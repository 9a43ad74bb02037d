"""Parity harness for the PyTorch port (``maggie_tpu_torch``) against ``maggie_tpu``.

The JAX model's variable tree comes from ``jax.eval_shape`` of its init (no
compile); the values are drawn with numpy from a seed: weights, random
BatchNorm statistics, and spectral-norm u/v converged by power iteration, so
every layer is live and activations stay O(1). ``convert_jax`` carries them
to the port. The helpers are imported by the other ``test_torch_*`` files.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import __graft_entry__ as graft
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.utils.convert_jax import convert_jax

# Reduced dims of the CPU tests (the dryrun's, __graft_entry__.py:129).
ATTEN, FINAL = 32, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while a module's tests run (autouse where a
    module imports it). The suite runs in several worker processes, and
    torch's default of one OpenMP thread per core in each of them
    oversubscribes the host: 6 port test files took 413 s in 6 workers with
    the default and 52 s with one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(atten=ATTEN, final=FINAL, sparse_mode="block", cap_frac=0.5):
    cfg = graft._image_model_cfg(atten_dim=atten, final_channel=final)
    cfg.model.decoder_args.update(dict(sparse_mode=sparse_mode, block_cap_frac=cap_frac))
    return cfg


def port_cfg(jcfg):
    """The same ``model`` subtree, as a port ConfigNode."""
    return ConfigNode(jcfg.model.to_dict())


def memo(key: str, build):
    """``build()`` (a dict) once a process for ``key``: the seeded weights
    and the variable shapes that the test files build again and again (the
    same arrays, for the same arguments). Each caller gets its own dict and
    its own copy of each array, so that a change it makes stays its own."""
    if key not in _MEMO:
        _MEMO[key] = build()
    value = _MEMO[key]
    return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in value.items()}


_MEMO: dict = {}


def shapes_of(init) -> dict:
    """The flat variable shapes of ``jax.eval_shape(init)``."""
    return {"/".join(k): v.shape for k, v in flatten_dict(jax.eval_shape(init)).items()}


def shared_shapes(key: str, init) -> dict:
    """``shapes_of(init)`` once a test run for ``key``, which names the model
    (its repr) and what else its init depends on. Tracing a model's init
    takes tens of seconds on a loaded host, and xdist runs the test files in
    several processes that ask for the same shapes: the first to ask traces
    it under a lock and leaves the shapes (a few KB) in the run's directory
    (``run_dir``); the others read them. Without xdist, once a process."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return memo(key, lambda: shapes_of(init))

    def shared():
        path = run_dir(run) / f"{hashlib.sha256(key.encode()).hexdigest()[:32]}.shapes"
        with _locked(path):
            if not path.exists():
                with open(path.with_suffix(".part"), "wb") as f:
                    pickle.dump(shapes_of(init), f)
                os.replace(path.with_suffix(".part"), path)
            with open(path, "rb") as f:
                return pickle.load(f)
    return memo(key, shared)


@contextlib.contextmanager
def jax_step_lock(name: str):
    """Held while a test computes the JAX train step ``name``, which several
    files compute from the same weights on the same batch. xdist runs those
    files at once: the first to take the lock compiles the step into the
    persistent compile cache (``tests/conftest.py``), and the others wait
    here, then load it from there instead of compiling it again. Each file
    still runs its own step, so a name shared by different steps costs
    time, never a wrong reference. Without xdist, no lock."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        yield
        return
    with _locked(run_dir(run) / f"{name}.step"):
        yield


def run_dir(run: str) -> Path:
    """This test run's directory under the temporary directory."""
    path = Path(tempfile.gettempdir()) / f"maggie_tests_{run}"
    path.mkdir(exist_ok=True)
    return path


@contextlib.contextmanager
def _locked(path: Path):
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def jax_shapes(model, n_i: int = 2) -> dict:
    small = graft._make_batch(1, 1, n_i, 64, 64)
    return shared_shapes(f"jax_shapes {model!r} {n_i}",
                         lambda: model.init({"params": jax.random.PRNGKey(0)}, small, train=False))


def _is_transposed_sn(key: str) -> bool:
    # the SNConvTranspose modules: decoder ResLayerDec block0 upsamplers, and
    # the MGM family's os2 -> os1 upsampler
    return (key.startswith("decoder_mod/layer") and key.endswith("block0/conv1/weight_bar")
            or key == "decoder_mod/conv1/weight_bar")


def sn_matrix(key: str, w: np.ndarray) -> np.ndarray:
    """The spectral-norm matrix of a JAX HWIO weight, torch layout."""
    if _is_transposed_sn(key):
        return np.transpose(w, (2, 3, 0, 1)).reshape(w.shape[2], -1)
    return np.transpose(w, (3, 2, 0, 1)).reshape(w.shape[3], -1)


def random_flat(shapes: dict, seed: int = 0) -> dict:
    """Seeded values for a flat JAX variable tree (built once a process for
    each tree and seed, ``memo``)."""
    key = f"random_flat {sorted((k, tuple(v)) for k, v in shapes.items())} {seed}"
    return memo(key, lambda: _random_flat(shapes, seed))


def _random_flat(shapes: dict, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    flat = {}
    for k, shape in sorted(shapes.items()):
        if k.startswith("spectral/"):
            continue
        leaf = k.rsplit("/", 1)[1]
        if k.startswith("batch_stats/"):
            v = rs.uniform(0.5, 1.5, shape) if leaf == "var" else rs.uniform(-0.3, 0.3, shape)
        elif leaf == "scale":
            v = rs.uniform(0.7, 1.3, shape)
        elif leaf in ("bias", "in_proj_bias", "out_proj_bias"):
            v = rs.uniform(-0.1, 0.1, shape)
        else:
            rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            fan = rf * (shape[-2] + shape[-1]) if len(shape) >= 2 else shape[0]
            v = rs.uniform(-1, 1, shape) * np.sqrt(6.0 / fan)
        flat[k] = v.astype(np.float32)
    for k in shapes:
        if k.startswith("spectral/") and k.endswith("/u"):
            base = k[len("spectral/"):-len("/u")]
            wkey = f"{base}/weight_bar"
            m = sn_matrix(wkey, flat[f"params/{wkey}"]).astype(np.float64)
            u = rs.randn(m.shape[0])
            for _ in range(30):
                v = m.T @ u
                v /= np.linalg.norm(v) + 1e-12
                u = m @ v
                u /= np.linalg.norm(u) + 1e-12
            flat[k] = u.astype(np.float32)
            flat[f"spectral/{base}/v"] = v.astype(np.float32)
    return flat


def jax_variables(flat: dict) -> dict:
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def port_from_flat(model_cfg, flat: dict):
    model = port_build_model(model_cfg, device="cpu")
    model.load_state_dict(convert_jax(flat, model))
    return model


def make_batch(n_i: int = 2, h: int = 128, w: int = 192, seed: int = 0):
    """The same batch for both packages (``__graft_entry__._make_batch``)."""
    jb = graft._make_batch(1, 1, n_i, h, w, seed=seed)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jb, tb


def build_pair(sparse_mode="block", cap_frac=0.5, seed=0):
    """(JAX model, JAX variables, port model, flat) on identical weights."""
    jcfg = jax_cfg(sparse_mode=sparse_mode, cap_frac=cap_frac)
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed)
    return jm, jax_variables(flat), port_from_flat(port_cfg(jcfg), flat), flat


def test_random_flat_round_trips_through_convert_jax():
    """The harness itself: every JAX array lands in the port and none is left."""
    jcfg = jax_cfg()
    shapes = jax_shapes(jax_build_model(jcfg.model))
    flat = random_flat(shapes)
    model = port_from_flat(port_cfg(jcfg), flat)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["encoder.conv1.module.weight_bar"].numpy(),
        np.transpose(flat["params/encoder_mod/backbone/conv1/weight_bar"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["decoder.layer3.0.weight"].numpy(),
        np.transpose(flat["params/decoder_mod/layer3_inv/weight"], (3, 0, 1, 2)))
