"""The port's names, imports and device rules.

- The port's ``state_dict`` is the original torch reference's: the JAX
  package's torch converter reads it key for key into the JAX variable tree.
- The port imports no JAX, no flax and nothing of ``maggie_tpu``; it imports
  without ``nvcc`` or ``triton``; asking for CUDA without a card raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu.utils.convert_torch import convert
from maggie_tpu_torch import resolve_device
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
from maggie_tpu_torch.utils.convert_jax import convert_jax
from test_torch_harness import jax_cfg, jax_shapes, make_batch, port_cfg

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("sparse_mode", ["block", "oracle"])
def test_reference_converter_reads_the_port_state_dict(sparse_mode, capsys):
    """convert_torch.convert(port.state_dict()) gives the JAX variable tree key
    for key and shape for shape, and convert_jax carries it back unchanged."""
    jcfg = jax_cfg(sparse_mode=sparse_mode)
    shapes = jax_shapes(jax_build_model(jcfg.model))
    model = port_build_model(port_cfg(jcfg), device="cpu",
                             generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    flat = convert({k: v.numpy() for k, v in sd.items()})
    assert "WARNING" not in capsys.readouterr().out      # no unconverted torch key
    assert sorted(flat) == sorted(shapes)
    for k, v in flat.items():
        assert tuple(v.shape) == tuple(shapes[k]), k
    back = convert_jax(flat, model)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_fold_spectral_norm_keeps_the_forward():
    """Folding sigma into every SN weight (transposed I == O upsamplers
    included) leaves the eval forward unchanged."""
    cfg = port_cfg(jax_cfg())
    model = port_build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # perturb the converged u/v so sigma's layout matters
        for name, buf in model.named_buffers():
            if name.endswith("weight_u") or name.endswith("weight_v"):
                buf.add_(0.1 * torch.randn(buf.shape, generator=torch.Generator().manual_seed(3)))
    _, tb = make_batch(seed=1)
    with torch.inference_mode():
        ref = model(tb)
        fold_spectral_norm(model)
        got = model(tb)
    assert not any(k.endswith("weight_u") for k in model.state_dict())
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def _port_files():
    return sorted((REPO / "maggie_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_flax_or_maggie_tpu():
    banned = ("jax", "jaxlib", "flax", "maggie_tpu")
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_import_needs_no_nvcc_triton_or_jax(tmp_path):
    """In a fresh interpreter with an empty PATH: importing every port module
    loads neither JAX nor triton and builds nothing."""
    code = ("import sys, pkgutil, importlib, maggie_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'maggie_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in ('jax', 'flax', 'triton', 'maggie_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "from maggie_tpu_torch.ops.kernels import build\n"
            "print(sorted(build._loaded))\n")
    env = {"PATH": "", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_build_model(port_cfg(jax_cfg()))             # the default device is cuda
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_raise_on_other_devices():
    """A wrapper takes its plain twin only for CPU tensors; anything else that
    is not CUDA raises instead of falling back."""
    meta = torch.empty((1, 8, 8, 1), device="meta")
    idx = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kg.gather_patches(meta, idx, idx, idx, 4, 1)
    with pytest.raises(ValueError):
        ku.compute_unknown(torch.empty((1, 8, 8), device="meta"), 15)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a GPU, and
    alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        env = dict(os.environ, PYTHONPATH="")
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
