"""safetensors weights in the port (``utils/checkpoint.py::read_safetensors``,
``load_model_weights``) and the model-zoo ids (``pretrained.py``).

- Files written here with numpy (the format: an 8-byte little-endian header
  length, a JSON header, the raw arrays) in F32, F16, I64, U8, BOOL and F64
  load equal to ``safetensors.numpy.load_file`` (the JAX package's reader)
  bit for bit, dtypes included; BF16 loads as torch bf16, with the bits
  that reader gives (ml_dtypes' bfloat16, registered by JAX).
- A seeded flagship ``state_dict`` saved as ``.safetensors`` (and as a
  snapshot dir's ``model.safetensors``) gives the forward of the ``.pth``
  route bit for bit; a snapshot dir is searched in the JAX package's order
  (``pytorch_model.bin``, ``model.safetensors``, ``model.pth``).
- Orbax dirs, hub ids and truncated files raise; the two zoo ids resolve to
  the JAX package's configs, an unknown id raises, and a zoo id with no
  local file raises ``FileNotFoundError`` naming the offline route.
"""

import json
import os

import numpy as np
import pytest
import torch

from maggie_tpu.pretrained import _ZOO_CONFIGS as JAX_ZOO
from maggie_tpu_torch.config import ConfigNode, load_config
from maggie_tpu_torch.flagship import blob_batch, flagship_cfg
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.pretrained import ZOO_CONFIGS, from_pretrained, zoo_config
from maggie_tpu_torch.utils.checkpoint import load_model_weights, read_safetensors
from test_torch_harness import ATTEN, FINAL, one_torch_thread  # noqa: F401

st_numpy = pytest.importorskip("safetensors.numpy", reason="the safetensors package is absent")

_NAMES = {np.dtype("float32"): "F32", np.dtype("float16"): "F16", np.dtype("float64"): "F64",
          np.dtype("int64"): "I64", np.dtype("int32"): "I32", np.dtype("uint8"): "U8",
          np.dtype("bool"): "BOOL"}


def write_safetensors(path, arrays: dict, raw: dict | None = None, metadata=None):
    """``arrays`` (numpy) and ``raw`` ({name: (dtype name, shape, bytes)}) into
    a ``.safetensors`` file, in name order, with numpy and json only."""
    header, blobs, offset = {}, [], 0
    entries = {k: (_NAMES[v.dtype], list(v.shape), np.ascontiguousarray(v).tobytes())
               for k, v in arrays.items()}
    entries.update(raw or {})
    for name in sorted(entries):
        dtype, shape, data = entries[name]
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(np.array([len(head)], "<u8").tobytes() + head + b"".join(blobs))
    return path


def state_dict_arrays(sd: dict) -> dict:
    return {k: v.detach().cpu().contiguous().numpy() for k, v in sd.items()}


def test_reader_equals_safetensors_numpy(tmp_path):
    rs = np.random.RandomState(0)
    arrays = {"a.f32": rs.randn(3, 5).astype(np.float32),
              "b.f16": rs.randn(7).astype(np.float16),
              "c.i64": rs.randint(-2**40, 2**40, (2, 2, 3)).astype(np.int64),
              "d.u8": rs.randint(0, 256, (4,)).astype(np.uint8),
              "e.bool": rs.rand(6) > 0.5,
              "f.f64": rs.randn(2, 3),
              "g.scalar": np.array(1.5, np.float32),
              "h.empty": np.zeros((0, 3), np.float32)}
    path = write_safetensors(str(tmp_path / "m.safetensors"), arrays, metadata={"format": "pt"})
    want = st_numpy.load_file(path)
    got = read_safetensors(path)
    assert set(got) == set(want) == set(arrays)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert g.tobytes() == v.tobytes(), k


def test_bf16_loads_as_torch_bf16(tmp_path):
    """The port reads BF16 as torch bf16. ``safetensors.numpy`` reads it as
    ml_dtypes' bfloat16 once JAX has registered that type with numpy (as in
    this process) and raises ``TypeError`` otherwise: the bits agree."""
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    bits = x.view(torch.int16).numpy().tobytes()
    path = write_safetensors(str(tmp_path / "b.safetensors"), {"f": np.ones(2, np.float32)},
                             raw={"w": ("BF16", [4, 6], bits)})
    want = st_numpy.load_file(path)["w"]
    assert want.dtype.name == "bfloat16"
    got = read_safetensors(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)
    assert got["w"].view(torch.int16).numpy().tobytes() == want.tobytes()
    assert torch.equal(got["f"], torch.ones(2))


@pytest.fixture(scope="module")
def reduced():
    """The reduced flagship's config (the harness's widths), its seeded
    model's ``state_dict`` and a batch."""
    cfg = flagship_cfg()
    cfg.model.decoder_args.update(dict(atten_dim=ATTEN, final_channel=FINAL))
    model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(4))
    return cfg, model.state_dict(), blob_batch(64, 128, 2, seed=1)


def _forward(cfg, weights, batch):
    cfg = cfg.clone()
    cfg.model.weights = weights
    model = load_model_weights(build_model(cfg.model, device="cpu"), cfg)
    with torch.inference_mode():
        return model.state_dict(), model(batch)


@pytest.mark.parametrize("layout", ["file", "snapshot_dir"])
def test_flagship_safetensors_gives_the_pth_forward(reduced, tmp_path, layout):
    cfg, sd, batch = reduced
    pth = str(tmp_path / "w.pth")
    torch.save(sd, pth)
    if layout == "file":
        weights = write_safetensors(str(tmp_path / "w.safetensors"), state_dict_arrays(sd))
    else:
        weights = str(tmp_path / "snap")
        os.makedirs(weights)
        write_safetensors(os.path.join(weights, "model.safetensors"), state_dict_arrays(sd))
    want_sd, want = _forward(cfg, pth, batch)
    got_sd, got = _forward(cfg, weights, batch)
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v), k
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_snapshot_dir_order(reduced, tmp_path):
    """``pytorch_model.bin`` before ``model.safetensors`` before
    ``model.pth``: each file holds the weights with the first BatchNorm's
    scale set to its rank, and the loaded scale tells which was read."""
    cfg, sd, _ = reduced
    key = "encoder.bn1.weight"
    names = ("pytorch_model.bin", "model.safetensors", "model.pth")
    snap = tmp_path / "snap"
    snap.mkdir()
    for i, name in enumerate(names):
        marked = dict(sd)
        marked[key] = torch.full_like(sd[key], float(i + 1))
        if name.endswith(".safetensors"):
            write_safetensors(str(snap / name), state_dict_arrays(marked))
        else:
            torch.save(marked, snap / name)
    for i, name in enumerate(names):
        c = cfg.clone()
        c.model.weights = str(snap)
        model = load_model_weights(build_model(c.model, device="cpu"), c)
        assert float(model.state_dict()[key][0]) == float(i + 1), name
        os.remove(snap / name)


@pytest.mark.parametrize("kind", ["orbax_dir", "hub_id", "truncated", "bad_dtype"])
def test_unreadable_weights_raise(reduced, tmp_path, kind):
    cfg = reduced[0].clone()
    if kind == "orbax_dir":
        (tmp_path / "ckpt" / "default").mkdir(parents=True)
        cfg.model.weights, exc, match = str(tmp_path / "ckpt"), FileNotFoundError, "orbax"
    elif kind == "hub_id":
        cfg.model.weights, exc, match = "someone/some-model", FileNotFoundError, "hub id"
    elif kind == "truncated":
        path = tmp_path / "t.safetensors"
        path.write_bytes(np.array([1000], "<u8").tobytes() + b"{}")
        cfg.model.weights, exc, match = str(path), ValueError, "not a safetensors file"
    else:
        cfg.model.weights = write_safetensors(str(tmp_path / "f8.safetensors"), {},
                                              raw={"w": ("F8_E4M3", [2], b"\0\0")})
        exc, match = ValueError, "F8_E4M3"
    with pytest.raises(exc, match=match):
        load_model_weights(build_model(cfg.model, device="cpu"), cfg)


def test_zoo_ids_resolve_to_their_configs(tmp_path, monkeypatch):
    """The JAX package's two ids and configs; a zoo id that names a local
    snapshot dir loads from it with its config."""
    assert ZOO_CONFIGS == JAX_ZOO
    for zoo_id, path in ZOO_CONFIGS.items():
        with pytest.raises(FileNotFoundError, match=r"local `\.safetensors`/`\.bin`"):
            zoo_config(zoo_id)
        with pytest.raises(FileNotFoundError, match="downloads nothing"):
            from_pretrained(zoo_id, device="cpu")
    with pytest.raises(ValueError, match="not a known model-zoo id"):
        from_pretrained("someone/some-model", device="cpu")
    cfg = ConfigNode({"model": {"arch": "Dummy"}})
    assert zoo_config("anything", cfg) is not cfg and zoo_config("anything", cfg) == cfg
    # a local snapshot dir under the id's own path resolves the id's config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    for zoo_id, path in ZOO_CONFIGS.items():
        os.makedirs(zoo_id)
        assert zoo_config(zoo_id) == load_config(os.path.join(repo, path))
    assert zoo_config("chuonghm/maggie-video-vim2k5-cvpr24").model.arch == "MaGGIe_Temp"
