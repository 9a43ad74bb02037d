"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
into ``_build/lib<name>-<source hash>.so`` beside this file (the directory is
git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds (``compute_unknown.cu``,
with one instance per element width, chunk height and alignment, about 40 s).
``build_all`` starts one ``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("gather_patches", "gather_patches_bwd", "compute_unknown")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels of maggie_tpu_torch are built at first use")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, target


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path] | None) -> None:
    if job is None:
        return
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                           f"{out.decode(errors='replace')}")
    os.replace(tmp, target)


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once;
    if one fails, the others are stopped before the error propagates."""
    jobs = {name: _start(name) for name in names}
    try:
        for name, job in jobs.items():
            _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
                job[1].unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build_all((name,))
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
