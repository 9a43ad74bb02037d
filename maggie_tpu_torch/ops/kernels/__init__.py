"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch twins.

Each wrapper launches its kernel for a CUDA tensor and runs the twin for a CPU
tensor. Kernels are built from ``csrc/`` at first use (``build.py``).
"""


def launch_counts() -> dict:
    """Each kernel's launches so far, as its wrapper counts them."""
    from . import gather, unknown
    return {"gather_patches": gather.launches, "gather_patches_bwd": gather.bwd_launches,
            "compute_unknown": unknown.launches}
