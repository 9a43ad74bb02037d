"""The cv2 build that ``maggie_tpu_torch/data/imgproc.py::warp_affine`` replicates.

The port's warp copies OpenCV 5.0's float32 warp kernel as dispatched on an
x86 host with AVX2 (checked against cv2 5.0.0 on a host with AVX2 and
AVX-512). OpenCV 4 warps in fixed point, and a build without AVX2, or with
its optimised paths off, rounds otherwise. So a test that holds the warp, or
a sample that went through it, bit for bit against cv2 needs that build.
"""

import cv2


def require_cv2_float_warp() -> None:
    """Fail, saying why, where cv2 is not the build that the warp replicates."""
    version = tuple(int(v) for v in cv2.__version__.split(".")[:2])
    # "*AVX2": dispatched code for AVX2 that this CPU runs ("AVX2?" would mark
    # code built for it that the CPU lacks)
    avx2 = "*AVX2" in cv2.getCPUFeaturesLine().split()
    optimised = cv2.useOptimized()
    assert version == (5, 0) and avx2 and optimised, (
        f"imgproc.warp_affine replicates OpenCV 5.0's float32 warpAffine on an AVX2 host; "
        f"this cv2 is {cv2.__version__} (AVX2 {avx2}, optimised paths {optimised}), whose "
        f"warpAffine rounds otherwise (OpenCV 4 works in fixed point), so the bit-equality "
        f"held here does not apply")
