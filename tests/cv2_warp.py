"""The cv2 build that ``maggie_tpu_torch/data/imgproc.py::warp_affine`` and
``gaussian_blur_f32`` replicate.

The port's warp copies OpenCV 5.0's float32 warp kernel as dispatched on an
x86 host with AVX2 (checked against cv2 5.0.0 on a host with AVX2 and
AVX-512). OpenCV 4 warps in fixed point, and a build without AVX2, or with
its optimised paths off, rounds otherwise. So a test that holds the warp, or
a sample that went through it, bit for bit against cv2 needs that build.
The float32 Gaussian blur likewise copies that build's filter engine
(fused multiply-adds in its vector code, rounded products in its scalar
tails).
"""

import cv2


def _replicated_build() -> tuple[bool, str]:
    """(whether cv2 is OpenCV 5.0 running its AVX2 code, a description)."""
    version = tuple(int(v) for v in cv2.__version__.split(".")[:2])
    # "*AVX2": dispatched code for AVX2 that this CPU runs ("AVX2?" would mark
    # code built for it that the CPU lacks)
    avx2 = "*AVX2" in cv2.getCPUFeaturesLine().split()
    optimised = cv2.useOptimized()
    return (version == (5, 0) and avx2 and optimised,
            f"this cv2 is {cv2.__version__} (AVX2 {avx2}, optimised paths {optimised})")


def require_cv2_float_warp() -> None:
    """Fail, saying why, where cv2 is not the build that the warp replicates."""
    ok, build = _replicated_build()
    assert ok, (
        f"imgproc.warp_affine replicates OpenCV 5.0's float32 warpAffine on an AVX2 host; "
        f"{build}, whose warpAffine rounds otherwise (OpenCV 4 works in fixed point), so the "
        f"bit-equality held here does not apply")


def require_cv2_float_blur() -> None:
    """Fail, saying why, where cv2 is not the build whose float32 Gaussian
    blur ``imgproc.gaussian_blur_f32`` replicates."""
    ok, build = _replicated_build()
    assert ok, (
        f"imgproc.gaussian_blur_f32 replicates OpenCV 5.0's float32 GaussianBlur on an AVX2 "
        f"host; {build}, whose filters may sum in another order, so the bit-equality held "
        f"here does not apply")
