// Haloed patch gather for the block-sparse refinement ladder (eval forward).
//
// Replaces the TPU kernel maggie_tpu/ops/pallas/gather.py::gather_patches_pallas
// (body _gather_kernel). For each of `cap` entries p = (n, by, bx) it copies the
// window of rows and columns [b*block - halo, b*block + block + halo) of a
// contiguous NHWC map feat (N, H, W, C), all C channels, into out[p]
// (cap, S, S, C) with S = block + 2*halo, writing zeros outside the map.
//
// Bound on the H100: bytes. The kernel does no arithmetic; it reads each
// touched input element about once (neighbouring windows overlap only in
// their halos, which L2 serves) and writes each output element once.
// Design: one CUDA block per (entry, range of window rows); the block loads its
// own (n, by, bx). One window row is S*C contiguous elements in the output and
// S*C contiguous elements of one map row in the input (NHWC), so consecutive
// threads touch consecutive addresses on both sides. The border is a bounds
// test on (y, x) instead of a padded copy of the map. One kernel serves every
// C, C=1 masks included: the TPU's 128-lane rule and its 4x4 mask packing do
// not apply here. Templated on float and __nv_bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerBlock = 8192;  // target elements moved per CUDA block

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T>
__global__ void gather_patches_kernel(const T* __restrict__ feat,
                                      const int64_t* __restrict__ idx_n,
                                      const int64_t* __restrict__ idx_by,
                                      const int64_t* __restrict__ idx_bx,
                                      T* __restrict__ out, int N, int H, int W,
                                      int C, int block, int halo, int size,
                                      int rows_per_block) {
  const int p = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, size);
  const int64_t n = idx_n[p];
  const int y0 = static_cast<int>(idx_by[p]) * block - halo;
  const int x0 = static_cast<int>(idx_bx[p]) * block - halo;
  const int row_len = size * C;
  const int total = (r1 - r0) * row_len;
  const bool n_ok = n >= 0 && n < N;
  const T zero = zero_value<T>();
  T* out_p = out + (static_cast<int64_t>(p) * size + r0) * row_len;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / row_len;
    const int e = i - r * row_len;  // element within the window row
    const int y = y0 + r0 + r;
    const int x = x0 + e / C;
    T v = zero;
    if (n_ok && y >= 0 && y < H && x >= 0 && x < W) {
      // (x0 + e / C) * C + e % C == x0 * C + e
      v = feat[((n * H + y) * W) * static_cast<int64_t>(C) +
               static_cast<int64_t>(x0) * C + e];
    }
    out_p[i] = v;
  }
}

template <typename T>
cudaError_t launch(const void* feat, const void* idx_n, const void* idx_by,
                   const void* idx_bx, void* out, int cap, int N, int H, int W,
                   int C, int block, int halo, cudaStream_t stream) {
  const int size = block + 2 * halo;
  const int row_len = size * C;
  int rows = kElemsPerBlock / row_len;
  rows = rows < 1 ? 1 : (rows > size ? size : rows);
  const dim3 grid(cap, (size + rows - 1) / rows);
  gather_patches_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const int64_t*>(idx_n),
      static_cast<const int64_t*>(idx_by), static_cast<const int64_t*>(idx_bx),
      static_cast<T*>(out), N, H, W, C, block, halo, size, rows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Indices are int64 device arrays of length
// cap. Entries with n outside [0, N) produce zeros. Returns cudaGetLastError().
extern "C" int gather_patches_launch(const void* feat, const void* idx_n,
                                     const void* idx_by, const void* idx_bx,
                                     void* out, int dtype, int cap, int N, int H,
                                     int W, int C, int block, int halo,
                                     void* stream) {
  if (cap <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0 || block <= 0 || halo < 0 || (block + 2 * halo) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C, block,
                        halo, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W,
                                C, block, halo, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
