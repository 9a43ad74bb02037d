// Backward of the haloed patch gather: the exact transpose of gather_patches.cu.
//
// The JAX package differentiates its gather with a custom VJP written in XLA,
// maggie_tpu/ops/blocksparse.py::_gather_patches_bwd (:109-173): entries are
// routed to (tile, duplicate rank) slots and the 9 shifted halo strips are
// added, with a scatter-add fallback when a tile has more entries than
// `dup_bound`. The forward's TPU kernel is
// maggie_tpu/ops/pallas/gather.py::gather_patches_pallas; this is the gradient
// that its port needs for training.
//
// Contract: for g (cap, S, S, C) contiguous, S = block + 2*halo, and entries
// p = (n_p, by_p, bx_p),
//   dfeat[n, y, x, c] = sum over the entries p of map n whose window covers
//                       (y, x) of g[p, y - (by_p*block - halo),
//                                    x - (bx_p*block - halo), c],
// for every duplicate entry (per-image gathers index with idx_n // n_i, so up
// to n_i entries share a tile) and every padding entry (capacities past the
// tile count repeat entry 0). Entries whose tile lies outside the grid
// [0, N) x [0, ceil(H/block)) x [0, ceil(W/block)) carry no gradient.
//
// Design: a deterministic pull, no float atomics, so that the result is the
// same bits on every run and equal to the plain twin
// (ops/kernels/gather.py::gather_patches_bwd_plain):
// 1. index pass, one thread block: each entry's tile key, integer counts per
//    tile, an exclusive scan, and each entry placed at its tile's start plus
//    its rank among the tile's entries of lower p. The result is a CSR list of
//    every tile's entries in ascending p (integer work only, so atomics do not
//    change the result).
// 2. pull pass, one thread per output element, threads in (n, y, x, c) order
//    so that a warp reads 32 neighbouring channels of g: the element visits its own
//    tile and the neighbours whose halo reaches it (rows and columns within
//    ceil(halo/block) tiles; one ring for every call site, where halo <
//    block), in row-major (dy, dx) order, adds each listed entry's value in
//    ascending p in f32, and rounds once to the output type. dfeat is written
//    in the layout the forward read: pixel-major (N, H, W, C) or the
//    plane-major (N, C, H, W) memory of the encoder's maps, so the backward
//    adds no layout copy. Every output element is written, zeros included.
//
// Bound on the H100: bytes (g read once per covering window, dfeat written
// once; no arithmetic beyond the sums). This first version is simple: one
// element per thread with 32-bit index math (three integer divisions), no
// vector loads, and plane-major dfeat written with a stride of H*W between
// neighbouring threads (the reads of g, up to 9 windows x n_i entries per
// element, outnumber the writes).
//
// Templated on float and __nv_bfloat16 (accumulation in f32 for both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kIndexThreads = 1024;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;  // grid-stride beyond this

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Shared memory: keys[cap], offsets[n_tiles + 1], partial[blockDim.x] (ints).
__global__ void __launch_bounds__(kIndexThreads)
    build_tile_lists(const int64_t* __restrict__ idx_n, const int64_t* __restrict__ idx_by,
                     const int64_t* __restrict__ idx_bx, int cap, int N, int nby, int nbx,
                     int* __restrict__ starts, int* __restrict__ list) {
  extern __shared__ int smem[];
  const int n_tiles = N * nby * nbx;
  int* keys = smem;
  int* offsets = smem + cap;
  int* partial = offsets + n_tiles + 1;
  const int tid = threadIdx.x;
  for (int p = tid; p < cap; p += blockDim.x) {
    const int64_t n = idx_n[p], by = idx_by[p], bx = idx_bx[p];
    const bool ok = n >= 0 && n < N && by >= 0 && by < nby && bx >= 0 && bx < nbx;
    keys[p] = ok ? static_cast<int>((n * nby + by) * nbx + bx) : -1;
  }
  for (int t = tid; t <= n_tiles; t += blockDim.x) offsets[t] = 0;
  __syncthreads();
  for (int p = tid; p < cap; p += blockDim.x)
    if (keys[p] >= 0) atomicAdd(&offsets[keys[p]], 1);
  __syncthreads();

  // exclusive scan of the counts: each thread sums a contiguous chunk, the
  // chunk sums are scanned (Hillis-Steele), then each chunk is written out
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += offsets[t];
  partial[tid] = sum;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int v = tid >= off ? partial[tid - off] : 0;
    __syncthreads();
    partial[tid] += v;
    __syncthreads();
  }
  int run = partial[tid] - sum;
  for (int t = lo; t < hi; ++t) {
    const int count = offsets[t];
    offsets[t] = run;
    starts[t] = run;
    run += count;
  }
  if (tid == blockDim.x - 1) starts[n_tiles] = partial[tid];
  __syncthreads();

  // each entry at its tile's start plus its rank among the tile's lower entries
  for (int p = tid; p < cap; p += blockDim.x) {
    const int key = keys[p];
    if (key < 0) continue;
    int rank = 0;
    for (int q = 0; q < p; ++q) rank += keys[q] == key;
    list[offsets[key] + rank] = p;
  }
}

template <typename T, bool kPlane>
__global__ void __launch_bounds__(kThreads)
    gather_bwd_pull(const T* __restrict__ g, const int* __restrict__ starts,
                    const int* __restrict__ list, T* __restrict__ dfeat, int H, int W, int C,
                    int block, int halo, int size, int nby, int nbx, int reach, int total) {
  // i walks (n, y, x, c) in both layouts, so that neighbouring threads read
  // neighbouring channels of g (coalesced); a plane-major dfeat is then
  // written with a stride of H*W between them. 32-bit index math: the host
  // checks that N*H*W*C fits.
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int r2 = r / W, x = r - r2 * W;
    const int n = r2 / H, y = r2 - n * H;
    const int ty0 = y / block, tx0 = x / block;
    float acc = 0.0f;
    for (int dy = -reach; dy <= reach; ++dy) {
      const int ty = ty0 + dy;
      const int ry = y - (ty * block - halo);
      if (ty < 0 || ty >= nby || ry < 0 || ry >= size) continue;
      for (int dx = -reach; dx <= reach; ++dx) {
        const int tx = tx0 + dx;
        const int rx = x - (tx * block - halo);
        if (tx < 0 || tx >= nbx || rx < 0 || rx >= size) continue;
        const int tile = (n * nby + ty) * nbx + tx;
        const int64_t at = (static_cast<int64_t>(ry) * size + rx) * C + c;
        for (int k = starts[tile], end = starts[tile + 1]; k < end; ++k)
          acc += to_float(g[static_cast<int64_t>(list[k]) * size * size * C + at]);
      }
    }
    if constexpr (kPlane)
      dfeat[(static_cast<int64_t>(n * C + c) * H + y) * W + x] = from_float<T>(acc);
    else
      dfeat[i] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* g, const int* starts, const int* list, void* dfeat, int N, int H,
                   int W, int C, int block, int halo, int nby, int nbx, bool plane,
                   cudaStream_t stream) {
  const int size = block + 2 * halo;
  const int reach = (halo + block - 1) / block;
  const int64_t total = static_cast<int64_t>(N) * H * W * C;
  if (total == 0) return cudaSuccess;
  if (total > INT32_MAX - static_cast<int64_t>(kThreads) * kMaxBlocks)
    return cudaErrorInvalidValue;  // the pull's 32-bit index math
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dfeat);
  if (plane)
    gather_bwd_pull<T, true><<<blocks, kThreads, 0, stream>>>(
        gt, starts, list, out, H, W, C, block, halo, size, nby, nbx, reach,
        static_cast<int>(total));
  else
    gather_bwd_pull<T, false><<<blocks, kThreads, 0, stream>>>(
        gt, starts, list, out, H, W, C, block, halo, size, nby, nbx, reach,
        static_cast<int>(total));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g is contiguous (cap, S, S, C); indices
// are int64 device arrays of length cap; dfeat is written whole: contiguous
// (N, H, W, C) when plane == 0, contiguous (N, C, H, W) when plane == 1.
// scratch holds n_tiles + 1 + cap ints, n_tiles = N * ceil(H/block) *
// ceil(W/block). The index pass takes (cap + n_tiles + 1 + kIndexThreads) * 4
// bytes of shared memory, which the caller checks against the card's limit.
// Launches the index pass and the pull on `stream`; returns the first non-zero
// cudaGetLastError().
extern "C" int gather_patches_bwd_launch(const void* g, const void* idx_n, const void* idx_by,
                                         const void* idx_bx, void* dfeat, void* scratch,
                                         int dtype, int cap, int N, int H, int W, int C,
                                         int block, int halo, int plane, void* stream) {
  if (cap < 0 || N < 0 || H < 0 || W < 0 || C <= 0 || block <= 0 || halo < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nby = (H + block - 1) / block, nbx = (W + block - 1) / block;
  const int n_tiles = N * nby * nbx;
  int* starts = static_cast<int*>(scratch);
  int* list = starts + n_tiles + 1;
  const size_t smem = (static_cast<size_t>(cap) + n_tiles + 1 + kIndexThreads) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        build_tile_lists, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  build_tile_lists<<<1, kIndexThreads, smem, s>>>(
      static_cast<const int64_t*>(idx_n), static_cast<const int64_t*>(idx_by),
      static_cast<const int64_t*>(idx_bx), cap, N, nby, nbx, starts, list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0 ? launch<float>(g, starts, list, dfeat, N, H, W, C, block, halo, nby, nbx,
                                   plane != 0, s)
                   : launch<__nv_bfloat16>(g, starts, list, dfeat, N, H, W, C, block, halo,
                                           nby, nbx, plane != 0, s);
  return static_cast<int>(err);
}
