// Haloed patch gather for the block-sparse refinement ladder (eval forward).
//
// Replaces the TPU kernel maggie_tpu/ops/pallas/gather.py::gather_patches_pallas
// (body _gather_kernel). For each of `cap` entries p = (n, by, bx) it copies the
// window of rows and columns [b*block - halo, b*block + block + halo) of map n of
// feat, logically (N, H, W, C), all C channels, into out[p] (cap, S, S, C)
// contiguous, S = block + 2*halo, writing zeros outside the map (and for n
// outside [0, N)).
//
// Bound on the H100: bytes. The kernel does no arithmetic: each touched input
// element is read about once (neighbouring windows overlap only in their halos,
// which L2 serves) and each output element is written once. What the design
// does about it: every access to device memory is a 16-byte vector wherever the
// alignment allows (Hopper moves 16 bytes a thread best), there is no division
// per element, and the caller's own memory layout is read as it is, so the
// caller makes no layout copy first. Two layouts, told apart by the strides:
//
// - pixel-major (contiguous NHWC; also any C=1 map): one window row is S*C
//   contiguous elements in the input and in the output. A thread block takes
//   (entry, band of rows); threads are 2-D (row, vector within the row); each
//   thread issues its loads for several rows before its stores. The in-map part
//   of a row is a span [v_lo, v_hi) of vectors, the rest are zero vectors. When
//   the row, the map row, the map, block*C, halo*C and both pointers are 16-byte
//   aligned (x8 and the os1 mask on the main path) the vector is 16 bytes; the
//   host picks that template instance once per launch, else one element.
// - plane-major (NCHW memory under the (N, H, W, C) view, i.e. permute(0,2,3,1)
//   of a contiguous NCHW tensor: fea3, fea2, the lazy-os1 input): a window row
//   of one channel is S contiguous elements of one plane. A thread block takes
//   (entry, two bands of R rows) and, per band, (1) stages each channel's row
//   segment into shared memory as 16-byte cp.async chunks over the 16-byte
//   aligned span that covers it (zero chunks outside the map), tile
//   [R][C][lp], lp an odd number of chunks so that channels start on
//   different banks; (2) turns it into the band's output order [R][S][C],
//   which is contiguous in the output, and writes it as 16-byte vectors. When
//   C is a multiple of one vector (fea3, fea2) each vector is one pixel's
//   channel group: threads read it down the staged channels, consecutive
//   threads on consecutive pixels, and write it to a padded band tile, from
//   which consecutive threads copy consecutive vectors out. Otherwise (the
//   6-channel lazy-os1 input) each thread gathers the elements of one output
//   vector straight from the staging tile, with one multiply-shift division
//   per vector and a scalar head and tail where the band is not 16-byte
//   aligned. Two staging buffers: the next band's cp.async loads run while this
//   band is turned and stored. A map whose rows are not 16-byte aligned stages
//   one element at a time (same plan, a chunk of one element); the output
//   side stays 16-byte.
//
// Templated on float and __nv_bfloat16. tests/test_torch_kernels.py emulates
// this work plan in numpy (test_gather_kernel_plan_matches_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;         // pixel-major: loads in flight per thread
constexpr int kStageBytes = 48 * 1024;    // plane-major: shared memory per block
constexpr int kBandsPerBlock = 2;         // plane-major: bands per thread block

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename V>
__device__ __forceinline__ V zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <>
__device__ __forceinline__ uint4 zero_value<uint4>() { return make_uint4(0, 0, 0, 0); }

// Global -> shared copy of one staging chunk: cp.async for 16 bytes, else a
// plain copy through a register.
template <typename V>
__device__ __forceinline__ void stage_copy(void* smem, const void* gmem) {
  if constexpr (sizeof(V) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  } else {
    *static_cast<V*>(smem) = *static_cast<const V*>(gmem);
  }
}
// Sixteen bytes from 16/sizeof(T) elements held in registers.
__device__ __forceinline__ uint4 pack16(const float (&e)[4]) {
  return make_uint4(__float_as_uint(e[0]), __float_as_uint(e[1]), __float_as_uint(e[2]),
                    __float_as_uint(e[3]));
}
__device__ __forceinline__ uint4 pack16(const __nv_bfloat16 (&e)[8]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = static_cast<unsigned>(__bfloat16_as_ushort(e[2 * j])) |
           (static_cast<unsigned>(__bfloat16_as_ushort(e[2 * j + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and Montgomery):
// l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d) + 1, computed on the host.
struct FastDiv {
  unsigned mul, shift;
};
FastDiv fast_div(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  return {static_cast<unsigned>((((1ull << l) - d) << 32) / d + 1), l};
}
__device__ __forceinline__ int operator/(int n, FastDiv f) {
  return static_cast<int>((__umulhi(static_cast<unsigned>(n), f.mul) + n) >> f.shift);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- pixel-major
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    gather_pixel_major(const T* __restrict__ feat, const int64_t* __restrict__ idx_n,
                       const int64_t* __restrict__ idx_by,
                       const int64_t* __restrict__ idx_bx, T* __restrict__ out, int N,
                       int H, int W, int C, int block, int halo, int size, int64_t sn,
                       int64_t sy) {
  constexpr int K = sizeof(V) / sizeof(T);  // elements per vector
  const int p = blockIdx.x;
  const int r0 = blockIdx.y * blockDim.y * kRowsPerThread;  // first row of the band
  const int64_t n = idx_n[p];
  const int y0 = static_cast<int>(idx_by[p]) * block - halo + r0;
  const int x0 = static_cast<int>(idx_bx[p]) * block - halo;
  const bool n_ok = n >= 0 && n < N;
  const int row_vecs = size * C / K;
  // the in-map columns [max(x0, 0), min(x0 + S, W)) as vectors of the row
  const int v_lo = (max(x0, 0) - x0) * C / K;
  const int v_hi = max((min(x0 + size, W) - x0) * C / K, v_lo);
  const int64_t row_len = static_cast<int64_t>(size) * C;
  T* out_band = out + (static_cast<int64_t>(p) * size + r0) * row_len;
  const int64_t src0 = n * sn + static_cast<int64_t>(x0) * C;  // + y * sy
  for (int v = threadIdx.x; v < row_vecs; v += blockDim.x) {
    V val[kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int r = threadIdx.y + u * blockDim.y;
      const int y = y0 + r;
      val[u] = zero_value<V>();
      if (n_ok && r0 + r < size && y >= 0 && y < H && v >= v_lo && v < v_hi)
        val[u] = reinterpret_cast<const V*>(feat + src0 + y * sy)[v];
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int r = threadIdx.y + u * blockDim.y;
      if (r0 + r < size) reinterpret_cast<V*>(out_band + r * row_len)[v] = val[u];
    }
  }
}

// ---------------------------------------------------------------- plane-major
// Shared memory: two staging tiles [rows][C][lp], then (from the next 16-byte
// boundary) the band in output order, [rows*S][C + KS]. kGrouped (C a multiple
// of KS = 16/sizeof(T), out 16-byte aligned): every 16-byte output vector is KS
// channels of one pixel; the transpose writes them to the band tile, each pixel
// padded by one vector so that these 16-byte writes are free of bank conflicts,
// and the band leaves the tile as consecutive 16-byte vectors. Otherwise (C=6)
// the band tile is not used: each thread gathers the KS consecutive elements
// of one 16-byte output vector straight from the staging tile, walking
// (row, pixel, channel) from one fast division, with a scalar head and tail
// where the band does not start or end on 16 bytes.
template <typename T, typename V, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    gather_plane_major(const T* __restrict__ feat, const int64_t* __restrict__ idx_n,
                       const int64_t* __restrict__ idx_by,
                       const int64_t* __restrict__ idx_bx, T* __restrict__ out, int N,
                       int H, int W, int C, int block, int halo, int size, int64_t sn,
                       int64_t sy, int64_t sc, int rows, int lp, FastDiv div_c,
                       FastDiv div_s) {
  constexpr int K = sizeof(V) / sizeof(T);   // elements per staging chunk
  constexpr int KS = 16 / sizeof(T);         // elements per output vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage0 = reinterpret_cast<T*>(smem_raw);
  T* stage1 = stage0 + rows * C * lp;

  const int p = blockIdx.x;
  const int64_t n = idx_n[p];
  const int y_first = static_cast<int>(idx_by[p]) * block - halo;
  const int x0 = static_cast<int>(idx_bx[p]) * block - halo;
  const bool n_ok = n >= 0 && n < N;
  // staged columns [xa, xa + nchunk*K): the K-aligned span over [x0, x0 + S)
  const int off = ((x0 % K) + K) % K;
  const int xa = x0 - off;
  const int nchunk = (off + size + K - 1) / K;
  const int n_bands = (size + rows - 1) / rows;
  const int band0 = blockIdx.y * kBandsPerBlock;
  const int band1 = min(band0 + kBandsPerBlock, n_bands);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  // grouped thread mappings, once per thread. Transpose: pixel x fastest
  // (consecutive stage reads), then channel group; store: channel group
  // fastest (consecutive output), then pixel.
  const int ng = C / KS;
  const int txs = min(size, nthreads), tx = tid % txs, tg = tid / txs, tgs = nthreads / txs;
  const int sgs = max(min(ng, nthreads), 1), sg = tid % sgs, sq = tid / sgs,
            sqs = nthreads / sgs;

  auto load = [&](int band, T* stage) {
    const int r0 = band * rows;
    const int nr = min(rows, size - r0);
    for (int s = threadIdx.y; s < nr * C; s += blockDim.y) {  // (row, channel) segment
      const int r = s / C;
      const int c = s - r * C;
      const int y = y_first + r0 + r;
      const bool row_ok = n_ok && y >= 0 && y < H;
      const T* src = feat + n * sn + c * sc + y * sy + xa;
      T* dst = stage + (r * C + c) * lp;
      for (int k = threadIdx.x; k < nchunk; k += blockDim.x) {
        const int x = xa + k * K;
        if (row_ok && x >= 0 && x + K <= W)
          stage_copy<V>(dst + k * K, src + k * K);
        else
          *reinterpret_cast<V*>(dst + k * K) = zero_value<V>();
      }
    }
    cp_async_commit();
  };

  load(band0, stage0);
  for (int b = band0; b < band1; ++b) {
    T* stage = ((b - band0) & 1) ? stage1 : stage0;
    if (b + 1 < band1) {
      load(b + 1, ((b - band0) & 1) ? stage0 : stage1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = b * rows;
    const int nr = min(rows, size - r0);
    T* dst = out + (static_cast<int64_t>(p) * size + r0) * size * C;
    if constexpr (kGrouped) {
      uint4* tv =
          reinterpret_cast<uint4*>(smem_raw + align16(2 * rows * C * lp * sizeof(T)));
      if (tg < tgs) {
        for (int r = 0; r < nr; ++r)
          for (int g = tg; g < ng; g += tgs)
            for (int x = tx; x < size; x += txs) {
              const T* s = stage + (r * C + g * KS) * lp + off + x;
              T e[KS];
#pragma unroll
              for (int i = 0; i < KS; ++i) e[i] = s[i * lp];
              tv[(r * size + x) * (ng + 1) + g] = pack16(e);
            }
      }
      __syncthreads();
      uint4* dv = reinterpret_cast<uint4*>(dst);
      if (sq < sqs) {
        for (int q = sq; q < nr * size; q += sqs)
          for (int g = sg; g < ng; g += sgs) dv[q * ng + g] = tv[q * (ng + 1) + g];
      }
    } else {
      const int len = nr * size * C;
      const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(dst) % 16) / sizeof(T));
      const int head = min((KS - sh) % KS, len);
      const int nvec = (len - head) / KS;
      const int tail = head + nvec * KS;
      // element e of the band is channel c of pixel x of band row r
      auto staged = [&](int e) {
        const int q = e / div_c, r = q / div_s;
        return stage[(r * C + e - q * C) * lp + off + q - r * size];
      };
      for (int i = tid; i < head; i += nthreads) dst[i] = staged(i);
      for (int i = tail + tid; i < len; i += nthreads) dst[i] = staged(i);
      uint4* dv = reinterpret_cast<uint4*>(dst + head);
      for (int v = tid; v < nvec; v += nthreads) {
        const int e0 = head + v * KS;
        const int q = e0 / div_c;
        int r = q / div_s, x = q - r * size, c = e0 - q * C;
        T e[KS];
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          e[i] = stage[(r * C + c) * lp + off + x];
          if (++c == C) {
            c = 0;
            if (++x == size) x = 0, ++r;
          }
        }
        dv[v] = pack16(e);
      }
    }
    __syncthreads();
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, typename V>
cudaError_t launch_pixel(const T* feat, const int64_t* idx_n, const int64_t* idx_by,
                         const int64_t* idx_bx, T* out, int cap, int N, int H, int W,
                         int C, int block, int halo, int64_t sn, int64_t sy,
                         cudaStream_t stream) {
  constexpr int K = sizeof(V) / sizeof(T);
  const int size = block + 2 * halo;
  const int row_vecs = size * C / K;
  const int tx = min((row_vecs + 31) / 32 * 32, kThreads);
  const int ty = kThreads / tx;
  const int rows = ty * kRowsPerThread;
  const dim3 grid(cap, (size + rows - 1) / rows);
  gather_pixel_major<T, V><<<grid, dim3(tx, ty), 0, stream>>>(
      feat, idx_n, idx_by, idx_bx, out, N, H, W, C, block, halo, size, sn, sy);
  return cudaGetLastError();
}

template <typename T, typename V, bool kGrouped>
cudaError_t launch_plane(const T* feat, const int64_t* idx_n, const int64_t* idx_by,
                         const int64_t* idx_bx, T* out, int cap, int N, int H, int W,
                         int C, int block, int halo, int64_t sn, int64_t sy, int64_t sc,
                         cudaStream_t stream) {
  constexpr int K = sizeof(V) / sizeof(T);
  constexpr int KS = 16 / sizeof(T);
  const int size = block + 2 * halo;
  // staged row length: at most K-1 leading elements plus S, in whole chunks; an
  // odd number of chunks, so that the channels' segments start on different
  // shared-memory banks
  const int nchunk = (K - 1 + size + K - 1) / K;
  const int lp = (nchunk | 1) * K;
  const int pc = kGrouped ? C + KS : 0;  // band tile elements per pixel
  const int64_t row_bytes = (2LL * C * lp + static_cast<int64_t>(size) * pc) * sizeof(T);
  int rows = static_cast<int>((kStageBytes - 16) / row_bytes);
  rows = rows < 1 ? 1 : (rows > size ? size : rows);
  const size_t smem = align16(2 * static_cast<size_t>(rows) * C * lp * sizeof(T)) +
                      static_cast<size_t>(rows) * size * pc * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gather_plane_major<T, V, kGrouped>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tx = min(nchunk, 32);
  const int ty = kThreads / tx;
  const int n_bands = (size + rows - 1) / rows;
  const dim3 grid(cap, (n_bands + kBandsPerBlock - 1) / kBandsPerBlock);
  gather_plane_major<T, V, kGrouped><<<grid, dim3(tx, ty), smem, stream>>>(
      feat, idx_n, idx_by, idx_bx, out, N, H, W, C, block, halo, size, sn, sy, sc,
      rows, lp, fast_div(C), fast_div(size));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* feat_v, const void* idx_n_v, const void* idx_by_v,
                   const void* idx_bx_v, void* out_v, int cap, int N, int H, int W,
                   int C, int block, int halo, int64_t sn, int64_t sy, int64_t sx,
                   int64_t sc, cudaStream_t stream) {
  constexpr int K = 16 / sizeof(T);
  const T* feat = static_cast<const T*>(feat_v);
  const int64_t* idx_n = static_cast<const int64_t*>(idx_n_v);
  const int64_t* idx_by = static_cast<const int64_t*>(idx_by_v);
  const int64_t* idx_bx = static_cast<const int64_t*>(idx_bx_v);
  T* out = static_cast<T*>(out_v);
  const int size = block + 2 * halo;
  if (sc == 1 && sx == C && sy == static_cast<int64_t>(W) * C) {  // pixel-major
    const bool vec = aligned16(feat) && aligned16(out) && (size * C) % K == 0 &&
                     sy % K == 0 && sn % K == 0 && (block * C) % K == 0 &&
                     (halo * C) % K == 0;
    return vec ? launch_pixel<T, uint4>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W,
                                        C, block, halo, sn, sy, stream)
               : launch_pixel<T, T>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C,
                                    block, halo, sn, sy, stream);
  }
  if (sx == 1 && sy == W && sc == static_cast<int64_t>(H) * W) {  // plane-major
    const bool vec = aligned16(feat) && sy % K == 0 && sc % K == 0 && sn % K == 0;
    const bool grouped = C % K == 0 && aligned16(out);
    if (vec && grouped)
      return launch_plane<T, uint4, true>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W,
                                          C, block, halo, sn, sy, sc, stream);
    if (vec)
      return launch_plane<T, uint4, false>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W,
                                           C, block, halo, sn, sy, sc, stream);
    if (grouped)
      return launch_plane<T, T, true>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C,
                                      block, halo, sn, sy, sc, stream);
    return launch_plane<T, T, false>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C,
                                     block, halo, sn, sy, sc, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Indices are int64 device arrays of length
// cap. feat is addressed as feat[n*stride_n + y*stride_y + x*stride_x +
// c*stride_c] (elements); the strides must be pixel-major (stride_c 1, stride_x
// C, stride_y W*C) or plane-major (stride_x 1, stride_y W, stride_c H*W). out is
// contiguous (cap, S, S, C). Entries with n outside [0, N) produce zeros.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int gather_patches_launch(const void* feat, const void* idx_n,
                                     const void* idx_by, const void* idx_bx,
                                     void* out, int dtype, int cap, int N, int H,
                                     int W, int C, int block, int halo,
                                     long long stride_n, long long stride_y,
                                     long long stride_x, long long stride_c,
                                     void* stream) {
  if (cap <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0 || block <= 0 || halo < 0 || (block + 2 * halo) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C, block, halo,
                        stride_n, stride_y, stride_x, stride_c, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(feat, idx_n, idx_by, idx_bx, out, cap, N, H, W, C, block,
                                halo, stride_n, stride_y, stride_x, stride_c, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
