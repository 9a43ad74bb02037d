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
// [0, N) x [0, ceil(H/block)) x [0, ceil(W/block)) carry no gradient. Each
// element's f32 sum takes the covering windows in row-major (dy, dx) order of
// the neighbouring tile, then in ascending p within a tile, and is rounded once
// to the output type: the order of the plain twin
// (ops/kernels/gather.py::gather_patches_bwd_plain), so the two agree bit for
// bit and two runs give the same bits (no float atomics anywhere).
//
// Bound on the H100: bytes. Each covering window's in-map part of g is read
// once (its off-map halo carries nothing) and each dfeat element written once;
// the only arithmetic is the f32 adds. Two launches:
//
// 1. build_tile_lists, one thread block: each entry's tile key and its arrival
//    among the tile's entries (an integer atomic), an exclusive scan of the
//    counts (warp shuffles, then the warps' totals), each entry placed at its
//    tile's start plus its arrival, then moved to its tile's start plus its
//    rank among the tile's entries of lower p: a CSR list of every tile's
//    entries in ascending p. Every step runs on all threads at once; a rank
//    costs one pass over the entry's own tile (integer work only).
// 2. gather_bwd_pull, one thread block per output box of (rows x columns x
//    channels) holding 16 KB of output (4096 f32 or 8192 bf16 elements):
//    whole tile rows of all C channels where they fit (fea1's 64x64x32 f32
//    tile is 32 boxes of 2 rows), or several whole tiles side by side where
//    one tile is smaller than a box (x8's 8x8x64 bf16 tiles, two a box). A
//    call is bound by the latency of each block's chain of dependent loads
//    (list bounds, list, g) more than by its bytes, so a box holds the same
//    bytes in both types. What it does about the costs of a thread per
//    element:
//    - Tile lookup once per block: the block takes its box from blockIdx,
//      loads the list bounds of the tiles within reach of the box in one round
//      of loads, skips tiles whose window misses the box, and stages the other
//      tiles' entries into shared memory as a window list, tiles in row-major
//      order of their position and entries in ascending p (for each element
//      that is the contract's order), kWindows at a time (a longer list, such
//      as a padded capacity repeating tile 0, is walked in rounds). No
//      division per element.
//    - 16-byte accesses: each thread owns fixed output vectors of the box (4 f32
//      or 8 bf16 channels of one pixel; consecutive threads on consecutive
//      vectors, so a warp reads a contiguous run of a window row of g) and keeps
//      their f32 sums in registers.
//    - Staged loads: window by window, each thread copies the vectors of that
//      window that fall on its own outputs into its own slots of a ring of D
//      box-sized stages in shared memory with 16-byte cp.async, D = 4 windows
//      ahead of the adds (64 KB a block). Three blocks an SM, in both types:
//      the 32 f32 sums a bf16 thread keeps fit the 80 registers that allows
//      (measured: 8% less time a bf16 step than two blocks with more registers).
//      A thread reads back only what it copied itself, so the ring needs no
//      barrier, only cp.async.wait_group. The windows of one tile lie scattered
//      over g (entry p at p*S*S*C), so the gain is the loads kept in flight, not
//      reuse. TMA was not taken: a window's rows are as short as 8 x 64
//      channels, and per-thread cp.async follows the masked rectangle of each
//      window with no descriptor per window.
//    - Stores: pixel-major dfeat takes each thread's vectors as 16-byte stores.
//      Plane-major dfeat (the NHWC view of NCHW memory) is turned through
//      shared memory (the ring, once drained), [channel][row][column] with an
//      odd plane stride, so that a warp writes consecutive x of one channel
//      plane as 16-byte vectors: the reverse of the forward's staged turn.
//    - Every element of the box is written, zeros included; a box with no
//      covering window writes its zeros the same way.
//    Tails inside the kernel: C not a multiple of one vector, or g or dfeat not
//    16-byte aligned, takes the one-element instance of the same plan (plain
//    copies instead of cp.async, 4096-element boxes); a plane-major map whose
//    width or block is not a multiple of one vector stores one element at a
//    time; ragged edge tiles mask their boxes. The host picks the instance
//    once per launch.
//
// Templated on float and __nv_bfloat16 (accumulation in f32 for both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kIndexThreads = 1024;
constexpr int kThreads = 256;                   // pull: threads per block
constexpr int kVectors = 4;                     // pull: 16-byte vectors a thread owns
constexpr int kElements = 16;                   // pull: elements a thread owns, one-element
constexpr int kStages = 4;                      // pull: windows staged ahead of the adds
constexpr int kMinBlocks = 3;                   // pull: blocks an SM holds (80 registers)
constexpr int kWindows = 256;                   // pull: windows staged per round
constexpr int kNeighbours = 64;                 // pull: neighbour bounds per round
constexpr int kOff = INT_MIN / 2;               // row of an owned vector off the map

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
  for (int t = tid; t <= n_tiles; t += blockDim.x) offsets[t] = 0;
  __syncthreads();
  // each entry's tile and its arrival among the tile's entries, packed as
  // tile * cap + arrival (under 2^31: cap + n_tiles fit in shared memory)
  for (int p = tid; p < cap; p += blockDim.x) {
    const int64_t n = idx_n[p], by = idx_by[p], bx = idx_bx[p];
    const bool ok = n >= 0 && n < N && by >= 0 && by < nby && bx >= 0 && bx < nbx;
    const int key = static_cast<int>((n * nby + by) * nbx + bx);
    keys[p] = ok ? key * cap + atomicAdd(&offsets[key], 1) : -1;
  }
  __syncthreads();

  // exclusive scan of the counts: each thread sums a contiguous chunk, the
  // chunk sums are scanned within each warp (shuffles) and across the warps'
  // totals, then each chunk is written out
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += offsets[t];
  int inc = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) partial[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x / 32) ? partial[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    partial[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? partial[warp - 1] : 0) + inc - sum;
  for (int t = lo; t < hi; ++t) {
    const int count = offsets[t];
    offsets[t] = run;
    starts[t] = run;
    run += count;
  }
  if (tid == blockDim.x - 1) {
    offsets[n_tiles] = run;
    starts[n_tiles] = run;
  }
  __syncthreads();

  // each entry at its tile's start plus its arrival: every tile's entries in
  // place, in no fixed order yet
  for (int p = tid; p < cap; p += blockDim.x) {
    if (keys[p] < 0) continue;
    const int key = keys[p] / cap;
    list[offsets[key] + keys[p] - key * cap] = p;
  }
  __syncthreads();
  // then each entry moves to its tile's start plus its rank among the tile's
  // entries of lower p (stable), through keys[], which is free by now
  const int total = offsets[n_tiles];
  for (int i = tid; i < total; i += blockDim.x) {
    int a = 0, b = n_tiles;  // the tile t with offsets[t] <= i < offsets[t + 1]
    while (b - a > 1) {
      const int mid = (a + b) / 2;
      if (offsets[mid] <= i) a = mid; else b = mid;
    }
    const int p = list[i];
    int rank = 0;
    for (int j = offsets[a], end = offsets[a + 1]; j < end; ++j) rank += list[j] < p;
    keys[offsets[a] + rank] = p;
  }
  __syncthreads();
  for (int i = tid; i < total; i += blockDim.x) list[i] = keys[i];
}

// Global -> shared copy of one owned vector: cp.async for 16 bytes, else a
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a[0..K) += the K elements of one staged vector, widened exactly to f32
__device__ __forceinline__ void add_vec(float* a, const uint4& v, float) {
  a[0] += __uint_as_float(v.x);
  a[1] += __uint_as_float(v.y);
  a[2] += __uint_as_float(v.z);
  a[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add_vec(float* a, const uint4& v, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[2 * j] += __uint_as_float(w[j] << 16);
    a[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void add_vec(float* a, float v, float) { a[0] += v; }
__device__ __forceinline__ void add_vec(float* a, __nv_bfloat16 v, __nv_bfloat16) {
  a[0] += __bfloat162float(v);
}

// Sixteen bytes of T from 16/sizeof(T) values (each rounded once)
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* a);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* a) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                    __float_as_uint(a[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* a) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a[2 * j]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a[2 * j + 1]))) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Output elements of one box: 16 KB of 16-byte vectors (4096 f32, 8192 bf16),
// or 4096 elements of the one-element instance
template <typename T, typename V>
__host__ __device__ constexpr int box_elements() {
  return kThreads * (sizeof(V) == 16 ? kVectors * 16 / static_cast<int>(sizeof(T)) : kElements);
}
template <typename T, typename V>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * box_elements<T, V>() * static_cast<int>(sizeof(T));
}

// Output layouts of the pull
constexpr int kPixel = 0;       // contiguous (N, H, W, C)
constexpr int kPlaneVec = 1;    // contiguous (N, C, H, W), 16-byte stores along x
constexpr int kPlaneElem = 2;   // contiguous (N, C, H, W), one element at a time

// The pull's boxes. Rows: each tile row is cut into rper boxes of R rows.
// Columns: the map is cut into groups of span = max(Wc, block) columns (one
// tile, or Wc / block whole tiles where a tile is smaller than a box), each
// group into cper boxes of Wc columns. Channels: runs of Cc.
struct Plan {
  int H, W, C, block, halo, nby, nbx, reach;
  int R, Wc, Cc, rper, span, cper;
  int nbr, nbc, nbch;  // boxes down one map, across it, over the channels
};

// One block per box: rows [Y0, Y1) x columns [X0, X1) x channels [c0, c1) of
// map n. V is the staged vector (uint4, or T itself).
template <typename T, typename V, int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gather_bwd_pull(const T* __restrict__ g, const int* __restrict__ starts,
                    const int* __restrict__ list, T* __restrict__ dfeat, Plan q) {
  constexpr int K = sizeof(V) / sizeof(T);           // elements per owned vector
  constexpr int kBox = box_elements<T, V>();
  constexpr int E = kBox / kThreads / K;             // owned vectors per thread
  constexpr int D = kStages;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);
  __shared__ int win_p[kWindows], win_y[kWindows], win_x[kWindows];
  __shared__ int nb_lo[kNeighbours], nb_hi[kNeighbours], nb_y[kNeighbours], nb_x[kNeighbours];

  const int H = q.H, W = q.W, C = q.C, block = q.block, halo = q.halo;
  const int R = q.R, Wc = q.Wc, Cc = q.Cc;
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int c0 = b % q.nbch * Cc;
  b /= q.nbch;
  const int bc = b % q.nbc;
  b /= q.nbc;
  const int br = b % q.nbr, n = b / q.nbr;
  const int ty = br / q.rper, gcol = bc / q.cper;
  const int Y0 = ty * block + br % q.rper * R;
  const int Y1 = min(min(Y0 + R, ty * block + block), H);
  const int X0 = gcol * q.span + bc % q.cper * Wc;
  const int X1 = min(min(X0 + Wc, gcol * q.span + q.span), W);
  if (Y0 >= Y1 || X0 >= X1) return;  // a box past a ragged edge
  const int c1 = min(c0 + Cc, C);
  const int size = block + 2 * halo;
  const int64_t entry = static_cast<int64_t>(size) * size * C;

  // the owned vectors: i = tid + e*kThreads, elements i*K.. of the box in
  // (row, column, channel) order; a row of kOff marks one off the map
  int gy[E], gx[E], gc[E];
  float acc[E][K];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int f = (tid + e * kThreads) * K;
    const int cc = f % Cc, rest = f / Cc;
    const int y = Y0 + rest / Wc, x = X0 + rest % Wc, c = c0 + cc;
    gy[e] = y < Y1 && x < X1 && c < c1 ? y : kOff;
    gx[e] = x;
    gc[e] = c;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[e][k] = 0.0f;
  }

  // add `count` staged windows in order, D windows of loads ahead of the adds
  auto pull = [&](int count) {
    __syncthreads();  // the window list is written
    for (int j = 0; j < count + D - 1; ++j) {
      if (j < count) {
        const T* gp = g + win_p[j] * entry;
        const int wy = win_y[j], wx = win_x[j];
        T* slot = ring + (j % D) * kBox;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int ry = gy[e] - wy, rx = gx[e] - wx;
          if (static_cast<unsigned>(ry) < static_cast<unsigned>(size) &&
              static_cast<unsigned>(rx) < static_cast<unsigned>(size))
            stage_copy<V>(slot + (tid + e * kThreads) * K,
                          gp + (static_cast<int64_t>(ry) * size + rx) * C + gc[e]);
        }
      }
      cp_async_commit();
      if (j >= D - 1) {
        cp_async_wait<D - 1>();
        const int w = j - (D - 1);
        const int wy = win_y[w], wx = win_x[w];
        const T* slot = ring + (w % D) * kBox;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int ry = gy[e] - wy, rx = gx[e] - wx;
          if (static_cast<unsigned>(ry) < static_cast<unsigned>(size) &&
              static_cast<unsigned>(rx) < static_cast<unsigned>(size))
            add_vec(acc[e], *reinterpret_cast<const V*>(slot + (tid + e * kThreads) * K), T());
        }
      }
    }
    __syncthreads();  // the window list may be overwritten
  };

  // the tiles whose windows may reach the box, in row-major order of their
  // position: restricted to the windows that cover one element, that is the
  // contract's row-major (dy, dx) order around the element's own tile. Each
  // tile's entries in ascending p.
  const int sy0 = Y0 / block - q.reach, sx0 = X0 / block - q.reach;
  const int nsx = (X1 - 1) / block - X0 / block + 1 + 2 * q.reach;
  const int n_nb = ((Y1 - 1) / block - Y0 / block + 1 + 2 * q.reach) * nsx;
  int count = 0;
  for (int nb0 = 0; nb0 < n_nb; nb0 += kNeighbours) {
    const int m = min(kNeighbours, n_nb - nb0);
    __syncthreads();  // the previous round's bounds are read
    if (tid < m) {
      const int sy = sy0 + (nb0 + tid) / nsx, sx = sx0 + (nb0 + tid) % nsx;
      const int wy = sy * block - halo, wx = sx * block - halo;
      int lo = 0, hi = 0;
      if (sy >= 0 && sy < q.nby && sx >= 0 && sx < q.nbx && wy < Y1 && wy + size > Y0 &&
          wx < X1 && wx + size > X0) {
        const int t = (n * q.nby + sy) * q.nbx + sx;
        lo = starts[t];
        hi = starts[t + 1];
      }
      nb_lo[tid] = lo;
      nb_hi[tid] = hi;
      nb_y[tid] = wy;
      nb_x[tid] = wx;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      int lo = nb_lo[j];
      const int hi = nb_hi[j], wy = nb_y[j], wx = nb_x[j];
      while (lo < hi) {
        const int take = min(hi - lo, kWindows - count);
        for (int i = tid; i < take; i += kThreads) {
          win_p[count + i] = list[lo + i];
          win_y[count + i] = wy;
          win_x[count + i] = wx;
        }
        count += take;
        lo += take;
        if (count == kWindows) {
          pull(count);
          count = 0;
        }
      }
    }
  }
  if (count > 0) pull(count);

  if constexpr (kLayout == kPixel) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (gy[e] == kOff) continue;
      T* dst = dfeat + ((static_cast<int64_t>(n) * H + gy[e]) * W + gx[e]) * C + gc[e];
      if constexpr (K > 1)
        *reinterpret_cast<uint4*>(dst) = pack16<T>(acc[e]);
      else
        *dst = from_float<T>(acc[e][0]);
    }
  } else {
    // turn the box through shared memory: [channel][row][column], odd plane
    // stride; the ring's copies are all complete (pull waited on each)
    const int plane = R * Wc + 1;
    T* turn = ring;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (gy[e] == kOff) continue;
      const int at = (gc[e] - c0) * plane + (gy[e] - Y0) * Wc + (gx[e] - X0);
#pragma unroll
      for (int k = 0; k < K; ++k) turn[at + k * plane] = from_float<T>(acc[e][k]);
    }
    __syncthreads();
    constexpr int KO = kLayout == kPlaneVec ? 16 / sizeof(T) : 1;
    const int nv = Wc / KO;  // the host takes kPlaneVec only where KO divides Wc
    for (int i = tid; i < Cc * R * nv; i += kThreads) {
      const int xv = i % nv, t = i / nv;
      const int y = Y0 + t % R, x = X0 + xv * KO, c = c0 + t / R;
      if (y >= Y1 || x >= X1 || c >= c1) continue;
      const T* src = turn + (c - c0) * plane + (y - Y0) * Wc + (x - X0);
      T* dst = dfeat + ((static_cast<int64_t>(n) * C + c) * H + y) * W + x;
      if constexpr (KO > 1) {
        float v[KO];
#pragma unroll
        for (int k = 0; k < KO; ++k) v[k] = to_float(src[k]);
        *reinterpret_cast<uint4*>(dst) = pack16<T>(v);
      } else {
        *dst = *src;
      }
    }
  }
}

template <typename T, typename V, int kLayout>
cudaError_t launch_pull(const T* g, const int* starts, const int* list, T* dfeat, int N,
                        const Plan& q, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(N) * q.nbr * q.nbc * q.nbch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // the ring is dynamic shared memory above 48 KB (set per call: per device)
  constexpr int kRing = ring_bytes<T, V>();
  const cudaError_t err = cudaFuncSetAttribute(
      gather_bwd_pull<T, V, kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
  if (err != cudaSuccess) return err;
  gather_bwd_pull<T, V, kLayout><<<static_cast<int>(blocks), kThreads, kRing, stream>>>(
      g, starts, list, dfeat, q);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* g, const int* starts, const int* list, void* dfeat, int N, int H,
                   int W, int C, int block, int halo, int nby, int nbx, bool plane,
                   cudaStream_t stream) {
  constexpr int K = 16 / sizeof(T);
  if (static_cast<int64_t>(N) * H * W * C == 0) return cudaSuccess;
  // the box: whole tile rows of all channels where they fit in `box` elements,
  // else a run of columns, else a run of channels; several whole tiles side by
  // side where one tile is smaller than a box
  const bool vec = C % K == 0 && aligned16(g) && aligned16(dfeat);
  const int box = vec ? box_elements<T, uint4>() : box_elements<T, T>();
  Plan q{H, W, C, block, halo, nby, nbx, (halo + block - 1) / block};
  q.Cc = std::min(C, box);
  q.Wc = std::min(block, box / q.Cc);
  q.R = std::min(block, box / (q.Wc * q.Cc));
  if (q.R == block && q.Wc == block)
    q.Wc = block * std::max(1, std::min(box / (block * block * q.Cc), nbx));
  q.span = std::max(q.Wc, block);
  q.cper = (q.span + q.Wc - 1) / q.Wc;
  q.rper = (block + q.R - 1) / q.R;
  q.nbr = nby * q.rper;
  q.nbc = (W + q.span - 1) / q.span * q.cper;
  q.nbch = (C + q.Cc - 1) / q.Cc;
  const bool vec_out = W % K == 0 && block % K == 0 && q.Wc % K == 0 && aligned16(dfeat);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dfeat);
#define PULL(V, L) launch_pull<T, V, L>(gt, starts, list, out, N, q, stream)
  if (!plane) return vec ? PULL(uint4, kPixel) : PULL(T, kPixel);
  if (vec_out) return vec ? PULL(uint4, kPlaneVec) : PULL(T, kPlaneVec);
  return vec ? PULL(uint4, kPlaneElem) : PULL(T, kPlaneElem);
#undef PULL
}

// The index pass alone: writes the CSR lists into `scratch` (see below).
cudaError_t launch_index(const void* idx_n, const void* idx_by, const void* idx_bx, int* scratch,
                         int cap, int N, int nby, int nbx, cudaStream_t s) {
  const int n_tiles = N * nby * nbx;
  const size_t smem = (static_cast<size_t>(cap) + n_tiles + 1 + kIndexThreads) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        build_tile_lists, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  build_tile_lists<<<1, kIndexThreads, smem, s>>>(
      static_cast<const int64_t*>(idx_n), static_cast<const int64_t*>(idx_by),
      static_cast<const int64_t*>(idx_bx), cap, N, nby, nbx, scratch, scratch + n_tiles + 1);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g is contiguous (cap, S, S, C); indices
// are int64 device arrays of length cap; dfeat is written whole: contiguous
// (N, H, W, C) when plane == 0, contiguous (N, C, H, W) when plane == 1.
// scratch holds n_tiles + 1 + cap ints, n_tiles = N * ceil(H/block) *
// ceil(W/block). The index pass takes (cap + n_tiles + 1 + kIndexThreads) * 4
// bytes of shared memory, which the caller checks against the card's limit;
// the pull takes at most 64 KB plus 4 KB, whatever the shapes.
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
  int* starts = static_cast<int*>(scratch);
  int* list = starts + N * nby * nbx + 1;
  cudaError_t err = launch_index(idx_n, idx_by, idx_bx, starts, cap, N, nby, nbx, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0 ? launch<float>(g, starts, list, dfeat, N, H, W, C, block, halo, nby, nbx,
                                   plane != 0, s)
                   : launch<__nv_bfloat16>(g, starts, list, dfeat, N, H, W, C, block, halo,
                                           nby, nbx, plane != 0, s);
  return static_cast<int>(err);
}

// The index pass of gather_patches_bwd_launch alone, with the same arguments
// and scratch: lets a caller time it apart from the pull with CUDA events.
extern "C" int gather_patches_bwd_index_launch(const void* idx_n, const void* idx_by,
                                               const void* idx_bx, void* scratch, int cap,
                                               int N, int H, int W, int block, void* stream) {
  if (cap < 0 || N < 0 || H < 0 || W < 0 || block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nby = (H + block - 1) / block, nbx = (W + block - 1) / block;
  return static_cast<int>(launch_index(idx_n, idx_by, idx_bx, static_cast<int*>(scratch), cap,
                                       N, nby, nbx, static_cast<cudaStream_t>(stream)));
}
