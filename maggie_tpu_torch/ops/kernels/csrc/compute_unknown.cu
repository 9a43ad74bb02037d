// Fused uncertainty region (eval compute_unknown): threshold + cv2 elliptical
// dilation of float alpha maps.
//
// Replaces the TPU kernel maggie_tpu/ops/pallas/unknown.py::compute_unknown_pallas
// (body _unknown_kernel):
//     u   = (lo < a < hi)
//     out = OR over the element's offsets (dy, dx) of u[y + dy][x + dx]
// written as 0/1 floats, zero outside the map (zero never wins a max over a
// 0/1 map, so this is exact).
//
// Bound on the H100: bytes, one f32 read and one f32 write per pixel; the logic
// is a few integer operations per 32 pixels. The work per SM is small (the main
// path's three maps are 7 MB), so what costs is latency: instructions and
// phases that wait on each other inside a block. What the design does about it:
//
// - Strips that stream. A block owns a 128-column strip of a band of rows of
//   one map and walks down the band's staged rows (ry above and below) in
//   chunks of 32 or 40 rows (8 or 10 warps: the host takes the one that pads
//   the band less). Each chunk is copied with 16-byte cp.async into one of
//   two staging buffers (the strip and the 16 columns on each side that an
//   element of half width <= 16 can reach; zeros off the map) one chunk ahead
//   of use: while a chunk is dilated and stored, the next one's loads are in
//   flight. The host sizes the bands so that the grid is a whole number of
//   blocks per SM.
// - One bit per pixel. Each warp takes 4 rows of the chunk; for each row and
//   each 32-column word (the 4 strip words and a guard word on each side) the
//   lanes read one staged pixel each and __ballot_sync makes the word (bit i
//   is column 32w + i).
// - Dilation on words, with the element fixed at compile time: one instance
//   per element width (1 to 33), whose row runs (dy, [a, b]) and their nested
//   extents come from constexpr code that repeats cv2's MORPH_ELLIPSE, so that
//   every loop below unrolls into shifts and loads with immediate operands.
//   Pass A: per staged word, one warp of a pair takes the columns left of the
//   word and the other the rest; each widens an OR of funnel shifts
//   (__funnelshift_r of the word and a neighbour) over the extents in turn
//   and keeps each extent's OR in shared memory, by staged row. Pass B: per
//   output word, the OR over the runs of its extent's words at row y + dy:
//   one 8-byte shared load and two ORs per run.
// - 16-byte stores as soon as a row is done, straight from pass B's
//   registers: each lane fetches its word with one shuffle, expands one
//   nibble into four 0/1 floats and writes one float4; neighbouring lanes
//   write neighbouring addresses.
// - Alignment decided once, on the host: the 16-byte instance runs when both
//   pointers are 16-byte aligned and W is a multiple of 4 (the main path's
//   W = 1024); otherwise the element instance copies and stores the same four
//   pixels per lane one float at a time.
//
// tests/test_torch_kernels.py emulates this work plan in numpy
// (test_kernel_plan_matches_plain) and holds the constexpr element against the
// port's cv2 replica; ops/kernels/unknown.py::plan is the host's half.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kStripWords = 4;                  // 128 output columns per strip
constexpr int kRowWords = kStripWords + 2;      // a guard word on each side
constexpr int kStageLanes = kStripWords * 8 + 8;  // strip + 16 guard columns a side
constexpr int kStageFloats = kStageLanes * 4;
constexpr int kPackRows = 4;                    // rows each warp packs
constexpr int kUnitRows = 32 / kStripWords;     // rows of one warp in passes A and B
constexpr int kStages = 2;                      // chunks in the staging ring
constexpr int kMaxHalo = 16;                    // rx, ry <= 16: widths up to 33
constexpr int kMaxWidth = 2 * kMaxHalo + 1;
constexpr int kMaxBandRows = 128;
// Chunks of 32 or 40 staged rows (8 or 10 warps), whichever pads the band's
// staged rows less: the host chooses. Both divide kMaxStaged.
constexpr int kMaxStaged = 160;
static_assert(kMaxStaged >= kMaxBandRows + 2 * kMaxHalo && kMaxStaged % 32 == 0 &&
                  kMaxStaged % 40 == 0, "staged rows of a band, in whole chunks");

// cv2 MORPH_ELLIPSE of `width` as row runs (dy, [a, b]) around the anchor,
// sorted so that the extents nest, and its distinct extents. cv2 takes, for
// row dy of |dy| <= r = width / 2, dx = round(r sqrt(1 - dy^2 / r^2)), which
// is the integer nearest sqrt(r^2 - dy^2) (never a tie for integers), and
// columns [max(r - dx, 0), min(r + dx + 1, width)).
struct Element {
  int n_runs = 0, n_ext = 0, ry = 0;
  int dy[kMaxWidth] = {}, a[kMaxWidth] = {}, b[kMaxWidth] = {}, ext[kMaxWidth] = {};
  int ea[kMaxWidth] = {}, eb[kMaxWidth] = {};  // distinct extents, narrowest first
};

__host__ __device__ constexpr int nearest_sqrt(int n) {
  int k = 0;
  while ((k + 1) * (k + 1) <= n) ++k;
  return n - k * k > k ? k + 1 : k;  // n >= k^2 + k + 1 iff sqrt(n) > k + 1/2
}

__host__ __device__ constexpr Element make_element(int width) {
  Element el;
  const int r = width / 2;
  if (width <= 1) {  // the single pixel
    el.n_runs = el.n_ext = 1;
    return el;
  }
  for (int dy = -r; dy < width - r; ++dy) {
    const int dx = nearest_sqrt(r * r - dy * dy);
    el.dy[el.n_runs] = dy;
    el.a[el.n_runs] = (r - dx > 0 ? r - dx : 0) - r;
    el.b[el.n_runs] = (r + dx + 1 < width ? r + dx + 1 : width) - 1 - r;
    ++el.n_runs;
  }
  for (int i = 1; i < el.n_runs; ++i)  // insertion sort by (extent width, dy)
    for (int j = i; j > 0; --j) {
      const int wj = el.b[j] - el.a[j], wp = el.b[j - 1] - el.a[j - 1];
      if (wj > wp || (wj == wp && el.dy[j] > el.dy[j - 1])) break;
      const int t0 = el.dy[j], t1 = el.a[j], t2 = el.b[j];
      el.dy[j] = el.dy[j - 1];
      el.a[j] = el.a[j - 1];
      el.b[j] = el.b[j - 1];
      el.dy[j - 1] = t0;
      el.a[j - 1] = t1;
      el.b[j - 1] = t2;
    }
  for (int k = 0; k < el.n_runs; ++k) {
    if (el.n_ext == 0 || el.ea[el.n_ext - 1] != el.a[k] || el.eb[el.n_ext - 1] != el.b[k]) {
      el.ea[el.n_ext] = el.a[k];
      el.eb[el.n_ext] = el.b[k];
      ++el.n_ext;
    }
    el.ext[k] = el.n_ext - 1;
    const int ady = el.dy[k] < 0 ? -el.dy[k] : el.dy[k];
    el.ry = el.ry > ady ? el.ry : ady;
  }
  return el;
}

__host__ __device__ constexpr bool element_ok(const Element& el) {  // what the passes rely on
  for (int e = 0; e < el.n_ext; ++e) {
    if (el.ea[e] > 0 || el.eb[e] < 0 || el.ea[e] < -kMaxHalo || el.eb[e] > kMaxHalo)
      return false;
    if (e > 0 && (el.ea[e] > el.ea[e - 1] || el.eb[e] < el.eb[e - 1])) return false;
  }
  return el.n_runs > 0 && el.ry <= kMaxHalo;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Bytes of the staging ring, of one chunk's words and of all dynamic shared
// memory (pass A's ORs at the end).
template <int kChunkRows>
__host__ __device__ constexpr size_t stage_bytes() {
  return size_t(kStages) * kChunkRows * kStageFloats * sizeof(float);
}
template <int kChunkRows>
__host__ __device__ constexpr size_t bits_bytes() {
  return size_t(kChunkRows) * kRowWords * sizeof(unsigned);
}
template <int kWidth, int kChunkRows>
__host__ __device__ constexpr size_t smem_bytes() {
  return stage_bytes<kChunkRows>() + bits_bytes<kChunkRows>() +
         size_t(make_element(kWidth).n_ext) * kMaxStaged * kStripWords * sizeof(uint2);
}

// Shared memory (dynamic): the staging ring [kStages][kChunkRows][kStageFloats],
// the chunk's words [kChunkRows][kRowWords], then pass A's ORs
// [n_ext][kMaxStaged][kStripWords] as (left, right) pairs.
template <bool kVec, int kWidth, int kChunkRows>
__global__ void __launch_bounds__(kChunkRows * 8, 2)
    compute_unknown_kernel(const float* __restrict__ alpha, float* __restrict__ out, int H,
                           int W, int band_rows, float lo, float hi) {
  constexpr int kThreads = kChunkRows * 8, kWarps = kThreads / 32;
  static_assert(kWarps * kPackRows == kChunkRows && kWarps * kUnitRows == 2 * kChunkRows,
                "a warp packs 4 rows; a warp pair takes 8 rows in pass A");
  constexpr Element el = make_element(kWidth);
  static_assert(element_ok(el), "element outside the kernel's limits");
  constexpr int ry = el.ry;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_stage = reinterpret_cast<float*>(smem_raw);
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem_raw + stage_bytes<kChunkRows>());
  uint2* s_h = reinterpret_cast<uint2*>(smem_raw + stage_bytes<kChunkRows>() +
                                        bits_bytes<kChunkRows>());
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* a_m = alpha + blockIdx.z * plane;
  float* o_m = out + blockIdx.z * plane;
  const int y0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, H - y0);  // output rows of this band
  const int staged = rows + 2 * ry;          // staged row s is map row y0 - ry + s
  const int n_chunks = (staged + kChunkRows - 1) / kChunkRows;
  const int x0 = blockIdx.y * kStripWords * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage float f of a row is column x0 - 16 + f
  auto issue = [&](int chunk) {
    if (chunk < n_chunks) {
      float* stage = s_stage + (chunk % kStages) * kChunkRows * kStageFloats;
      for (int item = tid; item < kChunkRows * kStageLanes; item += kThreads) {
        const int s = chunk * kChunkRows + item / kStageLanes;
        const int y = y0 - ry + s;
        const int x = x0 - 16 + (item % kStageLanes) * 4;
        const bool row_ok = s < staged && y >= 0 && y < H;
        const float* src = a_m + static_cast<int64_t>(y) * W + x;
        float* dst = stage + item * 4;
        if constexpr (kVec) {
          if (row_ok && x >= 0 && x < W)
            cp_async<16>(dst, src);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (row_ok && x + k >= 0 && x + k < W)
              cp_async<4>(dst + k, src + k);
            else
              dst[k] = 0.0f;
          }
        }
      }
    }
    cp_async_commit();  // one group per chunk, empty past the last
  };

  for (int c = 0; c < kStages - 1; ++c) issue(c);
  int done = 0;  // output rows stored so far
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);  // into the stage that chunk c - 1 left
    cp_async_wait_ring();    // this thread's copies of chunk c have landed
    __syncthreads();         // everyone's have
    {  // words of the warp's rows: bit i of word j is stage float 32 j - 16 + i.
      // All loads first, one store per lane last, so that nothing orders the
      // loads behind the stores.
      const float* stage = s_stage + (c % kStages) * kChunkRows * kStageFloats;
      float v[kPackRows][kRowWords];
#pragma unroll
      for (int i = 0; i < kPackRows; ++i)
#pragma unroll
        for (int j = 0; j < kRowWords; ++j) {
          const int f = 32 * j - 16 + lane;
          v[i][j] = f >= 0 && f < kStageFloats
                        ? stage[(warp * kPackRows + i) * kStageFloats + f] : 0.0f;
        }
      unsigned mine = 0u;  // word lane / kRowWords of row lane % kRowWords, in order
#pragma unroll
      for (int i = 0; i < kPackRows; ++i)
#pragma unroll
        for (int j = 0; j < kRowWords; ++j) {
          const unsigned word = __ballot_sync(0xffffffffu, v[i][j] > lo && v[i][j] < hi);
          if (lane == i * kRowWords + j) mine = word;
        }
      if (lane < kPackRows * kRowWords) s_bits[warp * kPackRows * kRowWords + lane] = mine;
    }
    __syncthreads();
    // pass A: warps 2q and 2q + 1 take rows 8q .. 8q + 7 of the chunk, one
    // lane per (row, strip word); the even warp ORs dx in [a, -1], the odd
    // one dx in [0, b]. Warps whose rows lie past the band skip it.
    const int a_row = (warp / 2) * kUnitRows + lane / kStripWords, a_word = lane % kStripWords;
    if (c * kChunkRows + (warp / 2) * kUnitRows < staged) {
      const unsigned* word = s_bits + a_row * kRowWords + a_word;  // left, word, right
      unsigned* h_out =
          reinterpret_cast<unsigned*>(s_h + (c * kChunkRows + a_row) * kStripWords + a_word) +
          (warp & 1);
      unsigned h = 0u;
      if (warp & 1) {
        const unsigned vc = word[1], vn = word[2];
#pragma unroll
        for (int e = 0; e < el.n_ext; ++e) {
#pragma unroll
          for (int d = e ? el.eb[e - 1] + 1 : 0; d <= el.eb[e]; ++d)
            h |= __funnelshift_r(vc, vn, d);
          h_out[e * kMaxStaged * kStripWords * 2] = h;
        }
      } else {
        const unsigned vp = word[0], vc = word[1];
#pragma unroll
        for (int e = 0; e < el.n_ext; ++e) {
          // column -d is a right shift by 32 - d of (word : left word)
#pragma unroll
          for (int d = e ? 1 - el.ea[e - 1] : 1; d <= -el.ea[e]; ++d)
            h |= __funnelshift_r(vp, vc, 32 - d);
          h_out[e * kMaxStaged * kStripWords * 2] = h;
        }
      }
    }
    __syncthreads();  // pass A's ORs hold every row of the chunk
    // pass B: output row r needs staged rows r .. r + 2 ry; at most kChunkRows
    // new ones. Warp q takes 8 of them, one lane per (row, strip word).
    const int ready = min(rows, (c + 1) * kChunkRows - 2 * ry);
    const int n_new = ready - done;
    if (n_new > warp * kUnitRows) {  // this warp has rows to store
      const int b_row = warp * kUnitRows + lane / kStripWords;
      const uint2* h_in = s_h + (done + b_row + ry) * kStripWords + lane % kStripWords;
      unsigned acc = 0u;
      if (b_row < n_new) {
#pragma unroll
        for (int k = 0; k < el.n_runs; ++k) {
          const uint2 lr = h_in[(el.ext[k] * kMaxStaged + el.dy[k]) * kStripWords];
          acc |= lr.x | lr.y;
        }
      }
      // store: lane l writes columns 4l .. 4l + 3 of each of the warp's rows
      const int x = x0 + lane * 4;
#pragma unroll
      for (int i = 0; i < kUnitRows; ++i) {
        const unsigned word = __shfl_sync(0xffffffffu, acc, i * kStripWords + lane / 8);
        const int r = warp * kUnitRows + i;
        if (r >= n_new || x >= W) continue;
        const unsigned nib = word >> (4 * (lane % 8));
        const float4 o = make_float4(static_cast<float>(nib & 1u),
                                     static_cast<float>((nib >> 1) & 1u),
                                     static_cast<float>((nib >> 2) & 1u),
                                     static_cast<float>((nib >> 3) & 1u));
        float* p = o_m + static_cast<int64_t>(y0 + done + r) * W + x;
        if constexpr (kVec) {
          *reinterpret_cast<float4*>(p) = o;
        } else {
          p[0] = o.x;
          if (x + 1 < W) p[1] = o.y;
          if (x + 2 < W) p[2] = o.z;
          if (x + 3 < W) p[3] = o.w;
        }
      }
    }
    done = max(done, ready);
  }
}

using Launch = cudaError_t (*)(const float*, float*, int, int, int, int, float, float,
                               cudaStream_t);

template <bool kVec, int kWidth, int kChunkRows>
cudaError_t launch(const float* alpha, float* out, int M, int H, int W, int band_rows,
                   float lo, float hi, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kWidth, kChunkRows>();
  auto kernel = compute_unknown_kernel<kVec, kWidth, kChunkRows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_strips = (W + kStripWords * 32 - 1) / (kStripWords * 32);
  const dim3 grid((H + band_rows - 1) / band_rows, n_strips, M);
  kernel<<<grid, kChunkRows * 8, smem, stream>>>(alpha, out, H, W, band_rows, lo, hi);
  return cudaGetLastError();
}

// one instance per width 1 .. kMaxWidth, indexed by width - 1
template <bool kVec, int kChunkRows, int... kIndex>
constexpr std::array<Launch, sizeof...(kIndex)> launch_table(
    std::integer_sequence<int, kIndex...>) {
  return {launch<kVec, kIndex + 1, kChunkRows>...};
}
template <bool kVec, int kChunkRows>
constexpr auto kLaunch = launch_table<kVec, kChunkRows>(
    std::make_integer_sequence<int, kMaxWidth>{});

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// alpha, out: contiguous float32 device arrays (M, H, W). width: the element
// width k_size // 2, 0 to 33 (0 and 1 are the single pixel). band_rows: output
// rows per thread block, 1 to 128. chunk_rows: 32 or 40. vec: 1 for the
// 16-byte instance (both pointers 16-byte aligned, W % 4 == 0), 0 for the
// element instance. Launches on `stream`; returns cudaGetLastError().
extern "C" int compute_unknown_launch(const void* alpha, void* out, int M, int H, int W,
                                      float lo, float hi, int width, int band_rows,
                                      int chunk_rows, int vec, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const int n_strips = (W + kStripWords * 32 - 1) / (kStripWords * 32);
  if (width < 0 || width > kMaxWidth || band_rows < 1 || band_rows > kMaxBandRows ||
      (chunk_rows != 32 && chunk_rows != 40) || M > 65535 || n_strips > 65535 ||
      (vec && !(aligned16(alpha) && aligned16(out) && W % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto& table = chunk_rows == 32 ? (vec ? kLaunch<true, 32> : kLaunch<false, 32>)
                                       : (vec ? kLaunch<true, 40> : kLaunch<false, 40>);
  const Launch fn = table[width > 1 ? width - 1 : 0];
  return static_cast<int>(fn(static_cast<const float*>(alpha), static_cast<float*>(out), M, H,
                             W, band_rows, lo, hi, static_cast<cudaStream_t>(stream)));
}
