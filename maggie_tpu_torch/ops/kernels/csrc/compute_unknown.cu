// Fused uncertainty region (eval compute_unknown): threshold + cv2 elliptical
// dilation of float alpha maps.
//
// Replaces the TPU kernel maggie_tpu/ops/pallas/unknown.py::compute_unknown_pallas
// (body _unknown_kernel):
//     u   = (lo < a < hi)
//     out = OR over the element's row runs (dy, [ra, rb]) of
//           (OR over dx in [ra, rb] of u[y + dy][x + dx])
// written as 0/1 floats. The run table is the port's _ellipse_row_runs, sorted
// by the host so that the extents [ra, rb] nest (each contains the previous).
//
// Bound on the H100: bytes (one f32 read and one f32 write per pixel); the
// logic is a handful of integer ORs per pixel.
// Design: one CUDA block per (map, kTileH-row, kTileW-column) tile, one thread
// per staged column. The block stages its tile plus the halo (ry rows above
// and below, rx columns left and right), thresholding on load, as one 64-bit
// mask per column: bit j of column c is u at staged row j. Loads along a row
// are coalesced across threads, and each thread issues all of its column's
// loads before using them. Each of the first kTileW threads then owns one
// output column: it widens a running horizontal OR over the nested extents,
// taking each distinct extent's horizontal max once, and ORs in the vertical
// shift of each row run with a single 64-bit shift. The result for all kTileH
// rows is one register.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileW = 128;    // output columns per block
constexpr int kTileH = 32;     // output rows per block (bits of the accumulator)
constexpr int kMaxHalo = 16;   // kTileH + 2 * ry <= 64 bits
constexpr int kMaxRows = kTileH + 2 * kMaxHalo;
constexpr int kThreads = kTileW + 2 * kMaxHalo;  // one thread per staged column
constexpr int kMaxRuns = 64;

struct RunTable {
  int n;
  int dy[kMaxRuns];
  int a[kMaxRuns];
  int b[kMaxRuns];
};

__global__ void compute_unknown_kernel(const float* __restrict__ alpha,
                                       float* __restrict__ out, int H, int W,
                                       float lo, float hi, RunTable runs, int ry,
                                       int rx) {
  __shared__ unsigned long long s_col[kTileW + 2 * kMaxHalo];
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* a_m = alpha + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int rows = kTileH + 2 * ry;
  const int ncols = kTileW + 2 * rx;

  // stage: bit j of column c = u(y0 - ry + j, x0 - rx + c); zero off the map.
  // One thread per staged column; the loads are issued before they are used
  // (unrolled into registers) so that their latencies overlap.
  const int c = threadIdx.x;
  if (c < ncols) {
    const int x = x0 - rx + c;
    const bool x_ok = x >= 0 && x < W;
    float v[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      const int y = y0 - ry + j;
      v[j] = (x_ok && j < rows && y >= 0 && y < H) ? a_m[static_cast<int64_t>(y) * W + x]
                                                   : 0.0f;
    }
    unsigned long long bits = 0ull;
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      bits |= static_cast<unsigned long long>(v[j] > lo && v[j] < hi) << j;
    s_col[c] = bits;
  }
  __syncthreads();

  // dilate: widen the horizontal OR over nested extents, shift-OR each run
  if (threadIdx.x >= kTileW) return;
  const int base = threadIdx.x + rx;
  unsigned long long h = 0ull;
  unsigned long long acc = 0ull;
  int ca = 0, cb = -1;  // current extent, empty
  for (int k = 0; k < runs.n; ++k) {
    const int ra = runs.a[k], rb = runs.b[k];
    if (ca > cb) {
      for (int d = ra; d <= rb; ++d) h |= s_col[base + d];
    } else {
      for (int d = ra; d < ca; ++d) h |= s_col[base + d];
      for (int d = cb + 1; d <= rb; ++d) h |= s_col[base + d];
    }
    ca = ra;
    cb = rb;
    acc |= h >> (ry + runs.dy[k]);
  }

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  float* o_m = out + blockIdx.z * plane;
  for (int y = 0; y < kTileH && y0 + y < H; ++y) {
    o_m[static_cast<int64_t>(y0 + y) * W + x] =
        static_cast<float>((acc >> y) & 1ull);
  }
}

}  // namespace

// alpha, out: contiguous float32 device arrays (M, H, W). dy/ra/rb: host arrays
// of n_runs row runs, extents nested in order. ry/rx: the largest |dy| and
// |dx|. Returns cudaGetLastError().
extern "C" int compute_unknown_launch(const void* alpha, void* out, int M,
                                      int H, int W, float lo, float hi,
                                      const int* dy, const int* ra,
                                      const int* rb, int n_runs, int ry, int rx,
                                      void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (n_runs < 1 || n_runs > kMaxRuns || ry < 0 || ry > kMaxHalo || rx < 0 ||
      rx > kMaxHalo || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  RunTable runs;
  runs.n = n_runs;
  for (int k = 0; k < n_runs; ++k) {
    if (dy[k] < -ry || dy[k] > ry || ra[k] < -rx || rb[k] > rx || ra[k] > rb[k])
      return static_cast<int>(cudaErrorInvalidValue);
    runs.dy[k] = dy[k];
    runs.a[k] = ra[k];
    runs.b[k] = rb[k];
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, M);
  compute_unknown_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<float*>(out), H, W, lo, hi,
      runs, ry, rx);
  return static_cast<int>(cudaGetLastError());
}
