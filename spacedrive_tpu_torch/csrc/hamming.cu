// hamming_near_mask: the Hamming near mask of two digest tiles, on Hopper.
//
// Replaces the JAX package's `hamming_tile` + `_near_mask_tile`
// (spacedrive_tpu/ops/hamming.py:34-40 and :68-70; jnp XOR +
// population_count, no Pallas counterpart), which `near_dup_pairs` runs
// when all N digests fit one tile, with the host's `np.triu(mask, k=1)`
// folded in. For x [n, W] and y [m, W] uint32 words (int32 tensors of
// uint32 bits) it writes the [n, m] byte mask
//
//   out[r, c] = popcount(x[r] ^ y[c]) <= threshold
//               && gi < gj && gi < N && gj < N,   gi = oi + r, gj = oj + c.
//
// What bounds it: W popcounts for each in-range pair (gi < gj, both below
// N: about n*m/2 when x is y), which Hopper issues at 16 per SM per clock,
// against n*m mask bytes written once (W*4 bytes of input per row and column
// are noise). At W = 2 the mask bytes bound; at W = 8 the popcounts. The
// design keeps both at one touch: a block stages ROWS rows of x in shared
// memory, each thread keeps its COLS columns of y in registers and walks the
// rows, so every x and y word is read from device memory once per block, and
// each thread writes its COLS mask bytes of a row as one 4-byte store
// (neighbouring lanes, neighbouring addresses). A row with no in-range pair
// among the thread's columns (on or below the diagonal, or past N) is
// stored as zeros without its popcounts.
//
// The in-range pairs form a triangle, and a grid of contiguous tiles fits
// one wave at n = 4096: the SMs whose tiles lie above the diagonal would set
// the time while the others idle. So a block's rows are strided over all n
// (row by + i * gridDim.y) and its warps' 128-column chunks over all m
// (chunk bx + w * gridDim.x): every block, and so every SM, holds about the
// same share of the triangle.
//
// Built by ops/_build.py with nvcc for sm_90a at first use; called through
// ops/hamming_cuda.py, whose plain torch version (a SWAR popcount) it is
// held against.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;    // mask columns per thread: one 4-byte store
constexpr int ROWS = 32;   // x rows per block, staged in shared memory
constexpr int MAX_WORDS = 8;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_COLS = 32 * COLS;  // mask columns per warp

template <int W>
__global__ void __launch_bounds__(THREADS)
hamming_near_mask_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                         int64_t n, int64_t m, int threshold, int64_t oi, int64_t oj,
                         int64_t n_valid, uint8_t* __restrict__ out) {
  __shared__ uint32_t xs[ROWS * W];
  const int64_t row_stride = gridDim.y;  // ceil(n / ROWS): rows r0 + i * row_stride
  const int64_t r0 = blockIdx.y;
  for (int i = threadIdx.x; i < ROWS * W; i += THREADS) {
    const int64_t r = r0 + (i / W) * row_stride;
    xs[i] = r < n ? x[r * W + i % W] : 0u;
  }
  __syncthreads();
  const int64_t chunk = blockIdx.x + (int64_t)gridDim.x * (threadIdx.x / 32);
  const int64_t c0 = chunk * WARP_COLS + (threadIdx.x % 32) * COLS;
  if (c0 >= m) return;

  uint32_t yw[COLS][W];
  bool col_ok[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int64_t col = c0 + c;
    col_ok[c] = col < m && oj + col < n_valid;
#pragma unroll
    for (int w = 0; w < W; ++w) yw[c][w] = col < m ? y[col * W + w] : 0u;
  }
  // Rows gi < live_end may pair with one of this thread's columns: gi is
  // below the largest in-range gj, which is itself below n_valid.
  const int64_t last_col = (c0 + COLS < m ? c0 + COLS : m) - 1;
  const int64_t live_end = oj + last_col < n_valid ? oj + last_col : n_valid - 1;
  const bool vector_store = c0 + COLS <= m && (m % COLS) == 0;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int64_t r = r0 + rr * row_stride;
    if (r >= n) break;
    const int64_t gi = oi + r;
    uint32_t packed = 0;
    if (gi < live_end) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) d += __popc(xs[rr * W + w] ^ yw[c][w]);
        const bool near = d <= threshold && col_ok[c] && gi < oj + c0 + c;
        packed |= (uint32_t)near << (8 * c);
      }
    }
    uint8_t* dst = out + r * m + c0;
    if (vector_store) {
      *reinterpret_cast<uint32_t*>(dst) = packed;
    } else {
      for (int c = 0; c < COLS && c0 + c < m; ++c) dst[c] = (uint8_t)(packed >> (8 * c));
    }
  }
}

template <int W>
void launch(const void* x, const void* y, int64_t n, int64_t m, int threshold, int64_t oi,
            int64_t oj, int64_t n_valid, void* out, cudaStream_t stream) {
  const int64_t chunks = (m + WARP_COLS - 1) / WARP_COLS;
  const dim3 grid((unsigned)((chunks + WARPS - 1) / WARPS), (unsigned)((n + ROWS - 1) / ROWS));
  hamming_near_mask_kernel<W><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), n, m, threshold, oi,
      oj, n_valid, static_cast<uint8_t*>(out));
}

}  // namespace

extern "C" {

// x [n, words], y [m, words] uint32 (words 1..8), out [n, m] bytes, all on
// the current device; launched on `stream`. Returns the launch's CUDA error
// (0 on success). The grid's y extent holds n up to 65535 * ROWS rows.
int sd_hamming_near_mask(const void* x, const void* y, int64_t n, int64_t m, int64_t words,
                         int64_t threshold, int64_t oi, int64_t oj, int64_t n_valid, void* out,
                         void* stream) {
  if (n < 1 || m < 1 || (n + ROWS - 1) / ROWS > 65535 || words < 1 || words > MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  const int thr = threshold < -1 ? -1 : (threshold > 1 << 20 ? 1 << 20 : (int)threshold);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch<1>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 2: launch<2>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 3: launch<3>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 4: launch<4>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 5: launch<5>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 6: launch<6>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    case 7: launch<7>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
    default: launch<8>(x, y, n, m, thr, oi, oj, n_valid, out, s); break;
  }
  return (int)cudaGetLastError();
}

const char* sd_hamming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
