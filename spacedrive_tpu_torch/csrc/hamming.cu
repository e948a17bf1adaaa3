// The Hamming near search on Hopper's tensor cores: a mask form and a count
// form of one design.
//
// Replaces jnp code of the JAX package that has no Pallas counterpart
// (spacedrive_tpu/ops/hamming.py):
//
// - hamming_near_mask: `hamming_tile` + `_near_mask_tile` (:34-40, :68-70),
//   which `near_dup_pairs` runs when all N digests fit one tile, with the
//   host's `np.triu(mask, k=1)` and the pyramid's range mask folded in. For
//   x [n, W] and y [m, W] uint32 words it writes the [n, m] byte mask
//
//     out[r, c] = dot(x[r], y[c]) >= 32W - 2t
//                 && gi < gj && gi < N && gj < N,   gi = oi + r, gj = oj + c.
//
// - hamming_near_counts: `_tile_counts_block` (:260) and `_refine_body` /
//   `_refine_counts` (:290, :313), the pyramid's counts sweep and its
//   refinement. For F blocks of S x S pairs, block f's rows at d[oi_f ...]
//   and columns at d[oj_f ...] of one digest array d, it writes [F, g, g]
//   int32: the in-range pairs within the threshold in each (S/g)^2 sub-block.
//
// Distance as a product: each digest bit maps to a signed byte, +1 or -1,
// so dot(x, y) = 32W - 2 hamming(x, y), exact in the s32 accumulator of
// `wgmma` (s8 x s8, k = 32: one 32-bit word per k step). The planes never
// exist in device memory: a block expands the int32 words it needs into
// +-1 bytes in shared memory, laid out as wgmma's K-major core matrices
// without swizzle (8 rows x 16 bytes each; LBO is the step to the next 16
// bytes of K, SBO to the next 8 rows), read by both operands' descriptors.
//
// What bounds it: the tensor work is 64 W operations a pair, 1979 TOP/s in
// int8; the compare and count on the CUDA cores is 2 operations a pair; the
// mask form also writes one byte a pair. At W = 2 the mask form is bound by
// its bytes, the count form by the compare and count. So the count form
// never writes a product or a mask: each thread takes the max of its
// accumulator registers, and only a warp with a value past the threshold
// (rare: near pairs are) compares and counts them in registers, sums its
// counts with one `redux.sync` per 16-column group, and only nonzero counts
// reach shared and then device memory (atomics into a zeroed output: several blocks may
// share a sub-block when S/g exceeds a block's 256-row band). Tiles with no
// in-range pair (below the diagonal, past N) skip their products; tiles
// wholly in range skip the range mask.
//
// One warpgroup (128 threads) per block; each block takes a band of at most
// 256 rows of one block (count form) or 64 rows x 128 columns (mask form),
// so a launch has many more blocks than the card has SMs and the scheduler
// balances the triangle. A thread stages whole rows, all its loads issued
// before any expansion; the count form loads the next 128-column tile's
// words into registers while it multiplies and counts the current one, and
// expands them into the second of two shared buffers (one barrier a tile).
// The range mask is three int32 compares a pair in tile coordinates.
// `wgmma` rather than `mma.sync`: it is the only way to the card's full
// int8 rate, and K-major s8 operands are what it takes.
//
// Built by ops/_build.py with nvcc for sm_90a at first use; called through
// ops/hamming_cuda.py, whose plain torch versions it is held against.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;     // one warpgroup
constexpr int TILE_M = 64;       // wgmma rows
constexpr int TILE_N = 128;      // wgmma columns: m64n128k32
constexpr int BAND_ROWS = 256;   // count form: rows of a block's band per CTA
constexpr int MAX_WORDS = 8;
constexpr int MAX_SUB = 64;      // count form: g <= 64, so g^2 counters fit
constexpr int CORE = 128;        // bytes of one 8 x 16-byte core matrix
constexpr int OUT_STRIDE = 144;  // mask form: bytes per staged mask row

// Byte offset of row r's 16-byte K chunk c in a plane of W words a row.
template <int W>
__device__ __forceinline__ int chunk_offset(int r, int c) {
  return ((r >> 3) * (2 * W) + c) * CORE + (r & 7) * 16;
}

// Four bits → four bytes: +1 for a set bit, -1 (0xFF) for a clear one. The
// multiply places bit i of the nibble at bit 9i (four disjoint copies).
__device__ __forceinline__ uint32_t signs4(uint32_t v) {
  const uint32_t t = ((v & 0xFu) * 0x00204081u) & 0x01010101u;
  return 0xFFFFFFFFu ^ (t * 0xFEu);
}

// One digest row's words, held in registers between its load and its
// expansion into shared memory.
template <int W>
struct Row {
  uint32_t w[W];
};

// Row `row` of src [n_src, W]; a row past n_src reads as zero words.
template <int W>
__device__ __forceinline__ Row<W> load_row(const uint32_t* __restrict__ src, int64_t row,
                                           int64_t n_src) {
  Row<W> v;
#pragma unroll
  for (int w = 0; w < W; ++w) v.w[w] = row < n_src ? __ldg(src + row * W + w) : 0u;
  return v;
}

// Row r's words as +-1 bytes at dst: 2W 16-byte chunks, one per 16 bits.
// Eight neighbouring threads (rows) fill one 128-byte core matrix.
template <int W>
__device__ __forceinline__ void store_row(uint8_t* dst, int r, const Row<W>& v) {
#pragma unroll
  for (int c = 0; c < 2 * W; ++c) {
    const uint32_t h = (c & 1) ? v.w[c >> 1] >> 16 : v.w[c >> 1];
    uint4 q;
    q.x = signs4(h);
    q.y = signs4(h >> 4);
    q.z = signs4(h >> 8);
    q.w = signs4(h >> 12);
    *reinterpret_cast<uint4*>(dst + chunk_offset<W>(r, c)) = q;
  }
}

// Make the generic-proxy stores to shared memory visible to wgmma's async
// proxy (then a barrier orders them for the other threads).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage `a_rows` (at most 2 * THREADS) rows of a_src [a_n, W] from row
// `a_first` at a_dst, and THREADS rows of b_src [b_n, W] from row `b_first`
// at b_dst (rows past the end read as zero words): every load is issued
// before any expansion, so their latencies overlap in one round trip.
template <int W>
__device__ __forceinline__ void stage_tiles(const uint32_t* __restrict__ a_src, int64_t a_n,
                                            uint8_t* a_dst, int64_t a_first, int a_rows,
                                            const uint32_t* __restrict__ b_src, int64_t b_n,
                                            uint8_t* b_dst, int64_t b_first) {
  Row<W> a[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (threadIdx.x + k * THREADS < a_rows)
      a[k] = load_row<W>(a_src, a_first + threadIdx.x + k * THREADS, a_n);
  const Row<W> b = load_row<W>(b_src, b_first + threadIdx.x, b_n);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (threadIdx.x + k * THREADS < a_rows) store_row<W>(a_dst, threadIdx.x + k * THREADS, a[k]);
  store_row<W>(b_dst, threadIdx.x, b);
  fence_async();
}

template <int W>
__device__ __forceinline__ uint64_t descriptor(const uint8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4)           // start address
         | ((uint64_t)(CORE >> 4) << 16)           // LBO: next 16 bytes of K
         | ((uint64_t)((2 * W * CORE) >> 4) << 32);  // SBO: next 8 rows
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d = a[64 rows] . b[128 rows]^T over W words, a and b staged by stage_tiles.
template <int W>
__device__ __forceinline__ void product(int (&d)[64], const uint8_t* a, const uint8_t* b) {
  const uint64_t da = descriptor<W>(a), db = descriptor<W>(b);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int w = 0; w < W; ++w) wgmma_s8(d, da + 16 * w, db + 16 * w, w);  // 256 B a word
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The accumulator's layout: thread t of the warpgroup holds, for column
// group j < 16, d[4j + 2h + e] at row 16 (t / 32) + (t % 32) / 4 + 8h and
// column 8j + 2 (t % 4) + e.
__device__ __forceinline__ int acc_row(int h) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int acc_col(int j, int e) { return 8 * j + 2 * (threadIdx.x & 3) + e; }

// Does a rows x cols tile at global (gi0, gj0) hold an in-range pair?
__device__ __forceinline__ bool any_in_range(int64_t gi0, int64_t gj0, int64_t rows,
                                             int64_t cols, int64_t n_valid) {
  const int64_t gi_end = min(gi0 + rows, n_valid), gj_end = min(gj0 + cols, n_valid);
  return rows > 0 && cols > 0 && gi0 < gi_end && gj0 < gj_end && gi0 < gj_end - 1;
}

// The range mask of a 64 x 128 tile at global (gi0, gj0) with `rows` and
// `cols` valid, in tile coordinates: pair (r, c) is in range iff
// r < row_lim && c < col_lim && r + diag < c. `inside`: every pair is.
struct TileRange {
  int row_lim, col_lim, diag;
  bool inside;
};

__device__ __forceinline__ TileRange tile_range(int64_t gi0, int64_t gj0, int64_t rows,
                                                int64_t cols, int64_t n_valid) {
  TileRange t;
  t.row_lim = (int)max((int64_t)0, min(rows, n_valid - gi0));
  t.col_lim = (int)max((int64_t)0, min(cols, n_valid - gj0));
  // gi < gj  <=>  r + (gi0 - gj0) < c; clamped, the comparison is unchanged.
  t.diag = (int)max((int64_t)-4 * TILE_N, min((int64_t)4 * TILE_N, gi0 - gj0));
  t.inside = t.row_lim == TILE_M && t.col_lim == TILE_N && t.diag + TILE_M - 1 < 0;
  return t;
}

// -- mask form --------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(THREADS)
near_mask_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y, int64_t n,
                 int64_t m, int dmin, int64_t oi, int64_t oj, int64_t n_valid,
                 int64_t col_tiles, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + TILE_M * 32 * W;
  uint8_t* o_s = b_s + TILE_N * 32 * W;
  const int64_t r0 = (blockIdx.x / col_tiles) * TILE_M;
  const int64_t c0 = (blockIdx.x % col_tiles) * TILE_N;
  const int64_t rows = min((int64_t)TILE_M, n - r0), cols = min((int64_t)TILE_N, m - c0);
  const int64_t gi0 = oi + r0, gj0 = oj + c0;
  const bool live = any_in_range(gi0, gj0, rows, cols, n_valid);
  if (live) {
    stage_tiles<W>(x, n, a_s, r0, TILE_M, y, m, b_s, c0);
    __syncthreads();
    int d[64];
    product<W>(d, a_s, b_s);
    const TileRange t = tile_range(gi0, gj0, rows, cols, n_valid);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = acc_col(j, 0);
        bool n0 = d[4 * j + 2 * h] >= dmin, n1 = d[4 * j + 2 * h + 1] >= dmin;
        if (!t.inside) {
          const bool row_ok = r < t.row_lim;
          n0 = n0 && row_ok && c < t.col_lim && r + t.diag < c;
          n1 = n1 && row_ok && c + 1 < t.col_lim && r + t.diag < c + 1;
        }
        *reinterpret_cast<uint16_t*>(o_s + r * OUT_STRIDE + c) =
            (uint16_t)((int)n0 | ((int)n1 << 8));
      }
    }
    __syncthreads();
  }
  // Coalesced stores: 16 bytes a thread where the rows allow, else bytes.
  if (cols == TILE_N && (m & 15) == 0) {
    for (int i = threadIdx.x; i < TILE_M * TILE_N / 16; i += THREADS) {
      const int r = i >> 3, v = i & 7;
      if (r >= rows) break;
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(out + (r0 + r) * m + c0 + 16 * v) =
          live ? *reinterpret_cast<const uint4*>(o_s + r * OUT_STRIDE + 16 * v) : z;
    }
  } else {
    for (int i = threadIdx.x; i < TILE_M * TILE_N; i += THREADS) {
      const int r = i / TILE_N, c = i % TILE_N;
      if (r >= rows) break;
      if (c < cols) out[(r0 + r) * m + c0 + c] = live ? o_s[r * OUT_STRIDE + c] : 0;
    }
  }
}

// -- count form -------------------------------------------------------------

// Count the near, in-range pairs of one 64 x 128 product `acc` into the
// band's counters (rows relative to the band: rq, columns to the block: c0).
template <bool WIDE>
__device__ __forceinline__ void count_tile(const int (&acc)[64], int dmin, const TileRange& t,
                                           int rq, int c0, int sub, int g, int* counts) {
  // Near pairs are rare: one max a value and one vote a warp skip a tile
  // with none, in range or not, before any compare-and-count.
  // Three-way maxes (Hopper's DPX) in a tree: 32 instructions, short chains.
  int m[22];
#pragma unroll
  for (int i = 0; i < 21; ++i) m[i] = __vimax3_s32(acc[3 * i], acc[3 * i + 1], acc[3 * i + 2]);
  m[21] = acc[63];
#pragma unroll
  for (int i = 0; i < 7; ++i) m[i] = __vimax3_s32(m[3 * i], m[3 * i + 1], m[3 * i + 2]);
  const int mx = max(__vimax3_s32(m[0], m[1], m[2]),
                     __vimax3_s32(m[3], m[4], __vimax3_s32(m[5], m[6], m[21])));
  if (!__any_sync(0xFFFFFFFFu, mx >= dmin)) return;
  if (WIDE) {
    // sub >= 16: a warp's 16 rows lie in one sub-row, a 16-column group in
    // one sub-column. Count per group in registers, sum over the warp.
    int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
      const bool row_ok = r < t.row_lim;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool near = acc[4 * j + 2 * h + e] >= dmin;
          if (!t.inside) {
            const int c = acc_col(j, e);
            near = near && row_ok && c < t.col_lim && r + t.diag < c;
          }
          cnt[j >> 1] += near;
        }
      }
    }
    const int lane = threadIdx.x & 31;
    int* row_counts = counts + ((rq + (threadIdx.x >> 5) * 16) / sub) * g;
    if (sub >= TILE_N) {
      const int total = (int)__reduce_add_sync(
          0xFFFFFFFFu,
          (unsigned)(cnt[0] + cnt[1] + cnt[2] + cnt[3] + cnt[4] + cnt[5] + cnt[6] + cnt[7]));
      if (lane == 0 && total) atomicAdd(row_counts + c0 / sub, total);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int v = (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)cnt[k]);
        if (lane == 0 && v) atomicAdd(row_counts + (c0 + 16 * k) / sub, v);
      }
    }
  } else {
    // Sub-blocks narrower than 16: each near pair adds to its own.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = acc_col(j, e);
          if (acc[4 * j + 2 * h + e] >= dmin && r < t.row_lim && c < t.col_lim &&
              r + t.diag < c)
            atomicAdd(counts + ((rq + r) / sub) * g + (c0 + c) / sub, 1);
        }
      }
    }
  }
}

// Block f's band (rows R0 ... R0 + rb of the block, rb = min(256, S rounded
// up to 64)) against the block's columns, in 128-column tiles: counts per
// sub-block of sub = S / g rows and columns into shared memory, then the
// nonzero ones added into out [F, g, g] (zeroed by the caller). Only the
// tiles with an in-range pair are visited, a contiguous run; each tile's
// column words are loaded into registers while the tile before is
// multiplied and counted, and expanded into the other of two buffers.
template <int W, bool WIDE>
__global__ void __launch_bounds__(THREADS, 5)
near_counts_kernel(const uint32_t* __restrict__ d, int64_t n_rows, const int64_t* __restrict__ origins,
                   int size, int sub, int g, int rb, int bands, int dmin, int64_t n_valid,
                   int* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + rb * 32 * W;  // two buffers of TILE_N rows
  int* counts = reinterpret_cast<int*>(b_s + 2 * TILE_N * 32 * W);
  const int64_t f = blockIdx.x / bands;
  const int R0 = (blockIdx.x % bands) * rb;
  const int64_t oi = origins[2 * f], oj = origins[2 * f + 1];
  const int band_rows = min(rb, size - R0);
  const int64_t gi_band = oi + R0;
  if (!any_in_range(gi_band, oj, band_rows, size, n_valid)) return;
  const int tiles = (size + TILE_N - 1) / TILE_N;
  int t0 = 0, t1 = tiles;
  while (!any_in_range(gi_band, oj + (int64_t)t0 * TILE_N, band_rows,
                       min(TILE_N, size - t0 * TILE_N), n_valid)) ++t0;
  while (!any_in_range(gi_band, oj + (int64_t)(t1 - 1) * TILE_N, band_rows,
                       min(TILE_N, size - (t1 - 1) * TILE_N), n_valid)) --t1;

  const int sub_rows = max(1, band_rows / sub);
  for (int i = threadIdx.x; i < sub_rows * g; i += THREADS) counts[i] = 0;
  stage_tiles<W>(d, n_rows, a_s, gi_band, rb, d, n_rows, b_s, oj + (int64_t)t0 * TILE_N);
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    uint8_t* b_cur = b_s + ((t - t0) & 1) * TILE_N * 32 * W;
    uint8_t* b_next = b_s + ((t - t0 + 1) & 1) * TILE_N * 32 * W;
    Row<W> next;
    if (t + 1 < t1) next = load_row<W>(d, oj + (int64_t)(t + 1) * TILE_N + threadIdx.x, n_rows);
    const int c0 = t * TILE_N;
    const int cols = min(TILE_N, size - c0);
    for (int q = 0; q < rb / TILE_M; ++q) {
      const int rq = q * TILE_M;  // first row of this 64-row group in the band
      const int rows = min(TILE_M, band_rows - rq);
      const int64_t gi0 = gi_band + rq, gj0 = oj + c0;
      if (!any_in_range(gi0, gj0, rows, cols, n_valid)) continue;
      int acc[64];
      product<W>(acc, a_s + rq * 32 * W, b_cur);
      count_tile<WIDE>(acc, dmin, tile_range(gi0, gj0, rows, cols, n_valid), rq, c0, sub, g,
                       counts);
    }
    if (t + 1 < t1) {
      store_row<W>(b_next, threadIdx.x, next);
      fence_async();
    }
    __syncthreads();
  }
  int* dst = out + (f * g + R0 / sub) * g;
  for (int i = threadIdx.x; i < sub_rows * g; i += THREADS)
    if (counts[i]) atomicAdd(dst + i, counts[i]);
}

template <typename Kernel>
int launch_with_smem(Kernel kernel, int64_t blocks, size_t smem, cudaStream_t stream,
                     const void* const* args) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks), dim3(THREADS),
                       const_cast<void**>(args), smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int dmin_of(int64_t threshold, int words) {
  const int64_t t = threshold < -1 ? -1 : (threshold > 32 * words ? 32 * words : threshold);
  return (int)(32 * words - 2 * t);
}

template <int W>
int mask_launch(const void* x, const void* y, int64_t n, int64_t m, int dmin, int64_t oi,
                int64_t oj, int64_t n_valid, void* out, cudaStream_t stream) {
  int64_t col_tiles = (m + TILE_N - 1) / TILE_N;
  const int64_t blocks = ((n + TILE_M - 1) / TILE_M) * col_tiles;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (TILE_M + TILE_N) * 32 * W + TILE_M * OUT_STRIDE;
  const void* args[] = {&x, &y, &n, &m, &dmin, &oi, &oj, &n_valid, &col_tiles, &out};
  return launch_with_smem(near_mask_kernel<W>, blocks, smem, stream, args);
}

template <int W>
int counts_launch(const void* d, int64_t n_rows, const void* origins, int64_t F, int size,
                  int g, int dmin, int64_t n_valid, void* out, cudaStream_t stream) {
  int sub = size / g;
  int rb = size >= BAND_ROWS ? BAND_ROWS : ((size + TILE_M - 1) / TILE_M) * TILE_M;
  int bands = (size + rb - 1) / rb;
  if (F * bands > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (rb + 2 * TILE_N) * 32 * W + sizeof(int) * g * g;
  const void* args[] = {&d, &n_rows, &origins, &size, &sub, &g, &rb, &bands, &dmin,
                        &n_valid, &out};
  if (sub >= 16) return launch_with_smem(near_counts_kernel<W, true>, F * bands, smem, stream, args);
  return launch_with_smem(near_counts_kernel<W, false>, F * bands, smem, stream, args);
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// x [n, words], y [m, words] uint32 (words 1..8), out [n, m] bytes, all on
// the current device; launched on `stream`. Returns the launch's CUDA error
// (0 on success).
int sd_hamming_near_mask(const void* x, const void* y, int64_t n, int64_t m, int64_t words,
                         int64_t threshold, int64_t oi, int64_t oj, int64_t n_valid, void* out,
                         void* stream) {
  if (n < 1 || m < 1 || words < 1 || words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  const int dmin = dmin_of(threshold, (int)words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: return mask_launch<1>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 2: return mask_launch<2>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 3: return mask_launch<3>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 4: return mask_launch<4>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 5: return mask_launch<5>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 6: return mask_launch<6>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    case 7: return mask_launch<7>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
    default: return mask_launch<8>(x, y, n, m, dmin, oi, oj, n_valid, out, s);
  }
}

// d [n_rows, words] uint32 (words 1..8), origins [F, 2] int64 row offsets
// with 0 <= o <= n_rows - size, out [F, g, g] int32 zeroed, all on the
// current device; size and g powers of two, g <= min(size, 64). Returns the
// launch's CUDA error (0 on success).
int sd_hamming_near_counts(const void* d, int64_t n_rows, int64_t words, const void* origins,
                           int64_t F, int64_t size, int64_t g, int64_t threshold,
                           int64_t n_valid, void* out, void* stream) {
  if (F < 1 || words < 1 || words > MAX_WORDS || !pow2(size) || size > (1 << 24) ||
      !pow2(g) || g > size || g > MAX_SUB || n_rows < size)
    return (int)cudaErrorInvalidValue;
  const int dmin = dmin_of(threshold, (int)words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = (int)size, G = (int)g;
  switch (words) {
    case 1: return counts_launch<1>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 2: return counts_launch<2>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 3: return counts_launch<3>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 4: return counts_launch<4>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 5: return counts_launch<5>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 6: return counts_launch<6>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    case 7: return counts_launch<7>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
    default: return counts_launch<8>(d, n_rows, origins, F, S, G, dmin, n_valid, out, s);
  }
}

const char* sd_hamming_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
