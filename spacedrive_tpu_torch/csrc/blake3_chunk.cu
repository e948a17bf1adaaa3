// BLAKE3 chunk and tree kernels for Hopper (sm_90a), plain C interface.
//
// What they replace. The two Pallas TPU kernels of
// spacedrive_tpu/ops/blake3_pallas.py and the jnp tree stage that follows
// them (spacedrive_tpu/ops/blake3_batch.py tree_reduce):
//   K1 "fast"      <- _chunk_kernel_meta (launched by _chunk_cvs_pallas_fast):
//       whole messages hashed from chunk counter 0, metadata derived from
//       (message length, chunk index). Every CAS-ID batch and every
//       validator small-file page runs it.
//   K2 "windowed"  <- _chunk_kernel (launched by _chunk_cvs_pallas): the same
//       chunk stage with a 64-bit chunk-counter base (lo/hi words with carry)
//       and a `whole` flag, so a one-chunk window of a longer stream is not
//       ROOT-finalized. The validator's streaming windows run it.
//   blake3_tree_fold <- the rest of tree_reduce, for messages longer than one
//       span (below).
// One templated body, blake3_chunk_span<WINDOWED, FUSED>, serves K1 and K2
// in two forms. FUSED = false writes every chunk's chaining value (CV) as
// word-major [8, B, C], exactly what the TPU kernels compute. FUSED = true
// is the main path: the CTA folds its chunk CVs into subtree tops in shared
// memory and writes only those.
//
// Decomposition. The grid is (ceil(B / M), ceil(C / S)): a CTA holds M
// segments of S threads, segment s being the aligned span blockIdx.y of
// chunks of message blockIdx.x * M + s; thread t of a segment computes the
// CV of chunk span * S + t. S is a power of two, so adjacent pairing inside
// an aligned span equals BLAKE3's global pairing for the first log2(S)
// levels (tree_reduce's rule: a pair merges iff its right index is below
// the level's n = ceil(n_chunks / 2^level), else the left CV is promoted;
// flags PARENT, plus ROOT iff the message is whole (K1), n == 2 and the
// global pair index is 0). ROOT can only arise inside span 0, when
// n_chunks <= S. K2's fused form hashes one window of a longer stream, so
// it sets neither ROOT nor the one-chunk ROOT of a whole message. The CTA
// writes one top per segment to [B, n_spans, 8]; with one span that is the
// digest.
// Messages longer than one span fold their tops with blake3_tree_fold: the
// same levels over S' tops per CTA, continuing from global level log2(S),
// launched until one top is left (one launch per 8 MiB window at S = 128).
// The fold is a second kernel, not a last-CTA-done tail in the same launch
// (__threadfence + an atomic ticket per message): no atomics, no ticket
// buffer to zero per call, and one code path for any number of tops. Its
// cost, measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, is
// 0.0077 ms per 8 MiB window (64 tops) against 0.0216 ms for the fused
// chunk launch and milliseconds for the window's host-to-device copy. The
// plain torch twin of this decomposition is
// spacedrive_tpu_torch/ops/blake3_batch.py tree_reduce_spans.
//
// What bounds them. A compression is 7 rounds x 8 G, each 4 adds (two of
// them three-input), 4 xors and 4 rotates, plus 8 output xors: 680
// operations, 456 of them xors and rotates. Those run only on the ALU pipe
// (LOP3, SHF), 64 lanes per SM per clock; the adds may also issue on the
// FMA pipe as IMAD. So a 64-byte block costs an SM at least 456 / 64 = 7.1
// cycles per lane against 5.0 cycles of its share of HBM bandwidth
// (3.35 TB/s over 132 SMs at 1.98 GHz), and a batch of whole messages (K1
// at the identify step) is bound by the ALU pipe. This build's chunk loop
// (chip_smoke.py prints its SASS mix) issues 582 ALU instructions per
// compression: LOP3 231, SHF 224, IADD3 113 and loop overhead. One 8 MiB
// window is only 8192 lanes (K2: 256 warps on 528
// schedulers) and is bound instead by one warp's path: 16 chunk blocks
// plus log2(8192) parent levels, each a compression that a lone warp
// takes 0.766 us for (its sub-partition's 16 ALU lanes need 2 cycles per
// warp instruction), a floor of 0.0222 ms per window.
//
// What the design does about it. One thread per chunk lane keeps the whole
// state, the 16 message words and the CV in registers; the 7 rounds are
// unrolled, the message permutation is a register rename, rotates are
// __funnelshift_r. Only active blocks are compressed (the loop stops at the
// chunk's last block), so padding costs no ALU work. Each thread loads its
// 64-byte block as 4 x 16-byte loads straight from the staged chunk-major
// rows: a cp.async double-buffered copy of each block through shared
// memory (4 threads per lane's 64 bytes, swizzled) was measured and dropped,
// slower for K1 (0.804 against 0.681 ms at the identify step: 76 registers
// and two barriers per block) and no faster for K2 (0.02996 against
// 0.02988 ms per window; chip_smoke.py, H100 80GB HBM3 at 700 W). The tree
// costs 1/S of the chunk work per level and never leaves shared memory:
// CVs sit word-major [8][M * S] (thread t stores column t,
// no bank conflicts), each level's pairs are packed onto the lowest threads
// across the M segments so few warps run the shrinking levels, and whole
// CTAs whose span starts past their messages' last chunk exit at once. K1
// and K2 differ only in how a lane derives its counter and ROOT flag; the
// index math has no 64-bit divide (b and c come from blockIdx).
//
// Launch contract: the kernels run on the caller's stream, never
// synchronise and allocate nothing; each launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u,
                   IV3 = 0xA54FF53Au, IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu,
                   IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;
constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t PARENT = 1u << 2;
constexpr uint32_t ROOT = 1u << 3;
constexpr int CHUNK_LEN = 1024;
constexpr int BLOCK_LEN = 64;
constexpr int WORDS_PER_CHUNK = 256;
constexpr int MAX_THREADS = 256;
constexpr long long MAX_GRID_Y = 65535;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t mx, uint32_t my) {
  a = a + b + mx;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + my;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

__device__ __forceinline__ void round_fn(uint32_t v[16], const uint32_t m[16]) {
  g(v[0], v[4], v[8], v[12], m[0], m[1]);
  g(v[1], v[5], v[9], v[13], m[2], m[3]);
  g(v[2], v[6], v[10], v[14], m[4], m[5]);
  g(v[3], v[7], v[11], v[15], m[6], m[7]);
  g(v[0], v[5], v[10], v[15], m[8], m[9]);
  g(v[1], v[6], v[11], v[12], m[10], m[11]);
  g(v[2], v[7], v[8], v[13], m[12], m[13]);
  g(v[3], v[4], v[9], v[14], m[14], m[15]);
}

// MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);
// fully unrolled, this is a register rename.
__device__ __forceinline__ void permute(uint32_t m[16]) {
  const uint32_t t[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                          m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = t[i];
}

// One compression; cv becomes the 8-word output chaining value. Permutes m.
__device__ __forceinline__ void compress(uint32_t cv[8], uint32_t m[16],
                                         uint32_t counter_lo, uint32_t counter_hi,
                                         uint32_t block_len, uint32_t flags) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    IV0,   IV1,   IV2,   IV3,   counter_lo, counter_hi,
                    block_len, flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    round_fn(v, m);
    if (r < 6) permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

__device__ __forceinline__ void set_iv(uint32_t cv[8]) {
  cv[0] = IV0; cv[1] = IV1; cv[2] = IV2; cv[3] = IV3;
  cv[4] = IV4; cv[5] = IV5; cv[6] = IV6; cv[7] = IV7;
}

// Chaining value of one chunk lane. `src` points at the lane's 1 KiB chunk.
// A block is compressed iff it holds bytes, or it is block 0 of chunk 0 of
// an empty message.
__device__ __forceinline__ void chunk_lane(const uint4* __restrict__ src,
                                           int chunk_bytes, bool empty0, bool single,
                                           uint32_t counter_lo, uint32_t counter_hi,
                                           uint32_t cv[8]) {
  const int full = (chunk_bytes + BLOCK_LEN - 1) / BLOCK_LEN;
  const int n_blocks = (full == 0 && empty0) ? 1 : full;  // active blocks
#pragma unroll 1
  for (int k = 0; k < n_blocks; ++k) {
    const int rest = chunk_bytes - k * BLOCK_LEN;
    const uint32_t block_len = rest < BLOCK_LEN ? (rest > 0 ? rest : 0) : BLOCK_LEN;
    const bool is_last = k == n_blocks - 1;
    const uint32_t flags = (k == 0 ? CHUNK_START : 0u) |
                           (is_last ? CHUNK_END : 0u) |
                           (is_last && single ? ROOT : 0u);
    const uint4 q0 = src[4 * k + 0];
    const uint4 q1 = src[4 * k + 1];
    const uint4 q2 = src[4 * k + 2];
    const uint4 q3 = src[4 * k + 3];
    uint32_t m[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                      q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
    compress(cv, m, counter_lo, counter_hi, block_len, flags);
  }
}

// Chunks of a `len`-byte message; an empty message is one chunk.
__device__ __forceinline__ int n_chunks_of(int len) {
  const int n = static_cast<int>((static_cast<long long>(len) + CHUNK_LEN - 1) / CHUNK_LEN);
  return n < 1 ? 1 : n;
}

// Nodes of a level: ceil(n_chunks / 2^level), 0 for a segment past the batch.
__device__ __forceinline__ long long level_n(int n_chunks, int level) {
  return (static_cast<long long>(n_chunks) + (1ll << level) - 1) >> level;
}

// log2(S) levels of tree_reduce's pairing over the CTA's shared memory.
// cvs is word-major [8][T] (T = blockDim.x = M * S); segment s holds its S
// nodes at columns s*S .. s*S + S - 1 and its message's chunk count in
// nch[s]. The segments' node 0 has global index `first` at global level
// `level0`. Leaves each segment's top in column s*S.
__device__ __forceinline__ void tree_levels(uint32_t* cvs, const int* nch,
                                            int log2s, int level0,
                                            long long first, bool root) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
#pragma unroll 1
  for (int l = 0; l < log2s; ++l) {
    const int lp = log2s - l - 1;  // log2 of the pairs per segment
    const int seg = t >> lp;
    const int p = t & ((1 << lp) - 1);
    const int col = (seg << log2s) + 2 * p;
    const bool active = t < (T >> (l + 1));  // pairs packed onto low threads
    bool merge = false;
    uint32_t flags = PARENT;
    uint32_t m[16];
    if (active) {
      const long long n = level_n(nch[seg], level0 + l);
      const long long gp = (first << lp) + p;  // global pair index
      merge = 2 * gp + 1 < n;
      if (root && n == 2 && gp == 0) flags |= ROOT;
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = cvs[i * T + col];
      if (merge) {
#pragma unroll
        for (int i = 0; i < 8; ++i) m[8 + i] = cvs[i * T + col + 1];
      }
    }
    __syncthreads();
    if (active) {
      uint32_t cv[8];
      if (merge) {
        set_iv(cv);
        compress(cv, m, 0u, 0u, BLOCK_LEN, flags);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = m[i];
      }
      const int dst = (seg << log2s) + p;
#pragma unroll
      for (int i = 0; i < 8; ++i) cvs[i * T + dst] = cv[i];
    }
    __syncthreads();
  }
}

// Each segment's top (column s*S) to tops[b, span, :] of [B, gridDim.y, 8].
__device__ __forceinline__ void store_tops(const uint32_t* cvs, int log2s,
                                           long long B, uint32_t* __restrict__ tops) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int M = T >> log2s;
  for (int i = t; i < 8 * M; i += T) {  // 8 words per segment; S < 8 loops
    const int s = i >> 3, w = i & 7;
    const long long b = static_cast<long long>(blockIdx.x) * M + s;
    if (b < B) tops[(b * gridDim.y + blockIdx.y) * 8 + w] = cvs[w * T + (s << log2s)];
  }
}

struct ChunkArgs {
  const uint32_t* words;   // [B, C, 256]
  const int32_t* lengths;  // [B]
  const uint32_t* meta;    // [3, B]: base_lo, base_hi, whole; null = scalars
  uint32_t base_lo, base_hi, whole;
  long long B, C;
  int log2s;               // S = 1 << log2s chunks per segment
  uint32_t* out;           // CV form [8, B, C]; fused [B, n_spans, 8]
};

template <bool WINDOWED, bool FUSED>
__global__ void __launch_bounds__(MAX_THREADS) blake3_chunk_span(ChunkArgs a) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int S = 1 << a.log2s;
  const int seg = t >> a.log2s;
  const long long b = static_cast<long long>(blockIdx.x) * (T >> a.log2s) + seg;
  const long long span = blockIdx.y;
  const long long c = span * S + (t & (S - 1));
  int len = 0, nch = 0;  // nch = 0: a segment past the batch
  if (b < a.B) {
    len = a.lengths[b];
    nch = n_chunks_of(len);
  }
  // A CTA whose spans all start past their messages' last chunk holds no
  // top that a fold reads (every pair there promotes into unread columns).
  if (FUSED && !__syncthreads_or(span * S < nch)) return;

  uint32_t cv[8];
  set_iv(cv);
  const bool lane = b < a.B && c < a.C;
  if (lane) {
    uint32_t lo0 = 0, hi0 = 0;
    bool whole = !WINDOWED;  // a fused windowed launch is never whole
    if (WINDOWED) {
      if (a.meta != nullptr) {
        lo0 = a.meta[b];
        hi0 = a.meta[a.B + b];
        whole = !FUSED && a.meta[2 * a.B + b] != 0;
      } else {
        lo0 = a.base_lo;
        hi0 = a.base_hi;
        whole = !FUSED && a.whole != 0;
      }
    }
    const uint32_t idx = static_cast<uint32_t>(c);
    const uint32_t counter_lo = lo0 + idx;
    const uint32_t counter_hi = hi0 + (counter_lo < idx ? 1u : 0u);
    const bool single = nch == 1 && lo0 == 0 && hi0 == 0 && whole;
    long long cb = static_cast<long long>(len) - c * CHUNK_LEN;
    cb = cb < 0 ? 0 : (cb > CHUNK_LEN ? CHUNK_LEN : cb);
    chunk_lane(reinterpret_cast<const uint4*>(a.words + (b * a.C + c) * WORDS_PER_CHUNK),
               static_cast<int>(cb), len == 0 && c == 0, single, counter_lo, counter_hi,
               cv);
  }
  if (!FUSED) {
    if (lane) {
      const long long L = a.B * a.C;
#pragma unroll
      for (int i = 0; i < 8; ++i) a.out[i * L + b * a.C + c] = cv[i];
    }
    return;
  }
  uint32_t* cvs = smem;                                   // [8][T]
  int* nchs = reinterpret_cast<int*>(smem + 8 * T);       // [M]
#pragma unroll
  for (int i = 0; i < 8; ++i) cvs[i * T + t] = cv[i];
  if ((t & (S - 1)) == 0) nchs[seg] = nch;
  __syncthreads();
  tree_levels(cvs, nchs, a.log2s, 0, span, !WINDOWED);
  store_tops(cvs, a.log2s, a.B, a.out);
}

// Fold [B, n_in, 8] subtree tops at global level `level0` (each top covers
// 2^level0 chunks) into [B, ceil(n_in / S), 8] tops at level0 + log2(S);
// ROOT-finalize a whole message's last parent unless WINDOWED.
template <bool WINDOWED>
__global__ void __launch_bounds__(MAX_THREADS)
blake3_tree_fold(const uint32_t* __restrict__ in, const int32_t* __restrict__ lengths,
                 long long B, long long n_in, int level0, int log2s,
                 uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int S = 1 << log2s;
  const int seg = t >> log2s;
  const long long b = static_cast<long long>(blockIdx.x) * (T >> log2s) + seg;
  const long long span = blockIdx.y;
  const long long j = span * S + (t & (S - 1));
  const int nch = b < B ? n_chunks_of(lengths[b]) : 0;
  if (!__syncthreads_or(span * S < level_n(nch, level0))) return;
  uint32_t* cvs = smem;
  int* nchs = reinterpret_cast<int*>(smem + 8 * T);
  if (b < B && j < n_in) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cvs[i * T + t] = in[(b * n_in + j) * 8 + i];
  }
  if ((t & (S - 1)) == 0) nchs[seg] = nch;
  __syncthreads();
  tree_levels(cvs, nchs, log2s, level0, span, !WINDOWED);
  store_tops(cvs, log2s, B, out);
}

// Shared memory of a fused or fold CTA: [8][T] CVs + [M] chunk counts.
size_t tree_smem(int threads, int log2s) {
  return (8 * static_cast<size_t>(threads) + (threads >> log2s)) * sizeof(uint32_t);
}

bool bad_shape(long long B, long long n, int log2s, int threads, dim3* grid) {
  if (log2s < 0 || threads < 1 || threads > MAX_THREADS || (threads >> log2s) < 1 ||
      threads % (1 << log2s) != 0)
    return true;
  const long long M = threads >> log2s;
  const long long gx = (B + M - 1) / M;
  const long long gy = (n + (1ll << log2s) - 1) >> log2s;
  if (gx > 0x7fffffffll || gy > MAX_GRID_Y) return true;
  *grid = dim3(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
  return false;
}

}  // namespace

extern "C" {

// words: [B, C, 256] uint32; lengths: [B] int32. meta: [3, B] uint32
// (counter base lo, hi, whole) or null for the scalars base_lo, base_hi,
// whole (ignored unless windowed; a fused windowed launch is never whole).
// threads = M * S with S = 1 << log2s. fused = 0: out is [8, B, C] chunk
// CVs. fused = 1: out is [B, ceil(C / S), 8] span tops (unless windowed,
// ROOT-finalized where a message's tree completes inside span 0).
int sd_blake3_chunk(const void* words, const void* lengths, const void* meta,
                    unsigned int base_lo, unsigned int base_hi, int whole,
                    long long B, long long C, int log2s, int threads,
                    int windowed, int fused, void* out, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  dim3 grid;
  if (bad_shape(B, C, log2s, threads, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs a{static_cast<const uint32_t*>(words), static_cast<const int32_t*>(lengths),
              static_cast<const uint32_t*>(meta), base_lo, base_hi,
              static_cast<uint32_t>(whole), B, C, log2s, static_cast<uint32_t*>(out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fused ? tree_smem(threads, log2s) : 0;
  if (windowed) {
    if (fused) blake3_chunk_span<true, true><<<grid, threads, smem, s>>>(a);
    else blake3_chunk_span<true, false><<<grid, threads, smem, s>>>(a);
  } else {
    if (fused) blake3_chunk_span<false, true><<<grid, threads, smem, s>>>(a);
    else blake3_chunk_span<false, false><<<grid, threads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// in: [B, n_in, 8] tops at global level level0 of K1's (windowed = 0) or
// K2's (windowed = 1) fused launch; out: [B, ceil(n_in / S), 8].
int sd_blake3_tree_fold(const void* in, const void* lengths, long long B,
                        long long n_in, int level0, int log2s, int threads,
                        int windowed, void* out, void* stream) {
  if (B <= 0 || n_in <= 0) return 0;
  dim3 grid;
  if (bad_shape(B, n_in, log2s, threads, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* src = static_cast<const uint32_t*>(in);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* dst = static_cast<uint32_t*>(out);
  const size_t smem = tree_smem(threads, log2s);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (windowed) blake3_tree_fold<true><<<grid, threads, smem, s>>>(src, lens, B, n_in, level0, log2s, dst);
  else blake3_tree_fold<false><<<grid, threads, smem, s>>>(src, lens, B, n_in, level0, log2s, dst);
  return static_cast<int>(cudaGetLastError());
}

const char* sd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
