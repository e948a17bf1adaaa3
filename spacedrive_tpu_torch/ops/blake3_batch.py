"""Batched pad-and-mask BLAKE3: host packing and the plain torch version.

Port of ``spacedrive_tpu/ops/blake3_batch.py``. Two halves:

- **Host packing** (numpy, copied): ``pack_messages``,
  ``build_cas_messages``, ``digests_to_cas_ids``, ``digests_to_hex`` and
  ``split_counter_base`` build the ``[B, C, 256]`` uint32 word grid
  (``le64(size) ‖ payload ‖ zeros`` rows for CAS IDs) and format digests.
- **The plain torch version of the device math**: ``chunk_prelude``,
  ``block_meta``, ``compress_cv``, ``chunk_cvs`` and ``tree_reduce``. It is
  the plain counterpart of the CUDA kernels in ``ops/blake3_cuda.py``
  (what a wrapper runs for a CPU tensor, and what ``chip_smoke.py`` holds
  the kernels against on the card). ``tree_reduce_spans`` is the span-top
  + fold decomposition the fused kernels run, kept for the tests that pin
  it against ``tree_reduce``.

Word forms. PyTorch has no uint32 arithmetic on the CPU (add, shift and
compare raise for UInt32), so the plain math carries every 32-bit word as
int64 masked to 32 bits, masking after each add and shift. Kernel inputs
and outputs are int32 tensors holding the uint32 bits. The conversions
between numpy uint32, int32 tensors and masked int64 live here and
nowhere else: ``words_to_tensor``, ``tensor_to_words``, ``as_i64`` and
``as_i32``.

Chunk-stage outputs are ``[8, B, C]`` int32 chaining values (word-major,
the layout the CUDA kernels write) plus ``[B]`` int32 chunk counts; the
tree stage returns ``[B, 8]`` int32 digests.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cas as _cas
from .blake3_ref import (
    BLOCK_LEN,
    CHUNK_END,
    CHUNK_LEN,
    CHUNK_START,
    IV,
    MSG_PERMUTATION,
    PARENT,
    ROOT,
)

BLOCKS_PER_CHUNK = CHUNK_LEN // BLOCK_LEN  # 16
WORDS_PER_BLOCK = BLOCK_LEN // 4  # 16
WORDS_PER_CHUNK = CHUNK_LEN // 4  # 256

MASK = 0xFFFFFFFF

# Message-word schedule: round r reads word SCHEDULE[r][i] of the block.
SCHEDULE = [tuple(range(16))]
for _ in range(6):
    SCHEDULE.append(tuple(SCHEDULE[-1][p] for p in MSG_PERMUTATION))


# ---------------------------------------------------------------------------
# uint32 word forms.


def words_to_tensor(arr, device) -> torch.Tensor:
    """numpy uint32 array → int32 tensor on `device` holding the same bits."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bits → numpy uint32 array (on the host)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def as_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 bits in any integer tensor → int64 masked to 32 bits."""
    return t.to(torch.int64) & MASK


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 masked to 32 bits → int32 tensor holding the same bits."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def n_chunks_of(lengths: torch.Tensor) -> torch.Tensor:
    """[B] byte lengths → [B] int32 chunk counts (an empty message is one)."""
    n = (lengths.to(torch.int64) + (CHUNK_LEN - 1)) // CHUNK_LEN
    return torch.clamp(n, min=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain torch device math (int64 masked words).


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK


def _ground(R0, R1, R2, R3, MX, MY):
    """G over the four columns (or diagonals) at once; rows are [4, ...]."""
    R0 = (R0 + R1 + MX) & MASK
    R3 = _rotr(R3 ^ R0, 16)
    R2 = (R2 + R3) & MASK
    R1 = _rotr(R1 ^ R2, 12)
    R0 = (R0 + R1 + MY) & MASK
    R3 = _rotr(R3 ^ R0, 8)
    R2 = (R2 + R3) & MASK
    R1 = _rotr(R1 ^ R2, 7)
    return R0, R1, R2, R3


def compress_cv(cv, m, counter_lo, counter_hi, block_len, flags):
    """One BLAKE3 compression over broadcastable int64 word tensors.

    cv: 8 words; m: 16 words; the rest per lane. Tensors or python ints,
    at least one a tensor. Returns the 8-word output chaining value.
    """
    parts = list(cv) + list(m) + [counter_lo, counter_hi, block_len, flags]
    device = next(p.device for p in parts if isinstance(p, torch.Tensor))
    parts = torch.broadcast_tensors(*[
        p if isinstance(p, torch.Tensor)
        else torch.tensor(p, dtype=torch.int64, device=device)
        for p in parts])
    R0 = torch.stack(parts[0:4])
    R1 = torch.stack(parts[4:8])
    M = torch.stack(parts[8:24])
    R3 = torch.stack(parts[24:28])
    iv = torch.tensor(IV[:4], dtype=torch.int64, device=device)
    R2 = iv.view((4,) + (1,) * (R0.dim() - 1)).expand_as(R0)
    for s in SCHEDULE:
        R0, R1, R2, R3 = _ground(R0, R1, R2, R3,
                                 M[[s[0], s[2], s[4], s[6]]],
                                 M[[s[1], s[3], s[5], s[7]]])
        # diagonal step: rotate rows so diagonals become columns
        R1 = torch.roll(R1, -1, dims=0)
        R2 = torch.roll(R2, -2, dims=0)
        R3 = torch.roll(R3, -3, dims=0)
        R0, R1, R2, R3 = _ground(R0, R1, R2, R3,
                                 M[[s[8], s[10], s[12], s[14]]],
                                 M[[s[9], s[11], s[13], s[15]]])
        R1 = torch.roll(R1, 1, dims=0)
        R2 = torch.roll(R2, 2, dims=0)
        R3 = torch.roll(R3, 3, dims=0)
    lo = R0 ^ R2  # out[i] = s[i] ^ s[i+8]
    hi = R1 ^ R3
    return list(lo.unbind(0)) + list(hi.unbind(0))


def split_counter_base(counter_base):
    """A chunk-counter base → (lo, hi) numpy uint32 words.

    Accepts a python int, a numpy uint64 array ([B] per-message bases) or
    an already split (lo, hi) pair.
    """
    if isinstance(counter_base, tuple):
        lo, hi = counter_base
        return np.asarray(lo, dtype=np.uint32), np.asarray(hi, dtype=np.uint32)
    base = np.asarray(counter_base, dtype=np.uint64)
    lo = (base & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (base >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def chunk_prelude(lengths, C, counter_base=0, whole=True):
    """Per-chunk metadata for the chunk stage.

    lengths: [B] integer tensor. Returns (chunk_bytes [B,C], n_chunks [B],
    single [B,1], k_last [B,C], counter_lo [B,C], counter_hi [B,C],
    empty0 [B,C]), int64 or bool. `single` is true only for a complete
    one-chunk message hashed from counter 0: a streaming window holding
    one chunk of a longer message passes ``whole=False`` so it is not
    root-finalized. `whole` is a bool or a [B] bool array.
    """
    device = lengths.device
    lengths = lengths.to(torch.int64)
    len_b = lengths[:, None]
    chunk_index = torch.arange(C, dtype=torch.int64, device=device)[None, :]
    chunk_bytes = torch.clamp(len_b - chunk_index * CHUNK_LEN, 0, CHUNK_LEN)
    n_chunks = torch.clamp((lengths + (CHUNK_LEN - 1)) // CHUNK_LEN, min=1)
    lo, hi = split_counter_base(counter_base)
    base_lo = torch.as_tensor(np.asarray(lo, dtype=np.int64), device=device)
    base_hi = torch.as_tensor(np.asarray(hi, dtype=np.int64), device=device)
    if base_lo.dim() == 1:  # per-message bases: [B] → [B, 1]
        base_lo = base_lo[:, None]
        base_hi = base_hi[:, None]
    whole = torch.as_tensor(np.asarray(whole, dtype=bool), device=device)
    if whole.dim() == 1:
        whole = whole[:, None]
    at_zero = (base_lo == 0) & (base_hi == 0)
    single = (n_chunks[:, None] == 1) & at_zero & whole  # [B, 1]
    k_last = torch.clamp((chunk_bytes + (BLOCK_LEN - 1)) // BLOCK_LEN - 1,
                         min=0)
    counter_lo = ((base_lo + chunk_index) & MASK).expand_as(chunk_bytes)
    carry = (counter_lo < chunk_index).to(torch.int64)
    counter_hi = ((base_hi + carry) & MASK).expand_as(chunk_bytes)
    empty0 = (len_b == 0) & (chunk_index == 0)
    return chunk_bytes, n_chunks, single, k_last, counter_lo, counter_hi, empty0


def block_meta(chunk_bytes, k_last, single, empty0, k: int):
    """(block_len, active, flags) for block index k of every chunk.

    A block is active if it holds bytes, or it is block 0 of chunk 0 of an
    empty message.
    """
    block_len = torch.clamp(chunk_bytes - k * BLOCK_LEN, 0, BLOCK_LEN)
    is_last = k_last == k
    active = (block_len > 0) | (empty0 & (k == 0))
    flags = ((CHUNK_START if k == 0 else 0)
             + is_last.to(torch.int64) * CHUNK_END
             + (is_last & single).to(torch.int64) * ROOT)
    return block_len, active, flags


def chunk_cvs(words, lengths, counter_base=0, whole=True):
    """Per-chunk chaining values of a batch (plain version of both kernels).

    words:   [B, C, 256] int32 tensor (uint32 bits), little-endian packed,
             zero padded.
    lengths: [B] integer tensor, message byte lengths.
    counter_base: absolute index of chunk 0 (int, numpy uint64 [B], or a
        split (lo, hi) pair) for streaming windows.
    whole: False when this grid is a window of a longer stream.

    Returns (cvs [8, B, C] int32, n_chunks [B] int32). A whole one-chunk
    message hashed from counter 0 had its last block compressed WITH the
    ROOT flag, so cvs[:, b, 0] is already its digest.
    """
    B, C, W = words.shape
    if W != WORDS_PER_CHUNK:
        raise ValueError(f"words must be [B, C, {WORDS_PER_CHUNK}], got {tuple(words.shape)}")
    (chunk_bytes, n_chunks, single, k_last,
     counter_lo, counter_hi, empty0) = chunk_prelude(lengths, C, counter_base, whole)
    cv = [torch.full((B, C), IV[i], dtype=torch.int64, device=words.device)
          for i in range(8)]
    for k in range(BLOCKS_PER_CHUNK):
        block_len, active, flags = block_meta(chunk_bytes, k_last, single, empty0, k)
        m = as_i64(words[:, :, k * WORDS_PER_BLOCK:(k + 1) * WORDS_PER_BLOCK])
        new_cv = compress_cv(cv, m.unbind(-1), counter_lo, counter_hi,
                             block_len, flags)
        cv = [torch.where(active, n, c) for n, c in zip(new_cv, cv)]
    return as_i32(torch.stack(cv)), n_chunks.to(torch.int32)


def tree_reduce(cvs, n_chunks, root=True):
    """Fold per-chunk CVs into digests by adjacent pairing.

    cvs: [8, B, C] int32 (uint32 bits); n_chunks: [B]. Returns [B, 8]
    int32. BLAKE3's "left subtree = largest power of two" rule equals
    repeated adjacent pairing with odd-tail promotion, so the merge is
    ceil(log2 C) parent compressions with per-lane ROOT flags. Lanes with
    n_chunks == 1 pass through untouched.

    root=False computes interior-subtree tops: no merge carries ROOT, so
    the result keeps merging upward (the streaming windows of
    ops/seqhash.py). Runs on the tensors' device with no host sync.
    """
    cvs = as_i64(cvs)
    _, B, C = cvs.shape
    n = n_chunks.to(torch.int64)
    while C > 1:
        half = (C + 1) // 2
        if half * 2 != C:
            cvs = torch.cat([cvs, torch.zeros((8, B, 1), dtype=torch.int64,
                                              device=cvs.device)], dim=2)
        left = cvs[:, :, 0::2]  # [8, B, half]
        right = cvs[:, :, 1::2]
        pair_index = torch.arange(half, dtype=torch.int64, device=cvs.device)[None, :]
        merged_real = (pair_index * 2 + 1) < n[:, None]
        is_root = (n[:, None] == 2) & (pair_index == 0) & root
        flags = PARENT + is_root.to(torch.int64) * ROOT
        parent = compress_cv(list(IV), list(left.unbind(0)) + list(right.unbind(0)),
                             0, 0, BLOCK_LEN, flags)
        cvs = torch.where(merged_real, torch.stack(parent), left)
        n = torch.clamp((n + 1) // 2, min=1)
        C = half
    return as_i32(cvs[:, :, 0].T.contiguous())


def _pair_level(x, n_chunks, level: int, root: bool, first):
    """One level of adjacent pairing over [8, B, R, 2k] (R aligned runs
    whose node 0 has global index `first` [R]) at global `level`."""
    width = x.shape[-1]
    n = (n_chunks.to(torch.int64)[:, None, None] + (1 << level) - 1) >> level
    left, right = x[..., 0::2], x[..., 1::2]
    half = width // 2
    gp = first[None, :, None] * half + torch.arange(half, device=x.device)[None, None, :]
    merged_real = gp * 2 + 1 < n
    is_root = (n == 2) & (gp == 0) & root
    flags = PARENT + is_root.to(torch.int64) * ROOT
    parent = compress_cv(list(IV), list(left.unbind(0)) + list(right.unbind(0)),
                         0, 0, BLOCK_LEN, flags)
    return torch.where(merged_real, torch.stack(parent), left)


def tree_reduce_spans(cvs, n_chunks, span: int, root=True):
    """``tree_reduce`` as the fused CUDA kernels compute it.

    cvs: [8, B, C] int32; returns [B, 8] int32, equal to
    ``tree_reduce(cvs, n_chunks, root)``. Each pass cuts the nodes into
    aligned runs of S = min(span, next_pow2(nodes)) (span a power of two),
    reduces every run to its top with log2(S) levels of the global rule
    (a pair merges iff its global right index is below the level's
    n = ceil(n_chunks / 2^level), ROOT iff `root`, n == 2 and the global
    pair index is 0), and repeats on the tops until one is left. A pass is
    one chunk-kernel or fold launch (blake3_chunk_span / blake3_tree_fold
    in csrc/blake3_chunk.cu). Only tests use it.
    """
    if span < 1 or span & (span - 1):
        raise ValueError(f"span must be a power of two, got {span}")
    x = as_i64(cvs)
    _, B, nodes = x.shape
    level = 0
    while True:
        S = min(span, 1 << (nodes - 1).bit_length())
        runs = -(-nodes // S)
        x = torch.cat([x, torch.zeros((8, B, runs * S - nodes), dtype=torch.int64,
                                      device=x.device)], dim=2).view(8, B, runs, S)
        first = torch.arange(runs, dtype=torch.int64, device=x.device)
        for _ in range(S.bit_length() - 1):
            x = _pair_level(x, n_chunks, level, root, first)
            level += 1
        x, nodes = x[..., 0], runs
        if nodes == 1:
            return as_i32(x[:, :, 0].T.contiguous())


# ---------------------------------------------------------------------------
# Host-side batch packing (numpy).


def pack_messages(messages, max_chunks=None):
    """Pack variable-length byte strings into a padded word grid.

    Returns (words [B, C, 256] uint32, lengths [B] int32).
    """
    B = len(messages)
    longest = max((len(m) for m in messages), default=0)
    C = max(1, -(-longest // CHUNK_LEN))
    if max_chunks is not None:
        if C > max_chunks:
            raise ValueError(f"message needs {C} chunks, grid has {max_chunks}")
        C = max_chunks
    buf = np.zeros((B, C * CHUNK_LEN), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, m in enumerate(messages):
        buf[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        lengths[i] = len(m)
    words = buf.view("<u4").reshape(B, C, WORDS_PER_CHUNK)
    return words, lengths


def build_cas_messages(payloads: np.ndarray, sizes: np.ndarray, payload_lens=None):
    """Prefix payload rows with the 8-byte LE file size and pack to words.

    payloads: [B, P] uint8, zero-padded past each row's payload length.
    sizes:    [B] uint64 — true file sizes (hashed as the prefix).
    payload_lens: [B] — bytes of real payload per row (default: P).

    Returns (words [B, C, 256] uint32, lengths [B] int32) where C is the
    grid for P (57 for the large-file mode, 101 for small).
    """
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
    B, P = payloads.shape
    if payload_lens is None:
        payload_lens = np.full((B,), P, dtype=np.int32)
    else:
        # Zero stale bytes past each row's payload: the compression always
        # consumes full 16-word blocks (block_len only clips the count), so
        # a reused buffer with residue would silently change the digest.
        payload_lens = np.asarray(payload_lens, dtype=np.int32)
        mask = np.arange(P, dtype=np.int32)[None, :] < payload_lens[:, None]
        payloads = np.where(mask, payloads, 0).astype(np.uint8)
    msg_len = _cas.SIZE_PREFIX_LEN + P
    C = max(1, -(-msg_len // CHUNK_LEN))
    buf = np.zeros((B, C * CHUNK_LEN), dtype=np.uint8)
    buf[:, : _cas.SIZE_PREFIX_LEN] = (
        np.asarray(sizes, dtype="<u8").reshape(B, 1).view(np.uint8)
    )
    buf[:, _cas.SIZE_PREFIX_LEN : _cas.SIZE_PREFIX_LEN + P] = payloads
    lengths = (_cas.SIZE_PREFIX_LEN + np.asarray(payload_lens, dtype=np.int32))
    return buf.view("<u4").reshape(B, C, WORDS_PER_CHUNK), lengths


def digests_to_cas_ids(digests) -> list:
    """[B, 8] uint32 digests → 16-hex-char CAS IDs (cas.rs:61)."""
    le = np.asarray(digests).astype("<u4")
    return [le[i].tobytes()[:8].hex() for i in range(le.shape[0])]


def digests_to_hex(digests) -> list:
    """[B, 8] uint32 digests → 64-hex-char checksums."""
    le = np.asarray(digests).astype("<u4")
    return [le[i].tobytes().hex() for i in range(le.shape[0])]
