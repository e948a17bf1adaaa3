"""Duplicate analytics: exact-dup grouping and the Hamming all-pairs.

Port of ``spacedrive_tpu/ops/hamming.py``:

- ``exact_dup_groups``: objects are keyed by CAS ID, so files whose IDs
  match are one object (``:104``).
- ``near_dup_pairs``: every (i < j) pair of digests within a Hamming
  threshold (pHash near-dup search). When all N digests fit one tile, one
  launch of the CUDA kernel ``hamming_near_mask`` (``ops/hamming_cuda.py``)
  gives the upper-triangle mask; past one tile, ``near_dup_pairs_device``
  runs the exact two-pass pyramid below.
- The numpy LSH banding (``phash_bands``, ``lsh_candidate_pairs``,
  ``pair_distances``, ``near_dup_pairs_lsh``), copied as they are.

Digests are [N, W] uint32 (W = 2 for 64-bit pHash). Every device entry
point takes ``device`` ("cuda" by default; raises where CUDA is absent;
"cpu" runs the plain versions). The sharded variants wait for the
multi-GPU slice.

The pyramid keeps the JAX package's semantics: digests padded to NT·T rows,
rows past N masked, only global i < j counted, per-tile counts, a
power-of-two tile, truncation past ``MAX_TOTAL_PAIRS`` that keeps the
sparsest tiles, output sorted by (i, j). Hamming distance is a matmul: with
each bit mapped to ±1, dot(x, y) = BITS − 2·hamming(x, y). The dtypes make
it exact: on the card ±1 fp16 operands and an fp16 product (cuBLAS may
reduce in fp16), every partial and final sum an integer of magnitude at most
BITS ≤ 2048, which fp16 holds exactly (wider digests take fp32 operands
and products); on the CPU fp32 throughout. ``jax.lax.map`` over tiles becomes
batched products with bounded memory: the counts sweep multiplies one row
tile by a block of column tiles per call (only j ≥ i: a tile below the
diagonal holds no i < j pair, and its count stays 0), refinement and
leaves gather their blocks and run one batched product per chunk. The
products are turned into 0/1 indicators in place and summed in fp32
(counts of at most 2**24 ones, exact), so no bool mask is cast to int64.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hamming_cuda
from .blake3_torch import resolve_device


def exact_dup_groups(ids: List[str]) -> Dict[str, List[int]]:
    """Group indexes by identical id; only groups with more than one member.

    Host-side: the digests themselves were computed on the device, and
    grouping N short strings is O(N) dict work.
    """
    groups: Dict[str, List[int]] = {}
    for i, cid in enumerate(ids):
        groups.setdefault(cid, []).append(i)
    return {k: v for k, v in groups.items() if len(v) > 1}


def _words(digests, device: torch.device) -> torch.Tensor:
    """[N, W] uint32 digests → int32 tensor of their bits on `device`."""
    if isinstance(digests, torch.Tensor):
        return digests.to(device=device, dtype=torch.int32)
    arr = np.ascontiguousarray(digests, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def hamming_tile(x, y) -> torch.Tensor:
    """[n, W] × [m, W] uint32 → [n, m] int32 Hamming distances (the plain
    SWAR popcount, on the tensors' device; numpy inputs run on the CPU).

    Kept under the JAX package's name for parity with it: no search path
    calls it (they take ``hamming_cuda.hamming_near_mask`` or the pyramid's
    ±1 products)."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    return hamming_cuda.hamming_distances_plain(_words(x, dev), _words(y, dev))


def near_dup_pairs(
    digests: np.ndarray,
    threshold: int,
    tile: int = 4096,
    stats: Optional[Dict] = None,
    device="cuda",
) -> List[Tuple[int, int]]:
    """All (i < j) index pairs with Hamming distance ≤ threshold, sorted.

    N ≤ tile: one ``hamming_near_mask`` launch over the whole set (the
    plain version on the CPU). Larger N: ``near_dup_pairs_device``, exact
    up to the MAX_TOTAL_PAIRS budget (``stats["truncated_pairs"]`` records
    what a degenerate cluster dropped)."""
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    dev = resolve_device(device)
    N = digests.shape[0]
    if N <= tile:
        d = _words(digests, dev)
        mask = hamming_cuda.hamming_near_mask(d, d, threshold)
        ii, jj = (t.cpu() for t in torch.nonzero(mask, as_tuple=True))
        return list(zip(ii.tolist(), jj.tolist()))
    return near_dup_pairs_device(digests, threshold, tile=tile, stats=stats, device=dev)


# -- LSH banding (numpy, copied as it is) ------------------------------------


def phash_bands(digests: np.ndarray, n_bands: int = 4) -> Dict[tuple, List[int]]:
    """LSH banding: split each digest into bands; near-dups (small Hamming
    distance) collide in at least one band with high probability.

    Per band, the byte-slice is zero-extended into a uint64 key, grouped
    with one argsort + boundary scan. Returns {(band, key): [indexes]} for
    buckets with > 1 member.
    """
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    N, W = digests.shape
    bits = digests.view(np.uint8).reshape(N, W * 4)
    per = max(1, (W * 4) // n_bands)
    assert per <= 8, "band wider than a uint64 key; raise n_bands"
    buckets: Dict[tuple, List[int]] = {}
    for b in range(n_bands):
        band = bits[:, b * per : (b + 1) * per]
        keys = np.zeros((N, 8), dtype=np.uint8)
        keys[:, : band.shape[1]] = band
        keys = keys.view("<u8").ravel()
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        # Boundaries of equal-key runs; keep runs of length > 1.
        starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        ends = np.r_[starts[1:], N]
        for s, e in zip(starts, ends):
            if e - s > 1:
                buckets[(b, int(sk[s]))] = order[s:e].tolist()
    return buckets


def lsh_candidate_pairs(digests: np.ndarray, n_bands: int = 4,
                        max_bucket: int = 4096) -> np.ndarray:
    """Unique candidate (i < j) pairs from LSH banding, as an [P, 2] array.

    Buckets larger than `max_bucket` (degenerate keys — e.g. thousands of
    identical digests) are truncated to their first `max_bucket` members
    to bound P at O(sum k²).
    """
    out = []
    for (_, _), idxs in phash_bands(digests, n_bands).items():
        k = min(len(idxs), max_bucket)
        a = np.asarray(idxs[:k], dtype=np.int64)
        ii, jj = np.triu_indices(k, k=1)
        lo = np.minimum(a[ii], a[jj])
        hi = np.maximum(a[ii], a[jj])
        out.append(np.stack([lo, hi], axis=1))
    if not out:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.concatenate(out, axis=0)
    # Dedup across bands: pack to one uint64 key per pair.
    packed = (pairs[:, 0].astype(np.uint64) << np.uint64(32)) \
        | pairs[:, 1].astype(np.uint64)
    packed = np.unique(packed)
    return np.stack([(packed >> np.uint64(32)).astype(np.int64),
                     (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)],
                    axis=1)


def pair_distances(digests: np.ndarray, pairs: np.ndarray,
                   chunk: int = 1 << 20) -> np.ndarray:
    """Hamming distance for each (i, j) row of `pairs` — vectorized
    XOR + popcount in bounded chunks, [P] int32."""
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    out = np.zeros((len(pairs),), dtype=np.int32)
    for s in range(0, len(pairs), chunk):
        p = pairs[s : s + chunk]
        x = digests[p[:, 0]] ^ digests[p[:, 1]]
        out[s : s + chunk] = np.bitwise_count(x).sum(axis=1)
    return out


def near_dup_pairs_lsh(digests: np.ndarray, threshold: int,
                       n_bands: int = 4) -> List[Tuple[int, int]]:
    """CPU fallback for beyond-all-pairs scale: LSH candidates + one
    vectorized distance pass. Probabilistic recall: a pair at distance
    d ≤ threshold is found iff some 16-bit band matches exactly. The exact
    pyramid (``near_dup_pairs_device``) is what the near-dup job runs on the
    card at any N."""
    pairs = lsh_candidate_pairs(digests, n_bands)
    if not len(pairs):
        return []
    d = pair_distances(digests, pairs)
    keep = pairs[d <= threshold]
    return [(int(i), int(j)) for i, j in keep]


# -- Exact all-pairs: the counts sweep and the refinement pyramid ------------
#
#   counts: every tile pair (i ≤ j) → per-tile count of (i < j) pairs ≤
#           threshold ([NT, NT] int32, a few KB to the host).
#   refine: only the flagged blocks → counts of their 16×16 sub-blocks,
#           tile → tile/16 → tile/256 (the work set stays O(pairs)).
#   leaves: [F, 16, 16] masks to the host, where numpy nonzero finishes.
# The N×N distance matrix never exists.

# Row tiles per counts call and blocks per refinement call (the JAX
# package's dispatch sizes; here they bound each call's host round trip).
COUNT_ROWS_PER_DISPATCH = 16
REFINE_BLOCKS_PER_DISPATCH = 1024
REFINE_SUB = 16  # 4096 → 256 → 16-wide leaf blocks
# Host-side pair-list budget; denser output is degenerate (see
# near_dup_pairs_device).
MAX_TOTAL_PAIRS = 4 << 20
# Bytes of products one matmul call may hold (the counts sweep's column
# block, a refinement chunk).
PRODUCT_BYTES = 1 << 30


def _plane_dtype(device: torch.device, bits: int) -> torch.dtype:
    """fp16 on the card while every dot fits its 11 significant bits; fp32
    otherwise and on the CPU."""
    return torch.float16 if device.type == "cuda" and bits <= 2048 else torch.float32


def _bit_planes(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N, W] uint32 bits (int32 tensor) → [N, W*32] ±1 (bit b of word w
    at column w*32+b)."""
    n, w = words.shape
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shifts) & 1
    return (bits.to(dtype) * 2 - 1).reshape(n, w * 32)


def _origin_pair_mask(dots, oi, oj, size: int, bits: int, threshold: int, n: int):
    """dots [F, size, size] → in-range (global i < j) mask for blocks whose
    rows start at global indices oi [F] and columns at oj [F]."""
    return (dots >= bits - 2 * threshold) & hamming_cuda.index_mask(oi, oj, size, size, n)


def _pair_mask(dots, i: int, j: int, T: int, bits: int, threshold: int, n: int):
    """dots [T, T] → boolean mask of in-range (global i < j) pairs for
    whole-tile coords (the oi = i·T, oj = j·T case of the origin form).
    Kept under the JAX package's name for parity with it: the pyramid
    calls ``_origin_pair_mask``."""
    origin = torch.tensor([[i * T, j * T]], dtype=torch.int64, device=dots.device)
    return _origin_pair_mask(dots[None], origin[:, 0], origin[:, 1], T, bits,
                             threshold, n)[0]


def _near_indicator(dots: torch.Tensor, bits: int, threshold: int) -> torch.Tensor:
    """1 where a dot says distance ≤ threshold, else 0, written over `dots`
    in its own dtype: the sums that follow read half the bytes a bool mask
    cast to int64 would, and need no copy."""
    return torch.ge(dots, bits - 2 * threshold, out=dots)


def _tile_counts_block(planes: torch.Tensor, row0: int, threshold: int, n: int,
                       block: int) -> torch.Tensor:
    """Pair counts for `block` consecutive row tiles from row0 (fewer past
    NT): planes [NT, T, BITS] ±1 → [rows, NT] int32.

    Row tile i meets column tiles j ≥ i in blocks of products of at most
    PRODUCT_BYTES. Off the diagonal and inside N every pair is in range, so
    the count is the indicator's sum; the diagonal tile keeps its strict
    upper triangle and the last tile drops its padding."""
    NT, T, BITS = planes.shape
    flat = planes.reshape(NT * T, BITS)
    rows = min(block, NT - row0)
    per_call = max(1, PRODUCT_BYTES // (T * T * planes.element_size()))
    upper = torch.ones((T, T), dtype=planes.dtype, device=planes.device).triu_(1)
    out = torch.zeros((rows, NT), dtype=torch.int64, device=planes.device)
    for k in range(rows):
        i = row0 + k
        for j0 in range(i, NT, per_call):
            j1 = min(NT, j0 + per_call)
            near = _near_indicator(torch.matmul(planes[i], flat[j0 * T:j1 * T].T),
                                   BITS, threshold)
            if j0 == i:
                near[:, :T] *= upper
            if (i + 1) * T > n:
                near[n - i * T:] = 0
            if j1 * T > n:
                near[:, n - j0 * T:] = 0
            # Row sums of at most T ones are exact in fp32.
            per_row = near.view(T, j1 - j0, T).sum(dim=2, dtype=torch.float32)
            out[k, j0:j1] = per_row.to(torch.int64).sum(dim=0)
    return out.to(torch.int32)


def _blocks(flat: torch.Tensor, coords: torch.Tensor, size: int):
    """Gather each block's rows and columns: ([F, size, BITS] x, y, oi, oj)
    for block origins `coords` [F, 2] in units of `size` rows."""
    ar = torch.arange(size, dtype=torch.int64, device=flat.device)
    oi, oj = coords[:, 0] * size, coords[:, 1] * size
    return flat[oi[:, None] + ar], flat[oj[:, None] + ar], oi, oj


def _refine_counts(flat: torch.Tensor, coords: torch.Tensor, threshold: int, n: int,
                   size: int, sub: int) -> torch.Tensor:
    """Subdivide count blocks: for each (row0, col0) block origin pair in
    `coords` (units of `size` rows/cols of the flat plane array), return
    [F, sub, sub] int32 pair counts of its sub-blocks. Matmul and
    reshape-sum only: no nonzero on the card. Only blocks that touch the
    diagonal or the end of N build an index mask."""
    x, y, oi, oj = _blocks(flat, coords, size)
    near = _near_indicator(torch.bmm(x, y.transpose(1, 2)), flat.shape[1], threshold)
    edge = torch.nonzero((oi + size > oj) | (oi + size > n) | (oj + size > n)).flatten()
    if len(edge):
        near[edge] *= hamming_cuda.index_mask(oi[edge], oj[edge], size, size, n)
    k = size // sub
    # Sub-block sums of at most k² ones are exact in fp32.
    return near.view(-1, sub, k, sub, k).sum(dim=(2, 4), dtype=torch.float32).to(torch.int32)


def _leaf_masks(flat: torch.Tensor, coords: torch.Tensor, threshold: int, n: int,
                size: int) -> torch.Tensor:
    """[F, size, size] uint8 pair masks for leaf blocks — small enough to
    ship to the host, where numpy nonzero finishes the job."""
    x, y, oi, oj = _blocks(flat, coords, size)
    return _origin_pair_mask(torch.bmm(x, y.transpose(1, 2)), oi, oj, size,
                             flat.shape[1], threshold, n).to(torch.uint8)


def near_dup_pairs_device(digests: np.ndarray, threshold: int,
                          tile: int = 4096,
                          stats: Optional[Dict] = None,
                          device="cuda") -> List[Tuple[int, int]]:
    """Exact all-pairs (i < j, distance ≤ threshold) at large N: the counts
    sweep, then the refinement pyramid, on `device`.

    Output is bounded at MAX_TOTAL_PAIRS: a degenerate near-identical
    cluster of m digests holds ~m²/2 qualifying pairs; past the budget the
    densest tiles are dropped with a RuntimeWarning, and
    `stats["truncated_pairs"]` carries the dropped-pair count. When `stats`
    is given, `stats["stage_s"]` gets each stage's seconds (each ends in a
    copy to the host, so the card's work is inside them): "planes",
    "counts", "refine_<size>" per level, "leaves", "host"."""
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    N, W = digests.shape
    if N < 2:
        return []
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile} "
                         "(the refinement pyramid subdivides by "
                         f"{REFINE_SUB})")
    dev = resolve_device(device)
    stage: Dict[str, float] = {}
    if stats is not None:
        stats["stage_s"] = stage
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        stage[name] = stage.get(name, 0.0) + now - clock[0]
        clock[0] = now

    NT = -(-N // tile)
    padded = np.zeros((NT * tile, W), dtype=np.uint32)
    padded[:N] = digests
    flat = _bit_planes(_words(padded, dev), _plane_dtype(dev, W * 32))
    planes = flat.view(NT, tile, W * 32)
    lap("planes")

    blocks = []
    for r0 in range(0, NT, COUNT_ROWS_PER_DISPATCH):
        blocks.append(_tile_counts_block(planes, r0, threshold, N,
                                         COUNT_ROWS_PER_DISPATCH).cpu().numpy())
    counts = np.concatenate(blocks, axis=0)
    lap("counts")

    coords = np.argwhere(counts > 0).astype(np.int32)
    if len(coords) == 0:
        return []
    tile_totals = counts[coords[:, 0], coords[:, 1]].astype(np.int64)
    if int(tile_totals.sum()) > MAX_TOTAL_PAIRS:
        # Keep sparsest tiles first until the pair budget is spent.
        order = np.argsort(tile_totals)
        keep = np.cumsum(tile_totals[order]) <= MAX_TOTAL_PAIRS
        dropped = int(tile_totals.sum() - tile_totals[order][keep].sum())
        warnings.warn(
            f"near_dup_pairs_device: truncating ~{dropped} pairs in "
            "degenerate near-identical clusters (MAX_TOTAL_PAIRS "
            f"= {MAX_TOTAL_PAIRS})", RuntimeWarning)
        if stats is not None:
            stats["truncated_pairs"] = (
                stats.get("truncated_pairs", 0) + dropped)
        coords = coords[order][keep]
        if len(coords) == 0:
            return []

    def run_level(fn, coords, size, *args) -> np.ndarray:
        """One refinement level in chunks of at most
        REFINE_BLOCKS_PER_DISPATCH blocks and PRODUCT_BYTES of products."""
        per = max(1, min(REFINE_BLOCKS_PER_DISPATCH,
                         PRODUCT_BYTES // (size * size * flat.element_size())))
        outs = []
        for f0 in range(0, len(coords), per):
            chunk = torch.from_numpy(coords[f0:f0 + per].astype(np.int64)).to(dev)
            outs.append(fn(flat, chunk, threshold, N, size, *args).cpu().numpy())
        return np.concatenate(outs, axis=0)

    # Refinement pyramid: tile → tile/16 → tile/256 leaf blocks; each
    # level keeps only sub-blocks whose count is nonzero.
    size = tile
    while size > REFINE_SUB:
        sub_counts = run_level(_refine_counts, coords, size, REFINE_SUB)
        f, a, b = np.nonzero(sub_counts)
        coords = np.stack([coords[f, 0] * REFINE_SUB + a,
                           coords[f, 1] * REFINE_SUB + b],
                          axis=1).astype(np.int32)
        lap(f"refine_{size}")
        size //= REFINE_SUB
        if len(coords) == 0:
            return []

    masks = run_level(_leaf_masks, coords, size)
    lap("leaves")
    f, ii, jj = np.nonzero(masks)
    pi = coords[f, 0].astype(np.int64) * size + ii
    pj = coords[f, 1].astype(np.int64) * size + jj
    order = np.lexsort((pj, pi))
    out = [(int(a), int(b)) for a, b in zip(pi[order], pj[order])]
    lap("host")
    return out
