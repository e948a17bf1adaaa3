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
sparsest tiles, output sorted by (i, j). Every level is a call of
``hamming_cuda.hamming_near_counts``: on the card one kernel launch that
keeps each pair's dot product in registers (with each bit mapped to ±1,
dot(x, y) = BITS − 2·hamming(x, y), exact in s32) and writes only counts;
on the CPU its plain version, fp32 ±1 products in bounded chunks. The sweep
counts each tile pair's sub-blocks directly, so the JAX package's
refinement at the tile size is folded into it.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hamming_cuda, kernel_registry
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
        # Guarded compare (contract hamming.pairs): the digests' copy to
        # the device precedes it, the pair indexes are the declared fetch.
        with kernel_registry.device_scope("hamming.pairs"):
            mask = hamming_cuda.hamming_near_mask(d, d, threshold)
            with kernel_registry.io("hamming.pairs"):
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
#   counts: every tile pair (i ≤ j) → counts of (i < j) pairs ≤ threshold
#           in each of its REFINE_SUB² sub-blocks (the count form at
#           S = tile, g = REFINE_SUB: the JAX package's per-tile sweep and
#           its first refinement in one pass), summed per tile for the
#           pair budget.
#   refine: only the flagged sub-blocks → counts of their 16×16
#           sub-blocks, tile/16 → tile/256 (the work set stays O(pairs)).
#   leaves: the count form at g = size, whose counts are the [F, size,
#           size] 0/1 pair masks.
# Each level's nonzero entries are found where its counts lie (torch.nonzero,
# row-major as np.nonzero), and only their indices and the per-tile sums
# cross to the host. The N×N distance matrix never exists, and on the card
# neither does any product or mask of the sweep and the refinement.

REFINE_SUB = 16  # 4096 → 256 → 16-wide leaf blocks
# Host-side pair-list budget; denser output is degenerate (see
# near_dup_pairs_device).
MAX_TOTAL_PAIRS = 4 << 20
# Blocks per count-form call: bounds each call's [F, g, g] counts (32 MB
# at g = 16) and its host round trip.
BLOCKS_PER_DISPATCH = 1 << 15




def near_dup_pairs_device(digests: np.ndarray, threshold: int,
                          tile: int = 4096,
                          stats: Optional[Dict] = None,
                          device="cuda") -> List[Tuple[int, int]]:
    """Exact all-pairs (i < j, distance ≤ threshold) at large N: the counts
    sweep, then the refinement pyramid, on `device`, every level one or more
    ``hamming_near_counts`` calls (the kernel on the card, its plain version
    on the CPU).

    Output is bounded at MAX_TOTAL_PAIRS: a degenerate near-identical
    cluster of m digests holds ~m²/2 qualifying pairs; past the budget the
    densest tiles are dropped with a RuntimeWarning, and
    `stats["truncated_pairs"]` carries the dropped-pair count. When `stats`
    is given, `stats["stage_s"]` gets each stage's seconds (each ends in a
    copy to the host, so the card's work is inside them): "planes" (the
    padded digests to the device), "counts", "refine_<size>" per level
    below the tile, "leaves", "host".

    Device memory past the digests: 4 B a tile pair for the per-tile
    totals, one dispatch's [BLOCKS_PER_DISPATCH, 16, 16] int32 counts
    (32 MB), and the sub-counts of the tiles that hold a pair (1 KB each;
    there are no more such tiles than qualifying pairs), then each level's
    counts of the flagged sub-blocks, which the pair budget bounds."""
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
    words = _words(padded, dev)
    lap("planes")

    # Guarded pyramid (contract hamming.pairs): the padded digests' copy
    # to the device precedes it; per-tile sums and nonzero indexes are
    # the declared fetches.
    with kernel_registry.device_scope("hamming.pairs"):
        def counts(blocks: np.ndarray, size: int, g: int) -> torch.Tensor:
            """[F, g, g] counts, on `dev`, of blocks with origins `blocks`
            (units of size)."""
            outs = [hamming_cuda.hamming_near_counts(
                words, blocks[f0:f0 + BLOCKS_PER_DISPATCH].astype(np.int64) * size, size, g,
                threshold, N) for f0 in range(0, len(blocks), BLOCKS_PER_DISPATCH)]
            return outs[0] if len(outs) == 1 else torch.cat(outs)

        def nonzero(t: torch.Tensor) -> np.ndarray:
            """Indices of t's nonzero entries, row-major (np.nonzero's order),
            found where t lies: only they cross to the host."""
            with kernel_registry.io("hamming.pairs"):
                return torch.nonzero(t).cpu().numpy().T

        # The sweep: tile pairs j ≥ i in row-major order (a tile below the
        # diagonal holds no i < j pair), at sub-block granularity. Each
        # dispatch keeps only the sub-counts of its tiles that hold a pair;
        # only the per-tile sums cross to the host.
        g0 = REFINE_SUB if tile > REFINE_SUB else 1
        iu, ju = np.triu_indices(NT)
        tile_pairs = np.stack([iu, ju], axis=1)
        sums, live = [], []
        for f0 in range(0, len(tile_pairs), BLOCKS_PER_DISPATCH):
            sub = hamming_cuda.hamming_near_counts(
                words, tile_pairs[f0:f0 + BLOCKS_PER_DISPATCH].astype(np.int64) * tile, tile,
                g0, threshold, N)
            total = sub.sum(dim=(1, 2), dtype=torch.int32)
            sums.append(total)
            with kernel_registry.io("hamming.pairs"):
                live.append(sub[torch.nonzero(total).flatten()])
        grid = np.zeros((NT, NT), dtype=np.int32)
        with kernel_registry.io("hamming.pairs"):
            grid[iu, ju] = torch.cat(sums).cpu().numpy()
        live = torch.cat(live)
        lap("counts")

        # The JAX package's pair budget, on the same per-tile counts in the
        # same order: it keeps and drops the same tiles. argwhere's row-major
        # order is the sweep's, so row k of `live` is the k-th nonzero tile.
        coords = np.argwhere(grid > 0).astype(np.int32)
        if len(coords) == 0:
            return []
        rows = np.arange(len(coords))
        tile_totals = grid[coords[:, 0], coords[:, 1]]
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
            coords, rows = coords[order][keep], order[keep]
            if len(coords) == 0:
                return []

        def subdivide(coords: np.ndarray, sub_counts: torch.Tensor, g: int) -> np.ndarray:
            """Origins (units of size / g) of the nonzero sub-blocks."""
            f, a, b = nonzero(sub_counts)
            return np.stack([coords[f, 0] * g + a, coords[f, 1] * g + b],
                            axis=1).astype(np.int32)

        # The kept tiles' sub-block counts come from the sweep; each level
        # below keeps only sub-blocks whose count is nonzero.
        size = tile
        if g0 > 1:
            rows_t = torch.from_numpy(rows)
            if dev.type == "cuda":  # no synchronizing copy in the guarded scope
                rows_t = rows_t.pin_memory().to(dev, non_blocking=True)
            coords = subdivide(coords, live[rows_t], g0)
            size //= g0
        while size > REFINE_SUB:
            coords = subdivide(coords, counts(coords, size, REFINE_SUB), REFINE_SUB)
            lap(f"refine_{size}")
            size //= REFINE_SUB
            if len(coords) == 0:
                return []

        f, ii, jj = nonzero(counts(coords, size, size))  # 0/1: the pair masks
        lap("leaves")
        pi = coords[f, 0].astype(np.int64) * size + ii
        pj = coords[f, 1].astype(np.int64) * size + jj
        order = np.lexsort((pj, pi))
        out = [(int(a), int(b)) for a, b in zip(pi[order], pj[order])]
        lap("host")
        return out
