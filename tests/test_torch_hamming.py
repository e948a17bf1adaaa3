"""The port's Hamming all-pairs against the JAX package's, on the CPU.

The plain near mask (the CPU side of ``hamming_near_mask``) against JAX's
``hamming_tile`` at W = 2 and W = 8; the plain count form (the CPU side of
``hamming_near_counts``) against JAX's ``_tile_counts_block``,
``_refine_counts`` and ``_leaf_masks`` at tiles 16, 64 and 256, W = 1, 2
and 8, ragged N and thresholds −1, 0, 10 and 32W; ``near_dup_pairs_device``
(the pyramid on the count form) against the JAX function and a numpy brute
force at ``tests/test_hamming.py``'s shapes, the truncation of a degenerate
cluster (the kept pairs and the dropped count the JAX package's) and the
power-of-two tile check included; the numpy LSH copies against the JAX
package's outputs. JAX compiles small shapes only.
"""

import warnings

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import hamming as jax_hamming
from spacedrive_tpu_torch.ops import hamming, hamming_cuda


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _brute(d, threshold):
    dist = np.bitwise_count(d[:, None, :] ^ d[None, :, :]).sum(axis=-1)
    ii, jj = np.nonzero(np.triu(dist <= threshold, k=1))
    return list(zip(ii.tolist(), jj.tolist()))


def _planted(seed, n, pairs, flips=8):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    for k in range(pairs):
        i, j = k, n // 2 + k
        d[j] = d[i]
        for b in rng.choice(64, size=int(rng.integers(0, flips)), replace=False):
            d[j, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d


@pytest.mark.parametrize("words", [2, 8])
def test_plain_mask_and_distances_match_jax_hamming_tile(words):
    rng = np.random.default_rng(words)
    d = rng.integers(0, 2**32, size=(32, words), dtype=np.uint32)
    d[5] = d[17] ^ np.uint32(0b101)
    want = np.asarray(jax_hamming.hamming_tile(d, d))
    t = torch.from_numpy(d.view(np.int32))
    assert np.array_equal(hamming_cuda.hamming_distances_plain(t, t).numpy(), want)
    threshold = 16 * words
    hamming_cuda.reset_launches()
    mask = hamming_cuda.hamming_near_mask(t, t, threshold)
    assert hamming_cuda.launches[hamming_cuda.NEAR_MASK] == 0  # the CPU runs plain
    assert np.array_equal(mask.numpy(), np.triu(want <= threshold, k=1))
    assert mask[5, 17]


def test_popcount32_at_the_word_edges():
    v = torch.tensor([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0x0F0F0F0F], dtype=torch.int64)
    assert hamming_cuda.popcount32(v).tolist() == [0, 1, 1, 32, 16, 16]


def test_plain_mask_respects_origins_and_the_valid_range():
    d = np.zeros((6, 2), np.uint32)  # all at distance 0
    t = torch.from_numpy(d.view(np.int32))
    mask = hamming_cuda.near_mask_plain(t, t, 0, oi=2, oj=0, n_valid=6)
    gi, gj = np.arange(6)[:, None] + 2, np.arange(6)[None, :]
    assert np.array_equal(mask.numpy(), (gi < gj) & (gi < 6) & (gj < 6))


def test_pyramid_matches_jax_and_brute_force():
    d = _planted(9, 700, 20)  # 3 tiles at tile=256, a ragged tail
    stats = {}
    got = hamming.near_dup_pairs_device(d, threshold=10, tile=256, stats=stats, device="cpu")
    want = jax_hamming.near_dup_pairs_device(d, threshold=10, tile=256)
    assert got == want == _brute(d, 10) and len(got) >= 20
    # The sweep counts 16-row sub-blocks, so no refinement level is left.
    assert set(stats["stage_s"]) == {"planes", "counts", "leaves", "host"}


def test_pair_masks_match_the_jax_packages():
    """JAX's ``_pair_mask`` against the port's index mask on the same dots,
    and against the count form at g = size (one count a pair) on digests."""
    rng = np.random.default_rng(6)
    dots = rng.integers(-64, 65, (16, 16)).astype(np.float32)
    d = _planted(6, 48, 10)
    words = torch.from_numpy(d.view(np.int32))
    planes = hamming_cuda.bit_planes(words).numpy()
    for i, j in ((0, 0), (0, 1), (1, 2), (2, 1)):
        want = np.asarray(jax_hamming._pair_mask(dots, i, j, 16, 64, 10, 40))
        origin = torch.tensor([[i * 16, j * 16]], dtype=torch.int64)
        in_range = hamming_cuda.index_mask(origin[:, 0], origin[:, 1], 16, 16, 40)[0]
        assert np.array_equal(((torch.from_numpy(dots) >= 64 - 20) & in_range).numpy(), want)
        block = planes[i * 16:i * 16 + 16] @ planes[j * 16:j * 16 + 16].T
        want = np.asarray(jax_hamming._pair_mask(block, i, j, 16, 64, 10, 40))
        got = hamming_cuda.near_counts_plain(words, origin, 16, 16, 10, 40)[0]
        assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_counts_sweep_counts_only_in_range_upper_pairs():
    d = np.zeros((768, 2), np.uint32)  # every pair within any threshold
    d[700:] = 1  # padding rows past N
    words = torch.from_numpy(d.view(np.int32))
    origins = np.stack(np.triu_indices(3), axis=1) * 256
    sub = hamming_cuda.hamming_near_counts(words, origins, 256, 16, 0, 700).numpy()
    counts = np.zeros((3, 3), np.int64)
    counts[np.triu_indices(3)] = sub.sum(axis=(1, 2))
    tile = np.minimum(np.arange(3) * 256 + 256, 700) - np.arange(3) * 256
    want = np.outer(tile, tile)
    want[np.diag_indices(3)] = tile * (tile - 1) // 2
    assert np.array_equal(counts, np.triu(want))
    # A diagonal tile's sub-blocks: 16·15/2 pairs on the diagonal, 256
    # above it, none below.
    diag = sub[0]
    assert np.array_equal(diag, np.triu(np.full((16, 16), 256), 1) + 120 * np.eye(16, dtype=int))


COUNT_CASES = [(16, 1, 40), (64, 2, 150), (256, 8, 300)]  # tile, W, N (ragged)


def _low_entropy(seed, n, words):
    """Digests with half their bits fixed and a few near copies: every
    threshold from 0 to 32W gives a different count."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, (n, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    d[n // 2:n // 2 + 8] = d[:8]
    d[n // 2:n // 2 + 6, 0] ^= np.uint32(0b1011)
    return d


def _jax_planes(d, tile):
    nt = -(-len(d) // tile)
    padded = np.zeros((nt * tile, d.shape[1]), np.uint32)
    padded[:len(d)] = d
    return padded, jax_hamming._bit_planes(padded)


@pytest.mark.parametrize("tile,words,n", COUNT_CASES)
@pytest.mark.parametrize("threshold", [-1, 0, 10, "32W"])
def test_count_form_plain_matches_jax_tile_counts_block(tile, words, n, threshold):
    t = 32 * words if threshold == "32W" else threshold
    padded, planes = _jax_planes(_low_entropy(tile + words, n, words), tile)
    nt = len(padded) // tile
    want = np.asarray(jax_hamming._tile_counts_block(
        planes.reshape(nt, tile, 32 * words), 0, t, n, nt))
    origins = np.stack(np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij"), -1) * tile
    got = hamming_cuda.hamming_near_counts(torch.from_numpy(padded.view(np.int32)),
                                           origins.reshape(-1, 2), tile, 1, t, n)
    assert np.array_equal(got.numpy().reshape(nt, nt), want)
    assert want.sum() > 0 or t == -1


@pytest.mark.parametrize("tile,words,n", COUNT_CASES)
@pytest.mark.parametrize("threshold", [-1, 0, 10, "32W"])
def test_count_form_plain_matches_jax_refine_counts(tile, words, n, threshold):
    """Blocks on, above, below and across the diagonal and past N, at
    sub-blocks of tile/16 (16 → 1: the leaf masks)."""
    t = 32 * words if threshold == "32W" else threshold
    padded, flat = _jax_planes(_low_entropy(tile * words, n, words), tile)
    nt = len(padded) // tile
    coords = np.stack(np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.int32)
    want = np.asarray(jax_hamming._refine_counts(flat, coords, t, n, tile, 16))
    got = hamming_cuda.hamming_near_counts(torch.from_numpy(padded.view(np.int32)),
                                           coords * tile, tile, 16, t, n)
    assert np.array_equal(got.numpy(), want)
    if tile == 16:
        masks = np.asarray(jax_hamming._leaf_masks(flat, coords, t, n, 16))
        assert np.array_equal(got.numpy(), masks)


def test_count_form_refuses_what_it_cannot_take():
    words = torch.zeros((64, 2), dtype=torch.int32)
    for size, g in ((48, 16), (64, 3), (16, 32), (256, 128)):
        with pytest.raises(ValueError, match="powers of two"):
            hamming_cuda.hamming_near_counts(words, [[0, 0]], size, g, 1, 64)
    with pytest.raises(ValueError, match="origins"):
        hamming_cuda.hamming_near_counts(words, [[0, 16]], 64, 16, 1, 64)
    assert hamming_cuda.hamming_near_counts(words, np.zeros((0, 2)), 16, 16, 1, 64).shape == (
        0, 16, 16)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_pyramid_levels_at_small_tiles_match_brute_force(tile):
    """tile 16: per-tile sweep, leaves of 16; 32: sweep at 2-row
    sub-blocks, leaves of 2; 64: sweep at 4, leaves of 4."""
    d = _planted(tile, 300, 30, flips=6)
    d[100:110] = d[100]
    stats = {}
    got = hamming.near_dup_pairs_device(d, threshold=8, tile=tile, stats=stats, device="cpu")
    assert got == _brute(d, 8) and len(got) >= 45
    assert not any(k.startswith("refine") for k in stats["stage_s"])


def test_dense_cluster_and_a_sparse_pair():
    rng = np.random.default_rng(12)
    d = rng.integers(0, 2**32, size=(600, 2), dtype=np.uint32)
    d[0:80] = d[0]
    d[300] = d[550]
    got = hamming.near_dup_pairs_device(d, threshold=0, tile=256, device="cpu")
    want = [(i, j) for i in range(80) for j in range(i + 1, 80)] + [(300, 550)]
    assert got == sorted(want) == _brute(d, 0)


def test_pair_budget_truncates_degenerate_clusters(monkeypatch):
    rng = np.random.default_rng(13)
    d = rng.integers(0, 2**32, size=(600, 2), dtype=np.uint32)
    d[0:500] = d[0]
    d[520] = d[550]
    monkeypatch.setattr(hamming, "MAX_TOTAL_PAIRS", 1000)
    stats = {}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pairs = hamming.near_dup_pairs_device(d, threshold=0, tile=256, stats=stats,
                                              device="cpu")
    assert any(issubclass(x.category, RuntimeWarning) and "truncating" in str(x.message)
               for x in w)
    assert (520, 550) in pairs and len(pairs) <= 1000
    assert set(pairs) <= set(_brute(d, 0)) and pairs == sorted(pairs)
    assert stats["truncated_pairs"] == len(_brute(d, 0)) - len(pairs)
    # The same tiles kept and dropped as the JAX package's budget.
    monkeypatch.setattr(jax_hamming, "MAX_TOTAL_PAIRS", 1000)
    jax_stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jax_hamming.near_dup_pairs_device(d, threshold=0, tile=256, stats=jax_stats)
    assert pairs == want and stats["truncated_pairs"] == jax_stats["truncated_pairs"]


@pytest.mark.parametrize("per_dispatch", [2, 4])
def test_sweep_split_over_dispatches_keeps_what_one_dispatch_keeps(monkeypatch, per_dispatch):
    """Each dispatch keeps only its live tiles' sub-counts; split over
    several, the pairs and the budget's cut are the JAX package's."""
    d = _planted(14, 600, 40, flips=6)
    d[0:500:5] = d[0]
    want = _brute(d, 6)
    monkeypatch.setattr(hamming, "BLOCKS_PER_DISPATCH", per_dispatch)
    assert hamming.near_dup_pairs_device(d, threshold=6, tile=64, device="cpu") == want
    monkeypatch.setattr(hamming, "MAX_TOTAL_PAIRS", 2500)
    monkeypatch.setattr(jax_hamming, "MAX_TOTAL_PAIRS", 2500)
    stats, jax_stats = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = hamming.near_dup_pairs_device(d, threshold=6, tile=256, stats=stats,
                                            device="cpu")
        kept = jax_hamming.near_dup_pairs_device(d, threshold=6, tile=256, stats=jax_stats)
    assert got == kept and 0 < len(got) < len(want)
    assert stats["truncated_pairs"] == jax_stats["truncated_pairs"] > 0


def test_non_pow2_tile_raises():
    with pytest.raises(ValueError, match="power of two"):
        hamming.near_dup_pairs_device(np.zeros((3000, 2), np.uint32), threshold=0,
                                      tile=1000, device="cpu")


@pytest.mark.parametrize("n,tile", [(4, 2), (300, 128), (500, 4096)])
def test_near_dup_pairs_one_tile_and_delegated(n, tile):
    d = _planted(n, n, n // 4, flips=4)
    assert hamming.near_dup_pairs(d, 3, tile=tile, device="cpu") == _brute(d, 3)


def test_exact_dup_groups():
    ids = ["aa", "bb", "aa", "cc", "bb", "aa"]
    assert hamming.exact_dup_groups(ids) == jax_hamming.exact_dup_groups(ids) == {
        "aa": [0, 2, 5], "bb": [1, 4]}


def test_lsh_copies_match_the_jax_packages():
    d = _planted(5, 2000, 50, flips=6)
    d[10] = d[500] = d[900]
    assert hamming.phash_bands(d) == jax_hamming.phash_bands(d)
    pairs = hamming.lsh_candidate_pairs(d)
    assert np.array_equal(pairs, jax_hamming.lsh_candidate_pairs(d))
    assert np.array_equal(hamming.lsh_candidate_pairs(d, max_bucket=2),
                          jax_hamming.lsh_candidate_pairs(d, max_bucket=2))
    assert np.array_equal(hamming.pair_distances(d, pairs),
                          jax_hamming.pair_distances(d, pairs))
    got = hamming.near_dup_pairs_lsh(d, 10)
    assert got == jax_hamming.near_dup_pairs_lsh(d, 10) and set(got) <= set(_brute(d, 10))


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hamming.near_dup_pairs(np.zeros((3, 2), np.uint32), 1)
