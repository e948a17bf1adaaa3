"""The port's Hamming all-pairs against the JAX package's, on the CPU.

The plain near mask (the CPU side of ``hamming_near_mask``) against JAX's
``hamming_tile`` at W = 2 and W = 8; ``near_dup_pairs_device`` (the counts
sweep and the refinement pyramid in torch) against the JAX function and a
numpy brute force at ``tests/test_hamming.py``'s shapes, the truncation of
a degenerate cluster and the power-of-two tile check included; the numpy
LSH copies against the JAX package's outputs. JAX compiles only shapes
``tests/test_hamming.py`` compiles, plus the one [32, 8] distance tile.
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
    assert np.array_equal(hamming.hamming_tile(d, d).numpy(), want)
    t = torch.from_numpy(d.view(np.int32))
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
    assert set(stats["stage_s"]) >= {"planes", "counts", "refine_256", "leaves"}


def test_pair_masks_match_the_jax_packages():
    rng = np.random.default_rng(6)
    dots = rng.integers(-64, 65, (16, 16)).astype(np.float32)
    for i, j in ((0, 0), (0, 1), (1, 2), (2, 1)):
        want = np.asarray(jax_hamming._pair_mask(dots, i, j, 16, 64, 10, 40))
        got = hamming._pair_mask(torch.from_numpy(dots), i, j, 16, 64, 10, 40)
        assert np.array_equal(got.numpy(), want)


def test_counts_sweep_counts_only_in_range_upper_pairs():
    d = np.zeros((700, 2), np.uint32)  # every pair within any threshold
    planes = hamming._bit_planes(torch.from_numpy(
        np.concatenate([d, np.ones((68, 2), np.uint32)]).view(np.int32)), torch.float32)
    counts = hamming._tile_counts_block(planes.view(3, 256, 64), 0, 0, 700, 16).numpy()
    tile = np.minimum(np.arange(3) * 256 + 256, 700) - np.arange(3) * 256
    want = np.outer(tile, tile)
    want[np.diag_indices(3)] = tile * (tile - 1) // 2
    assert np.array_equal(counts, np.triu(want))


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
