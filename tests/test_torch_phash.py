"""The port's pHash against the JAX package's numpy pHash, on the CPU.

Two float32 DCTs summed in different orders may put an AC term that sits on
its median on either side of it. The tolerance: bits agree, except a bit
whose AC term lies within 1e-4·max|AC| of its median in a float64
recomputation (``phash.near_median``); grids with margin agree exactly.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from spacedrive_tpu.ops import phash as jax_phash
from spacedrive_tpu_torch.ops import phash


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grids(seed, n, striped=False):
    """Random grids; striped ones repeat one row, so their 56 AC terms of
    vertical frequency are zero up to rounding: ties at the median."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (n, 32, 32)).astype(np.float32)
    return np.repeat(g[:, :1], 32, axis=1) if striped else g


def test_dct_and_bit_packing_are_the_jax_packages():
    assert np.array_equal(phash.dct_matrix(32), jax_phash.dct_matrix(32))
    bits = np.random.default_rng(0).integers(0, 2, (17, 63)).astype(bool)
    words = phash._bits_to_words(bits)
    assert np.array_equal(words, jax_phash._bits_to_words(bits))
    assert np.array_equal(phash.words_to_bits(words)[:, :63], bits)
    for w in words:
        blob = phash.phash_to_bytes(w)
        assert blob == jax_phash.phash_to_bytes(w) and len(blob) == 8
        assert np.array_equal(phash.phash_from_bytes(blob), w)


def test_median_of_63_terms_is_numpys():
    ac = np.random.default_rng(1).standard_normal((200, 63)).astype(np.float32)
    ac[:50] = np.round(ac[:50])  # repeated values
    got = torch.median(torch.from_numpy(ac), dim=1).values.numpy()
    assert np.array_equal(got, np.median(ac, axis=1))


@pytest.mark.parametrize("striped", [False, True])
def test_phash_matches_numpy_under_ties(striped):
    grids = _grids(2 + striped, 120, striped)
    got, want = phash.phash_torch(grids, "cpu"), jax_phash.phash_numpy(grids)
    assert phash.agree_under_ties(got, want, grids)
    if striped:  # the rule is exercised
        assert (phash.near_median(grids).sum(axis=1) > 1).all()


def test_grids_with_margin_agree_exactly():
    grids = _grids(4, 120)
    ties = phash.near_median(grids).sum(axis=1)  # the median term itself is 1
    clear = grids[ties == 1]
    assert len(clear) > 90
    assert np.array_equal(phash.phash_torch(clear, "cpu"), jax_phash.phash_numpy(clear))


def test_tie_rule_flags_a_flipped_bit_off_the_median():
    grids = _grids(5, 4)
    words = phash.phash_torch(grids, "cpu")
    bits = phash.words_to_bits(words)
    far = np.flatnonzero(~phash.near_median(grids)[0, :63])[0]
    bits[0, far] ^= True
    flipped = np.packbits(bits, axis=1).view(">u4").astype(np.uint32)
    assert not phash.agree_under_ties(flipped, words, grids)


def test_tf32_is_off_inside_and_restored(monkeypatch):
    # The products run in float64, which no TF32 switch reduces, and leave
    # the process-wide switch as the caller set it.
    seen = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a: seen.append(
        tuple(t.dtype for t in a)) or matmul(*a))
    matmul_flags = torch.backends.cuda.matmul
    before = matmul_flags.fp32_precision
    matmul_flags.fp32_precision = "tf32"
    try:
        phash.phash_torch(_grids(6, 2), "cpu")
        assert seen == [(torch.float64, torch.float64)] * 2
        assert matmul_flags.fp32_precision == "tf32"
    finally:
        matmul_flags.fp32_precision = before


def test_grids_must_be_32_by_32():
    with pytest.raises(ValueError):
        phash.phash_torch(np.zeros((2, 16, 16), np.float32), "cpu")


def _smooth_png(path, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    arr = np.kron(rng.normal(size=(12, 16)), np.ones((16, 16)))
    arr = (arr - arr.min()) / np.ptp(arr) * 255
    if noise:
        arr = np.clip(arr + np.random.default_rng(seed + 100).normal(scale=noise,
                                                                     size=arr.shape), 0, 255)
    Image.fromarray(arr.astype(np.uint8), "L").convert("RGB").save(path)


def test_phash_files_matches_the_jax_packages(tmp_path):
    paths = []
    for k in range(6):
        paths.append(str(tmp_path / f"img{k}.png"))
        _smooth_png(paths[-1], k // 2, noise=3.0 * (k % 2))
    bmp = tmp_path / "img.bmp"
    Image.open(paths[0]).save(bmp)
    paths.append(str(bmp))
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    paths.insert(3, str(tmp_path / "bad.jpg"))
    got, got_errors = phash.phash_files(paths, "cpu")
    want, want_errors = jax_phash.phash_files(paths, backend="numpy")
    assert got_errors == want_errors == [f"phash decode failed: {paths[3]}"]
    assert sorted(got) == sorted(want) == [k for k in range(len(paths)) if k != 3]
    keys = sorted(got)
    grids = np.stack([jax_phash.image_to_grid(paths[k]) for k in keys])
    assert phash.agree_under_ties(np.stack([got[k] for k in keys]),
                                  np.stack([want[k] for k in keys]), grids)
    assert np.array_equal(got[0], got[len(paths) - 1])  # the BMP of img0's pixels
