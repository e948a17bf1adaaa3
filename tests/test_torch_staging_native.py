"""The port's native staging plane against the JAX package's, on the CPU.

``spacedrive_tpu_torch`` builds its own copy of the staging half of
``native/sdio.cpp`` (``csrc/sdio_stage.cpp``) with g++ at first use. These
tests hold its packed staging (``stage_batch_native``) and its dense
staging (``_stage_files_native``) byte for byte against the JAX
package's, over an edge-case corpus; its CAS IDs and digests against the
JAX package's numpy reference; and the per-file degradation ladder, page
scrubbing, the pool's blocking and the build's locking on their own.
"""

import os
import struct
import threading

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_batch as jax_bb
from spacedrive_tpu.ops import staging as jax_staging
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.ops import _build, cas, staging

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native plane, switched on (its `make` builds it)."""
    from spacedrive_tpu import native as jax_native_mod

    monkeypatch.setenv("SDTPU_STAGE_NATIVE", "on")
    if not jax_native_mod.available():  # as the JAX package's own tests do
        pytest.skip("the JAX package's native libsdio is unavailable")
    return jax_native_mod


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _pattern(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def corpus(tmp_path):
    """(path, declared size) pairs: large, small, empty, missing, stale and
    grown files."""
    files = []
    for k, n in enumerate((102_401, 1_000_000, 1, 1023, 102_400)):
        files.append((_write(tmp_path / f"f{n}", _pattern(n, k)), n))
    files.append((_write(tmp_path / "empty", b""), 0))
    files.append((str(tmp_path / "missing"), 5000))
    files.append((_write(tmp_path / "stale", _pattern(150_000, 9)), 4_000_000))
    files.append((_write(tmp_path / "grew", _pattern(102_500, 10)), 3000))
    files.append((str(tmp_path / "missing-large"), 300_000))
    return files


SUBSETS = {
    "mixed": lambda files: files,
    "large": lambda files: [f for f in files if f[1] > cas.MINIMUM_FILE_SIZE],
    "small": lambda files: [f for f in files if 0 < f[1] <= cas.MINIMUM_FILE_SIZE],
}


def _cpu_pool(pages=1, rows=16):
    return staging.StagePool(CPU, pages, staging.StagePool.bytes_for(rows, 101 * 1024))


@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_stage_batch_native_matches_jax_package(corpus, jax_native, subset):
    files = SUBSETS[subset](corpus)
    ours = staging.stage_batch_native(files, _cpu_pool(), n_threads=2)
    theirs = jax_staging.stage_batch_native(files, pool=jax_staging.StagePool())
    assert theirs is not None
    try:
        assert ours.words.shape == theirs.words.shape
        assert ours.words.shape[1] == (57 if subset == "large" else 101)
        assert np.array_equal(ours.words, theirs.words)
        assert np.array_equal(ours.lengths, theirs.lengths)
        assert ours.empty_rows == theirs.empty_rows
        assert sorted(ours.errors) == sorted(theirs.errors)
        assert ours.fallback_files == theirs.fallback_files == 0
        words, lengths = ours.tensors()  # the copy sources: views of the page
        assert words.data_ptr() == ours.lease.page.data_ptr()
        assert np.array_equal(words.numpy().view(np.uint32), ours.words)
        assert np.array_equal(lengths.numpy(), ours.lengths)
    finally:
        ours.release()
        theirs.release()


def test_stage_files_native_matches_jax_package(corpus, jax_native):
    ours = staging._stage_files_native(corpus, *staging._classes(corpus), 2)
    theirs = jax_staging.stage_files(corpus)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.indexes == b.indexes
        assert np.array_equal(a.payloads, b.payloads)
        assert np.array_equal(a.sizes, b.sizes)
        assert np.array_equal(a.payload_lens, b.payload_lens)
    assert ours[2] == theirs[2]
    assert ours[3] == theirs[3]


def test_packed_identify_path_matches_jax_numpy_reference(corpus):
    """The "cuda" backend's staging and hashing, on the CPU: CAS IDs equal
    the JAX package's numpy backend, errors name the same files."""
    ids, errors = staging._cas_ids_packed(corpus, CPU, None)
    ref_ids, ref_errors = jax_staging.cas_ids_for_files(corpus, backend="numpy")
    assert ids == ref_ids
    assert set(errors) == set(ref_errors)
    names = {os.path.basename(corpus[i][0]) for i in errors}
    assert names == {"missing", "stale", "grew", "missing-large"}


@pytest.mark.parametrize("subset", ["large", "small"])
def test_staged_digests_match_jax_numpy_blake3(corpus, subset):
    from spacedrive_tpu_torch.ops import blake3_cuda

    files = [f for f in SUBSETS[subset](corpus)]
    staged = staging.stage_batch_native(files, _cpu_pool(), n_threads=1)
    try:
        got = blake3_cuda.blake3_words(*staged.tensors()).numpy().view(np.uint32)
        want = np.stack(jax_bb.blake3_batch(np, staged.words, staged.lengths), axis=1)
        assert np.array_equal(got, want)
    finally:
        staged.release()


def test_per_file_degradation_matrix(tmp_path):
    """Every rung at once: a healthy row, a vanished file and a truncated
    one (both readers fail: `errors`, rows scrubbed), an empty file
    (`empty_rows`) and a small file grown past its class."""
    ok = _write(tmp_path / "ok", _pattern(120_000, 1))
    short = _write(tmp_path / "short", _pattern(4096, 2))
    empty = _write(tmp_path / "empty", b"")
    grew = _write(tmp_path / "grew", _pattern(cas.MINIMUM_FILE_SIZE + 600, 3))
    files = [(ok, 120_000), (str(tmp_path / "gone"), 120_000), (short, 150_000),
             (empty, 0), (grew, 5000)]
    pool = _cpu_pool()
    pool._pages[0].fill_(0xAB)  # a dirty page
    staged = staging.stage_batch_native(files, pool, n_threads=2)
    try:
        assert sorted(staged.errors) == [1, 2, 4]
        assert staged.empty_rows == [3]
        assert staged.fallback_files == 0
        payload = staged.lease.arr[0, 8:int(staged.lengths[0])].tobytes()
        want = np.zeros(cas.LARGE_PAYLOAD_SIZE, np.uint8)
        staging._read_large(ok, 120_000, want)
        assert payload == want.tobytes()
        assert not staged.lease.arr[0, int(staged.lengths[0]):].any()
        for r in (1, 2, 3, 4):
            assert int(staged.lengths[r]) == 8
            assert staged.lease.arr[r, :8].tobytes() == struct.pack("<Q", files[r][1])
            assert not staged.lease.arr[r, 8:].any()
        _l, _s, empty_idx, perrors = staging.stage_files(files)
        assert sorted(perrors) == sorted(staged.errors)
        assert empty_idx == staged.empty_rows
    finally:
        staged.release()


def test_rows_the_c_plane_fails_are_reread_by_python(tmp_path, monkeypatch):
    """A row the C plane reports failed is retried by the Python reader
    into the same row: fallback_files counts it and the bytes are right."""
    files = [(_write(tmp_path / f"c{i}", _pattern(n, 20 + i)), n)
             for i, n in enumerate((120_000, 50_000, 102_401))]
    clean = staging.stage_batch_native(files, _cpu_pool(), n_threads=1)
    want_words, want_lens = clean.words.copy(), clean.lengths.copy()
    clean.release()

    real = native.stage_batch

    def failing(paths, sizes, out, payload_cap, *, n_threads):
        msg_lens, status = real(paths, sizes, out, payload_cap, n_threads=n_threads)
        out[:len(paths), 8:] = 0x5A  # what a failed read could leave behind
        status[:] = native.ERR_IO
        return msg_lens, status

    monkeypatch.setattr(native, "stage_batch", failing)
    staged = staging.stage_batch_native(files, _cpu_pool(), n_threads=1)
    try:
        assert staged.errors == {} and staged.fallback_files == len(files)
        assert np.array_equal(staged.words, want_words)
        assert np.array_equal(staged.lengths, want_lens)
    finally:
        staged.release()


def test_reused_page_is_scrubbed(tmp_path):
    """Batch B staged into batch A's page inherits none of A's bytes."""
    pool = staging.StagePool(CPU, 1, 2 * 101 * 1024 + 8)
    files_a = [(_write(tmp_path / f"big{i}", _pattern(150_000, 5 + i)), 150_000)
               for i in range(2)]
    small = _write(tmp_path / "small", _pattern(600, 6))
    a = staging.stage_batch_native(files_a, pool, n_threads=1)
    page = a.lease.page.data_ptr()
    a.release()
    b = staging.stage_batch_native([(small, 600)], pool, n_threads=1)
    try:
        assert b.lease.page.data_ptr() == page and pool.in_use == 1
        assert int(b.lengths[0]) == 8 + 600
        assert b.lease.arr[0, 8:608].tobytes() == open(small, "rb").read()
        assert not b.lease.arr[0, 608:].any()
    finally:
        b.release()
    assert pool.in_use == 0


def test_exhausted_pool_blocks_until_a_lease_returns(tmp_path):
    pool = _cpu_pool(pages=1, rows=4)
    path = _write(tmp_path / "x", _pattern(120_000, 7))
    held = pool.acquire(2, 58 * 1024)
    got = []
    waiter = threading.Thread(
        target=lambda: got.append(staging.stage_batch_native([(path, 120_000)], pool,
                                                             n_threads=1)))
    waiter.start()
    waiter.join(timeout=0.3)
    assert waiter.is_alive() and not got  # blocked, not degraded
    held.release()
    waiter.join(timeout=10)
    assert not waiter.is_alive() and len(got) == 1
    assert got[0].errors == {} and got[0].fallback_files == 0
    got[0].release()
    assert pool.in_use == 0


def test_pool_and_buffer_checks():
    pool = _cpu_pool(pages=1, rows=2)
    assert pool.pinned_bytes == 0 and not pool._pages[0].is_pinned()
    with pytest.raises(ValueError):
        pool.acquire(3, 101 * 1024)  # does not fit a page
    with pytest.raises(ValueError):
        staging.StagePool(CPU, 0, 1024)
    out = np.zeros((2, 57 * 1024), np.uint8)
    sizes = np.array([1, 1], np.uint64)
    with pytest.raises(ValueError, match="stride"):
        native.stage_batch(["a", "b"], sizes, out, cas.MINIMUM_FILE_SIZE, n_threads=1)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.stage_batch(["a", "b"], sizes, out[:, :1024], cas.LARGE_PAYLOAD_SIZE,
                           n_threads=1)
    with pytest.raises(ValueError, match="n_threads"):
        native.stage_batch(["a"], sizes[:1], out, cas.LARGE_PAYLOAD_SIZE, n_threads=0)
    with pytest.raises(ValueError):
        staging.stage_batch_native([], pool)


def test_build_is_locked_named_by_source_and_never_half_written(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    built, errors = [], []

    def build():
        try:
            built.append(_build.compile_source("sdio_stage"))
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(built)) == 1 and built[0] == _build.library_path("sdio_stage")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [built[0].name, built[0].with_suffix(".log").name, "sdio_stage.lock"])
    assert "-march" not in " ".join(_build.GXX_FLAGS)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.compile_source("sdio_stage")
