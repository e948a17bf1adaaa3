"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False. This file imports nothing of JAX, so it also runs on a GPU machine
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import asyncio

import numpy as np
import pytest
import torch

from spacedrive_tpu_torch.ops import blake3_batch as bb
from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, blake3_torch, overlap, staging

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _grid(seed, B, C, device):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(B, C, 256), dtype=np.uint32)
    lengths = rng.integers(0, C * 1024 + 1, size=B).astype(np.int32)
    edges = [0, 1, C * 1024][:B]
    lengths[:len(edges)] = edges
    return blake3_torch.words_to_device(words, lengths, device)


@pytest.mark.parametrize("B,C", [(1, 1), (37, 5), (300, 57), (64, 101)])
def test_fast_kernel_matches_plain(cuda, B, C):
    w, n = _grid(B * C, B, C, cuda)
    got, got_n = blake3_cuda.chunk_cvs_fast(w, n)
    ref, ref_n = bb.chunk_cvs(w, n)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got_n, ref_n)
    assert torch.equal(blake3_cuda.blake3_words(w, n), bb.tree_reduce(ref, ref_n))


@pytest.mark.parametrize("counter_base,whole", [
    (0, True), (16, False), (2**32 - 3, False),
    (np.array([2**32 - 1, 0, 2**40 + 7, 5], np.uint64),
     np.array([True, False, True, False])),
])
def test_windowed_kernel_matches_plain(cuda, counter_base, whole):
    w, n = _grid(4, 4, 9, cuda)
    got, _ = blake3_cuda.chunk_cvs(w, n, counter_base, whole)
    ref, _ = bb.chunk_cvs(w, n, counter_base, whole)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_edge_lengths_match_oracle_on_the_card(cuda):
    rng = np.random.default_rng(5)
    msgs = [rng.integers(0, 256, k, dtype=np.uint8).tobytes()
            for k in (0, 1, 63, 64, 65, 1024, 1025, 2048, 3071, 4096, 57352)]
    words, lengths = bb.pack_messages(msgs)
    digests = blake3_torch.blake3_words(words, lengths, device="cuda")
    hexes = bb.digests_to_hex(blake3_torch.digests_to_numpy(digests))
    assert hexes == [blake3_ref.blake3_hex(m) for m in msgs]


@pytest.mark.parametrize("C", [1, 5, 57, 101, 128, 129, 4096])
def test_fused_blake3_words_matches_plain_tree(cuda, C):
    B = 3 if C == 4096 else 40
    w, n = _grid(C, B, C, cuda)
    cvs, n_chunks = bb.chunk_cvs(w, n)
    want = bb.tree_reduce(cvs, n_chunks)
    assert torch.equal(blake3_cuda.blake3_words(w, n), want)
    for span in (4, 256):  # more folds; one span
        got = blake3_cuda._fused(w, n, windowed=False, span=span)
        torch.cuda.synchronize()
        assert torch.equal(got, want), span


@pytest.mark.parametrize("counter_base", [16, 2**32 - 3, 2**40 + 7])
@pytest.mark.parametrize("length", [1, 1024, 5000, 64 * 1024])
def test_window_top_matches_plain_windowed_tree(cuda, counter_base, length):
    rng = np.random.default_rng(length)
    words = rng.integers(0, 2**32, size=(1, 64, 256), dtype=np.uint32)
    w, n = blake3_torch.words_to_device(words, np.array([length], np.int32), cuda)
    cvs, n_chunks = bb.chunk_cvs(w, n, counter_base, whole=False)
    want = bb.tree_reduce(cvs, n_chunks, root=False)[0]
    assert torch.equal(blake3_cuda.window_top(w, n, counter_base), want)
    got = blake3_cuda._fused(w, n, windowed=True, counter_base=counter_base, span=4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)


def test_launch_error_raises_and_counts_nothing(cuda):
    # 65536 one-chunk spans exceed the grid's y limit: the launcher refuses.
    w = torch.zeros((1, 65536, 256), dtype=torch.int32, device=cuda)
    n = torch.tensor([65536 * 1024], dtype=torch.int32, device=cuda)
    blake3_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        blake3_cuda._fused(w, n, windowed=False, span=1)
    assert all(v == 0 for v in blake3_cuda.launches.values())


def _marked_corpus(root, n_files, batch):
    """Sparse large files, each with its own bytes at a sampled offset."""
    batches = overlap.make_sparse_corpus(str(root), n_files, 120_000, batch)
    rng = np.random.default_rng(n_files)
    for paths, _ in batches:
        for p in paths:
            with open(p, "r+b") as f:
                f.seek(40_000)
                f.write(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    return batches


def _plain_digests(paths, sizes):
    """Python readers + build_cas_messages + the plain torch K1, on the CPU."""
    large, _small, _empty, errors = staging.stage_files(list(zip(paths, sizes.tolist())))
    assert not errors
    words, lengths = bb.build_cas_messages(large.payloads, large.sizes)
    w, n = blake3_torch.words_to_device(words, lengths, "cpu")
    return blake3_torch.digests_to_numpy(bb.tree_reduce(*bb.chunk_cvs(w, n)))


def test_pinned_ring_matches_plain(cuda, tmp_path):
    batches = _marked_corpus(tmp_path, 5 * 64, 64)
    blake3_cuda.reset_launches()
    res, stats = overlap.run_overlapped(batches, depth=3, devices=["cuda"],
                                        calibrate_every=2)
    assert blake3_cuda.launches[blake3_cuda.FAST] == stats.kernel_batches \
        == len(batches) + len(stats.samples)
    assert stats.leases_out == 0 and stats.pinned_bytes > 0
    assert stats.stage_python_batches == 0 and stats.fallback_files == 0
    for k, (paths, sizes) in enumerate(batches):
        assert np.array_equal(res[k], _plain_digests(paths, sizes)), k


def test_identify_path_on_pinned_pages_matches_plain(cuda, tmp_path):
    rng = np.random.default_rng(3)
    files = []
    for i, n in enumerate((1, 1023, 102_400, 102_401, 3_000_000, 0)):
        p = tmp_path / f"f{i}"
        p.write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        files.append((str(p), n))
    files.append((str(tmp_path / "missing"), 4096))
    pool = staging.cas_pool(files)
    assert pool.pinned and all(page.is_pinned() for page in pool._pages)
    blake3_cuda.reset_launches()
    ids, errors = staging.cas_ids_for_files(files, "cuda", pool=pool)
    assert blake3_cuda.launches[blake3_cuda.FAST] == 2  # one per size class
    plain_ids, plain_errors = staging.cas_ids_for_files(files, "plain")
    assert ids == plain_ids and set(errors) == set(plain_errors) == {len(files) - 1}
    assert pool.in_use == 0


def test_non_blocking_copy_needs_a_pinned_source(cuda):
    words = torch.zeros((1, 1, 256), dtype=torch.int32)
    lengths = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="pinned"):
        blake3_torch.words_to_device(words, lengths, cuda, non_blocking=True)
    w, n = blake3_torch.words_to_device(words.pin_memory(), lengths.pin_memory(), cuda,
                                        non_blocking=True)
    torch.cuda.synchronize()
    assert w.is_cuda and torch.equal(w.cpu(), words) and torch.equal(n.cpu(), lengths)


def _scan(data_dir, root, backend, device_batch=None):
    """Index + identify `root` in a fresh library; (library, identifier report)."""
    from spacedrive_tpu_torch.jobs.manager import JobBuilder, JobManager
    from spacedrive_tpu_torch.jobs.report import JobReport
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob

    lib = Libraries(str(data_dir)).create("cuda-test")
    loc = locations.create_location(lib, str(root))

    async def main():
        jobs = JobManager()
        if device_batch is None:
            await locations.scan_location(jobs, lib, loc, backend=backend, with_media=False)
        else:
            await JobBuilder(IndexerJob(location_id=loc)).queue_next(FileIdentifierJob(
                location_id=loc, backend=backend, device_batch=device_batch)).spawn(jobs, lib)
        await jobs.wait_idle()

    asyncio.run(main())
    row = lib.db.query_one("SELECT * FROM job WHERE name = 'file_identifier'")
    return lib, JobReport.from_row(row)


def _step_size_classes(lib, step):
    """Size classes with rows, summed over the identifier's pages of `step`
    orphans in id order: the K1 launches the scan should make."""
    from spacedrive_tpu_torch.ops.cas import MINIMUM_FILE_SIZE

    sizes = [int.from_bytes(r["size_in_bytes_bytes"], "big") for r in lib.db.query(
        "SELECT size_in_bytes_bytes FROM file_path WHERE is_dir = 0 ORDER BY id")]
    return sum(any(s > MINIMUM_FILE_SIZE for s in page)
               + any(0 < s <= MINIMUM_FILE_SIZE for s in page)
               for page in (sizes[k:k + step] for k in range(0, len(sizes), step)))


def _identity(lib):
    rows = lib.db.query("SELECT materialized_path, name, cas_id, object_id FROM file_path "
                        "WHERE is_dir = 0")
    groups = {}
    for r in rows:
        groups.setdefault(r["object_id"], set()).add(r["materialized_path"] + r["name"])
    return ({r["materialized_path"] + r["name"]: r["cas_id"] for r in rows},
            sorted(sorted(g) for g in groups.values()))


@pytest.mark.parametrize("device_batch", [None, 500])
def test_scan_location_on_the_card_matches_plain(cuda, tmp_path, device_batch):
    rng = np.random.default_rng(17)
    root = tmp_path / "corpus"
    _marked_corpus(root / "large", 1536, 512)
    (root / "small").mkdir()
    for i in range(509):
        (root / "small" / f"s{i}").write_bytes(
            rng.integers(0, 256, int(rng.integers(1, 102_400)), dtype=np.uint8).tobytes())
    (root / "small" / "dup-a").write_bytes(b"same bytes" * 100)
    (root / "small" / "dup-b").write_bytes(b"same bytes" * 100)
    (root / "small" / "empty").write_bytes(b"")
    blake3_cuda.reset_launches()
    lib, report = _scan(tmp_path / "cuda", root, "cuda", device_batch)
    launches = dict(blake3_cuda.launches)
    plain_lib, plain_report = _scan(tmp_path / "plain", root, "plain")
    cas, groups = _identity(lib)
    assert len(cas) == 2048 and (cas, groups) == _identity(plain_lib)
    assert report.status == plain_report.status == 2  # COMPLETED
    meta = report.metadata
    assert meta["chunk_size"] == (device_batch or 16384)
    assert launches[blake3_cuda.FAST] == _step_size_classes(lib, meta["chunk_size"]) >= 2
    assert sum(launches.values()) == launches[blake3_cuda.FAST]
    assert meta["pool"]["in_use_after_hash"] == meta["pool"]["in_use_at_end"] == 0
    assert meta["pool"]["pinned_bytes"] > 0


def test_light_scan_on_the_card_matches_plain(cuda, tmp_path):
    """light_scan_location(backend="cuda") of one directory against the
    plain version in a library of its own: the same counts, CAS IDs and
    objects; K1 once per size class per page of CHUNK_SIZE orphans."""
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.objects.identifier import CHUNK_SIZE

    rng = np.random.default_rng(23)
    root = tmp_path / "corpus"
    _marked_corpus(root, 230, 90)
    for i in range(70):
        (root / f"s{i}").write_bytes(
            rng.integers(0, 256, int(rng.integers(1, 102_400)), dtype=np.uint8).tobytes())
    (root / "dup-a").write_bytes(b"same" * 300)
    (root / "dup-b").write_bytes(b"same" * 300)
    (root / "sub").mkdir()
    (root / "sub" / "not-walked").write_bytes(b"below the directory")
    out = {}
    for backend in ("cuda", "plain"):
        lib = Libraries(str(tmp_path / backend)).create("light")
        loc = locations.create_location(lib, str(root))
        blake3_cuda.reset_launches()
        result = locations.light_scan_location(lib, loc, None, backend=backend)
        out[backend] = (result, dict(blake3_cuda.launches), _identity(lib),
                        _step_size_classes(lib, CHUNK_SIZE))
        lib.db.close()
    (got, launches, identity, classes), (want, plain_launches, plain_identity, _) = \
        out["cuda"], out["plain"]
    assert got == want and got["saved"] == 303 and got["created"] == 301
    assert identity == plain_identity and "/sub/not-walked" not in identity[0]
    assert launches[blake3_cuda.FAST] == classes >= 2
    assert sum(launches.values()) == launches[blake3_cuda.FAST]
    assert sum(plain_launches.values()) == 0


# -- near-dup search: the Hamming kernel, pHash, the pyramid, the job --------


def _digests(seed, n, words, planted=0):
    """Random [n, words] uint32 digests; `planted` rows copy an earlier row
    with 0..6 bits flipped."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    for k in range(planted):
        i, j = k, n // 2 + k
        d[j] = d[i]
        for b in rng.choice(32 * words, size=int(rng.integers(0, 7)), replace=False):
            d[j, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d


def _brute_pairs(d, threshold):
    dist = np.bitwise_count(d[:, None, :] ^ d[None, :, :]).sum(axis=-1)
    ii, jj = np.nonzero(np.triu(dist <= threshold, k=1))
    return list(zip(ii.tolist(), jj.tolist()))


@pytest.mark.parametrize("n,m,words,oi,oj,n_valid", [
    (4096, 4096, 2, 0, 0, None), (4096, 4096, 8, 0, 0, None), (37, 1001, 3, 5, 0, 900),
    (1, 1, 1, 0, 0, None), (130, 66, 8, 4000, 4096, 4150), (64, 4097, 2, 0, 64, 3000),
    (50, 90, 2, 30, 0, 60), (64, 100, 2, 500, 0, None)])
def test_hamming_near_mask_matches_plain(cuda, n, m, words, oi, oj, n_valid):
    from spacedrive_tpu_torch.ops import hamming_cuda

    rng = np.random.default_rng(n + m + words)
    # Low-entropy words: about half the pairs fall under a threshold of 8·W.
    x = rng.integers(0, 2**32, (n, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    y = rng.integers(0, 2**32, (m, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    xt = torch.from_numpy(x.view(np.int32)).to(cuda)
    yt = torch.from_numpy(y.view(np.int32)).to(cuda)
    hamming_cuda.reset_launches()
    got = hamming_cuda.hamming_near_mask(xt, yt, 8 * words, oi, oj, n_valid)
    assert hamming_cuda.launches[hamming_cuda.NEAR_MASK] == 1
    want = hamming_cuda.near_mask_plain(xt, yt, 8 * words, oi, oj, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # Every case but a single pair and a block wholly below the diagonal
    # holds near pairs.
    assert int(want.sum()) > 0 or n * m == 1 or oi >= oj + m - 1


@pytest.mark.parametrize("words", range(1, 9))
@pytest.mark.parametrize("threshold", [-1, "half", "32W"])
def test_hamming_near_mask_at_every_width_and_threshold_edge(cuda, words, threshold):
    from spacedrive_tpu_torch.ops import hamming_cuda

    t = {"half": 8 * words, "32W": 32 * words}.get(threshold, threshold)
    rng = np.random.default_rng(words)
    x = rng.integers(0, 2**32, (200, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    xt = torch.from_numpy(x.view(np.int32)).to(cuda)
    for oi, oj, n_valid in ((0, 0, None), (70, 0, 190), (0, 130, 250)):
        got = hamming_cuda.hamming_near_mask(xt[:137], xt[3:], t, oi, oj, n_valid)
        want = hamming_cuda.near_mask_plain(xt[:137], xt[3:], t, oi, oj, n_valid)
        assert torch.equal(got, want)
        assert int(want.sum()) > 0 or t == -1


def _count_case(seed, n_rows, words):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, (n_rows, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    d[n_rows // 3:n_rows // 3 + 40] = d[:40]  # exact and near copies
    d[n_rows // 3:n_rows // 3 + 20, 0] ^= np.uint32(0b111)
    return d


@pytest.mark.parametrize("size,g,n_rows,words,n_valid", [
    (4096, 16, 9000, 2, 7000), (256, 16, 1000, 1, 1000), (256, 16, 1000, 8, 901),
    (16, 16, 300, 3, 290), (64, 16, 500, 5, 437), (512, 16, 1100, 2, 1100),
    (128, 1, 700, 4, 650), (1024, 4, 2100, 6, 2050), (2048, 4, 4200, 7, 3000)])
@pytest.mark.parametrize("threshold", [-1, "half", "32W"])
def test_hamming_near_counts_matches_plain(cuda, size, g, n_rows, words, n_valid, threshold):
    """Blocks on, above and below the diagonal, off it by ragged offsets and
    across it, cut by n_valid; sub-blocks from 1 to 512 rows (several
    256-row bands adding into one)."""
    from spacedrive_tpu_torch.ops import hamming_cuda

    t = {"half": 8 * words, "32W": 32 * words}.get(threshold, threshold)
    d = torch.from_numpy(_count_case(size + words, n_rows, words).view(np.int32)).to(cuda)
    top = n_rows - size
    origins = np.array([[0, 0], [0, top], [top, 0], [top, top], [top // 3, top // 2],
                        [top // 2, top // 3], [7, 5], [5, 7 + size // 2]], np.int64)
    hamming_cuda.reset_launches()
    got = hamming_cuda.hamming_near_counts(d, origins, size, g, t, n_valid)
    assert hamming_cuda.launches[hamming_cuda.NEAR_COUNTS] == 1
    want = hamming_cuda.near_counts_plain(d, origins, size, g, t, n_valid)
    torch.cuda.synchronize()
    assert got.shape == (len(origins), g, g) and torch.equal(got, want)
    assert int(want.sum()) > 0 or t == -1


def test_hamming_near_counts_refuses_and_counts_no_launch(cuda):
    from spacedrive_tpu_torch.ops import hamming_cuda

    wide = torch.zeros((64, 9), dtype=torch.int32, device=cuda)
    narrow = torch.zeros((64, 2), dtype=torch.int32, device=cuda)
    hamming_cuda.reset_launches()
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_counts(wide, [[0, 0]], 16, 16, 3, 64)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_counts(narrow, [[0, 60]], 16, 16, 3, 64)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_counts(narrow, [[0, 0]], 64, 128, 3, 64)
    assert hamming_cuda.launches[hamming_cuda.NEAR_COUNTS] == 0


def test_hamming_near_mask_refuses_what_the_kernel_cannot_take(cuda):
    from spacedrive_tpu_torch.ops import hamming_cuda

    wide = torch.zeros((4, 9), dtype=torch.int32, device=cuda)
    hamming_cuda.reset_launches()
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_mask(wide, wide, 3)
    assert hamming_cuda.launches[hamming_cuda.NEAR_MASK] == 0


def test_phash_on_the_card_matches_plain_under_ties(cuda):
    from spacedrive_tpu_torch.ops import phash

    rng = np.random.default_rng(3)
    grids = rng.integers(0, 256, (513, 32, 32)).astype(np.float32)
    grids[:256] = np.round(grids[:256] / 64) * 64  # coarse grids: many ties
    got = phash.phash_torch(grids, cuda)
    want = phash.phash_torch(grids, "cpu")
    assert phash.agree_under_ties(got, want, grids)


@pytest.mark.parametrize("case", ["planted", "dense", "one_tile"])
def test_near_dup_pairs_on_the_card_match_plain(cuda, case):
    from spacedrive_tpu_torch.ops import hamming, hamming_cuda

    if case == "planted":
        d, tile = _digests(9, 700, 2, planted=20), 256
    elif case == "dense":
        d, tile = _digests(12, 600, 2), 256
        d[0:80] = d[0]
        d[300] = d[550]
    else:
        d, tile = _digests(4, 3000, 2, planted=40), 4096
    hamming_cuda.reset_launches()
    stats = {}
    got = hamming.near_dup_pairs(d, 10, tile=tile, stats=stats, device=cuda)
    assert hamming_cuda.launches[hamming_cuda.NEAR_MASK] == (case == "one_tile")
    # The pyramid: the sweep, the leaves and nothing between at tile 256.
    assert hamming_cuda.launches[hamming_cuda.NEAR_COUNTS] == (0 if case == "one_tile" else 2)
    assert got == hamming.near_dup_pairs(d, 10, tile=tile, device="cpu") == _brute_pairs(d, 10)


def test_pair_budget_truncates_on_the_card(cuda, monkeypatch):
    from spacedrive_tpu_torch.ops import hamming

    d = _digests(13, 600, 2)
    d[0:500] = d[0]
    d[520] = d[550]
    monkeypatch.setattr(hamming, "MAX_TOTAL_PAIRS", 1000)
    stats = {}
    with pytest.warns(RuntimeWarning, match="truncating"):
        got = hamming.near_dup_pairs_device(d, 0, tile=256, stats=stats, device=cuda)
    plain_stats = {}
    with pytest.warns(RuntimeWarning, match="truncating"):
        want = hamming.near_dup_pairs_device(d, 0, tile=256, stats=plain_stats, device="cpu")
    assert got == want and stats["truncated_pairs"] == plain_stats["truncated_pairs"]
    assert (520, 550) in got and len(got) <= 1000 and stats["truncated_pairs"] > 0


def test_pyramid_at_the_sweep_tile_matches_plain(cuda):
    """tile 4096: the sweep at 256-row sub-blocks, one refinement level
    (256 → 16), the leaves; a cluster across two tiles."""
    from spacedrive_tpu_torch.ops import hamming, hamming_cuda

    d = _digests(21, 6000, 2, planted=60)
    d[4000:4200] = d[4000]
    hamming_cuda.reset_launches()
    stats = {}
    got = hamming.near_dup_pairs_device(d, 10, tile=4096, stats=stats, device=cuda)
    assert hamming_cuda.launches[hamming_cuda.NEAR_COUNTS] == 3
    assert set(stats["stage_s"]) == {"planes", "counts", "refine_256", "leaves", "host"}
    assert got == _brute_pairs(d, 10) and len(got) >= 200 * 199 // 2


def test_near_dup_job_on_the_card_matches_plain(cuda, tmp_path):
    import chip_smoke
    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.objects.dedup import NearDupDetectorJob
    from spacedrive_tpu_torch.ops import hamming_cuda, phash

    root = tmp_path / "images"
    planted = chip_smoke.write_image_corpus(root, 76, groups=8, copies=3, refused=2, seed=5,
                                            sides=((24, 200), (24, 160)))["planted"]
    results = {}
    for backend in ("cuda", "plain"):
        lib, _ = _scan(tmp_path / backend, root, backend)
        loc = lib.db.query_one("SELECT id FROM location")["id"]

        async def main():
            jobs = JobManager()
            jid = await jobs.ingest(lib, NearDupDetectorJob(location_id=loc, backend=backend))
            await jobs.wait_idle()
            return jid

        hamming_cuda.reset_launches()
        asyncio.run(main())
        if backend == "cuda":
            assert hamming_cuda.launches[hamming_cuda.NEAR_MASK] == 1
        results[backend] = chip_smoke.near_dup_state(lib, str(root))
    cuda_state, plain_state = results["cuda"], results["plain"]
    assert cuda_state["errors"] == plain_state["errors"] and len(cuda_state["errors"]) == 2
    paths = sorted(cuda_state["hashes"])
    assert paths == sorted(plain_state["hashes"])
    grids = np.stack([phash.image_to_grid(str(root / p)) for p in paths])
    assert phash.agree_under_ties(np.stack([cuda_state["hashes"][p] for p in paths]),
                                  np.stack([plain_state["hashes"][p] for p in paths]), grids)
    assert cuda_state["pairs"] == chip_smoke.brute_force_pairs(cuda_state["hashes"], 10)
    assert set(planted) <= {pair for pair, _ in cuda_state["pairs"]}


def _png_rgb(rgb) -> bytes:
    """A plain 8-bit RGB PNG (no PIL on the card's host)."""
    import struct
    import zlib
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_scan_with_media_on_the_card_matches_plain(cuda, tmp_path):
    """scan_location(with_media=True): K1 keys the thumbnails on the card;
    the media rows and thumbnails equal the plain chain's."""
    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.media import webpenc

    rng = np.random.default_rng(5)
    root = tmp_path / "photos"
    root.mkdir()
    for i in range(12):
        h, w = int(rng.integers(8, 900)), int(rng.integers(8, 900))
        px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = _png_rgb(px) if i % 2 else webpenc.encode(px)
        (root / f"p{i}.{'png' if i % 2 else 'webp'}").write_bytes(data)

    def run(backend):
        data_dir = tmp_path / backend
        lib = Libraries(str(data_dir)).create("media")
        loc = locations.create_location(lib, str(root))

        async def main():
            jobs = JobManager(services={"data_dir": str(data_dir)})
            await locations.scan_location(jobs, lib, loc, backend=backend, with_media=True)
            await jobs.wait_idle()

        asyncio.run(main())
        rows = {r["cas_id"]: tuple(r)[2:] for r in lib.db.query(
            "SELECT fp.cas_id, md.* FROM media_data md "
            "JOIN file_path fp ON fp.object_id = md.object_id")}
        thumbs = {p.name: p.read_bytes() for p in (data_dir / "thumbnails").rglob("*.webp")}
        statuses = [r["status"] for r in lib.db.query("SELECT status FROM job ORDER BY rowid")]
        lib.db.close()
        return rows, thumbs, statuses

    blake3_cuda.reset_launches()
    on_card = run("cuda")
    launches = dict(blake3_cuda.launches)
    plain = run("plain")
    from spacedrive_tpu_torch.ops.cas import MINIMUM_FILE_SIZE

    assert on_card == plain and len(on_card[0]) == 12 and len(on_card[1]) == 12
    assert on_card[2] == [2, 2, 2]
    sizes = [p.stat().st_size for p in root.iterdir()]
    classes = any(s > MINIMUM_FILE_SIZE for s in sizes) + any(s <= MINIMUM_FILE_SIZE for s in sizes)
    assert launches[blake3_cuda.FAST] == classes == sum(launches.values())


def test_the_default_scan_chain_on_the_card_matches_plain(cuda, tmp_path, monkeypatch):
    """scan_location with its default (the media job chained): audio and
    video probes, video frames, cover art, SVG and PDF thumbnails from the
    harness's own writers, on the card and with backend="plain", equal."""
    import chip_smoke

    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations

    root = tmp_path / "tree"
    monkeypatch.setattr(chip_smoke, "MEDIA_VIDEO_1080", (320, 180))
    plants = chip_smoke.write_media_slice2(root, 9)

    def run(backend):
        data_dir = tmp_path / backend
        lib = Libraries(str(data_dir)).create("media")
        loc = locations.create_location(lib, str(root))

        async def main():
            jobs = JobManager(services={"data_dir": str(data_dir)})
            await locations.scan_location(jobs, lib, loc, backend=backend)
            await jobs.wait_idle()

        asyncio.run(main())
        rows = {r["cas_id"]: r["stream_data"] for r in lib.db.query(
            "SELECT fp.cas_id, md.stream_data FROM media_data md "
            "JOIN file_path fp ON fp.object_id = md.object_id")}
        thumbs = {p.name: p.read_bytes() for p in (data_dir / "thumbnails").rglob("*.webp")}
        statuses = [r["status"] for r in lib.db.query("SELECT status FROM job ORDER BY rowid")]
        lib.db.close()
        return rows, thumbs, statuses

    blake3_cuda.reset_launches()
    on_card = run("cuda")
    assert blake3_cuda.launches[blake3_cuda.FAST] > 0
    assert on_card == run("plain") and on_card[2] == [2, 2, 2]
    assert len(on_card[0]) >= sum(p["row"] is not None for p in plants.values())
    assert len(on_card[1]) >= sum(p["thumb"] is not None for p in plants.values())


# -- the p2p tunnel's primitives and a clone on the card's host ---------------

@pytest.mark.parametrize("seed", range(4))
def test_tunnel_primitives_native_match_plain(cuda, seed):
    """The C++ X25519, Ed25519 and ChaCha20-Poly1305 against their plain
    Python twins on the card's host (which has no `cryptography`)."""
    from spacedrive_tpu_torch.p2p import _crypto

    rng = np.random.default_rng(seed)
    k, u, key = (rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(3))
    nonce = rng.integers(0, 256, 12, np.uint8).tobytes()
    msg = rng.integers(0, 256, int(rng.integers(0, 5000)), np.uint8).tobytes()
    assert _crypto.x25519(k, u) == _crypto.x25519_plain(k, u)
    assert _crypto.ed25519_public(k) == _crypto.ed25519_public(k, native=False)
    sig = _crypto.ed25519_sign(k, msg)
    assert sig == _crypto.ed25519_sign(k, msg, native=False)
    pub = _crypto.ed25519_public(k)
    assert _crypto.ed25519_verify(pub, msg, sig)
    assert not _crypto.ed25519_verify(pub, msg + b"!", sig)
    sealed = _crypto.seal(key, nonce, msg, b"aad")
    assert sealed == _crypto.seal_plain(key, nonce, msg, b"aad")
    assert _crypto.open_(key, nonce, sealed, b"aad") == msg
    with pytest.raises(_crypto.InvalidTag):
        _crypto.open_(key, nonce, bytes([sealed[0] ^ 1]) + sealed[1:], b"aad")


def test_two_nodes_clone_a_library_scanned_on_the_card(cuda, tmp_path):
    """A library scanned with K1 on the card clones over the tunnel into a
    second node, which spacedrops a file back and checksums it with K2."""
    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import validator
    from spacedrive_tpu_torch.ops import cas

    root = tmp_path / "loc"
    root.mkdir()
    rng = np.random.default_rng(3)
    for i in range(600):
        (root / f"f{i:04d}.bin").write_bytes(rng.integers(0, 256, 2000 + i, np.uint8).tobytes())
    big = tmp_path / "big.bin"
    big.write_bytes(rng.integers(0, 256, 9 << 20, np.uint8).tobytes())
    # The pure-Python reference hash of 9 MiB takes seconds: off the event
    # loop, which the tests' sanitizer holds to its stall threshold.
    want = cas.file_checksum(str(big))

    async def main():
        a, b = Node(str(tmp_path / "a")), Node(str(tmp_path / "b"))
        await a.start()
        await b.start()
        try:
            lib_a = a.create_library("cuda-clone")
            loc = locations.create_location(lib_a, str(root))
            await locations.scan_location(a.jobs, lib_a, loc, with_media=False)
            await a.jobs.wait_idle()
            await a.start_p2p(host="127.0.0.1", enable_discovery=False)
            pb = await b.start_p2p(host="127.0.0.1", enable_discovery=False)
            b.p2p.on_pairing_request = lambda peer, info: True
            assert await a.p2p.pair("127.0.0.1", pb, lib_a)
            [lib_b] = b.libraries.list()
            q = "SELECT pub_id, cas_id FROM file_path ORDER BY pub_id"
            for _ in range(400):
                if [tuple(r) for r in lib_b.db.query(q)] == [tuple(r) for r in lib_a.db.query(q)]:
                    break
                await asyncio.sleep(0.05)
            assert [tuple(r) for r in lib_b.db.query(q)] == [tuple(r) for r in lib_a.db.query(q)]
            drop = str(tmp_path / "drop.bin")
            b.p2p.on_spacedrop = lambda peer, req: drop
            assert await a.p2p.spacedrop("127.0.0.1", pb, str(big)) == "sent"
            got, errors = validator.checksums_for_files([drop], b.device)
            assert not errors and got[0] == want
        finally:
            await a.shutdown()
            await b.shutdown()

    asyncio.run(main())


def test_the_api_path_launches_every_main_path_kernel(cuda, tmp_path, monkeypatch):
    """chip_smoke's phase 14 at a small size: an ApiServer over a CUDA node
    scans, validates and searches near-duplicates through /rspc; K1, K2,
    the fold and the mask form launch, and the planted duplicate groups and
    near-duplicate pairs come back exactly (phase_api requires both)."""
    import chip_smoke
    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.ops import hamming_cuda

    monkeypatch.setattr(chip_smoke, "API_RTT_CALLS", 5)
    data_dir, root = str(tmp_path / "data"), tmp_path / "identify"
    rng = np.random.default_rng(1)
    for i in range(1200):
        p = root / f"scan-{i // 300:03d}" / f"f{i:05d}.bin"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rng.integers(0, 256, 300 + i, np.uint8).tobytes())

    async def scan():
        lib = Libraries(data_dir).create("api")
        loc = locations.create_location(lib, str(root))
        jobs = JobManager(services={"data_dir": data_dir, "device": "cuda"})
        await locations.scan_location(jobs, lib, loc, with_media=False)
        await jobs.wait_idle()
        await jobs.shutdown()
        lib.db.close()

    asyncio.run(scan())
    counts = {}
    out = chip_smoke.phase_api(tmp_path, data_dir, counts)
    for name in (blake3_cuda.FAST, blake3_cuda.WINDOWED, blake3_cuda.FOLD,
                 hamming_cuda.NEAR_MASK):
        assert counts["api"][name] > 0, name
    assert out["pairs"] == chip_smoke.API_PAIRS
    assert out["dup_groups"] == chip_smoke.API_DUP_GROUPS


def test_the_sync_guard_raises_inside_a_device_scope_and_lifts_in_a_declared_io(cuda, tmp_path):
    """The kernel registry armed in raise mode: ``.item()`` on a CUDA tensor
    inside ``device_scope`` raises (torch's sync debug error) and is recorded
    as ``host_transfer``; inside a declared ``io`` it passes; the identify
    main path runs under the armed guard with no record."""
    from spacedrive_tpu_torch.ops import kernel_registry

    got = []
    kernel_registry.arm("raise", lambda kind, detail, may_raise: got.append(kind))
    try:
        x = torch.ones(4, device="cuda")
        with pytest.raises(RuntimeError, match="synchroniz"):
            with kernel_registry.device_scope("test.witness"):
                x.sum().item()
        assert got == ["host_transfer"]
        with kernel_registry.device_scope("test.declared"):
            with kernel_registry.io("cas.ids"):
                assert x.sum().item() == 4.0
        files = []
        for i, size in enumerate((10, 5000, 150_000, 300_000)):
            p = tmp_path / f"f{i}"
            p.write_bytes(bytes(range(256)) * (size // 256) + bytes(size % 256))
            files.append((str(p), size))
        ids, errors = staging.cas_ids_for_files(files, backend="cuda")
        plain, _ = staging.cas_ids_for_files(files, backend="plain")
        assert ids == plain and not errors and got == ["host_transfer"]
        assert kernel_registry.guard_mode() == "default"
    finally:
        kernel_registry.disarm()


def test_the_rings_kernel_lanes_leave_out_the_wait_behind_earlier_batches(cuda, tmp_path):
    """A kernel slowed by a ~10 ms spin on small, quickly staged batches: at
    depth 3 each batch's copy ends while earlier kernels still hold the
    compute stream. Each batch's kernel lane is its own kernel only, so the
    lanes of the device follow one another without overlap, and every
    window is bound by the kernel."""
    from spacedrive_tpu_torch import flight

    def slow_k1(w, n):
        torch.cuda._sleep(20_000_000)
        return blake3_cuda.blake3_words(w, n)

    batches = overlap.make_sparse_corpus(str(tmp_path / "c"), 64, 200_000, 8)
    flight.RECORDER.clear()
    digs, _stats = overlap.run_overlapped(batches, slow_k1, calibrate_every=len(batches),
                                          depth=3, devices=["cuda"])
    events = flight.RECORDER.snapshot()
    plain, _ = overlap.run_overlapped(batches, calibrate_every=len(batches),
                                      depth=1, devices=["cuda"])
    assert all(np.array_equal(a, b) for a, b in zip(digs, plain))
    kernels = sorted((e for e in events if e["lane"] == "kernel"), key=lambda e: e["ts_us"])
    assert sorted(e["batch"] for e in kernels) == list(range(1, len(batches)))
    assert all(e["dur_us"] > 5_000 for e in kernels)
    for prev, nxt in zip(kernels, kernels[1:]):
        assert nxt["ts_us"] >= prev["ts_us"] + prev["dur_us"] - 100, (prev, nxt)
    windows = [e for e in events if e["lane"] == "window"]
    assert len(windows) == len(batches) - 1
    assert {w["binding"] for w in windows} == {"kernel"}
