"""The port's NearDupDetectorJob against the JAX package's, on the CPU.

One corpus (one file of every ``chip_smoke.IMAGE_KINDS`` entry: PNG of
every colour type and depth, Adam7 and 16-bit PNG, BMP, JPEG of every
chroma sampling, gray, progressive, with restart intervals and Adobe RGB,
GIF, ICO, TIFF (LZW, Deflate, PackBits, uncompressed), a DNG-shaped file,
WebP (lossless, colour-indexed, lossy, VP8X with ALPH or an animation);
planted near-dup groups — the same pixels re-encoded, as BMP and TIFF,
with added noise, as JPEG and as lossy WebP —, a byte-identical copy, two
identical non-image files, and a truncated PNG, a JPEG without EOI, random
bytes, a truncated TIFF and a WebP whose VP8 data is cut, which both
decoders refuse) is scanned and searched by the JAX package
(``backend="numpy"``: PIL decode, numpy pHash) and by the port
(``backend="plain"``: its own decoder, the torch pHash on the CPU), each in
a library of its own. The two must store the same pHash per path, the same
``near_dup_pair`` rows by path pair and distance, and the same job errors;
``exact_duplicate_groups`` and ``near_duplicates`` must read the same. The
LSH branch runs with ``ALL_PAIRS_LIMIT`` set low on both sides.
"""

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke
from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu.objects import dedup as jax_dedup
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.objects import dedup
from spacedrive_tpu_torch.ops import phash


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    n_singles = len(chip_smoke.IMAGE_KINDS)  # one file of each kind
    made = chip_smoke.write_image_corpus(root, n_singles + 7 * 2 + 1 + 5, groups=2, copies=1,
                                         refused=5, seed=21, sides=((24, 120), (24, 100)))
    assert set(made["kinds"]) == set(chip_smoke.IMAGE_KINDS)
    kinds = {p.suffix for p in root.rglob("*.*")}
    assert kinds >= {".png", ".bmp", ".jpg", ".gif", ".ico", ".tif", ".dng", ".webp"}
    (root / "d000" / "a.bin").write_bytes(b"D" * 5000)
    (root / "d000" / "b.bin").write_bytes(b"D" * 5000)
    return root, made


def _run(libraries, manager, loc_module, job_cls, data_dir, root, backend, scan_backend):
    lib = libraries(str(data_dir)).create("dedup")
    loc = loc_module.create_location(lib, str(root))

    async def main():
        jobs = manager()
        await loc_module.scan_location(jobs, lib, loc, backend=scan_backend, with_media=False)
        await jobs.wait_idle()
        await jobs.ingest(lib, job_cls(location_id=loc, backend=backend))
        await jobs.wait_idle()

    asyncio.run(main())
    return lib, loc


def _both(tmp_path, root):
    jax_lib, jax_loc = _run(JaxLibraries, JaxJobManager, jax_locations,
                            jax_dedup.NearDupDetectorJob, tmp_path / "jax", root, "numpy",
                            "numpy")
    port_lib, port_loc = _run(Libraries, JobManager, locations, dedup.NearDupDetectorJob,
                              tmp_path / "port", root, "plain", "plain")
    return (jax_lib, jax_loc), (port_lib, port_loc)


def _near_view(rows):
    return sorted((r["distance"], sorted([sorted(r["paths_a"]), sorted(r["paths_b"])]))
                  for r in rows)


def _groups_view(groups):
    return sorted((g["cas_id"], g["count"], g["total_bytes"], g["reclaimable_bytes"],
                   sorted(g["paths"])) for g in groups)


def test_near_dup_job_matches_the_jax_packages(tmp_path, corpus):
    root, made = corpus
    (jax_lib, jax_loc), (port_lib, port_loc) = _both(tmp_path, root)
    try:
        want = chip_smoke.near_dup_state(jax_lib, str(root))
        got = chip_smoke.near_dup_state(port_lib, str(root))
        paths = sorted(got["hashes"])
        assert paths == sorted(want["hashes"]) and len(paths) >= 14
        grids = np.stack([phash.image_to_grid(str(root / p)) for p in paths])
        assert phash.agree_under_ties(np.stack([got["hashes"][p] for p in paths]),
                                      np.stack([want["hashes"][p] for p in paths]), grids)
        # Each side's rows are its digests' exact pairs; between paths whose
        # hashes are equal, the two sides' rows are equal.
        assert got["pairs"] == chip_smoke.brute_force_pairs(got["hashes"], 10)
        assert want["pairs"] == chip_smoke.brute_force_pairs(want["hashes"], 10)
        same = {p for p in paths if np.array_equal(got["hashes"][p], want["hashes"][p])}
        assert len(same) >= len(paths) - 1
        assert [r for r in got["pairs"] if set(r[0]) <= same] == \
            [r for r in want["pairs"] if set(r[0]) <= same] != []
        assert set(made["planted"]) <= {pair for pair, _ in got["pairs"]}
        assert got["errors"] == want["errors"] == made["refused"]
        assert _groups_view(dedup.exact_duplicate_groups(port_lib, port_loc)) == \
            _groups_view(jax_dedup.exact_duplicate_groups(jax_lib, jax_loc)) != []
        assert _near_view(dedup.near_duplicates(port_lib)) == \
            _near_view(jax_dedup.near_duplicates(jax_lib)) != []
        report = next(r for r in chip_smoke.job_reports(port_lib)
                      if r.name == "near_dup_detector")
        assert report.metadata["hashed"] == made["files"] - len(made["refused"]) > len(paths)
        assert set(report.metadata["phase_s"]) >= {"decode", "phash", "db_hash", "pairs"}
    finally:
        jax_lib.db.close()
        port_lib.db.close()


def test_lsh_branch_matches_the_jax_packages(tmp_path, corpus, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(jax_dedup, "ALL_PAIRS_LIMIT", 2)
    monkeypatch.setattr(dedup, "ALL_PAIRS_LIMIT", 2)
    (jax_lib, _), (port_lib, _) = _both(tmp_path, root)
    try:
        want = chip_smoke.near_dup_state(jax_lib, str(root))
        got = chip_smoke.near_dup_state(port_lib, str(root))
        assert got["pairs"] == want["pairs"] != []
        assert set(got["pairs"]) <= set(chip_smoke.brute_force_pairs(got["hashes"], 10))
    finally:
        jax_lib.db.close()
        port_lib.db.close()


def test_a_native_plane_fault_fails_the_job_and_is_no_decode_error(tmp_path, corpus,
                                                                    monkeypatch):
    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.ops import _build

    root, _ = corpus
    library = _build.library

    def broken(name):
        if name == "imgdec":
            raise OSError("libimgdec.so: cannot open shared object file")
        return library(name)

    monkeypatch.setattr(_build, "library", broken)
    lib, _ = _run(Libraries, JobManager, locations, dedup.NearDupDetectorJob,
                  tmp_path / "port", root, "plain", "plain")
    try:
        report = next(r for r in chip_smoke.job_reports(lib) if r.name == "near_dup_detector")
        assert report.status == JobStatus.FAILED
        assert any("libimgdec.so" in e for e in report.errors_text)
        assert not any("phash decode failed" in e for e in report.errors_text)
        assert chip_smoke.near_dup_state(lib, str(root))["hashes"] == {}
    finally:
        lib.db.close()


def test_job_refuses_an_unknown_backend_and_cuda_without_a_card(monkeypatch):
    with pytest.raises(ValueError):
        dedup.NearDupDetectorJob(location_id=1, backend="numpy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dedup.NearDupDetectorJob(location_id=1)
    assert dedup.NearDupDetectorJob.NAME == jax_dedup.NearDupDetectorJob.NAME
    assert dedup.PHASHABLE_EXTENSIONS == jax_dedup.PHASHABLE_EXTENSIONS
    assert (dedup.PHASH_BATCH, dedup.DEFAULT_THRESHOLD, dedup.ALL_PAIRS_LIMIT) == \
        (jax_dedup.PHASH_BATCH, jax_dedup.DEFAULT_THRESHOLD, jax_dedup.ALL_PAIRS_LIMIT)
