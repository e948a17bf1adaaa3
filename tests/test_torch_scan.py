"""The port's scan → index → identify → store chain against the JAX
package's, on the CPU, compared exactly.

One corpus (nested directories, a hidden file, a ``.git`` directory, small
files and files past 100 KiB, a duplicate pair, an empty file, a ``.ts``
file whose kind is read from its header, and a 300-file directory whose
indexer batch crosses ``BLOB_MIN_OPS``) is scanned by the JAX package
(``scan_location(backend="numpy", with_media=False)``, nothing compiled)
and by the port (``backend="plain"``, the plain torch BLAKE3), each into a
library of its own. The two libraries must agree on: the file_path rows,
path → cas_id, the partition of paths by object, object kinds, shared-op
counts per (format, model, kind), and the jobs with their final statuses.
The comparison repeats after an edit, a delete and an add (the indexer's
update and remove paths), after ``scan_location_sub_path``, and for the
validator job in ``fill`` and ``verify`` mode, a corrupted file included.
"""

import asyncio
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu.objects.validator import ObjectValidatorJob as JaxValidator
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.jobs.report import JobStatus
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob
from spacedrive_tpu_torch.objects.validator import ObjectValidatorJob
from spacedrive_tpu_torch.sync import opblob
from spacedrive_tpu_torch.sync.manager import BLOB_MIN_OPS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write(path, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _corpus(root: str) -> None:
    rng = np.random.default_rng(11)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    large = rand(150_000)
    _write(f"{root}/docs/small.txt", rand(5000))
    _write(f"{root}/docs/large.bin", large)
    _write(f"{root}/photos/large_copy.bin", large)
    _write(f"{root}/docs/empty", b"")
    _write(f"{root}/docs/clip.ts", b"export const x = 1;\n" * 40)  # code, not video
    _write(f"{root}/photos/red.png", rand(3000))
    _write(f"{root}/.hidden", rand(10))
    _write(f"{root}/.git/config", b"[core]\n")
    _write(f"{root}/nested/a/b/c/deep.rs", rand(700))
    _write(f"{root}/nested/a/exact-100KiB", rand(102_400))
    for i in range(BLOB_MIN_OPS + 44):
        _write(f"{root}/many/f{i:04d}.txt", f"file {i}\n".encode() + rand(i % 64))


def _rel(r) -> str:
    ext = f".{r['extension']}" if r["extension"] else ""
    return f"{r['materialized_path'][1:]}{r['name']}{ext}"


def _snapshot(db) -> dict:
    paths = db.query("SELECT fp.*, o.kind AS okind FROM file_path fp "
                     "LEFT JOIN object o ON o.id = fp.object_id")
    files = [r for r in paths if not r["is_dir"]]
    groups = {}
    for r in files:
        groups.setdefault(r["object_id"], set()).add(_rel(r))
    ops = Counter(("row", r["model"], r["kind"]) for r in
                  db.query("SELECT model, kind FROM shared_operation"))
    for b in db.query("SELECT model, data FROM shared_op_blob"):
        ops.update(("blob", b["model"], e[2]) for e in opblob.decode_entries_py(b["data"]))
    return {
        "rows": sorted((r["materialized_path"], r["name"], r["extension"], r["is_dir"],
                        int.from_bytes(r["size_in_bytes_bytes"] or b"", "big"))
                       for r in paths),
        "cas": {_rel(r): r["cas_id"] for r in files},
        "objects": sorted(sorted(g) for g in groups.values()),
        "kinds": {_rel(r): r["okind"] for r in files},
        "checksums": {_rel(r): r["integrity_checksum"] for r in files},
        "ops": dict(ops),
        "jobs": [(r["name"], r["status"]) for r in
                 db.query("SELECT name, status FROM job ORDER BY rowid")],
        "n_objects": db.query_one("SELECT COUNT(*) AS n FROM object")["n"],
    }


class _Side:
    """One package's library, job manager and location over the corpus."""

    def __init__(self, data_dir, libraries, manager, scan, scan_sub, validator, backend):
        self.lib = libraries(data_dir).create("parity")
        self.manager, self.scan, self.scan_sub = manager, scan, scan_sub
        self.validator, self.backend = validator, backend
        self.loc = None

    def run(self, coro_fn):
        async def main():
            jobs = self.manager()
            await coro_fn(jobs)
            await jobs.wait_idle()
        asyncio.run(main())

    def scan_all(self, root):
        if self.loc is None:
            self.loc = self.create(self.lib, root)
        self.run(lambda jobs: self.scan(jobs, self.lib, self.loc, backend=self.backend,
                                        with_media=False))

    def scan_sub_path(self, sub):
        self.run(lambda jobs: self.scan_sub(jobs, self.lib, self.loc, sub,
                                            backend=self.backend))

    def validate(self, mode, sub_path=None):
        self.run(lambda jobs: jobs.ingest(self.lib, self.validator(self.loc, mode, sub_path)))

    def close(self):
        self.lib.db.close()


@pytest.fixture
def sides(tmp_path):
    root = str(tmp_path / "corpus")
    _corpus(root)
    jax = _Side(str(tmp_path / "jax"), JaxLibraries, JaxJobManager,
                jax_locations.scan_location, jax_locations.scan_location_sub_path,
                lambda loc, mode, sub: JaxValidator(location_id=loc, sub_path=sub,
                                                    backend="numpy", mode=mode),
                "numpy")
    jax.create = jax_locations.create_location
    port = _Side(str(tmp_path / "port"), Libraries, JobManager,
                 locations.scan_location, locations.scan_location_sub_path,
                 lambda loc, mode, sub: ObjectValidatorJob(location_id=loc, sub_path=sub,
                                                           device="cpu", mode=mode),
                 "plain")
    port.create = locations.create_location
    yield root, jax, port
    jax.close()
    port.close()


def _same(jax, port) -> dict:
    a, b = _snapshot(jax.lib.db), _snapshot(port.lib.db)
    assert a == b
    return b


def test_scan_chain_matches_the_jax_package(sides):
    root, jax, port = sides
    for side in (jax, port):
        side.scan_all(root)
    snap = _same(jax, port)
    assert len(snap["cas"]) == 10 + BLOB_MIN_OPS + 44
    assert snap["cas"]["docs/empty"] is None
    assert ["docs/large.bin", "photos/large_copy.bin"] in snap["objects"]
    assert snap["n_objects"] == len(snap["objects"]) == len(snap["cas"]) - 1
    assert snap["kinds"]["docs/clip.ts"] == 20  # CODE: no video magic in the header
    assert snap["ops"][("blob", "file_path", "c")] >= BLOB_MIN_OPS
    assert snap["jobs"] == [("indexer", int(JobStatus.COMPLETED)),
                            ("file_identifier", int(JobStatus.COMPLETED))]
    stats = port.lib.statistics()
    assert stats == {**jax.lib.statistics(), "library_db_size": stats["library_db_size"]}

    # The indexer's update and remove paths, then a rescan of one subtree.
    # The new file is written before the delete so that it cannot reuse the
    # deleted file's inode (which both packages read as a move).
    _write(f"{root}/docs/small.txt", b"edited " * 999)
    os.utime(f"{root}/docs/small.txt", (2e9, 2e9))
    _write(f"{root}/docs/new.txt", b"new file")
    os.remove(f"{root}/photos/red.png")
    for side in (jax, port):
        side.scan_all(root)
    snap = _same(jax, port)
    assert "photos/red.png" not in snap["cas"] and snap["cas"]["docs/new.txt"]
    assert ("row", "file_path", "d") in snap["ops"]
    assert ("row", "file_path", "u:cas_id") in snap["ops"]

    _write(f"{root}/nested/a/added.bin", b"\x01" * 200_000)
    for side in (jax, port):
        side.scan_sub_path("nested/a")
    snap = _same(jax, port)
    assert snap["cas"]["nested/a/added.bin"] is not None

    # The validator: fill every checksum, verify one subtree, then catch a
    # corrupted file (same size, same mtime: only the bytes changed).
    for side in (jax, port):
        side.validate("fill")
        side.validate("verify", "nested")
    snap = _same(jax, port)
    assert snap["jobs"][-1] == ("object_validator", int(JobStatus.COMPLETED))
    assert all(len(c) == 64 for c in snap["checksums"].values())
    target = f"{root}/many/f0007.txt"
    st = os.stat(target)
    with open(target, "r+b") as f:
        f.write(b"\xff")
    os.utime(target, ns=(st.st_atime_ns, st.st_mtime_ns))
    for side in (jax, port):
        side.validate("verify", "many")
    snap = _same(jax, port)
    assert snap["jobs"][-1] == ("object_validator", int(JobStatus.COMPLETED_WITH_ERRORS))
    errors = port.lib.db.query("SELECT errors_text FROM job ORDER BY rowid")[-1][0]
    assert "CHECKSUM MISMATCH" in errors and "f0007.txt" in errors


@pytest.mark.parametrize("case", ["with_media_chains", "sub_path_and_backend_refused"])
def test_media_and_unknown_backends_are_refused(tmp_path, case):
    """``with_media=True`` chains the media processor after the identifier;
    the sub-path rescan (which chains none, in the JAX package too) and an
    unknown backend are refused before any job is written."""
    lib = Libraries(str(tmp_path / "data")).create("refuse")
    try:
        root = tmp_path / "loc"
        root.mkdir()
        from PIL import Image
        Image.new("RGB", (40, 30), (200, 30, 90)).save(root / "photo.png")
        loc = locations.create_location(lib, str(root))
        if case == "with_media_chains":
            async def main():
                jobs = JobManager(services={"data_dir": str(tmp_path / "data")})
                await locations.scan_location(jobs, lib, loc, backend="plain", with_media=True)
                await jobs.wait_idle()
            asyncio.run(main())
            jobs = [(r["name"], r["status"]) for r in
                    lib.db.query("SELECT name, status FROM job ORDER BY rowid")]
            assert jobs == [(n, int(JobStatus.COMPLETED)) for n in
                            ("indexer", "file_identifier", "media_processor")]
            assert lib.db.query_one("SELECT COUNT(*) AS n FROM media_data")["n"] == 1
            return
        with pytest.raises(NotImplementedError, match="sub-path rescan chains no media job"):
            asyncio.run(locations.scan_location_sub_path(JobManager(), lib, loc, "x",
                                                         backend="plain", with_media=True))
        with pytest.raises(ValueError, match="unknown backend"):
            FileIdentifierJob(location_id=loc, backend="auto")
        assert lib.db.query_one("SELECT COUNT(*) AS n FROM job")["n"] == 0
    finally:
        lib.db.close()


def test_a_failed_step_is_redone_without_two_hashes_at_once(tmp_path, monkeypatch):
    """A step whose transaction fails leaves its cursor; the next step redoes
    that page after waiting out the worker's hash of the page after it, so
    two hashes never share the job's two-page pool at once."""
    from spacedrive_tpu_torch.jobs.manager import JobBuilder
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.objects import identifier

    root = tmp_path / "corpus"
    for i in range(250):
        _write(f"{root}/f{i:03d}", f"file {i}\n".encode())
    running, most = [0], [0]
    hash_page = FileIdentifierJob._hash

    def watched_hash(self, files):
        running[0] += 1
        most[0] = max(most[0], running[0])
        try:
            time.sleep(0.05)  # widens any overlap of two hashes
            return hash_page(self, files)
        finally:
            running[0] -= 1

    failed = []
    commit_page = identifier.identify_chunk

    def fail_once(*args, **kwargs):
        if not failed:
            failed.append(True)
            raise RuntimeError("injected commit failure")
        return commit_page(*args, **kwargs)

    monkeypatch.setattr(FileIdentifierJob, "_hash", watched_hash)
    monkeypatch.setattr(identifier, "identify_chunk", fail_once)
    lib = Libraries(str(tmp_path / "data")).create("redo")
    try:
        loc = locations.create_location(lib, str(root))

        async def main():
            jobs = JobManager()
            await JobBuilder(IndexerJob(location_id=loc)).queue_next(FileIdentifierJob(
                location_id=loc, backend="plain", device_batch=50)).spawn(jobs, lib)
            await asyncio.wait_for(jobs.wait_idle(), 60)

        asyncio.run(main())
        job = lib.db.query_one("SELECT status, errors_text FROM job "
                               "WHERE name = 'file_identifier'")
        assert job["status"] == int(JobStatus.COMPLETED_WITH_ERRORS)
        assert "injected commit failure" in job["errors_text"]
        assert most[0] == 1
        # Five steps for five pages, one lost to the failure: the failed
        # page was redone and only the last page is still orphaned.
        rows = lib.db.query("SELECT object_id FROM file_path WHERE is_dir = 0 ORDER BY id")
        assert [r["object_id"] is None for r in rows] == [False] * 200 + [True] * 50
    finally:
        lib.db.close()
