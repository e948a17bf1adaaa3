"""The port's file-ops jobs (copy, cut, delete, erase, duplicate) against
the JAX package's, on the CPU.

The same two-location tree goes through the JAX router over
``spacedrive_tpu.node.Node`` and through the port's router over
``Node(device="cpu")``; after each ``files.*Files`` procedure and its job,
both trees (names, " (N)" suffixes included, and bytes) and both
libraries' rows after a full rescan must be equal. The name helpers are
held against the JAX ones case by case, and the four jobs are in the
port's ``JOB_REGISTRY``, so a paused one cold-resumes.
"""

import asyncio
import hashlib
import os

import pytest
import torch

from spacedrive_tpu.api.router import mount_router as jax_mount_router
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import fs_ops as jax_fs_ops
from spacedrive_tpu_torch.api.router import mount_router
from spacedrive_tpu_torch.jobs.job import JOB_REGISTRY, JobState
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.jobs.report import JobStatus
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import fs_ops


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,ext,i", [
    ("report", "pdf", 2), ("report (1)", "pdf", 2), ("dir", None, 1),
    ("report (1) final", "txt", 3), ("a (2) (3)", None, 4), ("(1)", "x", 1),
    (" (7)", None, 8), ("report(1)", "pdf", 2),
])
def test_append_digit_to_filename_is_the_jax_packages(name, ext, i):
    assert fs_ops.append_digit_to_filename(name, ext, i) == \
        jax_fs_ops.append_digit_to_filename(name, ext, i)


@pytest.mark.parametrize("base,taken", [
    ("a.txt", ["a.txt"]), ("a.txt", ["a.txt", "a (1).txt"]),
    ("a (1).txt", ["a (1).txt"]), ("dir", ["dir", "dir (1)", "dir (2)"]),
    (".hidden", [".hidden"]), ("x.tar.gz", ["x.tar.gz"]),
])
def test_find_available_filename_for_duplicate_is_the_jax_packages(tmp_path, base, taken):
    for n in taken:
        (tmp_path / n).write_bytes(b"")
    target = str(tmp_path / base)
    assert fs_ops.find_available_filename_for_duplicate(target) == \
        jax_fs_ops.find_available_filename_for_duplicate(target)


def test_the_four_jobs_cold_resume_from_their_state():
    for name in ("file_copier", "file_cutter", "file_deleter", "file_eraser"):
        assert name in JOB_REGISTRY
    job = fs_ops.FileCopierJob(location_id=1, file_path_ids=[3, 4], target_location_id=2,
                               target_relative_directory="x")
    state = JobState.fresh(job.persistable_init_args())
    again = JOB_REGISTRY["file_copier"](**JobState.deserialize(state.serialize()).init_args)
    assert again.hash() == job.hash()
    assert (again.file_path_ids, again.target_relative_directory) == ([3, 4], "x")


def _tree(root: str) -> list:
    out = []
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [(rel, d, None) for d in sorted(dirs)]
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                out.append((rel, f, hashlib.sha256(fh.read()).hexdigest()))
    return sorted(out)


def _rows(db) -> list:
    return sorted((r["location_id"], r["materialized_path"], r["name"], r["extension"],
                   r["is_dir"], r["cas_id"], r["object_id"] is not None)
                  for r in db.query("SELECT * FROM file_path"))


def _make_tree(base: str) -> None:
    for rel, data in (("src/a.txt", b"alpha"), ("src/b.bin", b"B" * 3000),
                      ("src/sub/c.txt", b"gamma"), ("src/sub/deep/d.txt", b"delta"),
                      ("src/sub/deep/e.bin", bytes(range(256)) * 9),
                      ("dst/a.txt", b"a different alpha"), ("dst/keep.txt", b"keep")):
        p = os.path.join(base, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
    os.makedirs(os.path.join(base, "dst", "into"))


async def _fs_script(router, node, base: str) -> list:
    """The five procedures in turn, each followed by its job and a full
    rescan of both locations; returns the tree and the rows after each."""
    lib = await router.dispatch("library.create", {"name": "fs"})
    lid = lib["uuid"]
    src = await router.dispatch("locations.create", {"library_id": lid,
                                                     "path": f"{base}/src"})
    dst = await router.dispatch("locations.create", {"library_id": lid,
                                                     "path": f"{base}/dst"})
    await node.jobs.wait_idle()
    library = next(iter(node.libraries.list()))

    def fp(loc, mat, name):
        return library.db.query_one(
            "SELECT id FROM file_path WHERE location_id = ? AND materialized_path = ? "
            "AND name = ?", (loc, mat, name))["id"]

    steps = [
        ("files.copyFiles", lambda: {
            "source_location_id": src, "target_location_id": dst,
            "sources_file_path_ids": [fp(src, "/", "a"), fp(src, "/", "sub")],
            "target_location_relative_directory_path": ""}),
        ("files.copyFiles", lambda: {
            "source_location_id": src, "target_location_id": dst,
            "sources_file_path_ids": [fp(src, "/", "a"), fp(src, "/", "b")],
            "target_location_relative_directory_path": "into"}),
        ("files.duplicateFiles", lambda: {
            "location_id": src, "file_path_ids": [fp(src, "/", "a"), fp(src, "/", "b"),
                                                  fp(src, "/sub/", "deep")]}),
        ("files.duplicateFiles", lambda: {
            "location_id": src, "file_path_ids": [fp(src, "/", "a (1)")]}),
        ("files.cutFiles", lambda: {
            "source_location_id": src, "target_location_id": dst,
            "sources_file_path_ids": [fp(src, "/", "b"), fp(src, "/sub/", "c")],
            "target_location_relative_directory_path": "into"}),
        ("files.deleteFiles", lambda: {
            "location_id": dst, "file_path_ids": [fp(dst, "/", "keep"), fp(dst, "/", "sub")]}),
        ("files.eraseFiles", lambda: {
            "location_id": src, "file_path_ids": [fp(src, "/", "deep"),
                                                  fp(src, "/", "a (2)")], "passes": 2}),
    ]
    out = []
    for path, make in steps:
        job_id = await router.dispatch(path, {"library_id": lid, **make()})
        assert isinstance(job_id, str) and len(job_id) == 32
        await node.jobs.wait_idle()
        for loc in (src, dst):
            await router.dispatch("locations.fullRescan", {"library_id": lid,
                                                           "location_id": loc})
            await node.jobs.wait_idle()
        reports = await router.dispatch("jobs.reports", {"library_id": lid})
        done = [r for r in reports if r["name"].startswith("file_")]
        out.append((path, _tree(base), _rows(library.db),
                    sorted((r["name"], r["status"], r["errors_text"]) for r in done)))
    return out


def test_file_ops_give_the_jax_jobs_trees_and_rows(tmp_path):
    results = []
    for name, make, mount in (("jax", JaxNode, jax_mount_router),
                              ("port", lambda d: Node(d, device="cpu"), mount_router)):
        base = str(tmp_path / name)
        _make_tree(base)
        node = make(str(tmp_path / f"{name}-data"))

        async def main():
            try:
                return await _fs_script(mount(node), node, base)
            finally:
                await node.shutdown()
        results.append(asyncio.run(main()))
    theirs, mine = results
    assert len(mine) == len(theirs) == 7
    for (label, *a), (_, *b) in zip(mine, theirs):
        assert a == b, label
    names = {(d, n) for d, n, _ in mine[-1][1]}
    # the " (N)" names of copy, duplicate and cut, and what delete and erase removed
    assert {("dst", "a (1).txt"), ("src", "a (1).txt"), ("src", "b (1).bin"),
            ("dst/into", "b (1).bin"), ("dst/into", "c.txt"), ("src/sub", "deep")} <= names
    assert not {("src", "a (2).txt"), ("src", "deep"), ("dst", "keep.txt"),
                ("dst", "sub")} & names


def test_the_eraser_overwrites_before_it_unlinks(tmp_path, monkeypatch):
    """The Python overwrite: every pass writes the file's length in random
    bytes (fsynced) before the truncate and unlink."""
    target = tmp_path / "loc" / "secret.bin"
    target.parent.mkdir()
    target.write_bytes(b"S" * 5000)
    writes = []
    real_open = open

    class Spy:
        def __init__(self, f):
            self.f = f

        def __getattr__(self, k):
            return getattr(self.f, k)

        def write(self, b):
            writes.append(bytes(b))
            return self.f.write(b)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return self.f.__exit__(*a)

    def spy_open(path, mode="r", *a, **k):
        f = real_open(path, mode, *a, **k)
        return Spy(f) if str(path) == str(target) and mode == "r+b" else f

    monkeypatch.setattr("builtins.open", spy_open)
    job = fs_ops.FileEraserJob(location_id=1, file_path_ids=[], passes=3)
    step = {"id": None, "pub_id": None, "is_dir": False, "name": "secret",
            "extension": "bin", "full_path": str(target)}

    async def main():
        return await job.execute_step(None, {"dirs_to_remove": []}, step, 0)
    outcome = asyncio.run(main())
    assert not target.exists()
    assert outcome.metadata == {"erased": str(target)}
    assert [len(w) for w in writes] == [5000] * 3
    assert all(w != b"S" * 5000 for w in writes)


def test_a_paused_copy_cold_resumes_in_a_new_manager(tmp_path):
    base = str(tmp_path / "t")
    _make_tree(base)

    async def main():
        node = Node(str(tmp_path / "data"), device="cpu")
        router = mount_router(node)
        lib = await router.dispatch("library.create", {"name": "fs"})
        lid = lib["uuid"]
        src = await router.dispatch("locations.create", {"library_id": lid,
                                                         "path": f"{base}/src",
                                                         "dry_run": True})
        dst = await router.dispatch("locations.create", {"library_id": lid,
                                                         "path": f"{base}/dst",
                                                         "dry_run": True})
        library = node.libraries.list()[0]
        from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
        for loc in (src, dst):
            await node.jobs.wait(await node.jobs.ingest(library, IndexerJob(location_id=loc)))
        ids = [r["id"] for r in library.db.query(
            "SELECT id FROM file_path WHERE location_id = ? AND is_dir = 0", (src,))]
        job = fs_ops.FileCopierJob(location_id=src, file_path_ids=ids,
                                   target_location_id=dst, target_relative_directory="into")
        job_id = await node.jobs.ingest(library, job)
        node.jobs.pause(job_id)
        status = await node.jobs.wait(job_id)
        fresh = JobManager(services={"data_dir": node.data_dir})
        if status == JobStatus.PAUSED:
            assert job_id in await fresh.cold_resume(library)
            assert await fresh.wait(job_id) == JobStatus.COMPLETED
        copied = sorted(os.listdir(f"{base}/dst/into"))
        await fresh.shutdown()
        await node.shutdown()
        return status, copied
    status, copied = asyncio.run(main())
    assert status in (JobStatus.PAUSED, JobStatus.COMPLETED)
    assert copied == ["a.txt", "b.bin", "c.txt", "d.txt", "e.bin"]
