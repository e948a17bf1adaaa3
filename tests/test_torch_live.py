"""The live library on the CPU: light rescans, the ephemeral browse and
the watcher.

- ``light_scan_location`` of the port (``backend="plain"``) and of the JAX
  package (``backend="numpy"``), each over its own library of the same
  corpus, after the same adds, same-size edits, deletes, renames and a new
  directory: the same returned counts and the same library snapshot
  (``_snapshot`` of ``tests/test_torch_scan.py``).
- ``walk_ephemeral`` against the JAX one, field for field, CAS IDs
  included.
- The port's ``Locations`` under the polling watcher, and under inotify
  where ``inotify_available()``: a file dropped into a watched location
  gets its row and its CAS ID; synthetic inotify batches (creates,
  renames, removed and vanished directories, a queue overflow, a dropped
  watch) dirty what they dirty in the JAX package's watcher.
- ``tasks.py``: supervised tasks are held until they end and reaped by
  owner.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu.locations.non_indexed import walk_ephemeral as jax_walk_ephemeral
from spacedrive_tpu.locations.shallow import light_scan_location as jax_light_scan
from spacedrive_tpu.ops.cas import generate_cas_id
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.locations import watcher
from spacedrive_tpu_torch.locations.non_indexed import walk_ephemeral
from spacedrive_tpu_torch.locations.walker import Walker
from test_torch_scan import _corpus, _snapshot, _write

DEADLINE_S = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scanned(libraries, manager, create, scan, data_dir, root, backend):
    lib = libraries(data_dir).create("live")
    loc = create(lib, root)

    async def main():
        jobs = manager()
        await scan(jobs, lib, loc, backend=backend, with_media=False)
        await asyncio.wait_for(jobs.wait_idle(), 30)

    asyncio.run(main())
    return lib, loc


def _edit(root: str) -> None:
    """Adds, same-size edits with a new mtime, deletes, renames and a new
    directory, in two directories. New files are written before anything
    is deleted, so no new file takes a deleted one's inode."""
    rng = np.random.default_rng(3)
    for i in range(12):
        _write(f"{root}/many/new{i:02d}.txt", rng.integers(0, 256, 40 + i, np.uint8).tobytes())
    _write(f"{root}/docs/added.bin", b"\x07" * 150_000)
    _write(f"{root}/docs/sub/inner.txt", b"inside a new directory")
    for i in (3, 5, 8):
        path = f"{root}/many/f{i:04d}.txt"
        size = os.path.getsize(path)
        _write(path, bytes(reversed(open(path, "rb").read()))[:size].ljust(size, b"!"))
        os.utime(path, (2e9 + i, 2e9 + i))
    for i in (10, 11):
        os.remove(f"{root}/many/f{i:04d}.txt")
    os.remove(f"{root}/docs/small.txt")
    os.rename(f"{root}/many/f0020.txt", f"{root}/many/renamed-20.txt")
    os.rename(f"{root}/docs/clip.ts", f"{root}/docs/clip-renamed.ts")


def test_light_scan_matches_the_jax_package(tmp_path):
    port_root, jax_root = str(tmp_path / "port-corpus"), str(tmp_path / "jax-corpus")
    for root in (port_root, jax_root):
        _corpus(root)
    jax, jloc = _scanned(JaxLibraries, JaxJobManager, jax_locations.create_location,
                         jax_locations.scan_location, str(tmp_path / "jax"), jax_root,
                         "numpy")
    port, ploc = _scanned(Libraries, JobManager, locations.create_location,
                          locations.scan_location, str(tmp_path / "port"), port_root,
                          "plain")
    try:
        assert _snapshot(port.db) == _snapshot(jax.db)
        for root in (port_root, jax_root):
            _edit(root)
        got = []
        for sub in ("many", "docs", "docs/sub", None):
            a = jax_light_scan(jax, jloc, sub, backend="numpy")
            b = locations.light_scan_location(port, ploc, sub, backend="plain")
            assert {k: v for k, v in b.items() if k != "errors"} == \
                {k: v for k, v in a.items() if k != "errors"}, sub
            assert len(b["errors"]) == len(a["errors"]) == 0
            got.append(b)
        snap = _snapshot(port.db)
        assert snap == _snapshot(jax.db)
        many, docs, sub, _root = got
        # many: 12 new files and the renamed one saved, the 3 edits and the
        # directory itself updated, the 3 edits re-identified; the renamed
        # file keeps its row and its object.
        assert many == {"saved": 13, "updated": 4, "removed": 2, "linked": 0,
                        "created": 15, "errors": []}
        # docs: added.bin, sub/ and the renamed clip saved, small.txt removed.
        assert docs == {"saved": 3, "updated": 1, "removed": 1, "linked": 0,
                        "created": 1, "errors": []}
        assert sub == {"saved": 1, "updated": 0, "removed": 0, "linked": 0,
                       "created": 1, "errors": []}
        assert snap["cas"]["many/renamed-20.txt"] is not None
        assert "many/f0020.txt" not in snap["cas"] and "docs/small.txt" not in snap["cas"]
        for i in (3, 5, 8):
            rel = f"many/f{i:04d}.txt"
            assert snap["cas"][rel] == generate_cas_id(f"{port_root}/{rel}")
        assert snap["cas"]["docs/added.bin"] == generate_cas_id(f"{port_root}/docs/added.bin")
    finally:
        port.db.close()
        jax.db.close()


def test_walk_single_dir_is_shallow(tmp_path):
    root = tmp_path / "loc"
    _write(f"{root}/a/b.txt", b"b")
    _write(f"{root}/c.txt", b"c")
    res = Walker(1, str(root)).walk_single_dir(str(root / "a"), add_root=True)
    assert sorted((e.iso.materialized_path, e.iso.name) for e in res.walked) == \
        [("/", "a"), ("/a/", "b")]
    assert not res.to_walk and not res.errors


def _ephemeral_dir(root) -> None:
    rng = np.random.default_rng(9)
    for i, ext in enumerate(("png", "jpg", "webp", "gif", "PNG", "tiff")):
        _write(f"{root}/img{i}.{ext}", rng.integers(0, 256, 500 + 70_000 * i, np.uint8).tobytes())
    _write(f"{root}/empty.png", b"")
    _write(f"{root}/notes.txt", b"not an image")
    _write(f"{root}/.hidden.png", b"hidden image")
    _write(f"{root}/noext", b"x")
    _write(f"{root}/sub/inner.png", b"in a subdirectory")


@pytest.mark.parametrize("hidden,cas", [(False, True), (True, True), (False, False)])
def test_walk_ephemeral_matches_the_jax_package(tmp_path, hidden, cas):
    root = tmp_path / "browse"
    _ephemeral_dir(root)
    want = jax_walk_ephemeral(str(root), with_hidden_files=hidden, compute_cas_ids=cas)
    got = walk_ephemeral(str(root), with_hidden_files=hidden, compute_cas_ids=cas,
                         device="cpu")
    assert got == want
    with_ids = [e for e in got if e["cas_id"]]
    assert len(with_ids) == ((6 + hidden) if cas else 0)


async def _watch_and_drop(tmp_path, poll: bool) -> dict:
    root = tmp_path / "watched"
    _write(f"{root}/d/first.txt", b"first")
    lib = Libraries(str(tmp_path / "data")).create("watched")
    loc = locations.create_location(lib, str(root))
    events = []
    live = watcher.Locations(on_event=events.append, owner="test-live", backend="plain")
    try:
        assert live.watch_location(lib, loc)
        kind = type(live.watchers[(lib.id, loc)])
        assert kind is (watcher.PollingWatcher if poll else watcher.LocationWatcher)
        await asyncio.sleep(0.05)
        _write(f"{root}/dropped.bin", b"\x05" * 120_000)
        _write(f"{root}/d/second.txt", b"second")
        deadline = time.monotonic() + DEADLINE_S
        rows = {}
        while time.monotonic() < deadline:
            rows = {r["name"]: r["cas_id"] for r in lib.db.query(
                "SELECT name, cas_id FROM file_path WHERE is_dir = 0")}
            if rows.get("dropped") and rows.get("second") and rows.get("first"):
                break
            await asyncio.sleep(0.05)
        assert rows.get("dropped") == generate_cas_id(f"{root}/dropped.bin")
        assert rows.get("second") == generate_cas_id(f"{root}/d/second.txt")
        # The rescan of d/ identifies every orphan there, first.txt too.
        assert rows.get("first") == generate_cas_id(f"{root}/d/first.txt")
        assert not [e for e in events if e["type"] == "WatcherError"]
        assert any(e["type"] == "InvalidateOperation" for e in events)
    finally:
        await live.close()
        lib.db.close()
    return {"rows": rows}


def test_polling_watcher_rescans_a_dropped_file(tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_WATCHER", "poll")
    monkeypatch.setattr(watcher.PollingWatcher, "INTERVAL_S", 0.1)
    asyncio.run(_watch_and_drop(tmp_path, poll=True))


@pytest.mark.skipif(not watcher.inotify_available(), reason="inotify is not available here")
def test_inotify_watcher_rescans_a_dropped_file(tmp_path, monkeypatch):
    monkeypatch.delenv("SDTPU_WATCHER", raising=False)
    asyncio.run(_watch_and_drop(tmp_path, poll=False))


# Synthetic inotify batches, each (directory relative to the root, mask,
# name), and the directories they dirty. The test makes "sub/deep",
# "made" and "sub/moved" first; an overflow dirties every watched one.
W = watcher
EVENTS = {
    "file_created": ([("", W.IN_CREATE, "a.txt")], {""}),
    "file_written_below": ([("sub", W.IN_CLOSE_WRITE, "x")], {"sub"}),
    "directory_made": ([("", W.IN_CREATE | W.IN_ISDIR, "made")], {"", "made"}),
    "directory_moved_in": ([("sub", W.IN_MOVED_TO | W.IN_ISDIR, "moved")], {"sub", "sub/moved"}),
    "directory_removed": ([("", W.IN_DELETE | W.IN_ISDIR, "sub")], {""}),
    "watched_directory_gone": ([("sub/deep", W.IN_DELETE_SELF, "")], {"sub"}),
    "root_gone": ([("", W.IN_DELETE_SELF, "")], {""}),
    "rename_across": ([("", W.IN_MOVED_FROM, "a"), ("sub", W.IN_MOVED_TO, "a")], {"", "sub"}),
    "queue_overflow": ([(None, W.IN_Q_OVERFLOW, "")],
                       {"", "made", "sub", "sub/deep", "sub/moved"}),
    "ignored_then_stale": ([("sub/deep", W.IN_IGNORED, ""), ("sub/deep", W.IN_CREATE, "y")],
                           set()),
}


def _dirtied(watcher_cls, root, batch) -> set:
    """The directories `watcher_cls` (either package's LocationWatcher)
    reports for one batch of synthetic events, read without the debounce."""
    got = set()

    async def main():
        w = watcher_cls(1, str(root), got.add)
        try:
            wd_of = dict(w._path_to_wd)
            events = []
            for rel, mask, name in batch:
                path = os.path.join(str(root), rel) if rel else str(root)
                events.append((wd_of.get(os.path.normpath(path), -1), mask, 0, name))
            w._ino.read_events = lambda: events
            w._on_readable()
            if w._flush_handle is not None:
                w._flush_handle.cancel()
                w._flush()
        finally:
            w.close()

    asyncio.run(main())
    return got


@pytest.mark.skipif(not watcher.inotify_available(), reason="inotify is not available here")
@pytest.mark.parametrize("case", sorted(EVENTS))
def test_inotify_events_dirty_what_the_jax_watcher_dirties(tmp_path, case):
    from spacedrive_tpu.locations import watcher as jax_watcher

    root = tmp_path / "watched"
    (root / "sub" / "deep").mkdir(parents=True)
    (root / "made").mkdir()
    (root / "sub" / "moved").mkdir()
    batch, want = EVENTS[case]
    assert _dirtied(watcher.LocationWatcher, root, batch) == want
    assert _dirtied(jax_watcher.LocationWatcher, root, batch) == want


def test_supervised_tasks_are_held_and_reaped():
    from spacedrive_tpu_torch import tasks

    async def main():
        started = asyncio.Event()

        async def forever():
            started.set()
            await asyncio.sleep(3600)

        a = tasks.spawn("a", forever(), owner="t/x")
        b = tasks.spawn("b", forever(), owner="t/x/y")
        c = tasks.spawn("c", forever(), owner="t-other")
        done = tasks.spawn("d", asyncio.sleep(0), owner="t/x")
        await started.wait()
        await done
        await asyncio.sleep(0)
        assert set(tasks.live("t")) == {a, b} and a.get_name() == "sdtpu:t/x/a"
        assert await tasks.reap("t") == 2
        assert a.cancelled() and b.cancelled() and not c.done()
        assert tasks.live("t") == [] and tasks.live("t-other") == [c]
        await tasks.cancel_and_gather(c, None)
        assert c.cancelled() and tasks.live("t-other") == []

    asyncio.run(main())
    coro = asyncio.sleep(0)
    with pytest.raises(RuntimeError):
        tasks.spawn("no-loop", coro)
    assert coro.cr_frame is None  # closed, never awaited
