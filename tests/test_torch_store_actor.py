"""The port's group-commit write actor (``store/actor.py`` and
``Database.write_tx``), on the CPU.

The cases of ``tests/test_store_actor.py`` on the port's ``Database``:
concurrent writers coalesce into at most ``ceil(N / group_max)``
transactions, a lone writer commits at once, a failed batch rolls back
only its own savepoint while its group commits, tickets still queued at
shutdown fail exactly once, a nested ``write_tx`` rides the outer batch,
reads inside a batch see its writes, and ``SDTPU_STORE_ACTOR=off`` runs one
transaction per batch with no writer thread; four threads writing at once
do not deadlock. Then a scan chain with the actor on and with it off, and
one beside three other writers, gives the library snapshot of the JAX
package's straight run (``_snapshot`` of ``tests/test_torch_scan.py``).
"""

import asyncio
import math
import threading
import time

import pytest
import torch

from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.store import Database, uuid_bytes
from spacedrive_tpu_torch.store.actor import WriteActorClosed
from test_torch_scan import _corpus, _snapshot

DEADLINE_S = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def db(tmp_path):
    d = Database(tmp_path / "actor.db")
    yield d
    d.close()


def _objects(db) -> int:
    return db.query_one("SELECT COUNT(*) AS c FROM object")["c"]


def test_concurrent_writers_coalesce_into_fat_groups(db, monkeypatch):
    """16 concurrent writers behind one held-open closure land in
    ceil(17 / 8) = 3 groups carrying all 17 batches."""
    monkeypatch.setenv("SDTPU_STORE_GROUP_MAX", "8")
    n = 16
    queued = threading.Event()

    def blocker(conn):
        # Holds the first group open until every writer has queued, so
        # the groups form by design rather than by timing.
        queued.wait(DEADLINE_S)
        return "held"

    fut = db.submit_write(blocker)
    g0, b0 = db._actor.groups, db._actor.batches
    errs = []

    def write():
        try:
            db.insert("object", {"pub_id": uuid_bytes()})
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=write) for _ in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + DEADLINE_S
    while len(db._actor._q) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(db._actor._q) == n, "the writers did not all queue"
    queued.set()
    for t in threads:
        t.join(DEADLINE_S)
    assert fut.result(DEADLINE_S) == "held"
    assert not errs
    assert db._actor.groups - g0 == math.ceil((n + 1) / 8)  # 8 + 8 + 1
    assert db._actor.batches - b0 == n + 1
    assert _objects(db) == n


def test_lone_writer_commits_at_once(db, monkeypatch):
    """A group of one never waits for stragglers, however long the bound."""
    monkeypatch.setenv("SDTPU_STORE_GROUP_LATENCY_S", "5")
    t0 = time.perf_counter()
    for _ in range(5):
        db.insert("object", {"pub_id": uuid_bytes()})
    assert time.perf_counter() - t0 < 2.0
    assert _objects(db) == 5
    assert db._actor.groups == db._actor.batches == 5


def test_failed_batch_isolated_inside_group(db):
    started, release = threading.Event(), threading.Event()

    def blocker(conn):
        db.insert("tag", {"pub_id": uuid_bytes(), "name": "held"}, conn=conn)
        started.set()
        release.wait(DEADLINE_S)

    def boom(conn):
        db.insert("tag", {"pub_id": uuid_bytes(), "name": "dead"}, conn=conn)
        raise ValueError("batch body failed")

    f_block = db.submit_write(blocker)
    assert started.wait(DEADLINE_S)
    f_bad = db.submit_write(boom)
    f_good = db.submit_write(lambda conn: db.insert(
        "tag", {"pub_id": uuid_bytes(), "name": "alive"}, conn=conn))
    # A write_tx body that raises on its own thread rolls back alone too.
    slot_errs = []

    def slot():
        try:
            with db.write_tx() as conn:
                db.insert("tag", {"pub_id": uuid_bytes(), "name": "slot-dead"}, conn=conn)
                raise KeyError("slot body failed")
        except KeyError as e:
            slot_errs.append(e)

    th = threading.Thread(target=slot)
    th.start()
    deadline = time.monotonic() + DEADLINE_S
    while len(db._actor._q) < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    release.set()
    th.join(DEADLINE_S)
    with pytest.raises(ValueError):
        f_bad.result(DEADLINE_S)
    f_good.result(DEADLINE_S)
    f_block.result(DEADLINE_S)
    assert len(slot_errs) == 1
    assert {r["name"] for r in db.query("SELECT name FROM tag")} == {"held", "alive"}
    assert db._actor.groups == 1  # one group carried all four tickets


def test_shutdown_mid_queue_fails_futures_exactly_once(tmp_path):
    db = Database(tmp_path / "shutdown.db")
    started, release = threading.Event(), threading.Event()

    def blocker(conn):
        started.set()
        release.wait(DEADLINE_S)
        return "committed"

    f0 = db.submit_write(blocker)
    assert started.wait(DEADLINE_S)
    queued = [db.submit_write(lambda conn: "never") for _ in range(3)]
    settled = []
    for f in queued:
        f.add_done_callback(settled.append)
    closer = threading.Thread(target=db.close)
    closer.start()
    time.sleep(0.05)  # close() reaches the join of the actor's thread
    release.set()
    closer.join(DEADLINE_S)
    assert not closer.is_alive()
    assert f0.result(DEADLINE_S) == "committed"
    for f in queued:
        with pytest.raises(WriteActorClosed):
            f.result(DEADLINE_S)
    assert len(settled) == 3
    with pytest.raises(WriteActorClosed):
        with db.write_tx():
            pass  # pragma: no cover


def test_nested_write_tx_rides_outer_batch(db):
    with db.write_tx() as outer:
        db.insert("object", {"pub_id": uuid_bytes()}, conn=outer)
        with db.write_tx() as inner:
            assert inner is outer
            db.insert("object", {"pub_id": uuid_bytes()}, conn=inner)
        with pytest.raises(RuntimeError):
            with db.write_tx() as inner:
                db.insert("object", {"pub_id": uuid_bytes()}, conn=inner)
                raise RuntimeError("inner abort")
    assert _objects(db) == 2
    assert db._actor.groups == 1
    # Inside an open raw tx() on this thread, write_tx rides it too.
    with db.tx() as conn:
        with db.write_tx() as inner:
            assert inner is conn
            db.insert("object", {"pub_id": uuid_bytes()}, conn=inner)
    assert _objects(db) == 3 and db._actor.groups == 1


def test_reads_see_their_own_writes(db):
    for _ in range(4):
        db.insert("object", {"pub_id": uuid_bytes()})
    counts, errs = [], []

    def read():
        try:
            counts.extend(_objects(db) for _ in range(10))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=read) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert not errs and set(counts) == {4}
    with db.write_tx() as conn:
        db.insert("object", {"pub_id": uuid_bytes()}, conn=conn)
        assert conn is not db._conn()  # the actor's connection
        assert _objects(db) == 5


def test_actor_kill_switch_degrades_to_raw_tx(tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_STORE_ACTOR", "off")
    db = Database(tmp_path / "off.db")
    try:
        with db.write_tx() as conn:
            assert conn is db._conn()
            db.insert("object", {"pub_id": uuid_bytes()}, conn=conn)
        fut = db.submit_write(lambda conn: db.insert(
            "object", {"pub_id": uuid_bytes()}, conn=conn))
        assert fut.done()
        fut.result(0)
        assert db._actor._thread is None and db._actor.groups == 0
        assert _objects(db) == 2
    finally:
        db.close()


def test_four_concurrent_writers_do_not_deadlock(db):
    """Four threads each commit 25 batches, reading inside every one."""
    loc = db.insert("location", {"pub_id": uuid_bytes(), "path": "/x"})
    errs = []

    def writer(k):
        try:
            for i in range(25):
                with db.write_tx() as conn:
                    db.insert("file_path", {"pub_id": uuid_bytes(), "location_id": loc,
                                            "materialized_path": "/", "name": f"w{k}-{i}"},
                              conn=conn)
                    assert db.query_one("SELECT COUNT(*) AS c FROM file_path WHERE name = ?",
                                        (f"w{k}-{i}",))["c"] == 1
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert not any(t.is_alive() for t in threads) and not errs
    assert db.query_one("SELECT COUNT(*) AS c FROM file_path")["c"] == 100
    assert db._actor.batches == 101


def _scan(libraries, manager, create, scan, data_dir, root, backend):
    lib = libraries(data_dir).create("actor")
    loc = create(lib, root)

    async def main():
        jobs = manager()
        await scan(jobs, lib, loc, backend=backend, with_media=False)
        await asyncio.wait_for(jobs.wait_idle(), 30)

    asyncio.run(main())
    return lib


def test_scan_chain_snapshot_is_the_same_with_the_actor_on_and_off(tmp_path, monkeypatch):
    root = str(tmp_path / "corpus")
    _corpus(root)
    jax = _scan(JaxLibraries, JaxJobManager, jax_locations.create_location,
                jax_locations.scan_location, str(tmp_path / "jax"), root, "numpy")
    on = _scan(Libraries, JobManager, locations.create_location, locations.scan_location,
               str(tmp_path / "on"), root, "plain")
    monkeypatch.setenv("SDTPU_STORE_ACTOR", "off")
    off = _scan(Libraries, JobManager, locations.create_location, locations.scan_location,
                str(tmp_path / "off"), root, "plain")
    try:
        want = _snapshot(jax.db)
        assert _snapshot(on.db) == want
        assert _snapshot(off.db) == want
        assert on.db._actor.groups > 0 and off.db._actor.groups == 0
        assert off.db._actor._thread is None
    finally:
        for lib in (jax, on, off):
            lib.db.close()


def test_a_scan_beside_three_writers_matches_the_jax_package(tmp_path):
    """Three threads commit batches (each reading its own write) while the
    scan chain's jobs commit theirs: nothing deadlocks, every batch lands,
    and the scan's library is the JAX package's straight run."""
    root = str(tmp_path / "corpus")
    _corpus(root)
    jax = _scan(JaxLibraries, JaxJobManager, jax_locations.create_location,
                jax_locations.scan_location, str(tmp_path / "jax"), root, "numpy")
    lib = Libraries(str(tmp_path / "port")).create("busy")
    loc = locations.create_location(lib, root)
    stop, errs, written = threading.Event(), [], [0, 0, 0]

    def writer(k):
        try:
            while not stop.is_set():
                name = f"w{k}-{written[k]}"
                with lib.db.write_tx() as conn:
                    lib.db.insert("tag", {"pub_id": uuid_bytes(), "name": name}, conn=conn)
                    assert lib.db.query_one("SELECT COUNT(*) AS c FROM tag WHERE name = ?",
                                            (name,))["c"] == 1
                written[k] += 1
                time.sleep(0.001)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    async def main():
        jobs = JobManager()
        await locations.scan_location(jobs, lib, loc, backend="plain", with_media=False)
        await asyncio.wait_for(jobs.wait_idle(), 30)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        asyncio.run(main())
    finally:
        stop.set()
        for t in threads:
            t.join(DEADLINE_S)
    try:
        assert not errs and not any(t.is_alive() for t in threads)
        assert min(written) > 0
        assert lib.db.query_one("SELECT COUNT(*) AS c FROM tag")["c"] == sum(written)
        assert _snapshot(lib.db) == _snapshot(jax.db)
    finally:
        lib.db.close()
        jax.db.close()


FLAG_VALUES = {
    "SDTPU_STORE_ACTOR": ["", "off", "0", "false", "OFF", "on", "1", "yes"],
    "SDTPU_STORE_GROUP_MAX": ["", "8", "1", "64"],
    "SDTPU_STORE_GROUP_LATENCY_S": ["", "0", "0.25", "not-a-number"],
    "SDTPU_WATCHER": ["", "poll", " POLL ", "inotify"],
}


@pytest.mark.parametrize("name", sorted(FLAG_VALUES))
def test_port_flags_read_as_the_jax_packages(name, monkeypatch):
    from spacedrive_tpu import flags as jax_flags
    from spacedrive_tpu_torch import flags

    assert flags.FLAGS[name].default == jax_flags.FLAGS[name].default
    assert flags.FLAGS[name].strict == jax_flags.FLAGS[name].strict
    for value in FLAG_VALUES[name]:
        monkeypatch.setenv(name, value)
        assert flags.get(name) == jax_flags.get(name), value
    if flags.FLAGS[name].strict:
        monkeypatch.setenv(name, "many")
        with pytest.raises(ValueError):
            flags.get(name)
        with pytest.raises(ValueError):
            jax_flags.get(name)
    with pytest.raises(KeyError):
        flags.get("SDTPU_NOT_A_PORT_FLAG")
