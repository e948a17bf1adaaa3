"""The port's sync receive half against the JAX package's, on copies of
one library file.

Seeded op streams from three remote instances (shared creates, updates,
multi-updates and deletes; relation creates, updates and deletes; ops
delivered out of order, with conflicting HLC stamps from two writers of
one record, relation ops whose rows arrive later, ops of a model neither
schema knows) go through ``receive_crdt_operations`` of both managers,
page by page; blob pages through ``receive_blob_pages`` (the batched fast
path and its per-op fallback) and ``pump_clone_stream``. Every table of
the two files must then be identical row for row (op logs, quarantine and
parked relation ops included), and so must ``get_ops`` and
``iter_clone_stream``, page for page."""

import asyncio
import shutil

import numpy as np
import pytest

from spacedrive_tpu.store import db as jax_db
from spacedrive_tpu.sync import crdt as jax_crdt
from spacedrive_tpu.sync import ingest as jax_ingest
from spacedrive_tpu.sync import manager as jax_manager
from spacedrive_tpu_torch.store import db as port_db
from spacedrive_tpu_torch.sync import crdt as port_crdt
from spacedrive_tpu_torch.sync import ingest as port_ingest
from spacedrive_tpu_torch.sync import manager as port_manager

ME = bytes(range(16))
PEERS = [bytes([0xA0 + k]) * 16 for k in range(3)]
T0 = 1_750_000_000 << 32


def _fresh(path) -> None:
    db = jax_db.Database(str(path))
    for pub in [ME] + PEERS[:2]:
        db.insert("instance", {"pub_id": pub, "identity": b"", "node_id": b"",
                               "node_name": "t", "node_platform": 0,
                               "last_seen": 0, "date_created": 0})
    db.close()


def _pair(tmp_path, name="lib"):
    """The same library file, opened by each package's manager."""
    src = tmp_path / f"{name}.db"
    _fresh(src)
    dst = tmp_path / f"{name}-port.db"
    shutil.copy(src, dst)
    jm = jax_manager.SyncManager(jax_db.Database(str(src)), ME)
    pm = port_manager.SyncManager(port_db.Database(str(dst)), ME)
    for m in (jm, pm):  # the third peer is met through relayed ops
        m.register_instance(PEERS[1], last_seen=0, date_created=0)
    return jm, pm


def _dump(db) -> dict:
    out = {}
    tables = [r["name"] for r in db.query(
        "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name")]
    for table in tables:
        rows = db.query(f"SELECT * FROM {table} ORDER BY rowid")
        out[table] = [tuple(r) for r in rows]
    return out


def _without_times(dump: dict) -> dict:
    """A relayed instance's placeholder row is stamped with the wall clock."""
    out = dict(dump)
    out["instance"] = [r[:6] for r in dump["instance"]]
    return out


def _stream(seed: int, n_tags=12, n_objects=10, n_paths=8):
    """Wire-form ops from three peers; returned shuffled in pages."""
    rng = np.random.default_rng(seed)
    ops = []
    clock = [T0 + seed * 10_000]

    def op(peer, payload, ts=None):
        clock[0] += int(rng.integers(1, 50))
        ops.append({"instance": PEERS[peer], "timestamp": clock[0] if ts is None else ts,
                    "id": rng.integers(0, 256, 16, np.uint8).tobytes(), **payload})

    def shared(model, rid, field=None, value=None, delete=False, values=None, update=False):
        d = {"model": model, "record_id": rid, "field": field, "value": value,
             "delete": delete, "values": values}
        if update:
            d["update"] = True
        return {"shared": d}

    def relation(rel, item, group, field=None, value=None, delete=False, values=None):
        return {"relation": {"relation": rel, "item_id": item, "group_id": group,
                             "field": field, "value": value, "delete": delete,
                             "values": values}}

    tags = [bytes([1, i]) * 8 for i in range(n_tags)]
    objs = [bytes([2, i]) * 8 for i in range(n_objects)]
    paths = [bytes([3, i]) * 8 for i in range(n_paths)]
    for i, t in enumerate(tags):
        op(i % 3, shared("tag", t, values={"name": f"tag{i}", "color": "#00f"}))
    for i, o in enumerate(objs):
        op(i % 2, shared("object", o, values={"kind": i % 5, "date_created": i}))
    for i, p in enumerate(paths):
        op(0, shared("file_path", p, values={
            "name": f"p{i}", "extension": "bin", "materialized_path": "/",
            "is_dir": 0, "object_id": objs[i % n_objects]}))
    # relation ops, some before their rows (parked), some after
    early = bytes([2, 200]) * 8
    op(1, relation("tag_on_object", early, tags[0], values={"date_created": 5}))
    for i in range(6):
        op(i % 3, relation("tag_on_object", objs[i], tags[i], values={"date_created": i}))
    op(2, shared("object", early, values={"kind": 3}))
    # conflicting writers of one record, stamps interleaved
    for i in range(8):
        op(i % 2, shared("tag", tags[1], field="name", value=f"w{i}"),
           ts=T0 + seed * 10_000 + 5_000 + (7 - i) * 3)
    # multi-updates, single updates covering part of them, older ones
    for i in range(5):
        op(0, shared("object", objs[i], values={"kind": 9, "note": f"m{i}"}, update=True))
        op(1, shared("object", objs[i], field="note", value=f"single{i}"),
           ts=T0 + seed * 10_000 + 1 + i)  # older than everything: stale
    op(2, shared("file_path", paths[0], values={"cas_id": "aa" * 8, "object_id": objs[9]},
                 update=True))
    # relation update and delete, a revival after the delete
    op(0, relation("tag_on_object", objs[0], tags[0], field="date_created", value=77))
    op(1, relation("tag_on_object", objs[1], tags[1], delete=True))
    op(2, relation("tag_on_object", objs[1], tags[1], values={"date_created": 99}))
    # shared deletes (remove-wins over a later update), a delete of an
    # object with a membership row
    op(0, shared("tag", tags[5], delete=True))
    op(1, shared("tag", tags[5], field="color", value="#fff"))
    op(2, shared("object", objs[2], delete=True))
    # ops this schema can never apply: quarantined
    op(0, shared("no_such_model", b"q" * 16, values={"x": 1}))
    op(1, relation("no_such_relation", objs[3], tags[3]))
    # a relation op on a deleted record: dead, dropped
    op(2, relation("tag_on_object", objs[2], tags[2], values={"date_created": 1}))
    order = rng.permutation(len(ops))
    shuffled = [ops[i] for i in order]
    pages = []
    k = 0
    while k < len(shuffled):
        step = int(rng.integers(1, 9))
        pages.append(shuffled[k:k + step])
        k += step
    return pages


def _feed(jm, pm, pages):
    results = []
    for page in pages:
        a = jm.receive_crdt_operations([jax_crdt.CRDTOperation.from_wire(w) for w in page])
        b = pm.receive_crdt_operations([port_crdt.CRDTOperation.from_wire(w) for w in page])
        results.append((a[0], len(a[1]), b[0], len(b[1])))
    return results


def _wire(ops) -> list:
    return [op.to_wire() for op in ops]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_streams_give_identical_libraries(tmp_path, seed):
    jm, pm = _pair(tmp_path)
    pages = _stream(seed)
    results = _feed(jm, pm, pages)
    assert [r[:2] for r in results] == [r[2:] for r in results]
    # every page redelivered: the same verdicts (stale, or a parked
    # relation op applied now that its rows exist)
    again = _feed(jm, pm, pages)
    assert [r[:2] for r in again] == [r[2:] for r in again]
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))
    assert jm.timestamps == pm.timestamps
    dump = _dump(pm.db)
    assert dump["quarantined_op"], "the unknown models were quarantined"
    assert len(dump["shared_operation"]) >= 30 and dump["relation_operation"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("count", [1, 7, 1000])
def test_get_ops_and_clone_stream_page_alike(tmp_path, seed, count):
    jm, pm = _pair(tmp_path)
    _feed(jm, pm, _stream(seed))
    for clocks in ([], [(PEERS[0], T0)], [(p, T0 + seed * 10_000 + 300) for p in PEERS],
                   [(ME, 0), (PEERS[2], 1 << 62)]):
        got_j = jm.get_ops(jax_manager.GetOpsArgs(clocks=clocks, count=count))
        got_p = pm.get_ops(port_manager.GetOpsArgs(clocks=clocks, count=count))
        assert _wire(got_p) == _wire(got_j)
        assert [op.pack() for op in got_p] == [op.pack() for op in got_j]
    stream = lambda m: [(k, _wire(v) if k == "ops" else v)  # noqa: E731
                        for k, v in m.iter_clone_stream([], ops_page=count)]
    assert stream(pm) == stream(jm)


def _origin(tmp_path, n=300):
    """A solo JAX library with blob pages (creates, FK links, multi-updates)
    and row ops between them."""
    db = jax_db.Database(str(tmp_path / "origin.db"))
    pub = bytes([0xEE]) * 16
    db.insert("instance", {"pub_id": pub, "identity": b"", "node_id": b"",
                           "node_name": "o", "node_platform": 0,
                           "last_seen": 0, "date_created": 0})
    a = jax_manager.SyncManager(db, pub)
    opubs = [bytes([5, i % 256, i // 256]) + bytes(13) for i in range(n)]
    fpubs = [bytes([6, i % 256, i // 256]) + bytes(13) for i in range(n)]
    with a.db.tx() as conn:
        a.bulk_shared_ops(conn, "object", [(p, "c", None, None, {"kind": 5, "date_created": i})
                                           for i, p in enumerate(opubs)])
    t = bytes([7]) * 16
    with a.write_ops(a.shared_create("tag", t, {"name": "mid"})) as c:
        a.db.insert("tag", {"pub_id": t, "name": "mid"}, conn=c)
    with a.db.tx() as conn:
        a.bulk_shared_ops(conn, "file_path", [
            (fp, "c", None, None, {"name": f"f{i}", "materialized_path": "/", "is_dir": 0,
                                   "object_id": op})
            for i, (fp, op) in enumerate(zip(fpubs, opubs))])
    with a.db.tx() as conn:
        a.bulk_shared_ops(conn, "object", [(p, "u:kind+note", None, None,
                                            {"kind": 6, "note": "v2"}) for p in opubs])
    return a


def _receivers(tmp_path, origin, name):
    jm, pm = _pair(tmp_path, name)
    for m in (jm, pm):
        m.register_instance(origin.instance, last_seen=0, date_created=0)
    return jm, pm


@pytest.mark.parametrize("diverged", [False, True], ids=["fast", "fallback"])
def test_blob_pages_apply_alike(tmp_path, diverged):
    origin = _origin(tmp_path)
    jm, pm = _receivers(tmp_path, origin, "recv")
    if diverged:  # a local write newer than every page: the per-op path
        for m, crdt in ((jm, jax_crdt), (pm, port_crdt)):
            m.clock.update_with_timestamp(origin.clock.last + 10)
            op = crdt.CRDTOperation(ME, origin.clock.last + 10, b"L" * 16,
                                    crdt.SharedOp("tag", b"T" * 16, values={"name": "local"}))
            with m.write_ops([op]) as c:
                c.execute("INSERT INTO tag (pub_id, name) VALUES (?, ?)", (b"T" * 16, "local"))
    items = list(origin.iter_clone_stream([]))
    assert sum(k == "page" for k, _ in items) == 3
    for kind, item in items:
        if kind == "ops":
            a = jm.receive_crdt_operations(item)
            b = pm.receive_crdt_operations([port_crdt.CRDTOperation.from_wire(o.to_wire())
                                            for o in item])
            assert a[0] == b[0] and not a[1] and not b[1]
        else:
            a = jm.receive_blob_pages([item])
            b = pm.receive_blob_pages([dict(item)])
            assert (a[0], a[2]) == (b[0], b[2]) and not a[1] and not b[1]
            assert b[2] == (0 if diverged else 1)
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))
    # redelivered pages: stale everywhere, nothing logged twice
    page = [v for k, v in items if k == "page"][0]
    assert jm.receive_blob_pages([page])[0] == pm.receive_blob_pages([page])[0] == 0
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))


def test_pump_clone_stream_acks_alike(tmp_path):
    origin = _origin(tmp_path, n=260)
    jm, pm = _receivers(tmp_path, origin, "pump")
    frames = [{"kind": "clone_ops", "ops": _wire(v)} if k == "ops"
              else {"kind": "blob_page", **v} for k, v in origin.iter_clone_stream([])]
    frames.append({"kind": "blob_done"})

    async def run(module, mgr):
        inbox: asyncio.Queue = asyncio.Queue()
        for f in frames:
            inbox.put_nowait(f)
        acks, errors = [], []

        async def send(msg):
            acks.append(msg)

        out = await module.pump_clone_stream(mgr, inbox.get, send, errors)
        return out, acks, errors

    got_j = asyncio.run(run(jax_ingest, jm))
    got_p = asyncio.run(run(port_ingest, pm))
    assert got_p == got_j and not got_p[2]
    assert got_p[0][1] == 3  # three fast pages
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))


def test_quarantined_ops_drain_alike_after_the_model_appears(tmp_path):
    jm, pm = _pair(tmp_path)
    op = {"instance": PEERS[0], "timestamp": T0 + 5, "id": b"q" * 16,
          "shared": {"model": "tag2", "record_id": b"r" * 16, "field": None,
                     "value": None, "delete": False, "values": {"name": "later"}}}
    a = jm.receive_crdt_operations([jax_crdt.CRDTOperation.from_wire(op)])
    b = pm.receive_crdt_operations([port_crdt.CRDTOperation.from_wire(op)])
    assert a[0] == b[0] == 0 and len(a[1]) == len(b[1]) == 1
    assert "quarantined" in b[1][0]
    assert pm.timestamps[PEERS[0]] == jm.timestamps[PEERS[0]] == T0 + 5
    # still unknown: the drain leaves it
    assert pm.drain_quarantined_ops() == jm.drain_quarantined_ops() == 0
    # as after a schema upgrade that knows the model: the drain applies it
    op["shared"]["model"] = "tag"
    q = port_crdt.CRDTOperation.from_wire(op)
    for m in (jm, pm):
        m.db.run_tx("sync.quarantine.delete", (1,))
        with m.db.write_tx() as conn:
            m.db.run("sync.quarantine.insert", (q.id, q.timestamp, q.pack()), conn=conn)
    assert pm.drain_quarantined_ops() == jm.drain_quarantined_ops() == 1
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))


def test_cascade_local_fks_clears_references_alike(tmp_path):
    jm, pm = _pair(tmp_path)
    pages = _stream(9)
    _feed(jm, pm, pages)
    for m, mod in ((jm, jax_manager), (pm, port_manager)):
        oid = m.db.query_one("SELECT id FROM object ORDER BY id LIMIT 1")["id"]
        with m.db.write_tx() as conn:
            mod.cascade_local_fks(conn, "object", oid)
            conn.execute("DELETE FROM object WHERE id = ?", (oid,))
    assert _without_times(_dump(jm.db)) == _without_times(_dump(pm.db))
