"""The port's sync write path and job records against the JAX package's,
byte for byte, with clocks and id sources pinned on both sides.

- ``opblob``: the uniform blob encoder and the bulk payload fragments.
- ``SyncManager.bulk_shared_ops`` and ``write_ops``: the same op rows and
  blob pages, on a solo library and after a peer registers.
- ``uuid4_bytes_batch``: the same v7 layout from the same clock and bytes.
- Job state, job report rows, job hashes and indexer rule blobs.
"""

import itertools
import os
import time

import pytest

from spacedrive_tpu.jobs import job as jax_job
from spacedrive_tpu.jobs import report as jax_report
from spacedrive_tpu.locations import rules as jax_rules
from spacedrive_tpu.store import db as jax_db
from spacedrive_tpu.sync import crdt as jax_crdt
from spacedrive_tpu.sync import manager as jax_manager
from spacedrive_tpu.sync import opblob as jax_opblob
from spacedrive_tpu_torch.jobs import job as port_job
from spacedrive_tpu_torch.jobs import report as port_report
from spacedrive_tpu_torch.locations import rules as port_rules
from spacedrive_tpu_torch.store import db as port_db
from spacedrive_tpu_torch.sync import crdt as port_crdt
from spacedrive_tpu_torch.sync import manager as port_manager
from spacedrive_tpu_torch.sync import opblob as port_opblob

INSTANCE = bytes(range(16))
PEER = bytes(range(16, 32))


def _pub(i: int) -> bytes:
    return i.to_bytes(16, "big")


def _values(i: int) -> dict:
    return {"cas_id": f"{i:016x}", "object_id": _pub(10_000 + i),
            "kind": i % 26, "date_created": 1_700_000_000 + i, "size": i * 1.5}


def test_uniform_blob_and_bulk_payload_are_byte_equal():
    n = 300
    stamps = [(1_700_000_000 << 32) + 7 * i for i in range(n)]
    rids = [_pub(i) for i in range(n)]
    op_ids = [_pub(50_000 + i) for i in range(n)]
    packed = [port_crdt.pack_value(_values(i)) for i in range(n)]
    assert packed == [jax_crdt.pack_value(_values(i)) for i in range(n)]
    for kind in ("c", "u:cas_id+object_id"):
        blob = port_opblob.encode_uniform_py(stamps, rids, kind, op_ids, packed)
        assert blob == jax_opblob.encode_uniform_py(stamps, rids, kind, op_ids, packed)
        assert port_opblob.decode_entries_py(blob) == jax_opblob.decode_entries_py(blob)
        payload = port_opblob.pack_bulk_payload(kind, op_ids[0], packed[0])
        assert payload == jax_opblob.pack_bulk_payload(kind, op_ids[0], packed[0])
        assert payload == port_crdt.pack_value(port_crdt.op_payload(
            None, None, False, op_ids[0], _values(0), kind.startswith("u:")))


def test_uuid_batches_share_the_jax_layout(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_123_456_789_000)
    for n in (5, 100):
        monkeypatch.setattr(os, "urandom", lambda k: bytes(i % 251 for i in range(k)))
        monkeypatch.setattr(jax_crdt, "_uuid_state", [0, 0])
        monkeypatch.setattr(port_crdt, "_uuid_state", [0, 0])
        first = port_crdt.uuid4_bytes_batch(n)
        assert first == jax_crdt.uuid4_bytes_batch(n)
        # the counter continues within the millisecond: ordered, distinct
        second = port_crdt.uuid4_bytes_batch(n)
        assert second == jax_crdt.uuid4_bytes_batch(n)
        ids = first + second
        assert ids == sorted(ids) and len(set(ids)) == 2 * n
        assert all(b[6] >> 4 == 7 and b[8] >> 6 == 2 for b in ids)


@pytest.fixture
def both(tmp_path, monkeypatch):
    """(JAX, port) sync managers over fresh libraries with one instance row
    each, HLC stamps and op ids pinned to the same sequences."""
    pairs = []
    for name, dbm, mm, cm in (("jax", jax_db, jax_manager, jax_crdt),
                              ("port", port_db, port_manager, port_crdt)):
        db = dbm.Database(tmp_path / f"{name}.db")
        db.insert("instance", {"pub_id": INSTANCE, "identity": b"", "node_id": b"",
                               "node_name": "n", "node_platform": 0,
                               "last_seen": 0, "date_created": 0})
        sync = mm.SyncManager(db, INSTANCE)
        ts = itertools.count(1_700_000_000 << 32, 3)
        sync.clock.new_timestamps = lambda n, ts=ts: [next(ts) for _ in range(n)]
        sync.clock.new_timestamp = lambda ts=ts: next(ts)
        ids = itertools.count(1 << 100)
        monkeypatch.setattr(mm, "uuid4_bytes_batch",
                            lambda n, ids=ids: [_pub(next(ids)) for _ in range(n)])
        monkeypatch.setattr(cm, "uuid4_bytes", lambda ids=ids: _pub(next(ids)))
        pairs.append((db, sync))
    yield pairs
    for db, _ in pairs:
        db.close()


def _oplog(db):
    rows = [tuple(r) for r in db.query(
        "SELECT timestamp, model, record_id, kind, data, instance_id "
        "FROM shared_operation ORDER BY id")]
    blobs = [tuple(r) for r in db.query(
        "SELECT model, min_ts, max_ts, n_ops, data, instance_id "
        "FROM shared_op_blob ORDER BY id")]
    return rows, blobs


SPEC_SETS = {
    "creates_300": [(_pub(i), "c", None, None, _values(i)) for i in range(300)],
    "links_256": [(_pub(i), "u:cas_id+object_id", None, None,
                   {"cas_id": f"{i:016x}", "object_id": _pub(i + 1)}) for i in range(256)],
    "links_255": [(_pub(i), "u:cas_id+object_id", None, None,
                   {"cas_id": None, "object_id": _pub(i + 1)}) for i in range(255)],
    "field_updates_300": [(_pub(i), "u:integrity_checksum", "integrity_checksum",
                           f"{i:064x}", None) for i in range(300)],
    "deletes_300": [(_pub(i), "d", None, None, None) for i in range(300)],
    "mixed_300": [(_pub(i), "c" if i % 2 else "u:size", None if i % 2 else "size",
                   None if i % 2 else i, _values(i) if i % 2 else None) for i in range(300)],
    "int_record_ids_300": [(i, "c", None, None, {"x": i}) for i in range(300)],
}


@pytest.mark.parametrize("peer", [False, True], ids=["solo", "paired"])
@pytest.mark.parametrize("specs", sorted(SPEC_SETS))
def test_bulk_shared_ops_write_the_same_rows_and_blobs(both, specs, peer):
    out = []
    for db, sync in both:
        if peer:
            sync.register_instance(PEER, node_name="peer")
        with db.write_tx() as conn:
            assert sync.bulk_shared_ops(conn, "file_path", SPEC_SETS[specs]) == \
                len(SPEC_SETS[specs])
        out.append(_oplog(db))
    assert out[0] == out[1]
    rows, blobs = out[1]
    assert (len(blobs) == 1) == (not peer and specs in ("creates_300", "links_256"))


def test_write_ops_and_emission_off_match(both):
    out = []
    for db, sync in both:
        seen = []
        sync.on_created(lambda seen=seen: seen.append(1))
        ops = sync.shared_create("location", _pub(1), {"name": "a", "path": "/a"})
        ops += [sync.shared_update("location", _pub(1), "name", "b"),
                sync.shared_delete("location", _pub(2))]
        with sync.write_ops(ops):
            pass
        sync.emit_messages = False
        with sync.write_ops([sync.shared_update("location", _pub(1), "name", "c")]) as conn:
            assert sync.bulk_shared_ops(conn, "file_path", SPEC_SETS["creates_300"]) == 0
        assert seen == [1]
        out.append(_oplog(db))
    assert out[0] == out[1]
    assert len(out[0][0]) == 3 and out[0][1] == []


def test_job_records_pack_as_the_jax_packages():
    init = {"location_id": 3, "sub_path": None, "backend": "cuda", "device_batch": None}
    data = {"cursor": 17, "phase_s": {"hash": 0.25}, "where": "x = ?", "params": [3]}
    steps = [{"chunk": 0}, {"kind": "save", "scratch": 9}]
    chain = [("file_identifier", init)]
    mine = port_job.JobState(init, data, steps, 2, {"n": 1}, chain)
    theirs = jax_job.JobState(init, data, steps, 2, {"n": 1}, chain)
    assert mine.serialize() == theirs.serialize()
    back = port_job.JobState.deserialize(theirs.serialize())
    assert back.data == data and list(back.steps) == steps and back.next_chain == chain

    class PortJob(port_job.StatefulJob):
        NAME = "file_identifier"

    class JaxJob(jax_job.StatefulJob):
        NAME = "file_identifier"

    shuffled = dict(reversed(list(init.items())))
    assert PortJob(**init).hash() == JaxJob(**shuffled).hash()
    kw = dict(id=_pub(5), name="indexer", errors_text=["a", "b\n\nc"], data=b"s",
              metadata={"indexed_count": 4, "phase_s": {"walk": 1.5}}, task_count=3)
    mine = port_report.JobReport(**kw, status=port_report.JobStatus.COMPLETED)
    theirs = jax_report.JobReport(**kw, status=jax_report.JobStatus.COMPLETED)
    assert mine._row() == theirs._row()
    assert port_report.JobReport.from_row(theirs._row()) == mine


@pytest.mark.parametrize("i", range(len(jax_rules.SYSTEM_RULES)))
def test_system_rule_blobs_match(i):
    mine, theirs = port_rules.SYSTEM_RULES[i](), jax_rules.SYSTEM_RULES[i]()
    assert mine.name == theirs.name
    assert mine.serialize_rules() == theirs.serialize_rules()
    row = {"name": mine.name, "rules_per_kind": theirs.serialize_rules(),
           "default_rule": int(mine.default), "pub_id": b""}
    assert port_rules.IndexerRule.from_row(row).rules[0].params == theirs.rules[0].params
