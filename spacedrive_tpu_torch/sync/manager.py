"""Sync manager: atomic domain + op-log writes, op retrieval, LWW apply.

Port of ``spacedrive_tpu/sync/manager.py`` (upstream
core/crates/sync/src/manager.rs:62-199 and the apply half of the
generated ``ModelSyncData``, crates/sync-generator/src/lib.rs:24-80). The
apply code is generic over the model registry (``store/models.py``):

- ``write_ops`` puts the domain writes and the op-log rows in ONE
  transaction and then broadcasts a created message;
- ``bulk_shared_ops`` is the bulk writers' path, one ``shared_op_blob``
  page per uniform chunk of at least ``BLOB_MIN_OPS`` ops on a solo
  library;
- ``get_ops`` merges both op-log formats (rows and blob pages) after the
  per-instance HLC watermarks, ordered by (timestamp, instance);
  ``iter_clone_stream`` serves stored pages verbatim to a fresh peer;
- ``receive_crdt_operations`` ingests a page of remote ops in one
  transaction, a savepoint per op, last-writer-wins on the HLC
  (``_compare_message``), remove-wins deletes, early relation ops parked
  until their rows arrive, ops of unknown models quarantined;
- ``receive_blob_pages`` applies verbatim pages in one transaction each
  when it can prove the per-op compare a no-op, and per op otherwise.

FK fields sync as the referenced row's pub_id and resolve back to local
row ids on apply. Every row, page and op the port writes or serves is
byte-equal to the JAX package's for the same stamps, ids and values. The
JAX manager's telemetry counters and chaos seams are not ported.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .. import chaos
from ..store import models as M
from ..store.db import Database
from . import opblob
from .crdt import (CRDTOperation, OpKind, RelationOp, SharedOp, op_payload,
                   pack_value, unpack_value, uuid4_bytes_batch)
from .hlc import HLC

# A bulk append at or above this many ops on a SOLO library (no other
# instance registered) lands as ONE shared_op_blob page instead of that
# many shared_operation rows.
BLOB_MIN_OPS = 256

# The WAL size past which the clone's page apply checkpoints between pages.
CLONE_WAL_BUDGET = 64 << 20


@dataclass
class GetOpsArgs:
    """(instance pub_id → NTP64 watermark) + page size (manager.rs:24-28;
    OPS_PER_REQUEST=1000 at p2p/sync/mod.rs:403)."""

    clocks: List[Tuple[bytes, int]]
    count: int = 1000


def cascade_local_fks(conn, model: str, local_id: int) -> None:
    """Clear every FK reference to `model` row `local_id` that the DDL
    does not handle (no declared ON DELETE): nullable columns are set
    NULL, rows with a non-nullable reference are deleted. The sync apply
    path and local deletes (the orphan remover) share it."""
    for rname, rmodel in M.MODELS.items():
        for f in rmodel.fields:
            if _fk_target(f) != model or f.on_delete:
                continue
            if f.nullable:
                conn.execute(f"UPDATE {rname} SET {f.name} = NULL "
                             f"WHERE {f.name} = ?", (local_id,))
            else:
                conn.execute(f"DELETE FROM {rname} WHERE {f.name} = ?",
                             (local_id,))


def _fk_target(f: M.Field) -> Optional[str]:
    """Referenced table of an FK field (e.g. 'location')."""
    if not f.references:
        return None
    return f.references.split("(", 1)[0]


class SyncManager:
    def __init__(self, db: Database, instance_pub_id: bytes,
                 emit_messages: bool = True):
        self.db = db
        self.instance = instance_pub_id
        self.clock = HLC()
        self.emit_messages = emit_messages
        self._on_created: List[Callable[[], None]] = []
        # Instance pub_id → local row id, and → last-seen NTP64: the
        # watermark vector over PAIRED instances (evicting one would
        # re-pull its whole history).
        self._instance_ids: Dict[bytes, int] = {}
        self.timestamps: Dict[bytes, int] = {}
        self._sync_indexes_ready = False
        # Solo = no other instance registered: bulk writers may append
        # page-level op blobs. Flips False for good once a peer appears.
        self._solo = True
        # The clone fast path's proof that per-op compare is a no-op:
        # the highest logged stamp and whether any shared delete is
        # logged. Lazily read from SQL, then kept current in memory.
        self._op_log_high: Optional[int] = None
        self._has_shared_tombstones: Optional[bool] = None
        # Leaf lock over the caches above (job threads, ingest, pairing).
        self._meta_lock = threading.Lock()
        self._load_instances()
        # Re-ingest ops an older schema quarantined (one cheap SELECT
        # when the table is empty).
        self.drain_quarantined_ops()

    def _ensure_sync_indexes(self) -> None:
        """Build the op-log read indexes at first sync use (declared lazy
        so bulk local writers never maintain them)."""
        if self._sync_indexes_ready:
            return
        self.db.ensure_lazy_indexes("shared_operation")
        self.db.ensure_lazy_indexes("relation_operation")
        with self._meta_lock:
            self._sync_indexes_ready = True

    def _load_instances(self) -> None:
        rows = self.db.run("sync.instances.all")
        with self._meta_lock:
            for row in rows:
                self._instance_ids[row["pub_id"]] = row["id"]
                if row["timestamp"]:  # a peer's watermark: stamp after it
                    self.timestamps[row["pub_id"]] = row["timestamp"]
                    self.clock.update_with_timestamp(row["timestamp"])
            self._solo = all(pub == self.instance for pub in self._instance_ids)

    def _instance_row_id(self, pub_id: bytes, conn=None) -> int:
        rid = self._instance_ids.get(pub_id)
        if rid is None:
            row = self.db.run("sync.instances.id_by_pub", (pub_id,), conn=conn)
            if row is None:
                raise KeyError(f"unknown instance {pub_id.hex()}")
            rid = row["id"]
            with self._meta_lock:
                self._instance_ids[pub_id] = rid
        return rid

    def _op_log_state(self) -> Tuple[int, bool]:
        """(highest logged stamp over every op-log format, any shared
        delete logged?). Blob pages never hold deletes."""
        if self._op_log_high is None:
            hi = 0
            for row in (self.db.run("sync.oplog.max_ts_shared"),
                        self.db.run("sync.oplog.max_ts_relation"),
                        self.db.run("sync.oplog.max_ts_blob")):
                if row is not None and row["t"] is not None:
                    hi = max(hi, row["t"])
            with self._meta_lock:
                if self._op_log_high is None:
                    self._op_log_high = hi
        if self._has_shared_tombstones is None:
            probed = self.db.run("sync.oplog.has_tombstones") is not None
            with self._meta_lock:
                if self._has_shared_tombstones is None:
                    self._has_shared_tombstones = probed
        return self._op_log_high, self._has_shared_tombstones

    def _note_ops_logged(self, ts_high: int, any_shared_delete: bool) -> None:
        """Keep the ``_op_log_state`` facts current after an op insert
        (nothing while they are still unread)."""
        with self._meta_lock:
            if self._op_log_high is not None and ts_high > self._op_log_high:
                self._op_log_high = ts_high
            if any_shared_delete and self._has_shared_tombstones is not None:
                self._has_shared_tombstones = True

    def on_created(self, cb: Callable[[], None]) -> None:
        """Subscribe to the created broadcast (one call per committed batch
        of local ops)."""
        self._on_created.append(cb)

    def _notify_created(self) -> None:
        if not self.emit_messages:
            return
        for cb in list(self._on_created):
            cb()

    # -- op factory (crates/sync/src/factory.rs:22-120) --------------------

    def _new_op(self, typ) -> CRDTOperation:
        return CRDTOperation.new(self.instance, self.clock.new_timestamp(), typ)

    def shared_create(self, model: str, record_id: Any,
                      values: Optional[Dict[str, Any]] = None) -> List[CRDTOperation]:
        """Create = ONE "c" op carrying all initial values."""
        return [self._new_op(SharedOp(model, record_id, values=dict(values or {})))]

    def shared_update(self, model: str, record_id: Any, field: str,
                      value: Any) -> CRDTOperation:
        return self._new_op(SharedOp(model, record_id, field=field, value=value))

    def shared_multi_update(self, model: str, record_id: Any,
                            values: Dict[str, Any]) -> CRDTOperation:
        """ONE update op carrying several columns (kind "u:a+b"), applied
        per-field last-writer-wins."""
        return self._new_op(SharedOp(model, record_id, values=dict(values),
                                     update=True))

    def shared_delete(self, model: str, record_id: Any) -> CRDTOperation:
        return self._new_op(SharedOp(model, record_id, delete=True))

    def relation_create(self, relation: str, item_id: Any, group_id: Any,
                        values: Optional[Dict[str, Any]] = None) -> List[CRDTOperation]:
        return [self._new_op(RelationOp(relation, item_id, group_id,
                                        values=dict(values or {})))]

    def relation_update(self, relation: str, item_id: Any, group_id: Any,
                        field: str, value: Any) -> CRDTOperation:
        return self._new_op(RelationOp(relation, item_id, group_id,
                                       field=field, value=value))

    def relation_delete(self, relation: str, item_id: Any,
                        group_id: Any) -> CRDTOperation:
        return self._new_op(RelationOp(relation, item_id, group_id, delete=True))

    # -- write path --------------------------------------------------------

    @contextmanager
    def write_ops(self, ops: Sequence[CRDTOperation]):
        """One atomic transaction for domain writes + op-log rows:

            with sync.write_ops(ops) as conn:
                db.insert_many("file_path", rows, conn=conn)
        """
        with self.db.write_tx() as conn:
            yield conn
            self._insert_op_rows(conn, ops)
        if self.emit_messages and ops:
            self._notify_created()

    def _insert_op_rows(self, conn, ops: Iterable[CRDTOperation]) -> None:
        """Append local ops to the log as rows (nothing when message
        emission is off)."""
        if not self.emit_messages:
            return
        my_id = self._instance_row_id(self.instance, conn)
        shared_rows: List[tuple] = []
        rel_rows: List[tuple] = []
        for op in ops:
            t = op.typ
            data = pack_value(op_payload(t.field, t.value, t.delete, op.id,
                                         t.values, getattr(t, "update", False)))
            if isinstance(t, SharedOp):
                shared_rows.append((op.timestamp, t.model, pack_value(t.record_id),
                                    t.kind, data, my_id))
            else:
                rel_rows.append((op.timestamp, t.relation, pack_value(t.item_id),
                                 pack_value(t.group_id), t.kind, data, my_id))
        if shared_rows:
            self.db.run_many("sync.oplog.insert_shared", shared_rows, conn=conn)
        if rel_rows:
            self.db.run_many("sync.oplog.insert_relation", rel_rows, conn=conn)
        if shared_rows or rel_rows:
            self._note_ops_logged(max(r[0] for r in shared_rows + rel_rows),
                                  any(r[3] == OpKind.DELETE for r in shared_rows))

    def bulk_shared_ops(
        self, conn, model: str,
        specs: Sequence[Tuple[Any, str, Optional[str], Any, Optional[Dict[str, Any]]]],
    ) -> int:
        """Op-log append for bulk writers (identifier, indexer, validator).

        Each spec is (record_id, kind, field, value, values): kind "c"
        carries `values`, "u:<field>" carries field + value, a multi-field
        update ("u:a+b", field None) carries `values`. Writes the same rows
        ``_insert_op_rows`` would for the matching ops, stamps minted in one
        clock batch. Returns the number of ops appended (0 when emission is
        off)."""
        if not self.emit_messages or not specs:
            return 0
        my_id = self._instance_row_id(self.instance, conn)
        stamps = self.clock.new_timestamps(len(specs))
        op_ids = uuid4_bytes_batch(len(specs))

        # A big uniform chunk on a solo library lands as ONE blob page. Only
        # the create / multi-update shapes may: a delete packed as a
        # create-shaped payload would read as delete=False.
        if self._solo and len(specs) >= BLOB_MIN_OPS:
            kind0 = specs[0][1]
            uniform = (kind0 == "c" or kind0.startswith("u:")) and all(
                field is None and kind == kind0
                and type(rid) is bytes and len(rid) == 16
                for rid, kind, field, _v, _vs in specs)
            if uniform:
                blob = opblob.encode_uniform(
                    stamps, [s[0] for s in specs], kind0, op_ids,
                    [pack_value(s[4]) for s in specs])
                self.db.run("sync.blob.insert",
                            (model, stamps[0], stamps[-1], len(specs), blob, my_id),
                            conn=conn)
                self._note_ops_logged(stamps[-1], False)
                return len(specs)

        def _rid(rid) -> bytes:
            # a 16-byte pub_id packs as bin8(16): one concat, same bytes
            if type(rid) is bytes and len(rid) == 16:
                return b"\xc4\x10" + rid
            return pack_value(rid)

        def _data(kind: str, field, value, values, op_id) -> bytes:
            if kind == OpKind.DELETE:
                return pack_value(op_payload(None, None, True, op_id, values))
            if field is None:
                return opblob.pack_bulk_payload(kind, op_id, pack_value(values))
            return pack_value(op_payload(field, value, False, op_id, values))

        rows = [
            (ts, model, _rid(rid), kind, _data(kind, field, value, values, op_id), my_id)
            for (rid, kind, field, value, values), ts, op_id in zip(specs, stamps, op_ids)
        ]
        self.db.run_many("sync.oplog.insert_shared", rows, conn=conn)
        self._note_ops_logged(stamps[-1], any(s[1] == OpKind.DELETE for s in specs))
        return len(rows)

    def _insert_op_row(self, conn, op: CRDTOperation, instance_row_id: int) -> None:
        t = op.typ
        self._note_ops_logged(op.timestamp, isinstance(t, SharedOp) and t.delete)
        data = pack_value(op_payload(t.field, t.value, t.delete, op.id, t.values,
                                     getattr(t, "update", False)))
        if isinstance(t, SharedOp):
            self.db.run("sync.oplog.insert_shared",
                        (op.timestamp, t.model, pack_value(t.record_id), t.kind,
                         data, instance_row_id), conn=conn)
        else:
            self.db.run("sync.oplog.insert_relation",
                        (op.timestamp, t.relation, pack_value(t.item_id),
                         pack_value(t.group_id), t.kind, data, instance_row_id),
                        conn=conn)

    # -- read path (manager.rs:130-199) ------------------------------------

    @staticmethod
    def _watermark_where(clocks: Sequence[Tuple[bytes, int]], ts_col: str
                         ) -> Tuple[str, list]:
        """The per-instance watermark disjunction: ops newer than each
        listed instance's watermark, and every op of instances not listed."""
        conds, params = [], []
        for pub, ts in clocks:
            conds.append(f"(i.pub_id = ? AND {ts_col} > ?)")
            params.extend([pub, ts])
        if clocks:
            conds.append("i.pub_id NOT IN (" + ",".join("?" for _ in clocks) + ")")
            params.extend(pub for pub, _ in clocks)
        return (" OR ".join(conds) if conds else "1=1"), params

    def get_ops(self, args: GetOpsArgs) -> List[CRDTOperation]:
        """Ops newer than the given per-instance watermarks, plus every op
        of instances absent from the list, ordered by (timestamp,
        instance), at most ``args.count``, from both op-log formats."""
        self._ensure_sync_indexes()
        results: List[Tuple[int, bytes, CRDTOperation]] = self._blob_op_tuples(args)
        where, params = self._watermark_where(args.clocks, "o.timestamp")
        for table, is_shared in (("shared_operation", True),
                                 ("relation_operation", False)):
            rows = self.db.query(
                f"SELECT o.*, i.pub_id AS instance_pub_id FROM {table} o "
                f"JOIN instance i ON i.id = o.instance_id "
                f"WHERE {where} ORDER BY o.timestamp ASC LIMIT ?",
                params + [args.count])
            for row in rows:
                results.append((row["timestamp"], row["instance_pub_id"],
                                self._row_to_op(row, is_shared)))
        results.sort(key=lambda t: (t[0], t[1]))
        return [op for _, _, op in results[:args.count]]

    def _blob_op_tuples(self, args: GetOpsArgs
                        ) -> List[Tuple[int, bytes, CRDTOperation]]:
        """(timestamp, instance, op) from the blob pages, after the same
        watermarks. Pages decode lazily in min_ts order and stop once
        ``args.count`` ops are held and the rest lie past the count-th
        smallest stamp."""
        where, params = self._watermark_where(args.clocks, "b.max_ts")
        metas = self.db.query(
            f"SELECT b.id, b.model, b.min_ts, i.pub_id AS pub "
            f"FROM shared_op_blob b JOIN instance i "
            f"ON i.id = b.instance_id WHERE {where} ORDER BY b.min_ts",
            params)
        if not metas:
            return []
        wm = dict(args.clocks)
        out: List[Tuple[int, bytes, CRDTOperation]] = []
        for m in metas:
            if len(out) >= args.count:
                kth = sorted(t for t, _, _ in out)[args.count - 1]
                if m["min_ts"] > kth:
                    break
            row = self.db.run("sync.blob.data_by_id", (m["id"],))
            if row is None:
                # Exploded by a concurrent first ingest: its ops are rows
                # now, served by the row queries.
                continue
            floor = wm.get(m["pub"])
            kth = None
            for ts, rid, kind, payload in opblob.iter_entries(row["data"]):
                if floor is not None and ts <= floor:
                    continue
                if len(out) >= args.count:
                    # entries ascend within a page: nothing later can make it
                    if kth is None:
                        kth = sorted(t for t, _, _ in out)[args.count - 1]
                    if ts > kth:
                        break
                out.append((ts, m["pub"],
                            self._entry_to_op(m["model"], ts, rid, payload, m["pub"])))
        return out

    def _entry_to_op(self, model: str, ts: int, rid_packed: bytes,
                     payload: bytes, pub: bytes) -> CRDTOperation:
        """One blob entry → CRDTOperation (its payload is what the row
        format's ``data`` column would hold)."""
        data = unpack_value(payload)
        typ = SharedOp(model, unpack_value(rid_packed), data.get("field"),
                       data.get("value"), bool(data.get("delete")),
                       data.get("values"), bool(data.get("update")))
        return CRDTOperation(pub, ts, data.get("op_id", b""), typ)

    def _ensure_row_oplog(self) -> None:
        """Explode the blob pages into indexed op rows, which ingest's
        per-record lookups need; 16 pages a transaction, each page's rows
        and its delete atomic."""
        while True:
            metas = self.db.run("sync.blob.metas_batch")
            if not metas:
                return
            with self.db.write_tx() as conn:
                for m in metas:
                    self._explode_blob_conn(conn, m)

    def _explode_blob_conn(self, conn, m) -> None:
        self.db.run_many(
            "sync.oplog.insert_shared",
            [(ts, m["model"], rid, kind, payload, m["instance_id"])
             for ts, rid, kind, payload in opblob.decode_entries(m["data"])],
            conn=conn)
        self.db.run("sync.blob.delete", (m["id"],), conn=conn)

    def _row_to_op(self, row, is_shared: bool) -> CRDTOperation:
        data = unpack_value(row["data"])
        if is_shared:
            typ: Any = SharedOp(
                row["model"], unpack_value(row["record_id"]), data.get("field"),
                data.get("value"), bool(data.get("delete")), data.get("values"),
                bool(data.get("update")))
        else:
            typ = RelationOp(
                row["relation"], unpack_value(row["item_id"]),
                unpack_value(row["group_id"]), data.get("field"),
                data.get("value"), bool(data.get("delete")), data.get("values"))
        return CRDTOperation(row["instance_pub_id"], row["timestamp"],
                             data.get("op_id", b""), typ)

    # -- clone fast path: serving side --------------------------------------

    def iter_clone_stream(self, clocks: Sequence[Tuple[bytes, int]],
                          ops_page: int = 1000):
        """Yield ``("page", page)`` items carrying the stored blob pages
        VERBATIM, interleaved with ``("ops", [CRDTOperation, ...])`` chunks
        of row-format ops, for a peer whose watermark for the authoring
        instance is absent or zero. A page's ack advances that watermark
        to the page's max_ts, so every row op of the instance stamped
        below it is yielded ahead of the page. One SELECT per item."""
        self._ensure_sync_indexes()
        wm = dict(clocks)
        floors: Dict[bytes, int] = {}
        for m in self.db.run("sync.clone.blob_metas"):
            pub = m["pub"]
            if wm.get(pub, 0) != 0:
                continue
            for ops in self._row_ops_between(m["instance_id"], pub,
                                             floors.get(pub, 0), m["min_ts"], ops_page):
                yield ("ops", ops)
            row = self.db.run("sync.blob.data_by_id", (m["id"],))
            if row is None:
                continue  # exploded meanwhile: its ops are rows now
            yield ("page", {"model": m["model"], "instance": pub,
                            "min_ts": m["min_ts"], "max_ts": m["max_ts"],
                            "n_ops": m["n_ops"], "data": row["data"]})
            floors[pub] = m["max_ts"]

    def _row_ops_between(self, instance_row_id: int, pub: bytes,
                         lo: int, hi: int, ops_page: int):
        """Row-format ops of one instance with lo < ts < hi, in stamp
        order, in chunks of ops_page."""
        while True:
            merged: List[Tuple[int, bool, Any]] = []
            for table, is_shared in (("shared_operation", True),
                                     ("relation_operation", False)):
                rows = self.db.query(
                    f"SELECT o.*, ? AS instance_pub_id FROM {table} o "
                    f"WHERE o.instance_id = ? AND o.timestamp > ? "
                    f"AND o.timestamp < ? ORDER BY o.timestamp LIMIT ?",
                    (pub, instance_row_id, lo, hi, ops_page))
                merged.extend((r["timestamp"], is_shared, r) for r in rows)
            if not merged:
                return
            merged.sort(key=lambda t: t[0])
            chunk = merged[:ops_page]
            yield [self._row_to_op(r, s) for _, s, r in chunk]
            if len(merged) < ops_page:
                return
            lo = chunk[-1][0]

    # -- ingest (core/crates/sync/src/ingest.rs:110-233) -------------------

    def register_instance(self, pub_id: bytes, **fields: Any) -> int:
        """Insert an instance row if unknown; returns its local row id."""
        if pub_id != self.instance:
            with self._meta_lock:
                self._solo = False  # peers exist: bulk ops go to rows
        row = self.db.run("sync.instances.id_by_pub", (pub_id,))
        if row is not None:
            with self._meta_lock:
                self._instance_ids[pub_id] = row["id"]
            return row["id"]
        defaults = {
            "pub_id": pub_id, "identity": fields.pop("identity", b""),
            "node_id": fields.pop("node_id", b""),
            "node_name": fields.pop("node_name", "?"),
            "node_platform": fields.pop("node_platform", 0),
            "last_seen": fields.pop("last_seen", int(time.time())),
            "date_created": fields.pop("date_created", int(time.time())),
        }
        defaults.update(fields)
        rid = self.db.insert("instance", defaults)
        with self._meta_lock:
            self._instance_ids[pub_id] = rid
        return rid

    def _register_origin(self, pub: bytes) -> None:
        """An op relayed from an instance never paired here gets a
        placeholder row (no identity, no route)."""
        if pub not in self._instance_ids:
            try:
                self._instance_row_id(pub)
            except KeyError:
                self.register_instance(pub, node_name="(relayed)")

    def receive_crdt_operation(self, op: CRDTOperation) -> bool:
        """Ingest one remote op; True if applied, False if stale."""
        applied, errors = self.receive_crdt_operations([op])
        if errors:
            raise RuntimeError(errors[0])
        return applied == 1

    def receive_crdt_operations(self, ops: Sequence[CRDTOperation]
                                ) -> Tuple[int, List[str]]:
        """Ingest one pull-loop page in ONE transaction, a savepoint per
        op (a malformed remote op rolls back alone), one watermark write
        per instance. Returns (applied, per-op error strings).

        An op this schema can never apply (unknown model: a newer peer)
        is quarantined and its watermark advances; any other failure
        freezes its instance's watermark below it so the next pull
        re-serves it."""
        if not ops:
            return 0, []
        # Chaos seam: error fails the page like a poisoned batch (the pull
        # loop's frozen watermark re-serves it); delay is slow-apply
        # weather on this worker thread (wire callers ingest off-loop).
        f = chaos.hit("sync.ingest.apply", only=("delay", "error"))
        if f is not None:
            chaos.apply_sync(f)
        self._ensure_row_oplog()
        self._ensure_sync_indexes()
        for op in ops:
            self._register_origin(op.instance)
        applied = 0
        errors: List[str] = []
        ts_max: Dict[bytes, int] = {}
        failed: set = set()
        with self.db.write_tx() as conn:
            # A bulk writer that checked _solo before the peer registered
            # may land one last blob: the compares below must see it as rows.
            for m in self.db.run("sync.blob.metas_sweep", conn=conn):
                self._explode_blob_conn(conn, m)
            for op in ops:
                self.clock.update_with_timestamp(op.timestamp)
                reason = self._op_permanently_inapplicable(op)
                if reason is not None:
                    self.db.run("sync.quarantine.insert",
                                (op.id, op.timestamp, op.pack()), conn=conn)
                    errors.append(f"ingest {op.typ!r}: quarantined: {reason}")
                    if op.instance not in failed:
                        ts_max[op.instance] = max(
                            self.timestamps.get(op.instance, op.timestamp),
                            ts_max.get(op.instance, 0), op.timestamp)
                    continue
                try:
                    if not self._compare_message(op):
                        conn.execute("SAVEPOINT ingest_op")
                        try:
                            self._apply_op_conn(conn, op)
                        except Exception:
                            conn.execute("ROLLBACK TO SAVEPOINT ingest_op")
                            raise
                        finally:
                            conn.execute("RELEASE SAVEPOINT ingest_op")
                        applied += 1
                except Exception as e:  # noqa: BLE001 — per-op guard
                    errors.append(f"ingest {op.typ!r}: {e}")
                    failed.add(op.instance)
                    continue
                if op.instance in failed:
                    continue
                # the watermark moves only past applied or stale ops
                ts_max[op.instance] = max(
                    self.timestamps.get(op.instance, op.timestamp),
                    ts_max.get(op.instance, 0), op.timestamp)
            for pub, ts in ts_max.items():
                self.db.run("sync.instances.set_watermark", (ts, pub), conn=conn)
        with self._meta_lock:
            self.timestamps.update(ts_max)
        return applied, errors

    # -- clone fast path: receiving side ------------------------------------

    def receive_blob_pages(self, pages: Sequence[dict]
                           ) -> Tuple[int, List[str], int]:
        """Ingest verbatim blob pages, one transaction each: executemany
        op-log inserts and domain writes, FK pub_ids resolved by subselect
        after the page's rows are seeded. Per-op compare is skipped only
        where ``_clone_fast_eligible`` proves it a no-op; any other page
        (local writes during the clone, deletes logged, non-uniform
        payloads, redelivery) goes per op, to the same final state.
        Returns (applied, errors, fast_pages)."""
        applied = 0
        errors: List[str] = []
        fast_pages = 0
        for page in pages:
            a, errs, fast = self._receive_blob_page(page)
            applied += a
            errors.extend(errs)
            fast_pages += 1 if fast else 0
        return applied, errors, fast_pages

    def _receive_blob_page(self, page: dict) -> Tuple[int, List[str], bool]:
        model = page["model"]
        pub = bytes(page["instance"])
        rows = opblob.decode_apply_rows(page["data"])
        if not rows:
            return 0, [], False
        self._register_origin(pub)
        if self._clone_fast_eligible(model, rows):
            try:
                self._apply_page_fast(model, pub, rows)
                return len(rows), [], True
            except Exception as e:  # noqa: BLE001 — the tx rolled back whole
                errors = [f"clone fast apply {model}: {e}; falling back per-op"]
                applied, errs = self._receive_page_per_op(model, pub, rows)
                return applied, errors + errs, False
        applied, errs = self._receive_page_per_op(model, pub, rows)
        return applied, errs, False

    def _receive_page_per_op(self, model: str, pub: bytes,
                             rows: Sequence[tuple]) -> Tuple[int, List[str]]:
        ops = [self._entry_to_op(model, ts, rid, payload, pub)
               for ts, rid, _kind, payload, _vp, _u in rows]
        return self.receive_crdt_operations(ops)

    def _clone_fast_eligible(self, model: str, rows: Sequence[tuple]) -> bool:
        """True where the page's batched apply is provably the per-op
        path's: a known shared model, uniform create / multi-update
        entries only, stamps strictly ascending and newer than every
        logged op, no shared delete logged, no record twice."""
        mdef = M.MODELS.get(model)
        if mdef is None or mdef.sync != M.SyncMode.SHARED:
            return False  # the per-op path quarantines version skew
        hi, tombstones = self._op_log_state()
        if tombstones:
            return False
        prev = hi
        seen = set()
        for ts, rid, kind, _payload, values_packed, _update in rows:
            if values_packed is None:
                return False
            if kind != OpKind.CREATE and not kind.startswith("u:"):
                return False
            if ts <= prev:
                return False
            prev = ts
            if rid in seen:
                return False
            seen.add(rid)
        return True

    @staticmethod
    def _rid_bytes(rid_packed: bytes) -> Any:
        """A blob entry's packed record id (bin8(16) is the bulk shape)."""
        if len(rid_packed) == 18 and rid_packed[:2] == b"\xc4\x10":
            return rid_packed[2:]
        return unpack_value(rid_packed)

    def _apply_page_fast(self, model: str, pub: bytes, rows: Sequence[tuple]) -> None:
        """One page → one transaction of executemany writes, with
        ``_apply_shared``'s create / multi-update semantics."""
        mdef = M.MODELS[model]
        sync_col = mdef.sync_id[0]
        remote_id = self._instance_row_id(pub)
        max_ts = rows[-1][0]
        attributable = any(f.name == "instance_id" for f in mdef.fields)
        # (is_create, sorted value keys) → [(record_id, values)]; no record
        # repeats across groups (eligibility), so group order is free.
        groups: Dict[Tuple[bool, Tuple[str, ...]], List[Tuple[Any, dict]]] = {}
        oplog_rows = []
        any_create = False
        for ts, rid_packed, kind, payload, values_packed, _update in rows:
            oplog_rows.append((ts, model, rid_packed, kind, payload, remote_id))
            is_create = kind == OpKind.CREATE
            any_create = any_create or is_create
            values = unpack_value(values_packed) or {}
            groups.setdefault((is_create, tuple(sorted(values))), []).append(
                (self._rid_bytes(rid_packed), values))
        # A transaction of its own, not a savepoint of the group commit: a
        # savepoint over a page's thousands of row updates costs SQLite time
        # that grows with the database (3.4x over a 100 000-file clone).
        with self.db.tx() as conn:
            self.db.run_many("sync.oplog.insert_shared", oplog_rows, conn=conn)
            for (is_create, keys), recs in groups.items():
                self._apply_group_fast(conn, mdef, sync_col, remote_id,
                                       is_create and attributable, keys, recs)
            if any_create and self.db.run("sync.pending.any", conn=conn) is not None:
                # creates may materialise rows that parked relation ops wait for
                self._drain_pending_relations(conn)
            new_wm = max(self.timestamps.get(pub, 0), max_ts)
            self.db.run("sync.instances.set_watermark", (new_wm, pub), conn=conn)
        with self._meta_lock:
            self.timestamps[pub] = new_wm
        self.clock.update_with_timestamp(max_ts)
        self._note_ops_logged(max_ts, False)
        # A clone commits page after page: fold the WAL as it grows.
        self.db.fold_wal(CLONE_WAL_BUDGET)

    def _apply_group_fast(self, conn, mdef, sync_col: str, remote_id: int,
                          attribute: bool, keys: Tuple[str, ...],
                          recs: List[Tuple[Any, dict]]) -> None:
        """Domain writes of one (kind, value-shape) group: seed the rows,
        then set their fields; an FK field resolves its pub_id by
        subselect (NULL where the row is absent, as ``_resolve_fk``)."""
        table = mdef.name
        if attribute:
            conn.executemany(
                f"INSERT OR IGNORE INTO {table} ({sync_col}, instance_id) "
                f"VALUES (?, ?)", [(r, remote_id) for r, _ in recs])
            conn.executemany(
                f"UPDATE {table} SET instance_id = ? WHERE {sync_col} = ? "
                f"AND instance_id IS NULL", [(remote_id, r) for r, _ in recs])
        else:
            conn.executemany(f"INSERT OR IGNORE INTO {table} ({sync_col}) VALUES (?)",
                             [(r,) for r, _ in recs])
        # One UPDATE sets the group's fields (the JAX package runs one per
        # field; the rows end the same).
        sets, names = [], []
        for name in keys:
            try:
                f = mdef.field(name)  # registry guard before SQL
            except KeyError:
                continue  # a newer peer's field this schema lacks
            target = _fk_target(f)
            if target is not None and M.MODELS[target].sync == M.SyncMode.SHARED:
                sets.append(f"{name} = (SELECT id FROM {target} WHERE pub_id = ?)")
            else:
                sets.append(f"{name} = ?")
            names.append(name)
        if sets:
            conn.executemany(
                f"UPDATE {table} SET {', '.join(sets)} WHERE {sync_col} = ?",
                [tuple(vals[n] for n in names) + (r,) for r, vals in recs])

    def drain_quarantined_ops(self) -> int:
        """Re-ingest ops an older schema quarantined as unknown-model;
        those still unknown stay. Returns how many drained."""
        drained = 0
        for row in self.db.run("sync.quarantine.all"):
            op = CRDTOperation.unpack(row["data"])
            if self._op_permanently_inapplicable(op) is not None:
                continue
            _, errs = self.receive_crdt_operations([op])
            if not errs:
                self.db.run_tx("sync.quarantine.delete", (row["id"],))
                drained += 1
        return drained

    def _op_permanently_inapplicable(self, op: CRDTOperation) -> Optional[str]:
        """Why no retry can ever apply this op here (its model is unknown
        or of the wrong sync mode), else None. Unknown fields of a known
        model are skipped on apply, not refused."""
        t = op.typ
        if isinstance(t, SharedOp):
            model = M.MODELS.get(t.model)
            if model is None:
                return f"unknown model {t.model!r}"
            if model.sync != M.SyncMode.SHARED:
                return f"model {t.model!r} is not shared-synced"
        else:
            model = M.MODELS.get(t.relation)
            if model is None:
                return f"unknown relation {t.relation!r}"
            if model.sync != M.SyncMode.RELATION or not model.relation:
                return f"model {t.relation!r} is not relation-synced"
        return None

    def _compare_message(self, op: CRDTOperation) -> bool:
        """Last-writer-wins: is an op at or after this one logged for the
        same record and kind? (ingest.rs:188-233). An equal stamp counts
        as old, so a redelivered page logs nothing twice.

        Update kinds compare by FIELD COVERAGE: stale iff every field the
        op carries is covered by same-or-newer updates of the record.
        Shared deletes are remove-wins: a logged 'd' makes every other op
        on the record stale. A relation link is LWW between 'c' and 'd'
        by stamp: any op is stale under a same-or-newer delete, a delete
        also under a strictly newer create."""
        t = op.typ
        if isinstance(t, SharedOp):
            if not t.delete:
                if self.db.run("sync.lww.shared_tombstone",
                               (t.model, pack_value(t.record_id))) is not None:
                    return True
            kind = t.kind
            if kind.startswith("u:"):
                fields = set(OpKind.update_fields(kind))
                covered: set = set()
                for row in self.db.run("sync.lww.shared_update_coverage",
                                       (t.model, pack_value(t.record_id), op.timestamp)):
                    covered.update(OpKind.update_fields(row["kind"]))
                return fields <= covered
            row = self.db.run("sync.lww.shared_same_kind",
                              (op.timestamp, t.model, pack_value(t.record_id), t.kind))
        else:
            key = (t.relation, pack_value(t.item_id), pack_value(t.group_id))
            if t.delete:
                row = self.db.run("sync.lww.relation_delete_check",
                                  key + (op.timestamp, op.timestamp))
            else:
                row = self.db.run("sync.lww.relation_nondelete_check",
                                  key + (op.timestamp, t.kind))
        return row is not None

    # -- generic ModelSyncData apply ---------------------------------------

    def _resolve_fk(self, conn, table: str, pub_id: Any) -> Optional[int]:
        if pub_id is None:
            return None
        row = conn.execute(f"SELECT id FROM {table} WHERE pub_id = ?",
                           (pub_id,)).fetchone()
        return row["id"] if row else None

    def _apply_op_conn(self, conn, op: CRDTOperation) -> None:
        """Apply a remote op to the domain tables and log it, on the
        caller's transaction. A relation op whose rows have not arrived
        is parked in pending_relation_op (not the log, where a
        redelivery would read as stale) and drained by a later create."""
        t = op.typ
        remote_id = self._instance_row_id(op.instance, conn)
        if isinstance(t, SharedOp):
            self._apply_shared(conn, t, remote_id, op.timestamp)
            self._insert_op_row(conn, op, remote_id)
            if t.field is None and not t.delete and not t.update:
                self._drain_pending_relations(conn)
        elif self._apply_relation(conn, t, op.timestamp):
            self._insert_op_row(conn, op, remote_id)
        elif not self._relation_target_tombstoned(conn, t):
            # (a tombstoned target can never materialise: the op is dead)
            rmodel = M.MODELS[t.relation]
            item_f, group_f = rmodel.relation
            self.db.run("sync.pending.park",
                        (op.id, op.timestamp, op.pack(),
                         _fk_target(rmodel.field(item_f)), pack_value(t.item_id),
                         _fk_target(rmodel.field(group_f)), pack_value(t.group_id),
                         op.id), conn=conn)

    def _drain_pending_relations(self, conn) -> None:
        """Retry parked relation ops; applied ones move to the op log."""
        for row in self.db.run("sync.pending.all", conn=conn):
            op = CRDTOperation.unpack(row["data"])
            t = op.typ
            if not isinstance(t, RelationOp):
                self.db.run("sync.pending.delete", (row["id"],), conn=conn)
                continue
            if self._apply_relation(conn, t, op.timestamp):
                self._insert_op_row(conn, op, self._instance_row_id(op.instance, conn))
                self.db.run("sync.pending.delete", (row["id"],), conn=conn)
            elif self._relation_target_tombstoned(conn, t):
                self.db.run("sync.pending.delete", (row["id"],), conn=conn)

    def _relation_target_tombstoned(self, conn, t: RelationOp) -> bool:
        """Either record the relation op references has a logged delete."""
        model = M.MODELS[t.relation]
        item_f, group_f = model.relation
        for rid, tbl in ((t.item_id, _fk_target(model.field(item_f))),
                         (t.group_id, _fk_target(model.field(group_f)))):
            if tbl is not None and self.db.run(
                    "sync.lww.shared_tombstone", (tbl, pack_value(rid)),
                    conn=conn) is not None:
                return True
        return False

    def _superseding_update_fields(self, conn, t: SharedOp, ts: Optional[int]) -> set:
        """Fields of this record with updates NEWER than ts, which a
        create's batched values must not clobber."""
        if ts is None:
            return set()
        out: set = set()
        for row in self.db.run("sync.lww.superseding_updates",
                               (t.model, pack_value(t.record_id), ts), conn=conn):
            out.update(OpKind.update_fields(row["kind"]))
        return out

    def _apply_shared(self, conn, t: SharedOp,
                      origin_instance_row: Optional[int] = None,
                      ts: Optional[int] = None) -> None:
        model = M.MODELS[t.model]
        assert model.sync == M.SyncMode.SHARED, t.model
        sync_col = model.sync_id[0]
        if t.delete:
            # Clear every local reference first (nullable: SET NULL, else
            # delete the referencing row): a reference this peer made that
            # the emitter never saw would fail the delete on every retry.
            local = self._resolve_fk(conn, t.model, t.record_id)
            if local is not None:
                cascade_local_fks(conn, t.model, local)
            # Parked relation ops on the dead record can never apply.
            key = pack_value(t.record_id)
            self.db.run("sync.pending.purge_refs", (t.model, key, t.model, key),
                        conn=conn)
            conn.execute(f"DELETE FROM {t.model} WHERE {sync_col} = ?",
                         (t.record_id,))
            return

        def write_field(name: str, raw_value: Any) -> None:
            try:
                f = model.field(name)  # registry guard before SQL
            except KeyError:
                return  # a newer peer's field this schema lacks
            value = raw_value
            target = _fk_target(f)
            if target is not None and M.MODELS[target].sync == M.SyncMode.SHARED:
                value = self._resolve_fk(conn, target, value)
            conn.execute(f"UPDATE {t.model} SET {name} = ? WHERE {sync_col} = ?",
                         (value, t.record_id))

        def seed_row(attribute: bool) -> None:
            # A remotely CREATED row carries its creator in instance_id;
            # an update seeds it unattributed and the create backfills.
            attribute = attribute and origin_instance_row is not None and \
                any(f.name == "instance_id" for f in model.fields)
            if attribute:
                conn.execute(f"INSERT OR IGNORE INTO {t.model} "
                             f"({sync_col}, instance_id) VALUES (?, ?)",
                             (t.record_id, origin_instance_row))
                conn.execute(f"UPDATE {t.model} SET instance_id = ? "
                             f"WHERE {sync_col} = ? AND instance_id IS NULL",
                             (origin_instance_row, t.record_id))
            else:
                conn.execute(f"INSERT OR IGNORE INTO {t.model} ({sync_col}) "
                             f"VALUES (?)", (t.record_id,))

        if t.update:  # multi-field update: per-field LWW
            seed_row(attribute=False)
            superseded = self._superseding_update_fields(conn, t, ts)
            for name, raw in (t.values or {}).items():
                if name not in superseded:
                    write_field(name, raw)
            return
        if t.field is None:  # create, its values batched in the one op
            seed_row(attribute=True)
            superseded = (self._superseding_update_fields(conn, t, ts)
                          if t.values else set())
            for name, raw in (t.values or {}).items():
                if name not in superseded:
                    write_field(name, raw)
            return
        # single-field update: _compare_message already decided LWW
        seed_row(attribute=False)
        write_field(t.field, t.value)

    def _relation_field_superseded(self, conn, t: RelationOp, field: str,
                                   ts: Optional[int]) -> bool:
        if ts is None:
            return False
        return self.db.run(
            "sync.lww.relation_superseding",
            (t.relation, pack_value(t.item_id), pack_value(t.group_id),
             OpKind.update(field), ts), conn=conn) is not None

    def _apply_relation(self, conn, t: RelationOp, ts: Optional[int] = None) -> bool:
        """False when the referenced rows are not here yet (the caller
        parks the op)."""
        model = M.MODELS[t.relation]
        assert model.sync == M.SyncMode.RELATION and model.relation
        item_field, group_field = model.relation
        item_local = self._resolve_fk(conn, _fk_target(model.field(item_field)), t.item_id)
        group_local = self._resolve_fk(conn, _fk_target(model.field(group_field)),
                                       t.group_id)
        if item_local is None or group_local is None:
            return False
        if t.delete:
            conn.execute(f"DELETE FROM {t.relation} WHERE {item_field} = ? "
                         f"AND {group_field} = ?", (item_local, group_local))
            return True
        conn.execute(f"INSERT OR IGNORE INTO {t.relation} "
                     f"({item_field}, {group_field}) VALUES (?, ?)",
                     (item_local, group_local))

        def write_field(name: str, raw_value: Any) -> None:
            try:
                f = model.field(name)  # registry guard before SQL
            except KeyError:
                return
            conn.execute(f"UPDATE {t.relation} SET {f.name} = ? "
                         f"WHERE {item_field} = ? AND {group_field} = ?",
                         (raw_value, item_local, group_local))

        if t.field is not None:
            write_field(t.field, t.value)
        else:
            for name, raw in (t.values or {}).items():
                if not self._relation_field_superseded(conn, t, name, ts):
                    write_field(name, raw)
        return True
