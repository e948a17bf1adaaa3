"""Sync manager, write half: atomic domain + op-log writes.

Port of the write half of ``spacedrive_tpu/sync/manager.py``
(upstream core/crates/sync/src/manager.rs:62-199): the op factory
(``shared_create`` / ``shared_update`` / ``shared_delete``), ``write_ops``
(domain writes and op-log rows in ONE transaction, then a created
broadcast), ``_insert_op_rows``, ``bulk_shared_ops`` (the bulk writers'
fast path, with one ``shared_op_blob`` page per chunk of at least
``BLOB_MIN_OPS`` uniform ops on a solo library), ``register_instance`` and
the created-broadcast hooks. Every row and blob it writes is byte-equal to
the JAX package's for the same stamps, ids and values.

The receive, apply and clone half (``get_ops``, ingest, blob explode,
quarantine) waits in ROADMAP; until it lands, a library the port writes
is read by peers through the JAX package.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..store.db import Database
from . import opblob
from .crdt import CRDTOperation, OpKind, SharedOp, op_payload, pack_value, uuid4_bytes_batch
from .hlc import HLC

# A bulk append at or above this many ops on a SOLO library (no other
# instance registered) lands as ONE shared_op_blob page instead of that
# many shared_operation rows.
BLOB_MIN_OPS = 256


class SyncManager:
    def __init__(self, db: Database, instance_pub_id: bytes,
                 emit_messages: bool = True):
        self.db = db
        self.instance = instance_pub_id
        self.clock = HLC()
        self.emit_messages = emit_messages
        self._on_created: List[Callable[[], None]] = []
        # Instance pub_id → local row id.
        self._instance_ids: Dict[bytes, int] = {}
        # Solo = no other instance registered: bulk writers may append
        # page-level op blobs. Flips False for good once a peer appears.
        self._solo = True
        self._meta_lock = threading.Lock()
        self._load_instances()

    def _load_instances(self) -> None:
        rows = self.db.run("sync.instances.all")
        with self._meta_lock:
            for row in rows:
                self._instance_ids[row["pub_id"]] = row["id"]
                if row["timestamp"]:  # a peer's watermark: stamp after it
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

    def on_created(self, cb: Callable[[], None]) -> None:
        """Subscribe to the created broadcast (one call per committed batch
        of local ops)."""
        self._on_created.append(cb)

    def _notify_created(self) -> None:
        if not self.emit_messages:
            return
        for cb in list(self._on_created):
            cb()

    # -- op factory --------------------------------------------------------

    def _new_op(self, typ: SharedOp) -> CRDTOperation:
        return CRDTOperation.new(self.instance, self.clock.new_timestamp(), typ)

    def shared_create(self, model: str, record_id: Any,
                      values: Optional[Dict[str, Any]] = None) -> List[CRDTOperation]:
        """Create = ONE "c" op carrying all initial values."""
        return [self._new_op(SharedOp(model, record_id, values=dict(values or {})))]

    def shared_update(self, model: str, record_id: Any, field: str,
                      value: Any) -> CRDTOperation:
        return self._new_op(SharedOp(model, record_id, field=field, value=value))

    def shared_delete(self, model: str, record_id: Any) -> CRDTOperation:
        return self._new_op(SharedOp(model, record_id, delete=True))

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
        rows = []
        for op in ops:
            t = op.typ
            data = pack_value(op_payload(t.field, t.value, t.delete, op.id,
                                         t.values, t.update))
            rows.append((op.timestamp, t.model, pack_value(t.record_id), t.kind,
                         data, my_id))
        if rows:
            self.db.run_many("sync.oplog.insert_shared", rows, conn=conn)

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
                blob = opblob.encode_uniform_py(
                    stamps, [s[0] for s in specs], kind0, op_ids,
                    [pack_value(s[4]) for s in specs])
                self.db.run("sync.blob.insert",
                            (model, stamps[0], stamps[-1], len(specs), blob, my_id),
                            conn=conn)
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
        return len(rows)
