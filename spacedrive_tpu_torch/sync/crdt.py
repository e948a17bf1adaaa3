"""CRDT operation vocabulary: op kinds, shared ops, ids and value packing.

Port of ``spacedrive_tpu/sync/crdt.py``: ``OpKind``, the time-ordered
16-byte ids (``uuid4_bytes``, ``uuid4_bytes_batch``, v7 layout),
``SharedOp`` / ``RelationOp`` / ``CRDTOperation`` with their wire form
(``to_wire`` / ``from_wire``, ``pack`` / ``unpack``), the canonical op-log
payload (``op_payload``) and ``pack_value`` / ``unpack_value`` through the
port's msgpack codec, byte-identical to the JAX package's.

A ``CRDTOperation`` is (instance pub_id, NTP64 timestamp, op id, payload);
kinds are "c", "u:<field>", "u:<a>+<b>" (multi-field update) and "d"
(upstream crates/sync/src/crdt.rs:15-131).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np

from .. import _msgpack


class OpKind:
    CREATE = "c"
    DELETE = "d"

    @staticmethod
    def update(field: str) -> str:
        return f"u:{field}"

    @staticmethod
    def multi_update(fields) -> str:
        """Kind of a multi-field update op: "u:" + the sorted field names
        joined by "+" (the identifier's one {cas_id, object_id} op per
        file; applied per-field last-writer-wins)."""
        return "u:" + "+".join(sorted(fields))

    @staticmethod
    def update_fields(kind: str) -> list:
        """Field names an update kind covers ("u:a+b" → [a, b])."""
        return kind[2:].split("+") if kind.startswith("u:") else []


def uuid4_bytes() -> bytes:
    """One time-ordered 16-byte id (UUIDv7 layout; see the batch form)."""
    return uuid4_bytes_batch(1)[0]


_uuid_state = [0, 0]  # [last_ms, next_counter], shared across calls
_uuid_lock = threading.Lock()  # ids are minted from job threads too


def uuid4_bytes_batch(n: int) -> list:
    """n time-ordered ids from one urandom call: a 48-bit millisecond
    stamp, version 7, a 16-bit counter that continues across calls within
    one millisecond (so batches minted back to back stay ordered and
    distinct), the variant bits and 58 random bits. Bulk inserts into
    UNIQUE pub_id B-trees then append instead of landing on random
    leaves."""
    if n <= 0:
        return []
    blob = os.urandom(8 * n)
    with _uuid_lock:
        ms = time.time_ns() // 1_000_000
        if ms != _uuid_state[0]:
            _uuid_state[0] = ms
            _uuid_state[1] = 0
        base = _uuid_state[1]
        _uuid_state[1] = (base + n) & 0xFFFF
    ts = ms.to_bytes(6, "big")
    if n < 64:  # numpy's set-up costs more than it saves on small mints
        out = []
        for i in range(n):
            k = 8 * i
            c = (base + i) & 0xFFFF
            b = bytearray(16)
            b[0:6] = ts
            b[6] = 0x70 | ((c >> 12) & 0x0F)   # version 7 + counter hi
            b[7] = (c >> 4) & 0xFF             # counter mid
            b[8] = 0x80 | ((c & 0x0F) << 2) | (blob[k] & 0x03)  # variant + lo
            b[9:16] = blob[k + 1:k + 8]
            out.append(bytes(b))
        return out
    rnd = np.frombuffer(blob, dtype=np.uint8).reshape(n, 8)
    c = (base + np.arange(n, dtype=np.uint32)) & 0xFFFF
    b = np.empty((n, 16), dtype=np.uint8)
    b[:, 0:6] = np.frombuffer(ts, dtype=np.uint8)
    b[:, 6] = 0x70 | ((c >> 12) & 0x0F)
    b[:, 7] = (c >> 4) & 0xFF
    b[:, 8] = 0x80 | ((c & 0x0F) << 2) | (rnd[:, 0] & 0x03)
    b[:, 9:16] = rnd[:, 1:8]
    rows = b.tobytes()
    return [rows[i << 4:(i + 1) << 4] for i in range(n)]


@dataclass(frozen=True)
class SharedOp:
    model: str                   # model name in the registry
    record_id: Any               # sync id value (a pub_id)
    field: Optional[str] = None  # set for a single-field update
    value: Any = None
    delete: bool = False
    values: Any = None           # a create's initial values, or a multi-update's
    update: bool = False         # values + update=True: a multi-field update

    @property
    def kind(self) -> str:
        if self.delete:
            return OpKind.DELETE
        if self.field is not None:
            return OpKind.update(self.field)
        if self.update:
            return OpKind.multi_update(self.values or {})
        return OpKind.CREATE


@dataclass(frozen=True)
class RelationOp:
    relation: str                # relation model name
    item_id: Any                 # item sync id
    group_id: Any                # group sync id
    field: Optional[str] = None
    value: Any = None
    delete: bool = False
    values: Any = None           # a create's extra columns, all at once

    @property
    def kind(self) -> str:
        if self.delete:
            return OpKind.DELETE
        if self.field is not None:
            return OpKind.update(self.field)
        return OpKind.CREATE


@dataclass(frozen=True)
class CRDTOperation:
    instance: bytes   # instance pub_id (16 bytes)
    timestamp: int    # NTP64
    id: bytes         # op id
    typ: Union[SharedOp, RelationOp]

    @classmethod
    def new(cls, instance: bytes, timestamp: int,
            typ: Union[SharedOp, RelationOp]) -> "CRDTOperation":
        return cls(instance, timestamp, uuid4_bytes(), typ)

    # -- wire encoding -----------------------------------------------------

    def to_wire(self) -> dict:
        t = self.typ
        base = {"instance": self.instance, "timestamp": self.timestamp,
                "id": self.id}
        if isinstance(t, SharedOp):
            base["shared"] = {
                "model": t.model, "record_id": t.record_id,
                "field": t.field, "value": t.value, "delete": t.delete,
                "values": t.values,
            }
            if t.update:  # key only present on multi-field updates
                base["shared"]["update"] = True
        else:
            base["relation"] = {
                "relation": t.relation, "item_id": t.item_id,
                "group_id": t.group_id, "field": t.field,
                "value": t.value, "delete": t.delete, "values": t.values,
            }
        return base

    @classmethod
    def from_wire(cls, raw: dict) -> "CRDTOperation":
        if "shared" in raw:
            s = raw["shared"]
            typ: Union[SharedOp, RelationOp] = SharedOp(
                s["model"], s["record_id"], s["field"], s["value"],
                s["delete"], s.get("values"), bool(s.get("update")))
        else:
            r = raw["relation"]
            typ = RelationOp(
                r["relation"], r["item_id"], r["group_id"], r["field"],
                r["value"], r["delete"], r.get("values"))
        return cls(raw["instance"], raw["timestamp"], raw["id"], typ)

    def pack(self) -> bytes:
        return pack_value(self.to_wire())

    @classmethod
    def unpack(cls, blob: bytes) -> "CRDTOperation":
        return cls.from_wire(unpack_value(blob))


def op_payload(field: Optional[str], value: Any, delete: bool,
               op_id: bytes, values: Any, update: bool = False) -> dict:
    """The op log's ``data`` dict in its one canonical key order; every
    writer builds it here so equal ops pack to equal bytes."""
    d = {"field": field, "value": value, "delete": delete,
         "op_id": op_id, "values": values}
    if update:  # key only present on multi-field update ops
        d["update"] = True
    return d


def pack_value(v: Any) -> bytes:
    return _msgpack.packb(v)


def unpack_value(b: bytes) -> Any:
    return _msgpack.unpackb(b)
