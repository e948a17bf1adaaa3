"""Page-level op-log blob codec (the ``shared_op_blob.data`` format).

Port of the pure-Python encoders of ``spacedrive_tpu/sync/opblob.py``. A
bulk writer's whole chunk of shared ops (the identifier's links, the
indexer's 1000-row creates) lands in ONE ``shared_op_blob`` row. ``data``
is a msgpack array of per-op entries

    [timestamp (uint), record_id (bin: the msgpack-packed sync id),
     kind (str), payload (bin)]

where ``payload`` is byte-identical to what the same op's
``shared_operation.data`` would hold (``crdt.op_payload`` packed), so a
blob read back yields exactly the ops the row format would have.

The JAX package also encodes and decodes these pages in its native C++
plane (``sd_encode_ops`` / ``sd_decode_ops``), byte-equal to the Python
path; the port's copy of that codec waits in ROADMAP.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from .. import _msgpack

# Pre-encoded msgpack fragments of op_payload's canonical key order for
# the two field-is-None shapes bulk writers emit (create: a 5-key map;
# multi-field update: a 6-key map with a trailing update=True).
BULK_HDR5 = b"\x85\xa5field\xc0\xa5value\xc0\xa6delete\xc2"
BULK_HDR6 = b"\x86\xa5field\xc0\xa5value\xc0\xa6delete\xc2"
BULK_OPID = b"\xa5op_id\xc4\x10"
BULK_VALUES = b"\xa6values"
BULK_UPDATE_T = b"\xa6update\xc3"


def pack_bulk_payload(kind: str, op_id: bytes, values_packed: bytes) -> bytes:
    """One op's ``data`` payload from pre-packed values, for the
    field-is-None shapes (byte-equal to ``pack_value(op_payload(...))``)."""
    if kind.startswith("u:"):
        return (BULK_HDR6 + BULK_OPID + op_id
                + BULK_VALUES + values_packed + BULK_UPDATE_T)
    return BULK_HDR5 + BULK_OPID + op_id + BULK_VALUES + values_packed


def encode_entries(entries: Sequence[Sequence[Any]]) -> bytes:
    """[[ts, record_id_packed, kind, payload], ...] → blob bytes."""
    return _msgpack.packb(list(entries))


def decode_entries_py(data: bytes) -> List[list]:
    """Blob bytes → [[ts, record_id_packed, kind, payload], ...]."""
    return _msgpack.unpackb(data)


def encode_uniform_py(timestamps: Sequence[int], record_ids: Sequence[bytes],
                      kind: str, op_ids: Sequence[bytes],
                      values_packed: Sequence[bytes]) -> bytes:
    """Encode a uniform-kind chunk: every record id a raw 16-byte pub id
    (packed here as bin8(16)), every op a field-is-None create or
    multi-field update."""
    return encode_entries([
        [ts, b"\xc4\x10" + rid, kind, pack_bulk_payload(kind, oid, vp)]
        for ts, rid, oid, vp in zip(timestamps, record_ids, op_ids, values_packed)
    ])
