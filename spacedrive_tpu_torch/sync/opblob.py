"""Page-level op-log blob codec (the ``shared_op_blob.data`` format).

Port of the Python codec of ``spacedrive_tpu/sync/opblob.py``, both
halves. A
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
path; the port's copy of that codec waits in ROADMAP, and until then
``decode_entries``, ``decode_apply_rows`` and ``encode_uniform`` run the
Python path, which gives the same bytes and rows.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence

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


decode_entries = decode_entries_py


def iter_entries(data: bytes) -> Iterator[list]:
    """The entries one at a time: a count-bounded ``get_ops`` stops
    decoding a big page once its window is full."""
    return _msgpack.iter_array(data)


def decode_apply_rows(data: bytes) -> List[tuple]:
    """Blob bytes → (ts, rid_packed, kind, payload, values_packed, update)
    rows for the batched clone apply. ``values_packed`` is the payload's
    packed ``values`` map, located by the fragment arithmetic (the
    payloads were built from those very fragments) without decoding the
    payload; an entry whose payload is not a uniform bulk shape gets None,
    which sends the caller to its per-op path."""
    return [_apply_row_py(e) for e in decode_entries_py(data)]


_OPID_AT = len(BULK_HDR5)
_RID_AT = _OPID_AT + len(BULK_OPID)
_VALUES_AT = _RID_AT + 16
_VALUES_END = _VALUES_AT + len(BULK_VALUES)


def _apply_row_py(entry) -> tuple:
    """One decoded entry → its ``decode_apply_rows`` tuple; the update
    flag is set only where the whole uniform probe succeeds."""
    ts, rid, kind, payload = entry
    hdr6 = payload.startswith(BULK_HDR6)
    values: Optional[bytes] = None
    if (hdr6 or payload.startswith(BULK_HDR5)) and \
            payload[_OPID_AT:_RID_AT] == BULK_OPID and \
            payload[_VALUES_AT:_VALUES_END] == BULK_VALUES:
        if hdr6:
            if payload.endswith(BULK_UPDATE_T):
                values = payload[_VALUES_END:-len(BULK_UPDATE_T)] or None
        else:
            values = payload[_VALUES_END:] or None
    return (ts, rid, kind, payload, values, hdr6 and values is not None)


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


encode_uniform = encode_uniform_py
