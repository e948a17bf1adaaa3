"""A msgpack codec for the values the scan chain stores.

The JAX package writes job state, job reports, indexer rules, job scratch
rows, CRDT op payloads and op-log blobs with
``msgpack.packb(v, use_bin_type=True)`` and reads them with
``msgpack.unpackb(b, raw=False, strict_map_key=False)``. The machine the
port runs on has no ``msgpack`` package, so the port carries this codec:
``packb`` gives the same bytes for ``None``, ``bool``, ``int`` in
[-2**63, 2**64), ``float`` (as float 64), ``str``, ``bytes``, ``list`` /
``tuple`` and ``dict`` with any of these as keys, so a library the port
writes is the library the JAX package reads. ``unpackb`` decodes every
format ``packb`` writes plus float 32, with strings as ``str``, binaries
as ``bytes``, arrays as ``list`` and maps as ``dict`` whose keys may be of
any hashable type, as msgpack's are with ``strict_map_key=False``. It
refuses the ext types (``msgpack`` would hand back an ``ExtType`` no
caller reads), a map key that is not hashable (an array), a string that
is not UTF-8 and extra bytes after the value, each with a ``ValueError``.
``iter_array`` decodes an array one element at a time, as
``msgpack.Unpacker`` does, so a reader can stop early.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Iterator, Tuple

_B = struct.Struct(">B").pack
_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack


def _int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return _B(n)
        if n <= 0xFF:
            return _BB(0xCC, n)
        if n <= 0xFFFF:
            return _BH(0xCD, n)
        if n <= 0xFFFFFFFF:
            return _BI(0xCE, n)
        if n <= 0xFFFFFFFFFFFFFFFF:
            return _BQ(0xCF, n)
        raise OverflowError(f"int {n} does not fit msgpack's 64 bits")
    if n >= -32:
        return _B(n & 0xFF)
    if n >= -0x80:
        return _Bb(0xD0, n)
    if n >= -0x8000:
        return _Bh(0xD1, n)
    if n >= -0x80000000:
        return _Bi(0xD2, n)
    if n >= -0x8000000000000000:
        return _Bq(0xD3, n)
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, c8: int, c16: int, c32: int) -> bytes:
    if n < fix_max:
        return _B(fix | n)
    if c8 and n <= 0xFF:
        return _BB(c8, n)
    if n <= 0xFFFF:
        return _BH(c16, n)
    if n <= 0xFFFFFFFF:
        return _BI(c32, n)
    raise ValueError(f"msgpack cannot frame {n} items or bytes")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 32, 0xD9, 0xDA, 0xDB) + b


def _bin(b) -> bytes:
    b = bytes(b)
    n = len(b)
    if n <= 0xFF:
        return _BB(0xC4, n) + b
    if n <= 0xFFFF:
        return _BH(0xC5, n) + b
    if n <= 0xFFFFFFFF:
        return _BI(0xC6, n) + b
    raise ValueError(f"msgpack cannot frame {n} bytes")


def _pack(o: Any, w: Callable[[bytes], None]) -> None:
    t = type(o)
    if o is None:
        w(b"\xc0")
    elif t is bool:
        w(b"\xc3" if o else b"\xc2")
    elif t is int:
        w(_int(o))
    elif t is str:
        w(_str(o))
    elif t is bytes:
        w(_bin(o))
    elif t is dict:
        w(_header(len(o), 0x80, 16, 0, 0xDE, 0xDF))
        for k, v in o.items():
            _pack(k, w)
            _pack(v, w)
    elif t is list or t is tuple:
        w(_header(len(o), 0x90, 16, 0, 0xDC, 0xDD))
        for v in o:
            _pack(v, w)
    elif t is float:
        w(_Bd(0xCB, o))
    # Subclasses (IntEnum, str enums, bytearray, OrderedDict) pack as
    # their base type, as msgpack's packer does without strict_types.
    elif isinstance(o, int):
        w(_int(int(o)))
    elif isinstance(o, str):
        w(_str(str(o)))
    elif isinstance(o, (bytearray, memoryview)):
        w(_bin(o))
    elif isinstance(o, dict):
        _pack(dict(o), w)
    elif isinstance(o, (list, tuple)):
        _pack(list(o), w)
    elif isinstance(o, float):
        w(_Bd(0xCB, float(o)))
    else:
        raise TypeError(f"cannot msgpack {t.__name__}")


def packb(o: Any) -> bytes:
    """``msgpack.packb(o, use_bin_type=True)``."""
    parts: list = []
    _pack(o, parts.append)
    return b"".join(parts)


_U8 = struct.Struct(">B").unpack_from
_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_U64 = struct.Struct(">Q").unpack_from
_I8 = struct.Struct(">b").unpack_from
_I16 = struct.Struct(">h").unpack_from
_I32 = struct.Struct(">i").unpack_from
_I64 = struct.Struct(">q").unpack_from
_F32 = struct.Struct(">f").unpack_from
_F64 = struct.Struct(">d").unpack_from
# Fixed-width scalars: code → (reader, width).
_SCALARS = {
    0xCA: (_F32, 4), 0xCB: (_F64, 8),
    0xCC: (_U8, 1), 0xCD: (_U16, 2), 0xCE: (_U32, 4), 0xCF: (_U64, 8),
    0xD0: (_I8, 1), 0xD1: (_I16, 2), 0xD2: (_I32, 4), 0xD3: (_I64, 8),
}
# Length-prefixed formats: code → (kind, length reader, width).
_SIZED = {
    0xC4: ("bin", _U8, 1), 0xC5: ("bin", _U16, 2), 0xC6: ("bin", _U32, 4),
    0xD9: ("str", _U8, 1), 0xDA: ("str", _U16, 2), 0xDB: ("str", _U32, 4),
    0xDC: ("array", _U16, 2), 0xDD: ("array", _U32, 4),
    0xDE: ("map", _U16, 2), 0xDF: ("map", _U32, 4),
}


def _utf8(raw: bytes) -> str:
    try:
        return raw.decode()
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack str is not UTF-8: {e}") from None


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(data):
        raise ValueError("msgpack data ends inside a value")
    return data[pos:end], end


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    # The common codes first, inline: this runs once per decoded value.
    try:
        c = data[pos]
    except IndexError:
        raise ValueError("msgpack data ends inside a value") from None
    pos += 1
    if c < 0x80:
        return c, pos
    if 0xA0 <= c < 0xC0:
        end = pos + (c & 0x1F)
        if end > len(data):
            raise ValueError("msgpack data ends inside a value")
        return _utf8(data[pos:end]), end
    if c < 0x90:
        return _map(data, pos, c & 0x0F)
    if c < 0xA0:
        return _array(data, pos, c & 0x0F)
    if c >= 0xE0:
        return c - 0x100, pos
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    if c == 0xC4:
        if pos >= len(data):
            raise ValueError("msgpack data ends inside a value")
        end = pos + 1 + data[pos]
        if end > len(data):
            raise ValueError("msgpack data ends inside a value")
        return data[pos + 1:end], end
    scalar = _SCALARS.get(c)
    if scalar is not None:
        read, width = scalar
        if pos + width > len(data):
            raise ValueError("msgpack data ends inside a value")
        return read(data, pos)[0], pos + width
    sized = _SIZED.get(c)
    if sized is None:
        raise ValueError(f"msgpack code 0x{c:02x} is not supported")
    kind, read, width = sized
    if pos + width > len(data):
        raise ValueError("msgpack data ends inside a value")
    n = read(data, pos)[0]
    pos += width
    if kind == "bin":
        return _take(data, pos, n)
    if kind == "str":
        raw, pos = _take(data, pos, n)
        return _utf8(raw), pos
    if kind == "array":
        return _array(data, pos, n)
    return _map(data, pos, n)


def _array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    append = out.append
    for _ in range(n):
        v, pos = _unpack(data, pos)
        append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    size = len(data)
    for _ in range(n):
        # a fixstr key, inline; any other key through _unpack
        c = data[pos] if pos < size else -1
        if 0xA0 <= c < 0xC0:
            end = pos + 1 + (c & 0x1F)
            if end > size:
                raise ValueError("msgpack data ends inside a value")
            k = _utf8(data[pos + 1:end])
            pos = end
        else:
            k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        try:
            out[k] = v
        except TypeError:
            raise ValueError(f"msgpack map key of type {type(k).__name__} "
                             "is not hashable") from None
    return out, pos


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)``."""
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after the value")
    return obj


def iter_array(data) -> Iterator[Any]:
    """The elements of the msgpack array `data`, decoded one at a time
    (``msgpack.Unpacker.read_array_header`` then ``unpack`` per element)."""
    data = bytes(data)
    if not data:
        raise ValueError("msgpack data ends inside a value")
    c = data[0]
    if 0x90 <= c < 0xA0:
        n, pos = c & 0x0F, 1
    elif c in (0xDC, 0xDD):
        width = 2 if c == 0xDC else 4
        if len(data) < 1 + width:
            raise ValueError("msgpack data ends inside a value")
        n = (_U16 if c == 0xDC else _U32)(data, 1)[0]
        pos = 1 + width
    else:
        raise ValueError(f"msgpack value at 0 is not an array (code 0x{c:02x})")
    for _ in range(n):
        v, pos = _unpack(data, pos)
        yield v
