"""The port's wire registry (``spacedrive_tpu_torch/p2p/wire.py``) and
msgpack codec against the JAX package's, frame kind by frame kind.

Every declaration is the JAX package's (the baseline snapshot and the
generated table are equal), every declared kind's control frame packs to
the same bytes with the port's ``_msgpack`` as with ``msgpack``, and every
malformed mutant of ``tools/wire_grid.py`` is rejected without a crash,
by ``unpack`` and by the armed auditor, exactly where the JAX registry
rejects it."""

import msgpack
import pytest

from spacedrive_tpu.p2p import wire as jax_wire
from spacedrive_tpu_torch import _msgpack
from spacedrive_tpu_torch.p2p import wire
from tools import wire_grid

NAMES = sorted(jax_wire.MESSAGES)
CELLS = [(name, mutation) for name in NAMES
         for mutation, _f, _n in wire_grid.mutants(
             jax_wire, name, wire_grid.control_frame(jax_wire, name))]


def _packed(v):
    return msgpack.packb(v, use_bin_type=True)


def _unpacked(b):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


def test_the_registry_is_the_jax_packages():
    assert wire.baseline_snapshot() == jax_wire.baseline_snapshot()
    assert wire.PROTO_VERSIONS == jax_wire.PROTO_VERSIONS
    assert wire.MAX_FRAME == jax_wire.MAX_FRAME
    assert wire.wire_table_markdown() == jax_wire.wire_table_markdown()
    assert sorted(wire.MESSAGES) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_each_control_frame_packs_alike(name):
    frame = wire_grid.control_frame(wire, name)
    assert frame == wire_grid.control_frame(jax_wire, name)
    raw = _msgpack.packb(frame)
    assert raw == _packed(frame)
    assert _msgpack.unpackb(raw) == _unpacked(raw)
    assert wire.unpack(name, _msgpack.unpackb(raw)) == frame
    assert wire.classify(frame) == jax_wire.classify(frame)


def _verdict(w, name, frame, nbytes):
    try:
        w.unpack(name, frame, size=nbytes)
        return "accepted"
    except w.WireError as e:
        return type(e).__name__


@pytest.mark.parametrize("name,mutation", CELLS, ids=[f"{n}-{m}" for n, m in CELLS])
def test_each_mutant_is_rejected_as_the_jax_registry_rejects_it(name, mutation):
    [(frame, nbytes)] = [(f, n) for m, f, n in wire_grid.mutants(
        wire, name, wire_grid.control_frame(wire, name)) if m == mutation]
    got = _verdict(wire, name, frame, nbytes)
    assert got == _verdict(jax_wire, name, frame, nbytes)
    assert got != "accepted"
    assert wire.classify(frame) == jax_wire.classify(frame)
    recorded = []
    wire.arm("raise", lambda kind, detail, may_raise: recorded.append(detail))
    try:
        audited = wire.audit_frame(frame, "in", nbytes)
    finally:
        wire.disarm()
    still = wire_grid._still_valid(wire, frame, nbytes)
    if still is None:
        assert audited is None and len(recorded) == 1, (audited, recorded)
    else:  # the mutant landed on another declared contract
        assert audited == still and recorded == []


def test_the_auditor_passes_controls_and_stays_off_unless_armed(monkeypatch):
    frame = wire.pack("p2p.ping")
    assert wire.audit_frame({"t": "__bogus__"}, "in") is None  # disarmed
    recorded = []
    wire.arm("raise", lambda *a: recorded.append(a))
    try:
        assert wire.audit_frame(frame, "out", 16) == "p2p.ping"
        assert recorded == []
    finally:
        wire.disarm()
    monkeypatch.setenv("SDTPU_WIRE_AUDIT", "off")
    wire.arm("raise", lambda *a: recorded.append(a))
    assert not wire.armed()


@pytest.mark.parametrize("value", [
    {1: "int key", b"k": "bytes key", None: 0, True: [1, 2.5]},
    {"bin": b"\x00\xff", "str": "été", "empty": b"", "estr": ""},
    [2**64 - 1, -2**63, 1.5, -33, 255, 65536, "x" * 40, b"y" * 300],
    {"nested": [{"deep": {(1).to_bytes(1, "big"): [None]}}]},
])
def test_unpack_gives_what_msgpack_gives(value):
    raw = _packed(value)
    assert _msgpack.unpackb(raw) == _unpacked(raw)


@pytest.mark.parametrize("raw", [b"\xd4\x01\x00", b"\xc7\x02\x05ab"], ids=["fixext", "ext8"])
def test_ext_is_refused(raw):
    """msgpack hands back an ExtType, which no declared schema type takes;
    the port's codec refuses it at once."""
    assert isinstance(_unpacked(raw), msgpack.ExtType)
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)


@pytest.mark.parametrize("raw", [
    b"\x81\x91\x01\x02",        # a map keyed by an array
    b"\xa2\xff\xfe",            # a str that is not UTF-8
    b"\x93\x01\x02",            # an array that ends early
], ids=["array-key", "bad-utf8", "short"])
def test_unpack_refuses_what_msgpack_refuses(raw):
    with pytest.raises(Exception):
        _unpacked(raw)
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)


def test_iter_array_decodes_lazily():
    raw = _packed([[1, b"a", "c", b"p"]] * 3)
    it = _msgpack.iter_array(raw)
    assert next(it) == [1, b"a", "c", b"p"]
    assert list(it) == [[1, b"a", "c", b"p"]] * 2
    with pytest.raises(ValueError):
        list(_msgpack.iter_array(_packed({"a": 1})))
