"""Declared wire contracts: the registry of every cross-node message.

Port of ``spacedrive_tpu/p2p/wire.py``, every declaration identical (the
obs kinds included), so a frame is classified and validated alike on both
sides of a tunnel between a JAX node and a port node. Each frame kind that
crosses a tunnel (the p2p control headers, the obs plane, the sync pull
loop, the clone fast path, the spaceblock layer) is declared with its
schema, direction, size cap, proto-version group and the timeout budget
its exchange runs under:

- ``pack(name, **fields)`` builds a frame that cannot drift from its
  declaration (const discriminators filled in; unknown, missing or
  mistyped fields refused);
- ``unpack(name, frame)`` validates an inbound frame (unknown fields
  tolerated, version consts refused on mismatch with ``WireVersionError``,
  the size cap enforced where the transport gives the frame's size);
- ``audit_frame`` at the tunnel seam classifies and validates every frame
  in both directions once ``arm`` was called (``SDTPU_WIRE_AUDIT=off``
  keeps it off); the JAX package arms it with its sanitizer, which the
  port has not ported, and the port's tests arm it with a list;
- ``baseline_snapshot`` is the schema snapshot the JAX package's
  compatibility check commits.

Schema grammar (``{field: token}``): ``"str" | "int" | "bytes" | "bool" |
"float" | "list" | "dict" | "any"``, ``"?"`` appended for optional;
``"=<literal>"`` a const discriminator; ``"=proto"`` a version const
(``"=proto?"`` tolerates its absence). Bare-string frames are declared
with ``values=(...)``, raw binary frames with ``binary=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from .. import flags, timeouts

__all__ = [
    "MAX_FRAME", "PROTO_VERSIONS", "Field", "Message", "MESSAGES",
    "WireError", "WireSchemaError", "WireSizeError", "WireVersionError",
    "declare_message", "proto", "slice_cap", "message",
    "pack", "unpack", "classify", "audit_frame",
    "arm", "disarm", "armed", "wire_table_markdown", "baseline_snapshot",
]

# Transport sanity cap on one frame's payload: read_frame refuses
# anything larger before buffering it. Every declared size_cap sits at
# or below this; proto.py imports it from here so the transport bound
# and the contract bounds cannot drift.
MAX_FRAME = 64 * 1024 * 1024

_KIB, _MIB = 1024, 1024 * 1024

# One version per protocol GROUP (a message's name prefix): bump the
# group when any of its schemas changes shape. sync and clone share a
# number deliberately — the clone fast path is a sync-stream answer
# (a v2 sync peer would not understand v3's blob_stream frames), so
# they version together.
PROTO_VERSIONS: Dict[str, int] = {
    "p2p": 1,
    "obs": 1,
    "sync": 3,
    "clone": 3,
    "spaceblock": 1,
}

_TYPES: Dict[str, tuple] = {
    "str": (str,),
    "int": (int,),
    "bytes": (bytes, bytearray),
    "bool": (bool,),
    "float": (int, float),
    "list": (list, tuple),
    "dict": (dict,),
    "any": (object,),
}

_DIRECTIONS = ("dialer", "listener", "both")


class WireError(ValueError):
    """A frame broke its declared contract (or named no contract).
    A ValueError subclass: pre-registry decode sites raised plain
    ValueError for malformed frames, and their callers' handling
    still applies."""


class WireSchemaError(WireError):
    """Declared kind, payload drifted from its schema."""


class WireSizeError(WireError):
    """Frame larger than its declared size_cap."""


class WireVersionError(WireError):
    """Version const mismatch — the peer speaks another proto rev."""


@dataclass(frozen=True)
class Field:
    name: str
    type: str                      # key into _TYPES ("int" for consts)
    optional: bool = False
    const: Any = None              # literal value, or None
    is_proto: bool = False         # "=proto" version const


@dataclass(frozen=True)
class Message:
    name: str                      # dotted, first segment == group
    group: str                     # PROTO_VERSIONS key
    version: int
    direction: str                 # which tunnel side sends it
    fields: Tuple[Field, ...]      # empty for values/binary frames
    values: Optional[Tuple[str, ...]]   # bare-string frames
    binary: bool                   # raw-bytes frames (send_raw)
    size_cap: int                  # payload bytes, <= MAX_FRAME
    slice_cap: Optional[int]       # per-reply item cap (obs slices)
    timeout_budget: str            # timeouts.py registry name
    doc: str

    def field(self, name: str) -> Optional[Field]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    def schema_tokens(self) -> Dict[str, str]:
        """The declaration's schema dict, re-rendered token-for-token
        (what wire_baseline.json snapshots)."""
        out: Dict[str, str] = {}
        for f in self.fields:
            if f.is_proto:
                tok = "=proto?" if f.optional else "=proto"
            elif f.const is not None:
                tok = f"={f.const}"
            else:
                tok = f.type + ("?" if f.optional else "")
            out[f.name] = tok
        return out


# name -> Message. Grow-only by design: the registry IS the protocol
# inventory; messages retire via an explicit declaration removal plus
# a baseline regeneration, never at runtime.
MESSAGES: Dict[str, Message] = {}

# (discriminator field, value) -> message name, for classification.
_CONST_INDEX: Dict[Tuple[str, Any], str] = {}
# bare-string value -> message name.
_VALUE_INDEX: Dict[str, str] = {}


def _parse_field(name: str, token: Any) -> Field:
    if not isinstance(name, str) or not name:
        raise ValueError(f"wire schema field name {name!r} invalid")
    if not isinstance(token, str) or not token:
        raise ValueError(
            f"wire schema token for {name!r} must be a non-empty str, "
            f"got {token!r}")
    if token in ("=proto", "=proto?"):
        return Field(name, "int", optional=token.endswith("?"),
                     is_proto=True)
    if token.startswith("="):
        lit = token[1:]
        if not lit:
            raise ValueError(f"empty const token for field {name!r}")
        return Field(name, "str", const=lit)
    optional = token.endswith("?")
    base = token[:-1] if optional else token
    if base not in _TYPES:
        raise ValueError(
            f"unknown wire schema type {base!r} for field {name!r} "
            f"(one of {sorted(_TYPES)})")
    return Field(name, base, optional=optional)


def declare_message(name: str, proto: str, direction: str,
                    schema: Optional[Dict[str, str]] = None, *,
                    size_cap: int, timeout_budget: str, doc: str,
                    values: Optional[Tuple[str, ...]] = None,
                    binary: bool = False,
                    slice_cap: Optional[int] = None) -> Message:
    """Declare one cross-node message kind. Called at import time from
    the bottom of THIS module only (the wire-discipline pass holds the
    declarations literal and central)."""
    segments = name.split(".")
    if len(segments) < 2 or not all(
            s and s.replace("_", "a").isalnum() and s == s.lower()
            for s in segments):
        raise ValueError(
            f"wire message name {name!r} must be dotted lower_snake "
            "with at least two segments")
    if name in MESSAGES:
        raise ValueError(f"wire message {name!r} declared twice")
    if proto not in PROTO_VERSIONS:
        raise ValueError(
            f"{name}: unknown proto group {proto!r} "
            f"(one of {sorted(PROTO_VERSIONS)})")
    if segments[0] != proto:
        raise ValueError(
            f"{name}: name prefix must equal its proto group {proto!r}")
    if direction not in _DIRECTIONS:
        raise ValueError(
            f"{name}: direction {direction!r} not in {_DIRECTIONS}")
    if sum((schema is not None, values is not None, bool(binary))) != 1:
        raise ValueError(
            f"{name}: exactly one of schema/values/binary required")
    if not isinstance(size_cap, int) or not 0 < size_cap <= MAX_FRAME:
        raise ValueError(
            f"{name}: size_cap must be an int in (0, {MAX_FRAME}]")
    if slice_cap is not None and (
            not isinstance(slice_cap, int) or slice_cap <= 0):
        raise ValueError(f"{name}: slice_cap must be a positive int")
    if timeout_budget not in timeouts.TIMEOUTS:
        raise ValueError(
            f"{name}: timeout_budget {timeout_budget!r} is not a "
            "declared budget (timeouts.py)")
    if not doc:
        raise ValueError(f"{name}: doc required")

    fields: Tuple[Field, ...] = ()
    if schema is not None:
        fields = tuple(_parse_field(k, v) for k, v in schema.items())
    if values is not None:
        if not values or not all(
                isinstance(v, str) and v for v in values):
            raise ValueError(
                f"{name}: values must be a non-empty tuple of strings")
        for v in values:
            if v in _VALUE_INDEX:
                raise ValueError(
                    f"{name}: bare-string value {v!r} already claimed "
                    f"by {_VALUE_INDEX[v]}")

    msg = Message(name=name, group=proto, version=PROTO_VERSIONS[proto],
                  direction=direction, fields=fields,
                  values=tuple(values) if values else None,
                  binary=bool(binary), size_cap=size_cap,
                  slice_cap=slice_cap, timeout_budget=timeout_budget,
                  doc=doc)
    MESSAGES[name] = msg
    for f in fields:
        if f.const is not None and f.name in ("t", "kind"):
            key = (f.name, f.const)
            if key in _CONST_INDEX:
                raise ValueError(
                    f"{name}: discriminator {key!r} already claimed "
                    f"by {_CONST_INDEX[key]}")
            _CONST_INDEX[key] = name
    if values:
        for v in values:
            _VALUE_INDEX[v] = name
    return msg


def message(name: str) -> Message:
    try:
        return MESSAGES[name]
    except KeyError:
        raise WireError(
            f"undeclared wire message {name!r} (declare it in "
            "p2p/wire.py)") from None


def proto(group: str) -> int:
    """The group's wire version — the one source SYNC_PROTO, the clone
    stream, and the obs envelopes all read."""
    try:
        return PROTO_VERSIONS[group]
    except KeyError:
        raise KeyError(
            f"unknown wire proto group {group!r} "
            f"(one of {sorted(PROTO_VERSIONS)})") from None


def slice_cap(name: str) -> int:
    """A declared message's per-reply item cap (obs slice limits)."""
    cap = message(name).slice_cap
    if cap is None:
        raise KeyError(f"wire message {name!r} declares no slice_cap")
    return cap


def _type_ok(f: Field, value: Any) -> bool:
    if f.type == "any":
        return True
    if f.type in ("int", "float") and isinstance(value, bool):
        return False
    return isinstance(value, _TYPES[f.type])


def pack(name: str, /, **fields: Any) -> Any:
    """Build a frame that cannot drift from its declaration: const
    discriminators (including version fields) are filled in, unknown /
    missing / mistyped fields are refused. Returns the msgpack-ready
    value (dict for schema frames, str for values frames, bytes for
    binary frames — values/binary take a single `value=` kwarg).
    The message name is positional-only: a schema may legitimately
    declare a field called `name` (spaceblock.request does)."""
    msg = message(name)
    if msg.values is not None or msg.binary:
        if set(fields) != {"value"}:
            raise WireSchemaError(
                f"{name}: pack takes exactly one kwarg `value`")
        value = fields["value"]
        _check_scalar(msg, value)
        return value
    out: Dict[str, Any] = {}
    declared = {f.name for f in msg.fields}
    for k in fields:
        if k not in declared:
            raise WireSchemaError(
                f"{name}: field {k!r} not in the declared schema")
    for f in msg.fields:
        if f.is_proto:
            out[f.name] = msg.version
            continue
        if f.const is not None:
            given = fields.get(f.name, f.const)
            if given != f.const:
                raise WireSchemaError(
                    f"{name}: const field {f.name!r} must be "
                    f"{f.const!r}, got {given!r}")
            out[f.name] = f.const
            continue
        if f.name not in fields or fields[f.name] is None:
            if not f.optional:
                raise WireSchemaError(
                    f"{name}: required field {f.name!r} missing")
            if f.name in fields:
                out[f.name] = None  # explicit optional None rides along
            continue
        value = fields[f.name]
        if not _type_ok(f, value):
            raise WireSchemaError(
                f"{name}: field {f.name!r} must be {f.type}, got "
                f"{type(value).__name__}")
        out[f.name] = value
    return out


def _check_scalar(msg: Message, frame: Any) -> None:
    """Validate a values/binary frame's payload."""
    if msg.values is not None:
        if not isinstance(frame, str):
            raise WireSchemaError(
                f"{msg.name}: expected a bare string, got "
                f"{type(frame).__name__}")
        if frame not in msg.values:
            raise WireSchemaError(
                f"{msg.name}: value {frame!r} not in declared "
                f"{msg.values}")
        if len(frame.encode()) > msg.size_cap:
            raise WireSizeError(
                f"{msg.name}: value over the declared "
                f"{msg.size_cap}-byte cap")
        return
    # binary
    if not isinstance(frame, (bytes, bytearray)):
        raise WireSchemaError(
            f"{msg.name}: expected raw bytes, got "
            f"{type(frame).__name__}")
    if not frame:
        raise WireSchemaError(f"{msg.name}: empty binary frame")
    if len(frame) > msg.size_cap:
        raise WireSizeError(
            f"{msg.name}: {len(frame)} bytes over the declared "
            f"{msg.size_cap}-byte cap")


def unpack(name: str, frame: Any, *, size: Optional[int] = None) -> Any:
    """Validate an inbound frame against its declared contract and
    return it. Unknown fields are TOLERATED (forward compatibility: a
    newer peer may send more than we know); missing required fields,
    type drift, and const mismatches are refused; a version const from
    another rev raises WireVersionError (the polite-refusal idiom
    catches exactly that); `size` (the transport's payload byte count)
    enforces the declared size_cap."""
    msg = message(name)
    if size is not None and size > msg.size_cap:
        raise WireSizeError(
            f"{name}: {size}-byte frame over the declared "
            f"{msg.size_cap}-byte cap")
    if msg.values is not None or msg.binary:
        _check_scalar(msg, frame)
        return frame
    if not isinstance(frame, dict):
        raise WireSchemaError(
            f"{name}: expected a map frame, got "
            f"{type(frame).__name__}")
    for f in msg.fields:
        if f.name not in frame:
            if f.optional or (f.is_proto and f.optional):
                continue
            if f.is_proto:
                raise WireVersionError(
                    f"{name}: version field {f.name!r} missing")
            raise WireSchemaError(
                f"{name}: required field {f.name!r} missing")
        value = frame[f.name]
        if f.is_proto:
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value != msg.version:
                raise WireVersionError(
                    f"{name}: peer wire proto {value!r} != ours "
                    f"{msg.version}")
            continue
        if f.const is not None:
            if value != f.const:
                raise WireSchemaError(
                    f"{name}: const field {f.name!r} is {value!r}, "
                    f"declared {f.const!r}")
            continue
        if value is None:
            if f.optional:
                continue
            raise WireSchemaError(
                f"{name}: required field {f.name!r} is None")
        if not _type_ok(f, value):
            raise WireSchemaError(
                f"{name}: field {f.name!r} must be {f.type}, got "
                f"{type(value).__name__}")
    return frame


def classify(frame: Any) -> Tuple[str, ...]:
    """Candidate declared names for an arbitrary frame, best-first.

    Dict frames match on their const discriminators (`t` / `kind`),
    most-specific first; dict frames with NO declared discriminator
    (response envelopes) fall back to structural matching on required
    fields. Bare strings match the values index; bytes match binary
    messages. Empty tuple = undeclared."""
    if isinstance(frame, str):
        name = _VALUE_INDEX.get(frame)
        return (name,) if name else ()
    if isinstance(frame, (bytes, bytearray)):
        return tuple(n for n, m in MESSAGES.items() if m.binary)
    if not isinstance(frame, dict):
        return ()
    scored = []
    for name, msg in MESSAGES.items():
        if msg.values is not None or msg.binary:
            continue
        consts = [f for f in msg.fields
                  if f.const is not None and f.name in ("t", "kind")]
        if consts:
            if all(frame.get(f.name) == f.const for f in consts):
                scored.append((len(consts), name))
            continue
        required = [f for f in msg.fields
                    if not f.optional and f.const is None
                    and not f.is_proto]
        if required and all(f.name in frame for f in required):
            scored.append((0, name))
    scored.sort(key=lambda t: (-t[0], t[1]))
    best = [n for s, n in scored if s > 0]
    return tuple(best) if best else tuple(n for _, n in scored)


# -- runtime twin (armed by sanitize.install) --------------------------------

_armed = False
_mode = "count"
_recorder: Optional[Callable[[str, str, bool], None]] = None


def armed() -> bool:
    return _armed


def arm(mode: str, record: Callable[[str, str, bool], None]) -> None:
    """Arm the frame auditor. `record(kind, detail, may_raise)` receives
    each violation. SDTPU_WIRE_AUDIT=off skips arming entirely
    (pack/unpack still validate)."""
    global _armed, _mode, _recorder
    if flags.get("SDTPU_WIRE_AUDIT") == "off":
        return
    _armed = True
    _mode = mode
    _recorder = record


def disarm() -> None:
    global _armed, _recorder
    _armed = False
    _recorder = None


def _report(kind: str, detail: str) -> None:
    rec = _recorder
    if rec is not None:
        rec("wire_violation", detail, True)


def audit_frame(frame: Any, direction: str,
                nbytes: Optional[int] = None) -> Optional[str]:
    """The tunnel-seam auditor: classify + validate one frame in
    either direction. Returns the matched declared name, or None when
    disarmed or in violation (which goes to the armed recorder; the
    frame itself is never torn by its observer)."""
    if not _armed:
        return None
    names = classify(frame)
    if not names:
        _report("undeclared",
                f"wire: undeclared {direction} frame {_clip(frame)}")
        return None
    errors = []
    for name in names:
        try:
            unpack(name, frame, size=nbytes)
        except WireError as e:
            errors.append(e)
            continue
        return name
    if any(isinstance(e, WireVersionError) for e in errors):
        kind = "proto_skew"
    elif any(isinstance(e, WireSizeError) for e in errors):
        kind = "size_cap"
    else:
        kind = "schema"
    _report(kind, f"wire: {direction} frame failed "
                  f"{'/'.join(names)}: {errors[0]}")
    return None


def _clip(frame: Any, limit: int = 160) -> str:
    s = repr(frame)
    return s if len(s) <= limit else s[:limit] + "…"


# -- generated docs / snapshots ----------------------------------------------

def wire_table_markdown() -> str:
    """README's generated wire-contract inventory (one row per
    declared message)."""
    lines = [
        "| message | proto | sender | payload | size cap | budget |",
        "|---|---|---|---|---|---|",
    ]
    for name in sorted(MESSAGES):
        m = MESSAGES[name]
        if m.values is not None:
            payload = "one of " + " / ".join(
                f"`{v}`" for v in m.values)
        elif m.binary:
            payload = "raw bytes"
        else:
            payload = ", ".join(
                f"`{f}={tok}`" for f, tok in
                m.schema_tokens().items())
        if m.slice_cap is not None:
            payload += f" (slice cap {m.slice_cap})"
        cap = (f"{m.size_cap // _MIB} MiB" if m.size_cap >= _MIB
               else f"{m.size_cap // _KIB} KiB")
        lines.append(
            f"| `{name}` | {m.group} v{m.version} | {m.direction} "
            f"| {payload} | {cap} | `{m.timeout_budget}` |")
    return "\n".join(lines)


def baseline_snapshot() -> Dict[str, Dict[str, Any]]:
    """The proto-compat pass's committed snapshot shape
    (tools/sdlint/wire_baseline.json): schema + caps per version, so
    a shape change without a version bump is a build failure."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(MESSAGES):
        m = MESSAGES[name]
        if m.values is not None:
            payload: Any = {"values": list(m.values)}
        elif m.binary:
            payload = {"binary": True}
        else:
            payload = {"schema": m.schema_tokens()}
        out[name] = {"proto": m.group, "version": m.version,
                     "size_cap": m.size_cap, **payload}
        if m.slice_cap is not None:
            out[name]["slice_cap"] = m.slice_cap
    return out


# ---------------------------------------------------------------------------
# The inventory. Every cross-node frame kind, declared once, literal
# args only (the sdlint passes parse these calls cross-AST; a computed
# declaration is invisible to them and fails wire-discipline).
# ---------------------------------------------------------------------------

declare_message(
    "p2p.handshake.hello", "p2p", "both",
    {"identity": "bytes", "ephemeral": "bytes", "nonce": "bytes",
     "sig": "bytes"},
    size_cap=4096, timeout_budget="p2p.handshake",
    doc="Signed ephemeral key exchange, one per side, BEFORE the "
        "tunnel exists — the only frame that crosses in the clear "
        "(proto.tunnel_handshake verifies the signature).")

declare_message(
    "p2p.ping", "p2p", "dialer",
    {"t": "=ping", "tp": "str?"},
    size_cap=4096, timeout_budget="p2p.ping",
    doc="Liveness probe; the whole exchange runs under the p2p.ping "
        "budget (manager.ping).")

declare_message(
    "p2p.pong", "p2p", "listener",
    {"t": "=pong"},
    size_cap=4096, timeout_budget="p2p.ping",
    doc="Ping answer.")

declare_message(
    "p2p.pair.request", "p2p", "dialer",
    {"t": "=pair", "tp": "str?", "library_id": "str",
     "library_name": "str", "listen_port": "int", "instance": "dict"},
    size_cap=64 * 1024, timeout_budget="p2p.pair",
    doc="Pairing offer: signed instance row + the dialer's LISTENING "
        "port (the TCP source port is ephemeral) so the responder "
        "derives a route back.")

declare_message(
    "p2p.pair.response", "p2p", "listener",
    {"status": "str", "instance": "dict?"},
    size_cap=64 * 1024, timeout_budget="p2p.pair",
    doc="Pairing verdict: status accepted (with the responder's "
        "instance row) or rejected.")

declare_message(
    "p2p.spacedrop.offer", "p2p", "dialer",
    {"t": "=spacedrop", "req": "dict", "tp": "str?"},
    size_cap=64 * 1024, timeout_budget="p2p.spacedrop.verdict",
    doc="File-drop offer carrying an embedded spaceblock.request; the "
        "receiver's interactive decision runs under "
        "p2p.spacedrop.decide, the offerer waits under "
        "p2p.spacedrop.verdict.")

declare_message(
    "p2p.spacedrop.verdict", "p2p", "listener",
    values=("accept", "reject"),
    size_cap=4096, timeout_budget="p2p.spacedrop.verdict",
    doc="Bare-string spacedrop verdict; `accept` is followed by "
        "spaceblock chunks.")

declare_message(
    "p2p.file.request", "p2p", "dialer",
    {"t": "=file", "library_id": "str", "location_pub_id": "bytes",
     "file_path_pub_id": "bytes", "range_start": "int?",
     "range_end": "int?", "tp": "str?"},
    size_cap=64 * 1024, timeout_budget="p2p.file.response",
    doc="Files-over-p2p fetch, rows addressed by synced pub_ids "
        "(local autoincrement ids never cross the wire).")

declare_message(
    "p2p.file.response", "p2p", "listener",
    {"status": "str", "req": "dict?"},
    size_cap=64 * 1024, timeout_budget="p2p.file.response",
    doc="File-request answer: status ok (with the embedded "
        "spaceblock.request the chunk stream will follow) or "
        "not_found.")

declare_message(
    "obs.metrics", "obs", "dialer",
    {"t": "=obs.metrics", "proto": "=proto?", "tp": "str?",
     "limit": "int?"},
    size_cap=4096, timeout_budget="p2p.obs",
    doc="Fleet-plane request for the whole telemetry registry "
        "snapshot. The version const is optional-on-the-wire: the "
        "in-process loopback transports omit it.")

declare_message(
    "obs.health", "obs", "dialer",
    {"t": "=obs.health", "proto": "=proto?", "tp": "str?",
     "limit": "int?"},
    size_cap=4096, timeout_budget="p2p.obs",
    doc="Fleet-plane request for the latest HealthSnapshot.")

declare_message(
    "obs.trace", "obs", "dialer",
    {"t": "=obs.trace", "proto": "=proto?", "tp": "str?",
     "limit": "int?", "trace": "str?"},
    size_cap=4096, timeout_budget="p2p.obs", slice_cap=8192,
    doc="Fleet-plane request for a span-ring + flight-timeline slice, "
        "optionally filtered to one trace id; the responder clamps "
        "`limit` to the declared slice cap (the old "
        "TRACE_SLICE_LIMIT, now a registry read).")

declare_message(
    "obs.incidents", "obs", "dialer",
    {"t": "=obs.incidents", "proto": "=proto?", "tp": "str?",
     "limit": "int?"},
    size_cap=4096, timeout_budget="p2p.obs", slice_cap=256,
    doc="Fleet-plane request for incident-bundle HEADERS "
        "(newest-first, clamped to the declared slice cap — full "
        "bundles never cross the fleet plane unsolicited).")

declare_message(
    "obs.response", "obs", "listener",
    {"status": "str", "proto": "=proto", "what": "str?", "node": "dict?",
     "ts": "float?", "error": "str?", "metrics": "dict?",
     "health": "dict?", "incidents": "list?", "spans": "list?",
     "timeline": "list?"},
    size_cap=16 * 1024 * 1024, timeout_budget="p2p.obs",
    doc="Every obs answer: one envelope (status/proto/what/node/ts) "
        "plus the payload key its request kind declares — metrics | "
        "health | incidents | spans+timeline — or status=error with "
        "`error`. The version const is REQUIRED here: a stale-proto "
        "peer must degrade to a labeled stale row, never corrupt the "
        "merged fleet view.")

declare_message(
    "sync.announce", "sync", "dialer",
    {"t": "=sync", "kind": "=new_ops", "library_id": "str",
     "proto": "=proto", "tp": "str?"},
    size_cap=4096, timeout_budget="p2p.frame_send",
    doc="NewOperations: the originator has ops for this library; the "
        "responder drives the pull loop back over the same tunnel. "
        "Version checked in BOTH directions (see sync_net.py).")

declare_message(
    "sync.pull.request", "sync", "listener",
    {"kind": "=messages", "clocks": "list", "count": "int",
     "proto": "=proto", "tp": "str?"},
    size_cap=1024 * 1024, timeout_budget="sync.pull.request",
    doc="GetOperations: the puller's watermark clock vector + page "
        "size; the originator refuses to SERVE a version skew (a "
        "stale decoder would corrupt its replica's op log).")

declare_message(
    "sync.pull.page", "sync", "dialer",
    {"ops": "list", "has_more": "bool"},
    size_cap=32 * 1024 * 1024, timeout_budget="sync.pull.page",
    doc="One page of row-format CRDT ops answering a pull request; "
        "has_more drives the puller's next request.")

declare_message(
    "sync.done", "sync", "both",
    {"kind": "=done"},
    size_cap=4096, timeout_budget="p2p.frame_send",
    doc="Stream close: the puller finished ingesting, or the "
        "responder refuses the announce (unknown library / version "
        "skew).")

declare_message(
    "clone.stream", "clone", "dialer",
    {"kind": "=blob_stream", "window": "int"},
    size_cap=4096, timeout_budget="sync.clone.frame",
    doc="Clone fast-path opener answering a fresh peer's pull "
        "request: the windowed blob-page stream follows, `window` "
        "pages in flight per watermark ack.")

declare_message(
    "clone.ops", "clone", "dialer",
    {"kind": "=clone_ops", "ops": "list"},
    size_cap=32 * 1024 * 1024, timeout_budget="sync.clone.frame",
    doc="Interleaved row-format ops that must precede a page's "
        "watermark advance (ingested per-op on the receiver).")

declare_message(
    "clone.page", "clone", "dialer",
    {"kind": "=blob_page", "model": "str", "instance": "bytes",
     "min_ts": "int", "max_ts": "int", "n_ops": "int", "data": "bytes"},
    size_cap=48 * 1024 * 1024, timeout_budget="sync.clone.frame",
    doc="One stored blob page relayed VERBATIM (no per-op "
        "materialization); the receiver's batched apply commits it "
        "in one transaction, or falls back per-op on proof failure.")

declare_message(
    "clone.ack", "clone", "listener",
    {"kind": "=ack", "ts": "int", "fast": "bool"},
    size_cap=4096, timeout_budget="sync.clone.ack",
    doc="Per-page watermark ack: `ts` is the receiver's DURABLY "
        "committed watermark (a torn stream resumes exactly there); "
        "`fast` reports whether the batched apply held.")

declare_message(
    "clone.done", "clone", "dialer",
    {"kind": "=blob_done"},
    size_cap=4096, timeout_budget="p2p.frame_send",
    doc="Clean end of the blob phase; the puller re-requests with "
        "advanced clocks and the per-op loop serves the row tail.")

declare_message(
    "spaceblock.request", "spaceblock", "both",
    {"name": "str", "size": "int", "range_start": "int?",
     "range_end": "int?"},
    size_cap=64 * 1024, timeout_budget="p2p.transfer.chunk",
    doc="Block-transfer descriptor (BEP-style), embedded in "
        "spacedrop offers and file responses; block size derives "
        "from `size`.")

declare_message(
    "spaceblock.verdict", "spaceblock", "both",
    values=("ok", "cancel"),
    size_cap=4096, timeout_budget="p2p.transfer.chunk",
    doc="Bare-string per-block ack from the receiving side: `ok` "
        "releases the next block, `cancel` tears the transfer down "
        "mid-stream.")

declare_message(
    "spaceblock.chunk", "spaceblock", "both",
    binary=True,
    size_cap=4 * 1024 * 1024, timeout_budget="p2p.transfer.chunk",
    doc="Raw file block (send_raw/recv_raw, no msgpack): at most one "
        "4 MiB block (block_size_from_file_size's ceiling), each "
        "acked before the next.")
