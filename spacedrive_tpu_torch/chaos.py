"""Chaos plane: declared fault injection for the robustness rails.

PRs 3-13 built every robustness surface this engine has — timeout
budgets, bounded channels with shed/coalesce policies, jobs admission
refusal, the supervisor ownership tree, the race recorder, and the
health/fleet observatories — but nothing ever injected a fault against
them, so the declared capacities and budgets were untested guesses and
the recovery paths were bare counters. This module is the registry the
whole repo's pattern demands for that gap: every injection site is a
DECLARED fault point (name, site, allowed kinds, doc) at the bottom of
THIS module, armed per-run through the `SDTPU_CHAOS` spec flag, drawn
from a SEEDED deterministic RNG so a failing storm replays exactly.

Spec grammar (`SDTPU_CHAOS`)::

    <point>=<fault>[,<fault>...][;<point>=...]
    fault := delay:<dur>[:<prob>]          # 50ms | 0.2s | bare seconds
           | error|drop|disconnect|wedge|corrupt[:<prob>]

e.g. ``p2p.tunnel.frame=drop:0.01,delay:50ms;store.commit=error:0.05``.
Undeclared point names and kinds outside a point's declared set are
REFUSED at parse (`ChaosSpecError`) — a typo'd storm must fail loudly,
not silently run fault-free.

Fault kinds (what a firing injection does at the seam):

- ``delay``      — sleep the parsed duration (latency weather);
- ``error``      — raise ``ChaosError`` (a ConnectionError subclass:
  recovery paths treat it exactly like a failed peer/resource);
- ``drop``       — the call site discards the operation (a lost frame,
  a swallowed page) and flow control must recover;
- ``disconnect`` — raise ``ChaosDisconnect`` (torn transport);
- ``wedge``      — park the seam (`WEDGE_S` sleep) so the call site's
  declared timeout budget is what frees it — the direct test of the
  timeouts.py table;
- ``corrupt``    — the call site tampers the payload bytes (AEAD tag
  failure on the peer, schema rejection upstream).

Every firing counts into ``sd_chaos_injected_total{name,kind}`` BEFORE
the effect lands, so an artifact can always reconcile observed
degradation against injected cause. Determinism: each armed fault
point draws from its own ``random.Random`` seeded from
(`SDTPU_CHAOS_SEED`, point name), so one site's draw sequence does not
depend on how other sites interleave.

Disarmed cost is the telemetry contract: `hit()` is one module-global
load + None check (<5 µs, budget-tested like telemetry's disabled
path). Sites pass `only=` to restrict a draw to the kinds that seam
can express (a recv path cannot drop an AEAD frame without desyncing
the counter nonce; it can delay, wedge, or disconnect).

Design constraints (same as timeouts.py/channels.py): stdlib +
flags/telemetry only, importable from every layer without cycles.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import flags
from .telemetry import CHAOS_INJECTED

__all__ = [
    "FaultPoint", "Fault", "FAULTS", "KINDS", "declare_fault",
    "ChaosError", "ChaosDisconnect", "ChaosSpecError",
    "arm", "disarm", "rearm_from_env", "armed", "armed_spec",
    "hit", "apply_async", "apply_sync", "fault_table_markdown",
    "WEDGE_S",
]

KINDS = ("delay", "error", "drop", "disconnect", "wedge", "corrupt")

# A wedged seam parks this long; the call site's declared budget (or
# the harness teardown cancelling the task) is what frees it — wedge
# exists precisely to prove those budgets fire.
WEDGE_S = 3600.0


class ChaosError(ConnectionError):
    """An injected `error` fault. ConnectionError subclass on purpose:
    every recovery path that tolerates a failed peer/resource already
    catches it — chaos must exercise those paths, not invent new
    exception plumbing."""


class ChaosDisconnect(ChaosError):
    """An injected `disconnect` fault (torn transport mid-operation)."""


class ChaosSpecError(ValueError):
    """A malformed/undeclared SDTPU_CHAOS spec entry (refused at
    parse — armed runs fail loudly, never silently fault-free)."""


@dataclass(frozen=True)
class FaultPoint:
    name: str                 # dotted id: "<layer>.<seam>"
    site: str                 # "module.py function" (docs/table)
    kinds: Tuple[str, ...]    # subset of KINDS this seam can express
    doc: str


@dataclass(frozen=True)
class Fault:
    """One firing: what `hit()` hands the call site."""
    name: str
    kind: str
    delay_s: float = 0.0      # parsed duration (delay kind only)


# Import-time declaration registry (same contract as TIMEOUTS /
# CHANNELS / BACKOFFS): bounded by the declarations at the bottom of
# this module, never by runtime traffic.
FAULTS: Dict[str, FaultPoint] = {}  # sdlint: ok[unbounded-growth]


def declare_fault(name: str, site: str, kinds: Sequence[str],
                  doc: str) -> FaultPoint:
    if name in FAULTS:
        raise ValueError(f"fault point {name!r} declared twice")
    if not kinds:
        raise ValueError(f"fault point {name!r}: no kinds")
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f"fault point {name!r}: unknown kind {k!r}")
    p = FaultPoint(name, site, tuple(kinds), doc)
    FAULTS[name] = p
    return p


# -- spec parsing ------------------------------------------------------------

def _parse_duration(s: str) -> float:
    s = s.strip().lower()
    try:
        if s.endswith("ms"):
            d = float(s[:-2]) / 1000.0
        elif s.endswith("s"):
            d = float(s[:-1])
        else:
            d = float(s)
    except ValueError:
        raise ChaosSpecError(f"bad duration {s!r} (want 50ms/0.2s/0.2)")
    # Range-checked AT PARSE like everything else in the grammar: a
    # negative delay would crash sync seams with time.sleep's
    # ValueError (and silently no-op async ones), inf/nan would be an
    # undeclared permanent wedge — `wedge` is the declared spelling.
    if not (0.0 <= d <= WEDGE_S):
        raise ChaosSpecError(
            f"bad duration {s!r}: must be within [0, {WEDGE_S:g}s] "
            "(use the `wedge` kind for park-forever)")
    return d


def _parse_prob(s: str, where: str) -> float:
    try:
        p = float(s)
    except ValueError:
        raise ChaosSpecError(f"{where}: bad probability {s!r}")
    if not 0.0 <= p <= 1.0:
        raise ChaosSpecError(f"{where}: probability {p} outside [0, 1]")
    return p


@dataclass(frozen=True)
class _ArmedFault:
    kind: str
    prob: float
    delay_s: float = 0.0


def parse_spec(spec: str) -> Dict[str, List[_ArmedFault]]:
    """`SDTPU_CHAOS` grammar → {point name: armed faults}. Refuses
    undeclared names and kinds a point did not declare."""
    out: Dict[str, List[_ArmedFault]] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, faults = entry.partition("=")
        name = name.strip()
        if not sep or not faults.strip():
            raise ChaosSpecError(
                f"chaos spec entry {entry!r}: want <point>=<fault>[,...]")
        point = FAULTS.get(name)
        if point is None:
            raise ChaosSpecError(
                f"chaos spec names undeclared fault point {name!r} "
                "(declare it in spacedrive_tpu_torch/chaos.py)")
        armed: List[_ArmedFault] = []
        for f in faults.split(","):
            parts = [p.strip() for p in f.strip().split(":")]
            kind = parts[0]
            if kind not in KINDS:
                raise ChaosSpecError(
                    f"{name}: unknown fault kind {kind!r}")
            if kind not in point.kinds:
                raise ChaosSpecError(
                    f"{name}: kind {kind!r} not declared for this "
                    f"point (declared: {', '.join(point.kinds)})")
            if kind == "delay":
                if len(parts) < 2:
                    raise ChaosSpecError(
                        f"{name}: delay needs a duration "
                        "(delay:<dur>[:<prob>])")
                if len(parts) > 3:
                    raise ChaosSpecError(
                        f"{name}: delay takes at most a duration and "
                        "a probability (delay:<dur>[:<prob>])")
                dur = _parse_duration(parts[1])
                prob = _parse_prob(parts[2], name) \
                    if len(parts) > 2 else 1.0
                armed.append(_ArmedFault("delay", prob, dur))
            else:
                if len(parts) > 2:
                    raise ChaosSpecError(
                        f"{name}: {kind} takes at most a probability")
                prob = _parse_prob(parts[1], name) \
                    if len(parts) > 1 else 1.0
                armed.append(_ArmedFault(kind, prob))
        out.setdefault(name, []).extend(armed)
    return out


# -- arming ------------------------------------------------------------------
# _ARMED is the hot-path switch: None = disarmed, and hit() pays ONE
# module-global load to find out (the telemetry disabled-path shape).
# Faults and their per-point RNGs live in ONE structure rebound
# atomically by arm()/disarm(), so a worker thread mid-hit() during a
# concurrent rearm always sees a consistent snapshot (never a spec
# whose RNG table was cleared under it). RNGs are seeded (seed, name)
# so each site's draw sequence is deterministic regardless of
# cross-site interleaving.

_ARMED: Optional[
    Dict[str, Tuple[List[_ArmedFault], random.Random]]] = None
_spec_str: str = ""
_seed: int = 0


def arm(spec: str, seed: Optional[int] = None) -> None:
    """Parse and install a chaos spec (refusing bad entries). An empty
    spec disarms."""
    global _ARMED, _spec_str, _seed
    parsed = parse_spec(spec) if spec else {}
    _seed = int(seed if seed is not None
                else flags.get("SDTPU_CHAOS_SEED"))
    armed = {name: (faults, random.Random(f"{_seed}:{name}"))
             for name, faults in parsed.items()}
    _spec_str = spec if parsed else ""
    _ARMED = armed or None


def disarm() -> None:
    global _ARMED, _spec_str
    _ARMED = None
    _spec_str = ""


def rearm_from_env() -> None:
    """Re-read SDTPU_CHAOS / SDTPU_CHAOS_SEED (process bootstrap and
    tests; import does the same once at the bottom of this module)."""
    arm(str(flags.get("SDTPU_CHAOS") or ""))


def armed() -> bool:
    return _ARMED is not None


def armed_spec() -> str:
    """The spec string currently armed ('' when disarmed) — what the
    load harness records into its artifact."""
    return _spec_str


def armed_point(name: str) -> bool:
    """True when the armed spec names this fault point. A zero-draw
    pre-check for sites that would otherwise loop hit() across large
    batches (the staging seam draws per ROW so a 0.1-probability EIO
    storm speckles a batch instead of all-or-nothing) — skipping the
    loop when disarmed keeps the hot path at one dict probe."""
    spec = _ARMED
    return spec is not None and name in spec


def hit(name: str, only: Optional[Sequence[str]] = None
        ) -> Optional[Fault]:
    """One draw at a fault point. Returns the Fault to apply, or None
    (disarmed, point not in the spec, or no probability fired).

    `only` restricts the draw to kinds this call site can express —
    an armed kind outside it is skipped WITHOUT consuming a random
    draw, so the same seed fires identically whichever sites filter.
    Every returned fault is already counted into
    sd_chaos_injected_total{name,kind}."""
    spec = _ARMED
    if spec is None:
        return None
    entry = spec.get(name)
    if entry is None:
        return None
    armed_faults, rng = entry
    for f in armed_faults:
        if only is not None and f.kind not in only:
            continue
        if f.prob < 1.0 and rng.random() >= f.prob:
            continue
        CHAOS_INJECTED.labels(name=name, kind=f.kind).inc()
        return Fault(name, f.kind, f.delay_s)
    return None


async def apply_async(f: Fault) -> bool:
    """Generic async effect for a drawn fault. Returns True when the
    call site must DROP the operation; `corrupt` also returns False —
    tampering is site-specific (the site knows its payload bytes)."""
    if f.kind == "delay":
        await asyncio.sleep(f.delay_s)
        return False
    if f.kind == "wedge":
        await asyncio.sleep(WEDGE_S)
        return False
    if f.kind == "drop":
        return True
    if f.kind == "disconnect":
        raise ChaosDisconnect(f"chaos: injected disconnect at {f.name}")
    if f.kind == "error":
        raise ChaosError(f"chaos: injected error at {f.name}")
    return False  # corrupt: the site tampers its own bytes


def apply_sync(f: Fault) -> bool:
    """`apply_async` for synchronous seams (store commit, off-loop
    ingest): delay/wedge block the calling thread — which is the
    injected symptom, never the event loop (the only callers are
    already off-loop by the blocking-async discipline)."""
    if f.kind == "delay":
        time.sleep(f.delay_s)
        return False
    if f.kind == "wedge":
        time.sleep(WEDGE_S)
        return False
    if f.kind == "drop":
        return True
    if f.kind == "disconnect":
        raise ChaosDisconnect(f"chaos: injected disconnect at {f.name}")
    if f.kind == "error":
        raise ChaosError(f"chaos: injected error at {f.name}")
    return False


def fault_table_markdown() -> str:
    """Generated fault-point table (docs/architecture.md §Chaos)."""
    out = ["| Fault point | Site | Kinds | Covers |",
           "| --- | --- | --- | --- |"]
    for name in sorted(FAULTS):
        p = FAULTS[name]
        doc = " ".join(p.doc.split())
        out.append(f"| `{name}` | {p.site} | {', '.join(p.kinds)} "
                   f"| {doc} |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# THE fault-point namespace. Keep alphabetical; every entry must be
# referenced by a chaos.hit("<name>") literal at ≥1 injection site —
# tests/test_chaos.py's static↔runtime drift check fails on a declared
# point nothing injects (and on an injection site naming an undeclared
# point).
# ---------------------------------------------------------------------------

declare_fault(
    "api.http.dispatch", "api/server.py _rspc_http",
    ("delay", "error"),
    "rspc HTTP dispatch on the API host, before the procedure runs: "
    "delay = a slow backend, error = a failing one. Fires inside the "
    "admission-controlled region, so storms drive the api.http."
    "inflight shed path.")

declare_fault(
    "api.ws.send", "api/server.py WsSubscriptionPump._drain",
    ("delay", "drop", "wedge"),
    "One websocket frame leaving a subscription pump: delay = a slow "
    "consumer, wedge = a dead one that never reads (the channel must "
    "shed, the pump must never wedge the node), drop = a lost frame.")

declare_fault(
    "fleet.poll", "fleet.py FleetMonitor._poll_peer",
    ("delay", "error", "wedge"),
    "A fleet-observatory obs.health fetch from one peer: wedge parks "
    "the fetch until the declared fleet.poll budget fires and the "
    "peer's row goes stale-degraded; disarming must let the row "
    "recover.")

declare_fault(
    "incidents.write", "incidents.py IncidentObservatory._write",
    ("delay",),
    "The WAL-style bundle write, drawn twice: once mid-body (a delay "
    "there widens the torn-.json.tmp window) and once after the full "
    "body lands but before the atomic rename (the complete-tmp "
    "window). The kill -9 recovery test parks the writer in each "
    "window and asserts restart recovers a valid bundle or none — "
    "never a torn final file.")

declare_fault(
    "p2p.tunnel.frame", "p2p/proto.py Tunnel.send/recv",
    ("delay", "drop", "disconnect", "wedge", "corrupt"),
    "One sealed frame crossing a tunnel. Send side can drop (lost "
    "frame — flow control recovers) or corrupt (AEAD tag failure on "
    "the peer); recv side delays/wedges/disconnects only (dropping a "
    "received AEAD frame would desync the counter nonce, which is a "
    "different bug than the one being injected).")

declare_fault(
    "p2p.tunnel.open", "p2p/manager.py P2PManager.open_stream",
    ("delay", "error", "wedge"),
    "Outbound dial + handshake: error = unreachable peer (the "
    "announce loop's declared backoff path), wedge = a half-open "
    "socket the p2p.connect deadline must free.")

declare_fault(
    "persist.crashpoint", "persist.py crashpoint (every durability edge)",
    ("delay",),
    "One declared durability edge inside the persist write seam "
    "(tmp-open / tmp-partial / tmp-full / fsync-file / renamed), "
    "drawn between every two steps of every atomic/WAL artifact "
    "write: a delay widens that window for racing killers, and "
    "SDTPU_PERSIST_CRASHPOINT=<artifact>:<edge> turns the same edge "
    "into a SIGKILL — how tools/crash_grid.py proves valid-or-absent "
    "recovery at every edge systematically.")

declare_fault(
    "stage.native.read", "ops/staging.py stage_batch_native",
    ("delay", "error", "corrupt"),
    "The native packed-staging seam, per ROW of a staged batch: error "
    "= EIO from a flaky disk, corrupt = a torn/short read (both flip "
    "the row's status so it degrades to the per-file Python reader — "
    "identify throughput drops, digests stay bit-identical, the ring "
    "never wedges); delay = once per batch, slow-disk weather on the "
    "stage lane.")

declare_fault(
    "store.commit", "store/db.py Database.tx",
    ("delay", "error"),
    "Write-transaction commit: error = sqlite BUSY (an external "
    "writer holding the file lock), absorbed by the declared "
    "store.busy backoff so injected BUSY degrades to latency instead "
    "of job failure; delay = slow fsync weather under the write lock.")

declare_fault(
    "store.group_commit", "store/actor.py WriteActor._run_group",
    ("delay", "error"),
    "A coalesced group on the single-writer actor, after every batch "
    "body ran and before COMMIT: delay parks the whole group with the "
    "write lock held (the kill -9 durability storm's window — every "
    "batch in the group must either commit atomically or vanish "
    "atomically across a crash), error fails the group to all its "
    "waiters (each one sees its transaction roll back, exactly like a "
    "raw tx() commit failure).")

declare_fault(
    "sync.clone.ack", "sync/ingest.py pump_clone_stream",
    ("delay", "drop", "disconnect"),
    "A clone-stream watermark ack leaving the receiver: drop leaves "
    "the originator's window full until its sync.clone.ack budget "
    "fires; the stream dies and the per-op pull loop finishes the "
    "tail.")

declare_fault(
    "sync.clone.page", "sync/clone_serve.py serve_clone_stream",
    ("delay", "drop", "disconnect", "wedge"),
    "One blob page leaving the windowed clone originator: disconnect "
    "is the mid-clone torn stream (reconnect must converge byte-"
    "identically from the receiver's durable watermark), drop is a "
    "lost page the ack window starves on, wedge parks the stream "
    "against the drain/ack budgets.")

declare_fault(
    "sync.ingest.apply", "sync/manager.py receive_crdt_operations",
    ("delay", "error"),
    "Remote-op ingest on the receiving replica: error fails the page "
    "like a poisoned batch (the pull loop's frozen-watermark recovery "
    "re-serves it), delay is slow-apply weather under storm.")


# Import-time arming from the environment (the same shape as
# telemetry's _ENABLED): a process started with SDTPU_CHAOS set runs
# armed; rearm_from_env()/arm()/disarm() re-decide for tests and the
# load harness.
rearm_from_env()
