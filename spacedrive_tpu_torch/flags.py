"""The port's environment knobs: the JAX package's names and defaults.

The port's own copy of the entries of ``spacedrive_tpu/flags.py`` that its
modules read: the store's group-commit actor (``store/actor.py``,
``store/db.py``), the location watcher (``locations/watcher.py``), the
budgets of sync and p2p (``timeouts.py``), the clone pass-through
(``p2p/sync_net.py``), the wire auditor (``p2p/wire.py``) and the
observability plane (``telemetry.py``, ``tracing.py``, ``chaos.py``,
``channels.py``, ``persist.py``, ``tasks.py``, ``sanitize.py``,
``health.py``, ``incidents.py``, ``ops/kernel_registry.py``). It
declares no knob the JAX package lacks. ``get`` parses the live
environment on every call (nothing is cached), so a test or a bench can
flip a knob mid-process as it can in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


def parse_str(v: str) -> str:
    return v


def parse_onoff(v: str) -> bool:
    """Kill-switch semantics: anything but off/0/false is on."""
    return v.strip().lower() not in ("off", "0", "false")


def parse_flag1(v: str) -> bool:
    """Opt-in semantics: only 1/on/true/yes enable."""
    return v.strip().lower() in ("1", "on", "true", "yes")


def parse_float(v: str) -> float:
    return float(v)


def parse_int(v: str) -> int:
    return int(v)


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str
    strict: bool = False  # unparseable raises instead of falling back


FLAGS: Dict[str, Flag] = {}


def declare(name: str, default: Any, parse: Callable[[str], Any], doc: str,
            strict: bool = False) -> None:
    FLAGS[name] = Flag(name, default, parse, doc, strict)


def raw(name: str):
    """The raw environment string, or None when unset (the flag must be
    declared)."""
    if name not in FLAGS:
        raise KeyError(f"undeclared flag {name!r} (declare it in spacedrive_tpu_torch/flags.py)")
    return os.environ.get(name)


def get(name: str) -> Any:
    """The parsed value from the environment; the default when unset,
    empty or (for a flag that is not strict) unparseable."""
    flag = FLAGS.get(name)
    if flag is None:
        raise KeyError(f"undeclared flag {name!r} (declare it in spacedrive_tpu_torch/flags.py)")
    v = os.environ.get(name)
    if v is None or v == "":
        return flag.default
    try:
        return flag.parse(v)
    except (ValueError, TypeError):
        if flag.strict:
            raise ValueError(f"{name}={v!r}: unparseable")
        return flag.default


declare(
    "SDTPU_STORE_ACTOR", True, parse_onoff,
    "Kill switch of the per-library group-commit write actor (store/actor.py): "
    "`off` makes Database.write_tx() one serialized tx() per batch. Read on "
    "every write_tx entry.")

declare(
    "SDTPU_STORE_GROUP_LATENCY_S", 0.004, float,
    "How long an open group that already coalesced two or more batches waits "
    "for stragglers before it commits. A group of one commits at once.")

declare(
    "SDTPU_STORE_GROUP_MAX", 32, int,
    "At most this many queued write batches coalesce into one transaction.",
    strict=True)

declare(
    "SDTPU_WATCHER", "", lambda v: v.strip().lower(),
    "`poll` forces the polling watcher even where inotify is available "
    "(locations/watcher.py).")

declare(
    "SDTPU_CLONE_PASSTHROUGH", True, parse_onoff,
    "Kill switch for the full-library-clone blob pass-through fast path "
    "(p2p/sync_net.py). `off` forces the per-op pull loop.")

declare(
    "SDTPU_TIMEOUT_SCALE", 1.0, float,
    "Global multiplier over every declared network-await budget "
    "(timeouts.py).")

declare(
    "SDTPU_WIRE_AUDIT", "auto", lambda v: v.strip().lower(),
    "Runtime wire auditor (p2p/wire.py): when armed, every frame crossing "
    "the tunnel in either direction is matched against its declared "
    "message contract. `off` skips arming (pack/unpack still validate).")

declare(
    "SDTPU_CHAN_SCALE", 1.0, parse_float,
    "Global multiplier over every declared channel capacity "
    "(channels.py registry; README's generated channel table lists "
    "the per-channel defaults). Read at channel construction, not "
    "per put.")

declare(
    "SDTPU_CHAOS", "", parse_str,
    "Chaos-plane arming spec (chaos.py): `<point>=<fault>[,...];...` "
    "with faults delay:<dur>[:<prob>] or one of error/drop/"
    "disconnect/wedge/corrupt[:<prob>], e.g. "
    "`p2p.tunnel.frame=drop:0.01,delay:50ms`. "
    "Point names must be declared fault points; undeclared names and "
    "kinds a point did not declare are REFUSED at parse. Read at "
    "import / chaos.rearm_from_env(); empty = disarmed (one flag "
    "check per injection site).")

declare(
    "SDTPU_CHAOS_SEED", 0, parse_int,
    "Deterministic RNG seed for the armed chaos plane (chaos.py): "
    "each fault point draws from its own Random seeded (seed, point "
    "name), so a failing storm replays exactly under the same seed "
    "regardless of how concurrent sites interleave.", strict=True)

declare(
    "SDTPU_HEALTH_INTERVAL_S", 5.0, parse_float,
    "Seconds between health-observatory sampler ticks (health.py, "
    "supervised under node/health): each tick spools delta-snapshots "
    "of every metric family into the health.series rings, re-"
    "evaluates per-subsystem saturation, and emits a HealthSnapshot "
    "event.")

declare(
    "SDTPU_HEALTH_TOPK", 3, parse_int,
    "Bottleneck-attribution depth of the health observatory "
    "(health.py): the top-k resources driving each non-ok subsystem "
    "state, ranked by severity then evidence score, served by "
    "node.health and rendered by tools/sd_top.py.", strict=True)

declare(
    "SDTPU_INCIDENTS", True, parse_onoff,
    "Incident observatory master switch (incidents.py): when on, "
    "Node bootstrap installs the process-global black box and wires "
    "every detection surface (health states, backoff give-ups, "
    "count-mode sanitizer violations, crash markers) to snapshot-"
    "freeze evidence bundles. `off` makes install() a no-op.")

declare(
    "SDTPU_INCIDENT_DEGRADED_WINDOWS", 3, parse_int,
    "Consecutive health samples a subsystem must hold `degraded` "
    "before the incident observatory opens a health.degraded bundle "
    "(incidents.py) — brief wobbles don't produce postmortems; "
    "`saturated` always fires immediately.", strict=True)

declare(
    "SDTPU_INCIDENT_STORE_MB", 16.0, parse_float,
    "Byte cap (MB) on the on-disk incident-bundle store "
    "(incidents.py): crossing it evicts oldest bundles first and "
    "counts sd_incident_dropped_total. The count cap is the declared "
    "incidents.store channel capacity.")

declare(
    "SDTPU_INCIDENT_WINDOW_S", 60.0, parse_float,
    "Per-fingerprint rate-limit window for incident bundles "
    "(incidents.py): repeat firings of the same subsystem + resource "
    "+ trigger kind inside the window collapse into "
    "sd_incident_deduped_total instead of new bundles.")

declare(
    "SDTPU_FS_AUDIT", "auto", lambda v: v.strip().lower(),
    "Runtime fs auditor (persist.py, armed with the sanitizer): "
    "interposes os.replace/os.fsync, checks the fsync-file -> rename "
    "-> fsync-dir ordering each declared artifact's policy promises, "
    "and flags raw product-module renames outside the persist seam "
    "(persist_undeclared_write / persist_unfsynced_rename — raised "
    "in tier-1, counted in production). `off` skips arming (plain "
    "os.replace/os.fsync, zero overhead); `auto` follows "
    "SDTPU_SANITIZE. Read once at sanitize.install().")

declare(
    "SDTPU_PERSIST_CRASHPOINT", "", parse_str,
    "`<artifact>:<edge>` — SIGKILL this process at the named "
    "declared durability edge inside the persist seam "
    "(persist.crashpoint). How tools/crash_grid.py children die at "
    "every edge of every declared artifact systematically; empty "
    "(default) disables the kill switch.")

declare(
    "SDTPU_LOG_JSON", False, parse_flag1,
    "When on, a JSON-line formatter is installed on the "
    "`spacedrive_tpu_torch` logger (tracing.install_json_logging): every "
    "record carries ts/level/logger/msg plus the CURRENT trace/span "
    "id (the tracing contextvar survives to_thread), so log lines "
    "correlate with node.spans and exported traces.")

declare(
    "SDTPU_LOG_RING", True, parse_onoff,
    "Bounded in-memory log ring (tracing.LogRing, capacity declared "
    "as the tracing.logring channel): installed at Node bootstrap "
    "next to the JSON formatter, it keeps the newest trace/span-"
    "stamped records in-process so incident bundles can freeze a log "
    "tail instead of pointing at unrecoverable stderr.")

declare(
    "SDTPU_PROFILE", None, parse_str,
    "Directory for a torch.profiler Chrome trace (CPU and CUDA activity); "
    "set → one process-wide profiler starts at the first device_span() "
    "and stop_profiler() writes the trace there (tracing.py; probed once "
    "per process, reset_profiler_cache() re-arms).")

declare(
    "SDTPU_SANITIZE", False, parse_flag1,
    "Opt-in runtime sanitizer (sanitize.py): event-loop stall "
    "detector, lock-order cycle check, write-lock-held-across-await "
    "assertion. Tier-1 runs with it on.")

declare(
    "SDTPU_SANITIZE_MODE", "count", lambda v: v.strip().lower(),
    "`raise` (tests): a detected violation raises at the detection "
    "point; `count` (production): violations only increment "
    "sd_sanitize_* telemetry and record into sanitize.violations().")

declare(
    "SDTPU_SANITIZE_STALL_S", 1.0, parse_float,
    "Event-loop stall threshold in seconds: one callback/task step "
    "hogging the loop longer than this is a sanitizer violation.")

declare(
    "SDTPU_SPAN_RING", 512, parse_int,
    "Capacity of the tracing span ring buffer (tracing.py "
    "recent_spans / node.spans / the flight-recorder export). Read "
    "once at import — the ring is module-global; "
    "tracing.configure_span_ring() re-reads it for tests/embedders.",
    strict=True)

declare(
    "SDTPU_TASK_REAP_S", 5.0, parse_float,
    "Grace period the task supervisor's shutdown reap (tasks.py, "
    "driven by Node.shutdown) waits for cancelled tasks before "
    "declaring them orphaned (a sanitizer violation).")

declare(
    "SDTPU_TELEMETRY", True, parse_onoff,
    "Kill switch for the node-wide metrics registry (telemetry.py): "
    "`off` reduces every increment to one flag check.")

declare(
    "SDTPU_TELEMETRY_INTERVAL", 15.0, parse_float,
    "Seconds between periodic TelemetrySnapshot events on the node "
    "event bus (node.py TelemetryReporter).")

declare(
    "SDTPU_TRANSFER_GUARD", "auto", lambda v: v.strip().lower(),
    "Device-to-host sync guard inside device_scope() regions "
    "(ops/kernel_registry.py, armed with the sanitizer): "
    "torch.cuda.set_sync_debug_mode — `auto` follows "
    "SDTPU_SANITIZE_MODE (raise -> error, count -> warn), "
    "`raise`/`log` force a level, `off` disables.")
