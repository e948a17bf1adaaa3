"""Incident observatory: always-on black-box capture + evidence bundles.

The observability plane before this module was live-poll only: sd_top,
node.health, and the flight recorder answer "what is wrong NOW", but
the bounded rings they read age out in minutes (health.series sheds at
~10 min, the span ring at 512 records) — a storm, give-up, sanitizer
violation, or crash that happens while nobody is watching leaves no
postmortem. This module is the flight-data-recorder half: every
detection surface the registries already expose notifies the
observatory, and each distinct trouble fingerprint snapshot-freezes a
causal evidence BUNDLE — durably, rate-limited, and federable.

Triggers (the declared ``TRIGGERS`` table; the static↔runtime drift
test in tests/test_incidents.py pins that every declared kind has a
fire site and every fire site names a declared kind):

- ``health.saturated``  — a health subsystem entered ``saturated``
  (health.py sample() notifies after every evaluation, outside its
  lock);
- ``health.degraded``   — a subsystem held ``degraded`` for >=
  SDTPU_INCIDENT_DEGRADED_WINDOWS consecutive samples (brief wobbles
  don't open incidents; persistent ones do);
- ``backoff.give_up``   — a declared retry ladder exhausted
  (timeouts.Backoff.next_delay notifies once per exhausted ladder,
  exactly when sd_backoff_gave_up_total increments);
- ``sanitize.violation`` / ``task.exception`` / ``task.orphaned`` —
  a sanitizer detection in COUNT mode (raise mode already hands the
  evidence to the raiser; counting mode is production, where the
  violation would otherwise be one counter tick nobody saw);
- ``crash``             — the previous process died without running
  close(): a ``.running`` marker left in the store directory is
  noticed at next boot, and any partially-written bundle is recovered
  WAL-style (a torn ``.json.tmp`` is discarded, a complete one is
  promoted — never a torn final file).

A bundle carries the triggering attribution with its windowed
evidence, the relevant health-snapshot tails, the flight-recorder
timeline slice and span ring filtered to the implicated trace ids,
the chaos/backoff/timeout/shed counter families, the SQL
top-statements stage, a bounded log-ring tail (tracing.LogRing,
trace-id-stamped), and node identity / non-default flags / capacity
profile — enough to triage without the process that produced it.

Bundles are fingerprinted (subsystem + resource + trigger kind) for
dedup: repeat firings inside SDTPU_INCIDENT_WINDOW_S collapse into
sd_incident_deduped_total instead of new files. The on-disk store has
declared-channel semantics (``incidents.store``, shed_oldest): the
header index IS a registry channel whose eviction hook deletes the
evicted bundle's file, and a byte cap (SDTPU_INCIDENT_STORE_MB)
evicts oldest-first below the count cap — the store never grows past
its declared bounds. Surfaces: rspc ``incidents.list/get/ack`` + the
``incidents`` ws subscription (api/procedures.py), fleet federation
(``obs.incidents`` in p2p/obs.py; FleetMonitor pulls peers' bundle
headers, ``sd_top --fleet`` shows the INC column), and the
tools/sd_incidents.py CLI (list/show/diff/validate/self-check).
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import channels, chaos, flags, persist, telemetry, tracing
from .telemetry import (
    INCIDENTS_DEDUPED,
    INCIDENTS_DROPPED,
    INCIDENTS_OPENED,
    INCIDENTS_RECOVERED,
    INCIDENT_OPEN,
    INCIDENT_STORE_BYTES,
)

__all__ = [
    "TRIGGERS", "BUNDLE_SCHEMA", "IncidentObservatory",
    "validate_incident_bundle", "validate_incident_header",
    "install", "current", "uninstall",
]

BUNDLE_SCHEMA = 1

# Evidence bounds per bundle: a bundle is a postmortem slice, not a
# full dump — each section is capped so a storm of incidents cannot
# turn the store cap into a handful of giant files.
SPAN_LIMIT = 128
TIMELINE_LIMIT = 256
LOG_LIMIT = 128
TRACE_ID_LIMIT = 8          # implicated traces folded into one bundle
SQL_TOP = 3

# Counter families frozen into every bundle: the injected-cause /
# observed-effect reconciliation set (chaos, backoff, timeout, shed)
# plus the observatory's own families so a bundle shows the dedup and
# eviction pressure it was born under.
COUNTER_FAMILY_PREFIXES = (
    "sd_chaos_", "sd_backoff_", "sd_timeout_", "sd_chan_shed",
    "sd_sanitize_", "sd_task_", "sd_incident_",
)

# ---------------------------------------------------------------------------
# THE trigger namespace. Keep alphabetical; every entry must be fired
# by a `_fire("<kind>", ...)` literal (or the sanitizer kind map below)
# somewhere in the tree, and every fire site must name a declared kind
# — tests/test_incidents.py walks the AST both ways, the same drift
# gate the chaos fault points get.
# ---------------------------------------------------------------------------

TRIGGERS: Dict[str, str] = {
    "backoff.give_up":
        "A declared retry ladder exhausted its max_tries "
        "(timeouts.Backoff) — the operation stopped retrying and "
        "degraded; the bundle names the policy as its resource.",
    "crash":
        "The previous process exited without close(): the .running "
        "marker survived in the store directory. Fired once at "
        "next-boot recovery, after promoting or discarding any "
        "partially-written bundle.",
    "health.degraded":
        "A health subsystem held `degraded` for >= "
        "SDTPU_INCIDENT_DEGRADED_WINDOWS consecutive samples; the "
        "bundle's resource is the subsystem's top attributed finding.",
    "health.saturated":
        "A health subsystem entered `saturated`; the bundle's "
        "resource is the subsystem's top attributed finding.",
    "sanitize.violation":
        "A runtime-sanitizer detection recorded in COUNT mode "
        "(chan_overflow, data_race, loop_stall, sql_undeclared, ...) "
        "— production's only record of a contract breach.",
    "task.exception":
        "A supervised task died with an unhandled exception "
        "(tasks.py supervisor, routed through sanitize.record).",
    "task.orphaned":
        "A supervised task survived the shutdown reap's grace period "
        "(tasks.py supervisor, routed through sanitize.record).",
}

# Sanitizer violation kind → trigger kind. Task lifecycle kinds get
# their own trigger (they attribute under the tasks subsystem); every
# other sanitizer kind folds into the generic violation trigger.
_SANITIZE_TRIGGERS: Dict[str, str] = {
    "task_exception": "task.exception",
    "task_orphaned": "task.orphaned",
}

_MARKER = ".running"


def _fingerprint(kind: str, subsystem: str, resource: str) -> str:
    h = hashlib.sha256(
        f"{subsystem}|{resource}|{kind}".encode()).hexdigest()
    return h[:12]


def _subsystem_of(resource: str) -> str:
    """Dotted resource name → owning subsystem, the same first-segment
    convention the health engine's channel/timeout findings use."""
    return resource.split(".", 1)[0] if resource else "node"


class IncidentObservatory:
    """The capture engine: observers feed `_fire`, `_fire` dedups,
    assembles, and durably writes. One per process in production
    (module global, installed at Node bootstrap); bench CLIs and the
    sd_incidents self-check construct loose instances around a run,
    exactly like HealthMonitor."""

    def __init__(self, dir_path: Optional[str] = None, monitor=None,
                 events=None, node_id: str = "", node_name: str = ""):
        self._lock = threading.Lock()
        self.dir = os.path.abspath(dir_path) if dir_path else None
        self.monitor = monitor          # HealthMonitor or None
        self.events = events            # EventBus or None
        self.node_identity = {"id": str(node_id), "name": str(node_name)}
        self.window_s = float(flags.get("SDTPU_INCIDENT_WINDOW_S"))
        self.degraded_windows = max(
            1, int(flags.get("SDTPU_INCIDENT_DEGRADED_WINDOWS")))
        self.store_bytes_cap = int(
            float(flags.get("SDTPU_INCIDENT_STORE_MB")) * 1e6)
        # Header index with declared-channel semantics: count-capped by
        # the registry, shed_oldest, and the eviction hook deletes the
        # evicted bundle's file — the disk store can never outgrow the
        # index that names it.
        self._index = channels.channel(
            "incidents.store", on_evict=self._on_index_evict)
        self._last_fired: Dict[str, float] = {}   # fingerprint → ts
        self._dedup: Dict[str, int] = {}          # fingerprint → count
        self._degraded_streak: Dict[str, int] = {}
        self._store_bytes = 0
        self._closed = False
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._recover()
            self._write_marker()

    # -- observers (the detection surfaces call these) ----------------------

    def observe_health(self, snap: Dict[str, Any]) -> None:
        """Called after every health sample (health.py, outside its
        lock). Saturated fires immediately; degraded fires only after
        a streak — and the observatory never observes its own
        `incidents` subsystem (a bundle about bundle pressure would
        recurse forever)."""
        if self._closed:
            return
        states = snap.get("states") or {}
        attribution = snap.get("attribution") or {}
        # Streak bookkeeping under _lock (concurrent samplers exist in
        # embedder tests); the fires themselves run after release —
        # _fire re-acquires for its dedup window.
        fire: List[Tuple[str, str]] = []
        with self._lock:
            for sub, state in sorted(states.items()):
                if sub == "incidents":
                    continue
                if state == "saturated":
                    self._degraded_streak.pop(sub, None)
                    fire.append(("health.saturated", sub))
                elif state == "degraded":
                    streak = self._degraded_streak.get(sub, 0) + 1
                    self._degraded_streak[sub] = streak
                    if streak >= self.degraded_windows:
                        fire.append(("health.degraded", sub))
                else:
                    self._degraded_streak.pop(sub, None)
        for kind, sub in fire:
            self._fire_health(kind, sub, attribution)

    def _fire_health(self, kind: str, subsystem: str,
                     attribution: Dict[str, Any]) -> None:
        top = (attribution.get(subsystem) or [{}])[0]
        resource = top.get("resource") or subsystem
        self._fire(
            kind, subsystem, resource,
            top.get("reason") or f"subsystem {subsystem} {kind}",
            severity=int(top.get("severity") or 2),
            evidence=dict(top.get("evidence") or {}))

    def observe_give_up(self, name: str, tries: int) -> None:
        """Called once per exhausted backoff ladder (timeouts.py),
        exactly when sd_backoff_gave_up_total counts it."""
        if self._closed:
            return
        self._fire(
            "backoff.give_up", _subsystem_of(name), name,
            f"backoff ladder {name} exhausted after {tries} tries",
            severity=2, evidence={"tries": tries})

    def observe_violation(self, kind: str, detail: str) -> None:
        """Called per sanitizer violation recorded WITHOUT raising
        (sanitize.py _record): count mode, and the task lifecycle
        kinds that never raise. Raise mode already delivers the
        evidence to the raiser, and tier-1's per-test violation gate
        must not drown in bundles."""
        if self._closed:
            return
        trigger = _SANITIZE_TRIGGERS.get(kind, "sanitize.violation")
        sub = "tasks" if kind.startswith("task_") else "sanitize"
        self._fire(
            trigger, sub, f"sanitize.{kind}",
            detail[:500] or f"{kind} violation recorded",
            severity=1, evidence={"kind": kind})

    # -- the capture path ---------------------------------------------------

    def _fire(self, kind: str, subsystem: str, resource: str,
              reason: str, severity: int,
              evidence: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Dedup-gate, assemble, persist, announce. Returns the new
        bundle's header, or None when the fingerprint was rate-limited
        (counted into sd_incident_deduped_total)."""
        if kind not in TRIGGERS:
            raise ValueError(f"undeclared incident trigger {kind!r} "
                             "(declare it in spacedrive_tpu_torch/"
                             "incidents.py TRIGGERS)")
        now = time.time()
        fp = _fingerprint(kind, subsystem, resource)
        with self._lock:
            if self._closed:
                return None
            last = self._last_fired.get(fp)
            if last is not None and (now - last) < self.window_s:
                self._dedup[fp] = self._dedup.get(fp, 0) + 1
                INCIDENTS_DEDUPED.inc()
                return None
            self._last_fired[fp] = now
        bundle = self._assemble(kind, subsystem, resource, reason,
                                severity, evidence, fp, now)
        header = bundle_header(bundle)
        with self._lock:
            entry = {"header": header, "path": None, "bundle": None,
                     "bytes": 0}
            if self.dir is not None:
                entry["path"], entry["bytes"] = self._write(bundle)
                self._store_bytes += entry["bytes"]
            else:
                entry["bundle"] = bundle
            self._index.put_nowait(entry)
            self._enforce_bytes_cap()
            self._publish_gauges()
        INCIDENTS_OPENED.labels(kind=kind).inc()
        if self.events is not None:
            try:
                self.events.emit({"type": "Incident", "ts": now,
                                  "incident": dict(header)})
            except Exception:
                pass
        return header

    def _assemble(self, kind: str, subsystem: str, resource: str,
                  reason: str, severity: int, evidence: Dict[str, Any],
                  fp: str, now: float) -> Dict[str, Any]:
        """Snapshot-freeze the evidence. Every section is best-effort
        and bounded: a capture failure degrades that section to empty,
        never loses the trigger attribution itself."""
        from . import flight

        bundle: Dict[str, Any] = {
            "bundle": "incident", "schema": BUNDLE_SCHEMA,
            "id": f"{int(now * 1000):x}-{fp}",
            "ts": round(now, 3),
            "fingerprint": fp,
            "trigger": {
                "kind": kind, "subsystem": subsystem,
                "resource": resource, "reason": reason,
                "severity": 2 if severity not in (1, 2) else severity,
                "evidence": {k: v for k, v in evidence.items()},
            },
            "node": dict(self.node_identity),
            "ack": False,
        }
        try:
            timeline = flight.RECORDER.snapshot()[-TIMELINE_LIMIT:]
        except Exception:
            timeline = []
        bundle["timeline"] = timeline
        # Implicated traces: whatever the recent timeline touched. The
        # span slice follows those ids when any exist — the bundle
        # then reads as a causal story, not 128 unrelated spans.
        traces = []
        for ev in reversed(timeline):
            t = ev.get("trace")
            if t and t not in traces:
                traces.append(t)
            if len(traces) >= TRACE_ID_LIMIT:
                break
        try:
            if traces:
                spans: List[Dict[str, Any]] = []
                for t in traces:
                    spans.extend(tracing.recent_spans(
                        limit=SPAN_LIMIT, trace_id=t))
                spans.sort(key=lambda s: s.get("ts") or 0)
                bundle["spans"] = spans[-SPAN_LIMIT:]
            else:
                bundle["spans"] = tracing.recent_spans(limit=SPAN_LIMIT)
        except Exception:
            bundle["spans"] = []
        bundle["traces"] = traces
        try:
            bundle["logs"] = tracing.log_ring_tail(LOG_LIMIT)
        except Exception:
            bundle["logs"] = []
        bundle["counters"] = self._counter_stage()
        bundle["sql_top"] = self._sql_top()
        bundle["health"] = self._health_tail()
        try:
            bundle["flags"] = {
                name: flags.raw(name) for name in sorted(flags.FLAGS)
                if flags.raw(name) not in (None, "")
            }
        except Exception:
            bundle["flags"] = {}
        try:
            bundle["capacity"] = {
                name: channels.capacity(name)
                for name in sorted(channels.CHANNELS)
            }
        except Exception:
            bundle["capacity"] = {}
        return bundle

    def _counter_stage(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        try:
            for name, m in sorted(telemetry.REGISTRY.families().items()):
                if name.startswith(COUNTER_FAMILY_PREFIXES):
                    out[name] = m.snapshot_value()
        except Exception:
            pass
        return out

    def _sql_top(self) -> List[Dict[str, Any]]:
        """Hottest statements by cumulative executions — which SQL was
        hammering the store when the incident froze."""
        hot: List[Dict[str, Any]] = []
        try:
            fam = telemetry.REGISTRY.get("sd_sql_statements_total")
            if fam is not None:
                for labels, child in fam.samples():
                    v = getattr(child, "value", 0.0)
                    if labels and v > 0:
                        hot.append({"statement": labels.get("name", "?"),
                                    "total": v})
                hot.sort(key=lambda h: -h["total"])
        except Exception:
            pass
        return hot[:SQL_TOP]

    def _health_tail(self) -> Optional[Dict[str, Any]]:
        """States + attribution (with their inline evidence-series
        tails) of the freshest health snapshot — NOT the full window
        (bundle size discipline; the attribution carries the ring
        tails that matter)."""
        if self.monitor is None:
            return None
        try:
            snap = self.monitor.snapshot()
            return {"ts": snap.get("ts"),
                    "window_s": snap.get("window_s"),
                    "states": snap.get("states"),
                    "attribution": snap.get("attribution"),
                    "tasks": snap.get("tasks")}
        except Exception:
            return None

    # -- the durable store --------------------------------------------------

    @staticmethod
    def _chaos_window(edge: str) -> None:
        """The declared incidents.write chaos seam, hooked into the
        shared persist writer's edges: `tmp-partial` (half the body
        flushed) is the torn-tmp window, `pre-rename` (complete,
        fsynced, unrenamed) the complete-tmp window — a delay widens
        either so the kill -9 test can land inside it."""
        if edge in ("tmp-partial", "pre-rename"):
            fault = chaos.hit("incidents.write", only=("delay",))
            if fault is not None:
                chaos.apply_sync(fault)

    def _write(self, bundle: Dict[str, Any]) -> Tuple[str, int]:
        """WAL-style bundle write through the declared persist seam
        (artifact `incidents.bundle`): full body into `<id>.json.tmp`,
        fsync, then one atomic rename. A crash mid-write leaves a torn
        tmp (discarded at recovery) or a complete tmp (promoted) —
        never a torn `<id>.json`."""
        path = os.path.join(self.dir, f"{bundle['id']}.json")
        data = json.dumps(bundle, indent=1)
        with persist.wal_writer("incidents.bundle") as write:
            write(path, data, chaos_point=self._chaos_window)
        return path, len(data)

    def _on_index_evict(self, entry: Dict[str, Any]) -> None:
        """Channel shed_oldest eviction hook: the index slot is gone,
        so the file goes too (the store's declared-bound discipline).
        Runs under whatever context put_nowait sheds in — file unlink
        only, no locks taken."""
        INCIDENTS_DROPPED.inc()
        path = entry.get("path")
        if path:
            try:
                # Every caller holds _lock: the index put that sheds
                # (inside _fire's locked section), _enforce_bytes_cap,
                # and recovery — the hook itself takes none so the
                # locked put path never double-acquires.
                self._store_bytes -= entry.get("bytes", 0)  # sdlint: ok[shared-mutation]
                os.unlink(path)
            except OSError:
                pass

    def _enforce_bytes_cap(self) -> None:
        """Oldest-first eviction below the count cap when the byte cap
        is crossed (callers hold _lock)."""
        while (self._store_bytes > self.store_bytes_cap
               and len(self._index) > 1):
            try:
                self._on_index_evict(self._index.get_nowait())
            except Exception:
                break

    def _publish_gauges(self) -> None:
        open_n = sum(1 for e in self._index
                     if not e["header"].get("ack"))
        INCIDENT_OPEN.set(open_n)
        INCIDENT_STORE_BYTES.set(max(0, self._store_bytes))

    # -- crash marker + WAL recovery ----------------------------------------

    def _marker_path(self) -> str:
        return os.path.join(self.dir, _MARKER)

    def _write_marker(self) -> None:
        persist.atomic_write(
            "incidents.marker", self._marker_path(),
            json.dumps({"pid": os.getpid(), "ts": round(time.time(), 3),
                        "node": dict(self.node_identity)}))
        atexit.register(self._atexit)

    def _atexit(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def _recover(self) -> None:
        """Next-boot recovery: promote complete `.json.tmp` bundles,
        discard torn ones, rebuild the index from surviving files, and
        turn a surviving crash marker into a `crash` bundle."""
        crashed: Optional[Dict[str, Any]] = None
        marker = self._marker_path()
        if os.path.exists(marker):
            try:
                with open(marker) as f:
                    crashed = json.load(f)
            except (OSError, ValueError):
                crashed = {}
            try:
                os.unlink(marker)
            except OSError:
                pass
        def _complete(raw: bytes) -> bool:
            # A tmp is promotable only when it parses AND passes the
            # full bundle schema — a torn body fails either way.
            return not validate_incident_bundle(json.loads(raw))

        for path, outcome in persist.recover(
                "incidents.bundle", self.dir, validate=_complete):
            if outcome == "promoted" or path.endswith(".json.tmp"):
                INCIDENTS_RECOVERED.labels(outcome=outcome).inc()
        entries = []
        for fn in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, fn)
            if fn.endswith(".json"):
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if not validate_incident_header(bundle_header(doc)):
                    entries.append((doc, path))
        entries.sort(key=lambda e: e[0].get("ts") or 0)
        with self._lock:
            for doc, path in entries:
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                self._store_bytes += size
                self._index.put_nowait({"header": bundle_header(doc),
                                        "path": path, "bundle": None,
                                        "bytes": size})
            self._enforce_bytes_cap()
            self._publish_gauges()
        if crashed is not None:
            prev = (crashed or {}).get("node") or {}
            self._fire(
                "crash", "node", "node.process",
                "previous process exited without close() "
                f"(pid {(crashed or {}).get('pid', '?')}, node "
                f"{prev.get('name') or 'unknown'!s})",
                severity=2,
                evidence={"marker": crashed or {}})

    # -- read/triage surface ------------------------------------------------

    def list(self, limit: int = 0) -> List[Dict[str, Any]]:
        """Bundle headers, newest-first."""
        with self._lock:
            headers = [dict(e["header"]) for e in self._index]
        headers.reverse()
        return headers[:limit] if limit and limit > 0 else headers

    def get(self, bundle_id: str) -> Optional[Dict[str, Any]]:
        """One full bundle by id (disk is authoritative)."""
        with self._lock:
            entry = next((e for e in self._index
                          if e["header"]["id"] == bundle_id), None)
        if entry is None:
            return None
        if entry["path"] is not None:
            try:
                with open(entry["path"]) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        return entry["bundle"]

    def ack(self, bundle_id: str) -> bool:
        """Mark a bundle triaged: flips the header (and the file) so
        sd_incident_open tracks the untriaged backlog only."""
        with self._lock:
            entry = next((e for e in self._index
                          if e["header"]["id"] == bundle_id), None)
            if entry is None:
                return False
            entry["header"]["ack"] = True
            if entry["bundle"] is not None:
                entry["bundle"]["ack"] = True
            path = entry["path"]
            self._publish_gauges()
        if path is not None:
            try:
                with open(path) as f:
                    doc = json.load(f)
                doc["ack"] = True
                # Read-modify-write outside _lock: the index header
                # flip above (under _lock) is the authoritative state;
                # this file rewrite is its durable shadow, and ack is
                # idempotent per bundle id.
                # sdlint: ok[crash-atomicity]
                persist.atomic_write("incidents.bundle", path,
                                     json.dumps(doc, indent=1))
            except (OSError, ValueError):
                pass
        return True

    def deduped(self) -> Dict[str, int]:
        """Per-fingerprint dedup counts since construction (what the
        bench harnesses embed next to the headers)."""
        with self._lock:
            return dict(self._dedup)

    def close(self) -> None:
        """Orderly shutdown: remove the crash marker (an exit after
        close() is not a crash). Idempotent; bundles stay on disk."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.dir is not None:
            try:
                os.unlink(self._marker_path())
            except OSError:
                pass


# -- bundle schema -----------------------------------------------------------

def bundle_header(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """The federable subset of a bundle: what incidents.list serves,
    obs.incidents ships to peers, and BENCH artifacts embed."""
    return {
        "id": bundle.get("id"), "ts": bundle.get("ts"),
        "schema": bundle.get("schema"),
        "fingerprint": bundle.get("fingerprint"),
        "trigger": dict(bundle.get("trigger") or {}),
        "node": dict(bundle.get("node") or {}),
        "ack": bool(bundle.get("ack")),
    }


def validate_incident_header(doc: Any) -> List[str]:
    """Schema gate for a bundle header (the federated shape). Returns
    problem strings, empty = valid — same contract as
    health.validate_health_snapshot."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["incident header must be a dict"]
    if not isinstance(doc.get("id"), str) or not doc.get("id"):
        problems.append("id must be a non-empty string")
    if not isinstance(doc.get("ts"), (int, float)):
        problems.append("ts must be a number")
    if not isinstance(doc.get("fingerprint"), str) \
            or not doc.get("fingerprint"):
        problems.append("fingerprint must be a non-empty string")
    trig = doc.get("trigger")
    if not isinstance(trig, dict):
        return problems + ["trigger must be a dict"]
    if trig.get("kind") not in TRIGGERS:
        problems.append(
            f"trigger.kind {trig.get('kind')!r} is not a declared "
            "trigger (incidents.TRIGGERS)")
    for k in ("subsystem", "resource", "reason"):
        if not isinstance(trig.get(k), str) or not trig.get(k):
            problems.append(f"trigger.{k} must be a non-empty string")
    if trig.get("severity") not in (1, 2):
        problems.append("trigger.severity must be 1 or 2")
    if not isinstance(trig.get("evidence"), dict):
        problems.append("trigger.evidence must be a dict")
    node = doc.get("node")
    if not isinstance(node, dict) or \
            not isinstance(node.get("id"), str) or \
            not isinstance(node.get("name"), str):
        problems.append("node must be {id: str, name: str}")
    if not isinstance(doc.get("ack"), bool):
        problems.append("ack must be a bool")
    expected = _fingerprint(trig.get("kind") or "",
                            trig.get("subsystem") or "",
                            trig.get("resource") or "")
    if isinstance(doc.get("fingerprint"), str) and \
            doc["fingerprint"] != expected and not problems:
        problems.append(
            "fingerprint does not match sha256(subsystem|resource|"
            "kind) — dedup identity is broken")
    return problems


def validate_incident_bundle(doc: Any) -> List[str]:
    """Schema gate for a FULL bundle (the on-disk file and the
    incidents.get payload) — what `sd_incidents --input` checks and
    the WAL recovery uses to tell a complete tmp from a torn one."""
    if not isinstance(doc, dict):
        return ["incident bundle must be a dict"]
    problems = validate_incident_header(doc)
    if doc.get("bundle") != "incident":
        problems.append("bundle must be 'incident'")
    if doc.get("schema") != BUNDLE_SCHEMA:
        problems.append(f"schema must be {BUNDLE_SCHEMA}")
    for k in ("timeline", "spans", "logs", "traces"):
        if not isinstance(doc.get(k), list):
            problems.append(f"{k} must be a list")
    for k in ("counters", "flags", "capacity"):
        if not isinstance(doc.get(k), dict):
            problems.append(f"{k} must be a dict")
    if not isinstance(doc.get("sql_top"), list):
        problems.append("sql_top must be a list")
    health = doc.get("health")
    if health is not None and not isinstance(health, dict):
        problems.append("health must be a dict or null")
    return problems


# -- process-global wiring ----------------------------------------------------

_OBSERVATORY: Optional[IncidentObservatory] = None
_wire_lock = threading.Lock()


def current() -> Optional[IncidentObservatory]:
    return _OBSERVATORY


def install(dir_path: Optional[str] = None, monitor=None, events=None,
            node_id: str = "", node_name: str = ""
            ) -> Optional[IncidentObservatory]:
    """Construct the process-global observatory and wire every
    detection surface's observer hook to it. Idempotent — the first
    install wins (one black box per process; a second node in the same
    process shares it, exactly like the sanitizer). Returns the active
    observatory, or None when SDTPU_INCIDENTS is off."""
    global _OBSERVATORY
    if not flags.get("SDTPU_INCIDENTS"):
        return None
    with _wire_lock:
        if _OBSERVATORY is not None:
            return _OBSERVATORY
        obs = IncidentObservatory(
            dir_path=dir_path, monitor=monitor, events=events,
            node_id=node_id, node_name=node_name)
        _OBSERVATORY = obs
    _wire(obs)
    return obs


def _wire(obs: IncidentObservatory) -> None:
    from . import health, sanitize, timeouts

    health.set_incident_observer(obs.observe_health)
    timeouts.set_give_up_observer(obs.observe_give_up)
    sanitize.set_violation_observer(obs.observe_violation)


def uninstall() -> None:
    """Test/embedder hook: close the global observatory and detach
    every observer."""
    global _OBSERVATORY
    from . import health, sanitize, timeouts

    with _wire_lock:
        obs, _OBSERVATORY = _OBSERVATORY, None
    health.set_incident_observer(None)
    timeouts.set_give_up_observer(None)
    sanitize.set_violation_observer(None)
    if obs is not None:
        obs.close()
