"""Health observatory: metrics time-series + saturation attribution.

Everything ROADMAP item 3 needs for capacity tuning exists as declared
registries (channels, timeout budgets, the task supervisor, the jit
contracts, the race recorder) — but until this module the node could
only answer "what is happening right now": `/metrics` and
`node.metrics` are point-in-time snapshots, and the histograms are
cumulative-forever (a p99 from minute 1 pollutes hour 2). The
observatory closes both gaps:

- **Sampler.** A supervised task (`tasks.spawn`, owner ``node/health``,
  interval `SDTPU_HEALTH_INTERVAL_S`) spools DELTA-snapshots of every
  registered metric family into bounded per-series rings — counters
  become windowed rates, gauges become samples, histograms become
  windowed p50/p95/p99 via bucket-delta interpolation
  (`telemetry.Histogram.snapshot_delta`; the cumulative families are
  never reset, so `/metrics` keeps its meaning). The rings are
  declared `health.series` registry channels, so depth discipline
  applies to the observer itself.
- **Saturation engine.** On top of the freshest window it cross-reads
  the declared registries — channel depth/high-water vs declared
  capacity plus shed rate (channels.py), timeout firing rates
  (timeouts.py), store write-lock wait and commit latency, the task
  census vs the supervisor's ownership tree (tasks.py), the pipeline
  stage/retire stall split plus the flight recorder's per-batch bound
  attribution (`sd_pipeline_*`, flight.py), and the sanitizer/race
  violation counters — and emits a per-subsystem state
  (``ok | degraded | saturated``) with **bottleneck attribution**: the
  top-k resources driving the state, named by their declared registry
  name/owner/doc, with the evidence series inline.
- **Surfaces.** The `node.health` rspc query + ws subscription
  (coalesced newest-wins in the ws pump), periodic ``HealthSnapshot``
  events on the node event bus, the `sd_health_state{subsystem}`
  gauge family on `/metrics`, and the `tools/sd_top.py` live operator
  top.

Design constraints: stdlib + the registry modules only
(flags/telemetry/timeouts/channels/tasks/flight) — importable from
every layer without cycles and without jax. The engine reads metric
families ONLY through the `READS` table at the bottom of this module;
sdlint's telemetry pass fails the build on a `sd_*` literal here that
is not in `READS` (or not centrally registered), the same
static↔runtime parity discipline the span and channel registries get.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import channels, flags, tasks, telemetry, timeouts
from .telemetry import HEALTH_SAMPLES, HEALTH_STATE

__all__ = [
    "HealthMonitor", "READS", "STATES", "windowed_quantile",
    "validate_health_snapshot",
]

STATES = ("ok", "degraded", "saturated")

# -- state thresholds (documented in docs/architecture.md §Health) ----------
# Channel depth as a fraction of declared capacity that marks a
# consumer as falling behind (full = saturated outright).
DEPTH_DEGRADED_FRAC = 0.75
# Blocked-producer wait (windowed p99 of sd_chan_put_block_seconds) as
# a fraction of the channel's declared put_budget.
BLOCK_WAIT_DEGRADED_FRAC = 0.1
BLOCK_WAIT_SATURATED_FRAC = 0.5
# Store write-lock wait, windowed p99 seconds.
LOCK_WAIT_DEGRADED_S = 0.05
LOCK_WAIT_SATURATED_S = 0.5
# Store COMMIT latency, windowed p99 seconds.
COMMIT_DEGRADED_S = 1.0
# Group-commit end-to-end wait (enqueue → group COMMIT), windowed p99
# seconds. Healthy groups resolve in a few ms (one fsync shared across
# the group); tens of ms means the queue is deep or a batch body is
# slow inside the group — and the score carries the fraction of the
# declared store.actor.write budget burned per write.
GROUP_WAIT_DEGRADED_S = 0.25
GROUP_WAIT_SATURATED_S = 2.0
# Declared network budgets firing: any firing degrades; a sustained
# rate saturates (the peer/path is effectively down).
TIMEOUT_SATURATED_PER_S = 0.5
# Pipeline stall seconds accumulated per wall second (a dispatcher or
# retirer parked more than this fraction of the window).
PIPELINE_STALL_DEGRADED = 0.2
PIPELINE_STALL_SATURATED = 0.6
# Ring tail included per attribution entry ("evidence series inline").
EVIDENCE_POINTS = 32

# Subsystems that always carry a state, even when nothing is observed
# (operators diff states across polls; a key that appears only under
# load would read as a new failure mode).
BASE_SUBSYSTEMS = ("api", "jobs", "media", "ops", "p2p", "sanitize",
                   "store", "sync", "tasks")


def windowed_quantile(buckets: Sequence[float],
                      delta_counts: Sequence[int],
                      q: float) -> Optional[float]:
    """Prometheus-style histogram_quantile over NON-cumulative bucket
    deltas: find the bucket where the cumulative windowed count
    crosses q*total and interpolate linearly inside it (lower bound 0
    for the first bucket). Observations above the top finite bound
    clamp to it — the honest answer a fixed-bucket histogram can
    give. None when the window saw nothing."""
    total = sum(delta_counts)
    if total <= 0:
        return None
    rank = q * total
    lo, cum = 0.0, 0.0
    for le, c in zip(buckets, delta_counts):
        cum += c
        if c > 0 and cum >= rank:
            frac = (rank - (cum - c)) / c
            return lo + (le - lo) * frac
        lo = le
    return float(buckets[-1])


def _series_key(family: str, labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return family
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{family}{{{inner}}}"


def _round(v: Any, nd: int = 6) -> Any:
    return round(v, nd) if isinstance(v, float) else v


def _finding(resource: str, subsystem: str, severity: int, score: float,
             reason: str, owner: str = "", doc: str = "",
             evidence: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    return {
        "resource": resource, "subsystem": subsystem,
        "severity": int(severity), "score": _round(float(score), 3),
        "reason": reason, "owner": owner, "doc": doc,
        "evidence": {k: _round(v) for k, v in (evidence or {}).items()},
    }


def _family_doc(family: str) -> str:
    m = telemetry.REGISTRY.get(family)
    return m.help if m is not None else ""


class HealthMonitor:
    """The sampler + saturation engine, one per node (constructed at
    bootstrap, started with the node, reaped under ``node/health``).
    Bench CLIs construct throwaway instances around a run to embed a
    whole-run health section in their artifacts — `sample()` works
    loop-less, exactly like the channels it builds on."""

    def __init__(self, events=None, interval_s: Optional[float] = None,
                 owner: str = "health", node_id: str = "",
                 node_name: str = ""):
        self._lock = threading.Lock()
        self.events = events
        # Node identity riding every snapshot (fleet federation needs
        # labeled rows; skew needs the sampled-at wall clock, which
        # `ts` has always carried). Empty strings for loose monitors
        # (bench CLIs, tests) — the key is present either way so the
        # schema is one shape.
        self.node_identity = {"id": str(node_id), "name": str(node_name)}
        if interval_s is None:
            interval_s = float(flags.get("SDTPU_HEALTH_INTERVAL_S"))
        self.interval_s = max(0.05, interval_s)
        self.topk = max(1, int(flags.get("SDTPU_HEALTH_TOPK")))
        self._owner = owner
        self._task: Optional[asyncio.Task] = None
        # Series state, all under _lock (contract in threadctx.py).
        # Both maps are bounded by the metric registry's family×label
        # cardinality — the same import-time contract as the
        # declaration registries the engine reads.
        self._cursors: Dict[str, Any] = {}  # sdlint: ok[unbounded-growth]
        self._series: Dict[str, channels.Channel] = {}  # sdlint: ok[unbounded-growth]
        self._snapshots = channels.channel("health.snapshots")
        self._prev_t: Optional[float] = None
        self._last: Optional[Dict[str, Any]] = None
        # Establish cursors immediately: the first periodic tick then
        # has a real window instead of a meaningless since-forever one.
        self.sample()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            with self._lock:
                self._task = tasks.spawn(
                    "health-sampler", self._loop(), owner=self._owner)

    def stop(self) -> None:
        with self._lock:
            task, self._task = self._task, None
        if task is not None:
            task.cancel()

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            if telemetry.enabled():
                self._emit(self.sample())

    def _emit(self, snap: Dict[str, Any]) -> None:
        if self.events is not None:
            self.events.emit({"type": "HealthSnapshot",
                              "ts": snap["ts"], "health": snap})

    def emit_snapshot(self) -> None:
        """Push one HealthSnapshot now (the subscription's immediate
        first frame)."""
        self._emit(self.snapshot())

    # -- the sampler -------------------------------------------------------

    def snapshot(self, max_age_s: Optional[float] = None
                 ) -> Dict[str, Any]:
        """The latest computed snapshot; samples fresh when none
        exists or the last one is older than `max_age_s` (default
        2× interval — covers loop-less embedders and sync tests where
        the periodic sampler never runs)."""
        limit = 2.0 * self.interval_s if max_age_s is None else max_age_s
        with self._lock:
            last = self._last
        if last is not None and (time.time() - last["ts"]) <= limit:
            return last
        return self.sample()

    def sample(self) -> Dict[str, Any]:
        """One observation: delta-spool every registered family into
        the per-series rings, evaluate saturation, publish the
        sd_health_state gauges, and return the HealthSnapshot dict."""
        with self._lock:
            t, wall = time.perf_counter(), time.time()
            dt = (t - self._prev_t) if self._prev_t is not None else None
            window: Dict[str, Dict[str, Any]] = {}
            for name, metric in sorted(telemetry.REGISTRY.families()
                                       .items()):
                for labels, m in metric.samples():
                    key = _series_key(name, labels)
                    rec: Dict[str, Any] = {
                        "family": name, "labels": labels or {},
                        "kind": metric.kind,
                    }
                    point: Optional[float] = None
                    if metric.kind == "histogram":
                        d = m.snapshot_delta(self._cursors.get(key))
                        self._cursors[key] = d["cursor"]
                        rec["count"] = d["count"]
                        rec["sum"] = _round(d["sum"])
                        rec["rate"] = _round(
                            d["count"] / dt) if dt else 0.0
                        for q, lbl in ((0.5, "p50"), (0.95, "p95"),
                                       (0.99, "p99")):
                            rec[lbl] = _round(windowed_quantile(
                                m.buckets, d["counts"], q))
                        point = rec["p99"]
                    elif metric.kind == "gauge":
                        rec["value"] = _round(m.value)
                        point = rec["value"]
                    else:  # counter
                        d = m.snapshot_delta(self._cursors.get(key))
                        self._cursors[key] = d["cursor"]
                        rec["delta"] = _round(d["value"])
                        rec["rate"] = _round(
                            d["value"] / dt) if dt else 0.0
                        point = rec["rate"]
                    window[key] = rec
                    if point is not None:
                        ring = self._series.get(key)
                        if ring is None:
                            ring = self._series[key] = channels.channel(
                                "health.series")
                        ring.put_nowait([round(wall, 3), _round(point)])

            findings = _evaluate(window, dt, wall)
            census: Dict[str, int] = {}
            for owner in tasks.owners():
                root = tasks.owner_label(owner).split("/")[0]
                census[root] = census.get(root, 0) + 1

            states: Dict[str, str] = {s: "ok" for s in BASE_SUBSYSTEMS}
            by_sub: Dict[str, List[Dict[str, Any]]] = {}
            for f in findings:
                sub = f["subsystem"]
                by_sub.setdefault(sub, []).append(f)
                cur = states.get(sub, "ok")
                if f["severity"] > STATES.index(cur):
                    states[sub] = STATES[f["severity"]]
                else:
                    states.setdefault(sub, cur)
            attribution: Dict[str, List[Dict[str, Any]]] = {}
            for sub, fs in sorted(by_sub.items()):
                fs.sort(key=lambda f: (-f["severity"], -f["score"],
                                       f["resource"]))
                top = fs[:self.topk]
                for f in top:
                    # Evidence series inline: the ring tails behind
                    # each windowed number the engine judged by.
                    pts = {}
                    for key in list(f["evidence"])[:2]:
                        ring = self._series.get(key)
                        if ring is not None:
                            pts[key] = list(ring)[-EVIDENCE_POINTS:]
                    f["points"] = pts
                attribution[sub] = top

            snap: Dict[str, Any] = {
                "ts": round(wall, 3),
                "node": dict(self.node_identity),
                "window_s": _round(dt) if dt is not None else None,
                "interval_s": self.interval_s,
                "states": states,
                "attribution": attribution,
                "tasks": {"live": sum(census.values()),
                          "census": census},
                "window": window,
            }
            self._prev_t = t
            self._last = snap
            self._snapshots.put_nowait(snap)
        HEALTH_SAMPLES.inc()
        for sub, st in states.items():
            HEALTH_STATE.labels(subsystem=sub).set(STATES.index(st))
        # Incident observatory last, OUTSIDE the lock: the observer
        # snapshot-freezes evidence bundles (disk writes, counter
        # stages) and must never extend the sampler's critical
        # section — or break the sample on its own failure.
        observer = _incident_observer
        if observer is not None:
            try:
                observer(snap)
            except Exception:
                pass
        return snap


# Incident-observatory hook (incidents.py set_incident_observer):
# called with every computed snapshot so saturated/degraded states
# become durable evidence bundles.
_incident_observer: Optional[Callable[[Dict[str, Any]], None]] = None


def set_incident_observer(
        cb: Optional[Callable[[Dict[str, Any]], None]]) -> None:
    global _incident_observer
    _incident_observer = cb


# -- the saturation engine ---------------------------------------------------

def _win(window: Dict[str, Dict], family: str, **labels) -> Optional[Dict]:
    return window.get(_series_key(family, labels or None))


def _by_family(window: Dict[str, Dict], family: str
               ) -> List[Tuple[str, Dict]]:
    return [(k, rec) for k, rec in window.items()
            if rec["family"] == family]


def _evaluate(window: Dict[str, Dict], dt: Optional[float],
              wall: float) -> List[Dict[str, Any]]:
    """Cross-read the declared registries over the freshest window and
    name what is saturated and what it is blocked on. Rates need a
    window: the very first sample (dt None) judges gauges/depths
    only."""
    finds: List[Dict[str, Any]] = []
    finds.extend(_channel_findings(window, dt))
    finds.extend(_timeout_findings(window, dt))
    finds.extend(_store_findings(window))
    finds.extend(_task_findings(window, dt))
    finds.extend(_pipeline_findings(window, dt, wall))
    finds.extend(_sanitize_findings(window, dt))
    finds.extend(_incident_findings(window, dt))
    return finds


def _channel_findings(window, dt) -> List[Dict[str, Any]]:
    finds = []
    for name, c in channels.CHANNELS.items():
        if c.sheds_expected:
            continue  # aging out IS this channel's design
        depth_rec = _win(window, "sd_chan_depth", name=name)
        if depth_rec is None:
            continue  # never constructed in this process
        cap = channels.capacity(name)
        depth = depth_rec.get("value") or 0.0
        shed_rec = _win(window, "sd_chan_shed_total", name=name)
        shed_rate = (shed_rec or {}).get("rate") or 0.0
        hw_rec = _win(window, "sd_chan_high_water", name=name)
        evidence = {
            _series_key("sd_chan_depth", {"name": name}): depth,
            _series_key("sd_chan_shed_total", {"name": name}): shed_rate,
            "capacity": cap,
        }
        if hw_rec is not None:
            evidence[_series_key("sd_chan_high_water",
                                 {"name": name})] = hw_rec.get("value")
        sev, reason = 0, ""
        if c.policy == "block":
            wait_rec = _win(window, "sd_chan_put_block_seconds",
                            name=name)
            p99 = (wait_rec or {}).get("p99")
            budget_s = timeouts.budget(c.put_budget) \
                if c.put_budget else None
            if p99 is not None and budget_s:
                evidence["put_block_p99_s"] = p99
                evidence["put_budget_s"] = budget_s
                if p99 >= BLOCK_WAIT_SATURATED_FRAC * budget_s:
                    sev, reason = 2, (
                        f"producers wait p99 {p99:.3g}s of the "
                        f"{budget_s:g}s {c.put_budget} budget")
                elif p99 >= BLOCK_WAIT_DEGRADED_FRAC * budget_s:
                    sev, reason = 1, (
                        f"producers feel backpressure (put p99 "
                        f"{p99:.3g}s vs {budget_s:g}s budget)")
        else:
            shedding = shed_rate > 0 and (
                c.policy in ("shed_new", "shed_oldest") or depth >= cap)
            if shedding:
                sev, reason = 2, (
                    f"{c.policy} policy dropping work "
                    f"({shed_rate:.3g}/s, depth {depth:g}/{cap})")
            elif depth >= cap:
                sev, reason = 2, (
                    f"buffer full ({depth:g}/{cap}) — consumer wedged")
            elif depth >= DEPTH_DEGRADED_FRAC * cap:
                sev, reason = 1, (
                    f"consumer falling behind (depth {depth:g}/{cap})")
        if sev:
            finds.append(_finding(
                name, name.split(".")[0], sev,
                shed_rate + (depth / cap if cap else 0.0),
                reason, owner=c.owner, doc=c.doc, evidence=evidence))
    return finds


def _timeout_findings(window, dt) -> List[Dict[str, Any]]:
    finds = []
    if dt is None:
        return finds
    for name, c in timeouts.TIMEOUTS.items():
        rec = _win(window, "sd_timeout_fired_total", name=name)
        rate = (rec or {}).get("rate") or 0.0
        if rate <= 0:
            continue
        sev = 2 if rate >= TIMEOUT_SATURATED_PER_S else 1
        finds.append(_finding(
            name, name.split(".")[0], sev, rate,
            f"declared budget firing {rate:.3g}/s "
            f"(default {c.default_s:g}s)",
            owner=name.split(".")[0], doc=c.doc,
            evidence={_series_key("sd_timeout_fired_total",
                                  {"name": name}): rate}))
    return finds


def _hot_statements(window, top: int = 3) -> List[Dict[str, Any]]:
    """Per-statement attribution over the declared inventory (round
    16): the window's hottest statements by execution and row rate —
    so a saturated write lock names WHICH statement is hammering it,
    not just that the store hurts."""
    from .store import statements as _stmts

    hot = []
    for name in list(_stmts.STATEMENTS) + list(_stmts.SHAPES):
        rec = _win(window, "sd_sql_statements_total", name=name)
        rate = (rec or {}).get("rate") or 0.0
        if rate <= 0:
            continue
        rows = _win(window, "sd_sql_rows_total", name=name)
        hot.append({"statement": name, "rate": rate,
                    "rows_rate": (rows or {}).get("rate") or 0.0})
    hot.sort(key=lambda h: (-h["rows_rate"], -h["rate"]))
    return hot[:top]


def _store_findings(window) -> List[Dict[str, Any]]:
    finds = []
    lock_rec = _win(window, "sd_store_write_lock_wait_seconds")
    p99 = (lock_rec or {}).get("p99")
    if p99 is not None:
        sev = 2 if p99 >= LOCK_WAIT_SATURATED_S else \
            1 if p99 >= LOCK_WAIT_DEGRADED_S else 0
        if sev:
            finds.append(_finding(
                "store.db.write_lock", "store", sev, p99,
                f"write-lock wait p99 {p99:.3g}s in window — writers "
                "serializing behind the per-database lock",
                owner="store",
                doc=_family_doc("sd_store_write_lock_wait_seconds"),
                evidence={
                    "sd_store_write_lock_wait_seconds": p99,
                    "tx_rate": (_win(window, "sd_store_tx_total")
                                or {}).get("rate"),
                    "hottest_statements": _hot_statements(window),
                }))
    commit_rec = _win(window, "sd_store_commit_seconds")
    cp99 = (commit_rec or {}).get("p99")
    if cp99 is not None and cp99 >= COMMIT_DEGRADED_S:
        finds.append(_finding(
            "store.db.commit", "store", 1, cp99,
            f"COMMIT latency p99 {cp99:.3g}s in window",
            owner="store", doc=_family_doc("sd_store_commit_seconds"),
            evidence={"sd_store_commit_seconds": cp99,
                      "hottest_statements": _hot_statements(window)}))
    wait_rec = _win(window, "sd_store_group_wait_seconds")
    wp99 = (wait_rec or {}).get("p99")
    if wp99 is not None:
        sev = 2 if wp99 >= GROUP_WAIT_SATURATED_S else \
            1 if wp99 >= GROUP_WAIT_DEGRADED_S else 0
        if sev:
            budget = timeouts.budget("store.actor.write")
            size_rec = _win(window, "sd_store_group_size")
            finds.append(_finding(
                "store.actor.group", "store", sev, wp99,
                f"group-commit wait p99 {wp99:.3g}s in window "
                f"({wp99 / budget:.1%} of the store.actor.write "
                "budget) — the writer queue is deep or a batch body "
                "is slow inside the group",
                owner="store",
                doc=_family_doc("sd_store_group_wait_seconds"),
                evidence={
                    "sd_store_group_wait_seconds": wp99,
                    "sd_store_group_size": (size_rec or {}).get("p99"),
                    "group_rate": (_win(
                        window, "sd_store_group_commits_total")
                        or {}).get("rate"),
                    "shutdown_drains": (_win(
                        window, "sd_store_group_shutdown_drains_total")
                        or {}).get("delta"),
                    "hottest_statements": _hot_statements(window),
                }))
    return finds


def _task_findings(window, dt) -> List[Dict[str, Any]]:
    finds = []
    if dt is None:
        return finds
    orphan_rec = _win(window, "sd_task_orphaned_total")
    orphans = (orphan_rec or {}).get("delta") or 0.0
    if orphans > 0:
        finds.append(_finding(
            "tasks.orphans", "tasks", 2, orphans,
            f"{orphans:g} task(s) survived a shutdown reap grace "
            "period in this window",
            owner="tasks", doc=_family_doc("sd_task_orphaned_total"),
            evidence={"sd_task_orphaned_total": orphans}))
    exc_rec = _win(window, "sd_sanitize_violations_total",
                   kind="task_exception")
    exc = (exc_rec or {}).get("delta") or 0.0
    if exc > 0:
        finds.append(_finding(
            "tasks.exceptions", "tasks", 1, exc,
            f"{exc:g} supervised task(s) died with unhandled "
            "exceptions in this window",
            owner="tasks", doc=_family_doc("sd_task_spawned_total"),
            evidence={_series_key("sd_sanitize_violations_total",
                                  {"kind": "task_exception"}): exc}))
    return finds


def _pipeline_findings(window, dt, wall) -> List[Dict[str, Any]]:
    if dt is None:
        return []
    stage_r = (_win(window, "sd_pipeline_stage_stall_seconds_total")
               or {}).get("rate") or 0.0
    retire_r = (_win(window, "sd_pipeline_retire_stall_seconds_total")
                or {}).get("rate") or 0.0
    h2d_r = (_win(window, "sd_pipeline_h2d_seconds_total")
             or {}).get("rate") or 0.0
    busy = max(stage_r, retire_r)
    if busy < PIPELINE_STALL_DEGRADED:
        return []
    sev = 2 if busy >= PIPELINE_STALL_SATURATED else 1
    evidence = {
        "sd_pipeline_stage_stall_seconds_total": stage_r,
        "sd_pipeline_retire_stall_seconds_total": retire_r,
        "sd_pipeline_h2d_seconds_total": h2d_r,
    }
    if stage_r >= retire_r:
        resource = "ops.pipeline.stage"
        reason = (f"dispatchers starved {stage_r:.2f} stall-s/s "
                  "waiting on staged batches — the pipeline is "
                  "stage-bound")
        doc = _family_doc("sd_pipeline_stage_stall_seconds_total")
    else:
        binding = _flight_binding(wall, dt) or (
            "h2d" if h2d_r >= 0.5 * retire_r else "kernel")
        resource = f"ops.pipeline.{binding}"
        reason = (f"retirer starved {retire_r:.2f} stall-s/s; recent "
                  f"batch windows attribute the bound to {binding}")
        doc = _family_doc("sd_pipeline_h2d_seconds_total") \
            if binding == "h2d" else \
            _family_doc("sd_pipeline_retire_stall_seconds_total")
    return [_finding(resource, "ops", sev, busy, reason,
                     owner="ops", doc=doc, evidence=evidence)]


def _flight_binding(wall: float, dt: float) -> Optional[str]:
    """The dominant bound (stage|h2d|kernel) named by the flight
    recorder's per-batch window events inside the sampling window —
    the forensic half of the pipeline attribution."""
    from . import flight

    t0_us = int((wall - dt) * 1e6)
    counts: Dict[str, int] = {}
    for ev in flight.RECORDER.snapshot():
        if ev.get("lane") == "window" and ev.get("ts_us", 0) >= t0_us:
            b = ev.get("binding")
            if b:
                counts[b] = counts.get(b, 0) + 1
    if not counts:
        return None
    return max(counts.items(), key=lambda kv: (kv[1], kv[0]))[0]


def _sanitize_findings(window, dt) -> List[Dict[str, Any]]:
    finds = []
    if dt is None:
        return finds
    for key, rec in _by_family(window, "sd_sanitize_violations_total"):
        kind = rec["labels"].get("kind", "?")
        if kind in ("task_exception", "task_orphaned"):
            continue  # attributed under the tasks subsystem
        delta = rec.get("delta") or 0.0
        if delta <= 0:
            continue
        sev = 2 if kind == "data_race" else 1
        finds.append(_finding(
            f"sanitize.{kind}", "sanitize", sev, delta,
            f"{delta:g} {kind} violation(s) recorded in this window",
            owner="sanitize",
            doc=_family_doc("sd_sanitize_violations_total"),
            evidence={key: delta}))
    for key, rec in _by_family(window, "sd_race_candidates_total"):
        delta = rec.get("delta") or 0.0
        if delta <= 0:
            continue
        cls_attr = rec["labels"].get("cls_attr", "?")
        finds.append(_finding(
            f"sanitize.race.{cls_attr}", "sanitize", 1, delta,
            f"{delta:g} ownership-contract breach(es) on {cls_attr} "
            "in this window",
            owner="sanitize",
            doc=_family_doc("sd_race_candidates_total"),
            evidence={key: delta}))
    return finds


def _incident_findings(window, dt) -> List[Dict[str, Any]]:
    """The observatory observes itself: evidence lost to the store
    bound, and an untriaged backlog against the declared capacity.
    Both land under the dynamic `incidents` subsystem — which the
    observatory explicitly refuses to open bundles about (a black box
    recording its own pressure forever would be the feedback loop)."""
    finds = []
    if dt is not None:
        rec = _win(window, "sd_incident_dropped_total")
        delta = (rec or {}).get("delta") or 0.0
        if delta > 0:
            finds.append(_finding(
                "incidents.store", "incidents", 1, delta,
                f"{delta:g} evidence bundle(s) evicted by the store "
                "bound in this window — postmortems are being lost; "
                "raise SDTPU_INCIDENT_STORE_MB or triage faster",
                owner="incidents",
                doc=_family_doc("sd_incident_dropped_total"),
                evidence={"sd_incident_dropped_total": delta}))
    rec = _win(window, "sd_incident_open")
    open_n = (rec or {}).get("value") or 0.0
    cap = channels.capacity("incidents.store")
    if open_n >= 0.8 * cap:
        finds.append(_finding(
            "incidents.open", "incidents", 1, open_n / max(cap, 1),
            f"{open_n:g} unacknowledged bundle(s) vs store capacity "
            f"{cap} — the untriaged backlog is about to evict "
            "evidence (incidents.ack drains it)",
            owner="incidents",
            doc=_family_doc("sd_incident_open"),
            evidence={"sd_incident_open": open_n}))
    return finds


# -- artifact schema ---------------------------------------------------------

def validate_health_snapshot(doc: Any) -> List[str]:
    """Schema gate for a HealthSnapshot (the node.health payload and
    the `sd_top --json` artifact body). Returns problem strings
    (empty = valid) — the contract tools/sd_top.py self-checks in
    tier-1, same pattern as flight.validate_chrome_trace."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["health snapshot must be a dict"]
    if not isinstance(doc.get("ts"), (int, float)):
        problems.append("ts must be a number")
    node = doc.get("node")
    if node is not None:
        # Node identity is OPTIONAL (pre-fleet snapshots validate
        # unchanged — backward-compatible shape) but typed when
        # present: the fleet merger labels rows by it.
        if not isinstance(node, dict) or \
                not isinstance(node.get("id"), str) or \
                not isinstance(node.get("name"), str):
            problems.append(
                "node must be {id: str, name: str} when present")
    if doc.get("window_s") is not None and \
            not isinstance(doc["window_s"], (int, float)):
        problems.append("window_s must be a number or null")
    states = doc.get("states")
    if not isinstance(states, dict) or not states:
        return problems + ["states must be a non-empty dict"]
    for sub, st in states.items():
        if st not in STATES:
            problems.append(f"states[{sub}]: unknown state {st!r}")
    attribution = doc.get("attribution")
    if not isinstance(attribution, dict):
        return problems + ["attribution must be a dict"]
    for sub, entries in attribution.items():
        where = f"attribution[{sub}]"
        if sub not in states:
            problems.append(f"{where}: subsystem has no state")
            continue
        if not isinstance(entries, list) or not entries:
            problems.append(f"{where}: must be a non-empty list")
            continue
        worst = 0
        for i, e in enumerate(entries):
            ew = f"{where}[{i}]"
            if not isinstance(e, dict):
                problems.append(f"{ew}: not an object")
                continue
            for k, t in (("resource", str), ("reason", str),
                         ("owner", str), ("doc", str)):
                if not isinstance(e.get(k), t):
                    problems.append(f"{ew}: {k} must be a {t.__name__}")
            if e.get("subsystem") != sub:
                problems.append(f"{ew}: subsystem mismatch")
            sev = e.get("severity")
            if sev not in (1, 2):
                problems.append(f"{ew}: severity must be 1 or 2")
            else:
                worst = max(worst, sev)
            if not isinstance(e.get("evidence"), dict):
                problems.append(f"{ew}: evidence must be a dict")
            pts = e.get("points")
            if pts is not None:
                if not isinstance(pts, dict):
                    problems.append(f"{ew}: points must be a dict")
                else:
                    for series, tail in pts.items():
                        if not isinstance(tail, list) or any(
                                not isinstance(p, (list, tuple))
                                or len(p) != 2 for p in tail):
                            problems.append(
                                f"{ew}: points[{series}] must be "
                                "[ts, value] pairs")
        if worst and states.get(sub) != STATES[worst]:
            problems.append(
                f"{where}: state {states.get(sub)!r} inconsistent "
                f"with worst attributed severity {worst}")
    window = doc.get("window")
    if window is not None:
        if not isinstance(window, dict):
            problems.append("window must be a dict")
        else:
            for key, rec in window.items():
                if not isinstance(rec, dict) or rec.get("kind") not in (
                        "counter", "gauge", "histogram"):
                    problems.append(
                        f"window[{key}]: needs a kind of "
                        "counter|gauge|histogram")
                    break  # one structural problem is enough signal
    return problems


# ---------------------------------------------------------------------------
# THE families the saturation engine cross-reads, each with why. Every
# key must be registered in spacedrive_tpu_torch/telemetry.py, and every
# `sd_*` literal in this module must appear here — enforced statically
# by sdlint's telemetry pass (codes health-read-undeclared /
# health-read-unlisted) and at runtime by the parity test in
# tests/test_sdlint.py, the same shape as the span-family and channel
# drift checks.
# ---------------------------------------------------------------------------

READS: Dict[str, str] = {
    "sd_chan_depth": "instantaneous channel depth vs declared capacity",
    "sd_chan_high_water": "deepest observed depth per channel",
    "sd_chan_shed_total": "overflow-policy drop rate per channel",
    "sd_chan_put_block_seconds":
        "blocked-producer wait vs the channel's declared put budget",
    "sd_timeout_fired_total":
        "declared network-await budgets firing, per contract",
    "sd_store_write_lock_wait_seconds":
        "writer serialization behind the per-database write lock",
    "sd_store_commit_seconds": "COMMIT latency of write transactions",
    "sd_store_tx_total": "write-transaction rate (lock-wait context)",
    "sd_store_group_wait_seconds":
        "enqueue→COMMIT wait of group-committed writes vs the "
        "store.actor.write budget",
    "sd_store_group_size":
        "batches coalesced per group commit (fat-commit evidence)",
    "sd_store_group_commits_total":
        "group-commit rate of the per-library write actor",
    "sd_store_group_shutdown_drains_total":
        "write batches failed by actor shutdown (never silently "
        "dropped)",
    "sd_sql_statements_total":
        "per-statement execution rate (hottest-statement attribution "
        "for store findings)",
    "sd_sql_rows_total":
        "per-statement row throughput (hottest-statement attribution)",
    "sd_task_spawned_total": "supervisor spawn rate (census context)",
    "sd_task_orphaned_total": "tasks surviving the shutdown reap",
    "sd_pipeline_stage_stall_seconds_total":
        "identify-pipeline dispatcher starvation (stage-bound)",
    "sd_pipeline_retire_stall_seconds_total":
        "identify-pipeline retirer starvation (device-bound)",
    "sd_pipeline_h2d_seconds_total":
        "host→device transfer occupancy of the pipeline",
    "sd_sanitize_violations_total":
        "runtime-sanitizer detections by kind",
    "sd_race_candidates_total":
        "ownership-contract breaches recorded by the race recorder",
    "sd_incident_dropped_total":
        "evidence bundles evicted by the incident store's declared "
        "bound (postmortems lost)",
    "sd_incident_open":
        "untriaged incident-bundle backlog vs the incidents.store "
        "capacity",
}
