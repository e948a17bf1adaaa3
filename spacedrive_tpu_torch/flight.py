"""Flight recorder: pipeline timeline capture + Chrome-trace export.

The observability gap this closes (ROADMAP item 1's evidence problem):
when an identify run misses its computed bound, the aggregate
`sd_pipeline_*` counters say THAT time was lost, never WHERE — which
batch, which device stream, which stage. The recorder keeps a bounded
per-batch timeline of the depth-N pipeline (ops/overlap.py) and the
host hashing planes (ops/staging.py): one event per
stage/H2D/kernel/retire phase with begin-end wall timestamps, device
and stream labels, and the owning trace id — plus one `window` event
per retired batch carrying **bound attribution**: which of
max(t_stage, t_h2d, t_kernel) was binding for that batch and by how
much.

Storage is a declared registry channel (`ops.pipeline.timeline`,
shed_oldest — history ages out, memory never grows with uptime),
written from the per-device dispatch executor threads and the pipeline
coroutines under the recorder's lock; the ownership contract is
declared in threadctx.py (`flight.FlightRecorder`) so the race
recorder audits every write in tier-1.

`chrome_trace()` turns the span ring (tracing.py) plus this timeline
into a Chrome-trace/Perfetto `traceEvents` JSON document —
per-device stage/H2D/kernel/retire lanes, span lanes grouped by trace
id, `M` metadata naming every pid/tid — and `validate_chrome_trace()`
is the schema gate: `tools/trace_export.py --json` self-checks through
it in tier-1, the `node.trace.export` rspc route serves it from a live
node, and `overlap_bench --trace` / `perf_smoke --trace` ship it next
to their BENCH artifacts. `fleet_chrome_trace()` is the multi-node
composition (fleet.py distributed trace assembly): N nodes' captures
as per-node pid-lane pairs on one skew-aligned axis, offsets recorded
in the document metadata, behind `fleet.trace.export` and
`tools/trace_export.py --fleet`.

Design constraints: stdlib + channels/telemetry/tracing only — every
layer (ops executors, benches, the API host) can import it without
cycles and without jax.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import channels, tracing
from .telemetry import TRACE_TIMELINE_EVENTS

__all__ = [
    "FlightRecorder", "RECORDER", "LANES", "chrome_trace",
    "fleet_chrome_trace", "validate_chrome_trace",
]

# The pipeline phases one batch moves through, in order. `window` is
# the synthetic fifth lane: emitted when a batch's `retire` lands,
# carrying the batch's bound attribution.
LANES = ("stage", "h2d", "kernel", "retire")

# The three components the steady-state bound maximizes over
# (PipelineStats.bound_files_per_sec) — per-batch attribution names
# the binding one.
_BOUND_COMPONENTS = ("stage", "h2d", "kernel")

# Open-window safety cap: a run that dies mid-batch (or a caller that
# records phases but never a retire) must not leak entries — past the
# cap the oldest open window is dropped, not the recorder's memory
# contract. Bounded well above any real in-flight depth (ring depth
# caps at MAX_PIPELINE_DEPTH = 8 per run).
_OPEN_CAP = 64

# Run tokens disambiguate concurrent/successive pipeline runs whose
# batch NUMBERING overlaps (two identifier jobs both dispatch a
# "batch 3"; a trace id is not enough — one job's trace covers every
# run it starts). new_run_token() is what run_overlapped threads
# through its records.
_RUN_SEQ = itertools.count(1)


def new_run_token() -> int:
    """Fresh per-run id for record(..., run=token): keeps one run's
    open batch windows from colliding with another's."""
    return next(_RUN_SEQ)


class FlightRecorder:
    """Bounded per-batch pipeline timeline.

    Writers are the per-device dispatch executor threads, the retire
    executor thread, and the pipeline's private-loop coroutines —
    every mutation runs under `_lock` (contract declared in
    threadctx.py). Events are JSON-safe dicts; the ring is the
    declared `ops.pipeline.timeline` channel, so capacity scales with
    SDTPU_CHAN_SCALE and shed counts surface as
    sd_chan_shed_total{ops.pipeline.timeline}.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.ring = channels.channel("ops.pipeline.timeline")
        # (scope, run, batch) -> lane -> (t0_perf, t1_perf): the open
        # batch windows awaiting their retire event. Entries leave at
        # retire, and a window is only OPENED when the caller passes a
        # run token (the pipeline loop, which always retires) — scopes
        # that never emit a retire (identify host-plane chunks) are
        # pure lane events, so they cannot accumulate here. Capped at
        # _OPEN_CAP as the crashed-run backstop.
        self._open: Dict[Tuple[str, int, int],
                         Dict[str, Tuple[float, float]]] = {}

    def record(self, lane: str, batch: int, t0: float, t1: float,
               device: str = "", stream: int = 0,
               trace: Optional[str] = None, scope: str = "pipeline",
               run: Optional[int] = None, **fields: Any) -> None:
        """One phase of one batch: [t0, t1) perf_counter readings from
        the thread that ran the phase. With a `run` token
        (new_run_token(); the pipeline loop passes one), phases
        accumulate into the (scope, run, batch) window and `retire`
        closes it, emitting the bound-attribution event; without one
        the event is a bare lane entry."""
        ev = {
            "lane": lane, "batch": int(batch), "scope": scope,
            "device": str(device), "stream": int(stream),
            "ts_us": tracing.perf_to_us(t0),
            "dur_us": max(0, int((t1 - t0) * 1e6)),
        }
        if trace:
            ev["trace"] = trace
        ev.update(fields)
        TRACE_TIMELINE_EVENTS.inc()
        with self._lock:
            self.ring.put_nowait(ev)
            if run is None:
                return
            key = (scope, int(run), int(batch))
            if lane in _BOUND_COMPONENTS:
                entry = self._open.setdefault(key, {})
                entry[lane] = (t0, t1)
                if device:
                    # The batch's device stream (its h2d/kernel phases
                    # carry it; stage/retire run off-device): the
                    # window event inherits it so bound attribution
                    # names WHICH stream was bound, per device lane.
                    entry["_dev"] = (str(device), int(stream))
                while len(self._open) > _OPEN_CAP:
                    # Crashed-run backstop: drop the OLDEST open
                    # window (dict preserves insertion order) rather
                    # than grow with abandoned batches.
                    self._open.pop(next(iter(self._open)))
            elif lane == "retire":
                phases = self._open.pop(key, {})
                phases["retire"] = (t0, t1)
                win = self._window_event(ev, phases)
                if win is not None:
                    TRACE_TIMELINE_EVENTS.inc()
                    self.ring.put_nowait(win)

    @staticmethod
    def _window_event(retire_ev: Dict[str, Any],
                      phases: Dict[str, Tuple[float, float]]
                      ) -> Optional[Dict[str, Any]]:
        """Bound attribution for one retired batch: which of
        max(t_stage, t_h2d, t_kernel) bound it, and by how much over
        the runner-up (the margin a perfect pipeline of this shape
        cannot hide)."""
        dev, stream = phases.pop("_dev", (retire_ev["device"],
                                          retire_ev["stream"]))
        durs = {lane: t1 - t0 for lane, (t0, t1) in phases.items()}
        comps = [(durs.get(lane, 0.0), lane)
                 for lane in _BOUND_COMPONENTS]
        comps.sort(reverse=True)
        (best, binding), (second, _) = comps[0], comps[1]
        if best <= 0.0:
            return None  # phases never recorded (partial run)
        t0 = min(t0 for t0, _ in phases.values())
        t1 = max(t1 for _, t1 in phases.values())
        win = {
            "lane": "window", "batch": retire_ev["batch"],
            "scope": retire_ev["scope"], "device": dev,
            "stream": stream,
            "ts_us": tracing.perf_to_us(t0),
            "dur_us": max(0, int((t1 - t0) * 1e6)),
            "binding": binding,
            "margin_us": max(0, int((best - second) * 1e6)),
            "phases_us": {lane: int(d * 1e6)
                          for lane, d in sorted(durs.items())},
        }
        if "trace" in retire_ev:
            win["trace"] = retire_ev["trace"]
        return win

    def snapshot(self) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring (JSON-safe; what
        node.trace.export and the benches export)."""
        with self._lock:
            return [dict(ev) for ev in self.ring]

    def clear(self) -> None:
        """Test/bench hook: empty the ring and drop open windows."""
        with self._lock:
            while True:
                try:
                    self.ring.get_nowait()
                except Exception:
                    break
            self._open.clear()


# THE process-wide recorder (the pipeline writes here; multiple
# concurrent runs interleave by design — events carry their trace id).
RECORDER = FlightRecorder()


# -- Chrome-trace export ----------------------------------------------------
#
# Event shapes emitted (the trace-event format's stable core):
#   {"ph": "M", "name": "process_name"|"thread_name", "pid", ["tid"],
#    "args": {"name": ...}}                       — lane naming
#   {"ph": "X", "name", "ts", "dur", "pid", "tid", "args": {...}}
#                                                  — complete events
# ts/dur are microseconds; events are sorted by ts (metadata first) so
# validate_chrome_trace can assert monotonicity, which chrome://tracing
# and Perfetto both accept directly.

PID_SPANS = 1
PID_TIMELINE = 2


def _timeline_tid_name(ev: Dict[str, Any]) -> str:
    """Lane naming: per-device h2d/kernel streams, per-worker stage
    lanes, one retire lane, one window (bound-attribution) lane — the
    'per-device stage/H2D/kernel/retire lanes' the export promises."""
    lane = ev.get("lane", "?")
    dev = ev.get("device", "")
    scope = ev.get("scope", "pipeline")
    prefix = "" if scope == "pipeline" else f"{scope} "
    if dev:
        # Pipeline devices are jax device ids ("0"); identify-scope
        # events carry the backend name instead.
        dev_label = f"dev{dev}" if scope == "pipeline" else dev
        return f"{prefix}{dev_label} {lane}"
    if lane == "stage":
        return f"{prefix}stage/w{ev.get('stream', 0)}"
    return f"{prefix}{lane}"


def _node_trace_events(spans: List[Dict[str, Any]],
                       timeline: List[Dict[str, Any]],
                       node_name: str, pid_spans: int, pid_timeline: int,
                       shift_us: int = 0
                       ) -> Tuple[List[Dict[str, Any]],
                                  List[Dict[str, Any]]]:
    """One node's (meta, events) pair: span lanes under `pid_spans`,
    timeline lanes under `pid_timeline`, every timestamp shifted by
    `shift_us` (how the fleet merger aligns a remote node's wall clock
    onto the assembling node's axis; 0 for the local export)."""
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid_spans, "ts": 0,
         "args": {"name": f"{node_name}: spans"}},
        {"ph": "M", "name": "process_name", "pid": pid_timeline, "ts": 0,
         "args": {"name": f"{node_name}: pipeline timeline"}},
    ]

    # Span lanes: one tid per trace id, in order of first appearance —
    # a cross-node trace's local spans line up in one lane.
    trace_tids: Dict[str, int] = {}
    for rec in spans:
        if "ts_us" not in rec:
            continue  # pre-upgrade record shape (no start timestamp)
        trace = str(rec.get("trace", "?"))
        tid = trace_tids.get(trace)
        if tid is None:
            tid = len(trace_tids) + 1
            trace_tids[trace] = tid
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": pid_spans, "tid": tid, "ts": 0,
                         "args": {"name": f"trace {trace}"}})
        args = {k: v for k, v in rec.items() if k not in ("span", "ms")}
        events.append({
            "ph": "X", "name": str(rec.get("span", "?")),
            "ts": max(0, int(rec["ts_us"]) + shift_us),
            "dur": max(0, int(float(rec.get("ms", 0.0)) * 1000)),
            "pid": pid_spans, "tid": tid, "args": args,
        })

    # Timeline lanes.
    lane_tids: Dict[str, int] = {}
    for ev in timeline:
        if "ts_us" not in ev:
            continue
        lane_name = _timeline_tid_name(ev)
        tid = lane_tids.get(lane_name)
        if tid is None:
            tid = len(lane_tids) + 1
            lane_tids[lane_name] = tid
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": pid_timeline, "tid": tid, "ts": 0,
                         "args": {"name": lane_name}})
        if ev.get("lane") == "window":
            name = f"bound:{ev.get('binding', '?')}"
        else:
            name = f"{ev.get('lane', '?')} b{ev.get('batch', '?')}"
        args = {k: v for k, v in ev.items() if k != "ts_us"}
        events.append({
            "ph": "X", "name": name,
            "ts": max(0, int(ev["ts_us"]) + shift_us),
            "dur": max(0, int(ev.get("dur_us", 0))),
            "pid": pid_timeline, "tid": tid, "args": args,
        })
    return meta, events


def chrome_trace(spans: Optional[List[Dict[str, Any]]] = None,
                 timeline: Optional[List[Dict[str, Any]]] = None,
                 node_name: str = "node") -> Dict[str, Any]:
    """Span ring + pipeline timeline → one Chrome-trace JSON document.

    Defaults pull from the live process (the whole tracing ring, the
    process recorder); callers with their own captures — the CLI
    validating a fetched artifact, tests with synthetic events — pass
    them explicitly.
    """
    if spans is None:
        spans = tracing.recent_spans(limit=tracing.span_ring_capacity())
    if timeline is None:
        timeline = RECORDER.snapshot()

    meta, events = _node_trace_events(
        spans, timeline, node_name, PID_SPANS, PID_TIMELINE)
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "node": node_name,
            "spans": len([r for r in spans if "ts_us" in r]),
            "timeline_events": len(timeline),
            "generator": "spacedrive_tpu flight recorder",
        },
        "traceEvents": meta + events,
    }


def fleet_chrome_trace(rows: List[Dict[str, Any]],
                       trace: Optional[str] = None,
                       fleet_name: str = "fleet") -> Dict[str, Any]:
    """N nodes' span/timeline captures → ONE Chrome-trace document
    with per-node pid lanes (node i gets pids 2i+1 / 2i+2, named
    after the node), every remote timestamp shifted onto the
    assembling node's clock by that node's estimated skew.

    `rows` are dicts: {"node": name, "spans": [...], "timeline":
    [...], "skew_s": float} — skew_s is "how far ahead of the local
    wall clock this node's clock runs" (fleet.py estimates it from
    obs-poll RTT midpoints), so local_ts = remote_ts - skew. The
    per-node offsets are recorded in otherData.clock_skew_s so the
    correction is auditable, not silent."""
    meta: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    skews: Dict[str, float] = {}
    names: List[str] = []
    for i, row in enumerate(rows):
        name = str(row.get("node") or f"node{i}")
        skew_s = float(row.get("skew_s") or 0.0)
        names.append(name)
        skews[name] = round(skew_s, 6)
        m, e = _node_trace_events(
            row.get("spans") or [], row.get("timeline") or [],
            name, 2 * i + 1, 2 * i + 2,
            shift_us=-int(skew_s * 1e6))
        meta.extend(m)
        events.extend(e)
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    other: Dict[str, Any] = {
        "node": fleet_name,
        "nodes": names,
        "clock_skew_s": skews,
        "spans": sum(1 for e in events if e["pid"] % 2 == 1),
        "timeline_events": sum(1 for e in events if e["pid"] % 2 == 0),
        "generator": "spacedrive_tpu fleet observatory",
    }
    if trace:
        other["trace"] = str(trace)
    return {
        "displayTimeUnit": "ms",
        "otherData": other,
        "traceEvents": meta + events,
    }


def write_trace_artifact(path: str, node_name: str) -> List[str]:
    """The benches' shared --trace export: build the live process's
    trace, validate, and write it ONLY when schema-clean. Returns the
    problem list (empty = written) — the caller decides how to fail.
    One implementation so the export/validate/write sequence cannot
    drift between overlap_bench, perf_smoke, and future tools."""
    import json

    from . import persist

    doc = chrome_trace(node_name=node_name)
    problems = validate_chrome_trace(doc)
    if problems:
        return problems
    persist.atomic_write("flight.trace", path,
                         json.dumps(doc, indent=1))
    return []


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema gate for an exported trace. Returns problem strings
    (empty = valid): required keys per event kind, numeric µs
    timestamps, monotone ts over the complete events, and a named
    process/thread for every pid/tid an event lands in — the contract
    the golden-file test and `tools/trace_export.py --json` pin."""
    problems: List[str] = []
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        return ["top level must be a dict with a traceEvents list"]
    named_pids = set()
    named_tids = set()
    last_ts: Optional[int] = None
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                problems.append(
                    f"{where}: unknown metadata {ev.get('name')!r}")
                continue
            if not isinstance(ev.get("pid"), int):
                problems.append(f"{where}: metadata needs an int pid")
                continue
            if not isinstance(ev.get("args"), dict) or \
                    "name" not in ev["args"]:
                problems.append(f"{where}: metadata needs args.name")
                continue
            if ev["name"] == "process_name":
                named_pids.add(ev["pid"])
            else:
                if not isinstance(ev.get("tid"), int):
                    problems.append(
                        f"{where}: thread_name needs an int tid")
                    continue
                named_tids.add((ev["pid"], ev["tid"]))
        elif ph == "X":
            missing = [k for k in ("name", "ts", "dur", "pid", "tid")
                       if k not in ev]
            if missing:
                problems.append(f"{where}: missing keys {missing}")
                continue
            if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0 \
                    or not isinstance(ev["dur"], (int, float)) \
                    or ev["dur"] < 0:
                problems.append(
                    f"{where}: ts/dur must be non-negative numbers")
                continue
            if not isinstance(ev["pid"], int) \
                    or not isinstance(ev["tid"], int):
                problems.append(f"{where}: pid/tid must be ints")
                continue
            if last_ts is not None and ev["ts"] < last_ts:
                problems.append(
                    f"{where}: ts {ev['ts']} < previous {last_ts} — "
                    "complete events must be sorted")
            last_ts = int(ev["ts"])
            if ev["pid"] not in named_pids:
                problems.append(
                    f"{where}: pid {ev['pid']} has no process_name "
                    "metadata")
            if (ev["pid"], ev["tid"]) not in named_tids:
                problems.append(
                    f"{where}: pid/tid {ev['pid']}/{ev['tid']} has no "
                    "thread_name metadata")
        else:
            problems.append(f"{where}: unknown ph {ph!r}")
    if "displayTimeUnit" in doc and \
            doc["displayTimeUnit"] not in ("ms", "ns"):
        problems.append(
            f"displayTimeUnit {doc['displayTimeUnit']!r} not ms/ns")
    return problems
