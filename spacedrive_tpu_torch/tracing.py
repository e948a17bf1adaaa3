"""Structured tracing + device profiling.

The reference leans on the `tracing` ecosystem (rolling file logs, span
timing at debug level — SURVEY.md §5); the TPU-native equivalent is a
structured span log plus optional `torch.profiler` capture around device
batches:

- `span(name)` times a block and logs one structured line through the
  standard logging machinery (and the node event bus when attached).
  Spans are HIERARCHICAL: each carries a 64-bit trace id shared with
  every span under the same root, its own span id, and its parent's
  span id — propagated via a contextvar, so nesting survives
  `asyncio.to_thread` and task boundaries (both copy the context).
  Every finished span records `ok`/`error` (a body that raised is
  distinguishable in logs and the ring buffer) and lands in a bounded
  ring of recent spans queryable at runtime (`recent_spans`, served by
  the `node.spans` rspc query);
- `device_span(name)` additionally names the block with
  `torch.profiler.record_function` and an NVTX range; when
  `SDTPU_PROFILE=/path` is set, one process-wide `torch.profiler.profile`
  (CPU and CUDA activity) starts at the first device_span and
  `stop_profiler()` writes its Chrome trace into that directory;
- spans PROPAGATE across nodes: `traceparent()` renders the current
  (trace, span) as a compact wire field, `continue_trace(tp)` adopts a
  remote caller's ids so the first span opened inside becomes a child
  of the remote span — one trace id then covers a request end-to-end
  over the p2p/sync/rspc planes (the flight recorder's export path,
  flight.py, renders the merged timeline).

Span NAMES come from the central family registry at the bottom of this
module (`declare_span`): a span name is `<family>` or
`<family>/<variant>`, and the family must be declared — the sdlint
telemetry pass fails the build on an undeclared or fully-dynamic name,
the same scheme discipline metric families get.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import flags, telemetry

logger = logging.getLogger("spacedrive_tpu_torch")

# (trace_id, span_id) of the innermost live span in this context.
_current_span: contextvars.ContextVar[Optional[Tuple[int, int]]] = \
    contextvars.ContextVar("sdtpu_current_span", default=None)

# Bounded ring of recently finished span records (newest last). The
# default 512 records × ~200 B is ~100 KB — queryable at runtime
# without ever growing with uptime; SDTPU_SPAN_RING resizes it (read
# once at import; configure_span_ring() is the re-read hook). Floored
# at 1 like the re-read path: 0/negative would disable the ring (or
# crash deque construction) instead of erroring usefully.
SPAN_RING_CAPACITY = max(1, int(flags.get("SDTPU_SPAN_RING")))
_span_ring: deque = deque(maxlen=SPAN_RING_CAPACITY)
_span_ring_lock = threading.Lock()
# Ids are sequential above a random 48-bit per-process base: cheap to
# mint under the lock, and two NODES (separate processes) joined by
# trace propagation cannot collide on trace ids.
_ID_BASE = (int.from_bytes(os.urandom(6), "big") << 14) + 1
_id_counter = iter(range(_ID_BASE, 1 << 63)).__next__
_id_lock = threading.Lock()

# Wall-clock anchor for span/timeline timestamps: perf_counter gives
# the monotone durations, this epoch aligns them to wall microseconds
# so two nodes' exported traces land on one comparable axis.
_EPOCH = time.time() - time.perf_counter()


def perf_to_us(t_perf: float) -> int:
    """A time.perf_counter() reading as wall-clock microseconds (the
    Chrome-trace `ts` unit)."""
    return int((_EPOCH + t_perf) * 1e6)


def _new_id() -> int:
    with _id_lock:
        return _id_counter()


def span_ring_capacity() -> int:
    return SPAN_RING_CAPACITY


def configure_span_ring() -> int:
    """Re-read SDTPU_SPAN_RING and rebuild the ring, keeping the newest
    records that fit. The flag is otherwise read once at import (the
    ring is module-global); tests and long-lived embedders that change
    the environment call this to apply it."""
    global SPAN_RING_CAPACITY, _span_ring
    cap = max(1, int(flags.get("SDTPU_SPAN_RING")))
    with _span_ring_lock:
        if cap != SPAN_RING_CAPACITY:
            SPAN_RING_CAPACITY = cap
            _span_ring = deque(_span_ring, maxlen=cap)
    return SPAN_RING_CAPACITY


# -- cross-node propagation -------------------------------------------------

def current_trace() -> Optional[Tuple[int, int]]:
    """(trace_id, span_id) of the innermost live span, or None."""
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    """Hex trace id of the innermost live span, or None — what the
    flight recorder stamps on pipeline timeline events."""
    cur = _current_span.get()
    return f"{cur[0]:x}" if cur else None


def traceparent() -> Optional[str]:
    """The current span as a compact `<trace>-<span>` hex wire field —
    carried in p2p headers, sync pull frames, and rspc envelopes so the
    remote side's spans continue this trace instead of rooting a new
    one. None outside any span (the remote side then roots normally)."""
    cur = _current_span.get()
    return f"{cur[0]:x}-{cur[1]:x}" if cur else None


def parse_traceparent(tp: Any) -> Optional[Tuple[int, int]]:
    """Parse a wire traceparent; None for anything malformed — a
    hostile or stale peer field must degrade to a fresh root, never
    raise into the transport handler."""
    if not isinstance(tp, str) or "-" not in tp:
        return None
    trace_s, _, span_s = tp.partition("-")
    try:
        trace_id, span_id = int(trace_s, 16), int(span_s, 16)
    except ValueError:
        return None
    if not (0 < trace_id < 1 << 64 and 0 < span_id < 1 << 64):
        return None
    return trace_id, span_id


@contextlib.contextmanager
def continue_trace(tp: Any):
    """Adopt a remote caller's (trace, span) for the block: spans
    opened inside become children of the remote span, sharing its
    trace id across the wire. A missing/malformed `tp` is a no-op —
    the block's spans root locally as before."""
    parsed = parse_traceparent(tp)
    if parsed is None:
        yield
        return
    token = _current_span.set(parsed)
    try:
        yield
    finally:
        _current_span.reset(token)


def recent_spans(limit: int = 100,
                 trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Newest-last slice of the span ring buffer, optionally filtered
    to one trace. Records are JSON-safe dicts."""
    with _span_ring_lock:
        records = list(_span_ring)
    if trace_id is not None:
        records = [r for r in records if r.get("trace") == trace_id]
    limit = int(limit)
    return records[-limit:] if limit > 0 else []


def clear_span_ring() -> None:
    """Test hook: empty the ring buffer."""
    with _span_ring_lock:
        _span_ring.clear()


# -- trace-correlated structured logging (SDTPU_LOG_JSON) --------------------

class JsonLogFormatter(logging.Formatter):
    """One JSON object per log record, stamped with the CURRENT
    trace/span id at emit time. Emission is synchronous with the
    logging call and the span contextvar survives `asyncio.to_thread`
    and task boundaries, so a worker-side log line inside a span
    carries that span's trace id — log lines join node.spans and the
    flight-recorder export on one correlation key."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        cur = _current_span.get()
        if cur is not None:
            out["trace"] = f"{cur[0]:x}"
            out["span"] = f"{cur[1]:x}"
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


_json_handler: Optional[logging.Handler] = None
_json_handler_lock = threading.Lock()


def install_json_logging(force: bool = False, stream=None) -> bool:
    """Attach the JSON-line handler to the `spacedrive_tpu_torch` logger
    when the SDTPU_LOG_JSON flag is on (or `force` is set). Idempotent
    — one handler per process no matter how many nodes boot. Returns
    whether the handler is installed afterwards."""
    global _json_handler
    with _json_handler_lock:
        if _json_handler is not None:
            return True
        if not force and not flags.get("SDTPU_LOG_JSON"):
            return False
        h = logging.StreamHandler(stream)
        h.setFormatter(JsonLogFormatter())
        logger.addHandler(h)
        _json_handler = h
    return True


def uninstall_json_logging() -> None:
    """Test/embedder hook: detach the JSON handler installed above."""
    global _json_handler
    with _json_handler_lock:
        if _json_handler is not None:
            logger.removeHandler(_json_handler)
            _json_handler = None


class LogRing(logging.Handler):
    """Bounded in-memory log ring: the recoverable copy of the
    process's recent log lines. Records are the same JSON-safe dicts
    the JSON formatter emits — ts/level/logger/msg plus the CURRENT
    trace/span id — held in the declared `tracing.logring` channel
    (shed_oldest), so the tail joins spans and the flight-recorder
    export on one correlation key and never grows with uptime. The
    incident observatory freezes `tail()` into every evidence bundle;
    stderr is write-only, this ring is what survives into a
    postmortem."""

    def __init__(self) -> None:
        super().__init__()
        from . import channels
        self.ring = channels.channel("tracing.logring")

    def emit(self, record: logging.LogRecord) -> None:
        try:
            out: Dict[str, Any] = {
                "ts": round(record.created, 3),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
            cur = _current_span.get()
            if cur is not None:
                out["trace"] = f"{cur[0]:x}"
                out["span"] = f"{cur[1]:x}"
            if record.exc_info and record.exc_info[0] is not None:
                out["exc"] = record.exc_info[0].__name__
            self.ring.put_nowait(out)
        except Exception:
            self.handleError(record)

    def tail(self, limit: int = 100) -> List[Dict[str, Any]]:
        # All ring access is serialized by the handler lock: logging
        # holds it around every emit(), and tail() takes it here — the
        # ring needs no loop affinity of its own.
        with self.lock:
            records = [dict(r) for r in self.ring]
        limit = int(limit)
        return records[-limit:] if limit > 0 else []


_log_ring: Optional[LogRing] = None
_log_ring_lock = threading.Lock()


def install_log_ring(force: bool = False) -> bool:
    """Attach the LogRing handler to the `spacedrive_tpu_torch` logger when
    the SDTPU_LOG_RING flag is on (or `force` is set). Idempotent —
    one ring per process no matter how many nodes boot. Returns
    whether the ring is installed afterwards."""
    global _log_ring
    with _log_ring_lock:
        if _log_ring is not None:
            return True
        if not force and not flags.get("SDTPU_LOG_RING"):
            return False
        h = LogRing()
        logger.addHandler(h)
        _log_ring = h
    return True


def uninstall_log_ring() -> None:
    """Test/embedder hook: detach the LogRing handler."""
    global _log_ring
    with _log_ring_lock:
        if _log_ring is not None:
            logger.removeHandler(_log_ring)
            _log_ring = None


def log_ring_tail(limit: int = 100) -> List[Dict[str, Any]]:
    """Newest-last tail of the installed log ring ([] when the ring
    is not installed) — the bundle-assembly entry point."""
    with _log_ring_lock:
        ring = _log_ring
    return ring.tail(limit) if ring is not None else []


# -- profiler (SDTPU_PROFILE) ----------------------------------------------

# Tri-state probe cache: None = not yet probed, False = profiling off
# (env unset/empty, or a start failure), True = trace running. Cached so
# the device_span hot path is a single attribute check instead of an
# os.environ read per call; reset_profiler_cache() is the documented
# hook for tests/hosts that toggle SDTPU_PROFILE after import.
_profiler_state: Optional[bool] = None
_profiler_lock = threading.Lock()
_profiler = None  # the running torch.profiler.profile
_profile_dir: Optional[str] = None


def reset_profiler_cache() -> None:
    """Forget the cached SDTPU_PROFILE probe so the next device_span
    re-reads the environment (does NOT stop a running trace)."""
    global _profiler_state
    with _profiler_lock:
        if not _profiler_state:
            _profiler_state = None


def _ensure_profiler() -> bool:
    """Start the process-wide ``torch.profiler.profile`` (CPU and CUDA
    activity) once if SDTPU_PROFILE is set. The result — positive or
    negative — is cached; hosts that set the env var after import call
    reset_profiler_cache(). ANY profiling problem — an unwritable path,
    a profiler already running — degrades to plain spans; device
    batches run from thread-pool workers, so the start is lock-guarded.
    A profiler run's memory grows with its length, so it stays opt-in."""
    global _profiler_state, _profiler, _profile_dir
    state = _profiler_state
    if state is not None:
        return state
    with _profiler_lock:
        if _profiler_state is not None:
            return _profiler_state
        profile_dir = flags.get("SDTPU_PROFILE")
        if not profile_dir:
            _profiler_state = False
            return False
        try:
            import torch

            os.makedirs(profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception as e:
            _profiler_state = False
            logger.warning("SDTPU_PROFILE disabled: %s", e)
            return False
        _profiler, _profile_dir = prof, profile_dir
        _profiler_state = True
        import atexit

        # Process-scope flush. Deliberately NOT hooked into per-node
        # shutdown: the profiler is process-global and multiple nodes
        # share one process in tests.
        atexit.register(stop_profiler)
    return True


def stop_profiler() -> Optional[str]:
    """Stop the process-wide profiler and write its Chrome trace into
    the SDTPU_PROFILE directory; returns the file's path (None when no
    profiler ran)."""
    global _profiler_state, _profiler
    with _profiler_lock:
        prof, _profiler = _profiler, None
        if not _profiler_state or prof is None:
            return None
        _profiler_state = None
        prof.__exit__(None, None, None)
        path = os.path.join(_profile_dir,
                            f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def span(name: str, events=None, **fields):
    """Time a block; emit one structured record at debug level (the
    reference's ad-hoc Instant deltas, job/mod.rs:592,638).

    The record carries `trace` (shared by all spans under one root),
    `id`, `parent` (absent for roots), and `ok`/`error` — a raising
    body produces ok=False plus the exception type, so failed phases
    are distinguishable downstream. `events` may be an object with an
    `.emit(dict)` method (the node EventBus) or a bare callable."""
    parent = _current_span.get()
    if parent is None:
        trace_id, parent_id = _new_id(), None
    else:
        trace_id, parent_id = parent[0], parent[1]
    span_id = _new_id()
    token = _current_span.set((trace_id, span_id))
    t0 = time.perf_counter()
    err: Optional[BaseException] = None
    try:
        yield
    except BaseException as e:
        err = e
        raise
    finally:
        _current_span.reset(token)
        ms = (time.perf_counter() - t0) * 1000
        record = {
            "span": name, "ms": round(ms, 2),
            # Start timestamp in wall microseconds: what the Chrome-
            # trace exporter uses as `ts` (dur comes from `ms`), and
            # what makes two nodes' rings mergeable on one axis.
            "ts_us": perf_to_us(t0),
            "trace": f"{trace_id:x}", "id": f"{span_id:x}",
            "ok": err is None,
            **fields,
        }
        if parent_id is not None:
            record["parent"] = f"{parent_id:x}"
        if err is not None:
            record["error"] = type(err).__name__
        telemetry.TRACE_SPANS.labels(
            ok="true" if err is None else "false").inc()
        with _span_ring_lock:
            _span_ring.append(record)
        logger.debug("span %s", record)
        if events is not None:
            emit_fn = getattr(events, "emit", events)
            emit_fn({"type": "TraceSpan", **record})


@contextlib.contextmanager
def device_span(name: str, events=None, **fields):
    """span() + ``torch.profiler.record_function(name)`` and a
    ``torch.cuda.nvtx`` range, so the block names its region in a
    profiler trace (SDTPU_PROFILE) and in an NVTX timeline."""
    _ensure_profiler()
    with span(name, events, **fields), region(name):
        yield


@contextlib.contextmanager
def region(name: str):
    """``torch.profiler.record_function(name)`` plus, where CUDA is up,
    a ``torch.cuda.nvtx`` range: a named region with no span record (the
    kernel registry's device_scope/io labels use it). torch is imported
    here, not at module import, so the registry tables load without it."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# ---------------------------------------------------------------------------
# THE span-name namespace. A span name is `<family>` or
# `<family>/<variant>` (variants carry per-call detail: backend names,
# job names, rspc paths); the family before the first `/` must be
# declared here. Enforced by the sdlint telemetry pass: an undeclared
# family, a fully-dynamic name, or a declare_span() outside this module
# fails the build — span names stay a greppable, documented surface
# exactly like metric families.
# ---------------------------------------------------------------------------

# Import-time declaration registry (bounded by the source text, same
# contract as jobs.JOB_REGISTRY / store.MODELS).
SPAN_FAMILIES: Dict[str, str] = {}  # sdlint: ok[unbounded-growth]

_FAMILY_RE = re.compile(r"^[a-z0-9_.]+$")


def declare_span(family: str, doc: str = "") -> str:
    """Register a span family (tracing.py module bottom only — the
    telemetry pass flags declarations anywhere else)."""
    if not _FAMILY_RE.match(family):
        raise ValueError(
            f"span family {family!r} breaks the scheme "
            "(lowercase dotted, no slash — variants are per-call)")
    if family in SPAN_FAMILIES:
        raise ValueError(f"span family {family!r} declared twice")
    SPAN_FAMILIES[family] = doc
    return family


declare_span(
    "cas_ids",
    "One CAS hashing batch through ops/staging.cas_ids_for_files; the "
    "variant is the resolved backend (cuda, or native for the staging"
    " plane's host hash).")

declare_span(
    "fleet",
    "One fleet-observatory round (fleet.py); variants: poll (pull "
    "every paired peer's obs.health snapshot) and trace (distributed "
    "trace assembly across the fleet).")

declare_span(
    "job",
    "A job worker's whole run (jobs/worker.py); the variant is the "
    "job name. Root of the per-job trace; job.step spans nest under "
    "it.")

declare_span(
    "job.step",
    "One executed job step inside a job/<name> root span.")

declare_span(
    "p2p",
    "One inbound or outbound p2p exchange (p2p/manager.py); the "
    "variant is the header discriminator (ping/pair/spacedrop/file). "
    "Inbound spans continue the dialer's trace via the header's tp "
    "field.")

declare_span(
    "pipeline.run",
    "One depth-N identify pipeline run (ops/overlap.run_overlapped); "
    "the flight recorder's timeline events carry this span's trace "
    "id.")

declare_span(
    "rpc",
    "One rspc query/mutation dispatch on the API host (api/"
    "server.py); the variant is the procedure path. Continues the "
    "client's trace via the X-Sdtpu-Trace header / ws frame tp "
    "field.")

declare_span(
    "sync.pull",
    "The responder half of one sync stream (sync_net."
    "handle_sync_stream): the ingest pull loop, continuing the "
    "originator's trace from the new_ops header.")

declare_span(
    "sync.serve",
    "The originator half of one sync stream (sync_net._originate_one): "
    "announce + serve the peer's pull loop; root of the cross-node "
    "sync trace.")
