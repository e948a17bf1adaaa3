"""Node-wide telemetry: the process-global metrics registry.

The reference leans on the `tracing`/`tracing-subscriber` ecosystem for
in-process observability (SURVEY §5); the TPU-native equivalent is this
registry plus the hierarchical spans in `tracing.py`. Counters, gauges,
and fixed-bucket histograms live in ONE process-global namespace and are
served three ways: Prometheus text on `GET /metrics`, the `node.metrics`
rspc query, and periodic `TelemetrySnapshot` events on the node event
bus (node.py TelemetryReporter).

Design constraints, in order:

- **Cheap hot path.** Every increment starts with one module-global
  flag check; when telemetry is disabled (`SDTPU_TELEMETRY=off` or
  `set_enabled(False)`) that check is the WHOLE cost — the regression
  budget (tests/test_telemetry.py) holds it under 5 µs/call with
  typical cost ~0.1 µs. Enabled increments take one per-metric lock
  (leaf lock, never held around any other lock) so thread-pool workers
  never lose updates.
- **Central namespace.** Every metric family is defined at the bottom
  of THIS module and imported by the instrumented code;
  `tools/telemetry_lint.py` (run in tier-1) fails the build on
  families registered anywhere else or on name collisions (since
  round 9 the lint is sdlint's telemetry pass; the shim remains).
  Names follow `sd_<layer>_<what>[_total|_seconds|_bytes]` with
  layers jobs | identifier | sync | p2p | store | api | trace |
  sanitize | jit | task | timeout | chan | health | sql | chaos |
  backoff | wire.
- **Windowed reads without resets.** Counters and histograms expose
  `snapshot_delta(cursor)` — an exact delta view since a previous
  cursor — so the health observatory (health.py) can compute windowed
  rates and percentiles while the cumulative families `/metrics`
  serves keep their meaning forever (a delta reader NEVER resets the
  registry; consecutive deltas telescope exactly, even under
  concurrent increments).
- **No dependencies.** Pure stdlib plus the equally dependency-free
  flag registry (flags.py) — importable from every layer (store, p2p,
  ops) without cycles.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import flags

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "render_prometheus",
    "enabled", "set_enabled", "reset",
]

# Module-global hot-path switch: one LOAD_GLOBAL in every increment.
# Rebound (not mutated) by set_enabled so readers need no lock.
_ENABLED = flags.get("SDTPU_TELEMETRY")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Toggle all hot-path recording (process-wide). Values already
    recorded stay; disabled increments are dropped, not buffered."""
    global _ENABLED
    _ENABLED = bool(flag)


def _fmt_num(v: float) -> str:
    """Prometheus sample formatting: integral values without the .0."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[Any]) -> str:
    return ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values))


class _Metric:
    """Shared shell: name/help/labels plumbing. A metric with
    `labelnames` is a parent that only vends children via `labels()`;
    a metric without is itself the single sample."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple, "_Metric"] = {}

    def labels(self, **kv: Any) -> "_Metric":
        """Child metric for one label-value combination (created on
        first use, cached forever — label cardinality is expected to be
        tiny: status names, backend names, phase names)."""
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(kv[n] for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = type(self)(self.name, self.help,
                                       **self._child_kwargs())
                    self._children[key] = child
        return child

    def _child_kwargs(self) -> Dict[str, Any]:
        return {}

    def samples(self) -> List[Tuple[Optional[Dict[str, Any]], "_Metric"]]:
        """The flat sample list: (labels, child) per label combination
        for a labeled parent, [(None, self)] for a bare metric — what
        the health sampler iterates to spool every series."""
        if self.labelnames:
            with self._lock:
                items = sorted(self._children.items())
            return [(dict(zip(self.labelnames, key)), child)
                    for key, child in items]
        return [(None, self)]

    # -- introspection ----------------------------------------------------

    def _sample(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _zero(self) -> None:
        raise NotImplementedError

    def snapshot_value(self) -> Dict[str, Any]:
        if self.labelnames:
            return {
                "kind": self.kind,
                "labelnames": list(self.labelnames),
                "labeled": [
                    {"labels": dict(zip(self.labelnames, key)),
                     **child._sample()}
                    for key, child in sorted(self._children.items())
                ],
            }
        return {"kind": self.kind, **self._sample()}

    def reset(self) -> None:
        self._zero()
        for child in list(self._children.values()):
            child._zero()


class Counter(_Metric):
    """Monotonic float counter (Prometheus `counter`)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot_delta(self, cursor: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Windowed counter view: the value delta since `cursor` (a
        previous call's ``"cursor"``), plus the new cursor. Exact
        under concurrency — increments commit under the metric lock,
        so consecutive deltas telescope to the true total with
        nothing lost or double-counted, and the cumulative value is
        never touched (no reset). A value BELOW the cursor means the
        registry was reset mid-window (bench isolation); the delta
        then restarts from zero instead of going negative."""
        v = self._value
        prev = 0.0 if cursor is None else float(cursor)
        return {"value": v - prev if v >= prev else v, "cursor": v}

    def _sample(self) -> Dict[str, Any]:
        return {"value": self._value}

    def _zero(self) -> None:
        with self._lock:
            self._value = 0.0

    def _render(self, out: List[str], labels: str) -> None:
        suffix = f"{{{labels}}}" if labels else ""
        out.append(f"{self.name}{suffix} {_fmt_num(self._value)}")


class Gauge(Counter):
    """Set-to-current-value metric (Prometheus `gauge`)."""

    kind = "gauge"

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative bucket counts + sum + count.

    Buckets are upper bounds; +Inf is implicit. `observe` is one
    bisect + three adds under the metric lock."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def _child_kwargs(self) -> Dict[str, Any]:
        return {"buckets": self.buckets}

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def state(self) -> Tuple[Tuple[int, ...], float, int]:
        """Atomic (counts, sum, count) copy under the metric lock —
        the cursor `snapshot_delta` consumes. counts are per-bucket
        (non-cumulative), +Inf last."""
        with self._lock:
            return (tuple(self._counts), self._sum, self._count)

    def snapshot_delta(self, cursor: Optional[Tuple] = None
                       ) -> Dict[str, Any]:
        """Windowed histogram view since `cursor` (a previous call's
        ``"cursor"``): per-bucket NON-cumulative delta counts aligned
        with `self.buckets` (+Inf last), delta sum/count, and the new
        cursor. The read is one locked state copy, so a window's
        totals are exact even while worker threads observe
        concurrently — and the cumulative registry is never reset
        (windowed percentiles come from bucket-delta interpolation in
        health.py, not from zeroing). A shrunken state means the
        registry was reset mid-window; the delta restarts from the
        fresh values instead of going negative."""
        counts, s, n = self.state()
        if cursor is None:
            d_counts, d_sum, d_count = list(counts), s, n
        else:
            pc, ps, pn = cursor
            d_counts = [c - p for c, p in zip(counts, pc)]
            d_sum, d_count = s - ps, n - pn
            if d_count < 0 or any(c < 0 for c in d_counts):
                d_counts, d_sum, d_count = list(counts), s, n
        return {"counts": d_counts, "sum": d_sum, "count": d_count,
                "cursor": (counts, s, n)}

    def _sample(self) -> Dict[str, Any]:
        cum, cums = 0, []
        for c in self._counts[:-1]:
            cum += c
            cums.append(cum)
        return {
            "count": self._count, "sum": round(self._sum, 6),
            "buckets": [[le, n] for le, n in zip(self.buckets, cums)]
            + [["+Inf", self._count]],
        }

    def _zero(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def _render(self, out: List[str], labels: str) -> None:
        prefix = labels + "," if labels else ""
        cum = 0
        for le, c in zip(self.buckets, self._counts):
            cum += c
            out.append(
                f'{self.name}_bucket{{{prefix}le="{_fmt_num(le)}"}} {cum}')
        out.append(f'{self.name}_bucket{{{prefix}le="+Inf"}} {self._count}')
        suffix = f"{{{labels}}}" if labels else ""
        out.append(f"{self.name}_sum{suffix} {_fmt_num(self._sum)}")
        out.append(f"{self.name}_count{suffix} {self._count}")


class MetricsRegistry:
    """Name → metric map with collision detection. One process-global
    instance (REGISTRY) is the node-wide namespace; tests construct
    private ones for golden-format checks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                # Re-registration with an identical spec returns the
                # existing family (module re-imports); anything else is
                # a namespace collision and fails loudly.
                want_buckets = (
                    tuple(sorted(float(b) for b in kw["buckets"]))
                    if "buckets" in kw else None)
                if (type(existing) is cls
                        and existing.labelnames == tuple(labelnames)
                        and (want_buckets is None
                             or want_buckets == existing.buckets)):
                    return existing
                raise ValueError(
                    f"metric name collision: {name} already registered "
                    f"as {existing.kind}")
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def families(self) -> Dict[str, _Metric]:
        """Shallow copy of the name → family map (the health sampler's
        iteration surface; a copy so registration during the walk —
        module imports from another thread — cannot break it)."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe {name: sample} map — the TelemetrySnapshot event
        payload and the node.metrics query result."""
        return {name: m.snapshot_value()
                for name, m in sorted(self._metrics.items())}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            if m.labelnames:
                for key, child in sorted(m._children.items()):
                    child._render(out, _label_str(m.labelnames, key))
            else:
                m._render(out, "")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Zero every value (bench/test isolation). Metric objects stay
        registered — module-level references remain valid. Best-effort
        vs concurrent increments: a racing inc may land before or after
        its family is zeroed, never corrupt it."""
        for m in self._metrics.values():
            m.reset()


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# Metric families — THE node-wide namespace. Every family used anywhere
# in the package is defined here and imported by the instrumented code;
# tools/telemetry_lint.py fails tier-1 on families registered elsewhere.
# ---------------------------------------------------------------------------

# -- jobs (jobs/manager.py, jobs/worker.py, jobs/report.py) -----------------
JOBS_INGESTED = counter(
    "sd_jobs_ingested_total", "Jobs accepted by JobManager.ingest")
JOBS_DUPLICATE_REJECTED = counter(
    "sd_jobs_duplicate_rejected_total",
    "Jobs rejected because an identical job was running/queued")
JOBS_RESUMED = counter(
    "sd_jobs_resumed_total", "Paused/interrupted jobs re-admitted "
    "(resume + cold_resume)")
JOBS_EARLY_FINISH = counter(
    "sd_jobs_early_finish_total",
    "Jobs that completed at init via EarlyFinish (nothing to do)")
JOBS_STEP_ERRORS = counter(
    "sd_jobs_step_errors_total",
    "Non-fatal step errors recorded into job reports")
JOBS_COMPLETED = counter(
    "sd_jobs_completed_total", "Jobs reaching a final status",
    labelnames=("status",))
JOBS_RUNNING = gauge(
    "sd_jobs_running", "Jobs currently running under the worker pool")
JOBS_QUEUED = gauge(
    "sd_jobs_queued", "Jobs waiting in the manager FIFO queue")
JOB_DURATION_SECONDS = histogram(
    "sd_job_duration_seconds", "Wall time of finished job runs",
    labelnames=("name",),
    buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 60, 300, 1800))
JOB_STEP_SECONDS = histogram(
    "sd_job_step_seconds", "Wall time of individual job steps",
    labelnames=("name",))
JOBS_ITEMS_PROCESSED = counter(
    "sd_jobs_items_processed_total",
    "Completed task-count units (steps/chunks) by finished jobs",
    labelnames=("name",))
JOBS_ITEMS_PER_SEC = gauge(
    "sd_jobs_items_per_sec",
    "items/s of the most recently finished run of each job",
    labelnames=("name",))

# -- identifier (objects/identifier.py, ops/staging.py) ---------------------
IDENT_BATCHES = counter(
    "sd_identifier_batches_total",
    "CAS hashing batches dispatched, by resolved backend "
    "(jax = device pipeline; native/numpy/oracle = host planes)",
    labelnames=("backend",))
IDENT_BATCH_FILES = histogram(
    "sd_identifier_batch_files", "Files per CAS hashing batch",
    buckets=(1, 16, 64, 256, 1024, 4096, 16384, 65536))
IDENT_BYTES_HASHED = counter(
    "sd_identifier_bytes_hashed_total",
    "Payload bytes fed to the CAS hashers (sampled large-file rows "
    "count their 57344-byte payload, small files their real size)")
IDENT_DEVICE_FALLBACK = counter(
    "sd_identifier_device_fallback_total",
    "auto-backend batches that downgraded jax->host (link probe said "
    "the H2D link loses to the native plane)")
IDENT_READ_ERRORS = counter(
    "sd_identifier_read_errors_total",
    "Files dropped from CAS batches by read errors")
IDENT_FILES = counter(
    "sd_identifier_files_total",
    "Identifier outcomes per file", labelnames=("outcome",))
IDENT_PHASE_SECONDS = counter(
    "sd_identifier_phase_seconds_total",
    "Per-phase cost attribution of identifier steps (the phase_ms "
    "split, as live counters)", labelnames=("phase",))

# -- pipeline (ops/overlap.py depth-N identify pipeline) --------------------
PIPELINE_DEPTH_HIGH_WATER = gauge(
    "sd_pipeline_depth_high_water",
    "Most batches simultaneously in flight (stage→H2D→kernel→fetch) "
    "observed in the depth-N identify pipeline since process start "
    "(≤ SDTPU_PIPELINE_DEPTH by construction)")
PIPELINE_STAGE_STALL_SECONDS = counter(
    "sd_pipeline_stage_stall_seconds_total",
    "Dispatcher time spent waiting on the staged-batch channel — the "
    "un-hidden remainder when staging is the pipeline bottleneck")
PIPELINE_RETIRE_STALL_SECONDS = counter(
    "sd_pipeline_retire_stall_seconds_total",
    "Retirer time spent waiting on the in-flight window — pipeline "
    "starvation (H2D/kernel slower than the fetch side)")
PIPELINE_H2D_BYTES = counter(
    "sd_pipeline_h2d_bytes_total",
    "Host→device bytes transferred by the pipeline dispatchers "
    "(simulated-link runs count the simulated bytes too)")
PIPELINE_H2D_SECONDS = counter(
    "sd_pipeline_h2d_seconds_total",
    "Wall seconds the pipeline dispatchers spent in host→device "
    "transfer (including the SDTPU_SIM_LINK_GBPS injected delay)")
PIPELINE_DONATED_REUSE = counter(
    "sd_pipeline_donated_reuse_total",
    "Staged device buffers consumed by donated kernel dispatches "
    "(each is allocator space recycled for a later batch's H2D "
    "instead of pinned until digest retirement)")
PIPELINE_DEVICE_BATCHES = counter(
    "sd_pipeline_device_batches_total",
    "Batches dispatched per local device by the round-robin pipeline",
    labelnames=("device",))

# -- stage pool (ops/staging.py shared staging executor) --------------------
STAGE_POOL_WORKERS = gauge(
    "sd_stage_pool_workers",
    "Worker threads of the shared staging ThreadPoolExecutor "
    "(ops/staging.py) — 0 when the pool is shut down, so shutdown-"
    "leak tests can see its lifecycle")

# -- native packed staging (ops/staging.py stage_batch_native) --------------
STAGE_NATIVE_BYTES = counter(
    "sd_stage_native_bytes_total",
    "Message bytes (prefix + payload) staged by the native packed "
    "backend (sd_stage_batch) straight into pooled H2D source pages")
STAGE_BATCHES = counter(
    "sd_stage_batches_total",
    "Batches staged for the device CAS pipeline, by backend: `native` "
    "is the packed zero-copy path, `python` the stage_files + "
    "build_cas_messages host path (flag off, .so missing, or pool "
    "exhausted)",
    labelnames=("backend",))
STAGE_FALLBACK_FILES = counter(
    "sd_stage_fallback_files_total",
    "Files that degraded PER-FILE from the native packed reader to "
    "the Python reader (bad row status: vanished, permission, short "
    "read, chaos-injected EIO) inside an otherwise-native batch")
STAGE_POOL_BUFFERS = gauge(
    "sd_stage_pool_buffers",
    "Pooled staging pages currently checked out to in-flight batches "
    "(StagePool occupancy; the ops.stage.pool window meters the same "
    "edge with overflow detection)")
STAGE_POOL_HIGH_WATER = gauge(
    "sd_stage_pool_high_water",
    "Peak concurrent StagePool checkouts since process start — how "
    "close the ring came to the declared pool bound")

# -- sync (sync/manager.py, sync/ingest.py, sync/opblob.py) -----------------
SYNC_OPS_ENCODED = counter(
    "sd_sync_ops_encoded_total",
    "CRDT ops appended to the local op log, by storage format",
    labelnames=("format",))
SYNC_BLOB_PAGES_WRITTEN = counter(
    "sd_sync_blob_pages_written_total",
    "Page-level shared_op_blob rows written by bulk writers")
SYNC_OPS_SERVED = counter(
    "sd_sync_ops_served_total",
    "Ops served to pulling peers via get_ops (both storage formats)")
SYNC_OPS_INGESTED = counter(
    "sd_sync_ops_ingested_total",
    "Remote ops offered to receive_crdt_operations")
SYNC_OPS_APPLIED = counter(
    "sd_sync_ops_applied_total",
    "Remote ops that won LWW and mutated the replica")
SYNC_INGEST_ERRORS = counter(
    "sd_sync_ingest_errors_total",
    "Remote ops that failed ingest (savepoint rolled back)")
SYNC_INGEST_PAGES = counter(
    "sd_sync_ingest_pages_total",
    "Pull-loop pages drained through the ingest actor")
SYNC_BLOB_PAGES_APPLIED = counter(
    "sd_sync_blob_pages_applied_total",
    "Clone-stream blob pages applied, fast (batched, LWW-compare "
    "proven no-op) vs fallback (per-op)", labelnames=("path",))
SYNC_BLOBS_EXPLODED = counter(
    "sd_sync_blobs_exploded_total",
    "Blob pages exploded into indexed op rows (first remote ingest)")
SYNC_CLONE_WINDOW_STALLS = counter(
    "sd_sync_clone_window_stalls_total",
    "Times the clone-stream originator blocked on a watermark ack "
    "with CLONE_WINDOW pages in flight (receiver backpressure)")
SYNC_CLONE_PAGES_RELAYED = counter(
    "sd_sync_clone_pages_relayed_total",
    "Blob pages relayed verbatim to pulling peers (serving side)")

# -- p2p (p2p/proto.py, p2p/sync_net.py) ------------------------------------
P2P_TUNNEL_BYTES_SENT = counter(
    "sd_p2p_tunnel_bytes_sent_total",
    "Frame payload bytes written to p2p tunnels (post-encryption)")
P2P_TUNNEL_BYTES_RECV = counter(
    "sd_p2p_tunnel_bytes_recv_total",
    "Frame payload bytes read from p2p tunnels (pre-decryption)")
P2P_TUNNELS_OPENED = counter(
    "sd_p2p_tunnels_opened_total", "Authenticated tunnels established")
P2P_ROUTE_CACHE_HITS = counter(
    "sd_p2p_route_cache_hits_total",
    "Peer-route resolutions answered from the healthy-tunnel cache")
P2P_ROUTE_CACHE_MISSES = counter(
    "sd_p2p_route_cache_misses_total",
    "Peer-route resolutions that had to scan discovery")
P2P_RECONNECTS = counter(
    "sd_p2p_reconnects_total",
    "Announce rounds that lost a peer mid-stream (route invalidated; "
    "next round re-resolves)")

# -- store (store/db.py) ----------------------------------------------------
STORE_TX = counter(
    "sd_store_tx_total", "Write transactions committed through tx()")
STORE_COMMIT_SECONDS = histogram(
    "sd_store_commit_seconds", "COMMIT latency of write transactions",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5))
STORE_WRITE_LOCK_WAIT_SECONDS = histogram(
    "sd_store_write_lock_wait_seconds",
    "Time spent waiting for the per-database write lock",
    buckets=(0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1, 5, 30))
STORE_BUSY_RETRIES = counter(
    "sd_store_busy_retries_total",
    "Write-transaction commits retried under the declared store.busy "
    "backoff after sqlite BUSY (an external writer — or an injected "
    "store.commit chaos fault — holding the file lock): the retry "
    "degrades the fault to latency instead of failing the job")
STORE_GROUP_COMMITS = counter(
    "sd_store_group_commits_total",
    "Fat transactions committed by the single-writer group-commit "
    "actor (store/actor.py) — each one carries sd_store_group_size "
    "coalesced write batches")
STORE_GROUP_SIZE = histogram(
    "sd_store_group_size",
    "Write batches coalesced per group commit — 1 means the actor "
    "found no concurrency to exploit (the raw-tx shape), the "
    "SDTPU_STORE_GROUP_MAX ceiling means writers queue faster than "
    "COMMIT retires them",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
STORE_GROUP_WAIT_SECONDS = histogram(
    "sd_store_group_wait_seconds",
    "A write batch's whole trip through the actor: queue wait + "
    "batches coalesced ahead of it + the group COMMIT (the write "
    "path's end-to-end latency, vs the store.actor.write budget)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120))
STORE_GROUP_SHUTDOWN_DRAINS = counter(
    "sd_store_group_shutdown_drains_total",
    "Write batches failed loudly (never silently dropped) because "
    "the actor shut down with them still queued — each one's "
    "completion future resolves exactly once with the shutdown error")
STORE_INIT_WARNINGS = counter(
    "sd_store_init_warnings_total",
    "Non-fatal problems swallowed while opening a library database "
    "(e.g. the lazy-index drop failing on a corrupt library) — "
    "logged at debug, surfaced here so health can see a bad open")

# -- sql statement contracts (store/statements.py + store/sqlaudit.py) ------
SQL_STATEMENTS = counter(
    "sd_sql_statements_total",
    "Executions per declared statement/shape name (runtime SQL "
    "auditor; `_adhoc` = diagnostic reads through db.query)",
    labelnames=("name",))
SQL_ROWS = counter(
    "sd_sql_rows_total",
    "Rows flowing through each declared statement: fetched for reads "
    "(counted by Database.run), affected for writes (cursor rowcount)",
    labelnames=("name",))
SQL_UNDECLARED = counter(
    "sd_sql_undeclared_total",
    "Statements that matched no declared contract or shape — a "
    "sql_undeclared sanitizer violation outside the ad-hoc read "
    "allowance (raised in tier-1, counted in production)")
SQL_TX_STATEMENTS = histogram(
    "sd_sql_tx_statements",
    "Statements executed per committed write transaction — the "
    "commit-per-item anti-pattern reads as a spike at 1-2",
    buckets=(1, 2, 5, 10, 25, 100, 500, 1000, 5000, 20000))
SQL_SCAN = counter(
    "sd_sql_scan_total",
    "EXPLAIN-sampled executions whose query plan full-scans a "
    "registered large table (SDTPU_SQL_EXPLAIN sampling mode)",
    labelnames=("name",))

# -- api (api/server.py) ----------------------------------------------------
API_REQUESTS = counter(
    "sd_api_requests_total", "HTTP requests served, by route template",
    labelnames=("route",))

# -- tracing (tracing.py, flight.py) ----------------------------------------
TRACE_SPANS = counter(
    "sd_trace_spans_total", "Spans recorded into the ring buffer",
    labelnames=("ok",))
TRACE_TIMELINE_EVENTS = counter(
    "sd_trace_timeline_events_total",
    "Pipeline timeline events recorded by the flight recorder "
    "(flight.py): per-batch stage/H2D/kernel/retire phases plus the "
    "per-batch bound-attribution windows")

# -- sanitizer (sanitize.py) ------------------------------------------------
SANITIZE_VIOLATIONS = counter(
    "sd_sanitize_violations_total",
    "Runtime-sanitizer detections (SDTPU_SANITIZE=1), by kind: "
    "loop_stall | lock_across_await | lock_order_cycle | "
    "jit_retrace_budget | host_transfer | task_exception | "
    "task_orphaned | chan_overflow | data_race | sql_undeclared | "
    "sql_autocommit_write | persist_undeclared_write | "
    "persist_unfsynced_rename",
    labelnames=("kind",))
SANITIZE_LOOP_MAX_STALL = gauge(
    "sd_sanitize_loop_max_stall_seconds",
    "Longest single event-loop callback observed by the sanitizer "
    "since process start (0 while the sanitizer is off)")

# -- thread-safety (threadctx.py ownership registry) ------------------------
RACE_TRACKED_WRITES = counter(
    "sd_race_tracked_writes_total",
    "Attribute/container writes recorded by the armed threadctx write "
    "recorder (declared owner classes only; 0 while the race guard is "
    "off)")
RACE_CANDIDATES = counter(
    "sd_race_candidates_total",
    "Writes that broke their declared ownership contract — one attr "
    "written from >=2 threads with an empty lockset intersection, a "
    "second thread on a loop_only/single_thread attr, or a post-init "
    "write to an immutable one. Each is a data_race sanitizer "
    "violation (raised in tier-1, counted in production)",
    labelnames=("cls_attr",))
RACE_HANDOFF_CLOSED = counter(
    "sd_race_handoff_closed_total",
    "Cross-thread loop hand-offs (threadctx.call_threadsafe) dropped "
    "because the target event loop was already closed mid-shutdown — "
    "work that is moot by definition, counted instead of crashing the "
    "posting executor thread")

# -- jit contracts (ops/jit_registry.py) ------------------------------------
JIT_RETRACES = counter(
    "sd_jit_retraces_total",
    "New jit traces (cache growth) observed by the retrace guard, per "
    "registered contract name",
    labelnames=("fn",))
JIT_CACHE_SIZE = gauge(
    "sd_jit_cache_size",
    "Current process-wide trace count per registered jit contract "
    "(compared against the contract's max_traces budget)",
    labelnames=("fn",))
JIT_DECLARED_TRANSFERS = counter(
    "sd_jit_declared_transfers_total",
    "Entries into declared io() host-transfer scopes, per contract "
    "name (the sanctioned D2H points of the device pipelines)",
    labelnames=("fn",))

# -- task supervisor (tasks.py) ---------------------------------------------
TASK_SPAWNED = counter(
    "sd_task_spawned_total",
    "Tasks registered with the structured-concurrency supervisor, by "
    "ownership path (instance #seq stripped)",
    labelnames=("owner",))
TASK_ORPHANED = counter(
    "sd_task_orphaned_total",
    "Supervised tasks that survived a shutdown reap's grace period "
    "(SDTPU_TASK_REAP_S) — each is a task_orphaned sanitizer "
    "violation")
TASK_CANCEL_LATENCY = histogram(
    "sd_task_cancel_latency_seconds",
    "Seconds from a supervisor cancel() to the task actually "
    "finishing (shutdown responsiveness of the component tree)")

# -- channel contracts (channels.py) ----------------------------------------
CHAN_DEPTH = gauge(
    "sd_chan_depth",
    "Instantaneous item depth per registered channel (channels.py); "
    "multi-instance channels (per-tunnel windows, per-subscription ws "
    "buffers) sample the most recently updated instance",
    labelnames=("name",))
CHAN_HIGH_WATER = gauge(
    "sd_chan_high_water",
    "Deepest observed depth per registered channel since process "
    "start (monotonic across instance churn; the armed sanitizer "
    "raises when depth would exceed the declared capacity)",
    labelnames=("name",))
CHAN_SHED = counter(
    "sd_chan_shed_total",
    "Items dropped or coalesced away by a channel's overflow policy "
    "(shed_oldest eviction, shed_new rejection, coalesce replacement)",
    labelnames=("name",))
CHAN_PUT_BLOCK_SECONDS = histogram(
    "sd_chan_put_block_seconds",
    "Producer wait for space on block-policy channels (only waits are "
    "observed, not instant puts) — the backpressure actually exerted",
    labelnames=("name",),
    buckets=(0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120))

# -- fleet observatory (fleet.py, p2p/obs.py) -------------------------------
OBS_REQUESTS = counter(
    "sd_obs_requests_total",
    "Observability-protocol requests served to peers (p2p/obs.py "
    "serve_obs — the p2p obs.* handler and the rspc obs.* queries "
    "both dispatch through it), by request kind "
    "(metrics | health | trace | error)",
    labelnames=("what",))
FLEET_POLLS = counter(
    "sd_fleet_polls_total",
    "Fleet-observatory peer poll attempts (fleet.py), by outcome: "
    "ok | unreachable (connect/timeout failure, peer row goes "
    "stale-degraded) | malformed (snapshot rejected by the schema "
    "gate without touching the fleet view)",
    labelnames=("outcome",))
FLEET_PEERS = gauge(
    "sd_fleet_peers",
    "Peers currently registered with the fleet observatory's poller "
    "(paired p2p routes plus explicitly added clients)")
FLEET_PEERS_STALE = gauge(
    "sd_fleet_peers_stale",
    "Registered peers whose last good obs.health snapshot is older "
    "than 2x the poll interval (or who never answered) — each is a "
    "degraded row in the fleet view with last-seen evidence")

# -- health observatory (health.py) -----------------------------------------
HEALTH_STATE = gauge(
    "sd_health_state",
    "Per-subsystem saturation state computed by the health "
    "observatory's engine (health.py): 0 = ok, 1 = degraded, "
    "2 = saturated. The attribution behind each non-ok state is "
    "served by the node.health rspc query / subscription",
    labelnames=("subsystem",))
HEALTH_SAMPLES = counter(
    "sd_health_samples_total",
    "Sampler observations taken by the health observatory (each "
    "spools delta-snapshots of every registered family into the "
    "health.series rings and re-evaluates saturation)")

# -- timeout contracts (timeouts.py) ----------------------------------------
TIMEOUTS_FIRED = counter(
    "sd_timeout_fired_total",
    "Declared network-await budgets that fired, per contract name "
    "(timeouts.py registry) — which peers/paths are hanging",
    labelnames=("name",))

# -- backoff contracts (timeouts.py declare_backoff) -------------------------
BACKOFF_RETRIES = counter(
    "sd_backoff_retries_total",
    "Retries scheduled under a declared backoff policy (timeouts.py "
    "registry), per policy name — each is one jittered-exponential "
    "delay actually imposed on a failing operation",
    labelnames=("name",))
BACKOFF_GAVE_UP = counter(
    "sd_backoff_gave_up_total",
    "Backoff ladders exhausted (max_tries reached) per declared "
    "policy name — the operation stops retrying and degrades (the "
    "sync announcer hands the peer to the fleet observatory as "
    "stale; callers of with_backoff see the final exception)",
    labelnames=("name",))

# -- chaos plane (chaos.py) --------------------------------------------------
CHAOS_INJECTED = counter(
    "sd_chaos_injected_total",
    "Faults injected by the armed chaos plane (chaos.py, SDTPU_CHAOS "
    "spec), per declared fault point and kind — counted BEFORE the "
    "effect lands so artifacts reconcile observed degradation "
    "against injected cause. 0 forever while disarmed",
    labelnames=("name", "kind"))

# -- incident observatory (incidents.py) -------------------------------------
INCIDENTS_OPENED = counter(
    "sd_incident_opened_total",
    "Evidence bundles snapshot-frozen by the incident observatory "
    "(incidents.py), per declared trigger kind — each is one durable "
    "postmortem written to the incidents.store channel's on-disk "
    "bound",
    labelnames=("kind",))
INCIDENTS_DEDUPED = counter(
    "sd_incident_deduped_total",
    "Trigger firings collapsed into an existing fingerprint "
    "(subsystem + resource + kind) inside its "
    "SDTPU_INCIDENT_WINDOW_S rate-limit window — a storm shows up "
    "here, not as a store full of identical bundles")
INCIDENTS_DROPPED = counter(
    "sd_incident_dropped_total",
    "Bundles evicted from the bounded incidents.store (count cap via "
    "the declared channel's shed_oldest, byte cap via "
    "SDTPU_INCIDENT_STORE_MB) — evidence lost to the bound; the "
    "health observatory flags a non-zero delta under the incidents "
    "subsystem")
INCIDENTS_RECOVERED = counter(
    "sd_incident_recovered_total",
    "Partially-written bundles found at next-boot WAL recovery, by "
    "outcome: promoted (complete .json.tmp renamed into the store) | "
    "discarded (torn tmp unlinked — the crash landed mid-write)",
    labelnames=("outcome",))
INCIDENT_OPEN = gauge(
    "sd_incident_open",
    "Unacknowledged bundles currently in the incidents store — the "
    "untriaged postmortem backlog (incidents.ack drains it)")
INCIDENT_STORE_BYTES = gauge(
    "sd_incident_store_bytes",
    "Bytes of bundle JSON currently held by the on-disk incidents "
    "store, enforced below SDTPU_INCIDENT_STORE_MB by oldest-first "
    "eviction")

# -- persistence plane (persist.py) ------------------------------------------
PERSIST_WRITES = counter(
    "sd_persist_writes_total",
    "Durable writes committed through the declared persistence seam "
    "(persist.py registry), per artifact name — atomic/WAL file "
    "commits, sealed streams, scratch acquisitions, and DB-backed "
    "append commits all count here",
    labelnames=("name",))
PERSIST_FSYNC_SECONDS = histogram(
    "sd_persist_fsync_seconds",
    "Latency of fsync calls issued by the persist seam (file fsyncs "
    "before rename, directory fsyncs after) — slow-disk weather on "
    "the durability path shows up here before it shows up as job "
    "latency")
PERSIST_VIOLATIONS = counter(
    "sd_persist_violations_total",
    "Fs-auditor detections (persist.arm, with the sanitizer), by "
    "kind: persist_undeclared_write (raw os.replace from a product "
    "module outside the seam) | persist_unfsynced_rename (rename "
    "with no preceding file fsync against the artifact's declared "
    "policy) — raised in tier-1, counted in production",
    labelnames=("kind",))

# -- wire plane (p2p/wire.py) ------------------------------------------------
WIRE_FRAMES = counter(
    "sd_wire_frames_total",
    "Frames validated by the armed wire auditor at the pack/unpack "
    "seam, per declared message name and direction (`in` = decoded "
    "off a transport, `out` = encoded toward one) — the live census "
    "of which declared contracts actually carry traffic",
    labelnames=("name", "dir"))
WIRE_VIOLATIONS = counter(
    "sd_wire_violations_total",
    "Wire-auditor detections (wire.arm, with the sanitizer), by "
    "kind: undeclared (frame matching no declared contract) | "
    "schema (declared kind, payload drifted from its schema) | "
    "size_cap (frame over its declared cap) | proto_skew (version "
    "const mismatch) — raised in tier-1, counted in production",
    labelnames=("kind",))
WIRE_BYTES = counter(
    "sd_wire_bytes_total",
    "Payload bytes carried by audited frames, per declared message "
    "name (plaintext msgpack size at the tunnel seam — AEAD and "
    "length-header overhead excluded), so one chatty contract's "
    "share of the mesh is attributable by name",
    labelnames=("name",))
