"""Depth-N staging → H2D → kernel → D2H ring, measured for real.

Port of ``spacedrive_tpu/ops/overlap.py``: native staging, host-to-device
copies and the BLAKE3 kernel overlap, so the end-to-end rate is set by the
slowest stage, not their sum.

    stagers (k):      stage(i+1) .. stage(i+k)        threads, C plane
    dispatch (per device): H2D on a copy stream, K1 on a compute stream
    retire:           digests back, leases returned   one thread

- **depth** is the ring's slot count: at most `depth` batches are in
  flight from stage start to digest retirement (a semaphore of `depth`
  tickets), and every hand-off is a ``queue.Queue`` of capacity `depth`.
  Depth 1 is the serial reference.
- **staging** runs ``min(depth, batches - 1)`` stager threads, each calling
  ``staging.stage_batch_native`` (the ctypes call releases the interpreter
  lock) with `n_threads` C-plane threads into a page of one ``StagePool``
  of ``depth + 1`` pages, pinned when the devices are CUDA devices. The
  stagers share the host's cores: ``n_threads`` defaults to the cores over
  the stagers, rounded up, so a deep ring stages on no fewer threads than a
  serial one.
- **streams**: each CUDA device has a dispatch thread with its own copy and
  compute ``torch.cuda.Stream``. The copy is issued ``non_blocking`` from
  the pinned page on the copy stream and an event marks its end; the
  compute stream waits on that event and runs the kernel, whose digests go
  ``non_blocking`` into a pinned ``[B, 8]`` buffer, marked by a second
  event. The JAX package's donated ring has its twin in the caching
  allocator: the staged device buffers, allocated on the copy stream, are
  ``record_stream(compute)``-ed, so their memory serves a later batch's copy
  only once the kernel that reads them is done.
- **retire**: the retire thread waits for a batch's digest event, then
  (its copy long complete) returns the batch's page to the pool. A page is
  never rewritten while a copy reads it.
- **devices** take batches round-robin (one dispatch thread each). A CPU
  device runs the same ring with plain copies and the plain kernel, so the
  CPU tests drive every thread and hand-off.
- **sim-link mode** (`sim_link_gbps`): every copy also sleeps
  bytes / rate on its dispatch thread, so CPU runs pin the overlap math
  deterministically.

Calibration is the JAX package's: one serial, component-timed batch before
the run, one after, and one every `calibrate_every` batches in between (the
stagers hold at the milestone, the ring drains, the components are timed,
the ring resumes; only the timing itself leaves the measured wall). Its
bound differs in one term: the JAX package divided one stager's staging
time by the depth, assuming stagers multiply the staging rate; here the
calibration stages on all the stagers' threads at once and the bound takes
that time as is (on the H100 host the C plane's rate did not grow with
more concurrent stagers, PERF.md).

Observability, as in the JAX package: the whole run executes inside a
``pipeline.run`` span, and every measured batch's stage, h2d, kernel and
retire phases land in the flight recorder (``flight.RECORDER``) stamped
with that span's trace id; the retire closes the batch's window, whose
``binding`` names which of stage, h2d and kernel bound it. On a CUDA
device the h2d and kernel lanes come from the batch's CUDA events
(``h2d_start`` → ``copied`` on the copy stream, ``kernel_start`` →
``kernel_end`` around the launch on the compute stream), read in the
retirer once ``done`` has completed and placed by their elapsed time
from ``h2d_start``, which is anchored to the host clock at the moment it
was recorded: the h2d lane's length is the same copy time ``h2d_s``
sums, and the kernel lane leaves out the batch's wait behind earlier
kernels on the compute stream. The hand-offs take their capacity from the declared
``ops.pipeline.staged`` / ``ops.pipeline.inflight`` channels (capped at
the depth), and the ``sd_pipeline_*`` families count what the stats
report. The kernel launch runs inside the ``overlap.kernel`` device
scope and the calibration's digest fetch in the declared
``overlap.retire`` io (ops/kernel_registry.py).

Left out of this slice: the flag table (depth, devices and the simulated
link are arguments) and the mesh-derived device ring (queue A7:
multi-GPU).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import blake3_batch as bb
from . import blake3_cuda, blake3_torch, cas, kernel_registry, staging
from .. import channels, tracing
from ..flight import RECORDER, new_run_token
from ..telemetry import (PIPELINE_DEPTH_HIGH_WATER, PIPELINE_DEVICE_BATCHES,
                         PIPELINE_H2D_BYTES, PIPELINE_H2D_SECONDS,
                         PIPELINE_RETIRE_STALL_SECONDS, PIPELINE_STAGE_STALL_SECONDS)

# Deepest ring a run may ask for (the JAX package's declared channel cap).
MAX_PIPELINE_DEPTH = 8
# How often a blocked hand-off looks for an aborted run.
_POLL_S = 0.05
_DONE = object()  # end of the staged stream, one per dispatch thread
LARGE_STRIDE = staging._grid_for(cas.LARGE_PAYLOAD_SIZE)[1]


@dataclass
class PipelineStats:
    files: int = 0
    wall_s: float = 0.0       # measured loop time, calibration EXCLUDED
    stage_s: float = 0.0      # dispatcher stall waiting on staged batches
    retire_stall_s: float = 0.0  # retirer stall waiting on dispatches
    calibration_s: float = 0.0  # time spent in mid-run calibration pauses
    batches: int = 0
    batch_files: int = 0
    # Shape of this run (the bound below depends on it).
    depth: int = 1
    n_devices: int = 1
    streams_overlap: bool = False  # copy and kernel on separate streams
    sim_link_gbps: float = 0.0
    n_stagers: int = 1
    n_threads: int = 1        # C-plane threads per stager's staging call
    # Transfer accounting: bytes copied to the devices and the copies' time
    # (device time between CUDA events on the copy stream, host time for a
    # CPU device), simulated link sleeps included.
    h2d_bytes: int = 0
    h2d_s: float = 0.0
    depth_high_water: int = 0
    per_device_batches: Dict[str, int] = field(default_factory=dict)
    # Staging mix, warm-up and calibration included: batches the C plane
    # staged whole, and batches in which the per-file ladder's Python reader
    # staged at least one row (`fallback_files` rows in all).
    stage_native_batches: int = 0
    stage_python_batches: int = 0
    fallback_files: int = 0
    # Batches the kernel ran on, warm-up and calibration included.
    kernel_batches: int = 0
    # The staging pool: pinned bytes and their allocation time (set-up,
    # outside the measured wall).
    pool_pages: int = 0
    pinned_bytes: int = 0
    pin_alloc_s: float = 0.0
    leases_out: int = 0       # pages still checked out when the run ended
    # (stage, h2d, kernel) seconds of each serial calibration batch: one
    # before the run, one after, and one at every mid-run milestone, so the
    # bound comes from the same run as the measurement. The calibration
    # stages on n_threads x the number of stagers.
    samples: List[Tuple[float, float, float]] = field(default_factory=list)
    t_stage_1: float = 0.0
    t_h2d_1: float = 0.0
    t_kernel_1: float = 0.0
    t_stage_2: float = 0.0
    t_h2d_2: float = 0.0
    t_kernel_2: float = 0.0
    # Guards every field more than one thread writes.
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def files_per_sec(self) -> float:
        return self.files / self.wall_s if self.wall_s else 0.0

    @property
    def staging_backend(self) -> str:
        """'native' / 'python' / 'mixed': which reader staged this run."""
        if self.stage_native_batches and self.stage_python_batches:
            return "mixed"
        return "native" if self.stage_native_batches else "python"

    def _component_bests(self) -> Tuple[float, float, float]:
        def best(idx: int) -> float:
            vals = [s[idx] for s in self.samples if s[idx] > 0]
            return min(vals) if vals else 0.0
        return best(0), best(1), best(2)

    @property
    def bound_files_per_sec(self) -> float:
        """What a perfect ring of this run's shape would sustain under the
        best same-run calibration. Staging is one shared resource: the
        calibration stages a batch on every stager's threads at once, and
        the stagers together cannot beat that (the C plane already spreads
        one batch over its threads, so `depth` stagers share the cores
        rather than multiply them). Each device serializes its copies and
        its kernels, which overlap each other only where they run on
        separate streams (a CUDA device; a CPU device runs both on its
        dispatch thread). The ring's depth caps overall concurrency (depth
        1: the serial sum)."""
        t_s, t_h, t_k = self._component_bests()
        n_dev = max(self.n_devices, 1)
        depth = max(self.depth, 1)
        per_device = max(t_h, t_k) if self.streams_overlap else t_h + t_k
        denom = max(per_device / n_dev, t_s, (t_s + t_h + t_k) / depth)
        return self.batch_files / denom if denom else 0.0

    @property
    def bound_spread(self) -> float:
        """max/min of the binding component across calibration samples: how
        much the host's weather moved under the ring (1.0 = stable)."""
        if not self.samples:
            return 1.0
        which = max(range(3), key=lambda i: self._component_bests()[i])
        vals = [s[which] for s in self.samples if s[which] > 0]
        return max(vals) / min(vals) if vals else 1.0

    def bound_report(self) -> dict:
        """Measured rate, bound, their ratio, and, when measured < 0.9 x
        bound, a reason drawn from this run's calibration spread."""
        bound = self.bound_files_per_sec
        measured = self.files_per_sec
        ratio = measured / bound if bound else 0.0
        reason = None
        if bound and ratio < 0.9:
            names = ("stage", "h2d", "kernel")
            which = max(range(3), key=lambda i: self._component_bests()[i])
            mid = max(0, len(self.samples) - 2)
            reason = (
                f"bound uses the best of {len(self.samples)} same-run "
                f"calibrations of the binding '{names[which]}' stage, "
                f"which varied {self.bound_spread:.2f}x within this "
                f"run; the measured rate averages over the troughs "
                f"the best sample missed"
                + (f", and {mid} mid-run pause(s) each leave one "
                   f"pipeline refill un-overlapped in the measured wall"
                   if mid else ""))
        return {"measured_files_per_sec": round(measured, 1),
                "bound_files_per_sec": round(bound, 1),
                "ratio": round(ratio, 3),
                "depth": self.depth,
                "devices": self.n_devices,
                "calibrations": len(self.samples),
                "binding_component_spread": round(self.bound_spread, 2),
                "reason": reason}


class _Aborted(Exception):
    """Another thread of the ring failed; this one stops."""


@dataclass
class _InFlight:
    """One dispatched batch, from its copy to its retirement."""

    index: int
    lease: staging.StageLease
    digests: torch.Tensor            # [B, 8] int32 on the host (pinned on CUDA)
    label: str
    h2d_start: Optional[torch.cuda.Event] = None
    copied: Optional[torch.cuda.Event] = None
    # Recorded on the compute stream around the launch: the kernel lane is
    # the kernel alone, not its wait behind earlier batches on the stream.
    kernel_start: Optional[torch.cuda.Event] = None
    kernel_end: Optional[torch.cuda.Event] = None
    done: Optional[torch.cuda.Event] = None
    h2d_host_s: float = 0.0          # host-side copy time (CPU) + simulated link
    # Host perf_counter when h2d_start was recorded (the lanes' anchor),
    # and on a CPU device the host-timed kernel, from the anchor.
    t_anchor: float = 0.0
    kernel_from_s: float = 0.0
    kernel_host_s: float = 0.0


class _Ring:
    """State and stages of one run_overlapped call."""

    def __init__(self, batches, kernel, devs, depth, sim_link_gbps, n_threads,
                 stats: PipelineStats):
        self.batches = batches
        self.kernel = kernel
        self.devs = devs
        self.depth = depth
        self.sim = float(sim_link_gbps or 0.0)
        self.n_threads = n_threads
        self.stats = stats
        self.cuda = devs[0].type == "cuda"
        self.n_stagers = max(1, min(depth, len(batches) - 1))
        rows = max(len(p) for p, _ in batches)
        self.pool = staging.StagePool(devs[0], depth + 1,
                                      staging.StagePool.bytes_for(rows, LARGE_STRIDE))
        stats.pool_pages = self.pool.pages
        stats.pinned_bytes = self.pool.pinned_bytes
        stats.pin_alloc_s = self.pool.alloc_s
        # (copy, compute) streams per device; None on a CPU device.
        self.streams = [(torch.cuda.Stream(d), torch.cuda.Stream(d)) if self.cuda
                        else (None, None) for d in devs]
        self.abort = threading.Event()
        self.error: Optional[BaseException] = None
        # The flight recorder's stamps: the enclosing pipeline.run span's
        # trace and this run's token (set by run_overlapped).
        self.trace: Optional[str] = None
        self.run_token: Optional[int] = None

    # -- the three stages -------------------------------------------------

    def stage(self, i: int, n_threads: int) -> staging.NativeStaged:
        """Stage batch i into a pool page; a row that fails both readers
        fails the run."""
        paths, sizes = self.batches[i]
        staged = staging.stage_batch_native(list(zip(paths, sizes.tolist())),
                                            self.pool, n_threads=n_threads)
        if staged.errors:
            staged.release()
            raise OSError(f"staging errors: {list(staged.errors.values())[:3]}")
        with self.stats._lock:
            if staged.fallback_files:
                self.stats.stage_python_batches += 1
                self.stats.fallback_files += staged.fallback_files
            else:
                self.stats.stage_native_batches += 1
        return staged

    def dispatch(self, d: int, i: int, staged: staging.NativeStaged) -> _InFlight:
        """Copy batch i to device d and launch the kernel, without waiting
        for either on a CUDA device."""
        dev, (copy, compute) = self.devs[d], self.streams[d]
        words, lengths = staged.tensors()
        nbytes = words.numel() * 4 + lengths.numel() * 4
        rec = _InFlight(i, staged.lease, None, str(d))
        if not self.cuda:
            t0 = rec.t_anchor = time.perf_counter()
            w, n = blake3_torch.words_to_device(words, lengths, dev)
            self._sim_link(nbytes)
            rec.h2d_host_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            rec.digests = self.kernel(w, n)
            rec.kernel_host_s = time.perf_counter() - t1
            rec.kernel_from_s = t1 - t0
        else:
            with torch.cuda.device(dev):
                rec.h2d_start = torch.cuda.Event(enable_timing=True)
                rec.copied = torch.cuda.Event(enable_timing=True)
                rec.kernel_start = torch.cuda.Event(enable_timing=True)
                rec.kernel_end = torch.cuda.Event(enable_timing=True)
                rec.done = torch.cuda.Event(enable_timing=True)
                rec.h2d_start.record(copy)
                rec.t_anchor = time.perf_counter()
                w, n = blake3_torch.words_to_device(words, lengths, dev, stream=copy,
                                                    non_blocking=True)
                rec.copied.record(copy)
                t0 = time.perf_counter()
                self._sim_link(nbytes)
                rec.h2d_host_s = time.perf_counter() - t0
                compute.wait_event(rec.copied)
                # w and n were allocated on the copy stream: their memory
                # may serve another copy only after the kernel read them.
                w.record_stream(compute)
                n.record_stream(compute)
                with torch.cuda.stream(compute), \
                        kernel_registry.device_scope("overlap.kernel"):
                    rec.kernel_start.record(compute)
                    out = self.kernel(w, n)
                    rec.kernel_end.record(compute)
                    rec.digests = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    rec.digests.copy_(out, non_blocking=True)
                    rec.done.record(compute)
        with self.stats._lock:
            self.stats.kernel_batches += 1
            self.stats.h2d_bytes += nbytes
        PIPELINE_H2D_BYTES.inc(nbytes)
        return rec

    def retire(self, rec: _InFlight) -> np.ndarray:
        """Wait for a batch's digests, return its page, give its digests;
        record the batch's h2d, kernel and retire lanes (which closes its
        window in the flight recorder)."""
        t0r = time.perf_counter()
        h2d_s, kernel_from_s, kernel_s = rec.h2d_host_s, rec.kernel_from_s, rec.kernel_host_s
        try:
            if rec.done is not None:
                rec.done.synchronize()
                rec.copied.synchronize()  # the page's copy has completed
                h2d_s += rec.h2d_start.elapsed_time(rec.copied) / 1e3
                kernel_from_s = rec.h2d_start.elapsed_time(rec.kernel_start) / 1e3
                kernel_s = rec.kernel_start.elapsed_time(rec.kernel_end) / 1e3
        finally:
            rec.lease.release()
        with self.stats._lock:
            self.stats.h2d_s += h2d_s
        PIPELINE_H2D_SECONDS.inc(h2d_s)
        with kernel_registry.io("overlap.retire"):
            digests = bb.tensor_to_words(rec.digests).copy()
        t_kernel = rec.t_anchor + kernel_from_s
        RECORDER.record("h2d", batch=rec.index, t0=rec.t_anchor, t1=rec.t_anchor + h2d_s,
                        device=rec.label, trace=self.trace, run=self.run_token)
        RECORDER.record("kernel", batch=rec.index, t0=t_kernel, t1=t_kernel + kernel_s,
                        device=rec.label, trace=self.trace, run=self.run_token)
        RECORDER.record("retire", batch=rec.index, t0=t0r, t1=time.perf_counter(),
                        trace=self.trace, run=self.run_token)
        return digests

    def _sim_link(self, nbytes: int) -> None:
        if self.sim:
            time.sleep(nbytes / (self.sim * 1e9))

    # -- serial calibration -----------------------------------------------

    def calibrate(self) -> Tuple[float, float, float, np.ndarray]:
        """Batch 0 through the three stages one after another, each timed
        to its end: (stage s, h2d s, kernel + D2H s, digests). The staging
        runs on the ring's whole staging budget (every stager's threads),
        which is what the ring's staging throughput can reach."""
        dev, (copy, compute) = self.devs[0], self.streams[0]
        t0 = time.perf_counter()
        staged = self.stage(0, self.n_threads * self.n_stagers)
        t_stage = time.perf_counter() - t0
        try:
            words, lengths = staged.tensors()
            t0 = time.perf_counter()
            w, n = blake3_torch.words_to_device(words, lengths, dev, stream=copy,
                                                non_blocking=self.cuda)
            if self.cuda:
                copy.synchronize()
            self._sim_link(words.numel() * 4 + lengths.numel() * 4)
            t_h2d = time.perf_counter() - t0
            t0 = time.perf_counter()
            with torch.cuda.stream(compute) if self.cuda else nullcontext(), \
                    kernel_registry.device_scope("overlap.kernel"):
                out = self.kernel(w, n)
                with kernel_registry.io("overlap.retire"):
                    digests = blake3_torch.digests_to_numpy(out)
            t_kernel = time.perf_counter() - t0
        finally:
            if self.cuda:
                copy.synchronize()
            staged.release()
        with self.stats._lock:
            self.stats.kernel_batches += 1
        return t_stage, t_h2d, t_kernel, digests

    # -- the measured loop ------------------------------------------------

    def fail(self, exc: BaseException) -> None:
        if self.error is None:
            self.error = exc
        self.abort.set()

    def _put(self, q: queue.Queue, item) -> None:
        while True:
            if self.abort.is_set():
                raise _Aborted
            try:
                q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _get(self, q: queue.Queue):
        while True:
            if self.abort.is_set():
                raise _Aborted
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                continue

    def run(self, results: List[Optional[np.ndarray]], calibrate_every: int) -> None:
        """Batches 1.. through the ring; fills `results`; raises the first
        failure of any thread after every thread stopped and every lease
        came back."""
        n = len(self.batches)
        stats = self.stats
        n_stagers = self.n_stagers
        milestones = list(range(calibrate_every + 1, n - 1, calibrate_every))
        staged_q: queue.Queue = queue.Queue(
            maxsize=min(self.depth, channels.capacity("ops.pipeline.staged")))
        retire_q: queue.Queue = queue.Queue(
            maxsize=min(self.depth, channels.capacity("ops.pipeline.inflight")))
        tickets = threading.Semaphore(self.depth)
        cond = threading.Condition()
        state = {"next": 1, "in_flight": 0, "retired": 0,
                 "limit": milestones[0] if milestones else n, "pending": milestones,
                 "pause_s": 0.0}

        def stager() -> None:
            while True:
                with cond:
                    cond.wait_for(lambda: self.abort.is_set() or state["next"] >= n
                                  or state["next"] <= state["limit"])
                    if self.abort.is_set() or state["next"] >= n:
                        return
                    i = state["next"]
                    state["next"] = i + 1
                while not tickets.acquire(timeout=_POLL_S):
                    if self.abort.is_set():
                        return
                with cond:
                    state["in_flight"] += 1
                    with stats._lock:
                        stats.depth_high_water = max(stats.depth_high_water,
                                                     state["in_flight"])
                    if stats.depth_high_water > PIPELINE_DEPTH_HIGH_WATER.value:
                        PIPELINE_DEPTH_HIGH_WATER.set(stats.depth_high_water)
                t0 = time.perf_counter()
                staged = self.stage(i, self.n_threads)
                RECORDER.record("stage", batch=i, t0=t0, t1=time.perf_counter(),
                                trace=self.trace, run=self.run_token)
                try:
                    self._put(staged_q, (i, staged))
                except _Aborted:
                    staged.release()
                    return

        def dispatcher(d: int) -> None:
            while True:
                t0 = time.perf_counter()
                p0 = state["pause_s"]
                item = self._get(staged_q)
                # A calibration pause that ended during this wait is its own
                # account, not a staging stall.
                wait = max(0.0, time.perf_counter() - t0 - (state["pause_s"] - p0))
                with stats._lock:
                    stats.stage_s += wait
                PIPELINE_STAGE_STALL_SECONDS.inc(wait)
                if item is _DONE:
                    return
                i, staged = item
                try:
                    rec = self.dispatch(d, i, staged)
                except BaseException:
                    if self.cuda:
                        self.streams[d][0].synchronize()
                    staged.release()
                    raise
                with stats._lock:
                    stats.per_device_batches[rec.label] = \
                        stats.per_device_batches.get(rec.label, 0) + 1
                PIPELINE_DEVICE_BATCHES.labels(device=rec.label).inc()
                try:
                    self._put(retire_q, rec)
                except _Aborted:
                    self._drain(rec)
                    raise

        def retirer() -> None:
            while state["retired"] < n - 1:
                t0 = time.perf_counter()
                rec = self._get(retire_q)
                wait = time.perf_counter() - t0
                with stats._lock:
                    stats.retire_stall_s += wait
                PIPELINE_RETIRE_STALL_SECONDS.inc(wait)
                results[rec.index] = self.retire(rec)
                tickets.release()
                with cond:
                    state["retired"] += 1
                    state["in_flight"] -= 1
                    calibrate = bool(state["pending"]) and \
                        state["retired"] == state["pending"][0]
                if calibrate:
                    # The stagers hold at the milestone and the ring has
                    # drained: time the serial components, then resume.
                    t_pause = time.perf_counter()
                    sample = self.calibrate()
                    pause = time.perf_counter() - t_pause
                    with stats._lock:
                        stats.samples.append(sample[:3])
                        stats.calibration_s += pause
                    with cond:
                        state["pause_s"] += pause
                        state["pending"].pop(0)
                        state["limit"] = state["pending"][0] if state["pending"] else n
                        cond.notify_all()

        def guarded(fn, *args):
            def body():
                try:
                    fn(*args)
                except _Aborted:
                    pass
                except BaseException as exc:  # handed to the caller below
                    self.fail(exc)
                    with cond:
                        cond.notify_all()
            return body

        stagers = [threading.Thread(target=guarded(stager), name=f"ring-stage-{k}")
                   for k in range(n_stagers)]
        dispatchers = [threading.Thread(target=guarded(dispatcher, d),
                                        name=f"ring-dispatch-{d}")
                       for d in range(len(self.devs))]
        retire_thread = threading.Thread(target=guarded(retirer), name="ring-retire")
        t_start = time.perf_counter()
        threads = [*stagers, *dispatchers, retire_thread]
        for t in threads:
            t.start()
        try:
            for t in stagers:
                t.join()
            for _ in dispatchers:
                self._put(staged_q, _DONE)
        except _Aborted:
            pass
        finally:
            for t in threads:
                t.join()
            stats.wall_s = time.perf_counter() - t_start - state["pause_s"]
            for q in (staged_q, retire_q):
                self._drain_queue(q)
        if self.error is not None:
            raise self.error

    def _drain(self, rec: _InFlight) -> None:
        """Return an in-flight batch's page once its copy has completed."""
        if rec.copied is not None:
            rec.copied.synchronize()
        rec.lease.release()

    def _drain_queue(self, q: queue.Queue) -> None:
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _InFlight):
                self._drain(item)
            elif item is not _DONE:
                item[1].release()  # staged, never copied


def _check_batches(batches) -> None:
    if not batches:
        raise ValueError("run_overlapped needs at least one batch")
    for paths, sizes in batches:
        sizes = np.asarray(sizes)
        if len(paths) == 0 or sizes.shape != (len(paths),):
            raise ValueError("each batch is (paths, [len(paths)] sizes), non-empty")
        if np.any(sizes <= cas.MINIMUM_FILE_SIZE):
            raise ValueError("the ring takes large-class files only "
                             f"(> {cas.MINIMUM_FILE_SIZE} bytes)")


def run_overlapped(
    batches: Sequence[Tuple[Sequence[str], np.ndarray]],
    kernel: Optional[Callable] = None,
    calibrate_every: Optional[int] = None,
    *,
    depth: int,
    devices: Sequence,
    sim_link_gbps: float = 0.0,
) -> Tuple[List[np.ndarray], PipelineStats]:
    """Run the depth-N ring over pre-split file batches.

    batches: [(paths, sizes_u64)], all large-class (> 100 KiB) files.
    kernel: (words, lengths) → [B, 8] int32 digests on the batch's device;
        default ``blake3_cuda.blake3_words`` (K1 on a CUDA device, the plain
        torch version on a CPU one).
    calibrate_every: re-time the serial components every this many measured
        batches (default: about two mid-run pauses).
    depth: batches in flight at once (1 to MAX_PIPELINE_DEPTH).
    devices: where the batches go, round-robin: CUDA devices (which must
        exist: nothing falls back) or CPU devices, not both.
    sim_link_gbps: when > 0, each copy also sleeps bytes / rate.

    Returns ([per-batch [B, 8] uint32 digests], stats), row-aligned with
    each batch's paths. Batch 0 runs as the warm-up and calibration batch;
    the measured wall covers batches 1.. and excludes the calibrations.

    The whole run executes inside a ``pipeline.run`` span, and every
    measured batch lands in the flight recorder stamped with its trace id.
    """
    with tracing.span("pipeline.run", batches=len(batches)):
        return _run_overlapped(batches, kernel, calibrate_every, depth=depth,
                               devices=devices, sim_link_gbps=sim_link_gbps)


def _run_overlapped(batches, kernel, calibrate_every, *, depth, devices,
                    sim_link_gbps):
    _check_batches(batches)
    if not devices:
        raise ValueError("run_overlapped needs at least one device")
    devs = [blake3_torch.resolve_device(d) for d in devices]
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices must be all CUDA or all CPU, got {devs}")
    depth = max(1, min(int(depth), MAX_PIPELINE_DEPTH))
    n_stagers = max(1, min(depth, len(batches) - 1))
    n_threads = -(-staging.default_threads() // n_stagers)  # per stager
    stats = PipelineStats(batches=len(batches), batch_files=len(batches[0][0]),
                          depth=depth, n_devices=len(devs),
                          streams_overlap=devs[0].type == "cuda",
                          sim_link_gbps=float(sim_link_gbps or 0.0),
                          n_stagers=n_stagers, n_threads=n_threads)
    ring = _Ring(batches, kernel or blake3_cuda.blake3_words, devs, depth,
                 sim_link_gbps, n_threads, stats)
    ring.trace, ring.run_token = tracing.current_trace_id(), new_run_token()
    if calibrate_every is None:
        calibrate_every = max(2, (len(batches) - 1) // 3)

    ring.calibrate()  # warm-up: first launches, page faults, allocator
    s0 = ring.calibrate()
    stats.samples.append(s0[:3])
    results: List[Optional[np.ndarray]] = [None] * len(batches)
    results[0] = s0[3]
    if len(batches) > 1:
        ring.run(results, calibrate_every)
    stats.files = sum(len(p) for p, _ in batches[1:])
    stats.samples.append(ring.calibrate()[:3])
    stats.leases_out = ring.pool.in_use
    (stats.t_stage_1, stats.t_h2d_1, stats.t_kernel_1) = stats.samples[0]
    (stats.t_stage_2, stats.t_h2d_2, stats.t_kernel_2) = stats.samples[-1]
    return results, stats


def make_sparse_corpus(root: str, n_files: int, file_size: int,
                       batch: int) -> List[Tuple[List[str], np.ndarray]]:
    """n_files sparse files of `file_size` bytes, split into batches.

    Sparse (truncate-created) files exercise the exact staging path, open
    and pread through the C plane, at memory speed, so the ring measures
    staging, transfer and kernel overlap rather than the host's disk."""
    os.makedirs(root, exist_ok=True)
    batches = []
    for b0 in range(0, n_files, batch):
        paths = []
        for i in range(b0, min(b0 + batch, n_files)):
            p = os.path.join(root, f"f{i:07d}.bin")
            if not os.path.exists(p):
                with open(p, "wb") as f:
                    f.truncate(file_size)
            paths.append(p)
        sizes = np.full(len(paths), file_size, dtype=np.uint64)
        batches.append((paths, sizes))
    return batches
