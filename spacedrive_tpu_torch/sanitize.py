"""Opt-in runtime sanitizer: the port's copy of the JAX package's
``sanitize.py``.

It checks the engine's discipline rules at runtime, in the spirit of
ThreadSanitizer's dynamic-annotation checking (Serebryany &
Iskhodzhanov, WBIA 2009) scaled down to the three discipline rules this
engine actually depends on:

- **Event-loop stall detector** — every asyncio callback/task step is
  timed (one `Handle._run` wrap, two clock reads); a step hogging the
  loop past `SDTPU_SANITIZE_STALL_S` seconds is a violation. This is
  the runtime twin of sdlint's blocking-in-async pass: whatever the
  interprocedural walk missed shows up here as a measured stall.
- **Lock-order recorder + cycle check** — `tracked_lock()` /
  `tracked_rlock()` wrap the store's locks; each first acquisition
  while other tracked locks are held records held→new edges in a
  process-global lock graph, and an acquisition that would close a
  cycle (the classic AB/BA deadlock — the JAX `store/db.py`'s
  early reader-registration shape) is flagged BEFORE blocking on the lock,
  so `raise` mode surfaces the deadlock instead of hanging CI.
- **Write-lock-held-across-await assertion** — when an event-loop
  callback returns control to the loop with a tracked lock still held
  by the loop thread, a coroutine suspended mid-critical-section (the
  `with db.tx(): ... await ...` anti-pattern): every other task on the
  loop can now deadlock behind a lock whose owner only resumes via the
  same loop.
- **Device-contract guards** (armed via `ops/kernel_registry.arm()` at
  install): `device_scope()` regions arm torch's sync debug mode
  (`torch.cuda.set_sync_debug_mode`), so an undeclared synchronizing
  CUDA call raises in raise mode and warns in count mode (kind
  `host_transfer`; declared fetches go through `io(name)` scopes). The
  module's docstring states what the guard cannot see.
- **Task-supervisor detections** (round 11, reported through
  `record()` by `tasks.py` — the runtime twin of sdlint's
  task-lifecycle/cancellation-safety passes): a supervised task dying
  with an unretrieved exception is a `task_exception`, and a task
  surviving `Node.shutdown`'s reap grace is a `task_orphaned`
  (raised at the reap in tier-1).
- **Channel overflow detection** (round 12, armed via `channels.arm()`
  at install — the runtime twin of sdlint's queue-discipline and
  backpressure passes): a send_nowait burst past a declared frame
  window, or a nowait put on a full block-policy channel, is a
  `chan_overflow` violation — raised in tier-1, counted in
  production while the shed/coalesce policies keep depth bounded.
- **Fs auditor** (round 19, armed via `persist.arm()` at install
  unless `SDTPU_FS_AUDIT=off` — the runtime twin of sdlint's
  io-durability / crash-atomicity passes): os.replace/os.fsync are
  interposed; a raw product-module rename outside the declared
  persist seam is `persist_undeclared_write`, and a rename whose
  source was never fsynced against the artifact's declared policy is
  `persist_unfsynced_rename` — raised in tier-1, counted into
  `sd_persist_violations_total{kind}` in production.
- **Wire frame auditor** (round 20, armed via `p2p/wire.arm()` at
  install unless `SDTPU_WIRE_AUDIT=off` — the runtime twin of
  sdlint's wire-discipline / schema-drift / proto-compat passes):
  every frame crossing a tunnel in either direction is classified
  against the declared wire contracts (p2p/wire.py) — an undeclared
  kind, a schema mismatch, a size-cap breach, or a version skew is a
  `wire_violation` — raised in tier-1, counted into
  `sd_wire_violations_total{kind}` in production while conforming
  traffic feeds the `sd_wire_frames_total{name,dir}` census.
The SQL statement auditor (store/sqlaudit.py) and the cross-thread
race recorder (threadctx.py) of the JAX package are the observability
plane's second half (ROADMAP queue A item 6) and are not ported yet.

Activation: `SDTPU_SANITIZE=1` + `install()` (node bootstrap calls
`install(mode="count")`; `chip_smoke.py` installs raise mode). `SDTPU_SANITIZE_MODE=raise`
(tests) raises SanitizerViolation at the detection point where that is
safe (lock-order cycles); detections inside loop internals (stalls,
held-across-await) are always record-only and surface through
`violations()` — conftest asserts that list is empty when the tests end.
`count` mode (production) never raises: every detection increments
`sd_sanitize_violations_total{kind=...}` so /metrics and
`node.telemetry` expose them.

Disabled cost: `tracked_lock()` returns a plain `threading.Lock` and
`install()` is a no-op — zero overhead on every path.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Set

from . import flags
from .telemetry import SANITIZE_LOOP_MAX_STALL, SANITIZE_VIOLATIONS

__all__ = [
    "SanitizerViolation", "install", "installed", "uninstall",
    "tracked_lock", "tracked_rlock", "violations", "reset_violations",
    "held_tracked_locks", "held_tracked_lock_ids", "record",
]


class SanitizerViolation(RuntimeError):
    """Raised at the detection point in `raise` mode (safe sites only)."""


_installed = False
_mode = "count"
# Bounded: a long-lived count-mode node must not grow memory with its
# violation history — the full count lives in the telemetry counter;
# this list keeps the most recent details for violations()/tests.
_VIOLATIONS_CAP = 512
_violations: List[Dict[str, Any]] = []
_violations_lock = threading.Lock()
_orig_handle_run = None
_max_stall = 0.0

# Lock-order graph: graph id → graph ids acquired while it was held.
# Nodes are PER-INSTANCE (`name#seq`), not per-name: every Database
# names its locks db._write_lock/db._conns_lock, and a name-keyed graph
# would both miss cross-instance AB/BA deadlocks (libA.write vs
# libB.write taken in opposite orders reads as a reentrant skip) and
# merge unrelated instances' edges into false cycles.
# The lock graph IS the detector's memory: evicting edges would
# forget recorded orders and miss cycles. Bounded in practice by
# distinct tracked-lock instances (2 per Database); a pathological
# library-churn workload trades bytes for detection fidelity.
# sdlint: ok[unbounded-growth]
_edges: Dict[str, Set[str]] = {}
_edges_lock = threading.Lock()
_lock_seq = [0]

_tls = threading.local()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = []
        _tls.held = stack
    return stack


def held_tracked_locks() -> List[str]:
    """Names of tracked locks the CALLING thread currently holds
    (outermost first) — the sanitizer's own introspection hook, also
    handy in tests."""
    return [lk.name for lk in _held_stack()]


def held_tracked_lock_ids() -> List[str]:
    """Per-INSTANCE graph ids (`name#seq`) of the calling thread's held
    tracked locks — the lockset the threadctx race recorder intersects
    across writer threads (names alone would merge distinct Database
    instances' locks into phantom protection)."""
    return [lk.graph_id for lk in _held_stack()]


def installed() -> bool:
    return _installed


def mode() -> str:
    """The installed mode: ``raise`` or ``count``."""
    return _mode


def violations() -> List[Dict[str, Any]]:
    with _violations_lock:
        return list(_violations)


def reset_violations() -> None:
    with _violations_lock:
        _violations.clear()


# Incident-observatory hook (incidents.py set_violation_observer):
# notified per violation recorded WITHOUT raising — count mode is
# production, where a violation is otherwise one counter tick nobody
# saw; raise mode already hands the evidence to the raiser.
_violation_observer: Optional[Callable[[str, str], None]] = None


def set_violation_observer(
        cb: Optional[Callable[[str, str], None]]) -> None:
    global _violation_observer
    _violation_observer = cb


def _record(kind: str, detail: str, may_raise: bool) -> None:
    SANITIZE_VIOLATIONS.labels(kind=kind).inc()
    entry = {
        "kind": kind,
        "detail": detail,
        "thread": threading.current_thread().name,
        "stack": "".join(traceback.format_stack(limit=12)[:-2]),
    }
    with _violations_lock:
        _violations.append(entry)
        if len(_violations) > _VIOLATIONS_CAP:
            del _violations[0]
    if may_raise and _mode == "raise":
        raise SanitizerViolation(f"{kind}: {detail}")
    observer = _violation_observer
    if observer is not None:
        try:
            observer(kind, detail)
        except Exception:
            pass  # the black box must never break the detector


def record(kind: str, detail: str, may_raise: bool = False) -> None:
    """Public violation hook for the sanitizer's sibling runtimes
    (tasks.py's supervisor: `task_exception` / `task_orphaned`).
    Counts into sd_sanitize_violations_total and violations() whether
    or not install() ran — metrics must flow in production — and
    honors the raise/count split when asked (`may_raise`), exactly
    like the in-module detectors."""
    _record(kind, detail, may_raise=may_raise)


# -- lock-order recorder ----------------------------------------------------

def _would_cycle(new: str, held: List[str]) -> Optional[str]:
    """If acquiring `new` while `held` closes a cycle in the lock
    graph, return the offending held lock's name. DFS over recorded
    edges: a path new →* h means some thread acquires h after new —
    combined with this thread's h-then-new order, the AB/BA deadlock."""
    with _edges_lock:
        for h in held:
            if h == new:
                continue
            seen = {new}
            frontier = [new]
            while frontier:
                cur = frontier.pop()
                for nxt in _edges.get(cur, ()):
                    if nxt == h:
                        return h
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
    return None


def _note_acquire(lock: "_TrackedLock") -> None:
    held = [lk.graph_id for lk in _held_stack()
            if lk.graph_id != lock.graph_id]
    if not held:
        return
    offender = _would_cycle(lock.graph_id, held)
    if offender is not None:
        _record(
            "lock_order_cycle",
            f"acquiring {lock.graph_id!r} while holding {offender!r}, "
            f"but the recorded order elsewhere is {lock.graph_id!r} "
            f"before {offender!r}",
            may_raise=True)
    with _edges_lock:
        for h in held:
            _edges.setdefault(h, set()).add(lock.graph_id)


class _TrackedLock:
    """Order-recording wrapper with the threading.Lock surface the
    store uses (context manager + acquire/release + locked)."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        with _edges_lock:
            _lock_seq[0] += 1
            self.graph_id = f"{name}#{_lock_seq[0]}"
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Order check BEFORE blocking: in raise mode the would-be
        # deadlock surfaces as an exception, not a hung suite.
        _note_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held_stack().append(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<tracked {type(self._inner).__name__} {self.name!r}>"


class _TrackedRLock(_TrackedLock):
    _factory = staticmethod(threading.RLock)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _held_stack()
        reentrant = any(lk is self for lk in stack)
        if not reentrant:
            _note_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            stack.append(self)
        return ok


def tracked_lock(name: str):
    """A lock-order-recorded Lock when the sanitizer is installed, a
    plain threading.Lock otherwise (zero overhead)."""
    return _TrackedLock(name) if _installed else threading.Lock()


def tracked_rlock(name: str):
    return _TrackedRLock(name) if _installed else threading.RLock()


# -- event-loop instrumentation --------------------------------------------

# Stall threshold, set at install() from SDTPU_SANITIZE_STALL_S;
# module-level so tests can tighten/loosen it after install.
_stall_s = 1.0


def _wrap_handle_run(orig):
    def _run(self):  # noqa: ANN001 — asyncio.events.Handle method
        global _max_stall
        t0 = time.perf_counter()
        try:
            return orig(self)
        finally:
            dt = time.perf_counter() - t0
            if dt > _max_stall:
                _max_stall = dt
                SANITIZE_LOOP_MAX_STALL.set(dt)
            if dt > _stall_s:
                # Never raise here: an exception out of Handle._run
                # lands in loop internals, not the offending code.
                _record(
                    "loop_stall",
                    f"event-loop callback ran {dt:.3f}s "
                    f"(threshold {_stall_s}s): {self!r}",
                    may_raise=False)
            held = held_tracked_locks()
            reported = getattr(_tls, "across_await_reported", None)
            if held:
                # The callback returned control to the loop with a
                # tracked lock held by the loop thread — a coroutine
                # suspended inside a critical section. Report each
                # lock ONCE per continuously-held episode: while the
                # offender stays suspended, every later (innocent)
                # callback would otherwise re-record it with a fresh
                # multi-KB stack.
                new = [n for n in held if not reported or n not in reported]
                if new:
                    _record(
                        "lock_across_await",
                        f"event-loop callback left lock(s) {new} held "
                        f"across a suspension point (first observed "
                        f"after: {self!r})",
                        may_raise=False)
                _tls.across_await_reported = set(held)
            elif reported:
                _tls.across_await_reported = None
    return _run


def install(mode: Optional[str] = None) -> bool:
    """Arm the sanitizer if SDTPU_SANITIZE is set. Idempotent (the first
    install's mode holds); returns whether the sanitizer is installed
    after the call. `mode` overrides SDTPU_SANITIZE_MODE: a node installs
    in ``count`` mode, so a production process never raises. Locks
    created BEFORE install are plain locks — install early (node
    bootstrap) so the store's locks come from tracked_lock."""
    global _installed, _mode, _orig_handle_run, _stall_s
    if _installed:
        return True
    if not flags.get("SDTPU_SANITIZE"):
        return False
    _mode = mode or flags.get("SDTPU_SANITIZE_MODE")
    _stall_s = flags.get("SDTPU_SANITIZE_STALL_S")
    import asyncio.events

    if getattr(asyncio.events.Handle._run, "__module__", "") == "asyncio.events":
        # Time every loop callback, unless another stall detector (the JAX
        # package's, sharing the process) already wraps the loop.
        _orig_handle_run = asyncio.events.Handle._run
        asyncio.events.Handle._run = _wrap_handle_run(_orig_handle_run)
    # Arm the device-layer twin: the sync guard inside device_scope()
    # regions and the declared io() fetches (ops/kernel_registry.py).
    # Same raise/count split; violations flow through _record into the
    # shared list + sd_sanitize_violations_total.
    from .ops import kernel_registry

    kernel_registry.arm(_mode, _record)
    # Arm the resource-layer twin: channel depth-watermark breaches
    # (channels.py) flow through _record as `chan_overflow`.
    from . import channels

    channels.arm(_mode, _record)
    # The thread-ownership (threadctx.py) and SQL-statement
    # (store/sqlaudit.py) twins are the observability plane's second
    # half (ROADMAP queue A item 6); they are not armed here yet.
    # Arm the durability twin: the fs auditor interposes
    # os.replace/os.fsync and judges every rename against the persist
    # registry's declared fsync policies — breaches flow through
    # _record as `persist_undeclared_write` / `persist_unfsynced_`
    # `rename`. SDTPU_FS_AUDIT=off skips the wrap (persist checks it
    # — read once, at install).
    from . import persist

    persist.arm(_mode, _record)
    # Arm the protocol twin: the tunnel seam classifies + validates
    # every frame against the declared wire contracts — breaches flow
    # through _record as `wire_violation`. SDTPU_WIRE_AUDIT=off skips
    # the arming (wire checks it — read once, at install); pack/unpack
    # validate regardless.
    from .p2p import wire

    wire.arm(_mode, _record)
    _installed = True
    return True


def uninstall() -> None:
    """Disarm (tests). Already-created tracked locks keep recording
    into the (now-idle) graph; new ones are plain again."""
    global _installed, _orig_handle_run
    if not _installed:
        return
    import asyncio.events

    if _orig_handle_run is not None:
        asyncio.events.Handle._run = _orig_handle_run
        _orig_handle_run = None
    from .ops import kernel_registry

    kernel_registry.disarm()
    from . import channels

    channels.disarm()
    from . import persist

    persist.disarm()
    from .p2p import wire

    wire.disarm()
    _installed = False
