"""Single-writer group-commit actor: the store's write path.

Port of ``spacedrive_tpu/store/actor.py``. One ``WriteActor`` per
``Database`` (one per library). ``Database.write_tx()`` queues a ticket
and blocks for its turn; the actor's writer thread drains the tickets and
coalesces them into one transaction::

    BEGIN IMMEDIATE                       -- the actor, via db.tx()
      SAVEPOINT sdtpu_wtx                 -- ticket 1's bracket
        ... the caller's batch body ...   -- runs on the caller's thread
      RELEASE sdtpu_wtx
      SAVEPOINT sdtpu_wtx                 -- ticket 2, 3, ... likewise
    COMMIT                                -- one commit for the group

The connection goes to one caller at a time (grant and done events), so
SQLite never sees two threads at once. A body that raises rolls back its
own savepoint and re-raises to its caller; the rest of the group commits.
A failed COMMIT fails every ticket of the group. A group holds at most
``SDTPU_STORE_GROUP_MAX`` tickets; once the backlog is drained, a group
that already coalesced two or more waits at most
``SDTPU_STORE_GROUP_LATENCY_S`` for stragglers, and a group of one commits
at once. Tickets still queued when the actor stops fail exactly once with
``WriteActorClosed``.

Closure batches (``submit``) ride the same queue: the closure runs on the
actor's thread inside its own savepoint, and the returned future resolves
after the group commits (on the caller's event loop when one is given).

The queue is a deque under a ``threading.Condition``, bounded at
``QUEUE_CAPACITY`` (a producer blocks while it is full, the JAX package's
``store.actor.queue`` channel). Left to the JAX package: the chaos fault
point ``store.group_commit``, the telemetry counters, the thread-ownership
contracts and the timeouts registry; its two budgets are constants here
with the JAX values.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Deque, List, Optional

from .. import chaos, flags
from ..telemetry import (STORE_GROUP_COMMITS, STORE_GROUP_SHUTDOWN_DRAINS, STORE_GROUP_SIZE,
                         STORE_GROUP_WAIT_SECONDS)

__all__ = ["WriteActor", "WriteActorClosed", "WriteTxStalled"]

QUEUE_CAPACITY = 256
# The JAX package's store.actor.put and store.actor.write budgets (s).
PUT_BUDGET_S = 30.0
WRITE_BUDGET_S = 600.0


class WriteActorClosed(RuntimeError):
    """The library's write actor has stopped; the queued batch was not
    written."""


class WriteTxStalled(RuntimeError):
    """A budget expired: the writer thread, or a batch body holding the
    connection, is wedged."""


class _Ticket:
    """One queued write batch. Each field has one writer per phase of the
    handshake (enqueue → grant → body → commit), ordered by the events.

    A slot ticket (``fn`` is None) hands the group connection to the
    enqueueing thread, which runs its ``write_tx`` body between
    ``grant_evt`` and ``done_evt``. A closure ticket carries ``fn``, runs
    on the actor's thread and resolves ``future`` after the commit."""

    __slots__ = ("fn", "loop", "future", "enq_t", "grant_evt", "done_evt", "commit_evt",
                 "conn", "grant_exc", "commit_exc", "body_ok", "body_fatal",
                 "result", "resolved")

    def __init__(self, fn: Optional[Callable] = None, loop: Any = None,
                 future: Optional[Future] = None):
        self.fn = fn
        self.loop = loop
        self.future = future
        self.enq_t = time.perf_counter()
        self.grant_evt = threading.Event()
        self.done_evt = threading.Event()
        self.commit_evt = threading.Event()
        self.conn: Optional[sqlite3.Connection] = None
        self.grant_exc: Optional[BaseException] = None
        self.commit_exc: Optional[BaseException] = None
        self.body_ok = False
        # The body's savepoint bracket itself broke: the transaction's
        # state is unknown, so the whole group fails.
        self.body_fatal = False
        self.result: Any = None
        self.resolved = False


class WriteActor:
    """The per-library writer (see the module doc). Its thread starts on
    the first enqueue: a library that never writes carries no thread.
    ``groups`` and ``batches`` count committed groups and the tickets
    they carried."""

    def __init__(self, db: Any):
        self._db = db
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: Deque[_Ticket] = deque()
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self.groups = 0
        self.batches = 0

    # -- producer side -------------------------------------------------------

    def enqueue(self, t: _Ticket) -> None:
        """Queue one ticket, blocking for room up to ``PUT_BUDGET_S``.
        Raises WriteActorClosed after stop(), WriteTxStalled when the
        budget expires."""
        deadline = time.monotonic() + PUT_BUDGET_S
        with self._lock:
            if self._stopping or self._db._closed:
                raise WriteActorClosed(f"write actor for {self._db.path!r} is stopped")
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name=f"sd-store-writer:{self._db.path}")
                self._thread.start()
            while len(self._q) >= QUEUE_CAPACITY:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise WriteTxStalled(
                        f"the write queue stayed full for {PUT_BUDGET_S:.0f} s: "
                        "the writer thread is not draining")
                self._cv.wait(remaining)
                if self._stopping:
                    raise WriteActorClosed(f"write actor for {self._db.path!r} stopped "
                                           "while waiting for queue space")
            self._q.append(t)
            self._cv.notify_all()

    def submit(self, fn: Callable[[sqlite3.Connection], Any], loop: Any = None) -> Future:
        """Queue a closure batch: ``fn(conn)`` runs on the actor's thread in
        its own savepoint; the future resolves with its result after the
        group commits, or with the body's or the group's exception. With
        `loop` the future is settled on that event loop."""
        t = _Ticket(fn=fn, loop=loop, future=Future())
        self.enqueue(t)
        return t.future

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        """Stop the writer thread and fail whatever is still queued. Called
        by Database.close() before it takes the write lock, which the
        actor may hold for a group."""
        with self._lock:
            self._stopping = True
            self._cv.notify_all()
            th = self._thread
        if th is not None and th is not threading.current_thread():
            th.join(timeout=WRITE_BUDGET_S)
        self._drain()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    return
                t = self._q.popleft()
                self._cv.notify_all()
            STORE_GROUP_SHUTDOWN_DRAINS.inc()
            self._resolve(t, WriteActorClosed(
                f"write actor for {self._db.path!r} shut down with this batch "
                "still queued: it was not written"))

    # -- the actor's thread --------------------------------------------------

    def _next(self, timeout: Optional[float]) -> Optional[_Ticket]:
        """One ticket; None on stop or when `timeout` (0 polls the backlog)
        expires. timeout=None waits for work."""
        with self._lock:
            while True:
                if self._stopping:
                    return None
                if self._q:
                    t = self._q.popleft()
                    self._cv.notify_all()
                    return t
                if timeout is None:
                    self._cv.wait()
                    continue
                if timeout <= 0:
                    return None
                t0 = time.monotonic()
                self._cv.wait(timeout)
                timeout -= time.monotonic() - t0

    def _run(self) -> None:
        while True:
            t = self._next(None)
            if t is None:
                self._drain()
                return
            self._run_group(t)

    def _run_group(self, first: _Ticket) -> None:
        group_max = max(1, int(flags.get("SDTPU_STORE_GROUP_MAX")))
        latency_s = float(flags.get("SDTPU_STORE_GROUP_LATENCY_S"))
        group: List[_Ticket] = []
        commit_exc: Optional[BaseException] = None
        try:
            with self._db.tx() as conn:
                self._serve(first, conn, group)
                budget_left = latency_s
                while len(group) < group_max:
                    nxt = self._next(0.0)  # the backlog first
                    if nxt is None:
                        # A group of one commits now: a lone sequential
                        # writer must not pay the wait on every write.
                        if len(group) < 2 or budget_left <= 0:
                            break
                        t0 = time.monotonic()
                        nxt = self._next(budget_left)
                        budget_left -= time.monotonic() - t0
                        if nxt is None:
                            break
                    self._serve(nxt, conn, group)
                f = chaos.hit("store.group_commit", only=("delay", "error"))
                if f is not None:
                    # delay: the kill -9 durability window (the group is
                    # written but not committed). error: the group fails
                    # to every waiter (ChaosError).
                    chaos.apply_sync(f)
        except BaseException as e:  # noqa: BLE001 (handed to every ticket below)
            commit_exc = e
        if commit_exc is None and group:
            STORE_GROUP_COMMITS.inc()
            STORE_GROUP_SIZE.observe(len(group))
            self.groups += 1
            self.batches += len(group)
        now = time.perf_counter()
        for t in group:
            STORE_GROUP_WAIT_SECONDS.observe(now - t.enq_t)
            self._resolve(t, commit_exc)

    def _serve(self, t: _Ticket, conn: sqlite3.Connection, group: List[_Ticket]) -> None:
        """Run one ticket's body in the open group transaction; append it
        to `group` when its writes are pending there."""
        if t.fn is None:
            t.conn = conn
            t.grant_evt.set()
            if not t.done_evt.wait(WRITE_BUDGET_S):
                raise WriteTxStalled(
                    "a write_tx body held the group connection past "
                    f"{WRITE_BUDGET_S:.0f} s: failing the group")
            if t.body_fatal:
                raise sqlite3.OperationalError(
                    "a write_tx body failed and so did its savepoint rollback: "
                    "the transaction's state is unknown, failing the group")
            if t.body_ok:
                group.append(t)
            # A body that raised has its exception and its savepoint is
            # rolled back: the group goes on.
            return
        conn.execute("SAVEPOINT sdtpu_wtx")
        try:
            t.result = t.fn(conn)
        except Exception as body_exc:
            conn.execute("ROLLBACK TO sdtpu_wtx")
            conn.execute("RELEASE sdtpu_wtx")
            self._resolve(t, body_exc)
            return
        conn.execute("RELEASE sdtpu_wtx")
        group.append(t)

    # -- completion ----------------------------------------------------------

    def _resolve(self, t: _Ticket, exc: Optional[BaseException]) -> None:
        """Deliver a ticket's outcome exactly once."""
        if t.resolved:
            return
        t.resolved = True
        if t.fn is None:
            if t.conn is None:  # never granted (a shutdown drain)
                t.grant_exc = exc if exc is not None else WriteActorClosed(
                    "write actor stopped")
                t.grant_evt.set()
            else:
                t.commit_exc = exc
                t.commit_evt.set()
            return
        fut = t.future

        def settle() -> None:
            try:
                if exc is None:
                    fut.set_result(t.result)
                else:
                    fut.set_exception(exc)
            except InvalidStateError:
                pass  # the caller cancelled the future

        if t.loop is not None:
            try:
                t.loop.call_soon_threadsafe(settle)
                return
            except RuntimeError:
                pass  # the loop is closed: settle here
        settle()
