"""Ingest actor: the receiving half of the sync plane.

Port of ``spacedrive_tpu/sync/ingest.py`` (upstream
core/crates/sync/src/ingest.rs:30-108), the state machine

    WaitingForNotification → RetrievingMessages → Ingesting → (loop)

On a notification the ``Ingester`` puts ``Request(MESSAGES, clocks)`` in
its outbox (the p2p responder turns it into a pull request), waits for a
``MessagesEvent``, ingests the page through the manager's LWW path in one
worker-thread call, reports ``INGESTED`` counts, and asks again while
``has_more``; then ``FINISHED``. ``pump_clone_stream`` is the receiving
half of the clone fast path. Both speak through plain async callables and
queues, so tests drive them without a network.
"""

from __future__ import annotations

import asyncio
import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import channels, chaos, tasks
from ..p2p import wire
from ..timeouts import with_timeout
from .crdt import CRDTOperation
from .manager import SyncManager


class ReqKind(enum.Enum):
    MESSAGES = "messages"
    INGESTED = "ingested"
    FINISHED = "finished_ingesting"


@dataclass
class Request:
    kind: ReqKind
    timestamps: List[Tuple[bytes, int]] = field(default_factory=list)
    count: int = 1  # INGESTED: ops applied by the batch behind this


@dataclass
class MessagesEvent:
    instance: bytes
    messages: List[CRDTOperation]
    has_more: bool


def _extend_capped(errors: List[str], errs: List[str]) -> None:
    """Append ingest errors, the oldest out past ``Ingester.ERRORS_CAP``."""
    errors.extend(errs)
    if len(errors) > Ingester.ERRORS_CAP:
        del errors[: len(errors) - Ingester.ERRORS_CAP]


async def pump_clone_stream(sync: SyncManager, recv, send,
                            errors: List[str]) -> Tuple[int, int, int]:
    """Drain ``blob_page`` / ``clone_ops`` frames until ``blob_done``,
    acking each applied page with the durable watermark so the
    originator's window can release the next one. Pages go through
    ``receive_blob_pages``; interleaved ``clone_ops`` chunks through the
    per-op ingest. An instance whose watermark froze (an op failed)
    stops applying for the rest of the stream (its frames are acked with
    the frozen watermark) and the next pull re-serves it per op. Returns
    (ops applied, fast pages, fallback pages)."""
    applied = fast_pages = fallback_pages = 0
    dirty: set = set()
    expect: dict = {}  # the highest stamp delivered per instance

    def _frozen(pub: bytes) -> bool:
        return sync.timestamps.get(pub, 0) < expect.get(pub, 0)

    async def _send_ack(pub: bytes, fast: bool) -> None:
        # Chaos seam: a dropped or torn ack leaves the originator's window
        # full until its sync.clone.ack budget fires; the per-op pull loop
        # then finishes the tail from the durable watermark.
        f = chaos.hit("sync.clone.ack", only=("delay", "drop", "disconnect"))
        if f is not None and await chaos.apply_async(f):
            return  # dropped on the wire
        await with_timeout("sync.clone.ack_send", send(wire.pack(
            "clone.ack", ts=sync.timestamps.get(pub, 0), fast=bool(fast))))

    while True:
        frame = await with_timeout("sync.clone.frame", recv())
        kind = frame.get("kind") if isinstance(frame, dict) else None
        if kind == "blob_done":
            return applied, fast_pages, fallback_pages
        if kind == "clone_ops":
            frame = wire.unpack("clone.ops", frame)
            ops = [CRDTOperation.from_wire(raw) for raw in frame.get("ops", [])]
            live = [op for op in ops if op.instance not in dirty]
            if live:
                n, errs = await asyncio.to_thread(sync.receive_crdt_operations, live)
                applied += n
                _extend_capped(errors, errs)
                for op in live:
                    expect[op.instance] = max(expect.get(op.instance, 0), op.timestamp)
                for pub in {op.instance for op in live}:
                    if _frozen(pub):
                        dirty.add(pub)
        elif kind == "blob_page":
            frame = wire.unpack("clone.page", frame)
            pub = bytes(frame["instance"])
            if pub in dirty or _frozen(pub):
                dirty.add(pub)
                await _send_ack(pub, False)
                fallback_pages += 1
                continue
            n, errs, fast = await asyncio.to_thread(sync.receive_blob_pages, [frame])
            applied += n
            _extend_capped(errors, errs)
            fast_pages += 1 if fast else 0
            fallback_pages += 0 if fast else 1
            expect[pub] = max(expect.get(pub, 0), int(frame["max_ts"]))
            if _frozen(pub):
                dirty.add(pub)
            # ack after the commit: the watermark it carries is durable
            await _send_ack(pub, fast)
        else:
            raise wire.WireError(f"unexpected clone-stream frame: {frame!r}")


class Ingester:
    """The notification → retrieve → ingest loop of one library."""

    # the newest ingest errors kept for callers
    ERRORS_CAP = 256

    def __init__(self, sync: SyncManager, owner: str = "sync-ingest"):
        self.sync = sync
        self._owner = owner
        self.events = channels.channel("sync.ingest.events")
        self.requests = channels.channel("sync.ingest.requests")
        self.errors: List[str] = []
        self._task: Optional[asyncio.Task] = None

    def notify(self) -> None:
        """A peer has new ops; a storm of these coalesces into one."""
        self.events.put_nowait(("notification", None), key="notification")

    def deliver(self, event: MessagesEvent) -> None:
        """A page of ops arrived."""
        self.events.put_nowait(("messages", event))

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = tasks.spawn("ingester", self._run(), owner=self._owner)

    async def stop(self) -> None:
        await tasks.cancel_and_gather(self._task)
        self._task = None

    async def _run(self) -> None:
        while True:
            await self._wait("notification")
            has_more = True
            while has_more:
                # Our own instance at the current HLC goes in too, or a
                # peer that ingested our log would ship it straight back.
                clocks = dict(self.sync.timestamps)
                clocks[self.sync.instance] = max(self.sync.clock.last,
                                                 clocks.get(self.sync.instance, 0))
                await self.requests.put(Request(ReqKind.MESSAGES,
                                                timestamps=list(clocks.items())))
                event = await self._wait("messages")
                try:
                    applied, errors = await asyncio.to_thread(
                        self.sync.receive_crdt_operations, event.messages)
                except Exception as e:  # page-level guard
                    # the same clocks would fail again: abort this pull, the
                    # next notification retries from the stored watermarks
                    _extend_capped(self.errors, [f"ingest page: {e}"])
                    break
                _extend_capped(self.errors, errors)
                if applied:
                    await self.requests.put(Request(ReqKind.INGESTED, count=applied))
                has_more = event.has_more
            await self.requests.put(Request(ReqKind.FINISHED))

    async def _wait(self, kind: str):
        """Drop events of another kind while waiting for this one."""
        while True:
            k, payload = await self.events.get()
            if k == kind:
                return payload
