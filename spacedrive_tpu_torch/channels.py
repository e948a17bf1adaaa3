"""The bounded queues of the API, sync and p2p, as plain asyncio primitives.

The port's copy of the entries of ``spacedrive_tpu/channels.py`` that its
API host, sync and p2p modules build, with the JAX capacities: a
WebSocket subscription's event buffer (``api.ws``, 64, snapshot events
coalesced to the newest, a new event past the bound shed), the rspc HTTP
admission window (``api.http.inflight``, 256, a request past it refused), the clone serve gate
(``sync.clone.serve``, 2 FIFO slots), the tunnel's send window
(``p2p.tunnel.frames``, 4 frames sealed but not drained), the ingester's
event inbox (``sync.ingest.events``, 64, notifications coalesced) and
request outbox (``sync.ingest.requests``, 32, a full put waits under the
``sync.ingest.backlog`` budget), and the route cache (``p2p.route_cache``,
512, oldest out). The JAX registry's telemetry, sanitizer hooks and
``SDTPU_CHAN_SCALE`` wait with the observability twins.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict, deque
from typing import Any, Optional

from .timeouts import with_timeout

CAPACITY = {
    "api.ws": 64,
    "api.http.inflight": 256,
    "sync.clone.serve": 2,
    "p2p.tunnel.frames": 4,
    "sync.ingest.events": 64,
    "sync.ingest.requests": 32,
    "p2p.route_cache": 512,
}


def capacity(name: str) -> int:
    return CAPACITY[name]


class CoalescingChannel:
    """``api.ws``: a bounded FIFO whose keyed items replace the pending item
    under the same key (the newest snapshot wins); a new item past the
    bound is shed and counted in ``shed``. Loop thread only."""

    def __init__(self, name: str = "api.ws"):
        self.cap = CAPACITY[name]
        self._items: deque = deque()
        self._keyed: dict = {}
        self._ready = asyncio.Event()
        self.shed = 0

    def __len__(self) -> int:
        return len(self._items)

    def put_nowait(self, item: Any, key: Optional[str] = None) -> bool:
        if key is not None and key in self._keyed:
            self._keyed[key][1] = item
            return True
        if len(self._items) >= self.cap:
            self.shed += 1
            return False
        entry = [key, item]
        self._items.append(entry)
        if key is not None:
            self._keyed[key] = entry
        self._ready.set()
        return True

    def get_nowait(self) -> Any:
        if not self._items:
            raise asyncio.QueueEmpty
        key, item = self._items.popleft()
        if key is not None:
            self._keyed.pop(key, None)
        if not self._items:
            self._ready.clear()
        return item

    async def get(self) -> Any:
        while not self._items:
            await self._ready.wait()
        return self.get_nowait()


class AdmissionWindow:
    """``api.http.inflight``: one slot an in-flight dispatch; a request past
    the capacity (or past `cap`, which narrows it, never widens) is refused
    at once and counted in ``shed``."""

    def __init__(self, cap: Optional[int] = None):
        full = CAPACITY["api.http.inflight"]
        self.cap = full if cap is None else max(1, min(int(cap), full))
        self.inflight = 0
        self.shed = 0

    def try_acquire(self) -> bool:
        if self.inflight >= self.cap:
            self.shed += 1
            return False
        self.inflight += 1
        return True

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)


def serve_semaphore() -> asyncio.Semaphore:
    """The ``sync.clone.serve`` gate: waiters are served in arrival order."""
    return asyncio.Semaphore(CAPACITY["sync.clone.serve"])


class FrameWindow:
    """``p2p.tunnel.frames``: frames queued without a drain. A burst past
    the window is a bug in the sender (its memory would grow with the
    stream), so it raises."""

    def __init__(self):
        self.cap = CAPACITY["p2p.tunnel.frames"]
        self.depth = 0

    def note_put(self) -> None:
        self.depth += 1
        if self.depth > self.cap:
            raise OverflowError(f"p2p.tunnel.frames: {self.depth} frames queued "
                                f"past the window of {self.cap} without a drain")

    def note_drain(self) -> None:
        self.depth = 0


class EventInbox:
    """``sync.ingest.events``: (kind, payload) events; a "notification"
    while one is already pending collapses into it."""

    def __init__(self):
        self._q: asyncio.Queue = asyncio.Queue(CAPACITY["sync.ingest.events"])
        self._pending: set = set()

    def put_nowait(self, item: Any, key: Optional[str] = None) -> None:
        if key is not None:
            if key in self._pending:
                return
            self._pending.add(key)
        self._q.put_nowait((key, item))

    async def get(self) -> Any:
        key, item = await self._q.get()
        if key is not None:
            self._pending.discard(key)
        return item


class RequestOutbox:
    """``sync.ingest.requests``: a put into a full outbox waits under the
    ``sync.ingest.backlog`` budget."""

    def __init__(self):
        self._q: asyncio.Queue = asyncio.Queue(CAPACITY["sync.ingest.requests"])

    async def put(self, item: Any) -> None:
        if self._q.full():
            await with_timeout("sync.ingest.backlog", self._q.put(item))
        else:
            self._q.put_nowait(item)

    async def get(self) -> Any:
        return await self._q.get()

    def get_nowait(self) -> Any:
        return self._q.get_nowait()

    def empty(self) -> bool:
        return self._q.empty()


class RouteCache(OrderedDict):
    """``p2p.route_cache``: identity → (addr, port), least recently used
    out past the capacity."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > CAPACITY["p2p.route_cache"]:
            self.popitem(last=False)
