"""Declared budgets for the network awaits of the API, sync and p2p.

The port's own copy of the parts of ``spacedrive_tpu/timeouts.py`` that
its API host, sync and p2p modules read: ``with_timeout(name, awaitable)``,
``deadline(name)`` (one budget over a block of awaits), the budgets the
p2p and sync contracts name at the JAX defaults (README's timeout table),
and the retry ladders (``Backoff``, ``with_backoff``, ``RetrySchedule``)
with the sync announcer's ``p2p.announce.reconnect`` policy. The
effective budget is the default times ``SDTPU_TIMEOUT_SCALE``. The JAX
registry's counters and the budgets of planes the port has not ported
(fleet, obs over http, the pipeline channels) are left to it.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple, Type

from . import flags


@dataclass(frozen=True)
class TimeoutContract:
    name: str        # dotted id: "<layer>.<operation>"
    default_s: float
    doc: str


TIMEOUTS: Dict[str, TimeoutContract] = {
    c.name: c for c in (
        TimeoutContract("api.http.read", 30.0,
                        "Reading a request's head or body: bounds a slow-loris client."),
        TimeoutContract("api.http.write", 60.0,
                        "One streamed response chunk: a stalled client releases the "
                        "handler instead of pinning it."),
        TimeoutContract("api.ws.prepare", 30.0,
                        "The WebSocket upgrade handshake on the rspc route."),
        TimeoutContract("api.ws.send", 30.0,
                        "One WebSocket frame to a subscriber: a dead client cannot "
                        "wedge the emit path."),
        TimeoutContract("p2p.connect", 20.0,
                        "Outbound TCP dial + authenticated tunnel handshake."),
        TimeoutContract("p2p.file.response", 60.0,
                        "The remote library's file-request decision frame."),
        TimeoutContract("p2p.frame_send", 60.0,
                        "One control/ops frame into a tunnel, its drain included."),
        TimeoutContract("p2p.handshake", 20.0,
                        "The signed-ephemeral key exchange on a fresh tunnel."),
        TimeoutContract("p2p.header_recv", 30.0,
                        "Inbound dispatch header after an accepted handshake."),
        TimeoutContract("p2p.obs", 30.0,
                        "One obs request/response exchange (the wire declares it; "
                        "the port closes obs headers unanswered)."),
        TimeoutContract("p2p.pair", 60.0, "The whole pairing round-trip."),
        TimeoutContract("p2p.ping", 20.0, "Ping round-trip over a fresh tunnel."),
        TimeoutContract("p2p.spacedrop.decide", 60.0,
                        "Interactive accept/reject window for an inbound spacedrop."),
        TimeoutContract("p2p.spacedrop.verdict", 75.0,
                        "Sender's wait for the verdict; brackets the receiver's "
                        "decide window, so it must stay longer than it."),
        TimeoutContract("p2p.transfer.chunk", 60.0,
                        "One spaceblock block (send or receive) plus its ack."),
        TimeoutContract("sync.clone.ack", 180.0,
                        "Originator's wait for one blob-page watermark ack."),
        TimeoutContract("sync.clone.ack_send", 60.0,
                        "Receiver pushing a page ack back up the tunnel."),
        TimeoutContract("sync.clone.drain", 120.0,
                        "Flushing a pipelined clone window into the socket."),
        TimeoutContract("sync.clone.frame", 180.0,
                        "Receiver's wait for the next clone-stream frame."),
        TimeoutContract("sync.clone.serve", 120.0,
                        "One clone-serve page-fetch slot on the fair-share gate."),
        TimeoutContract("sync.ingest.backlog", 180.0,
                        "Ingester waiting for room in its bounded request queue."),
        TimeoutContract("sync.pull.page", 180.0,
                        "Responder's wait for one ops page."),
        TimeoutContract("sync.pull.request", 180.0,
                        "Originator's wait for the responder's next pull request."),
    )
}


def budget(name: str) -> float:
    """Effective seconds of a declared budget."""
    c = TIMEOUTS.get(name)
    if c is None:
        raise KeyError(f"undeclared timeout {name!r} "
                       "(declare it in spacedrive_tpu_torch/timeouts.py)")
    return c.default_s * flags.get("SDTPU_TIMEOUT_SCALE")


async def with_timeout(name: str, awaitable: Awaitable) -> Any:
    """``asyncio.wait_for`` under a declared budget."""
    return await asyncio.wait_for(awaitable, budget(name))


@contextlib.asynccontextmanager
async def deadline(name: str):
    """``async with deadline("p2p.handshake"):`` — every await in the
    block shares the named budget; past it, ``TimeoutError``."""
    async with asyncio.timeout(budget(name)):
        yield


@dataclass(frozen=True)
class BackoffContract:
    name: str
    base_s: float      # first retry delay
    cap_s: float       # ladder ceiling
    factor: float      # multiplier per retry
    jitter: float      # ± fraction of the delay
    max_tries: int     # retries before give-up; 0 = retry forever
    doc: str


BACKOFFS: Dict[str, BackoffContract] = {
    "p2p.announce.reconnect": BackoffContract(
        "p2p.announce.reconnect", 0.5, 60.0, 2.0, 0.25, 6,
        "Sync announce fan-out to a peer that failed its last round: "
        "retried up this ladder instead of on every local write; "
        "exhausted, retries park at the cap until it heals."),
}


class Backoff:
    """One failing operation's ladder: ``next_delay()`` per failure gives
    the jittered delay before the next try, or None once exhausted;
    ``reset()`` on success."""

    def __init__(self, name: str, rng: Optional[random.Random] = None):
        c = BACKOFFS.get(name)
        if c is None:
            raise KeyError(f"undeclared backoff {name!r}")
        self.contract = c
        self.tries = 0
        self._rng = rng

    def next_delay(self) -> Optional[float]:
        c = self.contract
        if c.max_tries and self.tries >= c.max_tries:
            return None
        d = min(c.cap_s, c.base_s * (c.factor ** min(self.tries, 64)))
        self.tries += 1
        if c.jitter:
            r = self._rng.random() if self._rng is not None else random.random()
            d *= 1.0 + c.jitter * (2.0 * r - 1.0)
        return d * flags.get("SDTPU_TIMEOUT_SCALE")

    def reset(self) -> None:
        self.tries = 0


async def with_backoff(name: str, fn: Callable[[], Awaitable],
                       retry_on: Tuple[Type[BaseException], ...]
                       = (ConnectionError, OSError, asyncio.TimeoutError),
                       rng: Optional[random.Random] = None) -> Any:
    """Call ``fn()`` under the declared policy: a retryable failure sleeps
    the next delay and tries again; an exhausted ladder re-raises."""
    b = Backoff(name, rng=rng)
    while True:
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except retry_on:
            d = b.next_delay()
            if d is None:
                raise
            await asyncio.sleep(d)


class RetrySchedule:
    """Per-key ladders for poll-shaped loops: ``allowed(key)`` says if a
    key may try now, ``failure(key)`` climbs its ladder (None once it gave
    up: it then stays parked at the cap), ``success(key)`` forgets it."""

    def __init__(self, name: str, rng: Optional[random.Random] = None):
        if name not in BACKOFFS:
            raise KeyError(f"undeclared backoff {name!r}")
        self.name = name
        self.contract = BACKOFFS[name]
        self._rng = rng
        self._ladders: Dict[Any, Backoff] = {}
        self._retry_at: Dict[Any, float] = {}

    def allowed(self, key: Any, now: Optional[float] = None) -> bool:
        t = time.monotonic() if now is None else now
        return t >= self._retry_at.get(key, 0.0)

    def failure(self, key: Any, now: Optional[float] = None) -> Optional[float]:
        t = time.monotonic() if now is None else now
        b = self._ladders.get(key)
        if b is None:
            b = self._ladders[key] = Backoff(self.name, rng=self._rng)
        d = b.next_delay()
        if d is None:
            self._retry_at[key] = t + self.contract.cap_s * flags.get("SDTPU_TIMEOUT_SCALE")
            return None
        self._retry_at[key] = t + d
        return d

    def success(self, key: Any) -> None:
        self._ladders.pop(key, None)
        self._retry_at.pop(key, None)

    evict = success
