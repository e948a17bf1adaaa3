"""The windowed clone-stream originator: the serving half of the
full-library clone fast path.

Port of ``spacedrive_tpu/sync/clone_serve.py``. ``serve_clone_stream``
sends a fresh peer the library's stored blob pages verbatim (and the
row-format ops that must precede each page's watermark advance) with at
most ``CLONE_WINDOW`` pages unacked; each ack carries the receiver's
durably committed watermark, so a dropped stream resumes where the
receiver's instance row says. Page fetches run off the loop and take a
FIFO slot of the node's ``serve_gate()``, so concurrent clone streams
share the fetch executor in turn. The tunnel is anything with
``send`` / ``send_nowait`` / ``drain`` / ``recv`` / ``close``.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .. import channels, chaos
from ..p2p import wire
from ..timeouts import with_timeout

__all__ = ["CLONE_WINDOW", "serve_clone_stream", "serve_gate", "pages_relayed"]

# Pages in flight before the originator waits for an ack: the tunnel's
# p2p.tunnel.frames window.
CLONE_WINDOW = channels.capacity("p2p.tunnel.frames")

# Pages this process relayed (every call of serve_clone_stream).
pages_relayed = [0]


def serve_gate() -> channels.Channel:
    """One node's fair-share page-fetch gate (the declared block channel
    ``sync.clone.serve``), shared by its clone streams."""
    return channels.channel("sync.clone.serve")


async def _next_item(stream, gate: Optional[channels.Channel]):
    """The stream's next item, fetched off-loop under a FIFO slot of the
    gate: a full gate's put waits under the ``sync.clone.serve`` budget."""
    if gate is None:
        return await asyncio.to_thread(next, stream, None)
    await gate.put(None)
    try:
        return await asyncio.to_thread(next, stream, None)
    finally:
        gate.get_nowait()


async def _await_ack(tunnel) -> None:
    ack = await with_timeout("sync.clone.ack", tunnel.recv())
    try:
        wire.unpack("clone.ack", ack)
    except wire.WireError:
        raise ConnectionError(f"clone stream: bad ack frame {ack!r}")


async def serve_clone_stream(sync, tunnel, clocks,
                             gate: Optional[channels.Channel] = None) -> bool:
    """Stream the eligible blob pages to the pulling peer. Returns False
    (nothing sent) when the peer is not a fresh clone target: the caller
    then serves the per-op page."""
    stream = sync.iter_clone_stream(clocks)  # lazy: the SQL runs in next()
    started = False
    inflight = 0
    try:
        while True:
            nxt = await _next_item(stream, gate)
            if nxt is None:
                break
            kind, item = nxt
            if not started:
                await with_timeout("p2p.frame_send", tunnel.send(
                    wire.pack("clone.stream", window=CLONE_WINDOW)))
                started = True
            if kind == "ops":
                await with_timeout("p2p.frame_send", tunnel.send(
                    wire.pack("clone.ops", ops=[op.to_wire() for op in item])))
                continue
            # Chaos seam: a dropped page starves the ack window, a
            # disconnect tears the stream mid-clone, a wedge parks it
            # against the drain budget.
            f = chaos.hit("sync.clone.page")
            if not (f is not None and await chaos.apply_async(f)):
                tunnel.send_nowait(wire.pack("clone.page", **item))
                pages_relayed[0] += 1
            inflight += 1
            if inflight >= CLONE_WINDOW:
                # one backpressure point a window, not a frame
                await with_timeout("sync.clone.drain", tunnel.drain())
            while inflight >= CLONE_WINDOW:
                await _await_ack(tunnel)
                inflight -= 1
        await with_timeout("sync.clone.drain", tunnel.drain())
        while inflight > 0:
            await _await_ack(tunnel)
            inflight -= 1
    except BaseException:
        tunnel.close()  # mid-stream failure: no clean blob_done exists
        raise
    if started:
        await with_timeout("p2p.frame_send", tunnel.send(wire.pack("clone.done")))
    return started
