"""Spaceblock: block-based file transfer over a tunnel.

Port of ``spacedrive_tpu/p2p/spaceblock.py`` (upstream
crates/p2p/src/spaceblock/mod.rs:1-70, after Syncthing's BEP): a
``SpaceblockRequest`` (name, size, optional range), then fixed-size
blocks, each acknowledged with ``ok`` or ``cancel`` so the receiver can
stop the transfer. The block size grows with the file size
(``block_size_from_file_size``, the reference's ``BlockSize::from_size``).
"""

from __future__ import annotations

from typing import BinaryIO, Callable, Optional

from ..timeouts import with_timeout
from . import wire
from .proto import Tunnel

KIB, MIB = 1024, 1024 * 1024


def block_size_from_file_size(size: int) -> int:
    if size > 500 * MIB:
        return 4 * MIB
    if size > 100 * MIB:
        return 1 * MIB
    if size > 10 * MIB:
        return 512 * KIB
    return 128 * KIB


class SpaceblockRequest:
    def __init__(self, name: str, size: int,
                 range_start: Optional[int] = None,
                 range_end: Optional[int] = None):
        self.name = name
        self.size = size
        self.range_start = range_start
        self.range_end = range_end

    def to_wire(self) -> dict:
        return wire.pack("spaceblock.request", name=self.name, size=self.size,
                         range_start=self.range_start, range_end=self.range_end)

    @classmethod
    def from_wire(cls, raw: dict) -> "SpaceblockRequest":
        raw = wire.unpack("spaceblock.request", raw)
        return cls(raw["name"], raw["size"], raw.get("range_start"),
                   raw.get("range_end"))

    @property
    def effective_range(self) -> tuple:
        start = self.range_start or 0
        end = self.range_end if self.range_end is not None else self.size
        return start, min(end, self.size)


async def send_file(tunnel: Tunnel, req: SpaceblockRequest, f: BinaryIO,
                    on_progress: Optional[Callable[[int], None]] = None) -> bool:
    """Stream the (ranged) file's blocks, each acked by the receiver.
    Returns False if it cancelled."""
    start, end = req.effective_range
    block = block_size_from_file_size(req.size)
    f.seek(start)
    sent = 0
    total = end - start
    while sent < total:
        chunk = f.read(min(block, total - sent))
        if not chunk:
            break
        # a budget per block: any size stays alive while blocks progress
        await with_timeout("p2p.transfer.chunk", tunnel.send_raw(chunk))
        sent += len(chunk)
        if on_progress:
            on_progress(sent)
        ack = await with_timeout("p2p.transfer.chunk", tunnel.recv())
        try:
            ack = wire.unpack("spaceblock.verdict", ack)
        except wire.WireError:
            return False  # an off-contract ack is no consent
        if ack != "ok":
            return False
    return True


async def receive_file(tunnel: Tunnel, req: SpaceblockRequest, out: BinaryIO,
                       on_progress: Optional[Callable[[int], None]] = None,
                       should_cancel: Optional[Callable[[], bool]] = None) -> bool:
    start, end = req.effective_range
    total = end - start
    got = 0
    while got < total:
        chunk = wire.unpack("spaceblock.chunk",
                            await with_timeout("p2p.transfer.chunk", tunnel.recv_raw()))
        out.write(chunk)
        got += len(chunk)
        if on_progress:
            on_progress(got)
        if should_cancel and should_cancel():
            await with_timeout("p2p.transfer.chunk", tunnel.send(
                wire.pack("spaceblock.verdict", value="cancel")))
            return False
        await with_timeout("p2p.transfer.chunk", tunnel.send(
            wire.pack("spaceblock.verdict", value="ok")))
    return True
