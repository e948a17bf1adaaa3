"""Peer discovery: signed UDP multicast beacons.

Port of ``spacedrive_tpu/p2p/discovery.py`` (the role of upstream
crates/p2p/src/discovery/mdns.rs): each node multicasts a beacon on
239.255.41.42:41420 every ``BEACON_INTERVAL_S`` — msgpack ``{"body",
"sig"}`` where ``body`` packs its identity, TCP port, metadata and time
and ``sig`` is its Ed25519 signature of ``body`` — and keeps a table of
the peers it hears, each dropped ``PEER_EXPIRY_S`` after its last beacon.
The beacons are the JAX package's, byte for byte, so either package's
node hears the other.
"""

from __future__ import annotations

import asyncio
import socket
import struct
import time
from typing import Callable, Dict, Optional

from .. import _msgpack, tasks
from .identity import Identity, RemoteIdentity

MCAST_GRP = "239.255.41.42"
MCAST_PORT = 41420
BEACON_INTERVAL_S = 2.0
PEER_EXPIRY_S = 10.0


class DiscoveredPeer:
    def __init__(self, identity: RemoteIdentity, addr: str, port: int,
                 metadata: dict):
        self.identity = identity
        self.addr = addr
        self.port = port
        self.metadata = metadata
        self.last_seen = time.monotonic()

    def __repr__(self) -> str:
        return f"Peer({self.identity!r} @ {self.addr}:{self.port})"


class Discovery:
    """Multicast beacon sender + listener with a peer table."""

    def __init__(self, identity: Identity, service_port: int,
                 metadata: Optional[dict] = None,
                 group: str = MCAST_GRP, port: int = MCAST_PORT,
                 owner: str = "p2p/discovery"):
        self._owner = owner
        self.identity = identity
        self.service_port = service_port
        self.metadata = metadata or {}
        self.group = group
        self.port = port
        self.peers: Dict[RemoteIdentity, DiscoveredPeer] = {}
        self.on_discovered: Optional[Callable[[DiscoveredPeer], None]] = None
        self.on_expired: Optional[Callable[[RemoteIdentity], None]] = None
        self._transport = None
        self._tasks: list = []

    def _beacon(self) -> bytes:
        body = _msgpack.packb({
            "identity": self.identity.to_remote_identity().to_bytes(),
            "port": self.service_port,
            "metadata": self.metadata,
            "ts": time.time(),
        })
        return _msgpack.packb({"body": body, "sig": self.identity.sign(body)})

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except (AttributeError, OSError):
            pass
        sock.bind(("", self.port))
        mreq = struct.pack("4sl", socket.inet_aton(self.group), socket.INADDR_ANY)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        sock.setblocking(False)

        class Proto(asyncio.DatagramProtocol):
            def datagram_received(proto_self, data, addr):
                self._on_datagram(data, addr)

        self._transport, _ = await loop.create_datagram_endpoint(Proto, sock=sock)
        self._tasks = [
            tasks.spawn("beacon", self._beacon_loop(), owner=self._owner),
            tasks.spawn("expire", self._expire_loop(), owner=self._owner),
        ]

    def _on_datagram(self, data: bytes, addr) -> None:
        try:
            outer = _msgpack.unpackb(data)
            body = _msgpack.unpackb(outer["body"])
            remote = RemoteIdentity(body["identity"])
            if remote == self.identity.to_remote_identity():
                return  # our own beacon
            if not remote.verify(outer["sig"], outer["body"]):
                return
        except Exception:
            return
        # signed is not trusted: any LAN host signs with its own key
        port = body.get("port")
        if not isinstance(port, int) or not (0 < port < 65536):
            return
        is_new = remote not in self.peers
        peer = DiscoveredPeer(remote, addr[0], port, body.get("metadata") or {})
        self.peers[remote] = peer
        if is_new and self.on_discovered:
            self.on_discovered(peer)

    async def _beacon_loop(self) -> None:
        while True:
            self._transport.sendto(self._beacon(), (self.group, self.port))
            await asyncio.sleep(BEACON_INTERVAL_S)

    async def _expire_loop(self) -> None:
        while True:
            await asyncio.sleep(PEER_EXPIRY_S / 2)
            now = time.monotonic()
            for key in [k for k, p in self.peers.items()
                        if now - p.last_seen > PEER_EXPIRY_S]:
                self.peers.pop(key, None)
                if self.on_expired:
                    self.on_expired(key)

    async def stop(self) -> None:
        await tasks.cancel_and_gather(*self._tasks)
        self._tasks = []
        if self._transport is not None:
            self._transport.close()
            self._transport = None
