"""P2PManager: the node's peer-to-peer service.

Port of ``spacedrive_tpu/p2p/manager.py`` (upstream
core/src/p2p/p2p_manager.rs:88-340): a TCP listener whose accepted
streams run the authenticated tunnel handshake and then dispatch on the
header's ``t`` (ping, spacedrop, pair, file, sync); discovery; and the
outbound calls: ``ping``, ``spacedrop`` (with the receiver's interactive
accept or reject), ``request_file`` (files over p2p, rows addressed by
synced pub_ids) and ``pair`` (one round-trip of instance rows, then a
backfill announce). The obs plane's headers (``obs.*``) are declared on
the wire but not served yet: such a tunnel is closed unanswered, as the
JAX manager closes a header it does not serve. QUIC is TCP here, as in
the JAX package.
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid as uuidlib
from typing import Callable, Dict, Optional

from .. import chaos, tracing
from ..timeouts import deadline, with_timeout
from . import wire
from .discovery import Discovery
from .identity import Identity, RemoteIdentity
from .proto import Tunnel, tunnel_handshake
from .spaceblock import SpaceblockRequest, receive_file, send_file


class P2PManager:
    def __init__(self, node, identity: Optional[Identity] = None,
                 enable_discovery: bool = True):
        self.node = node
        self.identity = identity or Identity()
        self.enable_discovery = enable_discovery
        self.discovery: Optional[Discovery] = None
        self.mdns = None
        self.server: Optional[asyncio.base_events.Server] = None
        self.port: Optional[int] = None
        # Spacedrop decision hook: (peer, request) -> save path | None.
        self.on_spacedrop: Callable[[RemoteIdentity, SpaceblockRequest],
                                    Optional[str]] = lambda peer, req: None
        # Pairing decision hook: (peer, library info) -> bool.
        self.on_pairing_request: Callable[[RemoteIdentity, dict],
                                          bool] = lambda peer, info: False
        self._spacedrop_cancel: Dict[str, bool] = {}
        # Interactive mode: where the hook declines, park the offer, emit
        # SpacedropRequest and wait for accept_ / reject_spacedrop.
        self.interactive_spacedrop = False
        self._pending_drops: Dict[str, asyncio.Future] = {}
        self.networked = None  # set by sync_net.NetworkedLibraries

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        self.server = await asyncio.start_server(self._on_connection, host, port)
        self.port = self.server.sockets[0].getsockname()[1]
        if self.enable_discovery:
            self.discovery = Discovery(
                self.identity, self.port,
                metadata={"name": self.node.config.name,
                          "node_id": self.node.config.id.hex()},
                owner=f"{self.node.task_owner}/p2p/discovery")
            await self.discovery.start()
            from .mdns import MdnsService

            self.mdns = MdnsService(
                instance=self.node.config.id.hex()[:12], service_port=self.port,
                txt={"name": self.node.config.name, "id": self.node.config.id.hex(),
                     "identity": self.identity.to_remote_identity().to_bytes().hex()},
                owner=f"{self.node.task_owner}/p2p/mdns")
            try:
                await self.mdns.start()
            except OSError:
                self.mdns = None  # 5353 taken: beacons only
        return self.port

    async def stop(self) -> None:
        if self.discovery is not None:
            await self.discovery.stop()
        if self.mdns is not None:
            await self.mdns.stop()
            self.mdns = None
        if self.server is not None:
            self.server.close()
            await self.server.wait_closed()
            self.server = None

    # -- outbound ----------------------------------------------------------

    async def open_stream(self, addr: str, port: int,
                          expected: Optional[RemoteIdentity] = None) -> Tunnel:
        async with deadline("p2p.connect"):
            # Chaos seam: error = an unreachable peer (the announce loop's
            # declared backoff path); wedge parks the dial until this
            # deadline frees it.
            f = chaos.hit("p2p.tunnel.open", only=("delay", "error", "wedge"))
            if f is not None:
                await chaos.apply_async(f)
            reader, writer = await asyncio.open_connection(addr, port)
            try:
                return await tunnel_handshake(reader, writer, self.identity,
                                              initiator=True, expected=expected)
            except BaseException:
                writer.close()  # a failed handshake must not leak the socket
                raise

    async def ping(self, addr: str, port: int) -> float:
        t0 = time.monotonic()
        with tracing.span("p2p/ping", peer=f"{addr}:{port}"):
            tunnel = await self.open_stream(addr, port)
            try:
                async with deadline("p2p.ping"):
                    await tunnel.send(wire.pack("p2p.ping", tp=tracing.traceparent()))
                    wire.unpack("p2p.pong", await tunnel.recv())
            finally:
                tunnel.close()
        return time.monotonic() - t0

    def _progress_emitter(self, drop_id: str, total: int, direction: str):
        """Throttled SpacedropProgress events, at the job plane's cadence."""
        from ..jobs.worker import PROGRESS_THROTTLE_S

        last = [0.0]

        def emit(done: int) -> None:
            now = time.monotonic()
            if now - last[0] >= PROGRESS_THROTTLE_S or done >= total:
                last[0] = now
                self.node.events.emit({
                    "type": "SpacedropProgress", "id": drop_id,
                    "direction": direction, "bytes": done, "total": total})
        return emit

    async def spacedrop(self, addr: str, port: int, file_path: str,
                        on_progress=None) -> str:
        """Send a file to a peer: 'sent', 'rejected' or 'cancelled'."""
        with tracing.span("p2p/spacedrop", peer=f"{addr}:{port}",
                          bytes=os.path.getsize(file_path)):
            return await self._spacedrop(addr, port, file_path, on_progress)

    async def _spacedrop(self, addr: str, port: int, file_path: str,
                         on_progress=None) -> str:
        size = os.path.getsize(file_path)
        req = SpaceblockRequest(os.path.basename(file_path), size)
        drop_id = uuidlib.uuid4().hex
        on_progress = on_progress or self._progress_emitter(drop_id, size, "send")
        tunnel = await self.open_stream(addr, port)
        try:
            await with_timeout("p2p.frame_send", tunnel.send(
                wire.pack("p2p.spacedrop.offer", req=req.to_wire(),
                          tp=tracing.traceparent())))
            try:
                verdict = wire.unpack("p2p.spacedrop.verdict", await with_timeout(
                    "p2p.spacedrop.verdict", tunnel.recv()))
            except wire.WireError:
                return "rejected"  # an off-contract verdict is no consent
            if verdict != "accept":
                return "rejected"
            self.node.events.emit({
                "type": "SpacedropStarted", "id": drop_id, "direction": "send",
                "name": req.name, "size": size, "peer": f"{addr}:{port}"})
            with await asyncio.to_thread(open, file_path, "rb") as f:
                ok = await send_file(tunnel, req, f, on_progress)
            return "sent" if ok else "cancelled"
        finally:
            tunnel.close()

    async def request_file(self, addr: str, port: int, library_id: str,
                           location_pub_id: bytes, file_path_pub_id: bytes,
                           out_path: str, range_start: Optional[int] = None,
                           range_end: Optional[int] = None) -> bool:
        """Fetch a file from a remote node's library by synced pub_ids."""
        with tracing.span("p2p/file", peer=f"{addr}:{port}"):
            return await self._request_file(addr, port, library_id, location_pub_id,
                                            file_path_pub_id, out_path, range_start,
                                            range_end)

    async def _request_file(self, addr, port, library_id, location_pub_id,
                            file_path_pub_id, out_path, range_start, range_end) -> bool:
        tunnel = await self.open_stream(addr, port)
        try:
            await with_timeout("p2p.frame_send", tunnel.send(wire.pack(
                "p2p.file.request", library_id=library_id,
                location_pub_id=location_pub_id, file_path_pub_id=file_path_pub_id,
                range_start=range_start, range_end=range_end,
                tp=tracing.traceparent())))
            try:
                resp = wire.unpack("p2p.file.response", await with_timeout(
                    "p2p.file.response", tunnel.recv()))
            except wire.WireError:
                return False
            if resp.get("status") != "ok":
                return False
            req = SpaceblockRequest.from_wire(resp["req"])
            with await asyncio.to_thread(open, out_path, "wb") as out:
                return await receive_file(tunnel, req, out)
        finally:
            tunnel.close()

    def _instance_info(self, library) -> dict:
        me = library.db.query_one("SELECT * FROM instance WHERE pub_id = ?",
                                  (library.sync.instance,))
        return {"pub_id": me["pub_id"],
                "identity": self.identity.to_remote_identity().to_bytes(),
                "node_id": self.node.config.id, "node_name": self.node.config.name}

    async def pair(self, addr: str, port: int, library) -> bool:
        """Pair a library with a peer: exchange instance rows so sync can
        flow (upstream p2p/pairing protocol v1 as one signed round-trip),
        then announce so the peer pulls the existing op log."""
        with tracing.span("p2p/pair", peer=f"{addr}:{port}", library=str(library.id)):
            return await self._pair(addr, port, library)

    async def _pair(self, addr: str, port: int, library) -> bool:
        tunnel = await self.open_stream(addr, port)
        try:
            async with deadline("p2p.pair"):
                info = await asyncio.to_thread(self._instance_info, library)
                await tunnel.send(wire.pack(
                    "p2p.pair.request", tp=tracing.traceparent(),
                    library_id=str(library.id),
                    library_name=library.config.name,
                    # our LISTENING port: the TCP source port is ephemeral
                    listen_port=self.port, instance=info))
                try:
                    resp = wire.unpack("p2p.pair.response", await tunnel.recv())
                except wire.WireError:
                    return False
                if resp.get("status") != "accepted":
                    return False
                inst = resp["instance"]
                await asyncio.to_thread(
                    library.sync.register_instance, inst["pub_id"],
                    identity=inst["identity"], node_id=inst["node_id"],
                    node_name=inst["node_name"])
            if self.networked is not None:
                self.networked.learn_instance(library.id, inst["pub_id"],
                                              RemoteIdentity(inst["identity"]),
                                              route=(addr, port))
                self.networked.originate_soon(library)
            return True
        finally:
            tunnel.close()

    # -- inbound dispatch --------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            tunnel = await tunnel_handshake(reader, writer, self.identity,
                                            initiator=False)
        except Exception:
            writer.close()
            return
        try:
            header = await with_timeout("p2p.header_recv", tunnel.recv())
            t = header.get("t") if isinstance(header, dict) else None
            tp = header.get("tp") if isinstance(header, dict) else None
            # Continue the dialer's trace: every handler span below lands in
            # the caller's trace (sync.pull re-anchors to the same header).
            # Each branch holds the header to its contract before reading
            # a field; a WireError lands in the generic handler below.
            with tracing.continue_trace(tp):
                if t == "ping":
                    with tracing.span("p2p/ping"):
                        wire.unpack("p2p.ping", header)
                        await with_timeout("p2p.frame_send",
                                           tunnel.send(wire.pack("p2p.pong")))
                elif t == "spacedrop":
                    with tracing.span("p2p/spacedrop"):
                        await self._handle_spacedrop(
                            tunnel, wire.unpack("p2p.spacedrop.offer", header))
                elif t == "pair":
                    with tracing.span("p2p/pair"):
                        await self._handle_pair(tunnel, wire.unpack("p2p.pair.request", header))
                elif t == "file":
                    with tracing.span("p2p/file"):
                        await self._handle_file(tunnel, wire.unpack("p2p.file.request", header))
                elif t == "sync":
                    # handle_sync_stream opens its own sync.pull span,
                    # parented on the originator's sync.serve span.
                    if self.networked is not None:
                        await self.networked.handle_sync_stream(tunnel, header)
                # any other header (the obs plane's) is closed unanswered
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:
            self.node.events.emit({"type": "P2PError", "error": str(e)})
        finally:
            tunnel.close()

    async def _decide_spacedrop(self, peer: RemoteIdentity, req: SpaceblockRequest,
                                drop_id: str) -> Optional[str]:
        save_path = self.on_spacedrop(peer, req)
        if save_path is not None or not self.interactive_spacedrop:
            return save_path
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending_drops[drop_id] = fut
        # the peer-chosen name is untrusted: consumers get a bare basename
        safe_name = os.path.basename(req.name).lstrip(".") or "spacedrop.bin"
        self.node.events.emit({
            "type": "SpacedropRequest", "id": drop_id, "name": safe_name,
            "size": req.size, "peer": peer.to_bytes().hex()})
        try:
            return await with_timeout("p2p.spacedrop.decide", fut)
        except asyncio.TimeoutError:
            self.node.events.emit({"type": "SpacedropTimedout", "id": drop_id})
            return None
        finally:
            self._pending_drops.pop(drop_id, None)

    def accept_spacedrop(self, drop_id: str, save_path: str) -> bool:
        fut = self._pending_drops.get(drop_id)
        if fut is None or fut.done():
            return False
        fut.set_result(save_path)
        return True

    def reject_spacedrop(self, drop_id: str) -> bool:
        fut = self._pending_drops.get(drop_id)
        if fut is None or fut.done():
            return False
        fut.set_result(None)
        self.node.events.emit({"type": "SpacedropRejected", "id": drop_id})
        return True

    def cancel_spacedrop(self, drop_id: str) -> None:
        if drop_id in self._spacedrop_cancel:
            self._spacedrop_cancel[drop_id] = True

    async def _handle_spacedrop(self, tunnel: Tunnel, header: dict) -> None:
        req = SpaceblockRequest.from_wire(header["req"])
        drop_id = uuidlib.uuid4().hex  # minted here: the sender's is untrusted
        save_path = await self._decide_spacedrop(tunnel.remote, req, drop_id)
        if save_path is None:
            await with_timeout("p2p.frame_send", tunnel.send(
                wire.pack("p2p.spacedrop.verdict", value="reject")))
            return
        await with_timeout("p2p.frame_send", tunnel.send(
            wire.pack("p2p.spacedrop.verdict", value="accept")))
        self._spacedrop_cancel[drop_id] = False
        self.node.events.emit({
            "type": "SpacedropStarted", "id": drop_id, "name": req.name,
            "direction": "receive", "size": req.size, "path": save_path,
            "peer": tunnel.remote.to_bytes().hex()})
        try:
            with await asyncio.to_thread(open, save_path, "wb") as out:
                await receive_file(
                    tunnel, req, out,
                    on_progress=self._progress_emitter(drop_id, req.size, "receive"),
                    should_cancel=lambda: self._spacedrop_cancel.get(drop_id, False))
        finally:
            self._spacedrop_cancel.pop(drop_id, None)
        self.node.events.emit({
            "type": "SpacedropReceived", "name": req.name, "path": save_path,
            "from": tunnel.remote.to_bytes().hex()})

    async def _handle_pair(self, tunnel: Tunnel, header: dict) -> None:
        if not self.on_pairing_request(tunnel.remote, header):
            await with_timeout("p2p.frame_send", tunnel.send(
                wire.pack("p2p.pair.response", status="rejected")))
            return
        lib = None
        for candidate in self.node.libraries.list():
            if str(candidate.id) == header["library_id"]:
                lib = candidate
                break
        if lib is None:
            # pairing into a library we lack: create it under the
            # originator's UUID, by which sync streams address it
            lib = self.node.create_library(
                header.get("library_name", "paired library"),
                lib_id=uuidlib.UUID(str(header["library_id"])))
        inst = header["instance"]
        await asyncio.to_thread(lib.sync.register_instance, inst["pub_id"],
                                identity=inst["identity"], node_id=inst["node_id"],
                                node_name=inst["node_name"])
        if self.networked is not None:
            # back to the initiator: its socket IP and announced listen port
            route = None
            peer = tunnel.writer.get_extra_info("peername")
            if peer and header.get("listen_port"):
                route = (peer[0], int(header["listen_port"]))
            self.networked.learn_instance(lib.id, inst["pub_id"],
                                          RemoteIdentity(inst["identity"]), route=route)
        info = await asyncio.to_thread(self._instance_info, lib)
        await with_timeout("p2p.frame_send", tunnel.send(wire.pack(
            "p2p.pair.response", status="accepted", instance=info)))
        if self.networked is not None:
            # symmetric backfill: our existing ops flow to the initiator
            self.networked.originate_soon(lib)

    async def _handle_file(self, tunnel: Tunnel, header: dict) -> None:
        from ..locations.paths import IsolatedPath

        async def not_found() -> None:
            await with_timeout("p2p.frame_send", tunnel.send(
                wire.pack("p2p.file.response", status="not_found")))

        lib = self.node.libraries.get(uuidlib.UUID(str(header["library_id"])))
        if lib is None:
            return await not_found()
        loc = await asyncio.to_thread(lib.db.query_one,
                                      "SELECT * FROM location WHERE pub_id = ?",
                                      (bytes(header["location_pub_id"]),))
        row = (await asyncio.to_thread(lib.db.query_one,
                                       "SELECT * FROM file_path WHERE pub_id = ?",
                                       (bytes(header["file_path_pub_id"]),))) if loc else None
        if row is None or loc is None or not loc["path"] or row["location_id"] != loc["id"]:
            return await not_found()
        iso = IsolatedPath.from_db_row(loc["id"], bool(row["is_dir"]),
                                       row["materialized_path"], row["name"] or "",
                                       row["extension"] or "")
        full = iso.join_on(loc["path"])
        if not os.path.isfile(full):
            return await not_found()
        req = SpaceblockRequest(os.path.basename(full), os.path.getsize(full),
                                header.get("range_start"), header.get("range_end"))
        await with_timeout("p2p.frame_send", tunnel.send(
            wire.pack("p2p.file.response", status="ok", req=req.to_wire())))
        with await asyncio.to_thread(open, full, "rb") as f:
            await send_file(tunnel, req, f)
