"""NetworkedLibraries: CRDT sync over the p2p mesh.

Port of ``spacedrive_tpu/p2p/sync_net.py`` (upstream
core/src/p2p/sync/mod.rs:31-446). Each library knows the remote
instances it is paired with. When local writes create ops, the
**originator** opens a tunnel to every reachable peer and announces
``new_ops``; the peer, the **responder**, then drives a pull loop over
the same tunnel — ``sync.pull.request`` frames with its watermark clocks,
answered from the originator's op log 1000 ops a page — through its
ingest actor until drained. A fresh peer's first pull is answered with
the clone fast path: the originator's stored blob pages, verbatim, under
windowed flow control (``SDTPU_CLONE_PASSTHROUGH``). A responder that
applied anything announces to its own peers in turn, so writes relay
along any connected mesh. Routes come from pairing, ``set_route`` or
discovery. The JAX module's tracing spans are not ported: the frames'
``tp`` fields stay absent, as the wire allows.
"""

from __future__ import annotations

import asyncio
import logging
import uuid as uuidlib
from typing import Dict, Optional, Tuple

from .. import channels, flags, tasks, timeouts, tracing
from ..sync.clone_serve import serve_clone_stream, serve_gate
from ..sync.crdt import CRDTOperation
from ..sync.ingest import Ingester, MessagesEvent, ReqKind, pump_clone_stream
from ..sync.manager import GetOpsArgs
from ..timeouts import with_timeout
from . import wire
from .identity import RemoteIdentity

logger = logging.getLogger(__name__)

OPS_PER_REQUEST = 1000

# The sync wire version, checked both ways: the responder refuses an
# announce of another version, the originator refuses to serve a pull of
# another (a stale decoder would misread multi-field updates and clone
# frames into its op log).
SYNC_PROTO = wire.proto("sync")


def _call_threadsafe(loop: Optional[asyncio.AbstractEventLoop], fn) -> bool:
    """Run `fn` on `loop`: inline on its own thread, else scheduled. A
    missing or closed loop drops it (peers pull on reconnect anyway)."""
    if loop is None or loop.is_closed():
        return False
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        fn()
        return True
    try:
        loop.call_soon_threadsafe(fn)
    except RuntimeError:  # closed meanwhile
        return False
    return True


class NetworkedLibraries:
    def __init__(self, node, p2p):
        self.node = node
        self.p2p = p2p
        p2p.networked = self
        # Captured so originate_soon works from the worker threads most
        # sync writes run on.
        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            self._loop = None
        # library_id → {instance pub_id → RemoteIdentity}
        self._instances: Dict[uuidlib.UUID, Dict[bytes, RemoteIdentity]] = {}
        # identity bytes → (addr, port), set by pairing or set_route; it
        # always wins over discovery and the cache
        self._routes: Dict[bytes, Tuple[str, int]] = {}
        # identity bytes → the last route that carried a healthy tunnel
        self._route_cache = channels.bounded_dict("p2p.route_cache")
        # a peer that failed its last announce climbs this ladder
        self._announce_backoff = timeouts.RetrySchedule("p2p.announce.reconnect")
        self._clone_gate = serve_gate()
        self._ingest_locks: Dict[uuidlib.UUID, asyncio.Lock] = {}
        self._owner = f"{getattr(node, 'task_owner', 'proc')}/sync"
        self._origin_pending: set = set()
        self._origin_redo: set = set()
        for lib in node.libraries.list():
            self.watch_library(lib)
        node.libraries.on_event(self._on_library_event)

    # -- wiring ------------------------------------------------------------

    def _on_library_event(self, kind: str, library) -> None:
        if kind == "load":
            self.watch_library(library)
        elif kind == "delete":
            for identity in self._instances.get(library.id, {}).values():
                self._announce_backoff.evict(identity.to_bytes())
            self._instances.pop(library.id, None)
            self._ingest_locks.pop(library.id, None)

    def watch_library(self, library) -> None:
        self._instances.setdefault(library.id, {})
        self._load_known_instances(library)
        library.sync.on_created(lambda lib=library: self.originate_soon(lib))

    def _load_known_instances(self, library) -> None:
        """Paired instances persist in the instance table; the identities
        recorded at pairing re-arm them after a restart."""
        me = library.sync.instance
        for row in library.db.run("sync.instances.rows"):
            if row["pub_id"] == me:
                continue
            identity = row["identity"]
            if identity and len(identity) == 32:
                self._instances[library.id][row["pub_id"]] = RemoteIdentity(identity)

    def learn_instance(self, library_id, pub_id: bytes, identity: RemoteIdentity,
                       route: Optional[Tuple[str, int]] = None) -> None:
        self._instances.setdefault(library_id, {})[pub_id] = identity
        if route is not None:
            self._routes[identity.to_bytes()] = route

    def set_route(self, identity: RemoteIdentity, addr: str, port: int) -> None:
        self._routes[identity.to_bytes()] = (addr, port)

    def _resolve(self, identity: RemoteIdentity) -> Optional[Tuple[str, int]]:
        key = identity.to_bytes()
        if key in self._routes:
            return self._routes[key]
        cached = self._route_cache.get(key)
        if cached is not None:
            return cached
        disc = self.p2p.discovery
        if disc is not None:
            for peer in disc.peers.values():
                if peer.identity.to_bytes() == key:
                    return (peer.addr, peer.port)
        return None

    # -- originator (p2p/sync/mod.rs:256-325) ------------------------------

    def originate_soon(self, library) -> None:
        """Local write hook: announce in the background. Callable from any
        thread; a burst while a round runs becomes one more round."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = self._loop

        def spawn() -> None:
            if library.id in self._origin_pending:
                self._origin_redo.add(library.id)
                return
            self._origin_pending.add(library.id)

            async def run() -> None:
                try:
                    while True:
                        self._origin_redo.discard(library.id)
                        await self.originate(library)
                        if library.id not in self._origin_redo:
                            break
                finally:
                    self._origin_pending.discard(library.id)
                    self._origin_redo.discard(library.id)

            tasks.spawn(f"origin/{library.id.hex[:8]}", run(), owner=self._owner)

        _call_threadsafe(loop, spawn)

    async def originate(self, library) -> None:
        for _pub_id, identity in list(self._instances.get(library.id, {}).items()):
            route = self._resolve(identity)
            if route is None:
                continue
            key = identity.to_bytes()
            if not self._announce_backoff.allowed(key):
                continue  # backing off; the peer pulls on any later announce
            try:
                # The serving half of the cross-node sync trace: this span
                # roots it (or continues the caller's), and its traceparent
                # travels in the announce so the responder's sync.pull span
                # lands in the same trace.
                with tracing.span("sync.serve", library=str(library.id)):
                    await self._serve_pull_loop(library, identity, route)
                self._route_cache[key] = route
                self._announce_backoff.success(key)
            except (ConnectionError, OSError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError):
                self._route_cache.pop(key, None)  # re-resolve next time
                self._announce_backoff.failure(key)

    async def _serve_pull_loop(self, library, identity: RemoteIdentity,
                               route: Tuple[str, int]) -> None:
        tunnel = await self.p2p.open_stream(*route, expected=identity)
        try:
            await with_timeout("p2p.frame_send", tunnel.send(
                wire.pack("sync.announce", library_id=str(library.id),
                          tp=tracing.traceparent())))
            # The clone fast path runs at most once a tunnel: a receiver
            # whose watermark stays frozen degrades to the per-op loop.
            clone_served = False
            while True:
                req = await with_timeout("sync.pull.request", tunnel.recv())
                if not isinstance(req, dict) or req.get("kind") == "done":
                    break
                try:
                    req = wire.unpack("sync.pull.request", req)
                except wire.WireVersionError as e:
                    logger.warning("not serving sync pull: %s", e)
                    await with_timeout("p2p.frame_send", tunnel.send(
                        wire.pack("sync.pull.page", ops=[], has_more=False)))
                    break
                clocks = [(bytes(i), int(t)) for i, t in req["clocks"]]
                if not clone_served and flags.get("SDTPU_CLONE_PASSTHROUGH"):
                    clone_served = await serve_clone_stream(
                        library.sync, tunnel, clocks, gate=self._clone_gate)
                    if clone_served:
                        continue
                ops = await asyncio.to_thread(library.sync.get_ops, GetOpsArgs(
                    clocks=clocks,
                    count=min(int(req.get("count", OPS_PER_REQUEST)), OPS_PER_REQUEST)))
                await with_timeout("p2p.frame_send", tunnel.send(wire.pack(
                    "sync.pull.page", ops=[op.to_wire() for op in ops],
                    has_more=len(ops) >= OPS_PER_REQUEST)))
        finally:
            tunnel.close()

    # -- responder (p2p/sync/mod.rs:379-446) -------------------------------

    async def handle_sync_stream(self, tunnel, header: dict) -> None:
        try:
            header = wire.unpack("sync.announce", header)
        except wire.WireVersionError as e:
            # version skew gets a polite refusal; other breaches propagate
            logger.warning("refusing sync stream: %s", e)
            await with_timeout("p2p.frame_send", tunnel.send(wire.pack("sync.done")))
            return
        lib = self.node.libraries.get(uuidlib.UUID(str(header["library_id"])))
        if lib is None:
            await with_timeout("p2p.frame_send", tunnel.send(wire.pack("sync.done")))
            return
        # Continue the originator's trace (the header's tp): this node's
        # pull spans, and the ingester task spawned under them, join the
        # serving node's trace instead of rooting a fresh one.
        with tracing.continue_trace(header.get("tp")), \
                tracing.span("sync.pull", library=str(lib.id)):
            lock = self._ingest_locks.setdefault(lib.id, asyncio.Lock())
            async with lock:
                await self._pull(lib, tunnel)
        self.node.events.invalidate_query(lib.id, "search.paths")

    async def _pull(self, library, tunnel) -> None:
        """Bridge the ingest actor's requests to the wire: MESSAGES become
        pull requests, pages come back as MessagesEvents, FINISHED closes
        the stream. Where anything applied, announce to our own peers."""
        ingester = Ingester(library.sync, owner=f"{self._owner}/ingest")
        ingester.start()
        applied = 0
        try:
            ingester.notify()
            while True:
                req = await ingester.requests.get()
                if req.kind == ReqKind.INGESTED:
                    applied += req.count
                    continue
                if req.kind == ReqKind.FINISHED:
                    await with_timeout("p2p.frame_send",
                                       tunnel.send(wire.pack("sync.done")))
                    return
                if req.kind != ReqKind.MESSAGES:
                    continue
                await with_timeout("p2p.frame_send", tunnel.send(wire.pack(
                    "sync.pull.request", clocks=[[i, t] for i, t in req.timestamps],
                    count=OPS_PER_REQUEST, tp=tracing.traceparent())))
                page = await with_timeout("sync.pull.page", tunnel.recv())
                if isinstance(page, dict) and page.get("kind") == "blob_stream":
                    # the clone fast path answered: drain it, then let the
                    # ingester re-request with the advanced clocks
                    wire.unpack("clone.stream", page)
                    n, _fast, _fb = await pump_clone_stream(
                        library.sync, tunnel.recv, tunnel.send, ingester.errors)
                    applied += n
                    ingester.deliver(MessagesEvent(instance=library.sync.instance,
                                                   messages=[], has_more=True))
                    continue
                page = wire.unpack("sync.pull.page", page)
                ops = [CRDTOperation.from_wire(raw) for raw in page.get("ops", [])]
                ingester.deliver(MessagesEvent(instance=library.sync.instance,
                                               messages=ops,
                                               has_more=bool(page.get("has_more"))))
        finally:
            # shielded: a cancelled pull still reaps its actor
            await asyncio.shield(ingester.stop())
            while not ingester.requests.empty():
                req = ingester.requests.get_nowait()
                if req.kind == ReqKind.INGESTED:
                    applied += req.count
            if applied:
                # relay whatever did apply, even after an abnormal end
                self.originate_soon(library)
