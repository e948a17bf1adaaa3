"""HTTP/WebSocket host: the node's ``apps/server``.

Port of ``spacedrive_tpu/api/server.py`` (upstream apps/server/src/main.rs:
40-63) on the port's own HTTP/1.1 and WebSocket layer (``api/_http.py``),
since the card's host has no aiohttp. The routes and their answers are the
JAX server's (``server.py:119-130``):

- ``GET /`` (the web explorer), ``/static/{name}``,
  ``/manifest.webmanifest`` and ``/health``;
- ``GET /rspc`` upgraded to a WebSocket: ``query``, ``mutation``,
  ``subscription`` and ``subscriptionStop`` frames, ``error`` frames, and
  a duplicate subscription id refused;
- ``GET`` and ``POST /rspc/{path}`` for one-shot calls, admitted through
  the ``api.http.inflight`` window (503 SHED past it);
- ``GET /spacedrive/thumbnail/{cas_id}.webp`` and
  ``GET /spacedrive/file/{library_id}/{location_id}/{file_path_id}`` with
  Range (206, 416) and the over-p2p branch for a remote location
  (custom_uri/mod.rs:149-330).

Wire protocol (JSON frames over the WebSocket):
  → {"id": 1, "type": "query"|"mutation", "path": "...", "input": {...}}
  ← {"id": 1, "type": "response", "result": ...}
  ← {"id": 1, "type": "error", "code": "...", "message": "..."}
  → {"id": 2, "type": "subscription", "path": "...", "input": {...}}
  ← {"id": 2, "type": "event", "data": ...}   (repeatedly)
  → {"id": 2, "type": "subscriptionStop"}

Observability, as in the JAX server: ``GET /metrics`` serves the
registry's Prometheus text; every rspc query or mutation runs in an
``rpc/<path>`` span that continues the caller's trace (the
``X-Sdtpu-Trace`` header over HTTP, the envelope's ``tp`` field over the
WebSocket); requests count into ``sd_api_requests_total{route}`` by route
template; and the ``api.http.dispatch`` and ``api.ws.send`` chaos points
fire at their seams.
"""

from __future__ import annotations

import asyncio
import json
import math
import mimetypes
import os
import re
import time
import uuid as uuidlib
from typing import Any, AsyncIterator, Dict, Optional

from .. import channels, chaos, tasks, telemetry, tracing
from ..locations.paths import IsolatedPath
from ..media.thumbnail import thumbnail_path
from ._http import (HttpError, HttpServer, Request, Response, Upgrade, WebSocket, is_upgrade,
                    json_response, text_response)
from .router import Router, RpcError, mount_router

RANGE_CHUNK = 1 << 20
_SNAPSHOTS = ("TelemetrySnapshot", "HealthSnapshot", "FleetHealthSnapshot")


class WsSubscriptionPump:
    """One subscription's bounded delivery path: events land in an
    ``api.ws`` channel and one supervised drainer task sends them under the
    ``api.ws.send`` budget. Snapshot events coalesce to the newest; past
    the bound a new event is shed, so a stalled consumer loses events and
    never wedges the node or its memory."""

    def __init__(self, send, owner: str):
        self._send = send
        self.chan = channels.channel("api.ws")
        self._task = tasks.spawn("ws-pump", self._drain(), owner=owner)

    def offer(self, payload: dict) -> bool:
        """Queue one event frame (loop thread); False when it was shed."""
        data = payload.get("data")
        key = data["type"] if isinstance(data, dict) and data.get("type") in _SNAPSHOTS \
            else None
        return self.chan.put_nowait(payload, key=key)

    async def _drain(self) -> None:
        while True:
            payload = await self.chan.get()
            # Chaos seam: delay = a slow consumer, wedge = a dead one (the
            # channel sheds while the drainer is parked; teardown cancels
            # this task), drop = a lost frame.
            f = chaos.hit("api.ws.send", only=("delay", "drop", "wedge"))
            if f is not None and await chaos.apply_async(f):
                continue  # dropped
            await self._send(payload)

    async def stop(self) -> None:
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)
        while len(self.chan):
            self.chan.get_nowait()


def _call_threadsafe(loop: asyncio.AbstractEventLoop, fn, arg) -> None:
    """Run fn(arg) on `loop`: at once on its thread, else scheduled; a
    closed loop drops it."""
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        fn(arg)
        return
    try:
        loop.call_soon_threadsafe(fn, arg)
    except RuntimeError:
        pass


def _parse_range(header: str):
    start_s, _, end_s = header[len("bytes="):].partition("-")
    return (int(start_s) if start_s else None), (int(end_s) if end_s else None)


async def _file_chunks(path: str, start: int, length: int) -> AsyncIterator[bytes]:
    f = await asyncio.to_thread(open, path, "rb")
    try:
        await asyncio.to_thread(f.seek, start)
        remaining = length
        while remaining > 0:
            chunk = await asyncio.to_thread(f.read, min(RANGE_CHUNK, remaining))
            if not chunk:
                break
            remaining -= len(chunk)
            yield chunk
    finally:
        f.close()


def _file_response(path: str, content_type: str, rng: Optional[str] = None) -> Response:
    """aiohttp's ``FileResponse``: the whole file with ``Accept-Ranges``,
    ``Last-Modified`` (the mtime rounded up to a second) and an ``ETag`` of
    mtime and size; a ``Range`` header of its one accepted form
    (``bytes=a-b``, ``bytes=a-``, ``bytes=-n``) gives 206, and 416 with
    ``Content-Range: bytes */size`` where it is malformed or past the end."""
    st = os.stat(path)
    size, start, count = st.st_size, None, st.st_size
    headers = {"Content-Type": content_type}
    # aiohttp answers an unsatisfiable range with an empty chunked body
    unsatisfiable = {**headers, "Content-Range": f"bytes */{size}",
                     "Transfer-Encoding": "chunked"}
    if rng is not None:
        m = re.fullmatch(r"bytes=(\d*)-(\d*)", rng, re.ASCII)
        a = int(m.group(1)) if m and m.group(1) else None
        b = int(m.group(2)) if m and m.group(2) else None
        if a is None and b is not None:
            a, b = -b, None
        elif a is not None and b is not None:
            b += 1
        if m is None or (a is None and b is None) or \
                (a is not None and b is not None and a >= b):
            return Response(416, headers=unsatisfiable)
        if a < 0 and b is None:
            start = max(0, a + size)
            count = size - start
        else:
            start = a
            count = min(b if b is not None else size, size) - start
        if start >= size:
            return Response(416, headers=unsatisfiable)
    headers.update({
        "ETag": f'"{st.st_mtime_ns:x}-{st.st_size:x}"',
        "Last-Modified": time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                       time.gmtime(math.ceil(st.st_mtime))),
        "Content-Length": str(count), "Accept-Ranges": "bytes"})
    if start is None:
        return Response(200, headers=headers, stream=_file_chunks(path, 0, count))
    headers["Content-Range"] = f"bytes {start}-{start + count - 1}/{size}"
    return Response(206, headers=headers, stream=_file_chunks(path, start, count))


class ApiServer:
    def __init__(self, node, router: Optional[Router] = None,
                 http_inflight_cap: Optional[int] = None):
        self.node = node
        self._owner = f"{getattr(node, 'task_owner', 'proc')}/api"
        self.router = router or mount_router(node)
        self._http = HttpServer(self._route)
        self.port: Optional[int] = None
        # Admission window for rspc HTTP dispatch: a request past the
        # capacity is refused with 503 SHED instead of queueing unbounded
        # behind a saturated backend; `http_inflight_cap` narrows it.
        self._inflight = channels.channel(
            "api.http.inflight", capacity_cap=http_inflight_cap)

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 8080) -> int:
        self.port = await self._http.start(host, port)
        return self.port

    async def stop(self) -> None:
        await self._http.stop()

    # -- routing -----------------------------------------------------------

    async def _route(self, req: Request):
        """Dispatch by route, counting each request under its route
        template (unmatched paths share one label)."""
        route, handler = self._match(req)
        telemetry.API_REQUESTS.labels(route=route).inc()
        if handler is None:
            raise HttpError(404)
        return await handler()

    def _match(self, req: Request):
        """(route template, handler thunk or None) of a request: the JAX
        server's aiohttp route table, matched by hand."""
        path = req.path
        if req.method in ("GET", "HEAD"):
            if path == "/":
                return "/", self._index
            if path == "/health":
                return "/health", lambda: self._text("OK")
            if path == "/metrics":
                return "/metrics", self._metrics
            if path == "/manifest.webmanifest":
                return "/manifest.webmanifest", self._manifest_async
            if path == "/rspc" and req.method == "GET":
                return "/rspc", lambda: self._upgrade(req)
            parts = path.split("/")
            if len(parts) == 3 and parts[1] == "static" and parts[2]:
                return "/static/{name}", lambda: self._static(parts[2])
            if len(parts) == 4 and parts[1:3] == ["spacedrive", "thumbnail"] \
                    and parts[3].endswith(".webp") and len(parts[3]) > len(".webp"):
                return ("/spacedrive/thumbnail/{cas_id}.webp",
                        lambda: self._thumbnail(req, parts[3][:-len(".webp")]))
            if len(parts) == 6 and parts[1:3] == ["spacedrive", "file"] and all(parts[3:]):
                return ("/spacedrive/file/{library_id}/{location_id}/{file_path_id}",
                        lambda: self._file(req, *parts[3:]))
        if req.method in ("GET", "POST") and path.startswith("/rspc/") \
                and "/" not in path[len("/rspc/"):] and len(path) > len("/rspc/"):
            return "/rspc/{path}", lambda: self._rspc_http(req, path[len("/rspc/"):])
        return "unmatched", None

    async def _text(self, text: str) -> Response:
        return text_response(text)

    async def _manifest_async(self) -> Response:
        return self._manifest()

    async def _upgrade(self, req: Request):
        if not is_upgrade(req):
            raise HttpError(400)
        return Upgrade(self._rspc_ws)

    async def _metrics(self) -> Response:
        """Prometheus text exposition of the node-wide registry (scrape
        this; the web UI gets the same data as TelemetrySnapshot events)."""
        return Response(200, telemetry.render_prometheus().encode("utf-8"),
                        {"Content-Type": telemetry.PROMETHEUS_CONTENT_TYPE})

    # -- handlers ----------------------------------------------------------

    async def _index(self) -> Response:
        from .webui import index_html

        return text_response(await asyncio.to_thread(index_html), content_type="text/html")

    async def _static(self, name: str) -> Response:
        """The explorer's assets; the name must resolve inside STATIC_DIR."""
        from .webui import STATIC_DIR

        path = os.path.realpath(os.path.join(STATIC_DIR, name))
        if not path.startswith(os.path.realpath(STATIC_DIR) + os.sep) \
                or not os.path.isfile(path):
            raise HttpError(404)
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"

        def _read() -> bytes:
            with open(path, "rb") as f:
                return f.read()

        return Response(200, await asyncio.to_thread(_read), {"Content-Type": ctype})

    def _manifest(self) -> Response:
        """PWA manifest: the web UI as an installable standalone app."""
        return json_response({
            "name": "Spacedrive TPU",
            "short_name": "sdtpu",
            "start_url": "/",
            "display": "standalone",
            "background_color": "#16161d",
            "theme_color": "#16161d",
            "description": "TPU-native virtual distributed filesystem",
            "icons": [],
        }, content_type="application/manifest+json")

    async def _rspc_http(self, req: Request, path: str) -> Response:
        if not self._inflight.put_nowait(1):
            # Refused before the body read: a shed request costs no
            # backend work.
            return json_response(
                {"error": {"code": "SHED",
                           "message": "API host at dispatch capacity; "
                                      "retry with backoff"}},
                status=503, headers={"Retry-After": "1"})
        try:
            if req.method == "POST":
                try:
                    input = await req.json()
                except (json.JSONDecodeError, UnicodeDecodeError):
                    input = None
                except asyncio.TimeoutError:
                    # A half-sent body fails the request; it never
                    # dispatches the procedure with null input.
                    return json_response(
                        {"error": {"code": "TIMEOUT",
                                   "message": "request body read timed out"}},
                        status=408)
            else:
                raw = req.query.get("input")
                input = json.loads(raw) if raw else None
            # Chaos seam (inside the admission window): delay = a slow
            # backend, error = a failing one, reported as 503 so clients
            # exercise their retry discipline.
            f = chaos.hit("api.http.dispatch", only=("delay", "error"))
            if f is not None:
                try:
                    await chaos.apply_async(f)
                except chaos.ChaosError as e:
                    return json_response(
                        {"error": {"code": "UNAVAILABLE", "message": str(e)}}, status=503)
            # A client propagates its trace in X-Sdtpu-Trace; the dispatch
            # span continues it, so an API-triggered job shows up under
            # the caller's id.
            with tracing.continue_trace(req.headers.get("X-Sdtpu-Trace")), \
                    tracing.span(f"rpc/{path}"):
                result = await self.router.dispatch(path, input)
            return json_response({"result": result})
        except RpcError as e:
            return json_response(
                {"error": {"code": e.code, "message": e.message}},
                status=400 if e.code == "BAD_REQUEST" else 404
                if e.code == "NOT_FOUND" else 500)
        finally:
            self._inflight.get_nowait()

    async def _rspc_ws(self, ws: WebSocket) -> None:
        subscriptions: Dict[Any, Any] = {}
        loop = asyncio.get_running_loop()

        async def ws_emit(payload: dict) -> None:
            # A subscriber gone mid-emit is unsubscribe racing us; anything
            # else (an unserializable payload) propagates to the supervisor.
            try:
                await ws.send_json(payload)
            except (asyncio.TimeoutError, ConnectionError, RuntimeError):
                pass

        async def handle(msg: dict) -> None:
            mid = msg.get("id")
            mtype = msg.get("type")
            try:
                if mtype in ("query", "mutation"):
                    try:
                        # The envelope's optional "tp" field is the
                        # WebSocket spelling of X-Sdtpu-Trace.
                        with tracing.continue_trace(msg.get("tp")), \
                                tracing.span(f"rpc/{msg['path']}"):
                            result = await self.router.dispatch(msg["path"], msg.get("input"))
                    except asyncio.TimeoutError as e:
                        # A budget fired inside the procedure: the socket is
                        # fine, so report it.
                        raise RpcError("TIMEOUT", f"upstream timeout: {e}") from e
                    await ws.send_json({"id": mid, "type": "response", "result": result})
                elif mtype == "subscription":
                    if mid in subscriptions:
                        # Overwriting the entry would strand the prior
                        # unsubscribe and pump for the server's lifetime.
                        raise RpcError("BAD_REQUEST", f"duplicate subscription id {mid!r}")
                    pump = WsSubscriptionPump(ws_emit, owner=self._owner)

                    def emit(data, _mid=mid, _pump=pump):
                        # Event bus callbacks may fire on worker threads;
                        # the channel is loop-thread only.
                        _call_threadsafe(loop, _pump.offer,
                                         {"id": _mid, "type": "event", "data": data})
                    try:
                        unsub = await self.router.subscribe(msg["path"], msg.get("input"), emit)
                    except asyncio.TimeoutError as e:
                        await pump.stop()
                        raise RpcError("TIMEOUT", f"upstream timeout: {e}") from e
                    except BaseException:
                        await pump.stop()
                        raise
                    subscriptions[mid] = (unsub, pump)
                    await ws.send_json({"id": mid, "type": "response", "result": None})
                elif mtype == "subscriptionStop":
                    unsub, pump = subscriptions.pop(mid, (None, None))
                    if unsub:
                        try:
                            unsub()
                        except Exception:
                            pass
                    if pump:
                        await pump.stop()
                else:
                    raise RpcError("BAD_REQUEST", f"unknown frame type {mtype}")
            except asyncio.TimeoutError:
                # api.ws.send fired: the transport is wedged, and an answer
                # over it would only double the wedge.
                pass
            except RpcError as e:
                await ws.send_json({"id": mid, "type": "error",
                                    "code": e.code, "message": e.message})
            except Exception as e:  # noqa: BLE001 — protocol boundary
                await ws.send_json({"id": mid, "type": "error",
                                    "code": "INTERNAL", "message": str(e)})

        try:
            async for opcode, data in ws:
                if opcode != 0x1:
                    continue
                try:
                    frame = json.loads(data)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                await handle(frame)
        finally:
            # Cancellation-safe teardown: every unsubscribe runs before the
            # first await, then all pumps stop under one shield that is
            # waited out even while this handler is being cancelled.
            for unsub, _pump in subscriptions.values():
                try:
                    unsub()
                except Exception:
                    pass
            if subscriptions:
                stops = asyncio.gather(*(pump.stop() for _, pump in subscriptions.values()),
                                       return_exceptions=True)
                cancelled = False
                while not stops.done():
                    try:
                        await asyncio.shield(stops)
                    except asyncio.CancelledError:
                        cancelled = True
                if cancelled:
                    raise asyncio.CancelledError

    async def _thumbnail(self, req: Request, cas_id: str) -> Response:
        if not cas_id.isalnum():
            raise HttpError(400)
        p = thumbnail_path(self.node.data_dir, cas_id)
        if not os.path.exists(p):
            raise HttpError(404)
        return _file_response(p, "image/webp", req.headers.get("Range"))

    def _location_is_local(self, lib, loc) -> bool:
        """Local when it belongs to this library instance (or predates
        instance attribution)."""
        if loc["instance_id"] is None:
            return True
        row = lib.db.run("node.instance_pub_by_row", (loc["instance_id"],))
        return row is None or row["pub_id"] == lib.sync.instance

    async def _file_over_p2p(self, req: Request, lib, loc, row) -> Response:
        """A remote node's file over the p2p mesh (custom_uri's
        files_over_p2p path): the rows cross as synced pub_ids, the client's
        Range maps onto the spaceblock ranged transfer, and the bytes stream
        back in RANGE_CHUNK pieces."""
        import tempfile

        node = self.node
        if ("filesOverP2P" not in node.config.features
                or node.p2p is None or node.p2p.networked is None):
            raise HttpError(404)
        inst = await asyncio.to_thread(
            lib.db.query_one, "SELECT * FROM instance WHERE id = ?", (loc["instance_id"],))
        if inst is None or not inst["identity"]:
            raise HttpError(404)
        from ..p2p.identity import RemoteIdentity

        route = node.p2p.networked._resolve(RemoteIdentity(inst["identity"]))
        if route is None:
            raise HttpError(404, "peer offline")
        range_start = range_end = None
        rng = req.headers.get("Range")
        if rng and rng.startswith("bytes="):
            try:
                start, end = _parse_range(rng)
            except ValueError:
                raise HttpError(400)
            range_start = start or 0
            range_end = end + 1 if end is not None else None
        with tempfile.NamedTemporaryFile(delete=False) as tmp:
            tmp_path = tmp.name
        try:
            ok = await node.p2p.request_file(
                route[0], route[1], str(lib.id), loc["pub_id"], row["pub_id"], tmp_path,
                range_start=range_start, range_end=range_end)
            if not ok:
                raise HttpError(404, "remote fetch failed")
            name = (row["name"] or "file") + ("." + row["extension"] if row["extension"] else "")
            got = os.path.getsize(tmp_path)
            headers = {"Content-Type": mimetypes.guess_type(name)[0] or "application/octet-stream",
                       "X-Served-Via": "p2p", "Content-Length": str(got),
                       "Accept-Ranges": "bytes"}
            status = 200
            if range_start is not None:
                raw_size = row["size_in_bytes_bytes"]
                size_b = int.from_bytes(raw_size, "big") if raw_size else "*"
                headers["Content-Range"] = f"bytes {range_start}-{range_start + got - 1}/{size_b}"
                status = 206
        except BaseException:
            os.unlink(tmp_path)
            raise

        async def chunks():
            try:
                async for c in _file_chunks(tmp_path, 0, got):
                    yield c
            finally:
                os.unlink(tmp_path)
        return Response(status, headers=headers, stream=chunks())

    async def _file(self, req: Request, library_id: str, location_id: str,
                    file_path_id: str) -> Response:
        """The original file, with Range (custom_uri/mod.rs:149-330)."""
        try:
            lib = self.node.libraries.get(uuidlib.UUID(library_id))
            location_id, file_path_id = int(location_id), int(file_path_id)
        except ValueError:
            raise HttpError(400)
        if lib is None:
            raise HttpError(404)
        row = await asyncio.to_thread(
            lib.db.query_one, "SELECT * FROM file_path WHERE id = ? AND location_id = ?",
            (file_path_id, location_id))
        loc = await asyncio.to_thread(
            lib.db.query_one, "SELECT * FROM location WHERE id = ?", (location_id,))
        if row is None or loc is None:
            raise HttpError(404)
        if not await asyncio.to_thread(self._location_is_local, lib, loc):
            return await self._file_over_p2p(req, lib, loc, row)
        if not loc["path"]:
            raise HttpError(404)
        iso = IsolatedPath.from_db_row(location_id, bool(row["is_dir"]), row["materialized_path"],
                                       row["name"] or "", row["extension"] or "")
        full = iso.join_on(loc["path"])
        if not os.path.isfile(full):
            raise HttpError(404)
        size = os.path.getsize(full)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        rng = req.headers.get("Range")
        if rng and rng.startswith("bytes="):
            try:
                start, end = _parse_range(rng)
            except ValueError:
                raise HttpError(400)
            start = start or 0
            end = min(size - 1 if end is None else end, size - 1)
            if start > end or start >= size:
                raise HttpError(416)
            return Response(206, headers={
                "Content-Type": ctype,
                "Content-Range": f"bytes {start}-{end}/{size}",
                "Content-Length": str(end - start + 1),
                "Accept-Ranges": "bytes",
            }, stream=_file_chunks(full, start, end - start + 1))
        return _file_response(full, ctype)


async def serve(data_dir: str, host: str = "127.0.0.1", port: int = 8080,
                device: str = "cuda", discovery: bool = True) -> None:
    """CLI entry: run a node and its API server until cancelled. The node
    runs its kernels on the card unless `device` is "cpu"; it raises at once
    where CUDA is asked for and absent."""
    from ..node import Node

    node = Node(data_dir, device=device)
    await node.start()
    p2p_port = await node.start_p2p(enable_discovery=discovery)
    node.p2p.interactive_spacedrop = True  # offers flow through p2p.events
    server = ApiServer(node)
    actual = await server.start(host, port)
    print(f"spacedrive_tpu_torch server listening on {host}:{actual} "
          f"(p2p on {p2p_port}, device {device})", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        # Shielded: serve() ends by cancellation (ctrl-C), and the node must
        # still shut down through its reap.
        await asyncio.shield(server.stop())
        await asyncio.shield(node.shutdown())
