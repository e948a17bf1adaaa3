"""A small HTTP/1.1 server and RFC 6455 server-side WebSocket on asyncio.

The JAX package's API host stands on ``aiohttp.web``; the card's host has
no aiohttp, so the port serves its routes with this module instead. All of
it runs on the node's event loop (``asyncio.start_server``), with no thread
pool:

- HTTP/1.1: the request line and headers, ``Content-Length`` bodies, the
  query string, keep-alive (HTTP/1.1's default; ``Connection: close``
  ends it), responses with a body (chunked on request) or a stream of
  chunks of a known length. A request's head and body are read under the ``api.http.read``
  budget and each response write drains under ``api.http.write``.
- WebSocket (RFC 6455, server side): the ``Sec-WebSocket-Accept``
  handshake under ``api.ws.prepare``; masked client frames (an unmasked
  one is refused with close code 1002); 7-, 16- and 64-bit payload
  lengths; continuation frames; ping answered by pong; the close
  handshake. A frame sent to the client drains under ``api.ws.send``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import struct
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import AsyncIterator, Awaitable, Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..timeouts import with_timeout

logger = logging.getLogger(__name__)

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024
MAX_MESSAGE_BYTES = 64 * 1024 * 1024

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_GOING_AWAY, CLOSE_PROTOCOL_ERROR, CLOSE_TOO_BIG = 1000, 1001, 1002, 1009


class HttpError(Exception):
    """Answer the request with `status` and aiohttp's plain-text body
    (``"404: Not Found"``), as the JAX host's ``web.HTTPNotFound`` does."""

    def __init__(self, status: int, text: Optional[str] = None):
        super().__init__(status)
        self.status = status
        self.text = text


class Headers:
    """Case-insensitive request headers; the last value of a repeated
    name wins."""

    def __init__(self, items: List[Tuple[str, str]]):
        self._d = {k.lower(): v for k, v in items}

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._d.get(name.lower(), default)


@dataclass
class Request:
    method: str
    target: str
    version: str
    headers: Headers
    reader: asyncio.StreamReader
    path: str = ""
    query: Dict[str, str] = field(default_factory=dict)
    _body: Optional[bytes] = None

    def __post_init__(self):
        parts = urlsplit(self.target)
        self.path = unquote(parts.path)
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))

    async def body(self) -> bytes:
        """The ``Content-Length`` body, read once under ``api.http.read``."""
        if self._body is None:
            n = int(self.headers.get("Content-Length") or 0)
            if n < 0 or n > MAX_BODY_BYTES:
                raise HttpError(413)
            self._body = await with_timeout("api.http.read", self.reader.readexactly(n)) \
                if n else b""
        return self._body

    async def json(self):
        return json.loads(await self.body())


@dataclass
class Response:
    """A response: `body` (chunk-encoded where the handler set
    ``Transfer-Encoding: chunked``), or `stream` (an async iterator of chunks
    whose lengths add up to the ``Content-Length`` header the handler set)."""

    status: int = 200
    body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)
    stream: Optional[AsyncIterator[bytes]] = None


def text_response(text: str, status: int = 200, content_type: str = "text/plain") -> Response:
    return Response(status, text.encode("utf-8"),
                    {"Content-Type": f"{content_type}; charset=utf-8"})


def json_response(data, status: int = 200, headers: Optional[Dict[str, str]] = None,
                  content_type: str = "application/json") -> Response:
    """``aiohttp.web.json_response``: ``json.dumps`` with its defaults."""
    return Response(status, json.dumps(data).encode("utf-8"),
                    {"Content-Type": f"{content_type}; charset=utf-8", **(headers or {})})


def error_response(status: int, text: Optional[str] = None) -> Response:
    return text_response(text if text is not None else
                         f"{status}: {HTTPStatus(status).phrase}", status)


@dataclass
class Upgrade:
    """A handler's answer to a WebSocket upgrade request: after the
    handshake the connection belongs to `run(ws)`."""

    run: Callable[["WebSocket"], Awaitable[None]]


def ws_accept(key: str) -> str:
    return base64.b64encode(hashlib.sha1(key.encode("ascii") + WS_GUID).digest()).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 mask: Optional[bytes] = None) -> bytes:
    """One frame; the server sends unmasked ones, a client passes `mask`."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(bit | 127)
        head += struct.pack(">Q", n)
    if mask is not None:
        head += mask
        payload = apply_mask(payload, mask)
    return bytes(head) + payload


def apply_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR with the repeating 4-byte key, one big-int operation."""
    n = len(payload)
    if not n:
        return b""
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "little") ^ int.from_bytes(key, "little")).to_bytes(n, "little")


class WebSocketClosed(Exception):
    pass


class WebSocket:
    """The server side of one upgraded connection. ``receive`` yields
    whole text or binary messages and answers control frames itself;
    every send is one ``write`` of a whole frame, so frames from several
    tasks never interleave."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed and opcode != OP_CLOSE:
            raise ConnectionResetError("websocket is closed")
        self.writer.write(encode_frame(opcode, payload))
        await with_timeout("api.ws.send", self.writer.drain())

    async def send_str(self, text: str) -> None:
        await self._send_frame(OP_TEXT, text.encode("utf-8"))

    async def send_json(self, data) -> None:
        await self.send_str(json.dumps(data))

    async def close(self, code: int = CLOSE_NORMAL) -> None:
        """Send a close frame once; the connection ends when the handler
        returns."""
        if self.closed:
            return
        self.closed = True
        try:
            await self._send_frame(OP_CLOSE, struct.pack(">H", code))
        except (ConnectionError, asyncio.TimeoutError, RuntimeError):
            pass

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        b0, b1 = await self.reader.readexactly(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if b0 & 0x70:
            raise _ProtocolError("reserved bits set")
        if not b1 & 0x80:
            raise _ProtocolError("unmasked client frame")
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack(">H", await self.reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", await self.reader.readexactly(8))[0]
        if opcode >= 0x8 and (n > 125 or not fin):
            raise _ProtocolError("bad control frame")
        if n > MAX_MESSAGE_BYTES:
            raise _TooBig()
        mask = await self.reader.readexactly(4)
        return fin, opcode, apply_mask(await self.reader.readexactly(n), mask)

    async def receive(self) -> Tuple[int, bytes]:
        """The next text or binary message as (opcode, payload); raises
        ``WebSocketClosed`` after a close frame, EOF or a protocol error
        (which it answers with close code 1002, or 1009 for a message too
        big)."""
        parts: List[bytes] = []
        first = None
        try:
            while True:
                fin, opcode, payload = await self._read_frame()
                if opcode == OP_PING:
                    await self._send_frame(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    code = struct.unpack(">H", payload[:2])[0] if len(payload) >= 2 \
                        else CLOSE_NORMAL
                    await self.close(code)
                    raise WebSocketClosed(code)
                if opcode == OP_CONT:
                    if first is None:
                        raise _ProtocolError("continuation without a first frame")
                elif opcode in (OP_TEXT, OP_BINARY):
                    if first is not None:
                        raise _ProtocolError("new message inside a fragmented one")
                    first = opcode
                else:
                    raise _ProtocolError(f"unknown opcode {opcode}")
                parts.append(payload)
                if sum(map(len, parts)) > MAX_MESSAGE_BYTES:
                    raise _TooBig()
                if fin:
                    return first, b"".join(parts)
        except _TooBig:
            await self.close(CLOSE_TOO_BIG)
            raise WebSocketClosed(CLOSE_TOO_BIG)
        except _ProtocolError:
            await self.close(CLOSE_PROTOCOL_ERROR)
            raise WebSocketClosed(CLOSE_PROTOCOL_ERROR)
        except (asyncio.IncompleteReadError, ConnectionError):
            self.closed = True
            raise WebSocketClosed(None)

    async def __aiter__(self):
        while True:
            try:
                yield await self.receive()
            except WebSocketClosed:
                return


class _ProtocolError(Exception):
    pass


class _TooBig(Exception):
    pass


Handler = Callable[[Request], Awaitable[object]]


class HttpServer:
    """Serves `handler` (a coroutine taking a ``Request`` and returning a
    ``Response`` or an ``Upgrade``, or raising ``HttpError``) on every
    connection of one listening socket."""

    def __init__(self, handler: Handler):
        self.handler = handler
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: Set[asyncio.Task] = set()

    async def start(self, host: str, port: int) -> int:
        """Listen on (host, port); returns the bound port."""
        self._server = await asyncio.start_server(self._serve_conn, host, port,
                                                  limit=MAX_HEAD_BYTES)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop listening, then cancel every open connection (a WebSocket
        handler included) and wait for them to finish their teardown."""
        if self._server is not None:
            self._server.close()
            self._server = None
        conns = list(self._conns)
        for t in conns:
            t.cancel()
        if conns:
            await asyncio.gather(*conns, return_exceptions=True)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    req = await with_timeout("api.http.read", self._read_head(reader))
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError, ValueError, ConnectionError):
                    return
                if req is None:
                    return
                if not await self._answer(req, reader, writer):
                    return
        except asyncio.CancelledError:
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError, OSError):
                pass

    @staticmethod
    async def _read_head(reader: asyncio.StreamReader) -> Optional[Request]:
        line = await reader.readline()
        while line in (b"\r\n", b"\n"):  # RFC 9112 §2.2: ignore leading empty lines
            line = await reader.readline()
        if not line:
            return None
        method, target, version = line.decode("latin-1").strip().split(" ", 2)
        if not version.startswith("HTTP/1."):
            raise ValueError(f"unsupported version {version!r}")
        items = []
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            items.append((name.strip(), value.strip()))
        return Request(method.upper(), target, version, Headers(items), reader)

    async def _answer(self, req: Request, reader, writer) -> bool:
        """Serve one request; False when the connection must end."""
        try:
            result = await self.handler(req)
        except HttpError as e:
            result = error_response(e.status, e.text)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError):
            return False
        except Exception:  # noqa: BLE001 — a handler's fault answers 500
            logger.exception("%s %s failed", req.method, req.path)
            result = error_response(500)
        if isinstance(result, Upgrade):
            await self._upgrade(req, result, reader, writer)
            return False
        # an unread body must not be parsed as the next request
        if req._body is None and int(req.headers.get("Content-Length") or 0):
            try:
                await req.body()
            except (HttpError, asyncio.TimeoutError, asyncio.IncompleteReadError):
                return False
        keep = self._keep_alive(req)
        try:
            await self._write_response(req, result, writer, keep)
        except (asyncio.TimeoutError, ConnectionError):
            return False
        return keep

    @staticmethod
    def _keep_alive(req: Request) -> bool:
        conn = (req.headers.get("Connection") or "").lower()
        if req.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn

    @staticmethod
    async def _write_response(req: Request, resp: Response, writer, keep: bool) -> None:
        headers = dict(resp.headers)
        chunked = headers.get("Transfer-Encoding") == "chunked"
        if resp.stream is None and not chunked:
            headers["Content-Length"] = str(len(resp.body))
        headers.setdefault("Content-Type", "application/octet-stream")
        headers["Connection"] = "keep-alive" if keep else "close"
        head = [f"HTTP/1.1 {resp.status} {HTTPStatus(resp.status).phrase}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        if req.method == "HEAD":
            await with_timeout("api.http.write", writer.drain())
            return
        if resp.stream is None:
            writer.write(resp.body if not chunked else
                         (f"{len(resp.body):x}\r\n".encode() + resp.body + b"\r\n"
                          if resp.body else b"") + b"0\r\n\r\n")
            await with_timeout("api.http.write", writer.drain())
            return
        try:
            async for chunk in resp.stream:
                writer.write(chunk)
                await with_timeout("api.http.write", writer.drain())
        finally:
            await resp.stream.aclose()

    @staticmethod
    async def _upgrade(req: Request, up: Upgrade, reader, writer) -> None:
        key = req.headers.get("Sec-WebSocket-Key")
        if key is None or (req.headers.get("Sec-WebSocket-Version") or "13") != "13":
            writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                         b"Connection: close\r\n\r\n")
            await with_timeout("api.http.write", writer.drain())
            return
        writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                      "Connection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {ws_accept(key)}\r\n\r\n").encode("latin-1"))
        await with_timeout("api.ws.prepare", writer.drain())
        ws = WebSocket(reader, writer)
        try:
            await up.run(ws)
        finally:
            await ws.close(CLOSE_GOING_AWAY)  # a no-op after a close handshake


def is_upgrade(req: Request) -> bool:
    return "websocket" in (req.headers.get("Upgrade") or "").lower() and \
        "upgrade" in (req.headers.get("Connection") or "").lower()
