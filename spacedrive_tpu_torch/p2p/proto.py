"""Wire framing and the authenticated, encrypted tunnel.

Port of ``spacedrive_tpu/p2p/proto.py`` (the roles of upstream
crates/p2p/src/proto.rs and spacetunnel/tunnel.rs): frames are
u32-length-prefixed msgpack values; the tunnel runs a signed ephemeral
X25519 exchange (each side signs its ephemeral key and a nonce with its
Ed25519 identity), derives one ChaCha20-Poly1305 key per direction with
HKDF-SHA256 over the sorted nonces, and seals every frame with a 12-byte
big-endian counter nonce. For the same keys and nonces the bytes on the
socket are the JAX package's, so a JAX node and a port node speak to
each other. The primitives are the port's own (``p2p/_crypto.py``).

The budgets live at the call sites: ``read_frame``, ``send`` and
``recv`` are what every ``with_timeout`` wraps; the handshake owns its
``p2p.handshake`` deadline.
"""

from __future__ import annotations

import asyncio
import os
import struct
from typing import Any, Optional, Tuple

from .. import _msgpack, channels, chaos
from ..telemetry import P2P_TUNNEL_BYTES_RECV, P2P_TUNNEL_BYTES_SENT
from ..timeouts import deadline
from . import _crypto, wire
from .identity import Identity, RemoteIdentity
from .wire import MAX_FRAME, audit_frame

# Bytes this process sealed and opened on its tunnels (ciphertext, length
# prefixes excluded), and tunnels opened.
stats = {"tunnels": 0, "bytes_sent": 0, "bytes_recv": 0}


class ProtoError(Exception):
    pass


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await reader.readexactly(4)
    (length,) = struct.unpack(">I", hdr)
    if length > MAX_FRAME:
        raise ProtoError(f"frame too large: {length}")
    return await reader.readexactly(length)


def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(struct.pack(">I", len(payload)) + payload)


async def read_msg(reader: asyncio.StreamReader) -> Any:
    return _msgpack.unpackb(await read_frame(reader))


def write_msg(writer: asyncio.StreamWriter, msg: Any) -> None:
    write_frame(writer, _msgpack.packb(msg))


class Tunnel:
    """Encrypted, identity-authenticated frame stream over TCP."""

    def __init__(self, reader, writer, send_key: bytes, recv_key: bytes,
                 remote: RemoteIdentity):
        self.reader = reader
        self.writer = writer
        self.remote = remote
        self._send = _crypto.ChaCha20Poly1305(send_key)
        self._recv = _crypto.ChaCha20Poly1305(recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0
        # frames sealed by send_nowait and not yet drained
        self._frames = channels.window("p2p.tunnel.frames")
        stats["tunnels"] += 1

    @staticmethod
    def _nonce(counter: int) -> bytes:
        return counter.to_bytes(12, "big")

    def _seal(self, plain: bytes, tamper: bool = False) -> bytes:
        """Encrypt, frame and count. `tamper` (the chaos `corrupt` fault
        only) flips one ciphertext bit after sealing, so the peer's AEAD
        open fails loudly."""
        sealed = self._send.encrypt(self._nonce(self._send_ctr), plain, None)
        self._send_ctr += 1
        if tamper:
            sealed = bytes([sealed[0] ^ 0x01]) + sealed[1:]
        stats["bytes_sent"] += len(sealed)
        P2P_TUNNEL_BYTES_SENT.inc(len(sealed))
        write_frame(self.writer, sealed)
        return sealed

    def _open(self, sealed: bytes) -> bytes:
        stats["bytes_recv"] += len(sealed)
        P2P_TUNNEL_BYTES_RECV.inc(len(sealed))
        plain = self._recv.decrypt(self._nonce(self._recv_ctr), sealed, None)
        self._recv_ctr += 1
        return plain

    async def send(self, msg: Any) -> None:
        # Chaos seam (send half): drop = the frame is lost on the wire
        # (never sealed; the peer's receive budget notices); corrupt =
        # sealed, then tampered (the peer's AEAD open fails).
        f = chaos.hit("p2p.tunnel.frame")
        if f is not None and await chaos.apply_async(f):
            return  # dropped
        payload = _msgpack.packb(msg)
        audit_frame(msg, "out", len(payload))
        self._seal(payload, tamper=f is not None and f.kind == "corrupt")
        await self.writer.drain()
        self._frames.note_drain()

    async def recv(self) -> Any:
        # Chaos seam (receive half): delay, wedge and disconnect only
        # (dropping a received frame would desync the counter nonce).
        f = chaos.hit("p2p.tunnel.frame", only=("delay", "disconnect", "wedge"))
        if f is not None:
            await chaos.apply_async(f)
        plain = self._open(await read_frame(self.reader))
        msg = _msgpack.unpackb(plain)
        audit_frame(msg, "in", len(plain))
        return msg

    def send_nowait(self, msg: Any) -> None:
        """Seal and queue a frame without awaiting the socket: the clone
        stream queues a window of pages, then drains once. Frames are
        sealed in call order, so the counter nonces stay in step."""
        payload = _msgpack.packb(msg)
        audit_frame(msg, "out", len(payload))
        self._seal(payload)
        self._frames.note_put()

    async def drain(self) -> None:
        await self.writer.drain()
        self._frames.note_drain()

    async def send_raw(self, data: bytes) -> None:
        audit_frame(data, "out", len(data))
        self._seal(data)
        await self.writer.drain()
        self._frames.note_drain()

    async def recv_raw(self) -> bytes:
        plain = self._open(await read_frame(self.reader))
        audit_frame(plain, "in", len(plain))
        return plain

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


def _derive_keys(shared: bytes, salt: bytes) -> Tuple[bytes, bytes]:
    okm = _crypto.hkdf_sha256(shared, salt, b"spacedrive-tpu-tunnel-v1", 64)
    return okm[:32], okm[32:]


async def tunnel_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    identity: Identity,
    initiator: bool,
    expected: Optional[RemoteIdentity] = None,
) -> Tunnel:
    """Authenticated key exchange → Tunnel. Each side sends
    (identity_pub, ephemeral_pub, nonce, sig(ephemeral_pub ‖ nonce)) and
    verifies the peer's signature before any key is derived."""
    eph = os.urandom(32)
    eph_pub = _crypto.x25519_public(eph)
    my_pub = identity.to_remote_identity().to_bytes()
    nonce = os.urandom(16)
    write_msg(writer, wire.pack("p2p.handshake.hello", identity=my_pub,
                                ephemeral=eph_pub, nonce=nonce,
                                sig=identity.sign(eph_pub + nonce)))
    async with deadline("p2p.handshake"):
        await writer.drain()
        # the peer is unauthenticated until the signature check below
        hello = wire.unpack("p2p.handshake.hello", await read_msg(reader))
    try:
        remote = RemoteIdentity(hello["identity"])
    except ValueError as e:
        raise ProtoError(f"peer identity malformed: {e}") from None
    if expected is not None and remote != expected:
        raise ProtoError("peer identity mismatch")
    if not remote.verify(hello["sig"], hello["ephemeral"] + hello["nonce"]):
        raise ProtoError("peer handshake signature invalid")
    if len(hello["ephemeral"]) != 32:
        raise ProtoError("peer ephemeral key is not 32 bytes")
    shared = _crypto.x25519_shared(eph, hello["ephemeral"])
    # both sides derive the same salt; the key order flips by role
    lo, hi = sorted([nonce, hello["nonce"]])
    k1, k2 = _derive_keys(shared, lo + hi)
    send_key, recv_key = (k1, k2) if initiator else (k2, k1)
    return Tunnel(reader, writer, send_key, recv_key, remote)
