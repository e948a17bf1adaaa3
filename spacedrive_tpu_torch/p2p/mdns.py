"""Standards-interoperable mDNS / DNS-SD discovery.

Port of ``spacedrive_tpu/p2p/mdns.py`` (stdlib only; upstream
crates/p2p/src/discovery/mdns.rs advertises ``_sd-spacedrive._udp``). The
signed UDP beacons (``p2p/discovery.py``) stay the authenticated default;
this adds a responder and browser on 224.0.0.251:5353 that any
``avahi-browse`` / ``dns-sd`` client can resolve. The wire format is
hand-rolled RFC 1035/6762/6763: header and compressed-name decoding
(encoding is compression-free, which is always legal), A / PTR / SRV /
TXT records. Records are unauthenticated hints: pairing verifies the
identity before any data flows. Where port 5353 is taken, ``start``
raises ``OSError`` and the p2p manager runs on beacons alone.

Service shape (RFC 6763):
  PTR  _spacedrive._udp.local            -> <inst>._spacedrive._udp.local
  SRV  <inst>._spacedrive._udp.local     -> <host>.local : service_port
  TXT  <inst>._spacedrive._udp.local     -> id=<hex peer id>, name=...
  A    <host>.local                      -> local address
"""

from __future__ import annotations

import asyncio
import socket
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import tasks

MDNS_GRP = "224.0.0.251"
MDNS_PORT = 5353
SERVICE = "_spacedrive._udp.local"
TTL = 120
ANNOUNCE_INTERVAL_S = 30.0
QUERY_INTERVAL_S = 15.0

TYPE_A = 1
TYPE_PTR = 12
TYPE_TXT = 16
TYPE_SRV = 33
CLASS_IN = 1
CACHE_FLUSH = 0x8001  # class IN + cache-flush bit on records we own


# -- DNS wire codec ---------------------------------------------------------

def encode_name(name: str) -> bytes:
    out = b""
    for label in name.strip(".").split("."):
        raw = label.encode()
        if not 0 < len(raw) < 64:
            raise ValueError(f"bad label {label!r}")
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def decode_name(buf: bytes, off: int) -> Tuple[str, int]:
    """Decodes a (possibly compression-pointer) name; returns
    (name, next offset). Guards pointer loops."""
    labels: List[str] = []
    jumps = 0
    end = None
    while True:
        if off >= len(buf):
            raise ValueError("truncated name")
        ln = buf[off]
        if ln == 0:
            off += 1
            break
        if ln & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(buf):
                raise ValueError("truncated pointer")
            ptr = ((ln & 0x3F) << 8) | buf[off + 1]
            if end is None:
                end = off + 2
            off = ptr
            jumps += 1
            if jumps > 32:
                raise ValueError("pointer loop")
            continue
        if ln & 0xC0:
            raise ValueError("bad label type")
        labels.append(buf[off + 1:off + 1 + ln].decode(errors="replace"))
        off += 1 + ln
    return ".".join(labels), (end if end is not None else off)


def _record(name: str, rtype: int, rdata: bytes,
            rclass: int = CACHE_FLUSH, ttl: int = TTL) -> bytes:
    return (encode_name(name) + struct.pack(">HHIH", rtype, rclass, ttl,
                                            len(rdata)) + rdata)


def txt_rdata(kv: Dict[str, str]) -> bytes:
    out = b""
    for k, v in kv.items():
        pair = f"{k}={v}".encode()[:255]
        out += bytes([len(pair)]) + pair
    return out or b"\x00"


def parse_txt(rdata: bytes) -> Dict[str, str]:
    out: Dict[str, str] = {}
    off = 0
    while off < len(rdata):
        ln = rdata[off]
        body = rdata[off + 1:off + 1 + ln]
        off += 1 + ln
        if b"=" in body:
            k, _, v = body.partition(b"=")
            out[k.decode(errors="replace")] = v.decode(errors="replace")
    return out


def parse_packet(buf: bytes):
    """-> (is_response, questions [(name, type)], answers
    [(name, type, ttl, rdata, full_buf, rdata_off)]) — rdata offsets
    kept so SRV/PTR targets can chase compression pointers."""
    if len(buf) < 12:
        raise ValueError("short packet")
    (_tid, flags, qd, an, ns, ar) = struct.unpack(">HHHHHH", buf[:12])
    off = 12
    questions = []
    for _ in range(qd):
        name, off = decode_name(buf, off)
        qtype, _qclass = struct.unpack(">HH", buf[off:off + 4])
        off += 4
        questions.append((name, qtype))
    answers = []
    for _ in range(an + ns + ar):
        name, off = decode_name(buf, off)
        rtype, _rclass, ttl, rdlen = struct.unpack(">HHIH",
                                                   buf[off:off + 10])
        off += 10
        answers.append((name, rtype, ttl, buf[off:off + rdlen], buf, off))
        off += rdlen
    return bool(flags & 0x8000), questions, answers


# -- service ---------------------------------------------------------------

class MdnsPeer:
    def __init__(self, instance: str, addr: str, port: int,
                 txt: Dict[str, str]):
        self.instance = instance
        self.addr = addr
        self.port = port
        self.txt = txt
        self.last_seen = time.monotonic()

    def __repr__(self) -> str:
        return f"MdnsPeer({self.instance!r} @ {self.addr}:{self.port})"


class MdnsService:
    """mDNS responder + browser for the spacedrive service type."""

    def __init__(self, instance: str, service_port: int,
                 txt: Optional[Dict[str, str]] = None,
                 group: str = MDNS_GRP, port: int = MDNS_PORT,
                 owner: str = "p2p/mdns"):
        self._owner = owner
        # instance/host labels must be DNS-safe
        safe = "".join(c if c.isalnum() or c == "-" else "-"
                       for c in instance)[:32] or "node"
        self.instance = f"{safe}.{SERVICE}"
        self.host = f"{safe}.local"
        self.service_port = service_port
        self.txt = dict(txt or {})
        self.group = group
        self.port = port
        self.peers: Dict[str, MdnsPeer] = {}
        self.on_discovered: Optional[Callable[[MdnsPeer], None]] = None
        self._transport = None
        self._tasks: list = []
        # SRV/TXT arrive in separate packets from some stacks: hold
        # partial info until both halves exist.
        self._partial: Dict[str, dict] = {}

    # -- record building --

    def _local_ip(self) -> str:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((self.group, self.port))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def _announcement(self, ttl: int = TTL) -> bytes:
        ip = self._local_ip()
        answers = [
            _record(SERVICE, TYPE_PTR, encode_name(self.instance),
                    rclass=CLASS_IN, ttl=ttl),  # shared record: no flush
            _record(self.instance, TYPE_SRV,
                    struct.pack(">HHH", 0, 0, self.service_port)
                    + encode_name(self.host), ttl=ttl),
            _record(self.instance, TYPE_TXT, txt_rdata(self.txt),
                    ttl=ttl),
            _record(self.host, TYPE_A, socket.inet_aton(ip), ttl=ttl),
        ]
        header = struct.pack(">HHHHHH", 0, 0x8400, 0, len(answers), 0, 0)
        return header + b"".join(answers)

    def _query(self) -> bytes:
        q = encode_name(SERVICE) + struct.pack(">HH", TYPE_PTR, CLASS_IN)
        return struct.pack(">HHHHHH", 0, 0, 1, 0, 0, 0) + q

    # -- lifecycle --

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                             socket.IPPROTO_UDP)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except (AttributeError, OSError):
                pass
            sock.bind(("", self.port))
            mreq = struct.pack("4sl", socket.inet_aton(self.group),
                               socket.INADDR_ANY)
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                            mreq)
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
            sock.setblocking(False)
        except OSError:
            sock.close()  # 5353 taken / membership denied: no fd leak
            raise

        svc = self

        class Proto(asyncio.DatagramProtocol):
            def datagram_received(proto_self, data, addr):
                svc._on_datagram(data, addr)

        self._transport, _ = await loop.create_datagram_endpoint(
            Proto, sock=sock)
        self._tasks = [
            tasks.spawn("announce", self._announce_loop(),
                        owner=self._owner),
            tasks.spawn("query", self._query_loop(), owner=self._owner),
            tasks.spawn("expire", self._expire_loop(), owner=self._owner),
        ]

    async def stop(self) -> None:
        # goodbye packet: TTL 0 clears remote caches (RFC 6762 §10.1)
        if self._transport is not None:
            try:
                self._transport.sendto(self._announcement(ttl=0),
                                       (self.group, self.port))
            except Exception:
                pass
        await tasks.cancel_and_gather(*self._tasks)
        self._tasks = []
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    # -- protocol --

    def _on_datagram(self, data: bytes, addr) -> None:
        try:
            is_resp, questions, answers = parse_packet(data)
        except Exception:
            return
        if not is_resp:
            # respond to PTR queries for our service type (and direct
            # SRV/TXT questions for our instance)
            for name, qtype in questions:
                if (name.lower() == SERVICE and qtype == TYPE_PTR) or \
                        name.lower() == self.instance.lower():
                    self._transport.sendto(self._announcement(),
                                           (self.group, self.port))
                    break
            return
        self._ingest_answers(answers, addr)

    MAX_PARTIAL = 512  # hostile-LAN bound on half-resolved entries

    def _ingest_answers(self, answers, addr) -> None:
        touched = set()

        def partial(lname: str, name: str) -> Optional[dict]:
            p = self._partial.get(lname)
            if p is None:
                if len(self._partial) >= self.MAX_PARTIAL:
                    return None  # bound the table on a hostile LAN
                p = self._partial[lname] = {"inst": name}
            # address follows the answering packet for THIS entry only
            p["addr"] = addr[0]
            touched.add(lname)
            return p

        for name, rtype, ttl, rdata, buf, roff in answers:
            lname = name.lower()
            if rtype == TYPE_PTR and lname == SERVICE:
                try:
                    inst, _ = decode_name(buf, roff)
                except ValueError:
                    continue
                if inst.lower() == self.instance.lower():
                    continue  # ourselves
                partial(inst.lower(), inst)
            elif rtype == TYPE_SRV:
                if lname == self.instance.lower():
                    continue
                try:
                    port = struct.unpack(">H", rdata[4:6])[0]
                except struct.error:
                    continue
                if ttl == 0:
                    self.peers.pop(lname, None)
                    self._partial.pop(lname, None)
                    touched.discard(lname)
                    continue
                p = partial(lname, name)
                if p is not None:
                    p["port"] = port
            elif rtype == TYPE_TXT:
                if lname == self.instance.lower():
                    continue
                p = partial(lname, name)
                if p is not None:
                    p["txt"] = parse_txt(rdata)
        # Graduate ONLY entries this packet touched — re-graduating the
        # whole table stamped every known peer with THIS packet's
        # source address. Partial state stays
        # until SRV+TXT both arrive; complete entries are dropped from
        # the table once peers holds them.
        for key in touched:
            p = self._partial.get(key)
            if not p or "port" not in p or not key.endswith(SERVICE):
                continue
            peer = MdnsPeer(p["inst"], p.get("addr", addr[0]),
                            p["port"], p.get("txt", {}))
            is_new = key not in self.peers
            self.peers[key] = peer
            if "txt" in p:
                self._partial.pop(key, None)
            if is_new and self.on_discovered:
                self.on_discovered(peer)

    async def _announce_loop(self) -> None:
        # RFC 6762 §8.3: a couple of quick startup announcements, then
        # periodic refresh well inside TTL
        for delay in (0.1, 1.0):
            await asyncio.sleep(delay)
            self._transport.sendto(self._announcement(),
                                   (self.group, self.port))
        while True:
            await asyncio.sleep(ANNOUNCE_INTERVAL_S)
            self._transport.sendto(self._announcement(),
                                   (self.group, self.port))

    async def _query_loop(self) -> None:
        while True:
            self._transport.sendto(self._query(), (self.group, self.port))
            await asyncio.sleep(QUERY_INTERVAL_S)

    async def _expire_loop(self) -> None:
        while True:
            await asyncio.sleep(TTL / 2)
            now = time.monotonic()
            for key in [k for k, p in self.peers.items()
                        if now - p.last_seen > TTL]:
                self.peers.pop(key, None)
