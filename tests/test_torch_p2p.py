"""The slice as a whole: two port nodes, and a JAX node with a port node,
over loopback TCP through the encrypted tunnel.

- pairing then sync, the backfill clone of a library with blob pages
  (the pass-through and, with it switched off, the per-op pull loop),
  relation ops, spacedrop accepted and rejected, ``request_file``, and an
  obs header closed unanswered;
- a JAX node and a port node paired in one process, writing on both
  sides: their libraries converge (one protocol: tunnel, codec, apply);
- a location identified by a port node (``device="cpu"``) and cloned
  into a second port node, whose tables equal those a JAX
  ``SyncManager`` builds from the same pages;
- the tunnel's frames, the discovery beacons and the mDNS packets are the
  JAX package's bytes.

Every wait has a deadline; no sleep is longer than 0.05 s."""

import asyncio
import os
import socket
import struct
import time

import numpy as np
import pytest

from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.p2p import discovery as jax_discovery
from spacedrive_tpu.p2p import identity as jax_identity
from spacedrive_tpu.p2p import mdns as jax_mdns
from spacedrive_tpu.p2p import proto as jax_proto
from spacedrive_tpu.store import db as jax_db
from spacedrive_tpu.sync import crdt as jax_crdt
from spacedrive_tpu.sync import manager as jax_manager
from spacedrive_tpu_torch.jobs.report import JobStatus
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.p2p import discovery, identity, mdns, proto, wire
from spacedrive_tpu_torch.sync import clone_serve
from spacedrive_tpu_torch.sync.manager import GetOpsArgs

DEADLINE_S = 20.0


def _run(coro):
    return asyncio.run(coro)


async def until(cond, what: str, deadline_s: float = DEADLINE_S):
    end = time.monotonic() + deadline_s
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < end, f"{what}: not within {deadline_s} s"
        await asyncio.sleep(0.05)


async def _started(*nodes):
    ports = []
    for n in nodes:
        await n.start()
        ports.append(await n.start_p2p(host="127.0.0.1", enable_discovery=False))
    return ports


async def _pair(a, b, lib_a, pb):
    b.p2p.on_pairing_request = lambda peer, info: True
    assert await a.p2p.pair("127.0.0.1", pb, lib_a)
    return await until(lambda: b.libraries.get(lib_a.id), "B's library")


def _write_tag(lib, name: str) -> bytes:
    pub = os.urandom(16)
    with lib.sync.write_ops(lib.sync.shared_create("tag", pub, {"name": name})) as conn:
        conn.execute("INSERT INTO tag (pub_id, name) VALUES (?, ?)", (pub, name))
    return pub


def _synced(db, table: str) -> list:
    """Rows as sync carries them: FKs as pub_ids, no local ids or owner."""
    cols = [r["name"] for r in db.query(f"PRAGMA table_info({table})")]
    fks = {r["from"]: r["table"] for r in db.query(f"PRAGMA foreign_key_list({table})")}
    sel = []
    for c in cols:
        if c in ("id", "instance_id", "inode"):
            continue
        if c in fks and fks[c] in ("object", "location", "tag", "file_path"):
            sel.append(f"(SELECT pub_id FROM {fks[c]} WHERE id = t.{c})")
        else:
            sel.append(f"t.{c}")
    return sorted(tuple(r) for r in db.query(f"SELECT {', '.join(sel)} FROM {table} t"))


def _op_count(db) -> int:
    return sum(db.query_one(q)[0] for q in (
        "SELECT COUNT(*) FROM shared_operation", "SELECT COUNT(*) FROM relation_operation",
        "SELECT COALESCE(SUM(n_ops), 0) FROM shared_op_blob"))


@pytest.fixture
def nodes(tmp_path):
    made = []

    def make(name):
        n = Node(str(tmp_path / name), device="cpu")
        made.append(n)
        return n
    return make


def test_pair_then_sync_and_the_op_logs_converge(nodes):
    a, b = nodes("a"), nodes("b")

    async def main():
        _, pb = await _started(a, b)
        try:
            lib_a = a.create_library("shared")
            lib_b = await _pair(a, b, lib_a, pb)
            assert lib_b.config.name == "shared"
            pub = _write_tag(lib_a, "from-a")
            row = await until(lambda: lib_b.db.query_one(
                "SELECT name FROM tag WHERE pub_id = ?", (pub,)), "the tag on B")
            assert row["name"] == "from-a"
            pub_b = _write_tag(lib_b, "from-b")
            await until(lambda: lib_a.db.query_one(
                "SELECT 1 FROM tag WHERE pub_id = ?", (pub_b,)), "B's tag on A")
            await until(lambda: _op_count(lib_a.db) == _op_count(lib_b.db) == 2, "op logs")
            assert _synced(lib_a.db, "tag") == _synced(lib_b.db, "tag")
            assert await a.p2p.ping("127.0.0.1", pb) < 5
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def _bulk_library(lib, n: int = 600) -> None:
    """A solo library's bulk writes: blob pages of object creates and
    file_path creates with an FK, a row op between them."""
    sync = lib.sync
    opubs = [os.urandom(16) for _ in range(n)]
    fpubs = [os.urandom(16) for _ in range(n)]
    with lib.db.write_tx() as conn:
        sync.bulk_shared_ops(conn, "object", [(p, "c", None, None, {"kind": 5})
                                              for p in opubs])
        conn.executemany("INSERT INTO object (pub_id, kind) VALUES (?, 5)",
                         [(p,) for p in opubs])
    _write_tag(lib, "between")
    with lib.db.write_tx() as conn:
        sync.bulk_shared_ops(conn, "file_path", [
            (fp, "c", None, None, {"name": f"f{i}", "materialized_path": "/", "is_dir": 0,
                                   "object_id": op})
            for i, (fp, op) in enumerate(zip(fpubs, opubs))])
        conn.executemany(
            "INSERT INTO file_path (pub_id, name, materialized_path, is_dir, object_id) "
            "VALUES (?, ?, '/', 0, (SELECT id FROM object WHERE pub_id = ?))",
            [(fp, f"f{i}", op) for i, (fp, op) in enumerate(zip(fpubs, opubs))])


@pytest.mark.parametrize("passthrough", ["on", "off"])
def test_backfill_clone_of_a_blob_library(nodes, monkeypatch, passthrough):
    monkeypatch.setenv("SDTPU_CLONE_PASSTHROUGH", passthrough)
    a, b = nodes("a"), nodes("b")

    async def main():
        _, pb = await _started(a, b)
        try:
            lib_a = a.create_library("bulk")
            _bulk_library(lib_a)
            assert lib_a.db.query_one("SELECT COUNT(*) FROM shared_op_blob")[0] == 2
            pages0 = clone_serve.pages_relayed[0]
            lib_b = await _pair(a, b, lib_a, pb)
            await until(lambda: _op_count(lib_b.db) == _op_count(lib_a.db), "the clone")
            for table in ("object", "file_path", "tag"):
                assert _synced(lib_b.db, table) == _synced(lib_a.db, table)
            relayed = clone_serve.pages_relayed[0] - pages0
            assert relayed == (2 if passthrough == "on" else 0)
            # the peer's watermark for A is durable: a re-announce moves nothing
            a.p2p.networked.originate_soon(lib_a)
            await asyncio.sleep(0.05)
            assert _op_count(lib_b.db) == _op_count(lib_a.db)
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def test_relation_ops_sync_over_the_network(nodes):
    a, b = nodes("a"), nodes("b")

    async def main():
        _, pb = await _started(a, b)
        try:
            lib_a = a.create_library("rel")
            lib_b = await _pair(a, b, lib_a, pb)
            sa = lib_a.sync
            tag, obj = os.urandom(16), os.urandom(16)
            ops = sa.shared_create("tag", tag, {"name": "red"}) + \
                sa.shared_create("object", obj, {"kind": 5})
            with sa.write_ops(ops) as conn:
                conn.execute("INSERT INTO tag (pub_id, name) VALUES (?, 'red')", (tag,))
                conn.execute("INSERT INTO object (pub_id, kind) VALUES (?, 5)", (obj,))
            ta = lib_a.db.query_one("SELECT id FROM tag WHERE pub_id = ?", (tag,))[0]
            oa = lib_a.db.query_one("SELECT id FROM object WHERE pub_id = ?", (obj,))[0]
            with sa.write_ops(sa.relation_create("tag_on_object", obj, tag)) as conn:
                conn.execute("INSERT INTO tag_on_object (tag_id, object_id) VALUES (?, ?)",
                             (ta, oa))
            q = ("SELECT t.name FROM tag_on_object x JOIN tag t ON t.id = x.tag_id "
                 "JOIN object o ON o.id = x.object_id WHERE o.pub_id = ?")
            row = await until(lambda: lib_b.db.query_one(q, (obj,)), "the link on B")
            assert row["name"] == "red"
            with sa.write_ops([sa.relation_delete("tag_on_object", obj, tag)]) as conn:
                conn.execute("DELETE FROM tag_on_object WHERE tag_id = ? AND object_id = ?",
                             (ta, oa))
            await until(lambda: lib_b.db.query_one(q, (obj,)) is None, "the unlink on B")
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


@pytest.mark.parametrize("verdict", ["accept", "reject"])
def test_spacedrop_interactive(nodes, tmp_path, verdict):
    a, b = nodes("a"), nodes("b")
    payload = os.urandom(300_000)
    src = tmp_path / "gift.bin"
    src.write_bytes(payload)
    dst = tmp_path / "received.bin"

    async def main():
        _, pb = await _started(a, b)
        try:
            b.p2p.interactive_spacedrop = True
            offers, progress = [], []

            def on_event(e):
                if e.get("type") == "SpacedropRequest":
                    offers.append(e)
                    if verdict == "accept":
                        b.p2p.accept_spacedrop(e["id"], str(dst))
                    else:
                        b.p2p.reject_spacedrop(e["id"])
                elif e.get("type") == "SpacedropProgress":
                    progress.append(e)
            b.events.subscribe(on_event)
            result = await a.p2p.spacedrop("127.0.0.1", pb, str(src))
            assert offers and offers[0]["name"] == "gift.bin"
            assert offers[0]["size"] == len(payload)
            if verdict == "accept":
                assert result == "sent"
                assert dst.read_bytes() == payload
                assert progress[-1]["bytes"] == len(payload)
            else:
                assert result == "rejected" and not dst.exists()
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def test_request_file_serves_a_row_by_its_pub_ids(nodes, tmp_path):
    a, b = nodes("a"), nodes("b")
    root = tmp_path / "loc"
    root.mkdir()
    payload = os.urandom(200_000)
    (root / "shared.bin").write_bytes(payload)

    async def main():
        pa, pb = await _started(a, b)
        try:
            lib_a = a.create_library("files")
            loc = locations.create_location(lib_a, str(root))
            await locations.scan_location(a.jobs, lib_a, loc, backend=a.backend,
                                          with_media=False)
            await a.jobs.wait_idle()
            lib_b = await _pair(a, b, lib_a, pb)
            row = await until(lambda: lib_b.db.query_one(
                "SELECT fp.pub_id, l.pub_id AS loc FROM file_path fp JOIN location l "
                "ON l.id = fp.location_id WHERE fp.name = 'shared'"), "the row on B")
            out = tmp_path / "fetched.bin"
            assert await b.p2p.request_file("127.0.0.1", pa, str(lib_b.id), row["loc"],
                                            row["pub_id"], str(out))
            assert out.read_bytes() == payload
            part = tmp_path / "part.bin"
            assert await b.p2p.request_file("127.0.0.1", pa, str(lib_b.id), row["loc"],
                                            row["pub_id"], str(part), 1000, 5000)
            assert part.read_bytes() == payload[1000:5000]
            assert not await b.p2p.request_file("127.0.0.1", pa, str(lib_b.id), row["loc"],
                                                os.urandom(16), str(tmp_path / "no.bin"))
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def test_an_obs_header_is_closed_unanswered(nodes):
    a, b = nodes("a"), nodes("b")

    async def main():
        _, pb = await _started(a, b)
        try:
            errors = []
            b.events.subscribe(lambda e: e.get("type") == "P2PError" and errors.append(e))
            tunnel = await a.p2p.open_stream("127.0.0.1", pb)
            try:
                await tunnel.send(wire.pack("obs.health"))
                with pytest.raises((asyncio.IncompleteReadError, ConnectionError)):
                    await asyncio.wait_for(tunnel.recv(), DEADLINE_S)
            finally:
                tunnel.close()
            assert errors == []
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def test_a_jax_node_and_a_port_node_sync_both_ways(tmp_path):
    j = JaxNode(str(tmp_path / "jax"))
    p = Node(str(tmp_path / "port"), device="cpu")

    async def main():
        await j.start()
        pj = await j.start_p2p(host="127.0.0.1", enable_discovery=False)
        pp, = await _started(p)
        try:
            # the JAX node's library, with bulk pages, paired into the port node
            lib_j = j.create_library("cross")
            _bulk_library(lib_j, 300)
            p.p2p.on_pairing_request = lambda peer, info: True
            assert await j.p2p.pair("127.0.0.1", pp, lib_j)
            lib_p = await until(lambda: p.libraries.get(lib_j.id), "the port's library")
            await until(lambda: _op_count(lib_p.db) == _op_count(lib_j.db), "port clones JAX")
            # writes on both sides, each reaches the other
            tj, tp = _write_tag(lib_j, "from-jax"), _write_tag(lib_p, "from-port")
            obj = lib_p.db.query_one("SELECT pub_id FROM object LIMIT 1")[0]
            with lib_p.sync.write_ops([lib_p.sync.shared_update("object", obj, "note",
                                                                "port-edit")]) as conn:
                conn.execute("UPDATE object SET note = 'port-edit' WHERE pub_id = ?", (obj,))
            for lib, pub in ((lib_p, tj), (lib_j, tp)):
                await until(lambda lib=lib, pub=pub: lib.db.query_one(
                    "SELECT 1 FROM tag WHERE pub_id = ?", (pub,)), "a tag across")
            await until(lambda: lib_j.db.query_one(
                "SELECT note FROM object WHERE pub_id = ?", (obj,))[0] == "port-edit",
                "the port's edit on the JAX node")
            await until(lambda: all(_synced(lib_j.db, t) == _synced(lib_p.db, t)
                                    for t in ("tag", "object", "file_path")), "convergence")
            # the port node pairs its own library into the JAX node
            lib_p2 = p.create_library("port-origin")
            _write_tag(lib_p2, "port-first")
            j.p2p.on_pairing_request = lambda peer, info: True
            assert await p.p2p.pair("127.0.0.1", pj, lib_p2)
            lib_j2 = await until(lambda: j.libraries.get(lib_p2.id), "the JAX library")
            await until(lambda: _synced(lib_j2.db, "tag") == _synced(lib_p2.db, "tag"),
                        "JAX clones the port")
        finally:
            await j.shutdown()
            await p.shutdown()
    _run(main())


def test_a_location_identified_by_a_port_node_clones_as_jax_applies_it(nodes, tmp_path):
    a, b = nodes("a"), nodes("b")
    root = tmp_path / "loc"
    (root / "sub").mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(300):
        d = root / "sub" if i % 3 else root
        (d / f"f{i:03d}.bin").write_bytes(rng.integers(0, 256, 100 + 37 * i, np.uint8).tobytes())
    (root / "dup.bin").write_bytes((root / "f000.bin").read_bytes())

    async def main():
        _, pb = await _started(a, b)
        try:
            lib_a = a.create_library("identified")
            loc = locations.create_location(lib_a, str(root))
            await locations.scan_location(a.jobs, lib_a, loc, backend=a.backend,
                                          with_media=False)
            await a.jobs.wait_idle()
            assert {r["status"] for r in lib_a.db.query("SELECT status FROM job")} == \
                {int(JobStatus.COMPLETED)}
            assert lib_a.db.query_one("SELECT COUNT(*) FROM shared_op_blob")[0] > 0
            # the same pages into a JAX manager on a fresh library file
            jdb = jax_db.Database(str(tmp_path / "jax-peer.db"))
            jdb.insert("instance", {"pub_id": b"J" * 16, "identity": b"", "node_id": b"",
                                    "node_name": "j", "node_platform": 0, "last_seen": 0,
                                    "date_created": 0})
            jm = jax_manager.SyncManager(jdb, b"J" * 16)
            jm.register_instance(lib_a.sync.instance)
            for kind, item in lib_a.sync.iter_clone_stream([]):
                if kind == "page":
                    jm.receive_blob_pages([item])
                else:
                    jm.receive_crdt_operations([jax_crdt.CRDTOperation.from_wire(o.to_wire())
                                                for o in item])
            while True:
                clocks = [(b"J" * 16, jm.clock.last)] + list(jm.timestamps.items())
                page = lib_a.sync.get_ops(GetOpsArgs(clocks=clocks, count=1000))
                if not page:
                    break
                jm.receive_crdt_operations([jax_crdt.CRDTOperation.from_wire(o.to_wire())
                                            for o in page])
            # and over the network into the port node B
            lib_b = await _pair(a, b, lib_a, pb)
            await until(lambda: _op_count(lib_b.db) == _op_count(lib_a.db), "the clone")
            for table in ("file_path", "object", "location"):
                want = _synced(lib_a.db, table)
                assert _synced(lib_b.db, table) == want
                assert _synced(jdb, table) == want
            jdb.close()
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


class _Writer:
    """A StreamWriter stand-in that keeps what the tunnel writes."""

    def __init__(self):
        self.out = bytearray()

    def write(self, data):
        self.out += data

    async def drain(self):
        pass

    def close(self):
        pass


def test_tunnel_frames_are_the_jax_packages_bytes():
    send_key, recv_key = bytes(range(32)), bytes(range(32, 64))
    remote = identity.Identity(b"\x01" * 32).to_remote_identity()
    jremote = jax_identity.RemoteIdentity(remote.to_bytes())
    frames = [wire.pack("p2p.ping"),
              wire.pack("clone.page", model="object", instance=b"i" * 16, min_ts=1,
                        max_ts=2, n_ops=1, data=os.urandom(5000)),
              wire.pack("sync.pull.page", ops=[{"a": 1, 2: b"x"}], has_more=False)]

    async def main():
        wp, wj = _Writer(), _Writer()
        tp = proto.Tunnel(None, wp, send_key, recv_key, remote)
        tj = jax_proto.Tunnel(None, wj, send_key, recv_key, jremote)
        for f in frames:
            await tp.send(f)
            await tj.send(f)
        await tp.send_raw(b"raw block")
        await tj.send_raw(b"raw block")
        assert bytes(wp.out) == bytes(wj.out)
        # and the port opens what the JAX package sealed
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(wj.out))
        rt = proto.Tunnel(reader, _Writer(), recv_key, send_key, remote)
        assert [await rt.recv() for _ in frames] == frames
        assert await rt.recv_raw() == b"raw block"
    _run(main())


def test_handshake_across_packages_over_a_socket_pair():
    async def main():
        s1, s2 = socket.socketpair()
        r1, w1 = await asyncio.open_connection(sock=s1)
        r2, w2 = await asyncio.open_connection(sock=s2)
        port_id, jax_id = identity.Identity(), jax_identity.Identity()
        tp, tj = await asyncio.gather(
            proto.tunnel_handshake(r1, w1, port_id, True),
            jax_proto.tunnel_handshake(r2, w2, jax_id, False))
        assert tp.remote.to_bytes() == jax_id.to_remote_identity().to_bytes()
        await tp.send(wire.pack("p2p.ping"))
        assert await tj.recv() == {"t": "ping"}
        await tj.send_raw(b"from jax")
        assert await tp.recv_raw() == b"from jax"
        tp.close()
        tj.close()
    _run(main())


def test_handshake_refuses_an_unexpected_peer():
    async def main():
        s1, s2 = socket.socketpair()
        r1, w1 = await asyncio.open_connection(sock=s1)
        r2, w2 = await asyncio.open_connection(sock=s2)
        other = identity.Identity().to_remote_identity()
        results = await asyncio.gather(
            proto.tunnel_handshake(r1, w1, identity.Identity(), True, expected=other),
            proto.tunnel_handshake(r2, w2, identity.Identity(), False),
            return_exceptions=True)
        assert isinstance(results[0], proto.ProtoError)
        w1.close()
        w2.close()
    _run(main())


def test_discovery_beacons_cross_packages():
    ip, jid = identity.Identity(), jax_identity.Identity()
    port_disc = discovery.Discovery(ip, 4242, metadata={"name": "port"})
    jax_disc = jax_discovery.Discovery(jid, 4343, metadata={"name": "jax"})
    jax_disc._on_datagram(port_disc._beacon(), ("10.0.0.2", 41420))
    port_disc._on_datagram(jax_disc._beacon(), ("10.0.0.3", 41420))
    [pj] = jax_disc.peers.values()
    [pp] = port_disc.peers.values()
    assert (pj.port, pj.addr, pj.metadata) == (4242, "10.0.0.2", {"name": "port"})
    assert (pp.port, pp.addr, pp.metadata) == (4343, "10.0.0.3", {"name": "jax"})
    # a forged signature and our own beacon are ignored
    forged = bytearray(port_disc._beacon())
    forged[-5] ^= 1
    before = dict(jax_disc.peers)
    jax_disc._on_datagram(bytes(forged), ("10.0.0.9", 41420))
    port_disc._on_datagram(port_disc._beacon(), ("10.0.0.9", 41420))
    assert jax_disc.peers == before and len(port_disc.peers) == 1


def test_mdns_packets_are_the_jax_packages(monkeypatch):
    kw = dict(instance="abc123def456", service_port=5151,
              txt={"name": "n", "id": "ff" * 8, "identity": "ee" * 32})
    port_svc, jax_svc = mdns.MdnsService(**kw), jax_mdns.MdnsService(**kw)
    for svc in (port_svc, jax_svc):
        monkeypatch.setattr(svc, "_local_ip", lambda: "127.0.0.1")
    for ttl in (mdns.TTL, 0):
        pkt = port_svc._announcement(ttl)
        assert pkt == jax_svc._announcement(ttl)
        assert repr(mdns.parse_packet(pkt)) == repr(jax_mdns.parse_packet(pkt))
    assert port_svc._query() == jax_svc._query()
    seen = []
    other = mdns.MdnsService(instance="zzz", service_port=1)
    other.on_discovered = seen.append
    other._ingest_answers(mdns.parse_packet(port_svc._announcement())[2], ("127.0.0.5", 5353))
    assert [(p.port, p.txt["name"]) for p in seen] == [(5151, "n")]
    with pytest.raises(ValueError):
        mdns.parse_packet(b"\x00" * 5)
    assert mdns.encode_name("a.b") == b"\x01a\x01b\x00"
    assert struct.unpack(">H", port_svc._query()[4:6])[0] == 1


def test_a_spacedrop_the_receiver_cancels_stops_the_sender(nodes, tmp_path):
    a, b = nodes("a"), nodes("b")
    src = tmp_path / "big.bin"
    src.write_bytes(os.urandom(3 << 20))  # 24 blocks of 128 KiB
    dst = tmp_path / "partial.bin"

    async def main():
        _, pb = await _started(a, b)
        try:
            b.p2p.on_spacedrop = lambda peer, req: str(dst)
            b.events.subscribe(lambda e: e.get("type") == "SpacedropStarted"
                               and b.p2p.cancel_spacedrop(e["id"]))
            assert await a.p2p.spacedrop("127.0.0.1", pb, str(src)) == "cancelled"
            assert dst.stat().st_size < src.stat().st_size
        finally:
            await a.shutdown()
            await b.shutdown()
    _run(main())


def test_a_restarted_node_re_arms_its_paired_peers(nodes, tmp_path):
    """Paired instances persist with their identities; after a restart
    (discovery off) a route set for the peer's identity carries the sync."""
    a, b = nodes("a"), nodes("b")

    async def main():
        _, pb = await _started(a, b)
        lib_a = a.create_library("restart")
        lib_b = await _pair(a, b, lib_a, pb)
        await a.shutdown()
        a2 = Node(str(tmp_path / "a"), device="cpu")
        await a2.start()
        await a2.start_p2p(host="127.0.0.1", enable_discovery=False)
        try:
            lib_a2 = a2.libraries.get(lib_a.id)
            peers = a2.p2p.networked._instances[lib_a.id]
            assert list(peers) == [lib_b.sync.instance]
            a2.p2p.networked.set_route(peers[lib_b.sync.instance], "127.0.0.1", pb)
            pub = _write_tag(lib_a2, "after-restart")
            await until(lambda: lib_b.db.query_one(
                "SELECT 1 FROM tag WHERE pub_id = ?", (pub,)), "the tag on B")
        finally:
            await a2.shutdown()
            await b.shutdown()
    _run(main())


def test_a_traceparent_sent_by_either_node_is_the_receivers_trace(tmp_path):
    """A traced ping from each node lands in the other's p2p/ping span under
    the sender's trace id, parented on the sender's span; a pairing's sync
    stream puts the receiver's sync.pull span in the originator's
    sync.serve trace, both ways."""
    from spacedrive_tpu import tracing as jtracing
    from spacedrive_tpu_torch import tracing as ptracing

    j = JaxNode(str(tmp_path / "jax"))
    p = Node(str(tmp_path / "port"), device="cpu")

    async def main():
        await j.start()
        pj = await j.start_p2p(host="127.0.0.1", enable_discovery=False)
        pp, = await _started(p)
        try:
            for sender, stracing, receiver, rtracing, port in (
                    (j, jtracing, p, ptracing, pp), (p, ptracing, j, jtracing, pj)):
                with stracing.span("rpc/ping"):
                    trace = stracing.current_trace_id()
                    await sender.p2p.ping("127.0.0.1", port)
                [mine] = [s for s in stracing.recent_spans(limit=50, trace_id=trace)
                          if s["span"] == "p2p/ping"]
                got = await until(lambda: [s for s in rtracing.recent_spans(
                    limit=200, trace_id=trace) if s["span"] == "p2p/ping"], "the remote span")
                assert got[0]["parent"] == mine["id"]
            lib_j = j.create_library("traced-j")
            _write_tag(lib_j, "j")
            lib_p = p.create_library("traced-p")
            _write_tag(lib_p, "p")
            p.p2p.on_pairing_request = lambda peer, info: True
            j.p2p.on_pairing_request = lambda peer, info: True
            assert await j.p2p.pair("127.0.0.1", pp, lib_j)
            assert await p.p2p.pair("127.0.0.1", pj, lib_p)
            for server, stracing, puller, rtracing, lib in (
                    (j, jtracing, p, ptracing, lib_j), (p, ptracing, j, jtracing, lib_p)):
                pulls = await until(lambda: [s for s in rtracing.recent_spans(limit=500)
                                             if s["span"] == "sync.pull"
                                             and s.get("library") == str(lib.id)],
                                    "the receiver's sync.pull span")
                serves = {s["trace"] for s in stracing.recent_spans(limit=500)
                          if s["span"] == "sync.serve" and s.get("library") == str(lib.id)}
                assert pulls[0]["trace"] in serves
        finally:
            await j.shutdown()
            await p.shutdown()
    _run(main())
