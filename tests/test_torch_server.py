"""The port's HTTP/WebSocket host (``api/server.py`` on ``api/_http.py``),
on the CPU.

- aiohttp's client drives it as ``tests/test_api.py`` drives the JAX host:
  health, the web UI and its assets, one-shot rspc over GET and POST,
  WebSocket queries, mutations and subscriptions with their invalidation
  events, Range fetches and thumbnails; a client holding several
  subscriptions has every one torn down when it closes or when the server
  stops; a duplicate subscription id is refused.
- Raw sockets check the RFC 6455 framing: the handshake's accept key,
  fragmented masked text, ping answered by pong, the close handshake, 16-
  and 64-bit payload lengths both ways, and an unmasked frame refused with
  close code 1002.
- The Range (206), 416, whole-file and thumbnail responses are held against
  the JAX server's on the same library: status, headers and body.
- ``python -m spacedrive_tpu_torch serve --device cpu`` answers ``/health``
  and stops on SIGINT with code 0.
"""

import asyncio
import base64
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import uuid
from pathlib import Path

import aiohttp
import pytest
import torch

from spacedrive_tpu_torch import tasks
from spacedrive_tpu_torch.api import _http
from spacedrive_tpu_torch.api.router import mount_router
from spacedrive_tpu_torch.api.server import ApiServer
from spacedrive_tpu_torch.node import Node

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _corpus(root):
    from PIL import Image

    os.makedirs(f"{root}/docs", exist_ok=True)
    with open(f"{root}/docs/hello.txt", "wb") as f:
        f.write(b"hello world " * 400)
    Image.new("RGB", (80, 60), (10, 120, 200)).save(f"{root}/pic.png")


@pytest.fixture
def env(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    _corpus(str(corpus))
    node = Node(str(tmp_path / "data"), device="cpu")
    return node, mount_router(node), str(corpus)


async def _scanned_library(http, base, corpus):
    async with http.post(f"{base}/rspc/library.create", json={"name": "ws-lib"}) as resp:
        lid = (await resp.json())["result"]["uuid"]
    async with http.post(f"{base}/rspc/locations.create",
                         json={"library_id": lid, "path": corpus, "dry_run": True}) as resp:
        loc = (await resp.json())["result"]
    return lid, loc


def test_server_http_ws_and_custom_uri(env):
    node, router, corpus = env

    async def main():
        server = ApiServer(node, router)
        port = await server.start(port=0)
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(f"{base}/health") as resp:
                    assert resp.status == 200 and await resp.text() == "OK"
                async with http.get(f"{base}/") as resp:
                    page = await resp.text()
                    assert resp.status == 200 and "/static/app.js" in page
                async with http.get(f"{base}/static/app.js") as resp:
                    js = await resp.text()
                    assert "/rspc" in js and "jobs.progress" in js
                async with http.get(f"{base}/static/..%2Fserver.py") as resp:
                    assert resp.status == 404
                async with http.get(f"{base}/manifest.webmanifest") as resp:
                    assert (await resp.json(content_type=None))["short_name"] == "sdtpu"
                async with http.get(f"{base}/metrics") as resp:
                    assert resp.status == 200
                    assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
                    assert "# TYPE sd_api_requests_total counter" in await resp.text()
                lid, loc = await _scanned_library(http, base, corpus)
                q = json.dumps({"library_id": lid})
                async with http.get(f"{base}/rspc/locations.list", params={"input": q}) as resp:
                    assert [x["id"] for x in (await resp.json())["result"]] == [loc]
                async with http.post(f"{base}/rspc/nope.nope", json={}) as resp:
                    assert resp.status == 404
                    assert (await resp.json())["error"]["code"] == "NOT_FOUND"
                async with http.post(f"{base}/rspc/tags.list", json={}) as resp:
                    assert resp.status == 400

                async with http.ws_connect(f"{base}/rspc") as ws:
                    await ws.send_json({"id": 1, "type": "subscription",
                                        "path": "invalidation.listen"})
                    assert (await ws.receive_json())["type"] == "response"
                    await ws.send_json({"id": 2, "type": "subscription", "path": "jobs.progress"})
                    assert (await ws.receive_json())["id"] == 2
                    await ws.send_json({"id": 3, "type": "mutation", "path": "tags.create",
                                        "input": {"library_id": lid, "name": "t"}})
                    got = set()
                    while got != {"event", "response"}:
                        frame = await asyncio.wait_for(ws.receive_json(), 5)
                        if frame["type"] == "event" and frame["data"]["key"] == "tags.list":
                            got.add("event")
                        if frame["type"] == "response" and frame["id"] == 3:
                            got.add("response")
                    await ws.send_json({"id": 4, "type": "mutation",
                                        "path": "locations.fullRescan",
                                        "input": {"library_id": lid, "location_id": loc}})
                    progress = 0
                    while (frame := await asyncio.wait_for(ws.receive_json(), 5))["id"] != 4:
                        progress += frame["id"] == 2
                    await node.jobs.wait_idle()
                    while True:  # the chain's JobProgress / JobUpdate frames
                        try:
                            frame = await asyncio.wait_for(ws.receive_json(), 0.5)
                        except asyncio.TimeoutError:
                            break
                        progress += frame["id"] == 2
                    await ws.send_json({"id": 5, "type": "query", "path": "nope.nope"})
                    while (frame := await asyncio.wait_for(ws.receive_json(), 5))["id"] != 5:
                        pass
                    assert (frame["type"], frame["code"]) == ("error", "NOT_FOUND")
                    await ws.send_json({"id": 6, "type": "bogus"})
                    while (frame := await asyncio.wait_for(ws.receive_json(), 5))["id"] != 6:
                        pass
                    assert frame["code"] == "BAD_REQUEST"
                await node.jobs.wait_idle()

                lib = node.libraries.get(uuid.UUID(lid))
                fp = lib.db.query_one("SELECT id, location_id FROM file_path WHERE name='hello'")
                url = f"{base}/spacedrive/file/{lid}/{fp['location_id']}/{fp['id']}"
                async with http.get(url) as resp:
                    assert resp.status == 200
                    assert (await resp.read()).startswith(b"hello world ")
                async with http.get(url, headers={"Range": "bytes=6-10"}) as resp:
                    assert resp.status == 206 and await resp.read() == b"world"
                    assert resp.headers["Content-Range"] == "bytes 6-10/4800"
                async with http.get(url, headers={"Range": "bytes=-"}) as resp:
                    assert resp.status == 206 and len(await resp.read()) == 4800
                async with http.get(url, headers={"Range": "bytes=9000-"}) as resp:
                    assert resp.status == 416
                async with http.get(f"{base}/spacedrive/file/{lid}/1/999999") as resp:
                    assert resp.status == 404
                async with http.get(f"{base}/spacedrive/file/not-a-uuid/1/1") as resp:
                    assert resp.status == 400
                pic = lib.db.query_one("SELECT cas_id FROM file_path WHERE name='pic'")
                async with http.get(f"{base}/spacedrive/thumbnail/{pic['cas_id']}.webp") as resp:
                    assert resp.status == 200
                    assert resp.headers["Content-Type"] == "image/webp"
                    assert (await resp.read())[:4] == b"RIFF"
                async with http.get(f"{base}/spacedrive/thumbnail/0000000000000000.webp") as r:
                    assert r.status == 404
            assert progress > 0
        finally:
            await server.stop()
            await node.shutdown()
    asyncio.run(main())


def _pumps(server):
    return [t for t in tasks.live(server._owner) if t.get_name().endswith("/ws-pump")]


def test_ws_teardown_reaps_every_subscription_pump(env):
    """A client holding several subscriptions has every event-bus callback
    removed and every pump reaped, whether it closes or the server stops;
    a duplicate subscription id is refused, not overwritten."""
    node, router, corpus = env

    async def main():
        server = ApiServer(node, router)
        port = await server.start(port=0)
        base = f"http://127.0.0.1:{port}"
        subs_before = len(node.events._subs)

        async def open_three(ws):
            for mid in (1, 2, 3):
                await ws.send_json({"id": mid, "type": "subscription",
                                    "path": "invalidation.listen"})
                assert (await asyncio.wait_for(ws.receive_json(), 5))["type"] == "response"
            assert len(node.events._subs) == subs_before + 3

        async def assert_torn_down():
            for _ in range(100):
                if not _pumps(server) and len(node.events._subs) == subs_before:
                    break
                await asyncio.sleep(0.02)
            assert len(node.events._subs) == subs_before
            assert not _pumps(server)

        async with aiohttp.ClientSession() as http:
            async with http.ws_connect(f"{base}/rspc") as ws:
                await open_three(ws)
                await ws.send_json({"id": 1, "type": "subscription",
                                    "path": "invalidation.listen"})
                frame = await asyncio.wait_for(ws.receive_json(), 5)
                assert frame["type"] == "error" and frame["code"] == "BAD_REQUEST"
                assert len(node.events._subs) == subs_before + 3
                await ws.send_json({"id": 2, "type": "subscriptionStop"})
                for _ in range(100):
                    if len(node.events._subs) == subs_before + 2:
                        break
                    await asyncio.sleep(0.02)
                assert len(node.events._subs) == subs_before + 2
                assert len(_pumps(server)) == 2
            await assert_torn_down()

            ws = await http.ws_connect(f"{base}/rspc")
            await open_three(ws)
            await server.stop()
            await assert_torn_down()
            msg = await asyncio.wait_for(ws.receive(), 5)
            assert msg.type in (aiohttp.WSMsgType.CLOSE, aiohttp.WSMsgType.CLOSED)
            await ws.close()
        await node.shutdown()
    asyncio.run(main())


def test_http_admission_sheds_past_its_window(env):
    node, router, _ = env
    gate = asyncio.Event

    async def main():
        release = gate()

        async def slow(node, _input):
            await release.wait()
            return "done"
        router.query("test.slow")(slow)
        server = ApiServer(node, router, http_inflight_cap=1)
        shed_before = server._inflight.shed_total
        port = await server.start(port=0)
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as http:
                first = asyncio.ensure_future(http.get(f"{base}/rspc/test.slow"))
                for _ in range(100):
                    if len(server._inflight):
                        break
                    await asyncio.sleep(0.01)
                async with http.post(f"{base}/rspc/buildInfo") as resp:
                    assert resp.status == 503 and resp.headers["Retry-After"] == "1"
                    assert (await resp.json())["error"]["code"] == "SHED"
                release.set()
                resp = await first
                assert (await resp.json())["result"] == "done"
                resp.release()
                async with http.post(f"{base}/rspc/buildInfo") as resp:
                    assert resp.status == 200
            assert server._inflight.shed_total - shed_before == 1
        finally:
            await server.stop()
            await node.shutdown()
    asyncio.run(main())


# -- raw-socket WebSocket framing ---------------------------------------------


class RawWs:
    """A minimal client over a plain socket, so the framing is ours."""

    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.key = base64.b64encode(os.urandom(16)).decode()
        self.s.sendall((f"GET /rspc HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                        f"Connection: Upgrade\r\nSec-WebSocket-Key: {self.key}\r\n"
                        f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += self.s.recv(1)
        self.head = head.decode()

    def send(self, opcode, payload, fin=True, masked=True):
        self.s.sendall(_http.encode_frame(opcode, payload, fin,
                                          mask=os.urandom(4) if masked else None))

    def _exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.s.recv(n - len(buf))
            if not chunk:
                raise EOFError
            buf += chunk
        return buf

    def recv(self):
        b0, b1 = self._exact(2)
        assert not b1 & 0x80, "server frames are unmasked"
        n, width = b1 & 0x7F, 7
        if n == 126:
            n, width = struct.unpack(">H", self._exact(2))[0], 16
        elif n == 127:
            n, width = struct.unpack(">Q", self._exact(8))[0], 64
        return b0 & 0x0F, self._exact(n), width

    def close(self):
        self.s.close()


@pytest.fixture
def served(env):
    """The server on a thread of its own (the raw client blocks)."""
    import threading

    node, router, corpus = env
    loop = asyncio.new_event_loop()
    server = ApiServer(node, router)
    port = loop.run_until_complete(server.start(port=0))
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    yield node, port, corpus, loop
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(10)
    asyncio.run_coroutine_threadsafe(node.shutdown(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    t.join(10)
    loop.close()


def test_ws_handshake_fragments_ping_and_close(served):
    _, port, _, _ = served
    ws = RawWs(port)
    assert ws.head.startswith("HTTP/1.1 101")
    accept = re.search(r"Sec-WebSocket-Accept: (\S+)", ws.head).group(1)
    assert accept == _http.ws_accept(ws.key)
    msg = json.dumps({"id": 7, "type": "query", "path": "buildInfo"}).encode()
    ws.send(_http.OP_TEXT, msg[:5], fin=False)
    ws.send(_http.OP_PING, b"mid")  # a control frame between fragments
    ws.send(_http.OP_CONT, msg[5:12], fin=False)
    ws.send(_http.OP_CONT, msg[12:], fin=True)
    op, payload, _ = ws.recv()
    assert (op, payload) == (_http.OP_PONG, b"mid")
    op, payload, width = ws.recv()
    assert op == _http.OP_TEXT and width == 7
    assert json.loads(payload) == {"id": 7, "type": "response",
                                   "result": {"version": "0.1.0", "commit": "unknown"}}
    ws.send(_http.OP_CLOSE, struct.pack(">H", 1000))
    op, payload, _ = ws.recv()
    assert op == _http.OP_CLOSE and struct.unpack(">H", payload)[0] == 1000
    with pytest.raises((EOFError, ConnectionError, OSError)):
        ws.recv()
    ws.close()


def test_ws_refuses_an_unmasked_frame_with_1002(served):
    _, port, _, _ = served
    ws = RawWs(port)
    ws.send(_http.OP_TEXT, b'{"id": 1, "type": "query", "path": "buildInfo"}', masked=False)
    op, payload, _ = ws.recv()
    assert op == _http.OP_CLOSE and struct.unpack(">H", payload)[0] == 1002
    ws.close()


def test_ws_16_and_64_bit_lengths_both_ways(served):
    node, port, corpus, loop = served
    lib = node.create_library("big")
    ws = RawWs(port)
    # 16-bit in: an input padded past 125 bytes; 64-bit in: past 65 535
    for pad, want in ((300, 16), (70_000, 64)):
        frame = json.dumps({"id": pad, "type": "mutation", "path": "tags.create",
                            "input": {"library_id": str(lib.id), "name": "x" * pad}})
        ws.send(_http.OP_TEXT, frame.encode())
        op, payload, width = ws.recv()
        reply = json.loads(payload)
        assert reply["id"] == pad and reply["result"]["name"] == "x" * pad
        assert width == want
    ws.close()


def test_http_keep_alive_and_query_strings(served):
    _, port, _, _ = served
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    for _ in range(3):  # one connection, three requests
        c.request("GET", "/rspc/library.list?input=")
        resp = c.getresponse()
        assert resp.status == 200 and json.loads(resp.read()) == {"result": []}
        assert resp.getheader("Connection") == "keep-alive"
    c.request("POST", "/rspc/library.create", body=json.dumps({"name": "k"}),
              headers={"Content-Type": "application/json"})
    lid = json.loads(c.getresponse().read())["result"]["uuid"]
    c.request("GET", "/rspc/tags.list?input=" +
              json.dumps({"library_id": lid}).replace(" ", "%20"))
    assert json.loads(c.getresponse().read()) == {"result": []}
    c.request("GET", "/nowhere", headers={"Connection": "close"})
    resp = c.getresponse()
    assert resp.status == 404 and resp.read() == b"404: Not Found"
    assert resp.getheader("Connection") == "close"
    c.close()


# -- responses against the JAX server ------------------------------------------

_SKIP = {"date", "server", "connection", "keep-alive"}


def test_range_416_and_thumbnail_responses_match_the_jax_servers(tmp_path):
    from spacedrive_tpu.api.server import ApiServer as JaxApiServer
    from spacedrive_tpu.node import Node as JaxNode

    corpus = tmp_path / "corpus"
    _corpus(str(corpus))
    (corpus / "big.bin").write_bytes(os.urandom(3 * (1 << 20) + 17))  # past RANGE_CHUNK
    data = str(tmp_path / "data")

    async def main():
        from spacedrive_tpu.api.router import mount_router as jax_mount
        from spacedrive_tpu.locations.manager import create_location, scan_location

        jnode = JaxNode(data)
        lib = jnode.create_library("shared")
        loc = create_location(lib, str(corpus))
        await scan_location(jnode.jobs, lib, loc, backend="numpy")
        await jnode.jobs.wait_idle()
        pnode = Node(data, device="cpu")
        pnode.libraries.init()
        jserver, pserver = JaxApiServer(jnode, jax_mount(jnode)), ApiServer(pnode)
        jport, pport = await jserver.start(port=0), await pserver.start(port=0)
        rows = {r["name"]: r for r in lib.db.query("SELECT * FROM file_path")}
        paths = [f"/spacedrive/file/{lib.id}/{loc}/{rows[n]['id']}" for n in
                 ("hello", "big", "pic")]
        paths.append(f"/spacedrive/thumbnail/{rows['pic']['cas_id']}.webp")
        cases = [(p, h) for p in paths for h in (
            {}, {"Range": "bytes=6-10"}, {"Range": "bytes=100-"}, {"Range": "bytes=-"},
            {"Range": "bytes=5-3"}, {"Range": "bytes=99999999-"},
            {"Range": "bytes=0-99999999"})]
        cases += [(f"/spacedrive/file/{lib.id}/{loc}/999999", {}),
                  ("/spacedrive/thumbnail/abc-def.webp", {}),
                  ("/spacedrive/thumbnail/0123456789abcdef.webp", {})]
        out = []
        try:
            async with aiohttp.ClientSession(auto_decompress=False) as http:
                for path, headers in cases:
                    got = []
                    for port in (jport, pport):
                        async with http.get(f"http://127.0.0.1:{port}{path}",
                                            headers=headers) as resp:
                            got.append((resp.status, await resp.read(), sorted(
                                (k.lower(), v) for k, v in resp.headers.items()
                                if k.lower() not in _SKIP)))
                    out.append((path, headers, got))
        finally:
            await jserver.stop()
            await pserver.stop()
            await pnode.shutdown()
            await jnode.shutdown()
        return out

    for path, headers, (theirs, mine) in asyncio.run(main()):
        assert mine[0] == theirs[0], (path, headers)
        assert mine[1] == theirs[1], (path, headers)
        assert mine[2] == theirs[2], (path, headers)


def test_serve_cli_answers_health_and_stops_on_sigint(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacedrive_tpu_torch", "serve", "--data-dir",
         str(tmp_path / "data"), "--port", "0", "--device", "cpu", "--no-discovery"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"listening on 127\.0\.0\.1:(\d+)", line).group(1))
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/health")
        resp = c.getresponse()
        assert (resp.status, resp.read()) == (200, b"OK")
        c.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_refuses_cuda_without_a_card_and_the_crypto_commands(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "spacedrive_tpu_torch", "serve", "--data-dir",
                        str(tmp_path / "d"), "--port", "0", "--no-discovery"],
                       cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    r = subprocess.run([sys.executable, "-m", "spacedrive_tpu_torch", "encrypt", "x"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "item 5" in r.stderr
