"""The port's media plane end to end against the JAX package's.

``scan_location`` (``with_media`` by default) through both packages over
one tree of images, audio, video, cover art, SVG and PDF (the JAX
identifier with ``backend="numpy"``, the port's with ``"plain"`` on the
CPU): equal ``media_data`` rows matched by cas_id (EXIF and
``stream_data``), the same thumbnail paths and sizes, the same grids
handed to the encoders, the same job steps, counts and status, with
OpenCV where it imports and without it; a second scan writes nothing;
the media job pauses and cold-resumes; the thumbnailer actor's batches,
coalescing, shedding, clean-up and cache versioning, as
``tests/test_thumbnailer.py`` holds the JAX actor to them, with a small
stand-in for the node the port does not have yet.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu_torch.jobs.manager import JobManager
from spacedrive_tpu_torch.jobs.report import JobStatus
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.locations.non_indexed import (queue_ephemeral_thumbnails,
                                                        walk_ephemeral)
from spacedrive_tpu_torch.media import actor as actor_mod
from spacedrive_tpu_torch.media.actor import Thumbnailer
from spacedrive_tpu.media import thumbnail as jax_thumbnail
from spacedrive_tpu.media import video as jax_video
from spacedrive_tpu_torch.media import thumbnail as port_thumbnail
from spacedrive_tpu_torch.media import video, webpenc
from spacedrive_tpu_torch.media.processor import MediaProcessorJob
from spacedrive_tpu_torch.media.thumbnail import (THUMBNAIL_CACHE_VERSION, scale_dimensions,
                                                  thumbnail_path)
from test_audio_metadata import make_wav
from test_avmeta import make_mkv_with_attachment, make_mp4_with_cover
from test_torch_svg_pdf import DOCS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + seed) % 256, (y * 5) % 256, (x + y) % 256, (x * y) % 256], -1)
    return (base[..., :c] + rng.integers(0, 20, (h, w, c))).clip(0, 255).astype(np.uint8)


def _exif(seed: int) -> bytes:
    R = TiffImagePlugin.IFDRational
    ex = Image.Exif()
    ex[0x010F], ex[0x0110], ex[0x0112] = "Cam", f"M{seed}", 1 + seed % 8
    sub = ex.get_ifd(0x8769)
    sub[0x9003], sub[0x829D], sub[0x8827] = f"2024:01:0{1 + seed % 9} 10:00:00", R(28, 10), 100
    gps = ex.get_ifd(0x8825)
    gps[1], gps[2] = "NS"[seed % 2], (R(40 + seed, 1), R(30, 1), R(15, 1))
    gps[3], gps[4] = "EW"[seed % 2], (R(70, 1), R(5, 1), R(seed, 1))
    return ex.tobytes()


FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# The second media slice's files by relative path, and their writers.
SLICE2 = {
    "audio/voice.wav": lambda p: make_wav(p, seconds=0.5, rate=8000, channels=1),
    "audio/song.mp3": lambda p: open(p, "wb").write(b"\xff\xfb" + bytes(400)),
    "video/cover.mp4": make_mp4_with_cover,
    "video/cover.mkv": make_mkv_with_attachment,
    "video/ipcm.mp4": lambda p: shutil.copy(os.path.join(FIX, "h264", "gradient_ipcm.mp4"), p),
    "video/cavlc.m2ts": lambda p: shutil.copy(os.path.join(FIX, "h264", "mixed_cavlc.m2ts"), p),
    "video/hevc.mp4": lambda p: shutil.copy(os.path.join(FIX, "video", "hevc.mp4"), p),
    "video/junk.mp4": lambda p: open(p, "wb").write(bytes(600)),
    "video/clip.avi": lambda p: _mjpeg(p),
    "docs/art.svg": lambda p: open(p, "w").write(DOCS["shapes.svg"]),
    "docs/broken.svg": lambda p: open(p, "w").write("<svg"),
    "docs/dct.pdf": lambda p: shutil.copy(os.path.join(FIX, "dct.pdf"), p),
    "docs/flate.pdf": lambda p: shutil.copy(os.path.join(FIX, "flate.pdf"), p),
    "docs/empty.pdf": lambda p: open(p, "wb").write(b"%PDF-1.4\n" + bytes(300)),
}


def _mjpeg(path):
    import io

    from spacedrive_tpu_torch.media.mjpeg import write_mjpeg_avi

    frames = []
    for k in range(10):
        buf = io.BytesIO()
        Image.fromarray(_scene(60, 80, k)).save(buf, "JPEG", quality=80)
        frames.append(buf.getvalue())
    write_mjpeg_avi(path, frames)


def _corpus(root) -> list:
    """Images of every kind the job meets, and the second media slice's
    audio, video, SVG and PDF files."""
    os.makedirs(os.path.join(root, "sub"))
    made = []

    def save(name, arr, fmt, mode=None, **kw):
        path = os.path.join(root, name)
        Image.fromarray(arr, mode).save(path, fmt, **kw)
        made.append(name)

    save("a.jpg", _scene(150, 200, 1), "JPEG", exif=_exif(1))
    save("b.png", _scene(48, 64, 2, 4), "PNG", exif=_exif(2))
    save("c.webp", _scene(40, 30, 3, 4), "WEBP", lossless=True, exif=_exif(3))
    save("d.tiff", _scene(33, 45, 4), "TIFF", exif=_exif(4))
    save("sub/e.gif", _scene(20, 30, 5)[..., 0], "GIF")
    save("sub/f.bmp", _scene(25, 17, 6), "BMP")
    save("sub/tiny.png", _scene(5, 7, 7), "PNG")
    save("sub/wide.png", _scene(1, 900, 8), "PNG")
    save("g.avif", _scene(24, 32, 9), "AVIF", exif=_exif(9))
    for name, write in SLICE2.items():
        os.makedirs(os.path.join(root, os.path.dirname(name)), exist_ok=True)
        write(os.path.join(root, name))
        made.append(name)
    return made


class _Run:
    """One package's library, data dir and location over the corpus."""

    def __init__(self, tmp, root, port: bool):
        self.port = port
        self.data = str(tmp / ("port" if port else "jax"))
        libs = Libraries(self.data) if port else JaxLibraries(self.data)
        self.lib = libs.create("media")
        mod = locations if port else jax_locations
        self.loc = mod.create_location(self.lib, root)

    def scan(self):
        async def main():
            if self.port:
                jobs = JobManager(services={"data_dir": self.data})
                await locations.scan_location(jobs, self.lib, self.loc, backend="plain",
                                              with_media=True)
            else:
                jobs = JaxJobManager(services={"data_dir": self.data})
                await jax_locations.scan_location(jobs, self.lib, self.loc, backend="numpy",
                                                  with_media=True)
            await jobs.wait_idle()
        asyncio.run(main())

    def rows(self) -> dict:
        return {r["cas_id"]: (r["resolution"], r["media_date"], r["media_location"],
                              r["camera_data"], r["stream_data"])
                for r in self.lib.db.query(
                    "SELECT fp.cas_id, md.* FROM media_data md "
                    "JOIN file_path fp ON fp.object_id = md.object_id")}

    def thumbs(self) -> dict:
        out = {}
        root = os.path.join(self.data, "thumbnails")
        for dirpath, _, names in os.walk(root):
            for n in names:
                if n.endswith(".webp"):
                    with Image.open(os.path.join(dirpath, n)) as im:
                        out[os.path.relpath(os.path.join(dirpath, n), root)] = im.size
        return out

    def media_reports(self) -> list:
        import msgpack

        out = []
        for r in self.lib.db.query("SELECT * FROM job WHERE name = 'media_processor' "
                                   "ORDER BY rowid"):
            meta = msgpack.unpackb(r["metadata"]) if r["metadata"] else {}
            out.append((r["status"], r["task_count"], r["completed_task_count"],
                        meta.get("media_data_extracted"), meta.get("thumbnails_generated")))
        return out

    def errors(self) -> str:
        return "".join(r["errors_text"] or "" for r in self.lib.db.query(
            "SELECT errors_text FROM job WHERE name = 'media_processor'"))


def _grids(monkeypatch) -> tuple:
    """{thumbnail file name: the RGB grid handed to the encoder} of each
    package: what PIL's save receives inside the JAX encode_webp, what the
    port's encode_webp hands its encoder."""
    jax, port, current = {}, {}, {}
    real_save, real_jax, real_port = Image.Image.save, jax_thumbnail.encode_webp, \
        port_thumbnail.encode_webp
    real_encode = webpenc.encode

    def save(self, fp, format=None, **kw):
        if format == "WEBP" and "jax" in current:
            jax[current["jax"]] = np.asarray(self.convert("RGB")).copy()
        return real_save(self, fp, format, **kw)

    def jax_encode_webp(im, out_path, *a, **kw):
        current["jax"] = os.path.basename(out_path)
        return real_jax(im, out_path, *a, **kw)

    def port_encode_webp(pixels, mode, out_path, *a, **kw):
        current["port"] = os.path.basename(out_path)
        return real_port(pixels, mode, out_path, *a, **kw)

    def encode(rgb, **kw):
        port[current["port"]] = rgb.copy()
        return real_encode(rgb, **kw)

    monkeypatch.setattr(Image.Image, "save", save)
    monkeypatch.setattr(jax_thumbnail, "encode_webp", jax_encode_webp)
    monkeypatch.setattr(port_thumbnail, "encode_webp", port_encode_webp)
    monkeypatch.setattr(webpenc, "encode", encode)
    return jax, port


def _chain(tmp_path, monkeypatch, routes: dict) -> None:
    root = str(tmp_path / "tree")
    _corpus(root)
    jax, port = _Run(tmp_path, root, port=False), _Run(tmp_path, root, port=True)
    jax_grids, port_grids = _grids(monkeypatch)
    try:
        jax.scan()
        port.scan()
        rows = port.rows()
        assert rows == jax.rows()
        by_name = {r["cas_id"]: f"{r['materialized_path']}{r['name']}.{r['extension']}"
                   for r in port.lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
        streams = {by_name[c][1:] for c, row in rows.items() if row[4] is not None}
        assert streams == routes["streams"]
        assert len(rows) == 7 + len(streams)
        thumbs = port.thumbs()
        assert thumbs == jax.thumbs()
        named = {by_name[os.path.basename(rel)[:-5]][1:] for rel in thumbs}
        assert {n for n in named if "/" in n and not n.startswith("sub/")} == routes["thumbs"]
        assert len(thumbs) == 8 + len(routes["thumbs"])  # not the AVIF
        for rel, size in thumbs.items():
            name = by_name[os.path.basename(rel)[:-5]]
            if name.rsplit(".", 1)[1] in ("png", "jpg", "webp", "tiff", "gif", "bmp"):
                with Image.open(os.path.join(root, name.lstrip("/"))) as im:
                    assert size == scale_dimensions(*im.size)
        # Every encoder got the JAX package's grid.
        assert sorted(port_grids) == sorted(jax_grids) == sorted(
            os.path.basename(r) for r in thumbs)
        for k, grid in jax_grids.items():
            assert port_grids[k].shape == grid.shape and np.array_equal(port_grids[k], grid), k
        # The same steps, counts and status; nothing left as not ported.
        assert port.media_reports() == jax.media_reports()
        assert "not ported" not in port.errors()
        # A second scan writes nothing: no row, no thumbnail rewritten.
        stamps = {p: os.stat(os.path.join(port.data, "thumbnails", p)).st_mtime_ns
                  for p in port.thumbs()}
        port.scan()
        assert port.rows() == rows
        assert {p: os.stat(os.path.join(port.data, "thumbnails", p)).st_mtime_ns
                for p in port.thumbs()} == stamps
        assert port.media_reports()[-1][3] == 0  # no row written
    finally:
        jax.lib.db.close()
        port.lib.db.close()


SELF_HOSTED = {
    "streams": {"audio/voice.wav", "video/cover.mp4", "video/cover.mkv", "video/ipcm.mp4",
                "video/hevc.mp4", "video/clip.avi"},
    "thumbs": {"video/cover.mp4", "video/cover.mkv", "video/ipcm.mp4", "video/cavlc.m2ts",
               "video/clip.avi", "docs/art.svg", "docs/dct.pdf", "docs/flate.pdf"},
}


def test_the_chain_writes_the_jax_packages_rows_and_thumbnails(tmp_path, monkeypatch):
    """In this runtime: OpenCV, where it imports, probes and decodes the
    containers the parsers leave."""
    if not video.cv2_available():
        pytest.skip("OpenCV absent: the self-hosted test below covers the chain")
    _chain(tmp_path, monkeypatch, {
        "streams": SELF_HOSTED["streams"] | {"video/cavlc.m2ts"},
        "thumbs": SELF_HOSTED["thumbs"] | {"video/hevc.mp4"}})


def test_the_chain_without_opencv_takes_the_self_hosted_routes(tmp_path, monkeypatch):
    """As on a host without OpenCV or ffmpeg (the card's): the container
    parsers, MJPEG, H.264, cover art, SVG and PDF."""
    for module in (jax_video, video):
        monkeypatch.setattr(module, "cv2_available", lambda: False)
        monkeypatch.setattr(module, "available", lambda: False)
    from spacedrive_tpu.media import avmetadata as jax_av
    from spacedrive_tpu_torch.media import avmetadata

    monkeypatch.setattr(jax_av, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(avmetadata, "ffmpeg_available", lambda: False)
    _chain(tmp_path, monkeypatch, SELF_HOSTED)


def test_the_port_reads_a_thumbnail_cache_the_jax_job_wrote(tmp_path):
    root = str(tmp_path / "tree")
    _corpus(root)
    jax = _Run(tmp_path, root, port=False)
    try:
        jax.scan()
        written = jax.thumbs()
        port = _Run(tmp_path, root, port=True)
        shutil.copytree(os.path.join(jax.data, "thumbnails"),
                        os.path.join(port.data, "thumbnails"))
        before = {p: open(os.path.join(port.data, "thumbnails", p), "rb").read()
                  for p in written}
        port.scan()
        # Every thumbnail was already there: none is re-encoded.
        assert {p: open(os.path.join(port.data, "thumbnails", p), "rb").read()
                for p in written} == before
        assert port.thumbs() == written
        port.lib.db.close()
    finally:
        jax.lib.db.close()


def test_the_media_job_pauses_and_cold_resumes(tmp_path, monkeypatch):
    root = str(tmp_path / "many")
    os.makedirs(root)
    for i in range(25):
        Image.fromarray(_scene(12, 16, i)).save(os.path.join(root, f"p{i:02d}.png"),
                                                exif=_exif(i))
    data = str(tmp_path / "data")
    lib = Libraries(data).create("pause")
    loc = locations.create_location(lib, root)
    real = MediaProcessorJob.execute_step
    holder = {}

    async def step_then_pause(self, ctx, data_, step, step_number):
        out = await real(self, ctx, data_, step, step_number)
        if step_number == 0:
            holder["jobs"].pause(holder["jid"])
        return out

    async def first():
        jobs = JobManager(services={"data_dir": data})
        await locations.scan_location(jobs, lib, loc, backend="plain", with_media=False)
        await jobs.wait_idle()
        holder["jobs"] = jobs
        holder["jid"] = await jobs.ingest(lib, MediaProcessorJob(location_id=loc))
        assert await jobs.wait(holder["jid"]) == JobStatus.PAUSED

    async def second():
        jobs = JobManager(services={"data_dir": data})
        assert len(await jobs.cold_resume(lib)) == 1
        await jobs.wait_idle()

    try:
        monkeypatch.setattr(MediaProcessorJob, "execute_step", step_then_pause)
        asyncio.run(first())
        assert lib.db.query_one("SELECT COUNT(*) AS n FROM media_data")["n"] == 10
        monkeypatch.setattr(MediaProcessorJob, "execute_step", real)
        asyncio.run(second())
        assert lib.db.query_one("SELECT COUNT(*) AS n FROM media_data")["n"] == 25
        row = lib.db.query_one("SELECT * FROM job WHERE name = 'media_processor'")
        assert row["status"] == int(JobStatus.COMPLETED)
        assert len(os.listdir(os.path.join(data, "thumbnails"))) > 1
    finally:
        lib.db.close()


# -- the actor, with a stand-in owner -----------------------------------------


class _Owner:
    def __init__(self, data_dir, libraries=()):
        self.data_dir = data_dir
        self.events_seen = []
        owner = self

        class _Events:
            def emit(self, event):
                owner.events_seen.append(event)

        class _Libraries:
            def list(self):
                return list(libraries)

        self.events, self.libraries = _Events(), _Libraries()


def _png(path, size=(640, 480)):
    Image.new("RGB", size, (200, 30, 90)).save(path)


def test_actor_batch_generates_thumbs_and_events(tmp_path):
    img = tmp_path / "pic.png"
    _png(img)
    owner = _Owner(str(tmp_path / "data"))

    async def main():
        t = Thumbnailer(owner)
        t.start()
        batch = await t.new_batch([("a1b2c3d4e5f60718", str(img))])
        await asyncio.wait_for(batch.done.wait(), 30)
        assert batch.generated == 1
        missing = await t.new_batch([("ffffffffffffffff", str(tmp_path / "missing.png")),
                                     ("eeeeeeeeeeeeeeee", str(tmp_path / "notes.txt"))])
        await asyncio.wait_for(missing.done.wait(), 30)
        assert missing.generated == 0
        await t.stop()

    asyncio.run(main())
    out = thumbnail_path(owner.data_dir, "a1b2c3d4e5f60718")
    assert os.path.basename(os.path.dirname(out)) == "a1"
    assert owner.events_seen[0]["cas_id"] == "a1b2c3d4e5f60718"
    with Image.open(out) as thumb:
        assert thumb.format == "WEBP" and thumb.size == scale_dimensions(640, 480)


def test_actor_coalesces_and_sheds_the_oldest_batch(tmp_path, monkeypatch):
    img = tmp_path / "pic.png"
    _png(img, (20, 10))
    owner = _Owner(str(tmp_path / "data"))
    monkeypatch.setattr(actor_mod, "QUEUE_CAPACITY", 2)

    async def main():
        t = Thumbnailer(owner)  # not started: batches wait in the queue
        first = await t.new_batch([("1111111111111111", str(img))])
        dup = await t.new_batch([("1111111111111111", str(img))])  # coalesces into `first`
        assert dup.entries == [] and not dup.done.is_set()
        second = await t.new_batch([("2222222222222222", str(img))])
        third = await t.new_batch([("3333333333333333", str(img))])  # sheds `first`
        assert first.done.is_set() and dup.done.is_set() and t.queue.shed == 1
        t.start()
        await asyncio.wait_for(asyncio.gather(second.done.wait(), third.done.wait()), 30)
        assert (second.generated, third.generated) == (1, 1)
        await t.stop()

    asyncio.run(main())
    assert not os.path.exists(thumbnail_path(owner.data_dir, "1111111111111111"))


def test_actor_cleanup_removes_unreferenced(tmp_path):
    img = tmp_path / "pic.png"
    _png(img, (30, 20))
    data = str(tmp_path / "data")
    lib = Libraries(data).create("t")
    owner = _Owner(data, [lib])
    try:
        async def main():
            t = Thumbnailer(owner)
            t.start()
            b = await t.new_batch([("11112222333344445", str(img)),
                                   ("aaaabbbbccccdddd", str(img))])
            await asyncio.wait_for(b.done.wait(), 30)
            await t.stop()
            return t

        t = asyncio.run(main())
        lib.db.insert("location", {"pub_id": os.urandom(16), "name": "l",
                                   "path": str(tmp_path)})
        loc = lib.db.query_one("SELECT id FROM location")["id"]
        lib.db.insert("file_path", {
            "pub_id": os.urandom(16), "location_id": loc, "cas_id": "11112222333344445",
            "materialized_path": "/", "name": "pic", "extension": "png", "is_dir": 0})
        assert t.clean_up() == 1
        assert t.exists("11112222333344445") and not t.exists("aaaabbbbccccdddd")
    finally:
        lib.db.close()


def test_actor_migrates_a_stale_cache_version(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(os.path.join(data, "thumbnails", "ab"))
    stale = os.path.join(data, "thumbnails", "ab", "abcd.webp")
    with open(stale, "wb") as f:
        f.write(b"old")
    with open(os.path.join(data, "thumbnails", "version.txt"), "w") as f:
        f.write("0")
    Thumbnailer(_Owner(data))
    assert not os.path.exists(stale)
    with open(os.path.join(data, "thumbnails", "version.txt")) as f:
        assert int(f.read()) == THUMBNAIL_CACHE_VERSION


def test_walk_ephemeral_queues_its_images(tmp_path):
    d = tmp_path / "browse"
    d.mkdir()
    for i in range(3):
        _png(d / f"i{i}.png", (40 + i, 30))
    (d / "notes.txt").write_text("x")
    owner = _Owner(str(tmp_path / "data"))

    async def main():
        t = Thumbnailer(owner)
        t.start()
        entries = walk_ephemeral(str(d), compute_cas_ids=True, device="cpu")
        batch = await queue_ephemeral_thumbnails(t, entries)
        await asyncio.wait_for(batch.done.wait(), 30)
        await t.stop()
        return entries, batch

    entries, batch = asyncio.run(main())
    assert batch.ephemeral and batch.generated == 3
    assert all(e["ephemeral"] for e in owner.events_seen)
    for e in entries:
        if e["extension"] == "png":
            assert os.path.exists(thumbnail_path(owner.data_dir, e["cas_id"]))


def test_extension_sets_are_the_jax_packages_in_this_runtime():
    from spacedrive_tpu.media import avmetadata as jax_av
    from spacedrive_tpu.media import exif as jax_exif
    from spacedrive_tpu.media import thumbnail as jax_thumb
    from spacedrive_tpu_torch.media import avmetadata, exif, thumbnail

    assert thumbnail.thumbnailable_extensions() == jax_thumb.thumbnailable_extensions()
    assert avmetadata.probeable_extensions() == jax_av.probeable_extensions()
    assert exif.MEDIA_DATA_EXTENSIONS == jax_exif.MEDIA_DATA_EXTENSIONS
