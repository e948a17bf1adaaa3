"""The port's video frame routes against the JAX package's.

H.264: the port's copy of the baseline CAVLC I-frame decoder gives the
committed fixtures' planes (``tests/fixtures/h264/*.truth.npz``) and the
JAX decoder's, from Annex B, MP4, TS and M2TS, and refuses what it
refuses. MJPEG: the writer's bytes and the frame chosen at 10 %. Cover
art: MP4 ``covr`` and Matroska attachments. For every route the RGB grid
handed to the WebP encoder equals the one PIL's ``save`` receives inside
the JAX ``encode_webp``.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.media import h264 as jax_h264
from spacedrive_tpu.media import mjpeg as jax_mjpeg
from spacedrive_tpu.media import mpegts as jax_ts
from spacedrive_tpu.media import video as jax_video
from spacedrive_tpu_torch.media import h264, mjpeg, mpegts, thumbnail, video, webpenc
from test_avmeta import box, full_box, make_mkv_with_attachment, make_mp4, make_mp4_with_cover

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
H264 = os.path.join(FIX, "h264")


@pytest.fixture(autouse=True)
def _no_ffmpeg(monkeypatch):
    """The chain without the ffmpeg CLI in both packages, whatever PATH
    holds (neither the test host nor the card's host has one)."""
    monkeypatch.setattr(jax_video, "available", lambda: False)
    monkeypatch.setattr(video, "available", lambda: False)


@pytest.fixture(params=["opencv", "self_hosted"])
def chain(request, monkeypatch):
    """The chain with OpenCV first where it imports, and without it, as on
    a host that lacks it: the self-hosted decoders and the cover art."""
    if request.param == "self_hosted" or not video.cv2_available():
        monkeypatch.setattr(jax_video, "cv2_available", lambda: False)
        monkeypatch.setattr(video, "cv2_available", lambda: False)
        return "self_hosted"
    return "opencv"


def _truth(name):
    return np.load(os.path.join(H264, f"{name}.truth.npz"))


def _planes(route: str, name: str, module_h264, module_ts):
    path = os.path.join(H264, name)
    if route == "annexb":
        with open(path, "rb") as f:
            return module_h264.decode_annexb_iframe(f.read())
    if route == "mp4":
        return module_h264.keyframe_from_mp4(path)
    return module_ts.keyframe_from_ts(path)


@pytest.mark.parametrize("route,name", [
    ("annexb", "gradient_ipcm.264"), ("mp4", "gradient_ipcm.mp4"), ("ts", "gradient_ipcm.ts"),
    ("annexb", "mixed_cavlc.264"), ("mp4", "mixed_cavlc.mp4"), ("ts", "mixed_cavlc.m2ts")])
def test_h264_planes_equal_the_truth_and_the_jax_decoder(route, name):
    got = _planes(route, name, h264, mpegts)
    want = _planes(route, name, jax_h264, jax_ts)
    assert got is not None and len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
    truth = _truth(name.split(".")[0])
    assert np.array_equal(got[0], truth["Y"])
    if "Cb" in truth:
        assert np.array_equal(got[1], truth["Cb"]) and np.array_equal(got[2], truth["Cr"])
    rgb = h264.yuv420_to_rgb(*got)
    assert np.array_equal(rgb, jax_h264.yuv420_to_rgb(*want))
    if "BGR" in truth:  # chroma's truth is FFmpeg's BGR: the JAX test's bound
        diff = np.abs(rgb[:, :, ::-1].astype(int) - truth["BGR"].astype(int))
        assert diff.max() <= 8 and diff.mean() < 2.0


def test_exp_golomb_and_the_refusals():
    for v in list(range(64)) + [255, 1023]:
        k = v + 1
        bits = "0" * (k.bit_length() - 1) + format(k, "b")
        pad = bits + "1" + "0" * (7 - len(bits) % 8)
        assert h264.BitReader(int(pad, 2).to_bytes((len(pad) + 7) // 8, "big")).ue() == v
    with pytest.raises(h264.Unsupported):  # CABAC
        h264.parse_pps(bytes([0b11100000, 0x80]))
    with pytest.raises(jax_h264.Unsupported):
        jax_h264.parse_pps(bytes([0b11100000, 0x80]))
    assert issubclass(h264.Unsupported, h264.H264Error) and issubclass(h264.H264Error, ValueError)
    with pytest.raises(h264.H264Error):
        h264.decode_annexb_iframe(b"\x00\x00\x01\x65" + bytes(16))


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(FIX, "video"))))
def test_streams_outside_the_subset_refuse_alike(name):
    path = os.path.join(FIX, "video", name)
    got = (h264.keyframe_from_mp4(path) if name.endswith(".mp4")
           else mpegts.keyframe_from_ts(path))
    want = (jax_h264.keyframe_from_mp4(path) if name.endswith(".mp4")
            else jax_ts.keyframe_from_ts(path))
    assert got is None and want is None


def test_junk_containers_refuse_alike(tmp_path):
    rng = np.random.default_rng(7)
    for name, data in (("a.mp4", b"\x00\x00\x00\x20ftypisom" + bytes(64)),
                       ("b.mp4", rng.bytes(256)), ("c.ts", rng.bytes(4096)),
                       ("d.ts", b"\x47" + bytes(187) + b"\x47" + bytes(400))):
        p = str(tmp_path / name)
        open(p, "wb").write(data)
        if name.endswith(".mp4"):
            assert h264.keyframe_from_mp4(p) is None and jax_h264.keyframe_from_mp4(p) is None
        else:
            assert mpegts.keyframe_from_ts(p) is None and jax_ts.keyframe_from_ts(p) is None
            assert mpegts.extract_annexb(p) == jax_ts.extract_annexb(p)


def _jpegs(n: int, size=(96, 64)):
    out = []
    for i in range(n):
        y, x = np.mgrid[0:size[1], 0:size[0]]
        px = np.stack([(x * 2 + 13 * i) % 256, (y * 3) % 256, np.full_like(x, 9 * i % 256)], -1)
        buf = io.BytesIO()
        Image.fromarray(px.astype(np.uint8)).save(buf, "JPEG", quality=80)
        out.append(buf.getvalue())
    return out


def test_mjpeg_writer_and_frame_choice(tmp_path):
    frames = _jpegs(23)
    ours, theirs = str(tmp_path / "port.avi"), str(tmp_path / "jax.avi")
    mjpeg.write_mjpeg_avi(ours, frames, fps=12)
    jax_mjpeg.write_mjpeg_avi(theirs, frames, fps=12)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert mjpeg.index_frames(ours) == jax_mjpeg.index_frames(ours)
    for frac in (0.0, 0.1, 0.5, 0.99, 1.0):
        got = mjpeg.frame_at_fraction(ours, frac)
        assert got == jax_mjpeg.frame_at_fraction(ours, frac)
        assert got == frames[min(int(23 * frac), 22)]
    with pytest.raises(ValueError):
        mjpeg.index_frames(_write(tmp_path / "not.avi", b"RIFF0000WAVE" + bytes(20)))
    with pytest.raises(ValueError):
        mjpeg.write_mjpeg_avi(str(tmp_path / "none.avi"), [])


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _non_mjpeg_avi(path) -> str:
    """An AVI whose frames are not JPEG: no MJPEG frame, no thumbnail."""
    mjpeg.write_mjpeg_avi(str(path), _jpegs(3))
    return _write(path, open(path, "rb").read().replace(b"\xff\xd8\xff", b"\x00\x01\x02"))


ROUTES = {
    "mjpeg.avi": lambda p: mjpeg.write_mjpeg_avi(str(p), _jpegs(20, (320, 200))),
    "ipcm.mp4": lambda p: _write(p, open(os.path.join(H264, "gradient_ipcm.mp4"), "rb").read()),
    "cavlc.m4v": lambda p: _write(p, open(os.path.join(H264, "mixed_cavlc.mp4"), "rb").read()),
    "ipcm.ts": lambda p: _write(p, open(os.path.join(H264, "gradient_ipcm.ts"), "rb").read()),
    "cavlc.m2ts": lambda p: _write(p, open(os.path.join(H264, "mixed_cavlc.m2ts"), "rb").read()),
    "cover.mp4": lambda p: make_mp4_with_cover(str(p)),
    "cover.mkv": lambda p: make_mkv_with_attachment(str(p)),
    "plain.mp4": lambda p: make_mp4(str(p)),
    "hevc.mp4": lambda p: _write(p, open(os.path.join(FIX, "video", "hevc.mp4"), "rb").read()),
    "vp9.webm": lambda p: _write(p, open(os.path.join(FIX, "video", "vp9.webm"), "rb").read()),
    "mpeg2.mpg": lambda p: _write(p, open(os.path.join(FIX, "video", "mpeg2.mpg"), "rb").read()),
    "notjpeg.avi": _non_mjpeg_avi,
}


def _cabac_with_cover(path) -> None:
    """A CABAC stream the decoder refuses, with cover art spliced into its
    moov: the chain falls through H.264 to the cover."""
    data = open(os.path.join(FIX, "video", "cabac_main.mp4"), "rb").read()
    buf = io.BytesIO()
    Image.new("RGB", (50, 70), (200, 40, 90)).save(buf, "JPEG", quality=85)
    covr = box(b"covr", box(b"data", struct.pack(">II", 13, 0) + buf.getvalue()))
    udta = box(b"udta", full_box(b"meta", 0, box(b"hdlr", bytes(24)) + box(b"ilst", covr)))
    i = data.find(b"moov") - 4
    size = struct.unpack_from(">I", data, i)[0]
    payload = udta + data[i + 8:i + size]  # before the muxer's own udta
    _write(path, data[:i] + struct.pack(">I4s", 8 + len(payload), b"moov") + payload
           + data[i + size:])


ROUTES["cabac_cover.mov"] = _cabac_with_cover


def _jax_grid(src: str, out: str, monkeypatch):
    seen = []
    real = Image.Image.save

    def spy(self, fp, format=None, **kw):
        if format == "WEBP":
            seen.append(np.asarray(self.convert("RGB")).copy())
        return real(self, fp, format, **kw)

    monkeypatch.setattr(Image.Image, "save", spy)
    try:
        done = jax_video.generate_video_thumbnail(src, out)
    finally:
        monkeypatch.setattr(Image.Image, "save", real)
    return done, seen


def _port_grid(src: str, out: str, monkeypatch, native: bool = True):
    seen = []
    real = webpenc.encode

    def spy(rgb, **kw):
        seen.append(rgb.copy())
        return real(rgb, **kw)

    monkeypatch.setattr(webpenc, "encode", spy)
    try:
        done = video.generate_video_thumbnail(src, out, native=native)
    finally:
        monkeypatch.setattr(webpenc, "encode", real)
    return done, seen


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_the_encoders_grid_equals_the_jax_grid(tmp_path, name, monkeypatch, chain):
    src = tmp_path / name
    ROUTES[name](src)
    jax_out, want = _jax_grid(str(src), str(tmp_path / "jax" / "t.webp"), monkeypatch)
    port_out, got = _port_grid(str(src), str(tmp_path / "port" / "t.webp"), monkeypatch)
    assert (port_out is None) == (jax_out is None)
    assert len(got) == len(want) <= 1
    if want:
        assert got[0].shape == want[0].shape and np.array_equal(got[0], want[0])
        with Image.open(port_out) as im:
            assert im.format == "WEBP" and im.size == (want[0].shape[1], want[0].shape[0])
        _, plain = _port_grid(str(src), str(tmp_path / "plain" / "t.webp"), monkeypatch,
                              native=False)
        assert np.array_equal(plain[0], want[0])
    if name.startswith(("mjpeg", "ipcm", "cavlc", "cover", "cabac")):
        assert port_out is not None
    if chain == "self_hosted" and name.startswith(("plain", "notjpeg", "hevc", "vp9", "mpeg2")):
        assert port_out is None


def test_generate_thumbnail_routes_video_through_the_chain(tmp_path, chain):
    src = str(tmp_path / "clip.avi")
    ROUTES["mjpeg.avi"](src)
    out = thumbnail.generate_thumbnail(src, str(tmp_path / "data"), "cd" * 8)
    assert out == thumbnail.thumbnail_path(str(tmp_path / "data"), "cd" * 8)
    with Image.open(out) as im:
        assert im.size == thumbnail.scale_dimensions(320, 200)
    # Already there: returned as it is.
    assert thumbnail.generate_thumbnail(src, str(tmp_path / "data"), "cd" * 8) == out
    assert thumbnail.generate_thumbnail(str(tmp_path / "missing.mp4"), str(tmp_path / "data"),
                                        "ef" * 8) is None
