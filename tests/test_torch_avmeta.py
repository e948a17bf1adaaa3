"""The port's audio and video probes against the JAX package's.

Every container the media job probes — WAV, FLAC, MP3 (CBR, Xing, MPEG-2.5,
an oversized ID3 tag), Ogg Vorbis and Opus, AVI, the ISO-BMFF family
(MP4, MOV, M4A, 3GP, rotated, with cover art, a lying stts), Matroska and
WebM (a non-minimal size vint, an attachment), garbage, truncations of each,
the committed H.264 and video fixtures — goes through both packages'
``probe_media`` in this runtime: the ``stream_data`` JSON the media job
writes must be byte-equal (or both None). The ffprobe route runs both
packages against one fake ``ffprobe`` on ``PATH``, and the ffmpeg
thumbnail route against one fake ``ffmpeg``, with the gates' caches
cleared.
"""

from __future__ import annotations

import io
import json
import os
import stat
import struct

import pytest
from PIL import Image

from spacedrive_tpu.media import avmetadata as jax_av
from spacedrive_tpu.media import video as jax_video
from spacedrive_tpu_torch.media import audio, avmetadata, mjpeg, mkv, mp4meta
from spacedrive_tpu_torch.media import video
from test_audio_metadata import make_wav
from test_avmeta import (_ebml_id, box, el, make_mkv, make_mkv_with_attachment,
                         make_mp4, make_mp4_with_cover)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _jpeg(color, size=(64, 48)) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, "JPEG", quality=85)
    return buf.getvalue()


def _flac(path, rate=44100, channels=2, depth=16, total=441_000, picture=0):
    bits = (rate << 44) | ((channels - 1) << 41) | ((depth - 1) << 36) | total
    info = struct.pack(">HH", 4096, 4096) + b"\x00" * 6 + bits.to_bytes(8, "big") + b"\x00" * 16
    pic = (b"\x06" + picture.to_bytes(3, "big") + b"\x00" * picture) if picture else b""
    with open(path, "wb") as f:
        f.write(b"fLaC" + pic + bytes([0x80]) + len(info).to_bytes(3, "big") + info)


def _mp3(path, header=b"\xff\xfb\x90\x00", frame_len=417, frames=100, id3=0, xing=None):
    frame = header + b"\x00" * (frame_len - 4)
    if xing is not None:
        first = bytearray(frame)
        first[36:48] = b"Xing" + struct.pack(">II", 1, xing)
        body = bytes(first) + frame * (frames - 1)
    else:
        body = frame * frames
    tag = b""
    if id3:
        syn = bytes([(id3 >> 21) & 0x7F, (id3 >> 14) & 0x7F, (id3 >> 7) & 0x7F, id3 & 0x7F])
        tag = b"ID3\x04\x00\x00" + syn + b"\x00" * id3
    with open(path, "wb") as f:
        f.write(tag + body)


def _ogg(path, codec="vorbis", granules=(96000,)):
    if codec == "vorbis":
        pkt = b"\x01vorbis" + struct.pack("<IB I", 0, 2, 48000) + b"\x00" * 9
    else:
        pkt = b"OpusHead" + bytes([1, 2]) + b"\x00" * 9
    pages = [b"OggS\x00\x02" + struct.pack("<q", 0) + b"\x00" * 12 + bytes([1, len(pkt)]) + pkt]
    for g in granules:
        pages.append(b"OggS\x00\x04" + struct.pack("<q", g) + b"\x00" * 12 + bytes([1, 1])
                     + b"\x00")
    with open(path, "wb") as f:
        f.write(b"".join(pages) + b"garbageOggS\xff\xff\xff\xff\xff\xff")


def _avi(path, frames=12, fps=15):
    mjpeg.write_mjpeg_avi(path, [_jpeg((20 * i % 256, 90, 30), (80, 60)) for i in range(frames)],
                          fps=fps)


def _mp4_branded(path, brand: bytes, rotated=False):
    make_mp4(path, rotated=rotated)
    data = bytearray(open(path, "rb").read())
    data[8:12] = brand
    open(path, "wb").write(bytes(data))


def _mp4_lying_stts(path):
    make_mp4(path)
    data = bytearray(open(path, "rb").read())
    i = data.find(b"stts")
    data[i + 8:i + 12] = (0xFFFFFFFF).to_bytes(4, "big")
    open(path, "wb").write(bytes(data))


def _mp4_empty_moov(path):
    with open(path, "wb") as f:
        f.write(box(b"ftyp", b"isom\x00\x00\x02\x00") + box(b"moov", b""))


def _webm(path):
    make_mkv(path)
    data = open(path, "rb").read().replace(b"matroska", b"webm\x00\x00\x00\x00")
    open(path, "wb").write(data)


def _mkv_nonminimal(path):
    header = el(0x1A45DFA3, el(0x4282, b"matroska"))
    video_el = el(0xE0, el(0xB0, (640).to_bytes(2, "big")) + el(0xBA, (480).to_bytes(2, "big")))
    vbody = el(0x83, b"\x01") + el(0x86, b"V_VP9") + video_el
    vbody += b"\xec" + bytes([0x80 | (127 - len(vbody) - 2)]) + b"\x00" * (127 - len(vbody) - 2)
    vtrack = _ebml_id(0xAE) + b"\x40\x7f" + vbody
    audio_el = el(0xE1, el(0xB5, struct.pack(">f", 22050.0)) + el(0x9F, b"\x01"))
    atrack = el(0xAE, el(0x83, b"\x02") + el(0x86, b"A_OPUS") + audio_el)
    seg = el(0x18538067, el(0x1549A966, el(0x4489, struct.pack(">d", 1000.0)))
             + el(0x1654AE6B, vtrack + atrack))
    open(path, "wb").write(header + seg)


def _mkv_unknown_size(path):
    make_mkv(path)
    data = open(path, "rb").read()
    i = data.find((0x18538067).to_bytes(4, "big")) + 4
    slen = 1 if data[i] & 0x80 else 5
    open(path, "wb").write(data[:i] + b"\x01\xff\xff\xff\xff\xff\xff\xff" + data[i + slen:])


def _bytes(payload):
    def write(path):
        open(path, "wb").write(payload)
    return write


WRITERS = {
    "pcm.wav": lambda p: make_wav(p, seconds=1.5, rate=8000, channels=1),
    "stereo.wave": lambda p: make_wav(p, seconds=0.5, rate=22050, channels=2),
    "plain.flac": _flac,
    "picture.flac": lambda p: _flac(p, 22050, 1, 24, 22050, picture=1 << 16),
    "cbr.mp3": lambda p: _mp3(p, id3=10),
    "xing.mp3": lambda p: _mp3(p, xing=250),
    "mpeg25.mp3": lambda p: _mp3(p, header=b"\xff\xe2\x98\x00", frame_len=104, frames=50),
    "big_id3.mp3": lambda p: _mp3(p, id3=300 * 1024, frames=40),
    "vorbis.ogg": _ogg,
    "negative.oga": lambda p: _ogg(p, granules=(48000, -1)),
    "voice.opus": lambda p: _ogg(p, codec="opus", granules=(96000,)),
    "mjpeg.avi": _avi,
    "movie.mp4": make_mp4,
    "rotated.mp4": lambda p: make_mp4(p, rotated=True),
    "cover.m4v": make_mp4_with_cover,
    "quicktime.mov": lambda p: _mp4_branded(p, b"qt  ", rotated=True),
    "song.m4a": lambda p: _mp4_branded(p, b"M4A "),
    "phone.3gp": lambda p: _mp4_branded(p, b"3gp5"),
    "lying_stts.mp4": _mp4_lying_stts,
    "empty_moov.mp4": _mp4_empty_moov,
    "movie.mkv": make_mkv,
    "cover.mkv": make_mkv_with_attachment,
    "clip.webm": _webm,
    "nonminimal.mkv": _mkv_nonminimal,
    "streamed.mkv": _mkv_unknown_size,
    "garbage.wav": _bytes(b"RIFF" + bytes(40)),
    "garbage.flac": _bytes(b"not a flac"),
    "garbage.mp3": _bytes(b"\xff\xfb" + bytes(400)),
    "garbage.ogg": _bytes(b"OggS" + bytes(30)),
    "garbage.avi": _bytes(b"RIFF\x10\x00\x00\x00AVI LIST" + bytes(8)),
    "garbage.mp4": _bytes(bytes(600)),
    "garbage.mkv": _bytes(bytes(100)),
    "unknown.xyz": _bytes(b"whatever"),
    "empty.wav": _bytes(b""),
}
TRUNCATED = ("pcm.wav", "plain.flac", "cbr.mp3", "vorbis.ogg", "mjpeg.avi", "movie.mp4",
             "cover.mkv", "quicktime.mov")
FIXTURES = sorted([os.path.join("video", n) for n in os.listdir(os.path.join(FIX, "video"))]
                  + [os.path.join("h264", n) for n in os.listdir(os.path.join(FIX, "h264"))
                     if not n.endswith(".npz")])


@pytest.fixture(autouse=True)
def _self_hosted(monkeypatch):
    """The self-hosted route in both packages, whatever PATH holds."""
    for gate in (jax_video.available, video.available):
        gate.cache_clear()
    monkeypatch.setattr(jax_av, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(avmetadata, "ffmpeg_available", lambda: False)
    yield
    for gate in (jax_video.available, video.available):
        gate.cache_clear()


@pytest.fixture(params=["opencv", "parsers"])
def probes(request, monkeypatch):
    """OpenCV's probe merged in where it imports, and the parsers alone,
    as on a host without it."""
    if request.param == "parsers" or not video.cv2_available():
        monkeypatch.setattr(jax_video, "cv2_available", lambda: False)
        monkeypatch.setattr(video, "cv2_available", lambda: False)
    return request.param


def _row(module, path):
    info = module.probe_media(path)
    return None if info is None else json.dumps(info.to_dict())


def _both(path):
    want, got = _row(jax_av, path), _row(avmetadata, path)
    assert got == want
    return got


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_stream_data_equals_the_jax_rows(tmp_path, name, probes):
    path = str(tmp_path / name)
    WRITERS[name](path)
    row = _both(path)
    if not name.startswith(("garbage", "unknown", "empty")):
        assert row is not None and json.loads(row)


@pytest.mark.parametrize("name", TRUNCATED)
@pytest.mark.parametrize("cut", (0.5, 0.1, 12))
def test_truncated_containers_read_as_the_jax_package_reads_them(tmp_path, name, cut, probes):
    whole = str(tmp_path / ("whole." + name.rsplit(".", 1)[1]))
    WRITERS[name](whole)
    data = open(whole, "rb").read()
    n = int(len(data) * cut) if cut < 1 else cut
    path = str(tmp_path / name)
    open(path, "wb").write(data[:n])
    _both(path)


@pytest.mark.parametrize("rel", FIXTURES)
def test_committed_video_fixtures(rel, probes):
    _both(os.path.join(FIX, rel))


def test_parsers_return_the_jax_parsers_dicts(tmp_path):
    from spacedrive_tpu.media import audio as jax_audio
    from spacedrive_tpu.media import mkv as jax_mkv
    from spacedrive_tpu.media import mp4meta as jax_mp4

    for name in sorted(WRITERS):
        path = str(tmp_path / name)
        WRITERS[name](path)
        assert audio.parse_stream_info(path) == jax_audio.parse_stream_info(path), name
        if name.endswith((".mp4", ".m4v", ".mov", ".m4a", ".3gp")):
            assert mp4meta.parse_mp4(path) == jax_mp4.parse_mp4(path), name
            assert mp4meta.mp4_cover_art(path) == jax_mp4.mp4_cover_art(path), name
        if name.endswith((".mkv", ".webm")):
            assert mkv.parse_mkv(path) == jax_mkv.parse_mkv(path), name
            assert mkv.mkv_attachment_image(path) == jax_mkv.mkv_attachment_image(path), name
    assert audio.AUDIO_EXTENSIONS == jax_audio.AUDIO_EXTENSIONS
    assert set(audio._PARSERS) == set(jax_audio._PARSERS)


# -- the ffprobe route and the ffmpeg thumbnail route -------------------------


FFPROBE = {
    "side_data": {"format": {"format_name": "mov,mp4,m4a", "duration": "12.500000",
                             "bit_rate": "812345"},
                  "streams": [{"codec_type": "video", "width": 1080, "height": 1920,
                               "codec_name": "h264", "avg_frame_rate": "30000/1001",
                               "side_data_list": [{"rotation": -90}]},
                              {"codec_type": "audio", "codec_name": "aac",
                               "sample_rate": "44100", "channels": 2},
                              {"codec_type": "video", "width": 10, "height": 10}]},
    "tags_rotate": {"format": {"format_name": "matroska,webm", "duration": "n/a"},
                    "streams": [{"codec_type": "video", "width": 640, "height": 360,
                                 "codec_name": "vp9", "avg_frame_rate": "0/0",
                                 "tags": {"rotate": "180"}},
                                {"codec_type": "audio", "codec_name": "opus",
                                 "sample_rate": "0", "channels": 1}]},
    "audio_only": {"format": {"format_name": "wav", "duration": "1.5", "bit_rate": "x"},
                   "streams": [{"codec_type": "audio", "codec_name": "pcm_s16le",
                                "sample_rate": "8000", "channels": 1}]},
    "bad_rotation": {"format": {}, "streams": [{"codec_type": "video", "width": 4,
                                                "height": 4, "tags": {"rotate": "sideways"}}]},
}


@pytest.fixture
def fake_ff(tmp_path, monkeypatch):
    """`ffprobe` printing $FAKE_PROBE (or failing), `ffmpeg` copying
    $FAKE_FRAME to its last argument, first on PATH; the gates re-read."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    scripts = {
        "ffprobe": '#!/bin/sh\n[ -n "$FAKE_PROBE_FAIL" ] && exit 1\ncat "$FAKE_PROBE"\n',
        "ffmpeg": '#!/bin/sh\nfor last; do :; done\ncp "$FAKE_FRAME" "$last"\n',
    }
    for name, text in scripts.items():
        p = bin_dir / name
        p.write_text(text)
        p.chmod(p.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(jax_av, "ffmpeg_available", jax_video.available)
    monkeypatch.setattr(avmetadata, "ffmpeg_available", video.available)
    for gate in (jax_video.available, video.available):
        gate.cache_clear()
    assert jax_video.available() and video.available()
    return tmp_path


@pytest.mark.parametrize("case", sorted(FFPROBE) + ["not_json", "fails"])
def test_the_ffprobe_route(fake_ff, monkeypatch, case):
    probe = fake_ff / "probe.json"
    probe.write_text(json.dumps(FFPROBE[case]) if case in FFPROBE else "{not json")
    monkeypatch.setenv("FAKE_PROBE", str(probe))
    if case == "fails":
        monkeypatch.setenv("FAKE_PROBE_FAIL", "1")
    path = str(fake_ff / "clip.mp4")
    make_mp4(path)
    row = _both(path)
    assert (row is None) == (case in ("not_json", "fails"))
    assert avmetadata.probeable_extensions() == jax_av.probeable_extensions()


def test_the_ffmpeg_thumbnail_route_seals_what_ffmpeg_wrote(fake_ff, monkeypatch):
    frame = fake_ff / "frame.webp"
    frame.write_bytes(b"RIFF\x10\x00\x00\x00WEBPVP8 fake frame")
    probe = fake_ff / "probe.json"
    probe.write_text(json.dumps(FFPROBE["side_data"]))
    monkeypatch.setenv("FAKE_FRAME", str(frame))
    monkeypatch.setenv("FAKE_PROBE", str(probe))
    src = str(fake_ff / "clip.mkv")
    make_mkv(src)
    outs = [str(fake_ff / "jax" / "t.webp"), str(fake_ff / "port" / "t.webp")]
    assert jax_video.generate_video_thumbnail(src, outs[0]) == outs[0]
    assert video.generate_video_thumbnail(src, outs[1]) == outs[1]
    assert open(outs[1], "rb").read() == open(outs[0], "rb").read() == frame.read_bytes()
    assert not os.path.exists(outs[1] + ".tmp")
    # An empty frame falls through to the chain: no cover art here, None.
    frame.write_bytes(b"")
    assert video.generate_video_thumbnail(src, outs[1] + "2") is None
    assert jax_video.generate_video_thumbnail(src, outs[0] + "2") is None


def test_extension_sets_and_gates_live_in_video(fake_ff):
    from spacedrive_tpu.media import thumbnail as jax_thumb
    from spacedrive_tpu_torch.media import thumbnail

    assert video.VIDEO_EXTENSIONS == jax_video.VIDEO_EXTENSIONS
    assert video._COVER_EXTENSIONS == jax_video._COVER_EXTENSIONS
    assert video._H264_TS_EXTENSIONS == jax_video._H264_TS_EXTENSIONS
    # With ffmpeg on PATH every video container is thumbnailable and every
    # audio extension probeable, in both packages.
    assert thumbnail.thumbnailable_extensions() == jax_thumb.thumbnailable_extensions()
    assert avmetadata.probeable_extensions() == jax_av.probeable_extensions()
    assert video.VIDEO_EXTENSIONS <= thumbnail.thumbnailable_extensions()
