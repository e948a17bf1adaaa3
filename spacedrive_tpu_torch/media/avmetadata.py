"""Audio/video stream metadata: the rows the media job writes as
``media_data.stream_data``.

Port of ``spacedrive_tpu/media/avmetadata.py``. The typed rows fill from
`ffprobe` when it exists (media/video.py gates), and otherwise from the
self-hosted container parsers (media/audio.py: WAV/FLAC/MP3/OGG/Opus/
AVI; media/mp4meta.py: MP4/MOV/M4A/3GP; media/mkv.py: MKV/WebM), with
OpenCV's probe filling the dimensions, duration and fps of a video
container those parsers read no stream facts from. The row's JSON is the
JAX package's byte for byte on the same file in the same runtime.
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import asdict, dataclass
from typing import Optional

from .video import available as ffmpeg_available


@dataclass
class StreamMetadata:
    duration_seconds: Optional[float] = None
    bitrate: Optional[int] = None
    format_name: Optional[str] = None
    brand: Optional[str] = None          # ISO-BMFF major brand
    # video stream
    width: Optional[int] = None
    height: Optional[int] = None
    fps: Optional[float] = None
    video_codec: Optional[str] = None
    rotation: Optional[int] = None       # display rotation, degrees CW
    # audio stream
    audio_codec: Optional[str] = None
    sample_rate: Optional[int] = None
    channels: Optional[int] = None
    bits_per_sample: Optional[int] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}


def probeable_extensions() -> set:
    """Audio/video extensions probe_media can actually read in THIS
    runtime: everything when ffprobe exists, all video plus the
    self-hosted audio formats when cv2's bundled libavcodec exists,
    else just the self-hosted parsers' formats — keeps the media job
    from re-probing thousands of deterministically-unreadable files on
    every run."""
    from .audio import AUDIO_EXTENSIONS, _PARSERS
    from .video import VIDEO_EXTENSIONS, cv2_available

    if ffmpeg_available():
        return set(AUDIO_EXTENSIONS) | set(VIDEO_EXTENSIONS)
    if cv2_available():
        return set(_PARSERS) | set(VIDEO_EXTENSIONS)
    return set(_PARSERS)


def _cv2_stream_metadata(path: str) -> Optional[StreamMetadata]:
    """Video-stream facts via cv2's bundled libavcodec (duration, fps,
    dimensions) for containers the self-hosted parsers can't read —
    the metadata twin of the cv2 thumbnail backend."""
    from .video import VIDEO_EXTENSIONS, cv2_probe

    import os

    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext not in VIDEO_EXTENSIONS:
        return None
    info = cv2_probe(path)
    if not info:
        return None
    md = StreamMetadata()
    md.duration_seconds = info.get("duration_seconds")
    md.width = info.get("width")
    md.height = info.get("height")
    md.fps = info.get("fps")
    return md


def probe_media(path: str) -> Optional[StreamMetadata]:
    """ffprobe (when installed), else the self-hosted parsers with a
    cv2 fallback for video containers they can't read → StreamMetadata;
    None when nothing can read the container."""
    if not ffmpeg_available():
        from .audio import parse_stream_info

        info = parse_stream_info(path)
        if info is None:
            return _cv2_stream_metadata(path)
        md = StreamMetadata()
        for k, v in info.items():
            # Parser keys are the dataclass fields; a mismatch is a bug,
            # not something to silently drop.
            setattr(md, k, v)
        if md.width is None and md.duration_seconds is None:
            # Parser read the container but got no stream facts (e.g. a
            # codec it can't inspect) — decode-probe with cv2 and MERGE:
            # the parser's container facts (format_name, brand, codecs)
            # must survive alongside cv2's dimensions/duration/fps.
            cv = _cv2_stream_metadata(path)
            if cv is not None:
                for name in ("duration_seconds", "width", "height", "fps"):
                    if getattr(md, name) is None:
                        setattr(md, name, getattr(cv, name))
        return md
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "quiet", "-print_format", "json",
             "-show_format", "-show_streams", path],
            capture_output=True, timeout=30, check=True)
        raw = json.loads(out.stdout)
    except Exception:
        return None
    md = StreamMetadata()
    fmt = raw.get("format", {})
    md.format_name = fmt.get("format_name")
    try:
        md.duration_seconds = float(fmt["duration"])
    except (KeyError, ValueError):
        pass
    try:
        md.bitrate = int(fmt["bit_rate"])
    except (KeyError, ValueError):
        pass
    for stream in raw.get("streams", []):
        if stream.get("codec_type") == "video" and md.width is None:
            md.width = stream.get("width")
            md.height = stream.get("height")
            md.video_codec = stream.get("codec_name")
            rate = stream.get("avg_frame_rate", "0/1")
            try:
                num, _, den = rate.partition("/")
                md.fps = float(num) / float(den or 1)
            except (ValueError, ZeroDivisionError):
                pass
            # display rotation: modern ffprobe puts it in side_data,
            # older ones in tags.rotate — keep parity with the
            # self-hosted mp4 parser's matrix-derived field
            try:
                rot = None
                for sd in stream.get("side_data_list", []):
                    if "rotation" in sd:
                        # side_data reports CCW (a portrait iPhone clip
                        # is -90); our field is degrees CW like the
                        # tkhd matrix and legacy tags.rotate
                        rot = -int(sd["rotation"])
                if rot is None and "rotate" in stream.get("tags", {}):
                    rot = int(stream["tags"]["rotate"])
                if rot is not None:
                    md.rotation = rot % 360 or None
            except (TypeError, ValueError):
                pass
        elif stream.get("codec_type") == "audio" and md.audio_codec is None:
            md.audio_codec = stream.get("codec_name")
            try:
                md.sample_rate = int(stream.get("sample_rate", 0)) or None
            except ValueError:
                pass
            md.channels = stream.get("channels")
    return md
