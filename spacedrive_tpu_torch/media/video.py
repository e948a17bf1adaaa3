"""Video thumbnailing: any-codec decode via ffmpeg CLI or OpenCV's
bundled libavcodec, self-hosted parsers as the library-free floor.

Port of ``spacedrive_tpu/media/video.py``: the same gates, extension sets
and chain of decode backends, best available first:

1. `ffmpeg`/`ffprobe` CLIs when installed;
2. `cv2.VideoCapture` where OpenCV imports (its wheels bundle
   libavcodec: CABAC Main/High H.264, HEVC, VP9, ...);
3. the self-hosted from-spec decoders — MJPEG-AVI (media/mjpeg.py)
   and baseline-CAVLC H.264 in MP4/TS (media/h264.py, mpegts.py);
4. embedded cover art (MP4 `covr`, Matroska attachments).

Where the JAX routes hand a PIL image to ``thumbnail.encode_webp``, the
port's hand (pixels, mode) to its own tail: a JPEG frame or a cover image
through ``imgdecode.decode_image``, an H.264 frame as the RGB of
``h264.yuv420_to_rgb``. A codec nothing in the chain handles degrades to
None. A route's failure moves on down the chain as in the JAX package,
except a fault of the port's native plane (its build or load), which
raises.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from functools import lru_cache
from typing import Optional

from .. import persist

SEEK_PERCENTAGE = 0.10  # thumbnailer.rs seek to 10%
# Containers the self-hosted MJPEG parser handles without ffmpeg.
MJPEG_EXTENSIONS = {"avi"}
VIDEO_EXTENSIONS = {
    "mp4", "mkv", "mov", "avi", "webm", "m4v", "mpg", "mpeg", "wmv",
    "flv", "3gp", "ts", "mts", "m2ts", "ogv",
}
_COVER_EXTENSIONS = {"mp4", "m4v", "mov", "m4a", "3gp", "mkv", "webm"}
_H264_MP4_EXTENSIONS = {"mp4", "m4v", "mov", "3gp"}
_H264_TS_EXTENSIONS = {"ts", "mts", "m2ts"}


@lru_cache(maxsize=1)
def available() -> bool:
    return (shutil.which("ffmpeg") is not None
            and shutil.which("ffprobe") is not None)


@lru_cache(maxsize=1)
def cv2_available() -> bool:
    """OpenCV with its bundled ffmpeg videoio — the any-codec decode
    backend when no ffmpeg CLI is installed."""
    try:
        import cv2  # noqa: F401

        return True
    except Exception:
        return False


def cv2_probe(path: str) -> Optional[dict]:
    """Container probe via cv2: duration / fps / dimensions / frames.
    Returns None when cv2 is absent or cannot open the file."""
    if not cv2_available():
        return None
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            return None
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        frames = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0
        out = {
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or None,
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or None,
            "fps": round(fps, 3) or None,
            "frame_count": int(frames) or None,
            "duration_seconds": (round(frames / fps, 3)
                                 if fps > 0 and frames > 0 else None),
        }
        return out if any(v for v in out.values()) else None
    finally:
        cap.release()


def probe_duration(path: str) -> Optional[float]:
    """Container duration in seconds, or None."""
    if available():
        try:
            out = subprocess.run(
                ["ffprobe", "-v", "quiet", "-print_format", "json",
                 "-show_format", path],
                capture_output=True, timeout=30, check=True)
            return float(json.loads(out.stdout)["format"]["duration"])
        except Exception:
            return None
    info = cv2_probe(path)
    return info.get("duration_seconds") if info else None


def _native_fault(e: Exception) -> bool:
    """Whether `e` is a fault of the native plane (a library that does not
    build or load), which raises where a file's own fault degrades."""
    return isinstance(e, (RuntimeError, OSError)) and not isinstance(
        e, (FileNotFoundError, IsADirectoryError, PermissionError))


def _encode(pixels, mode: str, out_path: str, target_px: float, native: bool) -> str:
    from .thumbnail import encode_webp

    return encode_webp(pixels, mode, out_path, native=native, target_px=target_px)


def _mjpeg_thumbnail(input_path: str, out_path: str, target_px: float,
                     native: bool = True) -> Optional[str]:
    """ffmpeg-free path: extract the 10% frame of an MJPEG AVI and webp
    it (media/mjpeg.py). Returns None for non-MJPEG containers."""
    from .imgdecode import decode_image
    from .mjpeg import frame_at_fraction

    try:
        jpeg = frame_at_fraction(input_path, SEEK_PERCENTAGE)
        if jpeg is None:
            return None
        return _encode(*decode_image(jpeg, native=native), out_path, target_px, native)
    except Exception as e:
        if _native_fault(e):
            raise
        return None


def _is_mjpeg_candidate(path: str) -> bool:
    return (os.path.splitext(path)[1].lstrip(".").lower()
            in MJPEG_EXTENSIONS)


def _h264_thumbnail(input_path: str, out_path: str, target_px: float,
                    native: bool = True) -> Optional[str]:
    """Self-hosted H.264 path: decode the IDR nearest 10% with the
    from-spec baseline-I decoder (media/h264.py) and webp it — MP4
    family via the sample tables, transport streams via the TS demux
    (media/mpegts.py). Returns None for non-H.264 files or streams
    outside the baseline-I subset (CABAC, high profile) — the caller
    then tries cover art."""
    from .h264 import keyframe_from_mp4, yuv420_to_rgb

    ext = os.path.splitext(input_path)[1].lstrip(".").lower()
    if ext in _H264_MP4_EXTENSIONS:
        grab = keyframe_from_mp4
    elif ext in _H264_TS_EXTENSIONS:
        from .mpegts import keyframe_from_ts as grab
    else:
        return None
    try:
        planes = grab(input_path, SEEK_PERCENTAGE)
        if planes is None:
            return None
        return _encode(yuv420_to_rgb(*planes), "RGB", out_path, target_px, native)
    except Exception as e:
        if _native_fault(e):
            raise
        return None


def _cv2_thumbnail(input_path: str, out_path: str, target_px: float,
                   native: bool = True) -> Optional[str]:
    """Decode the frame at 10% with cv2's bundled libavcodec and webp
    it — the any-codec backend. Seeks by frame index when the container
    reports a frame count, else reads the first frame. Returns None when
    cv2 is absent or its ffmpeg can't decode the stream — the caller
    continues down the self-hosted chain."""
    if not cv2_available():
        return None
    import cv2

    cap = cv2.VideoCapture(input_path)
    try:
        if not cap.isOpened():
            return None
        frames = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0
        if frames > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES,
                    int(frames * SEEK_PERCENTAGE))
        ok, frame = cap.read()
        if not ok and frames > 0:
            # Seek landed outside the decodable range (some containers
            # report wrong counts) — retry from the start.
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, frame = cap.read()
        if not ok or frame is None or frame.size == 0:
            return None
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return _encode(rgb, "RGB", out_path, target_px, native)
    except Exception as e:
        if _native_fault(e):
            raise
        return None
    finally:
        cap.release()


def _cover_art_thumbnail(input_path: str, out_path: str, target_px: float,
                         native: bool = True) -> Optional[str]:
    """Decoder-free fallback for H.264/HEVC containers: embedded cover
    art (iTunes `covr` in MP4, image attachments in Matroska — the
    cover.jpg convention of movie files). Returns None when absent."""
    from .imgdecode import decode_image

    ext = os.path.splitext(input_path)[1].lstrip(".").lower()
    if ext not in _COVER_EXTENSIONS:
        return None
    try:
        if ext in ("mkv", "webm"):
            from .mkv import mkv_attachment_image

            blob = mkv_attachment_image(input_path)
        else:
            from .mp4meta import mp4_cover_art

            blob = mp4_cover_art(input_path)
        if not blob:
            return None
        return _encode(*decode_image(blob, native=native), out_path, target_px, native)
    except Exception as e:
        if _native_fault(e):
            raise
        return None


def _fallback_chain(input_path: str, out_path: str, target_px: float,
                    native: bool = True) -> Optional[str]:
    """The ffmpeg-CLI-less backend chain, best decoder first (module
    docstring): cv2's libavcodec → self-hosted MJPEG-AVI → self-hosted
    CAVLC H.264 (MP4/TS) → embedded cover art."""
    return (_cv2_thumbnail(input_path, out_path, target_px, native)
            or (_mjpeg_thumbnail(input_path, out_path, target_px, native)
                if _is_mjpeg_candidate(input_path) else None)
            or _h264_thumbnail(input_path, out_path, target_px, native)
            or _cover_art_thumbnail(input_path, out_path, target_px, native))


def generate_video_thumbnail(input_path: str, out_path: str,
                             target_px: float = 262144.0, *,
                             native: bool = True) -> Optional[str]:
    """Seek 10%, grab one frame, scale to ~target_px, encode webp.

    Returns out_path on success, None when no decoder in the backend
    chain (module docstring) applies."""
    if not available():
        return _fallback_chain(input_path, out_path, target_px, native)
    from .thumbnail import TARGET_QUALITY, scale_dimensions

    duration = probe_duration(input_path) or 0.0
    seek = duration * SEEK_PERCENTAGE
    # ~512×512-equivalent area; ffmpeg keeps aspect via -2.
    w, _ = scale_dimensions(1024, 1024, target_px)
    tmp = out_path + ".tmp"
    try:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        # -f webp: the muxer cannot be inferred from the ".tmp" name.
        subprocess.run(
            ["ffmpeg", "-v", "quiet", "-ss", f"{seek:.3f}",
             "-i", input_path, "-frames:v", "1",
             "-vf", f"scale='min({w},iw)':-2",
             "-quality", str(TARGET_QUALITY), "-f", "webp", "-y", tmp],
            capture_output=True, timeout=60, check=True)
        if not os.path.getsize(tmp):
            raise ValueError("empty frame")
        # ffmpeg streamed the frame into the tmp; seal applies the
        # declared atomic-replace tail so readers never see torn webp.
        persist.seal("media.thumbnail", tmp, out_path)
        return out_path
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return _fallback_chain(input_path, out_path, target_px, native)
