"""Which audio and video files the media job probes, in this runtime.

The part of ``spacedrive_tpu/media/avmetadata.py`` (with the extension
sets of ``media/audio.py`` and ``media/video.py``) the media job's row
selection needs: ``probeable_extensions`` gives the JAX package's set in the
same runtime (ffmpeg and ffprobe on ``PATH``, or OpenCV importable). The
probes themselves, and the video thumbnails, are the second media slice's:
the job records those files as not ported yet.
"""

from __future__ import annotations

import shutil
from functools import lru_cache

AUDIO_EXTENSIONS = {"wav", "flac", "mp3", "ogg", "opus", "m4a", "aac", "wma", "aiff"}
# The self-hosted container parsers of media/audio.py, by extension.
PARSED_EXTENSIONS = {"wav", "wave", "flac", "mp3", "ogg", "oga", "opus", "avi", "mp4", "m4v",
                     "mov", "m4a", "3gp", "mkv", "webm"}
VIDEO_EXTENSIONS = {
    "mp4", "mkv", "mov", "avi", "webm", "m4v", "mpg", "mpeg", "wmv",
    "flv", "3gp", "ts", "mts", "m2ts", "ogv",
}
COVER_EXTENSIONS = {"mp4", "m4v", "mov", "m4a", "3gp", "mkv", "webm"}
H264_TS_EXTENSIONS = {"ts", "mts", "m2ts"}


@lru_cache(maxsize=1)
def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


@lru_cache(maxsize=1)
def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except Exception:
        return False


def probeable_extensions() -> set:
    """Audio/video extensions the JAX package's probe reads in this
    runtime: all with ffprobe, the parsed set and all video with OpenCV,
    else the parsed set."""
    if ffmpeg_available():
        return AUDIO_EXTENSIONS | VIDEO_EXTENSIONS
    if cv2_available():
        return PARSED_EXTENSIONS | VIDEO_EXTENSIONS
    return set(PARSED_EXTENSIONS)
