"""Durable writes of files beside the database: the thumbnail cache.

Port of the part of ``spacedrive_tpu/persist.py`` the media plane uses:
``atomic_write`` (a same-directory tmp file, flushed, fsynced where the
artifact's policy says so, renamed into place, its directory fsynced where
the policy says so), ``seal`` (the same tail for a tmp file another
program streamed: ffmpeg's video frame) and the artifacts they write,
``media.thumbnail``, ``media.thumbs_version``, ``node.config``, and the
backup restore's ``library.db_image`` and ``library.config``, under the
JAX package's names and policies.
The rest of that module (the WAL writers, scratch trees, crash points and
the artifact table) is not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

@dataclass(frozen=True)
class Artifact:
    name: str
    path_pattern: str
    fsync: str  # always | file-only | none


ARTIFACTS: Dict[str, Artifact] = {
    a.name: a for a in (
        # A regenerable cache: a power loss costs a re-encode, not
        # correctness; the rename keeps readers off torn webp bytes.
        Artifact("media.thumbnail", "thumbnails/<shard>/<cas_id>.webp", "none"),
        Artifact("media.thumbs_version", "thumbnails/version.txt", "none"),
        # Old-or-new after any crash: the node re-reads the surviving JSON.
        Artifact("node.config", "node_state.sdconfig", "always"),
        Artifact("library.config", "libraries/<uuid>.sdlibrary", "always"),
        # A backup restore re-runs from the zip; it writes the db before the
        # config, so a config never points at an absent db.
        Artifact("library.db_image", "libraries/<uuid>.db (backup restore)", "always"),
    )
}


def artifact(name: str) -> Artifact:
    try:
        return ARTIFACTS[name]
    except KeyError:
        raise KeyError(f"undeclared artifact {name!r}") from None


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(name: str, path: str, data) -> str:
    """Write `data` (bytes or str) to `path` under artifact `name`'s
    policy: same-dir tmp → flush → fsync(file) → atomic replace →
    fsync(dir)."""
    a = artifact(name)
    if isinstance(data, str):
        data = data.encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if a.fsync in ("always", "file-only"):
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if a.fsync == "always":
        _fsync_dir(os.path.dirname(path))
    return path


def seal(name: str, tmp_path: str, final_path: str) -> str:
    """Seal a streamed body: the caller (or a program it ran) wrote
    `tmp_path`; this applies artifact `name`'s tail — fsync(file) per
    policy → atomic replace → fsync(dir) — so a crash never leaves a
    truncated file that passes for a valid artifact."""
    a = artifact(name)
    if a.fsync in ("always", "file-only"):
        fd = os.open(tmp_path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp_path, final_path)
    if a.fsync == "always":
        _fsync_dir(os.path.dirname(final_path))
    return final_path
