"""Location CRUD + scan orchestration: the port's entry point.

Port of ``spacedrive_tpu/locations/manager.py`` (upstream
core/src/location/mod.rs): ``create_location`` writes the location row
through sync and attaches indexer rules, ``delete_location`` and
``relink_location`` delete it or point it at a moved directory; ``scan_location`` chains
``IndexerJob`` → ``FileIdentifierJob`` (→ ``MediaProcessorJob`` with
``with_media``) through the job builder (mod.rs:417-445); ``scan_location_sub_path`` rescans one directory and
what lies under it; ``light_scan_location`` (``locations/shallow.py``)
rescans one directory inline, the watcher's path. The chain's jobs pause,
resume, cancel and cold-resume through ``jobs/manager.py``.

The identifier's ``backend`` defaults to ``"cuda"`` (the hand-written
BLAKE3 kernel on the card) and the chain is refused at once where CUDA is
absent. ``with_media`` defaults to True, as in the JAX package: the media
job's rows and thumbnails (images, audio and video probes, video frames,
cover art, SVG, PDF) follow the identifier; its thumbnails need
``data_dir`` in the manager's services.
The sub-path rescan chains no media job, in the JAX package as here, so it
refuses ``with_media=True``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

from ..jobs.manager import JobBuilder, JobManager
from ..media.processor import MediaProcessorJob
from ..objects.identifier import FileIdentifierJob
from ..store import uuid_bytes
from .indexer_job import IndexerJob
from .shallow import light_scan_location

__all__ = ["LocationError", "create_location", "delete_location", "light_scan_location",
           "relink_location", "scan_location", "scan_location_sub_path"]


class LocationError(Exception):
    pass


def create_location(library, path: str, indexer_rule_ids: Sequence[int] = (),
                    name: Optional[str] = None) -> int:
    """Create a location row (+ its sync op) for a directory: the path must
    exist, be a directory, and not nest with an existing location."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise LocationError(f"{path} is not a directory")
    for row in library.db.run("location.paths"):
        other = row["path"] or ""
        if other and (path == other
                      or path.startswith(other.rstrip("/") + "/")
                      or other.startswith(path.rstrip("/") + "/")):
            raise LocationError(f"{path} overlaps existing location {other}")
    pub_id = uuid_bytes()
    name = name or os.path.basename(path) or path
    sync = library.sync
    ops = sync.shared_create("location", pub_id, {
        "name": name, "path": path, "date_created": int(time.time()),
    })
    with sync.write_ops(ops) as conn:
        loc_id = library.db.insert("location", {
            "pub_id": pub_id, "name": name, "path": path,
            "date_created": int(time.time()),
            "instance_id": sync._instance_row_id(sync.instance, conn),
        }, conn=conn)
        for rid in indexer_rule_ids:
            library.db.insert("indexer_rule_in_location", {
                "location_id": loc_id, "indexer_rule_id": rid,
            }, conn=conn)
    return loc_id


def delete_location(library, location_id: int) -> None:
    """Delete a location row through sync (its file paths cascade)."""
    row = library.db.run("location.pub_by_id", (location_id,))
    if row is None:
        raise LocationError("no such location")
    with library.sync.write_ops(
            [library.sync.shared_delete("location", row["pub_id"])]) as conn:
        library.db.delete("location", location_id, conn=conn)


def relink_location(library, location_id: int, new_path: str) -> None:
    """Point a location at a moved directory (location/mod.rs relink)."""
    new_path = os.path.abspath(new_path)
    if not os.path.isdir(new_path):
        raise LocationError(f"{new_path} is not a directory")
    row = library.db.run("location.pub_by_id", (location_id,))
    if row is None:
        raise LocationError("no such location")
    with library.sync.write_ops([library.sync.shared_update(
            "location", row["pub_id"], "path", new_path)]) as conn:
        library.db.update("location", location_id, {"path": new_path}, conn=conn)


async def scan_location(jobs: JobManager, library, location_id: int,
                        backend: str = "cuda", with_media: bool = True) -> bytes:
    """Full rescan: the indexer → identifier chain, and the media processor
    after it with `with_media` (location/mod.rs:417-445). Returns the
    indexer's job id; ``jobs.wait_idle()`` waits for the chain."""
    builder = JobBuilder(IndexerJob(location_id=location_id)).queue_next(
        FileIdentifierJob(location_id=location_id, backend=backend))
    if with_media:
        builder = builder.queue_next(MediaProcessorJob(location_id=location_id))
    return await builder.spawn(jobs, library)


async def scan_location_sub_path(jobs: JobManager, library, location_id: int,
                                 sub_path: str, backend: str = "cuda",
                                 with_media: bool = False) -> bytes:
    """Rescan of one directory of a location and what lies under it."""
    if with_media:
        raise NotImplementedError(
            "with_media=True: the sub-path rescan chains no media job, in the "
            "JAX package as here; run MediaProcessorJob(sub_path=...) itself")
    builder = JobBuilder(IndexerJob(location_id=location_id, sub_path=sub_path)) \
        .queue_next(FileIdentifierJob(location_id=location_id, sub_path=sub_path,
                                      backend=backend))
    return await builder.spawn(jobs, library)
