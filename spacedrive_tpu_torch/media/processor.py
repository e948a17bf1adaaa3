"""MediaProcessorJob: media-data extraction and thumbnails in one pass.

Port of ``spacedrive_tpu/media/processor.py`` (upstream
media_processor/job.rs): the location's media files in steps of
BATCH_SIZE = 10, EXIF into ``media_data`` rows (``media/exif.py``) and WebP
thumbnails keyed by cas_id (``media/thumbnail.py``, through the manager's
thumbnailer where it has one, else inline). An audio or video file's row
is its probe (``media/avmetadata.probe_media``) as ``stream_data`` JSON.
The row selection and the metadata keys are the JAX job's, so a library
reads the same to both.
"""

from __future__ import annotations

import asyncio
import json
from typing import List, Optional

from ..jobs.job import EarlyFinish, JobContext, StatefulJob, StepOutcome, register_job
from ..locations.paths import IsolatedPath
from ..store import statements
from .avmetadata import probe_media, probeable_extensions
from .exif import MEDIA_DATA_EXTENSIONS, extract_media_data
from .thumbnail import ensure_thumbnail_dir, generate_thumbnail, thumbnailable_extensions

BATCH_SIZE = 10  # media_processor/job.rs:34


@register_job
class MediaProcessorJob(StatefulJob):
    NAME = "media_processor"
    IS_BATCHED = True

    def __init__(self, *, location_id: int, sub_path: Optional[str] = None):
        super().__init__(location_id=location_id, sub_path=sub_path)
        self.location_id = location_id
        self.sub_path = sub_path

    def _init_sync(self, ctx: JobContext):
        from ..locations.file_path_helper import job_prologue

        exts = sorted(MEDIA_DATA_EXTENSIONS | thumbnailable_extensions()
                      | probeable_extensions())
        ph = ",".join("?" for _ in exts)
        loc, where, params = job_prologue(
            ctx.db, self.location_id, self.sub_path,
            f"location_id = ? AND is_dir = 0 AND object_id IS NOT NULL "
            f"AND LOWER(extension) IN ({ph})",
            [self.location_id, *exts])
        rows = ctx.db.query(statements.render("media.file_rows", where), params)
        if not rows:
            raise EarlyFinish("no media files")
        steps = [{"rows": [dict(r) for r in rows[i:i + BATCH_SIZE]]}
                 for i in range(0, len(rows), BATCH_SIZE)]
        data = {"location_path": loc["path"], "extracted": 0, "thumbs": 0}
        ctx.progress(task_count=len(steps))
        return data, steps

    async def execute_step(self, ctx, data, step, step_number):
        outcome = await asyncio.to_thread(self._exif_step, ctx, data, step)
        await self._thumbs_step(ctx, data, step)
        ctx.progress(message=f"media: {data['extracted']} exif, {data['thumbs']} thumbs")
        outcome.metadata = {
            "media_data_extracted": data["extracted"],
            "thumbnails_generated": data["thumbs"],
        }
        return outcome

    def _exif_step(self, ctx: JobContext, data, step) -> StepOutcome:
        av_exts = probeable_extensions()
        db = ctx.db
        errors: List[str] = []
        mds: List[dict] = []
        for r in step["rows"]:
            ext = (r["extension"] or "").lower()
            is_av = ext in av_exts
            if ext not in MEDIA_DATA_EXTENSIONS and not is_av:
                continue
            full = self._full_path(data, r)
            if db.run("media.data_exists", (r["object_id"],)) is not None:
                continue
            try:
                if is_av:
                    info = probe_media(full)
                    if info is None:
                        continue
                    md = {"object_id": r["object_id"],
                          "stream_data": json.dumps(info.to_dict())}
                else:
                    md = extract_media_data(full)
                    if md is None:
                        continue
                    md["object_id"] = r["object_id"]
                mds.append(md)
            except Exception as e:
                errors.append(f"media_data {full}: {e}")
        if mds:
            try:
                data["extracted"] += db.insert_many("media_data", mds, ignore_conflicts=True)
            except Exception:
                # OR IGNORE does not cover FK violations (an object deleted
                # between scan and insert): per-row inserts, so one dead
                # reference costs one error string, not the whole batch.
                with db.write_tx() as conn:
                    for md in mds:
                        try:
                            db.insert("media_data", md, conn=conn)
                            data["extracted"] += 1
                        except Exception as row_e:  # noqa: BLE001
                            errors.append(f"media_data object {md.get('object_id')}: {row_e}")
        return StepOutcome(errors=errors)

    async def _thumbs_step(self, ctx: JobContext, data, step) -> None:
        """The batch to the thumbnailer actor where the manager has one
        running (actor.rs:487), else inline."""
        data_dir = ctx.services.get("data_dir")
        if not data_dir:
            return
        exts = thumbnailable_extensions()
        entries = []
        for r in step["rows"]:
            ext = (r["extension"] or "").lower()
            if r["cas_id"] and ext in exts:
                entries.append((r["cas_id"], self._full_path(data, r)))
        if not entries:
            return
        actor = ctx.services.get("thumbnailer")
        if actor is not None and actor.is_running():
            batch = await actor.new_batch(entries, library_id=getattr(ctx.library, "id", None))
            await batch.done.wait()
            data["thumbs"] += batch.generated
        else:
            await asyncio.to_thread(ensure_thumbnail_dir, data_dir)
            for cas_id, full in entries:
                if await asyncio.to_thread(generate_thumbnail, full, data_dir, cas_id):
                    data["thumbs"] += 1

    def _full_path(self, data, r) -> str:
        iso = IsolatedPath.from_db_row(self.location_id, False, r["materialized_path"],
                                       r["name"] or "", r["extension"] or "")
        return iso.join_on(data["location_path"])

    async def finalize(self, ctx, data, metadata):
        return metadata
