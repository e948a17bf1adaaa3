"""ObjectValidatorJob: full-file BLAKE3 integrity checksums on the device.

Port of ``spacedrive_tpu/objects/validator.py``. ``checksums_for_files``
is ``ObjectValidatorJob._checksums_jax`` (:134-223) as a module-level
function with the same two regimes:

- small files (≤ ``SMALL_FILE_CAP``) are sorted by size and packed into
  pages of at most ``BATCH_ROWS`` rows whose PADDED grid stays within
  ``BATCH_BYTES``, one ``checksums_words_batched`` dispatch per page;
- large files stream through ``ops/seqhash.py`` windows (bounded memory
  at any size).

Semantics: upstream core/src/object/validation/hash.rs:10-24.

``ObjectValidatorJob`` (validator_job.rs:78-218) pages the location's
file_paths by id and checksums each page through ``checksums_for_files``
on its ``device`` (default ``"cuda"``; it raises at construction where
CUDA is absent). ``mode="fill"`` writes every missing
``integrity_checksum`` through sync; ``mode="verify"`` re-hashes files
that have one and reports each mismatch as a non-fatal error, never
overwriting the stored value.
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..jobs.job import EarlyFinish, JobContext, StatefulJob, StepOutcome, register_job
from ..locations.file_path_helper import job_prologue
from ..locations.paths import IsolatedPath
from ..ops import seqhash
from ..ops.blake3_torch import checksums_words_batched, resolve_device

# Files at or under this size share pages; larger ones stream.
SMALL_FILE_CAP = 4 << 20
# Padded grid bytes and rows per page dispatch.
BATCH_BYTES = 64 << 20
BATCH_ROWS = 512
# 8 MiB streaming windows: the JAX validator's single-device shard size.
WINDOW_CHUNKS = seqhash.DEFAULT_WINDOW_CHUNKS
# Files per job step (the JAX job's step on its batched planes): a step
# fills several pages.
STEP_FILES = 2048


def _padded_row(sz: int) -> int:
    """Grid bytes one row costs: every row pads to the page's pow2 max
    chunk count, and ascending size order makes the current file set it."""
    chunks = max(1, -(-max(sz, 1) // 1024))
    return (1 << (chunks - 1).bit_length()) * 1024


def checksums_for_files(
    paths: Sequence[str], device="cuda",
) -> Tuple[Dict[int, str], Dict[int, str]]:
    """paths → ({index: 64-hex checksum}, {index: error message})."""
    resolve_device(device)
    checksums: Dict[int, str] = {}
    errors: Dict[int, str] = {}
    small, big = [], []
    for i, path in enumerate(paths):
        try:
            sz = os.path.getsize(path)
        except OSError as e:
            errors[i] = f"{path}: {e}"
            continue
        (small if sz <= SMALL_FILE_CAP else big).append((i, path, sz))

    small.sort(key=lambda t: t[2])
    pos = 0
    while pos < len(small):
        batch, blobs = [], []
        while pos < len(small) and len(batch) < BATCH_ROWS:
            i, path, sz = small[pos]
            # Budget the PADDED grid, not the raw payload: one 4 MiB file
            # after 500 tiny ones would otherwise balloon the dispatch to
            # rows × pow2(max) ≈ GiBs of zeros.
            if batch and (len(batch) + 1) * _padded_row(sz) > BATCH_BYTES:
                break
            pos += 1
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                errors[i] = f"{path}: {e}"
                continue
            blobs.append(data)
            batch.append(i)
        if blobs:
            checksums.update(zip(batch, checksums_words_batched(blobs, device)))

    for i, path, _sz in big:
        try:
            checksums[i] = seqhash.file_checksum_streaming(path, device, WINDOW_CHUNKS)
        except OSError as e:
            errors[i] = f"{path}: {e}"
    return checksums, errors


@register_job
class ObjectValidatorJob(StatefulJob):
    NAME = "object_validator"
    IS_BATCHED = True

    def __init__(self, *, location_id: int, sub_path: Optional[str] = None,
                 device: str = "cuda", mode: str = "fill"):
        if mode not in ("fill", "verify"):
            raise ValueError(f"unknown validator mode {mode!r}")
        resolve_device(device)  # raises here where CUDA is asked for and absent
        super().__init__(location_id=location_id, sub_path=sub_path,
                         device=device, mode=mode)
        self.location_id = location_id
        self.sub_path = sub_path
        self.device = device
        self.mode = mode

    def _init_sync(self, ctx: JobContext):
        """Cursor-paginated steps: the resumable state is (WHERE, cursor,
        counters), whatever the scan's size."""
        db = ctx.db
        checksum_filter = ("integrity_checksum IS NULL" if self.mode == "fill"
                           else "integrity_checksum IS NOT NULL")
        loc, where, params = job_prologue(
            db, self.location_id, self.sub_path,
            f"location_id = ? AND is_dir = 0 AND {checksum_filter}", [self.location_id])
        count = db.query_one(f"SELECT COUNT(*) AS n FROM file_path WHERE {where}",
                             params)["n"]
        if count == 0:
            raise EarlyFinish("nothing to validate")
        chunk = STEP_FILES
        data = {"location_path": loc["path"], "where": where, "params": list(params),
                "cursor": 0, "chunk": chunk, "validated": 0, "mismatched": 0}
        steps = [{} for _ in range(-(-count // chunk))]
        ctx.progress(task_count=len(steps))
        return data, steps

    async def execute_step(self, ctx, data, step, step_number):
        return await asyncio.to_thread(self._step, ctx, data)

    def _fetch_rows(self, db, data) -> List[Dict[str, Any]]:
        rows = db.query(
            f"SELECT id, pub_id, materialized_path, name, extension, "
            f"integrity_checksum, size_in_bytes_bytes "
            f"FROM file_path WHERE {data['where']} "
            f"AND id >= ? ORDER BY id LIMIT ?",
            list(data["params"]) + [data["cursor"], data["chunk"]])
        return [{
            "id": r["id"], "pub_id": r["pub_id"],
            "materialized_path": r["materialized_path"],
            "name": r["name"] or "", "extension": r["extension"] or "",
            "expected": r["integrity_checksum"],
        } for r in rows]

    def _step(self, ctx: JobContext, data) -> StepOutcome:
        db, sync = ctx.db, ctx.library.sync
        rows = self._fetch_rows(db, data)
        if not rows:
            return StepOutcome()
        # The cursor passes this page only once it is processed: a replay
        # redoes it, and the guarded UPDATE keeps that idempotent.
        next_cursor = rows[-1]["id"] + 1
        paths = [IsolatedPath.from_db_row(self.location_id, False, r["materialized_path"],
                                          r["name"], r["extension"]).join_on(
                                              data["location_path"]) for r in rows]
        device = resolve_device(self.device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                sums, failed = checksums_for_files(paths, device)
        else:
            sums, failed = checksums_for_files(paths, device)
        errors = [failed[i] for i in sorted(failed)]
        results = [(rows[i], paths[i], sums[i]) for i in sorted(sums)]

        if self.mode == "verify":
            for r, path, checksum in results:
                if checksum != r["expected"]:
                    data["mismatched"] += 1
                    errors.append(f"CHECKSUM MISMATCH {path}: stored "
                                  f"{r['expected']}, current {checksum}")
            data["validated"] += len(results)
            data["cursor"] = next_cursor
            ctx.progress(message=(f"verified {data['validated']} files, "
                                  f"{data['mismatched']} mismatches"))
            return StepOutcome(errors=errors, metadata={
                "validated": data["validated"], "mismatched": data["mismatched"]})

        with db.write_tx() as conn:
            db.run_many("validator.fill_checksum",
                        [(checksum, r["id"]) for r, _p, checksum in results], conn=conn)
            n_ops = sync.bulk_shared_ops(conn, "file_path", [
                (r["pub_id"], "u:integrity_checksum", "integrity_checksum", checksum, None)
                for r, _p, checksum in results])
        if n_ops:
            sync._notify_created()
        data["validated"] += len(results)
        data["cursor"] = next_cursor
        ctx.progress(message=f"validated {data['validated']} files")
        return StepOutcome(errors=errors, metadata={"validated": data["validated"]})
