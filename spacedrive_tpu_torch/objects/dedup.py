"""Duplicate analytics: exact CAS-ID groups and the perceptual near-dup job.

Port of ``spacedrive_tpu/objects/dedup.py``. ``exact_duplicate_groups``
reports objects with several file_paths (the identifier's linking
invariant: same cas_id, same object). ``NearDupDetectorJob`` pHashes every
image of a location (host decode, ``ops/phash.py`` on the device), stores
the hashes on ``media_data`` rows, then runs one all-pairs compare and
stores ``near_dup_pair`` rows; ``near_duplicates`` reads them back.

``backend`` is the port's vocabulary: ``"cuda"`` (the default; raises at
construction where CUDA is absent) hashes on the card and always runs the
exact pairs search there (one ``hamming_near_mask`` launch up to one tile,
the pyramid past it), at any N. ``"plain"`` runs the same torch code on the
CPU, exact up to ``ALL_PAIRS_LIMIT`` digests and LSH banding past it, which
is what the JAX package does without a TPU. Nothing routes card work to the
CPU. Images are decoded on the host by ``media/imgdecode.py`` under either
backend (PNG, BMP, JPEG, GIF, ICO, TIFF with DNG's first IFD, and WebP,
read by their bytes, to PIL's grid); a file it refuses (HEIF, AVIF and
the rest that module lists) is a job error, ``phash decode failed:
<path>``, as in the JAX package where PIL refuses it too (PIL here reads
AVIF, which the port refuses). Any other
failure of a hash step (the native plane's build or load, the card) is no
file's fault and fails the job.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..jobs.job import (EarlyFinish, JobContext, JobError, StatefulJob, StepOutcome,
                        register_job)
from ..locations.file_path_helper import job_prologue
from ..locations.paths import IsolatedPath
from ..ops.blake3_torch import resolve_device
from ..ops.hamming import near_dup_pairs, near_dup_pairs_lsh
from ..ops.phash import phash_files, phash_from_bytes, phash_to_bytes
from ..store import statements

PHASH_BATCH = 256
DEFAULT_THRESHOLD = 10
# Beyond this many hashes the plain backend gives exact all-pairs up for
# LSH bucketing; the card stays exact.
ALL_PAIRS_LIMIT = 100_000
BACKENDS = ("cuda", "plain")

# The port's copy of spacedrive_tpu/media/exif.py's MEDIA_DATA_EXTENSIONS
# (media_data_extractor.rs:50-56).
MEDIA_DATA_EXTENSIONS = {
    "tiff", "dng", "jpeg", "jpg", "heif", "heifs", "heic", "avif",
    "avcs", "avci", "hif", "png", "webp",
}
PHASHABLE_EXTENSIONS = sorted(
    MEDIA_DATA_EXTENSIONS | {"bmp", "gif", "ico", "tif"})


def _display_path(p) -> str:
    return (f"{p['materialized_path']}{p['name']}"
            + (f".{p['extension']}" if p["extension"] else ""))


def exact_duplicate_groups(library, location_id: Optional[int] = None,
                           limit: int = 1000) -> List[Dict[str, Any]]:
    """Objects whose cas_id is shared by multiple file_paths —
    [{cas_id, object_pub_id, count, total_bytes, reclaimable_bytes, paths}]."""
    where = "fp.cas_id IS NOT NULL"
    params: List[Any] = []
    if location_id is not None:
        where += " AND fp.location_id = ?"
        params.append(location_id)
    rows = library.db.query(statements.render("dedup.exact_groups", where),
                            params + [limit])
    out = []
    for r in rows:
        paths = library.db.run("dedup.paths_by_cas", (r["cas_id"],))
        sizes = [int.from_bytes(p["size_in_bytes_bytes"] or b"", "big")
                 for p in paths]
        pub = r["object_pub_id"]
        out.append({
            "cas_id": r["cas_id"],
            # hex, not raw bytes: this dict crosses the JSON-RPC surface
            "object_pub_id": pub.hex() if isinstance(pub, bytes) else pub,
            "count": r["n"],
            "total_bytes": sum(sizes),
            "reclaimable_bytes": sum(sizes) - (sizes[0] if sizes else 0),
            "paths": [_display_path(p) for p in paths],
        })
    return out


@register_job
class NearDupDetectorJob(StatefulJob):
    """Two phases: (1) pHash every un-hashed image in PHASH_BATCH chunks,
    (2) one compare step running the all-pairs search and persisting
    near_dup_pair rows. Seconds per phase land in the metadata's
    ``phase_s`` (decode, phash, db_hash; load, pairs, db_pairs) with the
    pyramid's stages under ``pyramid_s``."""

    NAME = "near_dup_detector"
    IS_BATCHED = True

    def __init__(self, *, location_id: int,
                 threshold: int = DEFAULT_THRESHOLD,
                 sub_path: Optional[str] = None, backend: str = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {list(BACKENDS)}")
        # Raises here, before any file is read, where CUDA is absent.
        self._device = resolve_device("cuda" if backend == "cuda" else "cpu")
        super().__init__(location_id=location_id, threshold=threshold,
                         sub_path=sub_path, backend=backend)
        self.location_id = location_id
        self.threshold = threshold
        self.sub_path = sub_path
        self.backend = backend

    def _init_sync(self, ctx: JobContext):
        db = ctx.db
        ph = ",".join("?" for _ in PHASHABLE_EXTENSIONS)
        loc, where, params = job_prologue(
            db, self.location_id, self.sub_path,
            f"fp.location_id = ? AND fp.is_dir = 0 AND "
            f"fp.object_id IS NOT NULL AND LOWER(fp.extension) IN ({ph})",
            [self.location_id, *PHASHABLE_EXTENSIONS])
        where = where.replace("materialized_path LIKE",
                              "fp.materialized_path LIKE")
        rows = db.query(statements.render("dedup.image_rows", where), params)
        if not rows:
            raise EarlyFinish("no images to hash")
        to_hash = [
            {"id": r["id"], "object_id": r["object_id"],
             "materialized_path": r["materialized_path"],
             "name": r["name"] or "", "extension": r["extension"] or ""}
            for r in rows if r["phash"] is None
        ]
        steps: List[Any] = []
        for i in range(0, len(to_hash), PHASH_BATCH):
            steps.append({"kind": "hash",
                          "rows": to_hash[i:i + PHASH_BATCH]})
        steps.append({"kind": "compare"})
        data = {"location_path": loc["path"], "hashed": 0,
                "pairs_found": 0, "total_images": len(rows), "phase_s": {},
                "pyramid_s": {}}
        ctx.progress(task_count=len(steps))
        return data, steps

    async def execute_step(self, ctx, data, step, step_number):
        if step["kind"] == "hash":
            return await asyncio.to_thread(self._hash_step, ctx, data, step)
        return await asyncio.to_thread(self._compare_step, ctx, data)

    def _hash_step(self, ctx: JobContext, data, step) -> StepOutcome:
        db = ctx.db
        rows = step["rows"]
        paths = []
        for r in rows:
            iso = IsolatedPath.from_db_row(
                self.location_id, False, r["materialized_path"],
                r["name"], r["extension"])
            paths.append(iso.join_on(data["location_path"]))
        phase = data["phase_s"]
        try:
            hashes, errors = phash_files(paths, self._device, timings=phase)
        except Exception as e:  # noqa: BLE001 (each file's own failure is caught inside)
            raise JobError(f"phash step failed: {e!r}") from e
        t0 = time.perf_counter()
        with db.write_tx() as conn:
            for i, words in hashes.items():
                blob = phash_to_bytes(words)
                # UPDATE-then-INSERT decides per row on rowcount; one
                # transaction for the chunk.
                cur = db.run("dedup.set_phash", (blob, rows[i]["object_id"]), conn=conn)
                if cur.rowcount == 0:
                    db.run("dedup.insert_phash_row", (rows[i]["object_id"], blob),
                           conn=conn)
        phase["db_hash"] = phase.get("db_hash", 0.0) + time.perf_counter() - t0
        data["hashed"] += len(hashes)
        ctx.progress(message=f"hashed {data['hashed']} images")
        return StepOutcome(errors=errors,
                           metadata={"hashed": data["hashed"]})

    def _compare_step(self, ctx: JobContext, data) -> StepOutcome:
        db = ctx.db
        phase = data["phase_s"]
        t0 = time.perf_counter()
        rows = db.run("dedup.phashes_for_location", (self.location_id,))
        if len(rows) < 2:
            return StepOutcome(metadata={"pairs": 0})
        object_ids = [r["object_id"] for r in rows]
        digests = np.stack([phash_from_bytes(r["phash"]) for r in rows])
        t1 = time.perf_counter()
        phase["load"] = t1 - t0

        errors = []
        if self.backend == "cuda" or len(rows) <= ALL_PAIRS_LIMIT:
            # Exact, up to the MAX_TOTAL_PAIRS output budget; truncation in
            # degenerate clusters is surfaced as a job error.
            stats: dict = {}
            pairs = near_dup_pairs(digests, self.threshold, stats=stats,
                                   device=self._device)
            data["pyramid_s"] = stats.get("stage_s", {})
            if stats.get("truncated_pairs"):
                errors.append(
                    f"near-dup pair list truncated: ~"
                    f"{stats['truncated_pairs']} pairs in degenerate "
                    "near-identical clusters were dropped "
                    "(MAX_TOTAL_PAIRS budget)")
        else:
            # Plain backend at huge N: probabilistic LSH banding.
            pairs = near_dup_pairs_lsh(digests, self.threshold)
        t2 = time.perf_counter()
        phase["pairs"] = t2 - t1

        now = int(time.time())
        pair_rows = []
        for i, j in pairs:
            a, b = sorted((object_ids[i], object_ids[j]))
            if a == b:
                continue  # two file_paths of one object: exact dup
            d = int(np.sum(np.unpackbits(
                (digests[i] ^ digests[j]).astype(">u4").view(np.uint8))))
            pair_rows.append((a, b, d, now))
        with db.write_tx() as conn:
            db.run_many("dedup.upsert_pair", pair_rows, conn=conn)
        phase["db_pairs"] = time.perf_counter() - t2
        data["pairs_found"] = len(pairs)
        return StepOutcome(errors=errors, metadata={"pairs": len(pairs)})

    async def finalize(self, ctx, data, metadata):
        metadata.setdefault("hashed", data["hashed"])
        metadata["pairs"] = data["pairs_found"]
        metadata["total_images"] = data["total_images"]
        metadata["phase_s"] = data["phase_s"]
        metadata["pyramid_s"] = data["pyramid_s"]
        return metadata


def near_duplicates(library, location_id: Optional[int] = None,
                    max_distance: int = DEFAULT_THRESHOLD,
                    limit: int = 1000) -> List[Dict[str, Any]]:
    """Stored near-dup pairs with object and file detail. `location_id` is
    accepted for the JAX package's signature; as there, the pairs are not
    filtered by it."""
    rows = library.db.run("dedup.pairs_within", (max_distance, limit))
    out = []
    for r in rows:
        def paths_of(oid):
            return [_display_path(p)
                    for p in library.db.run("dedup.paths_for_object", (oid,))]
        out.append({
            "distance": r["distance"],
            "object_a": r["object_a_id"], "object_b": r["object_b_id"],
            "paths_a": paths_of(r["object_a_id"]),
            "paths_b": paths_of(r["object_b_id"]),
        })
    return out
