"""FileIdentifierJob: CAS-ID every orphan file_path, link or create objects.

Port of ``spacedrive_tpu/objects/identifier.py`` (upstream
core/src/object/file_identifier/file_identifier_job.rs:72-309 and
mod.rs:100-331): cursor-paginated pages of orphans (object_id IS NULL,
is_dir = 0); per page, kinds and CAS IDs, then cas_id writes, links to
existing objects by cas_id and new objects for the rest, all through sync,
in one transaction per step. Files of one page that share a CAS ID share
one new object.

Hashing goes through ``ops/staging.cas_ids_for_files`` on one of three
backends:

- ``"cuda"`` (the default): native staging into the pinned pages of one
  two-page ``StagePool`` the job allocates in ``init`` and keeps across
  steps, one non-blocking copy per size class and the fused BLAKE3 kernel
  K1 on the card. Steps run at ``AUTO_DEVICE_BATCH`` files unless
  ``device_batch`` is given. Constructing the job raises where CUDA is
  absent, before any file is read.
- ``"plain"``: the plain torch version on the CPU; ``"oracle"``: the
  pure-Python BLAKE3. Both step at ``CHUNK_SIZE`` unless ``device_batch``
  is given.

There is no ``"auto"`` backend and no link probe: nothing routes work to a
CPU plane on its own. Kept from the JAX job: hash-ahead (page k+1 fetched,
staged and hashed in a worker thread while page k commits), the
whole-library cas map, the index drop and rebuild for big scans, and the
per-phase seconds in ``data["phase_s"]``. A thread that hashes on the card
enters the job's device and stream itself.

The job pauses, resumes and cold-resumes from its cursor. ``suspend``
(a pause or a shutdown) waits out the hash-ahead worker, drops the page it
hashed, stops the thread and lets the pool go, so a paused job holds no
pinned page; the next step builds the pool again and hashes that page
anew. ``data["pages_hashed"]`` counts every page hashed, the re-hashed
ones included, and ``data["pauses"]`` the pool's leases at each pause.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..files import resolve_kind
from ..jobs.job import EarlyFinish, JobContext, StatefulJob, StepOutcome, register_job
from ..locations.file_path_helper import (load_location, materialized_like,
                                          sub_path_children_mat)
from ..ops import kernel_registry, staging
from ..telemetry import IDENT_FILES, IDENT_PHASE_SECONDS
from ..ops.blake3_torch import resolve_device
from ..sync.crdt import OpKind, uuid4_bytes_batch

CHUNK_SIZE = 100  # file_identifier/mod.rs:36
# The card's step: one K1 launch per size class present in 16384 files.
AUTO_DEVICE_BATCH = 16384
BACKENDS = ("cuda", "plain", "oracle")

# The identifier's one op per identified file: cas_id + object link
# together, per-field last-writer-wins on apply.
LINK_KIND = OpKind.multi_update(("cas_id", "object_id"))


def orphan_filters(location_id: int, cursor: int,
                   sub_mat_path: Optional[str]) -> Tuple[str, list]:
    """WHERE clause for orphan file_paths (file_identifier_job.rs:245-270)."""
    where = "object_id IS NULL AND is_dir = 0 AND location_id = ? AND id >= ?"
    params: list = [location_id, cursor]
    return materialized_like(where, params, sub_mat_path), params


def _in_chunks(seq: List, n: int = 900):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def stage_file_list(rows: List[Dict[str, Any]], location_id: int,
                    location_path: str) -> List[Tuple[str, int]]:
    """Orphan rows → (absolute path, size) pairs for the staged hasher
    (``IsolatedPath.from_db_row().join_on()`` inlined)."""
    files: List[Tuple[str, int]] = []
    base = os.fspath(location_path)
    sep_fix = os.sep != "/"
    if not base.endswith(os.sep):
        base += os.sep
    for r in rows:
        name = r["name"] or ""
        ext = r["extension"] or ""
        rel = (f"{r['materialized_path'][1:]}{name}.{ext}" if ext
               else f"{r['materialized_path'][1:]}{name}")
        if sep_fix:
            rel = rel.replace("/", os.sep)
        files.append((base + rel, int.from_bytes(r["size_in_bytes_bytes"] or b"", "big")))
    return files


@dataclass
class TxBatch:
    """Bookkeeping of one step's transaction: cas map keys added
    inside it (popped back out on rollback) and the op count whose created
    broadcast waits for the commit."""

    cas_added: List[str] = field(default_factory=list)
    n_ops: int = 0


def identify_chunk(library, rows: List[Dict[str, Any]], prehashed: Tuple, conn,
                   batch: TxBatch, cas_map: Optional[Dict[str, Tuple[int, bytes]]] = None,
                   timings: Optional[Dict[str, float]] = None) -> Tuple[int, int, List[str]]:
    """One hashed page's writes (identifier_job_step, mod.rs:100-331): kinds,
    cas_id writes, links to existing objects and new objects for the rest,
    all through sync, on the caller's open transaction `conn`. Returns
    (linked, created, errors).

    `prehashed` = (files, ids, read_errors) of the page. `cas_map` (cas_id →
    (object id, pub_id), kept by the job across pages) replaces the per-page
    IN() probes; the keys this page adds are noted in `batch.cas_added`, to
    be popped back out if the transaction rolls back, and its op count in
    `batch.n_ops`, whose created broadcast waits for the commit. `timings`
    accumulates per-phase seconds."""
    t = timings if timings is not None else {}

    def _mark(phase: str, t0: float) -> float:
        t1 = time.perf_counter()
        t[phase] = t.get(phase, 0.0) + (t1 - t0)
        return t1

    db, sync = library.db, library.sync
    tp = time.perf_counter()
    files, ids, read_errors = prehashed
    kinds = {i: int(resolve_kind(files[i][0], ext=rows[i]["extension"] or ""))
             for i in ids}
    tp = _mark("prep", tp)

    # Link targets: existing objects by cas_id (mod.rs:167-225).
    if cas_map is not None:
        existing = cas_map
    else:
        existing = {}
        for chunk in _in_chunks(sorted({c for c in ids.values() if c})):
            ph = ",".join("?" for _ in chunk)
            for r in conn.execute(
                    f"SELECT fp.cas_id AS cas_id, o.id AS oid, o.pub_id AS opub "
                    f"FROM file_path fp JOIN object o ON o.id = fp.object_id "
                    f"WHERE fp.cas_id IN ({ph})", chunk):
                existing.setdefault(r["cas_id"], (r["oid"], r["opub"]))
    tp = _mark("db_link", tp)

    # Resolve every row to an object: link or create.
    linked = 0
    by_cas: Dict[str, bytes] = {}
    pub_of: Dict[int, bytes] = {}
    new_objects: List[Tuple[bytes, int, Any]] = []
    create_specs: List[Tuple] = []
    oid_of: Dict[bytes, int] = {}
    fresh_pubs = uuid4_bytes_batch(len(ids))
    for i, cas_id in ids.items():
        hit = existing.get(cas_id) if cas_id is not None else None
        if hit is not None:
            oid_of[hit[1]] = hit[0]
            pub_of[i] = hit[1]
            linked += 1
        elif cas_id is not None and cas_id in by_cas:
            pub_of[i] = by_cas[cas_id]  # same-page duplicate
        else:
            opub = fresh_pubs[len(new_objects)]
            date_created = rows[i]["date_created"]
            new_objects.append((opub, kinds[i], date_created))
            create_specs.append((opub, "c", None, None,
                                 {"kind": kinds[i], "date_created": date_created}))
            if cas_id is not None:
                by_cas[cas_id] = opub
            pub_of[i] = opub
    tp = _mark("ops", tp)

    # Domain writes: the objects, then ONE file_path update pass.
    db.run_many("identifier.object_insert", new_objects, conn=conn)
    if new_objects:
        # Inside one transaction under the write lock the batch holds
        # consecutive rowids ending at last_insert_rowid(); one probe checks
        # the assumption.
        last = db.run("store.last_rowid", conn=conn)
        first = last - len(new_objects) + 1
        probe = db.run("identifier.object_by_pub", (new_objects[0][0],), conn=conn)
        if probe is not None and probe["id"] == first:
            for k, (opub, _, _) in enumerate(new_objects):
                oid_of[opub] = first + k
        else:
            for chunk in _in_chunks([p for p, _, _ in new_objects]):
                ph = ",".join("?" for _ in chunk)
                for r in conn.execute(
                        f"SELECT id, pub_id FROM object WHERE pub_id IN ({ph})", chunk):
                    oid_of[r["pub_id"]] = r["id"]
    db.run_many("identifier.link_paths",
                [(cas_id, oid_of[pub_of[i]], rows[i]["id"]) for i, cas_id in ids.items()],
                conn=conn)
    tp = _mark("db_write", tp)

    # Op log: object creates first (their stamps precede the links), then
    # one multi-field {cas_id, object_id} update per file_path.
    batch.n_ops += sync.bulk_shared_ops(conn, "object", create_specs)
    batch.n_ops += sync.bulk_shared_ops(conn, "file_path", [
        (rows[i]["pub_id"], LINK_KIND, None, None,
         {"cas_id": cas_id, "object_id": pub_of[i]})
        for i, cas_id in ids.items()])
    _mark("ops", tp)
    if cas_map is not None:
        # The next page of the same transaction dedups against these.
        for c, opub in by_cas.items():
            cas_map[c] = (oid_of[opub], opub)
        batch.cas_added.extend(by_cas)
    return linked, len(new_objects), list(read_errors.values())


@register_job
class FileIdentifierJob(StatefulJob):
    NAME = "file_identifier"
    IS_BATCHED = True

    # Above this many existing objects the whole-library cas map is not
    # preloaded and pages fall back to the per-page IN() probes.
    CAS_PRELOAD_MAX = 2_000_000
    # At or above this many orphans the file_path cas_id / object_id
    # indexes are dropped for the run and rebuilt in finalize.
    BULK_DROP_MIN_ORPHANS = 100_000

    def __init__(self, *, location_id: int, sub_path: Optional[str] = None,
                 backend: str = "cuda", device_batch: Optional[int] = None):
        """`device_batch` sets the files per step; each step's page is
        staged and hashed as one batch. The cursor advances per step and a
        replayed page is idempotent (updates keyed by row id)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {list(BACKENDS)}")
        if device_batch is not None and device_batch < 1:
            raise ValueError(f"device_batch must be >= 1, got {device_batch}")
        super().__init__(location_id=location_id, sub_path=sub_path,
                         backend=backend, device_batch=device_batch)
        self.location_id = location_id
        self.sub_path = sub_path
        self.backend = backend
        self.device_batch = device_batch
        if backend == "cuda":
            # Raises here, before any file is read, where CUDA is absent.
            self._device = resolve_device("cuda")
        self._pool: Optional[staging.StagePool] = None
        self._stream = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._prefetch = None
        self._count_lock = threading.Lock()
        self._leases_after_hash = 0
        self._pages_hashed = 0  # since the last fold into data

    @property
    def chunk_size(self) -> int:
        if self.device_batch is not None:
            return self.device_batch
        return AUTO_DEVICE_BATCH if self.backend == "cuda" else CHUNK_SIZE

    # -- lifecycle ---------------------------------------------------------

    def _init_sync(self, ctx: JobContext):
        db = ctx.db
        loc = load_location(db, self.location_id)
        sub_mat = sub_path_children_mat(self.location_id, self.sub_path)
        where, params = orphan_filters(self.location_id, 0, sub_mat)
        count = db.query_one(f"SELECT COUNT(*) AS n FROM file_path WHERE {where}",
                             params)["n"]
        if count == 0:
            raise EarlyFinish("no orphan file paths")
        chunk = self.chunk_size
        # Big scans drop the cas_id / object_id read indexes for the run
        # (two random B-tree inserts per file) and rebuild them sorted in
        # finalize; reopening the database recreates them after a crash,
        # cleanup() after a failure. The cas_id index goes only when the
        # preloaded cas map replaces its probes.
        rebuild = count >= self.BULK_DROP_MIN_ORPHANS
        cas_preload = db.run("store.object_count")["n"] <= self.CAS_PRELOAD_MAX
        if rebuild:
            with db.write_tx() as conn:
                if cas_preload:
                    conn.execute("DROP INDEX IF EXISTS idx_file_path_cas_id")
                conn.execute("DROP INDEX IF EXISTS idx_file_path_object_id")
        data = {
            "location_path": loc["path"],
            "sub_mat_path": sub_mat,
            "rebuild_indexes": rebuild,
            "cas_preload": cas_preload,
            "chunk_size": chunk,
            "cursor": 0,
            "linked": 0, "created": 0, "skipped": 0, "total_orphans": count,
            "phase_s": {},
        }
        if self.backend == "cuda":
            self._ensure_pool(data)
            data["pool"] = {"pages": self._pool.pages,
                            "pinned_bytes": self._pool.pinned_bytes,
                            "alloc_s": self._pool.alloc_s}
        steps = [{"chunk": i} for i in range(-(-count // chunk))]
        ctx.progress(task_count=len(steps), message=f"identifying {count} orphan paths")
        return data, steps

    def _ensure_pool(self, data: Dict[str, Any]) -> None:
        """One pool for the run, sized for the largest page: built in init
        and again by the first step after a resume, which skips init."""
        if self.backend != "cuda" or self._pool is not None:
            return
        with torch.cuda.device(self._device):
            self._pool = staging.cas_pool(min(data["chunk_size"], data["total_orphans"]),
                                          self._device)
            self._stream = torch.cuda.Stream(self._device)

    def _fold_counts(self, data: Dict[str, Any]) -> None:
        with self._count_lock:
            data["pages_hashed"] = data.get("pages_hashed", 0) + self._pages_hashed
            self._pages_hashed = 0

    async def execute_step(self, ctx, data, step, step_number):
        return await asyncio.to_thread(self._step, ctx, data)

    # -- hashing -------------------------------------------------------------

    def _hash(self, files):
        """One page through the job's backend. On the card: the caller's
        thread enters the job's device and stream, stages into the job's
        pool, and every lease is back when the call returns."""
        if self.backend != "cuda":
            with kernel_registry.device_scope("identify.hash"):
                out = staging.cas_ids_for_files(files, backend=self.backend)
            with self._count_lock:
                self._pages_hashed += 1
            return out
        # The bucketed identify hash runs inside the sanitizer's device
        # scope, as in the JAX package (contract cas.ids).
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream), \
                kernel_registry.device_scope("identify.hash"):
            out = staging.cas_ids_for_files(files, backend="cuda", pool=self._pool)
        with self._count_lock:
            self._pages_hashed += 1
            self._leases_after_hash = max(self._leases_after_hash, self._pool.in_use)
        return out

    def _fetch_page(self, ctx: JobContext, data: Dict[str, Any],
                    cursor: int) -> List[Dict[str, Any]]:
        where, params = orphan_filters(self.location_id, cursor, data["sub_mat_path"])
        return ctx.db.query(
            f"SELECT * FROM file_path WHERE {where} ORDER BY id ASC LIMIT ?",
            params + [data.get("chunk_size") or self.chunk_size])

    def _get_cas_map(self, ctx: JobContext, data: Dict[str, Any]):
        """Whole-library cas_id → (object id, pub_id), built once per run
        and kept by identify_chunk; None when init decided against it."""
        m = getattr(self, "_cas_map", None)
        if m is not None:
            return None if m is False else m
        if not data.get("cas_preload"):
            self._cas_map = False
            return None
        m = {}
        for r in ctx.db.run("identifier.cas_map"):
            m.setdefault(r["c"], (r["oid"], r["opub"]))
        self._cas_map = m
        return m

    def _fetch_and_hash(self, ctx: JobContext, data: Dict[str, Any], cursor: int):
        """Worker-thread body of hash-ahead: page fetch, file list, hash.
        Returns (rows, prehashed, per-phase seconds)."""
        w: Dict[str, float] = {}
        t0 = time.perf_counter()
        rows = self._fetch_page(ctx, data, cursor)
        w["fetch"] = time.perf_counter() - t0
        if not rows:
            return rows, None, w
        t0 = time.perf_counter()
        files = stage_file_list(rows, self.location_id, data["location_path"])
        w["prep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids, read_errors = self._hash(files)
        w["hash"] = time.perf_counter() - t0
        return rows, (files, ids, read_errors), w

    def _submit(self, fn, *args) -> concurrent.futures.Future:
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="identify-ahead")
        # The worker runs in the step's context: its spans (cas_ids/cuda)
        # stay in the job's trace.
        return self._executor.submit(contextvars.copy_context().run, fn, *args)

    def _take_page(self, ctx: JobContext, data: Dict[str, Any], cursor: int,
                   timings: Dict[str, float]):
        """The page at `cursor` (+ its hashes when the prefetch hashed it).
        Worker-measured seconds merge into `timings` at their own cost; the
        wait on the worker lands in `overlap_wait`.

        A prefetch of another page (the step before failed, so `cursor`
        did not advance) is waited out all the same before it is dropped:
        its hash holds the pool's pages, and a second hash beside it could
        hold one page each and wait for the other forever."""
        tf = time.perf_counter()
        pre, self._prefetch = self._prefetch, None
        rows = prehashed = wtimings = None
        if pre is not None:
            try:
                got = pre[1].result()
            except Exception:  # noqa: BLE001 (the page is redone inline)
                got = None
            if got is not None and pre[0] == cursor:
                rows, prehashed, wtimings = got
            timings["overlap_wait"] = (timings.get("overlap_wait", 0.0)
                                       + time.perf_counter() - tf)
        if wtimings:
            for k, v in wtimings.items():
                timings[k] = timings.get(k, 0.0) + v
        if rows is None:
            t0 = time.perf_counter()
            rows = self._fetch_page(ctx, data, cursor)
            timings["fetch"] = timings.get("fetch", 0.0) + time.perf_counter() - t0
        return (rows if rows else None), prehashed

    def _stage_and_hash(self, rows, data: Dict[str, Any], timings: Dict[str, float]):
        """Inline file list + hash of one page."""
        tp = time.perf_counter()
        files = stage_file_list(rows, self.location_id, data["location_path"])
        t1 = time.perf_counter()
        timings["prep"] = timings.get("prep", 0.0) + t1 - tp
        ids, read_errors = self._hash(files)
        timings["hash"] = timings.get("hash", 0.0) + time.perf_counter() - t1
        return files, ids, read_errors

    def _step(self, ctx: JobContext, data: Dict[str, Any]) -> StepOutcome:
        tf = time.perf_counter()
        timings = data.setdefault("phase_s", {})
        phase_before = dict(timings)
        self._ensure_pool(data)
        # Phase 1: the page, outside any transaction. A page the worker did
        # not hash (job start, or the redo of a failed step) is hashed here
        # before the next page's worker starts, so two hashes never run at
        # once and the pool's two pages suffice. Page k+1 is then fetched,
        # staged and hashed by the worker while page k commits.
        rows, prehashed = self._take_page(ctx, data, data["cursor"], timings)
        if rows is None:
            return StepOutcome()
        if prehashed is None:
            prehashed = self._stage_and_hash(rows, data, timings)
        cursor = rows[-1]["id"] + 1
        self._prefetch = (cursor, self._submit(self._fetch_and_hash, ctx, data, cursor))

        # Phase 2: ONE transaction for the page. The cursor in `data` (what
        # the crash checkpoint keeps) advances only after it.
        cas_map = self._get_cas_map(ctx, data)
        batch = TxBatch()
        try:
            with ctx.db.write_tx() as conn:
                linked, created, errors = identify_chunk(
                    ctx.library, rows, prehashed, conn, batch,
                    cas_map=cas_map, timings=timings)
                t_commit = time.perf_counter()
        except BaseException:
            # A rolled-back transaction's objects never existed.
            if cas_map is not None:
                for c in batch.cas_added:
                    cas_map.pop(c, None)
            raise
        timings["db_commit"] = timings.get("db_commit", 0.0) + time.perf_counter() - t_commit
        if batch.n_ops:
            ctx.library.sync._notify_created()
        data["cursor"] = cursor
        self._fold_counts(data)
        timings["step_total"] = timings.get("step_total", 0.0) + time.perf_counter() - tf
        for phase, total in timings.items():
            delta = total - phase_before.get(phase, 0.0)
            if delta > 0:
                IDENT_PHASE_SECONDS.labels(phase=phase).inc(delta)
        if linked:
            IDENT_FILES.labels(outcome="linked").inc(linked)
        if created:
            IDENT_FILES.labels(outcome="created").inc(created)
        if errors:
            IDENT_FILES.labels(outcome="skipped").inc(len(errors))
        data["linked"] += linked
        data["created"] += created
        data["skipped"] += len(errors)
        ctx.progress(message=(f"identified {data['linked'] + data['created']} of "
                              f"{data['total_orphans']} paths"))
        return StepOutcome(errors=errors, metadata={
            "total_objects_linked": data["linked"],
            "total_objects_created": data["created"],
            "total_skipped": data["skipped"],
            "cursor": data["cursor"],
        })

    # -- teardown ------------------------------------------------------------

    def _release(self) -> None:
        """Wait out a pending prefetch, stop the worker thread, let the
        pool's pages go."""
        pre, self._prefetch = self._prefetch, None
        if pre is not None:
            try:
                pre[1].result()
            except Exception:  # noqa: BLE001 (its page is not needed)
                pass
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._pool = None
        self._stream = None

    @staticmethod
    def _restore_indexes(db) -> None:
        """Recreate the bulk-dropped read indexes (no-op when present)."""
        with db.write_tx() as conn:
            conn.execute("CREATE INDEX IF NOT EXISTS idx_file_path_cas_id "
                         "ON file_path (cas_id)")
            conn.execute("CREATE INDEX IF NOT EXISTS idx_file_path_object_id "
                         "ON file_path (object_id)")

    async def suspend(self, ctx, data):
        """A pause or a shutdown: wait out the prefetch (its page is hashed
        again after the resume), stop the worker thread and let the pool
        go. The pool's leases at that point land in ``data["pauses"]``.
        The cas map is dropped too: other writers may add objects while
        the job is paused."""
        pool = self._pool
        await asyncio.to_thread(self._release)
        self._fold_counts(data)
        self._cas_map = None
        data.setdefault("pauses", []).append(
            {"in_use": pool.in_use if pool is not None else 0, "cursor": data["cursor"]})

    async def cleanup(self, ctx, data):
        """Failure or cancel: finalize never runs, so release the pool and
        restore the indexes here."""
        await asyncio.to_thread(self._release)
        await asyncio.to_thread(self._restore_indexes, ctx.db)

    async def finalize(self, ctx, data, metadata):
        pool = self._pool
        await asyncio.to_thread(self._release)
        self._fold_counts(data)
        metadata["pages_hashed"] = data["pages_hashed"]
        if data.get("pauses"):
            metadata["pauses"] = data["pauses"]
        if data.get("rebuild_indexes"):
            t0 = time.perf_counter()
            await asyncio.to_thread(self._restore_indexes, ctx.db)
            data["phase_s"]["index_rebuild"] = time.perf_counter() - t0
        phase = data.get("phase_s")
        if phase:
            metadata["phase_s"] = dict(sorted(phase.items()))
            metadata["chunk_size"] = data.get("chunk_size")
        if "pool" in data:
            metadata["pool"] = {**data["pool"], "in_use_after_hash": self._leases_after_hash,
                                "in_use_at_end": pool.in_use if pool is not None else 0}
        return metadata
