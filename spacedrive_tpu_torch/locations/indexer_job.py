"""IndexerJob: walk a location and persist file_path rows in batches.

Port of ``spacedrive_tpu/locations/indexer_job.py``; the job scratch
rows pack through the port's msgpack codec, byte-equal to the JAX
package's.

Behavioral equivalent of the reference's indexer job
(upstream core/src/location/indexer/indexer_job.rs:140-621):
init walks up to INIT_WALK_LIMIT entries and emits Save steps (chunks of
BATCH_SIZE=1000 creates), Update steps, and one Walk step per deferred
directory; Walk steps call keep_walking and append more steps. Stale rows
found by the walker are deleted. Dir sizes accumulate across steps and are
written in finalize.

All writes go through the sync manager (create/update/delete ops), unlike
the reference which TODOs sync for removals (indexer_job.rs:232).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

from .. import _msgpack
from ..jobs.job import EarlyFinish, JobContext, StatefulJob, StepOutcome, register_job
from ..store import statements
from .paths import IsolatedPath
from .rules import load_rules_for_location
from .walker import ToWalkEntry, WalkedEntry, Walker, WalkResult

BATCH_SIZE = 1000       # indexer_job.rs:48
INIT_WALK_LIMIT = 50_000  # indexer_job.rs:205


def _entry_to_row(e: WalkedEntry, location_id: int) -> Dict[str, Any]:
    m = e.metadata
    return {
        "pub_id": e.pub_id,
        "location_id": location_id,
        "is_dir": int(e.iso.is_dir),
        "materialized_path": e.iso.materialized_path,
        "name": e.iso.name,
        "extension": e.iso.extension,
        "inode": int(m.inode).to_bytes(8, "big"),
        "size_in_bytes_bytes": int(m.size_in_bytes).to_bytes(8, "big"),
        "date_created": m.created_at,
        "date_modified": m.modified_at,
        "date_indexed": time.time(),
    }


def _row_sync_values(row: Dict[str, Any]) -> Dict[str, Any]:
    """Synced field subset (location_id handled as the location pub_id by
    callers; local ids never go on the wire)."""
    return {k: row[k] for k in (
        "is_dir", "materialized_path", "name", "extension",
        "size_in_bytes_bytes", "date_created", "date_modified",
        "date_indexed",
    )}


def make_db_fetchers(db, location_id: int):
    """The walker's injected DB seams, backed by the real store
    (file_paths_db_fetcher_fn!/to_remove_db_fetcher_fn!,
    indexer/mod.rs macros)."""

    def existing(paths):
        out = []
        for p in paths:
            row = db.run("indexer.path_by_key", p.db_key())
            if row is not None:
                out.append(dict(row))
        return out

    def to_remove(parent_iso, iso_paths):
        """Rows directly under parent_iso that the walker did not see."""
        children_mat = parent_iso.materialized_path_for_children()
        if children_mat is None:
            return []
        rows = db.run("indexer.children", (location_id, children_mat))
        seen = {(p.materialized_path, p.name, p.extension)
                for p in iso_paths}
        return [dict(r) for r in rows
                if (r["materialized_path"], r["name"], r["extension"] or "")
                not in seen]

    return existing, to_remove


# -- shared write choreography (used by the job steps AND shallow.py) ------

SYNCED_UPDATE_FIELDS = ("inode", "size_in_bytes_bytes", "date_modified",
                        "date_indexed", "is_dir")


def _consume_scratch(conn, scratch_id: Optional[int]) -> None:
    """Drop a processed step's spooled payload inside the step's own
    domain transaction — commit and consume are atomic, so a crash can
    never land between them (no reliance on idempotent replay)."""
    if scratch_id is not None:
        conn.execute(statements.get("jobs.scratch.delete").sql,
                     (scratch_id,))


def save_file_path_rows(library, location_pub_id: bytes,
                        rows: List[Dict[str, Any]],
                        consume_scratch: Optional[int] = None) -> int:
    """Batched create through sync; replayed steps' unique collisions are
    ignored (IS_BATCHED idempotency).

    A new path whose inode ALREADY has a row is a move the walker saw
    from the destination side (cross-directory renames land in different
    walk steps, so remove-before-save ordering can't cover them): the
    existing row is re-pathed in place — keeping its object link and
    cas_id — instead of colliding with the (location_id, inode) unique
    constraint and being silently dropped."""
    if not rows:
        if consume_scratch is not None:
            with library.db.write_tx() as conn:
                _consume_scratch(conn, consume_scratch)
        return 0
    db, sync = library.db, library.sync

    # ONE batched lookup for the whole chunk's inodes (a per-row query
    # costs ~10 µs × 1M rows on big scans). Keys are the 8-byte big-
    # endian inode blobs as stored (FilePathMetadata.from_stat).
    from ..objects.identifier import _in_chunks

    inodes = sorted({r["inode"] for r in rows if r.get("inode")})
    existing_by_inode: Dict[bytes, Any] = {}
    for chunk in _in_chunks(inodes):
        ph = ",".join("?" for _ in chunk)
        # binds the declared indexer.paths_by_inodes shape
        for e in db.query(
            f"SELECT inode, pub_id, materialized_path, name, extension "
            f"FROM file_path WHERE location_id = ? AND inode IN ({ph})",
                [rows[0]["location_id"], *chunk]):
            existing_by_inode[e["inode"]] = e

    moved: List[Dict[str, Any]] = []
    fresh: List[Dict[str, Any]] = []
    for row in rows:
        existing = existing_by_inode.get(row.get("inode"))
        if existing is None:
            fresh.append(row)
        elif (existing["materialized_path"] != row["materialized_path"]
              or existing["name"] != row["name"]
              or (existing["extension"] or "") != (row["extension"] or "")):
            moved.append({**row, "pub_id": existing["pub_id"]})
        # else: identical path replay — the insert below IGNOREs it

    if moved:
        _repath_rows(library, moved)
    if not fresh:
        if consume_scratch is not None:
            with db.write_tx() as conn:
                _consume_scratch(conn, consume_scratch)
        return len(moved)
    specs = []
    for row in fresh:
        values = _row_sync_values(row)
        values["location_id"] = location_pub_id  # FK syncs as pub_id
        specs.append((row["pub_id"], "c", None, None, values))
    with db.write_tx() as conn:
        n = db.insert_many(
            "file_path", fresh, conn=conn, ignore_conflicts=True)
        n_ops = sync.bulk_shared_ops(conn, "file_path", specs)
        _consume_scratch(conn, consume_scratch)
    if n_ops:
        sync._notify_created()
    return len(moved) + n


def _repath_rows(library, rows: List[Dict[str, Any]]) -> int:
    """Move detected by inode: update the existing row's path identity
    (+ freshness fields) in place, preserving object link and cas_id."""
    db, sync = library.db, library.sync
    fields = ("materialized_path", "name", "extension",
              *SYNCED_UPDATE_FIELDS)
    ops = []
    with db.write_tx() as conn:
        for row in rows:
            values = {k: row[k] for k in fields}
            db.update("file_path", row["pub_id"], values, conn=conn,
                      id_col="pub_id")
            for k, v in values.items():
                ops.append(sync.shared_update(
                    "file_path", row["pub_id"], k, v))
        sync._insert_op_rows(conn, ops)
    if ops:
        sync._notify_created()
    return len(rows)


def update_file_path_rows(library, rows: List[Dict[str, Any]],
                          consume_scratch: Optional[int] = None) -> int:
    """A row lands here when the walker saw its content change
    (size/mtime drift): besides refreshing those fields, the derived
    identity — cas_id, integrity_checksum, object link — is INVALIDATED
    so the identifier re-identifies and the validator re-fills. Without
    this, stale checksums would read as corruption forever (and stale
    cas_ids as wrong dedup identity)."""
    if not rows:
        if consume_scratch is not None:
            with library.db.write_tx() as conn:
                _consume_scratch(conn, consume_scratch)
        return 0
    db, sync = library.db, library.sync
    ops = []
    with db.write_tx() as conn:
        for row in rows:
            values = {k: row[k] for k in SYNCED_UPDATE_FIELDS}
            if not row.get("is_dir"):
                values.update(cas_id=None, integrity_checksum=None,
                              object_id=None)
            db.update("file_path", row["pub_id"], values, conn=conn,
                      id_col="pub_id")
            for k, v in values.items():
                ops.append(sync.shared_update(
                    "file_path", row["pub_id"], k, v))
        sync._insert_op_rows(conn, ops)
        _consume_scratch(conn, consume_scratch)
    if ops:
        sync._notify_created()
    return len(rows)


def remove_file_path_rows(library, location_id: int,
                          removed: List[Dict[str, Any]],
                          consume_scratch: Optional[int] = None) -> int:
    """Delete stale rows; a removed DIRECTORY also deletes every
    descendant row by materialized_path prefix (the walker only reports
    the dir itself — without this, rm -rf'd subtrees leave ghost rows).

    Path-conditional: a row whose (materialized_path, name) no longer
    matches what the walker observed was MOVED and re-pathed by a save
    step since — deleting it by pub_id would destroy the moved file's
    row and object link. Such rows are skipped."""
    if not removed:
        if consume_scratch is not None:
            with library.db.write_tx() as conn:
                _consume_scratch(conn, consume_scratch)
        return 0
    db, sync = library.db, library.sync
    from .file_path_helper import materialized_like
    ops = []
    n = 0
    with db.write_tx() as conn:
        for r in removed:
            if r.get("materialized_path") is not None:
                cur_row = db.run("indexer.path_current",
                                 (r["pub_id"],), conn=conn)
                if cur_row is None:
                    continue  # already gone (replayed step)
                if (cur_row["materialized_path"] != r["materialized_path"]
                        or cur_row["name"] != r.get("name")):
                    continue  # re-pathed by a move — keep it
            if r.get("is_dir") and r.get("materialized_path") is not None:
                children_mat = (f"{r['materialized_path']}{r['name']}/")
                where, params = "location_id = ?", [location_id]
                where = materialized_like(where, params, children_mat)
                # binds the declared indexer.desc_pubs shape
                desc = conn.execute(
                    f"SELECT pub_id FROM file_path WHERE {where}",
                    params).fetchall()
                for d in desc:
                    ops.append(sync.shared_delete("file_path", d["pub_id"]))
                # binds the declared indexer.desc_delete shape
                cur = conn.execute(
                    f"DELETE FROM file_path WHERE {where}", params)
                n += cur.rowcount
            ops.append(sync.shared_delete("file_path", r["pub_id"]))
            db.run("indexer.path_delete_by_pub", (r["pub_id"],),
                   conn=conn)
            n += 1
        sync._insert_op_rows(conn, ops)
        _consume_scratch(conn, consume_scratch)
    if ops:
        sync._notify_created()
    return n


@register_job
class IndexerJob(StatefulJob):
    NAME = "indexer"
    IS_BATCHED = True

    def __init__(self, *, location_id: int, sub_path: Optional[str] = None):
        super().__init__(location_id=location_id, sub_path=sub_path)
        self.location_id = location_id
        self.sub_path = sub_path

    # -- helpers -----------------------------------------------------------

    def _walker(self, ctx: JobContext, location_path: str) -> Walker:
        # One Walker per run: rules can't change mid-job, and per-step
        # reconstruction would re-query the rule tables for every
        # deferred directory.
        cached = getattr(self, "_walker_cache", None)
        if cached is not None and cached.location_path == location_path:
            return cached
        db = ctx.db
        rules = load_rules_for_location(db, self.location_id)
        existing, to_remove = make_db_fetchers(db, self.location_id)
        self._walker_cache = Walker(
            self.location_id, location_path, rules=rules,
            existing_paths_fetcher=existing, to_remove_fetcher=to_remove,
        )
        return self._walker_cache

    def _spool(self, ctx: JobContext,
               batches: List[List[Dict[str, Any]]]) -> List[int]:
        """Write step row-payloads to job_scratch and return their ids.

        Steps then carry a scratch reference instead of inline rows, so
        the worker's 3-second crash checkpoint serializes step
        DESCRIPTORS (bytes) rather than the whole remaining workload —
        inline rows measured ~200 MB / ~23 s per checkpoint at 1M files.
        The scratch rows live in the library DB, so cold_resume finds
        them after a crash exactly like the step list itself."""
        if not batches:
            return []
        sids: List[int] = []
        with ctx.db.write_tx() as conn:
            for b in batches:
                # per-row lastrowid feeds the step descriptors —
                # executemany has no rowid surface; one tx regardless
                cur = ctx.db.run("jobs.scratch.insert",
                                 (ctx.job_id, _msgpack.packb(b)), conn=conn)
                sids.append(cur.lastrowid)
        return sids

    @staticmethod
    def _unspool(ctx: JobContext, step) -> List[Dict[str, Any]]:
        """Rows of a spooled step; [] when the scratch row is already
        consumed (replay of a completed step — consume commits atomically
        with the step's domain writes, so a missing row PROVES the work
        landed)."""
        row = ctx.db.run("jobs.scratch.data", (step["scratch"],))
        if row is None:
            return []
        return _msgpack.unpackb(row["data"])

    def _result_to_steps(self, ctx: JobContext, res: WalkResult,
                         data: Dict[str, Any]) -> List[Any]:
        steps: List[Any] = []
        # Removals are DEFERRED to the end of the job (finalize): a moved
        # file appears as (new path in some dir's walked) + (old path in
        # another dir's to_remove), and only after every save step has
        # had the chance to re-path it by inode can a removal safely
        # judge — path-conditionally — that a row is truly stale.
        # Deferred payloads SPOOL to job_scratch like save/update rows
        # (`data` only carries the scratch ids): inline removal dicts
        # were serialized into every 3-second crash checkpoint, so a
        # mass-removal rescan (rm -rf of a big subtree) regrew the
        # checkpoint blob toward the very problem spooling solved.
        if res.to_remove:
            removals = [
                {k: r.get(k) for k in (
                    "pub_id", "is_dir", "materialized_path", "name")}
                for r in res.to_remove]
            data.setdefault("removal_scratch", []).extend(self._spool(
                ctx, [removals[i:i + BATCH_SIZE]
                      for i in range(0, len(removals), BATCH_SIZE)]))
        save_rows = [_entry_to_row(e, self.location_id) for e in res.walked]
        save_batches = [save_rows[i:i + BATCH_SIZE]
                        for i in range(0, len(save_rows), BATCH_SIZE)]
        upd_rows = [_entry_to_row(e, self.location_id) for e in res.to_update]
        upd_batches = [upd_rows[i:i + BATCH_SIZE]
                       for i in range(0, len(upd_rows), BATCH_SIZE)]
        sids = self._spool(ctx, save_batches + upd_batches)
        steps.extend({"kind": "save", "scratch": sid}
                     for sid in sids[:len(save_batches)])
        steps.extend({"kind": "update", "scratch": sid}
                     for sid in sids[len(save_batches):])
        for w in res.to_walk:
            steps.append({"kind": "walk", "path": w.path,
                          "accepted": w.parent_dir_accepted_by_its_children,
                          "parent": w.maybe_parent})
        for p, s in res.paths_and_sizes.items():
            data["dir_sizes"][p] = data["dir_sizes"].get(p, 0) + s
        return steps

    # -- lifecycle ---------------------------------------------------------

    async def init(self, ctx: JobContext):
        db = ctx.db
        loc = db.run("location.by_id", (self.location_id,))
        if loc is None or not loc["path"]:
            raise EarlyFinish(f"location {self.location_id} gone")
        location_path = loc["path"]
        to_walk_path = location_path
        if self.sub_path:
            iso = IsolatedPath.new(
                self.location_id, location_path,
                f"{location_path.rstrip('/')}/{self.sub_path.strip('/')}",
                True)
            to_walk_path = iso.join_on(location_path)
        data: Dict[str, Any] = {
            "location_path": location_path,
            "location_pub_id": loc["pub_id"],
            "dir_sizes": {},
            # Scratch-row ids of spooled removal batches.
            "removal_scratch": [],
            "total_saved": 0, "total_updated": 0, "total_removed": 0,
            # Seconds per phase (walk, spool, save, update, remove,
            # dir_sizes), reported in the job's metadata.
            "phase_s": {},
        }
        walker = self._walker(ctx, location_path)
        res = await self._timed(data, "walk", walker.walk, to_walk_path, INIT_WALK_LIMIT)
        # Step building spools row batches into job_scratch (db writes):
        # off the event loop.
        steps = await self._timed(data, "spool", self._result_to_steps, ctx, res, data)
        # A pure-removal rescan (rm -rf'd subtree, nothing new) emits
        # zero steps but must still reach finalize, where the spooled
        # removals are applied — EarlyFinish here would both strand the
        # stale rows and leak the scratch payloads.
        if not steps and not data["removal_scratch"]:
            raise EarlyFinish("nothing to index")
        return data, steps

    @staticmethod
    async def _timed(data, phase: str, fn, *args):
        """fn(*args) off the event loop, its seconds added to data's phase."""
        t0 = time.perf_counter()
        try:
            return await asyncio.to_thread(fn, *args)
        finally:
            ph = data.setdefault("phase_s", {})
            ph[phase] = ph.get(phase, 0.0) + time.perf_counter() - t0

    async def execute_step(self, ctx: JobContext, data, step, step_number):
        kind = step["kind"]
        if kind == "save":
            return await self._timed(data, "save", self._save, ctx, data, step)
        if kind == "update":
            return await self._timed(data, "update", self._update, ctx, data, step)
        if kind == "remove":
            return await self._timed(data, "remove", self._remove, ctx, data, step)
        # walk step: descend one deferred directory.
        walker = self._walker(ctx, data["location_path"])
        res = await self._timed(
            data, "walk", walker.keep_walking,
            ToWalkEntry(step["path"], step.get("accepted"), step.get("parent")))
        more = await self._timed(data, "spool", self._result_to_steps, ctx, res, data)
        return StepOutcome(more_steps=more, errors=list(res.errors))

    def _save(self, ctx: JobContext, data, step) -> StepOutcome:
        n = save_file_path_rows(
            ctx.library, data["location_pub_id"], self._unspool(ctx, step),
            consume_scratch=step.get("scratch"))
        data["total_saved"] += n
        ctx.progress(message=f"saved {data['total_saved']} paths")
        return StepOutcome(metadata={"indexed_count": data["total_saved"]})

    def _update(self, ctx: JobContext, data, step) -> StepOutcome:
        data["total_updated"] += update_file_path_rows(
            ctx.library, self._unspool(ctx, step),
            consume_scratch=step.get("scratch"))
        return StepOutcome(metadata={"updated_count": data["total_updated"]})

    def _remove(self, ctx: JobContext, data, step) -> StepOutcome:
        data["total_removed"] += remove_file_path_rows(
            ctx.library, self.location_id, self._unspool(ctx, step),
            consume_scratch=step.get("scratch"))
        return StepOutcome(metadata={"removed_count": data["total_removed"]})

    async def cleanup(self, ctx: JobContext, data):
        """Cancel/failure path (finalize never runs): sweep this job's
        spooled step payloads. Resume-after-pause does NOT come through
        here — paused jobs keep their scratch rows alive alongside the
        persisted step list that references them."""
        if ctx.job_id:
            await asyncio.to_thread(
                ctx.db.run_tx, "jobs.scratch.delete_for_job",
                (ctx.job_id,))

    def _write_dir_sizes(self, ctx: JobContext, data) -> int:
        """Deferred dir-size writes + their sync ops in ONE tx.

        size_in_bytes_bytes is a SYNCED field (store/models.py), so the
        sizes an index run computes must reach peers — the bare UPDATE
        this used to do diverged replicas silently. Returns ops emitted; the caller fires the created
        notification outside the tx."""
        db = ctx.db
        sync = ctx.library.sync
        loc_path = data["location_path"]
        with db.write_tx() as conn:
            specs = []
            for path, size in data["dir_sizes"].items():
                try:
                    iso = IsolatedPath.new(
                        self.location_id, loc_path, path, True)
                except ValueError:
                    continue
                row = ctx.db.run(
                    "indexer.id_pub_by_key",
                    (iso.location_id, iso.materialized_path, iso.name,
                     iso.extension), conn=conn)
                if row is None:
                    continue
                blob = int(size).to_bytes(8, "big")
                # interleaved with the per-row key resolution above;
                # the whole rollup is already ONE tx
                ctx.db.run("indexer.set_dir_size", (blob, row["id"]),
                           conn=conn)
                specs.append((row["pub_id"], "u:size_in_bytes_bytes",
                              "size_in_bytes_bytes", blob, None))
            return sync.bulk_shared_ops(conn, "file_path", specs)

    async def finalize(self, ctx: JobContext, data, metadata):
        """Execute deferred removals (every save has had its chance to
        re-path moved inodes by now), then write accumulated dir sizes
        onto their file_path rows (indexer_job.rs finalize semantics)."""
        for sid in data.get("removal_scratch") or []:
            # Unspool each deferred-removal batch; a consumed/missing
            # row proves a replayed finalize already removed it.
            rows = await asyncio.to_thread(
                self._unspool, ctx, {"scratch": sid})
            data["total_removed"] += await self._timed(
                data, "remove", remove_file_path_rows, ctx.library,
                self.location_id, rows, sid)
        data["removal_scratch"] = []
        db = ctx.db
        if await self._timed(data, "dir_sizes", self._write_dir_sizes, ctx, data):
            ctx.library.sync._notify_created()
        if ctx.job_id:  # sweep any unconsumed scratch (replays, errors)
            await asyncio.to_thread(
                db.run_tx, "jobs.scratch.delete_for_job", (ctx.job_id,))
        metadata.setdefault("indexed_count", data["total_saved"])
        metadata.setdefault("updated_count", data["total_updated"])
        metadata.setdefault("removed_count", data["total_removed"])
        metadata["phase_s"] = dict(sorted(data["phase_s"].items()))
        return metadata
