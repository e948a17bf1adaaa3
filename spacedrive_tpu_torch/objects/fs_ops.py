"""Filesystem operation jobs: copy, cut, delete, erase.

Port of ``spacedrive_tpu/objects/fs_ops.py`` (upstream
core/src/object/fs/{mod,copy,cut,delete,erase}.rs):

- copy: one step a file; a directory expands into child steps when it
  runs (copy.rs:100-170); a name taken resolves by a " (N)" suffix
  (mod.rs:157-218, DUPLICATE_PATTERN " \\(\\d+\\)" mod.rs:36).
- cut: a rename within or between locations, copy and delete across
  devices (cut.rs).
- delete: removes a file or a whole tree (delete.rs:34).
- erase: overwrites a file's bytes with `passes` rounds of random data,
  then unlinks it (erase.rs:60-160); a directory expands to its children
  and is removed in finalize. The overwrite runs in Python, as the JAX
  job's own branch without the native library does.

Steps are plain dicts resolved from file_path ids at init, so a paused
job survives the process, as every StatefulJob does; the four jobs are in
``JOB_REGISTRY`` and cold-resume.
"""

from __future__ import annotations

import asyncio
import os
import re
import secrets
import shutil
from typing import Any, Dict, List, Optional

from ..jobs.job import EarlyFinish, JobContext, StatefulJob, StepOutcome, register_job
from ..locations.file_path_helper import load_location
from ..locations.paths import IsolatedPath

DUPLICATE_PATTERN = re.compile(r" \(\d+\)")  # fs/mod.rs:36
ERASE_BLOCK = 1_048_576


class FsJobError(Exception):
    pass


def construct_target_filename(name: str, extension: str, is_dir: bool) -> str:
    """fs/mod.rs:135-155."""
    if is_dir or not extension:
        return name
    return f"{name}.{extension}"


def append_digit_to_filename(file_name: str, ext: Optional[str],
                             current_int: int) -> str:
    """fs/mod.rs:157-175: strip a trailing ' (N)' then append ' (i)'.
    Only a suffix match is stripped — 'report (1) final' keeps its
    mid-name ' (1)'."""
    matches = list(DUPLICATE_PATTERN.finditer(file_name))
    base = file_name
    if matches and matches[-1].end() == len(file_name):
        base = file_name[:matches[-1].start()]
    if ext:
        return f"{base} ({current_int}).{ext}"
    return f"{base} ({current_int})"


def find_available_filename_for_duplicate(target_path: str) -> str:
    """First ' (N)' variant that doesn't exist (fs/mod.rs:177-218)."""
    parent = os.path.dirname(target_path)
    base = os.path.basename(target_path)
    dot = base.rfind(".")
    if dot > 0:
        stem, ext = base[:dot], base[dot + 1:]
    else:
        stem, ext = base, None
    for i in range(1, 1 << 16):
        candidate = os.path.join(
            parent, append_digit_to_filename(stem, ext, i))
        if not os.path.exists(candidate):
            return candidate
    raise FsJobError(f"failed to find available name for {target_path}")


def _file_datas(db, location_id: int, location_path: str,
                file_path_ids: List[int]) -> List[Dict[str, Any]]:
    """get_many_files_datas (fs/mod.rs:53-87): resolve ids → full paths."""
    out = []
    for fid in file_path_ids:
        row = db.run("api.file_path.by_id", (fid,))
        if row is None:
            raise FsJobError(f"file_path {fid} not found")
        iso = IsolatedPath.from_db_row(
            location_id, bool(row["is_dir"]), row["materialized_path"],
            row["name"] or "", row["extension"] or "")
        out.append({
            "id": row["id"], "pub_id": row["pub_id"],
            "is_dir": bool(row["is_dir"]),
            "name": row["name"] or "", "extension": row["extension"] or "",
            "full_path": iso.join_on(location_path),
        })
    return out


def _child_step(db, location_id: int, location_path: str, child_path: str,
                is_dir: bool) -> Optional[Dict[str, Any]]:
    """Resolve a directory child into a step via its DB row; unindexed
    children are skipped by copy (copy.rs:152-159) but still processed by
    delete/erase paths via raw fs operations."""
    try:
        iso = IsolatedPath.new(location_id, location_path, child_path, is_dir)
    except ValueError:
        return None
    row = db.run("indexer.path_by_key", iso.db_key())
    if row is None:
        return None
    return {
        "id": row["id"], "pub_id": row["pub_id"],
        "is_dir": bool(row["is_dir"]),
        "name": row["name"] or "", "extension": row["extension"] or "",
        "full_path": child_path,
    }


class _FsJobBase(StatefulJob):
    """Common init: resolve location + file datas into steps."""

    def __init__(self, *, location_id: int, file_path_ids: List[int],
                 **extra: Any):
        super().__init__(location_id=location_id,
                         file_path_ids=list(file_path_ids), **extra)
        self.location_id = location_id
        self.file_path_ids = list(file_path_ids)

    def _location_path(self, ctx: JobContext) -> str:
        return load_location(ctx.db, self.location_id)["path"]


@register_job
class FileDeleterJob(_FsJobBase):
    NAME = "file_deleter"  # delete.rs:34

    async def init(self, ctx: JobContext):
        path = await asyncio.to_thread(self._location_path, ctx)
        steps = await asyncio.to_thread(
            _file_datas, ctx.db, self.location_id, path,
            self.file_path_ids)
        if not steps:
            raise EarlyFinish("nothing to delete")
        return {"location_path": path}, steps

    async def execute_step(self, ctx, data, step, step_number):
        def run():
            # Idempotent: a replayed step whose target already vanished is
            # a no-op (steps replay after pause/crash, jobs/job.py).
            full = step["full_path"]
            if step["is_dir"]:
                shutil.rmtree(full, ignore_errors=True)
            elif os.path.lexists(full):
                os.remove(full)
        await asyncio.to_thread(run)
        return StepOutcome()


@register_job
class FileEraserJob(_FsJobBase):
    NAME = "file_eraser"  # erase.rs:63

    def __init__(self, *, location_id: int, file_path_ids: List[int],
                 passes: int = 1):
        super().__init__(location_id=location_id,
                         file_path_ids=file_path_ids, passes=passes)
        self.passes = passes

    async def init(self, ctx: JobContext):
        path = await asyncio.to_thread(self._location_path, ctx)
        steps = await asyncio.to_thread(
            _file_datas, ctx.db, self.location_id, path,
            self.file_path_ids)
        if not steps:
            raise EarlyFinish("nothing to erase")
        return {"location_path": path, "dirs_to_remove": []}, steps

    def _expand_dir(self, ctx: JobContext, data, step) -> list:
        # Expand children as further steps; dir removed in finalize
        # (erase.rs:99-137). Unindexed children MUST still be erased —
        # skipping them would delete plaintext bytes unscrubbed — so
        # they get synthetic steps without DB rows.
        more = []
        for entry in os.scandir(step["full_path"]):
            if entry.is_symlink():
                # NEVER scrub through a symlink — the target may live
                # outside the erase scope. Remove just the link.
                os.remove(entry.path)
                continue
            is_dir = entry.is_dir(follow_symlinks=False)
            child = _child_step(
                ctx.db, self.location_id, data["location_path"],
                entry.path, is_dir)
            if child is None:
                child = {"id": None, "pub_id": None, "is_dir": is_dir,
                         "name": entry.name, "extension": "",
                         "full_path": entry.path}
            more.append(child)
        return more

    async def execute_step(self, ctx, data, step, step_number):
        if step["is_dir"]:
            more = await asyncio.to_thread(self._expand_dir, ctx, data, step)
            data["dirs_to_remove"].append(step["full_path"])
            return StepOutcome(more_steps=more)

        def erase():
            full = step["full_path"]
            if os.path.islink(full):
                os.remove(full)
                return
            if not os.path.exists(full):
                return  # replayed step: already erased
            size = os.path.getsize(full)
            # In-place overwrite is the point of a secure erase.
            with open(full, "r+b") as f:
                for _ in range(max(1, self.passes)):
                    f.seek(0)
                    remaining = size
                    while remaining > 0:
                        n = min(ERASE_BLOCK, remaining)
                        f.write(secrets.token_bytes(n))
                        remaining -= n
                    f.flush()
                    os.fsync(f.fileno())
                f.truncate(0)
            os.remove(full)
        await asyncio.to_thread(erase)
        return StepOutcome(metadata={"erased": step["full_path"]})

    async def finalize(self, ctx, data, metadata):
        def sweep():
            # Deepest-first so nested dirs go before their parents.
            for d in sorted(data["dirs_to_remove"], key=len, reverse=True):
                try:
                    os.rmdir(d)
                except OSError:
                    shutil.rmtree(d, ignore_errors=True)
        await asyncio.to_thread(sweep)
        return metadata


class _CopyBase(_FsJobBase):
    """Shared copy machinery for copy and the cross-device cut fallback."""

    def __init__(self, *, location_id: int, file_path_ids: List[int],
                 target_location_id: int,
                 target_relative_directory: str = "", **extra: Any):
        super().__init__(
            location_id=location_id, file_path_ids=file_path_ids,
            target_location_id=target_location_id,
            target_relative_directory=target_relative_directory, **extra)
        self.target_location_id = target_location_id
        self.target_relative_directory = target_relative_directory

    def _init_sync(self, ctx: JobContext):
        db = ctx.db
        src_path = self._location_path(ctx)
        tgt_loc = load_location(db, self.target_location_id)
        tgt_base = os.path.join(
            tgt_loc["path"],
            self.target_relative_directory.strip("/").replace("/", os.sep))
        steps = []
        for fd in _file_datas(db, self.location_id, src_path,
                              self.file_path_ids):
            target = os.path.join(tgt_base, construct_target_filename(
                fd["name"], fd["extension"], fd["is_dir"]))
            fd["target_full_path"] = target
            steps.append(fd)
        if not steps:
            raise EarlyFinish("nothing to copy")
        return {"sources_location_path": src_path}, steps


@register_job
class FileCopierJob(_CopyBase):
    NAME = "file_copier"  # copy.rs:55

    async def execute_step(self, ctx, data, step, step_number):
        return await asyncio.to_thread(self._copy_one, ctx, data, step)

    def _copy_one(self, ctx: JobContext, data, step) -> StepOutcome:
        src, target = step["full_path"], step["target_full_path"]
        if step["is_dir"]:
            # Existing target dirs MERGE (children dedup individually) —
            # matching the reference's create_dir_all with no dir-level
            # " (N)" dedup (copy.rs:117-120,152).
            os.makedirs(target, exist_ok=True)
            more = []
            for entry in os.scandir(src):
                child = _child_step(
                    ctx.db, self.location_id, data["sources_location_path"],
                    entry.path, entry.is_dir(follow_symlinks=False))
                if child is None:
                    continue  # not indexed → skipped (copy.rs:152-159)
                child["target_full_path"] = os.path.join(
                    target, os.path.relpath(entry.path, src))
                more.append(child)
            return StepOutcome(more_steps=more)
        if os.path.exists(target):
            same_file = False
            try:
                same_file = os.path.samefile(src, target)
            except OSError:
                pass
            if not same_file:
                # Replay detection (idempotent steps): an interrupted-
                # then-replayed copy finds its own completed output —
                # identical size+mtime — and must not spawn a ' (N)'
                # duplicate. (duplicateFiles into the same dir hits the
                # samefile branch above and always dedup-names.)
                try:
                    import filecmp
                    if filecmp.cmp(src, target, shallow=True):
                        return StepOutcome()
                except OSError:
                    pass
            try:
                target = find_available_filename_for_duplicate(target)
            except FsJobError as e:
                return StepOutcome(errors=[str(e)])
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copy2(src, target)
        return StepOutcome()


@register_job
class FileCutterJob(_CopyBase):
    NAME = "file_cutter"  # cut.rs:43

    async def execute_step(self, ctx, data, step, step_number):
        def run() -> StepOutcome:
            src, target = step["full_path"], step["target_full_path"]
            if os.path.normpath(src) == os.path.normpath(target):
                return StepOutcome(
                    errors=[f"source and target are the same: {src}"])
            if not os.path.lexists(src):
                if os.path.exists(target):
                    return StepOutcome()  # replayed step: move completed
                return StepOutcome(errors=[f"source missing: {src}"])
            if os.path.exists(target):
                target2 = find_available_filename_for_duplicate(target)
            else:
                target2 = target
            os.makedirs(os.path.dirname(target2), exist_ok=True)
            try:
                # User-file MOVE (the cut job relocates the user's
                # bytes), not an artifact commit; cross-device falls
                # back to copy+delete.
                os.rename(src, target2)
            except OSError:
                # Cross-device: copy then delete.
                if step["is_dir"]:
                    shutil.copytree(src, target2)
                    shutil.rmtree(src)
                else:
                    shutil.copy2(src, target2)
                    os.remove(src)
            return StepOutcome()
        return await asyncio.to_thread(run)
