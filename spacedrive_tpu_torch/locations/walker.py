"""Rule-filtered filesystem walker with injected DB fetchers.

The port's own copy of ``spacedrive_tpu/locations/walker.py``, less the
shallow walk (``walk_single_dir``), which waits with ``locations/shallow.py``.

Behavioral equivalent of the reference's walker
(upstream core/src/location/indexer/walk.rs:116-690): iterative BFS
with per-entry rule application, dedup against the DB via *injected fetcher
closures* (the reference's main testing seam — walk.rs:695-1071 passes stub
closures so the walker runs without a database), deferred directory queue,
per-directory size accounting, and change detection (inode/mtime) to split
results into to_create / to_update / to_remove.

Synchronous by design: jobs run it via asyncio.to_thread, keeping the
event loop responsive (the reference uses tokio's async fs instead).
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..sync.crdt import uuid4_bytes
from .paths import IsolatedPath
from .rules import IndexerRule, RuleKind, apply_all

# Mtime comparisons tolerate 1 ms like the reference (walk.rs:378-380:
# DB datetimes lose precision).
MTIME_DELTA_S = 0.001


@dataclass(frozen=True)
class FilePathMetadata:
    """Subset of stat() persisted on every file_path row
    (file_path_helper/mod.rs:123-129)."""

    inode: int
    size_in_bytes: int
    created_at: float
    modified_at: float
    hidden: bool

    @classmethod
    def from_stat(cls, path: str, st: os.stat_result) -> "FilePathMetadata":
        name = os.path.basename(path)
        return cls(
            inode=st.st_ino,
            size_in_bytes=st.st_size,
            created_at=getattr(st, "st_birthtime", st.st_ctime),
            modified_at=st.st_mtime,
            hidden=name.startswith("."),  # unix semantics (mod.rs:131-144)
        )


@dataclass
class WalkedEntry:
    pub_id: bytes
    iso: IsolatedPath
    metadata: FilePathMetadata


@dataclass
class ToWalkEntry:
    path: str
    parent_dir_accepted_by_its_children: Optional[bool] = None
    maybe_parent: Optional[str] = None


@dataclass
class WalkResult:
    walked: List[WalkedEntry]           # new entries to create
    to_update: List[WalkedEntry]        # existing rows whose fs state changed
    to_walk: Deque[ToWalkEntry]         # deferred directories (batched jobs)
    to_remove: List[dict]               # stale rows {pub_id, cas_id, ...}
    errors: List[str]
    paths_and_sizes: Dict[str, int]     # dir path → accumulated size


# Injected seams (walk.rs:121-129). Both receive IsolatedPath keys:
# - existing_paths_fetcher(iso_paths) -> rows with at least
#   {pub_id, inode, date_modified, size_in_bytes_bytes, is_dir,
#    materialized_path, name, extension}
# - to_remove_fetcher(parent_iso, iso_paths) -> rows for paths under
#   parent_iso that are in the DB but NOT in iso_paths.
ExistingFetcher = Callable[[Sequence[IsolatedPath]], List[dict]]
ToRemoveFetcher = Callable[[IsolatedPath, Sequence[IsolatedPath]], List[dict]]


def _noop_existing(_paths: Sequence[IsolatedPath]) -> List[dict]:
    return []


def _noop_to_remove(_parent: IsolatedPath,
                    _paths: Sequence[IsolatedPath]) -> List[dict]:
    return []


class Walker:
    def __init__(
        self,
        location_id: int,
        location_path: str,
        rules: Sequence[IndexerRule] = (),
        existing_paths_fetcher: ExistingFetcher = _noop_existing,
        to_remove_fetcher: ToRemoveFetcher = _noop_to_remove,
        update_notifier: Optional[Callable[[str, int], None]] = None,
    ):
        self.location_id = location_id
        self.location_path = os.path.normpath(os.fspath(location_path))
        self.rules = list(rules)
        self.existing_paths_fetcher = existing_paths_fetcher
        self.to_remove_fetcher = to_remove_fetcher
        self.update_notifier = update_notifier or (lambda path, count: None)

    def _iso(self, path: str, is_dir: bool) -> IsolatedPath:
        return IsolatedPath.new(self.location_id, self.location_path, path, is_dir)

    # -- public entry points (walk / keep_walking) --------------------------

    def walk(self, root: Optional[str] = None, limit: int = 2**63) -> WalkResult:
        """Full BFS from `root` (default: the location root), stopping once
        `limit` paths are collected (remaining dirs stay in to_walk —
        walk.rs:178-182 semantics for batched indexer steps)."""
        root = os.path.normpath(root or self.location_path)
        to_walk: Deque[ToWalkEntry] = deque([ToWalkEntry(root)])
        indexed: Dict[IsolatedPath, WalkedEntry] = {}
        errors: List[str] = []
        to_remove: List[dict] = []
        paths_and_sizes: Dict[str, int] = {}

        while to_walk:
            entry = to_walk.popleft()
            size = self._walk_one(entry, indexed, to_walk, to_remove, errors,
                                  root=root)
            paths_and_sizes[entry.path] = \
                paths_and_sizes.get(entry.path, 0) + size
            if entry.maybe_parent is not None:
                paths_and_sizes[entry.maybe_parent] = \
                    paths_and_sizes.get(entry.maybe_parent, 0) + size
            if len(indexed) >= limit:
                break

        walked, to_update = self._filter_existing(indexed)
        return WalkResult(walked, to_update, to_walk, to_remove, errors,
                          paths_and_sizes)

    def keep_walking(self, entry: ToWalkEntry) -> WalkResult:
        """Process ONE deferred directory, returning newly deferred child
        dirs (keep_walking, walk.rs:199-262) — the indexer's Walk step."""
        to_walk: Deque[ToWalkEntry] = deque()
        indexed: Dict[IsolatedPath, WalkedEntry] = {}
        errors: List[str] = []
        to_remove: List[dict] = []
        size = self._walk_one(entry, indexed, to_walk, to_remove, errors,
                              root=entry.path)
        walked, to_update = self._filter_existing(indexed)
        sizes = {entry.path: size}
        if entry.maybe_parent is not None:
            sizes[entry.maybe_parent] = size
        return WalkResult(walked, to_update, to_walk, to_remove, errors, sizes)

    def walk_single_dir(self, root: Optional[str] = None,
                        add_root: bool = False) -> WalkResult:
        """Shallow, non-recursive walk of one directory (walk.rs:262-330),
        the light rescan's walk. With `add_root` the directory itself is
        indexed too."""
        root = os.path.normpath(root or self.location_path)
        indexed: Dict[IsolatedPath, WalkedEntry] = {}
        errors: List[str] = []
        to_remove: List[dict] = []
        if add_root:
            try:
                st = os.stat(root)
                iso = self._iso(root, True)
                indexed[iso] = WalkedEntry(uuid4_bytes(), iso,
                                           FilePathMetadata.from_stat(root, st))
            except OSError as e:
                errors.append(f"{root}: {e}")
        size = self._walk_one(ToWalkEntry(root), indexed, None, to_remove, errors,
                              root=root)
        walked, to_update = self._filter_existing(indexed)
        return WalkResult(walked, to_update, deque(), to_remove, errors, {root: size})

    # -- core per-directory pass (inner_walk_single_dir, walk.rs:430-690) --

    def _walk_one(
        self,
        entry: ToWalkEntry,
        indexed: Dict[IsolatedPath, WalkedEntry],
        to_walk: Optional[Deque[ToWalkEntry]],
        to_remove: List[dict],
        errors: List[str],
        root: str,
    ) -> int:
        path = entry.path
        try:
            parent_iso = self._iso(path, True)
        except ValueError as e:
            errors.append(str(e))
            return 0
        try:
            entries = list(os.scandir(path))
        except OSError as e:
            errors.append(f"{path}: {e}")
            return 0

        buffer: Dict[IsolatedPath, WalkedEntry] = {}
        for dirent in entries:
            accept_by_children_dir = entry.parent_dir_accepted_by_its_children
            current = dirent.path
            self.update_notifier(current, len(indexed) + len(buffer))

            per_kind = apply_all(self.rules, current)
            rejects = per_kind.get(RuleKind.REJECT_FILES_BY_GLOB)
            if rejects and not all(rejects):
                continue

            try:
                if dirent.is_symlink():  # hard-ignored (walk.rs:529-532)
                    continue
                st = dirent.stat()
                is_dir = dirent.is_dir()
            except OSError as e:
                errors.append(f"{current}: {e}")
                continue

            if is_dir:
                cr = per_kind.get(
                    RuleKind.REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT)
                if cr and not all(cr):
                    continue
                ca = per_kind.get(
                    RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT)
                if ca is not None:
                    if any(ca):
                        accept_by_children_dir = True
                    elif accept_by_children_dir is None:
                        accept_by_children_dir = False
                # Dirs are queued for descent even when accept-globs skip
                # them as entries (walk.rs:575-583 runs before the
                # accept-glob check).
                if to_walk is not None:
                    to_walk.append(ToWalkEntry(
                        current, accept_by_children_dir, path))

            accepts = per_kind.get(RuleKind.ACCEPT_FILES_BY_GLOB)
            if accepts is not None and not any(accepts):
                continue

            if accept_by_children_dir is False:
                continue

            # derive the child iso from the parent's fields — no
            # normpath / prefix-check round trip per dirent
            iso = parent_iso.child(dirent.name, is_dir)
            buffer[iso] = WalkedEntry(
                uuid4_bytes(), iso,
                FilePathMetadata.from_stat(current, st),
            )

            # Index any not-yet-seen ancestors up to (not incl.) the walk
            # root (walk.rs:617-660) — accept-globs can make a file appear
            # before its parent dir was accepted as an entry.
            ancestor = os.path.dirname(current)
            while ancestor != root and len(ancestor) > len(root):
                try:
                    aiso = self._iso(ancestor, True)
                except ValueError:
                    break
                if aiso in indexed or aiso in buffer:
                    break
                try:
                    ast = os.stat(ancestor)
                except OSError as e:
                    errors.append(f"{ancestor}: {e}")
                    ancestor = os.path.dirname(ancestor)
                    continue
                buffer[aiso] = WalkedEntry(
                    uuid4_bytes(), aiso,
                    FilePathMetadata.from_stat(ancestor, ast),
                )
                ancestor = os.path.dirname(ancestor)

        try:
            to_remove.extend(
                self.to_remove_fetcher(parent_iso, list(buffer)))
        except Exception as e:  # soft failure (walk.rs:663-672)
            errors.append(f"to_remove fetch {path}: {e}")

        total = sum(w.metadata.size_in_bytes for w in buffer.values())
        indexed.update(buffer)
        return total

    # -- DB dedup (filter_existing_paths, walk.rs:332-424) -----------------

    def _filter_existing(
        self, indexed: Dict[IsolatedPath, WalkedEntry]
    ) -> Tuple[List[WalkedEntry], List[WalkedEntry]]:
        if not indexed:
            return [], []
        rows = self.existing_paths_fetcher(list(indexed))
        by_key = {}
        for row in rows:
            iso = IsolatedPath.from_db_row(
                self.location_id, bool(row["is_dir"]),
                row["materialized_path"], row["name"], row["extension"] or "",
            )
            by_key[iso] = row
        to_create: List[WalkedEntry] = []
        to_update: List[WalkedEntry] = []
        for iso, entry in indexed.items():
            row = by_key.get(iso)
            if row is None:
                to_create.append(entry)
                continue
            db_inode = row.get("inode")
            db_inode = int.from_bytes(db_inode[:8], "big") if db_inode else None
            db_mtime = row.get("date_modified") or 0
            db_size = row.get("size_in_bytes_bytes")
            db_size = int.from_bytes(db_size, "big") if db_size else 0
            # Dir sizes are computed aggregates, not fs stat sizes, so size
            # never participates in change detection for dirs. (The
            # reference instead vetoes the whole update when a dir's stat
            # size differs from the stored aggregate — walk.rs:371-404 —
            # which suppresses nearly every dir update; deliberately not
            # mirrored.)
            changed = (
                db_inode != entry.metadata.inode
                or entry.metadata.modified_at - db_mtime > MTIME_DELTA_S
            )
            if changed:
                to_update.append(WalkedEntry(
                    row["pub_id"], iso, entry.metadata))
        return to_create, to_update
