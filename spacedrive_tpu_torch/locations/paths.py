"""Path algebra: the identity of every file row.

The port's own copy of ``spacedrive_tpu/locations/paths.py``, unchanged.

The (location_id, materialized_path, name, extension, is_dir) tuple ↔
filesystem path mapping, mirroring the semantics of the reference's
`IsolatedFilePathData`
(upstream core/src/location/file_path_helper/isolated_file_path_data.rs:27-556):

- `materialized_path` is the parent directory relative to the location
  root, always "/"-separated, always starting and ending with "/"
  ("/" for the root itself).
- `name` excludes the extension for files, includes everything for dirs.
- `extension` is everything after the last dot (empty for dirs, dotfiles,
  and extension-less files; a leading dot means hidden file, not
  extension).
- the unique key in the DB is (location_id, materialized_path, name,
  extension) — see store/models.py file_path uniques.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple


_FORBIDDEN_NAME = re.compile(r"/|\x00")  # POSIX rules (isolated_file_path_data.rs:181-200)


def accept_file_name(name: str) -> bool:
    return not _FORBIDDEN_NAME.search(name)


def _split_name_ext(stem: str) -> Tuple[str, str]:
    """Name/extension split: last dot wins, a dot at index 0 is a hidden
    file not an extension (isolated_file_path_data.rs:158-176)."""
    last_dot = stem.rfind(".")
    if last_dot <= 0:
        return stem, ""
    return stem[:last_dot], stem[last_dot + 1:]


def _name_ext(base: str, is_dir: bool):
    """The one name/extension split rule for every constructor —
    desynchronizing walk-time and parse-time DB keys is the failure
    this helper prevents."""
    return (base, "") if is_dir else _split_name_ext(base)


def _relative_to_location(location_path: str, full_path: str) -> str:
    loc = os.path.normpath(os.fspath(location_path))
    full = os.path.normpath(os.fspath(full_path))
    if full == loc:
        return ""
    prefix = loc.rstrip(os.sep) + os.sep
    if not full.startswith(prefix):
        raise ValueError(
            f"path {full!r} is not inside location {loc!r}"
        )
    return full[len(prefix):].replace(os.sep, "/")


def materialized_path_str(location_path: str, full_path: str) -> str:
    """Parent dir of full_path relative to the location root, normalized
    (extract_normalized_materialized_path_str, isolated_file_path_data.rs:485-513)."""
    rel = _relative_to_location(location_path, full_path)
    if not rel:
        return "/"
    parent = rel.rsplit("/", 1)[0] if "/" in rel else ""
    return f"/{parent}/" if parent else "/"


@dataclass(frozen=True)
class IsolatedPath:
    location_id: int
    materialized_path: str
    is_dir: bool
    name: str
    extension: str
    relative_path: str = field(default="", compare=False)

    # -- constructors ------------------------------------------------------

    @classmethod
    def new(cls, location_id: int, location_path: str | os.PathLike,
            full_path: str | os.PathLike, is_dir: bool) -> "IsolatedPath":
        rel = _relative_to_location(os.fspath(location_path), os.fspath(full_path))
        if not rel:  # the location root itself
            return cls(location_id, "/", True, "", "", "")
        mat = materialized_path_str(os.fspath(location_path), os.fspath(full_path))
        base = rel.rsplit("/", 1)[-1]
        name, ext = _name_ext(base, is_dir)
        return cls(location_id, mat, is_dir, name, ext, rel)

    def child(self, base: str, is_dir: bool) -> "IsolatedPath":
        """Child entry of this DIRECTORY, derived without touching the
        filesystem path algebra — the walker's per-dirent fast path
        (profiling showed normpath+prefix checks in `new()` were ~40%
        of pure walk time at 60k files; the parent's fields already
        hold everything the child needs)."""
        # mat comes from the IDENTITY fields (the same value
        # materialized_path_for_children computes), never from the
        # compare=False relative_path cache
        mat = self.materialized_path_for_children()
        rel = (f"{self.relative_path}/{base}" if self.relative_path
               else base)
        name, ext = _name_ext(base, is_dir)
        return IsolatedPath(self.location_id, mat, is_dir, name, ext, rel)

    @classmethod
    def from_relative(cls, location_id: int, relative: str) -> "IsolatedPath":
        """Parse "dir/dir2/file.txt" or "dir/sub/" (trailing slash = dir);
        from_relative_str semantics (isolated_file_path_data.rs:120-137)."""
        is_dir = relative.endswith("/")
        if relative in ("", "/"):
            return cls(location_id, "/", True, "", "", "")
        body = relative[:-1] if is_dir else relative
        body = body.lstrip("/")
        if "/" in body:
            parent, base = body.rsplit("/", 1)
            mat = f"/{parent}/"
        else:
            mat, base = "/", body
        name, ext = _name_ext(base, is_dir)
        return cls(location_id, mat, is_dir, name, ext, body)

    @classmethod
    def from_db_row(cls, location_id: int, is_dir: bool, materialized_path: str,
                    name: str, extension: str) -> "IsolatedPath":
        if not is_dir and extension:
            rel = f"{materialized_path[1:]}{name}.{extension}"
        else:
            rel = f"{materialized_path[1:]}{name}"
        return cls(location_id, materialized_path, is_dir, name, extension, rel)

    # -- algebra -----------------------------------------------------------

    @property
    def is_root(self) -> bool:
        return self.is_dir and self.materialized_path == "/" and not self.name

    def parent(self) -> "IsolatedPath":
        if self.materialized_path == "/":
            return IsolatedPath(self.location_id, "/", True, "", "", "")
        trimmed = self.materialized_path[:-1]  # drop trailing slash
        last_slash = trimmed.rfind("/")
        parent_mat = self.materialized_path[:last_slash + 1]
        parent_name = trimmed[last_slash + 1:]
        rel = self.materialized_path[1:-1]
        return IsolatedPath(self.location_id, parent_mat, True, parent_name, "", rel)

    def full_name(self) -> str:
        if self.extension:
            return f"{self.name}.{self.extension}"
        return self.name

    def materialized_path_for_children(self) -> Optional[str]:
        """What children of this dir store as their materialized_path."""
        if self.is_root:
            return "/"
        if not self.is_dir:
            return None
        return f"{self.materialized_path}{self.name}/"

    def join_on(self, location_path: str | os.PathLike) -> str:
        """Absolute filesystem path of this entry under location_path."""
        return os.path.join(
            os.fspath(location_path),
            self.relative_path.replace("/", os.sep),
        )

    def db_key(self) -> Tuple[int, str, str, str]:
        """(location_id, materialized_path, name, extension) — the DB
        unique key (schema.prisma:197 semantics)."""
        return (self.location_id, self.materialized_path, self.name, self.extension)

    def __str__(self) -> str:
        return self.relative_path
