"""Shared file_path query helpers for workload jobs.

The port's own copy of ``spacedrive_tpu/locations/file_path_helper.py``.

The reference keeps per-workload projections and sub-path guards in
core/src/location/file_path_helper/mod.rs (ensure_sub_path_is_in_location,
ensure_sub_path_is_directory, per-job `select!`s); here the shared pieces
are the location-row prologue every job runs and the escaped LIKE filter
for sub-path scoping.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..jobs.job import EarlyFinish
from .paths import IsolatedPath


def load_location(db, location_id: int):
    """Location row, or EarlyFinish when it vanished mid-chain (the
    reference jobs treat a missing location as clean completion)."""
    loc = db.run("location.by_id", (location_id,))
    if loc is None or not loc["path"]:
        raise EarlyFinish(f"location {location_id} gone")
    return loc


def sub_path_children_mat(location_id: int,
                          sub_path: Optional[str]) -> Optional[str]:
    """materialized_path prefix covering everything under sub_path."""
    if not sub_path:
        return None
    iso = IsolatedPath.from_relative(
        location_id, sub_path.strip("/") + "/")
    return iso.materialized_path_for_children()


def materialized_like(where: str, params: List[Any],
                      children_mat: Optional[str]) -> str:
    """Append an escaped `materialized_path LIKE prefix%` filter.

    SQLite LIKE has no default escape character, and `_`/`%` in real
    directory names would otherwise widen or break the match — both are
    escaped and an explicit ESCAPE clause added.
    """
    if children_mat is None:
        return where
    escaped = (children_mat.replace("\\", "\\\\")
               .replace("%", r"\%").replace("_", r"\_"))
    params.append(escaped + "%")
    return where + r" AND materialized_path LIKE ? ESCAPE '\'"


def job_prologue(db, location_id: int, sub_path: Optional[str],
                 base_where: str, base_params: List[Any],
                 ) -> Tuple[Any, str, List[Any]]:
    """The shared job-init prologue: (location row, WHERE, params) with
    sub-path scoping applied."""
    loc = load_location(db, location_id)
    where = materialized_like(
        base_where, base_params,
        sub_path_children_mat(location_id, sub_path))
    return loc, where, base_params
