"""light_scan_location: inline shallow index + identify of one directory.

Port of ``spacedrive_tpu/locations/shallow.py``. The reference's shallow
variants (indexer/shallow.rs:26, file_identifier/shallow.rs:26,
location/mod.rs:489) run inline rather than as jobs: they serve watcher
events and Explorer navigation, where the job queue's latency would be
felt. The walker's shallow mode feeds the indexer job's save, update and
remove writes, then the orphans of that one directory are identified in
pages of ``CHUNK_SIZE``: each page is hashed through
``staging.cas_ids_for_files`` on `backend` (K1 on the card for
``"cuda"``, the default; ``"plain"`` and ``"oracle"`` on the CPU) and
written by the identifier's ``identify_chunk`` in one ``write_tx``.
"""

from __future__ import annotations

from typing import Optional

from ..objects.identifier import (BACKENDS, CHUNK_SIZE, TxBatch, identify_chunk,
                                  orphan_filters, stage_file_list)
from ..ops import kernel_registry, staging
from ..telemetry import IDENT_FILES
from ..ops.blake3_torch import resolve_device
from .file_path_helper import load_location
from .indexer_job import (_entry_to_row, make_db_fetchers, remove_file_path_rows,
                          save_file_path_rows, update_file_path_rows)
from .paths import IsolatedPath
from .rules import load_rules_for_location
from .walker import Walker


def light_scan_location(library, location_id: int, sub_path: Optional[str] = None,
                        backend: str = "cuda") -> dict:
    """Shallow rescan of one directory: index its changes, identify its
    orphans. Returns {"saved", "updated", "removed", "linked", "created",
    "errors"}."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {list(BACKENDS)}")
    if backend == "cuda":
        resolve_device("cuda")  # raises here, before any write, without CUDA
    db = library.db
    loc = load_location(db, location_id)
    location_path = loc["path"]
    target = location_path
    sub_iso = None
    if sub_path:
        sub_iso = IsolatedPath.from_relative(location_id, sub_path.strip("/") + "/")
        target = sub_iso.join_on(location_path)

    rules = load_rules_for_location(db, location_id)
    existing, to_remove = make_db_fetchers(db, location_id)
    walker = Walker(location_id, location_path, rules=rules,
                    existing_paths_fetcher=existing, to_remove_fetcher=to_remove)
    res = walker.walk_single_dir(target, add_root=bool(sub_path))
    errors = list(res.errors)

    # Saves first: a renamed file is a new path in `walked` plus its old
    # path in `to_remove`, same inode. The save re-paths the existing row
    # in place (keeping its object link), and the path-conditional removal
    # then leaves the re-pathed row alone.
    rows = [_entry_to_row(e, location_id) for e in res.walked]
    save_file_path_rows(library, loc["pub_id"], rows)
    upd = [_entry_to_row(e, location_id) for e in res.to_update]
    update_file_path_rows(library, upd)
    removed = remove_file_path_rows(library, location_id, list(res.to_remove))

    # Identify the new orphans of this directory only.
    sub_mat = sub_iso.materialized_path_for_children() if sub_iso else "/"
    linked = created = 0
    cursor = 0  # passes unreadable rows, so they cannot loop forever
    while True:
        where, params = orphan_filters(location_id, cursor, None)
        where += " AND materialized_path = ?"
        params.append(sub_mat)
        page = [dict(r) for r in db.query(
            f"SELECT * FROM file_path WHERE {where} ORDER BY id LIMIT ?",
            params + [CHUNK_SIZE])]
        if not page:
            break
        files = stage_file_list(page, location_id, location_path)
        with kernel_registry.device_scope("identify.hash"):
            ids, read_errors = staging.cas_ids_for_files(files, backend=backend)
        # One write_tx per page: the cursor pages over committed rows.
        batch = TxBatch()
        with db.write_tx() as conn:
            lk, cr, errs = identify_chunk(library, page, (files, ids, read_errors),
                                          conn, batch)
        if batch.n_ops:
            library.sync._notify_created()
        # A standalone identify counts here (the job counts in its step).
        for outcome, n in (("linked", lk), ("created", cr), ("skipped", len(errs))):
            if n:
                IDENT_FILES.labels(outcome=outcome).inc(n)
        linked += lk
        created += cr
        errors.extend(errs)
        cursor = page[-1]["id"] + 1
        if len(page) < CHUNK_SIZE:
            break

    return {"saved": len(rows), "updated": len(upd), "removed": removed,
            "linked": linked, "created": created, "errors": errors}
