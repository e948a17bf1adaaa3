"""Ephemeral (non-indexed) directory browsing.

Port of ``spacedrive_tpu/locations/non_indexed.py`` (``walk`` in the
reference's core/src/location/non_indexed.rs:91): list a directory that
belongs to no location as typed entries (kind, size, dates) without
touching a library, and with ``compute_cas_ids`` the CAS IDs of its
images, the keys of their thumbnails. Those come from one
``staging.cas_ids_for_files`` call for the whole directory: K1 on the card
for ``device="cuda"`` (the default), the plain version for ``"cpu"``.
``queue_ephemeral_thumbnails`` hands those images to a thumbnailer's
ephemeral queue (``media/actor.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List

from ..files import ObjectKind, kind_for_extension
from ..ops import staging
from ..ops.blake3_torch import resolve_device


def walk_ephemeral(path: str, with_hidden_files: bool = False,
                   compute_cas_ids: bool = False, device="cuda") -> List[Dict]:
    """One directory as ephemeral entries, sorted by name; `cas_id` is set
    for non-empty images when `compute_cas_ids`, else None."""
    backend = "cuda" if resolve_device(device).type == "cuda" else "plain"
    entries: List[Dict] = []
    images: List[int] = []  # indexes into entries
    with os.scandir(path) as it:
        for dirent in sorted(it, key=lambda e: e.name):
            if not with_hidden_files and dirent.name.startswith("."):
                continue
            try:
                if dirent.is_symlink():
                    continue
                st = dirent.stat()
                is_dir = dirent.is_dir()
            except OSError:
                continue
            name = dirent.name
            ext = ""
            if not is_dir:
                dot = name.rfind(".")
                if dot > 0:
                    ext = name[dot + 1:]
            kind = ObjectKind.FOLDER if is_dir else kind_for_extension(ext)
            entry = {
                "name": name if is_dir else
                (name[:name.rfind(".")] if "." in name[1:] else name),
                "extension": ext,
                "path": dirent.path,
                "is_dir": is_dir,
                "kind": int(kind),
                "size_in_bytes": st.st_size,
                "date_created": getattr(st, "st_birthtime", st.st_ctime),
                "date_modified": st.st_mtime,
                "hidden": name.startswith("."),
                "cas_id": None,
            }
            if (compute_cas_ids and not is_dir and st.st_size > 0
                    and kind == ObjectKind.IMAGE):
                images.append(len(entries))
            entries.append(entry)
    if images:
        files = [(entries[i]["path"], entries[i]["size_in_bytes"]) for i in images]
        ids, _errors = staging.cas_ids_for_files(files, backend=backend)
        for k, i in enumerate(images):
            entries[i]["cas_id"] = ids.get(k)  # an unreadable file keeps None
    return entries


async def queue_ephemeral_thumbnails(thumbnailer, entries: List[Dict]):
    """The entries' images with a CAS ID as one ephemeral thumbnail batch
    (actor.rs new_ephemeral_batch); returns the batch (await
    ``batch.done``)."""
    return await thumbnailer.new_ephemeral_batch(
        [(e["cas_id"], e["path"]) for e in entries if e["cas_id"]])
