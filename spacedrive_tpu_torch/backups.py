"""Library backup and restore.

Port of ``spacedrive_tpu/backups.py`` (upstream core/src/api/backups.rs:
127-350): a backup is a zip under ``<data_dir>/backups/<backup_id>.bak``
holding ``manifest.json`` (backup id, timestamp, library id and name),
``library.db`` (the database after a WAL checkpoint) and
``library.sdlibrary`` (the config): the same entries as the JAX package's,
so a backup made by either package restores in the other. The restore
writes through ``persist`` (the db before the config) and reloads the
library.
"""

from __future__ import annotations

import json
import os
import time
import uuid as uuidlib
import zipfile
from typing import Dict, List

from . import persist


def backups_dir(data_dir: str) -> str:
    d = os.path.join(data_dir, "backups")
    os.makedirs(d, exist_ok=True)
    return d


def do_backup(node, library) -> str:
    """Create a backup; returns backup_id."""
    backup_id = str(uuidlib.uuid4())
    path = os.path.join(backups_dir(node.data_dir), f"{backup_id}.bak")
    # Checkpoint WAL so the main DB file is complete.
    library.db.checkpoint()
    manifest = {
        "id": backup_id,
        "timestamp": int(time.time()),
        "library_id": str(library.id),
        "library_name": library.config.name,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        z.write(library.db.path, "library.db")
        z.write(library.config_path, "library.sdlibrary")
    return backup_id


def list_backups(node) -> List[Dict]:
    out = []
    d = backups_dir(node.data_dir)
    for name in sorted(os.listdir(d)):
        if not name.endswith(".bak"):
            continue
        p = os.path.join(d, name)
        try:
            with zipfile.ZipFile(p) as z:
                manifest = json.loads(z.read("manifest.json"))
        except (OSError, zipfile.BadZipFile, KeyError, ValueError):
            continue
        manifest["path"] = p
        out.append(manifest)
    return out


def delete_backup(node, backup_id: str) -> bool:
    p = os.path.join(backups_dir(node.data_dir), f"{backup_id}.bak")
    if os.path.exists(p):
        os.remove(p)
        return True
    return False


def restore_backup(node, backup_id: str) -> str:
    """Restore a backup into the libraries dir (overwrites the library's
    DB + config); returns the library id. The library is reloaded."""
    p = os.path.join(backups_dir(node.data_dir), f"{backup_id}.bak")
    with zipfile.ZipFile(p) as z:
        manifest = json.loads(z.read("manifest.json"))
        lib_id = uuidlib.UUID(manifest["library_id"])
        lib = node.libraries.get(lib_id)
        if lib is not None:
            lib.db.close()
            node.libraries.libraries.pop(lib_id, None)
        base = node.libraries.dir
        db_path = os.path.join(base, f"{lib_id}.db")
        for suffix in ("-wal", "-shm"):
            stale = db_path + suffix
            if os.path.exists(stale):
                os.remove(stale)
        # Two durable artifacts land here; restore is idempotent from
        # the zip and ordered db-before-config, so a crash between the
        # two never leaves a config pointing at an absent/old db that
        # a re-run can't fix.
        persist.atomic_write("library.db_image", db_path,
                             z.read("library.db"))
        persist.atomic_write(
            "library.config",
            os.path.join(base, f"{lib_id}.sdlibrary"),
            z.read("library.sdlibrary"))
    node.libraries._load(lib_id)
    return str(lib_id)
