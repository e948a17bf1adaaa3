"""Library manager: one SQLite DB + sync manager + config per library.

Port of ``spacedrive_tpu/library.py`` (upstream
core/src/library/manager/mod.rs:138-318): libraries live under
``<data_dir>/libraries/`` as ``<uuid>.sdlibrary`` JSON configs next to
``<uuid>.db`` SQLite files; creating one writes this node's instance row
and seeds the system indexer rules, loading one opens its Database and
SyncManager, deleting one removes its files, and ``on_event`` hooks see
each load, edit and delete. The same files open in the JAX package. Keep ``data_dir`` on a local file system: the WAL's ``-shm``
file is a shared memory map.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid as uuidlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .locations.rules import seed_system_rules
from .store.db import Database, uuid_bytes
from .sync.manager import SyncManager

LIBRARY_CONFIG_VERSION = 1


@dataclass
class LibraryConfig:
    """library/config.rs:28 semantics, JSON-persisted."""

    name: str
    instance_id: str  # this node's instance pub_id (hex)
    description: str = ""
    version: int = LIBRARY_CONFIG_VERSION

    def to_json(self) -> dict:
        return {"version": self.version, "name": self.name,
                "description": self.description, "instance_id": self.instance_id}

    @classmethod
    def from_json(cls, raw: dict) -> "LibraryConfig":
        return cls(name=raw["name"], instance_id=raw["instance_id"],
                   description=raw.get("description", ""),
                   version=raw.get("version", LIBRARY_CONFIG_VERSION))


class Library:
    """The per-library service bundle jobs see as ctx.library."""

    def __init__(self, lib_id: uuidlib.UUID, config: LibraryConfig,
                 db: Database, sync: SyncManager, config_path: str):
        self.id = lib_id
        self.config = config
        self.db = db
        self.sync = sync
        self.config_path = config_path

    @property
    def instance_pub_id(self) -> bytes:
        return bytes.fromhex(self.config.instance_id)

    def save_config(self) -> None:
        """Write the JSON config atomically (temp file + rename)."""
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.config_path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.config.to_json(), f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.config_path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def statistics(self) -> dict:
        """library.statistics procedure data (api/libraries.rs:47)."""
        db = self.db
        objs = db.run("store.object_count")["n"]
        paths = db.run("library.stats.path_count")["n"]
        total = sum(int.from_bytes(r["size_in_bytes_bytes"] or b"", "big")
                    for r in db.run("library.stats.file_sizes"))
        unique = sum(int.from_bytes(r["s"] or b"", "big")
                     for r in db.run("library.stats.unique_sizes"))
        db_size = os.path.getsize(db.path) if os.path.exists(db.path) else 0
        # The latest snapshot only: replaced in place.
        with db.write_tx() as conn:
            db.run("library.stats.clear", conn=conn)
            db.run("library.stats.insert", (objs, str(db_size), str(unique), str(total)),
                   conn=conn)
        return {
            "total_object_count": objs,
            "total_path_count": paths,
            "total_bytes_used": str(total),
            "total_unique_bytes": str(unique),
            "library_db_size": str(db_size),
        }


class Libraries:
    """Loads, creates, edits and deletes libraries (manager/mod.rs:83-318)."""

    def __init__(self, data_dir: str):
        self.dir = os.path.join(data_dir, "libraries")
        os.makedirs(self.dir, exist_ok=True)
        self.libraries: Dict[uuidlib.UUID, Library] = {}
        self._on_event: List[Callable[[str, Library], None]] = []

    def on_event(self, cb: Callable[[str, Library], None]) -> None:
        """Load / edit / delete hooks (LibraryManagerEvent, manager/mod.rs:43)."""
        self._on_event.append(cb)

    def _emit(self, kind: str, library: Library) -> None:
        for cb in list(self._on_event):
            cb(kind, library)

    def init(self) -> None:
        """Load every ``*.sdlibrary`` of the data dir not loaded yet."""
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".sdlibrary"):
                continue
            try:
                lib_id = uuidlib.UUID(name[:-len(".sdlibrary")])
            except ValueError:
                continue  # a stray file never blocks the node's boot
            if lib_id not in self.libraries:
                self._load(lib_id)

    def create(self, name: str, node_name: str = "node", node_pub_id: bytes = b"",
               lib_id: Optional[uuidlib.UUID] = None) -> Library:
        """`lib_id` is given when pairing: a paired library keeps the
        originator's UUID, by which sync streams address it."""
        lib_id = lib_id or uuidlib.uuid4()
        instance_pub = uuid_bytes()
        cfg = LibraryConfig(name=name, instance_id=instance_pub.hex())
        cfg_path = os.path.join(self.dir, f"{lib_id}.sdlibrary")
        db = Database(os.path.join(self.dir, f"{lib_id}.db"))
        db.insert("instance", {
            "pub_id": instance_pub, "identity": b"", "node_id": node_pub_id,
            "node_name": node_name, "node_platform": 0,
            "last_seen": int(time.time()), "date_created": int(time.time()),
        })
        seed_system_rules(db)
        lib = Library(lib_id, cfg, db, SyncManager(db, instance_pub), cfg_path)
        lib.save_config()
        self.libraries[lib_id] = lib
        self._emit("load", lib)
        return lib

    def _load(self, lib_id: uuidlib.UUID) -> Library:
        cfg_path = os.path.join(self.dir, f"{lib_id}.sdlibrary")
        with open(cfg_path) as f:
            cfg = LibraryConfig.from_json(json.load(f))
        db = Database(os.path.join(self.dir, f"{lib_id}.db"))
        lib = Library(lib_id, cfg, db, SyncManager(db, bytes.fromhex(cfg.instance_id)),
                      cfg_path)
        self.libraries[lib_id] = lib
        self._emit("load", lib)
        return lib

    def get(self, lib_id: uuidlib.UUID) -> Optional[Library]:
        return self.libraries.get(lib_id)

    def list(self) -> List[Library]:
        return list(self.libraries.values())

    def delete(self, lib_id: uuidlib.UUID) -> None:
        lib = self.libraries.pop(lib_id, None)
        if lib is None:
            raise KeyError(str(lib_id))
        self._emit("delete", lib)
        lib.db.close()
        for suffix in (".sdlibrary", ".db", ".db-wal", ".db-shm"):
            p = os.path.join(self.dir, f"{lib_id}{suffix}")
            if os.path.exists(p):
                os.remove(p)

    def edit(self, lib_id: uuidlib.UUID, name: Optional[str] = None,
             description: Optional[str] = None) -> Library:
        lib = self.libraries[lib_id]
        if name is not None:
            lib.config.name = name
        if description is not None:
            lib.config.description = description
        lib.save_config()
        self._emit("edit", lib)
        return lib
