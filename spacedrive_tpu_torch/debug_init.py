"""Declarative dev seed: the data dir's ``init.json``.

Port of ``spacedrive_tpu/debug_init.py`` (upstream
core/src/util/debug_initializer.rs): the file names libraries and
locations to create when the node starts, so a dev node comes up
populated:

    {"libraries": [
        {"name": "dev", "reset_on_startup": false,
         "locations": [{"path": "/data/photos", "scan": true}]}
    ]}

Idempotent: a library (by name) and a location (by path) that exist are
reused. A scan runs on the node's backend (the card for a CUDA node).
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Optional

INIT_FILE = "init.json"


def _load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


async def apply_init_file(node, path: Optional[str] = None) -> int:
    """Apply the init config; returns the number of scans queued."""
    path = path or os.path.join(node.data_dir, INIT_FILE)
    if not os.path.exists(path):
        return 0
    config = await asyncio.to_thread(_load_config, path)
    scans = 0
    errors = []
    for lib_spec in config.get("libraries", []):
        try:
            scans += await _apply_library(node, lib_spec)
        except Exception as e:  # one bad entry must not block boot
            errors.append(f"{lib_spec.get('name', '?')}: {e}")
    for err in errors:
        node.events.emit({"type": "DebugInitError", "error": err})
    return scans


async def _apply_library(node, lib_spec: dict) -> int:
    name = lib_spec["name"]
    lib = next((c for c in node.libraries.list()
                if c.config.name == name), None)
    if lib is not None and lib_spec.get("reset_on_startup"):
        node.libraries.delete(lib.id)
        lib = None
    if lib is None:
        lib = node.create_library(name)
    scans = 0
    for loc_spec in lib_spec.get("locations", []):
        loc_path = os.path.abspath(loc_spec["path"])
        if not os.path.isdir(loc_path):
            continue
        row = await asyncio.to_thread(
            lib.db.query_one,
            "SELECT id FROM location WHERE path = ?", (loc_path,))
        if row is None:
            from .locations.manager import create_location

            loc_id = await asyncio.to_thread(create_location, lib, loc_path)
        else:
            loc_id = row["id"]
        if loc_spec.get("scan", True):
            from .locations.manager import scan_location

            await scan_location(node.jobs, lib, loc_id, backend=node.backend)
            scans += 1
    return scans
