"""JSON-safe row serialization for the API surface (port of
``spacedrive_tpu/api/serialization.py``): bytes as hex, the big-endian
size blob as ``size_in_bytes``, an inode blob as its integer."""

from __future__ import annotations

import sqlite3
from typing import Any, Dict, List, Optional


def to_json_value(v: Any) -> Any:
    if isinstance(v, bytes):
        return v.hex()
    return v


def row_to_dict(row) -> Dict[str, Any]:
    d = dict(row) if isinstance(row, sqlite3.Row) else dict(row)
    out = {}
    for k, v in d.items():
        if k == "size_in_bytes_bytes":
            out["size_in_bytes"] = int.from_bytes(v or b"", "big")
        elif k == "inode" and isinstance(v, bytes):
            out[k] = int.from_bytes(v[:8], "big")
        else:
            out[k] = to_json_value(v)
    return out


def rows_to_dicts(rows) -> List[Dict[str, Any]]:
    return [row_to_dict(r) for r in rows]


def file_path_display(row: Dict[str, Any]) -> str:
    ext = row.get("extension") or ""
    return f"{row.get('materialized_path', '/')}{row.get('name', '')}" + \
        (f".{ext}" if ext else "")
