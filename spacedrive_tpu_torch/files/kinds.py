"""Object kind taxonomy.

The port's own copy of ``spacedrive_tpu/files/kinds.py``, unchanged.

Mirrors the reference's 26-variant `ObjectKind` enum
(upstream crates/file-ext/src/kind.rs:6-56). Discriminant values are
stable and stored in the `object.kind` column, so the order here must never
change (the reference carries the same warning for its TS bindings).
"""

from __future__ import annotations

import enum


class ObjectKind(enum.IntEnum):
    UNKNOWN = 0
    DOCUMENT = 1
    FOLDER = 2
    TEXT = 3
    PACKAGE = 4
    IMAGE = 5
    AUDIO = 6
    VIDEO = 7
    ARCHIVE = 8
    EXECUTABLE = 9
    ALIAS = 10
    ENCRYPTED = 11
    KEY = 12
    LINK = 13
    WEB_PAGE_ARCHIVE = 14
    WIDGET = 15
    ALBUM = 16
    COLLECTION = 17
    FONT = 18
    MESH = 19
    CODE = 20
    DATABASE = 21
    BOOK = 22
    CONFIG = 23
    DOTFILE = 24
    SCREENSHOT = 25
