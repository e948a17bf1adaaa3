"""The port's file kinds: extension taxonomy and magic-byte checks."""

from .kinds import ObjectKind
from .ext import (
    EXTENSION_TABLE,
    extension_candidates,
    kind_for_extension,
    resolve_kind,
    verify_magic,
)

__all__ = [
    "ObjectKind",
    "EXTENSION_TABLE",
    "extension_candidates",
    "kind_for_extension",
    "resolve_kind",
    "verify_magic",
]
