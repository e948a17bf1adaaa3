"""The port's SQLite store: schema registry, named statements, Database."""

from .db import Database, uuid_bytes
from .models import MODELS, Model, SyncMode

__all__ = ["Database", "MODELS", "Model", "SyncMode", "uuid_bytes"]
