"""The port's locations: path algebra, indexer rules, the walker, the
indexer job and ``scan_location`` (``locations/manager.py``)."""

from .paths import IsolatedPath, accept_file_name, materialized_path_str

__all__ = ["IsolatedPath", "accept_file_name", "materialized_path_str"]
