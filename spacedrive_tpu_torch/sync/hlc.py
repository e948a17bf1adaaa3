"""Hybrid logical clock over NTP64 timestamps.

The port's own copy of ``spacedrive_tpu/sync/hlc.py``, unchanged.

The reference uses the `uhlc` crate (HLCBuilder in
upstream core/crates/sync/src/manager.rs:43): timestamps are NTP64
u64 values — upper 32 bits whole seconds since the UNIX epoch, lower 32
bits fractional seconds — made strictly monotonic across local events and
merged with remote timestamps on ingest
(upstream core/crates/sync/src/ingest.rs:113-116).
"""

from __future__ import annotations

import threading
import time


def ntp64_now() -> int:
    """Physical time as NTP64 (seconds<<32 | fraction)."""
    t = time.time()
    secs = int(t)
    frac = int((t - secs) * (1 << 32))
    return (secs << 32) | frac


def ntp64_to_seconds(ts: int) -> float:
    return (ts >> 32) + (ts & 0xFFFFFFFF) / (1 << 32)


class HLC:
    """Strictly monotonic hybrid clock, thread-safe."""

    def __init__(self, last: int = 0):
        self._last = last
        self._lock = threading.Lock()

    def new_timestamp(self) -> int:
        with self._lock:
            now = ntp64_now()
            self._last = now if now > self._last else self._last + 1
            return self._last

    def new_timestamps(self, n: int) -> range:
        """n strictly increasing timestamps under ONE lock acquisition —
        the bulk-writer path (an identifier chunk mints 2-3 ops per file,
        so per-op locking is measurable at 1M files)."""
        with self._lock:
            now = ntp64_now()
            start = now if now > self._last else self._last + 1
            self._last = start + n - 1
            return range(start, start + n)

    def update_with_timestamp(self, remote_ts: int) -> None:
        """Merge a remote timestamp so local events happen-after it."""
        with self._lock:
            if remote_ts > self._last:
                self._last = remote_ts

    @property
    def last(self) -> int:
        with self._lock:
            return self._last
