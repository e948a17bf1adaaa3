"""Filesystem watcher: inotify-backed location monitoring.

Port of ``spacedrive_tpu/locations/watcher.py`` (the reference's
core/src/location/manager/{mod,watcher/mod,watcher/linux}.rs): a recursive
watcher per location whose events (create, modify, rename, delete) are
debounced and dispatched as ``light_scan_location`` calls on the affected
directories. inotify is driven through ctypes (Linux); the polling
watcher is the fallback where inotify is absent, or when
``SDTPU_WATCHER=poll`` forces it.

``Locations`` takes the ``Node`` that owns it (its event bus, task tree and
scan backend), as the JAX actor does; without a node it takes an
``on_event`` callback, an owner name for its background tasks and the
``backend`` of its rescans, ``"cuda"`` by default (K1 on the card).
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import os
import struct
from typing import Callable, Dict, Optional, Set

from .. import flags, tasks
from ..ops.blake3_torch import resolve_device

# inotify event masks (linux/inotify.h)
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_MODIFY = 0x00000002
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_DELETE_SELF = 0x00000400
IN_MOVE_SELF = 0x00000800
IN_ISDIR = 0x40000000
IN_Q_OVERFLOW = 0x00004000
IN_IGNORED = 0x00008000
IN_NONBLOCK = 0x00000800
IN_CLOEXEC = 0x00080000

WATCH_MASK = (IN_CREATE | IN_DELETE | IN_CLOSE_WRITE | IN_MOVED_FROM |
              IN_MOVED_TO | IN_DELETE_SELF | IN_MOVE_SELF)

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len

DEBOUNCE_S = 0.1  # the reference debounces around 100 ms


class _Inotify:
    """Thin ctypes wrapper over the three inotify syscalls."""

    def __init__(self):
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self.fd = self._libc.inotify_init1(IN_NONBLOCK | IN_CLOEXEC)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")

    def add_watch(self, path: str, mask: int = WATCH_MASK) -> int:
        wd = self._libc.inotify_add_watch(self.fd, os.fsencode(path), mask)
        if wd < 0:
            raise OSError(ctypes.get_errno(), f"inotify_add_watch {path}")
        return wd

    def rm_watch(self, wd: int) -> None:
        self._libc.inotify_rm_watch(self.fd, wd)

    def read_events(self):
        """Drain pending events → [(wd, mask, cookie, name)]."""
        try:
            buf = os.read(self.fd, 65536)
        except BlockingIOError:
            return []
        events = []
        offset = 0
        while offset + _EVENT_HDR.size <= len(buf):
            wd, mask, cookie, length = _EVENT_HDR.unpack_from(buf, offset)
            offset += _EVENT_HDR.size
            name = buf[offset:offset + length].split(b"\x00", 1)[0].decode(
                "utf-8", "surrogateescape")
            offset += length
            events.append((wd, mask, cookie, name))
        return events

    def close(self) -> None:
        os.close(self.fd)


class PollingWatcher:
    """Polling fallback with the LocationWatcher contract: every
    ``INTERVAL_S`` it walks the tree and compares a per-directory signature
    (entry names, kinds, sizes, mtimes); a changed directory that still
    exists is reported to ``on_dirty(relpath)``. A vanished directory is
    covered by its parent's changed signature, except the root, which
    rescans as "" to surface the missing path.

    The baseline is taken synchronously up to ``SYNC_SEED_DIRS``
    directories (nothing created after ``watch()`` can hide in it), else on
    the first tick in a thread: a big location is scanned by a full scan
    chain beside its watcher anyway."""

    INTERVAL_S = 1.0
    SYNC_SEED_DIRS = 2000

    def __init__(self, location_id: int, root: str, on_dirty: Callable[[str], None],
                 owner: str = "locations"):
        self.location_id = location_id
        self.root = os.path.normpath(root)
        self.on_dirty = on_dirty
        self._sigs: Optional[Dict[str, tuple]] = self._snapshot(limit=self.SYNC_SEED_DIRS)
        self._task: Optional[asyncio.Task] = tasks.spawn(
            f"watcher-poll/{location_id}", self._poll_loop(), owner=owner)

    def _dir_sig(self, path: str) -> Optional[tuple]:
        try:
            with os.scandir(path) as it:
                ents = []
                for e in it:
                    try:
                        st = e.stat(follow_symlinks=False)
                        ents.append((e.name, e.is_dir(follow_symlinks=False),
                                     st.st_size, st.st_mtime_ns))
                    except OSError:
                        continue
            return tuple(sorted(ents))
        except OSError:
            return None

    def _snapshot(self, limit: Optional[int] = None) -> Optional[Dict[str, tuple]]:
        """Signature map of the whole tree; with `limit`, None past that
        many directories."""
        sigs: Dict[str, tuple] = {}
        stack = [self.root]
        while stack:
            d = stack.pop()
            sig = self._dir_sig(d)
            if sig is None:
                continue
            sigs[d] = sig
            if limit is not None and len(sigs) > limit:
                return None
            stack.extend(os.path.join(d, name) for name, is_dir, _, _ in sig if is_dir)
        return sigs

    async def _poll_loop(self) -> None:
        if self._sigs is None:  # a big tree: seed off the event loop
            self._sigs = await asyncio.to_thread(self._snapshot)
        while True:
            await asyncio.sleep(self.INTERVAL_S)
            try:
                new = await asyncio.to_thread(self._snapshot)
                old = self._sigs
                self._sigs = new
                dirty = {d for d in set(old) | set(new)
                         if old.get(d) != new.get(d) and d in new}
                if self.root in old and self.root not in new:
                    dirty.add(self.root)
                for d in sorted(dirty):
                    rel = os.path.relpath(d, self.root)
                    self.on_dirty("" if rel == "." else rel.replace(os.sep, "/"))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 (a throwing on_dirty must not stop the watcher)
                continue

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


def inotify_available() -> bool:
    try:
        _Inotify().close()
        return True
    except (OSError, AttributeError):
        return False


def make_watcher(location_id: int, root: str, on_dirty: Callable[[str], None],
                 owner: str = "locations"):
    """The inotify watcher where the platform has it, the polling one
    otherwise or under ``SDTPU_WATCHER=poll``. Call it on the event loop
    the watcher lives on."""
    if flags.get("SDTPU_WATCHER") != "poll" and inotify_available():
        return LocationWatcher(location_id, root, on_dirty)
    return PollingWatcher(location_id, root, on_dirty, owner=owner)


class LocationWatcher:
    """Recursive inotify watcher of one location, one watch per directory
    (a new directory gets its own as it appears). After ``DEBOUNCE_S`` it
    calls ``on_dirty(sub_path)`` on the event loop for each directory with
    changes (location-relative, '' for the root)."""

    def __init__(self, location_id: int, root: str, on_dirty: Callable[[str], None]):
        self.location_id = location_id
        self.root = os.path.normpath(root)
        self.on_dirty = on_dirty
        self.loop = asyncio.get_running_loop()
        self._ino = _Inotify()
        self._wd_to_path: Dict[int, str] = {}
        self._path_to_wd: Dict[str, int] = {}
        self._dirty: Set[str] = set()
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._watch_tree(self.root)
        self.loop.add_reader(self._ino.fd, self._on_readable)

    # -- watches -------------------------------------------------------------

    def _watch_tree(self, path: str) -> None:
        try:
            wd = self._ino.add_watch(path)
        except OSError:
            return
        self._wd_to_path[wd] = path
        self._path_to_wd[path] = wd
        try:
            with os.scandir(path) as it:
                for e in it:
                    if e.is_dir(follow_symlinks=False):
                        self._watch_tree(e.path)
        except OSError:
            pass

    def _unwatch(self, path: str) -> None:
        for p in [p for p in self._path_to_wd if p == path or p.startswith(path + os.sep)]:
            wd = self._path_to_wd.pop(p)
            self._wd_to_path.pop(wd, None)
            self._ino.rm_watch(wd)

    # -- events --------------------------------------------------------------

    def _on_readable(self) -> None:
        for wd, mask, cookie, name in self._ino.read_events():
            if mask & IN_Q_OVERFLOW:
                # The kernel lost events: any watched directory may be
                # stale, and the rescan is shallow, so dirty them all.
                for p in list(self._path_to_wd):
                    self._mark_dirty(p)
                continue
            if mask & IN_IGNORED:
                # The kernel dropped this watch (directory gone): forget it,
                # or a reused wd could later be removed under a live watch.
                stale = self._wd_to_path.pop(wd, None)
                if stale is not None:
                    self._path_to_wd.pop(stale, None)
                continue
            parent = self._wd_to_path.get(wd)
            if parent is None:
                continue
            full = os.path.join(parent, name) if name else parent
            if mask & IN_ISDIR:
                if mask & (IN_CREATE | IN_MOVED_TO):
                    self._watch_tree(full)
                    self._mark_dirty(full)
                elif mask & (IN_DELETE | IN_MOVED_FROM):
                    self._unwatch(full)
            if mask & (IN_DELETE_SELF | IN_MOVE_SELF):
                # The directory itself is gone: its parent's listing
                # changed (a deleted root rescans as the root).
                if parent == self.root:
                    self._mark_dirty(self.root)
                else:
                    self._mark_dirty(os.path.dirname(parent))
                continue
            self._mark_dirty(parent)

    def _mark_dirty(self, dir_path: str) -> None:
        self._dirty.add(dir_path)
        if self._flush_handle is None:
            self._flush_handle = self.loop.call_later(DEBOUNCE_S, self._flush)

    def _flush(self) -> None:
        self._flush_handle = None
        dirty, self._dirty = self._dirty, set()
        for d in dirty:
            rel = os.path.relpath(d, self.root)
            self.on_dirty("" if rel == "." else rel.replace(os.sep, "/"))

    def close(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
        self.loop.remove_reader(self._ino.fd)
        self._ino.close()


class Locations:
    """The locations actor: the watched locations and their watchers
    (manager/mod.rs:44-681). A watcher's dirty directories become
    ``light_scan_location`` calls on a worker thread, one location at a
    time; events that arrive during a rescan are coalesced and drained
    after it, never dropped. ``on_event`` receives ``WatcherError`` and
    ``InvalidateOperation`` events."""

    def __init__(self, node=None, on_event: Optional[Callable[[dict], None]] = None,
                 owner: Optional[str] = None, backend: Optional[str] = None):
        if node is not None:
            on_event = on_event or node.events.emit
            owner = owner or f"{node.task_owner}/locations"
            backend = backend or node.backend
        backend = backend or "cuda"
        if backend == "cuda":
            resolve_device("cuda")  # raises here where CUDA is absent
        self.node = node
        self.on_event = on_event or (lambda e: None)
        self.backend = backend
        self.watchers: Dict[tuple, object] = {}
        self._scanning: Set[tuple] = set()
        self._pending: Dict[tuple, Set[str]] = {}
        self._owner = owner or "locations"

    def watch_location(self, library, location_id: int) -> bool:
        loc = library.db.run("location.by_id", (location_id,))
        if loc is None or not loc["path"] or not os.path.isdir(loc["path"]):
            return False
        key = (library.id, location_id)
        if key in self.watchers:
            return True

        def on_dirty(sub_path: str, _key=key, _lib=library, _loc=location_id):
            pending = self._pending.setdefault(_key, set())
            pending.add(sub_path)
            if _key in self._scanning:
                return  # the running scan drains it
            self._scanning.add(_key)

            async def scan():
                from .shallow import light_scan_location
                try:
                    while self._pending.get(_key):
                        batch = self._pending.pop(_key)
                        self._pending[_key] = set()
                        for sub in sorted(batch):
                            try:
                                await asyncio.to_thread(light_scan_location, _lib, _loc,
                                                        sub or None, self.backend)
                            except Exception as e:  # noqa: BLE001 (reported, the watcher goes on)
                                self.on_event({"type": "WatcherError",
                                               "location_id": _loc, "error": str(e)})
                    self.on_event({"type": "InvalidateOperation",
                                   "library_id": str(_lib.id), "key": "search.paths"})
                finally:
                    self._pending.pop(_key, None)
                    self._scanning.discard(_key)

            tasks.spawn(f"watcher-scan/{_loc}", scan(), owner=self._owner)

        self.watchers[key] = make_watcher(location_id, loc["path"], on_dirty,
                                          owner=self._owner)
        return True

    def unwatch_location(self, library, location_id: int) -> None:
        w = self.watchers.pop((library.id, location_id), None)
        if w is not None:
            w.close()

    def idle(self) -> bool:
        """No rescan runs or waits."""
        return not self._scanning and not any(self._pending.values())

    async def close(self) -> None:
        """Close every watcher, then cancel and await the rescans still
        running or waiting."""
        for w in self.watchers.values():
            w.close()
        self.watchers.clear()
        await tasks.reap(self._owner)
