"""Thumbnailer actor: the long-lived batch-thumbnailing service.

Port of ``spacedrive_tpu/media/actor.py`` (upstream thumbnail/actor.rs): it
outlives jobs, owns the 256-way sharded WebP cache and serves indexed
batches (cas_id + source path, from the media processor) and ephemeral ones
(directories browsed outside any library, ``locations/non_indexed.py``),
``BATCH_CONCURRENCY`` thumbnails at a time in worker threads. Duplicate
requests coalesce into the batch already holding a path; a full queue sheds
its oldest batch (thumbnails are regenerable; its awaiters are released);
``NewThumbnail`` events go to the owner's event sink; ``clean_up`` removes
cache entries no loaded library references; the cache's version file
invalidates the whole cache across format changes.

The JAX actor belongs to a ``Node``, which the port does not have yet: its
owner here is any object with ``data_dir``, ``libraries`` (``list()`` of
libraries with a ``db``) and ``events`` (``emit(event)``). Its bounded queue
is a small one of its own (the JAX ``channels`` registry is not ported):
``QUEUE_CAPACITY`` batches, the oldest shed.
"""

from __future__ import annotations

import asyncio
import os
import shutil
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import tasks
from .thumbnail import (
    THUMBNAIL_CACHE_VERSION,
    VERSION_FILE,
    ensure_thumbnail_dir,
    generate_thumbnail,
    remove_thumbnails_by_cas_ids,
    thumbnail_path,
    thumbnailable_extensions,
)

BATCH_CONCURRENCY = 4        # actor.rs processing fan-out per batch
CLEANUP_TICK_S = 1800.0      # periodic clean-up vs library DBs
QUEUE_CAPACITY = 64          # the JAX package's media.thumbs channel


@dataclass
class ThumbBatch:
    """One unit of queued work: (cas_id, source path) pairs."""

    entries: List[tuple]     # [(cas_id, full_path), ...]
    library_id: Optional[object] = None
    ephemeral: bool = False
    done: asyncio.Event = field(default_factory=asyncio.Event)
    generated: int = 0
    # Completion shares: one for this batch's own processing (if it kept
    # any entries) plus one per delegate batch that absorbed coalesced
    # entries; `done` fires when every share lands.
    _outstanding: int = 0
    _dependents: List["ThumbBatch"] = field(default_factory=list)


class ShedQueue:
    """A bounded FIFO whose put never blocks: past `capacity` the oldest
    item is evicted through `on_evict`."""

    def __init__(self, capacity: int, on_evict: Callable[[object], None]):
        self.capacity = capacity
        self._items: deque = deque()
        self._on_evict = on_evict
        self._ready = asyncio.Event()
        self.shed = 0

    def __len__(self) -> int:
        return len(self._items)

    async def put(self, item) -> None:
        if len(self._items) >= self.capacity:
            self.shed += 1
            self._on_evict(self._items.popleft())
        self._items.append(item)
        self._ready.set()

    async def get(self):
        while not self._items:
            self._ready.clear()
            await self._ready.wait()
        return self._items.popleft()


class Thumbnailer:
    """Actor facade: queue batches, await them, let the loop work."""

    def __init__(self, owner):
        self.owner = owner
        self.data_dir = owner.data_dir
        self.queue = ShedQueue(QUEUE_CAPACITY, self._shed_batch)
        # (cas_id, path) → the pending/processing batch that will generate it.
        self._queued: Dict[Tuple[str, str], ThumbBatch] = {}
        self._owner = f"{getattr(owner, 'task_owner', 'proc')}/media"
        self._task: Optional[asyncio.Task] = None
        self._cleanup_task: Optional[asyncio.Task] = None
        self._migrate_version()

    # -- cache versioning (thumbnail/directory.rs) -------------------------

    def _migrate_version(self) -> None:
        root = os.path.join(self.data_dir, "thumbnails")
        vf = os.path.join(root, VERSION_FILE)
        if os.path.isdir(root):
            try:
                with open(vf) as f:
                    on_disk = int(f.read().strip() or 0)
            except (OSError, ValueError):
                on_disk = 0
            if on_disk != THUMBNAIL_CACHE_VERSION:
                shutil.rmtree(root, ignore_errors=True)
        ensure_thumbnail_dir(self.data_dir)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = tasks.spawn("thumbnailer", self._run(), owner=self._owner)
        if self._cleanup_task is None or self._cleanup_task.done():
            self._cleanup_task = tasks.spawn("thumbnailer-cleanup", self._cleanup_loop(),
                                             owner=self._owner)

    async def stop(self) -> None:
        await tasks.cancel_and_gather(self._task, self._cleanup_task)
        self._task = self._cleanup_task = None

    # -- queueing API (actor.rs new_batch / new_ephemeral_batch) -----------

    async def new_batch(self, entries: List[tuple], library_id=None) -> ThumbBatch:
        return await self._enqueue(ThumbBatch(entries=list(entries), library_id=library_id))

    async def new_ephemeral_batch(self, entries: List[tuple]) -> ThumbBatch:
        return await self._enqueue(ThumbBatch(entries=list(entries), ephemeral=True))

    async def _enqueue(self, batch: ThumbBatch) -> ThumbBatch:
        """Per-path coalescing + bounded put: entries pending in another
        batch are dropped from this one, whose `done` then waits for those
        delegates too."""
        fresh: List[tuple] = []
        delegates: List[ThumbBatch] = []
        for entry in batch.entries:
            owner = self._queued.get(entry)
            if owner is None:
                fresh.append(entry)
            elif all(owner is not d for d in delegates):
                delegates.append(owner)
        batch.entries = fresh
        batch._outstanding = 1 if fresh else 0
        for d in delegates:
            if not d.done.is_set():
                batch._outstanding += 1
                d._dependents.append(batch)
        if not fresh:
            if batch._outstanding == 0:
                batch.done.set()
            return batch
        for key in fresh:
            self._queued[key] = batch
        await self.queue.put(batch)
        return batch

    def _part_done(self, batch: ThumbBatch) -> None:
        """One completion share landed; the last fires `done` and cascades
        to dependents (edges point at older batches only: no cycle)."""
        batch._outstanding -= 1
        if batch._outstanding > 0 or batch.done.is_set():
            return
        batch.done.set()
        deps, batch._dependents = batch._dependents, []
        for dep in deps:
            self._part_done(dep)

    def _shed_batch(self, batch: ThumbBatch) -> None:
        self._forget(batch)
        self._part_done(batch)

    def _forget(self, batch: ThumbBatch) -> None:
        for key in batch.entries:
            if self._queued.get(key) is batch:
                del self._queued[key]

    def remove_cas_ids(self, cas_ids) -> int:
        return remove_thumbnails_by_cas_ids(self.data_dir, cas_ids)

    # -- the actor loop ----------------------------------------------------

    def is_running(self) -> bool:
        return self._task is not None and not self._task.done()

    async def _run(self) -> None:
        while True:
            batch: ThumbBatch = await self.queue.get()
            try:
                await self._process(batch)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # One poisoned batch must not kill the actor: jobs await
                # batch.done with no timeout.
                self.owner.events.emit({"type": "ThumbnailerError", "error": str(e)})
            finally:
                self._forget(batch)
                self._part_done(batch)

    async def _process(self, batch: ThumbBatch) -> None:
        sem = asyncio.Semaphore(BATCH_CONCURRENCY)
        exts = thumbnailable_extensions()

        async def one(cas_id: str, path: str) -> None:
            ext = os.path.splitext(path)[1].lstrip(".").lower()
            if ext not in exts:
                return
            async with sem:
                out = await asyncio.to_thread(generate_thumbnail, path, self.data_dir, cas_id)
            if out:
                batch.generated += 1
                self.owner.events.emit({"type": "NewThumbnail", "cas_id": cas_id,
                                        "ephemeral": batch.ephemeral})

        await asyncio.gather(*(one(cas_id, path) for cas_id, path in batch.entries))

    # -- clean-up (actor.rs periodic pass vs all library DBs) --------------

    async def _cleanup_loop(self) -> None:
        while True:
            await asyncio.sleep(CLEANUP_TICK_S)
            try:
                await asyncio.to_thread(self.clean_up)
            except Exception:
                pass  # best-effort janitor; never kill the actor

    def clean_up(self) -> int:
        """Remove cached thumbnails whose cas_id no loaded library
        references. Returns the number removed."""
        known = set()
        for lib in self.owner.libraries.list():
            for row in lib.db.run("media.known_cas"):
                known.add(row["cas_id"])
        removed = 0
        root = os.path.join(self.data_dir, "thumbnails")
        if not os.path.isdir(root):
            return 0
        for shard in os.listdir(root):
            shard_dir = os.path.join(root, shard)
            if not os.path.isdir(shard_dir) or len(shard) != 2:
                continue
            for name in os.listdir(shard_dir):
                if not name.endswith(".webp"):
                    continue
                if name[:-5] not in known:
                    try:
                        os.remove(os.path.join(shard_dir, name))
                        removed += 1
                    except OSError:
                        pass
            try:
                os.rmdir(shard_dir)  # only succeeds when empty
            except OSError:
                pass
        return removed

    def exists(self, cas_id: str) -> bool:
        return os.path.exists(thumbnail_path(self.data_dir, cas_id))
