"""Supervised background tasks: the part of ``spacedrive_tpu/tasks.py``
that the watcher, the Locations actor, sync and p2p need.

``spawn`` is the one way they start background work: the registry holds a
strong reference to every task until it finishes (an event loop keeps
only weak ones, so a task nobody holds can be collected mid-flight), each
task carries an owner name, and ``reap(owner)`` cancels and awaits what an
owner still runs. ``cancel_and_gather`` is the stop idiom: it swallows
only the victims' cancellation, while the caller's own cancellation still
propagates. ``owners`` and ``owner_label`` give the health observatory's
sampler its census of live tasks by owner root, and ``spawn`` counts into
``sd_task_spawned_total{owner}``. The JAX package's other telemetry, its
sanitizer hooks and reap grace period are left to it.
"""

from __future__ import annotations

import asyncio
import itertools
import re
import threading
from typing import Coroutine, Dict, List, Optional

from .telemetry import TASK_SPAWNED

__all__ = ["spawn", "live", "owners", "reap", "cancel_and_gather", "unique_owner",
           "owner_label", "TASK_NAME_PREFIX"]

TASK_NAME_PREFIX = "sdtpu:"
_OWNER_SEQ_RE = re.compile(r"#\d+")

_registry: Dict[asyncio.Task, str] = {}  # task → owner
_registry_lock = threading.Lock()
_owner_seq = itertools.count(1)


def unique_owner(prefix: str) -> str:
    """A process-unique owner root (``node#3``): two nodes in one process
    never reap each other's tasks."""
    return f"{prefix}#{next(_owner_seq)}"


def owner_label(owner: str) -> str:
    """Telemetry label of an owner path: the per-instance ``#seq`` is
    stripped, so label cardinality stays bounded by the component tree."""
    return _OWNER_SEQ_RE.sub("", owner)


def _in_subtree(owner: str, root: str) -> bool:
    return owner == root or owner.startswith(root + "/")


def _on_task_done(task: asyncio.Task) -> None:
    with _registry_lock:
        _registry.pop(task, None)
    if not task.cancelled():
        task.exception()  # retrieved: no "never retrieved" log at exit


def spawn(name: str, coro: Coroutine, owner: str = "proc") -> asyncio.Task:
    """A supervised task on the running loop, named ``sdtpu:<owner>/<name>``.
    Without a running loop the coroutine is closed and RuntimeError
    raised."""
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        coro.close()
        raise
    task = loop.create_task(coro, name=f"{TASK_NAME_PREFIX}{owner}/{name}")
    with _registry_lock:
        _registry[task] = owner
    task.add_done_callback(_on_task_done)
    TASK_SPAWNED.labels(owner=owner_label(owner)).inc()
    return task


def live(owner: Optional[str] = None) -> List[asyncio.Task]:
    """Registered tasks that have not finished, optionally of one owner
    and the owners under it (``owner/...``)."""
    with _registry_lock:
        items = list(_registry.items())
    return [t for t, o in items if owner is None or _in_subtree(o, owner)]


def owners() -> List[str]:
    """The owner of each registered task that has not finished."""
    with _registry_lock:
        return list(_registry.values())


async def cancel_and_gather(*tasks: Optional[asyncio.Task]) -> None:
    """Cancel `tasks` and wait for them to end."""
    victims = [t for t in tasks if t is not None]
    for t in victims:
        t.cancel()
    if victims:
        await asyncio.gather(*victims, return_exceptions=True)


async def reap(owner: str) -> int:
    """Cancel and await every task of `owner` (and the owners under it),
    sweeping again for tasks spawned meanwhile. Returns how many."""
    n = 0
    for _ in range(3):
        victims = [t for t in live(owner) if not t.done()]
        if not victims:
            break
        n += len(victims)
        await cancel_and_gather(*victims)
    return n
