"""The port's environment knobs: the JAX package's names and defaults.

The port's own copy of the entries of ``spacedrive_tpu/flags.py`` that its
modules read: the store's group-commit actor (``store/actor.py``,
``store/db.py``), the location watcher (``locations/watcher.py``), the
budgets of sync and p2p (``timeouts.py``), the clone pass-through
(``p2p/sync_net.py``) and the wire auditor (``p2p/wire.py``). It
declares no knob the JAX package lacks. ``get`` parses the live
environment on every call (nothing is cached), so a test or a bench can
flip a knob mid-process as it can in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


def parse_onoff(v: str) -> bool:
    """Kill-switch semantics: anything but off/0/false is on."""
    return v.strip().lower() not in ("off", "0", "false")


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any]
    doc: str
    strict: bool = False  # unparseable raises instead of falling back


FLAGS: Dict[str, Flag] = {}


def declare(name: str, default: Any, parse: Callable[[str], Any], doc: str,
            strict: bool = False) -> None:
    FLAGS[name] = Flag(name, default, parse, doc, strict)


def get(name: str) -> Any:
    """The parsed value from the environment; the default when unset,
    empty or (for a flag that is not strict) unparseable."""
    flag = FLAGS.get(name)
    if flag is None:
        raise KeyError(f"undeclared flag {name!r} (declare it in spacedrive_tpu_torch/flags.py)")
    v = os.environ.get(name)
    if v is None or v == "":
        return flag.default
    try:
        return flag.parse(v)
    except (ValueError, TypeError):
        if flag.strict:
            raise ValueError(f"{name}={v!r}: unparseable")
        return flag.default


declare(
    "SDTPU_STORE_ACTOR", True, parse_onoff,
    "Kill switch of the per-library group-commit write actor (store/actor.py): "
    "`off` makes Database.write_tx() one serialized tx() per batch. Read on "
    "every write_tx entry.")

declare(
    "SDTPU_STORE_GROUP_LATENCY_S", 0.004, float,
    "How long an open group that already coalesced two or more batches waits "
    "for stragglers before it commits. A group of one commits at once.")

declare(
    "SDTPU_STORE_GROUP_MAX", 32, int,
    "At most this many queued write batches coalesce into one transaction.",
    strict=True)

declare(
    "SDTPU_WATCHER", "", lambda v: v.strip().lower(),
    "`poll` forces the polling watcher even where inotify is available "
    "(locations/watcher.py).")

declare(
    "SDTPU_CLONE_PASSTHROUGH", True, parse_onoff,
    "Kill switch for the full-library-clone blob pass-through fast path "
    "(p2p/sync_net.py). `off` forces the per-op pull loop.")

declare(
    "SDTPU_TIMEOUT_SCALE", 1.0, float,
    "Global multiplier over every declared network-await budget "
    "(timeouts.py).")

declare(
    "SDTPU_WIRE_AUDIT", "auto", lambda v: v.strip().lower(),
    "Runtime wire auditor (p2p/wire.py): when armed, every frame crossing "
    "the tunnel in either direction is matched against its declared "
    "message contract. `off` skips arming (pack/unpack still validate).")
