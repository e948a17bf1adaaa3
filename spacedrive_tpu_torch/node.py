"""Node bootstrap: construct the services in order, own the event bus.

Port of ``spacedrive_tpu/node.py`` (upstream core/src/lib.rs:58-144):
``EventBus`` (a synchronous callback fan-out of CoreEvents,
``invalidate_query``), ``NodeConfig`` (the same ``node_state.sdconfig``
file and migration, so one data dir serves either package; feature flags),
``OrphanRemover``, and ``Node`` with its libraries, job manager,
thumbnailer, locations actor (``locations/watcher.Locations``), ``start``
(libraries loaded, the ``init.json`` seed applied, interrupted jobs
cold-resumed), ``start_p2p``, ``shutdown`` (which reaps the node's task
subtree) and ``create_library``: what the API's procedures read from a
node.

The node hashes on the card: ``device="cuda"`` is the default and raises
at once where CUDA is absent; ``device="cpu"`` (the tests) runs the plain
backends. ``node.backend`` is the scan backend that goes with it and
``jobs.services["device"]`` the device.

The observability plane rides the node as in the JAX package: the
sanitizer (``sanitize.install(mode="count")``: a no-op unless
``SDTPU_SANITIZE`` is set), JSON logging (``SDTPU_LOG_JSON``) and the log
ring, the ``TelemetryReporter`` (periodic ``TelemetrySnapshot`` events),
the health observatory (``self.health``, sampled under
``<node>/health``) and the process-global incident observatory
(``self.incidents``, bundles under ``<data_dir>/incidents/``). The fleet
observatory waits for the plane's second half.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid as uuidlib
from typing import Callable, Dict, List, Optional

from . import flags, persist, tasks, telemetry, tracing
from .health import HealthMonitor
from .jobs.manager import JobManager
from .library import Libraries, Library
from .locations.watcher import Locations
from .ops.blake3_torch import resolve_device

NODE_CONFIG_VERSION = 1
NODE_CONFIG_NAME = "node_state.sdconfig"


class EventBus:
    """CoreEvent fan-out (JobProgress, JobUpdate, InvalidateOperation,
    Spacedrop*, P2PError) to synchronous callbacks, each a cheap filter."""

    def __init__(self):
        self._subs: List[Callable[[dict], None]] = []

    def subscribe(self, cb: Callable[[dict], None]) -> Callable[[], None]:
        self._subs.append(cb)
        return lambda: self._subs.remove(cb)

    def emit(self, event: dict) -> None:
        for cb in list(self._subs):
            try:
                cb(event)
            except Exception:
                pass

    def invalidate_query(self, library_id, key: str) -> None:
        """invalidate_query! semantics (api/utils/invalidate.rs:131)."""
        self.emit({"type": "InvalidateOperation", "library_id": str(library_id),
                   "key": key})


def migrate_node_config(raw: dict) -> dict:
    """Upgrade a config step by step to NODE_CONFIG_VERSION
    (util/migrator.rs:33-41)."""
    version = raw.get("version", 0)
    if version > NODE_CONFIG_VERSION:
        raise ValueError(f"config version {version} is newer than supported "
                         f"{NODE_CONFIG_VERSION} (time traveling backwards?)")
    while version < NODE_CONFIG_VERSION:
        if version == 0:
            raw.setdefault("id", uuidlib.uuid4().hex)
            raw.setdefault("name", "spacedrive-tpu-node")
            raw.setdefault("features", [])
        version += 1
        raw["version"] = version
    return raw


class NodeConfig:
    """node_state.sdconfig (node/config.rs:22-43)."""

    def __init__(self, path: str):
        self.path = path
        raw = {}
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
        self.raw = migrate_node_config(raw)
        self.save()

    @property
    def id(self) -> bytes:
        return bytes.fromhex(self.raw["id"])

    @property
    def name(self) -> str:
        return self.raw["name"]

    @property
    def features(self) -> List[str]:
        return list(self.raw.get("features", []))

    def toggle_feature(self, feature: str) -> bool:
        """BackendFeature toggle (api/mod.rs:28-48); returns the new state."""
        feats = set(self.raw.get("features", []))
        enabled = feature not in feats
        (feats.add if enabled else feats.remove)(feature)
        self.raw["features"] = sorted(feats)
        self.save()
        return enabled

    def save(self) -> None:
        persist.atomic_write("node.config", self.path, json.dumps(self.raw, indent=2))


class OrphanRemover:
    """Deletes objects no file_path references, on a 1-minute tick or on
    demand (core/src/object/orphan_remover.rs:17-40)."""

    TICK_S = 60

    def __init__(self, library: Library, owner: str = "orphan-remover"):
        self.library = library
        self._owner = owner
        self._task: Optional[asyncio.Task] = None

    def invoke(self) -> int:
        from .sync.manager import cascade_local_fks

        db = self.library.db
        rows = db.run("node.orphan_objects")
        if not rows:
            return 0
        sync = self.library.sync
        ops = [sync.shared_delete("object", r["pub_id"]) for r in rows]
        with sync.write_ops(ops) as conn:
            for r in rows:
                # membership rows have no ON DELETE: clear them first
                cascade_local_fks(conn, "object", r["id"])
                db.run("node.object_delete", (r["id"],), conn=conn)
        return len(rows)

    def start(self) -> None:
        async def loop():
            while True:
                await asyncio.sleep(self.TICK_S)
                await asyncio.to_thread(self.invoke)
        self._task = tasks.spawn(f"orphan/{self.library.id.hex[:8]}", loop(),
                                 owner=self._owner)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


class TelemetryReporter:
    """Periodic TelemetrySnapshot events on the node event bus: the push
    view of the metrics registry, the same snapshot ``node.metrics``
    serves on demand. Interval from SDTPU_TELEMETRY_INTERVAL seconds
    (floor 0.05); the loop emits nothing while telemetry is disabled."""

    def __init__(self, events: EventBus, interval_s: Optional[float] = None,
                 owner: str = "telemetry-reporter"):
        self.events = events
        if interval_s is None:
            interval_s = flags.get("SDTPU_TELEMETRY_INTERVAL")
        self.interval_s = max(0.05, interval_s)
        self._owner = owner
        self._task: Optional[asyncio.Task] = None

    def emit_snapshot(self) -> None:
        self.events.emit({"type": "TelemetrySnapshot", "ts": time.time(),
                          "metrics": telemetry.snapshot()})

    def start(self) -> None:
        async def loop():
            while True:
                await asyncio.sleep(self.interval_s)
                if telemetry.enabled():
                    self.emit_snapshot()
        if self._task is None:
            self._task = tasks.spawn("telemetry-reporter", loop(), owner=self._owner)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


class Node:
    def __init__(self, data_dir: str, device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if device == "cuda":
            resolve_device("cuda")  # raises here where CUDA is absent
        # SDTPU_SANITIZE=1 arms the sanitizer in count mode: violations
        # count into sd_sanitize_* instead of raising (a no-op when unset).
        from . import sanitize

        sanitize.install(mode="count")
        # SDTPU_LOG_JSON: trace-correlated structured logging; the log
        # ring (SDTPU_LOG_RING, on by default) keeps a trace-stamped tail
        # for incident bundles. One handler each a process.
        tracing.install_json_logging()
        tracing.install_log_ring()
        self.data_dir = os.path.abspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.device = device
        self.backend = "cuda" if device == "cuda" else "plain"
        self.config = NodeConfig(os.path.join(self.data_dir, NODE_CONFIG_NAME))
        # the root of this node's task tree; shutdown reaps it
        self.task_owner = tasks.unique_owner("node")
        self.events = EventBus()
        self.libraries = Libraries(self.data_dir)
        from .media.actor import Thumbnailer

        self.thumbnailer = Thumbnailer(self)
        self.jobs = JobManager(
            on_event=self.events.emit,
            services={"data_dir": self.data_dir, "node": self,
                      "thumbnailer": self.thumbnailer, "device": device})
        self.orphan_removers: Dict[uuidlib.UUID, OrphanRemover] = {}
        self.locations = Locations(self)
        self.p2p = None  # created by start_p2p
        self.telemetry_reporter = TelemetryReporter(
            self.events, owner=f"{self.task_owner}/reporter")
        # Health observatory: delta-samples every metric family into
        # bounded rings and attributes saturation; serves node.health and
        # the sd_health_state{subsystem} gauges.
        self.health = HealthMonitor(
            self.events, owner=f"{self.task_owner}/health",
            node_id=self.config.id.hex(), node_name=self.config.name)
        # Incident observatory: process-global and idempotent (the first
        # node wins, as the sanitizer); a prior crash's partial bundle is
        # recovered here, before any trigger can fire. None when
        # SDTPU_INCIDENTS is off.
        from . import incidents

        self.incidents = incidents.install(
            dir_path=os.path.join(self.data_dir, "incidents"),
            monitor=self.health, events=self.events,
            node_id=self.config.id.hex(), node_name=self.config.name)
        self.libraries.on_event(self._on_library_event)

    # -- lifecycle (ordering-sensitive: lib.rs:134-138) --------------------

    async def start(self) -> None:
        """Load the libraries, apply the data dir's ``init.json`` seed,
        cold-resume the interrupted jobs, start the actors."""
        self.thumbnailer.start()
        try:
            self.telemetry_reporter.start()
            self.health.start()
        except RuntimeError:
            pass  # no running loop; node.metrics and on-demand health work
        self.libraries.init()
        # Before cold_resume, so reset_on_startup never deletes a library
        # whose jobs were just re-dispatched; a bad seed file is reported,
        # never a boot loop.
        from .debug_init import apply_init_file

        try:
            await apply_init_file(self)
        except Exception as e:
            self.events.emit({"type": "DebugInitError", "error": str(e)})
        for lib in self.libraries.list():
            await self.jobs.cold_resume(lib)
            self._ensure_actors(lib)

    def _on_library_event(self, kind: str, library: Library) -> None:
        if kind == "load":
            self._ensure_actors(library)
        elif kind == "delete":
            remover = self.orphan_removers.pop(library.id, None)
            if remover:
                remover.stop()
        self.events.invalidate_query(library.id, "library.list")

    def _ensure_actors(self, library: Library) -> None:
        if library.id not in self.orphan_removers:
            remover = OrphanRemover(library, owner=f"{self.task_owner}/orphan-remover")
            try:
                remover.start()
            except RuntimeError:
                pass  # no running loop; invoke() still works
            self.orphan_removers[library.id] = remover

    async def start_p2p(self, host: str = "0.0.0.0", port: int = 0,
                        enable_discovery: bool = True) -> int:
        """Bring up the listener, discovery and the sync mesh; returns the
        bound port."""
        from .p2p.manager import P2PManager
        from .p2p.sync_net import NetworkedLibraries

        if self.p2p is None:
            self.p2p = P2PManager(self, enable_discovery=enable_discovery)
            NetworkedLibraries(self, self.p2p)
        if self.p2p.server is not None:
            return self.p2p.port
        return await self.p2p.start(host, port)

    async def shutdown(self) -> None:
        """Stop jobs and actors, then reap the node's task subtree before
        the library databases close, so cancelled work can still write."""
        await self.jobs.shutdown()
        self.telemetry_reporter.stop()
        self.health.stop()
        await self.locations.close()
        await self.thumbnailer.stop()
        if self.p2p is not None:
            await self.p2p.stop()
        for remover in self.orphan_removers.values():
            remover.stop()
        try:
            await tasks.reap(self.task_owner)
        finally:
            for lib in self.libraries.list():
                lib.db.close()

    async def close(self) -> None:
        """Alias of ``shutdown``."""
        await self.shutdown()

    def create_library(self, name: str, lib_id=None) -> Library:
        return self.libraries.create(name, node_name=self.config.name,
                                     node_pub_id=self.config.id, lib_id=lib_id)
