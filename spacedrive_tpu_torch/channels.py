"""Central bounded-channel registry — the resource twin of
timeouts.py's budget table and tasks.py's supervisor.

Every producer/consumer channel in the engine (job run-queue, worker
command inbox, sync ingest inbox/outbox, thumbnailer batch queue, ws
subscription buffers, the tunnel's send_nowait frame window) is
DECLARED here — name, capacity, overflow policy, owner, and a
docstring — and constructed through `channel(name)` / `window(name)` /
`bounded_dict(name)`. Before this module the tree held a dozen
silently unbounded buffers (`asyncio.Queue()` with no maxsize, a bare
jobs deque, per-subscriber ws buffering limited only by RAM): ROADMAP
item 3's admission-control and shed-load work has nowhere to land
while any producer can absorb unbounded memory the moment its consumer
stalls. tools/sdlint's queue-discipline / backpressure /
unbounded-growth passes now fail the build on a bare cross-task queue,
an unbudgeted blocking put, or a grow-only collection in a long-lived
component; this registry is the sanctioned shape they all point at.

Overflow policies (what a full channel does with the next put):

- ``block``    — `await put()` waits for space under the contract's
  declared `put_budget` (a timeouts.py name: the wait is bounded and a
  fired budget counts into `sd_timeout_fired_total`). `put_nowait` on
  a full block channel is a programming error: it records a
  ``chan_overflow`` sanitizer violation and raises ChannelFull.
- ``shed_oldest`` — evict the head to admit the new item (regenerable
  work: thumbnail batches, stale worker commands).
- ``shed_new``  — drop the incoming item (admission control: the jobs
  run-queue refuses, it does not balloon).
- ``coalesce``  — `put(item, key=...)` replaces a pending item with
  the same key in place (telemetry snapshots, ingest notifications);
  on full with no key match it sheds the new item.

Every drop/replacement counts into `sd_chan_shed_total{name}`; depth
and high-water feed `sd_chan_depth`/`sd_chan_high_water{name}`, and
blocked producers observe into `sd_chan_put_block_seconds{name}`.
Effective capacity = declared capacity × `SDTPU_CHAN_SCALE` (flags.py),
read once at channel construction. `sanitize.install()` arms the
registry (`arm()`): a depth that would exceed the declared capacity —
only reachable through the external-buffer `Window` (a send_nowait
burst past the declared window) or a nowait put on a full block
channel — is a ``chan_overflow`` violation, raised in tier-1 and
counted in production.

README's channel table is generated from this registry
(`python -m tools.sdlint --chan-table`).

Design constraints (same as flags.py / timeouts.py): stdlib +
flags/telemetry/timeouts only, importable from every layer without
cycles. Channels are loop-thread-only like asyncio.Queue —
cross-thread producers go through `loop.call_soon_threadsafe`
(exactly how the ws emit path already crosses); the pure-sync surface
(`put_nowait`/`get_nowait`/`len`/`remove`) also works loop-less, which
is how the jobs run-queue serves synchronous construction paths.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from . import flags
from .telemetry import (
    CHAN_DEPTH,
    CHAN_HIGH_WATER,
    CHAN_PUT_BLOCK_SECONDS,
    CHAN_SHED,
)
from .timeouts import TIMEOUTS, with_timeout

__all__ = [
    "ChannelContract", "CHANNELS", "declare_channel", "capacity",
    "channel", "window", "bounded_dict", "Channel", "Window",
    "BoundedDict", "ChannelFull", "arm", "disarm",
    "chan_table_markdown",
]

POLICIES = ("block", "shed_oldest", "shed_new", "coalesce")
KINDS = ("queue", "window", "cache")


class ChannelFull(RuntimeError):
    """put_nowait on a full block-policy channel (producers must use
    the budgeted `await put()` there — the backpressure pass flags the
    call site statically; this is its runtime twin)."""


@dataclass(frozen=True)
class ChannelContract:
    name: str               # dotted id: "<layer>.<what>"
    capacity: int           # items before the overflow policy engages
    policy: str             # block | shed_oldest | shed_new | coalesce
    owner: str              # component that drains it (docs/table)
    doc: str
    put_budget: Optional[str] = None  # timeouts.py name (block queues)
    kind: str = "queue"     # queue | window (external buffer) | cache
    # True for HISTORY rings whose overflow policy is how they age by
    # design (flight-recorder timeline, health sample rings, the
    # latest-wins worker command inbox): the health engine reads their
    # shed rate as normal aging, not as saturation evidence.
    sheds_expected: bool = False


CHANNELS: Dict[str, ChannelContract] = {}

# Process-lifetime depth peak per channel NAME, backing the
# sd_chan_high_water gauge across instance churn. Keyed by declared
# names only, so it is bounded by the registry itself. The peak
# compare-and-set runs under _HW_LOCK: channels are loop-affine, but
# the pure-sync put_nowait surface is also driven from worker threads
# (jobs run-queue, the threaded stress test), and an unguarded
# read-compare-write could publish a LOWER peak over a higher one —
# the gauge is documented monotone. threadctx declares the contract
# (channels.Metered.high_water guarded_by _hw_lock).
_NAME_HIGH_WATER: Dict[str, int] = {}
_HW_LOCK = threading.Lock()

# Armed by sanitize.install(): (mode, record) — identical split to
# ops/jit_registry.arm. `record(kind, detail, may_raise)` is
# sanitize._record; raise/count is its decision.
_armed_record: Optional[Callable[[str, str, bool], None]] = None


def arm(mode: str, record: Callable[[str, str, bool], None]) -> None:
    """Arm overflow detection (called by sanitize.install). `mode` is
    carried by `record` itself; kept in the signature for parity with
    jit_registry.arm."""
    global _armed_record
    del mode  # the record callback owns the raise/count split
    _armed_record = record


def disarm() -> None:
    global _armed_record
    _armed_record = None


def _violation(detail: str) -> None:
    if _armed_record is not None:
        _armed_record("chan_overflow", detail, True)


def declare_channel(name: str, capacity: int, policy: str, owner: str,
                    doc: str, put_budget: Optional[str] = None,
                    kind: str = "queue",
                    sheds_expected: bool = False) -> ChannelContract:
    if name in CHANNELS:
        raise ValueError(f"channel {name!r} declared twice")
    if capacity <= 0:
        raise ValueError(f"channel {name!r}: capacity must be positive")
    if policy not in POLICIES:
        raise ValueError(f"channel {name!r}: unknown policy {policy!r}")
    if kind not in KINDS:
        raise ValueError(f"channel {name!r}: unknown kind {kind!r}")
    if policy == "block" and kind == "queue":
        if put_budget is None:
            raise ValueError(
                f"channel {name!r}: block policy requires a put_budget "
                "(a timeouts.py name) so producers can never wait "
                "unbounded")
        if put_budget not in TIMEOUTS:
            raise ValueError(
                f"channel {name!r}: put_budget {put_budget!r} is not "
                "declared in spacedrive_tpu_torch/timeouts.py")
    c = ChannelContract(name, int(capacity), policy, owner, doc,
                        put_budget, kind, bool(sheds_expected))
    CHANNELS[name] = c
    return c


def _contract(name: str) -> ChannelContract:
    c = CHANNELS.get(name)
    if c is None:
        raise KeyError(f"undeclared channel {name!r} (declare it in "
                       "spacedrive_tpu_torch/channels.py)")
    return c


def capacity(name: str) -> int:
    """Effective capacity for a declared channel: declared × the
    SDTPU_CHAN_SCALE flag, floored at 1."""
    c = _contract(name)
    try:
        scale = float(flags.get("SDTPU_CHAN_SCALE"))
    except (TypeError, ValueError):
        scale = 1.0
    return max(1, int(round(c.capacity * scale)))


class _Metered:
    """Depth/high-water/shed accounting shared by Channel and Window.
    Label children are cached at construction so the hot path is one
    method call per op."""

    def __init__(self, contract: ChannelContract):
        self.contract = contract
        self.name = contract.name
        self.capacity = capacity(contract.name)
        self.high_water = 0
        self._hw_lock = _HW_LOCK  # module-wide: peaks cross instances
        self._m_depth = CHAN_DEPTH.labels(name=self.name)
        self._m_high = CHAN_HIGH_WATER.labels(name=self.name)
        self._m_shed = CHAN_SHED.labels(name=self.name)

    def _note_depth(self, depth: int) -> None:
        self._m_depth.set(depth)
        if depth > self.high_water:
            with self._hw_lock:
                if depth > self.high_water:
                    self.high_water = depth
                # The gauge is per NAME and documented "since process
                # start"; instances come and go (one ws buffer per
                # subscription), so a fresh instance must not regress
                # it below an earlier instance's peak — and two racing
                # producers must not publish a lower peak over a
                # higher one (monotone under the stress test).
                if depth > _NAME_HIGH_WATER.get(self.name, 0):
                    _NAME_HIGH_WATER[self.name] = depth
                    self._m_high.set(depth)

    def _shed(self, n: int = 1) -> None:
        self._m_shed.inc(n)

    @property
    def shed_total(self) -> float:
        return self._m_shed.value


class Channel(_Metered):
    """A bounded producer/consumer channel bound to a declared
    contract. The deque-backed core needs no event loop; async
    `put`/`get` create their waiter futures lazily on the running
    loop, so synchronous construction paths (Node bootstrap, sync
    tests) work unchanged.

    `on_evict(item)` fires for every item the overflow policy drops
    (shed_oldest eviction, shed_new rejection, coalesce replacement)
    so adopters can settle promises the item carried (the thumbnailer
    marks a shed batch done — its awaiters must not hang)."""

    def __init__(self, name: str,
                 on_evict: Optional[Callable[[Any], None]] = None,
                 capacity_cap: Optional[int] = None):
        super().__init__(_contract(name))
        if self.contract.kind != "queue":
            raise ValueError(
                f"channel {name!r} is declared kind="
                f"{self.contract.kind!r}; use "
                f"{'window' if self.contract.kind == 'window' else 'bounded_dict'}()")
        if capacity_cap is not None:
            # Runtime narrowing BELOW the declared ceiling is allowed —
            # the contract is the upper bound the registry audits, not
            # an exact size (the depth-N overlap pipeline sizes its
            # hand-off channels to the configured depth, which must
            # never exceed the declared ops.pipeline.* capacity).
            self.capacity = max(1, min(self.capacity, int(capacity_cap)))
        self._on_evict = on_evict
        # Slots are [key, item] lists so a coalesce replacement mutates
        # in place, keeping the original queue position.
        self._slots: Deque[list] = deque()
        self._keys: Dict[Any, list] = {}
        self._getters: Deque[asyncio.Future] = deque()
        self._space: Deque[asyncio.Future] = deque()

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._slots)

    def qsize(self) -> int:
        return len(self._slots)

    def __bool__(self) -> bool:
        return bool(self._slots)

    def empty(self) -> bool:
        return not self._slots

    def __iter__(self) -> Iterator[Any]:
        """Snapshot iteration over pending items (run-queue scans)."""
        return iter([slot[1] for slot in list(self._slots)])

    # -- waiter plumbing ---------------------------------------------------

    @staticmethod
    def _wake(waiters: Deque[asyncio.Future]) -> None:
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                break

    def _evict(self, slot: list) -> None:
        if slot[0] is not None:
            self._keys.pop(slot[0], None)
        self._shed()
        if self._on_evict is not None:
            self._on_evict(slot[1])

    def _append(self, item: Any, key: Any) -> None:
        slot = [key, item]
        self._slots.append(slot)
        if key is not None:
            self._keys[key] = slot
        self._note_depth(len(self._slots))
        self._wake(self._getters)

    # -- producer side -----------------------------------------------------

    def put_nowait(self, item: Any, key: Any = None) -> bool:
        """Apply the contract's policy without awaiting. Returns True
        when the item is pending afterwards (directly or coalesced),
        False when it was shed."""
        if key is not None and key in self._keys:
            # Coalesce: replace the pending payload in place; the old
            # payload is the one shed.
            slot = self._keys[key]
            self._evict([None, slot[1]])
            slot[1] = item
            return True
        if len(self._slots) >= self.capacity:
            policy = self.contract.policy
            if policy == "block":
                _violation(
                    f"put_nowait on full block channel {self.name!r} "
                    f"(depth {len(self._slots)}/{self.capacity}): "
                    "producers must use the budgeted `await put()`")
                raise ChannelFull(
                    f"channel {self.name!r} full "
                    f"({len(self._slots)}/{self.capacity})")
            if policy == "shed_oldest":
                self._evict(self._slots.popleft())
                self._append(item, key)
                return True
            # shed_new, and coalesce with no pending key match
            self._evict([None, item])
            return False
        self._append(item, key)
        return True

    async def put(self, item: Any, key: Any = None) -> bool:
        """Policy-aware put. Non-block policies never wait (same as
        put_nowait); block policy waits for space under the contract's
        declared timeouts.py budget, observing the wait into
        sd_chan_put_block_seconds{name}."""
        if self.contract.policy != "block":
            return self.put_nowait(item, key)
        if key is not None and key in self._keys:
            # Same coalesce-in-place as put_nowait: without this, two
            # budgeted puts with one key would append two slots both
            # claiming the key, and the first consume would strip the
            # second slot's mapping — later puts then duplicate
            # instead of coalescing.
            slot = self._keys[key]
            self._evict([None, slot[1]])
            slot[1] = item
            return True
        if len(self._slots) >= self.capacity:
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            try:
                while len(self._slots) >= self.capacity:
                    fut = loop.create_future()
                    self._space.append(fut)
                    try:
                        await with_timeout(self.contract.put_budget, fut)
                    except BaseException:
                        # Budget fired or producer cancelled: remove
                        # the space waiter (wait_for already cancelled
                        # the future on timeout; an abandoned done
                        # future would otherwise sit in the deque until
                        # a get happens to sweep it) and hand any
                        # already-granted space to the next producer.
                        fut.cancel()
                        try:
                            self._space.remove(fut)
                        except ValueError:
                            pass
                        if len(self._slots) < self.capacity \
                                and not fut.cancelled():
                            self._wake(self._space)
                        raise
            finally:
                CHAN_PUT_BLOCK_SECONDS.labels(name=self.name).observe(
                    time.perf_counter() - t0)
        self._append(item, key)
        return True

    # -- consumer side -----------------------------------------------------

    def get_nowait(self) -> Any:
        if not self._slots:
            raise asyncio.QueueEmpty
        slot = self._slots.popleft()
        if slot[0] is not None and self._keys.get(slot[0]) is slot:
            del self._keys[slot[0]]
        self._note_depth(len(self._slots))
        self._wake(self._space)
        return slot[1]

    popleft = get_nowait  # run-queue spelling (jobs manager)

    async def get(self) -> Any:
        while True:
            try:
                return self.get_nowait()
            except asyncio.QueueEmpty:
                fut = asyncio.get_running_loop().create_future()
                self._getters.append(fut)
                try:
                    await fut
                except BaseException:
                    # Cancelled (or worse) while parked: drop the
                    # waiter instead of leaking it in the deque
                    # forever (the worker cancels a pending
                    # commands.get() every step), and if a put woke
                    # THIS future before the cancel landed, pass the
                    # wakeup on so the item isn't stranded — same
                    # contract as asyncio.Queue.get.
                    fut.cancel()
                    try:
                        self._getters.remove(fut)
                    except ValueError:
                        pass
                    if self._slots and not fut.cancelled():
                        self._wake(self._getters)
                    raise

    def remove(self, item: Any) -> None:
        """Remove a specific pending item (run-queue cancellation).
        Raises ValueError when absent, matching deque.remove."""
        for slot in self._slots:
            if slot[1] is item or slot[1] == item:
                self._slots.remove(slot)
                if slot[0] is not None:
                    self._keys.pop(slot[0], None)
                self._note_depth(len(self._slots))
                self._wake(self._space)
                return
        raise ValueError("Channel.remove(item): item not pending")


class Window(_Metered):
    """Depth tracker for a channel whose items live in an EXTERNAL
    buffer (proto.Tunnel's send_nowait frames sit in the transport's
    write buffer, not here). `note_put()` counts an item into the
    window; `note_drain()` empties it (the flush/ack point). A put
    past the declared capacity is the chan_overflow breach — the
    static backpressure pass bounds bursts at the AST, this bounds
    them at runtime.

    Depth mutations serialize on an internal guard so windows can be
    noted from executor threads (the staging buffer pool's stage and
    retire workers) as well as the event loop."""

    def __init__(self, name: str):
        super().__init__(_contract(name))
        if self.contract.kind != "window":
            raise ValueError(
                f"channel {name!r} is declared kind="
                f"{self.contract.kind!r}, not a window")
        self._depth_lock = threading.Lock()
        self._depth = 0

    def __len__(self) -> int:
        return self._depth

    def note_put(self) -> None:
        with self._depth_lock:
            self._depth += 1
            depth = self._depth
        self._note_depth(depth)
        if depth > self.capacity:
            self._shed()  # the frame is already queued; count + flag
            _violation(
                f"window {self.name!r} burst past its declared "
                f"capacity ({depth}/{self.capacity}) without a "
                "drain — a wedged peer now buffers unbounded memory")

    def note_drain(self) -> None:
        with self._depth_lock:
            self._depth = 0
        self._note_depth(0)

    def note_pop(self) -> None:
        """Retire ONE item from the window. For windows whose items
        return individually (the staging buffer pool's leases come
        back one per batch retirement) rather than draining at a
        single flush/ack point."""
        with self._depth_lock:
            if self._depth > 0:
                self._depth -= 1
            depth = self._depth
        self._note_depth(depth)


class BoundedDict(_Metered):
    """Registry-declared cache: an LRU dict capped at the contract's
    capacity, evictions counted into sd_chan_shed_total{name}. The
    unbounded-growth pass exempts attributes constructed through
    `bounded_dict()` — this is the sanctioned grow-forever shape."""

    def __init__(self, name: str):
        super().__init__(_contract(name))
        if self.contract.kind != "cache":
            raise ValueError(
                f"channel {name!r} is declared kind="
                f"{self.contract.kind!r}, not a cache")
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def __setitem__(self, k: Any, v: Any) -> None:
        if k in self._d:
            self._d.move_to_end(k)
        self._d[k] = v
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self._shed()
        self._note_depth(len(self._d))

    def __getitem__(self, k: Any) -> Any:
        v = self._d[k]
        self._d.move_to_end(k)
        return v

    def get(self, k: Any, default: Any = None) -> Any:
        if k in self._d:
            return self[k]
        return default

    def pop(self, k: Any, *default: Any) -> Any:
        v = self._d.pop(k, *default)
        self._note_depth(len(self._d))
        return v

    def __contains__(self, k: Any) -> bool:
        return k in self._d

    def __iter__(self):
        # Without this, `for k in bd` falls back to the legacy
        # sequence protocol (bd[0], bd[1], ...) and dies with a
        # baffling KeyError(0). Iteration is a read, not a use: it
        # must not disturb LRU order.
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __delitem__(self, k: Any) -> None:
        del self._d[k]
        self._note_depth(len(self._d))

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def values(self):
        return self._d.values()


def channel(name: str,
            on_evict: Optional[Callable[[Any], None]] = None,
            capacity_cap: Optional[int] = None) -> Channel:
    """A Channel bound to the declared contract `name`. Multiple
    instances per name are expected (one commands channel per worker,
    one ws buffer per subscription): the shed counter aggregates
    across them; depth gauges sample per instance. `capacity_cap`
    narrows this instance below the declared ceiling (never above)."""
    return Channel(name, on_evict=on_evict, capacity_cap=capacity_cap)


def window(name: str) -> Window:
    return Window(name)


def bounded_dict(name: str) -> BoundedDict:
    return BoundedDict(name)


def chan_table_markdown() -> str:
    """README's generated channel table (one row per declared
    channel)."""
    out = ["| Channel | Capacity | Policy | Owner | Covers |",
           "| --- | --- | --- | --- | --- |"]
    for name in sorted(CHANNELS):
        c = CHANNELS[name]
        doc = " ".join(c.doc.split())
        policy = c.policy if c.kind == "queue" else f"{c.policy} ({c.kind})"
        out.append(f"| `{name}` | {c.capacity} | {policy} | {c.owner} "
                   f"| {doc} |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# THE channel namespace. Keep alphabetical; every entry is enforced by
# the sdlint queue-discipline pass (a bare cross-task queue, or a
# channel() call naming an undeclared contract, fails the build) and
# cross-checked against this registry by tests/test_sdlint.py's drift
# test (every declared channel must be constructed somewhere in the
# tree; every construction must name a declared channel).
# ---------------------------------------------------------------------------

declare_channel(
    "api.ws", 64, "coalesce", "api",
    "Per-subscription websocket event buffer (api/server.py "
    "WsSubscriptionPump): one drainer task per subscription sends "
    "frames under the api.ws.send budget; TelemetrySnapshot events "
    "coalesce to the newest snapshot; a stalled consumer sheds new "
    "events instead of buffering the node's event stream in RAM.")

declare_channel(
    "api.http.inflight", 256, "shed_new", "api",
    "rspc HTTP admission window (api/server.py _rspc_http): one token "
    "per in-flight dispatch. shed_new IS the API host's shed-load "
    "edge — a request past capacity is refused with 503 SHED "
    "immediately instead of queueing unbounded behind a saturated "
    "backend (the jobs run-queue's admission refusal, for the HTTP "
    "plane); sheds count into sd_chan_shed_total{api.http.inflight}, "
    "which is how the health observatory attributes an API storm by "
    "name.")

declare_channel(
    "bench.chan", 256, "block", "tools",
    "tools/chan_bench.py producer/consumer burst channel: the "
    "measured put-block path (budget bench.chan.put).",
    put_budget="bench.chan.put")

declare_channel(
    "bench.load.wire", 64, "block", "tools",
    "tools/load_bench.py stub-transport frame pipe: one instance per "
    "direction per simulated peer, carrying the same tunnel-shaped "
    "frames (clone pages, acks, pull pages) the TCP plane does — the "
    "in-process wire the fleet-scale harness storms the real node "
    "over.", put_budget="bench.load.wire.put")

declare_channel(
    "bench.shed", 256, "shed_new", "tools",
    "tools/chan_bench.py stalled-consumer channel: the measured "
    "shed path.")

declare_channel(
    "jobs.manager.queue", 1024, "shed_new", "jobs",
    "JobManager admission run-queue (FIFO behind the worker pool). "
    "shed_new IS the admission control: a job past capacity is "
    "refused loudly (report FAILED + JobError event), the queue "
    "never balloons.")

declare_channel(
    "fleet.peer.snapshots", 32, "shed_oldest", "fleet",
    "Per-peer ring of fetched obs.health snapshots (spacedrive_tpu_torch/"
    "fleet.py): one instance per registered peer, each entry the "
    "peer's own HealthSnapshot plus receive metadata (rtt, estimated "
    "clock skew, received-at). Oldest snapshots age out — the fleet "
    "view only ever needs the freshest few — so a chatty peer cannot "
    "grow the poller's memory.", sheds_expected=True)

declare_channel(
    "fleet.snapshots", 32, "shed_oldest", "fleet",
    "Recent merged fleet-health views (spacedrive_tpu_torch/fleet.py): "
    "fleet.health serves the newest entry; history ages out "
    "oldest-first, same shape as health.snapshots.",
    sheds_expected=True)

declare_channel(
    "health.series", 120, "shed_oldest", "health",
    "Per-series sample ring of the health observatory (spacedrive_"
    "tpu/health.py): one instance per metric series, each entry a "
    "(ts, windowed value) point from the sampler. Oldest samples age "
    "out — ~10 min of history at the default 5 s interval — so the "
    "observer itself is depth-disciplined like everything it "
    "observes.", sheds_expected=True)

declare_channel(
    "health.snapshots", 64, "shed_oldest", "health",
    "Recent computed HealthSnapshot ring (spacedrive_tpu_torch/health.py): "
    "node.health serves the newest entry; history ages out "
    "oldest-first.", sheds_expected=True)

declare_channel(
    "incidents.store", 64, "shed_oldest", "incidents",
    "Incident-bundle header index of the incident observatory "
    "(spacedrive_tpu_torch/incidents.py) — the count bound of the on-disk "
    "bundle store. Each entry is one frozen evidence bundle's header "
    "plus its file path; shedding the oldest entry DELETES its file "
    "(the eviction hook is the store's garbage collector), so the "
    "postmortem directory can never outgrow this declared bound. "
    "The byte cap (SDTPU_INCIDENT_STORE_MB) evicts through the same "
    "hook; both count sd_incident_dropped_total.",
    sheds_expected=True)

declare_channel(
    "jobs.worker.commands", 16, "shed_oldest", "jobs",
    "Per-worker command inbox (pause/resume/cancel/shutdown). The "
    "drain is latest-wins, so shedding the OLDEST command under a "
    "flood preserves semantics exactly.", sheds_expected=True)

declare_channel(
    "media.thumbs", 64, "shed_oldest", "media",
    "Thumbnailer batch queue with per-path coalescing (media/"
    "actor.py): a full-library scan against a slow thumbnailer sheds "
    "the oldest batch (thumbnails are regenerable; its awaiters are "
    "released) instead of absorbing the index into RAM.")

declare_channel(
    "ops.pipeline.inflight", 8, "block", "ops",
    "Depth-N identify pipeline dispatched-but-unretired window "
    "(ops/overlap.py): device digests (plus, on the undonated path, "
    "their pinned input buffers) waiting for the D2H retirer. "
    "Capacity is the SDTPU_PIPELINE_DEPTH ceiling; each run narrows "
    "its instance to the configured depth.",
    put_budget="ops.pipeline.inflight.put")

declare_channel(
    "ops.pipeline.staged", 8, "block", "ops",
    "Depth-N identify pipeline staged-batch hand-off (ops/overlap.py): "
    "host word/length arrays staged by the concurrent stagers, waiting "
    "for a per-device dispatcher. Capacity is the SDTPU_PIPELINE_DEPTH "
    "ceiling; each run narrows its instance to the configured depth.",
    put_budget="ops.pipeline.staged.put")

declare_channel(
    "ops.pipeline.timeline", 4096, "shed_oldest", "ops",
    "Flight-recorder timeline ring (spacedrive_tpu_torch/flight.py): one "
    "event per pipeline batch phase (stage/H2D/kernel/retire, plus "
    "the per-batch bound-attribution window), written by the per-"
    "device dispatch executor threads under the recorder's lock. "
    "History ages out oldest-first — the export shows the recent "
    "window, memory never grows with uptime.", sheds_expected=True)

declare_channel(
    "ops.stage.pool", 12, "block", "ops",
    "Native staging buffer pool checkout window (ops/staging.py "
    "StagePool): each depth slot's packed H2D source page — a pooled, "
    "page-aligned anonymous mapping the C plane stages straight into "
    "and jax reads zero-copy — counts one item from acquire until its "
    "batch RETIRES. Capacity bounds total pooled pages "
    "(SDTPU_STAGE_POOL_BUFFERS narrows below it): the depth-8 ring + "
    "warmup/calibration leases + slack. An exhausted pool degrades "
    "the batch to the Python staging path — it never allocates past "
    "the bound — and a burst past capacity is a chan_overflow "
    "violation.", kind="window")

declare_channel(
    "p2p.route_cache", 512, "shed_oldest", "p2p",
    "Healthy-tunnel route cache (sync_net): LRU over identity → "
    "(addr, port), invalidated on send failure.", kind="cache")

declare_channel(
    "p2p.tunnel.frames", 4, "block", "p2p",
    "proto.Tunnel's send_nowait frame window: frames sealed but not "
    "yet drained to the socket. The capacity IS sync_net's "
    "CLONE_WINDOW; a burst past it without a drain is a "
    "chan_overflow violation, and the drain itself runs under the "
    "sync.clone.drain budget at the call site.", kind="window")

declare_channel(
    "store.actor.queue", 256, "block", "store",
    "Per-library write-batch queue of the single-writer group-commit "
    "actor (store/actor.py): every product write transaction — job "
    "chunks, sync ingest pages, api mutations — enters as one queued "
    "batch and is coalesced by the supervised writer thread into fat "
    "transactions (SDTPU_STORE_GROUP_MAX / _LATENCY_S bound the "
    "group). Producers block under the store.actor.put budget when "
    "the writer falls behind — the write path's admission edge.",
    put_budget="store.actor.put")

declare_channel(
    "sync.clone.serve", 2, "block", "sync",
    "Fair-share clone-serve page-fetch gate (sync/clone_serve.py): "
    "each concurrent clone stream's next off-loop page fetch takes "
    "one FIFO slot here, so N cloning peers round-robin the fetch "
    "executor instead of a hot stream (fast acks, warm cache) "
    "monopolizing it and starving slower peers — the load harness's "
    "per-peer fairness gate measures the result. Block-wait p99 vs "
    "the sync.clone.serve budget is the clone-overcommit signal the "
    "health observatory attributes by name.",
    put_budget="sync.clone.serve")

declare_channel(
    "sync.ingest.events", 64, "coalesce", "sync",
    "Ingester event inbox (notification/messages): notifications "
    "coalesce by kind (a poke storm collapses to one pending "
    "notification, the reference's wait! semantics); message pages "
    "are flow-controlled one-in-flight by the pull loop.")

declare_channel(
    "sync.ingest.requests", 32, "block", "sync",
    "Ingester → wire request outbox: the _pull consumer drains it "
    "between frames; the producer's put blocks under the "
    "sync.ingest.backlog budget when the consumer wedges.",
    put_budget="sync.ingest.backlog")

declare_channel(
    "tracing.logring", 512, "shed_oldest", "tracing",
    "Bounded in-memory log ring (tracing.LogRing, installed at Node "
    "bootstrap under SDTPU_LOG_RING): the newest trace/span-stamped "
    "log records, aged oldest-first, so incident bundles freeze a "
    "log tail without unbounded buffering — stderr is write-only, "
    "this ring is the recoverable copy.", sheds_expected=True)
