"""StatefulJob contract: resumable, checkpointable units of work.

Port of ``spacedrive_tpu/jobs/job.py`` (upstream core/src/job/mod.rs:68-110
semantics): ``init`` produces work steps, ``execute_step`` runs one step
(and may append more), ``finalize`` reports metadata. The whole job state
is msgpack-serializable through the port's codec, byte-equal to the JAX
package's, so a job row reads the same to both packages.

The port keeps its own ``JOB_REGISTRY``, what a resume dispatches on. Its
jobs carry the JAX package's ``NAME``s (``indexer``, ``file_identifier``,
``object_validator``, ``near_dup_detector``, ``media_processor`` and the
file-ops jobs ``file_copier``, ``file_cutter``, ``file_deleter``,
``file_eraser``); the two registries never meet. ``JobManager`` imports the
port's job classes before it resumes anything, so a fresh process can ``cold_resume`` a library's job
table.
"""

from __future__ import annotations

import asyncio
import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Type

from .. import _msgpack


def _canonical(v: Any) -> Any:
    """Recursively sort dict keys so the packed bytes are order-stable."""
    if isinstance(v, dict):
        return {k: _canonical(v[k]) for k in sorted(v)}
    if isinstance(v, (list, tuple)):
        return [_canonical(x) for x in v]
    return v


class JobError(Exception):
    pass


class EarlyFinish(JobError):
    """Job has nothing to do; complete cleanly (file_identifier_job.rs:131)."""


@dataclass
class StepOutcome:
    """Result of one execute_step call: more_steps go to the back of the
    queue, errors are non-fatal and accumulate into the report."""

    more_steps: List[Any] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)


class StatefulJob:
    """Base class for every workload job.

    Subclasses set NAME (stable, used for dispatch on resume) and
    implement init / execute_step / finalize. `init_args` must be
    msgpack-serializable: it is both the checkpoint identity and the dedup
    hash input (job/manager.rs:107-122 semantics).
    """

    NAME: str = ""
    IS_BATCHED: bool = False  # task_count counts batches, not items
    # Init-arg names that never reach the DB (secrets): they serialize as
    # None, and a cold-resumed job gets None back.
    TRANSIENT_ARGS: frozenset = frozenset()

    def __init__(self, **init_args: Any):
        self.init_args = init_args

    def persistable_init_args(self) -> Dict[str, Any]:
        """init_args with TRANSIENT_ARGS redacted to None: the only form
        written to the job table."""
        if not self.TRANSIENT_ARGS:
            return self.init_args
        return {k: (None if k in self.TRANSIENT_ARGS else v)
                for k, v in self.init_args.items()}

    def hash(self) -> str:
        """Dedup hash over (NAME, init args), insensitive to kwarg order."""
        payload = _msgpack.packb({"name": self.NAME, "init": _canonical(self.init_args)})
        return hashlib.blake2b(payload, digest_size=16).hexdigest()

    async def init(self, ctx: "JobContext") -> tuple[Dict[str, Any], List[Any]]:
        """Return (data, steps). Raise EarlyFinish when there is no work.
        Jobs whose init is pure sync work define ``_init_sync(ctx)``; the
        base runs it off the event loop."""
        sync_init = getattr(self, "_init_sync", None)
        if sync_init is not None:
            return await asyncio.to_thread(sync_init, ctx)
        raise NotImplementedError

    async def execute_step(self, ctx: "JobContext", data: Dict[str, Any], step: Any,
                           step_number: int) -> Optional[StepOutcome]:
        raise NotImplementedError

    async def cleanup(self, ctx: "JobContext", data: Optional[Dict[str, Any]]) -> None:
        """Best-effort teardown when the job ends WITHOUT finalize (a
        job-level failure or a cancel). Must be idempotent; the worker
        swallows exceptions."""
        return None

    async def suspend(self, ctx: "JobContext", data: Dict[str, Any]) -> None:
        """Let go of what the run holds outside its state (threads, pinned
        pages) before a pause or a shutdown persists that state. The job
        may stay paused for hours, and a resume (live or cold) runs the
        next step without ``init``, so a job rebuilds what it needs there.
        It may record what it let go in `data`, which is persisted after
        this returns."""
        return None

    async def finalize(self, ctx: "JobContext", data: Dict[str, Any],
                       metadata: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        return metadata or None


@dataclass
class JobState:
    """Everything needed to resume a job; `next_chain` persists queued
    follow-up jobs as (name, init_args) pairs."""

    init_args: Dict[str, Any]
    data: Dict[str, Any]
    steps: Deque[Any]
    step_number: int
    run_metadata: Dict[str, Any]
    next_chain: List[Any] = field(default_factory=list)

    def serialize(self) -> bytes:
        return _msgpack.packb({
            "init": self.init_args,
            "data": self.data,
            "steps": list(self.steps),
            "step_number": self.step_number,
            "run_metadata": self.run_metadata,
            "next_chain": [[name, init] for name, init in self.next_chain],
        })

    @classmethod
    def deserialize(cls, blob: bytes) -> "JobState":
        raw = _msgpack.unpackb(blob)
        return cls(
            init_args=raw["init"],
            data=raw["data"],
            steps=deque(raw["steps"]),
            step_number=raw["step_number"],
            run_metadata=raw["run_metadata"],
            next_chain=[tuple(p) for p in raw.get("next_chain", [])],
        )

    @classmethod
    def fresh(cls, init_args: Dict[str, Any],
              next_chain: Optional[List[Any]] = None) -> "JobState":
        """Pre-init state written at ingest."""
        return cls(init_args=init_args, data={}, steps=deque(), step_number=0,
                   run_metadata={}, next_chain=list(next_chain or []))


class JobContext:
    """What a running job sees: the library, its job id, progress, and
    `services`, the manager's node-level actors and settings (the media
    job's ``data_dir`` and thumbnailer) without jobs importing their owner."""

    def __init__(self, library: Any, report_progress=None, job_id: Optional[bytes] = None,
                 services: Optional[dict] = None):
        self.library = library
        self.services = services or {}
        self.job_id = job_id  # keys job_scratch rows
        self._report_progress = report_progress or (lambda **kw: None)

    @property
    def db(self):
        return self.library.db

    def progress(self, *, task_count: Optional[int] = None,
                 completed: Optional[int] = None, message: Optional[str] = None) -> None:
        """Report progress; the worker throttles and adds an ETA."""
        self._report_progress(task_count=task_count, completed=completed, message=message)


# NAME → class: what a resume of a persisted job chain dispatches on.
JOB_REGISTRY: Dict[str, Type[StatefulJob]] = {}


def register_job(cls: Type[StatefulJob]) -> Type[StatefulJob]:
    if not cls.NAME or JOB_REGISTRY.get(cls.NAME, cls) is not cls:
        raise ValueError(f"job class {cls.__name__} needs a NAME of its own")
    JOB_REGISTRY[cls.NAME] = cls
    return cls


def job_from_state(name: str, state: JobState) -> StatefulJob:
    """The job a persisted state blob resumes."""
    return JOB_REGISTRY[name](**state.init_args)
