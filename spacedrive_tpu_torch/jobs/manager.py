"""Job manager: worker pool, dedup, FIFO queue, chaining.

Port of ``spacedrive_tpu/jobs/manager.py`` (upstream
core/src/job/manager.rs semantics): at most ``MAX_WORKERS`` jobs run at
once and the rest wait in a plain FIFO, a job whose (name, init) hash
matches a running or queued one is refused, and a job that completes
starts the head of its queued ``next_jobs`` chain with the rest of the
chain behind it. Each job gets a report row at ingest carrying a pre-init
state blob with the chain. Pause, resume, cancel and cold resume wait in
ROADMAP.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from ..store import uuid_bytes as new_job_id
from .job import JobState, StatefulJob
from .report import JobReport, JobStatus
from .worker import Worker

MAX_WORKERS = 5  # manager.rs:32


class AlreadyRunning(Exception):
    pass


class JobBuilder:
    """Compose a job with chained next-jobs, then dispatch it:
    ``JobBuilder(a).queue_next(b).queue_next(c).spawn(manager, library)``
    (core/src/location/mod.rs:429-445)."""

    def __init__(self, job: StatefulJob):
        self.job = job
        self.next_jobs: List[StatefulJob] = []

    def queue_next(self, job: StatefulJob) -> "JobBuilder":
        self.next_jobs.append(job)
        return self

    async def spawn(self, manager: "JobManager", library: Any) -> bytes:
        return await manager.ingest(library, self.job, next_jobs=self.next_jobs)


class _Entry:
    def __init__(self, job, report, library, next_jobs):
        self.job = job
        self.report = report
        self.library = library
        self.next_jobs: List[StatefulJob] = next_jobs


def _chain(jobs: List[StatefulJob]) -> List[Any]:
    return [(j.NAME, j.init_args) for j in jobs]


class JobManager:
    def __init__(self, on_event: Optional[Callable[[dict], None]] = None,
                 max_workers: int = MAX_WORKERS):
        self.max_workers = max_workers
        self.on_event = on_event or (lambda e: None)
        self.running: Dict[bytes, Worker] = {}
        self._tasks: Dict[bytes, asyncio.Task] = {}
        self._entries: Dict[bytes, _Entry] = {}
        self.queue: Deque[_Entry] = deque()
        self._hashes: Dict[str, bytes] = {}  # job.hash() → job id
        self._final_status: Dict[bytes, JobStatus] = {}

    async def ingest(self, library: Any, job: StatefulJob,
                     next_jobs: Optional[List[StatefulJob]] = None) -> bytes:
        h = job.hash()
        if h in self._hashes:
            raise AlreadyRunning(f"{job.NAME} already running/queued")
        next_jobs = list(next_jobs or [])
        state = JobState.fresh(job.init_args, _chain(next_jobs))
        report = JobReport(id=new_job_id(), name=job.NAME, data=state.serialize())
        # Reserve the hash before the report write yields the loop.
        self._hashes[h] = report.id
        try:
            await asyncio.to_thread(report.create, library.db)
        except BaseException:
            if self._hashes.get(h) == report.id:
                del self._hashes[h]
            raise
        self._admit(_Entry(job, report, library, next_jobs))
        return report.id

    def _admit(self, entry: _Entry) -> None:
        self._entries[entry.report.id] = entry
        if len(self.running) < self.max_workers:
            self._start(entry)
            return
        self.queue.append(entry)
        entry.report.status = JobStatus.QUEUED
        entry.report.update(entry.library.db)

    def _start(self, entry: _Entry) -> None:
        worker = Worker(entry.job, entry.report, entry.library, self.on_event,
                        _chain(entry.next_jobs))
        self.running[entry.report.id] = worker
        task = asyncio.get_running_loop().create_task(
            worker.run(), name=f"job/{entry.report.name}")
        self._tasks[entry.report.id] = task
        task.add_done_callback(lambda t, jid=entry.report.id: self._on_done(jid, t))

    def _on_done(self, job_id: bytes, task: asyncio.Task) -> None:
        self.running.pop(job_id, None)
        self._tasks.pop(job_id, None)
        entry = self._entries.pop(job_id, None)
        status = entry.report.status if entry else JobStatus.FAILED
        self._final_status[job_id] = status
        if entry is not None:
            self._hashes.pop(entry.job.hash(), None)
            if status in (JobStatus.COMPLETED, JobStatus.COMPLETED_WITH_ERRORS) \
                    and entry.next_jobs:
                head, *rest = entry.next_jobs
                if head.hash() in self._hashes:
                    self.on_event({
                        "type": "JobError", "id": entry.report.id.hex(),
                        "message": f"chained job {head.NAME} skipped: "
                                   "identical job already running/queued"})
                else:
                    nxt_state = JobState.fresh(head.init_args, _chain(rest))
                    nxt_report = JobReport(id=new_job_id(), name=head.NAME,
                                           parent_id=entry.report.id,
                                           data=nxt_state.serialize())
                    nxt_report.create(entry.library.db)
                    self._hashes[head.hash()] = nxt_report.id
                    self._admit(_Entry(head, nxt_report, entry.library, rest))
        while self.queue and len(self.running) < self.max_workers:
            self._start(self.queue.popleft())

    async def wait_idle(self) -> None:
        """Return once no job runs or waits, chained jobs included."""
        while self._tasks or self.queue:
            await asyncio.gather(*list(self._tasks.values()), return_exceptions=True)
            # Awaiting finished tasks does not yield to the loop, and the
            # done callbacks that admit chained jobs run from it.
            await asyncio.sleep(0)
