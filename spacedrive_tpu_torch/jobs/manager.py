"""Job manager: worker pool, dedup, FIFO queue, chaining, job control.

Port of ``spacedrive_tpu/jobs/manager.py`` (upstream
core/src/job/manager.rs semantics): at most ``MAX_WORKERS`` jobs run at
once and the rest wait in a plain FIFO, a job whose (name, init) hash
matches a running, queued or paused one is refused, and a job that
completes starts the head of its queued ``next_jobs`` chain with the rest
of the chain behind it. Each job gets a report row at ingest carrying a
pre-init state blob with the chain.

Job control: ``pause``, ``resume`` (the live job, or one re-hydrated from
its report row), ``cancel`` (running, queued or paused), ``wait``,
``shutdown`` (running jobs pause, queued ones stay QUEUED in the DB) and
``cold_resume``, which resumes the Paused, Running and Queued reports that
have a state blob and fails those without (manager.rs:269-319). The JAX
package's bounded admission channel and its telemetry are left to it.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from ..store import uuid_bytes as new_job_id
from .job import JOB_REGISTRY, JobState, StatefulJob, job_from_state
from .report import JobReport, JobStatus
from .worker import Worker, WorkerCommand

MAX_WORKERS = 5  # manager.rs:32


class JobManagerError(Exception):
    pass


class AlreadyRunning(JobManagerError):
    pass


def _load_job_classes() -> None:
    """Register the port's job classes (their modules register them on
    import) before a report row is turned back into a job."""
    from ..locations import indexer_job  # noqa: F401
    from ..media import processor  # noqa: F401
    from ..objects import dedup, fs_ops, identifier, validator  # noqa: F401


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
    def __init__(self, job, report, library, next_jobs, resume_state=None):
        self.job = job
        self.report = report
        self.library = library
        self.next_jobs: List[StatefulJob] = next_jobs
        self.resume_state: Optional[JobState] = resume_state


def _chain(jobs: List[StatefulJob]) -> List[Any]:
    return [(j.NAME, j.persistable_init_args()) for j in jobs]


class JobManager:
    def __init__(self, on_event: Optional[Callable[[dict], None]] = None,
                 max_workers: int = MAX_WORKERS, services: Optional[dict] = None):
        self.max_workers = max_workers
        self.on_event = on_event or (lambda e: None)
        self.services = services or {}
        self.running: Dict[bytes, Worker] = {}
        self._tasks: Dict[bytes, asyncio.Task] = {}
        self._entries: Dict[bytes, _Entry] = {}
        self.queue: Deque[_Entry] = deque()
        self._hashes: Dict[str, bytes] = {}  # job.hash() → job id
        self._final_status: Dict[bytes, JobStatus] = {}
        self._paused: Dict[bytes, _Entry] = {}  # paused under this manager
        self._resuming: set = set()  # job ids inside resume()'s await
        self._shutting_down = False

    async def ingest(self, library: Any, job: StatefulJob,
                     next_jobs: Optional[List[StatefulJob]] = None) -> bytes:
        h = job.hash()
        if h in self._hashes:
            raise AlreadyRunning(f"{job.NAME} already running/queued")
        next_jobs = list(next_jobs or [])
        state = JobState.fresh(job.persistable_init_args(), _chain(next_jobs))
        report = JobReport(id=new_job_id(), name=job.NAME, data=state.serialize())
        # Reserve the hash before the report write yields the loop.
        self._hashes[h] = report.id
        try:
            await asyncio.to_thread(report.create, library.db)
        except BaseException:
            if self._hashes.get(h) == report.id:
                del self._hashes[h]
            raise
        self._admit(_Entry(job, report, library, next_jobs, resume_state=state))
        return report.id

    def _admit(self, entry: _Entry) -> None:
        self._entries[entry.report.id] = entry
        if len(self.running) < self.max_workers and not self._shutting_down:
            self._start(entry)
            return
        self.queue.append(entry)
        entry.report.status = JobStatus.QUEUED
        entry.report.update(entry.library.db)

    def _start(self, entry: _Entry) -> None:
        worker = Worker(entry.job, entry.report, entry.library, self.on_event,
                        resume_state=entry.resume_state, services=self.services)
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
            if status == JobStatus.PAUSED:
                # A paused job keeps its dedup hash until it is resumed or
                # cancelled.
                self._paused[job_id] = entry
            else:
                self._hashes.pop(entry.job.hash(), None)
            if status in (JobStatus.COMPLETED, JobStatus.COMPLETED_WITH_ERRORS) \
                    and entry.next_jobs and not self._shutting_down:
                head, *rest = entry.next_jobs
                if head.hash() in self._hashes:
                    self.on_event({
                        "type": "JobError", "id": entry.report.id.hex(),
                        "message": f"chained job {head.NAME} skipped: "
                                   "identical job already running/queued"})
                else:
                    nxt_state = JobState.fresh(head.persistable_init_args(), _chain(rest))
                    nxt_report = JobReport(id=new_job_id(), name=head.NAME,
                                           parent_id=entry.report.id,
                                           data=nxt_state.serialize())
                    nxt_report.create(entry.library.db)
                    self._hashes[head.hash()] = nxt_report.id
                    self._admit(_Entry(head, nxt_report, entry.library, rest,
                                       resume_state=nxt_state))
        while self.queue and len(self.running) < self.max_workers \
                and not self._shutting_down:
            self._start(self.queue.popleft())

    # -- control ---------------------------------------------------------------

    def pause(self, job_id: bytes) -> None:
        """Ask a running job to pause after its current step."""
        self._worker(job_id).command(WorkerCommand.PAUSE)

    async def resume(self, library: Any, job_id: bytes) -> None:
        """Resume a paused job: the live worker when it has not paused yet
        (the latest command wins), else re-admitted from its report row."""
        if job_id in self.running:
            self.running[job_id].command(WorkerCommand.RESUME)
            return
        if job_id in self._entries or job_id in self._resuming:
            return  # already re-admitted, or inside another resume()
        self._resuming.add(job_id)
        try:
            paused = self._paused.pop(job_id, None)
            row = await asyncio.to_thread(library.db.query_one,
                                          "SELECT * FROM job WHERE id = ?", (job_id,))
            if row is None:
                raise JobManagerError("no such job")
            report = JobReport.from_row(row)
            if report.status != JobStatus.PAUSED or not report.data:
                raise JobManagerError("job is not resumable")
            self._admit_from_state(library, report,
                                   live_job=paused.job if paused is not None else None)
        finally:
            self._resuming.discard(job_id)

    def _admit_from_state(self, library: Any, report: JobReport,
                          live_job: Optional[StatefulJob] = None) -> None:
        """Admit a job from its persisted state, its chain rebuilt from
        ``state.next_chain``. A resume under the same manager keeps the live
        job object (it still holds any TRANSIENT_ARGS the blob redacts)."""
        _load_job_classes()
        state = JobState.deserialize(report.data)
        job = live_job or job_from_state(report.name, state)
        next_jobs = [JOB_REGISTRY[name](**init) for name, init in state.next_chain
                     if name in JOB_REGISTRY]
        self._hashes.setdefault(job.hash(), report.id)
        self._final_status.pop(report.id, None)
        self._admit(_Entry(job, report, library, next_jobs, resume_state=state))

    def cancel(self, job_id: bytes) -> None:
        """Cancel a running job (after its current step), or a queued or
        paused one at once."""
        if job_id in self.running:
            self._worker(job_id).command(WorkerCommand.CANCEL)
            return
        for entry in list(self.queue):
            if entry.report.id == job_id:
                self.queue.remove(entry)
                break
        else:
            entry = self._paused.pop(job_id, None)
            if entry is None:
                raise JobManagerError("no such running/queued/paused job")
        self._finalize_entry(entry, JobStatus.CANCELED)

    def _finalize_entry(self, entry: _Entry, status: JobStatus) -> None:
        """A job that ends without a worker (a queued or paused cancel):
        drop it from the indexes, persist its report and sweep its spooled
        step payloads (the worker's cleanup never runs for it)."""
        job_id = entry.report.id
        self._entries.pop(job_id, None)
        h = entry.job.hash()
        if self._hashes.get(h) == job_id:
            del self._hashes[h]
        self._final_status[job_id] = status
        entry.report.status = status
        entry.report.data = None
        entry.report.update(entry.library.db)
        with entry.library.db.write_tx() as conn:
            entry.library.db.run("jobs.scratch.delete_for_job", (job_id,), conn=conn)

    def _worker(self, job_id: bytes) -> Worker:
        if job_id not in self.running:
            raise JobManagerError("no such running job")
        return self.running[job_id]

    async def wait(self, job_id: bytes) -> JobStatus:
        """Wait for a job to end or pause; returns its status."""
        task = self._tasks.get(job_id)
        if task is not None:
            return await asyncio.shield(task)
        if any(entry.report.id == job_id for entry in self.queue):
            while job_id not in self._tasks and job_id not in self._final_status:
                await asyncio.sleep(0.01)  # queued: wait for a worker
            return await self.wait(job_id)
        if job_id in self._final_status:
            return self._final_status[job_id]
        raise JobManagerError("unknown job")

    async def wait_idle(self) -> None:
        """Return once no job runs or waits, chained jobs included. During
        a shutdown queued jobs stay QUEUED and only running ones count."""
        while self._tasks or (self.queue and not self._shutting_down):
            await asyncio.gather(*list(self._tasks.values()), return_exceptions=True)
            # Awaiting finished tasks does not yield to the loop, and the
            # done callbacks that admit chained jobs run from it.
            await asyncio.sleep(0)

    # -- lifecycle ---------------------------------------------------------------

    async def shutdown(self) -> None:
        """Pause every running job; queued ones stay QUEUED in the DB."""
        self._shutting_down = True
        for w in list(self.running.values()):
            w.command(WorkerCommand.SHUTDOWN)
        await self.wait_idle()

    async def cold_resume(self, library: Any) -> List[bytes]:
        """Re-hydrate interrupted jobs from the DB (manager.rs:269-319):
        Paused, Running and Queued reports with a state blob are resumed,
        those without one are marked Failed. Returns the resumed ids."""
        _load_job_classes()
        resumed = []
        rows = await asyncio.to_thread(
            library.db.query, "SELECT * FROM job WHERE status IN (?, ?, ?)",
            (int(JobStatus.PAUSED), int(JobStatus.RUNNING), int(JobStatus.QUEUED)))
        for row in rows:
            report = JobReport.from_row(row)
            if not report.data or report.name not in JOB_REGISTRY:
                report.status = JobStatus.FAILED
                report.errors_text.append("job lost state; cannot resume")
                await asyncio.to_thread(report.update, library.db)
                continue
            state = JobState.deserialize(report.data)
            if job_from_state(report.name, state).hash() in self._hashes:
                continue
            self._admit_from_state(library, report)
            resumed.append(report.id)
        return resumed
