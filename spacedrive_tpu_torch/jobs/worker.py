"""The job run loop: one asyncio task per running job.

Port of ``spacedrive_tpu/jobs/worker.py``: ``init`` (skipped when the job
resumes from a state blob with work in it), then the steps in order (a
step may append more), a crash checkpoint of the resumable state every
``CHECKPOINT_INTERVAL_S``, ``finalize``, a passive WAL fold, and every
status transition persisted. A step's exception is a non-fatal error in
the report; a ``JobError`` or a failure outside a step fails the job after
its ``cleanup``. Progress events are throttled to ``PROGRESS_THROTTLE_S``
and carry an ETA (worker.rs:228-292).

The command inbox (``command``: PAUSE, RESUME, CANCEL, SHUTDOWN) is
drained between steps, the latest command winning. PAUSE and SHUTDOWN let
the job ``suspend`` and persist the remaining steps as a PAUSED report;
CANCEL runs ``cleanup`` and ends CANCELED, and is honoured after the last
step too, before ``finalize``. The JAX package also cancels a step in
flight; here a step always runs to its end (the identifier's commit runs
in a thread that a cancel could not stop), so a command waits for it.
"""

from __future__ import annotations

import asyncio
import time
import traceback
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from ..telemetry import JOBS_EARLY_FINISH, JOBS_STEP_ERRORS, JOB_STEP_SECONDS
from ..tracing import current_trace_id
from ..tracing import span as trace_span
from .job import EarlyFinish, JobContext, JobError, JobState, StatefulJob, StepOutcome
from .report import JobReport, JobStatus

PROGRESS_THROTTLE_S = 0.5  # worker.rs:273
# Periodic crash checkpoint: bounds what a hard kill replays.
CHECKPOINT_INTERVAL_S = 3.0


class WorkerCommand:
    PAUSE = "pause"
    RESUME = "resume"
    CANCEL = "cancel"
    SHUTDOWN = "shutdown"


class Worker:
    """Drives one job to completion, pause, cancellation or failure.
    `resume_state` is the state blob the job was admitted with: the
    pre-init blob of a fresh job (its chain), or the state of a paused or
    interrupted run."""

    def __init__(self, job: StatefulJob, report: JobReport, library: Any,
                 on_event: Callable[[dict], None],
                 resume_state: Optional[JobState] = None, services: Optional[dict] = None):
        self.job = job
        self.services = services or {}
        self.report = report
        self.library = library
        self.on_event = on_event
        self.resume_state = resume_state
        self.commands: Deque[str] = deque()
        self._last_progress_emit = 0.0
        self._last_checkpoint = time.monotonic()
        self._started_at = 0.0

    def command(self, cmd: str) -> None:
        self.commands.append(cmd)

    def _drain_commands(self) -> Optional[str]:
        """The latest pending command (a RESUME after a PAUSE not yet acted
        on cancels it)."""
        cmd = None
        while self.commands:
            cmd = self.commands.popleft()
        return cmd

    def _progress(self, task_count=None, completed=None, message=None) -> None:
        r = self.report
        if task_count is not None:
            r.task_count = task_count
        if completed is not None:
            r.completed_task_count = completed
        now = time.monotonic()
        if r.completed_task_count and r.task_count:
            per_task = (now - self._started_at) / r.completed_task_count
            remaining = per_task * (r.task_count - r.completed_task_count)
            r.date_estimated_completion = int(time.time() + remaining)
        if now - self._last_progress_emit >= PROGRESS_THROTTLE_S:
            self._last_progress_emit = now
            self.on_event({
                "type": "JobProgress", "id": r.id.hex(), "name": r.name,
                "task_count": r.task_count,
                "completed_task_count": r.completed_task_count,
                "message": message, "estimated_completion": r.date_estimated_completion,
            })

    async def run(self) -> JobStatus:
        # Root span of this run's trace: every job.step span (and any span
        # opened inside step bodies: contextvars survive asyncio.to_thread)
        # nests under it.
        with trace_span(f"job/{self.report.name}", job_id=self.report.id.hex()):
            # The run's trace id in the persisted report: an operator jumps
            # from a job row to its spans (node.spans {trace}) and its
            # flight-recorder timeline (node.trace.export).
            self.report.metadata["trace"] = current_trace_id()
            try:
                status = await self._run_inner()
            except asyncio.CancelledError:
                status = await self._persist_paused_or_fail("worker task cancelled")
            except Exception as e:  # noqa: BLE001 (a job-level failure)
                await self._cleanup_quietly(None)
                self.report.status = JobStatus.FAILED
                self.report.errors_text.append("".join(traceback.format_exception(e)).strip())
                self.report.date_completed = int(time.time())
                self.report.data = None
                await asyncio.to_thread(self.report.update, self.library.db)
            else:
                self.report.status = status
        self.report.record_metrics(
            duration_s=(time.monotonic() - self._started_at) if self._started_at else None)
        self.on_event({"type": "JobUpdate", "id": self.report.id.hex(),
                       "name": self.report.name, "status": int(self.report.status)})
        return self.report.status

    async def _spanned_step(self, ctx: JobContext, state: JobState):
        """One step under a child span of the job's root trace, plus the
        per-step latency histogram."""
        t0 = time.perf_counter()
        try:
            with trace_span("job.step", job=self.report.name, step=state.step_number):
                return await self.job.execute_step(ctx, state.data, state.steps[0],
                                                   state.step_number)
        finally:
            JOB_STEP_SECONDS.labels(name=self.report.name).observe(
                time.perf_counter() - t0)

    async def _run_inner(self) -> JobStatus:
        r = self.report
        ctx = JobContext(self.library, report_progress=self._progress, job_id=r.id,
                         services=self.services)
        self._started_at = time.monotonic()
        r.status = JobStatus.RUNNING
        r.date_started = int(time.time())
        await asyncio.to_thread(r.update, self.library.db)

        errors: List[str] = []
        resume = self.resume_state
        if resume is not None and (resume.steps or resume.step_number):
            state = resume
            errors = list(r.errors_text)
        else:
            # A fresh run, or a job resumed before its init ever ran (its
            # blob was written at ingest).
            try:
                data, steps = await self.job.init(ctx)
            except EarlyFinish:
                JOBS_EARLY_FINISH.inc()
                r.status = JobStatus.COMPLETED
                r.data = None  # clear the at-ingest state blob
                r.date_completed = int(time.time())
                await asyncio.to_thread(r.update, self.library.db)
                return JobStatus.COMPLETED
            state = JobState(
                init_args=self.job.persistable_init_args(), data=data,
                steps=deque(steps), step_number=0, run_metadata={},
                next_chain=resume.next_chain if resume is not None else [])
        if not r.task_count:
            r.task_count = len(state.steps)

        while state.steps:
            cmd = self._drain_commands()
            if cmd == WorkerCommand.CANCEL:
                return await self._finish_cancel(ctx, state)
            if cmd in (WorkerCommand.PAUSE, WorkerCommand.SHUTDOWN):
                return await self._persist_paused(ctx, state, errors)
            try:
                outcome = await self._spanned_step(ctx, state)
            except JobError:
                raise
            except Exception as e:  # noqa: BLE001 (a non-fatal step error)
                JOBS_STEP_ERRORS.inc()
                errors.append(f"step {state.step_number}: "
                              + "".join(traceback.format_exception(e)).strip())
                outcome = None
            if isinstance(outcome, StepOutcome):
                state.steps.extend(outcome.more_steps)
                r.task_count += len(outcome.more_steps)
                JOBS_STEP_ERRORS.inc(len(outcome.errors))
                errors.extend(outcome.errors)
                state.run_metadata.update(outcome.metadata)
            state.steps.popleft()
            state.step_number += 1
            self._progress(completed=state.step_number)
            now = time.monotonic()
            if now - self._last_checkpoint >= CHECKPOINT_INTERVAL_S:
                self._last_checkpoint = now
                # Best effort: a checkpoint write must never kill a job.
                try:
                    await asyncio.to_thread(self._persist_state, state, errors)
                except Exception:  # noqa: BLE001 (retried next interval)
                    pass

        # A CANCEL that came with the last step is still honoured: finalize
        # has not run. A PAUSE of a finished job is moot.
        if self._drain_commands() == WorkerCommand.CANCEL:
            return await self._finish_cancel(ctx, state)

        meta = await self.job.finalize(ctx, state.data, state.run_metadata)
        # Bulk jobs run with wal_autocheckpoint off: fold the WAL back now.
        await asyncio.to_thread(self.library.db.checkpoint_passive)
        if meta:
            r.metadata.update(meta)
        r.errors_text = errors
        r.completed_task_count = state.step_number
        r.data = None
        r.date_completed = int(time.time())
        r.status = JobStatus.COMPLETED_WITH_ERRORS if errors else JobStatus.COMPLETED
        await asyncio.to_thread(r.update, self.library.db)
        return r.status

    def _persist_state(self, state: JobState, errors: List[str]) -> None:
        """Write the resumable state blob (the crash checkpoint)."""
        self.report.data = state.serialize()
        self.report.errors_text = list(errors)
        self.report.completed_task_count = state.step_number
        self.report.update(self.library.db)

    async def _persist_paused(self, ctx: JobContext, state: JobState,
                              errors: List[str]) -> JobStatus:
        await self.job.suspend(ctx, state.data)
        self.report.status = JobStatus.PAUSED
        await asyncio.to_thread(self._persist_state, state, errors)
        return JobStatus.PAUSED

    async def _persist_paused_or_fail(self, why: str) -> JobStatus:
        """The worker's task was cancelled (process shutdown) with no state
        in hand: paused when a checkpoint was written, else failed."""
        if self.report.data is not None:
            self.report.status = JobStatus.PAUSED
        else:
            self.report.status = JobStatus.FAILED
            self.report.errors_text.append(why)
        await asyncio.to_thread(self.report.update, self.library.db)
        return self.report.status

    async def _finish_cancel(self, ctx: JobContext, state: JobState) -> JobStatus:
        await self._cleanup_quietly(state.data)
        self.report.status = JobStatus.CANCELED
        self.report.data = None
        self.report.completed_task_count = state.step_number
        self.report.date_completed = int(time.time())
        await asyncio.to_thread(self.report.update, self.library.db)
        return JobStatus.CANCELED

    async def _cleanup_quietly(self, data) -> None:
        """Run the job's no-finalize teardown; never raises."""
        try:
            await self.job.cleanup(JobContext(self.library, job_id=self.report.id,
                                              services=self.services), data)
        except Exception:  # noqa: BLE001 (cleanup is best-effort)
            pass
