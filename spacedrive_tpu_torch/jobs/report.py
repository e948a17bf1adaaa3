"""Job reports: the DB-persisted record of every job run.

Port of ``spacedrive_tpu/jobs/report.py`` (upstream
core/src/job/report.rs:41-257): status values are numerically identical,
and the row a report writes is the JAX package's, metadata packed through
the port's msgpack codec.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .. import _msgpack
from ..telemetry import (JOBS_COMPLETED, JOBS_ITEMS_PER_SEC, JOBS_ITEMS_PROCESSED,
                         JOB_DURATION_SECONDS)

# Record separator for the errors_text column: tracebacks hold blank lines.
_ERR_SEP = "\n\x1e\n"


class JobStatus(enum.IntEnum):
    QUEUED = 0
    RUNNING = 1
    COMPLETED = 2
    CANCELED = 3
    FAILED = 4
    PAUSED = 5
    COMPLETED_WITH_ERRORS = 6


@dataclass
class JobReport:
    id: bytes
    name: str
    status: JobStatus = JobStatus.QUEUED
    action: Optional[str] = None
    errors_text: list = field(default_factory=list)
    data: Optional[bytes] = None  # serialized JobState
    metadata: Dict[str, Any] = field(default_factory=dict)
    parent_id: Optional[bytes] = None
    task_count: int = 0
    completed_task_count: int = 0
    date_created: Optional[int] = None
    date_started: Optional[int] = None
    date_completed: Optional[int] = None
    date_estimated_completion: Optional[int] = None

    def record_metrics(self, duration_s: Optional[float] = None) -> None:
        """Publish this report's terminal facts to the node registry:
        completion counters by status, run duration, items processed and
        the derived items/s of the finished run. Called once a worker run
        (paused runs count too: their status label says so)."""
        JOBS_COMPLETED.labels(status=self.status.name.lower()).inc()
        if duration_s is not None and duration_s >= 0:
            JOB_DURATION_SECONDS.labels(name=self.name).observe(duration_s)
            if self.completed_task_count and duration_s > 0:
                JOBS_ITEMS_PER_SEC.labels(name=self.name).set(
                    self.completed_task_count / duration_s)
        if self.completed_task_count:
            JOBS_ITEMS_PROCESSED.labels(name=self.name).inc(self.completed_task_count)

    def create(self, db) -> None:
        self.date_created = int(time.time())
        db.insert("job", self._row())

    def update(self, db) -> None:
        db.update("job", self.id, self._row(exclude_id=True))

    def _row(self, exclude_id: bool = False) -> Dict[str, Any]:
        row = {
            "name": self.name,
            "action": self.action,
            "status": int(self.status),
            "errors_text": _ERR_SEP.join(self.errors_text) or None,
            "data": self.data,
            "metadata": _msgpack.packb(self.metadata) if self.metadata else None,
            "parent_id": self.parent_id,
            "task_count": self.task_count,
            "completed_task_count": self.completed_task_count,
            "date_estimated_completion": self.date_estimated_completion,
            "date_created": self.date_created,
            "date_started": self.date_started,
            "date_completed": self.date_completed,
        }
        if not exclude_id:
            row = {"id": self.id, **row}
        return row

    @classmethod
    def from_row(cls, row) -> "JobReport":
        meta = row["metadata"]
        return cls(
            id=row["id"],
            name=row["name"],
            status=JobStatus(row["status"] or 0),
            action=row["action"],
            errors_text=row["errors_text"].split(_ERR_SEP) if row["errors_text"] else [],
            data=row["data"],
            metadata=_msgpack.unpackb(meta) if meta else {},
            parent_id=row["parent_id"],
            task_count=row["task_count"] or 0,
            completed_task_count=row["completed_task_count"] or 0,
            date_created=row["date_created"],
            date_started=row["date_started"],
            date_completed=row["date_completed"],
            date_estimated_completion=row["date_estimated_completion"],
        )
