"""The port's job control: pause, resume, cancel, shutdown and cold resume.

The control cases of ``tests/test_jobs.py`` on the port's ``JobManager``
and worker: a cancel, a live pause and resume, a cold resume after the
manager is dropped, a stateless running report failing, a queued job
surviving a restart, a chain surviving a pause and a restart, and errors
surviving a pause. Then a scan chain whose identifier is paused, resumed,
paused again, shut down and cold-resumed by a fresh manager: its library
snapshot equals the JAX package's straight run of the same corpus, no page
is left unidentified or identified twice, and the job holds no staging
page while it is paused.
"""

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke

from spacedrive_tpu.jobs.manager import JobManager as JaxJobManager
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import manager as jax_locations
from spacedrive_tpu_torch.jobs.job import (JOB_REGISTRY, EarlyFinish, JobState, StatefulJob,
                                           StepOutcome, register_job)
from spacedrive_tpu_torch.jobs.manager import AlreadyRunning, JobBuilder, JobManager
from spacedrive_tpu_torch.jobs.report import JobReport, JobStatus
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import indexer_job
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.objects import dedup, validator
from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob
from spacedrive_tpu_torch.store import Database
from test_torch_scan import _corpus, _snapshot, _write

DEADLINE_S = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeLibrary:
    def __init__(self, db):
        self.db = db


@pytest.fixture
def library(tmp_path):
    lib = FakeLibrary(Database(tmp_path / "lib.db"))
    yield lib
    lib.db.close()


SINK = {}  # each job's steps, keyed by its tag


@register_job
class CountJob(StatefulJob):
    """Appends its step indexes to SINK[tag], dawdling `delay` per step."""

    NAME = "count"

    async def init(self, ctx):
        n = self.init_args["n"]
        if n == 0:
            raise EarlyFinish
        SINK.setdefault(self.init_args["tag"], [])
        return {"tag": self.init_args["tag"]}, list(range(n))

    async def execute_step(self, ctx, data, step, step_number):
        await asyncio.sleep(self.init_args.get("delay", 0))
        SINK[data["tag"]].append(step)
        return StepOutcome(metadata={"last": step})


@register_job
class SlowFlaky(StatefulJob):
    NAME = "slow_flaky"

    async def init(self, ctx):
        return {}, list(range(20))

    async def execute_step(self, ctx, data, step, step_number):
        await asyncio.sleep(0.01)
        if step == 1:
            raise ValueError("pre-pause error")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


async def _until(cond) -> None:
    while not cond():
        await asyncio.sleep(0.002)


def test_cancel(library):
    async def main():
        m = JobManager()
        jid = await m.ingest(library, CountJob(tag="cx", n=50, delay=0.02))
        await _until(lambda: len(SINK.get("cx", ())) >= 1)
        m.cancel(jid)
        assert await m.wait(jid) == JobStatus.CANCELED
        assert len(SINK["cx"]) < 50
        row = library.db.query_one("SELECT status, data FROM job")
        assert row["status"] == int(JobStatus.CANCELED) and row["data"] is None
        # A cancelled job's hash is free again.
        jid = await m.ingest(library, CountJob(tag="cx", n=50, delay=0.02))
        m.cancel(jid)
        await m.wait(jid)

    run(main())


def test_cancel_a_queued_and_a_paused_job(library):
    async def main():
        m = JobManager(max_workers=1)
        a = await m.ingest(library, CountJob(tag="cqa", n=30, delay=0.01))
        b = await m.ingest(library, CountJob(tag="cqb", n=2))
        m.cancel(b)  # queued: cancelled at once
        assert await m.wait(b) == JobStatus.CANCELED
        await asyncio.sleep(0.03)
        m.pause(a)
        assert await m.wait(a) == JobStatus.PAUSED
        with pytest.raises(AlreadyRunning):  # a paused job keeps its hash
            await m.ingest(library, CountJob(tag="cqa", n=30, delay=0.01))
        m.cancel(a)  # paused: cancelled at once
        assert await m.wait(a) == JobStatus.CANCELED
        await m.wait_idle()

    run(main())
    assert "cqb" not in SINK
    rows = library.db.query("SELECT status, data FROM job ORDER BY rowid")
    assert [(r["status"], r["data"]) for r in rows] == [(int(JobStatus.CANCELED), None)] * 2


def test_pause_resume_live(library):
    async def main():
        m = JobManager()
        jid = await m.ingest(library, CountJob(tag="pr", n=30, delay=0.01))
        await _until(lambda: len(SINK.get("pr", ())) >= 2)
        m.pause(jid)
        assert await m.wait(jid) == JobStatus.PAUSED
        done_at_pause = len(SINK["pr"])
        assert 0 < done_at_pause < 30
        row = library.db.query_one("SELECT * FROM job")
        assert row["status"] == int(JobStatus.PAUSED) and row["data"] is not None
        await m.resume(library, jid)
        assert await m.wait(jid) == JobStatus.COMPLETED
        # Steps run to their end here, so no step is replayed.
        assert SINK["pr"] == list(range(30))

    run(main())


def test_resume_before_the_pause_lands_wins(library):
    async def main():
        m = JobManager()
        jid = await m.ingest(library, CountJob(tag="rw", n=10, delay=0.01))
        m.pause(jid)
        await m.resume(library, jid)  # the latest command wins
        assert await m.wait(jid) == JobStatus.COMPLETED

    run(main())
    assert SINK["rw"] == list(range(10))


def test_cold_resume_after_process_death(library):
    async def phase1():
        m = JobManager()
        jid = await m.ingest(library, CountJob(tag="cold", n=40, delay=0.01))
        await _until(lambda: len(SINK.get("cold", ())) >= 2)
        m.pause(jid)
        await m.wait(jid)
        # the manager is dropped here: the process dies

    async def phase2():
        m2 = JobManager()
        resumed = await m2.cold_resume(library)
        assert len(resumed) == 1
        await m2.wait_idle()

    run(phase1())
    assert 0 < len(SINK["cold"]) < 40
    run(phase2())
    assert SINK["cold"] == list(range(40))
    row = library.db.query_one("SELECT * FROM job")
    assert row["status"] == int(JobStatus.COMPLETED)
    assert row["data"] is None  # the checkpoint is cleared on completion


def test_cold_resume_fails_stateless_running_job(library):
    r = JobReport(id=b"x" * 16, name="count", status=JobStatus.RUNNING)
    r.create(library.db)

    async def main():
        assert await JobManager().cold_resume(library) == []

    run(main())
    row = library.db.query_one("SELECT * FROM job")
    assert row["status"] == int(JobStatus.FAILED)
    assert "lost state" in row["errors_text"]


def test_queued_job_survives_restart(library):
    async def phase1():
        m = JobManager(max_workers=1)
        await m.ingest(library, CountJob(tag="qr1", n=20, delay=0.01))
        await m.ingest(library, CountJob(tag="qr2", n=2))
        await asyncio.sleep(0.03)
        await m.shutdown()

    run(phase1())
    assert "qr2" not in SINK  # never started
    statuses = [r["status"] for r in library.db.query("SELECT status FROM job ORDER BY rowid")]
    assert statuses == [int(JobStatus.PAUSED), int(JobStatus.QUEUED)]

    async def phase2():
        m = JobManager()
        assert len(await m.cold_resume(library)) == 2
        await m.wait_idle()

    run(phase2())
    assert SINK["qr1"] == list(range(20))
    assert SINK["qr2"] == [0, 1]


def test_chain_survives_pause_and_restart(library):
    async def phase1():
        m = JobManager()
        jid = await JobBuilder(CountJob(tag="ch1", n=30, delay=0.01)) \
            .queue_next(CountJob(tag="ch2", n=2)).spawn(m, library)
        await asyncio.sleep(0.05)
        m.pause(jid)
        await m.wait(jid)

    run(phase1())
    assert "ch2" not in SINK

    async def phase2():
        m = JobManager()
        await m.cold_resume(library)
        await m.wait_idle()

    run(phase2())
    assert SINK["ch1"] == list(range(30))
    assert SINK["ch2"] == [0, 1]
    rows = library.db.query("SELECT parent_id, status FROM job ORDER BY rowid")
    assert [r["status"] for r in rows] == [int(JobStatus.COMPLETED)] * 2
    assert rows[1]["parent_id"] is not None


def test_errors_survive_pause(library):
    async def main():
        m = JobManager()
        jid = await m.ingest(library, SlowFlaky())
        await _until(lambda: m.running[jid].report.completed_task_count >= 2)
        m.pause(jid)
        assert await m.wait(jid) == JobStatus.PAUSED
        row = library.db.query_one("SELECT errors_text FROM job")
        assert "pre-pause error" in (row["errors_text"] or "")
        await m.resume(library, jid)
        assert await m.wait(jid) == JobStatus.COMPLETED_WITH_ERRORS

    run(main())


def test_the_registry_knows_the_ports_job_classes():
    # jobs.manager loads them before a report row becomes a job again.
    from spacedrive_tpu_torch.jobs import manager

    manager._load_job_classes()
    assert {"indexer", "file_identifier", "object_validator",
            "near_dup_detector"} <= set(JOB_REGISTRY)
    state = JobState.fresh({"location_id": 3, "sub_path": None, "backend": "plain",
                            "device_batch": 7})
    job = JOB_REGISTRY["file_identifier"](**JobState.deserialize(state.serialize()).init_args)
    assert isinstance(job, FileIdentifierJob) and job.chunk_size == 7


def test_paused_scan_cold_resumes_to_the_jax_packages_library(tmp_path, monkeypatch):
    """The identifier (seven pages of 50) is paused after its second step,
    resumed live, paused after its third and shut down; a fresh manager
    cold-resumes it. Every page is hashed once, plus once for each page the
    hash-ahead worker hashed before a pause and the resume hashed again."""
    root = str(tmp_path / "corpus")
    _corpus(root)
    lib = Libraries(str(tmp_path / "port")).create("paused")
    jax_lib = JaxLibraries(str(tmp_path / "jax")).create("straight")
    try:
        loc = locations.create_location(lib, root)
        seen, steps, ref = {}, [0], {}
        step = FileIdentifierJob._step

        def stepped(self, ctx, data):
            # Asks for the pause from the step's thread before the step
            # returns, so it lands right after steps 2 and 3.
            out = step(self, ctx, data)
            steps[0] += 1
            if steps[0] in (2, 3):
                ref["loop"].call_soon_threadsafe(ref["m"].pause, ref["jid"])
            return out

        monkeypatch.setattr(FileIdentifierJob, "_step", stepped)

        def identifier(m):
            return next((j for j, w in m.running.items()
                         if w.report.name == "file_identifier"), None)

        async def first_run():
            m = JobManager()
            ref.update(loop=asyncio.get_running_loop(), m=m)
            await JobBuilder(IndexerJob(location_id=loc)).queue_next(FileIdentifierJob(
                location_id=loc, backend="plain", device_batch=50)).spawn(m, lib)
            await _until(lambda: identifier(m) is not None)
            jid = ref["jid"] = identifier(m)
            assert await m.wait(jid) == JobStatus.PAUSED
            seen["first"] = m._paused[jid].report.completed_task_count
            assert m._paused[jid].job._executor is None  # no hash-ahead thread
            await m.resume(lib, jid)
            assert await m.wait(jid) == JobStatus.PAUSED
            seen["second"] = m._paused[jid].report.completed_task_count
            await m.shutdown()

        run(first_run())
        assert (seen["first"], seen["second"]) == (2, 3)
        job = lib.db.query_one("SELECT * FROM job WHERE name = 'file_identifier'")
        assert job["status"] == int(JobStatus.PAUSED)
        state = JobState.deserialize(job["data"])
        pauses = state.data["pauses"]
        assert [p["in_use"] for p in pauses] == [0, 0]
        orphans = lib.db.query_one("SELECT COUNT(*) AS n FROM file_path WHERE is_dir = 0 "
                                   "AND object_id IS NULL")["n"]
        assert orphans > 0

        async def cold():
            m = JobManager()
            assert len(await m.cold_resume(lib)) == 1
            await m.wait_idle()

        run(cold())

        async def straight():
            m = JaxJobManager()
            jloc = jax_locations.create_location(jax_lib, root)
            await jax_locations.scan_location(m, jax_lib, jloc, backend="numpy",
                                              with_media=False)
            await asyncio.wait_for(m.wait_idle(), DEADLINE_S)

        asyncio.run(straight())
        assert _snapshot(lib.db) == _snapshot(jax_lib.db)
        report = JobReport.from_row(lib.db.query_one(
            "SELECT * FROM job WHERE name = 'file_identifier'"))
        assert report.status == JobStatus.COMPLETED
        # Seven pages, and the prefetched page dropped at each pause hashed again.
        assert report.metadata["pages_hashed"] == 7 + 2
        assert len(report.metadata["pauses"]) == 2
    finally:
        lib.db.close()
        jax_lib.db.close()


def _images(root) -> None:
    """24 small PNGs of their own scenes, four of them planted twins (the
    same pixels, other row filters), beside the scan corpus."""
    rng = np.random.default_rng(5)
    for i in range(20):
        h, w = (int(v) for v in rng.integers(24, 64, 2))
        rgb = np.clip(chip_smoke.image_scene(rng, h, w), 0, 255).astype(np.uint8)
        _write(f"{root}/images/p{i:02d}.png", chip_smoke.encode_image(rng, rgb, "png_rgb")[0])
        if i < 4:
            twin = chip_smoke.encode_image(rng, rgb, "png_rgb", np.full(h, 4))[0]
            _write(f"{root}/images/twin{i:02d}.png", twin)


def _state(lib, root) -> dict:
    near = chip_smoke.near_dup_state(lib, root)
    return {**_snapshot(lib.db), "phash": {k: v.tolist() for k, v in near["hashes"].items()},
            "pairs": near["pairs"]}


@pytest.mark.parametrize("kind", ["indexer", "object_validator", "near_dup_detector"])
def test_each_job_resumes_to_the_straight_runs_library(tmp_path, monkeypatch, kind):
    """The job, paused after its 2nd step, shut down and cold-resumed by a
    fresh manager, leaves the library its straight run leaves."""
    root = str(tmp_path / "corpus")
    _corpus(root)
    _images(root)
    monkeypatch.setattr(indexer_job, "BATCH_SIZE", 40)
    monkeypatch.setattr(indexer_job, "INIT_WALK_LIMIT", 100)
    monkeypatch.setattr(validator, "STEP_FILES", 50)
    monkeypatch.setattr(dedup, "PHASH_BATCH", 6)
    cls = {"indexer": IndexerJob, "object_validator": validator.ObjectValidatorJob,
           "near_dup_detector": dedup.NearDupDetectorJob}[kind]

    def make(loc):
        if kind == "indexer":
            return IndexerJob(location_id=loc)
        if kind == "object_validator":
            return validator.ObjectValidatorJob(location_id=loc, device="cpu")
        return dedup.NearDupDetectorJob(location_id=loc, backend="plain")

    managers, steps = [], [0]
    execute = cls.execute_step

    async def stepped(self, ctx, data, step, step_number):
        out = await execute(self, ctx, data, step, step_number)
        steps[0] += 1
        if steps[0] == 2 and managers:
            m = managers[-1]
            m.pause(next(j for j, w in m.running.items() if w.job is self))
        return out

    monkeypatch.setattr(cls, "execute_step", stepped)

    def library(name, paused):
        lib = Libraries(str(tmp_path / name)).create(name)
        loc = locations.create_location(lib, root)

        async def main():
            m = JobManager()
            if kind != "indexer":
                await locations.scan_location(m, lib, loc, backend="plain", with_media=False)
                await m.wait_idle()
            if paused:
                steps[0] = 0
                managers.append(m)
            jid = await m.ingest(lib, make(loc))
            status = await m.wait(jid)
            assert status == JobStatus.PAUSED if paused else status in (
                JobStatus.COMPLETED, JobStatus.COMPLETED_WITH_ERRORS)
            await m.shutdown()
            managers.clear()

        run(main())
        if paused:
            job = JobReport.from_row(lib.db.query_one(
                "SELECT * FROM job WHERE name = ?", (kind,)))
            assert job.status == JobStatus.PAUSED and job.completed_task_count == 2

            async def cold():
                m = JobManager()
                assert len(await m.cold_resume(lib)) == 1
                await m.wait_idle()

            run(cold())
        return lib

    straight, paused = library("straight", False), library("paused", True)
    try:
        want, got = _state(straight, root), _state(paused, root)
        assert got == want
        # The corpus's photos/red.png is random bytes: a decode error.
        assert got["jobs"][-1] == (kind, int(JobStatus.COMPLETED_WITH_ERRORS
                                             if kind == "near_dup_detector"
                                             else JobStatus.COMPLETED))
        if kind == "near_dup_detector":
            assert len(got["phash"]) == 24 and len(got["pairs"]) >= 4
    finally:
        straight.db.close()
        paused.db.close()
