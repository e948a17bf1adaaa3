"""The port's health observatory against the JAX package's.

Both monitors sample a private registry holding every declared family
(each package's ``telemetry.REGISTRY`` swapped for one), on a clock that
advances one second a sample; they are fed the same seeded increments
plus a saturated ``api.ws`` channel, fired ``p2p.ping`` budgets, an
orphaned task and lock waits. Their snapshots pass both packages'
``validate_health_snapshot`` and are equal after dropping the node's
identity. The families of the plane's second half (SQL statements, the
thread contracts) read zero and report nothing. The periodic sampler
runs as a supervised task and stops under a timeout.
"""

import asyncio

import numpy as np
import pytest

from spacedrive_tpu import health as jh
from spacedrive_tpu import telemetry as jt
from spacedrive_tpu_torch import health as ph
from spacedrive_tpu_torch import tasks as ptasks
from spacedrive_tpu_torch import telemetry as pt


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _table(mod):
    return {v.name: v for v in vars(mod).values() if isinstance(v, mod._Metric)}


def _fresh(mod):
    reg = mod.MetricsRegistry()
    fams = {}
    for name, m in sorted(_table(mod).items()):
        if m.kind == "histogram":
            fams[name] = reg.histogram(name, m.help, m.labelnames, buckets=m.buckets)
        else:
            fams[name] = getattr(reg, m.kind)(name, m.help, m.labelnames)
    return reg, fams


def _ops(seed: int):
    fams = _table(pt)
    rng = np.random.default_rng(seed)
    names = sorted(n for n in fams if not n.startswith(("sd_pipeline_", "sd_health_")))
    ops = [("sd_chan_depth", {"name": "api.ws"}, "set", 64.0),
           ("sd_chan_shed_total", {"name": "api.ws"}, "inc", 12.0),
           ("sd_timeout_fired_total", {"name": "p2p.ping"}, "inc", 3.0),
           ("sd_task_orphaned_total", {}, "inc", 1.0)]
    for _ in range(120):
        name = names[int(rng.integers(len(names)))]
        m = fams[name]
        lab = {n: f"v{int(rng.integers(2))}" for n in m.labelnames}
        if m.kind == "histogram":
            ops.append((name, lab, "observe", float(rng.exponential(0.2))))
        elif m.kind == "gauge":
            ops.append((name, lab, "set", float(rng.integers(0, 4))))
        else:
            ops.append((name, lab, "inc", float(rng.integers(1, 4))))
    for v in (0.01, 0.4, 0.9):
        ops.append(("sd_store_write_lock_wait_seconds", {}, "observe", v))
    return ops


def _snapshots(monkeypatch, tel, hmod, ops):
    reg, fams = _fresh(tel)
    monkeypatch.setattr(tel, "REGISTRY", reg)
    clock = _Clock()
    monkeypatch.setattr(hmod, "time", clock)
    mon = hmod.HealthMonitor(interval_s=1.0, node_id="n", node_name="t")
    first = mon.sample()
    clock.t += 1.0
    for name, labels, op, v in ops:
        m = fams[name].labels(**labels) if labels else fams[name]
        getattr(m, op)(v)
    second = mon.sample()
    return first, second


def _norm(snap):
    snap = dict(snap)
    snap.pop("node", None)
    snap.pop("tasks", None)  # each package's own supervisor census
    return snap


@pytest.mark.parametrize("seed", range(3))
def test_both_monitors_agree_on_the_same_increments(monkeypatch, seed):
    ops = _ops(seed)
    with monkeypatch.context() as m:
        mine = _snapshots(m, pt, ph, ops)
    with monkeypatch.context() as m:
        theirs = _snapshots(m, jt, jh, ops)
    for a, b in zip(mine, theirs):
        assert ph.validate_health_snapshot(a) == []
        assert jh.validate_health_snapshot(a) == []
        assert jh.validate_health_snapshot(b) == []
        assert _norm(a) == _norm(b)
    second = mine[1]
    assert second["states"]["api"] == "saturated"
    assert second["attribution"]["api"][0]["resource"] == "api.ws"
    assert second["states"]["tasks"] == "saturated"


def test_second_half_families_read_zero_and_report_nothing(monkeypatch):
    first, second = _snapshots(monkeypatch, pt, ph, [])
    for snap in (first, second):
        assert all(state == "ok" for state in snap["states"].values())
        assert all(not any(f["resource"].startswith(("sql.", "race.")) for f in fs)
                   for fs in snap["attribution"].values())


def test_the_sampler_runs_supervised_and_stops(monkeypatch):
    events = []

    class Bus:
        def emit(self, e):
            events.append(e)

    async def main():
        mon = ph.HealthMonitor(Bus(), interval_s=0.05, owner="test-health")
        mon.start()
        try:
            await asyncio.wait_for(_until(lambda: len(events) >= 2), 5.0)
        finally:
            mon.stop()
            await asyncio.wait_for(ptasks.reap("test-health"), 5.0)
        assert ptasks.live("test-health") == []
        assert all(e["type"] == "HealthSnapshot" for e in events)
        assert ph.validate_health_snapshot(mon.snapshot()) == []

    asyncio.run(main())


async def _until(cond):
    while not cond():
        await asyncio.sleep(0.01)
