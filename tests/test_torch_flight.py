"""The port's flight recorder against the JAX package's validators.

A depth-3 ring on the CPU over a sparse corpus (a simulated link makes
the copies take time) records stage, h2d, kernel and retire lanes per
measured batch; every batch's retire closes a ``window`` event whose
``binding`` names one of stage, h2d and kernel, all stamped with the
run's ``pipeline.run`` trace. ``chrome_trace`` then passes both
packages' ``validate_chrome_trace``, and the same events recorded by
hand through both recorders give the same window attribution.
"""

import numpy as np
import pytest

from spacedrive_tpu import flight as jfl
from spacedrive_tpu_torch import flight as pfl
from spacedrive_tpu_torch import tracing as ptr
from spacedrive_tpu_torch.ops import overlap


def test_a_cpu_ring_exports_a_valid_trace_with_every_window_attributed(tmp_path):
    batches = overlap.make_sparse_corpus(str(tmp_path / "c"), 48, 200_000, 8)
    pfl.RECORDER.clear()
    ptr.clear_span_ring()
    digs, stats = overlap.run_overlapped(batches, depth=3, devices=["cpu"],
                                         calibrate_every=len(batches), sim_link_gbps=0.5)
    assert len(digs) == len(batches)
    [run] = [s for s in ptr.recent_spans(limit=50) if s["span"] == "pipeline.run"]
    events = pfl.RECORDER.snapshot()
    windows = [e for e in events if e["lane"] == "window"]
    assert len(windows) == len(batches) - 1
    assert {w["batch"] for w in windows} == set(range(1, len(batches)))
    assert all(w["binding"] in ("stage", "h2d", "kernel") for w in windows)
    assert all(w["trace"] == run["trace"] for w in windows)
    lanes = {lane: sum(e["lane"] == lane for e in events)
             for lane in ("stage", "h2d", "kernel", "retire")}
    assert lanes == {lane: len(batches) - 1 for lane in lanes}
    doc = pfl.chrome_trace(node_name="test")
    assert pfl.validate_chrome_trace(doc) == []
    assert jfl.validate_chrome_trace(doc) == []
    assert any(e.get("name", "").startswith("bound:") for e in doc["traceEvents"])


@pytest.mark.parametrize("seed", range(3))
def test_hand_recorded_batches_attribute_alike(seed):
    recs = []
    for mod in (pfl, jfl):
        r = mod.FlightRecorder()
        token = mod.new_run_token()
        t = 100.0
        rng2 = np.random.default_rng(seed)
        for b in range(6):
            for lane in ("stage", "h2d", "kernel"):
                d = float(rng2.uniform(0.001, 0.01))
                r.record(lane, batch=b, t0=t, t1=t + d, device="0" if lane != "stage" else "",
                         trace="abc", run=token)
                t += d
            r.record("retire", batch=b, t0=t, t1=t + 0.0001, trace="abc", run=token)
        recs.append([{k: v for k, v in e.items() if k != "ts_us"} for e in r.snapshot()])
    assert recs[0] == recs[1]
    assert sum(e["lane"] == "window" for e in recs[0]) == 6


class _Event:
    """A stand-in for a completed CUDA event at `ms` on the device clock."""

    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_Event") -> float:
        return end.ms - self.ms


class _Lease:
    def release(self) -> None:
        pass


def test_a_queued_batchs_kernel_lane_leaves_out_its_wait():
    # The batch's copy ends at 1 ms, but its kernel waits on the compute
    # stream behind an earlier batch until 5 ms and runs 0.5 ms; the
    # digests' copy back ends at 5.6 ms.
    import torch

    ring = overlap._Ring.__new__(overlap._Ring)
    ring.stats, ring.trace, ring.run_token = overlap.PipelineStats(), None, None
    rec = overlap._InFlight(3, _Lease(), torch.zeros((2, 8), dtype=torch.int32), "0",
                            h2d_start=_Event(0.0), copied=_Event(1.0),
                            kernel_start=_Event(5.0), kernel_end=_Event(5.5),
                            done=_Event(5.6), t_anchor=100.0)
    pfl.RECORDER.clear()
    ring.retire(rec)
    lanes = {e["lane"]: e for e in pfl.RECORDER.snapshot()}
    assert lanes["h2d"]["dur_us"] == pytest.approx(1000, abs=1)
    assert lanes["kernel"]["dur_us"] == pytest.approx(500, abs=1)
    assert lanes["kernel"]["ts_us"] - lanes["h2d"]["ts_us"] == pytest.approx(5000, abs=1)
    assert ring.stats.h2d_s == pytest.approx(1e-3)
