"""The port's depth-N ring (``ops/overlap.py``) on the CPU.

Digest tests run the ring's default kernel (the plain torch K1 on a CPU
device) over at most 16 files x 4 batches and hold every digest against
the JAX package's numpy BLAKE3 on the Python readers' rows. Overlap-shaped
tests run a cheap kernel under a simulated link, after
``tests/test_overlap.py``: on a CPU device the copy and the kernel share
the dispatch thread, so the ring's overlap there comes from the stagers and
from round-robin over two devices.
"""

import threading

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_batch as jax_bb
from spacedrive_tpu.ops import staging as jax_staging
from spacedrive_tpu_torch.ops import overlap, staging


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cheap_kernel(words, lengths):
    """A [B, 8] stand-in for BLAKE3 that costs next to nothing."""
    return (words[:, :, :8].sum(dim=1, dtype=torch.int64)
            + lengths[:, None]).to(torch.int32)


def _corpus(root, n_files, batch, seed=11):
    """Sparse 120 000-byte files, each with its own bytes at a sampled
    offset, so a page that leaked between batches would show."""
    batches = overlap.make_sparse_corpus(str(root), n_files, 120_000, batch)
    rng = np.random.default_rng(seed)
    for paths, _ in batches:
        for p in paths:
            with open(p, "r+b") as f:
                f.seek(30_000)
                f.write(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    return batches


def _numpy_reference(paths, sizes):
    files = list(zip(paths, sizes.tolist()))
    large, _small, _empty, errors = jax_staging.stage_files(files)
    assert not errors
    words, lengths = jax_bb.build_cas_messages(large.payloads, large.sizes)
    return np.stack(jax_bb.blake3_batch(np, words, lengths), axis=1)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_digests_match_numpy_reference(tmp_path, depth):
    batches = _corpus(tmp_path, 4 * 16, 16)
    # depth 3 pauses once mid-run to calibrate (milestone after batch 2).
    res, stats = overlap.run_overlapped(batches, depth=depth, devices=["cpu"],
                                        calibrate_every=1 if depth == 3 else 99)
    for k, (paths, sizes) in enumerate(batches):
        assert res[k].dtype == np.uint32 and res[k].shape == (16, 8)
        assert np.array_equal(res[k], _numpy_reference(paths, sizes)), k
    assert len(stats.samples) == (3 if depth == 3 else 2)
    assert stats.kernel_batches == len(batches) + len(stats.samples)
    assert stats.stage_native_batches == stats.kernel_batches
    assert stats.stage_python_batches == 0 and stats.fallback_files == 0
    assert stats.staging_backend == "native"
    assert stats.files == 3 * 16 and stats.files_per_sec > 0
    assert 1 <= stats.depth_high_water <= depth
    assert stats.leases_out == 0 and stats.pool_pages == depth + 1
    assert stats.pinned_bytes == 0  # CPU pages are not pinned
    # Copies of the measured batches (calibration copies are timed apart).
    assert stats.h2d_bytes == (len(batches) - 1) * 16 * (57 * 1024 + 4)


def test_depth_one_is_serial(tmp_path):
    batches = _corpus(tmp_path, 6 * 16, 16)
    _res, stats = overlap.run_overlapped(batches, _cheap_kernel, depth=1,
                                         devices=["cpu"], sim_link_gbps=0.2)
    assert stats.depth_high_water == 1
    t_s, t_h, t_k = stats._component_bests()
    assert stats.bound_files_per_sec == pytest.approx(
        stats.batch_files / (t_s + t_h + t_k))


def test_sim_link_bound_across_depths(tmp_path):
    """After tests/test_overlap.py::test_sim_link_bound_across_depths: with
    the simulated link binding, depth 3 lands within 1.5x of its computed
    bound, beats depth 1 by more than 5 %, and the rate is monotone in
    depth within the same tolerances. Two CPU devices give the copies of
    two batches somewhere to overlap."""
    batches = _corpus(tmp_path, 9 * 32, 32)

    def measure(depth):
        # 32 rows of 57 KiB at 0.05 GB/s: ~37 ms of simulated copy a batch.
        res, stats = overlap.run_overlapped(
            batches, _cheap_kernel, len(batches), depth=depth,
            devices=["cpu", "cpu"], sim_link_gbps=0.05)
        assert all(r is not None for r in res)
        assert stats.sim_link_gbps == pytest.approx(0.05)
        assert 1 <= stats.depth_high_water <= depth
        return stats.bound_report()

    reports = {d: measure(d) for d in (1, 2, 3, 4)}
    measured = {d: r["measured_files_per_sec"] for d, r in reports.items()}
    # One re-measure for a deeper run that a scheduler storm crushed: a real
    # regression reproduces, a one-off stall does not.
    floor = {2: lambda: measured[1] * 0.90, 3: lambda: measured[2] * 0.85,
             4: lambda: measured[3] * 0.85}
    for d in (2, 3, 4):
        if measured[d] < floor[d]():
            retry = measure(d)
            if retry["measured_files_per_sec"] > measured[d]:
                reports[d] = retry
                measured[d] = retry["measured_files_per_sec"]
    assert reports[3]["bound_files_per_sec"] <= measured[3] * 1.5, reports[3]
    assert measured[3] > measured[1] * 1.05, measured
    assert measured[4] > measured[1] * 1.05, measured
    assert measured[2] >= measured[1] * 0.90, measured
    assert measured[3] >= measured[2] * 0.85, measured
    assert measured[4] >= measured[3] * 0.85, measured


def test_round_robin_over_two_cpu_devices(tmp_path):
    batches = _corpus(tmp_path, 7 * 8, 8)
    one, _ = overlap.run_overlapped(batches, _cheap_kernel, 99, depth=2,
                                    devices=["cpu"])
    two, stats = overlap.run_overlapped(batches, _cheap_kernel, 99, depth=3,
                                        devices=["cpu", "cpu"], sim_link_gbps=0.05)
    assert stats.n_devices == 2
    assert sorted(stats.per_device_batches) == ["0", "1"]
    assert all(v > 0 for v in stats.per_device_batches.values())
    assert sum(stats.per_device_batches.values()) == len(batches) - 1
    for a, b in zip(one, two):
        assert np.array_equal(a, b)


def test_pool_drains_after_a_staging_error(tmp_path, monkeypatch):
    batches = _corpus(tmp_path, 6 * 8, 8)
    paths, sizes = batches[3]
    batches[3] = ([*paths[:-1], str(tmp_path / "vanished")], sizes)
    pools = []

    class Recorded(staging.StagePool):
        def __init__(self, *args):
            super().__init__(*args)
            pools.append(self)

    monkeypatch.setattr(staging, "StagePool", Recorded)
    with pytest.raises(OSError, match="vanished"):
        overlap.run_overlapped(batches, _cheap_kernel, 99, depth=3,
                               devices=["cpu", "cpu"], sim_link_gbps=0.05)
    assert len(pools) == 1 and pools[0].in_use == 0
    assert not [t for t in threading.enumerate() if t.name.startswith("ring-")]


def test_ring_refuses_what_it_does_not_take(tmp_path):
    batches = _corpus(tmp_path, 4, 2)
    with pytest.raises(ValueError, match="large-class"):
        overlap.run_overlapped([(["x"], np.array([5000], np.uint64))], depth=1,
                               devices=["cpu"])
    with pytest.raises(ValueError):
        overlap.run_overlapped(batches, depth=1, devices=[])
    with pytest.raises(ValueError):
        overlap.run_overlapped([], depth=1, devices=["cpu"])
