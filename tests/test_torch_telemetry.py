"""The port's metrics registry against the JAX package's.

- The declared family table (name, kind, help, label names, buckets) is
  the JAX package's, family for family: 103 families.
- The same seeded increments, applied to fresh registries of both
  packages holding every declared family, render byte-equal Prometheus
  text and equal snapshots.
- ``snapshot_delta`` telescopes under 8 writer threads: the windows'
  deltas add up to the counter's total, nothing lost or counted twice.
- A disabled increment costs under 5 µs (the minimum over repeats, so a
  loaded worker does not fail it).
- An ``ast`` scan: metric families are declared only in ``telemetry.py``
  and span families only in ``tracing.py``; every span name in the port
  names a declared family.
"""

import ast
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from spacedrive_tpu import telemetry as jt
from spacedrive_tpu_torch import telemetry as pt
from spacedrive_tpu_torch import tracing as ptr

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "spacedrive_tpu_torch"


def _table(mod):
    out = {}
    for v in vars(mod).values():
        if isinstance(v, mod._Metric):
            out[v.name] = (v.kind, v.help, tuple(v.labelnames),
                           tuple(getattr(v, "buckets", ()) or ()))
    return out


def test_the_declared_families_are_the_jax_packages():
    mine, theirs = _table(pt), _table(jt)
    assert len(mine) == 103
    assert mine == theirs


def _fresh(mod):
    """A private registry holding every declared family of `mod`."""
    reg = mod.MetricsRegistry()
    fams = {}
    for name, (kind, help, labels, buckets) in sorted(_table(mod).items()):
        if kind == "histogram":
            fams[name] = reg.histogram(name, help, labels, buckets=buckets)
        else:
            fams[name] = getattr(reg, kind)(name, help, labels)
    return reg, fams


def _apply(fams, ops):
    for name, labels, op, v in ops:
        m = fams[name]
        if labels:
            m = m.labels(**labels)
        getattr(m, op)(v)


def _ops(seed: int, table: dict):
    rng = np.random.default_rng(seed)
    names = sorted(table)
    ops = []
    for _ in range(600):
        name = names[int(rng.integers(len(names)))]
        kind, _help, labels, _buckets = table[name]
        lab = {n: f"v{int(rng.integers(3))}" for n in labels}
        if kind == "histogram":
            ops.append((name, lab, "observe", float(rng.exponential(2.0))))
        elif kind == "gauge" and rng.random() < 0.5:
            ops.append((name, lab, "set", float(rng.integers(-5, 50))))
        else:
            ops.append((name, lab, "inc", float(rng.integers(1, 9))))
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_equal_increments_render_byte_equal_prometheus_text(seed):
    table = _table(pt)
    ops = _ops(seed, table)
    (jreg, jfams), (preg, pfams) = _fresh(jt), _fresh(pt)
    _apply(jfams, ops)
    _apply(pfams, ops)
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert preg.snapshot() == jreg.snapshot()
    assert pt.PROMETHEUS_CONTENT_TYPE == jt.PROMETHEUS_CONTENT_TYPE


def test_snapshot_delta_telescopes_under_eight_threads():
    c = pt.Counter("sd_test_telescope_total", "test")
    h = pt.Histogram("sd_test_telescope_seconds", "test", buckets=(0.5, 1, 2))
    start = threading.Barrier(9)

    def writer(k):
        start.wait()
        for i in range(2000):
            c.inc(1 + (i + k) % 3)
            h.observe(((i + k) % 5) * 0.5)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    start.wait()
    cursor, hcur, total, hcount = None, None, 0.0, 0
    while any(t.is_alive() for t in threads):
        d = c.snapshot_delta(cursor)
        total, cursor = total + d["value"], d["cursor"]
        hd = h.snapshot_delta(hcur)
        hcount, hcur = hcount + hd["count"], hd["cursor"]
    for t in threads:
        t.join(10)
    d = c.snapshot_delta(cursor)
    hd = h.snapshot_delta(hcur)
    assert total + d["value"] == c.value == sum(
        1 + (i + k) % 3 for k in range(8) for i in range(2000))
    assert hcount + hd["count"] == 16000


def test_a_disabled_increment_costs_one_flag_check():
    c = pt.Counter("sd_test_disabled_total", "test", ("kind",))
    child = c.labels(kind="x")
    pt.set_enabled(False)
    try:
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(2000):
                child.inc()
            best = min(best, (time.perf_counter() - t0) / 2000)
        assert child.value == 0.0
    finally:
        pt.set_enabled(True)
    assert best < 5e-6, f"a disabled increment took {best * 1e6:.2f} µs"


def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            yield name, node


def _literal_prefix(arg):
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values and isinstance(arg.values[0], ast.Constant):
        return arg.values[0].value
    return None


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_families_and_span_names_are_declared_where_the_jax_package_declares_them(path):
    tree = ast.parse(path.read_text(), str(path))
    rel = path.relative_to(PORT).as_posix()
    for name, node in _calls(tree):
        first = _literal_prefix(node.args[0]) if node.args else None
        if name in ("counter", "gauge", "histogram") and first and first.startswith("sd_"):
            assert rel == "telemetry.py", f"{rel}:{node.lineno} declares {first}"
        if name == "declare_span":
            assert rel == "tracing.py", f"{rel}:{node.lineno} declares a span family"
        if name in ("span", "device_span") and node.args and rel != "tracing.py":
            assert first is not None, f"{rel}:{node.lineno}: a fully dynamic span name"
            family = first.split("/")[0]
            assert family in ptr.SPAN_FAMILIES, f"{rel}:{node.lineno}: span {first!r}"
