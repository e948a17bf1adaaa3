"""The port's tracing against the JAX package's.

- The same nested spans in both packages give the same span tree: names,
  fields, ok/error, parent links and one trace id a root, equal after
  normalising ids and times; both rings keep the newest records.
- A traceparent rendered by either package parses in the other, and
  ``continue_trace`` of it parents the receiver's span on the sender's.
- ``JsonLogFormatter`` emits the same keys in both, the trace and span
  of the current span included; the log ring's tail holds them.
- ``device_span`` with ``SDTPU_PROFILE`` set writes, on the CPU, a Chrome
  trace holding the span's name (in a child process: the profiler is
  process-wide).
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest

from spacedrive_tpu import tracing as jtr
from spacedrive_tpu_torch import tracing as ptr

ROOT = Path(__file__).resolve().parent.parent


def _tree(mod, seed: int):
    """Nested spans in one package; the records of this run, normalised:
    ids become their order of appearance, times are dropped."""
    mod.clear_span_ring()
    with mod.span("job/identifier", job_id=f"j{seed}"):
        for step in range(2 + seed):
            with mod.span("job.step", job="identifier", step=step):
                with mod.device_span("cas_ids/cuda", batch=16 * step):
                    pass
        try:
            with mod.span("rpc/tags.create"):
                raise KeyError("x")
        except KeyError:
            pass
    with mod.span("sync.serve", library="L"):
        pass
    recs = mod.recent_spans(limit=512)
    ids = {}

    def norm(v):
        return ids.setdefault(v, len(ids)) if v is not None else None

    out = []
    for r in recs:
        r = dict(r)
        for key in ("ms", "ts_us"):
            assert isinstance(r.pop(key), (int, float))
        r["trace"], r["id"] = norm(r["trace"]), norm(r["id"])
        r["parent"] = norm(r.get("parent"))
        out.append(r)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_the_same_spans_give_the_same_tree(seed):
    mine, theirs = _tree(ptr, seed), _tree(jtr, seed)
    assert mine == theirs
    assert [r["span"] for r in mine][-1] == "sync.serve"
    assert sum(r["ok"] is False for r in mine) == 1


def test_the_span_families_are_the_jax_packages():
    assert sorted(ptr.SPAN_FAMILIES) == sorted(jtr.SPAN_FAMILIES) == [
        "cas_ids", "fleet", "job", "job.step", "p2p", "pipeline.run", "rpc",
        "sync.pull", "sync.serve"]


@pytest.mark.parametrize("sender,receiver", [(ptr, jtr), (jtr, ptr)],
                         ids=["port-to-jax", "jax-to-port"])
def test_a_traceparent_crosses_between_the_packages(sender, receiver):
    with sender.span("p2p/ping"):
        tp = sender.traceparent()
        trace, span_id = sender.current_trace()
    assert receiver.parse_traceparent(tp) == sender.parse_traceparent(tp) == (trace, span_id)
    receiver.clear_span_ring()
    with receiver.continue_trace(tp):
        with receiver.span("p2p/ping"):
            pass
    [rec] = receiver.recent_spans(limit=1)
    assert (rec["trace"], rec["parent"]) == (f"{trace:x}", f"{span_id:x}")
    for bad in (None, "", "zz-1", "0-1", "1", 7, f"{1 << 64:x}-1"):
        assert ptr.parse_traceparent(bad) == jtr.parse_traceparent(bad) is None


def _formatted(mod):
    rec = logging.LogRecord("spacedrive_tpu_torch.x", logging.WARNING, __file__, 1,
                            "hello %s", ("world",), None)
    with mod.span("rpc/x"):
        doc = json.loads(mod.JsonLogFormatter().format(rec))
        cur = mod.current_trace()
    return doc, cur


def test_json_log_records_carry_the_same_keys():
    (mine, cur), (theirs, _) = _formatted(ptr), _formatted(jtr)
    assert sorted(mine) == sorted(theirs)
    assert (mine["trace"], mine["span"]) == (f"{cur[0]:x}", f"{cur[1]:x}")
    assert mine["msg"] == theirs["msg"] == "hello world"


def test_the_log_ring_keeps_a_trace_stamped_tail():
    ptr.uninstall_log_ring()
    assert ptr.install_log_ring(force=True)
    try:
        log = logging.getLogger("spacedrive_tpu_torch.test")
        with ptr.span("rpc/x"):
            log.warning("one %d", 1)
            cur = ptr.current_trace()
        tail = ptr.log_ring_tail(5)
        assert tail[-1]["msg"] == "one 1" and tail[-1]["trace"] == f"{cur[0]:x}"
    finally:
        ptr.uninstall_log_ring()


CHILD = """
import sys
sys.path.insert(0, {root!r})
from spacedrive_tpu_torch import tracing
import torch
with tracing.device_span("cas_ids/cpu", batch=3):
    torch.ones(8).sum()
print(tracing.stop_profiler())
"""


def test_device_span_writes_a_chrome_trace_with_its_name(tmp_path):
    env = {**os.environ, "SDTPU_PROFILE": str(tmp_path / "prof")}
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    path = Path(proc.stdout.strip().splitlines()[-1])
    assert path.parent == tmp_path / "prof"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "cas_ids/cpu" in names
