"""The port's incident observatory against the JAX package's.

- The 7 declared triggers are the JAX package's.
- A give-up of a declared backoff ladder (``store.busy`` exhausted by a
  ``store.commit`` chaos fault) yields one bundle through the observer
  hook; both packages' validators accept its header and its body; a
  repeat inside the window is deduplicated.
- The state carries across: bundles written by a JAX observatory are
  recovered, listed, read and acknowledged by the port's on the same
  ``incidents/`` directory, and the reverse.
- Crash recovery: a child process that boots an observatory and dies
  without closing it leaves the ``.running`` marker; the next boot turns
  it into a ``crash`` bundle (the child runs under a time limit).
"""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest

from spacedrive_tpu import incidents as ji
from spacedrive_tpu_torch import chaos, timeouts
from spacedrive_tpu_torch import incidents as pi
from spacedrive_tpu_torch.store.db import Database

ROOT = Path(__file__).resolve().parent.parent


def test_the_triggers_are_the_jax_packages():
    assert sorted(pi.TRIGGERS) == sorted(ji.TRIGGERS) and len(pi.TRIGGERS) == 7
    assert pi.BUNDLE_SCHEMA == ji.BUNDLE_SCHEMA


def test_a_backoff_give_up_freezes_one_valid_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_TIMEOUT_SCALE", "0.01")
    obs = pi.IncidentObservatory(str(tmp_path / "incidents"), node_id="ab", node_name="port")
    timeouts.set_give_up_observer(obs.observe_give_up)
    db = Database(str(tmp_path / "lib.db"))
    try:
        for _ in range(2):  # the second give-up falls in the dedup window
            chaos.arm("store.commit=error:1.0", seed=3)
            try:
                with pytest.raises(sqlite3.OperationalError, match="locked"):
                    with db.tx() as conn:
                        conn.execute("CREATE TABLE IF NOT EXISTS t (x)")
            finally:
                chaos.disarm()
        [header] = obs.list()
        assert header["trigger"]["kind"] == "backoff.give_up"
        assert header["trigger"]["resource"] == "store.busy"
        assert pi.validate_incident_header(header) == ji.validate_incident_header(header) == []
        bundle = obs.get(header["id"])
        assert pi.validate_incident_bundle(bundle) == ji.validate_incident_bundle(bundle) == []
        assert obs.ack(header["id"]) and obs.list()[0]["ack"] is True
    finally:
        timeouts.set_give_up_observer(None)
        obs.close()
        db.close()


def _fire_three(obs):
    obs.observe_give_up("store.busy", 5)
    obs.observe_give_up("p2p.announce.reconnect", 6)
    obs.observe_violation("task_orphaned", "sdtpu:node#1/x survived the reap")


@pytest.mark.parametrize("writer,reader", [(ji, pi), (pi, ji)],
                         ids=["jax-to-port", "port-to-jax"])
def test_an_incidents_directory_carries_across_the_packages(tmp_path, writer, reader):
    d = str(tmp_path / "incidents")
    w = writer.IncidentObservatory(d, node_id="n1", node_name="writer")
    _fire_three(w)
    written = w.list()
    w.close()
    r = reader.IncidentObservatory(d, node_id="n2", node_name="reader")
    try:
        got = r.list()
        assert [h["id"] for h in got] == [h["id"] for h in written]
        assert [h["trigger"]["kind"] for h in got] == [
            "task.orphaned", "backoff.give_up", "backoff.give_up"]
        for h in got:
            assert reader.validate_incident_header(h) == []
            assert writer.validate_incident_bundle(r.get(h["id"])) == []
        assert r.ack(got[0]["id"])
    finally:
        r.close()
    again = writer.IncidentObservatory(d, node_id="n1", node_name="writer")
    try:
        assert [h["ack"] for h in again.list()] == [True, False, False]
    finally:
        again.close()


CHILD = """
import os, sys
sys.path.insert(0, {root!r})
from spacedrive_tpu_torch import incidents
obs = incidents.IncidentObservatory({d!r}, node_id="c", node_name="child")
obs.observe_give_up("store.busy", 5)
os._exit(0)  # no close(): the marker survives, as after a crash
"""


def test_a_crash_marker_becomes_a_crash_bundle_at_the_next_boot(tmp_path):
    d = str(tmp_path / "incidents")
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT), d=d)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(os.path.join(d, ".running"))
    obs = pi.IncidentObservatory(d, node_id="p", node_name="parent")
    try:
        kinds = [h["trigger"]["kind"] for h in obs.list()]
        assert kinds == ["crash", "backoff.give_up"]
        crash = obs.get(obs.list()[0]["id"])
        assert pi.validate_incident_bundle(crash) == ji.validate_incident_bundle(crash) == []
    finally:
        obs.close()
    assert not os.path.exists(os.path.join(d, ".running"))
