"""The port's node, library manager, budgets and op factory against the
JAX package's: one ``node_state.sdconfig`` and one library directory serve
either package; the library manager's load, edit and delete hooks; the
orphan remover's deletes and ops; ``with_timeout`` / ``deadline`` /
``with_backoff`` under their declared budgets; the op factory's ops."""

import asyncio
import json
import os

import pytest

from spacedrive_tpu import node as jax_node
from spacedrive_tpu import library as jax_library
from spacedrive_tpu import timeouts as jax_timeouts
from spacedrive_tpu.store import db as jax_db
from spacedrive_tpu.sync import manager as jax_manager
from spacedrive_tpu_torch import library, node, timeouts
from spacedrive_tpu_torch.store import db as port_db
from spacedrive_tpu_torch.sync import manager as port_manager


def test_one_node_config_file_serves_either_package(tmp_path):
    path = str(tmp_path / node.NODE_CONFIG_NAME)
    made = jax_node.NodeConfig(path)
    read = node.NodeConfig(path)
    assert (read.id, read.name) == (made.id, made.name)
    os.remove(path)
    made = node.NodeConfig(path)
    with open(path) as f:
        assert json.load(f) == made.raw
    again = jax_node.NodeConfig(path)
    assert (again.id, again.name, again.raw["version"]) == (made.id, made.name, 1)
    with open(path, "w") as f:
        json.dump({"version": 9}, f)
    with pytest.raises(ValueError):
        node.NodeConfig(path)
    assert node.migrate_node_config({"name": "x"})["name"] == "x"


def test_a_library_directory_serves_either_package(tmp_path):
    data = str(tmp_path)
    jax_libs = jax_library.Libraries(data)
    made = jax_libs.create("from-jax", node_name="n")
    made.db.close()
    port_libs = library.Libraries(data)
    events = []
    port_libs.on_event(lambda kind, lib: events.append((kind, lib.config.name)))
    port_libs.init()
    lib = port_libs.get(made.id)
    assert lib.config.name == "from-jax" and lib.instance_pub_id == made.instance_pub_id
    assert lib.sync.instance == made.sync.instance
    mine = port_libs.create("from-port")
    assert {x.config.name for x in port_libs.list()} == {"from-jax", "from-port"}
    port_libs.edit(mine.id, name="renamed", description="d")
    for x in port_libs.list():
        x.db.close()
    again = jax_library.Libraries(data)
    again.init()
    assert again.get(mine.id).config.name == "renamed"
    assert again.get(mine.id).config.description == "d"
    for x in again.list():
        x.db.close()
    port_libs = library.Libraries(data)
    port_libs.on_event(lambda kind, lib: events.append((kind, lib.config.name)))
    port_libs.init()
    port_libs.delete(mine.id)
    assert not any(n.startswith(str(mine.id)) for n in os.listdir(port_libs.dir))
    with pytest.raises(KeyError):
        port_libs.delete(mine.id)
    assert events[:3] == [("load", "from-jax"), ("load", "from-port"), ("edit", "renamed")]
    # init loads in file-name (uuid) order
    assert sorted(events[3:5]) == [("load", "from-jax"), ("load", "renamed")]
    assert events[5:] == [("delete", "renamed")]
    for x in port_libs.list():
        x.db.close()


def test_the_orphan_remover_deletes_as_the_jax_one(tmp_path):
    """Objects no file_path references go, with their tag links, each with
    a shared delete op; the JAX remover on a copy of the file agrees."""
    libs = library.Libraries(str(tmp_path / "port"))
    lib = libs.create("orphans")
    kept, orphan, tag = os.urandom(16), os.urandom(16), os.urandom(16)
    with lib.db.write_tx() as conn:
        for pub in (kept, orphan):
            conn.execute("INSERT INTO object (pub_id, kind) VALUES (?, 5)", (pub,))
        conn.execute("INSERT INTO tag (pub_id, name) VALUES (?, 't')", (tag,))
        conn.execute("INSERT INTO file_path (pub_id, name, object_id) VALUES "
                     "(?, 'f', (SELECT id FROM object WHERE pub_id = ?))", (os.urandom(16), kept))
        conn.execute("INSERT INTO tag_on_object (tag_id, object_id) VALUES "
                     "((SELECT id FROM tag WHERE pub_id = ?), "
                     "(SELECT id FROM object WHERE pub_id = ?))", (tag, orphan))
    lib.db.close()
    import shutil
    shutil.copytree(str(tmp_path / "port"), str(tmp_path / "jax"))
    counts = []
    for make_libs, make_remover in ((library.Libraries, node.OrphanRemover),
                                    (jax_library.Libraries, jax_node.OrphanRemover)):
        libs = make_libs(str(tmp_path / ("port" if make_libs is library.Libraries else "jax")))
        libs.init()
        [lib] = libs.list()
        counts.append(make_remover(lib).invoke())
        counts.append([bytes(r[0]) for r in lib.db.query("SELECT pub_id FROM object")])
        counts.append(lib.db.query_one("SELECT COUNT(*) FROM tag_on_object")[0])
        counts.append([(r["model"], r["kind"]) for r in lib.db.query(
            "SELECT model, kind FROM shared_operation")])
        lib.db.close()
    assert counts[:4] == counts[4:]
    assert counts[:4] == [1, [kept], 0, [("object", "d")]]


def test_budgets_are_the_jax_defaults_and_scale(monkeypatch):
    for name, c in timeouts.TIMEOUTS.items():
        assert jax_timeouts.TIMEOUTS[name].default_s == c.default_s, name
    jc, pc = jax_timeouts.BACKOFFS["p2p.announce.reconnect"], \
        timeouts.BACKOFFS["p2p.announce.reconnect"]
    assert (jc.base_s, jc.cap_s, jc.factor, jc.jitter, jc.max_tries) == \
        (pc.base_s, pc.cap_s, pc.factor, pc.jitter, pc.max_tries)
    monkeypatch.setenv("SDTPU_TIMEOUT_SCALE", "0.001")
    assert timeouts.budget("p2p.ping") == pytest.approx(0.02)
    with pytest.raises(KeyError):
        timeouts.budget("no.such.budget")

    async def main():
        with pytest.raises(asyncio.TimeoutError):
            await timeouts.with_timeout("p2p.ping", asyncio.sleep(10))
        with pytest.raises(TimeoutError):
            async with timeouts.deadline("p2p.ping"):
                await asyncio.sleep(10)
        tries = []

        async def flaky():
            tries.append(1)
            if len(tries) < 3:
                raise ConnectionError("down")
            return "up"
        assert await timeouts.with_backoff("p2p.announce.reconnect", flaky) == "up"
        assert len(tries) == 3

        async def dead():
            raise ConnectionError("down")
        with pytest.raises(ConnectionError):
            await timeouts.with_backoff("p2p.announce.reconnect", dead)
    asyncio.run(main())
    sched = timeouts.RetrySchedule("p2p.announce.reconnect")
    assert sched.allowed("peer", now=0.0)
    delays = [sched.failure("peer", now=0.0) for _ in range(7)]
    assert all(d is not None for d in delays[:6]) and delays[6] is None
    assert not sched.allowed("peer", now=0.0)
    sched.success("peer")
    assert sched.allowed("peer", now=0.0)


def _factory_ops(module, db_module, path):
    db = db_module.Database(str(path))
    db.insert("instance", {"pub_id": b"I" * 16, "identity": b"", "node_id": b"",
                           "node_name": "t", "node_platform": 0, "last_seen": 0,
                           "date_created": 0})
    m = module.SyncManager(db, b"I" * 16)
    ops = (m.shared_create("tag", b"T" * 16, {"name": "t"})
           + [m.shared_update("tag", b"T" * 16, "color", "#fff"),
              m.shared_multi_update("object", b"O" * 16, {"kind": 5, "note": "n"}),
              m.shared_delete("tag", b"T" * 16)]
           + m.relation_create("tag_on_object", b"O" * 16, b"T" * 16, {"date_created": 1})
           + [m.relation_update("tag_on_object", b"O" * 16, b"T" * 16, "date_created", 2),
              m.relation_delete("tag_on_object", b"O" * 16, b"T" * 16)])
    with m.write_ops(ops):
        pass
    out = [(o.typ.kind, {k: v for k, v in o.to_wire().items() if k not in ("id", "timestamp")})
           for o in ops]
    log = [(r["model"], r["kind"]) for r in db.query(
        "SELECT model, kind FROM shared_operation ORDER BY id")] + \
        [(r["relation"], r["kind"]) for r in db.query(
            "SELECT relation, kind FROM relation_operation ORDER BY id")]
    applied = m.receive_crdt_operation(type(ops[0]).from_wire(dict(
        ops[0].to_wire(), instance=b"R" * 16, timestamp=ops[-1].timestamp + 1)))
    db.close()
    return out, log, applied


def test_the_op_factory_builds_the_jax_ops(tmp_path):
    assert _factory_ops(port_manager, port_db, tmp_path / "p.db") == \
        _factory_ops(jax_manager, jax_db, tmp_path / "j.db")
