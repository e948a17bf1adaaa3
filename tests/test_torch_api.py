"""The port's rspc router against the JAX package's, on the CPU.

- The port mounts every procedure the JAX router mounts, with the same
  kind, library scope and invalidation keys, apart from ``NOT_YET``: the
  observability, crypto and ``files.convertImage`` procedures, each named
  with the port item it waits for, and none of them mounted.
- One scripted sequence in the manner of ``tests/test_api.py``'s
  ``test_full_api_flow`` (libraries, a location scanned, searched, tagged,
  labelled, grouped, renamed; the validator and near-dup jobs; preferences,
  notifications, sync messages, backups, auth) runs through the JAX
  ``mount_router(Node(...))`` and through the port's
  ``mount_router(Node(..., device="cpu"))`` on two copies of one corpus;
  every result must be equal after UUIDs, timestamps, inodes and the
  corpus root are normalised.
- ``debug_init`` seeds a node from one ``init.json`` the same way, and a
  backup made by either package restores in the other.
"""

import asyncio
import json
import os
import re
import shutil
import uuid

import numpy as np
import pytest
import torch

from spacedrive_tpu.api.procedures import register_all as jax_register_all
from spacedrive_tpu.api.router import Router as JaxRouter
from spacedrive_tpu.api.router import mount_router as jax_mount_router
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu_torch.api import procedures
from spacedrive_tpu_torch.api.procedures import NOT_YET, NOT_YET_ROUTES
from spacedrive_tpu_torch.api.router import Router, RpcError, mount_router
from spacedrive_tpu_torch.node import Node


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_router() -> JaxRouter:
    r = JaxRouter(node=None)
    jax_register_all(r)
    return r


def _port_router() -> Router:
    r = Router(node=None)
    procedures.register_all(r)
    return r


JAX = _jax_router()
PORT = _port_router()


def _jax_names():
    return sorted({("procedure", n) for n in JAX.procedures}
                  | {("subscription", n) for n in JAX.subscriptions})


@pytest.mark.parametrize("kind,name", _jax_names(), ids=lambda v: str(v))
def test_each_jax_procedure_is_mounted_alike_or_not_yet(kind, name):
    theirs = (JAX.procedures if kind == "procedure" else JAX.subscriptions)[name]
    mine = (PORT.procedures if kind == "procedure" else PORT.subscriptions).get(name)
    if name in NOT_YET:
        assert mine is None, f"{name} is in NOT_YET but mounted"
        return
    assert mine is not None, f"{name} is neither mounted nor in NOT_YET"
    assert (mine.kind, mine.library_scoped, mine.invalidates) == \
        (theirs.kind, theirs.library_scoped, theirs.invalidates)


def test_the_port_mounts_nothing_the_jax_router_lacks():
    assert set(PORT.procedures) <= set(JAX.procedures)
    assert set(PORT.subscriptions) <= set(JAX.subscriptions)
    assert set(PORT.procedures) | set(PORT.subscriptions) | set(NOT_YET) == \
        set(JAX.procedures) | set(JAX.subscriptions)


def test_not_yet_names_only_observability_crypto_and_convert_image():
    obs = {"node.metrics", "node.spans", "node.trace.export", "node.health", "node.telemetry"}
    for name, item in NOT_YET.items():
        if name in obs or name.split(".")[0] in ("obs", "fleet", "incidents"):
            assert "item 6" in item, name
        elif name.startswith("keys.") or name in ("files.encryptFiles", "files.decryptFiles"):
            assert "item 5" in item, name
        else:
            assert name == "files.convertImage" and "item 11" in item
    assert NOT_YET_ROUTES == {}
    assert {"buildInfo", "nodeState", "toggleFeatureFlag"} <= set(PORT.procedures)


def test_mount_router_refuses_an_invalidation_key_that_names_no_query(monkeypatch, tmp_path):
    register_all = procedures.register_all

    def register(r):
        register_all(r)
        r.mutation("x.bad", invalidates=["no.such.query"])(lambda node, input: None)

    monkeypatch.setattr(procedures, "register_all", register)
    with pytest.raises(RuntimeError, match="invalidates unknown query 'no.such.query'"):
        mount_router(Node(str(tmp_path / "n"), device="cpu"))


# -- the scripted sequence ---------------------------------------------------


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr.astype(np.uint8)).save(path)


def corpus(root: str) -> None:
    """Text, an exact duplicate pair, and PNGs: a near-duplicate pair and an
    unrelated image."""
    rng = np.random.default_rng(5)
    os.makedirs(f"{root}/docs", exist_ok=True)
    os.makedirs(f"{root}/photos", exist_ok=True)
    with open(f"{root}/docs/hello.txt", "wb") as f:
        f.write(b"hello world " * 400)
    blob = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    for name in ("docs/a.bin", "photos/a-copy.bin"):
        with open(f"{root}/{name}", "wb") as f:
            f.write(blob)
    base = np.kron(rng.integers(30, 220, (8, 10, 3)), np.ones((8, 8, 1)))
    _png(f"{root}/photos/grad.png", base)
    _png(f"{root}/photos/grad-edit.png", base + rng.integers(-4, 5, base.shape))
    _png(f"{root}/photos/noise.png", rng.integers(0, 256, (48, 48, 3)))


async def scripted(router, node, root: str) -> list:
    """The calls, in order; each result is recorded under a label."""
    out = []

    async def call(label, path, input=None):
        try:
            res = await router.dispatch(path, input)
        except Exception as e:  # the two routers raise their own RpcError
            res = {"error": type(e).__name__, "code": getattr(e, "code", None)}
        out.append((label, res))
        return res

    events = []
    node.events.subscribe(lambda e: events.append(e))
    await call("buildInfo", "buildInfo")
    await call("nodeState.features", "toggleFeatureFlag", {"feature": "filesOverP2P"})
    lib = await call("library.create", "library.create", {"name": "api-lib"})
    lid = lib["uuid"]
    await call("library.list", "library.list")
    await call("library.edit", "library.edit", {"id": lid, "description": "d"})
    await call("unknown", "nope.nope")
    await call("unscoped", "locations.list", {})
    loc = await call("locations.create", "locations.create",
                     {"library_id": lid, "path": root, "dry_run": True})
    await call("locations.create.overlap", "locations.create",
               {"library_id": lid, "path": f"{root}/docs", "dry_run": True})
    await call("locations.fullRescan", "locations.fullRescan",
               {"library_id": lid, "location_id": loc})
    await node.jobs.wait_idle()
    for path in ("locations.list", "locations.online", "nodes.listLocations",
                 "locations.indexer_rules.list", "tags.list", "labels.list",
                 "categories.list", "search.duplicates", "library.statistics",
                 "search.objectsCount"):
        await call(path, path, {"library_id": lid})
    await call("locations.get", "locations.get", {"library_id": lid, "location_id": loc})
    await call("locations.getWithRules", "locations.getWithRules",
               {"library_id": lid, "location_id": loc})
    await call("rules.listForLocation", "locations.indexer_rules.listForLocation",
               {"library_id": lid, "location_id": loc})
    paths = await call("search.paths", "search.paths", {"library_id": lid})
    await call("search.paths.window", "search.paths",
               {"library_id": lid, "skip": 2, "take": 3,
                "order": {"field": "name", "desc": True}})
    await call("search.paths.filter", "search.paths",
               {"library_id": lid, "filter": {"extension": "PNG"}})
    await call("search.pathsCount", "search.pathsCount",
               {"library_id": lid, "filter": {"is_dir": False}})
    objs = await call("search.objects", "search.objects", {"library_id": lid, "take": 2})
    await call("search.objects.window", "search.objects",
               {"library_id": lid, "skip": 1, "order": {"field": "kind"}})
    by_name = {p["name"]: p for p in paths["items"]}
    hello = by_name["hello"]
    obj = objs["items"][0]["id"]

    tag = await call("tags.create", "tags.create",
                     {"library_id": lid, "name": "important", "color": "#f00"})
    await call("tags.assign", "tags.assign",
               {"library_id": lid, "tag_id": tag["id"], "object_id": obj})
    await call("tags.getForObject", "tags.getForObject", {"library_id": lid, "object_id": obj})
    await call("tags.getWithObjects", "tags.getWithObjects", {"library_id": lid})
    await call("tags.update", "tags.update", {"library_id": lid, "id": tag["id"],
                                              "name": "vital"})
    await call("search.paths.tags", "search.paths",
               {"library_id": lid, "filter": {"tags": [tag["id"]]}})
    label = await call("labels.create", "labels.create", {"library_id": lid, "name": "cat"})
    await call("labels.assign", "labels.assign",
               {"library_id": lid, "label_id": label["id"], "object_id": obj})
    await call("labels.list.after", "labels.list", {"library_id": lid})
    await call("labels.getForObject", "labels.getForObject",
               {"library_id": lid, "object_id": obj})
    for kind in ("spaces", "albums"):
        g = await call(f"{kind}.create", f"{kind}.create", {"library_id": lid, "name": kind})
        await call(f"{kind}.addObjects", f"{kind}.addObjects",
                   {"library_id": lid, "id": g["id"], "object_ids": [obj, 99999]})
        await call(f"{kind}.get", f"{kind}.get", {"library_id": lid, "id": g["id"]})
        await call(f"{kind}.list", f"{kind}.list", {"library_id": lid})
        await call(f"{kind}.removeObjects", f"{kind}.removeObjects",
                   {"library_id": lid, "id": g["id"], "object_ids": [obj]})
        await call(f"{kind}.delete", f"{kind}.delete", {"library_id": lid, "id": g["id"]})
    await call("tags.delete", "tags.delete", {"library_id": lid, "id": tag["id"]})
    await call("labels.delete", "labels.delete", {"library_id": lid, "id": label["id"]})

    await call("files.get", "files.get", {"library_id": lid, "id": hello["object_id"]})
    await call("files.getPath", "files.getPath", {"library_id": lid, "id": hello["id"]})
    await call("files.getMediaData", "files.getMediaData",
               {"library_id": lid, "id": by_name["grad"]["object_id"]})
    await call("files.getConvertableImageExtensions", "files.getConvertableImageExtensions")
    await call("files.setFavorite", "files.setFavorite",
               {"library_id": lid, "id": hello["object_id"], "favorite": True})
    await call("files.setNote", "files.setNote",
               {"library_id": lid, "id": hello["object_id"], "note": "n"})
    await call("files.updateAccessTime", "files.updateAccessTime",
               {"library_id": lid, "ids": [hello["object_id"]]})
    await call("search.objects.favorite", "search.objects",
               {"library_id": lid, "filter": {"favorite": True}})
    await call("files.renameFile", "files.renameFile",
               {"library_id": lid, "file_path_id": hello["id"], "new_name": "renamed.txt"})
    await call("files.renameFile.dir", "files.renameFile",
               {"library_id": lid, "file_path_id": by_name["docs"]["id"],
                "new_name": "papers"})
    await call("files.createFolder", "files.createFolder",
               {"library_id": lid, "location_id": loc, "sub_path": "photos",
                "name": "new"})
    await call("search.paths.after", "search.paths", {"library_id": lid, "take": 500})

    for job, input in (("jobs.objectValidator", {"id": loc}),
                       ("jobs.nearDupDetector", {"id": loc, "threshold": 10})):
        await call(job, job, {"library_id": lid, **input})
        await node.jobs.wait_idle()
    await call("search.nearDuplicates", "search.nearDuplicates",
               {"library_id": lid, "max_distance": 10})
    await call("search.duplicates.after", "search.duplicates", {"library_id": lid})
    await call("checksums", "search.paths",
               {"library_id": lid, "filter": {"extension": "bin"}})
    reports = await router.dispatch("jobs.reports", {"library_id": lid})
    out.append(("jobs.reports", sorted((r["name"], r["status"], r["task_count"],
                                        r["completed_task_count"]) for r in reports)))
    await call("jobs.isActive", "jobs.isActive", {"library_id": lid})
    await call("jobs.clearAll", "jobs.clearAll", {"library_id": lid})
    await call("jobs.reports.after", "jobs.reports", {"library_id": lid})

    await call("preferences.update", "preferences.update",
               {"library_id": lid, "values": {"theme": "dark", "n": [1, 2], "gone": None}})
    await call("preferences.get", "preferences.get", {"library_id": lid})
    await call("notifications.testLibrary", "notifications.testLibrary", {"library_id": lid})
    notes = await call("notifications.get", "notifications.get")
    await call("notifications.dismiss", "notifications.dismiss",
               {"library_id": lid, "id": notes[0]["id"]})
    await call("notifications.dismissAll", "notifications.dismissAll")
    await call("notifications.get.after", "notifications.get")
    msgs = await router.dispatch("sync.messages", {"library_id": lid})
    out.append(("sync.messages", sorted((m["kind"], m["model"]) for m in msgs)))
    await call("nodes.edit", "nodes.edit", {"name": "renamed-node"})
    await call("nodeState", "nodeState")
    await call("auth.me", "auth.me")
    await call("auth.logout", "auth.logout")
    await call("p2p.state", "p2p.state")
    await call("p2p.spacedrop", "p2p.spacedrop", {"addr": "127.0.0.1", "port": 1,
                                                  "file_path": "/x"})
    await call("volumes.list", "volumes.list")
    await call("search.ephemeralPaths", "search.ephemeralPaths", {"path": f"{root}/photos"})
    await call("search.ephemeralPaths.bad", "search.ephemeralPaths", {"path": f"{root}/nope"})
    await call("locations.update", "locations.update",
               {"library_id": lid, "id": loc, "name": "corpus", "indexer_rules_ids": [1, 2]})
    await call("locations.getWithRules.after", "locations.getWithRules",
               {"library_id": lid, "location_id": loc})
    rule = await call("rules.create", "locations.indexer_rules.create",
                      {"library_id": lid, "name": "mine", "rules": [[0, ["*.tmp"]]]})
    await call("rules.get", "locations.indexer_rules.get", {"library_id": lid, "id": rule})
    await call("rules.delete.system", "locations.indexer_rules.delete",
               {"library_id": lid, "id": 1})
    await call("rules.delete", "locations.indexer_rules.delete",
               {"library_id": lid, "id": rule})
    await call("locations.relink", "locations.relink",
               {"library_id": lid, "location_id": loc, "path": f"{root}/photos"})
    await call("locations.delete", "locations.delete", {"library_id": lid, "location_id": loc})
    await call("locations.list.after", "locations.list", {"library_id": lid})
    out.append(("invalidations", sorted({e["key"] for e in events
                                         if e.get("type") == "InvalidateOperation"})))
    return out


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_JOB_ID = re.compile(r"[0-9a-f]{32}")
_OPAQUE = {"pub_id", "instance_id", "uuid", "id_of_node", "object_pub_id", "opub",
           "inode", "instance", "identity", "library_id",
           "total_bytes_available"}  # free space moves between the two runs


def normalise(v, root: str, key: str = ""):
    """UUIDs, pub ids, job ids, inodes and timestamps become placeholders;
    `root` (over the corpus and the data dir) becomes ``<root>``."""
    if isinstance(v, dict):
        return {k: normalise(x, root, k) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [normalise(x, root, key) for x in v]
    if v is None:
        return None
    if key.startswith("date_") or key in ("timestamp", "last_seen", "ts"):
        return "<t>"
    if key in _OPAQUE:
        return "<opaque>"
    if isinstance(v, str):
        if key in ("", "id") and _JOB_ID.fullmatch(v):  # a job's id, the node's
            return "<id>"
        return _UUID.sub("<uuid>", v.replace(root, "<root>"))
    return v


def _run_both(tmp_path, script):
    """`script(router, node, root)` through the JAX node and the port's CPU
    node, each on its own copy of the corpus; returns both normalised."""
    results = []
    for name, make in (("jax", lambda d: JaxNode(d)),
                       ("port", lambda d: Node(d, device="cpu"))):
        root = str(tmp_path / name / "corpus")
        corpus(root)
        node = make(str(tmp_path / name / "data"))
        router = jax_mount_router(node) if name == "jax" else mount_router(node)

        async def main():
            try:
                return await script(router, node, root)
            finally:
                await node.shutdown()
        results.append(normalise(asyncio.run(main()), str(tmp_path / name)))
    return results


def test_scripted_api_flow_gives_the_jax_routers_results(tmp_path):
    theirs, mine = _run_both(tmp_path, scripted)
    assert [label for label, _ in mine] == [label for label, _ in theirs]
    for (label, a), (_, b) in zip(mine, theirs):
        assert a == b, label


def test_rpc_errors_keep_their_codes(tmp_path):
    async def main():
        node = Node(str(tmp_path / "n"), device="cpu")
        router = mount_router(node)
        try:
            with pytest.raises(RpcError) as e:
                await router.dispatch("fleet.health")  # still NOT_YET
            assert e.value.code == "NOT_FOUND"
            with pytest.raises(RpcError) as e:
                await router.dispatch("jobs.progress")
            assert e.value.code == "BAD_REQUEST"
            with pytest.raises(RpcError) as e:
                await router.dispatch("tags.list", {"library_id": str(uuid.uuid4())})
            assert e.value.code == "NOT_FOUND"
            with pytest.raises(RpcError) as e:
                await router.dispatch("library.create", {})
            assert e.value.code == "BAD_REQUEST"
        finally:
            await node.shutdown()
    asyncio.run(main())


def test_debug_init_seeds_one_init_json_as_the_jax_node_does(tmp_path):
    snaps = []
    for name, make in (("jax", JaxNode), ("port", lambda d: Node(d, device="cpu"))):
        root = str(tmp_path / name / "corpus")
        corpus(root)
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        (data / "init.json").write_text(json.dumps({"libraries": [
            {"name": "dev", "locations": [{"path": root}, {"path": f"{root}/missing"}]},
            {"name": "empty", "locations": [{"path": f"{root}/docs", "scan": False}]},
            {"locations": []},
        ]}))

        async def main():
            node = make(str(data))
            errors = []
            node.events.subscribe(lambda e: e.get("type") == "DebugInitError"
                                  and errors.append(e["error"]))
            await node.start()
            await node.jobs.wait_idle()
            from spacedrive_tpu_torch.debug_init import apply_init_file as port_apply
            from spacedrive_tpu.debug_init import apply_init_file as jax_apply
            again = await (jax_apply if name == "jax" else port_apply)(node)
            libs = sorted((lib.config.name, sorted(
                (r["name"], r["path"].replace(root, "<root>"))
                for r in lib.db.query("SELECT name, path FROM location")),
                lib.db.query_one("SELECT COUNT(*) AS n FROM file_path")["n"])
                for lib in node.libraries.list())
            await node.jobs.wait_idle()
            await node.shutdown()
            return libs, again, errors
        snaps.append(asyncio.run(main()))
    assert snaps[0] == snaps[1]
    libs, again, errors = snaps[1]
    assert [name for name, _, _ in libs] == ["dev", "empty"] and again == 1
    assert errors == ["?: 'name'"] * 2  # at start, and on the second apply


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_a_backup_made_by_either_package_restores_in_the_other(tmp_path, maker):
    async def main():
        jnode = JaxNode(str(tmp_path / "jax"))
        pnode = Node(str(tmp_path / "port"), device="cpu")
        jr, pr = jax_mount_router(jnode), mount_router(pnode)
        src_node, src, dst_node, dst = (jnode, jr, pnode, pr) if maker == "jax" \
            else (pnode, pr, jnode, jr)
        try:
            lib = await src.dispatch("library.create", {"name": "bk"})
            lid = lib["uuid"]
            await src.dispatch("tags.create", {"library_id": lid, "name": "keepme"})
            backup_id = await src.dispatch("backups.backup", {"library_id": lid})
            listed = await src.dispatch("backups.getAll")
            assert [b["id"] for b in listed] == [backup_id]
            import zipfile
            with zipfile.ZipFile(listed[0]["path"]) as z:
                assert sorted(z.namelist()) == ["library.db", "library.sdlibrary",
                                                "manifest.json"]
            # the other node finds the zip in its own backups dir
            os.makedirs(os.path.join(dst_node.data_dir, "backups"), exist_ok=True)
            shutil.copy(listed[0]["path"], os.path.join(dst_node.data_dir, "backups"))
            assert await dst.dispatch("backups.restore", {"backup_id": backup_id}) == lid
            assert [t["name"] for t in await dst.dispatch("tags.list", {"library_id": lid})] \
                == ["keepme"]
            assert [x["uuid"] for x in await dst.dispatch("library.list")] == [lid]
            assert await dst.dispatch("backups.delete", {"backup_id": backup_id}) is True
            assert await dst.dispatch("backups.getAll") == []
        finally:
            await jnode.shutdown()
            await pnode.shutdown()
    asyncio.run(main())


def test_auth_device_flow_over_the_subscription(tmp_path):
    async def main():
        node = Node(str(tmp_path / "n"), device="cpu")
        router = mount_router(node)
        frames = []
        try:
            unsub = await router.subscribe("auth.loginSession", {"poll_interval": 0.01},
                                           frames.append)
            start = frames[0]
            assert start["state"] == "Start" and start["user_code"]
            from spacedrive_tpu_torch import auth
            assert auth.issuer_for(node).approve(start["user_code"], "u1", "u@x")
            for _ in range(200):
                if frames[-1]["state"] != "Start":
                    break
                await asyncio.sleep(0.01)
            assert frames[-1] == {"state": "Complete"}
            assert await router.dispatch("auth.me") == {"id": "u1", "email": "u@x"}
            await router.dispatch("auth.logout")
            with pytest.raises(RpcError):
                await router.dispatch("auth.me")
            unsub()
        finally:
            await node.shutdown()
    asyncio.run(main())


async def observability_script(router, node, root):
    """The 9 observability names through one router, on an incident store
    of the node's own (the observatory is process-global in both
    packages), normalised to what the two packages must share."""
    from spacedrive_tpu import flight as jflight
    from spacedrive_tpu import health as jhealth
    from spacedrive_tpu import incidents as jinc
    from spacedrive_tpu import tracing as jtracing
    from spacedrive_tpu_torch import incidents as pinc
    from spacedrive_tpu_torch import tracing as ptracing

    jax = isinstance(node, JaxNode)
    tracing, incidents = (jtracing, jinc) if jax else (ptracing, pinc)
    node.incidents = incidents.IncidentObservatory(
        os.path.join(node.data_dir, "scripted-incidents"), events=node.events,
        node_id="n", node_name="t")
    out = []
    metrics = await router.dispatch("node.metrics")
    out.append(("node.metrics", sorted((name, s["kind"]) for name, s in metrics.items())))
    with tracing.span("rpc/scripted"):
        with tracing.span("job.step", job="scripted", step=1):
            pass
        trace = tracing.current_trace_id()
    spans = await router.dispatch("node.spans", {"trace": trace, "limit": 10})
    out.append(("node.spans", [(s["span"], s["ok"], "parent" in s) for s in spans]))
    doc = await router.dispatch("node.trace.export")
    out.append(("node.trace.export", (jflight.validate_chrome_trace(doc),
                                      "rpc/scripted" in {e.get("name") for e in
                                                         doc["traceEvents"]})))
    snap = await router.dispatch("node.health")
    out.append(("node.health", (jhealth.validate_health_snapshot(snap), sorted(snap["states"]))))
    got = []
    for path in ("node.health", "node.telemetry", "incidents"):
        unsub = await router.subscribe(path, None, got.append)
        node.incidents.observe_give_up("store.busy", 5) if path == "incidents" else None
        unsub()
    out.append(("subscriptions", [e["type"] for e in got]))
    def ids_out(hs):  # a bundle id is its time in hex, then its fingerprint
        return [{**h, "id": h["id"].split("-")[1]} for h in hs]

    headers = await router.dispatch("incidents.list")
    out.append(("incidents.list", ids_out(headers)))
    bundle = await router.dispatch("incidents.get", {"id": headers[0]["id"]})
    out.append(("incidents.get", (jinc.validate_incident_bundle(bundle), sorted(bundle))))
    out.append(("incidents.ack", await router.dispatch("incidents.ack", {"id": headers[0]["id"]})))
    out.append(("incidents.list acked",
                ids_out(await router.dispatch("incidents.list", {"limit": 1}))))
    node.incidents.close()
    return out


def test_the_observability_procedures_give_the_jax_routers_results(tmp_path):
    theirs, mine = _run_both(tmp_path, observability_script)
    assert [label for label, _ in mine] == [label for label, _ in theirs]
    for (label, a), (_, b) in zip(mine, theirs):
        assert a == b, label
    got = dict(mine)
    assert len(got["node.metrics"]) == 103
    assert got["node.spans"] == [["job.step", True, True], ["rpc/scripted", True, False]]
    assert got["node.trace.export"] == [[], True]
    assert got["subscriptions"] == ["HealthSnapshot", "TelemetrySnapshot", "Incident"]
    assert got["incidents.ack"] == {"acked": True}


def test_metrics_route_serves_the_prometheus_text(tmp_path):
    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.api.server import ApiServer

    async def main():
        node = Node(str(tmp_path / "n"), device="cpu")
        server = ApiServer(node)
        port = await server.start("127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10)
            writer.close()
        finally:
            await server.stop()
            await node.shutdown()
        head, _, body = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        assert f"Content-Type: {telemetry.PROMETHEUS_CONTENT_TYPE}".encode() in head
        text = body.decode()
        assert "# TYPE sd_api_requests_total counter" in text
        assert 'sd_api_requests_total{route="/metrics"}' in text
    asyncio.run(main())
