"""Every API procedure, namespace by namespace.

Port of ``spacedrive_tpu/api/procedures.py`` (upstream core/src/api/*.rs,
plus the net-new ``search.duplicates`` / ``search.nearDuplicates`` /
``jobs.nearDupDetector`` over the device dedup analytics). The port mounts
every procedure the JAX router mounts and gives the same results, apart
from ``NOT_YET``: the procedures (and the one route) that wait for a later
port item, each mapped to that item. They are not mounted, so a client
asking for one gets ``NOT_FOUND``.

The node's device decides where the card's work runs: a scan, a rescan,
``jobs.identifyUniqueFiles``, ``jobs.objectValidator``,
``jobs.nearDupDetector`` and ``search.ephemeralPaths`` run their kernels on
the card for ``Node(device="cuda")`` and the plain versions for
``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid as uuidlib
from typing import Any, Dict

from .. import _msgpack
from .. import backups as backups_mod
from .. import tasks, telemetry, tracing
from ..jobs.report import JobStatus
from ..library import Library
from ..locations import manager as loc_manager
from ..locations.non_indexed import walk_ephemeral
from ..locations.paths import IsolatedPath
from ..locations.rules import IndexerRule, RuleKind, RulePerKind
from ..media.exif import extract_media_data
from ..store.db import uuid_bytes
from ..volume import get_volumes
from .router import Router, RpcError
from .serialization import row_to_dict, rows_to_dicts

BUILD_VERSION = "0.1.0"

_OBSERVABILITY = ("ROADMAP queue A item 6, its second half (fleet.py, p2p/obs.py: "
                  "the obs and fleet observatories)")
_CRYPTO = "ROADMAP queue A item 5, its crypto half (crypto/, objects/crypto_ops.py)"
_ENCODERS = "ROADMAP queue A item 11 (JPEG, GIF and TIFF encoders)"

# The JAX router's procedures this router does not mount yet, each with
# the port item it waits for. A name covers both kinds where the JAX router
# has a query and a subscription under it (fleet.health).
NOT_YET: Dict[str, str] = {
    **{name: _OBSERVABILITY for name in (
        "obs.metrics", "obs.health", "obs.trace", "obs.incidents",
        "fleet.health", "fleet.metrics", "fleet.trace.export")},
    **{f"keys.{name}": _CRYPTO for name in (
        "isUnlocked", "isSetup", "setup", "unlock", "lock", "list", "add",
        "mount", "unmount", "delete")},
    "files.encryptFiles": _CRYPTO,
    "files.decryptFiles": _CRYPTO,
    "files.convertImage": _ENCODERS,
}

# The JAX server's routes this server does not serve yet.
NOT_YET_ROUTES: Dict[str, str] = {}


def _json_safe(v: Any) -> Any:
    """Make an arbitrary extraction structure JSON-encodable: hex bytes
    at any depth, recurse containers, stringify anything else non-JSON
    (e.g. EXIF IFDRational)."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_json_safe(x) for x in v]
    return str(v)


def register_all(router: Router) -> None:
    _core(router)
    _incidents(router)
    _libraries(router)
    _volumes(router)
    _tags(router)
    _labels(router)
    _spaces(router)
    _albums(router)
    _categories(router)
    _locations(router)
    _files(router)
    _jobs(router)
    _search(router)
    _sync(router)
    _preferences(router)
    _notifications(router)
    _nodes(router)
    _auth(router)
    _backups(router)
    _p2p(router)
    _invalidation(router)


# -- unscoped core (api/mod.rs buildInfo/nodeState/toggleFeatureFlag) ------

def _core(r: Router) -> None:
    @r.query("buildInfo")
    def build_info(node, _input):
        return {"version": BUILD_VERSION, "commit": "unknown"}

    @r.query("nodeState")
    def node_state(node, _input):
        return {
            "id": node.config.id.hex(),
            "name": node.config.name,
            "data_path": node.data_dir,
            "features": node.config.features,
        }

    @r.mutation("toggleFeatureFlag")
    def toggle_feature(node, input):
        return node.config.toggle_feature(str(input["feature"]))

    @r.query("node.metrics")
    def node_metrics(node, _input):
        """The node-wide telemetry registry as one JSON-safe snapshot: the
        rspc face of GET /metrics (same counters, same instant)."""
        return telemetry.snapshot()

    @r.query("node.spans")
    def node_spans(node, input):
        """Recent finished spans from the tracing ring, newest last;
        optional {limit, trace} filters."""
        input = input or {}
        return tracing.recent_spans(limit=int(input.get("limit", 100)),
                                    trace_id=input.get("trace"))

    @r.query("node.trace.export")
    async def node_trace_export(node, input):
        """The flight-recorder export: span ring + pipeline timeline as one
        schema-valid Chrome-trace document (flight.py), built off the loop
        (a full ring is thousands of events to copy and sort)."""
        from .. import flight

        del input
        return await asyncio.to_thread(flight.chrome_trace, node_name=node.config.name)

    @r.query("node.health")
    def node_health(node, _input):
        """The health observatory's latest snapshot (health.py): states by
        subsystem with bottleneck attribution. Served from the sampler's
        cache; computed fresh when the sampler has not run within ~2
        intervals."""
        return node.health.snapshot()

    @r.subscription("node.health")
    def node_health_sub(node, _input, emit):
        """Every HealthSnapshot the sampler emits, plus one at once."""
        def on_event(e):
            if e.get("type") == "HealthSnapshot":
                emit(e)
        unsub = node.events.subscribe(on_event)
        node.health.emit_snapshot()  # after subscribing: this client sees it
        return unsub

    @r.subscription("node.telemetry")
    def node_telemetry(node, _input, emit):
        """The TelemetryReporter's periodic TelemetrySnapshot events, plus
        one at once."""
        def on_event(e):
            if e.get("type") == "TelemetrySnapshot":
                emit(e)
        unsub = node.events.subscribe(on_event)
        node.telemetry_reporter.emit_snapshot()
        return unsub


# -- incidents. (incidents.py) -----------------------------------------------

def _incidents(r: Router) -> None:
    """List bundle headers, pull one bundle, acknowledge it, and stream new
    incidents. All four degrade cleanly when SDTPU_INCIDENTS=off (an empty
    list, NOT_FOUND, a stream of nothing)."""

    def _obs(node):
        from .. import incidents

        return getattr(node, "incidents", None) or incidents.current()

    @r.query("incidents.list")
    def incidents_list(node, input):
        """Bundle headers newest first, optional {limit}."""
        obs = _obs(node)
        if obs is None:
            return []
        return obs.list(limit=int((input or {}).get("limit", 0)))

    @r.query("incidents.get")
    def incidents_get(node, input):
        """One whole evidence bundle by {id} (read from disk)."""
        obs = _obs(node)
        bundle = obs.get(str((input or {}).get("id", ""))) if obs is not None else None
        if bundle is None:
            raise RpcError("NOT_FOUND", "no such incident bundle")
        return bundle

    @r.mutation("incidents.ack")
    def incidents_ack(node, input):
        """Mark a bundle triaged: {id} → {acked: bool}."""
        obs = _obs(node)
        acked = obs.ack(str((input or {}).get("id", ""))) if obs is not None else False
        return {"acked": acked}

    @r.subscription("incidents")
    def incidents_sub(node, _input, emit):
        """Each Incident event (the new bundle's header) as the observatory
        freezes it; incidents.list is the paint-in query."""
        def on_event(e):
            if e.get("type") == "Incident":
                emit(e)
        return node.events.subscribe(on_event)


# -- library. (api/libraries.rs) -------------------------------------------

def _libraries(r: Router) -> None:
    def _lib_info(lib: Library) -> Dict[str, Any]:
        return {"uuid": str(lib.id), "config": lib.config.to_json()}

    @r.query("library.list")
    def lib_list(node, _input):
        return [_lib_info(lib) for lib in node.libraries.list()]

    @r.mutation("library.create", invalidates=["library.list"])
    def lib_create(node, input):
        lib = node.create_library(str(input["name"]))
        return _lib_info(lib)

    @r.mutation("library.edit", invalidates=["library.list"])
    def lib_edit(node, input):
        lib = node.libraries.edit(
            uuidlib.UUID(str(input["id"])),
            name=input.get("name"), description=input.get("description"))
        return _lib_info(lib)

    @r.mutation("library.delete", invalidates=["library.list"])
    def lib_delete(node, input):
        node.libraries.delete(uuidlib.UUID(str(input["id"])))
        return None

    @r.query("library.statistics", library=True)
    def lib_statistics(node, library, _input):
        return library.statistics()


# -- volumes. --------------------------------------------------------------

def _volumes(r: Router) -> None:
    @r.query("volumes.list")
    def volumes_list(node, _input):
        return get_volumes()


# -- tags. (api/tags.rs) ---------------------------------------------------

def _tags(r: Router) -> None:
    @r.query("tags.list", library=True)
    def tags_list(node, library, _input):
        return rows_to_dicts(library.db.run("api.tag.all"))

    @r.query("tags.get", library=True)
    def tags_get(node, library, input):
        row = library.db.run("api.tag.by_id", (int(input["id"]),))
        return row_to_dict(row) if row else None

    @r.query("tags.getForObject", library=True)
    def tags_for_object(node, library, input):
        return rows_to_dicts(library.db.run(
            "api.tag.for_object", (int(input["object_id"]),)))

    @r.query("tags.getWithObjects", library=True)
    def tags_with_objects(node, library, input):
        tags = rows_to_dicts(library.db.run("api.tag.all"))
        for t in tags:
            t["object_ids"] = [
                row["object_id"] for row in library.db.run(
                    "api.tag.object_ids", (t["id"],))
            ]
        return tags

    @r.mutation("tags.create", library=True, invalidates=["tags.list"])
    def tags_create(node, library, input):
        pub_id = uuid_bytes()
        sync = library.sync
        values = {"name": str(input["name"]),
                  "color": input.get("color"),
                  "date_created": int(time.time())}
        with sync.write_ops(
                sync.shared_create("tag", pub_id, values)) as conn:
            tag_id = library.db.insert(
                "tag", {"pub_id": pub_id, **values}, conn=conn)
        return {"id": tag_id, "pub_id": pub_id.hex(), **values}

    @r.mutation("tags.update", library=True, invalidates=["tags.list"])
    def tags_update(node, library, input):
        tag = library.db.run("api.tag.by_id", (int(input["id"]),))
        if tag is None:
            raise RpcError("NOT_FOUND", "no such tag")
        sync = library.sync
        values = {k: input[k] for k in ("name", "color") if k in input}
        ops = [sync.shared_update("tag", tag["pub_id"], k, v)
               for k, v in values.items()]
        with sync.write_ops(ops) as conn:
            library.db.update("tag", tag["id"], values, conn=conn)
        return None

    @r.mutation("tags.delete", library=True, invalidates=["tags.list"])
    def tags_delete(node, library, input):
        tag = library.db.run("api.tag.by_id", (int(input["id"]),))
        if tag is None:
            return None
        sync = library.sync
        # relation deletes FIRST (earlier HLC stamps): a peer holding
        # assignments must clear them before the row delete or its
        # FK constraint rejects the op forever (sync divergence).
        assigned = library.db.run("api.tag.assigned_objects",
                                  (tag["id"],))
        ops = [sync.relation_delete("tag_on_object", r["opub"],
                                    tag["pub_id"]) for r in assigned]
        ops.append(sync.shared_delete("tag", tag["pub_id"]))
        with sync.write_ops(ops) as conn:
            library.db.run("api.tag.clear_assignments", (tag["id"],),
                           conn=conn)
            library.db.delete("tag", tag["id"], conn=conn)
        return None

    @r.mutation("tags.assign", library=True,
                invalidates=["tags.getForObject"])
    def tags_assign(node, library, input):
        tag = library.db.run("api.tag.by_id", (int(input["tag_id"]),))
        obj = library.db.run("api.object.by_id",
                             (int(input["object_id"]),))
        if tag is None or obj is None:
            raise RpcError("NOT_FOUND", "tag or object missing")
        sync = library.sync
        if input.get("unassign"):
            ops = [sync.relation_delete(
                "tag_on_object", obj["pub_id"], tag["pub_id"])]
            with sync.write_ops(ops) as conn:
                library.db.run("api.tag.unassign",
                               (tag["id"], obj["id"]), conn=conn)
        else:
            ops = sync.relation_create(
                "tag_on_object", obj["pub_id"], tag["pub_id"])
            with sync.write_ops(ops) as conn:
                library.db.run("api.tag.assign",
                               (tag["id"], obj["id"]), conn=conn)
        return None


# -- labels. (schema.prisma:362-385 Label/LabelOnObject — the model the
#    reference ships without an API; CRUD + assignment mirror tags.) -------

def _labels(r: Router) -> None:
    @r.query("labels.list", library=True)
    def labels_list(node, library, _input):
        return rows_to_dicts(library.db.run(
            "api.label.list_with_counts"))

    @r.query("labels.getForObject", library=True)
    def labels_for_object(node, library, input):
        return rows_to_dicts(library.db.run(
            "api.label.for_object", (int(input["object_id"]),)))

    @r.mutation("labels.create", library=True, invalidates=["labels.list"])
    def labels_create(node, library, input):
        pub_id = uuid_bytes()
        sync = library.sync
        values = {"name": str(input["name"]),
                  "date_created": int(time.time())}
        with sync.write_ops(
                sync.shared_create("label", pub_id, values)) as conn:
            label_id = library.db.insert(
                "label", {"pub_id": pub_id, **values}, conn=conn)
        return {"id": label_id, "pub_id": pub_id.hex(), **values}

    @r.mutation("labels.assign", library=True,
                invalidates=["labels.list", "labels.getForObject"])
    def labels_assign(node, library, input):
        lb = library.db.run("api.label.by_id",
                            (int(input["label_id"]),))
        obj = library.db.run("api.object.by_id",
                             (int(input["object_id"]),))
        if lb is None or obj is None:
            raise RpcError("NOT_FOUND", "label or object missing")
        sync = library.sync
        if input.get("unassign"):
            ops = [sync.relation_delete(
                "label_on_object", obj["pub_id"], lb["pub_id"])]
            with sync.write_ops(ops) as conn:
                library.db.run("api.label.unassign",
                               (lb["id"], obj["id"]), conn=conn)
        else:
            ops = sync.relation_create(
                "label_on_object", obj["pub_id"], lb["pub_id"],
                {"date_created": int(time.time())})
            with sync.write_ops(ops) as conn:
                library.db.run(
                    "api.label.assign",
                    (lb["id"], obj["id"], int(time.time())), conn=conn)
        return None

    @r.mutation("labels.delete", library=True, invalidates=["labels.list"])
    def labels_delete(node, library, input):
        lb = library.db.run("api.label.by_id", (int(input["id"]),))
        if lb is None:
            return None
        sync = library.sync
        # relation deletes first — see tags_delete (FK-safe op order)
        assigned = library.db.run("api.label.assigned_objects",
                                  (lb["id"],))
        ops = [sync.relation_delete("label_on_object", r["opub"],
                                    lb["pub_id"]) for r in assigned]
        ops.append(sync.shared_delete("label", lb["pub_id"]))
        with sync.write_ops(ops) as conn:
            library.db.run("api.label.clear_assignments", (lb["id"],),
                           conn=conn)
            library.db.delete("label", lb["id"], conn=conn)
        return None


# -- spaces / albums (net-new API over schema.prisma:389-411/448-477's
# models — the reference registers the tables but ships NO api/ui for
# them; both stay LOCAL sync mode, matching its unannotated models) ----

def _grouping(r: Router, kind: str, rel: str, fk: str,
              extra_fields: tuple,
              rel_has_date_created: bool = False) -> None:
    """Shared CRUD for the two object-grouping models (space/album):
    identical shape, different table names and editable columns."""
    list_key = f"{kind}s.list"
    get_key = f"{kind}s.get"

    @r.query(f"{kind}s.list", library=True)
    def g_list(node, library, _input):
        return rows_to_dicts(library.db.query(
            f"SELECT g.*, COUNT(r.{fk}) AS object_count "
            f"FROM {kind} g LEFT JOIN {rel} r ON r.{fk} = g.id "
            f"GROUP BY g.id"))

    @r.query(f"{kind}s.get", library=True)
    def g_get(node, library, input):
        # f-strings bind the declared api.grouping.* shapes
        row = library.db.query_one(
            f"SELECT * FROM {kind} WHERE id = ?", (int(input["id"]),))
        if row is None:
            raise RpcError("NOT_FOUND", f"no such {kind}")
        out = row_to_dict(row)
        out["object_ids"] = [x["object_id"] for x in library.db.query(
            f"SELECT object_id FROM {rel} WHERE {fk} = ?", (row["id"],))]
        return out

    @r.mutation(f"{kind}s.create", library=True, invalidates=[list_key])
    def g_create(node, library, input):
        values = {"name": str(input["name"]),
                  "date_created": int(time.time()),
                  "date_modified": int(time.time())}
        for f in extra_fields:
            if f in input:
                values[f] = input[f]
        gid = library.db.insert(kind, {"pub_id": uuid_bytes(), **values})
        return {"id": gid, **values}

    @r.mutation(f"{kind}s.update", library=True,
                invalidates=[list_key, get_key])
    def g_update(node, library, input):
        gid = int(input["id"])
        if library.db.query_one(
                f"SELECT 1 FROM {kind} WHERE id = ?", (gid,)) is None:
            raise RpcError("NOT_FOUND", f"no such {kind}")
        values = {k: input[k] for k in ("name",) + extra_fields
                  if k in input}
        values["date_modified"] = int(time.time())
        library.db.update(kind, gid, values)
        return None

    @r.mutation(f"{kind}s.delete", library=True,
                invalidates=[list_key, get_key])
    def g_delete(node, library, input):
        with library.db.write_tx() as conn:
            conn.execute(f"DELETE FROM {rel} WHERE {fk} = ?",
                         (int(input["id"]),))
            conn.execute(f"DELETE FROM {kind} WHERE id = ?",
                         (int(input["id"]),))
        return None

    @r.mutation(f"{kind}s.addObjects", library=True,
                invalidates=[list_key, f"{kind}s.get"])
    def g_add(node, library, input):
        gid = int(input["id"])
        if library.db.query_one(
                f"SELECT 1 FROM {kind} WHERE id = ?", (gid,)) is None:
            raise RpcError("NOT_FOUND", f"no such {kind}")
        now = int(time.time())
        with library.db.write_tx() as conn:
            for oid in input["object_ids"]:
                # skip stale ids (object deleted between the caller's
                # list and this add): INSERT OR IGNORE does NOT
                # suppress FK violations, and one would roll back the
                # whole batch with a raw IntegrityError
                if library.db.run("api.object.exists", (int(oid),),
                                  conn=conn) is None:
                    continue
                if rel_has_date_created:
                    conn.execute(
                        f"INSERT OR IGNORE INTO {rel} ({fk}, object_id, "
                        f"date_created) VALUES (?, ?, ?)",
                        (gid, int(oid), now))
                else:
                    conn.execute(
                        f"INSERT OR IGNORE INTO {rel} ({fk}, object_id) "
                        f"VALUES (?, ?)", (gid, int(oid)))
        return None

    @r.mutation(f"{kind}s.removeObjects", library=True,
                invalidates=[list_key, f"{kind}s.get"])
    def g_remove(node, library, input):
        with library.db.write_tx() as conn:
            for oid in input["object_ids"]:
                conn.execute(
                    f"DELETE FROM {rel} WHERE {fk} = ? AND object_id = ?",
                    (int(input["id"]), int(oid)))
        return None


def _spaces(r: Router) -> None:
    _grouping(r, "space", "object_in_space", "space_id",
              ("description",))


def _albums(r: Router) -> None:
    _grouping(r, "album", "object_in_album", "album_id",
              ("is_hidden",), rel_has_date_created=True)


# -- categories. (api/categories.rs: object-kind counts) -------------------

def _categories(r: Router) -> None:
    @r.query("categories.list", library=True)
    def categories_list(node, library, _input):
        from ..files import ObjectKind
        counts = {int(k): 0 for k in ObjectKind}
        for row in library.db.run("api.object.kind_counts"):
            if row["kind"] is not None:
                counts[int(row["kind"])] = row["n"]
        return {ObjectKind(k).name.title().replace("_", ""): n
                for k, n in counts.items()}


# -- locations. (api/locations.rs incl. indexer_rules sub-router) ----------

def _locations(r: Router) -> None:
    @r.query("locations.list", library=True)
    def locations_list(node, library, _input):
        return rows_to_dicts(library.db.run("location.all"))

    @r.query("locations.get", library=True)
    def locations_get(node, library, input):
        row = library.db.run("location.by_id",
                             (int(input["location_id"]),))
        return row_to_dict(row) if row else None

    @r.query("locations.getWithRules", library=True)
    def locations_get_with_rules(node, library, input):
        row = library.db.run("location.by_id",
                             (int(input["location_id"]),))
        if row is None:
            return None
        out = row_to_dict(row)
        out["indexer_rules"] = rows_to_dicts(library.db.run(
            "location.rules_for", (row["id"],)))
        return out

    @r.mutation("locations.create", library=True,
                invalidates=["locations.list"])
    async def locations_create(node, library, input):
        try:
            loc_id = await asyncio.to_thread(
                loc_manager.create_location,
                library, str(input["path"]),
                indexer_rule_ids=input.get("indexer_rules_ids", []),
                name=input.get("name"))
        except loc_manager.LocationError as e:
            raise RpcError("BAD_REQUEST", str(e))
        if input.get("dry_run"):
            return loc_id
        await loc_manager.scan_location(node.jobs, library, loc_id,
                                        backend=node.backend)
        return loc_id

    @r.mutation("locations.update", library=True,
                invalidates=["locations.list"])
    def locations_update(node, library, input):
        loc = library.db.run("location.by_id", (int(input["id"]),))
        if loc is None:
            raise RpcError("NOT_FOUND", "no such location")
        sync = library.sync
        values = {k: input[k] for k in ("name", "hidden") if k in input}
        ops = [sync.shared_update("location", loc["pub_id"], k, v)
               for k, v in values.items()]
        with sync.write_ops(ops) as conn:
            library.db.update("location", loc["id"], values, conn=conn)
        # rule re-attachment
        if "indexer_rules_ids" in input:
            with library.db.write_tx() as conn:
                library.db.run("location.detach_rules", (loc["id"],),
                               conn=conn)
                library.db.run_many(
                    "location.attach_rule",
                    [(loc["id"], int(rid))
                     for rid in input["indexer_rules_ids"]], conn=conn)
        return None

    @r.mutation("locations.delete", library=True,
                invalidates=["locations.list"])
    def locations_delete(node, library, input):
        loc_manager.delete_location(library, int(input["location_id"]))
        return None

    @r.mutation("locations.relink", library=True,
                invalidates=["locations.list"])
    def locations_relink(node, library, input):
        loc_manager.relink_location(
            library, int(input["location_id"]), str(input["path"]))
        return None

    @r.mutation("locations.addLibrary", library=True,
                invalidates=["locations.list"])
    async def locations_add_library(node, library, input):
        # Same as create, addressed at an explicit library (locations.rs).
        return await locations_create(node, library, input)

    @r.mutation("locations.fullRescan", library=True)
    async def locations_full_rescan(node, library, input):
        await loc_manager.scan_location(
            node.jobs, library, int(input["location_id"]),
            backend=node.backend)
        return None

    @r.mutation("locations.quickRescan", library=True)
    async def locations_quick_rescan(node, library, input):
        from ..locations.shallow import light_scan_location
        return await asyncio.to_thread(
            light_scan_location, library, int(input["location_id"]),
            input.get("sub_path") or None, node.backend)

    @r.mutation("locations.subPathRescan", library=True)
    async def locations_sub_path_rescan(node, library, input):
        await loc_manager.scan_location_sub_path(
            node.jobs, library, int(input["location_id"]),
            str(input.get("sub_path", "")), backend=node.backend)
        return None

    @r.query("locations.online", library=True)
    def locations_online(node, library, _input):
        out = []
        for row in library.db.run("location.id_paths"):
            if row["path"] and os.path.isdir(row["path"]):
                out.append(row["id"])
        return out

    @r.mutation("locations.createDirectory", library=True)
    def locations_create_directory(node, library, input):
        loc = library.db.run("location.path_by_id",
                             (int(input["location_id"]),))
        if loc is None:
            raise RpcError("NOT_FOUND", "no such location")
        target = os.path.join(
            loc["path"], str(input["sub_path"]).strip("/"))
        os.makedirs(target, exist_ok=False)
        return None

    # indexer_rules sub-router (locations.rs mounts it under
    # locations.indexer_rules.*)
    @r.query("locations.indexer_rules.list", library=True)
    def rules_list(node, library, _input):
        return rows_to_dicts(library.db.run("location.rule.all"))

    @r.query("locations.indexer_rules.get", library=True)
    def rules_get(node, library, input):
        row = library.db.run("location.rule.by_id",
                             (int(input["id"]),))
        return row_to_dict(row) if row else None

    @r.query("locations.indexer_rules.listForLocation", library=True)
    def rules_for_location(node, library, input):
        return rows_to_dicts(library.db.run(
            "location.rules_for", (int(input["location_id"]),)))

    @r.mutation("locations.indexer_rules.create", library=True,
                invalidates=["locations.indexer_rules.list"])
    def rules_create(node, library, input):
        rule = IndexerRule(
            name=str(input["name"]),
            rules=[RulePerKind(RuleKind(int(k)), tuple(params))
                   for k, params in input["rules"]],
        )
        rid = library.db.insert("indexer_rule", {
            "pub_id": uuid_bytes(),
            "name": rule.name,
            "default_rule": int(bool(input.get("default", False))),
            "rules_per_kind": rule.serialize_rules(),
            "date_created": int(time.time()),
            "date_modified": int(time.time()),
        })
        return rid

    @r.mutation("locations.indexer_rules.delete", library=True,
                invalidates=["locations.indexer_rules.list"])
    def rules_delete(node, library, input):
        row = library.db.run("location.rule.default_flag",
                             (int(input["id"]),))
        if row is None:
            return None
        if row["default_rule"]:
            raise RpcError("BAD_REQUEST", "cannot delete a system rule")
        library.db.delete("indexer_rule", int(input["id"]))
        return None


# -- files. (api/files.rs) -------------------------------------------------

def _file_path_row(library, file_path_id: int):
    row = library.db.run("api.file_path.by_id", (file_path_id,))
    if row is None:
        raise RpcError("NOT_FOUND", f"file_path {file_path_id} not found")
    return row


def _object_row(library, object_id: int):
    row = library.db.run("api.object.by_id", (object_id,))
    if row is None:
        raise RpcError("NOT_FOUND", f"object {object_id} not found")
    return row


def _files(r: Router) -> None:
    @r.query("files.get", library=True)
    def files_get(node, library, input):
        obj = library.db.run("api.object.by_id", (int(input["id"]),))
        if obj is None:
            return None
        out = row_to_dict(obj)
        out["file_paths"] = rows_to_dicts(library.db.run(
            "api.file_path.for_object", (obj["id"],)))
        md = library.db.run("api.media_data.for_object", (obj["id"],))
        out["media_data"] = row_to_dict(md) if md else None
        return out

    @r.query("files.getPath", library=True)
    def files_get_path(node, library, input):
        row = _file_path_row(library, int(input["id"]))
        loc = library.db.run("location.path_by_id",
                             (row["location_id"],))
        if loc is None or not loc["path"]:
            return None
        iso = IsolatedPath.from_db_row(
            row["location_id"], bool(row["is_dir"]),
            row["materialized_path"], row["name"] or "",
            row["extension"] or "")
        return iso.join_on(loc["path"])

    @r.query("files.getMediaData", library=True)
    def files_get_media_data(node, library, input):
        md = library.db.run("api.media_data.for_object",
                            (int(input["id"]),))
        return row_to_dict(md) if md else None

    @r.query("files.getEphemeralMediaData")
    def files_get_ephemeral_media_data(node, input):
        md = extract_media_data(str(input["path"]))
        # EXIF extraction carries raw byte blobs (maker notes,
        # thumbnails) and rationals nested at ANY depth (IFD sub-dicts,
        # rational arrays) — sanitize recursively at the protocol
        # boundary instead of blowing up JSON encoding.
        return _json_safe(md)

    @r.mutation("files.setNote", library=True, invalidates=["search.objects"])
    def files_set_note(node, library, input):
        obj = _object_row(library, int(input["id"]))
        sync = library.sync
        note = input.get("note")
        with sync.write_ops([sync.shared_update(
                "object", obj["pub_id"], "note", note)]) as conn:
            library.db.update("object", obj["id"], {"note": note}, conn=conn)
        return None

    @r.mutation("files.setFavorite", library=True,
                invalidates=["search.objects"])
    def files_set_favorite(node, library, input):
        obj = _object_row(library, int(input["id"]))
        sync = library.sync
        fav = int(bool(input.get("favorite")))
        with sync.write_ops([sync.shared_update(
                "object", obj["pub_id"], "favorite", fav)]) as conn:
            library.db.update("object", obj["id"], {"favorite": fav},
                              conn=conn)
        return None

    def _set_access_time(library, ids, value):
        # date_accessed is a SYNCED object field: the write and its
        # per-object LWW update ops land in one tx, so peers see it.
        ids = [int(oid) for oid in ids]
        if not ids:
            return
        sync = library.sync
        ph = ",".join("?" for _ in ids)
        # binds the declared api.object.pubs_by_ids shape
        rows = library.db.query(
            f"SELECT id, pub_id FROM object WHERE id IN ({ph})", ids)
        ops = [sync.shared_update("object", r["pub_id"], "date_accessed",
                                  value) for r in rows]
        with sync.write_ops(ops) as conn:
            library.db.run_many(
                "api.object.set_access_time",
                [(value, r["id"]) for r in rows], conn=conn)

    @r.mutation("files.updateAccessTime", library=True)
    async def files_update_access_time(node, library, input):
        # A multi-select can carry thousands of ids — the SELECT + op
        # minting + write tx must not run on the event loop.
        await asyncio.to_thread(
            _set_access_time, library, input["ids"], int(time.time()))
        return None

    @r.mutation("files.removeAccessTime", library=True)
    async def files_remove_access_time(node, library, input):
        await asyncio.to_thread(
            _set_access_time, library, input["ids"], None)
        return None

    @r.mutation("files.renameFile", library=True,
                invalidates=["search.paths"])
    def files_rename(node, library, input):
        row = _file_path_row(library, int(input["file_path_id"]))
        loc = library.db.run("location.by_id", (row["location_id"],))
        iso = IsolatedPath.from_db_row(
            row["location_id"], bool(row["is_dir"]),
            row["materialized_path"], row["name"] or "",
            row["extension"] or "")
        old_full = iso.join_on(loc["path"])
        new_name = str(input["new_name"])
        if "/" in new_name or "\x00" in new_name:
            raise RpcError("BAD_REQUEST", "invalid file name")
        new_full = os.path.join(os.path.dirname(old_full), new_name)
        if os.path.exists(new_full):
            raise RpcError("BAD_REQUEST", "target name already exists")
        # User-file RENAME requested over RPC (the row follows the
        # user's file), not an artifact commit.
        os.rename(old_full, new_full)
        if row["is_dir"]:
            name, ext = new_name, ""
        else:
            dot = new_name.rfind(".")
            name, ext = (new_name, "") if dot <= 0 else \
                (new_name[:dot], new_name[dot + 1:])
        sync = library.sync
        ops = [sync.shared_update("file_path", row["pub_id"], "name", name),
               sync.shared_update("file_path", row["pub_id"], "extension",
                                  ext)]
        with sync.write_ops(ops) as conn:
            library.db.update("file_path", row["id"],
                              {"name": name, "extension": ext}, conn=conn)
            if row["is_dir"]:
                # descendants' materialized_path prefix changes too
                old_mat = f"{row['materialized_path']}{row['name']}/"
                new_mat = f"{row['materialized_path']}{name}/"
                library.db.run(
                    "api.file_path.rename_descendants",
                    (old_mat, new_mat, row["location_id"],
                     old_mat.replace("\\", "\\\\").replace("%", r"\%")
                     .replace("_", r"\_") + "%"), conn=conn)
        return None

    @r.mutation("files.createFolder", library=True,
                invalidates=["search.paths"])
    def files_create_folder(node, library, input):
        loc = library.db.run("location.by_id",
                             (int(input["location_id"]),))
        if loc is None:
            raise RpcError("NOT_FOUND", "no such location")
        target = os.path.join(loc["path"],
                              str(input["sub_path"]).strip("/"),
                              str(input["name"]))
        os.makedirs(target, exist_ok=False)
        from ..locations.shallow import light_scan_location
        light_scan_location(library, loc["id"],
                            str(input["sub_path"]).strip("/") or None,
                            node.backend)
        return target

    @r.mutation("files.createEphemeralFolder")
    def files_create_ephemeral_folder(node, input):
        target = os.path.join(str(input["path"]), str(input["name"]))
        os.makedirs(target, exist_ok=False)
        return target

    async def _spawn_fs_job(node, library, job):
        return (await node.jobs.ingest(library, job)).hex()

    @r.mutation("files.deleteFiles", library=True,
                invalidates=["search.paths"])
    async def files_delete(node, library, input):
        from ..objects.fs_ops import FileDeleterJob
        return await _spawn_fs_job(node, library, FileDeleterJob(
            location_id=int(input["location_id"]),
            file_path_ids=[int(i) for i in input["file_path_ids"]]))

    @r.mutation("files.eraseFiles", library=True,
                invalidates=["search.paths"])
    async def files_erase(node, library, input):
        from ..objects.fs_ops import FileEraserJob
        return await _spawn_fs_job(node, library, FileEraserJob(
            location_id=int(input["location_id"]),
            file_path_ids=[int(i) for i in input["file_path_ids"]],
            passes=int(input.get("passes", 1))))

    @r.mutation("files.copyFiles", library=True,
                invalidates=["search.paths"])
    async def files_copy(node, library, input):
        from ..objects.fs_ops import FileCopierJob
        return await _spawn_fs_job(node, library, FileCopierJob(
            location_id=int(input["source_location_id"]),
            file_path_ids=[int(i) for i in input["sources_file_path_ids"]],
            target_location_id=int(input["target_location_id"]),
            target_relative_directory=str(
                input.get("target_location_relative_directory_path", ""))))

    @r.mutation("files.cutFiles", library=True,
                invalidates=["search.paths"])
    async def files_cut(node, library, input):
        from ..objects.fs_ops import FileCutterJob
        return await _spawn_fs_job(node, library, FileCutterJob(
            location_id=int(input["source_location_id"]),
            file_path_ids=[int(i) for i in input["sources_file_path_ids"]],
            target_location_id=int(input["target_location_id"]),
            target_relative_directory=str(
                input.get("target_location_relative_directory_path", ""))))

    @r.mutation("files.duplicateFiles", library=True,
                invalidates=["search.paths"])
    async def files_duplicate(node, library, input):
        from ..objects.fs_ops import FileCopierJob
        return await _spawn_fs_job(node, library, FileCopierJob(
            location_id=int(input["location_id"]),
            file_path_ids=[int(i) for i in input["file_path_ids"]],
            target_location_id=int(input["location_id"]),
            target_relative_directory=str(
                input.get("target_relative_directory", ""))))

    @r.query("files.getConvertableImageExtensions")
    def files_convertable(node, _input):
        return ["png", "jpeg", "jpg", "webp", "bmp", "gif", "tiff"]


# -- jobs. (api/jobs.rs) ---------------------------------------------------

def _jobs(r: Router) -> None:
    @r.query("jobs.reports", library=True)
    def jobs_reports(node, library, _input):
        rows = library.db.run("api.job.reports")
        return rows_to_dicts(rows)

    @r.query("jobs.isActive", library=True)
    def jobs_is_active(node, library, _input):
        return bool(node.jobs.running)

    @r.subscription("jobs.progress")
    def jobs_progress(node, _input, emit):
        def on_event(e):
            if e.get("type") in ("JobProgress", "JobUpdate"):
                emit(e)
        return node.events.subscribe(on_event)

    @r.subscription("jobs.newThumbnail")
    def jobs_new_thumbnail(node, _input, emit):
        def on_event(e):
            if e.get("type") == "NewThumbnail":
                emit(e)
        return node.events.subscribe(on_event)

    @r.mutation("jobs.pause", library=True, invalidates=["jobs.reports"])
    def jobs_pause(node, library, input):
        node.jobs.pause(bytes.fromhex(str(input["id"])))
        return None

    @r.mutation("jobs.resume", library=True, invalidates=["jobs.reports"])
    async def jobs_resume(node, library, input):
        await node.jobs.resume(library, bytes.fromhex(str(input["id"])))
        return None

    @r.mutation("jobs.cancel", library=True, invalidates=["jobs.reports"])
    def jobs_cancel(node, library, input):
        node.jobs.cancel(bytes.fromhex(str(input["id"])))
        return None

    @r.mutation("jobs.clear", library=True, invalidates=["jobs.reports"])
    def jobs_clear(node, library, input):
        with library.db.write_tx() as conn:
            library.db.run(
                "api.job.clear",
                (bytes.fromhex(str(input["id"])), int(JobStatus.RUNNING),
                 int(JobStatus.PAUSED), int(JobStatus.QUEUED)),
                conn=conn)
        return None

    @r.mutation("jobs.clearAll", library=True, invalidates=["jobs.reports"])
    def jobs_clear_all(node, library, _input):
        with library.db.write_tx() as conn:
            library.db.run(
                "api.job.clear_all",
                (int(JobStatus.RUNNING), int(JobStatus.PAUSED),
                 int(JobStatus.QUEUED)), conn=conn)
        return None

    @r.mutation("jobs.generateThumbsForLocation", library=True)
    async def jobs_gen_thumbs(node, library, input):
        from ..media.processor import MediaProcessorJob
        jid = await node.jobs.ingest(library, MediaProcessorJob(
            location_id=int(input["id"]),
            sub_path=input.get("path") or None))
        return jid.hex()

    @r.mutation("jobs.objectValidator", library=True)
    async def jobs_object_validator(node, library, input):
        from ..objects.validator import ObjectValidatorJob
        jid = await node.jobs.ingest(library, ObjectValidatorJob(
            location_id=int(input["id"]),
            sub_path=input.get("path") or None,
            mode=str(input.get("mode", "fill")), device=node.device))
        return jid.hex()

    @r.mutation("jobs.identifyUniqueFiles", library=True)
    async def jobs_identify(node, library, input):
        from ..objects.identifier import FileIdentifierJob
        jid = await node.jobs.ingest(library, FileIdentifierJob(
            location_id=int(input["id"]),
            sub_path=input.get("path") or None, backend=node.backend))
        return jid.hex()

    @r.mutation("jobs.nearDupDetector", library=True)
    async def jobs_near_dup(node, library, input):
        from ..objects.dedup import NearDupDetectorJob
        jid = await node.jobs.ingest(library, NearDupDetectorJob(
            location_id=int(input["id"]),
            threshold=int(input.get("threshold", 10)),
            backend=node.backend))
        return jid.hex()


# -- search. (api/search.rs:364-750) ---------------------------------------

def _search_paths_where(input) -> tuple:
    where, params = "1=1", []
    f = input.get("filter") or {}
    if "location_id" in f:
        where += " AND fp.location_id = ?"
        params.append(int(f["location_id"]))
    if f.get("search"):
        where += " AND fp.name LIKE ?"
        params.append(f"%{f['search']}%")
    if "is_dir" in f:
        where += " AND fp.is_dir = ?"
        params.append(int(bool(f["is_dir"])))
    if f.get("extension"):
        where += " AND LOWER(fp.extension) = ?"
        params.append(str(f["extension"]).lower())
    if f.get("materialized_path"):
        where += " AND fp.materialized_path = ?"
        params.append(f["materialized_path"])
    if f.get("object_kind"):
        ph = ",".join("?" for _ in f["object_kind"])
        where += (f" AND fp.object_id IN "
                  f"(SELECT id FROM object WHERE kind IN ({ph}))")
        params.extend(int(k) for k in f["object_kind"])
    if f.get("tags"):
        ph = ",".join("?" for _ in f["tags"])
        where += (f" AND fp.object_id IN (SELECT object_id FROM "
                  f"tag_on_object WHERE tag_id IN ({ph}))")
        params.extend(int(t) for t in f["tags"])
    # Server-side favorite/extension-set filters: the virtualized
    # explorer windows the result by absolute index, so EVERY filter
    # must narrow the SQL — a client-side filter would leave holes in
    # the windows and shift indices.
    if f.get("favorite") is not None:
        where += (" AND fp.object_id IN "
                  "(SELECT id FROM object WHERE favorite = ?)")
        params.append(int(bool(f["favorite"])))
    if f.get("album_id"):
        where += (" AND fp.object_id IN (SELECT object_id FROM "
                  "object_in_album WHERE album_id = ?)")
        params.append(int(f["album_id"]))
    if f.get("space_id"):
        where += (" AND fp.object_id IN (SELECT object_id FROM "
                  "object_in_space WHERE space_id = ?)")
        params.append(int(f["space_id"]))
    if f.get("extensions"):
        ph = ",".join("?" for _ in f["extensions"])
        where += f" AND LOWER(fp.extension) IN ({ph})"
        params.extend(str(e).lower() for e in f["extensions"])
    return where, params


def _search(r: Router) -> None:
    @r.query("search.paths", library=True)
    def search_paths(node, library, input):
        """Two access modes (the reference's Explorer queries through
        @tanstack/react-virtual windows — interface/app/$libraryId/
        Explorer): keyset `cursor` pagination for sequential readers,
        and absolute `skip` windows + server-side `order` for the
        virtualized explorer, which addresses rows by scroll index."""
        input = input or {}
        where, params = _search_paths_where(input)
        take = min(int(input.get("take", 100)), 500)
        order = input.get("order") or {}
        ocol = {"id": "fp.id", "name": "fp.name COLLATE NOCASE",
                "kind": "fp.extension COLLATE NOCASE",
                "size": "fp.size_in_bytes",
                "modified": "fp.date_modified",
                }.get(str(order.get("field", "id")), "fp.id")
        odir = "DESC" if order.get("desc") else "ASC"
        if "skip" in input:
            skip = max(0, int(input["skip"]))
            rows = library.db.query(
                f"SELECT fp.* FROM file_path fp WHERE {where} "
                f"ORDER BY {ocol} {odir}, fp.id LIMIT ? OFFSET ?",
                params + [take, skip])
            items = rows_to_dicts(rows)
            for it in items:
                it["thumbnail_key"] = it.get("cas_id")
            return {"items": items, "skip": skip}
        cursor = int(input.get("cursor", 0))
        rows = library.db.query(
            f"SELECT fp.* FROM file_path fp WHERE {where} AND fp.id > ? "
            f"ORDER BY fp.id LIMIT ?", params + [cursor, take])
        items = rows_to_dicts(rows)
        for it in items:
            it["thumbnail_key"] = it.get("cas_id")
        return {
            "items": items,
            "cursor": items[-1]["id"] if len(items) == take else None,
        }

    @r.query("search.pathsCount", library=True)
    def search_paths_count(node, library, input):
        where, params = _search_paths_where(input or {})
        return library.db.query_one(
            f"SELECT COUNT(*) AS n FROM file_path fp WHERE {where}",
            params)["n"]

    def _objects_where(input) -> tuple:
        where, params = "1=1", []
        f = (input or {}).get("filter") or {}
        if f.get("favorite") is not None:
            where += " AND o.favorite = ?"
            params.append(int(bool(f["favorite"])))
        if f.get("hidden") is not None:
            where += " AND o.hidden = ?"
            params.append(int(bool(f["hidden"])))
        if f.get("kind"):
            ph = ",".join("?" for _ in f["kind"])
            where += f" AND o.kind IN ({ph})"
            params.extend(int(k) for k in f["kind"])
        if f.get("tags"):
            ph = ",".join("?" for _ in f["tags"])
            where += (f" AND o.id IN (SELECT object_id FROM tag_on_object "
                      f"WHERE tag_id IN ({ph}))")
            params.extend(int(t) for t in f["tags"])
        return where, params

    @r.query("search.objects", library=True)
    def search_objects(node, library, input):
        """Same two access modes as search.paths: keyset `cursor`
        pagination, or absolute `skip` windows + server-side `order`
        for virtualized object views."""
        input = input or {}
        where, params = _objects_where(input)
        take = min(int(input.get("take", 100)), 500)

        def _attach_fps(items):
            # ONE query per page, not per object: the windowed mode is
            # hit on every scroll of a virtualized view
            if not items:
                return items
            ph = ",".join("?" for _ in items)
            by_obj: Dict[int, list] = {it["id"]: [] for it in items}
            # binds the declared api.search.paths_for_objects shape
            for fp in library.db.query(
                    f"SELECT * FROM file_path WHERE object_id IN ({ph})",
                    [it["id"] for it in items]):
                by_obj[fp["object_id"]].append(row_to_dict(fp))
            for it in items:
                it["file_paths"] = by_obj[it["id"]]
            return items

        if "skip" in input:
            order = input.get("order") or {}
            ocol = {"id": "o.id", "kind": "o.kind",
                    "date_created": "o.date_created",
                    "date_accessed": "o.date_accessed",
                    }.get(str(order.get("field", "id")), "o.id")
            odir = "DESC" if order.get("desc") else "ASC"
            skip = max(0, int(input["skip"]))
            rows = library.db.query(
                f"SELECT o.* FROM object o WHERE {where} "
                f"ORDER BY {ocol} {odir}, o.id LIMIT ? OFFSET ?",
                params + [take, skip])
            return {"items": _attach_fps(rows_to_dicts(rows)),
                    "skip": skip}
        cursor = int(input.get("cursor", 0))
        rows = library.db.query(
            f"SELECT o.* FROM object o WHERE {where} AND o.id > ? "
            f"ORDER BY o.id LIMIT ?", params + [cursor, take])
        items = _attach_fps(rows_to_dicts(rows))
        return {
            "items": items,
            "cursor": items[-1]["id"] if len(items) == take else None,
        }

    @r.query("search.objectsCount", library=True)
    def search_objects_count(node, library, input):
        where, params = _objects_where(input or {})
        return library.db.query_one(
            f"SELECT COUNT(*) AS n FROM object o WHERE {where}", params)["n"]

    @r.query("search.ephemeralPaths")
    async def search_ephemeral(node, input):
        path = str(input["path"])
        if not os.path.isdir(path):
            raise RpcError("BAD_REQUEST", f"{path} is not a directory")
        want_thumbs = bool(input.get("with_thumbnails"))
        # CAS hashing is file I/O — never on the event loop.
        entries = await asyncio.to_thread(
            walk_ephemeral, path,
            with_hidden_files=bool(input.get("with_hidden_files")),
            compute_cas_ids=want_thumbs, device=node.device)
        if want_thumbs and node.thumbnailer.is_running():
            # Fire-and-forget ephemeral batch (non_indexed.rs spawns the
            # same way); NewThumbnail events announce completions.
            batch = [(e["cas_id"], e["path"])
                     for e in entries if e.get("cas_id")]
            if batch:
                await node.thumbnailer.new_ephemeral_batch(batch)
        return entries

    # Net-new: device dedup analytics surfaces.
    @r.query("search.duplicates", library=True)
    def search_duplicates(node, library, input):
        from ..objects.dedup import exact_duplicate_groups
        return exact_duplicate_groups(
            library, location_id=(input or {}).get("location_id"))

    @r.query("search.nearDuplicates", library=True)
    def search_near_duplicates(node, library, input):
        from ..objects.dedup import near_duplicates
        return near_duplicates(
            library,
            max_distance=int((input or {}).get("max_distance", 10)))


# -- sync. (api/sync.rs) ---------------------------------------------------

def _sync(r: Router) -> None:
    @r.query("sync.messages", library=True)
    def sync_messages(node, library, _input):
        from ..sync.manager import GetOpsArgs
        ops = library.sync.get_ops(GetOpsArgs(clocks=[], count=1000))
        return [
            {"instance": op.instance.hex(), "timestamp": op.timestamp,
             "kind": op.typ.kind,
             "model": getattr(op.typ, "model",
                              getattr(op.typ, "relation", None))}
            for op in ops
        ]

    @r.subscription("sync.newMessage", library=True)
    def sync_new_message(node, library, _input, emit):
        def cb():
            emit({"type": "SyncMessageCreated"})
        library.sync.on_created(cb)
        return lambda: library.sync._on_created.remove(cb)


# -- preferences. (api/preferences.rs; KV per library) ---------------------

def _preferences(r: Router) -> None:
    @r.query("preferences.get", library=True)
    def preferences_get(node, library, _input):
        out = {}
        for row in library.db.run("api.preference.all"):
            out[row["key"]] = _msgpack.unpackb(row["value"]) \
                if row["value"] else None
        return out

    @r.mutation("preferences.update", library=True,
                invalidates=["preferences.get"])
    def preferences_update(node, library, input):
        with library.db.write_tx() as conn:
            for k, v in (input.get("values") or {}).items():
                if v is None:
                    library.db.run("api.preference.delete", (str(k),),
                                   conn=conn)
                else:
                    library.db.upsert(
                        "preference", {"key": str(k)},
                        {"value": _msgpack.packb(v)},
                        conn=conn)
        return None


# -- notifications. (api/notifications.rs) ---------------------------------

def _notifications(r: Router) -> None:
    @r.query("notifications.get")
    def notifications_get(node, _input):
        out = []
        for lib in node.libraries.list():
            for row in lib.db.run("api.notification.recent"):
                d = row_to_dict(row)
                d["library_id"] = str(lib.id)
                out.append(d)
        return out

    @r.mutation("notifications.dismiss", library=True,
                invalidates=["notifications.get"])
    def notifications_dismiss(node, library, input):
        with library.db.write_tx() as conn:
            library.db.run("api.notification.dismiss",
                           (int(input["id"]),), conn=conn)
        return None

    @r.mutation("notifications.dismissAll",
                invalidates=["notifications.get"])
    def notifications_dismiss_all(node, _input):
        for lib in node.libraries.list():
            # one tx per LIBRARY — each library is its own database
            lib.db.run_tx("api.notification.dismiss_all")
        return None

    @r.subscription("notifications.listen")
    def notifications_listen(node, _input, emit):
        def on_event(e):
            if e.get("type") == "Notification":
                emit(e)
        return node.events.subscribe(on_event)

    @r.mutation("notifications.test")
    def notifications_test(node, _input):
        node.events.emit({"type": "Notification",
                          "data": {"kind": "test", "message": "test"}})
        return None

    @r.mutation("notifications.testLibrary", library=True)
    def notifications_test_library(node, library, _input):
        library.db.insert("notification", {
            "data": _msgpack.packb({"kind": "test"}),
        })
        node.events.emit({"type": "Notification",
                          "data": {"kind": "test",
                                   "library_id": str(library.id)}})
        return None


# -- nodes. (api/nodes.rs) -------------------------------------------------

def _nodes(r: Router) -> None:
    @r.mutation("nodes.edit", invalidates=["nodeState"])
    def nodes_edit(node, input):
        if input.get("name"):
            node.config.raw["name"] = str(input["name"])
            node.config.save()
        return None

    @r.query("nodes.listLocations", library=True)
    def nodes_list_locations(node, library, input):
        return rows_to_dicts(library.db.run("location.all"))


# -- auth. (api/auth.rs — the RFC 8628 device flow state machine) ----------

def _auth(r: Router) -> None:
    from .. import auth as auth_mod

    @r.query("auth.me")
    def auth_me(node, _input):
        # api/auth.rs:148-174: stored token → issuer lookup → {id,email}
        token = auth_mod.stored_token(node)
        if token is None:
            raise RpcError("UNAUTHORIZED", "No auth token")
        user = auth_mod.issuer_for(node).me(token.to_header())
        if user is None:
            raise RpcError("UNAUTHORIZED", "token no longer valid")
        return {"id": user["id"], "email": user["email"]}

    @r.mutation("auth.logout", invalidates=["auth.me"])
    def auth_logout(node, _input):
        # api/auth.rs:133-147: clear the persisted token
        token = auth_mod.stored_token(node)
        if token is not None:
            auth_mod.issuer_for(node).revoke(token.access_token)
        auth_mod.store_token(node, None)
        return None

    @r.subscription("auth.loginSession")
    def auth_login(node, _input, emit):
        """api/auth.rs:36-131: Start{user_code, urls} → poll the
        device-code grant → persist token → Complete; pending keeps
        polling, denial/expiry → Error. `poll_interval` input shortens
        the reference's 5 s loop for tests/offline issuers."""
        issuer = auth_mod.issuer_for(node)
        client_id = node.config.id.hex()
        interval = 5.0
        if isinstance(_input, dict) and _input.get("poll_interval"):
            interval = float(_input["poll_interval"])
        try:
            dev = issuer.device_code(client_id)
        except Exception:
            emit({"state": "Error"})
            return lambda: None
        emit({"state": "Start",
              "user_code": dev["user_code"],
              "verification_url": dev["verification_url"],
              "verification_url_complete": dev["verification_uri_complete"]})

        async def poll():
            try:
                while True:
                    await asyncio.sleep(interval)
                    status, body = issuer.access_token(
                        auth_mod.DEVICE_CODE_URN, dev["device_code"],
                        client_id)
                    if status == 200:
                        await asyncio.to_thread(
                            auth_mod.store_token,
                            node, auth_mod.OAuthToken.from_raw(body))
                        node.events.invalidate_query(None, "auth.me")
                        emit({"state": "Complete"})
                        return
                    if body.get("error") == "authorization_pending":
                        continue
                    emit({"state": "Error"})
                    return
            except asyncio.CancelledError:
                raise
            except Exception:
                # An HTTP-adapter issuer can raise (network) or return
                # a malformed token body — the subscriber must get a
                # terminal Error, never a silent hang (api/auth.rs
                # breaks Response::Error on every failure arm).
                emit({"state": "Error"})

        # Supervised under the node's task tree: a subscriber gone before
        # the first emit never cancels the poll, and node.shutdown's reap
        # sweeps it.
        task = tasks.spawn("auth-poll", poll(),
                           owner=f"{node.task_owner}/api")
        return task.cancel


# -- backups. (api/backups.rs) ---------------------------------------------

def _backups(r: Router) -> None:
    @r.query("backups.getAll")
    def backups_get_all(node, _input):
        return backups_mod.list_backups(node)

    @r.mutation("backups.backup", library=True,
                invalidates=["backups.getAll"])
    async def backups_backup(node, library, _input):
        return await asyncio.to_thread(backups_mod.do_backup, node, library)

    @r.mutation("backups.restore", invalidates=["backups.getAll",
                                                "library.list"])
    async def backups_restore(node, input):
        return await asyncio.to_thread(
            backups_mod.restore_backup, node, str(input["backup_id"]))

    @r.mutation("backups.delete", invalidates=["backups.getAll"])
    def backups_delete(node, input):
        return backups_mod.delete_backup(node, str(input["backup_id"]))


# -- invalidation. (api/utils/invalidate.rs) -------------------------------

# -- p2p. (api/p2p.rs: events, state, spacedrop, acceptSpacedrop,
#    cancelSpacedrop, pair) --------------------------------------------------

def _p2p(r: Router) -> None:
    def _mgr(node):
        if node.p2p is None:
            raise RpcError("BAD_REQUEST", "p2p is not started on this node")
        return node.p2p

    @r.query("p2p.state")
    def p2p_state(node, _input):
        if node.p2p is None:
            return {"enabled": False, "peers": []}
        disc = node.p2p.discovery
        peers = []
        if disc is not None:
            for peer in disc.peers.values():
                peers.append({
                    "identity": peer.identity.to_bytes().hex(),
                    "addr": peer.addr, "port": peer.port,
                    "metadata": peer.metadata,
                })
        return {
            "enabled": True,
            "identity": node.p2p.identity.to_remote_identity()
                        .to_bytes().hex(),
            "port": node.p2p.port,
            "peers": peers,
        }

    @r.subscription("p2p.events")
    def p2p_events(node, _input, emit):
        def on_event(e):
            if str(e.get("type", "")).startswith(("Spacedrop", "P2P",
                                                  "Discovered")):
                emit(e)
        return node.events.subscribe(on_event)

    @r.mutation("p2p.spacedrop")
    async def p2p_spacedrop(node, input):
        mgr = _mgr(node)
        return await mgr.spacedrop(
            str(input["addr"]), int(input["port"]),
            str(input["file_path"]))

    @r.mutation("p2p.acceptSpacedrop")
    def p2p_accept_spacedrop(node, input):
        mgr = _mgr(node)
        drop_id = str(input["id"])
        # rspc signature: Some(path) accepts, None rejects
        # (api/p2p.rs acceptSpacedrop).
        path = input.get("path")
        if path:
            return mgr.accept_spacedrop(drop_id, str(path))
        return mgr.reject_spacedrop(drop_id)

    @r.mutation("p2p.cancelSpacedrop")
    def p2p_cancel_spacedrop(node, input):
        _mgr(node).cancel_spacedrop(str(input["id"]))
        return None

    @r.mutation("p2p.pair", library=True)
    async def p2p_pair(node, library, input):
        mgr = _mgr(node)
        return await mgr.pair(str(input["addr"]), int(input["port"]),
                              library)

    @r.mutation("p2p.debugPing")
    async def p2p_debug_ping(node, input):
        mgr = _mgr(node)
        return await mgr.ping(str(input["addr"]), int(input["port"]))


def _invalidation(r: Router) -> None:
    @r.subscription("invalidation.listen")
    def invalidation_listen(node, _input, emit):
        def on_event(e):
            if e.get("type") == "InvalidateOperation":
                emit(e)
        return node.events.subscribe(on_event)
