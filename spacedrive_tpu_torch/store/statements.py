"""The named SQL statements the port runs.

A subset of ``spacedrive_tpu/store/statements.py``: each statement the
port's store, sync, node, library, locations, indexer, identifier,
validator, dedup, media, file-ops and API code execute (the ``api.*``
shapes included, as the JAX registry declares them, though their SQL is
built inline where it runs), under the JAX package's name and with its SQL text
(whitespace-collapsed, as the JAX registry keeps it;
``tests/test_torch_store.py`` holds the two texts equal). Call sites hold
only the name and run it through ``Database.run`` / ``run_many`` /
``run_tx``. A shape (``SHAPES``) is a statement with a ``{w}`` clause
filled where it runs (``render``). The JAX registry's contract checks
(declared tables, the runtime SQL auditor, shape matching) are not ported;
the scan chain's other dynamic SQL is written inline where it runs, as in
the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Stmt:
    name: str
    sql: str
    verb: str          # read | write
    cardinality: str   # one | many | scalar for reads, none for writes


STATEMENTS: Dict[str, Stmt] = {}
SHAPES: Dict[str, Stmt] = {}

_WS = re.compile(r"\s+")


def _declare(name: str, sql: str, verb: str, cardinality: str = "none",
             registry: Dict[str, Stmt] = STATEMENTS) -> None:
    if name in STATEMENTS or name in SHAPES:
        raise ValueError(f"statement {name!r} declared twice")
    registry[name] = Stmt(name, _WS.sub(" ", sql).strip(), verb, cardinality)


def render(name: str, where: str) -> str:
    """The SQL of shape `name` with its ``{w}`` clause filled by `where`."""
    try:
        return SHAPES[name].sql.replace("{w}", where)
    except KeyError:
        raise KeyError(f"undeclared shape {name!r}") from None


def get(name: str) -> Stmt:
    try:
        return STATEMENTS[name]
    except KeyError:
        raise KeyError(f"undeclared statement {name!r}") from None


# -- store (store/db.py) ----------------------------------------------------
_declare("store.object_count",
         "SELECT COUNT(*) AS n FROM object", "read", "one")
_declare("store.last_rowid", "SELECT last_insert_rowid()", "read", "scalar")

# -- sync write path (sync/manager.py) --------------------------------------
_declare("sync.instances.all",
         "SELECT id, pub_id, timestamp FROM instance", "read", "many")
_declare("sync.instances.id_by_pub",
         "SELECT id FROM instance WHERE pub_id = ?", "read", "one")
_declare("sync.oplog.insert_shared",
         "INSERT INTO shared_operation "
         "(timestamp, model, record_id, kind, data, instance_id) "
         "VALUES (?, ?, ?, ?, ?, ?)", "write")
_declare("sync.blob.insert",
         "INSERT INTO shared_op_blob "
         "(model, min_ts, max_ts, n_ops, data, instance_id) "
         "VALUES (?, ?, ?, ?, ?, ?)", "write")
_declare("sync.instances.set_watermark",
         "UPDATE instance SET timestamp = ? WHERE pub_id = ?", "write")
_declare("sync.instances.rows", "SELECT * FROM instance", "read", "many")
_declare("sync.oplog.insert_relation",
         "INSERT INTO relation_operation "
         "(timestamp, relation, item_id, group_id, kind, data, instance_id) "
         "VALUES (?, ?, ?, ?, ?, ?, ?)", "write")
_declare("sync.oplog.max_ts_shared",
         "SELECT MAX(timestamp) AS t FROM shared_operation", "read", "one")
_declare("sync.oplog.max_ts_relation",
         "SELECT MAX(timestamp) AS t FROM relation_operation", "read", "one")
_declare("sync.oplog.max_ts_blob",
         "SELECT MAX(max_ts) AS t FROM shared_op_blob", "read", "one")
_declare("sync.oplog.has_tombstones",
         "SELECT 1 FROM shared_operation WHERE kind = 'd' LIMIT 1", "read", "one")

# -- sync read path and clone serving ---------------------------------------
_declare("sync.blob.data_by_id",
         "SELECT data FROM shared_op_blob WHERE id = ?", "read", "one")
_declare("sync.clone.blob_metas",
         "SELECT b.id, b.model, b.min_ts, b.max_ts, b.n_ops, b.instance_id, "
         "i.pub_id AS pub FROM shared_op_blob b "
         "JOIN instance i ON i.id = b.instance_id ORDER BY b.min_ts",
         "read", "many")
_declare("sync.blob.metas_batch",
         "SELECT id, model, instance_id, data FROM shared_op_blob "
         "ORDER BY min_ts LIMIT 16", "read", "many")
_declare("sync.blob.metas_sweep",
         "SELECT id, model, instance_id, data FROM shared_op_blob "
         "ORDER BY min_ts", "read", "many")
_declare("sync.blob.delete", "DELETE FROM shared_op_blob WHERE id = ?", "write")

# -- sync ingest and last-writer-wins compare -------------------------------
_declare("sync.quarantine.insert",
         "INSERT OR IGNORE INTO quarantined_op (op_id, timestamp, data) "
         "VALUES (?, ?, ?)", "write")
_declare("sync.quarantine.all",
         "SELECT id, data FROM quarantined_op ORDER BY timestamp", "read", "many")
_declare("sync.quarantine.delete",
         "DELETE FROM quarantined_op WHERE id = ?", "write")
_declare("sync.lww.shared_tombstone",
         "SELECT 1 FROM shared_operation WHERE model = ? "
         "AND record_id = ? AND kind = 'd' LIMIT 1", "read", "one")
_declare("sync.lww.shared_update_coverage",
         "SELECT DISTINCT kind FROM shared_operation "
         "WHERE model = ? AND record_id = ? AND timestamp >= ? "
         "AND kind LIKE 'u:%'", "read", "many")
_declare("sync.lww.superseding_updates",
         "SELECT DISTINCT kind FROM shared_operation WHERE model = ? "
         "AND record_id = ? AND timestamp > ? AND kind LIKE 'u:%'", "read", "many")
_declare("sync.lww.shared_same_kind",
         "SELECT timestamp FROM shared_operation WHERE timestamp >= ? "
         "AND model = ? AND record_id = ? AND kind = ? "
         "ORDER BY timestamp DESC LIMIT 1", "read", "one")
_declare("sync.lww.relation_delete_check",
         "SELECT 1 FROM relation_operation WHERE relation = ? "
         "AND item_id = ? AND group_id = ? AND "
         "((kind = 'd' AND timestamp >= ?) OR "
         " (kind = 'c' AND timestamp > ?)) LIMIT 1", "read", "one")
_declare("sync.lww.relation_nondelete_check",
         "SELECT 1 FROM relation_operation WHERE relation = ? "
         "AND item_id = ? AND group_id = ? AND timestamp >= ? "
         "AND kind IN (?, 'd') LIMIT 1", "read", "one")
_declare("sync.lww.relation_superseding",
         "SELECT 1 FROM relation_operation WHERE relation = ? AND "
         "item_id = ? AND group_id = ? AND kind = ? AND timestamp > ? "
         "LIMIT 1", "read", "one")
_declare("sync.pending.park",
         "INSERT INTO pending_relation_op "
         "(op_id, timestamp, data, item_model, item_key, "
         "group_model, group_key) "
         "SELECT ?, ?, ?, ?, ?, ?, ? WHERE NOT EXISTS "
         "(SELECT 1 FROM pending_relation_op WHERE op_id = ?)", "write")
_declare("sync.pending.any",
         "SELECT 1 FROM pending_relation_op LIMIT 1", "read", "one")
_declare("sync.pending.all",
         "SELECT id, data FROM pending_relation_op ORDER BY timestamp",
         "read", "many")
_declare("sync.pending.delete",
         "DELETE FROM pending_relation_op WHERE id = ?", "write")
_declare("sync.pending.purge_refs",
         "DELETE FROM pending_relation_op WHERE "
         "(item_model = ? AND item_key = ?) OR "
         "(group_model = ? AND group_key = ?)", "write")

# -- node (node.py) ----------------------------------------------------------
_declare("node.orphan_objects",
         "SELECT o.id, o.pub_id FROM object o "
         "LEFT JOIN file_path fp ON fp.object_id = o.id "
         "WHERE fp.id IS NULL LIMIT 512", "read", "many")
_declare("node.object_delete", "DELETE FROM object WHERE id = ?", "write")

# -- library statistics (library.py) ----------------------------------------
_declare("library.stats.path_count",
         "SELECT COUNT(*) AS n FROM file_path", "read", "one")
_declare("library.stats.file_sizes",
         "SELECT size_in_bytes_bytes FROM file_path WHERE is_dir = 0",
         "read", "many")
_declare("library.stats.unique_sizes",
         "SELECT MIN(size_in_bytes_bytes) AS s FROM file_path "
         "WHERE is_dir = 0 AND object_id IS NOT NULL GROUP BY object_id",
         "read", "many")
_declare("library.stats.clear", "DELETE FROM statistics", "write")
_declare("library.stats.insert",
         "INSERT INTO statistics (total_object_count, library_db_size, "
         "total_unique_bytes, total_bytes_used) VALUES (?, ?, ?, ?)", "write")

# -- locations (locations/manager.py, rules.py) -----------------------------
_declare("location.paths", "SELECT path FROM location", "read", "many")
_declare("location.by_id",
         "SELECT * FROM location WHERE id = ?", "read", "one")
_declare("location.rules_for",
         "SELECT ir.* FROM indexer_rule ir JOIN indexer_rule_in_location irl "
         "ON irl.indexer_rule_id = ir.id WHERE irl.location_id = ?",
         "read", "many")

# -- indexer (locations/indexer_job.py) -------------------------------------
_declare("indexer.path_by_key",
         "SELECT * FROM file_path WHERE location_id = ? AND "
         "materialized_path = ? AND name = ? AND extension = ?", "read", "one")
_declare("indexer.children",
         "SELECT pub_id, cas_id, is_dir, materialized_path, name, extension "
         "FROM file_path WHERE location_id = ? AND materialized_path = ?",
         "read", "many")
_declare("indexer.path_current",
         "SELECT materialized_path, name FROM file_path WHERE pub_id = ?",
         "read", "one")
_declare("indexer.path_delete_by_pub",
         "DELETE FROM file_path WHERE pub_id = ?", "write")
_declare("indexer.id_pub_by_key",
         "SELECT id, pub_id FROM file_path WHERE location_id = ? AND "
         "materialized_path = ? AND name = ? AND extension = ?", "read", "one")
_declare("indexer.set_dir_size",
         "UPDATE file_path SET size_in_bytes_bytes = ? WHERE id = ?", "write")

# -- job scratch rows (jobs, indexer) ---------------------------------------
_declare("jobs.scratch.insert",
         "INSERT INTO job_scratch (job_id, data) VALUES (?, ?)", "write")
_declare("jobs.scratch.data",
         "SELECT data FROM job_scratch WHERE id = ?", "read", "one")
_declare("jobs.scratch.delete",
         "DELETE FROM job_scratch WHERE id = ?", "write")
_declare("jobs.scratch.delete_for_job",
         "DELETE FROM job_scratch WHERE job_id = ?", "write")

# -- identifier (objects/identifier.py) -------------------------------------
_declare("identifier.object_insert",
         "INSERT INTO object (pub_id, kind, date_created) VALUES (?, ?, ?)",
         "write")
_declare("identifier.object_by_pub",
         "SELECT id FROM object WHERE pub_id = ?", "read", "one")
_declare("identifier.link_paths",
         "UPDATE file_path SET cas_id = ?, object_id = ? WHERE id = ?", "write")
_declare("identifier.cas_map",
         "SELECT fp.cas_id AS c, o.id AS oid, o.pub_id AS opub "
         "FROM file_path fp JOIN object o ON o.id = fp.object_id "
         "WHERE fp.cas_id IS NOT NULL", "read", "many")

# -- validator (objects/validator.py) ---------------------------------------
_declare("validator.fill_checksum",
         "UPDATE file_path SET integrity_checksum = ? "
         "WHERE id = ? AND integrity_checksum IS NULL", "write")

# -- dedup (objects/dedup.py) -----------------------------------------------
_declare("dedup.exact_groups",
         "SELECT fp.cas_id AS cas_id, COUNT(*) AS n, "
         "o.pub_id AS object_pub_id "
         "FROM file_path fp JOIN object o ON o.id = fp.object_id "
         "WHERE {w} GROUP BY fp.cas_id HAVING n > 1 "
         "ORDER BY n DESC LIMIT ?", "read", "many", registry=SHAPES)
_declare("dedup.paths_by_cas",
         "SELECT materialized_path, name, extension, location_id, "
         "size_in_bytes_bytes FROM file_path WHERE cas_id = ?", "read", "many")
_declare("dedup.image_rows",
         "SELECT fp.id, fp.object_id, fp.materialized_path, fp.name, "
         "fp.extension, md.phash AS phash "
         "FROM file_path fp "
         "LEFT JOIN media_data md ON md.object_id = fp.object_id "
         "WHERE {w} ORDER BY fp.id", "read", "many", registry=SHAPES)
_declare("dedup.set_phash",
         "UPDATE media_data SET phash = ? WHERE object_id = ?", "write")
_declare("dedup.insert_phash_row",
         "INSERT OR IGNORE INTO media_data (object_id, phash) VALUES (?, ?)",
         "write")
_declare("dedup.phashes_for_location",
         "SELECT DISTINCT md.object_id AS object_id, md.phash AS phash "
         "FROM media_data md "
         "JOIN file_path fp ON fp.object_id = md.object_id "
         "WHERE md.phash IS NOT NULL AND fp.location_id = ?", "read", "many")
_declare("dedup.upsert_pair",
         "INSERT INTO near_dup_pair "
         "(object_a_id, object_b_id, distance, date_detected) "
         "VALUES (?, ?, ?, ?) "
         "ON CONFLICT (object_a_id, object_b_id) "
         "DO UPDATE SET distance = excluded.distance", "write")
_declare("dedup.pairs_within",
         "SELECT * FROM near_dup_pair WHERE distance <= ? "
         "ORDER BY distance ASC LIMIT ?", "read", "many")
_declare("dedup.paths_for_object",
         "SELECT materialized_path, name, extension "
         "FROM file_path WHERE object_id = ?", "read", "many")

# -- media (media/processor.py, media/actor.py) -----------------------------
_declare("media.file_rows",
         "SELECT id, pub_id, object_id, cas_id, materialized_path, "
         "name, extension FROM file_path WHERE {w} ORDER BY id", "read", "many",
         registry=SHAPES)
_declare("media.data_exists",
         "SELECT id FROM media_data WHERE object_id = ?", "read", "one")
_declare("media.known_cas",
         "SELECT DISTINCT cas_id FROM file_path WHERE cas_id IS NOT NULL", "read", "many")

# -- locations: the API's CRUD (locations/manager.py, api/procedures.py) --
_declare("location.all",
         "SELECT * FROM location", "read", "many")
_declare("location.path_by_id",
         "SELECT path FROM location WHERE id = ?", "read", "one")
_declare("location.pub_by_id",
         "SELECT pub_id FROM location WHERE id = ?", "read", "one")
_declare("location.id_paths",
         "SELECT id, path FROM location", "read", "many")
_declare("location.rule.all",
         "SELECT * FROM indexer_rule", "read", "many")
_declare("location.rule.by_id",
         "SELECT * FROM indexer_rule WHERE id = ?", "read", "one")
_declare("location.rule.default_flag",
         "SELECT default_rule FROM indexer_rule WHERE id = ?", "read", "one")
_declare("location.detach_rules",
         "DELETE FROM indexer_rule_in_location WHERE location_id = ?", "write")
_declare("location.attach_rule",
         "INSERT OR IGNORE INTO indexer_rule_in_location (location_id, "
         "indexer_rule_id) VALUES (?, ?)", "write")
_declare("node.instance_pub_by_row",
         "SELECT pub_id FROM instance WHERE id = ?", "read", "one")

# -- api (api/procedures.py, objects/fs_ops.py) ---------------------------
_declare("api.tag.all",
         "SELECT * FROM tag", "read", "many")
_declare("api.tag.by_id",
         "SELECT * FROM tag WHERE id = ?", "read", "one")
_declare("api.tag.for_object",
         "SELECT t.* FROM tag t JOIN tag_on_object to2 ON to2.tag_id = "
         "t.id WHERE to2.object_id = ?", "read", "many")
_declare("api.tag.object_ids",
         "SELECT object_id FROM tag_on_object WHERE tag_id = ?", "read", "many")
_declare("api.tag.assigned_objects",
         "SELECT o.pub_id AS opub FROM tag_on_object tob JOIN object o "
         "ON o.id = tob.object_id WHERE tob.tag_id = ?", "read", "many")
_declare("api.tag.clear_assignments",
         "DELETE FROM tag_on_object WHERE tag_id = ?", "write")
_declare("api.tag.unassign",
         "DELETE FROM tag_on_object WHERE tag_id = ? AND object_id = ?", "write")
_declare("api.tag.assign",
         "INSERT OR IGNORE INTO tag_on_object (tag_id, object_id) VALUES "
         "(?, ?)", "write")
_declare("api.label.list_with_counts",
         "SELECT l.*, COUNT(lo.label_id) AS object_count FROM label l "
         "LEFT JOIN label_on_object lo ON lo.label_id = l.id GROUP BY "
         "l.id", "read", "many")
_declare("api.label.by_id",
         "SELECT * FROM label WHERE id = ?", "read", "one")
_declare("api.label.for_object",
         "SELECT l.* FROM label l JOIN label_on_object lo ON lo.label_id "
         "= l.id WHERE lo.object_id = ?", "read", "many")
_declare("api.label.assigned_objects",
         "SELECT o.pub_id AS opub FROM label_on_object lo JOIN object o "
         "ON o.id = lo.object_id WHERE lo.label_id = ?", "read", "many")
_declare("api.label.clear_assignments",
         "DELETE FROM label_on_object WHERE label_id = ?", "write")
_declare("api.label.unassign",
         "DELETE FROM label_on_object WHERE label_id = ? AND object_id = "
         "?", "write")
_declare("api.label.assign",
         "INSERT OR IGNORE INTO label_on_object (label_id, object_id, "
         "date_created) VALUES (?, ?, ?)", "write")
_declare("api.object.by_id",
         "SELECT * FROM object WHERE id = ?", "read", "one")
_declare("api.object.exists",
         "SELECT 1 FROM object WHERE id = ?", "read", "one")
_declare("api.object.set_access_time",
         "UPDATE object SET date_accessed = ? WHERE id = ?", "write")
_declare("api.object.kind_counts",
         "SELECT kind, COUNT(*) AS n FROM object GROUP BY kind", "read", "many")
_declare("api.file_path.by_id",
         "SELECT * FROM file_path WHERE id = ?", "read", "one")
_declare("api.file_path.for_object",
         "SELECT * FROM file_path WHERE object_id = ?", "read", "many")
_declare("api.media_data.for_object",
         "SELECT * FROM media_data WHERE object_id = ?", "read", "one")
_declare("api.file_path.rename_descendants",
         "UPDATE file_path SET materialized_path = "
         "REPLACE(materialized_path, ?, ?) WHERE location_id = ? AND "
         "materialized_path LIKE ? ESCAPE '\\'", "write")
_declare("api.job.reports",
         "SELECT id, name, action, status, task_count, "
         "completed_task_count, errors_text, metadata, parent_id, "
         "date_created, date_started, date_completed, "
         "date_estimated_completion FROM job ORDER BY date_created DESC "
         "LIMIT 100", "read", "many")
_declare("api.job.clear",
         "DELETE FROM job WHERE id = ? AND status NOT IN (?, ?, ?)", "write")
_declare("api.job.clear_all",
         "DELETE FROM job WHERE status NOT IN (?, ?, ?)", "write")
_declare("api.preference.all",
         "SELECT * FROM preference", "read", "many")
_declare("api.preference.delete",
         "DELETE FROM preference WHERE key = ?", "write")
_declare("api.notification.recent",
         "SELECT * FROM notification ORDER BY id DESC LIMIT 50", "read", "many")
_declare("api.notification.dismiss",
         "UPDATE notification SET read = 1 WHERE id = ?", "write")
_declare("api.notification.dismiss_all",
         "UPDATE notification SET read = 1", "write")
_declare("api.object.pubs_by_ids",
         "SELECT id, pub_id FROM object WHERE id IN ({w})", "read", "many", registry=SHAPES)
_declare("api.grouping.list",
         "SELECT g.*, COUNT(r.{i}) AS object_count FROM {i} g LEFT JOIN "
         "{i} r ON r.{i} = g.id GROUP BY g.id", "read", "many", registry=SHAPES)
_declare("api.grouping.get",
         "SELECT * FROM {i} WHERE id = ?", "read", "one", registry=SHAPES)
_declare("api.grouping.exists",
         "SELECT 1 FROM {i} WHERE id = ?", "read", "one", registry=SHAPES)
_declare("api.grouping.object_ids",
         "SELECT object_id FROM {i} WHERE {i} = ?", "read", "many", registry=SHAPES)
_declare("api.search.paths_window",
         "SELECT fp.* FROM file_path fp WHERE {w} ORDER BY {w} {w}, "
         "fp.id LIMIT ? OFFSET ?", "read", "many", registry=SHAPES)
_declare("api.search.paths_cursor",
         "SELECT fp.* FROM file_path fp WHERE {w} AND fp.id > ? ORDER BY "
         "fp.id LIMIT ?", "read", "many", registry=SHAPES)
_declare("api.search.paths_count",
         "SELECT COUNT(*) AS n FROM file_path fp WHERE {w}", "read", "one", registry=SHAPES)
_declare("api.search.objects_window",
         "SELECT o.* FROM object o WHERE {w} ORDER BY {w} {w}, o.id "
         "LIMIT ? OFFSET ?", "read", "many", registry=SHAPES)
_declare("api.search.objects_cursor",
         "SELECT o.* FROM object o WHERE {w} AND o.id > ? ORDER BY o.id "
         "LIMIT ?", "read", "many", registry=SHAPES)
_declare("api.search.objects_count",
         "SELECT COUNT(*) AS n FROM object o WHERE {w}", "read", "one", registry=SHAPES)
_declare("api.search.paths_for_objects",
         "SELECT * FROM file_path WHERE object_id IN ({w})", "read", "many", registry=SHAPES)
