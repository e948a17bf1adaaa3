"""Declarative data model registry — schema + sync metadata in one place.

The port's own copy of ``spacedrive_tpu/store/models.py``, unchanged, so
a database the port creates has the JAX package's exact ``sqlite_master``
(``tests/test_torch_store.py`` holds the two schemas equal).

The reference defines its data model in Prisma schema doc-comments
(`upstream core/prisma/schema.prisma`, 532 lines) and generates both
the DB client and per-model CRDT sync types from annotations (`@local`,
`@shared(id: …)`, `@relation(item, group)`) via
`upstream crates/sync-generator/src/lib.rs:24-80`. Here the same
single-source-of-truth idea is a Python registry: each `Model` declares its
fields, indexes, and sync mode, and from it we derive (a) SQLite DDL
(store/db.py) and (b) CRDT apply/emit logic (sync/manager.py) — no codegen
step needed.

Sync modes (docs/developers/architecture/sync.mdx:22-47 semantics):
- LOCAL    — never synced (volumes, jobs, statistics).
- SHARED   — field-level last-write-wins CRDT keyed by a stable sync id.
- RELATION — CRDT over an (item, group) pair (tag_on_object).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple


class SyncMode(enum.Enum):
    LOCAL = "local"
    SHARED = "shared"
    RELATION = "relation"


@dataclass(frozen=True)
class Field:
    name: str
    type: str  # SQLite affinity: INTEGER | TEXT | REAL | BLOB
    nullable: bool = True
    primary_key: bool = False
    autoincrement: bool = False
    unique: bool = False
    default: Optional[str] = None  # raw SQL default
    references: Optional[str] = None  # "table(column)"
    on_delete: Optional[str] = None  # CASCADE | SET NULL | ...
    local_only: bool = False  # excluded from sync even on SHARED models


@dataclass(frozen=True)
class Model:
    name: str  # table name, snake_case
    fields: Tuple[Field, ...]
    sync: SyncMode = SyncMode.LOCAL
    # SHARED: field names forming the stable sync id (usually pub_id).
    sync_id: Tuple[str, ...] = ()
    # RELATION: (item_field, group_field) — each a FK whose sync id is the
    # referenced model's sync id.
    relation: Optional[Tuple[str, str]] = None
    uniques: Tuple[Tuple[str, ...], ...] = ()
    indexes: Tuple[Tuple[str, ...], ...] = ()
    # Indexes that only serve a subsystem's READ paths (e.g. the op
    # log's sync-side lookups) and would tax every bulk local write:
    # excluded from bootstrap DDL, built on first use via
    # Database.ensure_lazy_indexes(table).
    lazy_indexes: Tuple[Tuple[str, ...], ...] = ()

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"{self.name}.{name}")

    @property
    def synced_fields(self) -> List[Field]:
        return [
            f
            for f in self.fields
            if not f.primary_key
            and not f.local_only
            and f.name not in self.sync_id
        ]


def _id() -> Field:
    return Field("id", "INTEGER", nullable=False, primary_key=True, autoincrement=True)


def _pub_id() -> Field:
    return Field("pub_id", "BLOB", nullable=False, unique=True)


MODELS: Dict[str, Model] = {}


def register(model: Model) -> Model:
    assert model.name not in MODELS, model.name
    MODELS[model.name] = model
    return model


# --- CRDT op logs (schema.prisma:21-55). Local by definition. -------------

register(Model(
    "shared_operation",
    (
        _id(),
        Field("timestamp", "INTEGER", nullable=False),  # HLC as u64 NTP64
        Field("model", "TEXT", nullable=False),
        Field("record_id", "BLOB", nullable=False),  # msgpack sync id
        Field("kind", "TEXT", nullable=False),  # c | u:<field> | u:a+b (multi) | d
        Field("data", "BLOB", nullable=False),  # msgpack payload
        Field("instance_id", "INTEGER", nullable=False,
              references="instance(id)"),
    ),
    # Both indexes serve only the sync read paths (get_ops watermark
    # scans, ingest LWW compare). Local bulk writers (identifier/
    # indexer/validator) append millions of op rows, and the random
    # (model, record_id) btree inserts were the measured superlinear
    # cost at 1M files — so the indexes build lazily on first sync use
    # (SyncManager._ensure_sync_indexes) instead of taxing every scan.
    lazy_indexes=(("timestamp",), ("model", "record_id")),
))

# Page-level op-log blobs: a bulk writer's whole chunk of shared ops
# (identifier/indexer, ~4-10k ops) lands as ONE row here instead of
# that many shared_operation rows — the op-log append was the measured
# wall of the 1M identify (README phase_ms: 16.7 s encode+insert vs
# 15.7 s of hashing). `data` is a msgpack array of per-op
# [timestamp, record_id(bin), kind, payload(bin)] entries where
# `payload` is byte-identical to what shared_operation.data would
# hold (sync/opblob.py; natively encoded by sdio.cpp sd_encode_ops).
# Blobs are written only while the library is SOLO (single instance);
# get_ops reads them directly, and the first remote ingest explodes
# them into indexed rows (SyncManager._ensure_row_oplog) because the
# per-record LWW compares need the (model, record_id) index.
register(Model(
    "shared_op_blob",
    (
        _id(),
        Field("model", "TEXT", nullable=False),
        Field("min_ts", "INTEGER", nullable=False),
        Field("max_ts", "INTEGER", nullable=False),
        Field("n_ops", "INTEGER", nullable=False),
        Field("data", "BLOB", nullable=False),
        Field("instance_id", "INTEGER", nullable=False,
              references="instance(id)"),
    ),
    # One cheap index: get_ops pages skip fully-served blobs by
    # watermark; bulk writers append a handful of rows per chunk, so
    # unlike the per-op tables this maintenance cost is negligible.
    indexes=(("max_ts",),),
))

# Relation ops that arrived before the rows they reference (cross-
# instance arrival order is not timestamp-ordered): parked here instead
# of the op log — logging them would make _compare_message reject the
# redelivery forever — and drained after shared creates land.
register(Model(
    "pending_relation_op",
    (
        _id(),
        # Redelivered pages re-park the same op (the watermark freeze
        # re-serves unapplied ops by design) — the ingest INSERT dedups
        # on op_id via WHERE NOT EXISTS, or drain would graduate N
        # duplicates into the op log. Deliberately a PLAIN NULLABLE
        # column (not UNIQUE): this table predates the column, and the
        # additive migration can only ALTER in plain nullable columns —
        # a UNIQUE constraint here would brick every pre-existing
        # library at open (SQLite can't ADD a UNIQUE column).
        Field("op_id", "BLOB"),
        Field("timestamp", "INTEGER", nullable=False),
        Field("data", "BLOB", nullable=False),  # packed CRDTOperation
        # Referenced (target model, packed sync id) pairs, denormalized
        # at park time so a shared delete purges dead parked ops with
        # one indexed DELETE instead of unpacking the whole table.
        # Nullable: rows parked by an older schema lack them and fall
        # back to the drain-time tombstone check.
        Field("item_model", "TEXT"),
        Field("item_key", "BLOB"),
        Field("group_model", "TEXT"),
        Field("group_key", "BLOB"),
    ),
    indexes=(("timestamp",), ("op_id",), ("item_model", "item_key"),
             ("group_model", "group_key")),
))

# Ops this node's schema cannot apply (unknown model — version skew
# with a newer peer): quarantined instead of dropped, because the
# watermark advances past them and get_ops would never re-serve them.
# SyncManager.drain_quarantined_ops re-ingests after a schema upgrade
# teaches the registry the model.
register(Model(
    "quarantined_op",
    (
        _id(),
        Field("op_id", "BLOB", nullable=False, unique=True),
        Field("timestamp", "INTEGER", nullable=False),
        Field("data", "BLOB", nullable=False),  # packed CRDTOperation
    ),
    indexes=(("timestamp",),),
))

register(Model(
    "relation_operation",
    (
        _id(),
        Field("timestamp", "INTEGER", nullable=False),
        Field("relation", "TEXT", nullable=False),
        Field("item_id", "BLOB", nullable=False),
        Field("group_id", "BLOB", nullable=False),
        Field("kind", "TEXT", nullable=False),
        Field("data", "BLOB", nullable=False),
        Field("instance_id", "INTEGER", nullable=False,
              references="instance(id)"),
    ),
    # Sync-side reads only, as above. (relation, item_id) narrows the
    # per-record LWW compares exactly like shared_operation's
    # (model, record_id) — surfaced by schema-parity's
    # unindexed-filter over the relation compare statements.
    lazy_indexes=(("timestamp",), ("relation", "item_id")),
))

# --- Instances (schema.prisma:70-97): one row per (device, library). ------

register(Model(
    "instance",
    (
        _id(),
        _pub_id(),
        Field("identity", "BLOB", nullable=False),  # ed25519 public key
        Field("node_id", "BLOB", nullable=False),
        Field("node_name", "TEXT", nullable=False),
        Field("node_platform", "INTEGER", nullable=False),
        Field("last_seen", "INTEGER", nullable=False),
        Field("date_created", "INTEGER", nullable=False),
        Field("timestamp", "INTEGER"),  # latest HLC seen from this instance
    ),
))

register(Model(
    "statistics",
    (
        _id(),
        Field("date_captured", "INTEGER", nullable=False,
              default="(strftime('%s','now'))"),
        Field("total_object_count", "INTEGER", nullable=False, default="0"),
        Field("library_db_size", "TEXT", nullable=False, default="'0'"),
        Field("total_bytes_used", "TEXT", nullable=False, default="'0'"),
        Field("total_bytes_capacity", "TEXT", nullable=False, default="'0'"),
        Field("total_unique_bytes", "TEXT", nullable=False, default="'0'"),
        Field("total_bytes_free", "TEXT", nullable=False, default="'0'"),
        Field("preview_media_bytes", "TEXT", nullable=False, default="'0'"),
    ),
))

# --- Volumes (@local, schema.prisma:114). ---------------------------------

register(Model(
    "volume",
    (
        _id(),
        Field("name", "TEXT", nullable=False),
        Field("mount_point", "TEXT", nullable=False),
        Field("total_bytes_capacity", "TEXT", nullable=False, default="'0'"),
        Field("total_bytes_available", "TEXT", nullable=False, default="'0'"),
        Field("disk_type", "TEXT"),
        Field("filesystem", "TEXT"),
        Field("is_system", "INTEGER", nullable=False, default="0"),
        Field("date_modified", "INTEGER", nullable=False,
              default="(strftime('%s','now'))"),
    ),
    uniques=(("mount_point", "name"),),
))

# --- Locations (@shared(id: pub_id), schema.prisma:130). ------------------

register(Model(
    "location",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT"),
        Field("path", "TEXT"),
        Field("total_capacity", "INTEGER"),
        Field("available_capacity", "INTEGER"),
        Field("is_archived", "INTEGER"),
        Field("generate_preview_media", "INTEGER"),
        Field("sync_preview_media", "INTEGER"),
        Field("hidden", "INTEGER"),
        Field("date_created", "INTEGER"),
        Field("instance_id", "INTEGER", references="instance(id)",
              local_only=True),
    ),
    sync=SyncMode.SHARED,
    sync_id=("pub_id",),
))

# --- FilePath (@shared, schema.prisma:155-198). ---------------------------

register(Model(
    "file_path",
    (
        _id(),
        _pub_id(),
        Field("is_dir", "INTEGER"),
        Field("cas_id", "TEXT"),  # schema.prisma:162
        Field("integrity_checksum", "TEXT"),  # schema.prisma:164
        Field("location_id", "INTEGER", references="location(id)",
              on_delete="CASCADE"),
        Field("materialized_path", "TEXT"),  # schema.prisma:171
        Field("name", "TEXT"),
        Field("extension", "TEXT"),
        Field("size_in_bytes_bytes", "BLOB"),  # u64 BE bytes, like :178
        Field("inode", "BLOB"),  # schema.prisma:181
        Field("object_id", "INTEGER", references="object(id)"),
        Field("key_id", "INTEGER"),
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
        Field("date_indexed", "INTEGER"),
    ),
    sync=SyncMode.SHARED,
    sync_id=("pub_id",),
    uniques=(
        ("location_id", "materialized_path", "name", "extension"),  # :197
        ("location_id", "inode"),  # :198
    ),
    indexes=(("location_id",), ("cas_id",), ("object_id",)),
))

# --- Object (@shared, schema.prisma:204). ---------------------------------

register(Model(
    "object",
    (
        _id(),
        _pub_id(),
        Field("kind", "INTEGER"),
        Field("key_id", "INTEGER"),
        Field("hidden", "INTEGER"),
        Field("favorite", "INTEGER"),
        Field("important", "INTEGER"),
        Field("note", "TEXT"),
        Field("date_created", "INTEGER"),
        Field("date_accessed", "INTEGER"),
    ),
    sync=SyncMode.SHARED,
    sync_id=("pub_id",),
))

# --- MediaData (schema.prisma:298). ---------------------------------------

register(Model(
    "media_data",
    (
        _id(),
        Field("object_id", "INTEGER", nullable=False, unique=True,
              references="object(id)", on_delete="CASCADE"),
        Field("resolution", "BLOB"),
        Field("media_date", "BLOB"),
        Field("media_location", "BLOB"),
        Field("camera_data", "BLOB"),
        Field("artist", "TEXT"),
        Field("description", "TEXT"),
        Field("copyright", "TEXT"),
        Field("exif_version", "TEXT"),
        Field("epoch_time", "INTEGER"),
        # Net-new vs the reference: 64-bit perceptual hash (big-endian
        # bytes) for device-side near-dup search (BASELINE.json config 4).
        Field("phash", "BLOB"),
        # Net-new: audio/video container metadata as JSON (the
        # reference's audio.rs/video.rs structs are stubs; here the
        # self-hosted parsers in media/audio.py fill them for real).
        Field("stream_data", "TEXT"),
    ),
))

# --- Near-dup pairs (net-new capability; no reference analog). ------------

register(Model(
    "near_dup_pair",
    (
        _id(),
        Field("object_a_id", "INTEGER", nullable=False,
              references="object(id)", on_delete="CASCADE"),
        Field("object_b_id", "INTEGER", nullable=False,
              references="object(id)", on_delete="CASCADE"),
        Field("distance", "INTEGER", nullable=False),
        Field("date_detected", "INTEGER"),
    ),
    uniques=(("object_a_id", "object_b_id"),),
    # distance serves the search.nearDuplicates threshold filter —
    # surfaced by the JAX package's schema-parity unindexed-filter check.
    indexes=(("object_a_id",), ("object_b_id",), ("distance",)),
))

# --- Tags (@shared; TagOnObject @relation — schema.prisma:331,349). -------

register(Model(
    "tag",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT"),
        Field("color", "TEXT"),
        Field("redundancy_goal", "INTEGER"),
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
    ),
    sync=SyncMode.SHARED,
    sync_id=("pub_id",),
))

register(Model(
    "tag_on_object",
    (
        Field("tag_id", "INTEGER", nullable=False, primary_key=True,
              references="tag(id)"),
        Field("object_id", "INTEGER", nullable=False, primary_key=True,
              references="object(id)"),
    ),
    sync=SyncMode.RELATION,
    relation=("object_id", "tag_id"),  # (item, group) like the reference
    # object_id is the composite PK's SECOND column — the apply-side
    # delete cascade's WHERE object_id = ? needs its own index.
    indexes=(("object_id",),),
))

register(Model(
    "label",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT"),
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
    ),
    sync=SyncMode.SHARED,
    sync_id=("pub_id",),
))

register(Model(
    "label_on_object",
    (
        Field("label_id", "INTEGER", nullable=False, primary_key=True,
              references="label(id)"),
        Field("object_id", "INTEGER", nullable=False, primary_key=True,
              references="object(id)"),
        Field("date_created", "INTEGER"),
    ),
    sync=SyncMode.RELATION,
    relation=("object_id", "label_id"),
    indexes=(("object_id",),),
))

# --- Space / Album (schema.prisma:389-411, 448-477): object groupings.
# The reference leaves these sync-UNannotated (its generator emits no
# sync types for them), so they stay LOCAL here too.

register(Model(
    "space",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT"),
        Field("description", "TEXT"),
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
    ),
    sync=SyncMode.LOCAL,
))

register(Model(
    "object_in_space",
    (
        Field("space_id", "INTEGER", nullable=False, primary_key=True,
              references="space(id)"),
        Field("object_id", "INTEGER", nullable=False, primary_key=True,
              references="object(id)"),
    ),
    sync=SyncMode.LOCAL,
    indexes=(("object_id",),),
))

register(Model(
    "album",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT"),
        Field("is_hidden", "INTEGER"),
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
    ),
    sync=SyncMode.LOCAL,
))

register(Model(
    "object_in_album",
    (
        Field("album_id", "INTEGER", nullable=False, primary_key=True,
              references="album(id)"),
        Field("object_id", "INTEGER", nullable=False, primary_key=True,
              references="object(id)"),
        Field("date_created", "INTEGER"),
    ),
    sync=SyncMode.LOCAL,
    indexes=(("object_id",),),
))

# --- Jobs (@local, schema.prisma:415-441; self-relation for chains). ------

register(Model(
    "job",
    (
        Field("id", "BLOB", nullable=False, primary_key=True),  # uuid bytes
        Field("name", "TEXT"),
        Field("action", "TEXT"),
        Field("status", "INTEGER"),
        Field("errors_text", "TEXT"),
        Field("data", "BLOB"),  # serialized resumable JobState
        Field("metadata", "BLOB"),
        Field("parent_id", "BLOB", references="job(id)",
              on_delete="CASCADE"),  # schema.prisma:440-441
        Field("task_count", "INTEGER"),
        Field("completed_task_count", "INTEGER"),
        Field("date_estimated_completion", "INTEGER"),
        Field("date_created", "INTEGER"),
        Field("date_started", "INTEGER"),
        Field("date_completed", "INTEGER"),
    ),
))

# Spooled step payloads for batch jobs (net-new vs the reference, which
# rmp-serializes every remaining step into job.data, job/mod.rs:896):
# steps carry a scratch row id instead of inline row lists, so the
# periodic crash checkpoint serializes kilobytes of descriptors rather
# than the whole remaining workload (measured ~200 MB / ~23 s per
# 3-second checkpoint for a 1M-file index before this). Rows delete as
# steps complete; finalize/cleanup and the job-row FK cascade sweep
# leftovers.

register(Model(
    "job_scratch",
    (
        _id(),
        Field("job_id", "BLOB", nullable=False,
              references="job(id)", on_delete="CASCADE"),
        Field("data", "BLOB", nullable=False),
    ),
    indexes=(("job_id",),),
))

# --- IndexerRule (@local here; schema.prisma:490). ------------------------

register(Model(
    "indexer_rule",
    (
        _id(),
        _pub_id(),
        Field("name", "TEXT", unique=True),
        Field("default_rule", "INTEGER"),
        Field("rules_per_kind", "BLOB"),  # msgpack [(kind, params), ...]
        Field("date_created", "INTEGER"),
        Field("date_modified", "INTEGER"),
    ),
))

register(Model(
    "indexer_rule_in_location",
    (
        Field("location_id", "INTEGER", nullable=False, primary_key=True,
              references="location(id)", on_delete="CASCADE"),
        Field("indexer_rule_id", "INTEGER", nullable=False, primary_key=True,
              references="indexer_rule(id)", on_delete="CASCADE"),
    ),
))

# --- Preferences / notifications (schema.prisma:517,524). -----------------

register(Model(
    "preference",
    (
        Field("key", "TEXT", nullable=False, primary_key=True),
        Field("value", "BLOB"),
    ),
))

register(Model(
    "notification",
    (
        _id(),
        Field("read", "INTEGER", nullable=False, default="0"),
        Field("data", "BLOB", nullable=False),
        Field("expires_at", "INTEGER"),
        Field("date_created", "INTEGER", nullable=False,
              default="(strftime('%s','now'))"),
    ),
))


# --- DDL generation -------------------------------------------------------


def ddl_for(model: Model) -> List[str]:
    cols = []
    pk_fields = [f for f in model.fields if f.primary_key]
    composite_pk = len(pk_fields) > 1
    for f in model.fields:
        col = f"{f.name} {f.type}"
        if f.primary_key and not composite_pk:
            col += " PRIMARY KEY"
            if f.autoincrement:
                col += " AUTOINCREMENT"
            elif not f.nullable:
                # SQLite's legacy quirk: non-INTEGER single-column PRIMARY
                # KEYs accept NULL unless NOT NULL is spelled out.
                col += " NOT NULL"
        elif not f.nullable:
            col += " NOT NULL"
        if f.unique and not f.primary_key:
            col += " UNIQUE"
        if f.default is not None:
            col += f" DEFAULT {f.default}"
        if f.references:
            col += f" REFERENCES {f.references}"
            if f.on_delete:
                col += f" ON DELETE {f.on_delete}"
        cols.append(col)
    if composite_pk:
        cols.append(
            "PRIMARY KEY (" + ", ".join(f.name for f in pk_fields) + ")"
        )
    for uq in model.uniques:
        cols.append("UNIQUE (" + ", ".join(uq) + ")")
    stmts = [
        f"CREATE TABLE IF NOT EXISTS {model.name} (\n  "
        + ",\n  ".join(cols)
        + "\n)"
    ]
    for idx in model.indexes:
        iname = f"idx_{model.name}_" + "_".join(idx)
        stmts.append(
            f"CREATE INDEX IF NOT EXISTS {iname} ON {model.name} "
            "(" + ", ".join(idx) + ")"
        )
    return stmts


def lazy_index_ddl(table: str) -> List[str]:
    """CREATE INDEX statements for a table's lazily-built indexes."""
    model = MODELS[table]
    return [
        f"CREATE INDEX IF NOT EXISTS idx_{model.name}_" + "_".join(idx)
        + f" ON {model.name} (" + ", ".join(idx) + ")"
        for idx in model.lazy_indexes
    ]


def all_ddl() -> List[str]:
    out: List[str] = []
    for model in MODELS.values():
        out.extend(ddl_for(model))
    return out
