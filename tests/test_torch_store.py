"""The port's msgpack codec and store against the JAX package's, exactly.

- ``_msgpack.packb`` gives ``msgpack.packb(v, use_bin_type=True)``'s bytes
  for every type the scan chain stores, and ``unpackb`` reads them back as
  ``msgpack.unpackb(raw=False, strict_map_key=False)`` does.
- A database either package creates has the same ``sqlite_master`` and the
  same connection pragmas; each named statement has the JAX SQL text.
- The port's ``tx`` folds a WAL past its budget, and ``write_tx`` nests as
  a savepoint.
"""

import sqlite3

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spacedrive_tpu.store import db as jax_db
from spacedrive_tpu.store import statements as jax_statements
from spacedrive_tpu_torch import _msgpack
from spacedrive_tpu_torch.store import db as port_db
from spacedrive_tpu_torch.store import models as port_models
from spacedrive_tpu_torch.store import statements

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8) | st.integers(-2**40, 2**40),
                                     inner, max_size=20)),
    max_leaves=40)


def _ref_unpack(b: bytes):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


@settings(max_examples=120, deadline=None)
@given(_values)
def test_codec_matches_msgpack_and_round_trips(v):
    packed = _msgpack.packb(v)
    assert packed == msgpack.packb(v, use_bin_type=True)
    assert _msgpack.unpackb(packed) == _ref_unpack(packed)


@pytest.mark.parametrize("v", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    "x" * 31, "x" * 32, "é" * 128, "x" * 65536, b"x" * 255, b"x" * 256,
    b"x" * 65536, [0] * 15, [0] * 16, [0] * 65536,
    {str(i): i for i in range(15)}, {i: None for i in range(16)},
    {i: None for i in range(65536)}, 1.5, float("inf"), -0.0,
], ids=lambda v: f"{type(v).__name__}-{len(v) if hasattr(v, '__len__') else v}")
def test_codec_at_every_format_boundary(v):
    packed = _msgpack.packb(v)
    assert packed == msgpack.packb(v, use_bin_type=True)
    assert _msgpack.unpackb(packed) == _ref_unpack(packed)


def test_codec_reads_float32_and_refuses_what_it_cannot_frame():
    assert _msgpack.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5
    nan = _msgpack.unpackb(_msgpack.packb(float("nan")))
    assert nan != nan
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(bad)
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\x92\x01")  # an array that ends early
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\x01\x02")  # trailing bytes
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\xc1")  # never used


def _master(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name").fetchall()
    finally:
        conn.close()


PRAGMAS = ("journal_mode", "synchronous", "foreign_keys", "cache_size", "mmap_size",
           "temp_store", "wal_autocheckpoint", "journal_size_limit")


def test_both_packages_create_the_same_schema_and_pragmas(tmp_path):
    jdb = jax_db.Database(tmp_path / "jax.db")
    pdb = port_db.Database(tmp_path / "port.db")
    try:
        assert port_models.all_ddl() == __import__(
            "spacedrive_tpu.store.models", fromlist=["all_ddl"]).all_ddl()
        master = _master(tmp_path / "port.db")
        assert master == _master(tmp_path / "jax.db")
        assert {name for kind, name, _t, _s in master if kind == "table"} >= {
            "file_path", "object", "shared_operation", "shared_op_blob", "job", "location"}
        with jdb.tx() as jc, pdb.tx() as pc:
            for p in PRAGMAS:
                assert pc.execute(f"PRAGMA {p}").fetchone()[0] == \
                    jc.execute(f"PRAGMA {p}").fetchone()[0], p
    finally:
        jdb.close()
        pdb.close()


@pytest.mark.parametrize("name", sorted(statements.STATEMENTS))
def test_each_statement_is_the_jax_packages(name):
    mine, theirs = statements.get(name), jax_statements.get(name)
    assert mine.sql == theirs.sql
    assert mine.verb == theirs.verb
    assert mine.cardinality == theirs.cardinality


@pytest.mark.parametrize("name", sorted(statements.SHAPES))
def test_each_shape_is_the_jax_packages(name):
    mine, theirs = statements.SHAPES[name], jax_statements.SHAPES[name]
    assert mine.sql == theirs.sql
    assert mine.verb == theirs.verb
    assert mine.cardinality == theirs.cardinality
    assert statements.render(name, "fp.location_id = ?") == \
        theirs.sql.replace("{w}", "fp.location_id = ?")


def test_write_tx_nests_as_a_savepoint_and_rolls_back_alone(tmp_path):
    db = port_db.Database(tmp_path / "lib.db")
    try:
        with db.write_tx() as conn:
            db.run("library.stats.insert", (1, "a", "0", "0"), conn=conn)
            with pytest.raises(RuntimeError):
                with db.write_tx() as inner:
                    assert inner is conn
                    db.run("library.stats.insert", (2, "b", "0", "0"), conn=inner)
                    raise RuntimeError("inner batch fails")
            # a read inside the transaction sees its own write
            assert db.query_one("SELECT COUNT(*) AS n FROM statistics")["n"] == 1
        assert [r["library_db_size"] for r in db.query("SELECT * FROM statistics")] == ["a"]
        with pytest.raises(RuntimeError, match="open tx"):
            db.run("library.stats.clear")
    finally:
        db.close()


def test_tx_folds_the_wal_past_its_budget(tmp_path, monkeypatch):
    db = port_db.Database(tmp_path / "lib.db")
    monkeypatch.setattr(port_db.Database, "_WAL_CHECK_EVERY", 2)
    monkeypatch.setattr(port_db.Database, "_WAL_BUDGET_BYTES", 0)
    seen = []
    try:
        # The commits run on the write actor's connection: a first write
        # opens it (commit 1), then every connection is traced.
        db.run_tx("library.stats.insert", (9, "x", "0", "0"))
        for conn in db._all_conns:
            conn.set_trace_callback(seen.append)
        for i in range(4):
            db.run_tx("library.stats.insert", (i, "x" * 1000, "0", "0"))
        assert seen.count("PRAGMA wal_checkpoint(PASSIVE)") == 2
        monkeypatch.setattr(port_db.Database, "_WAL_BUDGET_BYTES", 1 << 40)
        seen.clear()
        for i in range(4):
            db.run_tx("library.stats.insert", (i, "x" * 1000, "0", "0"))
        assert "PRAGMA wal_checkpoint(PASSIVE)" not in seen
    finally:
        db.close()
