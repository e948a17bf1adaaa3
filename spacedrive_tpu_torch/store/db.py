"""SQLite store: one database file per library, single-writer discipline.

Port of ``spacedrive_tpu/store/db.py``: a thin wrapper over the stdlib
``sqlite3`` module in WAL mode, one connection per thread, one process-wide
write lock per database, every write inside a ``tx()`` batch. The schema
comes from ``store/models.py`` and the named statements from
``store/statements.py``.

What is kept exactly: the connection pragmas (WAL, ``synchronous=NORMAL``,
foreign keys, the 256 MiB page cache and 1 GiB mmap, ``temp_store=MEMORY``,
``wal_autocheckpoint=0``, ``journal_size_limit``), ``BEGIN IMMEDIATE`` …
``COMMIT`` with a short retry when the file is busy, the passive WAL fold
every 128 commits once the WAL passes 256 MiB, the schema bootstrap
(tables, then indexes) and the typed helpers. The JAX package's upgrades of
older libraries (additive columns, dropping op-log indexes an older schema
built eagerly) are left to it: the port opens the schema it creates.

``write_tx`` is the group-committed write path of the JAX package
(``store/actor.py``): a batch body runs in its own savepoint of the write
actor's transaction, coalesced with concurrent writers' batches, and
returns once that transaction has committed. A nested call, or a call
inside an open ``tx()`` on the same thread, rides that transaction under a
fresh savepoint. ``SDTPU_STORE_ACTOR=off`` gives one ``BEGIN IMMEDIATE``
… ``COMMIT`` per batch instead. Reads on a thread with an open
transaction (a granted ``write_tx`` included) see its uncommitted writes;
other reads use the thread's own connection (the JAX package lends a
pooled read-only one).
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
import uuid
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .. import chaos, flags, timeouts
from ..telemetry import STORE_BUSY_RETRIES
from . import actor as actor_mod
from . import models, statements
from ..sync.crdt import uuid4_bytes

# Delays between retries of a COMMIT (or a read) that found the file busy:
# about 2 s in all, then the error goes to the caller.
_BUSY_DELAYS_S = (0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 0.8)


def uuid_bytes(u: Optional[uuid.UUID] = None) -> bytes:
    """Stable 16-byte id; fresh ids are time-ordered (``sync.crdt``)."""
    if u is not None:
        return u.bytes
    return uuid4_bytes()


def _busy(e: sqlite3.OperationalError) -> bool:
    msg = str(e).lower()
    return "locked" in msg or "busy" in msg


class Database:
    """A single SQLite database with serialized writes."""

    # With wal_autocheckpoint off, every N commits the WAL size is checked
    # and folded back passively past this budget.
    _WAL_CHECK_EVERY = 128
    _WAL_BUDGET_BYTES = 256 << 20

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._write_lock = threading.RLock()
        self._conns_lock = threading.Lock()
        self._local = threading.local()
        self._all_conns: List[sqlite3.Connection] = []
        self._closed = False
        self._commits = 0
        self._actor = actor_mod.WriteActor(self)
        conn = self._conn()
        with self._write_lock:
            ddl = models.all_ddl()
            tables = [d for d in ddl if not d.lstrip().upper()
                      .startswith(("CREATE INDEX", "CREATE UNIQUE INDEX"))]
            for stmt in tables + [d for d in ddl if d not in tables]:
                conn.execute(stmt)
            conn.commit()

    def _conn(self) -> sqlite3.Connection:
        if self._closed:
            raise sqlite3.ProgrammingError("database is closed")
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA foreign_keys=ON")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA cache_size=-262144")
            conn.execute("PRAGMA mmap_size=1073741824")
            conn.execute("PRAGMA temp_store=MEMORY")
            # Bulk jobs checkpoint when they finish (jobs/worker.py) and
            # tx() folds a WAL past the budget; no automatic checkpoints.
            conn.execute("PRAGMA wal_autocheckpoint=0")
            conn.execute(f"PRAGMA journal_size_limit={self._WAL_BUDGET_BYTES}")
            with self._conns_lock:
                if self._closed:
                    conn.close()
                    raise sqlite3.ProgrammingError("database is closed")
                self._all_conns.append(conn)
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Close every thread's connection; later use raises. The write
        actor stops first: it may hold the write lock for a group, and it
        fails whatever is still queued."""
        self._actor.stop()
        with self._write_lock:
            with self._conns_lock:
                self._closed = True
                for conn in self._all_conns:
                    try:
                        conn.close()
                    except sqlite3.Error:
                        pass
                self._all_conns.clear()
                self._local = threading.local()

    # -- reads ------------------------------------------------------------

    def _read_conn(self) -> sqlite3.Connection:
        """The open transaction on this thread (a read inside it must see
        its uncommitted writes), else this thread's connection."""
        return getattr(self._local, "tx_conn", None) or self._conn()

    def _execute_read(self, conn: sqlite3.Connection, sql: str,
                      params: Sequence) -> sqlite3.Cursor:
        for delay in _BUSY_DELAYS_S + (None,):
            try:
                return conn.execute(sql, params)
            except sqlite3.OperationalError as e:
                if not _busy(e) or delay is None:
                    raise
                time.sleep(delay)

    def query(self, sql: str, params: Sequence = ()) -> List[sqlite3.Row]:
        return self._execute_read(self._read_conn(), sql, params).fetchall()

    def query_one(self, sql: str, params: Sequence = ()) -> Optional[sqlite3.Row]:
        return self._execute_read(self._read_conn(), sql, params).fetchone()

    # -- named statements -------------------------------------------------

    def run(self, name: str, params: Sequence = (), conn=None):
        """Execute the named statement. A read returns what its
        cardinality promises (``one`` → Row | None, ``many`` → rows,
        ``scalar`` → the first column of the first row); pass ``conn=``
        to read inside an open transaction. A write needs the open
        ``tx()`` connection and returns the cursor."""
        st = statements.get(name)
        if st.verb == "write":
            if conn is None:
                raise RuntimeError(f"{name}: write statements run on the open "
                                   "tx() connection; pass conn= (or use run_tx)")
            return conn.execute(st.sql, params)
        cur = conn.execute(st.sql, params) if conn is not None else \
            self._execute_read(self._read_conn(), st.sql, params)
        if st.cardinality == "many":
            return cur.fetchall()
        row = cur.fetchone()
        if st.cardinality == "scalar":
            return row[0] if row is not None else None
        return row

    def run_many(self, name: str, seq: Iterable[Sequence], conn=None) -> sqlite3.Cursor:
        """executemany of a named write statement on the open connection."""
        st = statements.get(name)
        if st.verb != "write" or conn is None:
            raise RuntimeError(f"{name}: run_many is for write statements "
                               "on the open tx() connection")
        return conn.executemany(st.sql, seq)

    def run_tx(self, name: str, params: Sequence = ()) -> sqlite3.Cursor:
        """One named write statement as its own write batch."""
        with self.write_tx() as c:
            return self.run(name, params, conn=c)

    # -- writes -----------------------------------------------------------

    @contextmanager
    def tx(self):
        """Serialized write transaction: ``BEGIN IMMEDIATE`` … ``COMMIT``
        under the write lock; reads on this thread see it until it ends."""
        conn = self._conn()
        with self._write_lock:
            prev = getattr(self._local, "tx_conn", None)
            self._local.tx_conn = conn
            try:
                conn.execute("BEGIN IMMEDIATE")
                yield conn
                self._commit_with_retry(conn)
            except BaseException:
                conn.rollback()
                raise
            finally:
                self._local.tx_conn = prev
            self._commits += 1
            if self._commits % self._WAL_CHECK_EVERY == 0:
                try:
                    if os.path.getsize(self.path + "-wal") > self._WAL_BUDGET_BYTES:
                        conn.execute("PRAGMA wal_checkpoint(PASSIVE)")
                except (OSError, sqlite3.Error):
                    pass

    @staticmethod
    def _commit_with_retry(conn: sqlite3.Connection) -> None:
        """COMMIT under the declared ``store.busy`` backoff: SQLite BUSY
        (another process holding the file lock, or an injected
        ``store.commit`` fault) costs bounded jittered latency
        (``sd_store_busy_retries_total``) instead of the whole
        transaction; an exhausted ladder re-raises the BUSY, and its
        give-up reaches the incident observatory."""
        b: Optional[timeouts.Backoff] = None
        while True:
            f = chaos.hit("store.commit", only=("delay", "error"))
            try:
                if f is not None:
                    if f.kind == "error":
                        raise sqlite3.OperationalError("database is locked")
                    chaos.apply_sync(f)  # delay: fsync weather
                conn.commit()
                return
            except sqlite3.OperationalError as e:
                if not _busy(e):
                    raise
                if b is None:
                    b = timeouts.Backoff("store.busy")
                d = b.next_delay()
                if d is None:
                    raise
                STORE_BUSY_RETRIES.inc()
                time.sleep(d)

    @contextmanager
    def _savepoint(self, conn: sqlite3.Connection):
        """One batch's bracket inside an enclosing transaction; same-name
        savepoints stack, so nested batches compose."""
        conn.execute("SAVEPOINT sdtpu_wtx")
        try:
            yield
        except BaseException:
            conn.execute("ROLLBACK TO sdtpu_wtx")
            conn.execute("RELEASE sdtpu_wtx")
            raise
        conn.execute("RELEASE sdtpu_wtx")

    @contextmanager
    def write_tx(self):
        """One write batch, group-committed by the write actor.

        The body runs on this thread in its own savepoint of the actor's
        transaction, over the actor's connection, and the block exits once
        that transaction has committed. A body that raises rolls back only
        its savepoint; a failed group COMMIT raises here. A nested call,
        or one inside an open ``tx()`` on this thread, rides that
        transaction under a fresh savepoint. The body must not reach
        ``checkpoint()``, ``checkpoint_passive()`` or ``tx()``: the actor
        holds the write lock for the whole group. With
        ``SDTPU_STORE_ACTOR=off``, one ``tx()`` per batch."""
        outer = getattr(self._local, "tx_conn", None)
        if outer is not None:
            with self._savepoint(outer):
                yield outer
            return
        if not flags.get("SDTPU_STORE_ACTOR"):
            with self.tx() as conn:
                yield conn
            return
        t = actor_mod._Ticket()
        self._actor.enqueue(t)
        if not t.grant_evt.wait(actor_mod.WRITE_BUDGET_S):
            raise actor_mod.WriteTxStalled(
                f"write_tx waited {actor_mod.WRITE_BUDGET_S:.0f} s for the group "
                "connection: the writer thread is wedged")
        if t.grant_exc is not None:
            raise t.grant_exc
        conn = t.conn
        try:
            self._local.tx_conn = conn
            try:
                conn.execute("SAVEPOINT sdtpu_wtx")
            except BaseException:
                t.body_fatal = True
                raise
            try:
                yield conn
            except BaseException:
                try:
                    conn.execute("ROLLBACK TO sdtpu_wtx")
                    conn.execute("RELEASE sdtpu_wtx")
                except sqlite3.Error:
                    t.body_fatal = True
                raise
            try:
                conn.execute("RELEASE sdtpu_wtx")
            except BaseException:
                t.body_fatal = True
                raise
            t.body_ok = True
        finally:
            # The connection goes back to the actor whatever happened: a
            # body that kept it would wedge every coalesced writer.
            self._local.tx_conn = None
            t.done_evt.set()
        if not t.commit_evt.wait(actor_mod.WRITE_BUDGET_S):
            raise actor_mod.WriteTxStalled(
                "a coalesced batch's group COMMIT did not resolve within "
                f"{actor_mod.WRITE_BUDGET_S:.0f} s")
        if t.commit_exc is not None:
            raise t.commit_exc

    def submit_write(self, fn, loop=None) -> Future:
        """Closure form of ``write_tx`` for a caller that must not park a
        thread: ``fn(conn)`` runs on the actor's thread in its own
        savepoint, and the returned future resolves with its result once
        the group commits (on `loop` when given). With the actor off the
        closure runs here under one ``tx()`` and the future comes back
        resolved."""
        if not flags.get("SDTPU_STORE_ACTOR"):
            fut: Future = Future()
            try:
                with self.tx() as conn:
                    res = fn(conn)
            except BaseException as e:  # noqa: BLE001 (the future carries it)
                fut.set_exception(e)
            else:
                fut.set_result(res)
            return fut
        return self._actor.submit(fn, loop=loop)

    def checkpoint(self) -> None:
        """Flush the WAL into the main file; never inside a transaction."""
        with self._write_lock:
            self._conn().execute("PRAGMA wal_checkpoint(TRUNCATE)")

    def checkpoint_passive(self) -> None:
        """Best-effort WAL flush at the end of a bulk job."""
        try:
            with self._write_lock:
                self._conn().execute("PRAGMA wal_checkpoint(PASSIVE)")
        except sqlite3.Error:
            pass

    def fold_wal(self, budget_bytes: int = None) -> bool:
        """PASSIVE checkpoint once the WAL has grown past `budget_bytes`
        (the WAL budget by default); never inside a transaction. A WAL that
        keeps growing costs every page read a longer wal-index search, so
        a long run of big commits (a clone's pages) folds it as it goes.
        Returns whether it checkpointed."""
        try:
            if os.path.getsize(self.path + "-wal") <= (budget_bytes or self._WAL_BUDGET_BYTES):
                return False
        except OSError:
            return False
        self.checkpoint_passive()
        return True

    def ensure_lazy_indexes(self, table: str) -> None:
        """Build a table's lazily declared indexes (``models.lazy_indexes``):
        idempotent; the first call on a big op log pays one index build."""
        for stmt in models.lazy_index_ddl(table):
            with self._write_lock:
                self._conn().execute(stmt)

    # -- typed helpers over the model registry ----------------------------

    def _write(self, conn, fn):
        if conn is not None:
            return fn(conn)
        with self.write_tx() as c:
            return fn(c)

    def insert(self, table: str, row: Dict[str, Any], conn=None) -> int:
        sql = (f"INSERT INTO {table} ({', '.join(row)}) "
               f"VALUES ({', '.join('?' for _ in row)})")
        return self._write(conn, lambda c: c.execute(sql, list(row.values())).lastrowid)

    def insert_many(self, table: str, rows: List[Dict[str, Any]], conn=None,
                    ignore_conflicts: bool = False) -> int:
        """Batched create; returns the number of rows inserted. Missing
        keys in a row insert NULL."""
        if not rows:
            return 0
        cols = list(dict.fromkeys(k for r in rows for k in r))
        conflict = " OR IGNORE" if ignore_conflicts else ""
        sql = (f"INSERT{conflict} INTO {table} ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' for _ in cols)})")
        vals = [[r.get(c) for c in cols] for r in rows]
        return self._write(conn, lambda c: c.executemany(sql, vals).rowcount)

    def update(self, table: str, row_id: Any, values: Dict[str, Any], conn=None,
               id_col: str = "id") -> None:
        if not values:
            return
        sql = (f"UPDATE {table} SET {', '.join(f'{k} = ?' for k in values)} "
               f"WHERE {id_col} = ?")
        self._write(conn, lambda c: c.execute(sql, [*values.values(), row_id]))

    def delete(self, table: str, row_id: Any, conn=None, id_col: str = "id") -> None:
        sql = f"DELETE FROM {table} WHERE {id_col} = ?"
        self._write(conn, lambda c: c.execute(sql, (row_id,)))

    def upsert(self, table: str, key: Dict[str, Any], values: Dict[str, Any],
               conn=None) -> None:
        cols = list(key) + list(values)
        sets = ", ".join(f"{k} = excluded.{k}" for k in values) or \
            f"{list(key)[0]} = excluded.{list(key)[0]}"
        sql = (f"INSERT INTO {table} ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' for _ in cols)}) "
               f"ON CONFLICT ({', '.join(key)}) DO UPDATE SET {sets}")
        self._write(conn, lambda c: c.execute(sql, [*key.values(), *values.values()]))
