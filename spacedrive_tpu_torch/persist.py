"""Declared persistence plane: every durable on-disk artifact, by name.

The engine's whole value is that its state survives: the library
database, the incident store, node/library configs, key material,
caches, and BENCH artifacts must recover after ANY crash. Before this
module each site hand-rolled (or skipped) the tmp → fsync → atomic-
replace idiom; now durability is a CONTRACT, the same registry shape
as timeouts.py / channels.py / chaos.py:

- `declare_artifact(name, path_pattern, kind, fsync, recovery)` at the
  bottom of this module declares every durable artifact: its dotted
  name, where it lives, its write discipline (`atomic` replace | `wal`
  promote-or-discard | `append` DB-rows | `scratch` always-removed),
  its fsync policy, and a one-line recovery story. README renders the
  inventory via `python -m tools.sdlint --artifact-table`.
- Product code writes BY NAME through `atomic_write()` /
  `wal_writer()` / `scratch()` / `seal()` / `db_write()`. sdlint's
  io-durability pass flags bare open-for-write, rename-without-tmp,
  replace-without-fsync, and undeclared/dynamic artifact names — the
  timeout-registry name rules pointed at the filesystem seam.
- Runtime twin (`arm()`, called by sanitize.install() unless
  `SDTPU_FS_AUDIT=off`): interposes `os.replace`/`os.fsync`, checks
  fsync-file → rename → fsync-dir ordering per declared policy, counts
  `sd_persist_writes_total{name}` / `sd_persist_fsync_seconds` /
  `sd_persist_violations_total{kind}`, and raises
  `persist_undeclared_write` / `persist_unfsynced_rename` in tier-1.
- Crash grid (`tools/crash_grid.py`): `crashpoint(name, edge)` fires
  between every two steps of a write; a child started with
  `SDTPU_PERSIST_CRASHPOINT=<name>:<edge>` SIGKILLs itself there, and
  the grid asserts every artifact recovers valid-or-absent at EVERY
  declared edge — systematically, not sampled. The same seam draws the
  declared `persist.crashpoint` chaos fault so SDTPU_CHAOS can widen
  any window with a delay.

Write path (atomic/wal), with its crashpoint edges:

    open  <path>.tmp            -- edge tmp-open      (empty tmp)
    write first half, flush     -- edge tmp-partial   (torn tmp)
    write rest, flush           -- edge tmp-full      (complete tmp)
    fsync(tmp)     [policy]     -- edge fsync-file
    os.replace(tmp, path)       -- edge renamed
    fsync(dir)     [always]     -- durable

Recovery: `recover(name, dir)` — `wal` promotes a complete, validated
tmp (fsyncing before the promote rename) and discards torn ones;
`atomic` discards all tmp residue. Every outcome is valid-or-absent;
a reader never sees a torn final file.
"""

from __future__ import annotations

import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import chaos, flags
from .telemetry import (
    PERSIST_FSYNC_SECONDS,
    PERSIST_VIOLATIONS,
    PERSIST_WRITES,
)

__all__ = [
    "Artifact", "ARTIFACTS", "declare_artifact", "artifact",
    "atomic_write", "wal_writer", "scratch", "seal", "db_write",
    "recover", "edges_for", "crashpoint",
    "arm", "disarm", "armed", "artifact_table_markdown",
]

KINDS = ("atomic", "wal", "append", "scratch")
FSYNC_POLICIES = ("always", "file-only", "none", "delegated")

# The SIGKILL edges of one atomic/wal write, in firing order. Policy
# `none`/`file-only` writes skip the edges their policy skips —
# edges_for() is the authoritative per-artifact list the crash grid
# iterates.
_EDGES_FSYNC = ("tmp-open", "tmp-partial", "tmp-full", "fsync-file",
                "renamed")
_EDGES_NOSYNC = ("tmp-open", "tmp-partial", "tmp-full", "renamed")


@dataclass(frozen=True)
class Artifact:
    name: str          # dotted id: "<layer>.<what>"
    path_pattern: str  # where it lives (docs/table; not a glob)
    kind: str          # atomic | wal | append | scratch
    fsync: str         # always | file-only | none | delegated
    recovery: str      # one-line crash-recovery story


# Import-time declaration registry (same contract as TIMEOUTS /
# CHANNELS / FAULTS): bounded by the declarations at the bottom of
# this module, never by runtime traffic.
ARTIFACTS: Dict[str, Artifact] = {}  # sdlint: ok[unbounded-growth]


def declare_artifact(name: str, path_pattern: str, kind: str,
                     fsync: str, recovery: str) -> Artifact:
    if name in ARTIFACTS:
        raise ValueError(f"artifact {name!r} declared twice")
    if "." not in name or not all(
            p.replace("_", "a").isalnum() and p == p.lower()
            for p in name.split(".")):
        raise ValueError(f"artifact name {name!r}: want "
                         "dotted lower_snake segments")
    if kind not in KINDS:
        raise ValueError(f"artifact {name!r}: unknown kind {kind!r}")
    if fsync not in FSYNC_POLICIES:
        raise ValueError(f"artifact {name!r}: unknown fsync "
                         f"policy {fsync!r}")
    if (fsync == "delegated") != (kind == "append"):
        raise ValueError(f"artifact {name!r}: `delegated` fsync is "
                         "for (and only for) DB-backed `append` "
                         "artifacts — SQLite owns their durability")
    if not recovery.strip():
        raise ValueError(f"artifact {name!r}: empty recovery story")
    a = Artifact(name, path_pattern, kind, fsync, recovery)
    ARTIFACTS[name] = a
    return a


def artifact(name: str) -> Artifact:
    a = ARTIFACTS.get(name)
    if a is None:
        raise KeyError(f"undeclared artifact {name!r} (declare it in "
                       "spacedrive_tpu_torch/persist.py)")
    return a


def edges_for(name: str) -> Tuple[str, ...]:
    """The crashpoint edges one write of `name` passes, in order —
    what tools/crash_grid.py SIGKILLs at, one child per edge."""
    a = artifact(name)
    if a.kind in ("append", "scratch"):
        return ()  # DB rows (SQLite WAL) / always-removed scratch
    if a.fsync in ("always", "file-only"):
        return _EDGES_FSYNC
    return _EDGES_NOSYNC


# -- crashpoint seam ---------------------------------------------------------

def crashpoint(name: str, edge: str) -> None:
    """One declared durability edge: draws the `persist.crashpoint`
    chaos fault (a delay widens the window for racing killers), then
    SIGKILLs this process when `SDTPU_PERSIST_CRASHPOINT` names this
    exact `<artifact>:<edge>` — how crash-grid children die at every
    edge systematically. No-ops in normal operation."""
    fault = chaos.hit("persist.crashpoint", only=("delay",))
    if fault is not None:
        chaos.apply_sync(fault)
    spec = flags.get("SDTPU_PERSIST_CRASHPOINT")
    if spec and spec == f"{name}:{edge}":
        os.kill(os.getpid(), signal.SIGKILL)


# -- write-context bookkeeping (the auditor's TLS seam) ----------------------

_tls = threading.local()


def _write_stack() -> List[Artifact]:
    stack = getattr(_tls, "writes", None)
    if stack is None:
        stack = []
        _tls.writes = stack
    return stack


@contextmanager
def _writing(a: Artifact) -> Iterator[None]:
    stack = _write_stack()
    stack.append(a)
    try:
        yield
    finally:
        stack.pop()


def _current_write() -> Optional[Artifact]:
    stack = _write_stack()
    return stack[-1] if stack else None


def _timed_fsync(fd: int) -> None:
    t0 = time.perf_counter()
    os.fsync(fd)
    PERSIST_FSYNC_SECONDS.observe(time.perf_counter() - t0)


def _fsync_dir(path: str) -> None:
    """Directory-entry durability for a just-renamed artifact: without
    this the rename itself can vanish at power loss even though the
    file's bytes were fsynced."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return  # platforms/filesystems without dir-open semantics
    try:
        _timed_fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- writers -----------------------------------------------------------------

def _write_bytes(a: Artifact, path: str, data: bytes,
                 chaos_point: Optional[Callable[[str], None]]) -> None:
    tmp = path + ".tmp"
    half = len(data) // 2
    # The seam itself is the one sanctioned bare writer.
    with open(tmp, "wb") as f:  # sdlint: ok[io-durability]
        crashpoint(a.name, "tmp-open")
        f.write(data[:half])
        f.flush()
        if chaos_point is not None:
            chaos_point("tmp-partial")   # the caller's torn-tmp window
        crashpoint(a.name, "tmp-partial")
        f.write(data[half:])
        f.flush()
        crashpoint(a.name, "tmp-full")
        if a.fsync in ("always", "file-only"):
            _timed_fsync(f.fileno())
            crashpoint(a.name, "fsync-file")
    if chaos_point is not None:
        chaos_point("pre-rename")        # the complete-tmp window
    os.replace(tmp, path)
    crashpoint(a.name, "renamed")
    if a.fsync == "always":
        _fsync_dir(os.path.dirname(path))
    PERSIST_WRITES.labels(name=a.name).inc()


def atomic_write(name: str, path: str, data,
                 chaos_point: Optional[Callable[[str], None]] = None
                 ) -> str:
    """Write `data` (bytes or str) durably to `path` under artifact
    `name`'s declared policy: same-dir tmp → flush → fsync(file) →
    atomic replace → fsync(dir). `chaos_point(edge)` is the caller's
    hook into the torn-tmp (`tmp-partial`) and complete-tmp
    (`pre-rename`) windows — how incidents.py keeps its declared
    `incidents.write` delay seam inside the shared writer."""
    a = artifact(name)
    if a.kind not in ("atomic", "wal"):
        raise ValueError(f"artifact {name!r} is kind={a.kind!r}; "
                         "atomic_write serves atomic|wal artifacts")
    if isinstance(data, str):
        data = data.encode("utf-8")
    with _writing(a):
        _write_bytes(a, path, data, chaos_point)
    return path


@contextmanager
def wal_writer(name: str) -> Iterator[Callable[..., str]]:
    """Record writer for a `wal` artifact: yields
    `write(path, data, chaos_point=None)` with the same tmp → fsync →
    rename discipline as atomic_write, under the WAL recovery contract
    (a complete tmp left by a crash is PROMOTED by recover(), a torn
    one discarded)."""
    a = artifact(name)
    if a.kind != "wal":
        raise ValueError(f"artifact {name!r} is kind={a.kind!r}; "
                         "wal_writer serves wal artifacts")

    def write(path: str, data,
              chaos_point: Optional[Callable[[str], None]] = None
              ) -> str:
        if isinstance(data, str):
            data = data.encode("utf-8")
        with _writing(a):
            _write_bytes(a, path, data, chaos_point)
        return path

    yield write


@contextmanager
def scratch(name: str, dir: Optional[str] = None,
            keep: Optional[str] = None) -> Iterator[str]:
    """A declared scratch tree: yields a fresh private directory and
    ALWAYS removes it on exit — success, failure, or sanitizer raise —
    the tmp-hygiene contract as an API instead of a per-tool finally.
    `keep` short-circuits to a caller-owned path that survives (bench
    --keep flows)."""
    a = artifact(name)
    if a.kind != "scratch":
        raise ValueError(f"artifact {name!r} is kind={a.kind!r}; "
                         "scratch serves scratch artifacts")
    if keep:
        os.makedirs(keep, exist_ok=True)
        PERSIST_WRITES.labels(name=name).inc()
        yield keep
        return
    path = tempfile.mkdtemp(prefix=name.replace(".", "-") + "-",
                            dir=dir)
    PERSIST_WRITES.labels(name=name).inc()
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def seal(name: str, tmp_path: str, final_path: str) -> str:
    """Seal a STREAMED body: the caller wrote `tmp_path` incrementally
    (multi-GB encrypt/transcode outputs that cannot buffer in memory);
    this applies the declared tail — fsync(file) per policy → atomic
    replace → fsync(dir) — so a crash never leaves a truncated file
    that passes for a valid artifact."""
    a = artifact(name)
    if a.kind != "atomic":
        raise ValueError(f"artifact {name!r} is kind={a.kind!r}; "
                         "seal serves atomic artifacts")
    with _writing(a):
        if a.fsync in ("always", "file-only"):
            fd = os.open(tmp_path, os.O_RDONLY)
            try:
                _timed_fsync(fd)
            finally:
                os.close(fd)
            crashpoint(a.name, "fsync-file")
        os.replace(tmp_path, final_path)
        crashpoint(a.name, "renamed")
        if a.fsync == "always":
            _fsync_dir(os.path.dirname(final_path))
    PERSIST_WRITES.labels(name=a.name).inc()
    return final_path


def db_write(name: str, rows: int = 1) -> None:
    """Record a commit of a DB-backed `append` artifact (job-scratch
    spool rows and kin). Durability is DELEGATED to SQLite's WAL (the
    group-commit actor's kill -9 storm proves it); this seam gives the
    artifact a declared name, a row in the table, and write counts."""
    a = artifact(name)
    if a.kind != "append":
        raise ValueError(f"artifact {name!r} is kind={a.kind!r}; "
                         "db_write serves append artifacts")
    PERSIST_WRITES.labels(name=a.name).inc(max(1, rows))


def recover(name: str, directory: str,
            validate: Optional[Callable[[bytes], bool]] = None
            ) -> List[Tuple[str, str]]:
    """Next-boot sweep of `directory` for artifact `name`'s tmp
    residue. Returns [(path, outcome)]: `wal` artifacts promote a
    complete tmp whose bytes pass `validate` (fsyncing BEFORE the
    promote rename — the promoted content must be durable too) and
    discard the rest; `atomic` artifacts discard all residue (the
    final file is already old-or-new, never torn). Promoted paths are
    the final (renamed) names."""
    a = artifact(name)
    out: List[Tuple[str, str]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    with _writing(a):
        for fn in names:
            if not fn.endswith(".tmp"):
                continue
            path = os.path.join(directory, fn)
            final = path[:-len(".tmp")]
            promoted = False
            if a.kind == "wal" and validate is not None:
                try:
                    with open(path, "rb") as f:
                        raw = f.read()
                    if validate(raw):
                        fd = os.open(path, os.O_RDONLY)
                        try:
                            _timed_fsync(fd)
                        finally:
                            os.close(fd)
                        os.replace(path, final)
                        _fsync_dir(directory)
                        promoted = True
                except (OSError, ValueError):
                    promoted = False
            if promoted:
                out.append((final, "promoted"))
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                out.append((path, "discarded"))
    return out


# -- runtime twin: the fs auditor -------------------------------------------

_armed = False
_mode = "count"
_recorder: Optional[Callable[[str, str, bool], None]] = None
_orig_replace: Optional[Callable[..., Any]] = None
_orig_fsync: Optional[Callable[..., Any]] = None

# (st_dev, st_ino) of recently-fsynced files, insertion-ordered.
# Bounded: the auditor's memory of "this inode was fsynced" only has
# to outlive the fsync → rename gap of in-flight writes.
_FSYNCED_CAP = 512
_fsynced: Dict[Tuple[int, int], bool] = {}
_fsynced_lock = threading.Lock()

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SELF_FILE = os.path.abspath(__file__)


def armed() -> bool:
    return _armed


def _report(kind: str, detail: str) -> None:
    PERSIST_VIOLATIONS.labels(kind=kind).inc()
    rec = _recorder
    if rec is not None:
        rec(kind, detail, True)  # raise-mode surfaces at the call site


def _note_fsynced(fd: int) -> None:
    try:
        st = os.fstat(fd)
    except OSError:
        return
    with _fsynced_lock:
        _fsynced[(st.st_dev, st.st_ino)] = True
        while len(_fsynced) > _FSYNCED_CAP:
            del _fsynced[next(iter(_fsynced))]


def _was_fsynced(path: str) -> bool:
    try:
        st = os.stat(path)
    except OSError:
        return True  # already renamed/raced away: nothing to judge
    with _fsynced_lock:
        return (st.st_dev, st.st_ino) in _fsynced


def _audited_fsync(fd):
    _note_fsynced(fd)
    return _orig_fsync(fd)


def _audited_replace(src, dst, *, src_dir_fd=None, dst_dir_fd=None):
    ctx = _current_write()
    if ctx is not None:
        # Inside the persist seam: verify the declared fsync-before-
        # rename ordering actually happened (belt and braces over the
        # writer's own code path — a policy regression fails tier-1).
        if ctx.fsync in ("always", "file-only") and \
                not _was_fsynced(os.fspath(src)):
            _report(
                "persist_unfsynced_rename",
                f"artifact {ctx.name!r}: rename of {src!r} with no "
                f"preceding fsync (declared policy {ctx.fsync!r})")
    else:
        # Raw os.replace from a product module is an undeclared
        # durable write — route it through the persist registry.
        caller = sys._getframe(1).f_code.co_filename
        try:
            caller = os.path.abspath(caller)
        except (OSError, ValueError):
            caller = ""
        if caller.startswith(_PKG_DIR + os.sep) and \
                caller != _SELF_FILE:
            rel = os.path.relpath(caller, os.path.dirname(_PKG_DIR))
            _report(
                "persist_undeclared_write",
                f"raw os.replace({os.fspath(src)!r} -> "
                f"{os.fspath(dst)!r}) from {rel} outside the persist "
                "seam — declare the artifact and write it by name")
    return _orig_replace(src, dst, src_dir_fd=src_dir_fd,
                         dst_dir_fd=dst_dir_fd)


def _is_builtin(fn) -> bool:
    return type(fn).__name__ == "builtin_function_or_method"


def arm(mode: str, record: Callable[[str, str, bool], None]) -> None:
    """Interpose os.replace/os.fsync (sanitize.install() calls this
    unless SDTPU_FS_AUDIT=off). Violations flow through `record` into
    the sanitizer's shared list/counter and raise in raise mode."""
    global _armed, _mode, _recorder, _orig_replace, _orig_fsync
    if _armed:
        return
    if flags.get("SDTPU_FS_AUDIT") == "off":
        return
    if not (_is_builtin(os.replace) and _is_builtin(os.fsync)):
        # Another auditor already interposes (the JAX package's, when
        # both packages share a process): it stays the one that judges
        # the caller's frame, and this seam does not stack over it.
        return
    _mode = mode
    _recorder = record
    _orig_replace = os.replace
    _orig_fsync = os.fsync
    os.replace = _audited_replace
    os.fsync = _audited_fsync
    _armed = True


def disarm() -> None:
    global _armed, _recorder, _orig_replace, _orig_fsync
    if not _armed:
        return
    if _orig_replace is not None:
        os.replace = _orig_replace
        _orig_replace = None
    if _orig_fsync is not None:
        os.fsync = _orig_fsync
        _orig_fsync = None
    _recorder = None
    with _fsynced_lock:
        _fsynced.clear()
    _armed = False


# -- docs --------------------------------------------------------------------

def artifact_table_markdown() -> str:
    """README's generated durable-artifact inventory (the flag/
    timeout/channel/statement table idiom): one row per declared
    artifact, straight from the registry."""
    lines = [
        "| artifact | path | kind | fsync | recovery |",
        "|---|---|---|---|---|",
    ]
    for name in sorted(ARTIFACTS):
        a = ARTIFACTS[name]
        lines.append(
            f"| `{a.name}` | `{a.path_pattern}` | {a.kind} | "
            f"{a.fsync} | {a.recovery} |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The artifact inventory — THE durable-state namespace. Every durable
# write anywhere in the engine names one of these; sdlint's
# io-durability pass fails on undeclared or dynamic names, and
# tests/test_persist.py's drift check fails on a declared artifact
# nothing writes (or a write site naming an undeclared artifact).
# tools/crash_grid.py SIGKILLs a child at every edges_for() edge of
# every atomic/wal row and asserts valid-or-absent recovery.
# ---------------------------------------------------------------------------

declare_artifact(
    "incidents.bundle", "incidents/<id>.json", "wal", "always",
    "Complete `.json.tmp` promoted at next boot (schema-validated), "
    "torn tmp discarded; a reader never sees a torn final bundle "
    "(incidents.py _recover).")

declare_artifact(
    "incidents.marker", "incidents/.running", "atomic", "none",
    "Presence after a crash IS the signal (becomes the `crash` "
    "bundle); removed by orderly close(). Torn/absent marker reads "
    "as a clean exit — advisory, so no fsync cost per boot.")

declare_artifact(
    "library.config", "libraries/<uuid>.sdlibrary", "atomic",
    "always",
    "Old-or-new after any crash (atomic replace); load parses the "
    "surviving JSON, tmp residue is ignored by the `*.sdlibrary` "
    "load filter and swept by recover().")

declare_artifact(
    "library.db_image", "libraries/<uuid>.db (backup restore)",
    "atomic", "always",
    "Backup restore is re-runnable from the zip: a crashed restore "
    "leaves old-or-new db bytes, never torn; restore order (db "
    "before config) means a config never points at an absent db.")

declare_artifact(
    "node.config", "node_state.sdconfig", "atomic", "always",
    "Old-or-new after any crash; Node boot re-reads the surviving "
    "JSON and regenerates defaults when absent.")

declare_artifact(
    "crypto.keyring", "keys.json", "atomic", "always",
    "Old-or-new after any crash — key material must never tear; a "
    "lost most-recent write re-enrolls the key, a torn file would "
    "lose the whole ring.")

declare_artifact(
    "media.thumbnail", "thumbnails/<shard>/<cas_id>.webp", "atomic",
    "none",
    "Regenerable cache: absent → re-encoded on demand; atomic "
    "replace keeps readers off torn webp bytes; no fsync (a power "
    "loss costs a re-encode, not correctness).")

declare_artifact(
    "media.thumbs_version", "thumbnails/version.txt", "atomic",
    "none",
    "Cache-format version stamp; absent → rewritten at next "
    "ensure_thumbnail_dir, mismatched → cache regenerated.")

declare_artifact(
    "object.sealed", "<target>.part -> <target> (.sdtpu seal)",
    "atomic", "always",
    "Streamed encrypt output sealed by fsync + rename: a crash "
    "leaves the `.part` (removed by the job's error path / re-run), "
    "never a truncated file that passes for a valid .sdtpu.")

declare_artifact(
    "stage.h2d_cache", "<cache_dir>/h2d_probe.json", "atomic",
    "none",
    "Link-probe cache: stale/torn/absent → re-probe (~ms); key "
    "mismatch is already a re-probe, so crash loss is free.")

declare_artifact(
    "flight.trace", "<--trace out>.json (chrome trace)", "atomic",
    "none",
    "Bench artifact: re-run the bench; atomic replace means "
    "chrome://tracing and trace_export never read torn JSON.")

declare_artifact(
    "bench.artifact", "<--json out> (BENCH result doc)", "atomic",
    "none",
    "Bench artifact: re-run the bench; atomic replace means "
    "bench_trend.py never chokes on a torn half-JSON from a crashed "
    "run.")

declare_artifact(
    "bench.workdir", "$TMPDIR/bench-workdir-* (scratch tree)",
    "scratch", "none",
    "Always removed on exit (success OR failure) by scratch(); a "
    "surviving tree is a tmp-hygiene violation, not state.")

declare_artifact(
    "job.scratch", "libraries/<uuid>.db `job_scratch` rows",
    "append", "delegated",
    "SQLite WAL owns durability (group-commit kill -9 storm proves "
    "it): spooled rows land all-or-nothing per tx; resume consumes "
    "surviving rows, unspool deletes them.")
