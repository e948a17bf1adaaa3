"""Central kernel contract registry — the port's twin of the JAX package's
``ops/jit_registry.py``.

Every kernel launch site of the port and every declared host fetch of a
kernel result DECLARES its contract here: the kernel forms it launches,
which dtypes cross the boundary, its shape policy, and whether its results
are expected to come back to the host. Contracts keep the JAX package's
names where the port has a counterpart of a ``declare_jit`` entry (the
list is the table at the bottom), so ``sd_jit_declared_transfers_total``
reads the same ``fn`` labels on either package.

At runtime:

- ``device_scope(label)`` is a guarded region around a device pipeline.
  It names the region with ``torch.profiler.record_function(label)`` and
  an NVTX range (``tracing.region``), so the JAX labels
  (``identify.hash``, ``seqhash.reduce``, ``phash.batch``,
  ``hamming.pairs``) name the kernels' regions in a profiler trace, and
  launches inside it are counted per label (``scope_counts``). When the
  sanitizer armed this module, an open scope arms
  ``torch.cuda.set_sync_debug_mode``: ``"error"`` in raise mode (a
  synchronizing CUDA call raises and is recorded as ``host_transfer``),
  ``"warn"`` in count mode (a warning, as JAX's ``log`` level, no counter).
- ``io(name)`` is a DECLARED host fetch: the contract must exist with
  ``host_transfer=True``; inside, the guard is lifted and the fetch counts
  into ``sd_jit_declared_transfers_total{fn}``. An ``io`` scope on an
  undeclared name is itself a violation.
- ``note_launch(form)`` is called by the wrappers where they add one to
  their ``launches`` dicts (``blake3_cuda.launches``,
  ``hamming_cuda.launches``), which stay the launch counts;
  ``launch_counts`` reads them.

``sd_jit_retraces_total`` and ``sd_jit_cache_size`` have nothing to count
here: a hand-written kernel is built once per process by ``nvcc`` and
launched with any shape, there is no trace cache to grow. Both families
stay declared (telemetry.py) and stay at 0.

What the guard sees, and what it does not. ``set_sync_debug_mode`` is
process-wide, while JAX's transfer guard is local to a context: an open
scope on one thread arms the guard for every thread, and an open ``io``
scope on one thread lifts it for every thread. The registry keeps counts
of open scopes and open ``io`` scopes under one lock and sets the mode
from them. The guard sees what torch itself synchronizes on: ``.item()``,
``.cpu()`` / ``.tolist()`` / ``.numpy()`` of a CUDA tensor, a blocking
copy in either direction (a pageable host-to-device ``.to(device)``
included), ``torch.nonzero`` and other ops whose output size depends on
the data. It does not see a synchronization inside the ``ctypes``
launchers (a ``cudaStreamSynchronize`` in C), an explicit
``torch.cuda.synchronize()``, or an event's ``synchronize()``. The
witness is ``chip_smoke.py``'s phase 15 (e): ``.item()`` on a CUDA tensor
inside ``device_scope`` raises there and lands in the sanitizer's list as
``host_transfer``.

Pure stdlib at import time: torch is imported where a scope touches it.
"""

from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

from .. import flags, tracing
from ..telemetry import JIT_DECLARED_TRANSFERS

__all__ = [
    "KernelContract", "CONTRACTS", "declare_kernel", "io", "device_scope",
    "arm", "disarm", "armed", "note_launch", "launch_counts", "scope_counts",
    "reset_scope_counts", "guard_mode",
]


@dataclass(frozen=True)
class KernelContract:
    """One launch site's (or one declared fetch's) declared behaviour.

    `site` is the ``relpath::qualname`` of the port's function; `replaces`
    the JAX contract it stands for (the same name where the port keeps
    it). `kernels` are the kernel forms the site launches (keys of the
    wrappers' ``launches`` dicts)."""

    name: str
    site: str
    replaces: str = ""
    kind: str = "entry"            # "entry" | "wrapper"
    kernels: Tuple[str, ...] = ()
    in_dtypes: Tuple[str, ...] = ()
    out_dtypes: Tuple[str, ...] = ()
    shape_buckets: str = ""
    host_transfer: bool = False    # results fetched via io(name)


CONTRACTS: Dict[str, KernelContract] = {}


def declare_kernel(name: str, site: str, *, replaces: str = "",
                   kind: str = "entry", kernels: Tuple[str, ...] = (),
                   in_dtypes: Tuple[str, ...] = (),
                   out_dtypes: Tuple[str, ...] = (),
                   shape_buckets: str,
                   host_transfer: bool = False) -> KernelContract:
    if name in CONTRACTS:
        raise ValueError(f"kernel contract {name!r} declared twice")
    if kind not in ("entry", "wrapper"):
        raise ValueError(f"{name}: unknown contract kind {kind!r}")
    if not shape_buckets.strip():
        raise ValueError(f"{name}: every contract must state its shape policy")
    c = KernelContract(name, site, replaces, kind, tuple(kernels),
                       tuple(in_dtypes), tuple(out_dtypes), shape_buckets,
                       host_transfer)
    CONTRACTS[name] = c
    return c


# -- runtime arming ---------------------------------------------------------
# sanitize.install() arms this module with its mode and its violation
# recorder; the callback keeps the import graph acyclic.

_armed = False
_mode = "count"
_record: Optional[Callable[[str, str, bool], None]] = None

_guard_lock = threading.Lock()
_open_scopes = 0   # device scopes open with the guard armed, all threads
_open_io = 0       # io scopes open inside them, all threads
_applied = "default"  # the sync debug mode last set

_label: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sdtpu_kernel_scope", default="")
_scope_lock = threading.Lock()
_scoped: Dict[Tuple[str, str], int] = {}


def arm(mode: str, record: Callable[[str, str, bool], None]) -> None:
    global _armed, _mode, _record
    _mode = mode
    _record = record
    _armed = True


def disarm() -> None:
    global _armed, _record
    _armed = False
    _record = None


def armed() -> bool:
    return _armed


def _guard_level() -> Optional[str]:
    """The sync debug mode an open scope arms, or None when off. `auto`
    follows the sanitizer mode: error under raise, warn under count."""
    if not _armed:
        return None
    mode = flags.get("SDTPU_TRANSFER_GUARD")
    if mode == "off":
        return None
    if mode == "auto":
        return "error" if _mode == "raise" else "warn"
    return {"raise": "error", "log": "warn"}.get(mode)


def _apply(level: str) -> None:
    """Set torch's process-wide sync debug mode to match the open scopes
    (caller holds _guard_lock)."""
    global _applied
    want = level if _open_scopes > 0 and _open_io == 0 else "default"
    if want == _applied:
        return
    import torch

    if torch.cuda.is_available():  # without CUDA there is nothing to guard
        torch.cuda.set_sync_debug_mode(want)
        _applied = want


def guard_mode() -> str:
    """The sync debug mode the registry set last (diagnostics)."""
    return _applied


def _is_sync_error(e: BaseException) -> bool:
    return "synchronizing cuda operation" in str(e).lower()


# -- launches ---------------------------------------------------------------

def note_launch(form: str) -> None:
    """One launch of kernel `form`, counted under the innermost open
    device scope's label ("" outside any scope)."""
    key = (_label.get(), form)
    with _scope_lock:
        _scoped[key] = _scoped.get(key, 0) + 1


def scope_counts() -> Dict[Tuple[str, str], int]:
    """(device-scope label, kernel form) → launches since the last
    reset_scope_counts()."""
    with _scope_lock:
        return dict(_scoped)


def reset_scope_counts() -> None:
    with _scope_lock:
        _scoped.clear()


def launch_counts() -> Dict[str, int]:
    """Kernel form → launches, read from the wrappers' ``launches`` dicts
    (reset with their ``reset_launches``)."""
    from . import blake3_cuda, hamming_cuda

    return {**blake3_cuda.launches, **hamming_cuda.launches}


# -- scopes -----------------------------------------------------------------

@contextmanager
def device_scope(label: str = "") -> Iterator[None]:
    """Guarded, named region around kernel launches (module docstring)."""
    global _open_scopes
    level = _guard_level()
    token = _label.set(label)
    if level is not None:
        with _guard_lock:
            _open_scopes += 1
            _apply(level)
    try:
        with tracing.region(label or "device_scope"):
            yield
    except Exception as e:
        if level is not None and _is_sync_error(e) and _record is not None:
            # Record for telemetry/violations(), then let torch's own
            # error surface with the offending line in its traceback.
            _record("host_transfer",
                    f"undeclared synchronizing CUDA call in device scope "
                    f"{label or '?'}: {e}", False)
        raise
    finally:
        _label.reset(token)
        if level is not None:
            with _guard_lock:
                _open_scopes -= 1
                _apply(level)


@contextmanager
def io(name: str) -> Iterator[None]:
    """A DECLARED host fetch (module docstring)."""
    global _open_io
    contract = CONTRACTS.get(name)
    if contract is None or not contract.host_transfer:
        if _armed and _record is not None:
            _record("host_transfer",
                    f"io({name!r}): not a declared host-transfer contract "
                    f"(declare it with host_transfer=True in "
                    f"spacedrive_tpu_torch/ops/kernel_registry.py)", True)
        yield
        return
    if _armed:
        JIT_DECLARED_TRANSFERS.labels(fn=name).inc()
    level = _guard_level()
    if level is not None:
        with _guard_lock:
            _open_io += 1
            _apply(level)
    try:
        with tracing.region(name):
            yield
    finally:
        if level is not None:
            with _guard_lock:
                _open_io -= 1
                _apply(level)


# ---------------------------------------------------------------------------
# THE kernel namespace: one contract for each of the JAX package's 22 jit
# contracts that has a counterpart in the port, under the JAX name, plus
# the port's fold (no JAX contract: jnp's tree_reduce ran inside the
# blake3 programs). The JAX contracts without a counterpart:
#   blake3.sharded, hamming.sharded, hamming.pyramid — multi-GPU
#     (ROADMAP queue A item 8);
#   blake3.donated — torch has no donation: the ring recycles its
#     pinned pages itself (ops/overlap.py);
#   hamming.tile — the port has no distance tile of its own: the mask
#     form computes distances and the mask in one kernel
#     (hamming.near_mask), as it replaces hamming_tile + _near_mask_tile;
#   hamming.refine, hamming.leaf_masks — the count form serves every
#     pyramid level (hamming.tile_counts);
#   staging.h2d_probe — the port does not probe its link.
# ---------------------------------------------------------------------------

_K1 = "blake3_chunk_fast"
_K2 = "blake3_chunk_windowed"
_FOLD = "blake3_tree_fold"
_MASK = "hamming_near_mask"
_COUNTS = "hamming_near_counts"

declare_kernel(
    "blake3.jnp", "spacedrive_tpu_torch/ops/blake3_torch.py::blake3_words",
    replaces="blake3.jnp", kernels=(_K1, _FOLD),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="any [B, C, 256] grid: the kernel takes B and C as "
                  "arguments (identify stages C = 57 / 101)")

declare_kernel(
    "blake3.pallas.chunk_fast",
    "spacedrive_tpu_torch/ops/blake3_cuda.py::chunk_cvs_fast",
    replaces="blake3.pallas.chunk_fast", kernels=("blake3_chunk_fast_cvs",),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="[B, C, 256] grids; the CV form runs only in parity checks")

declare_kernel(
    "blake3.pallas.chunk",
    "spacedrive_tpu_torch/ops/blake3_cuda.py::chunk_cvs",
    replaces="blake3.pallas.chunk", kernels=("blake3_chunk_windowed_cvs",),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="[B, C, 256] grids with a counter base; parity checks only")

declare_kernel(
    "blake3.pallas.words",
    "spacedrive_tpu_torch/ops/blake3_cuda.py::blake3_words",
    replaces="blake3.pallas.words", kernels=(_K1, _FOLD),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="K1 fused + the fold: chunk stage and tree in one pass")

declare_kernel(
    "blake3.tree_fold",
    "spacedrive_tpu_torch/ops/blake3_cuda.py::_fold",
    kind="wrapper", kernels=(_FOLD,),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="[B, n, 8] span tops folded by up to 128 a launch "
                  "(the port's own: no JAX contract)")

declare_kernel(
    "cas.ids", "spacedrive_tpu_torch/ops/staging.py::_cas_ids_packed",
    replaces="cas.ids", kind="wrapper", kernels=(_K1, _FOLD),
    host_transfer=True, out_dtypes=("str",),
    shape_buckets="one launch per size class a step (C = 57 / 101); the "
                  "[B, 8] digest fetch is this wrapper's contract")

declare_kernel(
    "cas.checksums",
    "spacedrive_tpu_torch/ops/blake3_torch.py::checksums_words_batched",
    replaces="cas.checksums", kind="wrapper", kernels=(_K1, _FOLD),
    host_transfer=True, out_dtypes=("str",),
    shape_buckets="one validator page of small files in one grid; the "
                  "hex digests are host strings — the fetch is declared")

declare_kernel(
    "hamming.near_mask",
    "spacedrive_tpu_torch/ops/hamming_cuda.py::hamming_near_mask",
    replaces="hamming.near_mask", kernels=(_MASK,),
    in_dtypes=("int32",), out_dtypes=("bool",),
    shape_buckets="one [N, N] launch for N <= the 4096 tile")

declare_kernel(
    "hamming.tile_counts",
    "spacedrive_tpu_torch/ops/hamming_cuda.py::hamming_near_counts",
    replaces="hamming.tile_counts", kernels=(_COUNTS,),
    in_dtypes=("int32", "int64"), out_dtypes=("int32",),
    shape_buckets="up to BLOCKS_PER_DISPATCH blocks a launch, every "
                  "pyramid level (the JAX refine and leaf programs too)")

declare_kernel(
    "hamming.pairs", "spacedrive_tpu_torch/ops/hamming.py::near_dup_pairs",
    replaces="hamming.pairs", kind="wrapper", kernels=(_MASK, _COUNTS),
    host_transfer=True, out_dtypes=("int64",),
    shape_buckets="bounded dispatch count (pyramid levels); pair "
                  "coordinates and per-tile sums are host output — the "
                  "fetches are declared here")

declare_kernel(
    "seqhash.reduce",
    "spacedrive_tpu_torch/ops/seqhash.py::StreamingChecksum._window_top",
    replaces="seqhash.reduce", kernels=(_K2, _FOLD, _K1),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="one [1, 8192, 256] window a launch (K2 + the fold); a "
                  "stream that fits one window takes K1 once")

declare_kernel(
    "seqhash.window",
    "spacedrive_tpu_torch/ops/seqhash.py::StreamingChecksum",
    replaces="seqhash.window", kind="wrapper", host_transfer=True,
    out_dtypes=("int32",),
    shape_buckets="window tops and digests are 8-word fetches — the D2H "
                  "per window is this wrapper's contract")

declare_kernel(
    "phash.batch", "spacedrive_tpu_torch/ops/phash.py::phash_torch",
    replaces="phash.batch", host_transfer=True,
    in_dtypes=("float64",), out_dtypes=("bool",),
    shape_buckets="[B, 32, 32] grids, torch matmuls (no hand kernel); the "
                  "bit fetch is declared")

declare_kernel(
    "overlap.kernel", "spacedrive_tpu_torch/ops/overlap.py::_Ring.dispatch",
    replaces="overlap.kernel", kernels=(_K1, _FOLD),
    in_dtypes=("int32",), out_dtypes=("int32",),
    shape_buckets="one large-class batch grid a run, launched on the "
                  "ring's compute stream")

declare_kernel(
    "overlap.retire", "spacedrive_tpu_torch/ops/overlap.py::run_overlapped",
    replaces="overlap.retire", kind="wrapper", host_transfer=True,
    out_dtypes=("int32",),
    shape_buckets="digest retirement is the ring's declared D2H point")
