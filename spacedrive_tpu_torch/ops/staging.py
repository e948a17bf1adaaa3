"""CAS staging: files → dense payload batches → CAS IDs, per backend.

Port of ``spacedrive_tpu/ops/staging.py`` (the identifier's feeding layer:
upstream core/src/object/file_identifier/mod.rs:107-134 →
core/src/object/cas.rs:23-62 hashes one file at a time; here whole batches
are staged into dense arrays and hashed at once).

Size classes keep the device grids canonical:
- LARGE (> 100 KiB): exactly 57,344 sampled bytes per row → a C = 57 grid.
- SMALL (≤ 100 KiB): whole file, zero-padded → a C = 101 grid with lengths.
Empty files get no CAS ID (``None``), matching FileMetadata::new
(mod.rs:80-88).

Two staging planes:
- ``stage_batch_native``: the native C++ plane (``native.stage_batch``)
  writes each row straight in the kernel's message layout,
  ``le64(size) ‖ payload ‖ zeros``, into a page of a ``StagePool``. The
  pages of a pool that serves a CUDA device are pinned, so the page goes
  to the card with one non-blocking copy. A row the C plane fails is
  retried by the Python reader into the same row; the identify main path
  and the depth-N ring (``ops/overlap.py``) stage this way.
- ``stage_files``: two dense payload arrays per call, read by the
  pure-Python readers, then packed by ``build_cas_messages``. The
  ``"plain"`` and ``"oracle"`` backends stage this way, which keeps the
  plain reference independent of the C plane. ``_stage_files_native``
  gives the same arrays from the C plane's ``stage_large`` /
  ``stage_small``.

Backends of ``cas_ids_for_files``:
- ``"oracle"``: streaming pure-Python BLAKE3 per file (the parity oracle).
- ``"plain"``: the plain torch version on the CPU.
- ``"cuda"``: native staging into pinned pages, the fused CUDA chunk +
  tree kernel on the GPU.

Left out of this slice, each for a reason:
- The link-probe auto policy (``auto_device_batch``,
  ``device_pipeline_worthwhile``, ``h2d_gbps``, ``default_backend``) would
  silently route work to a CPU plane, so ``"auto"`` is not a backend here.
- The fused native CPU hasher (``_cas_ids_native_fused``, the ``"native"``
  backend) waits for the port's copy of ``sd_cas_digests``.
- The whole-batch degradation of the JAX package's ``stage_batch_native``
  (flag off, library missing, pool exhausted): here a missing library
  raises and an exhausted pool blocks until a lease returns.
- Telemetry, spans, chaos points and flight-recorder events wait for the
  port's registry twins.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import blake3_batch as bb
from . import blake3_cuda, blake3_torch, cas, kernel_registry
from .. import chaos, native, tracing
from ..flight import RECORDER
from ..telemetry import (IDENT_BATCHES, IDENT_BATCH_FILES, IDENT_BYTES_HASHED,
                         IDENT_READ_ERRORS)

_CHUNK_SEQ = itertools.count(1).__next__


def default_threads() -> int:
    """C-plane threads for one staging call: the cores this process may
    run on."""
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 4


@dataclass
class StagedBatch:
    """Dense payload arrays for one size class."""

    indexes: List[int]          # positions in the caller's file list
    payloads: np.ndarray        # [B, P] uint8, zero-padded
    sizes: np.ndarray           # [B] uint64 declared file sizes
    payload_lens: np.ndarray    # [B] int32 real payload bytes per row


def _read_large(path: str, size: int, out: np.ndarray) -> None:
    """Sampled read into a 57,344-byte row (cas.rs:23-59 spec)."""
    with open(path, "rb") as f:
        pos = 0
        spec = cas.sample_spec(size)
        for offset, length in spec[:-1]:
            f.seek(offset)
            chunk = f.read(length)
            if len(chunk) != length:
                raise EOFError(f"{path}: short read at {offset}")
            out[pos:pos + length] = np.frombuffer(chunk, dtype=np.uint8)
            pos += length
        f.seek(-cas.HEADER_OR_FOOTER_SIZE, os.SEEK_END)
        chunk = f.read(cas.HEADER_OR_FOOTER_SIZE)
        if len(chunk) != cas.HEADER_OR_FOOTER_SIZE:
            raise EOFError(f"{path}: short footer read")
        out[pos:pos + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)


def _read_small(path: str, size: int, out: np.ndarray) -> int:
    """Whole-file read of a small file into `out`; returns its length. A
    file that grew past the small class is an ``EOFError``."""
    with open(path, "rb") as f:
        data = f.read(cas.MINIMUM_FILE_SIZE + 1)
    if len(data) > cas.MINIMUM_FILE_SIZE:
        raise EOFError(f"{path}: grew past declared size {size}")
    out[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return len(data)


def _classes(files: Sequence[Tuple[str, int]]):
    """(large, small, empty) indexes of (path, declared size) pairs."""
    large_idx = [i for i, (_, s) in enumerate(files)
                 if s > cas.MINIMUM_FILE_SIZE]
    small_idx = [i for i, (_, s) in enumerate(files)
                 if 0 < s <= cas.MINIMUM_FILE_SIZE]
    empty_idx = [i for i, (_, s) in enumerate(files) if s == 0]
    return large_idx, small_idx, empty_idx


def _stage_files_native(
    files, large_idx, small_idx, empty_idx, n_threads: int,
) -> Tuple[StagedBatch, StagedBatch, List[int], Dict[int, str]]:
    """``stage_files``' result through the C plane (``stage_large`` /
    ``stage_small``): no Python in the per-file loop, no per-file retry.
    No path of this slice stages this way; it is the counterpart of the
    JAX package's ``stage_files`` with its native plane on."""
    errors: Dict[int, str] = {}
    sizes = np.array([s for _, s in files], dtype=np.uint64)

    lpaths = [files[i][0] for i in large_idx]
    large, lstatus = native.stage_large(
        lpaths, sizes[large_idx] if large_idx else np.zeros(0, np.uint64),
        n_threads=n_threads)
    spaths = [files[i][0] for i in small_idx]
    small_wide, slens, sstatus = native.stage_small(
        spaths, cap=cas.MINIMUM_FILE_SIZE, n_threads=n_threads)
    small = small_wide[:, :cas.MINIMUM_FILE_SIZE]

    def filter_ok(idx_list, payloads, status, lens=None):
        bad_rows = np.nonzero(status != native.OK)[0]
        for row in bad_rows:
            errors[idx_list[row]] = (
                f"{files[idx_list[row]][0]}: "
                f"{native.STATUS_MESSAGES.get(int(status[row]), 'error')}")
        if len(bad_rows) == 0:
            return idx_list, payloads, lens
        ok = np.nonzero(status == native.OK)[0]
        return ([idx_list[r] for r in ok], payloads[ok],
                lens[ok] if lens is not None else None)

    large_idx, large, _ = filter_ok(large_idx, large, lstatus)
    small_idx, small, slens = filter_ok(small_idx, small, sstatus, slens)

    large_batch = StagedBatch(
        large_idx, large,
        sizes[large_idx] if large_idx else np.zeros(0, np.uint64),
        np.full((len(large_idx),), cas.LARGE_PAYLOAD_SIZE, dtype=np.int32))
    small_batch = StagedBatch(
        small_idx, small,
        sizes[small_idx] if small_idx else np.zeros(0, np.uint64),
        slens if slens is not None else np.zeros(0, np.int32))
    return large_batch, small_batch, empty_idx, errors


def stage_files(
    files: Sequence[Tuple[str, int]],
) -> Tuple[StagedBatch, StagedBatch, List[int], Dict[int, str]]:
    """Stage (path, size) pairs into dense per-class batches.

    Returns (large_batch, small_batch, empty_indexes, errors) where errors
    maps file index → message: unreadable files are skipped and the caller
    records them as non-fatal errors. A declared size larger than the file
    is an ``EOFError`` short read; a small file that grew past 100 KiB is
    an error too. The pure-Python readers run: this is the plain reference
    that the C plane is held against.
    """
    large_idx, small_idx, empty_idx = _classes(files)
    errors: Dict[int, str] = {}

    large = np.zeros((len(large_idx), cas.LARGE_PAYLOAD_SIZE), dtype=np.uint8)
    small = np.zeros((len(small_idx), cas.MINIMUM_FILE_SIZE), dtype=np.uint8)
    small_lens = np.zeros((len(small_idx),), dtype=np.int32)

    def read_one(kind: str, row: int, idx: int) -> None:
        path, size = files[idx]
        try:
            if kind == "large":
                _read_large(path, size, large[row])
            else:
                small_lens[row] = _read_small(path, size, small[row])
        except OSError as e:
            errors[idx] = f"{path}: {e}"
        except EOFError as e:
            errors[idx] = str(e)

    jobs = [("large", row, idx) for row, idx in enumerate(large_idx)] + \
           [("small", row, idx) for row, idx in enumerate(small_idx)]
    workers = min(32, (os.cpu_count() or 4) * 2)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="cas-stage") as pool:
        for fut in [pool.submit(read_one, *job) for job in jobs]:
            fut.result()

    sizes = np.array([s for _, s in files], dtype=np.uint64)
    large_batch = StagedBatch(
        large_idx, large,
        sizes[large_idx] if large_idx else np.zeros((0,), np.uint64),
        np.full((len(large_idx),), cas.LARGE_PAYLOAD_SIZE, dtype=np.int32))
    small_batch = StagedBatch(
        small_idx, small,
        sizes[small_idx] if small_idx else np.zeros((0,), np.uint64),
        small_lens)
    return large_batch, small_batch, empty_idx, errors


# -- native packed staging (the pinned ring feed) ---------------------------
#
# The classic path above stages per-class payload matrices and then pays a
# build_cas_messages pass (a fresh [B, C*1024] buffer, prefixes, a copy of
# every payload) before each host-to-device copy. The packed path hands the
# C plane a page of a StagePool and has it write the kernel's message
# layout directly. A page is the copy's source, so it returns to the pool
# only after that copy has completed.


@dataclass
class StageLease:
    """One checked-out page: `arr` is its [rows, stride] uint8 grid view and
    `lengths` its [rows] int32 view of the message lengths, stored after the
    grid so one pinned page carries both copy sources."""

    page: torch.Tensor       # the pool's whole page (pinned for a CUDA pool)
    arr: np.ndarray          # [rows, stride] uint8 view at the page's start
    lengths: np.ndarray      # [rows] int32 view right after the grid
    _pool: "StagePool"
    _released: bool = False

    def tensors(self, chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int32 [rows, chunks, 256] words, int32 [rows] lengths) views of
        the page: the sources of the host-to-device copy, no host copy."""
        rows, stride = self.arr.shape
        grid = rows * stride
        words = self.page[:grid].view(torch.int32).view(rows, chunks, bb.WORDS_PER_CHUNK)
        return words, self.page[grid:grid + 4 * rows].view(torch.int32)

    def release(self) -> None:
        """Return the page. Only once no copy still reads it."""
        if not self._released:
            self._released = True
            self._pool._put_back(self.page)


class StagePool:
    """A fixed set of staging pages, allocated once.

    The pages are ``torch.empty(page_bytes, dtype=uint8)``, pinned when the
    pool serves a CUDA device (so a copy from them runs without blocking)
    and ordinary host memory when it serves the CPU. ``acquire`` hands out a
    free page and blocks until a lease returns when every page is out; it
    never allocates past the pool. Size the pool from the work it feeds: one
    page per batch that can be in flight (the identify path holds two, the
    ring ``depth + 1``).
    """

    def __init__(self, device, pages: int, page_bytes: int) -> None:
        if pages < 1 or page_bytes < 1:
            raise ValueError(f"a pool needs pages >= 1 and page_bytes >= 1, "
                             f"got {pages}, {page_bytes}")
        self.device = blake3_torch.resolve_device(device)
        self.pinned = self.device.type == "cuda"
        self.page_bytes = int(page_bytes)
        t0 = time.perf_counter()
        self._pages = [torch.empty(self.page_bytes, dtype=torch.uint8,
                                   pin_memory=self.pinned) for _ in range(pages)]
        self.alloc_s = time.perf_counter() - t0
        self._free = list(self._pages)
        self._cond = threading.Condition()

    @staticmethod
    def bytes_for(rows: int, stride: int) -> int:
        """Page bytes a batch of `rows` rows at `stride` needs (grid + lengths)."""
        return rows * stride + 4 * rows

    @property
    def pages(self) -> int:
        return len(self._pages)

    @property
    def pinned_bytes(self) -> int:
        return self.pages * self.page_bytes if self.pinned else 0

    @property
    def in_use(self) -> int:
        with self._cond:
            return len(self._pages) - len(self._free)

    def acquire(self, rows: int, stride: int) -> StageLease:
        """Lease a page for `rows` rows at `stride`, waiting for a free one."""
        need = self.bytes_for(rows, stride)
        if need > self.page_bytes:
            raise ValueError(f"a batch of {rows} rows at stride {stride} needs "
                             f"{need} bytes; the pool's pages hold {self.page_bytes}")
        with self._cond:
            self._cond.wait_for(lambda: self._free)
            page = self._free.pop()
        buf = page.numpy()
        grid = rows * stride
        return StageLease(page, buf[:grid].reshape(rows, stride),
                          buf[grid:need].view(np.int32), self)

    def _put_back(self, page: torch.Tensor) -> None:
        with self._cond:
            self._free.append(page)
            self._cond.notify()


@dataclass
class NativeStaged:
    """A natively staged packed batch: row i corresponds to files[i].

    `words` / `lengths` are the kernel operands as numpy views of the page
    ([B, C, 256] uint32, [B] int32); ``tensors()`` gives the same memory as
    int32 tensors for the copy to the device. Rows listed in `errors` failed
    both the C plane and the per-file Python retry (scrubbed to the 8-byte
    prefix; ignore their digests); `empty_rows` are declared-empty files (no
    CAS ID); `fallback_files` counts rows the Python reader staged.
    """

    words: np.ndarray
    lengths: np.ndarray
    lease: StageLease
    errors: Dict[int, str]
    empty_rows: List[int]
    fallback_files: int = 0

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.lease.tensors(self.words.shape[1])

    def release(self) -> None:
        self.lease.release()


def _grid_for(payload_cap: int) -> Tuple[int, int]:
    """(chunk grid C, row stride) for a payload class: the exact
    build_cas_messages shape."""
    c = max(1, -(-(cas.SIZE_PREFIX_LEN + payload_cap) // bb.CHUNK_LEN))
    return c, c * bb.CHUNK_LEN


def _payload_cap(sizes: np.ndarray) -> int:
    """A batch with any small row is staged on the small grid (C = 101),
    else on the large one (C = 57)."""
    any_small = bool(np.any((sizes > 0) & (sizes <= cas.MINIMUM_FILE_SIZE)))
    return cas.MINIMUM_FILE_SIZE if any_small else cas.LARGE_PAYLOAD_SIZE


def stage_batch_native(
    files: Sequence[Tuple[str, int]], pool: StagePool, *,
    n_threads: Optional[int] = None,
) -> NativeStaged:
    """Stage a batch straight into a page of `pool` through the C plane.

    One ``native.stage_batch`` call (`n_threads` threads, default
    ``default_threads()``) writes every row. A row the C plane fails
    (vanished file, permission, short read) is retried by the Python reader
    into the same row, and the rest of the row is scrubbed; only a row that
    fails both lands in `errors`. A batch with any small row is staged at
    C = 101, else at C = 57. Waits for a page when the pool has none free.
    The caller releases the result once no copy reads its page.
    """
    n = len(files)
    if n == 0:
        raise ValueError("stage_batch_native needs at least one file")
    sizes = np.array([s for _, s in files], dtype=np.uint64)
    payload_cap = _payload_cap(sizes)
    grid_c, stride = _grid_for(payload_cap)
    lease = pool.acquire(n, stride)
    try:
        msg_lens, status = native.stage_batch(
            [p for p, _ in files], sizes, lease.arr, payload_cap,
            n_threads=n_threads or default_threads())
        if chaos.armed_point("stage.native.read"):
            f = chaos.hit("stage.native.read", only=("delay",))
            if f is not None:
                chaos.apply_sync(f)
            # Per-row draws: a probability storm speckles the batch (the
            # per-file ladder's degradation), not all or nothing.
            for r in range(n):
                f = chaos.hit("stage.native.read", only=("error", "corrupt"))
                if f is not None:
                    status[r] = (native.ERR_IO if f.kind == "error"
                                 else native.ERR_SHORT_READ)
        errors: Dict[int, str] = {}
        empty_rows: List[int] = []
        fallback = 0
        for r in np.nonzero(status != native.OK)[0]:
            r = int(r)
            if int(status[r]) == native.ERR_EMPTY:
                empty_rows.append(r)
                continue
            # Per-file ladder: the Python reader, into the same row.
            path, size = files[r]
            row = lease.arr[r]
            try:
                if size > cas.MINIMUM_FILE_SIZE:
                    _read_large(path, size, row[8:8 + cas.LARGE_PAYLOAD_SIZE])
                    plen = cas.LARGE_PAYLOAD_SIZE
                else:
                    plen = _read_small(path, size, row[8:])
                row[8 + plen:] = 0  # a reused page: scrub stale residue
                msg_lens[r] = 8 + plen
                fallback += 1
            except (OSError, EOFError) as e:
                errors[r] = f"{path}: {e}"
                row[8:] = 0
                msg_lens[r] = 8
        lease.lengths[:] = msg_lens
        words = lease.arr.view("<u4").reshape(n, grid_c, bb.WORDS_PER_CHUNK)
        return NativeStaged(words, lease.lengths, lease, errors, empty_rows, fallback)
    except BaseException:
        lease.release()
        raise


def _cas_ids_oracle(batch: StagedBatch) -> List[str]:
    return [
        cas.cas_id_of_payload(int(batch.sizes[row]),
                              batch.payloads[row, :batch.payload_lens[row]].tobytes())
        for row in range(len(batch.indexes))
    ]


def _cas_ids_plain(batch: StagedBatch) -> List[str]:
    return blake3_torch.cas_ids(batch.payloads, batch.sizes,
                                batch.payload_lens, "cpu")


_BACKENDS = {
    "oracle": _cas_ids_oracle,
    "plain": _cas_ids_plain,
}


def cas_pool(files: Union[Sequence[Tuple[str, int]], int], device="cuda") -> StagePool:
    """A two-page pool whose pages hold either size class of `files`: the
    identify path stages its large and small rows into one page each. An
    int `files` sizes the pages for that many files of either class, the
    pool a caller keeps across identify steps of up to that many files."""
    if isinstance(files, int):
        large = small = max(files, 1)
    else:
        large_idx, small_idx, _ = _classes(files)
        large, small = len(large_idx), len(small_idx)
    need = max(StagePool.bytes_for(large, _grid_for(cas.LARGE_PAYLOAD_SIZE)[1]),
               StagePool.bytes_for(small, _grid_for(cas.MINIMUM_FILE_SIZE)[1]),
               1)
    return StagePool(device, 2, need)


def _cas_ids_packed(files, device: torch.device, pool: Optional[StagePool]):
    """The identify main path on `device`: each size class staged by the C
    plane into its own page (large at C = 57, small at C = 101), copied
    without blocking, hashed by K1 (``blake3_cuda.blake3_words``). The
    small class is staged while the large one's copy and kernel run."""
    large_idx, small_idx, empty_idx = _classes(files)
    if pool is None:
        pool = cas_pool(files, device)
    elif pool.device != device or pool.pages < 2:
        raise ValueError(f"the identify path needs a pool of >= 2 pages on {device}, "
                         f"got {pool.pages} on {pool.device}")
    launched = []  # (file indexes, staged batch, [B, 8] digests on device)
    ids: Dict[int, Optional[str]] = {}
    errors: Dict[int, str] = {}
    drained = False
    chunk, trace = _CHUNK_SEQ(), tracing.current_trace_id()
    stage_s, t0 = 0.0, time.perf_counter()
    try:
        # Guarded dispatch (contract cas.ids): the staging copies are
        # pinned and non-blocking; the digests' fetch is the declared io.
        with kernel_registry.device_scope(f"cas_ids/{device.type}"):
            for idx in (large_idx, small_idx):
                if not idx:
                    continue
                ts = time.perf_counter()
                staged = stage_batch_native([files[i] for i in idx], pool)
                stage_s += time.perf_counter() - ts
                launched.append((idx, staged, None))
                w, n = blake3_torch.words_to_device(
                    *staged.tensors(), device, non_blocking=device.type == "cuda")
                launched[-1] = (idx, staged, blake3_cuda.blake3_words(w, n))
            with kernel_registry.io("cas.ids"):
                for idx, staged, digests in launched:
                    hexes = bb.digests_to_cas_ids(blake3_torch.digests_to_numpy(digests))
                    for row, i in enumerate(idx):
                        if row in staged.errors:
                            errors[i] = staged.errors[row]
                        else:
                            ids[i] = hexes[row]
                if device.type == "cuda":
                    # Every copy ran on the current stream: once it is
                    # drained, no copy reads a page and the pages may return.
                    torch.cuda.current_stream(device).synchronize()
                    drained = True
    finally:
        if device.type == "cuda" and not drained:
            with kernel_registry.io("cas.ids"):
                torch.cuda.current_stream(device).synchronize()
        for _, staged, _ in launched:
            staged.release()
    # The step's lanes as the JAX package's host-plane chunks record them
    # (scope "identify"): the C plane's staging, then copies, K1 and the
    # fetch, which interleave with the second class's staging.
    t1 = t0 + stage_s
    RECORDER.record("stage", batch=chunk, t0=t0, t1=t1, device=device.type,
                    scope="identify", trace=trace, files=len(files))
    RECORDER.record("kernel", batch=chunk, t0=t1, t1=time.perf_counter(),
                    device=device.type, scope="identify", trace=trace,
                    files=len(files))
    for idx in empty_idx:
        ids[idx] = None  # no CAS ID for empty files (mod.rs:86)
    return ids, errors


def cas_ids_for_files(
    files: Sequence[Tuple[str, int]], backend: str = "cuda", *,
    pool: Optional[StagePool] = None,
) -> Tuple[Dict[int, Optional[str]], Dict[int, str]]:
    """(path, size) pairs → {index: cas_id | None for empty}, {index: error}.

    The identifier's per-step work: stage + batch hash + format. The
    ``"cuda"`` backend stages through the C plane into `pool`, a CUDA ``StagePool`` of at least two pages that a caller
    keeps across steps (default: ``cas_pool(files)``, allocated per call;
    torch's caching host allocator keeps freed pinned blocks for reuse).
    """
    if backend == "cuda":
        # Fails before reading any file when there is no CUDA.
        device = blake3_torch.resolve_device("cuda")
    elif backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{sorted([*_BACKENDS, 'cuda'])}")
    IDENT_BATCHES.labels(backend=backend).inc()
    IDENT_BATCH_FILES.observe(len(files))
    # Payload-byte accounting (what the hashers consume): one pass over
    # the size list, ~ns a file against a ms-a-file pipeline.
    IDENT_BYTES_HASHED.inc(sum(
        cas.LARGE_PAYLOAD_SIZE if s > cas.MINIMUM_FILE_SIZE else s
        for _, s in files))
    # Staging belongs inside the span on every backend, so span timings
    # stay comparable across backends.
    with tracing.device_span(f"cas_ids/{backend}", batch=len(files)):
        if backend == "cuda":
            ids, errors = _cas_ids_packed(files, device, pool)
        else:
            hasher = _BACKENDS[backend]
            large, small, empty_idx, errors = stage_files(files)
            ids = {}
            for batch in (large, small):
                if batch.indexes:
                    ids.update(zip(batch.indexes, hasher(batch)))
            for idx in empty_idx:
                ids[idx] = None  # no CAS ID for empty files (mod.rs:86)
            for idx in errors:
                ids.pop(idx, None)  # a failed read's row hashed as zeros
    if errors:
        IDENT_READ_ERRORS.inc(len(errors))
    return ids, errors
