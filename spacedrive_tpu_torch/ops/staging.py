"""CAS staging: files → dense payload batches → CAS IDs, per backend.

Port of ``spacedrive_tpu/ops/staging.py`` (the identifier's feeding layer:
upstream core/src/object/file_identifier/mod.rs:107-134 →
core/src/object/cas.rs:23-62 hashes one file at a time; here whole batches
are staged into dense arrays and hashed at once).

Size classes keep the device grids canonical:
- LARGE (> 100 KiB): exactly 57,344 sampled bytes per row → [B, 57344].
- SMALL (≤ 100 KiB): whole file, zero-padded → [B, 102400] with lengths.
Empty files get no CAS ID (``None``), matching FileMetadata::new
(mod.rs:80-88).

Backends:
- ``"oracle"``: streaming pure-Python BLAKE3 per file (the parity oracle).
- ``"plain"``: the plain torch version on the CPU.
- ``"cuda"``: the fused CUDA chunk + tree kernels on the GPU.

Left out of this slice, each for a reason:
- The link-probe auto policy (``auto_device_batch``,
  ``device_pipeline_worthwhile``, ``h2d_gbps``, ``default_backend``) would
  silently route work to a CPU plane, so ``"auto"`` is not a backend here.
- The native C++ staging plane (``stage_batch_native``, ``StagePool``, the
  fused native hasher) waits for a later slice; reads here run on the
  pure-Python readers over a thread pool.
- Telemetry, spans and flight-recorder events wait for the port's
  registry twins.
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import blake3_torch, cas


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


def stage_files(
    files: Sequence[Tuple[str, int]],
) -> Tuple[StagedBatch, StagedBatch, List[int], Dict[int, str]]:
    """Stage (path, size) pairs into dense per-class batches.

    Returns (large_batch, small_batch, empty_indexes, errors) where errors
    maps file index → message: unreadable files are skipped and the caller
    records them as non-fatal errors. A declared size larger than the file
    is an ``EOFError`` short read; a small file that grew past 100 KiB is
    an error too.
    """
    large_idx = [i for i, (_, s) in enumerate(files)
                 if s > cas.MINIMUM_FILE_SIZE]
    small_idx = [i for i, (_, s) in enumerate(files)
                 if 0 < s <= cas.MINIMUM_FILE_SIZE]
    empty_idx = [i for i, (_, s) in enumerate(files) if s == 0]
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
                with open(path, "rb") as f:
                    data = f.read(cas.MINIMUM_FILE_SIZE + 1)
                if len(data) > cas.MINIMUM_FILE_SIZE:
                    raise EOFError(
                        f"{path}: grew past declared size {size}")
                small[row, :len(data)] = np.frombuffer(data, dtype=np.uint8)
                small_lens[row] = len(data)
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


def _cas_ids_oracle(batch: StagedBatch) -> List[str]:
    return [
        cas.cas_id_of_payload(int(batch.sizes[row]),
                              batch.payloads[row, :batch.payload_lens[row]].tobytes())
        for row in range(len(batch.indexes))
    ]


def _cas_ids_device(device: str):
    def run(batch: StagedBatch) -> List[str]:
        return blake3_torch.cas_ids(batch.payloads, batch.sizes,
                                    batch.payload_lens, device)
    return run


_BACKENDS = {
    "oracle": _cas_ids_oracle,
    "plain": _cas_ids_device("cpu"),
    "cuda": _cas_ids_device("cuda"),
}


def cas_ids_for_files(
    files: Sequence[Tuple[str, int]], backend: str = "cuda",
) -> Tuple[Dict[int, Optional[str]], Dict[int, str]]:
    """(path, size) pairs → {index: cas_id | None for empty}, {index: error}.

    The identifier's per-step work: stage + batch hash + format.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {sorted(_BACKENDS)}")
    hasher = _BACKENDS[backend]
    if backend == "cuda":
        blake3_torch.resolve_device("cuda")  # fail before reading any file
    large, small, empty_idx, errors = stage_files(files)
    ids: Dict[int, Optional[str]] = {}
    for batch in (large, small):
        if batch.indexes:
            ids.update(zip(batch.indexes, hasher(batch)))
    for idx in empty_idx:
        ids[idx] = None  # no CAS ID for empty files (mod.rs:86)
    for idx in errors:
        ids.pop(idx, None)  # a failed read's row hashed as zeros
    return ids, errors
