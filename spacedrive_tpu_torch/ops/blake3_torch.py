"""Device entry points for batched BLAKE3, CAS IDs and checksums.

Port of ``spacedrive_tpu/ops/blake3_jax.py``. The CAS pipeline uses two
canonical grids (``cas.rs:23-62`` semantics, see ``ops/cas.py``):

- large-file mode: every payload is exactly 57,344 sampled bytes
  (+ the 8-byte size prefix) → a ``[B, 57, 256]`` grid,
- small-file mode: whole files ≤ 100 KiB → a ``[B, 101, 256]`` grid.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``;
the CPU runs only when the caller passes ``device="cpu"`` (the tests do).
Asking for CUDA where there is none raises: nothing falls back to the CPU.

``words_to_device`` is where a staged grid crosses to the device: a numpy
batch (``build_cas_messages`` / ``pack_messages`` output, a ``[B, C, 256]``
uint32 array plus ``[B]`` int32 lengths, the same arrays the JAX package
stages), or the pinned views of a native staging page, copied without
blocking on a caller's stream.
``digests_to_numpy`` turns ``[B, 8]`` digests back into uint32.

Left out of this module, each for a reason:

- The B-bucket padding (``_B_BUCKETS``) exists only to bound jit
  recompiles. PyTorch runs eagerly and the kernels take any B.
- The mesh-sharded hasher (``make_sharded_blake3`` / ``sharded_hasher``)
  is multi-device and waits for a later slice.
- The donated entries (``_blake3_best_donated`` / ``_donated_local``) have
  no counterpart: the depth-N ring (``ops/overlap.py``) recycles staged
  device buffers through the caching allocator and ``record_stream``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import blake3_batch as bb
from . import blake3_cuda, cas, kernel_registry

# Canonical chunk-grid sizes for the two CAS modes.
LARGE_MSG_LEN = cas.SIZE_PREFIX_LEN + cas.LARGE_PAYLOAD_SIZE  # 57352
LARGE_CHUNKS = -(-LARGE_MSG_LEN // bb.CHUNK_LEN)  # 57
SMALL_MSG_MAX = cas.SIZE_PREFIX_LEN + cas.MINIMUM_FILE_SIZE  # 102408
SMALL_CHUNKS = -(-SMALL_MSG_MAX // bb.CHUNK_LEN)  # 101


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent.
    A CUDA device always carries its index (the current one where `device`
    names none), so two devices compare equal only when they are one card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain torch version")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def words_to_device(words, lengths, device="cuda", *, stream=None,
                    non_blocking: bool = False):
    """Staged grid → the port's (int32 words, int32 lengths) on `device`.

    `words` / `lengths` are numpy (uint32 [B, C, 256], int32 [B]) or the
    port's int32 tensors on the host, such as the views of a staging page
    (``staging.NativeStaged.tensors``). With `non_blocking` the copy to a
    CUDA device is issued on `stream` (default: the current stream) and
    returns before it completes; the source must then be pinned and must
    not be rewritten before the copy has completed (an event recorded on
    `stream` after this call says when). A non-blocking copy from pageable
    memory would silently run synchronously, so it raises instead.
    """
    dev = resolve_device(device)
    if isinstance(words, torch.Tensor):
        w, n = words, lengths
        if w.dtype != torch.int32 or n.dtype != torch.int32:
            raise ValueError("words and lengths tensors must be int32")
    else:
        w = bb.words_to_tensor(np.asarray(words), "cpu")
        n = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32))
    if w.dim() != 3 or w.shape[2] != bb.WORDS_PER_CHUNK:
        raise ValueError(f"words must be [B, C, {bb.WORDS_PER_CHUNK}], "
                         f"got {tuple(w.shape)}")
    if tuple(n.shape) != (w.shape[0],):
        raise ValueError(f"lengths must be [{w.shape[0]}], got {tuple(n.shape)}")
    if dev.type != "cuda":
        return w.to(dev), n.to(dev)
    if non_blocking and not (w.is_pinned() and n.is_pinned()):
        raise ValueError("a non_blocking host-to-device copy needs a pinned "
                         "source; pageable memory would copy synchronously")
    with torch.cuda.stream(stream if stream is not None
                           else torch.cuda.current_stream(dev)):
        return (w.to(dev, non_blocking=non_blocking),
                n.to(dev, non_blocking=non_blocking))


def digests_to_numpy(digests: torch.Tensor) -> np.ndarray:
    """[B, 8] int32 digest tensor → [B, 8] uint32 numpy array."""
    return bb.tensor_to_words(digests)


def blake3_words(words, lengths, device="cuda") -> torch.Tensor:
    """[B, C, 256] uint32 words + [B] int32 lengths (numpy, or the port's
    tensors) → [B, 8] int32 digest tensor on `device`."""
    if isinstance(words, torch.Tensor):
        dev = resolve_device(device)
        w, n = words.to(dev), lengths.to(dev)
    else:
        w, n = words_to_device(words, lengths, device)
    return blake3_cuda.blake3_words(w, n)


def cas_ids(payloads, sizes, payload_lens=None, device="cuda") -> list:
    """Payload rows [B, P] uint8 + sizes [B] → 16-hex CAS IDs."""
    words, lengths = bb.build_cas_messages(payloads, sizes, payload_lens)
    digests = blake3_words(words, lengths, device)
    return bb.digests_to_cas_ids(digests_to_numpy(digests))


def checksums_words_batched(blobs, device="cuda") -> list:
    """Full BLAKE3 digests (64-hex) of B byte strings in one dispatch.

    Rows are padded to a shared power-of-two chunk grid; callers group
    similar sizes per call (the validator sorts by size), so the shared C
    pads little.
    """
    if not blobs:
        return []
    maxlen = max(len(b) for b in blobs)
    C = max(1, -(-max(maxlen, 1) // bb.CHUNK_LEN))
    C = 1 << (C - 1).bit_length()
    words, lengths = bb.pack_messages(blobs, max_chunks=C)
    w, n = words_to_device(words, lengths, device)
    # Guarded dispatch (contract cas.checksums): the hex digests' fetch is
    # the declared io; the grid's copy to the device happened above.
    with kernel_registry.device_scope("cas.checksums"):
        digests = blake3_cuda.blake3_words(w, n)
        with kernel_registry.io("cas.checksums"):
            return bb.digests_to_hex(digests_to_numpy(digests))
