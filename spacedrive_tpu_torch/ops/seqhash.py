"""Streaming full-file BLAKE3 over device windows (one GPU).

Port of ``spacedrive_tpu/ops/seqhash.py`` in its single-device form:
``StreamingShardedChecksum`` becomes ``StreamingChecksum(device,
window_chunks)`` and ``sharded_file_checksum`` becomes
``file_checksum_streaming(path, device, window_chunks)``.

BLAKE3's tree over chunk CVs is adjacent pairing with odd-promote, so a
power-of-two-aligned span of chunks reduces to an independent subtree top.
Each full window (``window_chunks`` chunks, a power of two) that has more
data after it reduces to its subtree top on the device through
``blake3_cuda.window_top``: the fused windowed kernel with counter base =
the window's global chunk index, never ROOT-finalized, and the tree fold,
both in shared memory. The host folds window tops with the
incremental-stack rule (one 64-byte parent compression per merge,
``blake3_ref.compress``). Memory stays at one window whatever the file
size. Semantics: upstream core/src/object/validation/hash.rs:10-24.

Where the whole stream fits one window, the JAX package hashes it on the
host; the port instead sends it through the single-lane fast-kernel path
(``blake3_cuda.blake3_words``), which gives the same digest and keeps the
work on the device. The mesh-sharded single-call hasher
(``make_sharded_checksum``) is multi-device and waits for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import blake3_batch as bb
from . import blake3_cuda, kernel_registry
from .blake3_ref import BLOCK_LEN, IV, PARENT, ROOT, compress
from .blake3_torch import resolve_device

# 8 MiB windows: the JAX validator's single-device shard size.
DEFAULT_WINDOW_CHUNKS = 8192


class StreamingChecksum:
    """Streaming BLAKE3 whose full windows hash on `device`.

    Feed bytes in any increments with ``update``; ``digest`` finalizes.
    The tail window (whatever remains at ``digest`` time) reduces with the
    same adjacent-pairing tree, which equals the spec tree for a trailing
    span that starts on a window boundary; the stack then merges
    right-to-left with ROOT on the last parent — the finalize walk of
    ``blake3_ref.Blake3.digest``.
    """

    def __init__(self, device="cuda", window_chunks: int = DEFAULT_WINDOW_CHUNKS):
        if window_chunks < 1 or window_chunks & (window_chunks - 1):
            raise ValueError("window_chunks must be a power of two")
        if window_chunks * bb.CHUNK_LEN > 2**31 - 1:
            raise ValueError("a window must stay below 2 GiB (int32 lengths)")
        self._device = resolve_device(device)
        self._window_chunks = window_chunks
        self._window_bytes = window_chunks * bb.CHUNK_LEN
        self._buf = bytearray()
        self._windows_done = 0
        self._stack: list = []  # subtree CVs, shallowest first

    @property
    def windows_folded(self) -> int:
        """Full windows already reduced on the device."""
        return self._windows_done

    def update(self, data: bytes) -> "StreamingChecksum":
        self._buf += data
        # Keep at least one byte buffered: the final window must take the
        # ROOT path in digest(), so a window folds only when data strictly
        # beyond it has arrived.
        while len(self._buf) > self._window_bytes:
            window = bytes(self._buf[:self._window_bytes])
            del self._buf[:self._window_bytes]
            self._push_window_cv(self._window_top(window))
        return self

    def _window_words(self, data: bytes, chunks: int):
        buf = np.zeros(chunks * bb.CHUNK_LEN, dtype=np.uint8)
        buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        words = buf.view("<u4").reshape(1, chunks, bb.WORDS_PER_CHUNK)
        return (bb.words_to_tensor(words, self._device),
                torch.tensor([len(data)], dtype=torch.int32, device=self._device))

    def _window_top(self, data: bytes) -> list:
        """Reduce one window to its 8-word subtree-top CV."""
        words, length = self._window_words(data, self._window_chunks)
        base = self._windows_done * self._window_chunks
        # Guarded reduce (contract seqhash.reduce): the window's copy to
        # the device precedes it, its 8-word top is the declared fetch.
        with kernel_registry.device_scope("seqhash.reduce"):
            top = blake3_cuda.window_top(words, length, base)
            with kernel_registry.io("seqhash.window"):
                return [int(w) for w in bb.tensor_to_words(top)]

    def _push_window_cv(self, cv: list) -> None:
        self._windows_done += 1
        # Incremental-stack rule: after w windows, merge one level per
        # trailing zero bit of w.
        w = self._windows_done
        while w % 2 == 0:
            left = self._stack.pop()
            cv = compress(list(IV), left + cv, 0, BLOCK_LEN, PARENT)[:8]
            w //= 2
        self._stack.append(cv)

    def digest(self) -> bytes:
        tail = bytes(self._buf)
        if not self._stack:
            # The whole stream fits one window: one whole message.
            chunks = max(1, -(-len(tail) // bb.CHUNK_LEN))
            words, length = self._window_words(tail, chunks)
            with kernel_registry.device_scope("seqhash.reduce"):
                digest = blake3_cuda.blake3_words(words, length)
                with kernel_registry.io("seqhash.window"):
                    return bb.tensor_to_words(digest)[0].astype("<u4").tobytes()
        cv = self._window_top(tail)
        # Finalize: fold the stack right-to-left; ROOT on the last parent.
        for i, left in enumerate(reversed(self._stack)):
            flags = PARENT | (ROOT if i == len(self._stack) - 1 else 0)
            cv = compress(list(IV), left + cv, 0, BLOCK_LEN, flags)[:8]
        return b"".join(int(w).to_bytes(4, "little") for w in cv)

    def hexdigest(self) -> str:
        return self.digest().hex()


def file_checksum_streaming(path, device="cuda",
                            window_chunks: int = DEFAULT_WINDOW_CHUNKS) -> str:
    """Full-file checksum (64-hex, hash.rs:10-24) streamed through device
    windows with one window buffered at a time."""
    h = StreamingChecksum(device, window_chunks)
    with open(path, "rb") as f:
        while True:
            block = f.read(window_chunks * bb.CHUNK_LEN)
            if not block:
                break
            h.update(block)
    return h.hexdigest()
