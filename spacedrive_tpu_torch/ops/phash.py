"""Batched perceptual hashing (pHash): the DCT as two matrix products.

Port of ``spacedrive_tpu/ops/phash.py``. Each image is decoded on the host
to a 32×32 grayscale grid (``media/imgdecode.py``, PIL's grid bit for bit:
PNG, BMP, JPEG, GIF, ICO, TIFF (DNG's first IFD too) and WebP; anything
else is a decode error),
the batch's 2-D DCT-II is ``D @ X @ Dᵀ`` on the device, the 8×8
low-frequency block without its DC term is thresholded against its median:
63 bits, packed [B, 2] uint32 with one zero pad bit, the words
``ops/hamming.py`` compares.

The JAX package computes the DCT as an einsum outside any Pallas kernel, so
here it is two ``torch.matmul`` calls. TF32 would keep about three decimal
digits and move AC terms across the median, and torch's TF32 switches are
process-wide (flipping one from a job's thread races other threads, and
mixing its two APIs makes later reads raise), so the products run in
float64, which no TF32 setting touches: the float32 DCT matrix and the
grids (integers 0..255) are widened exactly, and the terms are at least as
exact as the JAX package's float32 einsum. The median of 63 terms is the
32nd smallest: torch's ``median`` (the lower median) and numpy's agree on
an odd count.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..media.imgdecode import GRID_EDGE, image_to_grid
from . import kernel_registry
from .blake3_torch import resolve_device

HASH_EDGE = 8            # 8×8 low-frequency block → 64 bits
INPUT_EDGE = GRID_EDGE   # downsampled grid edge (32)


def dct_matrix(n: int = INPUT_EDGE) -> np.ndarray:
    """Orthonormal DCT-II matrix [n, n] (float32)."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    m = np.cos(np.pi / n * (i + 0.5) * k)
    m[0] *= 1.0 / math.sqrt(2.0)
    return (m * math.sqrt(2.0 / n)).astype(np.float32)


_DCT32 = dct_matrix(INPUT_EDGE)


def _bits_to_words(bits: np.ndarray) -> np.ndarray:
    """[B, 63] bool → [B, 2] uint32 (63 AC bits + 1 zero pad)."""
    B = bits.shape[0]
    padded = np.zeros((B, 64), dtype=np.uint8)
    padded[:, :bits.shape[1]] = bits.astype(np.uint8)
    packed = np.packbits(padded, axis=1)  # [B, 8] bytes
    return packed.view(">u4").astype(np.uint32).reshape(B, 2)


_DCT_ON: Dict[torch.device, torch.Tensor] = {}  # _DCT32 in float64 per device


def _dct(device: torch.device) -> torch.Tensor:
    dct = _DCT_ON.get(device)
    if dct is None:
        dct = _DCT_ON.setdefault(
            device, torch.from_numpy(_DCT32.astype(np.float64)).to(device))
    return dct


def phash_bits(grids: torch.Tensor) -> torch.Tensor:
    """[B, 32, 32] float32 grids → [B, 63] bool AC bits on their device."""
    dct = _dct(grids.device)
    coeffs = torch.matmul(torch.matmul(dct, grids.to(torch.float64)), dct.T)
    low = coeffs[:, :HASH_EDGE, :HASH_EDGE].reshape(grids.shape[0], HASH_EDGE * HASH_EDGE)
    ac = low[:, 1:]
    med = torch.median(ac, dim=1, keepdim=True).values
    return ac > med


def phash_torch(grids: np.ndarray, device="cuda") -> np.ndarray:
    """[B, 32, 32] grids → [B, 2] uint32 pHashes, the DCT and median on
    `device` ("cuda" by default, raises where CUDA is absent; "cpu" runs
    the same torch code on the host)."""
    dev = resolve_device(device)
    g = torch.from_numpy(np.ascontiguousarray(grids, dtype=np.float32)).to(dev)
    if g.dim() != 3 or tuple(g.shape[1:]) != (INPUT_EDGE, INPUT_EDGE):
        raise ValueError(f"grids must be [B, {INPUT_EDGE}, {INPUT_EDGE}], got "
                         f"{tuple(g.shape)}")
    _dct(dev)  # its one copy to the device precedes the guarded region
    # Guarded dispatch (contract phash.batch): the bit fetch is the
    # declared io; the grids' copy to the device happened above.
    with kernel_registry.device_scope("phash.batch"):
        bits = phash_bits(g)
        with kernel_registry.io("phash.batch"):
            bits = bits.cpu().numpy()
    return _bits_to_words(bits)


def phash_files(paths: Sequence[str], device="cuda",
                timings: Optional[Dict[str, float]] = None) -> Tuple[dict, List[str]]:
    """paths → ({index: [2] uint32 hash}, errors). Decodes serially on the
    host, hashes the batch on `device`. `timings` accumulates the seconds
    of the two ("decode", "phash": the DCT to the bits back on the host)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    grids, idxs, errors = [], [], []
    for i, p in enumerate(paths):
        g = image_to_grid(p)
        if g is None:
            errors.append(f"phash decode failed: {p}")
        else:
            grids.append(g)
            idxs.append(i)
    t1 = time.perf_counter()
    words = phash_torch(np.stack(grids), dev) if grids else None
    if timings is not None:
        timings["decode"] = timings.get("decode", 0.0) + (t1 - t0)
        timings["phash"] = timings.get("phash", 0.0) + (time.perf_counter() - t1)
    if words is None:
        return {}, errors
    return {i: words[row] for row, i in enumerate(idxs)}, errors


def near_median(grids: np.ndarray, rel: float = 1e-4) -> np.ndarray:
    """[B, 32, 32] grids → [B, 64] bool, in hash bit order (the pad bit
    False): the AC terms within `rel`·max|AC| of their median in a float64
    recomputation. Two float32 pHashes summed in different orders may
    disagree on these bits and on no other."""
    dct = _DCT32.astype(np.float64)
    coeffs = dct @ np.asarray(grids, np.float64) @ dct.T
    ac = coeffs[:, :HASH_EDGE, :HASH_EDGE].reshape(len(coeffs), -1)[:, 1:]
    med = np.median(ac, axis=1, keepdims=True)
    tie = np.abs(ac - med) <= rel * np.abs(ac).max(axis=1, keepdims=True)
    return np.concatenate([tie, np.zeros((len(tie), 1), bool)], axis=1)


def words_to_bits(words: np.ndarray) -> np.ndarray:
    """[B, 2] uint32 pHashes → [B, 64] bool in hash bit order."""
    return np.unpackbits(np.asarray(words, ">u4").view(np.uint8).reshape(-1, 8),
                         axis=1).astype(bool)


def agree_under_ties(a: np.ndarray, b: np.ndarray, grids: np.ndarray) -> bool:
    """True when pHashes `a` and `b` ([B, 2] uint32) of `grids` differ only
    on bits ``near_median`` marks."""
    differ = words_to_bits(a) != words_to_bits(b)
    return not bool((differ & ~near_median(grids)).any())


def phash_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=">u4").tobytes()


def phash_from_bytes(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype=">u4").astype(np.uint32)
