"""Wrappers of the hand-written CUDA Hamming kernels, mask form and count form.

Both run ``csrc/hamming.cu`` (built by ``ops/_build.py``), one design on
Hopper's tensor cores: each digest bit becomes a ±1 byte in shared memory,
``wgmma`` multiplies them in s8 with s32 sums, and dot(x, y) = 32W −
2·hamming(x, y) is compared against the threshold in registers.

- ``hamming_near_mask`` ports the JAX package's ``hamming_tile`` +
  ``_near_mask_tile`` (``spacedrive_tpu/ops/hamming.py:34-40``, ``:68-70``:
  jnp XOR and ``population_count``, no Pallas counterpart), which
  ``near_dup_pairs`` runs when every digest fits one tile, with the host's
  ``np.triu(mask, k=1)`` and the pyramid's range mask folded in. Its plain
  version is a SWAR popcount on int64 tensors holding uint32 words.
- ``hamming_near_counts`` ports ``_tile_counts_block`` (``:260``) and
  ``_refine_body`` / ``_refine_counts`` (``:290``, ``:313``): the pyramid's
  counts of near pairs per sub-block, with no product or mask in device
  memory. Its plain version is the pyramid's arithmetic: fp32 ±1 products,
  threshold, index mask, reshape-sum.

The tensor's device decides: a CUDA tensor launches the kernel (or the call
raises), a CPU tensor takes the plain version. ``launches`` counts each
kernel's launches and nothing else.

Digests are int32 tensors ``[n, W]`` holding uint32 bits, 1 ≤ W ≤ 8 on the
card. The mask form takes any n and m (its grid has ⌈n/64⌉·⌈m/128⌉ blocks,
at most 2**31 − 1); the count form blocks of S × S rows of one digest
array, S and g powers of two, g ≤ min(S, 64).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build, kernel_registry

NEAR_MASK = "hamming_near_mask"
NEAR_COUNTS = "hamming_near_counts"
MAX_WORDS = 8  # the kernels' instantiations: one k step of wgmma a word
MAX_SUB = 64   # the count form's g: g² counters in shared memory
# Bytes of fp32 products one plain count call may hold.
PLAIN_PRODUCT_BYTES = 1 << 28

launches = {NEAR_MASK: 0, NEAR_COUNTS: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 held in an int64 tensor (values 0..2**32-1)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distances_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[n, W] × [m, W] uint32 words in int32 tensors → [n, m] int32
    Hamming distances, word by word (no [n, m, W] intermediate)."""
    xl = x.to(torch.int64) & 0xFFFFFFFF
    yl = y.to(torch.int64) & 0xFFFFFFFF
    dist = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.int64, device=x.device)
    for w in range(x.shape[1]):
        dist += popcount32(xl[:, None, w] ^ yl[None, :, w])
    return dist.to(torch.int32)


def bit_planes(words: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., W] uint32 bits (int32 tensor) → [..., W*32] ±1 (bit b of word w
    at column w*32+b)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return (bits.to(dtype) * 2 - 1).flatten(-2)


def index_mask(oi: torch.Tensor, oj: torch.Tensor, rows: int, cols: int,
               n_valid: int) -> torch.Tensor:
    """[F, rows, cols] bool: global gi < gj, both below `n_valid`, for
    blocks whose rows start at oi [F] and columns at oj [F] (int64)."""
    gi = (oi[:, None] + torch.arange(rows, dtype=torch.int64, device=oi.device))[:, :, None]
    gj = (oj[:, None] + torch.arange(cols, dtype=torch.int64, device=oj.device))[:, None, :]
    return (gi < gj) & (gi < n_valid) & (gj < n_valid)


def near_mask_plain(x: torch.Tensor, y: torch.Tensor, threshold: int, oi: int = 0,
                    oj: int = 0, n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``hamming_near_mask``."""
    n, m = x.shape[0], y.shape[0]
    origin = torch.tensor([oi, oj], dtype=torch.int64, device=x.device)
    in_range = index_mask(origin[:1], origin[1:], n, m, _n_valid(n, m, oi, oj, n_valid))[0]
    return (hamming_distances_plain(x, y) <= threshold) & in_range


def near_counts_plain(words: torch.Tensor, origins, size: int, g: int, threshold: int,
                      n_valid: int) -> torch.Tensor:
    """Plain version of ``hamming_near_counts``: per chunk of blocks, the
    rows and columns gathered, fp32 ±1 products (sums of at most 32W ±1
    terms, exact), 1 where dot ≥ 32W − 2·threshold, the index mask, and
    sums over each (size/g)² sub-block (at most size² ones, exact in fp32)."""
    origins = _origins(origins, words.shape[0], size)
    bits = 32 * words.shape[1]
    k = size // g
    per = max(1, PLAIN_PRODUCT_BYTES // (4 * size * size))
    ar = torch.arange(size, dtype=torch.int64)
    out = []
    for f0 in range(0, len(origins), per):
        oi, oj = origins[f0:f0 + per].to(words.device).unbind(1)
        x = bit_planes(words[oi[:, None] + ar.to(words.device)])
        y = bit_planes(words[oj[:, None] + ar.to(words.device)])
        near = torch.bmm(x, y.transpose(1, 2)) >= bits - 2 * threshold
        near &= index_mask(oi, oj, size, size, n_valid)
        out.append(near.to(torch.float32).view(-1, g, k, g, k).sum(dim=(2, 4))
                   .to(torch.int32))
    if not out:
        return torch.zeros((0, g, g), dtype=torch.int32, device=words.device)
    return torch.cat(out)


def _n_valid(n: int, m: int, oi: int, oj: int, n_valid: Optional[int]) -> int:
    return max(oi + n, oj + m) if n_valid is None else int(n_valid)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be an int32 [rows, W] tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.shape[1] != y.shape[1] or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and y {tuple(y.shape)} on "
                         f"{y.device} must share W and a device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_words(words: int) -> None:
    if not 1 <= words <= MAX_WORDS:
        raise ValueError(f"the kernel takes 1..{MAX_WORDS} words a digest, got {words}")


def _origins(origins, n_rows: int, size: int) -> torch.Tensor:
    """Block origins as a CPU int64 [F, 2] tensor, each block inside the
    digest array (checked on the host: the kernel trusts them)."""
    o = torch.as_tensor(np.asarray(origins, dtype=np.int64).reshape(-1, 2))
    if len(o) and (int(o.min()) < 0 or int(o.max()) > n_rows - size):
        raise ValueError(f"block origins must lie in [0, {n_rows - size}] for "
                         f"{size}-row blocks of {n_rows} rows")
    return o


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.sd_hamming_error_string(rc).decode()})")


def hamming_near_mask(x: torch.Tensor, y: torch.Tensor, threshold: int, oi: int = 0,
                      oj: int = 0, n_valid: Optional[int] = None) -> torch.Tensor:
    """[n, m] bool: Hamming(x[r], y[c]) ≤ threshold for global indices
    gi = oi + r < gj = oj + c, both below `n_valid` (default: no bound).
    One launch on the card for CUDA tensors; the plain version for CPU ones."""
    _check(x, y)
    if x.device.type == "cpu":
        return near_mask_plain(x, y, threshold, oi, oj, n_valid)
    n, m = x.shape[0], y.shape[0]
    _check_words(x.shape[1])
    out = torch.empty((n, m), dtype=torch.bool, device=x.device)
    if n == 0 or m == 0:
        return out
    x, y = x.contiguous(), y.contiguous()
    lib = _build.library("hamming")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sd_hamming_near_mask(
            x.data_ptr(), y.data_ptr(), n, m, x.shape[1], int(threshold), int(oi), int(oj),
            _n_valid(n, m, oi, oj, n_valid), out.data_ptr(), stream)
    _raise_on(rc, lib, NEAR_MASK)
    launches[NEAR_MASK] += 1
    kernel_registry.note_launch(NEAR_MASK)
    return out


def hamming_near_counts(words: torch.Tensor, origins, size: int, g: int, threshold: int,
                        n_valid: int) -> torch.Tensor:
    """[F, g, g] int32: for each block f of `size` × `size` pairs, rows from
    words[origins[f, 0]:] and columns from words[origins[f, 1]:] (origins
    [F, 2] in rows, a numpy array or CPU tensor), the pairs with Hamming
    distance ≤ threshold and global gi < gj, both below `n_valid`, counted
    per (size/g)² sub-block. One launch on the card for a CUDA `words`; the
    plain version for a CPU one."""
    _check(words, words)
    if size < 1 or size & (size - 1) or g < 1 or g & (g - 1) or g > min(size, MAX_SUB):
        raise ValueError(f"size and g must be powers of two with g ≤ min(size, {MAX_SUB}), "
                         f"got size {size}, g {g}")
    if words.device.type == "cpu":
        return near_counts_plain(words, origins, size, g, threshold, n_valid)
    _check_words(words.shape[1])
    o = _origins(origins, words.shape[0], size)
    out = torch.zeros((len(o), g, g), dtype=torch.int32, device=words.device)
    if len(o) == 0:
        return out
    words = words.contiguous()
    lib = _build.library("hamming")
    with torch.cuda.device(words.device):
        # Pinned and non-blocking: no synchronizing copy inside a
        # guarded device scope (ops/kernel_registry.py).
        o = o.pin_memory().to(words.device, non_blocking=True)
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.sd_hamming_near_counts(
            words.data_ptr(), words.shape[0], words.shape[1], o.data_ptr(), len(o), size, g,
            int(threshold), int(n_valid), out.data_ptr(), stream)
    _raise_on(rc, lib, NEAR_COUNTS)
    launches[NEAR_COUNTS] += 1
    kernel_registry.note_launch(NEAR_COUNTS)
    return out
