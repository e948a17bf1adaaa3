"""Wrapper of the hand-written CUDA Hamming near-mask kernel.

``hamming_near_mask`` is the port of the JAX package's ``hamming_tile`` +
``_near_mask_tile`` (``spacedrive_tpu/ops/hamming.py:34-40``, ``:68-70``:
jnp XOR and ``population_count``, no Pallas counterpart), which
``near_dup_pairs`` runs when every digest fits one tile, with the host's
``np.triu(mask, k=1)`` and the pyramid's range mask folded in. Torch has no
popcount operator, so the card runs ``csrc/hamming.cu`` (built by
``ops/_build.py``); the plain version is a SWAR popcount on int64 tensors
holding uint32 words.

The tensor's device decides: a CUDA tensor launches the kernel (or the call
raises), a CPU tensor takes the plain version. ``launches`` counts the
kernel's launches and nothing else.

Digests are int32 tensors ``[n, W]`` holding uint32 bits (W ≤ 8 on the
card); the mask is ``[n, m]`` bool.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEAR_MASK = "hamming_near_mask"
MAX_WORDS = 8  # the kernel's register tile of y words
MAX_ROWS = 65535 * 32  # the launch grid's y extent times its rows per block

launches = {NEAR_MASK: 0}


def reset_launches() -> None:
    launches[NEAR_MASK] = 0


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


def hamming_near_mask(x: torch.Tensor, y: torch.Tensor, threshold: int, oi: int = 0,
                      oj: int = 0, n_valid: Optional[int] = None) -> torch.Tensor:
    """[n, m] bool: Hamming(x[r], y[c]) ≤ threshold for global indices
    gi = oi + r < gj = oj + c, both below `n_valid` (default: no bound).
    One launch on the card for CUDA tensors; the plain version for CPU ones."""
    _check(x, y)
    if x.device.type == "cpu":
        return near_mask_plain(x, y, threshold, oi, oj, n_valid)
    n, m, words = x.shape[0], y.shape[0], x.shape[1]
    if not 1 <= words <= MAX_WORDS or n > MAX_ROWS:
        raise ValueError(f"the kernel takes 1..{MAX_WORDS} words and at most "
                         f"{MAX_ROWS} rows, got [{n}, {words}]")
    out = torch.empty((n, m), dtype=torch.bool, device=x.device)
    if n == 0 or m == 0:
        return out
    x, y = x.contiguous(), y.contiguous()
    lib = _build.library("hamming")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sd_hamming_near_mask(
            x.data_ptr(), y.data_ptr(), n, m, words, int(threshold), int(oi), int(oj),
            _n_valid(n, m, oi, oj, n_valid), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{NEAR_MASK} launch failed: CUDA error {rc} "
                           f"({lib.sd_hamming_error_string(rc).decode()})")
    launches[NEAR_MASK] += 1
    return out
