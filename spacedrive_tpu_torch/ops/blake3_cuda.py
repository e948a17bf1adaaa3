"""Wrappers of the hand-written CUDA BLAKE3 kernels.

Port of ``spacedrive_tpu/ops/blake3_pallas.py`` plus the tree stage that
follows its kernels. The kernels live in ``csrc/blake3_chunk.cu`` (built by
``ops/_build.py``); one templated body serves K1 and K2 in two forms:

- ``blake3_words`` launches K1 fused (``blake3_chunk_fast``): chunk CVs of
  whole messages from counter 0, folded into span tops in shared memory,
  then ``blake3_tree_fold`` until one top per message is left. The
  counterpart of ``blake3_words_pallas`` (``_chunk_kernel_meta`` + the jnp
  ``tree_reduce``) and the identify / validator-page main path.
- ``window_top`` launches K2 fused (``blake3_chunk_windowed``, never
  ROOT-finalized) and the fold: the subtree top of one streaming window at
  any 64-bit counter base (``ops/seqhash.py``).
- ``chunk_cvs_fast`` / ``chunk_cvs`` launch the CV forms
  (``blake3_chunk_fast_cvs`` / ``blake3_chunk_windowed_cvs``): every chunk's
  chaining value, exactly what ``_chunk_kernel_meta`` / ``_chunk_kernel``
  compute. No main path runs them; they keep the port's chunk stage held
  against the TPU kernels and plain ``bb.chunk_cvs``.

The tensor's device decides: a CUDA tensor launches the kernel (or the
call raises), a CPU tensor takes the plain torch version in
``ops/blake3_batch.py`` (``chunk_cvs`` + ``tree_reduce``). There is no
fallback from one to the other. ``launches`` counts each kernel form's
launches and nothing else.

Inputs are int32 tensors holding uint32 bits: words ``[B, C, 256]``,
lengths ``[B]`` (each at most ``C * 1024``). CV outputs are ``[8, B, C]``
int32 plus ``[B]`` int32 chunk counts; digests are ``[B, 8]`` int32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, kernel_registry
from . import blake3_batch as bb

FAST = "blake3_chunk_fast"
WINDOWED = "blake3_chunk_windowed"
FOLD = "blake3_tree_fold"
FAST_CVS = "blake3_chunk_fast_cvs"
WINDOWED_CVS = "blake3_chunk_windowed_cvs"

# Kernel form → launches since the last reset_launches().
launches = {name: 0 for name in (FAST, WINDOWED, FOLD, FAST_CVS, WINDOWED_CVS)}
# (windowed, fused) → the chunk kernel's form.
_FORMS = {(False, True): FAST, (True, True): WINDOWED,
          (False, False): FAST_CVS, (True, False): WINDOWED_CVS}

# Chunks per CTA segment (a power of two; a grid narrower than SPAN uses
# its next power of two) and threads per CTA (segments of several messages
# share a CTA). Chosen by one-off sweeps on an H100 80GB HBM3 (PERF.md,
# PR 2): an 8 MiB window's window_top took 0.0322 / 0.0295 / 0.0379 ms at
# spans of 64 / 128 / 256, and the identify step 0.842 / 0.685 / 0.678 ms
# at 64 / 128 / 256 threads.
SPAN = 128
THREADS = 256


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(words: torch.Tensor, lengths: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.dim() != 3 \
            or words.shape[2] != bb.WORDS_PER_CHUNK:
        raise ValueError(
            f"words must be an int32 [B, C, {bb.WORDS_PER_CHUNK}] tensor, got "
            f"{words.dtype} {tuple(words.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (words.shape[0],):
        raise ValueError(
            f"lengths must be an int32 [{words.shape[0]}] tensor, got "
            f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != words.device:
        raise ValueError("words and lengths must be on the same device")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


def _geometry(n: int, span: int):
    """(log2 S, threads per CTA) for n items per message: S = min(span,
    next_pow2(n)) with span a power of two, and as many messages per CTA
    as THREADS holds."""
    s = min(span, 1 << (max(n, 1) - 1).bit_length())
    return s.bit_length() - 1, max(1, THREADS // s) * s


def _run(name: str, device: torch.device, fn, *args) -> None:
    """Call one launcher on the current stream of `device`; raise on error."""
    lib = _build.library("blake3_chunk")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.sd_cuda_error_string(rc).decode()})")
    launches[name] += 1
    kernel_registry.note_launch(name)


def _counter_args(counter_base, whole, B: int, device: torch.device):
    """Counter base + whole flag as launch arguments: (meta, lo, hi, whole).

    Scalars (every streaming window) go as scalar kernel arguments and meta
    is None. Per-file arrays become one packed [3, B] uint32 (lo, hi,
    whole) copied once from pinned memory without blocking the host.
    """
    lo, hi = bb.split_counter_base(counter_base)
    flag = np.asarray(whole, dtype=bool)
    if lo.ndim == 0 and hi.ndim == 0 and flag.ndim == 0:
        return None, int(lo), int(hi), int(flag)
    packed = torch.empty((3, B), dtype=torch.int32, pin_memory=True)
    rows = packed.numpy().view(np.uint32)
    rows[0], rows[1], rows[2] = lo, hi, flag
    return packed.to(device, non_blocking=True), 0, 0, 0


def _chunk(words, lengths, *, windowed: bool, fused: bool, counter_base=0,
           whole=True, span: int = SPAN) -> torch.Tensor:
    """One launch of blake3_chunk_span: [8, B, C] CVs, or [B, n_spans, 8]
    span tops when fused (ROOT-finalized unless windowed; a fused windowed
    launch ignores `whole`)."""
    if not (words.is_contiguous() and words.data_ptr() % 16 == 0):
        raise ValueError("words must be contiguous and 16-byte aligned")
    B, C, _ = words.shape
    log2s, cta = _geometry(C, span)
    n_spans = -(-C // (1 << log2s))
    shape = (B, n_spans, 8) if fused else (8, B, C)
    out = torch.empty(shape, dtype=torch.int32, device=words.device)
    if B * C == 0:
        return out
    meta, lo, hi, flag = _counter_args(counter_base, whole, B, words.device)
    lengths = lengths.contiguous()
    _run(_FORMS[windowed, fused], words.device, "sd_blake3_chunk", words.data_ptr(),
         lengths.data_ptr(), None if meta is None else meta.data_ptr(), lo, hi, flag,
         B, C, log2s, cta, int(windowed), int(fused), out.data_ptr())
    return out


def _fold(tops: torch.Tensor, lengths: torch.Tensor, level: int, windowed: bool,
          span: int = SPAN) -> torch.Tensor:
    """[B, n, 8] tops of a fused launch at global level `level` → [B, 8] by
    blake3_tree_fold launches, each folding up to `span` tops per message."""
    B = tops.shape[0]
    while tops.shape[1] > 1:
        n_in = tops.shape[1]
        log2s, cta = _geometry(n_in, span)
        out = torch.empty((B, -(-n_in // (1 << log2s)), 8), dtype=torch.int32,
                          device=tops.device)
        _run(FOLD, tops.device, "sd_blake3_tree_fold", tops.data_ptr(),
             lengths.data_ptr(), B, n_in, level, log2s, cta, int(windowed),
             out.data_ptr())
        tops, level = out, level + log2s
    return tops.view(B, 8)


def _fused(words, lengths, *, windowed: bool, counter_base=0,
           span: int = SPAN) -> torch.Tensor:
    """Fused chunk kernel + folds: [B, 8] tops (digests unless windowed).
    The result does not depend on `span`; the on-card tests set it small
    to force several fold levels."""
    B, C, _ = words.shape
    if B == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=words.device)
    tops = _chunk(words, lengths, windowed=windowed, fused=True,
                  counter_base=counter_base, span=span)
    return _fold(tops, lengths.contiguous(), _geometry(C, span)[0], windowed, span)


def chunk_cvs_fast(words: torch.Tensor, lengths: torch.Tensor):
    """Whole messages from counter 0: (cvs [8, B, C], n_chunks [B])."""
    _check(words, lengths)
    if words.device.type == "cpu":
        return bb.chunk_cvs(words, lengths)
    cvs = _chunk(words, lengths, windowed=False, fused=False)
    return cvs, bb.n_chunks_of(lengths)


def chunk_cvs(words: torch.Tensor, lengths: torch.Tensor,
              counter_base=0, whole=True):
    """Chunk stage with a counter base (python int, numpy uint64 [B] or a
    split (lo, hi) pair) and a `whole` flag (bool or [B] bools):
    (cvs [8, B, C], n_chunks [B])."""
    _check(words, lengths)
    if words.device.type == "cpu":
        return bb.chunk_cvs(words, lengths, counter_base, whole)
    cvs = _chunk(words, lengths, windowed=True, fused=False,
                 counter_base=counter_base, whole=whole)
    return cvs, bb.n_chunks_of(lengths)


def blake3_words(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, C, 256] words + [B] lengths → [B, 8] int32 digests."""
    _check(words, lengths)
    if words.device.type == "cpu":
        return bb.tree_reduce(*bb.chunk_cvs(words, lengths))
    return _fused(words, lengths, windowed=False)


def window_top(words: torch.Tensor, length: torch.Tensor,
               counter_base: int) -> torch.Tensor:
    """[8] int32 subtree top of one streaming window: words [1, C, 256]
    whose chunk 0 is chunk `counter_base` of a longer stream (never
    ROOT-finalized), length [1] its bytes."""
    _check(words, length)
    if words.shape[0] != 1 or np.ndim(counter_base) != 0:
        raise ValueError("window_top takes one window and a scalar counter base")
    if words.device.type == "cpu":
        cvs, n = bb.chunk_cvs(words, length, counter_base, whole=False)
        return bb.tree_reduce(cvs, n, root=False)[0]
    return _fused(words, length, windowed=True, counter_base=counter_base)[0]
