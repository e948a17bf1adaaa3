#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``spacedrive_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's native sources from ``spacedrive_tpu_torch/csrc``
(``nvcc`` and ``g++``, all at once), drives the identify, validate and
near-dup paths through the entry points a user calls, holds every kernel
form against its plain torch version on the same inputs on the card
(bit-exact: the data is integer hashes and masks), checks results against
the pure-Python BLAKE3 oracle and a brute force, and times each kernel
with CUDA events. Phases:

1. build   — compile every source, print the build time, the ptxas reports
   and the SASS instruction mix of one compression in the chunk loop
   (beside the function's own operation counts, which set the bound);
2. identify step — B = 16384 large-file rows ([16384, 57, 256] words, the
   identifier's device step): K1's CV form, K1 fused (chunk + tree in one
   launch) and the plain chunk and tree stages;
3. small grid — B = 2048 rows at C = 101 with edge lengths;
4. real files — a 16384-file corpus through
   ``staging.cas_ids_for_files(backend="cuda")`` (the identify main path:
   the native C++ staging plane writes each size class into a pinned page,
   one non-blocking copy, K1), against ``backend="plain"`` on every 4th
   file and the odd ones, the oracle, and duplicate grouping; an uncounted second run splits its time into native
   staging, pinned H2D, hash and D2H + format, beside the Python readers
   and host packing that the plain path still runs;
5. validate — ``validator.checksums_for_files`` on a small-file page and a
   multi-window streamed file (the validate main path); K2's CV form, K2
   fused and the tree fold per 8 MiB window, counter bases straddling
   2**32, and the dependent latency of one compression;
6. ring — ``overlap.run_overlapped`` (the depth-N ring: native staging
   into pinned pages, H2D on a copy stream, K1 on a compute stream) at
   depths 1, 3, 3, 1 in turn over phase 4's 12288 large files (6 batches of
   2048) and a 12 288 x 120 000-byte sparse corpus (6 batches of 2048),
   every batch's digests held against the plain torch K1 on the Python
   readers' rows,
   after a staging probe (the C plane at 1-8 threads on one batch, the
   per-file cost of each system call, the corpus's file system);
7. scan — a 100 000-file location through the port's own job system:
   phase 4's directory plus ~83 600 sparse 120 000-byte files (1000 to a
   sub-directory, each with its own bytes at offset 0, two planted pairs),
   ``create_location`` and ``scan_location(backend="cuda", with_media=False)``
   in a fresh library whose SQLite files sit in the system temp dir. IndexerJob walks
   and saves the rows, FileIdentifierJob hashes 16384-file steps with K1
   out of one pinned two-page pool and links or creates objects. Every CAS
   ID is held against an independent ``cas_ids_for_files(backend="cuda")``
   call, phase 4's IDs, and a 1024-row sample against the plain version;
   object grouping, op-log counts, the launches (one K1 per size class per
   step) and the pool's leases are checked;
8. validate job — phase 5's directory as a second location, scanned, then
   ``ObjectValidatorJob`` in ``fill`` mode (every checksum equal to phase
   5's, K1 per page, 9 K2 windows and 9 folds for the 64 MiB file) and in
   ``verify`` mode (no mismatch);
9. near-dup job — two image locations written by the harness's own PNG,
   BMP, JPEG, GIF, ICO, TIFF and WebP writers in the system temp dir: A,
   about 4 400 images of 48–800 px a side (ICO and WebP singles at most
   256), every PNG colour type, depth and row filter, Adam7 and 16-bit
   PNG, BMP at 8, 24 and 32 bits, JPEG at 4:2:0, 4:2:2, 4:4:4, gray,
   progressive (spectral selection, DC successive approximation), with
   restart intervals and as Adobe RGB, GIF plain and interlaced, ICO with
   a PNG or DIB frame, TIFF (LZW, Deflate, PackBits, uncompressed; II and
   MM, strips and tiles, chunky and planar, predictor 2; gray at 1, 8 and
   16 bits, RGB at 8 and 16, RGBA, palette at 4 and 8; BigTIFF), a
   DNG-shaped TIFF, WebP lossless (predictor, subtract green, colour cache,
   backward references), colour-indexed, lossy (1-8 partitions, segments,
   both loop filters, 16x16 and B_PRED modes), with an ALPH chunk, and a
   two-frame animation whose first frame is smaller than its canvas; 180
   planted near-dup groups (a lossless TIFF, a JPEG and a lossy WebP
   re-encode in each), 60 byte-identical copies, 20 files the decoder
   must refuse (a truncated PNG, a JPEG without EOI, random bytes, a
   truncated TIFF, a WebP whose VP8 data is cut, a JPEG claiming
   arithmetic coding); and B, about 2 000. Each is scanned with
   ``scan_location(backend="cuda", with_media=False)``, then ``NearDupDetectorJob(backend=
   "cuda")`` decodes on the host (native C++ decoders), pHashes 256-image
   steps on the card and runs the exact pairs search: the pyramid
   (``hamming_near_counts`` launches) at A's ~4 300 digests, one
   ``hamming_near_mask`` launch at B's ~1 950. Checked: every kind is
   written; the job's errors are exactly the refused files; the native
   grids equal the plain decoder's on a 1024-file sample holding every
   format; every stored pHash the plain pHash of its grid (under the tie
   rule); the stored pairs equal a numpy brute force, distances included;
   every planted pair is found. Host decode time per image is printed per
   format, and for WebP per first chunk (VP8L, VP8, VP8X);
10. near-dup at scale — ``near_dup_pairs(device="cuda")`` (each call a
   main path: the count form's sweep, refinement and leaves) at 100 000
   digests against ``hamming_near_mask`` tiled over the card, at 1 000 000
   with 5 000 planted pairs (recall 1, every distance re-checked on the
   host), the stage table of both, a degenerate cluster past
   ``MAX_TOTAL_PAIRS`` (the warning, the count dropped, the pairs kept and
   dropped equal to the plain pyramid's on the CPU);
   ``hamming_near_counts`` against its plain version bit for bit at the
   sweep's shape (64 blocks of 4096 rows, g = 16) and the refinement's
   (4096 blocks of 256, g = 16), and ``hamming_near_mask`` at B's shape,
   [4096, 2] and [4096, 8], each timed beside its bound (tensor, compare
   and byte terms) and one ±1 fp16 ``torch.matmul`` of the same planes;
11. live library — a location of 8192 sparse files in the system temp
   dir: the scan chain with the identifier at 1024 files a step, paused
   after its 2nd step, resumed live, paused after one more, the manager
   shut down and a new one's ``cold_resume`` run to the end (every CAS ID
   against an independent cuda call, the staging pool's leases 0 at each
   pause, K1 launched once per page hashed, the two pages a pause dropped
   included); ``Locations.watch_location`` with the inotify watcher while
   two sub-directories take 300 new files, 50 same-size edits, 20 renames,
   40 deletes and a new directory, until the light rescans bring the rows
   back to the disk (K1 only inside ``light_scan_location``); and
   ``walk_ephemeral(compute_cas_ids=True)`` over 64 PNG and JPEG images
   against its plain version. The write actor's groups, tickets per group
   and commits are printed for phase 7's scan and for this phase;
12. media — the media plane, in the system temp dir: a location of about
   1 200 images written by the harness's own writers (16 camera-size
   4032 x 3024 4:2:0 JPEGs with an APP1 EXIF block of make, model, lens,
   date, f-number, exposure, ISO, orientation and GPS in all four
   quadrants; JPEG, PNG ``eXIf``, VP8X WebP with an ``EXIF`` chunk, TIFF
   with IFD0 tags and an Exif sub-IFD, DNG and NEF with a SubIFD JPEG
   preview, ``.heic``/``.avif`` boxes around a JPEG item and an Exif item;
   every IMAGE_KINDS kind) and the second slice's files, also the
   harness's own (WAV, FLAC, MP3, Ogg Vorbis; an MJPEG AVI of harness
   JPEGs, an MP4 and an MKV with cover art, one 1920 x 1080 I_PCM H.264
   frame in an MP4 whose planes are known by construction, the committed
   ``tests/fixtures/h264`` and ``tests/fixtures/video`` files; four SVGs,
   DCT and Flate PDFs), scanned with ``scan_location(backend="cuda")``
   (the media job chained by default), the thumbnailer actor running: K1
   launched once per size class of each identifier page; every
   ``media_data`` row reads back what its writer planted (plus codes
   included; ``stream_data`` the probe's fields) and no other file has
   one; every thumbnail at its keyed path at ``scale_dimensions``' size,
   the unresized ones over the PSNR floor against the planted pixels, the
   1080p frame's planes exactly the planted ones; the job completed
   without errors; the native decode, thumb_rgb and LANCZOS equal their
   plain versions on a sample, the encoder's native bytes its plain bytes,
   the thumbnails' native decode the plain decode, their PSNR against the
   grid over the tests' floor; a second scan writes nothing;
   ``walk_ephemeral`` over 64 images hands its CAS IDs to the actor's
   ephemeral queue. Printed: the job's wall and images/s, the seconds a
   stage (decode, thumb_rgb, resize, encode, write) by format, and the ms
   a call of each second-slice route (probe by extension, frame route,
   H.264 decode by frame size, SVG render, PDF stream);
13. sync — run right after phase 8, on phase 7's library: node A
   (``Node(data_dir)``, the library's data dir) and node B (empty, in
   the system temp dir) start their p2p planes on 127.0.0.1; A pairs the
   library into B over the encrypted tunnel (the port's X25519, Ed25519,
   HKDF and ChaCha20-Poly1305) and B clones it through the blob
   pass-through; B's ``file_path``, ``object``, ``location`` and
   ``instance`` rows equal A's by pub_id, and its op log A's count. Then
   one directory of phase 7's corpus takes 200 new files, 50 rewrites and
   50 removals, ``light_scan_location`` on A hashes them with K1, and B
   must converge within 30 s; last, A spacedrops phase 5's 64 MiB +
   12345 B file to B, whose ``checksums_for_files`` on the card (K2 and
   the fold) must equal A's checksum. Printed: the handshake's ms, the
   clone's wall, ops/s, pages relayed and bytes sealed, the AEAD's MB/s,
   the rescan's and the convergence's s, the spacedrop's MB/s;
14. api — run right after phase 13, on phase 7's library: an
   ``ApiServer`` over ``Node(data_dir, device="cuda")`` on 127.0.0.1:0,
   driven only through ``/rspc`` by the harness's own ``http.client`` and
   masked-frame WebSocket clients. A second location of 2 000 files in the
   system temp dir (200 PNGs from the harness's PNG writer, 40 of them
   planted near-duplicate pairs, 30 groups of byte-equal files, two files
   past the validator's 4 MiB cap) is created, ``locations.fullRescan``
   (K1), ``jobs.objectValidator`` (K1, K2, the fold) and
   ``jobs.nearDupDetector`` (the mask form) run through the API while a
   ``jobs.progress`` subscription counts frames; ``search.duplicates`` and
   ``search.nearDuplicates`` must return exactly the planted groups and
   pairs, ``search.pathsCount`` phase 7's location's rows, a 500-row
   ``search.paths`` window must arrive whole in a 64-bit-length frame, a
   thumbnail fetch WebP bytes, a Range fetch the exact slice;
   ``files.copyFiles``, ``files.duplicateFiles`` and ``files.deleteFiles``
   must leave a tree a rescan's rows agree with. Printed: median and p99
   round trips of 100-row ``search.paths`` windows over HTTP and over the
   WebSocket on the 100 000-file location, the API-driven job walls, the
   count of progress frames;
15. observe — the observability plane: (a) phase 4's 16 384 files
   identified with telemetry on and off (files/s of each; the CAS IDs
   phase 4's; ``sd_identifier_batch_files`` and
   ``sd_identifier_batches_total`` moved by exactly the call with telemetry
   on and not at all with it off; the kernel registry's K1 count in the
   ``cas_ids/cuda`` scope equal to ``launches``); (b) a child process with
   ``SDTPU_PROFILE`` (the torch profiler is process-wide) and the
   sanitizer in raise mode identifies 2 048 of them, validates a 9 MiB
   file and compares 2 000 digests with the mask form; the parent reads
   its Chrome trace, which must name the ``cas_ids/cuda``,
   ``seqhash.reduce`` and ``hamming.pairs`` regions and hold each
   kernel's device events (K1, K2, the fold, the mask form) inside its
   region; (e) in that child the three paths record no violation, and
   ``.item()`` on a CUDA tensor inside ``device_scope`` raises and is
   recorded as ``host_transfer``; (c) a 16-batch ring at depth 3 whose
   flight-recorder export passes ``validate_chrome_trace`` with a window
   per measured batch (printed: how many each of stage, h2d and kernel
   bound), each batch's kernel lane after its h2d lane and the kernel
   lanes one after another; (d) a fresh ``Node(device="cuda")`` behind an
   ``ApiServer`` scans a 2 000-file location through ``/rspc`` under a
   trace id the WebSocket client sends in ``tp``: ``GET /metrics``
   parses and its identifier counters match the scan, ``node.spans``
   returns the ``rpc/locations.fullRescan`` span (parented on the
   client's span), the jobs' and the ``cas_ids`` spans under that trace,
   ``node.trace.export`` and ``node.health`` validate, and
   ``store.commit=error`` armed for one write makes the ``store.busy``
   backoff give up into exactly one ``backoff.give_up`` bundle, read
   back through ``incidents.list``, ``incidents.get`` and
   ``incidents.ack``. Printed: files/s on and off,
   the ring's binding counts, the ``/metrics`` scrape's ms and the trace
   file's bytes;
16. the kernel table as one JSON line, launches summed over phases 4-15,
   the CV forms beside them with their 0.

Launch counts are reset just before each main path (phases 4 and 5, each
ring run of phase 6, the scans of phases 7, 8 and 9, each validator job,
each near-dup job and each search of phase 10, phase 11's paused scan,
its watcher's rescans and its browse, phase 12's scans and browse, and
phases 13 and 14 as a whole)
and read just after;
launches made to compare or time a kernel are not counted. Every failure
raises, so the exit code is 0 only if every phase passed. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# Integer lanes per SM per clock on Hopper (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0: 32-bit integer
# add, shift, bitwise and multiply-add each run 64 lanes per SM per clock).
# The ALU pipe takes IADD3, LOP3, SHF, PRMT and the rest of the integer
# and logic work; IMAD and IMUL go to the FMA pipe; the 4 schedulers issue
# 128 lanes per clock in all.
ALU_LANES = 64
ISSUE_LANES = 128
# One BLAKE3 compression: 7 rounds x 8 G, each 4 adds (two of them
# three-input, one IADD3 each), 4 xors and 4 rotates, plus 8 output xors.
# The xors and rotates run only on the ALU pipe (LOP3, SHF or PRMT); an
# add may issue on the FMA pipe as IMAD instead. So a compression needs at
# least max(456 / ALU_LANES, 680 / ISSUE_LANES) SM cycles per lane.
COMPRESSION_OPS = 7 * 8 * 12 + 8         # 680
COMPRESSION_ALU_OPS = 7 * 8 * 8 + 8      # 456
LANE_CYCLES = max(COMPRESSION_ALU_OPS / ALU_LANES, COMPRESSION_OPS / ISSUE_LANES)
# Opcodes of the compiled chunk loop by pipe, for the SASS diagnostic.
FMA_OPS = {"IMAD", "IMUL", "IDP"}
ALU_OPS = {"IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "IMNMX",
           "MOV", "IABS", "FLO", "POPC", "BMSK", "SGXT", "PLOP3", "P2R", "R2P",
           "VIADD", "VIMNMX", "LOP", "IADD", "SHL", "SHR"}
# Cycles per second of the sleep kernel queued ahead of a timed run (about
# the card's max SM clock; a slower clock only lengthens the sleep).
SLEEP_CYCLES_PER_S = 2.0e9
# Slice 1's device time per main-path unit (PERF.md, NVIDIA H100 80GB HBM3
# at 700 W): chunk kernel + plain torch tree, per identify step and per
# 8 MiB window.
SLICE1_STEP_MS = 0.6069 + 37.5385
SLICE1_WINDOW_MS = 0.2344 + 82.87


class SmokeFailure(AssertionError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_device(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls on
    the current stream (CUDA events), after one warm-up call.

    A sleep kernel queued first lasts twice as long as the host takes to
    enqueue the calls, so the card runs them back to back: a launch shorter
    than its own host overhead is timed on the device, not at the host's
    enqueue rate. (Calls that block the host, like the plain versions'
    many small launches, are timed at the rate they really run.)
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, 2.0) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words held in int32 tensors."""
    from spacedrive_tpu_torch.ops import blake3_batch as bb

    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((bb.as_i64(a) - bb.as_i64(b)).abs().max().item())


def compressions_of(lengths: np.ndarray) -> int:
    """Block compressions a chunk stage needs: ceil(len / 64), one for empty."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return int(np.maximum((lengths + 63) // 64, 1).sum())


def n_chunks_np(lengths: np.ndarray) -> np.ndarray:
    lengths = np.asarray(lengths, dtype=np.int64)
    return np.maximum((lengths + 1023) // 1024, 1)


def span_of(C: int, span: int) -> int:
    """The fused launch's S for a C-chunk grid (ops/blake3_cuda._geometry)."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    return 1 << blake3_cuda._geometry(C, span)[0]


def chunk_work(lengths: np.ndarray, C: int, span: int, fused: bool) -> tuple:
    """(compressions, bytes) of one chunk-kernel launch on this data.

    Active message blocks and lengths are read once. The CV form writes
    [8, B, C] CVs; the fused form adds the parents inside each span and
    writes one 32-byte top per span that holds chunks.
    """
    blocks = compressions_of(lengths)
    B = len(lengths)
    if not fused:
        return blocks, blocks * 64 + 4 * B + 32 * B * C
    n = n_chunks_np(lengths)
    spans = -(-n // span_of(C, span))
    return blocks + int((n - spans).sum()), blocks * 64 + 4 * B + 32 * int(spans.sum())


def fold_work(lengths: np.ndarray, C: int, span: int) -> tuple:
    """(parent compressions, bytes) of the folds after a fused launch."""
    n = n_chunks_np(lengths)
    spans = -(-n // span_of(C, span))
    return int((spans - 1).sum()), 32 * int(spans.sum()) + 4 * len(lengths) + 32 * len(lengths)


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)(.*)")
SASS_TARGET = re.compile(r"\bBRA\s+(?:`\(\s*)?(0x[0-9a-f]+)")


def sass_loop_opcodes(sass: str, kernel: str) -> collections.Counter:
    """Opcodes of the largest loop (a branch back to an earlier address, up
    to that branch) in the SASS of the function whose mangled name contains
    `kernel`."""
    funcs = sass.split("Function : ")[1:]
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), None)
    require(body is not None, f"no SASS function matching {kernel}")
    insns, best = [], None
    for line in body.splitlines():
        m = SASS_INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        insns.append((addr, m.group(2)))
        target = SASS_TARGET.search(m.group(2) + m.group(3))
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            if best is None or addr - lo > best[1] - best[0]:
                best = (lo, addr)
    require(best is not None, f"no loop in the SASS of {kernel}")
    return collections.Counter(op for addr, op in insns if best[0] <= addr <= best[1])


class Bound:
    """Least time the card could take: max(compressions x LANE_CYCLES over
    the SMs at their max clock, bytes / HBM rate)."""

    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        clock = nvidia_smi("clocks.max.sm").split()[0]
        self.clock_mhz = float(clock)

    def ms(self, compressions: int, nbytes: int) -> tuple:
        t_ops = compressions * LANE_CYCLES / (self.sms * self.clock_mhz * 1e6) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_stats(bound: Bound, ms: float, plain_ms: float, work: tuple, err: int,
                 shape) -> dict:
    bound_ms, bound_by = bound.ms(*work)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, shape=list(shape), compressions=work[0], bytes=work[1])


def phase_build():
    """Build every native source of the port at once (one compiler process
    each), then read the chunk kernel's SASS."""
    import concurrent.futures

    from spacedrive_tpu_torch.ops import _build

    names = ("blake3_chunk", "hamming", "sdio_stage", "imgdec", "jpegdec", "tiffdec", "webpdec",
             "webpenc")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.compile_source, names))
    seconds = time.perf_counter() - t0
    for name in names:
        _build.library(name)
    ptxas = {}
    for name in ("blake3_chunk", "hamming"):
        log = _build.library_path(name).with_suffix(".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    lib = _build.library_path("blake3_chunk")
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    # The chunk loop of K1's CV form: one block compression per iteration.
    # What this build issues, beside what the function needs (the bound).
    ops = sass_loop_opcodes(sass, "blake3_chunk_spanILb0ELb0EE")
    alu = sum(v for k, v in ops.items() if k in ALU_OPS)
    fma = sum(v for k, v in ops.items() if k in FMA_OPS)
    emit("build", seconds=seconds, sources=list(names), ptxas=ptxas,
         sass_loop_opcodes=dict(ops.most_common()),
         compiled=dict(alu_insns=alu, fma_insns=fma, issued=sum(ops.values()),
                       alu_cycles_per_lane=alu / ALU_LANES),
         function=dict(ops=COMPRESSION_OPS, alu_ops=COMPRESSION_ALU_OPS,
                       lane_cycles=LANE_CYCLES))


def phase_identify_step(bound: Bound, stats: dict):
    from spacedrive_tpu_torch.ops import blake3_batch as bb
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_torch, cas

    B = 16384
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, size=(B, cas.LARGE_PAYLOAD_SIZE), dtype=np.uint8)
    sizes = rng.integers(200_000, 50_000_000, size=B).astype(np.uint64)
    words, lengths = bb.build_cas_messages(payloads, sizes)
    C = words.shape[1]
    require(words.shape == (B, blake3_torch.LARGE_CHUNKS, 256), f"grid {words.shape}")
    w, n = blake3_torch.words_to_device(words, lengths, "cuda")

    cvs, n_chunks = blake3_cuda.chunk_cvs_fast(w, n)
    cvs_plain, n_plain = bb.chunk_cvs(w, n)
    err_cv = max_abs_err(cvs, cvs_plain)
    require(err_cv == 0 and torch.equal(n_chunks, n_plain), "K1 CV != plain at the identify step")
    plain_digests = bb.tree_reduce(cvs_plain, n_plain)
    digests = blake3_torch.blake3_words(w, n, "cuda")
    err = max_abs_err(digests, plain_digests)
    require(err == 0, "K1 fused digests != plain at the identify step")
    got = bb.digests_to_cas_ids(blake3_torch.digests_to_numpy(digests))
    for row in (0, B // 2, B - 1):
        require(got[row] == cas.cas_id_of_payload(int(sizes[row]), payloads[row].tobytes()),
                f"row {row} != oracle")

    cv_ms = time_device(lambda: blake3_cuda._chunk(w, n, windowed=False, fused=False), reps=20)
    fused_ms = time_device(lambda: blake3_cuda.blake3_words(w, n), reps=20)
    plain_chunk_ms = time_device(lambda: bb.chunk_cvs(w, n), reps=3)
    plain_tree_ms = time_device(lambda: bb.tree_reduce(cvs, n_chunks), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2e = blake3_torch.blake3_words(words, lengths, "cuda")
    blake3_torch.digests_to_numpy(e2e)
    e2e_s = time.perf_counter() - t0
    stats[blake3_cuda.FAST_CVS] = kernel_stats(
        bound, cv_ms, plain_chunk_ms, chunk_work(lengths, C, blake3_cuda.SPAN, False),
        err_cv, words.shape)
    stats[blake3_cuda.FAST] = kernel_stats(
        bound, fused_ms, plain_chunk_ms + plain_tree_ms,
        chunk_work(lengths, C, blake3_cuda.SPAN, True), err, words.shape)
    emit("identify_step", B=B, C=C, k1_cv_ms=cv_ms, k1_fused_ms=fused_ms,
         plain_chunk_ms=plain_chunk_ms,
         plain_tree_ms=plain_tree_ms, device_ms=fused_ms,
         slice1_device_ms=SLICE1_STEP_MS, files_per_s_device=B / (fused_ms / 1e3),
         e2e_h2d_hash_d2h_s=e2e_s, e2e_files_per_s=B / e2e_s,
         cv=stats[blake3_cuda.FAST_CVS], fused=stats[blake3_cuda.FAST],
         roofline_share_fused=stats[blake3_cuda.FAST]["bound_ms"] / fused_ms)


def phase_small_grid(stats: dict):
    from spacedrive_tpu_torch.ops import blake3_batch as bb
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, blake3_torch

    B = 2048
    edges = [0, 1, 63, 64, 65, 1024, 1025, 2048, 3071, 4096, blake3_torch.SMALL_MSG_MAX]
    rng = np.random.default_rng(1)
    lens = edges + rng.integers(0, blake3_torch.SMALL_MSG_MAX + 1, B - len(edges)).tolist()
    msgs = [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in lens]
    words, lengths = bb.pack_messages(msgs, max_chunks=blake3_torch.SMALL_CHUNKS)
    require(words.shape[1] == 101, f"grid {words.shape}")
    w, n = blake3_torch.words_to_device(words, lengths, "cuda")
    cvs, n_chunks = blake3_cuda.chunk_cvs_fast(w, n)
    cvs_plain, n_plain = bb.chunk_cvs(w, n)
    err_cv = max_abs_err(cvs, cvs_plain)
    require(err_cv == 0 and torch.equal(n_chunks, n_plain), "K1 CV != plain on the small grid")
    digests = blake3_cuda.blake3_words(w, n)
    err = max_abs_err(digests, bb.tree_reduce(cvs_plain, n_plain))
    require(err == 0, "K1 fused != plain on the small grid")
    hexes = bb.digests_to_hex(blake3_torch.digests_to_numpy(digests))
    for i in range(len(edges)):
        require(hexes[i] == blake3_ref.blake3_hex(msgs[i]), f"edge length {lens[i]} != oracle")
    for name, e in ((blake3_cuda.FAST_CVS, err_cv), (blake3_cuda.FAST, err)):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
    emit("small_grid", B=B, C=101, max_abs_err_cv=err_cv, max_abs_err_fused=err,
         edge_lengths=edges)


def _sparse_file(path: Path, size: int, marks: bytes) -> None:
    """`size` bytes, holes except `marks` written at every sample range."""
    from spacedrive_tpu_torch.ops import cas

    with open(path, "wb") as f:
        f.truncate(size)
        for offset, _length in cas.sample_spec(size):
            f.seek(offset)
            f.write(marks)


def build_identify_corpus(root: Path, n_files: int):
    """(path, declared size) pairs plus the planted duplicate groups."""
    rng = np.random.default_rng(4)
    files, planted = [], []
    n_large = n_files * 3 // 4
    for i in range(n_large - 16):
        size = int(rng.integers(200_000, 50_000_000))
        p = root / f"large-{i}"
        _sparse_file(p, size, rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
        files.append((str(p), size))
    for g in range(4):  # planted large duplicates: 4 groups of 4 identical files
        size = int(rng.integers(200_000, 50_000_000))
        marks = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        group = []
        for j in range(4):
            p = root / f"dup-large-{g}-{j}"
            _sparse_file(p, size, marks)
            group.append(str(p))
            files.append((str(p), size))
        planted.append(sorted(group))
    for g in range(8):  # planted small duplicates: 8 groups of 3
        data = rng.integers(0, 256, int(rng.integers(1, 100_000)), dtype=np.uint8).tobytes()
        group = []
        for j in range(3):
            p = root / f"dup-small-{g}-{j}"
            p.write_bytes(data)
            group.append(str(p))
            files.append((str(p), len(data)))
        planted.append(sorted(group))
    (root / "empty").write_bytes(b"")
    files.append((str(root / "empty"), 0))
    files.append((str(root / "missing"), 12345))
    stale = root / "stale"
    stale.write_bytes(rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes())
    files.append((str(stale), 9_000_000))
    i = 0
    while len(files) < n_files:
        size = int(rng.integers(64, 16_384)) if i % 16 else 102_400 - (i % 3)
        p = root / f"small-{i}"
        p.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        files.append((str(p), size))
        i += 1
    return files, sorted(planted)


# Phase 4 holds every PLAIN_STRIDE-th file against the plain path (phase 2
# holds K1 against plain at the full step shape; the script's time limit
# leaves room for no more).
PLAIN_STRIDE = 4


def phase_real_files(workdir: Path, counts: dict):
    """Phase 4. Returns the corpus's readable large files for the ring."""
    from spacedrive_tpu_torch.ops import blake3_batch as bb
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_torch, cas, staging
    from spacedrive_tpu_torch.ops.hamming import exact_dup_groups

    root = workdir / "identify"
    root.mkdir()
    t0 = time.perf_counter()
    files, planted = build_identify_corpus(root, 16384)
    corpus_s = time.perf_counter() - t0

    # Set-up, outside the measured window: the two pinned staging pages.
    pool = staging.cas_pool(files)
    require(pool.pinned and all(page.is_pinned() for page in pool._pages),
            "identify staging pages are not pinned")
    n_threads = staging.default_threads()

    # The identify main path, counted.
    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    t0 = time.perf_counter()
    ids, errors = staging.cas_ids_for_files(files, backend="cuda", pool=pool)
    identify_s = time.perf_counter() - t0
    counts["identify"] = dict(blake3_cuda.launches)
    require(counts["identify"][blake3_cuda.FAST] == 2,
            f"identify path launched {counts['identify']}, not one K1 per size class")
    require(pool.in_use == 0, f"{pool.in_use} identify leases never came back")

    # The plain path on every PLAIN_STRIDE-th file and the odd ones (empty,
    # missing, stale): both size classes, their edges and the errors.
    odd = {i for i, (p, _) in enumerate(files) if Path(p).name in ("empty", "missing", "stale")}
    checked = sorted(set(range(0, len(files), PLAIN_STRIDE)) | odd)
    t0 = time.perf_counter()
    plain_ids, plain_errors = staging.cas_ids_for_files([files[i] for i in checked],
                                                        backend="plain")
    plain_s = time.perf_counter() - t0
    require(all(ids.get(i) == plain_ids.get(j) for j, i in enumerate(checked)),
            "cuda CAS IDs != plain CAS IDs")
    require({i for i in errors if i in set(checked)} == {checked[j] for j in plain_errors},
            "cuda errors != plain errors")
    names = sorted(Path(files[i][0]).name for i in errors)
    require(names == ["missing", "stale"], f"unexpected errors {names}")
    require(ids[[p for p, _ in files].index(str(root / "empty"))] is None, "empty file has an id")
    sample = np.random.default_rng(5).choice(
        [i for i, cid in ids.items() if cid is not None], 16, replace=False)
    for i in sample:
        require(ids[int(i)] == cas.generate_cas_id(*files[int(i)]), f"{files[int(i)][0]} != oracle")
    keyed = [(i, cid) for i, cid in sorted(ids.items()) if cid is not None]
    groups = exact_dup_groups([cid for _, cid in keyed])
    found = sorted(sorted(files[keyed[j][0]][0] for j in g) for g in groups.values())
    require(found == planted, f"dup groups {len(found)} != planted {len(planted)}")

    # Where the time goes on this path (a second, uncounted run): native
    # staging into the pinned page, the non-blocking copy, K1, D2H + format.
    large_idx, small_idx, _ = staging._classes(files)
    split = {}
    for name, idx in (("large", large_idx), ("small", small_idx)):
        batch = [files[i] for i in idx]
        t0 = time.perf_counter()
        staged = staging.stage_batch_native(batch, pool, n_threads=n_threads)
        t1 = time.perf_counter()
        require(staged.lease.page.is_pinned(), f"{name} page is not pinned")
        w, n = blake3_torch.words_to_device(*staged.tensors(), "cuda", non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        staged.release()
        digests = blake3_torch.blake3_words(w, n, "cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        bb.digests_to_cas_ids(blake3_torch.digests_to_numpy(digests))
        t4 = time.perf_counter()
        readable = [r for r in range(len(idx)) if r not in staged.errors]
        require(staged.fallback_files == 0,
                f"{staged.fallback_files} readable {name} files fell back to Python reads")
        split[name] = dict(rows=len(idx), C=int(staged.words.shape[1]), readable=len(readable),
                           native_stage_s=t1 - t0, h2d_s=t2 - t1, pinned=True,
                           h2d_bytes=int(w.numel() * 4 + n.numel() * 4),
                           hash_s=t3 - t2, d2h_format_s=t4 - t3,
                           fallback_files=staged.fallback_files)
    require(pool.in_use == 0, "split-run leases never came back")

    # The plain path's host work, for comparison: Python readers, packing.
    t0 = time.perf_counter()
    large, small, _empty, _err = staging.stage_files(files)
    python_stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in (large, small):
        bb.build_cas_messages(batch.payloads, batch.sizes, batch.payload_lens)
    pack_s = time.perf_counter() - t0
    emit("real_files", files=len(files), corpus_build_s=corpus_s,
         identify_s=identify_s, identify_files_per_s=len(files) / identify_s,
         plain_s=plain_s, plain_files=len(checked), errors=names, dup_groups=len(found),
         launches=counts["identify"], n_threads=n_threads,
         pinned_bytes=pool.pinned_bytes, pin_alloc_s=pool.alloc_s,
         native_stage_s=sum(v["native_stage_s"] for v in split.values()),
         split=split, python_stage_s=python_stage_s, pack_s=pack_s)
    large_files = [(p, size) for p, size in files
                   if size > cas.MINIMUM_FILE_SIZE and Path(p).name != "stale"]
    return large_files, {files[i][0]: cid for i, cid in ids.items()}, planted


def phase_validate(workdir: Path, bound: Bound, counts: dict, stats: dict):
    from spacedrive_tpu_torch.objects import validator
    from spacedrive_tpu_torch.ops import blake3_batch as bb
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_ref, cas, seqhash

    root = workdir / "validate"
    root.mkdir()
    rng = np.random.default_rng(6)
    page = []
    for i in range(validator.BATCH_ROWS):  # one page: 512 rows of ≤ 128 KiB
        p = root / f"page-{i}"
        p.write_bytes(rng.integers(0, 256, int(rng.integers(1, 120_000)),
                                   dtype=np.uint8).tobytes())
        page.append(str(p))
    window = seqhash.DEFAULT_WINDOW_CHUNKS * bb.CHUNK_LEN
    big = root / "big"
    big.write_bytes(rng.integers(0, 256, 8 * window + 12345, dtype=np.uint8).tobytes())
    paths = page + [str(big)]

    # The validate main path, counted.
    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    t0 = time.perf_counter()
    sums, errors = validator.checksums_for_files(paths, "cuda")
    validate_s = time.perf_counter() - t0
    counts["validate"] = dict(blake3_cuda.launches)
    require(not errors, f"validator errors {errors}")
    for name in (blake3_cuda.FAST, blake3_cuda.WINDOWED, blake3_cuda.FOLD):
        require(counts["validate"][name] > 0, f"validate path launched no {name}")

    plain, _ = validator.checksums_for_files(page, "cpu")
    require(all(sums[i] == plain[i] for i in range(len(page))), "page != plain")
    for i in (0, 7, len(page) // 2, len(page) - 1):
        require(sums[i] == cas.file_checksum(page[i]), f"{page[i]} != oracle")
    require(sums[len(page)] == seqhash.file_checksum_streaming(big, "cpu"),
            "streamed big file != plain streamed")

    # K2's two forms against plain on the card, window by window.
    data = big.read_bytes()
    err_cv = err_top = 0
    n_windows = 0
    for k in range(0, len(data), window):
        chunk = data[k:k + window]
        buf = np.zeros(window, np.uint8)
        buf[:len(chunk)] = np.frombuffer(chunk, np.uint8)
        w = bb.words_to_tensor(buf.view("<u4").reshape(1, -1, 256), "cuda")
        n = torch.tensor([len(chunk)], dtype=torch.int32, device="cuda")
        base = k // bb.CHUNK_LEN
        got, got_n = blake3_cuda.chunk_cvs(w, n, base, whole=False)
        ref, ref_n = bb.chunk_cvs(w, n, base, whole=False)
        err_cv = max(err_cv, max_abs_err(got, ref))
        require(torch.equal(got_n, ref_n), "K2 n_chunks != plain")
        err_top = max(err_top, max_abs_err(blake3_cuda.window_top(w, n, base),
                                           bb.tree_reduce(ref, ref_n, root=False)[0]))
        n_windows += 1
    require(err_cv == 0, "K2 CV != plain on the big file's windows")
    require(err_top == 0, "K2 fused window top != plain on the big file's windows")

    # K2 at counter bases straddling 2**32 (per-file bases: one pinned copy),
    # window tops there, and a one-chunk non-whole window.
    words = rng.integers(0, 2**32, size=(5, 8, 256), dtype=np.uint32)
    lengths = np.array([8192, 5000, 1024, 0, 700], np.int32)
    bases = np.array([2**32 - 3, 2**32 - 1, 2**32, 2**40 + 7, 0], np.uint64)
    whole = np.array([False, True, False, True, False])
    w = bb.words_to_tensor(words, "cuda")
    n = torch.from_numpy(lengths).to("cuda")
    got, _ = blake3_cuda.chunk_cvs(w, n, bases, whole)
    ref, _ = bb.chunk_cvs(w, n, bases, whole)
    err_cv = max(err_cv, max_abs_err(got, ref))
    require(err_cv == 0, "K2 CV != plain at counter bases straddling 2**32")
    for row, base in ((0, 2**32 - 3), (1, 2**32 - 1), (0, 2**40 + 7)):
        ref, ref_n = bb.chunk_cvs(w[row:row + 1], n[row:row + 1], base, whole=False)
        err_top = max(err_top, max_abs_err(
            blake3_cuda.window_top(w[row:row + 1], n[row:row + 1], base),
            bb.tree_reduce(ref, ref_n, root=False)[0]))
    require(err_top == 0, "K2 fused window top != plain at counter bases past 2**32")
    msg = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    mw, ml = bb.pack_messages([msg])
    mw, ml = bb.words_to_tensor(mw, "cuda"), torch.from_numpy(ml).to("cuda")
    rooted, _ = blake3_cuda.chunk_cvs(mw, ml, 0, whole=True)
    window_cv, _ = blake3_cuda.chunk_cvs(mw, ml, 0, whole=False)
    plain_window, _ = bb.chunk_cvs(mw, ml, 0, whole=False)
    require(max_abs_err(window_cv, plain_window) == 0, "K2 whole=False != plain")
    require(bb.tensor_to_words(rooted[:, 0, 0]).astype("<u4").tobytes().hex()
            == blake3_ref.blake3_hex(msg), "K2 whole=True != oracle")
    require(not torch.equal(rooted, window_cv), "whole=False window was ROOT-finalized")

    # A ~3 MiB file in 256 KiB windows (two spans and a fold each) against the oracle.
    mid = root / "mid"
    mid.write_bytes(rng.integers(0, 256, 3 * 2**20 + 777, dtype=np.uint8).tobytes())
    mid_sum = seqhash.file_checksum_streaming(mid, "cuda", 256)
    require(mid_sum == cas.file_checksum(mid), "3 MiB streamed file != oracle")

    # One full 8 MiB window at the validator's shape, device inputs prepared:
    # K2 CV, K2 fused (span tops), the fold, and window_top.
    buf = np.frombuffer(data[:window], np.uint8)
    w = bb.words_to_tensor(buf.view("<u4").reshape(1, -1, 256), "cuda")
    n = torch.tensor([window], dtype=torch.int32, device="cuda")
    C, base, lens = w.shape[1], 8192, np.array([window])
    S = span_of(C, blake3_cuda.SPAN)
    cvs_plain, n_plain = bb.chunk_cvs(w, n, base, whole=False)
    top_plain = bb.tree_reduce(cvs_plain, n_plain, root=False)[0]
    # Every span of a full window is full, so the plain span tops are the
    # spans reduced as separate S-chunk messages, and their fold a message
    # of C / S tops.
    span_cvs = cvs_plain.view(8, C // S, S)
    span_n = torch.full((C // S,), S, dtype=torch.int32, device="cuda")
    tops_plain = bb.tree_reduce(span_cvs, span_n, root=False)
    fold_in = tops_plain.T.contiguous().view(8, 1, C // S)
    fold_n = torch.tensor([C // S], dtype=torch.int32, device="cuda")

    def k2_fused():
        return blake3_cuda._chunk(w, n, windowed=True, fused=True, counter_base=base)

    tops = k2_fused()
    err_k2 = max_abs_err(tops.view(-1, 8), tops_plain)
    require(err_k2 == 0, "K2 fused span tops != plain")
    level = S.bit_length() - 1
    folded = blake3_cuda._fold(tops, n, level, windowed=True)
    err_fold = max_abs_err(folded[0], top_plain)
    require(err_fold == 0, "fold != plain tree")
    require(max_abs_err(bb.tree_reduce(fold_in, fold_n, root=False)[0], top_plain) == 0,
            "plain span decomposition != plain tree")
    def k2_cv(words, length, counter_base):
        return blake3_cuda._chunk(words, length, windowed=True, fused=False,
                                  counter_base=counter_base, whole=False)

    cv_ms = time_device(lambda: k2_cv(w, n, base), reps=200)
    fused_ms = time_device(k2_fused, reps=200)
    fold_ms = time_device(lambda: blake3_cuda._fold(tops, n, level, windowed=True), reps=200)
    plain_chunk_ms = time_device(lambda: bb.chunk_cvs(w, n, base, whole=False), reps=3)
    plain_spans_ms = time_device(lambda: bb.tree_reduce(span_cvs, span_n, root=False), reps=5)
    plain_fold_ms = time_device(lambda: bb.tree_reduce(fold_in, fold_n, root=False), reps=5)
    plain_tree_ms = time_device(lambda: bb.tree_reduce(cvs_plain, n_plain, root=False), reps=5)

    # Dependent latency of one compression: a one-lane launch with 16
    # blocks against one with 1 block.
    z = torch.zeros((1, 1, 256), dtype=torch.int32, device="cuda")
    full, one = (torch.tensor([k], dtype=torch.int32, device="cuda") for k in (1024, 64))
    t16 = time_device(lambda: k2_cv(z, full, 0), reps=500)
    t1 = time_device(lambda: k2_cv(z, one, 0), reps=500)
    latency_ms = (t16 - t1) / 15
    depth = 16 + (C - 1).bit_length()
    floor_ms = depth * latency_ms

    fold_parents, fold_bytes = fold_work(lens, C, blake3_cuda.SPAN)
    stats[blake3_cuda.WINDOWED_CVS] = kernel_stats(
        bound, cv_ms, plain_chunk_ms, chunk_work(lens, C, blake3_cuda.SPAN, False),
        err_cv, w.shape)
    stats[blake3_cuda.WINDOWED] = kernel_stats(
        bound, fused_ms, plain_chunk_ms + plain_spans_ms,
        chunk_work(lens, C, blake3_cuda.SPAN, True), max(err_k2, err_top), w.shape)
    stats[blake3_cuda.FOLD] = kernel_stats(
        bound, fold_ms, plain_fold_ms, (fold_parents, fold_bytes), err_fold,
        [1, C // S, 8])
    window_ms = time_device(lambda: blake3_cuda.window_top(w, n, base), reps=200)
    emit("validate", files=len(paths), validate_s=validate_s, launches=counts["validate"],
         big_file_bytes=len(data), windows=n_windows, k2_cv_ms=cv_ms, k2_fused_ms=fused_ms,
         fold_ms=fold_ms, window_top_ms=window_ms,
         slice1_window_ms=SLICE1_WINDOW_MS, plain_chunk_ms=plain_chunk_ms,
         plain_tree_ms=plain_tree_ms, plain_span_tops_ms=plain_spans_ms,
         plain_fold_ms=plain_fold_ms, compression_latency_ms=latency_ms,
         one_lane_16_blocks_ms=t16, one_lane_1_block_ms=t1,
         latency_floor_ms=floor_ms, latency_floor_depth=depth,
         cv=stats[blake3_cuda.WINDOWED_CVS], fused=stats[blake3_cuda.WINDOWED],
         fold=stats[blake3_cuda.FOLD])
    # Every file of the directory with its checksum, each held against plain
    # or the oracle above: what phase 8's validator job must write.
    return {**{p: sums[i] for i, p in enumerate(paths)}, str(mid): mid_sum}


def plain_digests(batches) -> list:
    """The plain version of each ring batch: Python readers, host packing,
    the plain torch K1 on the card."""
    from spacedrive_tpu_torch.ops import blake3_batch as bb
    from spacedrive_tpu_torch.ops import blake3_torch, staging

    out = []
    for paths, sizes in batches:
        large, _small, _empty, errors = staging.stage_files(list(zip(paths, sizes.tolist())))
        require(not errors and len(large.indexes) == len(paths), f"plain staging: {errors}")
        words, lengths = bb.build_cas_messages(large.payloads, large.sizes)
        w, n = blake3_torch.words_to_device(words, lengths, "cuda")
        out.append(blake3_torch.digests_to_numpy(bb.tree_reduce(*bb.chunk_cvs(w, n))))
    return out


def staging_probe(workdir: Path, batch) -> dict:
    """Where one staged file's time goes on this host: the C plane on one
    batch at 1, 2, 4 and 8 threads, single-threaded Python timings of the
    system calls a file costs, and the file system the corpus lives on."""
    import mmap
    import os
    import platform

    from spacedrive_tpu_torch.ops import staging

    paths, sizes = batch
    files = list(zip(paths, sizes.tolist()))
    pool = staging.StagePool("cuda", 1, staging_page_bytes(len(files)))
    staging.stage_batch_native(files, pool).release()  # warm
    threads = {}
    for n in (1, 2, 4, 8):
        t0 = time.perf_counter()
        staging.stage_batch_native(files, pool, n_threads=n).release()
        threads[n] = time.perf_counter() - t0
    per_file_us = {}
    t0 = time.perf_counter()
    fds = [os.open(p, os.O_RDONLY) for p in paths]
    per_file_us["open"] = (time.perf_counter() - t0) / len(paths) * 1e6
    for name, call in (("fstat", lambda fd: os.fstat(fd)),
                       ("pread_10KiB", lambda fd: os.pread(fd, 10240, 20000)),
                       ("mmap_munmap", lambda fd: mmap.mmap(fd, 0, prot=mmap.PROT_READ).close())):
        t0 = time.perf_counter()
        for fd in fds:
            call(fd)
        per_file_us[name] = (time.perf_counter() - t0) / len(fds) * 1e6
    t0 = time.perf_counter()
    for fd in fds:
        os.close(fd)
    per_file_us["close"] = (time.perf_counter() - t0) / len(fds) * 1e6
    real = os.path.realpath(workdir)
    mounts = [ln.split()[:3] for ln in Path("/proc/mounts").read_text().splitlines()]
    mount = max((m for m in mounts if real == m[1] or real.startswith(m[1].rstrip("/") + "/")),
                key=lambda m: len(m[1]), default=None)
    return dict(files=len(paths), stage_s_by_threads=threads, syscall_us=per_file_us,
                fs=mount, kernel=platform.release(), cores=staging.default_threads())


RING_SPARSE_FILES = 12_288


def phase_ring(workdir: Path, large_files: list, counts: dict):
    from spacedrive_tpu_torch.ops import blake3_cuda, cas, overlap

    B = 2048
    require(len(large_files) == 12288, f"phase 4 left {len(large_files)} large files")
    corpora = {"identify_large": [
        ([p for p, _ in large_files[k:k + B]],
         np.array([size for _, size in large_files[k:k + B]], np.uint64))
        for k in range(0, len(large_files), B)]}
    t0 = time.perf_counter()
    # 12 288 sparse files (cut from 16 384 to make room for phase 15)
    sparse = overlap.make_sparse_corpus(str(workdir / "ring"), RING_SPARSE_FILES, 120_000, B)
    rng = np.random.default_rng(7)
    for paths, _ in sparse:  # distinct bytes per file, so a leaked page shows
        for p in paths:
            with open(p, "r+b") as f:
                for offset, _length in cas.sample_spec(120_000):
                    f.seek(offset)
                    f.write(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    corpora["sparse_120k"] = sparse
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # Every batch is held against its plain version: a page reused before its
    # copy finished would corrupt whichever batch it served.
    plain = {name: plain_digests(batches) for name, batches in corpora.items()}
    plain_s = time.perf_counter() - t0
    emit("ring_setup", batch_files=B, batches={k: len(v) for k, v in corpora.items()},
         corpus_build_s=corpus_s, plain_s=plain_s)
    emit("staging_probe", **{name: staging_probe(workdir, batches[1])
                             for name, batches in corpora.items()})

    for name, batches in corpora.items():
        # In turns (1, 3, 3, 1): the host's file-system latency drifts
        # between runs by more than depth changes, so only pairs in one
        # call, in both orders, compare the depths.
        for turn, depth in enumerate((1, 3, 3, 1)):
            torch.cuda.synchronize()
            blake3_cuda.reset_launches()
            # Calibrations before and after the run only: a mid-run pause
            # drains the ring, and 5-7 measured batches leave no room for one.
            res, stats = overlap.run_overlapped(batches, calibrate_every=len(batches),
                                                depth=depth, devices=["cuda"])
            launches = dict(blake3_cuda.launches)
            counts[f"ring/{name}/depth{depth}/{turn}"] = launches
            want = len(batches) + len(stats.samples)
            require(launches[blake3_cuda.FAST] == stats.kernel_batches == want,
                    f"ring {name} depth {depth}: K1 launches {launches} != {want} batches")
            require(sum(launches.values()) == launches[blake3_cuda.FAST],
                    f"ring {name} depth {depth} launched {launches}")
            for k, want in enumerate(plain[name]):
                require(np.array_equal(res[k], want),
                        f"ring {name} depth {depth}: batch {k} digests != plain")
            require(stats.stage_python_batches == 0 and stats.fallback_files == 0,
                    f"ring {name} depth {depth}: Python staging ran")
            require(stats.leases_out == 0, f"ring {name} depth {depth}: leases out")
            require(stats.pinned_bytes == stats.pool_pages * (
                staging_page_bytes(B)) > 0, "ring pages are not pinned")
            emit("ring", corpus=name, depth=depth, turn=turn, batches=len(batches),
                 batch_files=B,
                 files_per_s=stats.files_per_sec,
                 bound_files_per_s=stats.bound_files_per_sec,
                 bound_report=stats.bound_report(), wall_s=stats.wall_s,
                 samples_stage_h2d_kernel_s=stats.samples, stage_stall_s=stats.stage_s,
                 retire_stall_s=stats.retire_stall_s, calibration_s=stats.calibration_s,
                 h2d_s=stats.h2d_s, h2d_bytes=stats.h2d_bytes,
                 h2d_gb_per_s=stats.h2d_bytes / stats.h2d_s / 1e9 if stats.h2d_s else None,
                 depth_high_water=stats.depth_high_water, n_threads=stats.n_threads,
                 pool_pages=stats.pool_pages, pinned_bytes=stats.pinned_bytes,
                 pin_alloc_s=stats.pin_alloc_s, launches=launches,
                 stage_native_batches=stats.stage_native_batches,
                 stage_python_batches=stats.stage_python_batches)


def staging_page_bytes(rows: int) -> int:
    """Bytes of one ring page: `rows` rows on the C = 57 grid plus lengths."""
    from spacedrive_tpu_torch.ops import overlap, staging

    return staging.StagePool.bytes_for(rows, overlap.LARGE_STRIDE)


SCAN_FILES = 100_000       # BASELINE.json config 3's library size
SCAN_FILE_BYTES = 120_000
SCAN_DIR_FILES = 1000


def extend_scan_corpus(root: Path, n_more: int) -> list:
    """`n_more` sparse SCAN_FILE_BYTES-byte files, SCAN_DIR_FILES to a
    sub-directory of `root`, each truncate-created with its index written at
    offset 0 (inside the CAS header sample, so every file has its own CAS
    ID), except two planted pairs whose second file carries the first's
    index. Returns the planted pairs."""
    import concurrent.futures
    import os

    twin = {1: 0, 3: 2}

    def make_dir(d: int) -> None:
        dpath = root / f"scan-{d:03d}"
        dpath.mkdir()
        for i in range(d * SCAN_DIR_FILES, min((d + 1) * SCAN_DIR_FILES, n_more)):
            fd = os.open(dpath / f"f{i:06d}", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.ftruncate(fd, SCAN_FILE_BYTES)
                os.pwrite(fd, f"scan file {twin.get(i, i):08d}".encode(), 0)
            finally:
                os.close(fd)

    n_dirs = -(-n_more // SCAN_DIR_FILES)
    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        list(ex.map(make_dir, range(n_dirs)))
    return [sorted(str(root / "scan-000" / f"f{i:06d}") for i in pair)
            for pair in ((0, 1), (2, 3))]


def _rel_path(root: str, r) -> str:
    ext = f".{r['extension']}" if r["extension"] else ""
    return f"{root}/{r['materialized_path'][1:]}{r['name']}{ext}"


def run_scan(lib, location_id: int, counts: dict, key: str, events: list) -> float:
    """scan_location(backend="cuda", with_media=False) + wait_idle on a fresh
    JobManager, the launch counts reset just before and read just after.
    Returns wall s."""
    import asyncio

    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.ops import blake3_cuda

    async def main():
        jobs = JobManager(on_event=lambda e: events.append((time.perf_counter(), e))
                          if e["type"] == "JobUpdate" else None)
        await locations.scan_location(jobs, lib, location_id, backend="cuda",
                                      with_media=False)
        await jobs.wait_idle()

    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    t0 = time.perf_counter()
    asyncio.run(main())
    wall = time.perf_counter() - t0
    counts[key] = dict(blake3_cuda.launches)
    return wall


@contextlib.contextmanager
def device_spans(module, name: str, spans: list):
    """While open, each call of ``module.name`` is bracketed by a CUDA event
    pair on the caller's current stream, appended to `spans`: the device
    time of the work that call queued. The bracket counts no launch."""
    fn = getattr(module, name)

    def bracketed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    setattr(module, name, bracketed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def spans_s(spans: list) -> float:
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / 1e3


def job_reports(lib) -> list:
    from spacedrive_tpu_torch.jobs.report import JobReport

    return [JobReport.from_row(r) for r in lib.db.query("SELECT * FROM job ORDER BY rowid")]


def phase_scan(workdir: Path, data_dir: str, phase4_ids: dict, phase4_planted: list,
               counts: dict):
    """Phase 7: a SCAN_FILES-file location through the port's job system."""
    import os

    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.objects.identifier import AUTO_DEVICE_BATCH
    from spacedrive_tpu_torch.ops import blake3_cuda, blake3_torch, cas, staging
    from spacedrive_tpu_torch.sync import opblob

    root = workdir / "identify"
    on_disk = sum(len(fs) for _, _, fs in os.walk(root))
    t0 = time.perf_counter()
    planted = phase4_planted + extend_scan_corpus(root, SCAN_FILES - on_disk)
    corpus_s = time.perf_counter() - t0
    regular = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs)
    require(len(regular) == SCAN_FILES, f"{len(regular)} files on disk, not {SCAN_FILES}")

    lib = Libraries(data_dir).create("chip-smoke-scan")
    location_id = locations.create_location(lib, str(root))
    events: list = []
    t_start = time.perf_counter()
    # K1's and the pinned copies' share of the wall: device time between
    # event pairs around each call on the job's stream.
    k1_spans: list = []
    copy_spans: list = []
    actor_before = actor_stats(lib.db)
    with device_spans(blake3_cuda, "blake3_words", k1_spans), \
            device_spans(blake3_torch, "words_to_device", copy_spans):
        wall = run_scan(lib, location_id, counts, "scan", events)
    actor = actor_stats(lib.db, actor_before)
    k1_s, copy_s = spans_s(k1_spans), spans_s(copy_spans)
    launches = counts["scan"]
    db = lib.db

    reports = {rep.name: rep for rep in job_reports(lib)}
    require(set(reports) == {"indexer", "file_identifier"}, f"jobs {sorted(reports)}")
    for name, rep in reports.items():
        require(rep.status == JobStatus.COMPLETED,
                f"{name} ended {rep.status.name}: {rep.errors_text[:2]}")
    rows = db.query("SELECT id, materialized_path, name, extension, size_in_bytes_bytes, "
                    "cas_id, object_id FROM file_path WHERE is_dir = 0 ORDER BY id")
    path_of = {r["id"]: _rel_path(str(root), r) for r in rows}
    require(sorted(path_of.values()) == regular, "file_path rows != regular files on disk")
    sizes = {r["id"]: int.from_bytes(r["size_in_bytes_bytes"], "big") for r in rows}
    require(all(sizes[r["id"]] == os.path.getsize(path_of[r["id"]]) for r in rows[::97]),
            "row sizes != stat sizes")

    # Steps: consecutive pages of AUTO_DEVICE_BATCH orphans in id order; one
    # K1 launch per size class with rows in a page, none for K2 or the fold.
    steps = [rows[k:k + AUTO_DEVICE_BATCH] for k in range(0, len(rows), AUTO_DEVICE_BATCH)]
    classes = sum(any(sizes[r["id"]] > cas.MINIMUM_FILE_SIZE for r in page)
                  + any(0 < sizes[r["id"]] <= cas.MINIMUM_FILE_SIZE for r in page)
                  for page in steps)
    require(launches[blake3_cuda.FAST] == classes,
            f"scan launched {launches}, not one K1 per size class per step ({classes})")
    require(launches[blake3_cuda.WINDOWED] == launches[blake3_cuda.FOLD] == 0,
            f"scan launched K2 or the fold: {launches}")
    require(len(k1_spans) == len(copy_spans) == classes,
            f"{len(k1_spans)} K1 / {len(copy_spans)} copy spans, not {classes}")
    ident = reports["file_identifier"].metadata
    require(ident["chunk_size"] == AUTO_DEVICE_BATCH,
            f"identifier stepped at {ident.get('chunk_size')} files")
    require(ident["pool"]["in_use_after_hash"] == ident["pool"]["in_use_at_end"] == 0,
            f"staging leases out: {ident['pool']}")

    # CAS IDs: an independent cuda call over the same (path, size) list, in
    # steps of the same size on one pool, outside the job.
    files = [(path_of[r["id"]], sizes[r["id"]]) for r in rows]
    pool = staging.cas_pool(AUTO_DEVICE_BATCH)
    t0 = time.perf_counter()
    independent = {}
    for k in range(0, len(files), AUTO_DEVICE_BATCH):
        ids, errors = staging.cas_ids_for_files(files[k:k + AUTO_DEVICE_BATCH], "cuda",
                                                pool=pool)
        require(not errors, f"independent cuda call errors {list(errors.values())[:2]}")
        independent.update({k + i: cid for i, cid in ids.items()})
    independent_s = time.perf_counter() - t0
    require(pool.in_use == 0, "independent call leases out")
    got = [r["cas_id"] for r in rows]
    require(got == [independent[i] for i in range(len(rows))],
            "scan CAS IDs != the independent cuda call")
    by_path = dict(zip((f[0] for f in files), got))
    require(all(by_path.get(p, "absent") == cid for p, cid in phase4_ids.items()),
            "scan CAS IDs != phase 4's on phase 4's files")

    # A sample of 1024 rows drawn from every step against the plain version.
    rng = np.random.default_rng(8)
    sample = sorted(int(k + j) for k in range(0, len(rows), AUTO_DEVICE_BATCH)
                    for j in rng.choice(min(AUTO_DEVICE_BATCH, len(rows) - k),
                                        1024 // len(steps) + 1, replace=False))[:1024]
    t0 = time.perf_counter()
    plain, plain_errors = staging.cas_ids_for_files([files[i] for i in sample], "plain")
    plain_s = time.perf_counter() - t0
    require(not plain_errors and all(plain[j] == got[i] for j, i in enumerate(sample)),
            "scan CAS IDs != plain on the sample")

    empty = [r for r in rows if sizes[r["id"]] == 0]
    require(empty and all(r["cas_id"] is None and r["object_id"] is not None for r in empty),
            "empty files: a CAS ID or no object")
    n_objects = db.query_one("SELECT COUNT(*) AS n FROM object")["n"]
    distinct = len({c for c in got if c is not None})
    require(n_objects == distinct + len(empty),
            f"{n_objects} objects != {distinct} distinct CAS IDs + {len(empty)} empty")
    object_of = {path_of[r["id"]]: r["object_id"] for r in rows}
    for group in planted:
        require(len({object_of[p] for p in group}) == 1, f"planted group split: {group}")
    n_row_ops = db.query_one("SELECT COUNT(*) AS n FROM shared_operation")["n"]
    n_blob_ops = db.query_one("SELECT COALESCE(SUM(n_ops), 0) AS n FROM shared_op_blob")["n"]
    n_paths = db.query_one("SELECT COUNT(*) AS n FROM file_path")["n"]
    require(n_row_ops + n_blob_ops >= n_paths + n_objects,
            f"shared ops {n_row_ops} + {n_blob_ops} < paths {n_paths} + objects {n_objects}")
    blob = db.query_one("SELECT data, n_ops FROM shared_op_blob ORDER BY id DESC LIMIT 1")
    require(len(opblob.decode_entries_py(blob["data"])) == blob["n_ops"], "blob op count")

    done = {e["name"]: t for t, e in events}
    emit("scan", files=len(rows), dirs=n_paths - len(rows), corpus_write_s=corpus_s,
         wall_s=wall, files_per_s=len(rows) / wall,
         indexer_s=done["indexer"] - t_start,
         identifier_s=done["file_identifier"] - done["indexer"],
         indexer_phase_s=reports["indexer"].metadata["phase_s"],
         identifier_phase_s=ident["phase_s"], steps=len(steps), size_classes=classes,
         k1_device_s=k1_s, k1_share_of_wall=k1_s / wall, h2d_device_s=copy_s,
         h2d_share_of_wall=copy_s / wall,
         launches=launches, pool=ident["pool"], objects=n_objects, actor=actor,
         shared_op_rows=n_row_ops, shared_op_blob_ops=n_blob_ops,
         independent_cuda_s=independent_s, plain_sample=len(sample),
         plain_sample_s=plain_s, wal_bytes=os.path.getsize(db.path + "-wal")
         if os.path.exists(db.path + "-wal") else 0, db_bytes=os.path.getsize(db.path))
    return lib


def expected_pages(sizes) -> list:
    """The chunk grid C of each page ``validator.checksums_for_files`` packs
    its small files into (each page pads to the pow2 chunk count of its
    largest file)."""
    from spacedrive_tpu_torch.objects import validator

    pages, rows = [], 0
    for sz in sorted(s for s in sizes if s <= validator.SMALL_FILE_CAP):
        if rows and (rows >= validator.BATCH_ROWS
                     or (rows + 1) * validator._padded_row(sz) > validator.BATCH_BYTES):
            rows = 0
        if rows == 0:
            pages.append(0)
        rows += 1
        pages[-1] = validator._padded_row(sz) // 1024
    return pages


def fold_launches(C: int) -> int:
    """blake3_tree_fold launches after a fused launch on a C-chunk grid."""
    from spacedrive_tpu_torch.ops import blake3_cuda

    n, levels = -(-C // span_of(C, blake3_cuda.SPAN)), 0
    while n > 1:
        n = -(-n // span_of(n, blake3_cuda.SPAN))
        levels += 1
    return levels


def phase_validate_job(workdir: Path, lib, sums: dict, counts: dict):
    """Phase 8: scan phase 5's directory, then ObjectValidatorJob fill and
    verify on the card."""
    import asyncio
    import os

    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.objects.validator import ObjectValidatorJob
    from spacedrive_tpu_torch.ops import blake3_cuda

    root = workdir / "validate"
    location_id = locations.create_location(lib, str(root))
    scan_wall = run_scan(lib, location_id, counts, "validate_dir_scan", [])
    out = {}
    for mode in ("fill", "verify"):
        async def main():
            jobs = JobManager()
            jid = await jobs.ingest(lib, ObjectValidatorJob(location_id=location_id, mode=mode))
            await jobs.wait_idle()
            return jid

        torch.cuda.synchronize()
        blake3_cuda.reset_launches()
        t0 = time.perf_counter()
        jid = asyncio.run(main())
        wall = time.perf_counter() - t0
        counts[f"validate_job_{mode}"] = launches = dict(blake3_cuda.launches)
        rep = next(r for r in job_reports(lib) if r.id == jid)
        require(rep.status == JobStatus.COMPLETED,
                f"validator {mode} ended {rep.status.name}: {rep.errors_text[:2]}")
        require(rep.metadata.get("validated") == len(sums),
                f"validator {mode} validated {rep.metadata.get('validated')}")
        # K1 once per page (a page past one span folds too); the 64 MiB +
        # 12345 B file streams in 9 windows of K2 and one fold each.
        pages = expected_pages(os.path.getsize(p) for p in sums)
        folds = 9 + sum(fold_launches(C) for C in pages)
        require(launches[blake3_cuda.FAST] == len(pages),
                f"validator {mode} launched {launches}, not {len(pages)} pages of K1")
        require(launches[blake3_cuda.WINDOWED] == 9 and launches[blake3_cuda.FOLD] == folds,
                f"validator {mode} launched {launches}, not 9 windows and {folds} folds")
        out[mode] = dict(wall_s=wall, launches=launches, page_grids=pages,
                         mismatched=rep.metadata.get("mismatched", 0))
    require(out["verify"]["mismatched"] == 0, "verify found mismatches")
    rows = lib.db.query("SELECT materialized_path, name, extension, integrity_checksum "
                        "FROM file_path WHERE is_dir = 0 AND location_id = ?", (location_id,))
    written = {_rel_path(str(root), r): r["integrity_checksum"] for r in rows}
    require(written == sums, "validator checksums != phase 5's checksums_for_files")
    emit("validate_job", files=len(written), scan_wall_s=scan_wall,
         scan_launches=counts["validate_dir_scan"], **out)


# -- PNG and BMP writer (harness code: the near-dup corpus and the tests) -----

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(payload, zlib.crc32(kind))))


def pack_bits(values: np.ndarray, depth: int) -> np.ndarray:
    """[h, w] values below 2**depth → [h, rowbytes] bytes, MSB first."""
    h, w = values.shape
    per = 8 // depth
    wide = np.zeros((h, -(-w // per) * per), np.uint16)
    wide[:, :w] = values
    shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint16)
    return (wide.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)


def png_filter(rows: np.ndarray, bpp: int, filters: np.ndarray) -> bytes:
    """[h, rowbytes] raw bytes → the filtered scanlines, row y with PNG
    filter filters[y] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). Filtering
    reads only raw bytes, so every row is predicted at once."""
    r = rows.astype(np.int16)
    h, rb = r.shape
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :rb - bpp] if rb > bpp else a[:, bpp:]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = b[1:, :rb - bpp] if rb > bpp else c[1:, bpp:]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(r), a, b, (a + b) >> 1, paeth])
    out = np.empty((h, rb + 1), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = (r - preds[np.asarray(filters), np.arange(h)]) & 0xFF
    return out.tobytes()


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """[h, rowbytes] MSB-first packed values → [h, width] (pack_bits' inverse)."""
    per = 8 // depth
    shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
    values = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return values.reshape(rows.shape[0], -1)[:, :width]


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def adam7_passes(rows: np.ndarray, width: int, depth: int) -> list:
    """Raw scanlines [h, rowbytes] → (pass rows, pass width, first image
    row, row step) of each of Adam7's seven passes, empty passes left out."""
    h = rows.shape[0]
    if depth < 8:
        pixels = unpack_bits(rows, width, depth)
    else:
        pixels = rows.reshape(h, width, -1)
    out = []
    for x0, y0, dx, dy in ADAM7:
        sub = pixels[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            out.append((pack_bits(sub, depth) if depth < 8 else sub.reshape(sub.shape[0], -1),
                        sub.shape[1], y0, dy))
    return out


def png_bytes(rows: np.ndarray, width: int, ctype: int, depth: int, filters,
              palette=None, trns: bytes = None, level: int = 6,
              interlace: int = 0) -> bytes:
    """A PNG of raw scanlines `rows` [h, rowbytes] (packed below 8 bits,
    big-endian samples at 16); `interlace` 1 writes Adam7's passes, each
    pass row taking the filter of its image row."""
    import struct
    import zlib

    h = rows.shape[0]
    bpp = max(1, PNG_CHANNELS[ctype] * depth // 8)
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    filters = np.asarray(filters)
    if interlace:
        body = b"".join(png_filter(sub, bpp, filters[y0::dy])
                        for sub, _, y0, dy in adam7_passes(rows, width, depth))
    else:
        body = png_filter(rows, bpp, filters)
    out += png_chunk(b"IDAT", zlib.compress(body, level))
    return out + png_chunk(b"IEND", b"")


def png16_rows(values: np.ndarray) -> np.ndarray:
    """[h, w·channels] samples below 2**16 → [h, 2·w·channels] big-endian bytes."""
    return np.ascontiguousarray(values.astype(">u2")).view(np.uint8).reshape(
        values.shape[0], -1)


def bmp_bytes(pixels: np.ndarray, palette=None, top_down: bool = False,
              alpha: np.ndarray = None) -> bytes:
    """An uncompressed BMP (BITMAPINFOHEADER): [h, w, 3] RGB at 24 bits (32
    with `alpha` [h, w]), or [h, w] palette indices at 8 bits with
    `palette` [k, 3] RGB."""
    import struct

    h, w = pixels.shape[:2]
    if palette is not None:
        bits, body = 8, pixels.astype(np.uint8)[:, :, None]
        table = np.zeros((len(palette), 4), np.uint8)
        table[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        table = table.tobytes()
    else:
        bgr = pixels[..., ::-1].astype(np.uint8)
        if alpha is not None:
            bgr = np.concatenate([bgr, alpha.astype(np.uint8)[..., None]], axis=2)
        bits, body, table = 8 * bgr.shape[2], bgr, b""
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = body.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    offset = 14 + 40 + len(table)
    header = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, rows.size,
                       2835, 2835, len(palette) if palette is not None else 0, 0)
    return header + info + table + rows.tobytes()



# -- GIF and ICO writers (harness code: the near-dup corpus and the tests) ------


def lzw_codes(indices: np.ndarray, min_size: int) -> tuple:
    """GIF LZW of the index stream: (codes, widths), a clear code first and
    again whenever the table fills, the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    size, nxt, table = min_size + 1, clear + 2, {}
    flat = indices.reshape(-1).tolist()
    prefix = flat[0]
    for c in flat[1:]:
        code = table.get(prefix << 8 | c)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(size)
        table[prefix << 8 | c] = nxt
        nxt += 1
        if nxt - 1 == 1 << size and size < 12:
            size += 1
        if nxt == 4096:
            codes.append(clear)
            widths.append(size)
            size, nxt, table = min_size + 1, clear + 2, {}
        prefix = c
    codes.append(prefix)
    widths.append(size)
    if nxt == 1 << size and size < 12:  # the decoder's entry for that code
        size += 1
    codes.append(end)
    widths.append(size)
    return np.array(codes, np.int64), np.array(widths, np.int64)


def _pack_lsb(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Variable-width codes packed least significant bit first."""
    ev = np.repeat(np.arange(len(codes)), widths)
    j = np.arange(int(widths.sum())) - np.repeat(np.cumsum(widths) - widths, widths)
    return np.packbits(((codes[ev] >> j) & 1).astype(np.uint8), bitorder="little").tobytes()


def gif_bytes(indices: np.ndarray, palette, local: bool = False, interlace: bool = False,
              screen=None, offset=(0, 0), transparency: int = None) -> bytes:
    """A one-frame GIF89a of [h, w] palette indices: `palette` [k, 3] RGB as
    the global table (or the frame's local one), the frame at `offset` on a
    `screen` (w, h) (the frame's size by default), a graphic control block
    with `transparency`, rows in the four-pass order where `interlace`."""
    import struct

    h, w = indices.shape
    pal = np.asarray(palette, np.uint8)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(pal)] = pal
    min_size = max(2, bits)
    sw, sh = screen or (w, h)
    flags = 0x80 | (bits - 1) << 4 | (bits - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0 if local else flags, 0, 0)
    if not local:
        out += table.tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h,
                                 (0x80 | (bits - 1) if local else 0) | (0x40 if interlace else 0))
    if local:
        out += table.tobytes()
    if interlace:
        order = np.concatenate([np.arange(a, h, b) for a, b in ((0, 8), (4, 8), (2, 4), (1, 2))])
        indices = indices[order]
    data = _pack_lsb(*lzw_codes(indices.astype(np.int64), min_size))
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return out + bytes([min_size]) + blocks + b"\x00\x3b"


def dib_bytes(pixels: np.ndarray, bits: int, palette=None, alpha: np.ndarray = None,
              mask: np.ndarray = None) -> bytes:
    """An ICO frame's DIB: BITMAPINFOHEADER with the doubled height, the
    palette (1, 4 or 8 bits: `pixels` [h, w] indices) or BGR(A) pixels (24
    or 32 bits: `pixels` [h, w, 3] RGB, `alpha` [h, w]), bottom-up, then
    the 1-bit AND `mask` [h, w] (zeros by default)."""
    import struct

    h, w = pixels.shape[:2]
    if bits <= 8:
        table = np.zeros((len(palette), 4), np.uint8)
        table[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        body = pack_bits(pixels.astype(np.int64), bits) if bits < 8 else pixels.astype(np.uint8)
        table = table.tobytes()
    else:
        body = pixels[..., ::-1].astype(np.uint8)
        if bits == 32:
            a = np.zeros((h, w), np.uint8) if alpha is None else alpha.astype(np.uint8)
            body = np.concatenate([body, a[..., None]], axis=2)
        body, table = body.reshape(h, -1), b""
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :body.shape[1]] = body
    mstride = ((w + 31) >> 3) & ~3
    mrows = np.zeros((h, mstride), np.uint8)
    mrows[:, :-(-w // 8)] = pack_bits(np.zeros((h, w), np.int64) if mask is None
                                      else mask.astype(np.int64), 1)
    info = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, rows.size + mrows.size, 0, 0,
                       len(palette) if bits <= 8 else 0, 0)
    return info + table + rows[::-1].tobytes() + mrows[::-1].tobytes()


def ico_bytes(frames: list) -> bytes:
    """An ICO of frames [(image bytes: PNG or DIB, width, height, bit count)]."""
    import struct

    out = struct.pack("<HHH", 0, 1, len(frames))
    offset = 6 + 16 * len(frames)
    for data, w, h, bits in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bits, len(data), offset)
        offset += len(data)
    return out + b"".join(f[0] for f in frames)

# -- JPEG writer (harness code: the near-dup corpus and the tests) -------------

# ITU T.81 Annex K's tables: the luminance and chrominance quantisation
# tables (row-major) and the typical Huffman tables (code counts by length
# 1..16, then the symbols).
JPEG_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
             + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38))
_AC_SYMBOLS = [(r << 4) | s for r in range(16) for s in range(1, 11)]
JPEG_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
        0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
        0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
        0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
        0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
        0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
        0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
        0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
        0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
        0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
        0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
        0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
        0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
        0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
        0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)),
}
# The progression of a progressive file: DC first at Al = 1 (all components
# interleaved), two AC bands per component, then the DC refinement.
JPEG_PROGRESSION = ((0, 0, 0, 1), (1, 5, 0, 0), (6, 63, 0, 0), (0, 0, 1, 0))


def _dct_matrix() -> np.ndarray:
    k, n = np.arange(8)[:, None], np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


_ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8, (i // 8 if (i // 8 + i % 8) % 2
                                                                      else i % 8))))


def jpeg_quant(quality: int, chroma: bool) -> np.ndarray:
    """IJG's scaling of Annex K's table to `quality` (1..100), row-major."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((JPEG_QUANT[int(chroma)] * scale + 50) // 100, 1, 255)


def _huffman_codes(table) -> tuple:
    """(code, length) arrays indexed by symbol for Annex K's canonical code."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, 1):
        for _ in range(count):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _magnitude(v: np.ndarray) -> tuple:
    """(category, extra bits) of JPEG's value coding."""
    s = np.zeros(v.shape, np.int64)
    a = np.abs(v)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s, np.where(v >= 0, v, v + (1 << s) - 1)


def _scan_events(zz: np.ndarray, seq: np.ndarray, comp: np.ndarray, interval: np.ndarray,
                 spec: tuple, tables: list) -> tuple:
    """(codes, lengths, interval) of every Huffman code or raw bit field a
    scan writes, in stream order: blocks zz[seq] (component comp, restart
    interval interval) under spec (Ss, Se, Ah, Al)."""
    ss, se, ah, al = spec
    n = len(seq)
    keys, codes, lens = [], [], []
    if ss == 0 and ah:  # DC refinement: one raw bit a block
        return (zz[seq, 0] >> al) & 1, np.ones(n, np.int64), interval
    if ss == 0:
        dc = zz[seq, 0] >> al
        prev = np.zeros(n, np.int64)
        for c in np.unique(comp):
            at = np.nonzero(comp == c)[0]
            p = np.concatenate([[0], dc[at][:-1]])
            p[np.concatenate([[True], interval[at][1:] != interval[at][:-1]])] = 0
            prev[at] = p
        s, extra = _magnitude(dc - prev)
        tab = np.stack([t[0] for t in tables])
        code_of, len_of = tab[comp, 0, s], tab[comp, 1, s]
        keys.append(np.arange(n) * 200)
        codes.append(code_of << s | extra)
        lens.append(len_of + s)
    if se > 0:
        lo = max(ss, 1)
        band = zz[seq, lo:se + 1]
        band = np.where(band >= 0, band >> al, -((-band) >> al))
        width = se - lo + 1
        actab = np.stack([t[1] for t in tables])
        bi, k = np.nonzero(band)
        first = np.concatenate([[True], bi[1:] != bi[:-1]])
        prevk = np.where(first, -1, np.concatenate([[0], k[:-1]]))
        run = k - prevk - 1
        zrl, r = run // 16, run % 16
        s, extra = _magnitude(band[bi, k])
        sym = r << 4 | s
        keys.append(bi * 200 + 2 * k + 2)
        codes.append(actab[comp[bi], 0, sym] << s | extra)
        lens.append(actab[comp[bi], 1, sym] + s)
        zi = np.repeat(np.arange(len(bi)), zrl)
        keys.append(bi[zi] * 200 + 2 * k[zi] + 1)
        codes.append(actab[comp[bi[zi]], 0, 0xF0])
        lens.append(actab[comp[bi[zi]], 1, 0xF0])
        last = np.full(n, -1)
        np.maximum.at(last, bi, k)
        eob = np.nonzero(last < width - 1)[0]
        keys.append(eob * 200 + 199)
        codes.append(actab[comp[eob], 0, 0])
        lens.append(actab[comp[eob], 1, 0])
    keys = np.concatenate(keys)
    if any((ln == 0).any() for ln in lens):
        raise ValueError("a coefficient past Annex K's Huffman tables")
    order = np.argsort(keys, kind="stable")
    return (np.concatenate(codes)[order], np.concatenate(lens)[order],
            interval[keys[order] // 200])


def _pack_scan(codes: np.ndarray, lens: np.ndarray, interval: np.ndarray) -> bytes:
    """Entropy-coded bytes: each interval padded with 1 bits to a byte,
    0xFF stuffed with 0x00, RSTn between intervals."""
    n_int = int(interval.max()) + 1 if len(interval) else 1
    bits_in = np.bincount(interval, weights=lens, minlength=n_int).astype(np.int64)
    pad = -bits_in % 8
    codes = np.concatenate([codes, (1 << pad) - 1])
    lens = np.concatenate([lens, pad])
    interval = np.concatenate([interval, np.arange(n_int)])
    order = np.argsort(interval, kind="stable")
    codes, lens = codes[order], lens[order]
    total = int(lens.sum())
    ev = np.repeat(np.arange(len(lens)), lens)
    j = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    raw = np.packbits(((codes[ev] >> (lens[ev] - 1 - j)) & 1).astype(np.uint8))
    ends = np.cumsum((bits_in + pad) // 8)[:-1]
    ff = np.nonzero(raw == 0xFF)[0]
    out = np.insert(raw, ff + 1, 0)
    ends = ends + np.searchsorted(ff, ends)
    rst = 0xD0 + np.arange(len(ends)) % 8
    return np.insert(out, np.repeat(ends, 2),
                     np.stack([np.full(len(ends), 0xFF), rst], 1).reshape(-1)).astype(
        np.uint8).tobytes()


def jpeg_from_coefficients(blocks: list, width: int, height: int, sampling: list,
                           quant: list, progressive: bool = False, restart: int = 0,
                           adobe_rgb: bool = False, ids=None) -> bytes:
    """A JPEG of quantised coefficients: blocks[c] [bh, bw, 64] int (zigzag
    order, the component's whole MCU-padded grid), sampling[c] (h, v),
    quant[c] [64] row-major (component 0 takes table 0, the others table 1).
    Baseline (or progressive by JPEG_PROGRESSION) with Annex K's Huffman
    tables, restart markers every `restart` MCUs, a JFIF APP0, or an Adobe
    APP14 with transform 0 where `adobe_rgb`."""
    import struct

    n = len(blocks)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    offsets = np.cumsum([0] + [b.shape[0] * b.shape[1] for b in blocks])
    zz = np.concatenate([b.reshape(-1, 64) for b in blocks]).astype(np.int64)
    seg = lambda marker, payload: struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload  # noqa: E731
    out = b"\xff\xd8"
    out += seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])) if adobe_rgb else \
        seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    tq = [0] + [1] * (n - 1)
    for t in sorted(set(tq)):
        c = tq.index(t)
        out += seg(0xDB, bytes([t]) + np.asarray(quant[c])[_ZIGZAG].astype(np.uint8).tobytes())
    ids = ids or ([82, 71, 66] if adobe_rgb else list(range(1, n + 1)))
    out += seg(0xC2 if progressive else 0xC0, struct.pack(">BHHB", 8, height, width, n)
               + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], tq[c]])
                          for c in range(n)))
    for (cls, t), table in JPEG_HUFFMAN.items():
        out += seg(0xC4, bytes([cls << 4 | t]) + bytes(table[0]) + bytes(table[1]))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    tables = [(np.stack(_huffman_codes(JPEG_HUFFMAN[0, min(t, 1)])),
               np.stack(_huffman_codes(JPEG_HUFFMAN[1, min(t, 1)]))) for t in tq]

    def scan(comps, spec):
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            gy, gx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
            seq = (offsets[c] + gy * blocks[c].shape[1] + gx).reshape(-1)
            comp = np.full(len(seq), c)
            per = 1
        else:
            cols, comp = [], []
            my, mx = [a.reshape(-1) for a in np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                                         indexing="ij")]
            for c in comps:
                h, v = sampling[c]
                for dv in range(v):
                    for dh in range(h):
                        cols.append(offsets[c] + (my * v + dv) * blocks[c].shape[1] + mx * h + dh)
                        comp.append(c)
            per = len(cols)
            seq, comp = np.stack(cols, 1).reshape(-1), np.tile(comp, mcux * mcuy)
        mcu = np.arange(len(seq)) // per
        interval = mcu // restart if restart else np.zeros(len(seq), np.int64)
        ss, se, ah, al = spec
        header = bytes([len(comps)]) + b"".join(
            bytes([ids[c], tq[c] << 4 | tq[c]]) for c in comps) + bytes([ss, se, ah << 4 | al])
        return seg(0xDA, header) + _pack_scan(*_scan_events(zz, seq, comp, interval, spec,
                                                             tables))

    if not progressive:
        out += scan(list(range(n)), (0, 63, 0, 0))
    else:
        for spec in JPEG_PROGRESSION:
            if spec[0] == 0:
                out += scan(list(range(n)), spec)
            else:
                for c in range(n):
                    out += scan([c], spec)
    return out + b"\xff\xd9"


def jpeg_bytes(pixels: np.ndarray, quality: int = 75, sampling=(2, 2),
               progressive: bool = False, restart: int = 0, adobe_rgb: bool = False) -> bytes:
    """A JPEG of [h, w, 3] RGB (YCbCr with chroma at 1/sampling, or RGB
    components under Adobe's transform 0) or [h, w] gray uint8 pixels:
    float DCT, IJG-scaled Annex K tables, Annex K Huffman tables."""
    px = np.asarray(pixels, np.float64)
    height, width = px.shape[:2]
    if px.ndim == 2:
        planes, factors = [px], [(1, 1)]
    elif adobe_rgb:
        planes, factors = [px[..., 0], px[..., 1], px[..., 2]], [(1, 1)] * 3
    else:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        factors = [tuple(sampling), (1, 1), (1, 1)]
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    dct = _dct_matrix()
    blocks = []
    for plane, (h, v) in zip(planes, factors):
        # Box-average down to the component's grid (edges replicated to
        # whole boxes), then replicate its edges to the MCU-padded grid.
        fy, fx = vmax // v, hmax // h
        ph, pw = -(-height // fy) * fy, -(-width // fx) * fx
        full = np.pad(plane, ((0, ph - height), (0, pw - width)), mode="edge")
        small = full.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        gh, gw = mcuy * v * 8, mcux * h * 8
        small = np.pad(small, ((0, gh - small.shape[0]), (0, gw - small.shape[1])), mode="edge")
        tiles = small.reshape(gh // 8, 8, gw // 8, 8).transpose(0, 2, 1, 3) - 128
        coef = dct @ tiles @ dct.T
        q = jpeg_quant(quality, len(blocks) > 0 and not adobe_rgb)
        blocks.append(np.round(coef.reshape(gh // 8, gw // 8, 64) / q)[..., _ZIGZAG]
                      .astype(np.int64))
    quant = [jpeg_quant(quality, c > 0 and not adobe_rgb) for c in range(len(planes))]
    return jpeg_from_coefficients(blocks, width, height, factors, quant, progressive, restart,
                                  adobe_rgb)


# -- TIFF writer (harness code: the near-dup corpus and the tests) -------------

TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 7: "B", 16: "Q"}  # BYTE, ASCII, SHORT, LONG, UNDEFINED, LONG8


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW of `data`: MSB-first codes of 9 to 12 bits that widen one
    code early, a clear code first and whenever the table reaches 4094
    entries, EOI last (libtiff's encoder)."""
    codes, widths = [256], [9]
    size, nxt, table = 9, 258, {}
    flat = list(data)
    if flat:
        prefix = flat[0]
        for c in flat[1:]:
            code = table.get(prefix << 8 | c)
            if code is not None:
                prefix = code
                continue
            codes.append(prefix)
            widths.append(size)
            table[prefix << 8 | c] = nxt
            nxt += 1
            if nxt == 4094:
                codes.append(256)
                widths.append(size)
                size, nxt, table = 9, 258, {}
            elif nxt == 1 << size:
                size += 1
            prefix = c
        codes.append(prefix)
        widths.append(size)
        nxt += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(size)
            size = 9
        elif nxt == 1 << size:
            size += 1
    codes.append(257)
    widths.append(size)
    return _pack_msb(np.array(codes, np.int64), np.array(widths, np.int64))


def _pack_msb(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Variable-width codes packed most significant bit first."""
    ev = np.repeat(np.arange(len(codes)), widths)
    j = np.repeat(np.cumsum(widths), widths) - 1 - np.arange(int(widths.sum()))
    return np.packbits(((codes[ev] >> j) & 1).astype(np.uint8)).tobytes()


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literals, at most 128 bytes a block."""
    a = np.frombuffer(data, np.uint8)
    if not a.size:
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    lens = np.diff(np.r_[starts, a.size])
    out, lit = bytearray(), []

    def flush():
        for i in range(0, len(lit), 128):
            chunk = lit[i:i + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    for s, n in zip(starts.tolist(), lens.tolist()):
        if n < 3:
            lit.extend(a[s:s + n].tolist())
            continue
        flush()
        while n >= 2:
            k = min(n, 128)
            out += bytes([257 - k, int(a[s])])
            n -= k
        if n:
            lit.append(int(a[s]))
    flush()
    return bytes(out)


def _tiff_rows(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """[h, w, c] samples → [h, rowbytes] bytes, chunky, rows byte-aligned."""
    h, w, c = block.shape
    if bits == 8:
        return block.astype(np.uint8).reshape(h, w * c)
    if bits == 16:
        return np.ascontiguousarray(block.astype(order + "u2")).view(np.uint8).reshape(h, -1)
    return pack_bits(block.reshape(h, w * c).astype(np.int64), bits)


def tiff_image(samples: np.ndarray, photometric: int, bits: int, *, order: str = "<",
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip: int = None, tile=None, extra=(), colormap=None,
               orientation: int = None, tags: dict = None) -> tuple:
    """One TIFF image of [h, w] or [h, w, c] integer samples at `bits`
    (1, 2, 4, 8 or 16): ({tag: (type, values)}, [strip or tile bytes]).
    Strips of `rows_per_strip` (all rows by default) or `tile` (w, h)
    tiles, padded at the edges; `planar` 2 stores each sample's plane
    apart; `predictor` 2 differences each sample from the same sample of
    the pixel before; `compression` 1, 5 (LZW), 8 or 32946 (Deflate) or
    32773 (PackBits); the offsets are filled in by tiff_bytes."""
    import zlib

    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    planes = [samples[:, :, k:k + 1] for k in range(c)] if planar == 2 else [samples]
    if tile is not None:
        tw, tl = tile
        boxes = [(y, x) for y in range(0, h, tl) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        boxes = [(y, 0) for y in range(0, h, rps)]
    chunks = []
    for plane in planes:
        for y, x in boxes:
            if tile is not None:
                block = np.zeros((tl, tw, plane.shape[2]), np.int64)
                part = plane[y:y + tl, x:x + tw]
                block[:part.shape[0], :part.shape[1]] = part
            else:
                block = plane[y:y + rps].astype(np.int64)
            if predictor == 2:
                diff = block.copy()
                diff[:, 1:] -= block[:, :-1]
                block = diff & ((1 << bits) - 1)
            raw = _tiff_rows(block, bits, order).tobytes()
            if compression == 5:
                raw = tiff_lzw(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw, 1)
            elif compression == 32773:
                raw = packbits(raw)
            chunks.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [c]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if tile is not None:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, np.asarray(colormap, np.int64).T.reshape(-1).tolist())
    if orientation is not None:
        entries[274] = (3, [orientation])
    entries.update(tags or {})
    entries["tiled"] = tile is not None
    return entries, chunks


def tiff_bytes(*images, order: str = "<", bigtiff: bool = False) -> bytes:
    """A TIFF file of tiff_image() results: the first is IFD0, each later
    one a child IFD that IFD0's SubIFDs tag (330) points to, as a DNG's raw
    image is. The strip or tile data comes first, then the child IFDs,
    then IFD0; the header's byte order is `order` ("<" II, ">" MM)."""
    import struct

    long_type = 16 if bigtiff else 4
    pos = 16 if bigtiff else 8
    body = bytearray()
    laid = []
    for entries, chunks in images:
        offsets = []
        for ch in chunks:
            offsets.append(pos + len(body))
            body += ch + b"\x00" * (len(ch) & 1)
        entries = dict(entries)
        off_tag, cnt_tag = (324, 325) if entries.pop("tiled") else (273, 279)
        entries[off_tag] = (long_type, offsets)
        entries[cnt_tag] = (long_type, [len(ch) for ch in chunks])
        laid.append(entries)
    blobs, at = [], pos + len(body)
    for entries in laid[1:]:
        blob = _tiff_ifd(entries, at, order, bigtiff)
        blobs.append((at, blob))
        at += len(blob)
    if len(laid) > 1:
        laid[0][330] = (4, [a for a, _ in blobs])
    ifd0 = _tiff_ifd(laid[0], at, order, bigtiff)
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, at) if bigtiff else struct.pack(order + "HI", 42, at))
    return head + bytes(body) + b"".join(b for _, b in blobs) + ifd0


def _tiff_ifd(entries: dict, at: int, order: str, bigtiff: bool) -> bytes:
    """One IFD at file offset `at`, its out-of-line values after it, no
    next IFD."""
    import struct

    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "I", 4)
    head = struct.pack(order + ("Q" if bigtiff else "H"), len(entries))
    extra_at = at + len(head) + len(entries) * entry_size + (8 if bigtiff else 4)
    table, extra = b"", b""
    for tag in sorted(entries):
        kind, values = entries[tag]
        if kind == 2:
            payload = bytes(values)
        else:
            payload = struct.pack(order + TIFF_TYPES[kind] * len(values), *values)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\x00")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"), extra_at + len(extra))
            extra += payload + b"\x00" * (len(payload) & 1)
        table += struct.pack(order + "HH" + count_fmt, tag, kind, len(values)) + field
    return head + table + b"\x00" * (8 if bigtiff else 4) + extra


def dng_bytes(preview: np.ndarray, raw: np.ndarray, order: str = "<",
              compression: int = 1) -> bytes:
    """A DNG-shaped file: IFD0 a reduced 8-bit RGB preview (NewSubfileType
    1, DNGVersion 1.4, Make), its SubIFDs child the 16-bit CFA raw image
    (photometric 32803, a 2 x 2 RGGB pattern). PIL reads IFD0 only."""
    prev = tiff_image(preview, 2, 8, order=order, compression=compression,
                      rows_per_strip=16, tags={254: (4, [1]), 50706: (1, [1, 4, 0, 0]),
                                               271: (2, b"Harness\x00")})
    child = tiff_image(raw, 32803, 16, order=order, rows_per_strip=64,
                       tags={254: (4, [0]), 33421: (3, [2, 2]), 33422: (1, [0, 1, 1, 2])})
    return tiff_bytes(prev, child, order=order)


# -- WebP writers (harness code: the near-dup corpus and the tests) -----------


class _LosslessBits:
    """VP8L bit writer: (value, width) pairs packed least significant bit
    first at the end."""

    def __init__(self):
        self.values, self.widths = [], []

    def put(self, value: int, width: int) -> None:
        if width:
            self.values.append(int(value))
            self.widths.append(int(width))

    def extend(self, values: np.ndarray, widths: np.ndarray) -> None:
        keep = widths > 0
        self.values += values[keep].astype(np.int64).tolist()
        self.widths += widths[keep].astype(np.int64).tolist()

    def tobytes(self) -> bytes:
        v = np.array(self.values, np.int64)
        w = np.array(self.widths, np.int64)
        if not len(v):
            return b""
        ev = np.repeat(np.arange(len(v)), w)
        j = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
        return np.packbits(((v[ev] >> j) & 1).astype(np.uint8), bitorder="little").tobytes()


def huffman_lengths(counts: np.ndarray, max_len: int = 15) -> np.ndarray:
    """Code lengths of a complete prefix code over the symbols with a
    nonzero count, none longer than `max_len` (the counts are flattened
    until it holds); a lone symbol gets length 1."""
    import heapq

    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    weights = counts[used].astype(np.float64)
    while True:
        heap = [(w, i, (i,)) for i, w in enumerate(weights)]
        heapq.heapify(heap)
        depth = np.zeros(len(used), np.int64)
        tie = len(used)
        while len(heap) > 1:
            w1, _, a = heapq.heappop(heap)
            w2, _, b = heapq.heappop(heap)
            for k in a + b:
                depth[k] += 1
            heapq.heappush(heap, (w1 + w2, tie, a + b))
            tie += 1
        if depth.max() <= max_len:
            lengths[used] = depth
            return lengths
        weights = np.floor(weights / 2) + 1


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's code, bit-reversed for a least-significant-first
    stream (the canonical order: by length, then by symbol)."""
    order = sorted((int(n), s) for s, n in enumerate(lengths) if n)
    codes = np.zeros(len(lengths), np.int64)
    code, prev = 0, order[0][0] if order else 0
    for n, s in order:
        code <<= n - prev
        prev = n
        codes[s] = int(f"{code:0{n}b}"[::-1], 2)
        code += 1
    return codes


CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_code(bw: _LosslessBits, counts: np.ndarray) -> np.ndarray:
    """Write one prefix code for `counts` (a simple code where at most two
    symbols below 256 are used, else a normal one with the code-length
    code and its runs); returns the code lengths."""
    used = np.flatnonzero(counts)
    if len(used) == 0:
        counts = counts.copy()
        counts[0] = 1
        used = np.array([0])
    if len(used) <= 2 and used.max() < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        first = int(used[0])
        bw.put(int(first >= 2), 1)
        bw.put(first, 8 if first >= 2 else 1)
        if len(used) == 2:
            bw.put(int(used[1]), 8)
        lengths = np.zeros(len(counts), np.int64)
        lengths[used] = 1 if len(used) == 2 else 0
        return lengths
    lengths = huffman_lengths(counts)
    # Run-length the lengths: 16 repeats the last nonzero length 3-6
    # times, 17 and 18 runs of zeros of 3-10 and 11-138.
    tokens = []
    n, i, prev = len(lengths), 0, 8
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        if v == 0 and run >= 3:
            k = min(run, 138)
            tokens.append((18, k - 11, 7) if k >= 11 else (17, k - 3, 3))
            i += k
        elif v != 0 and v == prev and run >= 3:
            k = min(run, 6)
            tokens.append((16, k - 3, 2))
            i += k
        else:
            tokens.append((v, 0, 0))
            if v:
                prev = v
            i += 1
    cl_counts = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = huffman_lengths(cl_counts, 7)
    cl_codes = canonical_codes(cl_lengths)
    num = max(4, max(k + 1 for k, s in enumerate(CODE_LENGTH_ORDER) if cl_lengths[s]))
    bw.put(0, 1)
    bw.put(num - 4, 4)
    for k in range(num):
        bw.put(int(cl_lengths[CODE_LENGTH_ORDER[k]]), 3)
    bw.put(0, 1)  # no max_symbol: the runs cover every symbol
    single = int((cl_lengths > 0).sum()) == 1
    for sym, extra, width in tokens:
        if not single:
            bw.put(int(cl_codes[sym]), int(cl_lengths[sym]))
        bw.put(extra, width)
    if int((lengths > 0).sum()) == 1:
        lengths = np.where(lengths > 0, 0, lengths)
    return lengths


def _prefix(values: np.ndarray):
    """VP8L prefix coding of values >= 1: (symbol, extra bit count, extra
    bits)."""
    d = np.asarray(values, np.int64) - 1
    small = d < 4
    hb = np.where(small, 0, np.floor(np.log2(np.maximum(d, 1))).astype(np.int64))
    shb = np.where(small, 0, (d >> np.maximum(hb - 1, 0)) & 1)
    sym = np.where(small, d, 2 * hb + shb)
    nextra = np.where(small, 0, hb - 1)
    extra = np.where(small, 0, d & ((1 << nextra) - 1))
    return sym, nextra, extra


# (dx, dy) of the neighbours the writer copies from → its short distance code.
PLANE_CODES = {(0, 1): 1, (1, 0): 2, (1, 1): 3, (-1, 1): 4}


def _tokens(px: np.ndarray, width: int, cache_bits: int, backrefs: bool):
    """Greedy LZ77 over [n] uint32 ARGB: a backward reference where one of
    the four neighbours (left, up, up-left, up-right) repeats for 3 or
    more pixels, else a colour cache hit, else a literal. Returns
    (kind 0/1/2, a, b) arrays: literal (a = pixel), reference (a =
    length, b = distance code), cache (a = key)."""
    n = len(px)
    cands = []
    if backrefs:
        for (dx, dy), code in PLANE_CODES.items():
            d = dx + dy * width
            if 1 <= d < n:
                eq = np.zeros(n + 1, np.int64)
                eq[d:n] = px[d:] == px[:-d]
                # run[i] = equal positions from i on
                idx = np.flatnonzero(eq[:n] == 0)
                nxt = np.full(n + 1, n)
                nxt[idx] = idx
                nxt = np.minimum.accumulate(nxt[::-1])[::-1]
                cands.append((d, code, nxt[:n] - np.arange(n)))
    cache = {} if cache_bits else None
    shift = 32 - cache_bits
    kinds, a_vals, b_vals = [], [], []
    pxl = px.tolist()
    i, inserted = 0, 0
    runs = [(d, code, r.tolist()) for d, code, r in cands]
    while i < n:
        best, best_code = 0, 0
        for d, code, r in runs:
            if i >= d and r[i] > best:
                best, best_code = r[i], code
        if best >= 3:
            length = min(best, 4096)
            kinds.append(1)
            a_vals.append(length)
            b_vals.append(best_code)
            i += length
            continue
        v = pxl[i]
        if cache is not None:
            while inserted < i:
                u = pxl[inserted]
                cache[((u * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = u
                inserted += 1
            key = ((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
            if cache.get(key) == v:
                kinds.append(2)
                a_vals.append(key)
                b_vals.append(0)
                i += 1
                continue
        kinds.append(0)
        a_vals.append(v)
        b_vals.append(0)
        i += 1
    return np.array(kinds, np.int64), np.array(a_vals, np.int64), np.array(b_vals, np.int64)


def _image_data(bw: _LosslessBits, px: np.ndarray, width: int, cache_bits: int,
                backrefs: bool, level0: bool) -> None:
    """The entropy-coded image: colour cache bit, (level 0: no meta codes),
    the five codes, then the tokens."""
    if cache_bits:
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        bw.put(0, 1)
    if level0:
        bw.put(0, 1)  # one Huffman group
    kinds, a, b = _tokens(px.reshape(-1).astype(np.int64), width, cache_bits, backrefs)
    lit, ref, hit = kinds == 0, kinds == 1, kinds == 2
    green = np.where(lit, (a >> 8) & 0xFF, 0)
    len_sym, len_nx, len_x = _prefix(np.where(ref, a, 1))
    green = np.where(ref, 256 + len_sym, green)
    green = np.where(hit, 280 + a, green)
    dist_sym, dist_nx, dist_x = _prefix(np.where(ref, b, 1))
    alphabet = 280 + ((1 << cache_bits) if cache_bits else 0)
    chans = [(green, np.ones(len(kinds), bool), alphabet), ((a >> 16) & 0xFF, lit, 256),
             (a & 0xFF, lit, 256), ((a >> 24) & 0xFF, lit, 256), (dist_sym, ref, 40)]
    codes = []
    for sym, mask, size in chans:
        lengths = _write_code(bw, np.bincount(sym[mask], minlength=size))
        codes.append((lengths, canonical_codes(lengths)))
    # Interleave each token's fields in the order the decoder reads them.
    fields = []
    (gl, gc), (rl, rc), (bl, bc), (al, ac), (dl, dc) = codes
    fields.append((gc[green], gl[green]))
    fields.append((np.where(lit, rc[(a >> 16) & 0xFF], len_x), np.where(lit, rl[(a >> 16) & 0xFF],
                                                                        np.where(ref, len_nx, 0))))
    fields.append((np.where(lit, bc[a & 0xFF], dc[dist_sym]),
                   np.where(lit, bl[a & 0xFF], np.where(ref, dl[dist_sym], 0))))
    fields.append((np.where(lit, ac[(a >> 24) & 0xFF], dist_x),
                   np.where(lit, al[(a >> 24) & 0xFF], np.where(ref, dist_nx, 0))))
    vals = np.stack([f[0] for f in fields], axis=1).reshape(-1)
    wids = np.stack([f[1] for f in fields], axis=1).reshape(-1)
    bw.extend(vals, wids)


def _channels(px: np.ndarray) -> np.ndarray:
    """[..] uint32 ARGB → [.., 4] int64 (A, R, G, B)."""
    return np.stack([(px >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1).astype(np.int64)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch & 0xFF
    return ((ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]).astype(
        np.uint32)


def _predictions(argb: np.ndarray) -> np.ndarray:
    """[14, h, w, 4] each predictor mode's prediction of every pixel from
    its original neighbours (the edge rules applied by the caller)."""
    h, w = argb.shape
    c = _channels(argb)
    flat = c.reshape(-1, 4)
    n = h * w
    idx = np.arange(n)
    L = flat[np.maximum(idx - 1, 0)]
    T = flat[np.maximum(idx - w, 0)]
    TR = flat[np.clip(idx - w + 1, 0, n - 1)]
    TL = flat[np.maximum(idx - w - 1, 0)]

    def avg(a, b):
        return (a + b) >> 1

    black = np.zeros_like(L)
    black[:, 0] = 255
    sel_l = (np.abs(L - TL) - np.abs(T - TL)).sum(axis=1, keepdims=True) > 0
    half = avg(L, T)
    diff = half - TL
    modes = [black, L, T, TR, TL, avg(avg(L, TR), T), avg(L, TL), avg(L, T), avg(TL, T),
             avg(T, TR), avg(avg(L, TL), avg(T, TR)), np.where(sel_l, L, T),
             np.clip(L + T - TL, 0, 255), np.clip(half + np.trunc(diff / 2).astype(np.int64), 0,
                                                  255)]
    return np.stack(modes).reshape(14, h, w, 4)


def webp_lossless_stream(argb: np.ndarray, *, predictor_bits: int = None,
                         subtract_green: bool = False, cache_bits: int = 0,
                         backrefs: bool = True, palette: bool = False, header: bool = True,
                         alpha_used: bool = False) -> bytes:
    """A VP8L bitstream of [h, w] uint32 ARGB: the header (where
    `header`), then the transforms asked for (subtract-green, the
    predictor with the least-residual mode of each block of 2**bits, or a
    colour-indexing palette of at most 16 colours with pixels bundled),
    then the entropy-coded image with backward references and a colour
    cache of `cache_bits`."""
    h, w = argb.shape
    bw = _LosslessBits()
    if header:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_used), 1)
        bw.put(0, 3)
    data, width = argb.astype(np.uint32), w
    if palette:
        colours, index = np.unique(data.reshape(-1), return_inverse=True)
        num = len(colours)
        if num > 16:
            raise ValueError(f"{num} colours: the palette variant takes at most 16")
        bits = 1 if num > 4 else 2 if num > 2 else 3
        per, bpp = 1 << bits, 8 >> bits
        index = index.reshape(h, w)
        width = -(-w // per)
        wide = np.zeros((h, width * per), np.int64)
        wide[:, :w] = index
        packed = (wide.reshape(h, width, per) << (np.arange(per) * bpp)).sum(axis=2)
        bw.put(1, 1)
        bw.put(3, 2)
        bw.put(num - 1, 8)
        pal = _channels(colours)
        delta = pal.copy()
        delta[1:] -= pal[:-1]
        _image_data(bw, _pack(delta)[None, :], num, 0, False, False)
        data = (0xFF000000 | (packed << 8)).astype(np.uint32)
    if subtract_green:
        c = _channels(data)
        c[..., 1] -= c[..., 2]
        c[..., 3] -= c[..., 2]
        data = _pack(c)
        bw.put(1, 1)
        bw.put(2, 2)
    if predictor_bits is not None:
        hh, ww = data.shape
        preds = _predictions(data)
        c = _channels(data)
        resid = (c[None] - preds) & 0xFF
        score = np.minimum(resid, 256 - resid).sum(axis=-1)
        bh, bwid = -(-hh // (1 << predictor_bits)), -(-ww // (1 << predictor_bits))
        ys = np.arange(hh) >> predictor_bits
        xs = np.arange(ww) >> predictor_bits
        block = (ys[:, None] * bwid + xs[None, :]).reshape(-1)
        sums = np.stack([np.bincount(block, score[m].reshape(-1), bh * bwid) for m in range(14)])
        modes = sums.argmin(axis=0)
        mode_px = modes[block].reshape(hh, ww)
        pred = np.take_along_axis(preds, mode_px[None, :, :, None], axis=0)[0]
        # The edges: black at the first pixel, left along the first row,
        # top down the first column.
        cc = c.reshape(hh, ww, 4)
        pred[0, 0] = (255, 0, 0, 0)
        pred[0, 1:] = cc[0, :-1]
        pred[1:, 0] = cc[:-1, 0]
        data = _pack(c - pred)
        bw.put(1, 1)
        bw.put(0, 2)
        bw.put(predictor_bits - 2, 3)
        mode_img = (0xFF000000 | (modes.reshape(bh, bwid) << 8)).astype(np.uint32)
        _image_data(bw, mode_img, bwid, 0, True, False)
    bw.put(0, 1)  # no more transforms
    _image_data(bw, data, data.shape[1], cache_bits, backrefs, True)
    return bw.tobytes()


def riff_chunk(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff_webp(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def rgb_to_argb(rgb: np.ndarray, alpha: np.ndarray = None) -> np.ndarray:
    a = np.full(rgb.shape[:2], 255, np.uint32) if alpha is None else alpha.astype(np.uint32)
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return (a << 24) | (r << 16) | (g << 8) | b


def webp_lossless_bytes(rgb: np.ndarray, alpha: np.ndarray = None, **kw) -> bytes:
    """A lossless WebP (one VP8L chunk) of [h, w, 3] uint8 RGB and an
    optional [h, w] alpha; `kw` as webp_lossless_stream."""
    stream = webp_lossless_stream(rgb_to_argb(rgb, alpha), alpha_used=alpha is not None, **kw)
    return riff_webp(riff_chunk(b"VP8L", stream))


class _BoolWriter:
    """The VP8 boolean encoder (RFC 6386 section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def _carry(self) -> None:
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bits(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((value >> k) & 1, 0x80)

    def signed(self, value: int, n: int) -> None:
        self.bits(abs(value), n)
        self.put(int(value < 0), 0x80)

    def flag_signed(self, value: int, n: int) -> None:
        self.put(int(value != 0), 0x80)
        if value:
            self.signed(value, n)

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


ZIGZAG_ORDER = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])


def _tree_paths(tree) -> dict:
    """leaf → [(node, bit)] of a VP8 tree in libwebp's kYModesIntra4 form."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            nxt = tree[i + bit]
            step = path + [(i, bit)]
            if nxt > 0:
                walk(2 * nxt, step)
            else:
                paths[-nxt] = step

    walk(0, [])
    return paths


def _linear(fn, n: int = 16) -> np.ndarray:
    """The matrix of a transform from its integer version run without
    rounding (a float stand-in): column k = fn(unit vector k)."""
    return np.stack([fn(np.eye(n)[k]) for k in range(n)], axis=1)


def _idct_float(c):
    c = np.asarray(c, np.float64).reshape(4, 4)
    m1 = lambda a: a * 20091 / 65536 + a
    m2 = lambda a: a * 35468 / 65536
    a, b = c[0] + c[2], c[0] - c[2]
    cc, d = m2(c[1]) - m1(c[3]), m1(c[1]) + m2(c[3])
    t = np.stack([a + d, b + cc, b - cc, a - d])  # t[k][col]
    out = np.zeros((4, 4))
    for i in range(4):
        a, b = t[i, 0] + t[i, 2], t[i, 0] - t[i, 2]
        cc, d = m2(t[i, 1]) - m1(t[i, 3]), m1(t[i, 1]) + m2(t[i, 3])
        out[i] = np.array([a + d, b + cc, b - cc, a - d]) / 8
    return out.reshape(-1)


def _wht_float(dc):
    dc = np.asarray(dc, np.float64)
    tmp = np.zeros(16)
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = np.zeros(16)
    for i in range(4):
        d = tmp[4 * i]
        a0, a1 = d + tmp[3 + 4 * i], tmp[1 + 4 * i] + tmp[2 + 4 * i]
        a2, a3 = tmp[1 + 4 * i] - tmp[2 + 4 * i], d - tmp[3 + 4 * i]
        out[4 * i:4 * i + 4] = np.array([a0 + a1, a3 + a2, a0 - a1, a3 - a2]) / 8
    return out


_FDCT = np.linalg.inv(_linear(_idct_float))
_FWHT = np.linalg.inv(_linear(_wht_float))


def _rgb_to_yuv420(rgb: np.ndarray, mb_h: int, mb_w: int):
    """BT.601 studio-range YUV, chroma averaged over 2x2, edges replicated
    out to whole macroblocks."""
    h, w, _ = rgb.shape
    pad = np.pad(rgb.astype(np.float64), ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)),
                 mode="edge")
    r, g, b = pad[..., 0], pad[..., 1], pad[..., 2]
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256

    def down(p):
        return p.reshape(8 * mb_h, 2, 8 * mb_w, 2).mean(axis=(1, 3))

    return (np.clip(np.rint(y), 0, 255), np.clip(np.rint(down(u)), 0, 255),
            np.clip(np.rint(down(v)), 0, 255))


def _quantise(c: np.ndarray, q: int, bias: float) -> np.ndarray:
    level = np.floor(np.abs(c) / q + bias).astype(np.int64)
    return np.sign(c).astype(np.int64) * np.minimum(level, 2048)


class _Vp8Encoder:
    """A VP8 key-frame encoder that keeps its own reconstruction (the
    decoder's prediction, WHT and IDCT, from media/webp.py) so the file
    stays close to the picture."""

    def __init__(self, rgb: np.ndarray, rng, *, q_index: int, partitions: int,
                 segments: bool, filter_kind: str, level: int, sharpness: int,
                 b_pred_share: float, skip_proba: bool, prob_updates: int):
        from spacedrive_tpu_torch.media import webp as W

        self.W = W
        self.rng = rng
        h, w, _ = rgb.shape
        self.h, self.w = h, w
        self.mb_w, self.mb_h = (w + 15) >> 4, (h + 15) >> 4
        self.src_y, self.src_u, self.src_v = _rgb_to_yuv420(rgb, self.mb_h, self.mb_w)
        self.Y = np.zeros((16 * self.mb_h, 16 * self.mb_w), np.uint8)
        self.U = np.zeros((8 * self.mb_h, 8 * self.mb_w), np.uint8)
        self.V = np.zeros((8 * self.mb_h, 8 * self.mb_w), np.uint8)
        self.num_parts = partitions
        self.segments = segments
        self.b_pred_share = b_pred_share
        self.skip_proba = skip_proba
        # Segment quantisers (absolute) around q_index, and filter levels.
        self.seg_q = [int(np.clip(q_index + d, 0, 127)) for d in (0, -8, 8, 16)] if segments \
            else [q_index] * 4
        self.seg_filter = [int(np.clip(level + d, 0, 63)) for d in (0, 4, -4, 8)]
        self.filter_kind, self.level, self.sharpness = filter_kind, level, sharpness
        self.probs = list(W.T.COEFFS_PROBA0)
        self.updates = {}
        for i in rng.choice(len(self.probs), prob_updates, replace=False).tolist():
            self.updates[i] = int(rng.integers(1, 256))
            self.probs[i] = self.updates[i]
        flat = self.probs
        bands = [[[flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
                   for c in range(3)] for b in range(8)] for t in range(4)]
        self.bands = [[bands[t][W.BANDS[n]] for n in range(17)] for t in range(4)]
        self.bmode_paths = _tree_paths(W.YMODES_INTRA4)

    def dq_table(self) -> np.ndarray:
        """[segment, (y1, y2, uv), (dc, ac)] dequantisation factors, as the
        decoder derives them from the segment quantisers."""
        W = self.W
        table = np.zeros((4, 3, 2), np.int64)
        for seg, q in enumerate(self.seg_q):
            table[seg] = ((W.T.DC_TABLE[q], W.T.AC_TABLE[q]),
                          (W.T.DC_TABLE[q] * 2, max(8, (W.T.AC_TABLE[q] * 101581) >> 16)),
                          (W.T.DC_TABLE[min(q, 117)], W.T.AC_TABLE[q]))
        return table

    @staticmethod
    def _levels(coef: np.ndarray, q: np.ndarray, first: int) -> np.ndarray:
        """[m, nb, 16] transform coefficients (raster) → quantised levels
        by each macroblock's (dc, ac) factors `q` [m, 2]; the DC left at 0
        where `first`."""
        lv = np.concatenate([_quantise(coef[..., :1], q[:, None, None, 0], 0.5),
                             _quantise(coef[..., 1:], q[:, None, None, 1], 0.35)], axis=-1)
        if first:
            lv[..., 0] = 0
        return lv

    @staticmethod
    def _dequantise(lv: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Levels → the 16-bit coefficients the decoder holds."""
        deq = lv * np.where(np.arange(16) == 0, q[:, None, None, 0], q[:, None, None, 1])
        return ((deq + 0x8000) & 0xFFFF) - 0x8000

    @staticmethod
    def _gather(plane: np.ndarray, my: np.ndarray, mx: np.ndarray, size: int) -> np.ndarray:
        k = np.arange(size)
        return plane[(my * size)[:, None, None] + k[None, :, None],
                     (mx * size)[:, None, None] + k[None, None, :]].astype(np.int64)

    @staticmethod
    def _to_blocks(mb: np.ndarray, per_row: int) -> np.ndarray:
        """[m, 4·per_row, 4·per_row] → [m, per_row², 16] 4x4 blocks (raster)."""
        m = mb.shape[0]
        return mb.reshape(m, per_row, 4, per_row, 4).transpose(0, 1, 3, 2, 4).reshape(
            m, per_row * per_row, 16)

    def reconstruct(self) -> None:
        """Choose, quantise and reconstruct every macroblock, a wavefront
        at a time (W._diagonals): 16x16 luma and chroma modes by least
        error over four, B_PRED sub-blocks by least error over three."""
        W, rng = self.W, self.rng
        mb_w, mb_h = self.mb_w, self.mb_h
        self.is_i4 = rng.random((mb_h, mb_w)) < self.b_pred_share
        self.segment = rng.integers(0, 4, (mb_h, mb_w)) if self.segments \
            else np.zeros((mb_h, mb_w), np.int64)
        self.ymode = np.zeros((mb_h, mb_w), np.int64)
        self.bmodes = np.zeros((mb_h, mb_w, 16), np.int64)
        self.uvmode = np.zeros((mb_h, mb_w), np.int64)
        self.y2_lv = np.zeros((mb_h, mb_w, 16), np.int64)
        self.y_lv = np.zeros((mb_h, mb_w, 16, 16), np.int64)
        self.uv_lv = np.zeros((mb_h, mb_w, 8, 16), np.int64)
        dq = self.dq_table()
        modes4 = np.array([W.DC_PRED, W.TM_PRED, W.V_PRED, W.H_PRED])  # predict_all's order
        for my, mx in W._diagonals(mb_w, mb_h):
            q = dq[self.segment[my, mx]]
            sel = ~self.is_i4[my, mx]
            if sel.any():
                sy, sx, qs = my[sel], mx[sel], q[sel]
                k = len(sy)
                src = self._gather(self.src_y, sy, sx, 16)
                top, left, tl = W.neighbours(self.Y, sy, sx, 16)
                preds = W.predict_all(top, left, tl, sy, sx, 16)
                pick = np.abs(src[None] - preds).sum(axis=(2, 3)).argmin(axis=0)
                pred = preds[pick, np.arange(k)]
                coef = self._to_blocks(src - pred, 4) @ _FDCT.T
                y2 = coef[..., 0] @ _FWHT.T
                y2_lv = np.concatenate([_quantise(y2[:, :1], qs[:, 1, :1], 0.5),
                                        _quantise(y2[:, 1:], qs[:, 1, 1:], 0.5)], axis=1)
                dcs = W.wht_batch(self._dequantise(y2_lv[:, None], qs[:, 1])[:, 0])
                ac_lv = self._levels(coef, qs[:, 0], 1)
                coeffs = self._dequantise(ac_lv, qs[:, 0])
                coeffs[..., 0] = dcs
                res = W._idct(coeffs.reshape(-1, 16)).reshape(k, 16, 4, 4)
                W.put_blocks(self.Y, sy, sx,
                             np.clip(pred + W.blocks_to_plane(res, 4), 0, 255))
                self.ymode[sy, sx] = modes4[pick]
                self.y2_lv[sy, sx] = y2_lv
                self.y_lv[sy, sx] = ac_lv
            for y, x, qm in zip(my[~sel].tolist(), mx[~sel].tolist(), q[~sel]):
                self._i4(y, x, qm[0])
            src_u = self._gather(self.src_u, my, mx, 8)
            src_v = self._gather(self.src_v, my, mx, 8)
            nb_u = W.neighbours(self.U, my, mx, 8)
            nb_v = W.neighbours(self.V, my, mx, 8)
            m = len(my)
            preds_u = W.predict_all(*nb_u, my, mx, 8)
            preds_v = W.predict_all(*nb_v, my, mx, 8)
            err = np.abs(src_u[None] - preds_u).sum(axis=(2, 3)) + \
                np.abs(src_v[None] - preds_v).sum(axis=(2, 3))
            pick = err.argmin(axis=0)
            self.uvmode[my, mx] = modes4[pick]
            for plane, src, preds, at in ((self.U, src_u, preds_u, 0), (self.V, src_v, preds_v, 4)):
                pred = preds[pick, np.arange(m)]
                lv = self._levels(self._to_blocks(src - pred, 2) @ _FDCT.T, q[:, 2], 0)
                res = W._idct(self._dequantise(lv, q[:, 2]).reshape(-1, 16)).reshape(m, 4, 4, 4)
                W.put_blocks(plane, my, mx, np.clip(pred + W.blocks_to_plane(res, 2), 0, 255))
                self.uv_lv[my, mx, at:at + 4] = lv

    def _i4(self, mb_y: int, mb_x: int, q: np.ndarray) -> None:
        """One B_PRED macroblock, block by block in the decoder's work area."""
        W, rng = self.W, self.rng
        y0, x0 = 16 * mb_y, 16 * mb_x
        src = self.src_y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        top, left, tl = W.neighbours(self.Y, np.array([mb_y]), np.array([mb_x]), 16)

        def block(n, above, left4, corner):
            s = src[4 * (n >> 2):4 * (n >> 2) + 4, 4 * (n & 3):4 * (n & 3) + 4].reshape(-1)
            best = None
            for mode in (W.B_DC, W.B_TM, int(rng.integers(2, 10))):
                pred = np.array(W._predict4(mode, above, left4, corner))
                err = int(np.abs(s - pred).sum())
                if best is None or err < best[0]:
                    best = (err, mode, pred)
            _, mode, pred = best
            lv = self._levels(((s - pred) @ _FDCT.T)[None, None], q[None], 0)
            res = W._idct(self._dequantise(lv, q[None]).reshape(1, 16)).reshape(16)
            self.bmodes[mb_y, mb_x, n] = mode
            self.y_lv[mb_y, mb_x, n] = lv[0, 0]
            return np.clip(pred + res, 0, 255).tolist()

        W.i4_reconstruct(self.Y, mb_x, mb_y, self.mb_w, top[0].tolist(), left[0].tolist(),
                         int(tl[0]), block)

    # -- tokens ------------------------------------------------------------------

    def _block_tokens(self, bw: _BoolWriter, prob, ctx: int, lv_raster, first: int) -> int:
        """GetCoeffs' inverse for one block; returns the index past the
        last token written (the decoder's nz)."""
        n = first
        p = prob[n][ctx]
        zz = lv_raster[ZIGZAG_ORDER].tolist()
        nonzero = [k for k in range(first, 16) if zz[k]]
        if not nonzero:
            bw.put(0, p[0])
            return n
        last = nonzero[-1]
        while n < 16:
            if n > last:
                bw.put(0, p[0])
                return n
            bw.put(1, p[0])
            while zz[n] == 0:
                bw.put(0, p[1])
                n += 1
                p = prob[n][0]
            bw.put(1, p[1])
            v = abs(zz[n])
            nxt = prob[n + 1]
            if v == 1:
                bw.put(0, p[2])
                p = nxt[1]
            else:
                bw.put(1, p[2])
                self._large(bw, p, v)
                p = nxt[2]
            bw.put(int(zz[n] < 0), 0x80)
            n += 1
        return 16

    @staticmethod
    def _large(bw: _BoolWriter, p, v: int) -> None:
        if v <= 4:
            bw.put(0, p[3])
            if v == 2:
                bw.put(0, p[4])
            else:
                bw.put(1, p[4])
                bw.put(v - 3, p[5])
            return
        bw.put(1, p[3])
        if v <= 10:
            bw.put(0, p[6])
            if v <= 6:
                bw.put(0, p[7])
                bw.put(v - 5, 159)
            else:
                bw.put(1, p[7])
                bw.put((v - 7) >> 1, 165)
                bw.put((v - 7) & 1, 145)
            return
        bw.put(1, p[6])
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(cat >> 1, p[8])
        bw.put(cat & 1, p[9 + (cat >> 1)])
        extra = v - (3 + (8 << cat))
        probs = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
                 (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))[cat]
        for k, prob in enumerate(probs):
            bw.put((extra >> (len(probs) - 1 - k)) & 1, prob)

    def residual_tokens(self, bw: _BoolWriter, mb: dict, top: list, left: list) -> None:
        """ParseResiduals' inverse, the contexts updated as the decoder does."""
        if not mb["i4x4"]:
            nz = self._block_tokens(bw, self.bands[1], top[1] + left[1], mb["y2"], 0)
            top[1] = left[1] = int(nz > 0)
            first, ac = 1, self.bands[0]
        else:
            first, ac = 0, self.bands[3]
        tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
        for y in range(4):
            l = lnz & 1
            for x in range(4):
                nz = self._block_tokens(bw, ac, l + (tnz & 1), mb["y"][4 * y + x], first)
                l = int(nz > first)
                tnz = (tnz >> 1) | (l << 7)
            tnz >>= 4
            lnz = (lnz >> 1) | (l << 7)
        out_t, out_l = tnz, lnz >> 4
        for ch in (0, 2):
            tnz = (top[0] >> (4 + ch)) & 0xFF
            lnz = (left[0] >> (4 + ch)) & 0xFF
            for y in range(2):
                l = lnz & 1
                for x in range(2):
                    blk = mb["uv_levels"][2 * ch + 2 * y + x]
                    nz = self._block_tokens(bw, self.bands[2], l + (tnz & 1), blk, 0)
                    l = int(nz > 0)
                    tnz = (tnz >> 1) | (l << 3)
                tnz >>= 2
                lnz = (lnz >> 1) | (l << 5)
            out_t |= (tnz << 4) << ch
            out_l |= (lnz & 0xF0) << ch
        top[0] = out_t & 0xFF
        left[0] = out_l & 0xFF

    def encode(self) -> bytes:
        W = self.W
        self.reconstruct()
        mbs = []
        for y in range(self.mb_h):
            row = []
            for x in range(self.mb_w):
                i4 = bool(self.is_i4[y, x])
                mb = {"segment": int(self.segment[y, x]), "i4x4": i4,
                      "modes": self.bmodes[y, x].tolist() if i4 else [int(self.ymode[y, x])],
                      "uv": int(self.uvmode[y, x]), "y2": self.y2_lv[y, x],
                      "y": self.y_lv[y, x], "uv_levels": self.uv_lv[y, x]}
                mb["skip"] = not (mb["y"].any() or mb["uv_levels"].any() or
                                  (not i4 and mb["y2"].any()))
                row.append(mb)
            mbs.append(row)
        hdr = _BoolWriter()
        hdr.put(0, 0x80)  # colour space
        hdr.put(0, 0x80)  # clamping
        hdr.put(int(self.segments), 0x80)
        if self.segments:
            hdr.put(1, 0x80)  # update the map
            hdr.put(1, 0x80)  # update the data
            hdr.put(1, 0x80)  # absolute values
            for qv in self.seg_q:
                hdr.flag_signed(qv, 7)
            for fv in self.seg_filter:
                hdr.flag_signed(fv, 6)
            seg_probs = [int(self.rng.integers(1, 256)) for _ in range(3)]
            for pv in seg_probs:
                hdr.put(1, 0x80)
                hdr.bits(pv, 8)
        hdr.put(int(self.filter_kind == "simple"), 0x80)
        hdr.bits(self.level, 6)
        hdr.bits(self.sharpness, 3)
        hdr.put(1, 0x80)  # loop filter deltas on
        hdr.put(1, 0x80)  # and updated
        ref_delta = [int(self.rng.integers(-6, 7)), 0, 0, 0]
        mode_delta = [int(self.rng.integers(-6, 7)), 0, 0, 0]
        for dv in ref_delta + mode_delta:
            hdr.flag_signed(dv, 6)
        hdr.bits({1: 0, 2: 1, 4: 2, 8: 3}[self.num_parts], 2)
        hdr.bits(self.seg_q[0], 7)
        for _ in range(5):  # no quantiser deltas
            hdr.put(0, 0x80)
        hdr.put(0, 0x80)  # refresh entropy probabilities
        for i in range(len(self.probs)):
            if i in self.updates:
                hdr.put(1, W.T.COEFFS_UPDATE_PROBA[i])
                hdr.bits(self.updates[i], 8)
            else:
                hdr.put(0, W.T.COEFFS_UPDATE_PROBA[i])
        skip_p = int(self.rng.integers(1, 256)) if self.skip_proba else 0
        hdr.put(int(self.skip_proba), 0x80)
        if self.skip_proba:
            hdr.bits(skip_p, 8)
        parts = [_BoolWriter() for _ in range(self.num_parts)]
        intra_top = [W.B_DC] * (4 * self.mb_w)
        nz_top = [[0, 0] for _ in range(self.mb_w)]
        for mb_y, row in enumerate(mbs):
            left_modes = [W.B_DC] * 4
            tokens = parts[mb_y & (self.num_parts - 1)]
            nz_left = [0, 0]
            for mb_x, mb in enumerate(row):
                if self.segments:
                    s = mb["segment"]
                    hdr.put(s >> 1, seg_probs[0])
                    hdr.put(s & 1, seg_probs[1 + (s >> 1)])
                if self.skip_proba:
                    hdr.put(int(mb["skip"]), skip_p)
                t = intra_top[4 * mb_x:4 * mb_x + 4]
                if not mb["i4x4"]:
                    hdr.put(1, 145)
                    mode = mb["modes"][0]
                    hdr.put(int(mode in (W.TM_PRED, W.H_PRED)), 156)
                    if mode in (W.TM_PRED, W.H_PRED):
                        hdr.put(int(mode == W.TM_PRED), 128)
                    else:
                        hdr.put(int(mode == W.V_PRED), 163)
                    t = [mode] * 4
                    left_modes = [mode] * 4
                else:
                    hdr.put(0, 145)
                    for y in range(4):
                        ymode = left_modes[y]
                        for x in range(4):
                            prob = W.T.BMODES_PROBA[(t[x] * 10 + ymode) * 9:
                                                    (t[x] * 10 + ymode) * 9 + 9]
                            mode = mb["modes"][4 * y + x]
                            for node, bit in self.bmode_paths[mode]:
                                hdr.put(bit, prob[node >> 1] if node else prob[0])
                            ymode = mode
                            t[x] = mode
                        left_modes[y] = ymode
                intra_top[4 * mb_x:4 * mb_x + 4] = t
                uv = mb["uv"]
                hdr.put(int(uv != W.DC_PRED), 142)
                if uv != W.DC_PRED:
                    hdr.put(int(uv != W.V_PRED), 114)
                    if uv != W.V_PRED:
                        hdr.put(int(uv == W.TM_PRED), 183)
                if self.skip_proba and mb["skip"]:
                    nz_top[mb_x][0] = nz_left[0] = 0
                    if not mb["i4x4"]:
                        nz_top[mb_x][1] = nz_left[1] = 0
                else:
                    self.residual_tokens(tokens, mb, nz_top[mb_x], nz_left)
        first = hdr.finish()
        sizes = [p.finish() for p in parts]
        tag = (len(first) << 5) | (1 << 4)  # key frame, profile 0, shown
        out = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", self.w, self.h)
        out += first
        for p in sizes[:-1]:
            out += struct.pack("<I", len(p))[:3]
        return out + b"".join(sizes)


def vp8_frame(rgb: np.ndarray, rng, *, quality: int = 80, partitions: int = 1,
              segments: bool = False, filter_kind: str = "normal", level: int = 20,
              sharpness: int = 0, b_pred_share: float = 0.25, skip_proba: bool = True,
              prob_updates: int = 8) -> bytes:
    """A VP8 key frame (the payload of a "VP8 " chunk) of [h, w, 3] uint8
    RGB: `quality` 0-100 to the quantiser index, 1-8 token `partitions`,
    four `segments` with their own quantiser and filter level, the
    `filter_kind` ("simple" or "normal") loop filter at `level` and
    `sharpness`, a share of B_PRED macroblocks, the skip flag, and a few
    token probability updates, all drawn from `rng`."""
    q_index = int(np.clip(round((100 - quality) * 127 / 100), 0, 127))
    return _Vp8Encoder(rgb, rng, q_index=q_index, partitions=partitions, segments=segments,
                       filter_kind=filter_kind, level=level, sharpness=sharpness,
                       b_pred_share=b_pred_share, skip_proba=skip_proba,
                       prob_updates=prob_updates).encode()


def webp_lossy_bytes(rgb: np.ndarray, rng, alpha: np.ndarray = None, alpha_method: int = 1,
                     alpha_filter: int = 0, **kw) -> bytes:
    """A lossy WebP of [h, w, 3] uint8 RGB: a simple "VP8 " file, or with
    an [h, w] `alpha` a VP8X file with an ALPH chunk (raw where
    `alpha_method` is 0, else a VP8L stream; `alpha_filter` 0-3: none,
    horizontal, vertical, gradient); `kw` as vp8_frame."""
    frame = riff_chunk(b"VP8 ", vp8_frame(rgb, rng, **kw))
    if alpha is None:
        return riff_webp(frame)
    h, w = alpha.shape
    return riff_webp(vp8x_chunk(w, h, alpha=True) + alph_chunk(alpha, alpha_method, alpha_filter)
                     + frame)


def vp8x_chunk(w: int, h: int, alpha: bool = False, animation: bool = False) -> bytes:
    flags = (0x10 if alpha else 0) | (0x02 if animation else 0)
    return riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") +
                      (h - 1).to_bytes(3, "little"))


def alph_chunk(alpha: np.ndarray, method: int, filt: int) -> bytes:
    """An ALPH chunk: the alpha plane filtered (none, horizontal, vertical,
    gradient, predicting from the original values as libwebp's unfilter
    does), raw or as a headerless VP8L stream in the green channel."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]  # the first row is always horizontal
        if filt == 1:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:] = a[:-1]
        else:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    filtered = ((a - pred) & 0xFF).astype(np.uint32)
    if method == 0:
        body = filtered.astype(np.uint8).tobytes()
    else:
        body = webp_lossless_stream(filtered << 8, header=False, backrefs=True)
    return riff_chunk(b"ALPH", bytes([method | filt << 2]) + body)


def webp_animation_bytes(frames: list, canvas: tuple) -> bytes:
    """An animated WebP on a `canvas` (w, h): frames [(frame chunks
    (ALPH? + VP8/VP8L), x, y, w, h)] at even offsets, ANIM first."""
    out = vp8x_chunk(*canvas, animation=True)
    out += riff_chunk(b"ANIM", struct.pack("<IH", 0xFF000000, 0))
    for data, x, y, w, h in frames:
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + \
            (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little") + \
            (100).to_bytes(3, "little") + bytes([0])
        out += riff_chunk(b"ANMF", head + data)
    return riff_webp(out)


# -- near-dup corpus (harness code) ------------------------------------------

NEAR_DUP_THRESHOLD = 10      # the job's DEFAULT_THRESHOLD
# Encodings of the corpus: every PNG colour type and depth the decoder
# takes, Adam7 and 16-bit PNG, the three BMP forms, JPEG (4:2:0, 4:2:2,
# 4:4:4, gray, progressive, restart intervals, Adobe RGB), GIF (plain and
# interlaced), ICO (a PNG or a DIB frame beside a 16 px one), TIFF (LZW,
# Deflate, PackBits and uncompressed, II and MM, strips and tiles, chunky
# and planar, predictor 2, gray at 1, 8 and 16 bits, RGB at 8 and 16,
# RGBA, palette at 4 and 8), DNG (its IFD0 preview), and WebP (lossless,
# colour-indexed, lossy VP8, and VP8X with ALPH or two animation frames).
IMAGE_KINDS = ("png_rgb", "png_rgba", "png_gray", "png_la", "png_pal8", "png_pal4",
               "png_pal2", "png_pal1", "png_gray4", "png_gray2", "png_gray1",
               "bmp24", "bmp32", "bmp8", "jpeg_420", "jpeg_422", "jpeg_444", "jpeg_gray",
               "jpeg_prog", "jpeg_rst", "jpeg_adobe", "gif", "gif_interlaced", "ico_png",
               "ico_bmp", "png_adam7", "png_rgb16", "png_gray16", "png_rgba16",
               "tiff_lzw", "tiff_deflate", "tiff_packbits", "tiff_raw", "dng",
               "webp_lossless", "webp_palette", "webp_lossy", "webp_extended")
FORMATS = ("png", "bmp", "jpeg", "gif", "ico", "tiff", "webp")
CORPUS_DIR_FILES = 500
# 6 x 6 x 6 colour cube: the 8-bit palette of the pal8 and bmp8 kinds.
CUBE = np.stack(np.meshgrid(*[np.arange(6) * 51] * 3, indexing="ij"), -1).reshape(-1, 3)


_NOISE = []  # one pool of standard normals, drawn once (seed 0)


def noise_like(rng, shape) -> np.ndarray:
    """Standard normal float32 noise of `shape`: a window of a fixed pool at
    an offset drawn from `rng` (cheap enough for thousands of images)."""
    if not _NOISE:
        _NOISE.append(np.random.default_rng(0).standard_normal(1 << 22, dtype=np.float32))
    pool, n = _NOISE[0], int(np.prod(shape))
    reps = -(-n // len(pool))
    src = np.tile(pool, reps) if reps > 1 else pool
    start = int(rng.integers(0, len(src) - n + 1))
    return src[start:start + n].reshape(shape)


def image_scene(rng, h: int, w: int, noise: float = 1.5) -> np.ndarray:
    """[h, w, 3] float32 scene: a coarse random colour grid upsampled to the
    image (the structure pHash keeps), plus pixel noise of σ `noise`."""
    gh, gw = (int(v) for v in rng.integers(3, 13, 2))
    base = rng.normal(size=(gh, gw, 3))
    base = ((base - base.min()) / (np.ptp(base) + 1e-9) * 235 + 10).astype(np.float32)
    img = np.repeat(np.repeat(base, np.bincount(np.arange(h) * gh // h, minlength=gh), axis=0),
                    np.bincount(np.arange(w) * gw // w, minlength=gw), axis=1)
    return img + noise_like(rng, img.shape) * np.float32(noise)


def kind_format(kind: str) -> str:
    """The file format of an IMAGE_KINDS entry (one of FORMATS)."""
    return "tiff" if kind == "dng" else kind.split("_")[0].rstrip("0123456789")


def kind_extension(kind: str) -> str:
    return "dng" if kind == "dng" else {"jpeg": "jpg", "tiff": "tif"}.get(kind_format(kind),
                                                                         kind_format(kind))


def tiff_kind(rng, rgb: np.ndarray, kind: str) -> bytes:
    """A TIFF or DNG of [h, w, 3] uint8 `rgb` as `kind` (its layout drawn
    from `rng`); every variant but the 1-bit, palette and gray ones reads
    back to the pixels' own L plane."""
    from spacedrive_tpu_torch.media.imgdecode import l24

    h, w, _ = rgb.shape
    order = "<>"[int(rng.integers(0, 2))]
    strip = int(rng.integers(1, 65))
    if kind == "dng":
        mosaic = rgb.astype(np.int64)[..., 1] * 257
        mosaic[0::2, 0::2] = rgb[0::2, 0::2, 0].astype(np.int64) * 257
        mosaic[1::2, 1::2] = rgb[1::2, 1::2, 2].astype(np.int64) * 257
        return dng_bytes(rgb, mosaic, order, compression=int(rng.choice([1, 5])))
    if kind == "tiff_lzw":
        return tiff_bytes(tiff_image(rgb, 2, 8, order=order, compression=5,
                                     predictor=int(rng.integers(1, 3)), rows_per_strip=strip),
                          order=order)
    if kind == "tiff_deflate":
        wide = rng.random() < 0.5
        samples = rgb.astype(np.int64) * 257 + rng.integers(0, 2, rgb.shape) if wide else rgb
        tile = (16 * int(rng.integers(1, 9)), 16 * int(rng.integers(1, 9))) \
            if rng.random() < 0.6 else None
        return tiff_bytes(tiff_image(samples, 2, 16 if wide else 8, order=order,
                                     compression=int(rng.choice([8, 32946])),
                                     predictor=int(rng.integers(1, 3)),
                                     planar=int(rng.integers(1, 3)), tile=tile,
                                     rows_per_strip=strip), order=order)
    luma = l24(rgb)
    if kind == "tiff_packbits":
        pick = int(rng.integers(0, 3))
        if pick == 0:  # 8-bit gray, black or white is zero
            photometric = int(rng.integers(0, 2))
            img = tiff_image(luma if photometric else 255 - luma, photometric, 8, order=order,
                             compression=32773, rows_per_strip=strip)
        elif pick == 1:
            idx = (rgb.astype(np.int32) * 6 // 256) @ np.array([36, 6, 1])
            img = tiff_image(idx, 3, 8, order=order, compression=32773, rows_per_strip=strip,
                             colormap=CUBE * 257)
        else:
            levels = luma.astype(np.int64) >> 4
            ramp = np.arange(16) * 17 * 257
            img = tiff_image(levels, 3, 4, order=order, compression=32773,
                             rows_per_strip=strip, colormap=np.stack([ramp, ramp[::-1], ramp], 1))
        return tiff_bytes(img, order=order)
    pick = int(rng.integers(0, 4))  # tiff_raw
    if pick == 0:  # 1-bit, white or black is zero
        photometric = int(rng.integers(0, 2))
        bits = (luma >= 128).astype(np.int64)
        img = tiff_image(bits if photometric else 1 - bits, photometric, 1, order=order,
                         rows_per_strip=strip)
    elif pick == 1:  # I;16, a few samples past 255
        values = luma.astype(np.int64) + (rng.random((h, w)) < 0.01) * 1000
        img = tiff_image(values, 1, 16, order=order, rows_per_strip=strip)
    elif pick == 2:  # RGBA, associated or unassociated alpha
        alpha = rng.integers(128, 256, (h, w, 1))
        assoc = rng.random() < 0.5
        colour = rgb.astype(np.int64) * alpha // 255 if assoc else rgb.astype(np.int64)
        img = tiff_image(np.concatenate([colour, alpha], 2), 2, 8, order=order,
                         extra=(1,) if assoc else (2,), rows_per_strip=strip)
    else:  # RGB at 16 bits, as BigTIFF in one case of two (PIL reads II only)
        samples = rgb.astype(np.int64) * 257
        if rng.random() < 0.5:
            return tiff_bytes(tiff_image(samples, 2, 16, rows_per_strip=strip), order="<",
                              bigtiff=True)
        img = tiff_image(samples, 2, 16, order=order, rows_per_strip=strip)
    return tiff_bytes(img, order=order)


def webp_kind(rng, rgb: np.ndarray, kind: str) -> bytes:
    """A WebP of [h, w, 3] uint8 `rgb` as `kind`, its options drawn from
    `rng`."""
    h, w, _ = rgb.shape
    if kind == "webp_lossless":
        alpha = rng.integers(0, 256, (h, w)) if rng.random() < 0.3 else None
        return webp_lossless_bytes(rgb, alpha, predictor_bits=int(rng.integers(2, 6)),
                                   subtract_green=bool(rng.random() < 0.7),
                                   cache_bits=int(rng.integers(0, 11)))
    if kind == "webp_palette":  # 8 or 16 colours, pixels bundled two to a byte
        levels = (rgb >= 128).astype(np.uint8) * 255
        if rng.random() < 0.5:
            levels[..., 1] = (rgb[..., 1] >> 6) * 85
        return webp_lossless_bytes(levels, palette=True, cache_bits=int(rng.integers(0, 5)))
    lossy = dict(quality=int(rng.integers(40, 96)), partitions=int(rng.choice([1, 2, 4, 8])),
                 segments=bool(rng.random() < 0.5),
                 filter_kind=("simple", "normal")[int(rng.integers(0, 2))],
                 level=int(rng.integers(0, 64)), sharpness=int(rng.integers(0, 8)),
                 b_pred_share=0.1)
    if kind == "webp_lossy":
        return webp_lossy_bytes(rgb, rng, **lossy)
    if rng.random() < 0.5 or h < 4 or w < 4:  # VP8X with an ALPH chunk
        return webp_lossy_bytes(rgb, rng, alpha=rng.integers(0, 256, (h, w)),
                                alpha_method=int(rng.integers(0, 2)),
                                alpha_filter=int(rng.integers(0, 4)), **lossy)
    # Two animation frames: the first a part of the picture at an even
    # offset (the rest of the canvas stays transparent black), the second
    # the whole picture.
    fh, fw = int(rng.integers(h // 2, h + 1)), int(rng.integers(w // 2, w + 1))
    y0 = 2 * int(rng.integers(0, (h - fh) // 2 + 1))
    x0 = 2 * int(rng.integers(0, (w - fw) // 2 + 1))
    part = rgb[y0:y0 + fh, x0:x0 + fw]
    first = riff_chunk(b"VP8L", webp_lossless_stream(rgb_to_argb(part), predictor_bits=3)) \
        if rng.random() < 0.5 else riff_chunk(b"VP8 ", vp8_frame(part, rng, **lossy))
    second = riff_chunk(b"VP8 ", vp8_frame(rgb, rng, **lossy))
    return webp_animation_bytes([(first, x0, y0, fw, fh), (second, 0, 0, w, h)], (w, h))


def encode_image(rng, rgb: np.ndarray, kind: str, filters=None) -> tuple:
    """(file bytes, extension) of [h, w, 3] uint8 `rgb` as `kind`; PNG rows
    take `filters` (one 0..4 per row; random when None). ICO and WebP kinds
    keep at most 256 x 256 of the pixels (the WebP writers are Python
    loops)."""
    from spacedrive_tpu_torch.media.imgdecode import l24

    h, w, _ = rgb.shape
    if filters is None:
        filters = (rng.integers(0, 5, h) if rng.random() < 0.5
                   else np.full(h, int(rng.integers(0, 5))))
    ext = kind_extension(kind)
    if kind.startswith("bmp"):
        if kind == "bmp8":
            idx = (rgb.astype(np.int32) * 6 // 256) @ np.array([36, 6, 1])
            return bmp_bytes(idx, palette=CUBE), ext
        alpha = rng.integers(0, 256, (h, w)) if kind == "bmp32" else None
        return bmp_bytes(rgb, alpha=alpha, top_down=bool(rng.random() < 0.3)), ext
    if kind.startswith("jpeg"):
        quality = int(rng.integers(70, 96))
        if kind == "jpeg_gray":
            return jpeg_bytes(l24(rgb), quality), ext
        sampling = {"jpeg_422": (2, 1), "jpeg_444": (1, 1)}.get(kind, (2, 2))
        return jpeg_bytes(rgb, quality, sampling, progressive=kind == "jpeg_prog",
                          restart=int(rng.integers(1, 9)) if kind == "jpeg_rst" else 0,
                          adobe_rgb=kind == "jpeg_adobe"), ext
    if kind_format(kind) == "tiff":
        return tiff_kind(rng, rgb, kind), ext
    if kind.startswith("webp"):
        return webp_kind(rng, rgb[:256, :256], kind), ext
    idx8 = ((rgb.astype(np.int32) * 6 // 256) @ np.array([36, 6, 1])).astype(np.uint8)
    if kind.startswith("gif"):
        return gif_bytes(idx8, CUBE, local=bool(rng.random() < 0.5),
                         interlace=kind == "gif_interlaced"), ext
    if kind.startswith("ico"):
        px = rgb[:256, :256]
        h, w = px.shape[:2]
        if kind == "ico_png":
            big = png_bytes(px.reshape(h, -1), w, 2, 8, filters[:h], level=1)
        else:
            big = dib_bytes(px, 32, alpha=rng.integers(0, 256, (h, w)))
        small = dib_bytes(px[::max(1, h // 16), ::max(1, w // 16)][:16, :16], 24)
        return ico_bytes([(small, min(16, w), min(16, h), 24), (big, w, h, 32)]), ext
    luma = l24(rgb)
    if kind in ("png_rgb", "png_rgba", "png_adam7"):
        px = rgb if kind != "png_rgba" else np.concatenate(
            [rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2)
        return png_bytes(px.reshape(h, -1), w, 6 if kind == "png_rgba" else 2, 8, filters,
                         level=1, interlace=int(kind == "png_adam7")), ext
    if kind in ("png_rgb16", "png_rgba16"):
        px = rgb.astype(np.int64) * 257 + rng.integers(0, 2, (h, w, 3))
        if kind == "png_rgba16":
            px = np.concatenate([px, rng.integers(0, 1 << 16, (h, w, 1))], axis=2)
        return png_bytes(png16_rows(px.reshape(h, -1)), w, 6 if kind == "png_rgba16" else 2,
                         16, filters, level=1), ext
    if kind == "png_gray16":  # I;16 clips past 255: a few such pixels
        values = luma.astype(np.int64) + (rng.random((h, w)) < 0.01) * 1000
        return png_bytes(png16_rows(values), w, 0, 16, filters, level=1), ext
    if kind == "png_gray":
        return png_bytes(luma, w, 0, 8, filters, level=1), ext
    if kind == "png_la":
        la = np.stack([luma, rng.integers(0, 256, (h, w), dtype=np.uint8)], axis=2)
        return png_bytes(la.reshape(h, -1), w, 4, 8, filters, level=1), ext
    if kind == "png_pal8":
        trns = rng.integers(0, 256, len(CUBE)).astype(np.uint8).tobytes() \
            if rng.random() < 0.3 else None
        return png_bytes(idx8, w, 3, 8, filters, palette=CUBE, trns=trns, level=1), ext
    depth = int(kind[-1])
    levels = luma.astype(np.int32) * (1 << depth) // 256
    if kind.startswith("png_pal"):
        ramp = np.arange(1 << depth) * 255 // ((1 << depth) - 1)
        palette = np.stack([ramp, ramp[::-1], ramp], axis=1)
        return png_bytes(pack_bits(levels, depth), w, 3, depth, filters,
                         palette=palette, level=1), ext
    return png_bytes(pack_bits(levels, depth), w, 0, depth, filters, level=1), ext


def plain_phash_of(rgb: np.ndarray) -> np.ndarray:
    """The pHash of [h, w, 3] uint8 pixels by the plain host path (L24, the
    float64 LANCZOS, the CPU DCT): what any lossless encoding must give."""
    from spacedrive_tpu_torch.media.imgdecode import l24, resize_lanczos
    from spacedrive_tpu_torch.ops.phash import phash_torch

    grid = resize_lanczos(l24(rgb)).astype(np.float32)
    return phash_torch(grid[None], "cpu")[0]


def plain_phash_of_file(data: bytes) -> np.ndarray:
    """The pHash of an image file by the plain decoder and the CPU DCT."""
    from spacedrive_tpu_torch.media.imgdecode import decode_grid
    from spacedrive_tpu_torch.ops.phash import phash_torch

    return phash_torch(decode_grid(data, native=False)[None], "cpu")[0]


def _side(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def _corpus_task(root: Path, seed: int, sides, task) -> tuple:
    """Write one task's files; returns (bytes, planted pairs, redraws)."""
    kind, k, names = task
    rng = np.random.default_rng([seed, k, ["group", "single", "refused"].index(kind)])
    planted, redrawn, total = [], 0, 0
    if kind == "group":
        h, w = _side(rng, sides[1]), _side(rng, sides[0])
        scene = image_scene(rng, h, w)
        rgb = np.clip(scene, 0, 255).astype(np.uint8)
        base = plain_phash_of(rgb)
        members = [(names[0], encode_image(rng, rgb, "png_rgb", np.zeros(h, np.int64))[0]),
                   (names[1], encode_image(rng, rgb, "png_rgb", np.full(h, 4))[0]),
                   (names[2], encode_image(rng, rgb, "bmp24")[0])]
        for _ in range(8):
            sigma = np.float32(rng.uniform(3, 6))
            noisy = np.clip(scene + noise_like(rng, scene.shape) * sigma, 0, 255).astype(np.uint8)
            if np.bitwise_count(plain_phash_of(noisy) ^ base).sum() <= NEAR_DUP_THRESHOLD:
                members.append((names[3], encode_image(rng, noisy, "png_rgb")[0]))
                break
            redrawn += 1
        for _ in range(8):  # a JPEG re-encode, kept where the plain path agrees
            data = jpeg_bytes(rgb, int(rng.integers(75, 96)),
                              ((1, 1), (2, 1), (2, 2))[int(rng.integers(0, 3))],
                              progressive=bool(rng.random() < 0.3))
            if np.bitwise_count(plain_phash_of_file(data) ^ base).sum() <= NEAR_DUP_THRESHOLD:
                members.append((names[4], data))
                break
            redrawn += 1
        # A lossless TIFF (distance 0), then a lossy WebP kept as the JPEG is.
        members.append((names[5], tiff_kind(rng, rgb, ("tiff_lzw", "tiff_deflate")[
            int(rng.integers(0, 2))])))
        for _ in range(8):
            data = webp_lossy_bytes(rgb, rng, quality=int(rng.integers(75, 96)),
                                    partitions=int(rng.choice([1, 2, 4, 8])),
                                    segments=bool(rng.random() < 0.5),
                                    filter_kind=("simple", "normal")[int(rng.integers(0, 2))],
                                    level=int(rng.integers(0, 40)), b_pred_share=0.1)
            if np.bitwise_count(plain_phash_of_file(data) ^ base).sum() <= NEAR_DUP_THRESHOLD:
                members.append((names[6], data))
                break
            redrawn += 1
        for path, data in members:
            (root / path).write_bytes(data)
            total += len(data)
            if path != names[0]:
                planted.append(tuple(sorted((names[0], path))))
    elif kind == "single":
        enc = IMAGE_KINDS[k % len(IMAGE_KINDS)]
        h, w = _side(rng, sides[1]), _side(rng, sides[0])
        px = np.clip(image_scene(rng, h, w), 0, 255).astype(np.uint8)
        data = encode_image(rng, px, enc)[0]
        (root / names[0]).write_bytes(data)
        total = len(data)
    else:
        px = np.clip(image_scene(rng, 40, 60), 0, 255).astype(np.uint8)
        if k % 6 == 0:
            data = encode_image(rng, px, "png_rgb")[0]
            data = data[:int(rng.integers(16, len(data) - 20))]
        elif k % 6 == 1:
            data = jpeg_bytes(px)[:-2]
        elif k % 6 == 2:
            data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
        elif k % 6 == 3:
            data = tiff_kind(rng, px, "tiff_lzw")
            data = data[:int(rng.integers(8, len(data) - 8))]
        elif k % 6 == 4:
            data = webp_vp8_cut(rng, px)
        else:
            data = jpeg_bytes(px).replace(b"\xff\xc0", b"\xff\xc9", 1)
        (root / names[0]).write_bytes(data)
        total = len(data)
    return total, planted, redrawn


def webp_vp8_cut(rng, rgb: np.ndarray) -> bytes:
    """A lossy WebP whose VP8 data is cut short inside its token
    partition, the chunk and RIFF sizes made to match: a container
    libwebp takes, a frame it cannot finish."""
    frame = vp8_frame(rgb, rng, quality=90)
    first = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    keep = 10 + first + max(1, (len(frame) - 10 - first) // 4)
    return riff_webp(riff_chunk(b"VP8 ", frame[:keep]))


# The refused files in turn: their extensions.
REFUSED_EXTENSIONS = ("png", "jpg", "jpg", "tif", "webp", "jpg")


def write_image_corpus(root: Path, n_files: int, groups: int, copies: int, refused: int,
                       seed: int, sides=((48, 800), (48, 600)), executor=None) -> dict:
    """Write about `n_files` image files under `root`, CORPUS_DIR_FILES to a
    directory, sides log-uniform in `sides` ((min, max) width, (min, max)
    height), on `executor`'s workers (in this process when None):

    - `groups` planted near-dup groups: a scene as RGB PNG, the same pixels
      re-encoded with other row filters (distance 0, other bytes), as a
      24-bit BMP and as a lossless TIFF (distance 0), the scene with added
      noise of σ 3-6, a JPEG of the scene (quality 75-95, any chroma
      sampling, some progressive) and a lossy WebP of it (quality 75-95,
      1-8 partitions, segments, either loop filter), each of the last three
      kept where the plain path puts it within the threshold of the
      original (redrawn up to 8 times, else left out);
    - `copies` byte-identical copies of other images (one object each);
    - `refused` files the decoder must refuse: a truncated PNG, a JPEG
      without its EOI, a .jpg of random bytes, a truncated TIFF, a WebP
      whose VP8 data is cut, a JPEG whose frame header claims arithmetic
      coding, in turn (PIL refuses all but the last, which it decodes as
      noise);
    - the rest, single images of every kind in IMAGE_KINDS in turn.

    Returns {"planted": [(path, path)], "refused": [path], "files", "bytes",
    "redrawn", "kinds": {kind: single files}}, paths relative to `root`."""
    import functools

    counter = [0]

    def name(ext: str) -> str:
        k = counter[0]
        counter[0] += 1
        return f"d{k // CORPUS_DIR_FILES:03d}/img{k:06d}.{ext}"

    tasks = [("group", g, [name(e) for e in ("png", "png", "bmp", "png", "jpg", "tif", "webp")])
             for g in range(groups)]
    singles = n_files - 7 * groups - copies - refused
    if singles < copies:  # the copies are of single images
        raise ValueError(f"{n_files} files cannot hold {groups} groups of 7, {copies} copies "
                         f"and {refused} refused files beside the singles copied")
    tasks += [("single", k, [name(kind_extension(IMAGE_KINDS[k % len(IMAGE_KINDS)]))])
              for k in range(singles)]
    tasks += [("refused", k, [name(REFUSED_EXTENSIONS[k % len(REFUSED_EXTENSIONS)])])
              for k in range(refused)]
    copy_of = {name(t[2][0].rsplit(".", 1)[1]): t[2][0]
               for t in tasks[groups:groups + copies]}
    for d in sorted({p.split("/")[0] for t in tasks for p in t[2]} |
                    {p.split("/")[0] for p in copy_of}):
        (root / d).mkdir(parents=True, exist_ok=True)
    work = functools.partial(_corpus_task, root, seed, sides)
    if executor is not None:
        # The groups cost the most: spread them over the chunks (each
        # task draws from its own generator, so the order changes nothing).
        order = np.random.default_rng(seed).permutation(len(tasks))
        done = list(executor.map(work, [tasks[i] for i in order],
                                 chunksize=max(1, len(tasks) // 256)))
        results = [None] * len(tasks)
        for i, r in zip(order.tolist(), done):
            results[i] = r
    else:
        results = [work(t) for t in tasks]
    total = sum(r[0] for r in results)
    for dst, src in copy_of.items():
        data = (root / src).read_bytes()
        (root / dst).write_bytes(data)
        total += len(data)
    planted = [p for r in results for p in r[1]]
    return {"planted": planted, "refused": sorted(t[2][0] for t in tasks if t[0] == "refused"),
            "files": len(tasks) + len(planted) + len(copy_of), "bytes": total,
            "redrawn": sum(r[2] for r in results),
            "kinds": dict(collections.Counter(IMAGE_KINDS[k % len(IMAGE_KINDS)]
                                              for k in range(singles)))}


def near_dup_state(lib, root: str, location_id: int = None) -> dict:
    """What near-dup jobs left in `lib` for the location at `root` (all
    locations when `location_id` is None): {"hashes": {path: [2] uint32},
    "pairs": [((path, path), distance)], "errors": [path]}, each object
    named by its first path (relative to `root`) in sort order."""
    from spacedrive_tpu_torch.ops.phash import phash_from_bytes

    where, params = ("fp.is_dir = 0", []) if location_id is None else \
        ("fp.is_dir = 0 AND fp.location_id = ?", [location_id])
    rows = lib.db.query(
        "SELECT fp.materialized_path, fp.name, fp.extension, fp.object_id, md.phash "
        "FROM file_path fp LEFT JOIN media_data md ON md.object_id = fp.object_id "
        f"WHERE {where}", params)
    canon, blobs = {}, {}
    for r in rows:
        rel = _rel_path("", r)[1:]
        canon[r["object_id"]] = min(canon.get(r["object_id"], rel), rel)
        if r["phash"] is not None:
            blobs[r["object_id"]] = r["phash"]
    pairs = sorted((tuple(sorted((canon[r["object_a_id"]], canon[r["object_b_id"]]))),
                    r["distance"]) for r in lib.db.query("SELECT * FROM near_dup_pair")
                   if r["object_a_id"] in canon and r["object_b_id"] in canon)
    prefix = root.rstrip("/") + "/"
    errors = [e.split(": ", 1)[1] for rep in job_reports(lib)
              if rep.name == "near_dup_detector" for e in rep.errors_text]
    return {"hashes": {canon[o]: phash_from_bytes(b) for o, b in blobs.items()},
            "pairs": pairs,
            "errors": sorted(e[len(prefix):] for e in errors if e.startswith(prefix))}


def brute_force_pairs(hashes: dict, threshold: int, block: int = 2048) -> list:
    """Every pair of `hashes` (path → [W] uint32) within `threshold`, as
    near_dup_state lists them: numpy XOR + bitwise_count in row blocks."""
    paths = sorted(hashes)
    d = np.stack([hashes[p] for p in paths]) if paths else np.zeros((0, 2), np.uint32)
    out = []
    for r0 in range(0, len(paths), block):
        dist = np.bitwise_count(d[r0:r0 + block, None, :] ^ d[None, :, :]).sum(axis=-1)
        ii, jj = np.nonzero(dist <= threshold)
        keep = r0 + ii < jj
        out += [((paths[r0 + i], paths[j]), int(dist[i, j]))
                for i, j in zip(ii[keep].tolist(), jj[keep].tolist())]
    return sorted(out)


# -- phases 9 and 10: near-dup search -----------------------------------------

# Cut from 10 000 files to make room for phase 12 (a cut of scale).
NEAR_DUP_A = dict(n_files=4_400, groups=180, copies=60, refused=20)
NEAR_DUP_B = dict(n_files=2_000, groups=60, copies=20, refused=6)
PLAIN_DECODE_SAMPLE = 1024
# Phase 10: the job's ALL_PAIRS_LIMIT, the 1M-digest scale of
# tools/near_dup_scale.py, and the pyramid's tile.
SCALE_DIGESTS = (100_000, 1_000_000, 4096)
CORPUS_PROCESSES = 8
# The Hamming kernels' bound: each in-range pair costs 32W x 2 s8 tensor
# operations (dense int8: 8192 a SM a clock, the data sheet's 1979 TOPS
# over 132 SMs at 1830 MHz) and a compare and a count on the CUDA cores
# (ISSUE_LANES a SM a clock), both terms at the SMs' max clock.
INT8_OPS_PER_SM_CLOCK = 8192
COMPARE_OPS_PER_PAIR = 2
# Count form timing shapes: the 1M sweep's blocks (4096 rows, g = 16; 64
# tile pairs of the 100 000-digest grid in the sweep's order) and its
# refinement's (256 rows, g = 16; 4096 blocks).
COUNT_SHAPES = {"sweep": (4096, 16, 64), "refine": (256, 16, 4096)}


@contextlib.contextmanager
def recording(module, name: str, store: dict, seconds: dict = None):
    """While open, each call ``module.name(path)`` stores its result in
    `store` under `path`, and its wall time in `seconds` (a bracket around
    the decoder: it changes nothing)."""
    fn = getattr(module, name)

    def recorded(path, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(path, *args, **kwargs)
        if seconds is not None:
            seconds[path] = time.perf_counter() - t0
        store[path] = out
        return out

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


def run_near_dup_job(lib, location_id: int, counts: dict, key: str) -> tuple:
    """NearDupDetectorJob(backend="cuda") on a fresh JobManager, the launch
    counts reset just before and read just after, every grid the job
    decodes recorded and CUDA event pairs around each pHash on the card.
    Returns (wall s, job report, {path: grid}, {path: decode s}, [pHash
    device ms per step])."""
    import asyncio

    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.objects.dedup import NearDupDetectorJob
    from spacedrive_tpu_torch.ops import blake3_cuda, hamming_cuda, phash

    async def main():
        jobs = JobManager()
        jid = await jobs.ingest(lib, NearDupDetectorJob(location_id=location_id,
                                                        backend="cuda"))
        await jobs.wait_idle()
        return jid

    grids, seconds, spans = {}, {}, []
    with recording(phash, "image_to_grid", grids, seconds), \
            device_spans(phash, "phash_bits", spans):
        torch.cuda.synchronize()
        blake3_cuda.reset_launches()
        hamming_cuda.reset_launches()
        t0 = time.perf_counter()
        jid = asyncio.run(main())
        wall = time.perf_counter() - t0
    counts[key] = {**blake3_cuda.launches, **hamming_cuda.launches}
    report = next(r for r in job_reports(lib) if r.id == jid)
    torch.cuda.synchronize()
    return wall, report, grids, seconds, [start.elapsed_time(end) for start, end in spans]


def corpus_executor():
    """CORPUS_PROCESSES worker processes for the corpus writer and the
    plain decoder, spawned (the parent holds the card)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        CORPUS_PROCESSES, mp_context=multiprocessing.get_context("spawn"))


def plain_grids(paths: list, executor) -> list:
    """The plain decoder (Python unfilter, numpy L24 and LANCZOS) over
    `paths` on `executor`'s workers."""
    import functools

    from spacedrive_tpu_torch.media import imgdecode

    return list(executor.map(functools.partial(imgdecode.image_to_grid, native=False), paths,
                             chunksize=16))


def file_format(path: str) -> str:
    """The FORMATS entry of a corpus file, by its extension."""
    ext = path.rsplit(".", 1)[-1]
    return {"jpg": "jpeg", "tif": "tiff", "dng": "tiff"}.get(ext, ext)


def check_near_dup_location(name: str, root: Path, lib, location_id: int, made: dict,
                            wall: float, report, grids: dict, seconds: dict,
                            phash_device_ms: list, executor) -> dict:
    """The checks of one near-dup location; returns its numbers."""
    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.ops import phash

    state = near_dup_state(lib, str(root), location_id)
    require(set(made["kinds"]) == set(IMAGE_KINDS),
            f"{name}: the corpus lacks the kinds {sorted(set(IMAGE_KINDS) - set(made['kinds']))}")
    require(report.status == JobStatus.COMPLETED_WITH_ERRORS,
            f"{name}: near-dup job ended {report.status.name}: {report.errors_text[:2]}")
    require(state["errors"] == made["refused"],
            f"{name}: job errors {state['errors'][:3]}... != the {len(made['refused'])} "
            "refused files")
    decoded = {os.path.relpath(p, root): g for p, g in grids.items() if g is not None}
    require(len(decoded) == made["files"] - len(made["refused"]) == report.metadata["hashed"],
            f"{name}: decoded {len(decoded)}, hashed {report.metadata['hashed']}, "
            f"files {made['files']} - {len(made['refused'])} refused")
    # Native decode against the plain decoder on a sample; every stored
    # pHash against the plain (CPU) pHash of its grid, under the tie rule.
    rng = np.random.default_rng(len(decoded))
    sample = sorted(rng.choice(sorted(decoded), min(PLAIN_DECODE_SAMPLE, len(decoded)),
                               replace=False).tolist())
    t0 = time.perf_counter()
    plain = plain_grids([str(root / p) for p in sample], executor)
    plain_decode_s = time.perf_counter() - t0
    require(all(g is not None and np.array_equal(g, decoded[p]) for p, g in zip(sample, plain)),
            f"{name}: native grids != the plain decoder's on the sample")
    sample_formats = collections.Counter(file_format(p) for p in sample)
    require(set(sample_formats) == set(FORMATS),
            f"{name}: the plain sample holds {dict(sample_formats)}, not every format")
    by_format = collections.defaultdict(list)
    webp_by_chunk = collections.defaultdict(list)  # VP8L, VP8 or VP8X (ALPH, animation)
    for p, dt in seconds.items():
        if grids[p] is not None:
            by_format[file_format(p)].append(dt)
            if file_format(p) == "webp":
                with open(p, "rb") as f:
                    webp_by_chunk[f.read(16)[12:16].decode().strip()].append(dt)
    paths = sorted(state["hashes"])
    stored = np.stack([state["hashes"][p] for p in paths])
    g = np.stack([decoded[p] for p in paths])
    plain_hashes = phash.phash_torch(g, "cpu")
    require(phash.agree_under_ties(stored, plain_hashes, g),
            f"{name}: stored pHashes != the plain pHash beyond the tie rule")
    ties = int((phash.words_to_bits(stored) != phash.words_to_bits(plain_hashes)).sum())
    t0 = time.perf_counter()
    brute = brute_force_pairs(state["hashes"], NEAR_DUP_THRESHOLD)
    brute_s = time.perf_counter() - t0
    require(state["pairs"] == brute,
            f"{name}: {len(state['pairs'])} stored pairs != {len(brute)} brute-force pairs")
    found = {pair for pair, _ in state["pairs"]}
    missing = [p for p in made["planted"] if p not in found]
    require(not missing, f"{name}: planted pairs not found: {missing[:3]}")
    phase_s = report.metadata["phase_s"]
    steps = len(phash_device_ms)
    return dict(files=made["files"], bytes=made["bytes"], objects_hashed=len(paths),
                refused=len(made["refused"]), planted=len(made["planted"]),
                redrawn=made["redrawn"], pairs=len(state["pairs"]), job_wall_s=wall,
                images_per_s=report.metadata["hashed"] / wall, hash_steps=steps,
                decode_ms_per_image=phase_s["decode"] / len(decoded) * 1e3,
                decode_ms_per_image_by_format={
                    f: float(np.mean(by_format[f])) * 1e3 for f in FORMATS},
                images_by_format={f: len(by_format[f]) for f in FORMATS},
                decode_ms_webp_by_first_chunk={k: float(np.mean(v)) * 1e3
                                               for k, v in sorted(webp_by_chunk.items())},
                webp_by_first_chunk={k: len(v) for k, v in sorted(webp_by_chunk.items())},
                plain_sample_by_format=dict(sample_formats),
                decode_s_per_step=phase_s["decode"] / steps,
                phash_host_s_per_step=phase_s["phash"] / steps,
                phash_device_ms_per_step=float(np.mean(phash_device_ms)),
                phash_device_ms_median=float(np.median(phash_device_ms)),
                phash_device_ms_first=phash_device_ms[0],
                phash_device_ms_max=float(np.max(phash_device_ms)),
                db_s_per_step=phase_s["db_hash"] / steps, compare_load_s=phase_s["load"],
                compare_pairs_s=phase_s["pairs"], compare_db_s=phase_s["db_pairs"],
                pyramid_s=report.metadata["pyramid_s"], plain_sample=len(sample),
                plain_decode_s=plain_decode_s, tie_bits_differing=ties,
                brute_force_s=brute_s)


def phase_near_dup_job(workdir: Path, counts: dict) -> dict:
    """Phase 9: two image locations scanned and searched on the card."""
    from spacedrive_tpu_torch.library import Libraries

    lib = Libraries(str(workdir / "library")).create("chip-smoke-near-dup")
    out = {}
    try:
        with corpus_executor() as executor:
            for name, spec, seed in (("A", NEAR_DUP_A, 51), ("B", NEAR_DUP_B, 52)):
                out[name] = near_dup_location(workdir, lib, name, spec, seed, counts,
                                              executor)
    finally:
        lib.db.close()
    return out


def near_dup_location(workdir: Path, lib, name: str, spec: dict, seed: int, counts: dict,
                      executor) -> dict:
    """Write, scan and search one phase 9 location; returns its numbers."""
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.ops import hamming_cuda

    root = workdir / f"images-{name}"
    t0 = time.perf_counter()
    made = write_image_corpus(root, seed=seed, executor=executor, **spec)
    corpus_s = time.perf_counter() - t0
    location_id = locations.create_location(lib, str(root))
    scan_wall = run_scan(lib, location_id, counts, f"near_dup_scan_{name}", [])
    wall, report, grids, seconds, phash_ms = run_near_dup_job(lib, location_id, counts,
                                                              f"near_dup_job_{name}")
    launches = counts[f"near_dup_job_{name}"][hamming_cuda.NEAR_MASK]
    count_launches = counts[f"near_dup_job_{name}"][hamming_cuda.NEAR_COUNTS]
    out = dict(corpus_write_s=corpus_s, scan_wall_s=scan_wall,
               hamming_near_mask_launches=launches,
               hamming_near_counts_launches=count_launches,
               **check_near_dup_location(name, root, lib, location_id, made, wall, report,
                                         grids, seconds, phash_ms, executor))
    # One mask launch when every digest fits one tile; the pyramid's count
    # launches past it.
    one_tile = out["objects_hashed"] <= 4096
    require(launches == int(one_tile) and (count_launches == 0) == one_tile,
            f"{name}: {launches} hamming_near_mask and {count_launches} hamming_near_counts "
            f"launches for {out['objects_hashed']} digests")
    emit(f"near_dup_job_{name}", **out)
    return out


def make_digests(n: int, planted: int, threshold: int, seed: int = 0):
    """``tools/near_dup_scale.py``'s digests: n random 64-bit digests, with
    `planted` pairs copied from one row to another and up to `threshold`
    bits flipped (sources and targets one disjoint sample)."""
    rng = np.random.default_rng(seed)
    digests = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    both = rng.choice(n, size=2 * planted, replace=False)
    src, dst = both[:planted], both[planted:]
    flips = rng.integers(0, threshold + 1, size=len(src))
    digests[dst] = digests[src]
    for k in range(len(src)):
        bits = rng.choice(64, size=flips[k], replace=False)
        for b in bits:
            digests[dst[k], b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    pairs = {(min(a, b), max(a, b)) for a, b in zip(src.tolist(), dst.tolist())}
    return digests, pairs


def tiled_pairs(digests: np.ndarray, threshold: int, tile: int) -> list:
    """Every (i < j) pair within `threshold` without the pyramid:
    ``hamming_near_mask`` over each tile pair (j ≥ i) on the card."""
    from spacedrive_tpu_torch.ops import hamming_cuda

    d = torch.from_numpy(np.ascontiguousarray(digests).view(np.int32)).cuda()
    n, out = len(d), []
    for i0 in range(0, n, tile):
        for j0 in range(i0, n, tile):
            mask = hamming_cuda.hamming_near_mask(d[i0:i0 + tile], d[j0:j0 + tile], threshold,
                                                  i0, j0, n)
            ii, jj = (t.cpu().numpy() for t in torch.nonzero(mask, as_tuple=True))
            out += list(zip((ii + i0).tolist(), (jj + j0).tolist()))
    return sorted(out)


def hamming_bound(bound: "Bound", pairs: int, words: int, nbytes: int) -> dict:
    """Least time for `pairs` in-range pairs at W words and `nbytes` moved:
    the largest of the tensor, compare and byte terms."""
    clock = bound.sms * bound.clock_mhz * 1e6
    terms = dict(tensor_ms=pairs * 32 * words * 2 / (clock * INT8_OPS_PER_SM_CLOCK) * 1e3,
                 compare_ms=pairs * COMPARE_OPS_PER_PAIR / (clock * ISSUE_LANES) * 1e3,
                 bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    ops = max(terms["tensor_ms"], terms["compare_ms"])
    return dict(bound_ms=max(ops, terms["bytes_ms"]),
                bound_by="operations" if ops >= terms["bytes_ms"] else "bytes",
                bound_terms=terms, in_range_pairs=pairs, bytes=nbytes)


def plane_product(x: torch.Tensor, y: torch.Tensor):
    """The library yardstick: one ±1 fp16 ``torch.matmul`` of the planes,
    the product a matmul-based search pays before any compare (x [..., n,
    W], y [..., m, W] int32 words)."""
    from spacedrive_tpu_torch.ops import hamming_cuda

    xp = hamming_cuda.bit_planes(x, torch.float16)
    yp = hamming_cuda.bit_planes(y, torch.float16).transpose(-1, -2)
    return lambda: torch.matmul(xp, yp)


def mask_stats(bound: "Bound", n: int, words: int, seed: int) -> dict:
    """hamming_near_mask against its plain version at [n, words], bit for
    bit, and both timed on the card beside one fp16 product of the planes;
    the bound from this shape's work."""
    from spacedrive_tpu_torch.ops import hamming_cuda

    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32) & np.uint32(0x0F0F0F0F)
    x = torch.from_numpy(d.view(np.int32)).cuda()
    threshold = 8 * words  # about half the pairs near: both branches taken
    got = hamming_cuda.hamming_near_mask(x, x, threshold)
    want = hamming_cuda.near_mask_plain(x, x, threshold)
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item())
    require(err == 0, f"hamming_near_mask != plain at [{n}, {words}]")
    ms = time_device(lambda: hamming_cuda.hamming_near_mask(x, x, threshold), reps=50)
    plain_ms = time_device(lambda: hamming_cuda.near_mask_plain(x, x, threshold), reps=5)
    library_ms = time_device(plane_product(x, x), reps=20)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                shape=[n, words], near_pairs=int(want.sum().item()),
                **hamming_bound(bound, in_range_pairs(n, n), words, n * n + 2 * n * words * 4))


def count_stats(bound: "Bound", d: np.ndarray, form: str) -> dict:
    """hamming_near_counts against its plain version, bit for bit, at a
    COUNT_SHAPES shape over the digests d (threshold NEAR_DUP_THRESHOLD),
    both timed beside one fp16 product of the blocks' planes."""
    from spacedrive_tpu_torch.ops import hamming_cuda

    size, g, F = COUNT_SHAPES[form]
    n = len(d) // size * size
    words = torch.from_numpy(np.ascontiguousarray(d[:n]).view(np.int32)).cuda()
    if form == "sweep":
        iu, ju = np.triu_indices(n // size)
        blocks = np.stack([iu, ju], 1)[:F]
    else:  # diagonal blocks and random blocks above the diagonal
        rng = np.random.default_rng(F)
        b = np.sort(rng.integers(0, n // size, (F, 2)), axis=1)
        b[:F // 8, 1] = b[:F // 8, 0]
        blocks = b
    origins = blocks.astype(np.int64) * size
    t = NEAR_DUP_THRESHOLD
    got = hamming_cuda.hamming_near_counts(words, origins, size, g, t, n)
    want = hamming_cuda.near_counts_plain(words, origins, size, g, t, n)
    err = int((got - want).abs().max().item())
    require(err == 0, f"hamming_near_counts != plain at the {form} shape")
    ms = time_device(lambda: hamming_cuda.hamming_near_counts(words, origins, size, g, t, n),
                     reps=20)
    plain_ms = time_device(lambda: hamming_cuda.near_counts_plain(words, origins, size, g, t, n),
                           reps=3)
    ar = torch.arange(size, device="cuda")
    o = torch.from_numpy(origins).cuda()
    library_ms = time_device(plane_product(words[o[:, :1] + ar], words[o[:, 1:] + ar]), reps=5)
    pairs = sum(in_range_pairs(size, size, int(i), int(j), n) for i, j in origins)
    rows = len(np.unique(blocks)) * size
    nbytes = rows * 2 * 4 + origins.nbytes + F * g * g * 4
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                shape=[F, size, size, g], near_pairs=int(want.sum().item()),
                **hamming_bound(bound, pairs, 2, nbytes))


def in_range_pairs(n: int, m: int, oi: int = 0, oj: int = 0,
                   n_valid: Optional[int] = None) -> int:
    """Pairs of an [n, m] near mask at origin (oi, oj) with gi < gj, both
    below `n_valid`: the pairs whose products the kernels need (the rest
    are 0 by definition)."""
    n_valid = max(oi + n, oj + m) if n_valid is None else n_valid
    gi = np.arange(oi, min(oi + n, n_valid), dtype=np.int64)
    lo = np.maximum(gi + 1, oj)
    return int(np.clip(min(oj + m, n_valid) - lo, 0, None).sum())


def counted_pairs(d: np.ndarray, tile: int, counts: dict, key: str, stats: dict) -> list:
    """near_dup_pairs(device="cuda") as a main path: the launch counts reset
    just before and read just after."""
    from spacedrive_tpu_torch.ops import hamming, hamming_cuda

    torch.cuda.synchronize()
    hamming_cuda.reset_launches()
    pairs = hamming.near_dup_pairs(d, NEAR_DUP_THRESHOLD, tile, stats=stats, device="cuda")
    counts[key] = dict(hamming_cuda.launches)
    return pairs


def phase_near_dup_scale(bound: "Bound", n_b: int, counts: dict) -> dict:
    """Phase 10: the exact search at 100 000 and 1 000 000 digests, the
    pair budget, and both Hamming forms against their plain versions."""
    import warnings

    from spacedrive_tpu_torch.ops import hamming

    out = {}
    n_exact, n_large, tile = SCALE_DIGESTS
    d, planted = make_digests(n_exact, 1000, NEAR_DUP_THRESHOLD, seed=1)
    stats = {}
    t0 = time.perf_counter()
    pairs = counted_pairs(d, tile, counts, "scale_100k", stats)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = tiled_pairs(d, NEAR_DUP_THRESHOLD, tile)
    check_s = time.perf_counter() - t0
    require(pairs == want, f"100k: {len(pairs)} pyramid pairs != {len(want)} tiled pairs")
    require(planted <= set(pairs), "100k: a planted pair is missing")
    out["digests_exact_limit"] = dict(n=n_exact, wall_s=wall, stage_s=stats["stage_s"],
                                      pairs=len(pairs), tiled_check_s=check_s)
    out["counts"] = {form: count_stats(bound, d, form) for form in COUNT_SHAPES}

    d, planted = make_digests(n_large, 5000, NEAR_DUP_THRESHOLD, seed=0)
    stats = {}
    t0 = time.perf_counter()
    pairs = counted_pairs(d, tile, counts, "scale_1m", stats)
    wall = time.perf_counter() - t0
    got = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    dist = np.bitwise_count(d[got[:, 0]] ^ d[got[:, 1]]).sum(axis=1)
    require(bool((dist <= NEAR_DUP_THRESHOLD).all()) and bool((got[:, 0] < got[:, 1]).all()),
            "1M: a returned pair is past the threshold or not i < j")
    recall = len(planted & set(pairs)) / len(planted)
    require(recall == 1.0, f"1M: planted recall {recall}")
    out["digests_large"] = dict(n=n_large, wall_s=wall, stage_s=stats["stage_s"],
                                pairs=len(pairs), planted=len(planted), recall=recall,
                                yardstick_s=2 * n_large**2 * 64 / 989e12)
    emit("pyramid_stages", **{f"{n}": {"wall_s": r["wall_s"], **r["stage_s"]} for n, r in (
        (n_exact, out["digests_exact_limit"]), (n_large, out["digests_large"]))})

    # A degenerate cluster past MAX_TOTAL_PAIRS: 3000 equal digests in tile 0,
    # against the plain pyramid on the CPU (same tiles kept and dropped).
    d = make_digests(3 * tile, 0, NEAR_DUP_THRESHOLD, seed=2)[0]
    d[:3000] = d[0]
    d[2 * tile + 1] = d[3 * tile - 1]
    stats, plain_stats = {}, {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pairs = counted_pairs(d, tile, counts, "truncation", stats)
        plain = hamming.near_dup_pairs(d, NEAR_DUP_THRESHOLD, tile, stats=plain_stats,
                                       device="cpu")
    total = len(tiled_pairs(d, NEAR_DUP_THRESHOLD, tile))
    require(any("truncating" in str(w.message) for w in caught), "no truncation warning")
    require(pairs == plain and stats.get("truncated_pairs") == plain_stats["truncated_pairs"],
            f"truncation: the card kept {len(pairs)} pairs, dropped "
            f"{stats.get('truncated_pairs')}; the plain pyramid {len(plain)}, "
            f"{plain_stats['truncated_pairs']}")
    require(stats.get("truncated_pairs", 0) > 0 and (2 * tile + 1, 3 * tile - 1) in pairs
            and len(pairs) + stats["truncated_pairs"] == total > hamming.MAX_TOTAL_PAIRS
            >= len(pairs), f"truncation: {stats.get('truncated_pairs')} dropped, "
            f"{len(pairs)} kept of {total}")
    out["truncation"] = dict(pairs=total, truncated_pairs=stats["truncated_pairs"],
                             kept=len(pairs))

    out["mask"] = {f"{n}x{w}": mask_stats(bound, n, w, seed=n + w)
                   for n, w in ((n_b, 2), (tile, 2), (tile, 8))}
    emit("near_dup_scale", **out)
    return out


# -- phase 11: the live library -------------------------------------------------

LIVE_FILES = 8192          # the location: 8 sub-directories of 1024 sparse files
LIVE_PAGE = 1024           # the identifier's device_batch here: 8 steps
LIVE_PAUSE_AFTER = (2, 3)  # pause after the 2nd step, and after the 1st of the resumed run
LIVE_DEADLINE_S = 10.0     # the watcher's light rescans land within it
LIVE_IMAGES = 64
LIVE_BUDGET_S = 40.0


@contextlib.contextmanager
def after_each_step(hook):
    """While open, ``hook(job)`` runs on the step's thread after each
    FileIdentifierJob step, before the step returns to its worker."""
    from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob

    step = FileIdentifierJob._step

    def stepped(self, ctx, data):
        out = step(self, ctx, data)
        hook(self)
        return out

    FileIdentifierJob._step = stepped
    try:
        yield
    finally:
        FileIdentifierJob._step = step


async def until(cond, deadline_s: float, what: str) -> None:
    import asyncio

    deadline = time.monotonic() + deadline_s
    while not cond():
        require(time.monotonic() < deadline, f"{what}: not within {deadline_s} s")
        await asyncio.sleep(0.002)


def independent_cas_ids(files: list) -> list:
    """``cas_ids_for_files(backend="cuda")`` over (path, size) pairs in
    pages of LIVE_PAGE on one pool, outside any job."""
    from spacedrive_tpu_torch.ops import staging

    pool = staging.cas_pool(LIVE_PAGE)
    out = []
    for k in range(0, len(files), LIVE_PAGE):
        ids, errors = staging.cas_ids_for_files(files[k:k + LIVE_PAGE], "cuda", pool=pool)
        require(not errors, f"independent cuda call errors {list(errors.values())[:2]}")
        out.extend(ids[i] for i in range(len(files[k:k + LIVE_PAGE])))
    require(pool.in_use == 0, "independent call leases out")
    return out


def live_rows(lib, root: Path) -> dict:
    rows = lib.db.query("SELECT id, materialized_path, name, extension, is_dir, cas_id, "
                        "object_id, date_modified, size_in_bytes_bytes FROM file_path "
                        "ORDER BY id")
    return {os.path.relpath(_rel_path(str(root), r), root): r for r in rows}


def live_pause_resume(lib, location_id: int, root: Path, counts: dict) -> dict:
    """The scan chain with the identifier at LIVE_PAGE files a step: paused
    after its 2nd step, resumed live, paused after one more step, the
    manager shut down, then a new manager's cold_resume to the end."""
    import asyncio

    from spacedrive_tpu_torch.jobs.manager import JobBuilder, JobManager
    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob
    from spacedrive_tpu_torch.ops import blake3_cuda, cas

    steps, at_pause = [0], []

    async def first_run():
        loop = asyncio.get_running_loop()
        jobs = JobManager()

        def pause_job(job):
            jid = next(j for j, w in jobs.running.items() if w.job is job)
            jobs.pause(jid)

        def hook(job):
            steps[0] += 1
            if steps[0] in LIVE_PAUSE_AFTER:
                loop.call_soon_threadsafe(pause_job, job)

        def identifier():
            return next((j for j, w in jobs.running.items()
                         if w.report.name == "file_identifier"), None)

        with after_each_step(hook):
            await JobBuilder(IndexerJob(location_id=location_id)).queue_next(
                FileIdentifierJob(location_id=location_id, backend="cuda",
                                  device_batch=LIVE_PAGE)).spawn(jobs, lib)
            await until(lambda: identifier() is not None, 120, "the identifier's start")
            jid = identifier()
            for k in range(len(LIVE_PAUSE_AFTER)):
                status = await jobs.wait(jid)
                require(status == JobStatus.PAUSED, f"pause {k}: the identifier ended "
                        f"{status.name}")
                job = jobs._paused[jid].job
                at_pause.append(dict(completed=jobs._paused[jid].report.completed_task_count,
                                     holds_pool=job._pool is not None,
                                     holds_thread=job._executor is not None))
                if k + 1 < len(LIVE_PAUSE_AFTER):
                    await jobs.resume(lib, jid)
            t0 = time.perf_counter()
            await jobs.shutdown()
            return time.perf_counter() - t0

    async def cold():
        jobs = JobManager()
        resumed = await jobs.cold_resume(lib)
        require(len(resumed) == 1, f"cold_resume resumed {len(resumed)} jobs, not 1")
        await jobs.wait_idle()

    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    t0 = time.perf_counter()
    shutdown_s = asyncio.run(first_run())
    t1 = time.perf_counter()
    asyncio.run(cold())
    t2 = time.perf_counter()
    counts["live_scan"] = launches = dict(blake3_cuda.launches)

    reports = {rep.name: rep for rep in job_reports(lib)}
    require(set(reports) == {"indexer", "file_identifier"}, f"jobs {sorted(reports)}")
    for name, rep in reports.items():
        require(rep.status == JobStatus.COMPLETED,
                f"{name} ended {rep.status.name}: {rep.errors_text[:2]}")
    meta = reports["file_identifier"].metadata
    require([p["completed"] for p in at_pause] == list(LIVE_PAUSE_AFTER),
            f"paused at steps {at_pause}, not {LIVE_PAUSE_AFTER}")
    require(not any(p["holds_pool"] or p["holds_thread"] for p in at_pause),
            f"a paused identifier holds its pool or its thread: {at_pause}")
    require([p["in_use"] for p in meta["pauses"]] == [0] * len(LIVE_PAUSE_AFTER),
            f"pool leases at the pauses: {meta['pauses']}")
    rows = [r for r in live_rows(lib, root).items() if not r[1]["is_dir"]]
    sizes = [int.from_bytes(r["size_in_bytes_bytes"], "big") for _, r in rows]
    require(len(rows) == LIVE_FILES and min(sizes) > cas.MINIMUM_FILE_SIZE,
            f"{len(rows)} files, smallest {min(sizes)} B")
    pages = -(-LIVE_FILES // LIVE_PAGE)
    # Each pause drops the page the hash-ahead worker hashed; the resumed
    # run hashes it again. One size class: one K1 launch per page hashed.
    require(meta["pages_hashed"] == pages + len(LIVE_PAUSE_AFTER),
            f"{meta['pages_hashed']} pages hashed, not {pages} + {len(LIVE_PAUSE_AFTER)}")
    require(launches[blake3_cuda.FAST] == meta["pages_hashed"],
            f"K1 launched {launches[blake3_cuda.FAST]} times for {meta['pages_hashed']} pages")
    require(launches[blake3_cuda.WINDOWED] == launches[blake3_cuda.FOLD] == 0,
            f"the scan launched K2 or the fold: {launches}")
    t3 = time.perf_counter()
    want = independent_cas_ids([(str(root / rel), s) for (rel, _), s in zip(rows, sizes)])
    independent_s = time.perf_counter() - t3
    require([r["cas_id"] for _, r in rows] == want,
            "resumed scan CAS IDs != the independent cuda call")
    n_objects = lib.db.query_one("SELECT COUNT(*) AS n FROM object")["n"]
    require(n_objects == len(set(want)), f"{n_objects} objects != {len(set(want))} CAS IDs")
    return dict(first_run_s=t1 - t0, shutdown_s=shutdown_s, cold_resume_s=t2 - t1,
                scan_s=t2 - t0, pages=pages, pages_hashed=meta["pages_hashed"],
                paused_after_steps=[p["completed"] for p in at_pause],
                pool_in_use_at_pauses=[p["in_use"] for p in meta["pauses"]],
                launches=launches, independent_cuda_s=independent_s)


def _live_write(path: Path, marker: str, size: int = SCAN_FILE_BYTES) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.ftruncate(fd, size)
        os.pwrite(fd, marker.encode(), 0)
    finally:
        os.close(fd)


def live_changes(root: Path) -> dict:
    """In two sub-directories: 300 new files, 50 edits (same size, new
    bytes, mtime + 100 s), 20 renames, 40 deletes and one new directory
    with two files. New files are written before any delete, so none takes
    a deleted file's inode."""
    dirs = [root / "scan-000", root / "scan-001"]
    new, edited, renamed, deleted = [], {}, {}, []
    for d, path in enumerate(dirs):
        for k in range(150):
            new.append(path / f"live-{k:03d}")
            _live_write(new[-1], f"live new {d}-{k:06d}")
    added = dirs[0] / "added-dir"
    added.mkdir()
    for k in range(2):
        new.append(added / f"inner-{k}")
        _live_write(new[-1], f"live inner {k:06d}")
    for d, path in enumerate(dirs):
        olds = sorted(p for p in path.iterdir() if p.name.startswith("f"))
        for p in olds[:25]:
            st = os.stat(p)
            with open(p, "r+b") as f:
                f.write(f"live edit {d}-{p.name}".encode())
            os.utime(p, (st.st_atime, st.st_mtime + 100))
            edited[p] = os.stat(p).st_mtime
        for p in olds[25:35]:
            renamed[p] = p.with_name(f"renamed-{p.name}")
            os.rename(p, renamed[p])
        for p in olds[35:55]:
            deleted.append(p)
            os.remove(p)
    return dict(new=new, edited=edited, renamed=renamed, deleted=deleted, added_dir=added)


def live_watch(lib, location_id: int, root: Path, counts: dict) -> dict:
    """watch_location (inotify), the changes of live_changes, and the light
    rescans that bring the location's rows back to the disk."""
    import asyncio

    from spacedrive_tpu_torch.locations import shallow, watcher
    from spacedrive_tpu_torch.ops import blake3_cuda

    before = live_rows(lib, root)
    rescans = []
    scan = shallow.light_scan_location

    def recorded(library, loc, sub_path=None, backend="cuda"):
        k0, t0 = blake3_cuda.launches[blake3_cuda.FAST], time.perf_counter()
        out = scan(library, loc, sub_path, backend)
        rescans.append(dict(sub_path=sub_path, s=time.perf_counter() - t0,
                            k1=blake3_cuda.launches[blake3_cuda.FAST] - k0,
                            **{k: v for k, v in out.items() if k != "errors"},
                            errors=len(out["errors"])))
        return out

    def on_disk() -> set:
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}

    async def main():
        events = []
        live = watcher.Locations(on_event=events.append, owner="chip-smoke-live")
        try:
            require(live.watch_location(lib, location_id), "watch_location refused")
            w = live.watchers[(lib.id, location_id)]
            require(isinstance(w, watcher.LocationWatcher),
                    f"the {type(w).__name__} ran, not the inotify watcher")
            await asyncio.sleep(0.2)
            torch.cuda.synchronize()
            blake3_cuda.reset_launches()
            t0 = time.perf_counter()
            made = live_changes(root)
            changes_s = time.perf_counter() - t0

            def caught_up() -> bool:
                if not live.idle():
                    return False
                rows = live_rows(lib, root)
                files = {rel for rel, r in rows.items() if not r["is_dir"]}
                return (files == on_disk()
                        and all(r["object_id"] is not None for rel, r in rows.items()
                                if not r["is_dir"])
                        and all(abs(rows[os.path.relpath(p, root)]["date_modified"] - m) < 1e-3
                                for p, m in made["edited"].items()))

            deadline = time.monotonic() + LIVE_DEADLINE_S
            while not caught_up():
                require(time.monotonic() < deadline,
                        f"the light rescans did not catch up within {LIVE_DEADLINE_S} s "
                        f"({len(rescans)} rescans, events {events[-3:]})")
                await asyncio.sleep(0.05)
            caught_s = time.perf_counter() - t0
            launches = dict(blake3_cuda.launches)
            errors = [e for e in events if e["type"] == "WatcherError"]
            require(not errors, f"watcher errors: {errors[:3]}")
            return made, changes_s, caught_s, launches, type(w).__name__, len(w._path_to_wd)
        finally:
            await live.close()

    shallow.light_scan_location = recorded
    try:
        made, changes_s, caught_s, launches, kind, watches = asyncio.run(main())
    finally:
        shallow.light_scan_location = scan
    counts["live_watch"] = launches
    require(launches[blake3_cuda.FAST] > 0
            and launches[blake3_cuda.FAST] == sum(r["k1"] for r in rescans),
            f"K1 launched {launches} in all, {sum(r['k1'] for r in rescans)} in the rescans")
    require(launches[blake3_cuda.WINDOWED] == launches[blake3_cuda.FOLD] == 0,
            f"the rescans launched K2 or the fold: {launches}")
    require(all(r["errors"] == 0 for r in rescans), f"rescan errors: {rescans}")
    after = live_rows(lib, root)
    require(os.path.relpath(made["added_dir"], root) in after, "the new directory has no row")
    fresh = made["new"] + sorted(made["edited"])
    files = [(str(p), os.path.getsize(p)) for p in fresh]
    want = independent_cas_ids(files)
    got = [after[os.path.relpath(p, root)]["cas_id"] for p in fresh]
    require(got == want, "new and edited files' CAS IDs != the independent cuda call")
    for old, new in made["renamed"].items():
        a, b = before[os.path.relpath(old, root)], after[os.path.relpath(new, root)]
        require((a["id"], a["cas_id"], a["object_id"]) == (b["id"], b["cas_id"], b["object_id"]),
                f"the renamed {old.name} lost its row or its object")
    return dict(watcher=kind, watches=watches,
                changes=dict(new=len(made["new"]), edited=len(made["edited"]),
                             renamed=len(made["renamed"]), deleted=len(made["deleted"]),
                             new_dirs=1),
                changes_write_s=changes_s, caught_up_s=caught_s, rescans=len(rescans),
                rescan_s=sum(r["s"] for r in rescans), rescan_list=rescans,
                launches=launches)


def live_browse(workdir: Path, counts: dict) -> dict:
    """walk_ephemeral(compute_cas_ids=True) over a directory outside any
    location: LIVE_IMAGES PNG and JPEG images of the harness's writers and a
    few other files, against the plain version."""
    from spacedrive_tpu_torch.locations.non_indexed import walk_ephemeral
    from spacedrive_tpu_torch.ops import blake3_cuda, cas

    root = workdir / "browse"
    (root / "sub").mkdir(parents=True)
    rng = np.random.default_rng(110)
    kinds = [k for k in IMAGE_KINDS if k.startswith(("png", "jpeg"))]
    t0 = time.perf_counter()
    for i in range(LIVE_IMAGES):
        h, w = (int(v) for v in rng.integers(48, 257, 2))
        rgb = np.clip(image_scene(rng, h, w), 0, 255).astype(np.uint8)
        data, ext = encode_image(rng, rgb, kinds[i % len(kinds)])
        (root / f"img{i:02d}.{ext}").write_bytes(data)
    (root / "notes.txt").write_bytes(b"not an image\n" * 40)
    (root / "blob.bin").write_bytes(rng.integers(0, 256, 200_000, np.uint8).tobytes())
    (root / "empty.png").write_bytes(b"")
    (root / ".hidden.png").write_bytes(b"a hidden file")
    (root / "sub" / "inner.png").write_bytes(b"inside a sub-directory")
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    t0 = time.perf_counter()
    got = walk_ephemeral(str(root), compute_cas_ids=True)
    wall = time.perf_counter() - t0
    counts["live_browse"] = launches = dict(blake3_cuda.launches)
    t0 = time.perf_counter()
    plain = walk_ephemeral(str(root), compute_cas_ids=True, device="cpu")
    plain_s = time.perf_counter() - t0
    require(got == plain, "walk_ephemeral on the card != its plain version")
    images = [e for e in got if e["cas_id"]]
    require(len(images) == LIVE_IMAGES and len(got) == LIVE_IMAGES + 4,
            f"{len(images)} CAS IDs in {len(got)} entries")
    sizes = [e["size_in_bytes"] for e in images]
    classes = any(s > cas.MINIMUM_FILE_SIZE for s in sizes) + any(
        s <= cas.MINIMUM_FILE_SIZE for s in sizes)
    require(launches[blake3_cuda.FAST] == classes,
            f"walk_ephemeral launched {launches}, not one K1 per size class ({classes})")
    return dict(images=len(images), entries=len(got), write_s=write_s, wall_s=wall,
                plain_s=plain_s, size_classes=classes, launches=launches)


def actor_stats(db, before: Optional[dict] = None) -> dict:
    """The write actor's groups, tickets and tickets per group, and the
    database's commits, since `before` (another actor_stats) if given."""
    now = dict(groups=db._actor.groups, tickets=db._actor.batches, commits=db._commits)
    if before is not None:
        now = {k: v - before[k] for k, v in now.items() if k in before}
    now["tickets_per_group"] = now["tickets"] / now["groups"] if now["groups"] else 0.0
    return now


def phase_live(counts: dict) -> dict:
    """Phase 11: the live library on the card."""
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-live-") as tmp:
        workdir = Path(tmp)
        root = workdir / "location"
        root.mkdir()
        t0 = time.perf_counter()
        extend_scan_corpus(root, LIVE_FILES)
        corpus_s = time.perf_counter() - t0
        lib = Libraries(str(workdir / "data")).create("chip-smoke-live")
        try:
            location_id = locations.create_location(lib, str(root))
            scan = live_pause_resume(lib, location_id, root, counts)
            watch = live_watch(lib, location_id, root, counts)
            browse = live_browse(workdir, counts)
            actor = actor_stats(lib.db)
        finally:
            lib.db.close()
    wall = time.perf_counter() - t_all
    out = dict(wall_s=wall, parts=dict(corpus_write_s=corpus_s, scan_s=scan["scan_s"],
                                       watch_s=watch["caught_up_s"], browse_s=browse["wall_s"]),
               files=LIVE_FILES, scan=scan, watch=watch, browse=browse, actor=actor,
               launches={k: counts[k] for k in ("live_scan", "live_watch", "live_browse")})
    emit("live", **out)
    require(wall <= LIVE_BUDGET_S, f"phase 11 took {wall:.1f} s, past its {LIVE_BUDGET_S} s")
    return out


# -- media plane (phase 12) ---------------------------------------------------

MEDIA_CAMERA = 16             # 4032 x 3024 4:2:0 JPEGs with a camera's EXIF block
MEDIA_CAMERA_SCENES = 8       # distinct pictures among them (two EXIF blocks each)
MEDIA_SINGLES = 1100          # small images of every IMAGE_KINDS kind in turn
MEDIA_BROWSE = 64
MEDIA_SIDES = ((48, 640), (48, 480))
MEDIA_PLAIN_SAMPLE = 48       # small images whose grid the plain passes recompute
MEDIA_PLAIN_ENCODES = 12      # thumbnails the plain encoder and decoder redo
MEDIA_PSNR_FLOOR = 20.0       # dB, the floor tests/test_torch_thumbnail.py holds too
MEDIA_BUDGET_S = 110.0
# Planted GPS fixes, one a quadrant: (lat d, m, s as a rational, ref, lon ...,
# ref) and (latitude, longitude, plus code) as the JAX package computes them
# (spacedrive_tpu/media/exif.py and pluscodes.py, run once where it runs).
MEDIA_GPS = (
    ((37, 46, (3025, 100)), "N", (122, 25, (21, 2)), "W",
     (37.77506944444444, -122.41958333333334, "849VQHGJ+25")),
    ((33, 52, (4, 1)), "S", (151, 12, (26, 1)), "E",
     (-33.867777777777775, 151.2072222222222, "4RRH46J4+VV")),
    ((51, 30, (26, 1)), "N", (0, 7, (39, 1)), "W",
     (51.507222222222225, -0.1275, "9C3XGV4F+V2")),
    ((22, 54, (30, 1)), "S", (43, 11, (47, 1)), "W",
     (-22.90833333333333, -43.19638888888888, "589R3RR3+MC")),
)


def exif_fields(k: int) -> dict:
    """Camera fields of EXIF block k: what the writer plants and the
    media_data row must read back."""
    fix = MEDIA_GPS[k % len(MEDIA_GPS)]
    return {"make": f"Maker{k % 5}", "model": f"Camera {k}", "software": "fw 2.1",
            "lens_make": "Optics", "lens_model": f"Lens {k % 3} 24-70mm",
            "date": f"2024:0{1 + k % 9}:1{k % 10} 0{k % 10}:30:00",
            "f_number": (14 + k % 50, 10), "exposure_time": (1, 60 + k), "focal_length": (24 + k, 1),
            "iso": 100 * (1 + k % 32), "orientation": 1 + k % 8, "gps": fix}


def exif_tiff(fields: dict, order: str = "<", ifd0_only: bool = False) -> bytes:
    """A TIFF-structured EXIF block: IFD0 (Make, Model, Software,
    Orientation and the Exif and GPS IFD offsets), the Exif IFD (the date,
    f-number, exposure, ISO, focal length, lens), the GPS IFD (both
    references and both degree triples)."""
    def asc(s):
        return (2, list((s + "\x00").encode("latin-1")))

    (lat, lat_ref, lon, lon_ref, _) = fields["gps"]

    def dms(v):
        d, m, s = v
        return (5, [d, 1, m, 1, s[0], s[1]])

    ifd0 = {271: asc(fields["make"]), 272: asc(fields["model"]), 305: asc(fields["software"]),
            274: (3, [fields["orientation"]])}
    exif = {0x9003: asc(fields["date"]), 0x829D: (5, list(fields["f_number"])),
            0x829A: (5, list(fields["exposure_time"])), 0x920A: (5, list(fields["focal_length"])),
            0x8827: (3, [fields["iso"]]), 0xA433: asc(fields["lens_make"]),
            0xA434: asc(fields["lens_model"])}
    gps = {1: asc(lat_ref), 2: dms(lat), 3: asc(lon_ref), 4: dms(lon)}
    if ifd0_only:
        return _exif_layout([ifd0], order)
    ifd0 = {**ifd0, 0x8769: (4, [0]), 0x8825: (4, [0])}
    return _exif_layout([ifd0, exif, gps], order)


def _exif_ifd(entries: dict, at: int, order: str) -> bytes:
    body = struct.pack(order + "H", len(entries))
    extra_at = at + 2 + 12 * len(entries) + 4
    extra = b""
    for tag in sorted(entries):
        kind, values = entries[tag]
        payload = bytes(values) if kind == 2 else struct.pack(
            order + {3: "H", 4: "I", 5: "I"}[kind] * len(values), *values)
        count = len(values) // 2 if kind == 5 else len(values)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack(order + "I", extra_at + len(extra))
            extra += payload + b"\x00" * (len(payload) & 1)
        body += struct.pack(order + "HHI", tag, kind, count) + field
    return body + b"\x00\x00\x00\x00" + extra


def _exif_layout(ifds: list, order: str) -> bytes:
    """IFD0 at 8, then the Exif and GPS IFDs, IFD0's pointers filled."""
    sizes = [len(_exif_ifd(d, 0, order)) for d in ifds]
    at = [8]
    for n in sizes[:-1]:
        at.append(at[-1] + n)
    if len(ifds) == 3:
        ifds[0][0x8769], ifds[0][0x8825] = (4, [at[1]]), (4, [at[2]])
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", 8)
    return head + b"".join(_exif_ifd(d, a, order) for d, a in zip(ifds, at))


def expected_media_row(fields: dict, ifd0_only: bool = False) -> dict:
    """The camera_data and media_location (decoded) a row of `fields` holds."""
    cam = {"make": fields["make"], "model": fields["model"], "software": fields["software"],
           "orientation": fields["orientation"]}
    if ifd0_only:
        return {"camera_data": cam}
    cam.update(lens_make=fields["lens_make"], lens_model=fields["lens_model"],
               f_number=fields["f_number"][0] / fields["f_number"][1],
               exposure_time=fields["exposure_time"][0] / fields["exposure_time"][1],
               focal_length=fields["focal_length"][0] / fields["focal_length"][1],
               iso=fields["iso"])
    lat, lon, code = fields["gps"][4]
    return {"camera_data": cam, "media_date": fields["date"],
            "media_location": {"latitude": lat, "longitude": lon, "pluscode": code}}


def jpeg_with_exif(jpeg: bytes, tiff: bytes) -> bytes:
    seg = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + jpeg[2:]


def png_with_exif(png: bytes, tiff: bytes) -> bytes:
    at = png.index(b"IDAT") - 4
    return png[:at] + png_chunk(b"eXIf", tiff) + png[at:]


def webp_with_exif(rgb: np.ndarray, tiff: bytes) -> bytes:
    """A VP8X lossless WebP with an EXIF chunk after its image."""
    h, w, _ = rgb.shape
    vp8x = riff_chunk(b"VP8X", bytes([0x08, 0, 0, 0]) + (w - 1).to_bytes(3, "little") +
                      (h - 1).to_bytes(3, "little"))
    return riff_webp(vp8x + riff_chunk(b"VP8L", webp_lossless_stream(rgb_to_argb(rgb)))
                     + riff_chunk(b"EXIF", tiff))


def tiff_with_exif(rgb: np.ndarray, fields: dict) -> bytes:
    """An RGB TIFF whose IFD0 carries Make, Model, Software, Orientation 1
    and an Exif IFD pointer; the Exif IFD (date, f-number, ...) after the
    image. PIL's row reads IFD0 only: the JAX function asks for the sub-IFD
    after its file is closed."""
    tags = {271: (2, list((fields["make"] + "\x00").encode())),
            272: (2, list((fields["model"] + "\x00").encode())),
            305: (2, list((fields["software"] + "\x00").encode())), 274: (3, [1]),
            0x8769: (4, [0])}
    data = tiff_bytes(tiff_image(rgb, 2, 8, rows_per_strip=32, tags=tags))
    sub = _exif_ifd({0x9003: (2, list((fields["date"] + "\x00").encode())),
                     0x8827: (3, [fields["iso"]])}, len(data), "<")
    ifd0 = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, ifd0)[0]
    out = bytearray(data)
    for i in range(n):
        e = ifd0 + 2 + 12 * i
        if struct.unpack_from("<H", out, e)[0] == 0x8769:
            struct.pack_into("<I", out, e + 8, len(data))
    return bytes(out) + sub


def raw_with_preview(rgb: np.ndarray, preview: bytes, make: str) -> bytes:
    """A TIFF-structured RAW (.dng/.nef): IFD0 a small 8-bit RGB strip with
    Make and Model, its SubIFD a JPEGInterchangeFormat preview."""
    small = rgb[:16, :16]
    ifd0 = tiff_image(small, 2, 8, rows_per_strip=16,
                      tags={254: (4, [1]), 271: (2, list((make + "\x00").encode())),
                            272: (2, list(b"RAW 1\x00"))})
    base = tiff_bytes(ifd0)
    sub_at = len(base)
    jpeg_at = sub_at + 2 + 12 * 3 + 4
    sub = struct.pack("<H", 3) + struct.pack("<HHII", 254, 4, 1, 0) + \
        struct.pack("<HHII", 0x201, 4, 1, jpeg_at) + \
        struct.pack("<HHII", 0x202, 4, 1, len(preview)) + struct.pack("<I", 0)
    at = struct.unpack_from("<I", base, 4)[0]
    n = struct.unpack_from("<H", base, at)[0]
    # IFD0 gains SubIFDs (330) in place of its NewSubfileType's value slot:
    # rewrite the entry table with one more entry at the file's end.
    entries = [base[at + 2 + 12 * i:at + 14 + 12 * i] for i in range(n)]
    entries.append(struct.pack("<HHII", 330, 4, 1, sub_at))
    entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
    new_at = jpeg_at + len(preview) + (len(preview) & 1)
    table = struct.pack("<H", n + 1) + b"".join(entries) + b"\x00\x00\x00\x00"
    out = bytearray(base + sub + preview + b"\x00" * (len(preview) & 1) + table)
    struct.pack_into("<I", out, 4, new_at)
    return bytes(out)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def heif_with_jpeg(jpeg: bytes, tiff: bytes, width: int, height: int, brand: bytes) -> bytes:
    """An ISO BMFF file: a JPEG-coded primary item, an Exif item, the
    primary's size in ispe (the layout media/isobmff.py reads)."""
    ftyp = _box(b"ftyp", brand + b"\x00\x00\x00\x00mif1" + brand)
    pitm = _box(b"pitm", b"\x00\x00\x00\x00" + struct.pack(">H", 1))
    infe = [_box(b"infe", b"\x02\x00\x00\x00" + struct.pack(">HH", i, 0) + t + b"\x00")
            for i, t in ((1, b"jpeg"), (2, b"Exif"))]
    iinf = _box(b"iinf", b"\x00\x00\x00\x00" + struct.pack(">H", 2) + b"".join(infe))
    ispe = _box(b"ispe", b"\x00\x00\x00\x00" + struct.pack(">II", width, height))
    iprp = _box(b"iprp", _box(b"ipco", ispe))
    exif_item = struct.pack(">I", 0) + tiff

    def build(off1, off2):
        iloc = _box(b"iloc", b"\x00\x00\x00\x00" + struct.pack(">BBH", 0x44, 0, 2)
                    + struct.pack(">HHHII", 1, 0, 1, off1, len(jpeg))
                    + struct.pack(">HHHII", 2, 0, 1, off2, len(exif_item)))
        hdlr = _box(b"hdlr", bytes(8) + b"pict" + bytes(13))
        return ftyp + _box(b"meta", b"\x00\x00\x00\x00" + hdlr + pitm + iinf + iloc + iprp)

    at = len(build(0, 0)) + 8
    return build(at, at + len(jpeg)) + _box(b"mdat", jpeg + exif_item)


def camera_scene(k: int) -> np.ndarray:
    """A 4032 x 3024 picture: smooth gradients and a few edges."""
    h, w = 3024, 4032
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / (250 + 30 * k) + y / 470),
                    128 + 90 * np.cos(y / (380 + 20 * k) - x / 900),
                    (x + y * (k + 1)) / 31 % 256], -1)
    img[(y.astype(np.int64) // 500 + x.astype(np.int64) // 700 + k) % 5 == 0] *= 0.6
    return np.clip(img, 0, 255).astype(np.uint8)


def _media_task(root: Path, seed: int, task) -> dict:
    """Write one phase 12 file; returns {path: (bytes written, expected,
    (w, h) or None, kind)}: `expected` the row the file must read back ({}
    for a resolution-only row, None for no row), (w, h) the size of the
    image the thumbnail is made from (None where the port's decoder says)."""
    kind, k, path = task
    rng = np.random.default_rng([seed, k, len(kind)])
    out = {}
    if kind == "camera":  # one picture, a file for each of its EXIF blocks
        jpeg = jpeg_bytes(camera_scene(k), 85, (2, 2))
        for j in range(k, MEDIA_CAMERA, MEDIA_CAMERA_SCENES):
            fields = exif_fields(j)
            out[f"camera/IMG_{j:04d}.jpg"] = (jpeg_with_exif(jpeg, exif_tiff(fields)),
                                              expected_media_row(fields), (4032, 3024),
                                              "jpeg_camera")
    elif kind == "exif":
        h, w = _side(rng, MEDIA_SIDES[1]), _side(rng, MEDIA_SIDES[0])
        rgb = np.clip(image_scene(rng, h, w), 0, 255).astype(np.uint8)
        fields = exif_fields(100 + k)
        fmt = ("jpg", "png", "webp", "tiff", "heic", "avif", "dng", "nef")[k % 8]
        if fmt == "jpg":
            data = jpeg_with_exif(jpeg_bytes(rgb, 90), exif_tiff(fields, ">"))
            want, size = expected_media_row(fields), (w, h)
        elif fmt == "png":
            data = png_with_exif(encode_image(rng, rgb, "png_rgb")[0], exif_tiff(fields))
            want, size = expected_media_row(fields), (w, h)
        elif fmt == "webp":
            small = rgb[:256, :256]
            data = webp_with_exif(small, exif_tiff(fields))
            want, size = expected_media_row(fields), (small.shape[1], small.shape[0])
        elif fmt == "tiff":
            data = tiff_with_exif(rgb, fields)
            want, size = expected_media_row(fields, ifd0_only=True), (w, h)
            want["camera_data"]["orientation"] = 1
        elif fmt in ("heic", "avif"):
            data = heif_with_jpeg(jpeg_bytes(rgb, 90), exif_tiff(fields), 4 * w, 4 * h,
                                  fmt.encode())
            want, size = expected_media_row(fields), (w, h)
            want["resolution"] = (4 * w, 4 * h)
        else:
            data = raw_with_preview(rgb, jpeg_bytes(rgb, 90), fields["make"])
            want = {"camera_data": {"make": fields["make"], "model": "RAW 1"},
                    "resolution": (16, 16)} if fmt == "dng" else None
            size = (w, h)
        out[path.replace(".ext", f".{fmt}")] = (data, want, size, f"{fmt}_exif")
    elif kind == "single":
        enc = IMAGE_KINDS[k % len(IMAGE_KINDS)]
        h, w = _side(rng, MEDIA_SIDES[1]), _side(rng, MEDIA_SIDES[0])
        px = np.clip(image_scene(rng, h, w), 0, 255).astype(np.uint8)
        data, ext = encode_image(rng, px, enc)
        ext = {"tif": "tiff"}.get(ext, ext)
        media = ext in ("jpg", "png", "webp", "tiff", "dng")
        out[path.replace(".ext", f".{ext}")] = (data, {} if media else None, None, enc)
    for rel, (data, *_rest) in out.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    return {rel: (len(data), *rest) for rel, (data, *rest) in out.items()}


def write_media_corpus(root: Path, seed: int, executor) -> dict:
    """Phase 12's images: the camera JPEGs, EXIF-bearing files of every
    media format, IMAGE_KINDS singles."""
    tasks = [("camera", k, "camera") for k in range(MEDIA_CAMERA_SCENES)]
    tasks += [("exif", k, f"exif/x{k:04d}.ext") for k in range(64)]
    tasks += [("single", k, f"d{k // 256:02d}/s{k:05d}.ext") for k in range(MEDIA_SINGLES)]
    import functools

    made = {}
    for part in executor.map(functools.partial(_media_task, root, seed), tasks):
        made.update(part)
    return {"files": {rel: rest for rel, (_, *rest) in made.items()},
            "bytes": sum(n for n, *_ in made.values())}


# -- the second media slice's files: the harness's own writers ----------------

MEDIA_VIDEO_1080 = (1920, 1080)   # the I_PCM H.264 frame, a phone video's size
MEDIA_SVG_DOCS = {
    # Left third red, right third blue: the thumbnail must keep them.
    "flag.svg": """<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 300 200">
  <rect width="100" height="200" fill="red"/><rect x="100" width="100" height="200"
  fill="rgb(255, 255, 255)"/><rect x="200" width="100" height="200" fill="#0000ff"/>
  <circle cx="150" cy="100" r="40" fill="none" stroke="black" stroke-width="9"/></svg>""",
    "icon.svg": """<svg xmlns="http://www.w3.org/2000/svg" width="120" height="90">
  <g transform="translate(60,45) rotate(30) scale(1.2,0.8)">
    <ellipse rx="40" ry="20" fill="hsl(40, 80%, 60%)" stroke="DarkSlateGray"
      stroke-width="3"/></g>
  <path d="M 5 80 C 20 40, 40 100, 60 60 S 100 20, 115 70" fill="none" stroke="#c03"
    stroke-width="1.5" opacity="0.8"/>
  <polyline points="10,10 40,20 20,35 55,30" fill="none" stroke="navy" stroke-width="0.2"/>
  <path d="M80 10 A 12 8 30 1 1 100 20 z" fill="url(#none)" stroke="green"/></svg>""",
    "tall.svgz": """<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 40 400">
  <rect width="40" height="400" fill="teal"/><line x1="0" y1="0" x2="40" y2="400"
  stroke="white" stroke-width="5"/></svg>""",
    "broken.svg": "<svg",
}


def wav_bytes(seconds: float, rate: int, channels: int) -> bytes:
    import io
    import wave

    n = int(seconds * rate)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        t = np.arange(n) / rate
        pcm = (8000 * np.sin(2 * np.pi * 440 * t)).astype("<i2")
        w.writeframes(np.repeat(pcm, channels).tobytes())
    return buf.getvalue()


def flac_bytes(rate: int, channels: int, depth: int, total: int) -> bytes:
    bits = (rate << 44) | ((channels - 1) << 41) | ((depth - 1) << 36) | total
    info = struct.pack(">HH", 4096, 4096) + bytes(6) + bits.to_bytes(8, "big") + bytes(16)
    return b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info


def mp3_bytes(frames: int) -> bytes:
    """MPEG-1 Layer III at 128 kbps, 44.1 kHz, stereo, behind a 10-byte ID3
    tag: 417-byte frames."""
    return b"ID3\x04\x00\x00\x00\x00\x00\x0a" + bytes(10) + (
        b"\xff\xfb\x90\x00" + bytes(413)) * frames


def ogg_vorbis_bytes(rate: int, channels: int, granule: int) -> bytes:
    ident = b"\x01vorbis" + struct.pack("<IBI", 0, channels, rate) + bytes(9)
    first = b"OggS\x00\x02" + struct.pack("<q", 0) + bytes(12) + bytes([1, len(ident)]) + ident
    last = b"OggS\x00\x04" + struct.pack("<q", granule) + bytes(12) + bytes([1, 1, 0])
    return first + last


def riff_chunk(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("<I", len(payload)) + payload + (b"\x00" if len(payload) & 1
                                                               else b"")


def avi_mjpeg_bytes(jpegs: list, width: int, height: int, fps: int) -> bytes:
    """RIFF AVI: hdrl (avih, one vids strl of MJPG), movi of 00dc frames,
    idx1."""
    us = 1_000_000 // fps
    big = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", us, big * fps, 0, 0x10, len(jpegs), 0, 1, big, width, height,
                       0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, len(jpegs), big,
                                     0xFFFFFFFF, 0) + struct.pack("<4H", 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3,
                       0, 0, 0, 0)
    hdrl = riff_chunk(b"LIST", b"hdrl" + riff_chunk(b"avih", avih) + riff_chunk(
        b"LIST", b"strl" + riff_chunk(b"strh", strh) + riff_chunk(b"strf", strf)))
    movi, index = b"movi", []
    for j in jpegs:
        index.append(b"00dc" + struct.pack("<III", 0x10, len(movi), len(j)))
        movi += riff_chunk(b"00dc", j)
    body = b"AVI " + hdrl + riff_chunk(b"LIST", movi) + riff_chunk(b"idx1", b"".join(index))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def bmff_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def bmff_full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return bmff_box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def bmff_trak(handler: bytes, entry: bytes, timescale: int, duration: int, samples: int,
              width: int = 0, height: int = 0, tables: bytes = None) -> bytes:
    tkhd = bmff_full(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0, duration) + bytes(8)
                     + struct.pack(">hhhh", 0, 0, 0, 0) + MATRIX
                     + struct.pack(">II", width << 16, height << 16))
    mdhd = bmff_full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4,
                                                0))
    hdlr = bmff_full(b"hdlr", 0, 0, bytes(4) + handler + bytes(12) + b"smoke\x00")
    stsd = bmff_full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
    stts = bmff_full(b"stts", 0, 0, struct.pack(">III", 1, samples, max(duration // samples, 1)))
    stbl = bmff_box(b"stbl", stsd + stts + (tables or b""))
    return bmff_box(b"trak", tkhd + bmff_box(b"mdia", mdhd + hdlr + bmff_box(b"minf", stbl)))


def avc1_entry(width: int, height: int, avcc: bytes = b"") -> bytes:
    return bmff_box(b"avc1", bytes(6) + struct.pack(">H", 1) + bytes(16)
                    + struct.pack(">HHII", width, height, 0x480000, 0x480000) + bytes(4)
                    + struct.pack(">H", 1) + bytes(32) + struct.pack(">Hh", 0x18, -1)
                    + (bmff_box(b"avcC", avcc) if avcc else b""))


def mp4_with_cover_bytes(width: int, height: int, seconds: int, cover: bytes) -> bytes:
    """An MP4 of an avc1 video track (no decodable sample) and an mp4a audio
    track, with iTunes cover art in moov/udta/meta/ilst/covr."""
    mp4a = bmff_box(b"mp4a", bytes(6) + struct.pack(">H", 1) + bytes(8)
                    + struct.pack(">HH", 2, 16) + bytes(4) + struct.pack(">I", 48000 << 16))
    mvhd = bmff_full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, 1000 * seconds)
                     + struct.pack(">IH", 0x10000, 0x100) + bytes(10) + MATRIX + bytes(24)
                     + struct.pack(">I", 3))
    video = bmff_trak(b"vide", avc1_entry(width, height), 12800, 12800 * seconds,
                      30 * seconds, width, height)
    audio = bmff_trak(b"soun", mp4a, 48000, 48000 * seconds, 48000 * seconds)
    covr = bmff_box(b"covr", bmff_box(b"data", struct.pack(">II", 13, 0) + cover))
    udta = bmff_box(b"udta", bmff_full(b"meta", 0, 0, bmff_full(b"hdlr", 0, 0, bytes(20))
                                       + bmff_box(b"ilst", covr)))
    return (bmff_box(b"ftyp", b"isom\x00\x00\x02\x00isommp42")
            + bmff_box(b"moov", mvhd + video + audio + udta) + bmff_box(b"mdat", bytes(64)))


def ebml(eid: int, payload: bytes) -> bytes:
    size = bytes([0x80 | len(payload)]) if len(payload) < 0x7F else struct.pack(
        ">BI", 0x08, len(payload))
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + size + payload


def mkv_with_attachment_bytes(width: int, height: int, ms: float, cover: bytes) -> bytes:
    info = ebml(0x1549A966, ebml(0x2AD7B1, (1_000_000).to_bytes(3, "big"))
                + ebml(0x4489, struct.pack(">d", ms)))
    vtrack = ebml(0xAE, ebml(0x83, b"\x01") + ebml(0x86, b"V_MPEG4/ISO/AVC") + ebml(
        0xE0, ebml(0xB0, width.to_bytes(2, "big")) + ebml(0xBA, height.to_bytes(2, "big"))))
    atrack = ebml(0xAE, ebml(0x83, b"\x02") + ebml(0x86, b"A_AAC") + ebml(
        0xE1, ebml(0xB5, struct.pack(">f", 44100.0)) + ebml(0x9F, b"\x02")))
    attach = ebml(0x1941A469, ebml(0x61A7, ebml(0x466E, b"cover.jpg")
                                   + ebml(0x4660, b"image/jpeg") + ebml(0x465C, cover)))
    return (ebml(0x1A45DFA3, ebml(0x4282, b"matroska"))
            + ebml(0x18538067, info + ebml(0x1654AE6B, vtrack + atrack) + attach))


class _Bits:
    """An RBSP bit writer: u(n), ue, se, byte alignment."""

    def __init__(self):
        self.bits = []

    def u(self, value: int, n: int) -> None:
        self.bits += [(value >> k) & 1 for k in range(n - 1, -1, -1)]

    def ue(self, v: int) -> None:
        v += 1
        self.bits += [0] * (v.bit_length() - 1)
        self.u(v, v.bit_length())

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def bytes(self, stop: bool = True) -> bytes:
        bits = self.bits + ([1] if stop else [])
        bits += [0] * (-len(bits) % 8)
        return np.packbits(np.array(bits, np.uint8)).tobytes()


def nal(kind: int, rbsp: bytes) -> bytes:
    """A NAL unit (ref_idc 3) with emulation-prevention bytes."""
    return bytes([0x60 | kind]) + re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp,
                                         flags=re.S)


def h264_ipcm_nals(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, height: int) -> list:
    """SPS, PPS and one IDR slice of I_PCM macroblocks (baseline, CAVLC,
    no deblocking) carrying planes y [H, W], cb and cr [H/2, W/2], H and W
    multiples of 16, cropped to `height` rows."""
    h_mb, w_mb = y.shape[0] // 16, y.shape[1] // 16
    sps = _Bits()
    for v, n in ((66, 8), (0xC0, 8), (40, 8)):
        sps.u(v, n)
    for v in (0, 0, 2, 0):
        sps.ue(v)               # sps id, log2 max frame num - 4, poc type 2, refs
    sps.u(0, 1)
    sps.ue(w_mb - 1)
    sps.ue(h_mb - 1)
    sps.u(1, 1)                 # frame_mbs_only
    sps.u(0, 1)
    crop = (y.shape[0] - height) // 2
    sps.u(1 if crop else 0, 1)
    if crop:
        for v in (0, 0, 0, crop):
            sps.ue(v)
    sps.u(0, 1)                 # no VUI
    pps = _Bits()
    pps.ue(0)
    pps.ue(0)
    pps.u(0, 1)                 # CAVLC
    pps.u(0, 1)
    for v in (0, 0, 0):
        pps.ue(v)
    pps.u(0, 1)
    pps.u(0, 2)
    for v in (0, 0, 0):
        pps.se(v)               # pic_init_qp 26, qs, chroma offset
    pps.u(1, 1)                 # deblocking control present
    pps.u(0, 1)
    pps.u(0, 1)
    head = _Bits()
    for v in (0, 7, 0):
        head.ue(v)              # first mb, slice type I, pps id
    head.u(0, 4)                # frame_num
    head.ue(0)                  # idr_pic_id
    head.u(0, 2)                # no_output_of_prior_pics, long_term_reference
    head.se(0)                  # slice_qp_delta
    head.ue(1)                  # deblocking off
    head.ue(25)                 # the first macroblock: I_PCM, then its alignment
    mbs = np.concatenate([
        y.reshape(h_mb, 16, w_mb, 16).transpose(0, 2, 1, 3).reshape(-1, 256),
        cb.reshape(h_mb, 8, w_mb, 8).transpose(0, 2, 1, 3).reshape(-1, 64),
        cr.reshape(h_mb, 8, w_mb, 8).transpose(0, 2, 1, 3).reshape(-1, 64)], 1)
    # Every later macroblock: ue(25) = 000011010 and 7 alignment zeros.
    body = np.concatenate([np.tile(np.array([0x0D, 0x00], np.uint8), (len(mbs), 1)), mbs], 1)
    rbsp = head.bytes(stop=False) + body.reshape(-1)[2:].tobytes() + b"\x80"
    return [nal(7, sps.bytes()), nal(8, pps.bytes()), nal(5, rbsp)]


def h264_mp4_bytes(nals: list, width: int, height: int) -> bytes:
    """One key frame in an MP4: avcC with the SPS and PPS, the sample's NALs
    length-prefixed in mdat, a full sample table."""
    sps, pps, *slices = nals
    sample = b"".join(struct.pack(">I", len(n)) + n for n in slices)
    ftyp = bmff_box(b"ftyp", b"isom\x00\x00\x02\x00isomavc1")
    avcc = (b"\x01" + sps[1:4] + b"\xff\xe1" + struct.pack(">H", len(sps)) + sps + b"\x01"
            + struct.pack(">H", len(pps)) + pps)
    tables = (bmff_full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
              + bmff_full(b"stsz", 0, 0, struct.pack(">III", 0, 1, len(sample)))
              + bmff_full(b"stco", 0, 0, struct.pack(">II", 1, len(ftyp) + 8))
              + bmff_full(b"stss", 0, 0, struct.pack(">II", 1, 1)))
    mvhd = bmff_full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, 1000)
                     + struct.pack(">IH", 0x10000, 0x100) + bytes(10) + MATRIX + bytes(24)
                     + struct.pack(">I", 2))
    trak = bmff_trak(b"vide", avc1_entry(width, height, avcc), 1000, 1000, 1, width, height,
                     tables)
    return ftyp + bmff_box(b"mdat", sample) + bmff_box(b"moov", mvhd + trak)


def pdf_bytes(*images: tuple) -> bytes:
    """A PDF of image XObjects: (w, h, colour space, filter, stream,
    extra dictionary entries)."""
    out = b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog >>\nendobj\n"
    for k, (w, h, space, filt, stream, extra) in enumerate(images, 2):
        out += (b"%d 0 obj\n<< /Type /XObject /Subtype /Image /Width %d /Height %d "
                b"/ColorSpace %s /BitsPerComponent 8 /Filter %s %s/Length %d >>\nstream\n"
                % (k, w, h, space, filt, extra, len(stream)) + stream + b"\nendstream\nendobj\n")
    return out + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n"


def png_predicted(rows: np.ndarray) -> bytes:
    """[h, w·c] uint8 rows behind PNG filter bytes, Sub / Up / None in turn."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for k, row in enumerate(rows.astype(np.int64)):
        f = k % 3
        enc = row - (np.concatenate([[0, 0, 0], row[:-3]]) if f == 1 else prev if f == 2 else 0)
        out += bytes([f]) + bytes((enc & 0xFF).astype(np.uint8))
        prev = row
    return bytes(out)


def bt601_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """The thumbnailer's YCbCr 4:2:0 → RGB (media/h264.py yuv420_to_rgb)."""
    h, w = y.shape
    cb = np.repeat(np.repeat(cb, 2, 0), 2, 1)[:h, :w].astype(np.float64) - 128
    cr = np.repeat(np.repeat(cr, 2, 0), 2, 1)[:h, :w].astype(np.float64) - 128
    yy = (y.astype(np.float64) - 16) * (255.0 / 219.0)
    return np.clip(np.stack([yy + 1.596 * cr, yy - 0.392 * cb - 0.813 * cr, yy + 2.017 * cb],
                            -1), 0, 255).astype(np.uint8)


def svg_render_size(text: str) -> tuple:
    """The size the rasterizer renders an SVG at: its viewBox (else width and
    height) scaled to 262 144 px²."""
    box = re.search(r'viewBox="([^"]+)"', text)
    if box:
        vw, vh = (float(v) for v in box.group(1).split()[2:])
    else:
        vw, vh = (float(re.search(rf'{k}="([\d.]+)', text).group(1)) for k in ("width", "height"))
    scale = (262_144.0 / (vw * vh)) ** 0.5
    return max(1, int(round(vw * scale))), max(1, int(round(vh * scale)))


def write_media_slice2(root: Path, seed: int) -> dict:
    """Phase 12's second-slice files under `root`: {rel: plant}, a plant
    {"row": the stream_data fields it must read back, or None; "thumb":
    the (w, h) of the image its thumbnail is made from, or None; "rgb": the
    pixels the thumbnail must show where it is not resized; "planes": the
    H.264 planes the decoder must give}."""
    import gzip

    rng = np.random.default_rng(seed)
    plants = {}

    def put(rel, data, row=None, thumb=None, **extra):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
        plants[rel] = {"row": row, "thumb": thumb, **extra}

    put("audio/voice.wav", wav_bytes(1.5, 8000, 1), {
        "format_name": "wav", "audio_codec": "pcm_s16le", "channels": 1, "sample_rate": 8000,
        "bitrate": 128000, "duration_seconds": 1.5})
    put("audio/album.flac", flac_bytes(44100, 2, 16, 441_000), {
        "format_name": "flac", "audio_codec": "flac", "sample_rate": 44100, "channels": 2,
        "bits_per_sample": 16, "duration_seconds": 10.0})
    put("audio/song.mp3", mp3_bytes(100), {
        "format_name": "mp3", "audio_codec": "mp3", "sample_rate": 44100, "channels": 2,
        "bitrate": 128000, "duration_seconds": round(41700 * 8 / 128000, 3)})
    put("audio/track.ogg", ogg_vorbis_bytes(48000, 2, 96000), {
        "format_name": "ogg", "audio_codec": "vorbis", "channels": 2, "sample_rate": 48000,
        "duration_seconds": 2.0})
    frames = [np.clip(image_scene(rng, 240, 320), 0, 255).astype(np.uint8) for _ in range(10)]
    put("video/clip.avi", avi_mjpeg_bytes([jpeg_bytes(f, 90) for f in frames], 320, 240, 10), {
        "format_name": "avi", "width": 320, "height": 240, "fps": 10.0,
        "duration_seconds": 1.0, "video_codec": "MJPG"}, (320, 240), rgb=frames[1])
    cover = np.clip(image_scene(rng, 300, 300), 0, 255).astype(np.uint8)
    put("video/movie.mp4", mp4_with_cover_bytes(1280, 720, 12, jpeg_bytes(cover, 90)), {
        "format_name": "mp4", "brand": "isom", "duration_seconds": 12.0, "video_codec": "avc1",
        "width": 1280, "height": 720, "fps": 30.0, "audio_codec": "mp4a", "channels": 2,
        "sample_rate": 48000}, (300, 300), rgb=cover)
    art = np.clip(image_scene(rng, 200, 150), 0, 255).astype(np.uint8)
    put("video/film.mkv", mkv_with_attachment_bytes(1920, 800, 95_000.0, jpeg_bytes(art, 90)), {
        "format_name": "matroska", "duration_seconds": 95.0, "video_codec": "V_MPEG4/ISO/AVC",
        "width": 1920, "height": 800, "audio_codec": "A_AAC", "sample_rate": 44100,
        "channels": 2}, (150, 200), rgb=art)
    # The phone video: one 1920 x 1080 I_PCM frame whose planes the decoder
    # must give back exactly.
    w, h = MEDIA_VIDEO_1080
    hc = (h + 15) // 16 * 16
    yy, xx = np.mgrid[0:hc, 0:w]
    y = np.clip(16 + (xx * 219 // w + (yy // 8) % 7 + rng.integers(0, 3, (hc, w))), 0,
                255).astype(np.uint8)
    cy, cx = np.mgrid[0:hc // 2, 0:w // 2]
    cb = ((cx * 255 // (w // 2) + cy) % 256).astype(np.uint8)
    cr = ((cy * 255 // (hc // 2) + 3 * cx) % 256).astype(np.uint8)
    put("video/phone.mp4", h264_mp4_bytes(h264_ipcm_nals(y, cb, cr, h), w, h), {
        "format_name": "mp4", "brand": "isom", "duration_seconds": 1.0, "video_codec": "avc1",
        "width": w, "height": h, "fps": 1.0}, (w, h),
        planes=(y[:h], cb[:h // 2], cr[:h // 2]))
    # The committed H.264 and video fixtures, as the repo holds them.
    for name in ("gradient_ipcm.mp4", "gradient_ipcm.ts", "mixed_cavlc.mp4", "mixed_cavlc.m2ts",
                 "gradient_ipcm.264"):
        truth = np.load(ROOT / "tests" / "fixtures" / "h264" / (name.split(".")[0]
                                                                  + ".truth.npz"))
        size = truth["Y"].shape[::-1]
        is_mp4 = name.endswith(".mp4")
        put(f"fixtures/{name}", (ROOT / "tests" / "fixtures" / "h264" / name).read_bytes(),
            {"width": size[0], "height": size[1]} if is_mp4 else None,
            None if name.endswith(".264") else size,
            rgb=bt601_rgb(truth["Y"], truth["Cb"], truth["Cr"]) if "Cb" in truth else None)
    for path in sorted((ROOT / "tests" / "fixtures" / "video").iterdir()):
        parsed = path.suffix in (".mp4", ".webm")
        put(f"fixtures/{path.name}", path.read_bytes(), {} if parsed else None, None,
            any_thumb=True)
    for name, text in MEDIA_SVG_DOCS.items():
        data = gzip.compress(text.encode()) if name.endswith(".svgz") else text.encode()
        put(f"drawings/{name}", data, None, None if name == "broken.svg" else
            svg_render_size(text))
    page = np.clip(image_scene(rng, 300, 400), 0, 255).astype(np.uint8)
    flat = np.clip(image_scene(rng, 200, 320), 0, 255).astype(np.uint8)
    gray = np.clip(image_scene(rng, 90, 120)[..., 0], 0, 255).astype(np.uint8)
    put("docs/scan.pdf", pdf_bytes((400, 300, b"/DeviceRGB", b"/DCTDecode",
                                    jpeg_bytes(page, 92), b"")), None, (400, 300), rgb=page)
    put("docs/chart.pdf", pdf_bytes(
        (20, 10, b"/DeviceRGB", b"/FlateDecode", zlib.compress(bytes(600)), b""),
        (320, 200, b"/DeviceRGB", b"/FlateDecode", zlib.compress(png_predicted(
            flat.reshape(200, -1))), b"/DecodeParms << /Predictor 15 /Colors 3 /Columns 320 >> ")),
        None, (320, 200), rgb=flat)
    put("docs/gray.pdf", pdf_bytes((120, 90, b"/DeviceGray", b"/FlateDecode",
                                    zlib.compress(gray.tobytes()), b"")), None, (120, 90),
        rgb=np.repeat(gray[..., None], 3, -1))
    put("docs/text.pdf", b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog >>\nendobj\n%%EOF\n")
    return plants


class _MediaOwner:
    """The thumbnailer's owner in the smoke run (the port has no Node yet)."""

    def __init__(self, data_dir: str, libraries):
        self.data_dir = data_dir
        self.events_seen = collections.Counter()
        owner = self

        class _Events:
            def emit(self, event):
                owner.events_seen[(event["type"], event.get("ephemeral"))] += 1

        class _Libraries:
            def list(self):
                return list(libraries)

        self.events, self.libraries = _Events(), _Libraries()


@contextlib.contextmanager
def media_stage_clock(seconds: dict):
    """While open, the thumbnail passes' wall times add up in
    seconds[(format, stage)], the format that of the file the same thread
    last opened (each thumbnail runs on one worker thread from its decode
    to its write): decode (decode_image), thumb_rgb, resize, encode,
    write. A camera JPEG counts as ``jpeg_camera``, a RAW preview as
    ``raw``."""
    import threading

    from spacedrive_tpu_torch import native, persist
    from spacedrive_tpu_torch.media import images, imgdecode, rawpreview, webpenc

    local = threading.local()
    lock = threading.Lock()

    def opener(module, name, fmt_of):
        fn = getattr(module, name)

        def wrapper(path, *args, **kwargs):
            local.fmt = fmt_of(str(path))
            return fn(path, *args, **kwargs)

        return module, name, fn, wrapper

    def timed(module, name, stage):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with lock:
                key = (getattr(local, "fmt", "?"), stage)
                seconds[key] = seconds.get(key, 0.0) + dt
            return out

        return module, name, fn, wrapper

    patches = [opener(images, "format_image",
                      lambda p: "jpeg_camera" if "/camera/" in p else file_format(p)),
               opener(rawpreview, "extract_preview", lambda p: "raw"),
               timed(imgdecode, "decode_image", "decode"),
               timed(imgdecode, "thumb_rgb", "thumb_rgb"),
               timed(native, "resample_image", "resize"),
               timed(webpenc, "encode", "encode"),
               timed(persist, "atomic_write", "write")]
    for module, name, _, wrapper in patches:
        setattr(module, name, wrapper)
    try:
        yield
    finally:
        for module, name, fn, _ in patches:
            setattr(module, name, fn)


def _media_plain_one(path: str) -> bool:
    """Whether the native and the plain passes give `path` one grid."""
    from spacedrive_tpu_torch.media import images, thumbnail

    px, mode = images.format_image(path)
    ppx, pmode = images.format_image(path, native=False)
    return (mode == pmode and np.array_equal(px, ppx) and np.array_equal(
        thumbnail.thumbnail_rgb(px, mode), thumbnail.thumbnail_rgb(ppx, pmode, native=False)))


def _media_encode_one(args) -> tuple:
    """The grid of `src` encoded natively and plainly, and the thumbnail at
    `thumb` decoded natively and plainly: (bytes equal, decodes equal,
    PSNR of the decoded thumbnail against the grid)."""
    src, thumb = args
    from spacedrive_tpu_torch.media import images, imgdecode, thumbnail, webpenc

    grid = thumbnail.thumbnail_rgb(*images.format_image(src))
    data = webpenc.encode(grid)
    same_bytes = data == webpenc.encode(grid, native=False) and data == Path(thumb).read_bytes()
    decoded = imgdecode.decode_image(data)[0]
    same_decode = np.array_equal(decoded, imgdecode.decode_image(data, native=False)[0])
    mse = float(((decoded.astype(np.float64) - grid) ** 2).mean())
    return same_bytes, same_decode, 99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def media_rows(lib, root: Path) -> tuple:
    """The media_data rows by relative path: (EXIF rows, their msgpack
    fields decoded; stream rows, their stream_data JSON decoded)."""
    from spacedrive_tpu_torch import _msgpack

    rows, streams = {}, {}
    for r in lib.db.query("SELECT fp.materialized_path, fp.name, fp.extension, md.* "
                          "FROM media_data md JOIN file_path fp ON fp.object_id = md.object_id"):
        rel = (r["materialized_path"].lstrip("/") + r["name"] + "." + r["extension"])
        if r["stream_data"] is not None:
            streams[rel] = json.loads(r["stream_data"])
            continue
        row = {k: _msgpack.unpackb(r[k]) for k in ("resolution", "media_date", "media_location",
                                                   "camera_data") if r[k] is not None}
        rows[rel] = row
    return rows, streams


@contextlib.contextmanager
def media_route_clock(routes: dict, planes: dict):
    """While open, routes[name] = [calls, seconds] of the second slice's
    routes: each probe by extension (``probe/<ext>``), each video frame
    route (``frame/mjpeg``, ``frame/h264``, ``frame/cover``), the H.264
    decode by frame size (``h264/<w>x<h>``), the SVG render and the PDF
    image stream; planes[path] the planes each H.264 decode gave."""
    import threading

    from spacedrive_tpu_torch.media import h264, mpegts, pdf, processor, svg, video

    lock = threading.Lock()

    def add(name, dt):
        with lock:
            calls = routes.setdefault(name, [0, 0.0])
            calls[0] += 1
            calls[1] += dt

    def timed(module, attr, name_of):
        fn = getattr(module, attr)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            add(name_of(args, out), time.perf_counter() - t0)
            return out

        return module, attr, fn, wrapper

    def decoded(args, out):
        if out is None:
            return "h264/none"
        with lock:
            planes[str(args[0])] = out
        return f"h264/{out[0].shape[1]}x{out[0].shape[0]}"

    patches = [timed(processor, "probe_media",
                     lambda a, o: "probe/" + str(a[0]).rsplit(".", 1)[1].lower()),
               timed(video, "_mjpeg_thumbnail", lambda a, o: "frame/mjpeg"),
               timed(video, "_h264_thumbnail", lambda a, o: "frame/h264"),
               timed(video, "_cover_art_thumbnail", lambda a, o: "frame/cover"),
               timed(h264, "keyframe_from_mp4", decoded),
               timed(mpegts, "keyframe_from_ts", decoded),
               timed(svg, "render_svg", lambda a, o: "svg"),
               timed(pdf, "pdf_first_image", lambda a, o: "pdf")]
    for module, attr, _, wrapper in patches:
        setattr(module, attr, wrapper)
    try:
        yield
    finally:
        for module, attr, fn, _ in patches:
            setattr(module, attr, fn)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def check_slice2_thumbnail(rel: str, plant: dict, path: str, planes: dict,
                           check_planes: bool) -> None:
    """One second-slice thumbnail against its plant: its size, the H.264
    planes the decoder gave (where `check_planes`), its PSNR against the
    planted pixels where it was not resized (against the plain grid of the
    planted planes for the frame), the flag's colours."""
    from spacedrive_tpu_torch.media import imgdecode
    from spacedrive_tpu_torch.media.thumbnail import scale_dimensions, thumbnail_rgb

    require(os.path.exists(path), f"phase 12: no thumbnail of {rel}")
    shown = imgdecode.decode_image(Path(path).read_bytes())[0]
    size = scale_dimensions(*plant["thumb"])
    require(tuple(shown.shape[1::-1]) == size,
            f"phase 12: {rel} thumbnail {shown.shape[1::-1]} != {size}")
    want_rgb = None
    if "planes" in plant:
        if check_planes:
            got = planes.get(rel)
            require(got is not None and all(np.array_equal(g, w)
                                            for g, w in zip(got, plant["planes"])),
                    f"phase 12: {rel} decoded planes != the planted planes")
        want_rgb = thumbnail_rgb(bt601_rgb(*plant["planes"]), "RGB", native=False)
    elif plant.get("rgb") is not None and size == plant["thumb"]:
        want_rgb = plant["rgb"]
    if want_rgb is not None:
        db = psnr_db(shown, want_rgb)
        require(db >= MEDIA_PSNR_FLOOR, f"phase 12: {rel} thumbnail at {db:.2f} dB")
    if rel.endswith("flag.svg"):
        w = shown.shape[1]
        left = shown[:, : w // 6].reshape(-1, 3).mean(0)
        right = shown[:, -w // 6:].reshape(-1, 3).mean(0)
        require(np.abs(left - (255, 0, 0)).max() < 40 and np.abs(right - (0, 0, 255)).max() < 40,
                f"phase 12: the flag's thirds read {left.round()} and {right.round()}")


def check_media_slice2(plants: dict, streams: dict, data_dir: str, by_path: dict,
                       strict: bool) -> int:
    """Every second-slice row and thumbnail of the scan against its plant;
    returns the thumbnails checked. `strict`: neither ffmpeg nor OpenCV on
    this host, so every route is the self-hosted one and the rows and the
    thumbnail set are known exactly; else OpenCV (or ffprobe) may probe and
    decode more than the plants name."""
    from spacedrive_tpu_torch.media.thumbnail import thumbnail_path

    thumbs = 0
    for rel, plant in plants.items():
        got, want = streams.get(rel), plant["row"]
        if want is None:
            require(got is None or not strict, f"phase 12: a stream row for {rel}: {got}")
        elif rel.startswith("fixtures/"):
            require(got is not None and all(got.get(k) == v for k, v in want.items()),
                    f"phase 12: {rel} stream row {got} lacks {want}")
        else:
            require(got == want or (not strict and got is not None),
                    f"phase 12: {rel} stream row {got} != {want}")
        path = thumbnail_path(data_dir, by_path[rel])
        if plant["thumb"] is None:
            require(not os.path.exists(path) or (plant.get("any_thumb") and not strict),
                    f"phase 12: a thumbnail of {rel}")
            thumbs += os.path.exists(path)
            continue
        thumbs += 1
        check_slice2_thumbnail(rel, plant, path, {}, check_planes=False)
    return thumbs


def self_hosted_frames(plants: dict, root: Path, out_dir: Path, routes: dict) -> float:
    """The video plants again through ``video.generate_video_thumbnail`` with
    the ffmpeg and OpenCV gates closed, as the chain runs on a host without
    them (the JAX package's too): MJPEG, H.264 from MP4 and TS, cover art,
    every frame and its planes against the plant. Returns its wall s."""
    from spacedrive_tpu_torch.media import video

    planes: dict = {}
    gates = video.available, video.cv2_available
    video.available = video.cv2_available = lambda: False
    t0 = time.perf_counter()
    try:
        with media_route_clock(routes, planes):
            for rel, plant in plants.items():
                if rel.rsplit(".", 1)[1] not in video.VIDEO_EXTENSIONS:
                    continue
                out = str(out_dir / (rel.replace("/", "_") + ".webp"))
                got = video.generate_video_thumbnail(str(root / rel), out)
                if plant["thumb"] is None:
                    require(got is None, f"phase 12: a self-hosted frame of {rel}")
                    continue
                check_slice2_thumbnail(rel, plant, out, {
                    k[len(str(root)) + 1:]: v for k, v in planes.items()}, check_planes=True)
    finally:
        video.available, video.cv2_available = gates
    return time.perf_counter() - t0


def run_media_scan(lib, location_id: int, data_dir: str, owner, counts: dict, key: str):
    """scan_location(backend="cuda"), the media job chained by its default,
    with the thumbnailer running; the launch counts reset just before and
    read just after."""
    import asyncio

    from spacedrive_tpu_torch.jobs.manager import JobManager
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.media.actor import Thumbnailer
    from spacedrive_tpu_torch.ops import blake3_cuda, hamming_cuda

    async def main():
        actor = Thumbnailer(owner)
        actor.start()
        jobs = JobManager(services={"data_dir": data_dir, "thumbnailer": actor})
        await locations.scan_location(jobs, lib, location_id, backend="cuda")
        await jobs.wait_idle()
        await actor.stop()

    torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    hamming_cuda.reset_launches()
    t0 = time.perf_counter()
    asyncio.run(main())
    wall = time.perf_counter() - t0
    counts[key] = {**blake3_cuda.launches, **hamming_cuda.launches}
    return wall


def phase_media(counts: dict) -> dict:
    """Phase 12: the media plane on the card, images and the second slice's
    audio, video, SVG and PDF in one location."""
    import asyncio

    from spacedrive_tpu_torch.jobs.report import JobStatus
    from spacedrive_tpu_torch.library import Libraries
    from spacedrive_tpu_torch.locations import manager as locations
    from spacedrive_tpu_torch.locations.non_indexed import (queue_ephemeral_thumbnails,
                                                            walk_ephemeral)
    from spacedrive_tpu_torch.media import imgdecode
    from spacedrive_tpu_torch.media.actor import Thumbnailer
    from spacedrive_tpu_torch.media import video
    from spacedrive_tpu_torch.media.images import GENERIC_EXTENSIONS
    from spacedrive_tpu_torch.media.rawpreview import RAW_TIFF_EXTENSIONS
    from spacedrive_tpu_torch.media.thumbnail import scale_dimensions, thumbnail_path
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.ops.cas import MINIMUM_FILE_SIZE

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-media-") as tmp, \
            corpus_executor() as executor:
        workdir = Path(tmp)
        root, data_dir = workdir / "photos", str(workdir / "data")
        t0 = time.perf_counter()
        made = write_media_corpus(root, 61, executor)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plants = write_media_slice2(root, 62)
        slice2_write_s = time.perf_counter() - t0
        slice2_bytes = sum((root / rel).stat().st_size for rel in plants)
        strict = not (video.available() or video.cv2_available())
        files = made["files"]
        lib = Libraries(data_dir).create("chip-smoke-media")
        owner = _MediaOwner(data_dir, [lib])
        try:
            location_id = locations.create_location(lib, str(root))
            stage_s: dict = {}
            routes: dict = {}
            with media_stage_clock(stage_s), media_route_clock(routes, {}):
                wall = run_media_scan(lib, location_id, data_dir, owner, counts, "media_scan")
            reports = {r.name: r for r in job_reports(lib)}
            ident, media = reports["file_identifier"], reports["media_processor"]
            # K1: one launch a size class of each identifier page.
            sizes = [int.from_bytes(r["size_in_bytes_bytes"], "big") for r in lib.db.query(
                "SELECT size_in_bytes_bytes FROM file_path WHERE is_dir = 0 ORDER BY id")]
            step = ident.metadata["chunk_size"]
            pages = sum(any(s > MINIMUM_FILE_SIZE for s in p) + any(0 < s <= MINIMUM_FILE_SIZE
                                                                     for s in p)
                        for p in (sizes[k:k + step] for k in range(0, len(sizes), step)))
            k1 = counts["media_scan"][blake3_cuda.FAST]
            require(k1 == pages, f"phase 12: K1 launched {k1} times for {pages} page classes")
            require(media.status == JobStatus.COMPLETED and not media.errors_text,
                    f"phase 12: media job ended {media.status.name}: {media.errors_text[:4]}")
            # Every row reads back what its writer planted.
            rows, streams = media_rows(lib, root)
            want_rows = {rel: f[0] for rel, f in files.items() if f[0] is not None}
            require(set(rows) == set(want_rows),
                    f"phase 12: rows for {sorted(set(rows) ^ set(want_rows))[:4]}")
            for rel, want in want_rows.items():
                got = rows.get(rel, {})
                for key, value in want.items():
                    if key == "resolution":
                        value = {"width": value[0], "height": value[1]}
                    require(got.get(key) == value, f"phase 12: {rel} {key} {got.get(key)} != "
                                                   f"{value}")
            # Every thumbnail at its keyed path, at scale_dimensions' size.
            by_path = {r["materialized_path"].lstrip("/") + r["name"] + "." + r["extension"]:
                       r["cas_id"] for r in lib.db.query(
                           "SELECT materialized_path, name, extension, cas_id FROM file_path "
                           "WHERE is_dir = 0")}
            thumbs = 0
            for rel, (_, size, kind) in files.items():
                path = thumbnail_path(data_dir, by_path[rel])
                ext = rel.rsplit(".", 1)[1]
                if size is None and ext not in RAW_TIFF_EXTENSIONS:
                    size = imgdecode.decode_image((root / rel).read_bytes())[0].shape[1::-1]
                if size is None:  # a RAW without a JPEG preview
                    require(not os.path.exists(path), f"phase 12: a thumbnail of {rel}")
                    continue
                require(os.path.exists(path), f"phase 12: no thumbnail of {rel}")
                got = imgdecode.decode_image(Path(path).read_bytes())[0].shape[1::-1]
                require(tuple(got) == scale_dimensions(*size),
                        f"phase 12: {rel} thumbnail {got} != {scale_dimensions(*size)}")
                thumbs += 1
            image_thumbs = thumbs
            thumbs += check_media_slice2(plants, streams, data_dir, by_path, strict)
            require(thumbs == media.metadata["thumbnails_generated"],
                    f"phase 12: {thumbs} thumbnails checked, the job made "
                    f"{media.metadata['thumbnails_generated']}")
            # Native passes against plain, the encoder's bytes, the decode.
            rng = np.random.default_rng(12)
            small = sorted(rel for rel, f in files.items()
                           if f[2] != "jpeg_camera" and
                           rel.rsplit(".", 1)[1] in GENERIC_EXTENSIONS)
            sample = sorted(rng.choice(small, MEDIA_PLAIN_SAMPLE, replace=False).tolist())
            t0 = time.perf_counter()
            same_grid = list(executor.map(_media_plain_one, [str(root / p) for p in sample]))
            enc = sorted(rng.choice(small, MEDIA_PLAIN_ENCODES, replace=False).tolist()) + \
                [sorted(r for r in files if files[r][2] == "jpeg_camera")[0]]
            checked = list(executor.map(_media_encode_one, [
                (str(root / p), thumbnail_path(data_dir, by_path[p])) for p in enc]))
            plain_s = time.perf_counter() - t0
            require(all(same_grid), f"phase 12: native grids != plain on "
                                    f"{[p for p, ok in zip(sample, same_grid) if not ok][:3]}")
            require(all(c[0] for c in checked), "phase 12: encoder native bytes != plain")
            require(all(c[1] for c in checked), "phase 12: thumbnail decode native != plain")
            psnr = [c[2] for c in checked]
            require(min(psnr) >= MEDIA_PSNR_FLOOR,
                    f"phase 12: thumbnail PSNR {min(psnr):.2f} dB under {MEDIA_PSNR_FLOOR}")
            self_routes: dict = {}
            self_hosted_s = self_hosted_frames(plants, root, workdir / "self_hosted", self_routes)
            # A second scan writes nothing new.
            n_rows, n_streams = len(rows), len(streams)
            stamps = {p: os.stat(p).st_mtime_ns for p in Path(data_dir, "thumbnails").rglob(
                "*.webp")}
            rescan_wall = run_media_scan(lib, location_id, data_dir, owner, counts,
                                         "media_rescan")
            again = media_rows(lib, root)
            require((len(again[0]), len(again[1])) == (n_rows, n_streams),
                    "phase 12: the rescan wrote rows")
            require({p: os.stat(p).st_mtime_ns for p in Path(data_dir, "thumbnails").rglob(
                "*.webp")} == stamps, "phase 12: the rescan rewrote thumbnails")
            # The ephemeral browse: K1 keys, the actor's ephemeral queue.
            browse = workdir / "browse"
            browse.mkdir()
            for k in range(MEDIA_BROWSE):
                px = np.clip(image_scene(np.random.default_rng(k), 120 + k, 160), 0, 255)
                data, ext = encode_image(np.random.default_rng(k), px.astype(np.uint8),
                                         ("png_rgb", "jpeg420")[k % 2])
                (browse / f"b{k:03d}.{ext}").write_bytes(data)

            async def browse_main():
                actor = Thumbnailer(owner)
                actor.start()
                entries = walk_ephemeral(str(browse), compute_cas_ids=True, device="cuda")
                batch = await queue_ephemeral_thumbnails(actor, entries)
                await batch.done.wait()
                await actor.stop()
                return entries, batch

            blake3_cuda.reset_launches()
            t0 = time.perf_counter()
            entries, batch = asyncio.run(browse_main())
            browse_s = time.perf_counter() - t0
            counts["media_browse"] = dict(blake3_cuda.launches)
            require(batch.generated == MEDIA_BROWSE and all(
                os.path.exists(thumbnail_path(data_dir, e["cas_id"])) for e in entries),
                f"phase 12: the browse made {batch.generated} of {MEDIA_BROWSE} thumbnails")
        finally:
            lib.db.close()
    n_images = len(files)
    by_format = collections.defaultdict(dict)
    n_by_format = collections.Counter()
    for rel, f in files.items():
        if os.path.splitext(rel)[1]:
            n_by_format[file_format(rel) if f[2] != "jpeg_camera" else "jpeg_camera"] += 1
    for (fmt, stage), s in sorted(stage_s.items()):
        by_format[fmt][stage] = s
    phase_wall = time.perf_counter() - t_all
    out = dict(wall_s=phase_wall, corpus_write_s=corpus_s, corpus_bytes=made["bytes"],
               images=n_images, files=len(files), job_wall_s=wall,
               images_per_s=n_images / wall, rows=len(rows), thumbnails=image_thumbs,
               slice2=dict(files=len(plants), bytes=slice2_bytes, write_s=slice2_write_s,
                           stream_rows=len(streams), thumbnails=thumbs - image_thumbs,
                           chain="self_hosted" if strict else "opencv_or_ffmpeg",
                           ms_per_call={k: 1e3 * s / n for k, (n, s) in sorted(routes.items())},
                           calls={k: n for k, (n, _) in sorted(routes.items())},
                           self_hosted=dict(wall_s=self_hosted_s, ms_per_call={
                               k: 1e3 * s / n for k, (n, s) in sorted(self_routes.items())},
                               calls={k: n for k, (n, _) in sorted(self_routes.items())})),
               media_phase_s=media.metadata, identifier_s=ident.date_completed - ident.date_started,
               stage_s_by_format={k: dict(v) for k, v in by_format.items()},
               stage_ms_per_image={stage: 1e3 * sum(s for (f, st), s in stage_s.items()
                                                    if st == stage) / max(thumbs, 1)
                                   for stage in ("decode", "thumb_rgb", "resize", "encode",
                                                 "write")},
               images_by_format=dict(n_by_format), rescan_wall_s=rescan_wall,
               browse_s=browse_s, plain_checks_s=plain_s, psnr_db_min=min(psnr),
               psnr_db_mean=float(np.mean(psnr)), events=dict(
                   (f"{t}{'/ephemeral' if e else ''}", n)
                   for (t, e), n in owner.events_seen.items()),
               launches={k: counts[k] for k in ("media_scan", "media_rescan", "media_browse")})
    emit("media", **out)
    require(phase_wall <= MEDIA_BUDGET_S,
            f"phase 12 took {phase_wall:.1f} s, past its {MEDIA_BUDGET_S} s")
    return out


SYNC_DIR = "scan-050"         # the phase 7 directory the live part changes
SYNC_NEW, SYNC_EDITED, SYNC_REMOVED = 200, 50, 50
SYNC_CLONE_DEADLINE_S = 300.0
SYNC_CONVERGE_DEADLINE_S = 30.0
SYNC_AEAD_BYTES = 16 << 20


def synced_rows(db, table: str) -> list:
    """`table`'s rows as the sync plane carries them, sorted: every column
    but the local row id, its owner and a file's inode (local to the
    disk it was indexed on: creates do not carry it), an FK to a shared
    model as the referenced row's pub_id."""
    from spacedrive_tpu_torch.store import models as M

    model = M.MODELS[table]
    cols, joins = [], []
    for f in model.fields:
        if f.name in ("id", "instance_id", "inode"):
            continue
        target = f.references.split("(", 1)[0] if f.references else None
        if target is not None and M.MODELS[target].sync == M.SyncMode.SHARED:
            alias = f"j{len(joins)}"
            joins.append(f"LEFT JOIN {target} {alias} ON {alias}.id = t.{f.name}")
            cols.append(f"{alias}.pub_id")
        else:
            cols.append(f"t.{f.name}")
    rows = db.query(
        f"SELECT {', '.join(cols)} FROM {table} t {' '.join(joins)} ORDER BY t.pub_id")
    return [tuple(r) for r in rows]


def first_difference(ra: list, rb: list):
    """The first row pair (and column names' positions) that differ."""
    for x, y in zip(ra, rb):
        if x != y:
            return [(i, a, b) for i, (a, b) in enumerate(zip(x, y)) if a != b][:4]
    return None


def op_log_count(db) -> int:
    return (db.query_one("SELECT COUNT(*) AS n FROM shared_operation")["n"]
            + db.query_one("SELECT COUNT(*) AS n FROM relation_operation")["n"]
            + db.query_one("SELECT COALESCE(SUM(n_ops), 0) AS n FROM shared_op_blob")["n"])


def sync_live_changes(root: Path) -> dict:
    """SYNC_NEW new files, SYNC_EDITED rewritten in place, SYNC_REMOVED
    removed, all in one directory; the new ones are written first (a new
    file must not take a removed one's inode)."""
    d = root / SYNC_DIR
    old = sorted(p for p in d.iterdir() if p.is_file())
    new = [d / f"synced{i:04d}" for i in range(SYNC_NEW)]
    for i, p in enumerate(new):
        p.write_bytes(f"synced file {i:08d} ".encode() * 64)
    edited = old[:SYNC_EDITED]
    for i, p in enumerate(edited):
        with open(p, "r+b") as f:
            f.write(f"edited {i:08d}".encode())
        os.utime(p, None)
    removed = old[SYNC_EDITED:SYNC_EDITED + SYNC_REMOVED]
    for p in removed:
        p.unlink()
    return dict(new=len(new), edited=len(edited), removed=len(removed))


def phase_sync(workdir: Path, data_dir: str, sums: dict, counts: dict,
               device: str = "cuda") -> dict:
    """Phase 13: phase 7's library cloned over the encrypted tunnel to a
    second node, kept current through a light rescan, and a spacedrop."""
    import asyncio
    import socket
    import statistics

    from spacedrive_tpu_torch.locations import shallow
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import validator
    from spacedrive_tpu_torch.ops import blake3_cuda
    from spacedrive_tpu_torch.p2p import _crypto, proto
    from spacedrive_tpu_torch.p2p.identity import Identity
    from spacedrive_tpu_torch.sync import clone_serve

    key, nonce = bytes(range(32)), bytes(12)
    blob = np.random.default_rng(13).integers(0, 256, SYNC_AEAD_BYTES, np.uint8).tobytes()
    _crypto.seal(key, nonce, blob[:4096])  # builds the library
    t0 = time.perf_counter()
    for _ in range(4):
        sealed = _crypto.seal(key, nonce, blob)
    aead_mb_s = 4 * len(blob) / (time.perf_counter() - t0) / 1e6
    require(_crypto.open_(key, nonce, sealed) == blob, "AEAD round trip")
    plain_head = _crypto.seal_plain(key, nonce, blob[:65536])
    require(_crypto.seal(key, nonce, blob[:65536]) == plain_head, "AEAD native != plain")

    async def handshake_ms() -> float:
        ida, idb = Identity(), Identity()
        times = []
        for _ in range(8):
            s1, s2 = socket.socketpair()
            r1, w1 = await asyncio.open_connection(sock=s1)
            r2, w2 = await asyncio.open_connection(sock=s2)
            t = time.perf_counter()
            ta, tb = await asyncio.gather(proto.tunnel_handshake(r1, w1, ida, True),
                                          proto.tunnel_handshake(r2, w2, idb, False))
            times.append((time.perf_counter() - t) * 1e3)
            require(ta.remote == idb.to_remote_identity() and tb.remote == ida.to_remote_identity(),
                    "handshake identities")
            ta.close()
            tb.close()
        return statistics.median(times)

    big = str(workdir / "validate" / "big")
    root = workdir / "identify"

    async def main(b_dir: str):
        out = {"handshake_ms": await handshake_ms()}
        a, b = Node(data_dir, device=device), Node(b_dir, device=device)
        try:
            await a.start()
            await b.start()
            await a.start_p2p(host="127.0.0.1", enable_discovery=False)
            pb = await b.start_p2p(host="127.0.0.1", enable_discovery=False)
            [lib_a] = a.libraries.list()
            [loc] = lib_a.db.query("SELECT id FROM location WHERE path = ?", (str(root),))
            a_ops = op_log_count(lib_a.db)
            out["ping_ms"] = await a.p2p.ping("127.0.0.1", pb) * 1e3

            # Pair, then the clone through the pass-through.
            pages0, sent0 = clone_serve.pages_relayed[0], proto.stats["bytes_sent"]
            b.p2p.on_pairing_request = lambda peer, info: True
            t_pair = time.perf_counter()
            require(await a.p2p.pair("127.0.0.1", pb, lib_a), "pairing refused")
            [lib_b] = b.libraries.list()
            require(lib_b.id == lib_a.id, "B's library has another id")
            deadline = time.monotonic() + SYNC_CLONE_DEADLINE_S
            while op_log_count(lib_b.db) < a_ops:  # a count: poll it sparingly
                require(time.monotonic() < deadline,
                        f"the clone did not finish within {SYNC_CLONE_DEADLINE_S} s "
                        f"({op_log_count(lib_b.db)} of {a_ops} ops)")
                await asyncio.sleep(0.25)
            clone_s = time.perf_counter() - t_pair
            out.update(clone_s=clone_s, clone_ops=a_ops, clone_ops_per_s=a_ops / clone_s,
                       pages_relayed=clone_serve.pages_relayed[0] - pages0,
                       bytes_sealed=proto.stats["bytes_sent"] - sent0)
            require(out["pages_relayed"] > 0, "the clone relayed no blob page")
            t0 = time.perf_counter()
            for table in ("file_path", "object", "location"):
                ra = await asyncio.to_thread(synced_rows, lib_a.db, table)
                rb = await asyncio.to_thread(synced_rows, lib_b.db, table)
                require(ra == rb, f"B's {table} != A's ({len(rb)} rows against {len(ra)}; "
                                  f"first differing: {first_difference(ra, rb)})")
                out[f"{table}_rows"] = len(ra)
            inst = [sorted(r["pub_id"] for r in db.query("SELECT pub_id FROM instance"))
                    for db in (lib_a.db, lib_b.db)]
            require(inst[0] == inst[1], "instance rows differ")
            require(op_log_count(lib_b.db) == a_ops, "B's op log != A's")
            out["compare_s"] = time.perf_counter() - t0

            # The live part: one directory changed, a light rescan on A.
            out["changes"] = sync_live_changes(root)
            t0 = time.perf_counter()
            res = await asyncio.to_thread(shallow.light_scan_location, lib_a, loc["id"],
                                          SYNC_DIR, a.backend)
            out["rescan_s"] = time.perf_counter() - t0
            require(not res["errors"], f"rescan errors {res['errors'][:3]}")
            out["rescan"] = {k: v for k, v in res.items() if k != "errors"}
            # B has converged when its op log holds A's (an op and its rows
            # commit together); then every table must match.
            t0 = time.perf_counter()
            deadline = time.monotonic() + SYNC_CONVERGE_DEADLINE_S
            while op_log_count(lib_b.db) != op_log_count(lib_a.db):
                require(time.monotonic() < deadline,
                        f"B did not converge within {SYNC_CONVERGE_DEADLINE_S} s")
                await asyncio.sleep(0.05)
            out["converge_s"] = time.perf_counter() - t0
            for table in ("file_path", "object", "location"):
                ra = await asyncio.to_thread(synced_rows, lib_a.db, table)
                rb = await asyncio.to_thread(synced_rows, lib_b.db, table)
                require(ra == rb, f"B's {table} != A's after the rescan "
                                  f"(first differing: {first_difference(ra, rb)})")

            # Spacedrop: phase 5's 64 MiB + 12345 B file, checksummed on B.
            drop = os.path.join(b_dir, "drop-big")
            b.p2p.on_spacedrop = lambda peer, req: drop
            t0 = time.perf_counter()
            require(await a.p2p.spacedrop("127.0.0.1", pb, big) == "sent", "spacedrop refused")
            drop_s = time.perf_counter() - t0
            got, errors = await asyncio.to_thread(validator.checksums_for_files, [drop], device)
            require(not errors and got[0] == sums[big],
                    "the spacedropped file's checksum on B != A's")
            out.update(spacedrop_bytes=os.path.getsize(drop), spacedrop_s=drop_s,
                       spacedrop_mb_s=os.path.getsize(drop) / drop_s / 1e6)
            out["launches"] = dict(blake3_cuda.launches)
        finally:
            await a.shutdown()
            await b.shutdown()
        return out

    if device == "cuda":
        torch.cuda.synchronize()
    blake3_cuda.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sync-") as b_dir:
        t0 = time.perf_counter()
        out = asyncio.run(main(b_dir))
        out["wall_s"] = time.perf_counter() - t0
    out["aead_mb_s"] = aead_mb_s
    counts["sync"] = out["launches"]
    if device == "cuda":
        require(out["launches"][blake3_cuda.FAST] > 0, "the rescan launched no K1")
        require(out["launches"][blake3_cuda.WINDOWED] > 0
                and out["launches"][blake3_cuda.FOLD] > 0,
                "B's checksum launched no K2 or fold")
    emit("sync", **out)
    return out


# -- phase 14: the node's API -----------------------------------------------

API_FILES = 2000              # files of the second location, about
API_IMAGES = 200              # PNGs among them, API_PAIRS near-dup pairs included
API_PAIRS = 40
API_DUP_GROUPS = 30           # exact-duplicate groups of 2-4 byte-equal files
API_BIG = (9 << 20) + 4321    # two files past the validator's 4 MiB cap: K2 and the fold
API_RTT_CALLS = 200           # search.paths windows of 100, over HTTP and over WebSocket


class WsClient:
    """The harness's own RFC 6455 client over a plain socket: masked
    frames out, one reader thread in. ``call`` sends a query or mutation
    and waits for its response; event frames are counted by subscription
    id; ``widths`` records each received frame's length encoding (7, 16 or
    64 bits)."""

    def __init__(self, host: str, port: int):
        import base64
        import socket
        import threading

        self.sock = socket.create_connection((host, port), timeout=60)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /rspc HTTP/1.1\r\nHost: {host}:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n")
                          .encode())
        head = b""
        while b"\r\n\r\n" not in head:
            byte = self.sock.recv(1)
            require(byte, "the server closed the WebSocket handshake")
            head += byte
        require(head.startswith(b"HTTP/1.1 101"), f"handshake refused: {head[:80]!r}")
        self.next_id = 1000
        self.responses: dict = {}
        self.events = collections.Counter()
        self.widths = collections.Counter()
        self.cond = threading.Condition()
        self.closed = False
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(min(n - len(buf), 1 << 20))
            if not chunk:
                raise EOFError("WebSocket closed")
            buf += chunk
        return bytes(buf)

    def _read(self) -> None:
        try:
            while True:
                b0, b1 = self._exact(2)
                n, width = b1 & 0x7F, 7
                if n == 126:
                    n, width = struct.unpack(">H", self._exact(2))[0], 16
                elif n == 127:
                    n, width = struct.unpack(">Q", self._exact(8))[0], 64
                payload = self._exact(n)
                if b0 & 0x0F == 0x8:
                    break
                frame = json.loads(payload)
                with self.cond:
                    self.widths[width] += 1
                    if frame.get("type") == "event":
                        self.events[frame["id"]] += 1
                    else:
                        self.responses[frame["id"]] = (frame, width)
                    self.cond.notify_all()
        except (EOFError, OSError, ValueError):
            pass
        finally:
            with self.cond:
                self.closed = True
                self.cond.notify_all()

    def send(self, frame: dict) -> None:
        payload = json.dumps(frame).encode()
        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126 else
                                bytes([0x80 | 126]) + struct.pack(">H", n) if n < 1 << 16 else
                                bytes([0x80 | 127]) + struct.pack(">Q", n))
        key = (mask * (n // 4 + 1))[:n]
        body = (int.from_bytes(payload, "little") ^ int.from_bytes(key, "little")) \
            .to_bytes(n, "little") if n else b""
        self.sock.sendall(head + mask + body)

    def call(self, path: str, input=None, kind: str = "query", timeout: float = 600.0,
             tp: Optional[str] = None):
        """(result, width of the response frame); raises on an error frame.
        `tp` rides the envelope: the caller's trace, which the server's
        rpc span continues."""
        self.next_id += 1
        mid = self.next_id
        frame = {"id": mid, "type": kind, "path": path, "input": input}
        if tp is not None:
            frame["tp"] = tp
        self.send(frame)
        deadline = time.monotonic() + timeout
        with self.cond:
            while mid not in self.responses:
                require(not self.closed, f"WebSocket closed waiting for {path}")
                left = deadline - time.monotonic()
                require(left > 0, f"no WebSocket response to {path} in {timeout} s")
                self.cond.wait(left)
            frame, width = self.responses.pop(mid)
        require(frame["type"] == "response", f"{path}: {frame}")
        return frame["result"], width

    def subscribe(self, path: str, mid: int) -> None:
        self.send({"id": mid, "type": "subscription", "path": path})
        with self.cond:
            while mid not in self.responses:
                require(not self.closed, "WebSocket closed while subscribing")
                self.cond.wait(60)
            frame, _ = self.responses.pop(mid)
        require(frame["type"] == "response", f"subscription refused: {frame}")

    def close(self) -> None:
        try:
            self.sock.sendall(bytes([0x88, 0x82]) + bytes(4) + struct.pack(">H", 1000))
        except OSError:
            pass
        self.reader.join(10)
        self.sock.close()


class HttpClient:
    """One keep-alive ``http.client`` connection to the rspc routes."""

    def __init__(self, host: str, port: int):
        import http.client

        self.conn = http.client.HTTPConnection(host, port, timeout=600)

    def rpc(self, path: str, input=None, post: bool = True):
        if post:
            self.conn.request("POST", f"/rspc/{path}", body=json.dumps(input),
                              headers={"Content-Type": "application/json"})
        else:
            from urllib.parse import quote

            self.conn.request("GET", f"/rspc/{path}?input={quote(json.dumps(input))}")
        resp = self.conn.getresponse()
        body = json.loads(resp.read())
        require(resp.status == 200 and "result" in body, f"{path}: {resp.status} {body}")
        return body["result"]

    def get(self, url: str, headers: Optional[dict] = None):
        self.conn.request("GET", url, headers=headers or {})
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()

    def post_raw(self, url: str, input):
        """(status, headers, body) of a POST, whatever its status."""
        self.conn.request("POST", url, body=json.dumps(input),
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()


def api_scene(rng, side: int) -> np.ndarray:
    """A blocky RGB scene: 8 x 8 random colour blocks scaled to `side`."""
    return np.kron(rng.integers(20, 236, (8, 8, 3)), np.ones((side // 8, side // 8, 1)))


def write_api_location(root: Path, seed: int = 14) -> dict:
    """The second location: API_IMAGES PNGs (API_PAIRS scenes, each beside
    a copy with noise of ±3, and singles), API_DUP_GROUPS groups of
    byte-equal files, two API_BIG files, and small files of their own bytes
    up to about API_FILES. Returns {"pairs": {(a, b)}, "dup_groups":
    [sorted paths], "big": [paths], "images": [paths], "files": n}, paths
    relative to `root` with a leading "/"."""
    rng = np.random.default_rng(seed)
    out = {"pairs": set(), "dup_groups": [], "big": [], "images": []}
    files = 0

    def write(rel: str, data: bytes) -> None:
        nonlocal files
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        files += 1

    def png(rel: str, pixels: np.ndarray) -> None:
        h, w, _ = pixels.shape
        rows = np.clip(pixels, 0, 255).astype(np.uint8).reshape(h, w * 3)
        write(rel, png_bytes(rows, w, 2, 8, np.arange(h) % 5))
        out["images"].append("/" + rel)

    for k in range(API_PAIRS):
        scene = api_scene(rng, 64)
        a, b = f"photos/p{k // 20}/pair{k:03d}.png", f"photos/p{k // 20}/pair{k:03d}-edit.png"
        png(a, scene)
        png(b, scene + rng.integers(-3, 4, scene.shape))
        out["pairs"].add(("/" + a, "/" + b))
    for k in range(API_IMAGES - 2 * API_PAIRS):
        png(f"photos/s{k // 50}/single{k:03d}.png", api_scene(rng, 8 * int(rng.integers(4, 9))))
    for g in range(API_DUP_GROUPS):
        data = rng.integers(0, 256, int(rng.integers(500, 40_000)), np.uint8).tobytes()
        group = [f"docs/dups/g{g:02d}-{c}.bin" for c in range(2 + g % 3)]
        for rel in group:
            write(rel, data)
        out["dup_groups"].append(sorted("/" + r for r in group))
    for k in range(2):
        rel = f"big/stream{k}.bin"
        write(rel, rng.integers(0, 256, API_BIG, np.uint8).tobytes())
        out["big"].append("/" + rel)
    k = 0
    while files < API_FILES:
        write(f"docs/d{k // 100:02d}/note{k:04d}.txt",
              f"note {k}\n".encode() + rng.integers(0, 256, int(rng.integers(1, 8000)),
                                                    np.uint8).tobytes())
        k += 1
    out["files"] = files
    return out


def api_disk_paths(root: Path) -> set:
    """Every regular file and directory under `root`, as the indexer names
    them (``/dir/name.ext``)."""
    paths = set()
    for dirpath, dirs, names in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        base = "/" if rel == "." else f"/{rel}/"
        paths.update(base + n for n in dirs + names)
    return paths


def api_row_paths(rows) -> set:
    return {f"{r['materialized_path']}{r['name']}" +
            (f".{r['extension']}" if r["extension"] and not r["is_dir"] else "")
            for r in rows}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def phase_api(workdir: Path, data_dir: str, counts: dict, device: str = "cuda") -> dict:
    """Phase 14: the node's front door. An ``ApiServer`` over
    ``Node(data_dir, device)`` (phase 7's library) on 127.0.0.1:0, driven
    only through ``/rspc`` by the harness's http.client and WebSocket
    clients: a second location scanned, validated and searched for
    near-duplicates on the card, file ops, thumbnails, Range fetches and
    search latency over the 100 000-file location."""
    import asyncio
    import statistics
    import threading

    from spacedrive_tpu_torch.api.server import ApiServer
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.ops import blake3_cuda, hamming_cuda

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout: float = 900.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    async def boot():
        node = Node(data_dir, device=device)
        await node.start()
        server = ApiServer(node)
        return node, server, await server.start("127.0.0.1", 0)

    out: dict = {}
    api_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-api-")
    root = Path(api_tmp.name) / "library"
    node, server, port = on_loop(boot())
    ws = None
    try:
        t0 = time.perf_counter()
        made = write_api_location(root)
        out["write_s"] = time.perf_counter() - t0
        out["files_written"] = made["files"]
        [lib] = node.libraries.list()
        lid = str(lib.id)
        # phase 7's location: the library's largest (phase 8 added phase 5's)
        loc7, n7 = max(((r["location_id"], r["n"]) for r in lib.db.query(
            "SELECT location_id, COUNT(*) AS n FROM file_path GROUP BY location_id")),
            key=lambda t: t[1])

        if device == "cuda":
            torch.cuda.synchronize()
        blake3_cuda.reset_launches()
        hamming_cuda.reset_launches()
        t_api = time.perf_counter()
        http = HttpClient("127.0.0.1", port)
        ws = WsClient("127.0.0.1", port)
        ws.subscribe("jobs.progress", 1)
        require(http.rpc("library.list", post=False)[0]["uuid"] == lid, "library.list")
        loc, _ = ws.call("locations.create", {"library_id": lid, "path": str(root),
                                              "dry_run": True}, kind="mutation")
        walls = {}
        for name, path, input in (
                ("fullRescan", "locations.fullRescan", {"location_id": loc}),
                ("objectValidator", "jobs.objectValidator", {"id": loc}),
                ("nearDupDetector", "jobs.nearDupDetector", {"id": loc, "threshold": 10})):
            t0 = time.perf_counter()
            ws.call(path, {"library_id": lid, **input}, kind="mutation")
            on_loop(node.jobs.wait_idle())
            walls[name] = time.perf_counter() - t0
        reports = http.rpc("jobs.reports", {"library_id": lid})
        for r in reports[:5]:
            require(r["status"] == 2, f"job {r['name']} ended with status {r['status']}: "
                                      f"{(r['errors_text'] or '')[:200]}")
        want = {"indexer", "file_identifier", "media_processor", "object_validator",
                "near_dup_detector"}
        require(want <= {r["name"] for r in reports[:5]}, f"jobs {[r['name'] for r in reports]}")

        rows = lib.db.query("SELECT * FROM file_path WHERE location_id = ?", (loc,))
        require(api_row_paths(rows) == api_disk_paths(root),
                "the second location's rows != its files and directories")
        require(all(r["integrity_checksum"] for r in rows if not r["is_dir"]),
                "the validator left a file without its checksum")
        dups = http.rpc("search.duplicates", {"library_id": lid, "location_id": loc})
        got_groups = sorted(sorted(g["paths"]) for g in dups)
        require(got_groups == sorted(made["dup_groups"]),
                f"search.duplicates: {len(got_groups)} groups, planted "
                f"{len(made['dup_groups'])}")
        near = http.rpc("search.nearDuplicates", {"library_id": lid, "max_distance": 10})
        got_pairs = {tuple(sorted((p["paths_a"][0], p["paths_b"][0]))) for p in near}
        require(got_pairs == {tuple(sorted(p)) for p in made["pairs"]},
                f"search.nearDuplicates: {len(got_pairs)} pairs, planted {len(made['pairs'])}; "
                f"extra {sorted(got_pairs - made['pairs'])[:3]}")
        out["near_dup_max_distance"] = max(p["distance"] for p in near)

        n_paths = http.rpc("search.pathsCount", {"library_id": lid,
                                                 "filter": {"location_id": loc7}})
        require(n_paths == n7, f"search.pathsCount {n_paths} != the location's {n7} rows")
        page, width = ws.call("search.paths", {"library_id": lid, "take": 500,
                                               "filter": {"location_id": loc7}})
        require(len(page["items"]) == 500 and width == 64,
                f"a 500-row window came in a {width}-bit frame with {len(page['items'])} rows")

        by_path = {f"{r['materialized_path']}{r['name']}" +
                   (f".{r['extension']}" if r["extension"] else ""): r for r in rows}
        pic = by_path[made["images"][0]]
        status, headers, body = http.get(f"/spacedrive/thumbnail/{pic['cas_id']}.webp")
        require(status == 200 and body[:4] == b"RIFF" and body[8:12] == b"WEBP"
                and headers.get("Content-Type") == "image/webp", "thumbnail fetch")
        big = by_path[made["big"][0]]
        data = (root / made["big"][0][1:]).read_bytes()
        lo, hi = 5_000_000, 5_000_000 + (3 << 20) - 1
        status, headers, body = http.get(
            f"/spacedrive/file/{lid}/{loc}/{big['id']}", {"Range": f"bytes={lo}-{hi}"})
        require(status == 206 and body == data[lo:hi + 1]
                and headers.get("Content-Range") == f"bytes {lo}-{hi}/{len(data)}",
                "Range fetch")

        # file ops through the API, then a rescan that must agree with the disk
        src_ids = [by_path[p]["id"] for p in sorted(by_path) if p.startswith("/docs/d00/")][:20]
        dir_id = by_path["/docs/d01"]["id"]
        t0 = time.perf_counter()
        ws.call("files.createFolder", {"library_id": lid, "location_id": loc,
                                       "sub_path": "", "name": "copied"}, kind="mutation")
        for path, input in (
                ("files.copyFiles", {"source_location_id": loc, "target_location_id": loc,
                                     "sources_file_path_ids": src_ids + [dir_id],
                                     "target_location_relative_directory_path": "copied"}),
                ("files.duplicateFiles", {"location_id": loc, "file_path_ids": src_ids[:10],
                                          "target_relative_directory": "docs/d00"}),
                ("files.deleteFiles", {"location_id": loc,
                                       "file_path_ids": src_ids[10:] + [dir_id]})):
            http.rpc(path, {"library_id": lid, **input})
            on_loop(node.jobs.wait_idle())
        ws.call("locations.fullRescan", {"library_id": lid, "location_id": loc},
                kind="mutation")
        on_loop(node.jobs.wait_idle())
        walls["fileOps+rescan"] = time.perf_counter() - t0
        rows = lib.db.query("SELECT * FROM file_path WHERE location_id = ?", (loc,))
        disk = api_disk_paths(root)
        require(api_row_paths(rows) == disk, "rows != disk after copy, duplicate and delete")
        copied, dup_named = sum(p.startswith("/copied/") for p in disk), \
            sum(" (1)." in p for p in disk)
        require(copied == 20 + 1 + 100 and dup_named == 10 and "/docs/d01" not in disk,
                f"copy, duplicate or delete left another tree ({copied} paths under "
                f"/copied, {dup_named} ' (1)' names)")

        # round trips: search.paths windows of 100 over the 100 000-file location
        rtt = {"http": [], "ws": []}
        for kind in ("http", "ws"):
            cursor = 0
            for _ in range(API_RTT_CALLS):
                input = {"library_id": lid, "take": 100, "cursor": cursor,
                         "filter": {"location_id": loc7}}
                t0 = time.perf_counter()
                page = http.rpc("search.paths", input) if kind == "http" \
                    else ws.call("search.paths", input)[0]
                rtt[kind].append((time.perf_counter() - t0) * 1e3)
                require(len(page["items"]) == 100, "a short window")
                cursor = page["cursor"]
        if device == "cuda":
            torch.cuda.synchronize()
        out["api_s"] = time.perf_counter() - t_api
        launches = {**blake3_cuda.launches, **hamming_cuda.launches}
        counts["api"] = launches
        out.update(
            launches=launches, job_walls_s=walls, progress_frames=ws.events[1],
            frame_widths=dict(ws.widths), rows=len(rows), pairs=len(got_pairs),
            dup_groups=len(got_groups), paths_in_100k_location=n_paths,
            **{f"search_paths_{k}_ms": {"median": statistics.median(v),
                                        "p99": percentile(v, 99), "n": len(v)}
               for k, v in rtt.items()})
        require(ws.events[1] > 0, "no jobs.progress frame arrived")
        if device == "cuda":
            for name in (blake3_cuda.FAST, blake3_cuda.WINDOWED, blake3_cuda.FOLD,
                         hamming_cuda.NEAR_MASK):
                require(launches[name] > 0, f"phase 14: {name} never launched over the API")
    finally:
        if ws is not None:
            ws.close()
        on_loop(server.stop())
        on_loop(node.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        api_tmp.cleanup()
    emit("api", **out)
    return out


# -- observability plane (phase 15) -------------------------------------------

OBSERVE_CHILD_FILES = 2048      # (b) the profiled identify
OBSERVE_VALIDATE_BYTES = 9 << 20  # (b) one 9 MiB file: two K2 windows and folds
OBSERVE_MASK_DIGESTS = 2000     # (b) one mask-form compare
OBSERVE_RING_BATCHES = 16       # (c)
OBSERVE_RING_BATCH = 256
# (b): each kernel's device events must sit inside its named region. A
# form is known in the trace by its symbol, demangled or not:
# blake3_chunk_span<WINDOWED, FUSED> serves K1 and K2.
PROFILE_REGIONS = {
    "blake3_chunk_fast": (("blake3_chunk_span<false, true>", "blake3_chunk_spanILb0ELb1E"),
                          "cas_ids/cuda"),
    "blake3_chunk_windowed": (("blake3_chunk_span<true, true>", "blake3_chunk_spanILb1ELb1E"),
                              "seqhash.reduce"),
    "blake3_tree_fold": (("blake3_tree_fold",), "seqhash.reduce"),
    "hamming_near_mask": (("near_mask_kernel",), "hamming.pairs")}
PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
                       r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
                       r' (?:-?[0-9.]+(?:e[+-]?[0-9]+)?|NaN|[+-]Inf)$')


def family_value(name: str, **labels) -> float:
    """One counter child's value, or a histogram's observation sum."""
    from spacedrive_tpu_torch import telemetry

    fam = telemetry.REGISTRY.get(name)
    child = fam.labels(**labels) if labels else fam
    sample = child._sample()
    return float(sample["sum"] if "sum" in sample else sample["value"])


def observe_child(args: list) -> int:
    """Phase 15 (b) and (e), in a process of their own: the profiler is
    process-wide (SDTPU_PROFILE, set by the parent) and the sanitizer is
    installed in raise mode (SDTPU_SANITIZE, SDTPU_SANITIZE_MODE). Prints
    one JSON object: the trace file, the violations and what raised."""
    from spacedrive_tpu_torch import sanitize, tracing
    from spacedrive_tpu_torch.objects.validator import checksums_for_files
    from spacedrive_tpu_torch.ops import hamming, kernel_registry, staging

    spec = json.loads(Path(args[0]).read_text())
    require(sanitize.install(), "the sanitizer did not install (SDTPU_SANITIZE unset)")
    device = spec.get("device", "cuda")  # "cpu": a dry run of the plumbing
    out = {"mode": sanitize.mode()}
    ids, errors = staging.cas_ids_for_files([tuple(f) for f in spec["files"]],
                                            backend="cuda" if device == "cuda" else "plain")
    out["identify_matches"] = all(ids.get(i) == cid for i, cid in enumerate(spec["ids"]))
    sums, failed = checksums_for_files([spec["big"]], device)
    out["checksum"] = sums.get(0)
    digests = np.asarray(spec["digests"], dtype=np.uint32)
    out["pairs"] = [list(p) for p in hamming.near_dup_pairs(digests, 10, device=device)]
    out["violations_clean"] = [v["kind"] for v in sanitize.violations()]
    # The witness: a deliberate synchronizing call inside a device scope.
    x = torch.ones(4, device=device)
    try:
        with kernel_registry.device_scope("observe.witness"):
            x.sum().item()
        out["witness"] = "did not raise"
    except RuntimeError as e:
        out["witness"] = str(e).splitlines()[0][:200]
    out["violations"] = [v["kind"] for v in sanitize.violations()]
    if device == "cuda":
        torch.cuda.synchronize()
    out["trace_path"] = tracing.stop_profiler()
    print(json.dumps(out), flush=True)
    return 0


def profile_regions(trace: dict) -> dict:
    """For each PROFILE_REGIONS kernel: its device events and how many lie
    inside its region, by the launch's correlation to a CPU-side region
    (record_function) or, where no launch was traced, inside the region's
    device-side projection (gpu_user_annotation)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    regions, gpu_regions, launches = {}, {}, {}
    for e in events:
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if cat in ("user_annotation", "cpu_op"):
            regions.setdefault(e["name"], []).append(span)
        elif cat == "gpu_user_annotation":
            gpu_regions.setdefault(e["name"], []).append(span)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {"kernel_events": len(kernels), "events": len(events), "forms": {}}
    out["kernel_names"] = sorted({e["name"] for e in kernels})[:40]
    for form, (symbols, region) in PROFILE_REGIONS.items():
        mine = [e for e in kernels if any(sym in e["name"] for sym in symbols)]
        inside = 0
        via = set()
        for e in mine:
            t = launches.get((e.get("args") or {}).get("correlation"))
            if t is not None and any(a <= t <= b for a, b in regions.get(region, [])):
                inside += 1
                via.add("launch")
            elif any(a <= float(e["ts"]) <= b for a, b in gpu_regions.get(region, [])):
                inside += 1
                via.add("gpu_annotation")
        out["forms"][form] = {"region": region, "device_events": len(mine),
                              "inside": inside, "via": sorted(via),
                              "region_seen": region in regions}
    return out


def prometheus_ok(text: str) -> list:
    """Lines of a Prometheus text exposition that do not parse."""
    bad = []
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        if not PROM_LINE.match(line):
            bad.append(line)
    return bad


def phase_observe(workdir: Path, phase4_ids: dict, large_files: list, counts: dict,
                  device: str = "cuda") -> dict:
    """Phase 15: the observability plane on the card. (a) identify cost of
    telemetry, (b) a profiler run in a child, (c) the flight recorder on a
    ring, (d) a node's /metrics, spans, trace export, health and an
    incident, (e) the sync guard in raise mode (in the child of (b))."""
    import asyncio
    import secrets
    import threading

    from spacedrive_tpu_torch import chaos, flight, health, incidents, telemetry
    from spacedrive_tpu_torch.api.server import ApiServer
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.ops import blake3_cuda, hamming_cuda, kernel_registry, overlap
    from spacedrive_tpu_torch.ops import staging

    out: dict = {}
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    backend = "cuda" if cuda else "plain"  # a CPU dry run takes the plain path

    # (a) identify with telemetry on, then off. The hash entry writes no rows:
    # its own families (sd_identifier_batch_files, _batches_total) are checked
    # here, and sd_identifier_files_total, which counts the rows the
    # identifier job links, creates or skips, is held against a job's scan in (d).
    files = [(p, os.path.getsize(p)) for p in sorted(phase4_ids)]
    want = [phase4_ids[p] for p, _ in files]
    pool = staging.cas_pool(files, device) if cuda else None
    rates = {"on": [], "off": []}
    for on in (True, False):
        telemetry.set_enabled(on)
        try:
            b0 = family_value("sd_identifier_batch_files")
            n0 = family_value("sd_identifier_batches_total", backend=backend)
            if cuda:
                torch.cuda.synchronize()
            blake3_cuda.reset_launches()
            kernel_registry.reset_scope_counts()
            t0 = time.perf_counter()
            ids, _errors = staging.cas_ids_for_files(files, backend=backend, pool=pool)
            wall = time.perf_counter() - t0
        finally:
            telemetry.set_enabled(True)
        key = "on" if on else "off"
        rates[key].append(len(files) / wall)
        counts[f"observe_identify_{key}"] = dict(blake3_cuda.launches)
        require([ids.get(i) for i in range(len(files))] == want,
                f"phase 15 (a): CAS IDs with telemetry {key} != phase 4's")
        k1 = blake3_cuda.launches[blake3_cuda.FAST]
        scoped = kernel_registry.scope_counts().get(("cas_ids/cuda", blake3_cuda.FAST), 0)
        require(scoped == k1 == (2 if cuda else 0),
                f"phase 15 (a): registry counts {scoped} K1 in cas_ids/cuda, launches {k1}")
        db = family_value("sd_identifier_batch_files") - b0
        dn = family_value("sd_identifier_batches_total", backend=backend) - n0
        require((db, dn) == ((len(files), 1) if on else (0, 0)),
                f"phase 15 (a): telemetry {key} counted {db} files in {dn} batches")
    out["identify_files_per_s"] = rates
    out["identify_telemetry_cost"] = 1 - sum(rates["on"]) / sum(rates["off"])
    out["part_s"] = {"a": time.perf_counter() - t_phase}

    # (b) + (e) the profiler and the raise-mode guard, in a child
    if cuda:
        prof_dir = workdir / "observe-profile"
        prof_dir.mkdir()
        big = workdir / "observe-9mib.bin"
        big.write_bytes(np.random.default_rng(15).integers(
            0, 256, OBSERVE_VALIDATE_BYTES, dtype=np.uint8).tobytes())
        digests, planted = make_digests(OBSERVE_MASK_DIGESTS, 20, 10, seed=15)
        child_files = files[:OBSERVE_CHILD_FILES]
        spec = workdir / "observe-child.json"
        spec.write_text(json.dumps({"files": child_files, "ids": want[:OBSERVE_CHILD_FILES],
                                    "big": str(big), "digests": digests.tolist()}))
        env = {**os.environ, "SDTPU_PROFILE": str(prof_dir), "SDTPU_SANITIZE": "1",
               "SDTPU_SANITIZE_MODE": "raise"}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--observe-child",
                               str(spec)], env=env, capture_output=True, text=True,
                              timeout=300)
        out["profile_child_s"] = time.perf_counter() - t0
        require(proc.returncode == 0, f"phase 15 (b): the child failed ({proc.returncode}): "
                                      f"{proc.stderr[-2000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        require(child["identify_matches"], "phase 15 (b): the child's CAS IDs != phase 4's")
        from spacedrive_tpu_torch.objects.validator import checksums_for_files

        # phase 5 holds this path against its plain version at 64 MiB
        here, _ = checksums_for_files([str(big)], "cuda")
        require(child["checksum"] == here[0],
                "phase 15 (b): the child's 9 MiB checksum != this process's")
        want_pairs = tiled_pairs(digests, 10, 4096)
        require([tuple(p) for p in child["pairs"]] == want_pairs,
                "phase 15 (b): the mask compare's pairs != the plain tiles'")
        # (e) raise mode: no violation on the three paths; the witness raised
        require(child["mode"] == "raise" and child["violations_clean"] == [],
                f"phase 15 (e): violations in raise mode: {child['violations_clean']}")
        require("synchroniz" in child["witness"].lower()
                and child["violations"] == ["host_transfer"],
                f"phase 15 (e): the .item() witness gave {child['witness']!r}, "
                f"violations {child['violations']}")
        out["guard_witness"] = child["witness"]
        path = Path(child["trace_path"] or "")
        require(path.is_file(), f"phase 15 (b): no profiler trace ({child['trace_path']})")
        out["trace_file_bytes"] = path.stat().st_size
        trace = json.loads(path.read_text())
        names = {e.get("name") for e in trace.get("traceEvents", [])}
        regions = profile_regions(trace)
        out["profile"] = regions
        require({"cas_ids/cuda", "seqhash.reduce", "hamming.pairs"} <= names,
                f"phase 15 (b): regions missing from the trace: "
                f"{sorted({'cas_ids/cuda', 'seqhash.reduce', 'hamming.pairs'} - names)}")
        require(regions["kernel_events"] > 0,
                f"phase 15 (b): CUDA activity lists no kernel ({regions['events']} events): "
                "the profiler traced no device activity (CUPTI unavailable to this process)")
        for form, r in regions["forms"].items():
            require(r["device_events"] > 0,
                    f"phase 15 (b): no device event of {form} in the trace; its kernels: "
                    f"{regions['kernel_names']}")
            require(r["inside"] == r["device_events"],
                    f"phase 15 (b): {r['inside']} of {form}'s {r['device_events']} device "
                    f"events inside {r['region']}")

    out["part_s"]["b_e"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    # (c) the flight recorder on a ring of 16 batches at depth 3
    flight.RECORDER.clear()
    n_ring = OBSERVE_RING_BATCHES * OBSERVE_RING_BATCH
    ring_files = large_files[:n_ring]
    batches = [([p for p, _ in ring_files[k:k + OBSERVE_RING_BATCH]],
                np.array([s for _, s in ring_files[k:k + OBSERVE_RING_BATCH]], np.uint64))
               for k in range(0, n_ring, OBSERVE_RING_BATCH)]
    blake3_cuda.reset_launches()
    _digs, rstats = overlap.run_overlapped(batches, depth=3, devices=[device],
                                           calibrate_every=len(batches))
    counts["observe_ring"] = dict(blake3_cuda.launches)
    doc = flight.chrome_trace(node_name="chip-smoke")
    problems = flight.validate_chrome_trace(doc)
    require(problems == [], f"phase 15 (c): chrome trace problems {problems[:3]}")
    windows = [e for e in flight.RECORDER.snapshot() if e["lane"] == "window"]
    bound_by = collections.Counter(w["binding"] for w in windows)
    require(len(windows) == len(batches) - 1,
            f"phase 15 (c): {len(windows)} windows for {len(batches) - 1} measured batches")
    # A kernel lane spans its batch's launch to its kernel's end: after the
    # batch's copy, and after the kernel launched before it (one compute
    # stream, one dispatcher). 2 us covers the rounding to whole microseconds.
    lanes = {lane: {e["batch"]: e for e in flight.RECORDER.snapshot() if e["lane"] == lane}
             for lane in ("h2d", "kernel")}
    for b, k in lanes["kernel"].items():
        h = lanes["h2d"][b]
        require(k["ts_us"] >= h["ts_us"] + h["dur_us"] - 2,
                f"phase 15 (c): batch {b}'s kernel lane starts inside its copy: {h} {k}")
    in_order = sorted(lanes["kernel"].values(), key=lambda e: e["ts_us"])
    for prev, k in zip(in_order, in_order[1:]):
        require(k["ts_us"] >= prev["ts_us"] + prev["dur_us"] - 2,
                f"phase 15 (c): two kernel lanes overlap: {prev} {k}")
    out["ring"] = {"windows": len(windows), "bound_by": dict(bound_by),
                   "files_per_s": rstats.files_per_sec,
                   "bound_files_per_s": rstats.bound_files_per_sec}

    out["part_s"]["c"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    # (d) a node over the API
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    node_dir = tempfile.TemporaryDirectory(prefix="chip-smoke-observe-")

    async def boot():
        node = Node(str(Path(node_dir.name) / "node"), device=device)
        await node.start()
        server = ApiServer(node)
        return node, server, await server.start("127.0.0.1", 0)

    root = workdir / "observe-location"
    made = write_api_location(root)
    node, server, port = on_loop(boot())
    ws = None
    try:
        http = HttpClient("127.0.0.1", port)
        ws = WsClient("127.0.0.1", port)
        lib = http.rpc("library.create", {"name": "observe"})
        lid = lib["uuid"]
        f0 = {o: family_value("sd_identifier_files_total", outcome=o)
              for o in ("linked", "created", "skipped")}
        trace_id, parent = secrets.randbits(63) | 1, secrets.randbits(63) | 1
        tp = f"{trace_id:x}-{parent:x}"
        if cuda:
            torch.cuda.synchronize()
        blake3_cuda.reset_launches()
        hamming_cuda.reset_launches()
        loc, _ = ws.call("locations.create", {"library_id": lid, "path": str(root),
                                              "dry_run": True}, kind="mutation", tp=tp)
        ws.call("locations.fullRescan", {"library_id": lid, "location_id": loc},
                kind="mutation", tp=tp)
        on_loop(node.jobs.wait_idle())
        counts["observe_node"] = {**blake3_cuda.launches, **hamming_cuda.launches}
        # a fresh keep-alive connection: the server closes one idle past
        # its api.http.read budget, and the scan may have taken that long
        http = HttpClient("127.0.0.1", port)
        t0 = time.perf_counter()
        status, headers, body = http.get("/metrics")
        out["metrics_scrape_ms"] = (time.perf_counter() - t0) * 1e3
        text = body.decode()
        require(status == 200 and headers.get("Content-Type", "").startswith(
            "text/plain; version=0.0.4"), f"phase 15 (d): GET /metrics {status}")
        bad = prometheus_ok(text)
        require(not bad, f"phase 15 (d): /metrics lines that do not parse: {bad[:3]}")
        out["metrics_bytes"] = len(body)
        [library] = [x for x in node.libraries.list() if str(x.id) == lid]
        [ident] = [r for r in job_reports(library) if r.name == "file_identifier"]
        identified = {"linked": ident.metadata["total_objects_linked"],
                      "created": ident.metadata["total_objects_created"],
                      "skipped": ident.metadata["total_skipped"]}
        moved = {o: family_value("sd_identifier_files_total", outcome=o) - f0[o] for o in f0}
        require(moved == {o: float(v) for o, v in identified.items()}
                and identified["created"] > 0,
                f"phase 15 (d): sd_identifier_files_total moved {moved}, the scan's "
                f"identifier reports {identified}")
        for o, v in moved.items():
            prom = re.search(rf'^sd_identifier_files_total\{{outcome="{o}"\}} (\S+)$', text,
                             re.M)
            require(prom is not None and float(prom.group(1)) ==
                    family_value("sd_identifier_files_total", outcome=o),
                    f"phase 15 (d): /metrics sd_identifier_files_total{{{o}}}")
        out["identified"] = identified

        spans = http.rpc("node.spans", {"trace": f"{trace_id:x}", "limit": 512})
        by_name = collections.Counter(s["span"].split("/")[0] for s in spans)
        rpc = [s for s in spans if s["span"] == "rpc/locations.fullRescan"]
        require(rpc and rpc[0]["parent"] == f"{parent:x}",
                f"phase 15 (d): no rpc/locations.fullRescan span under the client's trace "
                f"({sorted(by_name)})")
        require(by_name["job"] >= 2 and by_name["cas_ids"] >= 1,
                f"phase 15 (d): the scan's job and cas_ids spans are not in the client's "
                f"trace: {dict(by_name)}")
        out["spans_in_trace"] = dict(by_name)
        doc = http.rpc("node.trace.export", post=False)
        require(flight.validate_chrome_trace(doc) == [], "phase 15 (d): node.trace.export")
        snap = http.rpc("node.health", post=False)
        require(health.validate_health_snapshot(snap) == [],
                f"phase 15 (d): node.health {health.validate_health_snapshot(snap)[:3]}")
        out["health_states"] = snap.get("states")

        before = {h["id"] for h in http.rpc("incidents.list", post=False)}
        chaos.arm("store.commit=error:1.0", seed=15)
        scale = os.environ.get("SDTPU_TIMEOUT_SCALE")
        os.environ["SDTPU_TIMEOUT_SCALE"] = "0.05"  # the ladder's sleeps, scaled
        try:
            status, _h, _b = http.post_raw("/rspc/tags.create",
                                           {"library_id": lid, "name": "observe",
                                            "color": "#00ff00"})
        finally:
            chaos.disarm()
            if scale is None:
                os.environ.pop("SDTPU_TIMEOUT_SCALE")
            else:
                os.environ["SDTPU_TIMEOUT_SCALE"] = scale
        require(status >= 400, f"phase 15 (d): a write under store.commit=error answered "
                               f"{status}")
        new = [h for h in http.rpc("incidents.list", post=False) if h["id"] not in before]
        require(len(new) == 1 and new[0]["trigger"]["kind"] == "backoff.give_up"
                and new[0]["trigger"]["resource"] == "store.busy",
                f"phase 15 (d): incidents after the give-up: {new}")
        require(incidents.validate_incident_header(new[0]) == [],
                f"phase 15 (d): {incidents.validate_incident_header(new[0])[:3]}")
        bundle = http.rpc("incidents.get", {"id": new[0]["id"]})
        require(incidents.validate_incident_bundle(bundle) == [],
                f"phase 15 (d): {incidents.validate_incident_bundle(bundle)[:3]}")
        require(http.rpc("incidents.ack", {"id": new[0]["id"]}) == {"acked": True},
                "phase 15 (d): incidents.ack")
        out["incident"] = {"trigger": new[0]["trigger"]["kind"],
                           "resource": new[0]["trigger"]["resource"]}
    finally:
        if ws is not None:
            ws.close()
        on_loop(server.stop())
        on_loop(node.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        node_dir.cleanup()
    out["part_s"]["d"] = time.perf_counter() - t_phase - sum(out["part_s"].values())
    out["wall_s"] = time.perf_counter() - t_phase
    emit("observe", **out)
    return out


REPLACES = {
    "blake3_chunk_fast": "spacedrive_tpu/ops/blake3_pallas.py:121",
    "blake3_chunk_fast_cvs": "spacedrive_tpu/ops/blake3_pallas.py:121",
    "blake3_chunk_windowed": "spacedrive_tpu/ops/blake3_pallas.py:210",
    "blake3_chunk_windowed_cvs": "spacedrive_tpu/ops/blake3_pallas.py:210",
    # tree_reduce is jnp in the JAX package: no Pallas counterpart.
    "blake3_tree_fold": "spacedrive_tpu/ops/blake3_batch.py:231",
    # hamming_tile + _near_mask_tile and the pyramid's sweep and refinement
    # are jnp in the JAX package: no Pallas counterpart.
    "hamming_near_mask": "spacedrive_tpu/ops/hamming.py:34 (hamming_tile) + :68 "
                         "(_near_mask_tile); jnp, no Pallas counterpart",
    "hamming_near_counts": "spacedrive_tpu/ops/hamming.py:260 (_tile_counts_block) + :290 "
                           "(_refine_body); jnp, no Pallas counterpart",
}
SOURCES = {"hamming_near_mask": "spacedrive_tpu_torch/csrc/hamming.cu",
           "hamming_near_counts": "spacedrive_tpu_torch/csrc/hamming.cu"}
# Kernels that must launch on a main path; the rest are parity forms.
MAIN_PATH = ("blake3_chunk_fast", "blake3_chunk_windowed", "blake3_tree_fold",
             "hamming_near_mask", "hamming_near_counts")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from spacedrive_tpu_torch.ops import blake3_cuda  # the port must import here

    gpu = nvidia_smi("name,power.limit")
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.cuda.set_device(0)
    bound = Bound()
    emit("device", name=torch.cuda.get_device_name(0), sms=bound.sms,
         max_sm_clock_mhz=bound.clock_mhz)

    stats, counts = {}, {}
    t_all = time.perf_counter()
    phase_s = {}
    last = [t_all]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    phase_build()
    mark("build")
    phase_identify_step(bound, stats)
    phase_small_grid(stats)
    mark("identify_step+small_grid")
    (ROOT / "spacedrive_tpu_torch" / "_build").mkdir(parents=True, exist_ok=True)
    # The corpus lives in the checkout, the library's SQLite files in the
    # system temp dir (a WAL's -shm file is a shared memory map).
    with tempfile.TemporaryDirectory(
            prefix="chip-smoke-", dir=ROOT / "spacedrive_tpu_torch" / "_build") as tmp, \
            tempfile.TemporaryDirectory(prefix="chip-smoke-lib-") as data_dir:
        large_files, phase4_ids, planted = phase_real_files(Path(tmp), counts)
        mark("real_files")
        sums = phase_validate(Path(tmp), bound, counts, stats)
        mark("validate")
        phase_ring(Path(tmp), large_files, counts)
        mark("ring")
        lib = phase_scan(Path(tmp), data_dir, phase4_ids, planted, counts)
        mark("scan")
        try:
            phase_validate_job(Path(tmp), lib, sums, counts)
        finally:
            lib.db.close()
        mark("validate_job")
        phase_sync(Path(tmp), data_dir, sums, counts)
        mark("sync")
        phase_api(Path(tmp), data_dir, counts)
        mark("api")
        phase_observe(Path(tmp), phase4_ids, large_files, counts)
        mark("observe")
    # The near-dup corpora and their library in the system temp dir.
    with tempfile.TemporaryDirectory(prefix="chip-smoke-near-dup-") as tmp:
        near_dup = phase_near_dup_job(Path(tmp), counts)
    mark("near_dup_job")
    scale = phase_near_dup_scale(bound, near_dup["B"]["objects_hashed"], counts)
    mark("near_dup_scale")
    stats["hamming_near_mask"] = scale["mask"][f"{near_dup['B']['objects_hashed']}x2"]
    stats["hamming_near_counts"] = scale["counts"]["sweep"]
    phase_live(counts)
    mark("live")
    phase_media(counts)
    mark("media")

    kernels = []
    for name, replaces in REPLACES.items():
        launches = sum(c.get(name, 0) for c in counts.values())
        if name in MAIN_PATH:
            require(launches > 0, f"{name} never launched on a main path")
        s = stats[name]  # a CV form (on no main path) is listed with its 0 launches
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "spacedrive_tpu_torch/csrc/blake3_chunk.cu"),
            "replaces": replaces, "launches": launches,
            "max_abs_err": s["max_abs_err"], "matches_plain": s["max_abs_err"] == 0,
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"), "shape": s["shape"],
        })
    emit("forms", **{name: stats[name] for name in REPLACES})
    emit("done", seconds=time.perf_counter() - t_all, phase_s=phase_s, launches_by_path=counts)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--observe-child"]:  # phase 15's child (b, e)
        sys.exit(observe_child(sys.argv[2:]))
    sys.exit(main())
