"""Build the port's native sources at first use and load them.

Each source in ``csrc/`` has a plain C interface and is compiled on its own
into a shared library, loaded with ``ctypes``:

- ``csrc/<name>.cu`` by ``nvcc`` for ``sm_90a`` (the CUDA kernels);
- ``csrc/<name>.cpp`` by ``g++`` (host code: the native staging plane, the
  image decoders and the p2p tunnel's cryptography).

The library's name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The flags
name no host CPU (no ``-march=native``), so a library built on one host is
right on any other, and the host code contracts no floating-point multiply
and add into one (``-ffp-contract=off``): the image decoder's LANCZOS
weights round as PIL's do. Builds write a temporary file and ``os.replace`` it
into place under a per-source file lock, so concurrent processes (xdist
workers) neither race nor load a half-written library. Libraries and the
compiler's output (``-Xptxas -v``: registers, spills) land in
``spacedrive_tpu_torch/_build/``, which git ignores.

Nothing here runs at import: the CPU tests import every module, and only
the first call into a library needs its compiler. A missing compiler
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-ffp-contract=off", "-Wall", "-Wextra")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_charpp = ctypes.POINTER(ctypes.c_char_p)

# name → (argtypes, restype) of each exported C function, per source.
_SIGNATURES = {
    "blake3_chunk": {
        "sd_blake3_chunk": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
             ctypes.c_uint, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "sd_blake3_tree_fold": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "sd_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "hamming": {
        "sd_hamming_near_mask": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "sd_hamming_near_counts": (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "sd_hamming_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "imgdec": {
        "sd_png_unfilter": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p],
            ctypes.c_int64),
        "sd_luma": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], None),
        "sd_resample_lanczos": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], None),
        "sd_resample_lanczos_image": (
            [_u8p] + [ctypes.c_int64] * 5 + [_u8p], None),
        "sd_resample_lanczos_rgba": (
            [_u8p] + [ctypes.c_int64] * 4 + [_u8p], None),
        "sd_thumb_rgb": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], ctypes.c_int64),
        "sd_gif_lzw": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, _u8p, ctypes.c_int64], ctypes.c_int64),
    },
    "jpegdec": {
        "sd_jpeg_header": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, _i64p], ctypes.c_int64),
        "sd_jpeg_decode": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], ctypes.c_int64),
    },
    "webpdec": {
        "sd_webp_alpha": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64], ctypes.c_int64),
        "sd_webp_lossless_bands": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p],
            ctypes.c_int64),
        "sd_webp_alpha_plane": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], ctypes.c_int64),
        "sd_webp_lossy": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p], ctypes.c_int64),
    },
    "webpenc": {
        "sd_webp_encode": (
            [_u8p] + [ctypes.c_int64] * 5 + [_i64p] * 5 + [_u8p, ctypes.c_int64],
            ctypes.c_int64),
    },
    "tiffdec": {
        "sd_tiff_chunks": (
            [_u8p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p] + [ctypes.c_int64] * 12
            + [_u8p], ctypes.c_int64),
    },
    "p2pcrypto": {
        "sd_x25519": ([_u8p, _u8p, _u8p], None),
        "sd_ed25519_base": ([_u8p, _u8p], None),
        "sd_ed25519_check": ([_u8p, _u8p, _u8p, _u8p], ctypes.c_int),
        "sd_aead_seal": (
            [_u8p, _u8p, _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64, ctypes.c_char_p],
            None),
        "sd_aead_open": (
            [_u8p, _u8p, _u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64, ctypes.c_char_p],
            ctypes.c_int),
    },
    "sdio_stage": {
        "sd_stage_large": (
            [ctypes.c_int64, _charpp, _u64p, _u8p, _i32p, ctypes.c_int], None),
        "sd_stage_small": (
            [ctypes.c_int64, _charpp, ctypes.c_uint64, _u8p, _i32p, _i32p,
             ctypes.c_int], None),
        "sd_stage_batch": (
            [ctypes.c_int64, _charpp, _u64p, _u8p, ctypes.c_int64,
             ctypes.c_uint64, _i32p, _i32p, ctypes.c_int], None),
    },
}

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda,
    else the first nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def gxx() -> str:
    """Path of the host C++ compiler: $CXX, else the first g++ on PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ not found: set CXX to a C++17 compiler")
    return found


def _source(name: str) -> Path:
    for ext in (".cu", ".cpp"):
        if (CSRC_DIR / f"{name}{ext}").is_file():
            return CSRC_DIR / f"{name}{ext}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [gxx(), *GXX_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.{cu,cpp} lives for the current source."""
    src = _source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_source(name: str) -> Path:
    """Compile csrc/<name> unless its current library exists; returns the
    library path. The compiler's output goes to <library>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = _source(name)
        proc = subprocess.run(_command(src, tmp), capture_output=True,
                              text=True, check=False)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"compiling csrc/{src.name} failed (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, compiled on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
        return lib
