"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
The library's name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Libraries
and the compiler's output (``-Xptxas -v``: registers, spills) land in
``spacedrive_tpu_torch/_build/``, which git ignores.

Nothing here runs at import: the CPU tests import every module, and only
the first launch of a kernel needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
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


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu lives for the current source."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_source(name: str) -> Path:
    """Compile csrc/<name>.cu unless its current library exists; returns
    the library path. The compiler's output goes to <library>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    tmp.rename(out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, compiled on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
        return lib
