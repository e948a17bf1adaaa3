"""The port's boundaries: what it may import, and where it may run.

- Nothing under ``spacedrive_tpu_torch/`` nor ``chip_smoke.py`` imports
  ``jax``, ``jaxlib`` or the JAX package ``spacedrive_tpu`` (the port keeps
  its own copies of the framework-free modules), nor ``msgpack``, ``PIL``,
  ``cryptography``, ``aiohttp`` or ``argon2``, which the GPU machine does
  not have (the port carries its own msgpack codec and HTTP/WebSocket
  server), and no C++ or CUDA source
  of the port includes a file outside ``spacedrive_tpu_torch/csrc/``.
- Asking an entry point for CUDA where there is none raises instead of
  running on the CPU, and a kernel wrapper given a CPU tensor takes the
  plain version without counting a launch.
"""

import ast
import asyncio
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spacedrive_tpu_torch.api.server import serve
from spacedrive_tpu_torch.locations import manager as locations
from spacedrive_tpu_torch.locations import watcher
from spacedrive_tpu_torch.locations.non_indexed import walk_ephemeral
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import validator
from spacedrive_tpu_torch.objects.dedup import NearDupDetectorJob
from spacedrive_tpu_torch.objects.identifier import FileIdentifierJob
from spacedrive_tpu_torch.ops import blake3_batch as bb
from spacedrive_tpu_torch.ops import (blake3_cuda, blake3_torch, hamming, hamming_cuda, overlap,
                                      phash, seqhash, staging)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "spacedrive_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "spacedrive_tpu", "msgpack", "PIL", "cryptography", "aiohttp",
             "argon2"}
CSRC = ROOT / "spacedrive_tpu_torch" / "csrc"
NATIVE_SOURCES = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".cpp", ".h"))
INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes run faster on one intra-op thread, and the suite's
    other xdist workers keep their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _imported(tree: ast.AST):
    """Absolute module names a file imports, statically or by name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_nor_what_the_gpu_host_lacks(path):
    bad = sorted(m for m in _imported(ast.parse(path.read_text(), str(path)))
                 if m.split(".")[0] in FORBIDDEN)
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_import_detector_catches_every_spelling():
    src = ("import jax.numpy as jnp\nfrom spacedrive_tpu.ops import cas\n"
           "import importlib\nimportlib.import_module('jaxlib')\n"
           "def f():\n    import msgpack\n"
           "from PIL import Image\n__import__('cryptography.hazmat')\n"
           "from aiohttp import web\nimport argon2.low_level\n"
           "from spacedrive_tpu_torch.ops import cas\nfrom . import x\n"
           "from spacedrive_tpu_torch import _msgpack\n")
    found = {m.split(".")[0] for m in _imported(ast.parse(src))} & FORBIDDEN
    assert found == FORBIDDEN


def test_scan_covers_the_staging_plane_the_ring_and_the_scan_chain():
    port = ROOT / "spacedrive_tpu_torch"
    assert {port / "native.py", port / "ops" / "overlap.py",
            port / "ops" / "staging.py", port / "_msgpack.py",
            port / "store" / "db.py", port / "sync" / "manager.py",
            port / "jobs" / "worker.py", port / "locations" / "manager.py",
            port / "objects" / "identifier.py", port / "media" / "imgdecode.py",
            port / "ops" / "phash.py", port / "ops" / "hamming.py",
            port / "ops" / "hamming_cuda.py", port / "objects" / "dedup.py",
            port / "media" / "jpeg.py", port / "media" / "gif.py",
            port / "media" / "tiff.py", port / "media" / "webp.py",
            port / "media" / "webp_tables.py", port / "store" / "actor.py",
            port / "flags.py", port / "tasks.py", port / "locations" / "shallow.py",
            port / "locations" / "watcher.py",
            port / "locations" / "non_indexed.py", port / "persist.py",
            *(port / "media" / f"{m}.py" for m in (
                "exif", "pluscodes", "isobmff", "rawpreview", "images", "thumbnail",
                "webpenc", "actor", "processor", "avmetadata")),
            *(port / "sync" / f"{m}.py" for m in ("ingest", "clone_serve", "opblob", "crdt")),
            *(port / "p2p" / f"{m}.py" for m in (
                "_crypto", "identity", "proto", "wire", "spaceblock", "discovery", "mdns",
                "sync_net", "manager")),
            port / "node.py", port / "library.py", port / "timeouts.py",
            port / "channels.py",
            *(port / "api" / f"{m}.py" for m in (
                "router", "procedures", "serialization", "server", "webui", "_http")),
            *(port / f"{m}.py" for m in (
                "cli", "__main__", "auth", "backups", "volume", "debug_init")),
            port / "objects" / "fs_ops.py"} <= set(PORT_FILES)
    assert {p.name for p in NATIVE_SOURCES} >= {"blake3_chunk.cu", "sdio_stage.cpp",
                                                 "hamming.cu", "imgdec.cpp", "jpegdec.cpp",
                                                 "tiffdec.cpp", "webpdec.cpp", "webpenc.cpp",
                                                 "p2pcrypto.cpp"}


def _foreign_includes(path: Path, text: str):
    """Includes that name a file outside the source's own directory: a
    path into the JAX package's trees, a parent directory, or a quoted
    include that csrc/ does not hold."""
    for kind, name in INCLUDE.findall(text):
        if name.startswith(("native/", "spacedrive_tpu/", "/")) or ".." in name \
                or (kind == '"' and not (path.parent / name).is_file()):
            yield name


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=lambda p: p.name)
def test_native_sources_include_nothing_outside_csrc(path):
    assert list(_foreign_includes(path, path.read_text())) == []


def test_include_detector_catches_every_spelling():
    src = ('#include "../../native/sdio.cpp"\n#include <spacedrive_tpu/x.h>\n'
           '#  include "native/sdio.cpp"\n#include "missing.h"\n#include <cstdint>\n')
    assert list(_foreign_includes(CSRC / "x.cpp", src)) == [
        "../../native/sdio.cpp", "spacedrive_tpu/x.h", "native/sdio.cpp", "missing.h"]


def _grid():
    words = np.zeros((2, 1, 256), np.uint32)
    return words, np.array([0, 5], np.int32)


@pytest.mark.parametrize("call", [
    lambda: blake3_torch.blake3_words(*_grid(), device="cuda"),
    lambda: blake3_torch.words_to_device(*_grid(), device="cuda"),
    lambda: blake3_torch.cas_ids(np.zeros((1, 16), np.uint8), np.array([16], np.uint64)),
    lambda: blake3_torch.checksums_words_batched([b"abc"]),
    lambda: staging.cas_ids_for_files([("/nonexistent", 3)], backend="cuda"),
    lambda: validator.checksums_for_files(["/nonexistent"]),
    lambda: seqhash.StreamingChecksum(),
    lambda: staging.stage_batch_native([("/nonexistent", 200_000)],
                                       staging.StagePool("cuda", 1, 1 << 20)),
    lambda: staging.cas_pool([("/nonexistent", 5)]),
    lambda: overlap.run_overlapped([(["/nonexistent"], np.array([200_000], np.uint64))],
                                   depth=1, devices=["cuda"]),
    lambda: blake3_torch.words_to_device(*_grid(), device="cuda", non_blocking=True),
    lambda: FileIdentifierJob(location_id=1),
    lambda: FileIdentifierJob(location_id=1, backend="cuda", device_batch=8),
    lambda: validator.ObjectValidatorJob(location_id=1),
    lambda: asyncio.run(locations.scan_location(None, None, 1)),
    lambda: asyncio.run(locations.scan_location_sub_path(None, None, 1, "a")),
    lambda: phash.phash_torch(np.zeros((1, 32, 32), np.float32)),
    lambda: phash.phash_files(["/nonexistent.png"]),
    lambda: hamming.near_dup_pairs(np.zeros((3, 2), np.uint32), 1),
    lambda: hamming.near_dup_pairs_device(np.zeros((3, 2), np.uint32), 1),
    lambda: NearDupDetectorJob(location_id=1),
    lambda: locations.light_scan_location(None, 1),
    lambda: walk_ephemeral("/nonexistent", compute_cas_ids=True),
    lambda: watcher.Locations(),
    lambda: Node("/nonexistent/node"),
    lambda: asyncio.run(serve("/nonexistent/serve", port=0)),
], ids=["blake3_words", "words_to_device", "cas_ids", "checksums",
        "cas_ids_for_files", "validator", "streaming", "stage_batch_native",
        "cas_pool", "run_overlapped", "words_to_device_non_blocking",
        "file_identifier_job", "file_identifier_job_batch", "object_validator_job",
        "scan_location", "scan_location_sub_path", "phash_torch", "phash_files",
        "near_dup_pairs", "near_dup_pairs_device", "near_dup_detector_job",
        "light_scan_location", "walk_ephemeral", "locations_actor", "node", "serve"])
def test_cuda_entry_points_raise_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_a_node_hashes_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``Node``'s default device is the card: its scan backend and the
    device its jobs see are CUDA's; without CUDA the node refuses to start,
    and a hash through its backend raises; ``device="cpu"`` runs the plain
    backends."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Node(str(tmp_path / "card"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    node = Node(str(tmp_path / "card"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert (node.device, node.backend, node.jobs.services["device"]) == ("cuda", "cuda", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validator.checksums_for_files(["/nonexistent"], node.device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        locations.light_scan_location(None, 1, backend=node.backend)
    cpu = Node(str(tmp_path / "cpu"), device="cpu")
    assert (cpu.device, cpu.backend) == ("cpu", "plain")
    with pytest.raises(ValueError):
        Node(str(tmp_path / "x"), device="tpu")


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    words, lengths = blake3_torch.words_to_device(*_grid(), device="cpu")
    blake3_cuda.reset_launches()
    fast, n_fast = blake3_cuda.chunk_cvs_fast(words, lengths)
    win, n_win = blake3_cuda.chunk_cvs(words, lengths)
    plain, n_plain = bb.chunk_cvs(words, lengths)
    assert torch.equal(fast, plain) and torch.equal(win, plain)
    assert torch.equal(n_fast, n_plain) and torch.equal(n_win, n_plain)
    digests = blake3_cuda.blake3_words(words, lengths)
    top = blake3_cuda.window_top(words[:1], lengths[:1], 16)
    assert torch.equal(digests, bb.tree_reduce(plain, n_plain))
    assert torch.equal(top, bb.tree_reduce(
        *bb.chunk_cvs(words[:1], lengths[:1], 16, whole=False), root=False)[0])
    assert set(blake3_cuda.launches) == {
        blake3_cuda.FAST, blake3_cuda.WINDOWED, blake3_cuda.FOLD,
        blake3_cuda.FAST_CVS, blake3_cuda.WINDOWED_CVS}
    assert all(n == 0 for n in blake3_cuda.launches.values())
    d = torch.zeros((3, 2), dtype=torch.int32)
    hamming_cuda.reset_launches()
    assert torch.equal(hamming_cuda.hamming_near_mask(d, d, 0),
                       hamming_cuda.near_mask_plain(d, d, 0))
    words = torch.zeros((64, 2), dtype=torch.int32)
    assert torch.equal(hamming_cuda.hamming_near_counts(words, [[0, 32]], 32, 16, 0, 64),
                       hamming_cuda.near_counts_plain(words, [[0, 32]], 32, 16, 0, 64))
    assert hamming_cuda.launches == {hamming_cuda.NEAR_MASK: 0, hamming_cuda.NEAR_COUNTS: 0}


def test_wrappers_refuse_malformed_inputs():
    words, lengths = blake3_torch.words_to_device(*_grid(), device="cpu")
    with pytest.raises(ValueError):
        blake3_cuda.chunk_cvs_fast(words.to(torch.int64), lengths)
    with pytest.raises(ValueError):
        blake3_cuda.chunk_cvs_fast(words, lengths[:1])
    with pytest.raises(ValueError):
        staging.cas_ids_for_files([], backend="auto")
    with pytest.raises(ValueError):
        blake3_cuda.window_top(words, lengths, 0)  # two windows
    with pytest.raises(ValueError):
        blake3_cuda.window_top(words[:1], lengths[:1], np.array([0, 1], np.uint64))
    d = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_mask(d.to(torch.int64), d, 0)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_near_mask(d, torch.zeros((3, 3), dtype=torch.int32), 0)
