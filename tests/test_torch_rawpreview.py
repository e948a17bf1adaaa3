"""``media/rawpreview.py`` against the JAX package's: the same preview (or
None) from TIFF-structured RAW files built the way
``tests/test_rawpreview.py`` builds them, both byte orders, with and without
a SubIFD, and from cut, garbled and non-TIFF files."""

from __future__ import annotations

import numpy as np
import pytest

from spacedrive_tpu.media import rawpreview as jax_raw
from spacedrive_tpu_torch.media import rawpreview as port_raw
from tests.test_rawpreview import build_raw


def _same(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    want, got = jax_raw.extract_preview(str(p)), port_raw.extract_preview(str(p))
    assert got == want
    return got


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("subifd", [True, False])
def test_previews_equal(tmp_path, endian, subifd):
    data, largest = build_raw(endian, with_subifd=subifd)
    assert _same(tmp_path, "x.nef", data) == largest


@pytest.mark.parametrize("seed", range(8))
def test_cut_and_garbled_files_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    data = bytearray(build_raw("<" if seed % 2 else ">", with_subifd=bool(seed % 3))[0])
    if seed < 4:
        data = data[:int(rng.integers(8, len(data)))]
    else:
        for at in rng.integers(0, min(len(data), 400), 6).tolist():
            data[at] = int(rng.integers(0, 256))
    _same(tmp_path, f"x{seed}.dng", bytes(data))


@pytest.mark.parametrize("data", [b"", b"II*\x00", b"not a tiff file at all, no sir",
                                  b"MM\x00*" + bytes(20)])
def test_non_tiff_and_tiny_files(tmp_path, data):
    assert _same(tmp_path, "y.cr2", data) is None


def test_extensions_are_the_jax_packages():
    assert port_raw.RAW_TIFF_EXTENSIONS == jax_raw.RAW_TIFF_EXTENSIONS
