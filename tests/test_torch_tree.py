"""The fused kernels' tree decomposition against the JAX package's tree.

``blake3_batch.tree_reduce_spans`` is the plain torch form of what the
fused CUDA kernels compute: span tops by adjacent pairing inside aligned
power-of-two spans, then folds of the tops, continuing the global levels.
It must equal the JAX package's numpy ``tree_reduce`` exactly (integer
hashes: tolerance 0) at every chunk count around the span boundaries, with
and without ROOT finalization. No JAX program compiles here.
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_batch as jax_bb
from spacedrive_tpu_torch.ops import blake3_batch as bb

SPANS = [4, 64, 128]


def _n_chunks_cases():
    for span in SPANS:
        for n in sorted({1, 2, span - 1, span, span + 1, 2 * span, 2 * span + 1,
                         57, 101, 4096}):
            for root in (True, False):
                yield pytest.param(n, span, root, id=f"n{n}-span{span}-root{int(root)}")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes run faster on one intra-op thread, and the suite's
    other xdist workers keep their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n_chunks,span,root", list(_n_chunks_cases()))
def test_span_tops_and_fold_match_jax_tree_reduce(n_chunks, span, root):
    rng = np.random.default_rng(n_chunks * 1000 + span)
    # Row 0 fills the grid; the shorter rows leave spans past their end.
    n = np.array([n_chunks, max(1, n_chunks // 2 + 1), 1], np.int32)
    cvs = rng.integers(0, 2**32, size=(8, len(n), n_chunks), dtype=np.uint32)
    want = np.stack(jax_bb.tree_reduce(np, list(cvs), n, root=root), axis=1)
    got = bb.tree_reduce_spans(bb.words_to_tensor(cvs, "cpu"), torch.from_numpy(n),
                               span, root)
    np.testing.assert_array_equal(bb.tensor_to_words(got), want)
