"""The port's kernel registry, the twin of the JAX package's jit registry.

- Each contract stands for a JAX ``declare_jit`` contract of the same
  name (but the port's own fold), names a function of the port that
  exists, and launches only kernel forms the wrappers count; the JAX
  contracts without a counterpart are the ones the module lists.
- An ``io`` scope on an undeclared name records a ``host_transfer``
  violation (raise mode asks to raise, as in the JAX package); a declared
  one counts into ``sd_jit_declared_transfers_total{fn}``.
- ``device_scope`` counts launches under its label; nested scopes count
  under the innermost; the guard level follows the sanitizer's mode and
  the flag. The guard's raise case is a ``cuda`` test
  (tests/test_torch_cuda.py).
"""

import importlib

import pytest

from spacedrive_tpu.ops import jit_registry as jr
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.ops import blake3_cuda, hamming_cuda, kernel_registry as kr

WITHOUT_COUNTERPART = {"blake3.sharded", "hamming.sharded", "hamming.pyramid", "blake3.donated",
                       "hamming.tile", "hamming.refine", "hamming.leaf_masks",
                       "staging.h2d_probe"}


def test_each_contract_stands_for_a_jax_contract():
    assert len(jr.CONTRACTS) == 22
    mine = {c.replaces for c in kr.CONTRACTS.values() if c.replaces}
    assert mine == set(jr.CONTRACTS) - WITHOUT_COUNTERPART
    for c in kr.CONTRACTS.values():
        if c.replaces:
            assert c.name == c.replaces
            assert c.host_transfer == jr.CONTRACTS[c.name].host_transfer, c.name
    assert [c.name for c in kr.CONTRACTS.values() if not c.replaces] == ["blake3.tree_fold"]


@pytest.mark.parametrize("name", sorted(kr.CONTRACTS))
def test_each_contract_names_a_port_function_and_counted_forms(name):
    c = kr.CONTRACTS[name]
    path, qual = c.site.split("::")
    mod = importlib.import_module(path[:-3].replace("/", "."))
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    forms = set(blake3_cuda.launches) | set(hamming_cuda.launches)
    assert set(c.kernels) <= forms
    assert c.shape_buckets.strip()


def _armed(mode):
    got = []
    kr.arm(mode, lambda kind, detail, may_raise: got.append((kind, may_raise)))
    return got


def test_an_undeclared_io_is_a_violation_and_a_declared_one_counts():
    got = _armed("count")
    try:
        with kr.io("no.such.fetch"):
            pass
        assert got == [("host_transfer", True)]
        before = telemetry.JIT_DECLARED_TRANSFERS.labels(fn="cas.ids").value
        with kr.io("cas.ids"):
            pass
        assert telemetry.JIT_DECLARED_TRANSFERS.labels(fn="cas.ids").value == before + 1
        with kr.io("hamming.near_mask"):  # declared, but not a host transfer
            pass
        assert got[-1] == ("host_transfer", True) and len(got) == 2
    finally:
        kr.disarm()
    with kr.io("no.such.fetch"):  # disarmed: nothing recorded
        pass
    assert len(got) == 2


def test_device_scopes_count_launches_under_their_label():
    kr.reset_scope_counts()
    with kr.device_scope("identify.hash"):
        kr.note_launch(blake3_cuda.FAST)
        with kr.device_scope("cas_ids/cuda"):
            kr.note_launch(blake3_cuda.FAST)
            kr.note_launch(blake3_cuda.FOLD)
    kr.note_launch(hamming_cuda.NEAR_MASK)
    assert kr.scope_counts() == {("identify.hash", blake3_cuda.FAST): 1,
                                 ("cas_ids/cuda", blake3_cuda.FAST): 1,
                                 ("cas_ids/cuda", blake3_cuda.FOLD): 1,
                                 ("", hamming_cuda.NEAR_MASK): 1}
    kr.reset_scope_counts()
    assert kr.launch_counts().keys() == set(blake3_cuda.launches) | set(hamming_cuda.launches)


@pytest.mark.parametrize("mode,flag,level", [
    ("raise", "auto", "error"), ("count", "auto", "warn"), ("count", "raise", "error"),
    ("raise", "log", "warn"), ("raise", "off", None)])
def test_the_guard_level_follows_the_mode_and_the_flag(monkeypatch, mode, flag, level):
    monkeypatch.setenv("SDTPU_TRANSFER_GUARD", flag)
    _armed(mode)
    try:
        assert kr._guard_level() == level
        with kr.device_scope("x"):  # no CUDA here: the mode stays torch's default
            assert kr.guard_mode() == "default"
    finally:
        kr.disarm()
    assert kr._guard_level() is None
