"""The port's chaos plane against the JAX package's.

- The 13 declared fault points are the JAX package's, by name and kinds.
- ``parse_spec`` gives equal results on a set of specs, and refuses the
  same bad ones.
- The same spec and seed give the same draws, site filters included.
- Every fault point but ``fleet.poll`` (whose site comes with the fleet
  observatory) fires at its site in the port: an ``ast`` scan finds each
  name in a ``chaos.hit`` call of the module the declaration names.
"""

import ast
from pathlib import Path

import pytest

from spacedrive_tpu import chaos as jc
from spacedrive_tpu_torch import chaos as pc

ROOT = Path(__file__).resolve().parent.parent

SPECS = [
    "",
    "store.commit=error:0.3",
    "p2p.tunnel.frame=drop:0.01,delay:50ms",
    "sync.clone.page=disconnect:0.5;api.ws.send=wedge:0.1",
    "stage.native.read=delay:0.2s:0.5,error:0.1,corrupt:0.05",
    "  api.http.dispatch = delay:5ms ; store.group_commit=error ",
    "incidents.write=delay:1",
]
BAD = [
    "nope.point=error",
    "store.commit=drop",
    "store.commit",
    "store.commit=error:1.5",
    "store.commit=delay:-1",
    "store.commit=bogus",
]


def test_the_declared_fault_points_are_the_jax_packages():
    mine = {n: p.kinds for n, p in pc.FAULTS.items()}
    theirs = {n: p.kinds for n, p in jc.FAULTS.items()}
    assert mine == theirs and len(mine) == 13


def _plain(parsed):
    return {n: [(f.kind, f.prob, f.delay_s) for f in fs] for n, fs in parsed.items()}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_agrees(spec):
    assert _plain(pc.parse_spec(spec)) == _plain(jc.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_both_refuse_a_bad_spec(spec):
    with pytest.raises(jc.ChaosSpecError):
        jc.parse_spec(spec)
    with pytest.raises(pc.ChaosSpecError):
        pc.parse_spec(spec)


@pytest.mark.parametrize("seed", [0, 7, 4242])
def test_the_same_seed_gives_the_same_draws(seed):
    spec = "p2p.tunnel.frame=drop:0.3,corrupt:0.2;store.commit=error:0.5,delay:1ms:0.5"
    sites = [("p2p.tunnel.frame", None), ("store.commit", ("delay", "error")),
             ("p2p.tunnel.frame", ("delay", "disconnect", "wedge")),
             ("store.commit", ("error",))] * 50
    draws = []
    for mod in (pc, jc):
        mod.arm(spec, seed=seed)
        try:
            draws.append([(f.kind, f.delay_s) if f is not None else None
                          for f in (mod.hit(n, only=o) for n, o in sites)])
        finally:
            mod.disarm()
    assert draws[0] == draws[1]
    assert any(d is not None for d in draws[0]) and any(d is None for d in draws[0])


def _hit_sites():
    out = {}
    for path in (ROOT / "spacedrive_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("hit", "armed_point") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                out.setdefault(node.args[0].value, set()).add(
                    path.relative_to(ROOT / "spacedrive_tpu_torch").as_posix())
    return out


def test_every_point_but_the_fleets_fires_at_its_declared_site():
    sites = _hit_sites()
    for name, point in pc.FAULTS.items():
        if name == "fleet.poll":
            assert name not in sites  # waits for fleet.py
            continue
        module = point.site.split()[0]
        assert module in sites.get(name, set()), (name, point.site, sites.get(name))
