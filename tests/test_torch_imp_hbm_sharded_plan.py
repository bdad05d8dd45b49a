"""The port's imp x HBM x sharded plan (cop5615_gossip_protocol_tpu_torch/
parallel/fused_imp_hbm_sharded.py) against the JAX package's, over a grid
of imp kind x population (perfect and not) x shard count x algorithm x pool
width: an accepting config gets the same geometry (H, rows_loc, PT,
layout), a refusing one the same reason, word for word; so do the gates
the port's SimConfig refuses itself (reference semantics, faults,
telemetry, bfloat16, step timing under overlap, the mass sentinel, a
delivery other than pool), given the JAX config's fields. The ladder
(``models/runner.sharded_tier``) names the composition exactly where the
JAX runner calls ``run_imp_hbm_sharded``, and otherwise gives the JAX
runner's reason; the single-device streaming tier's reasons
(``imp_hbm_support``) name the sharded composition as the JAX ones do."""

import dataclasses
import types

import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused_imp_hbm as jax_imp_hbm
from cop5615_gossip_protocol_tpu.parallel import fused_imp_hbm_sharded as jax_ih

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused_imp_hbm
from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

torch.set_num_threads(1)

# (kind, requested n): perfect squares and cubes, with and without pad
# lanes, and populations the honest lattices refuse.
CASES = (("imp3d", 27_000), ("imp3d", 27_001), ("imp3d", 4096), ("imp3d", 125_000),
         ("imp2d", 65_536), ("imp2d", 65_537), ("imp2d", 10_000), ("imp2d", 262_144))


def _geom(plan):
    if isinstance(plan, str):
        return plan
    *head, layout = plan
    return (*head, layout.n, layout.n_pad, layout.rows)


def _fields(jcfg):
    """The JAX config's fields as the port's plan reads them, for configs
    the port's SimConfig refuses to build (ROADMAP A6, A7, A12)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return types.SimpleNamespace(**fields, reference=jcfg.reference,
                                 faulted=jcfg.faulted)


@pytest.mark.parametrize("kind,n", CASES)
def test_plans_match_the_jax_plans(kind, n):
    jtopo, topo = jax_topology(kind, n), build_topology(kind, n)
    assert topo.n == jtopo.n
    for shards in (2, 3, 4, 8):
        for algorithm in ("gossip", "push-sum"):
            for pool_size in (2, 16, 32):
                kw = dict(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                          engine="fused", n_devices=shards, pool_size=pool_size)
                jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
                case = (kind, n, shards, algorithm, pool_size)
                assert _geom(ih.plan_imp_hbm_sharded(topo, cfg, shards)) == _geom(
                    jax_ih.plan_imp_hbm_sharded(jtopo, jcfg, shards)), case
                assert _geom(ih.plan_imp_hbm_sharded_shape(kind, n, cfg, shards)) == \
                    _geom(jax_ih.plan_imp_hbm_sharded_shape(kind, n, jcfg, shards)), case


@pytest.mark.parametrize("extra,words", [
    ({"semantics": "reference"}, "static extra edge"),
    ({"fault_rate": 0.1}, "failure models"),
    ({"telemetry": True}, "telemetry"),
    ({"dtype": "bfloat16"}, "float32 only"),
    ({"step_timing": True}, "step_timing"),
    ({"step_timing": True, "overlap_collectives": False}, None),
    ({"mass_tolerance": 1e-3, "algorithm": "push-sum"}, "mass-tolerance"),
    ({"delivery": "auto"}, "delivery='pool'"),
])
def test_gates_the_port_config_refuses_match_the_jax_plan(extra, words):
    kw = dict(n=27_000, topology="imp3d", algorithm="gossip", delivery="pool",
              engine="fused", n_devices=2)
    kw.update(extra)
    jcfg = JaxConfig(**kw)
    sem = kw.get("semantics", "batched")
    got = ih.plan_imp_hbm_sharded(build_topology("imp3d", 27_000, semantics=sem),
                                  _fields(jcfg), 2)
    want = jax_ih.plan_imp_hbm_sharded(jax_topology("imp3d", 27_000, semantics=sem),
                                       jcfg, 2)
    assert _geom(got) == _geom(want)
    assert (words is None) == (not isinstance(got, str))
    if words is not None:
        assert words in got


@pytest.mark.parametrize("algorithm", ["gossip", "push-sum"])
def test_past_the_single_device_cap(algorithm):
    """imp3d 520**3 (140,608,000 nodes, past the 2**27 single-device cap)
    in 4 shards, the population the card runs; and the plan's ceiling
    past 2**28 on 8 shards."""
    for n, shards in ((520**3, 4), (648**3, 8), (4096**3, 8)):
        kw = dict(n=n, topology="imp3d", algorithm=algorithm, delivery="pool",
                  engine="fused", n_devices=shards)
        got = ih.plan_imp_hbm_sharded_shape("imp3d", n, SimConfig(**kw), shards)
        want = jax_ih.plan_imp_hbm_sharded_shape("imp3d", n, JaxConfig(**kw), shards)
        assert _geom(got) == _geom(want)
        assert isinstance(got, str) == (n == 4096**3)
    H, rows_loc, PT, layout = ih.plan_imp_hbm_sharded_shape(
        "imp3d", 520**3, SimConfig(n=520**3, topology="imp3d", algorithm=algorithm,
                                   delivery="pool", n_devices=4), 4)
    assert (H, rows_loc, PT, layout.rows, layout.n_pad - layout.n) == (
        2944, 274_688, 2048, 1_098_752, 32_256)


def test_lattice_window_plan_matches_the_jax_one():
    """The lattice-window grouping the plan's budgets read."""
    for kind, n in (("imp3d", 27_000), ("imp2d", 65_536), ("imp3d", 1_000_000)):
        layout = ih.build_pool_layout(n)
        for rows_ext, pt in ((320, 64), (576, 64), (4608, 512)):
            assert ih._imp_lat_plan(kind, layout, rows_ext, pt) == \
                jax_ih._imp_lat_plan(kind, layout, rows_ext, pt)


def _jax_ladder(jtopo, jcfg, monkeypatch):
    """What the JAX runner does with an n_devices > 1 fused config: "run"
    if it calls run_imp_hbm_sharded, else the reason it raises."""
    def called(*args, **kw):
        raise LookupError("run_imp_hbm_sharded")

    monkeypatch.setattr(jax_ih, "run_imp_hbm_sharded", called)
    try:
        jax_runner.run(jtopo, jcfg)
    except LookupError:
        return "run"
    except ValueError as e:
        return str(e)
    raise AssertionError("the JAX runner neither ran nor refused")


@pytest.mark.parametrize("kind,n", [("imp3d", 27_000), ("imp3d", 4096),
                                    ("imp2d", 65_536), ("imp2d", 10_000)])
def test_ladder_matches_the_jax_ladder(kind, n, monkeypatch):
    jtopo, topo = jax_topology(kind, n), build_topology(kind, n)
    for shards in (2, 3, 4, 8):
        for pool_size in (2, 32):
            for delivery in ("pool", "auto"):
                kw = dict(n=n, topology=kind, algorithm="gossip", delivery=delivery,
                          engine="fused", n_devices=shards, pool_size=pool_size)
                jcfg = JaxConfig(**kw)
                cfg = SimConfig(**kw) if delivery == "pool" else _fields(jcfg)
                jax_does = _jax_ladder(jtopo, jcfg, monkeypatch)
                tier, reason, item = runner.sharded_tier(topo, cfg)
                case = (kind, n, shards, pool_size, delivery)
                if delivery == "pool":
                    assert (tier, item) == ("imp_hbm_sharded", "B12"), case
                    plan = jax_ih.plan_imp_hbm_sharded(jtopo, jcfg, shards)
                    assert jax_does == "run", case
                    assert reason == (None if not isinstance(plan, str) else
                                      f"engine='fused' with n_devices={shards} "
                                      f"unavailable: {plan}"), case
                else:
                    assert tier == "stencil_hbm_sharded" and reason == jax_does, case
                    assert "VMEM composition" in reason


def test_single_device_reasons_name_the_sharded_composition():
    for kind, n, shards in (("imp3d", 27_000, 2), ("imp3d", 27_000, None),
                            ("imp2d", 65_536, 4)):
        kw = dict(n=n, topology=kind, algorithm="gossip", delivery="pool",
                  n_devices=shards)
        got = fused_imp_hbm.imp_hbm_support(build_topology(kind, n), SimConfig(**kw))
        want = jax_imp_hbm.imp_hbm_support(jax_topology(kind, n), JaxConfig(**kw))
        assert got == want
        assert (got is None) == (shards is None)
    # Past the cap: the port's predicate on a stand-in for the imp3d 513**3
    # build (whose adjacency would take minutes), against the JAX reason's
    # text (its ops/fused_imp_hbm.py).
    n = 513**3
    big = dataclasses.replace(build_topology("imp3d", 27_000), n=n, n_requested=n,
                              target_count=n)
    reason = fused_imp_hbm.imp_hbm_support(
        big, SimConfig(n=n, topology="imp3d", delivery="pool"))
    assert reason == (
        f"population {n} exceeds the single-device HBM-plane budget "
        f"({2**27} nodes); n_devices > 1 shards past it "
        "(parallel/fused_imp_hbm_sharded.py)")
