"""The port's sharded lattice plans (cop5615_gossip_protocol_tpu_torch/
parallel/fused_sharded.py ``plan_fused_sharded``, parallel/fused_hbm_sharded.py
``plan_stencil_hbm_sharded``) against the JAX package's, over a grid of
lattice kind x population x shard count x algorithm x chunk_rounds: an
accepting config gets the same geometry (H, rows_loc, CR, PT, layout), a
refusing one the same reason, word for word. The ladder
(``models/runner.sharded_tier``) picks the JAX runner's composition: the
resident one while its plan accepts, else the streaming one, else neither
with both reasons. Small populations only: the JAX plans scan the
topology on every call."""

import dataclasses

import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.parallel import fused_hbm_sharded as jax_fh
from cop5615_gossip_protocol_tpu.parallel import fused_sharded as jax_fs

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded, fused_sharded

torch.set_num_threads(1)

SIZES = {"torus3d": (27_000, 125_000, 262_144), "ring": (1000, 131_072, 200_000),
         "line": (65_536, 131_072), "grid2d": (10_000, 90_000, 130_000, 262_144),
         "grid3d": (64_000, 125_000), "ref2d": (90_000, 262_144)}
CASES = [(kind, n) for kind, sizes in SIZES.items() for n in sizes]


def _sem(kind):
    return "reference" if kind == "ref2d" else "batched"


def _geom(plan):
    if isinstance(plan, str):
        return plan
    *head, layout = plan
    return (*head, layout.n, layout.n_pad, layout.rows)


@pytest.mark.parametrize("kind,n", CASES)
def test_plans_match_the_jax_plans(kind, n):
    jtopo = jax_topology(kind, n, semantics=_sem(kind))
    topo = build_topology(kind, n, semantics=_sem(kind))
    for shards in (2, 4, 8):
        for algorithm in ("gossip", "push-sum"):
            if algorithm == "push-sum" and kind == "ref2d":
                continue  # reference push-sum is the single walk (A7a)
            for chunk_rounds in (1, 8, 4096):
                kw = dict(n=n, topology=kind, algorithm=algorithm, engine="fused",
                          n_devices=shards, chunk_rounds=chunk_rounds,
                          semantics=_sem(kind))
                jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
                case = (kind, n, shards, algorithm, chunk_rounds)
                want_vmem = jax_fs.plan_fused_sharded(jtopo, jcfg, shards)
                want_hbm = jax_fh.plan_stencil_hbm_sharded(jtopo, jcfg, shards)
                assert _geom(fused_sharded.plan_fused_sharded(topo, cfg, shards)) == \
                    _geom(want_vmem), case
                assert _geom(fused_hbm_sharded.plan_stencil_hbm_sharded(
                    topo, cfg, shards)) == _geom(want_hbm), case
                tier, reason, item = runner.sharded_tier(topo, cfg)
                if not isinstance(want_vmem, str):
                    assert (tier, reason, item) == ("fused_sharded", None, "B10"), case
                elif not isinstance(want_hbm, str):
                    assert (tier, reason, item) == ("stencil_hbm_sharded", None,
                                                    "B11"), case
                else:
                    assert tier == "stencil_hbm_sharded" and reason == (
                        f"engine='fused' with n_devices={shards} unavailable: VMEM "
                        f"composition: {want_vmem}; HBM-streaming composition: "
                        f"{want_hbm}"), case


@pytest.mark.parametrize("kind,n,shards", [("torus3d", 125_000, 4), ("ring", 131_072, 2),
                                            ("grid2d", 90_000, 4), ("ref2d", 262_144, 2)])
def test_delivery_plan_matches_the_jax_window_plan(kind, n, shards):
    """The window grouping the streaming plan's budgets read (classes,
    groups, margin, blend) is the JAX kernel's, at the plan's geometry."""
    jtopo = jax_topology(kind, n, semantics=_sem(kind))
    topo = build_topology(kind, n, semantics=_sem(kind))
    cfg = SimConfig(n=n, topology=kind, algorithm="gossip", engine="fused",
                    n_devices=shards, semantics=_sem(kind))
    H, rows_loc, CR, PT, layout = fused_hbm_sharded.plan_stencil_hbm_sharded(
        topo, cfg, shards)
    jlayout = jax_fh.plan_stencil_hbm_sharded(jtopo, JaxConfig(
        n=n, topology=kind, algorithm="gossip", engine="fused", n_devices=shards,
        semantics=_sem(kind)), shards)[-1]
    rows_ext = rows_loc + 2 * H
    for pt in (PT, 256):
        assert fused_hbm_sharded._shard_delivery_plan(topo, layout, rows_ext, pt) == \
            jax_fh._shard_delivery_plan(jtopo, jlayout, rows_ext, pt)


def test_reference_geometries():
    """The shapes the card runs (their plans on spec-size topologies)."""
    def plans(kind, n, shards, algorithm="gossip"):
        topo = build_topology(kind, n)
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused",
                        n_devices=shards)
        return (fused_sharded.plan_fused_sharded(topo, cfg, shards),
                fused_hbm_sharded.plan_stencil_hbm_sharded(topo, cfg, shards))

    vmem, _ = plans("torus3d", 1_000_000, 2)
    assert vmem[:3] == (4096, 4096, 8)  # the halo is a whole shard
    vmem, _ = plans("grid2d", 1_000_000, 2, "push-sum")
    assert vmem[:3] == (3584, 4096, 8)
    vmem, _ = plans("ring", 131_072, 2)
    assert vmem[:3] == (512, 512, 64)


def test_implicit_and_imp_kinds_keep_their_compositions():
    topo = build_topology("imp3d", 27_000)
    cfg = SimConfig(n=27_000, topology="imp3d", algorithm="gossip", engine="fused",
                    delivery="pool", n_devices=2)
    assert runner.sharded_tier(topo, cfg) == ("imp_hbm_sharded", None, "B12")
    # The imp composition runs (parallel/fused_imp_hbm_sharded.py).
    res = run(topo, dataclasses.replace(cfg, max_rounds=2), devices=["cpu"] * 2)
    assert res.rounds == 2
    jtopo = jax_topology("imp3d", 27_000)
    jcfg = JaxConfig(n=27_000, topology="imp3d", algorithm="gossip", engine="fused",
                     delivery="pool", n_devices=2)
    assert fused_hbm_sharded.plan_stencil_hbm_sharded(topo, cfg, 2) == \
        jax_fh.plan_stencil_hbm_sharded(jtopo, jcfg, 2)
    full = SimConfig(n=1000, topology="full", algorithm="gossip", engine="fused",
                     delivery="pool", n_devices=2)
    jfull = JaxConfig(n=1000, topology="full", algorithm="gossip", engine="fused",
                      delivery="pool", n_devices=2)
    for mine, theirs in ((fused_sharded.plan_fused_sharded, jax_fs.plan_fused_sharded),
                         (fused_hbm_sharded.plan_stencil_hbm_sharded,
                          jax_fh.plan_stencil_hbm_sharded)):
        assert mine(build_topology("full", 1000), full, 2) == theirs(
            jax_topology("full", 1000), jfull, 2)


def test_a_config_both_plans_refuse_raises_both_reasons():
    topo = build_topology("grid2d", 10_000)
    cfg = SimConfig(n=10_000, topology="grid2d", algorithm="gossip", engine="fused",
                    n_devices=4)
    with pytest.raises(ValueError, match="VMEM composition: .*HBM-streaming composition"):
        run(topo, cfg, devices=["cpu"] * 4)
