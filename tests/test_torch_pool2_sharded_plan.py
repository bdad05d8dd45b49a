"""The port's replicated-pool2 plan (cop5615_gossip_protocol_tpu_torch/
parallel/pool2_sharded.py) against the JAX package's: over a grid of
populations, shard counts, pool widths and wires, an accepting config gets
the same geometry (rows_loc, processing tile, layout) and wire, a refusing
one the same reason; the band margin and the band starts agree; and the
VMEM replicated composition's plan, which the ladder tries first, agrees
too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.parallel import fused_pool_sharded as jax_vmem
from cop5615_gossip_protocol_tpu.parallel import pool2_sharded as jax_p2

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel import fused_pool_sharded, pool2_sharded

torch.set_num_threads(1)

SIZES = (20_000, 65_536, 70_000, 100_000, 120_000, 131_072, 262_144, 2_097_153,
         16_777_216, 16_777_217, 2**27)


def _plans(n, n_dev, pool_size, wire, algorithm="push-sum"):
    kw = dict(n=n, topology="full", algorithm=algorithm, delivery="pool",
              pool_size=pool_size, pool2_wire=wire, n_devices=n_dev,
              engine="fused")
    got = pool2_sharded.plan_pool2_sharded(build_topology("full", n),
                                           SimConfig(**kw), n_dev)
    want = jax_p2.plan_pool2_sharded(jax_topology("full", n), JaxConfig(**kw), n_dev)
    return got, want


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_plan_matches_the_jax_plan(n, n_dev):
    for pool_size in (2, 4, 16):
        for wire in ("auto", "all_gather", "reduce_scatter"):
            for algorithm in ("push-sum", "gossip"):
                got, want = _plans(n, n_dev, pool_size, wire, algorithm)
                case = (n, n_dev, pool_size, wire, algorithm)
                if isinstance(want, str):
                    assert got == want, case
                    continue
                rows_loc, pt, layout, resolved = got
                j_rows_loc, j_pt, j_layout, j_resolved = want
                assert (rows_loc, pt, resolved) == (j_rows_loc, j_pt, j_resolved), case
                assert (layout.n, layout.n_pad, layout.rows) == (
                    j_layout.n, j_layout.n_pad, j_layout.rows), case
                assert pool2_sharded.band_margin(layout) == jax_p2.band_margin(j_layout)


@pytest.mark.parametrize("n,n_dev,wire,margin", [
    (70_000, 4, "all_gather", None),        # the band margin exceeds a shard
    (120_000, 4, "reduce_scatter", 112),
    (200_000, 4, "reduce_scatter", 512),
    (131_072, 4, "reduce_scatter", 16),
    (16_777_216, 4, "reduce_scatter", 16),
])
def test_reference_geometries(n, n_dev, wire, margin):
    got, _ = _plans(n, n_dev, 2, "auto")
    rows_loc, pt, layout, resolved = got
    assert resolved == wire
    assert layout.n_pad > n if n % 65_536 else layout.n_pad == n
    if margin is not None:
        assert pool2_sharded.band_margin(layout) == margin
    if n == 16_777_216:
        assert (rows_loc, pt) == (32_768, 2048)


def test_refusals_name_their_reason():
    got, _ = _plans(16_777_217, 4, 2, "auto")
    assert got.startswith("no processing tile divides")
    got, _ = _plans(70_000, 4, 2, "reduce_scatter")
    assert "band margin (504 rows) exceeds the 256-row shard" in got


@pytest.mark.parametrize("n", [70_000, 120_000, 2_097_153, 16_777_216])
def test_band_starts_match(n):
    layout = fused_pool.build_pool_layout(n)
    j_layout = jax_fused_pool.build_pool_layout(n)
    rng = np.random.default_rng(n)
    offs = rng.integers(1, n, size=16).astype(np.int32)
    want = np.asarray(jax_p2.band_starts(jnp.asarray(offs), j_layout))
    assert pool2_sharded.band_starts(offs.tolist(), layout) == want.tolist()


@pytest.mark.parametrize("n", [20_000, 70_000, 2**21, 2**21 + 1])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_vmem_plan_matches_the_jax_plan(n, n_dev):
    kw = dict(n=n, topology="full", algorithm="gossip", delivery="pool",
              pool_size=4, n_devices=n_dev, engine="fused")
    got = fused_pool_sharded.plan_fused_pool_sharded(
        build_topology("full", n), SimConfig(**kw), n_dev)
    want = jax_vmem.plan_fused_pool_sharded(jax_topology("full", n), JaxConfig(**kw),
                                            n_dev)
    if isinstance(want, str):
        assert got == want
    else:
        assert got[0] == want[0] and got[1].rows == want[1].rows
