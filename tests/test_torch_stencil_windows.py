"""The windows of the port's sharded lattice compositions (cop5615_gossip_
protocol_tpu_torch/parallel/fused_sharded.py ``shard_windows``, the
contract of csrc/shard.cuh): round j of a super-step computes only the
extended rows W_j that the middle still depends on. Checked on the CPU:

- the windowed plain super-step against the full-buffer one (every row of
  the buffer in every round, the JAX kernels' sweep): the middle rows and
  u bitwise, both algorithms, one round and the plan's CR rounds, from a
  mid-run state, at torus3d 125,000 in 2 shards (both plans; 6,072 pad
  lanes across the mod-n blend) and 4 (the streaming plan), grid2d 90,000
  in 2 (non-wrap) and ring 131,072 in 2 and 4; the windowed version
  writes no row of out or y outside its windows;
- every window against a brute-force backward cone over every slot (the
  source slot of every non-pad receiver of W_j along every class, as
  csrc/shard.cuh's shard_source names it), over lattice kinds, shard
  counts, both plans, shards and round counts;
- a buffer whose halo is too small for the super-step's shifts is
  refused."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.ops import fused, rng
from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded, fused_sharded

from test_torch_stencil_sharded import _ext, _planes, _same

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

SENTINEL = -0x3C3C3C3D


def _tier(kind, n, shards, algorithm, plan):
    """(spec, rolls, geom) of one plan ("vmem" the resident tier's, "hbm"
    the streaming tier's) for the config."""
    topo = build_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused",
                    n_devices=shards)
    tier = (fused_sharded.vmem_tier if plan == "vmem" else fused_hbm_sharded.hbm_tier)(
        topo, cfg, shards)
    return topo, cfg, tier


def _filled(ext):
    out = []
    for x in ext:
        t = torch.empty(x.shape, dtype=x.dtype)
        t.view(torch.int32).fill_(SENTINEL)
        out.append(t)
    return out


WINDOWED_CASES = [("torus3d", 125_000, 2, "vmem"), ("torus3d", 125_000, 2, "hbm"),
                  ("torus3d", 125_000, 4, "hbm"), ("grid2d", 90_000, 2, "hbm"),
                  ("ring", 131_072, 2, "vmem"), ("ring", 131_072, 4, "hbm")]


@pytest.mark.parametrize("full_cr", [False, True])
@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("kind,n,shards,plan", WINDOWED_CASES)
def test_windowed_superstep_is_the_full_buffer_one(kind, n, shards, plan, algorithm,
                                                   full_cr):
    topo, cfg, tier = _tier(kind, n, shards, algorithm, plan)
    geom = tier.geom
    kw = fused_sharded.protocol_kw(topo, cfg, geom, tier.rolls)
    rounds = geom.cr if full_cr else 1
    keys = fused.round_keys(rng.PRNGKey(0), 40, rounds)
    glob = _planes(topo.n, geom.R * 128, algorithm, "mid")
    full = ((0, geom.rows_ext),) * (rounds + 1)
    for s in range(shards):
        row0 = geom.row0(s)
        ext = [torch.from_numpy(e.copy()) for e in _ext(glob, geom.R, row0, geom.rows_ext)]
        windows = fused_sharded.shard_windows(kw["spec"], tier.rolls, geom, row0, rounds)
        out, y = _filled(ext), _filled(ext)
        u = fused_sharded.shard_superstep_plain(ext, out, y, keys, rounds, row0, **kw)
        ref_out, ref_y = _filled(ext), _filled(ext)
        ref_u = fused_sharded.shard_superstep_plain(ext, ref_out, ref_y, keys, rounds, row0,
                                                    **kw, windows=full)
        assert torch.equal(u, ref_u), (s, u, ref_u)
        mid = slice(geom.H, geom.H + geom.rows_loc)
        for a, b in zip(out, ref_out):
            assert _same(a[mid].numpy(), b[mid].numpy()), s
        # Rows that no round wrote keep the sentinel: out is written by the
        # rounds j with rounds - 1 - j even, y by the others.
        for planes, first in ((out, (rounds - 1) % 2), (y, rounds % 2)):
            written = np.zeros(geom.rows_ext, dtype=bool)
            for j in range(first, rounds, 2):
                lo, hi = windows[j + 1]
                written[lo:hi] = True
            for p in planes:
                assert (p.view(torch.int32)[~torch.from_numpy(written)] == SENTINEL).all()


def _brute_windows(topo, geom, rolls, row0, rounds):
    """The windows by the definition, over every slot: W_{j-1} is the
    smallest row range holding W_j and the shard_source slot of every
    non-pad receiver of W_j along every class."""
    n_ext = geom.rows_ext * 128
    x = np.arange(n_ext, dtype=np.int64)
    g = ((row0 + x // 128) % geom.R) * 128 + x % 128
    wins = [(geom.H, geom.H + geom.rows_loc)]
    for _ in range(rounds):
        lo, hi = wins[-1]
        recv = x[lo * 128:hi * 128]
        gr = g[lo * 128:hi * 128]
        recv, gr = recv[gr < topo.n], gr[gr < topo.n]
        rows = [lo, hi - 1]
        for d, e1, e2 in rolls:
            e = np.where(gr >= d, e1, e2)
            src = np.where(recv >= e, recv - e, recv - e + n_ext)
            if src.size:
                rows += [int(src.min()) // 128, int(src.max()) // 128]
        wins.append((min(rows), max(rows) + 1))
    return tuple(reversed(wins))


BRUTE_CASES = [("torus3d", 125_000, 2, "vmem"), ("torus3d", 125_000, 2, "hbm"),
               ("torus3d", 125_000, 4, "hbm"), ("torus3d", 27_000, 2, "hbm"),
               ("ring", 131_072, 2, "vmem"), ("ring", 131_072, 4, "hbm"),
               ("grid2d", 130_000, 2, "vmem"), ("grid2d", 90_000, 4, "hbm"),
               ("line", 65_536, 2, "hbm"), ("grid3d", 27_000, 2, "hbm")]


@settings(max_examples=40, deadline=None)
@given(case=st.sampled_from(BRUTE_CASES), algorithm=st.sampled_from(["push-sum", "gossip"]),
       shard=st.integers(0, 3), rounds=st.integers(1, 64))
def test_windows_are_the_backward_cone(case, algorithm, shard, rounds):
    kind, n, shards, plan = case
    topo, _cfg, tier = _tier(kind, n, shards, algorithm, plan)
    geom = tier.geom
    shard %= shards
    rounds = min(rounds, geom.cr)
    row0 = geom.row0(shard)
    spec = hbm.stencil_spec(topo)
    got = fused_sharded.shard_windows(spec, tier.rolls, geom, row0, rounds)
    assert got == _brute_windows(topo, geom, tier.rolls, row0, rounds)
    assert all(0 <= lo < hi <= geom.rows_ext for lo, hi in got)


def test_a_halo_too_small_for_the_shifts_is_refused():
    topo, _cfg, tier = _tier("torus3d", 125_000, 2, "gossip", "vmem")
    geom = tier.geom
    spec = hbm.stencil_spec(topo)
    # The plan's H covers CR = 4 rounds of shifts; a super-step of as many
    # rounds as the buffer has rows reaches across its ends (the window
    # grows by the class shifts, ~20 rows a round here).
    fused_sharded.shard_windows(spec, tier.rolls, geom, geom.row0(0), geom.cr)
    with pytest.raises(ValueError, match="wrap"):
        fused_sharded.shard_windows(spec, tier.rolls, geom, geom.row0(0), geom.rows_ext)
    # A row map that would wrap twice.
    whole = fused_sharded.ShardGeometry(geom.R, geom.R, geom.R, 1)
    with pytest.raises(ValueError, match="2R"):
        fused_sharded.shard_windows(spec, tier.rolls, whole, geom.R - 1, 1)
