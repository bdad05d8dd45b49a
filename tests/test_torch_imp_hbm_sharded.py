"""The kernel oracle of the port's imp x HBM x sharded composition
(cop5615_gossip_protocol_tpu_torch/parallel/fused_imp_hbm_sharded.py): one
round of each JAX shard kernel (rows 18-19 of PERF.md's table,
make_pushsum_imp_hbm_shard_chunk and make_gossip_imp_hbm_shard_chunk, in
Pallas interpret mode) on every shard, against the port's plain shard round
on the same global state, bitwise on every middle plane and u.

The JAX kernels take the exchange's planes: the halo-extended shard (its
windowed planes with the lattice mirror margin) and the gathered copy with
its pool mirror margin, built here in numpy by their definition from one
global state made from a seed. The port's round reads the global state
itself (no halo). Push-sum s is uniform in [1, 2) and w in [0.5, 1.5), so
no sum is subnormal: the JAX kernels halve after the class sums, the port
before them, and the two agree exactly but on subnormals. Cases: imp3d
27,000 in 2 shards (both algorithms; 38,536 pad lanes, so the pool
windows' d / d + Z blend is live), in 4 (push-sum), and imp2d 65,536 in 2
(gossip; no pad)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.parallel import fused_imp_hbm_sharded as jax_ih

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih
from cop5615_gossip_protocol_tpu_torch.utils import carry

torch.set_num_threads(1)

SEED = 5
POOL = 4
ROUND = 7  # the absolute round whose keys and pool the round draws


def _state(algorithm, layout, rumor_target):
    """A global [R, 128] state from seed 11: push-sum (s, w, term, conv)
    with some term counts and conv flags set, gossip (count, active, conv)
    with half the nodes holding the rumor and those at the target
    converged; pad lanes as a run holds them."""
    rs = np.random.default_rng(11)
    R = layout.rows
    real = (np.arange(layout.n_pad) < layout.n).reshape(R, 128)
    if algorithm == "push-sum":
        return (np.where(real, rs.uniform(1, 2, (R, 128)), 0).astype(np.float32),
                np.where(real, rs.uniform(0.5, 1.5, (R, 128)), 1).astype(np.float32),
                np.where(real, rs.integers(0, 3, (R, 128)), 0).astype(np.int32),
                (real & (rs.random((R, 128)) < 0.2)).astype(np.int32))
    active = (real & (rs.random((R, 128)) < 0.5)).astype(np.int32)
    count = (rs.integers(0, rumor_target + 1, (R, 128)) * active).astype(np.int32)
    return count, active, (count >= rumor_target).astype(np.int32)


def _streams(n):
    """The round's key, pool and choice key from both packages, which must
    agree word for word; returns (JAX arrays, port lists)."""
    key = jax.random.PRNGKey(SEED)
    jax_s = (jax_fused.round_keys(key, ROUND, 1)[0],
             jax_fused_pool.round_offsets(key, ROUND, 1, POOL, n)[0],
             jax_fused_imp.choice_round_keys(key, ROUND, 1)[0])
    tkey = carry.key_from_numpy(np.asarray(key))
    port_s = (fused.round_keys(tkey, ROUND, 1)[0].tolist(),
              fused_pool.round_offsets(tkey, ROUND, 1, POOL, n)[0].tolist(),
              fused_imp.choice_round_keys(tkey, ROUND, 1)[0].tolist())
    for a, b in zip(jax_s, port_s):
        assert [int(x) for x in np.asarray(a)] == b
    return jax_s, port_s


@pytest.mark.parametrize("kind,n,shards,algorithm", [
    ("imp3d", 27_000, 2, "gossip"), ("imp3d", 27_000, 2, "push-sum"),
    ("imp3d", 27_000, 4, "push-sum"), ("imp2d", 65_536, 2, "gossip"),
])
def test_round_matches_the_jax_shard_kernel(kind, n, shards, algorithm):
    kw = dict(n=n, topology=kind, algorithm=algorithm, delivery="pool", engine="fused",
              n_devices=shards, pool_size=POOL, seed=SEED)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jtopo, topo = jax_topology(kind, n), build_topology(kind, n)
    H, rows_loc, PT, layout = jax_ih.plan_imp_hbm_sharded(jtopo, jcfg, shards)
    assert ih.plan_imp_hbm_sharded(topo, cfg, shards)[:3] == (H, rows_loc, PT)
    R, MP = layout.rows, PT + 16
    planes = _state(algorithm, layout, cfg.resolved_rumor_target)
    (keys, offs, ckeys), (tkeys, toffs, tckeys) = _streams(n)
    if algorithm == "push-sum":
        make, port, windowed = (jax_ih.make_pushsum_imp_hbm_shard_chunk,
                                ih.make_pushsum_imp_hbm_shard_chunk, (0, 1))
    else:
        make, port, windowed = (jax_ih.make_gossip_imp_hbm_shard_chunk,
                                ih.make_gossip_imp_hbm_shard_chunk, (1,))
    jfn, _, M_lat = make(jtopo, jcfg, H, rows_loc, PT, layout, interpret=True)
    jfn = jax.jit(jfn)
    tfn = port(topo, cfg, H, rows_loc, PT, layout)
    # The JAX exchange: the gathered windowed planes with the pool mirror
    # margin; per shard, every plane's extended ring from row0 with, on the
    # windowed planes, the lattice mirror margin.
    gathered = tuple(jnp.asarray(np.concatenate([planes[i], planes[i][:MP]]))
                     for i in windowed)
    tstate = tuple(torch.from_numpy(p.copy()) for p in planes)
    counts = []
    for dev in range(shards):
        row0 = (dev * rows_loc - H + 2 * R) % R
        ext = []
        for i, p in enumerate(planes):
            e = np.take(p, (row0 + np.arange(rows_loc + 2 * H)) % R, axis=0)
            ext.append(jnp.asarray(np.concatenate([e, e[:M_lat]]) if i in windowed else e))
        jout, ju = jfn(tuple(ext), gathered, keys, offs, ckeys, jnp.int32(row0),
                       jnp.int32(dev))
        tout, tu = tfn(tstate, tkeys, toffs, tckeys, dev * rows_loc)
        assert int(ju) == int(tu), dev
        counts.append(int(tu))
        for a, b in zip(jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.float32:
                assert np.isfinite(a).all()
                assert not (np.abs(a[a != 0]) < np.finfo(np.float32).tiny).any()
                a, b = a.view(np.int32), b.view(np.int32)
            assert (a == b).all(), dev
    # Real nodes converge in every case: the data holds converged nodes.
    assert sum(counts) > 0


def test_plain_round_is_the_single_device_round():
    """The port's shard rounds, joined, are one round of the single-device
    imp chunk (ops/fused_imp) on the same planes, bitwise."""
    n, shards = 27_000, 4
    topo = build_topology("imp3d", n)
    spec = fused_imp.imp_spec(topo)
    layout = fused_pool.build_pool_layout(n)
    rows_loc = layout.rows // shards
    (_, _, _), (tkeys, toffs, tckeys) = _streams(n)
    for algorithm in ("gossip", "push-sum"):
        planes = tuple(torch.from_numpy(p.copy()) for p in _state(algorithm, layout, 10))
        stream = (torch.tensor([tkeys]), torch.tensor([toffs], dtype=torch.int32),
                  torch.tensor([tckeys]))
        if algorithm == "push-sum":
            kw = {"spec": spec, "delta": 1e-6, "term_rounds": 3}
            single, _ = fused_imp.pushsum_imp_chunk_plain(planes, *stream, 0, 1,
                                                          target=n + 1, **kw)
            plain = ih.pushsum_imp_hbm_shard_round_plain
        else:
            kw = {"spec": spec, "rumor_target": 10, "suppress": False}
            single, _ = fused_imp.gossip_imp_chunk_plain(planes, *stream, 0, 1,
                                                         target=n + 1, **kw)
            plain = ih.gossip_imp_hbm_shard_round_plain
        outs = [plain(planes, tkeys, toffs, tckeys, s * rows_loc, rows_loc, **kw)
                for s in range(shards)]
        for p, want in enumerate(single):
            got = torch.cat([o[0][p] for o in outs])
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (algorithm, p)
        assert sum(int(u) for _, u in outs) == int(single[-1].sum())


@functools.lru_cache(maxsize=None)
def _marks(n, lo, hi, pool_size):
    topo = build_topology("imp3d", n)
    (_, _, _), (tkeys, _, tckeys) = _streams(n)
    return fused_imp.imp_marks(fused_imp.imp_spec(topo), tkeys, tckeys, pool_size, lo, hi)


def test_marks_at_any_rows_are_the_whole_ring_marks():
    """imp_marks over a row range, its 8-row choice groups cut anywhere,
    is the whole ring's marks over those rows."""
    n = 27_000
    whole = _marks(n, 0, 512, POOL)
    for lo, hi in ((0, 8), (3, 11), (200, 213), (211, 212), (256, 512)):
        assert torch.equal(_marks(n, lo, hi, POOL), whole[lo * 128:hi * 128]), (lo, hi)
