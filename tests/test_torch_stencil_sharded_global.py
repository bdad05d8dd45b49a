"""Global termination in the port's sharded lattice compositions (cop5615_
gossip_protocol_tpu_torch/parallel/fused_sharded.py, row 15, the resident
one, and parallel/fused_hbm_sharded.py, row 16, the streaming one) with
their shards placed on the CPU (``devices=["cpu"] * S``), where the wrappers
run their plain versions. torus3d 125,000 runs resident in 2 shards and
streaming in 4. Bitwise throughout:

- whole push-sum runs under termination='global', 2 and 4 shards, the
  verdict's overlap on and off, from the initial state with delta=1e-1 (the
  JAX package's own sharded global tests) and from a crafted state (one
  ratio everywhere but three nodes, at round 1000: the verdict fires a few
  rounds in): rounds, converged count, estimate and every plane are the
  port's single-device global run, and the rounds are the JAX chunked
  engine's (from the crafted state its planes too);
- the verdict on a super-step's first, middle and last round (a run capped
  a few rounds in and resumed, so the stop round falls there);
- the capped rerun's windows: a super-step's middle rows after ``cap``
  rounds under the windows of the whole super-step are those of a
  super-step of ``cap`` rounds, at caps 1, CR - 1, an odd and an even one,
  and the output lands in the cap's parity;
- one super-step's counts: term and conv stay, and the shards' u sum to
  each round's real nodes whose ratio moved past delta * max(|s/w|, 1).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.models.pushsum import PushSumState
from cop5615_gossip_protocol_tpu_torch.ops import fused, rng
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded as fh
from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

torch.set_num_threads(1)

N = 125_000
START = 1000
EPS = 8e-6
TIERS = {2: "fused_sharded", 4: "stencil_hbm_sharded"}


@functools.lru_cache(maxsize=None)
def _topo():
    return build_topology("torus3d", N)


def _crafted():
    """The canonical [n] crafted state: s = w = 1 but EPS more s at three
    nodes, term and conv 0."""
    s = np.ones(N, np.float32)
    s[[5, N // 3, 2 * N // 3 + 7]] = np.float32(1.0 + EPS)
    return (s, np.ones(N, np.float32), np.zeros(N, np.int32), np.zeros(N, bool))


def _start(crafted):
    if not crafted:
        return {}
    return {"start_state": PushSumState(*(torch.from_numpy(x.copy()) for x in _crafted())),
            "start_round": START}


def _fields(crafted, **kw):
    delta = {} if crafted else {"delta": 1e-1}
    return dict(n=N, topology="torus3d", algorithm="push-sum", termination="global",
                max_rounds=2000 + START, **delta, **kw)


def _same_state(a, b):
    for x, y in zip(a, b):
        x, y = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@functools.lru_cache(maxsize=None)
def _single(crafted):
    cfg = SimConfig(engine="fused", **_fields(crafted))
    return run(_topo(), cfg, device="cpu", **_start(crafted))


@functools.lru_cache(maxsize=None)
def _jax(crafted):
    start = {}
    if crafted:
        start = {"start_state": jax_pushsum.PushSumState(*(jnp.asarray(x)
                                                           for x in _crafted())),
                 "start_round": START}
    final = {}
    res = jax_runner.run(jax_topology("torus3d", N),
                         JaxConfig(engine="chunked", **_fields(crafted)),
                         on_chunk=lambda r, s: final.__setitem__("s", s), **start)
    return res, final["s"]


def _sharded(shards, crafted, **kw):
    cfg = SimConfig(engine="fused", n_devices=shards, **_fields(crafted, **kw))
    assert runner.sharded_tier(_topo(), cfg)[:2] == (TIERS[shards], None)
    return run(_topo(), cfg, devices=["cpu"] * shards, **_start(crafted))


@pytest.mark.parametrize("shards,overlap,crafted", [
    (2, True, True), (4, False, True), (2, False, False), (4, True, False)])
def test_global_run_is_the_single_device_run_and_jax(shards, overlap, crafted):
    res = _sharded(shards, crafted, chunk_rounds=8, overlap_collectives=overlap)
    single = _single(crafted)
    assert res.converged and res.converged_count == N
    assert (res.rounds, res.converged_count, res.estimate_mae) == (
        single.rounds, single.converged_count, single.estimate_mae)
    _same_state(res.state, single.state)
    assert bool(res.state.conv.all())
    jres, jstate = _jax(crafted)
    assert (res.rounds, res.converged_count) == (jres.rounds, jres.converged_count)
    if crafted:
        # A few rounds past the start, not a super-step boundary.
        assert START < res.rounds < START + 16
        assert res.estimate_mae == jres.estimate_mae
        _same_state(res.state, jstate)


# The streaming tier's plan gives 4 shards 2-round super-steps: no middle.
@pytest.mark.parametrize("shards,where", [(2, "first"), (2, "middle"), (2, "last"),
                                          (4, "first"), (4, "last")])
def test_verdict_on_a_supersteps_first_middle_and_last_round(shards, where):
    """A run capped k rounds past the crafted start, then resumed in
    super-steps of c rounds: the stop round falls at the super-step's
    position (m - 1 - k) % c, picked first, middle or last."""
    single = _single(True)
    m = single.rounds - START  # rounds from START to the stop, inclusive
    _, tier = _geometry(shards)
    c = min(tier.geom.cr, m)
    assert c >= (3 if where == "middle" else 2)
    p = {"first": 0, "middle": 1, "last": c - 1}[where]
    k = (m - 1 - p) % c
    start = _start(True)
    if k:
        cap = SimConfig(engine="fused", n_devices=shards, chunk_rounds=c,
                        **{**_fields(True), "max_rounds": START + k})
        part = run(_topo(), cap, devices=["cpu"] * shards, **start)
        assert part.rounds == START + k and not part.converged
        start = {"start_state": part.state, "start_round": part.rounds}
    cfg = SimConfig(engine="fused", n_devices=shards, chunk_rounds=c, **_fields(True))
    res = run(_topo(), cfg, devices=["cpu"] * shards, **start)
    assert (res.rounds - START - k - 1) % c == p
    assert res.rounds == single.rounds and res.converged
    _same_state(res.state, single.state)


def _geometry(shards, chunk_rounds=8):
    cfg = SimConfig(engine="fused", n_devices=shards, chunk_rounds=chunk_rounds,
                    **_fields(True))
    tier = (fs.vmem_tier if shards == 2 else fh.hbm_tier)(_topo(), cfg, shards)
    return cfg, tier


def _ext_planes(geom, row0):
    """Shard planes from the crafted state, extended: global row (row0 + r)
    mod R at extended row r."""
    s, w, _, _ = (torch.from_numpy(x.copy()) for x in _crafted())
    pad = geom.R * 128 - N
    full = (torch.cat([s, torch.zeros(pad)]).reshape(-1, 128),
            torch.cat([w, torch.ones(pad)]).reshape(-1, 128),
            torch.zeros(geom.R, 128, dtype=torch.int32),
            torch.zeros(geom.R, 128, dtype=torch.int32))
    rows = (row0 + torch.arange(geom.rows_ext)) % geom.R
    return tuple(p[rows].contiguous() for p in full)


@pytest.mark.parametrize("shards", [2, 4])
def test_capped_superstep_under_the_whole_windows(shards):
    cfg, tier = _geometry(shards)
    geom, rolls = tier.geom, tier.rolls
    kw = fs.protocol_kw(_topo(), cfg, geom, rolls)
    assert kw["global_term"]
    CR = geom.cr
    row0 = geom.row0(1)
    planes = _ext_planes(geom, row0)
    keys = fused.round_keys(rng.PRNGKey(cfg.seed), START, CR)
    whole = fs.shard_windows(kw["spec"], tuple(rolls), geom, row0, CR)
    H, rl = geom.H, geom.rows_loc
    for cap in sorted({1, CR - 1, 3, 4} & set(range(1, CR))):
        outs = []
        for windows in (whole[:cap + 1], None):
            out = [x.clone() for x in planes]
            y = [x.clone() for x in planes]
            u = fs.shard_superstep_plain(planes, out, y, keys, cap, row0,
                                         windows=windows, **kw)
            outs.append((out, u))
        (a, ua), (b, ub) = outs
        for p, q in zip(a, b):
            assert torch.equal(p[H:H + rl].view(torch.int32) if p.dtype == torch.float32
                               else p[H:H + rl],
                               q[H:H + rl].view(torch.int32) if q.dtype == torch.float32
                               else q[H:H + rl])
        assert torch.equal(ua, ub) and int(ua[-1]) == cap
        # The last round lands in ``out``: a round more (or less) would
        # leave the input's middle there.
        assert not torch.equal(a[0][H:H + rl], planes[0][H:H + rl])


def test_shard_counts_are_the_unstable_nodes():
    cfg, tier = _geometry(2)
    geom = tier.geom
    kw = fs.protocol_kw(_topo(), cfg, geom, tier.rolls)
    keys = fused.round_keys(rng.PRNGKey(cfg.seed), START, 1)
    total = 0
    for shard in range(2):
        row0 = geom.row0(shard)
        planes = _ext_planes(geom, row0)
        out = [x.clone() for x in planes]
        y = [x.clone() for x in planes]
        u = fs.shard_superstep_plain(planes, out, y, keys, 1, row0, **kw)
        H, rl = geom.H, geom.rows_loc
        assert all(torch.equal(out[p][H:H + rl], planes[p][H:H + rl]) for p in (2, 3))
        s0, w0 = planes[0][H:H + rl], planes[1][H:H + rl]
        s1, w1 = out[0][H:H + rl], out[1][H:H + rl]
        ratio = s0 / w0
        tol = torch.tensor(cfg.resolved_delta) * torch.maximum(ratio.abs(), torch.ones(()))
        g = (shard * rl + torch.arange(rl)[:, None]) * 128 + torch.arange(128)[None, :]
        unstable = ((s1 / w1 - ratio).abs() > tol) & (g < N)
        assert int(u[0]) == int(unstable.sum())
        total += int(u[0])
    assert total > 0
