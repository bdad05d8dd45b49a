"""Global termination in the port's imp x HBM x sharded composition
(cop5615_gossip_protocol_tpu_torch/parallel/fused_imp_hbm_sharded.py, row
18) with its shards placed on the CPU (``devices=["cpu"] * S``), where its
wrappers run their plain versions:

- whole push-sum runs under termination='global' in 2 and 4 shards, the
  verdict deferred and not, from the initial state and from a crafted one
  (one ratio everywhere but three nodes: the verdict fires a few rounds
  in), each bitwise the single-device streaming imp run (the ``imp_hbm``
  tier, reached by shrinking ops/fused_imp._VMEM_BUDGET in both packages)
  and the JAX chunked engine: rounds, converged count, estimate, every
  plane, conv latched on every node at the verdict;
- caps after an odd and an even number of rounds before the verdict and a
  run from the verdict's state (0 rounds) bitwise the single-device run;
- one round of every shard from the crafted state: term and conv stay, and
  the shards' u sum to the round's real nodes whose ratio moved past
  delta * max(|s/w|, 1).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.models.pushsum import PushSumState
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_pool, rng
from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

torch.set_num_threads(1)

SEED = 4
START = 1000
EPS = 8e-6


@pytest.fixture
def force_hbm(monkeypatch):
    """Shrink the resident imp tier's budget in both packages, so the
    single-device run is the streaming tier this composition shards."""
    monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)
    monkeypatch.setattr(jax_fused_imp, "_VMEM_BUDGET", 1000)


def _cfg(kind, n, **kw):
    return SimConfig(n=n, topology=kind, algorithm="push-sum", delivery="pool",
                     engine="fused", termination="global", seed=SEED, **kw)


@functools.lru_cache(maxsize=None)
def _topo(kind, n):
    return build_topology(kind, n)


def _crafted(n):
    """The canonical [n] crafted state: s = w = 1 but EPS more s at three
    nodes, term and conv 0."""
    s = np.ones(n, np.float32)
    s[[5, n // 3, 2 * n // 3 + 7]] = np.float32(1.0 + EPS)
    return (s, np.ones(n, np.float32), np.zeros(n, np.int32), np.zeros(n, bool))


def _start(kind, n, crafted):
    if not crafted:
        return {}
    return {"start_state": PushSumState(*(torch.from_numpy(x.copy()) for x in _crafted(n))),
            "start_round": START}


def _same_state(a, b):
    for x, y in zip(a, b):
        x, y = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _single(kind, n, crafted, max_rounds=None):
    bound = {} if max_rounds is None else {"max_rounds": max_rounds}
    cfg = _cfg(kind, n, **bound)
    assert runner.fused_tier(_topo(kind, n), cfg) == ("imp_hbm", None)
    return run(_topo(kind, n), cfg, device="cpu", **_start(kind, n, crafted))


def _jax(kind, n, crafted):
    jcfg = JaxConfig(n=n, topology=kind, algorithm="push-sum", delivery="pool",
                     engine="chunked", termination="global", seed=SEED)
    final = {}
    start = {}
    if crafted:
        start = {"start_state": jax_pushsum.PushSumState(*(jnp.asarray(x)
                                                           for x in _crafted(n))),
                 "start_round": START}
    res = jax_runner.run(jax_topology(kind, n), jcfg,
                         on_chunk=lambda r, s: final.__setitem__("s", s), **start)
    return res, final["s"]


@pytest.mark.parametrize("kind,n,shards,overlap,crafted", [
    ("imp3d", 4096, 2, True, False), ("imp3d", 4096, 4, False, True),
    ("imp2d", 4096, 2, False, True), ("imp2d", 4096, 4, True, False),
])
def test_global_run_is_the_single_device_run_and_jax(kind, n, shards, overlap, crafted,
                                                     force_hbm):
    cfg = _cfg(kind, n, n_devices=shards, overlap_collectives=overlap)
    assert runner.sharded_tier(_topo(kind, n), cfg) == ("imp_hbm_sharded", None, "B12")
    res = run(_topo(kind, n), cfg, devices=["cpu"] * shards, **_start(kind, n, crafted))
    single = _single(kind, n, crafted)
    assert res.converged and res.converged_count == n
    assert (res.rounds, res.converged_count, res.estimate_mae) == (
        single.rounds, single.converged_count, single.estimate_mae)
    _same_state(res.state, single.state)
    assert bool(res.state.conv.all()) and not res.state.term.any()
    jres, jstate = _jax(kind, n, crafted)
    assert (res.rounds, res.converged_count, res.estimate_mae) == (
        jres.rounds, jres.converged_count, jres.estimate_mae)
    _same_state(res.state, jstate)
    if crafted:
        assert START < res.rounds < START + 16


@pytest.mark.parametrize("cap", [2, 3])
def test_capped_and_resumed_global_runs(cap, force_hbm):
    kind, n, shards = "imp3d", 4096, 4
    cfg = _cfg(kind, n, n_devices=shards, max_rounds=START + cap)
    res = run(_topo(kind, n), cfg, devices=["cpu"] * shards, **_start(kind, n, True))
    single = _single(kind, n, True, START + cap)
    assert res.rounds == single.rounds == START + cap and not res.converged
    _same_state(res.state, single.state)
    assert not res.state.conv.any()
    # The rest of the run from the capped state, then a run from its verdict.
    whole = run(_topo(kind, n), _cfg(kind, n, n_devices=shards), devices=["cpu"] * shards,
                start_state=res.state, start_round=res.rounds)
    _same_state(whole.state, _single(kind, n, True).state)
    again = run(_topo(kind, n), _cfg(kind, n, n_devices=shards), devices=["cpu"] * shards,
                start_state=whole.state, start_round=whole.rounds)
    assert again.rounds == whole.rounds and again.converged
    _same_state(again.state, whole.state)


def test_shard_counts_are_the_unstable_nodes(force_hbm):
    kind, n, shards = "imp3d", 4096, 2
    topo = _topo(kind, n)
    cfg = _cfg(kind, n, n_devices=shards)
    _, rows_loc, _, layout = ih.plan_imp_hbm_sharded(topo, cfg, shards)
    kw = ih.absorb_kw(topo, cfg)
    assert kw["global_term"]
    s, w, _, _ = (torch.from_numpy(x.copy()) for x in _crafted(n))
    pad = layout.n_pad - n
    state = (torch.cat([s, torch.zeros(pad)]).reshape(-1, 128),
             torch.cat([w, torch.ones(pad)]).reshape(-1, 128),
             torch.zeros(layout.rows, 128, dtype=torch.int32),
             torch.zeros(layout.rows, 128, dtype=torch.int32))
    key = rng.PRNGKey(SEED)
    stream = (fused.round_keys(key, START, 1)[0].tolist(),
              fused_pool.round_offsets(key, START, 1, cfg.pool_size, n)[0].tolist(),
              fused_imp.choice_round_keys(key, START, 1)[0].tolist())
    out = ih.imp_hbm_shards_round_plain(state, stream, rows_loc,
                                        range(0, layout.rows, rows_loc), pushsum=True, **kw)
    planes = [torch.cat([o[0][p] for o in out]) for p in range(4)]
    # term and conv stay; u counts the real nodes whose ratio moved past
    # delta * max(|s/w|, 1).
    assert all(torch.equal(planes[p], state[p]) for p in (2, 3))
    ratio_old = state[0] / state[1]
    tol = torch.tensor(cfg.resolved_delta) * torch.maximum(ratio_old.abs(), torch.ones(()))
    real = (torch.arange(layout.n_pad) < n).reshape(layout.rows, 128)
    unstable = ((planes[0] / planes[1] - ratio_old).abs() > tol) & real
    assert sum(int(u) for _, u in out) == int(unstable.sum()) > 0
    # Local termination keeps the fault-free absorb.
    assert not ih.absorb_kw(topo, dataclasses.replace(cfg, termination="local"))["global_term"]
