"""The port's streaming sharded lattice composition (cop5615_gossip_protocol_
tpu_torch/parallel/fused_hbm_sharded.py, the JAX package's B11) on the CPU,
its shards placed explicitly on the CPU: one super-step of each JAX shard
kernel against the port's plain version at ring 131,072 x4 (the checks of
tests/test_torch_stencil_hbm_sharded.py), and whole runs at torus3d
125,000 x4: gossip resumed at round 96 of the single-device run, at
chunk_rounds=1 bitwise the single-device run and at the default CR at the
JAX schedule's boundary (chunks of CR * 8), the verdict deferred or not;
push-sum over a fixed round count, bitwise and conserving its mass; a
resume from a chunk boundary."""

import pytest
import torch

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded

from test_torch_stencil_hbm_sharded import check_superstep
from test_torch_stencil_sharded import jax_boundary, same_run

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

TORUS = 125_000
S = 4


@pytest.mark.parametrize("algorithm,state", [("gossip", "mid"), ("push-sum", "init")])
def test_ring_superstep_matches_the_jax_kernel(algorithm, state):
    check_superstep("ring", 131_072, algorithm, state)


def _single(algorithm, max_rounds, cache={}):
    if (algorithm, max_rounds) not in cache:
        topo = build_topology("torus3d", TORUS)
        cache[algorithm, max_rounds] = run(
            topo, SimConfig(n=TORUS, topology="torus3d", algorithm=algorithm,
                            engine="fused", max_rounds=max_rounds), device="cpu")
    return cache[algorithm, max_rounds]


def _sharded(algorithm, start=None, **kw):
    topo = build_topology("torus3d", TORUS)
    cfg = SimConfig(n=TORUS, topology="torus3d", algorithm=algorithm, engine="fused",
                    n_devices=S, **kw)
    extra = {} if start is None else {"start_state": start.state,
                                      "start_round": start.rounds}
    return run(topo, cfg, devices=["cpu"] * S, **extra), cfg


def test_gossip_cr1_is_the_single_device_run():
    mid, final = _single("gossip", 96), _single("gossip", 10**6)
    res, _ = _sharded("gossip", chunk_rounds=1, start=mid)
    same_run(res, final)


@pytest.mark.parametrize("overlap_collectives", [True, False])
def test_gossip_default_cr_stops_at_the_jax_boundary(overlap_collectives):
    """The plan's CR = 2 over chunks of CR * 8 = 16 rounds from round 97:
    boundaries at odd rounds, so the run ends one round past the
    single-device run's 132."""
    mid, final = _single("gossip", 97), _single("gossip", 10**6)
    res, cfg = _sharded("gossip", start=mid, overlap_collectives=overlap_collectives)
    plan = fused_hbm_sharded.plan_stencil_hbm_sharded(build_topology("torus3d", TORUS),
                                                      cfg, S)
    CR = plan[2]
    assert CR == 2
    want = jax_boundary(final.rounds, 97, CR, CR * 8, cfg.max_rounds)
    assert final.rounds <= res.rounds == want <= final.rounds + CR
    assert res.converged and res.converged_count == TORUS


def test_pushsum_fixed_rounds_bitwise_and_mass():
    res, _ = _sharded("push-sum", max_rounds=12)
    same_run(res, _single("push-sum", 12))
    s = res.state.s.double().sum().item()
    w = res.state.w.double().sum().item()
    assert abs(w - TORUS) / TORUS < 1e-5
    assert abs(s - TORUS * (TORUS - 1) / 2) / (TORUS * (TORUS - 1) / 2) < 1e-5


def test_resume_from_a_chunk_boundary():
    first, _ = _sharded("push-sum", max_rounds=4)
    again, _ = _sharded("push-sum", start=first, max_rounds=12)
    same_run(again, _single("push-sum", 12))
