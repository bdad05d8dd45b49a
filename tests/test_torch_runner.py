"""Whole runs of the port on the CPU against the JAX chunked engine with
pool delivery (pool_size 2): the port's chunked engine (engine auto on the
CPU) and its fused engine (the plain versions of the kernels). Gossip must
match bitwise in rounds and final state; push-sum in rounds and converged
count, with estimate_mae within 1e-3 (the fused-vs-chunked contract of
tests/test_fused_pool.py) and, since the float32 op order is the same,
bitwise s and w."""

import numpy as np
import pytest
import torch

import jax

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


def _jax_run(algorithm, n, seed, **kw):
    final = {}

    def hook(rounds, state):
        final["state"] = state

    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, delivery="pool",
                    pool_size=2, seed=seed, engine="chunked", **kw)
    res = jax_runner.run(jax_topology("full", n), cfg, on_chunk=hook)
    return res, final["state"]


def _assert_state_bitwise(port_state, jax_state):
    for a, b in zip(port_state, jax_state):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("n", [1000, 70000])
@pytest.mark.parametrize("seed", [0, 5])
def test_run_matches_jax_chunked(algorithm, n, seed):
    jres, jstate = _jax_run(algorithm, n, seed, chunk_rounds=64)
    topo = build_topology("full", n)
    for engine in ("auto", "fused"):
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2,
                        seed=seed, engine=engine, chunk_rounds=64)
        res = run(topo, cfg, device="cpu")
        assert res.converged and jres.converged
        assert res.rounds == jres.rounds
        assert res.converged_count == jres.converged_count
        if algorithm == "push-sum":
            assert abs(res.estimate_mae - jres.estimate_mae) < 1e-3
        _assert_state_bitwise(res.state, jstate)
        assert res.device == "cpu"


@pytest.mark.parametrize("engine", ["auto", "fused"])
def test_resume_from_carried_jax_state(engine):
    # A mid-run JAX state handed to the port through utils/carry.py finishes
    # on the JAX run's own trajectory.
    n, seed, mid = 1000, 3, 12
    jres, jstate = _jax_run("gossip", n, seed, chunk_rounds=64)
    _, jmid = _jax_run("gossip", n, seed, chunk_rounds=mid, max_rounds=mid)
    start = carry.state_from_numpy({k: np.asarray(v) for k, v in jmid._asdict().items()})
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)))
    cfg = SimConfig(n=n, algorithm="gossip", delivery="pool", pool_size=2,
                    seed=seed, engine=engine, chunk_rounds=64)
    res = run(build_topology("full", n), cfg, key=key, device="cpu",
              start_state=start, start_round=mid)
    assert res.rounds == jres.rounds
    _assert_state_bitwise(res.state, jstate)


def test_reference_semantics_gossip():
    # Q1 population n+1 with target n, Q2 11th receipt, leader self-count,
    # receiver-side suppression.
    n = 512
    jcfg = JaxConfig(n=n, topology="full", algorithm="gossip",
                     semantics="reference", delivery="pool", pool_size=2,
                     engine="chunked", chunk_rounds=32)
    jres = jax_runner.run(jax_topology("full", n, semantics="reference"), jcfg)
    for engine in ("auto", "fused"):
        cfg = SimConfig(n=n, algorithm="gossip", semantics="reference",
                        delivery="pool", pool_size=2, engine=engine,
                        chunk_rounds=32)
        res = run(build_topology("full", n, semantics="reference"), cfg,
                  device="cpu")
        assert (res.rounds, res.converged_count, res.population, res.target_count) == (
            jres.rounds, jres.converged_count, jres.population, jres.target_count)


def test_max_rounds_outcome():
    cfg = SimConfig(n=1000, algorithm="push-sum", delivery="pool", max_rounds=10,
                    chunk_rounds=4, engine="fused")
    res = run(build_topology("full", 1000), cfg, device="cpu")
    assert (res.rounds, res.converged, res.outcome) == (10, False, "max_rounds")
    assert [e["rounds"] for e in res.chunk_log] == [4, 8, 10]
