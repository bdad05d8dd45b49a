"""The port's fused pool chunks (cop5615_gossip_protocol_tpu_torch/ops/
fused_pool.py) against the JAX pool kernels make_pushsum_pool_chunk and
make_gossip_pool_chunk in interpret mode: one chunk of 8 rounds from the
same state, keys and pools, through the port's wrapper on CPU tensors (so
its plain version). States come from the JAX engines and are carried
across with utils/carry.py. Every plane and the executed-round count must
be bitwise equal, push-sum included (same float32 op order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import gossip as jax_gossip
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool

from cop5615_gossip_protocol_tpu_torch import SimConfig
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

K = 8
SEED = 2


def _jax_state(algorithm, n, pool_size, semantics, start_kind, mid_round, kw=None):
    """(canonical JAX state, its absolute round, topology, cfg); ``kw`` adds
    failure-model knobs to the config."""
    topo = jax_topology("full", n, semantics=semantics)
    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm,
                    semantics=semantics, delivery="pool", pool_size=pool_size,
                    seed=SEED, engine="chunked", **(kw or {}))
    key = jax.random.PRNGKey(SEED)
    if start_kind == "init":
        if algorithm == "push-sum":
            return jax_pushsum.init_state(topo.n, jnp.float32, 0), 0, topo, cfg
        leader = jax_runner.draw_leader(key, topo, cfg)
        st = jax_gossip.init_state(topo.n, leader, cfg.reference)
        return st, 0, topo, cfg
    seen = {}

    def hook(rounds, state):
        seen["state"], seen["rounds"] = state, rounds

    if start_kind == "mid":
        run_cfg = JaxConfig(**{**cfg.__dict__, "max_rounds": mid_round,
                               "chunk_rounds": mid_round})
    else:
        run_cfg = cfg
    res = jax_runner.run(topo, run_cfg, on_chunk=hook)
    assert res.converged == (start_kind == "converged")
    return seen["state"], seen["rounds"], topo, cfg


def run_case(algorithm, n, pool_size, semantics, start_kind, cap_after=None,
             mid_round=None, kw=None):
    """Run one chunk on both sides; returns (jax planes, jax executed, port
    planes, port executed, start). ``kw``: failure-model knobs of both
    configs (the port's wrapper takes them as fused.run_faults)."""
    st, start, topo, cfg = _jax_state(algorithm, n, pool_size, semantics,
                                      start_kind, mid_round, kw)
    faults = fused.run_faults(SimConfig(n=topo.n, algorithm=algorithm, seed=SEED,
                                        **(kw or {})), topo.n)
    cap = start + K if cap_after is None else start + cap_after
    layout = jax_fused_pool.build_pool_layout(topo.n)
    key = jax.random.PRNGKey(SEED)
    keys = jax_fused.round_keys(key, start, K)
    offs = jax_fused_pool.round_offsets(key, start, K, pool_size, topo.n)
    tkey = carry.key_from_numpy(np.asarray(key))
    tkeys = fused.round_keys(tkey, start, K)
    toffs = fused_pool.round_offsets(tkey, start, K, pool_size, topo.n)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    if algorithm == "push-sum":
        planes = (
            jax_fused._pad2d(jnp.asarray(st.s, jnp.float32), layout, 0.0),
            jax_fused._pad2d(jnp.asarray(st.w, jnp.float32), layout, 1.0),
            jax_fused._pad2d(jnp.asarray(st.term, jnp.int32), layout, 0),
            jax_fused._pad2d(jnp.asarray(st.conv).astype(jnp.int32), layout, 0),
        )
        fn, _ = jax_fused_pool.make_pushsum_pool_chunk(topo, cfg, interpret=True)
        port_state = carry.state_from_numpy(
            dict(zip(("s", "w", "term", "conv"), (np.asarray(p) for p in planes))))
        tout, tex = fused_pool.pushsum_pool_chunk(
            tuple(port_state), tkeys, toffs, start, cap, n=topo.n, target=target,
            delta=cfg.resolved_delta, term_rounds=cfg.term_rounds, faults=faults)
    else:
        planes = tuple(
            jax_fused._pad2d(jnp.asarray(x).astype(jnp.int32), layout, 0)
            for x in (st.count, st.active, st.conv)
        )
        fn, _ = jax_fused_pool.make_gossip_pool_chunk(topo, cfg, interpret=True)
        port_state = carry.state_from_numpy(
            dict(zip(("count", "active", "conv"), (np.asarray(p) for p in planes))))
        tout, tex = fused_pool.gossip_pool_chunk(
            tuple(port_state), tkeys, toffs, start, cap, n=topo.n, target=target,
            rumor_target=cfg.resolved_rumor_target, suppress=cfg.resolved_suppress,
            faults=faults)
    jout, jex = fn(planes, keys, offs, start, cap)
    return ([np.asarray(x) for x in jout], int(jex),
            [x.numpy() for x in tout], int(tex), start, [np.asarray(p) for p in planes])


def assert_bitwise(jout, tout):
    for a, b in zip(jout, tout):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.view(np.int32) == b.view(np.int32)).all()


def _launches():
    return (fused_pool.pushsum_pool_chunk.launches,
            fused_pool.gossip_pool_chunk.launches)


CASES = [
    # (algorithm, n, pool_size, semantics, start, cap_after, mid_round)
    ("push-sum", 1000, 2, "batched", "init", None, None),
    ("push-sum", 70000, 2, "batched", "init", None, None),
    ("push-sum", 1000, 4, "batched", "mid", None, 40),
    ("push-sum", 70000, 4, "batched", "mid", 3, 60),
    ("gossip", 1000, 2, "batched", "init", None, None),
    ("gossip", 70000, 4, "batched", "init", None, None),
    # Reference semantics: suppression on, rumor target 11, population n+1.
    ("gossip", 1000, 2, "reference", "mid", None, 18),
    ("gossip", 70000, 2, "reference", "mid", 3, 22),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunk_matches_jax_kernel(case):
    algorithm, n, pool_size, semantics, start_kind, cap_after, mid_round = case
    before = _launches()
    jout, jex, tout, tex, start, planes = run_case(
        algorithm, n, pool_size, semantics, start_kind, cap_after, mid_round)
    assert jex == tex == (K if cap_after is None else cap_after)
    assert_bitwise(jout, tout)
    # The input planes changed, so rounds really ran; CPU tensors never
    # launch a kernel.
    assert any((a != b).any() for a, b in zip(jout, planes))
    assert _launches() == before
    if semantics == "reference":
        # Some receivers start converged, so suppression drops real inboxes.
        assert 0 < planes[2].sum() < n


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_chunk_from_converged_state_is_a_no_op(algorithm):
    jout, jex, tout, tex, start, planes = run_case(
        algorithm, 1000, 2, "batched", "converged")
    assert start > 0 and jex == tex == 0
    assert_bitwise(jout, tout)
    assert_bitwise(planes, tout)


# The drop gate, crash-stop with quorum and global termination: (algorithm,
# n, pool_size, knobs, start, cap_after, mid_round). The crash schedules'
# death rounds fall inside the chunk from the initial state.
FAULT_CASES = [
    ("push-sum", 1000, 2, {"fault_rate": 0.1, "crash_schedule": "3:100,6:50",
                           "quorum": 0.95}, "init", None, None),
    ("push-sum", 70000, 4, {"fault_rate": 0.2, "crash_schedule": "2:7000,5:300",
                            "quorum": 0.9}, "init", None, None),
    ("push-sum", 65536, 2, {"fault_rate": 0.1, "crash_rate": 0.01, "quorum": 0.8},
     "mid", 5, 30),
    ("push-sum", 1000, 2, {"fault_rate": 0.1, "termination": "global"}, "init",
     None, None),
    ("push-sum", 70000, 2, {"termination": "global"}, "mid", None, 30),
    ("gossip", 1000, 2, {"fault_rate": 0.2, "crash_rate": 0.01, "quorum": 0.9},
     "init", None, None),
    ("gossip", 65536, 4, {"fault_rate": 0.1, "crash_schedule": "1:500,4:6000",
                          "quorum": 0.9}, "init", None, None),
    ("gossip", 70000, 2, {"crash_rate": 0.005, "quorum": 0.95}, "mid", 6, 10),
]


@pytest.mark.parametrize("case", FAULT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_faulted_chunk_matches_jax_kernel(case):
    algorithm, n, pool_size, kw, start_kind, cap_after, mid_round = case
    before = _launches()
    jout, jex, tout, tex, start, planes = run_case(
        algorithm, n, pool_size, "batched", start_kind, cap_after, mid_round, kw)
    assert jex == tex
    assert_bitwise(jout, tout)
    assert any((a != b).any() for a, b in zip(jout, planes))
    assert _launches() == before


@pytest.mark.parametrize("algorithm,kw", [
    ("push-sum", {"fault_rate": 0.1, "crash_schedule": "3:100,6:50", "quorum": 0.95}),
    ("push-sum", {"termination": "global"}),
    ("gossip", {"crash_rate": 0.01, "quorum": 0.9}),
])
def test_faulted_chunk_from_the_verdict_is_a_no_op(algorithm, kw):
    # A resumed chunk that starts at the quorum (or the global verdict):
    # the seed verdict of round start - 1 stops it before any round.
    jout, jex, tout, tex, start, planes = run_case(
        algorithm, 1000, 2, "batched", "converged", kw=kw)
    assert start > 0 and jex == tex == 0
    assert_bitwise(jout, tout)
    assert_bitwise(planes, tout)
