"""The port's streaming stencil chunks (cop5615_gossip_protocol_tpu_torch/ops/
fused_stencil_hbm.py) through their wrappers on CPU tensors, so their
plain versions, against the JAX chunked engine's rounds: the oracle the
JAX package's own streaming-tier tests hold its kernels to. States come
from the JAX engine and are carried across with utils/carry.py, one
topology serves both packages. Gossip planes must be bitwise equal, and so
must push-sum's (the halve before the class sums, and the sums in
ascending class order, are the chunked engine's float32 op order).

Also: the cap and converged-state contracts of a chunk, and the tier the
port's ladder picks against the JAX runner's ladder over a sweep of
configs (the JAX support predicates themselves, called on the JAX build).
"""

import numpy as np
import pytest
import torch

import jax

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil
from cop5615_gossip_protocol_tpu.ops import fused_stencil_hbm as jax_hbm

from cop5615_gossip_protocol_tpu_torch import SimConfig
from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_stencil, fused_stencil_hbm
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

K = 16
SEED = 4
MID = {"push-sum": 20, "gossip": 8}
CASES = [
    ("torus3d", 27_000, "batched"),
    ("grid3d", 27_000, "batched"),
    ("grid2d", 26_896, "batched"),
    ("line", 5_000, "batched"),
    ("ring", 5_000, "batched"),
    ("ref2d", 5_000, "reference"),
]


def _jax_states(kind, n, semantics, algorithm, mid, rounds):
    """JAX chunked-engine states at absolute rounds mid and mid + rounds
    (fewer if it converges first): [(round, state), ...]."""
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    seed=SEED, engine="chunked", chunk_rounds=mid,
                    max_rounds=mid + rounds)
    seen = []
    res = jax_runner.run(jax_build(kind, n, semantics=semantics), cfg,
                         on_chunk=lambda r, s: seen.append((r, s)))
    return seen, res


def _planes(state, layout):
    st = carry.state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()})
    if hasattr(st, "s"):
        return (fused._pad2d(st.s, layout, 0.0), fused._pad2d(st.w, layout, 1.0),
                fused._pad2d(st.term, layout, 0),
                fused._pad2d(st.conv.to(torch.int32), layout, 0))
    return tuple(fused._pad2d(x.to(torch.int32), layout, 0) for x in st)


def _setup(kind, n, semantics, algorithm):
    jtopo = jax_build(kind, n, semantics=semantics)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    seed=SEED)
    spec = fused_stencil_hbm.stencil_spec(topo)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    if algorithm == "push-sum":
        def chunk(state, keys, start, cap):
            return fused_stencil_hbm.pushsum_stencil_hbm_chunk(
                state, keys, start, cap, spec=spec, target=target,
                delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
    else:
        def chunk(state, keys, start, cap):
            return fused_stencil_hbm.gossip_stencil_hbm_chunk(
                state, keys, start, cap, spec=spec, target=target,
                rumor_target=cfg.resolved_rumor_target,
                suppress=cfg.resolved_suppress)
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(SEED)))
    return topo, fused_stencil_hbm._streaming_layout(topo.n), chunk, key


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("kind,n,semantics", CASES)
def test_chunk_matches_jax_chunked_rounds(kind, n, semantics, algorithm):
    if algorithm == "push-sum" and semantics == "reference":
        semantics = "batched"  # reference push-sum is the single walk (A7)
    mid = MID[algorithm]
    seen, _ = _jax_states(kind, n, semantics, algorithm, mid, K)
    (r0, s0), (r1, s1) = seen[0], seen[-1]
    assert r0 == mid and r1 > r0
    topo, layout, chunk, key = _setup(kind, n, semantics, algorithm)
    before = (fused_stencil_hbm.pushsum_stencil_hbm_chunk.launches,
              fused_stencil_hbm.gossip_stencil_hbm_chunk.launches)
    out, executed = chunk(_planes(s0, layout), fused.round_keys(key, mid, K),
                          mid, mid + K)
    assert int(executed) == r1 - r0
    _assert_bitwise(out, _planes(s1, layout))
    # CPU tensors run the plain version and launch nothing.
    assert before == (fused_stencil_hbm.pushsum_stencil_hbm_chunk.launches,
                      fused_stencil_hbm.gossip_stencil_hbm_chunk.launches)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_cap_inside_the_chunk_and_overshoot(algorithm):
    mid = MID[algorithm]
    seen, _ = _jax_states("torus3d", 27_000, "batched", algorithm, mid, 5)
    (_, s0), (r1, s1) = seen[0], seen[-1]
    assert r1 == mid + 5
    topo, layout, chunk, key = _setup("torus3d", 27_000, "batched", algorithm)
    planes = _planes(s0, layout)
    out, executed = chunk(planes, fused.round_keys(key, mid, K), mid, mid + 5)
    assert int(executed) == 5
    _assert_bitwise(out, _planes(s1, layout))
    # A chunk at or past its cap runs nothing and leaves the state as it was.
    out, executed = chunk(planes, fused.round_keys(key, mid, K), mid, mid)
    assert int(executed) == 0
    _assert_bitwise(out, planes)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_chunk_from_a_converged_state_runs_nothing(algorithm):
    kind, n = ("torus3d", 8) if algorithm == "push-sum" else ("torus3d", 27_000)
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED,
                    engine="chunked", chunk_rounds=64)
    final = {}
    res = jax_runner.run(jax_build(kind, n), cfg,
                         on_chunk=lambda r, s: final.__setitem__("s", s))
    assert res.converged
    topo, layout, chunk, key = _setup(kind, n, "batched", algorithm)
    planes = _planes(final["s"], layout)
    out, executed = chunk(planes, fused.round_keys(key, res.rounds, K),
                          res.rounds, res.rounds + K)
    assert int(executed) == 0
    _assert_bitwise(out, planes)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    topo, layout, chunk, key = _setup("torus3d", 27_000, "batched", "gossip")
    planes = (torch.zeros(layout.rows, 128, dtype=torch.int32),) * 3
    keys = fused.round_keys(key, 0, 4)
    with pytest.raises(ValueError, match="state plane"):
        chunk((planes[0].float(),) + planes[1:], keys, 0, 4)
    with pytest.raises(ValueError, match="state plane"):
        chunk(tuple(p[:-1] for p in planes), keys, 0, 4)
    with pytest.raises(ValueError, match="host-drawn"):
        chunk(planes, keys.to("meta"), 0, 4)
    with pytest.raises(ValueError, match="uint32"):
        chunk(planes, keys - 2**40, 0, 4)


def _jax_tier(topo, cfg):
    """The JAX runner's lattice ladder (models/runner.py), on its own
    support predicates."""
    if jax_fused.fused_support(topo, cfg) is None:
        return "stencil", None
    variant, reason = "stencil2", jax_fused_stencil.stencil2_support(topo, cfg)
    if reason is not None and jax_hbm.stencil_hbm_support(topo, cfg) is None:
        variant, reason = "stencil_hbm", None
    return variant, reason


SWEEP = [
    ("line", 1000, "batched"), ("line", 131_072, "batched"),
    ("line", 200_000, "batched"), ("line", 1000, "reference"),
    ("ring", 5000, "batched"), ("ring", 131_072, "batched"),
    ("ring", 300_000, "batched"), ("grid2d", 26_896, "batched"),
    ("grid2d", 160_000, "batched"), ("grid2d", 400, "reference"),
    ("grid3d", 27_000, "batched"), ("grid3d", 262_144, "batched"),
    ("grid3d", 1000, "reference"), ("ref2d", 5000, "reference"),
    ("ref2d", 5000, "batched"), ("torus3d", 27_000, "batched"),
    ("torus3d", 32_768, "batched"), ("torus3d", 125_000, "batched"),
]


@pytest.mark.parametrize("force", [False, True])
def test_ladder_matches_jax(force, monkeypatch):
    if force:
        # The JAX streaming-tier tests' way to reach the tier at small n.
        monkeypatch.setattr(jax_fused_stencil, "_VMEM_BUDGET", 1000)
        monkeypatch.setattr(fused_stencil, "_VMEM_BUDGET", 1000)
    seen = set()
    for kind, n, semantics in SWEEP:
        jtopo = jax_build(kind, n, semantics=semantics)
        topo = carry.topology_from_numpy(jtopo)
        for algorithm in ("push-sum", "gossip"):
            if algorithm == "push-sum" and semantics == "reference":
                continue
            want = _jax_tier(jtopo, JaxConfig(n=n, topology=kind, algorithm=algorithm,
                                              semantics=semantics))
            got = fused_tier(topo, SimConfig(n=n, topology=kind, algorithm=algorithm,
                                             semantics=semantics))
            assert got[0] == want[0], (kind, n, semantics, algorithm)
            assert (got[1] is None) == (want[1] is None), (kind, n, algorithm)
            seen.add(got[0])
    assert seen == ({"stencil", "stencil_hbm"} if force else {"stencil", "stencil2"})


@pytest.mark.parametrize("n", [116**3, 130**3])
def test_ladder_matches_jax_past_a_million(n):
    # torus3d only here: its JAX build is vectorized. At 116**3 gossip
    # fits the tiled tier's budget and push-sum does not.
    jtopo = jax_build("torus3d", n)
    topo = carry.topology_from_numpy(jtopo)
    for algorithm in ("push-sum", "gossip"):
        want = _jax_tier(jtopo, JaxConfig(n=n, topology="torus3d", algorithm=algorithm))
        got = fused_tier(topo, SimConfig(n=n, topology="torus3d", algorithm=algorithm))
        assert got[0] == want[0] and (got[1] is None) == (want[1] is None)
        expect = "stencil2" if (n, algorithm) == (116**3, "gossip") else "stencil_hbm"
        assert got[0] == expect


def test_streaming_layout_matches_jax():
    for n in (1000, 27_000, 1_000_000, 8_000_000, 130**3, 2**24):
        a, b = fused_stencil_hbm._streaming_layout(n), jax_hbm._streaming_layout(n)
        assert (a.n, a.n_pad, a.rows, a.tiles) == (b.n, b.n_pad, b.rows, b.tiles)
