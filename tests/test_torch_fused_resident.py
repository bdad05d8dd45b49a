"""The port's resident lattice tiers (ops/fused.py's whole-array tier,
ops/fused_stencil.py's tiled tier; on the card both run
csrc/fused_resident.cu) on the CPU, where their wrappers run the plain
version, against the JAX package:

- the ladder: the port's ``fused_tier`` picks the tier the JAX predicates
  (``fused_support``, ``stencil2_support``, called on the JAX build) pick;
- whole runs: ``run(engine="fused", device="cpu")`` on each tier against
  the JAX chunked engine, on the cases of the JAX package's own tests of
  the two tiers (tests/test_fused.py, tests/test_fused_stencil2.py),
  rounds, converged count, estimate and the final state bitwise (push-sum
  s/w too: the same float32 op order);
- single chunks: one 8-round chunk of each JAX kernel in Pallas interpret
  mode against the port's wrapper on the same start state;
- the wrappers' contracts: the JAX tier's layout, a cap inside the chunk,
  a chunk from a converged state, and no launch from CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, fused_stencil
from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEED = 4


def _jax_tier(jtopo, jcfg):
    """The JAX runner's lattice ladder on its own predicates."""
    if jax_fused.fused_support(jtopo, jcfg) is None:
        return "stencil"
    if jax_fused_stencil.stencil2_support(jtopo, jcfg) is None:
        return "stencil2"
    return "stencil_hbm"


@pytest.mark.parametrize("kind,n,tier", [
    ("line", 1000, "stencil"),
    ("grid2d", 10_000, "stencil"),
    ("ring", 131_072, "stencil"),
    ("grid3d", 125_000, "stencil"),
    ("ring", 5000, "stencil2"),
    ("torus3d", 1_000_000, "stencil2"),
    ("grid2d", 1_000_000, "stencil2"),
])
def test_ladder_matches_jax(kind, n, tier):
    jtopo = jax_build(kind, n)
    topo = carry.topology_from_numpy(jtopo)
    for algorithm in ("gossip", "push-sum"):
        jcfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, engine="fused")
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused")
        assert _jax_tier(jtopo, jcfg) == tier
        assert fused_tier(topo, cfg) == (tier, None)


def _jax_run(kind, n, algorithm, semantics="batched", **kw):
    """A JAX chunked-engine run and its final state."""
    final = {}
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    engine="chunked", seed=SEED, **kw)
    jtopo = jax_build(kind, n, semantics=semantics)
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: final.__setitem__("s", s))
    return jtopo, res, final["s"]


def _assert_same_run(res, jres, jstate):
    assert (res.rounds, res.converged, res.converged_count, res.estimate_mae) == (
        jres.rounds, jres.converged, jres.converged_count, jres.estimate_mae)
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


# (kind, n, algorithm, tier, extra config): the JAX tests' cases. Push-sum
# on the ring at 128 converges after 10,789 rounds; its first 3,000 are
# held here.
RUNS = [
    ("line", 144, "gossip", "stencil", {"max_rounds": 4000, "chunk_rounds": 48}),
    ("grid2d", 144, "gossip", "stencil", {"max_rounds": 4000, "chunk_rounds": 48}),
    ("grid3d", 144, "gossip", "stencil", {"max_rounds": 4000, "chunk_rounds": 48}),
    ("line", 100, "gossip", "stencil",
     {"semantics": "reference", "max_rounds": 6000, "chunk_rounds": 64}),
    ("ring", 128, "push-sum", "stencil", {"max_rounds": 3000, "chunk_rounds": 256}),
    ("grid2d", 49, "push-sum", "stencil", {"max_rounds": 60_000, "chunk_rounds": 256}),
    ("torus3d", 1000, "gossip", "stencil2", {"max_rounds": 3000, "chunk_rounds": 32}),
    ("ring", 300, "gossip", "stencil2", {"max_rounds": 3000, "chunk_rounds": 32}),
    ("torus3d", 1000, "gossip", "stencil2",
     {"max_rounds": 3000, "chunk_rounds": 32, "suppress_converged": True}),
    ("torus3d", 1000, "push-sum", "stencil2", {"max_rounds": 100, "chunk_rounds": 256}),
    ("torus3d", 1000, "gossip", "stencil2", {"max_rounds": 3000, "chunk_rounds": 5}),
    ("torus3d", 1000, "gossip", "stencil2", {"max_rounds": 3000, "chunk_rounds": 100}),
]


@pytest.mark.parametrize("kind,n,algorithm,tier,kw", RUNS)
def test_fused_run_matches_jax_chunked(kind, n, algorithm, tier, kw):
    kw = dict(kw)
    semantics = kw.pop("semantics", "batched")
    jtopo, jres, jstate = _jax_run(kind, n, algorithm, semantics, **kw)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    seed=SEED, engine="fused", **kw)
    assert fused_tier(topo, cfg) == (tier, None)
    before = (fused.pushsum_chunk.launches, fused.gossip_chunk.launches,
              fused_stencil.pushsum_stencil2_chunk.launches,
              fused_stencil.gossip_stencil2_chunk.launches)
    res = run(topo, cfg, device="cpu")
    _assert_same_run(res, jres, jstate)
    assert res.chunk_log[0]["rounds"] == min(kw["chunk_rounds"], res.rounds)
    # CPU tensors run the plain version and launch nothing.
    assert before == (fused.pushsum_chunk.launches, fused.gossip_chunk.launches,
                      fused_stencil.pushsum_stencil2_chunk.launches,
                      fused_stencil.gossip_stencil2_chunk.launches)


@pytest.mark.parametrize("kind,n,mid,tier", [("grid2d", 144, 32, "stencil"),
                                             ("torus3d", 1000, 8, "stencil2")])
def test_fused_resume_from_a_chunk_boundary(kind, n, mid, tier):
    # The JAX chunked engine's state at a chunk boundary, carried across,
    # resumes on the port's fused tier to the JAX run's end.
    jtopo, jres, jstate = _jax_run(kind, n, "gossip", chunk_rounds=64)
    _, _, jmid = _jax_run(kind, n, "gossip", chunk_rounds=mid, max_rounds=mid)
    start = carry.state_from_numpy({k: np.asarray(v) for k, v in jmid._asdict().items()})
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(SEED)))
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm="gossip", seed=SEED,
                    engine="fused", chunk_rounds=mid)
    assert fused_tier(topo, cfg) == (tier, None)
    res = run(topo, cfg, key=key, device="cpu", start_state=start, start_round=mid)
    _assert_same_run(res, jres, jstate)


def _planes(state, layout):
    """A JAX [n] state in a padded [rows, 128] layout, as torch planes."""
    st = carry.state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()})
    if hasattr(st, "s"):
        return (fused._pad2d(st.s, layout, 0.0), fused._pad2d(st.w, layout, 1.0),
                fused._pad2d(st.term, layout, 0),
                fused._pad2d(st.conv.to(torch.int32), layout, 0))
    return tuple(fused._pad2d(x.to(torch.int32), layout, 0) for x in st)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("kind,n,tier", [("ring", 128, "stencil"),
                                         ("torus3d", 125, "stencil2")])
def test_chunk_matches_the_jax_kernel_in_interpret_mode(kind, n, tier, algorithm):
    # One 8-round chunk of the JAX tier's Pallas kernel, interpreted on the
    # CPU, from a mid-run state of the JAX chunked engine, against the
    # port's wrapper on the same planes: the tiers share the layout.
    mid, rounds = (40, 8) if algorithm == "push-sum" else (4, 8)
    jtopo, _, jmid = _jax_run(kind, n, algorithm, chunk_rounds=mid, max_rounds=mid)
    jcfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, engine="fused", seed=SEED)
    make = {("stencil", "push-sum"): jax_fused.make_pushsum_chunk,
            ("stencil", "gossip"): jax_fused.make_gossip_chunk,
            ("stencil2", "push-sum"): jax_fused_stencil.make_pushsum_stencil2_chunk,
            ("stencil2", "gossip"): jax_fused_stencil.make_gossip_stencil2_chunk}
    jchunk, jlayout = make[tier, algorithm](jtopo, jcfg, interpret=True)
    jkey = jax.random.PRNGKey(SEED)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED)
    eng = fused_engine(topo, cfg, carry.key_from_numpy(np.asarray(jkey)), tier)
    assert (eng.layout.n_pad, eng.layout.rows) == (jlayout.n_pad, jlayout.rows)
    start = _planes(jmid, eng.layout)
    jout, jex = jchunk(tuple(jnp.asarray(p.numpy()) for p in start),
                       jax_fused.round_keys(jkey, mid, rounds), mid, mid + rounds)
    out, executed = eng.chunk(start, eng.streams(mid, rounds), mid, mid + rounds)
    assert int(executed) == int(jex) == rounds
    _assert_bitwise(out, tuple(torch.from_numpy(np.array(x)) for x in jout))


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("tier", ["stencil", "stencil2"])
def test_cap_inside_the_chunk_and_a_converged_start(tier, algorithm):
    kind, n = ("grid2d", 144) if tier == "stencil" else ("torus3d", 1000)
    jtopo, _, jmid = _jax_run(kind, n, algorithm, chunk_rounds=5, max_rounds=10)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED)
    eng = fused_engine(topo, cfg, carry.key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))),
                       tier)
    # Rounds 0..10 with the cap at round 10 of a 16-round chunk.
    out, executed = eng.chunk(eng.planes, eng.streams(0, 16), 0, 10)
    assert int(executed) == 10
    _assert_bitwise(out, _planes(jmid, eng.layout))
    # A chunk from a converged state (every real node's conv flag latched)
    # runs nothing and leaves the state as it was.
    real = torch.arange(eng.layout.n_pad).reshape(out[-1].shape) < topo.n
    done = (*out[:-1], real.to(torch.int32))
    out, executed = eng.chunk(done, eng.streams(10, 16), 10, 26)
    assert int(executed) == 0
    _assert_bitwise(out, done)


def test_wrappers_check_the_tier_layout():
    # Each resident tier takes its JAX tier's layout and refuses the other's.
    topo = build_topology("ring", 300)
    spec = fused_stencil_hbm.stencil_spec(topo)
    keys = fused.round_keys((0, 0), 0, 4)
    rows = {"stencil": fused.build_layout(300).rows,
            "stencil2": fused_pool.build_pool_layout(300).rows}
    assert rows == {"stencil": 3, "stencil2": 512}
    chunks = {"stencil": fused.gossip_chunk, "stencil2": fused_stencil.gossip_stencil2_chunk}
    for tier, chunk in chunks.items():
        for other, r in rows.items():
            planes = (torch.zeros(r, 128, dtype=torch.int32),) * 3
            call = lambda: chunk(planes, keys, 0, 4, spec=spec, target=300,  # noqa: E731
                                 rumor_target=10, suppress=False)
            if other == tier:
                assert int(call()[1]) == 4  # no node holds the rumor: nothing sends
            else:
                with pytest.raises(ValueError, match="state plane"):
                    call()
