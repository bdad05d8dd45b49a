"""Whole lattice runs of the port on the CPU against the JAX chunked engine,
on one topology carried across with utils/carry.py: the port's chunked
engine for every lattice kind and both algorithms, reference gossip on
line, grid2d and ref2d, and the fused engine (the streaming stencil
chunks' plain versions, with the tier forced the way the JAX package's
tests force it). Rounds, converged count, estimate_mae and the final state
must all be equal, push-sum s/w bitwise (same float32 op order).

And the dispatch: on a CUDA device (stubbed here, never touched) a config
the JAX ladder gives to a resident lattice tier goes to that fused tier,
and under engine="fused" on the CPU it runs there and equals the chunked
engine."""

import numpy as np
import pytest
import torch

import jax

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_stencil
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


def _jax_run(kind, n, semantics, algorithm, **kw):
    final = {}
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    engine="chunked", **kw)
    jtopo = jax_build(kind, n, semantics=semantics)
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: final.__setitem__("s", s))
    return jtopo, res, final["s"]


def _assert_same_run(res, jres, jstate):
    assert (res.rounds, res.converged, res.converged_count, res.population,
            res.target_count) == (jres.rounds, jres.converged, jres.converged_count,
                                  jres.population, jres.target_count)
    assert res.estimate_mae == jres.estimate_mae
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


# (kind, n, semantics, algorithm, max_rounds): runs that converge quickly
# go to the end, slow-mixing ones are bounded.
RUNS = [
    ("torus3d", 27_000, "batched", "gossip", 3000),
    ("torus3d", 8, "batched", "push-sum", 3000),
    ("torus3d", 8000, "batched", "push-sum", 150),
    ("ring", 1000, "batched", "gossip", 3000),
    ("ring", 500, "batched", "push-sum", 200),
    ("grid2d", 900, "batched", "gossip", 3000),
    ("grid2d", 400, "batched", "push-sum", 200),
    ("grid3d", 1000, "batched", "gossip", 3000),
    ("grid3d", 8000, "batched", "push-sum", 150),
    ("line", 1000, "batched", "gossip", 3000),
    ("line", 500, "batched", "push-sum", 200),
    ("ref2d", 900, "batched", "push-sum", 200),
    ("ref2d", 400, "reference", "gossip", 3000),
    ("line", 1000, "reference", "gossip", 3000),
    ("grid2d", 400, "reference", "gossip", 3000),
    ("grid3d", 1000, "reference", "gossip", 3000),
]


@pytest.mark.parametrize("kind,n,semantics,algorithm,max_rounds", RUNS)
def test_chunked_run_matches_jax(kind, n, semantics, algorithm, max_rounds):
    jtopo, jres, jstate = _jax_run(kind, n, semantics, algorithm, seed=1,
                                   max_rounds=max_rounds, chunk_rounds=128)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                    seed=1, max_rounds=max_rounds, chunk_rounds=128)
    res = run(carry.topology_from_numpy(jtopo), cfg, device="cpu")
    _assert_same_run(res, jres, jstate)
    assert res.device == "cpu"


@pytest.fixture
def force_streaming_tier(monkeypatch):
    # The JAX streaming-tier tests shrink the tiled tier's budget; the
    # whole-array tier also takes these small lattices, so its cap goes too.
    monkeypatch.setattr(fused_stencil, "_VMEM_BUDGET", 1000)
    monkeypatch.setattr(fused, "MAX_FUSED_NODES", 0)


@pytest.mark.parametrize("kind,n,semantics,algorithm,max_rounds", [
    ("torus3d", 27_000, "batched", "gossip", 3000),
    ("grid3d", 8000, "batched", "push-sum", 64),
    ("ring", 500, "batched", "push-sum", 64),
    ("line", 1000, "batched", "gossip", 300),
    ("ref2d", 400, "reference", "gossip", 150),
    ("grid2d", 400, "reference", "gossip", 3000),
])
def test_fused_streaming_tier_matches_chunked(kind, n, semantics, algorithm,
                                              max_rounds, force_streaming_tier):
    topo = build_topology(kind, n, semantics=semantics)
    results = {}
    for engine in ("chunked", "fused"):
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics,
                        seed=2, engine=engine, max_rounds=max_rounds, chunk_rounds=32)
        assert runner.fused_tier(topo, cfg) == ("stencil_hbm", None)
        results[engine] = run(topo, cfg, device="cpu")
    a, b = results["chunked"], results["fused"]
    assert (a.rounds, a.converged_count, a.estimate_mae) == (
        b.rounds, b.converged_count, b.estimate_mae)
    for x, y in zip(a.state, b.state):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
    # Chunks of 32 rounds, logged as they retire.
    assert b.chunk_log[0]["rounds"] == min(32, b.rounds)


def test_fused_resume_from_carried_jax_state(force_streaming_tier):
    n, seed, mid = 27_000, 3, 12
    jtopo, jres, jstate = _jax_run("torus3d", n, "batched", "gossip", seed=seed,
                                   chunk_rounds=64)
    _, _, jmid = _jax_run("torus3d", n, "batched", "gossip", seed=seed,
                          chunk_rounds=mid, max_rounds=mid)
    start = carry.state_from_numpy({k: np.asarray(v) for k, v in jmid._asdict().items()})
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)))
    cfg = SimConfig(n=n, topology="torus3d", algorithm="gossip", seed=seed,
                    engine="fused", chunk_rounds=64)
    res = run(carry.topology_from_numpy(jtopo), cfg, key=key, device="cpu",
              start_state=start, start_round=mid)
    _assert_same_run(res, jres, jstate)


@pytest.fixture
def stub_cuda(monkeypatch):
    """run() sees a CUDA device; the dispatch must refuse before using it."""
    monkeypatch.setattr(runner, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))


@pytest.mark.parametrize("kind,n,algorithm,tier", [
    ("grid3d", 8000, "push-sum", "stencil"),
    ("line", 1000, "gossip", "stencil"),
    ("torus3d", 27_000, "gossip", "stencil2"),
    ("ring", 5000, "push-sum", "stencil2"),
])
def test_resident_tiers_dispatch_on_cuda_and_run_under_fused(kind, n, algorithm,
                                                             tier, stub_cuda,
                                                             monkeypatch):
    topo = build_topology(kind, n)
    dispatched = []
    monkeypatch.setattr(runner, "_run_fused",
                        lambda *a: dispatched.append((a[3].type, a[-1])))
    for engine in ("auto", "fused"):
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine=engine)
        assert runner.fused_tier(topo, cfg) == (tier, None)
        run(topo, cfg)
    assert dispatched == [("cuda", tier)] * 2
    monkeypatch.undo()
    # On the CPU, engine="fused" runs the tier's plain version: the chunked
    # engine's trajectory over a bounded run.
    results = {}
    for engine in ("chunked", "fused"):
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine=engine,
                        max_rounds=64, chunk_rounds=32)
        results[engine] = run(topo, cfg, device="cpu")
    a, b = results["chunked"], results["fused"]
    assert (a.rounds, a.converged_count, a.estimate_mae) == (
        b.rounds, b.converged_count, b.estimate_mae)
    for x, y in zip(a.state, b.state):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def test_lattice_configs_outside_the_slice_name_roadmap_items():
    for kw, item in (({"topology": "imp3d", "halo_dma": "on"}, "A10"),
                     ({"topology": "ring", "plan": "auto"}, "A11"),
                     ({"topology": "line", "strict_engine": True}, "A12"),
                     ({"topology": "torus3d", "dtype": "float64"}, "A12")):
        fields = {"n": 1000, "algorithm": "push-sum", **kw}
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            SimConfig(**fields)
    # Replicas are ported (models/sweep.py).
    assert SimConfig(n=1000, algorithm="push-sum", topology="imp2d", replicas=2).replicas == 2
    with pytest.raises(ValueError, match="delivery='pool' applies"):
        SimConfig(n=1000, topology="grid2d", delivery="pool")
    with pytest.raises(ValueError, match="offset-structured"):
        SimConfig(n=1000, topology="full", delivery="stencil")
    # A 1-node ring is a self-loop: no displacement class, so the JAX
    # chunked engine delivers it by scatter, and the port does the same.
    res = run(build_topology("ring", 1), SimConfig(n=1, topology="ring"), device="cpu")
    jres = jax_runner.run(jax_build("ring", 1), JaxConfig(n=1, topology="ring"))
    assert (res.rounds, res.converged_count) == (jres.rounds, jres.converged_count)
    with pytest.raises(ValueError, match="not an arithmetic lattice"):
        # A 1-node line has no displacement class: the streaming tier the
        # ladder picks (as the JAX one does) cannot serve it.
        run(build_topology("line", 1),
            SimConfig(n=1, topology="line", engine="fused"), device="cpu")
