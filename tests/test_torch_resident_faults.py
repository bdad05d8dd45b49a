"""The resident lattice tiers' failure model on the CPU, where their
wrappers run the plain version (ops/fused_stencil_hbm.py's ``*_plain``,
which the kernels of csrc/fused_resident.cu are held against on the card):
the drop gate, crash-stop with quorum termination and push-sum's global
termination on the whole-array tier (``stencil``, ops/fused.py), and global
termination on the tiled tier (``stencil2``, ops/fused_stencil.py), against
the JAX package:

- single chunks: one 8-round chunk of the JAX tier's Pallas kernel in
  interpret mode (make_pushsum_chunk, make_gossip_chunk,
  make_pushsum_stencil2_chunk) against the port's wrapper on the same
  start state, every plane and the executed count bitwise, on a non-wrap
  lattice whose n is no multiple of 128 (line 1000, grid2d 900) and wrap
  ones whose n is (torus3d 512, ring 1024), across death rounds and with
  caps after odd and even rounds; a chunk from the verdict runs 0 rounds;
- whole runs: ``run(engine="fused", device="cpu")`` against the JAX chunked
  engine (rounds, converged count, outcome, estimate, every plane bitwise;
  a crash run of push-sum on a sparse lattice drains nodes into the
  subnormals, which XLA's CPU round flushes in part: such a run is held
  against the JAX package to round 100 and against the port's chunked
  engine to its end);
- the tiled tier's wrappers refuse the gate and crash-stop;
- csrc/faults.cuh's folded mark built with g++ against the plain
  version's ``ChunkFaults.blocked``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.models import gossip as jax_gossip
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil

from cop5615_gossip_protocol_tpu_torch import SimConfig, run
from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_stencil, fused_stencil_hbm, rng
from cop5615_gossip_protocol_tpu_torch.utils import carry

from test_torch_runner_faults import drains, planes_differ

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEED = 6
K = 8
CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"


def _jax_run(kind, n, algorithm, **kw):
    """A JAX chunked-engine run: (topology, result, final state)."""
    final = {}
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, engine="chunked",
                    seed=SEED, **kw)
    jtopo = jax_build(kind, n)
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: final.__setitem__("s", s))
    return jtopo, res, final["s"]


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


def _launches():
    return (fused.pushsum_chunk.launches, fused.gossip_chunk.launches,
            fused_stencil.pushsum_stencil2_chunk.launches,
            fused_stencil.gossip_stencil2_chunk.launches)


_MAKE = {("stencil", "push-sum"): jax_fused.make_pushsum_chunk,
         ("stencil", "gossip"): jax_fused.make_gossip_chunk,
         ("stencil2", "push-sum"): jax_fused_stencil.make_pushsum_stencil2_chunk}


def _start(kind, n, algorithm, knobs, start):
    """(JAX topology, the JAX chunked engine's state at round ``start``,
    its round): the initial state at 0, else the run to ``start`` (or to
    its verdict, for start None)."""
    if start == 0:
        jtopo = jax_build(kind, n)
        if algorithm == "push-sum":
            return jtopo, jax_pushsum.init_state(jtopo.n, jnp.float32, 0), 0
        cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED, **knobs)
        leader = jax_runner.draw_leader(jax.random.PRNGKey(SEED), jtopo, cfg)
        return jtopo, jax_gossip.init_state(jtopo.n, leader, False), 0
    if start is None:
        jtopo, res, st = _jax_run(kind, n, algorithm, **knobs)
        assert res.converged
        return jtopo, st, res.rounds
    jtopo, res, st = _jax_run(kind, n, algorithm, max_rounds=start, chunk_rounds=start,
                              **knobs)
    assert res.rounds == start and not res.converged
    return jtopo, st, start


def _both_chunks(kind, n, tier, algorithm, knobs, start, cap_after=None):
    """One chunk of the JAX tier's kernel in interpret mode and of the
    port's tier wrapper from the same state: (JAX planes, JAX executed,
    port planes, port executed, start planes, start round)."""
    jtopo, st, start = _start(kind, n, algorithm, knobs, start)
    jcfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, engine="fused", seed=SEED,
                     **knobs)
    jchunk, jlayout = _MAKE[tier, algorithm](jtopo, jcfg, interpret=True)
    jkey = jax.random.PRNGKey(SEED)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED, **knobs)
    assert fused_tier(topo, cfg) == (tier, None)
    eng = fused_engine(topo, cfg, carry.key_from_numpy(np.asarray(jkey)), tier)
    assert (eng.layout.n_pad, eng.layout.rows) == (jlayout.n_pad, jlayout.rows)
    planes = _planes(st, eng.layout)
    cap = start + (K if cap_after is None else cap_after)
    jout, jex = jchunk(tuple(jnp.asarray(p.numpy()) for p in planes),
                       jax_fused.round_keys(jkey, start, K), start, cap)
    before = _launches()
    out, executed = eng.chunk(planes, eng.streams(start, K), start, cap)
    # CPU tensors run the plain version and launch nothing.
    assert _launches() == before
    return (tuple(torch.from_numpy(np.array(x)) for x in jout), int(jex), out,
            int(executed), planes, start)


GATE_SCHEDULE = {"fault_rate": 0.2, "crash_schedule": "43:100,46:50", "quorum": 0.9}
GATE_RATE = {"fault_rate": 0.1, "crash_rate": 0.01, "quorum": 0.8}

# (kind, n, tier, algorithm, knobs, start round, cap after): the schedules'
# death rounds fall inside the chunk.
CHUNKS = [
    ("line", 1000, "stencil", "gossip", GATE_SCHEDULE, 40, None),
    ("line", 1000, "stencil", "push-sum", GATE_SCHEDULE, 40, 5),
    ("grid2d", 900, "stencil", "push-sum",
     {"fault_rate": 0.1, "crash_schedule": "2:50,5:100", "quorum": 0.95}, 0, None),
    ("grid2d", 900, "stencil", "gossip", GATE_RATE, 10, 6),
    ("ring", 1024, "stencil", "push-sum", GATE_RATE, 30, None),
    ("torus3d", 512, "stencil", "gossip",
     {"crash_schedule": "5:40,9:10", "quorum": 0.9}, 3, 5),
    ("torus3d", 512, "stencil", "push-sum", {"termination": "global"}, 20, None),
    ("line", 1000, "stencil", "push-sum", {"fault_rate": 0.1, "termination": "global"},
     0, 6),
    # Row 7: the tiled tier carries global termination alone.
    ("torus3d", 1000, "stencil2", "push-sum", {"termination": "global"}, 20, None),
    ("ring", 300, "stencil2", "push-sum", {"termination": "global"}, 0, 5),
]


@pytest.mark.parametrize("kind,n,tier,algorithm,knobs,start,cap_after", CHUNKS,
                         ids=lambda x: str(x).replace(" ", ""))
def test_faulted_chunk_matches_the_jax_kernel(kind, n, tier, algorithm, knobs, start,
                                              cap_after):
    jout, jex, out, executed, planes, _ = _both_chunks(kind, n, tier, algorithm,
                                                       knobs, start, cap_after)
    assert executed == jex == (K if cap_after is None else cap_after)
    _assert_bitwise(out, jout)
    assert any(not torch.equal(a, b) for a, b in zip(out, planes))


@pytest.mark.parametrize("kind,n,tier,algorithm,knobs", [
    ("grid2d", 900, "stencil", "gossip", {"crash_schedule": "3:100,6:50", "quorum": 0.9}),
    ("torus3d", 512, "stencil", "push-sum", {"termination": "global"}),
    ("torus3d", 1000, "stencil2", "push-sum", {"termination": "global"}),
])
def test_chunk_from_the_verdict_runs_no_round(kind, n, tier, algorithm, knobs):
    # A resumed chunk that starts at the quorum (or the global verdict):
    # the seed verdict of round start - 1 stops it before any round.
    jout, jex, out, executed, planes, start = _both_chunks(kind, n, tier, algorithm,
                                                           knobs, None)
    assert start > 0 and executed == jex == 0
    _assert_bitwise(out, jout)
    _assert_bitwise(out, planes)


def test_tiled_tier_refuses_the_gate_and_crash_stop():
    topo = carry.topology_from_numpy(jax_build("torus3d", 1000))
    spec = fused_stencil_hbm.stencil_spec(topo)
    key = rng.PRNGKey(SEED)
    for knobs in ({"fault_rate": 0.1}, {"crash_rate": 0.01, "quorum": 0.9}):
        cfg = SimConfig(n=1000, topology="torus3d", algorithm="gossip", **knobs)
        assert fused_tier(topo, cfg)[0] == "stencil2"
        eng = fused_engine(topo, SimConfig(n=1000, topology="torus3d",
                                           algorithm="gossip"), key, "stencil2")
        with pytest.raises(ValueError, match="global termination only"):
            fused_stencil.gossip_stencil2_chunk(
                eng.planes, fused.round_keys(key, 0, 4), 0, 4, spec=spec, target=1000,
                rumor_target=10, suppress=False, faults=fused.run_faults(cfg, 1000))


# (kind, n, algorithm, tier, knobs, max_rounds): whole runs on the fused
# tiers, chunks of 64 rounds.
RUNS = [
    ("grid2d", 900, "gossip", "stencil", {"fault_rate": 0.2}, None),
    ("grid2d", 900, "push-sum", "stencil", {"fault_rate": 0.2}, 600),
    ("grid2d", 900, "push-sum", "stencil", {"crash_rate": 0.002, "quorum": 0.7}, 600),
    ("grid2d", 900, "gossip", "stencil", {"crash_schedule": "3:100,6:50",
                                          "quorum": 0.95}, None),
    ("line", 1000, "gossip", "stencil", GATE_RATE, None),
    ("ring", 1024, "gossip", "stencil", {"fault_rate": 0.1, "crash_rate": 0.001,
                                         "quorum": 0.9}, None),
    ("ring", 1024, "push-sum", "stencil", {"fault_rate": 0.1, "termination": "global"},
     2000),
    ("torus3d", 512, "push-sum", "stencil", {"termination": "global"}, None),
    ("torus3d", 512, "push-sum", "stencil", {"fault_rate": 0.1,
                                             "crash_schedule": "10:50,40:100",
                                             "quorum": 0.9}, 600),
    ("torus3d", 1000, "push-sum", "stencil2", {"termination": "global"}, None),
    ("ring", 300, "push-sum", "stencil2", {"termination": "global"}, 600),
]


@pytest.mark.parametrize("kind,n,algorithm,tier,knobs,max_rounds", RUNS,
                         ids=lambda x: str(x).replace(" ", ""))
def test_fused_run_matches_jax_chunked(kind, n, algorithm, tier, knobs, max_rounds):
    bound = {} if max_rounds is None else {"max_rounds": max_rounds}
    jtopo, jres, jstate = _jax_run(kind, n, algorithm, chunk_rounds=64, **bound, **knobs)
    topo = carry.topology_from_numpy(jtopo)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED, engine="fused",
                    chunk_rounds=64, **bound, **knobs)
    assert fused_tier(topo, cfg) == (tier, None)
    before = _launches()
    res = run(topo, cfg, device="cpu")
    assert _launches() == before
    faults = "rate" if "crash_rate" in knobs else (
        "schedule" if "crash_schedule" in knobs else None)
    if drains(kind, algorithm, faults):
        # A push-sum run whose live nodes dead neighbours cut off halves
        # their mass into the subnormals, where XLA's jitted CPU round
        # flushes some halves and keeps others, and the port keeps them all,
        # as its kernels do on the card (tests/test_torch_runner_faults.py
        # early_planes). Once a node drains the trajectories may part (at
        # this seed grid2d 900 with a crash rate ends at round 523 here and
        # 530 in JAX). So the whole run is held against the port's chunked
        # engine, which tests/test_torch_runner_faults.py holds against the
        # JAX package, and the run to round 100 against the JAX package.
        chunked = run(topo, SimConfig(n=n, topology=kind, algorithm=algorithm,
                                      seed=SEED, engine="chunked", **bound, **knobs),
                      device="cpu")
        assert (res.rounds, res.converged_count, res.outcome) == (
            chunked.rounds, chunked.converged_count, chunked.outcome)
        _assert_bitwise(res.state, chunked.state)
        jtopo, jres, jstate = _jax_run(kind, n, algorithm, chunk_rounds=64,
                                       max_rounds=100, **knobs)
        res = run(topo, SimConfig(n=n, topology=kind, algorithm=algorithm, seed=SEED,
                                  engine="fused", chunk_rounds=64, max_rounds=100,
                                  **knobs), device="cpu")
    assert (res.rounds, res.converged_count, res.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert res.estimate_mae == jres.estimate_mae
    assert not any(d.any() for d in planes_differ(jstate, res.state).values())
    if algorithm == "push-sum":
        # Mass parks on the dead: summed over live and dead it is kept.
        w = res.state.w.double().sum().item()
        assert abs(w - res.population) < 1e-3 * res.population
    if knobs.get("termination") == "global" and res.converged:
        assert res.converged_count == n and (res.state.term == 0).all()


SHIM = r"""
#include "faults.cuh"
using namespace gossip;
extern "C" void marks(const int8_t* mark, const int* death, const int* needs,
                      uint32_t thresh, uint32_t k0, uint32_t k1, int start, int k,
                      int n, int8_t* out) {
  const Faults f{thresh, death, needs, start, 0};
  uint32_t g1, g2;
  round_gate_key<true>(f, k0, k1, g1, g2);
  for (int j = 0; j < n; ++j) out[j] = faulted_mark<true>(mark[j], f, k, g1, g2, j);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("resident_faults_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    so.marks.argtypes = [P, P, P, U, U, U, I, I, I, P]
    return so


@pytest.mark.parametrize("knobs", [{"fault_rate": 0.2},
                                   {"crash_rate": 0.01, "quorum": 0.9},
                                   {"fault_rate": 0.1, "crash_schedule": "5:300,7:40"}])
def test_folded_mark_is_the_plain_blocked_mark(shim, knobs):
    # The mark a kernel pass writes for a round (csrc/faults.cuh
    # faulted_mark, with the gate key derived from the round key) against
    # the plain version's ChunkFaults.blocked, pad lanes dead from round 0.
    n, rows = 1000, 8
    n_pad = rows * 128
    cfg = SimConfig(n=n, topology="line", **knobs)
    faults = fused.run_faults(cfg, n)
    start = 4
    keys = fused.round_keys(rng.PRNGKey(SEED), start, K)
    cf = faults.for_chunk(keys, start, n_pad, torch.device("cpu"))
    gen = np.random.default_rng(0)
    mark = torch.from_numpy(gen.integers(-1, 4, n_pad).astype(np.int64))
    death = (cf.death if cf.death is not None else torch.zeros(0, dtype=torch.int32))
    death = np.ascontiguousarray(death.numpy(), dtype=np.int32)
    m8 = np.ascontiguousarray(mark.numpy().astype(np.int8))
    for k in range(K):
        out = np.zeros(n_pad, np.int8)
        shim.marks(m8.ctypes.data, death.ctypes.data if death.size else None, None,
                   faults.thresh or 0, int(keys[k, 0]), int(keys[k, 1]), start, k, n_pad,
                   out.ctypes.data)
        want = cf.blocked(mark, start, k, rows).numpy()
        assert (out.astype(np.int64) == want).all()
        assert (want == -1).sum() > (mark.numpy() == -1).sum()
