"""The port's fused imp engine (ops/fused_imp.py, ops/fused_imp_hbm.py) on
the CPU, where its wrappers run the plain versions of csrc/fused_imp.cu:

- whole runs under engine="fused" bitwise the port's chunked engine, on
  the resident tier and on the streaming tier (forced at small n by
  shrinking the copied resident budget, as the JAX package's own tests
  force it), at grid side 2 (two lattice directions in one class) too;
- single chunks from a carried JAX chunked-engine state against that
  engine's later state: 13 rounds, a cap inside the chunk, an overshoot,
  a converged start;
- a pool offset forced onto lattice classes (and onto another slot's):
  every send still lands once, as the chunked engine delivers it;
- one chunk of the JAX package's own imp kernels, run in Pallas
  interpret mode, against the plain versions;
- the tier the port's ladder picks against the JAX ladder's;
- the kernels' per-node class selection (csrc/imp.cuh), built for the
  host with g++, against the JAX sampling."""

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
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp
from cop5615_gossip_protocol_tpu.ops import fused_imp_hbm as jax_fused_imp_hbm
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling
from cop5615_gossip_protocol_tpu.ops import topology as jax_topology

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import delivery, fused, fused_imp, fused_pool
from cop5615_gossip_protocol_tpu_torch.ops import sampling, topology
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"
SEED = 4


@pytest.fixture
def force_hbm(monkeypatch):
    monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)


def _cfg(kind, n, algorithm, **kw):
    return SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                     seed=SEED, chunk_rounds=16, **kw)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _fused_vs_chunked(kind, n, algorithm, tier, **kw):
    topo = build_topology(kind, n, seed=SEED)
    results = {}
    for engine in ("chunked", "fused"):
        cfg = _cfg(kind, n, algorithm, engine=engine, **kw)
        assert runner.fused_tier(topo, cfg) == (tier, None)
        results[engine] = run(topo, cfg, device="cpu")
    a, b = results["chunked"], results["fused"]
    assert (a.rounds, a.converged, a.converged_count, a.estimate_mae) == (
        b.rounds, b.converged, b.converged_count, b.estimate_mae)
    _assert_bitwise(a.state, b.state)
    return b


@pytest.mark.parametrize("kind,n,algorithm,kw", [
    ("imp3d", 1000, "gossip", {}),
    ("imp2d", 300, "push-sum", {"pool_size": 2, "max_rounds": 40}),
    ("imp3d", 8, "push-sum", {"max_rounds": 60}),
    ("imp2d", 4, "gossip", {"pool_size": 2, "rumor_threshold": 3}),
])
def test_resident_tier_matches_chunked(kind, n, algorithm, kw):
    res = _fused_vs_chunked(kind, n, algorithm, "imp", **kw)
    assert res.converged or res.rounds == kw.get("max_rounds")
    assert res.chunk_log[0]["rounds"] == min(16, res.rounds)


@pytest.mark.parametrize("kind,n,algorithm,kw", [
    ("imp3d", 1000, "push-sum", {"max_rounds": 40}),
    ("imp2d", 300, "gossip", {"suppress_converged": True}),
])
def test_streaming_tier_matches_chunked(kind, n, algorithm, kw, force_hbm):
    res = _fused_vs_chunked(kind, n, algorithm, "imp_hbm", **kw)
    assert res.converged or res.rounds == kw.get("max_rounds")


def _jax_states(kind, n, algorithm, mid, rounds):
    """JAX chunked-engine states at absolute rounds mid and mid + rounds."""
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                    seed=SEED, engine="chunked", chunk_rounds=mid,
                    max_rounds=mid + rounds)
    seen = []
    jtopo = jax_build(kind, n, seed=SEED)
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: seen.append((r, s)))
    return jtopo, seen, res


def _planes(state, layout):
    st = carry.state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()})
    if hasattr(st, "s"):
        return (fused._pad2d(st.s, layout, 0.0), fused._pad2d(st.w, layout, 1.0),
                fused._pad2d(st.term, layout, 0),
                fused._pad2d(st.conv.to(torch.int32), layout, 0))
    return tuple(fused._pad2d(x.to(torch.int32), layout, 0) for x in st)


def _chunk_fn(topo, algorithm, tier="imp"):
    cfg = _cfg(topo.kind, topo.n_requested, algorithm)
    eng = runner.fused_engine(topo, cfg, carry.key_from_numpy(
        np.asarray(jax.random.PRNGKey(SEED))), tier)
    return eng.chunk, eng.streams, eng.layout


@pytest.mark.parametrize("algorithm,mid", [("push-sum", 30), ("gossip", 6)])
def test_chunks_match_jax_chunked_rounds(algorithm, mid):
    jtopo, seen, _ = _jax_states("imp3d", 1000, algorithm, mid, 13)
    (r0, s0), (r1, s1) = seen[0], seen[-1]
    assert (r0, r1) == (mid, mid + 13)
    topo = carry.topology_from_numpy(jtopo)
    chunk, streams, layout = _chunk_fn(topo, algorithm)
    before = (fused_imp.pushsum_imp_chunk.launches, fused_imp.gossip_imp_chunk.launches)
    start = _planes(s0, layout)
    out, executed = chunk(start, streams(mid, 13), mid, mid + 13)  # K = 13
    assert int(executed) == 13
    _assert_bitwise(out, _planes(s1, layout))
    # A cap inside the chunk stops it there, and a chunk at its cap runs
    # nothing and leaves the state as it was.
    _, seen5, _ = _jax_states("imp3d", 1000, algorithm, mid, 5)
    out, executed = chunk(start, streams(mid, 16), mid, mid + 5)
    assert int(executed) == 5
    _assert_bitwise(out, _planes(seen5[-1][1], layout))
    out, executed = chunk(start, streams(mid, 16), mid, mid)
    assert int(executed) == 0
    _assert_bitwise(out, start)
    # CPU tensors run the plain version and launch nothing.
    assert before == (fused_imp.pushsum_imp_chunk.launches,
                      fused_imp.gossip_imp_chunk.launches)


def test_chunk_from_a_converged_state_runs_nothing():
    topo = build_topology("imp2d", 300, seed=SEED)
    res = run(topo, _cfg("imp2d", 300, "gossip"), device="cpu")
    assert res.converged
    chunk, streams, layout = _chunk_fn(topo, "gossip", "imp_hbm")
    planes = tuple(fused._pad2d(x.to(torch.int32), layout, 0) for x in res.state)
    out, executed = chunk(planes, streams(res.rounds, 16), res.rounds, res.rounds + 16)
    assert int(executed) == 0
    _assert_bitwise(out, planes)


@pytest.mark.parametrize("kind,n", [("imp3d", 1000), ("imp3d", 8), ("imp2d", 4)])
def test_pool_offsets_on_lattice_classes_deliver_once(kind, n):
    # Every node active and sending: one round must add exactly one receipt
    # per real node, whatever the pool offsets alias, and equal the chunked
    # engine's delivery on the same draws.
    topo = build_topology(kind, n, seed=SEED)
    spec = fused_imp.imp_spec(topo)
    layout = fused_pool.build_pool_layout(topo.n)
    lattice = list(spec.classes)
    offs = torch.tensor([[lattice[0], lattice[-1], lattice[0], 1]], dtype=torch.int32)
    key = torch.tensor([[11, 22]], dtype=torch.int64)
    ckey = sampling.imp_choice_key(key[0])[None]
    real = fused._pad2d(torch.ones(topo.n, dtype=torch.int32), layout, 0)
    zero = torch.zeros_like(real)
    (count, _, _), executed = fused_imp.gossip_imp_chunk(
        (zero, real, zero), key, offs, ckey, 0, 1, spec=spec, target=topo.n,
        rumor_target=10, suppress=False)
    assert int(executed) == 1 and int(count.sum()) == topo.n
    split = topology.imp_split(topo)
    cfg = _cfg(kind, n, "gossip")
    d, is_extra, choice, _, _ = runner.imp_pool_parts(
        topo, cfg, key[0], torch.from_numpy(split.disp_cols),
        torch.from_numpy(split.degree))
    want = delivery.deliver_imp_pool(torch.ones(1, topo.n, dtype=torch.int32), d,
                                     is_extra, choice, lattice, offs[0].tolist())[0]
    assert torch.equal(count.reshape(-1)[:topo.n], want)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_plain_versions_match_the_jax_kernels_in_interpret_mode(algorithm):
    # One 8-round chunk of the JAX package's resident imp kernel (Pallas
    # interpret mode on the CPU) against the port's plain version.
    n, rounds = 1000, 8
    jtopo = jax_build("imp3d", n, seed=SEED)
    jcfg = JaxConfig(n=n, topology="imp3d", algorithm=algorithm, delivery="pool",
                     engine="fused", seed=SEED)
    make = (jax_fused_imp.make_pushsum_imp_chunk if algorithm == "push-sum"
            else jax_fused_imp.make_gossip_imp_chunk)
    jchunk, jlayout = make(jtopo, jcfg, interpret=True)
    jkey = jax.random.PRNGKey(SEED)
    from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
    from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool

    mid = 20 if algorithm == "push-sum" else 4
    _, seen, _ = _jax_states("imp3d", n, algorithm, mid, 1)
    start = _planes(seen[0][1], fused_pool.build_pool_layout(jtopo.n))
    jout, jex = jchunk(tuple(jnp.asarray(p.numpy()) for p in start),
                       jax_fused.round_keys(jkey, mid, rounds),
                       jax_fused_pool.round_offsets(jkey, mid, rounds, 4, jtopo.n),
                       jax_fused_imp.choice_round_keys(jkey, mid, rounds), mid, mid + rounds)
    topo = carry.topology_from_numpy(jtopo)
    chunk, streams, _ = _chunk_fn(topo, algorithm)
    out, executed = chunk(start, streams(mid, rounds), mid, mid + rounds)
    assert int(executed) == int(jex) == rounds
    _assert_bitwise(out, tuple(torch.from_numpy(np.array(x)) for x in jout))


def _jax_tier(topo, cfg):
    """The JAX runner's imp ladder (models/runner.py) on its own predicates."""
    reason = jax_fused_imp.imp_fused_support(topo, cfg)
    if reason is not None and jax_fused_imp_hbm.imp_hbm_support(topo, cfg) is None:
        return "imp_hbm", None
    return "imp", reason


@pytest.mark.parametrize("force", [False, True])
def test_ladder_matches_jax(force, monkeypatch):
    if force:
        monkeypatch.setattr(jax_fused_imp, "_VMEM_BUDGET", 1000)
        monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)
    seen = set()
    for kind, n in (("imp3d", 1000), ("imp3d", 8), ("imp2d", 300), ("imp2d", 4)):
        jtopo = jax_build(kind, n, seed=SEED)
        topo = carry.topology_from_numpy(jtopo)
        for algorithm in ("push-sum", "gossip"):
            for pool_size in (4, 16, 32):
                kw = {"n": n, "topology": kind, "algorithm": algorithm,
                      "delivery": "pool", "pool_size": pool_size}
                want = _jax_tier(jtopo, JaxConfig(**kw))
                got = runner.fused_tier(topo, SimConfig(**kw))
                assert got[0] == want[0] and (got[1] is None) == (want[1] is None), kw
                seen.add(got)
    assert {t for t, r in seen if r is None} == ({"imp_hbm"} if force else {"imp"})


def test_ladder_budget_at_the_tier_boundaries():
    # The JAX ladder's tiers for the imp configs up to 16.8M, by the
    # budget function alone: no million-node topology is built here.
    table = [("imp2d", 100_489, 5, "push-sum", "imp"), ("imp3d", 10**6, 7, "push-sum", "imp"),
             ("imp3d", 10**6, 7, "gossip", "imp"), ("imp3d", 1_331_000, 7, "push-sum", "imp"),
             ("imp3d", 1_520_875, 7, "push-sum", "imp_hbm"),
             ("imp3d", 2_000_376, 7, "gossip", "imp_hbm"),
             ("imp3d", 2**24, 7, "push-sum", "imp_hbm"), ("imp3d", 2**24, 7, "gossip", "imp_hbm")]
    for kind, n, max_deg, algorithm, tier in table:
        n_pad = fused_pool.build_pool_layout(n).n_pad
        got = fused_imp._plane_bytes(n_pad, max_deg, algorithm)
        assert got == jax_fused_imp._plane_bytes(n_pad, max_deg, algorithm)
        assert fused_imp._VMEM_BUDGET == jax_fused_imp._VMEM_BUDGET
        assert ("imp" if got <= fused_imp._VMEM_BUDGET else "imp_hbm") == tier, (n, algorithm)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    topo = build_topology("imp3d", 1000, seed=SEED)
    spec = fused_imp.imp_spec(topo)
    layout = fused_pool.build_pool_layout(topo.n)
    planes = (torch.zeros(layout.rows, 128, dtype=torch.int32),) * 3
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(0)))
    keys, ckeys = fused.round_keys(key, 0, 4), fused_imp.choice_round_keys(key, 0, 4)
    offs = fused_pool.round_offsets(key, 0, 4, 4, topo.n)
    common = {"spec": spec, "target": topo.n, "rumor_target": 10, "suppress": False}
    with pytest.raises(ValueError, match="state plane"):
        fused_imp.gossip_imp_chunk(tuple(p[:-1] for p in planes), keys, offs, ckeys, 0, 4,
                                   **common)
    with pytest.raises(ValueError, match="ckeys must be int64"):
        fused_imp.gossip_imp_chunk(planes, keys, offs, ckeys[:3], 0, 4, **common)
    with pytest.raises(ValueError, match=r"offs must lie in \[1, 999\]"):
        fused_imp.gossip_imp_chunk(planes, keys, offs * 0, ckeys, 0, 4, **common)
    with pytest.raises(ValueError, match="pool_size"):
        fused_imp.gossip_imp_chunk(planes, keys, fused_pool.round_offsets(
            key, 0, 4, 32, topo.n), ckeys, 0, 4, **common)
    with pytest.raises(ValueError, match="host-drawn"):
        fused_imp.gossip_imp_chunk(planes, keys, offs, ckeys.to("meta"), 0, 4, **common)
    with pytest.raises(ValueError, match="batched imp build"):
        fused_imp.imp_spec(build_topology("imp3d", 1000, semantics="reference"))


SHIM = r"""
#include "imp.cuh"
using namespace gossip;
extern "C" void classes(int kind, int n, const int* lat, int n_lat,
                        const uint32_t* bits, const int* choice, int* out) {
  const Lattice L = make_lattice(kind, n, 0);
  Classes c;
  c.count = n_lat;
  for (int k = 0; k < kMaxClasses; ++k) c.d[k] = k < n_lat ? lat[k] : 0;
  for (int j = 0; j < n; ++j) out[j] = imp_class(L, c, j, bits[j], choice[j]);
}
extern "C" void choices(uint32_t k1, uint32_t k2, int n, int pool_size, int* out) {
  for (int j = 0; j < n; ++j)
    out[j] = pool_slot(threefry_word(k1, k2, choice_counter(j)), choice_sub(j), pool_size);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("imp_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("kind,n,pool_size", [
    ("imp3d", 1000, 4), ("imp3d", 8, 16), ("imp2d", 4, 2), ("imp2d", 70_000, 8)])
def test_header_class_selection_matches_jax_sampling(shim, kind, n, pool_size):
    jtopo = jax_build(kind, n, seed=SEED)
    n = jtopo.n
    split = jax_topology.imp_split(jtopo)
    cfg = JaxConfig(n=n, topology=kind, delivery="pool", pool_size=pool_size)
    kr = jax_sampling.round_key(jax.random.PRNGKey(7), 3)
    d, is_extra, choice, _, _ = (np.asarray(x) for x in jax_runner.imp_pool_parts(
        jtopo, cfg, kr, jnp.asarray(split.disp_cols), jnp.asarray(split.degree)))
    lattice = np.ascontiguousarray(split.lattice_offsets, dtype=np.int32)
    want = np.where(is_extra, len(lattice) + choice, np.searchsorted(lattice, d))
    # The packed choice words, from the choice key (counters past 2**16).
    ck = [int(v) for v in np.asarray(jax_sampling.imp_choice_key(kr))]
    got_choice = np.zeros(n, dtype=np.int32)
    shim.choices(ctypes.c_uint32(ck[0]), ctypes.c_uint32(ck[1]), n, pool_size,
                 _ptr(got_choice))
    assert (got_choice == choice).all()
    bits = np.ascontiguousarray(jax_sampling.uniform_bits(kr, n), dtype=np.uint32)
    got = np.zeros(n, dtype=np.int32)
    shim.classes({"imp2d": 2, "imp3d": 3}[kind], n, _ptr(lattice), len(lattice),
                 _ptr(bits), _ptr(np.ascontiguousarray(choice, dtype=np.int32)), _ptr(got))
    assert (got == want).all()
