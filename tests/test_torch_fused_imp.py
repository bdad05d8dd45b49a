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
- the kernels' per-node class selection and mark loop (csrc/imp.cuh, read
  through ``imp_dir_words``), built for the host with g++, against the JAX
  sampling, pad lanes and a real node with word 0 included; the words
  against the topology's direction pairs; the launches a chunk queues."""

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
extern "C" void classes(int n, const uint32_t* words, int n_lat, const uint32_t* bits,
                        const int* choice, int* out) {
  for (int j = 0; j < n; ++j) {
    const int q = imp_lattice_class(words[j], bits[j]);
    out[j] = q >= 0 ? q : n_lat + choice[j];
  }
}
extern "C" void choices(uint32_t k1, uint32_t k2, int n, int pool_size, int* out) {
  for (int j = 0; j < n; ++j)
    out[j] = pool_slot(threefry_word(k1, k2, choice_counter(j)), choice_sub(j), pool_size);
}
// The kernels' mark loop (csrc/fused_imp.cu, the prologue and the next
// marks of a round): one node a step, the choice word hashed only for the
// long-range slot.
extern "C" void marks(const uint32_t* words, uint32_t k1, uint32_t k2, uint32_t c1,
                      uint32_t c2, int n, int n_pad, int pool_size, int n_lat,
                      const int* active, int8_t* out) {
  for (int j = 0; j < n_pad; ++j)
    out[j] = j < n && (active == nullptr || active[j] != 0)
                 ? imp_mark(words[j], k1, k2, c1, c2, j, pool_size, n_lat)
                 : (int8_t)-1;
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
    so = ctypes.CDLL(str(lib))
    u32, P, I = ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int
    so.marks.argtypes = [P] + [u32] * 4 + [I] * 4 + [P, P]
    return so


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _jax_draw(kind, n, pool_size, rnd=3):
    """The JAX imp draw of one round: (jtopo, the class id of every real
    node, its pool choice, the sorted lattice classes, the round key and
    choice key as uint32 pairs)."""
    jtopo = jax_build(kind, n, seed=SEED)
    split = jax_topology.imp_split(jtopo)
    cfg = JaxConfig(n=jtopo.n, topology=kind, delivery="pool", pool_size=pool_size)
    kr = jax_sampling.round_key(jax.random.PRNGKey(7), rnd)
    d, is_extra, choice, _, _ = (np.asarray(x) for x in jax_runner.imp_pool_parts(
        jtopo, cfg, kr, jnp.asarray(split.disp_cols), jnp.asarray(split.degree)))
    lattice = np.ascontiguousarray(split.lattice_offsets, dtype=np.int32)
    want = np.where(is_extra, len(lattice) + choice, np.searchsorted(lattice, d))
    words = [[int(v) for v in np.asarray(k)] for k in (kr, jax_sampling.imp_choice_key(kr))]
    return jtopo, want, choice, lattice, words


def _dir_words(kind, n):
    topo = build_topology(kind, n, seed=SEED)
    rows = fused_pool.build_pool_layout(topo.n).rows
    words = fused_imp.imp_dir_words(fused_imp.imp_spec(topo), rows, torch.device("cpu"))
    return np.ascontiguousarray(words.numpy().view(np.uint32)), rows * 128


@pytest.mark.parametrize("kind,n,pool_size", [
    ("imp3d", 1000, 4), ("imp3d", 8, 16), ("imp2d", 4, 2), ("imp2d", 70_000, 8)])
def test_header_class_selection_matches_jax_sampling(shim, kind, n, pool_size):
    jtopo, want, choice, lattice, (kr, ck) = _jax_draw(kind, n, pool_size)
    n = jtopo.n
    # The packed choice words, from the choice key (counters past 2**16).
    got_choice = np.zeros(n, dtype=np.int32)
    shim.choices(ctypes.c_uint32(ck[0]), ctypes.c_uint32(ck[1]), n, pool_size,
                 _ptr(got_choice))
    assert (got_choice == choice).all()
    kr_jax = jax_sampling.round_key(jax.random.PRNGKey(7), 3)
    bits = np.ascontiguousarray(jax_sampling.uniform_bits(kr_jax, n), dtype=np.uint32)
    words, _ = _dir_words(kind, n)
    got = np.zeros(n, dtype=np.int32)
    shim.classes(n, _ptr(words), len(lattice), _ptr(bits),
                 _ptr(np.ascontiguousarray(choice, dtype=np.int32)), _ptr(got))
    assert (got == want).all()


@pytest.mark.parametrize("kind,n,pool_size", [
    ("imp3d", 1000, 2), ("imp3d", 8, 4), ("imp2d", 4, 16), ("imp2d", 70_000, 4),
    ("imp3d", 27_000, 16)])
def test_header_marks_match_the_jax_draw(shim, kind, n, pool_size):
    """The kernels' mark loop (the directions word, the slot hash, the
    choice word hashed for the long-range slot) over the whole padded layout:
    every real node's mark is the JAX draw's class, with the port's plain
    imp_marks beside it, every pad lane -1; gossip marks only its active
    nodes. Covers pad lanes (all but imp2d 4), grid side 2 (imp3d 8, imp2d
    4: two directions in one class) and pool widths 2 to 16."""
    jtopo, want, _, lattice, (kr, ck) = _jax_draw(kind, n, pool_size)
    n = jtopo.n
    words, n_pad = _dir_words(kind, n)
    gen = np.random.default_rng(2)
    active = np.ascontiguousarray(gen.random(n_pad) < 0.5, dtype=np.int32)
    plain = fused_imp.imp_marks(fused_imp.imp_spec(build_topology(kind, n, seed=SEED)),
                                kr, ck, pool_size, 0, n_pad // 128).numpy()
    for act in (None, active):
        got = np.empty(n_pad, dtype=np.int8)
        shim.marks(_ptr(words), *kr, *ck, n, n_pad, pool_size, len(lattice), _ptr(act),
                   _ptr(got))
        mask = np.ones(n, dtype=bool) if act is None else act[:n] != 0
        assert (got[:n] == np.where(mask, want, -1)).all()
        assert (got[n:] == -1).all()
        assert (got == np.where(np.arange(n_pad) < n, np.where(
            np.ones(n_pad, bool) if act is None else act != 0, plain, -1), -1)).all()
    assert (want >= len(lattice)).any() and (want < len(lattice)).any()


def test_a_real_node_with_word_zero_still_sends(shim):
    """Word 0 (degree 0) on a real node leaves it one slot, the long-range
    one: it sends along class L + its choice, never -1; pad lanes, whose
    word is 0 too, stay -1 because the loop tests j < n."""
    n, n_pad, L, pool_size = 1500, 2048, 6, 4
    bits = np.ascontiguousarray(np.random.default_rng(3).integers(
        0, 2**32, n_pad, dtype=np.uint64).astype(np.uint32))
    choice = np.ascontiguousarray(np.arange(n_pad) % pool_size, dtype=np.int32)
    zeros = np.zeros(n_pad, dtype=np.uint32)
    got = np.zeros(n_pad, dtype=np.int32)
    shim.classes(n_pad, _ptr(zeros), L, _ptr(bits), _ptr(choice), _ptr(got))
    assert (got == L + choice).all()
    marks = np.empty(n_pad, dtype=np.int8)
    shim.marks(_ptr(zeros), 1, 2, 3, 4, n, n_pad, pool_size, L, None, _ptr(marks))
    assert (marks[:n] >= L).all() and (marks[:n] < L + pool_size).all()
    assert (marks[n:] == -1).all()


def test_imp_dir_words_hold_the_live_directions():
    """imp_dir_words against the topology's own direction pairs in numpy:
    per real node the class ids of its live grid directions in column
    order and their count; 0 on pad lanes. imp3d 8 (side 2, shared
    classes), imp3d 1000 and imp2d 100,489 with pad lanes."""
    for kind, n in (("imp3d", 8), ("imp3d", 1000), ("imp2d", 100_000)):
        topo = build_topology(kind, n, seed=SEED)
        spec = fused_imp.imp_spec(topo)
        rows = fused_pool.build_pool_layout(topo.n).rows
        got = fused_imp.imp_dir_words(spec, rows, torch.device("cpu")).numpy()
        g = np.arange(rows * 128)
        classes = np.asarray(spec.classes)
        want, deg = np.zeros_like(g), np.zeros_like(g)
        for live, d in topology.lattice_dirs(topology.IMP_LATTICE[kind], topo.n, topo.n, g):
            live = live & (g < topo.n)
            k = np.searchsorted(classes, d)
            assert (classes[k[live]] == d[live]).all()
            want = want | np.where(live, k << (4 * deg), 0)
            deg = deg + live
        assert (got == (want | deg << 24)).all() and (got[topo.n:] == 0).all()
        assert (deg[:topo.n] >= 1).all()


def test_a_chunk_queues_its_rounds_and_three():
    """The launches a chunk of csrc/fused_imp.cu queues, as its wrappers
    count them: init, the mark prologue, one a round, finish."""
    assert [fused_imp.chunk_launches(k) for k in (0, 1, 2, 32)] == [3, 4, 5, 35]
