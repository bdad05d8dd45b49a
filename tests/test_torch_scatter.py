"""Scatter delivery in the port (ops/delivery.deliver, ops/sampling.
targets_full, ops/scatter.py and its kernel logic csrc/scatter.cuh, the
chunked engine of models/runner.py) against the JAX package on the CPU:

- ``deliver`` against ``zeros(n).at[t].add(v)`` and ``base.at[t].add(v)``
  on values over seven decades of magnitude and both signs, bitwise;
- ``targets_full`` against the JAX draw;
- the kernel's per-node code (csrc/scatter.cuh built with g++): the
  targets, the ordered bucket sum from a shuffled bucket, and a push-sum
  node's round against the plain round;
- whole runs against the JAX chunked engine (full 1000 and 70,000, imp3d
  1000 in both semantics with its orphans, imp2d 1000, ring and line under
  delivery="scatter", both algorithms): rounds, converged count,
  estimate_mae and every state plane bitwise;
- the ladder: scatter never fuses, engine="fused" with scatter raises as
  the JAX runner does, and the refusals that stay (matmul, A7b);
- the chunked engine's host reads: one status read a chunk, none a round.
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
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import pipeline, pushsum, runner
from cop5615_gossip_protocol_tpu_torch.ops import delivery, rng, sampling, scatter

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _adversarial(rng_np, m):
    """float32 values over seven decades, both signs."""
    mag = rng_np.random(m) * 10.0 ** rng_np.integers(-3, 4, m)
    return (mag * np.where(rng_np.random(m) < 0.5, -1, 1)).astype(np.float32)


@pytest.mark.parametrize("n,m", [(1, 50), (97, 20_000), (1000, 200_000)])
def test_deliver_matches_xla_scatter_add(n, m):
    r = np.random.default_rng(n)
    t = r.integers(0, n, m).astype(np.int32)
    v = _adversarial(r, m)
    base = _adversarial(r, n)
    want = jnp.zeros(n, jnp.float32).at[t].add(v)
    got = delivery.deliver(torch.from_numpy(v), torch.from_numpy(t), n)
    assert (_bits(got.numpy()) == _bits(want)).all()
    want_b = jnp.asarray(base).at[t].add(v)
    got_b = delivery.deliver(torch.from_numpy(v), torch.from_numpy(t), n,
                             base=torch.from_numpy(base))
    assert (_bits(got_b.numpy()) == _bits(want_b)).all()
    # Two channels in one call, each its own scatter; int32 exact.
    two = delivery.deliver(torch.from_numpy(np.stack([v, v[::-1].copy()])),
                           torch.from_numpy(t), n)
    assert (_bits(two[1].numpy()) == _bits(jnp.zeros(n, jnp.float32).at[t].add(v[::-1]))).all()
    ones = delivery.deliver(torch.ones(m, dtype=torch.int32), torch.from_numpy(t), n)
    assert (ones.numpy() == np.bincount(t, minlength=n)).all()


@pytest.mark.parametrize("n", [2, 3, 1000, 70_000])
def test_targets_full_matches_jax(n):
    for seed, r in ((0, 0), (5, 17), (9, 40_000)):
        kr = jax_sampling.round_key(jax.random.PRNGKey(seed), r)
        want = jax_sampling.targets_full(jax_sampling.uniform_bits(kr, n),
                                         jnp.arange(n, dtype=jnp.int32), n)
        bits = sampling.uniform_bits(sampling.round_key(rng.PRNGKey(seed), r), n)
        got = sampling.targets_full(bits, torch.arange(n), n)
        assert (got.numpy() == np.asarray(want)).all()
        assert (got.numpy() != np.arange(n)).all()


# ---------------------------------------------------------------------------
# csrc/scatter.cuh on the host
# ---------------------------------------------------------------------------

SHIM = r"""
#include "scatter.cuh"
using namespace gossip;
extern "C" void targets(uint32_t k1, uint32_t k2, int n, const int* nbr,
                        const int* deg, int max_deg, int* out) {
  for (int i = 0; i < n; ++i) {
    const uint32_t word = threefry_word(k1, k2, (uint32_t)i);
    if (nbr == nullptr) out[i] = scatter::target_full(word, i, n);
    else out[i] = deg[i] > 0 ? scatter::target_explicit(word, nbr + (long)i * max_deg, deg[i]) : -1;
  }
}
extern "C" void sums(int* idx, float* vs, float* vw, const int* start,
                     const int* count, int n, float* acc_s, float* acc_w) {
  for (int j = 0; j < n; ++j)
    scatter::bucket_sum(idx + start[j], vs + start[j], vw + start[j], count[j],
                        acc_s[j], acc_w[j]);
}
extern "C" void nodes(const float* s, const float* w, const int* term,
                      const unsigned char* conv, const unsigned char* sends,
                      int* idx, float* vs, float* vw, const int* start,
                      const int* count, int n, float delta, int term_rounds,
                      float* s_new, float* w_new, int* t_new, int* c_new) {
  for (int j = 0; j < n; ++j)
    c_new[j] = scatter::pushsum_node(s[j], w[j], term[j], conv[j] != 0, sends[j] != 0,
                                     idx + start[j], vs + start[j], vw + start[j],
                                     count[j], delta, term_rounds, s_new[j], w_new[j],
                                     t_new[j]);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("scatter_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _staged(targets, send_ok, values, n, r):
    """The kernel's bucket planes for these sends, each bucket shuffled
    (the place pass's atomic order): start, count, idx, and the values."""
    senders = np.nonzero(send_ok)[0]
    t = targets[senders]
    count = np.bincount(t, minlength=n).astype(np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    order = np.argsort(t, kind="stable")
    idx = senders[order].astype(np.int32)
    vals = [v[senders][order].astype(np.float32) for v in values]
    for j in range(n):
        seg = slice(start[j], start[j] + count[j])
        perm = r.permutation(count[j])
        idx[seg] = idx[seg][perm]
        for v in vals:
            v[seg] = v[seg][perm]
    return start, count, idx, vals


@pytest.mark.parametrize("kind,n", [("full", 1000), ("full", 2), ("imp3d", 1000),
                                    ("ring", 500)])
def test_kernel_targets_match_the_plain_draw(shim, kind, n):
    topo = build_topology(kind, n, semantics="reference" if kind == "imp3d" else "batched")
    n = topo.n
    graph = scatter.scatter_graph(topo, "cpu")
    key = sampling.round_key(rng.PRNGKey(3), 11)
    want, send_ok = scatter.round_targets(graph, key)
    out = np.empty(n, np.int32)
    nbr = None if topo.implicit else np.ascontiguousarray(topo.neighbors, np.int32)
    deg = None if topo.implicit else np.ascontiguousarray(topo.degree, np.int32)
    shim.targets(ctypes.c_uint32(int(key[0])), ctypes.c_uint32(int(key[1])), n, _ptr(nbr),
                 _ptr(deg), 0 if nbr is None else nbr.shape[1], _ptr(out))
    expect = np.where(send_ok.numpy(), want.numpy(), -1)
    assert (out == expect).all()
    if kind == "imp3d":
        assert (~send_ok.numpy()).any()  # the Q8 orphans do not send


def test_kernel_bucket_sum_is_the_serial_order(shim):
    r = np.random.default_rng(7)
    n, m = 300, 3000
    t = r.integers(0, n, m)
    v = _adversarial(r, m)
    u = _adversarial(r, m)
    start, count, idx, (vs, vw) = _staged(t, np.ones(m, bool), (v, u), n, r)
    acc_s = _adversarial(r, n)
    acc_w = np.zeros(n, np.float32)
    want_s = jnp.asarray(acc_s).at[t].add(v)
    want_w = jnp.zeros(n, jnp.float32).at[t].add(u)
    shim.sums(_ptr(idx), _ptr(vs), _ptr(vw), _ptr(start), _ptr(count), n, _ptr(acc_s),
              _ptr(acc_w))
    assert (_bits(acc_s) == _bits(want_s)).all()
    assert (_bits(acc_w) == _bits(want_w)).all()


@pytest.mark.parametrize("kind,n,semantics", [("full", 1000, "batched"),
                                              ("imp3d", 1000, "reference")])
def test_kernel_pushsum_node_matches_the_plain_round(shim, kind, n, semantics):
    topo = build_topology(kind, n, semantics=semantics)
    n = topo.n
    graph = scatter.scatter_graph(topo, "cpu")
    r = np.random.default_rng(1)
    # A mid-run-like state: mixed masses, some terms, some converged.
    state = pushsum.PushSumState(
        s=torch.from_numpy((r.random(n) * 100).astype(np.float32)),
        w=torch.from_numpy((r.random(n) + 0.25).astype(np.float32)),
        term=torch.from_numpy(r.integers(0, 3, n).astype(np.int32)),
        conv=torch.from_numpy(r.random(n) < 0.2))
    targets, send_ok = scatter.round_targets(graph, sampling.round_key(rng.PRNGKey(0), 5))
    want = scatter.pushsum_round_plain(state, targets, send_ok, delta=1e-2, term_rounds=3)
    s, w = state.s.numpy(), state.w.numpy()
    ok = send_ok.numpy()
    start, count, idx, (vs, vw) = _staged(targets.numpy(), ok, (s * np.float32(0.5),
                                                                  w * np.float32(0.5)), n, r)
    out = [np.empty(n, np.float32), np.empty(n, np.float32), np.empty(n, np.int32),
           np.empty(n, np.int32)]
    shim.nodes(_ptr(s), _ptr(w), _ptr(state.term.numpy()),
               _ptr(state.conv.numpy().astype(np.uint8)), _ptr(ok.astype(np.uint8)),
               _ptr(idx), _ptr(vs), _ptr(vw), _ptr(start), _ptr(count), n,
               ctypes.c_float(1e-2), 3, *(_ptr(o) for o in out))
    for got, exp in zip(out, want):
        assert (_bits(got) == _bits(exp.numpy().astype(got.dtype))).all()


# ---------------------------------------------------------------------------
# Whole runs against the JAX chunked engine
# ---------------------------------------------------------------------------


def _jax_run(kind, n, algorithm, **kw):
    final = {}
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, engine="chunked", **kw)
    jtopo = jax_build(kind, n, semantics=kw.get("semantics", "batched"))
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: final.__setitem__("s", s))
    return res, final["s"]


RUNS = [
    ("full", 1000, "push-sum", {}),
    ("full", 1000, "gossip", {}),
    ("full", 70_000, "push-sum", {}),
    ("full", 70_000, "gossip", {}),
    ("full", 1000, "gossip", {"semantics": "reference"}),
    ("imp3d", 1000, "push-sum", {}),
    ("imp3d", 1000, "gossip", {}),
    ("imp3d", 1000, "gossip", {"semantics": "reference"}),
    ("imp2d", 1000, "push-sum", {}),
    ("imp2d", 1000, "gossip", {"delivery": "scatter"}),
    ("ring", 500, "push-sum", {"delivery": "scatter"}),
    ("ring", 500, "gossip", {"delivery": "scatter"}),
    ("line", 300, "push-sum", {"delivery": "scatter", "max_rounds": 3000}),
    ("line", 1000, "gossip", {"delivery": "scatter"}),
]


@pytest.mark.parametrize("kind,n,algorithm,kw", RUNS)
def test_scatter_run_matches_jax_chunked_engine(kind, n, algorithm, kw):
    jres, jstate = _jax_run(kind, n, algorithm, **kw)
    topo = build_topology(kind, n, semantics=kw.get("semantics", "batched"))
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **kw)
    assert runner.resolve_delivery(topo, cfg) == "scatter"
    res = run(topo, cfg, device="cpu")
    assert (res.rounds, res.converged, res.converged_count, res.population,
            res.target_count, res.outcome) == (
        jres.rounds, jres.converged, jres.converged_count, jres.population,
        jres.target_count, jres.outcome)
    assert res.estimate_mae == jres.estimate_mae
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (_bits(a) == _bits(b)).all()


def test_scatter_chunk_resumes_and_stops_at_done():
    # A chunk from a converged state runs no round; a chunk capped short of
    # convergence, resumed, gives the uncapped run.
    topo = build_topology("imp3d", 1000)
    cfg = SimConfig(n=1000, topology="imp3d", algorithm="push-sum")
    whole = run(topo, cfg, device="cpu")
    half = run(topo, SimConfig(n=1000, topology="imp3d", algorithm="push-sum",
                               max_rounds=whole.rounds // 2), device="cpu")
    rest = run(topo, cfg, device="cpu", start_state=half.state, start_round=half.rounds)
    assert rest.rounds == whole.rounds
    for a, b in zip(rest.state, whole.state):
        assert torch.equal(a, b)
    again = run(topo, cfg, device="cpu", start_state=whole.state, start_round=whole.rounds)
    assert again.rounds == whole.rounds
    for a, b in zip(again.state, whole.state):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The ladder and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,kw", [
    ("full", 1000, {}), ("imp3d", 1000, {}), ("imp2d", 1000, {"delivery": "scatter"}),
    ("ring", 1024, {"delivery": "scatter"}), ("torus3d", 1000, {"delivery": "scatter"}),
    ("full", 1000, {"semantics": "reference", "algorithm": "gossip"}),
])
def test_scatter_never_fuses(kind, n, kw):
    semantics = kw.get("semantics", "batched")
    topo = build_topology(kind, n, semantics=semantics)
    cfg = SimConfig(n=n, topology=kind, **kw)
    variant, reason = runner.fused_tier(topo, cfg)
    assert reason is not None
    assert runner.resolve_delivery(topo, cfg) == "scatter"
    with pytest.raises(ValueError, match="delivers via the stencil formulation only"):
        run(topo, SimConfig(n=n, topology=kind, engine="fused",
                            **{**kw, "delivery": "scatter"}), device="cpu")


def test_refusals_around_scatter_and_the_walk():
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        SimConfig(n=100, delivery="matmul")
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        SimConfig(n=100, topology="imp3d", delivery="matmul")
    for kw in ({"delivery": "pool"}, {"topology": "ring", "delivery": "stencil"},
               {"engine": "fused"}):
        with pytest.raises(ValueError, match="single-walk"):
            SimConfig(**{"n": 100, "algorithm": "push-sum", "semantics": "reference", **kw})
    with pytest.raises(ValueError, match="Q9"):
        SimConfig(n=1000, topology="imp3d", delivery="pool", semantics="reference")
    with pytest.raises(ValueError, match="offset-structured"):
        # A 1-node ring has no displacement class: stencil delivery cannot
        # serve it (the JAX resolve_deliver_fn's refusal); auto scatters.
        run(build_topology("ring", 1), SimConfig(n=1, topology="ring", delivery="stencil"),
            device="cpu")
    # What stays legal: scatter anywhere, reference imp with its static edge.
    for kw in ({"topology": "full", "delivery": "scatter"},
               {"topology": "line", "delivery": "scatter"},
               {"topology": "imp2d", "semantics": "reference"},
               {"topology": "imp3d", "algorithm": "push-sum", "semantics": "reference"}):
        SimConfig(n=100, **kw)


# ---------------------------------------------------------------------------
# The chunked engine's host reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [("full", {}), ("torus3d", {}),
                                     ("full", {"delivery": "pool", "pool_size": 2})])
def test_chunked_engine_reads_the_status_once_a_chunk(monkeypatch, kind, kw):
    reads, dones = [], []
    real_read, real_done = pipeline._read, runner._host_done
    monkeypatch.setattr(pipeline, "_read", lambda h: reads.append(1) or real_read(h))
    monkeypatch.setattr(runner, "_host_done",
                        lambda *a: dones.append(1) or real_done(*a))
    chunk = 16
    cfg = SimConfig(n=1000, topology=kind, algorithm="gossip", chunk_rounds=chunk,
                    engine="chunked", **kw)
    res = run(build_topology(kind, 1000), cfg, device="cpu")
    assert res.converged
    # One status read a retired chunk, none a round; every chunk runs at
    # most chunk_rounds rounds (the schedule grows to it).
    assert len(reads) == len(res.chunk_log)
    assert len(reads) < res.rounds
    assert not dones
    ends = [0] + [e["rounds"] for e in res.chunk_log]
    assert all(0 < b - a <= chunk for a, b in zip(ends[:-1], ends[1:]))
