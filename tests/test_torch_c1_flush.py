"""XLA's subnormal flush and the port's plain rounds (models/pushsum.flush,
halve_and_send, absorb; ops/delivery.py; ops/fused.pushsum_class_rounds;
csrc/faults.cuh flush and keep_flushed).

The JAX package's round, jitted on the CPU, flushes every float32 result
under FLT_MIN to zero, and writes the kept w half (and, under pool, imp
pool and scatter delivery, the kept s half) as ``where(send_ok, x * 0.5,
x)``. A push-sum run with crashes on a sparse graph drains cut-off live
nodes into that range, so the estimate depends on it.

- The pin: the JAX chunked engine's round from a crafted state whose every
  value is near FLT_MIN, on each delivery, gives the flushed values this
  module asserts, and the port's chunked engine gives them bitwise. If XLA
  stops flushing (or rewrites another keep), this fails first.
- The one place the port does not follow: XLA's scalar remainder loop. A
  fused loop over n nodes runs 8 lanes at a time (sometimes with a
  narrower vector epilogue), and its last few nodes take scalar code that
  keeps x - flush(x / 2) (x itself where the half is flushed) instead of
  the vector body's flush(x / 2). How many depends on the loop and on n
  (test_c4_delay_ring_remainder_is_the_jax_round says more); the port
  keeps the vector body's form for every node.
- The three drained configs that had differed (line 200, ring 257, ref2d
  400 with crash and revive schedules and fresh rejoins): rounds, converged
  count and estimate_mae are the JAX package's baked values, and every s
  and w word the JAX run's.
- Drained runs held bitwise to their end: the crash and recovery configs of
  tests/test_torch_runner_faults.py and tests/test_torch_runner_revive.py
  whose live nodes drain, which those files hold on the planes to round 100.
- The kernels' flush helpers (csrc/faults.cuh, csrc/scatter.cuh built with
  g++) against the plain torch halves, keeps, inbox adds and sums.
- The float32 sum in XLA's CPU order (models/pushsum.sum_f32) against
  jnp.sum jitted on the CPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import pushsum
from cop5615_gossip_protocol_tpu_torch.utils.kernels import CSRC

import test_torch_runner_faults as rf
import test_torch_runner_revive as rr

torch.set_num_threads(1)

TINY = np.float32(1.91e-38)  # normal; its half is subnormal
FLT_MIN = np.finfo(np.float32).tiny


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _one_round(kind, n, delivery, s, w, kw=None):
    """One round (absolute round 100) from the state (s, w) on the JAX
    chunked engine and the port's: (JAX s, w, port s, w)."""
    fields = dict(n=n, topology=kind, algorithm="push-sum", delivery=delivery,
                  engine="chunked", max_rounds=101, **(kw or {}))
    jtopo = jax_topology(kind, n)
    m = jtopo.n
    seen = {}
    jst = jax_pushsum.PushSumState(jnp.asarray(s[:m]), jnp.asarray(w[:m]),
                                   jnp.zeros(m, jnp.int32), jnp.zeros(m, bool))
    jax_runner.run(jtopo, JaxConfig(**fields), start_state=jst, start_round=100,
                   on_chunk=lambda r, st: seen.update(state=st))
    tst = pushsum.PushSumState(torch.from_numpy(s[:m].copy()),
                               torch.from_numpy(w[:m].copy()),
                               torch.zeros(m, dtype=torch.int32),
                               torch.zeros(m, dtype=torch.bool))
    res = run(build_topology(kind, n), SimConfig(**fields), device="cpu",
              start_state=tst, start_round=100)
    return (np.asarray(seen["state"].s), np.asarray(seen["state"].w),
            res.state.s.numpy(), res.state.w.numpy())


# (kind, n, delivery, whether the kept s half takes the folded form): n a
# multiple of 8, so no node falls to a scalar remainder loop.
DELIVERIES = [("line", 200, "auto", False), ("ref2d", 400, "auto", False),
              ("full", 256, "pool", True), ("full", 256, "scatter", True),
              ("imp2d", 256, "pool", True), ("ring", 256, "scatter", True)]
KNOBS = [None, {"crash_schedule": "50:3", "quorum": 0.5}]


@pytest.mark.parametrize("kw", KNOBS, ids=["fault-free", "crash"])
@pytest.mark.parametrize("kind,n,delivery,fold", DELIVERIES,
                         ids=lambda x: str(x))
def test_jax_round_flushes_as_the_port_assumes(kind, n, delivery, fold, kw):
    # Every node at 1.91e-38 sends a subnormal half: XLA flushes it, so no
    # inbox carries anything, the kept w half (x * 0.5, flushed) is 0, and
    # the kept s half is 0 where XLA folds it the same way and s - 0 =
    # 1.91e-38 under stencil delivery. IEEE arithmetic would keep 9.55e-39.
    full = np.full(n + 1, TINY, np.float32)
    js, jw, ts, tw = _one_round(kind, n, delivery, full, full.copy(), kw)
    alive = np.ones(js.shape[0], bool)
    if kw is not None:
        cfg = JaxConfig(n=n, topology=kind, algorithm="push-sum", **kw)
        from cop5615_gossip_protocol_tpu.ops import faults as jax_faults
        alive = jax_faults.alive_at(jax_faults.death_plane(cfg, js.shape[0]), 100)
    assert (jw[alive] == 0).all() and (jw[~alive] == TINY).all()
    assert (js[alive] == (0 if fold else TINY)).all()
    assert np.array_equal(_bits(js), _bits(ts)) and np.array_equal(_bits(jw), _bits(tw))
    # A mixed state: the flushed halves, keeps, adds and sums bitwise.
    vals = np.array([1.91e-38, 1.5e-38, 2.35e-38, FLT_MIN, 1.0, -1.91e-38, 3.0e-38,
                     5.0, 2.4e-38], np.float32)
    s = np.resize(vals, n + 1).astype(np.float32)
    w = np.resize(vals[::-1], n + 1).astype(np.float32)
    js, jw, ts, tw = _one_round(kind, n, delivery, s, w, kw)
    assert np.array_equal(_bits(js), _bits(ts)) and np.array_equal(_bits(jw), _bits(tw))


def test_scalar_remainder_keeps_the_unflushed_half():
    # ring 257 under scatter delivery: node 256 is the loops' remainder and
    # keeps 1.91e-38 - flush(9.55e-39) = 1.91e-38, where the port (and the
    # vector body, nodes 0..255) keep flush(9.55e-39) = 0.
    full = np.full(258, TINY, np.float32)
    js, jw, ts, tw = _one_round("ring", 257, "scatter", full, full.copy())
    assert (jw[:256] == 0).all() and (js[:256] == 0).all()
    assert jw[256] == TINY and js[256] == TINY
    assert np.array_equal(_bits(js[:256]), _bits(ts[:256]))
    assert np.array_equal(_bits(jw[:256]), _bits(tw[:256]))
    assert tw[256] == 0 and ts[256] == 0


# ROADMAP C1's configs: the JAX package's rounds, converged count and
# estimate_mae (the JAX chunked engine on the CPU, seed 0).
C1_KNOBS = dict(algorithm="push-sum", crash_schedule="2:50,5:20",
                revive_schedule="6:40", rejoin="fresh", quorum=0.9, seed=0)
C1 = [("line", 200, 536, 153, 164.86640460104104),
      ("ring", 257, 819, 205, 144.54766571023697),
      ("ref2d", 400, 1265, 334, 163.27190031009195)]


@pytest.mark.parametrize("kind,n,rounds,converged,mae", C1, ids=lambda x: str(x))
def test_c1_configs_are_the_jax_runs(kind, n, rounds, converged, mae):
    fields = dict(n=n, topology=kind, **C1_KNOBS)
    res = run(build_topology(kind, n), SimConfig(**fields), device="cpu")
    assert (res.rounds, res.converged_count, res.estimate_mae) == (rounds, converged, mae)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n), JaxConfig(**fields),
                          on_chunk=lambda r, st: seen.update(state=st))
    assert (jres.rounds, jres.converged_count, jres.estimate_mae) == (rounds, converged, mae)
    rf.assert_same_run(jres, seen["state"], res)
    # The run drained: some live nodes hold no weight at all.
    assert (res.state.w == 0).sum() > 0


# The drained runs of the failure-model files, to their end: (module's
# both_runs, arguments, knobs). grid2d 900's rate run is held apart below.
DRAINED = [
    ("faults", ("grid2d", 900, "stencil", "push-sum", 600), "schedule"),
    ("revive", ("torus3d", 1000, "stencil", "push-sum", "fresh schedule", 400), None),
    ("revive", ("grid2d", 900, "stencil", "push-sum", "restore rate", 400), None),
    ("revive", ("imp2d", 1024, "pool", "push-sum", "fresh schedule"), None),
    ("revive", ("imp2d", 1024, "scatter", "push-sum", "restore rate"), None),
]


@pytest.mark.parametrize("which,args,faults", DRAINED, ids=lambda x: str(x))
def test_drained_runs_hold_to_their_end(which, args, faults):
    if which == "faults":
        jres, jstate, tres = rf.both_runs(*args, **rf.FAULTS[faults])
    else:
        jres, jstate, tres = rr.both_runs(*args)
    rf.assert_same_run(jres, jstate, tres)


def test_drained_run_differs_only_in_the_scalar_remainder():
    # grid2d 900 under the crash rate: nodes 896..899 are the remainder of
    # the JAX round's loops; two of them drain, and JAX keeps their last
    # w (1.97e-38 at round 383 on node 898) where the port flushes it.
    # Rounds, counts, outcome, the estimate and every other word agree.
    jres, jstate, tres = rf.both_runs("grid2d", 900, "stencil", "push-sum", 600,
                                      **rf.FAULTS["rate"])
    assert (tres.rounds, tres.converged_count, tres.outcome, tres.estimate_mae) == (
        jres.rounds, jres.converged_count, jres.outcome, jres.estimate_mae)
    differ = rf.planes_differ(jstate, tres.state)
    assert not any(differ[k].any() for k in ("s", "term", "conv"))
    assert np.nonzero(differ["w"])[0].tolist() == [896, 898]
    assert (tres.state.w[[896, 898]] == 0).all()



# ROADMAP C4: grid3d 343 (stencil delivery) push-sum under the dup gate, the
# delay ring and a crash rate, seed 5. Node 341 drains: at round 619 it
# holds w = 2.2599908e-38, whose half is subnormal; at round 620 JAX keeps
# 2.2599908e-38 and the port 0.0, and the estimates part from there. Round
# 621 is the first boundary past it.
C4_FIELDS = dict(n=343, topology="grid3d", algorithm="push-sum", engine="chunked",
                 dup_rate=0.1, delay_rounds=2, crash_rate=0.003, quorum=0.9, seed=5,
                 max_rounds=621)


def test_c4_delay_ring_remainder_is_the_jax_round():
    """The C4 pin: every s and w word, and the estimate, of the JAX chunked
    engine at round 621.

    It fails: the port keeps flush(w / 2) at node 341 where XLA's compiled
    round keeps w - flush(w / 2). XLA emits each fused loop over the n
    nodes as an LLVM loop, which the loop vectorizer splits into a vector
    body, sometimes a narrower vector epilogue, and a scalar remainder;
    the vector lanes keep flush(x / 2) and the scalar ones x - flush(x / 2).
    At n = 343 the delay ring's keep-and-absorb loops run 8 lanes
    interleaved by 4 over nodes 0-319, 4 lanes over 320-339 and scalar code
    over 340-342 (the dump of this config). Which nodes fall to the scalar
    code is LLVM's choice per loop and per trip count: from a state of all
    1.91e-38 (scripts/xla_remainder_tails.py), line n = 257..288 under
    stencil delivery keeps the remainder's w over the last r mod 2 nodes for
    r = n mod 32 up to 4, r mod 4 for r in 5..27 and r mod 8 for r >= 28;
    grid2d 900's stencil loop interleaves by 2 with no vector epilogue (4
    scalar nodes); full 257..288 under scatter and pool delivery has no
    scalar node at all. No rule of n and one vector width reproduces that,
    so the port keeps the vector body's form for every node
    (models/pushsum.halve_and_send) and this case stands failing.

    Host of the measurement: Intel Xeon, 8 CPUs, flags with avx2, fma,
    avx512f/dq/bw/vl, avx512_bf16, avx512_fp16, amx; XLA's loops carry
    "prefer-vector-width"="256", so the vector body is 8 float32 lanes.
    """
    seen = {}
    jres = jax_runner.run(jax_topology("grid3d", 343, seed=5), JaxConfig(**C4_FIELDS),
                              on_chunk=lambda r, st: seen.update(state=st))
    tres = run(build_topology("grid3d", 343, seed=5), SimConfig(**C4_FIELDS), device="cpu")
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome) == (621, 68, "max_rounds")
    differ = rf.planes_differ(seen["state"], tres.state)
    assert {k: np.nonzero(v)[0].tolist() for k, v in differ.items() if v.any()} == {}
    assert tres.estimate_mae == jres.estimate_mae


# ------------------------------------------------------- the kernels' helpers

SHIM = r"""
#include "faults.cuh"
#include "scatter.cuh"
using namespace gossip;
extern "C" void flush_all(const float* x, int n, float* out) {
  for (int j = 0; j < n; ++j) out[j] = flush(x[j]);
}
extern "C" void keeps(const float* s, const float* w, const int* sends, int fold, int n,
                      float* s_keep, float* w_keep) {
  for (int j = 0; j < n; ++j) {
    if (fold) keep_flushed<true>(s[j], w[j], sends[j] != 0, s_keep[j], w_keep[j]);
    else keep_flushed<false>(s[j], w[j], sends[j] != 0, s_keep[j], w_keep[j]);
  }
}
extern "C" void bucket(const float* s, const float* w, int k, float* acc_s, float* acc_w) {
  scatter::Send v[16];
  for (int a = 0; a < k; ++a) v[a] = scatter::make_send<true>(k - 1 - a, s[a], w[a]);
  scatter::ordered_sum<true>([&](int a) { return v[a]; }, k, *acc_s, *acc_w);
}
"""


@pytest.mark.parametrize("n", [7, 33, 1000, 4099])
@pytest.mark.parametrize("drained", [False, True], ids=["normal", "drained"])
def test_sum_f32_is_the_jitted_jax_sum(n, drained):
    """pushsum.sum_f32 (the sentinel's Σw and the walk's estimate) is
    jnp.sum jitted on the CPU, bitwise: its 32-element windows, and a
    partial sum under FLT_MIN flushed."""
    gen = np.random.default_rng(n)
    if drained:
        x = gen.choice(np.array([1.5e-38, -1.4e-38, 2.0e-38, -2.05e-38, 1.2e-38]), n)
    else:
        x = gen.standard_normal(n) * gen.choice(np.array([1.0, 1e3, 3e-38]), n)
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jnp.sum)(x))
    got = pushsum.sum_f32(torch.from_numpy(x)).numpy()
    assert got.view(np.int32) == want.view(np.int32)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("flush_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.flush_all.argtypes = [P, I, P]
    so.keeps.argtypes = [P, P, P, I, I, P, P]
    so.bucket.argtypes = [P, P, I, P, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _values(n, seed=4):
    gen = np.random.default_rng(seed)
    mags = np.array([0.0, 1e-45, 5e-39, 1.17e-38, FLT_MIN, 1.91e-38, 2.35e-38, 3e-38,
                     1.0, 255.0, np.inf, np.nan], np.float32)
    x = gen.choice(mags, n) * gen.choice(np.array([1, -1], np.float32), n)
    return x.astype(np.float32)


def test_flush_is_the_plain_flush(shim):
    x = _values(4096)
    out = np.empty_like(x)
    shim.flush_all(_p(x), x.size, _p(out))
    want = pushsum.flush(torch.from_numpy(x)).numpy()
    assert np.array_equal(out.view(np.int32), want.view(np.int32))
    assert (np.signbit(out) == np.signbit(x)).all()


@pytest.mark.parametrize("fold", [True, False])
def test_kept_halves_are_the_plain_halve(shim, fold):
    n = 4096
    s, w = _values(n, 1), _values(n, 2)
    sends = (np.random.default_rng(3).random(n) < 0.7).astype(np.int32)
    s_keep, w_keep = np.empty_like(s), np.empty_like(w)
    shim.keeps(_p(s), _p(w), _p(sends), int(fold), n, _p(s_keep), _p(w_keep))
    _, _, ps, pw = pushsum.halve_and_send(torch.from_numpy(s), torch.from_numpy(w),
                                          torch.from_numpy(sends != 0), fold)
    assert np.array_equal(s_keep.view(np.int32), ps.numpy().view(np.int32))
    assert np.array_equal(w_keep.view(np.int32), pw.numpy().view(np.int32))


def test_scatter_bucket_is_the_plain_flushed_delivery(shim):
    # A bucket of flushed halves that cancel into the subnormals (negated
    # halves, as mass_deflate sends): every add flushed, in ascending
    # sender index, onto the kept half.
    from cop5615_gossip_protocol_tpu_torch.ops import delivery

    gen = np.random.default_rng(9)
    for k in (1, 3, 8, 12):
        s = (gen.choice([1, -1], k) * gen.choice([2.4e-38, 3.0e-38, 4.7e-38], k)).astype(np.float32)
        w = (gen.choice([1, -1], k) * gen.choice([2.4e-38, 2.6e-38, 1.0], k)).astype(np.float32)
        acc_s, acc_w = np.float32(2.35e-38), np.float32(0)
        a_s, a_w = np.array([acc_s]), np.array([acc_w])
        shim.bucket(_p(s), _p(w), k, _p(a_s), _p(a_w))
        # Sender k - 1 - a sent (s[a], w[a]); all go to target 0.
        senders = k - 1 - np.arange(k)
        vs = np.zeros(k, np.float32)
        vw = np.zeros(k, np.float32)
        vs[senders] = pushsum.flush(torch.from_numpy(s * np.float32(0.5))).numpy()
        vw[senders] = pushsum.flush(torch.from_numpy(w * np.float32(0.5))).numpy()
        t = torch.zeros(k, dtype=torch.int64)
        want_s = delivery.deliver(torch.from_numpy(vs), t, 1, base=torch.tensor([acc_s]))
        want_w = delivery.deliver(torch.from_numpy(vw), t, 1, base=torch.tensor([acc_w]))
        assert a_s.view(np.int32)[0] == want_s.numpy().view(np.int32)[0]
        assert a_w.view(np.int32)[0] == want_w.numpy().view(np.int32)[0]
