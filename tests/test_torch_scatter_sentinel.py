"""Kernel A's clip and health-sentinel instances (csrc/scatter.cu) on the
CPU, and the float order of the telemetry instances (csrc/telemetry.cuh):

- the sentinel in the kernel's order: the plain scatter chunk with its Σw
  summed as kernel A sums it (ops/telemetry.slice_order on a grid) trips at
  the JAX chunked engine's round, on several grids, for configs whose
  |Σw - n| at every round stays far from the tolerance (an attack that
  adds whole units of w against a tolerance of 1e-3 or 10, where the
  float32 rounding of a 256- or 20,000-node Σw is below 0.002), and a
  healthy run never trips, also under the delay ring (the w in flight
  counted, each node's ring words in slot order);
- clip's per-node round (csrc/scatter.cuh pushsum_round_clipped,
  clip_scale) built with g++ against ``pushsum_round_plain`` with clip, on
  states with adversaries, drained values and a NaN, and the clipped run
  in the kernel's chunk form against the JAX chunked engine;
- the telemetry header's per-node errors and row assembly (built with g++)
  against ops/telemetry.py, and a C++ emulation of the kernel's sum order
  (each thread from 0.0, warps folded by halves, warps in order, the grid's
  lanes strided then folded, every add flushed) against
  ``telemetry.kernel_sum`` on the pool, slice and strided walks.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
from cop5615_gossip_protocol_tpu_torch.models.pipeline import NEVER, Ringed, proto_of
from cop5615_gossip_protocol_tpu_torch.ops import fused, rng, scatter, telemetry
from cop5615_gossip_protocol_tpu_torch.utils.kernels import CSRC

torch.set_num_threads(1)


def kernel_chunk_run(kind, n, knobs, order, max_rounds):
    """A whole push-sum scatter run as one plain chunk of kernel A's
    instance (the sentinel's Σw in ``order``): (status, final state)."""
    topo = build_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", **knobs)
    faults = fused.run_faults(cfg, n)
    key = rng.PRNGKey(cfg.seed)
    status = torch.tensor([0, 0] + [NEVER] * (cfg.mass_tolerance is not None),
                          dtype=torch.int32)
    state = pushsum_mod.init_state(n, cfg.initial_term_round)
    if cfg.delay_rounds:
        # Under the ring the sentinel counts the w in flight too, each
        # node's words in slot order (ops/scatter.ring_node_sums).
        state = Ringed(state, torch.zeros(cfg.delay_rounds, 2, n))
    state, status = scatter.pushsum_scatter_chunk_plain(
        state,
        fused.round_keys(key, 0, max_rounds), status,
        graph=scatter.scatter_graph(topo, "cpu"),
        target=cfg.resolved_target_count(n, topo.target_count),
        delta=cfg.resolved_delta, term_rounds=cfg.term_rounds, faults=faults,
        order=order)
    return status, proto_of(state)


def jax_run(kind, n, knobs, max_rounds):
    return jax_runner.run(jax_topology(kind, n),
                          JaxConfig(n=n, topology=kind, algorithm="push-sum",
                                    engine="chunked", max_rounds=max_rounds, **knobs))


SENTINEL_CASES = [
    # (kind, n, knobs, rounds): the JAX package's acceptance config, and
    # 20,000 nodes where 1% inflate from round 20 against a tolerance of 10.
    ("full", 256, {"byzantine_schedule": "12:8", "byzantine_mode": "mass_inflate",
                   "mass_tolerance": 1e-3}, 40),
    ("full", 20_000, {"byzantine_schedule": "20:200", "byzantine_mode": "mass_inflate",
                      "mass_tolerance": 10.0}, 40),
    ("full", 20_000, {"byzantine_rate": 0.01, "byzantine_mode": "garble",
                      "mass_tolerance": 10.0}, 40),
    # The same under the delay ring (the sentinel's Σw counts the w in
    # flight).
    ("full", 20_000, {"byzantine_schedule": "20:200", "byzantine_mode": "mass_inflate",
                      "mass_tolerance": 10.0, "delay_rounds": 3}, 40),
    ("imp2d", 10_000, {"byzantine_rate": 0.01, "byzantine_mode": "garble",
                       "mass_tolerance": 10.0, "delay_rounds": 2}, 40),
]


@pytest.mark.parametrize("grid", [1, 3, 40])
@pytest.mark.parametrize("kind,n,knobs,rounds", SENTINEL_CASES,
                         ids=["accept-256", "inflate-20000", "garble-20000",
                              "inflate-ring-20000", "garble-ring-imp2d"])
def test_sentinel_in_the_kernel_order_trips_at_the_jax_round(kind, n, knobs, rounds, grid):
    jres = jax_run(kind, n, knobs, rounds)
    status, _ = kernel_chunk_run(kind, n, knobs, telemetry.slice_order(grid, n), rounds)
    assert jres.outcome == "unhealthy"
    assert [int(v) for v in status] == [jres.rounds, 1, jres.unhealthy_round]


@pytest.mark.parametrize("grid", [1, 3, 40])
def test_global_sentinel_in_the_kernel_order_leaves_conv_to_the_verdict(grid):
    # Under global termination a trip ends the run with conv as the
    # tripping round's verdict left it (0 here: no round was stable), not
    # latched on every node.
    knobs = {"termination": "global", "byzantine_schedule": "20:200",
             "byzantine_mode": "mass_inflate", "mass_tolerance": 10.0}
    jres = jax_run("full", 20_000, knobs, 40)
    status, state = kernel_chunk_run("full", 20_000, knobs,
                                     telemetry.slice_order(grid, 20_000), 40)
    assert jres.outcome == "unhealthy"
    assert [int(v) for v in status] == [jres.rounds, 1, jres.unhealthy_round]
    assert int(state.conv.sum()) == jres.converged_count == 0


@pytest.mark.parametrize("delay", [0, 3])
def test_sentinel_in_the_kernel_order_keeps_a_healthy_run(delay):
    # An honest 20,000-node run: Σw stays within its float32 rounding of n,
    # far under the tolerance of 10 in any order (under the ring, with the
    # w in flight counted).
    knobs = {"mass_tolerance": 10.0, "delay_rounds": delay}
    jres = jax_run("full", 20_000, knobs, 60)
    status, _ = kernel_chunk_run("full", 20_000, knobs, telemetry.slice_order(7, 20_000), 60)
    assert jres.unhealthy_round is None
    assert int(status[2]) == NEVER and int(status[0]) == jres.rounds


def test_kernel_order_sum_differs_from_sum_f32_but_not_the_verdict():
    # The orders do differ on a million-scale plane: the reason the plain
    # version takes the kernel's order where it is held against the kernel.
    g = torch.Generator().manual_seed(0)
    w = (torch.rand(70_000, generator=g) * 2
         + torch.randn(70_000, generator=g) * 1e-3).to(torch.float32)
    sums = {telemetry.kernel_sum(w, telemetry.slice_order(grid, 70_000)).item()
            for grid in (1, 7, 264)}
    sums.add(pushsum_mod.sum_f32(w).item())
    assert len(sums) > 1
    assert max(sums) - min(sums) < 0.1


def test_clip_run_in_the_kernel_chunk_form_is_jax():
    knobs = {"byzantine_schedule": "12:8", "byzantine_mode": "mass_inflate",
             "robust_agg": "clip"}
    jres = jax_run("full", 256, knobs, 2000)
    status, state = kernel_chunk_run("full", 256, knobs, None, 400)
    assert (int(status[0]), bool(status[1])) == (jres.rounds, True)
    assert int(state.conv.sum()) == jres.converged_count


# ----------------------------------------------------------- the headers

SHIM = r"""
#include <string.h>
#include "scatter.cuh"
#include "telemetry.cuh"
using namespace gossip;

extern "C" void clip_rounds(const float* s, const float* w, const int* t,
                            const int* c, const int* sends, const float* in_s,
                            const float* in_w, int n, float delta, int term_rounds,
                            float* s_new, float* w_new, int* t_new, int* c_new,
                            float* scale) {
  for (int j = 0; j < n; ++j) {
    float ks, kw;
    keep_flushed<true>(s[j], w[j], sends[j] != 0, ks, kw);
    scale[j] = scatter::clip_scale(in_w[j], kw);
    c_new[j] = scatter::pushsum_round_clipped(
        s[j], w[j], t[j], c[j] != 0, sends[j] != 0,
        [&](float& a, float& b) { a = in_s[j]; b = in_w[j]; }, delta,
        term_rounds, s_new[j], w_new[j], t_new[j]);
  }
}

extern "C" void errs(const float* s, const float* w, int n, float tmean,
                     float* chunked, float* pool, float* stencil) {
  for (int j = 0; j < n; ++j) {
    chunked[j] = tele::chunked_err(s[j], w[j], tmean);
    pool[j] = tele::pool_err(s[j], w[j], tmean);
    stencil[j] = tele::stencil_err(s[j], w[j], tmean);
  }
}

extern "C" void assemble(const int* tot, const float* sum, int n_live, int target,
                         const int* needs, int r, int n_mass, int pushsum,
                         float* row) {
  tele::assemble(tot, sum, n_live, target, needs, r, n_mass, pushsum != 0, row);
}

// The kernel's order, emulated: visits [blocks * 256 * steps] (-1: none).
static float fold32(float* v) {
  for (int o = 16; o > 0; o >>= 1)
    for (int l = 0; l < o; ++l) v[l] = flush(v[l] + v[l + o]);
  return v[0];
}

extern "C" float kernel_order_sum(const float* x, const long long* visits,
                                  int blocks, int steps) {
  float partial[4096];
  for (int b = 0; b < blocks; ++b) {
    float thread[256];
    for (int t = 0; t < 256; ++t) {
      tele::Acc a;
      for (int k = 0; k < steps; ++k) {
        const long long j = visits[((long long)b * 256 + t) * steps + k];
        if (j >= 0) a.add(tele::kErr, x[j]);
      }
      thread[t] = a.f[0];
    }
    float block = 0.0f;
    for (int w = 0; w < 8; ++w) block = flush(block + fold32(thread + 32 * w));
    partial[b] = block;
  }
  float lanes[32];
  for (int l = 0; l < 32; ++l) {
    lanes[l] = 0.0f;
    for (int b = l; b < blocks; b += 32) lanes[l] = flush(lanes[l] + partial[b]);
  }
  return fold32(lanes);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sentinel_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.clip_rounds.argtypes = [P] * 7 + [I, F, I] + [P] * 5
    so.errs.argtypes = [P, P, I, F, P, P, P]
    so.assemble.argtypes = [P, P, I, I, P, I, I, I, P]
    so.kernel_order_sum.argtypes = [P, P, I, I]
    so.kernel_order_sum.restype = F
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _state(n, seed):
    """Push-sum values over the clip's regimes: ordinary, inflated, drained
    near FLT_MIN, zero and one NaN."""
    rng_ = np.random.default_rng(seed)
    vals = np.array([0.0, 1e-38, 2.3e-38, 0.5, 1.0, 3.0, 40.0, 1e3, -2.0],
                    dtype=np.float32)
    s = rng_.choice(vals, n).astype(np.float32) * rng_.integers(1, 9, n).astype(np.float32)
    w = rng_.choice(vals, n).astype(np.float32)
    w[w == 0] = 1.0
    in_s = rng_.choice(vals, n).astype(np.float32)
    in_w = rng_.choice(vals, n).astype(np.float32)
    in_w[3] = np.nan
    return s, w, in_s, in_w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clipped_node_round_is_the_plain_clip(shim, seed):
    n = 4096
    s, w, in_s, in_w = _state(n, seed)
    rng_ = np.random.default_rng(seed + 10)
    t = rng_.integers(0, 3, n).astype(np.int32)
    c = rng_.integers(0, 2, n).astype(np.int32)
    sends = rng_.integers(0, 2, n).astype(np.int32)
    out = [np.zeros(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.int32),
           np.zeros(n, np.int32), np.zeros(n, np.float32)]
    shim.clip_rounds(*map(_p, (s, w, t, c, sends, in_s, in_w)), n, 1e-6, 3,
                     *map(_p, out))
    state = pushsum_mod.PushSumState(torch.from_numpy(s), torch.from_numpy(w),
                                     torch.from_numpy(t), torch.from_numpy(c) != 0)
    ok = torch.from_numpy(sends) != 0
    _, _, s_keep, w_keep = pushsum_mod.halve_and_send(state.s, state.w, ok)
    scale = pushsum_mod.clip_scale(torch.from_numpy(in_w), w_keep)
    want = pushsum_mod.absorb_clipped(state, s_keep, w_keep, torch.from_numpy(in_s),
                                      torch.from_numpy(in_w), scale, 1e-6, 3)
    np.testing.assert_array_equal(out[4].view(np.int32), scale.numpy().view(np.int32))
    np.testing.assert_array_equal(out[0].view(np.int32), want.s.numpy().view(np.int32))
    np.testing.assert_array_equal(out[1].view(np.int32), want.w.numpy().view(np.int32))
    np.testing.assert_array_equal(out[2], want.term.numpy())
    np.testing.assert_array_equal(out[3] != 0, want.conv.numpy())


def test_estimate_errors_are_the_rows(shim):
    n = 4096
    s, w, _, _ = _state(n, 5)
    w[:7] = 0.0
    tmean = np.float32(telemetry.true_mean(1000))
    out = [np.zeros(n, np.float32) for _ in range(3)]
    shim.errs(_p(s), _p(w), n, float(tmean), *map(_p, out))
    st, wt = torch.from_numpy(s), torch.from_numpy(w)
    conv = torch.ones(n, dtype=torch.bool)
    tm = torch.tensor(tmean)
    np.testing.assert_array_equal(
        out[0].view(np.int32), telemetry.chunked_err(st, wt, conv, tm).numpy().view(np.int32))
    # The fused forms as plane_row writes them.
    flush = pushsum_mod.flush
    pool = torch.abs(flush(flush(st / torch.where(wt != 0, wt, torch.ones_like(wt))) - tm))
    stencil = torch.abs(flush(flush(st / wt) - tm))
    np.testing.assert_array_equal(out[1].view(np.int32), pool.numpy().view(np.int32))
    np.testing.assert_array_equal(out[2].view(np.int32), stencil.numpy().view(np.int32))


@pytest.mark.parametrize("crash,pushsum", [(False, True), (True, True), (True, False)])
def test_row_assembly_is_the_plain_rows(shim, crash, pushsum):
    tot = np.array([700, 990, 650, 812, 33, 4, 9], dtype=np.int32)
    sums = np.array([123.456, 1000.0625], dtype=np.float32)
    needs = np.array([980, 941], dtype=np.int32)
    row = np.zeros(10, np.float32)
    shim.assemble(_p(tot), _p(sums), 1000, 1000, _p(needs) if crash else None, 1, 1000,
                  int(pushsum), _p(row))
    live = int(tot[1]) if crash else 1000
    gap = int(needs[1] - tot[2]) if crash else 1000 - int(tot[0])
    want = telemetry.assemble(torch.tensor(int(tot[0])), live, gap, int(tot[3]),
                              torch.tensor(sums[0]), torch.tensor(sums[1]), 1000,
                              int(tot[4]), int(tot[5]), int(tot[6]), pushsum)
    np.testing.assert_array_equal(row.view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("walk,blocks,count", [
    ("pool", 3, 128 * 64), ("slice", 5, 3001), ("slice", 40, 20_000),
    ("strided", 2, 70_000), ("strided", 37, 1000)])
def test_kernel_order_is_the_kernels(shim, walk, blocks, count):
    order = {"pool": lambda: telemetry.pool_order(blocks, count),
             "slice": lambda: telemetry.slice_order(blocks, count),
             "strided": lambda: telemetry.strided_order(blocks, count)}[walk]()
    visited = order.visits[order.visits >= 0]
    assert torch.equal(torch.sort(visited).values, torch.arange(count))
    g = torch.Generator().manual_seed(blocks)
    x = (torch.randn(count, generator=g) * 1e3).to(torch.float32)
    x[::97] = 1e-38  # flushed adds
    x[::89] = -0.0
    visits = np.ascontiguousarray(order.visits.numpy())
    want = shim.kernel_order_sum(_p(x.numpy()), _p(visits), blocks, visits.shape[2])
    got = telemetry.kernel_sum(x, order)
    assert np.float32(want).view(np.int32) == got.numpy().view(np.int32)
