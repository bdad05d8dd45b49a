"""Global termination in the streaming lattice tier (``stencil_hbm``, row 9)
and both imp tiers (``imp`` and ``imp_hbm``, rows 11 and 13) on the CPU,
where the wrappers run their plain versions (which the kernels of
csrc/fused_stencil.cu and csrc/fused_imp.cu are held against on the card),
against the JAX package:

- single chunks: one 8-round chunk of the JAX tier's push-sum kernel in
  Pallas interpret mode (make_pushsum_stencil_hbm_chunk,
  make_pushsum_imp_chunk, make_pushsum_imp_hbm_chunk) against the port's
  wrapper from a crafted state (one ratio everywhere but three nodes, so
  the verdict fires inside the chunk and latches conv on every real node),
  every plane and the executed count bitwise; caps after 3 and 2 rounds
  (before the verdict); a chunk from the verdict runs 0 rounds (held to
  the JAX kernel on the resident imp tier);
- whole runs: ``run(engine="fused", device="cpu")`` on each tier (the
  streaming ones reached at small n by shrinking the resident tiers'
  budgets in both packages) against the JAX chunked engine: rounds,
  converged count, outcome, estimate and every plane bitwise, from the
  initial and from the crafted state;
- the wrappers refuse the drop gate and crash-stop (their JAX tiers run
  them on the chunked engine);
- csrc/faults.cuh's global absorb and latch built with g++ against the
  plain version's arithmetic.
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
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp
from cop5615_gossip_protocol_tpu.ops import fused_imp_hbm as jax_fused_imp_hbm
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil
from cop5615_gossip_protocol_tpu.ops import fused_stencil_hbm as jax_hbm

from cop5615_gossip_protocol_tpu_torch import SimConfig, run
from cop5615_gossip_protocol_tpu_torch.models.pushsum import PushSumState
from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
from cop5615_gossip_protocol_tpu_torch.ops import (
    fused,
    fused_imp,
    fused_imp_hbm,
    fused_stencil,
    fused_stencil_hbm,
)
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEED = 5
K = 8
START = 1000
# The crafted state's perturbation: the verdict fires 5-7 rounds in.
EPS = 8e-6
CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"


@pytest.fixture
def streaming_tiers(monkeypatch):
    """The resident tiers' budgets shrunk in both packages, so a small
    lattice takes the streaming lattice tier and imp3d 1000 the streaming
    imp tier."""
    for module in (fused, jax_fused):
        monkeypatch.setattr(module, "MAX_FUSED_NODES", 0)
    for module in (fused_stencil, jax_fused_stencil, fused_imp, jax_fused_imp):
        monkeypatch.setattr(module, "_VMEM_BUDGET", 1000)


def _cfgs(kind, n, **kw):
    extra = {"delivery": "pool"} if kind.startswith("imp") else {}
    common = dict(n=n, topology=kind, algorithm="push-sum", termination="global",
                  seed=SEED, **extra, **kw)
    return JaxConfig(**common), SimConfig(**common)


def _crafted(n, n_pad):
    """s = w = 1 on every real node but EPS more s at three nodes, term and
    conv 0: (padded numpy planes (s, w, term, conv), the canonical [n]
    state)."""
    s = np.zeros(n_pad, np.float32)
    s[:n] = 1.0
    s[[5, n // 3, 2 * n // 3 + 7]] = np.float32(1.0 + EPS)
    w = np.ones(n_pad, np.float32)
    zero = np.zeros(n_pad, np.int32)
    return (s, w, zero, zero.copy()), (s[:n].copy(), w[:n].copy(), zero[:n].copy(),
                                       np.zeros(n, bool))


_MAKE = {"stencil_hbm": jax_hbm.make_pushsum_stencil_hbm_chunk,
         "imp": jax_fused_imp.make_pushsum_imp_chunk,
         "imp_hbm": jax_fused_imp_hbm.make_pushsum_imp_hbm_chunk}


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _both_chunks(kind, n, tier, cap_after=None, start_planes=None, start=START):
    """One chunk of the JAX tier's push-sum kernel in interpret mode and of
    the port's tier wrapper from the crafted state (or ``start_planes`` at
    ``start``): (JAX planes, JAX executed, port planes, port executed, start
    planes)."""
    jcfg, cfg = _cfgs(kind, n, engine="fused")
    jtopo = jax_build(kind, n, seed=SEED)
    jchunk, jlayout = _MAKE[tier](jtopo, jcfg, interpret=True)
    jkey = jax.random.PRNGKey(SEED)
    topo = carry.topology_from_numpy(jtopo)
    eng = fused_engine(topo, cfg, carry.key_from_numpy(np.asarray(jkey)), tier)
    assert (eng.layout.n_pad, eng.layout.rows) == (jlayout.n_pad, jlayout.rows)
    if start_planes is None:
        flat, _ = _crafted(topo.n, eng.layout.n_pad)
        start_planes = tuple(torch.from_numpy(x.reshape(eng.layout.rows, 128)) for x in flat)
    cap = start + (K if cap_after is None else cap_after)
    jstreams = [jax_fused.round_keys(jkey, start, K)]
    if tier != "stencil_hbm":
        jstreams += [jax_fused_pool.round_offsets(jkey, start, K, jcfg.pool_size, jtopo.n),
                     jax_fused_imp.choice_round_keys(jkey, start, K)]
    jout, jex = jchunk(tuple(jnp.asarray(p.numpy()) for p in start_planes), *jstreams,
                       start, cap)
    out, executed = eng.chunk(start_planes, eng.streams(start, K), start, cap)
    return (tuple(torch.from_numpy(np.array(x)) for x in jout), int(jex), out,
            int(executed), start_planes)


CHUNKS = [("ring", 600, "stencil_hbm"), ("imp3d", 1000, "imp"), ("imp3d", 1000, "imp_hbm")]


@pytest.mark.parametrize("kind,n,tier", CHUNKS, ids=lambda x: str(x))
def test_global_chunk_fires_as_the_jax_kernel(kind, n, tier):
    jout, jex, out, executed, start = _both_chunks(kind, n, tier)
    assert executed == jex and 3 < executed < K
    _assert_bitwise(out, jout)
    real = (torch.arange(start[0].numel()) < n).reshape(start[0].shape)
    assert torch.equal(out[3], real.to(torch.int32))  # conv latched on the real nodes
    assert torch.equal(out[2], start[2])  # term stays
    # A chunk from the verdict's state runs no round (the JAX kernel's too,
    # on the resident imp tier: its interpret mode is the quickest).
    if tier == "imp":
        jout2, jex2, out2, executed2, _ = _both_chunks(kind, n, tier, start_planes=out,
                                                       start=START + executed)
        assert jex2 == 0
        _assert_bitwise(jout2, out)
    else:
        _, cfg = _cfgs(kind, n)
        eng = fused_engine(carry.topology_from_numpy(jax_build(kind, n, seed=SEED)), cfg,
                           carry.key_from_numpy(np.asarray(jax.random.PRNGKey(SEED))), tier)
        out2, executed2 = eng.chunk(out, eng.streams(START + executed, K),
                                    START + executed, START + executed + K)
    assert int(executed2) == 0
    _assert_bitwise(out2, out)


# A cap after an odd and after an even number of rounds, before the verdict.
@pytest.mark.parametrize("kind,n,tier,cap_after", [(*CHUNKS[0], 3), (*CHUNKS[1], 2)],
                         ids=lambda x: str(x))
def test_global_chunk_capped_before_the_verdict(kind, n, tier, cap_after):
    jout, jex, out, executed, _ = _both_chunks(kind, n, tier, cap_after)
    assert executed == jex == cap_after
    _assert_bitwise(out, jout)
    assert not out[3].any()  # no verdict yet: conv stays 0


def _jax_run(kind, n, start_state=None, **kw):
    jcfg, _ = _cfgs(kind, n, engine="chunked", **kw)
    final = {}
    jtopo = jax_build(kind, n, seed=SEED)
    res = jax_runner.run(jtopo, jcfg, on_chunk=lambda r, s: final.__setitem__("s", s),
                         start_state=start_state,
                         start_round=START if start_state is not None else 0)
    return jtopo, res, final["s"]


@pytest.mark.parametrize("kind,n,tier,crafted", [
    ("torus3d", 512, "stencil_hbm", True), ("grid2d", 900, "stencil_hbm", True),
    ("ring", 600, "stencil_hbm", True), ("imp3d", 1000, "imp", False),
    ("imp2d", 900, "imp", True), ("imp3d", 1000, "imp_hbm", True),
], ids=lambda x: str(x))
def test_global_run_is_the_jax_chunked_engine(kind, n, tier, crafted, request):
    if tier.endswith("hbm"):
        request.getfixturevalue("streaming_tiers")
    jcfg, cfg = _cfgs(kind, n)
    jtopo = jax_build(kind, n, seed=SEED)
    topo = carry.topology_from_numpy(jtopo)
    assert fused_tier(topo, cfg) == (tier, None)
    start = {}
    jstart = None
    if crafted:
        _, canon = _crafted(n, n)
        jstart = jax_pushsum.PushSumState(*(jnp.asarray(x) for x in canon))
        start = {"start_state": PushSumState(*(torch.from_numpy(x) for x in canon)),
                 "start_round": START}
    _, jres, jstate = _jax_run(kind, n, jstart)
    res = run(topo, SimConfig(**{**cfg.__dict__, "engine": "fused"}), device="cpu",
              **start)
    assert (res.rounds, res.converged_count, res.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert res.converged and res.converged_count == n
    assert res.estimate_mae == jres.estimate_mae
    for name in res.state._fields:
        a, b = np.asarray(getattr(jstate, name)), getattr(res.state, name).numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all(), name


@pytest.mark.parametrize("wrapper,kind", [
    (fused_stencil_hbm.pushsum_stencil_hbm_chunk, "torus3d"),
    (fused_imp.pushsum_imp_chunk, "imp3d"),
    (fused_imp_hbm.pushsum_imp_hbm_chunk, "imp3d"),
])
def test_wrappers_take_global_termination_only(wrapper, kind):
    _, cfg = _cfgs(kind, 1000)
    topo = carry.topology_from_numpy(jax_build(kind, 1000, seed=SEED))
    tier = {fused_stencil_hbm.pushsum_stencil_hbm_chunk: "stencil_hbm",
            fused_imp.pushsum_imp_chunk: "imp"}.get(wrapper, "imp_hbm")
    eng = fused_engine(topo, cfg, carry.key_from_numpy(np.asarray(jax.random.PRNGKey(0))),
                       tier)
    spec = (fused_stencil_hbm.stencil_spec(topo) if tier == "stencil_hbm"
            else fused_imp.imp_spec(topo))
    for knobs in ({"fault_rate": 0.1}, {"crash_rate": 0.01, "quorum": 0.9}):
        faults = fused.run_faults(SimConfig(n=1000, algorithm="push-sum", **knobs), 1000)
        with pytest.raises(ValueError, match="global termination only"):
            wrapper(eng.planes, *eng.streams(0, 4), 0, 4, spec=spec, target=1000,
                    delta=cfg.resolved_delta, term_rounds=cfg.term_rounds, faults=faults)


SHIM = r"""
#include "faults.cuh"
using namespace gossip;
extern "C" void absorb(const float* s, const float* w, const int* pad, const int* sends,
                       const float* in_s, const float* in_w, float delta, int count,
                       float* s_new, float* w_new, int* unstable) {
  for (int i = 0; i < count; ++i)
    unstable[i] = absorb_global(s[i], w[i], pad[i] != 0, sends[i] != 0, in_s[i], in_w[i],
                                delta, s_new[i], w_new[i]) ? 1 : 0;
}
extern "C" void latch(int latch_all, const int* conv, int n, int n_pad, int* out) {
  for (int j = 0; j < n_pad; ++j) out[j] = latched_conv(latch_all != 0, j, n, conv[j]);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("global_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")], check=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.absorb.argtypes = [P] * 6 + [F, I] + [P] * 3
    so.latch.argtypes = [I, P, I, I, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def test_global_absorb_and_latch_are_the_plain_arithmetic(shim):
    # The kernels' per-node global absorb (csrc/faults.cuh absorb_global)
    # against fused.pushsum_class_rounds' arithmetic under global
    # termination, on ratios near and far from 1 (the max(|s/w|, 1) switch),
    # inboxes of zero, sends and no sends, and pad lanes; and the latch.
    gen = np.random.default_rng(3)
    count = 1 << 14
    s = (gen.standard_normal(count) * np.where(gen.random(count) < 0.5, 1e-3, 1e3)
         ).astype(np.float32)
    w = gen.uniform(0.1, 2.0, count).astype(np.float32)
    # A quarter move a hair past or within the tolerance.
    near = gen.random(count) < 0.25
    in_s = np.where(gen.random(count) < 0.2, 0.0,
                    gen.standard_normal(count)).astype(np.float32)
    in_s = np.where(near, (s * np.float32(0.5) * np.float32(1 + 1e-6)).astype(np.float32),
                    in_s).astype(np.float32)
    in_w = np.where(near | (in_s == 0), np.where(near, w * np.float32(0.5), 0.0),
                    gen.uniform(0.0, 1.0, count)).astype(np.float32)
    pad = (gen.random(count) < 0.1).astype(np.int32)
    sends = ((gen.random(count) < 0.8) & (pad == 0)).astype(np.int32)
    delta = np.float32(1e-6)
    s_new, w_new = np.zeros(count, np.float32), np.zeros(count, np.float32)
    unstable = np.zeros(count, np.int32)
    shim.absorb(_p(s), _p(w), _p(pad), _p(sends), _p(in_s), _p(in_w), float(delta), count,
                _p(s_new), _p(w_new), _p(unstable))
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    keep = torch.from_numpy(sends) != 0
    zero = torch.zeros((), dtype=torch.float32)
    want_s = (ts - torch.where(keep, ts * 0.5, zero)) + torch.from_numpy(in_s)
    want_w = (tw - torch.where(keep, tw * 0.5, zero)) + torch.from_numpy(in_w)
    ratio_old = ts / tw
    tol = torch.tensor(delta) * torch.maximum(torch.abs(ratio_old), torch.ones(()))
    want_u = (torch.abs(want_s / want_w - ratio_old) > tol) & (torch.from_numpy(pad) == 0)
    assert np.array_equal(s_new.view(np.int32), want_s.numpy().view(np.int32))
    assert np.array_equal(w_new.view(np.int32), want_w.numpy().view(np.int32))
    assert np.array_equal(unstable != 0, want_u.numpy())
    assert 0 < unstable.sum() < count - pad.sum()
    n, n_pad = 1000, 1024
    conv = (gen.random(n_pad) < 0.3).astype(np.int32)
    out = np.zeros(n_pad, np.int32)
    shim.latch(1, _p(conv), n, n_pad, _p(out))
    assert (out == (np.arange(n_pad) < n)).all()
    shim.latch(0, _p(conv), n, n_pad, _p(out))
    assert (out == conv).all()
