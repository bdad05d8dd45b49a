"""The port's failure model on the host (cop5615_gossip_protocol_tpu_torch/
ops/faults.py, ops/rng.py, ops/sampling.py, config.py) against the JAX
package: rng.uniform and rng.permutation bitwise jax.random, the death
planes bitwise, quorum_need past 2**24 alive nodes, the per-round
quorum_needs against quorum_need(alive_at), the drop gate bitwise, the
config's errors and warnings word for word; and the kernels' per-node
rules (csrc/faults.cuh, as csrc/scatter.cuh and csrc/pool.cuh include it:
the gate, alive, the frozen latch, the global residual) built with g++
against the plain torch versions."""

import ctypes
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu.ops import faults as jax_faults
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch import SimConfig
from cop5615_gossip_protocol_tpu_torch.ops import faults, fused, rng, sampling
from cop5615_gossip_protocol_tpu_torch.utils import carry
from cop5615_gossip_protocol_tpu_torch.utils.kernels import CSRC

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


def _keys(seed, tag):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    return jkey, carry.key_from_numpy(np.asarray(jkey))


@pytest.mark.parametrize("n", [1, 2, 1000, 65_537, 2**20])
def test_uniform_and_permutation_are_jax_random(n):
    for seed in (0, 9):
        jkey, tkey = _keys(seed, faults.CRASH_TAG)
        u = np.asarray(jax.random.uniform(jkey, (n,), jnp.float32))
        tu = rng.uniform(tkey, (n,)).numpy()
        assert tu.dtype == np.float32 and (u.view(np.int32) == tu.view(np.int32)).all()
        assert ((0 <= tu) & (tu < 1)).all()
        p = np.asarray(jax.random.permutation(jkey, n))
        assert (rng.permutation(tkey, n).numpy() == p).all()


def test_permutation_keeps_ties_in_order():
    # Stable sort: equal words keep their input order, as lax.sort_key_val.
    x = torch.tensor([5, 1, 5, 1, 5])
    order = torch.sort(x, stable=True).indices
    assert order.tolist() == [1, 3, 0, 2, 4]


@pytest.mark.parametrize("kw", [
    {"crash_rate": 0.002}, {"crash_rate": 0.05},
    {"crash_schedule": "3:100,6:50"}, {"crash_schedule": "0:1,7:300,2:5"},
])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_death_plane_is_the_jax_plane(kw, seed):
    n = 1000
    jcfg = JaxConfig(n=n, seed=seed, **kw)
    cfg = SimConfig(n=n, seed=seed, **kw)
    want = jax_faults.death_plane(jcfg, n)
    got = faults.death_plane(cfg, n)
    assert got.dtype == np.int32 and (got == want).all()
    assert faults.death_plane(SimConfig(n=n), n) is None
    padded = fused.build_death2d(cfg, n, 1024)
    assert tuple(padded.shape) == (8, 128)
    assert (padded.reshape(-1)[n:] == 0).all()
    assert (padded.reshape(-1)[:n].numpy() == want).all()


@pytest.mark.parametrize("quorum", [0.7, 0.9, 0.95, 1.0])
def test_quorum_need_is_jax_past_2_24(quorum):
    counts = np.array([0, 1, 2, 999, 2**24 - 1, 2**24, 2**24 + 1, 2**24 + 3,
                       16_777_219, 50_000_001, 2**27, 2**30 + 7], np.int32)
    want = np.asarray(jax_faults.quorum_need(jnp.asarray(counts), quorum))
    assert (faults.quorum_need(counts, quorum) == want).all()
    for c in counts[:6]:
        assert faults.quorum_need(int(c), quorum) == int(
            jax_faults.quorum_need(int(c), quorum))
    if quorum == 1.0:
        assert (faults.quorum_need(counts, quorum) == counts).all()


@pytest.mark.parametrize("kw", [{"crash_rate": 0.01}, {"crash_schedule": "3:100,6:50,9:7"}])
def test_quorum_needs_follow_the_alive_count(kw):
    n, quorum = 1000, 0.9
    cfg = SimConfig(n=n, quorum=quorum, **kw)
    death = faults.death_plane(cfg, n)
    for start, count in ((0, 12), (5, 8), (40, 3), (200, 0)):
        needs, need_init = faults.quorum_needs(np.sort(death), n, start, count, quorum)
        assert needs.shape == (count,)
        for k in range(count):
            alive = int(faults.alive_at(death, start + k).sum())
            assert needs[k] == faults.quorum_need(alive, quorum)
        assert need_init == faults.quorum_need(int((death > start - 1).sum()), quorum)


@pytest.mark.parametrize("rate", [0.0, 1e-12, 0.2, 0.5, 0.999])
def test_send_gate_is_jax(rate):
    n = 5000
    jk = jax.random.fold_in(jax.random.PRNGKey(1), 17)
    tk = carry.key_from_numpy(np.asarray(jk))
    assert sampling.gate_threshold(rate) == jax_sampling.gate_threshold(rate)
    want = jax_sampling.send_gate(jk, n, rate)
    got = sampling.send_gate(tk, n, rate)
    if want is True:
        assert got is True
    else:
        assert (got.numpy() == np.asarray(want)).all()
    keys = fused.round_keys(rng.PRNGKey(1), 3, 4)
    jkeys = jax_fused.round_keys(jax.random.PRNGKey(1), 3, 4)
    assert (fused.gate_round_keys(keys).numpy()
            == np.asarray(jax_fused.gate_round_keys(jkeys)).astype(np.int64)).all()


BAD_CONFIGS = [
    {"crash_rate": 0.01, "termination": "global", "algorithm": "push-sum"},
    {"crash_schedule": "3:10", "target_frac": 0.5},
    {"crash_rate": 0.01, "semantics": "reference"},
    {"quorum": 0.0}, {"quorum": 1.5},
    {"termination": "global", "algorithm": "gossip"},
    {"termination": "global", "algorithm": "push-sum", "semantics": "reference"},
    {"termination": "sometimes", "algorithm": "push-sum"},
    {"crash_rate": 0.01, "crash_schedule": "3:10"},
    {"crash_schedule": "3-10"}, {"crash_schedule": "3:0"}, {"crash_schedule": "3:1,3:2"},
    {"fault_rate": 1.0}, {"crash_rate": -0.1},
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_config_errors_are_the_jax_texts(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(n=100, **kw)
    with pytest.raises(ValueError) as err:
        SimConfig(n=100, **kw)
    assert str(err.value) == str(jerr.value)


def test_quorum_without_a_crash_model_warns_as_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxConfig(n=100, quorum=0.9)
        cfg = SimConfig(n=100, quorum=0.9)
    assert cfg.lint_warnings == jcfg.lint_warnings and len(cfg.lint_warnings) == 1
    with pytest.warns(RuntimeWarning, match="quorum < 1.0 without a crash model"):
        SimConfig(n=100, quorum=0.9)
    assert SimConfig(n=100, quorum=0.9, crash_rate=0.01).lint_warnings == ()
    for kw in ({"fault_rate": 0.1}, {"crash_rate": 0.1}, {"crash_schedule": "1:2"}):
        assert SimConfig(n=100, **kw).faulted == JaxConfig(n=100, **kw).faulted
        assert SimConfig(n=100, **kw).crash_model == JaxConfig(n=100, **kw).crash_model


SHIM = r"""
#include "pool.cuh"
#include "scatter.cuh"
using namespace gossip;
extern "C" void gate_keys(uint32_t r1, uint32_t r2, uint32_t* g) {
  gate_key(r1, r2, g[0], g[1]);
}
extern "C" void gates(uint32_t g1, uint32_t g2, uint32_t thresh, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = gate_open(g1, g2, thresh, j) ? 1 : 0;
}
extern "C" void alive(const int* death, int round, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = alive_in(death[j], round) ? 1 : 0;
}
extern "C" void latch(const int* alive, const int* nv, const int* ov, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = frozen(alive[j] != 0, nv[j], ov[j]);
}
extern "C" void unstable(const float* s, const float* w, const float* s2,
                         const float* w2, float delta, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = unstable_global(s[j], w[j], s2[j], w2[j], delta);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("faults_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    u32, P, I, F = ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.gate_keys.argtypes = [u32, u32, P]
    so.gates.argtypes = [u32, u32, u32, I, P]
    so.alive.argtypes = [P, I, I, P]
    so.latch.argtypes = [P, P, P, I, P]
    so.unstable.argtypes = [P, P, P, P, F, I, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.2, 0.9])
def test_gate_rule_is_send_gate(shim, rate):
    n = 70_000
    round_k = sampling.round_key(rng.PRNGKey(5), 41)
    g = np.zeros(2, np.uint32)
    shim.gate_keys(int(round_k[0]), int(round_k[1]), _p(g))
    gk = rng.fold_in(round_k, sampling.GATE_TAG)
    assert g.tolist() == gk.tolist()
    out = np.zeros(n, np.int32)
    shim.gates(int(g[0]), int(g[1]), sampling.gate_threshold(rate), n, _p(out))
    want = sampling.send_gate(round_k, n, rate)
    assert (out == 1).all() if want is True else (out == want.numpy()).all()


def test_alive_latch_and_global_rules(shim):
    n = 4096
    death = faults.death_plane(SimConfig(n=n, crash_rate=0.01), n)
    out = np.zeros(n, np.int32)
    for r in (0, 5, 77, 2**30):
        shim.alive(_p(death), r, n, _p(out))
        assert (out == faults.alive_at(death, r)).all()
    gen = np.random.default_rng(0)
    alive = (gen.random(n) < 0.5).astype(np.int32)
    nv, ov = gen.integers(0, 9, n).astype(np.int32), gen.integers(0, 9, n).astype(np.int32)
    shim.latch(_p(alive), _p(nv), _p(ov), n, _p(out))
    assert (out == np.where(alive != 0, nv, ov)).all()
    s = gen.random(n).astype(np.float32) * 1000
    w = gen.random(n).astype(np.float32)
    s2 = s * (1 + gen.normal(0, 1e-6, n)).astype(np.float32)
    w2 = w.copy()
    w[:4] = [0.0, 1e-45, np.inf, 2.0]  # ratios inf, huge, 0 and small
    s2[4] = np.nan
    delta = 1e-6
    shim.unstable(_p(s), _p(w), _p(s2), _p(w2), delta, n, _p(out))
    ts, tw, ts2, tw2 = (torch.from_numpy(x) for x in (s, w, s2, w2))
    ratio_old = ts / tw
    tol = torch.tensor(delta, dtype=torch.float32) * torch.maximum(
        ratio_old.abs(), torch.ones(()))
    want = (ts2 / tw2 - ratio_old).abs() > tol
    assert (out == want.numpy()).all()
    assert 0 < out.sum() < n
