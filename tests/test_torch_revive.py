"""Crash-recovery on the host (cop5615_gossip_protocol_tpu_torch/ops/
faults.py, config.py, cli.py) against the JAX package, bitwise unless said:

- the revival plane over a sweep of seeds, crash and revive rates and
  schedules, and the schedule's "only k are dead there" error word for word;
- the padded plane, ``alive_at`` with a revival plane and ``revived_at``;
- ``quorum_needs`` from the sorted death and revival planes against
  ``quorum_need`` of JAX's per-round live count (the kernels' in-kernel
  count: ``alive_at`` summed);
- ``life_planes`` and the chunk wrappers' ``Faults`` carrying the plane;
- the config's errors in JAX's words, and the CLI's flags: the same config
  as the JAX CLI's, its record's config keys, the errors as "Invalid: ...";
- the kernels' per-node rules (csrc/faults.cuh, csrc/pool.cuh,
  csrc/stencil.cuh built with g++): the alive test with a revival round,
  the rejoin trigger, the reset state of each algorithm and rejoin, the
  mark a rejoining node writes, and the receivers' inboxes that take half
  of (i, 0) from a fresh rejoin, against the plain torch versions.
"""

import ctypes
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import cli as jax_cli
from cop5615_gossip_protocol_tpu.ops import faults as jax_faults

from cop5615_gossip_protocol_tpu_torch import SimConfig
from cop5615_gossip_protocol_tpu_torch import cli
from cop5615_gossip_protocol_tpu_torch.ops import faults, fused
from cop5615_gossip_protocol_tpu_torch.utils.kernels import CSRC

torch.set_num_threads(1)

NEVER = int(np.iinfo(np.int32).max)

PLANES = [
    {"crash_rate": 0.01, "revive_rate": 0.1},
    {"crash_rate": 0.3, "revive_rate": 0.5},
    {"crash_rate": 1e-4, "revive_rate": 0.999},
    {"crash_rate": 0.05, "revive_rate": 1e-6},
    {"crash_schedule": "3:100,6:50", "revive_schedule": "10:60,20:40"},
    {"crash_schedule": "0:500", "revive_schedule": "1:1,2:250,1000:249"},
    {"crash_rate": 0.02, "revive_schedule": "5:3,50:100"},
    {"crash_schedule": "4:200,9:300", "revive_rate": 0.3},
]


@pytest.mark.parametrize("kw", PLANES, ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_revival_plane_is_the_jax_plane(kw, seed):
    n = 1000
    want = jax_faults.revival_plane(JaxConfig(n=n, seed=seed, **kw), n)
    got = faults.revival_plane(SimConfig(n=n, seed=seed, **kw), n)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    death = faults.death_plane(SimConfig(n=n, seed=seed, **kw), n)
    rejoined = got != NEVER
    assert rejoined.any()
    # Only the dead rejoin, strictly after their death.
    assert (death[rejoined] != NEVER).all() and (got[rejoined] >= death[rejoined] + 1).all()
    planes = faults.life_planes(SimConfig(n=n, seed=seed, **kw), n)
    assert np.array_equal(planes.revive, got) and np.array_equal(planes.death, death)


def test_no_recovery_model_has_no_revival_plane():
    cfg = SimConfig(n=100, crash_rate=0.1)
    assert faults.revival_plane(cfg, 100) is None
    assert faults.life_planes(cfg, 100).revive is None
    assert faults.sorted_revival(cfg, 100) is None


@pytest.mark.parametrize("kw", [
    {"crash_schedule": "3:10", "revive_schedule": "5:11"},
    {"crash_schedule": "3:10", "revive_schedule": "3:1"},
    {"crash_schedule": "3:10,8:5", "revive_schedule": "5:4,9:12"},
])
def test_revive_schedule_with_too_few_dead_is_the_jax_error(kw):
    with pytest.raises(ValueError) as jerr:
        jax_faults.revival_plane(JaxConfig(n=100, **kw), 100)
    with pytest.raises(ValueError) as err:
        faults.revival_plane(SimConfig(n=100, **kw), 100)
    assert str(err.value) == str(jerr.value)
    assert "are dead there" in str(err.value)


def test_padded_plane_alive_and_revived_are_jax():
    n, n_pad = 1000, 1024
    cfg = dict(n=n, crash_rate=0.01, revive_rate=0.2, seed=2)
    death = faults.death_plane(SimConfig(**cfg), n)
    revive = faults.revival_plane(SimConfig(**cfg), n)
    padded = faults.pad_revival_plane(revive, n_pad)
    assert np.array_equal(padded, jax_faults.pad_revival_plane(revive, n_pad))
    assert (padded[n:] == NEVER).all() and faults.pad_revival_plane(revive, n) is revive
    dpad = faults.pad_death_plane(death, n_pad)
    for r in (0, 1, 7, 40, 300, 5000):
        want = np.asarray(jax_faults.alive_at(death, r, revive))
        assert np.array_equal(faults.alive_at(death, r, revive), want)
        assert np.array_equal(faults.alive_at(death, r), np.asarray(jax_faults.alive_at(death, r)))
        assert np.array_equal(faults.revived_at(revive, r),
                              np.asarray(jax_faults.revived_at(revive, r)))
        # Pad lanes stay dead.
        assert not faults.alive_at(dpad, r, padded)[n:].any()
        # torch planes take the same rule.
        got = faults.alive_at(torch.from_numpy(death), r, torch.from_numpy(revive))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", PLANES[:5], ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("quorum", [1.0, 0.9, 0.55])
def test_quorum_needs_with_revivals_are_the_in_kernel_count(kw, quorum):
    n = 1000
    cfg = SimConfig(n=n, quorum=quorum, **kw)
    death, revive = faults.death_plane(cfg, n), faults.revival_plane(cfg, n)
    for start, count in ((0, 40), (9, 8), (300, 5), (0, 0)):
        needs, need_init = faults.quorum_needs(np.sort(death), n, start, count, quorum,
                                               np.sort(revive))
        assert needs.shape == (count,)
        for k in range(count):
            alive = np.asarray(jax_faults.alive_at(death, start + k, revive))
            want = int(jax_faults.quorum_need(int(alive.astype(np.int32).sum()), quorum))
            assert needs[k] == want
        alive0 = np.asarray(jax_faults.alive_at(death, start - 1, revive))
        assert need_init == int(jax_faults.quorum_need(int(alive0.sum()), quorum))
    # The chunk wrappers' Faults carry the planes and the same needs.
    fx = fused.run_faults(cfg, n)
    assert np.array_equal(fx.revive, revive)
    needs, _ = fx.needs(9, 8)
    assert np.array_equal(needs.numpy(), faults.quorum_needs(
        np.sort(death), n, 9, 8, quorum, np.sort(revive))[0])


@pytest.mark.parametrize("algorithm,rejoin,reset", [
    ("push-sum", "restore", False), ("push-sum", "fresh", True),
    ("gossip", "restore", True), ("gossip", "fresh", True)])
def test_faults_reset_by_algorithm_and_rejoin(algorithm, rejoin, reset):
    cfg = SimConfig(n=100, algorithm=algorithm, crash_rate=0.1, revive_rate=0.5,
                    rejoin=rejoin)
    fx = fused.run_faults(cfg, 100)
    assert fx.reset == reset and fx.init_term == cfg.initial_term_round
    flat = fx.revive_flat(128, "cpu")
    assert flat.dtype == torch.int32 and (flat[100:] == NEVER).all()
    assert fx.revive_args(128, "cpu")[1:] == [int(reset), cfg.initial_term_round]


BAD_CONFIGS = [
    {"revive_rate": 0.1},
    {"revive_schedule": "3:1"},
    {"crash_rate": 0.1, "revive_rate": 0.1, "revive_schedule": "3:1"},
    {"crash_rate": 0.1, "revive_rate": 1.0},
    {"crash_rate": 0.1, "revive_rate": -0.5},
    {"crash_rate": 0.1, "revive_schedule": "3-1"},
    {"crash_rate": 0.1, "revive_schedule": "3:0"},
    {"crash_rate": 0.1, "revive_schedule": "2:1,2:3"},
    {"crash_rate": 0.1, "rejoin": "reboot"},
    {"rejoin": "later"},
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_config_errors_are_the_jax_texts(kw):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(n=100, **kw)
    with pytest.raises(ValueError) as err:
        SimConfig(n=100, **kw)
    assert str(err.value) == str(jerr.value)


def test_revive_model_is_jax():
    for kw in ({"crash_rate": 0.1}, {"crash_rate": 0.1, "revive_rate": 0.2},
               {"crash_schedule": "1:2", "revive_schedule": "3:1"}):
        assert SimConfig(n=100, **kw).revive_model == JaxConfig(n=100, **kw).revive_model
        assert SimConfig(n=100, **kw).faulted == JaxConfig(n=100, **kw).faulted


CLI_ARGS = [
    ["1000", "full", "push-sum", "--delivery", "pool", "--crash-rate", "0.01",
     "--revive-rate", "0.2", "--rejoin", "fresh", "--quorum", "0.9"],
    ["1000", "full", "gossip", "--crash-schedule", "3:100,6:50",
     "--revive-schedule", "10:60,20:40", "--quorum", "0.95"],
    ["400", "grid2d", "gossip", "--crash-rate", "0.005", "--revive-rate", "0.3",
     "--quorum", "0.9"],
]


def _record(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", CLI_ARGS, ids=lambda a: "-".join(a[:3]))
def test_cli_flags_are_the_jax_clis(capsys, argv):
    jrc, jrec = _record(capsys, jax_cli.main, argv + ["--platform", "cpu"])
    rc, rec = _record(capsys, cli.main, argv + ["--platform", "cpu"])
    assert rc == jrc
    assert rec["config"] == jrec["config"]
    for field in ("revive_rate", "revive_schedule", "rejoin"):
        assert rec["config"][field] == jrec["config"][field]
    for field in ("rounds", "converged_count", "outcome", "estimate_mae"):
        assert rec[field] == jrec[field], field


CLI_ERRORS = [
    (["--revive-rate", "0.1"], lambda: JaxConfig(n=100, revive_rate=0.1)),
    (["--crash-rate", "0.1", "--revive-rate", "0.1", "--revive-schedule", "3:1"],
     lambda: JaxConfig(n=100, crash_rate=0.1, revive_rate=0.1, revive_schedule="3:1")),
    (["--crash-schedule", "3:10", "--revive-schedule", "5:11"],
     lambda: jax_faults.revival_plane(JaxConfig(n=100, crash_schedule="3:10",
                                                revive_schedule="5:11"), 100)),
]


@pytest.mark.parametrize("argv,jax_error", CLI_ERRORS,
                         ids=["nothing-to-revive", "both", "too-few-dead"])
def test_cli_errors_are_the_jax_texts(capsys, argv, jax_error):
    with pytest.raises(ValueError) as jerr:
        jax_error()
    base = ["100", "full", "gossip", "--platform", "cpu"]
    rc = cli.main(base + argv)
    assert rc == 2
    assert f"Invalid: {jerr.value}" in capsys.readouterr().err
    # argparse refuses a rejoin it does not know, as the JAX CLI does.
    with pytest.raises(SystemExit):
        cli.main(base + ["--crash-rate", "0.1", "--rejoin", "reboot"])


SHIM = r"""
#include "pool.cuh"
#include "stencil.cuh"
using namespace gossip;
extern "C" void alive(const int* death, const int* revive, int round, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = node_alive(death, revive, j, round) ? 1 : 0;
}
extern "C" void rejoin_rule(const int* revive, int reset, int round, int n, int* out) {
  for (int j = 0; j < n; ++j) out[j] = rejoins(revive, reset, j, round) ? 1 : 0;
}
extern "C" void reset_pushsum(const int* rn, int init_term, int n, float* s, float* w,
                              int* t, int* c) {
  for (int j = 0; j < n; ++j) rejoin_pushsum(rn[j] != 0, j, init_term, s[j], w[j], t[j], c[j]);
}
extern "C" void reset_gossip(const int* rn, int n, int* cnt, int* act, int* c) {
  for (int j = 0; j < n; ++j) rejoin_gossip(rn[j] != 0, cnt[j], act[j], c[j]);
}
extern "C" void marks(const int8_t* mark, const int* active, int gossip_node,
                      const int* death, const int* revive, int reset, int k, int n,
                      int8_t* out) {
  Faults f{0u, death, nullptr, 0, 0, revive, reset, 0};
  for (int j = 0; j < n; ++j)
    out[j] = rejoin_mark(mark[j], active[j] != 0, gossip_node != 0, f, k, 0u, 0u, j);
}
extern "C" void pool_inbox(const int* offs, const int8_t* mark, const float* s,
                           const float* w, int n, float* in_s, float* in_w) {
  for (int j = 0; j < n; ++j) pool_pushsum_inbox_rejoin<2>(offs, mark, s, w, j, n, in_s[j], in_w[j]);
}
extern "C" void stencil_inbox(const int* d, int classes, const int8_t* mark,
                              const float* s, const float* w, int n, float* in_s,
                              float* in_w) {
  Classes cls{};
  cls.count = classes;
  for (int k = 0; k < classes; ++k) cls.d[k] = d[k];
  for (int j = 0; j < n; ++j) pushsum_inbox_rejoin(cls, mark, s, w, j, n, in_s[j], in_w[j]);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("revive_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.alive.argtypes = [P, P, I, I, P]
    so.rejoin_rule.argtypes = [P, I, I, I, P]
    so.reset_pushsum.argtypes = [P, I, I, P, P, P, P]
    so.reset_gossip.argtypes = [P, I, P, P, P]
    so.marks.argtypes = [P, P, I, P, P, I, I, I, P]
    so.pool_inbox.argtypes = [P, P, P, P, I, P, P]
    so.stencil_inbox.argtypes = [P, I, P, P, P, I, P, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data) if a is not None else None


def _planes(n, seed=1):
    cfg = SimConfig(n=n, crash_schedule=f"2:{n // 4},5:{n // 8}",
                    revive_schedule=f"4:{n // 10},7:{n // 8}", seed=seed)
    return faults.death_plane(cfg, n), faults.revival_plane(cfg, n)


def test_alive_with_a_revival_round(shim):
    n = 4096
    death, revive = _planes(n)
    out = np.zeros(n, np.int32)
    for r in range(10):
        shim.alive(_p(death), _p(revive), r, n, _p(out))
        assert (out == faults.alive_at(death, r, revive)).all()
        shim.alive(_p(death), None, r, n, _p(out))
        assert (out == faults.alive_at(death, r)).all()
        shim.alive(None, None, r, n, _p(out))
        assert out.all()
        for reset in (0, 1):
            shim.rejoin_rule(_p(revive), reset, r, n, _p(out))
            assert (out == (faults.revived_at(revive, r) & bool(reset))).all()
    assert (faults.revived_at(revive, 4)).sum() == n // 10


@pytest.mark.parametrize("algorithm,rejoin", [("push-sum", "fresh"), ("push-sum", "restore"),
                                              ("gossip", "restore")])
def test_reset_state_is_the_plain_rejoin(shim, algorithm, rejoin):
    n = 4096
    death, revive = _planes(n)
    fx = fused.run_faults(SimConfig(n=n, algorithm=algorithm, rejoin=rejoin,
                                    crash_schedule=f"2:{n // 4},5:{n // 8}",
                                    revive_schedule=f"4:{n // 10},7:{n // 8}", seed=1), n)
    gen = np.random.default_rng(3)
    r = 4
    rn = (faults.revived_at(revive, r) & fx.reset).astype(np.int32)
    cf = fused.ChunkFaults(None, None, torch.from_numpy(death), None, None, False,
                           torch.from_numpy(revive), fx.reset, fx.init_term)
    if algorithm == "push-sum":
        s = gen.random(n).astype(np.float32) * 100
        w = gen.random(n).astype(np.float32)
        t = gen.integers(0, 4, n).astype(np.int32)
        c = gen.integers(0, 2, n).astype(np.int32)
        want = cf.rejoin(tuple(torch.from_numpy(x.copy()).reshape(-1, 128)
                               for x in (s, w, t, c)), r)
        shim.reset_pushsum(_p(rn), fx.init_term, n, _p(s), _p(w), _p(t), _p(c))
        got = (s, w, t, c)
    else:
        cnt = gen.integers(0, 12, n).astype(np.int32)
        act = gen.integers(0, 2, n).astype(np.int32)
        c = gen.integers(0, 2, n).astype(np.int32)
        want = cf.rejoin(tuple(torch.from_numpy(x.copy()).reshape(-1, 128)
                               for x in (cnt, act, c)), r)
        shim.reset_gossip(_p(rn), n, _p(cnt), _p(act), _p(c))
        got = (cnt, act, c)
    for g, wnt in zip(got, want):
        assert np.array_equal(g.view(np.int32), wnt.reshape(-1).numpy().view(np.int32))
    changed = rn.sum()
    assert (changed > 0) == (algorithm == "gossip" or rejoin == "fresh")


def test_rejoining_marks_and_inboxes(shim):
    n = 4096
    death, revive = _planes(n)
    gen = np.random.default_rng(5)
    mark = gen.integers(-1, 2, n).astype(np.int8)
    active = gen.integers(0, 2, n).astype(np.int32)
    out = np.zeros(n, np.int8)
    for k in (3, 4, 6, 7):
        alive = faults.alive_at(death, k, revive)
        rn = faults.revived_at(revive, k)
        for gossip_node, reset in ((1, 1), (0, 1), (0, 0)):
            shim.marks(_p(mark), _p(active), gossip_node, _p(death), _p(revive), reset,
                       k, n, _p(out))
            base = np.where((active != 0) & alive & (mark >= 0), mark, -1)
            if gossip_node:
                want = np.where(rn, -1, base)
            else:
                want = np.where(rn & (base >= 0) & bool(reset), base | 16, base)
            assert (out == want).all()
    # The receivers: a source whose mark carries the bit sends half of
    # (its index, 0); the sums run from 0.0 in ascending slot or class order.
    s = gen.random(n).astype(np.float32) * 1000
    w = gen.random(n).astype(np.float32)
    mk = gen.integers(-1, 2, n).astype(np.int8)
    bit = gen.random(n) < 0.2
    tagged = np.where(bit & (mk >= 0), mk | 16, mk).astype(np.int8)
    s_eff = np.where(bit & (mk >= 0), np.arange(n, dtype=np.float32), s)
    w_eff = np.where(bit & (mk >= 0), np.float32(0), w)
    for cls in ([17, 400], [1, 64, 4031]):
        src = [(np.arange(n) - d) % n for d in cls]
        want_s = np.zeros(n, np.float32)
        want_w = np.zeros(n, np.float32)
        for k, i in enumerate(src):
            hit = mk[i] == k
            want_s = want_s + np.where(hit, s_eff[i] * np.float32(0.5), np.float32(0))
            want_w = want_w + np.where(hit, w_eff[i] * np.float32(0.5), np.float32(0))
        in_s, in_w = np.zeros(n, np.float32), np.zeros(n, np.float32)
        d = np.array(cls, np.int32)
        if len(cls) == 2:
            shim.pool_inbox(_p(d), _p(tagged), _p(s), _p(w), n, _p(in_s), _p(in_w))
        else:
            shim.stencil_inbox(_p(d), len(cls), _p(tagged), _p(s), _p(w), n, _p(in_s),
                               _p(in_w))
        assert np.array_equal(in_s.view(np.int32), want_s.view(np.int32))
        assert np.array_equal(in_w.view(np.int32), want_w.view(np.int32))
