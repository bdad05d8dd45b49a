"""Byzantine adversaries, robust aggregation and the health sentinel
(cop5615_gossip_protocol_tpu_torch/ops/faults.py, config.py, cli.py,
models/runner.py, models/pipeline.py, ops/delivery.py, ops/scatter.py, the
pool and whole-array lattice chunks) against the JAX package:

- the onset plane, both forms, bitwise at n = 200 and 70,000, padded;
- the config's errors in JAX's words, the CLI's flags and records;
- every mode on the chunked engine (full under pool and scatter delivery,
  ring, grid2d, imp2d; with and without crash and revive), bitwise the JAX
  chunked engine, and the acceptance pair of the JAX package's tests:
  unmitigated mass_inflate trips the sentinel at its onset round, the same
  attack under clip converges, and trim converges;
- one chunk of rows 1-2 (the pool kernels) and rows 5-6 (the whole-array
  lattice kernels) in each mode against the JAX kernels in Pallas
  interpret mode, through the port's wrappers on CPU tensors (their plain
  versions): gossip bitwise; push-sum to the JAX package's own tolerance
  between its pool kernel and its chunked engine (its kernel applies the
  lie to doubled planes and inverts it for the keep), while the port's
  fused runs are held bitwise against the JAX chunked engine;
- the ladder: demotion to the chunked engine under engine="auto", JAX's
  ValueError under engine="fused" and with n_devices > 1, and on the card
  kernel A's clip and sentinel instances picked for scatter delivery
  (A6c-2);
- the kernels' per-node rules (csrc/faults.cuh built with g++): the lie
  bit on a mark, what a receiver reads of a lying source, the gossip
  override.
"""

import ctypes
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu import cli as jax_cli
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import faults as jax_faults

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import faults, fused, scatter
from cop5615_gossip_protocol_tpu_torch.utils.kernels import CSRC

from test_torch_fused_pool import assert_bitwise, run_case
from test_torch_resident_faults import _assert_bitwise, _both_chunks
from test_torch_runner_faults import planes_differ, small_pool_cap, stub_card  # noqa: F401

torch.set_num_threads(1)

NEVER = int(np.iinfo(np.int32).max)


# ------------------------------------------------------------------- plane

PLANES = [{"byzantine_rate": 0.05}, {"byzantine_rate": 0.3},
          {"byzantine_schedule": "0:3,12:8"}, {"byzantine_schedule": "5:40,9:1,30:17"}]


@pytest.mark.parametrize("kw", PLANES, ids=lambda kw: str(list(kw.values())[0]))
@pytest.mark.parametrize("n,seed", [(200, 0), (200, 7), (70_000, 3)])
def test_plane_is_the_jax_plane(kw, n, seed):
    kw = dict(kw, algorithm="push-sum")
    want = jax_faults.byzantine_plane(JaxConfig(n=n, seed=seed, **kw), n)
    got = faults.byzantine_plane(SimConfig(n=n, seed=seed, **kw), n)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got != NEVER).any()
    padded = faults.pad_byzantine_plane(got, n + 100)
    assert np.array_equal(padded, jax_faults.pad_byzantine_plane(want, n + 100))
    for r in (0, 5, 12, 40):
        assert np.array_equal(faults.byzantine_at(got, r),
                              np.asarray(jax_faults.byzantine_at(want, r)))
    assert faults.BYZ_TAG == jax_faults.BYZ_TAG


def test_no_byzantine_model_has_no_plane_and_no_faults():
    cfg = SimConfig(n=100, algorithm="push-sum")
    assert faults.byzantine_plane(cfg, 100) is None
    assert fused.run_faults(cfg, 100) is None
    f = fused.run_faults(SimConfig(n=100, algorithm="push-sum", byzantine_rate=0.1,
                                   byzantine_mode="garble"), 100)
    assert f.byz_mode == "garble" and f.death is None and f.thresh is None
    assert f.byz_args(128, "cpu")[1] == fused.BYZ_MODES["garble"]
    assert (f.byz_flat(128, "cpu")[100:] == NEVER).all()


# ------------------------------------------------------------ config, CLI

BAD_CONFIGS = [
    {"byzantine_rate": 1.0},
    {"byzantine_rate": 0.1, "byzantine_schedule": "3:1"},
    {"byzantine_schedule": "3:x"},
    {"byzantine_rate": 0.1, "byzantine_mode": "nonsense"},
    {"byzantine_rate": 0.1, "byzantine_mode": "stale_rumor", "algorithm": "push-sum"},
    {"byzantine_rate": 0.1, "byzantine_mode": "mass_inflate", "algorithm": "gossip"},
    {"robust_agg": "median", "algorithm": "push-sum"},
    {"robust_agg": "clip", "algorithm": "gossip"},
    {"robust_agg": "clip", "mass_tolerance": 1e-3, "algorithm": "push-sum"},
    {"robust_agg": "trim", "algorithm": "push-sum", "delivery": "scatter"},
    {"robust_agg": "trim", "algorithm": "push-sum", "delivery": "pool",
     "topology": "imp2d"},
    {"mass_tolerance": 0.0, "algorithm": "push-sum"},
    {"mass_tolerance": 1e-3, "algorithm": "gossip"},
    {"mass_tolerance": 1e-3, "algorithm": "push-sum", "crash_rate": 0.1,
     "revive_rate": 0.1, "rejoin": "fresh"},
    {"mass_tolerance": 1e-3, "algorithm": "push-sum", "semantics": "reference"},
    {"byzantine_rate": 0.1, "algorithm": "push-sum", "semantics": "reference"},
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_config_errors_are_the_jax_texts(kw):
    fields = {"n": 100, "algorithm": "push-sum", **kw}
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ValueError) as err:
        SimConfig(**fields)
    assert str(err.value) == str(jerr.value)


def test_model_and_lint_are_jax():
    for kw in ({"byzantine_rate": 0.1}, {"byzantine_schedule": "3:4"}, {}):
        kw = dict(kw, byzantine_mode="garble")
        assert SimConfig(n=100, **kw).byzantine_model == JaxConfig(n=100, **kw).byzantine_model
    kw = dict(n=100, algorithm="push-sum", robust_agg="clip")
    with pytest.warns(RuntimeWarning):
        cfg = SimConfig(**kw)
    with pytest.warns(RuntimeWarning):
        assert cfg.lint_warnings == JaxConfig(**kw).lint_warnings
    assert SimConfig(n=100, byzantine_rate=0.1, byzantine_mode="garble").faulted


CLI_ARGS = [
    ["256", "full", "push-sum", "--delivery", "pool", "--byzantine-schedule", "12:8",
     "--mass-tolerance", "1e-3", "--chunk-rounds", "32"],
    ["256", "full", "push-sum", "--delivery", "pool", "--byzantine-schedule", "12:8",
     "--robust-agg", "clip"],
    ["300", "full", "gossip", "--byzantine-rate", "0.05", "--byzantine-mode",
     "stale_rumor", "--max-rounds", "200"],
    ["100", "ring", "push-sum", "--byzantine-rate", "0.05", "--byzantine-mode",
     "mass_deflate", "--max-rounds", "200"],
]


def _record(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", CLI_ARGS, ids=lambda a: "-".join(a[3:7]))
def test_cli_flags_are_the_jax_clis(capsys, argv):
    jrc, jrec = _record(capsys, jax_cli.main, argv + ["--platform", "cpu"])
    rc, rec = _record(capsys, cli.main, argv + ["--platform", "cpu"])
    assert rc == jrc
    for field in ("byzantine_rate", "byzantine_schedule", "byzantine_mode",
                  "robust_agg", "mass_tolerance"):
        assert rec["config"][field] == jrec["config"][field], field
    for field in ("rounds", "converged_count", "outcome", "estimate_mae",
                  "unhealthy_round"):
        assert rec[field] == jrec[field], field


def test_cli_errors_are_the_jax_texts(capsys):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(n=100, algorithm="gossip", byzantine_rate=0.1,
                  byzantine_mode="mass_inflate")
    rc = cli.main(["100", "full", "gossip", "--platform", "cpu", "--byzantine-rate", "0.1"])
    assert rc == 2
    assert f"Invalid: {jerr.value}" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["100", "full", "push-sum", "--platform", "cpu", "--robust-agg", "median"])


# ------------------------------------------------------ the chunked engine

def both_runs(kind, n, algorithm, engine="chunked", **kw):
    """(JAX chunked-engine result, its final state, the port's result)."""
    fields = dict(n=n, topology=kind, algorithm=algorithm, **kw)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n, seed=fields.get("seed", 0)),
                          JaxConfig(engine="chunked", **fields),
                          on_chunk=lambda r, st: seen.update(state=st))
    tres = run(build_topology(kind, n, seed=fields.get("seed", 0)),
               SimConfig(engine=engine, **fields), device="cpu")
    return jres, seen["state"], tres


def assert_same_run(jres, jstate, tres):
    assert (tres.rounds, tres.converged_count, tres.outcome, tres.unhealthy_round) == (
        jres.rounds, jres.converged_count, jres.outcome, jres.unhealthy_round)
    assert tres.estimate_mae == jres.estimate_mae
    assert not any(d.any() for d in planes_differ(jstate, tres.state).values())


CHURN = {"crash_schedule": "3:10,7:5", "revive_schedule": "9:8", "quorum": 0.8}
# (kind, n, delivery, with churn)
ENGINES = [("full", 256, "pool", False), ("full", 256, "scatter", True),
           ("ring", 64, "auto", False), ("grid2d", 100, "auto", True),
           ("imp2d", 100, "pool", True)]
MODES = {"push-sum": ("mass_inflate", "mass_deflate", "garble"),
         "gossip": ("stale_rumor", "garble")}


@pytest.mark.parametrize("algorithm,mode", [(a, m) for a, ms in MODES.items() for m in ms])
@pytest.mark.parametrize("kind,n,delivery,churn", ENGINES, ids=lambda x: str(x))
def test_chunked_engine_is_the_jax_chunked_engine(kind, n, delivery, churn, algorithm,
                                                  mode):
    kw = dict(delivery=delivery, byzantine_rate=0.05, byzantine_mode=mode,
              max_rounds=150, seed=4, **(CHURN if churn else {}))
    assert_same_run(*both_runs(kind, n, algorithm, **kw))


@pytest.mark.parametrize("mode", MODES["push-sum"])
@pytest.mark.parametrize("kind,n,delivery", [("full", 256, "scatter"), ("ring", 64, "auto"),
                                             ("imp2d", 100, "pool")])
def test_clip_on_the_chunked_engine_is_jax(kind, n, delivery, mode):
    # The clipped absorb's fused multiply-add (pushsum.absorb_clipped).
    assert_same_run(*both_runs(kind, n, "push-sum", delivery=delivery,
                               byzantine_rate=0.05, byzantine_mode=mode,
                               robust_agg="clip", max_rounds=150, seed=4))


ACCEPT = dict(delivery="pool", chunk_rounds=32, max_rounds=2000,
              byzantine_schedule="12:8", byzantine_mode="mass_inflate", seed=0)


def test_unmitigated_mass_inflate_is_unhealthy_at_its_onset():
    jres, jstate, tres = both_runs("full", 256, "push-sum", mass_tolerance=1e-3, **ACCEPT)
    assert_same_run(jres, jstate, tres)
    assert tres.outcome == "unhealthy" and tres.unhealthy_round == 12
    assert tres.rounds == 13 and not tres.converged


def test_clip_converges_under_the_same_attack():
    jres, jstate, tres = both_runs("full", 256, "push-sum", robust_agg="clip", **ACCEPT)
    assert_same_run(jres, jstate, tres)
    assert tres.outcome == "converged" and tres.estimate_mae < 5
    assert (tres.rounds, tres.estimate_mae) == (293, 0.024079235020734446)


def test_trim_converges_under_mass_inflate():
    jres, jstate, tres = both_runs(
        "full", 256, "push-sum", delivery="pool", chunk_rounds=32, max_rounds=2000,
        seed=1, byzantine_rate=0.05, byzantine_mode="mass_inflate", robust_agg="trim")
    assert_same_run(jres, jstate, tres)
    assert tres.outcome == "converged" and tres.estimate_mae < 10


def test_sentinel_on_scatter_and_stencil_is_jax():
    # The sentinel on the other deliveries, honest (no trip) and tripped.
    for kind, n, kw in (("full", 256, {"delivery": "scatter", "byzantine_schedule": "5:4"}),
                        ("ring", 64, {"byzantine_rate": 0.05, "max_rounds": 100}),
                        ("full", 256, {"delivery": "pool", "crash_schedule": "3:20",
                                       "quorum": 0.9})):
        assert_same_run(*both_runs(kind, n, "push-sum", mass_tolerance=1e-3, **kw))


# ---------------------------------------- fused tiers vs the JAX engines

@pytest.mark.parametrize("mode", MODES["push-sum"])
def test_pool_chunk_matches_the_jax_kernel_pushsum(mode):
    kw = {"byzantine_rate": 0.04, "byzantine_mode": mode}
    jout, jex, tout, tex, start, planes = run_case(
        "push-sum", 300, 2, "batched", "mid", None, 20, kw)
    assert jex == tex
    # The JAX kernel lies on doubled planes: its own test holds it to its
    # chunked engine at 1e-4; term and conv bitwise.
    for a, b in zip(jout[:2], tout[:2]):
        assert np.allclose(a, b, atol=1e-4, rtol=0)
    assert_bitwise(jout[2:], tout[2:])


@pytest.mark.parametrize("mode", MODES["gossip"])
def test_pool_chunk_matches_the_jax_kernel_gossip(mode):
    kw = {"byzantine_rate": 0.05, "byzantine_mode": mode, "crash_schedule": "2:20",
          "revive_schedule": "5:10", "quorum": 0.9}
    jout, jex, tout, tex, start, planes = run_case(
        "gossip", 300, 2, "batched", "init", None, None, kw)
    assert jex == tex
    assert_bitwise(jout, tout)


@pytest.mark.parametrize("algorithm,mode", [(a, m) for a, ms in MODES.items() for m in ms])
def test_stencil_chunk_matches_the_jax_kernel(algorithm, mode):
    knobs = {"byzantine_rate": 0.05, "byzantine_mode": mode}
    if (algorithm, mode) != ("gossip", "garble"):
        # The JAX kernel recomputes a dead node's conv from its count, so a
        # dead garble adversary loses the conv its chunked engine keeps
        # frozen; the port follows the chunked engine
        # (test_fused_runs_are_the_jax_chunked_engine).
        knobs.update(crash_rate=0.02, revive_rate=0.3, quorum=0.9)
    jout, jex, out, ex, planes, start = _both_chunks("ring", 256, "stencil", algorithm,
                                                     knobs, 10)
    assert jex == ex
    if algorithm == "gossip":
        _assert_bitwise(out, jout)
    else:
        for a, b in zip(out[:2], jout[:2]):
            assert torch.allclose(a, b, atol=1e-4, rtol=0)
        _assert_bitwise(out[2:], jout[2:])


@pytest.mark.parametrize("kind,n,delivery,algorithm,mode,churn", [
    ("full", 300, "pool", "push-sum", "mass_inflate", False),
    ("full", 300, "pool", "push-sum", "mass_deflate", True),
    ("full", 300, "pool", "gossip", "garble", True),
    ("ring", 256, "auto", "push-sum", "garble", True),
    ("ring", 256, "auto", "gossip", "stale_rumor", True),
    ("ring", 256, "auto", "gossip", "garble", True),
    ("grid2d", 256, "auto", "push-sum", "mass_inflate", True),
], ids=lambda x: str(x))
def test_fused_runs_are_the_jax_chunked_engine(kind, n, delivery, algorithm, mode, churn):
    # The fused tiers' plain versions (rows 1-2 and 5-6), whole runs.
    kw = dict(delivery=delivery, byzantine_rate=0.04, byzantine_mode=mode,
              max_rounds=120, seed=5, chunk_rounds=32)
    if churn:
        kw.update(crash_rate=0.02, revive_rate=0.3, quorum=0.9)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused", **kw)
    assert runner.fused_tier(build_topology(kind, n), cfg) == (
        "pool" if kind == "full" else "stencil", None)
    assert_same_run(*both_runs(kind, n, algorithm, engine="fused", **kw))


# ---------------------------------------------------------------- the ladder

# (kind, n, delivery, knobs, the JAX reason's words or None: runs fused)
LADDER = [
    ("full", 256, "pool", {"byzantine_rate": 0.1}, None),
    ("ring", 256, "auto", {"byzantine_rate": 0.1}, None),
    ("ring", 5000, "auto", {"byzantine_rate": 0.1}, "failure models"),
    ("full", 2000, "pool", {"byzantine_rate": 0.1}, "selected tier: 'pool2'"),
    ("imp2d", 900, "pool", {"byzantine_rate": 0.1}, "failure models"),
    ("full", 256, "pool", {"mass_tolerance": 1e-3}, "health sentinel"),
    ("full", 256, "pool", {"byzantine_rate": 0.1, "robust_agg": "clip"},
     "robust aggregation"),
    ("full", 256, "pool", {"byzantine_rate": 0.1, "robust_agg": "trim"},
     "robust aggregation"),
    ("grid2d", 900, "auto", {"mass_tolerance": 1e-3}, "health sentinel"),
]


@pytest.mark.parametrize("kind,n,delivery,knobs,words", LADDER, ids=lambda x: str(x))
def test_ladder_is_the_jax_ladder(kind, n, delivery, knobs, words, stub_card,
                                  small_pool_cap):
    fields = dict(n=n, topology=kind, algorithm="push-sum", delivery=delivery, **knobs)
    variant, reason = runner.fused_tier(build_topology(kind, n), SimConfig(**fields))
    assert (reason is None) == (words is None)
    if words is not None:
        assert words in reason
        # engine="fused" raises JAX's text, which the JAX runner raises too.
        with pytest.raises(ValueError) as jerr:
            jax_runner.run(jax_topology(kind, n), JaxConfig(engine="fused", **fields))
        with pytest.raises(ValueError) as err:
            run(build_topology(kind, n), SimConfig(engine="fused", **fields), device="cpu")
        assert str(err.value) == str(jerr.value) == f"engine='fused' unavailable: {reason}"
        # engine="auto" on the card demotes to the chunked engine.
        assert run(build_topology(kind, n), SimConfig(**fields)) == "chunked"
        assert stub_card == [torch.device("cuda", 0)]


@pytest.mark.parametrize("knobs,engine", [
    ({"byzantine_rate": 0.1}, "fused"), ({"mass_tolerance": 1e-3}, "fused"),
    ({"byzantine_rate": 0.1, "robust_agg": "clip"}, "fused"),
    ({"byzantine_rate": 0.1}, "auto"), ({"byzantine_rate": 0.1, "robust_agg": "clip"}, "auto"),
])
def test_sharded_runs_raise_the_jax_errors(knobs, engine):
    fields = dict(n=128, topology="full", algorithm="push-sum", delivery="pool",
                  n_devices=2, engine=engine, **knobs)
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology("full", 128), JaxConfig(strict_engine=True, **fields))
    with pytest.raises(ValueError) as err:
        run(build_topology("full", 128), SimConfig(**fields), devices=["cpu"] * 2)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("knobs", [{"byzantine_rate": 0.1, "robust_agg": "clip"},
                                   {"mass_tolerance": 1e-3}])
def test_kernel_a_refuses_clip_and_the_sentinel_on_the_card(knobs):
    # Kernel A has a clip instance and a sentinel instance but none of the
    # two together (csrc/scatter.cu pushsum_instance): the config refuses
    # the pair with the JAX package's text before a chunk is built, and
    # each knob alone picks one instance.
    other = ({"mass_tolerance": 1e-3} if "robust_agg" in knobs
             else {"byzantine_rate": 0.1, "robust_agg": "clip"})
    with pytest.raises(ValueError) as port_err:
        SimConfig(n=256, topology="full", algorithm="push-sum", **knobs, **other)
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(n=256, topology="full", algorithm="push-sum", **knobs, **other)
    assert "robust_agg contradicts mass_tolerance" in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)
    cfg = SimConfig(n=256, topology="full", algorithm="push-sum", **knobs)
    flags = scatter.instance_flags(fused.run_faults(cfg, 256), False)
    assert flags in (scatter.CLIP, scatter.SENTINEL)


@pytest.mark.parametrize("knobs", [{"byzantine_rate": 0.1, "robust_agg": "clip"},
                                   {"mass_tolerance": 1e-3}])
def test_kernel_a_picks_clip_and_sentinel_instances_on_the_card(knobs, monkeypatch):
    # On the card the chunked engine's scatter chunk hands the run's clip or
    # tolerance to the wrapper, and the wrapper picks the kernel's clip or
    # sentinel instance (with telemetry, that instance's telemetry form).
    cfg = SimConfig(n=256, topology="full", algorithm="push-sum", **knobs)
    seen = {}

    def wrapper(state, key, start, rounds, status, **kw):
        seen.update(kw)
        return state, status

    monkeypatch.setattr(runner.scatter, "pushsum_scatter_chunk", wrapper)
    monkeypatch.setattr(runner.scatter, "scatter_graph", lambda topo, device: None)
    init = runner.pushsum_mod.init_state
    monkeypatch.setattr(runner.pushsum_mod, "init_state",
                        lambda n, term, device=None: init(n, term))
    chunk, state0 = runner._make_chunk_fn(build_topology("full", 256), cfg,
                                          faults.rng.PRNGKey(0),
                                          torch.device("cuda", 0), 256)
    chunk(state0, torch.zeros(3, dtype=torch.int32), 0, 4)
    got = seen["faults"]
    assert (got.clip, got.mass_tolerance) == (cfg.robust_agg == "clip", cfg.mass_tolerance)
    want = scatter.CLIP if got.clip else scatter.SENTINEL
    assert scatter.instance_flags(got, False) == want
    assert scatter.instance_flags(got, True) == want | scatter.TELE


# ----------------------------------------------------- the kernels' rules

SHIM = r"""
#include "faults.cuh"
using namespace gossip;
extern "C" void lie_marks(const int8_t* mark, const int* byz, int round, int n, int8_t* out) {
  for (int j = 0; j < n; ++j) out[j] = lie_mark(mark[j], byz, j, round);
}
extern "C" void reads(const int8_t* mark, const float* s, const float* w, int mode, int n,
                      float* hs, float* hw) {
  for (int i = 0; i < n; ++i) read_send(mark[i], i, s[i], w[i], mode, hs[i], hw[i]);
}
extern "C" void overrides(int mode, const int* lying, int n, int* count, int* active,
                          int* conv) {
  for (int j = 0; j < n; ++j) gossip_override(mode, lying[j] != 0, count[j], active[j], conv[j]);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("byz_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.lie_marks.argtypes = [P, P, I, I, P]
    so.reads.argtypes = [P, P, P, I, I, P, P]
    so.overrides.argtypes = [I, P, I, P, P, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("mode", MODES["push-sum"])
def test_lying_marks_and_reads_are_the_plain_lie(shim, mode):
    n = 4096
    gen = np.random.default_rng(8)
    byz = faults.byzantine_plane(SimConfig(n=n, algorithm="push-sum", byzantine_rate=0.1,
                                           seed=2), n)
    byz = np.where(gen.random(n) < 0.5, byz, gen.integers(0, 20, n)).astype(np.int32)
    mark = gen.integers(-1, 4, n).astype(np.int8)
    mark = np.where((gen.random(n) < 0.2) & (mark >= 0), mark | 16, mark).astype(np.int8)
    out = np.zeros(n, np.int8)
    shim.lie_marks(_p(mark), _p(byz), 9, n, _p(out))
    lying = (byz <= 9) & (mark >= 0)
    assert np.array_equal(out, np.where(lying, mark | 32, mark).astype(np.int8))
    # What a receiver reads: the rejoin bit's reset state, halved and
    # flushed, then the mode's pair where the lie bit is set.
    s = (gen.random(n) * 1000).astype(np.float32)
    w = gen.random(n).astype(np.float32)
    s[:64] = np.float32(1.91e-38)
    hs, hw = np.zeros(n, np.float32), np.zeros(n, np.float32)
    shim.reads(_p(out), _p(s), _p(w), fused.BYZ_MODES[mode], n, _p(hs), _p(hw))
    rn = (out >= 0) & ((out & 16) != 0)
    s_eff = torch.from_numpy(np.where(rn, np.arange(n, dtype=np.float32), s))
    w_eff = torch.from_numpy(np.where(rn, np.float32(0), w))
    from cop5615_gossip_protocol_tpu_torch.models import pushsum
    ss, ws, _, _ = pushsum.halve_and_send(s_eff, w_eff, torch.ones(n, dtype=torch.bool))
    ws_, ww_ = faults.lie(mode, ss, ws, s_eff, w_eff, torch.from_numpy(lying))
    assert np.array_equal(hs.view(np.int32), ws_.numpy().view(np.int32))
    assert np.array_equal(hw.view(np.int32), ww_.numpy().view(np.int32))


@pytest.mark.parametrize("mode", MODES["gossip"])
def test_gossip_override_is_the_plain_override(shim, mode):
    n = 1000
    gen = np.random.default_rng(1)
    lying = (gen.random(n) < 0.3).astype(np.int32)
    count = gen.integers(0, 12, n).astype(np.int32)
    active = gen.integers(0, 2, n).astype(np.int32)
    conv = gen.integers(0, 2, n).astype(np.int32)
    want = faults.override(mode, torch.from_numpy(lying != 0), torch.from_numpy(count),
                           torch.from_numpy(active), torch.from_numpy(conv))
    shim.overrides(fused.BYZ_MODES[mode], _p(lying), n, _p(count), _p(active), _p(conv))
    for got, w in zip((count, active, conv), want):
        assert np.array_equal(got, w.numpy())
