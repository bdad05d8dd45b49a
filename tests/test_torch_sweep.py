"""The port's replica sweep (cop5615_gossip_protocol_tpu_torch/models/sweep.py)
held against the JAX package's (cop5615_gossip_protocol_tpu/models/sweep.py),
both on the CPU: every lane's planes, rounds, converged flag, outcome and
estimate bitwise the JAX lane's, on full (scatter and pool delivery), a
lattice (stencil), imp2d, both algorithms and one fault set; replica 0
bitwise the port's one-shot run(); the tag space and replica_keys against
jax.random; filler lanes; a deadline at a retired chunk; the record and
its CI; every refusal's text; and --replicas through both CLIs. The JAX
counterparts are tests/test_sweep.py and the batch-engine tests of
tests/test_serving.py."""

import dataclasses
import functools
import json
import time

import jax
import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu import cli as jax_cli
from cop5615_gossip_protocol_tpu.config import MAX_REPLICAS as JAX_MAX_REPLICAS
from cop5615_gossip_protocol_tpu.models import sweep as jax_sweep

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
from cop5615_gossip_protocol_tpu_torch.config import MAX_REPLICAS
from cop5615_gossip_protocol_tpu_torch.models import sweep
from cop5615_gossip_protocol_tpu_torch.ops import rng

torch.set_num_threads(1)

# (label, kind, n, algorithm, knobs, replicas): every lane of each is held
# bitwise to the JAX lane.
CASES = [
    ("full scatter push-sum", "full", 128, "push-sum", {}, 3),
    ("full pool gossip", "full", 128, "gossip", {"delivery": "pool", "pool_size": 2}, 3),
    ("full pool push-sum", "full", 96, "push-sum", {"delivery": "pool", "pool_size": 2}, 2),
    ("grid2d stencil push-sum", "grid2d", 64, "push-sum", {"max_rounds": 150}, 2),
    ("grid2d stencil gossip", "grid2d", 100, "gossip", {}, 3),
    ("imp2d scatter push-sum", "imp2d", 100, "push-sum", {}, 2),
    ("imp2d pool gossip", "imp2d", 100, "gossip", {"delivery": "pool"}, 3),
    ("full faults push-sum", "full", 128, "push-sum",
     {"crash_rate": 0.003, "quorum": 0.9, "dup_rate": 0.1, "delay_rounds": 2}, 2),
    ("full faults gossip", "full", 128, "gossip",
     {"crash_rate": 0.003, "quorum": 0.9, "dup_rate": 0.1, "delay_rounds": 2}, 3),
    ("full telemetry drop push-sum", "full", 96, "push-sum",
     {"telemetry": True, "fault_rate": 0.1}, 2),
]
IDS = [c[0] for c in CASES]


def _fields(kind, n, algorithm, knobs):
    return dict(n=n, topology=kind, algorithm=algorithm, chunk_rounds=32, **knobs)


@functools.lru_cache(maxsize=None)
def _sweeps(label):
    """(JAX SweepResult, port SweepResult, port topology, config fields)."""
    _, kind, n, algorithm, knobs, replicas = next(c for c in CASES if c[0] == label)
    fields = _fields(kind, n, algorithm, knobs)
    jres = jax_sweep.run_replicas(jax_topology(kind, n), JaxConfig(**fields), replicas)
    topo = build_topology(kind, n)
    tres = sweep.run_replicas(topo, SimConfig(**fields), replicas, device="cpu")
    return jres, tres, topo, fields


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_state(jstate, tstate):
    for f in tstate._fields:
        a, b = _bits(getattr(jstate, f)), _bits(getattr(tstate, f).numpy())
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("label", IDS)
def test_every_lane_is_the_jax_lane(label):
    jres, tres, _, fields = _sweeps(label)
    assert tres.rounds == jres.rounds
    assert tres.converged == jres.converged
    assert tres.outcome == jres.outcome
    assert tres.estimate_mae == jres.estimate_mae
    assert (tres.rounds_mean, tres.rounds_ci95) == (jres.rounds_mean, jres.rounds_ci95)
    assert len(tres.final_states) == len(jres.final_states) == jres.replicas
    for jst, tst in zip(jres.final_states, tres.final_states):
        _same_state(jst, tst)
    if fields.get("telemetry"):
        for jt, tt in zip(jres.telemetry, tres.telemetry):
            assert tt.start_round == jt.start_round
            assert np.array_equal(_bits(tt.data), _bits(jt.data))


@pytest.mark.parametrize("label", ["full scatter push-sum", "grid2d stencil gossip",
                                   "full faults gossip"])
def test_replica0_is_the_one_shot_run(label):
    _, tres, topo, fields = _sweeps(label)
    one = run(topo, SimConfig(**fields), device="cpu")
    assert (one.rounds, one.converged) == (tres.rounds[0], tres.converged[0])
    for f in one.state._fields:
        assert torch.equal(getattr(one.state, f).cpu(),
                           getattr(tres.final_states[0], f)), f


def test_replica_keys_and_the_tag_space_are_jax_random():
    assert (sweep.REPLICA_TAG0, sweep.LANE_FILLER_TAG0, MAX_REPLICAS) == (
        jax_sweep.REPLICA_TAG0, jax_sweep.LANE_FILLER_TAG0, JAX_MAX_REPLICAS)
    for seed in (0, 7, 2**31 + 5):
        want = jax_sweep.replica_keys(jax.random.PRNGKey(seed), 6)
        got = sweep.replica_keys(rng.PRNGKey(seed), 6)
        assert got[0] is not None and torch.equal(got[0], rng.PRNGKey(seed))
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w).astype(np.int64), g.numpy())
    for s in (0, 3, 12345, 2**31, 2**32 - 1, 2**40 + 17):
        assert np.array_equal(sweep._host_key_data(s), jax_sweep._host_key_data(s)), s
    key = rng.fold_in(rng.PRNGKey(9), 4)
    assert np.array_equal(sweep._host_key_data(key),
                          jax_sweep._host_key_data(jax.random.fold_in(jax.random.PRNGKey(9), 4)))
    for bad in (0, MAX_REPLICAS + 1):
        with pytest.raises(ValueError) as te:
            sweep.replica_keys(rng.PRNGKey(0), bad)
        with pytest.raises(ValueError) as je:
            jax_sweep.replica_keys(jax.random.PRNGKey(0), bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="seeds"):
        sweep._host_key_data(-1)


def test_filler_lanes_run_no_round_and_take_the_jax_filler_keys():
    kind, n = "full", 64
    fields = dict(n=n, topology=kind, algorithm="gossip", seed=3, chunk_rounds=16)
    seeds = [3, 11, 42]
    jres = jax_sweep.run_batched_keys(jax_topology(kind, n), JaxConfig(**fields), seeds,
                                      lanes=4)
    topo = build_topology(kind, n)
    tres = sweep.run_batched_keys(topo, SimConfig(**fields), seeds, lanes=4, device="cpu")
    assert (tres.lanes, tres.replicas, tres.rounds, tres.outcome) == (
        jres.lanes, jres.replicas, jres.rounds, jres.outcome)
    for jst, tst in zip(jres.final_states, tres.final_states):
        _same_state(jst, tst)
    # The filler lane's key: fold_in(keys[0], LANE_FILLER_TAG0 + lane).
    engine, hit = sweep._batch_engine(topo, SimConfig(**fields), 4, torch.device("cpu"))
    assert hit
    lanes = engine.init(np.stack([sweep._host_key_data(s) for s in seeds + [3]]), 3)
    jeng, _ = jax_sweep._batch_engine(jax_topology(kind, n), JaxConfig(**fields), 4)
    _, jkd = jeng["lane_init_b"](np.stack([jax_sweep._host_key_data(s)
                                           for s in seeds + [3]]), 3)
    assert np.array_equal(lanes.kd.numpy(), np.asarray(jkd).astype(np.int64))
    assert lanes.done_host.tolist() == [False, False, False, True]
    # A filler lane stays at round 0 through a chunk.
    engine.chunk(lanes, 64)
    assert lanes.rnd_host[3] == 0 and lanes.rnd_host[:3].min() > 0


def test_a_fired_deadline_stops_at_the_first_retired_chunk():
    kind, n = "full", 64
    fields = dict(n=n, topology=kind, algorithm="gossip", rumor_threshold=10**6,
                  max_rounds=10**4, chunk_rounds=8)
    keys = [5, 6]
    jres = jax_sweep.run_batched_keys(jax_topology(kind, n), JaxConfig(**fields), keys,
                                      deadline=time.monotonic() - 1.0)
    topo = build_topology(kind, n)
    tres = sweep.run_batched_keys(topo, SimConfig(**fields), keys,
                                  deadline=time.monotonic() - 1.0, device="cpu")
    assert tres.cancelled and jres.cancelled
    assert tres.rounds == jres.rounds == [8, 8]
    assert tres.outcome == jres.outcome == ["deadline_exceeded"] * 2
    for jst, tst in zip(jres.final_states, tres.final_states):
        _same_state(jst, tst)
    # The partial state is the one-shot run's at its round.
    part = run(topo, SimConfig(**{**fields, "max_rounds": 8, "seed": 6}), device="cpu")
    _same_state(jax.tree.map(np.asarray, part.state), tres.final_states[1])


def test_the_record_and_its_ci_are_the_jax_sweep_record():
    jres, tres, _, _ = _sweeps("full scatter push-sum")
    jrec, trec = jres.to_record(), tres.to_record()
    assert list(trec) == list(jrec)
    clocks = {"compile_s", "run_s", "wall_ms", "wall_ms_per_replica", "engine_cache"}
    assert {k: v for k, v in trec.items() if k not in clocks} == {
        k: v for k, v in jrec.items() if k not in clocks}
    for vals in ([], [3.0], [1, 2, 4, 8], [5.5, None, 7.25, 1e9]):
        assert sweep._mean_ci95(vals) == jax_sweep._mean_ci95(vals)


REFUSED = [
    {"semantics": "reference", "algorithm": "push-sum"},
    {"engine": "fused"},
    {"n_devices": 2},
    {"stall_chunks": 2},
    {"mass_tolerance": 1.0, "algorithm": "push-sum"},
]


@pytest.mark.parametrize("knobs", REFUSED, ids=lambda k: next(iter(k)))
def test_refusals_are_the_jax_texts(knobs):
    fields = {"n": 64, "topology": "full", "algorithm": "gossip", **knobs}
    # At config time with replicas > 1 ...
    with pytest.raises(ValueError) as je:
        JaxConfig(**fields, replicas=2)
    with pytest.raises(ValueError) as te:
        SimConfig(**fields, replicas=2)
    assert str(te.value) == str(je.value)
    # ... and by the engine for a config built with one replica.
    with pytest.raises(ValueError) as je:
        jax_sweep._reject_unsupported(JaxConfig(**fields))
    with pytest.raises(ValueError) as te:
        sweep.run_replicas(build_topology("full", 64), SimConfig(**fields), 2,
                           device="cpu")
    assert str(te.value) == str(je.value)


def test_replica_and_lane_bounds_are_the_jax_texts():
    for bad in (0, MAX_REPLICAS + 1):
        with pytest.raises(ValueError) as je:
            JaxConfig(n=64, replicas=bad)
        with pytest.raises(ValueError) as te:
            SimConfig(n=64, replicas=bad)
        assert str(te.value) == str(je.value)
    topo = build_topology("full", 32)
    cfg = SimConfig(n=32, algorithm="gossip")
    jtopo, jcfg = jax_topology("full", 32), JaxConfig(n=32, algorithm="gossip")
    for keys, lanes in (([], None), ([1, 2, 3], 2)):
        with pytest.raises(ValueError) as je:
            jax_sweep.run_batched_keys(jtopo, jcfg, keys, lanes=lanes)
        with pytest.raises(ValueError) as te:
            sweep.run_batched_keys(topo, cfg, keys, lanes=lanes, device="cpu")
        assert str(te.value) == str(je.value)


# ------------------------------------------------------------------ the CLIs

CLI_ARGV = ["200", "full", "push-sum", "--replicas", "3", "--chunk-rounds", "64"]
CLOCKS = {"compile_s", "run_s", "wall_ms", "wall_ms_per_replica", "build_s",
          "engine_cache"}


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err


def test_replicas_through_both_clis(tmp_path, capsys):
    jrc, jout, _ = _cli(jax_cli.main, CLI_ARGV + ["--platform", "cpu", "--jsonl",
                                                  str(tmp_path / "j.jsonl")], capsys)
    trc, tout, _ = _cli(cli.main, CLI_ARGV + ["--platform", "cpu", "--jsonl",
                                              str(tmp_path / "t.jsonl")], capsys)
    assert jrc == trc == 0
    # The summary line, its times aside.
    assert tout[-2].split(", wall")[0] == jout[-2].split(", wall")[0]
    assert tout[-2].startswith("3 replicas: rounds mean ")
    jrec, trec = json.loads(jout[-1]), json.loads(tout[-1])
    assert list(trec) == list(jrec)
    assert {k: v for k, v in trec.items() if k not in CLOCKS} == {
        k: v for k, v in jrec.items() if k not in CLOCKS}
    for name, rec in (("j", jrec), ("t", trec)):
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["rounds"] == rec["rounds"]
    # Exit 1 when a replica ends unconverged.
    argv = CLI_ARGV + ["--max-rounds", "50", "--quiet", "--platform", "cpu"]
    assert _cli(jax_cli.main, argv, capsys)[0] == _cli(cli.main, argv, capsys)[0] == 1


@pytest.mark.parametrize("flag", [
    ["--checkpoint", "ck.npz"], ["--resume", "ck.npz"],
    ["--trace-convergence", "t.jsonl"], ["--events", "e.jsonl"], ["--telemetry"],
    ["--metrics-dump", "m.prom"], ["--step-timing"], ["--deadline-ms", "100"]],
    ids=lambda f: f[0])
def test_per_run_flags_are_refused_with_the_jax_text(flag, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = CLI_ARGV + flag + ["--platform", "cpu"]
    jrc, _, jerr = _cli(jax_cli.main, argv, capsys)
    trc, _, terr = _cli(cli.main, argv, capsys)
    assert jrc == trc == 2
    want = [line for line in jerr.splitlines() if line.startswith("Invalid")]
    assert want and [line for line in terr.splitlines()
                     if line.startswith("Invalid")] == want
    assert f"Invalid: {flag[0]} does not apply to --replicas sweeps" in want[0]


def test_deadline_without_replicas_stays_unported(capsys):
    rc, _, err = _cli(cli.main, ["64", "full", "gossip", "--deadline-ms", "100",
                                 "--platform", "cpu"], capsys)
    assert rc == 2 and "--deadline-ms is not ported yet (ROADMAP A12)" in err


def test_a_replica_config_refused_through_the_cli_is_the_jax_text(capsys):
    argv = ["64", "full", "gossip", "--replicas", "2", "--engine", "fused",
            "--platform", "cpu"]
    jrc, _, jerr = _cli(jax_cli.main, argv, capsys)
    trc, _, terr = _cli(cli.main, argv, capsys)
    assert jrc == trc == 2
    assert [x for x in terr.splitlines() if x.startswith("Invalid")] == [
        x for x in jerr.splitlines() if x.startswith("Invalid")]
