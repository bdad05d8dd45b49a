"""The port's CLI (cop5615_gossip_protocol_tpu_torch/cli.py) against the JAX
CLI: the same record fields for the same run on the CPU (the reference's
own triples among them), and loud refusal of what is not ported yet."""

import json

import pytest
import torch

from cop5615_gossip_protocol_tpu.cli import main as jax_main

from cop5615_gossip_protocol_tpu_torch import bench
from cop5615_gossip_protocol_tpu_torch.cli import main

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


def _record(capsys, fn, argv):
    rc = fn(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_record_matches_jax_cli(capsys, tmp_path, algorithm):
    common = ["1000", "full", algorithm, "--delivery", "pool", "--pool-size", "2",
              "--seed", "4"]
    jrc, jrec = _record(capsys, jax_main, common)
    path = tmp_path / "runs.jsonl"
    rc, rec = _record(capsys, main, common + ["--platform", "cpu", "--jsonl", str(path)])
    assert rc == jrc == 0
    for field in ("rounds", "outcome", "converged_count", "estimate_mae",
                  "population", "target_count", "schema_version", "resolved_delta"):
        assert rec[field] == jrec[field], field
    # Every config key the port has is the JAX CLI's.
    assert set(rec["config"]) == set(jrec["config"])
    assert set(rec) - {"device"} <= set(jrec)
    assert json.loads(path.read_text()) == rec


@pytest.mark.parametrize("argv", [
    ["1000", "full", "push-sum", "--delivery", "pool", "--pool-size", "2",
     "--fault-rate", "0.1"],
    ["1000", "full", "gossip", "--delivery", "pool", "--crash-rate", "0.002",
     "--quorum", "0.9"],
    ["1000", "full", "gossip", "--crash-schedule", "3:100,6:50", "--quorum", "0.95"],
    ["1000", "full", "push-sum", "--termination", "global"],
    ["900", "imp2D", "push-sum", "--fault-rate", "0.2", "--crash-schedule", "3:50",
     "--quorum", "0.9"],
])
def test_fault_flags_record_matches_jax_cli(capsys, argv):
    # The drop gate, crash-stop with quorum and global termination: the
    # same record fields as the JAX CLI, every config key among them.
    jrc, jrec = _record(capsys, jax_main, argv)
    rc, rec = _record(capsys, main, argv + ["--platform", "cpu"])
    assert rc == jrc == 0
    for field in ("rounds", "outcome", "converged_count", "estimate_mae",
                  "population", "target_count", "resolved_delta"):
        assert rec[field] == jrec[field], field
    assert rec["config"] == jrec["config"]


def test_fault_flags_refuse_a_tier_without_them(capsys):
    # The sharded lattice compositions carry global termination (their
    # exact-stop verdict, ROADMAP A6a-4): asked for, the run passes the
    # knob's check and stops only at the devices, which the CPU has one of;
    # the CLI never runs another tier quietly.
    rc = main(["1000", "torus3d", "push-sum", "--termination", "global", "--devices",
               "2", "--engine", "fused", "--platform", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2 and "ROADMAP" not in err and "n_devices=2 out of range" in err
    rc = main(["1000", "full", "push-sum", "--quorum", "0.9", "--delivery", "pool",
               "--platform", "cpu", "--quiet"])
    assert rc == 0 and "quorum < 1.0 without a crash model" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["1000", "line", "gossip"],
    ["400", "2D", "gossip", "--semantics", "reference"],
    ["1000", "torus3d", "push-sum", "--max-rounds", "50"],
])
def test_lattice_record_matches_jax_cli(capsys, argv):
    # "2D" is the line-wired ref2d in reference semantics (Q6), population
    # n+1 with target n (Q1).
    jrc, jrec = _record(capsys, jax_main, argv)
    rc, rec = _record(capsys, main, argv + ["--platform", "cpu"])
    assert rc == jrc
    for field in ("topology_kind", "rounds", "outcome", "converged_count",
                  "estimate_mae", "population", "target_count", "max_deg"):
        assert rec[field] == jrec[field], field
    assert rec["config"] == jrec["config"]


@pytest.mark.parametrize("argv", [
    ["1000", "full", "gossip"],
    ["1000", "imp3D", "push-sum"],
    ["1000", "imp2D", "gossip", "--semantics", "reference"],
    ["100", "full", "push-sum", "--semantics", "reference"],
    ["100", "2D", "push-sum", "--semantics", "reference"],
])
def test_reference_triple_matches_jax_cli(capsys, argv):
    # The reference's own command lines: default delivery is scatter on full
    # and imp, and reference push-sum is the single walk (rounds are hops).
    jrc, jrec = _record(capsys, jax_main, argv)
    rc, rec = _record(capsys, main, argv + ["--platform", "cpu"])
    assert rc == jrc == 0
    for field in ("topology_kind", "rounds", "outcome", "converged_count",
                  "estimate_mae", "population", "target_count", "max_deg"):
        assert rec[field] == jrec[field], field
    assert rec["config"] == jrec["config"]


def test_quiet_and_reference_format(capsys):
    rc = main(["500", "full", "gossip", "--delivery", "pool", "--platform", "cpu",
               "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Convergence Time: " in out and "{" not in out


@pytest.mark.parametrize("flag,item", [
    (["--deadline-ms", "100"], "A12"),
    (["--devices", "4"], "A10"),
    (["--compile-cache", "cache"], "A12"),
    (["--backend", "refsim"], "A11"),
])
def test_unported_flag_names_roadmap_item(capsys, flag, item):
    rc = main(["1000", "full", "push-sum", "--delivery", "pool", "--platform",
               "cpu"] + flag)
    err = capsys.readouterr().err
    assert rc == 2
    assert flag[0] in err and f"ROADMAP {item}" in err


@pytest.mark.parametrize("argv,item", [
    (["1000", "full", "gossip", "--dtype", "float64"], "A12"),
    (["1000", "ring", "push-sum", "--dtype", "bfloat16"], "A12"),
    (["1000", "imp2d", "gossip", "--plan", "auto"], "A11"),
    (["1000", "imp3d", "push-sum", "--strict-engine"], "A12"),
])
def test_unported_config_names_roadmap_item(capsys, argv, item):
    rc = main(argv + ["--platform", "cpu"])
    assert rc == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["1000", "full", "gossip", "--delivery", "matmul"],
    ["1000", "full", "push-sum", "--delivery", "matmul", "--pool-size", "2"],
    ["900", "imp2d", "gossip", "--delivery", "matmul"],
    ["1000", "full", "gossip", "--dup-rate", "0.1", "--delay-rounds", "3"],
    ["400", "2D", "push-sum", "--dup-rate", "0.05", "--delay-rounds", "2",
     "--max-rounds", "200"],
])
def test_matmul_dup_and_delay_run_as_the_jax_cli(capsys, argv):
    # --delivery matmul, --dup-rate and --delay-rounds run, with the JAX
    # CLI's record.
    jrc, jrec = _record(capsys, jax_main, argv)
    rc, rec = _record(capsys, main, argv + ["--platform", "cpu"])
    assert rc == jrc
    for field in ("topology_kind", "rounds", "outcome", "converged_count",
                  "estimate_mae", "population", "target_count"):
        assert rec[field] == jrec[field], field
    assert rec["config"] == jrec["config"]


def test_invalid_input_fails_loudly(capsys):
    assert main(["1000", "moebius", "gossip", "--platform", "cpu"]) == 2
    assert "Invalid:" in capsys.readouterr().err
    assert main(["1000", "full", "gossip", "--delivery", "pool",
                 "--pool-size", "3", "--platform", "cpu"]) == 2


def test_bench_reports_a_bounded_lattice_sample(capsys, monkeypatch):
    # A lattice run defaults to stencil delivery; one that stops at the
    # default bound fails, one bounded by an explicit --max-rounds is a
    # bounded sample.
    argv = ["--platform", "cpu", "--topology", "torus3d", "--n", "1000"]
    monkeypatch.setattr(bench, "DEFAULT_MAX_ROUNDS", 20)
    assert bench.main(argv) == 1
    assert "FAILED_TO_CONVERGE" in capsys.readouterr().out
    assert bench.main(argv + ["--max-rounds", "20"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["rounds"], rec["outcome"], rec["vs_baseline"]) == (20, "max_rounds", None)
    assert rec["engine_us_per_round"] is None and rec["device"] == "cpu"
