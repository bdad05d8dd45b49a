"""The telemetry plane (cop5615_gossip_protocol_tpu_torch/ops/telemetry.py,
models/pipeline.py, models/runner.py, the CLI) against the JAX package:

- the chunked engine's rows bitwise the JAX chunked engine's rows, every
  column, on full under pool and scatter delivery, ring, grid2d and imp2d
  with pool delivery, both algorithms, under the fault sets of the JAX
  package's tests (a crash schedule with quorum, a gate firing on every
  node, crash-recovery, Byzantine adversaries, global termination, the
  sentinel, clip), at up to 70,000 nodes (sum_f32's windows three deep);
- the plain rows of rows 1-2 (the pool kernels) and rows 5-6 (the
  whole-array lattice kernels) against the JAX fused kernels' rows in Pallas
  interpret mode and against the JAX chunked rows: count columns exact, the
  estimate to rtol 1e-5 / atol 1e-7 and the mass to atol 1e-2, the JAX
  package's own tolerances between its fused and chunked rows (its kernels
  and the port's plain versions sum in other orders);
- telemetry on and off give the same run bitwise, on every engine;
- the chunk loop hands each retired chunk's rows to on_aux in order, reads
  the status once a chunk with rows or without, and the collector keeps only
  executed rows (a speculative chunk dropped at termination and a no-op
  chunk's rows never reach it);
- the ladder's demotions and refusals carry the JAX package's texts;
- ``--trace-convergence`` writes the JAX CLI's file byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu import cli as jax_cli
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
from cop5615_gossip_protocol_tpu_torch.models import pipeline, runner
from cop5615_gossip_protocol_tpu_torch.ops import telemetry

from test_torch_runner_faults import small_pool_cap, stub_card  # noqa: F401

torch.set_num_threads(1)

INTS = [telemetry.COL_CONV, telemetry.COL_LIVE, telemetry.COL_GAP, telemetry.COL_ACTIVE,
        telemetry.COL_DROPS, telemetry.COL_DUPS, telemetry.COL_REVIVED, telemetry.COL_BYZ]


def jax_rows(kind, n, engine, **kw):
    res = jax_runner.run(jax_topology(kind, n, seed=kw.get("seed", 0)),
                         JaxConfig(n=n, topology=kind, engine=engine, telemetry=True, **kw))
    return res, res.telemetry.data


def port_run(kind, n, engine, telemetry_on=True, **kw):
    return run(build_topology(kind, n, seed=kw.get("seed", 0)),
               SimConfig(n=n, topology=kind, engine=engine, telemetry=telemetry_on, **kw),
               device="cpu")


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


CRASH = {"crash_schedule": "3:8,6:4", "quorum": 0.9}
CHURN = {"fault_rate": 0.2, "crash_schedule": "3:10,7:5", "revive_schedule": "9:8",
         "quorum": 0.8}
CHUNKED = [
    ("full", 64, "push-sum", {"delivery": "pool"}),
    ("full", 64, "gossip", {"delivery": "pool"}),
    ("full", 256, "push-sum", {"delivery": "scatter"}),
    ("full", 256, "gossip", {"delivery": "scatter"}),
    ("ring", 64, "push-sum", {}),
    ("ring", 64, "gossip", {}),
    ("grid2d", 100, "push-sum", CHURN),
    ("grid2d", 100, "gossip", CHURN),
    ("imp2d", 100, "push-sum", dict(CHURN, delivery="pool", rejoin="fresh")),
    ("imp2d", 100, "gossip", dict(CHURN, delivery="pool")),
    ("full", 64, "gossip", CRASH),
    ("full", 64, "gossip", {"fault_rate": 0.999999999, "max_rounds": 32}),
    ("full", 256, "push-sum", {"byzantine_rate": 0.05, "byzantine_mode": "mass_deflate",
                               **CHURN}),
    ("full", 256, "gossip", {"delivery": "pool", "byzantine_rate": 0.05,
                             "byzantine_mode": "stale_rumor"}),
    ("full", 256, "push-sum", {"termination": "global", "fault_rate": 0.1}),
    ("full", 256, "push-sum", {"byzantine_schedule": "12:8", "mass_tolerance": 1e-3}),
    ("full", 256, "push-sum", {"termination": "global", "byzantine_schedule": "12:8",
                               "byzantine_mode": "mass_inflate", "mass_tolerance": 1e-3}),
    ("full", 256, "push-sum", {"byzantine_rate": 0.05, "robust_agg": "clip"}),
    ("full", 70_000, "push-sum", {"max_rounds": 6}),
]


@pytest.mark.parametrize("kind,n,algorithm,kw", CHUNKED,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{i}" for i, c in enumerate(CHUNKED)])
def test_chunked_rows_are_the_jax_chunked_rows(kind, n, algorithm, kw):
    kw = {"max_rounds": 120, "seed": 3, **kw}
    jres, want = jax_rows(kind, n, "chunked", algorithm=algorithm, **kw)
    tres = port_run(kind, n, "chunked", algorithm=algorithm, **kw)
    assert (tres.rounds, tres.outcome) == (jres.rounds, jres.outcome)
    got = tres.telemetry.data
    assert got.shape == (tres.rounds, telemetry.N_COLS) and tres.telemetry.start_round == 0
    assert same_bits(got, want), np.argwhere(got.view(np.int32) != want.view(np.int32))[:5]


def test_the_crash_schedule_and_the_gate_columns():
    # test_telemetry.py's own crash checks, on the port's rows.
    t = port_run("full", 64, "chunked", algorithm="gossip", seed=2, chunk_rounds=8,
                 max_rounds=4000, **CRASH).telemetry.data
    live = t[:, telemetry.COL_LIVE]
    assert live[0] == 64 and live[-1] == 64 - 12 and (np.diff(live) <= 0).all()
    assert t[-1][telemetry.COL_GAP] <= 0 and (t[:, telemetry.COL_DROPS] == 0).all()
    drop = port_run("full", 64, "chunked", algorithm="gossip", chunk_rounds=8,
                    fault_rate=0.999999999, max_rounds=32).telemetry.data
    assert (drop[:, telemetry.COL_DROPS] == 64).all()


def assert_close_rows(got, want, label):
    """The JAX package's tolerances between its fused and chunked rows."""
    assert got.shape == want.shape, label
    np.testing.assert_array_equal(got[:, INTS], want[:, INTS], err_msg=label)
    np.testing.assert_allclose(got[:, telemetry.COL_MAE], want[:, telemetry.COL_MAE],
                               rtol=1e-5, atol=1e-7, err_msg=label)
    np.testing.assert_allclose(got[:, telemetry.COL_MASS], want[:, telemetry.COL_MASS],
                               atol=1e-2, err_msg=label)


FUSED = [
    ("full", 64, "gossip", {"delivery": "pool", "fault_rate": 0.3}),
    ("full", 64, "push-sum", {"delivery": "pool", "crash_schedule": "3:6",
                              "revive_schedule": "7:3", "rejoin": "fresh", "quorum": 0.9}),
    ("ring", 256, "push-sum", {}),
    ("grid2d", 256, "gossip", {"fault_rate": 0.3, "byzantine_rate": 0.05,
                               "byzantine_mode": "garble"}),
]


@pytest.mark.parametrize("kind,n,algorithm,kw", FUSED,
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(FUSED)])
def test_fused_plain_rows_are_within_the_jax_fused_tolerance(kind, n, algorithm, kw):
    kw = {"seed": 1, "chunk_rounds": 8, "max_rounds": 16, "algorithm": algorithm, **kw}
    _, jfused = jax_rows(kind, n, "fused", **kw)
    _, jchunked = jax_rows(kind, n, "chunked", **kw)
    got = port_run(kind, n, "fused", **kw).telemetry.data
    assert_close_rows(got, jfused, "vs the JAX fused kernel")
    assert_close_rows(got, jchunked, "vs the JAX chunked engine")


@pytest.mark.parametrize("kind,n,engine,kw", [
    ("full", 256, "chunked", {"delivery": "scatter", "fault_rate": 0.2}),
    ("grid2d", 100, "chunked", CHURN),
    ("full", 256, "fused", {"delivery": "pool", "chunk_rounds": 16}),
    ("grid2d", 900, "fused", {"crash_schedule": "3:100,6:50", "revive_schedule": "10:60",
                              "quorum": 0.95, "chunk_rounds": 16}),
])
@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_telemetry_on_and_off_are_the_same_run(kind, n, engine, kw, algorithm):
    kw = dict(kw, algorithm=algorithm, max_rounds=60)
    on = port_run(kind, n, engine, True, **kw)
    off = port_run(kind, n, engine, False, **kw)
    assert off.telemetry is None and on.telemetry.rounds == on.rounds
    assert (on.rounds, on.converged_count, on.outcome) == (
        off.rounds, off.converged_count, off.outcome)
    for a, b in zip(on.state, off.state):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    assert "telemetry" not in on.to_record() and on.to_record()["aux_s"] >= 0


def test_status_is_read_once_a_chunk_with_rows(monkeypatch):
    reads = []
    real_read = pipeline._read
    monkeypatch.setattr(pipeline, "_read", lambda h: reads.append(1) or real_read(h))
    res = port_run("full", 1000, "chunked", algorithm="gossip", chunk_rounds=16)
    assert len(reads) == len(res.chunk_log) < res.rounds
    assert res.telemetry.rounds == res.rounds


def test_the_loop_hands_retired_rows_in_order_and_drops_speculation():
    # Chunks of 10 rounds; the third reaches done after 5 of its rounds, so
    # the fourth (queued at depth 2) is a dropped speculative chunk.
    seen, queued = [], []

    def dispatch(state, status, round_end):
        start = int(status[0])
        ran = 5 if round_end == 30 else (0 if status[1] else round_end - start)
        done = round_end >= 30 or bool(status[1])
        queued.append(round_end)
        rows = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 10) + start
        return state, torch.tensor([start + ran, int(done)]), rows

    col = telemetry.Collector(0, on_rows=lambda s, r: seen.append((s, r[:, 0].tolist())))
    loop = pipeline.run_chunks(dispatch=dispatch, state0=None,
                               status0=torch.tensor([0, 0]), start_round=0,
                               max_rounds=100, stride=10, depth=2, on_aux=col.on_aux)
    assert loop.rounds == 25 and loop.done and 40 in queued
    assert [s for s, _ in seen] == [0, 10, 20]
    assert seen[2][1] == [20.0, 21.0, 22.0, 23.0, 24.0]
    data = col.finalize().data
    assert data.shape == (25, telemetry.N_COLS)
    np.testing.assert_array_equal(data[:, 0], np.arange(25, dtype=np.float32))


def test_the_collector_keeps_executed_rows_only():
    col = telemetry.Collector(7)
    col.on_aux(7, 7, np.ones((8, telemetry.N_COLS), np.float32))  # a no-op chunk
    col.on_aux(7, 10, np.arange(80, dtype=np.float32).reshape(8, 10))
    traj = col.finalize()
    assert traj.start_round == 7 and traj.rounds == 3
    assert traj.to_trace_records("gossip")[0]["rounds"] == 8
    assert telemetry.Collector().finalize().data.shape == (0, telemetry.N_COLS)


def test_trace_records_are_the_jax_records():
    from cop5615_gossip_protocol_tpu.ops import telemetry as jax_telemetry

    data = np.zeros((4, telemetry.N_COLS), np.float32)
    data[:, telemetry.COL_CONV] = [1, 3, 3, 9]
    data[:, telemetry.COL_ACTIVE] = [2, 5, 8, 9]
    data[:, telemetry.COL_MAE] = [0.5, 0.25, 0.125, 0.0625]
    data[2, telemetry.COL_REVIVED] = 4
    data[1:, telemetry.COL_BYZ] = 2
    for algorithm in ("gossip", "push-sum"):
        assert telemetry.rows_to_trace_records(data, 5, algorithm, 1) == \
            jax_telemetry.rows_to_trace_records(data, 5, algorithm, 1)
    assert (telemetry.SCHEMA_VERSION, telemetry.COLUMNS) == (
        jax_telemetry.SCHEMA_VERSION, jax_telemetry.COLUMNS)


LADDER = [
    # (kind, n, delivery, the tier JAX picks) where telemetry demotes.
    ("ring", 5000, "auto", "stencil2"),
    ("full", 2000, "pool", "pool2"),
    ("imp2d", 900, "pool", "imp"),
]


@pytest.mark.parametrize("kind,n,delivery,tier", LADDER)
def test_telemetry_demotes_with_the_jax_text(kind, n, delivery, tier, stub_card,
                                             small_pool_cap):
    fields = dict(n=n, topology=kind, algorithm="push-sum", delivery=delivery,
                  telemetry=True)
    variant, reason = runner.fused_tier(build_topology(kind, n), SimConfig(**fields))
    assert variant == tier and reason == (
        "telemetry counters run in the fused stencil/pool kernels only "
        f"(selected tier: {tier!r})")
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology(kind, n), JaxConfig(engine="fused", **fields))
    with pytest.raises(ValueError) as err:
        run(build_topology(kind, n), SimConfig(engine="fused", **fields), device="cpu")
    assert str(err.value) == str(jerr.value) == f"engine='fused' unavailable: {reason}"
    assert run(build_topology(kind, n), SimConfig(**fields)) == "chunked"
    assert stub_card == [torch.device("cuda", 0)]


@pytest.mark.parametrize("kind,n,delivery", [("full", 64, "pool"), ("grid2d", 900, "auto")])
def test_pool_and_stencil_tiers_carry_telemetry(kind, n, delivery):
    cfg = SimConfig(n=n, topology=kind, delivery=delivery, telemetry=True)
    assert runner.fused_tier(build_topology(kind, n), cfg)[1] is None


def test_a_tier_without_rows_refuses_with_the_jax_text():
    topo = build_topology("ring", 5000)
    with pytest.raises(ValueError, match="the 'stencil2' tier does not carry"):
        runner.fused_engine(topo, SimConfig(n=5000, topology="ring", telemetry=True),
                            (0, 0), "stencil2")


def test_sharded_fused_refuses_with_the_jax_text():
    fields = dict(n=128, topology="full", algorithm="push-sum", delivery="pool",
                  n_devices=2, engine="fused", telemetry=True)
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology("full", 128), JaxConfig(strict_engine=True, **fields))
    with pytest.raises(ValueError) as err:
        run(build_topology("full", 128), SimConfig(**fields), devices=["cpu"] * 2)
    assert str(err.value) == str(jerr.value)


def test_sharded_auto_refuses_naming_a10():
    fields = dict(n=128, topology="full", algorithm="gossip", n_devices=2, telemetry=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        run(build_topology("full", 128), SimConfig(**fields), devices=["cpu"] * 2)


def test_reference_push_sum_refuses_with_the_jax_text():
    kw = dict(n=25, topology="full", algorithm="push-sum", semantics="reference",
              telemetry=True)
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as err:
        SimConfig(**kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("argv", [
    ["1000", "full", "gossip"],
    ["300", "full", "push-sum", "--chunk-rounds", "16"],
    ["900", "grid2d", "push-sum", "--engine", "chunked", "--crash-schedule", "3:100,6:50",
     "--revive-schedule", "10:60,20:40", "--quorum", "0.95", "--max-rounds", "200"],
    ["1000", "full", "gossip", "--delivery", "pool", "--engine", "chunked",
     "--fault-rate", "0.2", "--byzantine-rate", "0.02", "--byzantine-mode", "garble"],
])
def test_trace_file_is_the_jax_clis(tmp_path, capsys, argv):
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert cli.main(argv + ["--platform", "cpu", "--quiet", "--trace-convergence",
                            str(mine)]) == jax_cli.main(
        argv + ["--platform", "cpu", "--quiet", "--trace-convergence", str(theirs)])
    capsys.readouterr()
    assert mine.read_bytes() == theirs.read_bytes()
    recs = [json.loads(line) for line in mine.read_text().splitlines()]
    assert [r["rounds"] for r in recs] == list(range(1, len(recs) + 1))


def test_telemetry_flag_without_a_trace(capsys):
    assert cli.main(["500", "full", "gossip", "--platform", "cpu", "--telemetry"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["config"]["telemetry"] is True and "telemetry" not in rec
