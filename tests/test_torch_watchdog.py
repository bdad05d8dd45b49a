"""The chunk loop's boundary hooks (cop5615_gossip_protocol_tpu_torch/models/
pipeline.run_chunks, models/runner.StallWatchdog) against the JAX package:

- the stall watchdog ends a run "stalled" at JAX's round, on the chunked
  engine and on a fused tier's plain version, with and without a crash
  model (whose falling quorum need counts as progress), at pipeline depth 1
  and 4 (the speculative chunks dropped unread), and on the replicated-pool2
  composition;
- the chunk boundaries under a boundary observer are JAX's (chunks of
  chunk_rounds from the start round), and without one the chunked engine
  keeps its growing chunks;
- the hook-failure policy: an OSError in the checkpoint hook is recorded
  and counted under "continue", and ends the run under "raise"
  (``strict_checkpoint``), as in JAX; any other exception propagates;
- step timing: off, the chunk log is key for key what it was; on, each
  entry gains t_retire and wall_s, and ``step_timing_report`` has JAX's
  keys; the sharded plans refuse it under overlapped collectives with JAX's
  text;
- the retired state is copied to the host behind its chunk's own event
  (``_retired_to_host``, a CPU state handed on as it is).
"""

import errno

import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import pipeline as jax_pipeline
from cop5615_gossip_protocol_tpu.models.runner import run as jax_run
from cop5615_gossip_protocol_tpu.parallel.pool2_sharded import (
    plan_pool2_sharded as jax_plan_pool2,
)

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import pipeline, runner
from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel.pool2_sharded import plan_pool2_sharded
from cop5615_gossip_protocol_tpu_torch.utils import obs

torch.set_num_threads(1)

# (label, kind, n, knobs, port engine): runs the watchdog ends, the JAX run
# on its chunked engine (the same boundaries; gossip is bitwise everywhere).
STALLS = [
    ("line-chunked", "line", 128,
     dict(algorithm="gossip", fault_rate=0.9999, stall_chunks=3, chunk_rounds=32,
          max_rounds=100_000), "chunked"),
    ("full-pool-fused", "full", 1000,
     dict(algorithm="gossip", delivery="pool", pool_size=2, fault_rate=0.9999,
          stall_chunks=2, chunk_rounds=16, max_rounds=100_000), "fused"),
    # A crash at round 5 moves the need once; the gap is flat after it.
    ("full-pool-crash-fused", "full", 1000,
     dict(algorithm="gossip", delivery="pool", pool_size=2, fault_rate=0.9999,
          crash_schedule="5:100", quorum=0.9, stall_chunks=2, chunk_rounds=4,
          max_rounds=100_000), "fused"),
    # Nodes die every round: the need keeps falling, so the run is not
    # stalled while they do.
    ("full-crash-rate-chunked", "full", 256,
     dict(algorithm="gossip", fault_rate=0.9999, crash_rate=0.05, quorum=0.9,
          stall_chunks=2, chunk_rounds=4, max_rounds=100_000), "chunked"),
    ("ring-pushsum-crash-chunked", "ring", 200,
     dict(algorithm="push-sum", crash_schedule="2:150", quorum=1.0,
          stall_chunks=3, chunk_rounds=16, max_rounds=5000), "chunked"),
]


@pytest.mark.parametrize("label,kind,n,kw,engine", STALLS, ids=[s[0] for s in STALLS])
def test_watchdog_stalls_at_the_jax_round(label, kind, n, kw, engine):
    jres = jax_run(jax_topology(kind, n), JaxConfig(n=n, topology=kind,
                                                    engine="chunked", **kw))
    got = {}
    for depth in (1, 4):
        cfg = SimConfig(n=n, topology=kind, engine=engine, pipeline_chunks=depth, **kw)
        res = run(build_topology(kind, n), cfg, device="cpu")
        got[depth] = (res.outcome, res.rounds, res.converged_count,
                      [e["rounds"] for e in res.chunk_log])
    assert got[1] == got[4]
    outcome, rounds, count, boundaries = got[1]
    assert (outcome, rounds, count) == (jres.outcome, jres.rounds, jres.converged_count)
    assert boundaries == [e["rounds"] for e in jres.chunk_log]
    assert outcome == "stalled" and rounds < kw["max_rounds"]


def test_watchdog_off_runs_to_max_rounds():
    cfg = SimConfig(n=128, topology="line", algorithm="gossip", fault_rate=0.9999,
                    chunk_rounds=32, max_rounds=256)
    res = run(build_topology("line", 128), cfg, device="cpu")
    assert (res.outcome, res.rounds) == ("max_rounds", 256)


def test_watchdog_on_the_replicated_pool2_composition(monkeypatch):
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    n = 70_000
    kw = dict(n=n, algorithm="gossip", delivery="pool", pool_size=2, fault_rate=0.9999,
              stall_chunks=2, max_rounds=100_000)
    res = run(build_topology("full", n), SimConfig(**kw, n_devices=2, engine="fused"),
              device="cpu", devices=["cpu"] * 2)
    jres = jax_run(jax_topology("full", n), JaxConfig(**kw, chunk_rounds=8,
                                                      engine="chunked"))
    assert (res.outcome, res.rounds) == (jres.outcome, jres.rounds) == ("stalled", 24)


def test_progress_gap_counts_the_quorum_need():
    import numpy as np

    from cop5615_gossip_protocol_tpu_torch.ops import faults

    cfg = SimConfig(n=100, crash_schedule="3:10", quorum=0.9)
    life = faults.life_planes(cfg, 100)
    conv = np.zeros(100, bool)
    conv[:50] = True
    alive = faults.alive_at(life.death, 4, life.revive)
    need = faults.quorum_need(int(alive.sum()), 0.9)
    assert runner._progress_gap(life, 0.9, 100, conv, 5) == need - int(conv[alive].sum())
    assert runner._progress_gap(None, 0.9, 100, torch.tensor(conv), 5) == 50


def test_boundaries_follow_the_observers():
    topo = build_topology("full", 1000)
    cfg = SimConfig(n=1000, algorithm="gossip", chunk_rounds=8)
    free = run(topo, cfg, device="cpu")
    # Growing chunks: 8-round chunks first, then a quarter of the rounds run.
    assert [e["rounds"] for e in free.chunk_log][:2] == [8, 16]
    seen = []
    hooked = run(topo, cfg, device="cpu", on_chunk=lambda r, s: seen.append(r))
    fixed = run(topo, cfg, device="cpu", fixed_chunks=True)
    jres = jax_run(jax_topology("full", 1000), JaxConfig(n=1000, algorithm="gossip",
                                                         chunk_rounds=8))
    want = [e["rounds"] for e in jres.chunk_log]
    assert seen == [e["rounds"] for e in hooked.chunk_log] == want
    assert [e["rounds"] for e in fixed.chunk_log] == want
    assert free.rounds == hooked.rounds == jres.rounds
    for a, b in zip(free.state, hooked.state):
        assert torch.equal(a, b)


# ---------------------------------------------------------- the policies


def _flaky(fail_at):
    calls = []

    def hook(rounds, state):
        calls.append(rounds)
        if len(calls) in fail_at:
            raise OSError(errno.ENOSPC, "No space left on device")

    return hook, calls


@pytest.mark.parametrize("engine", ["chunked", "fused"])
def test_checkpoint_hook_failure_continues_by_default(engine):
    topo = build_topology("full", 256)
    cfg = SimConfig(n=256, algorithm="push-sum", delivery="pool", pool_size=2,
                    chunk_rounds=8, engine=engine, max_rounds=96)
    control = run(topo, cfg, device="cpu")
    counter = obs.default_registry().counter(
        "gossip_tpu_checkpoint_failed_total",
        "chunk-boundary checkpoint-hook I/O failures survived under "
        "hook_error='continue'")
    before = counter.value()
    hook, calls = _flaky({2})
    res = run(topo, cfg, device="cpu", on_chunk=hook)
    assert (res.rounds, res.converged_count, res.outcome) == (
        control.rounds, control.converged_count, control.outcome)
    [fail] = res.hook_failures
    assert fail["rounds"] == calls[1] and "OSError" in fail["error"]
    assert control.hook_failures is None
    assert counter.value() == before + 1
    assert res.hook_s > 0 and "hook_failures" not in res.to_record()


def test_strict_checkpoint_restores_fail_fast():
    cfg = SimConfig(n=256, algorithm="push-sum", chunk_rounds=8, strict_checkpoint=True)
    hook, _ = _flaky({1})
    with pytest.raises(OSError):
        run(build_topology("full", 256), cfg, device="cpu", on_chunk=hook)
    jcfg = JaxConfig(n=256, algorithm="push-sum", chunk_rounds=8, strict_checkpoint=True)
    hook, _ = _flaky({1})
    with pytest.raises(OSError):
        jax_run(jax_topology("full", 256), jcfg, on_chunk=hook)


def test_other_hook_errors_propagate():
    def hook(rounds, state):
        raise KeyError("not an I/O failure")

    with pytest.raises(KeyError):
        run(build_topology("full", 256), SimConfig(n=256, chunk_rounds=8),
            device="cpu", on_chunk=hook)
    with pytest.raises(ValueError, match="hook_error"):
        pipeline.run_chunks(dispatch=None, state0=None, status0=None, start_round=0,
                            max_rounds=1, stride=1, depth=1, hook_error="ignore")


# ---------------------------------------------------------- step timing


def test_step_timing_off_keeps_the_chunk_log():
    topo = build_topology("full", 1000)
    kw = dict(n=1000, algorithm="gossip", delivery="pool", pool_size=2, chunk_rounds=8)
    for engine in ("chunked", "fused"):
        off = run(topo, SimConfig(**kw, engine=engine), device="cpu")
        on = run(topo, SimConfig(**kw, engine=engine, step_timing=True), device="cpu")
        assert all(set(e) == {"rounds", "dispatch_s", "fetch_s"} for e in off.chunk_log)
        assert all(set(e) == {"rounds", "dispatch_s", "fetch_s", "t_retire", "wall_s"}
                   for e in on.chunk_log)
        assert on.rounds == off.rounds
        assert pipeline.step_timing_report(off.chunk_log) is None
    jres = jax_run(jax_topology("full", 1000), JaxConfig(**kw, step_timing=True))
    report = pipeline.step_timing_report(on.chunk_log)
    jreport = jax_pipeline.step_timing_report(jres.chunk_log)
    assert set(report) == set(jreport)
    assert report["rounds"] == jreport["rounds"]
    assert report["straggler"] == jreport["straggler"]
    assert pipeline.straggler_report({0: [1.0, 2.0], 1: [1.5, 2.25]}) == \
        jax_pipeline.straggler_report({0: [1.0, 2.0], 1: [1.5, 2.25]})


def test_step_timing_refused_under_overlap_by_the_sharded_plans():
    topo, jtopo = build_topology("full", 2**22), jax_topology("full", 2**22)
    kw = dict(n=2**22, algorithm="gossip", delivery="pool", pool_size=2,
              engine="fused", n_devices=4, step_timing=True)
    for overlap in (True, False):
        got = plan_pool2_sharded(topo, SimConfig(**kw, overlap_collectives=overlap), 4)
        want = jax_plan_pool2(jtopo, JaxConfig(**kw, overlap_collectives=overlap), 4)
        assert isinstance(got, str) == isinstance(want, str) == overlap
        if overlap:
            assert got == want


def test_retired_state_reaches_the_host_as_it_is_on_the_cpu():
    state = runner.pushsum_mod.init_state(8, 1)
    assert pipeline._retired_to_host(state, None, {}) is state
    nested = pipeline.Ringed(state, torch.zeros(2, 2, 8))
    doubled = pipeline._map_tensors(lambda x: x * 2, nested)
    assert isinstance(doubled, pipeline.Ringed)
    assert torch.equal(doubled.state.s, state.s * 2)
