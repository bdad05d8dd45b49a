"""The run-event log and the metrics registry (cop5615_gossip_protocol_tpu_torch/
utils/events.py, utils/obs.py) and the CLI's A8 flags, against the JAX CLI
called in-process with the same argv:

- ``--events``: the same event names in the same order, every non-clock
  field equal (chunk-retired rounds, checkpoint-written rounds, generations
  and bytes, the quarantine's reason and named arrays, watchdog-fired,
  sentinel-tripped, checkpoint-failed, resume, run-end), on runs that
  checkpoint, stall, trip the sentinel, resume with ``--resume auto`` past
  a bit-flipped newest generation, and survive an injected ENOSPC;
- ``--metrics-dump``: ``parse_prometheus`` of both dumps gives the same
  series (JAX's warm-engine pool family aside: the port has no such pool)
  and the same non-clock values;
- ``--resume``'s refusals (a config mismatch, auto without --checkpoint)
  as JAX's, exit 2;
- ``--profile`` writes a torch.profiler trace that holds chunkloop.dispatch;
- the registry itself renders and parses as JAX's does, and the event log
  refuses a newer schema.
"""

import json
from pathlib import Path

import pytest
import torch

from cop5615_gossip_protocol_tpu import cli as jax_cli
from cop5615_gossip_protocol_tpu.serving import pool as jax_pool
from cop5615_gossip_protocol_tpu.utils import checkpoint as jck
from cop5615_gossip_protocol_tpu.utils import obs as jax_obs

from cop5615_gossip_protocol_tpu_torch import cli
from cop5615_gossip_protocol_tpu_torch.serving import pool
from cop5615_gossip_protocol_tpu_torch.utils import checkpoint as ckpt
from cop5615_gossip_protocol_tpu_torch.utils import obs
from cop5615_gossip_protocol_tpu_torch.utils.events import (
    EVENT_SCHEMA_VERSION,
    RunEventLog,
    read_events,
)

torch.set_num_threads(1)

# Event fields read off a clock, and the paths (compared by name).
CLOCK = {"t_wall", "t_run", "dispatch_s", "fetch_s", "t_retire", "wall_s", "write_s",
         "compile_s", "run_s"}


def _fresh(monkeypatch):
    """Empty default registries, warm-engine pools and chaos counters in
    both packages."""
    monkeypatch.setattr(obs, "_DEFAULT", None)
    monkeypatch.setattr(jax_obs, "_DEFAULT", None)
    monkeypatch.setattr(pool, "_DEFAULT", None)
    monkeypatch.setattr(jax_pool, "_DEFAULT", None)
    for mod in (ckpt, jck):
        mod._ENV_STATE.update(saves=0, enospc_left=None)


# The warm-engine pool's series that count its use: the port's one-shot
# runs keep no engine in the pool, so they read 0 where the JAX runner's
# count its cached chunk.
POOL_USE = {"gossip_tpu_engine_pool_hits_total", "gossip_tpu_engine_pool_misses_total",
            "gossip_tpu_engine_pool_entries"}


def _both(tmp_path, monkeypatch, argv, flags=("events",)):
    """Run the JAX CLI and the port's CLI on ``argv`` in directories of their
    own, ``--events`` (and ``--checkpoint``/``--metrics-dump`` where asked)
    in each. Returns {pkg: (rc, dir)}."""
    out = {}
    for pkg, main, extra in (("jax", jax_cli.main, []),
                             ("port", cli.main, ["--platform", "cpu"])):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        _fresh(monkeypatch)
        more = ["--quiet"]
        if "events" in flags:
            more += ["--events", str(d / "events.jsonl")]
        if "checkpoint" in flags:
            more += ["--checkpoint", str(d / "ck.npz")]
        if "metrics" in flags:
            more += ["--metrics-dump", str(d / "metrics.prom")]
        out[pkg] = (main(argv + more + extra), d)
    return out


def _strip(event):
    rec = {k: v for k, v in event.items() if k not in CLOCK}
    for key in ("path",):
        if key in rec:
            rec[key] = Path(rec[key]).name
    if "quarantined" in rec:
        rec["quarantined"] = [Path(p).name for p in rec["quarantined"]]
    if "error" in rec:  # an OSError's text names the run's own directory
        rec["error"] = rec["error"].replace("/jax/", "/").replace("/port/", "/")
    return rec


def _same_events(out):
    (jrc, jdir), (rc, pdir) = out["jax"], out["port"]
    assert rc == jrc
    jev = read_events(jdir / "events.jsonl")
    pev = read_events(pdir / "events.jsonl")
    assert [e["event"] for e in pev] == [e["event"] for e in jev]
    for a, b in zip(pev, jev):
        assert _strip(a) == _strip(b), a["event"]
    return pev


EVENT_RUNS = [
    ("checkpoint-generations",
     ["2000", "full", "push-sum", "--delivery", "pool", "--pool-size", "2",
      "--chunk-rounds", "32", "--checkpoint-keep", "3", "--step-timing"],
     ("events", "checkpoint", "metrics"), "checkpoint-written"),
    ("crash-revive",
     ["1000", "full", "gossip", "--crash-schedule", "3:100", "--revive-schedule",
      "8:50", "--quorum", "0.95", "--chunk-rounds", "4", "--checkpoint-every", "2"],
     ("events", "checkpoint"), "crash-schedule-applied"),
    ("stalled",
     ["128", "line", "gossip", "--fault-rate", "0.9999", "--stall-chunks", "3",
      "--chunk-rounds", "32"], ("events", "metrics"), "watchdog-fired"),
    ("sentinel",
     ["256", "full", "push-sum", "--delivery", "pool", "--byzantine-schedule", "12:8",
      "--mass-tolerance", "1e-3", "--chunk-rounds", "8"], ("events",),
     "sentinel-tripped"),
]


@pytest.mark.parametrize("label,argv,flags,marker", EVENT_RUNS,
                         ids=[r[0] for r in EVENT_RUNS])
def test_event_log_matches_the_jax_cli(label, argv, flags, marker, tmp_path, monkeypatch):
    out = _both(tmp_path, monkeypatch, argv, flags)
    events = _same_events(out)
    names = [e["event"] for e in events]
    assert names[0] == "run-start" and names[-1] == "run-end" and marker in names
    retired = [e["rounds"] for e in events if e["event"] == "chunk-retired"]
    assert retired == sorted(retired) and retired[-1] == events[-1]["rounds"]
    if "checkpoint" in flags:
        written = [e for e in events if e["event"] == "checkpoint-written"]
        every = int(argv[argv.index("--checkpoint-every") + 1]) \
            if "--checkpoint-every" in argv else 1
        assert [e["rounds"] for e in written] == retired[every - 1::every]
    if "metrics" in flags:
        jm = obs.parse_prometheus((out["jax"][1] / "metrics.prom").read_text())
        pm = obs.parse_prometheus((out["port"][1] / "metrics.prom").read_text())
        assert set(pm) == set(jm)
        for name, series in pm.items():
            if name.endswith(("_seconds", "_seconds_bucket", "_seconds_sum",
                              "_us_per_round")):
                assert set(series) == set(jm[name]), name
                continue
            if name in POOL_USE:
                # The JAX runner keeps its jitted chunk in the pool; the
                # port's one-shot run builds its engine per run.
                assert set(series) == set(jm[name]) and set(series.values()) == {0}, name
                continue
            assert series == jm[name], name


def test_resume_auto_quarantines_a_flipped_generation(tmp_path, monkeypatch):
    argv = ["1000", "full", "push-sum", "--delivery", "pool", "--pool-size", "2",
            "--chunk-rounds", "32", "--checkpoint-keep", "3"]
    _both(tmp_path, monkeypatch, argv + ["--max-rounds", "96"], ("checkpoint",))

    def flip(d):
        newest = ckpt.candidate_paths(d / "ck.npz")[0]
        data = bytearray(newest.read_bytes())
        data[len(data) // 2] ^= 0x40
        newest.write_bytes(bytes(data))

    for pkg in ("jax", "port"):
        flip(tmp_path / pkg)
    out = _both(tmp_path, monkeypatch, argv + ["--resume", "auto"],
                ("events", "checkpoint"))
    events = _same_events(out)
    names = [e["event"] for e in events]
    assert names[:3] == ["run-start", "checkpoint-corrupt-quarantined", "resume"]
    assert events[2]["rounds"] == 64 and out["port"][0] == 0
    assert list((tmp_path / "port").glob("*.corrupt"))


def test_checkpoint_failure_is_an_event(tmp_path, monkeypatch):
    monkeypatch.setenv(ckpt.FAULT_ENV, "enospc:1:1")
    argv = ["1000", "full", "gossip", "--delivery", "pool", "--chunk-rounds", "4"]
    out = _both(tmp_path, monkeypatch, argv, ("events", "checkpoint", "metrics"))
    events = _same_events(out)
    [fail] = [e for e in events if e["event"] == "checkpoint-failed"]
    assert fail["rounds"] == 8 and "No space left on device" in fail["error"]
    pm = obs.parse_prometheus((out["port"][1] / "metrics.prom").read_text())
    assert obs.metric_value(pm, "gossip_tpu_checkpoint_failed_total") == 1.0


@pytest.mark.parametrize("argv,extra", [
    (["500", "full", "gossip", "--resume", "auto"], []),
    (["500", "full", "gossip"], ["--seed", "3"]),
])
def test_resume_refusals_match_the_jax_cli(argv, extra, tmp_path, monkeypatch, capsys):
    # The second case resumes a seed-0 checkpoint under --seed 3: a stream
    # knob, so the config match refuses it.
    ck = str(tmp_path / "ck.npz")
    if extra:
        assert cli.main(argv + ["--checkpoint", ck, "--platform", "cpu", "--quiet"]) == 0
        argv = argv + extra + ["--resume", ck]
    capsys.readouterr()
    rc = cli.main(argv + ["--platform", "cpu", "--quiet"])
    err = capsys.readouterr().err
    jrc = jax_cli.main(argv + ["--quiet"])
    jerr = capsys.readouterr().err
    assert rc == jrc == 2
    assert err.splitlines()[-1].split(" (saved:")[0] == \
        jerr.splitlines()[-1].split(" (saved:")[0]


def test_profile_holds_the_dispatch_marks(tmp_path):
    rc = cli.main(["1000", "full", "gossip", "--delivery", "pool", "--platform", "cpu",
                   "--quiet", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "chunkloop.dispatch" in trace
    json.loads(trace)


def test_registry_renders_and_parses_as_jax_does():
    regs = (obs.Registry(), jax_obs.Registry())
    for reg in regs:
        reg.counter("gossip_tpu_x_total", "x", ("outcome",)).inc(2, outcome="ok")
        reg.gauge("gossip_tpu_y", "y").set(1.5)
        h = reg.histogram("gossip_tpu_z_seconds", "z")
        for v in (1e-5, 0.003, 0.2, 7.0, 500.0):
            h.observe(v)
    assert regs[0].render() == regs[1].render()
    assert obs.parse_prometheus(regs[0].render()) == jax_obs.parse_prometheus(
        regs[1].render())
    h = regs[0].histogram("gossip_tpu_z_seconds")
    assert h.quantile(0.5) == regs[1].histogram("gossip_tpu_z_seconds").quantile(0.5)
    rec = {"outcome": "converged", "rounds": 12, "run_s": 0.5, "hook_s": 0.1,
           "chunk_log": [{"rounds": 12, "dispatch_s": 0.01, "fetch_s": 0.02}]}
    assert obs.observe_run_record(rec, registry=obs.Registry()).render() == \
        jax_obs.observe_run_record(rec, registry=jax_obs.Registry()).render()


def test_event_log_refuses_a_newer_schema(tmp_path):
    log = RunEventLog(tmp_path / "e.jsonl")
    log.emit("run-start", population=10)
    log.emit_chunks([{"rounds": 8, "dispatch_s": 0.0, "fetch_s": 0.0}])
    recs = read_events(tmp_path / "e.jsonl")
    assert [r["event"] for r in recs] == ["run-start", "chunk-retired"]
    assert recs[1]["chunk"] == 0 and recs[0]["schema_version"] == EVENT_SCHEMA_VERSION == 7
    with open(tmp_path / "e.jsonl", "a") as f:
        f.write(json.dumps({"schema_version": 8, "event": "x"}) + "\n")
    with pytest.raises(ValueError, match="schema 8"):
        read_events(tmp_path / "e.jsonl")
