"""CLI: the reference-parity positional triple plus the JAX CLI's flags.

    python -m cop5615_gossip_protocol_tpu_torch 1000000 full gossip
    python -m cop5615_gossip_protocol_tpu_torch 1000 imp3D push-sum --semantics reference
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --delivery pool --pool-size 2
    python -m cop5615_gossip_protocol_tpu_torch 16777216 full push-sum \\
        --delivery pool --pool-size 2
    python -m cop5615_gossip_protocol_tpu_torch 16777216 torus3d gossip
    python -m cop5615_gossip_protocol_tpu_torch 16777216 imp3d gossip --delivery pool
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full gossip \\
        --fault-rate 0.2 --crash-schedule 3:10000 --quorum 0.9
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --crash-rate 0.01 --revive-rate 0.2 --rejoin fresh --quorum 0.9
    python -m cop5615_gossip_protocol_tpu_torch 256 full push-sum \\
        --delivery pool --byzantine-schedule 12:8 --robust-agg clip
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --delivery pool --pool-size 2 --trace-convergence trace.jsonl
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --delivery matmul --pool-size 2
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full gossip \\
        --dup-rate 0.05 --delay-rounds 3
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --delivery pool --pool-size 2 --checkpoint run.npz --checkpoint-keep 3 \\
        --resume auto --events events.jsonl --metrics-dump metrics.prom
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum --replicas 8

runs on the GPU (``--platform cuda``, the default) or, when asked, on the
CPU (``--platform cpu``). Flags keep the JAX CLI's names; a JAX CLI flag
this slice does not port yet is rejected with the ROADMAP item that will
port it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import zipfile
from pathlib import Path
from typing import Optional

from .config import SimConfig, normalize_algorithm, normalize_topology

# JAX CLI flags not ported yet, with the ROADMAP item that ports each.
UNPORTED_FLAGS = {
    "--backend": "A11", "--dtype": "A12", "--x64": "A12",
    "--deadline-ms": "A12",
    "--halo-dma": "A10", "--distributed": "A10",
    "--coordinator": "A10", "--num-processes": "A10", "--process-id": "A10",
    "--strict-engine": "A12", "--compile-cache": "A12", "--plan": "A11",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gossip-torch",
        description=(
            "gossip / push-sum simulator on PyTorch and CUDA "
            "(usage parity: numNodes topology algorithm)"
        ),
    )
    p.add_argument("numNodes", type=int, help="requested node count")
    p.add_argument("topology",
                   help="full | line | ring | 2D | grid2d | ref2d | 3D | grid3d "
                   "| torus3d | imp2D | imp3D")
    p.add_argument("algorithm", help="gossip | push-sum")
    p.add_argument("--semantics", choices=["batched", "reference"],
                   default="batched")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--delta", type=float, default=None,
                   help="push-sum stability threshold (default 1e-6 in float32)")
    p.add_argument("--rumor-threshold", type=int, default=10)
    p.add_argument("--term-rounds", type=int, default=3)
    p.add_argument("--termination", choices=["local", "global"], default="local",
                   help="push-sum stop rule: local = the reference's per-node "
                   "consecutive-stability latch (program.fs:119-137); global "
                   "= stop when every node's per-round relative ratio change "
                   "is <= delta (the honest global-residual criterion)")
    p.add_argument("--max-rounds", type=int, default=1_000_000)
    p.add_argument("--chunk-rounds", type=int, default=4096)
    p.add_argument("--pipeline-chunks", type=int, default=2,
                   help="chunks kept in flight (models/pipeline.py)")
    p.add_argument("--replicas", type=int, default=1,
                   help="run this many replicas (distinct per-replica key "
                   "streams, replica 0 = the unbatched run) of the "
                   "configuration as the lanes of one batch engine and report "
                   "per-replica + mean/CI95 statistics (models/sweep.py); "
                   "chunked engines only")
    p.add_argument("--target-frac", type=float, default=None)
    p.add_argument("--suppress", choices=["auto", "on", "off"], default="auto",
                   help="suppress gossip sends to converged targets "
                   "(auto: on in reference semantics)")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="per-round probability a node fails to send (fault injection)")
    p.add_argument("--crash-rate", type=float, default=0.0,
                   help="crash-stop churn: per-round probability each node "
                   "dies permanently (dead nodes neither send nor advance; "
                   "push-sum mass parks on them, conserved)")
    p.add_argument("--crash-schedule", type=str, default=None,
                   metavar="ROUND:COUNT,...",
                   help="deterministic crash-stop schedule: kill COUNT "
                   "uniformly random nodes at each listed round "
                   "(mutually exclusive with --crash-rate)")
    p.add_argument("--revive-rate", type=float, default=0.0,
                   help="crash-recovery churn: per-round probability each "
                   "DEAD node rejoins (geometric dead-time; requires a "
                   "crash model). Gossip revivals rejoin susceptible; "
                   "push-sum rejoin semantics per --rejoin")
    p.add_argument("--revive-schedule", type=str, default=None,
                   metavar="ROUND:COUNT,...",
                   help="deterministic recovery schedule: rejoin COUNT "
                   "uniformly random dead nodes at each listed round "
                   "(mutually exclusive with --revive-rate; requires a "
                   "crash model)")
    p.add_argument("--rejoin", choices=["restore", "fresh"], default="restore",
                   help="push-sum revival semantics: restore = reclaim the "
                   "parked (s, w) mass (conserving); fresh = reset to "
                   "(s=x_i, w=0), discarding parked mass (the modeled "
                   "fault)")
    p.add_argument("--byzantine-rate", type=float, default=0.0,
                   help="adversarial plane: probability each node is "
                   "Byzantine from round 0 (adversaries stay ALIVE and "
                   "count toward quorum; behavior per --byzantine-mode)")
    p.add_argument("--byzantine-schedule", type=str, default=None,
                   metavar="ROUND:COUNT,...",
                   help="deterministic adversary onsets: turn COUNT "
                   "uniformly random nodes Byzantine at each listed round "
                   "(mutually exclusive with --byzantine-rate)")
    p.add_argument("--byzantine-mode",
                   choices=["mass_inflate", "mass_deflate", "stale_rumor",
                            "garble"],
                   default="mass_inflate",
                   help="what adversaries do: push-sum wire corruption "
                   "(mass_inflate = send the unhalved state, mass_deflate "
                   "= send negated mass, garble = swap s/w channels); "
                   "gossip state corruption (stale_rumor = perpetual rumor "
                   "re-injection, garble = fake convergence)")
    p.add_argument("--robust-agg", choices=["none", "clip", "trim"],
                   default="none",
                   help="push-sum countermeasure (chunked engine): bound "
                   "per-round accepted contributions — clip scales each "
                   "received (s, w) pair to a dynamic envelope; trim drops "
                   "the largest-|w| pool contribution channel "
                   "(delivery='pool')")
    p.add_argument("--mass-tolerance", type=float, default=None,
                   help="health sentinel (push-sum, chunked engine): every "
                   "round also checks state finiteness and |sum(w) - n| "
                   "against this tolerance; a trip ends the run with "
                   "outcome=unhealthy + the offending round instead of "
                   "converging wrong")
    p.add_argument("--dup-rate", type=float, default=0.0,
                   help="per-round probability a sent message is delivered "
                   "twice (at-least-once delivery; chunked engine, "
                   "scatter/stencil delivery; kernel A on CUDA under scatter)")
    p.add_argument("--delay-rounds", type=int, default=0,
                   help="defer every round's deliveries through a ring of "
                   "this depth (bounded message delay; chunked engine, "
                   "scatter/stencil delivery; kernel A on CUDA under scatter)")
    p.add_argument("--quorum", type=float, default=1.0,
                   help="crash-model termination: fraction of LIVE nodes "
                   "that must be converged to end the run (default 1.0)")
    p.add_argument("--stall-chunks", type=int, default=0,
                   help="watchdog: stop with outcome=stalled after this "
                   "many consecutive chunks without progress toward the "
                   "termination predicate (0 disables)")
    p.add_argument("--delivery",
                   choices=["auto", "scatter", "stencil", "pool", "matmul"],
                   default="auto",
                   help="message delivery: 'auto' is scatter on full and on "
                   "imp2d/imp3d (along the static extra edge) and stencil on "
                   "the lattices; 'scatter' anywhere; 'pool' on full and on "
                   "imp2d/imp3d (the long-range edge re-drawn each round from "
                   "the pool); 'matmul' where 'pool' applies: the same pooled "
                   "sampling delivered to the targets it implies (the fused "
                   "pool tiers on full, the chunked engine on imp2d/imp3d)")
    p.add_argument("--pool-size", type=int, default=4,
                   help="displacement-pool width for --delivery pool/matmul")
    p.add_argument("--engine", choices=["auto", "chunked", "fused"],
                   default="auto",
                   help="fused: the pool, stencil or imp kernels (their plain "
                   "versions on the CPU); chunked: the scatter kernels on "
                   "CUDA under scatter delivery, else one torch round per "
                   "step; auto: fused on CUDA where the delivery allows, "
                   "chunked otherwise and on the CPU")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on; cpu must be asked for")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the node dimension over this many devices "
                   "(shard i on cuda:i, so N visible cards are needed; with "
                   "--engine fused this runs the replicated-pool2 composition "
                   "on full with --delivery pool past 2**21 nodes, and the "
                   "resident or streaming halo composition on the lattices)")
    p.add_argument("--pool2-wire", choices=["auto", "reduce_scatter", "all_gather"],
                   default="auto",
                   help="delivery wire of the replicated-pool2 composition: "
                   "reduce_scatter delivers each shard only the summary bands "
                   "its pool-slot windows read, all_gather the whole summary "
                   "copy; auto picks reduce_scatter when devices > pool size")
    p.add_argument("--overlap-collectives", choices=["on", "off"], default="on",
                   help="on: the sharded composition's termination verdict is "
                   "read one super-step late, with exact rollback; off: after "
                   "every super-step. Rounds and state are identical either way")
    p.add_argument("--telemetry", action="store_true",
                   help="the telemetry plane (ops/telemetry.py): one counter "
                   "row a round, written on the device by the chunked engine "
                   "and the pool and whole-array lattice kernels and read "
                   "with each chunk's status; the other fused tiers run the "
                   "chunked engine (engine auto) or refuse (engine fused)")
    p.add_argument("--trace-convergence", type=str, default=None,
                   metavar="FILE",
                   help="append the per-round convergence trajectory (rounds, "
                   "converged/newly-converged counts, active count or "
                   "estimate error) as JSONL, one fsynced batch a retired "
                   "chunk; implies --telemetry")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                   "(trace.json, Chrome trace format; each chunk's queueing "
                   "is marked chunkloop.dispatch)")
    p.add_argument("--metrics-dump", type=str, default=None, metavar="FILE",
                   help="after the run, write the process metrics registry "
                   "(utils/obs.py) as Prometheus text exposition to FILE "
                   "('-' = stdout): run outcome/rounds counters, the wall "
                   "budget (build/compile/dispatch/fetch/hook/residual), "
                   "per-chunk dispatch/fetch histograms and the checkpoint "
                   "series")
    p.add_argument("--step-timing", action="store_true",
                   help="clock each retired chunk on the host: t_retire and "
                   "wall_s in the chunk log, the step_timing report on the "
                   "run record and the metrics dump (refused by the sharded "
                   "compositions under --overlap-collectives on)")
    p.add_argument("--events", type=str, default=None, metavar="FILE",
                   help="append schema-versioned lifecycle events (run-start, "
                   "resume, chunk-retired with dispatch/fetch timing splits, "
                   "checkpoint-written, watchdog-fired, run-end) as JSONL "
                   "(utils/events.py)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="write round-state checkpoints to this .npz path")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every K chunks (with --checkpoint)")
    p.add_argument("--checkpoint-keep", type=int, default=1,
                   help="retain this many checkpoint generations "
                   "(utils/checkpoint.py): K >= 2 writes numbered "
                   "<stem>.gNNNNNN.npz generations with a manifest and "
                   "keeps the plain path linked to the newest, so a torn "
                   "or bit-flipped latest write costs one interval, not "
                   "the run; 1 (default) is the single-file layout")
    p.add_argument("--strict-checkpoint", action="store_true",
                   help="fail fast when a checkpoint write fails (OSError "
                   "at the chunk-boundary hook) instead of emitting "
                   "checkpoint-failed and going on with that interval's "
                   "checkpoint lost")
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint .npz (either package's), or "
                   "'auto' to restart from the --checkpoint path's newest "
                   "intact generation when there is one (a fresh run "
                   "otherwise)")
    p.add_argument("--jsonl", type=str, default=None,
                   help="append the structured run record to this JSONL file")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the JSON record on stdout")
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [
        f for f in UNPORTED_FLAGS
        if getattr(args, f[2:].replace("-", "_")) is not None
        # A sweep refuses --deadline-ms with the JAX CLI's text (below).
        and not (f == "--deadline-ms" and args.replicas > 1)
    ]
    if given:
        print(
            "Invalid: " + ", ".join(
                f"{f} is not ported yet (ROADMAP {UNPORTED_FLAGS[f]})"
                for f in given
            ),
            file=sys.stderr,
        )
        return 2

    from .models.runner import run
    from .ops.topology import build_topology
    from .utils import metrics
    from .utils.device import resolve_device

    try:
        device = resolve_device(args.platform)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    try:
        algorithm = normalize_algorithm(args.algorithm)
        kind = normalize_topology(args.topology, args.semantics)
        cfg = SimConfig(
            n=args.numNodes,
            topology=kind,
            algorithm=algorithm,
            semantics=args.semantics,
            seed=args.seed,
            delta=args.delta,
            rumor_threshold=args.rumor_threshold,
            term_rounds=args.term_rounds,
            max_rounds=args.max_rounds,
            chunk_rounds=args.chunk_rounds,
            pipeline_chunks=args.pipeline_chunks,
            target_frac=args.target_frac,
            suppress_converged=(
                None if args.suppress == "auto" else args.suppress == "on"
            ),
            delivery=args.delivery,
            pool_size=args.pool_size,
            engine=args.engine,
            n_devices=args.devices,
            pool2_wire=args.pool2_wire,
            overlap_collectives=args.overlap_collectives == "on",
            fault_rate=args.fault_rate,
            crash_rate=args.crash_rate,
            crash_schedule=args.crash_schedule,
            dup_rate=args.dup_rate,
            delay_rounds=args.delay_rounds,
            revive_rate=args.revive_rate,
            revive_schedule=args.revive_schedule,
            rejoin=args.rejoin,
            byzantine_rate=args.byzantine_rate,
            byzantine_schedule=args.byzantine_schedule,
            byzantine_mode=args.byzantine_mode,
            robust_agg=args.robust_agg,
            mass_tolerance=args.mass_tolerance,
            quorum=args.quorum,
            termination=args.termination,
            stall_chunks=args.stall_chunks,
            strict_checkpoint=args.strict_checkpoint,
            telemetry=args.telemetry or bool(args.trace_convergence),
            step_timing=args.step_timing,
            # Config-level, so the sweep's contracts fail at config time.
            replicas=args.replicas,
        )
        for w in cfg.lint_warnings:
            print(f"Warning: {w}", file=sys.stderr)
        print(metrics.banner(cfg))
        t0 = time.perf_counter()
        topo = build_topology(kind, args.numNodes, seed=args.seed,
                              semantics=args.semantics)
        build_s = time.perf_counter() - t0
    except (ValueError, NotImplementedError) as e:
        print(f"Invalid: {e}", file=sys.stderr)
        return 2

    if args.replicas > 1:
        return _sweep(args, cfg, topo, build_s, device, metrics)

    events = _open_events(args.events, cfg, topo)
    try:
        on_chunk = _checkpoint_hook(args, cfg, events)
    except ValueError as e:
        print(f"Invalid: {e}", file=sys.stderr)
        return 2
    resumed = _resume(args, cfg, events)
    if isinstance(resumed, int):
        return resumed
    start_state, start_round = resumed
    start_conv = 0 if start_state is None else int(start_state.conv.sum())
    try:
        with _profile(args.profile, device):
            result = run(topo, cfg, device=device,
                         start_state=start_state, start_round=start_round,
                         on_telemetry=_trace_writer(args.trace_convergence,
                                                    cfg.algorithm, start_round,
                                                    start_conv),
                         on_chunk=on_chunk, fixed_chunks=events is not None)
    except (ValueError, NotImplementedError) as e:
        print(f"Invalid: {e}", file=sys.stderr)
        return 2
    result.build_s = build_s
    if events is not None:
        _close_events(events, cfg, result)
    print(metrics.convergence_line(result.wall_ms))
    record = metrics.run_record(cfg, topo, result)
    if cfg.step_timing:
        from .models import pipeline as pipeline_mod

        report = pipeline_mod.step_timing_report(result.chunk_log)
        if report is not None:
            record["step_timing"] = report
    if args.metrics_dump:
        from .serving import pool
        from .utils import obs

        # The warm-engine pool's family is in the registry, as in the JAX
        # CLI's dump; a one-shot run keeps no engine in it.
        pool.default_pool()
        obs.observe_run_record(record, chunk_log=result.chunk_log,
                               telemetry=result.telemetry)
        if record.get("step_timing") is not None:
            obs.observe_step_timing(record["step_timing"])
        obs.dump(args.metrics_dump)
    if not args.quiet:
        print(json.dumps(record))
    if args.jsonl:
        metrics.append_jsonl(args.jsonl, record)
    return 0 if result.converged else 1


def _sweep(args, cfg: SimConfig, topo, build_s: float, device, metrics) -> int:
    """``--replicas R`` (the JAX CLI's): R seeds of the configuration as
    the lanes of one batch engine (models/sweep.run_replicas), the summary
    line and the sweep record; exit 0 only when every replica converged.
    The per-run observability flags are refused."""
    for flag, set_ in (
        ("--checkpoint", args.checkpoint),
        ("--resume", args.resume),
        ("--trace-convergence", args.trace_convergence),
        ("--events", args.events),
        # run_replicas collects per-replica trajectories (the API), but
        # the CLI has no sweep serializer.
        ("--telemetry", args.telemetry),
        # The run-budget series of a metrics dump are per-run fields.
        ("--metrics-dump", args.metrics_dump),
        ("--step-timing", args.step_timing),
        # run_batched_keys(deadline=) takes one; the sweep record has no
        # per-replica outcome channel for partial results.
        ("--deadline-ms", args.deadline_ms),
    ):
        if set_:
            print(
                f"Invalid: {flag} does not apply to --replicas sweeps "
                "(per-run observability surfaces; run replicas "
                "unbatched, or use models/sweep.run_replicas for "
                "per-replica trajectories)",
                file=sys.stderr,
            )
            return 2
    from .models.sweep import run_replicas

    try:
        sres = run_replicas(topo, cfg, args.replicas, keep_states=False,
                            device=device)
    except (ValueError, NotImplementedError) as e:
        print(f"Invalid: {e}", file=sys.stderr)
        return 2
    record = sres.to_record()
    record["config"] = {
        "n": cfg.n, "topology": cfg.topology,
        "algorithm": cfg.algorithm, "seed": cfg.seed,
    }
    record["build_s"] = build_s
    ci = f" ±{sres.rounds_ci95:.1f}" if sres.rounds_ci95 is not None else ""
    print(
        f"{args.replicas} replicas: rounds mean "
        f"{sres.rounds_mean:.1f}{ci} (95% CI), wall "
        f"{sres.wall_ms:.2f} ms total "
        f"({sres.wall_ms / args.replicas:.2f} ms/replica)"
    )
    if not args.quiet:
        print(json.dumps(record))
    if args.jsonl:
        metrics.append_jsonl(args.jsonl, record)
    return 0 if sres.all_converged else 1


def _open_events(path: Optional[str], cfg: SimConfig, topo):
    """The run's event log with its opening events (the JAX CLI's), or
    None without ``--events``."""
    if not path:
        return None
    from .utils.events import RunEventLog

    events = RunEventLog(path)
    events.emit(
        "run-start",
        config={"n": cfg.n, "topology": cfg.topology,
                "algorithm": cfg.algorithm, "seed": cfg.seed,
                "semantics": cfg.semantics},
        population=topo.n,
        warnings=list(cfg.lint_warnings),
    )
    if cfg.crash_model:
        events.emit(
            "crash-schedule-applied",
            crash_rate=cfg.crash_rate,
            crash_schedule=cfg.crash_schedule,
            revive_rate=cfg.revive_rate,
            revive_schedule=cfg.revive_schedule,
            rejoin=cfg.rejoin if cfg.revive_model else None,
            quorum=cfg.quorum,
        )
    if cfg.byzantine_model:
        events.emit(
            "byzantine-model-applied",
            byzantine_rate=cfg.byzantine_rate,
            byzantine_schedule=cfg.byzantine_schedule,
            byzantine_mode=cfg.byzantine_mode,
            robust_agg=cfg.robust_agg,
        )
    return events


def _close_events(events, cfg: SimConfig, result) -> None:
    """The events written after the run, in the JAX CLI's order."""
    events.emit_chunks(result.chunk_log)
    for fail in result.hook_failures or ():
        events.emit("checkpoint-failed", **fail)
    if result.outcome == "stalled":
        events.emit("watchdog-fired", rounds=result.rounds)
    if result.outcome == "unhealthy":
        events.emit("sentinel-tripped", rounds=result.rounds,
                    unhealthy_round=result.unhealthy_round,
                    mass_tolerance=cfg.mass_tolerance)
    events.emit("run-end", outcome=result.outcome, rounds=result.rounds,
                converged_count=result.converged_count,
                compile_s=result.compile_s, run_s=result.run_s,
                dispatch_s=result.dispatch_s, fetch_s=result.fetch_s)


def _checkpoint_hook(args, cfg: SimConfig, events):
    """The ``on_chunk`` hook that writes a checkpoint every
    ``--checkpoint-every`` retired chunks, or None without
    ``--checkpoint``. The run hands it the canonical [n] state on the
    host."""
    if not args.checkpoint:
        return None
    from .utils import checkpoint as ckpt

    if args.checkpoint_every < 1:
        raise ValueError(f"--checkpoint-every must be >= 1, got {args.checkpoint_every}")

    counter = {"chunks": 0}

    def hook(rounds, state):
        counter["chunks"] += 1
        if counter["chunks"] % args.checkpoint_every:
            return
        info = ckpt.save(args.checkpoint, state, rounds, cfg,
                         keep=args.checkpoint_keep)
        if events is not None:
            events.emit("checkpoint-written", rounds=rounds, path=info["path"],
                        generation=info["generation"], bytes=info["bytes"],
                        write_s=info["write_s"])

    return hook


# Knobs a resumed run may change: they steer the loop or observe it, and no
# round computes anything else under them (the JAX CLI's set).
_LOOP_KNOBS = ("max_rounds", "chunk_rounds", "n_devices", "pipeline_chunks",
               "overlap_collectives", "halo_dma", "pool2_wire", "telemetry",
               "mass_tolerance", "strict_engine", "strict_checkpoint")


def _resume(args, cfg: SimConfig, events):
    """(start_state, start_round) for the run, (None, 0) for a fresh one,
    or the CLI's exit code 2 after a refusal (the JAX CLI's rules):
    ``--resume auto`` walks ``--checkpoint``'s generations newest first,
    quarantining corrupt ones, and starts fresh when none is intact; an
    explicit path fails loudly; the saved config must equal this one but
    for ``_LOOP_KNOBS``."""
    from .utils import checkpoint as ckpt

    resume_path = args.resume
    if resume_path == "auto":
        if not args.checkpoint:
            print("Invalid: --resume auto needs --checkpoint PATH (the "
                  "sidecar it restarts from)", file=sys.stderr)
            return 2
        resume_path = (args.checkpoint if ckpt.candidate_paths(args.checkpoint)
                       else None)
    if not resume_path:
        return None, 0

    def quarantined(**fields):
        if events is not None:
            events.emit("checkpoint-corrupt-quarantined", **fields)
        print(f"checkpoint generation {fields.get('path')} quarantined: "
              f"{fields.get('reason')}", file=sys.stderr)

    try:
        if args.resume == "auto":
            hit = ckpt.load_latest_intact(resume_path, on_event=quarantined)
            if hit is None:
                print(f"checkpoint {resume_path} has no intact generation; "
                      "starting fresh", file=sys.stderr)
                return None, 0
            start_state, start_round, saved_cfg, info = hit
            resume_path = info["path"]
        else:
            start_state, start_round, saved_cfg = ckpt.load(resume_path)
    except (ValueError, NotImplementedError, OSError, KeyError,
            zipfile.BadZipFile) as e:
        if args.resume == "auto":
            print(f"checkpoint {resume_path} unusable ({e}); starting fresh",
                  file=sys.stderr)
            return None, 0
        print(f"Invalid: {e}", file=sys.stderr)
        return 2
    knobs = {k: getattr(cfg, k) for k in _LOOP_KNOBS}
    if dataclasses.replace(saved_cfg, **knobs) != cfg:
        print("Invalid: checkpoint config mismatch — resume requires the "
              f"original flags (saved: {dataclasses.asdict(saved_cfg)})",
              file=sys.stderr)
        return 2
    if events is not None:
        events.emit("resume", rounds=start_round, path=str(resume_path))
    return start_state, start_round


@contextlib.contextmanager
def _profile(directory: Optional[str], device):
    """A torch.profiler trace of the block into ``directory``/trace.json,
    the card's kernels included on CUDA; nothing without a directory."""
    if not directory:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def _trace_writer(path: Optional[str], algorithm: str, start_round: int = 0,
                  start_conv: int = 0):
    """The streaming ``--trace-convergence`` writer (None without a path):
    each retired chunk's rows are appended as trace records in one fsynced
    batch (metrics.append_jsonl_many), rounds already written skipped by a
    high-water mark, so the file holds one record a round. A resumed run
    starts the mark at its start round and the converged count at its
    state's, so nodes converged before the checkpoint are not newly
    converged in its first record."""
    if not path:
        return None
    from .ops import telemetry as telemetry_mod
    from .utils import metrics

    prev = {"conv": start_conv, "hi": start_round}

    def write(chunk_start, rows):
        skip = prev["hi"] - chunk_start
        if skip > 0:
            if skip >= rows.shape[0]:
                return  # the whole chunk was already written
            rows = rows[skip:]
            chunk_start += skip
        recs = telemetry_mod.rows_to_trace_records(
            rows, chunk_start, algorithm, prev_conv=prev["conv"])
        if recs:
            prev["conv"] = recs[-1]["converged_count"]
        prev["hi"] = chunk_start + rows.shape[0]
        metrics.append_jsonl_many(path, recs)

    return write


if __name__ == "__main__":
    raise SystemExit(main())
