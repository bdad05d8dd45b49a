"""CLI: the reference-parity positional triple plus the JAX CLI's flags.

    python -m cop5615_gossip_protocol_tpu_torch 1000000 full gossip
    python -m cop5615_gossip_protocol_tpu_torch 1000 imp3D push-sum --semantics reference
    python -m cop5615_gossip_protocol_tpu_torch 1000000 full push-sum \\
        --delivery pool --pool-size 2
    python -m cop5615_gossip_protocol_tpu_torch 16777216 full push-sum \\
        --delivery pool --pool-size 2
    python -m cop5615_gossip_protocol_tpu_torch 16777216 torus3d gossip
    python -m cop5615_gossip_protocol_tpu_torch 16777216 imp3d gossip --delivery pool

runs on the GPU (``--platform cuda``, the default) or, when asked, on the
CPU (``--platform cpu``). Flags keep the JAX CLI's names; a JAX CLI flag
this slice does not port yet is rejected with the ROADMAP item that will
port it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from .config import SimConfig, normalize_algorithm, normalize_topology

# JAX CLI flags not ported yet, with the ROADMAP item that ports each.
UNPORTED_FLAGS = {
    "--backend": "A11", "--dtype": "A12", "--x64": "A12",
    "--termination": "A6", "--deadline-ms": "A12",
    "--halo-dma": "A10", "--distributed": "A10",
    "--coordinator": "A10", "--num-processes": "A10", "--process-id": "A10",
    "--replicas": "A9", "--fault-rate": "A6", "--crash-rate": "A6",
    "--crash-schedule": "A6", "--revive-rate": "A6",
    "--revive-schedule": "A6", "--rejoin": "A6", "--byzantine-rate": "A6",
    "--byzantine-schedule": "A6", "--byzantine-mode": "A6",
    "--robust-agg": "A6", "--mass-tolerance": "A6", "--quorum": "A6",
    "--telemetry": "A6", "--trace-convergence": "A6",
    "--dup-rate": "A7b", "--delay-rounds": "A7b",
    "--stall-chunks": "A8", "--profile": "A8", "--metrics-dump": "A8",
    "--step-timing": "A8", "--events": "A8", "--checkpoint": "A8",
    "--checkpoint-every": "A8", "--checkpoint-keep": "A8",
    "--strict-checkpoint": "A8", "--resume": "A8",
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
    p.add_argument("--max-rounds", type=int, default=1_000_000)
    p.add_argument("--chunk-rounds", type=int, default=4096)
    p.add_argument("--pipeline-chunks", type=int, default=2,
                   help="chunks kept in flight (models/pipeline.py)")
    p.add_argument("--target-frac", type=float, default=None)
    p.add_argument("--suppress", choices=["auto", "on", "off"], default="auto",
                   help="suppress gossip sends to converged targets "
                   "(auto: on in reference semantics)")
    p.add_argument("--delivery",
                   choices=["auto", "scatter", "stencil", "pool", "matmul"],
                   default="auto",
                   help="message delivery: 'auto' is scatter on full and on "
                   "imp2d/imp3d (along the static extra edge) and stencil on "
                   "the lattices; 'scatter' anywhere; 'pool' on full and on "
                   "imp2d/imp3d (the long-range edge re-drawn each round from "
                   "the pool); 'matmul' is not ported yet (ROADMAP A7b)")
    p.add_argument("--pool-size", type=int, default=4,
                   help="displacement-pool width for --delivery pool")
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
        )
        print(metrics.banner(cfg))
        t0 = time.perf_counter()
        topo = build_topology(kind, args.numNodes, seed=args.seed,
                              semantics=args.semantics)
        build_s = time.perf_counter() - t0
        result = run(topo, cfg, device=device)
    except (ValueError, NotImplementedError) as e:
        print(f"Invalid: {e}", file=sys.stderr)
        return 2
    result.build_s = build_s
    print(metrics.convergence_line(result.wall_ms))
    record = metrics.run_record(cfg, topo, result)
    if not args.quiet:
        print(json.dumps(record))
    if args.jsonl:
        metrics.append_jsonl(args.jsonl, record)
    return 0 if result.converged else 1


if __name__ == "__main__":
    raise SystemExit(main())
