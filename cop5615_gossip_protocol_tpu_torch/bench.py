"""North-star benchmark of the port: 1M-node push-sum on ``full`` with
offset-pool delivery, pool_size 2 (the JAX package's bench.py defaults;
past 2**21 nodes ``full`` runs the streaming pool kernels), any lattice
through the tier of lattice kernels the engine ladder picks (resident up
to about 1.5M nodes, streaming past it), or imp2d/imp3d through the imp
kernels (pooled long-range delivery).

    python -m cop5615_gossip_protocol_tpu_torch.bench [--n N] [--algorithm A]
    python -m cop5615_gossip_protocol_tpu_torch.bench --n 16777216
    python -m cop5615_gossip_protocol_tpu_torch.bench --topology torus3d \\
        --n 16777216 --algorithm gossip
    python -m cop5615_gossip_protocol_tpu_torch.bench --topology grid2d \\
        --n 10000
    python -m cop5615_gossip_protocol_tpu_torch.bench --topology torus3d \\
        --n 10000000 --max-rounds 2000
    python -m cop5615_gossip_protocol_tpu_torch.bench --topology imp3d \\
        --n 16777216 --delivery pool

Prints one JSON line with bench.py's keys (metric, value in rounds/sec,
unit, vs_baseline, rounds, wall_s, converged_count, estimate_mae, device),
the run's budget (setup/compile/dispatch/fetch seconds), and, on the GPU:
``engine_us_per_round``, the fused engine's device time per round timed
with CUDA events over one chunk from the initial state (the pool or
streaming pool kernels on ``full``, the resident or streaming stencil kernels on a lattice, the
imp kernels on imp2d/imp3d); ``repeat_wall_s``,
the run's wall when repeated at once in the same process; and ``profile``,
a third run under torch.profiler with the device's busy share and device
time by kernel. Runs on the GPU unless ``--platform cpu`` is given.

A run that ends unconverged at the default bound of DEFAULT_MAX_ROUNDS
prints a FAILED_TO_CONVERGE metric and exits 1; one bounded by an explicit
``--max-rounds`` is a bounded sample (BASELINE's 2,000-round torus3d
push-sum) and is reported with ``outcome`` "max_rounds".
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# The reference's push-sum on full at N=1000 took 418.63 ms (BASELINE.md),
# extrapolated linearly in N as the JAX bench.py does.
AKKA_MS_PER_NODE = 418.63 / 1000.0
ENGINE_ROUNDS = 64
DEFAULT_MAX_ROUNDS = 100_000


def engine_us_per_round(topo, cfg, device) -> float | None:
    """Device microseconds per executed round of one fused chunk of
    ENGINE_ROUNDS rounds from the initial state, by CUDA events, on the
    tier the run used (the pool, stencil or imp kernels)."""
    from .models.runner import fused_engine, fused_tier
    from .ops import rng

    variant, reason = fused_tier(topo, cfg)
    if reason is not None:
        return None
    eng = fused_engine(topo, cfg, rng.PRNGKey(cfg.seed), variant)
    extras = eng.streams(0, ENGINE_ROUNDS)
    state = tuple(p.contiguous().to(device) for p in eng.planes)
    eng.chunk(state, extras, 0, cfg.max_rounds)  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, executed = eng.chunk(state, extras, 0, cfg.max_rounds)
    end.record()
    end.synchronize()
    rounds = int(executed)
    return start.elapsed_time(end) * 1e3 / rounds if rounds else None


def profile_run(topo, cfg, device) -> dict:
    """One more run under torch.profiler: its wall, the device's busy time
    (the summed intervals of device activity, one stream) and busy share,
    and device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from . import run

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(topo, cfg, device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_s": wall, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall if wall > 0 else None,
        "device_time_by_kernel": [
            {"name": k, "total_us": us, "count": c} for k, (us, c) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--topology", default="full")
    ap.add_argument("--algorithm", default="push-sum")
    ap.add_argument("--delta", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=None,
                    help=f"default {DEFAULT_MAX_ROUNDS:,}; given explicitly, a run "
                    "that stops there is a bounded sample, not a failure")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--delivery", default=None,
                    help="default: pool on full, imp2d and imp3d, auto "
                    "(stencil) on the lattices")
    ap.add_argument("--pool-size", type=int, default=None,
                    help="default: 2 on full (the JAX bench's), else 4 (the CLI's)")
    args = ap.parse_args(argv)

    from . import SimConfig, build_topology, run
    from .models.runner import describe_device
    from .utils.device import resolve_device

    device = resolve_device(args.platform)
    delivery = args.delivery or (
        "pool" if args.topology in ("full", "imp2d", "imp3d") else "auto")
    cfg = SimConfig(
        n=args.n, topology=args.topology, algorithm=args.algorithm,
        delta=args.delta, seed=args.seed,
        max_rounds=DEFAULT_MAX_ROUNDS if args.max_rounds is None else args.max_rounds,
        delivery=delivery,
        pool_size=args.pool_size or (2 if args.topology == "full" else 4),
    )
    t0 = time.perf_counter()
    topo = build_topology(args.topology, args.n, seed=args.seed)
    build_s = time.perf_counter() - t0
    result = run(topo, cfg, device=device)
    name = "pushsum" if args.algorithm == "push-sum" else "gossip"
    if not result.converged and args.max_rounds is None:
        print(json.dumps({
            "metric": f"{name}_{args.topology}_{args.n}_FAILED_TO_CONVERGE",
            "value": 0.0, "unit": "rounds/sec", "vs_baseline": 0.0,
        }))
        return 1
    # The baseline is the reference's push-sum on full; no other config has
    # one.
    akka_s = AKKA_MS_PER_NODE * args.n / 1e3
    out = {
        "metric": f"{name}_rounds_per_sec_{args.topology}_n{args.n}",
        "value": result.to_record()["rounds_per_sec"] or 0.0,
        "unit": "rounds/sec",
        "vs_baseline": (akka_s / result.run_s if result.run_s > 0 else 0.0)
        if args.topology == "full" else None,
        "engine_us_per_round": (
            engine_us_per_round(topo, cfg, device) if device.type == "cuda" else None
        ),
        "rounds": result.rounds,
        "wall_s": result.run_s,
        "compile_s": result.compile_s,
        "build_s": build_s,
        "setup_s": result.setup_s,
        "dispatch_s": result.dispatch_s,
        "first_dispatch_s": result.first_dispatch_s,
        "fetch_s": result.fetch_s,
        "outcome": result.outcome,
        "converged_count": result.converged_count,
        "estimate_mae": result.estimate_mae,
        "device": describe_device(device),
    }
    if device.type == "cuda":
        # The same run again in this process, on a card that just worked:
        # tells a first run's warm-up cost from the steady run wall.
        out["repeat_wall_s"] = run(topo, cfg, device=device).run_s
        out["profile"] = profile_run(topo, cfg, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
