#!/usr/bin/env python3
"""Count the round kernels that a torch.profiler trace holds of a short
scatter run on one NVIDIA GPU, against the launches the wrapper counted,
with four ways of placing the trace around the run.

    python3 scripts/profiler_window.py [--reps 60] [--load]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The run is imp2d 100,000 push-sum on scatter delivery through run()
(kernel A, csrc/scatter.cu: about 19 chunks in about 7 ms of device time,
chip_smoke.py phase 14g's shortest run). Each repetition traces it once
in every mode, in turn:

- ``sync``: run(), torch.cuda.synchronize(), then the profiler stops;
- ``settle``: the same with SETTLE_S of sleep after the synchronize, so the
  device has been idle that long when the profiler stops;
- ``lead``: the same as ``sync`` with LEAD_S of sleep between the
  profiler's start and run();
- ``nosync``: the profiler stops as soon as run() returns, with the last
  chunks possibly still on the device, and the synchronize comes after.

With ``--load`` a spawned process keeps the host's cores busy with float32
matrix products on the CPU all the while, as chip_smoke.py's worker does
with its CPU runs while the card runs phase 14g.

For each trace it records the ``pushsum_rounds`` kernels in the trace,
the launches the wrapper counted in the same run, and, where the trace
holds fewer (k of m), which end of the run it lacks: its kernels'
durations in order of start are held against the first and the last k of
a whole trace's (the chunks differ in rounds: the last ones stop at done
or run none), and the closer end is the one kept. Prints one JSON line a
mode (traces; "k/m" and how many traces showed it; for the short ones,
how many kept the head and lacked the tail, and the reverse; when the
first round kernel of the trace starts, µs after the trace's start: the
whole traces' quantiles 0, 0.01, 0.5, 0.99 and 1, the short traces' each),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

SETTLE_S = 0.05
LEAD_S = 0.2
KIND, N, ALGORITHM = "imp2d", 100_000, "push-sum"


def traced(run_once, mode):
    """(the durations of the round kernels in the trace, in order of
    start; the launches counted; the first kernel's start, µs from the
    trace's start) of one run traced in ``mode``."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    torch.cuda.synchronize()
    scatter.pushsum_scatter_chunk.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            if mode == "lead":
                time.sleep(LEAD_S)
            run_once()
            if mode != "nosync":
                torch.cuda.synchronize()
            if mode == "settle":
                time.sleep(SETTLE_S)
    torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end - ev.time_range.start)
                   for ev in prof.events() if "pushsum_rounds" in ev.name)
    first = spans[0][0] if spans else None
    return [d for _, d in spans], scatter.pushsum_scatter_chunk.launches, first


def cpu_load(stop):
    """Matrix products on the CPU, on every core torch takes, until
    ``stop`` is set."""
    import torch

    a = torch.randn(1024, 1024)
    while not stop.is_set():
        a = torch.tanh(a @ a)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--load", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run

    topo = build_topology(KIND, N)
    cfg = SimConfig(n=N, topology=KIND, algorithm=ALGORITHM)

    def run_once():
        return run(topo, cfg)

    res = run_once()  # builds kernel A and warms the run
    print(json.dumps({"run": f"{KIND} {N} {ALGORITHM}", "rounds": res.rounds,
                      "run_s": res.run_s, "load": args.load}), flush=True)
    loader = None
    if args.load:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        stop = ctx.Event()
        loader = ctx.Process(target=cpu_load, args=(stop,))
        loader.start()
        time.sleep(5.0)  # the loader's torch import
    try:
        stats = trace_all(run_once, args.reps)
    finally:
        if loader is not None:
            stop.set()
            loader.join()
    for mode, st in stats.items():
        print(json.dumps(dict(mode=mode, settle_s=SETTLE_S if mode == "settle" else 0,
                              lead_s=LEAD_S if mode == "lead" else 0, **st)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


def trace_all(run_once, reps):
    """{mode: its traces' counts} over ``reps`` repetitions of every mode."""
    modes = ("sync", "settle", "lead", "nosync")
    stats = {m: {"traces": 0, "counts": {}, "lacks_tail": 0, "lacks_head": 0,
                 "first_us_whole": [], "first_us_short": []} for m in modes}
    whole = None  # the durations of a trace that held every launch
    short = []
    for _ in range(reps):
        for mode in modes:
            durs, launches, first = traced(run_once, mode)
            st = stats[mode]
            st["traces"] += 1
            if first is not None:
                st["first_us_whole" if len(durs) == launches else "first_us_short"].append(
                    first)
            key = f"{len(durs)}/{launches}"
            st["counts"][key] = st["counts"].get(key, 0) + 1
            if len(durs) == launches and whole is None:
                whole = durs
            elif len(durs) < launches:
                short.append((mode, durs))
    for mode, durs in short:
        if whole is None or not durs:
            continue
        k = len(durs)

        def miss(ref):
            return sum(abs(a - b) / max(b, 1.0) for a, b in zip(durs, ref))
        end = "lacks_tail" if miss(whole[:k]) <= miss(whole[-k:]) else "lacks_head"
        stats[mode][end] += 1
    for st in stats.values():
        # The whole traces' first starts by their quantiles; the short ones'
        # each.
        whole_first = sorted(st.pop("first_us_whole"))
        st["first_us_whole_q"] = [whole_first[int(q * (len(whole_first) - 1))]
                                  for q in (0.0, 0.01, 0.5, 0.99, 1.0)] if whole_first else []
    return stats


if __name__ == "__main__":
    sys.exit(main())
