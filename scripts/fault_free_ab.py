#!/usr/bin/env python3
"""Fault-free rows 1-7 (csrc/fused_pool.cu, csrc/fused_pool2.cu,
csrc/fused_resident.cu) and kernel A (csrc/scatter.cu) of several
checkouts, timed on one card in one call.

    python3 scripts/fault_free_ab.py PARENT CHANGE CHANGE PARENT

Each ROOT (a checkout's root, e.g. one unpacked with ``git archive``) runs
in a process of its own, in the order given, with that checkout's port and
its chip_smoke.py helpers: the push-sum and gossip pool chunks at full
1,000,000 (pool_size 2) over 32 rounds from chip_smoke's mid-run state,
kernel A's push-sum and gossip rounds at 1M full over chip_smoke's timed
chunk from its mid-run state, the streaming pool chunks (rows 3-4) at full
2**24 and the resident lattice chunks at chip_smoke's timed shapes (rows
5-6: grid2d 10,000 push-sum, line 1000 gossip; row 7: torus3d 1M
push-sum) over 32 rounds from chip_smoke's mid-run states, by CUDA events
(median of 5; the wrapper's host work included), and the round kernel's
own device time by torch.profiler (µs a call, a round for kernel A; the
host left out). The kernels are built from each checkout's own sources
into its own build/, and each root also prints the registers and spills
ptxas gave the round kernels of rows 1-7 and A. Prints one JSON line a
root, then the card's name and power limit, then each row's times in
every later root over the first root's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> dict:
    """The four fault-free rows' ms of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine
    from cop5615_gossip_protocol_tpu_torch.ops import fused, rng, scatter
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    dev = torch.device("cuda", 0)
    key = rng.PRNGKey(0)
    out = {"root": root}

    def device_us(fn, stem, reps=5):
        """The round kernel's own device time a call (µs, torch.profiler
        over ``reps`` calls): the wrapper's host work left out."""
        stack, prof = cs.cuda_profile()
        with stack:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(us for short, (_, us) in cs.device_kernels(prof).items()
                   if stem in short) / reps
    fns, _ = cs.pool_fns(dev, key, cs.N)
    for name, (kern, _, chunk, init, _, mid_round) in fns.items():
        mid, _ = chunk(kern, init, 0, mid_round)
        ms, (_, ex) = cs.time_ms(lambda: chunk(kern, mid, mid_round, cs.CHUNK),
                                 cs.TIME_REPS)
        out[f"{name}_pool_chunk"] = {
            "ms": ms, "rounds": int(ex),
            "kernel_us": device_us(lambda: chunk(kern, mid, mid_round, cs.CHUNK),
                                   f"{name}_rounds")}
    topo = build_topology("full", cs.N)
    graph = scatter.scatter_graph(topo, dev)

    def round_keys(start, count):
        return fused.round_keys(key, start, count)

    for algorithm in ("push-sum", "gossip"):
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        kern, _, chunk, init = cs.scatter_fns(dev, key, topo, graph, algorithm,
                                              "batched", round_keys)
        mid_round = cs.SCATTER_MID[name]
        mid, _ = chunk(kern, init, 0, mid_round)
        K = cs.SCATTER_TIMED[name]
        ms, (_, st) = cs.time_ms(lambda: chunk(kern, mid, mid_round, K), cs.TIME_REPS)
        rounds = int(st[0]) - mid_round
        out[f"{name}_scatter_round"] = {
            "ms": ms / rounds, "rounds": rounds,
            "kernel_us": device_us(lambda: chunk(kern, mid, mid_round, K),
                                   f"{name}_rounds") / rounds}
    # Rows 3-7 through the run's fused engine (its streams and wrappers),
    # fault-free, at chip_smoke's timed shapes.
    for row, kind, n, tier, mid_round, stem in (
            ("pushsum_pool2_chunk", "full", cs.POOL2_TIMED, "pool2", cs.POOL2_MID["pushsum"],
             "pushsum_pool2_round"),
            ("gossip_pool2_chunk", "full", cs.POOL2_TIMED, "pool2", cs.POOL2_MID["gossip"],
             "gossip_pool2_round"),
            ("pushsum_stencil_chunk", "grid2d", 10_000, "stencil",
             cs.RESIDENT_MID["pushsum"], "pushsum_rounds"),
            ("gossip_stencil_chunk", "line", 1000, "stencil", cs.RESIDENT_MID["gossip"],
             "gossip_rounds"),
            ("pushsum_stencil2_chunk", "torus3d", 1_000_000, "stencil2",
             cs.RESIDENT_MID["pushsum"], "pushsum_rounds")):
        algorithm = "push-sum" if row.startswith("pushsum") else "gossip"
        extra = {"delivery": "pool", "pool_size": cs.POOL} if tier == "pool2" else {}
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **extra)
        eng = fused_engine(build_topology(kind, n), cfg, key, tier)
        init = tuple(p.contiguous().to(dev) for p in eng.planes)
        mid, _ = eng.chunk(init, eng.streams(0, mid_round), 0, mid_round)
        streams = eng.streams(mid_round, cs.CHUNK)

        def call(eng=eng, mid=mid, mid_round=mid_round, streams=streams):
            return eng.chunk(mid, streams, mid_round, mid_round + cs.CHUNK)

        ms, (_, ex) = cs.time_ms(call, cs.TIME_REPS)
        out[row] = {"ms": ms, "rounds": int(ex), "kernel_us": device_us(call, stem)}
        del eng, init, mid
        torch.cuda.empty_cache()
    # The round kernels' registers and spills, from each library's build log.
    ptxas = {}
    for source in ("fused_pool", "fused_pool2", "fused_resident", "scatter"):
        log = kernels.library_path(source).with_suffix(".log")
        entry = None
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = line.split(chr(39))[1]
            elif entry and ("round" in entry) and ("registers" in line or "spill" in line):
                ptxas.setdefault(f"{source}:{entry}", []).append(line.strip())
    out["ptxas"] = ptxas
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    first = results[0]
    rows = [row for row in first if row not in ("root", "ptxas")]
    print(json.dumps({"over_first_root": {
        what: {row: [r[row][what] / first[row][what] for r in results[1:]] for row in rows}
        for what in ("ms", "kernel_us")}, "roots": roots}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
