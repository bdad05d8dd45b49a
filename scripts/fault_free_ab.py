#!/usr/bin/env python3
"""Fault-free rows 1-21 (csrc/fused_pool.cu, csrc/fused_pool2.cu,
csrc/fused_resident.cu, csrc/fused_stencil.cu, csrc/fused_imp.cu,
csrc/fused_stencil_shard.cu, csrc/fused_stencil_hbm_shard.cu,
csrc/fused_imp_hbm_shard.cu, csrc/fused_pool2_shard.cu) and kernel A
(csrc/scatter.cu) of several checkouts, timed on one card in one call.

    python3 scripts/fault_free_ab.py [--late-rows | --rows GROUPS] PARENT CHANGE CHANGE PARENT

Each ROOT (a checkout's root, e.g. one unpacked with ``git archive``) runs
in a process of its own, in the order given, with that checkout's port and
its chip_smoke.py helpers: the push-sum and gossip pool chunks at full
1,000,000 (pool_size 2) over 32 rounds from chip_smoke's mid-run state,
kernel A's push-sum and gossip rounds at 1M full over chip_smoke's timed
chunk from its mid-run state, the streaming pool chunks (rows 3-4) at full
2**24 and the resident lattice chunks at chip_smoke's timed shapes (rows
5-6: grid2d 10,000 push-sum, line 1000 gossip; row 7: torus3d 1M
push-sum) over 32 rounds from chip_smoke's mid-run states, rows 9-14
(torus3d 256**3, imp3d 1M and 2**24) over 32 rounds from the initial
state, and one round of every shard of rows 18-21 (imp3d 256**3 and full
2**24, 4 shards on the card) from the initial state, by CUDA events
(median of 5; the wrapper's host work included), and the round kernel's
own device time by torch.profiler (µs a call, a round for kernel A and
rows 9-14 and 18-21; the host left out). The kernels are built from each
checkout's own sources into its own build/, and each root also prints the
registers and spills ptxas gave the round kernels of rows 1-14, 18-21 and
A. ``--late-rows`` times rows 9-14 and 18-21 alone. ``--rows GROUPS``
times the comma-separated groups named: ``early`` (rows 1-7 and kernel A),
``late`` (rows 9-14, 18-21) and ``shard`` (rows 15-16: one super-step of
every shard, torus3d 100**3 in 2 shards on the resident tier and 256**3 in
4 on the streaming tier, every shard on the card, from chip_smoke's
mid-run state, as its phases 14a-14b queue them) and ``chunked`` (phase
14g's chunked-engine runs through run(), engine="chunked": line 1000
gossip and full 1000 push-sum on pool delivery, torch ops a round and no
kernel of csrc/; ms is run_s, the median of 5 runs after a warm-up run,
and kernel_us the device time of every kernel of one run); the default is
early and late. Prints one JSON line a root, then the card's name and power limit,
then each row's times in every later root over the first root's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str, groups=("early", "late")) -> dict:
    """The fault-free rows' times of the checkout at ``root``, by group:
    rows 1-7 and kernel A (early), rows 9-14 and 18-21 (late), rows 15-16
    (shard)."""
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
    if "shard" in groups:
        # Rows 15-16: one super-step of every shard from the mid-run state.
        for tier, stem in (("fused_sharded", "pushsum_shard_rounds"),
                           ("stencil_hbm_sharded", "pushsum_shard_round")):
            kind, n, shards = cs.STENCIL_SHARD_TIMED[tier]
            fn, kw, plan, _, mid, _ = cs.stencil_shard_case(
                dev, key, build_topology(kind, n), kind, n, shards, "push-sum", tier)
            rounds = min(plan.geom.cr, cs.STENCIL_SHARD_ROUNDS)
            bufs = cs.shard_buffers(mid, plan.geom, shards)
            keys = fused.round_keys(key, cs.STENCIL_SHARD_MID["pushsum"], rounds).to(dev)

            def step(fn=fn, kw=kw, plan=plan, bufs=bufs, keys=keys, rounds=rounds):
                cs.lattice_shard_step(fn, kw, plan, bufs, keys, rounds)

            ms, _ = cs.time_ms(step, cs.TIME_REPS)
            out[f"pushsum_{tier}_superstep"] = {"ms": ms, "rounds": rounds,
                                                "kernel_us": device_us(step, stem)}
            del bufs, mid
            torch.cuda.empty_cache()
    if "chunked" in groups:
        from cop5615_gossip_protocol_tpu_torch import run

        for kind, algorithm, kw in (("line", "gossip", {}),
                                    ("full", "push-sum", {"delivery": "pool",
                                                          "pool_size": cs.POOL})):
            topo = build_topology(kind, 1000)
            cfg = SimConfig(n=1000, topology=kind, algorithm=algorithm, engine="chunked", **kw)
            run(topo, cfg)
            run_s = sorted(run(topo, cfg).run_s for _ in range(5))
            stack, prof = cs.cuda_profile()
            with stack:
                res = run(topo, cfg)
                torch.cuda.synchronize()
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            out[f"chunked_{kind}_{name}"] = {
                "ms": run_s[2] * 1e3, "rounds": res.rounds,
                "kernel_us": sum(us for _, (_, us) in cs.device_kernels(prof).items())}
    if "early" in groups:
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
    # Rows 9-14 through the run's fused engine, fault-free, at chip_smoke's
    # timed shapes (torus3d 256**3, imp3d 1M and 2**24, pool_size 4), over
    # 32 rounds from the initial state.
    late = () if "late" not in groups else (
            ("pushsum_stencil_hbm_chunk", "torus3d", 2**24, "stencil_hbm", "pushsum_round"),
            ("gossip_stencil_hbm_chunk", "torus3d", 2**24, "stencil_hbm", "gossip_round"),
            ("pushsum_imp_chunk", "imp3d", 1_000_000, "imp", "pushsum_round"),
            ("gossip_imp_chunk", "imp3d", 1_000_000, "imp", "gossip_round"),
            ("pushsum_imp_hbm_chunk", "imp3d", 2**24, "imp_hbm", "pushsum_round"),
            ("gossip_imp_hbm_chunk", "imp3d", 2**24, "imp_hbm", "gossip_round"))
    for row, kind, n, tier, stem in late:
        algorithm = "push-sum" if row.startswith("pushsum") else "gossip"
        extra = {"delivery": "pool", "pool_size": cs.IMP_POOL} if tier.startswith("imp") else {}
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **extra)
        eng = fused_engine(build_topology(kind, n), cfg, key, tier)
        init = tuple(p.contiguous().to(dev) for p in eng.planes)
        streams = eng.streams(0, cs.CHUNK)

        def call(eng=eng, init=init, streams=streams):
            return eng.chunk(init, streams, 0, cs.CHUNK)

        ms, (_, ex) = cs.time_ms(call, cs.TIME_REPS)
        out[row] = {"ms": ms, "rounds": int(ex),
                    "kernel_us": device_us(call, stem) / max(int(ex), 1)}
        del eng, init
        torch.cuda.empty_cache()
    # Rows 18-21: one round of every shard, every shard on the card, from
    # the initial state (imp3d 256**3 and full 2**24, 4 shards each), as
    # chip_smoke's helpers queue them.
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    kind, n, shards = cs.IMP_SHARD_TIMED
    for algorithm in ("push-sum", "gossip") if "late" in groups else ():
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        pushsum = algorithm == "push-sum"
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                        pool_size=cs.IMP_POOL, engine="fused", n_devices=shards)
        topo = build_topology(kind, n)
        _, rows_loc, _, layout = ih.plan_imp_hbm_sharded(topo, cfg, shards)
        kw = ih.absorb_kw(topo, cfg)
        single = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                           pool_size=cs.IMP_POOL)
        init = tuple(p.contiguous().to(dev) for p in
                     fused_engine(topo, single, key, "imp_hbm").planes)
        stream, nxt = cs.imp_shard_streams(key, 0, cs.IMP_POOL, topo.n)
        bufs = cs.imp_shard_buffers(init, rows_loc, shards, pushsum)
        ih.mark_shards(bufs, stream[0], stream[2], rows_loc, pushsum=pushsum,
                       spec=kw["spec"], pool_size=cs.IMP_POOL)

        def shard_round(bufs=bufs, stream=stream, nxt=nxt, pushsum=pushsum, kw=kw):
            ih.launch_shard_rounds(bufs, stream, nxt, pushsum=pushsum, kw=kw)

        ms, _ = cs.time_ms(shard_round, cs.TIME_REPS)
        out[f"{name}_imp_hbm_shard_round"] = {
            "ms": ms, "rounds": 1,
            "kernel_us": device_us(shard_round, f"{name}_imp_shard_absorb")}
        del bufs, init
        torch.cuda.empty_cache()
    n, shards = cs.SHARD_TIMED
    for algorithm in ("push-sum", "gossip") if "late" in groups else ():
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        kern, _, kw, _, layout, _, _ = cs.shard_case(dev, key, n, shards, algorithm)
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=cs.POOL)
        eng = fused_engine(build_topology("full", n), cfg, key, "pool2")
        state = cs.shard_planes(tuple(p.contiguous().to(dev) for p in eng.planes),
                                algorithm)
        streams = cs.shard_streams(key, 0, cs.CHUNK, n, dev)
        sets = [tuple(x.clone() for x in state), tuple(torch.empty_like(x) for x in state)]
        ctl = {"u": None, "acc": torch.zeros(2, dtype=torch.int32, device=dev),
               "ctrl": torch.zeros(2, dtype=torch.int32, device=dev), "target": n + 1}
        R = layout.rows

        def rounds(kern=kern, algorithm=algorithm, kw=kw, sets=sets, streams=streams,
                   ctl=ctl, R=R):
            for i in range(cs.CHUNK):
                cs.shard_launch(kern, algorithm, kw, sets[i % 2], sets[1 - i % 2], streams,
                                i, 0, R, **ctl)

        ms, _ = cs.time_ms(rounds, cs.TIME_REPS)
        out[f"{name}_pool2_shard_round"] = {
            "ms": ms / cs.CHUNK, "rounds": 1,
            "kernel_us": device_us(rounds, f"{name}_pool2_shard_round") / cs.CHUNK}
        del eng, state, sets
        torch.cuda.empty_cache()
    # The round kernels' registers and spills, from each library's build log.
    ptxas = {}
    for source in ("fused_pool", "fused_pool2", "fused_resident", "scatter", "fused_stencil",
                   "fused_imp", "fused_stencil_shard", "fused_stencil_hbm_shard",
                   "fused_imp_hbm_shard", "fused_pool2_shard"):
        log = kernels.library_path(source).with_suffix(".log")
        entry = None
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = line.split(chr(39))[1]
            elif entry and ("round" in entry or "absorb" in entry) and (
                    "registers" in line or "spill" in line):
                ptxas.setdefault(f"{source}:{entry}", []).append(line.strip())
    out["ptxas"] = ptxas
    return out


def main() -> int:
    args = sys.argv[1:]
    groups = ["early", "late"]
    if args[:1] == ["--late-rows"]:
        groups, args = ["late"], args[1:]
    elif args[:1] == ["--rows"]:
        groups, args = args[1].split(","), args[2:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(one(args[1], groups)), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--rows", ",".join(groups), "--one", root],
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
