#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failed check exits
non-zero before the last line:

1. environment: python, torch and CUDA versions, the card's name and power
   limit (nvidia-smi);
2. build every CUDA source of the port with nvcc, all started together;
3. each kernel on one chunk of 32 rounds at n = 1,000,000, from the initial
   state and from a mid-run state, held against its plain torch version on
   the card (gossip bitwise; push-sum term/conv equal and s/w within 2 ulp),
   plus a chunk that starts converged (0 rounds, state unchanged);
4. the main path through ``run()``: 1M push-sum and 1M gossip on full with
   pool_size 2, launch counters zeroed before each run and read after it;
   each must converge, push-sum to a small estimate error, and each
   kernel's counter must have risen. A 1000-node run on the card must
   match the CPU's chunked engine (rounds, converged count, estimate);
5. each kernel's time per chunk by CUDA events, beside its plain version's
   and the least time the card could take for the same work.

Prints the ``kernels`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import statistics
import subprocess
import sys
import time

N = 1_000_000
POOL = 2
CHUNK = 32
TIME_REPS = 5
# Rounds run before the mid-run comparisons and timings: push-sum converges
# near round 950 at 1M, gossip near round 45.
MID_ROUNDS = {"pushsum": 300, "gossip": 8}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): HBM
# bandwidth, and the float32 rate outside the tensor cores. No integer rate
# is used: the integer hash is counted against the float32 rate too, which
# can only lower the bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Operations per packed Threefry word, from csrc/threefry.cuh: 20 rounds of
# (add, rotate, xor), 17 key-schedule adds, 2 key xors, and 8 slot
# extractions of (shift, and).
OPS_PER_WORD = 20 * 3 + 17 + 2 + 8 * 2


def ops_per_node(algorithm: str, pool: int) -> int:
    """Per-node, per-round operations of csrc/fused_pool.cu beside the
    hash: per slot a source index (compare, subtract, add), a choice
    compare and the adds; then the send and absorb arithmetic."""
    if algorithm == "push-sum":
        # send: 2 multiplies; slot: 3 index + 1 compare + 2 adds;
        # absorb: 2 subtracts, 2 adds, 2 divides, subtract, abs, compare,
        # received compare, term select and add, conv compare and or.
        return 2 + 6 * pool + 14
    # send mask: 2 compares; slot: 3 index + 1 compare + 1 add;
    # absorb: suppress compare, add, 2 compares, or, target compare.
    return 2 + 5 * pool + 6


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: chip_smoke.py needs one GPU")
    try:
        from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
        from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
        from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
        from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
        from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng
        from cop5615_gossip_protocol_tpu_torch.utils import kernels
    except ImportError as e:
        return fail(f"the port is not importable ({e}); run from a checkout's root")

    dev = torch.device("cuda", 0)
    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"card: {smi}")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = dict(zip(kernels.SOURCES, pool.map(kernels.build, kernels.SOURCES)))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {list(builds)}")
    for name, (lib, seconds) in builds.items():
        print(f"  {name}: nvcc {seconds:.2f} s -> {lib.name}")
        log = lib.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # ---------------------------------------------------------------- 3
    topo = build_topology("full", N)
    layout = fused_pool.build_pool_layout(N)
    key = rng.PRNGKey(0)
    target = N

    @functools.lru_cache(maxsize=None)
    def streams(start, count):
        # Cached, so the timed calls below time the wrappers (the streams'
        # copy to the card included), not the host drawing the keys.
        return (fused.round_keys(key, start, count),
                fused_pool.round_offsets(key, start, count, POOL, N))

    ps_cfg = SimConfig(n=N, algorithm="push-sum", delivery="pool", pool_size=POOL)
    go_cfg = SimConfig(n=N, algorithm="gossip", delivery="pool", pool_size=POOL)
    ps0 = pushsum_mod.init_state(N, ps_cfg.initial_term_round)
    ps_init = tuple(fused._pad2d(x, layout, f).contiguous().to(dev) for x, f in (
        (ps0.s, 0.0), (ps0.w, 1.0), (ps0.term, 0), (ps0.conv.to(torch.int32), 0)))
    go0 = gossip_mod.init_state(N, draw_leader(key, topo, go_cfg), False)
    go_init = tuple(fused._pad2d(x.to(torch.int32), layout, 0).contiguous().to(dev)
                    for x in go0)

    def ps_chunk(fn, state, start, count, cap=None):
        keys, offs = streams(start, count)
        return fn(state, keys, offs, start, start + count if cap is None else cap,
                  n=N, target=target, delta=ps_cfg.resolved_delta,
                  term_rounds=ps_cfg.term_rounds)

    def go_chunk(fn, state, start, count, cap=None):
        keys, offs = streams(start, count)
        return fn(state, keys, offs, start, start + count if cap is None else cap,
                  n=N, target=target, rumor_target=go_cfg.resolved_rumor_target,
                  suppress=go_cfg.resolved_suppress)

    def compare(name, got, want, float_planes):
        (g_state, g_ex), (w_state, w_ex) = got, want
        if int(g_ex) != int(w_ex):
            raise AssertionError(f"{name}: rounds {int(g_ex)} != plain {int(w_ex)}")
        err = 0.0
        for i, (g, w) in enumerate(zip(g_state, w_state)):
            if i < float_planes:
                ulp = (g.view(torch.int32).to(torch.int64)
                       - w.view(torch.int32).to(torch.int64)).abs().max().item()
                if ulp > 2 or not torch.isfinite(g).all():
                    raise AssertionError(f"{name}: plane {i} off by {ulp} ulp")
                err = max(err, (g - w).abs().max().item())
            elif not torch.equal(g, w):
                raise AssertionError(f"{name}: plane {i} differs from plain")
        print(f"  {name}: rounds {int(g_ex)}, max_abs_err {err}")
        return err

    kernel_fns = {
        "pushsum": (fused_pool.pushsum_pool_chunk, fused_pool.pushsum_pool_chunk_plain,
                    ps_chunk, ps_init, 2, MID_ROUNDS["pushsum"]),
        "gossip": (fused_pool.gossip_pool_chunk, fused_pool.gossip_pool_chunk_plain,
                   go_chunk, go_init, 0, MID_ROUNDS["gossip"]),
    }
    max_err = {}
    mid_states = {}
    print("kernels vs plain versions at n = 1,000,000:")
    try:
        for name, (kern, plain, chunk, init, nf, mid_round) in kernel_fns.items():
            e1 = compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                         chunk(plain, init, 0, CHUNK), nf)
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"{name}: converged before round {mid_round}")
            mid_states[name] = (mid, mid_round)
            e2 = compare(f"{name} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                         chunk(plain, mid, mid_round, CHUNK), nf)
            e3 = compare(f"{name} cap inside chunk", chunk(kern, mid, mid_round, CHUNK,
                                                           cap=mid_round + 5),
                         chunk(plain, mid, mid_round, CHUNK, cap=mid_round + 5), nf)
            done_state, _ = chunk(kern, init, 0, 4096)
            out, ex = chunk(kern, done_state, 4096, CHUNK)
            if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
                raise AssertionError(f"{name}: a chunk from a converged state ran")
            print(f"  {name} from converged state: 0 rounds, state unchanged")
            max_err[name] = max(e1, e2, e3)
        torch.cuda.synchronize()
    except AssertionError as e:
        return fail(str(e))

    # ---------------------------------------------------------------- 4
    launches = {}
    results = {}
    counters = {"pushsum": fused_pool.pushsum_pool_chunk,
                "gossip": fused_pool.gossip_pool_chunk}
    for name, cfg in (("pushsum", ps_cfg), ("gossip", go_cfg)):
        for fn in counters.values():
            fn.launches = 0
        res = run(topo, cfg)
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        results[name] = res
        print(json.dumps({
            "metric": f"{name}_rounds_per_sec_full_n{N}",
            "rounds": res.rounds, "wall_s": res.run_s,
            "rounds_per_s": res.rounds / res.run_s,
            "compile_s": res.compile_s, "dispatch_s": res.dispatch_s,
            "first_dispatch_s": res.first_dispatch_s, "fetch_s": res.fetch_s,
            "converged_count": res.converged_count,
            "estimate_mae": res.estimate_mae, "launches": launches[name],
            "device": res.device,
        }))
        if not res.converged or res.converged_count != N:
            return fail(f"1M {name} did not converge ({res.outcome})")
        if launches[name][name] == 0:
            return fail(f"the 1M {name} run never launched its kernel")
    # Converged ratios sit at the true mean (n-1)/2 up to float32 rounding:
    # the error relative to the mean must stay near the 1e-7 ulp scale.
    mae = results["pushsum"].estimate_mae
    true_mean = results["pushsum"].true_mean
    if mae is None or not mae / true_mean < 1e-6:
        return fail(f"1M push-sum estimate_mae {mae} is not small "
                    f"against the mean {true_mean}")
    for name, cfg in (("pushsum", ps_cfg), ("gossip", go_cfg)):
        small = SimConfig(n=1000, algorithm=cfg.algorithm, delivery="pool",
                          pool_size=POOL)
        a = run(build_topology("full", 1000), small)
        b = run(build_topology("full", 1000), small, device="cpu")
        if (a.rounds, a.converged_count, a.estimate_mae) != (
                b.rounds, b.converged_count, b.estimate_mae):
            return fail(f"1000-node {name} on the card {a.rounds}/{a.estimate_mae} "
                        f"!= CPU {b.rounds}/{b.estimate_mae}")
        print(f"  1000-node {name}: card == CPU chunked engine "
              f"(rounds {a.rounds}, estimate_mae {a.estimate_mae})")

    # ---------------------------------------------------------------- 5
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), out

    rows = []
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:860",
                "gossip": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:1157"}
    plane_bytes = {"pushsum": 16, "gossip": 12}
    for name, (kern, plain, chunk, init, nf, _) in kernel_fns.items():
        mid, mid_round = mid_states[name]
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(ex)
        algo = "push-sum" if name == "pushsum" else "gossip"
        moved = 2 * plane_bytes[name] * layout.n_pad + CHUNK * (16 + 4 * POOL) + 8
        ops = rounds * (layout.n_pad // 8 * OPS_PER_WORD
                        + layout.n_pad * ops_per_node(algo, POOL))
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{name}_pool_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_pool.cu",
            "replaces": replaces[name],
            "launches": launches[name][name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "status": "ported",
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
