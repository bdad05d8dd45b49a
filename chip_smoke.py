#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4   # the sharded imp and pool2 paths across 4 cards

Run from the root of a checkout. Phases, in order; any failed check exits
non-zero before the last line:

1. environment: python, torch and CUDA versions, the card's name and power
   limit (nvidia-smi);
2. build every CUDA source of the port with nvcc, all started together,
   and print each kernel's registers and spills (the persistent round
   kernels of csrc/fused_pool.cu and csrc/fused_resident.cu must not
   spill);
3. each pool kernel (one persistent cooperative launch a chunk, one pass
   and one barrier a round, the marks in two planes by round parity) on
   one chunk of 32 rounds at n = 1,000,000, from the initial state and from
   a mid-run state, with a cap inside the chunk after an odd and an even
   number of rounds, a one-round chunk and two zero-round chunks (no keys;
   capped at the start), held against its plain torch version on the card
   (gossip bitwise; push-sum term/conv equal and s/w within 2 ulp), plus a
   chunk that starts converged (0 rounds, state unchanged); and one chunk
   from the initial state at 2,097,152 (2**21, the tier's cap, where the
   planes outgrow the L2);
4. the pool path through ``run()``: 1M push-sum and 1M gossip on full with
   pool_size 2, launch counters zeroed before each run and read after it;
   each must converge, push-sum to a small estimate error, and each
   kernel's counter must read 9 (the warmup chunk and two 4,096-round
   chunks, 3 launches each). A 1000-node run on the card must match the
   CPU's chunked engine (rounds, converged count, estimate);
5. each stencil kernel against its plain version on the card, the same
   way: torus3d at 16,777,216 (256**3) from the initial state, from a
   mid-run state, with a cap inside the chunk and from a converged state;
   push-sum at the main path's torus3d 215**3 (pad lanes in the layout)
   from the initial and a mid-run state; on grid2d 4096**2, grid3d 256**3,
   line and ring at 16,777,216 and ref2d 4096**2 in reference semantics
   (the extra node), one chunk from the initial state and, for gossip, one
   from a spread state (a seeded half of the nodes holding the rumor, some
   converged), so every boundary face sends. The engine ladder must pick
   the streaming stencil tier for each;
6. the lattice path through ``run()``: torus3d 16,777,216 gossip to
   convergence, and torus3d 215**3 push-sum for 2,000 rounds with its mass
   conserved, counters zeroed before each run and read after it; then
   torus3d 130**3, both algorithms, 64 rounds on the card against the
   CPU's chunked engine (rounds, converged count, final state);
7. each imp kernel (a mark prologue, then one launch a round that also
   writes the next round's marks) against its plain version on the card,
   pool_size 4, one 32-round chunk at imp3d 16,777,216 (the streaming imp
   tier), imp3d 1,000,000 (the resident tier, 48,576 pad lanes) and imp2d
   100,489 (the BASELINE config, 30,583 pad lanes), from the initial state
   and from a mid-run state, with a cap inside the chunk after an odd and
   an even number of rounds, a one-round chunk, two zero-round chunks (no
   keys; capped at the start) and from a converged state, plus push-sum at
   pool_size 16; every check bitwise, and the ladder must pick the JAX
   ladder's tier for each;
8. the imp path through ``run()``: imp3d 16.8M and 1M, both algorithms,
   and imp2d 100,489 push-sum, each to convergence, counters zeroed before
   each run and read after it (the warmup's chunk and then K + 3 launches
   a chunk of K rounds), push-sum mass conserved; then imp3d 50**3, both
   algorithms, 64 rounds on the card against the CPU's chunked engine
   (rounds, converged count, final state bitwise);
9. each resident lattice kernel (one persistent cooperative launch a
   chunk) against its plain version on the card, one 32-round chunk at
   line 1,000, grid2d 10,000, grid3d 50**3 and ring 131,072 (the
   whole-array tier) and ring 5,000, torus3d 100**3 and grid2d 1000**2 (the
   tiled tier), from the initial state, from a mid-run state, with a cap
   inside the chunk, from a gossip spread state and from a converged
   state; every check bitwise, and the ladder must pick the JAX ladder's
   tier for each;
10. the resident path, counters zeroed before each run and read after it:
   the CLI's ``1000 line gossip`` (the reference's own command line) and
   the same run on the card against the CPU's chunked engine; grid2d
   10,000 push-sum (its first 4,096 rounds against the CPU's chunked
   engine, its whole run's rounds and estimate against the JAX package's
   chunked engine), torus3d 100**3 gossip and push-sum, each to
   convergence on the card, push-sum mass conserved, with the JAX
   package's round records printed beside;
11. each streaming pool kernel against its plain version on the card,
   pool_size 2, one 32-round chunk at full 2,097,153 (the tier's first
   population, 65,535 pad lanes), 10,000,000 and 16,777,216, from the
   initial state, from a mid-run state, with a cap inside the chunk and
   from a converged state, plus push-sum at pool_size 16 and one chunk
   from the initial state at 134,217,728 (2**27, the tier's cap); every
   check bitwise, and the ladder must pick the streaming pool tier;
12. the streaming pool path, counters zeroed before each run and read
   after it: full 16,777,216 and 134,217,728, both algorithms, to
   convergence (push-sum to a small estimate error with its mass
   conserved; the JAX package's 2**27 round records printed beside), the
   CLI's ``16777216 full push-sum --delivery pool --pool-size 2``, and
   2,097,153, both algorithms, 64 rounds on the card against the CPU's
   chunked engine (rounds, converged count, final state) and to
   convergence against the JAX chunked engine's rounds and estimate;
13. each shard kernel of the replicated-pool2 composition (every shard on
   the card, so a round is one launch over every row, reading the sources
   in place from the card's global copy of the summary planes) against its
   plain version at full 16,777,216 in 2 shards (the all_gather plan) and
   4 (the reduce_scatter plan) and 16,777,217 in 2 (65,535 pad lanes): one
   launch over every row and one over the last shard's rows alone (its
   count to u, the rows outside untouched) from the initial, a mid-run and
   a converged state, one with the verdict in the launch (ctrl counts the
   round and sets done), one from the converged state with the done flag
   set (nothing written), and 8 launches from 4 rounds before the
   converged round, whose target is reached inside them (ctrl stops
   there); every plane and count bitwise;
14. the sharded path through ``run(devices=["cuda:0"] * S)``, counters
   zeroed before each run and read after it: full 16,777,216 in 2 and 4
   shards and 2**27 in 4, both algorithms, to convergence, each bitwise the
   single-device streaming pool run of phase 12 (rounds, converged count,
   every plane), push-sum mass conserved, with no wire copy and no verdict
   launch queued; at 16,777,216 in 4 one launch a round, at most 352
   (push-sum) and 64 (gossip) on the path, and also gossip with the
   verdict not deferred, push-sum on the all_gather wire, and a resume
   from the converged gossip state (0 rounds, state unchanged);
14a. each shard kernel of the resident sharded lattice composition
   (parallel/fused_sharded.py, every shard on the card) against its plain
   version, one super-step on every shard from the initial state and from
   a mid-run state, at torus3d 100**3 in 2 and 4 shards, grid2d 1000**2 in
   2 (non-wrap, pad lanes) and ring 131,072 in 2, out and y filled with a
   sentinel first for both; every row of every out plane (so also a write
   outside a round's window) and every shard's per-round counts bitwise,
   each case's window sizes printed beside H and CR;
14b. the same for the streaming sharded lattice composition
   (parallel/fused_hbm_sharded.py) at torus3d 256**3 in 2 and 4 shards,
   215**3 in 4 (23,097 pad lanes, across the mod-n blend) and grid2d
   4096**2 in 4;
14c. the sharded lattice path through ``run(devices=["cuda:0"] * S)``,
   counters zeroed before each run and read after it: torus3d 100**3
   gossip and push-sum in 2 and 4 shards to convergence, each at the JAX
   schedule's first super-step boundary at or after phase 10's
   single-device round (push-sum mass conserved), gossip at
   chunk_rounds=1 bitwise phase 10's run, with the verdict not deferred,
   and resumed from its converged state (0 rounds); torus3d 256**3 gossip
   in 4 shards against phase 6's round; torus3d 215**3 push-sum in 4
   shards, 2,000 rounds at chunk_rounds=1 and at the default (CR 32), each
   bitwise phase 6's sample;
14d. each kernel of the sharded imp composition
   (parallel/fused_imp_hbm_sharded.py, every shard on the card: an absorb
   launch a shard a round that also writes the shard's next-round marks,
   after a mark prologue a shard) against its plain version, one round on
   every shard from the initial state, from a mid-run state and from a
   converged state, then the next round from the marks it wrote (a chunk
   boundary: no prologue, the stream drawn one round ahead), at imp3d
   100**3 in 2 shards (48,576 pad lanes), imp2d 4096**2 and imp3d 256**3 in
   4, push-sum also at pool_size 16, and imp3d 520**3 in 4 (past the
   single-device cap) from the initial state; every shard's planes and
   count and the next marks bitwise, and the ladder must pick the sharded
   imp composition for each;
14e. the sharded imp path through ``run(devices=["cuda:0"] * S)``,
   counters zeroed before each run and read after it (S prologue launches
   a run, S absorbs a round): imp3d 256**3 gossip and push-sum in 4 shards
   to convergence, each bitwise phase 8's single-device run (rounds,
   converged count, every plane), gossip also with the verdict not
   deferred and resumed from its converged state (0 rounds); imp3d 50**3
   in 2 shards, both algorithms, 64 rounds on the card against the CPU's
   run of the same shards; imp3d 520**3 in 4 shards, gossip to convergence
   and a 64-round push-sum sample conserving its mass;
14f. kernel A, the scatter round (csrc/scatter.cu, one host call a chunk,
   five launches a push-sum round and two a gossip round), against its
   plain version on the card one round at a time at full 1,000,000 and at
   imp3d 1000 in reference semantics (its Q8 orphan does not send), both
   algorithms, from the initial state, a mid-run state (also a 32-round
   and an 8-round chunk) and a converged state (one real round, and one
   with the done flag set, which changes nothing); every plane and the
   (rounds, done) status bitwise;
14g. the scatter path through ``run()``, counters zeroed before each run
   and read after it, the pipeline's status reads counted (one a chunk):
   ``1000000 full gossip`` and ``100000 imp2D push-sum`` (BASELINE.json),
   each bitwise the port's CPU run of the same config (computed by a
   spawned worker process while the card runs phases 2-14f), and 1M full
   push-sum; each against the JAX chunked engine's rounds and estimate on
   the CPU, push-sum with its mass conserved; run_s, rounds/s, launches
   and status reads a chunk printed; then the chunked engine's torch
   rounds on the card (``engine="chunked"``: 1000 line gossip, 1000 full
   push-sum with pool delivery), each bitwise the CPU's run with one
   status read a chunk;
14h. kernel B, the reference-semantics walk (csrc/walk.cu, one thread, up
   to 2**20 hops a launch), through ``run()`` at full 1000 (60,032 hops)
   and imp3d 1000 (185,604), each bitwise the plain walk on the CPU (every
   plane, the message, hops, the dead latch) and at the JAX package's
   hops, hops/s of both printed;
14i. the CLI triples ``1000 full gossip``, ``1000 imp3D push-sum`` and
   ``1000 full push-sum --semantics reference``, each at the JAX CLI's
   rounds and estimate, with their kernels launched;
15. each kernel's time per chunk by CUDA events, beside its plain version's
   and the least time the card could take for the same work (rows 1-2
   also over a 1,024-round chunk and at 2**21, and over rows 7-8); the
   replicated-pool2 kernels per round (one launch over every shard, 32 in a
   row and one alone) at 16,777,216 in 4, over rows 3-4, with the sharded
   runs' run_s over the single-device ones; the sharded lattice kernels per
   super-step at torus3d 100**3 in 2 (resident) and 256**3 in 4
   (streaming), the ring wire's copies timed apart, their bound counted on
   the windows' slot-rounds (``stencil_shard_bound``); the sharded imp
   kernels per round (every shard's absorb) at imp3d 256**3 in 4, whose
   wire copies nothing on one card (``--cards`` times it); kernel A per
   round at 1M full from the mid-run state (a 32-round push-sum and an
   8-round gossip chunk), beside one ``index_add_`` of a round's sends;
   kernel B over each whole walk in one launch, beside the plain walk on
   the host and the hop chain's bound (hops times one dependent load at
   the walk's working set, timed by csrc/walk.cu's chase kernel); then
   the imp rows' µs a round beside row 9's, and rows 13 and 18 over row 9.

Each of phases 5-14i prints its wall time.

Prints the ``kernels`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

``--cards N`` runs none of these phases: it runs the sharded imp path and
the replicated-pool2 path with shard i on cuda:i against the same runs on
one card, times each wire across cards, and ends with ``{"ok": true,
"mode": "cards N", "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import warnings

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
# Operations per Threefry word, from csrc/threefry.cuh: 20 rounds of (add,
# rotate, xor), 17 key-schedule adds and 2 key xors; a packed pool word adds
# 8 slot extractions of (shift, and).
OPS_PER_HASH = 20 * 3 + 17 + 2
OPS_PER_WORD = OPS_PER_HASH + 8 * 2


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


# The lattice phases: populations, and the rounds run before the mid-run
# comparisons and timings (16.8M torus3d gossip converges near round 570).
LATTICE_N = 2**24
LATTICE_PS_N = 215**3
LATTICE_PS_ROUNDS = 2000
LATTICE_CPU_N = 130**3
LATTICE_CPU_ROUNDS = 64
LATTICE_MID = {"pushsum": 300, "gossip": 200}
LATTICE_KINDS = (("grid2d", LATTICE_N, "batched"), ("grid3d", LATTICE_N, "batched"),
                 ("line", LATTICE_N, "batched"), ("ring", LATTICE_N, "batched"),
                 ("ref2d", LATTICE_N, "reference"))
# Bytes a round must move at this size: the state read and written once
# (push-sum s, w, term, conv; gossip count, active, conv), since 16.8M
# nodes of it are several times the 50 MB L2.
STATE_BYTES = {"pushsum": 32, "gossip": 24}


# Per-node operations of a lattice mark: the hash, the direction pairs
# (three index splits and the face selects, 20), the slot select (a modulo
# and six compare-select-adds, 19), the class lookup (10).
STENCIL_MARK_OPS = OPS_PER_HASH + 20 + 19 + 10


def stencil_absorb_ops(algorithm: str, classes: int) -> int:
    """Per-node operations of a lattice absorb: per class a source index
    (compare, subtract, add), the mark compare and the adds (push-sum also
    the two halvings); then the own halving and the absorb."""
    per_class = 8 if algorithm == "push-sum" else 5
    absorb = 16 if algorithm == "push-sum" else 6
    return per_class * classes + absorb


def stencil_ops_per_node(algorithm: str, classes: int) -> int:
    """Per-node, per-round operations of csrc/fused_stencil.cu: a mark and
    an absorb."""
    return STENCIL_MARK_OPS + stencil_absorb_ops(algorithm, classes)


def stencil_shard_bound(kw, plan, shards, rounds, algorithm, classes, resident):
    """(bytes, operations) a super-step of every shard needs: per shard the
    window slot-rounds of csrc/shard.cuh's contract, computed from the plan
    and the rolls, whatever computes them. A mark for each slot of W_{j-1}
    and an absorb for each slot of W_j in every round j; the state (with
    the keys and u) moved once a super-step where a shard's planes stay in
    the L2 (the resident tier: each slot of W_-1 read and its result
    written once), else once a round over W_j (the streaming tier)."""
    geom = plan.geom
    state = STATE_BYTES["pushsum" if algorithm == "push-sum" else "gossip"]
    moved = 16 * rounds + 4 * shards * (geom.cr + 1)
    ops = 0
    for s in range(shards):
        rows = window_rows(kw, geom, s, rounds)
        marks, absorbs = 128 * sum(rows[:-1]), 128 * sum(rows[1:])
        ops += marks * STENCIL_MARK_OPS + absorbs * stencil_absorb_ops(algorithm, classes)
        moved += state * 128 * (rows[0] if resident else sum(rows[1:]))
    return moved, ops


# Rounds of the main-path run whose launches each row of the kernels line
# counts, by row name.
MAIN_ROUNDS = {}


def compare(name, got, want, float_planes):
    """Hold a kernel chunk's (state, executed) against its plain version's:
    the rounds equal, the first ``float_planes`` planes within 2 ulp and
    finite, every other plane bit for bit. Returns the largest absolute
    difference."""
    import torch

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
        elif g.dtype != w.dtype or not torch.equal(
                g.view(torch.int32) if g.dtype == torch.float32 else g,
                w.view(torch.int32) if w.dtype == torch.float32 else w):
            raise AssertionError(f"{name}: plane {i} differs from plain")
    print(f"  {name}: rounds {int(g_ex)}, max_abs_err {err}", flush=True)
    return err


def time_ms(fn, reps):
    """Median milliseconds of ``fn()`` by CUDA events, after one warm call;
    returns (ms, the last call's result)."""
    import torch

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


def spread_state(init, n, rumor_target):
    """Gossip planes (count, active, conv) as a run holds them midway, made
    from seed 0 on the card: a random half of the nodes hold the rumor with
    counts up to the target, those at the target converged; pad lanes 0."""
    import torch

    dev, shape = init[0].device, init[0].shape
    gen = torch.Generator(device=dev).manual_seed(0)
    real = torch.arange(init[0].numel(), device=dev).reshape(shape) < n
    active = (torch.rand(shape, generator=gen, device=dev) < 0.5) & real
    count = torch.randint(0, rumor_target + 1, shape, generator=gen, device=dev,
                          dtype=torch.int32) * active
    return (count.to(torch.int32), active.to(torch.int32),
            (count >= rumor_target).to(torch.int32))


def parity_checks(name, kern, plain, chunk, mid, mid_round, float_planes):
    """The checks that the mark planes' round parity needs, kernel against
    plain from the mid-run state: a cap inside the chunk after an odd and
    after an even number of rounds, and a one-round chunk. Returns their
    max_abs_err."""
    return [compare(f"{name} cap inside chunk, {extra} rounds",
                    chunk(kern, mid, mid_round, CHUNK, cap=mid_round + extra),
                    chunk(plain, mid, mid_round, CHUNK, cap=mid_round + extra),
                    float_planes)
            for extra in (5, 6)] + [
        compare(f"{name} one-round chunk", chunk(kern, mid, mid_round, 1),
                chunk(plain, mid, mid_round, 1), float_planes)]


def zero_round_checks(name, kern, plain, chunk, state, start):
    """A chunk of no rounds, kernel against plain from ``state``: one with
    no keys and one capped at its start (keys, but no round to run); each
    must leave the state unchanged. Returns their max_abs_err."""
    import torch

    errs = []
    for label, count, cap in (("no keys", 0, None), ("capped at its start", CHUNK, start)):
        got = chunk(kern, state, start, count, cap=cap)
        errs.append(compare(f"{name} zero-round chunk ({label})", got,
                            chunk(plain, state, start, count, cap=cap), 0))
        if int(got[1]) != 0 or not all(torch.equal(a, b) for a, b in zip(got[0], state)):
            raise AssertionError(f"{name}: a zero-round chunk changed the state")
    return errs


# The pool tier's cap (ops/fused_pool.MAX_POOL_NODES): one kernel check and
# one timed chunk there, where push-sum's planes (52 MiB) outgrow the L2.
POOL_CAP_N = 2**21


def pool_fns(dev, key, n):
    """The pool kernels (rows 1-2) at population n on full, pool_size POOL:
    ({name: (kernel, plain, chunk, initial state, float planes, mid-run
    round)}, (push-sum cfg, gossip cfg)), where chunk(fn, state, start,
    count, cap=None) runs one chunk through fn on the run's streams."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool

    topo = build_topology("full", n)
    layout = fused_pool.build_pool_layout(n)

    @functools.lru_cache(maxsize=None)
    def streams(start, count):
        # Cached, so the timed calls time the wrappers (the streams' copy to
        # the card included), not the host drawing the keys.
        return (fused.round_keys(key, start, count),
                fused_pool.round_offsets(key, start, count, POOL, n))

    ps_cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", pool_size=POOL)
    go_cfg = SimConfig(n=n, algorithm="gossip", delivery="pool", pool_size=POOL)
    ps0 = pushsum_mod.init_state(n, ps_cfg.initial_term_round)
    ps_init = tuple(fused._pad2d(x, layout, f).contiguous().to(dev) for x, f in (
        (ps0.s, 0.0), (ps0.w, 1.0), (ps0.term, 0), (ps0.conv.to(torch.int32), 0)))
    go0 = gossip_mod.init_state(n, draw_leader(key, topo, go_cfg), False)
    go_init = tuple(fused._pad2d(x.to(torch.int32), layout, 0).contiguous().to(dev)
                    for x in go0)

    def ps_chunk(fn, state, start, count, cap=None):
        keys, offs = streams(start, count)
        return fn(state, keys, offs, start, start + count if cap is None else cap,
                  n=n, target=n, delta=ps_cfg.resolved_delta,
                  term_rounds=ps_cfg.term_rounds)

    def go_chunk(fn, state, start, count, cap=None):
        keys, offs = streams(start, count)
        return fn(state, keys, offs, start, start + count if cap is None else cap,
                  n=n, target=n, rumor_target=go_cfg.resolved_rumor_target,
                  suppress=go_cfg.resolved_suppress)

    return {
        "pushsum": (fused_pool.pushsum_pool_chunk, fused_pool.pushsum_pool_chunk_plain,
                    ps_chunk, ps_init, 2, MID_ROUNDS["pushsum"]),
        "gossip": (fused_pool.gossip_pool_chunk, fused_pool.gossip_pool_chunk_plain,
                   go_chunk, go_init, 0, MID_ROUNDS["gossip"]),
    }, (ps_cfg, go_cfg)


def lattice_checks(dev, key):
    """Phase 5: each stencil kernel against its plain version on the card:
    at torus3d 16.8M from the initial and a mid-run state, with a cap inside
    the chunk after an odd and an even number of rounds, a one-round chunk
    and from a converged state; at 215**3 and on the other kinds from the
    initial state (gossip also from a spread state). Returns {name: case}
    for the timing phase (the torus3d chunk function, its mid-run state and
    layout) and {name: max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    keys = functools.lru_cache(maxsize=None)(
        lambda start, count: fused.round_keys(key, start, count))

    def case(topo, kind, n, semantics, name):
        """(kernel, plain, chunk(fn, state, start, count, cap), init planes
        on the card, float planes, layout) for one lattice and algorithm."""
        algorithm = "push-sum" if name == "pushsum" else "gossip"
        # Reference push-sum is the single walk (not ported); the kernel
        # still runs push-sum on the reference topology.
        sem = "batched" if algorithm == "push-sum" else semantics
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=sem)
        tier = fused_tier(topo, cfg)
        if tier != ("stencil_hbm", None):
            raise AssertionError(f"{kind} n={n} {algorithm}: the ladder picks {tier}")
        common = {"spec": hbm.stencil_spec(topo),
                  "target": cfg.resolved_target_count(topo.n, topo.target_count)}
        if algorithm == "push-sum":
            fns = (hbm.pushsum_stencil_hbm_chunk, hbm.pushsum_stencil_hbm_chunk_plain)
            common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
        else:
            fns = (hbm.gossip_stencil_hbm_chunk, hbm.gossip_stencil_hbm_chunk_plain)
            common.update(rumor_target=cfg.resolved_rumor_target,
                          suppress=cfg.resolved_suppress)

        def chunk(fn, state, start, count, cap=None):
            return fn(state, keys(start, count), start,
                      start + count if cap is None else cap, **common)

        eng = fused_engine(topo, cfg, key, "stencil_hbm")
        init = tuple(p.contiguous().to(dev) for p in eng.planes)
        return (*fns, chunk, init, 2 if name == "pushsum" else 0, eng.layout)

    cases, max_err = {}, {}
    t0 = time.perf_counter()
    topo = build_topology("torus3d", LATTICE_N)
    print(f"stencil kernels vs plain versions at torus3d n = {LATTICE_N:,} "
          f"(built in {time.perf_counter() - t0:.2f} s):", flush=True)
    for name in ("pushsum", "gossip"):
        kern, plain, chunk, init, nf, layout = case(topo, "torus3d", LATTICE_N,
                                                    "batched", name)
        mid_round = LATTICE_MID[name]
        e1 = compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                     chunk(plain, init, 0, CHUNK), nf)
        mid, ex = chunk(kern, init, 0, mid_round)
        if int(ex) != mid_round:
            raise AssertionError(f"{name}: converged before round {mid_round}")
        e2 = compare(f"{name} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                     chunk(plain, mid, mid_round, CHUNK), nf)
        e3 = max(parity_checks(name, kern, plain, chunk, mid, mid_round, nf))
        if name == "gossip":
            done_state, ex = chunk(kern, mid, mid_round, 4096)
            done_round = mid_round + int(ex)
            if int(ex) == 4096:
                raise AssertionError("16.8M torus3d gossip did not converge")
        else:
            # Push-sum on the torus takes far longer to converge: latch
            # every node's conv flag instead.
            real = torch.arange(layout.n_pad, device=dev).reshape(mid[3].shape) < LATTICE_N
            done_state = (*mid[:3], real.to(torch.int32))
            done_round = mid_round
        out, ex = chunk(kern, done_state, done_round, CHUNK)
        if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
            raise AssertionError(f"{name}: a chunk from a converged state ran")
        print(f"  {name} from converged state (round {done_round}): 0 rounds, "
              "state unchanged", flush=True)
        max_err[name] = max(e1, e2, e3)
        cases[name] = (kern, plain, chunk, mid, mid_round, layout,
                       len(topo.offsets))
    del topo
    # The main path's push-sum population: 547,385 pad lanes past n.
    t0 = time.perf_counter()
    topo = build_topology("torus3d", LATTICE_PS_N)
    kern, plain, chunk, init, nf, _ = case(topo, "torus3d", LATTICE_PS_N, "batched",
                                           "pushsum")
    label = f"torus3d n={topo.n} (built in {time.perf_counter() - t0:.2f} s) pushsum"
    e1 = compare(f"{label} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                 chunk(plain, init, 0, CHUNK), nf)
    mid_round = LATTICE_MID["pushsum"]
    mid, ex = chunk(kern, init, 0, mid_round)
    if int(ex) != mid_round:
        raise AssertionError(f"215**3 push-sum: converged before round {mid_round}")
    e2 = compare(f"{label} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                 chunk(plain, mid, mid_round, CHUNK), nf)
    max_err["pushsum"] = max(max_err["pushsum"], e1, e2)
    del topo, init, mid
    for kind, n, semantics in LATTICE_KINDS:
        t0 = time.perf_counter()
        topo = build_topology(kind, n, semantics=semantics)
        label = f"{kind} {semantics} n={topo.n} (built in {time.perf_counter() - t0:.2f} s)"
        for name in ("pushsum", "gossip"):
            kern, plain, chunk, init, nf, _ = case(topo, kind, n, semantics, name)
            err = compare(f"{label} {name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                          chunk(plain, init, 0, CHUNK), nf)
            if name == "gossip":
                rumor_target = SimConfig(n=n, topology=kind, algorithm="gossip",
                                         semantics=semantics).resolved_rumor_target
                spread = spread_state(init, topo.n, rumor_target)
                mid_round = LATTICE_MID["gossip"]
                err = max(err, compare(
                    f"{label} gossip spread state K={CHUNK}",
                    chunk(kern, spread, mid_round, CHUNK),
                    chunk(plain, spread, mid_round, CHUNK), nf))
            max_err[name] = max(max_err[name], err)
        del topo
    torch.cuda.synchronize()
    return cases, max_err


def lattice_path(dev):
    """Phase 6: the lattice path through run(), counters zeroed before each
    run and read after it; then 130**3 on the card against the CPU's
    chunked engine. Returns the launches of each run and {(n, algorithm):
    (rounds, converged count, final state on the host)} of the torus3d
    runs for the sharded lattice phase."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    counters = {"pushsum": hbm.pushsum_stencil_hbm_chunk,
                "gossip": hbm.gossip_stencil_hbm_chunk}
    launches, single = {}, {}
    runs = (("gossip", SimConfig(n=LATTICE_N, topology="torus3d", algorithm="gossip")),
            ("pushsum", SimConfig(n=LATTICE_PS_N, topology="torus3d",
                                  algorithm="push-sum", max_rounds=LATTICE_PS_ROUNDS)))
    for name, cfg in runs:
        t0 = time.perf_counter()
        topo = build_topology("torus3d", cfg.n)
        build_s = time.perf_counter() - t0
        if fused_tier(topo, cfg) != ("stencil_hbm", None):
            raise AssertionError(f"{cfg.n} torus3d {name}: not the streaming tier")
        for fn in counters.values():
            fn.launches = 0
        res = run(topo, cfg)
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        MAIN_ROUNDS[f"{name}_stencil_hbm_chunk"] = res.rounds
        print(json.dumps({
            "metric": f"{name}_rounds_per_sec_torus3d_n{cfg.n}",
            "rounds": res.rounds, "run_s": res.run_s,
            "rounds_per_s": res.rounds / res.run_s, "build_s": build_s,
            "setup_s": res.setup_s, "compile_s": res.compile_s,
            "dispatch_s": res.dispatch_s, "first_dispatch_s": res.first_dispatch_s,
            "fetch_s": res.fetch_s, "converged_count": res.converged_count,
            "estimate_mae": res.estimate_mae, "launches": launches[name],
            "device": res.device,
        }), flush=True)
        # K + 3 launches a chunk (init, prologue, a round each, finish):
        # the warmup's one-round chunk, then chunks of chunk_rounds rounds
        # (the push-sum sample one of LATTICE_PS_ROUNDS).
        chunk_launches = 3 + min(cfg.chunk_rounds, cfg.max_rounds)
        extra = launches[name][name] - (3 + 1)
        if launches[name][name] == 0 or extra <= 0 or extra % chunk_launches:
            raise AssertionError(f"the torus3d {name} run queued {launches[name][name]} "
                                 f"launches, not 4 + a multiple of {chunk_launches}")
        if name == "gossip":
            if not res.converged or res.converged_count != cfg.n:
                raise AssertionError(f"16.8M torus3d gossip did not converge ({res.outcome})")
        else:
            if res.rounds != LATTICE_PS_ROUNDS:
                raise AssertionError(f"215**3 push-sum ran {res.rounds} rounds")
            n = topo.n
            mass_w = res.state.w.double().sum().item()
            mass_s = res.state.s.double().sum().item()
            err_w = abs(mass_w - n) / n
            err_s = abs(mass_s - n * (n - 1) / 2) / (n * (n - 1) / 2)
            print(f"  215**3 push-sum mass: sum w {mass_w} (rel err {err_w}), "
                  f"sum s {mass_s} (rel err {err_s})", flush=True)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError("215**3 push-sum did not conserve its mass")
        single[cfg.n, cfg.algorithm] = (res.rounds, res.converged_count,
                                        tuple(x.cpu() for x in res.state))
        del topo, res
    topo = build_topology("torus3d", LATTICE_CPU_N)
    for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
        cfg = SimConfig(n=LATTICE_CPU_N, topology="torus3d", algorithm=algorithm,
                        max_rounds=LATTICE_CPU_ROUNDS)
        t0 = time.perf_counter()
        a = run(topo, cfg)
        t1 = time.perf_counter()
        b = run(topo, cfg, device="cpu")
        t2 = time.perf_counter()
        if (a.rounds, a.converged_count) != (b.rounds, b.converged_count):
            raise AssertionError(
                f"130**3 {name}: card {a.rounds}/{a.converged_count} != "
                f"CPU {b.rounds}/{b.converged_count}")
        compare(f"130**3 {name} card vs CPU chunked engine, {a.rounds} rounds, "
                f"converged {a.converged_count} ({t1 - t0:.2f} s card, "
                f"{t2 - t1:.2f} s CPU)",
                (tuple(x.cpu() for x in a.state), a.rounds),
                (tuple(b.state), b.rounds), 2 if name == "pushsum" else 0)
    return launches, single


# The imp phases: (kind, requested n, the JAX ladder's tier) for the kernel
# checks, the rounds run before the mid-run checks and timings (imp3d 1M
# push-sum converges near round 800, gossip near round 60), and the 50**3
# card-vs-CPU check.
IMP_CASES = (("imp3d", 2**24, "imp_hbm"), ("imp3d", 1_000_000, "imp"),
             ("imp2d", 100_000, "imp"))
IMP_POOL = 4
IMP_MID = {"pushsum": 300, "gossip": 20}
IMP_CPU_N = 50**3
IMP_CPU_ROUNDS = 64


def imp_ops_per_node(algorithm: str, classes: int) -> int:
    """Per-node, per-round operations of csrc/fused_imp.cu: the slot-word
    hash, an eighth of the choice-word hash and the nibble extraction, the
    grid's direction pairs (20), the slot select (19) and the class lookup
    (10); per class (L lattice + P pool) a source index, the mark compare
    and the adds (push-sum also the two halvings); then the own halving and
    the absorb."""
    per_class = 8 if algorithm == "push-sum" else 5
    absorb = 16 if algorithm == "push-sum" else 6
    return OPS_PER_HASH + OPS_PER_HASH // 8 + 2 + 20 + 19 + 10 + per_class * classes + absorb


def imp_checks(dev, key):
    """Phase 7: each imp kernel against its plain version on the card.
    Returns {row: case} for the timing phase and {row: max_abs_err}, rows
    named by wrapper (pushsum_imp, gossip_imp, pushsum_imp_hbm,
    gossip_imp_hbm)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_imp_hbm
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool

    wrappers = {"imp": (fused_imp.pushsum_imp_chunk, fused_imp.gossip_imp_chunk),
                "imp_hbm": (fused_imp_hbm.pushsum_imp_hbm_chunk,
                            fused_imp_hbm.gossip_imp_hbm_chunk)}

    def case(topo, name, tier, pool):
        """(kernel, plain, chunk(fn, state, start, count, cap), init planes)."""
        algorithm = "push-sum" if name == "pushsum" else "gossip"
        cfg = SimConfig(n=topo.n_requested, topology=topo.kind, algorithm=algorithm,
                        delivery="pool", pool_size=pool)
        if fused_tier(topo, cfg) != (tier, None):
            raise AssertionError(f"{topo.kind} n={topo.n} {algorithm}: the ladder "
                                 f"picks {fused_tier(topo, cfg)}, not {tier}")
        common = {"spec": fused_imp.imp_spec(topo),
                  "target": cfg.resolved_target_count(topo.n, topo.target_count)}
        if algorithm == "push-sum":
            plain = fused_imp.pushsum_imp_chunk_plain
            common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
        else:
            plain = fused_imp.gossip_imp_chunk_plain
            common.update(rumor_target=cfg.resolved_rumor_target,
                          suppress=cfg.resolved_suppress)

        @functools.lru_cache(maxsize=None)
        def streams(start, count):
            return (fused.round_keys(key, start, count),
                    fused_pool.round_offsets(key, start, count, pool, topo.n),
                    fused_imp.choice_round_keys(key, start, count))

        def chunk(fn, state, start, count, cap=None):
            return fn(state, *streams(start, count), start,
                      start + count if cap is None else cap, **common)

        eng = fused_engine(topo, cfg, key, tier)
        init = tuple(p.contiguous().to(dev) for p in eng.planes)
        return wrappers[tier][algorithm != "push-sum"], plain, chunk, init

    cases, max_err = {}, {}
    for kind, n, tier in IMP_CASES:
        t0 = time.perf_counter()
        topo = build_topology(kind, n)
        label = f"{kind} n={topo.n} ({tier}, built in {time.perf_counter() - t0:.2f} s)"
        print(f"imp kernels vs plain versions, pool_size {IMP_POOL}, at {label}:", flush=True)
        for name in ("pushsum", "gossip"):
            kern, plain, chunk, init = case(topo, name, tier, IMP_POOL)
            mid_round = IMP_MID[name]
            errs = [compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                            chunk(plain, init, 0, CHUNK), 0)]
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"{kind} {name}: converged before round {mid_round}")
            errs.append(compare(f"{name} mid-run K={CHUNK}",
                                chunk(kern, mid, mid_round, CHUNK),
                                chunk(plain, mid, mid_round, CHUNK), 0))
            errs += parity_checks(name, kern, plain, chunk, mid, mid_round, 0)
            errs += zero_round_checks(name, kern, plain, chunk, mid, mid_round)
            done_state, ex = chunk(kern, mid, mid_round, 4096)
            done_round = mid_round + int(ex)
            if int(ex) == 4096:
                raise AssertionError(f"{kind} {name} did not converge")
            out, ex = chunk(kern, done_state, done_round, CHUNK)
            if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
                raise AssertionError(f"{kind} {name}: a chunk from a converged state ran")
            print(f"  {name} from converged state (round {done_round}): 0 rounds, "
                  "state unchanged", flush=True)
            row = f"{name}_{tier}"
            max_err[row] = max([max_err.get(row, 0.0)] + errs)
            if kind == "imp3d":  # the timed shapes
                cases[row] = (kern, plain, chunk, mid, mid_round, topo.n,
                              len(fused_imp.imp_spec(topo).classes), tier)
            if (kind, tier, name) == ("imp3d", "imp", "pushsum"):
                # The packed-choice cap: 16 pool classes.
                kern16, plain16, chunk16, init16 = case(topo, name, tier, 16)
                max_err[row] = max(max_err[row], compare(
                    f"{name} pool_size 16 init K={CHUNK}", chunk16(kern16, init16, 0, CHUNK),
                    chunk16(plain16, init16, 0, CHUNK), 0))
        del topo
    torch.cuda.synchronize()
    return cases, max_err


def imp_path(dev):
    """Phase 8: the imp path through run(), counters zeroed before each run
    and read after it; then 50**3 on the card against the CPU's chunked
    engine. Returns each row's launches over its main-path run, and {(n,
    algorithm): (rounds, converged_count, state on the host)} of the imp3d
    16,777,216 runs for the sharded imp phase."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused_imp, fused_imp_hbm

    counters = {"pushsum_imp": fused_imp.pushsum_imp_chunk,
                "gossip_imp": fused_imp.gossip_imp_chunk,
                "pushsum_imp_hbm": fused_imp_hbm.pushsum_imp_hbm_chunk,
                "gossip_imp_hbm": fused_imp_hbm.gossip_imp_hbm_chunk}
    launches, single = {}, {}
    for kind, n, _ in IMP_CASES:
        algorithms = ("gossip", "push-sum") if kind == "imp3d" else ("push-sum",)
        t0 = time.perf_counter()
        topo = build_topology(kind, n)
        build_s = time.perf_counter() - t0
        for algorithm in algorithms:
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                            pool_size=IMP_POOL)
            tier = fused_tier(topo, cfg)[0]
            name = f"{'pushsum' if algorithm == 'push-sum' else 'gossip'}_{tier}"
            for fn in counters.values():
                fn.launches = 0
            res = run(topo, cfg)
            counts = {k: fn.launches for k, fn in counters.items()}
            print(json.dumps({
                "metric": f"{name}_rounds_per_sec_{kind}_n{topo.n}",
                "rounds": res.rounds, "run_s": res.run_s,
                "rounds_per_s": res.rounds / res.run_s, "build_s": build_s,
                "setup_s": res.setup_s, "compile_s": res.compile_s,
                "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s,
                "converged_count": res.converged_count,
                "estimate_mae": res.estimate_mae, "launches": counts,
                "device": res.device,
            }), flush=True)
            # K + 3 launches a chunk (init, prologue, a round each, finish):
            # the warmup's one-round chunk, then chunks of chunk_rounds.
            chunk_launches = fused_imp.chunk_launches(min(cfg.chunk_rounds, cfg.max_rounds))
            extra = counts[name] - fused_imp.chunk_launches(1)
            if counts[name] == 0 or extra <= 0 or extra % chunk_launches:
                raise AssertionError(f"the {kind} {algorithm} run queued {counts[name]} "
                                     f"launches, not 4 + a multiple of {chunk_launches}")
            if not res.converged or res.converged_count != topo.n:
                raise AssertionError(f"{kind} n={topo.n} {algorithm} did not converge")
            if algorithm == "push-sum":
                m = topo.n
                err_w = abs(res.state.w.double().sum().item() - m) / m
                err_s = abs(res.state.s.double().sum().item() - m * (m - 1) / 2) / (m * (m - 1) / 2)
                print(f"  mass: sum w rel err {err_w}, sum s rel err {err_s}", flush=True)
                if not (err_w < 1e-5 and err_s < 1e-5):
                    raise AssertionError(f"{kind} push-sum did not conserve its mass")
            if kind == "imp3d":  # the timed shapes
                launches[name] = counts[name]
                MAIN_ROUNDS[f"{name}_chunk"] = res.rounds
            if (kind, n) == ("imp3d", IMP_SHARD_RUN_N):
                single[n, algorithm] = (res.rounds, res.converged_count,
                                        tuple(x.cpu() for x in res.state))
        del topo
    topo = build_topology("imp3d", IMP_CPU_N)
    for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
        cfg = SimConfig(n=IMP_CPU_N, topology="imp3d", algorithm=algorithm,
                        delivery="pool", pool_size=IMP_POOL, max_rounds=IMP_CPU_ROUNDS)
        t0 = time.perf_counter()
        a = run(topo, cfg)
        t1 = time.perf_counter()
        b = run(topo, cfg, device="cpu")
        t2 = time.perf_counter()
        if (a.rounds, a.converged_count) != (b.rounds, b.converged_count):
            raise AssertionError(
                f"50**3 imp3d {name}: card {a.rounds}/{a.converged_count} != "
                f"CPU {b.rounds}/{b.converged_count}")
        compare(f"50**3 imp3d {name} card vs CPU chunked engine, {a.rounds} rounds, "
                f"converged {a.converged_count} ({t1 - t0:.2f} s card, "
                f"{t2 - t1:.2f} s CPU)",
                (tuple(x.cpu() for x in a.state), a.rounds),
                (tuple(b.state), b.rounds), 0)
    return launches, single


# The resident lattice phases: (kind, n, the JAX ladder's tier) for the
# kernel checks, the rounds run before the mid-run checks (the fastest of
# these, torus3d 1M gossip, converges near round 239), and the shapes the
# timing phase takes from the main path (line 1000 gossip, grid2d 10,000
# push-sum, torus3d 1M both).
RESIDENT_CASES = (("line", 1000, "stencil"), ("grid2d", 10_000, "stencil"),
                  ("grid3d", 125_000, "stencil"), ("ring", 131_072, "stencil"),
                  ("ring", 5000, "stencil2"), ("torus3d", 1_000_000, "stencil2"),
                  ("grid2d", 1_000_000, "stencil2"))
RESIDENT_MID = {"pushsum": 300, "gossip": 40}
RESIDENT_TIMED = {("pushsum", "stencil"): ("grid2d", 10_000),
                  ("gossip", "stencil"): ("line", 1000),
                  ("pushsum", "stencil2"): ("torus3d", 1_000_000),
                  ("gossip", "stencil2"): ("torus3d", 1_000_000)}
# The JAX package's rounds for the main path's configs (BENCH_TABLES.md),
# printed beside the card's. The push-sum records come from its TPU
# kernels, whose float32 op order differs from the chunked engine's.
JAX_RECORDS = {("line", "gossip"): 1609, ("grid2d", "push-sum"): 83_290,
               ("torus3d", "gossip"): 239, ("torus3d", "push-sum"): 37_236}
# (rounds, estimate_mae) of the JAX package's chunked engine on the CPU,
# seed 0, which the card's whole run must equal:
#   python -m cop5615_gossip_protocol_tpu 10000 2D push-sum --engine chunked --platform cpu
JAX_CHUNKED = {("grid2d", 10_000, "push-sum"): (82_363, 0.09073036206020516)}
# The resident path's runs to convergence, on the card; the first
# PREFIX_ROUNDS rounds of the first are held bitwise against the CPU's
# chunked engine (its whole run of 83,290 rounds would take the CPU
# minutes).
RESIDENT_RUNS = (("grid2d", 10_000, "push-sum"), ("torus3d", 1_000_000, "gossip"),
                 ("torus3d", 1_000_000, "push-sum"))
PREFIX_ROUNDS = 4096
# The second timing of rows 5-8: one chunk this long from the same state
# (torus3d 1M gossip converges within it, so its rounds are fewer).
LONG_CHUNK = 1024


def resident_wrappers():
    """{(name, tier): the chunk wrapper}, rows 5-8 of the kernel table."""
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_stencil

    return {("pushsum", "stencil"): fused.pushsum_chunk,
            ("gossip", "stencil"): fused.gossip_chunk,
            ("pushsum", "stencil2"): fused_stencil.pushsum_stencil2_chunk,
            ("gossip", "stencil2"): fused_stencil.gossip_stencil2_chunk}


def resident_checks(dev, key):
    """Phase 9: each resident kernel against its plain version on the card,
    one 32-round chunk from the initial state, from a mid-run state, with a
    cap inside the chunk after an odd and an even number of rounds, a
    one-round chunk, from a gossip spread state and from a converged state,
    every check bitwise; the ladder must pick the JAX ladder's tier for
    each shape. Returns {(name, tier): case} for the timing phase and
    {(name, tier): max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    keys = functools.lru_cache(maxsize=None)(
        lambda start, count: fused.round_keys(key, start, count))
    wrappers = resident_wrappers()
    cases, max_err = {}, {}
    for kind, n, tier in RESIDENT_CASES:
        t0 = time.perf_counter()
        topo = build_topology(kind, n)
        label = f"{kind} n={topo.n} ({tier}, built in {time.perf_counter() - t0:.2f} s)"
        print(f"resident kernels vs plain versions at {label}:", flush=True)
        for name in ("pushsum", "gossip"):
            algorithm = "push-sum" if name == "pushsum" else "gossip"
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm)
            if fused_tier(topo, cfg) != (tier, None):
                raise AssertionError(f"{kind} n={n} {algorithm}: the ladder picks "
                                     f"{fused_tier(topo, cfg)}, not {tier}")
            common = {"spec": hbm.stencil_spec(topo),
                      "target": cfg.resolved_target_count(topo.n, topo.target_count)}
            if name == "pushsum":
                plain = hbm.pushsum_stencil_hbm_chunk_plain
                common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
            else:
                plain = hbm.gossip_stencil_hbm_chunk_plain
                common.update(rumor_target=cfg.resolved_rumor_target,
                              suppress=cfg.resolved_suppress)
            kern = wrappers[name, tier]

            def chunk(fn, state, start, count, cap=None, common=common):
                return fn(state, keys(start, count), start,
                          start + count if cap is None else cap, **common)

            init = tuple(p.contiguous().to(dev)
                         for p in fused_engine(topo, cfg, key, tier).planes)
            mid_round = RESIDENT_MID[name]
            errs = [compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                            chunk(plain, init, 0, CHUNK), 0)]
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"{kind} {name}: converged before round {mid_round}")
            errs.append(compare(f"{name} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                                chunk(plain, mid, mid_round, CHUNK), 0))
            errs += parity_checks(name, kern, plain, chunk, mid, mid_round, 0)
            if name == "gossip":
                spread = spread_state(init, topo.n, cfg.resolved_rumor_target)
                errs.append(compare(f"{name} spread state K={CHUNK}",
                                    chunk(kern, spread, mid_round, CHUNK),
                                    chunk(plain, spread, mid_round, CHUNK), 0))
            # Every real node's conv flag latched: the chunk runs nothing.
            real = torch.arange(mid[0].numel(), device=dev).reshape(mid[0].shape) < topo.n
            done_state = (*mid[:-1], real.to(torch.int32))
            out, ex = chunk(kern, done_state, mid_round, CHUNK)
            if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
                raise AssertionError(f"{kind} {name}: a chunk from a converged state ran")
            print(f"  {name} from converged state: 0 rounds, state unchanged", flush=True)
            max_err[name, tier] = max([max_err.get((name, tier), 0.0)] + errs)
            if RESIDENT_TIMED[name, tier] == (kind, n):
                cases[name, tier] = (kern, plain, chunk, mid, mid_round, len(topo.offsets))
        del topo
    torch.cuda.synchronize()
    return cases, max_err


def resident_path(dev):
    """Phase 10: the resident lattice path, counters zeroed before each run
    and read after it: the CLI's ``1000 line gossip`` (the reference's own
    command line) and the same config through run() against the CPU's
    chunked engine; then RESIDENT_RUNS to convergence on the card, push-sum
    with its mass conserved, the first run's first PREFIX_ROUNDS rounds
    also against the CPU's chunked engine.
    Returns each row's launches over its main-path run and {(n,
    algorithm): (rounds, converged count, final state on the host)} of the
    torus3d runs for the sharded lattice phase."""
    import contextlib
    import io

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier

    counters = resident_wrappers()
    launches, single = {}, {}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def report(label, res, build_s, counts, record):
        print(json.dumps({
            "metric": label, "rounds": res.rounds, "jax_record_rounds": record,
            "run_s": res.run_s, "rounds_per_s": res.rounds / res.run_s,
            "build_s": build_s, "setup_s": res.setup_s, "compile_s": res.compile_s,
            "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s,
            "chunks_retired": len(res.chunk_log),
            "converged_count": res.converged_count, "estimate_mae": res.estimate_mae,
            "launches": {f"{k[0]}_{k[1]}": v for k, v in counts.items()},
            "device": res.device,
        }), flush=True)

    def same_state(label, a, b, float_planes):
        if (a.rounds, a.converged_count) != (b.rounds, b.converged_count):
            raise AssertionError(f"{label}: card {a.rounds}/{a.converged_count} != "
                                 f"CPU {b.rounds}/{b.converged_count}")
        compare(f"{label}, {a.rounds} rounds, converged {a.converged_count}",
                (tuple(x.cpu() for x in a.state), a.rounds),
                (tuple(b.state), b.rounds), float_planes)

    def mass(label, res, n):
        err_w = abs(res.state.w.double().sum().item() - n) / n
        err_s = abs(res.state.s.double().sum().item() - n * (n - 1) / 2) / (n * (n - 1) / 2)
        print(f"  {label} mass: sum w rel err {err_w}, sum s rel err {err_s}", flush=True)
        if not (err_w < 1e-5 and err_s < 1e-5):
            raise AssertionError(f"{label} did not conserve its mass")

    # The CLI, as a user types it; its record line gives rounds and count.
    zero()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(["1000", "line", "gossip"])
    cli_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    rounds = json.loads(out.getvalue().strip().splitlines()[-1])["rounds"]
    print(f"  CLI 1000 line gossip: exit {code}, {rounds} rounds "
          f"(JAX record {JAX_RECORDS['line', 'gossip']}), {cli_s:.2f} s, "
          f"launches {counts[('gossip', 'stencil')]}", flush=True)
    if code != 0 or counts["gossip", "stencil"] == 0:
        raise AssertionError("the CLI's 1000 line gossip failed or never launched "
                             "the resident kernel")
    launches["gossip", "stencil"] = counts["gossip", "stencil"]
    MAIN_ROUNDS["gossip_stencil_chunk"] = rounds
    topo = build_topology("line", 1000)
    cfg = SimConfig(n=1000, topology="line", algorithm="gossip")
    a = run(topo, cfg)
    b = run(topo, SimConfig(n=1000, topology="line", algorithm="gossip",
                            engine="chunked"), device="cpu")
    same_state("1000 line gossip card vs CPU chunked engine", a, b, 0)
    if a.rounds != rounds:
        raise AssertionError(f"the CLI ran {rounds} rounds, run() {a.rounds}")

    # The first run's prefix bitwise, then each run to convergence.
    topos = {}
    for kind, n, algorithm in RESIDENT_RUNS:
        if (kind, n) not in topos:
            t0 = time.perf_counter()
            topos[kind, n] = (build_topology(kind, n), time.perf_counter() - t0)
    kind, n, algorithm = RESIDENT_RUNS[0]
    topo = topos[kind, n][0]
    prefix = {engine: SimConfig(n=n, topology=kind, algorithm=algorithm,
                                engine=engine, max_rounds=PREFIX_ROUNDS)
              for engine in ("auto", "chunked")}
    same_state(f"{kind} n={n} {algorithm} first {PREFIX_ROUNDS} rounds, card vs "
               "CPU chunked engine", run(topo, prefix["auto"]),
               run(topo, prefix["chunked"], device="cpu"), 2)
    for kind, n, algorithm in RESIDENT_RUNS:
        topo, build_s = topos[kind, n]
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm)
        tier = fused_tier(topo, cfg)[0]
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        zero()
        res = run(topo, cfg)
        counts = {k: fn.launches for k, fn in counters.items()}
        report(f"{name}_{tier}_rounds_per_sec_{kind}_n{topo.n}", res, build_s, counts,
               JAX_RECORDS.get((kind, algorithm)))
        if counts[name, tier] == 0 or counts[name, tier] % 3:
            raise AssertionError(f"{kind} {algorithm}: {counts[name, tier]} launches "
                                 f"of {name}_{tier}, not 3 a chunk")
        if not res.converged or res.converged_count != topo.n:
            raise AssertionError(f"{kind} n={topo.n} {algorithm} did not converge")
        if algorithm == "push-sum":
            mass(f"{kind} n={topo.n} push-sum", res, topo.n)
        want = JAX_CHUNKED.get((kind, n, algorithm))
        if want is not None and (res.rounds, res.estimate_mae) != want:
            raise AssertionError(f"{kind} n={n} {algorithm}: rounds, estimate_mae "
                                 f"{res.rounds}, {res.estimate_mae} != the JAX "
                                 f"chunked engine's {want}")
        launches[name, tier] = counts[name, tier]
        MAIN_ROUNDS[f"{name}_{tier}_chunk"] = res.rounds
        if kind == "torus3d":
            single[n, algorithm] = (res.rounds, res.converged_count,
                                    tuple(x.cpu() for x in res.state))
    torch.cuda.synchronize()
    return launches, single


# The streaming pool phases: the tier's first population (65,535 pad lanes
# past n), 10,000,000 (27,008) and 2**24 (none) for the kernel checks, the
# timed 2**24 and the tier's cap 2**27 (one chunk there; the plain version
# needs ~25 GB of temporaries), the card-vs-CPU population and rounds, and
# the JAX package's rounds at 2**27 on one TPU chip (tests_tpu/RUNLOG.md:
# 87-90), printed beside the card's, not asserted: the push-sum record comes
# from the TPU kernel, whose float32 op order differs.
POOL2_SIZES = (2**21 + 1, 10_000_000, 2**24)
# Rounds before the mid-run checks and timings: push-sum converges near
# round 98 at 2,097,153 (the float32 ratio is coarse past 2**20, so it
# steadies sooner than at 1M), gossip near round 50.
POOL2_MID = {"pushsum": 40, "gossip": 8}
POOL2_TIMED = 2**24
POOL2_CAP = 2**27
POOL2_CPU_N = 2**21 + 1
POOL2_CPU_ROUNDS = 64
POOL2_RECORDS = {"gossip": 64, "push-sum": 253}
# (rounds, estimate_mae) of the JAX package's chunked engine on the CPU at
# POOL2_CPU_N, seed 0, pool_size 2, which the card's whole runs must equal:
#   python -m cop5615_gossip_protocol_tpu 2097153 full push-sum --delivery pool \
#       --pool-size 2 --engine chunked --platform cpu
POOL2_JAX_CHUNKED = {"push-sum": (98, 0.004213935306690194), "gossip": (49, None)}


def pool2_ops_per_node(algorithm: str, pool: int) -> float:
    """Per-node, per-round operations of csrc/fused_pool2.cu: per slot two
    Threefry words per 8 nodes (csrc/pool2.cuh, column_sources), a source
    index (compare, subtract, add), the choice extraction (row add, word
    select, shift, and), the hit test (two compares, and) and the adds
    (push-sum also the two halvings); then the packed plane's unpack and
    pack (push-sum, 4) and the absorb."""
    per_slot = 2 * OPS_PER_HASH / 8 + 3 + 4 + 3 + (4 if algorithm == "push-sum" else 1)
    absorb = 16 + 4 if algorithm == "push-sum" else 6 + 1
    return pool * per_slot + absorb


def pool2_bytes_per_node(algorithm: str, pool: int) -> int:
    """Bytes a round must move per node past the L2: the state read and
    written once (push-sum s, w and the packed term|conv plane; gossip
    count and active) plus each slot's source window (push-sum s and w,
    gossip active)."""
    return 24 + 8 * pool if algorithm == "push-sum" else 16 + 4 * pool


def pool2_case(dev, key, n, algorithm, pool=POOL):
    """(kernel, plain, chunk(fn, state, start, count, cap), init planes on
    the card) for one streaming pool config; the ladder must pick pool2."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, fused_pool2

    topo = build_topology("full", n)
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=pool)
    if fused_tier(topo, cfg) != ("pool2", None):
        raise AssertionError(f"full n={n} {algorithm}: the ladder picks "
                             f"{fused_tier(topo, cfg)}, not pool2")
    common = {"n": n, "target": cfg.resolved_target_count(n, topo.target_count)}
    if algorithm == "push-sum":
        fns = (fused_pool2.pushsum_pool2_chunk, fused_pool2.pushsum_pool2_chunk_plain)
        common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
    else:
        fns = (fused_pool2.gossip_pool2_chunk, fused_pool2.gossip_pool2_chunk_plain)
        common.update(rumor_target=cfg.resolved_rumor_target,
                      suppress=cfg.resolved_suppress)

    @functools.lru_cache(maxsize=None)
    def streams(start, count):
        return (fused.round_keys(key, start, count),
                fused_pool.round_offsets(key, start, count, pool, n))

    def chunk(fn, state, start, count, cap=None):
        return fn(state, *streams(start, count), start,
                  start + count if cap is None else cap, **common)

    init = tuple(p.contiguous().to(dev)
                 for p in fused_engine(topo, cfg, key, "pool2").planes)
    return (*fns, chunk, init)


def pool2_checks(dev, key):
    """Phase 11: each streaming pool kernel against its plain version on the
    card, one 32-round chunk at each of POOL2_SIZES from the initial state,
    from a mid-run state, with a cap inside the chunk and from a converged
    state; push-sum at pool_size 16 at the tier's first size; one chunk from
    the initial state at 2**27. Every check bitwise. Returns {name: case}
    for the timing phase (the 2**24 mid-run state and the 2**27 initial
    one) and {name: max_abs_err}."""
    import torch

    cases, max_err = {}, {}
    for n in POOL2_SIZES:
        print(f"streaming pool kernels vs plain versions at full n = {n:,}:", flush=True)
        for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
            kern, plain, chunk, init = pool2_case(dev, key, n, algorithm)
            mid_round = POOL2_MID[name]
            errs = [compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                            chunk(plain, init, 0, CHUNK), 0)]
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"full n={n} {name}: converged before round {mid_round}")
            errs.append(compare(f"{name} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                                chunk(plain, mid, mid_round, CHUNK), 0))
            errs.append(compare(f"{name} cap inside chunk",
                                chunk(kern, mid, mid_round, CHUNK, cap=mid_round + 5),
                                chunk(plain, mid, mid_round, CHUNK, cap=mid_round + 5), 0))
            done_state, ex = chunk(kern, mid, mid_round, 4096)
            done_round = mid_round + int(ex)
            if int(ex) == 4096:
                raise AssertionError(f"full n={n} {name} did not converge")
            out, ex = chunk(kern, done_state, done_round, CHUNK)
            if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
                raise AssertionError(f"full n={n} {name}: a chunk from a converged state ran")
            print(f"  {name} from converged state (round {done_round}): 0 rounds, "
                  "state unchanged", flush=True)
            if n == POOL2_SIZES[0] and name == "pushsum":
                # The packed-choice cap: 16 pool slots.
                kern16, plain16, chunk16, init16 = pool2_case(dev, key, n, algorithm, 16)
                errs.append(compare(f"{name} pool_size 16 init K={CHUNK}",
                                    chunk16(kern16, init16, 0, CHUNK),
                                    chunk16(plain16, init16, 0, CHUNK), 0))
            max_err[name] = max([max_err.get(name, 0.0)] + errs)
            if n == POOL2_TIMED:
                cases[name] = (kern, plain, chunk, mid, mid_round, n)
            del init, mid, done_state, out
    # The tier's cap: one chunk from the initial state, where the card has
    # room for the plain version's temporaries.
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    print(f"streaming pool kernels vs plain versions at full n = {POOL2_CAP:,} "
          f"({free / 2**30:.1f} GiB free):", flush=True)
    for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
        kern, plain, chunk, init = pool2_case(dev, key, POOL2_CAP, algorithm)
        if free < 48 * 2**30:
            print(f"  {name}: plain version skipped, {free / 2**30:.1f} GiB free "
                  "is under the 48 GiB it needs", flush=True)
            cases[f"{name}_cap"] = (kern, None, chunk, init, 0, POOL2_CAP)
            continue
        cases[f"{name}_cap"] = (kern, plain, chunk, init, 0, POOL2_CAP)
        max_err[name] = max(max_err[name], compare(
            f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
            chunk(plain, init, 0, CHUNK), 0))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err


def pool2_path(dev):
    """Phase 12: the streaming pool path, counters zeroed before each run
    and read after it: 2**24 and 2**27 full, both algorithms, to
    convergence on the card (push-sum to a small estimate error with its
    mass conserved; the JAX records printed beside at 2**27); the CLI's
    ``16777216 full push-sum --delivery pool --pool-size 2``; then
    POOL2_CPU_N, both algorithms, POOL2_CPU_ROUNDS rounds on the card
    against the CPU's chunked engine, and to convergence against the JAX
    chunked engine's record. Returns each row's launches over its 2**24
    run, and {(n, algorithm): (rounds, converged count, final state on the
    host)} of the 2**24 and 2**27 runs for the sharded phase."""
    import contextlib
    import io

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool2

    counters = {"pushsum": fused_pool2.pushsum_pool2_chunk,
                "gossip": fused_pool2.gossip_pool2_chunk}
    launches, single = {}, {}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    for n in (POOL2_TIMED, POOL2_CAP):
        t0 = time.perf_counter()
        topo = build_topology("full", n)
        build_s = time.perf_counter() - t0
        for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
            cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL)
            if fused_tier(topo, cfg) != ("pool2", None):
                raise AssertionError(f"full n={n} {algorithm}: not the streaming pool tier")
            zero()
            res = run(topo, cfg)
            counts = {k: fn.launches for k, fn in counters.items()}
            print(json.dumps({
                "metric": f"{name}_pool2_rounds_per_sec_full_n{n}",
                "rounds": res.rounds,
                "jax_record_rounds": POOL2_RECORDS[algorithm] if n == POOL2_CAP else None,
                "run_s": res.run_s, "rounds_per_s": res.rounds / res.run_s,
                "build_s": build_s, "setup_s": res.setup_s, "compile_s": res.compile_s,
                "dispatch_s": res.dispatch_s, "first_dispatch_s": res.first_dispatch_s,
                "fetch_s": res.fetch_s, "finalize_s": res.finalize_s,
                "chunks_retired": len(res.chunk_log),
                "converged_count": res.converged_count,
                "estimate_mae": res.estimate_mae, "launches": counts,
                "device": res.device,
            }), flush=True)
            if counts[name] == 0 or not res.device.startswith("cuda"):
                raise AssertionError(f"full n={n} {algorithm} never launched its kernel")
            if not res.converged or res.converged_count != n:
                raise AssertionError(f"full n={n} {algorithm} did not converge ({res.outcome})")
            if algorithm == "push-sum":
                if res.estimate_mae is None or not res.estimate_mae / res.true_mean < 1e-6:
                    raise AssertionError(f"full n={n} push-sum estimate_mae {res.estimate_mae} "
                                         f"is not small against the mean {res.true_mean}")
                err_w = abs(res.state.w.double().sum().item() - n) / n
                err_s = abs(res.state.s.double().sum().item() - n * (n - 1) / 2) / (n * (n - 1) / 2)
                print(f"  mass: sum w rel err {err_w}, sum s rel err {err_s}", flush=True)
                if not (err_w < 1e-5 and err_s < 1e-5):
                    raise AssertionError(f"full n={n} push-sum did not conserve its mass")
            if n == POOL2_TIMED:
                launches[name] = counts[name]
                MAIN_ROUNDS[f"{name}_pool2_chunk"] = res.rounds
                RUN_S[f"{name}_single"] = res.run_s
            single[n, algorithm] = (res.rounds, res.converged_count,
                                    tuple(x.cpu() for x in res.state))
            del res
        del topo
        torch.cuda.empty_cache()

    # The CLI, as a user types it; its record line gives rounds and count.
    zero()
    out = io.StringIO()
    argv = [str(POOL2_TIMED), "full", "push-sum", "--delivery", "pool", "--pool-size", "2"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    record = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"  CLI {' '.join(argv)}: exit {code}, {record['rounds']} rounds, "
          f"converged {record['converged_count']}, {time.perf_counter() - t0:.2f} s, "
          f"launches {counters['pushsum'].launches}", flush=True)
    if code != 0 or counters["pushsum"].launches == 0:
        raise AssertionError("the CLI's 16.8M full push-sum failed or never launched "
                             "the streaming pool kernel")

    topo = build_topology("full", POOL2_CPU_N)
    for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
        cfg = SimConfig(n=POOL2_CPU_N, algorithm=algorithm, delivery="pool",
                        pool_size=POOL, max_rounds=POOL2_CPU_ROUNDS)
        t0 = time.perf_counter()
        a = run(topo, cfg)
        t1 = time.perf_counter()
        b = run(topo, cfg, device="cpu")
        t2 = time.perf_counter()
        if (a.rounds, a.converged_count) != (b.rounds, b.converged_count):
            raise AssertionError(
                f"full n={POOL2_CPU_N} {name}: card {a.rounds}/{a.converged_count} != "
                f"CPU {b.rounds}/{b.converged_count}")
        compare(f"full n={POOL2_CPU_N} {name} card vs CPU chunked engine, {a.rounds} "
                f"rounds, converged {a.converged_count} ({t1 - t0:.2f} s card, "
                f"{t2 - t1:.2f} s CPU)",
                (tuple(x.cpu() for x in a.state), a.rounds),
                (tuple(b.state), b.rounds), 0)
        # The whole run on the card against the JAX chunked engine's.
        res = run(topo, SimConfig(n=POOL2_CPU_N, algorithm=algorithm, delivery="pool",
                                  pool_size=POOL))
        want = POOL2_JAX_CHUNKED[algorithm]
        if (res.rounds, res.estimate_mae) != want or res.converged_count != POOL2_CPU_N:
            raise AssertionError(f"full n={POOL2_CPU_N} {algorithm}: rounds, estimate_mae "
                                 f"{res.rounds}, {res.estimate_mae} != the JAX chunked "
                                 f"engine's {want}")
        print(f"  full n={POOL2_CPU_N} {name} to convergence on the card: {res.rounds} "
              f"rounds, estimate_mae {res.estimate_mae}, the JAX chunked engine's", flush=True)
    return launches, single


# The replicated-pool2 composition (parallel/pool2_sharded.py), its shards
# all on the one card, where a round is one launch over every row: the
# kernel checks at (n, shards, the wire the plan picks), each launch held
# against its plain version from the initial, the POOL2_MID and a converged
# state (16,777,217 has 65,535 pad lanes, so its columns straddle the mod-n
# wrap), over every row and over the last shard's rows alone (a device of a
# several-card run), and a chunk of SHARD_CAP_CHUNK launches whose target
# is reached halfway; the runs through run(), each against the
# single-device streaming pool run of phase 12; and the timed round.
SHARD_CASES = ((2**24, 2, "all_gather"), (2**24, 4, "reduce_scatter"),
               (2**24 + 1, 2, "all_gather"))
SHARD_RUNS = ((2**24, 2), (2**24, 4), (2**27, 4))
SHARD_TIMED = (2**24, 4)
SHARD_CAP_CHUNK = 8
# Launches on the SHARD_TIMED paths at most: one a round, to the end of the
# 8-round chunk after the one that converges (338 and 56 rounds).
SHARD_MAX_LAUNCHES = {"pushsum": 352, "gossip": 64}
# run_s of the 16.8M push-sum runs, single-device (phase 12) and sharded
# (phase 14), for the line that sets them side by side.
RUN_S = {}


def shard_planes(planes, algorithm):
    """The streaming pool tier's padded planes, (s, w, term, conv) or
    (count, active, conv), as the composition's (s, w, term|conv) or
    (count, active), in one set over every row."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded

    if algorithm == "push-sum":
        s, w, term, conv = planes
        tc = torch.where(conv != 0, term | pool2_sharded.TC_CONV_BIT, term)
        return (s, w, tc.to(torch.int32))
    return tuple(planes[:2])


def shard_case(dev, key, n, shards, algorithm):
    """The launch's wrapper, its plain version, their keywords, the plan's
    rows_loc, layout and wire, and the config's target."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    topo = build_topology("full", n)
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL,
                    n_devices=shards, engine="fused")
    rows_loc, _, layout, wire = p2s.plan_pool2_sharded(topo, cfg, shards)
    if algorithm == "push-sum":
        fns = (p2s.pushsum_pool2_shard_round, p2s.pushsum_pool2_shard_round_plain)
    else:
        fns = (p2s.gossip_pool2_shard_round, p2s.gossip_pool2_shard_round_plain)
    return (*fns, p2s.round_kw(topo, cfg), rows_loc, layout, wire,
            cfg.resolved_target_count(n, topo.target_count))


def shard_streams(key, rnd, count, n, dev):
    """Rounds rnd..rnd + count - 1's keys and displacements on the card,
    and on the host as lists."""
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool

    keys = fused.round_keys(key, rnd, count)
    offs = fused_pool.round_offsets(key, rnd, count, POOL, n)
    return keys.to(dev), offs.to(dev), keys.tolist(), offs.tolist()


def shard_launch(kern, algorithm, kw, state, out, streams, at, row0, rows, **ctl):
    """One launch over global rows [row0, row0 + rows) from ``state`` (the
    composition's planes over every row) into ``out``'s, round ``at`` of
    ``streams``."""
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    glob, own = p2s.split_state(state, algorithm)
    glob_out, own_out = p2s.split_state(out, algorithm)
    kern(glob, glob_out, tuple(p[row0:row0 + rows] for p in own),
         tuple(p[row0:row0 + rows] for p in own_out), streams[0], streams[1], row0,
         **kw, at=at, **ctl)


def shard_plain(plain, algorithm, kw, state, streams, at, row0, rows):
    """The plain version of ``shard_launch``: (the rows' planes, count)."""
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    glob, own = p2s.split_state(state, algorithm)
    return plain(glob, tuple(p[row0:row0 + rows] for p in own), streams[2][at],
                 streams[3][at], row0, **kw)


def shard_bitwise(label, got, want):
    """Every plane of ``got`` bit for bit ``want``'s; returns the largest
    absolute difference (0.0)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            err = max(err, (g - w).abs().max().item()) if same else err
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"{label}: a plane differs from plain")
    return err


def shard_checks(dev, key):
    """Phase 13: each shard kernel against its plain version on the card at
    each of SHARD_CASES: one launch over every row and one over the last
    shard's rows alone (counts to u; rows outside untouched) from the
    initial, the POOL2_MID and a converged state; over every row with the
    verdict in the launch (ctrl counts the round and sets done as the
    plain count says), from the converged state with the done flag set
    (nothing written, ctrl unchanged), and a chunk of SHARD_CAP_CHUNK
    launches from the POOL2_MID state whose target, the plain count after
    its fifth round, is reached inside it (ctrl stops there and the final
    set is the plain state then). Every plane and count bitwise. Returns
    the timed case's operands {name: ...} and {name: max_abs_err}."""
    import torch

    cases, max_err = {}, {}
    for n, shards, want_wire in SHARD_CASES:
        print(f"shard kernels vs plain versions at full n = {n:,}, {shards} shards:",
              flush=True)
        for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
            kern, plain, kw, rows_loc, layout, wire, target = shard_case(dev, key, n, shards,
                                                                         algorithm)
            if wire != want_wire:
                raise AssertionError(f"n={n} x{shards}: the plan picks {wire}")
            R = layout.rows
            p2_kern, _, chunk, init = pool2_case(dev, key, n, algorithm)
            mid_round = POOL2_MID[name]
            mid, ex = chunk(p2_kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"n={n} {name}: converged before round {mid_round}")
            done, ex = chunk(p2_kern, mid, mid_round, 4096)
            done_round = mid_round + int(ex)
            err = 0.0

            def zeros(k):
                return torch.zeros(k, dtype=torch.int32, device=dev)

            for label, planes, rnd in (("init", init, 0), ("mid-run", mid, mid_round),
                                       ("converged", done, done_round)):
                state = shard_planes(planes, algorithm)
                streams = shard_streams(key, rnd, 1, n, dev)
                # Every row, then the last shard's rows alone, counts to u.
                full = None
                for row0, rows in ((0, R), (R - rows_loc, rows_loc)):
                    out = tuple(sentinel_like(x) for x in state)
                    u = zeros(1)
                    shard_launch(kern, algorithm, kw, state, out, streams, 0, row0, rows,
                                 u=u, acc=zeros(2), ctrl=zeros(2))
                    want, want_u = shard_plain(plain, algorithm, kw, state, streams, 0,
                                               row0, rows)
                    full = (want, want_u) if full is None else full
                    where = f"n={n} {name} {label} rows [{row0}, {row0 + rows})"
                    if int(u[0]) != int(want_u):
                        raise AssertionError(f"{where}: u {int(u[0])} != plain {int(want_u)}")
                    err = max(err, shard_bitwise(where, [p[row0:row0 + rows] for p in out],
                                                 want))
                    if rows < R:
                        shard_bitwise(f"{where}: rows outside",
                                      [torch.cat([p[:row0], p[row0 + rows:]]) for p in out],
                                      [sentinel_like(p[:R - rows]) for p in out])
                # The verdict in the launch.
                ctrl = zeros(2)
                out = tuple(torch.empty_like(x) for x in state)
                shard_launch(kern, algorithm, kw, state, out, streams, 0, 0, R, u=None,
                             acc=zeros(2), ctrl=ctrl, target=target)
                want_ctrl = [int(int(full[1]) >= target), 1]
                if ctrl.tolist() != want_ctrl:
                    raise AssertionError(f"n={n} {name} {label}: ctrl {ctrl.tolist()} != "
                                         f"{want_ctrl}")
                err = max(err, shard_bitwise(f"n={n} {name} {label} verdict", out, full[0]))
                print(f"  {name} {label} ({wire}): every row, the last shard's and the "
                      f"verdict bitwise, converged {int(full[1])}, ctrl {want_ctrl}",
                      flush=True)
            # From the converged state with the done flag set: nothing written.
            state = shard_planes(done, algorithm)
            out = tuple(sentinel_like(x) for x in state)
            ctrl = torch.tensor([1, done_round], dtype=torch.int32, device=dev)
            u = zeros(1)
            shard_launch(kern, algorithm, kw, state, out, shard_streams(key, done_round, 1,
                                                                        n, dev),
                         0, 0, R, u=None, acc=zeros(2), ctrl=ctrl, target=target)
            shard_bitwise(f"n={n} {name} done flag set", out,
                          [sentinel_like(x) for x in state])
            if ctrl.tolist() != [1, done_round]:
                raise AssertionError(f"n={n} {name}: a launch with the done flag set "
                                     f"changed ctrl to {ctrl.tolist()}")
            print(f"  {name} from the converged state (round {done_round}), done flag "
                  "set: nothing written", flush=True)
            # A chunk whose target is reached inside it: from 4 rounds before
            # the streaming pool tier's converged round.
            late_round = done_round - SHARD_CAP_CHUNK // 2
            late, ex = chunk(p2_kern, mid, mid_round, late_round - mid_round)
            state = shard_planes(late, algorithm)
            streams = shard_streams(key, late_round, SHARD_CAP_CHUNK, n, dev)
            plain_sets, counts = [state], []
            for i in range(SHARD_CAP_CHUNK):
                nxt, c = shard_plain(plain, algorithm, kw, plain_sets[-1], streams, i, 0, R)
                plain_sets.append(nxt)
                counts.append(int(c))
            stop = next(i + 1 for i, c in enumerate(counts) if c >= target)
            if stop != SHARD_CAP_CHUNK // 2:
                raise AssertionError(f"n={n} {name}: the plain rounds from round {late_round} "
                                     f"converge after {stop}, not at round {done_round}")
            sets = [tuple(x.clone() for x in state), tuple(sentinel_like(x) for x in state)]
            ctrl, acc = zeros(2), zeros(2)
            for i in range(SHARD_CAP_CHUNK):
                shard_launch(kern, algorithm, kw, sets[i % 2], sets[1 - i % 2], streams, i,
                             0, R, u=None, acc=acc, ctrl=ctrl, target=target)
            if ctrl.tolist() != [1, stop]:
                raise AssertionError(f"n={n} {name}: a chunk capped after {stop} rounds "
                                     f"left ctrl {ctrl.tolist()}")
            err = max(err, shard_bitwise(f"n={n} {name} capped chunk", sets[stop % 2],
                                         plain_sets[stop]))
            print(f"  {name} chunk of {SHARD_CAP_CHUNK} launches from round {late_round}, "
                  f"counts {counts[:stop]}: done after {stop} (round {done_round}), ctrl "
                  "and planes bitwise", flush=True)
            max_err[name] = max(max_err.get(name, 0.0), err)
            if (n, shards) == SHARD_TIMED:
                cases[name] = (kern, plain, algorithm, kw, shard_planes(mid, algorithm),
                               mid_round, n, R)
            del init, mid, done, late, plain_sets, sets
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err


def shard_path(dev, single):
    """Phase 14: the sharded path through run(devices=[card] * S), counters
    zeroed before each run and read after it: SHARD_RUNS, both algorithms,
    to convergence, each bitwise the single-device streaming pool run of
    phase 12 (rounds, converged count, every plane), push-sum mass
    conserved; every run queues no wire copy and no verdict launch (the
    verdict is in the launch); at SHARD_TIMED the launches are one a round
    and at most SHARD_MAX_LAUNCHES, and also gossip with the verdict not
    deferred, push-sum on the all_gather wire, and a resume from the
    converged gossip state (0 rounds, state unchanged). Returns each row's
    launches over its SHARD_TIMED run."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import sharded_tier
    from cop5615_gossip_protocol_tpu_torch.parallel import halo
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    counters = {"pushsum": p2s.pushsum_pool2_shard_round,
                "gossip": p2s.gossip_pool2_shard_round}
    launches = {}
    verdicts = []
    real_verdict = p2s.shard_verdict

    def counted_verdict(*args, **kw):
        verdicts.append(1)
        return real_verdict(*args, **kw)

    def drive(topo, cfg, shards, label, **kw):
        for fn in counters.values():
            fn.launches = 0
        halo.exchange_rows_batched.copies = 0
        verdicts.clear()
        res = run(topo, cfg, devices=[dev] * shards, **kw)
        counts = {k: fn.launches for k, fn in counters.items()}
        copies = halo.exchange_rows_batched.copies
        rounds, count, state = single[cfg.n, cfg.algorithm]
        print(json.dumps({
            "metric": f"{label}_pool2_sharded_full_n{cfg.n}_x{shards}",
            "wire": p2s.plan_pool2_sharded(topo, cfg, shards)[3],
            "overlap_collectives": cfg.overlap_collectives,
            "rounds": res.rounds, "single_device_rounds": rounds,
            "run_s": res.run_s, "rounds_per_s": res.rounds / max(res.run_s, 1e-9),
            "setup_s": res.setup_s, "compile_s": res.compile_s,
            "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s,
            "finalize_s": res.finalize_s, "chunks_retired": len(res.chunk_log),
            "converged_count": res.converged_count, "estimate_mae": res.estimate_mae,
            "launches": counts, "wire_copies": copies, "verdict_launches": len(verdicts),
            "device": res.device,
        }), flush=True)
        if not res.device.startswith("cuda"):
            raise AssertionError(f"{label} n={cfg.n} x{shards} did not run on the card")
        if "start_state" not in kw and counts[label] < res.rounds:
            raise AssertionError(f"{label} n={cfg.n} x{shards}: {counts[label]} launches "
                                 f"for {res.rounds} rounds")
        if copies or verdicts:
            raise AssertionError(f"{label} n={cfg.n} x{shards} on one card queued {copies} "
                                 f"wire copies and {len(verdicts)} verdict launches")
        if (res.rounds, res.converged_count) != (rounds, count) or not res.converged:
            raise AssertionError(
                f"{label} n={cfg.n} x{shards}: {res.rounds} rounds, {res.converged_count} "
                f"converged != the single-device run's {rounds}, {count}")
        for got, want in zip(res.state, state):
            got = got.cpu()
            same = (torch.equal(got.view(torch.int32), want.view(torch.int32))
                    if got.dtype == torch.float32 else torch.equal(got, want))
            if not same:
                raise AssertionError(f"{label} n={cfg.n} x{shards}: a final plane "
                                     "differs from the single-device run's")
        if cfg.algorithm == "push-sum":
            n = cfg.n
            err_w = abs(res.state.w.double().sum().item() - n) / n
            err_s = abs(res.state.s.double().sum().item() - n * (n - 1) / 2) / (n * (n - 1) / 2)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError(f"n={n} x{shards} push-sum did not conserve its mass")
        print(f"  {label} n={cfg.n:,} x{shards}: {res.rounds} rounds, bitwise the "
              f"single-device run, {counts[label]} launches, no wire copy, no verdict "
              "launch", flush=True)
        return res, counts

    p2s.shard_verdict = counted_verdict
    try:
        for n, shards in SHARD_RUNS:
            topo = build_topology("full", n)
            for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
                cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL,
                                n_devices=shards, engine="fused")
                if sharded_tier(topo, cfg) != ("pool2_sharded", None, "B13"):
                    raise AssertionError(f"n={n} x{shards}: the ladder picks "
                                         f"{sharded_tier(topo, cfg)}")
                res, counts = drive(topo, cfg, shards, name)
                if (n, shards) != SHARD_TIMED:
                    del res
                    continue
                if counts[name] > SHARD_MAX_LAUNCHES[name]:
                    raise AssertionError(f"{name} n={n} x{shards}: {counts[name]} launches, "
                                         f"more than {SHARD_MAX_LAUNCHES[name]}")
                launches[name] = counts[name]
                MAIN_ROUNDS[f"{name}_pool2_shard_round"] = res.rounds
                RUN_S[f"{name}_sharded"] = res.run_s
                if name == "gossip":
                    again, _ = drive(topo, cfg, shards, name, start_state=res.state,
                                     start_round=res.rounds)
                    if again.rounds != res.rounds:
                        raise AssertionError("a run from the converged state ran rounds")
                    drive(topo, dataclasses.replace(cfg, overlap_collectives=False), shards,
                          name)
                else:
                    drive(topo, dataclasses.replace(cfg, pool2_wire="all_gather"), shards,
                          name)
                del res
            torch.cuda.empty_cache()
    finally:
        p2s.shard_verdict = real_verdict
    return launches


# The sharded lattice compositions, every shard on the one card: the
# resident one (parallel/fused_sharded.py, row 15) and the streaming one
# (parallel/fused_hbm_sharded.py, rows 16-17). The kernel checks at (kind,
# n, shards), each the tier the ladder must pick, run one super-step on
# every shard from the initial state and from a mid-run state (the
# single-device run's planes after STENCIL_SHARD_MID rounds), of the plan's
# CR rounds or STENCIL_SHARD_ROUNDS when fewer; the timed super-steps are
# those at STENCIL_SHARD_TIMED, from the mid-run state.
STENCIL_SHARD_CASES = {
    "fused_sharded": (("torus3d", 1_000_000, 2), ("torus3d", 1_000_000, 4),
                      ("grid2d", 1_000_000, 2), ("ring", 131_072, 2)),
    "stencil_hbm_sharded": (("torus3d", 2**24, 2), ("torus3d", 2**24, 4),
                            ("torus3d", 215**3, 4), ("grid2d", 2**24, 4)),
}
STENCIL_SHARD_ROUNDS = 8
STENCIL_SHARD_MID = {"pushsum": 300, "gossip": 100}
STENCIL_SHARD_TIMED = {"fused_sharded": ("torus3d", 1_000_000, 2),
                       "stencil_hbm_sharded": ("torus3d", 2**24, 4)}
# The resident tier's runs: torus3d at phase 10's population.
STENCIL_SHARD_RUN_N = 1_000_000


def stencil_shard_case(dev, key, topo, kind, n, shards, algorithm, tier):
    """The tier's wrapper and keywords for one config, its geometry, and
    the global start and mid-run planes on the card (the single-device
    engine's, in the pool layout both use)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.models.runner import (
        fused_engine, fused_tier, sharded_tier)
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded as fh
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused",
                    n_devices=shards)
    if sharded_tier(topo, cfg) != (tier, None, {"fused_sharded": "B10",
                                                "stencil_hbm_sharded": "B11"}[tier]):
        raise AssertionError(f"{kind} n={n} x{shards} {algorithm}: the ladder picks "
                             f"{sharded_tier(topo, cfg)}")
    plan = (fs.vmem_tier if tier == "fused_sharded" else fh.hbm_tier)(topo, cfg, shards)
    kw = fs.protocol_kw(topo, cfg, plan.geom, plan.rolls)
    single = SimConfig(n=n, topology=kind, algorithm=algorithm)
    eng = fused_engine(topo, single, key, fused_tier(topo, single)[0])
    if eng.layout.rows != plan.geom.R:
        raise AssertionError(f"{kind} n={n}: layouts differ")
    init = tuple(p.contiguous().to(dev) for p in eng.planes)
    mid_round = STENCIL_SHARD_MID["pushsum" if algorithm == "push-sum" else "gossip"]
    mid, ex = eng.chunk(init, eng.streams(0, mid_round), 0, mid_round)
    if int(ex) != mid_round:
        raise AssertionError(f"{kind} n={n} {algorithm}: converged before {mid_round}")
    torch.cuda.synchronize()
    fn = plan.pushsum if algorithm == "push-sum" else plan.gossip
    return fn, kw, plan, init, mid, mid_round


# Every word of a shard's out and y planes before a checked super-step: the
# kernel and the plain version both start from it, so a write by either
# outside the windows shows in the bitwise comparison of every row of out.
SENTINEL = -0x3C3C3C3D


def sentinel_like(x):
    """A plane of x's shape and type whose every 32-bit word is SENTINEL."""
    import torch

    out = torch.empty_like(x)
    out.view(torch.int32).fill_(SENTINEL)
    return out


def shard_buffers(planes, geom, shards):
    """Per shard: its extended planes cut from the global ``planes`` (row
    r of shard s is global row (row0_s + r) mod R), its out and y planes
    filled with SENTINEL, and its mark, u, ctrl and bar buffers."""
    import torch

    dev = planes[0].device
    out = []
    for s in range(shards):
        rows = (geom.row0(s) + torch.arange(geom.rows_ext, device=dev)) % geom.R
        ext = tuple(p.index_select(0, rows).contiguous() for p in planes)
        out.append({
            "ext": ext, "out": tuple(sentinel_like(x) for x in ext),
            "y": tuple(sentinel_like(x) for x in ext),
            "mark": torch.empty(2 * geom.rows_ext * 128, dtype=torch.int8, device=dev),
            "u": torch.zeros(geom.cr + 1, dtype=torch.int32, device=dev),
            "ctrl": torch.zeros(2, dtype=torch.int32, device=dev),
            "bar": torch.zeros(2, dtype=torch.int32, device=dev),
        })
    return out


def lattice_shard_step(fn, kw, plan, bufs, keys, rounds):
    """One super-step's shard calls (no wire, no verdict) into each
    shard's out and u."""
    for s, b in enumerate(bufs):
        extra = {"bar": b["bar"]} if plan.barrier else {}
        fn(b["ext"], b["out"], b["y"], b["mark"], keys, rounds, plan.geom.row0(s),
           **kw, u=b["u"], ctrl=b["ctrl"], **extra)


def window_rows(kw, geom, shard, rounds):
    """Rows of shard ``shard``'s windows W_-1, W_0, ..., W_{rounds-1} in a
    ``rounds``-round super-step (csrc/shard.cuh's contract)."""
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    return [hi - lo for lo, hi in fs.shard_windows(
        kw["spec"], tuple(kw["rolls"]), geom, geom.row0(shard), rounds)]


def stencil_shard_checks(dev, key, tier):
    """Phases 14a (the resident tier) and 14b (the streaming tier): each
    shard kernel against its plain version on the card, one super-step on
    every shard from the initial and the mid-run state at each of
    STENCIL_SHARD_CASES[tier], out and y filled with SENTINEL first for
    both; every row of every out plane and every shard's u bitwise. Returns
    the timed case's operands {name: ...} and {name: max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import build_topology
    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    cases, max_err = {}, {}
    for kind, n, shards in STENCIL_SHARD_CASES[tier]:
        t0 = time.perf_counter()
        topo = build_topology(kind, n)
        print(f"{tier} shard kernels vs plain versions at {kind} n = {topo.n:,}, "
              f"{shards} shards (built in {time.perf_counter() - t0:.2f} s):", flush=True)
        for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
            fn, kw, plan, init, mid, mid_round = stencil_shard_case(
                dev, key, topo, kind, n, shards, algorithm, tier)
            geom = plan.geom
            rounds = min(geom.cr, STENCIL_SHARD_ROUNDS)
            for label, state, rnd in (("init", init, 0), ("mid-run", mid, mid_round)):
                bufs = shard_buffers(state, geom, shards)
                keys = fused.round_keys(key, rnd, rounds).to(dev)
                lattice_shard_step(fn, kw, plan, bufs, keys, rounds)
                err = 0.0
                for s, b in enumerate(bufs):
                    # The plain version from the same SENTINEL out and y.
                    want = tuple(sentinel_like(x) for x in b["ext"])
                    want_y = tuple(sentinel_like(x) for x in b["ext"])
                    want_u = fs.shard_superstep_plain(b["ext"], want, want_y, keys, rounds,
                                                      geom.row0(s), **kw)
                    if not torch.equal(b["u"].cpu(), want_u):
                        raise AssertionError(f"{kind} n={n} x{shards} {name} {label} shard "
                                             f"{s}: u {b['u'].tolist()} != plain "
                                             f"{want_u.tolist()}")
                    for got, exp in zip(b["out"], want):
                        if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
                            raise AssertionError(f"{kind} n={n} x{shards} {name} {label} "
                                                 f"shard {s}: a plane differs from plain")
                        if got.dtype == torch.float32:
                            err = max(err, (got - exp).abs().max().item())
                    del want, want_y
                # Each shard's W_-1 and its mean window over the rounds, in rows.
                wins = [window_rows(kw, geom, s, rounds) for s in range(shards)]
                print(f"  {name} {label} (H {geom.H}, CR {geom.cr}, {rounds} rounds; "
                      f"rows_ext {geom.rows_ext}, middle {geom.rows_loc}, windows W_-1 / "
                      f"mean a round {[(w[0], round(sum(w[1:]) / rounds, 1)) for w in wins]}"
                      f"): every shard bitwise on every row of out and u, middle converged "
                      f"{sum(int(b['u'][rounds - 1]) for b in bufs)}, max_abs_err {err}",
                      flush=True)
                max_err[name] = max(max_err.get(name, 0.0), err)
                if STENCIL_SHARD_TIMED[tier] == (kind, n, shards) and label == "mid-run":
                    cases[name] = (fn, kw, plan, bufs, keys, rounds, len(topo.offsets))
                else:
                    del bufs
            del init, mid
        del topo
        fs._shard_slots.cache_clear()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err


def stencil_shard_path(dev, single):
    """Phase 14c: the sharded lattice path through run(devices=[card] * S),
    counters zeroed before each run and read after it. torus3d 1,000,000
    gossip and push-sum in 2 and 4 shards (the resident tier) to
    convergence, each at the JAX schedule's first super-step boundary at or
    after phase 10's single-device round, push-sum with its mass
    conserved; gossip at chunk_rounds=1 bitwise phase 10's run (rounds,
    converged count, every plane); gossip x4 with the verdict not deferred
    equal to the deferred run, and a resume from the converged gossip state
    (0 rounds, state unchanged); torus3d 2**24 gossip in 4 shards (the
    streaming tier) to convergence against phase 6's round; torus3d 215**3
    push-sum in 4 shards, LATTICE_PS_ROUNDS rounds at chunk_rounds=1 and
    at the default (super-steps of CR 32, the main-path run whose launches
    row 16 counts), each bitwise phase 6's sample and conserving its mass.
    Returns each kernel's launches over its main-path run."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import sharded_tier
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded as fh
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs
    from cop5615_gossip_protocol_tpu_torch.parallel import overlap

    counters = {("pushsum", "fused_sharded"): fs.pushsum_stencil_shard_superstep,
                ("gossip", "fused_sharded"): fs.gossip_stencil_shard_superstep,
                ("pushsum", "stencil_hbm_sharded"): fh.pushsum_stencil_hbm_shard_superstep,
                ("gossip", "stencil_hbm_sharded"): fh.gossip_stencil_hbm_shard_superstep}
    launches = {}

    def boundary(rounds, cr, stride, start=0):
        b = start
        while b < rounds:
            b = overlap.next_boundary(b, start, stride, cr, 10**9)
        return b

    def drive(topo, cfg, label, want, **kw):
        for fn in counters.values():
            fn.launches = 0
        tier, _, _ = sharded_tier(topo, cfg)
        plan = (fs.vmem_tier if tier == "fused_sharded" else fh.hbm_tier)(
            topo, cfg, cfg.n_devices)
        res = run(topo, cfg, devices=[dev] * cfg.n_devices, **kw)
        counts = {f"{k[0]}_{k[1]}": fn.launches for k, fn in counters.items()}
        rounds, count, state = want
        start = kw.get("start_round", 0)
        expect = (rounds if cfg.max_rounds <= rounds
                  else boundary(rounds, plan.geom.cr, plan.stride, start))
        print(json.dumps({
            "metric": f"{label}_{tier}_{cfg.topology}_n{cfg.n}_x{cfg.n_devices}",
            "H": plan.geom.H, "cr": plan.geom.cr, "stride": plan.stride,
            "overlap_collectives": cfg.overlap_collectives,
            "rounds": res.rounds, "single_device_rounds": rounds,
            "expected_rounds": expect, "run_s": res.run_s,
            "rounds_per_s": res.rounds / max(res.run_s, 1e-9),
            "setup_s": res.setup_s, "compile_s": res.compile_s,
            "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s,
            "finalize_s": res.finalize_s, "chunks_retired": len(res.chunk_log),
            "converged_count": res.converged_count, "estimate_mae": res.estimate_mae,
            "launches": counts, "device": res.device,
        }), flush=True)
        if not res.device.startswith("cuda"):
            raise AssertionError(f"{label} n={cfg.n} x{cfg.n_devices} did not run on the card")
        if "start_state" not in kw and counts[f"{label}_{tier}"] == 0:
            raise AssertionError(f"{label} n={cfg.n} never launched its {tier} kernel")
        if res.rounds != expect or not rounds <= res.rounds <= rounds + plan.geom.cr:
            raise AssertionError(f"{label} n={cfg.n} x{cfg.n_devices}: {res.rounds} rounds, "
                                 f"not the boundary {expect} after {rounds}")
        if res.rounds == rounds:
            if res.converged_count != count:
                raise AssertionError(f"{label} n={cfg.n}: converged {res.converged_count} "
                                     f"!= {count}")
            for got, exp in zip(res.state, state):
                got = got.cpu()
                same = (torch.equal(got.view(torch.int32), exp.view(torch.int32))
                        if got.dtype == torch.float32 else torch.equal(got, exp))
                if not same:
                    raise AssertionError(f"{label} n={cfg.n} x{cfg.n_devices}: a final "
                                         "plane differs from the single-device run's")
        if cfg.algorithm == "push-sum":
            n = cfg.n
            err_w = abs(res.state.w.double().sum().item() - n) / n
            err_s = abs(res.state.s.double().sum().item() - n * (n - 1) / 2) / (
                n * (n - 1) / 2)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError(f"{label} n={n} x{cfg.n_devices} lost mass")
        print(f"  {label} {cfg.topology} n={cfg.n:,} x{cfg.n_devices} ({tier}, CR "
              f"{plan.geom.cr}): {res.rounds} rounds (single-device {rounds})"
              + (", bitwise the single-device run" if res.rounds == rounds else ""),
              flush=True)
        return res, counts

    topo = build_topology("torus3d", STENCIL_SHARD_RUN_N)
    for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
        want = single["resident"][STENCIL_SHARD_RUN_N, algorithm]
        for shards in (2, 4):
            cfg = SimConfig(n=STENCIL_SHARD_RUN_N, topology="torus3d", algorithm=algorithm,
                            engine="fused", n_devices=shards)
            res, counts = drive(topo, cfg, name, want)
            if (name, shards) == ("gossip", 2):
                launches["gossip", "fused_sharded"] = counts["gossip_fused_sharded"]
                MAIN_ROUNDS["gossip_fused_sharded_superstep"] = res.rounds
                again, _ = drive(topo, cfg, name, (res.rounds, res.converged_count,
                                                   tuple(x.cpu() for x in res.state)),
                                 start_state=res.state, start_round=res.rounds)
                if again.rounds != res.rounds:
                    raise AssertionError("a run from the converged state ran rounds")
                drive(topo, dataclasses.replace(cfg, chunk_rounds=1), name, want)
            if (name, shards) == ("pushsum", 2):
                launches["pushsum", "fused_sharded"] = counts["pushsum_fused_sharded"]
                MAIN_ROUNDS["pushsum_fused_sharded_superstep"] = res.rounds
            if (name, shards) == ("gossip", 4):
                serial, _ = drive(topo, dataclasses.replace(cfg, overlap_collectives=False),
                                  name, want)
                if serial.rounds != res.rounds:
                    raise AssertionError("the verdict's schedule changed the rounds")
            del res
    del topo
    topo = build_topology("torus3d", LATTICE_N)
    cfg = SimConfig(n=LATTICE_N, topology="torus3d", algorithm="gossip", engine="fused",
                    n_devices=4)
    res, counts = drive(topo, cfg, "gossip", single["lattice"][LATTICE_N, "gossip"])
    launches["gossip", "stencil_hbm_sharded"] = counts["gossip_stencil_hbm_sharded"]
    MAIN_ROUNDS["gossip_stencil_hbm_sharded_superstep"] = res.rounds
    del topo
    topo = build_topology("torus3d", LATTICE_PS_N)
    cfg = SimConfig(n=LATTICE_PS_N, topology="torus3d", algorithm="push-sum",
                    engine="fused", n_devices=4, max_rounds=LATTICE_PS_ROUNDS)
    want = single["lattice"][LATTICE_PS_N, "push-sum"]
    drive(topo, dataclasses.replace(cfg, chunk_rounds=1), "pushsum", want)
    res, counts = drive(topo, cfg, "pushsum", want)
    launches["pushsum", "stencil_hbm_sharded"] = counts["pushsum_stencil_hbm_sharded"]
    MAIN_ROUNDS["pushsum_stencil_hbm_sharded_superstep"] = res.rounds
    del res
    del topo
    torch.cuda.empty_cache()
    return launches


def stencil_shard_rows(cases, launches, max_err):
    """Rows 15-17 of the kernels line: one super-step (every shard's call)
    at STENCIL_SHARD_TIMED from the mid-run state (``cases``, phases
    14a-14b), the ring wire's copies timed apart, each beside its plain
    version and its bound on the windows' slot-rounds."""
    from cop5615_gossip_protocol_tpu_torch.parallel import halo
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    rows = []
    replaces = {
        ("pushsum", "fused_sharded"):
            "cop5615_gossip_protocol_tpu/parallel/fused_sharded.py:448",
        ("gossip", "fused_sharded"):
            "cop5615_gossip_protocol_tpu/parallel/fused_sharded.py:448",
        ("pushsum", "stencil_hbm_sharded"):
            "cop5615_gossip_protocol_tpu/parallel/fused_hbm_sharded.py:773",
        ("gossip", "stencil_hbm_sharded"):
            "cop5615_gossip_protocol_tpu/parallel/fused_hbm_sharded.py:1069"}
    sources = {"fused_sharded": "csrc/fused_stencil_shard.cu",
               "stencil_hbm_sharded": "csrc/fused_stencil_hbm_shard.cu"}
    for tier in ("fused_sharded", "stencil_hbm_sharded"):
        for name in ("pushsum", "gossip"):
            algo = "push-sum" if name == "pushsum" else "gossip"
            fn, kw, plan, bufs, keys, rounds, classes = cases[tier][name]
            ms, _ = time_ms(lambda: lattice_shard_step(fn, kw, plan, bufs, keys, rounds),
                            TIME_REPS)
            wire = halo.ring_exchange([b["ext"] for b in bufs], plan.geom.H,
                                      plan.geom.rows_loc)
            wire_ms, _ = time_ms(lambda: halo.exchange_rows_batched(wire), TIME_REPS)
            plain_ms, _ = time_ms(lambda: [
                fs.shard_superstep_plain(b["ext"], b["out"], b["y"], keys, rounds,
                                         plan.geom.row0(s), **kw)
                for s, b in enumerate(bufs)], 2)
            kind, n, shards = STENCIL_SHARD_TIMED[tier]
            moved, ops = stencil_shard_bound(kw, plan, shards, rounds, algo, classes,
                                             tier == "fused_sharded")
            bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
            rows.append({
                "name": f"{name}_{tier}_superstep", "route": "cuda",
                "source": f"cop5615_gossip_protocol_tpu_torch/{sources[tier]}",
                "replaces": replaces[name, tier],
                "launches": launches[name, tier],
                "max_abs_err": max_err[tier][name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None, "rounds_per_call": rounds,
                "us_per_round": ms * 1e3 / rounds, "shards": shards, "H": plan.geom.H,
                "cr": plan.geom.cr, "window_rows": [window_rows(kw, plan.geom, s, rounds)
                                                    for s in range(shards)],
                "wire_ms": wire_ms, "population": n,
                "topology": kind, "status": "ported",
            })
            del wire
            fs._shard_slots.cache_clear()
    return rows


# The imp x HBM x sharded composition (parallel/fused_imp_hbm_sharded.py,
# rows 18-19), its shards all on the one card: the kernel checks at (kind,
# n, shards, pool_size), each the composition the ladder must pick, one
# round on every shard from the initial state, from a mid-run state (the
# single-device run's planes after IMP_MID rounds) and from a converged
# state; imp3d 520**3 (past the single-device cap) from the initial state;
# the card-vs-CPU runs at IMP_CPU_N, IMP_SHARD_ROUNDS rounds; the timed
# round at IMP_SHARD_TIMED from the mid-run state.
IMP_SHARD_CASES = (("imp3d", 1_000_000, 2, IMP_POOL), ("imp2d", 2**24, 4, IMP_POOL),
                   ("imp3d", 2**24, 4, IMP_POOL), ("imp3d", 1_000_000, 2, 16))
IMP_SHARD_BIG = 520**3
IMP_SHARD_RUN_N = 2**24
IMP_SHARD_ROUNDS = 64
IMP_SHARD_TIMED = ("imp3d", 2**24, 4)
# The JAX package's imp3d 16,777,216 round records (BENCH_TABLES.md:192-193),
# printed beside the card's, not asserted: the push-sum record comes from the
# TPU kernels, whose float32 op order differs from the chunked engine's.
JAX_IMP_RECORDS = {"gossip": 69, "push-sum": 867}


@functools.lru_cache(maxsize=2)
def imp_topology(kind, n):
    """One build of each imp topology the sharded imp phases share (imp3d
    520**3 takes the host tens of seconds and gigabytes)."""
    from cop5615_gossip_protocol_tpu_torch import build_topology

    t0 = time.perf_counter()
    topo = build_topology(kind, n)
    print(f"  built {kind} n = {topo.n:,} in {time.perf_counter() - t0:.2f} s", flush=True)
    return topo


def imp_shard_streams(key, rnd, pool, n):
    """Round rnd's key, pool offsets and choice key, as the run draws them,
    and round rnd + 1's key and choice key, whose marks rnd's absorbs write
    (the run draws its streams one round past each chunk)."""
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_pool

    keys = fused.round_keys(key, rnd, 2).tolist()
    ckeys = fused_imp.choice_round_keys(key, rnd, 2).tolist()
    return ((keys[0], fused_pool.round_offsets(key, rnd, 1, pool, n)[0].tolist(), ckeys[0]),
            (keys[1], ckeys[1]))


def imp_shard_buffers(state, rows_loc, shards, pushsum):
    """The run's operands of one round of every shard from the global
    ``state`` on the card (parallel/fused_imp_hbm_sharded.ShardRound each):
    the two mark planes, push-sum's global (s, w) in (a copy) and out, and
    per shard its own planes in and out and its u, acc and ctrl."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    dev, R = state[0].device, state[0].shape[0]
    n_glob = 2 if pushsum else 0
    mark, nxt = torch.empty(2, R, 128, dtype=torch.int8, device=dev).unbind(0)
    glob_in = tuple(x.clone() for x in state[:n_glob])
    glob_out = tuple(torch.empty_like(x) for x in glob_in)
    out = []
    for s in range(shards):
        own = tuple(p[s * rows_loc:(s + 1) * rows_loc].contiguous() for p in state[n_glob:])
        out.append(ih.ShardRound(
            s * rows_loc, mark, nxt, glob_in, glob_out, own,
            tuple(torch.empty_like(x) for x in own),
            *(torch.zeros(k, dtype=torch.int32, device=dev) for k in (1, 2, 2))))
    return out


def imp_shard_next(bufs):
    """The operands of the round after ``bufs``' round, as the run's
    ping/pong sets give them: the mark planes and the plane sets swapped
    (its inputs are the round's outputs, its next marks overwrite the
    round's input marks), the same u, acc and ctrl."""
    return [sh._replace(mark=sh.next, next=sh.mark, glob_in=sh.glob_out,
                        glob_out=sh.glob_in, own_in=sh.own_out, own_out=sh.own_in)
            for sh in bufs]


def imp_shard_state(bufs, pushsum):
    """The global state [R, 128] planes a round of ``bufs`` wrote."""
    import torch

    own = [torch.cat([sh.own_out[p] for sh in bufs]) for p in range(len(bufs[0].own_out))]
    return (tuple(bufs[0].glob_out) if pushsum else ()) + tuple(own)


def imp_shard_checks(dev, key):
    """Phase 14d: each kernel of the sharded imp composition against its
    plain version on the card, queued as the run queues them (every
    shard's mark prologue, then every shard's absorb, which writes the next
    round's marks from the stream drawn one round ahead), at
    IMP_SHARD_CASES from the initial, a mid-run and a converged state, and
    at imp3d IMP_SHARD_BIG in 4 shards from the initial state: every
    shard's planes and u and the next round's mark plane bitwise; then a
    second round from the kernels' own state and next marks, as the first
    round of the next chunk runs, against two plain rounds. Returns the
    timed case's operands {name: ...} and {name: max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, sharded_tier
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    def bitwise(got, want):
        return (torch.equal(got.view(torch.int32), want.view(torch.int32))
                if got.dtype == torch.float32 else torch.equal(got, want))

    cases, max_err = {}, {}
    for kind, n, shards, pool in IMP_SHARD_CASES + (("imp3d", IMP_SHARD_BIG, 4, IMP_POOL),):
        print(f"sharded imp kernels vs plain versions at {kind} n = {n:,}, {shards} "
              f"shards, pool_size {pool}:", flush=True)
        topo = imp_topology(kind, n)
        for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
            if pool == 16 and name == "gossip":
                continue  # the packed-choice cap: push-sum
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                            pool_size=pool, engine="fused", n_devices=shards)
            if sharded_tier(topo, cfg) != ("imp_hbm_sharded", None, "B12"):
                raise AssertionError(f"{kind} n={n} x{shards} {algorithm}: the ladder "
                                     f"picks {sharded_tier(topo, cfg)}")
            H, rows_loc, PT, layout = ih.plan_imp_hbm_sharded(topo, cfg, shards)
            pushsum = algorithm == "push-sum"
            kw = ih.absorb_kw(topo, cfg)
            row_los = range(0, layout.rows, rows_loc)
            single = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                               pool_size=pool)
            eng = fused_engine(topo, single, key, "imp_hbm")
            states = [("init", tuple(p.contiguous().to(dev) for p in eng.planes), 0)]
            if n != IMP_SHARD_BIG:
                mid_round = IMP_MID[name]
                mid, ex = eng.chunk(states[0][1], eng.streams(0, mid_round), 0, mid_round)
                done, ex2 = eng.chunk(mid, eng.streams(mid_round, 4096), mid_round,
                                      mid_round + 4096)
                if int(ex) != mid_round or int(ex2) == 4096:
                    raise AssertionError(f"{kind} n={n} {algorithm}: no mid-run state")
                states += [("mid-run", mid, mid_round),
                           ("converged", done, mid_round + int(ex2))]

            def plain_round(state, stream):
                """One plain round of every shard: the global planes it
                writes and every shard's u."""
                out = ih.imp_hbm_shards_round_plain(state, stream, rows_loc, row_los,
                                                    pushsum=pushsum, **kw)
                planes = tuple(torch.cat([o[0][p] for o in out]) for p in range(len(state)))
                return planes, [int(u) for _, u in out]

            def check(label, bufs, want, want_u, want_next):
                err = 0.0
                got = imp_shard_state(bufs, pushsum)
                for g, w in zip(got, want):
                    if not bitwise(g, w):
                        raise AssertionError(f"{kind} n={n} x{shards} {name} {label}: a "
                                             "plane differs from plain")
                    if g.dtype == torch.float32:
                        if not torch.isfinite(g).all():
                            raise AssertionError(f"{kind} n={n} {name}: not finite")
                        err = max(err, (g - w).abs().max().item())
                got_u = [int(sh.u) for sh in bufs]
                if got_u != want_u:
                    raise AssertionError(f"{kind} n={n} x{shards} {name} {label}: u {got_u}"
                                         f" != plain {want_u}")
                if not torch.equal(bufs[0].next, want_next):
                    raise AssertionError(f"{kind} n={n} x{shards} {name} {label}: the next "
                                         "round's marks differ from plain")
                return err, sum(got_u)

            for label, state, rnd in states:
                stream, nxt = imp_shard_streams(key, rnd, pool, topo.n)
                stream2, nxt2 = imp_shard_streams(key, rnd + 1, pool, topo.n)
                want, want_u = plain_round(state, stream)

                def next_marks(planes, keys):
                    return torch.cat([ih.shard_marks_plain(
                        kw["spec"], *keys, pool, lo, rows_loc,
                        None if pushsum else planes[1][lo:lo + rows_loc], dev)
                        for lo in row_los])

                bufs = imp_shard_buffers(state, rows_loc, shards, pushsum)
                ih.mark_shards(bufs, stream[0], stream[2], rows_loc, pushsum=pushsum,
                               spec=kw["spec"], pool_size=pool)
                ih.launch_shard_rounds(bufs, stream, nxt, pushsum=pushsum, kw=kw)
                err, total = check(label, bufs, want, want_u, next_marks(want, nxt))
                # The next chunk's first round: no prologue, the marks the
                # last round wrote from the stream drawn one round ahead.
                want2, want2_u = plain_round(want, stream2)
                bufs2 = imp_shard_next(bufs)
                ih.launch_shard_rounds(bufs2, stream2, nxt2, pushsum=pushsum, kw=kw)
                err2, _ = check(f"{label}, second round", bufs2, want2, want2_u,
                                next_marks(want2, nxt2))
                del bufs, bufs2, want, want2
                print(f"  {name} {label} (round {rnd}, and {rnd + 1} from its next marks; "
                      f"H {H}, rows_loc {rows_loc}, PT {PT}): every shard and the next "
                      f"marks bitwise, converged {total}, max_abs_err {max(err, err2)}",
                      flush=True)
                row = f"{name}_imp_hbm_sharded"
                max_err[row] = max(max_err.get(row, 0.0), err, err2)
                if (kind, n, shards) == IMP_SHARD_TIMED and label == "mid-run":
                    cases[row] = (state, stream, nxt, rows_loc, shards, kw, pushsum,
                                  len(kw["spec"].classes), pool, layout)
            del states, eng
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err


def imp_shard_path(dev, single):
    """Phase 14e: the sharded imp path through run(devices=[card] * S),
    counters zeroed before each run and read after it: imp3d IMP_SHARD_BIG
    in 4 shards, gossip to convergence and a push-sum sample of
    IMP_SHARD_ROUNDS rounds conserving its mass; imp3d IMP_SHARD_RUN_N
    gossip and push-sum in 4 shards to convergence, each bitwise phase 8's
    single-device run (rounds, converged count, every plane); imp3d
    IMP_CPU_N in 2 shards, both algorithms, IMP_SHARD_ROUNDS rounds, the
    card against the CPU's run of the same shards. Returns each row's
    launches (marks and absorbs) over its IMP_SHARD_RUN_N run."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, run
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    counters = {"mark": ih.imp_hbm_shard_mark,
                "pushsum": ih.pushsum_imp_hbm_shard_absorb,
                "gossip": ih.gossip_imp_hbm_shard_absorb}
    launches = {}

    def same_state(a, b):
        return all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(a, b))

    def drive(n, algorithm, shards, devices, **kw):
        for fn in counters.values():
            fn.launches = 0
        cfg = SimConfig(n=n, topology="imp3d", algorithm=algorithm, delivery="pool",
                        pool_size=IMP_POOL, engine="fused", n_devices=shards, **kw)
        res = run(imp_topology("imp3d", n), cfg, devices=devices)
        counts = {k: fn.launches for k, fn in counters.items()}
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        print(json.dumps({
            "metric": f"{name}_imp_hbm_sharded_imp3d_n{n}_x{shards}",
            "rounds": res.rounds, "run_s": res.run_s,
            "rounds_per_s": res.rounds / max(res.run_s, 1e-9),
            "setup_s": res.setup_s, "compile_s": res.compile_s,
            "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s,
            "finalize_s": res.finalize_s, "chunks_retired": len(res.chunk_log),
            "converged_count": res.converged_count, "estimate_mae": res.estimate_mae,
            "launches": counts, "device": res.device,
        }), flush=True)
        # One absorb a shard a round queued (the chunks' rounds, a no-op
        # once the run is done) and the mark prologue once a shard.
        if devices[0] != "cpu" and (counts["mark"] != shards or counts[name] == 0
                                    or counts[name] % shards):
            raise AssertionError(f"imp3d n={n} x{shards} {algorithm} queued {counts}: not "
                                 f"{shards} prologue launches and {shards} a round")
        if algorithm == "push-sum":
            err_w = abs(res.state.w.double().sum().item() - n) / n
            err_s = abs(res.state.s.double().sum().item() - n * (n - 1) / 2) / (
                n * (n - 1) / 2)
            print(f"  mass: sum w rel err {err_w}, sum s rel err {err_s}", flush=True)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError(f"imp3d n={n} x{shards} push-sum lost mass")
        return res, counts

    # imp3d IMP_SHARD_BIG first, while phase 14d's build of it is cached.
    res, _ = drive(IMP_SHARD_BIG, "gossip", 4, [dev] * 4)
    if not res.converged or res.converged_count != IMP_SHARD_BIG:
        raise AssertionError(f"imp3d {IMP_SHARD_BIG} x4 gossip did not converge")
    print(f"  gossip imp3d n={IMP_SHARD_BIG:,} x4 (past the single-device cap): converged "
          f"in {res.rounds} rounds", flush=True)
    del res
    drive(IMP_SHARD_BIG, "push-sum", 4, [dev] * 4, max_rounds=IMP_SHARD_ROUNDS)
    imp_topology.cache_clear()
    for name, algorithm in (("gossip", "gossip"), ("pushsum", "push-sum")):
        rounds, count, state = single[IMP_SHARD_RUN_N, algorithm]
        res, counts = drive(IMP_SHARD_RUN_N, algorithm, 4, [dev] * 4)
        if (res.rounds, res.converged_count) != (rounds, count) or not same_state(
                res.state, state):
            raise AssertionError(f"imp3d {IMP_SHARD_RUN_N} x4 {algorithm}: {res.rounds} "
                                 f"rounds, not bitwise phase 8's run of {rounds}")
        print(f"  {name} imp3d n={IMP_SHARD_RUN_N:,} x4: {res.rounds} rounds (JAX record "
              f"{JAX_IMP_RECORDS[algorithm]}), bitwise phase 8's single-device run",
              flush=True)
        launches[name] = counts["mark"] + counts[name]
        MAIN_ROUNDS[f"{name}_imp_hbm_shard_round"] = res.rounds
        if name == "gossip":
            # The verdict not deferred: round r + 1 no longer runs ahead of
            # round r's verdict, and nothing may change.
            ser, _ = drive(IMP_SHARD_RUN_N, algorithm, 4, [dev] * 4,
                           overlap_collectives=False)
            if (ser.rounds, ser.converged_count) != (rounds, count) or not same_state(
                    ser.state, state):
                raise AssertionError(f"imp3d {IMP_SHARD_RUN_N} x4 gossip, verdict not "
                                     "deferred: not bitwise phase 8's run")
            # A resume from the converged state: its prologue and rounds do
            # nothing.
            cfg = SimConfig(n=IMP_SHARD_RUN_N, topology="imp3d", algorithm=algorithm,
                            delivery="pool", pool_size=IMP_POOL, engine="fused",
                            n_devices=4)
            again = run(imp_topology("imp3d", IMP_SHARD_RUN_N), cfg, devices=[dev] * 4,
                        start_state=res.state, start_round=res.rounds)
            if again.rounds != res.rounds or not again.converged or not same_state(
                    again.state, state):
                raise AssertionError(f"imp3d {IMP_SHARD_RUN_N} x4 gossip resumed from its "
                                     f"converged state ran ({again.rounds} rounds)")
            print(f"  gossip imp3d n={IMP_SHARD_RUN_N:,} x4, verdict not deferred: bitwise "
                  f"the deferred run; resumed from its converged state: 0 rounds, state "
                  f"unchanged", flush=True)
            del ser, again
        del res
    imp_topology.cache_clear()
    for algorithm in ("gossip", "push-sum"):
        t0 = time.perf_counter()
        a, _ = drive(IMP_CPU_N, algorithm, 2, [dev] * 2, max_rounds=IMP_SHARD_ROUNDS)
        t1 = time.perf_counter()
        b, _ = drive(IMP_CPU_N, algorithm, 2, ["cpu"] * 2, max_rounds=IMP_SHARD_ROUNDS)
        t2 = time.perf_counter()
        if (a.rounds, a.converged_count) != (b.rounds, b.converged_count) or not same_state(
                a.state, b.state):
            raise AssertionError(f"50**3 x2 {algorithm}: the card's run differs from the "
                                 "CPU's")
        print(f"  {algorithm} imp3d n={IMP_CPU_N:,} x2: card == CPU, {a.rounds} rounds, "
              f"converged {a.converged_count} ({t1 - t0:.2f} s card, {t2 - t1:.2f} s CPU)",
              flush=True)
    imp_topology.cache_clear()
    torch.cuda.empty_cache()
    return launches


def imp_shard_rows(dev, cases, launches, max_err):
    """Rows 18-19 of the kernels line: one round of every shard (each
    shard's absorb, which writes the next round's marks, as the run queues
    a round) at IMP_SHARD_TIMED from the mid-run state by CUDA events,
    beside the plain versions' time and the bound. With every shard on one
    card the wire copies nothing, so the rows time none: ``--cards`` times
    it across cards."""
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    rows = []
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/parallel/fused_imp_hbm_sharded.py:678",
                "gossip": "cop5615_gossip_protocol_tpu/parallel/fused_imp_hbm_sharded.py:939"}
    for name in ("pushsum", "gossip"):
        algo = "push-sum" if name == "pushsum" else "gossip"
        row = f"{name}_imp_hbm_sharded"
        (state, stream, nxt, rows_loc, shards, kw, pushsum, lattice, pool,
         layout) = cases[row]
        bufs = imp_shard_buffers(state, rows_loc, shards, pushsum)
        ih.mark_shards(bufs, stream[0], stream[2], rows_loc, pushsum=pushsum,
                       spec=kw["spec"], pool_size=pool)
        ms, _ = time_ms(lambda: ih.launch_shard_rounds(bufs, stream, nxt, pushsum=pushsum,
                                                       kw=kw), TIME_REPS)
        plain_ms, _ = time_ms(lambda: ih.imp_hbm_shards_round_plain(
            state, stream, rows_loc, range(0, layout.rows, rows_loc), pushsum=pushsum,
            **kw), 2)
        n_pad = layout.n_pad
        # Each shard's state read and written once and the round's streams.
        moved = STATE_BYTES[name] * n_pad + 16 + 4 * pool + 16
        ops = n_pad * imp_ops_per_node(algo, lattice + pool)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{name}_imp_hbm_shard_round", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_imp_hbm_shard.cu",
            "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": max_err[row],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "rounds_per_call": 1, "us_per_round": ms * 1e3,
            "shards": shards, "population": IMP_SHARD_TIMED[1],
            "topology": IMP_SHARD_TIMED[0], "status": "ported",
        })
        del bufs
    return rows


def imp_shard_cards(cards):
    """``--cards N``: the sharded imp path with shard i on cuda:i (the CLI's
    ``--devices N``), imp3d IMP_SHARD_RUN_N gossip and push-sum to
    convergence, each bitwise the same run with every shard on cuda:0 and
    the single-device run on cuda:0; and the wire alone (each shard's rows
    of the mark plane and push-sum's s and w into every other card's copy),
    median of TIME_REPS by the host clock around the copies and a
    synchronize of every card."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, run
    from cop5615_gossip_protocol_tpu_torch.parallel import halo

    topo = imp_topology("imp3d", IMP_SHARD_RUN_N)
    devices = [torch.device("cuda", i) for i in range(cards)]

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    for algorithm in ("gossip", "push-sum"):
        cfg = SimConfig(n=IMP_SHARD_RUN_N, topology="imp3d", algorithm=algorithm,
                        delivery="pool", pool_size=IMP_POOL, engine="fused",
                        n_devices=cards)
        single = run(topo, dataclasses.replace(cfg, n_devices=None))
        one = run(topo, cfg, devices=[devices[0]] * cards)
        spread = run(topo, cfg)
        same = all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x.cpu(), y.cpu())
                   for a in (one, single) for x, y in zip(spread.state, a.state))
        print(json.dumps({
            "metric": f"{algorithm}_imp_hbm_sharded_imp3d_n{IMP_SHARD_RUN_N}_x{cards}_cards",
            "rounds": spread.rounds, "one_card_rounds": one.rounds,
            "single_device_rounds": single.rounds, "run_s": spread.run_s,
            "one_card_run_s": one.run_s, "single_device_run_s": single.run_s,
            "dispatch_s": spread.dispatch_s, "fetch_s": spread.fetch_s,
            "converged_count": spread.converged_count,
            "estimate_mae": spread.estimate_mae, "bitwise_one_card_and_single": same,
            "device": spread.device}), flush=True)
        if not spread.rounds == one.rounds == single.rounds or not same:
            raise AssertionError(f"{algorithm} on {cards} cards differs from one card")
        rows_loc = -(-IMP_SHARD_RUN_N // 128) // cards
        planes_of = {d: (torch.zeros(rows_loc * cards, 128, dtype=torch.int8, device=d),)
                     + (tuple(torch.zeros(rows_loc * cards, 128, device=d) for _ in range(2))
                        if algorithm == "push-sum" else ()) for d in devices}
        wire = halo.replica_rows(planes_of, rows_loc, devices)
        times = []
        for _ in range(TIME_REPS + 1):
            sync()
            t0 = time.perf_counter()
            halo.exchange_rows_batched(wire)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"metric": f"{algorithm}_imp_wire_ms_x{cards}_cards",
                          "wire_ms": statistics.median(times[1:]),
                          "bytes_per_card": (cards - 1) * rows_loc * 128 * (
                              9 if algorithm == "push-sum" else 1)}), flush=True)
        del planes_of, wire


def pool2_shard_cards(cards):
    """``--cards N``: the replicated-pool2 path with shard i on cuda:i (the
    CLI's ``--devices N``), full SHARD_TIMED[0] gossip and push-sum to
    convergence, each bitwise the same run with every shard on cuda:0 and
    the single-device run on cuda:0 (rounds, every plane); and the wire of
    one round alone (the remote rows of each card's shards' bands on the
    reduce_scatter plan, every remote row on the all_gather plan), median
    of TIME_REPS by the host clock around the copies and a synchronize of
    every card, with the bytes it moves into each card, no more than the
    JAX wire's (the plan's bands, or its gathered copy)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, rng
    from cop5615_gossip_protocol_tpu_torch.parallel import halo
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    n = SHARD_TIMED[0]
    topo = build_topology("full", n)
    devices = [torch.device("cuda", i) for i in range(cards)]

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    def bitwise(a, b):
        return all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(a.state, b.state))

    for algorithm in ("gossip", "push-sum"):
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL,
                        engine="fused", n_devices=cards)
        single = run(topo, dataclasses.replace(cfg, n_devices=None))
        one = run(topo, cfg, devices=[devices[0]] * cards)
        halo.exchange_rows_batched.copies = 0
        spread = run(topo, cfg)
        copies = halo.exchange_rows_batched.copies
        same = bitwise(spread, one) and bitwise(spread, single)
        rows_loc, PT, layout, wire = p2s.plan_pool2_sharded(topo, cfg, cards)
        print(json.dumps({
            "metric": f"{algorithm}_pool2_sharded_full_n{n}_x{cards}_cards", "wire": wire,
            "rounds": spread.rounds, "one_card_rounds": one.rounds,
            "single_device_rounds": single.rounds, "run_s": spread.run_s,
            "one_card_run_s": one.run_s, "single_device_run_s": single.run_s,
            "dispatch_s": spread.dispatch_s, "fetch_s": spread.fetch_s,
            "converged_count": spread.converged_count, "wire_copies": copies,
            "estimate_mae": spread.estimate_mae, "bitwise_one_card_and_single": same,
            "device": spread.device}), flush=True)
        if not spread.rounds == one.rounds == single.rounds or not same or not copies:
            raise AssertionError(f"replicated-pool2 {algorithm} on {cards} cards differs "
                                 "from one card, or its wire copied nothing")
        # One round's wire, at the run's first round's displacements.
        placed = p2s.place_shards(devices, rows_loc)
        owners = [g.device for g in placed for _ in range(g.rows // rows_loc)]
        n_planes = len(p2s.SUMMARY_OF[algorithm])
        planes = {d: tuple(torch.zeros(layout.rows, 128, device=d) for _ in range(n_planes))
                  for d in devices}
        if wire == "reduce_scatter":
            offs = fused_pool.round_offsets(rng.PRNGKey(cfg.seed), 0, 1, POOL, n)[0].tolist()
            groups = halo.band_replica_rows(planes, rows_loc, owners,
                                            p2s.band_starts(offs, layout),
                                            rows_loc + p2s.band_margin(layout))
        else:
            groups = halo.replica_rows(planes, rows_loc, owners)
        into = {}
        for dsts, _ in groups:
            for x in dsts:
                into[x.device.index] = into.get(x.device.index, 0) + x.numel() * 4
        times = []
        for _ in range(TIME_REPS + 1):
            sync()
            t0 = time.perf_counter()
            halo.exchange_rows_batched(groups)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        jax_bytes = n_planes * 128 * 4 * (POOL * (rows_loc + p2s.band_margin(layout))
                                          if wire == "reduce_scatter"
                                          else layout.rows + PT + 16)
        print(json.dumps({"metric": f"{algorithm}_pool2_wire_ms_x{cards}_cards",
                          "wire": wire, "wire_ms": statistics.median(times[1:]),
                          "bytes_per_card": into, "jax_wire_bytes_per_card": jax_bytes}),
              flush=True)
        if max(into.values()) > jax_bytes:
            raise AssertionError(f"the {wire} wire moves more into a card than the JAX wire")
        del planes, groups


# The scatter path (ops/scatter.py, csrc/scatter.cu: kernel A) and the walk
# (models/reference.py, csrc/walk.cu: kernel B). Kernel A's checks, one
# round at a time: 1M full (both algorithms) and imp3d 1000 in reference
# semantics (its Q8 orphans, nodes of degree 0 that do not send); the
# rounds run before the mid-run checks (1M push-sum converges near round
# 674, gossip near 56); and the rounds of the timed chunk from there.
SCATTER_CASES = (("full", 1_000_000, "batched"), ("imp3d", 1000, "reference"))
SCATTER_MID = {"pushsum": 300, "gossip": 8}
SCATTER_TIMED = {"pushsum": CHUNK, "gossip": 8}
# The whole runs users type (BASELINE.json), each on the card against the
# port's CPU run of the same config (rounds, converged count, every plane),
# which a worker process computes while the card runs the earlier phases.
SCATTER_RUNS = (("full", 1_000_000, "gossip"), ("imp2d", 100_000, "push-sum"))
# (rounds, estimate_mae) of the JAX package's chunked engine on the CPU,
# seed 0, default delivery (scatter), which the card's runs must equal:
#   python -m cop5615_gossip_protocol_tpu 1000000 full push-sum --platform cpu
SCATTER_JAX = {("full", 1_000_000, "push-sum"): (674, 0.025499165106202766),
               ("full", 1_000_000, "gossip"): (56, None),
               ("imp2d", 100_000, "push-sum"): (505, 0.002863447207906636)}
# The walks, reference-semantics push-sum, with the hops the JAX package's
# run_walk takes on the CPU, seed 0 (python -m cop5615_gossip_protocol_tpu
# 1000 full push-sum --semantics reference --platform cpu).
WALK_RUNS = {("full", 1000): 60_032, ("imp3d", 1000): 185_604}
# The CLI triples, as the reference's users type them, with the JAX CLI's
# (rounds, estimate_mae) on the CPU, seed 0.
CLI_TRIPLES = {("1000", "full", "gossip"): (36, None),
               ("1000", "imp3D", "push-sum"): (481, 3.62016172591666e-05),
               ("1000", "full", "push-sum", "--semantics", "reference"):
                   (60_032, 2.5024414753715973e-06)}
# Per-node operations of a scatter round: the hash, the target (a modulo
# and an add, 3), and for push-sum the halves, the sums, the two divisions
# and the latch (12), for gossip the count and flags (4).
SCATTER_OPS = {"pushsum": OPS_PER_HASH + 3 + 12, "gossip": OPS_PER_HASH + 3 + 4}
# Bytes a node a round must move: its state read and written once
# (push-sum s, w, term, conv: 13; gossip count, active, conv: 6).
SCATTER_STATE_BYTES = {"pushsum": 13, "gossip": 6}
# Operations of one hop of the walk: two hashes, the pick (a modulo and an
# add), the sums, two divisions, the halves and the latch.
WALK_HOP_OPS = 2 * OPS_PER_HASH + 3 + 12


def cpu_scatter_runs():
    """The port's CPU runs of SCATTER_RUNS: {(kind, n, algorithm): (rounds,
    converged count, [planes as numpy], run_s)}. Runs in a worker process
    (spawned, so it holds no CUDA context) while the card runs phases 3-14e."""
    import os

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for kind, n, algorithm in SCATTER_RUNS:
        res = run(build_topology(kind, n), SimConfig(n=n, topology=kind, algorithm=algorithm),
                  device="cpu")
        out[kind, n, algorithm] = (res.rounds, res.converged_count,
                                   [x.numpy() for x in res.state], res.run_s)
    return out


def same_planes(label, got, want):
    """Every plane of two states bit for bit (float planes by their bits);
    returns the largest absolute difference (0.0)."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: plane {i} is {g.dtype} {tuple(g.shape)}, "
                                 f"want {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.float32:
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{label}: plane {i} differs "
                                     f"(max {(g - w).abs().max().item()})")
            err = max(err, (g - w).abs().max().item())
        elif not torch.equal(g, w):
            raise AssertionError(f"{label}: plane {i} differs")
    return err


def scatter_checks(dev, key):
    """Phase 14f: kernel A (csrc/scatter.cu) one round at a time against
    its plain version on the card, at SCATTER_CASES, both algorithms: from
    the initial state, a mid-run state and a converged state (one real
    round, and one with the done flag set, which must change nothing), and
    a SCATTER_TIMED-round chunk from the mid-run state; every plane and the
    status bitwise. Returns {(name, kind): case} for the timing phase and
    {name: max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import fused, scatter

    @functools.lru_cache(maxsize=None)
    def round_keys(start, count):
        # Cached, so the timed calls time the wrapper, not the host
        # drawing the keys.
        return fused.round_keys(key, start, count)

    cases, max_err = {}, {}
    for kind, n, semantics in SCATTER_CASES:
        topo = build_topology(kind, n, semantics=semantics)
        graph = scatter.scatter_graph(topo, dev)
        orphans = 0 if topo.implicit else int((topo.degree == 0).sum())
        print(f"  {kind} n={topo.n} ({semantics}): {orphans} orphans", flush=True)
        for algorithm in ("push-sum", "gossip"):
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, semantics=semantics)
            target = cfg.resolved_target_count(topo.n, topo.target_count)
            if name == "pushsum":
                init = pushsum_mod.init_state(topo.n, cfg.initial_term_round, dev)
                kw = {"graph": graph, "target": target, "delta": cfg.resolved_delta,
                      "term_rounds": cfg.term_rounds}
                kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
            else:
                init = gossip_mod.init_state(topo.n, draw_leader(key, topo, cfg),
                                             cfg.reference and kind == "full", dev)
                kw = {"graph": graph, "target": target,
                      "rumor_target": cfg.resolved_rumor_target,
                      "suppress": cfg.resolved_suppress}
                kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain

            def chunk(fn, state, start, count, done=0, kw=kw):
                status = torch.tensor([start, done], dtype=torch.int32, device=dev)
                return fn(state, round_keys(start, count), status, **kw)

            def check(label, state, start, count, done=0, chunk=chunk, kern=kern,
                      plain=plain):
                got, want = (chunk(kern, state, start, count, done),
                             chunk(plain, state, start, count, done))
                if got[1].tolist() != want[1].tolist():
                    raise AssertionError(f"{label}: status {got[1].tolist()} != plain "
                                         f"{want[1].tolist()}")
                err = same_planes(label, got[0], want[0])
                print(f"  {label}: status {got[1].tolist()}, bitwise", flush=True)
                return err, got

            tag = f"{name} {kind} n={topo.n}"
            errs = [check(f"{tag} initial state, one round", init, 0, 1)[0]]
            mid_round = SCATTER_MID[name]
            mid, st = chunk(kern, init, 0, mid_round)
            if st.tolist() != [mid_round, 0]:
                raise AssertionError(f"{tag}: status {st.tolist()} after {mid_round} rounds")
            errs.append(check(f"{tag} mid-run state, one round", mid, mid_round, 1)[0])
            errs.append(check(f"{tag} mid-run state, {SCATTER_TIMED[name]} rounds", mid,
                              mid_round, SCATTER_TIMED[name])[0])
            state, st, rnd = init, None, 0
            while st is None or not st[1]:
                if rnd >= 100_000:
                    raise AssertionError(f"{tag}: no convergence in {rnd} rounds")
                state, st = chunk(kern, state, rnd, 512)
                st, rnd = st.tolist(), rnd + 512
            errs.append(check(f"{tag} converged state (round {st[0]}), one round",
                              state, st[0], 1)[0])
            err, (same, after) = check(f"{tag} converged state, done flag set", state,
                                       st[0], 1, done=1)
            same_planes(f"{tag} a round after done", same, state)
            if after.tolist() != [st[0], 1]:
                raise AssertionError(f"{tag}: a round after done moved the status")
            max_err[name] = max(max_err.get(name, 0.0), *errs, err)
            cases[name, kind] = (kern, plain, chunk, mid, mid_round, topo.n, graph)
    torch.cuda.synchronize()
    return cases, max_err


def scatter_path(dev, cpu_runs):
    """Phase 14g: the scatter path through run() on the card, counters
    zeroed before each run and read after it, the pipeline's status reads
    counted: SCATTER_RUNS against the port's CPU runs (``cpu_runs``, the
    worker's result: rounds, converged count, every plane bitwise), and
    1M full push-sum; each against the JAX chunked engine's rounds and
    estimate, push-sum with its mass conserved; one status read a chunk.
    Returns {name: launches on its main-path run}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models import pipeline
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    counters = {"pushsum": scatter.pushsum_scatter_chunk,
                "gossip": scatter.gossip_scatter_chunk}
    passes = {"pushsum": scatter.PUSHSUM_PASSES, "gossip": scatter.GOSSIP_PASSES}
    launches = {}
    reads = []
    real_read = pipeline._read

    def counted_read(handle):
        reads.append(1)
        return real_read(handle)

    pipeline._read = counted_read
    try:
        for kind, n, algorithm in SCATTER_RUNS + (("full", 1_000_000, "push-sum"),):
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            topo = build_topology(kind, n)
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm)
            for fn in counters.values():
                fn.launches = 0
            reads.clear()
            res = run(topo, cfg)
            count = counters[name].launches
            chunks = len(res.chunk_log)
            print(json.dumps({
                "metric": f"{name}_scatter_rounds_per_sec_{kind}_n{topo.n}",
                "rounds": res.rounds, "run_s": res.run_s,
                "rounds_per_s": res.rounds / res.run_s, "setup_s": res.setup_s,
                "compile_s": res.compile_s, "dispatch_s": res.dispatch_s,
                "fetch_s": res.fetch_s, "chunks_retired": chunks,
                "status_reads": len(reads), "launches": count,
                "launches_per_chunk": count / chunks,
                "converged_count": res.converged_count,
                "estimate_mae": res.estimate_mae, "device": res.device}), flush=True)
            if not res.converged or res.converged_count != topo.n:
                raise AssertionError(f"{kind} n={topo.n} {algorithm} did not converge")
            if len(reads) != chunks:
                raise AssertionError(f"{kind} {algorithm}: {len(reads)} status reads for "
                                     f"{chunks} chunks")
            if count < passes[name] * res.rounds or count % passes[name]:
                raise AssertionError(f"{kind} {algorithm}: {count} launches of "
                                     f"{name}_scatter for {res.rounds} rounds")
            want = SCATTER_JAX[kind, n, algorithm]
            if (res.rounds, res.estimate_mae) != want:
                raise AssertionError(f"{kind} n={n} {algorithm}: rounds, estimate_mae "
                                     f"{res.rounds}, {res.estimate_mae} != the JAX "
                                     f"chunked engine's {want}")
            if algorithm == "push-sum":
                w_err = abs(res.state.w.double().sum().item() - topo.n) / topo.n
                mean = topo.n * (topo.n - 1) / 2
                s_err = abs(res.state.s.double().sum().item() - mean) / mean
                print(f"  mass: sum w rel err {w_err}, sum s rel err {s_err}", flush=True)
                if not (w_err < 1e-5 and s_err < 1e-5):
                    raise AssertionError(f"{kind} {algorithm} did not conserve its mass")
            if (kind, n, algorithm) in cpu_runs:
                rounds, conv, planes, cpu_s = cpu_runs[kind, n, algorithm]
                if (res.rounds, res.converged_count) != (rounds, conv):
                    raise AssertionError(f"{kind} {algorithm}: card {res.rounds}/"
                                         f"{res.converged_count} != CPU {rounds}/{conv}")
                same_planes(f"{kind} n={topo.n} {algorithm}, card vs CPU", res.state, planes)
                print(f"  {kind} n={topo.n} {algorithm}: card == the port's CPU run "
                      f"({rounds} rounds, every plane; CPU run_s {cpu_s:.2f})", flush=True)
                launches[name] = count
                MAIN_ROUNDS[f"{name}_scatter_round"] = res.rounds
        # The chunked engine's torch rounds on the card (engine="chunked"):
        # the same device-side status, one read a chunk, each run bitwise
        # the CPU's.
        for kind, algorithm, kw in (("line", "gossip", {}),
                                    ("full", "push-sum", {"delivery": "pool",
                                                          "pool_size": POOL})):
            topo = build_topology(kind, 1000)
            cfg = SimConfig(n=1000, topology=kind, algorithm=algorithm,
                            engine="chunked", **kw)
            reads.clear()
            res = run(topo, cfg)
            card_reads = len(reads)
            cpu = run(topo, cfg, device="cpu")
            if (res.rounds, res.converged_count) != (cpu.rounds, cpu.converged_count):
                raise AssertionError(f"chunked {kind} {algorithm}: card {res.rounds} "
                                     f"!= CPU {cpu.rounds}")
            same_planes(f"chunked engine {kind} 1000 {algorithm}, card vs CPU",
                        res.state, cpu.state)
            if card_reads != len(res.chunk_log):
                raise AssertionError(f"chunked {kind} {algorithm}: {card_reads} status "
                                     f"reads for {len(res.chunk_log)} chunks")
            print(f"  chunked engine {kind} 1000 {algorithm} on the card: {res.rounds} "
                  f"rounds, run_s {res.run_s:.4f}, {card_reads} status reads for "
                  f"{len(res.chunk_log)} chunks, bitwise the CPU's run", flush=True)
    finally:
        pipeline._read = real_read
    torch.cuda.synchronize()
    return launches


def walk_path(dev, key):
    """Phase 14h: the walk (kernel B, csrc/walk.cu) through run() on the
    card at WALK_RUNS, its launch counter zeroed before each run and read
    after it, against the plain walk on the CPU (every plane, the message,
    hops, the dead latch, bitwise) and the JAX package's hops; hops/s of
    both. Returns ({(kind, n): case} for the timing phase, launches of the
    first walk, max_abs_err)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models import reference

    cases, launches, err = {}, None, 0.0
    for (kind, n), hops in WALK_RUNS.items():
        topo = build_topology(kind, n, semantics="reference")
        cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference")
        reference.walk_hops.launches = 0
        card = run(topo, cfg)
        count = reference.walk_hops.launches
        plain = run(topo, cfg, device="cpu")
        label = f"walk {kind} n={topo.n}"
        err = max(err, same_planes(label, [x.cpu() for x in card.state], plain.state))
        if (card.rounds, card.converged_count, card.estimate_mae) != (
                plain.rounds, plain.converged_count, plain.estimate_mae) or card.rounds != hops:
            raise AssertionError(f"{label}: card {card.rounds} hops, CPU {plain.rounds}, "
                                 f"JAX {hops}")
        if count == 0:
            raise AssertionError(f"{label}: the walk kernel never launched")
        print(json.dumps({
            "metric": f"walk_hops_per_sec_{kind}_n{topo.n}", "hops": card.rounds,
            "run_s": card.run_s, "hops_per_s": card.rounds / card.run_s,
            "plain_run_s": plain.run_s, "plain_hops_per_s": plain.rounds / plain.run_s,
            "launches": count, "converged_count": card.converged_count,
            "estimate_mae": card.estimate_mae, "device": card.device}), flush=True)
        if launches is None:
            launches = count
            MAIN_ROUNDS["walk_hops"] = card.rounds
        cases[kind, n] = (topo, cfg, card.rounds, plain.run_s)
    torch.cuda.synchronize()
    return cases, launches, err


def cli_triples():
    """Phase 14i: the CLI triples as the reference's users type them, on
    the card, each against the JAX CLI's rounds and estimate; the scatter
    and walk kernels must have launched."""
    import contextlib
    import io

    from cop5615_gossip_protocol_tpu_torch import cli
    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    counters = (scatter.pushsum_scatter_chunk, scatter.gossip_scatter_chunk,
                reference.walk_hops)
    for argv, want in CLI_TRIPLES.items():
        for fn in counters:
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(list(argv))
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        got = (rec["rounds"], rec["estimate_mae"])
        counts = [fn.launches for fn in counters]
        print(f"  CLI {' '.join(argv)}: exit {code}, rounds {got[0]}, estimate_mae "
              f"{got[1]}, {time.perf_counter() - t0:.2f} s, launches {counts}", flush=True)
        if code != 0 or got != want or not any(counts):
            raise AssertionError(f"CLI {' '.join(argv)}: exit {code}, {got} != the JAX "
                                 f"CLI's {want}, launches {counts}")


def scatter_rows(dev, key, cases, launches, max_err):
    """Kernel A's rows of the kernels line: a round at 1M full from the
    mid-run state (a SCATTER_TIMED-round chunk over its rounds), beside the
    plain version's round and one index_add_ of a round's sends (the
    delivery alone, the PyTorch call that scatters them, in atomic order)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.ops import sampling, scatter

    rows = []
    for name in ("pushsum", "gossip"):
        kern, plain, chunk, mid, mid_round, n, graph = cases[name, "full"]
        K = SCATTER_TIMED[name]
        ms, (_, st) = time_ms(lambda: chunk(kern, mid, mid_round, K), TIME_REPS)
        rounds = int(st[0]) - mid_round
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, K), 2)
        targets, send_ok = scatter.round_targets(
            graph, sampling.round_key(key, mid_round))
        if name == "pushsum":
            vals = torch.where(send_ok, mid.s * 0.5, 0.0)
            senders = n
        else:
            vals = (mid.active & send_ok).to(torch.int32)
            senders = int(vals.sum())
        inbox = torch.zeros_like(vals)
        lib_ms, _ = time_ms(lambda: inbox.index_add_(0, targets, vals), TIME_REPS)
        # Device time by kernel over the same chunk (torch.profiler), µs a
        # round: where a round's time goes among its passes.
        with warnings.catch_warnings():
            # The profiler warns that it keeps one cycle's events: one is
            # all this takes.
            warnings.simplefilter("ignore", UserWarning)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                chunk(kern, mid, mid_round, K)
                torch.cuda.synchronize()
        passes = {}
        for ev in prof.key_averages():
            us_total = getattr(ev, "device_time_total", None)
            if us_total is None:
                us_total = getattr(ev, "cuda_time_total", 0.0)
            if us_total and ev.count:
                short = ev.key.replace("(anonymous namespace)::", "")
                short = short.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1]
                passes[short or ev.key[:40]] = passes.get(short, 0.0) + us_total / rounds
        moved = SCATTER_STATE_BYTES[name] * 2 * n
        ops = senders * SCATTER_OPS[name] + (n - senders) * 4
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{name}_scatter_round", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/scatter.cu",
            "replaces": "cop5615_gossip_protocol_tpu/ops/delivery.py:22",
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms / rounds, "plain_ms": plain_ms / rounds,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "library_call": "index_add_ of one round's sends",
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "device_us_per_round_by_kernel": passes,
            "launches_a_round": (scatter.PUSHSUM_PASSES if name == "pushsum"
                                 else scatter.GOSSIP_PASSES),
            "population": n, "topology": "full", "status": "ported",
        })
    return rows


def walk_row(dev, key, cases, launches, max_err):
    """Kernel B's row: the whole 1000 full walk from its kickoff in one
    launch, by CUDA events, beside the plain walk's time on the host; its
    bound by the contract (bytes, operations) and by the hop chain (hops
    times one dependent load at the walk's working set, timed by the
    chase kernel)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    timed = {}
    for (kind, n), (topo, cfg, hops, plain_s) in cases.items():
        graph = scatter.scatter_graph(topo, dev)
        leader = draw_leader(key, topo, cfg)
        c0 = reference.make_walk(topo, cfg, key, leader, dev)
        target = cfg.resolved_target_count(topo.n, topo.target_count)
        ms, (_, st) = time_ms(lambda: reference.walk_hops(
            c0, key, graph, hops=reference.LAUNCH_HOPS, max_steps=cfg.max_rounds,
            target=target, delta=cfg.resolved_delta, term_rounds=cfg.term_rounds), 3)
        walked = int(st[0]) - 1
        # One dependent load at the walk's working set: a random cycle over
        # as many ints as the walk's planes hold (s, w, term, conv and, on
        # an explicit topology, the neighbour rows and degrees).
        words = topo.n * 13 // 4 + (0 if topo.implicit else topo.n * (topo.max_deg + 1))
        gen = torch.Generator().manual_seed(0)
        perm = torch.randperm(words, generator=gen)
        nxt = torch.empty(words, dtype=torch.int32)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        nxt = nxt.to(dev)
        steps = 1 << 20
        chase_ms, _ = time_ms(lambda: reference.chase(nxt, steps), 3)
        load_ns = chase_ms * 1e6 / steps
        # The hop chain: on full the next node is arithmetic on the word,
        # and the message waits on one load (the node's s); on an explicit
        # topology the next node waits on two (its degree, then its
        # neighbour column).
        chain = 1 if topo.implicit else 2
        moved = topo.n * 13 * 2 + (0 if topo.implicit else topo.n * (topo.max_deg + 1) * 4)
        ops = walked * WALK_HOP_OPS
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        timed[kind] = {
            "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "latency_bound_ms": walked * chain * load_ns * 1e-6,
            "dependent_load_ns": load_ns, "hops_per_call": walked,
            "us_per_hop": ms * 1e3 / walked, "population": topo.n, "topology": kind,
        }
    return {
        "name": "walk_hops", "route": "cuda",
        "source": "cop5615_gossip_protocol_tpu_torch/csrc/walk.cu",
        "replaces": "cop5615_gossip_protocol_tpu/models/reference.py:153",
        "launches": launches, "max_abs_err": max_err, **timed["full"],
        "library_ms": None, "at_imp3d": timed["imp3d"], "status": "ported",
    }


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    t_main = time.perf_counter()
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: chip_smoke.py needs one GPU")
    try:
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
    cards = int(sys.argv[sys.argv.index("--cards") + 1]) if "--cards" in sys.argv else 1
    if cards > 1:
        if torch.cuda.device_count() < cards:
            return fail(f"--cards {cards}: {torch.cuda.device_count()} card(s) visible")
        try:
            imp_shard_cards(cards)
            pool2_shard_cards(cards)
        except (AssertionError, RuntimeError) as e:
            return fail(str(e))
        print(smi)
        print(json.dumps({"ok": True, "mode": f"cards {cards}", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # The port's CPU runs that phase 14g holds the card's scatter runs
    # against, in a spawned worker while the card runs phases 2-14e.
    import multiprocessing

    worker = multiprocessing.get_context("spawn").Pool(1)
    try:
        cpu_runs = worker.apply_async(cpu_scatter_runs)
        return run_phases(torch, dev, smi, kernels, cpu_runs, t_main)
    finally:
        worker.terminate()
        worker.join()


def run_phases(torch, dev, smi, kernels, cpu_runs, t_main) -> int:
    """Phases 2-15 of the one-card run; ``cpu_runs`` is the worker's
    pending result for phase 14g."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, rng

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = dict(zip(kernels.SOURCES, pool.map(kernels.build, kernels.SOURCES)))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {list(builds)}")
    for name, (lib, seconds) in builds.items():
        print(f"  {name}: nvcc {seconds:.2f} s -> {lib.name}")
        log = lib.with_suffix(".log")
        entry = None
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry function" in line:
                entry = line.split(chr(39))[1]
                print(f"    {entry}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
                # A spill in a persistent round kernel (rows 1-2, 5-8)
                # would add local-memory traffic to every round: a failure.
                if (name in ("fused_pool", "fused_resident") and "rounds" in (entry or "")
                        and "spill" in line and "0 bytes spill stores, 0 bytes spill loads"
                        not in line):
                    return fail(f"{name}: {entry} spills ({line.strip()})")

    # ---------------------------------------------------------------- 3
    topo = build_topology("full", N)
    layout = fused_pool.build_pool_layout(N)
    key = rng.PRNGKey(0)
    kernel_fns, (ps_cfg, go_cfg) = pool_fns(dev, key, N)
    max_err = {}
    mid_states = {}
    print("kernels vs plain versions at n = 1,000,000:")
    try:
        for name, (kern, plain, chunk, init, nf, mid_round) in kernel_fns.items():
            errs = [compare(f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                            chunk(plain, init, 0, CHUNK), nf)]
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"{name}: converged before round {mid_round}")
            mid_states[name] = (mid, mid_round)
            errs.append(compare(f"{name} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                                chunk(plain, mid, mid_round, CHUNK), nf))
            errs += parity_checks(name, kern, plain, chunk, mid, mid_round, nf)
            errs += zero_round_checks(name, kern, plain, chunk, mid, mid_round)
            done_state, _ = chunk(kern, init, 0, 4096)
            out, ex = chunk(kern, done_state, 4096, CHUNK)
            if int(ex) != 0 or not all(torch.equal(a, b) for a, b in zip(out, done_state)):
                raise AssertionError(f"{name}: a chunk from a converged state ran")
            print(f"  {name} from converged state: 0 rounds, state unchanged")
            max_err[name] = max(errs)
        print(f"kernels vs plain versions at n = {POOL_CAP_N:,} (the tier's cap):")
        cap_fns, _ = pool_fns(dev, key, POOL_CAP_N)
        for name, (kern, plain, chunk, init, nf, _) in cap_fns.items():
            max_err[name] = max(max_err[name], compare(
                f"{name} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                chunk(plain, init, 0, CHUNK), nf))
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
        MAIN_ROUNDS[f"{name}_pool_chunk"] = res.rounds
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
        # The warmup chunk and two 4,096-round chunks (pipeline depth 2),
        # 3 launches each whatever their rounds.
        if launches[name][name] != 3 * fused_pool.chunk_launches(4096):
            return fail(f"the 1M {name} run queued {launches[name][name]} launches "
                        "of its kernel, not 9 (3 chunks of 3)")
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

    # -------------------------------- 5, 6, 7, 8, 9, 10, 11, 12, 13, 14
    def phase(number, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {number} ({fn.__name__}): {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    try:
        lattice_cases, lattice_err = phase(5, lattice_checks, dev, key)
        lattice_launches, lattice_single = phase(6, lattice_path, dev)
        imp_cases, imp_err = phase(7, imp_checks, dev, key)
        imp_launches, imp_single = phase(8, imp_path, dev)
        resident_cases, resident_err = phase(9, resident_checks, dev, key)
        resident_launches, resident_single = phase(10, resident_path, dev)
        pool2_cases, pool2_err = phase(11, pool2_checks, dev, key)
        pool2_launches, pool2_single = phase(12, pool2_path, dev)
        shard_cases, shard_err = phase(13, shard_checks, dev, key)
        shard_launches = phase(14, shard_path, dev, pool2_single)
        del pool2_single
        stencil_shard_cases, stencil_shard_err = {}, {}
        for part, tier in (("14a", "fused_sharded"), ("14b", "stencil_hbm_sharded")):
            stencil_shard_cases[tier], stencil_shard_err[tier] = phase(
                part, stencil_shard_checks, dev, key, tier)
        stencil_shard_launches = phase(
            "14c", stencil_shard_path, dev,
            {"lattice": lattice_single, "resident": resident_single})
        del lattice_single, resident_single
        imp_shard_cases, imp_shard_err = phase("14d", imp_shard_checks, dev, key)
        imp_shard_launches = phase("14e", imp_shard_path, dev, imp_single)
        del imp_single
        scatter_cases, scatter_err = phase("14f", scatter_checks, dev, key)
        t0 = time.perf_counter()
        try:
            cpu_done = cpu_runs.get(timeout=900)
        except Exception as e:  # the worker's own error, re-raised here
            raise RuntimeError(f"the CPU runs of phase 14g failed: {e!r}") from e
        print(f"  the worker's CPU runs: waited {time.perf_counter() - t0:.1f} s",
              flush=True)
        scatter_launches = phase("14g", scatter_path, dev, cpu_done)
        walk_cases, walk_launches, walk_err = phase("14h", walk_path, dev, key)
        phase("14i", cli_triples)
    except (AssertionError, RuntimeError) as e:
        return fail(str(e))

    # --------------------------------------------------------------- 15
    rows = []
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:860",
                "gossip": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:1157"}
    plane_bytes = {"pushsum": 16, "gossip": 12}
    def pool_bound(n_pad, rounds, name):
        # The state stays in the L2 through the chunk at 1M: its bytes are
        # read and written once per chunk, with the streams.
        algo = "push-sum" if name == "pushsum" else "gossip"
        moved = 2 * plane_bytes[name] * n_pad + CHUNK * (16 + 4 * POOL) + 8
        ops = rounds * (n_pad // 8 * OPS_PER_WORD + n_pad * ops_per_node(algo, POOL))
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    for name, (kern, plain, chunk, init, nf, _) in kernel_fns.items():
        mid, mid_round = mid_states[name]
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        # The same state over a long chunk, which spreads the chunk's fixed
        # cost (the wrapper, three launches) over more rounds.
        long_ms, (_, long_ex) = time_ms(lambda: chunk(kern, mid, mid_round, LONG_CHUNK),
                                        TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(ex)
        bound_ms, bound_by = pool_bound(layout.n_pad, rounds, name)
        # The first chunk at the tier's cap, whose planes outgrow the L2.
        kern_c, _, chunk_c, init_c, _, _ = cap_fns[name]
        cap_ms, (cap_out, cap_ex) = time_ms(lambda: chunk_c(kern_c, init_c, 0, CHUNK),
                                            TIME_REPS)
        cap_bound_ms, cap_bound_by = pool_bound(cap_out[0].numel(), int(cap_ex), name)
        rows.append({
            "name": f"{name}_pool_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_pool.cu",
            "replaces": replaces[name],
            "launches": launches[name][name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "rounds_long_chunk": int(long_ex),
            "us_per_round_long_chunk": long_ms * 1e3 / int(long_ex),
            "at_cap": {"population": POOL_CAP_N, "ms": cap_ms, "bound_ms": cap_bound_ms,
                       "bound_by": cap_bound_by, "rounds_per_call": int(cap_ex),
                       "us_per_round": cap_ms * 1e3 / int(cap_ex)},
            "status": "ported",
        })
    del cap_fns
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/ops/fused_stencil_hbm.py:899",
                "gossip": "cop5615_gossip_protocol_tpu/ops/fused_stencil_hbm.py:1206"}
    for name, (kern, plain, chunk, mid, mid_round, layout, classes) in lattice_cases.items():
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(ex)
        algo = "push-sum" if name == "pushsum" else "gossip"
        moved = rounds * STATE_BYTES[name] * layout.n_pad + CHUNK * 16 + 8
        ops = rounds * layout.n_pad * stencil_ops_per_node(algo, classes)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{name}_stencil_hbm_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_stencil.cu",
            "replaces": replaces[name],
            "launches": lattice_launches[name][name],
            "max_abs_err": lattice_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "status": "ported",
        })
    replaces = {"pushsum_imp": "cop5615_gossip_protocol_tpu/ops/fused_imp.py:307",
                "gossip_imp": "cop5615_gossip_protocol_tpu/ops/fused_imp.py:467",
                "pushsum_imp_hbm": "cop5615_gossip_protocol_tpu/ops/fused_imp_hbm.py:478",
                "gossip_imp_hbm": "cop5615_gossip_protocol_tpu/ops/fused_imp_hbm.py:716"}
    for row, (kern, plain, chunk, mid, mid_round, n, lattice, tier) in imp_cases.items():
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(ex)
        name = row.split("_")[0]
        algo = "push-sum" if name == "pushsum" else "gossip"
        n_pad = mid[0].numel()
        streams = CHUNK * (32 + 4 * IMP_POOL) + 8
        # The resident tier's state fits the L2: its bytes are read and
        # written once per chunk; the streaming tier's once per round.
        passes = 1 if tier == "imp" else rounds
        moved = passes * STATE_BYTES[name] * n_pad + streams
        ops = rounds * n_pad * imp_ops_per_node(algo, lattice + IMP_POOL)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{row}_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_imp.cu",
            "replaces": replaces[row],
            "launches": imp_launches[row], "max_abs_err": imp_err[row],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "population": n, "status": "ported",
        })
    replaces = {("pushsum", "stencil"): "cop5615_gossip_protocol_tpu/ops/fused.py:741",
                ("gossip", "stencil"): "cop5615_gossip_protocol_tpu/ops/fused.py:993",
                ("pushsum", "stencil2"): "cop5615_gossip_protocol_tpu/ops/fused_stencil.py:268",
                ("gossip", "stencil2"): "cop5615_gossip_protocol_tpu/ops/fused_stencil.py:427"}
    for (name, tier), (kern, plain, chunk, mid, mid_round, classes) in resident_cases.items():
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        # The same state over a long chunk, which spreads the chunk's fixed
        # cost (the wrapper, three launches) over more rounds.
        long_ms, (_, long_ex) = time_ms(lambda: chunk(kern, mid, mid_round, LONG_CHUNK),
                                        TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(ex)
        algo = "push-sum" if name == "pushsum" else "gossip"
        n_pad = mid[0].numel()
        # The state stays in the L2 through the chunk: its bytes are read
        # and written once per chunk, with the keys.
        moved = STATE_BYTES[name] * n_pad + CHUNK * 16 + 8
        ops = rounds * n_pad * stencil_ops_per_node(algo, classes)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        kind, n = RESIDENT_TIMED[name, tier]
        rows.append({
            "name": f"{name}_{tier}_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_resident.cu",
            "replaces": replaces[name, tier],
            "launches": resident_launches[name, tier],
            "max_abs_err": resident_err[name, tier],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "rounds_long_chunk": int(long_ex),
            "us_per_round_long_chunk": long_ms * 1e3 / int(long_ex),
            "population": n, "topology": kind, "status": "ported",
        })
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/ops/fused_pool2.py:952",
                "gossip": "cop5615_gossip_protocol_tpu/ops/fused_pool2.py:1388"}
    for name in ("pushsum", "gossip"):
        algo = "push-sum" if name == "pushsum" else "gossip"
        timed = {}
        # Rows 3-4 at 2**24 from a mid-run state; beside them, the first
        # chunk at the tier's cap.
        for which in (name, f"{name}_cap"):
            kern, plain, chunk, state, start, n = pool2_cases[which]
            ms, (_, ex) = time_ms(lambda: chunk(kern, state, start, CHUNK), TIME_REPS)
            plain_ms = (time_ms(lambda: chunk(plain, state, start, CHUNK), 2)[0]
                        if plain is not None else None)
            rounds = int(ex)
            n_pad = state[0].numel()
            moved = (rounds * pool2_bytes_per_node(algo, POOL) * n_pad
                     + CHUNK * (16 + 4 * POOL) + 8)
            ops = rounds * n_pad * pool2_ops_per_node(algo, POOL)
            bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
            timed[which] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
                "population": n,
            }
            torch.cuda.empty_cache()
        rows.append({
            "name": f"{name}_pool2_chunk", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_pool2.cu",
            "replaces": replaces[name],
            "launches": pool2_launches[name], "max_abs_err": pool2_err[name],
            **timed[name], "library_ms": None,
            "at_cap": timed[f"{name}_cap"], "status": "ported",
        })
    # Rows 20-21: one round of every shard, one launch over every row (the
    # verdict in it, against a target no round reaches) at SHARD_TIMED from
    # the mid-run state, timed over 32 launches in a row, as the run queues
    # them, and as a single launch. On one card the wire copies nothing
    # (phase 14 counts it); ``--cards`` times it across cards.
    replaces = {"pushsum": "cop5615_gossip_protocol_tpu/parallel/pool2_sharded.py:591",
                "gossip": "cop5615_gossip_protocol_tpu/parallel/pool2_sharded.py:836"}
    for name in ("pushsum", "gossip"):
        kern, plain, algorithm, kw, state, mid_round, n, R = shard_cases[name]
        streams = shard_streams(key, mid_round, CHUNK, n, dev)
        sets = [tuple(x.clone() for x in state), tuple(torch.empty_like(x) for x in state)]
        ctl = {"u": None, "acc": torch.zeros(2, dtype=torch.int32, device=dev),
               "ctrl": torch.zeros(2, dtype=torch.int32, device=dev), "target": n + 1}

        def rounds():
            for i in range(CHUNK):
                shard_launch(kern, algorithm, kw, sets[i % 2], sets[1 - i % 2], streams, i,
                             0, R, **ctl)

        chunk_ms, _ = time_ms(rounds, TIME_REPS)
        one_ms, _ = time_ms(lambda: shard_launch(kern, algorithm, kw, state, sets[1], streams,
                                                 0, 0, R, **ctl), TIME_REPS)
        plain_ms, _ = time_ms(lambda: shard_plain(plain, algorithm, kw, state, streams, 0, 0,
                                                  R), 2)
        n_pad = R * 128
        moved = pool2_bytes_per_node(algorithm, POOL) * n_pad + 16 + 4 * POOL + 8
        ops = n_pad * pool2_ops_per_node(algorithm, POOL)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        rows.append({
            "name": f"{name}_pool2_shard_round", "route": "cuda",
            "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_pool2_shard.cu",
            "replaces": replaces[name],
            "launches": shard_launches[name], "max_abs_err": shard_err[name],
            "ms": chunk_ms / CHUNK, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "rounds_per_call": 1, "us_per_round": chunk_ms * 1e3 / CHUNK,
            "timed_launches": CHUNK, "single_launch_ms": one_ms,
            "shards": SHARD_TIMED[1], "launches_a_round": 1, "wire_copies_a_round": 0,
            "population": n, "status": "ported",
        })
        del sets
    torch.cuda.empty_cache()
    rows += stencil_shard_rows(stencil_shard_cases, stencil_shard_launches,
                               stencil_shard_err)
    rows += imp_shard_rows(dev, imp_shard_cases, imp_shard_launches, imp_shard_err)
    rows += scatter_rows(dev, key, scatter_cases, scatter_launches, scatter_err)
    rows.append(walk_row(dev, key, walk_cases, walk_launches, walk_err))
    for row in rows:
        row["main_path_rounds"] = MAIN_ROUNDS.get(row["name"])
    # The imp rows beside row 9 (the streaming lattice push-sum, the same
    # bytes bound as row 13), all from this run.
    us = {row["name"]: row["us_per_round"] for row in rows if "us_per_round" in row}
    print(json.dumps({"metric": "imp_us_per_round", **{
        name: us[name] for name in (
            "pushsum_imp_chunk", "gossip_imp_chunk", "pushsum_imp_hbm_chunk",
            "gossip_imp_hbm_chunk", "pushsum_imp_hbm_shard_round",
            "gossip_imp_hbm_shard_round", "pushsum_stencil_hbm_chunk")},
        "row13_over_row9": us["pushsum_imp_hbm_chunk"] / us["pushsum_stencil_hbm_chunk"],
        "row18_over_row9": (us["pushsum_imp_hbm_shard_round"]
                            / us["pushsum_stencil_hbm_chunk"])}), flush=True)
    # Rows 20-21 beside rows 3-4 (the same round over every row, from one
    # global copy in place of the tier's ping/pong planes), and the sharded
    # runs' run_s beside the single-device ones, all from this run.
    print(json.dumps({"metric": "pool2_shard_us_per_round", **{
        name: us[name] for name in (
            "pushsum_pool2_shard_round", "gossip_pool2_shard_round", "pushsum_pool2_chunk",
            "gossip_pool2_chunk")},
        "row20_over_row3": us["pushsum_pool2_shard_round"] / us["pushsum_pool2_chunk"],
        "row21_over_row4": us["gossip_pool2_shard_round"] / us["gossip_pool2_chunk"],
        "run_s": RUN_S,
        "pushsum_run_s_over_single": RUN_S["pushsum_sharded"] / RUN_S["pushsum_single"],
        "gossip_run_s_over_single": RUN_S["gossip_sharded"] / RUN_S["gossip_single"]}),
        flush=True)
    # Rows 1-2 beside rows 7-8 (the same persistent design at torus3d 1M,
    # 10 classes in place of 2), all from this run.
    print(json.dumps({"metric": "pool_us_per_round", **{
        name: us[name] for name in (
            "pushsum_pool_chunk", "gossip_pool_chunk", "pushsum_stencil2_chunk",
            "gossip_stencil2_chunk")},
        "row1_over_row7": us["pushsum_pool_chunk"] / us["pushsum_stencil2_chunk"],
        "row2_over_row8": us["gossip_pool_chunk"] / us["gossip_stencil2_chunk"]}),
        flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t_main:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
