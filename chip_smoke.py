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
   kernels of csrc/fused_pool.cu, csrc/fused_resident.cu and csrc/scatter.cu,
   the walk, and both instances of the round, absorb and sends kernels of
   csrc/fused_stencil.cu, csrc/fused_imp.cu, csrc/fused_imp_hbm_shard.cu and
   csrc/fused_pool2_shard.cu must not spill);
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
14f. kernel A, the scatter round (csrc/scatter.cu, one persistent
   cooperative launch a chunk), against its plain version on the card at
   full 1,000,000 and at imp3d 1000 in reference semantics (its Q8 orphan
   does not send), both algorithms: one round from the initial state; from
   a mid-run state one round, no round, a 32-round (push-sum) or 8-round
   (gossip) chunk and chunks capped after 5 and after 6 rounds (both round
   parities); a chunk that reaches done in its middle, then a second chunk
   from its result (nothing moves); from a converged state one real round,
   and one with the done flag set (nothing moves); every plane and the
   (rounds, done) status bitwise, and the kernel's scratch zero after every
   chunk; then one 2-round chunk of each algorithm at full 2**27, the
   largest size, bitwise;
14g. the scatter path through ``run()``, counters zeroed before each run
   and read after it, the pipeline's status reads counted (one a chunk):
   ``1000000 full gossip`` and ``100000 imp2D push-sum`` (BASELINE.json),
   each bitwise the port's CPU run of the same config (computed by a
   spawned worker process while the card runs phases 2-14f), and 1M full
   push-sum; each against the JAX chunked engine's rounds and estimate on
   the CPU, push-sum with its mass conserved; one launch a chunk of
   rounds, by the wrapper's counter and, in the same run again under
   torch.profiler, by the round kernels in the card's trace; run_s,
   rounds/s, launches a chunk and status reads printed; then the chunked
   engine's torch rounds on the card
   (``engine="chunked"``: 1000 line gossip, 1000 full
   push-sum with pool delivery), each bitwise the CPU's run with one
   status read a chunk;
14h. kernel B, the reference-semantics walk (csrc/walk.cu, one block: one
   thread walks while the others draw the next hops' words, up to 2**20
   hops a launch), through ``run()`` at full 1000 (60,032 hops) and imp3d
   1000 (185,604), each bitwise the plain walk on the CPU (every plane, the
   message, hops, the dead latch) and at the JAX package's hops, hops/s of
   both printed; then line 1000 (two-hop revisits, to its 1M-hop cap),
   full 1000 capped at 4,099 hops, the full 1000 walk in launches of 1,000
   hops against one launch, a Q8 death on a three-node graph with an
   orphan, and full 100,000 and imp3d 8000 capped at 500,000 hops, each
   bitwise the plain walk; the launches by tier (shared memory at the
   1000-node walks, the global tier past it) are asserted;
14i. the CLI triples ``1000 full gossip``, ``1000 imp3D push-sum`` and
   ``1000 full push-sum --semantics reference``, each at the JAX CLI's
   rounds and estimate, with their kernels launched;
14j. (run inside phase 15, after its fault-free rows and before the kernels
   line) the failure model on the two main paths (ROADMAP A6a-1): rows 1-2
   and kernel A, each in its faulted instance, at full 1,000,000 against
   their plain versions on the card, under the drop gate with crash-stop
   (a schedule and a rate, with quorum) and the drop gate with global
   termination: a 32-round chunk from the initial state across the
   schedule's death rounds, from a mid-run state chunks capped after 5 and
   6 rounds (both mark parities), a chunk that reaches the verdict three
   rounds in and one that starts at it; every plane and count bitwise. Then
   the runs through ``run()`` and the CLI, counters zeroed before each and
   read after it: 1M full push-sum (pool, pool_size 2) under the gate and
   a crash schedule with quorum 0.95, and under the gate with global
   termination; 1M full gossip (pool) under a crash rate with quorum 0.9;
   the CLI's ``1000000 full gossip`` and ``100000 imp2D push-sum`` (scatter,
   kernel A) with ``--fault-rate 0.2 --crash-schedule 3:10000 --quorum
   0.9``; each ends "converged" at the rounds and converged count baked
   from the CPU (FAULT_RUNS), push-sum with its mass over live and dead
   nodes conserved; and the same five at 70,000 nodes on the card against
   the worker's CPU runs (rounds, converged count, every plane);
14k. (run after 14j) the failure model in rows 3-7 (ROADMAP A6a-2): the
   resident lattice kernels' faulted instances (csrc/fused_resident.cu)
   at line 1000, grid2d 10,000 and grid3d 125,000, row 7's global instance
   at torus3d 1,000,000 and the streaming pool kernels' faulted instances
   (csrc/fused_pool2.cu) at full 16,777,216, pool_size 2, against their
   plain versions on the card, the same chunks as 14j, every plane and
   count bitwise (where a push-sum run cannot reach its verdict, the chunk
   from a state with every real node converged). Then the runs through
   ``run()`` and the CLI: ``10000 grid2D push-sum --fault-rate 0.1
   --crash-schedule 40000:20 --quorum 0.9`` and ``1000 line gossip
   --fault-rate 0.2``, grid2d 10,000 push-sum with global termination and
   grid3d 125,000 gossip under the gate and a crash rate, each at the
   rounds and converged count baked from the JAX chunked engine on the
   CPU; torus3d 1M push-sum global at the kernel checks' verdict round;
   16,777,216 full push-sum under the gate and a crash schedule (quorum
   0.95) and under the gate with global termination, and gossip under a
   crash rate (quorum 0.9), each against the same whole run of the plain
   version on the card (rounds, converged count, every plane); push-sum
   with its mass conserved over live and dead nodes, each with its kernel
   launched; and those three at 70,000 nodes on the streaming pool tier
   against the worker's CPU runs;
14l. (run after 14k) the failure model in A6a-3's rows: the global
   instances of rows 9, 11 and 13 (csrc/fused_stencil.cu, csrc/fused_imp.cu)
   at torus3d 256**3, imp3d 1,000,000 and imp3d 2**24 against their plain
   versions on the card, from a crafted state (one ratio everywhere but
   three nodes) at round 1000: a 32-round chunk in which the verdict fires
   (conv latched on every real node), chunks capped after 5 and 6 rounds
   and a chunk from the verdict (0 rounds); each through run() from the
   crafted state to the checks' verdict round, row 11 also from the
   initial state, bitwise the plain version's whole run on the card; row
   18's global absorb (csrc/fused_imp_hbm_shard.cu) at imp3d 256**3 in 4
   shards, one round of every shard from the crafted and the initial state
   against the plain round, and runs from both (and capped after 5 and 6
   rounds, and from the verdict) bitwise the single-device imp_hbm run;
   rows 20-21's faulted instances (csrc/fused_pool2_shard.cu) at full
   2**24 in 4 shards under the gate with a crash schedule, a crash rate or
   global termination: the sends launch and one launch a shard at rounds
   0, 5 and 20 against the plain bits and round, and runs at 2,197,152 in 4
   shards, from the initial and the crafted state, bitwise the
   single-device streaming pool run; counters zeroed before each run and
   read after it;
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
   rows 1-7 and kernel A in their faulted (row 7: global) instances, rows
   9, 11, 13 and 18 in their global ones and rows 20-21 in their faulted
   ones (with the sends launch) beside their fault-free times of this run,
   each round kernel's device time a round in both instances; rows 15-16's
   global super-steps beside their local instance on the same state, and
   kernel A's, rows 1-2's and rows 5-6's revive instances beside their
   fault-free ones on the same state; kernel B over each whole walk in one launch, beside the plain walk on
   the host and the hop chain's bound (hops times what a hop waits on from
   the hop before: on full the message's and the pick's arithmetic, timed
   by csrc/walk.cu's arith kernel; on imp3d two dependent accesses at the
   walk's working set in the memory its tier walks in, shared or global,
   timed by its chase kernel), the bytes/operations bound beside it; then
   the imp rows' µs a round beside row 9's, and rows 13 and 18 over row 9.

14m. (run after 14l) global termination in the sharded lattice
   compositions (ROADMAP A6a-4): rows 15-16's global instances
   (csrc/fused_stencil_shard.cu, csrc/fused_stencil_hbm_shard.cu) at
   torus3d 100**3 in 2 shards and 256**3 in 4, every shard on the card,
   from phase 14l's crafted state: one super-step of every shard against
   the plain version (every row of out and y, and u, the middle's unstable
   counts), then run(devices=[card] * S) from the crafted state, stopping at
   the exact round, bitwise the single-device global run (stencil2,
   stencil_hbm), and runs resumed so the verdict lands on a super-step's
   first, middle and last round, bitwise the same;
14n. (run after 14m) crash-recovery (ROADMAP A6b) in kernel A and rows 1-2
   at full 1,000,000 and rows 5-6 at grid2d 10,000: each faulted instance
   with a revival plane against its plain version on the card under a
   crash and revive schedule (push-sum rejoining fresh) and a crash and
   revive rate (push-sum restoring): a 32-round chunk from the initial
   state, chunks that end just before and just after the first revival
   round and a chunk resumed at it, every plane bitwise; then REVIVE_RUNS
   through run() and the CLI against the worker's CPU runs (rounds,
   converged count, estimate, run()'s every plane);

14o. (run after 14n) Byzantine adversaries (ROADMAP A6c) and XLA's flush
   (ROADMAP C1): each faulted instance of rows 1-2 and kernel A at full
   1,000,000, kernel A at imp2d 100,000 and rows 5-6 at grid2d 10,000 in
   every mode (and push-sum mass_deflate with a crash and revive schedule)
   against its plain version on the card, a 32-round chunk from round 16
   across the onset at round 20; a drained crafted state (s and w near
   FLT_MIN) through rows 1, 3, 5, 20 and kernel A under a crash model
   against each plain version; then BYZ_RUNS through run() against the JAX
   chunked engine's values baked on the CPU (each Byzantine row's own
   main-path run at its kernel, shape and mode, whose launches the kernels
   line reports; the acceptance pair of unhealthy and clip, trim, each
   kernel under the modes, ROADMAP C1's drained configs);
14p. (run after 14o) the telemetry plane (ROADMAP A6d) and kernel A's clip
   and sentinel (A6c-2): each telemetry instance of kernel A and rows 1-2 at
   full 1,000,000, rows 5-6 at grid2d 10,000 and kernel A at imp2d 100,000,
   fault-free and with a gate and a crash and revive schedule, against its
   plain version (every plane, the status and every row bitwise; the plain
   rows' float sums in the kernel's order on its grid) and against the
   instance without telemetry (bitwise: rows change nothing), a 32-round
   chunk from round 16; kernel A's clip and sentinel instances, with and
   without telemetry, at full 1,000,000 the same way, the sentinel tripping
   at round 20 inside the chunk; then TELE_RUNS through run() against the
   JAX chunked engine's values baked on the CPU (each new row's main-path
   run, whose launches the kernels line reports; the acceptance pair on
   scatter delivery; telemetry under clip, the sentinel, a gate with churn
   and global termination: every count column of the rows exact, the
   estimate and mass to stated tolerances), and TELE_CLIS through the CLI
   with --trace-convergence against the JAX CLI's trace;
14q. (run after 14p) delivery="matmul" and the dup and delay instances of
   kernel A (ROADMAP A7b): full 1,000,000 push-sum and gossip with
   --delivery matmul --pool-size 2 through run() on rows 1-2, bitwise the
   --delivery pool run and at the JAX chunked engine's baked rounds; full
   2,097,153 a few chunks on rows 3-4 and on the replicated-pool2
   composition over 2 shards on the card, bitwise the pool runs; imp2d
   100,489 push-sum --delivery matmul --pool-size 4 on the chunked engine
   to convergence, bitwise the port's CPU run (baked); then each dup and
   delay instance of kernel A at full 1,000,000 and imp2d 100,489, both
   algorithms (dup, delay, both; with telemetry, a gate with churn, a
   Byzantine model, clip, global termination), a 32-round chunk from round
   16 against the plain version (every plane, the ring, the status and
   every row bitwise); DD_RUNS through run() against the JAX chunked
   engine's values baked on the CPU (rounds, counts, outcome, estimate, the
   final planes by digest, and under telemetry the rows), DD_CLIS through
   the CLI with --dup-rate and --delay-rounds, and grid2d 10,000 push-sum
   with dup and delay on stencil delivery (the chunked engine's torch
   rounds) bitwise the port's CPU run (baked);
14r. (run after 14q) checkpoint and resume, the event log, the metrics
   registry, step timing and the stall watchdog (ROADMAP A8): full
   1,000,000 push-sum and gossip with --delivery pool --pool-size 2 through
   the CLI with --checkpoint, --checkpoint-keep 3, --events, --metrics-dump
   and --step-timing (rows 1-2), at JAX's baked rounds, count and estimate
   with the launches of the run without hooks, the last generation's array
   digests the run's; then the newest generation bit-flipped and --resume
   auto: quarantined, resumed from the generation before it, bitwise; kernel
   A at 1,000,000 full push-sum under a crash and a revival schedule resumed
   from a checkpoint at the revival round, and row 3 at 4,194,305 resumed
   mid-run, each bitwise the run without hooks; --stall-chunks 2 on row 2
   stalled at the JAX chunked engine's baked rounds, without and with a
   crash; row 1's checkpoint at full 20,000 resumed on the CPU (the plain
   version) and the CPU's resumed on the card, both bitwise the card's run.
   Prints each checkpoint's write_s and the CLI runs' run_s beside the runs
   without hooks;
14s. (run after 14r) the replica sweep and the lane server (ROADMAP A9a):
   full 1,000,000 push-sum and gossip --replicas 8 through the CLI, kernel
   A one launch a live lane a chunk on one stream (counted from zero around
   each run), at the JAX package's baked rounds, replica 0 bitwise the
   one-shot run(); grid2d 1,000,000 push-sum, 4 replicas to round 256
   through run_replicas on stencil delivery (the chunked engine's torch
   rounds) at JAX's baked rounds and converged counts, replica 0 bitwise the
   one-shot run; serve_lanes at full 65,536 push-sum on 4 lanes with 8
   tickets, one killed by its deadline at the first boundary, each ticket
   bitwise its one-shot run and at JAX's baked rounds; and the same sweeps
   and lane server at CPU sizes, every lane bitwise the port's CPU run.
   Prints each sweep's wall a replica beside the one-shot run's and kernel
   A's launches a chunk;

Each of phases 5-14s prints its wall time.

Prints the ``kernels`` JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

``--phase 14s`` runs phase 14s alone (its kernels built on first use) and
ends with ``{"ok": true, "mode": "phase 14s", "device": {...}}``.

``--cards N`` runs none of these phases: it runs the sharded imp path and
the replicated-pool2 path with shard i on cuda:i against the same runs on
one card, times each wire across cards, runs rows 15-16's global runs
from the crafted state across the cards against one card (phase 14m's
runs), and ends with ``{"ok": true, "mode": "cards N", "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

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


def lattice_global_cards(cards):
    """``--cards N``: rows 15-16's global runs with shard i on cuda:i,
    torus3d 100**3 (resident) and 256**3 (streaming) in N shards from phase
    14l's crafted state, each bitwise the same run with every shard on
    cuda:0 and the single-device run (the exact stop round, every plane):
    the verdict's capped rerun and the conv latch reach every card."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import sharded_tier
    from cop5615_gossip_protocol_tpu_torch.ops.fused_pool import build_pool_layout

    devices = [torch.device("cuda", i) for i in range(cards)]
    for n, tier in ((1_000_000, "fused_sharded"), (LATTICE_N, "stencil_hbm_sharded")):
        topo = build_topology("torus3d", n)
        cfg = SimConfig(n=n, topology="torus3d", algorithm="push-sum", engine="fused",
                        termination="global", n_devices=cards)
        if sharded_tier(topo, cfg)[:2] != (tier, None):
            raise AssertionError(f"torus3d n={n} x{cards}: the ladder picks "
                                 f"{sharded_tier(topo, cfg)}")
        _, canon = crafted_state(n, build_pool_layout(n).n_pad, devices[0])
        start = {"start_state": canon, "start_round": GLOBAL_START}
        single = run(topo, dataclasses.replace(cfg, n_devices=None), **start)
        one = run(topo, cfg, devices=[devices[0]] * cards, **start)
        spread = run(topo, cfg, **start)
        same = all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x.cpu(), y.cpu())
                   for a in (one, single) for x, y in zip(spread.state, a.state))
        print(json.dumps({
            "metric": f"pushsum_global_{tier}_torus3d_n{n}_x{cards}_cards",
            "rounds": spread.rounds, "one_card_rounds": one.rounds,
            "single_device_rounds": single.rounds, "run_s": spread.run_s,
            "one_card_run_s": one.run_s, "converged_count": spread.converged_count,
            "bitwise_one_card_and_single": same, "device": spread.device}), flush=True)
        if not (spread.rounds == one.rounds == single.rounds and same
                and spread.converged_count == n):
            raise AssertionError(f"{tier} global on {cards} cards differs from one card")


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

    for algorithm, termination in (("gossip", "local"), ("push-sum", "local"),
                                   ("push-sum", "global")):
        cfg = SimConfig(n=IMP_SHARD_RUN_N, topology="imp3d", algorithm=algorithm,
                        delivery="pool", pool_size=IMP_POOL, engine="fused",
                        n_devices=cards, termination=termination)
        single = run(topo, dataclasses.replace(cfg, n_devices=None))
        one = run(topo, cfg, devices=[devices[0]] * cards)
        spread = run(topo, cfg)
        same = all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x.cpu(), y.cpu())
                   for a in (one, single) for x, y in zip(spread.state, a.state))
        tag = algorithm if termination == "local" else f"{algorithm}_global"
        print(json.dumps({
            "metric": f"{tag}_imp_hbm_sharded_imp3d_n{IMP_SHARD_RUN_N}_x{cards}_cards",
            "rounds": spread.rounds, "one_card_rounds": one.rounds,
            "single_device_rounds": single.rounds, "run_s": spread.run_s,
            "one_card_run_s": one.run_s, "single_device_run_s": single.run_s,
            "dispatch_s": spread.dispatch_s, "fetch_s": spread.fetch_s,
            "converged_count": spread.converged_count,
            "estimate_mae": spread.estimate_mae, "bitwise_one_card_and_single": same,
            "device": spread.device}), flush=True)
        if not spread.rounds == one.rounds == single.rounds or not same:
            raise AssertionError(f"{tag} on {cards} cards differs from one card")
        if termination == "global":
            continue  # the wire is push-sum's, timed above
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
    # The failure model across cards: the send bits ride the wire with the
    # summary rows (phase 14l's configs, at its whole runs' population).
    n = SHARD_FAULT_N
    topo = build_topology("full", n)
    for name, algorithm, label in SHARD_FAULT_CONFIGS:
        if SHARD_FAULT_TIMED[name] != label:
            continue
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL,
                        engine="fused", n_devices=cards, **shard_fault_knobs(label, n))
        single = run(topo, dataclasses.replace(cfg, n_devices=None))
        one = run(topo, cfg, devices=[devices[0]] * cards)
        halo.exchange_rows_batched.copies = 0
        spread = run(topo, cfg)
        copies = halo.exchange_rows_batched.copies
        same = bitwise(spread, one) and bitwise(spread, single)
        print(json.dumps({
            "metric": f"{name}_pool2_sharded_{label}_full_n{n}_x{cards}_cards",
            "wire": p2s.plan_pool2_sharded(topo, cfg, cards)[3], "rounds": spread.rounds,
            "one_card_rounds": one.rounds, "single_device_rounds": single.rounds,
            "run_s": spread.run_s, "one_card_run_s": one.run_s,
            "single_device_run_s": single.run_s, "converged_count": spread.converged_count,
            "wire_copies": copies, "bitwise_one_card_and_single": same,
            "device": spread.device}), flush=True)
        if not spread.rounds == one.rounds == single.rounds or not same or not copies:
            raise AssertionError(f"replicated-pool2 {name} {label} on {cards} cards "
                                 "differs from one card, or its wire copied nothing")


# The scatter path (ops/scatter.py, csrc/scatter.cu: kernel A) and the walk
# (models/reference.py, csrc/walk.cu: kernel B). Kernel A's checks, one
# round at a time: 1M full (both algorithms) and imp3d 1000 in reference
# semantics (its Q8 orphans, nodes of degree 0 that do not send); the
# rounds run before the mid-run checks (1M push-sum converges near round
# 674, gossip near 56); and the rounds of the timed chunk from there.
SCATTER_CASES = (("full", 1_000_000, "batched"), ("imp3d", 1000, "reference"))
SCATTER_MID = {"pushsum": 300, "gossip": 8}
SCATTER_TIMED = {"pushsum": CHUNK, "gossip": 8}
# The largest full population of phase 14f's checks: the fused tiers' cap.
SCATTER_LARGEST = 2**27
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
# Phase 14h's further walks, each bitwise the plain walk on the CPU, with
# the kernel tier each must run: (kind, n, max_rounds or None, tier). Line
# 1000 comes back to a node two hops later all the time (to its 1M-hop
# cap); 4,099 hops is no multiple of the kernel's ring half (1,024 hops);
# full 100,000 and imp3d 8000 outgrow the shared memory of a block.
WALK_CHECKS = (("line", 1000, None, "shared"), ("full", 1000, 4099, "shared"),
               ("full", 100_000, 500_000, "global"), ("imp3d", 8000, 500_000, "global"))
# Hops a launch of the walk in phase 14h's split walk.
WALK_SPLIT_HOPS = 1000
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


def scatter_scratch_zero(label, graph):
    """Kernel A's zero planes (push-sum's bucket counts, gossip's receipts,
    both round parities) must be zero between chunks."""
    import torch

    for name in ("counts", "inbox"):
        plane = graph.work.get(name)
        if plane is not None and torch.count_nonzero(plane).item():
            raise AssertionError(f"{label}: the scratch {name} is not zero after the chunk")


def scatter_checks(dev, key):
    """Phase 14f: kernel A (csrc/scatter.cu) against its plain version on
    the card, at SCATTER_CASES, both algorithms: one round from the initial
    state; from a mid-run state one round, no round, a SCATTER_TIMED-round
    chunk and chunks capped after 5 and 6 rounds; a chunk that reaches done
    three rounds in, then a chunk from its result; from a converged state
    one real round, and one with the done flag set; every plane and the
    status bitwise, the scratch zero after every kernel chunk. Then
    scatter_largest. Returns {(name, kind): case} for the timing phase and
    {name: max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import build_topology
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
            kern, plain, chunk, init = scatter_fns(dev, key, topo, graph, algorithm,
                                                   semantics, round_keys)

            def check(label, state, start, count, done=0, chunk=chunk, kern=kern,
                      plain=plain):
                got = chunk(kern, state, start, count, done)
                scatter_scratch_zero(label, graph)
                want = chunk(plain, state, start, count, done)
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
            for count in (1, 0, SCATTER_TIMED[name], 5, 6):
                errs.append(check(f"{tag} mid-run state, a chunk of {count} rounds", mid,
                                  mid_round, count)[0])
            state, st, rnd = init, None, 0
            while st is None or not st[1]:
                if rnd >= 100_000:
                    raise AssertionError(f"{tag}: no convergence in {rnd} rounds")
                state, st = chunk(kern, state, rnd, 512)
                st, rnd = st.tolist(), rnd + 512
            final = st[0]
            # Done three rounds into an 8-round chunk; then a chunk from its
            # result, which must change nothing.
            late, _ = chunk(kern, init, 0, final - 3)
            err, (ended, st_end) = check(f"{tag} state of round {final - 3}, 8 rounds "
                                         f"(done after 3)", late, final - 3, 8)
            errs.append(err)
            if st_end.tolist() != [final, 1]:
                raise AssertionError(f"{tag}: done mid-chunk gave {st_end.tolist()}, "
                                     f"want [{final}, 1]")
            again, st_again = chunk(kern, ended, final, 8, done=1)
            scatter_scratch_zero(f"{tag} a chunk after done", graph)
            same_planes(f"{tag} a chunk after done", again, ended)
            if st_again.tolist() != st_end.tolist():
                raise AssertionError(f"{tag}: a chunk after done moved the status")
            print(f"  {tag} a chunk after the done chunk: nothing moved, scratch zero",
                  flush=True)
            errs.append(check(f"{tag} converged state (round {final}), one round",
                              state, final, 1)[0])
            err, (same, after) = check(f"{tag} converged state, done flag set", state,
                                       final, 1, done=1)
            same_planes(f"{tag} a round after done", same, state)
            if after.tolist() != [final, 1]:
                raise AssertionError(f"{tag}: a round after done moved the status")
            max_err[name] = max(max_err.get(name, 0.0), *errs, err)
            cases[name, kind] = (kern, plain, chunk, mid, mid_round, topo.n, graph)
    for name, err in scatter_largest(dev, key, round_keys).items():
        max_err[name] = max(max_err[name], err)
    torch.cuda.synchronize()
    return cases, max_err


def scatter_fns(dev, key, topo, graph, algorithm, semantics, round_keys):
    """(kernel wrapper, plain version, chunk, initial state) of kernel A
    on ``topo``: ``chunk(fn, state, start, count, done=0)`` runs ``count``
    rounds from absolute round ``start`` under a fresh status."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    cfg = SimConfig(n=topo.n, topology=topo.kind, algorithm=algorithm,
                    semantics=semantics)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    if algorithm == "push-sum":
        init = pushsum_mod.init_state(topo.n, cfg.initial_term_round, dev)
        kw = {"graph": graph, "target": target, "delta": cfg.resolved_delta,
              "term_rounds": cfg.term_rounds}
        kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
    else:
        init = gossip_mod.init_state(topo.n, draw_leader(key, topo, cfg),
                                     cfg.reference and topo.kind == "full", dev)
        kw = {"graph": graph, "target": target,
              "rumor_target": cfg.resolved_rumor_target,
              "suppress": cfg.resolved_suppress}
        kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain

    def chunk(fn, state, start, count, done=0):
        # The kernel's wrapper folds the round keys on the card from the
        # run's key; the plain version takes them drawn on the host.
        status = torch.tensor([start, done], dtype=torch.int32, device=dev)
        if fn is plain:
            return fn(state, round_keys(start, count), status, **kw)
        return fn(state, key, start, count, status, **kw)

    return kern, plain, chunk, init


def scatter_largest(dev, key, round_keys):
    """Kernel A at the largest size a user runs on ``full`` (2**27, the
    fused tiers' cap; past it the chunked engine runs scatter too): one
    2-round chunk of each algorithm from the initial state, bitwise its
    plain version, with the scratch's size printed. Returns {name:
    max_abs_err}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import build_topology
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    n = SCATTER_LARGEST
    topo = build_topology("full", n)
    graph = scatter.scatter_graph(topo, dev)
    errs = {}
    for algorithm in ("push-sum", "gossip"):
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        kern, plain, chunk, init = scatter_fns(dev, key, topo, graph, algorithm,
                                               "batched", round_keys)
        label = f"{name} full n={n:,} initial state, 2 rounds"
        got = chunk(kern, init, 0, 2)
        scatter_scratch_zero(label, graph)
        scratch = sum(x.numel() * x.element_size() for x in graph.work.values())
        want = chunk(plain, init, 0, 2)
        if got[1].tolist() != want[1].tolist():
            raise AssertionError(f"{label}: status {got[1].tolist()} != plain "
                                 f"{want[1].tolist()}")
        errs[name] = same_planes(label, got[0], want[0])
        print(f"  {label}: status {got[1].tolist()}, bitwise; scratch "
              f"{scratch / 2**30:.2f} GiB", flush=True)
        del got, want, init
        torch.cuda.empty_cache()
    graph.work.clear()
    torch.cuda.empty_cache()
    return errs


# The wait between a trace's start and the work it traces (cuda_profile).
TRACE_LEAD_S = 0.2


def cuda_profile():
    """torch.profiler over the card's activity alone, its warning that it
    keeps one cycle's events silenced (one cycle is all this takes). The
    trace waits TRACE_LEAD_S after it starts before the stack is handed
    back. With the host's cores busy, a trace entered just before a run
    now and then lacked the run's first launches (1 to 7 of a scatter
    run's 19 round kernels, in 1 to 3 of 300 traces; the first launch it
    kept began within 0.5 ms of its start), and none of 300 traces with
    the wait did (scripts/profiler_window.py)."""
    import contextlib

    import torch

    stack = contextlib.ExitStack()
    stack.enter_context(warnings.catch_warnings())
    warnings.simplefilter("ignore", UserWarning)
    prof = stack.enter_context(torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]))
    time.sleep(TRACE_LEAD_S)
    return stack, prof


def device_kernels(prof):
    """{short name: (events, device µs in all)} of a torch.profiler trace's
    device activity (kernels, copies, memsets), the name cut to its
    function's (``pushsum_rounds``)."""
    out = {}
    for ev in prof.key_averages():
        us_total = getattr(ev, "device_time_total", None)
        if us_total is None:
            us_total = getattr(ev, "cuda_time_total", 0.0)
        if us_total and ev.count:
            short = ev.key.replace("(anonymous namespace)::", "")
            short = short.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1]
            short = short or ev.key[:40]
            count, us = out.get(short, (0, 0.0))
            out[short] = (count + ev.count, us + us_total)
    return out


def profiled(fn, stem=None):
    """({short name: (events, device µs)} of the device activity of
    ``fn()``, by torch.profiler; fn's result). torch.profiler has handed
    back a trace with no device activity at all (no kernel, copy or
    memset) now and then on the H100, and once a trace without the round
    kernel a chunk had launched: such a trace (with none, or, when ``stem``
    is given, with no kernel whose name holds it) is taken again, at most
    twice; any other trace is returned as it is."""
    import torch

    for _ in range(3):
        stack, prof = cuda_profile()
        with stack:
            out = fn()
            torch.cuda.synchronize()
        traced = device_kernels(prof)
        if traced and (stem is None or any(stem in short for short in traced)):
            break
    return traced, out


def scatter_path(dev, cpu_runs):
    """Phase 14g: the scatter path through run() on the card, counters
    zeroed before each run and read after it, the pipeline's status reads
    counted: SCATTER_RUNS against the port's CPU runs (``cpu_runs``, the
    worker's result: rounds, converged count, every plane bitwise), and
    1M full push-sum; each against the JAX chunked engine's rounds and
    estimate, push-sum with its mass conserved; one status read a chunk;
    one launch a chunk of rounds by the wrapper's counter, and the same
    run again under torch.profiler with one ``*_rounds`` kernel in the
    card's trace a chunk of rounds. Returns {name: launches on its
    main-path run}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models import pipeline, runner
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    counters = {"pushsum": scatter.pushsum_scatter_chunk,
                "gossip": scatter.gossip_scatter_chunk}
    launches = {}
    reads = []
    calls = []  # the rounds of each chunk the runner asks for
    real_read, real_make = pipeline._read, runner._make_chunk_fn

    def counted_read(handle):
        reads.append(1)
        return real_read(handle)

    def counted_make(*args, **kw):
        chunk_fn, state0 = real_make(*args, **kw)

        def counted_chunk(state, status, start, end):
            calls.append(max(end - start, 0))
            return chunk_fn(state, status, start, end)
        return counted_chunk, state0

    pipeline._read = counted_read
    runner._make_chunk_fn = counted_make
    try:
        for kind, n, algorithm in SCATTER_RUNS + (("full", 1_000_000, "push-sum"),):
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            topo = build_topology(kind, n)
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm)
            for fn in counters.values():
                fn.launches = 0
            reads.clear()
            calls.clear()
            res = run(topo, cfg)
            count = counters[name].launches
            chunks = len(res.chunk_log)
            status_reads = len(reads)
            # The chunks the runner queued that hold rounds: the warmup, the
            # retired chunks and the one in flight at the end.
            queued = sum(1 for k in calls if k > 0)
            # The same run again under torch.profiler: the round kernels in
            # the card's own trace, one a chunk of rounds.
            for fn in counters.values():
                fn.launches = 0
            calls.clear()
            stack, prof = cuda_profile()
            with stack:
                run(topo, cfg)
                torch.cuda.synchronize()
            traced = device_kernels(prof).get(f"{name}_rounds", (0, 0.0))[0]
            traced_queued = sum(1 for k in calls if k > 0)
            print(json.dumps({
                "metric": f"{name}_scatter_rounds_per_sec_{kind}_n{topo.n}",
                "rounds": res.rounds, "run_s": res.run_s,
                "rounds_per_s": res.rounds / res.run_s, "setup_s": res.setup_s,
                "compile_s": res.compile_s, "dispatch_s": res.dispatch_s,
                "fetch_s": res.fetch_s, "chunks_retired": chunks,
                "status_reads": status_reads, "chunks_of_rounds_queued": queued,
                "launches": count, "launches_per_chunk": count / queued,
                "traced_run": {"kernels_in_trace": traced,
                               "launches": counters[name].launches,
                               "chunks_of_rounds_queued": traced_queued},
                "converged_count": res.converged_count,
                "estimate_mae": res.estimate_mae, "device": res.device}), flush=True)
            if not res.converged or res.converged_count != topo.n:
                raise AssertionError(f"{kind} n={topo.n} {algorithm} did not converge")
            if status_reads != chunks:
                raise AssertionError(f"{kind} {algorithm}: {status_reads} status reads "
                                     f"for {chunks} chunks")
            if count != queued:
                raise AssertionError(f"{kind} {algorithm}: {count} launches of "
                                     f"{name}_scatter for {queued} chunks of rounds "
                                     f"({res.rounds} rounds), not one a chunk")
            if not traced == counters[name].launches == traced_queued:
                raise AssertionError(f"{kind} {algorithm}, traced run: {traced} "
                                     f"{name}_rounds kernels in the trace, the counter "
                                     f"{counters[name].launches}, {traced_queued} chunks "
                                     f"of rounds: not one launch a chunk")
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
        pipeline._read, runner._make_chunk_fn = real_read, real_make
    torch.cuda.synchronize()
    return launches


def walk_path(dev, key):
    """Phase 14h: the walk (kernel B, csrc/walk.cu) through run() on the
    card at WALK_RUNS and WALK_CHECKS, its launch counters (in all and by
    tier) zeroed before each run and read after it, against the plain walk
    on the CPU (every plane, the message, hops, the dead latch, bitwise)
    and at WALK_RUNS the JAX package's hops; hops/s of both. Then the full
    1000 walk in launches of WALK_SPLIT_HOPS hops against one launch, and a
    Q8 death. Returns ({(kind, n): case} for the timing phase, launches of
    the first walk, max_abs_err)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models import reference

    cases, launches, err = {}, None, 0.0
    runs = [(kind, n, None, "shared", hops) for (kind, n), hops in WALK_RUNS.items()]
    runs += [(kind, n, cap, tier, None) for kind, n, cap, tier in WALK_CHECKS]
    for kind, n, cap, tier, hops in runs:
        topo = build_topology(kind, n, semantics="reference")
        cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference",
                        **({} if cap is None else {"max_rounds": cap}))
        reference.walk_hops.launches = 0
        reference.walk_hops.launches_by_tier = dict.fromkeys(reference.TIERS, 0)
        card = run(topo, cfg)
        count = reference.walk_hops.launches
        by_tier = dict(reference.walk_hops.launches_by_tier)
        plain = run(topo, cfg, device="cpu")
        label = f"walk {kind} n={topo.n}" + ("" if cap is None else f" capped at {cap}")
        err = max(err, same_planes(label, [x.cpu() for x in card.state], plain.state))
        if (card.rounds, card.converged_count, card.estimate_mae) != (
                plain.rounds, plain.converged_count, plain.estimate_mae) or (
                hops is not None and card.rounds != hops) or (
                cap is not None and card.rounds != cap):
            raise AssertionError(f"{label}: card {card.rounds} hops, CPU {plain.rounds}, "
                                 f"JAX {hops}, cap {cap}")
        if count == 0 or by_tier[tier] != count:
            raise AssertionError(f"{label}: {count} launches of the walk kernel, by tier "
                                 f"{by_tier}, not all in the {tier} tier")
        print(json.dumps({
            "metric": f"walk_hops_per_sec_{kind}_n{topo.n}", "hops": card.rounds,
            "max_rounds": cfg.max_rounds, "outcome": card.outcome,
            "run_s": card.run_s, "hops_per_s": card.rounds / card.run_s,
            "plain_run_s": plain.run_s, "plain_hops_per_s": plain.rounds / plain.run_s,
            "launches": count, "launches_by_tier": by_tier,
            "converged_count": card.converged_count,
            "estimate_mae": card.estimate_mae, "device": card.device}), flush=True)
        if launches is None:
            launches = count
            MAIN_ROUNDS["walk_hops"] = card.rounds
        if hops is not None:
            cases[kind, n] = (topo, cfg, card.rounds, plain.run_s)
    err = max(err, walk_split(dev, key), walk_q8(dev, key))
    torch.cuda.synchronize()
    return cases, launches, err


def walk_split(dev, key):
    """The full 1000 walk in launches of WALK_SPLIT_HOPS hops (each resumed
    inside a ring half) against the same walk in one launch, bitwise."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    topo = build_topology("full", 1000, semantics="reference")
    cfg = SimConfig(n=1000, topology="full", algorithm="push-sum", semantics="reference")
    graph = scatter.scatter_graph(topo, dev)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    kw = {"max_steps": cfg.max_rounds, "target": target, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}
    c0 = reference.make_walk(topo, cfg, key, draw_leader(key, topo, cfg), dev)
    whole, _ = reference.walk_hops(c0, key, graph, hops=reference.LAUNCH_HOPS, **kw)
    carry, calls = c0, 0
    while True:
        carry, status = reference.walk_hops(carry, key, graph, hops=WALK_SPLIT_HOPS, **kw)
        calls += 1
        steps, count, dead = status.tolist()
        if dead or steps >= cfg.max_rounds or count >= target:
            break
    err = same_planes(f"walk full 1000 in {calls} launches of {WALK_SPLIT_HOPS} hops vs one",
                      list(carry), list(whole))
    print(f"  walk full n={topo.n} in {calls} launches of {WALK_SPLIT_HOPS} hops: "
          f"{steps} hops, bitwise one launch", flush=True)
    return err


def walk_q8(dev, key):
    """A Q8 death on the card: the three-node graph of
    tests/test_torch_reference_walk.py with node 2 an orphan, the walk
    forced onto it, against the plain walk; a dead carry takes no hop."""
    import numpy as np
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.ops import scatter
    from cop5615_gossip_protocol_tpu_torch.ops.topology import Topology

    topo = Topology("line", 3, 3, 3, 1, np.array([[1], [0], [0]], np.int32),
                    np.array([1, 1, 0], np.int32))
    cfg = SimConfig(n=3, topology="line", algorithm="push-sum", semantics="reference")
    kw = {"hops": 5, "max_steps": 100, "target": 3, "delta": cfg.resolved_delta,
          "term_rounds": 3}
    c0 = reference.make_walk(topo, cfg, key, 0)._replace(
        cur=torch.tensor(2, dtype=torch.int32))
    want, want_st = reference.walk_hops(c0, key, scatter.scatter_graph(topo, "cpu"), **kw)
    graph = scatter.scatter_graph(topo, dev)
    got, st = reference.walk_hops(reference.WalkCarry(*(x.to(dev) for x in c0)), key,
                                  graph, **kw)
    err = same_planes("walk Q8 orphan", list(got), list(want))
    again, again_st = reference.walk_hops(got, key, graph, **kw)
    err = max(err, same_planes("walk Q8 orphan, dead carry", list(again), list(want)))
    if not (st.tolist() == want_st.tolist() == again_st.tolist() == [2, 0, 1]):
        raise AssertionError(f"walk Q8 orphan: status {st.tolist()}, "
                             f"{again_st.tolist()}, plain {want_st.tolist()}")
    print(f"  walk Q8 orphan: dead after 1 hop at node {int(got.cur)}, bitwise the "
          "plain walk; a dead carry takes no hop", flush=True)
    return err


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
              f"{got[1]}, run_s {rec['run_s']}, rounds/s {got[0] / rec['run_s']:.6g}, "
              f"{time.perf_counter() - t0:.2f} s, launches {counts}", flush=True)
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
        # round: where a round's time goes among its passes; and the chunk's
        # launches, by the wrapper's counter and by the kernels in the trace.
        def once():
            kern.launches = 0
            return chunk(kern, mid, mid_round, K)

        traced, _ = profiled(once)
        counted = kern.launches
        passes = {short: us / rounds for short, (_, us) in traced.items()}
        # The round kernel by its name's stem: an instance of a template
        # (the fault-free one here) may come out of the trace mangled.
        in_trace = sum(count for short, (count, _) in traced.items()
                       if f"{name}_rounds" in short)
        if not counted == in_trace == 1:
            raise AssertionError(f"{name} scatter: a {K}-round chunk launched {counted} "
                                 f"times by its counter, {in_trace} in the trace, not "
                                 f"once (the trace: {sorted(traced)})")
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
            "launches_a_chunk": counted, "kernels_a_chunk_in_trace": in_trace,
            "population": n, "topology": "full", "status": "ported",
        })
    return rows


def walk_row(dev, key, cases, launches, max_err):
    """Kernel B's row: the whole 1000 full walk from its kickoff in one
    launch, by CUDA events, beside the plain walk's time on the host; its
    bound the hop chain, a latency: hops times what a hop must wait on from
    the hop before, on full the message's and the pick's arithmetic (timed
    by the arith_chain kernel), on an explicit topology two dependent
    accesses at the walk's working set (timed by the chase kernel in shared
    memory and in global memory; the tier the walk runs prices it). Its
    ``bound_by`` says "operations", a chain of dependent ones; the
    bytes/operations bound stands beside it."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    timed = {}
    for (kind, n), (topo, cfg, hops, plain_s) in cases.items():
        graph = scatter.scatter_graph(topo, dev)
        tier, _ = reference.walk_tier(graph)
        leader = draw_leader(key, topo, cfg)
        c0 = reference.make_walk(topo, cfg, key, leader, dev)
        target = cfg.resolved_target_count(topo.n, topo.target_count)
        ms, (_, st) = time_ms(lambda: reference.walk_hops(
            c0, key, graph, hops=reference.LAUNCH_HOPS, max_steps=cfg.max_rounds,
            target=target, delta=cfg.resolved_delta, term_rounds=cfg.term_rounds), 3)
        walked = int(st[0]) - 1
        # One dependent access at the walk's working set: a random cycle
        # over as many ints as the walk keeps (a 16-byte record a node and,
        # on an explicit topology, its staged row: max_deg + 3 ints).
        words = topo.n * 4 + (0 if topo.implicit else topo.n * (topo.max_deg + 3))
        gen = torch.Generator().manual_seed(0)
        perm = torch.randperm(words, generator=gen)
        nxt = torch.empty(words, dtype=torch.int32)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        nxt = nxt.to(dev)
        steps = 1 << 20
        access_ns = {}
        for memory in reference.TIERS:
            chase_ms, _ = time_ms(lambda: reference.chase(nxt, steps, memory == "shared"), 3)
            access_ns[memory] = chase_ms * 1e6 / steps
        # A hop's loop-carried arithmetic, with no memory: the message's add
        # and multiply, and on full the pick's add and minimum beside it.
        arith_ms, _ = time_ms(lambda: reference.arith_chain(steps, topo.n, dev,
                                                            topo.implicit), 3)
        arith_ns = arith_ms * 1e6 / steps
        # The hop chain, what no design takes off it. On full the next
        # node's record is read a hop ahead and its index is arithmetic on
        # a prepared shift, so hop to hop only arithmetic depends on the hop
        # before (a record written two hops before is read after its write,
        # about one hop in n); on an explicit topology the next node waits
        # on two dependent accesses (its staged row, then its neighbour
        # column), beside the message's arithmetic.
        if topo.implicit:
            chain_ns = dict.fromkeys(access_ns, arith_ns)
            chain_kind = ("latency: the message's add and multiply and the pick's add "
                          "and minimum a hop (arith_chain), no dependent access")
        else:
            chain_ns = {m: max(2 * ns, arith_ns) for m, ns in access_ns.items()}
            chain_kind = (f"latency: 2 dependent {tier}-memory accesses a hop (chase), "
                          "beside the message's add and multiply")
        chain_ms = {m: walked * ns * 1e-6 for m, ns in chain_ns.items()}
        moved = topo.n * 13 * 2 + (0 if topo.implicit else topo.n * (topo.max_deg + 1) * 4)
        ops = walked * WALK_HOP_OPS
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        timed[kind] = {
            "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": chain_ms[tier],
            "bound_by": "operations", "bound_kind": chain_kind,
            "tier": tier, "chain_bound_ms_by_memory": chain_ms,
            "dependent_access_ns": access_ns, "hop_arith_ns": arith_ns,
            "bytes_ops_bound_ms": max(bytes_ms, ops_ms),
            "bytes_ops_bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "over_chain_bound": ms / chain_ms[tier], "hops_per_call": walked,
            "us_per_hop": ms * 1e3 / walked, "population": topo.n, "topology": kind,
        }
    return {
        "name": "walk_hops", "route": "cuda",
        "source": "cop5615_gossip_protocol_tpu_torch/csrc/walk.cu",
        "replaces": "cop5615_gossip_protocol_tpu/models/reference.py:153",
        "launches": launches, "max_abs_err": max_err, **timed["full"],
        "library_ms": None, "at_imp3d": timed["imp3d"], "status": "ported",
    }


# The failure model on the two main paths: the drop gate, crash-stop with
# quorum termination and push-sum's global termination, in rows 1-2
# (csrc/fused_pool.cu) and kernel A (csrc/scatter.cu). Phase 14j's kernel
# checks run each kernel's faulted instance at 1M full against its plain
# version under FAULT_CFGS; its runs through run() and the CLI end at the
# baked FAULT_RUNS constants.
FAULT_CFGS = {
    "pushsum crash": ("push-sum", {"fault_rate": 0.1,
                                   "crash_schedule": "5:10000,20:50000",
                                   "quorum": 0.95}),
    "pushsum global": ("push-sum", {"fault_rate": 0.1, "termination": "global"}),
    "gossip crash": ("gossip", {"fault_rate": 0.1, "crash_rate": 0.001,
                                "quorum": 0.9}),
}
# Rounds run before each config's mid-run checks and timings (at 1M the
# pool runs end near rounds 166, 58 and 34).
FAULT_MID = {"pushsum crash": 60, "pushsum global": 30, "gossip crash": 8}
# The runs, each with (rounds, converged count) baked from the CPU, seed 0:
# the pool push-sum ones from the port's plain versions,
#   run(build_topology("full", 1000000), SimConfig(n=1000000,
#       algorithm="push-sum", delivery="pool", pool_size=2, engine="fused",
#       <kw>), device="cpu")
# the others from the JAX package's chunked engine,
#   run(build_topology(kind, n), SimConfig(n=n, topology=kind,
#       algorithm=algorithm, engine="chunked", <kw>))
# (the CLI's as ``python -m cop5615_gossip_protocol_tpu <argv>
# --platform cpu`` gives them).
FAULT_RUNS = (
    # (label, argv of the CLI or None, kind, n, algorithm, kw, baked)
    ("pool push-sum gate+crash", None, "full", 1_000_000, "push-sum",
     {"delivery": "pool", "pool_size": 2, "fault_rate": 0.1,
      "crash_schedule": "5:10000,20:50000", "quorum": 0.95}, (166, 893_003)),
    ("pool push-sum gate+global", None, "full", 1_000_000, "push-sum",
     {"delivery": "pool", "pool_size": 2, "fault_rate": 0.1,
      "termination": "global"}, (58, 1_000_000)),
    ("pool gossip crash", None, "full", 1_000_000, "gossip",
     {"delivery": "pool", "pool_size": 2, "crash_rate": 0.001, "quorum": 0.9},
     (34, 909_960)),
    ("CLI scatter gossip", ("1000000", "full", "gossip", "--fault-rate", "0.2",
                            "--crash-schedule", "3:10000", "--quorum", "0.9"),
     "full", 1_000_000, "gossip",
     {"fault_rate": 0.2, "crash_schedule": "3:10000", "quorum": 0.9},
     (42, 908_471)),
    ("CLI scatter push-sum", ("100000", "imp2D", "push-sum", "--fault-rate",
                              "0.2", "--crash-schedule", "3:10000", "--quorum",
                              "0.9"),
     "imp2d", 100_000, "push-sum",
     {"fault_rate": 0.2, "crash_schedule": "3:10000", "quorum": 0.9},
     (320, 81_629)),
)
# The runs again at this population, each on the card against the port's
# CPU run of the same config (rounds, converged count, every plane), which
# the worker computes while the card runs the earlier phases; a crash
# schedule there is scaled to the population.
FAULT_SMALL_N = 70_000


def small_fault_runs():
    """(label, kind, n, algorithm, kw) of FAULT_RUNS at FAULT_SMALL_N."""
    out = []
    for label, _, kind, n, algorithm, kw, _ in FAULT_RUNS:
        kw = dict(kw)
        if "crash_schedule" in kw:
            kw["crash_schedule"] = ",".join(
                f"{r}:{int(c) * FAULT_SMALL_N // n}" for r, c in
                (e.split(":") for e in kw["crash_schedule"].split(",")))
        out.append((label, kind, FAULT_SMALL_N, algorithm, kw))
    return out


def cpu_fault_runs():
    """The port's CPU runs of small_fault_runs(): {label: (rounds,
    converged count, [planes as numpy])}. Runs in the worker process."""
    import os

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for label, kind, n, algorithm, kw in small_fault_runs():
        res = run(build_topology(kind, n), SimConfig(n=n, topology=kind,
                                                     algorithm=algorithm, **kw),
                  device="cpu")
        out[label] = (res.rounds, res.converged_count, [x.numpy() for x in res.state])
    return out


def fault_pool_fns(dev, key, algorithm, kw):
    """Rows 1-2 under a failure model at N: (kernel, plain, chunk, initial
    state), chunk(fn, state, start, count, cap=None) as pool_fns'."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool

    n = N
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL, **kw)
    faults = fused.run_faults(cfg, n)
    layout = fused_pool.build_pool_layout(n)

    @functools.lru_cache(maxsize=None)
    def streams(start, count):
        return (fused.round_keys(key, start, count),
                fused_pool.round_offsets(key, start, count, POOL, n))

    if algorithm == "push-sum":
        st = pushsum_mod.init_state(n, cfg.initial_term_round)
        init = tuple(fused._pad2d(x, layout, f).contiguous().to(dev) for x, f in (
            (st.s, 0.0), (st.w, 1.0), (st.term, 0), (st.conv.to(torch.int32), 0)))
        kern, plain = fused_pool.pushsum_pool_chunk, fused_pool.pushsum_pool_chunk_plain
        extra = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
    else:
        st = gossip_mod.init_state(n, draw_leader(key, build_topology("full", n), cfg),
                                   False)
        init = tuple(fused._pad2d(x.to(torch.int32), layout, 0).contiguous().to(dev)
                     for x in st)
        kern, plain = fused_pool.gossip_pool_chunk, fused_pool.gossip_pool_chunk_plain
        extra = {"rumor_target": cfg.resolved_rumor_target,
                 "suppress": cfg.resolved_suppress}

    def chunk(fn, state, start, count, cap=None):
        keys, offs = streams(start, count)
        return fn(state, keys, offs, start, start + count if cap is None else cap,
                  n=n, target=n, faults=faults, **extra)

    return kern, plain, chunk, init


def fault_scatter_fns(dev, key, graph, algorithm, kw):
    """Kernel A under a failure model at N full: (kernel, plain, chunk,
    initial state), chunk(fn, state, start, count, done=0) as
    scatter_fns'."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import fused, scatter

    n = N
    cfg = SimConfig(n=n, algorithm=algorithm, **kw)
    faults = fused.run_faults(cfg, n)
    if algorithm == "push-sum":
        init = pushsum_mod.init_state(n, cfg.initial_term_round, dev)
        extra = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
    else:
        init = gossip_mod.init_state(n, draw_leader(key, build_topology("full", n), cfg),
                                     False, dev)
        extra = {"rumor_target": cfg.resolved_rumor_target,
                 "suppress": cfg.resolved_suppress}
        kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain

    @functools.lru_cache(maxsize=None)
    def round_keys(start, count):
        return fused.round_keys(key, start, count)

    def chunk(fn, state, start, count, done=0):
        status = torch.tensor([start, done], dtype=torch.int32, device=dev)
        if fn is plain:
            return fn(state, round_keys(start, count), status, graph=graph,
                      target=n, start=start, faults=faults, **extra)
        return fn(state, key, start, count, status, graph=graph, target=n,
                  faults=faults, **extra)

    return kern, plain, chunk, init


def fault_checks(dev, key):
    """Phase 14j, the kernels: rows 1-2 and kernel A under each of
    FAULT_CFGS at 1M full against their plain versions on the card, every
    plane and count bitwise: a 32-round chunk from the initial state
    (across the crash schedule's death rounds 5 and 20), from a mid-run
    state a 32-round chunk and chunks capped after 5 and 6 rounds (both
    mark parities), a chunk that reaches the quorum (or the global verdict)
    three rounds in, and a chunk that starts at it (0 rounds, state
    unchanged). Returns ({(row, cfg): case} for the timing, {row:
    max_abs_err})."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import build_topology
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    graph = scatter.scatter_graph(build_topology("full", N), dev)
    cases, max_err = {}, {}
    for label, (algorithm, kw) in FAULT_CFGS.items():
        name = "pushsum" if algorithm == "push-sum" else "gossip"
        mid_round = FAULT_MID[label]
        # Rows 1-2.
        kern, plain, chunk, init = fault_pool_fns(dev, key, algorithm, kw)
        tag = f"{label} pool"
        errs = [compare(f"{tag} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                        chunk(plain, init, 0, CHUNK), 0)]
        mid, ex = chunk(kern, init, 0, mid_round)
        if int(ex) != mid_round:
            raise AssertionError(f"{tag}: done before round {mid_round}")
        errs.append(compare(f"{tag} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                            chunk(plain, mid, mid_round, CHUNK), 0))
        for extra in (5, 6):
            errs.append(compare(f"{tag} cap after {extra} rounds",
                                chunk(kern, mid, mid_round, CHUNK, cap=mid_round + extra),
                                chunk(plain, mid, mid_round, CHUNK, cap=mid_round + extra),
                                0))
        state, rnd = init, 0
        while True:
            out, ex = chunk(kern, state, rnd, 512)
            if int(ex) < 512:
                final = rnd + int(ex)
                break
            state, rnd = out, rnd + 512
            if rnd >= 100_000:
                raise AssertionError(f"{tag}: no verdict in {rnd} rounds")
        late, _ = chunk(kern, init, 0, final - 3)
        got = chunk(kern, late, final - 3, 8)
        errs.append(compare(f"{tag} from round {final - 3}, 8 rounds (done after 3)",
                            got, chunk(plain, late, final - 3, 8), 0))
        if int(got[1]) != 3:
            raise AssertionError(f"{tag}: the verdict came after {int(got[1])} rounds, not 3")
        at_quorum = got[0]
        for fn, who in ((kern, "kernel"), (plain, "plain")):
            same, ex0 = chunk(fn, at_quorum, final, CHUNK)
            if int(ex0) != 0 or not all(torch.equal(a, b) for a, b in zip(same, at_quorum)):
                raise AssertionError(f"{tag}: the {who} chunk from the verdict's state ran")
        print(f"  {tag}: verdict after round {final}; a chunk from it runs 0 rounds, "
              "state unchanged", flush=True)
        row = f"{name}_pool_chunk"
        max_err[row] = max(max_err.get(row, 0.0), *errs)
        cases[row, label] = (kern, plain, chunk, mid, mid_round)
        # Kernel A.
        kern, plain, chunk, init = fault_scatter_fns(dev, key, graph, algorithm, kw)
        tag = f"{label} scatter"

        def check(text, state, start, count, done=0, chunk=chunk, kern=kern,
                  plain=plain):
            got = chunk(kern, state, start, count, done)
            scatter_scratch_zero(text, graph)
            want = chunk(plain, state, start, count, done)
            if got[1].tolist() != want[1].tolist():
                raise AssertionError(f"{text}: status {got[1].tolist()} != plain "
                                     f"{want[1].tolist()}")
            err = same_planes(text, got[0], want[0])
            print(f"  {text}: status {got[1].tolist()}, bitwise", flush=True)
            return err, got

        errs = [check(f"{tag} initial state, {CHUNK} rounds", init, 0, CHUNK)[0]]
        mid, st = chunk(kern, init, 0, mid_round)
        if st.tolist() != [mid_round, 0]:
            raise AssertionError(f"{tag}: status {st.tolist()} after {mid_round} rounds")
        for count in (5, 6, SCATTER_TIMED[name]):
            errs.append(check(f"{tag} mid-run, {count} rounds", mid, mid_round, count)[0])
        state, st, rnd = init, None, 0
        while st is None or not st[1]:
            if rnd >= 100_000:
                raise AssertionError(f"{tag}: no verdict in {rnd} rounds")
            state, st = chunk(kern, state, rnd, 512)
            st, rnd = st.tolist(), rnd + 512
        final = st[0]
        late, _ = chunk(kern, init, 0, final - 3)
        err, (ended, st_end) = check(f"{tag} from round {final - 3}, 8 rounds "
                                     f"(done after 3)", late, final - 3, 8)
        errs.append(err)
        if st_end.tolist() != [final, 1]:
            raise AssertionError(f"{tag}: the verdict gave {st_end.tolist()}, "
                                 f"want [{final}, 1]")
        err, (same, after) = check(f"{tag} at the verdict, done flag set", ended, final,
                                   8, done=1)
        same_planes(f"{tag} a chunk after the verdict", same, ended)
        row = f"{name}_scatter_chunk"
        max_err[row] = max(max_err.get(row, 0.0), *errs, err)
        cases[row, label] = (kern, plain, chunk, mid, mid_round)
    graph.work.clear()
    torch.cuda.synchronize()
    return cases, max_err


def fault_phase(dev, key, cpu_small):
    """Phase 14j: fault_checks, then fault_path. Returns (cases, max_err,
    launches)."""
    cases, max_err = fault_checks(dev, key)
    return cases, max_err, fault_path(dev, cpu_small)


def fault_path(dev, cpu_small):
    """Phase 14j, the runs: FAULT_RUNS through run() (the CLI's as typed),
    counters zeroed before each and read after it; each must end
    "converged" at its baked rounds and converged count, push-sum with its
    mass over live and dead nodes conserved, and its faulted kernel must
    have launched. Then small_fault_runs() on the card against the
    worker's CPU runs (``cpu_small``): rounds, converged count, every plane
    bitwise. Returns {row: launches on its main-path run}."""
    import contextlib
    import io

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, scatter

    counters = {"pushsum_pool_chunk": fused_pool.pushsum_pool_chunk,
                "gossip_pool_chunk": fused_pool.gossip_pool_chunk,
                "pushsum_scatter_chunk": scatter.pushsum_scatter_chunk,
                "gossip_scatter_chunk": scatter.gossip_scatter_chunk}
    launches = {}
    for label, argv, kind, n, algorithm, kw, baked in FAULT_RUNS:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if argv is None:
            res = run(build_topology(kind, n), SimConfig(n=n, topology=kind,
                                                         algorithm=algorithm, **kw))
            got = (res.rounds, res.converged_count, res.outcome)
            state = res.state
        else:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code = cli.main(list(argv))
            rec = json.loads(out.getvalue().strip().splitlines()[-1])
            got = (rec["rounds"], rec["converged_count"], rec["outcome"])
            state = None
            if code != 0:
                raise AssertionError(f"{label}: the CLI exited {code}")
        counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
        row = next(iter(counts), None)
        if f"{row} faulted" not in launches:
            launches[f"{row} faulted"] = counts.get(row, 0)
            MAIN_ROUNDS[f"{row} faulted"] = got[0]
        print(f"  {label}: rounds {got[0]}, converged {got[1]}, {got[2]}, "
              f"{time.perf_counter() - t0:.2f} s, launches {counts}", flush=True)
        if got != (*baked, "converged") or not counts:
            raise AssertionError(f"{label}: {got} != baked {baked} (converged), "
                                 f"launches {counts}")
        if state is not None and algorithm == "push-sum":
            mass_w = state.w.double().sum().item()
            mass_s = state.s.double().sum().item()
            err_w = abs(mass_w - n) / n
            err_s = abs(mass_s - n * (n - 1) / 2) / (n * (n - 1) / 2)
            print(f"    mass over live and dead nodes: sum w {mass_w} (rel err "
                  f"{err_w}), sum s {mass_s} (rel err {err_s})", flush=True)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError(f"{label}: the mass is not conserved")
    for label, kind, n, algorithm, kw in small_fault_runs():
        res = run(build_topology(kind, n), SimConfig(n=n, topology=kind,
                                                     algorithm=algorithm, **kw))
        rounds, count, planes = cpu_small[label]
        if (res.rounds, res.converged_count) != (rounds, count):
            raise AssertionError(f"{label} n={n}: card {res.rounds}/{res.converged_count}"
                                 f" != CPU {rounds}/{count}")
        same_planes(f"{label} n={n}", res.state, planes)
        print(f"  {label} n={n}: card == CPU (rounds {rounds}, converged {count}, "
              "every plane)", flush=True)
    return launches


def fault_rows(cases, launches, max_err, fault_free_ms):
    """The faulted rows of the kernels line: rows 1-2 over a 32-round chunk
    and kernel A per round over its timed chunk, each from the mid-run state
    under FAULT_CFGS' gate-and-crash configs, beside the plain version and
    the fault-free time of the same row measured in this call
    (``fault_free_ms``)."""
    rows = []
    picks = {"pushsum_pool_chunk": "pushsum crash", "gossip_pool_chunk": "gossip crash",
             "pushsum_scatter_chunk": "pushsum crash",
             "gossip_scatter_chunk": "gossip crash"}
    for row, label in picks.items():
        kern, plain, chunk, mid, mid_round = cases[row, label]
        name = row.split("_")[0]
        pool = "pool" in row
        K = CHUNK if pool else SCATTER_TIMED[name]
        ms, out = time_ms(lambda: chunk(kern, mid, mid_round, K), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, K), 2)
        rounds = int(out[1]) if pool else int(out[1][0]) - mid_round
        n_pad = mid[0].numel()
        algo = "push-sum" if name == "pushsum" else "gossip"
        if pool:
            # The fault-free bound's bytes and operations, plus the death
            # plane read once and a gate hash a node a round.
            state_bytes = 16 if name == "pushsum" else 12
            moved = 2 * state_bytes * n_pad + 4 * n_pad + CHUNK * (16 + 4 * POOL + 4)
            ops = rounds * (n_pad // 8 * OPS_PER_WORD
                            + n_pad * (ops_per_node(algo, POOL) + OPS_PER_HASH))
        else:
            moved = rounds * N * (2 * SCATTER_STATE_BYTES[name] + 4)
            ops = rounds * N * (SCATTER_OPS[name] + OPS_PER_HASH)
            ms, plain_ms = ms / rounds, plain_ms / rounds
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        if not pool:
            bytes_ms, ops_ms = bytes_ms / rounds, ops_ms / rounds
        print(f"  {row} faulted ({label}): {ms:.4f} ms against fault-free "
              f"{fault_free_ms[row]:.4f} ms ({ms / fault_free_ms[row]:.3f}x), "
              f"plain {plain_ms:.4f} ms", flush=True)
        rows.append({
            "name": f"{row} faulted",
            "route": "cuda",
            "source": ("cop5615_gossip_protocol_tpu_torch/csrc/fused_pool.cu" if pool
                       else "cop5615_gossip_protocol_tpu_torch/csrc/scatter.cu"),
            "replaces": ({"pushsum": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:860",
                          "gossip": "cop5615_gossip_protocol_tpu/ops/fused_pool.py:1157"}[name]
                         if pool else "cop5615_gossip_protocol_tpu/ops/delivery.py:22"),
            "launches": launches.get(f"{row} faulted", 0),
            "max_abs_err": max_err[row],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "fault_free_ms": fault_free_ms[row],
            "rounds_per_call": rounds,
            "us_per_round": ms * 1e3 / rounds if pool else ms * 1e3,
            "config": FAULT_CFGS[label][1], "status": "ported",
        })
    return rows


# The failure model in the resident lattice kernels (rows 5-6, and row 7's
# global termination: csrc/fused_resident.cu) and the streaming pool
# kernels (rows 3-4, csrc/fused_pool2.cu). Phase 14k's kernel checks run
# each faulted instance against its plain version on the card under the
# configs of fault2_knobs: rows 5-6 at FAULT2_RESIDENT, row 7 (global
# only, as its JAX tier) at torus3d 1M and rows 3-4 at 2**24 full, pool
# size 2; its runs through run() and the CLI end at the baked FAULT2_RUNS
# constants, at the verdict round of the kernel checks, or at the plain
# version's whole run on the card.
FAULT2_LABELS = ("pushsum crash", "pushsum global", "gossip crash")
# (kind, n, tier, {label: whether the run reaches its verdict}) of the
# kernel checks; line 1000 gossip and grid2d 10,000 push-sum are the shapes
# of rows 5-6's fault-free timings. A push-sum run with early deaths on a
# 2-D or 3-D lattice drains its mass into the dead and its weights into the
# subnormals and never reaches the quorum (the JAX chunked engine's grid2d
# 10,000 run with 400 deaths: 3,431 live nodes converged after 1,000,000
# rounds), and global termination on line 1000 needs every ratio settled
# to the last bit at once (no verdict in 400,000 rounds): those cases check
# the chunk from the verdict from a state where every real node converged.
FAULT2_CASES = (
    ("line", 1000, "stencil", {"pushsum crash": True, "gossip crash": True}),
    ("grid2d", 10_000, "stencil", {"pushsum crash": False, "pushsum global": True,
                                   "gossip crash": True}),
    ("grid3d", 125_000, "stencil", {"pushsum crash": False, "pushsum global": True,
                                    "gossip crash": True}),
    ("torus3d", 1_000_000, "stencil2", {"pushsum global": True}),
    ("full", 2**24, "pool2", {"pushsum crash": True, "pushsum global": True,
                              "gossip crash": True}))
# Rounds run before each config's mid-run checks and timings.
FAULT2_MID = {"pushsum crash": 30, "pushsum global": 30, "gossip crash": 8}
# The runs, each with (rounds, converged count) baked from the JAX
# package's chunked engine on the CPU, seed 0 (the grid2d push-sum crash
# comes late, at round 40,000: with early deaths the run drains into the
# dead and never reaches the quorum, see FAULT2_CASES):
#   run(build_topology(kind, n), SimConfig(n=n, topology=kind,
#       algorithm=algorithm, engine="chunked", <kw>))
# (the CLI's as ``python -m cop5615_gossip_protocol_tpu <argv> --platform
# cpu`` gives them); None where the run is held against the kernel checks'
# verdict round (torus3d 1M) or the plain version's whole run on the card
# (2**24 full). The 2**24 runs come first, after the kernel checks' 2**24
# configs, whose death planes (~20 s of host work at 2**24 for a schedule)
# they find in ops/faults.py's cache.
FAULT2_RUNS = (
    # (label, argv of the CLI or None, kind, n, algorithm, kw, baked)
    ("pool2 push-sum gate+crash", None, "full", 2**24, "push-sum",
     {"delivery": "pool", "pool_size": 2, "fault_rate": 0.1,
      "crash_schedule": "5:167772,20:838860", "quorum": 0.95}, None),
    ("pool2 push-sum gate+global", None, "full", 2**24, "push-sum",
     {"delivery": "pool", "pool_size": 2, "fault_rate": 0.1, "termination": "global"},
     None),
    ("pool2 gossip crash", None, "full", 2**24, "gossip",
     {"delivery": "pool", "pool_size": 2, "crash_rate": 0.001, "quorum": 0.9}, None),
    ("CLI grid2d push-sum gate+crash",
     ("10000", "grid2D", "push-sum", "--fault-rate", "0.1", "--crash-schedule",
      "40000:20", "--quorum", "0.9"),
     "grid2d", 10_000, "push-sum",
     {"fault_rate": 0.1, "crash_schedule": "40000:20", "quorum": 0.9}, (67_382, 8986)),
    ("CLI line gossip gate", ("1000", "line", "gossip", "--fault-rate", "0.2"),
     "line", 1000, "gossip", {"fault_rate": 0.2}, (1973, 1000)),
    ("grid2d push-sum global", None, "grid2d", 10_000, "push-sum",
     {"termination": "global"}, (87_872, 10_000)),
    ("grid3d gossip gate+crash", None, "grid3d", 125_000, "gossip",
     {"fault_rate": 0.1, "crash_rate": 0.001, "quorum": 0.9}, (174, 100_505)),
    ("torus3d push-sum global", None, "torus3d", 1_000_000, "push-sum",
     {"termination": "global"}, None),
)
# The 2**24 runs again at FAULT_SMALL_N on the streaming pool tier
# (ops/fused_pool.MAX_POOL_NODES shrunk to 1000 on both sides), each on the
# card against the port's CPU run (rounds, converged count, every plane),
# which the worker computes while the card runs the earlier phases.


def fault2_knobs(label, n, tier):
    """(algorithm, knobs) of a phase 14k config at population n: the crash
    schedule kills 1% of the nodes at round 5 and 5% at round 20; the tiled
    lattice tier takes global termination alone."""
    algorithm = "gossip" if label.startswith("gossip") else "push-sum"
    kw = {"pushsum crash": {"fault_rate": 0.1, "crash_schedule": f"5:{n // 100},20:{n // 20}",
                            "quorum": 0.95},
          "pushsum global": ({"termination": "global"} if tier == "stencil2" else
                             {"fault_rate": 0.1, "termination": "global"}),
          "gossip crash": {"fault_rate": 0.1, "crash_rate": 0.001, "quorum": 0.9}}[label]
    if tier in ("pool", "pool2"):
        kw = {"delivery": "pool", "pool_size": POOL, **kw}
    return algorithm, kw


def small_fault2_runs():
    """(label, n, algorithm, kw) of FAULT2_RUNS' 2**24 runs at FAULT_SMALL_N,
    their crash schedules scaled to it."""
    out = []
    for label, _, kind, n, algorithm, kw, _ in FAULT2_RUNS:
        if kind != "full":
            continue
        kw = dict(kw)
        if "crash_schedule" in kw:
            kw["crash_schedule"] = ",".join(
                f"{r}:{int(c) * FAULT_SMALL_N // n}" for r, c in
                (e.split(":") for e in kw["crash_schedule"].split(",")))
        out.append((label, FAULT_SMALL_N, algorithm, kw))
    return out


def cpu_fault2_runs():
    """The port's CPU runs of small_fault2_runs() on the streaming pool tier
    (the pool tier's cap shrunk to 1000 nodes): {label: (rounds, converged
    count, [planes as numpy])}. Runs in the worker process."""
    import os

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    cap, fused_pool.MAX_POOL_NODES = fused_pool.MAX_POOL_NODES, 1000
    out = {}
    try:
        for label, n, algorithm, kw in small_fault2_runs():
            res = run(build_topology("full", n),
                      SimConfig(n=n, algorithm=algorithm, **{**kw, "engine": "fused"}),
                      device="cpu")
            out[label] = (res.rounds, res.converged_count, [x.numpy() for x in res.state])
    finally:
        fused_pool.MAX_POOL_NODES = cap
    return out


def fault2_fns(dev, key, kind, n, tier, label):
    """One phase 14k kernel and config: (kernel, plain, chunk, initial state
    on the card, population, knobs, delivery classes), chunk(fn, state,
    start, count, cap=None, faulted=True) on the run's streams and failure
    model; the ladder must pick ``tier``."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool2
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    topo = build_topology(kind, n)
    algorithm, kw = fault2_knobs(label, topo.n, tier)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **kw)
    if fused_tier(topo, cfg) != (tier, None):
        raise AssertionError(f"{kind} n={n} {label}: the ladder picks "
                             f"{fused_tier(topo, cfg)}, not {tier}")
    eng = fused_engine(topo, cfg, key, tier)
    common = {"target": cfg.resolved_target_count(topo.n, topo.target_count),
              "faults": fused.run_faults(cfg, topo.n)}
    name = "pushsum" if algorithm == "push-sum" else "gossip"
    if tier == "pool2":
        common["n"] = topo.n
        kern, plain = {"pushsum": (fused_pool2.pushsum_pool2_chunk,
                                   fused_pool2.pushsum_pool2_chunk_plain),
                       "gossip": (fused_pool2.gossip_pool2_chunk,
                                  fused_pool2.gossip_pool2_chunk_plain)}[name]
    else:
        common["spec"] = hbm.stencil_spec(topo)
        kern = resident_wrappers()[name, tier]
        plain = {"pushsum": hbm.pushsum_stencil_hbm_chunk_plain,
                 "gossip": hbm.gossip_stencil_hbm_chunk_plain}[name]
    if name == "pushsum":
        common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
    else:
        common.update(rumor_target=cfg.resolved_rumor_target,
                      suppress=cfg.resolved_suppress)
    streams = functools.lru_cache(maxsize=None)(eng.streams)

    def chunk(fn, state, start, count, cap=None, faulted=True):
        # faulted=False: the same chunk without the failure model (the
        # kernels' fault-free instance).
        return fn(state, *streams(start, count), start,
                  start + count if cap is None else cap,
                  **(common if faulted else {**common, "faults": None}))

    init = tuple(p.contiguous().to(dev) for p in eng.planes)
    classes = POOL if topo.implicit else len(topo.offsets)
    return kern, plain, chunk, init, topo.n, kw, classes


def verdict_round(tag, kern, chunk, init, step):
    """The round a run of ``kern`` from ``init`` ends at its verdict, by
    chunks of ``step`` rounds (at most 400,000 rounds)."""
    state, rnd = init, 0
    while True:
        out, ex = chunk(kern, state, rnd, step)
        if int(ex) < step:
            return rnd + int(ex)
        state, rnd = out, rnd + step
        if rnd >= 400_000:
            raise AssertionError(f"{tag}: no verdict in {rnd} rounds")


def fault2_checks(dev, key):
    """Phase 14k, the kernels: each case of FAULT2_CASES under each of its
    configs, kernel against plain version on the card, every plane and
    count bitwise: a 32-round chunk from the initial state (across the
    crash schedule's death rounds 5 and 20), from a mid-run state a
    32-round chunk and chunks capped after 5 and 6 rounds (both parities of
    the marks or send bits), where the run reaches its verdict a chunk that
    reaches it three rounds in, and a chunk that starts at the verdict (0
    rounds, state unchanged). Returns ({(row, label, kind): case} for the
    timing, {row: max_abs_err}, {(kind, n, label): verdict round})."""
    import torch

    cases, max_err, verdicts = {}, {}, {}
    for kind, n, tier, labels in FAULT2_CASES:
        for label, reaches in labels.items():
            t0 = time.perf_counter()
            kern, plain, chunk, init, pop, kw, classes = fault2_fns(dev, key, kind, n, tier,
                                                                    label)
            name = label.split()[0]
            tag = f"{kind} n={pop} {label} ({tier})"
            mid_round = FAULT2_MID[label]
            errs = [compare(f"{tag} init K={CHUNK}", chunk(kern, init, 0, CHUNK),
                            chunk(plain, init, 0, CHUNK), 0)]
            mid, ex = chunk(kern, init, 0, mid_round)
            if int(ex) != mid_round:
                raise AssertionError(f"{tag}: done before round {mid_round}")
            errs.append(compare(f"{tag} mid-run K={CHUNK}", chunk(kern, mid, mid_round, CHUNK),
                                chunk(plain, mid, mid_round, CHUNK), 0))
            for extra in (5, 6):
                errs.append(compare(f"{tag} cap after {extra} rounds",
                                    chunk(kern, mid, mid_round, CHUNK, cap=mid_round + extra),
                                    chunk(plain, mid, mid_round, CHUNK, cap=mid_round + extra),
                                    0))
            if reaches:
                final = verdict_round(tag, kern, chunk, init,
                                      64 if tier == "pool2" else 4096)
                late, _ = chunk(kern, init, 0, final - 3)
                got = chunk(kern, late, final - 3, 8)
                errs.append(compare(f"{tag} from round {final - 3}, 8 rounds (done after 3)",
                                    got, chunk(plain, late, final - 3, 8), 0))
                if int(got[1]) != 3:
                    raise AssertionError(f"{tag}: the verdict came after {int(got[1])} "
                                         "rounds, not 3")
                at_verdict = got[0]
                verdicts[kind, n, label] = final
            else:
                # Every real node's conv flag latched (push-sum keeps it in
                # its last plane), from the mid-run state.
                final = mid_round
                real = torch.arange(mid[0].numel(), device=dev).reshape(mid[0].shape) < pop
                at_verdict = (*mid[:-1], real.to(torch.int32))
            for fn, who in ((kern, "kernel"), (plain, "plain")):
                same, ex0 = chunk(fn, at_verdict, final, CHUNK)
                if int(ex0) != 0 or not all(torch.equal(a, b)
                                            for a, b in zip(same, at_verdict)):
                    raise AssertionError(f"{tag}: the {who} chunk from the verdict's state ran")
            print(f"  {tag}: " + (f"verdict after round {final}" if reaches else
                                  "every real node converged") +
                  f"; a chunk from it runs 0 rounds, state unchanged "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            row = f"{name}_{tier}_chunk"
            max_err[row] = max(max_err.get(row, 0.0), *errs)
            cases[row, label, kind] = (kern, plain, chunk, mid, mid_round, kw, classes)
            del init, mid, at_verdict
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err, verdicts


@contextlib.contextmanager
def plain_in_place(module, name, plain):
    """Inside the block ``module.name`` is its plain version (which takes
    the wrapper's arguments and runs on the card): a whole run() of the
    plain version, to hold the kernels' run against."""
    kern = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kern)


def fault2_path(dev, verdicts, cpu_small):
    """Phase 14k, the runs: FAULT2_RUNS through run() (the CLI's as typed),
    counters zeroed before each and read after it; each must end
    "converged" at its baked rounds and converged count, or at the kernel
    checks' verdict round, or at the rounds, count and every plane of the
    plain version's whole run on the card; push-sum with its mass over live
    and dead nodes conserved (a CLI run's through the same config in run());
    and its faulted kernel must have launched.
    Then small_fault2_runs() on the card against the worker's CPU runs
    (``cpu_small``). Returns {row: launches on its main-path run}."""
    import io

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, fused_pool2

    counters = {f"{name}_{tier}_chunk": fn for (name, tier), fn in resident_wrappers().items()}
    counters.update({"pushsum_pool2_chunk": fused_pool2.pushsum_pool2_chunk,
                     "gossip_pool2_chunk": fused_pool2.gossip_pool2_chunk})
    launches = {}
    for label, argv, kind, n, algorithm, kw, baked in FAULT2_RUNS:
        for fn in counters.values():
            fn.launches = 0
        topo = build_topology(kind, n)
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **kw)
        t0 = time.perf_counter()
        if argv is None:
            res = run(topo, cfg)
            got = (res.rounds, res.converged_count, res.outcome)
            state = res.state
        else:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code = cli.main(list(argv))
            rec = json.loads(out.getvalue().strip().splitlines()[-1])
            got = (rec["rounds"], rec["converged_count"], rec["outcome"])
            state = None
            if code != 0:
                raise AssertionError(f"{label}: the CLI exited {code}")
        counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
        run_s = time.perf_counter() - t0
        if state is None and algorithm == "push-sum":
            # The CLI prints no state: the same config through run(), for
            # the mass.
            res = run(topo, cfg)
            if (res.rounds, res.converged_count) != got[:2]:
                raise AssertionError(f"{label}: run() {res.rounds}/{res.converged_count} "
                                     f"!= the CLI's {got[:2]}")
            state = res.state
        row = next(iter(counts), None)
        suffix = "global" if row == "pushsum_stencil2_chunk" else "faulted"
        if f"{row} {suffix}" not in launches:
            launches[f"{row} {suffix}"] = counts.get(row, 0)
            MAIN_ROUNDS[f"{row} {suffix}"] = got[0]
        print(f"  {label}: rounds {got[0]}, converged {got[1]}, {got[2]}, "
              f"{run_s:.2f} s, launches {counts}", flush=True)
        if not counts or got[2] != "converged":
            raise AssertionError(f"{label}: {got}, launches {counts}")
        if baked is not None and got[:2] != baked:
            raise AssertionError(f"{label}: {got[:2]} != baked {baked}")
        want = verdicts.get((kind, n, "pushsum global"))
        if kind == "torus3d" and got[0] != want:
            raise AssertionError(f"{label}: rounds {got[0]} != the kernel checks' verdict "
                                 f"round {want}")
        if kind == "full":
            # The same whole run through the plain version on the card.
            name = f"{'pushsum' if algorithm == 'push-sum' else 'gossip'}_pool2_chunk"
            with plain_in_place(fused_pool2, name, getattr(fused_pool2, f"{name}_plain")):
                ref = run(topo, cfg)
            if (ref.rounds, ref.converged_count) != got[:2]:
                raise AssertionError(f"{label}: kernels {got[:2]} != plain "
                                     f"{ref.rounds}/{ref.converged_count}")
            same_planes(f"{label} vs the plain version's run", state, ref.state)
            print(f"    == the plain version's whole run on the card, every plane "
                  f"({ref.run_s:.2f} s)", flush=True)
            del ref
        if state is not None and algorithm == "push-sum":
            mass_w = state.w.double().sum().item()
            mass_s = state.s.double().sum().item()
            err_w = abs(mass_w - n) / n
            err_s = abs(mass_s - n * (n - 1) / 2) / (n * (n - 1) / 2)
            print(f"    mass over live and dead nodes: sum w {mass_w} (rel err "
                  f"{err_w}), sum s {mass_s} (rel err {err_s})", flush=True)
            if not (err_w < 1e-5 and err_s < 1e-5):
                raise AssertionError(f"{label}: the mass is not conserved")
        del state
        torch.cuda.empty_cache()
    cap = fused_pool.MAX_POOL_NODES
    fused_pool.MAX_POOL_NODES = 1000
    try:
        for label, n, algorithm, kw in small_fault2_runs():
            res = run(build_topology("full", n),
                      SimConfig(n=n, algorithm=algorithm, **{**kw, "engine": "fused"}))
            rounds, count, planes = cpu_small[label]
            if (res.rounds, res.converged_count) != (rounds, count):
                raise AssertionError(f"{label} n={n}: card {res.rounds}/"
                                     f"{res.converged_count} != CPU {rounds}/{count}")
            same_planes(f"{label} n={n}", res.state, planes)
            print(f"  {label} n={n} (pool2): card == CPU (rounds {rounds}, converged "
                  f"{count}, every plane)", flush=True)
    finally:
        fused_pool.MAX_POOL_NODES = cap
    return launches


def fault2_phase(dev, key, cpu_small):
    """Phase 14k: fault2_checks, then fault2_path. Returns (cases, max_err,
    launches)."""
    cases, max_err, verdicts = fault2_checks(dev, key)
    return cases, max_err, fault2_path(dev, verdicts, cpu_small)


# The timed faulted rows: (row, label, kind) of a phase 14k case, at the
# shape of the row's fault-free timing.
FAULT2_TIMED = (("pushsum_stencil_chunk", "pushsum crash", "grid2d"),
                ("gossip_stencil_chunk", "gossip crash", "line"),
                ("pushsum_stencil2_chunk", "pushsum global", "torus3d"),
                ("pushsum_pool2_chunk", "pushsum crash", "full"),
                ("gossip_pool2_chunk", "gossip crash", "full"))


def fault2_rows(cases, launches, max_err, fault_free_ms):
    """The faulted rows 3-6 and row 7's global row of the kernels line: a
    32-round chunk from the mid-run state under FAULT2_TIMED's configs,
    beside the plain version and the fault-free time of the same row
    measured in this call (``fault_free_ms``), and the round kernels'
    device time a round in both instances on the same state."""
    rows = []
    replaces = {"pushsum_stencil_chunk": "cop5615_gossip_protocol_tpu/ops/fused.py:741",
                "gossip_stencil_chunk": "cop5615_gossip_protocol_tpu/ops/fused.py:993",
                "pushsum_stencil2_chunk":
                    "cop5615_gossip_protocol_tpu/ops/fused_stencil.py:268",
                "pushsum_pool2_chunk": "cop5615_gossip_protocol_tpu/ops/fused_pool2.py:952",
                "gossip_pool2_chunk": "cop5615_gossip_protocol_tpu/ops/fused_pool2.py:1388"}
    for row, label, kind in FAULT2_TIMED:
        kern, plain, chunk, mid, mid_round, kw, classes = cases[row, label, kind]
        ms, out = time_ms(lambda: chunk(kern, mid, mid_round, CHUNK), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, mid_round, CHUNK), 2)
        rounds = int(out[1])
        # The round kernels' own device time a round (torch.profiler, the
        # host left out): the faulted instance and the fault-free one on the
        # same state and streams (the fault-free chunk may run other rounds).
        stem = {"pushsum_pool2_chunk": "pushsum_pool2_round",
                "gossip_pool2_chunk": "gossip_pool2_round"}.get(
                    row, f"{row.split('_')[0]}_rounds")
        device_us = {}
        for faulted in (True, False):
            traced, (_, ex) = profiled(
                lambda: chunk(kern, mid, mid_round, CHUNK, faulted=faulted), stem)
            # A launch a round (rows 3-4), or one persistent launch a chunk
            # (rows 5-7).
            us, _ = launch_us(traced, stem)
            device_us[faulted] = (us if us is None or kind == "full"
                                  else us / max(int(ex), 1))
        n_pad = mid[0].numel()
        name = row.split("_")[0]
        algo = "push-sum" if name == "pushsum" else "gossip"
        gate = kw.get("fault_rate", 0) > 0
        crash = "crash_schedule" in kw or "crash_rate" in kw
        hashes = OPS_PER_HASH if gate else 0
        if kind == "full":
            # A round streams the state, the sources' windows and (crash)
            # the death plane from HBM; the send bits' 2 bytes per slot per
            # 8 nodes, the own bits' byte and the next bits' byte replace
            # gossip's source reads of the active plane.
            per_node = pool2_bytes_per_node(algo, POOL) + (4 if crash else 0)
            per_node += (2 * POOL + 2) / 8 - (0 if name == "pushsum" else 4 * POOL)
            moved = rounds * per_node * n_pad + CHUNK * (16 + 4 * POOL + 4) + 8
            ops = rounds * n_pad * (pool2_ops_per_node(algo, POOL) + hashes)
        else:
            # The state, the death plane and the keys and needs once a
            # chunk: they stay in the L2.
            moved = STATE_BYTES[name] * n_pad + (4 * n_pad if crash else 0) + CHUNK * 20 + 8
            ops = rounds * n_pad * (stencil_ops_per_node(algo, classes) + hashes)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        suffix = "global" if row == "pushsum_stencil2_chunk" else "faulted"
        print(f"  {row} {suffix} ({label}, {kind} n={n_pad}): {ms:.4f} ms against "
              f"fault-free {fault_free_ms[row]:.4f} ms "
              f"({ms / fault_free_ms[row]:.3f}x), plain {plain_ms:.4f} ms; "
              f"{ratio_text(device_us[True], device_us[False])}", flush=True)
        rows.append({
            "name": f"{row} {suffix}",
            "route": "cuda",
            "source": ("cop5615_gossip_protocol_tpu_torch/csrc/fused_pool2.cu"
                       if kind == "full" else
                       "cop5615_gossip_protocol_tpu_torch/csrc/fused_resident.cu"),
            "replaces": replaces[row],
            "launches": launches.get(f"{row} {suffix}", 0),
            "max_abs_err": max_err[row],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "fault_free_ms": fault_free_ms[row],
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "device_us_per_round": device_us[True],
            "fault_free_device_us_per_round": device_us[False],
            "topology": kind, "config": kw, "status": "ported",
        })
    return rows


# Phase 14l: the failure model in the rows A6a-3 brings it to (ROADMAP
# A6a-3): global termination in row 9 (the streaming lattice tier, torus3d
# 256**3), rows 11 and 13 (the resident and streaming imp tiers, imp3d
# 1,000,000 and 2**24) and row 18 (the sharded imp composition, imp3d
# 256**3 in 4 shards), and the drop gate, crash-stop with quorum and
# global termination in rows 20-21 (the replicated-pool2 composition, full
# 2**24 in 4 shards), each at its row's timed shape.
GLOBAL_CASES = (("pushsum_stencil_hbm_chunk", "torus3d", LATTICE_N, "stencil_hbm"),
                ("pushsum_imp_chunk", "imp3d", N, "imp"),
                ("pushsum_imp_hbm_chunk", "imp3d", 2**24, "imp_hbm"))
# The crafted start of the global checks and runs, at round GLOBAL_START:
# s = w = 1 on every real node (one ratio everywhere) but GLOBAL_EPS more s
# at three nodes, so the global verdict fires a dozen rounds in; from the
# initial state a lattice run takes tens of thousands of rounds to it.
GLOBAL_EPS = 3e-5
GLOBAL_START = 1000
# Rows 20-21: the one-launch checks at SHARD_TIMED from the single-device
# run's state at each of SHARD_FAULT_ROUNDS (the schedule's deaths at
# rounds 5 and 20), and the whole runs at SHARD_FAULT_N in SHARD_TIMED's
# shards, each bitwise the single-device streaming pool run: past the pool
# tier's 2**21 nodes, with 31,072 pad lanes (2**21 + 1's 4,224-row shards
# are no multiple of a processing tile, so its plan refuses 4 shards).
SHARD_FAULT_ROUNDS = (0, 5, 20)
SHARD_FAULT_N = 2**21 + 100_000
# Operations a node a round that global termination adds: the old ratio's
# division, its abs, the max with 1, the tolerance's product, the compare.
GLOBAL_OPS = 5


def shard_fault_knobs(label, n):
    """The failure model of a rows 20-21 config at population n: the drop
    gate with a crash schedule (1% of the nodes at round 5, 5% at round 20;
    the quorum 0.95) or a crash rate (quorum 0.9), or with global
    termination."""
    return {"gate+schedule": {"fault_rate": 0.1, "crash_schedule":
                              f"5:{n // 100},20:{n // 20}", "quorum": 0.95},
            "gate+rate": {"fault_rate": 0.1, "crash_rate": 0.001, "quorum": 0.9},
            "global": {"fault_rate": 0.1, "termination": "global"}}[label]


# (row, algorithm, label): the configs of rows 20-21's checks and runs.
SHARD_FAULT_CONFIGS = (("pushsum", "push-sum", "gate+schedule"),
                       ("pushsum", "push-sum", "global"),
                       ("gossip", "gossip", "gate+schedule"),
                       ("gossip", "gossip", "gate+rate"))
# The timed faulted configs of rows 20-21: the configs rows 3-4's faulted
# rows are timed under (FAULT2_TIMED).
SHARD_FAULT_TIMED = {"pushsum": "gate+schedule", "gossip": "gate+rate"}


def crafted_state(n, n_pad, dev):
    """The global checks' start: padded planes (s, w, term, conv) on the
    card, flat [n_pad] each, and the canonical [n] state run() resumes from."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.models.pushsum import PushSumState

    s = torch.ones(n_pad, device=dev)
    s[n:] = 0.0
    s[torch.tensor([5, n // 3, 2 * n // 3 + 7], device=dev)] = 1.0 + GLOBAL_EPS
    w = torch.ones(n_pad, device=dev)
    zero = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    canon = PushSumState(s=s[:n].cpu(), w=w[:n].cpu(), term=zero[:n].cpu(),
                         conv=zero[:n].cpu() != 0)
    return (s, w, zero, zero.clone()), canon


def global_fns(dev, key, kind, n, tier):
    """One global row's wrapper, plain version and config: (topology,
    config, kernel, plain, chunk(fn, state, start, count, cap=None,
    faulted=True) on the run's streams, the initial planes on the card);
    the ladder must pick ``tier``."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_imp_hbm
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    imp = tier.startswith("imp")
    topo = imp_topology(kind, n) if imp else build_topology(kind, n)
    extra = {"delivery": "pool", "pool_size": IMP_POOL} if imp else {}
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", termination="global",
                    **extra)
    if fused_tier(topo, cfg) != (tier, None):
        raise AssertionError(f"{kind} n={n} global: the ladder picks "
                             f"{fused_tier(topo, cfg)}, not {tier}")
    eng = fused_engine(topo, cfg, key, tier)
    common = {"target": cfg.resolved_target_count(topo.n, topo.target_count),
              "faults": fused.run_faults(cfg, topo.n), "delta": cfg.resolved_delta,
              "term_rounds": cfg.term_rounds}
    if imp:
        kern = {"imp": fused_imp.pushsum_imp_chunk,
                "imp_hbm": fused_imp_hbm.pushsum_imp_hbm_chunk}[tier]
        plain = fused_imp.pushsum_imp_chunk_plain
        common["spec"] = fused_imp.imp_spec(topo)
    else:
        kern, plain = hbm.pushsum_stencil_hbm_chunk, hbm.pushsum_stencil_hbm_chunk_plain
        common["spec"] = hbm.stencil_spec(topo)
    streams = functools.lru_cache(maxsize=None)(eng.streams)

    def chunk(fn, state, start, count, cap=None, faulted=True):
        return fn(state, *streams(start, count), start,
                  start + count if cap is None else cap,
                  **(common if faulted else {**common, "faults": None}))

    return topo, cfg, kern, plain, chunk, tuple(p.contiguous().to(dev) for p in eng.planes)


def global_checks(dev, key):
    """Phase 14l, rows 9, 11 and 13: each global instance against its plain
    version on the card, every plane and count bitwise, from the crafted
    state at GLOBAL_START: a 32-round chunk in which the verdict fires (conv
    latched on every real node), chunks capped after 5 and 6 rounds (both
    mark parities, before the verdict), and a chunk from the verdict (0
    rounds, state unchanged). Returns ({row: case} for the timing,
    {row: max_abs_err}, {row: (verdict round, crafted canonical state)})."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.ops import fused_imp

    cases, max_err, verdicts = {}, {}, {}
    for row, kind, n, tier in GLOBAL_CASES:
        t0 = time.perf_counter()
        topo, cfg, kern, plain, chunk, init = global_fns(dev, key, kind, n, tier)
        tag = f"{row} global ({kind} n={topo.n}, {tier})"
        flat, canon = crafted_state(topo.n, init[0].numel(), dev)
        start = tuple(x.reshape(init[0].shape) for x in flat)
        s0 = GLOBAL_START
        got = chunk(kern, start, s0, CHUNK)
        errs = [compare(f"{tag} crafted K={CHUNK}", got, chunk(plain, start, s0, CHUNK), 0)]
        fired = int(got[1])
        real = (torch.arange(init[0].numel(), device=dev) < topo.n).reshape(init[0].shape)
        if not 6 < fired < CHUNK or not torch.equal(got[0][3], real.to(torch.int32)):
            raise AssertionError(f"{tag}: the verdict came after {fired} rounds, or conv "
                                 "is not latched on every real node")
        for extra in (5, 6):
            errs.append(compare(f"{tag} cap after {extra} rounds",
                                chunk(kern, start, s0, CHUNK, cap=s0 + extra),
                                chunk(plain, start, s0, CHUNK, cap=s0 + extra), 0))
        for fn, who in ((kern, "kernel"), (plain, "plain")):
            same, ex0 = chunk(fn, got[0], s0 + fired, CHUNK)
            if int(ex0) != 0 or not all(torch.equal(a, b) for a, b in zip(same, got[0])):
                raise AssertionError(f"{tag}: the {who} chunk from the verdict ran")
        print(f"  {tag}: verdict after {fired} rounds from round {s0}, conv latched; a "
              f"chunk from it runs 0 rounds ({time.perf_counter() - t0:.1f} s)", flush=True)
        classes = (len(fused_imp.imp_spec(topo).classes) if tier.startswith("imp")
                   else len(topo.offsets))
        cases[row] = (kern, plain, chunk, init, tier, classes)
        max_err[row] = max(errs)
        verdicts[row] = (s0 + fired, canon, topo, cfg)
        del start, got
        torch.cuda.empty_cache()
    return cases, max_err, verdicts


def global_path(dev, verdicts):
    """Phase 14l, rows 9, 11 and 13 through run(), counters zeroed before
    each run and read after it: from the crafted state each run ends
    "converged" at the kernel checks' verdict round with every node
    converged, bitwise the plain version's whole run on the card (rounds,
    every plane); and row 11 from the initial state too (the main path),
    bitwise the plain version's run. Returns {row: launches on its main-path
    run}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_imp, fused_imp_hbm
    from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

    wrappers = {"pushsum_stencil_hbm_chunk": (hbm, hbm.pushsum_stencil_hbm_chunk_plain),
                "pushsum_imp_chunk": (fused_imp, fused_imp.pushsum_imp_chunk_plain),
                "pushsum_imp_hbm_chunk": (fused_imp_hbm, fused_imp.pushsum_imp_chunk_plain)}
    launches = {}
    for row, _, _, tier in GLOBAL_CASES:
        final, canon, topo, cfg = verdicts[row]
        module, plain = wrappers[row]
        runs = [("crafted", {"start_state": canon, "start_round": GLOBAL_START})]
        if tier == "imp":
            runs.append(("initial", {}))
        for label, kw in runs:
            getattr(module, row).launches = 0
            t0 = time.perf_counter()
            res = run(topo, cfg, **kw)
            count = getattr(module, row).launches
            with plain_in_place(module, row, plain):
                ref = run(topo, cfg, **kw)
            if not res.converged or res.converged_count != topo.n or not count:
                raise AssertionError(f"{row} global {label}: {res.outcome}, converged "
                                     f"{res.converged_count}, launches {count}")
            if label == "crafted" and res.rounds != final:
                raise AssertionError(f"{row} global: run() ends at round {res.rounds}, the "
                                     f"kernel checks' verdict at {final}")
            if ref.rounds != res.rounds:
                raise AssertionError(f"{row} global {label}: {res.rounds} rounds, the plain "
                                     f"version's run {ref.rounds}")
            same_planes(f"{row} global {label} vs the plain version's run", res.state,
                        ref.state)
            print(f"  {row} global from the {label} state: rounds {res.rounds}, every "
                  f"node converged, launches {count}, bitwise the plain version's run "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            launches[f"{row} global"] = count
            MAIN_ROUNDS[f"{row} global"] = res.rounds
            del res, ref
        torch.cuda.empty_cache()
    return launches


def imp_shard_global(dev, key):
    """Phase 14l, row 18: the sharded imp composition's global instance at
    IMP_SHARD_TIMED against its plain version on the card, one round of
    every shard (queued as the run queues it) from the crafted state and
    from the initial state, every shard's planes, u and the next marks
    bitwise; then through run() with every shard on the card, counters
    zeroed before each run and read after it: from the crafted state to its
    verdict, capped after 5 and 6 rounds, and from the initial state (the
    main path), each bitwise the single-device streaming imp run (rounds,
    every plane), and a run from the verdict's state (0 rounds). Returns
    (case for the timing, max_abs_err, launches on the main-path run)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, sharded_tier
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

    kind, n, shards = IMP_SHARD_TIMED
    topo = imp_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", delivery="pool",
                    pool_size=IMP_POOL, engine="fused", n_devices=shards,
                    termination="global")
    if sharded_tier(topo, cfg) != ("imp_hbm_sharded", None, "B12"):
        raise AssertionError(f"imp3d x{shards} global: the ladder picks "
                             f"{sharded_tier(topo, cfg)}")
    _, rows_loc, _, layout = ih.plan_imp_hbm_sharded(topo, cfg, shards)
    kw = ih.absorb_kw(topo, cfg)
    row_los = range(0, layout.rows, rows_loc)
    flat, canon = crafted_state(topo.n, layout.n_pad, dev)
    crafted = tuple(x.reshape(layout.rows, 128) for x in flat)
    single_cfg = dataclasses.replace(cfg, n_devices=None, engine="auto")
    init = tuple(p.contiguous().to(dev) for p in
                 fused_engine(topo, single_cfg, key, "imp_hbm").planes)
    err = 0.0
    for label, state, rnd in (("crafted", crafted, GLOBAL_START), ("initial", init, 0)):
        stream, nxt = imp_shard_streams(key, rnd, IMP_POOL, topo.n)
        out = ih.imp_hbm_shards_round_plain(state, stream, rows_loc, row_los, pushsum=True,
                                            **kw)
        want = tuple(torch.cat([o[0][p] for o in out]) for p in range(4))
        bufs = imp_shard_buffers(state, rows_loc, shards, True)
        ih.mark_shards(bufs, stream[0], stream[2], rows_loc, pushsum=True, spec=kw["spec"],
                       pool_size=IMP_POOL)
        ih.launch_shard_rounds(bufs, stream, nxt, pushsum=True, kw=kw)
        err = max(err, shard_bitwise(f"row 18 global {label}", imp_shard_state(bufs, True),
                                     want))
        got_u, want_u = [int(sh.u) for sh in bufs], [int(u) for _, u in out]
        marks = torch.cat([ih.shard_marks_plain(kw["spec"], *nxt, IMP_POOL, lo, rows_loc,
                                                None, dev) for lo in row_los])
        if got_u != want_u or not torch.equal(bufs[0].next, marks):
            raise AssertionError(f"row 18 global {label}: u {got_u} != plain {want_u}, or "
                                 "the next marks differ")
        print(f"  row 18 global, one round of every shard from the {label} state (round "
              f"{rnd}): bitwise, unstable nodes {sum(got_u)}", flush=True)
        del bufs
    launches = 0
    for label, kw_run in (("crafted", {"start_state": canon, "start_round": GLOBAL_START}),
                          ("crafted, 5 rounds", {"start_state": canon,
                                                 "start_round": GLOBAL_START, "cap": 5}),
                          ("crafted, 6 rounds", {"start_state": canon,
                                                 "start_round": GLOBAL_START, "cap": 6}),
                          ("initial", {})):
        cap = kw_run.pop("cap", None)
        run_cfg = cfg if cap is None else dataclasses.replace(
            cfg, max_rounds=GLOBAL_START + cap)
        ih.pushsum_imp_hbm_shard_absorb.launches = 0
        res = run(topo, run_cfg, devices=[dev] * shards, **kw_run)
        count = ih.pushsum_imp_hbm_shard_absorb.launches
        ref = run(topo, dataclasses.replace(single_cfg, max_rounds=run_cfg.max_rounds),
                  **kw_run)
        if (res.rounds, res.converged_count) != (ref.rounds, ref.converged_count):
            raise AssertionError(f"row 18 global {label}: {res.rounds}/"
                                 f"{res.converged_count} != single-device "
                                 f"{ref.rounds}/{ref.converged_count}")
        same_planes(f"row 18 global {label} vs the single-device run", res.state,
                    ref.state)
        if cap is None and not (res.converged and res.converged_count == topo.n):
            raise AssertionError(f"row 18 global {label}: {res.outcome}")
        if label == "crafted":
            again = run(topo, cfg, devices=[dev] * shards, start_state=res.state,
                        start_round=res.rounds)
            if again.rounds != res.rounds:
                raise AssertionError("row 18 global: a run from the verdict ran rounds")
            same_planes("row 18 global from the verdict", again.state, res.state)
        if label == "initial":
            launches = count
            MAIN_ROUNDS["pushsum_imp_hbm_shard_round global"] = res.rounds
        print(f"  row 18 global run from the {label} state: rounds {res.rounds}, converged "
              f"{res.converged_count}, launches {count}, bitwise the single-device run",
              flush=True)
        del res, ref
    torch.cuda.empty_cache()
    case = (init, rows_loc, shards, kw, len(kw["spec"].classes), layout)
    return case, err, launches


def shard_fault_checks(dev, key):
    """Phase 14l, rows 20-21: each faulted shard kernel at SHARD_TIMED
    against its plain version on the card under each of
    SHARD_FAULT_CONFIGS, from the single-device run's state at each of
    SHARD_FAULT_ROUNDS: the first round's send bits of every row (the
    sends launch, one a shard-sized block) against the plain bits, then one
    launch a shard over its rows, which also writes the next round's bits:
    every shard's planes, u and the next bits bitwise. Returns ({row:
    timing case}, {row: max_abs_err}, max_abs_err of the sends launch)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine
    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    n, shards = SHARD_TIMED
    topo = build_topology("full", n)
    cases, max_err = {}, {}
    for name, algorithm, label in SHARD_FAULT_CONFIGS:
        t0 = time.perf_counter()
        knobs = shard_fault_knobs(label, n)
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL, **knobs)
        kern, plain, kw, rows_loc, layout, _, _ = shard_case(dev, key, n, shards, algorithm)
        R = layout.rows
        faults = fused.run_faults(cfg, n)
        thresh = faults.thresh or 0
        death = faults.death_flat(layout.n_pad, dev)
        death = None if death is None else death.reshape(R, 128)
        eng = fused_engine(topo, cfg, key, "pool2")
        state, rnd = tuple(p.contiguous().to(dev) for p in eng.planes), 0
        for want_rnd in SHARD_FAULT_ROUNDS:
            if want_rnd > rnd:
                state, ex = eng.chunk(state, eng.streams(rnd, want_rnd - rnd), rnd, want_rnd)
                if int(ex) != want_rnd - rnd:
                    raise AssertionError(f"{name} {label}: done before round {want_rnd}")
                rnd = want_rnd
            planes = shard_planes(state, algorithm)
            streams = shard_streams(key, rnd, 2, n, dev)
            glob, own = p2s.split_state(planes, algorithm)
            active = None if algorithm == "push-sum" else glob[0]
            gate = fused.gate_round_keys(torch.tensor(streams[2][:2]))
            sends = torch.zeros(R // 8, 128, dtype=torch.uint8, device=dev)
            want_sends = torch.zeros_like(sends)
            for lo in range(0, R, rows_loc):
                rows_death = None if death is None else death[lo:lo + rows_loc].contiguous()
                p2s.pool2_shard_sends(sends, active, rows_death, streams[2][0], rnd, lo,
                                      rows_loc, n=n, thresh=thresh)
                want_sends[lo // 8:(lo + rows_loc) // 8] = p2s.pack_sends(p2s.send_rows_plain(
                    None if active is None else active[lo:lo + rows_loc], rows_death, thresh,
                    gate[0].tolist(), rnd, lo, rows_loc, n, dev))
            if not torch.equal(sends, want_sends):
                raise AssertionError(f"{name} {label} round {rnd}: the sends launch's bits "
                                     "differ from plain")
            errs = []
            nxt_kern = torch.zeros_like(sends)
            for s in range(shards):
                lo = s * rows_loc
                rows_death = None if death is None else death[lo:lo + rows_loc].contiguous()
                sf = p2s.ShardFaults(thresh, rows_death, None, rnd, faults.global_term,
                                     sends, nxt_kern)
                out = tuple(torch.empty_like(x) for x in planes)
                u = torch.zeros(1, dtype=torch.int32, device=dev)
                ctl = {"u": u, "acc": torch.zeros(2, dtype=torch.int32, device=dev),
                       "ctrl": torch.zeros(2, dtype=torch.int32, device=dev)}
                shard_launch(kern, algorithm, kw, planes, out, streams, 0, lo, rows_loc,
                             **ctl, faults=sf)
                got = p2s.join_state(p2s._rows_of(p2s.split_state(out, algorithm)[0], lo,
                                                  rows_loc),
                                     tuple(p[lo:lo + rows_loc]
                                           for p in p2s.split_state(out, algorithm)[1]),
                                     algorithm)
                want, want_u = plain(glob, tuple(p[lo:lo + rows_loc] for p in own),
                                     streams[2][0], streams[3][0], lo, **kw,
                                     faults=sf._replace(next_sends=None))
                errs.append(shard_bitwise(f"{name} {label} round {rnd} shard {s}", got, want))
                if int(u) != int(want_u):
                    raise AssertionError(f"{name} {label} round {rnd} shard {s}: u {int(u)} "
                                         f"!= plain {int(want_u)}")
                act = None if algorithm == "push-sum" else p2s.split_state(want, algorithm)[0][0]
                want_next = p2s.pack_sends(p2s.send_rows_plain(
                    act, rows_death, thresh, gate[1].tolist(), rnd + 1, lo, rows_loc, n, dev))
                if not torch.equal(nxt_kern[lo // 8:(lo + rows_loc) // 8], want_next):
                    raise AssertionError(f"{name} {label} round {rnd} shard {s}: the next "
                                         "round's bits differ from plain")
            row = f"{name}_pool2_shard_round"
            max_err[row] = max([max_err.get(row, 0.0)] + errs)
            if SHARD_FAULT_TIMED[name] == label and want_rnd == SHARD_FAULT_ROUNDS[-1]:
                cases[row] = (kern, plain, algorithm, kw, planes, rnd, n, R, faults, death,
                              label)
        print(f"  {name} {label} at {n:,} x{shards}: the sends launch and one launch a "
              f"shard bitwise at rounds {SHARD_FAULT_ROUNDS} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del eng, state
        torch.cuda.empty_cache()
    return cases, max_err


def shard_fault_path(dev):
    """Phase 14l, rows 20-21 through run(), every shard on the card,
    counters zeroed before each run and read after it: each of
    SHARD_FAULT_CONFIGS at SHARD_FAULT_N in SHARD_TIMED's shards (the main
    path: the sends launch where the run starts and one launch a round),
    bitwise the single-device streaming pool run of the same config
    (rounds, converged count, every plane); and under global termination
    from the crafted state, to its verdict and capped after 5 and 6
    rounds, each bitwise the single-device run, and from the verdict's
    state (0 rounds). Returns {row: launches on its main-path run},
    {sends: launches}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    n, shards = SHARD_FAULT_N, SHARD_TIMED[1]
    topo = build_topology("full", n)
    counters = {"pushsum": p2s.pushsum_pool2_shard_round,
                "gossip": p2s.gossip_pool2_shard_round}
    launches = {}
    _, canon = crafted_state(n, n, dev)
    for name, algorithm, label in SHARD_FAULT_CONFIGS:
        knobs = shard_fault_knobs(label, n)
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=POOL,
                        engine="fused", **knobs)
        scfg = dataclasses.replace(cfg, n_devices=shards)
        runs = [("initial", {}, None)]
        if label == "global":
            runs += [("crafted", {"start_state": canon, "start_round": GLOBAL_START}, None),
                     ("crafted, 5 rounds", {"start_state": canon,
                                            "start_round": GLOBAL_START}, 5),
                     ("crafted, 6 rounds", {"start_state": canon,
                                            "start_round": GLOBAL_START}, 6)]
        for what, kw_run, cap in runs:
            t0 = time.perf_counter()
            bound = {} if cap is None else {"max_rounds": GLOBAL_START + cap}
            counters[name].launches = 0
            p2s.pool2_shard_sends.launches = 0
            res = run(topo, dataclasses.replace(scfg, **bound), devices=[dev] * shards,
                      **kw_run)
            count, sends = counters[name].launches, p2s.pool2_shard_sends.launches
            ref = run(topo, dataclasses.replace(cfg, **bound), **kw_run)
            if (res.rounds, res.converged_count) != (ref.rounds, ref.converged_count):
                raise AssertionError(f"{name} {label} {what}: {res.rounds}/"
                                     f"{res.converged_count} != single-device "
                                     f"{ref.rounds}/{ref.converged_count}")
            same_planes(f"{name} {label} {what} vs the single-device run", res.state,
                        ref.state)
            if cap is None and not res.converged:
                raise AssertionError(f"{name} {label} {what}: {res.outcome}")
            if count < res.rounds - kw_run.get("start_round", 0) or sends != 1:
                raise AssertionError(f"{name} {label} {what}: {count} launches for "
                                     f"{res.rounds} rounds, {sends} sends launches")
            if what == "crafted":
                again = run(topo, scfg, devices=[dev] * shards, start_state=res.state,
                            start_round=res.rounds)
                if again.rounds != res.rounds:
                    raise AssertionError(f"{name} {label}: a run from the verdict ran")
                same_planes(f"{name} {label} from the verdict", again.state, res.state)
            if what == "initial" and SHARD_FAULT_TIMED[name] == label:
                launches[f"{name}_pool2_shard_round faulted"] = count
                launches["pool2_shard_sends"] = sends
                MAIN_ROUNDS[f"{name}_pool2_shard_round faulted"] = res.rounds
                MAIN_ROUNDS["pool2_shard_sends"] = res.rounds
            print(f"  {name} {label} from the {what} state at {n:,} x{shards}: rounds "
                  f"{res.rounds}, converged {res.converged_count}, {count} launches and "
                  f"{sends} sends launch, bitwise the single-device run "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            del res, ref
        torch.cuda.empty_cache()
    return launches


def fault3_phase(dev, key):
    """Phase 14l: global_checks, global_path, imp_shard_global,
    shard_fault_checks and shard_fault_path. Returns (cases, max_err,
    launches)."""
    cases, max_err, verdicts = global_checks(dev, key)
    launches = global_path(dev, verdicts)
    cases["pushsum_imp_hbm_shard_round"], max_err["pushsum_imp_hbm_shard_round"], \
        launches["pushsum_imp_hbm_shard_round global"] = imp_shard_global(dev, key)
    shard_cases, shard_err = shard_fault_checks(dev, key)
    cases.update(shard_cases)
    max_err.update(shard_err)
    launches.update(shard_fault_path(dev))
    return cases, max_err, launches


# The timed rows of phase 14l: (JAX site, CUDA source, round kernel's name).
FAULT3_ROWS = {
    "pushsum_stencil_hbm_chunk": ("ops/fused_stencil_hbm.py:899", "fused_stencil.cu",
                                  "pushsum_round"),
    "pushsum_imp_chunk": ("ops/fused_imp.py:307", "fused_imp.cu", "pushsum_round"),
    "pushsum_imp_hbm_chunk": ("ops/fused_imp_hbm.py:478", "fused_imp.cu", "pushsum_round"),
    "pushsum_imp_hbm_shard_round": ("parallel/fused_imp_hbm_sharded.py:678",
                                    "fused_imp_hbm_shard.cu", "pushsum_imp_shard_absorb"),
    "pushsum_pool2_shard_round": ("parallel/pool2_sharded.py:591", "fused_pool2_shard.cu",
                                  "pushsum_pool2_shard_round"),
    "gossip_pool2_shard_round": ("parallel/pool2_sharded.py:836", "fused_pool2_shard.cu",
                                 "gossip_pool2_shard_round"),
}


def launch_us(traced, stem):
    """(device µs a launch, launches) of the kernels named ``stem`` in a
    torch.profiler trace (``profiled``): the mean over the launches the
    trace holds, or (None, 0) when it holds none. A trace on the H100 has
    held only some of a call's launches (half the fault-free resident
    chunk's time, CUDA events over the same calls disagreeing), and three
    traces in a row none of a persistent cooperative launch's, so
    a time a round is this mean over the launches a round, never the
    trace's sum over the rounds, and a device time is a measurement the
    kernels line may lack ("not measured"), never a check."""
    events = sum(count for short, (count, _) in traced.items() if stem in short)
    us = sum(us for short, (_, us) in traced.items() if stem in short)
    return (us / events if events else None), events


def per_round_us(fn, stem, launches_a_round):
    """The device µs a round of the kernels named ``stem`` that fn()
    launches ``launches_a_round`` times a round (torch.profiler, the host
    left out, ``launch_us``; None when no trace held them); fn's result."""
    traced, out = profiled(fn, stem)
    us, _ = launch_us(traced, stem)
    return (None if us is None else us * launches_a_round), out


def ratio_text(us, us_free):
    """The device times of an instance and its fault-free one, printed."""
    if us is None or us_free is None:
        return "round kernel device time not measured (no launch in the traces)"
    return (f"round kernel {us:.2f} µs a round against the fault-free instance's "
            f"{us_free:.2f} on the same state ({us / us_free:.3f}x)")


def fault3_row(row, suffix, ms, plain_ms, moved, ops, launches, max_err, fault_free_ms,
               rounds, us, us_free, **extra):
    """One row of the kernels line for a phase 14l instance."""
    site, source, _ = FAULT3_ROWS[row]
    bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    print(f"  {row} {suffix}: {ms:.4f} ms against fault-free {fault_free_ms:.4f} ms "
          f"({ms / fault_free_ms:.3f}x), plain {plain_ms:.4f} ms; {ratio_text(us, us_free)}",
          flush=True)
    return {"name": f"{row} {suffix}", "route": "cuda",
            "source": f"cop5615_gossip_protocol_tpu_torch/csrc/{source}",
            "replaces": f"cop5615_gossip_protocol_tpu/{site}",
            "launches": launches.get(f"{row} {suffix}", 0), "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "fault_free_ms": fault_free_ms,
            "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
            "device_us_per_round": us, "fault_free_device_us_per_round": us_free,
            "status": "ported", **extra}


def fault3_rows(dev, key, cases, launches, max_err, fault_free_ms):
    """Phase 14l's rows of the kernels line: rows 9, 11 and 13 in their
    global instances over a 32-round chunk from the initial state, row 18's
    global absorb over one round of every shard, and rows 20-21's faulted
    launches (SHARD_FAULT_TIMED's configs, 32 in a row over every row from
    the checks' state) and the sends launch; each beside its plain version,
    the fault-free time of the row measured in this call
    (``fault_free_ms``), and the round kernel's device time a round in
    both instances on the same state."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    rows = []
    for row, kind, n, _ in GLOBAL_CASES:
        kern, plain, chunk, init, tier, classes = cases[row]
        ms, out = time_ms(lambda: chunk(kern, init, 0, CHUNK), TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, init, 0, CHUNK), 2)
        rounds = int(out[1])
        stem = FAULT3_ROWS[row][2]
        us, _ = per_round_us(lambda: chunk(kern, init, 0, CHUNK), stem, 1)
        us_free, (_, ex) = per_round_us(lambda: chunk(kern, init, 0, CHUNK, faulted=False),
                                        stem, 1)
        if int(ex) != CHUNK:
            raise AssertionError(f"{row}: the fault-free chunk stopped at {int(ex)}")
        n_pad = init[0].numel()
        if tier == "stencil_hbm":
            moved = rounds * STATE_BYTES["pushsum"] * n_pad + CHUNK * 16 + 8
            ops = rounds * n_pad * (stencil_ops_per_node("push-sum", classes) + GLOBAL_OPS)
        else:
            # The resident tier's state fits the L2 (read and written once a
            # chunk); the streaming tier's streams every round.
            passes = 1 if tier == "imp" else rounds
            moved = passes * STATE_BYTES["pushsum"] * n_pad + CHUNK * (32 + 4 * IMP_POOL) + 8
            ops = rounds * n_pad * (imp_ops_per_node("push-sum", classes + IMP_POOL)
                                    + GLOBAL_OPS)
        rows.append(fault3_row(row, "global", ms, plain_ms, moved, ops, launches,
                               max_err[row], fault_free_ms[row], rounds, us, us_free,
                               topology=kind, population=n))
    # Row 18: one round of every shard's absorb from the initial state.
    row = "pushsum_imp_hbm_shard_round"
    init, rows_loc, shards, kw, lattice, layout = cases[row]
    stream, nxt = imp_shard_streams(key, 0, IMP_POOL, IMP_SHARD_TIMED[1])
    bufs = imp_shard_buffers(init, rows_loc, shards, True)
    ih.mark_shards(bufs, stream[0], stream[2], rows_loc, pushsum=True, spec=kw["spec"],
                   pool_size=IMP_POOL)
    free_kw = {**kw, "global_term": False}
    ms, _ = time_ms(lambda: ih.launch_shard_rounds(bufs, stream, nxt, pushsum=True, kw=kw),
                    TIME_REPS)
    plain_ms, _ = time_ms(lambda: ih.imp_hbm_shards_round_plain(
        init, stream, rows_loc, range(0, layout.rows, rows_loc), pushsum=True, **kw), 2)
    stem = FAULT3_ROWS[row][2]
    us, _ = per_round_us(lambda: ih.launch_shard_rounds(bufs, stream, nxt, pushsum=True,
                                                        kw=kw), stem, shards)
    us_free, _ = per_round_us(lambda: ih.launch_shard_rounds(bufs, stream, nxt, pushsum=True,
                                                             kw=free_kw), stem, shards)
    moved = STATE_BYTES["pushsum"] * layout.n_pad + 16 + 4 * IMP_POOL + 16
    ops = layout.n_pad * (imp_ops_per_node("push-sum", lattice + IMP_POOL) + GLOBAL_OPS)
    rows.append(fault3_row(row, "global", ms, plain_ms, moved, ops, launches, max_err[row],
                           fault_free_ms[row], 1, us, us_free, shards=shards,
                           population=IMP_SHARD_TIMED[1], topology=IMP_SHARD_TIMED[0]))
    del bufs
    # Rows 20-21: 32 launches in a row over every row (the verdict in the
    # launch, against a target no round reaches), each reading its round's
    # send bits and writing the next round's.
    sends_case = None
    for name in ("pushsum", "gossip"):
        row = f"{name}_pool2_shard_round"
        kern, plain, algorithm, kw, planes, rnd, n, R, faults, death, label = cases[row]
        streams = shard_streams(key, rnd, CHUNK + 1, n, dev)
        thresh = faults.thresh or 0
        glob = p2s.split_state(planes, algorithm)[0]
        active = None if algorithm == "push-sum" else glob[0]
        bits = [torch.zeros(R // 8, 128, dtype=torch.uint8, device=dev) for _ in range(2)]
        p2s.pool2_shard_sends(bits[0], active, death, streams[2][0], rnd, 0, R, n=n,
                              thresh=thresh)
        sends_case = (bits[1], active, death, streams[2][0], rnd, R, n, thresh)
        sets = [tuple(x.clone() for x in planes), tuple(torch.empty_like(x) for x in planes)]
        ctl = {"u": None, "acc": torch.zeros(2, dtype=torch.int32, device=dev),
               "ctrl": torch.zeros(2, dtype=torch.int32, device=dev), "target": n + 1}

        def launches_in_a_row(faulted=True):
            for i in range(CHUNK):
                sf = None if not faulted else p2s.ShardFaults(
                    thresh, death, None, rnd + i, faults.global_term, bits[i % 2],
                    bits[1 - i % 2])
                shard_launch(kern, algorithm, kw, sets[i % 2], sets[1 - i % 2], streams, i,
                             0, R, **ctl, faults=sf)

        chunk_ms, _ = time_ms(launches_in_a_row, TIME_REPS)
        sf0 = p2s.ShardFaults(thresh, death, None, rnd, faults.global_term, bits[0], None)
        plain_ms, _ = time_ms(lambda: shard_plain(plain, algorithm, {**kw, "faults": sf0},
                                                  planes, streams, 0, 0, R), 2)
        stem = FAULT3_ROWS[row][2]
        us, _ = per_round_us(launches_in_a_row, stem, 1)
        us_free, _ = per_round_us(lambda: launches_in_a_row(False), stem, 1)
        n_pad = R * 128
        crash = faults.death is not None
        # The state and the sources' windows, the own rows' death round, and
        # the send bits (2 bytes per slot per 8 nodes, the own and the next
        # byte) in place of gossip's source reads of the active plane.
        per_node = pool2_bytes_per_node(algorithm, POOL) + (4 if crash else 0)
        per_node += (2 * POOL + 2) / 8 - (0 if name == "pushsum" else 4 * POOL)
        moved = per_node * n_pad + 16 + 4 * POOL + 8
        ops = n_pad * (pool2_ops_per_node(algorithm, POOL) + OPS_PER_HASH)
        rows.append(fault3_row(row, "faulted", chunk_ms / CHUNK, plain_ms, moved, ops,
                               launches, max_err[row], fault_free_ms[row], 1, us, us_free,
                               config=shard_fault_knobs(label, n), shards=SHARD_TIMED[1],
                               population=n, timed_launches=CHUNK))
        del sets
    # The sends launch: a run's first round's bits over every row.
    out, active, death, keys, rnd, R, n, thresh = sends_case
    ms, _ = time_ms(lambda: p2s.pool2_shard_sends(out, active, death, keys, rnd, 0, R, n=n,
                                                  thresh=thresh), TIME_REPS)
    gate = fused.gate_round_keys(torch.tensor([keys]))[0].tolist()
    plain_ms, _ = time_ms(lambda: p2s.pack_sends(p2s.send_rows_plain(
        active, death, thresh, gate, rnd, 0, R, n, dev)), 2)
    n_pad = R * 128
    moved = n_pad * ((4 if death is not None else 0) + (4 if active is not None else 0)
                     + 1 / 8)
    ops = n_pad * (OPS_PER_HASH + 4)
    bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    rows.append({"name": "pool2_shard_sends", "route": "cuda",
                 "source": "cop5615_gossip_protocol_tpu_torch/csrc/fused_pool2_shard.cu",
                 "replaces": "cop5615_gossip_protocol_tpu/parallel/pool2_sharded.py:836",
                 "launches": launches.get("pool2_shard_sends", 0),
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "library_ms": None, "population": n, "status": "ported"})
    torch.cuda.empty_cache()
    return rows


# Phase 14m: global termination in the sharded lattice compositions
# (ROADMAP A6a-4), rows 15-16's global instances: torus3d 100**3 in 2
# shards (the resident tier) and 256**3 in 4 (the streaming tier), every
# shard on the one card, from the crafted state of phase 14l at
# GLOBAL_START.
SHARD_GLOBAL_CASES = (("pushsum_fused_sharded_superstep", "fused_sharded", "torus3d",
                       1_000_000, 2),
                      ("pushsum_stencil_hbm_sharded_superstep", "stencil_hbm_sharded",
                       "torus3d", LATTICE_N, 4))


def shard_global_setup(dev, kind, n, shards, tier):
    """(topology, config, Tier, wrapper keywords) of a row 15-16 global
    case; the ladder must pick ``tier``."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import sharded_tier
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded as fh
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    topo = build_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", termination="global",
                    engine="fused", n_devices=shards)
    if sharded_tier(topo, cfg)[:2] != (tier, None):
        raise AssertionError(f"{kind} n={n} x{shards} global: the ladder picks "
                             f"{sharded_tier(topo, cfg)}")
    plan = (fs.vmem_tier if tier == "fused_sharded" else fh.hbm_tier)(topo, cfg, shards)
    kw = fs.protocol_kw(topo, cfg, plan.geom, plan.rolls)
    if not kw["global_term"]:
        raise AssertionError("the wrappers' keywords lack global termination")
    return topo, cfg, plan, kw


def shard_global_path(dev, key):
    """Phase 14m: for each of SHARD_GLOBAL_CASES, one super-step of every
    shard's global instance from the crafted state against the plain
    version on the card (every row of out and y from SENTINEL, and u: the
    middle's unstable counts), then run(devices=[card] * S) from the
    crafted state, counters zeroed before it and read after it, bitwise the
    single-device global run (the stencil2 tier at 100**3, stencil_hbm at
    256**3: rounds, converged count, every plane), and runs resumed so the
    verdict lands on a super-step's first, middle and last round, each
    bitwise the same. Returns ({row: case} for the timing, {row:
    max_abs_err}, {row: launches})."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused
    from cop5615_gossip_protocol_tpu_torch.ops.fused_pool import build_pool_layout
    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    cases, max_err, launches = {}, {}, {}
    for row, tier, kind, n, shards in SHARD_GLOBAL_CASES:
        t0 = time.perf_counter()
        topo, cfg, plan, kw = shard_global_setup(dev, kind, n, shards, tier)
        geom = plan.geom
        layout = build_pool_layout(n)
        flat, canon = crafted_state(n, layout.n_pad, dev)
        planes = tuple(x.reshape(layout.rows, 128) for x in flat)
        rounds = min(geom.cr, STENCIL_SHARD_ROUNDS)
        keys = fused.round_keys(key, GLOBAL_START, rounds).to(dev)
        bufs = shard_buffers(planes, geom, shards)
        lattice_shard_step(plan.pushsum, kw, plan, bufs, keys, rounds)
        err, unstable = 0.0, []
        for s, b in enumerate(bufs):
            want = tuple(sentinel_like(x) for x in b["ext"])
            want_y = tuple(sentinel_like(x) for x in b["ext"])
            want_u = fs.shard_superstep_plain(b["ext"], want, want_y, keys, rounds,
                                              geom.row0(s), **kw)
            if not torch.equal(b["u"].cpu(), want_u):
                raise AssertionError(f"{row} global shard {s}: u {b['u'].tolist()} != "
                                     f"plain {want_u.tolist()}")
            for got, exp in zip(b["out"] + b["y"], want + want_y):
                if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
                    raise AssertionError(f"{row} global shard {s}: a plane differs "
                                         "from plain")
                if got.dtype == torch.float32:
                    err = max(err, (got - exp).abs().max().item())
            unstable.append(b["u"][:rounds].tolist())
            del want, want_y
        print(f"  {row} global ({kind} n={n:,} x{shards}, {tier}, CR {geom.cr}, "
              f"{rounds} rounds from round {GLOBAL_START}): every shard bitwise its plain "
              f"version on every row of out and y and in u (unstable a round "
              f"{[sum(c) for c in zip(*unstable)]})", flush=True)
        max_err[row] = err
        cases[row] = (plan, kw, bufs, keys, rounds, len(topo.offsets), tier)
        start = {"start_state": canon, "start_round": GLOBAL_START}
        single = run(topo, SimConfig(n=n, topology=kind, algorithm="push-sum",
                                     termination="global"), device=dev, **start)
        fn = plan.pushsum
        fn.launches = 0
        res = run(topo, cfg, devices=[str(dev)] * shards, **start)
        launches[row] = fn.launches
        if dev.type == "cuda" and fn.launches == 0:
            raise AssertionError(f"{row} global run: no launch of its kernel")
        if not (res.converged and res.converged_count == n):
            raise AssertionError(f"{row} global run: {res.outcome}, "
                                 f"{res.converged_count} converged")
        same_planes(f"{row} global run", res.state, single.state)
        if (res.rounds, res.estimate_mae) != (single.rounds, single.estimate_mae):
            raise AssertionError(f"{row} global run: rounds {res.rounds} != single "
                                 f"{single.rounds}")
        m = single.rounds - GLOBAL_START
        c = min(geom.cr, m)
        positions = {"first": 0, "last": c - 1}
        if c >= 3:
            positions["middle"] = c // 2
        for where, p in positions.items():
            k = (m - 1 - p) % c
            at = dict(start)
            if k:
                part = run(topo, dataclasses.replace(cfg, chunk_rounds=c,
                                                     max_rounds=GLOBAL_START + k),
                           devices=[str(dev)] * shards, **start)
                at = {"start_state": part.state, "start_round": part.rounds}
            again = run(topo, dataclasses.replace(cfg, chunk_rounds=c),
                        devices=[str(dev)] * shards, **at)
            if again.rounds != single.rounds:
                raise AssertionError(f"{row} verdict on a super-step's {where} round: "
                                     f"rounds {again.rounds} != {single.rounds}")
            same_planes(f"{row} verdict on a super-step's {where} round", again.state,
                        single.state)
        print(f"  {row} global runs from round {GLOBAL_START}: stop at round "
              f"{single.rounds} (exact, not a super-step boundary), bitwise the "
              f"single-device run; {launches[row]} launches; the verdict on a "
              f"{c}-round super-step's {', '.join(positions)} round bitwise too "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del single, res, planes, flat
        fs._shard_slots.cache_clear()
        torch.cuda.empty_cache()
    return cases, max_err, launches


def shard_global_rows(cases, launches, max_err):
    """Phase 14m's rows of the kernels line: each global super-step of every
    shard from the crafted state by CUDA events, beside the local instance
    (the fault-free one) on the same state in the same call, the plain
    version's time and the bound on the windows' slot-rounds
    (stencil_shard_bound, plus GLOBAL_OPS an absorb)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded as fs

    rows = []
    sites = {"pushsum_fused_sharded_superstep": (
        "parallel/fused_sharded.py:448", "fused_stencil_shard.cu"),
        "pushsum_stencil_hbm_sharded_superstep": (
        "parallel/fused_hbm_sharded.py:773", "fused_stencil_hbm_shard.cu")}
    for row, (plan, kw, bufs, keys, rounds, classes, tier) in cases.items():
        local = {**kw, "global_term": False}
        ms, _ = time_ms(lambda: lattice_shard_step(plan.pushsum, kw, plan, bufs, keys,
                                                   rounds), TIME_REPS)
        local_ms, _ = time_ms(lambda: lattice_shard_step(plan.pushsum, local, plan, bufs,
                                                         keys, rounds), TIME_REPS)
        t0 = time.perf_counter()
        for s, b in enumerate(bufs):
            fs.shard_superstep_plain(b["ext"], b["out"], b["y"], keys, rounds,
                                     plan.geom.row0(s), **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        moved, ops = stencil_shard_bound(kw, plan, len(bufs), rounds, "push-sum",
                                         classes, tier == "fused_sharded")
        absorbs = sum(128 * sum(window_rows(kw, plan.geom, s, rounds)[1:])
                      for s in range(len(bufs)))
        ops += absorbs * GLOBAL_OPS
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        site, source = sites[row]
        print(f"  {row} global: {ms:.4f} ms a {rounds}-round super-step against the "
              f"local instance's {local_ms:.4f} on the same state ({ms / local_ms:.3f}x), "
              f"plain {plain_ms:.1f} ms", flush=True)
        rows.append({"name": f"{row} global", "route": "cuda",
                     "source": f"cop5615_gossip_protocol_tpu_torch/csrc/{source}",
                     "replaces": f"cop5615_gossip_protocol_tpu/{site}",
                     "launches": launches[row], "max_abs_err": max_err[row],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "fault_free_ms": local_ms,
                     "rounds_per_call": rounds,
                     "us_per_round": ms * 1e3 / rounds, "status": "ported"})
    return rows


# Phase 14n: crash-recovery (ROADMAP A6b) in kernel A, rows 1-2 and rows
# 5-6: each faulted instance with a revival plane against its plain version
# on the card at full 1,000,000 (kernel A, rows 1-2) and grid2d 10,000
# (rows 5-6), under a crash schedule (1% of the nodes at round 5, 5% at
# round 20) with a revive schedule (half of 1% at round 12, 2% at round 30)
# and a crash rate (0.01) with a revive rate (0.2); push-sum rejoins fresh
# under the schedule and restores under the rate.
REVIVE_KERNELS = (("pool", "full", N), ("scatter", "full", N), ("stencil", "grid2d", 10_000))
# ROADMAP C1's failure model (phase 14o's drained runs): push-sum with a
# crash and revive schedule, fresh rejoins and a 0.9 quorum, seed 0.
C1_KNOBS = dict(crash_schedule="2:50,5:20", revive_schedule="6:40", rejoin="fresh",
                quorum=0.9)
REVIVE_LABELS = ("pushsum fresh schedule", "pushsum restore rate", "gossip schedule",
                 "gossip rate")


def revive_knobs(label, n):
    """(algorithm, knobs) of a phase 14n config at population n."""
    algorithm = "gossip" if label.startswith("gossip") else "push-sum"
    if label.endswith("schedule"):
        kw = {"crash_schedule": f"5:{n // 100},20:{n // 20}",
              "revive_schedule": f"12:{n // 200},30:{n // 50}", "quorum": 0.95}
    else:
        kw = {"crash_rate": 0.01, "revive_rate": 0.2, "quorum": 0.9}
    if "fresh" in label:
        kw["rejoin"] = "fresh"
    return algorithm, kw


def revive_fns(dev, key, kernel, kind, n, label):
    """One phase 14n kernel and config: (kernel, plain, chunk(fn, state,
    start, count) -> (state, rounds run), initial state on the card, the
    run's Faults)."""
    return kernel_fns(dev, key, kernel, kind, n, *revive_knobs(label, n))


def kernel_fns(dev, key, kernel, kind, n, algorithm, kw):
    """One kernel of phases 14n-14o under a config's failure-model knobs
    ``kw``: (kernel, plain, chunk(fn, state, start, count, faulted=True) ->
    (state, rounds run), initial state on the card, the run's Faults)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, scatter

    label = f"{algorithm} {kw}"
    name = "pushsum" if algorithm == "push-sum" else "gossip"
    if kernel == "scatter":
        from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
        from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
        from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader

        topo = build_topology(kind, n)
        n = topo.n  # imp2d rounds the population to a square
        graph = scatter.scatter_graph(topo, dev)
        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **kw)
        faults = fused.run_faults(cfg, n)
        if name == "pushsum":
            init = pushsum_mod.init_state(n, cfg.initial_term_round, dev)
            kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
            extra = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        else:
            init = gossip_mod.init_state(n, draw_leader(key, topo, cfg), False, dev)
            kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain
            extra = {"rumor_target": cfg.resolved_rumor_target,
                     "suppress": cfg.resolved_suppress}
        keys = functools.lru_cache(maxsize=None)(
            lambda start, count: fused.round_keys(key, start, count))

        def chunk(fn, state, start, count, faulted=True):
            status = torch.tensor([start, 0], dtype=torch.int32, device=dev)
            fx = faults if faulted else None
            if fn is plain:
                st, status = fn(state, keys(start, count), status, graph=graph,
                                target=n, start=start, faults=fx, **extra)
            else:
                st, status = fn(state, key, start, count, status, graph=graph,
                                target=n, faults=fx, **extra)
            return st, status[0] - start

        return kern, plain, chunk, init, faults
    topo = build_topology(kind, n)
    extra = {"delivery": "pool", "pool_size": POOL} if kernel == "pool" else {}
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, **extra, **kw)
    if fused_tier(topo, cfg) != (kernel, None):
        raise AssertionError(f"{kind} n={n} {label}: the ladder picks "
                             f"{fused_tier(topo, cfg)}, not {kernel}")
    eng = fused_engine(topo, cfg, key, kernel)
    faults = fused.run_faults(cfg, n)
    if kernel == "pool":
        from cop5615_gossip_protocol_tpu_torch.ops import fused_pool

        kern, plain = {"pushsum": (fused_pool.pushsum_pool_chunk,
                                   fused_pool.pushsum_pool_chunk_plain),
                       "gossip": (fused_pool.gossip_pool_chunk,
                                  fused_pool.gossip_pool_chunk_plain)}[name]
        common = {"n": n}
    else:
        from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

        kern = resident_wrappers()[name, "stencil"]
        plain = {"pushsum": hbm.pushsum_stencil_hbm_chunk_plain,
                 "gossip": hbm.gossip_stencil_hbm_chunk_plain}[name]
        common = {"spec": hbm.stencil_spec(topo)}
    common.update(target=n, faults=faults)
    if name == "pushsum":
        common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
    else:
        common.update(rumor_target=cfg.resolved_rumor_target,
                      suppress=cfg.resolved_suppress)
    streams = functools.lru_cache(maxsize=None)(eng.streams)

    def chunk(fn, state, start, count, faulted=True):
        return fn(state, *streams(start, count), start, start + count,
                  **(common if faulted else {**common, "faults": None}))

    return kern, plain, chunk, tuple(p.contiguous().to(dev) for p in eng.planes), faults


def revive_checks(dev, key):
    """Phase 14n, the kernels: each of REVIVE_KERNELS under each of
    REVIVE_LABELS against its plain version on the card, every plane and the
    rounds bitwise: a 32-round chunk from the initial state (across the
    deaths and revivals), chunks that end just before and just after the
    first revival round R, and a chunk resumed at R from the kernel's state
    there. Returns ({(kernel, label): case} for the timing, {kernel name:
    max_abs_err})."""
    import numpy as np
    import torch

    cases, max_err = {}, {}
    for kernel, kind, n in REVIVE_KERNELS:
        t0 = time.perf_counter()
        for label in REVIVE_LABELS:
            kern, plain, chunk, init, faults = revive_fns(dev, key, kernel, kind, n, label)
            tag = f"{kernel} {label}"
            rv = faults.revive[faults.revive != np.iinfo(np.int32).max]
            R = int(rv.min())
            if not 0 < R < CHUNK:
                raise AssertionError(f"{tag}: the first revival round {R} is not in the "
                                     f"first chunk")
            pair = chunk
            errs = [same_planes(f"{tag} init {CHUNK} rounds", pair(kern, init, 0, CHUNK)[0],
                                pair(plain, init, 0, CHUNK)[0])]
            for cap in (R, R + 1):
                got, want = pair(kern, init, 0, cap), pair(plain, init, 0, cap)
                if int(got[1]) != int(want[1]):
                    raise AssertionError(f"{tag} capped at {cap}: rounds {int(got[1])} "
                                         f"!= plain {int(want[1])}")
                errs.append(same_planes(f"{tag} capped at round {cap}", got[0], want[0]))
                if cap == R:
                    at_r = got[0]
            errs.append(same_planes(f"{tag} resumed at round {R}",
                                    pair(kern, at_r, R, 8)[0], pair(plain, at_r, R, 8)[0]))
            name = "pushsum" if label.startswith("pushsum") else "gossip"
            max_err[f"{name} {kernel}"] = max(max_err.get(f"{name} {kernel}", 0.0), *errs)
            cases[kernel, label] = (kern, plain, chunk, init, n)
        print(f"  {kernel} ({kind} n={n:,}): {', '.join(REVIVE_LABELS)}: a {CHUNK}-round "
              "chunk from the initial state, chunks capped at the first revival round R "
              "and R + 1, and one resumed at R, each bitwise its plain version "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return cases, max_err


# Phase 14n's runs: (label, kernel, kind, n, algorithm, the CLI's flags
# beyond the triple). Each runs on the card through run(), the first of each
# kernel also through the CLI, and on the CPU in the worker (the same tier's
# plain version); they must agree.
REVIVE_RUNS = (
    ("pool push-sum fresh", "pool", "full", 20_000, "push-sum",
     ["--delivery", "pool", "--pool-size", "2", "--crash-schedule", "5:200,20:1000",
      "--revive-schedule", "12:100,30:400", "--rejoin", "fresh", "--quorum", "0.95"]),
    ("pool gossip rate", "pool", "full", 20_000, "gossip",
     ["--delivery", "pool", "--pool-size", "2", "--crash-rate", "0.01",
      "--revive-rate", "0.2", "--quorum", "0.9"]),
    ("scatter push-sum restore", "scatter", "full", 20_000, "push-sum",
     ["--crash-rate", "0.01", "--revive-rate", "0.2", "--quorum", "0.9"]),
    ("scatter gossip fresh", "scatter", "full", 20_000, "gossip",
     ["--crash-schedule", "5:200,20:1000", "--revive-schedule", "12:100,30:400",
      "--quorum", "0.95"]),
    ("stencil push-sum fresh", "stencil", "grid2d", 10_000, "push-sum",
     ["--crash-rate", "0.001", "--revive-rate", "0.2", "--rejoin", "fresh",
      "--quorum", "0.9", "--max-rounds", "3000"]),
    ("stencil gossip schedule", "stencil", "grid2d", 10_000, "gossip",
     ["--crash-schedule", "5:100,20:500", "--revive-schedule", "12:50,30:200",
      "--quorum", "0.95"]),
)


def revive_cfg(kind, n, algorithm, flags):
    """The SimConfig the CLI builds from ``flags``."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.cli import build_parser

    args = build_parser().parse_args([str(n), kind, algorithm, *flags])
    fields = {"delivery": args.delivery, "pool_size": args.pool_size,
              "crash_rate": args.crash_rate, "crash_schedule": args.crash_schedule,
              "revive_rate": args.revive_rate, "revive_schedule": args.revive_schedule,
              "rejoin": args.rejoin, "quorum": args.quorum,
              "max_rounds": args.max_rounds}
    return SimConfig(n=n, topology=kind, algorithm=algorithm, **fields)


def cpu_revive_runs():
    """The port's CPU runs of REVIVE_RUNS on each kernel's tier (the plain
    versions; the chunked engine for scatter): {label: (rounds, converged
    count, estimate_mae, [planes as numpy])}. Runs in the worker process."""
    import os

    import torch

    from cop5615_gossip_protocol_tpu_torch import build_topology, run

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for label, kernel, kind, n, algorithm, flags in REVIVE_RUNS:
        cfg = revive_cfg(kind, n, algorithm, flags)
        if kernel != "scatter":
            cfg = dataclasses.replace(cfg, engine="fused")
        res = run(build_topology(kind, n), cfg, device="cpu")
        out[label] = (res.rounds, res.converged_count, res.estimate_mae,
                      [x.numpy() for x in res.state])
    return out


def revive_path(dev, cpu_runs):
    """Phase 14n, the runs: each of REVIVE_RUNS on the card through run(),
    its kernel's counter zeroed before and read after, and the first of
    each kernel through the CLI, against the worker's CPU run: rounds,
    converged count and estimate, and run()'s every plane. Returns {kernel
    name: launches}."""
    from cop5615_gossip_protocol_tpu_torch import build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, scatter

    counters = {("pool", "push-sum"): fused_pool.pushsum_pool_chunk,
                ("pool", "gossip"): fused_pool.gossip_pool_chunk,
                ("scatter", "push-sum"): scatter.pushsum_scatter_chunk,
                ("scatter", "gossip"): scatter.gossip_scatter_chunk,
                ("stencil", "push-sum"): fused.pushsum_chunk,
                ("stencil", "gossip"): fused.gossip_chunk}
    launches, seen = {}, set()
    for label, kernel, kind, n, algorithm, flags in REVIVE_RUNS:
        t0 = time.perf_counter()
        cli_too = kernel not in seen
        rounds, count, mae, planes = cpu_runs[label]
        cfg = revive_cfg(kind, n, algorithm, flags)
        fn = counters[kernel, algorithm]
        fn.launches = 0
        res = run(build_topology(kind, n), cfg)
        name = f"{'pushsum' if algorithm == 'push-sum' else 'gossip'} {kernel}"
        launches[name] = launches.get(name, 0) + fn.launches
        if fn.launches == 0:
            raise AssertionError(f"{label}: the run launched no {kernel} kernel")
        if (res.rounds, res.converged_count, res.estimate_mae) != (rounds, count, mae):
            raise AssertionError(f"{label}: card {res.rounds}/{res.converged_count}/"
                                 f"{res.estimate_mae} != CPU {rounds}/{count}/{mae}")
        same_planes(f"{label} run", res.state, planes)
        seen.add(kernel)
        if not cli_too:
            print(f"  {label} ({kind} n={n:,}): {res.outcome} at round {res.rounds}, "
                  f"{res.converged_count} converged, run() bitwise the CPU run; "
                  f"{fn.launches} launches ({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        cli = subprocess.run(
            [sys.executable, "-m", "cop5615_gossip_protocol_tpu_torch", str(n), kind,
             algorithm, *flags], capture_output=True, text=True, timeout=300)
        if cli.returncode not in (0, 1):
            raise AssertionError(f"{label} CLI exited {cli.returncode}: {cli.stderr[-500:]}")
        rec = json.loads(cli.stdout.strip().splitlines()[-1])
        if (rec["rounds"], rec["converged_count"], rec["estimate_mae"]) != (
                rounds, count, mae):
            raise AssertionError(f"{label} CLI: {rec['rounds']}/{rec['converged_count']}/"
                                 f"{rec['estimate_mae']} != CPU {rounds}/{count}/{mae}")
        print(f"  {label} ({kind} n={n:,}): {res.outcome} at round {res.rounds}, "
              f"{res.converged_count} converged, run() bitwise the CPU run, the CLI's "
              f"record equal; {fn.launches} launches "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def revive_phase(dev, key, cpu_runs):
    """Phase 14n: revive_checks, then revive_path. Returns (cases, max_err,
    launches)."""
    cases, max_err = revive_checks(dev, key)
    return cases, max_err, revive_path(dev, cpu_runs)


def revive_rows(cases, launches, max_err):
    """Phase 14n's rows of the kernels line: each kernel's revive instance
    (the schedule configs: push-sum rejoining fresh) over a 32-round chunk
    from the initial state by CUDA events, beside the fault-free instance
    on the same state in the same call and the plain version; the bound is
    the fault-free bound's bytes and operations (as phase 15 counts them
    for each kernel) plus the death and revival planes read."""
    sites = {"pool": ("ops/fused_pool.py:860", "ops/fused_pool.py:1157", "fused_pool.cu"),
             "scatter": ("ops/delivery.py:22", "ops/delivery.py:22", "scatter.cu"),
             "stencil": ("ops/fused.py:741", "ops/fused.py:993", "fused_resident.cu")}
    timed = {"pushsum": "pushsum fresh schedule", "gossip": "gossip schedule"}
    rows = []
    for kernel, kind, _ in REVIVE_KERNELS:
        for name, label in timed.items():
            kern, plain, chunk, init, n = cases[kernel, label]
            ms, (_, ex) = time_ms(lambda: chunk(kern, init, 0, CHUNK), TIME_REPS)
            free_ms, _ = time_ms(lambda: chunk(kern, init, 0, CHUNK, faulted=False),
                                 TIME_REPS)
            plain_ms, _ = time_ms(lambda: chunk(plain, init, 0, CHUNK), 1)
            rounds = int(ex)
            algo = "push-sum" if name == "pushsum" else "gossip"
            n_pad = init[0].numel()
            if kernel == "pool":
                state_bytes = 16 if name == "pushsum" else 12
                moved = 2 * state_bytes * n_pad + 8 * n_pad + CHUNK * (16 + 4 * POOL + 4)
                ops = rounds * (n_pad // 8 * OPS_PER_WORD
                                + n_pad * ops_per_node(algo, POOL))
            elif kernel == "scatter":
                moved = rounds * n * (2 * SCATTER_STATE_BYTES[name] + 8)
                ops = rounds * n * SCATTER_OPS[name]
            else:
                # The resident tier's state stays in the L2 through a chunk.
                moved = STATE_BYTES[name] * n_pad + 8 * n_pad + CHUNK * 16
                ops = rounds * n_pad * stencil_ops_per_node(algo, 4)
            bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
            site = sites[kernel][0 if name == "pushsum" else 1]
            print(f"  {name} {kernel} revive ({label}, {kind} n={n:,}): {ms:.4f} ms a "
                  f"{rounds}-round chunk against the fault-free instance's {free_ms:.4f} "
                  f"on the same state ({ms / free_ms:.3f}x), plain {plain_ms:.1f} ms",
                  flush=True)
            rows.append({"name": f"{name}_{kernel}_chunk revive", "route": "cuda",
                         "source": "cop5615_gossip_protocol_tpu_torch/csrc/"
                                   f"{sites[kernel][2]}",
                         "replaces": f"cop5615_gossip_protocol_tpu/{site}",
                         "launches": launches.get(f"{name} {kernel}", 0),
                         "max_abs_err": max_err[f"{name} {kernel}"],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                         "library_ms": None, "fault_free_ms": free_ms,
                         "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
                         "config": label, "status": "ported"})
    return rows


# ----------------------------------------------------------------- 14o
# Byzantine adversaries (ROADMAP A6c) in rows 1-2 and kernel A at full
# 1,000,000, kernel A at imp2d 100,000 (push-sum) and rows 5-6 at grid2d
# 10,000: 1% of the nodes turn at round 20, inside the chunk compared from
# round BYZ_MID; one config a kernel adds a crash and revive schedule.
BYZ_KERNELS = (("pool", "full", N), ("scatter", "full", N),
               ("scatter", "imp2d", 100_000), ("stencil", "grid2d", 10_000))
BYZ_MODES = (("push-sum", "mass_inflate"), ("push-sum", "mass_deflate"),
             ("push-sum", "garble"), ("gossip", "stale_rumor"), ("gossip", "garble"))
BYZ_MID = 16
FLT_MIN = 1.1754943508222875e-38


def byz_knobs(n, algorithm, mode, churn):
    """The knobs of a phase 14o kernel config at population n."""
    kw = {"byzantine_schedule": f"20:{n // 100}", "byzantine_mode": mode}
    if churn:
        kw.update(crash_schedule=f"5:{n // 100},20:{n // 20}",
                  revive_schedule=f"12:{n // 200},30:{n // 50}", quorum=0.95)
        if algorithm == "push-sum":
            kw["rejoin"] = "fresh"
    return kw


def byz_checks(dev, key):
    """Phase 14o, the kernels: each of BYZ_KERNELS in each mode (push-sum
    only on imp2d) and one push-sum mass_deflate config with crash and
    revive, against its plain version on the card: from the kernel's own
    state at round BYZ_MID, a CHUNK-round chunk across the onset, every
    plane and the rounds bitwise. Returns ({(kernel, kind, name): timing
    case}, {row key: max_abs_err})."""
    import torch

    cases, max_err = {}, {}
    for kernel, kind, n in BYZ_KERNELS:
        t0 = time.perf_counter()
        configs = [(a, m, False) for a, m in BYZ_MODES if kind != "imp2d" or a == "push-sum"]
        configs.append(("push-sum", "mass_deflate", True))
        for algorithm, mode, churn in configs:
            kern, plain, chunk, init, _ = kernel_fns(
                dev, key, kernel, kind, n, algorithm, byz_knobs(n, algorithm, mode, churn))
            tag = f"{kernel} {kind} {algorithm} {mode}{' with churn' if churn else ''}"
            mid, ran = chunk(kern, init, 0, BYZ_MID)
            if int(ran) != BYZ_MID:
                raise AssertionError(f"{tag}: done before round {BYZ_MID}")
            got, g_ran = chunk(kern, mid, BYZ_MID, CHUNK)
            want, w_ran = chunk(plain, mid, BYZ_MID, CHUNK)
            if int(g_ran) != int(w_ran):
                raise AssertionError(f"{tag}: rounds {int(g_ran)} != plain {int(w_ran)}")
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            row = f"{name} {kernel} {kind}"
            max_err[row] = max(max_err.get(row, 0.0),
                               same_planes(f"{tag} from round {BYZ_MID}", got, want))
            if not churn and mode in ("mass_inflate", "stale_rumor"):
                cases[kernel, kind, name] = (kern, plain, chunk, mid, n)
        print(f"  {kernel} ({kind} n={n:,}): {len(configs)} configs, a {CHUNK}-round "
              f"chunk from round {BYZ_MID} across the onset at round 20 bitwise its plain "
              f"version ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return cases, max_err


def drained_planes(n, n_pad, dev, flat=False):
    """A push-sum state drained into the subnormals' edge: s and w drawn
    from values near FLT_MIN (whose halves are subnormal) and a few normal
    ones, pad lanes (0, 1); term 0, conv 0. Flat [n_pad] planes, or the
    [n_pad / 128, 128] layout."""
    import torch

    gen = torch.Generator().manual_seed(3)
    vals = torch.tensor([1.91e-38, 1.5e-38, 2.35e-38, FLT_MIN, 3.0e-38, 2.4e-38, 1.0, 5.0],
                        dtype=torch.float32)
    s = vals[torch.randint(0, vals.numel(), (n_pad,), generator=gen)]
    w = vals[torch.randint(0, vals.numel(), (n_pad,), generator=gen)]
    s[n:], w[n:] = 0.0, 1.0
    zero = torch.zeros(n_pad, dtype=torch.int32)
    planes = (s, w, zero, zero.clone())
    if not flat:
        planes = tuple(p.reshape(n_pad // 128, 128) for p in planes)
    return tuple(p.to(dev) for p in planes)


def drained_checks(dev, key):
    """Phase 14o, C1: a drained crafted state through each push-sum
    instance that carries crash-stop (rows 1, 3, 5 and 20, kernel A) under
    a crash model, against its plain version on the card: 8 rounds (row
    20: one round of every shard), every plane bitwise. Each flushes where
    the plain round does; the state's halves are subnormal, so a kernel
    that kept them would differ."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig
    from cop5615_gossip_protocol_tpu_torch.models.pushsum import PushSumState
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, fused_pool2
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded as p2s

    t0 = time.perf_counter()
    for kernel, kind, n in (("pool", "full", N), ("scatter", "full", N),
                            ("stencil", "grid2d", 10_000)):
        kw = {"crash_schedule": f"2:{n // 100}", "quorum": 0.9}
        kern, plain, chunk, init, _ = kernel_fns(dev, key, kernel, kind, n, "push-sum", kw)
        if kernel == "scatter":
            p = drained_planes(n, n, dev, flat=True)
            state = PushSumState(p[0], p[1], p[2], p[3] != 0)
        else:
            state = drained_planes(n, init[0].numel(), dev)
        same_planes(f"drained {kernel} {kind}", chunk(kern, state, 40, 8)[0],
                    chunk(plain, state, 40, 8)[0])
    # Row 3: the streaming pool kernel's faulted instance on the pool layout.
    cfg = SimConfig(n=N, algorithm="push-sum", delivery="pool", pool_size=POOL,
                    crash_rate=0.01, quorum=0.9)
    faults = fused.run_faults(cfg, N)
    state = drained_planes(N, fused_pool.build_pool_layout(N).n_pad, dev)
    common = dict(n=N, target=N, delta=cfg.resolved_delta, term_rounds=cfg.term_rounds,
                  faults=faults)
    keys, offs = fused.round_keys(key, 40, 8), fused_pool.round_offsets(key, 40, 8, POOL, N)
    same_planes("drained pool2 full",
                fused_pool2.pushsum_pool2_chunk(state, keys, offs, 40, 48, **common)[0],
                fused_pool2.pushsum_pool2_chunk_plain(state, keys, offs, 40, 48, **common)[0])
    # Row 20: one round of every shard at SHARD_FAULT_N in SHARD_TIMED's shards.
    n, shards = SHARD_FAULT_N, SHARD_TIMED[1]
    kern, plain, kw, rows_loc, layout, _, _ = shard_case(dev, key, n, shards, "push-sum")
    cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", pool_size=POOL,
                    crash_rate=0.01, quorum=0.9)
    faults = fused.run_faults(cfg, n)
    R = layout.rows
    death = faults.death_flat(layout.n_pad, dev).reshape(R, 128)
    planes = shard_planes(drained_planes(n, layout.n_pad, dev), "push-sum")
    streams = shard_streams(key, 0, 2, n, dev)
    sends = torch.zeros(R // 8, 128, dtype=torch.uint8, device=dev)
    for lo in range(0, R, rows_loc):
        p2s.pool2_shard_sends(sends, None, death[lo:lo + rows_loc].contiguous(),
                              streams[2][0], 0, lo, rows_loc, n=n, thresh=0)
    glob, own = p2s.split_state(planes, "push-sum")
    for s in range(shards):
        lo = s * rows_loc
        rows_death = death[lo:lo + rows_loc].contiguous()
        sf = p2s.ShardFaults(0, rows_death, None, 0, False, sends, torch.zeros_like(sends))
        out = tuple(torch.empty_like(x) for x in planes)
        ctl = {"u": torch.zeros(1, dtype=torch.int32, device=dev),
               "acc": torch.zeros(2, dtype=torch.int32, device=dev),
               "ctrl": torch.zeros(2, dtype=torch.int32, device=dev)}
        shard_launch(kern, "push-sum", kw, planes, out, streams, 0, lo, rows_loc, **ctl,
                     faults=sf)
        got_glob, got_own = p2s.split_state(out, "push-sum")
        got = p2s.join_state(p2s._rows_of(got_glob, lo, rows_loc),
                             tuple(p[lo:lo + rows_loc] for p in got_own), "push-sum")
        want, _ = plain(glob, tuple(p[lo:lo + rows_loc] for p in own), streams[2][0],
                        streams[3][0], lo, **kw, faults=sf._replace(next_sends=None))
        shard_bitwise(f"drained pool2 shard {s}", got, want)
    print(f"  a drained state (s, w near FLT_MIN) through rows 1, 3, 5, 20 and kernel A "
          f"under a crash model, bitwise each plain version "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()


# Phase 14o's runs: (label, kernel or None for the chunked engine's torch
# rounds, kind, n, algorithm, knobs, and the JAX package's chunked engine on
# the CPU: rounds, converged count, outcome, unhealthy round, estimate_mae).
# The first seven are the kernels line's Byzantine rows' main-path runs, one
# a row at its kernel, shape and mode (byz_knobs, capped rounds); the rest
# check the other modes, churn, trim, clip, the sentinel and ROADMAP C1.
BYZ_ROW_RUNS = 7
BYZ_RUNS = (
    ("pool push-sum row", "pool", "full", N, "push-sum",
     dict(delivery="pool", pool_size=POOL, byzantine_schedule=f"20:{N // 100}",
          byzantine_mode="mass_inflate", max_rounds=100),
     (100, 785948, "max_rounds", None, 0.04891205438035852)),
    ("pool gossip row", "pool", "full", N, "gossip",
     dict(delivery="pool", pool_size=POOL, byzantine_schedule=f"20:{N // 100}",
          byzantine_mode="stale_rumor", max_rounds=100),
     (100, 990000, "max_rounds", None, None)),
    ("scatter push-sum row", "scatter", "full", N, "push-sum",
     dict(byzantine_schedule=f"20:{N // 100}", byzantine_mode="mass_inflate", max_rounds=100),
     (100, 680199, "max_rounds", None, 0.05546462182948156)),
    ("scatter gossip row", "scatter", "full", N, "gossip",
     dict(byzantine_schedule=f"20:{N // 100}", byzantine_mode="stale_rumor", max_rounds=100),
     (100, 990000, "max_rounds", None, None)),
    ("scatter imp2d push-sum row", "scatter", "imp2d", 100_000, "push-sum",
     dict(byzantine_schedule="20:1000", byzantine_mode="mass_inflate", max_rounds=300),
     (300, 99290, "max_rounds", None, 2.1681926319107676)),
    ("stencil push-sum row", "stencil", "grid2d", 10_000, "push-sum",
     dict(byzantine_schedule="20:100", byzantine_mode="mass_inflate", max_rounds=300),
     (300, 40, "max_rounds", None, 2747.8530031817327)),
    ("stencil gossip row", "stencil", "grid2d", 10_000, "gossip",
     dict(byzantine_schedule="20:100", byzantine_mode="stale_rumor", max_rounds=200),
     (200, 9900, "max_rounds", None, None)),
    ("mass_inflate unmitigated", None, "full", 256, "push-sum",
     dict(delivery="pool", chunk_rounds=32, max_rounds=2000, byzantine_schedule="12:8",
          byzantine_mode="mass_inflate", mass_tolerance=1e-3),
     (13, 0, "unhealthy", 12, 0.0)),
    ("mass_inflate under clip", None, "full", 256, "push-sum",
     dict(delivery="pool", chunk_rounds=32, max_rounds=2000, byzantine_schedule="12:8",
          byzantine_mode="mass_inflate", robust_agg="clip"),
     (293, 256, "converged", None, 0.024079235020734446)),
    ("mass_inflate under trim", None, "full", 256, "push-sum",
     dict(delivery="pool", chunk_rounds=32, max_rounds=2000, seed=1, byzantine_rate=0.05,
          byzantine_mode="mass_inflate", robust_agg="trim"),
     (135, 256, "converged", None, 1.6477119714302677)),
    ("pool mass_inflate", "pool", "full", 20_000, "push-sum",
     dict(delivery="pool", pool_size=2, byzantine_schedule="20:200",
          byzantine_mode="mass_inflate", max_rounds=400),
     (216, 20_000, "converged", None, 0.0007820173152954339)),
    ("pool mass_deflate with churn", "pool", "full", 20_000, "push-sum",
     dict(delivery="pool", pool_size=2, byzantine_rate=0.01, byzantine_mode="mass_deflate",
          crash_schedule="5:200,20:1000", revive_schedule="12:100,30:400", rejoin="fresh",
          quorum=0.95, max_rounds=400),
     (126, 18_336, "converged", None, 467.60648901117594)),
    ("pool gossip garble", "pool", "full", 20_000, "gossip",
     dict(delivery="pool", pool_size=2, byzantine_rate=0.01, byzantine_mode="garble"),
     (38, 20_000, "converged", None, None)),
    ("scatter garble", "scatter", "full", 20_000, "push-sum",
     dict(byzantine_rate=0.01, byzantine_mode="garble", max_rounds=400),
     (400, 0, "max_rounds", None, 0.0)),
    ("scatter gossip stale_rumor", "scatter", "full", 20_000, "gossip",
     dict(byzantine_schedule="5:100", byzantine_mode="stale_rumor", max_rounds=200),
     (200, 19_900, "max_rounds", None, None)),
    ("stencil mass_deflate with churn", "stencil", "grid2d", 10_000, "push-sum",
     dict(byzantine_rate=0.01, byzantine_mode="mass_deflate", crash_rate=0.001,
          revive_rate=0.2, quorum=0.9, max_rounds=600),
     (600, 87, "max_rounds", None, 2649.064890829168)),
    ("stencil gossip garble", "stencil", "grid2d", 10_000, "gossip",
     dict(byzantine_rate=0.01, byzantine_mode="garble", crash_schedule="5:100,20:500",
          revive_schedule="12:50,30:200", quorum=0.95),
     (287, 9193, "converged", None, None)),
    # ROADMAP C1's configs: drained runs of row 5's faulted instance (line,
    # ref2d) and of the chunked engine's torch rounds on the card (ring 257,
    # whose tiled tier refuses crashes, as in JAX).
    ("C1 line", "stencil", "line", 200, "push-sum", C1_KNOBS,
     (536, 153, "converged", None, 164.86640460104104)),
    ("C1 ring", None, "ring", 257, "push-sum", C1_KNOBS,
     (819, 205, "converged", None, 144.54766571023697)),
    ("C1 ref2d", "stencil", "ref2d", 400, "push-sum", C1_KNOBS,
     (1265, 334, "converged", None, 163.27190031009195)),
)


def byz_path(dev):
    """Phase 14o, the runs: each of BYZ_RUNS on the card through run(), the
    counters zeroed just before it and read just after, against the JAX
    chunked engine's values baked above (scatter delivery with clip and the
    sentinel runs in phase 14p). Returns {(kernel, kind, name): launches}
    of the first BYZ_ROW_RUNS runs, the rows' own."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, scatter

    counters = {("pool", "push-sum"): fused_pool.pushsum_pool_chunk,
                ("pool", "gossip"): fused_pool.gossip_pool_chunk,
                ("scatter", "push-sum"): scatter.pushsum_scatter_chunk,
                ("scatter", "gossip"): scatter.gossip_scatter_chunk,
                ("stencil", "push-sum"): fused.pushsum_chunk,
                ("stencil", "gossip"): fused.gossip_chunk}
    launches = {}
    t0 = time.perf_counter()
    for i, (label, kernel, kind, n, algorithm, kw, want) in enumerate(BYZ_RUNS):
        for fn in counters.values():
            fn.launches = 0
        res = run(build_topology(kind, n), SimConfig(n=n, topology=kind, algorithm=algorithm,
                                                     **kw))
        counts = {k: fn.launches for k, fn in counters.items()}
        got = (res.rounds, res.converged_count, res.outcome, res.unhealthy_round,
               res.estimate_mae)
        # The estimate is a float64 numpy sum on the host, whose order
        # numpy picks by the host's vector width: its last place can differ
        # from the baking machine's on equal planes.
        mae, want_mae = got[4], want[4]
        if got[:4] != want[:4] or (mae is None) != (want_mae is None) or (
                mae is not None and abs(mae - want_mae) > 1e-12 * max(1.0, abs(want_mae))):
            raise AssertionError(f"{label} ({kind} n={n:,}): {got} != JAX {want}")
        if kernel is None:
            if any(counts.values()):
                raise AssertionError(f"{label}: the chunked engine's run launched a kernel")
            continue
        if counts[kernel, algorithm] == 0:
            raise AssertionError(f"{label}: the run launched no {kernel} kernel")
        if i < BYZ_ROW_RUNS:
            name = "pushsum" if algorithm == "push-sum" else "gossip"
            launches[kernel, kind, name] = counts[kernel, algorithm]
            MAIN_ROUNDS[f"{name}_{kernel}_chunk byzantine {kind}"] = res.rounds
            print(f"  {label} ({kind} n={n:,}): {res.outcome} at round {res.rounds}, "
                  f"{counts[kernel, algorithm]} launches", flush=True)
    print(f"  {len(BYZ_RUNS)} runs through run() equal to the JAX chunked engine's "
          f"rounds, counts, outcome, unhealthy round and estimate (each Byzantine row's "
          f"main-path run, the acceptance pair, trim, rows 1-2, 5-6 and kernel A under "
          f"each mode, ROADMAP C1's drained configs) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return launches


def byz_phase(dev, key):
    """Phase 14o: byz_checks, drained_checks, then byz_path. Returns
    (cases, max_err, launches)."""
    cases, max_err = byz_checks(dev, key)
    drained_checks(dev, key)
    return cases, max_err, byz_path(dev)


def byz_rows(cases, launches, max_err):
    """Phase 14o's rows of the kernels line: each kernel's faulted instance
    under a Byzantine model (push-sum mass_inflate, gossip stale_rumor) over
    a CHUNK-round chunk from the round-BYZ_MID state by CUDA events, beside
    the fault-free instance on the same state in the same call and the
    plain version; the bound is revive_rows' with the onset plane in place
    of the death and revival planes."""
    sites = {"pool": ("ops/fused_pool.py:860", "ops/fused_pool.py:1157", "fused_pool.cu"),
             "scatter": ("ops/delivery.py:22", "ops/delivery.py:22", "scatter.cu"),
             "stencil": ("ops/fused.py:741", "ops/fused.py:993", "fused_resident.cu")}
    rows = []
    for (kernel, kind, name), (kern, plain, chunk, mid, n) in cases.items():
        ms, (_, ex) = time_ms(lambda: chunk(kern, mid, BYZ_MID, CHUNK), TIME_REPS)
        free_ms, _ = time_ms(lambda: chunk(kern, mid, BYZ_MID, CHUNK, faulted=False),
                             TIME_REPS)
        plain_ms, _ = time_ms(lambda: chunk(plain, mid, BYZ_MID, CHUNK), 1)
        rounds = max(int(ex), 1)
        algo = "push-sum" if name == "pushsum" else "gossip"
        n_pad = mid[0].numel()
        if kernel == "pool":
            state_bytes = 16 if name == "pushsum" else 12
            moved = 2 * state_bytes * n_pad + 4 * n_pad + CHUNK * (16 + 4 * POOL + 4)
            ops = rounds * (n_pad // 8 * OPS_PER_WORD + n_pad * ops_per_node(algo, POOL))
        elif kernel == "scatter":
            moved = rounds * n * (2 * SCATTER_STATE_BYTES[name] + 4)
            ops = rounds * n * SCATTER_OPS[name]
        else:
            moved = STATE_BYTES[name] * n_pad + 4 * n_pad + CHUNK * 16
            ops = rounds * n_pad * stencil_ops_per_node(algo, 4)
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        print(f"  {name} {kernel} byzantine ({kind} n={n:,}): {ms:.4f} ms a {rounds}-round "
              f"chunk against the fault-free instance's {free_ms:.4f} on the same state "
              f"({ms / free_ms:.3f}x), plain {plain_ms:.1f} ms", flush=True)
        rows.append({"name": f"{name}_{kernel}_chunk byzantine {kind}", "route": "cuda",
                     "source": f"cop5615_gossip_protocol_tpu_torch/csrc/{sites[kernel][2]}",
                     "replaces": "cop5615_gossip_protocol_tpu/"
                                 f"{sites[kernel][0 if name == 'pushsum' else 1]}",
                     "launches": launches[kernel, kind, name],
                     "max_abs_err": max_err[f"{name} {kernel} {kind}"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "fault_free_ms": free_ms,
                     "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
                     "config": "byzantine mass_inflate" if name == "pushsum"
                               else "byzantine stale_rumor",
                     "status": "ported"})
    return rows


# ----------------------------------------------------------------- 14p
# The telemetry plane (ROADMAP A6d) in kernel A, rows 1-2 and rows 5-6, and
# kernel A's clip and sentinel instances (A6c-2). TELE_KERNELS are the
# telemetry instances at their main-path shapes, each fault-free and with a
# drop gate and a crash and revive schedule (tele_knobs); a chunk from the
# kernel's own state at round TELE_MID is held against the plain version,
# whose float sums follow the kernel's order on the kernel's grid.
TELE_KERNELS = (("scatter", "full", N), ("pool", "full", N),
                ("stencil", "grid2d", 10_000), ("scatter", "imp2d", 100_000))
TELE_MID = 16
NEVER = 2**31 - 1
# The columns of a row that are counts, exact in any order (ops/telemetry.py).
TELE_INTS = (0, 1, 2, 3, 6, 7, 8, 9)
# A failure model of nothing: it runs a kernel's faulted instance with no
# fault (the instance a telemetry instance extends).
def empty_faults():
    from cop5615_gossip_protocol_tpu_torch.ops import fused

    return fused.Faults(thresh=None, death=None, death_sorted=None, quorum=1.0,
                        global_term=False)


# Kernel A's clip and sentinel at full 1,000,000: 1% of the nodes inflate
# from round 20; the sentinel's tolerance is far above the float32 rounding
# of a million-node Σw (its ulp is 0.0625) and far below the ~5,000 the
# attack adds, so the trip round does not depend on the sum's order.
CLIP_KW = {"byzantine_schedule": f"20:{N // 100}", "byzantine_mode": "mass_inflate",
           "robust_agg": "clip"}
SENTINEL_KW = {"byzantine_schedule": f"20:{N // 100}", "byzantine_mode": "mass_inflate",
               "mass_tolerance": 100.0}


def tele_knobs(n, algorithm, churn):
    """A 14p kernel config's knobs: none, or a drop gate with a crash and
    revive schedule (push-sum rejoining fresh)."""
    if not churn:
        return {}
    kw = {"fault_rate": 0.1, "crash_schedule": f"5:{n // 100},20:{n // 20}",
          "revive_schedule": f"12:{n // 200},30:{n // 50}", "quorum": 0.95}
    if algorithm == "push-sum":
        kw["rejoin"] = "fresh"
    return kw


def tele_fns(dev, key, kernel, kind, n, algorithm, kw):
    """One kernel of phase 14p under a config with telemetry on (knobs kw):
    a namespace of the kernel wrapper, the plain version, chunk(fn, state,
    start, count, tele=True, fx=the config's Faults) -> (state, status
    (kernel A) or rounds run, rows or None), the initial state on the card,
    the scatter graph (kernel A) and grid(tele), the grid of the instance a
    chunk runs. The plain version sums the rows' floats (and the sentinel's
    Σw) in the kernel's order on that grid."""
    import types

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, scatter, telemetry

    name = "pushsum" if algorithm == "push-sum" else "gossip"
    pushsum = name == "pushsum"
    topo = build_topology(kind, n)
    n = topo.n  # imp2d rounds the population to a square
    if kernel == "scatter":
        from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
        from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
        from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader

        cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, telemetry=True, **kw)
        graph = scatter.scatter_graph(topo, dev)
        faults = fused.run_faults(cfg, n)

        @functools.lru_cache(maxsize=None)
        def grid(tele):
            flags = (scatter.instance_flags(faults, tele) if pushsum
                     else scatter.TELE if tele else 0)
            return scatter.telemetry_grid(pushsum, faults is not None or tele, flags, n,
                                          dev.index)

        @functools.lru_cache(maxsize=None)
        def order(tele):
            o = telemetry.slice_order if pushsum else telemetry.strided_order
            return o(grid(tele), n).to(dev)

        rows_kern = telemetry.make_row_fn(topo, cfg, key, dev)
        if pushsum:
            init = pushsum_mod.init_state(n, cfg.initial_term_round, dev)
            kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
            extra = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        else:
            init = gossip_mod.init_state(n, draw_leader(key, topo, cfg), False, dev)
            kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain
            extra = {"rumor_target": cfg.resolved_rumor_target,
                     "suppress": cfg.resolved_suppress}
        keys = functools.lru_cache(maxsize=None)(
            lambda start, count: fused.round_keys(key, start, count))
        health = [NEVER] if cfg.mass_tolerance is not None else []

        def chunk(fn, state, start, count, tele=True, fx=faults):
            status = torch.tensor([start, 0, *health], dtype=torch.int32, device=dev)
            if fn is plain:
                o = order(tele)
                rows_fn = telemetry.make_row_fn(
                    topo, cfg, key, dev, fsum=functools.partial(telemetry.kernel_sum, order=o))
                st, status, *rows = fn(state, keys(start, count), status, graph=graph,
                                       target=n, start=start, faults=fx,
                                       telemetry=rows_fn if tele else None,
                                       **({"order": o} if pushsum else {}), **extra)
            else:
                st, status, *rows = fn(state, key, start, count, status, graph=graph,
                                       target=n, faults=fx,
                                       telemetry=rows_kern if tele else None, **extra)
            return st, status, rows[0] if rows else None

        return types.SimpleNamespace(kern=kern, plain=plain, chunk=chunk, init=init,
                                     graph=graph, grid=grid, n=n, faults=faults)
    extra = {"delivery": "pool", "pool_size": POOL} if kernel == "pool" else {}
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, telemetry=True, **extra, **kw)
    if fused_tier(topo, cfg) != (kernel, None):
        raise AssertionError(f"{kind} n={n} {kw}: the ladder picks {fused_tier(topo, cfg)}, "
                             f"not {kernel}")
    eng = fused_engine(topo, cfg, key, kernel)
    init = tuple(p.contiguous().to(dev) for p in eng.planes)
    n_pad = init[0].numel()
    faults = fused.run_faults(cfg, n)
    if kernel == "pool":
        kern, plain = {"pushsum": (fused_pool.pushsum_pool_chunk,
                                   fused_pool.pushsum_pool_chunk_plain),
                       "gossip": (fused_pool.gossip_pool_chunk,
                                  fused_pool.gossip_pool_chunk_plain)}[name]
        common = {"n": n}
        g = fused_pool.telemetry_grid("fused_pool", pushsum, POOL, n_pad, dev.index)
    else:
        from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm as hbm

        kern = resident_wrappers()[name, "stencil"]
        plain = {"pushsum": hbm.pushsum_stencil_hbm_chunk_plain,
                 "gossip": hbm.gossip_stencil_hbm_chunk_plain}[name]
        common = {"spec": hbm.stencil_spec(topo)}
        g = fused_pool.telemetry_grid("fused_resident", pushsum, 0, n_pad, dev.index)
    common.update(target=n, faults=faults)
    if pushsum:
        common.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds)
    else:
        common.update(rumor_target=cfg.resolved_rumor_target, suppress=cfg.resolved_suppress)
    streams = functools.lru_cache(maxsize=None)(eng.streams)

    def chunk(fn, state, start, count, tele=True, fx=faults):
        kw2 = dict(common, faults=fx)
        if fn is not plain:
            kw2["telemetry"] = tele
        elif kernel == "pool":
            kw2.update(telemetry=tele, grid=g)
        else:
            kw2["telemetry"] = fused.RowSpec.for_layout("stencil", n_pad, g) if tele else None
        st, ex, *rows = fn(state, *streams(start, count), start, start + count, **kw2)
        return st, ex, rows[0] if rows else None

    return types.SimpleNamespace(kern=kern, plain=plain, chunk=chunk, init=init, graph=None,
                                 grid=lambda tele: g, n=n, faults=faults)


def tele_ran(st, start):
    """Rounds a chunk ran: from kernel A's status, or the fused chunk's count."""
    return int(st[0]) - start if st.numel() > 1 else int(st)


def tele_compare(tag, got, want):
    """A chunk's state, status or rounds, and rows against another's, every
    plane and row bitwise; returns the largest absolute difference (0.0)."""
    err = same_planes(tag, got[0], want[0])
    same_planes(f"{tag}: status", [got[1]], [want[1]])
    if (got[2] is None) != (want[2] is None):
        raise AssertionError(f"{tag}: one side has rows")
    if got[2] is not None:
        same_planes(f"{tag}: rows", [got[2]], [want[2]])
    return err


def tele_checks(dev, key):
    """Phase 14p, the kernels: each of TELE_KERNELS' telemetry instances
    (push-sum only on imp2d), fault-free and with a gate and a crash and
    revive schedule: from the instance's own state at round TELE_MID a
    CHUNK-round chunk against its plain version (every plane, the status and
    every row bitwise) and against the instance without telemetry (every
    plane and the status bitwise: rows observe, they change nothing), kernel
    A's scratch zero after it. Returns ({(kernel, kind, name): case}, {row:
    max_abs_err})."""
    import torch

    cases, max_err = {}, {}
    for kernel, kind, n in TELE_KERNELS:
        t0 = time.perf_counter()
        algorithms = ("push-sum",) if kind == "imp2d" else ("push-sum", "gossip")
        for algorithm in algorithms:
            for churn in (False, True):
                f = tele_fns(dev, key, kernel, kind, n, algorithm,
                             tele_knobs(n, algorithm, churn))
                tag = f"{kernel} {kind} {algorithm}{' with churn' if churn else ''} telemetry"
                mid, st, _ = f.chunk(f.kern, f.init, 0, TELE_MID)
                if tele_ran(st, 0) != TELE_MID:
                    raise AssertionError(f"{tag}: done before round {TELE_MID}")
                got = f.chunk(f.kern, mid, TELE_MID, CHUNK)
                err = tele_compare(f"{tag} from round {TELE_MID}", got,
                                   f.chunk(f.plain, mid, TELE_MID, CHUNK))
                off = f.chunk(f.kern, mid, TELE_MID, CHUNK, tele=False)
                tele_compare(f"{tag} on/off", (got[0], got[1], None), off)
                if f.graph is not None:
                    scatter_scratch_zero(tag, f.graph)
                if not float(got[2][:, 1].sum()) > 0:  # the live column
                    raise AssertionError(f"{tag}: the rows are empty")
                name = "pushsum" if algorithm == "push-sum" else "gossip"
                row = f"{name} {kernel} {kind}"
                max_err[row] = max(max_err.get(row, 0.0), err)
                if not churn:
                    cases[kernel, kind, name] = f
        print(f"  {kernel} ({kind} n={n:,}): telemetry instances fault-free and with a gate "
              f"and churn, a {CHUNK}-round chunk from round {TELE_MID} bitwise the plain "
              f"version (planes, status, rows) and the instance without telemetry "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return cases, max_err


def clip_sentinel_checks(dev, key):
    """Phase 14p, A6c-2: kernel A's clip and sentinel instances, each with
    and without telemetry, at full 1,000,000 against the plain version from
    the kernel's own state at round TELE_MID, a CHUNK-round chunk across the
    onset at round 20 (every plane, the status and the rows bitwise); the
    sentinel trips at round 20 inside the chunk and latches it in the
    status's third word. Returns ({label: case}, {row: max_abs_err})."""
    cases, max_err = {}, {}
    t0 = time.perf_counter()
    # For the timing: clip against the faulted instance under the same
    # Byzantine model, the sentinel on an honest run (no trip in the chunk)
    # against the fault-free instance.
    base = tele_fns(dev, key, "scatter", "full", N, "push-sum",
                    {k: v for k, v in CLIP_KW.items() if k.startswith("byzantine")})
    honest = tele_fns(dev, key, "scatter", "full", N, "push-sum",
                      {"mass_tolerance": SENTINEL_KW["mass_tolerance"]})
    for label, kw in (("clip", CLIP_KW), ("sentinel", SENTINEL_KW),
                      ("sentinel global", dict(SENTINEL_KW, termination="global"))):
        f = tele_fns(dev, key, "scatter", "full", N, "push-sum", kw)
        f.base, f.timed = (base, f) if label == "clip" else (None, honest)
        for tele in (False, True):
            tag = f"scatter {label}{' telemetry' if tele else ''}"
            mid, st, _ = f.chunk(f.kern, f.init, 0, TELE_MID, tele)
            if tele_ran(st, 0) != TELE_MID:
                raise AssertionError(f"{tag}: done before round {TELE_MID}")
            got = f.chunk(f.kern, mid, TELE_MID, CHUNK, tele)
            err = tele_compare(f"{tag} from round {TELE_MID}", got,
                               f.chunk(f.plain, mid, TELE_MID, CHUNK, tele))
            scatter_scratch_zero(tag, f.graph)
            status = [int(v) for v in got[1]]
            if label.startswith("sentinel") and status != [21, 1, 20]:
                raise AssertionError(f"{tag}: status {status}, want the trip at round 20")
            # Global termination: the trip leaves conv as round 20's verdict
            # wrote it (no round was stable), not latched on every node.
            if label == "sentinel global" and int(got[0].conv.sum()) != 0:
                raise AssertionError(f"{tag}: {int(got[0].conv.sum())} nodes converged")
            if label == "clip" and status[:2] != [TELE_MID + CHUNK, 0]:
                raise AssertionError(f"{tag}: status {status}")
            max_err[f"{label}{' telemetry' if tele else ''}"] = err
        cases[label] = f
    print(f"  scatter clip and sentinel (full n={N:,}; the sentinel under local and global "
          f"termination), with and without telemetry: a {CHUNK}-round chunk from round "
          f"{TELE_MID} bitwise the plain version, the sentinel tripping at round 20 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return cases, max_err


# Phase 14p's runs: (label, kernel, kind, n, algorithm, knobs, and the JAX
# package's chunked engine on the CPU: rounds, converged count, outcome,
# unhealthy round, estimate_mae; then, under telemetry, a digest of its
# rows' count columns, its middle and its last row). The first TELE_ROW_RUNS
# are the kernels line's rows' main-path runs, one a row.
TELE_ROW_RUNS = 9
TELE_RUNS = (
    ("scatter push-sum telemetry", "scatter", "full", N, "push-sum",
     dict(telemetry=True, max_rounds=100),
     (100, 682815, "max_rounds", None, 0.025377014493501347),
     ("55bb00e8849b7fda", 50, [67584.0, 1000000.0, 932416.0, 0.0, 0.02212062105536461,
                               -0.125, 0.0, 0.0, 0.0, 0.0],
      [682815.0, 1000000.0, 317185.0, 0.0, 0.024290574714541435, 0.0625, 0.0, 0.0, 0.0,
       0.0])),
    ("scatter gossip telemetry", "scatter", "full", N, "gossip", dict(telemetry=True),
     (56, 1000000, "converged", None, None),
     ("90e28b2dcd82281c", 28, [407717.0, 1000000.0, 592283.0, 999872.0, 0.0, 0.0, 0.0, 0.0,
                               0.0, 0.0],
      [1000000.0, 1000000.0, 0.0, 1000000.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])),
    ("pool push-sum telemetry", "pool", "full", N, "push-sum",
     dict(delivery="pool", pool_size=POOL, telemetry=True, max_rounds=100),
     (100, 788489, "max_rounds", None, 0.024118961397771744),
     ("1140d02f0287a54b", 50, [99856.0, 1000000.0, 900144.0, 0.0, 0.021039672195911407,
                               0.0625, 0.0, 0.0, 0.0, 0.0],
      [788489.0, 1000000.0, 211511.0, 0.0, 0.022980663925409317, 0.0, 0.0, 0.0, 0.0,
       0.0])),
    ("pool gossip telemetry", "pool", "full", N, "gossip",
     dict(delivery="pool", pool_size=POOL, telemetry=True),
     (48, 1000000, "converged", None, None),
     ("25c534621c68e255", 24, [8923.0, 1000000.0, 991077.0, 998702.0, 0.0, 0.0, 0.0, 0.0,
                               0.0, 0.0],
      [1000000.0, 1000000.0, 0.0, 1000000.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])),
    ("stencil push-sum telemetry", "stencil", "grid2d", 10_000, "push-sum",
     dict(telemetry=True, max_rounds=300),
     (300, 45, "max_rounds", None, 2608.727033233688),
     ("df18b906ebb2c308", 150, [23.0, 10000.0, 9977.0, 0.0, 2740.026611328125, 0.0, 0.0,
                                0.0, 0.0, 0.0],
      [45.0, 10000.0, 9955.0, 0.0, 2608.726806640625, 0.0, 0.0, 0.0, 0.0, 0.0])),
    ("stencil gossip telemetry", "stencil", "grid2d", 10_000, "gossip", dict(telemetry=True),
     (322, 10000, "converged", None, None),
     ("126af7447fcbe1c1", 161, [3973.0, 10000.0, 6027.0, 4520.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                0.0],
      [10000.0, 10000.0, 0.0, 10000.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])),
    ("scatter imp2d push-sum telemetry", "scatter", "imp2d", 100_000, "push-sum",
     dict(telemetry=True, max_rounds=300),
     (300, 100067, "max_rounds", None, 0.0028661904611618923),
     ("931139bfa0d67f7b", 150, [5306.0, 100489.0, 95183.0, 0.0, 0.011598014272749424, 0.0,
                                0.0, 0.0, 0.0, 0.0],
      [100067.0, 100489.0, 422.0, 0.0, 0.0027103715110570192, -0.0078125, 0.0, 0.0, 0.0,
       0.0])),
    ("scatter clip", "scatter", "full", N, "push-sum", dict(CLIP_KW, max_rounds=100),
     (100, 684925, "max_rounds", None, 1.6034667931057975), None),
    ("scatter sentinel", "scatter", "full", N, "push-sum", dict(SENTINEL_KW, max_rounds=100),
     (21, 0, "unhealthy", 20, 0.0), None),
    # The acceptance pair of the JAX package's tests on scatter delivery.
    ("scatter sentinel 256", "scatter", "full", 256, "push-sum",
     dict(chunk_rounds=32, max_rounds=2000, byzantine_schedule="12:8",
          byzantine_mode="mass_inflate", mass_tolerance=1e-3),
     (13, 0, "unhealthy", 12, 0.0), None),
    ("scatter clip 256", "scatter", "full", 256, "push-sum",
     dict(chunk_rounds=32, max_rounds=2000, byzantine_schedule="12:8",
          byzantine_mode="mass_inflate", robust_agg="clip"),
     (284, 256, "converged", None, 0.03563208905430265), None),
    ("scatter telemetry clip", "scatter", "full", 20_000, "push-sum",
     dict(telemetry=True, byzantine_schedule="20:200", byzantine_mode="mass_inflate",
          robust_agg="clip", max_rounds=300),
     (300, 19999, "max_rounds", None, 2.980727190955977),
     ("a4f9c3a2a34131b5", 150, [19929.0, 20000.0, 71.0, 0.0, 2.9808390140533447,
                                -4024.8828125, 0.0, 0.0, 0.0, 200.0],
      [19999.0, 20000.0, 1.0, 0.0, 2.980727434158325, -4110.03125, 0.0, 0.0, 0.0, 200.0])),
    ("scatter telemetry sentinel", "scatter", "full", 20_000, "push-sum",
     dict(telemetry=True, byzantine_schedule="20:200", byzantine_mode="mass_inflate",
          mass_tolerance=10.0, max_rounds=300),
     (21, 0, "unhealthy", 20, 0.0),
     ("61a6c6b5678255d4", 10, [0.0, 20000.0, 20000.0, 0.0, 0.0, 0.001953125, 0.0, 0.0, 0.0,
                               0.0],
      [0.0, 20000.0, 20000.0, 0.0, 0.0, 96.26953125, 0.0, 0.0, 0.0, 200.0])),
    # The sentinel under global termination: the trip leaves conv 0 (no
    # round was stable), with and without rows.
    ("scatter sentinel global", "scatter", "full", 20_000, "push-sum",
     dict(termination="global", byzantine_schedule="20:200", byzantine_mode="mass_inflate",
          mass_tolerance=10.0, max_rounds=300),
     (21, 0, "unhealthy", 20, 0.0), None),
    ("scatter telemetry sentinel global", "scatter", "full", 20_000, "push-sum",
     dict(telemetry=True, termination="global", byzantine_schedule="20:200",
          byzantine_mode="mass_inflate", mass_tolerance=10.0, max_rounds=300),
     (21, 0, "unhealthy", 20, 0.0),
     ("61a6c6b5678255d4", 10, [0.0, 20000.0, 20000.0, 0.0, 0.0, 0.001953125, 0.0, 0.0, 0.0,
                               0.0],
      [0.0, 20000.0, 20000.0, 0.0, 0.0, 96.26953125, 0.0, 0.0, 0.0, 200.0])),
    ("scatter telemetry churn", "scatter", "full", 20_000, "push-sum",
     dict(telemetry=True, max_rounds=400, **tele_knobs(20_000, "push-sum", True)),
     (143, 18335, "converged", None, 343.05554211702804),
     ("432a3189a413445e", 71, [2.0, 19300.0, 18333.0, 0.0, 343.0576171875,
                               -2238.421875, 1838.0, 0.0, 0.0, 0.0],
      [18335.0, 19300.0, 0.0, 0.0, 343.0555419921875, -2238.421875, 1880.0, 0.0, 0.0,
       0.0])),
    ("scatter gossip telemetry churn", "scatter", "full", 20_000, "gossip",
     dict(telemetry=True, **tele_knobs(20_000, "gossip", True)),
     (35, 18411, "converged", None, None),
     ("a039f9d2601e02b3", 17, [8.0, 19900.0, 18897.0, 18299.0, 0.0, 0.0, 1993.0, 0.0, 0.0,
                               0.0],
      [18411.0, 19300.0, -71.0, 19885.0, 0.0, 0.0, 1909.0, 0.0, 0.0, 0.0])),
    ("pool telemetry churn", "pool", "full", 20_000, "push-sum",
     dict(delivery="pool", pool_size=POOL, telemetry=True, max_rounds=400,
          **tele_knobs(20_000, "push-sum", True)),
     (130, 18386, "converged", None, 341.45208583201594),
     ("ddaa3de467dc1b3f", 65, [0.0, 19300.0, 18335.0, 0.0, 0.0, -2256.05078125, 1963.0,
                               0.0, 0.0, 0.0],
      [18386.0, 19300.0, -51.0, 0.0, 341.45208740234375, -2256.05078125, 1931.0, 0.0,
       0.0, 0.0])),
    ("pool gossip telemetry churn", "pool", "full", 20_000, "gossip",
     dict(delivery="pool", pool_size=POOL, telemetry=True, byzantine_rate=0.01,
          byzantine_mode="stale_rumor", max_rounds=300,
          crash_schedule="5:200,20:1000", revive_schedule="12:100,30:400", quorum=0.95),
     (23, 19152, "converged", None, None),
     ("7f38e23cbb0d9605", 11, [39.0, 19800.0, 18771.0, 19764.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                               202.0],
      [19152.0, 18900.0, -335.0, 19919.0, 0.0, 0.0, 0.0, 0.0, 0.0, 202.0])),
    ("stencil telemetry churn", "stencil", "grid2d", 10_000, "push-sum",
     dict(telemetry=True, max_rounds=400, **tele_knobs(10_000, "push-sum", True)),
     (400, 83, "max_rounds", None, 2785.1668141789983),
     ("3ee2610b9dde3b0a", 200, [38.0, 9650.0, 9130.0, 0.0, 2916.45849609375,
                                -948.2939453125, 936.0, 0.0, 0.0, 0.0],
      [83.0, 9650.0, 9085.0, 0.0, 2785.166748046875, -948.2939453125, 932.0, 0.0, 0.0,
       0.0])),
    ("stencil gossip telemetry churn", "stencil", "grid2d", 10_000, "gossip",
     dict(telemetry=True, **tele_knobs(10_000, "gossip", True)),
     (303, 9171, "converged", None, None),
     ("fc67a9a7b82f56b6", 151, [2649.0, 9650.0, 6519.0, 3056.0, 0.0, 0.0, 1021.0, 0.0,
                                0.0, 0.0],
      [9171.0, 9650.0, -3.0, 9349.0, 0.0, 0.0, 968.0, 0.0, 0.0, 0.0])),
    ("scatter telemetry global", "scatter", "full", 20_000, "push-sum",
     dict(telemetry=True, termination="global", fault_rate=0.1),
     (57, 20000, "converged", None, 0.0005834082072269666),
     ("0aed7710b781d709", 28, [0.0, 20000.0, 20000.0, 0.0, 0.0, 0.0, 2081.0, 0.0, 0.0, 0.0],
      [20000.0, 20000.0, 0.0, 0.0, 0.0005366210825741291, 0.0, 1992.0, 0.0, 0.0, 0.0])),
    ("pool telemetry global", "pool", "full", 20_000, "push-sum",
     dict(delivery="pool", pool_size=POOL, telemetry=True, termination="global"),
     (47, 20000, "converged", None, 0.0006363675183401938),
     ("bdf98aeb9d35c55e", 23, [0.0, 20000.0, 20000.0, 0.0, 0.0, 0.001953125, 0.0, 0.0, 0.0,
                               0.0],
      [20000.0, 20000.0, 0.0, 0.0, 0.0005956054665148258, 0.001953125, 0.0, 0.0, 0.0,
       0.0])),
)
# The CLI with --trace-convergence on the card against the JAX CLI's trace
# for the same arguments on the CPU: the file's digest (gossip: byte for
# byte), the digest of its records without estimate_mae, their count and
# the last record.
TELE_CLIS = (
    (["1000", "full", "gossip"], "cc5601f86bf6ae79", "15e78e0a1531f8d6", 36,
     {"rounds": 36, "converged_count": 1000, "newly_converged": 1, "active_count": 1000}),
    (["1000", "full", "push-sum", "--delivery", "pool", "--pool-size", "2"], None,
     "a3c44c5d48d9f4d7", 285, {"rounds": 285, "converged_count": 1000, "newly_converged": 1,
                               "estimate_mae": 2.3284912458620965e-05}),
    (["900", "grid2d", "push-sum", "--crash-schedule", "3:100,6:50", "--revive-schedule",
      "10:60,20:40", "--quorum", "0.95"], None, "b8dc432be79c6c6f", 2730,
     {"rounds": 2730, "converged_count": 808, "newly_converged": 1,
      "estimate_mae": 296.0455017089844}),
)


def tele_row_close(label, got, want, n, total=None):
    """A card row against the JAX chunked engine's: counts equal, the
    estimate within 1e-4 relative, and the mass within the JAX package's
    fused-against-chunked atol of 1e-2 or 4 ulps of a float32 n, whichever
    is larger (0.25 at 1,000,000). The card's kernels add Σw in their own
    order and sum_f32 in another; on these runs' states the orders differ
    by at most 3 ulps of n (scripts/telemetry_mass_orders.py). Where Σw
    strays far from n (``total``: duplicate delivery creates mass), the
    ulps are Σw's."""
    import numpy as np

    for c in TELE_INTS:
        if got[c] != want[c]:
            raise AssertionError(f"{label}: column {c} {got[c]} != JAX {want[c]}")
    if abs(got[4] - want[4]) > 1e-4 * abs(want[4]) + 1e-7:
        raise AssertionError(f"{label}: estimate_mae {got[4]} != JAX {want[4]}")
    tol = max(1e-2, 4 * float(np.spacing(np.float32(n if total is None else total))))
    if abs(got[5] - want[5]) > tol:
        raise AssertionError(f"{label}: mass_residual {got[5]} != JAX {want[5]} (tol {tol})")


def tele_path(dev):
    """Phase 14p, the runs: each of TELE_RUNS on the card through run(), the
    counters zeroed just before it and read just after, against the JAX
    chunked engine's values baked above (rounds, converged count, outcome,
    unhealthy round, estimate, and the rows: every count column by digest,
    the middle and last rows' floats to tele_row_close's tolerances); then
    TELE_CLIS through the CLI. Returns {label: launches} of the first
    TELE_ROW_RUNS runs, the rows' own."""
    import hashlib
    import tempfile

    import numpy as np

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, scatter

    counters = {("pool", "push-sum"): fused_pool.pushsum_pool_chunk,
                ("pool", "gossip"): fused_pool.gossip_pool_chunk,
                ("scatter", "push-sum"): scatter.pushsum_scatter_chunk,
                ("scatter", "gossip"): scatter.gossip_scatter_chunk,
                ("stencil", "push-sum"): fused.pushsum_chunk,
                ("stencil", "gossip"): fused.gossip_chunk}
    launches = {}
    t0 = time.perf_counter()
    for i, (label, kernel, kind, n, algorithm, kw, want, tele) in enumerate(TELE_RUNS):
        for fn in counters.values():
            fn.launches = 0
        topo = build_topology(kind, n)
        res = run(topo, SimConfig(n=n, topology=kind, algorithm=algorithm, **kw))
        counts = {k: fn.launches for k, fn in counters.items()}
        got = (res.rounds, res.converged_count, res.outcome, res.unhealthy_round,
               res.estimate_mae)
        mae, want_mae = got[4], want[4]
        if got[:4] != want[:4] or (mae is None) != (want_mae is None) or (
                mae is not None and abs(mae - want_mae) > 1e-12 * max(1.0, abs(want_mae))):
            raise AssertionError(f"{label} ({kind} n={n:,}): {got} != JAX {want}")
        if counts[kernel, algorithm] == 0 or sum(counts.values()) != counts[kernel, algorithm]:
            raise AssertionError(f"{label}: launches {counts}, want {kernel} alone")
        if tele is not None:
            digest, mid_i, mid_row, last_row = tele
            data = res.telemetry.data
            if data.shape != (res.rounds, 10):
                raise AssertionError(f"{label}: rows {data.shape}, rounds {res.rounds}")
            ints = hashlib.sha256(data[:, list(TELE_INTS)].astype(np.int64).tobytes())
            if ints.hexdigest()[:16] != digest:
                raise AssertionError(f"{label}: the rows' count columns differ from JAX's")
            tele_row_close(f"{label} row {mid_i}", data[mid_i].tolist(), mid_row, topo.n)
            tele_row_close(f"{label} last row", data[-1].tolist(), last_row, topo.n)
        if i < TELE_ROW_RUNS:
            launches[label] = counts[kernel, algorithm]
            MAIN_ROUNDS[{r[1]: r[2] for r in TELE_ROWS}[label]] = res.rounds
            print(f"  {label} ({kind} n={n:,}): {res.outcome} at round {res.rounds}, "
                  f"{counts[kernel, algorithm]} launches", flush=True)
    print(f"  {len(TELE_RUNS)} runs through run() equal to the JAX chunked engine's rounds, "
          f"counts, outcome, unhealthy round, estimate and rows (each new row's main-path "
          f"run, clip and the sentinel on scatter delivery, the acceptance pair, telemetry "
          f"with clip, the sentinel, a gate with churn and global termination) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (argv, sha, ints, count, last) in enumerate(TELE_CLIS):
            path = f"{tmp}/trace{i}.jsonl"
            with contextlib.redirect_stdout(None):
                rc = cli.main(argv + ["--quiet", "--trace-convergence", path])
            if rc != 0:
                raise AssertionError(f"CLI {argv}: exit {rc}")
            raw = open(path, "rb").read()
            recs = [json.loads(line) for line in raw.decode().splitlines()]
            no_mae = [{k: v for k, v in r.items() if k != "estimate_mae"} for r in recs]
            if (len(recs), hashlib.sha256(json.dumps(no_mae).encode()).hexdigest()[:16]) != (
                    count, ints):
                raise AssertionError(f"CLI {argv}: the trace's records differ from JAX's")
            if sha is not None and hashlib.sha256(raw).hexdigest()[:16] != sha:
                raise AssertionError(f"CLI {argv}: the trace file is not the JAX CLI's")
            got_last = recs[-1]
            if "estimate_mae" in last and abs(got_last["estimate_mae"] - last["estimate_mae"]) > (
                    1e-4 * abs(last["estimate_mae"]) + 1e-7):
                raise AssertionError(f"CLI {argv}: last record {got_last} != JAX {last}")
    print(f"  {len(TELE_CLIS)} CLI runs with --trace-convergence: the records' counts equal "
          f"the JAX CLI's trace, the gossip file byte for byte ({time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    return launches


def tele_phase(dev, key):
    """Phase 14p: tele_checks, clip_sentinel_checks, then tele_path.
    Returns (cases, max_err, launches)."""
    cases, max_err = tele_checks(dev, key)
    cs_cases, cs_err = clip_sentinel_checks(dev, key)
    cases.update(cs_cases)
    max_err.update(cs_err)
    return cases, max_err, tele_path(dev)


# The kernels line's rows of phase 14p: (case, the main-path run whose
# launches the row reports, the row's name, the JAX site it replaces).
TELE_ROWS = (
    (("scatter", "full", "pushsum"), "scatter push-sum telemetry",
     "pushsum_scatter_chunk telemetry full", "ops/telemetry.py:117"),
    (("scatter", "full", "gossip"), "scatter gossip telemetry",
     "gossip_scatter_chunk telemetry full", "ops/telemetry.py:117"),
    (("pool", "full", "pushsum"), "pool push-sum telemetry",
     "pushsum_pool_chunk telemetry full", "ops/fused_pool.py:860"),
    (("pool", "full", "gossip"), "pool gossip telemetry",
     "gossip_pool_chunk telemetry full", "ops/fused_pool.py:1157"),
    (("stencil", "grid2d", "pushsum"), "stencil push-sum telemetry",
     "pushsum_chunk telemetry grid2d", "ops/fused.py:741"),
    (("stencil", "grid2d", "gossip"), "stencil gossip telemetry",
     "gossip_chunk telemetry grid2d", "ops/fused.py:993"),
    (("scatter", "imp2d", "pushsum"), "scatter imp2d push-sum telemetry",
     "pushsum_scatter_chunk telemetry imp2d", "ops/telemetry.py:117"),
    ("clip", "scatter clip", "pushsum_scatter_chunk clip full", "models/pushsum.py:134"),
    ("sentinel", "scatter sentinel", "pushsum_scatter_chunk sentinel full",
     "models/pipeline.py:72"),
)


def tele_rows(cases, launches, max_err):
    """Phase 14p's rows of the kernels line: each new instance over a
    CHUNK-round chunk from its round-TELE_MID state by CUDA events, beside
    the instance the run takes without it (telemetry off; clip: the faulted
    instance under the same Byzantine model; the sentinel, timed on an
    honest run's state so that it runs the whole chunk: the fault-free
    instance) and, for telemetry, the faulted instance with no fault (the
    instance the telemetry one extends), on the same state in the same
    call, and the plain version. The bound counts what revive_rows counts
    for the kernel, plus a telemetry chunk's partials written and read
    (rounds x blocks x 40 bytes) and its rows; the sentinel's partials are a
    few KB a round."""
    rows = []
    srcs = {"pool": "fused_pool.cu", "scatter": "scatter.cu", "stencil": "fused_resident.cu"}
    for case_key, run_label, row_name, site in TELE_ROWS:
        f = cases[case_key]
        instance = case_key if isinstance(case_key, str) else "telemetry"
        kernel = "scatter" if isinstance(case_key, str) else case_key[0]
        name = "pushsum" if isinstance(case_key, str) else case_key[2]
        tele = instance == "telemetry"
        if instance == "sentinel":
            f = f.timed
        mid, st, _ = f.chunk(f.kern, f.init, 0, TELE_MID, tele)
        ms, (_, st, _) = time_ms(lambda: f.chunk(f.kern, mid, TELE_MID, CHUNK, tele),
                                 TIME_REPS)
        if instance == "clip":
            off = lambda: f.base.chunk(f.base.kern, mid, TELE_MID, CHUNK, False)  # noqa: E731
        elif instance == "sentinel":
            off = lambda: f.chunk(f.kern, mid, TELE_MID, CHUNK, False, None)  # noqa: E731
        else:
            off = lambda: f.chunk(f.kern, mid, TELE_MID, CHUNK, False)  # noqa: E731
        off_ms, _ = time_ms(off, TIME_REPS)
        faulted_ms = None
        if tele:
            faulted_ms, _ = time_ms(lambda: f.chunk(f.kern, mid, TELE_MID, CHUNK, False,
                                                    f.faults or empty_faults()), TIME_REPS)
        plain_ms, _ = time_ms(lambda: f.chunk(f.plain, mid, TELE_MID, CHUNK, tele), 1)
        rounds = max(tele_ran(st, TELE_MID), 1)
        algo = "push-sum" if name == "pushsum" else "gossip"
        n, n_pad = f.n, mid[0].numel()
        grid = f.grid(tele)
        extra = (rounds * grid * 40 * 2 + CHUNK * 40) if tele else 0
        if kernel == "pool":
            state_bytes = 16 if name == "pushsum" else 12
            moved = 2 * state_bytes * n_pad + 4 * n_pad + CHUNK * (16 + 4 * POOL + 4)
            ops = rounds * (n_pad // 8 * OPS_PER_WORD + n_pad * ops_per_node(algo, POOL))
        elif kernel == "scatter":
            moved = rounds * n * (2 * SCATTER_STATE_BYTES[name] + 4)
            ops = rounds * n * SCATTER_OPS[name]
        else:
            moved = STATE_BYTES[name] * n_pad + 4 * n_pad + CHUNK * 16
            ops = rounds * n_pad * stencil_ops_per_node(algo, 4)
        moved += extra
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        versus = "" if faulted_ms is None else (
            f", {faulted_ms:.4f} in the faulted instance without telemetry "
            f"({ms / faulted_ms:.3f}x)")
        print(f"  {row_name} (n={n:,}): {ms:.4f} ms a {rounds}-round chunk against "
              f"{off_ms:.4f} without it on the same state ({ms / off_ms:.3f}x){versus}, "
              f"plain {plain_ms:.1f} ms, grid {grid}", flush=True)
        err_key = (f"{name} {kernel} {case_key[1]}" if tele else instance)
        rows.append({"name": row_name, "route": "cuda",
                     "source": f"cop5615_gossip_protocol_tpu_torch/csrc/{srcs[kernel]}",
                     "replaces": f"cop5615_gossip_protocol_tpu/{site}",
                     "launches": launches[run_label],
                     "max_abs_err": max_err[err_key],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "off_ms": off_ms, "on_over_off": ms / off_ms,
                     "faulted_off_ms": faulted_ms,
                     "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
                     "grid": grid, "config": instance, "status": "ported"})
    return rows


# ----------------------------------------------------------------- 14q
# delivery="matmul" (A7b): on full it runs the pool tiers, whose kernels
# compute its function (rows 1-4 and, with n_devices > 1, rows 20-21), so a
# matmul run must be bitwise its pool run. Its rounds at 1,000,000 and
# pool_size 2 are the JAX chunked engine's (its matmul tier is bitwise its
# pool tier there: a receiver gets at most two sends), baked from the CPU:
# (rounds, converged count, estimate_mae).
MATMUL_JAX = {"push-sum": (545, 1000000, 0.024193345390492643),
              "gossip": (48, 1000000, None)}
MATMUL_BIG = 2**21 + 1  # past the pool tier's cap: rows 3-4, and rows 20-21 x2
MATMUL_BIG_ROUNDS = 24
# The chunked engine's matmul round on imp2d 100,489 push-sum, pool_size 4,
# to convergence: the port's order is explicit, so the card's run is
# bitwise the port's CPU run, baked here (rounds, converged count,
# estimate_mae, a digest of the final planes). JAX's pool run of the same
# config ends at JAX_IMP_POOL_ROUNDS; JAX's matmul run follows its host's
# thread count (ROADMAP C) and is not pinned.
MATMUL_IMP = (467, 100489, 0.00277182584593402, "66b7aedc3c4c5dda")
JAX_IMP_POOL_ROUNDS = 532

# Kernel A's dup and delay instances: dup_rate 0.05 and a ring of depth 3,
# each chunk from the instance's own round-DD_MID state across a
# CHUNK-round stretch (the ring wraps ten times), against the plain version.
DD_KW = {"dup_rate": 0.05, "delay_rounds": 3}
DD_MID = 16
DD_KINDS = (("full", N), ("imp2d", 100_489))


def dd_churn(n, algorithm):
    """A drop gate with a crash and revive schedule (push-sum rejoining
    fresh), as phase 14p's churn."""
    return tele_knobs(n, algorithm, True)


def dd_configs(n, algorithm):
    """Phase 14q's chunk checks at population n: (label, knobs, telemetry)."""
    byz = {"byzantine_schedule": f"4:{n // 100}",
           "byzantine_mode": "mass_deflate" if algorithm == "push-sum" else "stale_rumor"}
    out = [("dup", {"dup_rate": 0.05}, False), ("delay", {"delay_rounds": 3}, False),
           ("dup delay", DD_KW, False), ("dup delay telemetry", DD_KW, True),
           ("dup delay churn telemetry", dict(DD_KW, **dd_churn(n, algorithm)), True),
           ("dup delay byzantine", dict(DD_KW, **byz), False)]
    if algorithm == "push-sum":
        clip = {"byzantine_schedule": f"4:{n // 100}", "byzantine_mode": "mass_inflate",
                "robust_agg": "clip"}
        # The sentinel (which excludes the dup gate) under the ring, tripping
        # at round 20 inside the chunk, as phase 14p's does.
        sentinel = {"byzantine_schedule": f"20:{n // 100}", "byzantine_mode": "mass_inflate",
                    "mass_tolerance": 100.0, "delay_rounds": 3}
        out += [("dup clip", dict(clip, dup_rate=0.05), False),
                ("dup delay clip telemetry", dict(DD_KW, **clip), True),
                ("dup global telemetry", {"dup_rate": 0.05, "termination": "global"}, True),
                ("delay sentinel", sentinel, False),
                ("delay sentinel telemetry", sentinel, True)]
    return out


def dd_fns(dev, key, kind, n, algorithm, kw, tele):
    """One phase 14q config of kernel A: a namespace of the wrapper, the
    plain version, chunk(fn, carry, start, count, fx=the config's Faults) ->
    (carry, status, rows or None), the initial carry (with its ring of
    zeros under delay), the grid and the instance's flags. The plain
    version sums the rows' floats in the kernel's order on that grid."""
    import types

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
    from cop5615_gossip_protocol_tpu_torch.models import pipeline
    from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import fused, scatter, telemetry

    pushsum = algorithm == "push-sum"
    topo = build_topology(kind, n)
    n = topo.n
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, telemetry=tele, **kw)
    graph = scatter.scatter_graph(topo, dev)
    faults = fused.run_faults(cfg, n)
    flags = scatter.instance_flags(faults, tele, pushsum)
    grid = scatter.telemetry_grid(pushsum, True, flags, n, dev.index) if tele else None
    order = ((telemetry.slice_order if pushsum else telemetry.strided_order)(grid, n).to(dev)
             if tele else None)
    if pushsum:
        st0 = pushsum_mod.init_state(n, cfg.initial_term_round, dev)
        kern, plain = scatter.pushsum_scatter_chunk, scatter.pushsum_scatter_chunk_plain
        extra = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        ring0 = torch.zeros(cfg.delay_rounds, 2, n, device=dev)
    else:
        st0 = gossip_mod.init_state(n, draw_leader(key, topo, cfg), False, dev)
        kern, plain = scatter.gossip_scatter_chunk, scatter.gossip_scatter_chunk_plain
        extra = {"rumor_target": cfg.resolved_rumor_target, "suppress": cfg.resolved_suppress}
        ring0 = torch.zeros(cfg.delay_rounds, n, dtype=torch.int32, device=dev)
    init = pipeline.Ringed(st0, ring0) if cfg.delay_rounds else st0
    rows_kern = telemetry.make_row_fn(topo, cfg, key, dev) if tele else None
    rows_plain = (telemetry.make_row_fn(topo, cfg, key, dev, fsum=functools.partial(
        telemetry.kernel_sum, order=order)) if tele else None)
    keys = functools.lru_cache(maxsize=None)(
        lambda start, count: fused.round_keys(key, start, count))

    health = [NEVER] if cfg.mass_tolerance is not None else []

    def chunk(fn, carry, start, count, fx=faults):
        status = torch.tensor([start, 0, *health], dtype=torch.int32, device=dev)
        if fn is plain:
            out = fn(carry, keys(start, count), status, graph=graph, target=n, start=start,
                     faults=fx, telemetry=rows_plain,
                     **({"order": order} if pushsum and tele else {}), **extra)
        else:
            out = fn(carry, key, start, count, status, graph=graph, target=n, faults=fx,
                     telemetry=rows_kern, **extra)
        return out[0], out[1], out[2] if tele else None

    return types.SimpleNamespace(kern=kern, plain=plain, chunk=chunk, init=init, n=n,
                                 faults=faults, flags=flags, grid=grid, graph=graph)


def dd_compare(tag, got, want):
    """Two chunks' carries (planes and ring), status and rows, bitwise;
    returns the largest absolute difference (0.0)."""
    from cop5615_gossip_protocol_tpu_torch.models import pipeline

    err = same_planes(tag, pipeline.proto_of(got[0]), pipeline.proto_of(want[0]))
    rings = [c.ring for c in (got[0], want[0]) if isinstance(c, pipeline.Ringed)]
    if len(rings) == 1:
        raise AssertionError(f"{tag}: one side carries a ring")
    if rings:
        same_planes(f"{tag}: ring", [rings[0]], [rings[1]])
    same_planes(f"{tag}: status", [got[1]], [want[1]])
    if got[2] is not None:
        same_planes(f"{tag}: rows", [got[2]], [want[2]])
    return err


def dd_checks(dev, key):
    """Phase 14q, kernel A: every dd_configs config at each of DD_KINDS, both
    algorithms: the wrapper's own round-DD_MID carry, then a CHUNK-round
    chunk of the kernel against the plain version on it, every plane, the
    ring, the status and the rows bitwise. Returns ({(algorithm, kind,
    label): (fns, mid carry)}, {the same: max_err})."""
    cases, max_err = {}, {}
    t0 = time.perf_counter()
    for kind, n in DD_KINDS:
        for algorithm in ("push-sum", "gossip"):
            for label, kw, tele in dd_configs(n, algorithm):
                f = dd_fns(dev, key, kind, n, algorithm, kw, tele)
                mid, st, _ = f.chunk(f.kern, f.init, 0, DD_MID)
                if int(st[1]) or int(st[0]) != DD_MID:
                    raise AssertionError(f"{algorithm} {kind} {label}: the run ended "
                                         f"before round {DD_MID} ({st.tolist()})")
                got = f.chunk(f.kern, mid, DD_MID, CHUNK)
                want = f.chunk(f.plain, mid, DD_MID, CHUNK)
                tag = f"{algorithm} {kind} {label}"
                max_err[algorithm, kind, label] = dd_compare(tag, got, want)
                cases[algorithm, kind, label] = (f, mid)
    print(f"  kernel A's dup and delay instances, {len(cases)} configs (full 1M and imp2d "
          f"100,489, both algorithms: dup, delay, both, with telemetry, a gate and churn, a "
          f"Byzantine model, clip, global termination, and the sentinel under the ring "
          f"tripping at round 20): a {CHUNK}-round chunk from round {DD_MID} bitwise the "
          f"plain version (planes, ring, status, rows) ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return cases, max_err


# Phase 14q's runs through run(): (label, kind, n, algorithm, knobs, and the
# JAX chunked engine's values on the CPU as TELE_RUNS bakes them). The
# first DD_ROW_RUNS are the kernels line's rows' main-path runs, one a row.
DD_ROW_RUNS = 10
DD_RUNS = (
    ("scatter push-sum dup", "full", N, "push-sum",
     dict(dup_rate=0.05, max_rounds=100),
     (100, 662161, "max_rounds", None, 21.345198576772525, "a9817a13535a688d"),
     None),
    ("scatter push-sum delay", "full", N, "push-sum",
     dict(delay_rounds=3, max_rounds=100),
     (100, 2, "max_rounds", None, 1.6822862998815253, "67c3493c4add0247"),
     None),
    ("scatter push-sum dup delay", "full", N, "push-sum",
     dict(DD_KW, max_rounds=100),
     (100, 0, "max_rounds", None, 0.0, "27548cc3d333fca6"),
     None),
    ("scatter gossip dup", "full", N, "gossip",
     dict(dup_rate=0.05),
     (56, 1000000, "converged", None, None, "7ca8eb1f6a3852dd"),
     None),
    ("scatter gossip delay", "full", N, "gossip",
     dict(delay_rounds=3),
     (81, 1000000, "converged", None, None, "18e2a34e36ddd23b"),
     None),
    ("scatter gossip dup delay", "full", N, "gossip",
     dict(DD_KW),
     (81, 1000000, "converged", None, None, "17e9bf05b278a530"),
     None),
    ("scatter push-sum telemetry dup delay churn", "imp2d", 100_489, "push-sum",
     dict(DD_KW, telemetry=True, max_rounds=300, **dd_churn(100_489, "push-sum")),
     (300, 30, "max_rounds", None, 1182.1525394685405, "52d54cae066c343b"),
     ("9bd45158e38ad0fb", 150,
      [12.0, 96972.0, 92114.0, 0.0, 1303.3414306640625, 84223.65625, 9539.0, 4839.0, 0.0, 0.0],
      [30.0, 96972.0, 92096.0, 0.0, 1182.1527099609375, 350865.625, 9808.0, 4814.0, 0.0, 0.0])),
    ("scatter gossip telemetry dup delay churn", "imp2d", 100_489, "gossip",
     dict(DD_KW, telemetry=True, **dd_churn(100_489, "gossip")),
     (87, 93112, "converged", None, None, "489b2bd7e210a3f3"),
     ("d171deb64f84a063", 43,
      [194.0, 96972.0, 91930.0, 4049.0, 0.0, 0.0, 9904.0, 4950.0, 0.0, 0.0],
      [93112.0, 96972.0, -988.0, 96975.0, 0.0, 0.0, 9763.0, 4831.0, 0.0, 0.0])),
    ("scatter clip dup", "full", N, "push-sum",
     dict(dup_rate=0.05, byzantine_schedule="20:10000", byzantine_mode="mass_inflate",
          robust_agg="clip", max_rounds=100),
     (100, 670067, "max_rounds", None, 26.010026373205132, "576ee5a446e53232"),
     None),
    ("scatter delay sentinel", "full", N, "push-sum",
     dict(delay_rounds=3, byzantine_schedule="20:10000", byzantine_mode="mass_inflate",
          mass_tolerance=100.0, max_rounds=100),
     (21, 0, "unhealthy", 20, 0.0, "8c3a8bec6428897b"),
     None),
    ("scatter global dup", "full", 20_000, "push-sum",
     dict(dup_rate=0.05, termination="global"),
     (53, 20000, "converged", None, 1.4731923774287397, "88d907f5621ded1e"),
     None),
    ("scatter imp2d push-sum dup delay", "imp2d", 100_489, "push-sum",
     dict(DD_KW, max_rounds=300),
     (300, 79, "max_rounds", None, 17.30833528072078, "41ccf5158848d04f"),
     None),
    ("scatter imp2d gossip byzantine dup delay", "imp2d", 100_489, "gossip",
     dict(DD_KW, max_rounds=300, byzantine_rate=0.01,
          byzantine_mode="stale_rumor"),
     (300, 99523, "max_rounds", None, None, "ac2e550c01a4cb3c"),
     None),
)
# The CLI with --dup-rate and --delay-rounds on the card against the JAX
# chunked engine's (rounds, converged count, estimate_mae) for the same
# arguments.
DD_CLIS = ((["1000", "full", "gossip", "--dup-rate", "0.1", "--delay-rounds", "3"],
            (49, 1000, None, True)),
           (["1000", "full", "push-sum", "--dup-rate", "0.05", "--delay-rounds", "2",
             "--max-rounds", "400"], (400, 996, 1.176238475496141, False)))
# Stencil delivery with dup and delay (the chunked engine's torch rounds) on
# grid2d 10,000 push-sum, 300 rounds: bitwise the port's CPU run, baked
# (rounds, converged count, outcome, estimate_mae, the planes' digest).
DD_STENCIL = (300, 11, "max_rounds", 2435.434775220734, "7d8f6b757bdf9cea")


def state_digest(state):
    """The first 16 hex digits of the sha256 of a state's planes' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in state:
        x = x.cpu().contiguous()
        h.update(x.numpy().tobytes() if x.dtype == torch.bool
                 else x.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def matmul_path(dev):
    """Phase 14q, delivery="matmul": full 1M push-sum and gossip at
    pool_size 2 through run() (rows 1-2), bitwise the pool runs and at
    JAX's rounds; full 2,097,153 (rows 3-4) and its replicated-pool2
    composition over 2 shards on the card (rows 20-21), a few chunks
    bitwise the pool runs; imp2d 100,489 push-sum at pool_size 4 on the
    chunked engine to convergence, bitwise the port's CPU run. Counters
    zeroed before each run and read after it."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, fused_pool2
    from cop5615_gossip_protocol_tpu_torch.parallel import pool2_sharded

    counters = (fused_pool.pushsum_pool_chunk, fused_pool.gossip_pool_chunk,
                fused_pool2.pushsum_pool2_chunk, fused_pool2.gossip_pool2_chunk,
                pool2_sharded.pushsum_pool2_shard_round,
                pool2_sharded.gossip_pool2_shard_round)

    def both(kind, n, algorithm, devices=None, **kw):
        out = {}
        for delivery in ("pool", "matmul"):
            for fn in counters:
                fn.launches = 0
            cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery=delivery, **kw)
            res = run(build_topology(kind, n), cfg, devices=devices)
            out[delivery] = (res, {fn.__name__: fn.launches for fn in counters if fn.launches})
        (p, pl), (m, ml) = out["pool"], out["matmul"]
        tag = f"{algorithm} {kind} n={n:,} {kw}"
        if (m.rounds, m.converged_count, m.estimate_mae) != (
                p.rounds, p.converged_count, p.estimate_mae) or ml != pl or not ml:
            raise AssertionError(f"{tag}: matmul {m.rounds}/{m.estimate_mae} {ml} != pool "
                                 f"{p.rounds}/{p.estimate_mae} {pl}")
        same_planes(f"{tag}: matmul vs pool", m.state, p.state)
        return m, ml

    t0 = time.perf_counter()
    for algorithm in ("push-sum", "gossip"):
        topo = build_topology("full", N)
        cfg = SimConfig(n=N, algorithm=algorithm, delivery="matmul", pool_size=POOL)
        if fused_tier(topo, cfg) != ("pool", None):
            raise AssertionError(f"matmul 1M {algorithm}: tier {fused_tier(topo, cfg)}")
        res, launches = both("full", N, algorithm, pool_size=POOL)
        want = MATMUL_JAX[algorithm]
        got = (res.rounds, res.converged_count, res.estimate_mae)
        if got[:2] != want[:2] or (want[2] is not None and abs(got[2] - want[2]) > 1e-12):
            raise AssertionError(f"matmul 1M {algorithm}: {got} != JAX {want}")
        print(f"  full 1M {algorithm} --delivery matmul --pool-size 2: rows 1-2 ({launches}), "
              f"bitwise the pool run, {res.rounds} rounds as JAX's", flush=True)
    for algorithm in ("push-sum", "gossip"):
        cfg = SimConfig(n=MATMUL_BIG, algorithm=algorithm, delivery="matmul", pool_size=POOL)
        if fused_tier(build_topology("full", MATMUL_BIG), cfg) != ("pool2", None):
            raise AssertionError(f"matmul {MATMUL_BIG} {algorithm}: not rows 3-4")
        _, launches = both("full", MATMUL_BIG, algorithm, pool_size=POOL, chunk_rounds=8,
                           max_rounds=MATMUL_BIG_ROUNDS)
        _, shard = both("full", MATMUL_BIG, algorithm, devices=[str(dev)] * 2, pool_size=POOL,
                        chunk_rounds=8, max_rounds=MATMUL_BIG_ROUNDS, n_devices=2,
                        engine="fused")
        print(f"  full {MATMUL_BIG:,} {algorithm} matmul, {MATMUL_BIG_ROUNDS} rounds: rows "
              f"3-4 ({launches}) and the replicated-pool2 composition x2 on the card "
              f"({shard}), each bitwise its pool run", flush=True)
    cfg = SimConfig(n=100_489, topology="imp2d", algorithm="push-sum", delivery="matmul",
                    pool_size=4)
    res = run(build_topology("imp2d", 100_489), cfg)
    got = (res.rounds, res.converged_count, res.estimate_mae, state_digest(res.state))
    if got != MATMUL_IMP:
        raise AssertionError(f"imp2d 100,489 matmul on the card {got} != CPU {MATMUL_IMP}")
    print(f"  imp2d 100,489 push-sum --delivery matmul --pool-size 4 (the chunked engine): "
          f"{res.rounds} rounds, bitwise the port's CPU run (JAX's pool run: "
          f"{JAX_IMP_POOL_ROUNDS}; JAX's matmul run follows its host's threads); run_s "
          f"{res.run_s:.3f}, {res.run_s * 1e3 / res.rounds:.3f} ms a round "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"metric": "pushsum_matmul_round_ms_imp2d_n100489",
                      "rounds": res.rounds, "run_s": res.run_s,
                      "ms_per_round": res.run_s * 1e3 / res.rounds,
                      "dispatch_s": res.dispatch_s, "fetch_s": res.fetch_s}), flush=True)


def dd_path(dev):
    """Phase 14q, the runs: each of DD_RUNS on the card through run(), the
    counters zeroed just before it and read just after, against the JAX
    chunked engine's values baked above (rounds, converged count, outcome,
    unhealthy round, estimate, and the rows' count columns by digest, the
    middle and last rows to tele_row_close's tolerances); DD_CLIS through
    the CLI; the stencil run against the port's CPU run. Returns {label:
    launches} of the first DD_ROW_RUNS runs."""
    import hashlib

    import numpy as np

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, cli, run
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    counters = {"push-sum": scatter.pushsum_scatter_chunk,
                "gossip": scatter.gossip_scatter_chunk}
    launches = {}
    t0 = time.perf_counter()
    for i, (label, kind, n, algorithm, kw, want, tele) in enumerate(DD_RUNS):
        for fn in counters.values():
            fn.launches = 0
        topo = build_topology(kind, n)
        res = run(topo, SimConfig(n=n, topology=kind, algorithm=algorithm, **kw))
        got = (res.rounds, res.converged_count, res.outcome, res.unhealthy_round,
               res.estimate_mae, state_digest(res.state))
        mae, want_mae = got[4], want[4]
        if got[:4] != tuple(want[:4]) or got[5] != want[5] or (mae is None) != (
                want_mae is None) or (mae is not None and abs(mae - want_mae) > 1e-12 * max(
                    1.0, abs(want_mae))):
            raise AssertionError(f"{label} ({kind} n={n:,}): {got} != JAX {want}")
        own = counters[algorithm].launches
        if own == 0 or sum(fn.launches for fn in counters.values()) != own:
            raise AssertionError(f"{label}: kernel A's launches {own}")
        if tele is not None:
            digest, mid_i, mid_row, last_row = tele
            data = res.telemetry.data
            ints = hashlib.sha256(data[:, list(TELE_INTS)].astype(np.int64).tobytes())
            if ints.hexdigest()[:16] != digest:
                raise AssertionError(f"{label}: the rows' count columns differ from JAX's")
            for tag, row, want_row in ((f"row {mid_i}", data[mid_i], mid_row),
                                       ("last row", data[-1], last_row)):
                tele_row_close(f"{label} {tag}", row.tolist(), want_row, topo.n,
                               total=topo.n + abs(want_row[5]))
        if i < DD_ROW_RUNS:
            launches[label] = own
            MAIN_ROUNDS[{r[1]: r[2] for r in DD_ROWS}[label]] = res.rounds
        print(f"  {label} ({kind} n={n:,}): {res.outcome} at round {res.rounds}, {own} "
              f"launches", flush=True)
    for argv, want in DD_CLIS:
        rec = io.StringIO()
        with contextlib.redirect_stdout(rec):
            rc = cli.main(argv)
        out = json.loads(rec.getvalue().strip().splitlines()[-1])
        got = (out["rounds"], out["converged_count"], out["estimate_mae"])
        if rc != (0 if want[3] else 1) or got != tuple(want[:3]):
            raise AssertionError(f"CLI {argv}: exit {rc}, {got} != JAX {want}")
    res = run(build_topology("grid2d", 10_000),
              SimConfig(n=10_000, topology="grid2d", algorithm="push-sum", delivery="stencil",
                        max_rounds=300, **DD_KW))
    got = (res.rounds, res.converged_count, res.outcome, res.estimate_mae,
           state_digest(res.state))
    if got != DD_STENCIL:
        raise AssertionError(f"grid2d 10,000 stencil dup delay on the card {got} != CPU "
                             f"{DD_STENCIL}")
    print(f"  {len(DD_RUNS)} runs through run() equal to the JAX chunked engine's, "
          f"{len(DD_CLIS)} CLI runs with --dup-rate/--delay-rounds, and grid2d 10,000 "
          f"stencil push-sum with dup and delay bitwise the CPU run "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def dd_phase(dev, key):
    """Phase 14q: matmul_path, dd_checks, then dd_path. Returns (cases,
    max_err, launches)."""
    matmul_path(dev)
    cases, max_err = dd_checks(dev, key)
    return cases, max_err, dd_path(dev)


# The kernels line's rows of phase 14q: (case, the main-path run whose
# launches the row reports, the row's name).
DD_ROWS = (
    (("push-sum", "full", "dup"), "scatter push-sum dup", "pushsum_scatter_chunk dup full"),
    (("push-sum", "full", "delay"), "scatter push-sum delay",
     "pushsum_scatter_chunk delay full"),
    (("push-sum", "full", "dup delay"), "scatter push-sum dup delay",
     "pushsum_scatter_chunk dup delay full"),
    (("gossip", "full", "dup"), "scatter gossip dup", "gossip_scatter_chunk dup full"),
    (("gossip", "full", "delay"), "scatter gossip delay", "gossip_scatter_chunk delay full"),
    (("gossip", "full", "dup delay"), "scatter gossip dup delay",
     "gossip_scatter_chunk dup delay full"),
    (("push-sum", "imp2d", "dup delay churn telemetry"),
     "scatter push-sum telemetry dup delay churn",
     "pushsum_scatter_chunk dup delay telemetry imp2d"),
    (("gossip", "imp2d", "dup delay churn telemetry"),
     "scatter gossip telemetry dup delay churn",
     "gossip_scatter_chunk dup delay telemetry imp2d"),
    (("push-sum", "full", "dup clip"), "scatter clip dup", "pushsum_scatter_chunk dup clip full"),
    (("push-sum", "full", "delay sentinel"), "scatter delay sentinel",
     "pushsum_scatter_chunk delay sentinel full"),
)


def scatter_registers():
    """{(pushsum, faulted, flags): (registers, spill bytes)} of csrc/scatter.cu's
    round kernels, from its ptxas log."""
    import re

    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    out, entry = {}, None
    for line in kernels.library_path("scatter").with_suffix(".log").read_text().splitlines():
        m = re.search(r"(pushsum|gossip)_roundsILb(\d)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            entry = (m.group(1) == "pushsum", int(m.group(2)), int(m.group(3))) if m else None
        elif entry and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            out[entry] = [None, spill]
        elif entry and "registers" in line:
            out[entry][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def dd_rows(cases, launches, max_err):
    """Phase 14q's rows of the kernels line: each new instance over a
    CHUNK-round chunk from its round-DD_MID carry by CUDA events (median of
    TIME_REPS), beside the faulted instance it extends (the same config
    without the dup gate and the ring, on the same state in the same call)
    and the plain version, with the registers and spills of both
    instances. The faulted instance starts from the protocol state with
    push-sum's mass in flight (the ring's s and w) added to each node, so
    its Σw is the run's and the sentinel trips where the new instance's
    does; each side's µs a round are over the rounds it ran, and their
    ratio is ``on_over_base``. The bound is byz_rows' for kernel A plus the
    ring's words read and written each round (push-sum 16 bytes a node,
    gossip 8) and, under the dup gate, a hash a node."""
    from cop5615_gossip_protocol_tpu_torch.models import pipeline

    regs = scatter_registers()
    rows = []
    for case, run_label, row_name in DD_ROWS:
        algorithm, kind, label = case
        f, mid = cases[case]
        pushsum = algorithm == "push-sum"
        name = "pushsum" if pushsum else "gossip"
        ms, (_, st, _) = time_ms(lambda: f.chunk(f.kern, mid, DD_MID, CHUNK), TIME_REPS)
        base_fx = dataclasses.replace(f.faults, dup_thresh=None, delay=0, planes={})
        proto = pipeline.proto_of(mid)
        if pushsum and isinstance(mid, pipeline.Ringed):
            proto = proto._replace(s=proto.s + mid.ring[:, 0].sum(0),
                                   w=proto.w + mid.ring[:, 1].sum(0))
        base_ms, (_, base_st, _) = time_ms(
            lambda: f.chunk(f.kern, proto, DD_MID, CHUNK, base_fx), TIME_REPS)
        plain_ms, _ = time_ms(lambda: f.chunk(f.plain, mid, DD_MID, CHUNK), 1)
        rounds = max(int(st[0]) - DD_MID, 1)
        base_rounds = max(int(base_st[0]) - DD_MID, 1)
        per_round = (ms / rounds) / (base_ms / base_rounds)
        n = f.n
        ring = 0 if not f.flags & 16 else (16 if pushsum else 8)
        moved = rounds * n * (2 * SCATTER_STATE_BYTES[name] + 4 + ring)
        ops = rounds * n * (SCATTER_OPS[name] + (OPS_PER_HASH if f.flags & 8 else 0))
        bytes_ms, ops_ms = moved / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        mine = regs.get((pushsum, 1, f.flags), [None, None])
        base = regs.get((pushsum, 1, f.flags & ~24), [None, None])
        if mine[1]:
            raise AssertionError(f"{row_name}: the instance spills {mine[1]} bytes")
        print(f"  {row_name} (n={n:,}): {ms:.4f} ms a {rounds}-round chunk "
              f"({ms * 1e3 / rounds:.1f} us a round, {mine[0]} registers, spill {mine[1]}) "
              f"against the faulted instance it extends {base_ms:.4f} ms a "
              f"{base_rounds}-round chunk ({base_ms * 1e3 / base_rounds:.1f} us a round, "
              f"{base[0]} registers) on the same state ({per_round:.3f}x a round), "
              f"plain {plain_ms:.1f} ms", flush=True)
        rows.append({"name": row_name, "route": "cuda",
                     "source": "cop5615_gossip_protocol_tpu_torch/csrc/scatter.cu",
                     "replaces": "cop5615_gossip_protocol_tpu/ops/delivery.py:22",
                     "launches": launches[run_label],
                     "max_abs_err": max_err[case],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "faulted_base_ms": base_ms,
                     "faulted_base_rounds": base_rounds,
                     "on_over_base": per_round, "registers": mine[0],
                     "spill_bytes": mine[1], "base_registers": base[0],
                     "rounds_per_call": rounds, "us_per_round": ms * 1e3 / rounds,
                     "config": label, "status": "ported"})
    return rows


# ----------------------------------------------------------------- 14r
# Checkpoint and resume, the event log, the metrics registry, step timing
# and the stall watchdog (A8) on the card. The CLI runs of rows 1-2 at
# 1,000,000 full with pool_size 2 end at JAX's rounds (MATMUL_JAX: the
# matmul runs there are bitwise the pool runs). Gossip ends at round 48, so
# its runs take 16-round chunks: with 64 there would be one generation and
# nothing older to fall back to.
PERSIST_CLI = (("push-sum", 64), ("gossip", 16))
# Kernel A at 1,000,000 full push-sum with a crash and a revival schedule;
# the revival round is a chunk boundary, where the run is resumed.
PERSIST_A = {"crash_schedule": "10:50000", "revive_schedule": "128:20000",
             "quorum": 0.9, "chunk_rounds": 64}
PERSIST_A_AT = 128
PERSIST_ROW3_N = 2**22 + 1  # rows 3-4: past the pool tier's cap
PERSIST_ROW3_AT = 64
# The JAX chunked engine's stalled runs on the CPU at 1,000,000 full gossip,
# pool_size 2, fault_rate 0.9999, stall_chunks 2, chunk_rounds 64: (rounds,
# converged count), without and with a crash of 200,000 nodes at round 100
# (the fall of the quorum need at the boundary after it is progress):
#   run(build_topology("full", 10**6), SimConfig(n=10**6, algorithm="gossip",
#       engine="chunked", delivery="pool", pool_size=2, fault_rate=0.9999,
#       stall_chunks=2, chunk_rounds=64[, crash_schedule="100:200000", quorum=0.9]))
STALL_JAX = {"": (192, 0), "100:200000": (256, 0)}
CROSS_N = 20_000  # the card-to-CPU and CPU-to-card resumes
CROSS_AT = 64


def array_digests(state):
    """The SHA-256 of each plane's bytes by field name, as a checkpoint's
    sidecar records them (array_sha256)."""
    import hashlib

    return {f: hashlib.sha256(getattr(state, f).cpu().numpy().tobytes()).hexdigest()
            for f in state._fields}


def cli_record(argv):
    """The port's CLI on ``argv`` in this process: (exit code, its JSON
    record)."""
    from cop5615_gossip_protocol_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def persist_cli(work, algorithm, chunk):
    """Phase 14r, rows 1-2: the run through run() with no hook, then the
    CLI with --checkpoint, --checkpoint-keep 3, --events, --metrics-dump and
    --step-timing at JAX's rounds, count and estimate with the same launches,
    its last generation's array digests those of the run; then the newest
    generation bit-flipped and --resume auto: quarantined, the run resumed
    from the generation before it, its last generation's digests the same.
    Returns (write_s of each checkpoint, run_s without and with hooks)."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
    from cop5615_gossip_protocol_tpu_torch.utils import checkpoint as ckpt
    from cop5615_gossip_protocol_tpu_torch.utils import obs
    from cop5615_gossip_protocol_tpu_torch.utils.events import read_events

    counter = {"push-sum": fused_pool.pushsum_pool_chunk,
               "gossip": fused_pool.gossip_pool_chunk}[algorithm]
    counter.launches = 0
    free = run(build_topology("full", N),
               SimConfig(n=N, algorithm=algorithm, delivery="pool", pool_size=POOL,
                         chunk_rounds=chunk))
    free_launches, counter.launches = counter.launches, 0
    want = MATMUL_JAX[algorithm]
    digests = array_digests(free.state)
    d = work / algorithm
    ck = d / "ck.npz"
    argv = [str(N), "full", algorithm, "--delivery", "pool", "--pool-size", str(POOL),
            "--chunk-rounds", str(chunk), "--checkpoint", str(ck), "--checkpoint-keep", "3",
            "--step-timing", "--metrics-dump", str(d / "metrics.prom")]
    # The registry is the process's: the dump holds earlier runs' bytes too.
    written_before = obs.metric_value(obs.parse_prometheus(obs.default_registry().render()),
                                      "gossip_tpu_checkpoint_bytes_written_total") or 0.0
    rc, rec = cli_record(argv + ["--events", str(d / "events.jsonl")])
    got = (rec["rounds"], rec["converged_count"], rec["estimate_mae"])
    if rc != 0 or got[:2] != want[:2] or (want[2] is not None
                                           and abs(got[2] - want[2]) > 1e-12):
        raise AssertionError(f"CLI {algorithm} with hooks: exit {rc}, {got} != JAX {want}")
    if counter.launches != free_launches or free_launches == 0:
        raise AssertionError(f"CLI {algorithm}: {counter.launches} launches, {free_launches} "
                             "without hooks")
    events = read_events(d / "events.jsonl")
    written = [e for e in events if e["event"] == "checkpoint-written"]
    retired = [e["rounds"] for e in events if e["event"] == "chunk-retired"]
    if [e["rounds"] for e in written] != retired or retired[-1] != want[0]:
        raise AssertionError(f"{algorithm}: checkpoints at {[e['rounds'] for e in written]}, "
                             f"chunks retired at {retired}")
    newest = ckpt.candidate_paths(ck)[0]
    side = json.loads(newest.with_name(newest.name + ".json").read_text())
    if side["array_sha256"] != digests or side["rounds"] != want[0]:
        raise AssertionError(f"{algorithm}: the last checkpoint is not the run's state")
    prom = obs.parse_prometheus((d / "metrics.prom").read_text())
    if obs.metric_value(prom, "gossip_tpu_checkpoint_bytes_written_total") - written_before != sum(
            e["bytes"] for e in written) or rec["step_timing"]["dispatches"] != len(retired):
        raise AssertionError(f"{algorithm}: the metrics dump or step timing disagree")
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0x40
    newest.write_bytes(bytes(data))
    counter.launches = 0
    rc, again = cli_record(argv + ["--resume", "auto", "--events", str(d / "resume.jsonl")])
    events = read_events(d / "resume.jsonl")
    names = [e["event"] for e in events]
    if rc != 0 or names[:3] != ["run-start", "checkpoint-corrupt-quarantined", "resume"] or (
            events[2]["rounds"] != retired[-2]) or counter.launches == 0:
        raise AssertionError(f"{algorithm} --resume auto: exit {rc}, {names[:3]}")
    newest = ckpt.candidate_paths(ck)[0]
    side = json.loads(newest.with_name(newest.name + ".json").read_text())
    if (again["rounds"], again["converged_count"]) != want[:2] or side[
            "array_sha256"] != digests:
        raise AssertionError(f"{algorithm}: the resumed run is not the run")
    print(f"  full 1M {algorithm} (rows 1-2, {chunk}-round chunks): the CLI with --checkpoint "
          f"--checkpoint-keep 3 --events --metrics-dump --step-timing at JAX's {want[0]} "
          f"rounds, {free_launches} launches as without hooks, the last generation's digests "
          f"the run's; the newest bit-flipped, --resume auto quarantined it, resumed at round "
          f"{retired[-2]} and ended bitwise; write_s "
          f"{[round(e['write_s'], 4) for e in written]}, run_s {free.run_s:.4f} without "
          f"hooks, {rec['run_s']:.4f} with them", flush=True)
    return [e["write_s"] for e in written], free.run_s, rec["run_s"]


def resumed_bitwise(label, topo, cfg, at, work, counters, device=None):
    """A run through run() without hooks, the same run with a checkpoint
    hook saving its boundary ``at`` to disk, and a run resumed from that
    file: every plane of the two ends bitwise, the same rounds, the same
    kernels launched in each (the chunked engine takes JAX's fixed chunks
    under a hook, so its launch count differs from its growing chunks').
    Returns the run and the checkpoint's path."""
    from cop5615_gossip_protocol_tpu_torch import run
    from cop5615_gossip_protocol_tpu_torch.utils import checkpoint as ckpt

    def launched():
        out = {fn.__name__: fn.launches for fn in counters if fn.launches}
        for fn in counters:
            fn.launches = 0
        return out

    launched()
    free = run(topo, cfg, device=device)
    path = work / f"{label.replace(' ', '_')}.npz"

    def hook(rounds, state):
        if rounds == at:
            ckpt.save(path, state, rounds, cfg)

    free_launches = launched()
    hooked = run(topo, cfg, device=device, on_chunk=hook)
    hooked_launches = launched()
    state, start, _ = ckpt.load(path)
    again = run(topo, cfg, device=device, start_state=state, start_round=start)
    again_launches = launched()
    if not free_launches or not set(free_launches) == set(hooked_launches) == set(
            again_launches):
        raise AssertionError(f"{label}: launches {free_launches}, {hooked_launches}, "
                             f"{again_launches}")
    for res in (hooked, again):
        if res.rounds != free.rounds or res.outcome != free.outcome:
            raise AssertionError(f"{label}: {res.rounds} {res.outcome} != {free.rounds} "
                                 f"{free.outcome}")
        same_planes(label, res.state, free.state)
    print(f"  {label}: resumed at round {at}, bitwise the run to its {free.outcome} at round "
          f"{free.rounds} (launches {free_launches} without hooks, {hooked_launches} with, "
          f"{again_launches} resumed)", flush=True)
    return free, path


def persist_phase(dev):
    """Phase 14r: persist_cli for rows 1-2; kernel A under a crash and a
    revival schedule resumed at the revival round; row 3 resumed mid-run;
    the stall watchdog through the CLI at JAX's rounds; a checkpoint of the
    card resumed on the CPU and one of the CPU resumed on the card."""
    import shutil

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.ops import fused_pool, fused_pool2, scatter
    from cop5615_gossip_protocol_tpu_torch.utils import checkpoint as ckpt

    work = Path(__file__).resolve().parent / "build" / "chip_smoke_14r"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        costs = {}
        for algorithm, chunk in PERSIST_CLI:
            costs[algorithm] = persist_cli(work, algorithm, chunk)
        resumed_bitwise(
            "kernel A full 1M push-sum, crash 10:50000 revive 128:20000",
            build_topology("full", N), SimConfig(n=N, algorithm="push-sum", **PERSIST_A),
            PERSIST_A_AT, work, (scatter.pushsum_scatter_chunk,))
        topo = build_topology("full", PERSIST_ROW3_N)
        resumed_bitwise(
            f"row 3 full {PERSIST_ROW3_N:,} push-sum", topo,
            SimConfig(n=PERSIST_ROW3_N, algorithm="push-sum", delivery="pool",
                      pool_size=POOL, chunk_rounds=32),
            PERSIST_ROW3_AT, work, (fused_pool2.pushsum_pool2_chunk,))
        for crash, want in STALL_JAX.items():
            extra = ["--crash-schedule", crash, "--quorum", "0.9"] if crash else []
            fused_pool.gossip_pool_chunk.launches = 0
            rc, rec = cli_record([str(N), "full", "gossip", "--delivery", "pool",
                                  "--pool-size", str(POOL), "--fault-rate", "0.9999",
                                  "--stall-chunks", "2", "--chunk-rounds", "64"] + extra)
            got = (rec["outcome"], rec["rounds"], rec["converged_count"])
            if rc != 1 or got != ("stalled", *want) or not fused_pool.gossip_pool_chunk.launches:
                raise AssertionError(f"--stall-chunks 2 {extra}: exit {rc}, {got} != JAX {want}")
        print(f"  --stall-chunks 2 (row 2, fault_rate 0.9999): stalled at JAX's rounds "
              f"{[w[0] for w in STALL_JAX.values()]}, without and with a crash", flush=True)
        # Across devices: rows 1 on the card and its plain version on the CPU.
        topo = build_topology("full", CROSS_N)
        cfg = SimConfig(n=CROSS_N, algorithm="push-sum", delivery="pool", pool_size=POOL,
                        chunk_rounds=64, engine="fused")
        card, path = resumed_bitwise(f"row 1 full {CROSS_N:,} push-sum on the card", topo,
                                     cfg, CROSS_AT, work, (fused_pool.pushsum_pool_chunk,))
        state, start, _ = ckpt.load(path)
        on_cpu = run(topo, cfg, device="cpu", start_state=state, start_round=start)
        snaps = {}
        run(topo, dataclasses.replace(cfg, max_rounds=2 * CROSS_AT), device="cpu",
            on_chunk=lambda r, s: snaps.setdefault(r, s))
        ckpt.save(work / "cpu.npz", snaps[2 * CROSS_AT], 2 * CROSS_AT, cfg)
        state, start, _ = ckpt.load(work / "cpu.npz")
        on_card = run(topo, cfg, start_state=state, start_round=start)
        for label, res in (("card to CPU", on_cpu), ("CPU to card", on_card)):
            if res.rounds != card.rounds:
                raise AssertionError(f"{label}: {res.rounds} rounds != {card.rounds}")
            same_planes(f"full {CROSS_N:,} resumed {label}", res.state, card.state)
        print(f"  full {CROSS_N:,} push-sum: the card's round-{CROSS_AT} checkpoint resumed "
              f"on the CPU and the CPU's round-{2 * CROSS_AT} one on the card, both bitwise the "
              f"card's run", flush=True)
        print(json.dumps({"metric": "checkpoint_cost_full_n1000000", **{
            algorithm: {"write_s": w, "run_s_without_hooks": a, "run_s_with_hooks": b}
            for algorithm, (w, a, b) in costs.items()}}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------- 14s
# The replica sweep and the lane server (ROADMAP A9a) on the card. The
# sweeps at 1,000,000 full run kernel A one lane at a time; the JAX
# package's run_replicas on the CPU, seed 0, gives each replica's rounds
# (every replica converged, so its converged count is n):
#   run_replicas(build_topology("full", 10**6), SimConfig(n=10**6,
#       algorithm=algorithm), 8)
SWEEP_N = 1_000_000
SWEEP_REPLICAS = 8
SWEEP_JAX = {"push-sum": [674, 651, 677, 745, 627, 731, 650, 754],
             "gossip": [56, 55, 53, 53, 52, 54, 54, 52]}
# grid2d 1,000,000 push-sum, 4 replicas to max_rounds 256 on stencil
# delivery (the chunked engine's torch rounds): (rounds, converged count) a
# replica, from the same JAX call with topology="grid2d", max_rounds=256.
SWEEP_GRID_REPLICAS = 4
SWEEP_GRID_MAX = 256
SWEEP_GRID_JAX = [(256, 2399), (256, 2462), (256, 2405), (256, 2500)]
# The lane server at full 65,536 push-sum, chunk_rounds 64, on 4 lanes: the
# ticket of seed 10 expires before the first boundary and is killed there;
# seeds 11-17 follow, each converging at the rounds the JAX package's
#   run_batched_keys(build_topology("full", 65536), SimConfig(n=65536,
#       algorithm="push-sum", chunk_rounds=64), [11, ..., 17])
# gives.
SERVE_N = 65_536
SERVE_LANES = 4
SERVE_CHUNK = 64
SERVE_DEAD = 10
SERVE_JAX = {11: 630, 12: 602, 13: 619, 14: 700, 15: 642, 16: 565, 17: 606}
# The same sweeps and lane server at populations the CPU runs in well under
# a minute: every lane on the card bitwise the port's CPU run.
SWEEP_SMALL = (("full", 10_000, "push-sum", SWEEP_REPLICAS, {}),
               ("full", 10_000, "gossip", SWEEP_REPLICAS, {}),
               ("grid2d", 10_000, "push-sum", SWEEP_GRID_REPLICAS,
                {"max_rounds": SWEEP_GRID_MAX}))
SERVE_SMALL_N = 2048


class _Tickets:
    """A lane source over a list of tickets: each poll hands out what the
    free lanes take, and the results are kept by tag."""

    def __init__(self, tickets):
        self.todo = list(tickets)
        self.results = {}

    def poll(self, k):
        out, self.todo = self.todo[:k], self.todo[k:]
        return out

    def on_result(self, ticket, res):
        self.results[ticket.tag] = res

    def on_boundary(self, active, lanes):
        return True


def serve_run(n, device=None):
    """serve_lanes at full ``n`` push-sum on SERVE_LANES lanes: the killed
    ticket, then SERVE_JAX's seeds. Returns (summary, {seed: LaneResult})."""
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import sweep

    tickets = [sweep.LaneTicket(key=SERVE_DEAD, tag=SERVE_DEAD,
                                deadline=time.monotonic() - 1.0)]
    tickets += [sweep.LaneTicket(key=s, tag=s) for s in SERVE_JAX]
    src = _Tickets(tickets)
    cfg = SimConfig(n=n, algorithm="push-sum", chunk_rounds=SERVE_CHUNK)
    summary = sweep.serve_lanes(build_topology("full", n), cfg, src, SERVE_LANES,
                                device=device)
    return summary, src.results


def cpu_sweep_runs():
    """The port's CPU sweeps of SWEEP_SMALL and lane server at
    SERVE_SMALL_N: {(kind, n, algorithm): (rounds, [[planes] a lane])} and
    {"serve": {seed: (rounds, outcome, [planes])}}. Runs in the worker."""
    import os

    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import sweep

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = {}
    for kind, n, algorithm, replicas, kw in SWEEP_SMALL:
        res = sweep.run_replicas(build_topology(kind, n),
                                 SimConfig(n=n, topology=kind, algorithm=algorithm, **kw),
                                 replicas, device="cpu")
        out[kind, n, algorithm] = (res.rounds, [[x.numpy() for x in st]
                                                for st in res.final_states])
    _, results = serve_run(SERVE_SMALL_N, "cpu")
    out["serve"] = {s: (r.rounds, r.outcome, [x.numpy() for x in r.state])
                    for s, r in results.items()}
    return out


def sweep_phase(dev, cpu_small):
    """Phase 14s: the 1M full push-sum and gossip sweeps through the CLI
    (--replicas 8, kernel A a lane at a time) at JAX's rounds, replica 0
    bitwise the one-shot run; the grid2d 1M push-sum sweep on the chunked
    engine's torch rounds at JAX's rounds and counts; the lane server at
    full 65,536 with churn and a killed ticket, each ticket bitwise its
    one-shot run; the same sweeps and lane server at CPU sizes bitwise the
    port's CPU runs. Returns {algorithm: kernel A's sweep numbers}."""
    import torch

    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
    from cop5615_gossip_protocol_tpu_torch.models import sweep
    from cop5615_gossip_protocol_tpu_torch.ops import scatter

    counts = {"chunks": 0, "lanes": 0, "warm": 0}
    real = {name: getattr(sweep.BatchEngine, name) for name in ("chunk", "_run_lane", "warm")}

    def counted(name, key):
        def fn(self, *args, **kw):
            counts[key] += 1
            return real[name](self, *args, **kw)
        return fn

    for name, key in (("chunk", "chunks"), ("_run_lane", "lanes"), ("warm", "warm")):
        setattr(sweep.BatchEngine, name, counted(name, key))
    kernels = {"push-sum": scatter.pushsum_scatter_chunk,
               "gossip": scatter.gossip_scatter_chunk}
    report = {}
    try:
        for algorithm, kern in kernels.items():
            topo = build_topology("full", SWEEP_N)
            cfg = SimConfig(n=SWEEP_N, algorithm=algorithm)
            # The main path: the CLI as a user types it.
            kern.launches = 0
            counts.update(chunks=0, lanes=0, warm=0)
            t0 = time.perf_counter()
            rc, rec = cli_record([str(SWEEP_N), "full", algorithm, "--replicas",
                                  str(SWEEP_REPLICAS)])
            cli_s = time.perf_counter() - t0
            launches, seen = kern.launches, dict(counts)
            if rc != 0 or rec["rounds"] != SWEEP_JAX[algorithm] or not rec["all_converged"]:
                raise AssertionError(f"full {SWEEP_N:,} {algorithm} --replicas "
                                     f"{SWEEP_REPLICAS}: exit {rc}, rounds {rec['rounds']} "
                                     f"!= JAX {SWEEP_JAX[algorithm]}")
            # One launch of kernel A a live lane a chunk (and the warm-up's).
            if not launches or launches != seen["lanes"] + seen["warm"]:
                raise AssertionError(f"{algorithm} sweep: {launches} launches of kernel A "
                                     f"for {seen['lanes']} lane chunks and "
                                     f"{seen['warm']} warm-ups")
            res = sweep.run_replicas(topo, cfg, SWEEP_REPLICAS)
            one = run(topo, cfg)
            if res.rounds != SWEEP_JAX[algorithm] or [
                    int(st.conv.sum()) for st in res.final_states] != [SWEEP_N] * SWEEP_REPLICAS:
                raise AssertionError(f"{algorithm} run_replicas: rounds {res.rounds}")
            if one.rounds != res.rounds[0]:
                raise AssertionError(f"{algorithm}: replica 0 ran {res.rounds[0]} rounds, "
                                     f"the one-shot run {one.rounds}")
            same_planes(f"{algorithm} replica 0 vs the one-shot run", res.final_states[0],
                        one.state)
            report[algorithm] = {
                "launches": launches, "chunks": seen["chunks"],
                "lane_chunks": seen["lanes"], "warm_launches": seen["warm"],
                "launches_per_chunk": seen["lanes"] / max(seen["chunks"], 1),
                "rounds": res.rounds, "sweep_run_s": res.run_s,
                "sweep_ms_per_replica": res.wall_ms / SWEEP_REPLICAS,
                "one_shot_run_s": one.run_s, "one_shot_rounds": one.rounds,
                "cli_s": cli_s,
                "estimate_mae_mean": res.estimate_mae_mean,
            }
            print(f"  full {SWEEP_N:,} {algorithm} --replicas {SWEEP_REPLICAS}: rounds "
                  f"{res.rounds} (JAX's), {res.wall_ms / SWEEP_REPLICAS:.2f} ms a replica "
                  f"against {one.run_s * 1e3:.2f} ms for the one-shot run; kernel A "
                  f"{launches} launches, {seen['lanes']} lane chunks in {seen['chunks']} "
                  f"chunk(s) (+{seen['warm']} warm-up)", flush=True)
            del res, one
            torch.cuda.empty_cache()
        # A lattice on the chunked engine's torch rounds.
        topo = build_topology("grid2d", SWEEP_N)
        cfg = SimConfig(n=SWEEP_N, topology="grid2d", algorithm="push-sum",
                        max_rounds=SWEEP_GRID_MAX)
        res = sweep.run_replicas(topo, cfg, SWEEP_GRID_REPLICAS)
        got = [(r, int(st.conv.sum())) for r, st in zip(res.rounds, res.final_states)]
        if got != SWEEP_GRID_JAX:
            raise AssertionError(f"grid2d {SWEEP_N:,} push-sum sweep: {got} != JAX "
                                 f"{SWEEP_GRID_JAX}")
        one = run(topo, cfg)
        same_planes("grid2d replica 0 vs the one-shot run", res.final_states[0], one.state)
        report["grid2d"] = {"rounds": res.rounds, "sweep_run_s": res.run_s,
                            "one_shot_run_s": one.run_s}
        print(f"  grid2d {SWEEP_N:,} push-sum, {SWEEP_GRID_REPLICAS} replicas to round "
              f"{SWEEP_GRID_MAX}: converged counts {[c for _, c in got]} (JAX's), "
              f"{res.wall_ms / SWEEP_GRID_REPLICAS:.1f} ms a replica against "
              f"{one.run_s * 1e3:.1f} ms for the one-shot run (fused)", flush=True)
        del res, one
        # The lane server under churn and a killed ticket.
        summary, results = serve_run(SERVE_N)
        topo = build_topology("full", SERVE_N)
        if (summary.served, summary.refills) != (len(SERVE_JAX) + 1,
                                                  len(SERVE_JAX) + 1 - SERVE_LANES):
            raise AssertionError(f"serve_lanes: {summary}")
        dead = results[SERVE_DEAD]
        if (dead.outcome, dead.rounds) != ("deadline_exceeded", SERVE_CHUNK):
            raise AssertionError(f"the killed ticket: {dead.outcome} at {dead.rounds}")
        want = run(topo, SimConfig(n=SERVE_N, algorithm="push-sum", seed=SERVE_DEAD,
                                   max_rounds=SERVE_CHUNK))
        same_planes("the killed ticket vs its one-shot run", dead.state, want.state)
        for s, rounds in SERVE_JAX.items():
            r = results[s]
            if (r.outcome, r.rounds) != ("converged", rounds):
                raise AssertionError(f"ticket {s}: {r.outcome} at {r.rounds} != JAX {rounds}")
            one = run(topo, SimConfig(n=SERVE_N, algorithm="push-sum", seed=s,
                                      chunk_rounds=SERVE_CHUNK))
            same_planes(f"ticket {s} vs its one-shot run", r.state, one.state)
        print(f"  serve_lanes full {SERVE_N:,} push-sum on {SERVE_LANES} lanes: "
              f"{summary.served} tickets, {summary.refills} refills, {summary.chunks} "
              f"chunks, the killed one at round {SERVE_CHUNK}; every ticket bitwise its "
              f"one-shot run, at JAX's rounds", flush=True)
        report["serve"] = {"served": summary.served, "refills": summary.refills,
                           "chunks": summary.chunks, "run_s": summary.run_s}
        # The small sweeps and lane server against the port's CPU runs.
        for kind, n, algorithm, replicas, kw in SWEEP_SMALL:
            res = sweep.run_replicas(build_topology(kind, n),
                                     SimConfig(n=n, topology=kind, algorithm=algorithm, **kw),
                                     replicas)
            rounds, planes = cpu_small[kind, n, algorithm]
            if res.rounds != rounds:
                raise AssertionError(f"{kind} {n:,} {algorithm} sweep: {res.rounds} "
                                     f"!= CPU {rounds}")
            for lane, (st, want) in enumerate(zip(res.final_states, planes)):
                same_planes(f"{kind} {n:,} {algorithm} lane {lane} vs the CPU", st, want)
        _, results = serve_run(SERVE_SMALL_N)
        for s, (rounds, outcome, planes) in cpu_small["serve"].items():
            r = results[s]
            if (r.rounds, r.outcome) != (rounds, outcome):
                raise AssertionError(f"serve {SERVE_SMALL_N:,} ticket {s}: "
                                     f"{(r.rounds, r.outcome)} != CPU {(rounds, outcome)}")
            same_planes(f"serve {SERVE_SMALL_N:,} ticket {s} vs the CPU", r.state, planes)
        print(f"  every lane of {[f'{k} {n:,} {a}' for k, n, a, _, _ in SWEEP_SMALL]} and "
              f"of serve_lanes at {SERVE_SMALL_N:,} bitwise the port's CPU runs",
              flush=True)
    finally:
        for name, fn in real.items():
            setattr(sweep.BatchEngine, name, fn)
    print(json.dumps({"metric": "replica_sweep_full_n1000000", **report}), flush=True)
    return report


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
            lattice_global_cards(cards)
        except (AssertionError, RuntimeError) as e:
            return fail(str(e))
        print(smi)
        print(json.dumps({"ok": True, "mode": f"cards {cards}", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # The port's CPU runs that phases 14g, 14j and 14k hold the card's runs
    # against, in a spawned worker while the card runs the phases before.
    import multiprocessing

    if "--phase" in sys.argv:
        which = sys.argv[sys.argv.index("--phase") + 1]
        if which != "14s":
            return fail(f"--phase {which}: only phase 14s runs alone")
        worker = multiprocessing.get_context("spawn").Pool(1)
        try:
            cpu_sweep = worker.apply_async(cpu_sweep_runs)
            t0 = time.perf_counter()
            sweep_phase(dev, cpu_sweep.get(timeout=900))
            print(f"phase 14s (sweep_phase): {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as e:
            return fail(str(e))
        finally:
            worker.terminate()
            worker.join()
        print(smi)
        print(json.dumps({"ok": True, "mode": "phase 14s", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    worker = multiprocessing.get_context("spawn").Pool(1)
    try:
        cpu_runs = (worker.apply_async(cpu_scatter_runs),
                    worker.apply_async(cpu_fault_runs),
                    worker.apply_async(cpu_fault2_runs),
                    worker.apply_async(cpu_revive_runs),
                    worker.apply_async(cpu_sweep_runs))
        return run_phases(torch, dev, smi, kernels, cpu_runs, t_main)
    finally:
        worker.terminate()
        worker.join()


def run_phases(torch, dev, smi, kernels, cpu_runs, t_main) -> int:
    """Phases 2-15 of the one-card run; ``cpu_runs`` are the worker's
    pending results for phases 14g, 14j, 14k, 14n and 14s."""
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
                # A spill in a persistent round kernel (rows 1-2, 5-8,
                # kernel A), in the walk (kernel B) or in a round, absorb or
                # sends kernel of rows 9-14 and 18-21 (both instances of
                # each) would add local-memory traffic to every round or
                # hop: a failure.
                persistent = (name in ("fused_pool", "fused_resident", "scatter")
                              and "rounds" in (entry or "")) or (
                                  name == "walk" and "walk_kernel" in (entry or "")) or (
                                  name in ("fused_stencil", "fused_imp",
                                           "fused_imp_hbm_shard", "fused_pool2_shard")
                                  and any(k in (entry or "")
                                          for k in ("round", "absorb", "sends")))
                if (persistent and "spill" in line
                        and "0 bytes spill stores, 0 bytes spill loads" not in line):
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

    print(f"phases 1-4: {time.perf_counter() - t_main:.1f} s", flush=True)

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
            cpu_done = cpu_runs[0].get(timeout=900)
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
    t15 = time.perf_counter()
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
    try:
        rows += scatter_rows(dev, key, scatter_cases, scatter_launches, scatter_err)
    except AssertionError as e:
        return fail(str(e))
    rows.append(walk_row(dev, key, walk_cases, walk_launches, walk_err))
    t14j = time.perf_counter()
    # Phase 14j runs after the rows above: with it before them,
    # torch.profiler handed scatter_rows' profiled gossip chunk an empty
    # trace (no kernel, copy or memset at all) on the H100.
    try:
        cpu_small = cpu_runs[1].get(timeout=900)
        fault_cases, fault_err, fault_launches = phase("14j", fault_phase, dev, key,
                                                       cpu_small)
    except Exception as e:
        return fail(str(e))
    t15 += time.perf_counter() - t14j  # phase 15's time leaves 14j's out
    # The faulted rows 1-2 and A beside the fault-free ones timed above.
    by_name = {row["name"]: row["ms"] for row in rows}
    rows += fault_rows(fault_cases, fault_launches, fault_err, {
        "pushsum_pool_chunk": by_name["pushsum_pool_chunk"],
        "gossip_pool_chunk": by_name["gossip_pool_chunk"],
        "pushsum_scatter_chunk": by_name["pushsum_scatter_round"],
        "gossip_scatter_chunk": by_name["gossip_scatter_round"]})
    t14k = time.perf_counter()
    try:
        cpu_small2 = cpu_runs[2].get(timeout=900)
        fault2_cases, fault2_err, fault2_launches = phase("14k", fault2_phase, dev, key,
                                                          cpu_small2)
    except Exception as e:
        return fail(str(e))
    t15 += time.perf_counter() - t14k  # and 14k's
    # The faulted rows 3-6 and row 7's global row beside the fault-free
    # ones timed above.
    rows += fault2_rows(fault2_cases, fault2_launches, fault2_err,
                        {row: by_name[row] for row, _, _ in FAULT2_TIMED})
    t14l = time.perf_counter()
    try:
        fault3_cases, fault3_err, fault3_launches = phase("14l", fault3_phase, dev, key)
    except (AssertionError, RuntimeError) as e:
        return fail(str(e))
    t15 += time.perf_counter() - t14l  # and 14l's
    # Rows 9, 11, 13 and 18 in their global instances and rows 20-21 in
    # their faulted ones beside the fault-free rows timed above.
    try:
        rows += fault3_rows(dev, key, fault3_cases, fault3_launches, fault3_err,
                            {row: by_name[row] for row in FAULT3_ROWS})
    except (AssertionError, RuntimeError) as e:
        return fail(str(e))
    t14m = time.perf_counter()
    try:
        shard_global_cases, shard_global_err, shard_global_launches = phase(
            "14m", shard_global_path, dev, key)
        cpu_revive = cpu_runs[3].get(timeout=900)
        revive_cases, revive_err, revive_launches = phase("14n", revive_phase, dev, key,
                                                          cpu_revive)
        byz_cases, byz_err, byz_launches = phase("14o", byz_phase, dev, key)
        tele_cases, tele_err, tele_launches = phase("14p", tele_phase, dev, key)
        dd_cases, dd_err, dd_launches = phase("14q", dd_phase, dev, key)
        phase("14r", persist_phase, dev)
        cpu_sweep = cpu_runs[4].get(timeout=900)
        sweep_report = phase("14s", sweep_phase, dev, cpu_sweep)
    except Exception as e:
        return fail(str(e))
    t15 += time.perf_counter() - t14m  # and 14m-14s's
    # Rows 15-16 in their global instances, and kernel A, rows 1-2 and rows
    # 5-6 in their revive instances, beside their other instances.
    try:
        rows += shard_global_rows(shard_global_cases, shard_global_launches,
                                  shard_global_err)
        rows += revive_rows(revive_cases, revive_launches, revive_err)
        rows += byz_rows(byz_cases, byz_launches, byz_err)
        rows += tele_rows(tele_cases, tele_launches, tele_err)
        rows += dd_rows(dd_cases, dd_launches, dd_err)
    except (AssertionError, RuntimeError) as e:
        return fail(str(e))
    for row in rows:
        row["main_path_rounds"] = MAIN_ROUNDS.get(row["name"])
        # Kernel A on phase 14s's path: the 1M sweeps, a launch a live lane
        # a chunk, counted from zero around each CLI run.
        algo = {"pushsum_scatter_round": "push-sum",
                "gossip_scatter_round": "gossip"}.get(row["name"])
        if algo is not None:
            row["sweep"] = {k: sweep_report[algo][k] for k in (
                "launches", "chunks", "lane_chunks", "launches_per_chunk",
                "sweep_ms_per_replica", "one_shot_run_s")}
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
    print(f"phase 15 (kernel rows): {time.perf_counter() - t15:.1f} s", flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t_main:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
