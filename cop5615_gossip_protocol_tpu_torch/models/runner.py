"""Round-loop harness.

``run`` drives one simulation to convergence (or ``cfg.max_rounds``) in
chunks of up to ``cfg.chunk_rounds`` rounds through the pipelined chunk
loop (models/pipeline.py), and returns a ``RunResult``. The engines are the
JAX runner's:

- the fused engines: the pool engine (ops/fused_pool.py) on ``full`` up to
  2**21 nodes and the streaming pool engine (ops/fused_pool2.py) past it,
  the three lattice tiers on the lattices (whole-array resident,
  ops/fused.py; tiled resident, ops/fused_stencil.py; streaming,
  ops/fused_stencil_hbm.py) and the imp engine (ops/fused_imp.py, both imp
  tiers) on imp2d/imp3d, each running its CUDA kernels on a CUDA device and
  their plain torch versions on the CPU;
- the chunked engine on [n] tensors, the JAX chunked engine's
  counterpart: scatter delivery (the default on ``full`` and imp2d/imp3d,
  ``delivery="scatter"`` anywhere) runs ops/scatter.py, its CUDA kernel on
  a CUDA device and its plain torch version on the CPU; pool, stencil,
  imp pool and matmul delivery run one torch round per step. Its chunks
  keep their (rounds, done) status on the device, so a chunk is queued
  with no host read and the pipeline reads the status once a chunk;
- reference-semantics push-sum: the single walk (models/reference.py,
  csrc/walk.cu on a CUDA device), before any ladder;
- with ``n_devices > 1``, the sharded composition the JAX ladder picks
  (``sharded_tier``): the replicated-pool2 one (parallel/pool2_sharded.py),
  the resident and streaming lattice ones (parallel/fused_sharded.py,
  parallel/fused_hbm_sharded.py) and the imp one
  (parallel/fused_imp_hbm_sharded.py) run, every other is refused naming
  its ROADMAP item.

The fused tier is picked by the JAX runner's ladder (``fused_tier``), so a
config lands on the tier the JAX package would give it, and every tier's
kernels are ported. ``engine="auto"`` runs the kernels on CUDA and
the chunked engine on the CPU, and never fuses scatter delivery;
``"fused"`` forces the fused engine (on the CPU, the plain versions) and
refuses scatter delivery; ``"chunked"`` forces the chunked engine. There
is no degradation ladder: a kernel that fails to build or launch raises.

The drop gate, crash-stop with quorum termination and push-sum's global
termination (``fault_rate``, ``crash_rate``/``crash_schedule`` with
``quorum``, ``termination``) run on the chunked engine under every delivery,
on the pool and streaming pool tiers, on the whole-array lattice tier and,
with n_devices > 1, on the replicated-pool2 composition; the tiled and
streaming lattice tiers, both imp tiers and the sharded imp and lattice
compositions take global termination, the only one their JAX tiers take.
Crash-recovery (``revive_rate``/``revive_schedule`` with ``rejoin``) runs
on the chunked engine under every delivery, on the pool tier and on the
whole-array lattice tier, as in JAX. Byzantine adversaries
(``byzantine_rate``/``byzantine_schedule`` with ``byzantine_mode``) run on
the chunked engine under every delivery, on the pool tier and on the
whole-array lattice tier; robust aggregation (``robust_agg``) and the health
sentinel (``mass_tolerance``) on the chunked engine alone (under scatter
delivery on the card, kernel A's clip and sentinel instances). Every
fused tier and composition carries each failure-model knob its JAX
counterpart takes; where the JAX ladder demotes, the port runs its chunked
engine, on the card too; where a sharded plan refuses, the run raises the
JAX ladder's ValueError.

``delivery="matmul"`` samples as pool delivery does and delivers to the
targets that sampling implies: on ``full`` it runs the pool tiers (rows
1-4; with n_devices > 1 and engine="fused" the replicated-pool2
composition, rows 20-21), whose kernels compute its function, and on the
imp kinds the chunked engine (ops/delivery.deliver_matmul, each receiver's
senders in ascending index). Duplicate delivery and the delay ring
(``dup_rate``, ``delay_rounds``) run on the chunked engine under scatter
and stencil delivery (kernel A's dup and delay instances under scatter
delivery on the card), as in JAX; every fused tier demotes them, and pool
and matmul delivery refuse them with the JAX runner's text.

The telemetry plane (``cfg.telemetry``, ops/telemetry.py) writes one row a
round on the chunked engine (torch ops after each round, or kernel A's
telemetry instance under scatter delivery on the card) and in the pool and
whole-array lattice kernels (rows 1-2 and 5-6); every other fused tier
demotes to the chunked engine under engine="auto" and raises under
engine="fused", and the sharded fused compositions refuse it, with the JAX
ladder's texts.

Chunk-boundary hooks (the JAX runner's): ``run(on_chunk=...)`` calls
``on_chunk(rounds, state)`` with the canonical state at every retired chunk
(the CLI's checkpoint writer), and ``cfg.stall_chunks`` ends a run whose
termination gap has not moved for that many chunks with outcome "stalled"
(``StallWatchdog``), on every engine. Under a hook, the watchdog,
``cfg.step_timing`` or ``fixed_chunks`` (the CLI's ``--events``) the chunked
engine queues chunks of ``cfg.chunk_rounds`` rounds from the start round,
the JAX chunked engine's boundaries; without them it keeps its growing
chunks (``_FIRST_CHUNK`` up to chunk_rounds).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig, unported
from ..ops import delivery as delivery_mod
from ..ops import faults as faults_mod
from ..ops import (
    fused,
    fused_imp,
    fused_imp_hbm,
    fused_pool,
    fused_pool2,
    fused_stencil,
    fused_stencil_hbm,
    rng,
    sampling,
    scatter,
)
from ..ops import telemetry as telemetry_mod
from ..ops.topology import IMP_LATTICE, Topology, imp_split
from ..utils.device import resolve_device
from ..utils.metrics import RUN_RECORD_SCHEMA_VERSION
from . import gossip as gossip_mod
from . import pipeline as pipeline_mod
from . import pushsum as pushsum_mod
from . import reference as reference_mod

# The chunked engine's first chunk, in rounds (at most chunk_rounds).
_FIRST_CHUNK = 8

# fold_in tag for the leader draw, above every round index (max_rounds <=
# 2**30), so it never collides with a round key.
_LEADER_TAG = 2**31 - 1


@dataclasses.dataclass
class RunResult:
    """Structured result of one run; the JAX RunResult's fields, plus the
    device the run went to."""

    algorithm: str
    topology: str
    semantics: str
    n_requested: int
    population: int
    target_count: int
    rounds: int
    converged_count: int
    converged: bool
    compile_s: float
    run_s: float
    build_s: float = 0.0
    outcome: str = "converged"
    unhealthy_round: Optional[int] = None
    degradations: Optional[list] = None
    true_mean: Optional[float] = None
    estimate_mae: Optional[float] = None
    schema_version: int = RUN_RECORD_SCHEMA_VERSION
    dispatch_s: float = 0.0
    fetch_s: float = 0.0
    first_dispatch_s: float = 0.0
    hook_s: float = 0.0
    aux_s: float = 0.0
    setup_s: float = 0.0
    finalize_s: float = 0.0
    device: str = ""
    # Data, not measurements: excluded from to_record. ``state`` is the
    # final canonical PushSumState/GossipState; ``telemetry`` the run's
    # ops/telemetry.TelemetryTrajectory when cfg.telemetry is on;
    # ``hook_failures`` the checkpoint writes the run survived under
    # hook_error="continue" ({"rounds", "error"}, in order), or None.
    chunk_log: Optional[list] = None
    state: Optional[object] = None
    telemetry: Optional[object] = None
    hook_failures: Optional[list] = None

    @property
    def wall_ms(self) -> float:
        """Steady-state run wall-clock in ms (excludes build and warmup)."""
        return self.run_s * 1e3

    def to_record(self) -> dict:
        rec = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("chunk_log", "state", "telemetry", "hook_failures")
        }
        rec["wall_ms"] = self.wall_ms
        rec["rounds_per_sec"] = self.rounds / self.run_s if self.run_s > 0 else None
        rec["residual_s"] = (
            self.run_s - self.dispatch_s - self.fetch_s - self.hook_s
        )
        return rec


class StallWatchdog:
    """The progress watchdog over chunk boundaries (cfg.stall_chunks, the
    JAX runner's): a run whose termination gap (``_progress_gap``) has not
    moved for ``stall_chunks`` retired chunks in a row ends with outcome
    "stalled". One instance a run; the engines ask it only when
    cfg.stall_chunks is set."""

    def __init__(self, stall_chunks: int):
        self.limit = int(stall_chunks)
        self.stalled = False
        self._last = None
        self._misses = 0

    def no_progress(self, metric: int) -> bool:
        """Record this chunk's gap; True once it has been flat for
        ``limit`` chunks in a row."""
        if not self.limit:
            return False
        if metric == self._last:
            self._misses += 1
            if self._misses >= self.limit:
                self.stalled = True
        else:
            self._last, self._misses = metric, 0
        return self.stalled


def _progress_gap(life, quorum: float, target: int, conv, rounds: int) -> int:
    """The watchdog's metric at a boundary: the distance left to the
    predicate done evaluates. Without a crash model, target minus the
    converged count; under one (``life``, faults.life_planes), the quorum
    need of the nodes alive in the last round run minus the converged
    among them, so a need that falls as nodes die counts as progress while
    the converged count stays flat. ``conv`` is a [n] bool array or tensor
    on the host."""
    conv_i = np.asarray(conv).astype(np.int32)
    if life is None:
        return int(target) - int(conv_i.sum())
    alive = faults_mod.alive_at(life.death, rounds - 1, life.revive)
    need = faults_mod.quorum_need(int(alive.sum()), quorum)
    return int(need) - int(conv_i[alive].sum())


def boundary_hooks(topo: Topology, cfg: SimConfig, target: int, on_chunk,
                   canonical) -> tuple:
    """The chunk loop's ``on_retire`` and ``should_stop`` for a run (each
    None when not asked for) and its watchdog: ``canonical(rounds, state)``
    turns the carry retired at ``rounds``, on the host, into the canonical
    [n] state."""
    watchdog = StallWatchdog(cfg.stall_chunks)
    on_retire = should_stop = None
    if on_chunk is not None:
        def on_retire(rounds, state):
            on_chunk(rounds, canonical(rounds, state))
    if cfg.stall_chunks:
        life = faults_mod.life_planes(cfg, topo.n)

        def should_stop(rounds, state):
            return watchdog.no_progress(_progress_gap(
                life, cfg.quorum, target, canonical(rounds, state).conv, rounds))
    return on_retire, should_stop, watchdog


def hook_kw(cfg: SimConfig, on_retire, should_stop) -> dict:
    """run_chunks's hook arguments for a run."""
    return {"on_retire": on_retire, "should_stop": should_stop,
            "step_timing": cfg.step_timing,
            "hook_error": "raise" if cfg.strict_checkpoint else "continue"}


def draw_leader(base_key, topo: Topology, cfg: SimConfig) -> int:
    """Leader in [0, nodes): the reference's Random().Next(0, nodes), where
    nodes excludes the Q1 extra actor (program.fs:173)."""
    upper = int(topo.target_count if cfg.reference else topo.n)
    return int(rng.randint(rng.fold_in(base_key, _LEADER_TAG), (), 0, upper))


def resolve_delivery(topo: Topology, cfg: SimConfig) -> str:
    """The chunked round's delivery (the JAX runner's
    ``resolve_deliver_fn``): "pool" or "matmul" when asked for, stencil
    (masked circular shifts) where the topology has a small displacement
    set and the delivery is not "scatter", scatter-add otherwise."""
    if cfg.delivery in ("pool", "matmul"):
        return cfg.delivery
    if cfg.delivery == "stencil" and topo.offsets is None:
        raise ValueError(
            "delivery='stencil' requires an offset-structured topology "
            "(line/ring/grid2d/ref2d/grid3d/torus3d); "
            f"{topo.kind!r} has no small displacement set")
    if cfg.delivery != "scatter" and topo.offsets is not None:
        return "stencil"
    return "scatter"


def _make_chunk_fn(topo: Topology, cfg: SimConfig, base_key, device,
                   target: int):
    """The chunked engine's chunk on [n] tensors. Returns (chunk_fn(state,
    status, start, end, key=None) -> (state, status), state0): rounds
    start..end under the overshoot contract, ``status`` an int32 [2]
    (rounds, done) tensor on the device, so a chunk queues its rounds with
    no host read. ``key`` replaces ``base_key`` for one call: every stream
    of the chunk is drawn from it (the replica sweep's lanes, models/sweep.py,
    run one chunk function under their own keys).
    The drop gate and the dead leave a round's senders, dead nodes keep
    their protocol state, push-sum may terminate globally, and under a
    crash model a round is judged by the quorum of its live nodes (the JAX
    runner's ``targets_and_gate``, ``_freeze_dead`` and
    ``_done_predicate``); under a recovery model revived nodes send again
    and, where their rejoin resets them, start their revival round from the
    reset state (``make_revive_fn``). Under the dup gate a dup-gated
    sender's message lands twice (``make_df``), and under the delay ring
    (``delay_rounds`` = D) the carry is a ``pipeline.Ringed`` pair: round r
    reads slot r % D of the ring, writes its fresh inbox (summed from 0)
    there and absorbs what it read (the JAX runner's ``make_round_fn``).

    Under scatter delivery a chunk is one call of the scatter wrapper
    (ops/scatter.py: csrc/scatter.cu on CUDA, its plain version on the
    CPU). Otherwise every round is torch ops, guarded by
    ``pipeline.advance``: on ``full`` the round draws cfg.pool_size shared
    displacements, every node picks one with packed choice bits, every node
    sends, and delivery is pool_size masked rolls; on a lattice every node
    draws one word, takes the neighbour column it selects
    (``targets_explicit``), nodes of degree > 0 send, and delivery is one
    masked roll per displacement class (``deliver_stencil``); on imp2d/imp3d
    with pool delivery a node that selects its long-range column sends
    along one of the round's pool displacements instead
    (``imp_pool_parts``, ``deliver_imp_pool``). Under delivery="matmul"
    the round samples as pool delivery does and delivers to the targets
    that sampling implies (``delivery.deliver_matmul``)."""
    n = topo.n
    pushsum = cfg.algorithm == "push-sum"
    delivery = resolve_delivery(topo, cfg)
    if delivery in ("pool", "matmul") and (cfg.dup_rate > 0
                                           or cfg.delay_rounds > 0):
        raise ValueError(
            "dup/delay fault models run on the scatter/stencil chunked "
            f"paths only; {cfg.delivery} delivery supports the drop gate "
            "(--fault-rate) and crash models"
        )
    scattered = delivery == "scatter"
    D = cfg.delay_rounds
    # The telemetry plane's row after each round (ops/telemetry.py).
    row_fn = (telemetry_mod.make_row_fn(topo, cfg, base_key, device)
              if cfg.telemetry else None)
    if pushsum:
        state0 = pushsum_mod.init_state(n, cfg.initial_term_round, device)
    else:
        state0 = gossip_mod.init_state(
            n, draw_leader(base_key, topo, cfg),
            cfg.reference and topo.kind == "full", device)
    if D:
        # The ring of deliveries in flight, zero at the start of a run.
        ring0 = (torch.zeros(D, 2, n, dtype=torch.float32, device=device)
                 if pushsum else torch.zeros(D, n, dtype=torch.int32,
                                             device=device))
        state0 = pipeline_mod.Ringed(state0, ring0)

    if scattered:
        graph = scatter.scatter_graph(topo, device)
        faults = fused.run_faults(cfg, n)
        if pushsum:
            fn = functools.partial(scatter.pushsum_scatter_chunk, graph=graph,
                                   target=target, delta=cfg.resolved_delta,
                                   term_rounds=cfg.term_rounds, faults=faults)
        else:
            fn = functools.partial(scatter.gossip_scatter_chunk, graph=graph,
                                   target=target,
                                   rumor_target=cfg.resolved_rumor_target,
                                   suppress=cfg.resolved_suppress,
                                   faults=faults)

        def scatter_chunk(state, status, start, end, key=None):
            key = base_key if key is None else key
            rows = row_fn and functools.partial(row_fn, key=key)
            return fn(state, key, start, max(end - start, 0), status,
                      telemetry=rows)

        return scatter_chunk, state0

    if topo.kind in IMP_LATTICE:
        split = imp_split(topo)
        if split is None:
            raise ValueError(
                f"imp pooled delivery unavailable for this {topo.kind!r} "
                "instance (lattice slots are not offset-structured)"
            )
        disp_cols = torch.from_numpy(split.disp_cols).to(device)
        degree = torch.from_numpy(split.degree).to(device)
        send_ok = degree > 0
        lattice = [int(q) for q in split.lattice_offsets]

        ids = torch.arange(n, dtype=torch.int64, device=device)

        def deliver_parts(round_idx: int, key):
            kr = sampling.round_key(key, round_idx)
            d, is_extra, choice, offs, _ = imp_pool_parts(
                topo, cfg, kr, disp_cols, degree, device)
            if delivery == "matmul":
                # Each node's target: its sampled lattice displacement, or
                # on its long-range slot its pool displacement.
                offs = offs.to(device, torch.int64)
                disp = torch.where(is_extra, offs[choice.to(torch.int64)], d)
                targets = torch.remainder(ids + disp, n)
                return lambda values: delivery_mod.deliver_matmul(
                    values, targets, n)
            return lambda values: delivery_mod.deliver_imp_pool(
                values, d, is_extra, choice, lattice, offs.tolist())

    elif topo.implicit:
        send_ok = torch.ones(n, dtype=torch.bool, device=device)

        pool_fn = (delivery_mod.deliver_pool_trimmed if cfg.robust_agg == "trim"
                   else delivery_mod.deliver_pool)

        ids = torch.arange(n, dtype=torch.int64, device=device)

        def deliver_parts(round_idx: int, key):
            kr = sampling.round_key(key, round_idx)
            offs = sampling.pool_offsets(kr, cfg.pool_size, n)
            choice = sampling.pool_choice_packed(kr, n, cfg.pool_size, device=device)
            if delivery == "matmul":
                targets = sampling.targets_pool(choice, offs, ids, n)
                return lambda values: delivery_mod.deliver_matmul(
                    values, targets, n)
            return lambda values: pool_fn(values, choice, offs.tolist())

    else:
        neighbors = torch.from_numpy(topo.neighbors).to(device)
        degree = torch.from_numpy(topo.degree).to(device)
        send_ok = degree > 0
        offsets = [int(d) for d in topo.offsets]

        def deliver_parts(round_idx: int, key):
            kr = sampling.round_key(key, round_idx)
            bits = sampling.uniform_bits(kr, n, device=device)
            targets = sampling.targets_explicit(bits, neighbors, degree)
            return make_df(lambda values: delivery_mod.deliver_stencil(
                values, targets, offsets, n), kr)

    def make_df(deliver, kr):
        """The round's delivery with its dup gate folded in (the JAX
        runner's ``make_df``)."""
        dup = sampling.dup_gate(kr, n, cfg.dup_rate, device=device)
        return lambda v: delivery_mod.deliver_dup(deliver, v, dup)

    faults = fused.run_faults(cfg, n)
    death = faults.death_flat(n, device) if faults and faults.death is not None else None
    revive = faults.revive_flat(n, device) if faults is not None else None
    byz = faults.byz_flat(n, device) if faults is not None else None
    mode = cfg.byzantine_mode

    def alive(round_idx: int):
        return faults_mod.alive_at(death, round_idx, revive)

    def gated(send_ok, round_idx: int, key):
        """The round's senders: the drop gate's and the living among
        ``send_ok`` (the JAX runner's ``targets_and_gate``; revived nodes
        send again)."""
        if faults is None:
            return send_ok
        gate = sampling.send_gate(sampling.round_key(key, round_idx), n,
                                  cfg.fault_rate, device=device)
        if gate is not True:
            send_ok = send_ok & gate
        if death is not None:
            send_ok = send_ok & alive(round_idx)
        return send_ok

    def rejoin(state, round_idx: int):
        """The reset at the start of a revival round's body (the JAX
        runner's ``make_revive_fn``)."""
        if revive is None:
            return state
        return faults_mod.rejoin(state, faults_mod.revived_at(revive, round_idx),
                                 faults.reset, faults.init_term)

    def freeze_dead(old, new, round_idx: int):
        if death is None:
            return new
        return faults_mod.freeze_dead(old, new, ~alive(round_idx))

    if pushsum:
        delta, term_rounds = cfg.resolved_delta, cfg.term_rounds
        global_term = cfg.termination == "global"
        # The kept halves' forms: stencil delivery keeps s - s_send, and
        # w - w_send under global termination, except under the delay ring
        # (pushsum.halve_and_send).
        fold_s = topo.implicit or topo.kind in IMP_LATTICE or D > 0
        fold_w = fold_s or not global_term

        clip = cfg.robust_agg == "clip"

        def round_fn(carry, round_idx, key):
            state = pipeline_mod.proto_of(carry)
            state = rejoin(state, round_idx)
            deliver = deliver_parts(round_idx, key)
            ok = gated(send_ok, round_idx, key)
            s_send, w_send, s_keep, w_keep = pushsum_mod.halve_and_send(
                state.s, state.w, ok, fold_s, fold_w
            )
            if byz is not None:
                # The lie is what a sender puts on the wire (and what enters
                # the ring); its kept halves stay honest (make_byz_send_fn).
                s_send, w_send = faults_mod.lie(
                    mode, s_send, w_send, state.s, state.w,
                    faults_mod.byzantine_at(byz, round_idx) & ok)
            inbox = deliver(torch.stack([s_send, w_send]))
            if D:
                inbox = pipeline_mod.ring_step(carry.ring, inbox, round_idx % D)
            if clip:
                new = pushsum_mod.absorb_clipped(
                    state, s_keep, w_keep, inbox[0], inbox[1],
                    pushsum_mod.clip_scale(inbox[1], w_keep), delta, term_rounds)
            else:
                new = pushsum_mod.absorb(
                    state, s_keep, w_keep, inbox[0], inbox[1], delta,
                    term_rounds, global_term)
            new = freeze_dead(state, new, round_idx)
            return (pipeline_mod.RingRound(new, carry.ring, round_idx % D, inbox)
                    if D else new)

    else:
        rumor_target, suppress = cfg.resolved_rumor_target, cfg.resolved_suppress

        def round_fn(carry, round_idx, key):
            state = pipeline_mod.proto_of(carry)
            state = rejoin(state, round_idx)
            deliver = deliver_parts(round_idx, key)
            vals = gossip_mod.send_values(state, gated(send_ok, round_idx, key))
            inbox = deliver(vals[None])[0]
            if D:
                inbox = pipeline_mod.ring_step(carry.ring, inbox, round_idx % D)
            new = gossip_mod.absorb(state, inbox, rumor_target, suppress)
            new = freeze_dead(state, new, round_idx)
            if byz is not None:
                # The live adversaries' override, after the freeze
                # (make_byz_override_fn).
                lying = faults_mod.byzantine_at(byz, round_idx)
                if death is not None:
                    lying = lying & alive(round_idx)
                new = gossip_mod.GossipState(
                    *faults_mod.override(mode, lying, *new))
            return (pipeline_mod.RingRound(new, carry.ring, round_idx % D, inbox)
                    if D else new)

    bad = (None if cfg.mass_tolerance is None
           else pipeline_mod.health_check(n, cfg.mass_tolerance))

    def round_chunk(state, status, start, end, key=None):
        key = base_key if key is None else key
        status = status.clone()
        state = pipeline_mod.own_ring(state)
        count = max(end - start, 0)
        needs = faults.needs(start, count)[0] if death is not None else None
        rows = (None if row_fn is None else
                torch.zeros(count, telemetry_mod.N_COLS, dtype=torch.float32,
                            device=device))
        for k, rnd in enumerate(range(start, end)):
            verdict = {} if needs is None else {"alive": alive(rnd),
                                                "need": int(needs[k])}
            state = pipeline_mod.advance(state, round_fn(state, rnd, key), status,
                                         target, bad=bad, **verdict)
            if rows is not None:
                # The row after the round, from its output state.
                rows[k] = row_fn(pipeline_mod.proto_of(state), rnd,
                                 verdict.get("need"), key=key)
        return (state, status) if rows is None else (state, status, rows)

    return round_chunk, state0


def imp_pool_parts(topo: Topology, cfg: SimConfig, round_k, disp_cols,
                   degree, device=None):
    """The imp pooled round's sampling: (d_sampled, is_extra, choice, offs,
    send_ok). The slot word is the static path's (``uniform_bits`` off the
    round key, slot = word % degree over the -1-sentineled displacement
    columns of ``imp_split``), so a sampled -1 is the long-range slot; its
    target is one of the round's pool displacements, picked by 4 bits of a
    packed word off ``imp_choice_key``."""
    n = topo.n
    bits = sampling.uniform_bits(round_k, n, device=device)
    d = sampling.targets_explicit(bits, disp_cols, degree)
    is_extra = (d == -1) & (degree > 0)
    offs = sampling.pool_offsets(round_k, cfg.pool_size, n)
    choice = sampling.pool_choice_packed(
        sampling.imp_choice_key(round_k), n, cfg.pool_size, device=device)
    return d, is_extra, choice, offs, degree > 0


def _host_done(state, target: int, cfg: Optional[SimConfig] = None,
               rounds: int = 0) -> bool:
    """The termination predicate on a canonical state after ``rounds``
    rounds: converged count >= target, or under ``cfg``'s crash model the
    quorum of the nodes alive in the last round (rounds - 1), revivals
    counted."""
    conv = state.conv.cpu().numpy() != 0
    planes = None if cfg is None else faults_mod.life_planes(cfg, conv.shape[0])
    if planes is None:
        return bool(conv.sum() >= target)
    alive = faults_mod.alive_at(planes.death, rounds - 1, planes.revive)
    need = faults_mod.quorum_need(int(alive.sum()), cfg.quorum)
    return bool((conv & alive).sum() >= need)


def _finalize_result(topo: Topology, cfg: SimConfig, state, rounds: int,
                     target: int, compile_s: float, run_s: float, done: bool,
                     loop, device, collector=None,
                     stalled: bool = False) -> RunResult:
    """The result record from the final canonical state, on the host in
    float64 (diagnostics, never trajectory state). A tripped health
    sentinel (``loop.unhealthy_round``) makes the outcome "unhealthy", and
    the run is not converged whatever its count; a run the watchdog ended
    (``stalled``) and not converged is "stalled"."""
    conv_np = state.conv.cpu().numpy()
    converged_count = int(conv_np.sum())
    unhealthy = getattr(loop, "unhealthy_round", None)
    done = done and unhealthy is None
    result = RunResult(
        algorithm=cfg.algorithm,
        topology=topo.kind,
        semantics=cfg.semantics,
        n_requested=topo.n_requested,
        population=topo.n,
        target_count=target,
        rounds=rounds,
        converged_count=converged_count,
        converged=done,
        compile_s=compile_s,
        run_s=run_s,
        outcome=("unhealthy" if unhealthy is not None
                 else "converged" if done
                 else "stalled" if stalled else "max_rounds"),
        unhealthy_round=unhealthy,
        device=describe_device(device),
    )
    if cfg.algorithm == "push-sum":
        true_mean = (topo.n - 1) / 2.0
        s_np = state.s.cpu().numpy().astype(np.float64)
        w_np = state.w.cpu().numpy().astype(np.float64)
        w_safe = np.where(w_np != 0, w_np, 1.0)
        ratio = np.where(w_np != 0, s_np / w_safe, 0.0)
        err = np.where(conv_np, np.abs(ratio - true_mean), 0.0)
        mae = float(err.sum() / max(converged_count, 1))
        result.true_mean = true_mean
        result.estimate_mae = mae if math.isfinite(mae) else None
    result.dispatch_s = loop.dispatch_s
    result.fetch_s = loop.fetch_s
    result.first_dispatch_s = loop.first_dispatch_s
    result.aux_s = loop.aux_s
    result.hook_s = loop.hook_s
    result.chunk_log = loop.chunk_log
    if loop.hook_failures:
        result.hook_failures = list(loop.hook_failures)
    result.state = state
    if collector is not None:
        result.telemetry = collector.finalize()
    return result


def describe_device(device: torch.device) -> str:
    """The device a result ran on, by name (the card's, on CUDA)."""
    if device.type == "cuda":
        return f"{device}: {torch.cuda.get_device_name(device)}"
    return str(device)


def fused_tier(topo: Topology, cfg: SimConfig) -> tuple[str, Optional[str]]:
    """The fused tier the JAX runner's ladder picks for this config, and
    None or the reason it cannot run there (models/runner.py of the JAX
    package: with pool delivery, the pool engine on ``full`` up to its VMEM
    cap and the streaming pool tier past it, and on imp2d/imp3d the
    resident imp tier up to its plane budget, else the streaming one; with
    any other delivery the lattice tiers, the whole-array stencil tier,
    else the tiled one, else the streaming one, which serve neither
    ``full`` nor the imp kinds; delivery="scatter" pins the chunked
    engine, so it never fuses). The health sentinel and robust aggregation
    run on the chunked engine only, and the telemetry plane and the
    Byzantine plane on it and the pool and whole-array stencil tiers (rows
    1-2 and 5-6), with the JAX ladder's reasons."""
    variant, reason = _fused_variant(topo, cfg)
    if reason is None and cfg.telemetry and variant not in ("stencil", "pool"):
        reason = ("telemetry counters run in the fused stencil/pool kernels "
                  f"only (selected tier: {variant!r})")
    if reason is None and cfg.mass_tolerance is not None:
        reason = ("the health sentinel (--mass-tolerance) runs in the "
                  "chunked/sharded XLA round bodies only")
    if reason is None and cfg.byzantine_model and variant not in ("stencil", "pool"):
        reason = ("the byzantine adversary plane rides the fused "
                  f"stencil/pool kernels only (selected tier: {variant!r}); "
                  "other tiers run it on the chunked engine")
    if reason is None and cfg.robust_agg != "none":
        reason = ("robust aggregation (--robust-agg) bounds inboxes in the "
                  "chunked XLA round bodies only")
    if (reason is None and cfg.delivery == "scatter"
            and variant not in ("pool", "pool2", "imp", "imp_hbm")):
        reason = ("delivery='scatter' runs the chunked engine (the fused "
                  "lattice tiers deliver by the stencil formulation)")
    return variant, reason


def _fused_variant(topo: Topology, cfg: SimConfig) -> tuple[str, Optional[str]]:
    """``fused_tier``'s tier and its plan's reason, before the knobs that
    only the chunked engine carries. delivery="matmul" on ``full`` takes
    the pool tiers, whose kernels compute its function (the JAX tiers' MXU
    blend is bitwise their roll blend), and on the imp kinds the chunked
    engine."""
    if cfg.delivery == "matmul" and topo.kind in IMP_LATTICE:
        return "imp", (
            "the fused imp tiers deliver by lattice/pool class rolls; "
            "delivery='matmul' runs the chunked engine on imp kinds (the "
            "MXU tier's fused home is the implicit-full pool kernels)")
    if cfg.delivery == "pool" and topo.kind in IMP_LATTICE:
        reason = fused_imp.imp_fused_support(topo, cfg)
        if reason is not None and fused_imp_hbm.imp_hbm_support(topo, cfg) is None:
            return "imp_hbm", None
        return "imp", reason
    if cfg.delivery in ("pool", "matmul") and topo.implicit:
        if topo.n <= fused_pool.MAX_POOL_NODES:
            return "pool", fused_pool.pool_fused_support(topo, cfg)
        return "pool2", fused_pool2.pool2_support(topo, cfg)
    reason = fused.fused_support(topo, cfg)
    if reason is None:
        variant = "stencil"
    else:
        variant, reason = "stencil2", fused_stencil.stencil2_support(topo, cfg)
        if reason is not None and fused_stencil_hbm.stencil_hbm_support(topo, cfg) is None:
            variant, reason = "stencil_hbm", None
    return variant, reason


def sharded_tier(topo: Topology, cfg: SimConfig) -> tuple[str, Optional[str], str]:
    """The composition the JAX runner's ladder picks for an n_devices > 1
    config (models/runner.py of the JAX package), the reason it cannot run
    there (None if the JAX package would run it), and the ROADMAP item that
    ports it. ``engine="fused"`` on implicit ``full`` with pool delivery
    tries the VMEM replicated composition (``fused_pool_sharded``, up to
    the pool engine's 2**21 nodes) and then the replicated-pool2 one
    (``pool2_sharded``), else both plans' reasons; with matmul delivery
    the replicated-pool2 one alone (the matmul tier's sharded home); the imp kinds with pool
    delivery go to ``imp_hbm_sharded``, else its plan's reason; every other
    kind (the imp kinds under another delivery too) tries the resident
    lattice composition (``fused_sharded``) and then the streaming one
    (``stencil_hbm_sharded``), else both plans' reasons; any other engine
    goes to the sharded XLA engine (``sharded``)."""
    from ..parallel.fused_hbm_sharded import plan_stencil_hbm_sharded
    from ..parallel.fused_imp_hbm_sharded import plan_imp_hbm_sharded
    from ..parallel.fused_pool_sharded import plan_fused_pool_sharded
    from ..parallel.fused_sharded import plan_fused_sharded
    from ..parallel.pool2_sharded import plan_pool2_sharded

    S = cfg.n_devices
    if cfg.engine != "fused":
        return "sharded", None, "A10"
    if topo.implicit:
        plan_vmem = (
            "the VMEM replicated pool composition serves "
            "delivery='pool'; the matmul tier's sharded home "
            "is the replicated-pool2 composition"
        ) if cfg.delivery == "matmul" else plan_fused_pool_sharded(topo, cfg, S)
        if not isinstance(plan_vmem, str):
            return "fused_pool_sharded", None, "A10"
        plan_p2 = plan_pool2_sharded(topo, cfg, S)
        if not isinstance(plan_p2, str):
            return "pool2_sharded", None, "B13"
        return "pool2_sharded", (
            f"engine='fused' with n_devices={S} unavailable: VMEM pool "
            f"composition: {plan_vmem}; replicated-pool2 composition: {plan_p2}"
        ), "B13"
    if topo.kind in IMP_LATTICE and cfg.delivery == "pool":
        plan_imp = plan_imp_hbm_sharded(topo, cfg, S)
        if not isinstance(plan_imp, str):
            return "imp_hbm_sharded", None, "B12"
        return "imp_hbm_sharded", (
            f"engine='fused' with n_devices={S} unavailable: {plan_imp}"), "B12"
    plan_vmem = plan_fused_sharded(topo, cfg, S)
    if not isinstance(plan_vmem, str):
        return "fused_sharded", None, "B10"
    plan_hbm = plan_stencil_hbm_sharded(topo, cfg, S)
    if not isinstance(plan_hbm, str):
        return "stencil_hbm_sharded", None, "B11"
    return "stencil_hbm_sharded", (
        f"engine='fused' with n_devices={S} unavailable: VMEM composition: "
        f"{plan_vmem}; HBM-streaming composition: {plan_hbm}"
    ), "B11"


_SHARDED_NAMES = {
    "sharded": "the sharded XLA engine (run_sharded; --devices with "
               "--engine fused runs the replicated-pool2 composition on full "
               "and the imp composition on imp2d/imp3d with --delivery pool, "
               "and the lattice compositions on the lattices)",
    "fused_pool_sharded": "the VMEM replicated pool composition "
                          "(parallel/fused_pool_sharded.py, full up to "
                          "2**21 nodes)",
}


def run(topo: Topology, cfg: SimConfig, key=None, device=None,
        start_state=None, start_round: int = 0, devices=None,
        on_telemetry=None, on_chunk=None, fixed_chunks: bool = False) -> RunResult:
    """Run one simulation to convergence or cfg.max_rounds.

    ``device`` is "cuda" (the default) or "cpu"; with no GPU and no
    explicit CPU request this raises instead of running on the CPU.
    ``key`` is the base key (default ``rng.PRNGKey(cfg.seed)``);
    ``start_state``/``start_round`` resume from a canonical state at an
    absolute round, on the same trajectory (round keys are absolute).
    Reference-semantics push-sum is the single walk, whose ``rounds`` are
    message hops.

    With ``cfg.n_devices > 1`` the run is sharded over that many shards:
    ``devices`` names each shard's device (``["cuda:0"] * 4`` puts four on
    one card, ``["cpu"] * 4`` on the CPU); without it shard i goes to
    device i of ``device``'s kind, which must be visible
    (parallel/mesh.make_mesh). The composition is the JAX ladder's
    (``sharded_tier``); the replicated-pool2, the lattice and the imp ones
    run, every other refuses naming its ROADMAP item.

    Under ``cfg.telemetry`` the result carries the run's rows
    (``RunResult.telemetry``), and ``on_telemetry(chunk_start_round,
    rows)`` fires with each retired chunk's rows (ops/telemetry.Collector).

    ``on_chunk(rounds, state)`` fires at every retired chunk with the
    canonical state on the host (CPU tensors, [n] entries: a sharded run's
    padding stripped), the CLI's checkpoint hook. ``fixed_chunks`` gives
    the chunked engine the JAX chunked engine's boundaries without a hook
    (the CLI's ``--events``: its chunk-retired rounds are JAX's)."""
    t_enter = time.perf_counter()
    sharded = cfg.n_devices is not None and cfg.n_devices > 1
    if devices is not None and not sharded:
        raise ValueError("devices places the shards of an n_devices > 1 run; "
                         f"n_devices is {cfg.n_devices}")
    if sharded:
        return _run_sharded(topo, cfg, key, device, devices, start_state,
                            start_round, t_enter, on_chunk)
    device = resolve_device(device)
    key = rng.PRNGKey(cfg.seed) if key is None else key
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    if cfg.reference and cfg.algorithm == "push-sum":
        # Reference fidelity: the single walk (one message in flight).
        # Gossip has no such mode: the batched round already models the
        # reference's informed nodes all sending at once.
        if start_state is not None:
            raise ValueError("the reference-semantics walk does not resume "
                             "from a batched state")
        return _run_reference_walk(topo, cfg, key, device, target, t_enter)
    if cfg.engine != "chunked":
        variant, reason = fused_tier(topo, cfg)
        if cfg.engine == "fused":
            if variant not in ("pool", "pool2") and cfg.delivery == "scatter":
                raise ValueError(
                    "engine='fused' delivers via the stencil formulation "
                    "only; delivery='scatter' would be silently ignored — "
                    "use delivery='auto'/'stencil' or engine='chunked'"
                )
            if reason is not None:
                raise ValueError(f"engine='fused' unavailable: {reason}")
            return _run_fused(topo, cfg, key, device, start_state,
                              start_round, target, t_enter, on_telemetry,
                              on_chunk, variant)
        if reason is None and device.type == "cuda":
            return _run_fused(topo, cfg, key, device, start_state,
                              start_round, target, t_enter, on_telemetry,
                              on_chunk, variant)
    return _run_chunked(topo, cfg, key, device, start_state, start_round,
                        target, t_enter, on_telemetry, on_chunk, fixed_chunks)


def _run_sharded(topo, cfg, key, device, devices, start_state, start_round,
                 t_enter, on_chunk=None) -> RunResult:
    """The JAX ladder's n_devices > 1 step: the composition and its plan's
    reason (``sharded_tier``), JAX's ValueError where a plan refuses the
    config, and only then the port's own refusal by ROADMAP item: a
    composition not ported (``_SHARDED_NAMES``)."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.fused_hbm_sharded import run_stencil_hbm_sharded
    from ..parallel.fused_imp_hbm_sharded import run_imp_hbm_sharded
    from ..parallel.fused_sharded import run_fused_sharded
    from ..parallel.pool2_sharded import run_pool2_sharded

    if cfg.engine == "fused":
        if cfg.telemetry:
            raise ValueError(
                "telemetry counters run in the single-device fused "
                "stencil/pool kernels and the chunked/sharded XLA "
                "engines; the sharded fused compositions do not carry "
                "the counter block — drop the engine override (the "
                "sharded XLA engine psums the block in-trace)"
            )
        if cfg.mass_tolerance is not None:
            raise ValueError(
                "the health sentinel (--mass-tolerance) runs in the "
                "chunked and sharded XLA round bodies; the sharded "
                "fused compositions do not carry it — drop the engine "
                "override"
            )
        if cfg.byzantine_model:
            raise ValueError(
                "the byzantine adversary plane is threaded through "
                "the chunked engine and the single-device fused "
                "stencil/pool kernels; the sharded fused compositions "
                "do not carry the plane — drop the engine override"
            )
        if cfg.robust_agg != "none":
            raise ValueError(
                "robust aggregation (--robust-agg) bounds inboxes in "
                "the chunked XLA round bodies only; the sharded fused "
                "compositions do not carry it — drop the engine "
                "override"
            )
        if topo.kind in IMP_LATTICE and cfg.delivery == "matmul":
            raise ValueError(
                "engine='fused' with delivery='matmul' on imp kinds "
                "is not served: the imp x HBM x sharded composition "
                "delivers by lattice/pool class rolls — use "
                "delivery='pool' for that composition, or the "
                "single-device chunked engine for the matmul tier"
            )
    elif cfg.delivery == "matmul":
        raise ValueError(
            "delivery='matmul' has no sharded XLA path (the chunked "
            "sharded engine delivers pool rounds by global rolls / "
            "scatter, which would break the matmul tier's zero-scatter "
            "contract); the MXU tier runs on the single-device chunked "
            "engine, the fused pool kernels, and the replicated-pool2 "
            "composition (engine='fused') — drop n_devices or use "
            "delivery='pool'"
        )
    elif cfg.byzantine_model or cfg.robust_agg != "none":
        raise ValueError(
            "the byzantine adversary plane and robust aggregation run "
            "on the single-device chunked engine (and, for the plane, "
            "the fused stencil/pool kernels); the sharded XLA "
            "composition does not thread them through its shard-mapped "
            "round body — drop n_devices"
        )
    tier, reason, item = sharded_tier(topo, cfg)
    if reason is not None:
        raise ValueError(reason)
    runs = {"pool2_sharded": run_pool2_sharded,
            "fused_sharded": run_fused_sharded,
            "stencil_hbm_sharded": run_stencil_hbm_sharded,
            "imp_hbm_sharded": run_imp_hbm_sharded}
    if tier not in runs:
        raise unported(f"n_devices={cfg.n_devices} with engine={cfg.engine!r} "
                       f"on {topo.kind}: {_SHARDED_NAMES[tier]}", item)
    mesh = mesh_mod.make_mesh(
        cfg.n_devices, devices,
        platform=resolve_device(device).type if devices is None else "cuda")
    key = rng.PRNGKey(cfg.seed) if key is None else key
    return runs[tier](topo, cfg, mesh, key, start_state, start_round, t_enter,
                      on_chunk=on_chunk)


def _run_reference_walk(topo, cfg, key, device, target, t_enter) -> RunResult:
    """The single walk to convergence, death or cfg.max_rounds hops:
    ``rounds`` counts hops, and the estimate error is the JAX package's,
    in float32 over the converged nodes."""
    leader = draw_leader(key, topo, cfg)
    t0 = time.perf_counter()
    final, compile_s, run_s = reference_mod.run_walk(topo, cfg, key, leader,
                                                     target, device)
    converged_count = int(final.conv.sum())
    done = converged_count >= target
    result = RunResult(
        algorithm=cfg.algorithm,
        topology=topo.kind,
        semantics=cfg.semantics,
        n_requested=topo.n_requested,
        population=topo.n,
        target_count=target,
        rounds=int(final.steps),  # message hops, not synchronous rounds
        converged_count=converged_count,
        converged=done,
        compile_s=compile_s,
        run_s=run_s,
        outcome="converged" if done else "max_rounds",
        device=describe_device(device),
    )
    result.true_mean = (topo.n - 1) / 2.0
    result.estimate_mae = reference_mod.estimate_mae(final, result.true_mean)
    result.state = final
    result.setup_s = t0 - t_enter
    return result


def _to_device(state, device):
    return type(state)(*(x.to(device).clone() for x in state))


def _run_chunked(topo, cfg, key, device, start_state, start_round, target,
                 t_enter, on_telemetry=None, on_chunk=None,
                 fixed_chunks: bool = False) -> RunResult:
    """Chunk loop over the chunked engine: each chunk queues its rounds
    with the (rounds, done) status on the device, and the pipeline reads
    that status once a chunk (with the chunk's telemetry rows, copied
    behind the same event). Under a boundary observer (``on_chunk``, the
    watchdog, step timing, ``fixed_chunks``) chunks are cfg.chunk_rounds
    long from the start round, the JAX chunked engine's boundaries."""
    chunk_fn, state0 = _make_chunk_fn(topo, cfg, key, device, target)
    if start_state is not None:
        if cfg.delay_rounds > 0:
            raise ValueError(
                "resume with delay_rounds > 0 is unsupported: the in-flight "
                "delivery ring is not checkpointed, so the resumed "
                "trajectory could not be bitwise-faithful"
            )
        state0 = _to_device(start_state, device)
    done0 = start_state is not None and _host_done(state0, target, cfg,
                                                   start_round)
    queued = {"end": start_round}  # nominal start of the next chunk

    def dispatch(state, status, round_end):
        # A chunk that runs at all starts where the previous one was told
        # to end; after termination every round is a no-op.
        start, queued["end"] = queued["end"], round_end
        return chunk_fn(state, status, start, round_end)

    t0 = time.perf_counter()
    setup_s = t0 - t_enter
    # Warmup: builds the kernels on first use and runs one real round,
    # discarded (round keys are absolute, so the timed loop recomputes it
    # identically).
    warm = torch.tensor([start_round, 0] + [pipeline_mod.NEVER] * (
        cfg.mass_tolerance is not None), dtype=torch.int32, device=device)
    chunk_fn(state0, warm, start_round, min(start_round + 1, cfg.max_rounds))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    # Under the health sentinel a third word holds its first unhealthy
    # round (pipeline.advance).
    health = [] if cfg.mass_tolerance is None else [pipeline_mod.NEVER]
    status0 = torch.tensor([start_round, int(done0), *health], dtype=torch.int32,
                           device=device)
    K = cfg.chunk_rounds

    def next_end(end):
        # Chunks grow by a quarter of the rounds run so far, from
        # _FIRST_CHUNK up to chunk_rounds: the rounds queued past
        # termination (no-ops, but each still computed or launched) stay a
        # fraction of the run, at one status read a chunk.
        return end + min(K, max(_FIRST_CHUNK, (end - start_round) // 4))

    on_retire, should_stop, watchdog = boundary_hooks(
        topo, cfg, target, on_chunk, lambda _, st: pipeline_mod.proto_of(st))
    fixed = (fixed_chunks or on_chunk is not None or cfg.stall_chunks > 0
             or cfg.step_timing)
    collector = (telemetry_mod.Collector(start_round, on_rows=on_telemetry)
                 if cfg.telemetry else None)
    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=state0, status0=status0,
        start_round=start_round, max_rounds=cfg.max_rounds, stride=K,
        # The CPU runs a chunk as it is queued: a second chunk in flight
        # would only add no-op rounds.
        depth=cfg.pipeline_chunks if device.type == "cuda" else 1,
        next_end=None if fixed else next_end,
        on_aux=collector and collector.on_aux,
        **hook_kw(cfg, on_retire, should_stop),
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    # The result's state is the protocol state alone (the JAX proto_of).
    result = _finalize_result(topo, cfg, pipeline_mod.proto_of(loop.state),
                              loop.rounds, target, compile_s, run_s,
                              loop.done, loop, device, collector,
                              stalled=watchdog.stalled)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result


@dataclasses.dataclass
class FusedEngine:
    """One fused tier set up for one config: ``planes`` is the start state
    in the tier's padded layout (CPU tensors), ``streams(start, count)``
    draws the per-round inputs on the host (the fold_in keys, plus the
    displacement pools on the pool and imp tiers and the choice keys on the
    imp tiers), ``chunk(state, streams, start,
    cap) -> (state, executed)`` runs one chunk, and ``to_canonical`` turns
    padded planes back into a [n] state."""

    layout: object
    planes: tuple
    streams: object
    chunk: object
    to_canonical: object


def fused_engine(topo: Topology, cfg: SimConfig, key, variant: str,
                 start_state=None) -> FusedEngine:
    """The fused engine of tier ``variant`` ("pool", "pool2", "stencil",
    "stencil2", "stencil_hbm", "imp" or "imp_hbm")."""
    n = topo.n
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    if cfg.telemetry and variant not in ("stencil", "pool"):
        raise ValueError(
            "telemetry counters run in the fused stencil and pool kernels "
            f"only; the {variant!r} tier does not carry the counter block — "
            "use engine='chunked' or a telemetry-capable population")
    if variant in ("pool", "pool2"):
        layout = fused_pool.build_pool_layout(n)
        pushsum_chunk, gossip_chunk = (
            (fused_pool.pushsum_pool_chunk, fused_pool.gossip_pool_chunk)
            if variant == "pool" else
            (fused_pool2.pushsum_pool2_chunk, fused_pool2.gossip_pool2_chunk))
        common = {"n": n, "target": target, "faults": fused.run_faults(cfg, n)}
    elif variant in ("imp", "imp_hbm"):
        layout = fused_pool.build_pool_layout(n)
        pushsum_chunk, gossip_chunk = (
            (fused_imp.pushsum_imp_chunk, fused_imp.gossip_imp_chunk)
            if variant == "imp" else
            (fused_imp_hbm.pushsum_imp_hbm_chunk, fused_imp_hbm.gossip_imp_hbm_chunk))
        common = {"spec": fused_imp.imp_spec(topo), "target": target}
        if cfg.algorithm == "push-sum":
            common["faults"] = fused.run_faults(cfg, n)
    else:
        build, pushsum_chunk, gossip_chunk = {
            "stencil": (fused.build_layout, fused.pushsum_chunk,
                        fused.gossip_chunk),
            "stencil2": (fused_pool.build_pool_layout,
                         fused_stencil.pushsum_stencil2_chunk,
                         fused_stencil.gossip_stencil2_chunk),
            "stencil_hbm": (fused_stencil_hbm._streaming_layout,
                            fused_stencil_hbm.pushsum_stencil_hbm_chunk,
                            fused_stencil_hbm.gossip_stencil_hbm_chunk),
        }[variant]
        layout = build(n)
        common = {"spec": fused_stencil_hbm.stencil_spec(topo), "target": target}
        if variant != "stencil_hbm" or cfg.algorithm == "push-sum":
            common["faults"] = fused.run_faults(cfg, n)
    if cfg.telemetry:
        # The kernels' telemetry instance: the chunk returns its rows too.
        common["telemetry"] = True

    def streams(start, count):
        keys = fused.round_keys(key, start, count)
        if variant.startswith("stencil"):
            return (keys,)
        offs = fused_pool.round_offsets(key, start, count, cfg.pool_size, n)
        if variant in ("pool", "pool2"):
            return keys, offs
        return keys, offs, fused_imp.choice_round_keys(key, start, count)

    if cfg.algorithm == "push-sum":
        if start_state is not None and start_state.s.dtype != torch.float32:
            # The JAX runner's refusal: a float64 checkpoint silently
            # downcast to the float32-only fused tiers would lose precision.
            raise ValueError(
                "fused engine resume requires a float32 checkpoint, got "
                f"{str(start_state.s.dtype).removeprefix('torch.')}; resume with "
                "engine='chunked' (matching the checkpoint dtype) instead"
            )
        st = start_state or pushsum_mod.init_state(n, cfg.initial_term_round)
        planes = (
            fused._pad2d(st.s.cpu().to(torch.float32), layout, 0.0),
            fused._pad2d(st.w.cpu().to(torch.float32), layout, 1.0),
            fused._pad2d(st.term.cpu().to(torch.int32), layout, 0),
            fused._pad2d(st.conv.cpu().to(torch.int32), layout, 0),
        )

        def chunk(state, extras, start, cap):
            return pushsum_chunk(state, *extras, start, cap, **common,
                                 delta=cfg.resolved_delta,
                                 term_rounds=cfg.term_rounds)

        def to_canonical(state):
            s, w, t, c = (x.reshape(-1)[:n] for x in state)
            return pushsum_mod.PushSumState(s=s, w=w, term=t, conv=c != 0)

    else:
        st = start_state or gossip_mod.init_state(
            n, draw_leader(key, topo, cfg), cfg.reference and topo.kind == "full"
        )
        planes = (
            fused._pad2d(st.count.cpu().to(torch.int32), layout, 0),
            fused._pad2d(st.active.cpu().to(torch.int32), layout, 0),
            fused._pad2d(st.conv.cpu().to(torch.int32), layout, 0),
        )

        def chunk(state, extras, start, cap):
            return gossip_chunk(state, *extras, start, cap, **common,
                                rumor_target=cfg.resolved_rumor_target,
                                suppress=cfg.resolved_suppress)

        def to_canonical(state):
            cnt, act, c = (x.reshape(-1)[:n] for x in state)
            return gossip_mod.GossipState(count=cnt, active=act != 0, conv=c != 0)

    return FusedEngine(layout, planes, streams, chunk, to_canonical)


def _run_fused(topo, cfg, key, device, start_state, start_round, target,
               t_enter, on_telemetry, on_chunk, variant) -> RunResult:
    """Chunk loop over a fused engine: one chunk call per cfg.chunk_rounds
    rounds, with the per-round streams drawn on the host (the wrappers
    copy them to the device without a sync); under cfg.telemetry a chunk
    also returns its rows (rows 1-2 and 5-6, the only tiers that carry
    them)."""
    eng = fused_engine(topo, cfg, key, variant, start_state)
    streams, chunk_fn = eng.streams, eng.chunk
    state_dev = tuple(p.contiguous().to(device) for p in eng.planes)
    if variant.startswith("stencil") and device.type == "cuda":
        # The lattice kernels' directions word, cached per layout and
        # device: built here, so its time counts as set-up.
        fused_stencil_hbm.dir_words(fused_stencil_hbm.stencil_spec(topo),
                                    eng.layout.rows, state_dev[0].device)
    elif variant.startswith("imp") and device.type == "cuda":
        # The imp kernels' directions word, the same way.
        fused_imp.imp_dir_words(fused_imp.imp_spec(topo), eng.layout.rows,
                                state_dev[0].device)
    K = cfg.chunk_rounds
    queued = {"end": start_round}  # nominal start of the next chunk

    def dispatch(state, status, round_end):
        # A chunk that runs at all starts where the previous one was told
        # to end: a chunk stops short only at termination, and every later
        # chunk is then a no-op that keeps the carry's counter.
        start, queued["end"] = queued["end"], round_end
        new_state, executed, *rows = chunk_fn(state, streams(start, K), start,
                                              round_end)
        expected = min(K, max(round_end - start, 0))
        ex = executed.to(torch.int64)
        new_status = torch.stack(
            [status[0] + ex, ((status[1] != 0) | (ex < expected)).to(torch.int64)]
        )
        return (new_state, new_status, *rows)

    t0 = time.perf_counter()
    setup_s = t0 - t_enter
    # Warmup: builds the kernels on first use and runs one real round on
    # the same input, discarded (the chunk leaves its input unchanged).
    warm_end = min(start_round + 1, cfg.max_rounds)
    chunk_fn(state_dev, streams(start_round, 1), start_round, warm_end)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    status0 = torch.tensor([start_round, 0], dtype=torch.int64, device=device)
    collector = (telemetry_mod.Collector(start_round, on_rows=on_telemetry)
                 if cfg.telemetry else None)
    # The hooks read the tier's planes on the host, in canonical form.
    on_retire, should_stop, watchdog = boundary_hooks(
        topo, cfg, target, on_chunk, lambda _, st: eng.to_canonical(st))
    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=state_dev, status0=status0,
        start_round=start_round, max_rounds=cfg.max_rounds, stride=K,
        depth=cfg.pipeline_chunks, on_aux=collector and collector.on_aux,
        **hook_kw(cfg, on_retire, should_stop),
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    final = eng.to_canonical(loop.state)
    result = _finalize_result(topo, cfg, final, loop.rounds, target,
                              compile_s, run_s,
                              _host_done(final, target, cfg, loop.rounds),
                              loop, device, collector, stalled=watchdog.stalled)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result
