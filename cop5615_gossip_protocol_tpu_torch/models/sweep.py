"""The batch engine — many independent simulations of one engine class on
one device (the JAX package's models/sweep.py).

R lanes of one COMPILE CLASS (serving/keys.py: same topology, algorithm
and fault class, different base keys) share one engine: the chunked
engine's chunk function over the topology's device tensors, the failure
model's planes and the kernels' scratch, built once and kept warm in the
engine pool (serving/pool.py). Lanes are a leading dimension of the state:
``[R, n]`` planes, ``[R]`` round counters and done flags, ``[R, 2]`` key
data and, under the delay ring, an ``[R, D, ...]`` ring. Three front ends
share it:

- ``run_replicas`` — the replica sweep: R seeds derived from one run's
  base key (``--replicas``);
- ``run_batched_keys`` — a wave of independent requests, each lane riding
  its own base key, so lane i is bitwise the one-shot ``runner.run`` with
  that key;
- ``serve_lanes`` — continuous batching: at every chunk boundary the lanes
  whose request ended (converged, max_rounds or its own deadline) are
  retired through the source's ``on_result`` and refilled from the source
  with fresh requests, each bitwise the one-shot run of its request.

A chunk runs each live lane's chunk of the port's chunked engine
(``runner._make_chunk_fn``) under that lane's key, one lane after another
in lane order on the device's current stream: under scatter delivery on
the card that is one launch of kernel A (ops/scatter.py) a live lane a
chunk. Kernel A is persistent, with a grid barrier
(csrc/persistent.cuh): two of its launches running at once could hold
blocks the other waits for, so lanes never run concurrently. The torch-ops
deliveries (pool, stencil, imp pool, matmul) call the unchanged round lane
by lane too. A lane's chunk covers rounds ``rnd .. min(rnd +
chunk_rounds, cap)`` off its own round counter, so lanes at different
rounds (continuous refill) each advance one stride a chunk. On the CPU a
lane's chunk runs in growing pieces that stop at its termination (the
one-shot engine's schedule, models/runner.py), since every round queued
past it would be computed; the rounds and state are the same, under the
overshoot contract.

Per-replica keys (the fold_in tag space of ops/faults.py):

- replica 0 uses the run's base key UNCHANGED, so replica 0 is bitwise the
  unbatched run with the same seed;
- replica r > 0 uses ``fold_in(base_key, REPLICA_TAG0 + r)``, a region
  disjoint from the round indices (< 2**30), CRASH_TAG and _LEADER_TAG;
- batch FILLER lanes (a batch padded to its lane count) use
  ``fold_in(keys[0], LANE_FILLER_TAG0 + lane)``, the slice of the replica
  region just above MAX_REPLICAS. Filler lanes start done and run zero
  rounds.

The crash plane is a function of the CONFIG (``PRNGKey(cfg.seed)``), so
all replicas share one death plane; replicas vary the message and partner
streams (and the gossip leader), not the churn.

A done lane is frozen bitwise: it is skipped, and a chunk queued past its
termination is a no-op under the overshoot contract. The fused tiers do
not grow a lane dimension: the sweep always runs the chunked engine, and
engine='fused' is refused.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import MAX_REPLICAS, SimConfig
from ..ops import rng
from ..ops import telemetry as telemetry_mod
from ..ops.topology import Topology
from ..serving import keys as keys_mod
from ..serving import pool as pool_mod
from ..utils.device import resolve_device
from ..utils.metrics import RUN_RECORD_SCHEMA_VERSION
from . import gossip as gossip_mod
from . import pipeline as pipeline_mod
from . import pushsum as pushsum_mod
from .runner import _FIRST_CHUNK, _make_chunk_fn, draw_leader

# First replica tag: above the round-index region (< 2**30) and the
# churn-plane tags, below _LEADER_TAG (2**31 - 1). Replica 0 has NO tag: it
# rides the base key itself.
REPLICA_TAG0 = 2**30 + 2**29

# First batch-filler tag: the replica-region slice just above the real
# replica tags, so a filler lane's stream never meets a real lane's.
LANE_FILLER_TAG0 = REPLICA_TAG0 + MAX_REPLICAS


def replica_keys(base_key, replicas: int) -> list:
    """Per-replica base keys (int64 [2] tensors). Replica 0 IS base_key
    (bitwise the unbatched run); replica r > 0 folds REPLICA_TAG0 + r."""
    if not (1 <= replicas <= MAX_REPLICAS):
        raise ValueError(
            f"replicas must be in [1, {MAX_REPLICAS}], got {replicas}"
        )
    return [base_key] + [
        rng.fold_in(base_key, REPLICA_TAG0 + r) for r in range(1, replicas)
    ]


def _mean_ci95(values) -> tuple[Optional[float], Optional[float]]:
    """(mean, half-width of the normal-approximation 95% CI), None mean on
    empty input, None CI below two samples."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return None, None
    mean = sum(vals) / len(vals)
    if len(vals) < 2:
        return mean, None
    var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
    return mean, 1.96 * math.sqrt(var / len(vals))


@dataclasses.dataclass
class SweepResult:
    """Aggregate of one batch of lanes (one configuration, R keys).

    ``rounds``/``converged``/``outcome`` are per lane (replica 0 first —
    bitwise the unbatched run). ``final_states`` holds each lane's
    canonical protocol state (CPU tensors) and ``telemetry`` each lane's
    TelemetryTrajectory under cfg.telemetry; both are data, excluded from
    ``to_record``."""

    algorithm: str
    topology: str
    semantics: str
    n_requested: int
    population: int
    target_count: int
    replicas: int
    rounds: list
    converged: list
    outcome: list
    compile_s: float
    run_s: float
    schema_version: int = RUN_RECORD_SCHEMA_VERSION
    rounds_mean: Optional[float] = None
    rounds_ci95: Optional[float] = None
    estimate_mae: Optional[list] = None  # push-sum only, per replica
    estimate_mae_mean: Optional[float] = None
    estimate_mae_ci95: Optional[float] = None
    true_mean: Optional[float] = None
    final_states: Optional[list] = None
    telemetry: Optional[list] = None
    # The batch's lane count — >= replicas; the difference is filler lanes.
    lanes: Optional[int] = None
    # Warm-engine pool verdict for this batch's engine: "hit" or "miss".
    engine_cache: Optional[str] = None
    # The caller's deadline cancelled the batch at a chunk boundary: lanes
    # still unconverged carry outcome="deadline_exceeded" with their
    # partial state; converged lanes keep their full results.
    cancelled: bool = False

    @property
    def wall_ms(self) -> float:
        return self.run_s * 1e3

    @property
    def all_converged(self) -> bool:
        return all(self.converged)

    def to_record(self) -> dict:
        rec = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("final_states", "telemetry")
        }
        rec["wall_ms"] = self.wall_ms
        rec["wall_ms_per_replica"] = self.wall_ms / max(self.replicas, 1)
        rec["all_converged"] = self.all_converged
        return rec


def _reject_unsupported(cfg: SimConfig) -> None:
    if cfg.reference:
        raise ValueError(
            "replica sweeps vmap the batched synchronous-round engines; "
            "reference semantics (single-walk push-sum, Q1 population) has "
            "no batched replica axis — use batched semantics"
        )
    if cfg.engine == "fused":
        raise ValueError(
            "engine='fused' does not apply to replica sweeps: the Pallas "
            "tiers opt out of the batch dimension (plan/tiering gate); the "
            "sweep always runs the chunked XLA engines — drop the engine "
            "override"
        )
    if cfg.n_devices is not None and cfg.n_devices > 1:
        raise ValueError(
            "replica sweeps are single-device (the replica axis IS the "
            "parallelism); drop n_devices or run replicas unbatched"
        )
    if cfg.stall_chunks:
        raise ValueError(
            "stall_chunks watchdog semantics are per-run; a batched sweep "
            "has no single progress gap to watch — run stall diagnostics "
            "unbatched"
        )
    if cfg.mass_tolerance is not None:
        raise ValueError(
            "the health sentinel (mass_tolerance) carries one per-run "
            "health scalar through the chunk loop; a batched sweep has no "
            "per-replica outcome channel for it — run health-sentinel "
            "diagnostics unbatched"
        )


def _host_key_data(key_or_seed) -> np.ndarray:
    """uint32[2] raw key data for one lane. An int is a seed: below 2**32
    the threefry seeding layout is ``[0, seed]``, what
    ``jax.random.PRNGKey(seed)`` holds; a larger seed splits into its high
    and low words (``rng.PRNGKey``). A key (int64 [2], ``rng``'s layout)
    is taken as it is."""
    if isinstance(key_or_seed, (int, np.integer)):
        s = int(key_or_seed)
        if s < 0:
            raise ValueError(f"seeds must be >= 0, got {s}")
        if s < 2**32:
            return np.array([0, s], np.uint32)
        key_or_seed = rng.PRNGKey(s)
    kd = np.asarray(torch.as_tensor(key_or_seed).cpu(), dtype=np.int64).reshape(-1)
    if kd.shape != (2,) or ((kd < 0) | (kd > rng.MASK)).any():
        raise ValueError(f"a key is two uint32 words, got {kd.tolist()}")
    return kd.astype(np.uint32)


@dataclasses.dataclass
class Lanes:
    """The state of a batch's lanes on the engine's device: the protocol
    state's planes ``[R, n]``, the ring ``[R, D, 2, n]`` (push-sum) or
    ``[R, D, n]`` (gossip) under the delay ring, the round counters (int32)
    and done flags ``[R]``, and the key data ``[R, 2]`` (int64 holding
    uint32 words, on the host, where the wrappers take their keys).
    ``rnd_host``/``done_host`` mirror the counters as of the last boundary."""

    state: object
    ring: Optional[torch.Tensor]
    rnd: torch.Tensor
    done: torch.Tensor
    kd: torch.Tensor
    rnd_host: np.ndarray
    done_host: np.ndarray

    def carry(self, lane: int):
        """Lane ``lane``'s carry, views of its rows, as the chunked engine
        takes it."""
        proto = type(self.state)(*(x[lane] for x in self.state))
        if self.ring is None:
            return proto
        return pipeline_mod.Ringed(proto, self.ring[lane])

    def store(self, lane: int, carry) -> None:
        """Write a lane's carry back into its rows."""
        for dst, src in zip(self.state, pipeline_mod.proto_of(carry)):
            dst[lane].copy_(src)
        if self.ring is not None:
            self.ring[lane].copy_(carry.ring)

    def sync(self) -> None:
        """Read the counters to the host: the boundary's one read."""
        self.rnd_host = self.rnd.cpu().numpy().astype(np.int64)
        self.done_host = self.done.cpu().numpy().astype(bool)


class BatchEngine:
    """One engine of the batch: the chunked engine's chunk function for
    (topo, cfg) on ``device`` and everything built once for it, serving
    ``lanes`` lanes. Built by ``_batch_engine`` and kept in the pool."""

    def __init__(self, topo: Topology, cfg: SimConfig, lanes: int, device):
        self.topo, self.cfg, self.lanes, self.device = topo, cfg, lanes, device
        self.n = topo.n
        self.pushsum = cfg.algorithm == "push-sum"
        self.target = cfg.resolved_target_count(topo.n, topo.target_count)
        self.stride = cfg.chunk_rounds
        self.chunk_fn, _ = _make_chunk_fn(topo, cfg, rng.PRNGKey(cfg.seed),
                                          device, self.target)

    def fresh(self, kd) -> tuple:
        """One lane's start state from its key data — the ONE home of
        per-lane initialization, shared by ``init`` and ``refill``: push-sum
        (s, w) = (i, 1); gossip's leader drawn from the lane's key as
        ``draw_leader`` does; an empty ring."""
        key = torch.as_tensor(np.asarray(kd, np.int64))
        if self.pushsum:
            st = pushsum_mod.init_state(self.n, self.cfg.initial_term_round,
                                        self.device)
        else:
            st = gossip_mod.init_state(self.n, draw_leader(key, self.topo, self.cfg),
                                       False, self.device)
        ring = None
        D = self.cfg.delay_rounds
        if D:
            ring = (torch.zeros(D, 2, self.n, dtype=torch.float32, device=self.device)
                    if self.pushsum else
                    torch.zeros(D, self.n, dtype=torch.int32, device=self.device))
        return st, ring

    def init(self, kd_padded: np.ndarray, n_requests: int) -> Lanes:
        """Every lane's start state and key data: filler lanes (index >=
        n_requests) swap in keys folded from the LANE_FILLER_TAG0 region
        off lane 0's key, and start done."""
        kd = np.array(kd_padded, dtype=np.int64).reshape(self.lanes, 2)
        key0 = torch.as_tensor(kd[0])
        for lane in range(n_requests, self.lanes):
            kd[lane] = rng.fold_in(key0, LANE_FILLER_TAG0 + lane).numpy()
        states = [self.fresh(kd[lane]) for lane in range(self.lanes)]
        proto = type(states[0][0])(*(torch.stack(planes) for planes in
                                     zip(*(st for st, _ in states))))
        ring = (None if states[0][1] is None
                else torch.stack([r for _, r in states]))
        done = np.arange(self.lanes) >= n_requests
        return Lanes(
            state=proto, ring=ring,
            rnd=torch.zeros(self.lanes, dtype=torch.int32, device=self.device),
            done=torch.from_numpy(done).to(self.device),
            kd=torch.from_numpy(kd), rnd_host=np.zeros(self.lanes, np.int64),
            done_host=done.copy())

    def refill(self, lanes: Lanes, kd_new: np.ndarray, refill: np.ndarray,
               kill: np.ndarray) -> None:
        """Continuous refill, in place: a lane under ``refill`` takes
        ``fresh`` of its new key data, round 0, not done; a lane under
        ``kill`` (its deadline expired) is marked done, so it is frozen
        until a refill reclaims it. Every other lane is untouched."""
        for lane in np.nonzero(refill)[0]:
            lane = int(lane)
            st, ring = self.fresh(kd_new[lane])
            lanes.store(lane, st if ring is None else pipeline_mod.Ringed(st, ring))
            lanes.kd[lane] = torch.as_tensor(np.asarray(kd_new[lane], np.int64))
            lanes.rnd[lane] = 0
            lanes.done[lane] = False
        for lane in np.nonzero(kill & ~refill)[0]:
            lanes.done[int(lane)] = True
        lanes.sync()

    def _run_lane(self, lanes: Lanes, lane: int, start: int, end: int):
        """Rounds start .. end of one lane under its key; returns the rows
        of the rounds it executed under cfg.telemetry (a device tensor),
        else None. On the card one call of the chunk function; on the CPU
        growing pieces that stop at the lane's termination."""
        key = lanes.kd[lane]
        carry = lanes.carry(lane)
        status = torch.stack((lanes.rnd[lane], lanes.done[lane].to(torch.int32)))
        pieces = []
        at = start
        while True:
            stop = end if self.device.type != "cpu" else min(
                end, at + min(self.stride, max(_FIRST_CHUNK, (at - start) // 4)))
            carry, status, *rows = self.chunk_fn(carry, status, at, stop, key=key)
            if rows:
                pieces.append(rows[0])
            at = stop
            if at >= end or self.device.type != "cpu" or bool(status[1]):
                break
        lanes.store(lane, carry)
        lanes.rnd[lane] = status[0]
        lanes.done[lane] = status[1] != 0
        if not pieces:
            return None
        return torch.cat(pieces) if len(pieces) > 1 else pieces[0]

    def chunk(self, lanes: Lanes, cap: int) -> dict:
        """One chunk of every live lane (not done, round below ``cap``), in
        lane order on one stream, then the boundary's read. Returns
        {lane: rows of the rounds it executed} under cfg.telemetry."""
        ran = {}
        before = lanes.rnd_host.copy()
        for lane in range(self.lanes):
            start = int(before[lane])
            if lanes.done_host[lane] or start >= cap:
                continue
            ran[lane] = self._run_lane(lanes, lane, start,
                                       min(start + self.stride, cap))
        lanes.sync()
        if not self.cfg.telemetry:
            return {}
        out = {}
        for lane, rows in ran.items():
            executed = int(lanes.rnd_host[lane] - before[lane])
            if executed > 0:
                out[lane] = rows[:executed].cpu().numpy().astype(np.float32)
        return out

    def warm(self, lanes: Lanes) -> None:
        """Build the kernels and run one real round of lane 0 on a copy,
        discarded (the timed loop recomputes it off the absolute-round key
        stream)."""
        carry = lanes.carry(0)
        copy = type(carry)(*(x.clone() if isinstance(x, torch.Tensor)
                             else type(x)(*(y.clone() for y in x)) for x in carry))
        status = torch.zeros(2, dtype=torch.int32, device=self.device)
        self.chunk_fn(copy, status, 0, min(1, self.cfg.max_rounds), key=lanes.kd[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _batch_engine(topo: Topology, cfg: SimConfig, lanes: int, device):
    """Build (or fetch warm) the batch engine for one (canonical engine
    key, lane count) on ``device``. Returns ``(engine, cache_hit)``."""
    return pool_mod.default_pool().get_or_build(
        ("batch-engine", keys_mod.canonical_key(cfg, topo, device), lanes),
        lambda: BatchEngine(topo, cfg, lanes, device),
    )


def _protos_host(lanes: Lanes):
    """The protocol state's planes on the host, one copy a plane (a copy
    on the CPU too: the lanes' rows change under later chunks and
    refills)."""
    return type(lanes.state)(*(x.to("cpu", copy=True) for x in lanes.state))


def _lane_state(protos, lane: int):
    return type(protos)(*(x[lane] for x in protos))


def _estimate_mae(s, w, conv) -> tuple:
    """(true mean, per-lane estimate_mae) of push-sum planes ``[R, n]`` on
    the host, in float64 numpy (the JAX sweep's epilogue)."""
    n = s.shape[-1]
    true_mean = (n - 1) / 2.0
    s = np.asarray(s, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    conv = np.asarray(conv)
    w_safe = np.where(w != 0, w, 1)
    err = np.where(conv, np.abs(s / w_safe - true_mean), 0.0)
    counts = np.maximum(conv.sum(axis=-1), 1)
    return true_mean, err.sum(axis=-1) / counts


def run_batched_keys(
    topo: Topology,
    cfg: SimConfig,
    keys: list,
    lanes: Optional[int] = None,
    keep_states: bool = True,
    deadline: Optional[float] = None,
    device=None,
) -> SweepResult:
    """Run ``len(keys)`` independent simulations of one engine class as
    the lanes of one batch — lane ``i`` rides ``keys[i]`` (a seed or a
    key) as its base key, so it is bitwise the one-shot
    ``models.runner.run`` with that key.

    ``lanes`` pads the batch (lane-count bucketing): lanes beyond
    ``len(keys)`` are FILLER — keys from the LANE_FILLER_TAG0 region, done
    at entry so they run zero rounds. The engine comes from the warm pool
    (serving/pool.py) keyed by the canonical engine key + lane count.

    ``deadline`` (absolute ``time.monotonic`` seconds) is checked at every
    retired chunk: a fired deadline stops the batch there, and lanes still
    unconverged get ``outcome="deadline_exceeded"`` with their partial
    state and telemetry (``SweepResult.cancelled``). ``device`` is "cuda"
    (the default) or "cpu", as for ``runner.run``."""
    _reject_unsupported(cfg)
    device = resolve_device(device)
    requests = len(keys)
    if requests < 1:
        raise ValueError("run_batched_keys needs at least one base key")
    if lanes is None:
        lanes = requests
    if not (requests <= lanes <= MAX_REPLICAS):
        raise ValueError(
            f"lanes must be in [len(keys)={requests}, {MAX_REPLICAS}], "
            f"got {lanes}"
        )
    engine, cache_hit = _batch_engine(topo, cfg, lanes, device)
    kd = np.stack([_host_key_data(k) for k in keys]
                  + [_host_key_data(keys[0])] * (lanes - requests))
    state = engine.init(kd, requests)

    t0 = time.perf_counter()
    if not cache_hit:
        engine.warm(state)
    compile_s = time.perf_counter() - t0

    trajs = [[] for _ in range(requests)] if cfg.telemetry else None
    rounds_end = 0
    cancelled = False
    t1 = time.perf_counter()
    while True:
        rounds_end = min(rounds_end + cfg.chunk_rounds, cfg.max_rounds)
        rows = engine.chunk(state, cfg.max_rounds)
        for lane, r in rows.items():
            if lane < requests:
                trajs[lane].append(r)
        if state.done_host.all() or rounds_end >= cfg.max_rounds:
            break
        if deadline is not None and time.monotonic() >= deadline:
            # The overshoot contract makes a retired chunk a safe cancel
            # point: unconverged lanes report deadline_exceeded below.
            cancelled = True
            break
    run_s = time.perf_counter() - t1

    rounds_np = state.rnd_host[:requests]
    done_np = state.done_host[:requests]
    protos = _protos_host(state)
    target = engine.target
    result = SweepResult(
        algorithm=cfg.algorithm,
        topology=topo.kind,
        semantics=cfg.semantics,
        n_requested=topo.n_requested,
        population=topo.n,
        target_count=target,
        replicas=requests,
        rounds=[int(r) for r in rounds_np],
        converged=[bool(d) for d in done_np],
        outcome=[
            "converged" if bool(d)
            else ("deadline_exceeded" if cancelled else "max_rounds")
            for d in done_np
        ],
        compile_s=compile_s,
        run_s=run_s,
        lanes=lanes,
        engine_cache="hit" if cache_hit else "miss",
        cancelled=cancelled,
    )
    result.rounds_mean, result.rounds_ci95 = _mean_ci95(result.rounds)
    if cfg.telemetry:
        result.telemetry = [
            telemetry_mod.TelemetryTrajectory(
                start_round=0,
                data=(np.concatenate(t) if t
                      else np.zeros((0, telemetry_mod.N_COLS), np.float32)),
            )
            for t in trajs
        ]
    if keep_states:
        result.final_states = [_lane_state(protos, r) for r in range(requests)]
    if cfg.algorithm == "push-sum":
        result.true_mean, mae = _estimate_mae(
            protos.s[:requests].numpy(), protos.w[:requests].numpy(),
            protos.conv[:requests].numpy())
        result.estimate_mae = [float(e) for e in mae]
        result.estimate_mae_mean, result.estimate_mae_ci95 = _mean_ci95(
            result.estimate_mae
        )
    return result


@dataclasses.dataclass
class LaneTicket:
    """One request offered to the lane server. ``key`` is a seed (or a
    key) — the lane's base key, as a ``run_batched_keys`` lane.
    ``deadline`` is an absolute ``time.monotonic`` bound checked on the
    host at every chunk boundary; an expired lane is retired with
    ``outcome="deadline_exceeded"`` and its slot reclaimed. ``tag`` is the
    caller's."""

    key: object
    tag: object = None
    deadline: Optional[float] = None


@dataclasses.dataclass
class LaneResult:
    """One retired lane's result, delivered through ``source.on_result``
    at the chunk boundary the lane retired."""

    slot: int
    rounds: int
    converged: bool
    outcome: str  # converged | max_rounds | deadline_exceeded
    state: Optional[object] = None  # the protocol state, CPU tensors
    telemetry: Optional[object] = None  # TelemetryTrajectory
    target_count: int = 0
    estimate_mae: Optional[float] = None  # push-sum only
    true_mean: Optional[float] = None
    engine_cache: Optional[str] = None
    t_fill: float = 0.0  # monotonic time the lane was seeded/refilled
    lanes: int = 0
    occupancy: int = 0  # occupied lanes at the retiring boundary


@dataclasses.dataclass
class LaneServeSummary:
    """Aggregate of one ``serve_lanes`` acquisition."""

    served: int = 0  # results delivered (initial fill + refills)
    refills: int = 0  # lanes reclaimed mid-run for fresh requests
    chunks: int = 0  # chunk dispatches
    occupancy_sum: int = 0  # Σ occupied lanes over boundaries
    lanes: int = 0
    engine_cache: Optional[str] = None
    abandoned: bool = False  # the source told the loop to stop observing
    run_s: float = 0.0
    compile_s: float = 0.0


def _lane_result(slot, occupants, rnd_np, protos, outcome, cfg, topo,
                 lanes, occupancy, engine_cache, target):
    occ = occupants[slot]
    state = _lane_state(protos, slot)
    res = LaneResult(
        slot=slot,
        rounds=int(rnd_np[slot]),
        converged=outcome == "converged",
        outcome=outcome,
        state=state,
        target_count=target,
        engine_cache=engine_cache,
        t_fill=occ["t_fill"],
        lanes=lanes,
        occupancy=occupancy,
    )
    if occ["trajs"] is not None:
        res.telemetry = telemetry_mod.TelemetryTrajectory(
            start_round=0,
            data=(np.concatenate(occ["trajs"]) if occ["trajs"]
                  else np.zeros((0, telemetry_mod.N_COLS), np.float32)),
        )
    if cfg.algorithm == "push-sum":
        # Same float64 numpy formula as SweepResult's epilogue.
        res.true_mean, mae = _estimate_mae(state.s.numpy(), state.w.numpy(),
                                           state.conv.numpy())
        res.estimate_mae = float(mae)
    return res


def _poll(source, free: int) -> list:
    tickets = source.poll(free)
    if len(tickets) > free:
        raise ValueError(
            f"source.poll returned {len(tickets)} tickets for {free} free "
            "lanes — excess tickets would be silently dropped"
        )
    return tickets


def serve_lanes(topo: Topology, cfg: SimConfig, source, lanes: int,
                device=None) -> LaneServeSummary:
    """Continuous batching: run the batch engine as a lane server fed by
    ``source``, the host-side admission adapter:

    - ``source.poll(slots) -> list[LaneTicket]`` — up to ``slots`` fresh
      same-bucket requests; an empty list means nothing to refill with
      right now (the loop keeps draining the occupied lanes);
    - ``source.on_result(ticket, LaneResult)`` — a lane RETIRED at a chunk
      boundary (converged, hit max_rounds, or its deadline expired);
    - ``source.on_boundary(active, lanes) -> bool`` — a heartbeat at every
      boundary; False abandons the acquisition.

    The loop exits when no lane is occupied and ``poll`` returns nothing.
    Every decision in it is host-side and clock-only. A lane's streams are
    a function of its key and the absolute round index alone, so a
    refilled lane is bitwise the one-shot ``runner.run`` of its request,
    whatever its batch-mates do. ``device`` as for ``run_batched_keys``."""
    _reject_unsupported(cfg)
    device = resolve_device(device)
    if not (1 <= lanes <= MAX_REPLICAS):
        raise ValueError(
            f"lanes must be in [1, {MAX_REPLICAS}], got {lanes}"
        )
    engine, cache_hit = _batch_engine(topo, cfg, lanes, device)
    target = engine.target
    engine_cache = "hit" if cache_hit else "miss"
    summary = LaneServeSummary(lanes=lanes, engine_cache=engine_cache)

    tickets = _poll(source, lanes)
    if not tickets:
        return summary
    t_now = time.monotonic()
    occupants: list = [None] * lanes
    for i, t in enumerate(tickets):
        occupants[i] = {"ticket": t, "t_fill": t_now,
                        "trajs": [] if cfg.telemetry else None}
    kd = np.stack([_host_key_data(t.key) for t in tickets]
                  + [_host_key_data(tickets[0].key)] * (lanes - len(tickets)))
    state = engine.init(kd, len(tickets))

    t0 = time.perf_counter()
    if not cache_hit:
        engine.warm(state)
    summary.compile_s = time.perf_counter() - t0

    false_mask = np.zeros(lanes, bool)
    t1 = time.perf_counter()
    while True:
        rows = engine.chunk(state, cfg.max_rounds)
        rnd_np, done_np = state.rnd_host, state.done_host
        summary.chunks += 1
        for slot, r in rows.items():
            if occupants[slot] is not None:
                occupants[slot]["trajs"].append(r)
        now = time.monotonic()
        retiring: list = []  # (slot, outcome)
        for slot, occ in enumerate(occupants):
            if occ is None:
                continue
            if done_np[slot]:
                retiring.append((slot, "converged"))
            elif rnd_np[slot] >= cfg.max_rounds:
                retiring.append((slot, "max_rounds"))
            elif (occ["ticket"].deadline is not None
                  and now >= occ["ticket"].deadline):
                # The lane is frozen by the kill mask below and its
                # partial-but-exact result handed out now.
                retiring.append((slot, "deadline_exceeded"))
        killed = [s for s, o in retiring if o == "deadline_exceeded"]
        if retiring:
            occupancy = sum(o is not None for o in occupants)
            protos = _protos_host(state)
            for slot, outcome in retiring:
                occ = occupants[slot]
                res = _lane_result(
                    slot, occupants, rnd_np, protos, outcome, cfg, topo,
                    lanes, occupancy, engine_cache, target,
                )
                occupants[slot] = None
                summary.served += 1
                source.on_result(occ["ticket"], res)
        free = [i for i in range(lanes) if occupants[i] is None]
        fresh = _poll(source, len(free)) if free else []
        if fresh or killed:
            refill_mask = false_mask.copy()
            kill_mask = false_mask.copy()
            kill_mask[killed] = True
            kd_new = state.kd.numpy().copy()
            t_now = time.monotonic()
            for slot, t in zip(free, fresh):
                refill_mask[slot] = True
                kd_new[slot] = _host_key_data(t.key)
                occupants[slot] = {"ticket": t, "t_fill": t_now,
                                   "trajs": [] if cfg.telemetry else None}
            engine.refill(state, kd_new, refill_mask, kill_mask)
            summary.refills += len(fresh)
        active = sum(o is not None for o in occupants)
        summary.occupancy_sum += active
        if not source.on_boundary(active, lanes):
            summary.abandoned = True
            break
        if active == 0:
            break
    summary.run_s = time.perf_counter() - t1
    return summary


def run_replicas(
    topo: Topology,
    cfg: SimConfig,
    replicas: int,
    key=None,
    keep_states: bool = True,
    device=None,
) -> SweepResult:
    """Run ``replicas`` seeds of one configuration as the lanes of one
    batch. Replica 0 is bitwise ``models.runner.run`` with the same key;
    replica r > 0 folds REPLICA_TAG0 + r. A thin front end over
    ``run_batched_keys`` — the replica keys ARE the batch lanes."""
    if key is None:
        key = rng.PRNGKey(cfg.seed)
    return run_batched_keys(
        topo, cfg, replica_keys(key, replicas), keep_states=keep_states,
        device=device,
    )
