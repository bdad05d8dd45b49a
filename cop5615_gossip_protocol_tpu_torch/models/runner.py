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
  a CUDA device and its plain torch version on the CPU; pool, stencil and
  imp pool delivery run one torch round per step. Its chunks keep their
  (rounds, done) status on the device, so a chunk is queued with no host
  read and the pipeline reads the status once a chunk;
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
    # final canonical PushSumState/GossipState.
    chunk_log: Optional[list] = None
    state: Optional[object] = None

    @property
    def wall_ms(self) -> float:
        """Steady-state run wall-clock in ms (excludes build and warmup)."""
        return self.run_s * 1e3

    def to_record(self) -> dict:
        rec = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("chunk_log", "state")
        }
        rec["wall_ms"] = self.wall_ms
        rec["rounds_per_sec"] = self.rounds / self.run_s if self.run_s > 0 else None
        rec["residual_s"] = (
            self.run_s - self.dispatch_s - self.fetch_s - self.hook_s
        )
        return rec


def draw_leader(base_key, topo: Topology, cfg: SimConfig) -> int:
    """Leader in [0, nodes): the reference's Random().Next(0, nodes), where
    nodes excludes the Q1 extra actor (program.fs:173)."""
    upper = int(topo.target_count if cfg.reference else topo.n)
    return int(rng.randint(rng.fold_in(base_key, _LEADER_TAG), (), 0, upper))


def resolve_delivery(topo: Topology, cfg: SimConfig) -> str:
    """The chunked round's delivery (the JAX runner's
    ``resolve_deliver_fn``): "pool" when asked for, stencil (masked
    circular shifts) where the topology has a small displacement set and
    the delivery is not "scatter", scatter-add otherwise."""
    if cfg.delivery == "pool":
        return "pool"
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
    status, start, end) -> (state, status), state0): rounds start..end
    under the overshoot contract, ``status`` an int32 [2] (rounds, done)
    tensor on the device, so a chunk queues its rounds with no host read.
    Fault-free.

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
    (``imp_pool_parts``, ``deliver_imp_pool``)."""
    n = topo.n
    pushsum = cfg.algorithm == "push-sum"
    if pushsum:
        state0 = pushsum_mod.init_state(n, cfg.initial_term_round, device)
    else:
        state0 = gossip_mod.init_state(
            n, draw_leader(base_key, topo, cfg),
            cfg.reference and topo.kind == "full", device)

    if resolve_delivery(topo, cfg) == "scatter":
        graph = scatter.scatter_graph(topo, device)
        if pushsum:
            fn = functools.partial(scatter.pushsum_scatter_chunk, graph=graph,
                                   target=target, delta=cfg.resolved_delta,
                                   term_rounds=cfg.term_rounds)
        else:
            fn = functools.partial(scatter.gossip_scatter_chunk, graph=graph,
                                   target=target,
                                   rumor_target=cfg.resolved_rumor_target,
                                   suppress=cfg.resolved_suppress)

        def scatter_chunk(state, status, start, end):
            return fn(state, fused.round_keys(base_key, start, max(end - start, 0)),
                      status)

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

        def deliver_parts(round_idx: int):
            kr = sampling.round_key(base_key, round_idx)
            d, is_extra, choice, offs, _ = imp_pool_parts(
                topo, cfg, kr, disp_cols, degree, device)
            return lambda values: delivery_mod.deliver_imp_pool(
                values, d, is_extra, choice, lattice, offs.tolist())

    elif topo.implicit:
        send_ok = torch.ones(n, dtype=torch.bool, device=device)

        def deliver_parts(round_idx: int):
            kr = sampling.round_key(base_key, round_idx)
            offs = sampling.pool_offsets(kr, cfg.pool_size, n).tolist()
            choice = sampling.pool_choice_packed(kr, n, cfg.pool_size, device=device)
            return lambda values: delivery_mod.deliver_pool(values, choice, offs)

    else:
        neighbors = torch.from_numpy(topo.neighbors).to(device)
        degree = torch.from_numpy(topo.degree).to(device)
        send_ok = degree > 0
        offsets = [int(d) for d in topo.offsets]

        def deliver_parts(round_idx: int):
            kr = sampling.round_key(base_key, round_idx)
            bits = sampling.uniform_bits(kr, n, device=device)
            targets = sampling.targets_explicit(bits, neighbors, degree)
            return lambda values: delivery_mod.deliver_stencil(
                values, targets, offsets, n)

    if pushsum:
        delta, term_rounds = cfg.resolved_delta, cfg.term_rounds

        def round_fn(state, round_idx):
            deliver = deliver_parts(round_idx)
            s_send, w_send, s_keep, w_keep = pushsum_mod.halve_and_send(
                state.s, state.w, send_ok
            )
            inbox = deliver(torch.stack([s_send, w_send]))
            return pushsum_mod.absorb(
                state, s_keep, w_keep, inbox[0], inbox[1], delta, term_rounds
            )

    else:
        rumor_target, suppress = cfg.resolved_rumor_target, cfg.resolved_suppress

        def round_fn(state, round_idx):
            deliver = deliver_parts(round_idx)
            vals = gossip_mod.send_values(state, send_ok)
            inbox = deliver(vals[None])[0]
            return gossip_mod.absorb(state, inbox, rumor_target, suppress)

    def round_chunk(state, status, start, end):
        status = status.clone()
        for rnd in range(start, end):
            state = pipeline_mod.advance(state, round_fn(state, rnd), status, target)
        return state, status

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


def _host_done(state, target: int) -> bool:
    return bool(int(state.conv.sum()) >= target)


def _finalize_result(topo: Topology, cfg: SimConfig, state, rounds: int,
                     target: int, compile_s: float, run_s: float, done: bool,
                     loop, device) -> RunResult:
    """The result record from the final canonical state, on the host in
    float64 (diagnostics, never trajectory state)."""
    conv_np = state.conv.cpu().numpy()
    converged_count = int(conv_np.sum())
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
        outcome="converged" if done else "max_rounds",
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
    result.chunk_log = loop.chunk_log
    result.state = state
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
    engine, so it never fuses)."""
    if cfg.delivery == "pool" and topo.kind in IMP_LATTICE:
        reason = fused_imp.imp_fused_support(topo, cfg)
        if reason is not None and fused_imp_hbm.imp_hbm_support(topo, cfg) is None:
            return "imp_hbm", None
        return "imp", reason
    if cfg.delivery == "pool" and topo.implicit:
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
    if reason is None and cfg.delivery == "scatter":
        reason = ("delivery='scatter' runs the chunked engine (the fused "
                  "lattice tiers deliver by the stencil formulation)")
    return variant, reason


def sharded_tier(topo: Topology, cfg: SimConfig) -> tuple[str, Optional[str], str]:
    """The composition the JAX runner's ladder picks for an n_devices > 1
    config (models/runner.py of the JAX package), the reason it cannot run
    there (None if the JAX package would run it), and the ROADMAP item that
    ports it. ``engine="fused"`` on implicit ``full`` with pool delivery
    tries the VMEM replicated composition (``fused_pool_sharded``, up to
    the pool engine's 2**21 nodes) and then the replicated-pool2 one
    (``pool2_sharded``), else both plans' reasons; the imp kinds with pool
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
        plan_vmem = plan_fused_pool_sharded(topo, cfg, S)
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
        start_state=None, start_round: int = 0, devices=None) -> RunResult:
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
    run, every other refuses naming its ROADMAP item."""
    t_enter = time.perf_counter()
    sharded = cfg.n_devices is not None and cfg.n_devices > 1
    if devices is not None and not sharded:
        raise ValueError("devices places the shards of an n_devices > 1 run; "
                         f"n_devices is {cfg.n_devices}")
    if sharded:
        return _run_sharded(topo, cfg, key, device, devices, start_state,
                            start_round, t_enter)
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
                              start_round, target, t_enter, variant)
        if reason is None and device.type == "cuda":
            return _run_fused(topo, cfg, key, device, start_state,
                              start_round, target, t_enter, variant)
    return _run_chunked(topo, cfg, key, device, start_state, start_round,
                        target, t_enter)


def _run_sharded(topo, cfg, key, device, devices, start_state, start_round,
                 t_enter) -> RunResult:
    from ..parallel import mesh as mesh_mod
    from ..parallel.fused_hbm_sharded import run_stencil_hbm_sharded
    from ..parallel.fused_imp_hbm_sharded import run_imp_hbm_sharded
    from ..parallel.fused_sharded import run_fused_sharded
    from ..parallel.pool2_sharded import run_pool2_sharded

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
    return runs[tier](topo, cfg, mesh, key, start_state, start_round, t_enter)


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
                 t_enter) -> RunResult:
    """Chunk loop over the chunked engine: each chunk queues its rounds
    with the (rounds, done) status on the device, and the pipeline reads
    that status once a chunk."""
    chunk_fn, state0 = _make_chunk_fn(topo, cfg, key, device, target)
    if start_state is not None:
        state0 = _to_device(start_state, device)
    done0 = start_state is not None and _host_done(state0, target)
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
    warm = torch.tensor([start_round, 0], dtype=torch.int32, device=device)
    chunk_fn(state0, warm, start_round, min(start_round + 1, cfg.max_rounds))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0

    status0 = torch.tensor([start_round, int(done0)], dtype=torch.int32, device=device)
    K = cfg.chunk_rounds

    def next_end(end):
        # Chunks grow by a quarter of the rounds run so far, from
        # _FIRST_CHUNK up to chunk_rounds: the rounds queued past
        # termination (no-ops, but each still computed or launched) stay a
        # fraction of the run, at one status read a chunk.
        return end + min(K, max(_FIRST_CHUNK, (end - start_round) // 4))

    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=state0, status0=status0,
        start_round=start_round, max_rounds=cfg.max_rounds, stride=K,
        # The CPU runs a chunk as it is queued: a second chunk in flight
        # would only add no-op rounds.
        depth=cfg.pipeline_chunks if device.type == "cuda" else 1,
        next_end=next_end,
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    result = _finalize_result(topo, cfg, loop.state, loop.rounds, target,
                              compile_s, run_s, loop.done, loop, device)
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
    if variant in ("pool", "pool2"):
        layout = fused_pool.build_pool_layout(n)
        pushsum_chunk, gossip_chunk = (
            (fused_pool.pushsum_pool_chunk, fused_pool.gossip_pool_chunk)
            if variant == "pool" else
            (fused_pool2.pushsum_pool2_chunk, fused_pool2.gossip_pool2_chunk))
        common = {"n": n, "target": target}
    elif variant in ("imp", "imp_hbm"):
        layout = fused_pool.build_pool_layout(n)
        pushsum_chunk, gossip_chunk = (
            (fused_imp.pushsum_imp_chunk, fused_imp.gossip_imp_chunk)
            if variant == "imp" else
            (fused_imp_hbm.pushsum_imp_hbm_chunk, fused_imp_hbm.gossip_imp_hbm_chunk))
        common = {"spec": fused_imp.imp_spec(topo), "target": target}
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

    def streams(start, count):
        keys = fused.round_keys(key, start, count)
        if variant.startswith("stencil"):
            return (keys,)
        offs = fused_pool.round_offsets(key, start, count, cfg.pool_size, n)
        if variant in ("pool", "pool2"):
            return keys, offs
        return keys, offs, fused_imp.choice_round_keys(key, start, count)

    if cfg.algorithm == "push-sum":
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
               t_enter, variant) -> RunResult:
    """Chunk loop over a fused engine: one chunk call per cfg.chunk_rounds
    rounds, with the per-round streams drawn on the host (the wrappers
    copy them to the device without a sync)."""
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
        new_state, executed = chunk_fn(state, streams(start, K), start, round_end)
        expected = min(K, max(round_end - start, 0))
        ex = executed.to(torch.int64)
        new_status = torch.stack(
            [status[0] + ex, ((status[1] != 0) | (ex < expected)).to(torch.int64)]
        )
        return new_state, new_status

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
    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=state_dev, status0=status0,
        start_round=start_round, max_rounds=cfg.max_rounds, stride=K,
        depth=cfg.pipeline_chunks,
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    final = eng.to_canonical(loop.state)
    result = _finalize_result(topo, cfg, final, loop.rounds, target,
                              compile_s, run_s, _host_done(final, target),
                              loop, device)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result
