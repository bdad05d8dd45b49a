"""Fused x sharded lattices, the HBM-streaming tier: the counterpart of the
JAX package's parallel/fused_hbm_sharded.py, for shards past the resident
tier's 100 MB budget (torus3d 256**3 in 2 or 4 shards, any lattice up to
its HBM budget).

It computes the resident tier's function (parallel/fused_sharded.py) on the
same extended buffers, windows, wire, schedule and verdict, through its own
kernels (csrc/fused_stencil_hbm_shard.cu: a mark prologue and one launch a
round, queued by one call a shard a super-step,
``pushsum_stencil_hbm_shard_superstep`` and
``gossip_stencil_hbm_shard_superstep``), with the classes' rolls of the
JAX streaming plan (``_class_sigmas``: one roll per class on the non-wrap
lattices and on wrap lattices without pad lanes, the blend pair
otherwise). The plan (``plan_stencil_hbm_sharded``) is the JAX plan: its
halo, CR and processing tile PT, picked under the JAX kernel's VMEM-scratch
and HBM budgets, or its reason. The port's kernels do not stream TPU
windows, so PT only decides the geometry, as in the JAX package; the JAX
kernel's interior-first tile order (``_boundary_split``, ``_visit_order``)
overlaps its in-kernel halo DMA and changes no value, and the port's wire
is the copy wire of the JAX package's ``halo_dma`` "auto" off the TPU, so
neither is here. Chunks are CR * 8 rounds, as in the JAX run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

from ..config import SimConfig
from ..ops import fused_stencil_hbm as hbm
from ..ops.fused import LANES
from ..ops.fused_pool import build_pool_layout
from ..ops.topology import Topology
from . import mesh as mesh_mod
from .fused_sharded import (
    MAX_SUPERSTEP_ROUNDS,
    ShardGeometry,
    Tier,
    _common_gates,
    _signed_pad,
    check_superstep,
    functional_superstep,
    launch_superstep,
    protocol_kw,
    run_lattice_shards,
    run_plain,
)

_PT_CANDIDATES = (2048, 1024, 512, 256)
# The JAX plan's per-device budgets (set for its TPU): the resident planes
# in HBM and the streaming scratch in VMEM. Kept so the plan's geometry and
# ceilings are the JAX package's.
_HBM_PLANE_BUDGET = 12 * 2**30
_VMEM_SCRATCH_BUDGET = 80 * 2**20


def _class_sigmas(topo: Topology, layout):
    """Per class d: (d, sigma1, sigma2), the signed in-buffer sender
    offsets; sigma1 serves receivers at global flat >= d, sigma2 those
    below, and sigma2 is None where one offset is exact for every receiver:
    non-wrap lattices (their boundary masks kill every sender that would
    wrap) and wrap lattices without pad lanes (both coincide)."""
    _, wrap = hbm._lattice_params(topo)
    n_pad, N = layout.n_pad, layout.n
    out = []
    for d in (int(x) for x in topo.offsets):
        if wrap:
            s1 = _signed_pad(-d, n_pad)
            s2 = _signed_pad(N - d, n_pad)
            out.append((d, s1, None if s1 == s2 else s2))
        else:
            out.append((d, -(d if d <= N // 2 else d - N), None))
    return out


def _halo_width_slots(topo: Topology, layout) -> int:
    """Largest |in-buffer shift| of any class: the per-round advance of the
    stale rows from the extended buffer's ends."""
    return max(max(abs(s1), abs(s2 if s2 is not None else 0))
               for _, s1, s2 in _class_sigmas(topo, layout))


def _shard_delivery_plan(topo: Topology, layout, rows_ext: int, PT: int):
    """The JAX kernel's window plan over a rows_ext-row extended buffer:
    every class variant is a window need (roll e = -sigma mod n_ext), and
    needs within one PT-row tile share a window. Returns (classes, groups,
    M, blend) as the JAX function does; the plan's budgets read groups and
    M."""
    return _sigma_plan(tuple(_class_sigmas(topo, layout)), rows_ext, PT)


def _sigma_plan(sigmas: tuple, rows_ext: int, PT: int):
    n_ext = rows_ext * LANES
    blend = any(s2 is not None for _, _, s2 in sigmas)
    needs = []
    for ci, (d, s1, s2) in enumerate(sigmas):
        e1 = (-s1) % n_ext
        if s2 is None:
            needs.append((ci, d, e1, hbm._centered_sq(e1, rows_ext), None))
        else:
            e2 = (-s2) % n_ext
            needs.append((ci, d, e1, hbm._centered_sq(e1, rows_ext), True))
            needs.append((ci, d, e2, hbm._centered_sq(e2, rows_ext), False))
    classes, groups, M = hbm._plan_from_needs(
        needs, [d for d, _s1, _s2 in sigmas], PT, with_liveness=False)
    return classes, groups, M, blend


def class_rolls(topo: Topology, layout, n_ext: int) -> tuple:
    """Per class (d, e1, e2), the extended buffer's forward rolls of
    ``_class_sigmas`` (e2 = e1 where one offset serves every receiver)."""
    return tuple((d, (-s1) % n_ext, (-(s1 if s2 is None else s2)) % n_ext)
                 for d, s1, s2 in _class_sigmas(topo, layout))


@functools.lru_cache(maxsize=256)
def _fit(sigmas: tuple, rows_loc: int, w: int, pushsum: bool, cr: int):
    """(rows_ext, PT, H) of the JAX plan's tile pick at ``cr`` rounds a
    super-step, or None. Cached: the plan tries every PT at every CR, and a
    run, the ladder and the CLI each ask for it."""
    n_state = 4 if pushsum else 3
    h_min = -(-(cr * w) // LANES) + 1
    cands = []
    for pt in _PT_CANDIDATES:
        r = (-rows_loc) % pt
        if r % 2:
            continue  # 2H cannot hit an odd residue mod an even PT
        h = h_min + ((r // 2 - h_min) % (pt // 2))
        rows_ext = rows_loc + 2 * h
        if rows_ext // pt < 2 or h > rows_loc:
            continue
        _cls, grp, m_max, _bl = _sigma_plan(sigmas, rows_ext, pt)
        sum_m = sum(m for _, m, _l in grp)
        # Streaming scratch: own-state tiles + one window set per group.
        vmem = ((4 if pushsum else 3) * pt + sum_m * (3 if pushsum else 2)) * LANES * 4
        if vmem > _VMEM_SCRATCH_BUDGET:
            continue
        # Resident planes: margined and plain parities, the extended inputs
        # and the overlap schedule's carry.
        carry_rows = n_state * (rows_ext + rows_loc)
        hbm_bytes = ((4 if pushsum else 2) * (rows_ext + m_max) + 4 * rows_ext
                     + n_state * rows_ext + carry_rows) * LANES * 4
        if hbm_bytes > _HBM_PLANE_BUDGET:
            continue
        cands.append((rows_ext, pt, h))
    if not cands:
        return None
    # Largest PT whose halo waste stays within ~12% of the leanest.
    lean = min(c[0] for c in cands)
    ok = [c for c in cands if c[0] <= lean + max(lean // 8, 1)]
    return max(ok, key=lambda c: c[1])


def plan_stencil_hbm_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(H, rows_loc, CR, PT, layout) or a string reason why not: the JAX
    plan, its gates in its order (the port is one process drawing the
    partitionable stream, so the JAX threefry gate has nothing to refuse)."""
    if topo.implicit:
        return (
            "implicit (full) topology has no displacement structure for "
            "the halo composition; use delivery='pool' (the fused pool x "
            "sharded composition)"
        )
    if topo.kind in ("imp2d", "imp3d"):
        return (
            f"topology {topo.kind!r} carries a random long-range edge the "
            "halo composition cannot serve; use delivery='pool' (the "
            "imp x HBM x sharded composition, "
            "parallel/fused_imp_hbm_sharded.py)"
        )
    if topo.kind not in hbm._HBM_KINDS:
        return (
            f"topology {topo.kind!r} has no arithmetic displacement "
            f"columns (served kinds: {', '.join(hbm._HBM_KINDS)})"
        )
    if topo.offsets is None:
        return f"topology {topo.kind!r} has no small displacement set"
    reason = _common_gates(topo, cfg)
    if reason is not None:
        return reason
    layout = build_pool_layout(topo.n)
    R = layout.rows
    if R % n_dev != 0:
        return (
            f"padded layout ({R} rows) must split evenly; {n_dev} devices "
            "do not divide it"
        )
    rows_loc = R // n_dev
    w = _halo_width_slots(topo, layout)
    key = (tuple(_class_sigmas(topo, layout)), rows_loc, w,
           cfg.algorithm == "push-sum")
    CR = max(1, min(int(cfg.chunk_rounds), MAX_SUPERSTEP_ROUNDS))
    while CR > 1 and _fit(*key, CR) is None:
        CR //= 2
    b = _fit(*key, CR)
    if b is None:
        return (
            f"no processing-tile split fits: per-round halo ({w} slots) at "
            f"a {rows_loc}-row shard exceeds the shard, the VMEM streaming "
            "scratch, or the per-device HBM plane budget even at "
            "chunk_rounds=1; use the chunked collective engine"
        )
    _, PT, H = b
    return (H, rows_loc, CR, PT, layout)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# version (parallel/fused_sharded.shard_superstep_plain). The contract of
# parallel/fused_sharded.py's wrappers, without the barrier words.
# ---------------------------------------------------------------------------


def pushsum_stencil_hbm_shard_superstep(planes, out, y, mark, keys, rounds: int,
                                        row0: int, *, spec, rolls,
                                        geom: ShardGeometry, delta: float,
                                        term_rounds: int, u, ctrl,
                                        global_term: bool = False) -> None:
    """Up to CR push-sum rounds on one shard's extended (s, w, term, conv)
    planes into ``out``: rounds + 1 launches of
    csrc/fused_stencil_hbm_shard.cu (the mark prologue, then one a round)
    on CUDA tensors, the plain version on CPU ones. ``global_term`` runs
    the global-termination instance (u the middle's unstable counts)."""
    dev = check_superstep(planes, out, y, mark, keys, rounds, row0, spec, rolls,
                          geom, u, ctrl)
    if dev.type == "cpu":
        run_plain(planes, out, y, keys, rounds, row0, u, ctrl,
                  {"spec": spec, "rolls": rolls, "geom": geom, "delta": delta,
                   "term_rounds": term_rounds, "global_term": global_term})
        return
    launch_superstep("fused_stencil_hbm_shard",
                     "gossip_pushsum_stencil_hbm_shard_superstep", dev, planes, out,
                     y, mark, keys, rounds, row0, spec, rolls, geom,
                     (ctypes.c_float(delta), term_rounds, int(global_term)), u, ctrl)
    pushsum_stencil_hbm_shard_superstep.launches += rounds + 1


def gossip_stencil_hbm_shard_superstep(planes, out, y, mark, keys, rounds: int,
                                       row0: int, *, spec, rolls,
                                       geom: ShardGeometry, rumor_target: int,
                                       suppress: bool, u, ctrl) -> None:
    """Gossip analog of ``pushsum_stencil_hbm_shard_superstep``: (count,
    active, conv), receiver-side suppression."""
    dev = check_superstep(planes, out, y, mark, keys, rounds, row0, spec, rolls,
                          geom, u, ctrl)
    if dev.type == "cpu":
        run_plain(planes, out, y, keys, rounds, row0, u, ctrl,
                  {"spec": spec, "rolls": rolls, "geom": geom,
                   "rumor_target": rumor_target, "suppress": suppress})
        return
    launch_superstep("fused_stencil_hbm_shard",
                     "gossip_gossip_stencil_hbm_shard_superstep", dev, planes, out,
                     y, mark, keys, rounds, row0, spec, rolls, geom,
                     (rumor_target, int(suppress)), u, ctrl)
    gossip_stencil_hbm_shard_superstep.launches += rounds + 1


# Kernel launches queued by each wrapper (the prologue and one a round),
# counted where the kernel is launched and nowhere else.
pushsum_stencil_hbm_shard_superstep.launches = 0
gossip_stencil_hbm_shard_superstep.launches = 0


def _make_chunk(topo: Topology, cfg: SimConfig, H: int, rows_loc: int, layout,
                superstep):
    geom = ShardGeometry(layout.rows, H, rows_loc, 1)
    kw = protocol_kw(topo, cfg, geom,
                     class_rolls(topo, layout, geom.rows_ext * LANES))

    def chunk_fn(state, keys, row0, dev, start, cap):
        del dev  # row0 places the shard
        out, executed, u = functional_superstep(superstep, kw, state, keys,
                                                int(row0), int(start), int(cap), False)
        return tuple(x[H:H + rows_loc] for x in out), executed, u[:-1]

    return chunk_fn, geom.rows_ext


def make_pushsum_stencil_hbm_shard_chunk(topo: Topology, cfg: SimConfig, H: int,
                                         rows_loc: int, PT: int, layout):
    """``chunk_fn(state, keys, row0, dev, start, cap) -> (mid_state4,
    executed, u)``: up to K = keys.shape[0] push-sum rounds on one shard's
    extended (s, w, term, conv) planes, the JAX factory's contract (its
    XLA-wire form; PT is the plan's and the kernel does not tile). Returns
    (chunk_fn, rows_ext)."""
    del PT
    return _make_chunk(topo, cfg, H, rows_loc, layout,
                       pushsum_stencil_hbm_shard_superstep)


def make_gossip_stencil_hbm_shard_chunk(topo: Topology, cfg: SimConfig, H: int,
                                        rows_loc: int, PT: int, layout):
    """Gossip analog of ``make_pushsum_stencil_hbm_shard_chunk``."""
    del PT
    return _make_chunk(topo, cfg, H, rows_loc, layout,
                       gossip_stencil_hbm_shard_superstep)


def hbm_tier(topo: Topology, cfg: SimConfig, n_dev: int) -> Tier:
    """The streaming tier's Tier for this config, or ValueError with the
    plan's reason."""
    plan = plan_stencil_hbm_sharded(topo, cfg, n_dev)
    if isinstance(plan, str):
        raise ValueError(f"engine='fused' with n_devices={n_dev} unavailable: {plan}")
    H, rows_loc, CR, _PT, layout = plan
    geom = ShardGeometry(layout.rows, H, rows_loc, CR)
    return Tier(geom=geom, rolls=class_rolls(topo, layout, geom.rows_ext * LANES),
                stride=CR * 8, pushsum=pushsum_stencil_hbm_shard_superstep,
                gossip=gossip_stencil_hbm_shard_superstep, barrier=False,
                sources=("fused_stencil_hbm_shard", "fused_stencil_shard"))


def run_stencil_hbm_sharded(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh,
                            key, start_state=None, start_round: int = 0,
                            t_enter: Optional[float] = None, on_chunk=None):
    """Sharded streaming lattice run (engine='fused', n_devices > 1, past
    the resident tier's budget): parallel/fused_sharded.run_lattice_shards
    on this tier, chunks of CR * 8 rounds as in the JAX run."""
    return run_lattice_shards(topo, cfg, mesh, key, hbm_tier(topo, cfg, mesh.size),
                              start_state, start_round, t_enter, on_chunk)
