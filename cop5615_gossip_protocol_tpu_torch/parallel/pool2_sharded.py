"""Replicated-pool2: the full topology sharded over several devices, the
counterpart of the JAX package's parallel/pool2_sharded.py.

The state planes of the streaming pool tier (ops/fused_pool2.py: push-sum
s, w and the packed term|conv plane, gossip count and active) are
row-sharded: shard i owns global rows [i * rows_loc, (i + 1) * rows_loc)
of the pool layout's [R, 128] planes, on ``mesh.devices[i]``. One
super-step is one round:

1. the wire delivers each shard the windowed summary its pool slots read
   (raw s and w for push-sum, the active plane for gossip): the whole
   margin-extended copy (``all_gather``) or one band per slot at the
   slot's band start (``reduce_scatter``), parallel/halo.py's copies;
2. one launch per shard advances its rows one round, reading each slot's
   sources from that summary (csrc/fused_pool2_shard.cu, the kernels of
   ``pushsum_pool2_shard_round`` and ``gossip_pool2_shard_round``), and
   leaves its converged count u in a device slot;
3. the verdict sums the shards' u against the target on the device
   (parallel/overlap.py orders it, with the ``overlap_collectives`` knob).

Each output row is computed from the same inputs by the same operations as
the single-device streaming pool tier's, so a run is bitwise the port's
single-device pool2 run on either wire, at every shard count. The plan
(``plan_pool2_sharded``, ``band_margin``, ``band_starts``) is the JAX
plan's, so a config gets the JAX package's geometry and wire, or its
reason. On the CPU the wrappers run their plain torch versions; on CUDA
they launch the kernels. Fault operands (the drop gate, the death planes,
global termination) and ``delivery="matmul"`` are refused by the config
(ROADMAP A6, A7).
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import torch

from ..config import SimConfig
from ..ops import fused, fused_pool
from ..ops.fused import LANES
from ..ops.sampling import POOL_CHOICE_BITS
from ..ops.topology import Topology
from ..utils import kernels
from . import halo
from . import mesh as mesh_mod
from . import overlap as overlap_mod

# Processing-tile candidates of the JAX kernels, largest first: a shard's
# rows must be a multiple of one. The port's kernels do not tile, but the
# plan keeps the JAX geometry so both packages accept the same configs.
_PT_CANDIDATES = (2048, 1024, 512, 256)

# The JAX plan's per-device budget for the resident planes (12 GiB, set for
# its TPU); kept so the plan's ceilings are the JAX package's.
_HBM_PLANE_BUDGET = 12 * 2**30

# The push-sum term|conv plane of the streaming pool tier.
TC_CONV_BIT = 1 << 30
TC_TERM_MASK = TC_CONV_BIT - 1

# Rounds per chunk of the run's chunk loop (the JAX run's stride).
STRIDE = 8


def plan_pool2_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(rows_loc, PT, layout, wire) or a string reason why the composition
    can't run: the JAX plan. ``wire`` is "reduce_scatter" (per-slot bands)
    or "all_gather" (the whole copy), cfg.resolved_pool2_wire with auto
    demoting to the gather wire when the band margin exceeds a shard. The
    JAX plan's fault, dtype, telemetry and step-timing gates are the port
    config's own refusals (ROADMAP A6, A8, A12)."""
    if not topo.implicit:
        return (
            "the replicated-pool2 composition serves the implicit full "
            "topology only"
        )
    if cfg.delivery not in ("pool", "matmul"):
        return (
            "the replicated-pool2 composition requires delivery='pool' or "
            "delivery='matmul' (the same gate as the single-device pool "
            "engine dispatch; matmul runs the per-shard one-hot MXU blend "
            "after the one all_gather — the wire is unchanged)"
        )
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    layout = fused_pool.build_pool_layout(topo.n)
    R = layout.rows
    if R % n_dev != 0:
        return (
            f"padded layout ({R} rows) must split evenly; {n_dev} devices "
            "do not divide it"
        )
    rows_loc = R // n_dev
    PT = next((pt for pt in _PT_CANDIDATES if rows_loc % pt == 0), None)
    if PT is None:
        return (
            f"no processing tile divides the {rows_loc}-row shard "
            f"(candidates {_PT_CANDIDATES}); use fewer devices"
        )
    pushsum = cfg.algorithm == "push-sum"
    n_wp = 2 if pushsum else 1  # windowed summary planes (s, w | active)
    n_state = 3 if pushsum else 2  # s, w, tc | count, active
    M = PT + 16
    P = cfg.pool_size
    ME = band_margin(layout)
    wire = cfg.resolved_pool2_wire(n_dev)
    if wire == "reduce_scatter" and ME > rows_loc:
        if cfg.pool2_wire != "auto":
            return (
                f"the reduce_scatter band margin ({ME} rows) exceeds the "
                f"{rows_loc}-row shard — the margin ppermute reads ONE "
                "ring neighbor; use pool2_wire='all_gather' or fewer "
                "devices"
            )
        wire = "all_gather"
    own = 2 * n_state * rows_loc * LANES * 4
    if wire == "reduce_scatter":
        n_seg = halo.band_segments(rows_loc, n_dev)
        bands = n_wp * P * (rows_loc + ME) * LANES * 4
        scatter_buf = n_wp * (rows_loc + n_dev * (rows_loc // n_seg)) * LANES * 4
        carry = n_state * rows_loc * LANES * 4
        if bands + scatter_buf + own + carry > _HBM_PLANE_BUDGET:
            return (
                f"population {topo.n} exceeds the replicated-pool2 plane "
                f"budget (reduce_scatter wire): the per-slot summary "
                f"bands ({bands >> 20} MiB) plus the slot-group scatter "
                f"buffer ({scatter_buf >> 20} MiB), the shard planes and "
                f"the loop carry do not fit "
                f"{_HBM_PLANE_BUDGET >> 30} GiB per device"
            )
        return (rows_loc, PT, layout, wire)
    gathered = n_wp * (R + M) * LANES * 4
    carry = gathered + n_state * rows_loc * LANES * 4
    if gathered + own + carry > _HBM_PLANE_BUDGET:
        return (
            f"population {topo.n} exceeds the replicated-pool2 plane "
            f"budget: the gathered windowed copy ({gathered >> 20} MiB) "
            "plus the shard planes and the overlap carry do not fit "
            f"{_HBM_PLANE_BUDGET >> 30} GiB per device"
        )
    return (rows_loc, PT, layout, wire)


def band_margin(layout) -> int:
    """Band rows past the core shard on the reduce_scatter wire: 16 mirror
    rows, plus, at padded populations (Z = n_pad - n > 0), the 8-aligned
    slack between the d and d + Z variants' sources."""
    Z = layout.n_pad - layout.n
    dq = 0 if Z == 0 else ((Z // LANES + 8 + 7) // 8) * 8
    return 16 + dq


def band_starts(offs, layout) -> list:
    """Slot k's band start for one round's displacements: the band of the
    shard at row0 covers global rows [(row0 + base_k) mod R, + rows_loc +
    band_margin), base_k = align8(R - (d_k + Z) // 128 - 1)."""
    Z = layout.n_pad - layout.n
    R = layout.rows
    return [((R - (int(d) + Z) // LANES - 1) // 8) * 8 for d in offs]


# ---------------------------------------------------------------------------
# The delivered summary of one shard: ``sources[k]`` the planes slot k reads
# (push-sum (s, w), gossip (active,)), ``bases[k]`` where they start
# (csrc/pool2.cuh, wire_row). The all_gather wire gives every slot the same
# [R + PT + 16, 128] copy, whose row r is global row r: base (R - row0) mod R.
# ---------------------------------------------------------------------------


def gather_wire(windowed, PT: int, devices, pool_size: int) -> list:
    """Per destination shard (sources, bases) on the all_gather wire:
    ``windowed`` holds, per summary plane, its S shards."""
    rows_loc = windowed[0][0].shape[0]
    R = rows_loc * len(devices)
    copies = [halo.gather_rows(shards, PT + 16, devices) for shards in windowed]
    return [([tuple(c[s] for c in copies)] * pool_size,
             [(R - s * rows_loc) % R] * pool_size) for s in range(len(devices))]


def band_wire(windowed, offs, layout, devices) -> list:
    """Per destination shard (sources, bases) on the reduce_scatter wire:
    one band per slot and summary plane, at ``band_starts(offs)``."""
    rows_loc = windowed[0][0].shape[0]
    bases = band_starts(offs, layout)
    items = [(shards, base) for base in bases for shards in windowed]
    bands = halo.scatter_band_rows(items, rows_loc, band_margin(layout), devices)
    n_wp = len(windowed)
    return [([tuple(bands[s][k * n_wp:(k + 1) * n_wp]) for k in range(len(bases))],
             bases) for s in range(len(devices))]


# ---------------------------------------------------------------------------
# Plain versions: one shard's round in torch, on any device. They are what
# the kernels are held against, and what the wrappers run on CPU tensors.
# ---------------------------------------------------------------------------


def _slot_reads(keys, offs, wire, row0: int, rows_loc: int, R: int, n: int,
                device):
    """Per slot k, in order: (hit, at) over the shard's destinations, flat
    global j = row0 * 128 + local: hit where j is real and its mod-n source
    i chose slot k, ``at`` the flat index of i in slot k's summary."""
    j = row0 * LANES + torch.arange(rows_loc * LANES, dtype=torch.int64, device=device)
    k1k2 = torch.tensor([int(keys[0]), int(keys[1])], dtype=torch.int64)
    choice = fused_pool._choice_plane(k1k2.to(device), R, len(offs)).reshape(-1)
    _, bases = wire
    for k, d in enumerate(offs):
        src = torch.where(j >= d, j - d, j - d + n)
        ch = torch.where(src < n, choice[src], -1)
        hit = (ch == k) & (j < n)
        at = (((src >> 7) - row0 - bases[k] + 2 * R) % R) * LANES + (src & (LANES - 1))
        yield hit, at


def pushsum_pool2_shard_round_plain(planes, wire, keys, offs, row0: int, *,
                                    n: int, rows: int, delta: float,
                                    term_rounds: int):
    """One push-sum round over one shard: ``planes`` its (s, w, tc)
    [rows_loc, 128] planes, ``wire`` its (sources, bases) summary,
    ``keys`` the round key (k1, k2), ``offs`` the P displacements, ``row0``
    its first global row of ``rows``. Returns ((s', w', tc'), u) with u the
    shard's converged count (int32, 0-dim)."""
    s, w, tc = (p.reshape(-1) for p in planes)
    rows_loc, dev = planes[0].shape[0], s.device
    pad = row0 * LANES + torch.arange(s.numel(), device=dev) >= n
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    in_s = torch.zeros_like(s)
    in_w = torch.zeros_like(w)
    for k, (hit, at) in enumerate(_slot_reads(keys, offs, wire, row0, rows_loc,
                                              rows, n, dev)):
        ws, ww = (x.reshape(-1) for x in wire[0][k])
        in_s = in_s + torch.where(hit, ws[at] * 0.5, zero)
        in_w = in_w + torch.where(hit, ww[at] * 0.5, zero)
    s_send = torch.where(pad, zero, s * 0.5)
    w_send = torch.where(pad, zero, w * 0.5)
    s_new = (s - s_send) + in_s
    w_new = (w - w_send) + in_w
    stable = torch.abs(s_new / w_new - s / w) <= torch.tensor(delta, dtype=torch.float32)
    term = tc & TC_TERM_MASK
    t_new = torch.where(in_w > 0, torch.where(stable, term + 1, 0), term)
    conv = (((tc & TC_CONV_BIT) != 0) | (t_new >= term_rounds)) & ~pad
    tc_new = torch.where(conv, t_new | TC_CONV_BIT, t_new).to(torch.int32)
    shape = planes[0].shape
    return ((s_new.reshape(shape), w_new.reshape(shape), tc_new.reshape(shape)),
            conv.sum().to(torch.int32))


def gossip_pool2_shard_round_plain(planes, wire, keys, offs, row0: int, *,
                                   n: int, rows: int, rumor_target: int,
                                   suppress: bool):
    """Gossip analog of ``pushsum_pool2_shard_round_plain``: ``planes`` is
    (count, active), the summary the active plane; conv is count >=
    rumor_target on real lanes, suppression receiver-side."""
    cnt, act = (p.reshape(-1) for p in planes)
    rows_loc, dev = planes[0].shape[0], cnt.device
    pad = row0 * LANES + torch.arange(cnt.numel(), device=dev) >= n
    inbox = torch.zeros_like(cnt)
    for k, (hit, at) in enumerate(_slot_reads(keys, offs, wire, row0, rows_loc,
                                              rows, n, dev)):
        inbox = inbox + (hit & (wire[0][k][0].reshape(-1)[at] != 0)).to(torch.int32)
    if suppress:
        inbox = torch.where((cnt >= rumor_target) & ~pad, 0, inbox)
    cnt_new = (cnt + inbox).to(torch.int32)
    act_new = ((act != 0) | (inbox > 0)).to(torch.int32)
    conv = (cnt_new >= rumor_target) & ~pad
    shape = planes[0].shape
    return ((cnt_new.reshape(shape), act_new.reshape(shape)),
            conv.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two. Each writes the shard's new planes
# into ``out`` and its count into ``u`` (int32 [1]) unless ``ctrl[0]`` (the
# run's done flag) is set; ``acc`` is the shard's zeroed int32 [2] scratch.
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "gossip_pushsum_pool2_shard_round":
        [_P] * 6 + [_PP, _IP, _IP, _U, _U] + [_I] * 5 + [_F, _I, _P, _P, _P, _I, _P],
    "gossip_gossip_pool2_shard_round":
        [_P] * 4 + [_PP, _IP, _IP, _U, _U] + [_I] * 7 + [_P, _P, _P, _I, _P],
    "gossip_pool2_shard_verdict": [_P, _I, _I, _P, _I, _P],
}


def _check(planes, out, dtypes, wire, offs, rows: int, n: int, u, acc,
           ctrl) -> torch.device:
    dev = planes[0].device
    for x, size in ((u, 1), (acc, 2), (ctrl, 2)):
        if x.device != dev or x.dtype != torch.int32 or x.numel() != size:
            raise ValueError(f"u, acc and ctrl must be int32 [1], [2], [2] on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shard rounds run on cpu or cuda tensors, got {dev}")
    shape = tuple(planes[0].shape)
    if len(shape) != 2 or shape[1] != LANES or rows % shape[0]:
        raise ValueError(f"shard planes must be [rows_loc, {LANES}] with rows_loc "
                         f"dividing {rows}, got {shape}")
    for x, dt in zip(tuple(planes) + tuple(out), dtypes * 2):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"shard plane must be {dt} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError("shard planes must be contiguous")
    if len(offs) not in fused_pool.POOL_SIZES:
        raise ValueError(f"pool_size {len(offs)} not in {fused_pool.POOL_SIZES}")
    if not all(1 <= int(d) <= n - 1 for d in offs):
        raise ValueError(f"offs must lie in [1, {n - 1}]")
    sources, bases = wire
    if len(sources) != len(offs) or len(bases) != len(offs):
        raise ValueError("the wire must give one summary and base per slot")
    for planes_k in sources:
        for x in planes_k:
            if x.device != dev or not x.is_contiguous() or x.shape[1] != LANES:
                raise ValueError(f"summary planes must be contiguous [*, {LANES}] "
                                 f"on {dev}")
    if not all(0 <= int(b) < rows for b in bases):
        raise ValueError(f"bases must lie in [0, {rows})")
    return dev


def _launch(name: str, dev, planes, wire_ptrs, bases, offs, ints, u, acc,
            ctrl) -> None:
    """Queue one launch of entry point ``name`` on the current stream of
    ``dev``: the shard's planes, its wire (host arrays of pointers, bases
    and displacements), the scalars, then u, acc and ctrl."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fn = kernels.entry("fused_pool2_shard", name, _SIGNATURES[name])
    P = len(offs)
    err = fn(*[ctypes.c_void_p(x.data_ptr()) for x in planes],
             (ctypes.c_void_p * len(wire_ptrs))(*wire_ptrs),
             (ctypes.c_int * P)(*[int(b) for b in bases]),
             (ctypes.c_int * P)(*[int(d) for d in offs]),
             *ints, *[ctypes.c_void_p(x.data_ptr()) for x in (u, acc, ctrl)],
             dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _write_plain(result, out, u) -> None:
    planes, count = result
    for o, x in zip(out, planes):
        o.copy_(x)
    u[0] = count


def pushsum_pool2_shard_round(planes, out, wire, keys, offs, row0: int, *,
                              n: int, rows: int, delta: float, term_rounds: int,
                              u, acc, ctrl) -> None:
    """One push-sum round over one shard, (s, w, tc) ``planes`` into
    ``out``: the kernel on CUDA tensors, the plain version on CPU ones."""
    dev = _check(planes, out, (torch.float32, torch.float32, torch.int32), wire,
                 offs, rows, n, u, acc, ctrl)
    if dev.type == "cpu":
        if not int(ctrl[0]):
            _write_plain(pushsum_pool2_shard_round_plain(
                planes, wire, keys, offs, row0, n=n, rows=rows, delta=delta,
                term_rounds=term_rounds), out, u)
        return
    wire_ptrs = [x.data_ptr() for planes_k in wire[0] for x in planes_k]
    _launch("gossip_pushsum_pool2_shard_round", dev, (*planes, *out), wire_ptrs,
            wire[1], offs,
            (ctypes.c_uint(int(keys[0])), ctypes.c_uint(int(keys[1])), n, rows,
             row0, planes[0].shape[0], len(offs), ctypes.c_float(delta),
             term_rounds), u, acc, ctrl)
    pushsum_pool2_shard_round.launches += 1


def gossip_pool2_shard_round(planes, out, wire, keys, offs, row0: int, *,
                             n: int, rows: int, rumor_target: int, suppress: bool,
                             u, acc, ctrl) -> None:
    """Gossip analog of ``pushsum_pool2_shard_round``: (count, active)."""
    dev = _check(planes, out, (torch.int32, torch.int32), wire, offs, rows, n, u,
                 acc, ctrl)
    if dev.type == "cpu":
        if not int(ctrl[0]):
            _write_plain(gossip_pool2_shard_round_plain(
                planes, wire, keys, offs, row0, n=n, rows=rows,
                rumor_target=rumor_target, suppress=suppress), out, u)
        return
    wire_ptrs = [planes_k[0].data_ptr() for planes_k in wire[0]]
    _launch("gossip_gossip_pool2_shard_round", dev, (*planes, *out), wire_ptrs,
            wire[1], offs,
            (ctypes.c_uint(int(keys[0])), ctypes.c_uint(int(keys[1])), n, rows,
             row0, planes[0].shape[0], len(offs), rumor_target, int(suppress)),
            u, acc, ctrl)
    gossip_pool2_shard_round.launches += 1


# Kernel launches queued by each wrapper (one a shard a round), counted
# where the kernel is launched and nowhere else.
pushsum_pool2_shard_round.launches = 0
gossip_pool2_shard_round.launches = 0


def shard_verdict(u, target: int, ctrl) -> None:
    """The round's verdict on ``u`` (int32 [S], the shards' counts, on
    ctrl's device): unless ctrl[0] (done) is set, count the round in
    ctrl[1] and set done once sum(u) >= target."""
    if ctrl.device.type == "cpu":
        if not int(ctrl[0]):
            ctrl[1] += 1
            ctrl[0] = int(int(u.sum()) >= target)
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(ctrl.device).cuda_stream)
    fn = kernels.entry("fused_pool2_shard", "gossip_pool2_shard_verdict",
                       _SIGNATURES["gossip_pool2_shard_verdict"])
    err = fn(ctypes.c_void_p(u.data_ptr()), u.numel(), target,
             ctypes.c_void_p(ctrl.data_ptr()), ctrl.device.index, stream)
    if err:
        raise RuntimeError(f"pool2_shard_verdict: CUDA launch failed with "
                           f"cudaError_t {err}")


def make_pushsum_pool2_shard_chunk(topo: Topology, cfg: SimConfig, rows_loc: int,
                                   layout):
    """``chunk_fn(state3, wire, keys, offs, row0) -> (state3', u)``: one
    push-sum round over the shard at ``row0`` (the JAX factory's
    contract, fault-free, so without its gate, death and ``rnd``
    operands; the kernel does not tile, so without its PT), through
    ``pushsum_pool2_shard_round``."""
    kw = {"n": topo.n, "rows": layout.rows, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}

    def chunk_fn(state3, wire, keys, offs, row0):
        return _functional(pushsum_pool2_shard_round, state3, wire, keys, offs,
                           row0, rows_loc, kw)

    return chunk_fn


def make_gossip_pool2_shard_chunk(topo: Topology, cfg: SimConfig, rows_loc: int,
                                  layout):
    """Gossip analog of ``make_pushsum_pool2_shard_chunk``: (count,
    active)."""
    kw = {"n": topo.n, "rows": layout.rows,
          "rumor_target": cfg.resolved_rumor_target,
          "suppress": cfg.resolved_suppress}

    def chunk_fn(state2, wire, keys, offs, row0):
        return _functional(gossip_pool2_shard_round, state2, wire, keys, offs,
                           row0, rows_loc, kw)

    return chunk_fn


def _functional(round_fn, state, wire, keys, offs, row0, rows_loc, kw):
    if state[0].shape[0] != rows_loc:
        raise ValueError(f"shard planes must have {rows_loc} rows")
    dev = state[0].device
    out = [torch.empty_like(x) for x in state]
    u = torch.zeros(1, dtype=torch.int32, device=dev)
    acc = torch.zeros(2, dtype=torch.int32, device=dev)
    ctrl = torch.zeros(2, dtype=torch.int32, device=dev)
    round_fn(state, out, wire, keys, offs, row0, **kw, u=u, acc=acc, ctrl=ctrl)
    return tuple(out), u[0]


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def _start_planes(topo, cfg, key, mesh, rows_loc, layout, start_state):
    """Per shard, the start planes on its device: from ``start_state``
    (canonical [n] tensors), or built per shard from the global row index
    (no global host array)."""
    from ..models.runner import draw_leader

    n = topo.n
    pushsum = cfg.algorithm == "push-sum"
    if start_state is not None:
        if pushsum:
            tc = torch.where(start_state.conv.cpu(),
                             start_state.term.cpu().to(torch.int32) | TC_CONV_BIT,
                             start_state.term.cpu().to(torch.int32))
            full = (fused._pad2d(start_state.s.cpu().to(torch.float32), layout, 0.0),
                    fused._pad2d(start_state.w.cpu().to(torch.float32), layout, 1.0),
                    fused._pad2d(tc.to(torch.int32), layout, 0))
        else:
            full = (fused._pad2d(start_state.count.cpu().to(torch.int32), layout, 0),
                    fused._pad2d(start_state.active.cpu().to(torch.int32), layout, 0))
        return [tuple(p[s * rows_loc:(s + 1) * rows_loc].contiguous().to(dev)
                      for p in full) for s, dev in enumerate(mesh.devices)]

    def ids(lo, hi, dev):
        return mesh_mod.flat_ids(lo, hi, LANES, dev)

    if pushsum:
        term0 = cfg.initial_term_round
        planes = (
            mesh_mod.put_rows(mesh, rows_loc, lambda lo, hi, dev: torch.where(
                ids(lo, hi, dev) < n, ids(lo, hi, dev), 0).to(torch.float32)),
            mesh_mod.put_rows(mesh, rows_loc, lambda lo, hi, dev: torch.ones(
                hi - lo, LANES, dtype=torch.float32, device=dev)),
            mesh_mod.put_rows(mesh, rows_loc, lambda lo, hi, dev: torch.where(
                ids(lo, hi, dev) < n, term0, 0).to(torch.int32)),
        )
    else:
        leader = draw_leader(key, topo, cfg)
        receipt = int(cfg.reference and topo.kind == "full")
        planes = (
            mesh_mod.put_rows(mesh, rows_loc, lambda lo, hi, dev: (
                (ids(lo, hi, dev) == leader) * receipt).to(torch.int32)),
            mesh_mod.put_rows(mesh, rows_loc, lambda lo, hi, dev: (
                ids(lo, hi, dev) == leader).to(torch.int32)),
        )
    return [tuple(p[s] for p in planes) for s in range(mesh.size)]


class ShardControl:
    """The control block of a run of one-round super-steps over shards on
    ``devices``: on the home device (shard 0's) the done flag and round
    counter ``ctrl`` (int32 [2]) and the shards' counts of each round
    parity ``u_all`` (int32 [2, S]); on every other device a copy of ctrl
    and each of its shards' count slots; per shard its int32 [2] scratch."""

    def __init__(self, devices, done: bool, start_round: int):
        self.devices, self.home = list(devices), devices[0]
        home = self.home
        self.ctrl = torch.tensor([int(done), start_round], dtype=torch.int32, device=home)
        self.ctrl_on = {dev: (self.ctrl if dev == home else self.ctrl.to(dev))
                        for dev in self.devices}
        self.u_all = torch.zeros(2, len(self.devices), dtype=torch.int32, device=home)
        self.u_of = [[self.u_all[par, s:s + 1] if dev == home else
                      torch.zeros(1, dtype=torch.int32, device=dev) for par in (0, 1)]
                     for s, dev in enumerate(self.devices)]
        self.acc = [torch.zeros(2, dtype=torch.int32, device=dev) for dev in self.devices]

    def args(self, s: int, par: int) -> dict:
        """Shard s's u, acc and ctrl operands in a round of parity ``par``."""
        return {"u": self.u_of[s][par], "acc": self.acc[s],
                "ctrl": self.ctrl_on[self.devices[s]]}


def run_round_supersteps(topo: Topology, cfg: SimConfig, ctl: ShardControl, *,
                         start_round: int, target: int, t_enter: float, library: str,
                         draw, launch_round, final_state, ahead: int = 0,
                         prologue=None):
    """Run one-round super-steps to convergence or cfg.max_rounds and return
    the RunResult: chunks of STRIDE rounds queued through
    models/pipeline.py, one host sync each, each round's verdict ordered by
    parallel/overlap.py. ``draw(begin, count)`` gives the random streams
    of rounds begin.. (one tuple a round), drawn ``ahead`` rounds past each
    chunk; ``launch_round(r, stream, *later)`` queues round r's wire and
    shard launches, each shard's count into its ``ctl.args`` slot, with the
    streams of rounds r + 1..r + ahead as ``later``; ``final_state(par)``
    joins the planes of parity ``par`` into the canonical state.
    ``library`` names the kernels' source, loaded (with the verdict's)
    before the run's clock starts; ``prologue()``, if given, is queued
    then too, ahead of the first round."""
    from ..models import pipeline as pipeline_mod
    from ..models.runner import _finalize_result

    home = ctl.home
    streams = {}

    def launch(r):
        launch_round(r, *(streams[r + i] for i in range(ahead + 1)))
        for s, dev in enumerate(ctl.devices):
            if dev != home:
                ctl.u_all[r % 2, s].copy_(ctl.u_of[s][r % 2][0])

    def verdict(r):
        shard_verdict(ctl.u_all[r % 2], target, ctl.ctrl)
        for dev, c in ctl.ctrl_on.items():
            if dev != home:
                c.copy_(ctl.ctrl)

    queued = {"end": start_round}

    def dispatch(state, status, round_end):
        # A chunk that runs at all starts where the previous one was told
        # to end: only termination stops a chunk short, and every later
        # chunk's launches then return at once.
        begin, queued["end"] = queued["end"], round_end
        count = max(round_end - begin, 0)
        streams.clear()
        streams.update(zip(range(begin, begin + count + ahead),
                           draw(begin, count + ahead)))
        overlap_mod.superstep_rounds(begin, round_end, launch_round=launch,
                                     verdict=verdict,
                                     overlap=cfg.overlap_collectives)
        return state, ctl.ctrl[[1, 0]].to(torch.int64)

    t0 = time.perf_counter()
    setup_s = t0 - t_enter
    if home.type == "cuda":
        for name in dict.fromkeys((library, "fused_pool2_shard")):
            kernels.load(name)
    if prologue is not None:
        prologue()
    if home.type == "cuda":
        torch.cuda.synchronize(home)
    compile_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=None, status0=ctl.ctrl[[1, 0]].to(torch.int64),
        start_round=start_round, max_rounds=cfg.max_rounds, stride=STRIDE,
        depth=cfg.pipeline_chunks,
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    result = _finalize_result(topo, cfg, final_state(loop.rounds % 2), loop.rounds,
                              target, compile_s, run_s, loop.done, loop, home)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result


def run_pool2_sharded(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh, key,
                      start_state=None, start_round: int = 0,
                      t_enter: Optional[float] = None):
    """Sharded replicated-pool2 run (engine='fused', n_devices > 1, full
    with delivery='pool'), to convergence or cfg.max_rounds; returns the
    RunResult, its state the canonical [n] planes joined from the shards.

    Each shard keeps a ping/pong pair of plane sets: round r reads set
    r % 2 and writes the other, so the planes after r rounds are set r % 2
    and a verdict's round counter names them. The run's control block
    (``ShardControl``) lives on shard 0's device, and
    ``run_round_supersteps`` drives the rounds."""
    from ..models import gossip as gossip_mod
    from ..models import pushsum as pushsum_mod
    from ..models.runner import _host_done

    t_enter = time.perf_counter() if t_enter is None else t_enter
    S = mesh.size
    plan = plan_pool2_sharded(topo, cfg, S)
    if isinstance(plan, str):
        raise ValueError(f"engine='fused' with n_devices={S} unavailable: {plan}")
    rows_loc, PT, layout, wire_kind = plan
    n, R, P = topo.n, layout.rows, cfg.pool_size
    pushsum = cfg.algorithm == "push-sum"
    target = cfg.resolved_target_count(n, topo.target_count)
    devices, home = mesh.devices, mesh.devices[0]

    start = _start_planes(topo, cfg, key, mesh, rows_loc, layout, start_state)
    done0 = start_state is not None and _host_done(start_state, target)
    sets = []
    for s in range(S):
        pair = [None, None]
        pair[start_round % 2] = start[s]
        pair[(start_round + 1) % 2] = tuple(torch.empty_like(x) for x in start[s])
        sets.append(pair)
    del start
    ctl = ShardControl(devices, done0, start_round)
    if pushsum:
        round_fn = pushsum_pool2_shard_round
        kw = {"n": n, "rows": R, "delta": cfg.resolved_delta,
              "term_rounds": cfg.term_rounds}
        windowed_of = (0, 1)  # the summary planes: raw s and w
    else:
        round_fn = gossip_pool2_shard_round
        kw = {"n": n, "rows": R, "rumor_target": cfg.resolved_rumor_target,
              "suppress": cfg.resolved_suppress}
        windowed_of = (1,)  # the active plane

    def draw(begin, count):
        return list(zip(fused.round_keys(key, begin, count).tolist(),
                        fused_pool.round_offsets(key, begin, count, P, n).tolist()))

    def launch_round(r, stream):
        keys, offs = stream
        cur = [sets[s][r % 2] for s in range(S)]
        windowed = [[cur[s][p] for s in range(S)] for p in windowed_of]
        if wire_kind == "all_gather":
            wires = gather_wire(windowed, PT, devices, P)
        else:
            wires = band_wire(windowed, offs, layout, devices)
        for s in range(S):
            round_fn(cur[s], sets[s][(r + 1) % 2], wires[s], keys, offs,
                     s * rows_loc, **kw, **ctl.args(s, r % 2))

    def final_state(par):
        final = [sets[s][par] for s in range(S)]
        joined = [torch.cat([final[s][p].to(home) for s in range(S)]).reshape(-1)[:n]
                  for p in range(len(final[0]))]
        if pushsum:
            return pushsum_mod.PushSumState(
                s=joined[0], w=joined[1], term=joined[2] & TC_TERM_MASK,
                conv=(joined[2] & TC_CONV_BIT) != 0)
        return gossip_mod.GossipState(
            count=joined[0], active=joined[1] != 0,
            conv=joined[0] >= cfg.resolved_rumor_target)

    return run_round_supersteps(topo, cfg, ctl, start_round=start_round, target=target,
                                t_enter=t_enter, library="fused_pool2_shard", draw=draw,
                                launch_round=launch_round, final_state=final_state)
