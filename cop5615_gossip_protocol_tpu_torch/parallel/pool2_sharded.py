"""Replicated-pool2: the full topology sharded over several devices, the
counterpart of the JAX package's parallel/pool2_sharded.py.

The state planes of the streaming pool tier (ops/fused_pool2.py: push-sum
s, w and the packed term|conv plane, gossip count and active) are
row-sharded: each shard owns ``rows_loc`` consecutive rows of the pool
layout's [R, 128] planes. The shards of one device sit on consecutive
rows (``place_shards``: the devices in order of first appearance, each
with as many row blocks as it has shards; with shard i on device i this is
shard i on rows [i * rows_loc, (i + 1) * rows_loc)). Each distinct device
keeps one global [R, 128] copy, per round parity, of the summary planes
that other nodes read (push-sum s and w, gossip active), and its own rows
of the planes only the node reads (push-sum term|conv, gossip count), also
one set per parity. One super-step is one round r:

1. **wire**: with several devices, the rows of set r % 2 that a device
   reads but another owns are copied into the same rows of its copy, one
   batched copy per (destination, source) device pair into the
   preallocated planes (parallel/halo.py): on the ``all_gather`` plan every
   remote row (``replica_rows``, built once a run), on the
   ``reduce_scatter`` plan only the remote rows of each slot's band at its
   start (``band_replica_rows``, built each round from its displacements).
   With every shard on one device the wire is empty;
2. **round**: one launch a device over all of its rows
   (csrc/fused_pool2_shard.cu, the kernels of ``pushsum_pool2_shard_round``
   and ``gossip_pool2_shard_round``): each destination reads its slots'
   sources from the device's copy at their global index and writes its
   rows of set (r + 1) % 2, which are, in place, round r + 1's summary;
3. **verdict**: with every shard on one device the launch takes it itself
   (its last block counts the round and sets the done flag); with several,
   each device's launch leaves its converged count u, the counts are
   copied to the home device (shard 0's) and summed against the target
   there (parallel/overlap.py orders it, with the ``overlap_collectives``
   knob).

This departs from the JAX wire, which delivers each shard a fresh summary:
the whole margin-extended copy (one all_gather) or one band per slot at
the slot's band start (a banded reduce_scatter plus a margin ppermute),
which each TPU tile reads at static windows. On the card a source is a
load at a computed index, so a device reads its global copy in place: one
card copies nothing a round, and several move no more bytes than the JAX
wire does (the remote rows of the plan's gathered copy or bands). The
plan (``plan_pool2_sharded``, ``band_margin``, ``band_starts``) is still
the JAX plan, so a config gets the JAX package's geometry and wire, or its
reason; PT decides nothing else here.

Each output row is computed from the same inputs by the same operations as
the single-device streaming pool tier's, so a run is bitwise the port's
single-device pool2 run on either wire, at every shard count and
placement. Termination is checked every round, so ``rounds`` is exact. On
the CPU the wrappers run their plain torch versions; on CUDA they launch
the kernels; nothing falls back from one to the other. Fault operands (the
drop gate, the death planes, global termination) and ``delivery="matmul"``
are refused by the config (ROADMAP A6, A7).
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import torch

from ..config import SimConfig
from ..models.pushsum import flush, halve_and_send
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

# Rounds of random streams the run draws and uploads at once: drawing them
# costs the host about the same for 8 rounds as for a few hundred.
DRAW_ROUNDS = 256


def plan_pool2_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(rows_loc, PT, layout, wire) or a string reason why the composition
    can't run: the JAX plan. ``wire`` is "reduce_scatter" (per-slot bands)
    or "all_gather" (the whole copy), cfg.resolved_pool2_wire with auto
    demoting to the gather wire when the band margin exceeds a shard. The
    JAX plan's dtype gate is the port config's own refusal (ROADMAP A12);
    its crash-recovery, telemetry and step-timing gates are here."""
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
    if cfg.dup_rate > 0 or cfg.delay_rounds > 0:
        return "dup/delay fault models run on the chunked engine only"
    if cfg.revive_model:
        return (
            "crash-recovery (revive) runs on the chunked, sharded, and "
            "VMEM fused stencil/pool engines only"
        )
    if cfg.telemetry:
        return (
            "telemetry counters run in the single-device fused kernels and "
            "the chunked/sharded XLA engines; this composition does not "
            "carry the counter block"
        )
    if cfg.step_timing and cfg.overlap_collectives:
        return (
            "step_timing under the overlapped super-step schedule would "
            "force the deferred termination psum to drain at every timed "
            "boundary (a host sync inside the overlap window); use "
            "overlap_collectives=False or step_timing=False"
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
# Placement: a device's shards on consecutive rows.
# ---------------------------------------------------------------------------


class DeviceRows(NamedTuple):
    """The rows one device owns: global rows [row0, row0 + rows)."""
    device: torch.device
    row0: int
    rows: int


def place_shards(devices, rows_loc: int) -> list:
    """The DeviceRows of each distinct device of ``devices`` (shard i's),
    in order of first appearance, each holding as many consecutive
    ``rows_loc``-row blocks as it has shards. The home device (shard 0's)
    comes first; with shard i on device i, shard i owns rows [i * rows_loc,
    (i + 1) * rows_loc)."""
    devices = list(devices)
    placed, row0 = [], 0
    for dev in dict.fromkeys(devices):
        rows = devices.count(dev) * rows_loc
        placed.append(DeviceRows(dev, row0, rows))
        row0 += rows
    return placed


# ---------------------------------------------------------------------------
# Plain versions: one device's round in torch, on any device. They are what
# the kernels are held against, and what the wrappers run on CPU tensors.
# ``glob`` is the device's global [R, 128] summary planes, ``own`` its
# [rows, 128] rows of the other planes, global rows [row0, row0 + rows).
# ---------------------------------------------------------------------------


def _slot_reads(keys, offs, row0: int, rows: int, R: int, n: int, device):
    """Per slot k, in order: (hit, src) over the destinations, flat global
    j = row0 * 128 + local: ``src`` the mod-n source of j, the flat index
    where the summary planes hold it, and ``hit`` where j is real and src
    chose slot k (csrc/pool2.cuh, slot_reads)."""
    j = row0 * LANES + torch.arange(rows * LANES, dtype=torch.int64, device=device)
    k1k2 = torch.tensor([int(keys[0]), int(keys[1])], dtype=torch.int64)
    choice = fused_pool._choice_plane(k1k2.to(device), R, len(offs)).reshape(-1)
    for k, d in enumerate(offs):
        src = torch.where(j >= d, j - d, j - d + n)
        ch = torch.where(src < n, choice[src], -1)
        yield (ch == k) & (j < n), src


def _rows_of(glob, row0: int, rows: int):
    return tuple(p[row0:row0 + rows] for p in glob)


class ShardFaults(NamedTuple):
    """One device's failure-model operands in one round, which run the
    kernels' faulted instance: the gate threshold (0 without a gate), the
    device's rows of the death plane (int32 [rows, 128], None without a
    crash model), the round's quorum need (int32 [1] on the device, None
    without a crash model or when the launch takes no verdict), the round's
    absolute index, push-sum's global termination, this round's send bits
    (the device's global uint8 [R // 8, 128] plane, ``pack_sends``' layout)
    and the next round's (written for the device's rows; None: not
    written), whose gate key comes from the next row of the streams."""
    thresh: int
    death: Optional[torch.Tensor]
    need: Optional[torch.Tensor]
    rnd: int
    global_term: bool
    sends: torch.Tensor
    next_sends: Optional[torch.Tensor]


def pack_sends(mask: torch.Tensor) -> torch.Tensor:
    """uint8 [rows // 8, 128] send bits of a bool [rows, 128] mask of 8-row
    groups: node (8q + sub, lane)'s bit is bit sub of byte (q, lane), the
    packed choice words' layout (csrc/pool2.cuh send_bit)."""
    groups = mask.reshape(-1, 8, LANES).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=mask.device).reshape(1, 8, 1)
    return (groups << shifts).sum(dim=1).to(torch.uint8)


def unpack_sends(plane: torch.Tensor) -> torch.Tensor:
    """The bool [R, 128] mask of a uint8 [R // 8, 128] send-bit plane."""
    shifts = torch.arange(8, dtype=torch.int32, device=plane.device).reshape(1, 8, 1)
    bits = (plane.to(torch.int32).unsqueeze(1) >> shifts) & 1
    return bits.reshape(-1, LANES) != 0


def send_rows_plain(active, death, thresh: int, gate_key, rnd: int, row0: int,
                    rows: int, n: int, device) -> torch.Tensor:
    """bool [rows, 128]: whether each node of global rows [row0, row0 +
    rows) sends in round ``rnd`` (csrc/faults.cuh send_flag): real, active
    (``active`` its gossip flags, None for push-sum), alive (``death`` its
    death rounds, or None) and its word of the gate stream at its global
    flat index at least ``thresh`` (the round's ``gate_key``; 0: no gate)."""
    j = mesh_mod.flat_ids(row0, row0 + rows, LANES, device)
    ok = j < n
    if active is not None:
        ok = ok & (active != 0)
    if death is not None:
        ok = ok & (death > rnd)
    if thresh:
        words = fused.threefry_bits_2d(int(gate_key[0]), int(gate_key[1]), rows, LANES,
                                       row0=row0, device=device)
        ok = ok & (words >= thresh)
    return ok


def _sending(faults: Optional[ShardFaults]):
    """The flat bool mask of the round's senders, or None (fault-free)."""
    return None if faults is None else unpack_sends(faults.sends).reshape(-1)


def pushsum_pool2_shard_round_plain(glob, own, keys, offs, row0: int, *, n: int,
                                    delta: float, term_rounds: int,
                                    faults: Optional[ShardFaults] = None):
    """One push-sum round over a device's rows: ``glob`` the (s, w)
    summary, ``own`` the rows' (tc,), ``keys`` the round key (k1, k2),
    ``offs`` the P displacements. Returns ((s', w', tc') of the rows, u)
    with u their converged count (int32, 0-dim). ``faults`` (a
    ShardFaults) runs the failure model: a source delivers and a node
    sends iff its send bit is set; a dead node's tc stays and u counts conv
    among the live nodes, or under global termination tc stays and u counts
    the real nodes whose ratio moved more than delta * max(|s/w|, 1)."""
    rows, R = own[0].shape[0], glob[0].shape[0]
    s_g, w_g = (p.reshape(-1) for p in glob)
    s, w = (p.reshape(-1) for p in _rows_of(glob, row0, rows))
    tc = own[0].reshape(-1)
    dev = s.device
    pad = row0 * LANES + torch.arange(s.numel(), device=dev) >= n
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sending = _sending(faults)
    in_s = torch.zeros_like(s)
    in_w = torch.zeros_like(w)
    for hit, src in _slot_reads(keys, offs, row0, rows, R, n, dev):
        if sending is not None:
            hit = hit & sending[src]
        in_s = flush(in_s + torch.where(hit, flush(s_g[src] * 0.5), zero))
        in_w = flush(in_w + torch.where(hit, flush(w_g[src] * 0.5), zero))
    sends = ~pad if sending is None else sending[row0 * LANES:(row0 + rows) * LANES]
    _, _, s_keep, w_keep = halve_and_send(s, w, sends)
    s_new = flush(s_keep + in_s)
    w_new = flush(w_keep + in_w)
    delta_t = torch.tensor(delta, dtype=torch.float32)
    shape = own[0].shape
    if faults is not None and faults.global_term:
        ratio_old = s / w
        tol = delta_t * torch.maximum(torch.abs(ratio_old), torch.ones((), device=dev))
        unstable = (torch.abs(s_new / w_new - ratio_old) > tol) & ~pad
        return ((s_new.reshape(shape), w_new.reshape(shape), tc.reshape(shape)),
                unstable.sum().to(torch.int32))
    stable = torch.abs(s_new / w_new - s / w) <= delta_t
    term = tc & TC_TERM_MASK
    t_new = torch.where(in_w > 0, torch.where(stable, term + 1, 0), term)
    conv = (((tc & TC_CONV_BIT) != 0) | (t_new >= term_rounds)) & ~pad
    tc_new = torch.where(conv, t_new | TC_CONV_BIT, t_new).to(torch.int32)
    if faults is not None and faults.death is not None:
        alive = faults.death.reshape(-1) > faults.rnd
        tc_new = torch.where(alive, tc_new, tc)
        conv = conv & alive
    return ((s_new.reshape(shape), w_new.reshape(shape), tc_new.reshape(shape)),
            conv.sum().to(torch.int32))


def gossip_pool2_shard_round_plain(glob, own, keys, offs, row0: int, *, n: int,
                                   rumor_target: int, suppress: bool,
                                   faults: Optional[ShardFaults] = None):
    """Gossip analog of ``pushsum_pool2_shard_round_plain``: ``glob`` is
    (active,), ``own`` (count,); returns ((count', active') of the rows,
    u). conv is count >= rumor_target on real lanes, suppression
    receiver-side. Under ``faults`` a source delivers iff its send bit is
    set (its active flag is not read), a dead node's inbox counts nothing
    and u counts conv among the live nodes."""
    rows, R = own[0].shape[0], glob[0].shape[0]
    a_g = glob[0].reshape(-1)
    act = _rows_of(glob, row0, rows)[0].reshape(-1)
    cnt = own[0].reshape(-1)
    dev = cnt.device
    pad = row0 * LANES + torch.arange(cnt.numel(), device=dev) >= n
    sending = _sending(faults)
    inbox = torch.zeros_like(cnt)
    for hit, src in _slot_reads(keys, offs, row0, rows, R, n, dev):
        delivers = hit & (a_g[src] != 0) if sending is None else hit & sending[src]
        inbox = inbox + delivers.to(torch.int32)
    alive = None
    if faults is not None and faults.death is not None:
        alive = faults.death.reshape(-1) > faults.rnd
        inbox = torch.where(alive, inbox, 0)
    if suppress:
        inbox = torch.where((cnt >= rumor_target) & ~pad, 0, inbox)
    cnt_new = (cnt + inbox).to(torch.int32)
    act_new = ((act != 0) | (inbox > 0)).to(torch.int32)
    conv = (cnt_new >= rumor_target) & ~pad
    if alive is not None:
        conv = conv & alive
    shape = own[0].shape
    return ((cnt_new.reshape(shape), act_new.reshape(shape)),
            conv.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two. Each reads the device's global
# ``glob_in`` and its rows' ``own_in``, and writes the rows of ``glob_out``
# and ``own_out``, unless ``ctrl[0]`` (the run's done flag on this device)
# is set. ``keys`` (int64 [K, 2]) and ``offs`` (int32 [K, P]) are a chunk's
# streams on the planes' device, of which the launch reads round ``at``.
# The rows' converged count goes to ``u`` (int32 [1]); with ``u`` None the
# launch takes the verdict: it counts the round in ctrl[1] and sets ctrl[0]
# once the count reaches ``target`` (under ``faults``, ShardFaults: the
# round's quorum need, or 0 unstable nodes). ``acc`` is the device's zeroed
# int32 [2] scratch. ``faults`` runs the faulted instance, which also
# writes the rows' send bits of the next round (round ``at + 1``'s key).
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# The failure model's arguments (faulted, thresh, death, need, round), then
# push-sum's global, then the send bits of this round and the next and the
# next round's key.
_FAULT_ARGS = [_I, _U, _P, _P, _I]
_SIGNATURES = {
    "gossip_pushsum_pool2_shard_round":
        [_P] * 8 + [_I] * 4 + [_F, _I] + [_P] * 3 + [_I] + _FAULT_ARGS + [_I]
        + [_P] * 3 + [_I, _P],
    "gossip_gossip_pool2_shard_round":
        [_P] * 6 + [_I] * 6 + [_P] * 3 + [_I] + _FAULT_ARGS + [_P] * 3 + [_I, _P],
    "gossip_pool2_shard_sends": [_P, _P] + [_U] * 3 + [_I] * 4 + [_P, _I, _P],
    "gossip_pool2_shard_verdict": [_P, _I, _I, _P, _I, _P, _I, _P],
}


def _check(glob_in, glob_out, own_in, own_out, dtypes, keys, offs, at: int, row0: int,
           n: int, u, acc, ctrl, faults=None) -> torch.device:
    dev = glob_in[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shard rounds run on cpu or cuda tensors, got {dev}")
    R, rows = glob_in[0].shape[0], own_in[0].shape[0]
    glob_dt, own_dt = dtypes
    for planes, dts, shape in ((glob_in, glob_dt, (R, LANES)), (glob_out, glob_dt, (R, LANES)),
                               (own_in, own_dt, (rows, LANES)),
                               (own_out, own_dt, (rows, LANES))):
        if len(planes) != len(dts):
            raise ValueError(f"expected {len(dts)} planes, got {len(planes)}")
        for x, dt in zip(planes, dts):
            if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
                raise ValueError(f"shard plane must be {dt} {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError("shard planes must be contiguous")
    if rows < 8 or rows % 8 or row0 % 8 or not 0 <= row0 <= R - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) must be whole 8-row groups "
                         f"inside [0, {R})")
    if not 2 <= n <= R * LANES < 2**31:
        raise ValueError(f"{R} rows do not hold n={n} in int32 flat indices")
    if (keys.device != dev or keys.dtype != torch.int64 or keys.dim() != 2
            or keys.shape[1] != 2):
        raise ValueError(f"keys must be int64 [K, 2] on {dev}")
    if (offs.device != dev or offs.dtype != torch.int32 or offs.dim() != 2
            or offs.shape[0] != keys.shape[0]):
        raise ValueError(f"offs must be int32 [K, P] on {dev}, K = {keys.shape[0]}")
    if offs.shape[1] not in fused_pool.POOL_SIZES:
        raise ValueError(f"pool_size {offs.shape[1]} not in {fused_pool.POOL_SIZES}")
    if not 0 <= at < keys.shape[0]:
        raise ValueError(f"round {at} outside the {keys.shape[0]} rounds of the streams")
    # The run's draw makes every displacement so; on the card the check
    # would cost a host sync, so only the CPU checks the values.
    if dev.type == "cpu" and not all(1 <= d <= n - 1 for d in offs[at].tolist()):
        raise ValueError(f"offs must lie in [1, {n - 1}]")
    for x, size in ((acc, 2), (ctrl, 2)) + (() if u is None else ((u, 1),)):
        if x.device != dev or x.dtype != torch.int32 or x.numel() != size:
            raise ValueError(f"u, acc and ctrl must be int32 [1], [2], [2] on {dev}")
    if faults is not None:
        _check_faults(faults, dev, R, rows)
        if faults.next_sends is not None and at + 1 >= keys.shape[0]:
            raise ValueError("the next round's send bits need its key: round "
                             f"{at + 1} of the streams")
    return dev


def _check_faults(faults: ShardFaults, dev, R: int, rows: int) -> None:
    for x in (faults.sends, faults.next_sends):
        if x is not None and (x.device != dev or x.dtype != torch.uint8
                              or tuple(x.shape) != (R // 8, LANES)
                              or not x.is_contiguous()):
            raise ValueError(f"send bits must be uint8 ({R // 8}, {LANES}) on {dev}")
    d = faults.death
    if d is not None and (d.device != dev or d.dtype != torch.int32
                          or tuple(d.shape) != (rows, LANES) or not d.is_contiguous()):
        raise ValueError(f"the death rows must be int32 ({rows}, {LANES}) on {dev}")
    if faults.need is not None and (faults.need.device != dev
                                    or faults.need.dtype != torch.int32
                                    or faults.need.numel() != 1):
        raise ValueError(f"the quorum need must be int32 [1] on {dev}")
    if not 0 <= faults.thresh <= 0xFFFFFFFF:
        raise ValueError("the gate threshold must be a uint32")


def _round_plain(algorithm: str, glob_in, glob_out, own_in, own_out, keys, offs, at: int,
                 row0: int, kw: dict, u, target: int, ctrl, faults) -> None:
    if int(ctrl[0]):
        return
    plain = (pushsum_pool2_shard_round_plain if algorithm == "push-sum"
             else gossip_pool2_shard_round_plain)
    planes, count = plain(glob_in, own_in, keys[at].tolist(), offs[at].tolist(), row0,
                          **kw, faults=faults)
    summary, mine = split_state(planes, algorithm)
    rows = own_in[0].shape[0]
    for o, x in zip(_rows_of(glob_out, row0, rows) + tuple(own_out), summary + mine):
        o.copy_(x)
    if faults is not None and faults.next_sends is not None:
        gate = fused.gate_round_keys(keys[at + 1:at + 2].cpu())[0].tolist()
        mask = send_rows_plain(None if algorithm == "push-sum" else summary[0],
                               faults.death, faults.thresh, gate, faults.rnd + 1, row0,
                               rows, kw["n"], glob_in[0].device)
        faults.next_sends[row0 // 8:(row0 + rows) // 8] = pack_sends(mask)
    if u is None:
        ctrl[1] += 1
        ctrl[0] = int(_fires(int(count), target, None if faults is None else faults.need,
                             faults is not None and faults.global_term))
    else:
        u[0] = count


def _fires(total: int, target: int, need=None, global_term: bool = False) -> bool:
    """A round's verdict on its count: 0 unstable nodes under global
    termination, else the count against the quorum need (``need``, int32
    [1]) or the target."""
    if global_term:
        return total == 0
    return total >= (target if need is None else int(need[0]))


def _fault_args(faults: Optional[ShardFaults], keys, at: int, pushsum: bool) -> list:
    """The entry points' failure-model arguments (``_FAULT_ARGS``, push-sum's
    global, the send bits and the next round's key)."""
    if faults is None:
        args = [0, 0, None, None, 0] + ([0] if pushsum else []) + [None, None, None]
        return args
    ptr = (lambda x: None if x is None else x.data_ptr())
    args = [1, faults.thresh, ptr(faults.death), ptr(faults.need), faults.rnd]
    if pushsum:
        args.append(int(faults.global_term))
    nxt = (None if faults.next_sends is None
           else keys.data_ptr() + (at + 1) * keys.stride(0) * 8)
    return args + [faults.sends.data_ptr(), ptr(faults.next_sends), nxt]


def _launch(name: str, dev, planes, keys, offs, at: int, ints, u, acc, ctrl,
            target: int, fargs) -> None:
    """Queue one launch of entry point ``name`` on the current stream of
    ``dev``: the planes, round ``at`` of the streams, the scalars, then u
    (null for the verdict in the launch), acc, ctrl, the target and the
    failure model's arguments."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fn = kernels.entry("fused_pool2_shard", name, _SIGNATURES[name])
    err = fn(*[x.data_ptr() for x in planes], keys.data_ptr() + at * keys.stride(0) * 8,
             offs.data_ptr() + at * offs.stride(0) * 4, *ints,
             None if u is None else u.data_ptr(), acc.data_ptr(), ctrl.data_ptr(),
             target, *fargs, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def pushsum_pool2_shard_round(glob_in, glob_out, own_in, own_out, keys, offs, row0: int,
                              *, n: int, delta: float, term_rounds: int, u, acc, ctrl,
                              target: int = 0, at: int = 0,
                              faults: Optional[ShardFaults] = None) -> None:
    """One push-sum round over a device's rows [row0, row0 + rows): the
    global (s, w) ``glob_in`` [R, 128] and the rows' (tc,) ``own_in`` [rows,
    128] into ``glob_out``'s rows and ``own_out``: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    f32, i32 = torch.float32, torch.int32
    dev = _check(glob_in, glob_out, own_in, own_out, ((f32, f32), (i32,)), keys, offs,
                 at, row0, n, u, acc, ctrl, faults)
    if dev.type == "cpu":
        _round_plain("push-sum", glob_in, glob_out, own_in, own_out, keys, offs, at, row0,
                     {"n": n, "delta": delta, "term_rounds": term_rounds}, u, target, ctrl,
                     faults)
        return
    _launch("gossip_pushsum_pool2_shard_round", dev,
            (*glob_in, *own_in, *glob_out, *own_out), keys, offs, at,
            (n, row0, own_in[0].shape[0], offs.shape[1], ctypes.c_float(delta),
             term_rounds), u, acc, ctrl, target, _fault_args(faults, keys, at, True))
    pushsum_pool2_shard_round.launches += 1


def gossip_pool2_shard_round(glob_in, glob_out, own_in, own_out, keys, offs, row0: int,
                             *, n: int, rumor_target: int, suppress: bool, u, acc, ctrl,
                             target: int = 0, at: int = 0,
                             faults: Optional[ShardFaults] = None) -> None:
    """Gossip analog of ``pushsum_pool2_shard_round``: the global (active,)
    and the rows' (count,)."""
    i32 = torch.int32
    dev = _check(glob_in, glob_out, own_in, own_out, ((i32,), (i32,)), keys, offs, at,
                 row0, n, u, acc, ctrl, faults)
    if faults is not None and faults.global_term:
        raise ValueError("gossip has no global termination")
    if dev.type == "cpu":
        _round_plain("gossip", glob_in, glob_out, own_in, own_out, keys, offs, at, row0,
                     {"n": n, "rumor_target": rumor_target, "suppress": suppress}, u,
                     target, ctrl, faults)
        return
    _launch("gossip_gossip_pool2_shard_round", dev,
            (*own_in, *glob_in, *own_out, *glob_out), keys, offs, at,
            (n, row0, own_in[0].shape[0], offs.shape[1], rumor_target, int(suppress)),
            u, acc, ctrl, target, _fault_args(faults, keys, at, False))
    gossip_pool2_shard_round.launches += 1


# Kernel launches queued by each wrapper (one a device a round), counted
# where the kernel is launched and nowhere else.
pushsum_pool2_shard_round.launches = 0
gossip_pool2_shard_round.launches = 0


def pool2_shard_sends(sends, active, death, keys, rnd: int, row0: int, rows: int, *,
                      n: int, thresh: int) -> None:
    """The send bits of round ``rnd`` (``keys`` its key, two uint32 words)
    for a device's rows [row0, row0 + rows) into its global send-bit plane
    ``sends`` (uint8 [R // 8, 128]; ``send_rows_plain``): ``active`` the
    device's global gossip active plane (None for push-sum), ``death`` its
    rows of the death plane (None without a crash model), ``thresh`` the
    gate threshold (0: none). A run's first round's bits; every later
    round's are written by the round before it."""
    dev = sends.device
    if death is not None and tuple(death.shape) != (rows, LANES):
        raise ValueError(f"the death rows must be ({rows}, {LANES})")
    if dev.type == "cpu":
        gate = fused.gate_round_keys(torch.tensor([[int(k) for k in keys]]))[0].tolist()
        act = None if active is None else active[row0:row0 + rows]
        sends[row0 // 8:(row0 + rows) // 8] = pack_sends(
            send_rows_plain(act, death, thresh, gate, rnd, row0, rows, n, dev))
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fn = kernels.entry("fused_pool2_shard", "gossip_pool2_shard_sends",
                       _SIGNATURES["gossip_pool2_shard_sends"])
    err = fn(None if active is None else active.data_ptr(),
             None if death is None else death.data_ptr(), int(keys[0]), int(keys[1]),
             thresh, rnd, n, row0, rows, sends.data_ptr(), dev.index, stream)
    if err:
        raise RuntimeError(f"pool2_shard_sends: CUDA launch failed with cudaError_t {err}")
    pool2_shard_sends.launches += 1


# The sends launches (one a device where a run starts or resumes).
pool2_shard_sends.launches = 0


def shard_verdict(u, target: int, ctrl, need=None, global_term: bool = False) -> None:
    """The round's verdict on ``u`` (int32 [S], one count a slot, on
    ctrl's device): unless ctrl[0] (done) is set, count the round in
    ctrl[1] and set done once sum(u) reaches the target, the round's quorum
    need (``need``, int32 [1] on ctrl's device) or, under global
    termination (u the unstable counts), 0."""
    if ctrl.device.type == "cpu":
        if not int(ctrl[0]):
            ctrl[1] += 1
            ctrl[0] = int(_fires(int(u.sum()), target, need, global_term))
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(ctrl.device).cuda_stream)
    fn = kernels.entry("fused_pool2_shard", "gossip_pool2_shard_verdict",
                       _SIGNATURES["gossip_pool2_shard_verdict"])
    err = fn(ctypes.c_void_p(u.data_ptr()), u.numel(), target,
             None if need is None else ctypes.c_void_p(need.data_ptr()), int(global_term),
             ctypes.c_void_p(ctrl.data_ptr()), ctrl.device.index, stream)
    if err:
        raise RuntimeError(f"pool2_shard_verdict: CUDA launch failed with "
                           f"cudaError_t {err}")


def round_kw(topo: Topology, cfg: SimConfig) -> dict:
    """The round wrappers' keywords of a config."""
    if cfg.algorithm == "push-sum":
        return {"n": topo.n, "delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
    return {"n": topo.n, "rumor_target": cfg.resolved_rumor_target,
            "suppress": cfg.resolved_suppress}


# The state's planes that are summary planes (read by other nodes) and the
# node's own: push-sum (s, w | tc), gossip (active | count).
SUMMARY_OF = {"push-sum": (0, 1), "gossip": (1,)}
OWN_OF = {"push-sum": (2,), "gossip": (0,)}


def split_state(state, algorithm: str):
    """(summary planes, own planes) of a state in its canonical order."""
    return (tuple(state[p] for p in SUMMARY_OF[algorithm]),
            tuple(state[p] for p in OWN_OF[algorithm]))


def join_state(glob, own, algorithm: str) -> tuple:
    """The state in its canonical order from (summary, own) planes."""
    out = [None] * (len(glob) + len(own))
    for p, x in zip(SUMMARY_OF[algorithm] + OWN_OF[algorithm], tuple(glob) + tuple(own)):
        out[p] = x
    return tuple(out)


def _round_fn(algorithm: str):
    if algorithm == "push-sum":
        return pushsum_pool2_shard_round
    return gossip_pool2_shard_round


# ---------------------------------------------------------------------------
# The JAX factories' functional form: one round of one shard from the global
# state, for the tests and the card's checks.
# ---------------------------------------------------------------------------


def _shard_chunk(algorithm: str, state, keys, offs, row0: int, rows_loc: int, kw: dict,
                 faults=None, rnd: int = 0):
    """One round of the shard at ``row0`` from the global [R, 128] ``state``
    on one device, as the device's launch over that shard's rows alone.
    Under ``faults`` (the run's fused.Faults) the round ``rnd``'s send bits
    of every row are written first, one sends launch a shard-sized block,
    as a run's first round has them. Returns (its planes in the state's
    order, u)."""
    dev, R = state[0].device, state[0].shape[0]
    glob, own = split_state(state, algorithm)
    glob_out = tuple(torch.empty_like(x) for x in glob)
    own_in = tuple(x[row0:row0 + rows_loc].contiguous() for x in own)
    own_out = tuple(torch.empty_like(x) for x in own_in)
    u, acc, ctrl = (torch.zeros(k, dtype=torch.int32, device=dev) for k in (1, 2, 2))
    k = torch.tensor([[int(keys[0]), int(keys[1])]], dtype=torch.int64, device=dev)
    o = torch.tensor([[int(d) for d in offs]], dtype=torch.int32, device=dev)
    shard_faults = None
    if faults is not None:
        death = faults.death_flat(R * LANES, dev)
        death = None if death is None else death.reshape(R, LANES)
        sends = torch.zeros(R // 8, LANES, dtype=torch.uint8, device=dev)
        for lo in range(0, R, rows_loc):
            pool2_shard_sends(sends, None if algorithm == "push-sum" else glob[0],
                              None if death is None else death[lo:lo + rows_loc].contiguous(),
                              keys, rnd, lo, rows_loc, n=kw["n"], thresh=faults.thresh or 0)
        shard_faults = ShardFaults(
            faults.thresh or 0,
            None if death is None else death[row0:row0 + rows_loc].contiguous(), None,
            rnd, faults.global_term, sends, None)
    _round_fn(algorithm)(glob, glob_out, own_in, own_out, k, o, row0, **kw, u=u, acc=acc,
                         ctrl=ctrl, faults=shard_faults)
    return join_state(_rows_of(glob_out, row0, rows_loc), own_out, algorithm), u[0]


def make_pushsum_pool2_shard_chunk(topo: Topology, cfg: SimConfig, rows_loc: int,
                                   layout):
    """``chunk_fn(state3, keys, offs, row0, rnd=0) -> (state3', u)``: one
    push-sum round (absolute round ``rnd``) over the shard at ``row0`` from
    the global (s, w, tc) [R, 128] planes (the JAX factory's contract, its
    gate keys and death windows drawn here from the config: the round's
    send bits; its delivered summary is here the global planes, and the
    kernel does not tile, so without its PT), through
    ``pushsum_pool2_shard_round``; returns the shard's planes."""
    del layout
    kw = round_kw(topo, cfg)
    faults = fused.run_faults(cfg, topo.n)

    def chunk_fn(state3, keys, offs, row0, rnd=0):
        return _shard_chunk("push-sum", state3, keys, offs, row0, rows_loc, kw, faults,
                            rnd)

    return chunk_fn


def make_gossip_pool2_shard_chunk(topo: Topology, cfg: SimConfig, rows_loc: int,
                                  layout):
    """Gossip analog of ``make_pushsum_pool2_shard_chunk``: (count,
    active)."""
    del layout
    kw = round_kw(topo, cfg)
    faults = fused.run_faults(cfg, topo.n)

    def chunk_fn(state2, keys, offs, row0, rnd=0):
        return _shard_chunk("gossip", state2, keys, offs, row0, rows_loc, kw, faults, rnd)

    return chunk_fn


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def _start_rows(topo, cfg, key, placed, layout, start_state):
    """Per device (``placed``), its rows of the start planes in the
    canonical order, on the device: from ``start_state`` (canonical [n]
    tensors), or built from the global row index (no global host array)."""
    from ..models.runner import draw_leader

    n = topo.n
    if start_state is not None:
        if cfg.algorithm == "push-sum":
            tc = torch.where(start_state.conv.cpu(),
                             start_state.term.cpu().to(torch.int32) | TC_CONV_BIT,
                             start_state.term.cpu().to(torch.int32))
            full = (fused._pad2d(start_state.s.cpu().to(torch.float32), layout, 0.0),
                    fused._pad2d(start_state.w.cpu().to(torch.float32), layout, 1.0),
                    fused._pad2d(tc.to(torch.int32), layout, 0))
        else:
            full = (fused._pad2d(start_state.count.cpu().to(torch.int32), layout, 0),
                    fused._pad2d(start_state.active.cpu().to(torch.int32), layout, 0))
        return [tuple(p[g.row0:g.row0 + g.rows].contiguous().to(g.device) for p in full)
                for g in placed]

    def ids(g):
        return mesh_mod.flat_ids(g.row0, g.row0 + g.rows, LANES, g.device)

    if cfg.algorithm == "push-sum":
        term0 = cfg.initial_term_round
        return [(torch.where(ids(g) < n, ids(g), 0).to(torch.float32),
                 torch.ones(g.rows, LANES, dtype=torch.float32, device=g.device),
                 torch.where(ids(g) < n, term0, 0).to(torch.int32)) for g in placed]
    leader = draw_leader(key, topo, cfg)
    receipt = int(cfg.reference and topo.kind == "full")
    return [(((ids(g) == leader) * receipt).to(torch.int32),
             (ids(g) == leader).to(torch.int32)) for g in placed]


class ShardControl:
    """The control block of a run of one-round super-steps over count slots
    on ``devices`` (a shard each, or a device each): on the home device
    (slot 0's) the done flag and round counter ``ctrl`` (int32 [2]) and the
    slots' counts of each round parity ``u_all`` (int32 [2, S]); on every
    other device a copy of ctrl and each of its slots' counts; per slot its
    int32 [2] scratch."""

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
        """Slot s's u, acc and ctrl operands in a round of parity ``par``."""
        return {"u": self.u_of[s][par], "acc": self.acc[s],
                "ctrl": self.ctrl_on[self.devices[s]]}


def run_round_supersteps(topo: Topology, cfg: SimConfig, ctl: ShardControl, *,
                         start_round: int, target: int, t_enter: float, library: str,
                         draw, launch_round, final_state, ahead: int = 0,
                         prologue=None, verdict_in_launch: bool = False,
                         need_of=None, global_term: bool = False, on_chunk=None):
    """Run one-round super-steps to convergence or cfg.max_rounds and return
    the RunResult: chunks of STRIDE rounds queued through
    models/pipeline.py, one host sync each, each round's verdict ordered by
    parallel/overlap.py. ``draw(begin, count)`` gives the random streams
    of rounds begin.. (one item a round), drawn ``ahead`` rounds past each
    chunk; ``launch_round(r, stream, *later)`` queues round r's wire and
    launches, each slot's count into its ``ctl.args`` slot, with the
    streams of rounds r + 1..r + ahead as ``later``; ``final_state(par,
    done)`` joins the planes of parity ``par`` into the canonical state
    (``done`` the run's verdict). With ``verdict_in_launch`` the launches
    take the verdict themselves (one slot, on the home device), so none is
    queued. A queued verdict compares the slots' counts with the target,
    with round r's quorum need ``need_of(r)`` (an int32 [1] tensor on the
    home device) where it is given, or under ``global_term`` with 0. ``library`` names the
    kernels' source, loaded (with the verdict's) before the run's clock
    starts; ``prologue()``, if given, is queued then too, ahead of the
    first round. Under a boundary observer (``on_chunk``, the stall
    watchdog, step timing) the loop runs at depth 1, since the next chunk
    would overwrite the planes a retired boundary's state lies in; the
    hooks read ``final_state`` on the host."""
    from ..models import pipeline as pipeline_mod
    from ..models.runner import _finalize_result, boundary_hooks, hook_kw

    home = ctl.home
    streams = {}

    def launch(r):
        launch_round(r, *(streams[r + i] for i in range(ahead + 1)))
        for s, dev in enumerate(ctl.devices):
            if dev != home:
                ctl.u_all[r % 2, s].copy_(ctl.u_of[s][r % 2][0])

    def verdict(r):
        if verdict_in_launch:
            return
        shard_verdict(ctl.u_all[r % 2], target, ctl.ctrl,
                      need=None if need_of is None else need_of(r), global_term=global_term)
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

    def retired(rounds, _):
        state = final_state(rounds % 2, bool(ctl.ctrl[0]))
        return type(state)(*(x.cpu() for x in state))

    on_retire, should_stop, watchdog = boundary_hooks(topo, cfg, target, on_chunk,
                                                      retired)
    hooked = on_retire is not None or should_stop is not None or cfg.step_timing
    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=None, status0=ctl.ctrl[[1, 0]].to(torch.int64),
        start_round=start_round, max_rounds=cfg.max_rounds, stride=STRIDE,
        depth=1 if hooked else cfg.pipeline_chunks,
        **hook_kw(cfg, on_retire, should_stop),
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    result = _finalize_result(topo, cfg, final_state(loop.rounds % 2, loop.done),
                              loop.rounds, target, compile_s, run_s, loop.done, loop, home,
                              stalled=watchdog.stalled)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result


def _on_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if dev.type == "cpu" else fused_pool._upload(x, dev)


def run_pool2_sharded(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh, key,
                      start_state=None, start_round: int = 0,
                      t_enter: Optional[float] = None, on_chunk=None):
    """Sharded replicated-pool2 run (engine='fused', n_devices > 1, full
    with delivery='pool'), to convergence or cfg.max_rounds; returns the
    RunResult, its state the canonical [n] planes joined from the devices.

    Each distinct device holds its global summary planes and its rows of
    the others in ping/pong form: round r reads set r % 2 and writes the
    other, never its inputs, so the planes after r rounds are set r % 2, a
    verdict's round counter names them, and a deferred verdict that fires
    rolls the next round back by the counter alone. The run's control block
    (``ShardControl``, a count slot a device) lives on the home device, and
    ``run_round_supersteps`` drives the rounds; the keys and displacements
    of DRAW_ROUNDS rounds at a time are drawn and uploaded to every device
    once, and each round's launches read their row of them.

    Under the failure model (the run's fused.Faults) each device also holds
    a global send-bit plane per round parity, which the wire carries with
    the summary rows, and its own rows of the death plane; the rounds'
    quorum needs ride the streams, a round's launches write the next
    round's bits (so the streams are drawn one round ahead), and a sends
    launch a device writes the first round's."""
    from ..models import gossip as gossip_mod
    from ..models import pushsum as pushsum_mod
    from ..models.runner import _host_done

    t_enter = time.perf_counter() if t_enter is None else t_enter
    S = mesh.size
    plan = plan_pool2_sharded(topo, cfg, S)
    if isinstance(plan, str):
        raise ValueError(f"engine='fused' with n_devices={S} unavailable: {plan}")
    rows_loc, _PT, layout, wire_kind = plan
    n, R, P = topo.n, layout.rows, cfg.pool_size
    algorithm = cfg.algorithm
    target = cfg.resolved_target_count(n, topo.target_count)
    placed = place_shards(mesh.devices, rows_loc)
    G = len(placed)
    in_launch = G == 1
    faults = fused.run_faults(cfg, n)
    thresh = 0 if faults is None or faults.thresh is None else faults.thresh
    global_term = faults is not None and faults.global_term

    start = _start_rows(topo, cfg, key, placed, layout, start_state)
    done0 = start_state is not None and _host_done(start_state, target, cfg, start_round)
    par0 = start_round % 2
    # Per device g: glob[g][par] its global summary planes of parity par,
    # own[g][par] its rows of the others; under the failure model bits[g][par]
    # its global send-bit plane and death[g] its rows of the death plane.
    glob, own, bits, death = [], [], [], []
    for g, rows in zip(placed, start):
        summary, mine = split_state(rows, algorithm)
        sets = [tuple(torch.zeros(R, LANES, dtype=x.dtype, device=g.device)
                      for x in summary) for _ in range(2)]
        for x, y in zip(sets[par0], summary):
            x[g.row0:g.row0 + g.rows] = y
        glob.append(sets)
        pair = [None, None]
        pair[par0] = mine
        pair[1 - par0] = tuple(torch.empty_like(x) for x in mine)
        own.append(pair)
        if faults is not None:
            bits.append([torch.zeros(R // 8, LANES, dtype=torch.uint8, device=g.device)
                         for _ in range(2)])
            flat = faults.death_flat(layout.n_pad, "cpu")
            death.append(None if flat is None else flat[
                g.row0 * LANES:(g.row0 + g.rows) * LANES].reshape(g.rows, LANES).to(g.device))
    del start
    ctl = ShardControl([g.device for g in placed], done0, start_round)
    round_fn = _round_fn(algorithm)
    kw = round_kw(topo, cfg)
    # The owner (device index) of each rows_loc-row block.
    owners = [g for g, dev_rows in enumerate(placed) for _ in range(dev_rows.rows // rows_loc)]
    if wire_kind == "all_gather":
        wires = [halo.replica_rows({g: glob[g][par] for g in range(G)}, rows_loc, owners)
                 + (halo.replica_rows({g: (bits[g][par],) for g in range(G)}, rows_loc // 8,
                                      owners) if bits else [])
                 for par in (0, 1)]
    margin = rows_loc + band_margin(layout)

    def wire(par, offs):
        if G == 1:
            return []
        if wire_kind == "all_gather":
            return wires[par]
        starts = band_starts(offs, layout)
        groups = halo.band_replica_rows({g: glob[g][par] for g in range(G)}, rows_loc,
                                        owners, starts, margin)
        if bits:
            # The bit planes' rows are 8-row groups; bands start and end on one.
            groups += halo.band_replica_rows({g: (bits[g][par],) for g in range(G)},
                                             rows_loc // 8, owners,
                                             [b // 8 for b in starts], margin // 8)
        return groups

    # The streams of rounds block["begin"].. on every device and on the host.
    block = {"begin": 0, "count": 0}

    def draw(begin, count):
        if count == 0:
            return []
        if not block["begin"] <= begin <= begin + count <= block["begin"] + block["count"]:
            size = max(count, DRAW_ROUNDS)
            keys = fused.round_keys(key, begin, size)
            offs = fused_pool.round_offsets(key, begin, size, P, n)
            needs = None if faults is None else faults.needs(begin, size)[0]
            block.update(begin=begin, count=size, offs=offs.tolist(), on=[
                (_on_device(keys, g.device), _on_device(offs, g.device)) for g in placed],
                needs=None if needs is None else [_on_device(needs, g.device)
                                                  for g in placed])
        at = begin - block["begin"]
        return [(at + i, block["on"], block["offs"][at + i]) for i in range(count)]

    def need_of(g, at):
        return None if block["needs"] is None else block["needs"][g][at:at + 1]

    def prologue():
        if faults is None:
            return
        keys = fused.round_keys(key, start_round, 1)[0].tolist()
        for g, d in enumerate(placed):
            pool2_shard_sends(bits[g][par0],
                              None if algorithm == "push-sum" else glob[g][par0][0],
                              death[g], keys, start_round, d.row0, d.rows, n=n,
                              thresh=thresh)

    def launch_round(r, stream, *_later):
        at, on, offs = stream
        par = r % 2
        halo.exchange_rows_batched(wire(par, offs))
        for g, dev_rows in enumerate(placed):
            args = ctl.args(g, par)
            shard_faults = None if faults is None else ShardFaults(
                thresh, death[g], need_of(g, at) if in_launch else None, r, global_term,
                bits[g][par], bits[g][1 - par])
            round_fn(glob[g][par], glob[g][1 - par], own[g][par], own[g][1 - par], *on[g],
                     dev_rows.row0, **kw, u=None if in_launch else args["u"],
                     acc=args["acc"], ctrl=args["ctrl"], target=target, at=at,
                     faults=shard_faults)

    def verdict_need(r):
        return need_of(0, r - block["begin"])

    def final_state(par, done):
        home = placed[0].device
        planes = [join_state(_rows_of(glob[g][par], d.row0, d.rows), own[g][par], algorithm)
                  for g, d in enumerate(placed)]
        joined = [torch.cat([p[i].to(home) for p in planes]).reshape(-1)[:n]
                  for i in range(len(planes[0]))]
        if algorithm == "push-sum":
            conv = (joined[2] & TC_CONV_BIT) != 0
            if global_term and done:
                # The global verdict latches conv on every real node.
                conv = torch.ones_like(conv)
            return pushsum_mod.PushSumState(
                s=joined[0], w=joined[1], term=joined[2] & TC_TERM_MASK, conv=conv)
        return gossip_mod.GossipState(
            count=joined[0], active=joined[1] != 0,
            conv=joined[0] >= cfg.resolved_rumor_target)

    return run_round_supersteps(topo, cfg, ctl, start_round=start_round, target=target,
                                t_enter=t_enter, library="fused_pool2_shard", draw=draw,
                                launch_round=launch_round, final_state=final_state,
                                ahead=0 if faults is None else 1, prologue=prologue,
                                verdict_in_launch=in_launch,
                                need_of=None if faults is None else verdict_need,
                                global_term=global_term, on_chunk=on_chunk)
