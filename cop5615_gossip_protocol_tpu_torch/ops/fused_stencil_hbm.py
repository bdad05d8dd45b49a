"""Streaming stencil engine: fused multi-round chunks on the six arithmetic
lattices (torus3d, ring, grid2d, grid3d, line, ref2d), up to 2**27 nodes.

One call runs a chunk of up to K synchronous push-sum or gossip rounds on
the padded ``[rows, 128]`` layout of the JAX package's
ops/fused_stencil_hbm.py (``_streaming_layout``), consuming per-round
fold_in keys, and stops early once the converged count reaches the target.
Every node draws one word at its global index and picks a direction from
the lattice's arithmetic direction pairs (``topology.lattice_dirs``), bitwise the
chunked engine's ``targets_explicit``; delivery sums the sorted
displacement classes in order, as ``deliver_stencil`` does.

``pushsum_stencil_hbm_chunk`` and ``gossip_stencil_hbm_chunk`` launch the
CUDA kernels of csrc/fused_stencil.cu on CUDA tensors and run their plain
torch versions (``*_plain``) on CPU tensors; the plain versions run on any
device and are what the kernels are held against. The resident lattice
tiers (ops/fused.py, ops/fused_stencil.py) compute the same function and
share the plain versions, the wrapper checks, ``kernel_chunk`` and the
per-slot directions word the kernels mark from (``dir_words``, built on
the host once per layout and device; the sharded lattice kernels read it
too). The push-sum wrapper takes the run's global termination
(``faults``), the one failure-model knob the JAX tier takes, and runs the
kernels' global instance; the plain versions carry the whole failure
model for every lattice tier.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..utils import kernels
from . import rng
from .fused import (
    LANES,
    Faults,
    clamp_cap_and_pad,
    class_sources,
    gossip_class_rounds,
    pushsum_class_rounds,
    threefry2x32_hash,
)
from .fused_pool import (
    TELE_ARGS,
    PoolLayout,
    _chunk_faults,
    _upload,
    build_pool_layout,
    fault_args,
    tele_args,
)
from .topology import Topology, lattice_dirs

MAX_STENCIL_HBM_NODES = 2**27
_HBM_KINDS = ("torus3d", "ring", "grid2d", "grid3d", "line", "ref2d")
# The lattice families of csrc/stencil.cuh (ref2d is wired as a line).
_KIND_IDS = {"ring": 0, "line": 1, "ref2d": 1, "grid2d": 2, "grid3d": 3,
             "torus3d": 4}
# Slots per host thread's chunk of the directions words (``dir_words``).
_WORDS_STEP = 1 << 20


def stencil_hbm_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the streaming stencil engine can run this config (the JAX
    tier's predicate; the port's configs are float32 by construction)."""
    if topo.kind not in _HBM_KINDS:
        return (
            f"topology {topo.kind!r} has no arithmetic displacement "
            f"columns (served kinds: {', '.join(_HBM_KINDS)})"
        )
    if cfg.faulted:
        # The JAX tier takes no failure model: the config runs on the
        # chunked engine.
        return "failure models not supported in this fused kernel"
    if topo.n > MAX_STENCIL_HBM_NODES:
        return (
            f"population {topo.n} exceeds the HBM-plane budget "
            f"({MAX_STENCIL_HBM_NODES} nodes)"
        )
    return None


def _n_lat(topo: Topology) -> int:
    """Nodes of the lattice proper: n, or n - 1 when the last node is the
    reference's unwired Q1 node (degree 0; the grids in reference
    semantics), whose live masks are then forced empty."""
    if topo.degree is not None and topo.degree.size and int(topo.degree[-1]) == 0:
        return topo.n - 1
    return topo.n


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """What the chunks need of a lattice topology."""

    kind: str
    n: int  # population
    n_lat: int  # nodes of the lattice proper (see _n_lat)
    classes: tuple  # the sorted mod-n displacement classes


def stencil_spec(topo: Topology) -> StencilSpec:
    offs = topo.offsets
    if topo.kind not in _HBM_KINDS or offs is None:
        raise ValueError(f"{topo.kind!r} n={topo.n} is not an arithmetic lattice")
    return StencilSpec(topo.kind, topo.n, _n_lat(topo),
                       tuple(int(d) for d in offs))


def _lattice_params(topo: Topology):
    """(dirs, wrap): ``dirs(idx)`` the lattice's direction pairs at global
    node indices ``idx`` (``topology.lattice_dirs``), and whether the
    lattice wraps (ring, torus3d: every direction live everywhere) or masks
    its boundary faces instead (grid2d, grid3d, line, ref2d)."""
    n, n_lat = topo.n, _n_lat(topo)
    return ((lambda idx: lattice_dirs(topo.kind, n, n_lat, idx)),
            topo.kind in ("ring", "torus3d"))


def _centered_sq(e: int, rows: int) -> int:
    """Centered row shift of a forward roll by ``e`` on a ``rows``-row
    ring: the signed window displacement the JAX plans cluster on."""
    q = e // LANES
    return q - rows if q > rows // 2 else q


def _plan_from_needs(needs, class_ds, PT: int, with_liveness: bool):
    """The JAX streaming tiers' greedy window grouping, for the sharded
    streaming plan's geometry (parallel/fused_hbm_sharded.py): ``needs``
    are (class index, d, roll e, centered row shift sq, blend side) rows;
    needs whose sq lie within one PT-row tile share a window of m_rows =
    PT + 16 + round8(span) rows. Returns (classes, groups, M):
    classes[ci] = (class_ds[ci], ((group, e, sq, take1), ...)), groups[gi]
    = (sq_hi, m_rows, live), M = the largest m_rows. The port's kernels do
    not stream windows; the plan's budgets are computed from these."""
    order = sorted(range(len(needs)), key=lambda i: needs[i][3])
    raw_groups = []
    cur, lo, hi = [], 0, 0
    for i in order:
        sq = needs[i][3]
        if cur and max(hi, sq) - min(lo, sq) <= PT:
            cur.append(i)
            lo, hi = min(lo, sq), max(hi, sq)
        else:
            if cur:
                raw_groups.append((cur, lo, hi))
            cur, lo, hi = [i], sq, sq
    raw_groups.append((cur, lo, hi))
    need_group, groups = {}, []
    for gi, (members, lo, hi) in enumerate(raw_groups):
        m_rows = PT + 16 + ((hi - lo + 7) // 8) * 8
        conds = []
        for i in members:
            need_group[i] = gi
            conds.append((needs[i][1], needs[i][4]))
        live = None
        if with_liveness and not any(t is None for _, t in conds):
            live = conds
        groups.append((hi, m_rows, live))
    classes = [(d, tuple((need_group[i], needs[i][2], needs[i][3], needs[i][4])
                         for i in range(len(needs)) if needs[i][0] == ci))
               for ci, d in enumerate(class_ds)]
    return classes, groups, max(m for _, m, _l in groups)


def _sample_disp_dirs(bits: torch.Tensor, pairs):
    """Per-node sampled mod-n displacement and degree from the direction
    pairs, bitwise sampling.targets_explicit: slot = the unsigned word
    modulo max(degree, 1), then the slot-th LIVE pair in column order.
    Returns (d, deg)."""
    deg = pairs[0][0].to(torch.int64)
    for live, _ in pairs[1:]:
        deg = deg + live.to(torch.int64)
    slot = bits % deg.clamp(min=1)
    d = torch.zeros_like(bits)
    cum = torch.zeros_like(bits)
    for live, disp in pairs:
        d = torch.where(live & (slot == cum), disp, d)
        cum = cum + live.to(torch.int64)
    return d, deg


def _streaming_layout(n: int) -> PoolLayout:
    """The pool layout with rows rounded up to a multiple of 4096 past 4096
    rows (the JAX streaming tier's layout). The pad lanes never send and
    never receive, so the padding leaves the trajectory unchanged."""
    base = build_pool_layout(n)
    if base.rows <= 4096 or base.rows % 4096 == 0:
        return base
    rows = -(-base.rows // 4096) * 4096
    return PoolLayout(n=n, n_pad=rows * LANES, rows=rows,
                      tiles=rows * base.tiles // base.rows)


@functools.lru_cache(maxsize=4)
def _dir_words_host(spec, R: int) -> np.ndarray:
    """``dir_words`` on the host, shared by the devices that ask for it."""
    classes = np.asarray(spec.classes, dtype=np.int32)
    if len(classes) > 16:
        raise ValueError("at most 16 displacement classes fit a 4-bit class id")
    words = np.empty(R * LANES, dtype=np.int32)

    def fill(lo):
        g = np.arange(lo, min(lo + _WORDS_STEP, R * LANES), dtype=np.int32)
        word = np.zeros_like(g)
        deg = np.zeros_like(g)
        for live, d in lattice_dirs(spec.kind, spec.n, spec.n_lat, g):
            live = live & (g < spec.n)
            k = np.minimum(np.searchsorted(classes, d), len(classes) - 1).astype(np.int32)
            if not np.all(~live | (classes[k] == d)):
                raise ValueError(f"{spec.kind}: a live displacement is not a class")
            word |= (k << (4 * deg)) * live
            deg += live
        words[lo:lo + g.size] = word | (deg << 24)

    # numpy releases the GIL in its loops, so the chunks run in parallel.
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(0, R * LANES, _WORDS_STEP)))
    return words


@functools.lru_cache(maxsize=4)
def dir_words(spec, R: int, device) -> torch.Tensor:
    """int32 [R * 128] static directions word of every slot of an [R, 128]
    layout, built on the host (as the JAX engines build their displacement
    planes) and copied to ``device``: bits 4k..4k+3 hold the class id of
    the slot's k-th live direction in the topology's column order, bits
    24..26 its degree; 0 for pad lanes and degree-0 nodes (csrc/shard.cuh
    ``word_class`` reads it). Every lattice kernel marks from it: the
    single-device ones (csrc/fused_stencil.cu, csrc/fused_resident.cu) and
    the sharded ones, at global flat indices. Cached per (spec, R, device),
    so a run builds it once, in its set-up. Raises ValueError if a live
    direction's displacement is not a class or there are more than 16
    classes."""
    return torch.from_numpy(_dir_words_host(spec, R)).to(device)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in torch, on any device.
# ---------------------------------------------------------------------------


def _stencil_classes(spec: StencilSpec, keys, rows: int, dev):
    """``round_classes`` of the lattice chunks (fused.pushsum_class_rounds):
    each node draws its word at its global index and marks the class of
    the displacement its direction pairs select; the classes are the
    sorted displacement classes, each with its static sources."""
    n = spec.n
    jflat = torch.arange(rows * LANES, dtype=torch.int64, device=dev)
    padm = jflat >= n
    pairs = lattice_dirs(spec.kind, n, spec.n_lat, jflat)
    classes = torch.tensor(spec.classes, dtype=torch.int64, device=dev)
    srcs = [(q, class_sources(rows * LANES, d, n, dev))
            for q, d in enumerate(spec.classes)]

    def round_classes(k):
        bits = threefry2x32_hash(keys[k, 0], keys[k, 1], jflat)
        d, deg = _sample_disp_dirs(bits, pairs)
        cls = torch.searchsorted(classes, d)
        return torch.where((deg > 0) & ~padm, cls, -1), srcs

    return round_classes


def pushsum_stencil_hbm_chunk_plain(state4, keys, start: int, cap: int, *,
                                    spec: StencilSpec, target: int,
                                    delta: float, term_rounds: int,
                                    faults: Optional[Faults] = None,
                                    telemetry=None):
    """Up to K = keys.shape[0] push-sum lattice rounds on the padded planes
    (s, w, term, conv_i32) of any [rows, 128] layout that covers n: the
    plain version of every lattice tier's kernels (this streaming tier's
    and the resident tiers' of ops/fused.py and ops/fused_stencil.py), with
    the run's drop gate, crash-stop and global termination (``faults``, the
    run's fused.Faults or None; fused.pushsum_class_rounds). Returns
    (state4', rounds_executed), and with ``telemetry`` (a fused.RowSpec:
    the whole-array tier's telemetry instance) the chunk's rows too."""
    dev, rows = state4[0].device, state4[0].shape[0]
    cap, keys = clamp_cap_and_pad(start, cap, keys)
    return pushsum_class_rounds(
        state4, start, cap, keys.shape[0],
        _stencil_classes(spec, keys.to(dev), rows, dev), n=spec.n,
        target=target, delta=delta, term_rounds=term_rounds,
        faults=_chunk_faults(faults, keys, start, rows, dev), fold_s=False,
        telemetry=telemetry)


def gossip_stencil_hbm_chunk_plain(state3, keys, start: int, cap: int, *,
                                   spec: StencilSpec, target: int,
                                   rumor_target: int, suppress: bool,
                                   faults: Optional[Faults] = None,
                                   telemetry=None):
    """Up to K gossip lattice rounds on the padded planes (count,
    active_i32, conv_i32), with receiver-side suppression and the run's
    drop gate and crash-stop (``faults``); like
    ``pushsum_stencil_hbm_chunk_plain``, the plain version of every lattice
    tier. Returns (state3', rounds_executed)."""
    dev, rows = state3[0].device, state3[0].shape[0]
    cap, keys = clamp_cap_and_pad(start, cap, keys)
    return gossip_class_rounds(
        state3, start, cap, keys.shape[0],
        _stencil_classes(spec, keys.to(dev), rows, dev), n=spec.n,
        target=target, rumor_target=rumor_target, suppress=suppress,
        faults=_chunk_faults(faults, keys, start, rows, dev), telemetry=telemetry)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two.
# ---------------------------------------------------------------------------


def _check(planes, dtypes, keys, spec: StencilSpec, rows: int) -> torch.device:
    """The checks of every lattice tier's wrappers: state planes of the
    tier's [rows, 128] layout on one cpu or cuda device, host-drawn keys,
    and a lattice the kernels take. Returns the planes' device."""
    if len(planes) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} state planes, got {len(planes)}")
    shape = (rows, LANES)
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"stencil chunks run on cpu or cuda tensors, got {dev}")
    for x, dt in zip(planes, dtypes):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(
                f"state plane must be {dt} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError("state planes must be contiguous")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64 [K, 2], got {keys.dtype} {tuple(keys.shape)}")
    if keys.device.type != "cpu":
        raise ValueError("keys are a host-drawn stream: pass a CPU tensor")
    words = keys.numpy()
    if words.size and (words.min() < 0 or words.max() > rng.MASK):
        raise ValueError("keys must hold uint32 words")
    if spec.kind not in _KIND_IDS or not 1 <= len(spec.classes) <= 16:
        raise ValueError(f"not a stencil lattice the kernels take: {spec}")
    if spec.n > MAX_STENCIL_HBM_NODES:
        raise ValueError(f"population {spec.n} exceeds {MAX_STENCIL_HBM_NODES}")
    return dev


def global_only(faults: Optional[Faults], tier: str) -> Optional[Faults]:
    """The failure model of a tier whose JAX kernels take global
    termination alone (the tiled and streaming lattice tiers, both imp
    tiers): ``faults`` as it is, or ValueError on a drop gate or a death
    plane, which the JAX ladder runs on the chunked engine."""
    if faults is not None and (faults.thresh is not None or faults.death is not None):
        raise ValueError(f"{tier} takes global termination only; the drop gate and "
                         "crash-stop run on the chunked engine")
    return faults


def global_flag(faults: Optional[Faults]) -> int:
    """The push-sum entry points' ``global`` argument."""
    return int(faults is not None and faults.global_term)


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# The lattice entry points of csrc/fused_stencil.cu and csrc/fused_resident.cu
# take the same arguments; then the streaming push-sum one takes global
# termination's flag, and the resident ones the failure model's (faulted,
# thresh, death, needs, need_init, start, and push-sum's global) and the
# telemetry instance's (fused_pool.TELE_ARGS).
_PUSHSUM_ARGS = [_P] * 17 + [_I] * 6 + [_F] + [_I] * 2
_GOSSIP_ARGS = [_P] * 14 + [_I] * 9
_FAULT_ARGS = [_I, _U, _P, _P, _I, _I]


def _argtypes(source: str, pushsum: bool):
    """The argtypes of a lattice entry point of csrc/<source>.cu."""
    args = list(_PUSHSUM_ARGS if pushsum else _GOSSIP_ARGS)
    if source == "fused_resident":
        args += (_FAULT_ARGS + ([_P, _I, _I, _I] if pushsum else [_P, _I]) + [_P, _I]
                 + TELE_ARGS)
    elif pushsum:
        args.append(_I)
    return args + [_I, _P]


def kernel_chunk(source: str, name: str, state, keys, start: int, cap: int,
                 spec: StencilSpec, tail, faults: Optional[Faults] = None,
                 telemetry: bool = False):
    """Queue one chunk through the lattice entry point ``name`` of
    csrc/<source>.cu on the current stream of the state's device and raise
    on a launch error. ``tail`` holds the protocol's trailing arguments;
    the resident entry points (csrc/fused_resident.cu) then take the
    failure model's, where ``faults`` (the run's, or None) picks the
    kernels' faulted instance and gives its inputs, and ``telemetry`` their
    telemetry instance (with the faulted one, under no fault too). Returns
    (state', rounds_executed, rounds the chunk may run[, rows])."""
    dev = state[0].device
    cap, keys = clamp_cap_and_pad(start, cap, keys)
    resident = source == "fused_resident"
    # One copy to the card for the host streams: the keys, then under a
    # crash model the rounds' quorum needs (the kernels fold the gate keys
    # themselves).
    needs = need_init = None
    if faults is not None:
        needs, need_init = faults.needs(start, keys.shape[0])
    parts = [keys.contiguous().view(torch.int32).reshape(-1)]
    if needs is not None:
        parts.append(needs)
    streams = _upload(torch.cat(parts) if len(parts) > 1 else keys, dev)
    rounds = max(0, cap - start)
    n_pad = state[0].numel()
    planes = len(state) * n_pad
    dirs = dir_words(spec, state[0].shape[0], dev)
    # Two allocations a chunk and few tensor ops, each of which costs a
    # short chunk several µs of host time: the result planes with the
    # control words behind them (done, rounds executed, then 8 * (rounds +
    # 2) bytes of scratch; the entry point zeroes them), and the other plane
    # set with the two mark planes (round j reads half j % 2), passed as
    # raw pointers. Both stay safe after this returns: the caching allocator
    # hands their memory only to work queued later on the same stream.
    head = torch.empty(planes + 2 + 2 * (rounds + 2), dtype=torch.int32, device=dev)
    work = torch.empty(planes + n_pad // 2, dtype=torch.int32, device=dev)
    out = [p if p.dtype == x.dtype else p.view(x.dtype) for p, x in
           zip(head[:planes].view(len(state), *state[0].shape).unbind(0), state)]
    other = [work.data_ptr() + 4 * i * n_pad for i in range(len(state))]
    fn = kernels.entry(source, name, _argtypes(source, len(state) == 4))
    classes = np.ascontiguousarray(spec.classes, dtype=np.int32)
    lattice = (len(spec.classes), _KIND_IDS[spec.kind], spec.n,
               spec.n - spec.n_lat)
    fargs = [] if not resident else fault_args(
        faults, None if needs is None else streams.data_ptr() + 8 * keys.numel(),
        need_init, start, n_pad, dev, len(state) == 4, revive=True)
    rows_out = None
    if resident:
        targs = [None, None, 0, ctypes.c_float(0.0)]
        if telemetry:
            fargs[0] = 1
            targs, rows_out, _scratch = tele_args(
                "fused_resident", len(state) == 4, 0, spec.n, n_pad, rounds,
                keys.shape[0], dev)
        fargs += targs
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[x.data_ptr() for x in (*state, *out)], *other,
             work.data_ptr() + 4 * planes, streams.data_ptr(), dirs.data_ptr(),
             head.data_ptr() + 4 * planes, classes.ctypes.data, *lattice,
             n_pad, rounds, *tail, *fargs, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    out = (tuple(out), head[planes + 1], rounds)
    return out if rows_out is None else (*out, rows_out)


def pushsum_stencil_hbm_chunk(state4, keys, start: int, cap: int, *,
                              spec: StencilSpec, target: int, delta: float,
                              term_rounds: int, faults: Optional[Faults] = None):
    """Up to K = keys.shape[0] push-sum lattice rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged.

    ``state4`` is (s, w, term, conv_i32) in the padded [rows, 128] layout
    (``_streaming_layout``) on one device; ``keys`` int64 [K, 2] fold_in
    keys (uint32 words, fused.round_keys) are a CPU tensor. Returns
    (state4', rounds_executed) with rounds_executed a 0-dim int32 tensor on
    the state's device; the inputs are left unchanged. CUDA state runs the
    kernel and CPU state the plain version. ``faults`` (the run's
    fused.Faults, or None) may carry global termination only, which runs
    the kernels' global instance: a gate or a death plane raises
    ValueError."""
    dev = _check(state4, (torch.float32, torch.float32, torch.int32, torch.int32),
                 keys, spec, _streaming_layout(spec.n).rows)
    faults = global_only(faults, "the streaming stencil tier (stencil_hbm)")
    if dev.type == "cpu":
        return pushsum_stencil_hbm_chunk_plain(
            state4, keys, start, cap, spec=spec, target=target, delta=delta,
            term_rounds=term_rounds, faults=faults,
        )
    out, executed, rounds = kernel_chunk(
        "fused_stencil", "gossip_pushsum_stencil_chunk", state4, keys, start, cap,
        spec, (ctypes.c_float(delta), term_rounds, target, global_flag(faults)))
    pushsum_stencil_hbm_chunk.launches += 3 + rounds
    return out, executed


def gossip_stencil_hbm_chunk(state3, keys, start: int, cap: int, *,
                             spec: StencilSpec, target: int,
                             rumor_target: int, suppress: bool):
    """Gossip analog of ``pushsum_stencil_hbm_chunk``: ``state3`` is
    (count, active_i32, conv_i32); converged-target suppression is
    receiver-side."""
    dev = _check(state3, (torch.int32,) * 3, keys, spec,
                 _streaming_layout(spec.n).rows)
    if dev.type == "cpu":
        return gossip_stencil_hbm_chunk_plain(
            state3, keys, start, cap, spec=spec, target=target,
            rumor_target=rumor_target, suppress=suppress,
        )
    out, executed, rounds = kernel_chunk(
        "fused_stencil", "gossip_gossip_stencil_chunk", state3, keys, start, cap,
        spec, (rumor_target, int(suppress), target))
    gossip_stencil_hbm_chunk.launches += 3 + rounds
    return out, executed


# Kernel launches queued by each wrapper (init, the prologue, one a round,
# finish), counted where the kernel is launched and nowhere else.
pushsum_stencil_hbm_chunk.launches = 0
gossip_stencil_hbm_chunk.launches = 0
