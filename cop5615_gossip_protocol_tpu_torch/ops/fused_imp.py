"""Fused imp engine: multi-round chunks on imp2d/imp3d under pooled
long-range sampling ("stencil + P pooled classes"), up to 2**27 nodes.

One call runs a chunk of up to K synchronous push-sum or gossip rounds on
the padded ``[rows, 128]`` pool layout (``build_pool_layout``), consuming
per-round fold_in keys, displacement pools (``fused_pool.round_offsets``)
and choice keys (``choice_round_keys``), and stops early once the converged
count reaches the target. Per round, bitwise the chunked engine's
``imp_pool_parts`` and ``deliver_imp_pool``:

- every node draws its slot word at its global index off the round key;
  slot = word % degree over its live lattice directions (the grid2d/grid3d
  pairs of ``topology.lattice_dirs``) and, last, its long-range slot;
- a lattice slot marks the class of its displacement (its index q in the
  sorted lattice offsets), the long-range slot marks class L + its pool
  choice, 4 bits of a packed word drawn off fold_in(round key,
  IMP_CHOICE_TAG);
- each receiver sums the halved sends from 0.0 over the L lattice classes,
  then the P pool classes: class ids, not displacements, so a pool offset
  equal to a lattice displacement (or to another slot's) delivers once.

The JAX package computes this function in two tiers, a VMEM-resident one
(its ops/fused_imp.py) and an HBM-streaming one (its ops/fused_imp_hbm.py);
the split is the TPU's VMEM budget. On the card one kernel pair over
ping/pong device planes (csrc/fused_imp.cu) serves both: the ladder still
names the JAX tier (``imp_fused_support`` here, ``imp_hbm_support`` in
ops/fused_imp_hbm.py), and each tier's wrappers count their own launches.
The kernels read each node's class through its static directions word
(``imp_dir_words``, built on the card once per layout and device; the
sharded imp kernels read it too).

``pushsum_imp_chunk`` and ``gossip_imp_chunk`` launch the kernels on CUDA
tensors and run the plain torch versions (``*_plain``) on CPU tensors; the
plain versions run on any device and are what the kernels are held against.
The kernels take honest (batched-semantics) builds, whose lattice is the
whole grid: reference semantics cannot run pooled delivery at all (Q9).
The push-sum wrappers take the run's global termination (``faults``), the
one failure-model knob both JAX imp tiers take, and run the kernels'
global instance; the drop gate and crash-stop run on the chunked engine.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
    round_keys,
    threefry2x32_hash,
    threefry_bits_2d,
)
from .fused_pool import POOL_SIZES, _chunk_faults, _upload, build_pool_layout
from .fused_stencil_hbm import _sample_disp_dirs, global_flag, global_only
from .sampling import (
    IMP_CHOICE_TAG,
    POOL_CHOICE_BITS,
    POOL_PACK,
    choice_from_words,
    pool_rows,
)
from .topology import IMP_LATTICE, Topology, imp_lattice_offsets, lattice_dirs

# The JAX resident tier's plane budget, copied as the ladder's predicate.
_VMEM_BUDGET = 100 * 1024 * 1024
# Slots per step of ``imp_dir_words``' build, which bounds its temporaries.
_WORDS_STEP = 1 << 22


def _plane_bytes(n_pad: int, max_deg: int, algorithm: str) -> int:
    """The JAX resident tier's VMEM bytes (4-byte words a node): push-sum 4
    state + 2x2 doubled sends + 2 doubled class plane; gossip 3 state + 2
    doubled class plane; both max_deg class columns + 1 degree."""
    per_node = (4 + 4 + 2) if algorithm == "push-sum" else (3 + 2)
    return n_pad * 4 * (per_node + max_deg + 1)


def imp_reason(topo: Topology, cfg: SimConfig, single_device: str) -> Optional[str]:
    """The checks both imp tiers share, in the JAX predicates' order: None
    if the kernels take this config, else the reason not; ``single_device``
    is the tier's reason for an n_devices > 1 config."""
    if topo.kind not in IMP_LATTICE:
        return f"topology {topo.kind!r} is not an imp (lattice+extra) kind"
    if cfg.reference:
        return (
            "pooled long-range sampling cannot reproduce the reference's "
            "static extra edge (Q9); reference semantics use scatter"
        )
    if imp_lattice_offsets(topo) is None:
        return "lattice slots are not offset-structured for this instance"
    if topo.target_count != topo.n:
        return "the fused imp kernels take batched-semantics builds"
    if cfg.faulted:
        # The JAX tier takes no failure model: the config runs on the
        # chunked engine.
        return "failure models not supported in this fused kernel"
    if cfg.n_devices is not None and cfg.n_devices > 1:
        return single_device
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    return None


def imp_fused_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the JAX package's resident imp tier would run this config,
    else the reason not (its predicate; the port's configs are float32
    by construction)."""
    reason = imp_reason(topo, cfg, "fused engine is single-device")
    if reason is not None:
        return reason
    layout = build_pool_layout(topo.n)
    if _plane_bytes(layout.n_pad, topo.max_deg, cfg.algorithm) > _VMEM_BUDGET:
        return (
            f"population {topo.n} (max_deg {topo.max_deg}) exceeds the "
            "VMEM-resident plane budget"
        )
    return None


@dataclasses.dataclass(frozen=True)
class ImpSpec:
    """What the chunks need of an imp topology."""

    kind: str  # imp2d or imp3d
    n: int  # population: the whole grid
    classes: tuple  # the sorted mod-n lattice displacement classes


def imp_spec(topo: Topology) -> ImpSpec:
    offs = imp_lattice_offsets(topo)
    if topo.kind not in IMP_LATTICE or offs is None or topo.target_count != topo.n:
        raise ValueError(f"{topo.kind!r} n={topo.n} is not a batched imp build")
    return ImpSpec(topo.kind, topo.n, tuple(int(d) for d in offs))


def choice_round_keys(base_key, start: int, count: int) -> torch.Tensor:
    """int64 ``[count, 2]`` keys of the per-round pool-choice stream:
    fold_in(round key, IMP_CHOICE_TAG) for absolute rounds start.., the
    key sampling.imp_choice_key gives each round."""
    keys = round_keys(base_key, start, count)
    a, b = rng.threefry2x32(keys[:, 0], keys[:, 1], 0, IMP_CHOICE_TAG)
    return torch.stack([a, b], dim=1)


@functools.lru_cache(maxsize=4)
def imp_dir_words(spec: ImpSpec, R: int, device) -> torch.Tensor:
    """int32 [R * 128] static directions word of every slot of an [R, 128]
    layout, built with torch on ``device`` (no host pass, which would cost
    more than a run at 16.8M nodes): bits 4k..4k+3 hold the class id (the
    index in the sorted lattice classes) of the slot's k-th live grid
    direction in the topology's column order, bits 24..26 its lattice
    degree; 0 on pad lanes (csrc/imp.cuh ``imp_lattice_class`` reads it, with
    the long-range slot after the lattice ones). The imp kernels mark from
    it, single-device and sharded at global flat indices. Cached per
    (spec, R, device), so a run builds it once, in its set-up."""
    classes = torch.tensor(spec.classes, dtype=torch.int64, device=device)
    words = torch.empty(R * LANES, dtype=torch.int32, device=device)
    for lo in range(0, R * LANES, _WORDS_STEP):
        g = torch.arange(lo, min(lo + _WORDS_STEP, R * LANES), dtype=torch.int64,
                         device=device)
        word, deg = torch.zeros_like(g), torch.zeros_like(g)
        for live, d in lattice_dirs(IMP_LATTICE[spec.kind], spec.n, spec.n, g):
            live = (live & (g < spec.n)).to(torch.int64)
            k = torch.searchsorted(classes, d).clamp(max=len(spec.classes) - 1)
            word = word | (k << (4 * deg)) * live
            deg = deg + live
        words[lo:lo + g.numel()] = (word | (deg << 24)).to(torch.int32)
    return words


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in torch, on any device.
# ---------------------------------------------------------------------------


def imp_marks(spec: ImpSpec, key, ckey, pool_size: int, lo: int, hi: int,
              device=None) -> torch.Tensor:
    """int64 [(hi - lo) * 128] class id each node of global rows [lo, hi)
    sends along in one round (-1 on pad lanes), as the module docstring
    draws it: ``key`` and ``ckey`` are the round's key and choice key
    (pairs of uint32 words, ints or tensors)."""
    n = spec.n
    jflat = torch.arange(lo * LANES, hi * LANES, dtype=torch.int64, device=device)
    padm = jflat >= n
    # The grid's direction pairs in neighbour-column order, then the
    # long-range slot: live on every real node, with displacement -1 so it
    # never aliases a lattice class.
    pairs = lattice_dirs(IMP_LATTICE[spec.kind], n, n, jflat) + [(~padm, jflat * 0 - 1)]
    d, _ = _sample_disp_dirs(threefry2x32_hash(key[0], key[1], jflat), pairs)
    # The packed choice words of the 8-row groups the rows meet.
    w0, w1 = lo // POOL_PACK, -(-hi // POOL_PACK)
    words = threefry_bits_2d(ckey[0], ckey[1], w1 - w0, LANES, row0=w0, device=device)
    choice = choice_from_words(words, pool_size)[lo - w0 * POOL_PACK:hi - w0 * POOL_PACK]
    lattice = torch.tensor(spec.classes, dtype=torch.int64, device=device)
    cls = torch.where(d >= 0, torch.searchsorted(lattice, d.clamp(min=0)),
                      len(spec.classes) + choice.reshape(-1).to(torch.int64))
    return torch.where(padm, -1, cls)


def _imp_classes(spec: ImpSpec, keys, offs, ckeys, rows: int):
    """``round_classes`` of the imp chunks (fused.pushsum_class_rounds):
    the marks (``imp_marks``), the L lattice classes with their static
    sources, then the P pool classes with the round's."""
    n, n_pad, dev = spec.n, rows * LANES, keys.device
    L, P = len(spec.classes), offs.shape[1]
    lat_srcs = [(q, class_sources(n_pad, d, n, dev)) for q, d in enumerate(spec.classes)]

    def round_classes(k):
        pool = [(L + p, class_sources(n_pad, offs[k, p], n, dev)) for p in range(P)]
        return imp_marks(spec, keys[k], ckeys[k], P, 0, rows, dev), lat_srcs + pool

    return round_classes


def pushsum_imp_chunk_plain(state4, keys, offs, ckeys, start: int, cap: int, *,
                            spec: ImpSpec, target: int, delta: float,
                            term_rounds: int, faults: Optional[Faults] = None):
    """Up to K = keys.shape[0] push-sum imp rounds on the padded planes
    (s, w, term, conv_i32), with the run's global termination (``faults``,
    the run's fused.Faults or None; fused.pushsum_class_rounds). Returns
    (state4', rounds_executed)."""
    dev, rows = state4[0].device, state4[0].shape[0]
    cap, keys, offs, ckeys = clamp_cap_and_pad(start, cap, keys, ((offs, 1), (ckeys, 0)))
    return pushsum_class_rounds(
        state4, start, cap, keys.shape[0],
        _imp_classes(spec, keys.to(dev), offs.to(dev), ckeys.to(dev), rows),
        n=spec.n, target=target, delta=delta, term_rounds=term_rounds,
        faults=_chunk_faults(faults, keys, start, rows, dev))


def gossip_imp_chunk_plain(state3, keys, offs, ckeys, start: int, cap: int, *,
                           spec: ImpSpec, target: int, rumor_target: int,
                           suppress: bool):
    """Up to K gossip imp rounds on the padded planes (count, active_i32,
    conv_i32), with receiver-side suppression. Returns (state3',
    rounds_executed)."""
    dev, rows = state3[0].device, state3[0].shape[0]
    cap, keys, offs, ckeys = clamp_cap_and_pad(start, cap, keys, ((offs, 1), (ckeys, 0)))
    return gossip_class_rounds(
        state3, start, cap, keys.shape[0],
        _imp_classes(spec, keys.to(dev), offs.to(dev), ckeys.to(dev), rows),
        n=spec.n, target=target, rumor_target=rumor_target, suppress=suppress)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two.
# ---------------------------------------------------------------------------


def _check(planes, dtypes, keys, offs, ckeys, spec: ImpSpec) -> torch.device:
    if len(planes) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} state planes, got {len(planes)}")
    shape = (pool_rows(spec.n), LANES)
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"imp chunks run on cpu or cuda tensors, got {dev}")
    for x, dt in zip(planes, dtypes):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(
                f"state plane must be {dt} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError("state planes must be contiguous")
    for name, k in (("keys", keys), ("ckeys", ckeys)):
        if k.dtype != torch.int64 or k.dim() != 2 or k.shape != (keys.shape[0], 2):
            raise ValueError(f"{name} must be int64 [K, 2], got {k.dtype} {tuple(k.shape)}")
    if offs.dtype != torch.int32 or offs.dim() != 2 or offs.shape[0] != keys.shape[0]:
        raise ValueError(
            f"offs must be int32 [K, P] with K = {keys.shape[0]}, got "
            f"{offs.dtype} {tuple(offs.shape)}"
        )
    if offs.shape[1] not in POOL_SIZES:
        raise ValueError(
            f"pool_size {offs.shape[1]} not in {POOL_SIZES} (the packed-choice "
            "limit of the kernels)"
        )
    # The streams are drawn on the host; checking their values there costs
    # no device sync, and an offset outside [1, n-1] would send the
    # kernels' gathers out of bounds.
    if any(x.device.type != "cpu" for x in (keys, offs, ckeys)):
        raise ValueError("keys, offs and ckeys are host-drawn streams: pass CPU tensors")
    for k in (keys, ckeys):
        if k.numel() and (k.min() < 0 or k.max() > rng.MASK):
            raise ValueError("keys must hold uint32 words")
    if offs.numel() and (offs.min() < 1 or offs.max() > spec.n - 1):
        raise ValueError(f"offs must lie in [1, {spec.n - 1}]")
    if spec.kind not in IMP_LATTICE or not 1 <= len(spec.classes) <= 6:
        raise ValueError(f"not an imp lattice the kernels take: {spec}")
    if spec.n > 2**27:
        raise ValueError(f"population {spec.n} exceeds {2**27}")
    return dev


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gossip_pushsum_imp_chunk": [_P] * 19 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "gossip_gossip_imp_chunk": [_P] * 16 + [_I] * 9 + [_P],
}


def chunk_launches(rounds: int) -> int:
    """Launches a chunk of csrc/fused_imp.cu queues: init, the mark
    prologue, one a round, finish."""
    return rounds + 3


def _kernel_chunk(name: str, state, keys, offs, ckeys, start: int, cap: int,
                  spec: ImpSpec, tail):
    """Queue one chunk of csrc/fused_imp.cu on the current stream of the
    state's device and raise on a launch error. Returns (state',
    rounds_executed, launches queued)."""
    dev = state[0].device
    cap, keys, offs, ckeys = clamp_cap_and_pad(start, cap, keys, ((offs, 1), (ckeys, 0)))
    keys, ckeys = _upload(keys, dev), _upload(ckeys, dev)
    offs = offs.contiguous()  # read on the host, one round per launch
    rounds = max(0, cap - start)
    n_pad = state[0].numel()
    planes = len(state) * n_pad
    words = imp_dir_words(spec, state[0].shape[0], dev)
    # Two allocations a chunk, as ops/fused_stencil_hbm.kernel_chunk makes
    # them: the result planes with the control words behind them (done,
    # rounds executed, then 8 * (rounds + 2) bytes of scratch; the entry
    # point zeroes them), and the other plane set with the two mark planes
    # (round j reads half j % 2), passed as raw pointers.
    head = torch.empty(planes + 2 + 2 * (rounds + 2), dtype=torch.int32, device=dev)
    work = torch.empty(planes + n_pad // 2, dtype=torch.int32, device=dev)
    out = [p if p.dtype == x.dtype else p.view(x.dtype) for p, x in
           zip(head[:planes].view(len(state), *state[0].shape).unbind(0), state)]
    other = [work.data_ptr() + 4 * i * n_pad for i in range(len(state))]
    classes = np.ascontiguousarray(spec.classes, dtype=np.int32)
    fn = kernels.entry("fused_imp", name, _SIGNATURES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[x.data_ptr() for x in (*state, *out)], *other,
             work.data_ptr() + 4 * planes, keys.data_ptr(), ckeys.data_ptr(),
             words.data_ptr(), offs.data_ptr(), head.data_ptr() + 4 * planes,
             classes.ctypes.data, len(spec.classes), spec.n, n_pad, rounds,
             offs.shape[1], *tail, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    return tuple(out), head[planes + 1], chunk_launches(rounds)


def pushsum_chunk(counter, state4, keys, offs, ckeys, start: int, cap: int, *,
                  spec: ImpSpec, target: int, delta: float, term_rounds: int,
                  faults: Optional[Faults] = None):
    """The push-sum chunk behind both tiers' wrappers; a launch adds the
    kernels it queued to ``counter.launches``. ``faults`` (the run's
    fused.Faults, or None) may carry global termination only, which runs
    the kernels' global instance: a gate or a death plane raises ValueError
    (both JAX imp tiers run those on the chunked engine)."""
    dev = _check(state4, (torch.float32, torch.float32, torch.int32, torch.int32),
                 keys, offs, ckeys, spec)
    faults = global_only(faults, "the imp tiers (imp, imp_hbm)")
    if dev.type == "cpu":
        return pushsum_imp_chunk_plain(
            state4, keys, offs, ckeys, start, cap, spec=spec, target=target,
            delta=delta, term_rounds=term_rounds, faults=faults)
    out, executed, launches = _kernel_chunk(
        "gossip_pushsum_imp_chunk", state4, keys, offs, ckeys, start, cap, spec,
        (ctypes.c_float(delta), term_rounds, target, global_flag(faults)))
    counter.launches += launches
    return out, executed


def gossip_chunk(counter, state3, keys, offs, ckeys, start: int, cap: int, *,
                 spec: ImpSpec, target: int, rumor_target: int, suppress: bool):
    """The gossip chunk behind both tiers' wrappers."""
    dev = _check(state3, (torch.int32,) * 3, keys, offs, ckeys, spec)
    if dev.type == "cpu":
        return gossip_imp_chunk_plain(
            state3, keys, offs, ckeys, start, cap, spec=spec, target=target,
            rumor_target=rumor_target, suppress=suppress)
    out, executed, launches = _kernel_chunk(
        "gossip_gossip_imp_chunk", state3, keys, offs, ckeys, start, cap, spec,
        (rumor_target, int(suppress), target))
    counter.launches += launches
    return out, executed


def pushsum_imp_chunk(state4, keys, offs, ckeys, start: int, cap: int, *,
                      spec: ImpSpec, target: int, delta: float, term_rounds: int,
                      faults: Optional[Faults] = None):
    """Up to K = keys.shape[0] push-sum imp rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged.

    ``state4`` is (s, w, term, conv_i32) in the padded [rows, 128] pool
    layout on one device; ``keys`` and ``ckeys`` int64 [K, 2] (uint32
    words; fused.round_keys, choice_round_keys) and ``offs`` int32 [K, P]
    (fused_pool.round_offsets) are CPU tensors. Returns (state4',
    rounds_executed) with rounds_executed a 0-dim int32 tensor on the
    state's device; the inputs are left unchanged. CUDA state runs the
    kernel and CPU state the plain version. ``faults`` as in
    ``pushsum_chunk``: global termination only."""
    return pushsum_chunk(pushsum_imp_chunk, state4, keys, offs, ckeys, start, cap,
                         spec=spec, target=target, delta=delta,
                         term_rounds=term_rounds, faults=faults)


def gossip_imp_chunk(state3, keys, offs, ckeys, start: int, cap: int, *,
                     spec: ImpSpec, target: int, rumor_target: int,
                     suppress: bool):
    """Gossip analog of ``pushsum_imp_chunk``: ``state3`` is (count,
    active_i32, conv_i32); converged-target suppression is receiver-side."""
    return gossip_chunk(gossip_imp_chunk, state3, keys, offs, ckeys, start, cap,
                        spec=spec, target=target, rumor_target=rumor_target,
                        suppress=suppress)


# Kernel launches queued by each wrapper (init, the mark prologue, one a
# round, finish: ``chunk_launches``), counted where the kernels are launched
# and nowhere else.
pushsum_imp_chunk.launches = 0
gossip_imp_chunk.launches = 0
