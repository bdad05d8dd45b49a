"""Helpers shared by the fused chunk engines, as plain torch functions, and
the whole-array stencil tier of the JAX package's ops/fused.py
(make_pushsum_chunk, make_gossip_chunk): its support predicate, its layout
and its chunk wrappers.

The CUDA kernels compute the same things on the device: the Threefry hash
in csrc/threefry.cuh, the done flag, the round cap and the class-keyed
delivery and absorb (``pushsum_class_rounds``, ``gossip_class_rounds``)
inside csrc/fused_pool.cu, csrc/fused_pool2.cu, csrc/fused_stencil.cu,
csrc/fused_resident.cu and csrc/fused_imp.cu. The whole-array tier's
wrappers (``pushsum_chunk``, ``gossip_chunk``) run csrc/fused_resident.cu,
the kernel pair it shares with the tiled tier (ops/fused_stencil.py), on
CUDA tensors and the lattice tiers' plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from . import rng
from .topology import Topology

LANES = 128
# The JAX whole-array stencil tier's population cap (its VMEM budget).
MAX_FUSED_NODES = 131_072


def _has_wrap_edges(topo: Topology) -> bool:
    """True if any live edge's raw displacement (j - i) differs from its
    signed modular displacement, i.e. the edge wraps the index space."""
    cols = np.arange(topo.max_deg)[None, :]
    live = cols < topo.degree[:, None]
    ids = np.arange(topo.n, dtype=np.int64)[:, None]
    raw = (topo.neighbors.astype(np.int64) - ids)[live]
    mod = raw % topo.n
    signed = np.where(mod <= topo.n // 2, mod, mod - topo.n)
    return bool((raw != signed).any())


def fused_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the JAX package's whole-array stencil tier would run this
    config, else the reason not (its predicate, ops/fused.py; the port's
    configs are fault-free, float32 and single-device by construction)."""
    del cfg
    if topo.implicit:
        return "implicit (full) topology has no displacement structure"
    if topo.offsets is None:
        return f"topology {topo.kind!r} has no small displacement set"
    if topo.n > MAX_FUSED_NODES:
        return f"population {topo.n} exceeds VMEM-resident limit {MAX_FUSED_NODES}"
    if topo.n % LANES != 0 and _has_wrap_edges(topo):
        return (
            "wraparound topology needs population divisible by 128 "
            f"(n={topo.n}); rolls in the padded layout would misdeliver"
        )
    return None


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """The whole-array tier's padded [rows, 128] layout."""

    n: int
    n_pad: int
    rows: int


def build_layout(n: int) -> FusedLayout:
    """n rounded up to whole 128-lane rows, as the JAX tier lays it out.
    Pad lanes never send and never receive."""
    rows = -(-n // LANES)
    return FusedLayout(n=n, n_pad=rows * LANES, rows=rows)


def pushsum_chunk(state4, keys, start: int, cap: int, *, spec, target: int,
                  delta: float, term_rounds: int):
    """Up to K = keys.shape[0] push-sum lattice rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged, on
    (s, w, term, conv_i32) in the ``build_layout`` layout; the contract of
    fused_stencil.pushsum_stencil2_chunk (``spec`` a
    fused_stencil_hbm.StencilSpec)."""
    # Imported here: ops/fused_stencil imports this module.
    from .fused_stencil import pushsum_resident_chunk

    return pushsum_resident_chunk(
        pushsum_chunk, build_layout(spec.n).rows, state4, keys, start, cap,
        spec=spec, target=target, delta=delta, term_rounds=term_rounds)


def gossip_chunk(state3, keys, start: int, cap: int, *, spec, target: int,
                 rumor_target: int, suppress: bool):
    """Gossip analog of ``pushsum_chunk``: ``state3`` is (count,
    active_i32, conv_i32); converged-target suppression is receiver-side."""
    from .fused_stencil import gossip_resident_chunk

    return gossip_resident_chunk(
        gossip_chunk, build_layout(spec.n).rows, state3, keys, start, cap,
        spec=spec, target=target, rumor_target=rumor_target, suppress=suppress)


# Kernel launches queued by each wrapper (3 a chunk), counted where the
# kernel is launched and nowhere else.
pushsum_chunk.launches = 0
gossip_chunk.launches = 0


def threefry2x32_hash(k1, k2, i):
    """Threefry-2x32 of counter ``i`` (high counter word 0) under key
    (k1, k2), xor-folded: the partitionable-stream word at position i."""
    a, b = rng.threefry2x32(k1, k2, 0, i)
    return a ^ b


def threefry_bits_2d(k1, k2, rows: int, cols: int, row0=0, device=None):
    """int64 ``[rows, cols]`` uint32 words equal to rows [row0, row0+rows)
    of ``jax.random.bits(key, ((row0+rows)*cols,))`` reshaped."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return threefry2x32_hash(k1, k2, ((r + row0) * cols + c) & rng.MASK)


def round_keys(base_key, start: int, count: int) -> torch.Tensor:
    """int64 ``[count, 2]`` fold_in keys for absolute rounds
    start..start+count (the stream sampling.round_key draws)."""
    k1, k2 = int(base_key[0]), int(base_key[1])
    rounds = (start + torch.arange(count, dtype=torch.int64)) & rng.MASK
    a, b = rng.threefry2x32(k1, k2, 0, rounds)
    return torch.stack([a, b], dim=1)


def clamp_cap_and_pad(start: int, cap: int, keys, extras=()):
    """Clamp the round cap to the rounds that have real keys, then pad the
    per-round streams to 8-round blocks (the TPU kernels' SMEM blocks).
    Padded rounds never run, because the cap stops short of them.
    ``extras`` is a tuple of (tensor, fill) pairs padded alongside the keys.
    Returns (cap, keys, *extras)."""
    cap = min(int(cap), int(start) + keys.shape[0])
    pad = -keys.shape[0] % 8
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, 2))])
        padded = tuple(
            torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
            for a, fill in extras
        )
    else:
        padded = tuple(a for a, _ in extras)
    return (cap, keys) + padded


def _pad2d(x: torch.Tensor, layout, fill) -> torch.Tensor:
    """[n] -> [rows, 128]: pad the tail with ``fill`` and fold into lanes."""
    pad = layout.n_pad - layout.n
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(layout.rows, LANES)


def make_done_flag(target: int):
    """Fault-free termination verdict: ``done_flag(total)`` is True once the
    converged count reaches the target."""

    def done_flag(total) -> bool:
        return bool(total >= target)

    return done_flag


def class_sources(n_pad: int, d, n: int, device=None) -> torch.Tensor:
    """Flat [n_pad] index of the node whose message along the mod-n
    displacement ``d`` lands on each receiver j: j - d, wrapped by n."""
    j = torch.arange(n_pad, dtype=torch.int64, device=device)
    return torch.where(j >= d, j - d, j - d + n)


def pushsum_class_rounds(state4, start: int, cap: int, count: int,
                         round_classes, *, n: int, target: int, delta: float,
                         term_rounds: int):
    """The plain version of every push-sum chunk kernel: up to ``count``
    rounds from absolute round ``start`` on the padded planes (s, w, term,
    conv_i32), stopping at ``cap`` or once ``target`` nodes converged.

    ``round_classes(k) -> (mark, classes)`` describes round k's sends:
    ``mark`` is the int64 [n_pad] class id each node sends along (-1 for
    none: pad lanes, degree 0) and ``classes`` the (class id, source index)
    pairs in delivery order, where the source index (``class_sources``)
    names the node whose send along that class lands on each receiver. Each
    receiver sums the halved sends from 0.0 in that order: the chunked
    engines' float32 op order. Returns (state4', rounds_executed)."""
    s, w, t, c = (x.clone() for x in state4)
    dev, rows = s.device, s.shape[0]
    padm = (torch.arange(rows * LANES, device=dev) >= n).reshape(rows, LANES)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    done = make_done_flag(target)
    finished = done(c.sum())
    executed = 0
    for k in range(count):
        if finished or start + k >= cap:
            break
        mark, classes = round_classes(k)
        sends = mark >= 0
        ss = torch.where(sends, s.reshape(-1) * 0.5, zero)
        ws = torch.where(sends, w.reshape(-1) * 0.5, zero)
        in_s = torch.zeros_like(ss)
        in_w = torch.zeros_like(ws)
        for cid, src in classes:
            hit = mark[src] == cid
            in_s = in_s + torch.where(hit, ss[src], zero)
            in_w = in_w + torch.where(hit, ws[src], zero)
        in_s = torch.where(padm, zero, in_s.reshape(rows, LANES))
        in_w = torch.where(padm, zero, in_w.reshape(rows, LANES))
        s_new = (s - ss.reshape(rows, LANES)) + in_s
        w_new = (w - ws.reshape(rows, LANES)) + in_w
        received = in_w > 0
        stable = torch.abs(s_new / w_new - s / w) <= delta_t
        t = torch.where(received, torch.where(stable, t + 1, 0), t).to(torch.int32)
        c = torch.where(padm, 0, (c != 0) | (t >= term_rounds)).to(torch.int32)
        s, w = s_new, w_new
        executed += 1
        finished = done(c.sum())
    return (s, w, t, c), torch.tensor(executed, dtype=torch.int32, device=dev)


def gossip_class_rounds(state3, start: int, cap: int, count: int,
                        round_classes, *, n: int, target: int,
                        rumor_target: int, suppress: bool):
    """The plain version of every gossip chunk kernel, on the padded planes
    (count, active_i32, conv_i32): ``pushsum_class_rounds``' contract, where
    only active nodes send (their mark is kept, every other node's is -1),
    a receiver counts the class sources that sent along the class, and
    suppression is receiver-side. Returns (state3', rounds_executed)."""
    cnt, act, c = (x.clone() for x in state3)
    dev, rows = cnt.device, cnt.shape[0]
    padm = (torch.arange(rows * LANES, device=dev) >= n).reshape(rows, LANES)
    done = make_done_flag(target)
    finished = done(c.sum())
    executed = 0
    for k in range(count):
        if finished or start + k >= cap:
            break
        mark, classes = round_classes(k)
        mark = torch.where(act.reshape(-1) != 0, mark, -1)
        inbox = torch.zeros(rows * LANES, dtype=torch.int32, device=dev)
        for cid, src in classes:
            inbox = inbox + (mark[src] == cid).to(torch.int32)
        inbox = torch.where(padm, 0, inbox.reshape(rows, LANES))
        if suppress:
            inbox = torch.where(c != 0, 0, inbox)
        cnt = (cnt + inbox).to(torch.int32)
        act = ((act != 0) | (inbox > 0)).to(torch.int32)
        c = ((cnt >= rumor_target) & ~padm).to(torch.int32)
        executed += 1
        finished = done(c.sum())
    return (cnt, act, c), torch.tensor(executed, dtype=torch.int32, device=dev)
