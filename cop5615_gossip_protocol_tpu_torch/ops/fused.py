"""Helpers shared by the fused chunk engines, as plain torch functions, and
the support predicate of the JAX package's whole-array stencil tier.

The CUDA kernels compute the same things on the device: the Threefry hash
in csrc/threefry.cuh, the done flag and the round cap inside
csrc/fused_pool.cu and csrc/fused_stencil.cu. The whole-array stencil
kernels themselves (the JAX package's ops/fused.py make_pushsum_chunk and
make_gossip_chunk) are not ported yet (ROADMAP B5); ``fused_support`` is
kept so the engine ladder picks the tier the JAX package picks.
"""

from __future__ import annotations

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
