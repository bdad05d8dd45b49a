"""Resident lattice chunks: the tiled tier of the JAX package's
ops/fused_stencil.py (make_pushsum_stencil2_chunk, make_gossip_stencil2_chunk)
and what it shares with the whole-array tier of its ops/fused.py.

The JAX package runs small and mid-size lattices in two VMEM-resident
tiers: the whole-array one (n <= 131,072, wrap kinds aligned to 128 lanes)
and this tiled one (any alignment, state planes up to a 100 MB budget).
Both compute the streaming tier's function (ops/fused_stencil_hbm.py); the
split is the TPU's VMEM. On the card one kernel pair serves both tiers:
csrc/fused_resident.cu, whose chunk is one persistent cooperative launch
bracketed by the init and finish launches, 3 launches whatever K is. The
ladder still names the JAX tier (``fused.fused_support``,
``stencil2_support`` here), each tier keeps the JAX tier's layout
(``fused.build_layout``, the pool layout here), and each tier's wrappers
count their own launches.

``pushsum_stencil2_chunk`` and ``gossip_stencil2_chunk`` launch the kernels
on CUDA tensors and run the plain version on CPU tensors: the streaming
tier's ``*_plain`` functions, which take any layout. The whole-array tier's
wrappers take the run's drop gate, crash-stop and global termination
(``fused.Faults``); this tier's take global termination only, as the JAX
tier does (its gated and crashed configs run on the chunked engine).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import SimConfig
from .fused import Faults, RowSpec
from .fused_pool import build_pool_layout
from .fused_stencil_hbm import (
    StencilSpec,
    _check,
    global_only,
    gossip_stencil_hbm_chunk_plain,
    kernel_chunk,
    pushsum_stencil_hbm_chunk_plain,
)
from .topology import Topology

# The JAX tier's VMEM plane budget, in bytes.
_VMEM_BUDGET = 100 * 1024 * 1024
# Launches of one resident chunk: init, the persistent round loop, finish
# (and under telemetry the reduce of its rows).
RESIDENT_LAUNCHES = 3


def _plane_bytes(n_pad: int, max_deg: int, algorithm: str) -> int:
    """Resident planes in bytes (4-byte words per node): push-sum 4 state +
    2x2 doubled sends + 2 doubled displacement; gossip 3 state + 2 doubled
    marked displacement; both max_deg displacement columns + 1 degree."""
    per_node = 4 + 4 + 2 if algorithm == "push-sum" else 3 + 2
    return n_pad * 4 * (per_node + max_deg + 1)


def stencil2_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the tiled stencil tier would run this config, else why not."""
    if topo.implicit:
        return "implicit (full) topology has no displacement structure"
    if topo.offsets is None:
        return f"topology {topo.kind!r} has no small displacement set"
    if cfg.faulted:
        # The JAX tier takes no failure model: the config runs on the
        # chunked engine.
        return "failure models not supported in this fused kernel"
    layout = build_pool_layout(topo.n)
    if _plane_bytes(layout.n_pad, topo.max_deg, cfg.algorithm) > _VMEM_BUDGET:
        return (
            f"population {topo.n} (max_deg {topo.max_deg}) exceeds the "
            "VMEM-resident plane budget"
        )
    return None


def pushsum_resident_chunk(counter, rows: int, state4, keys, start: int,
                           cap: int, *, spec: StencilSpec, target: int,
                           delta: float, term_rounds: int,
                           faults: Optional[Faults] = None,
                           telemetry: bool = False, grid: Optional[int] = None):
    """The push-sum chunk behind both resident tiers' wrappers, on state in
    the tier's [rows, 128] layout, with the run's failure model
    (``faults``: None for a fault-free run with local termination, which
    runs the kernels' fault-free instance); a launch adds its launches to
    ``counter.launches``. ``telemetry`` (the whole-array tier's, rows 5-6)
    runs the telemetry instance and returns the rows too; on the CPU their
    float sums follow the kernel's order on ``grid`` blocks."""
    dev = _check(state4, (torch.float32, torch.float32, torch.int32, torch.int32),
                 keys, spec, rows)
    if dev.type == "cpu":
        return pushsum_stencil_hbm_chunk_plain(
            state4, keys, start, cap, spec=spec, target=target, delta=delta,
            term_rounds=term_rounds, faults=faults,
            telemetry=_row_spec(telemetry, rows, grid))
    out, executed, _, *tele = kernel_chunk(
        "fused_resident", "gossip_pushsum_resident_chunk", state4, keys, start,
        cap, spec, (ctypes.c_float(delta), term_rounds, target), faults,
        telemetry)
    counter.launches += RESIDENT_LAUNCHES + telemetry
    return (out, executed, *tele)


def _row_spec(telemetry: bool, rows: int, grid: Optional[int]):
    from .fused import LANES

    return RowSpec.for_layout("stencil", rows * LANES, grid) if telemetry else None


def gossip_resident_chunk(counter, rows: int, state3, keys, start: int,
                          cap: int, *, spec: StencilSpec, target: int,
                          rumor_target: int, suppress: bool,
                          faults: Optional[Faults] = None,
                          telemetry: bool = False, grid: Optional[int] = None):
    """The gossip chunk behind both resident tiers' wrappers."""
    dev = _check(state3, (torch.int32,) * 3, keys, spec, rows)
    if dev.type == "cpu":
        return gossip_stencil_hbm_chunk_plain(
            state3, keys, start, cap, spec=spec, target=target,
            rumor_target=rumor_target, suppress=suppress, faults=faults,
            telemetry=_row_spec(telemetry, rows, grid))
    out, executed, _, *tele = kernel_chunk(
        "fused_resident", "gossip_gossip_resident_chunk", state3, keys, start,
        cap, spec, (rumor_target, int(suppress), target), faults, telemetry)
    counter.launches += RESIDENT_LAUNCHES + telemetry
    return (out, executed, *tele)


# The tiled tier's failure model is global termination alone (the JAX tier
# refuses the drop gate and crash-stop, fused_stencil.py:96).
_TIER = "the tiled stencil tier (stencil2)"


def pushsum_stencil2_chunk(state4, keys, start: int, cap: int, *,
                           spec: StencilSpec, target: int, delta: float,
                           term_rounds: int, faults: Optional[Faults] = None):
    """Up to K = keys.shape[0] push-sum lattice rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged.

    ``state4`` is (s, w, term, conv_i32) in the padded [rows, 128] pool
    layout (``build_pool_layout``) on one device; ``keys`` int64 [K, 2]
    fold_in keys (uint32 words, fused.round_keys) are a CPU tensor. Returns
    (state4', rounds_executed) with rounds_executed a 0-dim int32 tensor on
    the state's device; the inputs are left unchanged. CUDA state runs the
    kernel and CPU state the plain version. ``faults`` (the run's
    fused.Faults, or None) may carry global termination only: a gate or a
    death plane raises ValueError."""
    return pushsum_resident_chunk(
        pushsum_stencil2_chunk, build_pool_layout(spec.n).rows, state4, keys,
        start, cap, spec=spec, target=target, delta=delta,
        term_rounds=term_rounds, faults=global_only(faults, _TIER))


def gossip_stencil2_chunk(state3, keys, start: int, cap: int, *,
                          spec: StencilSpec, target: int, rumor_target: int,
                          suppress: bool, faults: Optional[Faults] = None):
    """Gossip analog of ``pushsum_stencil2_chunk``: ``state3`` is (count,
    active_i32, conv_i32); converged-target suppression is receiver-side.
    Gossip has no global termination, so ``faults`` is None or raises as
    there."""
    return gossip_resident_chunk(
        gossip_stencil2_chunk, build_pool_layout(spec.n).rows, state3, keys,
        start, cap, spec=spec, target=target, rumor_target=rumor_target,
        suppress=suppress, faults=global_only(faults, _TIER))


# Kernel launches queued by each wrapper (3 a chunk), counted where the
# kernel is launched and nowhere else.
pushsum_stencil2_chunk.launches = 0
gossip_stencil2_chunk.launches = 0
