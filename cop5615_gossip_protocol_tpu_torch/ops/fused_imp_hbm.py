"""The streaming imp tier: imp2d/imp3d past the resident tier's plane
budget, up to 2**27 nodes.

In the JAX package this tier is a kernel of its own (its
ops/fused_imp_hbm.py), which streams the state through VMEM windows
because the planes no longer fit there. It computes the resident tier's
function on the same layout (``build_pool_layout``), and on the card one
pair of kernels serves both (csrc/fused_imp.cu, ops/fused_imp.py). This
module keeps the tier's predicate, so the port's ladder picks the tier the
JAX one picks, and its own wrappers, so a run shows which tier launched.
"""

from __future__ import annotations

from typing import Optional

from ..config import SimConfig
from . import fused_imp
from .fused import Faults
from .fused_stencil_hbm import MAX_STENCIL_HBM_NODES
from .topology import Topology


def imp_hbm_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the JAX package's streaming imp tier would run this config,
    else the reason not (its predicate, whose reasons name the sharded
    composition past one device)."""
    reason = fused_imp.imp_reason(
        topo, cfg,
        "this streaming engine is single-device; n_devices > 1 runs the imp "
        "x HBM x sharded composition (parallel/fused_imp_hbm_sharded.py — "
        "lattice halos + one all_gather of the windowed planes per round)")
    if reason is not None:
        return reason
    if topo.n > MAX_STENCIL_HBM_NODES:
        return (
            f"population {topo.n} exceeds the single-device HBM-plane "
            f"budget ({MAX_STENCIL_HBM_NODES} nodes); n_devices > 1 "
            "shards past it (parallel/fused_imp_hbm_sharded.py)"
        )
    return None


def pushsum_imp_hbm_chunk(state4, keys, offs, ckeys, start: int, cap: int, *,
                          spec: fused_imp.ImpSpec, target: int, delta: float,
                          term_rounds: int, faults: Optional[Faults] = None):
    """``fused_imp.pushsum_imp_chunk`` on this tier: the same function,
    layout and kernels (global termination only, as ``faults``), counted
    here."""
    return fused_imp.pushsum_chunk(
        pushsum_imp_hbm_chunk, state4, keys, offs, ckeys, start, cap, spec=spec,
        target=target, delta=delta, term_rounds=term_rounds, faults=faults)


def gossip_imp_hbm_chunk(state3, keys, offs, ckeys, start: int, cap: int, *,
                         spec: fused_imp.ImpSpec, target: int,
                         rumor_target: int, suppress: bool):
    """``fused_imp.gossip_imp_chunk`` on this tier, counted here."""
    return fused_imp.gossip_chunk(
        gossip_imp_hbm_chunk, state3, keys, offs, ckeys, start, cap, spec=spec,
        target=target, rumor_target=rumor_target, suppress=suppress)


# Kernel launches queued by each wrapper (init, the mark prologue, one a
# round, finish: ``fused_imp.chunk_launches``), counted where the kernels are
# launched and nowhere else.
pushsum_imp_hbm_chunk.launches = 0
gossip_imp_hbm_chunk.launches = 0
