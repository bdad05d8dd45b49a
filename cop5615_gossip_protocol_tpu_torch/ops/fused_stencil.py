"""Support predicate of the JAX package's tiled VMEM-resident stencil tier
(its ops/fused_stencil.py, make_pushsum_stencil2_chunk and
make_gossip_stencil2_chunk).

The tier's kernels are not ported yet (ROADMAP B6). Its predicate is, so
the engine ladder in models/runner.py picks the tier the JAX package picks:
a config this tier would serve raises there instead of running elsewhere.
"""

from __future__ import annotations

from typing import Optional

from ..config import SimConfig
from .fused_pool import build_pool_layout
from .topology import Topology

# The JAX tier's VMEM plane budget, in bytes.
_VMEM_BUDGET = 100 * 1024 * 1024


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
    layout = build_pool_layout(topo.n)
    if _plane_bytes(layout.n_pad, topo.max_deg, cfg.algorithm) > _VMEM_BUDGET:
        return (
            f"population {topo.n} (max_deg {topo.max_deg}) exceeds the "
            "VMEM-resident plane budget"
        )
    return None
