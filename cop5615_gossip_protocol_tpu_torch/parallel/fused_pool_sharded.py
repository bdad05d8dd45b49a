"""The VMEM replicated pool composition's plan: the counterpart of the JAX
package's parallel/fused_pool_sharded.py ``plan_fused_pool_sharded``.

The JAX ladder tries this composition first on ``full`` with n_devices > 1
(every shard runs the single-device pool kernel on an all_gathered copy,
up to the pool engine's 2**21 nodes) and the replicated-pool2 composition
past it. The port carries the plan so its ladder picks the JAX tier; the
composition itself is not ported (ROADMAP A10), and a config it would
serve is refused by name.
"""

from __future__ import annotations

from ..config import SimConfig
from ..ops import fused_pool
from ..ops.sampling import POOL_CHOICE_BITS
from ..ops.topology import Topology


def plan_fused_pool_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(rows_loc, layout) or a string reason why the composition can't run
    (the JAX plan's reasons; its dtype gate is the port config's own
    refusal)."""
    if cfg.delivery != "pool":
        return (
            "the fused pool composition requires delivery='pool' (the same "
            "gate as the single-device pool engine dispatch)"
        )
    if not topo.implicit:
        return (
            "the fused pool engine serves the implicit full topology only; "
            f"pooled delivery on {topo.kind!r} runs the chunked engine"
        )
    if cfg.dup_rate > 0 or cfg.delay_rounds > 0:
        return "dup/delay fault models run on the chunked engine only"
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    if topo.n > fused_pool.MAX_POOL_NODES:
        return (
            f"population {topo.n} exceeds the VMEM-resident doubled-plane "
            f"budget ({fused_pool.MAX_POOL_NODES} nodes)"
        )
    if cfg.revive_model:
        # The JAX composition's kernels predate the revival plane.
        return (
            "crash-recovery (revive) runs on the chunked, sharded, and "
            "single-device VMEM fused stencil/pool engines only"
        )
    if cfg.telemetry:
        return (
            "telemetry counters run in the single-device fused kernels and "
            "the chunked/sharded XLA engines; this composition does not "
            "carry the counter block"
        )
    layout = fused_pool.build_pool_layout(topo.n)
    R = layout.rows
    if R % n_dev != 0 or (R // n_dev) % fused_pool.TILE != 0:
        return (
            f"padded layout ({R} rows) must split into whole {fused_pool.TILE}-row "
            f"tiles per device; {n_dev} devices do not divide it"
        )
    return (R // n_dev, layout)
