"""Canonical config→engine keys — the single home of engine-cache keying
(the JAX package's serving/keys.py).

Two configs that build the IDENTICAL engine must map to the same key, and
two configs that build different engines must never collide. A batch
engine (models/sweep.py) fixes everything that does not ride the chunk
boundary as an argument, so the key is built from three parts:

- the config **compile class**: every SimConfig field except the ones that
  are host-loop-only (seed, max_rounds, pipeline_chunks, strict_engine,
  stall_chunks, replicas), with the resolved-policy fields NORMALIZED so
  spellings that build the same engine share one (delta=None vs
  delta=resolved_delta, suppress=None vs resolved, gossip configs ignoring
  push-sum-only knobs and vice versa);
- the **fault class**: the normalized failure model. Fault-free configs
  collapse to one class regardless of quorum/rejoin spellings; a crash or
  Byzantine model additionally pins ``cfg.seed``, since its planes derive
  from ``PRNGKey(seed)`` and are built into the engine (ops/faults.py);
- the **topology class**: kind + the BUILT population (the padded-N
  bucket) + neighbor-tensor shapes, and for the seed-built kinds a
  fingerprint of the neighbor values, which the engine holds on its
  device.

The key also pins the runtime: the device the engine's tensors live on,
the torch version and the identity of the kernel build (``_runtime_class``),
any of which changes what the engine runs.

``serve_bucket_key`` is the micro-batcher's stricter grouping: on top of
the engine key it pins ``max_rounds`` (the shared round cap is
batch-wide) and, for seed-built topologies (imp2d/imp3d), the topology
seed — co-batched lanes share ONE neighbor tensor, so its values must
match, not just its shape.
"""

from __future__ import annotations

import dataclasses
import functools

from ..config import SimConfig
from ..ops.topology import Topology, build_topology

# SimConfig fields that never change the engine: they drive the host loop
# (round caps, pipeline depth, watchdog cadence) or harness policy
# (strict_engine). Everything NOT listed here is part of the compile class
# by default, so a future SimConfig field is conservatively key-splitting
# until proven host-only.
HOST_ONLY_FIELDS = frozenset({
    "seed",            # key material rides the chunk call as key data;
                       # crash models re-pin it via fault_class
    "n",               # padded-N bucketing: the BUILT population
                       # (topology_class) rules
    "max_rounds",      # the round cap is a chunk argument
    "pipeline_chunks",
    "stall_chunks",
    "strict_engine",
    "replicas",        # lane count is a separate pool-key component
})

# Fields replaced by normalized entries below (resolved-policy collapse).
_NORMALIZED_FIELDS = frozenset({
    "delta", "suppress_converged", "rumor_threshold", "term_rounds",
    "termination", "pool_size", "quorum", "rejoin",
    "fault_rate", "crash_rate", "crash_schedule",
    "revive_rate", "revive_schedule", "dup_rate", "delay_rounds",
    "byzantine_rate", "byzantine_schedule", "byzantine_mode", "robust_agg",
})

# Topology kinds whose neighbor tensors depend on the build seed (the
# random long-range extra edge): co-batching lanes over one shared tensor
# requires identical build seeds for these.
SEED_BUILT_KINDS = frozenset({"imp2d", "imp3d"})


def fault_class(cfg: SimConfig) -> tuple:
    """Normalized failure-model identity. Fault-free configs collapse to
    one class (quorum/rejoin/revive spellings are only consulted under a
    crash model). A crash model pins ``cfg.seed``: the death/revival
    planes derive from ``PRNGKey(seed)`` and are built into the engine."""
    if not cfg.faulted:
        return ("fault-free",)
    out: list = ["faulted"]
    if cfg.fault_rate > 0:
        out.append(("drop", cfg.fault_rate))
    if cfg.dup_rate > 0:
        out.append(("dup", cfg.dup_rate))
    if cfg.delay_rounds > 0:
        out.append(("delay", cfg.delay_rounds))
    if cfg.crash_model:
        out.append((
            "crash", cfg.crash_rate, cfg.crash_schedule, cfg.quorum,
            cfg.seed,
        ))
        if cfg.revive_model:
            rejoin = cfg.rejoin if cfg.algorithm == "push-sum" else "susceptible"
            out.append((
                "revive", cfg.revive_rate, cfg.revive_schedule, rejoin,
            ))
    if cfg.byzantine_model:
        # Like the crash planes, the adversary plane derives from
        # PRNGKey(seed) and is built into the engine — byzantine engines
        # are per-seed too. The mode and countermeasure change the round.
        out.append((
            "byzantine", cfg.byzantine_rate, cfg.byzantine_schedule,
            cfg.byzantine_mode, cfg.robust_agg, cfg.seed,
        ))
    return tuple(out)


def compile_class(cfg: SimConfig) -> tuple:
    """The config side of the engine key: raw fields minus host-only ones,
    with resolved-policy normalization (see module docstring)."""
    pushsum = cfg.algorithm == "push-sum"
    items = tuple(sorted(
        (f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)
        if f.name not in HOST_ONLY_FIELDS and f.name not in _NORMALIZED_FIELDS
    ))
    normalized = (
        ("delta", cfg.resolved_delta if pushsum else None),
        ("term", (cfg.initial_term_round, cfg.term_rounds, cfg.termination)
         if pushsum else None),
        ("rumor_target", None if pushsum else cfg.resolved_rumor_target),
        ("suppress", None if pushsum else cfg.resolved_suppress),
        # Pool and matmul delivery sample pool_size displacements a round;
        # `delivery` itself is a raw compile-class field.
        ("pool_size",
         cfg.pool_size if cfg.delivery in ("pool", "matmul") else None),
        # robust_agg changes the receiver's absorb whether or not
        # adversaries exist, so it splits keys even when fault_class says
        # fault-free.
        ("robust_agg", cfg.robust_agg),
    )
    return items + normalized + (("faults", fault_class(cfg)),)


def topology_class(topo: Topology) -> tuple:
    """The topology side: kind + BUILT population (the padded-N bucket)
    + neighbor-tensor SHAPES. For the SEED_BUILT kinds the key additionally
    pins a content fingerprint of the neighbor tensors: the batch engine
    holds the topology's tensors on its device, so two same-shape imp
    graphs built from different seeds must never share an entry."""
    fingerprint = None
    if topo.kind in SEED_BUILT_KINDS and topo.neighbors is not None:
        import hashlib

        h = hashlib.sha1()
        h.update(topo.neighbors.tobytes())
        h.update(topo.degree.tobytes())
        fingerprint = h.hexdigest()[:16]
    return (
        "topo", topo.kind, topo.n, topo.target_count,
        topo.max_deg, topo.implicit, fingerprint,
    )


def _runtime_class(device=None) -> tuple:
    """What else rebuilds an engine for the same config: the device its
    tensors and kernels live on (type and index), the torch version, and on
    a CUDA device the identity of the kernel build (utils/kernels.build_id:
    an edited source or changed nvcc flag is another build)."""
    import torch

    from ..utils import kernels
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    return ("device", dev.type, dev.index, "torch", torch.__version__,
            "kernels", kernels.build_id() if dev.type == "cuda" else None)


def canonical_key(cfg: SimConfig, topo: Topology, device=None) -> tuple:
    """The engine identity of (cfg, topo) on ``device`` (the GPU unless the
    caller asks for the CPU) — hashable, order-stable, and safe to use as a
    warm-pool key (serving/pool.py)."""
    return (compile_class(cfg), topology_class(topo), _runtime_class(device))


@functools.lru_cache(maxsize=256)
def get_topology(kind: str, n: int, seed: int = 0,
                 semantics: str = "batched") -> Topology:
    """Build-once topology cache. Builders are pure functions of these
    four arguments, and every consumer treats the neighbor arrays as
    read-only, so sharing one instance across requests is safe."""
    return build_topology(kind, n, seed=seed, semantics=semantics)


def padded_population(kind: str, n: int, seed: int = 0,
                      semantics: str = "batched") -> int:
    """The padded-N bucket of a requested population: the BUILT topology's
    node count after builder rounding (grid2d rounds up to a square, imp3d
    down to a cube, …). Requests whose n rounds to the same population —
    and whose compile/fault classes match — share one warm engine."""
    return get_topology(kind, n, seed=seed, semantics=semantics).n


def resolved_plan_label(cfg: SimConfig, topo: Topology) -> str:
    """The plan the runner executes for (cfg, topo): "hand" for
    hand-planned configs. ``plan='auto'`` (the cost model's winner) is
    refused by SimConfig until ROADMAP A11 ports the cost model."""
    if cfg.plan != "auto":
        return "hand"
    from ..config import unported

    raise unported("plan='auto'", "A11")


def serve_bucket_key(cfg: SimConfig, topo: Topology, device=None) -> tuple:
    """The micro-batcher's grouping key: the engine key plus the
    batch-wide host knobs (max_rounds — one shared round cap per batch),
    for seed-built topologies the build seed (co-batched lanes share ONE
    neighbor tensor; its VALUES must match, not just shapes), and the
    resolved plan."""
    topo_seed = cfg.seed if topo.kind in SEED_BUILT_KINDS else None
    return canonical_key(cfg, topo, device) + (
        ("max_rounds", cfg.max_rounds), ("topo_seed", topo_seed),
        ("plan", resolved_plan_label(cfg, topo)),
    )


def bucket_label(cfg: SimConfig, topo: Topology) -> str:
    """Human-readable bucket name for stats and responses — (protocol,
    topology-kind, padded-N bucket, engine, fault class), compressed."""
    fc = fault_class(cfg)
    fc_s = fc[0] if fc == ("fault-free",) else "faulted"
    return (
        f"{cfg.algorithm}/{topo.kind}/n{topo.n}/{cfg.engine}/{fc_s}"
        + ("/tele" if cfg.telemetry else "")
    )
