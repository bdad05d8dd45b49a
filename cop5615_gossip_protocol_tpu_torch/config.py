"""Simulation configuration for the PyTorch port.

The field names, defaults and ``resolved_*`` rules are those of the JAX
package's ``SimConfig``, so a run record from either package carries the
same config keys. The port runs push-sum and gossip on the implicit
``full`` topology and on imp2d/imp3d with scatter delivery (the default)
or ``delivery="pool"``, on the six arithmetic lattices (line, ring,
grid2d, ref2d, grid3d, torus3d) with stencil (the default) or scatter
delivery, and reference-semantics push-sum as the single walk.
``n_devices``, ``pool2_wire`` and ``overlap_collectives`` configure the
sharded compositions (models/runner.run says which run);
every other field keeps its default here, and setting it
to anything else raises NotImplementedError naming the ROADMAP item that
will port it.
"""

from __future__ import annotations

import dataclasses

TOPOLOGIES = (
    "line", "ring", "full", "grid2d", "ref2d", "imp2d", "grid3d", "torus3d",
    "imp3d",
)
ALGORITHMS = ("gossip", "push-sum")
SEMANTICS = ("batched", "reference")
DELIVERIES = ("auto", "scatter", "stencil", "pool", "matmul")

_CLI_TOPOLOGY_ALIASES = {
    "line": "line",
    "ring": "ring",
    "full": "full",
    "2d": "grid2d",
    "grid2d": "grid2d",
    "ref2d": "ref2d",
    "imp2d": "imp2d",
    "3d": "grid3d",
    "grid3d": "grid3d",
    "torus3d": "torus3d",
    "imp3d": "imp3d",
}

_CLI_ALGORITHM_ALIASES = {
    "gossip": "gossip",
    "push-sum": "push-sum",
    "pushsum": "push-sum",
    "push_sum": "push-sum",
}

# (field, default, ROADMAP item) for every field this slice does not port.
_UNPORTED = (
    ("dtype", "float32", "A12"),
    ("fault_rate", 0.0, "A6"),
    ("crash_rate", 0.0, "A6"),
    ("crash_schedule", None, "A6"),
    ("revive_rate", 0.0, "A6"),
    ("revive_schedule", None, "A6"),
    ("rejoin", "restore", "A6"),
    ("byzantine_rate", 0.0, "A6"),
    ("byzantine_schedule", None, "A6"),
    ("byzantine_mode", "mass_inflate", "A6"),
    ("robust_agg", "none", "A6"),
    ("quorum", 1.0, "A6"),
    ("mass_tolerance", None, "A6"),
    ("telemetry", False, "A6"),
    ("termination", "local", "A6"),
    ("dup_rate", 0.0, "A7b"),
    ("delay_rounds", 0, "A7b"),
    ("stall_chunks", 0, "A8"),
    ("step_timing", False, "A8"),
    ("strict_checkpoint", False, "A8"),
    ("replicas", 1, "A9"),
    ("halo_dma", "auto", "A10"),
    ("plan", "hand", "A11"),
    ("strict_engine", False, "A12"),
)


def unported(what: str, item: str) -> NotImplementedError:
    """The error every unported feature raises: what was asked for and the
    ROADMAP item that will port it."""
    return NotImplementedError(
        f"{what} is not ported to cop5615_gossip_protocol_tpu_torch yet "
        f"(ROADMAP {item})"
    )


def normalize_topology(name: str, semantics: str = "batched") -> str:
    """Map a CLI topology spelling to a canonical kind ("2D" is the
    line-wired ref2d under reference semantics, the honest grid2d
    otherwise)."""
    key = name.strip().lower()
    if key not in _CLI_TOPOLOGY_ALIASES:
        raise ValueError(
            f"unknown topology {name!r}; expected one of "
            f"{sorted(set(_CLI_TOPOLOGY_ALIASES))}"
        )
    kind = _CLI_TOPOLOGY_ALIASES[key]
    if kind == "grid2d" and semantics == "reference" and key == "2d":
        return "ref2d"
    return kind


def normalize_algorithm(name: str) -> str:
    key = name.strip().lower()
    if key not in _CLI_ALGORITHM_ALIASES:
        raise ValueError(
            f"unknown algorithm {name!r}; expected one of "
            f"{sorted(set(_CLI_ALGORITHM_ALIASES))}"
        )
    return _CLI_ALGORITHM_ALIASES[key]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full description of one simulation run (see the JAX package's
    SimConfig for the meaning of every field)."""

    n: int
    topology: str = "full"
    algorithm: str = "gossip"
    semantics: str = "batched"
    seed: int = 0
    dtype: str = "float32"
    delta: float | None = None
    rumor_threshold: int = 10
    term_rounds: int = 3
    max_rounds: int = 1_000_000
    chunk_rounds: int = 4096
    pipeline_chunks: int = 2
    overlap_collectives: bool = True
    halo_dma: str = "auto"
    target_frac: float | None = None
    suppress_converged: bool | None = None
    fault_rate: float = 0.0
    crash_rate: float = 0.0
    crash_schedule: str | None = None
    revive_rate: float = 0.0
    revive_schedule: str | None = None
    rejoin: str = "restore"
    byzantine_rate: float = 0.0
    byzantine_schedule: str | None = None
    byzantine_mode: str = "mass_inflate"
    robust_agg: str = "none"
    dup_rate: float = 0.0
    delay_rounds: int = 0
    quorum: float = 1.0
    stall_chunks: int = 0
    mass_tolerance: float | None = None
    strict_engine: bool = False
    strict_checkpoint: bool = False
    telemetry: bool = False
    step_timing: bool = False
    engine: str = "auto"
    plan: str = "hand"
    delivery: str = "auto"
    pool_size: int = 4
    n_devices: int | None = None
    pool2_wire: str = "auto"
    replicas: int = 1
    termination: str = "local"

    def __post_init__(self) -> None:
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; expected one of {TOPOLOGIES}"
            )
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected one of {ALGORITHMS}"
            )
        if self.semantics not in SEMANTICS:
            raise ValueError(
                f"unknown semantics {self.semantics!r}; expected one of {SEMANTICS}"
            )
        if self.term_rounds < 1:
            raise ValueError("term_rounds must be >= 1")
        if self.rumor_threshold < 1:
            raise ValueError("rumor_threshold must be >= 1")
        if not (1 <= self.max_rounds <= 2**30):
            # Keeps round-indexed fold_in tags disjoint from the leader tag.
            raise ValueError("max_rounds must be in [1, 2**30]")
        if self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")
        if not (1 <= self.pipeline_chunks <= 64):
            raise ValueError(
                f"pipeline_chunks must be in [1, 64], got {self.pipeline_chunks}"
            )
        if self.delivery not in DELIVERIES:
            raise ValueError(
                f"unknown delivery {self.delivery!r}; "
                "expected auto|scatter|stencil|pool|matmul"
            )
        if self.delivery == "pool" and self.topology not in (
            "full", "imp2d", "imp3d"
        ):
            raise ValueError(
                "delivery='pool' applies to the implicit full topology and "
                f"to imp2d/imp3d; got topology={self.topology!r}"
            )
        if self.delivery == "matmul" and self.topology not in (
            "full", "imp2d", "imp3d"
        ):
            raise ValueError(
                "delivery='matmul' applies where pooled sampling applies "
                f"(full, imp2d/imp3d); got topology={self.topology!r}"
            )
        if not (2 <= self.pool_size <= 1024) or self.pool_size & (
            self.pool_size - 1
        ):
            raise ValueError(
                f"pool_size must be a power of two in [2, 1024], got {self.pool_size}"
            )
        if self.engine not in ("auto", "chunked", "fused"):
            raise ValueError(
                f"unknown engine {self.engine!r}; expected auto|chunked|fused"
            )
        for field, default, item in _UNPORTED:
            value = getattr(self, field)
            if value != default:
                raise unported(f"{field}={value!r}", item)
        if self.pool2_wire not in ("auto", "reduce_scatter", "all_gather"):
            raise ValueError(
                f"unknown pool2_wire {self.pool2_wire!r}; expected "
                "auto|reduce_scatter|all_gather"
            )
        if self.delivery == "matmul":
            raise unported(
                "delivery='matmul' (the one-hot matmul form of pooled "
                "delivery)", "A7b")
        if self.topology in ("imp2d", "imp3d"):
            if self.delivery == "stencil":
                raise ValueError(
                    "delivery='stencil' requires an offset-structured "
                    "topology; imp2d/imp3d have random long-range edges"
                )
            if self.delivery == "pool" and self.reference:
                raise ValueError(
                    "delivery='pool' on imp topologies re-draws the random "
                    "long-range edge per round and cannot reproduce the "
                    "reference's static extra edge (Q9, program.fs:308-310); "
                    "use batched semantics or delivery='scatter'"
                )
        elif self.topology == "full" and self.delivery == "stencil":
            raise ValueError(
                "delivery='stencil' requires an offset-structured "
                "topology (line/ring/grid2d/ref2d/grid3d/torus3d)"
            )
        if self.reference and self.algorithm == "push-sum":
            if self.delivery in ("stencil", "pool"):
                raise ValueError(
                    f"delivery={self.delivery!r} does not apply to "
                    "reference-semantics push-sum — the single-walk simulator "
                    "has no batched delivery step"
                )
            if self.engine == "fused":
                raise ValueError(
                    "engine='fused' does not apply to reference-semantics "
                    "push-sum — the single-walk simulator (one message in "
                    "flight) has no multi-round batched kernel; drop the "
                    "engine override or use batched semantics"
                )

    @property
    def reference(self) -> bool:
        return self.semantics == "reference"

    @property
    def faulted(self) -> bool:
        """Any failure-model knob set (the JAX property the fused plans
        gate on; every such knob is refused above until A6 and A7b)."""
        return (self.fault_rate > 0.0 or self.crash_rate > 0.0
                or self.crash_schedule is not None or self.dup_rate > 0.0
                or self.delay_rounds > 0 or self.byzantine_rate > 0.0
                or self.byzantine_schedule is not None)

    @property
    def resolved_delta(self) -> float:
        """Push-sum stability threshold: the reference's 1e-10 is below the
        float32 ratio noise floor, so the float32 default is 1e-6; an
        explicit ``delta`` always wins."""
        if self.delta is not None:
            return self.delta
        return 1e-6

    @property
    def resolved_rumor_target(self) -> int:
        """Receipt count at which a gossip node converges: the 11th receipt
        in reference semantics (quirk Q2), the threshold otherwise."""
        return self.rumor_threshold + 1 if self.reference else self.rumor_threshold

    @property
    def initial_term_round(self) -> int:
        """Push-sum termRound start: 1 in the reference (Q4), 0 otherwise."""
        return 1 if self.reference else 0

    @property
    def resolved_suppress(self) -> bool:
        if self.suppress_converged is not None:
            return self.suppress_converged
        return self.reference

    def resolved_pool2_wire(self, n_devices: int) -> str:
        """Delivery wire of the replicated-pool2 composition on
        ``n_devices`` shards: "auto" picks the banded reduce_scatter wire
        exactly when every band is smaller than the gathered copy
        (n_devices > pool_size); an explicit value forces either wire."""
        if self.pool2_wire != "auto":
            return self.pool2_wire
        return "reduce_scatter" if n_devices > self.pool_size else "all_gather"

    def resolved_target_count(self, population: int, builder_target: int) -> int:
        """Number of converged nodes that ends the run."""
        if self.target_frac is not None:
            return max(1, min(population, int(round(self.target_frac * population))))
        if self.reference:
            return builder_target
        return population
