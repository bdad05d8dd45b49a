"""Simulation configuration for the PyTorch port.

The field names, defaults and ``resolved_*`` rules are those of the JAX
package's ``SimConfig``, so a run record from either package carries the
same config keys. The port runs push-sum and gossip on the implicit
``full`` topology and on imp2d/imp3d with scatter delivery (the default),
``delivery="pool"`` or ``delivery="matmul"`` (the same pooled sampling
delivered to the targets it implies), on the six arithmetic lattices
(line, ring, grid2d, ref2d, grid3d, torus3d) with stencil (the default) or
scatter delivery, and reference-semantics push-sum as the single walk.
``n_devices``, ``pool2_wire`` and ``overlap_collectives`` configure the
sharded compositions (models/runner.run says which run); ``fault_rate``,
``crash_rate``/``crash_schedule`` with ``quorum``,
``revive_rate``/``revive_schedule`` with ``rejoin``, ``dup_rate``,
``delay_rounds`` and ``termination`` set the drop gate, crash-stop with
quorum termination, crash-recovery, duplicate delivery, the delay ring and
push-sum's global termination (ops/faults.py);
``byzantine_rate``/``byzantine_schedule`` with ``byzantine_mode``,
``robust_agg`` and ``mass_tolerance`` the Byzantine adversaries, robust
aggregation and the health sentinel; ``telemetry`` the per-round counter
rows (ops/telemetry.py); ``stall_chunks``, ``step_timing`` and
``strict_checkpoint`` the stall watchdog, the retire clocks of the chunk
loop and its checkpoint-failure policy (models/pipeline.py); ``replicas``
the lane count of the replica sweep (models/sweep.py). Every other
field keeps its default
here, and setting it
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

# Replica-sweep / serving-batch lane cap (models/sweep.py re-exports it):
# bounds the REPLICA_TAG0 fold_in region. Lives here so
# SimConfig.__post_init__ can validate ``replicas`` without importing the
# sweep engine.
MAX_REPLICAS = 4096
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
        if not (0.0 <= self.fault_rate < 1.0):
            raise ValueError("fault_rate must be in [0, 1)")
        if not (0.0 <= self.crash_rate < 1.0):
            raise ValueError("crash_rate must be in [0, 1)")
        if not (0.0 <= self.dup_rate < 1.0):
            raise ValueError("dup_rate must be in [0, 1)")
        if self.crash_schedule is not None:
            if self.crash_rate > 0:
                raise ValueError(
                    "crash_rate and crash_schedule are mutually exclusive "
                    "(the schedule IS the death process)"
                )
            from .ops.faults import parse_crash_schedule

            parse_crash_schedule(self.crash_schedule)  # fail at config time
        if not (0.0 <= self.revive_rate < 1.0):
            raise ValueError("revive_rate must be in [0, 1)")
        if self.revive_schedule is not None:
            if self.revive_rate > 0:
                raise ValueError(
                    "revive_rate and revive_schedule are mutually exclusive "
                    "(the schedule IS the recovery process)"
                )
            from .ops.faults import parse_schedule

            parse_schedule(self.revive_schedule, "revive")  # same grammar
        if self.revive_model and not self.crash_model:
            raise ValueError(
                "revive_rate/revive_schedule describe how CRASHED nodes "
                "rejoin; without crash_rate/crash_schedule there is nothing "
                "to revive — the flags would silently mean nothing"
            )
        if self.rejoin not in ("restore", "fresh"):
            raise ValueError(
                f"unknown rejoin {self.rejoin!r}; expected restore|fresh"
            )
        if not (0.0 <= self.byzantine_rate < 1.0):
            raise ValueError("byzantine_rate must be in [0, 1)")
        if self.byzantine_schedule is not None:
            if self.byzantine_rate > 0:
                raise ValueError(
                    "byzantine_rate and byzantine_schedule are mutually "
                    "exclusive (the schedule IS the adversary onset process)"
                )
            from .ops.faults import parse_schedule

            parse_schedule(self.byzantine_schedule, "byzantine")  # same grammar
        if self.byzantine_mode not in (
            "mass_inflate", "mass_deflate", "stale_rumor", "garble"
        ):
            raise ValueError(
                f"unknown byzantine_mode {self.byzantine_mode!r}; expected "
                "mass_inflate|mass_deflate|stale_rumor|garble"
            )
        if self.byzantine_model:
            valid_modes = (
                ("mass_inflate", "mass_deflate", "garble")
                if self.algorithm == "push-sum"
                else ("stale_rumor", "garble")
            )
            if self.byzantine_mode not in valid_modes:
                raise ValueError(
                    f"byzantine_mode {self.byzantine_mode!r} does not apply "
                    f"to algorithm {self.algorithm!r}: push-sum adversaries "
                    "corrupt the sent (s, w) wire pair "
                    "(mass_inflate|mass_deflate|garble); gossip adversaries "
                    "corrupt protocol state (stale_rumor|garble)"
                )
        if self.robust_agg not in ("none", "clip", "trim"):
            raise ValueError(
                f"unknown robust_agg {self.robust_agg!r}; expected "
                "none|clip|trim"
            )
        if self.robust_agg != "none":
            if self.algorithm != "push-sum":
                raise ValueError(
                    "robust_agg bounds the push-sum (s, w) contributions a "
                    "receiver accepts; gossip receipts carry no mass to "
                    "clip or trim"
                )
            if self.mass_tolerance is not None:
                raise ValueError(
                    "robust_agg contradicts mass_tolerance: clip/trim "
                    "DISCARD suspect mass by design, so the conservation "
                    "sentinel would trip on the countermeasure, not "
                    "corruption"
                )
            if self.robust_agg == "trim" and self.delivery != "pool":
                raise ValueError(
                    "robust_agg='trim' drops the largest-|w| channel among "
                    "the pool tier's per-slot sampled contributions; other "
                    "deliveries accumulate a single inbox with no channels "
                    "to trim — use delivery='pool' or robust_agg='clip'"
                )
            if self.robust_agg == "trim" and self.topology != "full":
                raise ValueError(
                    "robust_agg='trim' applies to the implicit full "
                    "topology's uniform pool-slot channels; the imp "
                    "lattice+pool delivery mixes channel classes with no "
                    "single slot order to trim over — use robust_agg='clip'"
                )
        if not (0 <= self.delay_rounds <= 64):
            raise ValueError(
                f"delay_rounds must be in [0, 64], got {self.delay_rounds} "
                "(the ring buffer holds delay_rounds full delivery planes)"
            )
        if not (0.0 < self.quorum <= 1.0):
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        for lint in self.lint_warnings:
            import warnings

            warnings.warn(lint, RuntimeWarning, stacklevel=2)
        if self.mass_tolerance is not None:
            if self.mass_tolerance <= 0:
                raise ValueError(
                    f"mass_tolerance must be > 0, got {self.mass_tolerance}"
                )
            if self.algorithm != "push-sum":
                raise ValueError(
                    "mass_tolerance watches the push-sum conservation "
                    "invariant Σw == population; gossip state has no mass "
                    "to diverge"
                )
            if self.dup_rate > 0:
                raise ValueError(
                    "mass_tolerance contradicts dup_rate: at-least-once "
                    "delivery CREATES mass by design, so the sentinel "
                    "would trip on the modeled fault, not corruption"
                )
            if self.revive_model and self.rejoin == "fresh":
                raise ValueError(
                    "mass_tolerance contradicts rejoin='fresh': fresh "
                    "revivals discard parked mass and re-create their "
                    "value by design — use rejoin='restore' (conserving) "
                    "with the sentinel"
                )
            if self.semantics == "reference":
                raise ValueError(
                    "mass_tolerance runs inside the synchronous chunk "
                    "program; reference-semantics push-sum is a single "
                    "random walk with no round body — use batched semantics"
                )
        if (
            self.telemetry
            and self.semantics == "reference"
            and self.algorithm == "push-sum"
        ):
            raise ValueError(
                "telemetry accumulates per-ROUND counters inside the "
                "synchronous chunk program; reference-semantics push-sum is "
                "a single random walk (one message in flight) with no round "
                "structure to trace — use batched semantics"
            )
        if self.semantics == "reference" and (
            self.crash_model or self.dup_rate > 0 or self.delay_rounds > 0
            or self.byzantine_model or self.robust_agg != "none"
        ):
            raise ValueError(
                "crash/dup/delay/byzantine fault models (and robust_agg) "
                "contradict reference semantics — the reference models zero "
                "faults (program.fs has no failure path); use batched "
                "semantics"
            )
        if self.crash_model and self.termination == "global":
            raise ValueError(
                "termination='global' (every node's residual stable) is "
                "undefined under a crash model — dead nodes park arriving "
                "mass and never stabilize; use the local latch with quorum"
            )
        if self.crash_model and self.target_frac is not None:
            raise ValueError(
                "target_frac and the crash model's quorum rule are two "
                "different termination targets; use quorum"
            )
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
                "delivery='matmul' recasts the pooled delivery as a "
                "blocked one-hot dot_general (the MXU tier) and applies "
                "where pooled sampling applies: the implicit full topology "
                "and imp2d/imp3d; offset-structured kinds keep their "
                "stencil/scatter plans — "
                f"got topology={self.topology!r}"
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
        if not (1 <= self.replicas <= MAX_REPLICAS):
            raise ValueError(
                f"replicas must be in [1, {MAX_REPLICAS}], got "
                f"{self.replicas} (the REPLICA_TAG0 fold_in region caps the "
                "lane count — TAG MAP in ops/faults.py)"
            )
        if self.replicas > 1:
            # The replica sweep runs the chunked engine lane by lane
            # (models/sweep.py); its contracts fail at config time, as in
            # the JAX package.
            if self.engine == "fused":
                raise ValueError(
                    "engine='fused' does not apply to replica sweeps: the "
                    "Pallas tiers opt out of the batch dimension "
                    "(plan/tiering gate); the sweep always runs the chunked "
                    "XLA engines — drop the engine override"
                )
            if self.semantics == "reference":
                raise ValueError(
                    "replica sweeps vmap the batched synchronous-round "
                    "engines; reference semantics (single-walk push-sum, Q1 "
                    "population) has no batched replica axis — use batched "
                    "semantics"
                )
            if self.n_devices is not None and self.n_devices > 1:
                raise ValueError(
                    "replica sweeps are single-device (the replica axis IS "
                    "the parallelism); drop n_devices or run replicas "
                    "unbatched"
                )
            if self.stall_chunks:
                raise ValueError(
                    "stall_chunks watchdog semantics are per-run; a batched "
                    "sweep has no single progress gap to watch — run stall "
                    "diagnostics unbatched"
                )
            if self.mass_tolerance is not None:
                raise ValueError(
                    "the health sentinel (mass_tolerance) carries one "
                    "per-run health scalar through the chunk loop; a "
                    "batched sweep has no per-replica outcome channel for "
                    "it — run health-sentinel diagnostics unbatched"
                )
        if self.stall_chunks < 0:
            raise ValueError("stall_chunks must be >= 0")
        if self.pool2_wire not in ("auto", "reduce_scatter", "all_gather"):
            raise ValueError(
                f"unknown pool2_wire {self.pool2_wire!r}; expected "
                "auto|reduce_scatter|all_gather"
            )
        if self.topology in ("imp2d", "imp3d"):
            if self.delivery == "stencil":
                raise ValueError(
                    "delivery='stencil' requires an offset-structured "
                    "topology; imp2d/imp3d have random long-range edges"
                )
            if self.reference and (
                self.delivery == "pool"
                or (self.delivery == "matmul" and self.algorithm == "gossip")
            ):
                # Reference push-sum under matmul is the single walk, which
                # reads no delivery (the JAX runner's order).
                raise ValueError(
                    f"delivery={self.delivery!r} on imp topologies re-draws "
                    "the random long-range edge per round and cannot reproduce the "
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
        if self.termination not in ("local", "global"):
            raise ValueError(
                f"unknown termination {self.termination!r}; expected local|global"
            )
        if self.termination == "global" and self.algorithm != "push-sum":
            raise ValueError(
                "termination='global' is a push-sum residual criterion "
                "(max |Δ(s/w)| <= delta); gossip terminates on receipt "
                "counts only"
            )
        if self.termination == "global" and self.semantics == "reference":
            raise ValueError(
                "termination='global' replaces the reference's local "
                "stability rule (program.fs:119-137) and contradicts "
                "reference semantics; use batched semantics"
            )

    @property
    def reference(self) -> bool:
        return self.semantics == "reference"

    @property
    def crash_model(self) -> bool:
        """True when nodes can die (ops/faults.death_plane is not None)."""
        return self.crash_rate > 0.0 or self.crash_schedule is not None

    @property
    def revive_model(self) -> bool:
        """True when crashed nodes can rejoin (ops/faults.revival_plane is
        not None)."""
        return self.revive_rate > 0.0 or self.revive_schedule is not None

    @property
    def byzantine_model(self) -> bool:
        """True when nodes can lie (ops/faults.byzantine_plane is not
        None). Adversaries stay alive and count toward the quorum."""
        return self.byzantine_rate > 0.0 or self.byzantine_schedule is not None

    @property
    def lint_warnings(self) -> tuple[str, ...]:
        """Valid-but-suspect combinations, as the JAX package words them:
        the CLI prints each to stderr, and __post_init__ raises each as a
        RuntimeWarning."""
        out = []
        if self.quorum != 1.0 and not self.crash_model:
            out.append(
                "quorum < 1.0 without a crash model has no effect (the "
                "legacy converged_count >= target predicate rules); set "
                "crash_rate/crash_schedule, or use target_frac to relax a "
                "fault-free target"
            )
        if self.robust_agg != "none" and not self.byzantine_model:
            out.append(
                "robust_agg without a byzantine model bounds contributions "
                "that are all honest — pure overhead that can only discard "
                "legitimate mass; set byzantine_rate/byzantine_schedule, or "
                "drop --robust-agg"
            )
        return tuple(out)

    @property
    def faulted(self) -> bool:
        """Any failure-model knob set (the JAX property the fused plans
        gate on)."""
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
