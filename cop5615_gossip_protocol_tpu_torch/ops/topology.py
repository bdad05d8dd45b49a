"""Network topologies. This slice ports the implicit complete graph
(``full``); the explicit lattice and imp builders come with ROADMAP A7."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import unported


@dataclasses.dataclass(frozen=True)
class Topology:
    """Host-side description of a network. ``neighbors``/``degree`` are None
    for implicit kinds (``full``), where partners are index shifts.
    ``target_count`` is the converged count that ends a run: n in batched
    semantics, the reference's N of N+1 (quirk Q1) otherwise."""

    kind: str
    n: int  # actual population (after the reference's +1 quirk)
    n_requested: int
    target_count: int
    max_deg: int
    neighbors: Optional[np.ndarray]
    degree: Optional[np.ndarray]

    @property
    def implicit(self) -> bool:
        return self.neighbors is None


def build_full(n: int, reference: bool = False) -> Topology:
    """Complete graph, implicit: partners are drawn as index shifts, never
    gathered from an adjacency row."""
    pop = n + 1 if reference else n
    if pop < 2:
        raise ValueError("full topology needs at least 2 nodes")
    return Topology("full", pop, n, n if reference else pop, 0, None, None)


def build_topology(kind: str, n: int, *, seed: int = 0,
                   semantics: str = "batched") -> Topology:
    """Build a topology by kind; ``seed`` feeds the random-edge kinds."""
    del seed  # only the imp kinds draw edges (ROADMAP A7)
    if kind == "full":
        return build_full(n, semantics == "reference")
    raise unported(f"topology {kind!r}", "A7")
