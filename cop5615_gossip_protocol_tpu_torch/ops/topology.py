"""Network topologies: the implicit complete graph, the six arithmetic
lattices, and the two lattices with one random long-range edge per node
(imp2d, imp3d).

Every build function returns the same arrays as the JAX package's
function of the same name, byte for byte: a padded ``[n, max_deg]`` int32
neighbour table whose live columns follow the JAX append order, the degree
vector, and the population/target pair with the reference quirks:

- Q1: in reference semantics the population is n+1 and the target n
  (program.fs:152-154, 178); the grids append the extra node unwired
  (degree 0), while line, ring and ref2d wire it into the chain;
- Q6: "2D" (``ref2d``) rounds n up to a square and wires it as a line
  (program.fs:227-248);
- torus3d at cube side 2: the +1 and -1 neighbour of an axis are the same
  node, so rows carry multi-edges;
- reference imp3d (C3/Q8/Q9): the population is floor(n**0.33334)**3 + 1
  but the lattice side floor(n**0.34), the lattice is cut at the rounded
  population, and the extra edge is drawn from [0, rounded - 1), so it may
  be a self-edge or a duplicate.

The JAX build functions append row by row in Python; these build the same
columns with vectorized numpy (a 16.8M-node lattice in seconds). The imp
kinds' extra edges are one vectorized draw, ``rng.integers(0, hi,
size=rows)``, which yields the same values as the JAX builders' loop of
scalar draws from the same generator.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Host-side description of a network. ``neighbors``/``degree`` are None
    for implicit kinds (``full``), where partners are index shifts.
    ``target_count`` is the converged count that ends a run: n in batched
    semantics, the reference's N of N+1 (quirk Q1) otherwise."""

    kind: str
    n: int  # actual population (after rounding and the reference's +1)
    n_requested: int
    target_count: int
    max_deg: int
    neighbors: Optional[np.ndarray]  # [n, max_deg] int32, padded with 0
    degree: Optional[np.ndarray]  # [n] int32

    @property
    def implicit(self) -> bool:
        return self.neighbors is None

    @functools.cached_property
    def offsets(self) -> Optional[np.ndarray]:
        """``stencil_offsets(self)``, computed once per topology: the engine
        ladder's predicates, the fused engine and the chunked engine all
        read it."""
        return stencil_offsets(self)


def _cube_side(n: int, min_side: int = 1) -> int:
    """Largest g with g**3 <= n, clamped to min_side."""
    g = round(n ** (1 / 3))
    if g**3 > n:
        g -= 1
    return max(g, min_side)


# The kinds whose displacement classes follow from their geometry alone.
_ARITHMETIC_KINDS = ("line", "ring", "ref2d", "grid2d", "grid3d", "torus3d")


def kind_offsets(kind: str, n_requested: int) -> Optional[np.ndarray]:
    """The sorted modular displacement classes of a batched-semantics
    lattice, from its geometry alone: what ``stencil_offsets`` scans out of
    the built adjacency, in O(1) instead of O(n * max_deg). None for kinds
    without arithmetic displacements (full, imp2d, imp3d)."""
    if kind in ("line", "ring", "ref2d"):
        pop = math.ceil(math.sqrt(n_requested)) ** 2 if kind == "ref2d" else n_requested
        cands = [1, pop - 1]
    elif kind == "grid2d":
        side = math.ceil(math.sqrt(n_requested))
        pop = side * side
        cands = [1, pop - 1, side, pop - side]
    elif kind == "grid3d":
        g = _cube_side(n_requested)
        pop = g**3
        cands = [m * s % pop for m in (1, g, g * g) for s in (1, pop - 1)]
    elif kind == "torus3d":
        if n_requested < 8:
            raise ValueError("torus3d needs at least 8 nodes (cube side >= 2)")
        g = _cube_side(n_requested, min_side=2)
        pop = g**3
        # Per axis: the interior steps +-m and the wrap steps +-m*(g-1),
        # which coincide at small g (np.unique folds them, as the scan does).
        cands = [m * s % pop for m in (1, g, g * g)
                 for s in (1, pop - 1, g - 1, pop - (g - 1))]
    else:
        return None
    if pop < 2:
        return None
    offs = np.unique(np.asarray(cands, dtype=np.int64) % pop)
    offs = offs[offs != 0]
    return offs.astype(np.int32) if offs.size else None


def stencil_offsets(topo: Topology, max_offsets: int = 16) -> Optional[np.ndarray]:
    """Sorted unique ``(neighbor - node) mod n`` over all live adjacency
    slots, or None when the topology is implicit, has more than
    ``max_offsets`` classes, or a self-loop (class 0). A batched-semantics
    arithmetic lattice (its target is its population) takes them from
    ``kind_offsets``; every other build (reference semantics, the imp
    kinds' random edges) scans its adjacency, as the JAX package always
    does. The two are pinned equal in tests/test_torch_topology.py."""
    if topo.implicit or topo.n < 2:
        return None
    if topo.kind in _ARITHMETIC_KINDS and topo.target_count == topo.n:
        offs = kind_offsets(topo.kind, topo.n_requested)
        return offs if offs is not None and offs.size <= max_offsets else None
    return _scan_offsets(topo, topo.degree, max_offsets)


def _scan_offsets(topo: Topology, live_slots: np.ndarray,
                  max_offsets: int) -> Optional[np.ndarray]:
    """Sorted unique ``(neighbor - node) mod n`` over the first
    ``live_slots[i]`` slots of each row, or None past ``max_offsets`` of
    them, with none, or with class 0 (a self-loop)."""
    cols = np.arange(topo.max_deg)[None, :]
    live = cols < live_slots[:, None]
    ids = np.arange(topo.n, dtype=np.int64)[:, None]
    diffs = _few_unique((topo.neighbors.astype(np.int64) - ids)[live] % topo.n,
                        max_offsets)
    if diffs is None or diffs.size == 0 or diffs[0] == 0:
        return None
    return diffs.astype(np.int32)


def _few_unique(values: np.ndarray, limit: int) -> Optional[np.ndarray]:
    """np.unique of an array expected to hold few distinct values, or None
    past ``limit`` of them: one filtering pass per value found, instead of
    sorting the whole array (tens of millions of slots on a big lattice)."""
    found = []
    while values.size:
        if len(found) == limit:
            return None
        found.append(values.min())
        values = values[values != found[-1]]
    return np.asarray(found, dtype=values.dtype)


def lattice_dirs(kind: str, n: int, n_lat: int, idx):
    """The direction pairs of a lattice kind in neighbour-column order: a
    list of (live, d) over the node indices ``idx`` (an int64 numpy array
    or torch tensor), where a live direction leads to node (idx + d) mod n.
    ``n`` is the population and ``n_lat`` the nodes of the lattice proper:
    n, or n - 1 past the reference grids' unwired Q1 node. The build
    functions pack these into the neighbour table, the streaming stencil
    engine samples them directly (ops/fused_stencil_hbm.py), and
    csrc/stencil.cuh computes the same pairs on the card."""
    in_lat = idx < n_lat
    zero = idx * 0
    if kind == "ring":
        return [(in_lat, zero + (n - 1)), (in_lat, zero + 1)]
    if kind in ("line", "ref2d"):
        # Chain wiring over the whole population (ref2d is quirk Q6).
        return [(in_lat & (idx > 0), zero + (n - 1)),
                (in_lat & (idx < n_lat - 1), zero + 1)]
    if kind == "grid2d":
        s = math.isqrt(n_lat)
        x, y = idx % s, idx // s
        return [(in_lat & (x > 0), zero + (n - 1)), (in_lat & (x < s - 1), zero + 1),
                (in_lat & (y > 0), zero + (n - s)), (in_lat & (y < s - 1), zero + s)]
    g = _cube_side(n_lat)
    g2 = g * g
    x, y, z = idx % g, (idx // g) % g, idx // g2
    if kind == "grid3d":
        return [(in_lat & (x > 0), zero + (n - 1)), (in_lat & (x < g - 1), zero + 1),
                (in_lat & (y > 0), zero + (n - g)), (in_lat & (y < g - 1), zero + g),
                (in_lat & (z > 0), zero + (n - g2)), (in_lat & (z < g - 1), zero + g2)]

    def pick(cond, a, b):  # a where cond, else b (numpy or torch alike)
        return zero + b + (a - b) * cond

    # torus3d: a face's wrap edge is +-(g-1) steps along its axis.
    return [(in_lat, pick(x > 0, n - 1, g - 1)),
            (in_lat, pick(x < g - 1, 1, n - (g - 1))),
            (in_lat, pick(y > 0, n - g, g * (g - 1))),
            (in_lat, pick(y < g - 1, g, n - g * (g - 1))),
            (in_lat, pick(z > 0, n - g2, g2 * (g - 1))),
            (in_lat, pick(z < g - 1, g2, n - g2 * (g - 1)))]


def _pack(kind: str, n_requested: int, pop: int, target: int, pairs,
          extra: Optional[np.ndarray] = None) -> Topology:
    """A Topology from direction pairs over the nodes 0..pop-1: row i holds
    its live neighbours left-aligned in direction order, then ``extra[i]``
    (the imp kinds' long-range edge) for rows i < len(extra), zero-padded
    to max_deg = max(largest degree, 1) columns."""
    i = np.arange(pop, dtype=np.int64)
    width = len(pairs) + (extra is not None)
    if extra is None and all(live.all() for live, _ in pairs):
        # The wrap kinds: one column each.
        nbr = np.stack([(i + d) % pop for _, d in pairs], axis=1).astype(np.int32)
        deg = np.full(pop, len(pairs), dtype=np.int32)
    else:
        nbr = np.zeros((pop, width), dtype=np.int32)
        deg = np.zeros(pop, dtype=np.int32)
        for live, d in pairs:
            rows = np.flatnonzero(live)
            nbr[rows, deg[rows]] = (rows + d[rows]) % pop
            deg[rows] += 1
        if extra is not None:
            rows = np.arange(len(extra))
            nbr[rows, deg[rows]] = extra
            deg[rows] += 1
    max_deg = max(int(deg.max(initial=0)), 1)
    return Topology(kind, pop, n_requested, target, max_deg,
                    np.ascontiguousarray(nbr[:, :max_deg]), deg)


def _build(kind: str, n_requested: int, pop: int, n_lat: int,
           target: int) -> Topology:
    """A lattice's Topology from its direction pairs (``lattice_dirs``)."""
    i = np.arange(pop, dtype=np.int64)
    return _pack(kind, n_requested, pop, target, lattice_dirs(kind, pop, n_lat, i))


def build_line(n: int, reference: bool = False) -> Topology:
    """Path graph: node i <-> {i-1, i+1}; the ends have one neighbour."""
    pop = n + 1 if reference else n
    return _build("line", n, pop, pop, n if reference else pop)


def build_ring(n: int, reference: bool = False) -> Topology:
    """Cycle graph: node i <-> {(i-1) mod n, (i+1) mod n}."""
    pop = n + 1 if reference else n
    return _build("ring", n, pop, pop, n if reference else pop)


def build_full(n: int, reference: bool = False) -> Topology:
    """Complete graph, implicit: partners are drawn as index shifts, never
    gathered from an adjacency row."""
    pop = n + 1 if reference else n
    if pop < 2:
        raise ValueError("full topology needs at least 2 nodes")
    return Topology("full", pop, n, n if reference else pop, 0, None, None)


def build_grid2d(n: int, reference: bool = False) -> Topology:
    """4-neighbour grid over side**2 nodes, side = ceil(sqrt(n)); reference
    semantics append one unwired node (Q1)."""
    sq = math.ceil(math.sqrt(n)) ** 2
    return _build("grid2d", n, sq + (1 if reference else 0), sq, sq)


def build_ref2d(n: int, reference: bool = True) -> Topology:
    """The reference's "2D" (Q6): n rounds up to a square, wired as a line
    over the whole population (the Q1 extra node included)."""
    sq = math.ceil(math.sqrt(n)) ** 2
    pop = sq + 1 if reference else sq
    return _build("ref2d", n, pop, pop, sq if reference else pop)


def build_grid3d(n: int, reference: bool = False) -> Topology:
    """6-neighbour grid over g**3 nodes, g the floored cube side of n;
    reference semantics append one unwired node (Q1)."""
    cube = _cube_side(n) ** 3
    return _build("grid3d", n, cube + (1 if reference else 0), cube, cube)


def build_torus3d(n: int, reference: bool = False) -> Topology:
    """3-D torus over g**3 nodes: six neighbours per node, wrapping on every
    axis (multi-edges at g = 2). Reference semantics change nothing; n < 8
    has no torus and raises."""
    del reference
    if n < 8:
        raise ValueError("torus3d needs at least 8 nodes (cube side >= 2)")
    cube = _cube_side(n, min_side=2) ** 3
    return _build("torus3d", n, cube, cube, cube)


def _uniform_other(rng: np.random.Generator, pop: int) -> np.ndarray:
    """One long-range partner per node i < pop, uniform over [0, pop) \\ {i}:
    a draw from [0, pop - 1) stepped past i."""
    draws = rng.integers(0, pop - 1, size=pop)
    return draws + (draws >= np.arange(pop))


def build_imp2d(n: int, seed: int = 0, reference: bool = False) -> Topology:
    """The grid2d lattice over side**2 nodes, side = ceil(sqrt(n)), plus
    one uniformly random long-range edge per node (j != i) as the last
    column; reference semantics append one unwired node (Q1)."""
    sq = math.ceil(math.sqrt(n)) ** 2
    pop = sq + (1 if reference else 0)
    rng = np.random.default_rng(seed)
    extra = _uniform_other(rng, sq) if sq >= 2 else None
    pairs = lattice_dirs("grid2d", pop, sq, np.arange(pop, dtype=np.int64))
    return _pack("imp2d", n, pop, sq, pairs, extra)


def build_imp3d(n: int, seed: int = 0, reference: bool = False) -> Topology:
    """The grid3d lattice plus one random extra neighbour per node
    (program.fs:267-313).

    Honest semantics: n rounds down to a cube (n >= 8), the lattice covers
    it, and the extra edge is uniform over j != i. Reference semantics
    (C3/Q8/Q9): rounded = floor(n**0.33334)**3 and the population is
    rounded + 1 (Q1); the lattice side is floor(n**0.34), its rows and
    forward edges cut at limit = min(g**3, rounded), so nodes the lattice
    misses are orphans (Q8); each lattice row's extra is drawn from
    [0, rounded - 1) and may be a self-edge or a duplicate (Q9)."""
    rng = np.random.default_rng(seed)
    if not reference:
        if n < 8:
            raise ValueError("imp3d needs at least 8 nodes (cube side >= 2)")
        pop = _cube_side(n, min_side=2) ** 3
        pairs = lattice_dirs("grid3d", pop, pop, np.arange(pop, dtype=np.int64))
        return _pack("imp3d", n, pop, pop, pairs, _uniform_other(rng, pop))
    rounded = max(int(math.floor(n**0.33334)) ** 3, 1)
    g = max(int(math.floor(n**0.34)), 1)
    g2 = g * g
    pop = rounded + 1
    limit = min(g**3, rounded)
    idx = np.arange(pop, dtype=np.int64)
    x, y, z = idx % g, (idx // g) % g, idx // g2
    inside = idx < limit
    zero = idx * 0
    pairs = [(inside & (x > 0), zero + (pop - 1)),
             (inside & (x < g - 1) & (idx + 1 < limit), zero + 1),
             (inside & (y > 0), zero + (pop - g)),
             (inside & (y < g - 1) & (idx + g < limit), zero + g),
             (inside & (z > 0), zero + (pop - g2)),
             (inside & (z < g - 1) & (idx + g2 < limit), zero + g2)]
    extra = rng.integers(0, max(rounded - 1, 1), size=limit)
    return _pack("imp3d", n, pop, rounded, pairs, extra)


# The lattice under each imp kind's extra edge.
IMP_LATTICE = {"imp2d": "grid2d", "imp3d": "grid3d"}


@dataclasses.dataclass(frozen=True)
class ImpSplit:
    """Lattice/extra decomposition of an imp2d/imp3d adjacency for pooled
    delivery (ops/delivery.deliver_imp_pool). The builders append each
    node's long-range edge as the LAST live slot of its row, after the
    lattice edges, so:

    - ``lattice_offsets``: the sorted modular displacement classes of the
      non-extra slots ({+-1, +-side} for imp2d, {+-1, +-g, +-g**2} for
      imp3d);
    - ``disp_cols``: [n, max_deg] int32 per-slot modular displacement,
      -1 on the extra slot and on dead slots (so a sampled extra never
      aliases a lattice class);
    - ``degree``: the row degrees (the extra slot is index degree - 1)."""

    lattice_offsets: np.ndarray  # [L] int32, sorted unique, no 0
    disp_cols: np.ndarray  # [n, max_deg] int32, -1 on extra/dead slots
    degree: np.ndarray  # [n] int32


def imp_lattice_offsets(topo: Topology, max_offsets: int = 16) -> Optional[np.ndarray]:
    """``imp_split(topo).lattice_offsets`` without building the split's
    per-slot columns: for a batched-semantics build (its target is its
    population) the lattice kind's ``kind_offsets`` at the built
    population, else a scan of every row's slots but the last live one.
    None when the topology is not an imp kind or its lattice slots are not
    offset-structured (the two ways are pinned equal in
    tests/test_torch_topology_imp.py)."""
    if topo.kind not in IMP_LATTICE or topo.implicit or topo.n < 2:
        return None
    if topo.target_count == topo.n:
        offs = kind_offsets(IMP_LATTICE[topo.kind], topo.n)
        return offs if offs is not None and offs.size <= max_offsets else None
    return _scan_offsets(topo, topo.degree - 1, max_offsets)


def imp_split(topo: Topology, max_offsets: int = 16) -> Optional[ImpSplit]:
    """The lattice/extra split, or None when the topology is not an imp
    kind or its non-extra slots are not offset-structured."""
    offs = imp_lattice_offsets(topo, max_offsets)
    if offs is None:
        return None
    lattice_live = np.arange(topo.max_deg)[None, :] < topo.degree[:, None] - 1
    ids = np.arange(topo.n, dtype=np.int64)[:, None]
    disp = (topo.neighbors.astype(np.int64) - ids) % topo.n
    return ImpSplit(
        lattice_offsets=offs,
        disp_cols=np.where(lattice_live, disp, -1).astype(np.int32),
        degree=topo.degree.copy(),
    )


_BUILD = {
    "line": build_line,
    "ring": build_ring,
    "full": build_full,
    "grid2d": build_grid2d,
    "ref2d": build_ref2d,
    "grid3d": build_grid3d,
    "torus3d": build_torus3d,
}


def build_topology(kind: str, n: int, *, seed: int = 0,
                   semantics: str = "batched") -> Topology:
    """Build a topology by kind; ``seed`` feeds the imp kinds' extra
    edges."""
    reference = semantics == "reference"
    if kind == "imp2d":
        return build_imp2d(n, seed, reference)
    if kind == "imp3d":
        return build_imp3d(n, seed, reference)
    if kind not in _BUILD:
        raise ValueError(f"unknown topology kind {kind!r}")
    return _BUILD[kind](n, reference)
