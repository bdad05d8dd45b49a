"""The port's topology build functions (cop5615_gossip_protocol_tpu_torch/ops/
topology.py) against the JAX package's: byte-identical neighbour tables,
degrees, populations and targets for every lattice kind, across sizes that
round (non-square, non-cube), tiny and degenerate geometries, torus3d at
cube side 2 (multi-edges), and reference semantics (the Q1 extra node, Q6
ref2d). The displacement classes (analytic in batched semantics, scanned
in reference semantics) must equal the JAX adjacency scan; and a JAX
topology carried across with utils/carry.py must be the port's own build."""

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu.ops import topology as jax_topology

from cop5615_gossip_protocol_tpu_torch import SimConfig
from cop5615_gossip_protocol_tpu_torch.ops import topology
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SIZES = {
    "line": (1, 2, 3, 17, 1001),
    "ring": (1, 2, 3, 17, 1001),
    "ref2d": (1, 2, 4, 10, 1001),
    "grid2d": (1, 2, 4, 5, 10, 95, 1001),
    "grid3d": (1, 7, 8, 9, 26, 27, 28, 1000),
    "torus3d": (8, 9, 26, 27, 64, 1000),
}


def _assert_same(port, ref):
    for field in ("kind", "n", "n_requested", "target_count", "max_deg"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("neighbors", "degree"):
        a, b = getattr(port, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("semantics", ["batched", "reference"])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_topologies_byte_identical(kind, semantics):
    for n in SIZES[kind]:
        port = topology.build_topology(kind, n, semantics=semantics)
        ref = jax_topology.build_topology(kind, n, semantics=semantics)
        _assert_same(port, ref)
        want = jax_topology.stencil_offsets(ref)
        got = topology.stencil_offsets(port)
        assert (got is None) == (want is None), (kind, n)
        if want is not None:
            assert got.dtype == want.dtype and (got == want).all(), (kind, n)


def test_torus_side_two_has_multi_edges():
    port = topology.build_topology("torus3d", 8)
    _assert_same(port, jax_topology.build_topology("torus3d", 8))
    # +1 and -1 along an axis are the same node: every row repeats a pair.
    assert (port.neighbors[:, 0] == port.neighbors[:, 1]).all()
    assert topology.stencil_offsets(port).tolist() == [1, 2, 4, 6, 7]


@pytest.mark.parametrize("kind,n", [
    ("line", 20000), ("ring", 20000), ("ref2d", 20000), ("grid2d", 20000),
    ("grid3d", 20000), ("torus3d", 125000),
])
def test_analytic_offsets_equal_the_scan(kind, n):
    # A batched build takes its classes from kind_offsets; at sizes past
    # the small sweep they must still equal the JAX package's adjacency scan.
    port = topology.build_topology(kind, n)
    want = jax_topology.stencil_offsets(jax_topology.build_topology(kind, n))
    assert (topology.stencil_offsets(port) == want).all()
    # The engines read them once per topology, from the cached attribute.
    assert port.offsets is port.offsets and (port.offsets == want).all()
    assert (topology.kind_offsets(kind, n) == jax_topology.kind_offsets(kind, n)).all()


def test_kind_offsets_sweep_matches_jax():
    for kind, sizes in SIZES.items():
        for n in sizes:
            if kind == "torus3d" and n < 8:
                continue
            a, b = topology.kind_offsets(kind, n), jax_topology.kind_offsets(kind, n)
            assert (a is None) == (b is None), (kind, n)
            if a is not None:
                assert (a == b).all(), (kind, n)
    assert topology.kind_offsets("full", 100) is None


def test_reference_builds_scan_their_own_classes():
    # Reference-semantics populations differ from kind_offsets' batched
    # geometry (line over n+1 nodes, grid plus an unwired node), so their
    # classes come from the scan.
    for kind in ("line", "grid2d", "ref2d"):
        n = 20000
        port = topology.build_topology(kind, n, semantics="reference")
        ref = jax_topology.build_topology(kind, n, semantics="reference")
        assert (topology.stencil_offsets(port) == jax_topology.stencil_offsets(ref)).all()


def test_imp_kinds_are_not_ported():
    # The imp kinds build (tests/test_torch_topology_imp.py) and run scatter
    # (their default, along the static extra edge), pooled and matmul
    # delivery; the matmul delivery runs on the chunked engine alone
    # (tests/test_torch_matmul.py), as in JAX.
    for kind in ("imp2d", "imp3d"):
        assert topology.build_topology(kind, 1000).kind == kind
        assert SimConfig(n=1000, topology=kind, algorithm="push-sum").delivery == "auto"
        assert SimConfig(n=1000, topology=kind, algorithm="push-sum",
                         delivery="matmul").delivery == "matmul"
    with pytest.raises(ValueError, match="torus3d needs at least 8"):
        topology.build_topology("torus3d", 7)


@pytest.mark.parametrize("kind,n,semantics", [
    ("torus3d", 1000, "batched"), ("grid2d", 95, "reference"),
    ("line", 17, "reference"), ("full", 100, "reference"),
])
def test_topology_from_numpy(kind, n, semantics):
    ref = jax_topology.build_topology(kind, n, semantics=semantics)
    carried = carry.topology_from_numpy(ref)
    own = topology.build_topology(kind, n, semantics=semantics)
    if own.implicit:
        assert carried == own
    else:
        _assert_same(carried, own)
        assert carried.neighbors is not ref.neighbors  # an array of its own


def test_topology_from_numpy_refuses_a_row_slice():
    part = jax_topology.build_topology("torus3d", 1000, rows=(0, 100))
    with pytest.raises(ValueError, match="row slice"):
        carry.topology_from_numpy(part)
    bad = jax_topology.build_topology("line", 10)
    with pytest.raises(ValueError, match="shape"):
        carry.topology_from_numpy(type("T", (), {
            **{f: getattr(bad, f) for f in ("kind", "n", "n_requested",
                                            "target_count", "max_deg", "degree")},
            "neighbors": np.zeros((3, 2), np.int32)})())
