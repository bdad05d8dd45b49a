"""The port's imp2d/imp3d build functions (cop5615_gossip_protocol_tpu_torch/
ops/topology.py) against the JAX package's: byte-identical neighbour
tables, degrees, populations and targets in both semantics (the reference
imp3d's two roundings, its cut lattice and its self-edge draws included),
over two seeds; the lattice/extra split; the displacement-class scan the
port now runs for kinds without arithmetic classes; and a JAX imp build
carried across with utils/carry.py, which must be the port's own build."""

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu.ops import topology as jax_topology

from cop5615_gossip_protocol_tpu_torch.ops import topology
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

HONEST = [("imp2d", n) for n in (4, 9, 300, 26_896)] + [
    ("imp3d", n) for n in (8, 27, 1000, 27_000)]
REFERENCE = [("imp2d", 300), ("imp3d", 1000), ("imp3d", 4000)]


def _assert_same(port, ref):
    for field in ("kind", "n", "n_requested", "target_count", "max_deg"):
        assert getattr(port, field) == getattr(ref, field), field
    for field in ("neighbors", "degree"):
        a, b = getattr(port, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def _assert_same_split(port, ref):
    a, b = topology.imp_split(port), jax_topology.imp_split(ref)
    assert (a is None) == (b is None)
    if a is not None:
        for field in ("lattice_offsets", "disp_cols", "degree"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind,n,semantics", [
    (k, n, "batched") for k, n in HONEST] + [(k, n, "reference") for k, n in REFERENCE])
def test_imp_builds_byte_identical(kind, n, semantics, seed):
    ref = jax_topology.build_topology(kind, n, seed=seed, semantics=semantics)
    port = topology.build_topology(kind, n, seed=seed, semantics=semantics)
    _assert_same(port, ref)
    _assert_same_split(port, ref)
    # The classes the port scans for imp kinds are the JAX scan's.
    want, got = jax_topology.stencil_offsets(ref), topology.stencil_offsets(port)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == want.dtype and (got == want).all()
    # A JAX build carried across is the port's own build.
    carried = carry.topology_from_numpy(ref)
    _assert_same(carried, port)
    _assert_same_split(carried, ref)


def test_stencil_offsets_scan_the_imp_kinds():
    # kind_offsets knows no imp kind; the scan finds classes on tiny builds.
    port = topology.build_topology("imp3d", 8)
    assert topology.stencil_offsets(port).tolist() == [1, 2, 3, 4, 6, 7]
    for n in (9, 16):
        assert topology.stencil_offsets(topology.build_topology("imp2d", n)) is not None
    for kind, n in (("imp3d", 27), ("imp2d", 100)):
        assert topology.stencil_offsets(topology.build_topology(kind, n)) is None


@pytest.mark.parametrize("kind,n", HONEST + [("imp3d", 125_000)])
def test_lattice_offsets_from_the_geometry_equal_the_scan(kind, n):
    # A batched build takes its lattice classes from kind_offsets; they
    # must be the scan over every row's slots but the long-range one.
    port = topology.build_topology(kind, n)
    scanned = topology._scan_offsets(port, port.degree - 1, 16)
    assert (topology.imp_lattice_offsets(port) == scanned).all()
    # Grid side 2: two directions share a class, so L is 5 (imp3d), 3 (imp2d).
    if port.n in (4, 8):
        assert len(scanned) == {4: 3, 8: 5}[port.n]


def test_reference_imp3d_has_two_sides():
    # n = 4000: the population rounds with the cube side 15 (3375 + 1 nodes),
    # the lattice uses side 16, cut at 3375; the last lattice row is cut
    # short and the Q1 node is unwired.
    port = topology.build_topology("imp3d", 4000, semantics="reference")
    assert (port.n, port.target_count) == (3376, 3375)
    assert port.degree[-1] == 0 and (port.degree[:-1] >= 1).all()
    # Node 14 is (14, 0, 0) on side 16, so it has an x+1 neighbour (it
    # would not on side 15), then y+1 and z+1.
    assert port.neighbors[14, :4].tolist() == [13, 15, 30, 270]
    # Node 3374 is (14, 2, 13): its x+1, y+1 and z+1 fall past the cut.
    assert port.degree[3374] == 4
    assert port.neighbors[3374, :3].tolist() == [3373, 3374 - 16, 3374 - 256]


@pytest.mark.parametrize("pop,hi", [(8, 7), (1000, 999), (100_489, 100_488),
                                    (2**20, 2**20 - 1), (3375, 3374)])
def test_vectorized_draw_is_the_scalar_loop(pop, hi):
    # The JAX builders draw one scalar per node; the port draws them in one
    # call. Same generator, same values (also past 2**16 draws).
    loop_rng = np.random.default_rng(5)
    count = min(pop, 100_000)
    want = np.array([int(loop_rng.integers(0, hi)) for _ in range(count)])
    got = np.random.default_rng(5).integers(0, hi, size=pop)
    assert (got[:count] == want).all()
