"""Lattice sampling and stencil delivery of the port against the JAX
package:

- ``sampling.targets_explicit`` and ``delivery.deliver_stencil`` on the
  same seeded inputs (bitwise, float and int values);
- the direction pairs of ``ops/topology.lattice_dirs`` (over a spec the
  streaming stencil engine takes) against the JAX adjacency, on the JAX package's own case list
  (tests/test_fused_stencil_hbm.py), and the sampled displacement against
  ``targets_explicit``;
- the kernels' per-node logic in csrc/stencil.cuh, built for the host with
  g++ into a tiny shared library and called through ctypes: the lattice
  geometry (cube/square side, the reference's extra node), the direction
  pairs, the sampled displacement and each receiver's class check.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.ops import delivery as jax_delivery
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling
from cop5615_gossip_protocol_tpu.ops import topology as jax_topology

from cop5615_gossip_protocol_tpu_torch.ops import delivery, fused_stencil_hbm, sampling, topology
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

# The JAX package's case list for the arithmetic direction columns.
CASES = [
    ("torus3d", 27_000, "batched"),
    ("grid3d", 27_000, "batched"),
    ("grid2d", 26_896, "batched"),
    ("line", 5_000, "batched"),
    ("ring", 5_000, "batched"),
    ("grid3d", 27_000, "reference"),
    ("grid2d", 26_896, "reference"),
    ("ref2d", 5_000, "reference"),
]


def _jax_disp(topo, round_key):
    """Each node's sampled mod-n displacement under the JAX chunked
    engine's draw (-1 for degree 0), and the word it drew."""
    n = topo.n
    bits = jax_sampling.uniform_bits(round_key, n)
    t = np.asarray(jax_sampling.targets_explicit(
        bits, jnp.asarray(topo.neighbors), jnp.asarray(topo.degree)))
    disp = np.where(topo.degree > 0, (t.astype(np.int64) - np.arange(n)) % n, -1)
    return disp, np.asarray(bits)


@pytest.mark.parametrize("max_deg", [1, 4, 6, 7])
def test_targets_explicit_matches_jax(max_deg):
    rs = np.random.default_rng(max_deg)
    n = 5000
    neighbors = rs.integers(0, n, (n, max_deg), dtype=np.int32)
    degree = rs.integers(0, max_deg + 1, n, dtype=np.int32)
    bits = rs.integers(0, 2**32, n, dtype=np.uint32)
    want = jax_sampling.targets_explicit(
        jnp.asarray(bits), jnp.asarray(neighbors), jnp.asarray(degree))
    got = sampling.targets_explicit(
        torch.from_numpy(bits.astype(np.int64)), torch.from_numpy(neighbors),
        torch.from_numpy(degree))
    assert (got.numpy() == np.asarray(want)).all()


@pytest.mark.parametrize("kind,n,semantics", [
    ("torus3d", 1000, "batched"), ("torus3d", 8, "batched"),
    ("line", 500, "batched"), ("grid2d", 400, "reference"),
])
def test_deliver_stencil_matches_jax(kind, n, semantics):
    jtopo = jax_build(kind, n, semantics=semantics)
    topo = carry.topology_from_numpy(jtopo)
    n = topo.n
    offsets = jax_topology.stencil_offsets(jtopo)
    rs = np.random.default_rng(n)
    disp, _ = _jax_disp(jtopo, jax.random.PRNGKey(n))
    targets = np.where(disp >= 0, (np.arange(n) + disp) % n, 0).astype(np.int32)
    for values in (rs.random(n, dtype=np.float32) * 1e3,
                   rs.integers(0, 2, n, dtype=np.int32)):
        values = np.where(disp >= 0, values, 0).astype(values.dtype)
        want = jax_delivery.deliver_stencil(
            jnp.asarray(values), jnp.asarray(targets), offsets, n)
        got = delivery.deliver_stencil(
            torch.from_numpy(values), torch.from_numpy(targets.astype(np.int64)),
            offsets, n)
        assert got.dtype == torch.from_numpy(values).dtype
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
        # [C, n] channels deliver row by row.
        stacked = delivery.deliver_stencil(
            torch.from_numpy(np.stack([values, values])),
            torch.from_numpy(targets.astype(np.int64)), offsets, n)
        assert (stacked[1] == got).all()


def _port_pairs(topo):
    spec = fused_stencil_hbm.stencil_spec(topo)
    pairs = topology.lattice_dirs(spec.kind, spec.n, spec.n_lat,
                                  torch.arange(spec.n, dtype=torch.int64))
    return [(live.numpy(), disp.numpy()) for live, disp in pairs]


@pytest.mark.parametrize("kind,n,semantics", CASES)
def test_lattice_params_reproduce_the_adjacency(kind, n, semantics):
    # The j-th LIVE direction pair in column order is neighbour column j.
    jtopo = jax_build(kind, n, semantics=semantics)
    topo = carry.topology_from_numpy(jtopo)
    n = topo.n
    got = np.full((n, topo.max_deg), -1, dtype=np.int64)
    live_count = np.zeros(n, dtype=np.int64)
    for live, disp in _port_pairs(topo):
        rows = np.nonzero(live)[0]
        got[rows, live_count[rows]] = disp[rows]
        live_count += live
    assert (live_count == topo.degree).all()
    want = np.where(
        np.arange(topo.max_deg)[None, :] < topo.degree[:, None],
        (topo.neighbors.astype(np.int64) - np.arange(n)[:, None]) % n,
        -1,
    )
    assert (got == want).all()
    # And the sampled displacement is targets_explicit's.
    want_d, bits = _jax_disp(jtopo, jax_sampling.round_key(jax.random.PRNGKey(3), 7))
    d, deg = fused_stencil_hbm._sample_disp_dirs(
        torch.from_numpy(bits.astype(np.int64)),
        [(torch.from_numpy(lv), torch.from_numpy(dp)) for lv, dp in _port_pairs(topo)])
    assert (np.where(deg.numpy() > 0, d.numpy(), -1) == want_d).all()


SHIM = r"""
#include "stencil.cuh"
using namespace gossip;
extern "C" void lattice(int kind, int n, int extra, int* out) {
  const Lattice L = make_lattice(kind, n, extra);
  out[0] = L.kind; out[1] = L.n; out[2] = L.n_lat; out[3] = L.side;
}
extern "C" int dirs(int kind, int n, int extra, long count, int* live_out,
                    int* disp_out) {
  const Lattice L = make_lattice(kind, n, extra);
  int k = 0;
  for (long j = 0; j < count; ++j) {
    bool live[kMaxDirs];
    int disp[kMaxDirs];
    k = lattice_dirs(L, (int)j, live, disp);
    for (int i = 0; i < k; ++i) {
      live_out[i * count + j] = live[i] ? 1 : 0;
      disp_out[i * count + j] = disp[i];
    }
  }
  return k;
}
extern "C" void sample(int kind, int n, int extra, const uint32_t* bits,
                       long count, int* out) {
  const Lattice L = make_lattice(kind, n, extra);
  for (long j = 0; j < count; ++j) out[j] = sample_disp(L, (int)j, bits[j]);
}
extern "C" void classes(const int* ds, long count, const int* cls, int ncls,
                        int* out) {
  for (long j = 0; j < count; ++j) out[j] = class_of(ds[j], cls, ncls);
}
extern "C" void sources(long count, int d, int n, int* out) {
  for (long j = 0; j < count; ++j) out[j] = class_source((int)j, d, n);
}
extern "C" int root(int x, int p) { return integer_root(x, p); }
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("stencil_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _kernel_lattice(topo):
    spec = fused_stencil_hbm.stencil_spec(topo)
    return (fused_stencil_hbm._KIND_IDS[spec.kind], spec.n, spec.n - spec.n_lat), spec


@pytest.mark.parametrize("kind,n,semantics", CASES + [("torus3d", 8, "batched")])
def test_header_matches_the_adjacency_and_the_draw(shim, kind, n, semantics):
    jtopo = jax_build(kind, n, semantics=semantics)
    topo = carry.topology_from_numpy(jtopo)
    n = topo.n
    (kid, _, extra), spec = _kernel_lattice(topo)
    geo = np.zeros(4, dtype=np.int32)
    shim.lattice(kid, n, extra, _ptr(geo))
    side = {"grid2d": round(spec.n_lat ** 0.5)}.get(
        kind, round(spec.n_lat ** (1 / 3)) if kind in ("grid3d", "torus3d") else 0)
    assert geo.tolist() == [kid, n, spec.n_lat, side]
    # Direction pairs: the port's (already held against the adjacency).
    pairs = _port_pairs(topo)
    live = np.zeros((len(pairs), n), dtype=np.int32)
    disp = np.zeros((len(pairs), n), dtype=np.int32)
    assert shim.dirs(kid, n, extra, ctypes.c_long(n), _ptr(live), _ptr(disp)) == len(pairs)
    for k, (lv, dp) in enumerate(pairs):
        assert (live[k] == lv).all() and (disp[k] == dp).all(), k
    # Sampled displacement: targets_explicit's, -1 at degree 0.
    want_d, bits = _jax_disp(jtopo, jax_sampling.round_key(jax.random.PRNGKey(5), 11))
    got_d = np.zeros(n, dtype=np.int32)
    shim.sample(kid, n, extra, _ptr(np.ascontiguousarray(bits)), ctypes.c_long(n),
                _ptr(got_d))
    assert (got_d == want_d).all()
    # Class check: the index of the displacement in the sorted classes.
    cls = np.asarray(spec.classes, dtype=np.int32)
    got_c = np.zeros(n, dtype=np.int32)
    shim.classes(_ptr(got_d), ctypes.c_long(n), _ptr(cls), len(cls), _ptr(got_c))
    want_c = np.where(got_d >= 0, np.searchsorted(cls, got_d), -1)
    assert (got_c == want_c).all()
    for d in cls:
        src = np.zeros(n, dtype=np.int32)
        shim.sources(ctypes.c_long(n), int(d), n, _ptr(src))
        assert (src == (np.arange(n) - d) % n).all()


def test_header_integer_roots(shim):
    for p, top in ((2, 2**27), (3, 2**27)):
        for r in (1, 2, 3, 130, 215, 256, 4096, 11585):
            for x in (r**p - 1, r**p, r**p + 1):
                if 0 <= x <= top:
                    want = int(np.floor(x ** (1 / p) + 1e-9))
                    while want**p > x:
                        want -= 1
                    while (want + 1) ** p <= x:
                        want += 1
                    assert shim.root(x, p) == want, (x, p)
