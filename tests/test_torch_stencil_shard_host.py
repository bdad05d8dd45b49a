"""The sharded lattice kernels' per-slot helpers (cop5615_gossip_protocol_
tpu_torch/csrc/shard.cuh: shard_global_flat, shard_source, shard_middle),
built for the host with g++ into a tiny shared library and called through
ctypes. For every slot of every shard's extended buffer the shim gives its
global flat index, whether it is a middle row, and its source slot along
every class. The global index must be the row map's (numpy); a plane
whose value is its own global flat index, extended by the port's ring wire
(parallel/halo.py), must hold at each middle receiver's source slot the
node the mod-n roll sends from (class_source), for the rolls of both
tiers, which must be the JAX package's (its signed offsets, _class_sigmas)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.parallel import fused_hbm_sharded as jax_fh
from cop5615_gossip_protocol_tpu.parallel import fused_sharded as jax_fs

from cop5615_gossip_protocol_tpu_torch import build_topology
from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded, fused_sharded, halo

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include "shard.cuh"
using namespace gossip;
// Per extended slot x: its global flat index, its middle flag and, per
// class k, its source slot (src[k * n_ext + x]).
extern "C" void shard_slots(int R, int row0, int rows_ext, int H, int rows_loc,
                            int count, const int* d, const int* e1, const int* e2,
                            int* g_out, int* mid_out, int* src_out) {
  ShardGeom G{R, row0, rows_ext, H, rows_loc};
  ShardClasses sc;
  sc.cls.count = count;
  for (int k = 0; k < count; ++k) {
    sc.cls.d[k] = d[k];
    sc.e1[k] = e1[k];
    sc.e2[k] = e2[k];
  }
  const int n_ext = rows_ext * 128;
  for (int x = 0; x < n_ext; ++x) {
    const int g = shard_global_flat(G, x);
    g_out[x] = g;
    mid_out[x] = shard_middle(G, x) ? 1 : 0;
    for (int k = 0; k < count; ++k) src_out[k * n_ext + x] = shard_source(sc, k, x, g, n_ext);
  }
}
"""

# (kind, n, shards, H): the torus's pad lanes (the mod-n blend), a ring
# without pad, a non-wrap grid with pad, and a halo of a whole shard.
CASES = (("torus3d", 125_000, 2, 512), ("ring", 131_072, 4, 128),
         ("grid2d", 130_000, 2, 512), ("torus3d", 27_000, 2, 128))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("stencil_shard_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.shard_slots.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
    return so


def _slots(shim, geom, row0, rolls):
    n_ext = geom.rows_ext * 128
    arrays = [np.ascontiguousarray([r[i] for r in rolls], np.int32) for i in range(3)]
    g, mid = np.empty(n_ext, np.int32), np.empty(n_ext, np.int32)
    src = np.empty(len(rolls) * n_ext, np.int32)
    shim.shard_slots(geom.R, row0, geom.rows_ext, geom.H, geom.rows_loc, len(rolls),
                     *(ctypes.c_void_p(a.ctypes.data) for a in (*arrays, g, mid, src)))
    return g, mid.astype(bool), src.reshape(len(rolls), n_ext)


def _rolls_match_the_jax_offsets(kind, n, layout, n_ext):
    """The B10 rolls are the JAX kernel's (-signed_pad) shifts; the B11 rolls
    its _class_sigmas."""
    topo, jtopo = build_topology(kind, n), jax_topology(kind, n)
    b10 = fused_sharded.shift_pairs(topo.offsets, topo.n, layout.n_pad, n_ext)
    for d, e1, e2 in b10:
        assert e1 == (-jax_fs._signed_pad(-d, layout.n_pad)) % n_ext
        assert e2 == (-jax_fs._signed_pad(topo.n - d, layout.n_pad)) % n_ext
    assert jtopo.n == topo.n
    jl = jax_fused_pool.build_pool_layout(jtopo.n)
    assert fused_hbm_sharded._class_sigmas(topo, layout) == jax_fh._class_sigmas(jtopo, jl)
    assert fused_hbm_sharded._halo_width_slots(topo, layout) == \
        jax_fh._halo_width_slots(jtopo, jl)
    return topo, b10, fused_hbm_sharded.class_rolls(topo, layout, n_ext)


@pytest.mark.parametrize("kind,n,S,H", CASES)
def test_every_receiver_reads_its_mod_n_source(shim, kind, n, S, H):
    layout = fused_pool.build_pool_layout(build_topology(kind, n).n)
    R = layout.rows
    geom = fused_sharded.ShardGeometry(R, H, R // S, 1)
    n_ext = geom.rows_ext * 128
    topo, b10, b11 = _rolls_match_the_jax_offsets(kind, n, layout, n_ext)
    ids = torch.arange(layout.n_pad, dtype=torch.int32).reshape(R, 128)
    sets = []
    for s in range(S):
        ext = torch.full((geom.rows_ext, 128), -1, dtype=torch.int32)
        ext[H:H + geom.rows_loc] = ids[s * geom.rows_loc:(s + 1) * geom.rows_loc]
        sets.append((ext,))
    halo.exchange_rows_batched(halo.ring_exchange(sets, H, geom.rows_loc))
    wrap = kind in ("ring", "torus3d")
    for s in range(S):
        row0 = geom.row0(s)
        x = np.arange(n_ext)
        want_g = ((row0 + x // 128) % R) * 128 + x % 128
        ext = sets[s][0].reshape(-1).numpy()
        assert (ext == want_g).all()  # the wire filled every halo row
        for rolls in (b10, b11):
            g, mid, src = _slots(shim, geom, row0, rolls)
            assert (g == want_g).all()
            assert (mid == ((x // 128 >= H) & (x // 128 < H + geom.rows_loc))).all()
            real = mid & (g < topo.n)
            for k, (d, _e1, _e2) in enumerate(rolls):
                want = np.where(g >= d, g - d, g - d + topo.n)
                got = ext[src[k]]
                if wrap:
                    assert (got[real] == want[real]).all(), (s, d)
                else:
                    # Non-wrap lattices: a receiver whose mod-n source lies
                    # across the global wrap never hears from it (the
                    # source's direction is not live), so only the other
                    # receivers' sources must be exact.
                    inner = real & (np.abs(g - want) <= topo.n // 2)
                    assert (got[inner] == want[inner]).all(), (s, d)
