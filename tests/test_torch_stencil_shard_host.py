"""The sharded lattice kernels' per-slot helpers (cop5615_gossip_protocol_
tpu_torch/csrc/shard.cuh: shard_global_flat, shard_source, shard_middle,
shard_global_row, word_class, word_mark, setup_shard), built for the host
with g++ into a tiny shared library and called through ctypes. For every
slot of every shard's extended buffer the shim gives its global flat index,
whether it is a middle row, and its source slot along every class. The
global index must be the row map's (numpy); a plane whose value is its own
global flat index, extended by the port's ring wire (parallel/halo.py),
must hold at each middle receiver's source slot the node the mod-n roll
sends from (class_source), for the rolls of both tiers, which must be the
JAX package's (its signed offsets, _class_sigmas). The wrap-free global row
must be (row0 + r) mod R wherever row0 + rows_ext <= 2R; the packed
directions word (parallel/fused_sharded.dir_words) read by word_class must
give, for every global index of every lattice kind and a spread of draws,
the class of csrc/stencil.cuh's sample_disp (class_of), and word_mark the
mark_of of the single-device kernels; setup_shard must refuse windows that
are not nested ranges ending at the middle."""

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
from cop5615_gossip_protocol_tpu_torch.ops.fused_stencil_hbm import _KIND_IDS, stencil_spec
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
// shard_global_row of every extended row of a buffer.
extern "C" void global_rows(int R, int row0, int rows_ext, int* out) {
  const ShardGeom G{R, row0, rows_ext, 1, rows_ext - 2};
  for (int r = 0; r < rows_ext; ++r) out[r] = shard_global_row(G, r);
}
// Per global index g < count and draw bits[b]: word_class of g's
// directions word (got) beside the class of sample_disp's displacement
// (want, -1 for none and for the pad lanes); per g, word_mark beside
// mark_of under the key (k0, k1).
extern "C" int word_checks(int kind, int n, int extra_node, const int* classes,
                           int n_classes, const int* words, int count,
                           const unsigned* bits, int n_bits, unsigned k0,
                           unsigned k1, int* got, int* want, int* got_mark,
                           int* want_mark) {
  Lattice L;
  Classes cls;
  if (!setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls)) return 0;
  const long long key[2] = {(long long)k0, (long long)k1};
  for (int g = 0; g < count; ++g) {
    for (int b = 0; b < n_bits; ++b) {
      got[g * n_bits + b] = word_class((uint32_t)words[g], bits[b]);
      const int d = g < n ? sample_disp(L, g, bits[b]) : -1;
      want[g * n_bits + b] = d < 0 ? -1 : class_of(d, cls.d, cls.count);
    }
    got_mark[g] = word_mark((uint32_t)words[g], k0, k1, g);
    want_mark[g] = g < n ? mark_of(L, cls, key, g) : -1;
  }
  return 1;
}
// setup_shard's verdict on a super-step's arguments.
extern "C" int shard_ok(int n, const int* classes, int n_classes, int R, int row0,
                        int rows_ext, int H, int rows_loc, const int* e1,
                        const int* e2, const int* win, int rounds) {
  ShardGeom G;
  ShardClasses sc;
  ShardWindows W;
  return setup_shard(n, classes, n_classes, R, row0, rows_ext, H, rows_loc, e1, e2,
                     win, rounds, &G, &sc, &W) ? 1 : 0;
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
    P, I = ctypes.c_void_p, ctypes.c_int
    so.shard_slots.argtypes = [I] * 6 + [P] * 6
    so.global_rows.argtypes = [I, I, I, P]
    so.word_checks.argtypes = [I, I, I, P, I, P, I, P, I, ctypes.c_uint, ctypes.c_uint,
                               P, P, P, P]
    so.shard_ok.argtypes = [I, P, I, I, I, I, I, I, P, P, P, I]
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


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_global_row_is_the_row_map_without_a_modulo(shim, S):
    """Every shard geometry the plans allow (H <= rows_loc, so row0 +
    rows_ext <= 2R), at every H: one conditional subtract is the mod."""
    R = 64 * S
    rows_loc = R // S
    for H in (1, rows_loc // 2, rows_loc):
        geom = fused_sharded.ShardGeometry(R, H, rows_loc, 1)
        for s in range(S):
            row0 = geom.row0(s)
            assert row0 + geom.rows_ext <= 2 * R
            out = np.empty(geom.rows_ext, np.int32)
            shim.global_rows(R, row0, geom.rows_ext, _ptr(out))
            assert (out == (row0 + np.arange(geom.rows_ext)) % R).all(), (H, s)


# Every lattice kind, with its boundary faces, pad lanes, the reference
# grids' unwired extra node (ref2d) and a cube of side 2, whose two
# directions along an axis share one displacement.
WORD_CASES = [("ring", 1000, "batched"), ("line", 1000, "batched"),
              ("grid2d", 900, "batched"), ("grid3d", 1000, "batched"),
              ("torus3d", 27_000, "batched"), ("torus3d", 8, "batched"),
              ("ref2d", 900, "reference")]


@pytest.mark.parametrize("kind,n,semantics", WORD_CASES)
def test_direction_word_class_is_sample_disp(shim, kind, n, semantics):
    topo = build_topology(kind, n, semantics=semantics)
    spec = stencil_spec(topo)
    layout = fused_pool.build_pool_layout(topo.n)
    words = fused_sharded.dir_words(spec, layout.rows, torch.device("cpu")).numpy()
    classes = np.ascontiguousarray(spec.classes, np.int32)
    bits = np.array([0, 1, 2, 3, 4, 5, 7, 11, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                     2_654_435_761], np.uint32)
    count = words.size
    got = np.empty(count * bits.size, np.int32)
    want = np.empty_like(got)
    got_mark = np.empty(count, np.int32)
    want_mark = np.empty_like(got_mark)
    assert shim.word_checks(_KIND_IDS[kind], topo.n, topo.n - spec.n_lat, _ptr(classes),
                            classes.size, _ptr(words), count, _ptr(bits), bits.size,
                            0x12345678, 0x9ABCDEF0, _ptr(got), _ptr(want),
                            _ptr(got_mark), _ptr(want_mark))
    assert (got == want).all()
    assert (got_mark == want_mark).all()
    assert (words[topo.n:] == 0).all()  # pad lanes never send
    # Degree (bits 24-26) and at most six 4-bit class ids below it.
    assert ((words >> 24) == topo.degree.tolist() + [0] * (count - topo.n)).all()


def test_setup_shard_refuses_bad_windows(shim):
    n, R = 125_000, 1024
    classes = np.array([1, 50], np.int32)
    e1 = np.array([1, 50], np.int32)
    e2 = e1.copy()

    def ok(win, H=64, rows_loc=512, row0=0, rounds=2):
        win = np.ascontiguousarray(win, np.int32).reshape(-1)
        return shim.shard_ok(n, _ptr(classes), 2, R, row0, rows_loc + 2 * H, H, rows_loc,
                             _ptr(e1), _ptr(e2), _ptr(win), rounds)

    H, rows_loc = 64, 512
    mid = (H, H + rows_loc)
    assert ok([(H - 2, H + rows_loc + 2), (H - 1, H + rows_loc + 1), mid])
    assert not ok([(H - 2, H + rows_loc + 2), (H - 1, H + rows_loc + 1),
                   (H, H + rows_loc - 1)])  # the last window is not the middle
    assert not ok([(H, H + rows_loc), (H - 1, H + rows_loc + 1), mid])  # not nested
    assert not ok([(-1, H + rows_loc + 2), (H - 1, H + rows_loc + 1), mid])
    assert not ok([(0, rows_loc + 2 * H + 1), (H - 1, H + rows_loc + 1), mid])
    assert not ok([(H - 2, H + rows_loc + 2), (H - 1, H + rows_loc + 1), mid], row0=R)
    # A buffer longer than the layout: its row map wraps once while row0 +
    # rows_ext <= 2R, twice past it.
    H, rows_loc = 384, 512
    mid = (H, H + rows_loc)
    assert ok([mid, mid], H=H, rows_loc=rows_loc, rounds=1, row0=2 * R - rows_loc - 2 * H)
    assert not ok([mid, mid], H=H, rows_loc=rows_loc, rounds=1,
                  row0=2 * R - rows_loc - 2 * H + 1)
