"""The streaming pool kernels' per-node helpers (cop5615_gossip_protocol_tpu_
torch/csrc/pool2.cuh), built for the host with g++ into a tiny shared
library and called through ctypes, against the port's plain versions: the
mod-n source of a destination (stencil.cuh's class_source, which the column
helper uses), the packed word and sub-slot of a source, its regenerated
pool choice, the sources and choices of a whole packed-word column (the
kernels' word-grain hashing, wrap column included), and the push-sum
term/conv plane."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include "pool2.cuh"
using namespace gossip::pool2;
extern "C" void sources(int n, int d, int count, int* out) {
  for (int j = 0; j < count; ++j) out[j] = gossip::class_source(j, d, n);
}
extern "C" void words(int count, uint32_t* word, int* sub) {
  for (int i = 0; i < count; ++i) {
    word[i] = choice_word_index(i);
    sub[i] = choice_sub(i);
  }
}
extern "C" void choices(uint32_t k1, uint32_t k2, int n, int n_pad, int pool_size,
                        int* out) {
  for (int i = 0; i < n_pad; ++i) out[i] = source_choice(k1, k2, i, n, pool_size);
}
// Every packed-word column of the layout under displacement d, scattered
// back to flat destinations; returns the Threefry words drawn in all.
extern "C" long columns(uint32_t k1, uint32_t k2, int n, int n_pad, int d,
                        int pool_size, int* src_out, int* ch_out) {
  long drawn = 0;
  for (int col = 0; col < n_pad / kPack; ++col) {
    const int j0 = (col / kLanes) * kPack * kLanes + col % kLanes;
    int src[kPack], ch[kPack];
    drawn += column_sources(j0, d, n, k1, k2, pool_size, src, ch);
    for (int sub = 0; sub < kPack; ++sub) {
      src_out[j0 + sub * kLanes] = src[sub];
      ch_out[j0 + sub * kLanes] = ch[sub];
    }
  }
  return drawn;
}
extern "C" void tc(const int* term, const int* conv, int count, int* packed,
                   int* term_back, int* conv_back) {
  for (int i = 0; i < count; ++i) {
    packed[i] = tc_pack(term[i], conv[i] != 0);
    term_back[i] = tc_term(packed[i]);
    conv_back[i] = tc_conv(packed[i]) ? 1 : 0;
  }
}
"""

# Z = n_pad - n > 0 (the wrap shifts wrapped sources), Z = 0, and the pool2
# tier's first population (Z = 65,535).
SIZES = (20_000, 65_536, 2**21 + 1)
POOL = 4


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pool2_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    shim.columns.restype = ctypes.c_long
    return shim


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _round_key(seed, r):
    key = fused.round_keys(rng.PRNGKey(seed), r, 1)[0]
    return key, [ctypes.c_uint32(int(v)) for v in key]


def _choice(key, n):
    """The plain versions' choice of every node (pad lanes -1)."""
    layout = fused_pool.build_pool_layout(n)
    ch = fused_pool._choice_plane(key, layout.rows, POOL).reshape(-1).numpy()
    return np.where(np.arange(layout.n_pad) < n, ch, -1), layout.n_pad


@pytest.mark.parametrize("n", SIZES)
def test_source_index_is_the_mod_n_roll(shim, n):
    n_pad = fused_pool.build_pool_layout(n).n_pad
    for d in (1, 127, 128, 1025, n // 2, n - 1):
        out = np.zeros(n_pad, dtype=np.int32)
        shim.sources(n, d, n_pad, _ptr(out))
        want = fused.class_sources(n_pad, torch.tensor(d), n).numpy()
        assert (out == want).all()


def test_word_and_sub_slot(shim):
    n_pad = fused_pool.build_pool_layout(70_000).n_pad
    word = np.zeros(n_pad, dtype=np.uint32)
    sub = np.zeros(n_pad, dtype=np.int32)
    shim.words(n_pad, _ptr(word), _ptr(sub))
    i = np.arange(n_pad)
    row, lane = i // 128, i % 128
    assert (word == (row // 8) * 128 + lane).all()
    assert (sub == row % 8).all()


@pytest.mark.parametrize("n", SIZES)
def test_regenerated_choice_matches_the_choice_plane(shim, n):
    key, (k1, k2) = _round_key(3, 17)
    want, n_pad = _choice(key, n)
    out = np.zeros(n_pad, dtype=np.int32)
    shim.choices(k1, k2, n, n_pad, POOL, _ptr(out))
    assert (out == want).all()


@pytest.mark.parametrize("n", SIZES)
def test_column_sources_and_choices(shim, n):
    key, (k1, k2) = _round_key(5, 2)
    choice, n_pad = _choice(key, n)
    offs = fused_pool.round_offsets(rng.PRNGKey(5), 2, 1, POOL, n)[0].tolist()
    # The round's own pool, plus the edges: the smallest and largest
    # displacement, and one that puts the wrap on a column boundary.
    for d in offs + [1, n - 1, 1024 * (n // 2048)]:
        src = np.zeros(n_pad, dtype=np.int32)
        ch = np.zeros(n_pad, dtype=np.int32)
        drawn = shim.columns(k1, k2, n, n_pad, d, POOL, _ptr(src), _ptr(ch))
        want_src = fused.class_sources(n_pad, torch.tensor(d), n).numpy()
        assert (src == want_src).all()
        assert (ch == np.where(want_src < n, choice[np.minimum(want_src, n_pad - 1)],
                               -1)).all()
        # Two words per column, eight on the columns the wrap cuts through
        # (at most one per lane).
        cut = (drawn - 2 * (n_pad // 8)) // 6
        assert drawn == 2 * (n_pad // 8) + 6 * cut and 0 <= cut <= 128


def test_term_conv_plane_round_trips(shim):
    term = np.array([0, 1, 5, 2**29, 2**30 - 1] * 2, dtype=np.int32)
    conv = np.array([0] * 5 + [1] * 5, dtype=np.int32)
    packed, term_back, conv_back = (np.zeros_like(term) for _ in range(3))
    shim.tc(_ptr(term), _ptr(conv), term.size, _ptr(packed), _ptr(term_back),
            _ptr(conv_back))
    assert (packed == np.where(conv != 0, term | (1 << 30), term)).all()
    assert (term_back == term).all() and (conv_back == conv).all()
