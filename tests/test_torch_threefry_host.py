"""The CUDA kernels' own Threefry (cop5615_gossip_protocol_tpu_torch/csrc/
threefry.cuh), built for the host with g++ into a tiny shared library and
called through ctypes, against jax.random: the words the kernels draw,
past counter 2**16, and the packed pool slots they extract."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include "threefry.cuh"
extern "C" void words(uint32_t k1, uint32_t k2, const uint32_t* counters,
                      uint32_t* out, long count) {
  for (long i = 0; i < count; ++i)
    out[i] = gossip::threefry_word(k1, k2, counters[i]);
}
extern "C" void pair(uint32_t k1, uint32_t k2, uint32_t x0, uint32_t x1,
                     uint32_t* out) {
  gossip::threefry2x32(k1, k2, x0, x1);
  out[0] = x0;
  out[1] = x1;
}
extern "C" void slots(const uint32_t* words_in, int pool_size, int* out,
                      long count) {
  for (long i = 0; i < count; ++i)
    for (int sub = 0; sub < 8; ++sub)
      out[i * 8 + sub] = gossip::pool_slot(words_in[i], sub, pool_size);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("threefry_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _key(seed, tag):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    return key, [int(v) for v in np.asarray(key)]


@pytest.mark.parametrize("seed,tag", [(0, 0), (7, 0x0FF5), (2**31 - 1, 123)])
def test_kernel_words_match_jax_bits(shim, seed, tag):
    key, (k1, k2) = _key(seed, tag)
    count = 70000  # counters run past 2**16
    want = np.asarray(jax.random.bits(key, (count,), jnp.uint32))
    counters = np.arange(count, dtype=np.uint32)
    out = np.zeros(count, dtype=np.uint32)
    shim.words(ctypes.c_uint32(k1), ctypes.c_uint32(k2), _ptr(counters), _ptr(out),
               ctypes.c_long(count))
    assert (out == want).all()


def test_kernel_pair_is_fold_in(shim):
    key, (k1, k2) = _key(3, 9)
    out = np.zeros(2, dtype=np.uint32)
    for data in (0, 1, 0x5EED, 2**31 - 1):
        shim.pair(ctypes.c_uint32(k1), ctypes.c_uint32(k2), ctypes.c_uint32(0),
                  ctypes.c_uint32(data), _ptr(out))
        assert (out == np.asarray(jax.random.fold_in(key, data))).all()


@pytest.mark.parametrize("pool_size", [2, 4, 8, 16])
def test_kernel_slots_match_packed_choice(shim, pool_size):
    n = 70000
    kr = jax_sampling.round_key(jax.random.PRNGKey(1), 5)
    words = np.asarray(jax_sampling.pool_words(kr, n))  # [rows // 8, 128]
    out = np.zeros(words.size * 8, dtype=np.int32)
    shim.slots(_ptr(np.ascontiguousarray(words)), ctypes.c_int(pool_size), _ptr(out),
               ctypes.c_long(words.size))
    # out[(w * 128 + lane) * 8 + sub] is node row w * 8 + sub, lane lane.
    slots = out.reshape(words.shape[0], 128, 8).transpose(0, 2, 1).reshape(-1)
    want = np.asarray(jax_sampling.pool_choice_packed(kr, n, pool_size))
    assert (slots[:n] == want).all()
