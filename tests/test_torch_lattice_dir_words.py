"""The single-device lattice kernels' static directions word
(cop5615_gossip_protocol_tpu_torch/ops/fused_stencil_hbm.dir_words) and the
resident kernel's per-round barrier word, on the CPU.

- On every single-device lattice layout (the whole-array tier's
  ``fused.build_layout``, the tiled tier's ``fused_pool.build_pool_layout``,
  the streaming tier's ``fused_stencil_hbm._streaming_layout``) and every
  lattice kind, each real slot's word, read as csrc/shard.cuh's
  ``word_class`` reads it (in numpy here), must give for a spread of draws
  the class of the JAX package's draw: ``sampling.targets_explicit`` on its
  neighbour table, as a sorted displacement class. Pad lanes and degree-0
  nodes hold 0, so they never send.
- ``parallel/fused_sharded.dir_words`` is the same function.
- csrc/stencil.cuh's barrier word, built with g++: a grid's 64-bit adds
  carry every arrival in the high half and the exact converged total in
  the low half, up to n_pad < 2**31; and its push-sum inbox, which loads
  every class source whatever its mark, bitwise the chunked engine's sum.
- The wrappers on CPU tensors run the plain version: they never build the
  directions word and never reach a kernel, and neither does ``run()`` on
  the CPU.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling
from cop5615_gossip_protocol_tpu.ops.topology import stencil_offsets

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, fused_stencil
from cop5615_gossip_protocol_tpu_torch.ops import fused_stencil_hbm
from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded
from cop5615_gossip_protocol_tpu_torch.utils import kernels

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

LAYOUTS = {"whole_array": fused.build_layout,
           "pool": fused_pool.build_pool_layout,
           "streaming": fused_stencil_hbm._streaming_layout}

# Every lattice kind: the torus with pad lanes (27,000 and 1000 in every
# layout) and at cube side 2 (two directions share a displacement), the
# boundary-masked grids and line, the ring, and the reference grid whose
# last node is unwired (ref2d).
KINDS = [("torus3d", 27_000, "batched"), ("torus3d", 1000, "batched"),
         ("torus3d", 8, "batched"), ("grid2d", 900, "batched"),
         ("grid3d", 1000, "batched"), ("line", 1000, "batched"),
         ("ring", 1000, "batched"), ("ref2d", 900, "reference")]


def word_class(words: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """csrc/shard.cuh word_class in numpy: bits % degree picks the
    slot-th 4-bit class id below the degree field; -1 for degree 0."""
    deg = (words >> 24).astype(np.uint32)
    slot = bits.astype(np.uint32) % np.maximum(deg, 1)
    cls = (words.astype(np.uint32) >> (4 * slot)) & 15
    return np.where(deg == 0, -1, cls.astype(np.int64))


def jax_classes(kind, n, semantics, bits):
    """The class of each node's JAX draw under ``bits`` (targets_explicit
    on the JAX neighbour table), -1 for degree-0 nodes."""
    jt = jax_topology(kind, n, semantics=semantics)
    target = np.asarray(jax_sampling.targets_explicit(
        jnp.asarray(bits), jnp.asarray(jt.neighbors), jnp.asarray(jt.degree)))
    d = (target.astype(np.int64) - np.arange(jt.n)) % jt.n
    classes = np.asarray(stencil_offsets(jt), dtype=np.int64)
    k = np.searchsorted(classes, d)
    assert (classes[np.minimum(k, len(classes) - 1)] == d)[jt.degree > 0].all()
    return np.where(np.asarray(jt.degree) > 0, k, -1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind,n,semantics", KINDS)
def test_word_class_is_the_jax_draw(kind, n, semantics, layout):
    topo = build_topology(kind, n, semantics=semantics)
    spec = fused_stencil_hbm.stencil_spec(topo)
    rows = LAYOUTS[layout](topo.n).rows
    words = fused_stencil_hbm.dir_words(spec, rows, torch.device("cpu")).numpy()
    assert words.shape == (rows * 128,) and words.dtype == np.int32
    assert (words[topo.n:] == 0).all()  # pad lanes never send
    rng = np.random.default_rng(7)
    draws = [np.full(topo.n, v, np.uint32) for v in (0, 1, 5, 0xFFFFFFFF)]
    draws += [rng.integers(0, 2**32, topo.n, dtype=np.uint32) for _ in range(6)]
    for bits in draws:
        got = word_class(words[:topo.n], bits)
        assert (got == jax_classes(kind, n, semantics, bits)).all()


def test_streaming_layout_past_4096_rows():
    # The streaming layout rounds rows up to a multiple of 4096 past 4096
    # rows; every slot past n is a pad lane.
    topo = build_topology("ring", 600_000)
    spec = fused_stencil_hbm.stencil_spec(topo)
    rows = fused_stencil_hbm._streaming_layout(topo.n).rows
    assert rows == 8192 and rows != fused_pool.build_pool_layout(topo.n).rows
    words = fused_stencil_hbm.dir_words(spec, rows, torch.device("cpu")).numpy()
    assert (words[topo.n:] == 0).all()
    bits = np.random.default_rng(3).integers(0, 2**32, topo.n, dtype=np.uint32)
    assert (word_class(words[:topo.n], bits) == jax_classes("ring", 600_000, "batched", bits)).all()


def test_the_sharded_compositions_share_the_word():
    assert fused_sharded.dir_words is fused_stencil_hbm.dir_words


SHIM = r"""
#include "stencil.cuh"
using namespace gossip;
// pushsum_inbox of every receiver j < n.
extern "C" void inboxes(const int* classes, int count, const signed char* mark,
                        const float* s, const float* w, int n, float* in_s,
                        float* in_w) {
  Classes cls;
  cls.count = count;
  for (int k = 0; k < kMaxClasses; ++k) cls.d[k] = k < count ? classes[k] : 0;
  for (int j = 0; j < n; ++j)
    pushsum_inbox(cls, (const int8_t*)mark, s, w, j, n, in_s[j], in_w[j]);
}
// Adds barrier_arrival(counts[b]) for b < blocks into one word, in order;
// writes the arrivals and the total it holds after each add.
extern "C" void barrier_adds(const int* counts, int blocks, unsigned* arrivals,
                             int* totals) {
  unsigned long long word = 0;
  for (int b = 0; b < blocks; ++b) {
    word += barrier_arrival(counts[b]);
    arrivals[b] = barrier_arrivals(word);
    totals[b] = barrier_total(word);
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("barrier_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.barrier_adds.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    P, I = ctypes.c_void_p, ctypes.c_int
    so.inboxes.argtypes = [P, I, P, P, P, I, P, P]
    return so


@pytest.mark.parametrize("kind,n", [("torus3d", 27_000), ("grid2d", 900), ("line", 1000),
                                    ("ring", 1000)])
def test_pushsum_inbox_is_the_chunked_engines_sum(shim, kind, n):
    # The inbox loads every class source's s and w whatever its mark: the
    # sum must still be, bit for bit, the chunked engine's order (from 0.0,
    # ascending classes, each hit's halved send), on marks that hit, miss
    # and are -1, and on values down to subnormals.
    topo = build_topology(kind, n)
    classes = np.asarray(fused_stencil_hbm.stencil_spec(topo).classes, np.int32)
    rng = np.random.default_rng(5)
    mark = rng.integers(-1, len(classes), n).astype(np.int8)
    s = (rng.random(n) * 10.0 ** rng.integers(-44, 6, n)).astype(np.float32)
    w = (rng.random(n) * 10.0 ** rng.integers(-44, 2, n)).astype(np.float32)
    got_s, got_w = np.empty(n, np.float32), np.empty(n, np.float32)
    shim.inboxes(ctypes.c_void_p(classes.ctypes.data), len(classes),
                 *(ctypes.c_void_p(a.ctypes.data) for a in (mark, s, w)), n,
                 ctypes.c_void_p(got_s.ctypes.data), ctypes.c_void_p(got_w.ctypes.data))
    want_s, want_w = np.zeros(n, np.float32), np.zeros(n, np.float32)
    j = np.arange(n)
    for k, d in enumerate(classes):
        i = (j - d) % n
        hit = mark[i] == k
        want_s = want_s + np.where(hit, s[i] * np.float32(0.5), np.float32(0.0))
        want_w = want_w + np.where(hit, w[i] * np.float32(0.5), np.float32(0.0))
    assert (got_s.view(np.int32) == want_s.view(np.int32)).all()
    assert (got_w.view(np.int32) == want_w.view(np.int32)).all()


def _counts(case):
    rng = np.random.default_rng(11)
    blocks, top = {"one block holds n_pad - 1": (1056, 2**31 - 1),
                   "full grid near 2**31": (1056, 2**31 - 1),
                   "grid2d 10,000": (40, 10_112),
                   "empty rounds": (132, 0)}[case]
    if case == "one block holds n_pad - 1":
        counts = np.zeros(blocks, np.int64)
        counts[500] = top
    elif top == 0:
        counts = np.zeros(blocks, np.int64)
    else:
        cuts = np.sort(rng.integers(0, top, blocks - 1))
        counts = np.diff(np.concatenate([[0], cuts, [top]]))
    return counts.astype(np.int32)


@pytest.mark.parametrize("case", ["one block holds n_pad - 1", "full grid near 2**31",
                                  "grid2d 10,000", "empty rounds"])
def test_barrier_word_carries_arrivals_and_the_exact_total(shim, case):
    counts = _counts(case)
    blocks = counts.size
    arrivals = np.empty(blocks, np.uint32)
    totals = np.empty(blocks, np.int32)
    shim.barrier_adds(ctypes.c_void_p(counts.ctypes.data), blocks,
                      ctypes.c_void_p(arrivals.ctypes.data), ctypes.c_void_p(totals.ctypes.data))
    # Every prefix: its arrivals and its exact partial sum; the grid's
    # barrier opens at the last arrival with the round's total.
    assert (arrivals == np.arange(1, blocks + 1)).all()
    assert (totals.astype(np.int64) == np.cumsum(counts.astype(np.int64))).all()
    assert (arrivals[:-1] < blocks).all() and arrivals[-1] == blocks


def _no_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU chunk reached the CUDA path")
    monkeypatch.setattr(fused_stencil_hbm, "dir_words", refuse)
    monkeypatch.setattr(kernels, "entry", refuse)
    monkeypatch.setattr(kernels, "load", refuse)


TIERS = [("stencil", "grid2d", 900), ("stencil2", "torus3d", 27_000),
         ("stencil_hbm", "torus3d", 27_000)]


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("tier,kind,n", TIERS)
def test_cpu_wrappers_never_build_the_word_or_launch(tier, kind, n, algorithm, monkeypatch):
    if tier == "stencil_hbm":
        # Reach the streaming tier at a small n, as its ladder tests do.
        monkeypatch.setattr(fused_stencil, "_VMEM_BUDGET", 1000)
        monkeypatch.setattr(fused, "MAX_FUSED_NODES", 1000)
    topo = build_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, engine="fused",
                    max_rounds=24, chunk_rounds=8)
    assert fused_tier(topo, cfg) == (tier, None)
    wrappers = {"stencil": (fused.pushsum_chunk, fused.gossip_chunk),
                "stencil2": (fused_stencil.pushsum_stencil2_chunk,
                             fused_stencil.gossip_stencil2_chunk),
                "stencil_hbm": (fused_stencil_hbm.pushsum_stencil_hbm_chunk,
                                fused_stencil_hbm.gossip_stencil_hbm_chunk)}[tier]
    counter = wrappers[0 if algorithm == "push-sum" else 1]
    eng = fused_engine(topo, cfg, (0, 0), tier)
    before = counter.launches
    _no_kernel(monkeypatch)
    out, executed = eng.chunk(eng.planes, eng.streams(0, 8), 0, 8)
    assert int(executed) == 8 and out[0].device.type == "cpu"
    res = run(topo, cfg, device="cpu")
    assert res.rounds == 24
    assert counter.launches == before
