"""The pool kernels' per-node code (cop5615_gossip_protocol_tpu_torch/csrc/
pool.cuh, which csrc/fused_pool.cu runs) built for the host with g++, and
their wrappers' launch count, on the CPU.

- Each node's round mark, as the kernels' mark loop writes it (the
  prologue's and a round's next marks: the packed choice word hashed from
  the round key, its nibble masked to the pool width), is the JAX
  package's draw ``sampling.pool_choice_packed`` for pool widths 2 to 16,
  with pad lanes (1000, 70,000) and without (65,536), over several round
  keys; pad lanes are -1, and so are inactive gossip nodes.
- The halve-on-read inbox is bitwise the plain version's slot sums (from
  0.0, slots ascending, each hit's halved send), on marks that hit, miss
  and are -1 and on values down to subnormals; the gossip inbox counts the
  same hits.
- The round loop's walk (a thread a packed word, its 8 nodes in turn)
  covers the layout once, a warp on 32 consecutive nodes a step, and the
  word a thread hashes is each of its nodes' word.
- A chunk is 3 launches whatever its rounds, and CPU tensors never reach a
  kernel: the wrappers and ``run()`` on the CPU run the plain versions.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng
from cop5615_gossip_protocol_tpu_torch.utils import kernels

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"
SEED = 3
ROUNDS = (0, 1, 7, 4097)

SHIM = r"""
#include "pool.cuh"
using namespace gossip;
// The kernels' mark loop (csrc/fused_pool.cu, the prologue and a round's
// next marks) over the padded layout; `active` null for push-sum.
extern "C" void marks(uint32_t k1, uint32_t k2, int n, int n_pad, int pool_size,
                      const int* active, int8_t* out) {
  for (int j = 0; j < n_pad; ++j)
    out[j] = active == nullptr || active[j] != 0
                 ? pool_mark(pool_word(k1, k2, j), j, n, pool_size)
                 : (int8_t)-1;
}
// Both inboxes of every receiver j < n at pool width P.
template <int P>
void inboxes_of(const int* offs, const int8_t* mark, const float* s,
                const float* w, int n, float* in_s, float* in_w, int* receipts) {
  for (int j = 0; j < n; ++j) {
    pool_pushsum_inbox<P>(offs, mark, s, w, j, n, in_s[j], in_w[j]);
    receipts[j] = pool_gossip_inbox<P>(offs, mark, j, n);
  }
}
extern "C" void inboxes(const int* offs, int pool_size, const int8_t* mark,
                        const float* s, const float* w, int n, float* in_s,
                        float* in_w, int* receipts) {
  switch (pool_size) {
    case 2: return inboxes_of<2>(offs, mark, s, w, n, in_s, in_w, receipts);
    case 4: return inboxes_of<4>(offs, mark, s, w, n, in_s, in_w, receipts);
    case 8: return inboxes_of<8>(offs, mark, s, w, n, in_s, in_w, receipts);
    default: return inboxes_of<16>(offs, mark, s, w, n, in_s, in_w, receipts);
  }
}
// The kernels' round loop: node word_node(wi, sub) of each packed word wi
// and the counter of the word its thread hashes (its sub-row 0 node's).
extern "C" void walk(int n_pad, int* node, uint32_t* counter) {
  for (int wi = 0; wi < n_pad / 8; ++wi)
    for (int sub = 0; sub < 8; ++sub) {
      node[wi * 8 + sub] = word_node(wi, sub);
      counter[wi * 8 + sub] = choice_counter(word_node(wi, 0));
    }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pool_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    u32, P, I = ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int
    so.marks.argtypes = [u32, u32, I, I, I, P, P]
    so.inboxes.argtypes = [P, I, P, P, P, I, P, P, P]
    so.walk.argtypes = [I, P, P]
    return so


def _ptr(a):
    return None if a is None else ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("n", [1000, 65_536, 70_000])
@pytest.mark.parametrize("pool_size", [2, 4, 8, 16])
def test_marks_are_the_jax_pool_draw(shim, pool_size, n):
    n_pad = fused_pool.build_pool_layout(n).n_pad
    active = np.ascontiguousarray(np.random.default_rng(n).random(n_pad) < 0.5,
                                  dtype=np.int32)
    base = jax.random.PRNGKey(SEED)
    for r in ROUNDS:
        kr = jax_sampling.round_key(base, r)
        want = np.asarray(jax_sampling.pool_choice_packed(kr, n, pool_size))
        k1, k2 = (int(v) for v in np.asarray(kr))
        # The port's own round key stream gives the kernels the same words.
        assert fused.round_keys(rng.PRNGKey(SEED), r, 1)[0].tolist() == [k1, k2]
        for act in (None, active):
            got = np.empty(n_pad, dtype=np.int8)
            shim.marks(k1, k2, n, n_pad, pool_size, _ptr(act), _ptr(got))
            sends = np.ones(n, bool) if act is None else act[:n] != 0
            assert (got[:n] == np.where(sends, want, -1)).all()
            assert (got[n:] == -1).all()
        assert len(np.unique(want)) == pool_size


@pytest.mark.parametrize("n,pool_size", [(1000, 2), (70_000, 4), (1000, 8), (65_536, 16)])
def test_inbox_is_the_plain_slot_sum(shim, n, pool_size):
    layout = fused_pool.build_pool_layout(n)
    keys = fused.round_keys(rng.PRNGKey(SEED), 5, 1)
    offs = fused_pool.round_offsets(rng.PRNGKey(SEED), 5, 1, pool_size, n)
    # The plain version's marks and slot sources for the round, with
    # senders knocked out (-1) as inactive gossip nodes are.
    mark, classes = fused_pool._pool_classes(keys, offs, layout.rows, n)(0)
    gen = np.random.default_rng(n)
    mark = torch.where(torch.from_numpy(gen.random(layout.n_pad) < 0.2), -1, mark)
    s = (gen.random(layout.n_pad) * 10.0 ** gen.integers(-44, 6, layout.n_pad)
         ).astype(np.float32)
    w = (gen.random(layout.n_pad) * 10.0 ** gen.integers(-44, 2, layout.n_pad)
         ).astype(np.float32)
    # fused.pushsum_class_rounds' sums: the halved sends, from 0.0, slots
    # ascending; and gossip's receipt count.
    ts, tw = torch.from_numpy(s) * 0.5, torch.from_numpy(w) * 0.5
    zero = torch.zeros((), dtype=torch.float32)
    want_s, want_w = torch.zeros(layout.n_pad), torch.zeros(layout.n_pad)
    want_r = torch.zeros(layout.n_pad, dtype=torch.int32)
    for cid, src in classes:
        hit = mark[src] == cid
        want_s = want_s + torch.where(hit, ts[src], zero)
        want_w = want_w + torch.where(hit, tw[src], zero)
        want_r = want_r + hit.to(torch.int32)
    m8 = np.ascontiguousarray(mark.numpy().astype(np.int8))
    got_s, got_w = np.empty(n, np.float32), np.empty(n, np.float32)
    got_r = np.empty(n, np.int32)
    o = np.ascontiguousarray(offs[0].numpy())
    shim.inboxes(_ptr(o), pool_size, _ptr(m8), _ptr(s), _ptr(w), n, _ptr(got_s),
                 _ptr(got_w), _ptr(got_r))
    assert (got_s.view(np.int32) == want_s[:n].numpy().view(np.int32)).all()
    assert (got_w.view(np.int32) == want_w[:n].numpy().view(np.int32)).all()
    assert (got_r == want_r[:n].numpy()).all()
    assert 0 < (got_r > 0).mean() < 1


@pytest.mark.parametrize("n", [1000, 70_000])
def test_the_walk_covers_every_node_once_with_its_word(shim, n):
    """The round loop's walk (a thread a packed word, its 8 nodes in turn)
    visits every slot of the layout once; at each step a warp's 32 threads
    (32 consecutive words) are on 32 consecutive nodes; and the word a
    thread hashes once is the packed word of each of its 8 nodes."""
    n_pad = fused_pool.build_pool_layout(n).n_pad
    node = np.empty(n_pad, np.int32)
    counter = np.empty(n_pad, np.uint32)
    shim.walk(n_pad, _ptr(node), _ptr(counter))
    assert (np.sort(node) == np.arange(n_pad)).all()
    steps = node.reshape(-1, 32, 8).transpose(0, 2, 1)
    assert (np.diff(steps, axis=2) == 1).all()
    j = node.astype(np.int64)
    assert (counter == (j // 1024) * 128 + j % 128).all()


@pytest.mark.parametrize("rounds", [0, 1, 2, 4096])
def test_a_chunk_is_three_launches(rounds):
    assert fused_pool.chunk_launches(rounds) == 3


def _refuse(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a CUDA kernel")


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_cpu_tensors_never_reach_a_kernel(algorithm, monkeypatch):
    monkeypatch.setattr(kernels, "entry", _refuse)
    monkeypatch.setattr(kernels, "load", _refuse)
    before = (fused_pool.pushsum_pool_chunk.launches, fused_pool.gossip_pool_chunk.launches)
    n = 1000
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2,
                    max_rounds=64)
    res = run(build_topology("full", n), cfg, device="cpu")
    assert res.rounds > 0
    layout = fused_pool.build_pool_layout(n)
    keys = fused.round_keys(rng.PRNGKey(0), 0, 4)
    offs = fused_pool.round_offsets(rng.PRNGKey(0), 0, 4, 2, n)
    if algorithm == "push-sum":
        planes = (torch.zeros(layout.rows, 128), torch.ones(layout.rows, 128),
                  torch.zeros(layout.rows, 128, dtype=torch.int32),
                  torch.zeros(layout.rows, 128, dtype=torch.int32))
        _, ex = fused_pool.pushsum_pool_chunk(planes, keys, offs, 0, 4, n=n, target=n,
                                              delta=1e-10, term_rounds=3)
    else:
        planes = tuple(torch.zeros(layout.rows, 128, dtype=torch.int32) for _ in range(3))
        planes[1][0, 0] = 1
        _, ex = fused_pool.gossip_pool_chunk(planes, keys, offs, 0, 4, n=n, target=n,
                                             rumor_target=10, suppress=False)
    assert int(ex) == 4
    assert (fused_pool.pushsum_pool_chunk.launches,
            fused_pool.gossip_pool_chunk.launches) == before
