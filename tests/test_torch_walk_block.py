"""The walker of the walk kernel (csrc/walk.cuh walk_block, built with g++)
against the JAX package's models/reference.py on the CPU, float32:

- whole walks driven as csrc/walk.cu drives them: launches of up to
  ``hops`` hops, each a loop over ring halves of RING hops indexed by the
  absolute hop count, the walker given one half's prepared entries (the
  shift on full, the raw word elsewhere) and stopping exactly where the
  walk stops. Full 100 and 1000, line 100, ref2d 100 and imp3d 1000, with
  the stop by the converged target, by max_steps, by death (Q8) and by the
  launch's hops, mid-half; every plane, the message, hops and the dead
  latch equal JAX's run_walk, bitwise;
- a self-loop, where the next node's planes read ahead must take the
  hop's own writes;
- masses near the subnormals, where a node's kept ratio must be that of
  its halves (against the port's plain walk: JAX's step on the CPU
  flushes subnormals to zero, and walks the flushed carry bitwise);
- the full pick's compare-and-subtract against the plain pick;
- the fastmod of the staged rows against ``%``, for every degree the
  topologies have.
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

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.models import reference as jax_reference
from cop5615_gossip_protocol_tpu.ops.topology import Topology as JaxTopology

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.models import reference, runner
from cop5615_gossip_protocol_tpu_torch.ops import rng
from cop5615_gossip_protocol_tpu_torch.ops.scatter import scatter_graph
from cop5615_gossip_protocol_tpu_torch.ops.topology import Topology

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"
# Hops a half of csrc/walk.cu's ring holds (kRing).
RING = 1024

SHIM = r"""
#include <stdlib.h>
#include "walk.cuh"
using namespace gossip::walk;
// walk_block over host arrays as the kernel lays them out: the planes
// packed into 16-byte node records (s, w, s / w, term * 2 + conv), each
// unpacked after; on full (nbr null) the entries are
// shifts, else raw words over rows staged as the kernel stages them.
extern "C" void block(float* s, float* w, int* term, unsigned char* conv,
                      const int* nbr, const int* deg, int max_deg, int n,
                      int* scal, float* msg, const uint32_t* entries, int count,
                      int max_steps, int target, float delta, int term_rounds) {
  Carry c{scal[0], scal[1], scal[2], scal[3], msg[0], msg[1]};
  Node* nodes = (Node*)aligned_alloc(16, sizeof(Node) * (size_t)n);
  for (int i = 0; i < n; ++i) nodes[i] = make_node(s[i], w[i], term[i], conv[i]);
  if (nbr == nullptr) {
    walk_block(c, Records{nodes}, entries, count, FullPick{n}, max_steps, target,
               delta, term_rounds);
  } else {
    int* rows = (int*)malloc(sizeof(int) * (size_t)n * row_stride(max_deg));
    for (int i = 0; i < n; ++i) stage_row(rows, i, nbr, deg, max_deg);
    walk_block(c, Records{nodes}, entries, count, RowPick{rows, row_stride(max_deg), n},
               max_steps, target, delta, term_rounds);
    free(rows);
  }
  for (int i = 0; i < n; ++i) {
    s[i] = nodes[i].s; w[i] = nodes[i].w; term[i] = nodes[i].tc >> 1;
    conv[i] = (unsigned char)(nodes[i].tc & 1);
  }
  free(nodes);
  scal[0] = c.cur; scal[1] = c.steps; scal[2] = c.dead; scal[3] = c.conv_count;
  msg[0] = c.msg_s; msg[1] = c.msg_w;
}
extern "C" void shifts(const uint32_t* words, int m, int n, uint32_t* out) {
  for (int i = 0; i < m; ++i) out[i] = full_shift(words[i], n);
}
extern "C" int full_next(uint32_t shift, int node, int n) {
  bool ok;
  return FullPick{n}.next(shift, node, ok);
}
extern "C" uint64_t mod_constant(uint32_t d) { return fastmod_constant(d); }
extern "C" void mods(const uint32_t* words, int m, uint32_t d, uint32_t* out) {
  const uint64_t c = fastmod_constant(d);
  for (int i = 0; i < m; ++i) out[i] = fastmod(words[i], c, d);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("walk_block_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(lib))
    lib.full_next.restype = ctypes.c_int
    lib.mod_constant.restype = ctypes.c_uint64
    return lib


def _p(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_carry(got, want):
    for name in reference.WalkCarry._fields:
        a, b = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        assert (_bits(a) == _bits(b.astype(a.dtype))).all(), name


def kernel_walk(shim, carry, key, topo, *, hops, max_steps, target, delta,
                term_rounds):
    """One launch of csrc/walk.cu on the host: from ``carry`` up to ``hops``
    hops, ring half by ring half, the walker's stop as the kernel takes it.
    Returns the carry after it."""
    n = topo.n
    s, w = carry.s.numpy().copy(), carry.w.numpy().copy()
    term = carry.term.numpy().copy()
    conv = carry.conv.numpy().astype(np.uint8)
    nbr = None if topo.implicit else np.ascontiguousarray(topo.neighbors, np.int32)
    deg = None if topo.implicit else np.ascontiguousarray(topo.degree, np.int32)
    scal = np.array([int(carry.cur), int(carry.steps), int(carry.dead),
                     int(conv.sum())], np.int32)
    msg = np.array([carry.msg_s, carry.msg_w], np.float32)
    end = int(scal[1]) + hops
    k = int(scal[1]) // RING
    while True:
        entries = np.ascontiguousarray(reference.hop_words(key, k * RING, RING), np.uint32)
        if nbr is None:
            out = np.empty(RING, np.uint32)
            shim.shifts(_p(entries), RING, n, _p(out))
            entries = out
        steps = int(scal[1])
        at = entries[steps - k * RING:]
        shim.block(_p(s), _p(w), _p(term), _p(conv), _p(nbr), _p(deg),
                   0 if nbr is None else nbr.shape[1], n, _p(scal), _p(msg), _p(at),
                   min((k + 1) * RING, end) - steps, max_steps, target,
                   ctypes.c_float(delta), term_rounds)
        walking = not scal[2] and scal[1] < max_steps and scal[3] < target
        if not walking or scal[1] >= end:
            break
        k += 1
    return reference.WalkCarry(
        s=torch.from_numpy(s), w=torch.from_numpy(w), term=torch.from_numpy(term),
        conv=torch.from_numpy(conv.astype(bool)),
        cur=torch.tensor(int(scal[0]), dtype=torch.int32),
        msg_s=torch.tensor(msg[0]), msg_w=torch.tensor(msg[1]),
        steps=torch.tensor(int(scal[1]), dtype=torch.int32),
        dead=torch.tensor(bool(scal[2])))


def _walk(shim, topo, cfg, key, leader, target, launch_hops):
    """The walk to its end in launches of ``launch_hops`` hops, as
    models/reference.run_walk drives the kernel."""
    carry = reference.make_walk(topo, cfg, key, leader)
    kw = {"max_steps": cfg.max_rounds, "target": target, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}
    launches = 0
    while True:
        carry = kernel_walk(shim, carry, key, topo, hops=launch_hops, **kw)
        launches += 1
        if (bool(carry.dead) or int(carry.steps) >= cfg.max_rounds
                or int(carry.conv.sum()) >= target):
            return carry, launches


def _configs(kind, n, **kw):
    jcfg = JaxConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference", **kw)
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference", **kw)
    return jcfg, cfg


# (kind, n, max_rounds or None, hops a launch): the stop by the converged
# target (full, ref2d, line, imp3d), by max_steps inside a ring half (4,099
# and 777), and launches that end inside a half, resumed there.
WALKS = [("full", 100, None, reference.LAUNCH_HOPS),
         ("full", 1000, None, reference.LAUNCH_HOPS),
         ("full", 1000, 4099, reference.LAUNCH_HOPS),
         ("full", 1000, None, 1000),
         ("line", 100, None, reference.LAUNCH_HOPS),
         ("ref2d", 100, None, 777),
         ("imp3d", 1000, None, reference.LAUNCH_HOPS),
         ("imp3d", 1000, 777, 300)]


@pytest.mark.parametrize("kind,n,max_rounds,launch_hops", WALKS)
def test_walk_block_matches_jax_run_walk(shim, kind, n, max_rounds, launch_hops):
    kw = {} if max_rounds is None else {"max_rounds": max_rounds}
    jcfg, cfg = _configs(kind, n, **kw)
    jtopo = jax_build(kind, n, semantics="reference")
    topo = build_topology(kind, n, semantics="reference")
    key = rng.PRNGKey(0)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    leader = runner.draw_leader(key, topo, cfg)
    want, _, _ = jax_reference.run_walk(jtopo, jcfg, jax.random.PRNGKey(0),
                                        jnp.int32(leader), target)
    got, launches = _walk(shim, topo, cfg, key, leader, target, launch_hops)
    _assert_same_carry(got, want)
    hops = int(got.steps)
    assert hops % RING != 0  # the stop falls inside a ring half
    if max_rounds is not None:
        assert hops == max_rounds
    assert launches == -(-(hops - 1) // launch_hops)


def _custom(neighbors, degree):
    n, max_deg = neighbors.shape
    args = ("line", n, n, n, max_deg, np.ascontiguousarray(neighbors, np.int32),
            np.ascontiguousarray(degree, np.int32))
    return JaxTopology(*args), Topology(*args)


def _custom_walk(shim, neighbors, degree, leader, launch_hops):
    jtopo, topo = _custom(neighbors, degree)
    jcfg, cfg = _configs("line", topo.n)
    key = rng.PRNGKey(0)
    target = topo.n
    want, _, _ = jax_reference.run_walk(jtopo, jcfg, jax.random.PRNGKey(0),
                                        jnp.int32(leader), target)
    got, _ = _walk(shim, topo, cfg, key, leader, target, launch_hops)
    _assert_same_carry(got, want)
    return got


def test_walk_block_dies_mid_half_q8(shim):
    # A ring of 64 nodes; node 10 also links to node 64, an orphan, so the
    # walk wanders until it steps onto it and dies (its pick: padded
    # column 0).
    n = 65
    neighbors = np.zeros((n, 3), np.int32)
    degree = np.full(n, 2, np.int32)
    for i in range(64):
        neighbors[i, :2] = ((i - 1) % 64, (i + 1) % 64)
    neighbors[10, 2] = 64
    degree[10] = 3
    degree[64] = 0
    got = _custom_walk(shim, neighbors, degree, 0, 500)
    assert bool(got.dead) and int(got.steps) % RING != 0 and int(got.steps) > 2


def test_walk_block_self_loop_reads_its_own_write(shim):
    # Every node links to itself and its two ring neighbours: a third of the
    # hops come back to the node just written, which the walker's read
    # ahead must take from the hop's own values.
    n = 50
    neighbors = np.array([[i, (i - 1) % n, (i + 1) % n] for i in range(n)], np.int32)
    got = _custom_walk(shim, neighbors, np.full(n, 3, np.int32), 7, reference.LAUNCH_HOPS)
    assert int(got.steps) > RING


@pytest.mark.parametrize("n", [2, 3, 1001, 2**20 + 1])
def test_full_pick_is_the_plain_pick(shim, n):
    words = np.array(sorted({0, 1, n - 2, n - 1, 2**32 - 1}), np.uint32)
    shift = np.empty_like(words)
    shim.shifts(_p(words), len(words), n, _p(shift))
    for word, sh in zip(words.tolist(), shift.tolist()):
        assert 1 <= sh <= n - 1
        for node in sorted({0, 1, n // 2, n - 2, n - 1}):
            want, ok = reference._pick(word, node, None, None, n)
            assert ok and shim.full_next(sh, node, n) == want


def _degrees():
    """Every degree of the topologies the walk tests run, and 1..16."""
    out = set(range(1, 17))
    for kind, n in (("line", 100), ("ref2d", 100), ("imp3d", 1000), ("line", 1000)):
        out |= set(build_topology(kind, n, semantics="reference").degree.tolist())
    return sorted(d for d in out if d > 0)


@pytest.mark.parametrize("d", _degrees())
def test_fastmod_is_the_remainder(shim, d):
    # Lemire et al.'s condition for an exact remainder of every 32-bit word:
    # 2**64 <= M * d <= 2**64 + 2**32 (M = 0 stands for 2**64 at d = 1).
    m = shim.mod_constant(d) or 2**64
    assert 2**64 <= m * d <= 2**64 + 2**32
    r = np.random.default_rng(d)
    edge = {0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1}
    edge |= {q * d + e for q in ((2**32 - 1) // d, (2**32 - 1) // d - 1) for e in (-1, 0, 1)}
    words = np.concatenate([np.array(sorted(x for x in edge if 0 <= x < 2**32), np.uint32),
                            r.integers(0, 2**32, 10**5, dtype=np.uint64).astype(np.uint32)])
    got = np.empty_like(words)
    shim.mods(_p(words), len(words), d, _p(got))
    assert (got == words % np.uint32(d)).all()


def _subnormal_pair():
    """Two nodes that pass the message back and forth, with masses near the
    float32 subnormals (seed 14 of k * 2**-149): the 2-node topology in
    both packages and the carry at hop 1, as numpy arrays."""
    jtopo, topo = _custom(np.array([[1], [0]], np.int32), np.array([1, 1], np.int32))
    r = np.random.default_rng(14)
    s = (r.integers(1, 2**24, 2) * 2.0**-149).astype(np.float32)
    w = np.array([r.choice([2.0, 3.0, 5.0]), r.choice([1.0, 3.0, 7.0])], np.float32)
    msg_s = np.float32(r.integers(1, 2**24) * 2.0**-149)
    msg_w = np.float32(r.choice([1.0, 3.0]))
    return jtopo, topo, s, w, msg_s, msg_w


def _pair_carry(s, w, msg_s, msg_w):
    return reference.WalkCarry(
        s=torch.from_numpy(s), w=torch.from_numpy(w), term=torch.zeros(2, dtype=torch.int32),
        conv=torch.zeros(2, dtype=torch.bool), cur=torch.tensor(0, dtype=torch.int32),
        msg_s=torch.tensor(msg_s), msg_w=torch.tensor(msg_w),
        steps=torch.tensor(1, dtype=torch.int32), dead=torch.tensor(False))


# The subnormal walks' settings: 22 hops from hop 1, a target never met.
PAIR = {"max_steps": 23, "target": 3, "delta": 1e-45, "term_rounds": 3}


def test_walk_block_keeps_the_ratio_of_subnormal_halves(shim):
    # Halving a sum near the subnormals can lose its last bits: the ratio a
    # record keeps must then be that of the halves, as the plain walk
    # divides them on the next visit. A ratio kept from the sums, not the
    # halves, would leave termRound 0 where the plain walk has 1.
    _, topo, s, w, msg_s, msg_w = _subnormal_pair()
    carry = _pair_carry(s, w, msg_s, msg_w)
    key = rng.PRNGKey(0)
    want, _ = reference.walk_hops_plain(carry, key, scatter_graph(topo, "cpu"), hops=100,
                                        **PAIR)
    got = kernel_walk(shim, carry, key, topo, hops=100, **PAIR)
    _assert_same_carry(got, want)
    assert int(got.steps) == 23 and want.term.tolist() == [0, 1]


def test_jax_step_flushes_subnormals(shim):
    # XLA on the CPU flushes float32 subnormals to zero, in its inputs and
    # its results; the port keeps them (IEEE, as numpy and the kernel built
    # without -ftz). So on the pair above JAX's step walks the carry with
    # every subnormal flushed: bitwise the walker from that carry, and not
    # the walker from the carry as given.
    jtopo, topo, s, w, msg_s, msg_w = _subnormal_pair()
    jcfg, _ = _configs("line", 2, delta=PAIR["delta"], term_rounds=PAIR["term_rounds"])
    step_fn, jc, kd, targs = jax_reference.make_walk(jtopo, jcfg, jax.random.PRNGKey(0),
                                                     jnp.int32(0))
    jc = jc._replace(s=jnp.asarray(s), w=jnp.asarray(w), term=jnp.zeros(2, jnp.int32),
                     conv=jnp.zeros(2, bool), cur=jnp.int32(0), msg_s=jnp.float32(msg_s),
                     msg_w=jnp.float32(msg_w), steps=jnp.int32(1), dead=jnp.bool_(False))
    step = jax.jit(step_fn)
    for _ in range(PAIR["max_steps"] - 1):
        jc = step(jc, kd, *targs)
    key = rng.PRNGKey(0)
    flushed = _pair_carry(np.zeros_like(s), w, np.float32(0), msg_w)
    _assert_same_carry(kernel_walk(shim, flushed, key, topo, hops=100, **PAIR), jc)
    ieee = kernel_walk(shim, _pair_carry(s, w, msg_s, msg_w), key, topo, hops=100, **PAIR)
    assert (_bits(ieee.s.numpy()) != _bits(np.asarray(jc.s))).any()


def test_chain_probes_refuse_the_cpu():
    # The hop chain's probes time the card: on the CPU they raise.
    with pytest.raises(ValueError, match="cuda"):
        reference.arith_chain(8, 1000, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        reference.chase(torch.zeros(4, dtype=torch.int32), 8)
