"""The reference-semantics push-sum walk in the port (models/reference.py,
its kernel logic csrc/walk.cuh, models/runner.run's dispatch) against the
JAX package's models/reference.py on the CPU, float32:

- whole walks at n = 20, 100 and 1000 on full, 100 on line and ref2d and
  1000 on imp3d (with its orphans): hops, the dead latch, every plane (s,
  w, term, conv) and the in-flight message equal JAX's run_walk, bitwise;
- a max_rounds cap mid-walk, and the walk resumed from the capped carry;
- the Q8 orphan case and the Q5 converged relay;
- one hop of the kernel's walker (csrc/walk.cuh walk_block over the
  kernel's node records and staged rows, built with g++) against the JAX
  step function, from mid-walk carries, a converged node and an orphan;
- the run record: rounds (hops), converged count and estimate_mae equal
  the JAX runner's.
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
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops.topology import Topology as JaxTopology

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import reference, runner
from cop5615_gossip_protocol_tpu_torch.ops import rng, scatter
from cop5615_gossip_protocol_tpu_torch.ops.topology import Topology

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_carry(got, want):
    for name in reference.WalkCarry._fields:
        a, b = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        assert (_bits(a) == _bits(b.astype(a.dtype))).all(), name


def _both(kind, n, seed=0, **kw):
    jcfg = JaxConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference",
                     seed=seed, **kw)
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference",
                    seed=seed, **kw)
    return (jax_build(kind, n, semantics="reference"), jcfg,
            build_topology(kind, n, semantics="reference"), cfg)


WALKS = [("full", 20), ("full", 100), ("full", 1000), ("line", 100), ("ref2d", 100),
         ("imp3d", 1000)]


@pytest.mark.parametrize("kind,n", WALKS)
def test_walk_matches_jax_run_walk(kind, n):
    jtopo, jcfg, topo, cfg = _both(kind, n)
    jkey, key = jax.random.PRNGKey(0), rng.PRNGKey(0)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    leader = runner.draw_leader(key, topo, cfg)
    assert leader == int(jax_runner.draw_leader(jkey, jtopo, jcfg))
    want, _, _ = jax_reference.run_walk(jtopo, jcfg, jkey, jnp.int32(leader), target)
    got, _, _ = reference.run_walk(topo, cfg, key, leader, target, "cpu")
    _assert_same_carry(got, want)
    assert int(got.steps) > 1


@pytest.mark.parametrize("kind,n", [("full", 1000), ("imp3d", 1000)])
def test_walk_capped_and_resumed(kind, n):
    jtopo, jcfg, topo, cfg = _both(kind, n, max_rounds=777)
    key = rng.PRNGKey(0)
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    leader = runner.draw_leader(key, topo, cfg)
    want, _, _ = jax_reference.run_walk(jtopo, jcfg, jax.random.PRNGKey(0),
                                        jnp.int32(leader), target)
    got, _, _ = reference.run_walk(topo, cfg, key, leader, target, "cpu")
    _assert_same_carry(got, want)
    assert int(got.steps) == 777
    # The same walk in two calls of the wrapper: 300 hops, then the rest.
    graph = scatter.scatter_graph(topo, "cpu")
    kw = {"max_steps": 777, "target": target, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}
    c0 = reference.make_walk(topo, cfg, key, leader)
    mid, status = reference.walk_hops(c0, key, graph, hops=300, **kw)
    assert status.tolist() == [301, int(mid.conv.sum()), 0]
    end, status = reference.walk_hops(mid, key, graph, hops=10_000, **kw)
    _assert_same_carry(end, want)
    assert status.tolist() == [777, int(end.conv.sum()), 0]


def test_walk_dies_on_orphan_q8():
    # The JAX package's own case: node 2 is an orphan; a walk forced onto
    # it dies, and a walk that never reaches it goes on.
    neighbors = np.array([[1], [0], [0]], dtype=np.int32)
    degree = np.array([1, 1, 0], dtype=np.int32)
    jtopo = JaxTopology("line", 3, 3, 3, 1, neighbors, degree)
    topo = Topology("line", 3, 3, 3, 1, neighbors, degree)
    jcfg = JaxConfig(n=3, topology="line", algorithm="push-sum", semantics="reference")
    cfg = SimConfig(n=3, topology="line", algorithm="push-sum", semantics="reference")
    jkey, key = jax.random.PRNGKey(0), rng.PRNGKey(0)
    step_fn, jc, kd, targs = jax_reference.make_walk(jtopo, jcfg, jkey, jnp.int32(0))
    c0 = reference.make_walk(topo, cfg, key, 0)
    _assert_same_carry(c0, jc)
    want = step_fn(jc._replace(cur=jnp.int32(2)), kd, *targs)
    graph = scatter.scatter_graph(topo, "cpu")
    got, status = reference.walk_hops(c0._replace(cur=torch.tensor(2, dtype=torch.int32)),
                                      key, graph, hops=5, max_steps=100, target=3,
                                      delta=cfg.resolved_delta, term_rounds=3)
    assert bool(want.dead) and bool(got.dead) and status.tolist()[2] == 1
    _assert_same_carry(got, want)  # one hop, then frozen
    # A dead carry takes no hop.
    again, _ = reference.walk_hops(got, key, graph, hops=5, max_steps=100, target=3,
                                   delta=cfg.resolved_delta, term_rounds=3)
    _assert_same_carry(again, want)


def test_walk_relays_at_a_converged_node_q5():
    jtopo, jcfg, topo, cfg = _both("full", 10)
    key = rng.PRNGKey(2)
    leader = runner.draw_leader(key, topo, cfg)
    step_fn, jc, kd, targs = jax_reference.make_walk(jtopo, jcfg, jax.random.PRNGKey(2),
                                                     jnp.int32(leader))
    cur = int(jc.cur)
    want = step_fn(jc._replace(conv=jc.conv.at[cur].set(True)), kd, *targs)
    c0 = reference.make_walk(topo, cfg, key, leader)
    conv = c0.conv.clone()
    conv[cur] = True
    got, _ = reference.walk_hops(c0._replace(conv=conv), key,
                                 scatter.scatter_graph(topo, "cpu"), hops=1,
                                 max_steps=100, target=topo.target_count,
                                 delta=cfg.resolved_delta, term_rounds=3)
    _assert_same_carry(got, want)
    assert float(got.msg_s) == float(c0.msg_s) and float(got.s[cur]) == float(c0.s[cur])


# ---------------------------------------------------------------------------
# csrc/walk.cuh on the host
# ---------------------------------------------------------------------------

SHIM = r"""
#include <stdlib.h>
#include "walk.cuh"
using namespace gossip::walk;
// One hop of the kernel's walker on the host: the planes packed into its
// 16-byte node records and, on an explicit topology, the rows staged as
// csrc/walk.cu stages them; the hop's entry prepared as the kernel's
// drawing threads prepare it (the shift on full, else the raw word); scal
// as walk.cu keeps it.
extern "C" void one_hop(float* s, float* w, int* term, unsigned char* conv,
                        const int* nbr, const int* deg, int max_deg, int n,
                        int* scal, float* msg, uint32_t k1, uint32_t k2,
                        float delta, int term_rounds) {
  Carry c{scal[0], scal[1], scal[2], scal[3], msg[0], msg[1]};
  const uint32_t word = hop_word(k1, k2, (uint32_t)c.steps);
  Node* nodes = (Node*)aligned_alloc(16, sizeof(Node) * (size_t)n);
  for (int i = 0; i < n; ++i) nodes[i] = make_node(s[i], w[i], term[i], conv[i]);
  if (nbr == nullptr) {
    const uint32_t shift = full_shift(word, n);
    walk_block(c, Records{nodes}, &shift, 1, FullPick{n}, 0x7fffffff, 0x7fffffff,
               delta, term_rounds);
  } else {
    int* rows = (int*)malloc(sizeof(int) * (size_t)n * row_stride(max_deg));
    for (int i = 0; i < n; ++i) stage_row(rows, i, nbr, deg, max_deg);
    walk_block(c, Records{nodes}, &word, 1, RowPick{rows, row_stride(max_deg), n},
               0x7fffffff, 0x7fffffff, delta, term_rounds);
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
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("walk_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _p(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("kind,n", [("full", 100), ("line", 100), ("imp3d", 1000)])
def test_kernel_hop_matches_jax_step(shim, kind, n):
    jtopo, jcfg, topo, cfg = _both(kind, n)
    seed = 3
    jkey, key = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    leader = runner.draw_leader(key, topo, cfg)
    step_fn, carry, kd, targs = jax_reference.make_walk(jtopo, jcfg, jkey,
                                                        jnp.int32(leader))
    nbr = None if topo.implicit else np.ascontiguousarray(topo.neighbors, np.int32)
    deg = None if topo.implicit else np.ascontiguousarray(topo.degree, np.int32)
    hops = 0
    for _ in range(400):
        if bool(carry.dead):
            break
        want = step_fn(carry, kd, *targs)
        s, w = np.array(carry.s, np.float32), np.array(carry.w, np.float32)
        term = np.array(carry.term, np.int32)
        conv = np.array(carry.conv, np.uint8)
        scal = np.array([int(carry.cur), int(carry.steps), int(carry.dead),
                         int(conv.sum()), 0], np.int32)
        msg = np.array([carry.msg_s, carry.msg_w], np.float32)
        shim.one_hop(_p(s), _p(w), _p(term), _p(conv), _p(nbr), _p(deg),
                     0 if nbr is None else nbr.shape[1], topo.n, _p(scal), _p(msg),
                     ctypes.c_uint32(int(key[0])), ctypes.c_uint32(int(key[1])),
                     ctypes.c_float(cfg.resolved_delta), cfg.term_rounds)
        for a, b in ((s, want.s), (w, want.w), (term, want.term),
                     (conv.astype(bool), want.conv)):
            assert (_bits(a) == _bits(np.asarray(b))).all()
        assert scal[:3].tolist() == [int(want.cur), int(want.steps), int(want.dead)]
        assert scal[3] == int(np.asarray(want.conv).sum())
        assert (_bits(msg) == _bits(np.array([want.msg_s, want.msg_w], np.float32))).all()
        carry, hops = want, hops + 1
    assert hops > 0


# ---------------------------------------------------------------------------
# The run record
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,seed", [("full", 100, 0), ("full", 1000, 1),
                                         ("line", 100, 0), ("imp3d", 1000, 0)])
def test_run_record_matches_jax_runner(kind, n, seed):
    jtopo, jcfg, topo, cfg = _both(kind, n, seed=seed)
    jres = jax_runner.run(jtopo, jcfg)
    res = run(topo, cfg, device="cpu")
    assert (res.rounds, res.converged, res.converged_count, res.population,
            res.target_count, res.outcome) == (
        jres.rounds, jres.converged, jres.converged_count, jres.population,
        jres.target_count, jres.outcome)
    assert res.estimate_mae == jres.estimate_mae
    assert res.true_mean == jres.true_mean
