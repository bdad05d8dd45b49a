"""The streaming pool tier's failure model on the CPU, where its wrappers
run their plain versions (ops/fused_pool2.py, which the kernels of
csrc/fused_pool2.cu are held against on the card): the drop gate,
crash-stop with quorum termination and push-sum's global termination,
against the JAX package:

- single chunks: one chunk of the JAX pool2 kernels in Pallas interpret
  mode (make_pushsum_pool2_chunk, make_gossip_pool2_chunk) against the
  port's wrapper on the same start state, every plane and the executed
  count bitwise, at n = 1000, 65,536 (no pad lanes) and 70,000 (two tiles
  of the JAX kernel), across death rounds and with caps after odd and even
  rounds; a chunk from the verdict runs 0 rounds;
- whole runs: ``run(engine="fused", device="cpu")`` on the tier (reached at
  small n by shrinking ``fused_pool.MAX_POOL_NODES`` to 1000 in both
  packages) against the JAX chunked engine: rounds, converged count,
  outcome, estimate and every plane bitwise;
- the kernels' per-node helpers (csrc/pool2.cuh, csrc/faults.cuh: the send
  flag, the send bits' byte plane, a column's masked choices, the frozen
  packed plane) built with g++ against the plain code.
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
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import gossip as jax_gossip
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import fused_pool2 as jax_fused_pool2

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, fused_pool2, rng
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEED = 7
K = 6
CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"


def _jax_run(algorithm, n, **kw):
    final = {}
    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, delivery="pool",
                    pool_size=2, seed=SEED, engine="chunked", **kw)
    res = jax_runner.run(jax_topology("full", n), cfg,
                         on_chunk=lambda r, s: final.__setitem__("s", s))
    return res, final["s"]


def _start_state(algorithm, n, knobs, start):
    """(canonical JAX state, its round): the initial state at 0, the
    chunked engine's at ``start``, or at its verdict for start None."""
    if start == 0:
        if algorithm == "push-sum":
            return jax_pushsum.init_state(n, jnp.float32, 0), 0
        topo = jax_topology("full", n)
        cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, seed=SEED, **knobs)
        leader = jax_runner.draw_leader(jax.random.PRNGKey(SEED), topo, cfg)
        return jax_gossip.init_state(n, leader, False), 0
    if start is None:
        res, st = _jax_run(algorithm, n, **knobs)
        assert res.converged
        return st, res.rounds
    res, st = _jax_run(algorithm, n, chunk_rounds=start, max_rounds=start, **knobs)
    assert res.rounds == start and not res.converged
    return st, start


def _both_chunks(algorithm, n, knobs, start, cap_after=None):
    """One chunk of the JAX pool2 kernel in interpret mode and of the port's
    wrapper from the same state: (JAX planes, JAX executed, port planes,
    port executed, start planes)."""
    topo = jax_topology("full", n)
    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, delivery="pool",
                    pool_size=2, seed=SEED, engine="chunked", **knobs)
    st, start = _start_state(algorithm, n, knobs, start)
    layout = jax_fused_pool.build_pool_layout(n)
    key = jax.random.PRNGKey(SEED)
    keys = jax_fused.round_keys(key, start, K)
    offs = jax_fused_pool.round_offsets(key, start, K, 2, n)
    tkey = carry.key_from_numpy(np.asarray(key))
    tkeys, toffs = fused.round_keys(tkey, start, K), fused_pool.round_offsets(tkey, start, K, 2, n)
    target = cfg.resolved_target_count(n, topo.target_count)
    faults = fused.run_faults(SimConfig(n=n, algorithm=algorithm, seed=SEED, **knobs), n)
    cap = start + (K if cap_after is None else cap_after)
    if algorithm == "push-sum":
        planes = (jax_fused._pad2d(jnp.asarray(st.s, jnp.float32), layout, 0.0),
                  jax_fused._pad2d(jnp.asarray(st.w, jnp.float32), layout, 1.0),
                  jax_fused._pad2d(jnp.asarray(st.term, jnp.int32), layout, 0),
                  jax_fused._pad2d(jnp.asarray(st.conv).astype(jnp.int32), layout, 0))
        fn, _ = jax_fused_pool2.make_pushsum_pool2_chunk(topo, cfg, interpret=True)
        port = fused_pool2.pushsum_pool2_chunk
        kw = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        fields = ("s", "w", "term", "conv")
    else:
        planes = tuple(jax_fused._pad2d(jnp.asarray(x).astype(jnp.int32), layout, 0)
                       for x in (st.count, st.active, st.conv))
        fn, _ = jax_fused_pool2.make_gossip_pool2_chunk(topo, cfg, interpret=True)
        port = fused_pool2.gossip_pool2_chunk
        kw = {"rumor_target": cfg.resolved_rumor_target,
              "suppress": cfg.resolved_suppress}
        fields = ("count", "active", "conv")
    jout, jex = fn(planes, keys, offs, start, cap)
    tstate = tuple(carry.state_from_numpy(dict(zip(fields, (np.asarray(p) for p in planes)))))
    before = (fused_pool2.pushsum_pool2_chunk.launches,
              fused_pool2.gossip_pool2_chunk.launches)
    tout, tex = port(tstate, tkeys, toffs, start, cap, n=n, target=target, faults=faults,
                     **kw)
    # CPU tensors run the plain version and launch nothing.
    assert (fused_pool2.pushsum_pool2_chunk.launches,
            fused_pool2.gossip_pool2_chunk.launches) == before
    return [np.asarray(x) for x in jout], int(jex), [x.numpy() for x in tout], int(tex), \
        [np.asarray(p) for p in planes]


def _assert_bitwise(a_planes, b_planes):
    for a, b in zip(a_planes, b_planes):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.view(np.int32) == b.view(np.int32)).all()


SCHEDULE = {"fault_rate": 0.1, "crash_schedule": "2:100,4:50", "quorum": 0.95}

# (algorithm, n, knobs, start round, cap after): the schedules' death rounds
# fall inside the chunk.
CHUNKS = [
    ("push-sum", 1000, SCHEDULE, 0, None),
    ("push-sum", 65_536, {"fault_rate": 0.2, "crash_rate": 0.01, "quorum": 0.8}, 10, 5),
    ("push-sum", 70_000, {"fault_rate": 0.1, "termination": "global"}, 20, None),
    ("push-sum", 1000, {"termination": "global"}, 0, 4),
    ("gossip", 1000, {"fault_rate": 0.2, "crash_rate": 0.01, "quorum": 0.9}, 0, None),
    ("gossip", 65_536, {"crash_schedule": "12:3000,14:500", "quorum": 0.9}, 10, 3),
    ("gossip", 70_000, SCHEDULE, 0, 4),
]


@pytest.mark.parametrize("algorithm,n,knobs,start,cap_after", CHUNKS,
                         ids=lambda x: str(x).replace(" ", ""))
def test_faulted_chunk_matches_the_jax_kernel(algorithm, n, knobs, start, cap_after):
    jout, jex, tout, tex, planes = _both_chunks(algorithm, n, knobs, start, cap_after)
    assert jex == tex == (K if cap_after is None else cap_after)
    _assert_bitwise(jout, tout)
    assert any((a != b).any() for a, b in zip(tout, planes))


@pytest.mark.parametrize("algorithm,knobs", [
    ("push-sum", SCHEDULE),
    ("push-sum", {"fault_rate": 0.1, "termination": "global"}),
    ("gossip", {"crash_rate": 0.01, "quorum": 0.9}),
])
def test_chunk_from_the_verdict_runs_no_round(algorithm, knobs):
    # A resumed chunk that starts at the quorum (or the global verdict):
    # the seed verdict of round start - 1 stops it before any round.
    jout, jex, tout, tex, planes = _both_chunks(algorithm, 1000, knobs, None)
    assert jex == tex == 0
    _assert_bitwise(jout, tout)
    _assert_bitwise(planes, tout)


@pytest.fixture
def force_pool2(monkeypatch):
    """Shrink the pool engine's domain in both packages, so n > 1000 on
    ``full`` lands on the streaming pool tier."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)


# (algorithm, n, knobs): whole runs, chunks of 16 rounds.
RUNS = [
    ("push-sum", 20_000, SCHEDULE),
    ("push-sum", 20_000, {"crash_rate": 0.005, "quorum": 0.9}),
    ("push-sum", 2000, {"fault_rate": 0.2, "termination": "global"}),
    ("gossip", 20_000, {"fault_rate": 0.1, "crash_rate": 0.002, "quorum": 0.9}),
    ("gossip", 2000, {"fault_rate": 0.2}),
]


@pytest.mark.parametrize("algorithm,n,knobs", RUNS, ids=lambda x: str(x).replace(" ", ""))
def test_fused_run_matches_jax_chunked(algorithm, n, knobs, force_pool2):
    jres, jstate = _jax_run(algorithm, n, chunk_rounds=64, **knobs)
    topo = build_topology("full", n)
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2, seed=SEED,
                    engine="fused", chunk_rounds=16, **knobs)
    assert runner.fused_tier(topo, cfg) == ("pool2", None)
    before = (fused_pool2.pushsum_pool2_chunk.launches,
              fused_pool2.gossip_pool2_chunk.launches)
    res = run(topo, cfg, device="cpu")
    assert (fused_pool2.pushsum_pool2_chunk.launches,
            fused_pool2.gossip_pool2_chunk.launches) == before
    assert res.converged
    assert (res.rounds, res.converged_count, res.outcome, res.estimate_mae) == (
        jres.rounds, jres.converged_count, jres.outcome, jres.estimate_mae)
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.view(np.int32) == b.view(np.int32)).all()
    if algorithm == "push-sum":
        # Mass parks on the dead: summed over live and dead it is kept.
        assert abs(res.state.w.double().sum().item() - n) < 1e-3 * n
    if knobs.get("termination") == "global":
        assert res.converged_count == n and (res.state.term == 0).all()


SHIM = r"""
#include "pool2.cuh"
using namespace gossip;
using namespace gossip::pool2;
// Each node's send flag for chunk round k, as the kernels compute it.
extern "C" void flags(const int* active, const int* death, uint32_t thresh,
                      uint32_t k0, uint32_t k1, int start, int k, int n, int n_pad,
                      int* out) {
  const Faults f{thresh, death, nullptr, start, 0};
  uint32_t g1, g2;
  round_gate_key<true>(f, k0, k1, g1, g2);
  for (int j = 0; j < n_pad; ++j)
    out[j] = send_flag(f, active[j] != 0, j, n, k, g1, g2) ? 1 : 0;
}
// The byte plane a round's pass writes: column col's 8 destinations' flags
// into byte col, bit sub; then every node's bit read back by send_bit.
extern "C" void pack(const int* flag, int n_pad, uint8_t* bytes, int* back) {
  for (int col = 0; col < n_pad / kPack; ++col) {
    const int j0 = local_column_origin(col);
    uint32_t b = 0;
    for (int sub = 0; sub < kPack; ++sub) b |= (uint32_t)(flag[j0 + sub * kLanes] != 0) << sub;
    bytes[col] = (uint8_t)b;
  }
  for (int i = 0; i < n_pad; ++i) back[i] = send_bit(bytes, i) ? 1 : 0;
}
// Every column's sources and masked choices under displacement d.
extern "C" long columns(uint32_t k1, uint32_t k2, int n, int n_pad, int d,
                        int pool_size, const uint8_t* bytes, int* src_out,
                        int* ch_out) {
  long drawn = 0;
  for (int col = 0; col < n_pad / kPack; ++col) {
    const int j0 = local_column_origin(col);
    int src[kPack], ch[kPack];
    drawn += column_sources_sending(j0, d, n, k1, k2, pool_size, bytes, src, ch);
    for (int sub = 0; sub < kPack; ++sub) {
      src_out[j0 + sub * kLanes] = src[sub];
      ch_out[j0 + sub * kLanes] = ch[sub];
    }
  }
  return drawn;
}
extern "C" void frozen(const int* alive, const int* tc, const int* term,
                       const int* conv, int count, int* out) {
  for (int i = 0; i < count; ++i)
    out[i] = tc_frozen(alive[i] != 0, tc[i], term[i], conv[i] != 0);
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pool2_faults_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    so.flags.argtypes = [P, P, U, U, U, I, I, I, I, P]
    so.pack.argtypes = [P, I, P, P]
    so.columns.argtypes = [U, U, I, I, I, I, P, P, P]
    so.columns.restype = ctypes.c_long
    so.frozen.argtypes = [P, P, P, P, I, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("n", [20_000, 65_536, 70_000])
def test_send_bits_and_masked_columns_are_the_plain_blocked_choice(shim, n):
    # The kernels' send bits (faults.cuh send_flag, packed a column a byte)
    # against the plain version's blocked marks (fused.ChunkFaults.blocked
    # of every active real node), and each column's sources and choices
    # with a blocked source's choice -1 against the unmasked columns of
    # tests/test_torch_pool2_host.py masked by those flags.
    layout = fused_pool.build_pool_layout(n)
    n_pad, rows = layout.n_pad, layout.rows
    cfg = SimConfig(n=n, algorithm="gossip", fault_rate=0.3, crash_rate=0.02, quorum=0.9)
    faults = fused.run_faults(cfg, n)
    start = 5
    keys = fused.round_keys(rng.PRNGKey(SEED), start, 4)
    cf = faults.for_chunk(keys, start, n_pad, torch.device("cpu"))
    gen = np.random.default_rng(1)
    active = (gen.random(n_pad) < 0.7).astype(np.int32)
    death = np.ascontiguousarray(cf.death.numpy(), dtype=np.int32)
    k = 2
    flag = np.zeros(n_pad, np.int32)
    shim.flags(_p(active), _p(death), faults.thresh, int(keys[k, 0]), int(keys[k, 1]),
               start, k, n, n_pad, _p(flag))
    mark = torch.where(torch.from_numpy(active) != 0, 0, -1).to(torch.int64)
    mark = torch.where(torch.arange(n_pad) < n, mark, -1)
    want = (cf.blocked(mark, start, k, rows) >= 0).numpy().astype(np.int32)
    assert (flag == want).all() and 0 < flag.sum() < n
    bytes_ = np.zeros(n_pad // 8, np.uint8)
    back = np.zeros(n_pad, np.int32)
    shim.pack(_p(flag), n_pad, _p(bytes_), _p(back))
    assert (back == flag).all()
    k1, k2 = (int(x) for x in keys[k])
    plain_choice = fused_pool._choice_plane(keys[k], rows, 4).reshape(-1).numpy()
    for d in (1, 127, 128, 1000, n - 1, n // 2 + 3):
        src = np.zeros(n_pad, np.int32)
        ch = np.zeros(n_pad, np.int32)
        shim.columns(k1, k2, n, n_pad, d, 4, _p(bytes_), _p(src), _p(ch))
        j = np.arange(n_pad)
        want_src = np.where(j >= d, j - d, j - d + n)
        assert (src == want_src).all()
        sends = flag[want_src] != 0
        want_ch = np.where((want_src < n) & sends, plain_choice[want_src], -1)
        assert (ch == want_ch).all()


def test_frozen_packed_plane(shim):
    gen = np.random.default_rng(2)
    count = 4096
    alive = (gen.random(count) < 0.5).astype(np.int32)
    tc = gen.integers(0, 1 << 31, count, dtype=np.int64).astype(np.int32)
    term = gen.integers(0, 1 << 20, count).astype(np.int32)
    conv = (gen.random(count) < 0.5).astype(np.int32)
    out = np.zeros(count, np.int32)
    shim.frozen(_p(alive), _p(tc), _p(term), _p(conv), count, _p(out))
    want = np.where(alive != 0, np.where(conv != 0, term | (1 << 30), term), tc)
    assert (out == want).all()
