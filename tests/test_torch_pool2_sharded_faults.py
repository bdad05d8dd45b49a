"""The replicated-pool2 composition (cop5615_gossip_protocol_tpu_torch/
parallel/pool2_sharded.py, rows 20-21) under the drop gate, crash-stop with
quorum termination and push-sum's global termination, on the CPU with its
shards named on the CPU (``devices=["cpu"] * S``), where the wrappers run
their plain versions:

- one round of each JAX shard kernel in Pallas interpret mode
  (make_pushsum_pool2_shard_chunk, make_gossip_pool2_shard_chunk, with the
  round's gate key and the death windows) on every shard, against the
  port's plain version of one launch over that shard's rows, which reads
  each source's send bit from the round's bit plane (every row's bits from
  ``send_rows_plain``) where the JAX kernel regenerates the sources' gate
  words and reads their death rounds: planes and the shard's count u
  bitwise, from a state across the schedule's death round, on both wires;
- whole runs at 70,000, 100,000 and 120,000 nodes (the pool engine's cap
  shrunk to 1000 in both packages), S = 2 and 4, the verdict deferred and
  not, also with every shard placed as if on a device of its own (the send
  bits ride the wire with the summary rows): bitwise the port's
  single-device pool2 run under the same failure model and the JAX chunked
  engine's (rounds, converged count, estimate, every plane), and a run
  from the verdict's state runs no round;
- the send-bit plane's layout (csrc/pool2.cuh send_bit, the shard kernels'
  byte of a column) built with g++ against ``pack_sends`` and
  ``unpack_sends``.
"""

import ctypes
import functools
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
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.parallel import pool2_sharded as jax_p2

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel import halo, pool2_sharded
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

SEED = 3
POOL = 2
CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

# The failure models: the gate with a crash schedule (deaths at rounds 3
# and 6), with a crash rate, and with global termination (push-sum).
KNOBS = {"schedule": {"fault_rate": 0.2, "crash_schedule": "3:1000,6:500", "quorum": 0.95},
         "rate": {"fault_rate": 0.1, "crash_rate": 0.002, "quorum": 0.8},
         "global": {"fault_rate": 0.1, "termination": "global"}}


@pytest.fixture
def force_pool2(monkeypatch):
    """Shrink the pool engine's domain in both packages, so n > 1000 on
    ``full`` lands past the VMEM compositions."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)


@pytest.fixture
def split_devices(monkeypatch):
    """Place every shard as if on a device of its own: a global plane set
    and a send-bit plane pair, a count slot and a launch a shard a round,
    the wire between them and the verdict on the home slot, on the CPU."""
    monkeypatch.setattr(pool2_sharded, "place_shards", lambda devices, rows_loc: [
        pool2_sharded.DeviceRows(dev, s * rows_loc, rows_loc)
        for s, dev in enumerate(devices)])


def _cfgs(n, algorithm, knobs, **kw):
    common = dict(n=n, topology="full", algorithm=algorithm, delivery="pool",
                  pool_size=POOL, seed=SEED, **KNOBS[knobs], **kw)
    return JaxConfig(**common), SimConfig(**common)


@functools.lru_cache(maxsize=None)
def _jax_chunked(algorithm, n, knobs, max_rounds):
    """The JAX chunked engine's run and final state (numpy planes)."""
    jcfg, _ = _cfgs(n, algorithm, knobs, engine="chunked",
                    chunk_rounds=min(max_rounds, 64), max_rounds=max_rounds)
    final = {}
    res = jax_runner.run(jax_topology("full", n), jcfg,
                         on_chunk=lambda r, s: final.__setitem__("s", s))
    return res, tuple(np.asarray(x) for x in final["s"])


def _same_state(a_state, b_planes):
    for a, b in zip(a_state, b_planes):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


# ---------------------------------------------------------------------------
# One round of the JAX shard kernels against the port's plain versions.
# ---------------------------------------------------------------------------


# n: 70,000 runs the all_gather wire, 120,000 the reduce_scatter bands.
@pytest.mark.parametrize("algorithm,knobs,rnd,n", [
    ("gossip", "schedule", 3, 70_000), ("gossip", "rate", 4, 120_000),
    ("push-sum", "schedule", 6, 120_000), ("push-sum", "rate", 4, 70_000),
    ("push-sum", "global", 0, 70_000), ("push-sum", "global", 0, 120_000),
])
def test_faulted_round_matches_jax_shard_kernel(algorithm, knobs, rnd, n, force_pool2):
    S = 4
    jcfg, cfg = _cfgs(n, algorithm, knobs, n_devices=S, engine="fused")
    jtopo = jax_topology("full", n)
    rows_loc, PT, layout, wire = jax_p2.plan_pool2_sharded(jtopo, jcfg, S)
    assert pool2_sharded.plan_pool2_sharded(build_topology("full", n), cfg, S)[3] == wire
    banded = wire == "reduce_scatter"
    R, M = layout.rows, PT + 16
    # The state at round rnd: the JAX chunked engine's, padded as the tier's.
    st = (_jax_chunked(algorithm, n, knobs, rnd)[1] if rnd
          else _initial(algorithm, n, jtopo, jcfg))
    planes = _planes(algorithm, st, layout)
    key = jax.random.PRNGKey(SEED)
    keys = jax_fused.round_keys(key, rnd, 1)
    offs = jax_fused_pool.round_offsets(key, rnd, 1, POOL, n)[0]
    gkeys = jax_fused.gate_round_keys(keys)[0]
    death2d = jax_fused.build_death2d(jcfg, n, layout.n_pad)
    tkey = carry.key_from_numpy(np.asarray(key))
    tkeys = fused.round_keys(tkey, rnd, 1)[0].tolist()
    toffs = fused_pool.round_offsets(tkey, rnd, 1, POOL, n)[0].tolist()
    assert [int(k) for k in np.asarray(keys[0])] == tkeys
    faults = fused.run_faults(cfg, n)
    tdeath = faults.death_flat(layout.n_pad, "cpu")
    tdeath = None if tdeath is None else tdeath.reshape(R, 128)
    if death2d is not None:
        assert (np.asarray(death2d) == tdeath.numpy()).all()
    pushsum = algorithm == "push-sum"
    make = (jax_p2.make_pushsum_pool2_shard_chunk if pushsum
            else jax_p2.make_gossip_pool2_shard_chunk)
    plain = (pool2_sharded.pushsum_pool2_shard_round_plain if pushsum
             else pool2_sharded.gossip_pool2_shard_round_plain)
    jfn = jax.jit(make(jtopo, jcfg, rows_loc, PT, layout, interpret=True, banded=banded))
    windowed = planes[:2] if pushsum else planes[1:]
    glob = tuple(torch.from_numpy(p.copy()) for p in windowed)
    # The round's send bits of every row, as the owners wrote them.
    gate = fused.gate_round_keys(torch.tensor([tkeys]))[0].tolist()
    sends = pool2_sharded.pack_sends(pool2_sharded.send_rows_plain(
        None if pushsum else glob[0], tdeath, faults.thresh or 0, gate, rnd, 0, R, n, "cpu"))
    kw = pool2_sharded.round_kw(build_topology("full", n), cfg)
    death_mir = None if death2d is None else jnp.concatenate([death2d, death2d[:M]])
    bases = pool2_sharded.band_starts(toffs, layout)
    ME = pool2_sharded.band_margin(layout)
    total = 0
    for s in range(S):
        row0 = s * rows_loc
        own = tuple(p[row0:row0 + rows_loc] for p in planes)
        if banded:
            bands = [[np.take(p, np.arange(row0 + b, row0 + b + rows_loc + ME) % R, axis=0)
                      for p in windowed] for b in bases]
            jwire = (jnp.asarray(bases, jnp.int32),
                     tuple(jnp.asarray(x) for band in bands for x in band))
        else:
            jwire = tuple(jnp.asarray(np.concatenate([p, p[:M]])) for p in windowed)
        jout, ju = jfn(tuple(jnp.asarray(p) for p in own), jwire, keys[0], offs,
                       gkeys, None if death2d is None else death2d[row0:row0 + rows_loc],
                       death_mir, jnp.int32(row0), jnp.int32(rnd))
        sf = pool2_sharded.ShardFaults(
            faults.thresh or 0,
            None if tdeath is None else tdeath[row0:row0 + rows_loc].contiguous(), None,
            rnd, faults.global_term, sends, None)
        own_t = tuple(torch.from_numpy(p[row0:row0 + rows_loc].copy())
                      for p in (planes[2:] if pushsum else planes[:1]))
        tout, tu = plain(glob, own_t, tkeys, toffs, row0, **kw, faults=sf)
        assert int(ju) == int(tu)
        total += int(tu)
        # The port's planes in the state's order: (s, w, tc) or (count, active).
        for a, b in zip(jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.float32:
                # Halve after the sums (JAX) equals halve before (the port)
                # but on subnormals: the data must hold none.
                assert not (np.abs(a[a != 0]) < np.finfo(np.float32).tiny).any()
                a, b = a.view(np.int32), b.view(np.int32)
            assert (a == b).all()
    # Push-sum from the initial state under global termination: most nodes'
    # ratios move in the first round.
    assert total > n // 2 if knobs == "global" else total >= 0


def _initial(algorithm, n, jtopo, jcfg):
    """The canonical JAX initial state as numpy planes."""
    from cop5615_gossip_protocol_tpu.models import gossip as jax_gossip
    from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum

    if algorithm == "push-sum":
        st = jax_pushsum.init_state(n, jnp.float32, 0)
    else:
        leader = jax_runner.draw_leader(jax.random.PRNGKey(SEED), jtopo, jcfg)
        st = jax_gossip.init_state(n, leader, False)
    return tuple(np.asarray(x) for x in st)


def _planes(algorithm, st, layout):
    """Padded [R, 128] numpy planes of the pool2 tier: (s, w, tc) or
    (count, active)."""
    def pad(x, fill, dtype):
        out = np.full(layout.n_pad, fill, dtype)
        out[:layout.n] = x
        return out.reshape(layout.rows, 128)

    if algorithm == "push-sum":
        s, w, term, conv = st
        tc = np.where(conv, term | jax_p2.TC_CONV_BIT, term).astype(np.int32)
        return (pad(s, 0.0, np.float32), pad(w, 1.0, np.float32), pad(tc, 0, np.int32))
    count, active, _ = st
    return pad(count, 0, np.int32), pad(active, 0, np.int32)


# ---------------------------------------------------------------------------
# Whole runs against the single-device pool2 run and the JAX chunked engine.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _single_device(algorithm, n, knobs):
    _, cfg = _cfgs(n, algorithm, knobs, engine="fused")
    topo = build_topology("full", n)
    assert runner.fused_tier(topo, cfg) == ("pool2", None)
    return run(topo, cfg, device="cpu")


@pytest.mark.parametrize("algorithm,knobs,n,S,overlap,split", [
    ("gossip", "schedule", 70_000, 2, True, False),
    ("gossip", "rate", 120_000, 4, False, True),
    ("push-sum", "schedule", 70_000, 4, False, False),
    ("push-sum", "global", 120_000, 2, True, True),
    ("gossip", "schedule", 100_000, 4, True, True),
    ("push-sum", "global", 100_000, 4, False, False),
])
def test_faulted_sharded_run_is_bitwise_the_single_device_run(
        algorithm, knobs, n, S, overlap, split, force_pool2, request):
    if split:
        request.getfixturevalue("split_devices")
    _, cfg = _cfgs(n, algorithm, knobs, engine="fused", n_devices=S,
                   overlap_collectives=overlap)
    topo = build_topology("full", n)
    assert runner.sharded_tier(topo, cfg) == ("pool2_sharded", None, "B13")
    halo.exchange_rows_batched.copies = 0
    res = run(topo, cfg, devices=["cpu"] * S)
    assert (halo.exchange_rows_batched.copies > 0) == split
    ref = _single_device(algorithm, n, knobs)
    assert res.converged and ref.converged
    assert (res.rounds, res.converged_count, res.estimate_mae) == (
        ref.rounds, ref.converged_count, ref.estimate_mae)
    _same_state(res.state, [x.numpy() for x in ref.state])
    jres, jstate = _jax_chunked(algorithm, n, knobs, 1_000_000)
    assert (res.rounds, res.converged_count, res.estimate_mae) == (
        jres.rounds, jres.converged_count, jres.estimate_mae)
    _same_state(res.state, jstate)
    if knobs == "global":
        assert res.converged_count == n and (res.state.term == 0).all()
    # A run from the verdict's state runs no round.
    again = run(topo, cfg, devices=["cpu"] * S, start_state=res.state,
                start_round=res.rounds)
    assert again.rounds == res.rounds and again.converged
    _same_state(again.state, [x.numpy() for x in res.state])


@pytest.mark.parametrize("knobs", [{"fault_rate": 0.1}, {"termination": "global"},
                                   {"crash_rate": 0.01, "quorum": 0.9}])
def test_failure_model_configs_run_on_the_composition(knobs):
    # The configs tests/test_torch_pool2_sharded.py once held refused: at
    # 100,000 nodes in 4 shards (1,024 rows, no whole 512-row tiles for the
    # VMEM composition) the JAX ladder takes them to the replicated-pool2
    # composition, which runs them, 40 rounds bitwise the single-device run.
    n, S = 100_000, 4
    common = {"n": n, "algorithm": "push-sum", "delivery": "pool", "engine": "fused",
              "max_rounds": 40, **knobs}
    topo = build_topology("full", n)
    cfg = SimConfig(**common, n_devices=S)
    assert runner.sharded_tier(topo, cfg) == ("pool2_sharded", None, "B13")
    res = run(topo, cfg, devices=["cpu"] * S)
    ref = run(topo, SimConfig(**common), device="cpu")
    assert (res.rounds, res.converged_count) == (ref.rounds, ref.converged_count)
    _same_state(res.state, [x.numpy() for x in ref.state])


def test_gossip_has_no_global_termination():
    n = 70_000
    R = fused_pool.build_pool_layout(n).rows
    glob = (torch.zeros(R, 128, dtype=torch.int32),)
    own = (torch.zeros(R // 4, 128, dtype=torch.int32),)
    sf = pool2_sharded.ShardFaults(0, None, None, 0, True,
                                   torch.zeros(R // 8, 128, dtype=torch.uint8), None)
    with pytest.raises(ValueError, match="no global termination"):
        pool2_sharded.gossip_pool2_shard_round(
            glob, tuple(torch.empty_like(x) for x in glob), own,
            tuple(torch.empty_like(x) for x in own), torch.zeros(1, 2, dtype=torch.int64),
            torch.ones(1, 2, dtype=torch.int32), 0, n=n, rumor_target=10, suppress=False,
            u=None, acc=torch.zeros(2, dtype=torch.int32),
            ctrl=torch.zeros(2, dtype=torch.int32), faults=sf)


SHIM = r"""
#include "pool2.cuh"
using namespace gossip::pool2;
// The byte the shard kernels write for column col of the rows from row0,
// and the flat position of its first destination's packed choice word.
extern "C" void bytes_of(int row0, int rows, int* byte, int* word) {
  for (int col = 0; col < rows / kPack * kLanes; ++col) {
    byte[col] = row0 * (kLanes / kPack) + col;
    word[col] = (int)choice_word_index(shard_column_origin(col, row0));
  }
}
// Every node's send bit of a global plane, and the plane a pass writes
// from flags over the rows from row0 (bit sub of a column's byte).
extern "C" void bits(const uint8_t* plane, int count, int* out) {
  for (int i = 0; i < count; ++i) out[i] = send_bit(plane, i) ? 1 : 0;
}
extern "C" void write(const int* flag, int row0, int rows, uint8_t* plane) {
  for (int col = 0; col < rows / kPack * kLanes; ++col) {
    const int j0 = shard_column_origin(col, row0);
    unsigned b = 0;
    for (int sub = 0; sub < kPack; ++sub) b |= (unsigned)(flag[j0 + sub * kLanes] != 0) << sub;
    plane[row0 * (kLanes / kPack) + col] = (uint8_t)b;
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pool2_shard_bits_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.bytes_of.argtypes = [I, I, P, P]
    so.bits.argtypes = [P, I, P]
    so.write.argtypes = [P, I, I, P]
    return so


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("R,row0,rows", [(64, 0, 64), (64, 16, 32), (1024, 256, 256)])
def test_send_bit_plane_layout(shim, R, row0, rows):
    # The shard kernels' byte of a column is its destinations' packed choice
    # word's position; a pass over the rows from row0 writes exactly the
    # bytes pack_sends makes of them, and send_bit reads unpack_sends' mask.
    cols = rows // 8 * 128
    byte, word = np.zeros(cols, np.int32), np.zeros(cols, np.int32)
    shim.bytes_of(row0, rows, _p(byte), _p(word))
    assert (byte == word).all()
    assert (byte == np.arange(row0 * 16, (row0 + rows) * 16)).all()
    gen = np.random.default_rng(R + row0)
    flag = (gen.random(R * 128) < 0.4).astype(np.int32)
    plane = np.zeros(R * 16, np.uint8)
    shim.write(_p(flag), row0, rows, _p(plane))
    mask = torch.from_numpy(flag.reshape(R, 128) != 0)
    want = pool2_sharded.pack_sends(mask[row0:row0 + rows]).numpy().reshape(-1)
    assert (plane[row0 * 16:(row0 + rows) * 16] == want).all()
    assert not plane[:row0 * 16].any() and not plane[(row0 + rows) * 16:].any()
    full = pool2_sharded.pack_sends(mask).numpy()
    back = np.zeros(R * 128, np.int32)
    shim.bits(_p(np.ascontiguousarray(full.reshape(-1))), R * 128, _p(back))
    assert (back == flag).all()
    assert torch.equal(pool2_sharded.unpack_sends(torch.from_numpy(full)), mask)
