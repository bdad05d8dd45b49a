"""The port's replicated-pool2 composition (cop5615_gossip_protocol_tpu_torch/
parallel/pool2_sharded.py) on the CPU, with its shards placed explicitly on
the CPU (``devices=["cpu"] * S``), where its wrappers run their plain
versions. Checked:

- one round of each JAX shard kernel, in Pallas interpret mode, on every
  shard, against the port's plain version of one launch over that shard's
  rows, which reads the global planes in place where the JAX kernel reads
  the wire built in numpy by its definition (the gathered copy with its
  mirror margin, or each slot's band at its start): gossip exactly;
  push-sum bitwise, the data holding no subnormal, where the JAX kernel's
  halve after the slot sums could round otherwise than the port's halve
  before them; from the initial and a mid-run state, on both wires;
- whole runs at 70,000, 120,000 and 131,072 nodes (the pool engine's cap
  shrunk to 1000 in both packages), S = 2 and 4, both algorithms, both
  wires, the verdict deferred and not: bitwise the port's single-device
  pool2 run and the JAX chunked engine's (rounds, converged count, every
  plane), push-sum capped at 120 rounds past 70,000; the same with every
  shard placed as if on a device of its own (``place_shards`` split: the
  wire, the per-device counts and the deferred verdict), and one wrapper
  call a round a device, counted;
- resume from a chunk boundary onto the same trajectory and from the
  converged state, the ladder's tier and refusals against the JAX ladder,
  and no silent placement."""

import dataclasses
import functools

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
from cop5615_gossip_protocol_tpu.parallel import fused_pool_sharded as jax_vmem
from cop5615_gossip_protocol_tpu.parallel import pool2_sharded as jax_p2

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng
from cop5615_gossip_protocol_tpu_torch.parallel import halo, mesh, pool2_sharded
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

SEED = 3
POOL = 2


@pytest.fixture
def force_pool2(monkeypatch):
    """Shrink the pool engine's domain in both packages, so n > 1000 on
    ``full`` lands past the VMEM compositions."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)


def _cfgs(n, algorithm, **kw):
    common = dict(n=n, topology="full", algorithm=algorithm, delivery="pool",
                  pool_size=POOL, seed=SEED, **kw)
    return JaxConfig(**common), SimConfig(**common)


@functools.lru_cache(maxsize=None)
def _jax_chunked(algorithm, n, max_rounds):
    """The JAX chunked engine's run and final state (numpy planes)."""
    jcfg, _ = _cfgs(n, algorithm, engine="chunked", chunk_rounds=64,
                    max_rounds=max_rounds)
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


def _jax_state(algorithm, n, mid_round):
    """(canonical JAX state as numpy, its absolute round)."""
    if mid_round == 0:
        jcfg, _ = _cfgs(n, algorithm)
        if algorithm == "push-sum":
            st = jax_pushsum.init_state(n, jnp.float32, 0)
        else:
            leader = jax_runner.draw_leader(jax.random.PRNGKey(SEED),
                                            jax_topology("full", n), jcfg)
            st = jax_gossip.init_state(n, leader, False)
        return tuple(np.asarray(x) for x in st), 0
    return _jax_chunked(algorithm, n, mid_round)[1], mid_round


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


@pytest.mark.parametrize("n", [70_000, 120_000, 131_072])  # gather, band, band
@pytest.mark.parametrize("algorithm,mid_round", [
    ("gossip", 0), ("gossip", 25), ("push-sum", 0), ("push-sum", 60),
])
def test_round_matches_jax_shard_kernel(algorithm, mid_round, n, force_pool2):
    S = 4
    jcfg, cfg = _cfgs(n, algorithm, n_devices=S, engine="fused")
    jtopo = jax_topology("full", n)
    rows_loc, PT, layout, wire = jax_p2.plan_pool2_sharded(jtopo, jcfg, S)
    plan = pool2_sharded.plan_pool2_sharded(build_topology("full", n), cfg, S)
    assert plan[:2] == (rows_loc, PT) and plan[3] == wire
    banded = wire == "reduce_scatter"
    st, rnd = _jax_state(algorithm, n, mid_round)
    planes = _planes(algorithm, st, layout)
    R, M = layout.rows, PT + 16
    key = jax.random.PRNGKey(SEED)
    keys = jax_fused.round_keys(key, rnd, 1)[0]
    offs = jax_fused_pool.round_offsets(key, rnd, 1, POOL, n)[0]
    tkey = carry.key_from_numpy(np.asarray(key))
    tkeys = fused.round_keys(tkey, rnd, 1)[0].tolist()
    toffs = fused_pool.round_offsets(tkey, rnd, 1, POOL, n)[0].tolist()
    assert [int(k) for k in np.asarray(keys)] == tkeys
    assert np.asarray(offs).tolist() == toffs
    windowed = planes[:2] if algorithm == "push-sum" else planes[1:]
    if algorithm == "push-sum":
        make = jax_p2.make_pushsum_pool2_shard_chunk
        port = pool2_sharded.make_pushsum_pool2_shard_chunk
    else:
        make = jax_p2.make_gossip_pool2_shard_chunk
        port = pool2_sharded.make_gossip_pool2_shard_chunk
    jfn = jax.jit(functools.partial(
        make(jtopo, jcfg, rows_loc, PT, layout, interpret=True, banded=banded),
        gkeys=None, death_own=None, death_mir=None))
    tfn = port(build_topology("full", n), cfg, rows_loc, layout)
    bases = pool2_sharded.band_starts(toffs, layout)
    ME = pool2_sharded.band_margin(layout)
    gathered = [np.concatenate([p, p[:M]]) for p in windowed]
    glob = tuple(torch.from_numpy(p.copy()) for p in planes)
    total = 0
    for s in range(S):
        row0 = s * rows_loc
        own = tuple(p[row0:row0 + rows_loc] for p in planes)
        if banded:
            # Slot k's band: mirrored rows [(row0 + base_k) mod R, +rows_loc+ME).
            bands = [[np.take(p, np.arange(row0 + b, row0 + b + rows_loc + ME) % R,
                              axis=0) for p in windowed] for b in bases]
            jwire = (jnp.asarray(bases, jnp.int32),
                     tuple(jnp.asarray(x) for band in bands for x in band))
        else:
            jwire = tuple(jnp.asarray(g) for g in gathered)
        jout, ju = jfn(tuple(jnp.asarray(p) for p in own), jwire, keys, offs,
                       row0=jnp.int32(row0), rnd=jnp.int32(rnd))
        tout, tu = tfn(glob, tkeys, toffs, row0)
        assert int(ju) == int(tu)
        total += int(tu)
        for a, b in zip(jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.float32:
                # Halve after the sums (JAX) equals halve before (the port)
                # but on subnormals: the data must hold none.
                assert not (np.abs(a[a != 0]) < np.finfo(np.float32).tiny).any()
                a, b = a.view(np.int32), b.view(np.int32)
            assert (a == b).all()
    if mid_round:
        assert 0 < total < n  # a mid-run state: some nodes, not all, converged


# ---------------------------------------------------------------------------
# Whole runs against the port's single-device pool2 run and the JAX
# chunked engine.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _single_device(algorithm, n, max_rounds):
    _, cfg = _cfgs(n, algorithm, engine="fused", max_rounds=max_rounds)
    topo = build_topology("full", n)
    assert runner.fused_tier(topo, cfg) == ("pool2", None)
    return run(topo, cfg, device="cpu")


def _launches():
    return (pool2_sharded.pushsum_pool2_shard_round.launches,
            pool2_sharded.gossip_pool2_shard_round.launches)


@pytest.mark.parametrize("algorithm,n,S,wire,overlap,max_rounds", [
    ("gossip", 70_000, 2, "reduce_scatter", True, 1_000_000),
    ("gossip", 70_000, 4, "auto", False, 1_000_000),  # gather: margin > shard
    ("gossip", 120_000, 2, "all_gather", False, 1_000_000),
    ("gossip", 120_000, 4, "auto", True, 1_000_000),  # band
    ("gossip", 131_072, 2, "auto", True, 1_000_000),  # gather
    ("gossip", 131_072, 4, "reduce_scatter", False, 1_000_000),
    ("push-sum", 70_000, 2, "auto", True, 1_000_000),  # gather
    ("push-sum", 70_000, 4, "all_gather", False, 1_000_000),
    ("push-sum", 120_000, 4, "auto", False, 120),  # band
    ("push-sum", 131_072, 2, "reduce_scatter", True, 120),
])
def test_sharded_run_is_bitwise_the_single_device_run(
        algorithm, n, S, wire, overlap, max_rounds, force_pool2):
    _, cfg = _cfgs(n, algorithm, engine="fused", n_devices=S, pool2_wire=wire,
                   overlap_collectives=overlap, max_rounds=max_rounds)
    topo = build_topology("full", n)
    assert runner.sharded_tier(topo, cfg) == ("pool2_sharded", None, "B13")
    before = _launches()
    res = run(topo, cfg, devices=["cpu"] * S)
    assert _launches() == before  # the CPU launches nothing
    assert res.device == "cpu" and res.converged == (max_rounds > 1000)
    for ref in (_single_device(algorithm, n, max_rounds),):
        assert (res.rounds, res.converged, res.converged_count, res.estimate_mae) == (
            ref.rounds, ref.converged, ref.converged_count, ref.estimate_mae)
        _same_state(res.state, [x.numpy() for x in ref.state])
    jres, jstate = _jax_chunked(algorithm, n, max_rounds)
    assert (res.rounds, res.converged, res.converged_count, res.estimate_mae) == (
        jres.rounds, jres.converged, jres.converged_count, jres.estimate_mae)
    _same_state(res.state, jstate)


@pytest.fixture
def split_devices(monkeypatch):
    """Place every shard as if on a device of its own: a global plane set,
    a count slot and a launch a shard a round, the wire between them and
    the verdict on the home slot, all on the CPU."""
    monkeypatch.setattr(pool2_sharded, "place_shards", lambda devices, rows_loc: [
        pool2_sharded.DeviceRows(dev, s * rows_loc, rows_loc)
        for s, dev in enumerate(devices)])


@pytest.mark.parametrize("algorithm,n,S,wire,overlap,max_rounds", [
    ("gossip", 120_000, 4, "reduce_scatter", True, 1_000_000),
    ("gossip", 120_000, 2, "all_gather", False, 1_000_000),
    ("gossip", 131_072, 4, "reduce_scatter", False, 1_000_000),
    ("gossip", 70_000, 4, "auto", True, 1_000_000),  # gather: margin > shard
    ("push-sum", 70_000, 2, "auto", True, 1_000_000),  # gather
    ("push-sum", 120_000, 4, "reduce_scatter", True, 120),
    ("push-sum", 131_072, 2, "all_gather", False, 120),
    ("push-sum", 131_072, 4, "reduce_scatter", False, 120),
])
def test_split_placement_is_bitwise_the_single_device_run(
        algorithm, n, S, wire, overlap, max_rounds, force_pool2, split_devices):
    _, cfg = _cfgs(n, algorithm, engine="fused", n_devices=S, pool2_wire=wire,
                   overlap_collectives=overlap, max_rounds=max_rounds)
    topo = build_topology("full", n)
    halo.exchange_rows_batched.copies = 0
    res = run(topo, cfg, devices=["cpu"] * S)
    assert halo.exchange_rows_batched.copies > 0  # the wire ran between the slots
    ref = _single_device(algorithm, n, max_rounds)
    assert (res.rounds, res.converged, res.converged_count, res.estimate_mae) == (
        ref.rounds, ref.converged, ref.converged_count, ref.estimate_mae)
    _same_state(res.state, [x.numpy() for x in ref.state])


@pytest.mark.parametrize("algorithm,S,split", [
    ("push-sum", 2, False), ("push-sum", 4, True), ("gossip", 4, False),
    ("gossip", 2, True),
])
def test_a_round_is_one_launch_a_device(algorithm, S, split, force_pool2, monkeypatch,
                                        request):
    """The launches a run queues, counted as wrapper calls (on the CPU each
    runs the plain version): one a device a round, in row order, with the
    verdict in the launch (none queued) and no wire when every shard is on
    one device, and one verdict a round otherwise."""
    if split:
        request.getfixturevalue("split_devices")
    n, max_rounds = 120_000, 40
    _, cfg = _cfgs(n, algorithm, engine="fused", n_devices=S, max_rounds=max_rounds)
    name = ("pushsum_pool2_shard_round" if algorithm == "push-sum"
            else "gossip_pool2_shard_round")
    calls, verdicts = [], []
    real, real_verdict = getattr(pool2_sharded, name), pool2_sharded.shard_verdict

    def spy(*args, **kw):
        calls.append((args[6], kw["u"] is None))
        return real(*args, **kw)

    def spy_verdict(*args, **kw):
        verdicts.append(1)
        return real_verdict(*args, **kw)

    monkeypatch.setattr(pool2_sharded, name, spy)
    monkeypatch.setattr(pool2_sharded, "shard_verdict", spy_verdict)
    halo.exchange_rows_batched.copies = 0
    res = run(build_topology("full", n), cfg, devices=["cpu"] * S)
    rows_loc = pool2_sharded.plan_pool2_sharded(build_topology("full", n), cfg, S)[0]
    row0s = [s * rows_loc for s in range(S)] if split else [0]
    # Rounds queued: to max_rounds, or to convergence and at most two
    # 8-round chunks past it.
    queued = len(calls) // len(row0s)
    assert [r for r, _ in calls] == row0s * queued
    assert res.rounds <= queued <= max_rounds and queued % 8 == 0
    if res.rounds == max_rounds:
        assert queued == max_rounds
    assert all(in_launch == (not split) for _, in_launch in calls)
    assert len(verdicts) == (queued if split else 0)
    assert (halo.exchange_rows_batched.copies > 0) == split


@pytest.mark.parametrize("algorithm,n,S,mid,end", [
    ("gossip", 120_000, 4, 16, 1_000_000), ("push-sum", 70_000, 2, 16, 40),
])
def test_resume_from_a_chunk_boundary(algorithm, n, S, mid, end, force_pool2):
    topo = build_topology("full", n)
    key = rng.PRNGKey(SEED)

    def sharded(max_rounds, **kw):
        _, cfg = _cfgs(n, algorithm, engine="fused", n_devices=S,
                       max_rounds=max_rounds)
        return run(topo, cfg, key=key, devices=["cpu"] * S, **kw)

    whole = sharded(end)
    half = sharded(mid)
    assert half.rounds == mid and not half.converged
    resumed = sharded(end, start_state=half.state, start_round=mid)
    assert (resumed.rounds, resumed.converged_count) == (whole.rounds,
                                                         whole.converged_count)
    _same_state(resumed.state, [x.numpy() for x in whole.state])
    if whole.converged:
        # From the converged state nothing runs and nothing changes.
        again = sharded(end, start_state=whole.state, start_round=whole.rounds)
        assert again.rounds == whole.rounds and again.converged
        _same_state(again.state, [x.numpy() for x in whole.state])


@pytest.mark.parametrize("algorithm,n,S,mid,end", [
    ("gossip", 120_000, 4, 24, 1_000_000), ("push-sum", 131_072, 2, 16, 40),
])
def test_resume_with_split_placement(algorithm, n, S, mid, end, force_pool2,
                                     split_devices):
    """A resume from a chunk boundary and from the converged state, every
    shard as if on a device of its own, against the same run on one."""
    topo = build_topology("full", n)
    key = rng.PRNGKey(SEED)

    def sharded(max_rounds, **kw):
        _, cfg = _cfgs(n, algorithm, engine="fused", n_devices=S,
                       max_rounds=max_rounds)
        return run(topo, cfg, key=key, devices=["cpu"] * S, **kw)

    whole = _single_device(algorithm, n, end)
    half = sharded(mid)
    assert half.rounds == mid and not half.converged
    resumed = sharded(end, start_state=half.state, start_round=mid)
    assert (resumed.rounds, resumed.converged_count) == (whole.rounds,
                                                         whole.converged_count)
    _same_state(resumed.state, [x.numpy() for x in whole.state])
    if whole.converged:
        again = sharded(end, start_state=whole.state, start_round=whole.rounds)
        assert again.rounds == whole.rounds and again.converged
        _same_state(again.state, [x.numpy() for x in whole.state])


# ---------------------------------------------------------------------------
# The ladder, the refusals and the placement.
# ---------------------------------------------------------------------------


def _jax_tier(n, jcfg):
    """The JAX runner's n_devices > 1 ladder on implicit full with
    engine='fused' and pool delivery: the composition, or its error."""
    topo = jax_topology("full", n)
    plan_vmem = jax_vmem.plan_fused_pool_sharded(topo, jcfg, jcfg.n_devices)
    if not isinstance(plan_vmem, str):
        return "fused_pool_sharded", None
    plan_p2 = jax_p2.plan_pool2_sharded(topo, jcfg, jcfg.n_devices)
    if not isinstance(plan_p2, str):
        return "pool2_sharded", None
    return "pool2_sharded", (
        f"engine='fused' with n_devices={jcfg.n_devices} unavailable: VMEM pool "
        f"composition: {plan_vmem}; replicated-pool2 composition: {plan_p2}")


@pytest.mark.parametrize("n,S,pool_size,tier", [
    (2**21, 2, 2, "fused_pool_sharded"), (2**21, 8, 16, "fused_pool_sharded"),
    (100_000, 4, 4, "pool2_sharded"),  # 1024 rows: not whole 512-row tiles
    (2**21 + 1, 2, 2, "pool2_sharded"), (16_777_216, 4, 2, "pool2_sharded"),
    (2**27, 4, 2, "pool2_sharded"), (16_777_217, 4, 2, "pool2_sharded"),
])
def test_ladder_matches_the_jax_ladder(n, S, pool_size, tier):
    common = dict(n=n, topology="full", algorithm="gossip", delivery="pool",
                  pool_size=pool_size, n_devices=S, engine="fused")
    jtier, jreason = _jax_tier(n, JaxConfig(**common))
    got, reason, item = runner.sharded_tier(build_topology("full", n),
                                           SimConfig(**common))
    assert (got, reason) == (jtier, jreason) and got == tier
    assert (reason is not None) == (n == 16_777_217)
    if reason is not None:
        assert "no processing tile divides" in reason
    assert item == {"fused_pool_sharded": "A10", "pool2_sharded": "B13"}[got]


@pytest.mark.parametrize("kind,n,kw,exc,words", [
    ("full", 2**21, {}, NotImplementedError, ("ROADMAP A10", "VMEM replicated")),
    ("full", 200_000, {"engine": "auto"}, NotImplementedError,
     ("ROADMAP A10", "run_sharded", "--devices")),
    ("full", 200_000, {"engine": "chunked"}, NotImplementedError, ("ROADMAP A10",)),
    ("torus3d", 4096, {"delivery": "auto"}, ValueError,
     ("unavailable: VMEM composition", "HBM-streaming composition")),
    ("imp3d", 4096, {"n_devices": 3}, ValueError,
     ("unavailable", "3 devices do not divide it")),
    ("full", 16_777_217, {}, ValueError,
     ("unavailable: VMEM pool composition", "no processing tile divides")),
])
def test_other_compositions_refuse_with_their_item(kind, n, kw, exc, words):
    args = {"n": n, "topology": kind, "algorithm": "gossip", "delivery": "pool",
            "pool_size": 2, "n_devices": 4, "engine": "fused", **kw}
    cfg = SimConfig(**args)
    with pytest.raises(exc) as err:
        run(build_topology(kind, n), cfg, devices=["cpu"] * 4)
    assert all(w in str(err.value) for w in words), str(err.value)


def test_faults_and_matmul_stay_refused():
    for kw, item in (({"strict_engine": True}, "A12"),
                     ({"plan": "auto"}, "A11"), ({"halo_dma": "on"}, "A10")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            SimConfig(**{"n": 100_000, "algorithm": "push-sum", "delivery": "pool",
                         "n_devices": 4, "engine": "fused", **kw})
    # Replicas are ported, and a sweep refuses the fused engine (the JAX
    # config's text).
    with pytest.raises(ValueError, match="does not apply to replica sweeps"):
        SimConfig(n=100_000, algorithm="push-sum", delivery="pool", n_devices=4,
                  engine="fused", replicas=2)
    # The dup gate and the delay ring stay refused by the plan, with the
    # JAX plan's text; matmul runs here (tests/test_torch_matmul.py), and
    # the VMEM replicated composition refuses it with JAX's text.
    topo = build_topology("full", 100_000)
    for kw in ({"dup_rate": 0.1}, {"delay_rounds": 2}):
        cfg = SimConfig(n=100_000, algorithm="push-sum", delivery="pool",
                        n_devices=4, engine="fused", **kw)
        jcfg = JaxConfig(n=100_000, algorithm="push-sum", delivery="pool",
                         n_devices=4, engine="fused", **kw)
        assert pool2_sharded.plan_pool2_sharded(topo, cfg, 4) == \
            jax_p2.plan_pool2_sharded(jax_topology("full", 100_000), jcfg, 4)
    cfg = SimConfig(n=100_000, algorithm="push-sum", delivery="matmul",
                    n_devices=4, engine="fused")
    assert not isinstance(pool2_sharded.plan_pool2_sharded(topo, cfg, 4), str)
    assert runner.sharded_tier(topo, cfg)[:2] == ("pool2_sharded", None)
    # The drop gate, crash-stop and global termination run on the
    # composition now (tests/test_torch_pool2_sharded_faults.py).
    with pytest.raises(ValueError, match="unknown pool2_wire"):
        SimConfig(n=100, delivery="pool", pool2_wire="psum")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; these pin the behaviour without one")


def test_no_silent_placement(no_gpu, force_pool2, monkeypatch):
    n, topo = 70_000, build_topology("full", 70_000)
    _, cfg = _cfgs(n, "gossip", engine="fused", n_devices=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(topo, cfg)
    with pytest.raises(ValueError, match=r"1 cpu device\(s\) visible"):
        run(topo, cfg, device="cpu")
    with pytest.raises(ValueError, match="names 2 device"):
        run(topo, cfg, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="devices places the shards"):
        run(topo, SimConfig(n=n, delivery="pool"), devices=["cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(2, ["cuda:0", "cuda:0"])
    # An explicit CPU list never reaches a CUDA call.
    def cuda_touched(*a, **k):
        raise AssertionError("a CUDA call on the CPU path")

    for name in ("current_stream", "synchronize", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, cuda_touched)
    monkeypatch.setattr(pool2_sharded.kernels, "entry", cuda_touched)
    monkeypatch.setattr(pool2_sharded.kernels, "load", cuda_touched)
    res = run(topo, dataclasses.replace(cfg, max_rounds=8), devices=["cpu"] * 4)
    assert res.rounds == 8 and res.device == "cpu"


def test_cli_flags_reach_the_config(capsys, force_pool2):
    from cop5615_gossip_protocol_tpu_torch.cli import main

    # --devices N needs N visible devices of the platform, as in JAX.
    assert main(["70000", "full", "gossip", "--delivery", "pool", "--pool-size", "2",
                 "--engine", "fused", "--devices", "2", "--platform", "cpu",
                 "--pool2-wire", "reduce_scatter", "--overlap-collectives",
                 "off"]) == 2
    err = capsys.readouterr().err
    assert "n_devices=2 out of range; 1 cpu device(s) visible" in err
    with pytest.raises(SystemExit):
        main(["70000", "full", "gossip", "--delivery", "pool", "--pool2-wire",
              "psum", "--platform", "cpu"])


def test_wrappers_refuse_what_the_kernels_do_not_take(force_pool2):
    n = 70_000
    _, cfg = _cfgs(n, "gossip", engine="fused", n_devices=4)
    rows_loc, PT, layout, _ = pool2_sharded.plan_pool2_sharded(
        build_topology("full", n), cfg, 4)
    R = layout.rows
    glob = (torch.zeros(R, 128, dtype=torch.int32),)
    glob_out = (torch.empty_like(glob[0]),)
    own = (torch.zeros(rows_loc, 128, dtype=torch.int32),)
    own_out = (torch.empty_like(own[0]),)
    keys = torch.tensor([[1, 2]], dtype=torch.int64)
    offs = torch.tensor([[5, 7]], dtype=torch.int32)
    kw = {"n": n, "rumor_target": 10, "suppress": False,
          "u": torch.zeros(1, dtype=torch.int32), "acc": torch.zeros(2, dtype=torch.int32),
          "ctrl": torch.zeros(2, dtype=torch.int32)}
    fn = pool2_sharded.gossip_pool2_shard_round
    fn(glob, glob_out, own, own_out, keys, offs, rows_loc, **kw)  # accepted
    fn(glob, glob_out, own, own_out, keys, offs, 0, **{**kw, "u": None}, target=5)
    with pytest.raises(ValueError, match="shard plane"):
        fn((glob[0].float(),), glob_out, own, own_out, keys, offs, 0, **kw)
    with pytest.raises(ValueError, match="shard plane"):
        fn(glob, glob_out, own, (own_out[0][:8],), keys, offs, 0, **kw)
    with pytest.raises(ValueError, match="whole 8-row groups"):
        fn(glob, glob_out, own, own_out, keys, offs, 4, **kw)
    with pytest.raises(ValueError, match="whole 8-row groups"):
        fn(glob, glob_out, own, own_out, keys, offs, R - rows_loc + 8, **kw)
    with pytest.raises(ValueError, match="pool_size 3"):
        fn(glob, glob_out, own, own_out, keys, torch.tensor([[5, 7, 9]], dtype=torch.int32),
           0, **kw)
    with pytest.raises(ValueError, match="offs must lie"):
        fn(glob, glob_out, own, own_out, keys, torch.tensor([[0, n]], dtype=torch.int32),
           0, **kw)
    with pytest.raises(ValueError, match="keys must be int64"):
        fn(glob, glob_out, own, own_out, keys.int(), offs, 0, **kw)
    with pytest.raises(ValueError, match="round 1 outside"):
        fn(glob, glob_out, own, own_out, keys, offs, 0, **kw, at=1)
    with pytest.raises(ValueError, match="u, acc and ctrl"):
        fn(glob, glob_out, own, own_out, keys, offs, 0, **{**kw, "ctrl": torch.zeros(2)})
