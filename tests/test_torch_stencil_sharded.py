"""The port's resident sharded lattice composition (cop5615_gossip_protocol_
tpu_torch/parallel/fused_sharded.py, the JAX package's B10) on the CPU, its
shards placed explicitly on the CPU (``devices=["cpu"] * S``), where its
wrappers run their plain versions. Checked:

- the JAX engines' per-slot displacement planes (``_build_disp_planes``)
  against the lattice direction pairs the port's kernels sample from,
  slot by slot, on every lattice kind;
- one super-step of the JAX shard kernel (``make_stencil_shard_chunk``), in
  Pallas interpret mode, on every shard, against the port's plain version
  on the same extended planes: the middle rows, the rounds run and the
  per-round counts u, bitwise, gossip and push-sum (the same halve before
  the class sums in both), from the initial state and from a mid-run
  state, at torus3d 125,000 x2, ring 131,072 x2 and grid2d 361**2 x2
  (non-wrap, pad lanes);
- whole runs, torus3d 125,000 x2, gossip resumed at round 96 of the
  single-device run: at chunk_rounds=1 bitwise the single-device run
  (rounds, converged count, every plane); at the default CR at the JAX
  schedule's first super-step boundary at or after the single-device
  round, the verdict deferred or not with equal results; push-sum over a
  fixed round count from the fresh start, bitwise and conserving its mass;
  a resume from a chunk boundary onto the same trajectory."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.parallel import fused_sharded as jax_fs

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.ops import fused, rng
from cop5615_gossip_protocol_tpu_torch.ops.topology import lattice_dirs
from cop5615_gossip_protocol_tpu_torch.parallel import fused_sharded, overlap

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

TORUS = 125_000


def _ref(kind):
    return "reference" if kind == "ref2d" else "batched"


@pytest.mark.parametrize("kind,n", [("torus3d", 27_000), ("torus3d", 8),
                                    ("ring", 1000), ("line", 1000),
                                    ("grid2d", 900), ("grid3d", 1000),
                                    ("ref2d", 900)])
def test_disp_planes_are_the_direction_pairs(kind, n):
    """Slot j of the JAX displacement planes is the j-th LIVE direction
    pair of the lattice at that node (csrc/stencil.cuh computes the same
    pairs, tests/test_torch_stencil.py), the degree plane the live count;
    the port's copy of the planes is the JAX function's."""
    jtopo = jax_topology(kind, n, semantics=_ref(kind))
    topo = build_topology(kind, n, semantics=_ref(kind))
    layout = jax_fused_pool.build_pool_layout(topo.n)
    disp, deg = jax_fused_stencil._build_disp_planes(jtopo, layout)
    mine, my_deg = fused_sharded._build_disp_planes(topo, layout)
    np.testing.assert_array_equal(mine, disp)
    np.testing.assert_array_equal(my_deg, deg)
    disp = disp.reshape(disp.shape[0], -1)
    deg = deg.reshape(-1)
    n_lat = topo.n - 1 if int(topo.degree[-1]) == 0 else topo.n
    idx = np.arange(layout.n_pad, dtype=np.int64)
    pairs = lattice_dirs(kind, topo.n, n_lat, idx)
    cum = np.zeros(layout.n_pad, dtype=np.int64)
    for live, d in pairs:
        live = np.asarray(live) & (idx < topo.n)
        slot = np.nonzero(live)[0]
        np.testing.assert_array_equal(disp[cum[slot], slot],
                                      (np.asarray(d) % topo.n)[slot])
        cum += live
    np.testing.assert_array_equal(cum, deg)


# ---------------------------------------------------------------------------
# One super-step against the JAX shard kernel.
# ---------------------------------------------------------------------------


def _planes(n, n_pad, algorithm, state, seed=11):
    """Global [n_pad] planes as numpy: the initial state, or a mid-run
    state made from a seed (push-sum ratios spread, some term counts and
    conv flags set; gossip half the nodes active with counts to the
    target). No float is subnormal."""
    rs = np.random.default_rng(seed)
    real = np.arange(n_pad) < n
    if algorithm == "push-sum":
        s = np.where(real, np.arange(n_pad), 0).astype(np.float32)
        w = np.ones(n_pad, np.float32)
        t = np.zeros(n_pad, np.int32)
        c = np.zeros(n_pad, np.int32)
        if state == "mid":
            s = (s * rs.uniform(0.5, 1.5, n_pad)).astype(np.float32)
            w = (w * rs.uniform(0.25, 2.0, n_pad)).astype(np.float32)
            t = rs.integers(0, 3, n_pad).astype(np.int32)
            c = ((rs.uniform(size=n_pad) < 0.1) & real).astype(np.int32)
        return [s, w, t, c]
    act = np.zeros(n_pad, np.int32)
    act[n // 3] = 1
    cnt = np.zeros(n_pad, np.int32)
    if state == "mid":
        act = ((rs.uniform(size=n_pad) < 0.5) & real).astype(np.int32)
        cnt = (rs.integers(0, 11, n_pad) * act).astype(np.int32)
    return [cnt, act, (cnt >= 10).astype(np.int32)]


def _ext(glob, rows, row0, rows_ext):
    """A shard's extended planes from global [R * 128] planes: extended row
    r is global row (row0 + r) mod R."""
    idx = (row0 + np.arange(rows_ext)) % rows
    return [g.reshape(rows, 128)[idx] for g in glob]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return a.view(np.int32).tobytes() == b.view(np.int32).tobytes()
    return a.dtype == b.dtype and np.array_equal(a, b)


def _jax_keys(start, count):
    keys = np.asarray(jax_fused.round_keys(jax.random.PRNGKey(0), start, count))
    mine = fused.round_keys(rng.PRNGKey(0), start, count)
    assert np.array_equal(keys.astype(np.int64), mine.numpy())
    return keys, mine


SUPERSTEPS = [("torus3d", TORUS, "gossip", "init"), ("torus3d", TORUS, "gossip", "mid"),
              ("torus3d", TORUS, "push-sum", "init"), ("torus3d", TORUS, "push-sum", "mid"),
              ("ring", 131_072, "gossip", "init"), ("ring", 131_072, "push-sum", "mid"),
              ("grid2d", 130_000, "gossip", "mid"), ("grid2d", 130_000, "push-sum", "init")]


@pytest.mark.parametrize("kind,n,algorithm,state", SUPERSTEPS)
def test_superstep_matches_the_jax_kernel(kind, n, algorithm, state):
    """Every shard's middle rows, rounds run and u after one super-step of
    CR = 2 rounds from round 40 (grid2d 361**2: 130,321 nodes, 751 pad
    lanes), bitwise the JAX kernel in interpret mode. Push-sum
    is bitwise because both halve each source before the class sums."""
    S = 2
    kw = dict(n=n, topology=kind, algorithm=algorithm, engine="fused",
              n_devices=S, chunk_rounds=2)
    jtopo, topo = jax_topology(kind, n), build_topology(kind, n)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    H, rows_loc, CR, layout = jax_fs.plan_fused_sharded(jtopo, jcfg, S)
    assert fused_sharded.plan_fused_sharded(topo, cfg, S)[:3] == (H, rows_loc, CR)
    jchunk, rows_ext = jax_fs.make_stencil_shard_chunk(jtopo, jcfg, H, rows_loc,
                                                       layout, interpret=True)
    chunk, my_rows_ext = fused_sharded.make_stencil_shard_chunk(topo, cfg, H,
                                                                rows_loc, layout)
    assert my_rows_ext == rows_ext
    disp, deg = jax_fused_stencil._build_disp_planes(jtopo, layout)
    glob = _planes(topo.n, layout.n_pad, algorithm, state)
    keys, my_keys = _jax_keys(40, CR)
    R = layout.rows
    for dev in range(S):
        row0 = (dev * rows_loc - H + 2 * R) % R
        ext = _ext(glob, R, row0, rows_ext)
        idx = (row0 + np.arange(rows_ext)) % R
        out, ex, conv_mid, u = jchunk(tuple(jnp.asarray(e) for e in ext),
                                      jnp.asarray(keys), row0, 40, 40 + CR,
                                      jnp.asarray(disp[:, idx]), jnp.asarray(deg[idx]))
        mine, my_ex, my_conv_mid, my_u = chunk(
            tuple(torch.from_numpy(e.copy()) for e in ext), my_keys, row0, 40, 40 + CR)
        assert (int(ex), int(conv_mid)) == (my_ex, my_conv_mid) == (CR, int(my_u[CR - 1]))
        assert np.array_equal(np.asarray(u), my_u.numpy()), (dev, u, my_u)
        for a, b in zip(out, mine):
            assert _same(np.asarray(a)[H:H + rows_loc], b[H:H + rows_loc].numpy()), dev


def test_zero_round_superstep_leaves_the_state():
    topo = build_topology("torus3d", TORUS)
    cfg = SimConfig(n=TORUS, topology="torus3d", algorithm="gossip", engine="fused",
                    n_devices=2)
    H, rows_loc, CR, layout = fused_sharded.plan_fused_sharded(topo, cfg, 2)
    chunk, rows_ext = fused_sharded.make_stencil_shard_chunk(topo, cfg, H, rows_loc,
                                                             layout)
    ext = [torch.from_numpy(e.copy()) for e in
           _ext(_planes(TORUS, layout.n_pad, "gossip", "mid"), layout.rows, 0, rows_ext)]
    out, ex, conv_mid, u = chunk(ext, fused.round_keys(rng.PRNGKey(0), 7, CR), 0, 7, 7)
    assert (ex, conv_mid) == (0, 0) and (u == -1).all()
    assert all(torch.equal(a, b) for a, b in zip(out, ext))


# ---------------------------------------------------------------------------
# Whole runs.
# ---------------------------------------------------------------------------


def jax_boundary(single_rounds, start, cr, stride, max_rounds):
    """The round the JAX run of a sharded lattice composition stops at: its
    first super-step boundary at or after ``single_rounds`` (chunks of
    ``stride`` rounds from ``start``, each run as super-steps of ``cr``)."""
    b = start
    while b < single_rounds:
        chunk = start + ((b - start) // stride) * stride
        b = min(b + cr, chunk + stride, max_rounds)
    return b


def same_run(a, b):
    """Rounds, converged count and every canonical plane bitwise."""
    assert (a.rounds, a.converged_count, a.converged) == (
        b.rounds, b.converged_count, b.converged)
    for x, y in zip(a.state, b.state):
        assert _same(x.numpy(), y.numpy())


@functools.lru_cache(maxsize=None)
def _single(algorithm, max_rounds):
    topo = build_topology("torus3d", TORUS)
    return run(topo, SimConfig(n=TORUS, topology="torus3d", algorithm=algorithm,
                               engine="fused", max_rounds=max_rounds), device="cpu")


def _sharded(algorithm, shards=2, start=None, **kw):
    topo = build_topology("torus3d", TORUS)
    cfg = SimConfig(n=TORUS, topology="torus3d", algorithm=algorithm, engine="fused",
                    n_devices=shards, **kw)
    extra = {} if start is None else {"start_state": start.state,
                                      "start_round": start.rounds}
    return run(topo, cfg, devices=["cpu"] * shards, **extra), cfg


def test_gossip_cr1_is_the_single_device_run():
    mid, final = _single("gossip", 96), _single("gossip", 10**6)
    assert final.converged and final.rounds > 96
    res, _ = _sharded("gossip", chunk_rounds=1, start=mid)
    same_run(res, final)


@pytest.mark.parametrize("chunk_rounds,cr,overlap_collectives",
                         [(4096, 4, True), (5, 5, True), (5, 5, False)])
def test_gossip_cr_stops_at_the_jax_boundary(chunk_rounds, cr, overlap_collectives):
    """The default chunk_rounds (CR = 4, whose boundaries meet the
    single-device round) and chunk_rounds=5 (CR = 5, chunks of 40 rounds:
    the run ends past the single-device round), the verdict deferred and
    not."""
    mid, final = _single("gossip", 96), _single("gossip", 10**6)
    res, cfg = _sharded("gossip", start=mid, chunk_rounds=chunk_rounds,
                        overlap_collectives=overlap_collectives)
    H, rows_loc, CR, _ = fused_sharded.plan_fused_sharded(
        build_topology("torus3d", TORUS), cfg, 2)
    assert CR == cr
    want = jax_boundary(final.rounds, 96, CR, cfg.chunk_rounds * 8, cfg.max_rounds)
    assert final.rounds <= res.rounds == want <= final.rounds + CR
    assert res.converged and res.converged_count == TORUS
    if res.rounds == final.rounds:
        same_run(res, final)


def test_pushsum_fixed_rounds_bitwise_and_mass():
    res, _ = _sharded("push-sum", max_rounds=12)
    single = _single("push-sum", 12)
    same_run(res, single)
    s = res.state.s.double().sum().item()
    w = res.state.w.double().sum().item()
    assert abs(w - TORUS) / TORUS < 1e-5
    assert abs(s - TORUS * (TORUS - 1) / 2) / (TORUS * (TORUS - 1) / 2) < 1e-5


def test_resume_from_a_chunk_boundary():
    first, _ = _sharded("push-sum", max_rounds=4, chunk_rounds=2)
    again, _ = _sharded("push-sum", start=first, max_rounds=12, chunk_rounds=2)
    same_run(again, _single("push-sum", 12))


def test_schedule_boundaries_follow_the_jax_chunks():
    """Super-steps of CR from each chunk's start, cut at its end; the host
    batches end on those boundaries."""
    assert [overlap.next_boundary(b, 3, 10, 4, 100) for b in (3, 7, 11, 13, 97)] == [
        7, 11, 13, 17, 100]
    assert jax_boundary(14, 3, 4, 10, 100) == 17
