"""Checkpoint and resume (cop5615_gossip_protocol_tpu_torch/utils/
checkpoint.py, the run's ``on_chunk`` hook) against the JAX package, bitwise:

- a state saved by either package is read by the other's ``load``, and the
  two sidecars of the same state agree on config, config_sha256,
  array_sha256, stream_version, rounds and data_sha256;
- a checkpoint written by either package at a mid-run boundary resumes in
  the other and ends bitwise the uninterrupted run, on the chunked engine
  (pool and scatter delivery, and a crash + revive schedule resumed at its
  revival round) and on the plain versions of rows 1-2, 3-4 and 5-6. Where
  the two packages' runs follow the same trajectory (gossip everywhere, the
  chunked engine's push-sum) the checkpoint crosses in both directions;
  push-sum on a fused tier follows the port's kernel order, not JAX's, so
  there the port's checkpoint is read and written back by JAX and the port
  resumes JAX's file;
- port twins of the JAX package's integrity tests (tests/test_recovery.py):
  the same exception class and the same named arrays, quarantine and
  fall-back, generations, a kill at every fault point (on the chunked
  engine: the JAX configs' n_devices=2 is the sharded XLA engine, ROADMAP
  A10), the ENOSPC spec and the stream-version rule;
- the sharded compositions' checkpoints hold exactly n entries and resume
  under another shard count bitwise (the JAX package's elastic resume);
- the JAX runner's resume refusals, with its texts.
"""

import dataclasses
import errno
import json

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models.runner import run as jax_run
from cop5615_gossip_protocol_tpu.utils import checkpoint as jck

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import pushsum
from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
from cop5615_gossip_protocol_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


class SimulatedCrash(BaseException):
    """A process death inside a save: BaseException, so no except clause of
    the run catches it."""


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(got, want, label=""):
    for f in want._fields:
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
            label, f)


def _port(kind, n, **kw):
    topo = build_topology(kind, n)
    cfg = SimConfig(n=n, topology=kind, **kw)
    snaps = []

    def hook(rounds, state):
        snaps.append((rounds, type(state)(*(x.clone() for x in state))))

    def go(**more):
        return run(topo, cfg, device="cpu", **more)

    return topo, cfg, go(on_chunk=hook), snaps, go


def _jax(kind, n, **kw):
    topo = jax_topology(kind, n)
    cfg = JaxConfig(n=n, topology=kind, **kw)
    snaps = []
    res = jax_run(topo, cfg, on_chunk=lambda r, s: snaps.append((r, s)))
    return topo, cfg, res, snaps


def _sidecar(path):
    return json.loads(open(str(path) + ".json").read())


# ------------------------------------------------------------ the format


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_sidecars_and_archives_read_across_packages(algorithm, tmp_path):
    kw = dict(algorithm=algorithm, delivery="pool", pool_size=2, chunk_rounds=8,
              crash_schedule="3:20", quorum=0.9, max_rounds=24)
    _, cfg, _, snaps, _ = _port("full", 256, **kw)
    _, jcfg, _, jsnaps = _jax("full", 256, **kw)
    (rounds, state), (jrounds, jstate) = snaps[1], jsnaps[1]
    assert rounds == jrounds == 16
    _assert_bitwise(state, jstate)
    ckpt.save(tmp_path / "port.npz", state, rounds, cfg)
    jck.save(tmp_path / "jax.npz", jstate, jrounds, jcfg)
    a, b = _sidecar(tmp_path / "port.npz"), _sidecar(tmp_path / "jax.npz")
    for key in ("format", "generation", "rounds", "stream_version", "data_sha256",
                "array_sha256", "config", "config_sha256"):
        assert a[key] == b[key], key
    js, jr, jc = jck.load(tmp_path / "port.npz")
    ps, pr, pc = ckpt.load(tmp_path / "jax.npz")
    assert jr == pr == 16 and jc == jcfg and pc == cfg
    _assert_bitwise(js, state, "JAX reads the port's")
    _assert_bitwise(ps, jstate, "the port reads JAX's")
    assert type(ps).__name__ == type(jstate).__name__


# Cross-package resume cases: (label, kind, n, the port's config, the JAX
# engine, the boundary index to resume at, whether the two packages' runs
# follow one trajectory). Rows 1-2 and 5-6 are the fused engine's plain
# versions on the CPU (engine="fused"), rows 3-4 the streaming pool tier
# (fused_pool.MAX_POOL_NODES patched to 1000).
RESUME_CASES = [
    ("chunked-pool-pushsum", "full", 256,
     dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=16), 2, True),
    ("chunked-scatter-pushsum", "full", 256,
     dict(algorithm="push-sum", chunk_rounds=16), 3, True),
    ("chunked-scatter-gossip", "full", 1000,
     dict(algorithm="gossip", chunk_rounds=4), 2, True),
    # The revival round is 16, a boundary: the checkpoint holds the stored
    # planes before the round's rejoin reset.
    ("chunked-revive-pushsum", "full", 256,
     dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=8,
          crash_schedule="4:40", revive_schedule="16:30", rejoin="fresh",
          quorum=0.9), 1, True),
    ("chunked-revive-gossip", "full", 256,
     dict(algorithm="gossip", crash_schedule="3:40", revive_schedule="8:40",
          quorum=0.95, chunk_rounds=8), 0, True),
    ("rows12-gossip", "full", 1000,
     dict(algorithm="gossip", delivery="pool", pool_size=2, chunk_rounds=8,
          engine="fused"), 1, True),
    ("rows12-pushsum", "full", 1000,
     dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=32,
          engine="fused", max_rounds=160), 3, False),
    ("rows12-revive-pushsum", "full", 1000,
     dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=8,
          crash_schedule="4:100", revive_schedule="16:60", rejoin="fresh",
          quorum=0.9, engine="fused", max_rounds=64), 1, False),
    ("rows34-gossip", "full", 1500,
     dict(algorithm="gossip", delivery="pool", pool_size=2, chunk_rounds=8,
          engine="fused"), 1, True),
    ("rows34-pushsum", "full", 1500,
     dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=32,
          engine="fused", max_rounds=128), 2, False),
    ("rows56-gossip", "grid2d", 900,
     dict(algorithm="gossip", chunk_rounds=16, engine="fused"), 1, True),
    ("rows56-pushsum", "grid2d", 900,
     dict(algorithm="push-sum", chunk_rounds=16, engine="fused", max_rounds=96), 2, False),
]


@pytest.mark.parametrize("label,kind,n,kw,at,agree", RESUME_CASES,
                         ids=[c[0] for c in RESUME_CASES])
def test_resume_across_packages_bitwise(label, kind, n, kw, at, agree, tmp_path,
                                        monkeypatch):
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    topo, cfg, whole, snaps, go = _port(kind, n, **kw)
    rounds, state = snaps[at]
    assert 0 < rounds < whole.rounds
    if label.startswith("rows34"):
        from cop5615_gossip_protocol_tpu_torch.models.runner import fused_tier

        assert fused_tier(topo, cfg)[0] == "pool2"
    if agree:
        # The JAX side runs its chunked engine on the CPU: the same
        # boundaries (chunks of chunk_rounds), the same trajectory.
        jtopo, jcfg, jwhole, jsnaps = _jax(kind, n, **{**kw, "engine": "chunked"})
        assert [r for r, _ in jsnaps] == [r for r, _ in snaps]
        _assert_bitwise(whole.state, jsnaps[-1][1], label)
        # JAX's checkpoint, resumed in the port.
        jck.save(tmp_path / "jax.npz", jsnaps[at][1], rounds, jcfg)
        st, r0, saved = ckpt.load(tmp_path / "jax.npz")
        assert dataclasses.replace(saved, engine=cfg.engine) == cfg
        again = go(start_state=st, start_round=r0)
        # The port's checkpoint, resumed in JAX.
        ckpt.save(tmp_path / "port.npz", state, rounds, cfg)
        jst, jr0, jsaved = jck.load(tmp_path / "port.npz")
        tail = []
        jagain = jax_run(jtopo, dataclasses.replace(jsaved, engine="chunked"),
                         start_state=jst, start_round=jr0,
                         on_chunk=lambda r, s: tail.append((r, s)))
        assert (jagain.rounds, jagain.converged_count, jagain.outcome) == (
            jwhole.rounds, jwhole.converged_count, jwhole.outcome), label
        assert tail[-1][0] == jwhole.rounds
        _assert_bitwise(tail[-1][1], jsnaps[-1][1], label)
    else:
        # The port's checkpoint, read and written back by JAX, resumed in
        # the port.
        ckpt.save(tmp_path / "port.npz", state, rounds, cfg)
        jst, jr0, jsaved = jck.load(tmp_path / "port.npz")
        jck.save(tmp_path / "jax.npz", jst, jr0, jsaved)
        assert _sidecar(tmp_path / "jax.npz")["data_sha256"] == \
            _sidecar(tmp_path / "port.npz")["data_sha256"]
        st, r0, saved = ckpt.load(tmp_path / "jax.npz")
        assert saved == cfg
        again = go(start_state=st, start_round=r0)
    assert (again.rounds, again.converged_count, again.outcome) == (
        whole.rounds, whole.converged_count, whole.outcome), label
    _assert_bitwise(again.state, whole.state, label)


def test_jax_resume_ends_in_the_jax_state(tmp_path):
    # The port's checkpoint resumed by JAX's chunked engine ends in JAX's
    # uninterrupted final state, every word.
    kw = dict(algorithm="push-sum", delivery="pool", pool_size=2, chunk_rounds=16)
    _, cfg, whole, snaps, _ = _port("full", 256, **kw)
    jtopo, jcfg, jwhole, jsnaps = _jax("full", 256, **kw)
    ckpt.save(tmp_path / "port.npz", snaps[2][1], snaps[2][0], cfg)
    jst, jr0, jsaved = jck.load(tmp_path / "port.npz")
    tail = []
    jax_run(jtopo, jsaved, start_state=jst, start_round=jr0,
            on_chunk=lambda r, s: tail.append((r, s)))
    assert tail[-1][0] == jwhole.rounds == whole.rounds
    _assert_bitwise(tail[-1][1], jsnaps[-1][1])
    _assert_bitwise(whole.state, jsnaps[-1][1])


# ------------------------------------------------------ sharded resumes


@pytest.mark.parametrize("algorithm,n,S,S_to,max_rounds", [
    ("gossip", 120_000, 4, 2, 1_000_000), ("push-sum", 70_000, 2, 1, 40)])
def test_elastic_mesh_resume_bitwise(algorithm, n, S, S_to, max_rounds, tmp_path,
                                     monkeypatch):
    # The replicated-pool2 composition's checkpoint holds n entries, the
    # shards' padding stripped, and resumes under another shard count (one:
    # the single-device streaming pool tier) bitwise the uninterrupted run
    # there.
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    topo = build_topology("full", n)

    def cfg_of(shards):
        return SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2,
                         engine="fused", n_devices=shards if shards > 1 else None,
                         max_rounds=max_rounds)

    def go(shards, **kw):
        devices = ["cpu"] * shards if shards > 1 else None
        return run(topo, cfg_of(shards), device="cpu", devices=devices, **kw)

    snaps = []
    src = go(S, on_chunk=lambda r, s: snaps.append((r, s)))
    assert len(snaps) >= 3
    rounds, state = snaps[1]
    assert rounds == 16 and all(x.shape == (n,) for x in state)
    ckpt.save(tmp_path / "ck.npz", state, rounds, cfg_of(S))
    st, r0, saved = ckpt.load(tmp_path / "ck.npz")
    assert saved == cfg_of(S)
    control = go(S_to)
    again = go(S_to, start_state=st, start_round=r0)
    assert (again.rounds, again.converged_count) == (control.rounds, control.converged_count)
    _assert_bitwise(again.state, control.state)
    _assert_bitwise(src.state, control.state)


def test_lattice_shards_checkpoint_resumes_on_one_device(tmp_path):
    # The resident lattice composition's boundary state (two shards, chunks
    # of chunk_rounds * 8 rounds) resumes on the single-device fused tier
    # bitwise its uninterrupted run.
    n = 125_000
    topo = build_topology("torus3d", n)
    kw = dict(n=n, topology="torus3d", algorithm="gossip", chunk_rounds=1,
              engine="fused", max_rounds=16)
    snaps = []
    sharded = run(topo, SimConfig(**kw, n_devices=2), device="cpu",
                  devices=["cpu"] * 2, on_chunk=lambda r, s: snaps.append((r, s)))
    assert [r for r, _ in snaps] == [8, 16]
    ckpt.save(tmp_path / "ck.npz", snaps[0][1], 8, SimConfig(**kw, n_devices=2))
    st, r0, _ = ckpt.load(tmp_path / "ck.npz")
    single = run(topo, SimConfig(**kw), device="cpu")
    again = run(topo, SimConfig(**kw), device="cpu", start_state=st, start_round=r0)
    assert again.rounds == single.rounds == sharded.rounds == 16
    _assert_bitwise(again.state, single.state)
    _assert_bitwise(sharded.state, single.state)


# ------------------------------------------------------------ refusals


def test_fused_resume_refuses_a_float64_state():
    n = 1000
    st = pushsum.init_state(n, 1)
    st = st._replace(s=st.s.double(), w=st.w.double())
    cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", engine="fused")
    with pytest.raises(ValueError, match=r"fused engine resume requires a float32 "
                       r"checkpoint, got float64; resume with engine='chunked'"):
        run(build_topology("full", n), cfg, device="cpu", start_state=st, start_round=8)


def test_resume_under_the_delay_ring_is_refused():
    n = 256
    cfg = SimConfig(n=n, algorithm="gossip", delay_rounds=2)
    jcfg = JaxConfig(n=n, algorithm="gossip", delay_rounds=2)
    import jax.numpy as jnp
    from cop5615_gossip_protocol_tpu.models import gossip as jgossip
    from cop5615_gossip_protocol_tpu_torch.models import gossip

    st = gossip.init_state(n, 0, False)
    with pytest.raises(ValueError) as err:
        run(build_topology("full", n), cfg, device="cpu", start_state=st, start_round=4)
    with pytest.raises(ValueError) as jerr:
        jax_run(jax_topology("full", n), jcfg, start_state=jgossip.GossipState(
            count=jnp.zeros(n, jnp.int32), active=jnp.zeros(n, bool),
            conv=jnp.zeros(n, bool)), start_round=4)
    assert str(err.value) == str(jerr.value)


# -------------------------------------------- integrity twins (JAX's names)


def _pushsum_checkpoint(tmp_path, rounds=8, **save_kw):
    cfg = SimConfig(n=64, topology="full", algorithm="push-sum", max_rounds=500,
                    chunk_rounds=8)
    snaps = []
    run(build_topology("full", 64), cfg, device="cpu",
        on_chunk=lambda r, s: snaps.append((r, s)))
    path = tmp_path / "ck.npz"
    ckpt.save(path, snaps[0][1], rounds, cfg, **save_kw)
    return path, cfg, snaps[0][1]


def test_checkpoint_mispair_window_refused(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)
    old_archive = path.read_bytes()
    ckpt.save(path, st0, 16, cfg)
    path.write_bytes(old_archive)  # a new sidecar paired with the old archive
    with pytest.raises(ckpt.CheckpointIntegrityError, match="mispaired"):
        ckpt.load(path)
    with pytest.raises(jck.CheckpointIntegrityError, match="mispaired"):
        jck.load(path)


def test_checkpoint_new_rename_order_window_refused(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)

    def kill(point, _path):
        if point == "after-data-rename":
            raise SimulatedCrash(point)

    ckpt.FAULT_HOOK = kill
    try:
        with pytest.raises(SimulatedCrash):
            ckpt.save(path, st0, 16, cfg)
    finally:
        ckpt.FAULT_HOOK = None
    with pytest.raises(ckpt.CheckpointIntegrityError, match="mispaired"):
        ckpt.load(path)


def test_checkpoint_bitflip_names_corrupt_array(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    victim = next(k for k in arrays if not k.startswith("__"))
    flipped = arrays[victim].copy()
    flipped.reshape(-1).view(np.uint8)[0] ^= 0x40
    arrays[victim] = flipped
    np.savez_compressed(path, **arrays)  # digests deliberately not refreshed
    with pytest.raises(ckpt.CheckpointIntegrityError) as ei:
        ckpt.load(path)
    with pytest.raises(jck.CheckpointIntegrityError) as jei:
        jck.load(path)
    assert ei.value.corrupt_arrays == jei.value.corrupt_arrays == (victim,)
    assert ei.value.reason == jei.value.reason


def test_checkpoint_corrupt_sidecar_refused(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)
    sidecar = path.with_suffix(path.suffix + ".json")
    sidecar.write_text(sidecar.read_text()[:-20])  # torn sidecar write
    with pytest.raises(ckpt.CheckpointIntegrityError, match="sidecar"):
        ckpt.load(path)


def test_load_latest_intact_quarantines_and_falls_back(tmp_path):
    cfg = SimConfig(n=64, topology="full", algorithm="push-sum", max_rounds=500,
                    chunk_rounds=8)
    snaps = []
    run(build_topology("full", 64), cfg, device="cpu",
        on_chunk=lambda r, s: snaps.append((r, s)))
    path = tmp_path / "ck.npz"
    ckpt.save(path, snaps[0][1], snaps[0][0], cfg, keep=3)
    ckpt.save(path, snaps[1][1], snaps[1][0], cfg, keep=3)
    newest = ckpt.candidate_paths(path)[0]
    newest.write_bytes(newest.read_bytes()[:200])  # torn write

    events = []
    hit = ckpt.load_latest_intact(path, on_event=lambda **f: events.append(f))
    assert hit is not None
    st, rnds, cfg2, info = hit
    assert rnds == snaps[0][0] and info["generation"] == 0 and cfg2 == cfg
    _assert_bitwise(st, snaps[0][1], "fallback-state")
    [ev] = events
    assert set(ev) >= {"path", "reason", "corrupt_arrays", "quarantined"}
    assert "unreadable" in ev["reason"]
    assert all(p.endswith(".corrupt") for p in ev["quarantined"])
    assert newest not in ckpt.candidate_paths(path)
    assert list(tmp_path.glob("*.corrupt"))


def test_load_latest_intact_none_when_nothing_intact(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)
    path.write_bytes(path.read_bytes()[:100])
    events = []
    assert ckpt.load_latest_intact(path, on_event=lambda **f: events.append(f)) is None
    assert len(events) == 1


def test_checkpoint_generation_retention(tmp_path):
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8, keep=2)
    for rounds in (16, 24, 32):
        info = ckpt.save(path, st0, rounds, cfg, keep=2)
    assert info["generation"] == 3
    gens = ckpt.candidate_paths(path)
    assert len(gens) == 2
    manifest = json.loads((tmp_path / "ck.manifest.json").read_text())
    assert sorted(e["generation"] for e in manifest["generations"]) == [2, 3]
    assert {e["generation"]: e["rounds"] for e in manifest["generations"]}[3] == 32
    assert path.is_symlink()
    assert ckpt.load(path)[1] == 32
    # JAX's save goes on counting the port's generations, and the reverse.
    jst, _, jcfg = jck.load(path)
    assert jck.save(path, jst, 40, jcfg, keep=2)["generation"] == 4
    assert ckpt.save(path, st0, 48, cfg, keep=2)["generation"] == 5


# Configs of the fault-point sweep: the JAX package's, on the chunked engine.
_DURABLE_CFGS = {
    "gossip-crash-revive": dict(
        n=256, topology="full", algorithm="gossip", crash_schedule="3:40",
        revive_schedule="8:40", quorum=0.95, max_rounds=2000, chunk_rounds=8),
    "push-sum": dict(n=256, topology="full", algorithm="push-sum",
                     max_rounds=2000, chunk_rounds=8),
}


@pytest.fixture(scope="module", params=sorted(_DURABLE_CFGS))
def durable_control(request):
    name = request.param
    cfg = SimConfig(**_DURABLE_CFGS[name])
    topo = build_topology(cfg.topology, cfg.n)
    snaps = []
    res = run(topo, cfg, device="cpu", on_chunk=lambda r, s: snaps.append((r, s)))
    assert res.outcome == "converged" and len(snaps) >= 3
    return name, cfg, topo, res, snaps


@pytest.mark.parametrize("point", ckpt.FAULT_POINTS)
def test_kill_at_every_fault_point_recovers_bitwise(durable_control, point, tmp_path):
    name, cfg, topo, control, snaps = durable_control
    path = tmp_path / "ck.npz"
    (r0, st0), (r1, st1) = snaps[0], snaps[1]
    ckpt.save(path, st0, r0, cfg, keep=3)

    def kill(p, _path):
        if p == point:
            raise SimulatedCrash(p)

    ckpt.FAULT_HOOK = kill
    try:
        with pytest.raises(SimulatedCrash):
            ckpt.save(path, st1, r1, cfg, keep=3)
    finally:
        ckpt.FAULT_HOOK = None
    events = []
    hit = ckpt.load_latest_intact(path, on_event=lambda **f: events.append(f))
    assert hit is not None, (name, point)
    st, rnds, cfg2, info = hit
    assert rnds in (r0, r1), (name, point)
    for ev in events:
        assert set(ev) >= {"path", "reason", "corrupt_arrays", "quarantined"}
    tail = []
    resumed = run(topo, cfg2, device="cpu", start_state=st, start_round=rnds,
                  on_chunk=lambda r, s: tail.append((r, s)))
    assert (resumed.rounds, resumed.converged_count, resumed.outcome) == (
        control.rounds, control.converged_count, control.outcome), (name, point)
    fr, fs = tail[-1]
    _assert_bitwise(fs, dict(snaps)[fr], (name, point))


def test_env_fault_enospc_spec(tmp_path, monkeypatch):
    monkeypatch.setenv(ckpt.FAULT_ENV, "enospc:1:1")
    ckpt._ENV_STATE["saves"] = 0
    ckpt._ENV_STATE["enospc_left"] = None
    path, cfg, st0 = _pushsum_checkpoint(tmp_path, rounds=8)  # save 0: ok
    with pytest.raises(OSError) as ei:
        ckpt.save(path, st0, 16, cfg)  # save 1: ENOSPC
    assert ei.value.errno == errno.ENOSPC
    ckpt.save(path, st0, 24, cfg)  # save 2: the budget is spent
    assert ckpt.load(path)[1] == 24


def test_checkpoint_stream_v5_sensitivity(tmp_path):
    cfg = SimConfig(n=64, topology="full", algorithm="push-sum", byzantine_rate=0.05,
                    byzantine_mode="mass_inflate")
    st = pushsum.init_state(64, 0)
    for byz, refused in ((0.05, True), (0.0, False)):
        path = tmp_path / f"old_{byz}.npz"
        ckpt.save(path, st, 8, dataclasses.replace(cfg, byzantine_rate=byz))
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["__stream__"] = np.asarray(4)
        np.savez_compressed(path, **arrays)
        ckpt._refresh_digests(path)
        if refused:
            with pytest.raises(ValueError, match="stream") as err:
                ckpt.load(path)
            with pytest.raises(ValueError) as jerr:
                jck.load(path)
            assert str(err.value) == str(jerr.value)
        else:
            assert ckpt.load(path)[1] == jck.load(path)[1] == 8
