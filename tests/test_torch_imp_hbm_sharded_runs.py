"""Whole runs of the port's imp x HBM x sharded composition
(cop5615_gossip_protocol_tpu_torch/parallel/fused_imp_hbm_sharded.py) with
its shards placed on the CPU (``devices=["cpu"] * S``), where its wrappers
run their plain versions. A super-step is one round, so every run is the
single-device streaming imp run (the ``imp_hbm`` tier, reached at these
populations by shrinking ops/fused_imp._VMEM_BUDGET to 1000, as the JAX
package's tests do) bitwise: rounds, converged count, every plane.

- imp3d 27,000 gossip in 2 and 4 shards, the verdict deferred and not,
  to convergence; its rounds and converged count also the JAX chunked
  engine's;
- push-sum, 48 rounds, imp3d 27,000 and imp2d 65,536 in 2 and 4 shards;
- a resume from a mid-run state ends at the full run's round on the same
  state; a run from a converged state runs 0 rounds; a max_rounds cap
  is honoured;
- a round queues one absorb a shard and a run one mark prologue a shard
  at each start or resume, counted as wrapper calls;
- the wire alone (parallel/halo.replica_rows), with distinct buffers
  standing in for distinct devices: after the copies every device's
  copy is the global plane."""

import dataclasses
import functools

import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused_imp
from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih
from cop5615_gossip_protocol_tpu_torch.parallel import halo

torch.set_num_threads(1)


@pytest.fixture
def force_hbm(monkeypatch):
    """Shrink the resident imp tier's budget, so the single-device oracle
    is the streaming tier this composition shards."""
    monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)


def _cfg(kind, n, algorithm, **kw):
    return SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                     engine="fused", **kw)


@functools.lru_cache(maxsize=None)
def _topo(kind, n):
    return build_topology(kind, n)


def _single(kind, n, algorithm, max_rounds):
    cfg = _cfg(kind, n, algorithm, max_rounds=max_rounds)
    assert runner.fused_tier(_topo(kind, n), cfg) == ("imp_hbm", None)
    return run(_topo(kind, n), cfg, device="cpu")


def _same_state(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _sharded(kind, n, algorithm, shards, **kw):
    cfg = _cfg(kind, n, algorithm, n_devices=shards, **kw)
    assert runner.sharded_tier(_topo(kind, n), cfg) == ("imp_hbm_sharded", None, "B12")
    return run(_topo(kind, n), cfg, devices=["cpu"] * shards)


@pytest.mark.parametrize("shards", [2, 4])
def test_gossip_runs_are_the_single_device_run(shards, force_hbm):
    n = 27_000
    single = _single("imp3d", n, "gossip", 300)
    jax_res = jax_runner.run(jax_topology("imp3d", n), JaxConfig(
        n=n, topology="imp3d", algorithm="gossip", delivery="pool", engine="chunked",
        chunk_rounds=16, max_rounds=300))
    assert single.converged and (single.rounds, single.converged_count) == (
        jax_res.rounds, jax_res.converged_count)
    for overlap in (True, False):
        res = _sharded("imp3d", n, "gossip", shards, max_rounds=300,
                       overlap_collectives=overlap)
        assert res.converged and res.device == "cpu"
        assert (res.rounds, res.converged_count) == (single.rounds, single.converged_count)
        _same_state(res.state, single.state)


@pytest.mark.parametrize("kind,n", [("imp3d", 27_000), ("imp2d", 65_536)])
def test_pushsum_runs_are_the_single_device_run(kind, n, force_hbm):
    single = _single(kind, n, "push-sum", 48)
    assert single.rounds == 48 and single.outcome == "max_rounds"
    for shards in (2, 4):
        res = _sharded(kind, n, "push-sum", shards, max_rounds=48)
        assert (res.rounds, res.converged_count) == (48, single.converged_count)
        _same_state(res.state, single.state)


def test_resume_converged_state_and_cap(force_hbm):
    n, shards = 27_000, 2
    topo = _topo("imp3d", n)
    full = _sharded("imp3d", n, "gossip", shards, max_rounds=300)
    mid = _sharded("imp3d", n, "gossip", shards, max_rounds=20)
    assert mid.rounds == 20 and not mid.converged and mid.outcome == "max_rounds"
    cfg = _cfg("imp3d", n, "gossip", n_devices=shards, max_rounds=300)
    resumed = run(topo, cfg, devices=["cpu"] * shards, start_state=mid.state,
                  start_round=20)
    assert (resumed.rounds, resumed.converged_count) == (full.rounds, full.converged_count)
    _same_state(resumed.state, full.state)
    again = run(topo, cfg, devices=["cpu"] * shards, start_state=full.state,
                start_round=full.rounds)
    assert again.rounds == full.rounds and again.converged
    _same_state(again.state, full.state)
    # A cap inside a chunk of 8 rounds.
    capped = run(topo, dataclasses.replace(cfg, max_rounds=13), devices=["cpu"] * shards)
    assert capped.rounds == 13 and capped.outcome == "max_rounds"


def test_wrappers_refuse_what_the_kernels_do_not_take():
    topo = _topo("imp3d", 27_000)
    spec = fused_imp.imp_spec(topo)
    R, rows_loc = 512, 256
    mark, nxt_mark = torch.zeros(2, R, 128, dtype=torch.int8).unbind(0)
    own = tuple(torch.zeros(rows_loc, 128, dtype=torch.int32) for _ in range(3))
    out = tuple(torch.empty_like(x) for x in own)
    u, acc, ctrl = (torch.zeros(k, dtype=torch.int32) for k in (1, 2, 2))
    kw = {"spec": spec, "rumor_target": 10, "suppress": False, "u": u, "acc": acc,
          "ctrl": ctrl}
    nxt = ((1, 2), (3, 4))  # the next round's key and choice key
    before = ih.gossip_imp_hbm_shard_absorb.launches
    ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, nxt, own, out, [1, 2, 3, 4], 0, **kw)
    assert ih.gossip_imp_hbm_shard_absorb.launches == before  # the CPU launches nothing
    with pytest.raises(ValueError, match="offs must lie"):
        ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, nxt, own, out, [0, 2, 3, 4], 0,
                                       **kw)
    with pytest.raises(ValueError, match="pool_size"):
        ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, nxt, own, out, [1, 2, 3], 0, **kw)
    with pytest.raises(ValueError, match="outside"):
        ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, nxt, own, out, [1, 2, 3, 4], 300,
                                       **kw)
    with pytest.raises(ValueError, match="mark must be"):
        ih.gossip_imp_hbm_shard_absorb(mark.to(torch.int32), nxt_mark, nxt, own, out,
                                       [1, 2, 3, 4], 0, **kw)
    with pytest.raises(ValueError, match="next mark must be"):
        ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark[:8], nxt, own, out, [1, 2, 3, 4], 0,
                                       **kw)
    with pytest.raises(ValueError, match="two uint32 words"):
        ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, ((1, 2), (-3, 4)), own, out,
                                       [1, 2, 3, 4], 0, **kw)
    with pytest.raises(ValueError, match="two uint32 words"):
        ih.imp_hbm_shard_mark(mark, None, (-1, 0), (0, 0), 0, R, spec=spec,
                              pool_size=4, ctrl=ctrl)
    with pytest.raises(ValueError, match="active must be"):
        ih.imp_hbm_shard_mark(mark, own[0][:8], (1, 0), (0, 0), 0, 16, spec=spec,
                              pool_size=4, ctrl=ctrl)
    # A done flag makes every wrapper a no-op.
    ctrl[0] = 1
    mark.fill_(7)
    ih.imp_hbm_shard_mark(mark, None, (1, 2), (3, 4), 0, R, spec=spec, pool_size=4,
                          ctrl=ctrl)
    nxt_mark.fill_(7)
    ih.gossip_imp_hbm_shard_absorb(mark, nxt_mark, nxt, own, out, [1, 2, 3, 4], 0, **kw)
    assert (mark == 7).all() and (nxt_mark == 7).all()


@pytest.mark.parametrize("algorithm", ["gossip", "push-sum"])
def test_a_round_is_one_launch_a_shard(algorithm, monkeypatch, force_hbm):
    """The launches a run queues, counted as wrapper calls (on the CPU each
    runs its plain version): S absorbs a round (each also writing the
    shard's next marks) and S mark prologues where the run starts or
    resumes, none a round; the resumed run is still the full run."""
    calls = {}
    absorb = ("pushsum" if algorithm == "push-sum" else "gossip") + "_imp_hbm_shard_absorb"
    for name in ("imp_hbm_shard_mark", absorb):
        real = getattr(ih, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(ih, name, spy)
    n, shards = 27_000, 4
    full = _sharded("imp3d", n, algorithm, shards, max_rounds=21)
    assert full.rounds == 21 and not full.converged
    assert calls == {"imp_hbm_shard_mark": shards, absorb: shards * 21}
    calls.clear()
    mid = _sharded("imp3d", n, algorithm, shards, max_rounds=13)
    cfg = _cfg("imp3d", n, algorithm, n_devices=shards, max_rounds=21)
    resumed = run(_topo("imp3d", n), cfg, devices=["cpu"] * shards, start_state=mid.state,
                  start_round=13)
    assert calls == {"imp_hbm_shard_mark": 2 * shards, absorb: shards * 21}
    assert resumed.rounds == 21
    _same_state(resumed.state, full.state)


@pytest.mark.parametrize("shards,devices", [
    (4, ("d0", "d1", "d2", "d3")), (4, ("d0", "d0", "d1", "d1")), (3, ("d0", "d1", "d0")),
])
def test_the_wire_leaves_every_device_copy_whole(shards, devices):
    """replica_rows over one copy per distinct (stand-in) device: each
    copy starts with only its own shards' rows right; after the wire every
    copy is the global plane. Several shards on one device share its
    copy, and one device alone has no wire at all."""
    rows_loc = 8 if shards == 3 else 6
    R = rows_loc * shards
    gen = torch.Generator().manual_seed(0)
    glob = (torch.rand(R, 128, generator=gen),
            torch.randint(-1, 20, (R, 128), generator=gen).to(torch.int8))
    copies = {}
    for dev in dict.fromkeys(devices):
        planes = (torch.full_like(glob[0], -5.0), torch.full_like(glob[1], -9))
        for s, d in enumerate(devices):
            if d == dev:
                rows = slice(s * rows_loc, (s + 1) * rows_loc)
                for x, g in zip(planes, glob):
                    x[rows] = g[rows]
        copies[dev] = planes
    groups = halo.replica_rows(copies, rows_loc, devices)
    distinct = len(copies)
    assert len(groups) == distinct * (distinct - 1)
    halo.exchange_rows_batched(groups)
    for planes in copies.values():
        for x, g in zip(planes, glob):
            assert torch.equal(x, g)
    assert halo.replica_rows({"d0": glob}, rows_loc, ("d0",) * shards) == []


def test_cli_reaches_the_composition(capsys, monkeypatch):
    """``--devices S --engine fused --delivery pool`` on imp reaches the
    composition: nothing in the CLI or the config refuses it. On the CPU
    the one visible device then refuses the placement (shard i goes to
    device i, as the JAX make_mesh); with the placement stubbed to the CPU
    the CLI runs it."""
    from cop5615_gossip_protocol_tpu_torch.cli import main
    from cop5615_gossip_protocol_tpu_torch.parallel import mesh

    argv = ["27000", "imp3d", "gossip", "--delivery", "pool", "--devices", "2",
            "--engine", "fused", "--platform", "cpu", "--max-rounds", "3"]
    assert main(argv) == 2
    assert "1 cpu device(s) visible" in capsys.readouterr().err
    real = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda n, devices=None, platform="cuda": real(n, ["cpu"] * n))
    assert main(argv) == 1  # a bounded sample: max_rounds, not converged
    out = capsys.readouterr().out
    assert '"rounds": 3' in out
