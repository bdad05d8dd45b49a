"""Crash-recovery (revive_rate / revive_schedule with rejoin) in the port's
engines on the CPU, against the JAX package, bitwise unless said:

- whole runs of the chunked engine (cop5615_gossip_protocol_tpu_torch/
  models/runner.py) under every delivery (pool on full, stencil on torus3d
  and grid2d, imp pool on imp2d, scatter on full and imp2d), both
  algorithms, push-sum rejoining fresh and restoring, revivals drawn by a
  schedule and by a rate, against the JAX chunked engine: rounds, converged
  count, outcome, estimate and every plane. A push-sum run on a sparse
  graph whose live nodes the dead cut off drains into the subnormals, which
  the port keeps and XLA's jitted CPU round flushes in part (the caveat of
  tests/test_torch_runner_faults.py ``early_planes``): such a run
  must equal the JAX run in rounds, counts and outcome, and its planes are
  held bitwise on a run of 100 rounds;
- the plain versions of the pool kernels (rows 1-2) and the whole-array
  lattice kernels (rows 5-6) with a revival plane, one chunk against the
  JAX tiers' Pallas kernels in interpret mode: from the initial state
  across death and revival rounds, capped just before and just after a
  revival round, and resumed at one;
- whole runs of the fused engine (those plain versions) against the port's
  chunked engine and the JAX chunked engine;
- a run cut just before a revival round and resumed there lands on the
  whole run's state;
- fresh rejoins that end the run with w = 0 on some node: the estimate
  leaves them out (``_finalize_result``), as JAX's does;
- the ladder: revive on the streaming pool tier (pool2), the replicated
  pool2 and the fused pool compositions, the tiled and streaming lattice
  tiers, both imp tiers and the sharded lattice and imp plans gives the JAX
  tier and reason, and where the JAX ladder demotes, the port runs its
  chunked engine, on the card too.
"""

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused_imp, fused_pool, fused_stencil

from test_torch_fused_pool import assert_bitwise, run_case
from test_torch_resident_faults import _assert_bitwise, _both_chunks
from test_torch_runner_faults import _jax_ladder, _jax_sharded_error, planes_differ

torch.set_num_threads(1)

SEED = 3

REVIVES = {
    "fresh schedule": {"crash_schedule": "3:100,6:50", "revive_schedule": "10:60,20:40",
                       "rejoin": "fresh", "quorum": 0.95},
    "restore rate": {"crash_rate": 0.01, "revive_rate": 0.1, "quorum": 0.9},
    "fresh rate": {"crash_rate": 0.005, "revive_rate": 0.2, "rejoin": "fresh",
                   "quorum": 0.9},
    "restore schedule": {"crash_schedule": "2:80,9:40", "revive_schedule": "5:30,12:70",
                         "quorum": 0.9},
}


def both_runs(kind, n, delivery, algorithm, revive, max_rounds=None, engine="chunked"):
    """(JAX chunked-engine result, its final state, the port's result)."""
    extra = {} if max_rounds is None else {"max_rounds": max_rounds}
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery, seed=SEED,
                  **REVIVES[revive], **extra)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n, seed=SEED),
                          JaxConfig(engine="chunked", **fields),
                          on_chunk=lambda rounds, st: seen.update(state=st))
    tres = run(build_topology(kind, n, seed=SEED), SimConfig(engine=engine, **fields),
               device="cpu")
    return jres, seen["state"], tres


def assert_same_run(jres, jstate, tres):
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert tres.estimate_mae == jres.estimate_mae
    assert not any(d.any() for d in planes_differ(jstate, tres.state).values())


def drains(kind, algorithm):
    """Whether dead nodes can cut a push-sum run's live nodes off (a sparse
    graph): they then halve their mass away into the subnormals."""
    return algorithm == "push-sum" and kind != "full"


# (kind, n, delivery, push-sum's max_rounds): the lattices' push-sum runs
# stop at their bound.
DELIVERIES = [("full", 1000, "pool", None), ("full", 3001, "scatter", None),
              ("torus3d", 1000, "stencil", 400), ("grid2d", 900, "stencil", 400),
              ("imp2d", 1024, "pool", None), ("imp2d", 1024, "scatter", None)]
CASES = [(kind, n, delivery, mr, algorithm, revive)
         for kind, n, delivery, mr in DELIVERIES
         for algorithm in ("push-sum", "gossip")
         for revive in ("fresh schedule", "restore rate")]


@pytest.mark.parametrize("kind,n,delivery,max_rounds,algorithm,revive", CASES,
                         ids=lambda x: str(x).replace(" ", "_"))
def test_chunked_engine_matches_jax(kind, n, delivery, max_rounds, algorithm, revive):
    mr = max_rounds if algorithm == "push-sum" else None
    jres, jstate, tres = both_runs(kind, n, delivery, algorithm, revive, mr)
    if drains(kind, algorithm):
        assert (tres.rounds, tres.converged_count, tres.outcome) == (
            jres.rounds, jres.converged_count, jres.outcome)
        jres, jstate, tres = both_runs(kind, n, delivery, algorithm, revive, 100)
    assert_same_run(jres, jstate, tres)
    if algorithm == "push-sum" and "restore" in revive:
        # Restoring rejoins keep the mass over live, dead and revived nodes.
        w = tres.state.w.double().sum().item()
        assert abs(w - tres.population) < 1e-3 * tres.population


@pytest.mark.parametrize("kind,n,delivery", [("full", 1000, "pool"), ("full", 3001, "scatter")])
@pytest.mark.parametrize("revive", ["fresh rate", "restore schedule"])
def test_chunked_engine_other_revivals_match_jax(kind, n, delivery, revive):
    for algorithm in ("push-sum", "gossip"):
        assert_same_run(*both_runs(kind, n, delivery, algorithm, revive))


# ----------------------------------------------------- the kernels' plain versions

POOL_FRESH = {"crash_schedule": "1:100,3:50", "revive_schedule": "4:60,6:40",
              "rejoin": "fresh", "quorum": 0.95}
POOL_RESTORE = {"crash_rate": 0.05, "revive_rate": 0.3, "quorum": 0.9}

# (algorithm, n, pool_size, knobs, start, cap_after, mid_round): the 8-round
# chunks cross the deaths and the revivals at rounds 4 and 6; caps end
# before (4) and after (5) the first revival; "mid" at 4 resumes at it.
POOL_CASES = [
    ("push-sum", 1000, 2, POOL_FRESH, "init", None, None),
    ("push-sum", 1000, 2, POOL_FRESH, "init", 4, None),
    ("push-sum", 70000, 4, POOL_FRESH, "init", 5, None),
    ("push-sum", 1000, 2, POOL_FRESH, "mid", None, 4),
    ("push-sum", 65536, 2, POOL_RESTORE, "init", None, None),
    ("push-sum", 1000, 4, POOL_RESTORE, "mid", 3, 6),
    ("gossip", 1000, 2, POOL_FRESH, "init", None, None),
    ("gossip", 70000, 2, POOL_FRESH, "mid", 5, 4),
    ("gossip", 1000, 4, POOL_RESTORE, "init", 5, None),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pool_chunk_matches_the_jax_kernel(case):
    algorithm, n, pool_size, kw, start_kind, cap_after, mid_round = case
    jout, jex, tout, tex, start, planes = run_case(
        algorithm, n, pool_size, "batched", start_kind, cap_after, mid_round, kw)
    assert jex == tex == (8 if cap_after is None else cap_after)
    assert_bitwise(jout, tout)
    assert any((a != b).any() for a, b in zip(jout, planes))


RES_FRESH = {"crash_schedule": "41:100,43:50", "revive_schedule": "44:60,46:40",
             "rejoin": "fresh", "quorum": 0.9}
RES_RESTORE = {"crash_rate": 0.02, "revive_rate": 0.3, "quorum": 0.8}

# (kind, n, algorithm, knobs, start, cap_after): rows 5-6 on a non-wrap
# lattice whose n is no multiple of 128 (line 1000, grid2d 900) and a wrap
# one whose n is (torus3d 512); starts at round 40 or 44 (a revival round).
RESIDENT_CASES = [
    ("line", 1000, "push-sum", RES_FRESH, 40, None),
    ("line", 1000, "push-sum", RES_FRESH, 40, 4),
    ("line", 1000, "push-sum", RES_FRESH, 40, 5),
    ("grid2d", 900, "push-sum", RES_FRESH, 44, None),
    ("grid2d", 900, "push-sum", RES_RESTORE, 20, 5),
    ("torus3d", 512, "push-sum", RES_FRESH, 40, None),
    ("line", 1000, "gossip", RES_FRESH, 40, None),
    ("grid2d", 900, "gossip", RES_FRESH, 44, 3),
    ("torus3d", 512, "gossip", RES_RESTORE, 3, None),
]


@pytest.mark.parametrize("kind,n,algorithm,knobs,start,cap_after", RESIDENT_CASES,
                         ids=lambda x: str(x).replace(" ", ""))
def test_resident_chunk_matches_the_jax_kernel(kind, n, algorithm, knobs, start, cap_after):
    jout, jex, out, executed, planes, _ = _both_chunks(kind, n, "stencil", algorithm,
                                                       knobs, start, cap_after)
    assert executed == jex == (8 if cap_after is None else cap_after)
    _assert_bitwise(out, jout)
    assert any(not torch.equal(a, b) for a, b in zip(out, planes))


@pytest.mark.parametrize("kind,n,delivery,max_rounds", [
    ("full", 1000, "pool", None), ("grid2d", 900, "auto", 300), ("line", 1000, "auto", 300)])
@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_fused_engine_runs_match_the_chunked_engine_and_jax(kind, n, delivery, max_rounds,
                                                           algorithm):
    # Gossip on a lattice may never reach the quorum with nodes dead for good.
    mr = max_rounds if algorithm == "push-sum" or kind == "full" else 2000
    jres, jstate, fres = both_runs(kind, n, delivery, algorithm, "fresh schedule", mr,
                                   engine="fused")
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery, seed=SEED,
                  **REVIVES["fresh schedule"], **({} if mr is None else {"max_rounds": mr}))
    cres = run(build_topology(kind, n, seed=SEED), SimConfig(engine="chunked", **fields),
               device="cpu")
    assert (fres.rounds, fres.converged_count, fres.estimate_mae) == (
        cres.rounds, cres.converged_count, cres.estimate_mae)
    assert not any(d.any() for d in planes_differ(cres.state, fres.state).values())
    if drains(kind, algorithm):
        assert (fres.rounds, fres.converged_count) == (jres.rounds, jres.converged_count)
        jres, jstate, fres = both_runs(kind, n, delivery, algorithm, "fresh schedule", 100,
                                       engine="fused")
    assert_same_run(jres, jstate, fres)


@pytest.mark.parametrize("engine,kind,delivery", [
    ("chunked", "full", "pool"), ("chunked", "full", "scatter"), ("chunked", "grid2d", "auto"),
    ("fused", "full", "pool"), ("fused", "grid2d", "auto")])
@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_resume_at_a_revival_round(engine, kind, delivery, algorithm):
    n = 900 if kind == "grid2d" else 1000
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery, seed=SEED,
                  engine=engine, **REVIVES["fresh schedule"])
    if kind == "grid2d" and algorithm == "push-sum":
        fields["max_rounds"] = 200
    topo = build_topology(kind, n, seed=SEED)
    whole = run(topo, SimConfig(**fields), device="cpu")
    for cut in (10, 20):  # the revival rounds: the cut state is un-reset
        part = run(topo, SimConfig(**{**fields, "max_rounds": cut}), device="cpu")
        assert part.rounds == cut and not part.converged
        rest = run(topo, SimConfig(**fields), device="cpu", start_state=part.state,
                   start_round=part.rounds)
        assert (rest.rounds, rest.converged_count, rest.estimate_mae) == (
            whole.rounds, whole.converged_count, whole.estimate_mae)
        for a, b in zip(rest.state, whole.state):
            a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
            assert torch.equal(a, b)


@pytest.mark.parametrize("delivery,engine", [("pool", "chunked"), ("scatter", "chunked"),
                                             ("pool", "fused")])
def test_fresh_rejoins_with_no_weight_leave_the_estimate(delivery, engine):
    # Revivals at round 40, and the run cut right after it: a fresh node
    # that received nothing in round 40 ends with w = 0 (its ratio is no
    # number) and is not converged, so the estimate leaves it out.
    kw = {"crash_schedule": "3:300", "revive_schedule": "40:200", "rejoin": "fresh",
          "quorum": 0.9, "max_rounds": 41}
    fields = dict(n=1000, algorithm="push-sum", delivery=delivery, seed=SEED, **kw)
    seen = {}
    jres = jax_runner.run(jax_topology("full", 1000), JaxConfig(engine="chunked", **fields),
                          on_chunk=lambda r, st: seen.update(state=st))
    tres = run(build_topology("full", 1000), SimConfig(engine=engine, **fields),
               device="cpu")
    assert_same_run(jres, seen["state"], tres)
    zero = tres.state.w == 0
    assert zero.any() and not tres.state.conv[zero].any()
    assert tres.estimate_mae is not None and np.isfinite(tres.estimate_mae)


# ------------------------------------------------------------------ the ladder

@pytest.fixture
def small_caps(monkeypatch):
    """Every tier's cap small in both packages: full 2000 takes pool2, ring
    200,000 the streaming lattice tier, imp3d 1000 the streaming imp tier."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(fused_stencil, "_VMEM_BUDGET", 8 * 2**20)
    monkeypatch.setattr(jax_fused_stencil, "_VMEM_BUDGET", 8 * 2**20)


@pytest.fixture
def stub_card(monkeypatch):
    """A run that resolves to cuda:0 with no card: the fused engine raises
    if reached, the chunked engine records its device and returns."""
    monkeypatch.setattr(runner, "resolve_device", lambda device=None: torch.device("cuda", 0))
    reached = []

    def fused(*args, **kwargs):
        raise AssertionError("the fused engine was reached")

    def chunked(topo, cfg, key, device, *args):
        reached.append(device)
        return "chunked"

    monkeypatch.setattr(runner, "_run_fused", fused)
    monkeypatch.setattr(runner, "_run_chunked", chunked)
    return reached


RESTORE = {"crash_rate": 0.01, "revive_rate": 0.2, "quorum": 0.9}

# (kind, n, delivery, imp budget shrunk, what the port does on the card).
LADDER = [
    ("full", 1000, "pool", False, "fused"),  # rows 1-2 carry revive
    ("full", 2000, "pool", False, "chunked"),  # pool2 refuses it, as in JAX
    ("grid2d", 900, "auto", False, "fused"),  # rows 5-6 carry it
    ("ring", 5000, "auto", False, "chunked"),  # stencil2: faulted
    ("ring", 200_000, "auto", False, "chunked"),  # stencil_hbm: faulted
    ("imp3d", 1000, "pool", False, "chunked"),  # imp: faulted
    ("imp3d", 1000, "pool", True, "chunked"),  # imp_hbm: faulted
]


@pytest.mark.parametrize("kind,n,delivery,imp_hbm,action", LADDER,
                         ids=lambda x: str(x).replace(" ", ""))
def test_ladder_is_the_jax_ladder(kind, n, delivery, imp_hbm, action, small_caps,
                                  stub_card, monkeypatch):
    if imp_hbm:
        monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)
        monkeypatch.setattr(jax_fused_imp, "_VMEM_BUDGET", 1000)
    fields = dict(n=n, topology=kind, algorithm="push-sum", delivery=delivery, **RESTORE)
    topo = build_topology(kind, n)
    tier = runner.fused_tier(topo, SimConfig(**fields))
    assert tier == _jax_ladder(jax_topology(kind, n), JaxConfig(**fields))
    if (kind, n) == ("full", 2000):
        assert tier[0] == "pool2" and "crash-recovery (revive)" in tier[1]
    if action == "chunked":
        assert tier[1] is not None
        assert run(topo, SimConfig(**fields)) == "chunked"
        assert stub_card == [torch.device("cuda", 0)]
        with pytest.raises(ValueError, match="engine='fused' unavailable"):
            run(topo, SimConfig(**fields, engine="fused"), device="cpu")
    else:
        assert tier[1] is None
        with pytest.raises(AssertionError, match="the fused engine was reached"):
            run(topo, SimConfig(**fields))


@pytest.mark.parametrize("n", [1000, 4096])
def test_sharded_pool_plans_refuse_revive_as_jax(n, small_caps):
    fields = dict(n=n, algorithm="push-sum", delivery="pool", engine="fused", n_devices=2,
                  **RESTORE)
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology("full", n), JaxConfig(**fields))
    with pytest.raises(ValueError) as err:
        run(build_topology("full", n), SimConfig(**fields), devices=["cpu"] * 2)
    assert str(err.value) == str(jerr.value)
    assert "crash-recovery (revive)" in str(err.value)


@pytest.mark.parametrize("kind,n,knobs", [
    ("torus3d", 8000, {}), ("torus3d", 125_000, {}),
    ("imp3d", 4096, {"delivery": "pool"}),
], ids=lambda x: str(x).replace(" ", ""))
def test_sharded_lattice_and_imp_plans_refuse_revive_as_jax(kind, n, knobs):
    fields = dict(n=n, topology=kind, algorithm="push-sum", engine="fused", n_devices=2,
                  **RESTORE, **knobs)
    want = _jax_sharded_error(kind, n, fields)
    with pytest.raises(ValueError) as err:
        run(build_topology(kind, n), SimConfig(**fields), devices=["cpu"] * 2)
    assert str(err.value) == want


def test_streaming_pool_wrappers_refuse_a_revival_plane():
    # The JAX pool2 tier refuses crash-recovery; its kernels' wrappers do
    # too, on any device, rather than run crash-stop quietly.
    from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool2

    n = 2000
    cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", pool_size=2, **RESTORE)
    faults = fused.run_faults(cfg, n)
    layout = fused_pool.build_pool_layout(n)
    planes = tuple(torch.zeros(layout.rows, 128, dtype=dt) for dt in
                   (torch.float32, torch.float32, torch.int32, torch.int32))
    keys = torch.zeros(8, 2, dtype=torch.int64)
    offs = torch.ones(8, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="crash-recovery"):
        fused_pool2.pushsum_pool2_chunk(planes, keys, offs, 0, 8, n=n, target=n, delta=1e-6,
                                        term_rounds=3, faults=faults)
    with pytest.raises(ValueError, match="crash-recovery"):
        fused_pool2.gossip_pool2_chunk(planes[2:] + planes[3:], keys, offs, 0, 8, n=n,
                                       target=n, rumor_target=10, suppress=False,
                                       faults=faults)
