"""The port's chunked engine (cop5615_gossip_protocol_tpu_torch/models/
runner.py, run(..., device="cpu")) with the drop gate, crash-stop with
quorum termination and push-sum's global termination, against the JAX
package's chunked engine: rounds, converged count, outcome, estimate_mae
and every final plane bitwise, on full (pool and scatter delivery) and
grid2d (stencil); imp2d runs in tests/test_torch_runner_faults_imp.py.
Then the ladder: the port's tier and reason are the JAX runner's for each
faulted config, a tier whose kernels carry the knob runs it fused, and a
config the JAX ladder demotes runs the chunked engine on the card; with
n_devices > 1 a config a JAX plan refuses raises the JAX ladder's
ValueError, and global termination on the sharded lattice compositions
runs (ROADMAP A6a-4)."""

import numpy as np
import pytest
import torch

import jax

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_imp as jax_fused_imp
from cop5615_gossip_protocol_tpu.ops import fused_imp_hbm as jax_fused_imp_hbm
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import fused_pool2 as jax_fused_pool2
from cop5615_gossip_protocol_tpu.ops import fused_stencil as jax_fused_stencil
from cop5615_gossip_protocol_tpu.ops import fused_stencil_hbm as jax_fused_stencil_hbm

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused_imp, fused_pool, fused_stencil

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEED = 3

FAULTS = {
    "drop": {"fault_rate": 0.2},
    "schedule": {"crash_schedule": "3:100,6:50", "quorum": 0.95},
    "rate": {"crash_rate": 0.002, "quorum": 0.7},
    "global": {"termination": "global"},
}


def faulted_cases(deliveries):
    return [(kind, n, delivery, algorithm, name)
            for kind, n, delivery, max_rounds in deliveries
            for algorithm in ("push-sum", "gossip")
            for name in FAULTS
            if not (algorithm == "gossip" and name == "global")]


def both_runs(kind, n, delivery, algorithm, max_rounds=None, **kw):
    """(JAX result, its final state, port result) of one config."""
    extra = {} if max_rounds is None else {"max_rounds": max_rounds}
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery,
                  engine="chunked", seed=SEED, **extra, **kw)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n, seed=SEED), JaxConfig(**fields),
                          on_chunk=lambda rounds, st: seen.update(state=st))
    tres = run(build_topology(kind, n, seed=SEED), SimConfig(**fields), device="cpu")
    return jres, seen["state"], tres


def planes_differ(jstate, tstate):
    """Per plane, the nodes where the two final states differ (float planes
    by their bits)."""
    out = {}
    for name in tstate._fields:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        out[name] = a != b
    return out


def assert_same_run(jres, jstate, tres):
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert tres.estimate_mae == jres.estimate_mae
    assert not any(d.any() for d in planes_differ(jstate, tres.state).values())


def drains(kind, algorithm, faults) -> bool:
    """Whether a push-sum run's live nodes can be cut off by dead
    neighbours (a crash model on a sparse graph): they halve their mass
    away into the subnormals."""
    return algorithm == "push-sum" and faults in ("rate", "schedule") and kind != "full"


def early_planes(jres, tres, kind, n, delivery, algorithm, faults):
    """A draining run's checks: the whole run's rounds, counts and outcome
    must be the JAX run's; the runs to round 100 are returned for the
    bitwise checks. The port flushes subnormal results as the JAX round
    jitted on XLA's CPU does (models/pushsum.flush), so these runs are held
    bitwise to their end in tests/test_torch_c1_flush.py, with the one
    exception XLA's scalar remainder loop makes."""
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    return both_runs(kind, n, delivery, algorithm, 100, **FAULTS[faults])


# (kind, n, delivery, max_rounds): grid2d's push-sum runs stop at their
# bound (10,000 rounds or more to converge there).
DELIVERIES = [("full", 1000, "pool", None), ("full", 3001, "scatter", None),
              ("grid2d", 900, "stencil", 600)]
BOUNDS = {(kind, delivery): mr for kind, _, delivery, mr in DELIVERIES}


@pytest.mark.parametrize("kind,n,delivery,algorithm,faults",
                         faulted_cases(DELIVERIES))
def test_chunked_engine_matches_jax(kind, n, delivery, algorithm, faults):
    max_rounds = BOUNDS[kind, delivery] if algorithm == "push-sum" else None
    jres, jstate, tres = both_runs(kind, n, delivery, algorithm, max_rounds,
                                   **FAULTS[faults])
    if drains(kind, algorithm, faults):
        jres, jstate, tres = early_planes(jres, tres, kind, n, delivery, algorithm,
                                          faults)
    assert_same_run(jres, jstate, tres)
    if faults != "drop" and algorithm == "push-sum":
        # Mass parks on the dead: summed over live and dead it is kept.
        w = tres.state.w.double().sum().item()
        assert abs(w - tres.population) < 1e-3 * tres.population


def test_global_termination_converges_everyone_at_once():
    jres, jstate, tres = both_runs("full", 1000, "pool", "push-sum",
                                   termination="global", fault_rate=0.1)
    assert_same_run(jres, jstate, tres)
    assert tres.converged and tres.converged_count == 1000
    assert (tres.state.term == 0).all()


def test_resume_at_the_quorum_runs_no_round():
    kw = dict(n=1000, algorithm="gossip", delivery="pool", crash_rate=0.002,
              quorum=0.8, seed=SEED)
    first = run(build_topology("full", 1000), SimConfig(**kw), device="cpu")
    again = run(build_topology("full", 1000), SimConfig(**kw), device="cpu",
                start_state=first.state, start_round=first.rounds)
    assert first.converged and again.converged
    assert again.rounds == first.rounds
    for a, b in zip(first.state, again.state):
        assert torch.equal(a, b)


# --------------------------------------------------------------- the ladder


def _jax_ladder(jtopo, jcfg):
    """The JAX runner's single-device fused ladder (models/runner.py
    _run_resolved) on its own predicates: (tier, reason)."""
    if jcfg.delivery == "pool" and jtopo.implicit:
        if jtopo.n <= jax_fused_pool.MAX_POOL_NODES:
            return "pool", jax_fused_pool.pool_fused_support(jtopo, jcfg)
        return "pool2", jax_fused_pool2.pool2_support(jtopo, jcfg)
    if jcfg.delivery == "pool":
        reason = jax_fused_imp.imp_fused_support(jtopo, jcfg)
        if reason is not None and jax_fused_imp_hbm.imp_hbm_support(jtopo, jcfg) is None:
            return "imp_hbm", None
        return "imp", reason
    if jax_fused.fused_support(jtopo, jcfg) is None:
        return "stencil", None
    reason = jax_fused_stencil.stencil2_support(jtopo, jcfg)
    if reason is not None and jax_fused_stencil_hbm.stencil_hbm_support(jtopo, jcfg) is None:
        return "stencil_hbm", None
    return "stencil2", reason


@pytest.fixture
def small_pool_cap(monkeypatch):
    """The pool tier's cap at 1000 nodes in both packages, so full 2000
    takes the streaming pool tier (pool2)."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)


@pytest.fixture
def small_stencil2_budget(monkeypatch):
    """The tiled lattice tier's plane budget at 8 MB in both packages, so
    ring 200,000 (13 MB of push-sum planes) takes the streaming lattice tier
    (stencil_hbm) while ring 5000 and torus3d 1000 (3.25 and 4.25 MB) stay
    tiled."""
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


# (kind, n, delivery, knobs, what the port does on the card): "chunked"
# where the JAX ladder demotes, "fused" where the tier's kernels carry the
# knob (the pool tiers and the whole-array lattice tier all three; the
# tiled and streaming lattice tiers and both imp tiers global
# termination); no single-device tier refuses one any more.
LADDER = [
    ("grid2d", 900, "auto", {"fault_rate": 0.1}, "fused"),
    ("line", 1000, "stencil", {"crash_rate": 0.01, "quorum": 0.9}, "fused"),
    ("ring", 5000, "auto", {"fault_rate": 0.1}, "chunked"),
    ("torus3d", 1000, "auto", {"termination": "global"}, "fused"),
    ("ring", 5000, "auto", {"termination": "global"}, "fused"),
    ("imp2d", 900, "pool", {"fault_rate": 0.1}, "chunked"),
    ("imp3d", 1000, "pool", {"crash_schedule": "2:10", "quorum": 0.9}, "chunked"),
    ("imp2d", 900, "pool", {"termination": "global"}, "fused"),
    ("full", 1000, "pool", {"fault_rate": 0.1, "crash_rate": 0.01}, "fused"),
    ("full", 1000, "pool", {"termination": "global"}, "fused"),
    ("full", 2000, "pool", {"fault_rate": 0.1}, "fused"),
    ("full", 2000, "pool", {"termination": "global"}, "fused"),
    ("ring", 200_000, "auto", {"termination": "global"}, "fused"),
]


@pytest.mark.parametrize("kind,n,delivery,knobs,action", LADDER,
                         ids=lambda x: str(x).replace(" ", ""))
def test_ladder_is_the_jax_ladder(kind, n, delivery, knobs, action, small_pool_cap,
                                  small_stencil2_budget, stub_card):
    algorithm = "push-sum"
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery, **knobs)
    jtopo = jax_topology(kind, n)
    topo = build_topology(kind, n)
    tier = runner.fused_tier(topo, SimConfig(**fields))
    assert tier == _jax_ladder(jtopo, JaxConfig(**fields))
    if (kind, n) == ("ring", 200_000):
        assert tier == ("stencil_hbm", None)
    if action == "chunked":
        assert run(topo, SimConfig(**fields)) == "chunked"
        assert stub_card == [torch.device("cuda", 0)]
        with pytest.raises(ValueError, match="engine='fused' unavailable: failure models"):
            run(topo, SimConfig(**fields, engine="fused"), device="cpu")
    else:
        with pytest.raises(AssertionError, match="the fused engine was reached"):
            run(topo, SimConfig(**fields))
    # Scatter delivery never fuses: the chunked engine, on the card too.
    if kind != "full" or delivery != "pool":
        return
    stub_card.clear()
    scatter = dict(fields, delivery="scatter")
    assert run(topo, SimConfig(**scatter)) == "chunked" and stub_card


def test_streaming_imp_tier_refuses_global_termination(monkeypatch, stub_card):
    # The imp tiers carry global termination now (A6a-3): the streaming
    # one, which its JAX tier runs it on, is reached (at a small n by
    # shrinking the resident imp tier's budget in both packages, as
    # tests/test_torch_fused_imp.py does), on the card and under
    # engine="fused", where the CPU runs its plain version.
    monkeypatch.setattr(fused_imp, "_VMEM_BUDGET", 1000)
    monkeypatch.setattr(jax_fused_imp, "_VMEM_BUDGET", 1000)
    fields = dict(n=1000, topology="imp3d", algorithm="push-sum", delivery="pool",
                  termination="global")
    topo = build_topology("imp3d", 1000)
    assert runner.fused_tier(topo, SimConfig(**fields)) == _jax_ladder(
        jax_topology("imp3d", 1000), JaxConfig(**fields)) == ("imp_hbm", None)
    with pytest.raises(AssertionError, match="the fused engine was reached"):
        run(topo, SimConfig(**fields))
    with pytest.raises(AssertionError, match="the fused engine was reached"):
        run(topo, SimConfig(**fields, engine="fused"), device="cpu")


# --------------------------------------------------------- the sharded ladder

def _jax_sharded_error(kind, n, fields):
    """The JAX runner's ValueError for an n_devices > 1 config its plans
    refuse: raised by its ladder on the lattices; on the imp kinds its run
    first asks for the devices, so the text is built from its plan's
    reason as its run words it."""
    from cop5615_gossip_protocol_tpu.parallel import fused_imp_hbm_sharded as jax_ih

    jtopo, jcfg = jax_topology(kind, n), JaxConfig(**fields)
    if kind.startswith("imp"):
        reason = jax_ih.plan_imp_hbm_sharded(jtopo, jcfg, jcfg.n_devices)
        assert isinstance(reason, str)
        return f"engine='fused' with n_devices={jcfg.n_devices} unavailable: {reason}"
    with pytest.raises(ValueError) as err:
        jax_runner.run(jtopo, jcfg)
    return str(err.value)


# Each of the JAX sharded plans' fault gates: the resident and streaming
# lattice compositions (both refuse the drop gate and crash-stop), the imp
# composition (the same).
@pytest.mark.parametrize("kind,n,knobs", [
    ("torus3d", 8000, {"fault_rate": 0.1}),
    ("grid2d", 4096, {"crash_rate": 0.01, "quorum": 0.9}),
    ("imp3d", 4096, {"delivery": "pool", "fault_rate": 0.1}),
    ("imp2d", 4096, {"delivery": "pool", "crash_schedule": "3:10", "quorum": 0.9}),
], ids=lambda x: str(x).replace(" ", ""))
def test_sharded_ladder_raises_the_jax_plans_reasons(kind, n, knobs):
    fields = dict(n=n, topology=kind, algorithm="push-sum", engine="fused", n_devices=2,
                  **knobs)
    want = _jax_sharded_error(kind, n, fields)
    assert "failure models not supported in this fused kernel" in want
    with pytest.raises(ValueError) as err:
        run(build_topology(kind, n), SimConfig(**fields), devices=["cpu"] * 2)
    assert str(err.value) == want


# Global termination on the sharded lattice compositions, whose JAX plans
# take it: refused until their exact-stop verdict (ROADMAP A6a-4), which now
# runs them; a few rounds are the single-device run's
# (tests/test_torch_stencil_sharded_global.py holds whole runs).
@pytest.mark.parametrize("n,tier", [(2**21, "fused_sharded"), (1000, "stencil_hbm_sharded")])
def test_sharded_lattice_global_termination_stays_refused(n, tier):
    fields = dict(n=n, topology="torus3d", algorithm="push-sum", termination="global",
                  max_rounds=3)
    topo = build_topology("torus3d", n)
    cfg = SimConfig(engine="fused", n_devices=2, **fields)
    assert runner.sharded_tier(topo, cfg)[:2] == (tier, None)
    res = run(topo, cfg, devices=["cpu"] * 2)
    single = run(topo, SimConfig(engine="fused", **fields), device="cpu")
    assert res.rounds == single.rounds == 3 and not res.converged
    for a, b in zip(res.state, single.state):
        a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
        assert torch.equal(a, b)
