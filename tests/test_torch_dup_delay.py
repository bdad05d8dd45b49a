"""Duplicate delivery and the delay ring (``dup_rate``, ``delay_rounds``) in
the port's chunked engine (models/runner.py, ops/scatter.py's plain
versions; run(..., device="cpu")) against the JAX package's chunked engine:

- ``sampling.dup_gate`` against the JAX draw, bitwise;
- one round's float order near FLT_MIN against the JAX round jitted on
  XLA's CPU: with the dup gate or the ring XLA folds no scatter onto a
  kept half, each inbox sums from 0 and the two inboxes of a dup round
  add; stencil delivery keeps ``s - s_send`` (and ``w - w_send`` under
  global termination) unless the ring is on, when every delivery keeps
  both halves in the where form (models/pushsum.halve_and_send);
- whole runs on line 200, grid2d 400 (stencil and scatter), full 1000 and
  imp2d 900 (scatter), both algorithms, dup and delay alone and together
  and with the drop gate, crash-stop with quorum, crash-recovery, a
  Byzantine model, clip, global termination and telemetry: rounds, counts,
  outcome, estimate and every plane bitwise, the telemetry rows too
  (column 7, dup_count, among them);
- the health sentinel under the ring (Σw over the state and the ring);
- mass over the state and the ring conserved under delay alone;
- the refusals, each with the JAX text: config values out of range,
  reference semantics, mass_tolerance with dup, dup/delay under pool and
  matmul delivery, and resume with a ring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.models.pushsum import PushSumState as JaxPushSum
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import pipeline, pushsum, runner
from cop5615_gossip_protocol_tpu_torch.ops import delivery, rng, sampling

torch.set_num_threads(1)

SEED = 3
FLT_MIN = np.float32(1.17549435e-38)


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.5, 0.999])
def test_dup_gate_is_jax(rate):
    for rnd in (0, 7, 2**20):
        jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), rnd)
        tkey = sampling.round_key(rng.PRNGKey(SEED), rnd)
        want = jax_sampling.dup_gate(jkey, 1000, rate)
        got = sampling.dup_gate(tkey, 1000, rate)
        if rate == 0.0:
            assert want is False and got is False
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fields(kind, n, algorithm, delivery_, **kw):
    return dict(n=n, topology=kind, algorithm=algorithm, delivery=delivery_,
                engine="chunked", seed=SEED, **kw)


def _one_round(kind, delivery_, glob, dup, delay):
    """(JAX round's output carry, port round's output carry) from one
    crafted state near FLT_MIN (halves subnormal) and a crafted ring."""
    n = 1024
    fields = _fields(kind, n, "push-sum", delivery_, dup_rate=dup,
                     delay_rounds=delay,
                     termination="global" if glob else "local")
    r = np.random.default_rng(1)
    s = ((1 + 3 * r.random(n)) * FLT_MIN).astype(np.float32)
    w = ((1 + 3 * r.random(n)) * FLT_MIN).astype(np.float32)
    ring = ((1 + 3 * r.random((max(delay, 1), 2, n))) * FLT_MIN).astype(np.float32)
    jtopo = jax_topology(kind, n, seed=SEED)
    key = jax.random.PRNGKey(SEED)
    round_fn, _, kd, targs = jax_runner.make_round_fn(jtopo, JaxConfig(**fields), key)
    jst = JaxPushSum(jnp.asarray(s), jnp.asarray(w), jnp.zeros(n, jnp.int32),
                     jnp.zeros(n, bool))
    carry = (jst, jnp.asarray(ring)) if delay else jst
    jout = jax.jit(round_fn)(carry, jnp.int32(5), kd, *targs)

    chunk_fn, _ = runner._make_chunk_fn(
        build_topology(kind, n, seed=SEED), SimConfig(**fields), rng.PRNGKey(SEED),
        torch.device("cpu"), n)
    tst = pushsum.PushSumState(torch.tensor(s), torch.tensor(w),
                               torch.zeros(n, dtype=torch.int32),
                               torch.zeros(n, dtype=torch.bool))
    tcarry = pipeline.Ringed(tst, torch.tensor(ring)) if delay else tst
    status = torch.tensor([5, 0], dtype=torch.int32)
    tout = chunk_fn(tcarry, status, 5, 6)[0]
    return jout, tout


@pytest.mark.parametrize("kind,delivery_", [("full", "scatter"), ("imp2d", "scatter"),
                                            ("grid2d", "stencil"), ("line", "stencil")])
@pytest.mark.parametrize("glob", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("dup,delay", [(0.3, 0), (0.0, 3), (0.3, 3)])
def test_round_float_order_near_flt_min_is_jax(kind, delivery_, glob, dup, delay):
    jout, tout = _one_round(kind, delivery_, glob, dup, delay)
    jst = jout[0] if delay else jout
    tst = pipeline.proto_of(tout)
    for name in ("s", "w"):
        np.testing.assert_array_equal(
            getattr(tst, name).numpy().view(np.int32),
            np.asarray(getattr(jst, name)).view(np.int32), err_msg=name)
    if delay:
        np.testing.assert_array_equal(tout.ring.numpy().view(np.int32),
                                      np.asarray(jout[1]).view(np.int32))


@pytest.mark.parametrize("kind", ["grid2d", "line"])
def test_stencil_global_keeps_w_minus_its_send(kind):
    # The plain stencil round under global termination (no dup, no ring):
    # XLA keeps w - w_send there (ROADMAP C3).
    jout, tout = _one_round(kind, "stencil", True, 0.0, 0)
    for name in ("s", "w"):
        np.testing.assert_array_equal(getattr(tout, name).numpy().view(np.int32),
                                      np.asarray(getattr(jout, name)).view(np.int32))


def both_runs(kind, n, delivery_, algorithm, **kw):
    """(JAX result, its final protocol state, port result) of one config."""
    fields = _fields(kind, n, algorithm, delivery_, **kw)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n, seed=SEED), JaxConfig(**fields),
                          on_chunk=lambda rounds, st: seen.update(state=st))
    tres = run(build_topology(kind, n, seed=SEED), SimConfig(**fields), device="cpu")
    return jres, seen["state"], tres


def assert_same_run(jres, jstate, tres):
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert tres.estimate_mae == jres.estimate_mae
    assert tres.unhealthy_round == jres.unhealthy_round
    for name in tres.state._fields:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tres.state, name).numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=name)
    if jres.telemetry is not None:
        np.testing.assert_array_equal(tres.telemetry.data.view(np.int32),
                                      np.asarray(jres.telemetry.data).view(np.int32))


BASES = [("line", 200, "stencil"), ("grid2d", 400, "stencil"),
         ("grid2d", 400, "scatter"), ("full", 1000, "scatter"),
         ("imp2d", 900, "scatter")]
ALONE = {"dup": {"dup_rate": 0.1}, "delay": {"delay_rounds": 3},
         "both": {"dup_rate": 0.1, "delay_rounds": 3}}


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
@pytest.mark.parametrize("mix", sorted(ALONE))
@pytest.mark.parametrize("kind,n,delivery_", BASES)
def test_dup_and_delay_match_jax(kind, n, delivery_, mix, algorithm):
    # Push-sum on the lattices takes thousands of rounds: bounded at 300.
    jres, jstate, tres = both_runs(kind, n, delivery_, algorithm,
                                   max_rounds=300, **ALONE[mix])
    assert_same_run(jres, jstate, tres)


WITH = {
    "gate": {"fault_rate": 0.2},
    "crash": {"crash_schedule": "3:40,6:20", "quorum": 0.9},
    "revive": {"crash_schedule": "3:40,6:20", "revive_schedule": "12:30",
               "rejoin": "fresh", "quorum": 0.9},
    "byzantine": {"byzantine_schedule": "4:10"},
    "clip": {"byzantine_schedule": "4:10", "robust_agg": "clip"},
    "global": {"termination": "global"},
    "telemetry": {"telemetry": True, "fault_rate": 0.1,
                  "crash_schedule": "5:30", "quorum": 0.9},
}


def with_cases():
    out = []
    for mix in sorted(WITH):
        for algorithm in ("push-sum", "gossip"):
            if algorithm == "gossip" and mix in ("clip", "global"):
                continue
            for kind, n, delivery_ in (("full", 1000, "scatter"),
                                       ("grid2d", 400, "stencil"),
                                       ("imp2d", 900, "scatter")):
                out.append((kind, n, delivery_, algorithm, mix))
    return out


@pytest.mark.parametrize("kind,n,delivery_,algorithm,mix", with_cases())
def test_dup_delay_with_the_failure_model_match_jax(kind, n, delivery_, algorithm,
                                                     mix):
    kw = dict(WITH[mix])
    if "byzantine_schedule" in kw:
        kw["byzantine_mode"] = ("mass_deflate" if algorithm == "push-sum"
                                else "stale_rumor")
    jres, jstate, tres = both_runs(kind, n, delivery_, algorithm, max_rounds=300,
                                   dup_rate=0.05, delay_rounds=2, **kw)
    assert_same_run(jres, jstate, tres)
    if mix == "telemetry":
        dups = tres.telemetry.data[:, 7]
        assert dups.sum() > 0


@pytest.mark.parametrize("kind,n,delivery_", [("full", 1000, "scatter"),
                                              ("grid2d", 400, "stencil")])
@pytest.mark.parametrize("adversary", [False, True], ids=["honest", "garble"])
def test_sentinel_counts_the_ring(kind, n, delivery_, adversary):
    # Under the ring the sentinel's Σw is the state's plus the ring's: an
    # honest run stays healthy at a tight tolerance (about half the mass is
    # in flight every round), and a garbling adversary trips it at JAX's
    # round.
    byz = ({"byzantine_schedule": "20:5", "byzantine_mode": "garble"}
           if adversary else {})
    jres, jstate, tres = both_runs(kind, n, delivery_, "push-sum", max_rounds=200,
                                   delay_rounds=3, mass_tolerance=1e-2, **byz)
    assert_same_run(jres, jstate, tres)
    assert (tres.outcome == "unhealthy") == adversary


@pytest.mark.parametrize("kind,n,delivery_", [("full", 1000, "scatter"),
                                              ("grid2d", 400, "stencil")])
def test_mass_over_state_and_ring_is_conserved(kind, n, delivery_):
    cfg = SimConfig(**_fields(kind, n, "push-sum", delivery_, delay_rounds=4))
    chunk_fn, carry = runner._make_chunk_fn(
        build_topology(kind, n, seed=SEED), cfg, rng.PRNGKey(SEED),
        torch.device("cpu"), n)
    status = torch.tensor([0, 0], dtype=torch.int32)
    carry, status = chunk_fn(carry, status, 0, 40)
    st, ring = carry
    mass_s = st.s.double().sum() + ring[:, 0].double().sum()
    mass_w = st.w.double().sum() + ring[:, 1].double().sum()
    assert ring[:, 1].sum() > 0  # mass is in flight
    assert abs(float(mass_w) - n) <= 1e-5 * n
    assert abs(float(mass_s) - n * (n - 1) / 2) <= 1e-5 * n * (n - 1) / 2


def _both_raise(fields, topo_kind, n, **run_kw):
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology(topo_kind, n, seed=SEED), JaxConfig(**fields),
                       **run_kw)
    with pytest.raises(ValueError) as terr:
        run(build_topology(topo_kind, n, seed=SEED), SimConfig(**fields),
            device="cpu", **run_kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("delivery_", ["pool", "matmul"])
@pytest.mark.parametrize("kind", ["full", "imp2d"])
@pytest.mark.parametrize("knob", [{"dup_rate": 0.1}, {"delay_rounds": 2}])
def test_pool_and_matmul_refuse_dup_and_delay_as_jax(delivery_, kind, knob):
    n = 1000 if kind == "full" else 900
    _both_raise(dict(n=n, topology=kind, algorithm="gossip", delivery=delivery_,
                     seed=SEED, **knob), kind, n)


def test_resume_with_a_ring_is_refused_as_jax():
    fields = dict(n=1000, topology="full", algorithm="gossip", delivery="scatter",
                  seed=SEED, delay_rounds=2)
    seen = {}
    jres = jax_runner.run(jax_topology("full", 1000, seed=SEED),
                          JaxConfig(**dict(fields, delay_rounds=0, max_rounds=5)),
                          on_chunk=lambda rounds, st: seen.update(state=st))
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology("full", 1000, seed=SEED), JaxConfig(**fields),
                       start_state=seen["state"], start_round=jres.rounds)
    tres = run(build_topology("full", 1000, seed=SEED),
               SimConfig(**dict(fields, delay_rounds=0, max_rounds=5)), device="cpu")
    with pytest.raises(ValueError) as terr:
        run(build_topology("full", 1000, seed=SEED), SimConfig(**fields),
            device="cpu", start_state=tres.state, start_round=tres.rounds)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    {"dup_rate": 1.0}, {"dup_rate": -0.1}, {"delay_rounds": 65},
    {"delay_rounds": -1},
    {"algorithm": "push-sum", "dup_rate": 0.1, "mass_tolerance": 1e-3},
    {"semantics": "reference", "dup_rate": 0.1},
    {"semantics": "reference", "delay_rounds": 2},
])
def test_config_errors_are_the_jax_texts(kw):
    fields = dict({"n": 100, "topology": "full", "algorithm": "gossip"}, **kw)
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ValueError) as terr:
        SimConfig(**fields)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("delivery_", ["auto", "scatter"])
def test_fused_tiers_demote_dup_and_delay(delivery_):
    # Every fused plan refuses them: engine auto runs the chunked engine,
    # engine fused raises the JAX ladder's text.
    for kind, n in (("full", 1000), ("grid2d", 400), ("imp2d", 900)):
        for knob in ({"dup_rate": 0.1}, {"delay_rounds": 2}):
            cfg = SimConfig(n=n, topology=kind, algorithm="gossip",
                            delivery="pool" if kind == "full" else delivery_,
                            **knob)
            jcfg = JaxConfig(n=n, topology=kind, algorithm="gossip",
                             delivery="pool" if kind == "full" else delivery_,
                             **knob)
            variant, reason = runner.fused_tier(build_topology(kind, n, seed=SEED), cfg)
            assert reason is not None
            if kind == "full":
                from cop5615_gossip_protocol_tpu.ops import fused_pool as jfp

                assert reason == jfp.pool_fused_support(
                    jax_topology(kind, n, seed=SEED), jcfg)


@pytest.mark.parametrize("n,refused", [(2**30, True), (2**30 - 1, False)])
def test_card_dup_instance_takes_n_below_its_index_word(n, refused):
    # A push-sum dup instance of kernel A carries 2 i + the dup bit in an
    # int32 (csrc/scatter.cuh dup_index): the wrapper refuses n >= 2**30 off
    # the CPU before it reaches the kernel. Meta tensors stand in for the
    # card's (they hold no memory); one node fewer passes that check and
    # meets the device check after it.
    from cop5615_gossip_protocol_tpu_torch.ops import fused, scatter

    cfg = SimConfig(n=n, topology="full", algorithm="push-sum", delivery="scatter",
                    dup_rate=0.05)
    meta = torch.device("meta")
    state = pushsum.PushSumState(*(torch.empty(n, dtype=dt, device=meta) for dt in (
        torch.float32, torch.float32, torch.int32, torch.bool)))
    status = torch.zeros(2, dtype=torch.int32, device=meta)
    graph = scatter.scatter_graph(build_topology("full", n), meta)
    with pytest.raises(ValueError) as err:
        scatter.pushsum_scatter_chunk(
            state, rng.PRNGKey(SEED), 0, 1, status, graph=graph, target=n,
            delta=cfg.resolved_delta, term_rounds=cfg.term_rounds,
            faults=fused.run_faults(cfg, n))
    if refused:
        assert str(err.value) == ("dup_rate > 0 with push-sum scatter delivery on the "
                                  "card takes n < 2**30 (a record's index word carries "
                                  f"2 i + the dup bit), got n={n}")
    else:
        assert "scatter chunks run on cpu or cuda tensors" in str(err.value)
