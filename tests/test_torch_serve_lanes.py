"""The port's lane server and its serving pieces
(cop5615_gossip_protocol_tpu_torch/models/sweep.serve_lanes,
serving/keys.py, serving/pool.py) held against the JAX package's, both on
the CPU: every request served through refilled, filler and killed lanes is
bitwise the JAX lane server's result and the port's one-shot run(); a
poll overflow is loud; the canonical keys, the warm pool and the
quarantine behave as JAX's. The JAX counterparts are the serve_lanes tests
of tests/test_continuous.py and the keys, pool and run_batched_keys tests
of tests/test_serving.py."""

import time

import jax
import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import sweep as jax_sweep
from cop5615_gossip_protocol_tpu.serving import keys as jax_keys

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import sweep
from cop5615_gossip_protocol_tpu_torch.serving import keys as keys_mod
from cop5615_gossip_protocol_tpu_torch.serving import pool as pool_mod
from cop5615_gossip_protocol_tpu_torch.utils import obs

torch.set_num_threads(1)
CPU = torch.device("cpu")


class ScriptedSource:
    """A list-backed lane source (tests/test_continuous.py's): hands out up
    to ``k`` tickets a poll, the first poll capped at ``first_fill``, and
    collects the results by tag."""

    def __init__(self, tickets, first_fill=None):
        self.todo = list(tickets)
        self.first_fill = first_fill
        self.results = {}
        self.boundaries = 0

    def poll(self, k):
        if self.first_fill is not None:
            k = min(k, self.first_fill)
            self.first_fill = None
        out, self.todo = self.todo[:k], self.todo[k:]
        return out

    def on_result(self, ticket, res):
        assert ticket.tag not in self.results, "double result for a lane"
        self.results[ticket.tag] = res

    def on_boundary(self, active, lanes):
        self.boundaries += 1
        return True


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_state(want, got):
    for f in got._fields:
        assert np.array_equal(_bits(getattr(want, f)), _bits(getattr(got, f))), f


def _serve_both(fields, tickets, lanes, first_fill=None):
    """The JAX lane server and the port's on the same tickets: (JAX
    results, port results, port summary)."""
    kind, n = fields["topology"], fields["n"]
    jsrc = ScriptedSource([jax_sweep.LaneTicket(key=t.key, tag=t.tag, deadline=t.deadline)
                           for t in tickets], first_fill)
    jax_sweep.serve_lanes(jax_topology(kind, n), JaxConfig(**fields), jsrc, lanes=lanes)
    tsrc = ScriptedSource(tickets, first_fill)
    summary = sweep.serve_lanes(build_topology(kind, n), SimConfig(**fields), tsrc,
                                lanes=lanes, device="cpu")
    return jsrc.results, tsrc.results, summary


def _same_result(jres, tres):
    assert (tres.rounds, tres.converged, tres.outcome, tres.target_count) == (
        jres.rounds, jres.converged, jres.outcome, jres.target_count)
    assert tres.estimate_mae == jres.estimate_mae
    _same_state(jres.state, tres.state)
    if jres.telemetry is not None:
        assert np.array_equal(_bits(tres.telemetry.data), _bits(jres.telemetry.data))


def _one_shot(fields, seed):
    kind, n = fields["topology"], fields["n"]
    return run(build_topology(kind, n), SimConfig(**{**fields, "seed": seed}), device="cpu")


GOSSIP = dict(n=32, topology="full", algorithm="gossip", rumor_threshold=5, chunk_rounds=4)


@pytest.mark.parametrize("first_fill,telemetry", [(None, True), (3, False)],
                         ids=["refill churn, telemetry", "filler lane reclaimed"])
def test_gossip_requests_are_bitwise_through_refills(first_fill, telemetry):
    seeds = [3, 11, 42, 7, 99, 123, 5, 6] if first_fill is None else [21, 22, 23, 24, 25]
    lanes = 2 if first_fill is None else 4
    fields = {**GOSSIP, "telemetry": telemetry}
    tickets = [sweep.LaneTicket(key=s, tag=s) for s in seeds]
    jres, tres, summary = _serve_both(fields, tickets, lanes, first_fill)
    assert summary.served == len(seeds)
    assert summary.refills == len(seeds) - (lanes if first_fill is None else first_fill)
    for s in seeds:
        _same_result(jres[s], tres[s])
        one = _one_shot(fields, s)
        assert tres[s].outcome == "converged" and tres[s].rounds == one.rounds
        _same_state(one.state, tres[s].state)
        if telemetry:
            assert np.array_equal(_bits(tres[s].telemetry.data), _bits(one.telemetry.data))


def test_pushsum_requests_are_bitwise_with_the_jax_estimate():
    fields = dict(n=32, topology="full", algorithm="push-sum", delta=1e-3, chunk_rounds=8)
    seeds = [5, 6, 7, 8]
    jres, tres, _ = _serve_both(fields, [sweep.LaneTicket(key=s, tag=s) for s in seeds], 2)
    for s in seeds:
        _same_result(jres[s], tres[s])
        one = _one_shot(fields, s)
        assert tres[s].rounds == one.rounds
        _same_state(one.state, tres[s].state)


def test_a_deadline_kills_a_lane_and_its_slot_is_refilled():
    # An expired ticket retires at the first boundary with its partial
    # state, the lane is refilled with the waiting ticket, which converges.
    fields = dict(n=64, topology="full", algorithm="push-sum", chunk_rounds=16)
    tickets = [sweep.LaneTicket(key=3, tag="dead", deadline=time.monotonic() - 1.0),
               sweep.LaneTicket(key=4, tag="live"),
               sweep.LaneTicket(key=5, tag="late")]
    jres, tres, summary = _serve_both(fields, tickets, 2)
    assert summary.served == 3 and summary.refills == 1
    for tag in ("dead", "live", "late"):
        _same_result(jres[tag], tres[tag])
    dead = tres["dead"]
    assert (dead.outcome, dead.converged, dead.rounds) == ("deadline_exceeded", False, 16)
    part = _one_shot({**fields, "max_rounds": 16}, 3)
    _same_state(part.state, dead.state)
    assert tres["live"].outcome == tres["late"].outcome == "converged"
    # The late request is a refilled lane at round 0 of its own.
    _same_state(_one_shot(fields, 5).state, tres["late"].state)


def test_serve_lanes_poll_overflow_is_loud():
    class Greedy(ScriptedSource):
        def poll(self, k):
            return [sweep.LaneTicket(key=i, tag=i) for i in range(k + 1)]

    with pytest.raises(ValueError) as te:
        sweep.serve_lanes(build_topology("full", 32), SimConfig(**GOSSIP), Greedy([]),
                          lanes=1, device="cpu")
    with pytest.raises(ValueError) as je:
        jax_sweep.serve_lanes(jax_topology("full", 32), JaxConfig(**GOSSIP), Greedy([]),
                              lanes=1)
    assert str(te.value) == str(je.value) and "free lanes" in str(te.value)
    for bad in (0, sweep.MAX_REPLICAS + 1):
        with pytest.raises(ValueError) as te:
            sweep.serve_lanes(build_topology("full", 32), SimConfig(**GOSSIP),
                              ScriptedSource([]), lanes=bad, device="cpu")
        with pytest.raises(ValueError) as je:
            jax_sweep.serve_lanes(jax_topology("full", 32), JaxConfig(**GOSSIP),
                                  ScriptedSource([]), lanes=bad)
        assert str(te.value) == str(je.value)


def test_an_abandoning_source_stops_the_loop():
    class Abandon(ScriptedSource):
        def on_boundary(self, active, lanes):
            super().on_boundary(active, lanes)
            return False

    src = Abandon([sweep.LaneTicket(key=s, tag=s) for s in (1, 2)])
    summary = sweep.serve_lanes(build_topology("full", 32),
                                SimConfig(**{**GOSSIP, "rumor_threshold": 10**6}), src,
                                lanes=2, device="cpu")
    assert summary.abandoned and summary.chunks == 1 and src.boundaries == 1


# ------------------------------------------------------------ canonical keys

KEY_CONFIGS = [
    dict(n=64, algorithm="gossip"),
    dict(n=64, algorithm="push-sum"),
    dict(n=64, algorithm="gossip", fault_rate=0.1),
    dict(n=64, algorithm="gossip", crash_schedule="3:8", quorum=0.9, seed=2),
    dict(n=64, algorithm="push-sum", crash_rate=0.01, revive_rate=0.1, rejoin="fresh",
         quorum=0.9),
    dict(n=64, algorithm="gossip", crash_rate=0.01, revive_schedule="5:2", quorum=0.9),
    dict(n=64, algorithm="push-sum", dup_rate=0.1, delay_rounds=2),
    dict(n=64, algorithm="push-sum", byzantine_rate=0.1, robust_agg="clip"),
    dict(n=64, algorithm="push-sum", termination="global"),
]


@pytest.mark.parametrize("fields", KEY_CONFIGS, ids=str)
def test_fault_class_and_bucket_label_are_the_jax_ones(fields):
    jcfg, cfg = JaxConfig(**fields), SimConfig(**fields)
    assert keys_mod.fault_class(cfg) == jax_keys.fault_class(jcfg)
    topo, jtopo = build_topology("full", 64), jax_topology("full", 64)
    assert keys_mod.bucket_label(cfg, topo) == jax_keys.bucket_label(jcfg, jtopo)
    assert keys_mod.topology_class(topo) == jax_keys.topology_class(jtopo)


def _key_of(**fields):
    cfg = SimConfig(**fields)
    topo = keys_mod.get_topology(cfg.topology, cfg.n, seed=cfg.seed)
    return keys_mod.canonical_key(cfg, topo, "cpu")


def test_canonical_keys_split_and_collapse_as_the_jax_keys():
    base = dict(n=64, topology="full", algorithm="gossip")
    assert _key_of(**base, seed=0) == _key_of(**base, seed=9)
    for other in (dict(algorithm="push-sum"), dict(n=128), dict(telemetry=True),
                  dict(fault_rate=0.1)):
        assert _key_of(**base) != _key_of(**{**base, **other})
    crash = dict(base, crash_schedule="3:8", quorum=0.9)
    assert _key_of(**crash, seed=0) == _key_of(**crash, seed=0)
    assert _key_of(**crash, seed=0) != _key_of(**crash, seed=1)
    a = SimConfig(n=64, algorithm="push-sum")
    assert _key_of(n=64, algorithm="push-sum") == _key_of(
        n=64, algorithm="push-sum", delta=a.resolved_delta)
    with pytest.warns(RuntimeWarning):
        relaxed = SimConfig(n=64, algorithm="gossip", quorum=0.9)
    assert keys_mod.fault_class(relaxed) == ("fault-free",)
    # The runtime is part of the key: another device is another engine.
    topo = build_topology("full", 64)
    cfg = SimConfig(**base)
    assert keys_mod.canonical_key(cfg, topo, "cpu")[-1][:3] == ("device", "cpu", None)
    assert keys_mod.canonical_key(cfg, topo, "cpu")[:2] == (
        keys_mod.compile_class(cfg), keys_mod.topology_class(topo))


def test_padded_population_and_the_bucket_key():
    for kind, n in (("grid2d", 95), ("grid2d", 100), ("imp3d", 100), ("full", 77)):
        assert keys_mod.padded_population(kind, n) == jax_keys.padded_population(kind, n)
    t95, t100 = keys_mod.get_topology("grid2d", 95), keys_mod.get_topology("grid2d", 100)
    a = SimConfig(n=95, topology="grid2d", algorithm="gossip", seed=0)
    b = SimConfig(n=100, topology="grid2d", algorithm="gossip", seed=1)
    assert keys_mod.serve_bucket_key(a, t95, "cpu") == keys_mod.serve_bucket_key(b, t100, "cpu")
    c = SimConfig(n=100, topology="grid2d", algorithm="gossip", max_rounds=50)
    assert keys_mod.serve_bucket_key(c, t100, "cpu") != keys_mod.serve_bucket_key(b, t100, "cpu")
    assert keys_mod.resolved_plan_label(a, t95) == "hand"


def test_seed_built_topologies_split_the_key_and_keep_their_own_graph():
    cfg = SimConfig(n=64, topology="imp2d", algorithm="gossip")
    ta, tb = build_topology("imp2d", 64, seed=0), build_topology("imp2d", 64, seed=1)
    assert keys_mod.canonical_key(cfg, ta, "cpu") != keys_mod.canonical_key(cfg, tb, "cpu")
    assert keys_mod.canonical_key(cfg, ta, "cpu") == keys_mod.canonical_key(
        cfg, build_topology("imp2d", 64, seed=0), "cpu")
    for seed in (0, 1):
        topo = build_topology("imp2d", 64, seed=seed)
        c = SimConfig(n=64, topology="imp2d", algorithm="gossip", seed=seed)
        batch = sweep.run_batched_keys(topo, c, [seed], lanes=1, device="cpu")
        assert batch.rounds[0] == run(topo, c, device="cpu").rounds


# ------------------------------------------------------------------ the pool


def test_pool_lru_and_counters():
    reg = obs.Registry()
    p = pool_mod.WarmEnginePool(capacity=2, registry=reg)
    assert p.get_or_build("a", lambda: "A") == ("A", False)
    assert p.get_or_build("a", lambda: "A2") == ("A", True)
    p.get_or_build("b", lambda: "B")
    p.get_or_build("a", lambda: "A3")  # refresh a's recency
    p.get_or_build("c", lambda: "C")  # evicts b (LRU)
    assert p.get_or_build("b", lambda: "B2") == ("B2", False)
    s = p.stats()
    assert s["evictions"] >= 2 and s["entries"] == 2
    assert s["hits"] == 2 and s["misses"] == 4
    assert p.invalidate(lambda k: k == "b") == 1 and len(p) == 1
    parsed = obs.parse_prometheus(reg.render())
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_hits_total") == 2
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_misses_total") == 4
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_evictions_total") == s["evictions"]
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_invalidations_total") == 1
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_entries") == 1
    assert obs.metric_value(parsed, "gossip_tpu_engine_pool_capacity") == 2
    with pytest.raises(ValueError, match="capacity"):
        pool_mod.WarmEnginePool(capacity=0, registry=reg)


def test_quarantine_opens_probes_once_and_closes():
    q = pool_mod.Quarantine(cooldown_s=10.0, registry=obs.Registry())
    assert q.check("k", now=0.0) == "closed"
    q.trip("k", now=0.0)
    assert q.check("k", now=5.0) == "open"
    assert q.check("k", now=11.0) == "probe"
    assert q.check("k", now=11.5) == "open"  # one probe a window
    q.record("k", ok=False, now=12.0)
    assert q.state("k") == "open" and q.check("k", now=21.0) == "open"
    assert q.check("k", now=22.5) == "probe"
    q.record("k", ok=True, now=23.0)
    assert q.state("k") == "closed" and q.open_count() == 0


def test_the_batch_engine_is_reused_across_seeds():
    topo = build_topology("full", 48)
    cfg = SimConfig(n=48, algorithm="gossip", seed=0)
    first = sweep.run_batched_keys(topo, cfg, [101, 102], lanes=2, device="cpu")
    again = sweep.run_batched_keys(topo, SimConfig(n=48, algorithm="gossip", seed=77),
                                   [201, 202], lanes=2, device="cpu")
    assert again.engine_cache == "hit" and first.lanes == again.lanes == 2
    wider = sweep.run_batched_keys(topo, cfg, [1, 2, 3], lanes=4, device="cpu")
    assert wider.lanes == 4
    key = ("batch-engine", keys_mod.canonical_key(cfg, topo, CPU), 2)
    engine, hit = pool_mod.default_pool().get_or_build(key, lambda: None)
    assert hit and isinstance(engine, sweep.BatchEngine)
    # The batch's lanes are bitwise the JAX wave's.
    jres = jax_sweep.run_batched_keys(jax_topology("full", 48),
                                      JaxConfig(n=48, algorithm="gossip"), [201, 202],
                                      lanes=2)
    assert again.rounds == jres.rounds
    for jst, tst in zip(jres.final_states, again.final_states):
        _same_state(jax.tree.map(np.asarray, jst), tst)
