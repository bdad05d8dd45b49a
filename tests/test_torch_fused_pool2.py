"""The port's streaming pool tier (cop5615_gossip_protocol_tpu_torch/ops/
fused_pool2.py) on the CPU, where its wrappers run their plain versions.

The tier serves ``full`` past the pool engine's 2**21 nodes; the tests reach
it at small populations by shrinking ``fused_pool.MAX_POOL_NODES`` to 1000
in both packages, as the JAX package's own pool2 tests do. Checked:

- the ladder picks the JAX ladder's tier, with its reason, at 2**21,
  2**21 + 1 and 2**27 + 1 (past the budget engine="auto" demotes to the
  chunked engine and engine="fused" raises), and dispatches pool2 configs
  to the fused engine on CUDA (stubbed here, never touched);
- whole runs of the port's fused engine against the JAX chunked engine:
  rounds, converged count, estimate and every state plane bitwise, at
  n = 20000 (pad lanes, so the mod-n wrap shifts wrapped sources) and 65536
  (no pad lanes), gossip with and without suppression, and push-sum;
- one chunk of each JAX pool2 kernel in Pallas interpret mode against the
  port's plain version, from the initial and a mid-run state, bitwise;
- a cap inside the chunk, a chunk from a converged state (0 rounds, state
  unchanged), gossip's derived conv, resume from a chunk boundary, and
  the wrappers' refusals."""

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

SEED = 2


@pytest.fixture
def force_pool2(monkeypatch):
    """Shrink the pool engine's domain in both packages, so n > 1000 on
    ``full`` lands on the streaming pool tier."""
    monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", 1000)
    monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", 1000)


@pytest.fixture
def stub_cuda(monkeypatch):
    """run() sees a CUDA device; the tests stub whatever would touch it."""
    monkeypatch.setattr(runner, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))


def _jax_tier(n, cfg):
    """The JAX runner's ladder on ``full`` (models/runner.py, its pool /
    pool2 branch): the tier and the reason it cannot run there."""
    topo = jax_topology("full", n)
    if n <= jax_fused_pool.MAX_POOL_NODES:
        return "pool", jax_fused_pool.pool_fused_support(topo, cfg)
    return "pool2", jax_fused_pool2.pool2_support(topo, cfg)


@pytest.mark.parametrize("n,tier,budget", [
    (2**21, "pool", False), (2**21 + 1, "pool2", False), (2**27 + 1, "pool2", True),
])
@pytest.mark.parametrize("pool_size", [2, 16])
def test_ladder_matches_the_jax_ladder(n, tier, budget, pool_size):
    jcfg = JaxConfig(n=n, topology="full", algorithm="gossip", delivery="pool",
                     pool_size=pool_size)
    cfg = SimConfig(n=n, topology="full", algorithm="gossip", delivery="pool",
                    pool_size=pool_size)
    jtier, jreason = _jax_tier(n, jcfg)
    got, reason = runner.fused_tier(build_topology("full", n), cfg)
    assert (got, jtier) == (tier, tier)
    if budget:
        # The same reason; what runs past the budget is the port's own.
        assert "HBM-plane budget" in reason
        assert reason.split(";")[0] == jreason.split(";")[0]
    else:
        assert reason is None and jreason is None


def test_past_the_budget_auto_demotes_and_fused_raises(stub_cuda, monkeypatch):
    n = 2**27 + 1
    topo = build_topology("full", n)
    ran = []
    monkeypatch.setattr(runner, "_run_chunked", lambda *a: ran.append(a[3].type))
    monkeypatch.setattr(runner, "_run_fused", lambda *a: ran.append("fused"))
    cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", pool_size=2)
    run(topo, cfg)
    assert ran == ["cuda"]
    cfg = SimConfig(n=n, algorithm="push-sum", delivery="pool", pool_size=2,
                    engine="fused")
    with pytest.raises(ValueError, match="HBM-plane budget"):
        run(topo, cfg)
    assert ran == ["cuda"]


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_pool2_configs_dispatch_to_the_fused_tier_on_cuda(algorithm, stub_cuda,
                                                          monkeypatch):
    dispatched = []
    monkeypatch.setattr(runner, "_run_fused",
                        lambda *a: dispatched.append((a[3].type, a[-1])))
    for n in (2**21 + 1, 10_000_000, 2**27):
        cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2)
        run(build_topology("full", n), cfg)
    assert dispatched == [("cuda", "pool2")] * 3


# ---------------------------------------------------------------------------
# Whole runs against the JAX chunked engine.
# ---------------------------------------------------------------------------


def _jax_run(algorithm, n, **kw):
    final = {}
    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, delivery="pool",
                    pool_size=2, seed=SEED, engine="chunked", **kw)
    res = jax_runner.run(jax_topology("full", n), cfg,
                         on_chunk=lambda r, s: final.__setitem__("s", s))
    return res, final["s"]


def _assert_same_run(res, jres, jstate):
    assert (res.rounds, res.converged, res.converged_count, res.population) == (
        jres.rounds, jres.converged, jres.converged_count, jres.population)
    assert res.estimate_mae == jres.estimate_mae
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


@pytest.mark.parametrize("algorithm,n,suppress", [
    ("gossip", 20_000, None), ("gossip", 65_536, None), ("gossip", 20_000, True),
    ("push-sum", 20_000, None),
])
def test_fused_run_matches_jax_chunked(algorithm, n, suppress, force_pool2):
    jres, jstate = _jax_run(algorithm, n, suppress_converged=suppress, chunk_rounds=64)
    topo = build_topology("full", n)
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2,
                    seed=SEED, engine="fused", suppress_converged=suppress,
                    chunk_rounds=16)
    assert runner.fused_tier(topo, cfg) == ("pool2", None)
    before = (fused_pool2.pushsum_pool2_chunk.launches,
              fused_pool2.gossip_pool2_chunk.launches)
    res = run(topo, cfg, device="cpu")
    assert res.converged
    _assert_same_run(res, jres, jstate)
    # Chunks of 16 rounds, logged as they retire; the CPU launches nothing.
    assert res.chunk_log[0]["rounds"] == 16
    assert (fused_pool2.pushsum_pool2_chunk.launches,
            fused_pool2.gossip_pool2_chunk.launches) == before


@pytest.mark.parametrize("algorithm,mid", [("gossip", 8), ("push-sum", 40)])
def test_resume_from_a_chunk_boundary(algorithm, mid, force_pool2):
    n = 20_000
    jres, jstate = _jax_run(algorithm, n, chunk_rounds=64)
    _, jmid = _jax_run(algorithm, n, chunk_rounds=mid, max_rounds=mid)
    start = carry.state_from_numpy({k: np.asarray(v) for k, v in jmid._asdict().items()})
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(SEED)))
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2,
                    seed=SEED, engine="fused", chunk_rounds=16)
    res = run(build_topology("full", n), cfg, key=key, device="cpu",
              start_state=start, start_round=mid)
    _assert_same_run(res, jres, jstate)


# ---------------------------------------------------------------------------
# Single chunks against the JAX pool2 kernels in interpret mode.
# ---------------------------------------------------------------------------

K = 4


def _start_state(algorithm, n, topo, cfg, mid_round):
    """(canonical JAX state, its absolute round): the initial state, or the
    chunked engine's at ``mid_round``."""
    if mid_round == 0:
        if algorithm == "push-sum":
            return jax_pushsum.init_state(topo.n, jnp.float32, 0), 0
        leader = jax_runner.draw_leader(jax.random.PRNGKey(SEED), topo, cfg)
        return jax_gossip.init_state(topo.n, leader, cfg.reference), 0
    _, st = _jax_run(algorithm, n, chunk_rounds=mid_round, max_rounds=mid_round)
    return st, mid_round


@pytest.mark.parametrize("algorithm,n,mid_round", [
    ("gossip", 20_000, 0), ("gossip", 20_000, 10), ("gossip", 65_536, 0),
    ("gossip", 65_536, 10), ("push-sum", 20_000, 0), ("push-sum", 20_000, 100),
])
def test_chunk_matches_jax_pool2_kernel(algorithm, n, mid_round):
    topo = jax_topology("full", n)
    cfg = JaxConfig(n=n, topology="full", algorithm=algorithm, delivery="pool",
                    pool_size=2, seed=SEED, engine="chunked")
    st, start = _start_state(algorithm, n, topo, cfg, mid_round)
    layout = jax_fused_pool.build_pool_layout(n)
    key = jax.random.PRNGKey(SEED)
    keys = jax_fused.round_keys(key, start, K)
    offs = jax_fused_pool.round_offsets(key, start, K, 2, n)
    tkey = carry.key_from_numpy(np.asarray(key))
    tkeys, toffs = fused.round_keys(tkey, start, K), fused_pool.round_offsets(tkey, start, K, 2, n)
    target = cfg.resolved_target_count(n, topo.target_count)
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
    jout, jex = fn(planes, keys, offs, start, start + K)
    tstate = carry.state_from_numpy(dict(zip(fields, (np.asarray(p) for p in planes))))
    tout, tex = port(tuple(tstate), tkeys, toffs, start, start + K, n=n, target=target, **kw)
    assert int(jex) == int(tex) == K
    for a, b, p in zip(jout, tout, planes):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == p.shape and a.dtype == b.dtype
        assert (a.view(np.int32) == b.view(np.int32)).all()


# ---------------------------------------------------------------------------
# The chunk contract on the port's wrappers.
# ---------------------------------------------------------------------------


def _port_case(algorithm, n):
    """(wrapper, chunk(state, start, count, cap, fn), initial planes)."""
    topo = build_topology("full", n)
    cfg = SimConfig(n=n, algorithm=algorithm, delivery="pool", pool_size=2, seed=SEED)
    key = rng.PRNGKey(SEED)
    eng = runner.fused_engine(topo, cfg, key, "pool2")
    target = cfg.resolved_target_count(n, topo.target_count)
    if algorithm == "push-sum":
        fn = fused_pool2.pushsum_pool2_chunk
        kw = {"delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
    else:
        fn = fused_pool2.gossip_pool2_chunk
        kw = {"rumor_target": cfg.resolved_rumor_target,
              "suppress": cfg.resolved_suppress}

    def chunk(state, start, count, cap=None, fn=fn):
        return fn(state, fused.round_keys(key, start, count),
                  fused_pool.round_offsets(key, start, count, 2, n), start,
                  start + count if cap is None else cap, n=n, target=target, **kw)

    return fn, chunk, eng.planes


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_cap_inside_the_chunk(algorithm):
    _, chunk, init = _port_case(algorithm, 20_000)
    capped, ex = chunk(init, 0, 8, cap=3)
    short, ex3 = chunk(init, 0, 3)
    assert int(ex) == int(ex3) == 3 and _equal(capped, short)
    assert not _equal(capped, init)
    # The pool tier's chunk runs the same trajectory.
    pool_fn = (fused_pool.pushsum_pool_chunk if algorithm == "push-sum"
               else fused_pool.gossip_pool_chunk)
    pooled, pex = chunk(init, 0, 8, cap=3, fn=pool_fn)
    assert int(pex) == 3 and _equal(pooled, capped)


@pytest.mark.parametrize("algorithm", ["push-sum", "gossip"])
def test_chunk_from_a_converged_state_runs_nothing(algorithm):
    _, chunk, init = _port_case(algorithm, 20_000)
    done, ex = chunk(init, 0, 512)
    rounds = int(ex)
    assert 0 < rounds < 512
    out, ex = chunk(done, rounds, 16)
    assert int(ex) == 0 and _equal(out, done)


def test_gossip_conv_is_derived_from_count():
    n = 20_000
    _, chunk, init = _port_case("gossip", n)
    mid, _ = chunk(init, 0, 22)
    count, active, conv = mid
    assert 0 < int(conv.sum()) < n
    # Whatever conv plane comes in, the chunk reads and returns count >=
    # rumor_target on real lanes.
    for bogus in (torch.zeros_like(conv), torch.ones_like(conv)):
        out, ex = chunk((count, active, bogus), 22, 4)
        want, wex = chunk(mid, 22, 4)
        assert int(ex) == int(wex) == 4 and _equal(out, want)
    out, ex = chunk((count, active, torch.ones_like(conv)), 22, 0)
    assert int(ex) == 0 and _equal(out, mid)
    # All real counts at the target: converged, whatever the conv plane says.
    real = torch.arange(count.numel()).reshape(count.shape) < n
    full = torch.where(real, 10, 0).to(torch.int32)
    out, ex = chunk((full, real.to(torch.int32), torch.zeros_like(conv)), 12, 8)
    assert int(ex) == 0 and torch.equal(out[2], real.to(torch.int32))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    n = 20_000
    ps, ps_chunk, ps_init = _port_case("push-sum", n)
    go, go_chunk, go_init = _port_case("gossip", n)
    key = rng.PRNGKey(SEED)
    keys = fused.round_keys(key, 0, 4)
    offs = fused_pool.round_offsets(key, 0, 4, 2, n)
    kw_ps = {"n": n, "target": n, "delta": 1e-6, "term_rounds": 3}
    kw_go = {"n": n, "target": n, "rumor_target": 10, "suppress": False}
    s, w, t, c = ps_init
    rows = s.shape[0]
    with pytest.raises(ValueError, match="state plane"):  # the layout
        ps((torch.zeros(rows + 8, 128), w, t, c), keys, offs, 0, 4, **kw_ps)
    with pytest.raises(ValueError, match="state plane"):  # a dtype
        ps((s.double(), w, t, c), keys, offs, 0, 4, **kw_ps)
    with pytest.raises(ValueError, match="state plane"):
        go((go_init[0].float(), *go_init[1:]), keys, offs, 0, 4, **kw_go)
    with pytest.raises(ValueError, match="expected 3 state planes"):
        go(ps_init, keys, offs, 0, 4, **kw_go)
    for p in (3, 32):  # the packed-choice limit
        bad = fused_pool.round_offsets(key, 0, 4, 32, n)[:, :p]
        with pytest.raises(ValueError, match="pool_size"):
            ps(ps_init, keys, bad, 0, 4, **kw_ps)
    with pytest.raises(ValueError, match="offs must lie"):
        go(go_init, keys, offs + n, 0, 4, **kw_go)
    with pytest.raises(ValueError, match=r"n must lie in \[2, 134217728\]"):
        ps(ps_init, keys, offs, 0, 4, **{**kw_ps, "n": 2**27 + 1})
