"""delivery="matmul" in the port against the JAX package on the CPU.

The JAX tier delivers a pooled round's sends with a blocked one-hot
dot_general (its ops/delivery.deliver_matmul), whose float32 sums follow
XLA's dot panels on the CPU: each receiver's sends ascend inside panels of
512 senders with the process on 8 CPUs, 256 on one, and the panels' sums
are added. That order follows the host's thread count, and at pool_size 4
or more it moves push-sum's rounds, so no test pins a JAX push-sum matmul
run at pool_size >= 4. The port's order is explicit (each receiver's
senders in ascending index onto 0, ops/delivery.deliver_matmul) and is held
here to:

- the op: bitwise JAX on integer channels and at pool_size 2 (a receiver
  gets at most two sends, and two adds commute), JAX's own float bound
  (rtol 1e-6) at pool_size 4; aggregate_full, build_spmv_plan and
  deliver_spmv against JAX and brute force; targets_pool against JAX;
- whole runs: gossip bitwise JAX on full 1000 (chunked engine and the pool
  tier's plain version) and imp2d 900; push-sum at pool_size 2 on full
  1000 bitwise JAX on the chunked engine and through the pool tier; push-sum
  at pool_size 4 on full 1000 and imp2d 900 converges, conserves Σs and Σw
  to 1e-5 relative, estimates the mean to 1e-6 of it, and ends in its own
  recorded rounds;
- the ladder: full takes the pool tiers (rows 1-4) with JAX's reasons, imp
  runs the chunked engine and refuses engine="fused" with JAX's text, and
  with n_devices > 1 the sharded XLA engine, the imp composition and the
  VMEM replicated composition refuse with JAX's texts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import delivery as jax_delivery
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import fused_pool2 as jax_fused_pool2
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import delivery, fused_pool, rng, sampling

torch.set_num_threads(1)

SEED = 3


def _pool_round(n, K, rnd=5):
    """(choice, offsets, targets) of one pooled round, from both packages:
    the port's, checked against JAX's targets_pool."""
    key = sampling.round_key(rng.PRNGKey(SEED), rnd)
    offs = sampling.pool_offsets(key, K, n)
    choice = sampling.pool_choice_packed(key, n, K)
    ids = torch.arange(n)
    targets = sampling.targets_pool(choice, offs, ids, n)
    jt = jax_sampling.targets_pool(jnp.asarray(choice.numpy()), jnp.asarray(offs.numpy()),
                                   jnp.arange(n, dtype=jnp.int32), n)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jt))
    return choice, offs, targets


@pytest.mark.parametrize("n", [37, 1000])
@pytest.mark.parametrize("K", [2, 4])
def test_deliver_matmul_integer_channels_are_jax(n, K):
    _, _, targets = _pool_round(n, K)
    r = np.random.default_rng(n)
    vals = r.integers(0, 3, (1, n)).astype(np.int32)
    want = jax_delivery.deliver_matmul(jnp.asarray(vals), jnp.asarray(targets.numpy()), n)
    got = delivery.deliver_matmul(torch.tensor(vals), targets, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [37, 1000])
def test_deliver_matmul_floats_at_pool_size_2_are_jax(n):
    choice, offs, targets = _pool_round(n, 2)
    r = np.random.default_rng(n)
    vals = (r.random((2, n)) * 10.0 ** r.integers(-3, 4, (2, n))).astype(np.float32)
    want = jax_delivery.deliver_matmul(jnp.asarray(vals), jnp.asarray(targets.numpy()), n)
    got = delivery.deliver_matmul(torch.tensor(vals), targets, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    # Also bitwise the pool round's masked rolls.
    pool = delivery.deliver_pool(torch.tensor(vals), choice, offs.tolist())
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  pool.numpy().view(np.int32))


@pytest.mark.parametrize("n,K", [(1000, 4), (5000, 8)])
def test_deliver_matmul_floats_hold_jax_bound(n, K):
    _, _, targets = _pool_round(n, K)
    r = np.random.default_rng(n)
    vals = r.random((2, n)).astype(np.float32)
    want = np.asarray(jax_delivery.deliver_matmul(jnp.asarray(vals),
                                                  jnp.asarray(targets.numpy()), n))
    got = delivery.deliver_matmul(torch.tensor(vals), targets, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # The port's order is the explicit one: each receiver's senders in
    # ascending index onto 0.
    np.testing.assert_array_equal(
        got.view(np.int32),
        delivery.deliver(torch.tensor(vals), targets, n).numpy().view(np.int32))


def test_deliver_matmul_pad_targets_match_nothing():
    n = 300
    r = np.random.default_rng(0)
    targets = r.integers(-1, n, n)
    vals = r.random(n).astype(np.float32)
    want = np.zeros(n, np.float64)
    np.add.at(want, targets[targets >= 0], vals[targets >= 0])
    got = delivery.deliver_matmul(torch.tensor(vals), torch.tensor(targets), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    jgot = jax_delivery.deliver_matmul(jnp.asarray(vals), jnp.asarray(targets), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6)


@pytest.mark.parametrize("shape", [(200,), (2, 333)])
def test_aggregate_full_is_jax_and_brute_force(shape):
    r = np.random.default_rng(1)
    vals = r.random(shape).astype(np.float32)
    got = delivery.aggregate_full(torch.tensor(vals)).numpy()
    want = np.asarray(jax_delivery.aggregate_full(jnp.asarray(vals)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    brute = vals.sum(axis=-1, keepdims=True, dtype=np.float64) - vals
    np.testing.assert_allclose(got, brute, rtol=1e-5)


def _csr(n, seed):
    r = np.random.default_rng(seed)
    deg = r.integers(0, 6, n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = r.integers(0, n, int(deg.sum()))
    return indptr, indices


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("channels", [None, 2])
def test_spmv_plan_and_delivery_are_jax_and_brute_force(n, channels):
    indptr, indices = _csr(n, n)
    plan = delivery.build_spmv_plan(indptr, indices, n)
    jplan = jax_delivery.build_spmv_plan(indptr, indices, n)
    for field in ("n", "nb"):
        assert getattr(plan, field) == getattr(jplan, field)
    for field in ("tiles", "tile_ids", "src_blocks"):
        np.testing.assert_array_equal(getattr(plan, field), getattr(jplan, field))
    r = np.random.default_rng(2)
    shape = (n,) if channels is None else (channels, n)
    vals = r.random(shape).astype(np.float32)
    got = delivery.deliver_spmv(torch.tensor(vals), plan).numpy()
    want = np.asarray(jax_delivery.deliver_spmv(jnp.asarray(vals), jplan))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    brute = np.zeros(shape, np.float64)
    for j in range(n):
        for i in indices[indptr[j]:indptr[j + 1]]:
            brute[..., j] += vals[..., i]
    np.testing.assert_allclose(got, brute, rtol=1e-5)
    ints = r.integers(0, 5, shape).astype(np.int32)
    np.testing.assert_array_equal(
        delivery.deliver_spmv(torch.tensor(ints), plan).numpy(),
        np.asarray(jax_delivery.deliver_spmv(jnp.asarray(ints), jplan)))


def both_runs(kind, n, algorithm, engine="chunked", **kw):
    fields = dict(n=n, topology=kind, algorithm=algorithm, delivery="matmul",
                  seed=SEED, **kw)
    seen = {}
    jres = jax_runner.run(jax_topology(kind, n, seed=SEED),
                          JaxConfig(**fields, engine="chunked"),
                          on_chunk=lambda rounds, st: seen.update(state=st))
    tres = run(build_topology(kind, n, seed=SEED), SimConfig(**fields, engine=engine),
               device="cpu")
    return jres, seen["state"], tres


def assert_same_run(jres, jstate, tres):
    assert (tres.rounds, tres.converged_count, tres.outcome) == (
        jres.rounds, jres.converged_count, jres.outcome)
    assert tres.estimate_mae == jres.estimate_mae
    for name in tres.state._fields:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tres.state, name).numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind,n,engine", [("full", 1000, "chunked"),
                                           ("full", 1000, "fused"),
                                           ("imp2d", 900, "chunked")])
@pytest.mark.parametrize("K", [2, 4])
def test_gossip_under_matmul_is_jax(kind, n, engine, K):
    assert_same_run(*both_runs(kind, n, "gossip", engine, pool_size=K))


@pytest.mark.parametrize("engine", ["chunked", "fused"])
def test_pushsum_matmul_at_pool_size_2_is_jax(engine):
    assert_same_run(*both_runs("full", 1000, "push-sum", engine, pool_size=2))


# The port's own push-sum matmul runs at pool_size 4, recorded on the CPU
# (the order is host-independent): JAX's rounds follow its host's thread
# count, so they are not pinned.
OWN_ROUNDS = {("full", 1000): 339, ("imp2d", 900): 380}


@pytest.mark.parametrize("kind,n", sorted(OWN_ROUNDS))
def test_pushsum_matmul_at_pool_size_4_holds_the_float_contract(kind, n):
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", delivery="matmul",
                    pool_size=4, seed=SEED)
    res = run(build_topology(kind, n, seed=SEED), cfg, device="cpu")
    assert res.converged and res.converged_count == n
    s = res.state.s.double().sum().item()
    w = res.state.w.double().sum().item()
    assert abs(w - n) <= 1e-5 * n
    assert abs(s - n * (n - 1) / 2) <= 1e-5 * n * (n - 1) / 2
    assert res.estimate_mae / res.true_mean < 1e-6
    assert res.rounds == OWN_ROUNDS[kind, n]
    # The pool-order run of the same config is JAX's pool run, bitwise.
    fields = dict(n=n, topology=kind, algorithm="push-sum", delivery="pool",
                  pool_size=4, seed=SEED, engine="chunked")
    jpool = jax_runner.run(jax_topology(kind, n, seed=SEED), JaxConfig(**fields))
    tpool = run(build_topology(kind, n, seed=SEED), SimConfig(**fields), device="cpu")
    assert (tpool.rounds, tpool.estimate_mae) == (jpool.rounds, jpool.estimate_mae)


@pytest.mark.parametrize("n", [1000, 5000])
def test_full_takes_the_pool_tiers_with_jax_reasons(n, monkeypatch):
    # Past MAX_POOL_NODES (monkeypatched in both packages) the streaming
    # tier, rows 3-4.
    for big in (False, True):
        if big:
            monkeypatch.setattr(fused_pool, "MAX_POOL_NODES", n - 1)
            monkeypatch.setattr(jax_fused_pool, "MAX_POOL_NODES", n - 1)
        for kw in ({}, {"fault_rate": 0.1}, {"telemetry": True},
                   {"dup_rate": 0.1}):
            cfg = SimConfig(n=n, topology="full", algorithm="gossip",
                            delivery="matmul", **kw)
            jcfg = JaxConfig(n=n, topology="full", algorithm="gossip",
                             delivery="matmul", **kw)
            topo, jtopo = build_topology("full", n), jax_topology("full", n)
            variant, reason = runner.fused_tier(topo, cfg)
            assert variant == ("pool2" if big else "pool")
            want = (jax_fused_pool2.pool2_support(jtopo, jcfg) if big
                    else jax_fused_pool.pool_fused_support(jtopo, jcfg))
            if kw.get("telemetry") and big:
                want = ("telemetry counters run in the fused stencil/pool "
                        "kernels only (selected tier: 'pool2')")
            assert reason == want


def test_imp_matmul_runs_chunked_and_refuses_fused_as_jax():
    fields = dict(n=900, topology="imp2d", algorithm="gossip", delivery="matmul",
                  seed=SEED, engine="fused")
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology("imp2d", 900, seed=SEED), JaxConfig(**fields))
    with pytest.raises(ValueError) as terr:
        run(build_topology("imp2d", 900, seed=SEED), SimConfig(**fields), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind,n,engine", [("full", 4096, "chunked"),
                                           ("full", 4096, "auto"),
                                           ("imp2d", 900, "fused"),
                                           ("full", 1000, "fused")])
def test_sharded_matmul_refusals_are_jax(kind, n, engine):
    # The sharded XLA engine (engine chunked/auto), the imp composition and,
    # at a population whose padded rows do not split (full 1000 over 3),
    # both implicit-full compositions, each with the JAX ladder's text; the
    # VMEM replicated composition's is the matmul one.
    S = 3 if kind == "full" and engine == "fused" else 2
    fields = dict(n=n, topology=kind, algorithm="gossip", delivery="matmul",
                  seed=SEED, engine=engine, n_devices=S)
    with pytest.raises(ValueError) as jerr:
        jax_runner.run(jax_topology(kind, n, seed=SEED), JaxConfig(**fields))
    with pytest.raises(ValueError) as terr:
        run(build_topology(kind, n, seed=SEED), SimConfig(**fields), device="cpu",
            devices=["cpu"] * S)
    assert str(terr.value) == str(jerr.value)


def test_matmul_off_the_pool_kinds_is_refused_as_jax():
    fields = dict(n=100, topology="grid2d", algorithm="gossip", delivery="matmul")
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ValueError) as terr:
        SimConfig(**fields)
    assert str(terr.value) == str(jerr.value)
