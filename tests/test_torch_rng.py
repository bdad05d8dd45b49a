"""The port's random stream (cop5615_gossip_protocol_tpu_torch/ops/rng.py)
against jax.random, bit for bit: keys, fold_in, split, bits, randint, and
the streams built on them (round keys, displacement pools, the leader)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import fused as jax_fused
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_pool, rng

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 7]
TAGS = [0, 17, 0x0FF5, 0x5EED, 2**31 - 1]


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    jkey = jax.random.PRNGKey(seed)
    key = rng.PRNGKey(seed)
    assert (key.numpy() == _u32(jkey)).all()
    for tag in TAGS:
        assert (rng.fold_in(key, tag).numpy()
                == _u32(jax.random.fold_in(jkey, tag))).all()
    assert (rng.split(key, 3).numpy() == _u32(jax.random.split(jkey, 3))).all()


@pytest.mark.parametrize("shape", [(7,), (300, 257), (3, 5, 4400)])
@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
def test_bits_past_2_16(shape, seed):
    # (300, 257) and (3, 5, 4400) put counters past 2**16.
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED)
    want = _u32(jax.random.bits(jkey, shape, jnp.uint32))
    got = rng.bits(rng.fold_in(rng.PRNGKey(seed), 0x5EED), shape).numpy()
    assert got.shape == want.shape and (got == want).all()


@pytest.mark.parametrize("minval,maxval", [(0, 1000), (0, 65536), (0, 70000),
                                           (0, 1000001), (5, 17), (3, 3)])
@pytest.mark.parametrize("shape", [(), (50,)])
def test_randint(minval, maxval, shape):
    for seed in (0, 3):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 - 1)
        want = np.asarray(jax.random.randint(jkey, shape, minval, maxval,
                                             dtype=jnp.int32))
        key = rng.fold_in(rng.PRNGKey(seed), 2**31 - 1)
        got = rng.randint(key, shape, minval, maxval).numpy()
        assert got.shape == want.shape and (got == want).all()


@pytest.mark.parametrize("row0", [0, 64, 1000])
def test_threefry_bits_2d(row0):
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    k1, k2 = (jnp.uint32(v) for v in np.asarray(jkey))
    want = _u32(jax_fused.threefry_bits_2d(k1, k2, 64, 128, row0=row0))
    key = rng.fold_in(rng.PRNGKey(4), 2)
    got = fused.threefry_bits_2d(int(key[0]), int(key[1]), 64, 128, row0=row0)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("start", [0, 37, 2**20])
def test_round_keys_and_offsets(start):
    jkey = jax.random.PRNGKey(11)
    key = rng.PRNGKey(11)
    assert (fused.round_keys(key, start, 20).numpy()
            == _u32(jax_fused.round_keys(jkey, start, 20))).all()
    for pool, n in ((2, 1000), (4, 70000), (16, 1000000)):
        want = np.asarray(jax_fused_pool.round_offsets(jkey, start, 20, pool, n))
        got = fused_pool.round_offsets(key, start, 20, pool, n).numpy()
        assert got.dtype == np.int32 and (got == want).all()


@pytest.mark.parametrize("n,semantics", [(1000, "batched"), (70000, "batched"),
                                         (1000000, "batched"),
                                         (1000, "reference")])
def test_draw_leader(n, semantics):
    for seed in (0, 5):
        jcfg = JaxConfig(n=n, topology="full", algorithm="gossip",
                         semantics=semantics, seed=seed)
        want = int(jax_runner.draw_leader(
            jax.random.PRNGKey(seed), jax_topology("full", n, semantics=semantics),
            jcfg))
        cfg = SimConfig(n=n, algorithm="gossip", semantics=semantics, seed=seed,
                        delivery="pool")
        got = runner.draw_leader(
            rng.PRNGKey(seed), build_topology("full", n, semantics=semantics), cfg)
        assert got == want
