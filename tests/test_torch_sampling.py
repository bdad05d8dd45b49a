"""The port's sampling and delivery (cop5615_gossip_protocol_tpu_torch/ops/
sampling.py, delivery.py) against the JAX package's, bitwise, at n = 1000
(padded mod-n tail), 65536 (no pad) and 70000 (two TPU tiles)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu.ops import delivery as jax_delivery
from cop5615_gossip_protocol_tpu.ops import fused_pool as jax_fused_pool
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling

from cop5615_gossip_protocol_tpu_torch.ops import delivery, fused_pool, rng, sampling

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)

SIZES = [1000, 65536, 70000]


def _keys(seed, r):
    return (jax_sampling.round_key(jax.random.PRNGKey(seed), r),
            sampling.round_key(rng.PRNGKey(seed), r))


def test_constants():
    for name in ("STREAM_VERSION", "POOL_CHOICE_BITS", "POOL_PACK",
                 "POOL_TILE_ROWS", "_POOL_TAG"):
        assert getattr(sampling, name) == getattr(jax_sampling, name)


@pytest.mark.parametrize("n", SIZES)
def test_layout_and_words(n):
    assert sampling.pool_rows(n) == jax_sampling.pool_rows(n)
    jl, tl = jax_fused_pool.build_pool_layout(n), fused_pool.build_pool_layout(n)
    assert (jl.n, jl.n_pad, jl.rows, jl.tiles) == (tl.n, tl.n_pad, tl.rows, tl.tiles)
    jk, tk = _keys(3, 17)
    want = np.asarray(jax_sampling.pool_words(jk, n)).astype(np.int64)
    assert (sampling.pool_words(tk, n).numpy() == want).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pool_size", [2, 4, 16, 32])
def test_pool_choice_packed(n, pool_size):
    # 32 exceeds the 4-bit packing and takes the full-word stream.
    jk, tk = _keys(1, 5)
    want = np.asarray(jax_sampling.pool_choice_packed(jk, n, pool_size))
    got = sampling.pool_choice_packed(tk, n, pool_size)
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    want_long = np.asarray(jax_sampling.pool_choice_packed(jk, n, pool_size, n + 300))
    got_long = sampling.pool_choice_packed(tk, n, pool_size, out_len=n + 300)
    assert (got_long.numpy() == want_long).all()


@pytest.mark.parametrize("n", SIZES)
def test_pool_offsets(n):
    for r in (0, 1, 999):
        jk, tk = _keys(7, r)
        for pool_size in (2, 4, 16):
            want = np.asarray(jax_sampling.pool_offsets(jk, pool_size, n))
            got = sampling.pool_offsets(tk, pool_size, n)
            assert got.dtype == torch.int32 and (got.numpy() == want).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pool_size", [2, 4])
def test_deliver_pool_bitwise(n, pool_size):
    rs = np.random.default_rng(n + pool_size)
    floats = rs.standard_normal((2, n)).astype(np.float32) * 1e3
    ints = rs.integers(0, 2, size=(1, n)).astype(np.int32)
    jk, tk = _keys(2, 3)
    jchoice = jax_sampling.pool_choice_packed(jk, n, pool_size)
    joffs = jax_sampling.pool_offsets(jk, pool_size, n)
    tchoice = sampling.pool_choice_packed(tk, n, pool_size)
    toffs = sampling.pool_offsets(tk, pool_size, n).tolist()
    for arr in (floats, ints):
        want = np.asarray(jax_delivery.deliver_pool(jnp.asarray(arr), jchoice, joffs))
        got = delivery.deliver_pool(torch.from_numpy(arr), tchoice, toffs).numpy()
        assert got.dtype == want.dtype
        assert (got.view(np.int32) == want.view(np.int32)).all()
