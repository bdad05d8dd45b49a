"""One round of the port's protocol models (cop5615_gossip_protocol_tpu_torch/
models/pushsum.py, gossip.py) against the JAX package's, bitwise, on inputs
made from a seed with numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu.models import gossip as jax_gossip
from cop5615_gossip_protocol_tpu.models import pushsum as jax_pushsum

from cop5615_gossip_protocol_tpu_torch.models import gossip, pushsum

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    if got.dtype == np.float32:
        return got.shape == want.shape and (got.view(np.int32) == want.view(np.int32)).all()
    return got.dtype == want.dtype and (got == want).all()


@pytest.mark.parametrize("n", [1000, 70000])
def test_pushsum_round(n):
    rs = np.random.default_rng(n)
    s = rs.uniform(0, n, n).astype(np.float32)
    w = rs.uniform(0.1, 2, n).astype(np.float32)
    term = rs.integers(0, 3, n).astype(np.int32)
    conv = rs.random(n) < 0.2
    send_ok = rs.random(n) < 0.9
    in_s = np.where(rs.random(n) < 0.7, rs.uniform(0, n, n), 0).astype(np.float32)
    in_w = np.where(in_s > 0, rs.uniform(0, 1, n), 0).astype(np.float32)

    jstate = jax_pushsum.PushSumState(*(jnp.asarray(x) for x in (s, w, term, conv)))
    jparts = jax_pushsum.halve_and_send(jstate.s, jstate.w, jnp.asarray(send_ok))
    jnew = jax_pushsum.absorb(jstate, jparts[2], jparts[3], jnp.asarray(in_s),
                              jnp.asarray(in_w), 1e-6, 3)
    tstate = pushsum.PushSumState(*(torch.from_numpy(x) for x in (s, w, term, conv)))
    tparts = pushsum.halve_and_send(tstate.s, tstate.w, torch.from_numpy(send_ok))
    tnew = pushsum.absorb(tstate, tparts[2], tparts[3], torch.from_numpy(in_s),
                          torch.from_numpy(in_w), 1e-6, 3)
    assert all(_same(a, b) for a, b in zip(tparts, jparts))
    assert all(_same(a, b) for a, b in zip(tnew, jnew))
    init = pushsum.init_state(n, 1)
    assert all(_same(a, b) for a, b in zip(init, jax_pushsum.init_state(n, jnp.float32, 1)))


@pytest.mark.parametrize("suppress", [False, True])
def test_gossip_round(suppress):
    n = 5000
    rs = np.random.default_rng(1)
    count = rs.integers(0, 12, n).astype(np.int32)
    active = count > 0
    conv = count >= 10
    inbox = rs.integers(0, 3, n).astype(np.int32)
    send_ok = rs.random(n) < 0.8
    jstate = jax_gossip.GossipState(*(jnp.asarray(x) for x in (count, active, conv)))
    tstate = gossip.GossipState(*(torch.from_numpy(x) for x in (count, active, conv)))
    assert _same(gossip.send_values(tstate, torch.from_numpy(send_ok)),
                 jax_gossip.send_values(jstate, jnp.asarray(send_ok)))
    jnew = jax_gossip.absorb(jstate, jnp.asarray(inbox), 10, suppress)
    tnew = gossip.absorb(tstate, torch.from_numpy(inbox), 10, suppress)
    assert all(_same(a, b) for a, b in zip(tnew, jnew))
    for counts_receipt in (False, True):
        want = jax_gossip.init_state(n, 17, counts_receipt)
        got = gossip.init_state(n, 17, counts_receipt)
        assert all((a.numpy() == np.asarray(b)).all() for a, b in zip(got, want))
