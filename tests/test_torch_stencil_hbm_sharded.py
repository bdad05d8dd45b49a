"""The port's streaming sharded lattice composition (cop5615_gossip_protocol_
tpu_torch/parallel/fused_hbm_sharded.py, the JAX package's B11) on the CPU,
its shards placed explicitly on the CPU (``devices=["cpu"] * S``), where its
wrappers run their plain versions. Checked:

- one super-step of each JAX shard kernel
  (``make_pushsum_stencil_hbm_shard_chunk``,
  ``make_gossip_stencil_hbm_shard_chunk``, the XLA-wire form), in Pallas
  interpret mode, on every shard, against the port's plain version on the
  same extended planes: the middle rows, the rounds run and u. Gossip is
  bitwise; push-sum is bitwise on data with no subnormal, where the JAX
  kernel's halve after the class sums rounds as the port's halve before
  them. At torus3d 125,000 x4 (which the resident plan refuses) and
  grid2d 300**2 x4 (non-wrap, one roll per class), from the initial state
  and from a mid-run state; ring 131,072 x4 and whole runs are in
  tests/test_torch_stencil_hbm_sharded_runs.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_topology
from cop5615_gossip_protocol_tpu.parallel import fused_hbm_sharded as jax_fh
from cop5615_gossip_protocol_tpu.parallel import fused_sharded as jax_fs

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.parallel import fused_hbm_sharded

from test_torch_stencil_sharded import (
    _ext, _jax_keys, _planes, _same)

# One torch thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

TORUS = 125_000
S = 4

SUPERSTEPS = [("torus3d", TORUS, "gossip", "init"), ("torus3d", TORUS, "push-sum", "mid"),
              ("grid2d", 90_000, "gossip", "init"), ("grid2d", 90_000, "push-sum", "mid")]


@pytest.mark.parametrize("kind,n,algorithm,state", SUPERSTEPS)
def test_superstep_matches_the_jax_kernel(kind, n, algorithm, state):
    check_superstep(kind, n, algorithm, state)


def check_superstep(kind, n, algorithm, state):
    """Every shard's middle rows, rounds run and u after one super-step of
    CR = 1 round from round 40, the JAX kernel in interpret mode. The
    push-sum data (``_planes``) holds no subnormal, so the halve's place
    leaves every float bitwise."""
    kw = dict(n=n, topology=kind, algorithm=algorithm, engine="fused",
              n_devices=S, chunk_rounds=1)
    jtopo, topo = jax_topology(kind, n), build_topology(kind, n)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    assert isinstance(jax_fs.plan_fused_sharded(jtopo, jcfg, S), str)
    H, rows_loc, CR, PT, layout = jax_fh.plan_stencil_hbm_sharded(jtopo, jcfg, S)
    assert fused_hbm_sharded.plan_stencil_hbm_sharded(topo, cfg, S)[:4] == (
        H, rows_loc, CR, PT)
    make = ("make_pushsum_stencil_hbm_shard_chunk" if algorithm == "push-sum"
            else "make_gossip_stencil_hbm_shard_chunk")
    jchunk, _ = getattr(jax_fh, make)(jtopo, jcfg, H, rows_loc, PT, layout,
                                      interpret=True)
    chunk, rows_ext = getattr(fused_hbm_sharded, make)(topo, cfg, H, rows_loc, PT,
                                                       layout)
    glob = _planes(topo.n, layout.n_pad, algorithm, state)
    keys, my_keys = _jax_keys(40, CR)
    R = layout.rows
    for dev in range(S):
        row0 = (dev * rows_loc - H + 2 * R) % R
        ext = _ext(glob, R, row0, rows_ext)
        out, ex, u = jchunk(tuple(jnp.asarray(e) for e in ext), jnp.asarray(keys),
                            row0, dev, 40, 40 + CR)
        mine, my_ex, my_u = chunk(tuple(torch.from_numpy(e.copy()) for e in ext),
                                  my_keys, row0, dev, 40, 40 + CR)
        assert int(ex) == my_ex == CR
        assert np.array_equal(np.asarray(u), my_u.numpy()), (dev, u, my_u)
        for a, b in zip(out, mine):
            assert _same(np.asarray(a), b.numpy()), dev
