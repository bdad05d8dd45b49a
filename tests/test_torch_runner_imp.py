"""The port's chunked imp pooled round (models/runner.py) against the JAX
chunked engine on the CPU, on one topology carried across with
utils/carry.py:

- the round's sampling (``imp_pool_parts``: sampled displacement,
  long-range flag, pool choice, pool offsets, send gate) for given round
  keys;
- whole runs to convergence, both algorithms, pool_size 2 and 4, gossip
  with suppression, and a push-sum run resumed mid-way from a carried JAX
  state: rounds, converged count, estimate_mae and the final state equal,
  push-sum s/w bitwise (the same float32 op order);
- the CLI: an imp run with --delivery pool gives the JAX CLI's record; one
  without it, or in reference semantics, exits 2."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cop5615_gossip_protocol_tpu import SimConfig as JaxConfig
from cop5615_gossip_protocol_tpu import build_topology as jax_build
from cop5615_gossip_protocol_tpu.cli import main as jax_main
from cop5615_gossip_protocol_tpu.models import runner as jax_runner
from cop5615_gossip_protocol_tpu.ops import sampling as jax_sampling
from cop5615_gossip_protocol_tpu.ops import topology as jax_topology

from cop5615_gossip_protocol_tpu_torch import SimConfig, run
from cop5615_gossip_protocol_tpu_torch.cli import main
from cop5615_gossip_protocol_tpu_torch.models import runner
from cop5615_gossip_protocol_tpu_torch.ops import topology
from cop5615_gossip_protocol_tpu_torch.utils import carry

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


@pytest.mark.parametrize("kind,n,pool_size", [("imp3d", 1000, 4), ("imp2d", 300, 2)])
def test_imp_pool_parts_match_jax(kind, n, pool_size):
    jtopo = jax_build(kind, n, seed=2)
    topo = carry.topology_from_numpy(jtopo)
    jsplit, split = jax_topology.imp_split(jtopo), topology.imp_split(topo)
    jcfg = JaxConfig(n=n, topology=kind, delivery="pool", pool_size=pool_size)
    cfg = SimConfig(n=n, topology=kind, delivery="pool", pool_size=pool_size)
    for r in (0, 7, 1234):
        kr = jax_sampling.round_key(jax.random.PRNGKey(9), r)
        want = jax_runner.imp_pool_parts(jtopo, jcfg, kr, jnp.asarray(jsplit.disp_cols),
                                         jnp.asarray(jsplit.degree))
        got = runner.imp_pool_parts(topo, cfg, carry.key_from_numpy(np.asarray(kr)),
                                    torch.from_numpy(split.disp_cols),
                                    torch.from_numpy(split.degree))
        for name, g, w in zip(("d", "is_extra", "choice", "offs", "send_ok"), got, want):
            assert (g.numpy() == np.asarray(w)).all(), (name, r)
        assert got[1].any() and (got[0] >= 0).any()  # both kinds of slot drawn


def _jax_run(kind, n, algorithm, **kw):
    final = {}
    cfg = JaxConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool",
                    engine="chunked", **kw)
    jtopo = jax_build(kind, n, seed=kw.get("seed", 0))
    res = jax_runner.run(jtopo, cfg, on_chunk=lambda r, s: final.__setitem__("s", s))
    return jtopo, res, final["s"]


def _assert_same_run(res, jres, jstate):
    assert (res.rounds, res.converged, res.converged_count, res.population,
            res.target_count) == (jres.rounds, jres.converged, jres.converged_count,
                                  jres.population, jres.target_count)
    assert res.estimate_mae == jres.estimate_mae
    for a, b in zip(res.state, jstate):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert (a == b).all()


@pytest.mark.parametrize("kind,n,algorithm,pool_size,suppress", [
    ("imp2d", 300, "gossip", 4, None),
    ("imp2d", 300, "push-sum", 2, None),
    ("imp3d", 1000, "gossip", 2, None),
    ("imp3d", 1000, "push-sum", 4, None),
    ("imp3d", 1000, "gossip", 4, True),
])
def test_chunked_run_matches_jax(kind, n, algorithm, pool_size, suppress):
    kw = {"seed": 4, "pool_size": pool_size, "suppress_converged": suppress,
          "chunk_rounds": 128}
    jtopo, jres, jstate = _jax_run(kind, n, algorithm, **kw)
    cfg = SimConfig(n=n, topology=kind, algorithm=algorithm, delivery="pool", **kw)
    assert runner.fused_tier(carry.topology_from_numpy(jtopo), cfg) == ("imp", None)
    res = run(carry.topology_from_numpy(jtopo), cfg, device="cpu")
    assert res.converged
    _assert_same_run(res, jres, jstate)


def test_chunked_resume_from_carried_jax_state():
    kind, n, seed, mid = "imp2d", 300, 3, 40
    jtopo, jres, jstate = _jax_run(kind, n, "push-sum", seed=seed, chunk_rounds=64)
    _, _, jmid = _jax_run(kind, n, "push-sum", seed=seed, chunk_rounds=mid,
                          max_rounds=mid)
    start = carry.state_from_numpy({k: np.asarray(v) for k, v in jmid._asdict().items()})
    key = carry.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)))
    cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", delivery="pool",
                    seed=seed, chunk_rounds=64)
    res = run(carry.topology_from_numpy(jtopo), cfg, key=key, device="cpu",
              start_state=start, start_round=mid)
    _assert_same_run(res, jres, jstate)


def _record(capsys, fn, argv):
    rc = fn(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["1000", "imp3D", "push-sum", "--delivery", "pool"],
    ["300", "imp2D", "gossip", "--delivery", "pool", "--pool-size", "2", "--seed", "5"],
])
def test_cli_imp_record_matches_jax_cli(capsys, argv):
    jrc, jrec = _record(capsys, jax_main, argv)
    rc, rec = _record(capsys, main, argv + ["--platform", "cpu"])
    assert rc == jrc == 0
    for field in ("topology_kind", "rounds", "outcome", "converged_count",
                  "estimate_mae", "population", "target_count", "max_deg"):
        assert rec[field] == jrec[field], field
    assert rec["config"] == jrec["config"]


@pytest.mark.parametrize("argv,needles", [
    (["1000", "imp3d", "push-sum", "--delivery", "matmul"], ("ROADMAP A7b",)),
    (["1000", "imp2d", "gossip", "--delivery", "stencil"], ("offset-structured",)),
    (["1000", "imp3d", "gossip", "--delivery", "pool", "--semantics", "reference"],
     ("Q9",)),
])
def test_cli_imp_refusals(capsys, argv, needles):
    assert main(argv + ["--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert all(s in err for s in needles), err


def test_imp_entry_points_refuse_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this pins the behaviour without one")
    argv = ["27000", "imp3d", "push-sum", "--delivery", "pool"]
    assert main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
    topo = topology.build_topology("imp3d", 27_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(topo, SimConfig(n=27_000, topology="imp3d", delivery="pool"))
