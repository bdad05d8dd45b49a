"""The port's chunked engine with the drop gate, crash-stop with quorum
termination and push-sum's global termination on imp2d, under scatter
delivery (along the static extra edge) and pool delivery (the long-range
edge drawn from the round's pool), against the JAX package's chunked
engine: rounds, converged count, outcome, estimate_mae and every final
plane bitwise (a draining push-sum run: its planes to round 100; the
helpers of tests/test_torch_runner_faults.py)."""

import pytest
import torch

from test_torch_runner_faults import (FAULTS, assert_same_run, both_runs, drains,
                                      early_planes, faulted_cases)

# One torch thread: the suite runs in several worker processes at once, and
# torch's default of a thread per core would oversubscribe the machine.
torch.set_num_threads(1)


@pytest.mark.parametrize("kind,n,delivery,algorithm,faults", faulted_cases(
    [("imp2d", 900, "scatter", None), ("imp2d", 900, "pool", None)]))
def test_chunked_engine_matches_jax_on_imp(kind, n, delivery, algorithm, faults):
    jres, jstate, tres = both_runs(kind, n, delivery, algorithm, **FAULTS[faults])
    assert tres.converged
    if drains(kind, algorithm, faults):
        jres, jstate, tres = early_planes(jres, tres, kind, n, delivery, algorithm,
                                          faults)
    assert_same_run(jres, jstate, tres)
