"""The termination verdict's schedule for the sharded compositions: the
counterpart of the JAX package's parallel/overlap.py.

A super-step of a sharded composition is its wire, one launch per shard
(one round in the replicated-pool2 composition, up to CR rounds in the
lattice compositions) and a verdict: the sum of the shards' converged
counts after the super-step's last round against the target, taken on the
device (the done flag and round counter the next launches read). With
``overlap`` off the verdict of super-step i is queued right after its
launches. With it on, it is queued one super-step late, after super-step
i + 1's launches, as the JAX schedule defers its psum under the next
super-step's kernel, and the rollback is exact: super-step i + 1 reads
super-step i's planes and never writes them, and a verdict that fires
leaves the round counter at super-step i's end, which names its planes, so
super-step i + 1's work is never observed. The last verdict of a chunk is
drained before the chunk ends. Either schedule gives the same rounds and
state; nothing is read on the host per super-step.
"""

from __future__ import annotations

from typing import Callable, Iterable


def next_boundary(b: int, start: int, stride: int, cr: int, max_rounds: int) -> int:
    """The super-step boundary after boundary ``b`` in the JAX lattice
    compositions' schedule: chunks of ``stride`` rounds from ``start`` (the
    last cut at ``max_rounds``), each run as super-steps of ``cr`` rounds
    from its start, the last cut at its end."""
    chunk = start + ((b - start) // stride) * stride
    return min(b + cr, chunk + stride, max_rounds)


def overlapped_superstep_loop(steps: Iterable, *, launch: Callable, verdict: Callable,
                              overlap: bool) -> None:
    """Queue ``steps`` in order: ``launch(step)`` queues a super-step's wire
    and shard launches, ``verdict(step)`` its verdict, in the serial or the
    deferred order (the JAX loop of the same name)."""
    pending = None
    for step in steps:
        launch(step)
        if not overlap:
            verdict(step)
            continue
        if pending is not None:
            verdict(pending)
        pending = step
    if pending is not None:
        verdict(pending)


def superstep_rounds(start: int, end: int, *, launch_round: Callable[[int], None],
                     verdict: Callable[[int], None], overlap: bool) -> None:
    """Queue rounds start..end-1: ``launch_round(r)`` queues round r's wire
    and shard launches, ``verdict(r)`` its verdict, in the serial or the
    deferred order: super-steps of one round."""
    overlapped_superstep_loop(range(start, end), launch=launch_round,
                              verdict=verdict, overlap=overlap)
