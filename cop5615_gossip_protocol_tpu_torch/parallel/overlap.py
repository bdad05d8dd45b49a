"""The termination verdict's schedule for the sharded compositions: the
counterpart of the JAX package's parallel/overlap.py.

A round of the replicated-pool2 composition is its wire, one launch per
shard and a verdict: the sum of the shards' converged counts against the
target, taken on the device (the done flag and round counter the next
launches read). With ``overlap`` off the verdict of round r is queued
right after round r's launches. With it on, it is queued one round late,
after round r + 1's launches, as the JAX schedule defers its psum under the
next round's kernel, and the rollback is exact: round r + 1 read round r's
planes and wrote the other set of its ping/pong pair, and a verdict that
fires at round r leaves the round counter at r + 1, whose parity names
round r's planes, so round r + 1's work is never observed. The last
verdict of a chunk is drained before the chunk ends. Either schedule gives
the same rounds and state; nothing is read on the host per round.
"""

from __future__ import annotations

from typing import Callable


def superstep_rounds(start: int, end: int, *, launch_round: Callable[[int], None],
                     verdict: Callable[[int], None], overlap: bool) -> None:
    """Queue rounds start..end-1: ``launch_round(r)`` queues round r's wire
    and shard launches, ``verdict(r)`` its verdict, in the serial or the
    deferred order."""
    pending = None
    for r in range(start, end):
        launch_round(r)
        if not overlap:
            verdict(r)
            continue
        if pending is not None:
            verdict(pending)
        pending = r
    if pending is not None:
        verdict(pending)
