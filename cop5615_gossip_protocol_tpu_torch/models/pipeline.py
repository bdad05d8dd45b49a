"""Speculative chunk pipelining: the host-side chunk loop.

Up to ``depth`` chunks are in flight: chunk k+1 is queued on the current
CUDA stream before chunk k's termination status is read, and each chunk's
small (rounds, done) status is copied to pinned host memory as soon as it
is queued, so retiring a chunk waits on one event and reads two integers.
Correctness rests on the overshoot contract every chunk function keeps: a
chunk queued at an already-terminal carry is a no-op (state unchanged,
round counter unchanged), so ``rounds`` is the retired carry's own exact
count, never rounded up to the pipeline depth.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class ChunkLoopResult:
    """Outcome of one pipelined chunk loop."""

    state: object  # final carry state
    rounds: int  # exact executed-round count (the retired carry's counter)
    done: bool  # the engine's own termination flag at the final boundary
    chunks_retired: int
    dispatch_s: float = 0.0  # host time queueing chunks
    fetch_s: float = 0.0  # host time blocked on the status readback
    first_dispatch_s: float = 0.0  # the first chunk's queueing time alone
    # Per retired chunk, in order: {"rounds", "dispatch_s", "fetch_s"}.
    chunk_log: list = dataclasses.field(default_factory=list)


def _prefetch(status):
    """Start the device-to-host copy of a chunk's (rounds, done) status.
    Returns a handle ``_read`` turns into two Python ints."""
    if isinstance(status, torch.Tensor) and status.is_cuda:
        host = torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
        host.copy_(status, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(status.device))
        return host, event
    return status, None


def _read(handle) -> tuple[int, bool]:
    status, event = handle
    if event is not None:
        event.synchronize()  # blocks until the chunk (and its copy) is done
    rounds, done = (int(v) for v in status)
    return rounds, bool(done)


def advance(state, new, status, target: int):
    """One round of a chunk that stays on the device, under the overshoot
    contract: ``new`` (the round's output) replaces ``state`` unless
    ``status`` (int32 [2]: rounds, done) is already done. The round is
    counted and done re-tested against ``target`` converged nodes on the
    device, with no host read; ``status`` is updated in place."""
    done = status[1] != 0
    out = type(state)(*(torch.where(done, a, b) for a, b in zip(state, new)))
    status[0] += (~done).to(status.dtype)
    status[1] = (done | (out.conv.sum() >= target)).to(status.dtype)
    return out


def run_chunks(*, dispatch: Callable, state0, status0, start_round: int,
               max_rounds: int, stride: int, depth: int,
               next_end: Optional[Callable[[int], int]] = None) -> ChunkLoopResult:
    """Drive ``dispatch(state, status, round_end) -> (state, status)`` to
    termination with up to ``depth`` chunks in flight.

    ``status`` is the (rounds, done) pair of the carry: an int tensor [2] on
    the device, or a tuple of Python values for engines that decide on the
    host. ``dispatch`` advances to ``round_end`` (absolute round index),
    stops early on its own termination predicate, and must be an overshoot
    no-op. A chunk queued at boundary k targets ``min(start + (k+1) *
    stride, max_rounds)``: the schedule of the serial loop, because a
    non-terminal chunk always runs to its round_end. ``next_end(end)``, if
    given, replaces that schedule: the chunk after the one ending at
    ``end`` ends at ``next_end(end)`` (at most max_rounds)."""
    depth = max(1, int(depth))
    inflight: collections.deque = collections.deque()
    head = (state0, status0)
    last_end = start_round
    retired = 0
    dispatched = 0
    dispatch_total = fetch_total = first_dispatch = 0.0
    chunk_log: list = []

    def fill() -> None:
        """Top the pipeline up. Chunks that could not advance past
        max_rounds are never queued, except the very first."""
        nonlocal head, last_end, dispatch_total, dispatched, first_dispatch
        while len(inflight) < depth and (
            last_end < max_rounds or (not inflight and retired == 0)
        ):
            last_end = (min(last_end + stride, max_rounds) if next_end is None
                        else min(next_end(last_end), max_rounds))
            t0 = time.perf_counter()
            head = dispatch(head[0], head[1], last_end)
            disp_s = time.perf_counter() - t0
            dispatch_total += disp_s
            if dispatched == 0:
                first_dispatch = disp_s
            dispatched += 1
            inflight.append((head, _prefetch(head[1]), disp_s))

    fill()
    rounds, done = start_round, False
    final = head
    while inflight:
        cur, handle, disp_s = inflight.popleft()
        t0 = time.perf_counter()
        rounds, done = _read(handle)
        fetch_s = time.perf_counter() - t0
        fetch_total += fetch_s
        retired += 1
        chunk_log.append(
            {"rounds": rounds, "dispatch_s": disp_s, "fetch_s": fetch_s}
        )
        final = cur
        if done or rounds >= max_rounds:
            # Chunks still in flight are no-ops by the overshoot contract.
            inflight.clear()
            break
        fill()
    return ChunkLoopResult(
        state=final[0], rounds=rounds, done=done, chunks_retired=retired,
        dispatch_s=dispatch_total, fetch_s=fetch_total,
        first_dispatch_s=first_dispatch, chunk_log=chunk_log,
    )
