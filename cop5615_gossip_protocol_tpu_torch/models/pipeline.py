"""Speculative chunk pipelining: the host-side chunk loop.

Up to ``depth`` chunks are in flight: chunk k+1 is queued on the current
CUDA stream before chunk k's termination status is read, and each chunk's
small (rounds, done) status is copied to pinned host memory as soon as it
is queued, so retiring a chunk waits on one event and reads two integers.
Correctness rests on the overshoot contract every chunk function keeps: a
chunk queued at an already-terminal carry is a no-op (state unchanged,
round counter unchanged), so ``rounds`` is the retired carry's own exact
count, never rounded up to the pipeline depth.

Under the health sentinel (``mass_tolerance``) the status carries a third
word, the first round whose state was unhealthy (NEVER while none was), and
a tripped round ends the run as done does (the JAX runner's ``health``).

Under the delay ring (``delay_rounds``) the chunked engine's carry is a
``Ringed`` pair, the protocol state and the ring of deliveries in flight;
``advance`` guards both under the overshoot contract, and the protocol
state alone (``proto_of``) is judged, traced and returned.

Under the telemetry plane (ops/telemetry.py) a chunk also returns its rows,
a ``[rounds, N_COLS]`` float32 buffer on the device: its copy to pinned
memory is queued with the status copy, behind the same event, so retiring a
chunk still waits on one event and reads nothing more from the device, and
``on_aux`` gets the rows at each retired chunk, in order. A speculative
chunk dropped at termination never reaches it.

Chunk-boundary hooks keep the serial loop's semantics (the JAX driver's):

- ``on_retire`` (the checkpoint hook) fires at RETIRED chunks, in order,
  with that chunk's state, never for a speculative one, so a checkpoint at
  boundary k is the serial loop's boundary-k checkpoint;
- ``should_stop`` (the stall watchdog) is asked at retired boundaries in
  order; when it fires at chunk k, the chunks in flight are dropped and
  the run's result is carry k (``chunks_speculative`` counts them).

Both read the retired state while later chunks may be in flight on the same
stream. A plain ``.cpu()`` would wait for every chunk queued after it and
turn depth 2 into depth 1, so the loop copies the retired state to pinned
host memory on a side stream that waits on the retired chunk's own event
(``_retired_to_host``), and the hooks get host tensors. Each engine's chunk
returns fresh state planes, so a retired state stays valid while later
chunks run; engines whose planes are reused (the sharded compositions) run
at depth 1 under hooks.

The loop times the hooks (``hook_s``), and with ``step_timing`` stamps each
chunk_log entry with ``t_retire`` and ``wall_s`` (retire to retire; the
first from loop entry), clock reads at boundaries the loop already
observes. Under ``hook_error="continue"`` an OSError in ``on_retire`` (a
full disk) is recorded in ``hook_failures`` and counted in the registry's
``gossip_tpu_checkpoint_failed_total``, and the run goes on; any other
exception propagates. ``chunkloop.dispatch`` marks each queueing in a
``torch.profiler`` trace (``--profile``).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .pushsum import flush, sum_f32

# The sentinel's word while no round has tripped (ops/faults.NEVER).
NEVER = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class ChunkLoopResult:
    """Outcome of one pipelined chunk loop."""

    state: object  # final carry state
    rounds: int  # exact executed-round count (the retired carry's counter)
    done: bool  # the engine's own termination flag at the final boundary
    chunks_retired: int
    chunks_speculative: int = 0  # queued chunks dropped by a stall exit
    dispatch_s: float = 0.0  # host time queueing chunks
    fetch_s: float = 0.0  # host time blocked on the status readback
    first_dispatch_s: float = 0.0  # the first chunk's queueing time alone
    # Per retired chunk, in order: {"rounds", "dispatch_s", "fetch_s"}.
    chunk_log: list = dataclasses.field(default_factory=list)
    # The health sentinel's first unhealthy round, or None.
    unhealthy_round: Optional[int] = None
    aux_s: float = 0.0  # host time in on_aux (a part of fetch_s)
    hook_s: float = 0.0  # host time in on_retire and should_stop
    # on_retire OSErrors survived under hook_error="continue": {"rounds",
    # "error"} per failed boundary, in order.
    hook_failures: list = dataclasses.field(default_factory=list)


class Ringed(NamedTuple):
    """The chunked engine's carry under the delay ring: the protocol state
    and the ring, float32 [D, 2, n] (push-sum's s and w) or int32 [D, n]
    (gossip's receipts), slot ``round % D`` read and then overwritten by
    round ``round`` (the JAX runner's ``(state, ring)`` carry)."""

    state: object
    ring: torch.Tensor


class RingRound(NamedTuple):
    """A round's output under the delay ring: its protocol state, the ring
    with the round's fresh inbox written at ``slot`` in place
    (``ring_step``), and what the slot held, which ``advance`` writes back
    where the round ran past done."""

    state: object
    ring: torch.Tensor
    slot: int
    old: torch.Tensor


def proto_of(carry):
    """The protocol state of a carry (the JAX runner's ``proto_of``)."""
    return carry.state if isinstance(carry, Ringed) else carry


def ring_step(ring: torch.Tensor, fresh: torch.Tensor, slot: int) -> torch.Tensor:
    """The arrival: a copy of what ``ring[slot]`` held, read before the
    round's fresh inbox is written there in place (the JAX runner's
    ``dynamic_index_in_dim`` then ``dynamic_update_index_in_dim``). One
    slot moves a round: the round returns a ``RingRound``, and a chunk
    works on its own copy of the ring (``own_ring``)."""
    old = ring[slot].clone()
    ring[slot] = fresh
    return old


def own_ring(carry):
    """``carry`` with a copy of its ring (a chunk's first step, so the
    rounds' in-place writes leave the caller's carry as it was)."""
    if isinstance(carry, Ringed):
        return Ringed(carry.state, carry.ring.clone())
    return carry


def _to_host(x):
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def _prefetch(status, aux=None):
    """Start the device-to-host copies of a chunk's (rounds, done) status
    and its telemetry rows (``aux``, or None), behind one event. Returns a
    handle ``_read`` turns into Python ints and the host rows."""
    if isinstance(status, torch.Tensor) and status.is_cuda:
        host = _to_host(status)
        aux_host = None if aux is None else _to_host(aux)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(status.device))
        return host, event, aux_host
    return status, None, aux


def _read(handle) -> tuple[int, bool, Optional[int]]:
    """(rounds, done, the sentinel's unhealthy round or None)."""
    status, event, _ = handle
    if event is not None:
        event.synchronize()  # blocks until the chunk (and its copies) are done
    rounds, done, *health = (int(v) for v in status)
    unhealthy = health[0] if health and health[0] != NEVER else None
    return rounds, bool(done), unhealthy


def health_check(n: int, tol: float, wsum: Callable = sum_f32,
                 ring_sum: Optional[Callable] = None) -> Callable:
    """The health sentinel's test of a push-sum state (the JAX runner's
    ``sentinel_bad``): a non-finite s or w, or |Σw − n| above ``tol``, in
    float32 with Σw in ``wsum``'s order (``sum_f32``'s, the JAX chunked
    engine's, unless a kernel's order is asked for). Under the delay ring
    (a ``Ringed`` carry) the ring's values count as well: a non-finite
    word in it is unhealthy, and the w in flight adds to Σw, summed by
    ``ring_sum(ring)`` (by default ``wsum`` over the flattened [D, n] w
    planes, JAX's ``sum(ring[:, 1, :])``). Returns a 0-dim bool tensor."""
    n32 = torch.tensor(n, dtype=torch.float32)
    tol32 = torch.tensor(tol, dtype=torch.float32)
    if ring_sum is None:
        def ring_sum(ring):
            return wsum(ring[:, 1, :].reshape(-1))

    def bad(carry) -> torch.Tensor:
        state = proto_of(carry)
        finite = torch.isfinite(state.s).all() & torch.isfinite(state.w).all()
        total = wsum(state.w)
        if isinstance(carry, Ringed):
            finite = finite & torch.isfinite(carry.ring).all()
            total = flush(total + ring_sum(carry.ring))
        resid = torch.abs(total - n32.to(state.w.device))
        return ~finite | (resid > tol32.to(state.w.device))

    return bad


def advance(state, new, status, target: int, alive=None, need: int = 0,
            bad=None):
    """One round of a chunk that stays on the device, under the overshoot
    contract: ``new`` (the round's output) replaces ``state`` unless
    ``status`` (int32 [2]: rounds, done) is already done. The round is
    counted and done re-tested on the device, with no host read, and
    ``status`` is updated in place: done once ``target`` nodes converged,
    or, under a crash model (``alive`` the round's alive mask, ``need`` its
    quorum need, faults.quorum_needs), once the converged live nodes reach
    the need of the round just executed. Under the health sentinel
    (``bad``, ``health_check``'s test; status int32 [3]) the round just
    executed is latched into status[2] where it is the first whose state is
    unhealthy, and that ends the run. A ``Ringed`` carry keeps its ring
    too where done is set: ``new`` is then the round's ``RingRound``, and
    its slot gets back what it held, so a round past done never rotates
    the ring."""
    done = status[1] != 0
    ring = None
    if isinstance(state, Ringed):
        ring = new.ring
        ring[new.slot] = torch.where(done, new.old, ring[new.slot])
        state, new = state.state, new.state
    out = type(state)(*(torch.where(done, a, b) for a, b in zip(state, new)))
    status[0] += (~done).to(status.dtype)
    if alive is None:
        verdict = out.conv.sum() >= target
    else:
        verdict = (out.conv & alive).sum() >= need
    if ring is not None:
        out = Ringed(out, ring)
    if bad is not None:
        trip = ~done & (status[2] == NEVER) & bad(out)
        status[2] = torch.where(trip, status[0] - 1, status[2])
        verdict = verdict | (status[2] != NEVER)
    status[1] = (done | verdict).to(status.dtype)
    return out


def _map_tensors(fn, x):
    """``x`` (a tensor, or tuples and NamedTuples of them, or None) with
    ``fn`` applied to every tensor."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [_map_tensors(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _retired_to_host(state, event, streams: dict):
    """A retired chunk's state on the host, copied on a side stream that
    waits on the chunk's own event, so the copy does not wait for the
    chunks queued after it on the current stream. Each plane is marked as
    used on the side stream (``record_stream``), so the caching allocator
    does not hand it on before the copy is done. ``streams`` holds the
    loop's side stream a device. Without an event (the CPU) the state is
    returned as it is."""
    if event is None:
        return state
    copies = []

    def copy(x):
        if not x.is_cuda:
            return x
        side = streams.get(x.device)
        if side is None:
            side = streams[x.device] = torch.cuda.Stream(x.device)
        side.wait_event(event)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(x, non_blocking=True)
        x.record_stream(side)
        copies.append(side)
        return host

    out = _map_tensors(copy, state)
    for side in dict.fromkeys(copies):
        side.synchronize()
    return out


def _count_hook_failure() -> None:
    """One more chunk-boundary checkpoint failure in the registry."""
    from ..utils import obs

    obs.default_registry().counter(
        "gossip_tpu_checkpoint_failed_total",
        "chunk-boundary checkpoint-hook I/O failures survived under "
        "hook_error='continue'",
    ).inc()


def run_chunks(*, dispatch: Callable, state0, status0, start_round: int,
               max_rounds: int, stride: int, depth: int,
               next_end: Optional[Callable[[int], int]] = None,
               on_aux: Optional[Callable[[int, int, object], None]] = None,
               on_retire: Optional[Callable[[int, object], None]] = None,
               should_stop: Optional[Callable[[int, object], bool]] = None,
               step_timing: bool = False, hook_error: str = "raise"
               ) -> ChunkLoopResult:
    """Drive ``dispatch(state, status, round_end) -> (state, status[,
    aux])`` to termination with up to ``depth`` chunks in flight.

    ``status`` is the (rounds, done) pair of the carry: an int tensor [2] on
    the device, or a tuple of Python values for engines that decide on the
    host. ``dispatch`` advances to ``round_end`` (absolute round index),
    stops early on its own termination predicate, and must be an overshoot
    no-op. A chunk queued at boundary k targets ``min(start + (k+1) *
    stride, max_rounds)``: the schedule of the serial loop, because a
    non-terminal chunk always runs to its round_end. ``next_end(end)``, if
    given, replaces that schedule: the chunk after the one ending at
    ``end`` ends at ``next_end(end)`` (at most max_rounds). A third output,
    ``aux`` (the chunk's telemetry rows), is copied to the host with the
    status and handed to ``on_aux(rounds_before, rounds_after, aux)`` at
    each retired chunk, in order.

    ``on_retire(rounds, state)`` fires at each retired chunk, in order, and
    ``should_stop(rounds, state)`` is asked at each retired chunk that did
    not end the run; a True ends it there, the chunks in flight dropped.
    Both get the retired state on the host (``_retired_to_host``).
    ``step_timing`` adds ``t_retire`` and ``wall_s`` to each chunk_log
    entry. ``hook_error`` is "raise" (an OSError in ``on_retire`` ends the
    run) or "continue" (it is recorded in ``hook_failures`` and the run
    goes on); see the module docstring."""
    if hook_error not in ("raise", "continue"):
        raise ValueError(
            f"hook_error must be 'raise' or 'continue', got {hook_error!r}")
    depth = max(1, int(depth))
    hooked = on_retire is not None or should_stop is not None
    side_streams: dict = {}
    inflight: collections.deque = collections.deque()
    head = (state0, status0)
    last_end = start_round
    retired = 0
    dispatched = 0
    dispatch_total = fetch_total = first_dispatch = aux_total = hook_total = 0.0
    chunk_log: list = []
    hook_failures: list = []

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
            with torch.profiler.record_function("chunkloop.dispatch"):
                out = dispatch(head[0], head[1], last_end)
            head = out[:2]
            disp_s = time.perf_counter() - t0
            dispatch_total += disp_s
            if dispatched == 0:
                first_dispatch = disp_s
            dispatched += 1
            aux = out[2] if len(out) > 2 else None
            inflight.append((head, _prefetch(head[1], aux), disp_s))

    def result(carry, speculative: int = 0) -> ChunkLoopResult:
        return ChunkLoopResult(
            state=carry[0], rounds=rounds, done=done, chunks_retired=retired,
            chunks_speculative=speculative, dispatch_s=dispatch_total,
            fetch_s=fetch_total, first_dispatch_s=first_dispatch,
            chunk_log=chunk_log, unhealthy_round=unhealthy, aux_s=aux_total,
            hook_s=hook_total, hook_failures=hook_failures,
        )

    fill()
    t_prev = time.perf_counter()
    rounds, done, unhealthy = start_round, False, None
    final = head
    while inflight:
        cur, handle, disp_s = inflight.popleft()
        before = rounds
        t0 = time.perf_counter()
        rounds, done, unhealthy = _read(handle)
        if on_aux is not None and handle[2] is not None:
            t_aux = time.perf_counter()
            on_aux(before, rounds, handle[2])
            aux_total += time.perf_counter() - t_aux
        fetch_s = time.perf_counter() - t0
        fetch_total += fetch_s
        retired += 1
        entry = {"rounds": rounds, "dispatch_s": disp_s, "fetch_s": fetch_s}
        if step_timing:
            t_retire = time.perf_counter()
            entry["t_retire"] = t_retire
            entry["wall_s"] = t_retire - t_prev
            t_prev = t_retire
        chunk_log.append(entry)
        final = cur
        ending = done or rounds >= max_rounds
        if hooked and (on_retire is not None or not ending):
            t_hook = time.perf_counter()
            try:
                host = _retired_to_host(cur[0], handle[1], side_streams)
                if on_retire is not None:
                    try:
                        on_retire(rounds, host)
                    except OSError as e:
                        if hook_error != "continue":
                            raise
                        hook_failures.append(
                            {"rounds": rounds, "error": f"{type(e).__name__}: {e}"})
                        print(f"[pipeline] chunk-boundary hook failed at rounds="
                              f"{rounds}: {e} — continuing (this interval's "
                              "checkpoint is lost; --strict-checkpoint fails fast)",
                              file=sys.stderr)
                        _count_hook_failure()
                stop = (not ending and should_stop is not None
                        and should_stop(rounds, host))
            finally:
                hook_total += time.perf_counter() - t_hook
            if stop:
                # The run ends at this boundary; the chunks in flight ran
                # rounds past it and are dropped unread.
                return result(cur, len(inflight))
        if ending:
            # Chunks still in flight are no-ops by the overshoot contract.
            inflight.clear()
            break
        fill()
    return result(final)


def step_timing_report(chunk_log, start_round: int = 0,
                       per_process_t=None) -> Optional[dict]:
    """The per-dispatch attribution record of a ``step_timing`` chunk_log
    (the JAX package's): the wall of each retired chunk, the median and
    max us a round, and the straggler section. Host arithmetic over a log
    already collected; None when the log has no timing rows.
    ``per_process_t`` is ``{process: [t_retire, ...]}`` from several
    processes (``straggler_report``); one process reports zero skew."""
    rows = [e for e in (chunk_log or ()) if "wall_s" in e]
    if not rows:
        return None
    walls = [float(e["wall_s"]) for e in rows]
    prev = start_round
    per_round_us = []
    rounds_list = []
    for e, w in zip(rows, walls):
        r = int(e["rounds"])
        delta = r - prev
        prev = r
        rounds_list.append(r)
        if delta > 0:
            per_round_us.append(w / delta * 1e6)
    srt = sorted(per_round_us)
    straggler = (
        straggler_report(per_process_t) if per_process_t else
        {"processes": 1, "boundaries": len(rows),
         "max_skew_s": 0.0, "median_skew_s": 0.0}
    )
    return {
        "dispatches": len(rows),
        "wall_s": walls,
        "rounds": rounds_list,
        "median_us_per_round": srt[len(srt) // 2] if srt else None,
        "max_us_per_round": srt[-1] if srt else None,
        "straggler": straggler,
    }


def straggler_report(per_process_t) -> dict:
    """Per-process skew from retire timestamps: boundary k's skew is
    ``max_p t[p][k] - min_p t[p][k]``, over the shortest process log."""
    cols = [list(map(float, ts)) for ts in (
        per_process_t.values() if isinstance(per_process_t, dict)
        else per_process_t
    )]
    cols = [c for c in cols if c]
    if len(cols) < 2:
        return {"processes": len(cols),
                "boundaries": len(cols[0]) if cols else 0,
                "max_skew_s": 0.0, "median_skew_s": 0.0}
    n = min(len(c) for c in cols)
    skews = [max(c[k] for c in cols) - min(c[k] for c in cols) for k in range(n)]
    srt = sorted(skews)
    return {
        "processes": len(cols),
        "boundaries": n,
        "max_skew_s": srt[-1],
        "median_skew_s": srt[len(srt) // 2],
    }
