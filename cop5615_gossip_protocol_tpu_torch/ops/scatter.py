"""Scatter delivery's chunk of rounds on [n] planes: the chunked engine's
round when messages go to drawn targets (``full`` and imp2d/imp3d by
default, any explicit topology with ``delivery="scatter"``).

A round draws one word per node off the round key (``uniform_bits``), takes
the target ``targets_full`` (full) or ``targets_explicit`` (a neighbour
column) gives, lets nodes of degree > 0 send, adds the sends into their
targets (``delivery.deliver``: each target's senders in ascending index,
the order of a serial scatter-add) and absorbs. The JAX package
runs this round as XLA ops (its ``models/runner.py`` ``targets_and_gate``
and ``pushsum.round_from_targets``, delivery an XLA scatter-add at
``ops/delivery.py:22``); it reaches no Pallas kernel. On the card the
round is csrc/scatter.cu, because a float scatter by atomics would add
push-sum's mass in an order that changes from run to run.

A chunk runs under the overshoot contract with a device status (int32
[2]: rounds executed, done): a round after done is a no-op, so a chunk of
K rounds is queued with no host read. On the card a chunk is one
persistent cooperative launch that runs all its rounds and stops at done
(``chunk_launches``). Under the run's failure model (``fused.Faults``)
the drop gate and the dead leave a round's senders, a dead node's protocol
state is frozen, a round is judged by the quorum of its live nodes, and
push-sum may terminate globally; under a recovery model a revived node
sends again and, where its rejoin resets it, starts its revival round from
the reset state: the kernels' faulted instances. Robust aggregation's clip
and the health sentinel (push-sum) and the telemetry plane's rows (both
protocols) are instances of their own, and so are the dup gate (a
dup-gated sender's message lands twice) and the delay ring (the carry is a
pipeline.Ringed pair: round r absorbs slot r % D of the ring and leaves
its fresh inbox there). CUDA state launches the kernels; CPU state runs
the plain versions; there is no fallback between the two.

The sentinel's Σw and the rows' float sums are whole-grid sums in the
kernel's fixed order (ops/telemetry.KernelOrder, slice_order for push-sum,
strided_order for gossip, over the kernel's grid, ``telemetry_grid``): the
plain versions take that order where they are held against the kernel
(``order``), and ``sum_f32``'s, the JAX chunked engine's, otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..models import gossip as gossip_mod
from ..models import pushsum as pushsum_mod
from ..models.pipeline import (Ringed, RingRound, advance, health_check, own_ring,
                               proto_of, ring_step)
from ..models.pushsum import sum_f32
from ..utils import kernels
from . import delivery, fused, rng, sampling
from . import faults as faults_mod
from . import telemetry as telemetry_mod
from .topology import Topology

# The most blocks of a persistent launch (csrc/scatter.cu kMaxGrid): one
# slice total each.
MAX_GRID = 2048


def chunk_launches(rounds: int, telemetry: bool = False) -> int:
    """Launches a chunk of csrc/scatter.cu queues: one persistent launch
    that runs every round, whatever their number, and with telemetry the
    reduce of its rows; none for no round."""
    return (2 if telemetry else 1) if rounds > 0 else 0


@dataclasses.dataclass
class ScatterGraph:
    """What a scatter round needs of a topology, on one device: the padded
    neighbour table and degrees (None on the implicit full topology), and
    the kernels' scratch (``_work``), allocated at the first launch."""

    n: int
    device: torch.device
    neighbors: Optional[torch.Tensor]  # int32 [n, max_deg]
    degree: Optional[torch.Tensor]  # int32 [n]
    work: dict = dataclasses.field(default_factory=dict)


def scatter_graph(topo: Topology, device) -> ScatterGraph:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if topo.implicit:
        return ScatterGraph(topo.n, device, None, None)
    return ScatterGraph(
        topo.n, device,
        torch.from_numpy(topo.neighbors).to(device=device, dtype=torch.int32).contiguous(),
        torch.from_numpy(topo.degree).to(device=device, dtype=torch.int32).contiguous(),
    )


def round_targets(graph: ScatterGraph, round_key):
    """(targets, send_ok) of one round: int64 [n] partners and bool [n]
    senders."""
    n, dev = graph.n, graph.device
    bits = sampling.uniform_bits(round_key, n, device=dev)
    if graph.neighbors is None:
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        return (sampling.targets_full(bits, ids, n),
                torch.ones(n, dtype=torch.bool, device=dev))
    targets = sampling.targets_explicit(bits, graph.neighbors, graph.degree)
    return targets, graph.degree > 0


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in torch, on any device.
# ---------------------------------------------------------------------------


def pushsum_round_plain(state, targets, send_ok, *, delta: float,
                        term_rounds: int, global_term: bool = False,
                        lying=None, mode: str = "", clip: bool = False,
                        dup=None, ring=None, slot: int = 0):
    """One push-sum round from its targets (``round_from_targets``) in the
    op order of the JAX package's jitted round: s and w halve; the s halves
    add onto each target's kept half in ascending sender index (XLA folds
    ``s_keep + deliver(s_send)`` into one scatter-add onto ``s_keep``), the
    w halves into an inbox from 0 that is then added to the kept half (the
    inbox also says whether the node received, so XLA keeps it). Under
    global termination nothing reads that flag, and the w halves too add
    onto the kept half. Every half, add and sum is flushed
    (pushsum.flush). ``lying`` (bool [n]) senders put ``mode``'s pair on
    the wire (faults.lie); with ``clip`` both inboxes sum from 0 and the
    absorb adds them clipped (pushsum.absorb_clipped).

    With the dup gate (``dup``, bool [n]) or the delay ring (``ring``,
    float32 [D, 2, n], read and written at ``slot``) XLA folds nothing:
    each inbox sums from 0 (a dup-gated sender's half a second time into
    an inbox of its own, the two added), and the kept half adds the inbox,
    or under the ring what the ring held (pipeline.ring_step). Returns the
    new state, and with a ring (written in place) what its slot held too."""
    s_send, w_send, s_keep, w_keep = pushsum_mod.halve_and_send(
        state.s, state.w, send_ok)
    if lying is not None:
        s_send, w_send = faults_mod.lie(mode, s_send, w_send, state.s, state.w,
                                        lying & send_ok)
    n = state.s.shape[0]
    if dup is not None or ring is not None:
        in_s, in_w = delivery.deliver_dup(
            lambda v: delivery.deliver(v, targets, n),
            torch.stack([s_send, w_send]), dup)
        if ring is not None:
            arrival = ring_step(ring, torch.stack([in_s, in_w]), slot)
            in_s, in_w = arrival
        if clip:
            new = pushsum_mod.absorb_clipped(
                state, s_keep, w_keep, in_s, in_w,
                pushsum_mod.clip_scale(in_w, w_keep), delta, term_rounds)
        else:
            new = pushsum_mod.absorb(state, s_keep, w_keep, in_s, in_w, delta,
                                     term_rounds, global_term)
        return new if ring is None else (new, arrival)
    if clip:
        in_w = delivery.deliver(w_send, targets, n)
        return pushsum_mod.absorb_clipped(
            state, s_keep, w_keep, delivery.deliver(s_send, targets, n), in_w,
            pushsum_mod.clip_scale(in_w, w_keep), delta, term_rounds)
    s_new = delivery.deliver(s_send, targets, n, base=s_keep)
    if global_term:
        # No received flag keeps the w inbox apart: XLA folds both sums.
        return pushsum_mod.absorb_global(
            state, s_new, delivery.deliver(w_send, targets, n, base=w_keep),
            delta)
    inbox_w = delivery.deliver(w_send, targets, n)
    return pushsum_mod.absorb_sums(state, s_new,
                                   pushsum_mod.flush(w_keep + inbox_w),
                                   inbox_w > 0, delta, term_rounds)


def gossip_round_plain(state, targets, send_ok, *, rumor_target: int,
                       suppress: bool, dup=None, ring=None, slot: int = 0):
    """One gossip round from its targets: every informed sender adds 1,
    a dup-gated one twice (``dup``); under the delay ring (``ring``, int32
    [D, n]) the round absorbs what slot ``slot`` held and leaves its fresh
    receipts there. Returns the new state, and with a ring (written in
    place) what its slot held too."""
    vals = gossip_mod.send_values(state, send_ok)
    inbox = delivery.deliver_dup(
        lambda v: delivery.deliver(v, targets, state.count.shape[0]), vals, dup)
    if ring is not None:
        inbox = ring_step(ring, inbox, slot)
    new = gossip_mod.absorb(state, inbox, rumor_target, suppress)
    return new if ring is None else (new, inbox)


def _chunk_plain(round_fn, state, keys, status, target: int, start: int,
                 faults: Optional[fused.Faults], row_fn=None, wsum=sum_f32,
                 ring_sum=None):
    """K = keys.shape[0] rounds under the overshoot contract. ``faults``
    adds the drop gate and the living to each round's senders, freezes a
    dead node's protocol state (push-sum's s and w still absorb), judges a
    round by the quorum of its live nodes, and under a recovery model
    resets a revived node at its revival round's start (``faults.rejoin``;
    a round after done keeps the state it was given, not the reset one).
    Under a Byzantine model ``round_fn`` gets the round's adversaries (a
    push-sum sender among them lies) and a live gossip adversary's state
    takes the mode's override after the freeze; under the health sentinel
    (status int32 [3]) a round whose state is unhealthy ends the run
    (pipeline.advance), its Σw in ``wsum``'s order (and the ring's in
    ``ring_sum``'s, pipeline.health_check). Under the dup gate
    ``round_fn`` gets the round's dup-gated nodes, and under the delay
    ring (``state`` a pipeline.Ringed carry) the chunk's copy of the ring
    and the round's slot, and returns what the slot held beside the state. With ``row_fn``
    (telemetry.make_row_fn's) it returns the rows of the rounds it executed
    too, float32 [K, N_COLS], zero past them."""
    status = status.clone()
    state = own_ring(state)
    executed0 = int(status[0])
    proto = proto_of(state)
    n_pad, dev = proto[0].shape[0], proto[0].device
    fx = None
    bad = None
    rows = (None if row_fn is None else
            torch.zeros(keys.shape[0], telemetry_mod.N_COLS, dtype=torch.float32,
                        device=dev))
    if faults is not None:
        fx = faults.for_chunk(keys, start, n_pad, dev)
        if faults.mass_tolerance is not None:
            bad = health_check(n_pad, faults.mass_tolerance, wsum, ring_sum)
    for k in range(keys.shape[0]):
        if fx is None:
            state = advance(state, round_fn(state, keys[k], True, None), status,
                            target)
            if rows is not None:
                rows[k] = row_fn(state, start + k)
            continue
        ok = True
        if fx.thresh is not None:
            ok = sampling.uniform_bits(fx.gate_keys[k], n_pad, device=dev) >= fx.thresh
        alive = fx.alive_flat(start + k)
        if alive is not None:
            ok = alive if ok is True else ok & alive
        extra = {}
        if faults.dup_thresh is not None:
            extra["dup"] = rng.bits(rng.fold_in(keys[k], sampling.DUP_TAG),
                                    (n_pad,), device=dev) < faults.dup_thresh
        if isinstance(state, Ringed):
            extra.update(ring=state.ring, slot=(start + k) % faults.delay)
        entry = proto_of(state)
        if fx.revive is not None:
            entry = faults_mod.rejoin(entry, fx.revive == start + k, fx.reset,
                                      fx.init_term)
        lying = fx.lying_flat(start + k)
        new = round_fn(entry, keys[k], ok, lying, **extra)
        new, arrival = new if "ring" in extra else (new, None)
        verdict = {}
        if alive is not None:
            new = faults_mod.freeze_dead(entry, new, ~alive)
            verdict = {"alive": alive, "need": int(fx.needs[k])}
        if lying is not None and isinstance(new, gossip_mod.GossipState):
            new = gossip_mod.GossipState(*faults_mod.override(
                fx.byz_mode, lying if alive is None else lying & alive, *new))
        if arrival is not None:
            new = RingRound(new, state.ring, extra["slot"], arrival)
        state = advance(state, new, status, target, bad=bad, **verdict)
        if rows is not None:
            rows[k] = row_fn(proto_of(state), start + k, verdict.get("need"))
    if rows is None:
        return state, status
    rows[int(status[0]) - executed0:] = 0
    return state, status, rows


def pushsum_scatter_chunk_plain(state, keys, status, *, graph: ScatterGraph,
                                target: int, delta: float, term_rounds: int,
                                start: int = 0,
                                faults: Optional[fused.Faults] = None,
                                telemetry=None, order=None):
    """K = keys.shape[0] push-sum scatter rounds from absolute round
    ``start`` (plain version of ``pushsum_scatter_chunk``). ``telemetry``
    (telemetry.make_row_fn's row function) returns the chunk's rows too;
    ``order`` (a telemetry.KernelOrder) sums the sentinel's Σw in the
    kernel's order, sum_f32's (the JAX chunked engine's) without it; under
    the ring the w in flight adds ``ring_node_sums`` in that order."""
    global_term = faults is not None and faults.global_term
    mode = "" if faults is None else faults.byz_mode
    clip = faults is not None and faults.clip

    def round_fn(st, key, ok, lying, **extra):
        targets, send_ok = round_targets(graph, key)
        return pushsum_round_plain(st, targets, send_ok & ok, delta=delta,
                                   term_rounds=term_rounds,
                                   global_term=global_term, lying=lying,
                                   mode=mode, clip=clip, **extra)
    wsum = ring_sum = None
    if order is not None:
        def wsum(v):
            return telemetry_mod.kernel_sum(v, order)

        def ring_sum(ring):
            return wsum(ring_node_sums(ring))
    return _chunk_plain(round_fn, state, keys, status, target, start, faults,
                        telemetry, wsum or sum_f32, ring_sum)


def ring_node_sums(ring: torch.Tensor) -> torch.Tensor:
    """Each node's w in flight, float32 [n]: its words of the [D, 2, n]
    ring's w planes added in slot order from 0, flushed (kernel A's
    sentinel under the ring sums these in its order)."""
    acc = torch.zeros_like(ring[0, 1])
    for d in range(ring.shape[0]):
        acc = pushsum_mod.flush(acc + ring[d, 1])
    return acc


def gossip_scatter_chunk_plain(state, keys, status, *, graph: ScatterGraph,
                               target: int, rumor_target: int, suppress: bool,
                               start: int = 0,
                               faults: Optional[fused.Faults] = None,
                               telemetry=None):
    """K gossip scatter rounds (plain version of ``gossip_scatter_chunk``);
    ``telemetry`` as there."""
    def round_fn(st, key, ok, lying, **extra):
        targets, send_ok = round_targets(graph, key)
        return gossip_round_plain(st, targets, send_ok & ok,
                                  rumor_target=rumor_target, suppress=suppress,
                                  **extra)
    return _chunk_plain(round_fn, state, keys, status, target, start, faults,
                        telemetry)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch csrc/scatter.cu, CPU tensors run the plain
# versions.
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    "gossip_pushsum_scatter_chunk": [_P] * 6 + [_I, _I] + [_P] * 7 + [_U] * 3
                                    + [_I, _F, _I, _I] + [_I, _U, _P, _P]
                                    + [_P, _I, _I] + [_I] + [_P, _I]
                                    + [_U, _P, _I]
                                    + [_I, _I, _F, _P, _P, _P, _I, _F] + [_I, _P],
    "gossip_gossip_scatter_chunk": [_P] * 5 + [_I, _I] + [_P] * 3 + [_U] * 3
                                   + [_I] * 4 + [_I, _U, _P, _P] + [_P, _I]
                                   + [_P, _I] + [_U, _P, _I] + [_P, _P, _I]
                                   + [_I, _P],
    "gossip_scatter_grid": [_I] * 5,
}
# The kernels' instance flags (csrc/scatter.cu kClip, kSentinel, kTele,
# kDup, kDelay).
CLIP, SENTINEL, TELE, DUP, DELAY = 1, 2, 4, 8, 16
# A push-sum dup instance's record carries 2 i + sender i's dup bit in its
# int32 index word (csrc/scatter.cuh dup_index): it takes n below this.
DUP_MAX_N = 2 ** 30


def instance_flags(faults: Optional[fused.Faults], telemetry: bool,
                   pushsum: bool = True) -> int:
    """The instance flags of a chunk under ``faults`` (clip and the
    sentinel, push-sum's alone; the dup gate, the delay ring) and with or
    without telemetry."""
    f = faults
    return ((CLIP if pushsum and f is not None and f.clip else 0)
            | (SENTINEL if pushsum and f is not None and f.mass_tolerance is not None
               else 0)
            | (TELE if telemetry else 0)
            | (DUP if f is not None and f.dup_thresh is not None else 0)
            | (DELAY if f is not None and f.delay > 0 else 0))


@functools.lru_cache(maxsize=None)
def telemetry_grid(pushsum: bool, faulted: bool, flags: int, n: int,
                   device_index: int) -> int:
    """The grid of a kernel instance's persistent launch at n nodes on card
    ``device_index`` (csrc/scatter.cu gossip_scatter_grid): the blocks whose
    partials a telemetry chunk's scratch holds, and the blocks whose order
    the plain versions follow (telemetry.slice_order, strided_order)."""
    fn = kernels.entry("scatter", "gossip_scatter_grid",
                       _SIGNATURES["gossip_scatter_grid"])
    grid = fn(int(pushsum), int(faulted), flags, n, device_index)
    if grid <= 0:
        raise RuntimeError(f"gossip_scatter_grid failed with cudaError_t {-grid}")
    return grid


def _check(carry, dtypes, key, start: int, rounds: int, status,
           graph: ScatterGraph, faults: Optional[fused.Faults]) -> torch.device:
    state = proto_of(carry)
    dev = state[0].device
    delay = 0 if faults is None else faults.delay
    if isinstance(carry, Ringed) != (delay > 0):
        raise ValueError("the state must be a Ringed carry exactly under the "
                         f"delay ring (delay_rounds {delay})")
    if delay:
        shape = ((delay, 2, graph.n) if dtypes[0] == torch.float32
                 else (delay, graph.n))
        ring = carry.ring
        if (ring.device != dev or ring.dtype != dtypes[0]
                or tuple(ring.shape) != shape or not ring.is_contiguous()):
            raise ValueError(f"the ring must be contiguous {dtypes[0]} {shape} "
                             f"on {dev}, got {ring.dtype} {tuple(ring.shape)} "
                             f"on {ring.device}")
    if (dev.type != "cpu" and dtypes[0] == torch.float32 and faults is not None
            and faults.dup_thresh is not None and graph.n >= DUP_MAX_N):
        raise ValueError(
            f"dup_rate > 0 with push-sum scatter delivery on the card takes n < "
            f"2**30 (a record's index word carries 2 i + the dup bit), got n={graph.n}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter chunks run on cpu or cuda tensors, got {dev}")
    for x, dt in zip(state, dtypes):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (graph.n,):
            raise ValueError(f"state plane must be {dt} [{graph.n}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if graph.device != dev:
        raise ValueError(f"the graph lies on {graph.device}, the state on {dev}")
    if (status.device != dev or status.dtype != torch.int32
            or tuple(status.shape) not in ((2,), (3,))):
        raise ValueError("status must be int32 [2] (rounds, done), or [3] with "
                         "the health sentinel's word, on the state's device")
    if len(key) != 2 or not all(0 <= int(x) <= rng.MASK for x in key):
        raise ValueError(f"key must be the run's two uint32 words, got {key}")
    if start < 0 or rounds < 0:
        raise ValueError(f"start and rounds must be >= 0, got {start}, {rounds}")
    return dev


def _work(graph: ScatterGraph, pushsum: bool) -> dict:
    """The kernels' scratch on the graph's device, allocated once a graph:
    the planes every chunk leaves zero (push-sum's bucket counts and
    gossip's receipts, int32 [2, n], one row a round parity) and the ones
    each round rewrites (push-sum's tickets (target, rank), each bucket's
    offset in its block's slice, the slices' totals and the 16-byte
    records, and the sentinel's partials)."""
    n, dev, w = graph.n, graph.device, graph.work
    if pushsum and "counts" not in w:
        w["counts"] = torch.zeros(2, n, dtype=torch.int32, device=dev)
        w["tickets"] = torch.empty(n, 2, dtype=torch.int32, device=dev)
        w["offsets"] = torch.empty(n, dtype=torch.int32, device=dev)
        w["totals"] = torch.empty(MAX_GRID, dtype=torch.int32, device=dev)
        w["records"] = torch.empty(n, 4, dtype=torch.int32, device=dev)
        # The sentinel's per-block Σw and non-finite flags, and under the
        # ring its w in flight, a slot a round parity each (written before
        # they are read in every round).
        w["health"] = torch.empty(6 * MAX_GRID, dtype=torch.int32, device=dev)
    if not pushsum and "inbox" not in w:
        w["inbox"] = torch.zeros(2, n, dtype=torch.int32, device=dev)
    return w


def _graph_args(graph: ScatterGraph):
    if graph.neighbors is None:
        return [None, None, 0, graph.n]
    return [graph.neighbors.data_ptr(), graph.degree.data_ptr(),
            graph.neighbors.shape[1], graph.n]


def _launch(name: str, args, dev: torch.device) -> None:
    """Queue one chunk through entry point ``name`` of csrc/scatter.cu on
    the current stream of ``dev`` and raise on a launch error. The barrier
    words dropped after this returns stay safe: torch's caching allocator
    hands their memory only to work queued later on the same stream."""
    fn = kernels.entry("scatter", name, _SIGNATURES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*args, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _tele_buffers(graph: ScatterGraph, pushsum: bool, faulted: bool,
                  flags: int, rounds: int, dev: torch.device):
    """A telemetry chunk's scratch (the header and every block's partials
    of every round), its rows and the instance's grid."""
    grid = telemetry_grid(pushsum, faulted, flags, graph.n, dev.index)
    scratch = torch.empty(2 + rounds * grid * telemetry_mod.PARTIALS,
                          dtype=torch.int32, device=dev)
    rows = torch.empty(rounds, telemetry_mod.N_COLS, dtype=torch.float32,
                       device=dev)
    return scratch, rows, grid


def pushsum_scatter_chunk(state, key, start: int, rounds: int, status, *,
                          graph: ScatterGraph, target: int, delta: float,
                          term_rounds: int,
                          faults: Optional[fused.Faults] = None,
                          telemetry=None):
    """Push-sum scatter rounds start .. start + rounds - 1 (absolute round
    numbers), round r under the fold_in key ``fused.round_keys`` draws for
    it from the run's ``key`` (int64 [2] on the host).

    ``state`` is a PushSumState of [n] planes (float32 s, w, int32 term,
    bool conv) on the graph's device; ``status`` int32 [2] (rounds
    executed, done) on the device, done once ``target`` nodes converged.
    Returns (state', status'), new tensors; the inputs are left unchanged.
    On the card the kernel folds the round keys itself. ``faults`` (the
    run's fused.Faults, None for a fault-free run with local termination)
    adds the drop gate, crash-stop with the quorum verdict and global
    termination (the kernel's faulted instance), and with clip
    (``faults.clip``) or the health sentinel (``faults.mass_tolerance``;
    status int32 [3]) the kernel's clip or sentinel instance. ``telemetry``
    (telemetry.make_row_fn's row function, which the plain version runs)
    picks the telemetry instance, and the chunk returns its rows too,
    float32 [rounds, N_COLS] on the device."""
    dev = _check(state, (torch.float32, torch.float32, torch.int32, torch.bool),
                 key, start, rounds, status, graph, faults)
    if dev.type == "cpu":
        return pushsum_scatter_chunk_plain(state, fused.round_keys(key, start, rounds),
                                           status, graph=graph, target=target,
                                           delta=delta, term_rounds=term_rounds,
                                           start=start, faults=faults,
                                           telemetry=telemetry)
    flags = instance_flags(faults, telemetry is not None)
    out, ring = _clone_carry(state)
    status = status.clone()
    tele = telemetry is not None
    if rounds == 0:
        return (out, status) + ((_no_rows(dev),) if tele else ())
    w = _work(graph, pushsum=True)
    words = torch.empty(3 * rounds + 1, dtype=torch.int64, device=dev)
    fargs, _needs = _fault_args(faults, start, rounds, dev)
    # Telemetry runs with the faulted instance, under no fault too.
    fargs[0] = int(faults is not None or tele)
    scratch = rows = None
    grid = 0
    if tele:
        scratch, rows, grid = _tele_buffers(graph, True, True, flags, rounds, dev)
    _launch("gossip_pushsum_scatter_chunk", [
        *(x.data_ptr() for x in proto_of(out)), *_graph_args(graph),
        *(w[k].data_ptr() for k in ("counts", "tickets", "offsets", "totals",
                                    "records")),
        words.data_ptr(), status.data_ptr(), *_key_args(key, start), rounds,
        ctypes.c_float(delta), term_rounds, target, *fargs,
        *_revive_args(faults, dev), int(faults is not None and faults.global_term),
        *_byz_args(faults, dev), *_dd_args(faults, ring), int(bool(flags & CLIP)),
        int(bool(flags & SENTINEL)),
        ctypes.c_float(0.0 if faults is None or faults.mass_tolerance is None
                       else faults.mass_tolerance),
        w["health"].data_ptr(), *_tele_ptrs(scratch, rows), grid,
        ctypes.c_float(telemetry_mod.true_mean(graph.n))], dev)
    pushsum_scatter_chunk.launches += chunk_launches(rounds, tele)
    return (out, status) + ((rows,) if tele else ())


def gossip_scatter_chunk(state, key, start: int, rounds: int, status, *,
                         graph: ScatterGraph, target: int, rumor_target: int,
                         suppress: bool, faults: Optional[fused.Faults] = None,
                         telemetry=None):
    """Gossip analog of ``pushsum_scatter_chunk``: ``state`` is a
    GossipState (int32 count, bool active, bool conv); converged-target
    suppression is receiver-side; ``telemetry`` as there."""
    dev = _check(state, (torch.int32, torch.bool, torch.bool), key, start, rounds,
                 status, graph, faults)
    if dev.type == "cpu":
        return gossip_scatter_chunk_plain(state, fused.round_keys(key, start, rounds),
                                          status, graph=graph, target=target,
                                          rumor_target=rumor_target, suppress=suppress,
                                          start=start, faults=faults,
                                          telemetry=telemetry)
    out, ring = _clone_carry(state)
    status = status.clone()
    tele = telemetry is not None
    if rounds == 0:
        return (out, status) + ((_no_rows(dev),) if tele else ())
    w = _work(graph, pushsum=False)
    words = torch.empty(rounds + 1, dtype=torch.int64, device=dev)
    fargs, _needs = _fault_args(faults, start, rounds, dev)
    fargs[0] = int(faults is not None or tele)
    scratch = rows = None
    grid = 0
    if tele:
        scratch, rows, grid = _tele_buffers(
            graph, False, True, instance_flags(faults, True, pushsum=False),
            rounds, dev)
    _launch("gossip_gossip_scatter_chunk", [
        *(x.data_ptr() for x in proto_of(out)), *_graph_args(graph),
        w["inbox"].data_ptr(), words.data_ptr(), status.data_ptr(),
        *_key_args(key, start), rounds, rumor_target, int(suppress), target,
        *fargs, *_revive_args(faults, dev)[:2], *_byz_args(faults, dev),
        *_dd_args(faults, ring), *_tele_ptrs(scratch, rows), grid], dev)
    gossip_scatter_chunk.launches += chunk_launches(rounds, tele)
    return (out, status) + ((rows,) if tele else ())


def _clone_carry(carry):
    """(a copy of the chunk's carry, which the kernel updates in place, and
    the copy's ring, None without one)."""
    proto = proto_of(carry)
    out = type(proto)(*(x.clone() for x in proto))
    if isinstance(carry, Ringed):
        ring = carry.ring.clone()
        return Ringed(out, ring), ring
    return out, None


def _dd_args(faults: Optional[fused.Faults], ring) -> list:
    """(dup threshold, ring, its depth) as the entry points take them: 0,
    None and 0 where the run has neither."""
    dup = 0 if faults is None or faults.dup_thresh is None else faults.dup_thresh
    if ring is None:
        return [dup, None, 0]
    return [dup, ring.data_ptr(), ring.shape[0]]


def _tele_ptrs(scratch, rows) -> list:
    return [None, None] if scratch is None else [scratch.data_ptr(), rows.data_ptr()]


def _no_rows(dev) -> torch.Tensor:
    return torch.zeros(0, telemetry_mod.N_COLS, dtype=torch.float32, device=dev)


def _fault_args(faults: Optional[fused.Faults], start: int, rounds: int,
                dev: torch.device):
    """(faulted, threshold, death plane, quorum needs) as the entry points
    take them, and the needs tensor the caller keeps until the launch is
    queued (a copy to the card without a host sync). The quorum needs count
    the revivals too (fused.Faults.needs)."""
    if faults is None:
        return [0, 0, None, None], None
    if faults.death is None:
        return [1, faults.thresh or 0, None, None], None
    needs = faults.needs(start, rounds)[0].pin_memory().to(dev, non_blocking=True)
    death = faults.death_flat(faults.death.shape[0], dev)
    return [1, faults.thresh or 0, death.data_ptr(), needs.data_ptr()], needs


def _revive_args(faults: Optional[fused.Faults], dev: torch.device) -> list:
    """(revival plane, reset, initial term) as the entry points take them."""
    if faults is None or faults.revive is None:
        return [None, 0, 0]
    return faults.revive_args(faults.revive.shape[0], dev)


def _byz_args(faults: Optional[fused.Faults], dev: torch.device) -> list:
    """(Byzantine onset plane, mode) as the entry points take them."""
    if faults is None:
        return [None, 0]
    return faults.byz_args(None, dev)


def _key_args(key, start: int):
    """The run's key words and the first round (mod 2**32, as
    ``fused.round_keys`` folds it) as the entry points take them."""
    return int(key[0]), int(key[1]), start & rng.MASK


# Kernel launches queued by each wrapper (one a chunk of rounds), counted
# where the kernel is launched and nowhere else.
pushsum_scatter_chunk.launches = 0
gossip_scatter_chunk.launches = 0
