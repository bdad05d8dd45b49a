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
K rounds is queued with no host read. CUDA state launches the kernels;
CPU state runs the plain versions; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..models import gossip as gossip_mod
from ..models import pushsum as pushsum_mod
from ..models.pipeline import advance
from ..utils import kernels
from . import delivery, rng, sampling
from .topology import Topology

# Counts a block of the scan kernels covers (csrc/scatter.cu kScanTile).
SCAN_TILE = 1024
# Launches a round: push-sum counts its buckets, scans them (two
# launches), places its sends and sums-and-absorbs; gossip sends and
# absorbs.
PUSHSUM_PASSES = 5
GOSSIP_PASSES = 2


@dataclasses.dataclass
class ScatterGraph:
    """What a scatter round needs of a topology, on one device: the padded
    neighbour table and degrees (None on the implicit full topology), and
    the kernels' scratch, allocated at the first launch and left zeroed by
    every round."""

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
                        term_rounds: int):
    """One push-sum round from its targets (``round_from_targets``) in the
    op order of the JAX package's jitted round: s and w halve; the s halves
    add onto each target's kept half in ascending sender index (XLA folds
    ``s_keep + deliver(s_send)`` into one scatter-add onto ``s_keep``), the
    w halves into an inbox from 0 that is then added to the kept half (the
    inbox also says whether the node received, so XLA keeps it)."""
    s_send, w_send, s_keep, w_keep = pushsum_mod.halve_and_send(
        state.s, state.w, send_ok)
    n = state.s.shape[0]
    s_new = delivery.deliver(s_send, targets, n, base=s_keep)
    inbox_w = delivery.deliver(w_send, targets, n)
    return pushsum_mod.absorb_sums(state, s_new, w_keep + inbox_w, inbox_w > 0,
                                   delta, term_rounds)


def gossip_round_plain(state, targets, send_ok, *, rumor_target: int,
                       suppress: bool):
    """One gossip round from its targets: every informed sender adds 1."""
    vals = gossip_mod.send_values(state, send_ok)
    inbox = delivery.deliver(vals, targets, state.count.shape[0])
    return gossip_mod.absorb(state, inbox, rumor_target, suppress)


def _chunk_plain(round_fn, state, keys, status, target: int):
    status = status.clone()
    for k in range(keys.shape[0]):
        state = advance(state, round_fn(state, keys[k]), status, target)
    return state, status


def pushsum_scatter_chunk_plain(state, keys, status, *, graph: ScatterGraph,
                                target: int, delta: float, term_rounds: int):
    """K = keys.shape[0] push-sum scatter rounds (plain version of
    ``pushsum_scatter_chunk``)."""
    def round_fn(st, key):
        targets, send_ok = round_targets(graph, key)
        return pushsum_round_plain(st, targets, send_ok, delta=delta,
                                   term_rounds=term_rounds)
    return _chunk_plain(round_fn, state, keys, status, target)


def gossip_scatter_chunk_plain(state, keys, status, *, graph: ScatterGraph,
                               target: int, rumor_target: int, suppress: bool):
    """K gossip scatter rounds (plain version of ``gossip_scatter_chunk``)."""
    def round_fn(st, key):
        targets, send_ok = round_targets(graph, key)
        return gossip_round_plain(st, targets, send_ok, rumor_target=rumor_target,
                                  suppress=suppress)
    return _chunk_plain(round_fn, state, keys, status, target)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch csrc/scatter.cu, CPU tensors run the plain
# versions.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gossip_pushsum_scatter_chunk": [_P] * 4 + [_P, _P, _I, _I] + [_P] * 10
                                    + [_P, _I, _F, _I, _I, _I, _P],
    "gossip_gossip_scatter_chunk": [_P] * 3 + [_P, _P, _I, _I] + [_P] * 3
                                   + [_P, _I, _I, _I, _I, _I, _P],
}


def _check(state, dtypes, keys, status, graph: ScatterGraph) -> torch.device:
    dev = state[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter chunks run on cpu or cuda tensors, got {dev}")
    for x, dt in zip(state, dtypes):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (graph.n,):
            raise ValueError(f"state plane must be {dt} [{graph.n}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if graph.device != dev:
        raise ValueError(f"the graph lies on {graph.device}, the state on {dev}")
    if status.device != dev or status.dtype != torch.int32 or tuple(status.shape) != (2,):
        raise ValueError("status must be int32 [2] (rounds, done) on the state's device")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64 [K, 2], got {keys.dtype} {tuple(keys.shape)}")
    if keys.device.type != "cpu":
        raise ValueError("keys are host-drawn round keys: pass a CPU tensor")
    words = keys.numpy()
    if words.size and (words.min() < 0 or words.max() > rng.MASK):
        raise ValueError("keys must hold uint32 words")
    return dev


def _work(graph: ScatterGraph, pushsum: bool) -> dict:
    """The kernels' scratch on the graph's device: the zeroed words every
    round leaves zeroed (bucket counts and fills, gossip's inbox, the
    converged count and its ticket) and the ones each round rewrites."""
    n, dev, w = graph.n, graph.device, graph.work
    if "acc" not in w:
        w["acc"] = torch.zeros(2, dtype=torch.int32, device=dev)
    if pushsum and "cnt" not in w:
        tiles = (n + SCAN_TILE - 1) // SCAN_TILE
        for name in ("cnt", "fill"):
            w[name] = torch.zeros(n, dtype=torch.int32, device=dev)
        for name in ("tgt", "offs", "idx"):
            w[name] = torch.empty(n, dtype=torch.int32, device=dev)
        w["tile_sum"] = torch.empty(tiles, dtype=torch.int32, device=dev)
        w["vs"] = torch.empty(n, dtype=torch.float32, device=dev)
        w["vw"] = torch.empty(n, dtype=torch.float32, device=dev)
    if not pushsum and "inbox" not in w:
        w["inbox"] = torch.zeros(n, dtype=torch.int32, device=dev)
    return w


def _graph_args(graph: ScatterGraph):
    if graph.neighbors is None:
        return [None, None, 0, graph.n]
    return [graph.neighbors.data_ptr(), graph.degree.data_ptr(),
            graph.neighbors.shape[1], graph.n]


def _launch(name: str, args, dev: torch.device) -> None:
    fn = kernels.entry("scatter", name, _SIGNATURES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*args, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def pushsum_scatter_chunk(state, keys, status, *, graph: ScatterGraph,
                          target: int, delta: float, term_rounds: int):
    """K = keys.shape[0] push-sum scatter rounds, one per round key.

    ``state`` is a PushSumState of [n] planes (float32 s, w, int32 term,
    bool conv) on the graph's device; ``keys`` int64 [K, 2] the rounds'
    fold_in keys on the host; ``status`` int32 [2] (rounds executed, done)
    on the device, done once ``target`` nodes converged. Returns (state',
    status'), new tensors; the inputs are left unchanged."""
    dev = _check(state, (torch.float32, torch.float32, torch.int32, torch.bool),
                 keys, status, graph)
    if dev.type == "cpu":
        return pushsum_scatter_chunk_plain(state, keys, status, graph=graph,
                                           target=target, delta=delta,
                                           term_rounds=term_rounds)
    w = _work(graph, pushsum=True)
    keys = keys.contiguous()
    out = pushsum_mod.PushSumState(*(x.clone() for x in state))
    status = status.clone()
    _launch("gossip_pushsum_scatter_chunk", [
        *(x.data_ptr() for x in out), *_graph_args(graph),
        *(w[k].data_ptr() for k in ("tgt", "cnt", "fill", "offs", "tile_sum",
                                    "idx", "vs", "vw", "acc")),
        status.data_ptr(), keys.data_ptr(), keys.shape[0],
        ctypes.c_float(delta), term_rounds, target], dev)
    pushsum_scatter_chunk.launches += PUSHSUM_PASSES * keys.shape[0]
    return out, status


def gossip_scatter_chunk(state, keys, status, *, graph: ScatterGraph,
                         target: int, rumor_target: int, suppress: bool):
    """Gossip analog of ``pushsum_scatter_chunk``: ``state`` is a
    GossipState (int32 count, bool active, bool conv); converged-target
    suppression is receiver-side."""
    dev = _check(state, (torch.int32, torch.bool, torch.bool), keys, status, graph)
    if dev.type == "cpu":
        return gossip_scatter_chunk_plain(state, keys, status, graph=graph,
                                          target=target, rumor_target=rumor_target,
                                          suppress=suppress)
    w = _work(graph, pushsum=False)
    keys = keys.contiguous()
    out = gossip_mod.GossipState(*(x.clone() for x in state))
    status = status.clone()
    _launch("gossip_gossip_scatter_chunk", [
        *(x.data_ptr() for x in out), *_graph_args(graph),
        w["inbox"].data_ptr(), w["acc"].data_ptr(), status.data_ptr(),
        keys.data_ptr(), keys.shape[0], rumor_target, int(suppress),
        target], dev)
    gossip_scatter_chunk.launches += GOSSIP_PASSES * keys.shape[0]
    return out, status


# Kernel launches queued by each wrapper (its passes a round), counted
# where the kernels are launched and nowhere else.
pushsum_scatter_chunk.launches = 0
gossip_scatter_chunk.launches = 0
