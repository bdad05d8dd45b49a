"""Reference-fidelity push-sum: a single random walk.

The reference's push-sum keeps exactly ONE message in flight: every
ComputePushSum receipt triggers exactly one send (program.fs:110-143), so
the protocol is a lone random walk carrying half-masses through the graph,
and "rounds" counts message hops. This mode exists for apples-to-apples
validation against the reference at small n; it is inherently sequential.
The semantics are the JAX package's ``models/reference.py``:

- Kickoff (program.fs:110-116): the leader halves (s, w) and sends the
  halves to a random neighbour (hop word ``fold_in(base_key, 0)``).
- Non-converged receipt (program.fs:119-143): absorb, compare the pre/post
  ratio to delta, reset-or-increment termRound, latch convergence at
  term_rounds (and reset termRound to 0 when it fires, program.fs:136),
  then halve and forward.
- Converged receipt (program.fs:125-127, Q5): relay the message untouched;
  the node's own state is frozen.
- Q8: a walk that reaches a degree-0 orphan (possible in imp3d, whose extra
  edges can point at orphans) dies: the ``dead`` latch freezes it.

Hop h draws its word off ``fold_in(base_key, h)``, never off the state, so
the plain version draws a block of hops' words at once and walks them with
float32 scalars in the JAX step's op order. On the card one launch of one
block walks up to ``hops`` hops (csrc/walk.cu): one thread walks while the
block's other warps draw the next hops' words ahead of it, over a 16-byte
record a node staged in shared memory when the records fit there (the
shared tier), else in scratch (the global tier); the host reads (steps,
converged count, dead) once a launch.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..ops import rng
from ..ops.scatter import ScatterGraph, scatter_graph
from ..ops.topology import Topology
from ..utils import kernels
from .pushsum import sum_f32

# Hops one launch of the walk kernel runs at most (the walks at the
# reference's sizes take 10**4-10**6 hops).
LAUNCH_HOPS = 1 << 20
# Hops whose words the plain version draws at once.
_WORD_BLOCK = 4096


class WalkCarry(NamedTuple):
    s: torch.Tensor  # [n] float32
    w: torch.Tensor  # [n] float32
    term: torch.Tensor  # [n] int32
    conv: torch.Tensor  # [n] bool
    cur: torch.Tensor  # () int32 — node about to process the in-flight message
    msg_s: torch.Tensor  # () float32 — in-flight sum mass
    msg_w: torch.Tensor  # () float32 — in-flight weight mass
    steps: torch.Tensor  # () int32 — hops taken
    dead: torch.Tensor  # () bool — walk hit an orphan (Q8)


def hop_words(base_key, start: int, count: int) -> np.ndarray:
    """uint32 words of hops start..start+count: ``jax.random.bits(
    fold_in(base_key, h), ())`` for each h."""
    steps = (start + torch.arange(count, dtype=torch.int64)) & rng.MASK
    a, b = rng.threefry2x32(int(base_key[0]), int(base_key[1]), 0, steps)
    x0, x1 = rng.threefry2x32(a, b, 0, 0)
    return (x0 ^ x1).numpy()


def _pick(word: int, node: int, nbr, deg, n: int) -> tuple[int, bool]:
    """pick_neighbor: (partner, ok) of ``node`` under ``word``."""
    if nbr is None:
        return (node + 1 + word % max(n - 1, 1)) % n, True
    d = int(deg[node])
    return int(nbr[node, word % max(d, 1)]), d > 0


def make_walk(topo: Topology, cfg: SimConfig, base_key, leader: int,
              device=None) -> WalkCarry:
    """The post-kickoff carry: the leader already halved, its halves in
    flight toward a random neighbour of the leader (hop 1 next)."""
    n = topo.n
    s = torch.arange(n, dtype=torch.float32)
    w = torch.ones(n, dtype=torch.float32)
    half_s, half_w = s[leader] * 0.5, w[leader] * 0.5
    s[leader], w[leader] = half_s, half_w
    word = int(hop_words(base_key, 0, 1)[0])
    first, ok = _pick(word, leader, topo.neighbors, topo.degree, n)
    carry = WalkCarry(
        s=s, w=w,
        term=torch.full((n,), cfg.initial_term_round, dtype=torch.int32),
        conv=torch.zeros(n, dtype=torch.bool),
        cur=torch.tensor(first, dtype=torch.int32), msg_s=half_s.clone(),
        msg_w=half_w.clone(), steps=torch.tensor(1, dtype=torch.int32),
        dead=torch.tensor(not ok))
    return WalkCarry(*(x.to(device) for x in carry))


# ---------------------------------------------------------------------------
# Plain version: the kernel's function on the host.
# ---------------------------------------------------------------------------


def walk_hops_plain(carry: WalkCarry, base_key, graph: ScatterGraph, *,
                    hops: int, max_steps: int, target: int, delta: float,
                    term_rounds: int):
    """Up to ``hops`` hops of the walk (plain version of ``walk_hops``):
    numpy float32 scalars in the JAX step's op order. Returns (carry',
    status) with status int32 [3] (steps, converged count, dead)."""
    dev = carry.s.device
    s, w = carry.s.cpu().numpy().copy(), carry.w.cpu().numpy().copy()
    term = carry.term.cpu().numpy().copy()
    conv = carry.conv.cpu().numpy().copy()
    nbr = None if graph.neighbors is None else graph.neighbors.cpu().numpy()
    deg = None if graph.degree is None else graph.degree.cpu().numpy()
    n = graph.n
    cur, steps, dead = int(carry.cur), int(carry.steps), bool(carry.dead)
    msg_s, msg_w = np.float32(carry.msg_s.item()), np.float32(carry.msg_w.item())
    delta32, half = np.float32(delta), np.float32(0.5)
    conv_count = int(conv.sum())
    end = steps + hops
    words = hop_words(base_key, steps, 0)
    base = steps
    while not dead and steps < min(max_steps, end) and conv_count < target:
        if steps - base >= words.shape[0]:
            base, words = steps, hop_words(base_key, steps, _WORD_BLOCK)
        s_c, w_c = s[cur], w[cur]
        newsum, newweight = s_c + msg_s, w_c + msg_w
        cal = abs(s_c / w_c - newsum / newweight)
        if not conv[cur]:
            term_new = 0 if cal > delta32 else int(term[cur]) + 1
            fires = term_new >= term_rounds
            if fires:
                term_new = 0
                conv[cur] = True
                conv_count += 1
            msg_s, msg_w = newsum * half, newweight * half
            s[cur], w[cur], term[cur] = msg_s, msg_w, term_new
        cur, ok = _pick(int(words[steps - base]), cur, nbr, deg, n)
        steps += 1
        dead = dead or not ok
    out = WalkCarry(
        s=torch.from_numpy(s), w=torch.from_numpy(w), term=torch.from_numpy(term),
        conv=torch.from_numpy(conv), cur=torch.tensor(cur, dtype=torch.int32),
        msg_s=torch.tensor(msg_s), msg_w=torch.tensor(msg_w),
        steps=torch.tensor(steps, dtype=torch.int32), dead=torch.tensor(dead))
    status = torch.tensor([steps, conv_count, int(dead)], dtype=torch.int32)
    return WalkCarry(*(x.to(dev) for x in out)), status.to(dev)


# ---------------------------------------------------------------------------
# Wrapper: CUDA tensors launch csrc/walk.cu, CPU tensors run the plain
# version.
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURE = [_P] * 4 + [_P, _P, _P, _I, _I, _P, _U, _U, _I, _I, _I, _F, _I, _I, _I, _P]
# The kernel's tiers: the walk's records in shared memory or in scratch.
TIERS = ("shared", "global")


def walk_tier(graph: ScatterGraph) -> tuple[str, int]:
    """The tier a launch on ``graph`` (on a CUDA device) runs, by size
    before the launch (csrc/walk.cu gossip_walk_tier): ``shared`` when the
    walk's node records, rows and ring fit the device's opt-in shared
    memory a block, else ``global``; and the bytes of the records and rows,
    which the global tier keeps in scratch."""
    max_deg = 0 if graph.neighbors is None else graph.neighbors.shape[1]
    scratch = ctypes.c_longlong()
    fn = kernels.entry("walk", "gossip_walk_tier", [_I, _I, _I, _I, _P])
    got = fn(graph.n, max_deg, int(graph.neighbors is None), graph.device.index,
             ctypes.byref(scratch))
    if got < 0:
        raise RuntimeError("gossip_walk_tier: the device's shared memory limit "
                           "could not be read")
    return TIERS[0 if got else 1], scratch.value


def walk_hops(carry: WalkCarry, base_key, graph: ScatterGraph, *, hops: int,
              max_steps: int, target: int, delta: float, term_rounds: int):
    """Up to ``hops`` hops of the walk from ``carry``, stopping at death,
    ``max_steps`` hops or ``target`` converged nodes. ``carry`` lies on the
    graph's device; ``base_key`` is the run's key (int64 [2], uint32
    words). Returns (carry', status) with status int32 [3] (steps,
    converged count, dead) on the device, to read once a call; the input
    carry is left unchanged. CUDA state launches one kernel in the tier
    ``walk_tier`` picks; CPU state runs the plain version."""
    n, dev = graph.n, carry.s.device
    for x, dt in zip(carry[:4], (torch.float32, torch.float32, torch.int32, torch.bool)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (n,):
            raise ValueError(f"walk plane must be {dt} [{n}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if graph.device != dev:
        raise ValueError(f"the graph lies on {graph.device}, the walk on {dev}")
    if hops < 0:
        raise ValueError(f"hops must be >= 0, got {hops}")
    if dev.type == "cpu":
        return walk_hops_plain(carry, base_key, graph, hops=hops, max_steps=max_steps,
                               target=target, delta=delta, term_rounds=term_rounds)
    if dev.type != "cuda":
        raise ValueError(f"the walk runs on cpu or cuda tensors, got {dev}")
    if not 1 <= term_rounds < 2**30:
        # The kernel keeps termRound (< term_rounds) as term * 2 + conv.
        raise ValueError(f"the walk kernel takes term_rounds in [1, 2**30), got "
                         f"{term_rounds}")
    planes = [x.clone() for x in carry[:4]]
    scal = torch.stack([
        carry.cur.to(torch.int32), carry.steps.to(torch.int32),
        carry.dead.to(torch.int32), carry.conv.sum().to(torch.int32),
        carry.msg_s.to(torch.float32).view(torch.int32),
        carry.msg_w.to(torch.float32).view(torch.int32)])
    nbr = None if graph.neighbors is None else graph.neighbors.data_ptr()
    deg = None if graph.degree is None else graph.degree.data_ptr()
    max_deg = 0 if graph.neighbors is None else graph.neighbors.shape[1]
    tier, scratch_bytes = walk_tier(graph)
    # The global tier keeps the walk's records and rows in scratch.
    scratch = None
    if tier == "global":
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    fn = kernels.entry("walk", "gossip_walk_hops", _SIGNATURE)
    err = fn(*(x.data_ptr() for x in planes), nbr, deg,
             None if scratch is None else scratch.data_ptr(), max_deg, n, scal.data_ptr(),
             int(base_key[0]), int(base_key[1]), hops, max_steps, target,
             ctypes.c_float(delta), term_rounds, int(tier == "shared"), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gossip_walk_hops: CUDA launch failed with cudaError_t {err}")
    walk_hops.launches += 1
    walk_hops.launches_by_tier[tier] += 1
    out = WalkCarry(*planes, cur=scal[0], msg_s=scal[4].view(torch.float32),
                    msg_w=scal[5].view(torch.float32), steps=scal[1],
                    dead=scal[2] != 0)
    return out, scal[[1, 3, 2]]


# Kernel launches queued by the wrapper, counted where the kernel is
# launched and nowhere else, in all and by tier.
walk_hops.launches = 0
walk_hops.launches_by_tier = dict.fromkeys(TIERS, 0)


def chase(nxt: torch.Tensor, steps: int, shared: bool = False) -> torch.Tensor:
    """Follow ``nxt`` (int32 [m] on a CUDA device) for ``steps`` dependent
    loads from index 0 on one thread (csrc/walk.cu gossip_chase), over
    global memory or, ``shared``, over a copy in shared memory: the time of
    one dependent access at a working set of m ints in the memory a walk
    tier walks in, the unit of the walk's hop chain. Returns the index it
    ends at (int32 [1])."""
    if nxt.device.type != "cuda" or nxt.dtype != torch.int32 or not nxt.is_contiguous():
        raise ValueError("chase follows a contiguous int32 CUDA tensor")
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    fn = kernels.entry("walk", "gossip_chase", [_P, _I, _I, _I, _P, _I, _I, _P])
    err = fn(nxt.data_ptr(), nxt.numel(), 0, steps, out.data_ptr(), int(shared),
             nxt.device.index, torch.cuda.current_stream(nxt.device).cuda_stream)
    if err:
        raise RuntimeError(f"gossip_chase: CUDA launch failed with cudaError_t {err}")
    return out


def arith_chain(steps: int, n: int, device, index: bool = True) -> torch.Tensor:
    """Run a hop's loop-carried arithmetic ``steps`` times on one thread
    (csrc/walk.cu gossip_arith_chain): the message's add and multiply for s
    and w and, ``index``, the full pick's add and minimum at population n,
    with no memory. Its time a step is the least a hop takes on full, the
    other unit of the walk's hop chain. Returns the last message's bits
    and node (int32 [3])."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"arith_chain runs on a cuda device, got {dev}")
    out = torch.empty(3, dtype=torch.int32, device=dev)
    fn = kernels.entry("walk", "gossip_arith_chain", [_U, _I, _F, _F, _I, _I, _P, _I, _P])
    err = fn(max(n // 3, 1), n, ctypes.c_float(0.75), ctypes.c_float(1.25), steps,
             int(index), out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gossip_arith_chain: CUDA launch failed with cudaError_t {err}")
    return out


def estimate_mae(carry: WalkCarry, true_mean: float) -> float:
    """Mean |s/w - true_mean| over the converged nodes, in float32 as the
    JAX package's walk runner computes it (its sum's order, ``sum_f32``)."""
    s, w = carry.s.cpu().numpy(), carry.w.cpu().numpy()
    conv = carry.conv.cpu().numpy()
    err = np.where(conv, np.abs(s / w - np.float32(true_mean)), np.float32(0))
    total = np.float32(sum_f32(torch.from_numpy(err)).item())
    return float(total / np.float32(max(int(conv.sum()), 1)))


def run_walk(topo: Topology, cfg: SimConfig, base_key, leader: int, target: int,
             device):
    """Drive the walk to convergence, death or cfg.max_rounds hops, one
    ``walk_hops`` call at a time with one host read each. Returns (final
    WalkCarry, compile_s, run_s); "rounds" in walk mode count hops."""
    graph = scatter_graph(topo, device)
    carry0 = make_walk(topo, cfg, base_key, leader, graph.device)
    kw = {"target": target, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}
    t0 = time.perf_counter()
    # Warmup: builds the kernel on first use and runs ONE hop, discarded
    # (the timed run recomputes it from carry0 on the same hop stream).
    _, status = walk_hops(carry0, base_key, graph, hops=1,
                          max_steps=cfg.max_rounds, **kw)
    status.tolist()
    compile_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    carry = carry0
    hops = LAUNCH_HOPS if graph.device.type == "cuda" else cfg.max_rounds
    while True:
        carry, status = walk_hops(carry, base_key, graph, hops=hops,
                                  max_steps=cfg.max_rounds, **kw)
        steps, count, dead = status.tolist()
        if dead or steps >= cfg.max_rounds or count >= target:
            break
    run_s = time.perf_counter() - t1
    return carry, compile_s, run_s
