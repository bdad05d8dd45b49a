"""Fused x sharded lattices, the VMEM-resident tier: the counterpart of the
JAX package's parallel/fused_sharded.py, and the super-step machinery the
streaming tier (parallel/fused_hbm_sharded.py) shares.

Shard i owns global rows [i * rows_loc, (i + 1) * rows_loc) of the padded
[R, 128] pool layout and keeps it in a halo-extended buffer of rows_ext =
rows_loc + 2H rows: its left neighbour's last H rows, its own rows (the
middle), its right neighbour's first H rows, so extended row r holds global
row (row0 + r) mod R with row0 = (i * rows_loc - H + 2R) mod R. A
super-step is

1. the ring wire: each shard's 2H halo rows per plane copied in from its
   neighbours' middle rows (parallel/halo.py);
2. one call per shard that runs up to CR rounds on its extended buffer
   (csrc/fused_stencil_shard.cu, the kernels of
   ``pushsum_stencil_shard_superstep`` and
   ``gossip_stencil_shard_superstep``): every slot draws its bits at its
   GLOBAL flat index, and delivery of class d is a circular roll over the
   extended buffer by e1 or, for receivers below global flat d, e2 (the
   mod-n blend); round j computes only its window W_j, the rows the middle
   still depends on (``shard_windows``; H covers a super-step's shifts, so
   no window reaches across the buffer's ends and the middle is exact);
3. the verdict: the shards' middle converged counts after the super-step's
   last round, summed against the target on the device
   (parallel/overlap.py orders it, ``overlap_collectives``).

Convergence is detected at super-step boundaries, so ``rounds`` is the
first boundary at or after the single-device run's round (equal at
chunk_rounds=1, where the state is bitwise the single-device run's). The
boundaries are the JAX run's: super-steps of CR rounds from each chunk's
start, cut at its end, chunks of ``stride`` rounds (``run_chunks``). The
plan (``plan_fused_sharded``) is the JAX plan, so a config gets the JAX
package's H, CR and tier, or its reason. On the CPU the wrappers run their
plain torch versions; on CUDA they launch the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..ops import fused
from ..ops import fused_stencil_hbm as hbm
from ..ops.fused import LANES
from ..ops.fused_pool import TILE, PoolLayout, _upload, build_pool_layout
from ..ops.fused_stencil_hbm import dir_words
from ..ops.topology import Topology, lattice_dirs
from ..utils import kernels
from . import halo
from . import mesh as mesh_mod
from . import overlap as overlap_mod

# The JAX composition's VMEM plane budget, in bytes.
_VMEM_BUDGET = 100 * 1024 * 1024

# Rounds a super-step may run: the plans' CR cap, and the windows the
# kernels take by value (csrc/shard.cuh kMaxWindows - 1).
MAX_SUPERSTEP_ROUNDS = 64

# Super-steps queued per host batch of the run's chunk loop: a batch ends on
# a JAX super-step boundary and the loop reads the done flag once a batch.
STEPS_PER_BATCH = 8


def _signed_pad(d: int, n_pad: int) -> int:
    d = d % n_pad
    return d if d <= n_pad // 2 else d - n_pad


def threefry_bits_rows(k1, k2, global_rows, cols: int) -> torch.Tensor:
    """int64 [rows, cols] uint32 words at explicit global rows: element
    (r, c) hashes counter global_rows[r] * cols + c, the bits the
    single-device engines draw there."""
    rows = torch.as_tensor(global_rows, dtype=torch.int64)
    i = rows[:, None] * cols + torch.arange(cols, dtype=torch.int64)[None, :]
    return fused.threefry2x32_hash(k1, k2, i & 0xFFFFFFFF)


def _common_gates(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """The JAX plans' gates after the topology's own, in their order. The
    port is one process drawing the partitionable stream, so the JAX
    process-count and threefry gates have nothing to refuse here."""
    if cfg.dtype != "float32":
        return "fused engine supports float32 only"
    if cfg.telemetry:
        return (
            "telemetry counters run in the single-device fused kernels and "
            "the chunked/sharded XLA engines; this composition does not "
            "carry the counter block"
        )
    if cfg.step_timing and cfg.overlap_collectives:
        return (
            "step_timing under the overlapped super-step schedule would "
            "force the deferred termination psum to drain at every timed "
            "boundary (a host sync inside the overlap window); use "
            "overlap_collectives=False or step_timing=False"
        )
    if cfg.faulted:
        return "failure models not supported in this fused kernel"
    if cfg.delivery == "scatter":
        return (
            "the fused kernel delivers via the stencil formulation only; "
            "delivery='scatter' would be silently ignored"
        )
    return None


def plan_fused_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(H, rows_loc, CR, layout) or a string reason why not: the JAX plan.
    CR = min(chunk_rounds, 64), halved until the halo (one shard at most)
    and the extended planes (the 100 MB VMEM budget) fit."""
    if topo.implicit:
        return (
            "implicit (full) topology has no displacement structure for "
            "the halo composition; use delivery='pool' (the fused pool x "
            "sharded composition, parallel/fused_pool_sharded.py)"
        )
    offsets = topo.offsets
    if offsets is None:
        return f"topology {topo.kind!r} has no small displacement set"
    reason = _common_gates(topo, cfg)
    if reason is not None:
        return reason
    layout = build_pool_layout(topo.n)
    R = layout.rows
    if R % n_dev != 0 or (R // n_dev) % TILE != 0:
        return (
            f"padded layout ({R} rows) must split into whole {TILE}-row "
            f"tiles per device; {n_dev} devices do not divide it"
        )
    rows_loc = R // n_dev
    n_pad, n = layout.n_pad, topo.n
    # Max |in-buffer shift| over both blend variants of every class.
    w = 0
    for d in (int(x) for x in offsets):
        w = max(w, abs(_signed_pad(-d, n_pad)), abs(_signed_pad(n - d, n_pad)))
    CR = max(1, min(int(cfg.chunk_rounds), MAX_SUPERSTEP_ROUNDS))
    per_node = (4 + 4 + 2) if cfg.algorithm == "push-sum" else (3 + 2)

    def h_for(cr):
        return -(-((-(-(cr * w) // LANES) + 1)) // TILE) * TILE

    def fits(cr):
        h = h_for(cr)
        vmem = (rows_loc + 2 * h) * LANES * 4 * (per_node + topo.max_deg + 1)
        return h <= rows_loc and vmem <= _VMEM_BUDGET

    while CR > 1 and not fits(CR):
        CR //= 2
    if not fits(CR):
        return (
            f"per-round halo ({w} slots) at a {rows_loc}-row shard exceeds "
            "the shard or the VMEM plane budget even at chunk_rounds=1; "
            "use the chunked collective engine"
        )
    return (h_for(CR), rows_loc, CR, layout)


def _build_disp_planes(topo: Topology, layout: PoolLayout):
    """[max_deg, rows, 128] int32 mod-n displacement per neighbour slot (0
    on dead slots) and the [rows, 128] degree plane: the JAX engines'
    sampling tables. The port's kernels derive the same displacements
    from the lattice's direction pairs (``topology.lattice_dirs``, the
    slot-th live pair); tests/test_torch_stencil_sharded.py holds the two
    slot by slot."""
    n, n_pad = topo.n, layout.n_pad
    ids = np.arange(n, dtype=np.int64)[:, None]
    disp = (topo.neighbors.astype(np.int64) - ids) % n
    cols = np.arange(topo.max_deg)[None, :]
    disp = np.where(cols < topo.degree[:, None], disp, 0)
    disp_cols = np.zeros((topo.max_deg, n_pad), dtype=np.int32)
    disp_cols[:, :n] = disp.T
    degree = np.zeros((n_pad,), dtype=np.int32)
    degree[:n] = topo.degree
    return (disp_cols.reshape(topo.max_deg, layout.rows, LANES),
            degree.reshape(layout.rows, LANES))


# ---------------------------------------------------------------------------
# One shard's geometry and its classes' rolls.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """The extended buffer of every shard: R global rows, H halo rows a
    side, rows_loc own rows, CR rounds a super-step at most."""

    R: int
    H: int
    rows_loc: int
    cr: int

    @property
    def rows_ext(self) -> int:
        return self.rows_loc + 2 * self.H

    def row0(self, shard: int) -> int:
        """Global row of shard ``shard``'s extended row 0."""
        return (shard * self.rows_loc - self.H + 2 * self.R) % self.R


def shift_pairs(classes, n: int, n_pad: int, n_ext: int) -> tuple:
    """Per class d: (d, e1, e2), the forward rolls over the n_ext-slot
    extended buffer that deliver class d to receivers at global flat >= d
    (e1) and below it (e2): a roll by e delivers out[x] = in[x - e], and
    the sender sits signed_pad(-d) or signed_pad(n - d) slots away."""
    return tuple((int(d), (-_signed_pad(-int(d), n_pad)) % n_ext,
                  (-_signed_pad(n - int(d), n_pad)) % n_ext) for d in classes)


# ---------------------------------------------------------------------------
# The windows: the rows each round of a super-step computes (the contract of
# csrc/shard.cuh), and the static directions words the kernels' marks read.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def shard_windows(spec, rolls: tuple, geom: ShardGeometry, row0: int,
                  rounds: int) -> tuple:
    """The extended row ranges a ``rounds``-round super-step computes on the
    shard of ``geom`` whose extended row 0 is global row ``row0``: ``rounds + 1``
    half-open (lo, hi) pairs, entry j + 1 the window W_j that round j
    absorbs, entry 0 the window W_{-1} that round 0's marks cover.
    W_{rounds-1} is the middle; W_{j-1} is the smallest range holding W_j
    and every source slot (``shard_source`` in csrc/shard.cuh) of a non-pad
    receiver in W_j along every class, from the classes' rolls (d, e1, e2)
    and which receivers lie at or past global flat d (e1) or below it (e2).
    Raises ValueError where a source would wrap across the buffer's ends,
    which the plans' H rules out, or where row0 + rows_ext passes 2R."""
    n, R, H, rows_loc, rows_ext = spec.n, geom.R, geom.H, geom.rows_loc, geom.rows_ext
    n_ext = rows_ext * LANES
    if not 0 <= row0 < R or row0 + rows_ext > 2 * R:
        raise ValueError(f"row0 {row0} + rows_ext {rows_ext} must stay below 2R = {2 * R}")
    # Extended rows [0, R - row0) hold global rows row0.., the rest wrap to
    # global row 0: per piece (first row, end row, global flat minus slot).
    cut = min(R - row0, rows_ext)
    pieces = ((0, cut, row0 * LANES), (cut, rows_ext, (row0 - R) * LANES))
    # Each roll's in-buffer shift: the source of slot x is x + shift.
    shifts = [(d, -(e1 if e1 <= n_ext // 2 else e1 - n_ext),
               -(e2 if e2 <= n_ext // 2 else e2 - n_ext)) for d, e1, e2 in rolls]
    windows = [(H, H + rows_loc)]
    for _ in range(rounds):
        lo, hi = windows[-1]
        s_lo, s_hi = lo * LANES, hi * LANES
        for p_lo, p_hi, off in pieces:
            # Non-pad receivers of the window in this piece: g = x + off < n.
            a = max(lo, p_lo) * LANES
            b = min(min(hi, p_hi) * LANES, n - off)
            if a >= b:
                continue
            for d, sh1, sh2 in shifts:
                at = min(max(d - off, a), b)  # receivers from here on: g >= d
                for ra, rb, sh in ((at, b, sh1), (a, at, sh2)):
                    if ra >= rb:
                        continue
                    if ra + sh < 0 or rb + sh > n_ext:
                        raise ValueError(
                            f"class {d}: sources of slots [{ra}, {rb}) wrap across "
                            f"the {rows_ext}-row buffer's ends in a {rounds}-round "
                            f"super-step (H {H} too small)")
                    s_lo, s_hi = min(s_lo, ra + sh), max(s_hi, rb + sh)
        windows.append((s_lo // LANES, -(-s_hi // LANES)))
    return tuple(reversed(windows))


# ---------------------------------------------------------------------------
# Plain version: one shard's super-step in torch, on any device. It is what
# the kernels of both tiers are held against, and what their wrappers run
# on CPU tensors.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _shard_slots(spec, rolls, R: int, H: int, rows_loc: int, row0: int, device):
    """The static per-slot tensors of one shard's extended buffer: global
    flat index, pad and middle masks, the lattice's direction pairs there
    and each class's source slot. Cached for a run's shards, which ask for
    them every super-step."""
    n, n_ext = spec.n, (rows_loc + 2 * H) * LANES
    x = torch.arange(n_ext, dtype=torch.int64, device=device)
    g = ((row0 + x // LANES) % R) * LANES + x % LANES
    row = x // LANES
    mid = (row >= H) & (row < H + rows_loc)
    pairs = lattice_dirs(spec.kind, n, spec.n_lat, g)
    srcs = [torch.where(g >= d, (x - e1) % n_ext, (x - e2) % n_ext)
            for d, e1, e2 in rolls]
    return g, g >= n, mid, pairs, srcs


def shard_superstep_plain(state, out, y, keys, rounds: int, row0: int, *, spec, rolls,
                          geom: ShardGeometry, delta: float = 0.0,
                          term_rounds: int = 0, rumor_target: int = 0,
                          suppress: bool = False, windows=None,
                          global_term: bool = False):
    """``rounds`` lattice rounds on one shard's extended planes ``state``
    (push-sum s, w, term, conv; gossip count, active, conv; [rows_ext, 128]
    each, read only), keys[j] the fold_in key of round j, ``rolls`` the
    classes' (d, e1, e2). Round j computes the rows of its window W_j
    (``windows``, by default ``shard_windows``; every row of the buffer in
    each round gives the full-buffer super-step) from round j - 1's planes
    and writes them into its destination set, ``out`` for the last round
    and alternately ``y`` before it, leaving the other rows as they were.
    Returns u, int32 [cr + 1]: u[j] the converged count over the middle
    rows after round j (-1 for rounds not run), u[cr] the rounds run. Under
    push-sum's ``global_term`` term and conv pass through unchanged and
    u[j] counts the middle's real nodes whose ratio moved more than delta *
    max(|s / w|, 1) in round j."""
    dev = state[0].device
    pushsum = len(state) == 4
    g, pad, mid, pairs, srcs = _shard_slots(spec, tuple(rolls), geom.R, geom.H,
                                            geom.rows_loc, row0, dev)
    if windows is None:
        windows = shard_windows(spec, tuple(rolls), geom, row0, rounds)
    classes = torch.tensor(spec.classes, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    u = torch.full((geom.cr + 1,), -1, dtype=torch.int32)
    u[geom.cr] = rounds
    keys = keys.cpu()
    mid_lo, mid_hi = geom.H * LANES, (geom.H + geom.rows_loc) * LANES
    src = [p.reshape(-1) for p in state]
    for j in range(rounds):
        dst = [p.reshape(-1) for p in (out if (rounds - 1 - j) % 2 == 0 else y)]
        # Round j's marks over W_{j-1}; every other slot holds class 0, so a
        # read outside the window would show.
        ma, mb = (r * LANES for r in windows[j])
        bits = fused.threefry2x32_hash(int(keys[j, 0]), int(keys[j, 1]), g[ma:mb])
        d, deg = hbm._sample_disp_dirs(bits, [(lv[ma:mb], dp[ma:mb])
                                              for lv, dp in pairs])
        mark = torch.zeros_like(g)
        mark[ma:mb] = torch.where((deg > 0) & ~pad[ma:mb],
                                  torch.searchsorted(classes, d), -1)
        if not pushsum:
            mark[ma:mb] = torch.where(src[1][ma:mb] != 0, mark[ma:mb], -1)
        a, b = (r * LANES for r in windows[j + 1])
        rx = slice(a, b)
        pad_r = pad[rx]
        if pushsum:
            s, w, t, c = src
            ss = torch.where(mark >= 0, s * 0.5, zero)
            ws = torch.where(mark >= 0, w * 0.5, zero)
            in_s = torch.zeros(b - a, dtype=torch.float32, device=dev)
            in_w = torch.zeros_like(in_s)
            for k, si in enumerate(srcs):
                si = si[rx]
                hit = mark[si] == k
                in_s = in_s + torch.where(hit, ss[si], zero)
                in_w = in_w + torch.where(hit, ws[si], zero)
            in_s = torch.where(pad_r, zero, in_s)
            in_w = torch.where(pad_r, zero, in_w)
            s_new = (s[rx] - ss[rx]) + in_s
            w_new = (w[rx] - ws[rx]) + in_w
            if global_term:
                ratio_old = s[rx] / w[rx]
                tol = torch.tensor(delta, dtype=torch.float32, device=dev) * \
                    torch.maximum(torch.abs(ratio_old), torch.ones((), device=dev))
                unstable = (torch.abs(s_new / w_new - ratio_old) > tol) & ~pad_r
                for p, v in zip(dst, (s_new, w_new, t[rx], c[rx])):
                    p[rx] = v.to(p.dtype)
                x = torch.arange(a, b, device=dev)
                u[j] = int((unstable & (x >= mid_lo) & (x < mid_hi)).sum())
                src = dst
                continue
            stable = torch.abs(s_new / w_new - s[rx] / w[rx]) <= torch.tensor(
                delta, dtype=torch.float32, device=dev)
            t_new = torch.where(in_w > 0, torch.where(stable, t[rx] + 1, 0), t[rx])
            c_new = torch.where(pad_r, 0, (c[rx] != 0) | (t_new >= term_rounds))
            new = (s_new, w_new, t_new, c_new)
        else:
            cnt, act, c = src
            inbox = torch.zeros(b - a, dtype=torch.int32, device=dev)
            for k, si in enumerate(srcs):
                inbox = inbox + (mark[si[rx]] == k).to(torch.int32)
            inbox = torch.where(pad_r, 0, inbox)
            if suppress:
                inbox = torch.where(c[rx] != 0, 0, inbox)
            cnt_new = cnt[rx] + inbox
            new = (cnt_new, (act[rx] != 0) | (inbox > 0),
                   (cnt_new >= rumor_target) & ~pad_r)
        for p, v in zip(dst, new):
            p[rx] = v.to(p.dtype)
        u[j] = int((dst[-1][mid_lo:mid_hi] != 0).sum())
        src = dst
    return u


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# version. No fallback between the two. Each runs ``rounds`` rounds from the
# plane set ``planes`` (left unchanged) into ``out``, alternating with
# ``y``, over the super-step's windows, and writes ``u`` (int32 [cr + 1])
# unless ``ctrl[0]`` (the run's done flag) is set, when it runs nothing.
# ``mark`` is the int8 mark scratch, two planes by round parity; ``bar``
# the barrier words of the cooperative launch.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Planes, mark, keys and directions words; the host class, roll and window
# arrays; the shard and round counts; the protocol's scalars (push-sum's
# global flag last); u and ctrl.
_PUSHSUM_ARGS = [_P] * 19 + [_I] * 9 + [_F, _I, _I, _P, _P]
_GOSSIP_ARGS = [_P] * 16 + [_I] * 11 + [_P, _P]
_SIGNATURES = {
    "gossip_pushsum_stencil_shard_superstep": _PUSHSUM_ARGS + [_P, _I, _P],
    "gossip_gossip_stencil_shard_superstep": _GOSSIP_ARGS + [_P, _I, _P],
    "gossip_pushsum_stencil_hbm_shard_superstep": _PUSHSUM_ARGS + [_I, _P],
    "gossip_gossip_stencil_hbm_shard_superstep": _GOSSIP_ARGS + [_I, _P],
    "gossip_stencil_shard_verdict": [_P] + [_I] * 5 + [_P, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(source: str, name: str):
    return kernels.entry(source, name, _SIGNATURES[name])


def check_superstep(planes, out, y, mark, keys, rounds: int, row0: int, spec,
                    rolls, geom: ShardGeometry, u, ctrl, bar=None) -> torch.device:
    """The checks of every super-step wrapper (``bar`` for the resident
    tier's). Returns the planes' device."""
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shard super-steps run on cpu or cuda tensors, got {dev}")
    shape = (geom.rows_ext, LANES)
    dtypes = ((torch.float32, torch.float32, torch.int32, torch.int32)
              if len(planes) == 4 else (torch.int32,) * 3)
    for x, dt in zip(tuple(planes) + tuple(out) + tuple(y), dtypes * 3):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"shard plane must be {dt} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError("shard planes must be contiguous")
    if not 1 <= rounds <= min(geom.cr, MAX_SUPERSTEP_ROUNDS):
        raise ValueError(f"rounds must lie in [1, {min(geom.cr, MAX_SUPERSTEP_ROUNDS)}], "
                         f"got {rounds}")
    if not 0 <= row0 < geom.R:
        raise ValueError(f"row0 must lie in [0, {geom.R}), got {row0}")
    if len(rolls) != len(spec.classes) or not 1 <= len(rolls) <= 16:
        raise ValueError("one (d, e1, e2) roll per displacement class, at most 16")
    if (mark.dtype != torch.int8 or mark.device != dev
            or mark.numel() != 2 * geom.rows_ext * LANES):
        raise ValueError(f"mark must be int8 [2 * rows_ext * 128] on {dev}")
    if (keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2
            or keys.shape[0] < rounds or not keys.is_contiguous()
            or keys.device != dev):
        raise ValueError(f"keys must be contiguous int64 [>= rounds, 2] on {dev}")
    for x, size in ((u, geom.cr + 1), (ctrl, 2)) + (((bar, 2),) if bar is not None else ()):
        if x.device != dev or x.dtype != torch.int32 or x.numel() != size:
            raise ValueError(f"u, ctrl and bar must be int32 [cr + 1], [2] and [2] "
                             f"on {dev}")
    return dev


def run_plain(planes, out, y, keys, rounds, row0, u, ctrl, kw) -> None:
    """The CPU branch of the wrappers: unless done, the plain version into
    ``out``, ``y`` and ``u``; when done, ``u`` says no round ran."""
    if int(ctrl[0]):
        u.fill_(-1)
        u[-1] = 0
        return
    u.copy_(shard_superstep_plain(planes, out, y, keys, rounds, row0, **kw))


@functools.lru_cache(maxsize=256)
def _host_args(spec, rolls: tuple, geom: ShardGeometry, row0: int, rounds: int):
    """A super-step's host arrays for its C call (d, e1, e2, the windows)
    and their pointers, kept alive by the cache."""
    windows = shard_windows(spec, rolls, geom, row0, rounds)
    arrays = tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (
        [r[0] for r in rolls], [r[1] for r in rolls], [r[2] for r in rolls],
        [v for w in windows for v in w]))
    return arrays, [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


def launch_superstep(source: str, name: str, dev, planes, out, y, mark, keys,
                     rounds: int, row0: int, spec, rolls, geom, tail, u, ctrl,
                     bar=None) -> None:
    """Queue one super-step through entry point ``name`` of csrc/<source>.cu
    on the current stream of ``dev``, over the super-step's windows;
    ``tail`` holds the protocol's scalar arguments. Raises on a launch
    error."""
    _arrays, host = _host_args(spec, tuple(rolls), geom, row0, rounds)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptrs = [ctypes.c_void_p(x.data_ptr())
            for x in (*planes, *out, *y, mark, keys, dir_words(spec, geom.R, dev))]
    ints = (len(rolls), spec.n, geom.R, row0, geom.rows_ext, geom.H, geom.rows_loc,
            rounds, geom.cr)
    tail_ptrs = [ctypes.c_void_p(u.data_ptr()), ctypes.c_void_p(ctrl.data_ptr())]
    if bar is not None:
        tail_ptrs.append(ctypes.c_void_p(bar.data_ptr()))
    err = _entry(source, name)(*ptrs, *host, *ints, *tail, *tail_ptrs, dev.index,
                               stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def pushsum_stencil_shard_superstep(planes, out, y, mark, keys, rounds: int,
                                    row0: int, *, spec, rolls,
                                    geom: ShardGeometry, delta: float,
                                    term_rounds: int, u, ctrl, bar,
                                    global_term: bool = False) -> None:
    """Up to CR push-sum rounds on one shard's extended (s, w, term, conv)
    planes into ``out`` (see the section comment): one persistent
    cooperative launch of csrc/fused_stencil_shard.cu on CUDA tensors, the
    plain version on CPU ones. ``mark`` is int8 [2 * rows_ext * 128],
    ``bar`` two zeroed int32 words the launch leaves zeroed.
    ``global_term`` runs the global-termination instance: term and conv
    pass through and u[j] is the middle's unstable count of round j."""
    dev = check_superstep(planes, out, y, mark, keys, rounds, row0, spec, rolls,
                          geom, u, ctrl, bar)
    if dev.type == "cpu":
        run_plain(planes, out, y, keys, rounds, row0, u, ctrl,
                  {"spec": spec, "rolls": rolls, "geom": geom, "delta": delta,
                   "term_rounds": term_rounds, "global_term": global_term})
        return
    launch_superstep("fused_stencil_shard", "gossip_pushsum_stencil_shard_superstep",
                     dev, planes, out, y, mark, keys, rounds, row0, spec, rolls,
                     geom, (ctypes.c_float(delta), term_rounds, int(global_term)),
                     u, ctrl, bar)
    pushsum_stencil_shard_superstep.launches += 1


def gossip_stencil_shard_superstep(planes, out, y, mark, keys, rounds: int,
                                   row0: int, *, spec, rolls,
                                   geom: ShardGeometry, rumor_target: int,
                                   suppress: bool, u, ctrl, bar) -> None:
    """Gossip analog of ``pushsum_stencil_shard_superstep``: (count,
    active, conv), receiver-side suppression."""
    dev = check_superstep(planes, out, y, mark, keys, rounds, row0, spec, rolls,
                          geom, u, ctrl, bar)
    if dev.type == "cpu":
        run_plain(planes, out, y, keys, rounds, row0, u, ctrl,
                  {"spec": spec, "rolls": rolls, "geom": geom,
                   "rumor_target": rumor_target, "suppress": suppress})
        return
    launch_superstep("fused_stencil_shard", "gossip_gossip_stencil_shard_superstep",
                     dev, planes, out, y, mark, keys, rounds, row0, spec, rolls,
                     geom, (rumor_target, int(suppress)), u, ctrl, bar)
    gossip_stencil_shard_superstep.launches += 1


# Kernel launches queued by each wrapper (one a shard a super-step),
# counted where the kernel is launched and nowhere else.
pushsum_stencil_shard_superstep.launches = 0
gossip_stencil_shard_superstep.launches = 0


def shard_verdict(u, executed: int, target: int, ctrl) -> None:
    """A super-step's verdict on ``u`` (int32 [S, cr + 1], the shards'
    u, on ctrl's device): unless ctrl[0] (done) is set, count ``executed``
    rounds in ctrl[1] and set done once the shards' counts after round
    executed - 1 sum to ``target``."""
    if ctrl.device.type == "cpu":
        if not int(ctrl[0]):
            ctrl[1] += executed
            ctrl[0] = int(int(u[:, executed - 1].sum()) >= target)
        return
    stream = ctypes.c_void_p(torch.cuda.current_stream(ctrl.device).cuda_stream)
    err = _entry("fused_stencil_shard", "gossip_stencil_shard_verdict")(ctypes.c_void_p(u.data_ptr()), u.shape[1], u.shape[0], executed - 1,
             executed, target, ctypes.c_void_p(ctrl.data_ptr()), ctrl.device.index,
             stream)
    if err:
        raise RuntimeError(f"stencil_shard_verdict: CUDA launch failed with "
                           f"cudaError_t {err}")


# ---------------------------------------------------------------------------
# The JAX factories' functional form: one super-step from given planes, for
# the tests and the card's checks.
# ---------------------------------------------------------------------------


def functional_superstep(superstep, kw, ext_state, keys, row0: int, start: int,
                         cap: int, bar: bool):
    """One super-step of ``superstep`` (a wrapper, with barrier words when
    ``bar``) from ``ext_state``: keys int64 [K, 2] (a CPU tensor), rounds =
    min(K, cap - start). Returns (ext_state', executed, u) with u int32
    [K + 1] on the host; the rows outside the super-step's windows keep the
    input's values, and a super-step of 0 rounds returns copies of its
    input."""
    geom = kw["geom"]
    cap, keys = fused.clamp_cap_and_pad(start, cap, keys)
    geom = dataclasses.replace(geom, cr=keys.shape[0])
    rounds = max(0, cap - start)
    dev = ext_state[0].device
    if rounds == 0:
        u = torch.full((geom.cr + 1,), -1, dtype=torch.int32)
        u[-1] = 0
        return tuple(x.clone() for x in ext_state), 0, u
    out = [x.clone() for x in ext_state]
    y = [x.clone() for x in ext_state]
    mark = torch.empty(2 * geom.rows_ext * LANES, dtype=torch.int8, device=dev)
    u = torch.zeros(geom.cr + 1, dtype=torch.int32, device=dev)
    ctrl = torch.zeros(2, dtype=torch.int32, device=dev)
    keys = keys.to(dev) if dev.type == "cpu" else _upload(keys, dev)
    extra = {"bar": torch.zeros(2, dtype=torch.int32, device=dev)} if bar else {}
    superstep(ext_state, out, y, mark, keys, rounds, row0, **{**kw, "geom": geom},
              u=u, ctrl=ctrl, **extra)
    return tuple(out), rounds, u.cpu()


def protocol_kw(topo: Topology, cfg: SimConfig, geom: ShardGeometry, rolls) -> dict:
    """The wrappers' keywords for this config."""
    kw = {"spec": hbm.stencil_spec(topo), "rolls": rolls, "geom": geom}
    if cfg.algorithm == "push-sum":
        kw.update(delta=cfg.resolved_delta, term_rounds=cfg.term_rounds,
                  global_term=cfg.termination == "global")
    else:
        kw.update(rumor_target=cfg.resolved_rumor_target,
                  suppress=cfg.resolved_suppress)
    return kw


def make_stencil_shard_chunk(topo: Topology, cfg: SimConfig, H: int,
                             rows_loc: int, layout):
    """``chunk_fn(ext_state, keys, row0, start, cap) -> (ext_state',
    executed, conv_mid, u)``: up to K = keys.shape[0] rounds on one shard's
    extended planes (the JAX factory's contract, its displacement and
    degree planes derived in the kernel); conv_mid is the middle converged
    count after the last round run (0 if none), u [K] the per-round counts
    (-1 where not run). Returns (chunk_fn, rows_ext)."""
    geom = ShardGeometry(layout.rows, H, rows_loc, 1)
    rolls = shift_pairs(topo.offsets, topo.n, layout.n_pad, geom.rows_ext * LANES)
    kw = protocol_kw(topo, cfg, geom, rolls)
    superstep = (pushsum_stencil_shard_superstep if cfg.algorithm == "push-sum"
                 else gossip_stencil_shard_superstep)

    def chunk_fn(ext_state, keys, row0, start, cap):
        out, executed, u = functional_superstep(superstep, kw, ext_state, keys,
                                                int(row0), int(start), int(cap), True)
        conv_mid = int(u[executed - 1]) if executed else 0
        return out, executed, conv_mid, u[:-1]

    return chunk_fn, geom.rows_ext


# ---------------------------------------------------------------------------
# The run, shared by both lattice tiers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tier:
    """What a lattice tier gives the shared run: its plan's geometry and
    rolls, its chunk stride, its wrappers, whether they take the
    cooperative launch's barrier words and the kernel sources to build."""

    geom: ShardGeometry
    rolls: tuple
    stride: int
    pushsum: object
    gossip: object
    barrier: bool
    sources: tuple


def _start_mid(topo, cfg, key, mesh, rows_loc, layout, start_state):
    """Per shard, its middle rows' start planes on its device: from
    ``start_state`` (canonical [n] tensors), or built per shard from the
    global row index (the JAX ``to_planes`` fills: pad w 1, pad term the
    initial term round)."""
    from ..models.runner import draw_leader

    n = topo.n
    pushsum = cfg.algorithm == "push-sum"
    term0 = cfg.initial_term_round
    if start_state is not None:
        if pushsum:
            full = (fused._pad2d(start_state.s.cpu().to(torch.float32), layout, 0.0),
                    fused._pad2d(start_state.w.cpu().to(torch.float32), layout, 1.0),
                    fused._pad2d(start_state.term.cpu().to(torch.int32), layout, term0),
                    fused._pad2d(start_state.conv.cpu().to(torch.int32), layout, 0))
        else:
            full = tuple(fused._pad2d(x.cpu().to(torch.int32), layout, 0)
                         for x in (start_state.count, start_state.active,
                                   start_state.conv))
        return [tuple(p[s * rows_loc:(s + 1) * rows_loc].contiguous().to(dev)
                      for p in full) for s, dev in enumerate(mesh.devices)]

    def ids(lo, hi, dev):
        return mesh_mod.flat_ids(lo, hi, LANES, dev)

    def const(value, dtype):
        return lambda lo, hi, dev: torch.full((hi - lo, LANES), value, dtype=dtype,
                                              device=dev)

    if pushsum:
        row_fns = (
            lambda lo, hi, dev: torch.where(ids(lo, hi, dev) < n, ids(lo, hi, dev),
                                            0).to(torch.float32),
            const(1.0, torch.float32), const(term0, torch.int32),
            const(0, torch.int32))
    else:
        leader = draw_leader(key, topo, cfg)
        row_fns = (const(0, torch.int32),
                    lambda lo, hi, dev: (ids(lo, hi, dev) == leader).to(torch.int32),
                    const(0, torch.int32))
    planes = [mesh_mod.put_rows(mesh, rows_loc, fn) for fn in row_fns]
    return [tuple(p[s] for p in planes) for s in range(mesh.size)]


def run_lattice_shards(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh, key,
                       tier: Tier, start_state=None, start_round: int = 0,
                       t_enter: Optional[float] = None, on_chunk=None):
    """A sharded lattice run on ``tier``, to convergence or cfg.max_rounds;
    returns the RunResult, its state the canonical [n] planes joined from
    the shards' middle rows.

    Each shard keeps two extended plane sets and a third for the rounds in
    between: super-step i reads set i % 2 and leaves its result in the
    other, never writing its input, so a deferred verdict that fires rolls
    the next super-step back by the round counter alone. The run's done
    flag and round counter (``ctrl``) and the shards' counts live on shard
    0's device; a shard on another device gets its copy of the flag after
    each verdict and returns its counts after each super-step. Batches of
    STEPS_PER_BATCH super-steps are queued through models/pipeline.py, one
    host sync each. Push-sum's global termination runs the super-steps
    serially with one host read each (``global_verdict``), as JAX does: the
    run stops at the exact round, not at a super-step boundary.

    Under a boundary observer (``on_chunk``, the stall watchdog, step
    timing) a dispatch is one JAX chunk of ``tier.stride`` rounds and the
    loop runs at depth 1, since the next batch would overwrite the sets a
    retired boundary's state lies in; the hooks read the joined [n] state,
    padding stripped, on the host."""
    from ..models import gossip as gossip_mod
    from ..models import pipeline as pipeline_mod
    from ..models import pushsum as pushsum_mod
    from ..models.runner import (
        _finalize_result,
        _host_done,
        boundary_hooks,
        hook_kw,
    )

    t_enter = time.perf_counter() if t_enter is None else t_enter
    S, geom = mesh.size, tier.geom
    H, rows_loc, CR = geom.H, geom.rows_loc, geom.cr
    layout = build_pool_layout(topo.n)
    n = topo.n
    pushsum = cfg.algorithm == "push-sum"
    target = cfg.resolved_target_count(n, topo.target_count)
    devices, home = mesh.devices, mesh.devices[0]
    superstep = tier.pushsum if pushsum else tier.gossip
    kw = protocol_kw(topo, cfg, geom, tier.rolls)

    start = _start_mid(topo, cfg, key, mesh, rows_loc, layout, start_state)
    done0 = start_state is not None and _host_done(start_state, target)
    sets, ys, marks, bars = [], [], [], []
    for s, dev in enumerate(devices):
        x0 = tuple(torch.empty(geom.rows_ext, LANES, dtype=p.dtype, device=dev)
                   for p in start[s])
        for x, p in zip(x0, start[s]):
            x[H:H + rows_loc].copy_(p)
        sets.append((x0, tuple(torch.empty_like(x) for x in x0)))
        ys.append(tuple(torch.empty_like(x) for x in x0))
        marks.append(torch.empty(2 * geom.rows_ext * LANES, dtype=torch.int8,
                                 device=dev))
        bars.append(torch.zeros(2, dtype=torch.int32, device=dev))
    del start
    wires = [halo.ring_exchange([sets[s][par] for s in range(S)], H, rows_loc)
             for par in (0, 1)]
    ctrl = torch.tensor([int(done0), start_round], dtype=torch.int32, device=home)
    ctrl_on = {dev: (ctrl if dev == home else ctrl.to(dev)) for dev in devices}
    u_all = torch.zeros(2, S, CR + 1, dtype=torch.int32, device=home)
    u_of = [[u_all[par, s] if dev == home else
             torch.zeros(CR + 1, dtype=torch.int32, device=dev) for par in (0, 1)]
            for s, dev in enumerate(devices)]
    row0 = [geom.row0(s) for s in range(S)]
    extra = [{"bar": bars[s]} if tier.barrier else {} for s in range(S)]
    # Super-step boundaries: the set a round count's state is in.
    set_of_round = {start_round: 0}
    counter = {"step": 0, "end": start_round}

    def launch(step):
        i, b, e, keys_on = step
        par = i % 2
        halo.exchange_rows_batched(wires[par])
        for s, dev in enumerate(devices):
            superstep(sets[s][par], sets[s][1 - par], ys[s], marks[s], keys_on[dev],
                      e - b, row0[s], **kw, u=u_of[s][par], ctrl=ctrl_on[dev],
                      **extra[s])
            if dev != home:
                u_all[par, s].copy_(u_of[s][par])
        set_of_round[e] = 1 - par

    def verdict(step):
        i, b, e, _ = step
        shard_verdict(u_all[i % 2], e - b, target, ctrl)
        for dev, c in ctrl_on.items():
            if dev != home:
                c.copy_(ctrl)

    global_term = pushsum and cfg.termination == "global"
    # Global termination's latch: conv 1 on every real node of a shard's
    # middle rows, 0 on its pad lanes, on the shard's own device.
    latch = [mesh_mod.flat_ids(s * rows_loc, (s + 1) * rows_loc, LANES, dev)
             .lt(n).to(torch.int32) for s, dev in enumerate(devices)] \
        if global_term else None
    verdict_at = {"done": bool(done0)}

    def global_verdict(step):
        # The exact stop of global termination (the JAX package's
        # global_verdict_step), one host read a super-step: the first round
        # whose unstable count, summed over the shards, is 0; a super-step
        # that ran past it is run again from the same input set (which no
        # super-step writes) with the same keys, capped there, which is
        # bitwise the prefix; then conv latches on every real node.
        i, b, e, keys_on = step
        if verdict_at["done"]:
            return
        par, executed = i % 2, e - b
        zeros = (u_all[par, :, :executed].sum(0) == 0).nonzero()
        if len(zeros) == 0:
            ctrl[1] += executed
            return
        stop = int(zeros[0]) + 1
        if stop < executed:
            for s, dev in enumerate(devices):
                superstep(sets[s][par], sets[s][1 - par], ys[s], marks[s],
                          keys_on[dev], stop, row0[s], **kw, u=u_of[s][par],
                          ctrl=ctrl_on[dev], **extra[s])
        for s in range(S):
            sets[s][1 - par][3][H:H + rows_loc].copy_(latch[s])
        set_of_round[b + stop] = 1 - par
        verdict_at["done"] = True
        ctrl[0], ctrl[1] = 1, b + stop
        for dev, c in ctrl_on.items():
            if dev != home:
                c.copy_(ctrl)

    def boundary(b):
        return overlap_mod.next_boundary(b, start_round, tier.stride, CR,
                                         cfg.max_rounds)

    def next_end(last_end):
        for _ in range(STEPS_PER_BATCH):
            if last_end >= cfg.max_rounds:
                break
            last_end = boundary(last_end)
        return last_end

    def dispatch(state, status, round_end):
        # A batch that runs at all starts where the previous one was told
        # to end: only termination stops one short, and every later
        # batch's launches then return at once.
        begin, counter["end"] = counter["end"], round_end
        if round_end <= begin:
            return state, ctrl[[1, 0]].to(torch.int64)
        keys = fused.round_keys(key, begin, round_end - begin)
        keys_on = {dev: (keys if dev.type == "cpu" else _upload(keys, dev))
                   for dev in set(devices)}
        steps, b = [], begin
        while b < round_end:
            e = boundary(b)
            steps.append((counter["step"], b, e,
                          {dev: k[b - begin:] for dev, k in keys_on.items()}))
            counter["step"] += 1
            b = e
        if global_term:
            # JAX keeps the serial loop for global termination.
            overlap_mod.overlapped_superstep_loop(steps, launch=launch,
                                                  verdict=global_verdict,
                                                  overlap=False)
        else:
            overlap_mod.overlapped_superstep_loop(
                steps, launch=launch, verdict=verdict,
                overlap=cfg.overlap_collectives)
        return state, ctrl[[1, 0]].to(torch.int64)

    t0 = time.perf_counter()
    setup_s = t0 - t_enter
    if home.type == "cuda":
        for source in tier.sources:
            kernels.load(source)
        torch.cuda.synchronize(home)
    compile_s = time.perf_counter() - t0

    def state_at(rounds, dev):
        # The canonical state after ``rounds`` rounds, joined on ``dev``.
        final = [sets[s][set_of_round[rounds]] for s in range(S)]
        joined = [torch.cat([final[s][p][H:H + rows_loc].to(dev) for s in range(S)])
                  .reshape(-1)[:n] for p in range(len(final[0]))]
        if pushsum:
            return pushsum_mod.PushSumState(s=joined[0], w=joined[1], term=joined[2],
                                            conv=joined[3] != 0)
        return gossip_mod.GossipState(count=joined[0], active=joined[1] != 0,
                                      conv=joined[2] != 0)

    on_retire, should_stop, watchdog = boundary_hooks(
        topo, cfg, target, on_chunk, lambda rounds, _: state_at(rounds, "cpu"))
    hooked = on_retire is not None or should_stop is not None or cfg.step_timing
    t1 = time.perf_counter()
    loop = pipeline_mod.run_chunks(
        dispatch=dispatch, state0=None, status0=ctrl[[1, 0]].to(torch.int64),
        start_round=start_round, max_rounds=cfg.max_rounds, stride=tier.stride,
        depth=1 if hooked else cfg.pipeline_chunks,
        next_end=None if hooked else next_end,
        **hook_kw(cfg, on_retire, should_stop),
    )
    run_s = time.perf_counter() - t1
    t_fin = time.perf_counter()
    state = state_at(loop.rounds, home)
    result = _finalize_result(topo, cfg, state, loop.rounds, target, compile_s,
                              run_s, loop.done, loop, home, stalled=watchdog.stalled)
    result.setup_s = setup_s
    result.finalize_s = time.perf_counter() - t_fin
    return result


def vmem_tier(topo: Topology, cfg: SimConfig, n_dev: int) -> Tier:
    """The resident tier's Tier for this config, or ValueError with the
    plan's reason."""
    plan = plan_fused_sharded(topo, cfg, n_dev)
    if isinstance(plan, str):
        raise ValueError(f"engine='fused' with n_devices={n_dev} unavailable: {plan}")
    H, rows_loc, CR, layout = plan
    geom = ShardGeometry(layout.rows, H, rows_loc, CR)
    return Tier(geom=geom,
                rolls=shift_pairs(topo.offsets, topo.n, layout.n_pad,
                                  geom.rows_ext * LANES),
                stride=cfg.chunk_rounds * 8,
                pushsum=pushsum_stencil_shard_superstep,
                gossip=gossip_stencil_shard_superstep, barrier=True,
                sources=("fused_stencil_shard",))


def run_fused_sharded(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh, key,
                      start_state=None, start_round: int = 0,
                      t_enter: Optional[float] = None, on_chunk=None):
    """Sharded resident lattice run (engine='fused', n_devices > 1, while
    a shard fits the JAX plan's 100 MB budget): run_lattice_shards on this
    tier, chunks of chunk_rounds * 8 rounds as in the JAX run."""
    return run_lattice_shards(topo, cfg, mesh, key, vmem_tier(topo, cfg, mesh.size),
                              start_state, start_round, t_enter, on_chunk)
