"""imp2d/imp3d x HBM x sharded: the counterpart of the JAX package's
parallel/fused_imp_hbm_sharded.py, for imp populations past one device
(the single-device imp tiers stop at 2**27 nodes).

Shard i owns global rows [i * rows_loc, (i + 1) * rows_loc) of the padded
[R, 128] pool layout (``build_pool_layout``). One super-step is ONE round,
as in the JAX composition: the pooled long-range classes are uniform over
the whole ring, so nothing coarser is exact. Each device keeps two global
int8 mark planes, one per round parity, holding the class id each node
sends along (-1 for none). Round r is

1. **wire**: each shard's rows of mark plane r % 2 (and, for push-sum, of
   the current s and w planes) copied into every other device's global
   copy, one ``torch._foreach_copy_`` per device pair into preallocated
   rows (parallel/halo.py); shards on one device share its copies, so on
   one card the wire moves nothing;
2. **absorb**: one launch a shard over its own rows, reading every source
   from its device's global copies: lattice class q from j - d_q (the
   honest lattice never wraps), pool slot p from (j - offs[p]) mod n, the
   sends of the class sources whose mark is the class, summed in class
   order; it writes the shard's next planes, u (its converged count) and
   its nodes' round r + 1 marks into mark plane (r + 1) % 2
   (csrc/fused_imp_hbm_shard.cu, the single-device draw of
   csrc/fused_imp.cu: the slot word at the node's global index, read
   through its directions word, the pool choice from the packed word of
   its 8-row group; gossip from the active flag it has just computed);
3. **verdict**: the shards' u summed against the target on the device,
   deferred one round under ``overlap_collectives`` (parallel/overlap.py).

A mark prologue, one launch a shard, writes the first round's marks where
a run starts or resumes. The run draws each chunk's streams one round past
its end, so the chunk's last round writes the next chunk's first marks.

This departs from the JAX wire, which sends the raw windowed planes (s and
w, or active: 8 or 4 bytes a node) in one all_gather plus a ring halo of
every plane, and has each TPU tile REGENERATE the marks of every window it
reads (a tile load needs a static window in VMEM). On the card a source is
a load at a computed index, so the absorb reads class ids from a global
mark plane and no halo exists: the wire carries 9 bytes a node (push-sum s,
w, mark) or 1 (gossip mark), and each shard computes only its own rows.
The plan (``plan_imp_hbm_sharded``) is still the JAX plan, halo H and
processing tile PT included, so the ladder accepts and refuses exactly
where the JAX one does; H and PT decide nothing else here.

Each output row is computed from the same marks and sends by the same
operations, in the same order, as the single-device imp run
(ops/fused_imp.py), so a sharded run is bitwise it: same rounds, same
state. Termination is checked every round, so ``rounds`` is exact; under
push-sum's global termination a shard's count is its unstable real nodes,
the verdict fires when they sum to 0, and the run latches conv on every
real node (the JAX plan refuses the drop gate and crash-stop). On the
CPU the wrappers run their plain torch versions; on CUDA they launch the
kernels; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import torch

from ..config import SimConfig
from ..ops import fused, fused_imp, fused_pool
from ..ops.fused import LANES
from ..ops.fused_pool import build_pool_layout
from ..ops.fused_stencil_hbm import _KIND_IDS, _centered_sq, _plan_from_needs
from ..ops.sampling import POOL_CHOICE_BITS
from ..ops.topology import IMP_LATTICE, Topology, imp_lattice_offsets
from ..utils import kernels
from . import halo
from . import mesh as mesh_mod
from .fused_hbm_sharded import _HBM_PLANE_BUDGET, _VMEM_SCRATCH_BUDGET

# The JAX plan's processing-tile candidates: its lattice compositions' plus
# two small ones for test-size shards.
_PT_CANDIDATES = (2048, 1024, 512, 256, 128, 64)

# Rounds per chunk of the run's chunk loop (the JAX run's stride).
STRIDE = 8


# ---------------------------------------------------------------------------
# The plan: the JAX plan's gates, geometry and reasons.
# ---------------------------------------------------------------------------


def _imp_lattice_offsets(kind: str, n: int):
    """Sorted mod-n lattice displacement classes of an honest imp kind, from
    (kind, n) alone; None when n is not a perfect square (imp2d) or cube
    (imp3d)."""
    if kind == "imp2d":
        s = round(n ** 0.5)
        if s * s != n:
            return None
        return sorted({n - 1, 1, n - s, s})
    g = round(n ** (1 / 3))
    if g * g * g != n:
        return None
    g2 = g * g
    return sorted({n - 1, 1, n - g, g, n - g2, g2})


def _imp_lat_plan(kind: str, layout, rows_ext: int, PT: int):
    """The JAX kernel's lattice-window plan over a rows_ext-row extended
    ring: one signed need per class (the non-wrap lattice), keyed by class
    id, grouped by the shared planner (ops/fused_stencil_hbm.
    _plan_from_needs). Returns (classes, groups, M); the plan's budgets
    read groups and M."""
    n_ext = rows_ext * LANES
    N = layout.n
    offs = _imp_lattice_offsets(kind, N)
    assert offs is not None
    needs = []
    for q, d in enumerate(offs):
        e = (d if d <= N // 2 else d - N) % n_ext
        needs.append((q, d, e, _centered_sq(e, rows_ext), None))
    return _plan_from_needs(needs, list(range(len(offs))), PT, with_liveness=False)


def plan_imp_hbm_sharded_shape(kind: str, n: int, cfg: SimConfig, n_dev: int):
    """(H, rows_loc, PT, layout) or a string reason why not: the JAX plan,
    a function of (kind, n, cfg, n_dev) alone, its gates in its order (the
    port is one process drawing the partitionable stream, so the JAX
    process-count and threefry gates have nothing to refuse here)."""
    if kind not in IMP_LATTICE:
        return f"topology {kind!r} is not an imp (lattice+extra) kind"
    if cfg.delivery != "pool":
        return (
            "the imp x HBM x sharded composition serves the pooled "
            "long-range recast only (delivery='pool' — the same gate as "
            "the single-device imp engine dispatch)"
        )
    if cfg.reference:
        return (
            "pooled long-range sampling cannot reproduce the reference's "
            "static extra edge (Q9); reference semantics use scatter"
        )
    if cfg.dtype != "float32":
        return "fused engine supports float32 only"
    if cfg.faulted:
        return "failure models not supported in this fused kernel"
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
    if cfg.mass_tolerance is not None:
        return (
            "the health sentinel (--mass-tolerance) runs in the chunked "
            "and sharded XLA round bodies only"
        )
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    offs = _imp_lattice_offsets(kind, n)
    if offs is None:
        return (
            f"honest {kind} lattices need a perfect "
            f"{'square' if kind == 'imp2d' else 'cube'} population; "
            f"{n} is not one"
        )
    layout = build_pool_layout(n)
    R = layout.rows
    if R % n_dev != 0:
        return (
            f"padded layout ({R} rows) must split evenly; {n_dev} devices "
            "do not divide it"
        )
    rows_loc = R // n_dev
    Z = layout.n_pad - layout.n
    w = max(abs(d if d <= n // 2 else d - n) for d in offs)
    n_pw = cfg.pool_size * (1 if Z == 0 else 2)
    pushsum = cfg.algorithm == "push-sum"
    n_state = 4 if pushsum else 3
    n_wp = 2 if pushsum else 1
    h_min = -(-w // LANES) + 1
    cands = []
    for pt in _PT_CANDIDATES:
        r = (-rows_loc) % pt
        if r % 2:
            continue  # 2H cannot hit an odd residue mod an even PT
        h = h_min + ((r // 2 - h_min) % (pt // 2))
        rows_ext = rows_loc + 2 * h
        if rows_ext % pt or rows_ext // pt < 1 or h > rows_loc:
            continue
        _cls, grp, m_lat = _imp_lat_plan(kind, layout, rows_ext, pt)
        MP = pt + 16
        # Each mirror margin must fit one ring revolution.
        if m_lat > rows_ext or MP > R:
            continue
        # The TPU kernel's streaming scratch: own-state tiles, the lattice
        # group windows and the per-slot pool windows, with their marks.
        vmem = (n_state * pt + sum(m for _, m, _l in grp) * (n_wp + 1)
                + n_pw * MP * (n_wp + 1)) * LANES * 4
        if vmem > _VMEM_SCRATCH_BUDGET:
            continue
        # Its per-device planes: the gathered copy, the extended inputs, the
        # in-kernel assembly planes, the outputs and the overlap carry.
        gathered = n_wp * (R + MP)
        ext_in = n_state * rows_ext
        ext_asm = n_wp * (rows_ext + m_lat) + (n_state - n_wp) * rows_ext
        outp = n_state * rows_ext
        carry = gathered + ext_in + n_state * rows_loc
        if (gathered + ext_in + ext_asm + outp + carry) * LANES * 4 > _HBM_PLANE_BUDGET:
            continue
        cands.append((rows_ext, pt, h))
    if not cands:
        return (
            f"no processing-tile split fits: the lattice halo ({w} slots) "
            f"at a {rows_loc}-row shard exceeds the shard, the VMEM "
            "streaming scratch, or the per-device HBM plane budget (the "
            "gathered windowed copy is the floor); use the chunked "
            "collective engine"
        )
    # The largest PT whose halo waste stays within ~12% of the leanest.
    lean = min(c[0] for c in cands)
    ok = [c for c in cands if c[0] <= lean + max(lean // 8, 1)]
    _, PT, H = max(ok, key=lambda c: c[1])
    return (H, rows_loc, PT, layout)


def plan_imp_hbm_sharded(topo: Topology, cfg: SimConfig, n_dev: int):
    """(H, rows_loc, PT, layout) or a string reason why the composition
    can't run this instance: the built instance's lattice slots must be
    offset-structured (the JAX ``imp_split`` gate, asked of
    ``imp_lattice_offsets``, which gives the same answer without the
    per-slot columns), then the shape-level plan."""
    if topo.kind not in IMP_LATTICE:
        return f"topology {topo.kind!r} is not an imp (lattice+extra) kind"
    if imp_lattice_offsets(topo) is None:
        return "lattice slots are not offset-structured for this instance"
    return plan_imp_hbm_sharded_shape(topo.kind, topo.n, cfg, n_dev)


# ---------------------------------------------------------------------------
# Plain versions, in torch on any device: what the kernels are held against
# and what the wrappers run on CPU tensors. ``keys`` and ``ckeys`` are one
# round's key and choice key (two uint32 words each), ``offs`` its P pool
# displacements; global planes are [R, 128], a shard's own [rows_loc, 128].
# ---------------------------------------------------------------------------


def shard_marks_plain(spec, keys, ckeys, pool_size: int, row_lo: int,
                      rows: int, active=None, device=None) -> torch.Tensor:
    """int8 [rows, 128] marks of global rows [row_lo, row_lo + rows) on
    ``device``: each node's class id this round (ops/fused_imp.imp_marks),
    -1 on pad lanes and, for gossip (``active`` the rows' active plane),
    on inactive nodes."""
    mark = fused_imp.imp_marks(spec, keys, ckeys, pool_size, row_lo, row_lo + rows,
                               device=device).reshape(rows, LANES)
    if active is not None:
        mark = torch.where(active != 0, mark, -1)
    return mark.to(torch.int8)


def _sources(spec, offs, row_lo: int, rows_loc: int, device):
    """The receivers' pad mask and the (class id, flat source index) of every
    class in delivery order, for the receivers of global rows [row_lo,
    row_lo + rows_loc): the L lattice classes, then the P pool slots
    (fused.class_sources' roll)."""
    j = torch.arange(row_lo * LANES, (row_lo + rows_loc) * LANES, dtype=torch.int64,
                     device=device)
    n = spec.n
    ds = list(spec.classes) + [int(d) for d in offs]
    return j >= n, [(c, torch.where(j >= d, j - d, j - d + n)) for c, d in enumerate(ds)]


def pushsum_inbox_plain(mark, glob, offs, row_lo: int, rows_loc: int, *, spec):
    """The push-sum inboxes of the receivers of global rows [row_lo, row_lo
    + rows_loc) (csrc/imp.cuh, imp_pushsum_inbox): from 0.0, per class in
    delivery order, the halved send of the class source whose mark (in the
    global int8 ``mark``) is the class; ``glob`` the global (s, w). Returns
    (pad, in_s, in_w), flat, 0.0 on pad receivers."""
    dev = mark.device
    mark = mark.reshape(-1)
    s_g, w_g = (p.reshape(-1) for p in glob)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pad, classes = _sources(spec, offs, row_lo, rows_loc, dev)
    in_s = torch.zeros(rows_loc * LANES, dtype=torch.float32, device=dev)
    in_w = torch.zeros_like(in_s)
    for cid, src in classes:
        hit = mark[src] == cid
        in_s = in_s + torch.where(hit, s_g[src] * 0.5, zero)
        in_w = in_w + torch.where(hit, w_g[src] * 0.5, zero)
    return pad, torch.where(pad, zero, in_s), torch.where(pad, zero, in_w)


def gossip_inbox_plain(mark, offs, row_lo: int, rows_loc: int, *, spec):
    """The gossip inboxes of the same receivers (imp_gossip_inbox): the
    class sources whose mark is the class. Returns (pad, inbox), int32,
    0 on pad receivers."""
    mark = mark.reshape(-1)
    pad, classes = _sources(spec, offs, row_lo, rows_loc, mark.device)
    inbox = torch.zeros(rows_loc * LANES, dtype=torch.int32, device=mark.device)
    for cid, src in classes:
        inbox = inbox + (mark[src] == cid).to(torch.int32)
    return pad, torch.where(pad, 0, inbox)


def pushsum_absorb_plain(mark, glob, own, offs, row_lo: int, *, spec,
                         delta: float, term_rounds: int, global_term: bool = False):
    """The push-sum absorb over one shard: ``mark`` the global int8 marks,
    ``glob`` the global (s, w), ``own`` the shard's (term, conv). Returns
    ((s', w', term', conv') of the shard's rows, u) with u its converged
    count (int32, 0-dim). Under global termination (``global_term``) term
    and conv stay and u counts the shard's real nodes whose ratio moved more
    than delta * max(|s/w|, 1)."""
    term, conv = (p.reshape(-1) for p in own)
    rows_loc, dev = own[0].shape[0], term.device
    pad, in_s, in_w = pushsum_inbox_plain(mark, glob, offs, row_lo, rows_loc, spec=spec)
    lo, hi = row_lo * LANES, (row_lo + rows_loc) * LANES
    s, w = (p.reshape(-1)[lo:hi] for p in glob)
    sends = mark.reshape(-1)[lo:hi] >= 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s_new = (s - torch.where(sends, s * 0.5, zero)) + in_s
    w_new = (w - torch.where(sends, w * 0.5, zero)) + in_w
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    shape = own[0].shape
    if global_term:
        ratio_old = s / w
        tol = delta_t * torch.maximum(torch.abs(ratio_old), torch.ones((), device=dev))
        unstable = (torch.abs(s_new / w_new - ratio_old) > tol) & ~pad
        return (tuple(x.reshape(shape) for x in (s_new, w_new, term, conv)),
                unstable.sum().to(torch.int32))
    stable = torch.abs(s_new / w_new - s / w) <= delta_t
    t = torch.where(in_w > 0, torch.where(stable, term + 1, 0), term).to(torch.int32)
    c = torch.where(pad, 0, (conv != 0) | (t >= term_rounds)).to(torch.int32)
    return (tuple(x.reshape(shape) for x in (s_new, w_new, t, c)),
            c.sum().to(torch.int32))


def gossip_absorb_plain(mark, own, offs, row_lo: int, *, spec,
                        rumor_target: int, suppress: bool):
    """The gossip absorb over one shard: ``mark`` the global int8 marks,
    ``own`` the shard's (count, active, conv); suppression receiver-side.
    Returns ((count', active', conv'), u)."""
    cnt, act, conv = (p.reshape(-1) for p in own)
    pad, inbox = gossip_inbox_plain(mark, offs, row_lo, own[0].shape[0], spec=spec)
    if suppress:
        inbox = torch.where(conv != 0, 0, inbox)
    cnt = (cnt + inbox).to(torch.int32)
    act = ((act != 0) | (inbox > 0)).to(torch.int32)
    c = ((cnt >= rumor_target) & ~pad).to(torch.int32)
    shape = own[0].shape
    return tuple(x.reshape(shape) for x in (cnt, act, c)), c.sum().to(torch.int32)


def imp_hbm_shards_round_plain(state, stream, rows_loc: int, row_los, *,
                               pushsum: bool, **kw) -> list:
    """One round of the shards at global rows ``row_los`` (each rows_loc
    rows) from the global state [R, 128] (push-sum (s, w, term, conv),
    gossip (count, active, conv)) and the round's ``stream`` (keys, offs,
    ckeys): every shard's marks, then these shards' absorbs. Returns, per
    shard, (its planes' rows, u)."""
    keys, offs, ckeys = stream
    R, dev = state[0].shape[0], state[0].device
    mark = torch.cat([shard_marks_plain(kw["spec"], keys, ckeys, len(offs), lo,
                                        min(rows_loc, R - lo),
                                        None if pushsum else state[1][lo:lo + rows_loc],
                                        dev)
                      for lo in range(0, R, rows_loc)])
    out = []
    for lo in row_los:
        if pushsum:
            own = tuple(p[lo:lo + rows_loc] for p in state[2:])
            out.append(pushsum_absorb_plain(mark, state[:2], own, offs, lo, **kw))
        else:
            own = tuple(p[lo:lo + rows_loc] for p in state)
            out.append(gossip_absorb_plain(mark, own, offs, lo, **kw))
    return out


def pushsum_imp_hbm_shard_round_plain(state, keys, offs, ckeys, row_lo: int,
                                      rows_loc: int, *, spec, delta: float,
                                      term_rounds: int, global_term: bool = False):
    """One push-sum round over the shard at global rows [row_lo, row_lo +
    rows_loc) from the global state (s, w, term, conv) [R, 128]: every
    shard's marks, then this shard's absorb (``pushsum_absorb_plain``).
    Returns (its (s, w, term, conv) rows, u)."""
    return imp_hbm_shards_round_plain(state, (keys, offs, ckeys), rows_loc, [row_lo],
                                      pushsum=True, spec=spec, delta=delta,
                                      term_rounds=term_rounds,
                                      global_term=global_term)[0]


def gossip_imp_hbm_shard_round_plain(state, keys, offs, ckeys, row_lo: int,
                                     rows_loc: int, *, spec, rumor_target: int,
                                     suppress: bool):
    """Gossip analog of ``pushsum_imp_hbm_shard_round_plain`` from the
    global (count, active, conv)."""
    return imp_hbm_shards_round_plain(state, (keys, offs, ckeys), rows_loc, [row_lo],
                                      pushsum=False, spec=spec, rumor_target=rumor_target,
                                      suppress=suppress)[0]


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels of csrc/fused_imp_hbm_shard.cu,
# CPU tensors run the plain versions; no fallback between the two. Each does
# nothing once ``ctrl[0]`` (the run's done flag, int32 [2] on the planes'
# device) is set. ``mark`` is a device's global int8 [R, 128] mark plane.
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "gossip_imp_hbm_shard_mark": [_P] * 3 + [_U] * 4 + [_I] * 5 + [_P, _I, _P],
    "gossip_pushsum_imp_hbm_shard_absorb":
        [_P] * 11 + [_U] * 4 + [_P, _I, _P] + [_I] * 4 + [_F, _I, _I] + [_P] * 3
        + [_I, _P],
    "gossip_gossip_imp_hbm_shard_absorb":
        [_P] * 9 + [_U] * 4 + [_P, _I, _P] + [_I] * 6 + [_P] * 3 + [_I, _P],
}


def _words(keys) -> tuple:
    k1, k2 = (int(k) for k in keys)
    if not (0 <= k1 <= 0xFFFFFFFF and 0 <= k2 <= 0xFFFFFFFF):
        raise ValueError("keys must be two uint32 words")
    return k1, k2


def _check_plane(x, dtype, shape, dev, what: str) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{what} must be {dtype} {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_spec(spec, pool_size: int, R: int) -> None:
    if spec.kind not in IMP_LATTICE or not 1 <= len(spec.classes) <= 6:
        raise ValueError(f"not an imp lattice the kernels take: {spec}")
    if pool_size not in fused_pool.POOL_SIZES:
        raise ValueError(f"pool_size {pool_size} not in {fused_pool.POOL_SIZES}")
    if not spec.n <= R * LANES < 2**31:
        raise ValueError(f"{R} rows do not hold n={spec.n} in int32 flat indices")


def _check_ctrl(ctrl, dev) -> None:
    if ctrl.device != dev or ctrl.dtype != torch.int32 or ctrl.numel() != 2:
        raise ValueError(f"ctrl must be int32 [2] on {dev}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _mark_args(mark, spec, keys, ckeys):
    """The C arguments naming the marks a launch writes: ``mark``'s plane,
    the device's directions words and the round's (key, choice key)."""
    words = fused_imp.imp_dir_words(spec, mark.shape[0], mark.device)
    return (mark.data_ptr(), words.data_ptr(), *_words(keys), *_words(ckeys))


def imp_hbm_shard_mark(mark, active, keys, ckeys, row_lo: int, rows: int, *,
                       spec, pool_size: int, ctrl) -> None:
    """The mark prologue: write the marks of global rows [row_lo, row_lo +
    rows) into ``mark`` (``shard_marks_plain``): ``active`` is those rows'
    gossip active plane, or None for push-sum (every real node sends);
    ``keys`` and ``ckeys`` the round's key and choice key."""
    dev, R = mark.device, mark.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shard rounds run on cpu or cuda tensors, got {dev}")
    _check_plane(mark, torch.int8, (R, LANES), dev, "mark")
    _check_spec(spec, pool_size, R)
    if not (0 <= row_lo and rows >= 1 and row_lo + rows <= R):
        raise ValueError(f"rows [{row_lo}, {row_lo + rows}) outside [0, {R})")
    if active is not None:
        _check_plane(active, torch.int32, (rows, LANES), dev, "active")
    _check_ctrl(ctrl, dev)
    if dev.type == "cpu":
        if not int(ctrl[0]):
            mark[row_lo:row_lo + rows] = shard_marks_plain(
                spec, _words(keys), _words(ckeys), pool_size, row_lo, rows, active, dev)
        return
    fn = kernels.entry("fused_imp_hbm_shard", "gossip_imp_hbm_shard_mark",
                       _SIGNATURES["gossip_imp_hbm_shard_mark"])
    m_ptr, w_ptr, *key_words = _mark_args(mark, spec, keys, ckeys)
    err = fn(m_ptr, None if active is None else active.data_ptr(), w_ptr, *key_words,
             len(spec.classes), spec.n, pool_size, row_lo, rows, ctrl.data_ptr(),
             dev.index, _stream(dev))
    if err:
        raise RuntimeError(f"imp_hbm_shard_mark: CUDA launch failed with cudaError_t {err}")
    imp_hbm_shard_mark.launches += 1


def _check_absorb(mark, next_mark, own_in, own_out, dtypes, offs, row_lo: int, spec,
                  u, acc, ctrl):
    dev, R = mark.device, mark.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shard rounds run on cpu or cuda tensors, got {dev}")
    _check_plane(mark, torch.int8, (R, LANES), dev, "mark")
    _check_plane(next_mark, torch.int8, (R, LANES), dev, "next mark")
    rows_loc = own_in[0].shape[0]
    for x, dt in zip(tuple(own_in) + tuple(own_out), dtypes * 2):
        _check_plane(x, dt, (rows_loc, LANES), dev, "shard plane")
    _check_spec(spec, len(offs), R)
    if not 0 <= row_lo <= R - rows_loc:
        raise ValueError(f"rows [{row_lo}, {row_lo + rows_loc}) outside [0, {R})")
    if not all(1 <= int(d) <= spec.n - 1 for d in offs):
        raise ValueError(f"offs must lie in [1, {spec.n - 1}]")
    for x, size in ((u, 1), (acc, 2)):
        if x.device != dev or x.dtype != torch.int32 or x.numel() != size:
            raise ValueError(f"u and acc must be int32 [1] and [2] on {dev}")
    _check_ctrl(ctrl, dev)
    return dev, rows_loc


def _absorb_args(spec, offs, row_lo: int, rows_loc: int):
    classes = (ctypes.c_int * len(spec.classes))(*spec.classes)
    pool = (ctypes.c_int * len(offs))(*[int(d) for d in offs])
    return classes, len(spec.classes), pool, len(offs), spec.n, row_lo, rows_loc


def pushsum_imp_hbm_shard_absorb(mark, next_mark, nxt, glob_in, glob_out, own_in,
                                 own_out, offs, row_lo: int, *, spec, delta: float,
                                 term_rounds: int, u, acc, ctrl,
                                 global_term: bool = False) -> None:
    """The push-sum absorb over the shard at global rows [row_lo, row_lo +
    rows_loc) (``pushsum_absorb_plain``): reads ``mark`` and the global
    (s, w) ``glob_in``, writes the shard's rows of ``glob_out``, its
    (term, conv) ``own_out`` from ``own_in``, its converged count to ``u``
    (int32 [1]; ``acc`` is the shard's zeroed int32 [2] scratch) and its
    rows' marks of the next round into ``next_mark`` (``nxt`` that round's
    key and choice key)."""
    f32, i32 = torch.float32, torch.int32
    dev, rows_loc = _check_absorb(mark, next_mark, own_in, own_out, (i32, i32), offs,
                                  row_lo, spec, u, acc, ctrl)
    for x in tuple(glob_in) + tuple(glob_out):
        _check_plane(x, f32, tuple(mark.shape), dev, "global s/w plane")
    if dev.type == "cpu":
        if not int(ctrl[0]):
            planes, count = pushsum_absorb_plain(mark, glob_in, own_in, offs, row_lo,
                                                 spec=spec, delta=delta,
                                                 term_rounds=term_rounds,
                                                 global_term=global_term)
            glob_out[0][row_lo:row_lo + rows_loc] = planes[0]
            glob_out[1][row_lo:row_lo + rows_loc] = planes[1]
            own_out[0].copy_(planes[2])
            own_out[1].copy_(planes[3])
            u[0] = count
            next_mark[row_lo:row_lo + rows_loc] = shard_marks_plain(
                spec, _words(nxt[0]), _words(nxt[1]), len(offs), row_lo, rows_loc,
                device=dev)
        return
    fn = kernels.entry("fused_imp_hbm_shard", "gossip_pushsum_imp_hbm_shard_absorb",
                       _SIGNATURES["gossip_pushsum_imp_hbm_shard_absorb"])
    ptrs = [x.data_ptr() for x in (*glob_in, *glob_out, *own_in, *own_out, mark)]
    err = fn(*ptrs, *_mark_args(next_mark, spec, *nxt),
             *_absorb_args(spec, offs, row_lo, rows_loc), ctypes.c_float(delta),
             term_rounds, int(global_term), u.data_ptr(), acc.data_ptr(),
             ctrl.data_ptr(), dev.index, _stream(dev))
    if err:
        raise RuntimeError(f"pushsum_imp_hbm_shard_absorb: CUDA launch failed with "
                           f"cudaError_t {err}")
    pushsum_imp_hbm_shard_absorb.launches += 1


def gossip_imp_hbm_shard_absorb(mark, next_mark, nxt, own_in, own_out, offs,
                                row_lo: int, *, spec, rumor_target: int, suppress: bool,
                                u, acc, ctrl) -> None:
    """Gossip analog of ``pushsum_imp_hbm_shard_absorb``: the shard's
    (count, active, conv) from ``own_in`` into ``own_out``
    (``gossip_absorb_plain``), the next marks from the new active flags."""
    dev, rows_loc = _check_absorb(mark, next_mark, own_in, own_out, (torch.int32,) * 3,
                                  offs, row_lo, spec, u, acc, ctrl)
    if dev.type == "cpu":
        if not int(ctrl[0]):
            planes, count = gossip_absorb_plain(mark, own_in, offs, row_lo, spec=spec,
                                                rumor_target=rumor_target,
                                                suppress=suppress)
            for o, x in zip(own_out, planes):
                o.copy_(x)
            u[0] = count
            next_mark[row_lo:row_lo + rows_loc] = shard_marks_plain(
                spec, _words(nxt[0]), _words(nxt[1]), len(offs), row_lo, rows_loc,
                planes[1], dev)
        return
    fn = kernels.entry("fused_imp_hbm_shard", "gossip_gossip_imp_hbm_shard_absorb",
                       _SIGNATURES["gossip_gossip_imp_hbm_shard_absorb"])
    ptrs = [x.data_ptr() for x in (*own_in, *own_out, mark)]
    err = fn(*ptrs, *_mark_args(next_mark, spec, *nxt),
             *_absorb_args(spec, offs, row_lo, rows_loc), rumor_target, int(suppress),
             u.data_ptr(), acc.data_ptr(), ctrl.data_ptr(), dev.index, _stream(dev))
    if err:
        raise RuntimeError(f"gossip_imp_hbm_shard_absorb: CUDA launch failed with "
                           f"cudaError_t {err}")
    gossip_imp_hbm_shard_absorb.launches += 1


# Kernel launches queued by each wrapper (the prologue: one a shard where a
# run starts or resumes; an absorb: one a shard a round), counted where the
# kernel is launched and nowhere else.
imp_hbm_shard_mark.launches = 0
pushsum_imp_hbm_shard_absorb.launches = 0
gossip_imp_hbm_shard_absorb.launches = 0


class ShardRound(NamedTuple):
    """One shard's operands in one round: its global rows from ``row_lo``,
    its device's global mark planes of this round (``mark``, read) and of
    the next (``next``, written), push-sum's global (s, w) planes in and
    out (``()`` for gossip), its own planes in and out (``own_out`` None:
    the shard is only marked), and its u, acc and ctrl."""
    row_lo: int
    mark: torch.Tensor
    next: torch.Tensor
    glob_in: tuple
    glob_out: tuple
    own_in: tuple
    own_out: Optional[tuple]
    u: torch.Tensor
    acc: torch.Tensor
    ctrl: torch.Tensor


def mark_shards(shards, keys, ckeys, rows_loc: int, *, pushsum: bool, spec,
                pool_size: int) -> None:
    """The mark prologue of a round over ``shards`` (ShardRound each): every
    shard's rows of its ``mark`` plane under the round's key and choice
    key, from its own planes' active flags (gossip)."""
    for sh in shards:
        imp_hbm_shard_mark(sh.mark, None if pushsum else sh.own_in[1], keys, ckeys,
                           sh.row_lo, rows_loc, spec=spec, pool_size=pool_size,
                           ctrl=sh.ctrl)


def launch_shard_rounds(shards, stream, nxt, *, pushsum: bool, kw: dict,
                        wire=()) -> None:
    """Queue one round over ``shards`` (ShardRound each) with the round's
    ``stream`` (keys, offs, ckeys): the ``wire`` (parallel/halo.replica_rows'
    groups), then the absorb launch of every shard with its output planes,
    which writes the shard's marks of the next round, whose (keys, ckeys)
    are ``nxt``. ``kw`` is the absorb's keywords, ``spec`` among them."""
    _keys, offs, _ckeys = stream
    halo.exchange_rows_batched(wire)
    for sh in shards:
        if sh.own_out is None:
            continue
        if pushsum:
            pushsum_imp_hbm_shard_absorb(sh.mark, sh.next, nxt, sh.glob_in, sh.glob_out,
                                         sh.own_in, sh.own_out, offs, sh.row_lo, **kw,
                                         u=sh.u, acc=sh.acc, ctrl=sh.ctrl)
        else:
            gossip_imp_hbm_shard_absorb(sh.mark, sh.next, nxt, sh.own_in, sh.own_out,
                                        offs, sh.row_lo, **kw, u=sh.u, acc=sh.acc,
                                        ctrl=sh.ctrl)


def absorb_kw(topo: Topology, cfg: SimConfig) -> dict:
    """The absorb wrappers' keywords of a config."""
    spec = fused_imp.imp_spec(topo)
    if cfg.algorithm == "push-sum":
        return {"spec": spec, "delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds,
                "global_term": cfg.termination == "global"}
    return {"spec": spec, "rumor_target": cfg.resolved_rumor_target,
            "suppress": cfg.resolved_suppress}


# ---------------------------------------------------------------------------
# The JAX factories' functional form: one round of one shard from the
# global state, for the tests and the card's checks.
# ---------------------------------------------------------------------------


def _shard_chunk(state, stream, row0: int, rows_loc: int, *, pushsum: bool, kw: dict):
    """One round of the shard at ``row0`` from the global ``state`` on one
    device, queued as a run that starts at this round queues it (every
    shard's mark prologue, then this shard's absorb, whose next-round marks
    are drawn here from this round's keys and dropped). Returns (its
    planes, u)."""
    dev, R = state[0].device, state[0].shape[0]
    n_glob = 2 if pushsum else 0
    glob_in = tuple(state[:n_glob])
    glob_out = tuple(torch.empty_like(x) for x in glob_in)
    own_out = tuple(torch.empty_like(p[row0:row0 + rows_loc]) for p in state[n_glob:])
    mark, nxt_mark = torch.empty(2, R, LANES, dtype=torch.int8, device=dev).unbind(0)
    u, acc, ctrl = (torch.zeros(k, dtype=torch.int32, device=dev) for k in (1, 2, 2))
    shards = [ShardRound(lo, mark, nxt_mark, glob_in, glob_out,
                         tuple(p[lo:lo + rows_loc] for p in state[n_glob:]),
                         own_out if lo == row0 else None, u, acc, ctrl)
              for lo in range(0, R, rows_loc)]
    keys, offs, ckeys = stream
    mark_shards(shards, keys, ckeys, rows_loc, pushsum=pushsum, spec=kw["spec"],
                pool_size=len(offs))
    launch_shard_rounds(shards, stream, (keys, ckeys), pushsum=pushsum, kw=kw)
    return tuple(p[row0:row0 + rows_loc] for p in glob_out) + own_out, u[0]


def make_pushsum_imp_hbm_shard_chunk(topo: Topology, cfg: SimConfig, H: int,
                                     rows_loc: int, PT: int, layout):
    """``chunk_fn(state4, keys, offs, ckeys, row0) -> (mid_state4, u)``: one
    push-sum round over the shard at global row ``row0`` from the global
    (s, w, term, conv) [R, 128] planes (the JAX factory's contract, whose
    halo-extended and gathered planes are here the global ones; H, PT and
    layout are the plan's and change nothing)."""
    del H, PT, layout
    kw = absorb_kw(topo, cfg)

    def chunk_fn(state4, keys, offs, ckeys, row0):
        return _shard_chunk(state4, (keys, offs, ckeys), row0, rows_loc, pushsum=True,
                            kw=kw)

    return chunk_fn


def make_gossip_imp_hbm_shard_chunk(topo: Topology, cfg: SimConfig, H: int,
                                    rows_loc: int, PT: int, layout):
    """Gossip analog of ``make_pushsum_imp_hbm_shard_chunk``:
    ``chunk_fn(state3, keys, offs, ckeys, row0)`` from the global (count,
    active, conv)."""
    del H, PT, layout
    kw = absorb_kw(topo, cfg)

    def chunk_fn(state3, keys, offs, ckeys, row0):
        return _shard_chunk(state3, (keys, offs, ckeys), row0, rows_loc, pushsum=False,
                            kw=kw)

    return chunk_fn


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def run_imp_hbm_sharded(topo: Topology, cfg: SimConfig, mesh: mesh_mod.Mesh, key,
                        start_state=None, start_round: int = 0,
                        t_enter: Optional[float] = None, on_chunk=None):
    """Sharded imp run (engine='fused', n_devices > 1, imp2d/imp3d with
    delivery='pool'), to convergence or cfg.max_rounds; returns the
    RunResult, its state the canonical [n] planes joined from the shards.

    Each distinct device holds one global plane set in ping/pong form
    (push-sum s and w), two mark planes by round parity and the directions
    words; a shard's s and w rows are a slice of its device's set, its
    other planes its own ping/pong pair. Round r reads set r % 2 and mark
    plane r % 2 and writes the other two, never its inputs, so a deferred
    verdict that fires rolls the next round back by the round counter
    alone. The run's control block (pool2_sharded.ShardControl) lives on
    shard 0's device, and pool2_sharded.run_round_supersteps runs the
    rounds, as it does for the replicated-pool2 composition, drawing each
    chunk's streams one round ahead for the next marks and queueing the
    mark prologue of ``start_round`` before the first. Under global
    termination (push-sum) each shard's u is its unstable count, the
    verdict fires when they sum to 0, and the run's result then has conv
    latched on every real node."""
    from ..models import gossip as gossip_mod
    from ..models import pushsum as pushsum_mod
    from ..models.runner import _host_done
    from .fused_sharded import _start_mid
    from .pool2_sharded import ShardControl, run_round_supersteps

    t_enter = time.perf_counter() if t_enter is None else t_enter
    S = mesh.size
    plan = plan_imp_hbm_sharded(topo, cfg, S)
    if isinstance(plan, str):
        raise ValueError(f"engine='fused' with n_devices={S} unavailable: {plan}")
    _H, rows_loc, _PT, layout = plan
    n, R, P = topo.n, layout.rows, cfg.pool_size
    pushsum = cfg.algorithm == "push-sum"
    global_term = pushsum and cfg.termination == "global"
    target = cfg.resolved_target_count(n, topo.target_count)
    devices, home = mesh.devices, mesh.devices[0]
    row_lo = [s * rows_loc for s in range(S)]

    start = _start_mid(topo, cfg, key, mesh, rows_loc, layout, start_state)
    done0 = start_state is not None and _host_done(start_state, target)
    par0 = start_round % 2
    # Per distinct device: its mark planes, [par] -> plane, and, for
    # push-sum, its global (s, w) ping/pong pair, [par] -> (s, w); and the
    # kernels' directions words, built here so their time counts as set-up.
    distinct = dict.fromkeys(devices)
    marks = {dev: torch.empty(2, R, LANES, dtype=torch.int8, device=dev).unbind(0)
             for dev in distinct}
    kw = absorb_kw(topo, cfg)
    for dev in distinct:
        if dev.type == "cuda":
            fused_imp.imp_dir_words(kw["spec"], R, dev)
    glob = {dev: [tuple(torch.empty(R, LANES, dtype=torch.float32, device=dev)
                        for _ in range(2)) for _ in range(2)]
            for dev in distinct} if pushsum else {dev: [(), ()] for dev in distinct}
    # Per shard its own planes, [par] -> planes: push-sum (term, conv),
    # gossip (count, active, conv).
    own = []
    for s, dev in enumerate(devices):
        planes = start[s][2:] if pushsum else start[s]
        pair = [None, None]
        pair[par0] = planes
        pair[1 - par0] = tuple(torch.empty_like(x) for x in planes)
        own.append(pair)
        for x, p in zip(glob[dev][par0], start[s][:2] if pushsum else ()):
            x[row_lo[s]:row_lo[s] + rows_loc].copy_(p)
    del start
    ctl = ShardControl(devices, done0, start_round)
    # Per round parity: every shard's operands, and the wire (each shard's
    # rows of its device's planes into every other device's copy).
    shards_of = [[ShardRound(row_lo[s], marks[dev][par], marks[dev][1 - par],
                             glob[dev][par], glob[dev][1 - par], own[s][par],
                             own[s][1 - par], **ctl.args(s, par))
                  for s, dev in enumerate(devices)] for par in (0, 1)]
    # The wire of round r carries the marks of its parity, which round
    # r - 1 (or the prologue) wrote.
    wires = [halo.replica_rows({dev: (marks[dev][par],) + glob[dev][par] for dev in marks},
                               rows_loc, devices) for par in (0, 1)]

    def draw(begin, count):
        return list(zip(fused.round_keys(key, begin, count).tolist(),
                        fused_pool.round_offsets(key, begin, count, P, n).tolist(),
                        fused_imp.choice_round_keys(key, begin, count).tolist()))

    def prologue():
        keys, _offs, ckeys = draw(start_round, 1)[0]
        mark_shards(shards_of[par0], keys, ckeys, rows_loc, pushsum=pushsum,
                    spec=kw["spec"], pool_size=P)

    def launch_round(r, stream, nxt):
        launch_shard_rounds(shards_of[r % 2], stream, (nxt[0], nxt[2]), pushsum=pushsum,
                            kw=kw, wire=wires[r % 2])

    def final_state(par, done):
        def joined(planes_of):
            return torch.cat([planes_of(s).to(home) for s in range(S)]).reshape(-1)[:n]

        if pushsum:
            conv = joined(lambda s: own[s][par][1]) != 0
            if global_term and done:
                # The global verdict latches conv on every real node.
                conv = torch.ones_like(conv)
            return pushsum_mod.PushSumState(
                s=joined(lambda s: glob[devices[s]][par][0][row_lo[s]:row_lo[s] + rows_loc]),
                w=joined(lambda s: glob[devices[s]][par][1][row_lo[s]:row_lo[s] + rows_loc]),
                term=joined(lambda s: own[s][par][0]), conv=conv)
        return gossip_mod.GossipState(
            count=joined(lambda s: own[s][par][0]),
            active=joined(lambda s: own[s][par][1]) != 0,
            conv=joined(lambda s: own[s][par][2]) != 0)

    return run_round_supersteps(topo, cfg, ctl, start_round=start_round, target=target,
                                t_enter=t_enter, library="fused_imp_hbm_shard", draw=draw,
                                launch_round=launch_round, final_state=final_state,
                                ahead=1, prologue=prologue, global_term=global_term,
                                on_chunk=on_chunk)
