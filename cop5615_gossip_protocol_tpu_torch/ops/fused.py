"""Helpers shared by the fused chunk engines, as plain torch functions, and
the whole-array stencil tier of the JAX package's ops/fused.py
(make_pushsum_chunk, make_gossip_chunk): its support predicate, its layout
and its chunk wrappers.

The CUDA kernels compute the same things on the device: the Threefry hash
in csrc/threefry.cuh, the done flag, the round cap and the class-keyed
delivery and absorb (``pushsum_class_rounds``, ``gossip_class_rounds``)
inside csrc/fused_pool.cu, csrc/fused_pool2.cu, csrc/fused_stencil.cu,
csrc/fused_resident.cu and csrc/fused_imp.cu. The whole-array tier's
wrappers (``pushsum_chunk``, ``gossip_chunk``) run csrc/fused_resident.cu,
the kernel pair it shares with the tiled tier (ops/fused_stencil.py), on
CUDA tensors and the lattice tiers' plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..models.pushsum import flush, halve_and_send
from . import rng, telemetry
from .faults import lie, override
from .topology import Topology

LANES = 128
# The JAX whole-array stencil tier's population cap (its VMEM budget).
MAX_FUSED_NODES = 131_072


def _has_wrap_edges(topo: Topology) -> bool:
    """True if any live edge's raw displacement (j - i) differs from its
    signed modular displacement, i.e. the edge wraps the index space."""
    cols = np.arange(topo.max_deg)[None, :]
    live = cols < topo.degree[:, None]
    ids = np.arange(topo.n, dtype=np.int64)[:, None]
    raw = (topo.neighbors.astype(np.int64) - ids)[live]
    mod = raw % topo.n
    signed = np.where(mod <= topo.n // 2, mod, mod - topo.n)
    return bool((raw != signed).any())


def fused_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the JAX package's whole-array stencil tier would run this
    config, else the reason not (its predicate, ops/fused.py; the port's
    configs are float32 by construction, and its drop and crash models run
    in the JAX tier)."""
    if topo.implicit:
        return "implicit (full) topology has no displacement structure"
    if topo.offsets is None:
        return f"topology {topo.kind!r} has no small displacement set"
    if cfg.dup_rate > 0 or cfg.delay_rounds > 0:
        # Duplicate delivery and the delay ring restructure delivery
        # itself: the config runs on the chunked engine.
        return "dup/delay fault models run on the chunked engine only"
    if topo.n > MAX_FUSED_NODES:
        return f"population {topo.n} exceeds VMEM-resident limit {MAX_FUSED_NODES}"
    if topo.n % LANES != 0 and _has_wrap_edges(topo):
        return (
            "wraparound topology needs population divisible by 128 "
            f"(n={topo.n}); rolls in the padded layout would misdeliver"
        )
    return None


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """The whole-array tier's padded [rows, 128] layout."""

    n: int
    n_pad: int
    rows: int


def build_layout(n: int) -> FusedLayout:
    """n rounded up to whole 128-lane rows, as the JAX tier lays it out.
    Pad lanes never send and never receive."""
    rows = -(-n // LANES)
    return FusedLayout(n=n, n_pad=rows * LANES, rows=rows)


def pushsum_chunk(state4, keys, start: int, cap: int, *, spec, target: int,
                  delta: float, term_rounds: int,
                  faults: Optional[Faults] = None, telemetry: bool = False):
    """Up to K = keys.shape[0] push-sum lattice rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged, on
    (s, w, term, conv_i32) in the ``build_layout`` layout; the contract of
    fused_stencil.pushsum_stencil2_chunk (``spec`` a
    fused_stencil_hbm.StencilSpec). ``faults`` (the run's ``Faults``, None
    for a fault-free run with local termination) adds the drop gate,
    crash-stop with the quorum verdict and global termination;
    ``telemetry`` runs the telemetry instance and returns the chunk's rows
    too (fused_pool.pushsum_pool_chunk's contract)."""
    # Imported here: ops/fused_stencil imports this module.
    from .fused_stencil import pushsum_resident_chunk

    return pushsum_resident_chunk(
        pushsum_chunk, build_layout(spec.n).rows, state4, keys, start, cap,
        spec=spec, target=target, delta=delta, term_rounds=term_rounds,
        faults=faults, telemetry=telemetry)


def gossip_chunk(state3, keys, start: int, cap: int, *, spec, target: int,
                 rumor_target: int, suppress: bool,
                 faults: Optional[Faults] = None, telemetry: bool = False):
    """Gossip analog of ``pushsum_chunk``: ``state3`` is (count,
    active_i32, conv_i32); converged-target suppression is receiver-side;
    ``faults`` adds the drop gate and crash-stop."""
    from .fused_stencil import gossip_resident_chunk

    return gossip_resident_chunk(
        gossip_chunk, build_layout(spec.n).rows, state3, keys, start, cap,
        spec=spec, target=target, rumor_target=rumor_target, suppress=suppress,
        faults=faults, telemetry=telemetry)


# Kernel launches queued by each wrapper (3 a chunk, 4 with telemetry),
# counted where the kernel is launched and nowhere else.
pushsum_chunk.launches = 0
gossip_chunk.launches = 0


def threefry2x32_hash(k1, k2, i):
    """Threefry-2x32 of counter ``i`` (high counter word 0) under key
    (k1, k2), xor-folded: the partitionable-stream word at position i."""
    a, b = rng.threefry2x32(k1, k2, 0, i)
    return a ^ b


def threefry_bits_2d(k1, k2, rows: int, cols: int, row0=0, device=None):
    """int64 ``[rows, cols]`` uint32 words equal to rows [row0, row0+rows)
    of ``jax.random.bits(key, ((row0+rows)*cols,))`` reshaped."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return threefry2x32_hash(k1, k2, ((r + row0) * cols + c) & rng.MASK)


def round_keys(base_key, start: int, count: int) -> torch.Tensor:
    """int64 ``[count, 2]`` fold_in keys for absolute rounds
    start..start+count (the stream sampling.round_key draws)."""
    k1, k2 = int(base_key[0]), int(base_key[1])
    rounds = (start + torch.arange(count, dtype=torch.int64)) & rng.MASK
    a, b = rng.threefry2x32(k1, k2, 0, rounds)
    return torch.stack([a, b], dim=1)


def clamp_cap_and_pad(start: int, cap: int, keys, extras=()):
    """Clamp the round cap to the rounds that have real keys, then pad the
    per-round streams to 8-round blocks (the TPU kernels' SMEM blocks).
    Padded rounds never run, because the cap stops short of them.
    ``extras`` is a tuple of (tensor, fill) pairs padded alongside the keys.
    Returns (cap, keys, *extras)."""
    cap = min(int(cap), int(start) + keys.shape[0])
    pad = -keys.shape[0] % 8
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, 2))])
        padded = tuple(
            torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
            for a, fill in extras
        )
    else:
        padded = tuple(a for a, _ in extras)
    return (cap, keys) + padded


def _pad2d(x: torch.Tensor, layout, fill) -> torch.Tensor:
    """[n] -> [rows, 128]: pad the tail with ``fill`` and fold into lanes."""
    pad = layout.n_pad - layout.n
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x.reshape(layout.rows, LANES)


def make_done_flag(target: int, needs=None, need_init=None):
    """Termination verdict: ``done_flag(total, k)`` is True once the
    converged count ``total`` reaches the target. The quorum form (a crash
    model: ``needs`` the int32 [K] quorum needs of the chunk's rounds,
    ``need_init`` the seed need at the round before them,
    faults.quorum_needs) takes ``total`` as the converged live count and
    compares it with round k's need, or with the seed need for k = -1."""

    def done_flag(total, k: int = -1) -> bool:
        if needs is None:
            return bool(total >= target)
        return bool(total >= (need_init if k < 0 else int(needs[k])))

    return done_flag


def gate_round_keys(keys: torch.Tensor) -> torch.Tensor:
    """int64 ``[K, 2]`` drop-gate keys of the chunk's round keys: each
    round key folded with sampling.GATE_TAG, the stream send_gate draws, so
    a kernel's gate words are the chunked engine's word for word."""
    from .sampling import GATE_TAG

    # In numpy: a chunk's few dozen keys cost microseconds there, where
    # torch's per-op overhead would cost the wrapper a millisecond.
    words = keys.numpy()
    a, b = rng.threefry2x32(words[:, 0], words[:, 1], 0, GATE_TAG)
    return torch.from_numpy(np.stack([a, b], axis=1))


def build_death2d(cfg: SimConfig, n: int, n_pad: int) -> Optional[torch.Tensor]:
    """int32 ``[n_pad // 128, 128]`` death plane of a padded layout, or None
    without a crash model. Pad lanes die at round 0, so they count as dead
    from the start and alive counts over the layout are the population's."""
    from . import faults

    death = faults.death_plane(cfg, n)
    if death is None:
        return None
    return torch.from_numpy(
        faults.pad_death_plane(death, n_pad).reshape(n_pad // LANES, LANES).copy())


# The Byzantine modes as the kernels take them (csrc/faults.cuh).
BYZ_MODES = {"mass_inflate": 1, "mass_deflate": 2, "garble": 3,
             "stale_rumor": 4}


class ChunkFaults(NamedTuple):
    """One chunk's fault inputs (``Faults.for_chunk``): the gate threshold
    and the gate keys of its rounds (None without a gate), the death plane
    over the padded layout, flat int32 [n_pad] on the state's device, the
    quorum needs of its rounds and the seed need (None without a crash
    model), whether push-sum terminates globally, under a recovery
    model the revival plane over the layout (pad lanes NEVER; else None),
    whether a revived node's state resets (``reset``: gossip always,
    push-sum under rejoin="fresh") and push-sum's initial term, and under a
    Byzantine model the onset plane over the layout (pad lanes NEVER; else
    None) and the mode."""

    thresh: Optional[int]
    gate_keys: Optional[torch.Tensor]
    death: Optional[torch.Tensor]
    needs: Optional[torch.Tensor]
    need_init: Optional[int]
    global_term: bool
    revive: Optional[torch.Tensor] = None
    reset: bool = False
    init_term: int = 0
    byz: Optional[torch.Tensor] = None
    byz_mode: str = ""

    def lying_flat(self, r: int):
        """Flat [n_pad] mask of the adversaries of absolute round r, or None
        without a Byzantine model."""
        return None if self.byz is None else self.byz <= r

    def alive_flat(self, r: int):
        """Flat [n_pad] alive mask of absolute round r (dead exactly during
        death <= r < revive), or None without a crash model."""
        if self.death is None:
            return None
        alive = self.death > r
        return alive if self.revive is None else alive | (self.revive <= r)

    def blocked(self, mark, start: int, k: int, rows: int):
        """Round k's marks with the gate and the dead folded in: -1 where
        the node's gate word is below the threshold or it is dead."""
        if self.thresh is not None:
            g = threefry_bits_2d(self.gate_keys[k, 0], self.gate_keys[k, 1],
                                 rows, LANES, device=mark.device).reshape(-1)
            mark = torch.where(g < self.thresh, -1, mark)
        if self.death is not None:
            mark = torch.where(self.alive_flat(start + k), mark, -1)
        return mark

    def alive(self, r: int, rows: int):
        """[rows, 128] alive mask of absolute round r, or None."""
        alive = self.alive_flat(r)
        return None if alive is None else alive.reshape(rows, LANES)

    def live_total(self, c, r: int, rows: int) -> int:
        """The done flag's count after round r: conv among live nodes
        under a crash model, all conv otherwise."""
        alive = self.alive(r, rows)
        return int(c.sum()) if alive is None else int(((c != 0) & alive).sum())

    def rejoin(self, planes, r: int):
        """The padded planes at the start of absolute round r's body: the
        nodes that revive in round r reset where ``reset`` holds
        (faults.rejoin)."""
        if self.revive is None:
            return planes
        from . import faults

        rn = (self.revive == r).reshape(planes[0].shape)
        return faults.rejoin(planes, rn, self.reset, self.init_term)


@dataclasses.dataclass
class Faults:
    """The drop gate, crash-stop with quorum, crash-recovery and global
    termination of one run, as the chunk wrappers take them: ``thresh`` the
    gate threshold (None without a gate), ``death`` the int32 [n] death
    plane and ``death_sorted`` it sorted (None without a crash model),
    whether push-sum terminates globally, ``revive`` the int32 [n] revival
    plane and ``revive_sorted`` it sorted (None without a recovery model),
    whether a revived node resets (``reset``) and push-sum's initial
    term; under a Byzantine model ``byz`` the int32 [n] onset plane and
    ``byz_mode`` its mode; whether push-sum clips its inboxes
    (``robust_agg="clip"``) and the health sentinel's ``mass_tolerance``
    (None: off), which only the scatter round's plain version carries;
    the dup gate's threshold (``dup_thresh``, None without one) and the
    delay ring's depth (``delay``, 0 without one), which only the scatter
    round carries among the chunks (the fused plans refuse both)."""

    thresh: Optional[int]
    death: Optional[np.ndarray]
    death_sorted: Optional[np.ndarray]
    quorum: float
    global_term: bool
    revive: Optional[np.ndarray] = None
    revive_sorted: Optional[np.ndarray] = None
    reset: bool = False
    init_term: int = 0
    byz: Optional[np.ndarray] = None
    byz_mode: str = ""
    clip: bool = False
    mass_tolerance: Optional[float] = None
    dup_thresh: Optional[int] = None
    delay: int = 0
    planes: dict = dataclasses.field(default_factory=dict)

    def gate_keys(self, keys: torch.Tensor) -> Optional[torch.Tensor]:
        return None if self.thresh is None else gate_round_keys(keys)

    def needs(self, start: int, count: int):
        """(int32 [count] needs of rounds start.., the seed need), or
        (None, None) without a crash model."""
        if self.death is None:
            return None, None
        from . import faults

        needs, need_init = faults.quorum_needs(
            self.death_sorted, self.death.shape[0], start, count, self.quorum,
            self.revive_sorted)
        return torch.from_numpy(needs.astype(np.int32)), need_init

    def death_flat(self, n_pad: int, device) -> Optional[torch.Tensor]:
        """The death plane padded to n_pad (pad lanes dead at round 0),
        int32 [n_pad] on ``device``, made once a size and device."""
        if self.death is None:
            return None
        from . import faults

        key = (n_pad, str(device))
        if key not in self.planes:
            self.planes[key] = torch.from_numpy(
                faults.pad_death_plane(self.death, n_pad).copy()).to(device)
        return self.planes[key]

    def revive_flat(self, n_pad: int, device) -> Optional[torch.Tensor]:
        """The revival plane padded to n_pad (pad lanes NEVER), int32
        [n_pad] on ``device``, made once a size and device; None without a
        recovery model."""
        if self.revive is None:
            return None
        from . import faults

        key = ("revive", n_pad, str(device))
        if key not in self.planes:
            self.planes[key] = torch.from_numpy(
                faults.pad_revival_plane(self.revive, n_pad).copy()).to(device)
        return self.planes[key]

    def byz_flat(self, n_pad: int, device) -> Optional[torch.Tensor]:
        """The Byzantine onset plane padded to n_pad (pad lanes NEVER),
        int32 [n_pad] on ``device``, made once a size and device; None
        without a Byzantine model."""
        if self.byz is None:
            return None
        from . import faults

        key = ("byz", n_pad, str(device))
        if key not in self.planes:
            self.planes[key] = torch.from_numpy(
                faults.pad_byzantine_plane(self.byz, n_pad).copy()).to(device)
        return self.planes[key]

    def byz_args(self, n_pad: Optional[int], device) -> list:
        """The Byzantine arguments of the entry points that carry them
        (kernel A, the pool kernels, the whole-array lattice kernels): the
        onset plane over n_pad (the population where None) on ``device``
        (None without a Byzantine model) and the mode (BYZ_MODES, 0 for
        none)."""
        if self.byz is None:
            return [None, 0]
        plane = self.byz_flat(self.byz.shape[0] if n_pad is None else n_pad, device)
        return [plane.data_ptr(), BYZ_MODES[self.byz_mode]]

    def revive_args(self, n_pad: int, device) -> list:
        """The recovery arguments of the entry points that carry it (kernel
        A, the pool kernels, the whole-array lattice kernels): the revival
        plane over n_pad on ``device`` (None without a recovery model),
        whether a revived node resets, push-sum's initial term."""
        revive = self.revive_flat(n_pad, device)
        return [None if revive is None else revive.data_ptr(), int(self.reset),
                self.init_term]

    def for_chunk(self, keys, start: int, n_pad: int, device) -> ChunkFaults:
        """The ``ChunkFaults`` of a chunk of keys.shape[0] rounds from
        ``start`` on an n_pad layout."""
        needs, need_init = self.needs(start, keys.shape[0])
        return ChunkFaults(self.thresh, self.gate_keys(keys),
                           self.death_flat(n_pad, device), needs, need_init,
                           self.global_term, self.revive_flat(n_pad, device),
                           self.reset, self.init_term,
                           self.byz_flat(n_pad, device), self.byz_mode)


def run_faults(cfg: SimConfig, n: int) -> Optional[Faults]:
    """The run's ``Faults``, or None for a fault-free run with local
    termination and no Byzantine model, robust aggregation, health
    sentinel, dup gate or delay ring (the chunks' fault-free form)."""
    from . import faults, sampling

    gate = cfg.fault_rate > 0
    if not (gate or cfg.crash_model or cfg.termination == "global"
            or cfg.byzantine_model or cfg.robust_agg != "none"
            or cfg.mass_tolerance is not None or cfg.dup_rate > 0
            or cfg.delay_rounds > 0):
        return None
    return Faults(
        thresh=sampling.gate_threshold(cfg.fault_rate) if gate else None,
        death=faults.death_plane(cfg, n),
        death_sorted=faults.sorted_death(cfg, n),
        quorum=cfg.quorum,
        global_term=cfg.termination == "global",
        revive=faults.revival_plane(cfg, n),
        revive_sorted=faults.sorted_revival(cfg, n),
        reset=cfg.algorithm == "gossip" or cfg.rejoin == "fresh",
        init_term=cfg.initial_term_round,
        byz=faults.byzantine_plane(cfg, n),
        byz_mode=cfg.byzantine_mode if cfg.byzantine_model else "",
        clip=cfg.robust_agg == "clip",
        mass_tolerance=cfg.mass_tolerance,
        dup_thresh=(sampling.gate_threshold(cfg.dup_rate) if cfg.dup_rate > 0
                    else None),
        delay=cfg.delay_rounds,
    )


@dataclasses.dataclass
class RowSpec:
    """What a fused kernel's telemetry instance (rows 1-2: csrc/fused_pool.cu,
    rows 5-6: csrc/fused_resident.cu) writes after each round, for its
    plain version: the kernel's float order over the padded plane
    (telemetry.pool_order or strided_order over its grid) and the form of
    its estimate error, "pool" (w = 0 read as 1, the JAX pool kernel's
    w_safe) or "stencil" (s / w, the JAX stencil kernel's)."""

    order: object  # telemetry.KernelOrder
    err: str

    @classmethod
    def for_layout(cls, kind: str, n_pad: int, grid: Optional[int] = None):
        """The spec of a pool or stencil chunk on an n_pad layout; ``grid``
        the kernel's blocks (telemetry_grid on the card), else the blocks
        its nodes would need."""
        work = n_pad // 8 if kind == "pool" else n_pad
        grid = grid or max(1, -(-work // telemetry.BLOCK))
        order = (telemetry.pool_order(grid, n_pad) if kind == "pool"
                 else telemetry.strided_order(grid, n_pad))
        return cls(order, kind)


def plane_row(spec: RowSpec, planes, k: int, r: int, *, n: int, target: int,
              fx: Optional[ChunkFaults]) -> torch.Tensor:
    """The row a fused kernel's telemetry instance writes after chunk round
    k (absolute round r) from the post-round padded planes (push-sum (s, w,
    term, conv), gossip (count, active, conv), after the global latch): the
    JAX fused kernels' counters (ops/fused.py telemetry_row), each float
    sum in the kernel's order, mass over the padded plane less n_pad."""
    from . import telemetry

    pushsum = planes[0].is_floating_point()
    c = planes[-1] != 0
    dev, rows = c.device, c.shape[0]
    n_pad = rows * LANES
    conv = c.sum(dtype=torch.int32)
    alive = None if fx is None else fx.alive(r, rows)
    if alive is None:
        live, gap = n, target - conv
    else:
        live = alive.sum(dtype=torch.int32)
        gap = int(fx.needs[k]) - (c & alive).sum(dtype=torch.int32)
    err_sum = w_sum = active = 0
    if pushsum:
        s, w = planes[0], planes[1]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        tmean = torch.tensor(telemetry.true_mean(n), dtype=torch.float32, device=dev)
        w_div = torch.where(w != 0, w, torch.ones_like(w)) if spec.err == "pool" else w
        err = torch.where(c, torch.abs(flush(flush(s / w_div) - tmean)), zero)
        order = spec.order.to(dev)
        err_sum = telemetry.kernel_sum(err, order)
        w_sum = telemetry.kernel_sum(w, order)
    else:
        active = (planes[1] != 0).sum(dtype=torch.int32)
    drops = revived = byz = 0
    if fx is not None and fx.thresh is not None:
        g = threefry_bits_2d(fx.gate_keys[k, 0], fx.gate_keys[k, 1], rows, LANES,
                             device=dev)
        real = (torch.arange(n_pad, device=dev) < n).reshape(rows, LANES)
        fired = (g < fx.thresh) & real
        drops = (fired if alive is None else fired & alive).sum(dtype=torch.int32)
    if fx is not None and fx.revive is not None:
        revived = (fx.revive == r).sum(dtype=torch.int32)
    if fx is not None and fx.byz is not None:
        byz = (fx.byz <= r).sum(dtype=torch.int32)
    return telemetry.assemble(conv, live, gap, active, err_sum, w_sum, n_pad,
                              drops, revived, byz, pushsum)


def class_sources(n_pad: int, d, n: int, device=None) -> torch.Tensor:
    """Flat [n_pad] index of the node whose message along the mod-n
    displacement ``d`` lands on each receiver j: j - d, wrapped by n."""
    j = torch.arange(n_pad, dtype=torch.int64, device=device)
    return torch.where(j >= d, j - d, j - d + n)


def pushsum_class_rounds(state4, start: int, cap: int, count: int,
                         round_classes, *, n: int, target: int, delta: float,
                         term_rounds: int, faults: Optional[ChunkFaults] = None,
                         fold_s: bool = True, telemetry: Optional[RowSpec] = None):
    """The plain version of every push-sum chunk kernel: up to ``count``
    rounds from absolute round ``start`` on the padded planes (s, w, term,
    conv_i32), stopping at ``cap`` or once ``target`` nodes converged.

    ``round_classes(k) -> (mark, classes)`` describes round k's sends:
    ``mark`` is the int64 [n_pad] class id each node sends along (-1 for
    none: pad lanes, degree 0) and ``classes`` the (class id, source index)
    pairs in delivery order, where the source index (``class_sources``)
    names the node whose send along that class lands on each receiver. Each
    receiver sums the halved sends from 0.0 in that order: the chunked
    engines' float32 op order. Returns (state4', rounds_executed).

    ``faults`` (the pool tier's) folds the drop gate and the dead into the
    marks, so a blocked node keeps its whole mass; a dead node's term and
    conv stay frozen while its s and w absorb, and the verdict is the
    quorum of live nodes. A revived node sends again, and under
    rejoin="fresh" its state resets at the start of its revival round
    (``ChunkFaults.rejoin``). Under global termination term and conv are left
    alone, a round counts its unstable real nodes (|ratio change| above
    delta * max(|ratio|, 1)), and the round where none is unstable latches
    conv on every real node and ends the run.

    With ``telemetry`` (a RowSpec) it returns each executed round's row
    (``plane_row``) too: (state4', rounds_executed, float32 [count,
    N_COLS] rows, zero past the executed ones)."""
    s, w, t, c = (x.clone() for x in state4)
    dev, rows = s.device, s.shape[0]
    tele = _row_buffer(telemetry, count, dev)
    padm = (torch.arange(rows * LANES, device=dev) >= n).reshape(rows, LANES)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    fx = faults
    done = make_done_flag(target, fx and fx.needs, fx and fx.need_init)
    finished = done(c.sum() if fx is None else fx.live_total(c, start - 1, rows))
    executed = 0
    for k in range(count):
        if finished or start + k >= cap:
            break
        if fx is not None:
            s, w, t, c = fx.rejoin((s, w, t, c), start + k)
        mark, classes = round_classes(k)
        if fx is not None:
            mark = fx.blocked(mark, start, k, rows)
        sends = mark >= 0
        ss, ws, s_keep, w_keep = (x.reshape(rows, LANES) for x in halve_and_send(
            s.reshape(-1), w.reshape(-1), sends, fold_s))
        ss, ws = ss.reshape(-1), ws.reshape(-1)
        lying = None if fx is None else fx.lying_flat(start + k)
        if lying is not None:
            # A lying sender's wire pair; its kept halves stay honest.
            ss, ws = lie(fx.byz_mode, ss, ws, s.reshape(-1), w.reshape(-1),
                         lying & sends)
        in_s = torch.zeros_like(ss)
        in_w = torch.zeros_like(ws)
        for cid, src in classes:
            hit = mark[src] == cid
            in_s = flush(in_s + torch.where(hit, ss[src], zero))
            in_w = flush(in_w + torch.where(hit, ws[src], zero))
        in_s = torch.where(padm, zero, in_s.reshape(rows, LANES))
        in_w = torch.where(padm, zero, in_w.reshape(rows, LANES))
        s_new = flush(s_keep + in_s)
        w_new = flush(w_keep + in_w)
        executed += 1
        if fx is not None and fx.global_term:
            ratio_old = s / w
            tol = delta_t * torch.maximum(torch.abs(ratio_old),
                                          torch.ones((), device=dev))
            unstable = (torch.abs(s_new / w_new - ratio_old) > tol) & ~padm
            s, w = s_new, w_new
            finished = not bool(unstable.any())
            if finished:
                c = (~padm).to(torch.int32)
            if tele is not None:
                tele[k] = plane_row(telemetry, (s, w, t, c), k, start + k, n=n,
                                    target=target, fx=fx)
            continue
        received = in_w > 0
        stable = torch.abs(s_new / w_new - s / w) <= delta_t
        t_new = torch.where(received, torch.where(stable, t + 1, 0), t).to(torch.int32)
        c_new = torch.where(padm, 0, (c != 0) | (t_new >= term_rounds)).to(torch.int32)
        alive = None if fx is None else fx.alive(start + k, rows)
        if alive is not None:
            t_new = torch.where(alive, t_new, t)
            c_new = torch.where(alive, c_new, c)
        s, w, t, c = s_new, w_new, t_new, c_new
        finished = done(c.sum() if fx is None else fx.live_total(c, start + k, rows), k)
        if tele is not None:
            tele[k] = plane_row(telemetry, (s, w, t, c), k, start + k, n=n,
                                target=target, fx=fx)
    out = ((s, w, t, c), torch.tensor(executed, dtype=torch.int32, device=dev))
    return out if tele is None else (*out, tele)


def _row_buffer(spec: Optional[RowSpec], count: int, dev):
    """A chunk's zeroed rows, or None without telemetry."""
    return None if spec is None else torch.zeros(
        count, telemetry.N_COLS, dtype=torch.float32, device=dev)


def gossip_class_rounds(state3, start: int, cap: int, count: int,
                        round_classes, *, n: int, target: int,
                        rumor_target: int, suppress: bool,
                        faults: Optional[ChunkFaults] = None,
                        telemetry: Optional[RowSpec] = None):
    """The plain version of every gossip chunk kernel, on the padded planes
    (count, active_i32, conv_i32): ``pushsum_class_rounds``' contract, where
    only active nodes send (their mark is kept, every other node's is -1),
    a receiver counts the class sources that sent along the class, and
    suppression is receiver-side. ``faults`` as there: blocked and dead
    nodes mark -1, a dead node's inbox counts nothing, and a revived node
    resets to (0, inactive, unconverged) at its revival round's start. Returns
    (state3', rounds_executed), and with ``telemetry`` the rows too."""
    cnt, act, c = (x.clone() for x in state3)
    dev, rows = cnt.device, cnt.shape[0]
    tele = _row_buffer(telemetry, count, dev)
    padm = (torch.arange(rows * LANES, device=dev) >= n).reshape(rows, LANES)
    fx = faults
    done = make_done_flag(target, fx and fx.needs, fx and fx.need_init)
    finished = done(c.sum() if fx is None else fx.live_total(c, start - 1, rows))
    executed = 0
    for k in range(count):
        if finished or start + k >= cap:
            break
        if fx is not None:
            cnt, act, c = fx.rejoin((cnt, act, c), start + k)
        mark, classes = round_classes(k)
        mark = torch.where(act.reshape(-1) != 0, mark, -1)
        if fx is not None:
            mark = fx.blocked(mark, start, k, rows)
        inbox = torch.zeros(rows * LANES, dtype=torch.int32, device=dev)
        for cid, src in classes:
            inbox = inbox + (mark[src] == cid).to(torch.int32)
        inbox = torch.where(padm, 0, inbox.reshape(rows, LANES))
        if suppress:
            inbox = torch.where(c != 0, 0, inbox)
        alive = None if fx is None else fx.alive(start + k, rows)
        if alive is not None:
            inbox = torch.where(alive, inbox, 0)
        c_old = c
        cnt = (cnt + inbox).to(torch.int32)
        act = ((act != 0) | (inbox > 0)).to(torch.int32)
        c = ((cnt >= rumor_target) & ~padm).to(torch.int32)
        if alive is not None:
            c = torch.where(alive, c, c_old)
        lying = None if fx is None else fx.lying_flat(start + k)
        if lying is not None:
            # A live adversary's state takes the mode's override.
            lying = lying.reshape(rows, LANES)
            cnt, act, c = override(fx.byz_mode, lying if alive is None else
                                   lying & alive, cnt, act, c)
        executed += 1
        finished = done(c.sum() if fx is None else fx.live_total(c, start + k, rows), k)
        if tele is not None:
            tele[k] = plane_row(telemetry, (cnt, act, c), k, start + k, n=n,
                                target=target, fx=fx)
    out = ((cnt, act, c), torch.tensor(executed, dtype=torch.int32, device=dev))
    return out if tele is None else (*out, tele)
