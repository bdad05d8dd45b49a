"""The telemetry plane: one float32 counter row a round, kept on the device.

The JAX package's ops/telemetry.py: each chunk writes one row of
``N_COLS`` float32 counters for every round it executes, after the round,
from the round's output state, into a buffer that rides out of the chunk
beside its status; the chunk loop copies it to the host with the status
(models/pipeline.run_chunks ``on_aux``) and ``Collector`` keeps the rows of
the rounds the chunk executed. ``cfg.telemetry`` off leaves every chunk as
it was.

Column schema (``SCHEMA_VERSION`` 3, all float32; counts are exact below
2**24):

    0 converged_count  conv over all nodes (dead included)
    1 live_count       nodes alive in the round (the population without a
                       crash model)
    2 progress_gap     target - conv, or under a crash model the round's
                       quorum need - conv among the live
    3 active_count     gossip: nodes that heard the rumor; 0 for push-sum
    4 estimate_mae     push-sum: mean |s/w - (n-1)/2| over converged nodes
    5 mass_residual    push-sum: sum(w) - population
    6 drop_count       drop-gate firings among live nodes in the round
    7 dup_count        dup-gate firings among live nodes in the round (the
                       chunked engine under scatter and stencil delivery,
                       the only ones that take the dup gate; 0 elsewhere)
    8 revived_count    nodes whose revival round is the round
    9 byzantine_count  nodes adversarial in the round

Who writes the rows: the chunked engine (``make_row_fn``, torch ops after
every round, its float sums in ``pushsum.sum_f32``'s order, so the rows are
the JAX chunked engine's bit for bit), kernel A (csrc/scatter.cu) and the
pool and whole-array lattice kernels (csrc/fused_pool.cu,
csrc/fused_resident.cu; rows 1-2 and 5-6). A kernel's telemetry instance
writes each block's partial counts and float sums for each round into a
``[rounds, blocks, PARTIALS]`` scratch, and after the chunk one reduce
kernel sums them in block order into the ``[rounds, N_COLS]`` rows
(csrc/telemetry.cuh). Its float sums run in the kernel's own order
(``KernelOrder``), which the plain versions repeat, so a kernel's rows are
bitwise its plain version's; the plain rows of rows 1-2 and 5-6 stay within
the JAX package's own tolerances of its fused kernels' rows (their sums run
in another order there too). Every other fused tier demotes to the chunked
engine or refuses, as in the JAX ladder (models/runner.fused_tier).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..models.pushsum import flush, sum_f32
from . import faults as faults_mod
from . import sampling
from .topology import Topology

SCHEMA_VERSION = 3

COLUMNS = (
    "converged_count",
    "live_count",
    "progress_gap",
    "active_count",
    "estimate_mae",
    "mass_residual",
    "drop_count",
    "dup_count",
    "revived_count",
    "byzantine_count",
)
N_COLS = len(COLUMNS)

COL_CONV = 0
COL_LIVE = 1
COL_GAP = 2
COL_ACTIVE = 3
COL_MAE = 4
COL_MASS = 5
COL_DROPS = 6
COL_DUPS = 7
COL_REVIVED = 8
COL_BYZ = 9

# Words a block writes for each round into a kernel's telemetry scratch
# (csrc/telemetry.cuh kPartials): seven int32 counts, then three float32
# sums.
PARTIALS = 11
# The kernels' block width (csrc/chunk.cuh kBlock) and warp.
BLOCK = 256
WARP = 32


def true_mean(n: int) -> float:
    """Push-sum's ground truth: node i holds i, so the mean is (n-1)/2."""
    return (n - 1) / 2.0


def assemble(conv, live, gap, active, err_sum, w_sum, n_mass: int, drops,
             revived, byz, pushsum: bool, dups=0) -> torch.Tensor:
    """One row from its counts and float sums (0-dim tensors or ints):
    estimate_mae = err_sum / max(conv, 1) and mass_residual = w_sum - n_mass
    in float32, each flushed as XLA flushes them on the CPU."""
    f32 = torch.float32
    conv_t = torch.as_tensor(conv).to(f32)
    dev = conv_t.device
    zero = torch.zeros((), dtype=f32, device=dev)
    if pushsum:
        mae = flush(torch.as_tensor(err_sum, device=dev).to(f32)
                    / torch.clamp(conv_t, min=1.0))
        mass = flush(torch.as_tensor(w_sum, device=dev).to(f32)
                     - torch.tensor(n_mass, dtype=f32, device=dev))
    else:
        mae = mass = zero
    cols = [conv_t, live, gap, active if not pushsum else zero, mae, mass,
            drops, dups, revived, byz]
    return torch.stack([torch.as_tensor(c, device=dev).to(f32) for c in cols])


def chunked_err(s, w, conv, tmean):
    """Per node |s/w - true_mean| where converged (0 where not), with w = 0
    read as a ratio of 0, each op flushed: the chunked engine's
    estimate_mae terms (the JAX ``make_row_fn``; kernel A's)."""
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    nz = w != 0
    ratio = torch.where(nz, flush(s / torch.where(nz, w, torch.ones_like(w))), zero)
    return torch.where(conv, torch.abs(flush(ratio - tmean)), zero)


def make_row_fn(topo: Topology, cfg: SimConfig, base_key, device=None,
                fsum: Callable = sum_f32):
    """``row_fn(state, round_idx, need=None, key=None) -> float32 [N_COLS]``
    of the chunked engine, on the state's device: the row after round
    ``round_idx`` from its output state (the JAX ``make_row_fn``). ``need``
    is the round's quorum need under a crash model (faults.quorum_needs;
    taken from the live count on the host when None). The drop count
    redraws the round's gate from the round key of ``key`` (``base_key``
    when None; a sweep lane passes its own), as the round drew it;
    float sums run in ``fsum``'s order (sum_f32: the JAX chunked engine's).
    The dup count redraws the round's dup gate the same way."""
    n = topo.n
    target = cfg.resolved_target_count(topo.n, topo.target_count)
    pushsum = cfg.algorithm == "push-sum"
    tmean = torch.tensor(true_mean(n), dtype=torch.float32)
    planes = faults_mod.life_planes(cfg, n)
    death = None if planes is None else torch.from_numpy(planes.death).to(device)
    revive = (None if planes is None or planes.revive is None
              else torch.from_numpy(planes.revive).to(device))
    byz_np = faults_mod.byzantine_plane(cfg, n)
    byz = None if byz_np is None else torch.from_numpy(byz_np).to(device)

    def row_fn(state, round_idx: int, need=None, key=None):
        key = base_key if key is None else key
        dev = state.conv.device
        conv = state.conv
        conv_ct = conv.sum(dtype=torch.int32)
        alive = None
        if death is None:
            live = torch.tensor(n, dtype=torch.int32, device=dev)
            gap = target - conv_ct
        else:
            alive = faults_mod.alive_at(death, round_idx, revive)
            live = alive.sum(dtype=torch.int32)
            if need is None:
                need = faults_mod.quorum_need(int(live), cfg.quorum)
            gap = need - (conv & alive).sum(dtype=torch.int32)
        err_sum = w_sum = act = 0
        if pushsum:
            err_sum = fsum(chunked_err(state.s, state.w, conv, tmean.to(dev)))
            w_sum = fsum(state.w)
        else:
            act = state.active.sum(dtype=torch.int32)
        drops = dups = 0
        if cfg.fault_rate > 0:
            gate = sampling.send_gate(sampling.round_key(key, round_idx), n,
                                      cfg.fault_rate, device=dev)
            fired = ~gate if alive is None else ~gate & alive
            drops = fired.sum(dtype=torch.int32)
        if cfg.dup_rate > 0:
            dup = sampling.dup_gate(sampling.round_key(key, round_idx), n,
                                    cfg.dup_rate, device=dev)
            dups = (dup if alive is None else dup & alive).sum(dtype=torch.int32)
        revived = 0 if revive is None else faults_mod.revived_at(
            revive, round_idx).sum(dtype=torch.int32)
        byz_ct = 0 if byz is None else faults_mod.byzantine_at(
            byz, round_idx).sum(dtype=torch.int32)
        return assemble(conv_ct, live, gap, act, err_sum, w_sum, n, drops,
                        revived, byz_ct, pushsum, dups)

    return row_fn


# ---------------------------------------------------------------------------
# The kernels' float order (csrc/telemetry.cuh), for their plain versions.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelOrder:
    """The order in which a telemetry instance sums a float over nodes:
    thread t of block b adds the nodes ``visits[b, t, :]`` (-1: no node at
    that step) in that order, from 0.0; each warp's 32 sums then fold by
    halves (lanes l and l + o, o = 16, 8, 4, 2, 1); the block adds its 8
    warp sums in warp order from 0.0; and the grid's ``blocks`` partials
    are added with lane l taking blocks l, l + 32, ... in order from 0.0,
    then the 32 lane sums folded by halves. Every add is flushed
    (csrc/faults.cuh flush)."""

    visits: torch.Tensor  # int64 [blocks, BLOCK, steps]

    @property
    def blocks(self) -> int:
        return self.visits.shape[0]

    def to(self, device) -> "KernelOrder":
        return KernelOrder(self.visits.to(device))


def _strided(blocks: int, count: int) -> torch.Tensor:
    """Visits of a grid-stride loop over ``count`` items: thread g =
    b * BLOCK + t takes g, g + blocks * BLOCK, ..."""
    threads = blocks * BLOCK
    steps = max(1, -(-count // threads))
    idx = (torch.arange(threads, dtype=torch.int64)[:, None]
           + threads * torch.arange(steps, dtype=torch.int64)[None, :])
    return torch.where(idx < count, idx, -1).reshape(blocks, BLOCK, steps)


def strided_order(blocks: int, count: int) -> KernelOrder:
    """A grid-stride loop over ``count`` nodes (csrc/fused_resident.cu,
    kernel A's gossip instance)."""
    return KernelOrder(_strided(blocks, count))


def pool_order(blocks: int, n_pad: int, pack: int = 8, lanes: int = 128) -> KernelOrder:
    """csrc/fused_pool.cu's walk: a grid-stride loop over packed words wi,
    each thread taking the ``pack`` nodes of its word in order (pool.cuh
    word_node: (wi / lanes) * pack * lanes + sub * lanes + wi % lanes)."""
    words = _strided(blocks, n_pad // pack)
    sub = torch.arange(pack, dtype=torch.int64)
    node = ((words[..., None] // lanes) * (pack * lanes) + sub * lanes
            + words[..., None] % lanes)
    node = torch.where(words[..., None] >= 0, node, -1)
    return KernelOrder(node.reshape(blocks, BLOCK, -1))


def slice_order(blocks: int, n: int) -> KernelOrder:
    """Kernel A's push-sum walk (csrc/scatter.cuh Slices): block b owns
    [b * size, min((b + 1) * size, n)), size = ceil(n / blocks), and thread
    t takes lo + t, lo + t + BLOCK, ..."""
    size = -(-n // blocks)
    steps = max(1, -(-size // BLOCK))
    b = torch.arange(blocks, dtype=torch.int64)[:, None, None]
    t = torch.arange(BLOCK, dtype=torch.int64)[None, :, None]
    k = torch.arange(steps, dtype=torch.int64)[None, None, :]
    lo = b * size
    j = lo + t + BLOCK * k
    hi = torch.clamp((b + 1) * size, max=n)
    return KernelOrder(torch.where(j < hi, j, -1))


def _fold_halves(x: torch.Tensor) -> torch.Tensor:
    """The last dim (32) folded by halves, flushed: lane 0 of a warp's
    shuffle-down tree."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = flush(x[..., :h] + x[..., h:2 * h])
    return x[..., 0]


def _serial(x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over the last dim in order from 0.0, flushed; ``valid`` masks
    steps that do not exist (no add at all, so a -0.0 sum stays)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        nxt = flush(acc + x[..., i])
        acc = nxt if valid is None else torch.where(valid[..., i], nxt, acc)
    return acc


def block_partials(values: torch.Tensor, order: KernelOrder) -> torch.Tensor:
    """float32 [blocks]: each block's sum of ``values`` (flat, per node)."""
    v = values.reshape(-1).to(torch.float32)
    idx = order.visits.to(v.device)
    valid = idx >= 0
    per_thread = _serial(v[idx.clamp(min=0)], valid)  # [blocks, BLOCK]
    warps = _fold_halves(per_thread.reshape(order.blocks, BLOCK // WARP, WARP))
    return _serial(warps)


def grid_sum(partials: torch.Tensor) -> torch.Tensor:
    """0-dim float32: the blocks' partials in the reduce's order (lane l
    takes blocks l, l + 32, ...; then the lanes folded by halves)."""
    g = partials.shape[0]
    steps = max(1, -(-g // WARP))
    pad = steps * WARP - g
    p = torch.cat([partials, partials.new_zeros(pad)]).reshape(steps, WARP).T
    valid = (torch.arange(steps * WARP, device=p.device) < g).reshape(steps, WARP).T
    return _fold_halves(_serial(p, valid))


def kernel_sum(values: torch.Tensor, order: KernelOrder) -> torch.Tensor:
    """A telemetry instance's float sum of ``values`` over the nodes."""
    return grid_sum(block_partials(values, order))


# ---------------------------------------------------------------------------
# The host side: records, the trajectory, the collector.
# ---------------------------------------------------------------------------


def rows_to_trace_records(data: np.ndarray, start_round: int, algorithm: str,
                          prev_conv: int = 0) -> list:
    """Per-round records of the ``--trace-convergence`` JSONL schema for
    rows ``data`` whose first row follows absolute round ``start_round``:
    rounds, converged_count, newly_converged (from ``prev_conv``, the
    converged count before these rows) and estimate_mae (push-sum) or
    active_count (gossip); ``revived`` and ``byzantine`` only on rounds
    where they are > 0."""
    out = []
    prev = int(prev_conv)
    pushsum = algorithm == "push-sum"
    for i in range(data.shape[0]):
        row = data[i]
        conv = int(row[COL_CONV])
        rec = {
            "rounds": start_round + i + 1,
            "converged_count": conv,
            "newly_converged": conv - prev,
        }
        prev = conv
        if pushsum:
            rec["estimate_mae"] = float(row[COL_MAE])
        else:
            rec["active_count"] = int(row[COL_ACTIVE])
        if row.shape[0] > COL_REVIVED and row[COL_REVIVED] > 0:
            rec["revived"] = int(row[COL_REVIVED])
        if row.shape[0] > COL_BYZ and row[COL_BYZ] > 0:
            rec["byzantine"] = int(row[COL_BYZ])
        out.append(rec)
    return out


@dataclasses.dataclass
class TelemetryTrajectory:
    """A run's rows: ``data[i]`` is the row after absolute round
    ``start_round + i``."""

    start_round: int
    data: np.ndarray  # [rounds executed, N_COLS] float32
    schema_version: int = SCHEMA_VERSION
    columns: tuple = COLUMNS

    @property
    def rounds(self) -> int:
        return int(self.data.shape[0])

    def to_trace_records(self, algorithm: str, prev_conv: int = 0) -> list:
        return rows_to_trace_records(self.data, self.start_round, algorithm,
                                     prev_conv)


class Collector:
    """The chunk loop's ``on_aux``: at each retired chunk it keeps the rows
    of the rounds the chunk executed (rounds_after - rounds_before) and
    drops the rest (rounds queued past termination, a no-op chunk's
    rows). ``on_rows(chunk_start_round, rows)`` fires with each retired
    chunk's rows: the CLI's streaming trace writer."""

    def __init__(self, start_round: int = 0, on_rows=None):
        self._start = int(start_round)
        self._parts: list = []
        self._on_rows = on_rows

    def on_aux(self, rounds_before: int, rounds_after: int, aux) -> None:
        executed = int(rounds_after) - int(rounds_before)
        if executed <= 0:
            return
        buf = aux.numpy() if isinstance(aux, torch.Tensor) else np.asarray(aux)
        rows = np.array(buf[:executed, :N_COLS], dtype=np.float32)
        self._parts.append(rows)
        if self._on_rows is not None:
            self._on_rows(int(rounds_before), rows)

    def finalize(self) -> TelemetryTrajectory:
        data = (np.concatenate(self._parts, axis=0) if self._parts
                else np.zeros((0, N_COLS), np.float32))
        return TelemetryTrajectory(start_round=self._start, data=data)
