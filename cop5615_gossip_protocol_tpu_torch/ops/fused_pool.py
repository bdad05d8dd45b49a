"""Fused multi-round pool engine for the implicit full topology.

One call runs a chunk of up to K synchronous push-sum or gossip rounds on
the padded ``[rows, 128]`` layout of the JAX package's ops/fused_pool.py,
consuming per-round fold_in keys and displacement pools, and stops early
once the converged count reaches the target, or under the run's failure
model (``fused.Faults``: the drop gate, crash-stop with the quorum of the
live nodes, push-sum's global termination) once its verdict fires.
``pushsum_pool_chunk`` and
``gossip_pool_chunk`` launch the CUDA kernels of csrc/fused_pool.cu on
CUDA tensors and run their plain torch versions (``*_plain``) on CPU
tensors; the plain versions run on any device and are what the kernels are
held against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..config import SimConfig
from ..utils import kernels
from . import rng
from . import telemetry as telemetry_mod
from .fused import (
    LANES,
    Faults,
    RowSpec,
    clamp_cap_and_pad,
    class_sources,
    gossip_class_rounds,
    pushsum_class_rounds,
    threefry_bits_2d,
)
from .sampling import (
    POOL_CHOICE_BITS,
    POOL_PACK,
    POOL_TILE_ROWS,
    _POOL_TAG,
    choice_from_words,
    pool_rows,
)
from .topology import Topology

TILE = POOL_TILE_ROWS
# The JAX engine's VMEM budget; larger populations run the streaming pool
# tier (ops/fused_pool2.py).
MAX_POOL_NODES = 2**21
POOL_SIZES = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class PoolLayout:
    n: int
    n_pad: int
    rows: int
    tiles: int


def build_pool_layout(n: int) -> PoolLayout:
    rows = pool_rows(n)
    return PoolLayout(n=n, n_pad=rows * LANES, rows=rows, tiles=rows // TILE)


def pool_fused_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the fused pool engine can run this config, else the reason
    (the JAX tier's, which serves delivery="pool" and "matmul" alike)."""
    if not topo.implicit:
        return (
            "the fused pool engine serves the implicit full topology only; "
            f"pooled delivery on {topo.kind!r} runs the chunked engine"
        )
    if cfg.dup_rate > 0 or cfg.delay_rounds > 0:
        # Duplicate delivery and the delay ring restructure delivery
        # itself: the config runs on the chunked engine.
        return "dup/delay fault models run on the chunked engine only"
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    if topo.n > MAX_POOL_NODES:
        return (
            f"population {topo.n} exceeds the pool engine's {MAX_POOL_NODES} "
            "nodes; the streaming pool tier (ops/fused_pool2.py) runs it"
        )
    return None


def round_offsets(base_key, start: int, count: int, pool_size: int,
                  n: int) -> torch.Tensor:
    """int32 ``[count, pool_size]`` displacement pools for absolute rounds
    start..start+count: sampling.pool_offsets of each round's key."""
    rounds = (start + torch.arange(count, dtype=torch.int64)) & rng.MASK
    k1, k2 = rng.threefry2x32(int(base_key[0]), int(base_key[1]), 0, rounds)
    t1, t2 = rng.threefry2x32(k1, k2, 0, _POOL_TAG)
    slot = torch.arange(pool_size, dtype=torch.int64)[None, :]
    a, b = rng.threefry2x32(t1[:, None], t2[:, None], 0, slot)
    return (1 + (a ^ b) % (n - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in torch, on any device.
# ---------------------------------------------------------------------------


def _choice_plane(key_row: torch.Tensor, rows: int, pool_size: int) -> torch.Tensor:
    """int32 [rows, 128] pool slots of one round (packed words)."""
    words = threefry_bits_2d(
        key_row[0], key_row[1], rows // POOL_PACK, LANES, device=key_row.device
    )
    return choice_from_words(words, pool_size)


def _pool_classes(keys, offs, rows: int, n: int):
    """``round_classes`` of the pool chunks (fused.pushsum_class_rounds):
    every real node marks its pool slot, and slot k's sources are the
    mod-n roll by the round's k-th displacement."""
    n_pad = rows * LANES
    padm = torch.arange(n_pad, device=keys.device) >= n

    def round_classes(k):
        choice = _choice_plane(keys[k], rows, offs.shape[1]).reshape(-1)
        mark = torch.where(padm, -1, choice.to(torch.int64))
        return mark, [(slot, class_sources(n_pad, offs[k, slot], n, keys.device))
                      for slot in range(offs.shape[1])]

    return round_classes


def pushsum_pool_chunk_plain(state4, keys, offs, start: int, cap: int, *,
                             n: int, target: int, delta: float,
                             term_rounds: int,
                             faults: Optional[Faults] = None,
                             telemetry: bool = False,
                             grid: Optional[int] = None):
    """Up to K = keys.shape[0] push-sum pool rounds on the padded planes
    (s, w, term, conv_i32), with the run's drop gate, crash-stop and
    global termination (``faults``, fused.pushsum_class_rounds). Returns
    (state4', rounds_executed), and with ``telemetry`` the chunk's rows
    too, float32 [K, N_COLS], their float sums in the order of the
    kernel's telemetry instance on ``grid`` blocks (``telemetry_grid``)."""
    dev, rows = state4[0].device, state4[0].shape[0]
    cap, keys, offs = clamp_cap_and_pad(start, cap, keys, ((offs, 1),))
    return pushsum_class_rounds(
        state4, start, cap, keys.shape[0],
        _pool_classes(keys.to(dev), offs.to(dev), rows, n), n=n,
        target=target, delta=delta, term_rounds=term_rounds,
        faults=_chunk_faults(faults, keys, start, rows, dev),
        telemetry=_row_spec(telemetry, rows, grid))


def gossip_pool_chunk_plain(state3, keys, offs, start: int, cap: int, *,
                            n: int, target: int, rumor_target: int,
                            suppress: bool, faults: Optional[Faults] = None,
                            telemetry: bool = False, grid: Optional[int] = None):
    """Up to K gossip pool rounds on the padded planes (count, active_i32,
    conv_i32), with receiver-side suppression and the run's drop gate and
    crash-stop. Returns (state3', rounds_executed), and with ``telemetry``
    the rows too."""
    dev, rows = state3[0].device, state3[0].shape[0]
    cap, keys, offs = clamp_cap_and_pad(start, cap, keys, ((offs, 1),))
    return gossip_class_rounds(
        state3, start, cap, keys.shape[0],
        _pool_classes(keys.to(dev), offs.to(dev), rows, n), n=n,
        target=target, rumor_target=rumor_target, suppress=suppress,
        faults=_chunk_faults(faults, keys, start, rows, dev),
        telemetry=_row_spec(telemetry, rows, grid))


def _row_spec(telemetry: bool, rows: int, grid: Optional[int]):
    return RowSpec.for_layout("pool", rows * LANES, grid) if telemetry else None


def _chunk_faults(faults: Optional[Faults], keys, start: int, rows: int, dev):
    return None if faults is None else faults.for_chunk(keys, start, rows * LANES, dev)


def fault_args(faults: Optional[Faults], needs_ptr, need_init, start: int,
               n_pad: int, dev, pushsum: bool, revive: bool = False) -> list:
    """The failure-model arguments that the chunk entry points of
    csrc/fused_pool.cu, csrc/fused_pool2.cu and csrc/fused_resident.cu take
    after their protocol's: whether to run the faulted instance, the gate
    threshold, the death plane over n_pad on ``dev``, the rounds' quorum
    needs on the device (``needs_ptr``, None without a crash model), the
    seed need, the chunk's first absolute round, where the entry point
    carries crash-recovery and the Byzantine plane (``revive``:
    csrc/fused_pool.cu and csrc/fused_resident.cu) the revival plane,
    whether a revived node resets and (push-sum) the initial term, and, for
    push-sum, global termination; then, where ``revive``, the Byzantine
    onset plane over n_pad and the mode (``Faults.byz_args``)."""
    if faults is None:
        args = [0, 0, None, None, 0, start]
    else:
        death = faults.death_flat(n_pad, dev)
        args = [1, faults.thresh or 0, None if death is None else death.data_ptr(),
                needs_ptr, need_init or 0, start]
    if revive:
        rv = [None, 0, 0] if faults is None else faults.revive_args(n_pad, dev)
        args += rv if pushsum else rv[:2]
    if pushsum:
        args.append(int(faults is not None and faults.global_term))
    if revive:
        args += [None, 0] if faults is None else faults.byz_args(n_pad, dev)
    return args


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two.
# ---------------------------------------------------------------------------


def _check(planes, dtypes, keys, offs, n: int) -> torch.device:
    if len(planes) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} state planes, got {len(planes)}")
    shape = (pool_rows(n), LANES)
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pool chunks run on cpu or cuda tensors, got {dev}")
    for x, dt in zip(planes, dtypes):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(
                f"state plane must be {dt} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError("state planes must be contiguous")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be int64 [K, 2], got {keys.dtype} {tuple(keys.shape)}")
    if offs.dtype != torch.int32 or offs.dim() != 2 or offs.shape[0] != keys.shape[0]:
        raise ValueError(
            f"offs must be int32 [K, P] with K = {keys.shape[0]}, got "
            f"{offs.dtype} {tuple(offs.shape)}"
        )
    if offs.shape[1] not in POOL_SIZES:
        raise ValueError(
            f"pool_size {offs.shape[1]} not in {POOL_SIZES} (the packed-choice "
            "limit of the kernels)"
        )
    # The streams are drawn on the host; checking their values there costs
    # no device sync, and an offset outside [1, n-1] would send the
    # kernels' gathers out of bounds.
    if keys.device.type != "cpu" or offs.device.type != "cpu":
        raise ValueError("keys and offs are host-drawn streams: pass CPU tensors")
    # numpy's reductions: a chunk's fixed host cost counts in short chunks.
    words, pools = keys.numpy(), offs.numpy()
    if words.size and (words.min() < 0 or words.max() > rng.MASK):
        raise ValueError("keys must hold uint32 words")
    if pools.size and (pools.min() < 1 or pools.max() > n - 1):
        raise ValueError(f"offs must lie in [1, {n - 1}]")
    return dev


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_FAULT_ARGS = [_I, _U, _P, _P, _I, _I]
# The telemetry instance's arguments (csrc/fused_pool.cu,
# csrc/fused_resident.cu): its scratch, its rows, its grid, the true mean.
TELE_ARGS = [_P, _P, _I, _F]
_SIGNATURES = {
    "gossip_pushsum_pool_chunk": [_P] * 14 + [_I] * 4 + [_F, _I, _I]
                                 + _FAULT_ARGS + [_P, _I, _I] + [_I] + [_P, _I]
                                 + TELE_ARGS + [_I, _P],
    "gossip_gossip_pool_chunk": [_P] * 11 + [_I] * 7 + _FAULT_ARGS + [_P, _I]
                                + [_P, _I] + TELE_ARGS + [_I, _P],
    "gossip_pool_grid": [_I] * 4,
    "gossip_resident_grid": [_I] * 4,
}


def chunk_launches(rounds: int, telemetry: bool = False) -> int:
    """Launches a chunk of csrc/fused_pool.cu (or csrc/fused_resident.cu)
    queues, whatever its rounds: init, the persistent launch that runs them
    all, finish, and with telemetry the reduce of its rows."""
    return 4 if telemetry else 3


@functools.lru_cache(maxsize=None)
def telemetry_grid(source: str, pushsum: bool, pool_size: int, n_pad: int,
                   device_index: int) -> int:
    """The grid of the telemetry instance's persistent launch
    (csrc/fused_pool.cu gossip_pool_grid at a pool width, or
    csrc/fused_resident.cu gossip_resident_grid): the blocks whose partials
    a chunk's scratch holds and whose order the plain rows follow."""
    symbol = "gossip_pool_grid" if source == "fused_pool" else "gossip_resident_grid"
    fn = kernels.entry(source, symbol, _SIGNATURES[symbol])
    grid = fn(int(pushsum), pool_size, n_pad, device_index)
    if grid <= 0:
        raise RuntimeError(f"{symbol} failed with cudaError_t {-grid}")
    return grid


def tele_args(source: str, pushsum: bool, pool_size: int, n: int, n_pad: int,
              rounds: int, count: int, dev):
    """(the entry point's telemetry arguments, the rows, the buffers to
    keep until the launch is queued) of a telemetry chunk of ``rounds``
    rounds whose rows buffer has ``count`` >= rounds rows (zero past the
    rounds the reduce writes)."""
    grid = telemetry_grid(source, pushsum, pool_size, n_pad, dev.index)
    scratch = torch.empty(rounds * grid * telemetry_mod.PARTIALS,
                          dtype=torch.int32, device=dev)
    rows = torch.zeros(count, telemetry_mod.N_COLS, dtype=torch.float32,
                       device=dev)
    return ([scratch.data_ptr(), rows.data_ptr(), grid,
             ctypes.c_float(telemetry_mod.true_mean(n))], rows, scratch)


def _upload(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host stream on the device, copied without a host sync."""
    return x.pin_memory().to(dev, non_blocking=True)


def _launch(source: str, name: str, argtypes, dev: torch.device, pointers,
            ints) -> None:
    """Queue one chunk through entry point ``name`` of csrc/<source>.cu on
    the current stream of ``dev`` and raise on a launch error. Buffers the
    caller drops after this returns stay safe: torch's caching allocator
    hands their memory only to work queued later on the same stream."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    fn = kernels.entry(source, name, argtypes)
    err = fn(*[_ptr(x) for x in pointers], *ints, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _kernel_chunk(name: str, state, keys, offs, start: int, cap: int, n: int,
                  tail, faults: Optional[Faults] = None, telemetry: bool = False):
    """Queue one chunk through entry point ``name`` of csrc/fused_pool.cu
    on the current stream of the state's device and raise on a launch
    error. ``tail`` holds the protocol's trailing arguments; ``faults`` (the
    run's, or None) picks the kernels' faulted instance and gives its
    inputs; ``telemetry`` the telemetry instance (with the faulted one,
    under no fault too). Returns (state', rounds_executed[, rows])."""
    dev = state[0].device
    cap, keys, offs = clamp_cap_and_pad(start, cap, keys, ((offs, 1),))
    n_pad = state[0].numel()
    # One copy to the card for the host streams: the keys' uint32 words
    # (int64 [K, 2] as int32 pairs), the pools, then under a crash model the
    # rounds' quorum needs (the kernels fold the gate keys themselves).
    parts = [keys.contiguous().view(torch.int32).reshape(-1), offs.reshape(-1)]
    needs = need_init = None
    if faults is not None:
        needs, need_init = faults.needs(start, keys.shape[0])
        if needs is not None:
            parts.append(needs)
    streams = _upload(torch.cat(parts), dev)
    fargs = fault_args(
        faults, None if needs is None else
        streams.data_ptr() + 8 * keys.numel() + 4 * offs.numel(), need_init, start,
        n_pad, dev, len(state) == 4, revive=True)
    rounds = max(0, cap - start)
    targs, rows_out = [None, None, 0, ctypes.c_float(0.0)], None
    if telemetry:
        fargs[0] = 1
        targs, rows_out, _scratch = tele_args(
            "fused_pool", len(state) == 4, offs.shape[1], n, n_pad, rounds,
            keys.shape[0], dev)
    planes = len(state) * n_pad
    # Two allocations a chunk beside the streams' copy: the result planes
    # with the control words behind them (done, rounds executed, then 8 *
    # (rounds + 2) bytes of scratch; the entry point zeroes them), and the
    # kernel's own planes: push-sum's other s and w (its term and conv stay
    # in the result planes) or gossip's int8 flags, then the two mark planes
    # (round r reads half r % 2). All are passed as raw pointers and stay
    # safe after this returns: torch's caching allocator hands their memory
    # only to work queued later on the same stream.
    head = torch.empty(planes + 2 + 2 * (rounds + 2), dtype=torch.int32, device=dev)
    own_bytes = 8 * n_pad if len(state) == 4 else n_pad
    work = torch.empty((own_bytes + 2 * n_pad) // 4, dtype=torch.int32, device=dev)
    base = work.data_ptr()
    own = [base, base + 4 * n_pad] if len(state) == 4 else [base]
    out = [p if p.dtype == x.dtype else p.view(x.dtype) for p, x in
           zip(head[:planes].view(len(state), *state[0].shape).unbind(0), state)]
    fn = kernels.entry("fused_pool", name, _SIGNATURES[name])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[x.data_ptr() for x in (*state, *out)], *own, base + own_bytes,
             streams.data_ptr(),
             streams.data_ptr() + 8 * keys.numel(),
             head.data_ptr() + 4 * planes, n, n_pad, offs.shape[1], rounds, *tail,
             *fargs, *targs, dev.index, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    out = (tuple(out), head[planes + 1])
    return out if rows_out is None else (*out, rows_out)


def pushsum_pool_chunk(state4, keys, offs, start: int, cap: int, *, n: int,
                       target: int, delta: float, term_rounds: int,
                       faults: Optional[Faults] = None, telemetry: bool = False):
    """Up to K = keys.shape[0] push-sum pool rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged.

    ``state4`` is (s, w, term, conv_i32) in the padded [rows, 128] layout,
    on one device; ``keys`` int64 [K, 2] fold_in keys (uint32 words) and
    ``offs`` int32 [K, P] displacement pools are CPU tensors (fused.
    round_keys, round_offsets). Returns (state4', rounds_executed) with
    rounds_executed a 0-dim int32 tensor on the state's device; the inputs
    are left unchanged. CUDA state runs the kernel and CPU state the plain
    version. ``faults`` (the run's fused.Faults, None for a fault-free run
    with local termination) adds the drop gate, crash-stop with the quorum
    verdict and global termination. ``telemetry`` runs the telemetry
    instance and returns the chunk's rows too (float32 [K padded to 8,
    N_COLS], zero past the executed rounds)."""
    dev = _check(state4, (torch.float32, torch.float32, torch.int32, torch.int32),
                 keys, offs, n)
    if dev.type == "cpu":
        return pushsum_pool_chunk_plain(
            state4, keys, offs, start, cap, n=n, target=target, delta=delta,
            term_rounds=term_rounds, faults=faults, telemetry=telemetry,
        )
    out = _kernel_chunk("gossip_pushsum_pool_chunk", state4, keys, offs, start, cap, n,
                        (ctypes.c_float(delta), term_rounds, target), faults,
                        telemetry)
    pushsum_pool_chunk.launches += chunk_launches(keys.shape[0], telemetry)
    return out


def gossip_pool_chunk(state3, keys, offs, start: int, cap: int, *, n: int,
                      target: int, rumor_target: int, suppress: bool,
                      faults: Optional[Faults] = None, telemetry: bool = False):
    """Gossip analog of ``pushsum_pool_chunk``: ``state3`` is (count,
    active_i32, conv_i32); converged-target suppression is receiver-side."""
    dev = _check(state3, (torch.int32,) * 3, keys, offs, n)
    if dev.type == "cpu":
        return gossip_pool_chunk_plain(
            state3, keys, offs, start, cap, n=n, target=target,
            rumor_target=rumor_target, suppress=suppress, faults=faults,
            telemetry=telemetry,
        )
    out = _kernel_chunk("gossip_gossip_pool_chunk", state3, keys, offs, start, cap, n,
                        (rumor_target, int(suppress), target), faults, telemetry)
    gossip_pool_chunk.launches += chunk_launches(keys.shape[0], telemetry)
    return out


# Kernel launches queued by each wrapper (3 a chunk, 4 with telemetry), counted
# where the kernel is launched and nowhere else.
pushsum_pool_chunk.launches = 0
gossip_pool_chunk.launches = 0


