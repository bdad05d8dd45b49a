"""Streaming fused pool engine for the implicit full topology past the pool
engine's cap: the counterpart of the JAX package's ops/fused_pool2.py.

One call runs a chunk of up to K synchronous push-sum or gossip rounds on
the pool layout (ops/fused_pool.py: ``[pool_rows(n), 128]``, the same
host-drawn keys and displacement pools), for populations up to
``MAX_POOL2_NODES``. The trajectory is the pool tier's; what differs is how
the kernels of csrc/fused_pool2.cu move it: one launch a round over
ping/pong planes, no send planes, the pool choice regenerated where it is
read. ``pushsum_pool2_chunk`` and ``gossip_pool2_chunk`` launch them on
CUDA tensors and run their plain torch versions (``*_plain``) on CPU
tensors; the plain versions run on any device and are what the kernels are
held against.

Gossip stores no conv plane: conv is ``count >= rumor_target`` on real
lanes (count never decreases), read from the incoming counts and returned
that way whatever conv plane came in, as the JAX tier does.

Both wrappers take the run's drop gate, crash-stop with the quorum verdict
and push-sum's global termination (``faults``, a ``fused.Faults``), as the
pool tier's do: the kernels' faulted instances, and the plain versions'
fault branches (fused.pushsum_class_rounds, gossip_class_rounds).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import SimConfig
from . import fused_pool
from .fused import Faults, clamp_cap_and_pad
from .sampling import POOL_CHOICE_BITS
from .topology import Topology

# The JAX tier's cap (its HBM-plane budget): 2**27 nodes. The kernels' int32
# indices hold past it (j - d + n < 2**28).
MAX_POOL2_NODES = 2**27


def pool2_support(topo: Topology, cfg: SimConfig) -> Optional[str]:
    """None if the streaming pool engine can run this (float32,
    single-device) config, else the reason: the JAX tier's reasons that
    apply to the port's configs."""
    if not topo.implicit:
        return "the streaming pool engine serves the implicit full topology only"
    if cfg.dup_rate > 0 or cfg.delay_rounds > 0:
        # Duplicate delivery and the delay ring restructure delivery
        # itself: the config runs on the chunked engine.
        return "dup/delay fault models run on the chunked engine only"
    if cfg.revive_model:
        # The JAX tier's needs and windowed freeze come from the sorted
        # death plane alone: a revive config runs on the chunked engine.
        return (
            "crash-recovery (revive) runs on the chunked, sharded, and "
            "VMEM fused stencil/pool engines only"
        )
    if cfg.pool_size > 1 << POOL_CHOICE_BITS:
        return (
            f"pool_size {cfg.pool_size} exceeds the packed-choice limit "
            f"{1 << POOL_CHOICE_BITS}"
        )
    if topo.n > MAX_POOL2_NODES:
        return (
            f"population {topo.n} exceeds the HBM-plane budget "
            f"({MAX_POOL2_NODES} nodes); n_devices > 1 with engine='fused' "
            "shards the aggregate past it (the replicated-pool2 composition, "
            "parallel/pool2_sharded.py)"
        )
    return None


# ---------------------------------------------------------------------------
# Plain versions: the kernels' function in torch, on any device. The
# push-sum one is the pool tier's; gossip first derives conv from count.
# ---------------------------------------------------------------------------

pushsum_pool2_chunk_plain = fused_pool.pushsum_pool_chunk_plain


def gossip_pool2_chunk_plain(state3, keys, offs, start: int, cap: int, *,
                             n: int, target: int, rumor_target: int,
                             suppress: bool, faults: Optional[Faults] = None):
    """Up to K gossip pool rounds on the padded planes (count, active_i32,
    conv_i32), with conv derived from count (the incoming conv plane is not
    read) and the run's drop gate and crash-stop (``faults``). Returns
    (state3', rounds_executed)."""
    count, active, _ = state3
    real = torch.arange(count.numel(), device=count.device).reshape(count.shape) < n
    conv = ((count >= rumor_target) & real).to(torch.int32)
    return fused_pool.gossip_pool_chunk_plain(
        (count, active, conv), keys, offs, start, cap, n=n, target=target,
        rumor_target=rumor_target, suppress=suppress, faults=faults)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernels, CPU tensors run the plain
# versions. No fallback between the two.
# ---------------------------------------------------------------------------


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# The failure model's arguments (faulted, thresh, death, needs, need_init,
# start; push-sum's global), then the send bits' planes.
_FAULT_ARGS = [_I, _U, _P, _P, _I, _I]
_SIGNATURES = {
    "gossip_pushsum_pool2_chunk": [_P] * 18 + [_I] * 4 + [_F, _I, _I]
                                  + _FAULT_ARGS + [_I, _P] + [_I, _P],
    "gossip_gossip_pool2_chunk": [_P] * 13 + [_I] * 7 + _FAULT_ARGS + [_P]
                                 + [_I, _P],
}


def _check(planes, dtypes, keys, offs, n: int) -> torch.device:
    if not 2 <= n <= MAX_POOL2_NODES:
        raise ValueError(f"n must lie in [2, {MAX_POOL2_NODES}], got {n}")
    return fused_pool._check(planes, dtypes, keys, offs, n)


def _device_streams(start: int, cap: int, keys, offs, dev):
    """(rounds to queue, keys, offs on the card, ctrl, scratch, the padded
    keys on the host)."""
    cap, keys, offs = clamp_cap_and_pad(start, cap, keys, ((offs, 1),))
    rounds = max(0, cap - start)
    ctrl = torch.zeros(2, dtype=torch.int32, device=dev)
    scratch = torch.zeros(2 * (rounds + 1), dtype=torch.int32, device=dev)
    return (rounds, fused_pool._upload(keys, dev), fused_pool._upload(offs, dev),
            ctrl, scratch, keys)


def _no_revive(faults: Optional[Faults]) -> None:
    """The JAX tier refuses crash-recovery (``pool2_support``), and so do
    these kernels, whatever their device: a revival plane raises."""
    if faults is not None and faults.revive is not None:
        raise ValueError("crash-recovery (revive) runs on the chunked, sharded, "
                         "and VMEM fused stencil/pool engines only")


def _fault_args(faults: Optional[Faults], keys, start: int, n_pad: int, dev,
                pushsum: bool):
    """The entry points' failure-model arguments of one chunk (``keys`` the
    padded host keys; fused_pool.fault_args), then the send bits' two
    parities, n_pad / 8 bytes each; and the tensors they point into, which
    must outlive the host call that queues the launches."""
    needs = need_init = sends = None
    if faults is not None:
        needs, need_init = faults.needs(start, keys.shape[0])
        if needs is not None:
            needs = fused_pool._upload(needs, dev)
        sends = torch.empty(2 * (n_pad // 8), dtype=torch.uint8, device=dev)
    args = fused_pool.fault_args(faults, None if needs is None else needs.data_ptr(),
                                 need_init, start, n_pad, dev, pushsum)
    args.append(None if sends is None else sends.data_ptr())
    return args, (needs, sends)


def pushsum_pool2_chunk(state4, keys, offs, start: int, cap: int, *, n: int,
                        target: int, delta: float, term_rounds: int,
                        faults: Optional[Faults] = None):
    """Up to K = keys.shape[0] push-sum pool rounds from absolute round
    ``start``, stopping at ``cap`` or once ``target`` nodes converged: the
    contract of fused_pool.pushsum_pool_chunk, for 2 <= n <= 2**27.

    ``state4`` is (s, w, term, conv_i32) in the pool layout on one device;
    ``keys`` int64 [K, 2] and ``offs`` int32 [K, P] are CPU tensors.
    Returns (state4', rounds_executed) with rounds_executed a 0-dim int32
    tensor on the state's device; the inputs are left unchanged. ``faults``
    (the run's fused.Faults, None for a fault-free run with local
    termination) adds the drop gate, crash-stop with the quorum verdict and
    global termination."""
    dev = _check(state4, (torch.float32, torch.float32, torch.int32, torch.int32),
                 keys, offs, n)
    _no_revive(faults)
    if dev.type == "cpu":
        return pushsum_pool2_chunk_plain(
            state4, keys, offs, start, cap, n=n, target=target, delta=delta,
            term_rounds=term_rounds, faults=faults)
    rounds, keys_d, offs, ctrl, scratch, keys = _device_streams(start, cap, keys,
                                                                offs, dev)
    out = [torch.empty_like(x) for x in state4]
    # Ping/pong plane sets A and B: s, w and the packed term|conv plane.
    ab = [torch.empty_like(x) for x in state4[:3] * 2]
    fault_args, _keep = _fault_args(faults, keys, start, state4[0].numel(), dev, True)
    fused_pool._launch(
        "fused_pool2", "gossip_pushsum_pool2_chunk", _SIGNATURES["gossip_pushsum_pool2_chunk"],
        dev,
        (*state4, *out, *ab, keys_d, offs, ctrl, scratch),
        (n, state4[0].numel(), offs.shape[1], rounds, ctypes.c_float(delta),
         term_rounds, target, *fault_args),
    )
    pushsum_pool2_chunk.launches += 2 + rounds
    return tuple(out), ctrl[1]


def gossip_pool2_chunk(state3, keys, offs, start: int, cap: int, *, n: int,
                       target: int, rumor_target: int, suppress: bool,
                       faults: Optional[Faults] = None):
    """Gossip analog of ``pushsum_pool2_chunk``: ``state3`` is (count,
    active_i32, conv_i32), with conv read and returned as count >=
    rumor_target on real lanes; converged-target suppression is
    receiver-side; ``faults`` adds the drop gate and crash-stop."""
    dev = _check(state3, (torch.int32,) * 3, keys, offs, n)
    _no_revive(faults)
    if dev.type == "cpu":
        return gossip_pool2_chunk_plain(
            state3, keys, offs, start, cap, n=n, target=target,
            rumor_target=rumor_target, suppress=suppress, faults=faults)
    rounds, keys_d, offs, ctrl, scratch, keys = _device_streams(start, cap, keys,
                                                                offs, dev)
    out = [torch.empty_like(x) for x in state3]
    ab = [torch.empty_like(x) for x in state3[:2] * 2]  # count, active: A, B
    fault_args, _keep = _fault_args(faults, keys, start, state3[0].numel(), dev, False)
    fused_pool._launch(
        "fused_pool2", "gossip_gossip_pool2_chunk", _SIGNATURES["gossip_gossip_pool2_chunk"],
        dev,
        (*state3[:2], *out, *ab, keys_d, offs, ctrl, scratch),
        (n, state3[0].numel(), offs.shape[1], rounds, rumor_target, int(suppress),
         target, *fault_args),
    )
    gossip_pool2_chunk.launches += 2 + rounds
    return tuple(out), ctrl[1]


# Kernel launches queued by each wrapper (init + 1 per round + finish),
# counted where the kernel is launched and nowhere else.
pushsum_pool2_chunk.launches = 0
gossip_pool2_chunk.launches = 0
