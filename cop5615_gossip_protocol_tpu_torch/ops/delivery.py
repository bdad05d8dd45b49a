"""Message delivery: the scatter-add of values into their targets, the
scatter-free masked circular shifts (offset pools on the implicit full
topology, static displacement classes on the lattices, and both on
imp2d/imp3d), and delivery="matmul"'s delivery to explicit targets with
the matrix primitives beside it (``aggregate_full``, ``deliver_spmv``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pushsum import flush


def _add(inbox: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One delivery add, flushed where the sum is float (XLA flushes a
    subnormal sum on the CPU; models/pushsum.flush)."""
    out = inbox + x
    return flush(out) if out.is_floating_point() else out


def deliver(values: torch.Tensor, targets: torch.Tensor, n: int,
            base: torch.Tensor | None = None) -> torch.Tensor:
    """Sum ``values[..., i]`` into slot ``targets[i]`` of a fresh [..., n]
    inbox (``values`` is [m] or [C, m]; push-sum stacks s and w), in a
    fixed order on every device: each target's senders add in ascending
    sender index onto 0, the order of a serial scatter-add loop (and of the
    JAX package's ``zeros(n).at[targets].add(values)`` on the CPU); with
    ``base`` they add onto a copy of ``base`` instead (``base.at[targets]
    .add(values)``, the form XLA gives ``keep + deliver(...)`` inside the
    JAX package's jitted rounds).

    The senders are stable-sorted by target and each gets its rank inside
    its target's bucket; rank r = 0, 1, ... then adds in one indexed add,
    and no two senders of one rank share a target, so no level collides."""
    targets = targets.to(torch.int64)
    m = targets.shape[0]
    inbox = (values.new_zeros((*values.shape[:-1], n)) if base is None
             else base.clone())
    if m == 0:
        return inbox
    if not values.is_floating_point():
        # Integer sums are exact in any order.
        return inbox.index_add_(-1, targets, values)
    order = torch.sort(targets, stable=True).indices
    sorted_t = targets[order]
    counts = torch.bincount(targets, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=targets.device) - starts[sorted_t]
    for r in range(int(counts.max())):
        level = rank == r
        t, src = sorted_t[level], order[level]
        inbox[..., t] = _add(inbox[..., t], values[..., src])
    return inbox


def deliver_dup(deliver_fn, values: torch.Tensor, dup) -> torch.Tensor:
    """``deliver_fn(values)`` under the dup gate (``dup``, bool [n]: the
    dup-gated senders, or False/None for none): a gated sender's value
    lands twice, ``deliver_fn(v) + deliver_fn(where(dup, v, 0))``, the two
    inboxes summed apart and then added (the JAX runner's ``make_df``; XLA
    folds neither onto the other)."""
    inbox = deliver_fn(values)
    if dup is None or dup is False:
        return inbox
    return _add(inbox, deliver_fn(torch.where(dup, values, torch.zeros_like(values))))


def deliver_pool(channels: torch.Tensor, choice: torch.Tensor, offsets) -> torch.Tensor:
    """Scatter-free pool delivery: ``channels`` is [C, n] (push-sum stacks
    s and w, gossip uses C=1), ``choice`` each node's pool slot and
    ``offsets`` the round's K displacements (Python ints). The inbox is K
    masked circular shifts, accumulated in static slot order from zero:

        inbox[:, j] = sum over k of channels[:, j - o_k] * [choice[j - o_k] == k]
    """
    inbox = torch.zeros_like(channels)
    zero = torch.zeros((), dtype=channels.dtype, device=channels.device)
    for k, off in enumerate(offsets):
        masked = torch.where((choice == k)[None, :], channels, zero)
        inbox = _add(inbox, torch.roll(masked, int(off), dims=1))
    return inbox


def deliver_stencil(values: torch.Tensor, targets: torch.Tensor, offsets,
                    n: int) -> torch.Tensor:
    """Scatter-free delivery for offset-structured topologies: every edge
    displacement ``(target - sender) mod n`` lies in the sorted set
    ``offsets``, so the inbox is one masked circular shift per class,
    accumulated from zero in ascending class order:

        inbox[..., j] = sum over d of values[..., j - d] * [disp[j - d] == d]

    ``values`` is [n] or [C, n] (push-sum stacks s and w). A line's node
    n-1 never leaks onto node 0: no +1 edge leaves n-1, so its mask slot
    never fires."""
    ids = torch.arange(n, dtype=targets.dtype, device=targets.device)
    disp = torch.remainder(targets - ids, n)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    inbox = torch.zeros_like(values)
    for d in offsets:
        masked = torch.where(disp == int(d), values, zero)
        inbox = _add(inbox, torch.roll(masked, int(d), dims=-1))
    return inbox


def deliver_imp_pool(channels: torch.Tensor, d_sampled: torch.Tensor,
                     is_extra: torch.Tensor, choice: torch.Tensor,
                     lattice_offsets, pool_offs) -> torch.Tensor:
    """Rolls-only delivery on imp2d/imp3d under pooled long-range sampling:
    a node that sampled a lattice slot sends along its displacement, one
    that sampled its long-range slot along the round's pool displacement
    ``pool_offs[choice]``. The inbox sums from zero over the sorted lattice
    classes, then the pool slots in order:

        inbox = sum over q of roll(channels * [d_sampled == q], q)
              + sum over k of roll(channels * [is_extra & choice == k], pool_offs[k])

    ``channels`` is [C, n]; ``d_sampled`` the sampled modular displacement
    (-1 on the extra slot, so it never aliases a lattice class). A pool
    offset equal to a lattice displacement, or to another slot's, still
    delivers each send once: the masks are disjoint."""
    inbox = torch.zeros_like(channels)
    zero = torch.zeros((), dtype=channels.dtype, device=channels.device)
    for q in lattice_offsets:
        masked = torch.where((d_sampled == int(q))[None, :], channels, zero)
        inbox = _add(inbox, torch.roll(masked, int(q), dims=1))
    for k, off in enumerate(pool_offs):
        masked = torch.where((is_extra & (choice == k))[None, :], channels, zero)
        inbox = _add(inbox, torch.roll(masked, int(off), dims=1))
    return inbox


def deliver_pool_trimmed(channels: torch.Tensor, choice: torch.Tensor,
                         offsets) -> torch.Tensor:
    """``deliver_pool`` less, at each receiver with two or more
    contributing slots, the slot whose |w| (row 1 of the [2, n] (s, w)
    stack) is largest: ``robust_agg="trim"`` (the JAX package's
    ``deliver_pool_trimmed``). The dropped slot's (s, w) pair leaves
    together; a receiver's sole contribution stays. Ties keep the first
    slot; slot 0 is the first "largest" even when it carries nothing."""
    inbox = torch.zeros_like(channels)
    zero = torch.zeros((), dtype=channels.dtype, device=channels.device)
    best = torch.zeros_like(channels)
    best_absw = torch.full(channels.shape[1:], -1.0, dtype=channels.dtype,
                           device=channels.device)
    contribs = torch.zeros(channels.shape[1:], dtype=torch.int32,
                           device=channels.device)
    for k, off in enumerate(offsets):
        masked = torch.where((choice == k)[None, :], channels, zero)
        contrib = torch.roll(masked, int(off), dims=1)
        inbox = _add(inbox, contrib)
        absw = torch.abs(contrib[1])
        contribs = contribs + (absw > 0).to(torch.int32)
        better = absw > best_absw
        best = torch.where(better[None, :], contrib, best)
        best_absw = torch.maximum(best_absw, absw)
    drop = contribs >= 2
    return flush(inbox - torch.where(drop[None, :], best, zero))


# ---------------------------------------------------------------------------
# delivery="matmul" and the matrix delivery primitives (the JAX package's
# MXU tier, ops/delivery.py there).
# ---------------------------------------------------------------------------

MM_BLOCK = 128  # the JAX tier's tile edge: SpmvPlan's block


def deliver_matmul(values: torch.Tensor, targets: torch.Tensor,
                   n: int) -> torch.Tensor:
    """``inbox[..., j] = sum over i of values[..., i] * [targets[i] == j]``:
    the function of the JAX package's ``deliver_matmul`` (a blocked one-hot
    dot_general there). ``values`` is [n] or [C, n]; a target of -1 (a pad
    slot) matches no receiver: it lands in a slot n past the inbox, which
    is dropped.

    The float order is explicit and the same on every host and device:
    each receiver's senders add in ascending sender index onto 0, flushed,
    as ``deliver`` sums. The JAX tier's order is XLA's dot on the CPU: each
    receiver's sends ascend inside panels of senders (512 with the process
    on 8 CPUs, 256 on one) and the panels' sums are then added, so its
    float32 sums follow the host's thread count. The two agree bitwise
    where a receiver gets at most two sends (pool_size 2: two float adds
    commute) and on integer channels (exact in any order); elsewhere they
    are the same sum to float32 rounding. Integer channels stay integers
    here (the JAX tier round-trips them through float32, exact below
    2**24)."""
    targets = targets.to(torch.int64)
    return deliver(values, torch.where(targets < 0, n, targets), n + 1)[..., :n]


def aggregate_full(values: torch.Tensor) -> torch.Tensor:
    """The complete graph's adjacency-vector product in closed form: the
    adjacency is J - I, so ``inbox[j] = sum over i != j of values[i]`` is
    ``sum(values) - values`` along the last axis (the JAX package's
    ``aggregate_full``)."""
    return values.sum(dim=-1, keepdim=values.ndim > 1) - values


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """A static graph's in-edges as dense MM_BLOCK x MM_BLOCK adjacency
    tiles (block-sparse rows), built once on the host (``build_spmv_plan``):
    tile (s, r) holds A[i, j] for senders i of block s and receivers j of
    block r, stored packed ([T, 128, 128], tile 0 all zero), with each
    receiver block's padded tile list."""

    n: int
    nb: int
    tiles: np.ndarray  # [T, 128, 128] float32, tiles[0] == 0
    tile_ids: np.ndarray  # [nb, max_t] int32 indices into tiles (0 = pad)
    src_blocks: np.ndarray  # [nb, max_t] int32 sender block of each tile


def build_spmv_plan(indptr, indices, n: int) -> SpmvPlan:
    """The plan of a CSR of in-edges: ``indices[indptr[j]:indptr[j+1]]``
    lists the senders delivering into receiver j; parallel edges add up in
    their tile entry."""
    B = MM_BLOCK
    nb = -(-n // B)
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    tile_map: dict = {}
    for j in range(n):
        for i in indices[indptr[j]:indptr[j + 1]]:
            key = (int(i) // B, j // B)
            t = tile_map.get(key)
            if t is None:
                t = tile_map[key] = np.zeros((B, B), np.float32)
            t[int(i) % B, j % B] += 1.0
    tiles = [np.zeros((B, B), np.float32)]
    per_row: list = [[] for _ in range(nb)]
    for (sb, rb), tile in sorted(tile_map.items(), key=lambda kv: kv[0][::-1]):
        per_row[rb].append((len(tiles), sb))
        tiles.append(tile)
    max_t = max(1, max(len(row) for row in per_row))
    tile_ids = np.zeros((nb, max_t), np.int32)
    src_blocks = np.zeros((nb, max_t), np.int32)
    for rb, row in enumerate(per_row):
        for k, (tid, sb) in enumerate(row):
            tile_ids[rb, k] = tid
            src_blocks[rb, k] = sb
    return SpmvPlan(n=n, nb=nb, tiles=np.stack(tiles), tile_ids=tile_ids,
                    src_blocks=src_blocks)


def deliver_spmv(values: torch.Tensor, plan: SpmvPlan) -> torch.Tensor:
    """All-in-edge aggregation over the plan's static graph: ``inbox[...,
    j] = sum over in-neighbours i of j of values[..., i]``, ``values`` [n]
    or [C, n]. For each receiver block its stored tiles and their senders'
    value blocks contract in one ``torch.matmul`` (pad entries hit the zero
    tile 0), accumulating in float32 (float64 for float64 values) and cast
    back, as the JAX primitive does; a float sum's order is the matmul
    library's."""
    squeeze = values.ndim == 1
    ch = values[None, :] if squeeze else values
    B, n, nb = MM_BLOCK, plan.n, plan.nb
    acc_t = torch.float64 if ch.dtype == torch.float64 else torch.float32
    dev = ch.device
    ch_p = torch.zeros(ch.shape[0], nb * B, dtype=acc_t, device=dev)
    ch_p[:, :n] = ch.to(acc_t)
    vb = ch_p.reshape(ch.shape[0], nb, B)
    tiles = torch.as_tensor(plan.tiles, device=dev).to(acc_t)
    tile_ids = torch.as_tensor(plan.tile_ids, device=dev).to(torch.int64)
    src = torch.as_tensor(plan.src_blocks, device=dev).to(torch.int64)
    tf32 = (torch.backends.cuda.matmul.allow_tf32 if dev.type == "cuda"
            else None)
    try:
        if tf32 is not None:
            # The float32 contract: no TF32 inputs for this call.
            torch.backends.cuda.matmul.allow_tf32 = False
        # [nb, C, max_t * B] @ [nb, max_t * B, B] -> [nb, C, B]
        vt = vb[:, src, :].permute(1, 0, 2, 3).reshape(nb, ch.shape[0], -1)
        tt = tiles[tile_ids].reshape(nb, -1, B)
        blocks = torch.matmul(vt, tt)
    finally:
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    inbox = blocks.permute(1, 0, 2).reshape(ch.shape[0], nb * B)[:, :n]
    inbox = inbox.to(values.dtype)
    return inbox[0] if squeeze else inbox
