"""Message delivery: the scatter-add of values into their targets, and the
scatter-free masked circular shifts (offset pools on the implicit full
topology, static displacement classes on the lattices, and both on
imp2d/imp3d)."""

from __future__ import annotations

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
