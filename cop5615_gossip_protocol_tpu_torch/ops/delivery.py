"""Message delivery as masked circular shifts: offset pools on the implicit
full topology, static displacement classes on the lattices, and both on
imp2d/imp3d."""

from __future__ import annotations

import torch


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
        inbox = inbox + torch.roll(masked, int(off), dims=1)
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
        inbox = inbox + torch.roll(masked, int(d), dims=-1)
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
        inbox = inbox + torch.roll(masked, int(q), dims=1)
    for k, off in enumerate(pool_offs):
        masked = torch.where((is_extra & (choice == k))[None, :], channels, zero)
        inbox = inbox + torch.roll(masked, int(off), dims=1)
    return inbox
