"""Message delivery for offset-pool sampling on the implicit full topology."""

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
