"""Gossip (rumor spreading), one synchronous round at a time.

Every informed node sends the rumor to one sampled partner per round; a node
converges when its receipt count reaches the rumor target. Converged-target
suppression is applied receiver-side against the round-start conv vector,
element-wise identical to each sender probing its target (program.fs:92).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GossipState(NamedTuple):
    count: torch.Tensor  # [n] int32 — rumor receipt count
    active: torch.Tensor  # [n] bool — has heard the rumor
    conv: torch.Tensor  # [n] bool — count reached the target


def init_state(pop: int, leader: int, leader_counts_receipt: bool,
               device=None) -> GossipState:
    """Only the leader starts informed; on ``full`` in reference semantics
    its kickoff counts as receipt #1 (C13)."""
    active = torch.arange(pop, device=device) == int(leader)
    count = (active & leader_counts_receipt).to(torch.int32)
    return GossipState(
        count=count, active=active,
        conv=torch.zeros(pop, dtype=torch.bool, device=device),
    )


def send_values(state: GossipState, send_ok) -> torch.Tensor:
    """int32 delivery values: 1 per sent message this round."""
    return (state.active & send_ok).to(torch.int32)


def absorb(state: GossipState, inbox, rumor_target: int,
           suppress: bool = False) -> GossipState:
    """Receipt-count update; ``suppress`` drops a converged node's inbox."""
    if suppress:
        inbox = torch.where(state.conv, torch.zeros_like(inbox), inbox)
    count_new = state.count + inbox
    active_new = state.active | (inbox > 0)
    conv_new = count_new >= rumor_target
    return GossipState(count=count_new, active=active_new, conv=conv_new)
