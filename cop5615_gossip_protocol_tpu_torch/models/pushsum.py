"""Push-sum (distributed averaging), one synchronous round at a time.

Every node holds (s, w) with s_i = i and w_i = 1; each round it halves its
mass, sends one half to a sampled partner, absorbs what arrived, and counts
consecutive sub-delta ratio changes on rounds it received something; after
``term_rounds`` such rounds it latches converged (program.fs:110-143).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PushSumState(NamedTuple):
    s: torch.Tensor  # [n] float32 — running sum mass
    w: torch.Tensor  # [n] float32 — running weight mass
    term: torch.Tensor  # [n] int32 — consecutive sub-delta receipt rounds
    conv: torch.Tensor  # [n] bool — latched converged flag


def init_state(pop: int, initial_term: int, device=None) -> PushSumState:
    """s_i = i, w_i = 1, term = initial_term (1 under quirk Q4)."""
    return PushSumState(
        s=torch.arange(pop, dtype=torch.float32, device=device),
        w=torch.ones(pop, dtype=torch.float32, device=device),
        term=torch.full((pop,), initial_term, dtype=torch.int32, device=device),
        conv=torch.zeros(pop, dtype=torch.bool, device=device),
    )


def halve_and_send(s, w, send_ok):
    """Returns (s_send, w_send, s_keep, w_keep); nodes with send_ok False
    keep their whole mass."""
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    s_send = torch.where(send_ok, s * 0.5, zero)
    w_send = torch.where(send_ok, w * 0.5, zero)
    return s_send, w_send, s - s_send, w - w_send


def absorb(state: PushSumState, s_keep, w_keep, inbox_s, inbox_w, delta,
           term_rounds: int) -> PushSumState:
    """Absorb one round of deliveries: the ratio change is measured pre- vs
    post-absorb, and only a round that received something moves the
    termination counter (local termination)."""
    return absorb_sums(state, s_keep + inbox_s, w_keep + inbox_w, inbox_w > 0,
                       delta, term_rounds)


def absorb_sums(state: PushSumState, s_new, w_new, received, delta,
                term_rounds: int) -> PushSumState:
    """``absorb`` with the round's sums already taken: ``s_new``/``w_new``
    are the kept halves plus the deliveries, ``received`` whether any
    delivery carried weight."""
    delta = torch.tensor(delta, dtype=state.s.dtype)
    stable = torch.abs(s_new / w_new - state.s / state.w) <= delta
    term_new = torch.where(
        received, torch.where(stable, state.term + 1, 0), state.term
    ).to(torch.int32)
    conv_new = state.conv | (term_new >= term_rounds)
    return PushSumState(s=s_new, w=w_new, term=term_new, conv=conv_new)
