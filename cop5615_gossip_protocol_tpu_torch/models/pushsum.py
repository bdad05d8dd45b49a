"""Push-sum (distributed averaging), one synchronous round at a time.

Every node holds (s, w) with s_i = i and w_i = 1; each round it halves its
mass, sends one half to a sampled partner, absorbs what arrived, and counts
consecutive sub-delta ratio changes on rounds it received something; after
``term_rounds`` such rounds it latches converged (program.fs:110-143).

Float32 results follow the JAX package's jitted round on the CPU, where XLA
flushes subnormal results to zero (``flush``): each half sent, each kept
half, each delivery add and each absorbed sum. A push-sum run with crashes
on a sparse graph drains cut-off live nodes into that range, so the flush
decides which of them keep any weight, and with it the estimate. XLA also
writes the kept w half as ``where(send_ok, w * 0.5, w)``, which equals
``w - w_send`` except where the half is flushed; the kept s half takes the
same form under pool, imp pool and scatter delivery and stays ``s -
s_send`` under stencil delivery (``halve_and_send``'s ``fold_s``), as the
JAX round's compiled form shows (tests/test_torch_c1_flush.py pins both).
Stencil delivery keeps ``w - w_send`` too under global termination, and
under the delay ring every delivery keeps both halves in the where form
(``fold_w``; tests/test_torch_dup_delay.py pins them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# The least normal float32: XLA's flush sends every result below it in
# magnitude to a zero of its sign.
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every value under FLT_MIN in magnitude sent to a zero of
    its sign, as XLA flushes a subnormal result on the CPU (csrc/faults.cuh
    ``flush`` on the card)."""
    return x * (x.abs() >= FLT_MIN)


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum in the order the JAX package's ``jnp.sum`` takes on the
    CPU: XLA rewrites a reduction of more than 32 elements into sums of
    32-element windows (the padding split between both ends, the smaller
    half in front), each from 0 in index order, and reduces the window
    sums the same way, every add flushed."""
    x = x.reshape(-1).to(torch.float32)
    while x.numel() > 32:
        pad = -x.numel() % 32
        rows = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, 32)
        x = torch.zeros(rows.shape[0], dtype=torch.float32, device=x.device)
        for col in range(32):
            x = flush(x + rows[:, col])
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for v in x:
        total = flush(total + v)
    return total


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


def halve_and_send(s, w, send_ok, fold_s: bool = True, fold_w: bool = True):
    """Returns (s_send, w_send, s_keep, w_keep), each flushed; nodes with
    send_ok False keep their whole mass. With ``fold_s`` (pool, imp pool
    and scatter delivery, and every delivery under the delay ring) the kept
    s half is ``where(send_ok, s * 0.5, s)``, and with ``fold_w`` (all but
    stencil delivery under global termination with no delay ring) the kept
    w half is; otherwise the kept half is ``x - x_send`` (the
    module docstring)."""
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    s_send = flush(torch.where(send_ok, s * 0.5, zero))
    w_send = flush(torch.where(send_ok, w * 0.5, zero))
    s_keep = flush(torch.where(send_ok, s * 0.5, s) if fold_s else s - s_send)
    w_keep = flush(torch.where(send_ok, w * 0.5, w) if fold_w else w - w_send)
    return s_send, w_send, s_keep, w_keep


def absorb(state: PushSumState, s_keep, w_keep, inbox_s, inbox_w, delta,
           term_rounds: int, global_termination: bool = False,
           valid=None) -> PushSumState:
    """Absorb one round of deliveries: the ratio change is measured pre- vs
    post-absorb, and only a round that received something moves the
    termination counter (local termination).

    ``global_termination`` replaces the latch with the global residual
    rule: conv becomes all-or-nothing, every node converged iff every
    node's |Δ(s/w)| <= delta * max(|s/w|, 1) this round, and term is left
    alone. ``valid`` (bool [n], optional) keeps pad slots out of that
    broadcast."""
    s_new, w_new = flush(s_keep + inbox_s), flush(w_keep + inbox_w)
    if global_termination:
        return absorb_global(state, s_new, w_new, delta, valid)
    return absorb_sums(state, s_new, w_new, inbox_w > 0, delta, term_rounds)


def absorb_global(state: PushSumState, s_new, w_new, delta,
                  valid=None) -> PushSumState:
    """``absorb`` under global termination, with the round's sums already
    taken."""
    delta_t = torch.tensor(delta, dtype=state.s.dtype)
    ratio_old = state.s / state.w
    tol = delta_t * torch.maximum(torch.abs(ratio_old),
                                  torch.ones((), dtype=state.s.dtype))
    stable = torch.abs(s_new / w_new - ratio_old) <= tol
    conv_new = stable.all().expand(state.conv.shape)
    if valid is not None:
        conv_new = conv_new & valid
    return PushSumState(s=s_new, w=w_new, term=state.term, conv=conv_new.clone())


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


def clip_scale(inbox_w, w_keep):
    """``robust_agg="clip"`` (the JAX runner's ``make_robust_clip_fn``): the
    factor of a receiver's inbox. It accepts at most cap = 2 * max(w_keep,
    1) of weight a round: an inbox over the cap scales both channels by cap
    / inbox_w, and one with inbox_w <= 0 is dropped (factor 0)."""
    one = torch.ones((), dtype=inbox_w.dtype, device=inbox_w.device)
    cap = flush(2.0 * torch.maximum(w_keep, one))
    over = inbox_w > cap
    scale = torch.where(over, flush(cap / torch.where(over, inbox_w, one)), one)
    return torch.where(inbox_w > 0, scale, torch.zeros_like(scale))


def fma32(a, b, c):
    """a * b + c in float32 with one rounding, as a fused multiply-add
    gives it: the product is exact in float64, the sum is rounded to odd
    there (its TwoSum error decides the last bit), and the one rounding to
    float32 is then the correct one."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(err > 0, torch.full_like(s, float("inf")),
                                         torch.full_like(s, float("-inf"))))
    s = torch.where((err != 0) & even & torch.isfinite(s), odd, s)
    return s.to(torch.float32)


def absorb_clipped(state: PushSumState, s_keep, w_keep, inbox_s, inbox_w,
                   scale, delta, term_rounds: int) -> PushSumState:
    """``absorb`` of the inboxes times the clip's ``scale`` (clip_scale):
    XLA contracts each kept half plus its scaled inbox into one fused
    multiply-add (fma32), flushed; the receipt test reads the scaled w
    inbox."""
    return absorb_sums(state, flush(fma32(inbox_s, scale, s_keep)),
                       flush(fma32(inbox_w, scale, w_keep)),
                       flush(inbox_w * scale) > 0, delta, term_rounds)
