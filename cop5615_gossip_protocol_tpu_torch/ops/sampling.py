"""Random partner selection.

On ``full``, each round draws ``pool_size`` shared displacements
(``pool_offsets``) and every node picks one of them with 4 bits of a packed
threefry word (``pool_choice_packed``); under scatter delivery every node
draws one word (``uniform_bits``) and shifts by it (``targets_full``). On an
explicit topology every node draws one word and takes the neighbour column
it selects (``targets_explicit``). The streams are the JAX package's, bit for bit:
round keys are ``fold_in(base, round)``, the pool folds in ``_POOL_TAG``,
and the choice words come straight off the round key on ``full`` and off
``imp_choice_key`` on imp2d/imp3d.
"""

from __future__ import annotations

import torch

from . import rng

# Version of the random-stream derivation scheme, the JAX package's: every
# checkpoint records it (utils/checkpoint.py).
STREAM_VERSION = 5

_POOL_TAG = 0x0FF5

# fold_in tag of the imp kinds' packed pool-choice words: their slot words
# come off the untagged round key, so the choice needs a stream of its own.
IMP_CHOICE_TAG = 0x1A77

POOL_CHOICE_BITS = 4  # supports pool_size in {2, 4, 8, 16}
POOL_PACK = 32 // POOL_CHOICE_BITS  # nodes per random word
POOL_TILE_ROWS = 512  # the TPU kernel's tile height; fixes the padded row count
_POOL_LANES = 128


def round_key(base_key, round_idx: int) -> torch.Tensor:
    """Key for one synchronous round: fold_in by the absolute round index,
    so chunking and resume cannot change the stream."""
    return rng.fold_in(base_key, round_idx)


def imp_choice_key(round_k) -> torch.Tensor:
    """Key of the imp pooled round's packed choice words."""
    return rng.fold_in(round_k, IMP_CHOICE_TAG)


def uniform_bits(key, n: int, device=None) -> torch.Tensor:
    """[n] uint32 words (as int64)."""
    return rng.bits(key, (n,), device=device)


def targets_explicit(bits: torch.Tensor, neighbors: torch.Tensor,
                     degree: torch.Tensor) -> torch.Tensor:
    """Partner index per node of an explicit (padded-row) topology: the
    slot is the unsigned word modulo max(degree, 1), and the partner that
    slot's neighbour column. Degree-0 rows return their padded column 0;
    callers mask such nodes out of sending."""
    slot = bits % degree.to(torch.int64).clamp(min=1)
    target = neighbors[:, 0]
    for k in range(1, neighbors.shape[1]):
        target = torch.where(slot == k, neighbors[:, k], target)
    return target


def targets_full(bits: torch.Tensor, node_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Partner j != i on the implicit complete graph: the uniform shift
    1 + word % (n - 1) in [1, n), taken mod n. The words are uint32 held in
    int64, so the modulo is the JAX package's uint32 one; n = 1 has no
    other node and every target is 0."""
    shift = 1 + bits % max(n - 1, 1)
    return (node_ids.to(torch.int64) + shift) % n


def pool_offsets(round_k, pool_size: int, n: int) -> torch.Tensor:
    """int32 ``[pool_size]`` offsets, each uniform on [1, n-1]: the round's
    shared displacement pool."""
    b = rng.bits(rng.fold_in(round_k, _POOL_TAG), (pool_size,))
    return (1 + b % (n - 1)).to(torch.int32)


def targets_pool(choice: torch.Tensor, offsets: torch.Tensor,
                 node_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Partner indices implied by (choice, offsets): node i sends to
    ``(i + offsets[choice[i]]) mod n``, the targets the pool round's masked
    rolls deliver to (delivery="matmul" delivers to them directly)."""
    shift = offsets.to(node_ids.device)[choice.to(torch.int64)]
    return (node_ids.to(torch.int64) + shift.to(torch.int64)) % n


def pool_rows(n: int) -> int:
    """Padded row count of the pool layout: the [rows, 128] grid covering n
    nodes, rounded to whole TPU-kernel tiles (the packed-choice geometry
    depends on it)."""
    rows_min = (n + _POOL_LANES - 1) // _POOL_LANES
    return ((rows_min + POOL_TILE_ROWS - 1) // POOL_TILE_ROWS) * POOL_TILE_ROWS


def pool_words(round_k, n: int, device=None) -> torch.Tensor:
    """uint32 ``[pool_rows(n) // POOL_PACK, 128]`` (as int64): the round's
    packed choice words."""
    return rng.bits(round_k, (pool_rows(n) // POOL_PACK, _POOL_LANES), device=device)


def choice_from_words(words: torch.Tensor, pool_size: int) -> torch.Tensor:
    """int32 ``[rows, 128]`` slots from packed words: node (row, lane) reads
    word[row // 8, lane] >> 4 * (row % 8), masked to the pool width."""
    rows = words.shape[0] * POOL_PACK
    expanded = words.repeat_interleave(POOL_PACK, dim=0)
    shift = POOL_CHOICE_BITS * (
        torch.arange(rows, device=words.device) % POOL_PACK
    )
    return ((expanded >> shift[:, None]) & (pool_size - 1)).to(torch.int32)


def pool_choice_packed(round_k, n: int, pool_size: int,
                       out_len: int | None = None, device=None) -> torch.Tensor:
    """int32 ``[out_len or n]`` pool slots for nodes 0.., 4 bits each out of
    the packed words; pool_size > 16 draws one full word per node instead
    (a stream of its own, which the kernels do not take)."""
    out_len = n if out_len is None else out_len
    if pool_size > 1 << POOL_CHOICE_BITS:
        return (uniform_bits(round_k, out_len, device) & (pool_size - 1)).to(
            torch.int32
        )
    flat = choice_from_words(pool_words(round_k, n, device), pool_size).reshape(-1)
    if out_len <= flat.shape[0]:
        return flat[:out_len]
    return torch.cat([flat, flat.new_zeros(out_len - flat.shape[0])])


# fold_in tags of the per-round drop gate and duplicate-delivery gate,
# folded into the round key.
GATE_TAG = 0x5EED
DUP_TAG = 0xD00B


def gate_threshold(rate: float) -> int:
    """uint32 threshold T with P(word < T) = rate (to 2**-32): a node whose
    gate word is below T drops its send this round."""
    return min(int(round(float(rate) * 2.0**32)), 2**32 - 1)


def send_gate(round_k, n: int, fault_rate: float, device=None):
    """bool [n], True where the node may send this round (the drop gate),
    or the constant True when fault_rate is 0: one word a node off
    fold_in(round key, GATE_TAG), against ``gate_threshold``."""
    if fault_rate <= 0.0:
        return True
    words = rng.bits(rng.fold_in(round_k, GATE_TAG), (n,), device=device)
    return words >= gate_threshold(fault_rate)


def dup_gate(round_k, n: int, dup_rate: float, device=None):
    """bool [n], True where the node's message is delivered twice this
    round (at-least-once delivery), or the constant False when dup_rate is
    0: one word a node off fold_in(round key, DUP_TAG), below
    ``gate_threshold``."""
    if dup_rate <= 0.0:
        return False
    words = rng.bits(rng.fold_in(round_k, DUP_TAG), (n,), device=device)
    return words < gate_threshold(dup_rate)
