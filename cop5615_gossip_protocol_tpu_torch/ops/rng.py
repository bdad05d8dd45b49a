"""Counter-based random stream: ``jax.random``'s default threefry2x32 with
``jax_threefry_partitionable=True``, reproduced bit for bit in torch.

A key is an int64 tensor ``[2]`` holding two uint32 words, the same data
``jax.random.PRNGKey`` holds. torch on the CPU implements neither ``+``,
``<<``, ``>>`` nor ``%`` on ``torch.uint32``, so every word here lives in
int64 and is masked back to 32 bits after each add and shift. The CUDA
kernels compute the same hash in uint32 (csrc/threefry.cuh).

Partitionable streams hash each element's flat position ``i`` as the
counter pair ``(hi32(i), lo32(i))``, so any slice of a draw can be computed
on its own (the kernels draw their words tile by tile).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under key
    (k1, k2). Operands are int64 tensors or Python ints holding uint32
    values, broadcast against each other; returns the output pair."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _words(key):
    """(k1, k2) of a key as Python ints."""
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 — jax.random's name
    """Key data for an integer seed: the seed's 64-bit pattern split into
    (high, low) words, as ``jax.random.PRNGKey`` builds it for a Python int
    (identical under 32- and 64-bit JAX for 0 <= seed < 2**31)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed at counter (0, uint32(data))."""
    k1, k2 = _words(key)
    a, b = threefry2x32(k1, k2, 0, int(data) & MASK)
    return torch.tensor([int(a), int(b)], dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key i is the hash at counter
    (0, i). Returns int64 ``[num, 2]``."""
    k1, k2 = _words(key)
    a, b = threefry2x32(k1, k2, 0, torch.arange(num, dtype=torch.int64))
    return torch.stack([a, b], dim=1)


def bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32): each flat position i hashed at (hi32(i), lo32(i)) and the
    output pair xor-folded."""
    k1, k2 = _words(key)
    if isinstance(shape, int):
        shape = (shape,)
    count = 1
    for d in shape:
        count *= int(d)
    i = torch.arange(count, dtype=torch.int64, device=device)
    a, b = threefry2x32(k1, k2, i >> 32, i & MASK)
    return (a ^ b).reshape(tuple(shape))


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``: two
    draws from the split key, combined as hi * (2**32 mod span) + lo mod
    span in wrapping uint32 arithmetic (jax _src/random.py _randint)."""
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    k_hi, k_lo = split(key, 2)
    higher = bits(k_hi, shape)
    lower = bits(k_lo, shape)
    multiplier = (((2**16 % span) ** 2) & MASK) % span
    offset = (((higher % span) * multiplier) & MASK) + lower % span
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): each word's
    top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    words = bits(key, shape, device=device)
    one = 0x3F800000
    return ((words >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def permutation(key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` stably sorted by
    fresh 32-bit words, ceil(3 ln n / ln(2**32 - 1)) times, each time under
    the second key of a split of the first. int64 [n]."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64)
    num_rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(num_rounds):
        key, subkey = split(key, 2)
        order = torch.sort(bits(subkey, (n,)), stable=True).indices
        x = x[order]
    return x
