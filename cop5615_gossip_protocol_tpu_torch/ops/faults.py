"""Crash-stop and quorum termination: the failure model's host side.

Every node gets a death round at run start, an int32 plane drawn from
``PRNGKey(cfg.seed)`` under ``CRASH_TAG`` alone, so every engine rebuilds
the same plane from the config. Node i is alive during round r iff
``death[i] > r``. Dead nodes never send; push-sum mass sent to a dead node
still lands in its (s, w), so total mass over live and dead nodes is
conserved, but its protocol state (term and conv; gossip's count, active
and conv) is frozen.

``crash_rate`` p: each node survives each round with probability 1 - p, a
geometric death round by inverse CDF of one uniform draw a node.
``crash_schedule`` "round:count,...": exactly ``count`` distinct nodes,
taken in the order of one permutation, die at each listed round.

Under a crash model a run stops when the converged live nodes reach the
quorum of the live ones: ``sum(conv & alive(r)) >= quorum_need(sum(alive(r)))``
after round r. The need is ``alive - floor((1 - quorum) * alive)`` in
float32, integer-exact at quorum 1.0 for every population (a float32
``ceil(quorum * alive)`` is off by one above 2**24 nodes).

The JAX package's ops/faults.py defines these; this is the port's own copy
of what it runs (revival, Byzantine nodes and their tags are not ported:
``LifePlanes.revive`` is always None here).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

from . import rng

# Death-plane fold_in tag, above every round index (max_rounds <= 2**30).
CRASH_TAG = 2**30 + 0xDEAD

# Death round of a node that never crashes: above any reachable round.
NEVER = np.int32(np.iinfo(np.int32).max)


class LifePlanes(NamedTuple):
    """The run's churn history: per-node death rounds; ``revive`` (the
    revival rounds of a recovery model) is None in the port."""

    death: np.ndarray  # int32 [n]
    revive: Optional[np.ndarray]


def parse_schedule(spec: str, kind: str = "crash") -> tuple[tuple[int, int], ...]:
    """Parse "round:count,round:count,..." into sorted (round, count)
    pairs. Rounds must be distinct non-negative ints, counts positive;
    ``kind`` names the schedule in the error texts."""
    events = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"{kind} schedule entry {token!r} is not 'round:count'"
            )
        try:
            rnd, count = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"{kind} schedule entry {token!r} is not 'round:count' "
                "with integer fields"
            ) from None
        if rnd < 0:
            raise ValueError(f"{kind} schedule round {rnd} must be >= 0")
        if count <= 0:
            raise ValueError(f"{kind} schedule count {count} must be > 0")
        events.append((rnd, count))
    if not events:
        raise ValueError(f"{kind} schedule {spec!r} has no entries")
    rounds = [r for r, _ in events]
    if len(set(rounds)) != len(rounds):
        raise ValueError(f"{kind} schedule {spec!r} repeats a round")
    return tuple(sorted(events))


def parse_crash_schedule(spec: str) -> tuple[tuple[int, int], ...]:
    return parse_schedule(spec, "crash")


def death_plane(cfg, n: int) -> Optional[np.ndarray]:
    """int32 [n] death rounds, or None without a crash model. Memoized on
    the knobs it reads; treat the array as read-only."""
    if not cfg.crash_model:
        return None
    return _death_plane_cached(cfg.seed, cfg.crash_rate, cfg.crash_schedule, n)


@functools.lru_cache(maxsize=4)
def _death_plane_cached(seed: int, crash_rate: float, crash_schedule,
                        n: int) -> np.ndarray:
    key = rng.fold_in(rng.PRNGKey(seed), CRASH_TAG)
    if crash_schedule is not None:
        events = parse_crash_schedule(crash_schedule)
        total = sum(c for _, c in events)
        if total > n:
            raise ValueError(
                f"crash schedule kills {total} nodes but the population "
                f"is {n}"
            )
        perm = rng.permutation(key, n).numpy()
        death = np.full((n,), NEVER, np.int32)
        off = 0
        for rnd, count in events:
            death[perm[off: off + count]] = rnd
            off += count
        return death
    u = rng.uniform(key, (n,)).numpy().astype(np.float64)
    # P(death >= k) = (1 - p)^k: the geometric's inverse CDF.
    death = np.floor(np.log1p(-u) / np.log1p(-float(crash_rate)))
    return np.clip(death, 0, float(NEVER)).astype(np.int32)


def life_planes(cfg, n: int) -> Optional[LifePlanes]:
    """The run's churn history as host planes, or None without a crash
    model."""
    death = death_plane(cfg, n)
    return None if death is None else LifePlanes(death=death, revive=None)


def pad_death_plane(death: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad to n_pad with death round 0: pad slots count as dead, so alive
    counts over a padded layout equal the population's."""
    if death.shape[0] == n_pad:
        return death
    return np.concatenate([death, np.zeros((n_pad - death.shape[0],), np.int32)])


def alive_at(death, round_idx):
    """Alive mask for round ``round_idx`` (numpy or torch): dead from the
    death round on."""
    return death > round_idx


def quorum_need(alive_count, quorum: float):
    """Converged live nodes that end the run: ``alive - floor((1 - quorum)
    * alive)``, the slack in float32 (the subtraction and the product) as
    the JAX package computes it. Takes an int or an int array; returns the
    same kind (int32 values)."""
    ac = np.asarray(alive_count, dtype=np.int32)
    slack = np.floor(
        (np.float32(1.0) - np.float32(quorum)) * ac.astype(np.float32)
    )
    need = ac - slack.astype(np.int32)
    return int(need) if need.ndim == 0 else need


def quorum_needs(death_sorted: np.ndarray, n: int, start: int, count: int,
                 quorum: float) -> tuple[np.ndarray, int]:
    """The quorum needs of rounds start .. start + count - 1 (int32
    [count]) and the seed need at round start - 1, from the sorted death
    plane: alive(r) = n - #(death <= r), one search a round."""
    # The queries in the plane's own dtype: a wider one would make numpy
    # convert the whole plane on every call.
    rounds = (start + np.arange(-1, count)).astype(death_sorted.dtype)
    alive = n - np.searchsorted(death_sorted, rounds, side="right")
    need_init = quorum_need(int(alive[0]), quorum)
    alive = alive[1:]
    return quorum_need(alive.astype(np.int32), quorum).reshape(-1), need_init


@functools.lru_cache(maxsize=4)
def _sorted_cached(seed: int, crash_rate: float, crash_schedule, n: int):
    return np.sort(_death_plane_cached(seed, crash_rate, crash_schedule, n))


def sorted_death(cfg, n: int) -> Optional[np.ndarray]:
    """The death plane sorted (``quorum_needs``' input), or None without a
    crash model. Memoized like the plane."""
    if not cfg.crash_model:
        return None
    return _sorted_cached(cfg.seed, cfg.crash_rate, cfg.crash_schedule, n)


def freeze_dead(old, new, dead):
    """A round's state with the dead nodes' protocol state frozen: push-sum's
    term and conv, gossip's every plane keep ``old``'s values where ``dead``
    (bool [n]) is set, while push-sum's s and w take ``new``'s (the mass sent
    to a dead node parks there)."""
    import torch

    return type(new)(*(b if name in ("s", "w") else torch.where(dead, a, b)
                       for name, a, b in zip(new._fields, old, new)))
