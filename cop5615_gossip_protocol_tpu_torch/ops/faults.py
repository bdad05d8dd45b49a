"""Crash-stop, crash-recovery and quorum termination: the failure model's
host side.

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

Crash-recovery (``revive_rate``/``revive_schedule``, with a crash model):
each crashed node may get a revival round, a second int32 plane drawn from
``PRNGKey(cfg.seed)`` under ``REVIVE_TAG`` (and the death plane). Node i is
dead exactly during ``death[i] <= r < revive[i]``, and ``revive > death``
always. A revived node sends again; at the start of its revival round's
body a gossip node resets to (count 0, inactive, unconverged), and a
push-sum node under ``rejoin="fresh"`` to (s = its index, w = 0, term at
its initial value, unconverged), under ``"restore"`` to nothing: it takes
its parked (s, w) back (models/runner.make_revive_fn). ``revive_rate`` p:
each dead node rejoins each round after its death with probability p, a
geometric dead time of at least 1 round; ``revive_schedule``
"round:count,...": the first ``count`` nodes of one permutation that are
dead at each listed round (and not revived yet) rejoin there.

Under a crash model a run stops when the converged live nodes reach the
quorum of the live ones: ``sum(conv & alive(r)) >= quorum_need(sum(alive(r)))``
after round r. The need is ``alive - floor((1 - quorum) * alive)`` in
float32, integer-exact at quorum 1.0 for every population (a float32
``ceil(quorum * alive)`` is off by one above 2**24 nodes).

Byzantine adversaries (``byzantine_rate``/``byzantine_schedule`` with
``byzantine_mode``): each node gets an onset round, a third int32 plane drawn
from ``PRNGKey(cfg.seed)`` under ``BYZ_TAG`` alone; node i lies from round
``byz[i]`` on (NEVER: honest). ``byzantine_rate`` F: each node lies from
round 0 with probability F (``uniform < F``); ``byzantine_schedule``
"round:count,...": ``count`` nodes of one permutation turn at each listed
round. Adversaries stay alive and count toward the quorum. A lying push-sum
sender puts its mode's pair on the wire (``lie``) and keeps its honest
halves; a live gossip adversary's state takes its mode's override at the
end of its round (``override``).

The JAX package's ops/faults.py defines these; this is the port's own copy
of what it runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

from . import rng

# Death-plane fold_in tag, above every round index (max_rounds <= 2**30).
CRASH_TAG = 2**30 + 0xDEAD

# Revival-plane fold_in tag, beside CRASH_TAG.
REVIVE_TAG = 2**30 + 0xA11FE

# Byzantine-plane fold_in tag, beside both.
BYZ_TAG = 2**30 + 0xBAD0

# Death round of a node that never crashes: above any reachable round.
NEVER = np.int32(np.iinfo(np.int32).max)


class LifePlanes(NamedTuple):
    """The run's churn history: per-node death rounds, and the revival
    rounds of a recovery model (None without one)."""

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


def revival_plane(cfg, n: int) -> Optional[np.ndarray]:
    """int32 [n] revival rounds, NEVER where a node never rejoins (every
    node that never dies too), or None without a recovery model. Memoized
    like the death plane; treat the array as read-only."""
    if not cfg.revive_model:
        return None
    return _revival_plane_cached(cfg.seed, cfg.crash_rate, cfg.crash_schedule,
                                 cfg.revive_rate, cfg.revive_schedule, n)


@functools.lru_cache(maxsize=4)
def _revival_plane_cached(seed: int, crash_rate: float, crash_schedule,
                          revive_rate: float, revive_schedule,
                          n: int) -> np.ndarray:
    death = _death_plane_cached(seed, crash_rate, crash_schedule, n)
    key = rng.fold_in(rng.PRNGKey(seed), REVIVE_TAG)
    revive = np.full((n,), NEVER, np.int32)
    if revive_schedule is not None:
        # At each listed round, the first `count` nodes of one permutation
        # that are dead there and not revived yet rejoin.
        perm = rng.permutation(key, n).numpy()
        assigned = np.zeros((n,), bool)
        for rnd, count in parse_schedule(revive_schedule, "revive"):
            eligible = perm[(death[perm] < rnd) & (revive[perm] > rnd)
                            & ~assigned[perm]]
            if eligible.shape[0] < count:
                raise ValueError(
                    f"revive schedule rejoins {count} nodes at round {rnd} "
                    f"but only {eligible.shape[0]} are dead there"
                )
            chosen = eligible[:count]
            revive[chosen] = rnd
            assigned[chosen] = True
        return revive
    u = rng.uniform(key, (n,)).numpy().astype(np.float64)
    # A dead time D >= 1 rounds with P(D > k) = (1 - p)^k: the geometric's
    # inverse CDF, as the death plane's.
    dead_time = 1.0 + np.floor(np.log1p(-u) / np.log1p(-float(revive_rate)))
    rev = death.astype(np.int64) + dead_time.astype(np.int64)
    dead = death != NEVER
    revive[dead] = np.clip(rev, 0, int(NEVER)).astype(np.int32)[dead]
    return revive


def byzantine_plane(cfg, n: int) -> Optional[np.ndarray]:
    """int32 [n] adversary onset rounds, NEVER where a node stays honest,
    or None without a Byzantine model. Memoized like the death plane;
    treat the array as read-only."""
    if not cfg.byzantine_model:
        return None
    return _byzantine_plane_cached(cfg.seed, cfg.byzantine_rate,
                                   cfg.byzantine_schedule, n)


@functools.lru_cache(maxsize=4)
def _byzantine_plane_cached(seed: int, byzantine_rate: float,
                            byzantine_schedule, n: int) -> np.ndarray:
    key = rng.fold_in(rng.PRNGKey(seed), BYZ_TAG)
    if byzantine_schedule is not None:
        events = parse_schedule(byzantine_schedule, "byzantine")
        total = sum(c for _, c in events)
        if total > n:
            raise ValueError(
                f"byzantine schedule turns {total} nodes but the "
                f"population is {n}"
            )
        perm = rng.permutation(key, n).numpy()
        byz = np.full((n,), NEVER, np.int32)
        off = 0
        for rnd, count in events:
            byz[perm[off: off + count]] = rnd
            off += count
        return byz
    # Rate form: a fixed adversarial fraction, each node from round 0.
    u = rng.uniform(key, (n,)).numpy()
    return np.where(u < np.float32(byzantine_rate), 0, int(NEVER)).astype(np.int32)


def life_planes(cfg, n: int) -> Optional[LifePlanes]:
    """The run's churn history as host planes, or None without a crash
    model."""
    death = death_plane(cfg, n)
    if death is None:
        return None
    return LifePlanes(death=death, revive=revival_plane(cfg, n))


def pad_death_plane(death: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad to n_pad with death round 0: pad slots count as dead, so alive
    counts over a padded layout equal the population's."""
    if death.shape[0] == n_pad:
        return death
    return np.concatenate([death, np.zeros((n_pad - death.shape[0],), np.int32)])


def pad_revival_plane(revive: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad to n_pad with NEVER: pad slots die at round 0 and never rejoin."""
    if revive.shape[0] == n_pad:
        return revive
    return np.concatenate(
        [revive, np.full((n_pad - revive.shape[0],), NEVER, np.int32)])


def pad_byzantine_plane(byz: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad to n_pad with NEVER: pad slots stay honest."""
    if byz.shape[0] == n_pad:
        return byz
    return np.concatenate([byz, np.full((n_pad - byz.shape[0],), NEVER, np.int32)])


def byzantine_at(byz, round_idx):
    """Adversary mask of round ``round_idx`` (numpy or torch): from the
    onset round on; a turned node never reverts."""
    return byz <= round_idx


def lie(mode: str, s_send, w_send, s, w, lying):
    """The wire pair where ``lying`` (push-sum, the JAX runner's
    ``make_byz_send_fn``): mass_inflate sends the round-start (s, w) whole,
    mass_deflate the negated halves, garble the halves with the channels
    swapped; the honest halves elsewhere."""
    import torch

    if mode == "mass_inflate":
        return torch.where(lying, s, s_send), torch.where(lying, w, w_send)
    if mode == "mass_deflate":
        return torch.where(lying, -s_send, s_send), torch.where(lying, -w_send, w_send)
    return torch.where(lying, w_send, s_send), torch.where(lying, s_send, w_send)


def override(mode: str, lying, count, active, conv):
    """Gossip's (count, active, conv) with the live adversaries' override
    (``lying``; the JAX runner's ``make_byz_override_fn``): stale_rumor pins
    (0, active, unconverged), garble latches conv. Takes bool or int
    planes and returns the same kinds."""
    import torch

    if mode == "stale_rumor":
        return (torch.where(lying, torch.zeros_like(count), count),
                torch.where(lying, torch.ones_like(active), active),
                torch.where(lying, torch.zeros_like(conv), conv))
    return count, active, torch.where(lying, torch.ones_like(conv), conv)


def alive_at(death, round_idx, revive=None):
    """Alive mask for round ``round_idx`` (numpy or torch): dead exactly
    during ``death <= round_idx < revive``."""
    alive = death > round_idx
    if revive is not None:
        alive = alive | (revive <= round_idx)
    return alive


def revived_at(revive, round_idx):
    """Mask of the nodes whose revival round is ``round_idx``: the rejoin
    reset's trigger."""
    return revive == round_idx


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
                 quorum: float, revive_sorted: Optional[np.ndarray] = None
                 ) -> tuple[np.ndarray, int]:
    """The quorum needs of rounds start .. start + count - 1 (int32
    [count]) and the seed need at round start - 1, from the sorted death
    plane and, under a recovery model, the sorted revival plane: alive(r)
    = n - #(death <= r) + #(revive <= r) (a node revives only after it
    died), one search a plane a round, in integers."""
    # The queries in the plane's own dtype: a wider one would make numpy
    # convert the whole plane on every call.
    rounds = (start + np.arange(-1, count)).astype(death_sorted.dtype)
    alive = n - np.searchsorted(death_sorted, rounds, side="right")
    if revive_sorted is not None:
        alive = alive + np.searchsorted(revive_sorted, rounds, side="right")
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


@functools.lru_cache(maxsize=4)
def _sorted_revival_cached(seed: int, crash_rate: float, crash_schedule,
                           revive_rate: float, revive_schedule, n: int):
    return np.sort(_revival_plane_cached(seed, crash_rate, crash_schedule,
                                         revive_rate, revive_schedule, n))


def sorted_revival(cfg, n: int) -> Optional[np.ndarray]:
    """The revival plane sorted, or None without a recovery model."""
    if not cfg.revive_model:
        return None
    return _sorted_revival_cached(cfg.seed, cfg.crash_rate, cfg.crash_schedule,
                                  cfg.revive_rate, cfg.revive_schedule, n)


def freeze_dead(old, new, dead):
    """A round's state with the dead nodes' protocol state frozen: push-sum's
    term and conv, gossip's every plane keep ``old``'s values where ``dead``
    (bool [n]) is set, while push-sum's s and w take ``new``'s (the mass sent
    to a dead node parks there)."""
    import torch

    return type(new)(*(b if name in ("s", "w") else torch.where(dead, a, b)
                       for name, a, b in zip(new._fields, old, new)))


def rejoin(planes, rn, reset: bool, init_term: int):
    """The state at the start of the round whose revivals are ``rn`` (bool,
    the planes' shape; ``revived_at``): where ``reset`` holds (gossip
    always, push-sum under rejoin="fresh"), push-sum's (s, w, term, conv)
    take (the node's flat index, 0, ``init_term``, 0) and gossip's (count,
    active, conv) zeros; the planes as they are otherwise (the JAX runner's
    ``make_revive_fn``). Takes a canonical state or a tuple of padded
    planes (pad lanes never revive) and returns the same kind."""
    import torch

    if not reset or not bool(rn.any()):
        return planes
    if len(planes) == 4:
        s, w, t, c = planes
        ids = torch.arange(s.numel(), dtype=s.dtype, device=s.device).reshape(s.shape)
        new = (torch.where(rn, ids, s), torch.where(rn, torch.zeros_like(w), w),
               torch.where(rn, torch.full_like(t, init_term), t),
               torch.where(rn, torch.zeros_like(c), c))
    else:
        new = tuple(torch.where(rn, torch.zeros_like(x), x) for x in planes)
    return type(planes)(*new) if hasattr(planes, "_fields") else new
