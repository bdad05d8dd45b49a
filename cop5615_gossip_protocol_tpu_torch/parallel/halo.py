"""The sharded compositions' wires, as in-process copies: the counterparts
of the JAX package's parallel/halo.py ``exchange_rows_batched`` (the
lattice compositions' ring halo exchange, one ppermute pair for every
plane), ``scatter_band_rows`` (the replicated-pool2 composition's banded
reduce_scatter plus margin ppermute) and of ``parallel/pool2_sharded.py``'s
gather ``exchange`` (one all_gather plus the mirrored margin rows); and
``replica_rows``, the imp composition's wire, which keeps one global copy
of its planes per device current by copying each shard's rows into the
other devices' copies.

Shard i owns global rows [i * rows_loc, (i + 1) * rows_loc) of a windowed
summary plane (push-sum's raw s and w, gossip's active plane). Every copy
lands on the destination shard's device, with no assumption that it is the
source's; shards that share a device share one gathered copy.
"""

from __future__ import annotations

import math

import torch


def band_segments(rows_loc: int, n_dev: int) -> int:
    """Segment count of the JAX package's banded reduce_scatter wire
    (gcd(rows_loc, n_dev)); its plan budgets one segment's send buffer."""
    return math.gcd(rows_loc, n_dev)


def band_rows(shards, start: int, count: int, device) -> torch.Tensor:
    """Rows [start, start + count) of the global plane, wrapped mod its row
    count R, copied from the shards that own them onto ``device``."""
    rows_loc = shards[0].shape[0]
    R = rows_loc * len(shards)
    out = torch.empty((count,) + tuple(shards[0].shape[1:]),
                      dtype=shards[0].dtype, device=device)
    g, done = start % R, 0
    while done < count:
        owner, r = divmod(g, rows_loc)
        take = min(rows_loc - r, count - done)
        out[done:done + take].copy_(shards[owner][r:r + take], non_blocking=True)
        g, done = (g + take) % R, done + take
    return out


def scatter_band_rows(items, rows_loc: int, margin: int, devices) -> list:
    """The reduce_scatter wire: for each destination shard s, one
    [rows_loc + margin, 128] band per (shards, base) item, the global rows
    [(s * rows_loc + base) mod R, + rows_loc + margin) of that plane (the
    rows the shard's pool-slot windows read: its core rows, shifted by the
    slot's band start ``base``, plus the margin). Returns bands[s][item]."""
    return [[band_rows(shards, s * rows_loc + base, rows_loc + margin, dev)
             for shards, base in items]
            for s, dev in enumerate(devices)]


def gather_rows(shards, margin: int, devices) -> list:
    """The all_gather wire: each destination shard's [R + margin, 128] copy
    of the whole plane, its rows [R, R + margin) mirroring rows [0, margin)
    (the JAX exchange's margin-extended copy). One copy per distinct
    destination device; returns copies[s]."""
    R = shards[0].shape[0] * len(shards)
    by_device = {}
    for dev in devices:
        if dev not in by_device:
            by_device[dev] = band_rows(shards, 0, R + margin, dev)
    return [by_device[dev] for dev in devices]


def ring_exchange(sets, H: int, rows_loc: int) -> list:
    """The ring halo wire over one extended plane set per shard (``sets[s]``
    its planes, [rows_loc + 2H, 128] each, middle rows [H, H + rows_loc)):
    each shard's left halo, rows [0, H), takes its left neighbour's last H
    middle rows and its right halo its right neighbour's first H, in ring
    order, which is global row order. Returns the copies as groups of
    (destinations, sources), int32 views of the preallocated planes, one
    group per (destination, source) device pair, for
    ``exchange_rows_batched``; with 2 shards both neighbours are one
    shard, and H may be a whole shard."""
    S = len(sets)
    groups = {}
    for s, planes in enumerate(sets):
        left, right = sets[(s - 1) % S], sets[(s + 1) % S]
        for p, plane in enumerate(planes):
            for dst, src in ((plane[:H], left[p][rows_loc:rows_loc + H]),
                             (plane[H + rows_loc:], right[p][H:2 * H])):
                dsts, srcs = groups.setdefault((dst.device, src.device), ([], []))
                dsts.append(dst.view(torch.int32))
                srcs.append(src.view(torch.int32))
    return list(groups.values())


def replica_rows(planes_of: dict, rows_loc: int, devices) -> list:
    """The wire over one global plane set per device (``planes_of[dev]``
    its planes, [R, 128] each, in one order on every device), shard s (on
    ``devices[s]``) owning rows [s * rows_loc, (s + 1) * rows_loc): each
    shard's rows of its device's planes copied into the same rows of every
    other device's. Returns the copies as groups of (destinations,
    sources), int32 views of the preallocated planes, one group per
    (destination, source) device pair, for ``exchange_rows_batched``; none
    when every shard shares one device."""
    groups = {}
    for s, src_dev in enumerate(devices):
        rows = slice(s * rows_loc, (s + 1) * rows_loc)
        for dst_dev, planes in planes_of.items():
            if dst_dev == src_dev:
                continue
            dsts, srcs = groups.setdefault((dst_dev, src_dev), ([], []))
            for dst, src in zip(planes, planes_of[src_dev]):
                dsts.append(dst[rows].view(torch.int32))
                srcs.append(src[rows].view(torch.int32))
    return list(groups.values())


def exchange_rows_batched(groups) -> None:
    """Queue a wire's copies (``ring_exchange``'s or ``replica_rows``'
    groups), one batched copy per group, into preallocated rows: no
    allocation."""
    for dsts, srcs in groups:
        torch._foreach_copy_(dsts, srcs, non_blocking=True)
