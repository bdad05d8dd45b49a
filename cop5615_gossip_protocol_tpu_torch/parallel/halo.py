"""The sharded compositions' wires, as in-process copies into
preallocated rows: ``ring_exchange``, the lattice compositions' ring halo
(the counterpart of the JAX package's parallel/halo.py
``exchange_rows_batched``, one ppermute pair for every plane);
``replica_rows``, which keeps one global copy of a plane set per device
current by copying each shard's rows into the other devices' copies (the
imp composition's wire, and the replicated-pool2 composition's on the
all_gather plan, where the JAX package all_gathers the windowed summary);
and ``band_replica_rows``, the replicated-pool2 composition's wire on the
reduce_scatter plan (the JAX banded reduce_scatter plus margin ppermute),
which copies into each device's global copy only the rows of its shards'
pool-slot bands that another device owns. ``exchange_rows_batched``
queues any of them.

Devices are named by keys (a ``torch.device``, or any label the caller
groups its planes by); copies between two keys run whatever devices their
tensors lie on, and shards that share a key share one copy, so with one
key there is nothing to copy.
"""

from __future__ import annotations

import math

import torch


def band_segments(rows_loc: int, n_dev: int) -> int:
    """Segment count of the JAX package's banded reduce_scatter wire
    (gcd(rows_loc, n_dev)); its plan budgets one segment's send buffer."""
    return math.gcd(rows_loc, n_dev)


def _add_copies(groups: dict, dst_key, src_key, dst_planes, src_planes,
                rows: slice) -> None:
    dsts, srcs = groups.setdefault((dst_key, src_key), ([], []))
    for dst, src in zip(dst_planes, src_planes):
        dsts.append(dst[rows].view(torch.int32))
        srcs.append(src[rows].view(torch.int32))


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
    """The wire over one global plane set per device key (``planes_of[key]``
    its planes, [R, 128] each, in one order under every key), row block s
    (rows [s * rows_loc, (s + 1) * rows_loc)) owned by ``devices[s]``: each
    block copied from its owner's planes into the same rows of every other
    key's. Returns the copies as groups of (destinations, sources), int32
    views of the preallocated planes, one group per (destination, source)
    pair, for ``exchange_rows_batched``; none when one key owns every
    block."""
    groups = {}
    for s, src_key in enumerate(devices):
        rows = slice(s * rows_loc, (s + 1) * rows_loc)
        for dst_key, planes in planes_of.items():
            if dst_key != src_key:
                _add_copies(groups, dst_key, src_key, planes, planes_of[src_key], rows)
    return list(groups.values())


def band_replica_rows(planes_of: dict, rows_loc: int, owners, starts, count: int) -> list:
    """The reduce_scatter wire in place, over one global plane set per
    device key as in ``replica_rows`` (``owners[s]`` the key owning row
    block s): for each key, the rows of its blocks' bands, [(s * rows_loc +
    start) mod R, + count) for each block s it owns and each ``start`` (a
    pool slot's band start), that another key owns, copied from that key's
    planes into the same rows of its own. Overlapping bands are copied once,
    and runs of rows of one owner in one copy. Returns the groups of
    ``replica_rows``' form; none when one key owns every block."""
    R = rows_loc * len(owners)
    groups = {}
    for dst_key, planes in planes_of.items():
        pieces = []
        for s, key in enumerate(owners):
            if key != dst_key:
                continue
            for start in starts:
                a = (s * rows_loc + start) % R
                pieces += [(a, min(a + count, R))] + ([(0, a + count - R)]
                                                      if a + count > R else [])
        pieces.sort()
        merged = []
        for a, b in pieces:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        for a, b in merged:
            while a < b:
                src_key = owners[a // rows_loc]
                end = min(b, (a // rows_loc + 1) * rows_loc)
                while end < b and owners[end // rows_loc] == src_key:
                    end = min(b, end + rows_loc)
                if src_key != dst_key:
                    _add_copies(groups, dst_key, src_key, planes, planes_of[src_key],
                                slice(a, end))
                a = end
    return list(groups.values())


def exchange_rows_batched(groups) -> None:
    """Queue a wire's copies (``ring_exchange``'s, ``replica_rows``' or
    ``band_replica_rows``' groups), one batched copy per group, into
    preallocated rows: no allocation. Counts the copies queued."""
    for dsts, srcs in groups:
        torch._foreach_copy_(dsts, srcs, non_blocking=True)
        exchange_rows_batched.copies += len(dsts)


# Plane copies queued by exchange_rows_batched, counted where they are queued.
exchange_rows_batched.copies = 0
