"""Carry state, keys and topologies across from the JAX package, as numpy
arrays.

A JAX ``PushSumState``/``GossipState`` (or the padded planes its fused
kernels take) converted with ``np.asarray`` field by field becomes the
port's state here, so a run can be handed over mid-trajectory and the next
chunk compared; a JAX ``Topology`` becomes the port's, so both packages
run on one adjacency.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gossip import GossipState
from ..models.pushsum import PushSumState
from ..ops.topology import Topology

_FLOAT = {"s", "w"}
_FLAG = {"conv", "active"}


def state_from_numpy(state, device="cpu"):
    """Port state from a JAX state's fields as numpy arrays: a NamedTuple
    or a mapping with the fields of PushSumState (s, w, term, conv) or
    GossipState (count, active, conv). Canonical ``[n]`` fields keep their
    types (float32, int32, bool flags); padded ``[rows, 128]`` planes
    become the fused engine's planes (float32 s/w, int32 everything
    else)."""
    fields = dict(state._asdict() if hasattr(state, "_asdict") else state)
    if set(fields) == set(PushSumState._fields):
        kind = PushSumState
    elif set(fields) == set(GossipState._fields):
        kind = GossipState
    else:
        raise ValueError(
            f"fields {sorted(fields)} match neither PushSumState nor GossipState"
        )
    out = {}
    for name in kind._fields:
        arr = np.asarray(fields[name])
        if name in _FLOAT:
            dtype = np.float32
        elif name in _FLAG and arr.ndim == 1:
            dtype = np.bool_
        else:
            dtype = np.int32
        out[name] = torch.from_numpy(np.ascontiguousarray(arr.astype(dtype))).to(device)
    return kind(**out)


def key_from_numpy(key_data) -> torch.Tensor:
    """Port key (int64 [2] of uint32 words) from JAX key data (uint32 [2],
    e.g. ``np.asarray(jax.random.PRNGKey(seed))``)."""
    arr = np.asarray(key_data)
    if arr.shape != (2,):
        raise ValueError(f"key data must have shape (2,), got {arr.shape}")
    return torch.from_numpy(arr.astype(np.uint32).astype(np.int64))


def topology_from_numpy(topo) -> Topology:
    """Port topology from a JAX ``Topology``'s fields (or any object with
    kind, n, n_requested, target_count, max_deg, neighbors and degree):
    the neighbour table and degrees become int32 numpy arrays of their
    own, None stays None (the implicit ``full``). A host-sharded JAX build
    (a row slice of the adjacency) is refused."""
    rows_built = getattr(topo, "rows_built", None)
    if rows_built is not None and tuple(rows_built) != (0, topo.n):
        raise ValueError(
            f"a row slice {tuple(rows_built)} of the adjacency is not a topology"
        )

    def table(arr, shape):
        if arr is None:
            return None
        out = np.array(arr, dtype=np.int32, copy=True)
        if out.shape != shape:
            raise ValueError(f"expected shape {shape}, got {out.shape}")
        return out

    n, max_deg = int(topo.n), int(topo.max_deg)
    if (topo.neighbors is None) != (topo.degree is None):
        raise ValueError("neighbors and degree must both be given or both None")
    return Topology(
        kind=str(topo.kind), n=n, n_requested=int(topo.n_requested),
        target_count=int(topo.target_count), max_deg=max_deg,
        neighbors=table(topo.neighbors, (n, max_deg)),
        degree=table(topo.degree, (n,)),
    )
