"""The shard kernels' addressing (cop5615_gossip_protocol_tpu_torch/
csrc/pool2.cuh: local_column_origin, shard_column_origin, slot_reads),
built for the host with g++ into a tiny shared library and called through
ctypes, and the wire that puts the sources there on several devices
(parallel/halo.band_replica_rows, replica_rows).

For every destination of every shard, under several displacements (the
wrap column, a shard boundary, the ends of [1, n - 1]) and every pool
slot, the shim walks the shard's packed-word columns as the kernels do and
gives each destination's global index, the flat index of its mod-n source
in the device's global summary plane and whether the source chose the
slot; they must be the plain version's reads (pool2_sharded._slot_reads):
the source's own global index, no modulo. Then, with the shards placed on
several stand-in devices, a plane whose value is its own flat index, held
by each device only on its own rows, must hold after the wire every source
a device's shards read on a hit, with no more rows copied per device than
the JAX wire's bands (reduce_scatter) or gathered copy (all_gather)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cop5615_gossip_protocol_tpu_torch.ops import fused_pool
from cop5615_gossip_protocol_tpu_torch.parallel import halo, pool2_sharded

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include "pool2.cuh"
using namespace gossip::pool2;
// Per local destination l of the rows [row0, row0 + rows): its global
// index, the flat index of its source under slot `slot` (displacement d)
// and whether that source chose the slot, as the kernels walk them.
extern "C" void device_reads(int n, int row0, int rows, int d, unsigned k1,
                             unsigned k2, int pool_size, int slot, int* j_out,
                             int* at_out, int* hit_out) {
  for (int col = 0; col < rows / kPack * kLanes; ++col) {
    const int j0 = shard_column_origin(col, row0), l0 = local_column_origin(col);
    int at[kPack];
    bool hit[kPack];
    slot_reads(j0, d, n, k1, k2, pool_size, slot, at, hit);
    for (int sub = 0; sub < kPack; ++sub) {
      const int l = l0 + sub * kLanes;
      j_out[l] = j0 + sub * kLanes;
      at_out[l] = at[sub];
      hit_out[l] = hit[sub] ? 1 : 0;
    }
  }
}
"""

# (n, shards, pool_size): a padded layout whose band margin nearly fills a
# shard, padded and unpadded layouts in 4 and 8 shards, and the streaming
# tier's first n (65,535 pad lanes).
CASES = ((70_000, 2, 2), (120_000, 4, 2), (120_000, 8, 4), (131_072, 4, 2),
         (131_072, 8, 2), (2**21 + 1, 2, 2))


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pool2_shard_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.device_reads.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_uint] * 2
                                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    return so


def _offs(n, rows_loc, rng, count):
    """Displacements in [1, n - 1]: the ends, one row, half the ring, a
    shard boundary and just past it, and random ones."""
    fixed = [1, n - 1, 128, n // 2, rows_loc * 128, rows_loc * 128 + 5]
    return [d for d in fixed if d <= n - 1] + rng.integers(1, n, size=count).tolist()


def _plain_reads(keys, offs, row0, rows, R, n):
    return [(hit.numpy(), src.numpy()) for hit, src in pool2_sharded._slot_reads(
        keys, offs, row0, rows, R, n, torch.device("cpu"))]


@pytest.mark.parametrize("n,S,P", CASES)
def test_slot_reads_are_the_plain_reads(shim, n, S, P):
    layout = fused_pool.build_pool_layout(n)
    R, rows_loc = layout.rows, layout.rows // S
    rng = np.random.default_rng(n + S)
    offs = _offs(n, rows_loc, rng, 2 if n > 2**20 else 4)
    out = [np.empty(rows_loc * 128, np.int32) for _ in range(3)]
    wraps = 0
    for s in range(S):
        row0 = s * rows_loc
        keys = rng.integers(0, 2**32, size=2).tolist()
        # Every P-slot group of the displacements, each slot of it.
        for g in range(0, len(offs) - P + 1, P):
            group = offs[g:g + P]
            plain = _plain_reads(keys, group, row0, rows_loc, R, n)
            for slot, d in enumerate(group):
                shim.device_reads(n, row0, rows_loc, d, keys[0], keys[1], P, slot,
                                  *(ctypes.c_void_p(x.ctypes.data) for x in out))
                j, at, hit = out
                assert (j == row0 * 128 + np.arange(rows_loc * 128)).all()
                want_hit, want_src = plain[slot]
                assert (at == want_src).all()
                assert (at == np.where(j >= d, j - d, j - d + n)).all()
                assert ((at >= 0) & (at < R * 128)).all()
                assert (hit.astype(bool) == want_hit).all()
                # The column the mod-n wrap cuts through: j0 < d <= j0 + 896.
                j0 = j.reshape(-1, 8, 128)[:, 0, :]
                wraps += int(((j0 < d) & (d <= j0 + 7 * 128)).sum())
    assert wraps > 0


def _labels(S, kind):
    return {"own": tuple(f"d{s}" for s in range(S)),
            "pairs": tuple(f"d{s % 2}" for s in range(S))}[kind]


@pytest.mark.parametrize("kind", ["own", "pairs"])
@pytest.mark.parametrize("n,S,P", CASES[:5])
def test_the_wire_delivers_every_source_read(n, S, P, kind):
    layout = fused_pool.build_pool_layout(n)
    R, rows_loc = layout.rows, layout.rows // S
    ME = pool2_sharded.band_margin(layout)
    placed = pool2_sharded.place_shards(_labels(S, kind), rows_loc)
    owners = [g.device for g in placed for _ in range(g.rows // rows_loc)]
    rng = np.random.default_rng(n + S + P)
    value = torch.arange(R * 128, dtype=torch.int32).reshape(R, 128)
    for wire in ("reduce_scatter", "all_gather"):
        offs = _offs(n, rows_loc, rng, 2)[:P]
        keys = rng.integers(0, 2**32, size=2).tolist()
        planes = {}
        for g in placed:
            plane = torch.full((R, 128), -1, dtype=torch.int32)
            plane[g.row0:g.row0 + g.rows] = value[g.row0:g.row0 + g.rows]
            planes[g.device] = (plane,)
        if wire == "reduce_scatter":
            groups = halo.band_replica_rows(planes, rows_loc, owners,
                                            pool2_sharded.band_starts(offs, layout),
                                            rows_loc + ME)
            # The JAX wire: P bands of rows_loc + ME rows a shard.
            budget = {g.device: P * (rows_loc + ME) * g.rows // rows_loc for g in placed}
        else:
            groups = halo.replica_rows(planes, rows_loc, owners)
            budget = {g.device: R + 16 for g in placed}  # the gathered copy, at least
        copied = {g.device: 0 for g in placed}
        for dsts, _ in groups:
            for x in dsts:
                dev = next(k for k, (p,) in planes.items()
                           if x.untyped_storage().data_ptr() == p.untyped_storage().data_ptr())
                copied[dev] += x.shape[0]
        assert all(copied[d] <= budget[d] for d in copied), (copied, budget)
        halo.exchange_rows_batched(groups)
        for g in placed:
            flat = planes[g.device][0].reshape(-1).numpy()
            for hit, src in _plain_reads(keys, offs, g.row0, g.rows, R, n):
                assert (flat[src[hit]] == src[hit]).all()
    # With every shard on one device there is nothing to copy.
    one = {"d0": (value.clone(),)}
    assert halo.band_replica_rows(one, rows_loc, ["d0"] * S, [0, 8], rows_loc + ME) == []
    assert halo.replica_rows(one, rows_loc, ["d0"] * S) == []


def test_place_shards_keeps_a_device_on_consecutive_rows():
    place = pool2_sharded.place_shards
    assert place(["a", "b", "a", "b"], 16) == [
        pool2_sharded.DeviceRows("a", 0, 32), pool2_sharded.DeviceRows("b", 32, 32)]
    assert place(["b", "a", "a"], 8) == [
        pool2_sharded.DeviceRows("b", 0, 8), pool2_sharded.DeviceRows("a", 8, 16)]
    assert place(["c"] * 4, 8) == [pool2_sharded.DeviceRows("c", 0, 32)]
