"""The shard kernels' addressing helpers (cop5615_gossip_protocol_tpu_torch/
csrc/pool2.cuh: local_column_origin, shard_column_origin, wire_row,
wire_index), built for the host with g++ into a tiny shared library and
called through ctypes. For every destination of every shard, under several
displacements, the shim walks the shard's packed-word columns as the
kernels do and gives each destination's global index, its mod-n source and
where that source sits in the delivered summary; a plane whose value is its
own flat index, delivered by the port's wires (parallel/halo.py), must hold
the source there: every slot's band on the reduce_scatter wire, the whole
copy on the all_gather wire."""

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
// Per local destination l of the shard at row0: its global index, its
// mod-n source under d and that source's flat index in a summary whose
// rows start at global row (row0 + base) mod R.
extern "C" void shard_reads(int n, int R, int row0, int rows_loc, int d, int base,
                            int* j_out, int* src_out, int* at_out) {
  for (int col = 0; col < rows_loc / kPack * kLanes; ++col) {
    const int j0 = shard_column_origin(col, row0), l0 = local_column_origin(col);
    for (int sub = 0; sub < kPack; ++sub) {
      const int l = l0 + sub * kLanes, j = j0 + sub * kLanes;
      j_out[l] = j;
      src_out[l] = gossip::class_source(j, d, n);
      at_out[l] = wire_index(src_out[l], row0, base, R);
    }
  }
}
"""

# (n, shards): a padded layout whose band margin nearly fills a shard, two
# padded and one unpadded band geometry, and the streaming tier's first n.
CASES = ((70_000, 2), (120_000, 4), (131_072, 4), (2**21 + 1, 2))


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
    so.shard_reads.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    return so


def _reads(shim, n, R, row0, rows_loc, d, base):
    out = [np.empty(rows_loc * 128, np.int32) for _ in range(3)]
    shim.shard_reads(n, R, row0, rows_loc, d, base,
                     *(ctypes.c_void_p(x.ctypes.data) for x in out))
    return out


@pytest.mark.parametrize("n,S", CASES)
def test_every_source_is_read_where_the_wire_put_it(shim, n, S):
    layout = fused_pool.build_pool_layout(n)
    R, rows_loc = layout.rows, layout.rows // S
    ME = pool2_sharded.band_margin(layout)
    assert ME <= rows_loc
    plane = torch.arange(layout.n_pad, dtype=torch.int32).reshape(R, 128)
    shards = [plane[s * rows_loc:(s + 1) * rows_loc] for s in range(S)]
    devices = [torch.device("cpu")] * S
    gathered = halo.gather_rows(shards, 256 + 16, devices)
    rng = np.random.default_rng(n)
    offs = [1, n - 1, 128, n // 2] + rng.integers(1, n, size=4).tolist()
    bases = pool2_sharded.band_starts(offs, layout)
    bands = halo.scatter_band_rows([(shards, b) for b in bases], rows_loc, ME, devices)
    for s in range(S):
        row0 = s * rows_loc
        for k, (d, base) in enumerate(zip(offs, bases)):
            j, src, at = _reads(shim, n, R, row0, rows_loc, d, base)
            assert (j == row0 * 128 + np.arange(rows_loc * 128)).all()
            want = np.where(j >= d, j - d, j - d + n)
            assert (src == want).all()
            band = bands[s][k].reshape(-1).numpy()
            assert bands[s][k].shape == (rows_loc + ME, 128)
            assert ((at >= 0) & (at < band.size)).all()
            assert (band[at] == src).all()
            # The gather wire: the whole copy, base (R - row0) mod R.
            j, src, at = _reads(shim, n, R, row0, rows_loc, d, (R - row0) % R)
            assert (gathered[s].reshape(-1).numpy()[at] == src).all()
