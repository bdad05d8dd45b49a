"""The per-node helpers of the sharded imp kernels (cop5615_gossip_protocol_
tpu_torch/csrc/imp.cuh: imp_mark and the receivers' imp_pushsum_inbox and
imp_gossip_inbox), built for the host with g++ into a tiny shared library
and called through ctypes, the node loop of csrc/fused_imp_hbm_shard.cu's
prologue and absorb (which writes the same marks for the next round)
around them. Over row ranges that cut the 8-row choice groups anywhere,
the marks read through
ops/fused_imp.imp_dir_words must be the plain version's
(parallel/fused_imp_hbm_sharded.shard_marks_plain, push-sum and gossip),
and over a shard's receivers the inboxes must be the plain absorb's
(pushsum_inbox_plain bitwise, gossip_inbox_plain), at pool widths 4 and
16, with and without pad lanes."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from cop5615_gossip_protocol_tpu_torch import build_topology
from cop5615_gossip_protocol_tpu_torch.ops import fused, fused_imp, fused_pool, rng
from cop5615_gossip_protocol_tpu_torch.parallel import fused_imp_hbm_sharded as ih

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include "imp.cuh"
using namespace gossip;

static Classes lattice_of(const int* classes, int count) {
  Classes c;
  c.count = count;
  for (int k = 0; k < kMaxClasses; ++k) c.d[k] = k < count ? classes[k] : 0;
  return c;
}

// The prologue's (and an absorb's next-mark) loop over rows
// [row_lo, row_lo + rows).
extern "C" void shard_marks(const uint32_t* words, int n, int n_classes, unsigned k1,
                            unsigned k2, unsigned c1, unsigned c2, int pool_size,
                            int row_lo, int rows, const int* active, int8_t* out) {
  for (int l = 0; l < rows * kChoiceLanes; ++l) {
    const int j = row_lo * kChoiceLanes + l;
    out[l] = j < n && (active == nullptr || active[l] != 0)
                 ? imp_mark(words[j], k1, k2, c1, c2, j, pool_size, n_classes)
                 : (int8_t)-1;
  }
}

// The absorb kernels' inboxes over the receivers of rows [row_lo, + rows).
extern "C" void inboxes(const int* classes, int n_classes, const int* offs,
                        int pool_size, int n, const int8_t* mark, const float* s,
                        const float* w, int row_lo, int rows, float* in_s,
                        float* in_w, int* inbox) {
  const Classes lattice = lattice_of(classes, n_classes);
  ImpPool pool;
  pool.count = pool_size;
  for (int k = 0; k < kMaxImpPool; ++k) pool.d[k] = k < pool_size ? offs[k] : 0;
  for (int l = 0; l < rows * kChoiceLanes; ++l) {
    const int j = row_lo * kChoiceLanes + l;
    in_s[l] = in_w[l] = 0.0f;
    inbox[l] = 0;
    if (j >= n) continue;
    imp_pushsum_inbox(lattice, pool, mark, s, w, j, n, in_s[l], in_w[l]);
    inbox[l] = imp_gossip_inbox(lattice, pool, mark, j, n);
  }
}
"""

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("imp_shard_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(lib), str(d / "shim.cpp")],
                   check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.shard_marks.argtypes = [_P, _I, _I] + [_U] * 4 + [_I, _I, _I, _P, _P]
    so.inboxes.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P]
    return so


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr()) if x is not None else None


def _round(n, pool_size, rnd=7):
    key = rng.PRNGKey(3)
    return (fused.round_keys(key, rnd, 1)[0].tolist(),
            fused_pool.round_offsets(key, rnd, 1, pool_size, n)[0].tolist(),
            fused_imp.choice_round_keys(key, rnd, 1)[0].tolist())


@pytest.mark.parametrize("kind,n,pool_size", [("imp3d", 27_000, 4), ("imp2d", 65_536, 16),
                                              ("imp3d", 125_000, 16)])
def test_marks_and_inboxes_match_the_plain_versions(shim, kind, n, pool_size):
    topo = build_topology(kind, n)
    spec = fused_imp.imp_spec(topo)
    R = fused_pool.build_pool_layout(n).rows
    keys, offs, ckeys = _round(n, pool_size)
    classes = (ctypes.c_int * len(spec.classes))(*spec.classes)
    words = fused_imp.imp_dir_words(spec, R, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    active = (torch.rand(R, 128, generator=gen) < 0.5).to(torch.int32)
    # The whole ring's marks a shard range at a time, ranges cut anywhere.
    cuts = sorted({0, R, 5, 8, 13, R // 2, R // 2 + 3, R - 1} & set(range(R + 1)))
    marks = {}
    for gossip in (False, True):
        got = torch.empty(R, 128, dtype=torch.int8)
        for lo, hi in zip(cuts, cuts[1:]):
            act = active[lo:hi].contiguous() if gossip else None
            shim.shard_marks(_ptr(words), n, len(spec.classes), *keys, *ckeys, pool_size,
                             lo, hi - lo, _ptr(act), _ptr(got[lo:hi]))
            want = ih.shard_marks_plain(spec, keys, ckeys, pool_size, lo, hi - lo, act)
            assert torch.equal(got[lo:hi], want), (gossip, lo, hi)
        marks[gossip] = got
    assert ((marks[False] >= 0).sum() == n) and (marks[False] >= len(spec.classes)).any()
    # The inboxes of a shard's receivers off the push-sum marks.
    s = torch.rand(R, 128, generator=gen) + 1.0
    w = torch.rand(R, 128, generator=gen) + 0.5
    pool = (ctypes.c_int * pool_size)(*offs)
    rows, received = R // 4, 0
    for lo in (0, R // 2, R - rows):
        in_s, in_w = torch.empty(rows, 128), torch.empty(rows, 128)
        inbox = torch.empty(rows, 128, dtype=torch.int32)
        shim.inboxes(classes, len(spec.classes), pool, pool_size, n, _ptr(marks[False]),
                     _ptr(s), _ptr(w), lo, rows, _ptr(in_s), _ptr(in_w), _ptr(inbox))
        _, ws, ww = ih.pushsum_inbox_plain(marks[False], (s, w), offs, lo, rows, spec=spec)
        _, wi = ih.gossip_inbox_plain(marks[False], offs, lo, rows, spec=spec)
        assert torch.equal(in_s.reshape(-1).view(torch.int32), ws.view(torch.int32))
        assert torch.equal(in_w.reshape(-1).view(torch.int32), ww.view(torch.int32))
        assert torch.equal(inbox.reshape(-1), wi)
        received += int((wi > 0).sum())
    assert received > 0
