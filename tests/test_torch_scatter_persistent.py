"""Kernel A's persistent form (csrc/scatter.cu) on the CPU: its per-node
pieces in csrc/scatter.cuh, built with g++, against the plain versions,
and host emulations of its passes against the plain rounds:

- the round key the kernel folds against ``fused.round_keys``;
- the 16-byte send record's pack, store and load;
- buckets filled in a random rank order (the counting atomic's order on
  the card), summed by ``record_sum`` (sorted in registers up to
  ``kSortMax`` sends, by repeated selection past it) against
  ``delivery.deliver``'s serial order and the JAX package's scatter-add;
- the slices of targets the blocks own;
- the dup and delay instances' pieces: the dup bit against
  ``jax.random.bits`` on fold_in(round key, 0xD00B), the ring slot, a
  bucket's inbox pair summed from 0 with the dup-gated sends a second time
  apart (``record_inbox``) and a node's unfolded round from it
  (``pushsum_round_inbox``) against the plain round;
- push-sum: the prologue's counts, then per round the slice scan, the
  place pass at base + offset + rank and the absorb that zeroes its count
  and counts round r + 1 into the other parity, every atomic in a shuffled
  order, against ``pushsum_scatter_chunk_plain`` at full 1000 and imp3d
  1000 in reference semantics (its orphan does not send), over two rounds
  and over a chunk that stops at done after one (the staged counts zeroed);
- gossip: the inbox of each round parity, the same way;
- the wrapper: one launch a chunk of rounds, none for no round, and no
  kernel reached from CPU tensors.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
from cop5615_gossip_protocol_tpu_torch.models import gossip as gossip_mod
from cop5615_gossip_protocol_tpu_torch.models import pushsum as pushsum_mod
from cop5615_gossip_protocol_tpu_torch.ops import delivery, fused, rng, sampling, scatter

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "cop5615_gossip_protocol_tpu_torch" / "csrc"

SHIM = r"""
#include <string.h>
#include "scatter.cuh"
using namespace gossip;
using namespace gossip::scatter;

extern "C" void round_keys(uint32_t k1, uint32_t k2, const uint32_t* rounds, int m,
                           uint32_t* out) {
  for (int a = 0; a < m; ++a) round_key(k1, k2, rounds[a], out[2 * a], out[2 * a + 1]);
}

extern "C" void layout(int* out) {
  out[0] = (int)sizeof(Send);
  out[1] = (int)alignof(Send);
  out[2] = (int)sizeof(Ticket);
  out[3] = (int)alignof(Ticket);
  out[4] = kSortMax;
}

// make_send and store_send into rec[i], then load_send back into out[i].
extern "C" void pack(const int* idx, const float* s, const float* w, int m,
                     Send* rec, Send* out) {
  for (int i = 0; i < m; ++i) {
    store_send(rec + i, make_send(idx[i], s[i], w[i]));
    out[i] = load_send(rec + i);
  }
}

extern "C" void record_sums(const Send* rec, const int* start, const int* count,
                            int n, float* acc_s, float* acc_w) {
  for (int j = 0; j < n; ++j)
    record_sum(rec + start[j], count[j], acc_s[j], acc_w[j]);
}

extern "C" void dup_bits(uint32_t r1, uint32_t r2, uint32_t thresh, int n, int* out) {
  uint32_t d1, d2;
  dup_key(r1, r2, d1, d2);
  for (int j = 0; j < n; ++j) out[j] = dup_fires(d1, d2, thresh, j);
}

extern "C" void ring_slots(const int* rounds, int m, int D, int* out) {
  for (int a = 0; a < m; ++a) out[a] = ring_slot(rounds[a], D);
}

// The dup instances' inbox pair of each bucket (record_inbox<Dup>), then a
// node's round from it (pushsum_round_inbox).
extern "C" void record_inboxes(const Send* rec, const int* start, const int* count,
                               int n, int dup, float* in_s, float* in_w) {
  for (int j = 0; j < n; ++j) {
    if (dup)
      record_inbox<true>(rec + start[j], count[j], in_s[j], in_w[j]);
    else
      record_inbox<false>(rec + start[j], count[j], in_s[j], in_w[j]);
  }
}

extern "C" void inbox_rounds(float* s, float* w, int* term, unsigned char* conv,
                             const unsigned char* sends, const float* in_s,
                             const float* in_w, int n, float delta, int term_rounds) {
  for (int j = 0; j < n; ++j) {
    float s_new, w_new;
    int t_new;
    conv[j] = (unsigned char)pushsum_round_inbox(
        s[j], w[j], term[j], conv[j] != 0, sends[j] != 0, in_s[j], in_w[j], delta,
        term_rounds, s_new, w_new, t_new);
    s[j] = s_new;
    w[j] = w_new;
    term[j] = t_new;
  }
}

extern "C" void slices(int n, int blocks, int* lo, int* hi, const int* t, int m,
                       int* owner) {
  const Slices sl = make_slices(n, blocks);
  for (int b = 0; b < blocks; ++b) {
    lo[b] = slice_lo(sl, b);
    hi[b] = slice_hi(sl, b);
  }
  for (int a = 0; a < m; ++a) owner[a] = slice_of(sl, t[a]);
}

struct Graph {
  const int* nbr;
  const int* deg;
  int max_deg;
  int n;
};

static int target_of(const Graph& g, uint32_t k1, uint32_t k2, int i) {
  const uint32_t word = threefry_word(k1, k2, (uint32_t)i);
  if (g.nbr == nullptr) return target_full(word, i, g.n);
  if (g.deg[i] <= 0) return -1;
  return target_explicit(word, g.nbr + (long)i * g.max_deg, g.deg[i]);
}

// csrc/scatter.cu pushsum_rounds, pass by pass, one thread at a time:
// every counting atomic in the order `order` (a permutation of the nodes).
extern "C" void emulate_pushsum(float* s, float* w, int* term, unsigned char* conv,
                                const int* nbr, const int* deg, int max_deg, int n,
                                const uint32_t* keys, int rounds, int blocks,
                                const int* order, float delta, int term_rounds,
                                int target, int* status, int* cnt) {
  if (status[1] || rounds == 0) return;
  const Graph g{nbr, deg, max_deg, n};
  const Slices sl = make_slices(n, blocks);
  Ticket* tick = new Ticket[n];
  int* loc = new int[n];
  int* base = new int[blocks];
  Send* rec = new Send[n];
  auto count_send = [&](uint32_t k1, uint32_t k2, int i, int* c) {
    const int t = target_of(g, k1, k2, i);
    return Ticket{t, t >= 0 ? c[t]++ : 0};
  };
  for (int q = 0; q < n; ++q) tick[order[q]] = count_send(keys[0], keys[1], order[q], cnt);
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const int r = executed;
    int* cnt_r = cnt + (long)(r & 1) * n;
    int* cnt_next = cnt + (long)((r + 1) & 1) * n;
    int carry_all = 0;
    for (int b = 0; b < blocks; ++b) {
      int carry = 0;
      for (int j = slice_lo(sl, b); j < slice_hi(sl, b); ++j) {
        loc[j] = carry;
        carry += cnt_r[j];
      }
      base[b] = carry_all;
      carry_all += carry;
    }
    for (int i = 0; i < n; ++i) {
      const Ticket tk = tick[i];
      if (tk.target < 0) continue;
      const int pos = base[slice_of(sl, tk.target)] + loc[tk.target] + tk.rank;
      store_send(rec + pos, make_send(i, s[i], w[i]));
    }
    const bool next = r + 1 < rounds;
    int converged = 0;
    for (int q = 0; q < n; ++q) {
      const int j = order[q];
      const int k = cnt_r[j];
      const int at = k > 0 ? base[slice_of(sl, j)] + loc[j] : 0;
      const Ticket tk = next ? count_send(keys[2 * r + 2], keys[2 * r + 3], j, cnt_next)
                             : Ticket{-1, 0};
      if (k > 0) cnt_r[j] = 0;
      float s_new, w_new;
      int t_new;
      const int cv = pushsum_round(
          s[j], w[j], term[j], conv[j] != 0, nbr == nullptr || deg[j] > 0,
          [&](float& a, float& b) { record_sum(rec + at, k, a, b); }, delta,
          term_rounds, s_new, w_new, t_new);
      s[j] = s_new;
      w[j] = w_new;
      term[j] = t_new;
      conv[j] = (unsigned char)cv;
      if (next) tick[j] = tk;
      converged += cv;
    }
    done = converged >= target;
    ++executed;
  }
  if (executed < rounds) memset(cnt + (long)(executed & 1) * n, 0, sizeof(int) * n);
  status[0] += executed;
  status[1] = done ? 1 : 0;
  delete[] tick;
  delete[] loc;
  delete[] base;
  delete[] rec;
}

// csrc/scatter.cu gossip_rounds the same way (the absorb of csrc/chunk.cuh
// gossip_absorb, which is device code, written out).
extern "C" void emulate_gossip(int* count, unsigned char* active, unsigned char* conv,
                               const int* nbr, const int* deg, int max_deg, int n,
                               const uint32_t* keys, int rounds, const int* order,
                               int rumor_target, int suppress, int target,
                               int* status, int* inbox) {
  if (status[1] || rounds == 0) return;
  const Graph g{nbr, deg, max_deg, n};
  for (int q = 0; q < n; ++q) {
    const int i = order[q];
    const int t = active[i] ? target_of(g, keys[0], keys[1], i) : -1;
    if (t >= 0) inbox[t] += 1;
  }
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const int r = executed;
    int* in = inbox + (long)(r & 1) * n;
    int* out = r + 1 < rounds ? inbox + (long)((r + 1) & 1) * n : nullptr;
    int converged = 0;
    for (int q = 0; q < n; ++q) {
      const int j = order[q];
      int got = in[j];
      if (got) in[j] = 0;
      if (suppress && conv[j]) got = 0;
      count[j] += got;
      active[j] = (active[j] || got > 0) ? 1 : 0;
      conv[j] = count[j] >= rumor_target ? 1 : 0;
      if (out && active[j]) {
        const int t = target_of(g, keys[2 * r + 2], keys[2 * r + 3], j);
        if (t >= 0) out[t] += 1;
      }
      converged += conv[j];
    }
    done = converged >= target;
    ++executed;
  }
  if (executed < rounds) memset(inbox + (long)(executed & 1) * n, 0, sizeof(int) * n);
  status[0] += executed;
  status[1] = done ? 1 : 0;
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("scatter_persistent_shim")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(d / "shim.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _adversarial(r, m):
    """float32 values over seven decades, both signs."""
    mag = r.random(m) * 10.0 ** r.integers(-3, 4, m)
    return (mag * np.where(r.random(m) < 0.5, -1, 1)).astype(np.float32)


def _records(m):
    """m zeroed 16-byte records (int32 [m, 4]: index, s bits, w bits, pad)."""
    return np.zeros((m, 4), np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_round_key_is_fused_round_keys(shim, seed):
    # The kernel folds each round's key from the run's key and the absolute
    # round; the host draws the same keys with fused.round_keys. Rounds past
    # 2**16 and a start past 2**32, which round_keys folds mod 2**32.
    key = rng.PRNGKey(seed)
    for start, count in ((0, 70), (65_530, 12), (1_000_000, 5), (2**32 - 3, 6)):
        want = fused.round_keys(key, start, count).numpy().astype(np.uint32)
        rounds = ((start + np.arange(count)) & rng.MASK).astype(np.uint32)
        got = np.zeros((count, 2), np.uint32)
        shim.round_keys(ctypes.c_uint32(int(key[0])), ctypes.c_uint32(int(key[1])),
                        _ptr(rounds), count, _ptr(got))
        assert (got == want).all()
    assert scatter._key_args(key, 2**32 + 5)[2] == 5


def test_record_layout_and_pack(shim):
    out = np.zeros(5, np.int32)
    shim.layout(_ptr(out))
    assert out[:4].tolist() == [16, 16, 8, 8]
    assert out[4] == 8
    r = np.random.default_rng(0)
    m = 1000
    idx = r.integers(0, 2**31 - 1, m).astype(np.int32)
    s, w = _adversarial(r, m), np.abs(_adversarial(r, m))
    s[:4] = [0.0, -0.0, np.float32(1e-45), np.float32(3.4e38)]  # a denormal, the top
    rec, back = _records(m), _records(m)
    shim.pack(_ptr(idx), _ptr(s), _ptr(w), m, _ptr(rec), _ptr(back))
    half = np.float32(0.5)
    for got in (rec, back):
        assert (got[:, 0] == idx).all()
        assert (got[:, 1] == _bits(s * half)).all()
        assert (got[:, 2] == _bits(w * half)).all()
        assert (got[:, 3] == 0).all()


def _shuffled_buckets(r, t, values, n):
    """Records of sends with targets t, bucket after bucket, each bucket in
    a random rank order: (records, start, count)."""
    m = t.shape[0]
    count = np.bincount(t, minlength=n).astype(np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    rank = np.empty(m, np.int64)
    fill = np.zeros(n, np.int64)
    for i in r.permutation(m):  # the counting atomic's order
        rank[i] = fill[t[i]]
        fill[t[i]] += 1
    rec = _records(m)
    pos = start[t] + rank
    rec[pos, 0] = np.arange(m, dtype=np.int32)
    rec[pos, 1] = _bits(values[0])
    rec[pos, 2] = _bits(values[1])
    return rec, start, count


@pytest.mark.parametrize("n,m", [(300, 300), (300, 3000), (7, 140)])
def test_record_sum_is_the_serial_order(shim, n, m):
    # m / n sends a bucket on average: Poisson(1) as on full, then buckets
    # past kSortMax (the selection path), then buckets of ~20.
    r = np.random.default_rng(n + m)
    t = r.integers(0, n, m)
    v, u = _adversarial(r, m), _adversarial(r, m)
    rec, start, count = _shuffled_buckets(r, t, (v, u), n)
    if m > n:
        assert count.max() > 8
    acc_s = _adversarial(r, n)
    acc_w = np.zeros(n, np.float32)
    want_s = delivery.deliver(torch.from_numpy(v), torch.from_numpy(t), n,
                              base=torch.from_numpy(acc_s)).numpy()
    want_w = delivery.deliver(torch.from_numpy(u), torch.from_numpy(t), n).numpy()
    assert (_bits(want_s) == _bits(jnp.asarray(acc_s).at[t].add(v))).all()
    shim.record_sums(_ptr(rec), _ptr(start), _ptr(count), n, _ptr(acc_s), _ptr(acc_w))
    assert (_bits(acc_s) == _bits(want_s)).all()
    assert (_bits(acc_w) == _bits(want_w)).all()


@pytest.mark.parametrize("rate", [0.05, 0.5, 0.999])
def test_dup_bit_is_the_jax_dup_gate(shim, rate):
    # The kernels' dup bit: a Threefry word on fold_in(round key, 0xD00B)
    # below the threshold, against jax.random.bits and the port's
    # sampling.dup_gate.
    import jax

    thresh = sampling.gate_threshold(rate)
    for rnd in (0, 13, 2**20 + 1):
        jkey = jax.random.fold_in(jax.random.PRNGKey(7), rnd)
        words = np.asarray(jax.random.bits(jax.random.fold_in(jkey, 0xD00B), (5000,),
                                           jnp.uint32))
        rkey = sampling.round_key(rng.PRNGKey(7), rnd)
        got = np.zeros(5000, np.int32)
        shim.dup_bits(ctypes.c_uint32(int(rkey[0])), ctypes.c_uint32(int(rkey[1])),
                      ctypes.c_uint32(thresh), 5000, _ptr(got))
        assert (got == (words < thresh)).all()
        assert (got == sampling.dup_gate(rkey, 5000, rate).numpy()).all()


def test_ring_slot_is_the_round_mod_depth(shim):
    rounds = np.array([0, 1, 2, 3, 63, 64, 1000, 2**30], np.int32)
    for D in (1, 3, 64):
        got = np.zeros(rounds.shape[0], np.int32)
        shim.ring_slots(_ptr(rounds), rounds.shape[0], D, _ptr(got))
        assert (got == rounds % D).all()


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("n,m", [(300, 300), (300, 3000)])
def test_record_inbox_and_round_are_the_plain_round(shim, dup, n, m):
    # A bucket's inbox pair from 0, the dup-gated sends a second time into
    # an inbox of their own and the two added (ops/delivery.deliver_dup),
    # then a node's unfolded round (pushsum_round_plain with a dup gate).
    r = np.random.default_rng(n + m + dup)
    t = r.integers(0, n, m)
    v, u = _adversarial(r, m), np.abs(_adversarial(r, m))
    rec, start, count = _shuffled_buckets(r, t, (v, u), n)
    gate = r.random(m) < 0.3 if dup else np.zeros(m, bool)
    # A dup instance's index word: 2 i + the dup bit (dup_index).
    rec[:, 0] = 2 * rec[:, 0] + gate[rec[:, 0]]
    in_s, in_w = np.zeros(n, np.float32), np.zeros(n, np.float32)
    shim.record_inboxes(_ptr(rec), _ptr(start), _ptr(count), n, int(dup),
                        _ptr(in_s), _ptr(in_w))
    tt = torch.from_numpy(t)
    dg = torch.from_numpy(gate) if dup else None
    for got, vals in ((in_s, v), (in_w, u)):
        want = delivery.deliver_dup(lambda v: delivery.deliver(v, tt, n),
                                    torch.from_numpy(vals), dg).numpy()
        assert (_bits(got) == _bits(want)).all()
    s, w = np.abs(_adversarial(r, n)), np.abs(_adversarial(r, n)) + 1
    term = r.integers(0, 3, n).astype(np.int32)
    conv = np.zeros(n, np.uint8)
    sends = (r.random(n) < 0.9).astype(np.uint8)
    st = pushsum_mod.PushSumState(torch.from_numpy(s.copy()), torch.from_numpy(w.copy()),
                                  torch.from_numpy(term.copy()), torch.zeros(n, dtype=torch.bool))
    s_send, w_send, s_keep, w_keep = pushsum_mod.halve_and_send(
        st.s, st.w, torch.from_numpy(sends != 0))
    want = pushsum_mod.absorb(st, s_keep, w_keep, torch.from_numpy(in_s),
                              torch.from_numpy(in_w), 1e-6, 3)
    shim.inbox_rounds(_ptr(s), _ptr(w), _ptr(term), _ptr(conv), _ptr(sends), _ptr(in_s),
                      _ptr(in_w), n, ctypes.c_float(1e-6), 3)
    assert (_bits(s) == _bits(want.s.numpy())).all()
    assert (_bits(w) == _bits(want.w.numpy())).all()
    assert (term == want.term.numpy()).all() and (conv == want.conv.numpy()).all()


@pytest.mark.parametrize("n,blocks", [(1, 1), (1001, 4), (1_000_000, 977), (2**27, 1056),
                                      (2**31 - 1, 2048)])
def test_slices_cover_every_node_once(shim, n, blocks):
    lo, hi = np.zeros(blocks, np.int32), np.zeros(blocks, np.int32)
    r = np.random.default_rng(blocks)
    t = np.concatenate([[0, n - 1], r.integers(0, n, 1000)]).astype(np.int32)
    owner = np.zeros(t.shape[0], np.int32)
    shim.slices(n, blocks, _ptr(lo), _ptr(hi), _ptr(t), t.shape[0], _ptr(owner))
    assert lo[0] == 0 and hi[-1] == n
    assert (lo <= hi).all() and (hi[:-1] == lo[1:]).all()
    assert ((lo[owner] <= t) & (t < hi[owner])).all()


CASES = [("full", 1000, "batched"), ("imp3d", 1000, "reference")]


def _graph_arrays(topo):
    if topo.implicit:
        return None, None, 0
    nbr = np.ascontiguousarray(topo.neighbors, np.int32)
    return nbr, np.ascontiguousarray(topo.degree, np.int32), nbr.shape[1]


def _pushsum_state(r, n):
    """A mid-run-like push-sum state: mixed masses, some terms, some
    converged."""
    return pushsum_mod.PushSumState(
        s=torch.from_numpy((r.random(n) * 100).astype(np.float32)),
        w=torch.from_numpy((r.random(n) + 0.25).astype(np.float32)),
        term=torch.from_numpy(r.integers(0, 3, n).astype(np.int32)),
        conv=torch.from_numpy(r.random(n) < 0.2))


@pytest.mark.parametrize("stop", ["cap", "done"])
@pytest.mark.parametrize("blocks", [1, 7])
@pytest.mark.parametrize("kind,n,semantics", CASES)
def test_pushsum_passes_match_two_plain_rounds(shim, kind, n, semantics, blocks, stop):
    topo = build_topology(kind, n, semantics=semantics)
    n = topo.n
    graph = scatter.scatter_graph(topo, "cpu")
    r = np.random.default_rng(blocks)
    state = _pushsum_state(r, n)
    start = 40_000  # absolute round keys
    keys = fused.round_keys(rng.PRNGKey(2), start, 2)
    # "done": a target the first round reaches, so the chunk stops there
    # and round 1's staged counts must be zeroed.
    target = n if stop == "cap" else 1
    status = torch.tensor([start, 0], dtype=torch.int32)
    want, want_status = scatter.pushsum_scatter_chunk_plain(
        state, keys, status, graph=graph, target=target, delta=1e-2, term_rounds=3)
    s, w = state.s.numpy().copy(), state.w.numpy().copy()
    term = state.term.numpy().copy()
    conv = state.conv.numpy().astype(np.uint8)
    nbr, deg, max_deg = _graph_arrays(topo)
    words = np.ascontiguousarray(keys.numpy().astype(np.uint32).reshape(-1))
    order = r.permutation(n).astype(np.int32)
    got_status = status.numpy().copy()
    cnt = np.zeros(2 * n, np.int32)
    shim.emulate_pushsum(_ptr(s), _ptr(w), _ptr(term), _ptr(conv), _ptr(nbr), _ptr(deg),
                         max_deg, n, _ptr(words), 2, blocks, _ptr(order),
                         ctypes.c_float(1e-2), 3, target, _ptr(got_status), _ptr(cnt))
    assert got_status.tolist() == want_status.tolist()
    assert want_status.tolist() == ([start + 2, 0] if stop == "cap" else [start + 1, 1])
    for got, exp in zip((s, w, term, conv), want):
        assert (_bits(got) == _bits(exp.numpy().astype(got.dtype))).all()
    assert not cnt.any()


@pytest.mark.parametrize("stop", ["cap", "done"])
@pytest.mark.parametrize("kind,n,semantics", CASES)
def test_gossip_parity_inboxes_match_two_plain_rounds(shim, kind, n, semantics, stop):
    topo = build_topology(kind, n, semantics=semantics)
    n = topo.n
    graph = scatter.scatter_graph(topo, "cpu")
    r = np.random.default_rng(5)
    cfg = SimConfig(n=n, topology=kind, algorithm="gossip", semantics=semantics)
    # Some nodes converged, so a target of 1 stops the chunk after a round.
    count = r.integers(0, cfg.resolved_rumor_target + 1, n).astype(np.int32)
    state = gossip_mod.GossipState(
        count=torch.from_numpy(count), active=torch.from_numpy(r.random(n) < 0.3),
        conv=torch.from_numpy(count >= cfg.resolved_rumor_target))
    start = 77
    keys = fused.round_keys(rng.PRNGKey(4), start, 2)
    target = n if stop == "cap" else 1
    status = torch.tensor([start, 0], dtype=torch.int32)
    kw = {"rumor_target": cfg.resolved_rumor_target, "suppress": cfg.resolved_suppress}
    want, want_status = scatter.gossip_scatter_chunk_plain(
        state, keys, status, graph=graph, target=target, **kw)
    planes = [state.count.numpy().copy(), state.active.numpy().astype(np.uint8),
              state.conv.numpy().astype(np.uint8)]
    nbr, deg, max_deg = _graph_arrays(topo)
    words = np.ascontiguousarray(keys.numpy().astype(np.uint32).reshape(-1))
    order = r.permutation(n).astype(np.int32)
    got_status = status.numpy().copy()
    inbox = np.zeros(2 * n, np.int32)
    shim.emulate_gossip(*(_ptr(x) for x in planes), _ptr(nbr), _ptr(deg), max_deg, n,
                        _ptr(words), 2, _ptr(order), kw["rumor_target"],
                        int(kw["suppress"]), target, _ptr(got_status), _ptr(inbox))
    assert got_status.tolist() == want_status.tolist()
    assert want_status.tolist() == ([start + 2, 0] if stop == "cap" else [start + 1, 1])
    for got, exp in zip(planes, want):
        assert (got == exp.numpy().astype(got.dtype)).all()
    assert not inbox.any()


def test_wrappers_launch_once_a_chunk_and_never_from_the_cpu():
    assert [scatter.chunk_launches(k) for k in (0, 1, 8, 4096)] == [0, 1, 1, 1]
    topo = build_topology("full", 500)
    graph = scatter.scatter_graph(topo, "cpu")
    cfg = SimConfig(n=500, algorithm="push-sum")
    state = pushsum_mod.init_state(500, cfg.initial_term_round, "cpu")
    status = torch.tensor([3, 0], dtype=torch.int32)
    kw = {"graph": graph, "target": 500, "delta": cfg.resolved_delta,
          "term_rounds": cfg.term_rounds}
    before = scatter.pushsum_scatter_chunk.launches
    key = rng.PRNGKey(0)
    for count in (0, 2):
        out, st = scatter.pushsum_scatter_chunk(state, key, 3, count, status, **kw)
        want, want_st = scatter.pushsum_scatter_chunk_plain(
            state, fused.round_keys(key, 3, count), status, **kw)
        assert st.tolist() == want_st.tolist() == [3 + count, 0]
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        if count == 0:
            assert all(torch.equal(a, b) for a, b in zip(out, state))
    assert scatter.pushsum_scatter_chunk.launches == before
    assert not graph.work  # no kernel scratch for CPU tensors
    assert status.tolist() == [3, 0]  # the input status is left as it was
