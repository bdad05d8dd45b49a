#!/usr/bin/env python3
"""Time variants of the PyTorch port's walk kernel (kernel B) on one NVIDIA
GPU.

    python3 scripts/walk_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is built with the port's nvcc flags into
build/walk_variants/<variant>/ and loaded in place of the committed library
for the same wrapper calls (models/reference.walk_hops):

- ``base``: the committed cop5615_gossip_protocol_tpu_torch/csrc/walk.cu and
  csrc/walk.cuh (one block of 256 threads: thread 0 walks, warps 1-7 draw
  the next 1,024 hops' entries into a ring in shared memory; a 16-byte
  record a node that keeps its ratio s / w, so a hop divides once; the
  next node read before the hop's write; the shared tier where the records
  fit);
- ``base_global``: the same library with the global tier forced (the
  records and rows staged in global scratch);
- ``one_thread``: the kernel's first form (one thread in one block, each
  hop's two Threefry hashes on the walker, the pick's modulo by a runtime
  divisor, the planes in global memory), its loop and hop verbatim;
- ``two_div``: the ratio before the hop divided again from s and w (two
  divisions a hop);
- ``cmp_sub``: the full pick's modulo as a compare and subtract (the base
  takes the unsigned minimum of x and x - n);
- ``no_ahead``: the next node read after the hop's write;
- ``pick_inline``: each hop's pick in the hop (the base picks a hop
  ahead);
- ``flat``: the absorb written as selects around one store;
- ``ring256``, ``ring4096``: ring halves of 256 or 4,096 hops;
- ``threads128``: blocks of 128 threads.

And two splits of the committed kernel, which walk another walk and are
timed only to split a hop (their results are not compared; µs a hop over
the hops they took): ``split_nodiv``, the hop's division made a product,
and ``split_nostop``, the walker's stop test without the converged count
(so it walks to max_steps).

For the walks of ``chip_smoke.py`` phase 14h that the row times (full 1000
and imp3d 1000, reference semantics, seed 0) and line 1000 (two-hop
revisits, 1,000,000 hops), each variant runs the whole walk from its kickoff
in one launch (``LAUNCH_HOPS`` hops), held bitwise against ``base`` (every
plane, the message, hops, the dead latch; ``base`` against the plain walk on
the CPU), and is timed by CUDA events (median of 5 after a warm call),
every variant twice: in order, then in reverse order. Beside them, one
dependent access at the walk's working set in shared and in global memory
(csrc/walk.cu's chase kernel), a hop's loop-carried arithmetic (its arith
kernel), and the hop chain those price (the arithmetic on full, two
accesses or the arithmetic, the larger, elsewhere). Prints each
variant's ptxas lines for its walk kernels, one JSON line a walk (µs a hop),
then the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 5
WALKS = (("full", 1000, None), ("imp3d", 1000, None), ("line", 1000, None))

# The kernel's first form: its loop and hop as they were, with the entry
# points the wrapper calls (the global tier always, with no scratch).
ONE_THREAD = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scatter.cuh"
#include "walk.cuh"

namespace {

using gossip::walk::Carry;

// Its pick: on full (nbr null) the shift partner, else the neighbour
// column word % degree; `ok` is false for a degree-0 orphan.
__device__ __forceinline__ int pick(uint32_t word, int node, const int* nbr,
                                    const int* deg, int max_deg, int n, bool& ok) {
  if (nbr == nullptr) {
    ok = true;
    return gossip::scatter::target_full(word, node, n);
  }
  const int d = deg[node];
  ok = d > 0;
  return gossip::scatter::target_explicit(word, nbr + (long long)node * max_deg, d);
}

__device__ __forceinline__ void hop1(Carry& c, float* s, float* w, int* term,
                                     uint8_t* conv, uint32_t word, const int* nbr,
                                     const int* deg, int max_deg, int n,
                                     float delta, int term_rounds) {
  const int cur = c.cur;
  const float s_c = s[cur], w_c = w[cur];
  const float newsum = s_c + c.msg_s;
  const float newweight = w_c + c.msg_w;
  const float cal = fabsf(s_c / w_c - newsum / newweight);
  if (!conv[cur]) {
    int term_new = cal > delta ? 0 : term[cur] + 1;
    const bool fires = term_new >= term_rounds;
    if (fires) term_new = 0;
    const float s_half = newsum * 0.5f, w_half = newweight * 0.5f;
    s[cur] = s_half;
    w[cur] = w_half;
    term[cur] = term_new;
    c.msg_s = s_half;
    c.msg_w = w_half;
    if (fires) {
      conv[cur] = 1;
      c.conv_count += 1;
    }
  }
  bool ok;
  c.cur = pick(word, cur, nbr, deg, max_deg, n, ok);
  c.steps += 1;
  if (!ok) c.dead = 1;
}

__global__ void walk_kernel(float* s, float* w, int* term, uint8_t* conv,
                            const int* nbr, const int* deg, int max_deg, int n,
                            int* scal, uint32_t k1, uint32_t k2, int hops,
                            int max_steps, int target, float delta,
                            int term_rounds) {
  Carry c{scal[0], scal[1], scal[2], scal[3], __int_as_float(scal[4]),
          __int_as_float(scal[5])};
  for (int h = 0; h < hops && gossip::walk::walking(c, max_steps, target); ++h) {
    hop1(c, s, w, term, conv, gossip::walk::hop_word(k1, k2, (uint32_t)c.steps),
         nbr, deg, max_deg, n, delta, term_rounds);
  }
  scal[0] = c.cur;
  scal[1] = c.steps;
  scal[2] = c.dead;
  scal[3] = c.conv_count;
  scal[4] = __float_as_int(c.msg_s);
  scal[5] = __float_as_int(c.msg_w);
}

}  // namespace

extern "C" int gossip_walk_tier(int, int, int, int, long long* scratch_bytes) {
  *scratch_bytes = 0;
  return 0;
}

extern "C" int gossip_walk_hops(float* s, float* w, int* term, uint8_t* conv,
                                const int* nbr, const int* deg, void* scratch,
                                int max_deg, int n, int* scal, unsigned k1,
                                unsigned k2, int hops, int max_steps, int target,
                                float delta, int term_rounds, int tier,
                                int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      s, w, term, conv, nbr, deg, max_deg, n, scal, k1, k2, hops, max_steps,
      target, delta, term_rounds);
  return (int)cudaGetLastError();
}
"""

RING = "constexpr int kRing = 1024;"
THREADS = "constexpr int kThreads = 256;"
LOAD = "    Node y = nodes.load(at);\n"
AFTER_WRITES = "    if (at == cur) y = x;\n"
TWO_DIV = ("const float cal = fabsf(x.ratio - ratio);",
           "const float cal = fabsf(x.s / x.w - ratio);")
CMP_SUB = ("    const uint32_t x = (uint32_t)node + shift, y = x - (uint32_t)n;\n"
           "    return (int)(y < x ? y : x);",
           "    const int x = node + (int)shift;\n    return x >= n ? x - n : x;")
NODIV = ("const float ratio = newsum / newweight;", "const float ratio = newsum * newweight;")
PICK_AHEAD = (("""  bool ok;
  int nxt = pk.next(entries[0], cur, ok);
  for (int i = 0;;) {
    const int at = pk.real(nxt, cur);
    Node y = nodes.load(at);
    // The next hop's pick, from the node it starts at (a dead walk takes
    // no next hop).
    bool ok_next;
    const int nxt_next = pk.next(entries[i + 1 < count ? i + 1 : i], at, ok_next);
""", """  for (int i = 0;;) {
    bool ok;
    const int nxt = pk.next(entries[i], cur, ok);
    const int at = pk.real(nxt, cur);
    Node y = nodes.load(at);
"""), ("""    nxt = nxt_next;
    ok = ok_next;
""", ""))
ABSORB = ("""    if (!(x.tc & 1)) {
      int t = cal > delta ? 0 : (x.tc >> 1) + 1;
      const int fires = t >= term_rounds;
      if (fires) t = 0;
      const float s_half = newsum * 0.5f, w_half = newweight * 0.5f;
      x = Node{s_half, w_half, ratio, t * 2 + fires};
      // A half that fell to a subnormal lost bits: the ratio is that of
      // the halves.
      if (!(s_half * 2.0f == newsum && w_half * 2.0f == newweight))
        x.ratio = s_half / w_half;
      nodes.store(cur, x);
      c.conv_count += fires;
      c.msg_s = x.s;
      c.msg_w = x.w;
    }
""", """    {
      const bool absorbs = !(x.tc & 1);
      int t = cal > delta ? 0 : (x.tc >> 1) + 1;
      const int fires = absorbs && t >= term_rounds;
      if (fires) t = 0;
      const float s_half = newsum * 0.5f, w_half = newweight * 0.5f;
      float kept = ratio;
      if (absorbs && !(s_half * 2.0f == newsum && w_half * 2.0f == newweight))
        kept = s_half / w_half;
      if (absorbs) {
        x = Node{s_half, w_half, kept, t * 2 + fires};
        nodes.store(cur, x);
        c.msg_s = s_half;
        c.msg_w = w_half;
      }
      c.conv_count += fires;
    }
""")
NOSTOP = ("if (++i >= hops || c.dead || c.conv_count >= target) return;",
          "if (++i >= hops || c.dead) return;")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _edits(text, edits):
    for old, new in edits:
        text = _sub(text, old, new)
    return text


def variants(cu: str, cuh: str) -> dict:
    """{name: (walk.cu text, walk.cuh text)} of every variant built."""
    out = {"base": (cu, cuh), "one_thread": (ONE_THREAD, cuh),
           "two_div": (cu, _sub(cuh, *TWO_DIV)), "cmp_sub": (cu, _sub(cuh, *CMP_SUB)),
           "no_ahead": (cu, _sub(_sub(cuh, LOAD, ""), AFTER_WRITES, LOAD + AFTER_WRITES)),
           "pick_inline": (cu, _edits(cuh, PICK_AHEAD)), "flat": (cu, _sub(cuh, *ABSORB)),
           "split_nodiv": (cu, _sub(cuh, *NODIV)), "split_nostop": (cu, _sub(cuh, *NOSTOP))}
    for ring in (256, 4096):
        out[f"ring{ring}"] = (_sub(cu, RING, f"constexpr int kRing = {ring};"), cuh)
    out["threads128"] = (_sub(cu, THREADS, "constexpr int kThreads = 128;"), cuh)
    return out


def build(name: str, cu: str, cuh: str, csrc: Path, nvcc_flags, nvcc) -> Path:
    d = ROOT / "build" / "walk_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(cuh if h.name == "walk.cuh" else h.read_text())
    (d / "walk.cu").write_text(cu)
    lib = d / "libwalk.so"
    proc = subprocess.run([nvcc, *nvcc_flags, "-I", str(d), "-o", str(lib),
                           str(d / "walk.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = [f"{line.split(chr(39))[1]}: {log[i + 2].strip()}; {log[i + 3].strip()}"
            for i, line in enumerate(log[:-3])
            if "Compiling entry function" in line and "walk_kernel" in line]
    print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return lib


def events_ms(fn) -> float:
    """Median ms of ``fn()`` by CUDA events over REPS calls, after a warm
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def main() -> int:
    import concurrent.futures
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models import reference
    from cop5615_gossip_protocol_tpu_torch.models.runner import draw_leader
    from cop5615_gossip_protocol_tpu_torch.ops import rng, scatter
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    csrc = kernels.CSRC
    texts = variants(*((csrc / f).read_text() for f in ("walk.cu", "walk.cuh")))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: build(kv[0], *kv[1], csrc, kernels.NVCC_FLAGS, kernels.nvcc_path()),
            texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load, real_tier = kernels.load, reference.walk_tier
    key = rng.PRNGKey(0)
    dev = torch.device("cuda", 0)
    names = list(texts) + ["base_global"]
    order = names + list(reversed(names))
    for kind, n, cap in WALKS:
        topo = build_topology(kind, n, semantics="reference")
        cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", semantics="reference",
                        **({} if cap is None else {"max_rounds": cap}))
        graph = scatter.scatter_graph(topo, dev)
        target = cfg.resolved_target_count(topo.n, topo.target_count)
        kw = {"hops": reference.LAUNCH_HOPS, "max_steps": cfg.max_rounds, "target": target,
              "delta": cfg.resolved_delta, "term_rounds": cfg.term_rounds}
        c0 = reference.make_walk(topo, cfg, key, draw_leader(key, topo, cfg))
        plain, _ = reference.walk_hops(c0, key, scatter.scatter_graph(topo, "cpu"), **kw)
        c0 = reference.WalkCarry(*(x.to(dev) for x in c0))
        times, tiers = {}, {}
        for variant in order:
            lib = loaded["base" if variant == "base_global" else variant]
            kernels.load = (lambda lib: (lambda source: lib if source == "walk"
                                         else real_load(source)))(lib)
            reference.walk_tier = ((lambda g: ("global", real_tier(g)[1]))
                                   if variant == "base_global" else real_tier)
            tiers[variant] = reference.walk_tier(graph)[0]
            got, _ = reference.walk_hops(c0, key, graph, **kw)
            for name, a, b in zip(reference.WalkCarry._fields, got, plain):
                if variant.startswith("split_"):
                    break
                a, b = a.cpu(), b.cpu()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise AssertionError(f"{variant}: walk {kind} n={topo.n}: {name} "
                                         "differs from the plain walk")
            ms = events_ms(lambda: reference.walk_hops(c0, key, graph, **kw))
            times.setdefault(variant, []).append(ms * 1e3 / (int(got.steps) - 1))
        kernels.load, reference.walk_tier = real_load, real_tier
        # One dependent access at the walk's working set (as chip_smoke.py's
        # row counts it), in shared and in global memory.
        words = topo.n * 4 + (0 if topo.implicit else topo.n * (topo.max_deg + 3))
        gen = torch.Generator().manual_seed(0)
        perm = torch.randperm(words, generator=gen)
        nxt = torch.empty(words, dtype=torch.int32)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        nxt = nxt.to(dev)
        steps = 1 << 20
        access_ns = {memory: events_ms(lambda: reference.chase(nxt, steps, memory == "shared"))
                     * 1e6 / steps for memory in reference.TIERS}
        # A hop's loop-carried arithmetic (the message's, and on full the
        # pick's): the whole chain on full, beside two accesses elsewhere.
        arith_ns = events_ms(lambda: reference.arith_chain(steps, topo.n, dev,
                                                           topo.implicit)) * 1e6 / steps
        chain_ns = {m: arith_ns if topo.implicit else max(2 * ns, arith_ns)
                    for m, ns in access_ns.items()}
        print(json.dumps({"kernel": "walk_hops", "topology": kind, "n": topo.n,
                          "hops": int(plain.steps), "us_per_hop": times, "tier": tiers,
                          "dependent_access_ns": access_ns, "hop_arith_ns": arith_ns,
                          "chain_us_per_hop": {m: ns * 1e-3 for m, ns in chain_ns.items()},
                          "bitwise": True}), flush=True)
        del graph, c0
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
