#!/usr/bin/env python3
"""Time variants of the PyTorch port's scatter round kernel (kernel A) on
one NVIDIA GPU.

    python3 scripts/scatter_round_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is the committed cop5615_gossip_protocol_tpu_torch/csrc/
scatter.cu and csrc/scatter.cuh with one textual change, built with the
port's nvcc flags into build/scatter_variants/<variant>/ and loaded in place
of the committed library for the same wrapper calls:

- ``base``: the committed source (each send's rank in its bucket from the
  counting atomic, one 16-byte record a send, the slice scan four values a
  thread a step, the grid at least 2 nodes a thread, one sender or node at
  a time in the place pass and the absorb, buckets up to 8 sends sorted in
  registers);
- ``stamped``: the committed source with the global timer read by one
  thread after every barrier, which splits a push-sum round into its scan,
  place and absorb passes (each with the barrier after it);
- ``cursor``: the place pass takes each slot with a returning atomic on
  the round's count (an atomic cursor, as the first form of the kernel
  did), the counting atomic returns nothing, and the absorb reads its
  bucket's size from the offsets;
- ``planes``: three 4-byte planes (index, s half, w half) in place of the
  16-byte record;
- ``scan1``: the slice scan one value a thread a step;
- ``grid1``, ``grid4``, ``grid8``: at least 1, 4 or 8 nodes a thread (more
  or fewer blocks where n is small; each barrier costs more with more
  blocks);
- ``place4``, ``place8``: the place pass in steps of 4 or 8 senders a
  thread, each step's loads issued before its stores; ``absorb2``,
  ``absorb4``: the absorb in steps of 2 or 4 nodes (``STEPPED_PLACE``,
  ``STEPPED_ABSORB``);
- ``lb4``: the push-sum kernel built for 4 resident blocks an SM
  (``__launch_bounds__``: 64 registers), ``lb0`` with no minimum (the
  base asks for 3: 80 registers);
- ``sort4``, ``sort16``: buckets up to 4 or 16 sends sorted in registers.

And one split of the committed kernel, which computes something else and
is timed only to split a round (its result is not compared, and the
scratch it leaves is zeroed): ``split_barrier``, the rounds' passes empty,
so a round is its barriers (three for push-sum, one for gossip) and their
block sums.

For full 1,000,000 and imp2d 100,489 (``100000 imp2D``, BASELINE.json),
push-sum from round 300 in a 32-round chunk and gossip from round 8 in an
8-round chunk, each variant is held bitwise against the committed kernel's
result (planes and status) and timed by CUDA events (median of 5, after a
warm call), every variant twice: in order, then in reverse order. Beside
them, one PyTorch call for each memory pattern of the passes, on the same
card and the round's targets (median of 5): a gather of one int32 a send
at its target (``take``, the place pass's offset read), a store of one
16-byte row a send at a random slot (``index_copy_``, its record store),
and one int32 atomic add a send (``index_add_``, the counting atomic).
Prints each variant's registers and spills, one JSON line a case (µs a
round), then the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import scatter_fns  # noqa: E402  (phase 14f's cases, shared)

REPS = 5
# (algorithm, kind, n, semantics, start round, rounds a chunk)
CASES = (("push-sum", "full", 1_000_000, "batched", 300, 32),
         ("gossip", "full", 1_000_000, "batched", 8, 8),
         ("push-sum", "imp2d", 100_000, "batched", 300, 32),
         ("gossip", "imp2d", 100_000, "batched", 8, 8))

CURSOR = (("c.loc[tk.target] + tk.rank;",
           "c.loc[tk.target] + atomicSub(&cnt[tk.target], 1) - 1;", 1),
          ("      const int k = cnt[j];\n",
           "      const int k = (j + 1 < hi ? c.loc[j + 1] : total) - c.loc[j];\n", 1),
          ("      if (k > 0) cnt[j] = 0;\n", "", 1),
          ("  return Ticket{t, t >= 0 ? atomicAdd(&cnt[t], 1) : 0};",
           "  if (t >= 0) atomicAdd(&cnt[t], 1);\n  return Ticket{t, 0};", 1))

PLANES = (("""      gossip::scatter::store_send(c.rec + pos,
                                  gossip::scatter::make_send(i, c.s[i], c.w[i]));""",
           """      {
        int* q = (int*)c.rec;
        q[pos] = i;
        ((float*)q)[n + pos] = c.s[i] * 0.5f;
        ((float*)q)[2 * (size_t)n + pos] = c.w[i] * 0.5f;
      }""", 1),
          ("gossip::scatter::record_sum(c.rec + at, k, a, b);",
           "const int* q = (const int*)c.rec + at;\n"
           "            gossip::scatter::ordered_sum(\n"
           "                [&](int e) {\n"
           "                  return gossip::scatter::Send{\n"
           "                      q[e], ((const float*)q)[n + e],\n"
           "                      ((const float*)q)[2 * (size_t)n + e], 0};\n"
           "                },\n"
           "                k, a, b);",
           1))

SPLIT_BARRIER = (("lo, hi, [&](int j) { return cnt[j]; },",
                  "lo, lo, [&](int j) { return cnt[j]; },", 1),
                 ("i < hi; i += kBlock) {\n      const Ticket tk = c.tick[i];",
                  "i < lo; i += kBlock) {\n      const Ticket tk = c.tick[i];", 1),
                 ("j < hi; j += kBlock) {\n      // The loads first",
                  "j < lo; j += kBlock) {\n      // The loads first", 1),
                 ("j < n; j += stride) {\n      int got = in[j];",
                  "j < 0; j += stride) {\n      int got = in[j];", 1))

# The place pass and the absorb in steps of @STEP@ nodes a thread: each
# step's loads issued together, then its atomics and sums, its stores last.
# Each replaces the committed loop, from its first line to the barrier
# after it.
PLACE_LOOP = ("    for (int i = lo + threadIdx.x; i < hi; i += kBlock) {\n"
              "      const Ticket tk", "    round_barrier(c.words + 3 * r + 1, 0);")
STEPPED_PLACE = """    for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kBlock * @STEP@) {
      int pos[@STEP@];
      float s_t[@STEP@], w_t[@STEP@];
#pragma unroll
      for (int h = 0; h < @STEP@; ++h) {
        const int i = i0 + h * kBlock;
        const Ticket tk = i < hi ? c.tick[i] : Ticket{-1, 0};
        pos[h] = tk.target < 0 ? -1
                               : base[gossip::scatter::slice_of(sl, tk.target)] +
                                     c.loc[tk.target] + tk.rank;
        s_t[h] = i < hi ? c.s[i] : 0.0f;
        w_t[h] = i < hi ? c.w[i] : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < @STEP@; ++h)
        if (pos[h] >= 0)
          gossip::scatter::store_send(
              c.rec + pos[h], gossip::scatter::make_send(i0 + h * kBlock, s_t[h], w_t[h]));
    }
"""
ABSORB_LOOP = ("    for (int j = lo + threadIdx.x; j < hi; j += kBlock) {\n"
               "      // The loads first",
               "    const int sum = round_barrier(c.words + 3 * r + 2")
STEPPED_ABSORB = """    for (int j0 = lo + threadIdx.x; j0 < hi; j0 += kBlock * @STEP@) {
      int k[@STEP@], at[@STEP@], t_old[@STEP@];
      float s_t[@STEP@], w_t[@STEP@];
      bool c_old[@STEP@];
      Ticket tk[@STEP@];
#pragma unroll
      for (int h = 0; h < @STEP@; ++h) {
        const int j = j0 + h * kBlock;
        const bool in = j < hi;
        k[h] = in ? cnt[j] : 0;
        at[h] = mine + (in ? c.loc[j] : 0);
        s_t[h] = in ? c.s[j] : 0.0f;
        w_t[h] = in ? c.w[j] : 0.0f;
        t_old[h] = in ? c.term[j] : 0;
        c_old[h] = in && c.conv[j] != 0;
      }
#pragma unroll
      for (int h = 0; h < @STEP@; ++h) {
        const int j = j0 + h * kBlock;
        tk[h] = next && j < hi ? count_send(c.g, k1, k2, j, cnt_next) : Ticket{-1, 0};
      }
      float s_new[@STEP@], w_new[@STEP@];
      int t_new[@STEP@], cv[@STEP@];
#pragma unroll
      for (int h = 0; h < @STEP@; ++h) {
        const int j = j0 + h * kBlock;
        cv[h] = gossip::scatter::pushsum_round(
            s_t[h], w_t[h], t_old[h], c_old[h], j < hi && sends(c.g, j),
            [&](float& a, float& b) {
              gossip::scatter::record_sum(c.rec + at[h], k[h], a, b);
            },
            c.delta, c.term_rounds, s_new[h], w_new[h], t_new[h]);
      }
#pragma unroll
      for (int h = 0; h < @STEP@; ++h) {
        const int j = j0 + h * kBlock;
        if (j >= hi) continue;
        if (k[h] > 0) cnt[j] = 0;
        c.s[j] = s_new[h];
        c.w[j] = w_new[h];
        c.term[j] = t_new[h];
        c.conv[j] = (uint8_t)cv[h];
        if (next) c.tick[j] = tk[h];
        converged += cv[h];
      }
    }
"""

# The global timer after every barrier of the push-sum round, into the
# slice totals' plane past the grid's own (int64 slots 512 on).
STAMP = """
#define STAMP(slot)                                                        \\
  if (blockIdx.x == 0 && threadIdx.x == 0 && (slot) < 512) {               \\
    unsigned long long t_;                                                 \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \\
    ((unsigned long long*)c.tot)[512 + (slot)] = t_;                       \\
  }
"""
STAMPED = (("namespace {\n", STAMP + "namespace {\n", 1),
           ("round_barrier(c.words + 3 * c.rounds, 0);",
            "round_barrier(c.words + 3 * c.rounds, 0);\n  STAMP(0);", 1),
           ("round_barrier(c.words + 3 * r, 0);",
            "round_barrier(c.words + 3 * r, 0);\n    STAMP(3 * r + 1);", 1),
           ("round_barrier(c.words + 3 * r + 1, 0);",
            "round_barrier(c.words + 3 * r + 1, 0);\n    STAMP(3 * r + 2);", 1),
           ("const int sum = round_barrier(c.words + 3 * r + 2, block_sum(converged));",
            "const int sum = round_barrier(c.words + 3 * r + 2, block_sum(converged));\n"
            "    STAMP(3 * r + 3);", 1))

SCAN_ITEMS = "constexpr int kScanItems = 4;"
NODES = "constexpr int kNodesPerThread = 2;"
SORT_MAX = "constexpr int kSortMax = 8;"
PUSHSUM_KERNEL = "__global__ void __launch_bounds__(kBlock, F ? 2 : 3)\n    pushsum_rounds("


def _sub(text, old, new, count):
    if text.count(old) != count:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _edits(text, edits):
    for old, new, count in edits:
        text = _sub(text, old, new, count)
    return text


def _stepped(text, loop, template, step):
    """``text`` with the loop that runs from ``loop[0]`` to ``loop[1]``
    replaced by ``template`` in steps of ``step`` nodes."""
    first, stop = loop
    if text.count(first) != 1 or text.count(stop) != 1:
        raise RuntimeError(f"variant edit does not apply: {first[:60]!r}")
    a, b = text.index(first), text.index(stop)
    return text[:a] + template.replace("@STEP@", str(step)) + text[b:]


def variants(cu: str, cuh: str) -> dict:
    """{name: (scatter.cu text, scatter.cuh text)}: the committed source as
    ``base``, each variant of it, and the split (name ``split_barrier``)."""
    out = {"base": (cu, cuh), "stamped": (_edits(cu, STAMPED), cuh),
           "cursor": (_edits(cu, CURSOR), cuh), "planes": (_edits(cu, PLANES), cuh),
           "scan1": (_sub(cu, SCAN_ITEMS, "constexpr int kScanItems = 1;", 1), cuh)}
    for nodes in (1, 4, 8):
        out[f"grid{nodes}"] = (_sub(cu, NODES, f"constexpr int kNodesPerThread = {nodes};",
                                    1), cuh)
    for step in (4, 8):
        out[f"place{step}"] = (_stepped(cu, PLACE_LOOP, STEPPED_PLACE, step), cuh)
    for step in (2, 4):
        out[f"absorb{step}"] = (_stepped(cu, ABSORB_LOOP, STEPPED_ABSORB, step), cuh)
    for blocks, bounds in ((4, "(kBlock, 4)"), (0, "(kBlock)")):
        out[f"lb{blocks}"] = (_sub(cu, PUSHSUM_KERNEL,
                                   PUSHSUM_KERNEL.replace("(kBlock, F ? 2 : 3)", bounds),
                                   1), cuh)
    for cap in (4, 16):
        out[f"sort{cap}"] = (cu, _sub(cuh, SORT_MAX, f"constexpr int kSortMax = {cap};", 1))
    out["split_barrier"] = (_edits(cu, SPLIT_BARRIER), cuh)
    return out


def build(name: str, cu: str, cuh: str, csrc: Path, nvcc_flags, nvcc) -> Path:
    d = ROOT / "build" / "scatter_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(cuh if h.name == "scatter.cuh" else h.read_text())
    (d / "scatter.cu").write_text(cu)
    lib = d / "libscatter.so"
    proc = subprocess.run([nvcc, *nvcc_flags, "-I", str(d), "-o", str(lib),
                           str(d / "scatter.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    # The round kernels' spills and registers.
    regs = [f"{log[i + 2].strip()}; {log[i + 3].strip()}" for i, line in enumerate(log[:-3])
            if "Compiling entry function" in line and "_rounds" in line]
    print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return lib


def pass_times(graph, rounds: int) -> dict:
    """The stamped variant's last chunk split by pass: the median µs from
    one barrier's exit to the next's over its rounds (scan, place and
    absorb, each with the barrier after it), from the global timer block
    0 read into the slice totals' plane."""
    import torch

    stamps = graph.work["totals"].view(torch.int64)[512:512 + 3 * rounds + 1].tolist()
    gaps = [(b - a) / 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    return {name: statistics.median(gaps[i::3]) for i, name in
            enumerate(("scan", "place", "absorb"))}


def yardsticks(graph, key, start: int) -> dict:
    """µs of one PyTorch call for each memory pattern of a push-sum round's
    passes, on round ``start``'s targets (median of 5 by CUDA events)."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.ops import sampling, scatter

    targets, send_ok = scatter.round_targets(graph, sampling.round_key(key, start))
    t = targets[send_ok].long()
    m, dev = t.shape[0], t.device
    offsets = torch.zeros(graph.n, dtype=torch.int32, device=dev)
    records = torch.zeros(m, 4, dtype=torch.int32, device=dev)
    rows = torch.ones(m, 4, dtype=torch.int32, device=dev)
    slots = torch.randperm(m, device=dev)
    counts = torch.zeros(graph.n, dtype=torch.int32, device=dev)
    ones = torch.ones(m, dtype=torch.int32, device=dev)
    calls = {"take": lambda: torch.take(offsets, t),
             "index_copy_16B": lambda: records.index_copy_(0, slots, rows),
             "index_add_int32": lambda: counts.index_add_(0, t, ones)}
    out = {}
    for name, fn in calls.items():
        fn()
        samples = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b) * 1e3)
        out[name] = statistics.median(samples)
    return out


def main() -> int:
    import concurrent.futures
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from cop5615_gossip_protocol_tpu_torch import build_topology
    from cop5615_gossip_protocol_tpu_torch.ops import fused, rng, scatter
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    csrc = kernels.CSRC
    texts = variants(*((csrc / f).read_text() for f in ("scatter.cu", "scatter.cuh")))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: build(kv[0], *kv[1], csrc, kernels.NVCC_FLAGS, kernels.nvcc_path()),
            texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load = kernels.load
    key = rng.PRNGKey(0)
    round_keys = functools.lru_cache(maxsize=None)(
        lambda start, count: fused.round_keys(key, start, count))
    dev = torch.device("cuda", 0)
    order = list(texts) + list(reversed(texts))
    for algorithm, kind, n, semantics, start, count in CASES:
        topo = build_topology(kind, n, semantics=semantics)
        graph = scatter.scatter_graph(topo, dev)
        kern, _, chunk, init = scatter_fns(dev, key, topo, graph, algorithm, semantics,
                                           round_keys)
        state = chunk(kern, init, 0, start)[0]
        times, want, passes = {}, None, []
        for variant in order:
            kernels.load = (lambda lib: (lambda source: lib if source == "scatter"
                                         else real_load(source)))(loaded[variant])

            def call():
                return chunk(kern, state, start, count)

            out, st = call()
            torch.cuda.synchronize()
            got = (tuple(x.view(torch.int32) if x.dtype == torch.float32 else x
                         for x in out), st.tolist())
            if want is None:
                want = got
            elif not variant.startswith("split_") and (
                    got[1] != want[1] or not all(
                        torch.equal(a, b) for a, b in zip(got[0], want[0]))):
                raise AssertionError(f"{variant}: {algorithm} {kind} n={topo.n} differs "
                                     f"from base")
            samples = []
            for _ in range(REPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                samples.append(a.elapsed_time(b))
            if variant == "stamped" and algorithm == "push-sum":
                passes.append(pass_times(graph, want[1][0] - start))
            if variant.startswith("split_"):
                # The split leaves staged counts or receipts behind.
                for plane in graph.work.values():
                    if plane.dtype == torch.int32:
                        plane.zero_()
            times.setdefault(variant, []).append(
                statistics.median(samples) * 1e3 / (want[1][0] - start))
        kernels.load = real_load
        print(json.dumps({"kernel": f"{algorithm}_scatter_chunk", "topology": kind,
                          "n": topo.n, "start": start, "chunk": count,
                          "rounds": want[1][0] - start, "us_per_round": times,
                          "stamped_us_per_pass": passes,
                          "yardsticks_us": yardsticks(graph, key, start),
                          "bitwise": True}), flush=True)
        del state, init, graph
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
