#!/usr/bin/env python3
"""Time variants of the PyTorch port's pool round kernel on one NVIDIA GPU.

    python3 scripts/pool_round_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is the committed cop5615_gossip_protocol_tpu_torch/csrc/
fused_pool.cu and csrc/pool.cuh with one textual change, built with the
port's nvcc flags into build/pool_variants/<variant>/ and loaded in place of
the committed library for the same wrapper calls:

- ``base``: the committed source (a thread a packed choice word, which
  hashes it once and walks its 8 nodes, one lane 128 rows apart, so a warp
  reads 32 consecutive nodes a step; the loads (own state and slot
  gathers) of 1 node for push-sum and of 4 nodes for gossip issued together
  before their stores; the slot loop unrolled at a compile-time pool width;
  a slot source's s and w loaded whatever its mark);
- ``pushsum_step2``: push-sum's loads of 2 nodes issued together;
- ``gossip_step1``, ``gossip_step2``, ``gossip_step8``: gossip's of 1, 2
  or all 8 nodes;
- ``node``: a thread a node over the plain grid-stride order, each hashing
  the packed word of its own next mark (8 hashes a word);
- ``runtime_width``: the slot loops unrolled to the cap of 16 with a test
  of each slot against a width the compiler cannot see, as in a kernel
  built for any pool width;
- ``lazy_own``: the own state loaded through the absorb's accessors, after
  the gathers, as csrc/chunk.cuh's absorb_node helpers do;
- ``late``: a slot source's s and w loaded only when its mark is the slot;
- ``lb8``: the round kernels built for 8 resident blocks an SM
  (``__launch_bounds__``: 32 registers).

And three splits of the committed kernel, which compute something else and
are timed only to split a round (their results are not compared):

- ``split_barrier``: the rounds' loops empty, so a round is its barrier
  (and its block sum);
- ``split_no_next``: no next-round marks written (no hash, no mark store);
- ``split_no_gather``: every inbox empty (no slot source read).

For full 1,000,000 (push-sum from round 300, gossip from round 8) and
2,097,152 (the tier's cap, both from round 0), pool_size 2, each variant
runs one 32-round chunk and one 1,024-round chunk (cut where the run
converges), held bitwise against the committed kernel's result (the splits
run every round of the chunk and are not compared), and is timed by CUDA
events (median of 5, after a warm call), every variant twice: in order,
then in reverse order. Prints one JSON line a case and chunk length (µs a
round), then the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import pool_fns  # noqa: E402  (the rows' cases, shared)

CHUNKS = (32, 1024)
REPS = 5
CASES = (("pushsum", 1_000_000, True), ("gossip", 1_000_000, True),
         ("pushsum", 2**21, False), ("gossip", 2**21, False))

# The round kernels' declarations, for launch bounds.
KERNELS = ("__global__ void pushsum_rounds(", "__global__ void gossip_rounds(")

# Nodes of a walk whose loads issue together.
PUSHSUM_STEP = "constexpr int kPushSumStep = 1;"
GOSSIP_STEP = "constexpr int kGossipStep = 4;"

# The committed walk (a thread a packed word, its 8 nodes in steps) turned
# into a thread a node: the loop over nodes, each hashing its own word.
NODE = (("wi < c.n_pad / kChoicePack;", "wi < c.n_pad;", 2),
        ("next ? pool_word(k0, k1, word_node(wi, 0))", "next ? pool_word(k0, k1, wi)", 2),
        ("sub0 < kChoicePack;", "sub0 < 1;", 2),
        ("word_node(wi, sub0 + h)", "wi", 4),
        (GOSSIP_STEP, "constexpr int kGossipStep = 1;", 1),
        ("pushsum_rounds<P, F>, c.n_pad / kChoicePack,",
         "pushsum_rounds<P, F>, c.n_pad,", 1),
        ("gossip_rounds<P, F>, c.n_pad / kChoicePack,",
         "gossip_rounds<P, F>, c.n_pad,", 1))

# The slot loops (csrc/pool.cuh) at a width hidden from the compiler.
SLOT_LOOP = "#pragma unroll\n  for (int k = 0; k < P; ++k)"
RUNTIME_LOOP = """  int width = P;
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(width));
#endif
#pragma unroll
  for (int k = 0; k < 16; ++k) if (k < width)"""

# The own state loaded with the gathers (committed) or through the absorb's
# accessors, after them.
LAZY = (("""          s_t[h] = cur_s[j];
          w_t[h] = cur_w[j];
          t_old[h] = a.term[j];
          c_old[h] = a.conv[j];
""", "", 1),
        ("""              s_t[h], w_t[h], [&] { return t_old[h]; },
              [&] { return c_old[h] != 0; },""",
         """              cur_s[j], cur_w[j], [&] { return a.term[j]; },
              [&] { return a.conv[j] != 0; },""", 1),
        ("""          count0[h] = c.a.count[j];
          flags0[h] = c.flags[j];
""", "", 1),
        ("""              [&] { return (flags0[h] & kConv) != 0; },
              [&] { return count0[h]; }, [&] { return flags0[h] & kActive; },""",
         """              [&] { return (c.flags[j] & kConv) != 0; },
              [&] { return c.a.count[j]; }, [&] { return c.flags[j] & kActive; },""", 1))

# The gathers (csrc/pool.cuh, pool_pushsum_inbox) with the loads after the
# mark compare.
EARLY = """    const float si = s[i], wi = w[i];
    const bool hit = mark[i] == k;
    in_s = in_s + (hit ? si * 0.5f : 0.0f);
    in_w = in_w + (hit ? wi * 0.5f : 0.0f);"""
LATE = """    float vs = 0.0f, vw = 0.0f;
    if (mark[i] == k) {
      vs = s[i] * 0.5f;
      vw = w[i] * 0.5f;
    }
    in_s = in_s + vs;
    in_w = in_w + vw;"""

# The splits' edits.
NEXT = "r + 1 < c.rounds ? c.mark + ((r + 1) & 1) * c.n_pad : nullptr;"
NO_GATHER = (("if (j < c.n)\n            gossip::pool_pushsum_inbox<P>(",
              "if (false)\n            gossip::pool_pushsum_inbox<P>(", 1),
             ("j < c.n ? gossip::pool_gossip_inbox<P>(od, mk, j, c.n) : 0", "0", 1))


def _sub(text, old, new, count):
    if text.count(old) != count:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _edits(text, edits):
    for old, new, count in edits:
        text = _sub(text, old, new, count)
    return text


def variants(pool_src: str, cuh_src: str) -> dict:
    """{name: (fused_pool.cu text, {header: text})}: the committed source as
    ``base``, each variant of it, and the splits (names ``split_*``)."""
    same = {}
    lb8 = _edits(pool_src, [(d, d.replace("__global__ void",
                                          "__global__ void __launch_bounds__(kBlock, 8)"), 1)
                            for d in KERNELS])
    return {
        "base": (pool_src, same),
        "pushsum_step2": (_sub(pool_src, PUSHSUM_STEP, "constexpr int kPushSumStep = 2;", 1),
                          same),
        "gossip_step1": (_sub(pool_src, GOSSIP_STEP, "constexpr int kGossipStep = 1;", 1), same),
        "gossip_step2": (_sub(pool_src, GOSSIP_STEP, "constexpr int kGossipStep = 2;", 1), same),
        "gossip_step8": (_sub(pool_src, GOSSIP_STEP, "constexpr int kGossipStep = 8;", 1), same),
        "node": (_edits(pool_src, NODE), same),
        "runtime_width": (pool_src, {"pool.cuh": _sub(cuh_src, SLOT_LOOP, RUNTIME_LOOP, 2)}),
        "lazy_own": (_edits(pool_src, LAZY), same),
        "late": (pool_src, {"pool.cuh": _sub(cuh_src, EARLY, LATE, 1)}),
        "lb8": (lb8, same),
        "split_barrier": (_sub(pool_src, "wi < c.n_pad / kChoicePack;", "wi < 0;", 2), same),
        "split_no_next": (_sub(pool_src, NEXT, "nullptr;", 2), same),
        "split_no_gather": (_edits(pool_src, NO_GATHER), same),
    }


def build(name: str, pool_text: str, headers: dict, csrc: Path, nvcc_flags, nvcc) -> Path:
    d = ROOT / "build" / "pool_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(headers.get(h.name) or h.read_text())
    (d / "fused_pool.cu").write_text(pool_text)
    lib = d / "libfused_pool.so"
    proc = subprocess.run([nvcc, *nvcc_flags, "-I", str(d), "-o", str(lib),
                           str(d / "fused_pool.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    # The round kernels' spills and registers at pool width 2.
    regs = [f"{log[i + 2].strip()}; {log[i + 3].strip()}" for i, line in enumerate(log[:-3])
            if "Compiling entry function" in line and "_roundsILi2E" in line]
    print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return lib


def main() -> int:
    import concurrent.futures
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from cop5615_gossip_protocol_tpu_torch.ops import rng
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    csrc = kernels.CSRC
    texts = variants(*((csrc / f).read_text() for f in ("fused_pool.cu", "pool.cuh")))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: build(kv[0], *kv[1], csrc, kernels.NVCC_FLAGS, kernels.nvcc_path()),
            texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load = kernels.load
    key = rng.PRNGKey(0)
    dev = torch.device("cuda", 0)
    order = list(texts) + list(reversed(texts))
    for name, n, from_mid in CASES:
        kern, _, chunk, init, _, mid_round = pool_fns(dev, key, n)[0][name]
        start = mid_round if from_mid else 0
        state = chunk(kern, init, 0, start)[0] if start else init
        for count in CHUNKS:
            times, want = {}, None
            for variant in order:
                kernels.load = (lambda lib: (lambda source: lib if source == "fused_pool"
                                             else real_load(source)))(loaded[variant])

                def call():
                    return chunk(kern, state, start, count)

                out, ex = call()
                torch.cuda.synchronize()
                got = tuple(x.view(torch.int32) if x.dtype == torch.float32 else x
                            for x in out)
                if want is None:
                    want = (got, int(ex))
                elif variant.startswith("split_"):
                    pass
                elif int(ex) != want[1] or not all(
                        torch.equal(a, b) for a, b in zip(got, want[0])):
                    raise AssertionError(f"{variant}: {name} n={n} K={count} differs from base")
                samples = []
                for _ in range(REPS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    b.synchronize()
                    samples.append(a.elapsed_time(b))
                times.setdefault(variant, []).append(
                    statistics.median(samples) * 1e3 / int(ex))
            kernels.load = real_load
            print(json.dumps({"kernel": f"{name}_pool_chunk", "n": n, "start": start,
                              "chunk": count, "rounds": want[1], "us_per_round": times,
                              "bitwise": True}), flush=True)
        del state, init
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
