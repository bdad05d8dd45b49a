#!/usr/bin/env python3
"""Time variants of the PyTorch port's imp round kernel on one NVIDIA GPU.

    python3 scripts/imp_round_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is the committed cop5615_gossip_protocol_tpu_torch/csrc/
fused_imp.cu and csrc/imp.cuh with one textual change, built with the
port's nvcc flags into build/imp_variants/<variant>/ and loaded in place of
the committed library for the same wrapper calls:

- ``base``: the committed source (one thread a node, the packed choice
  word hashed only by a node whose slot comes out as the long-range one;
  a lattice class source's s and w loaded whatever its mark, a pool class
  source's only on a hit);
- ``word``: a thread takes the 8 nodes of one packed choice word (one lane,
  128 rows apart) and hashes the word once for them;
- ``late``: every class source's s and w loaded only on a hit;
- ``early_all``: every class source's s and w loaded whatever its mark;
- ``word+late``: both (the first form of the one-launch round);
- ``derive``: each node's live directions derived in the pass from its
  index, as the mark launch before the one-launch round did, instead of
  read from the directions word.

For imp3d 16,777,216 (push-sum and gossip) and 1,000,000 (push-sum),
pool_size 4, each variant runs one 32-round chunk from a mid-run state
(push-sum round 300, gossip round 20), held bitwise against the committed
kernel's result, and is timed by CUDA events (median of 5, after a warm
call), every variant twice: in order, then in reverse order. Prints one
JSON line a case, then the card's name and power limit.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHUNK = 32
REPS = 5
MID = {"push-sum": 300, "gossip": 20}
CASES = (("push-sum", 2**24), ("gossip", 2**24), ("push-sum", 1_000_000))

# The committed gathers (csrc/imp.cuh, imp_pushsum_inbox) and the other two
# forms: every source's s and w loaded only on a hit, or all of them
# whatever the mark.
EARLY_LATTICE = """      float vs = 0.0f, vw = 0.0f;
      if (lat) {
        const float si = s[i], wi = w[i];
        const bool hit = mark[i] == k;
        vs = hit ? si * 0.5f : 0.0f;
        vw = hit ? wi * 0.5f : 0.0f;
      } else if (mark[i] == lattice.count + k) {
        vs = s[i] * 0.5f;
        vw = w[i] * 0.5f;
      }"""
LATE = """      float vs = 0.0f, vw = 0.0f;
      if (mark[i] == (lat ? k : lattice.count + k)) {
        vs = s[i] * 0.5f;
        vw = w[i] * 0.5f;
      }"""
EARLY_ALL = """      const float si = s[i], wi = w[i];
      const bool hit = mark[i] == (lat ? k : lattice.count + k);
      const float vs = hit ? si * 0.5f : 0.0f, vw = hit ? wi * 0.5f : 0.0f;"""

# The directions derived in the pass from the node index (the grid's side
# read off its sorted classes: imp3d [1, g, g*g, n-g*g, n-g, n-1], imp2d
# [1, s, n-s, n-1]; a side of 2, where classes alias, is not handled)
# instead of loaded from the directions word.
DERIVE = """__device__ __forceinline__ uint32_t derive_word(const Classes& c, int j) {
  const int g = c.d[1];
  uint32_t word = 0u, deg = 0u;
  auto add = [&](bool live, uint32_t cls) {
    if (live) {
      word |= cls << (4u * deg);
      ++deg;
    }
  };
  if (c.count == 6) {
    const int x = j % g, y = (j / g) % g, z = j / c.d[2];
    add(x > 0, 5u); add(x < g - 1, 0u); add(y > 0, 4u);
    add(y < g - 1, 1u); add(z > 0, 3u); add(z < g - 1, 2u);
  } else {
    const int x = j % g, y = j / g;
    add(x > 0, 3u); add(x < g - 1, 0u); add(y > 0, 2u); add(y < g - 1, 1u);
  }
  return word | (deg << 24);
}

"""

# The word form: a thread takes the 8 nodes of one packed choice word (one
# lane, 128 rows apart) and hashes the word once for them.
NODE_LOOP = """  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;"""
WORD_LOOP = """  for (int wi = blockIdx.x * kBlock + threadIdx.x; wi < n_pad / 8;
       wi += gridDim.x * kBlock) {
    const uint32_t cword =
        next ? gossip::threefry_word(c.a, c.b, (uint32_t)wi) : 0u;
#pragma unroll 1
    for (int sub = 0; sub < 8; ++sub) {
    const int j = (wi / 128 * 8 + sub) * 128 + wi % 128;
    const bool pad = j >= n;"""
# The node loop's end in the gossip round and in the push-sum round (which
# picks its verdict by its global-termination flag G).
LOOP_ENDS = ("  }\n  finish_count(block_sum(count)",
             "  }\n  if constexpr (!G)\n    finish_count(block_sum(count)")
WORD_MARK = """__device__ __forceinline__ int8_t word_mark(uint32_t word, KeyWords k,
                                            uint32_t cword, int j, int pool_size,
                                            int lattice_count) {
  const int q = gossip::imp_lattice_class(
      word, gossip::threefry_word(k.a, k.b, (uint32_t)j));
  return (int8_t)(q >= 0 ? q : lattice_count + gossip::pool_slot(
      cword, gossip::choice_sub(j), pool_size));
}

"""
SEPARATOR = "// ---------------------------------------------------------------- push-sum"
# The round kernels' next-mark call (the prologue's reads pool_size).
ROUND_MARK = re.compile(r"gossip::imp_mark\(words\[j\], k\.a, k\.b, c\.a, c\.b, j,(\s+)pool\.count")


def _sub(text, old, new, count):
    if text.count(old) != count:
        raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _round_marks(text, new):
    out, count = ROUND_MARK.subn(new, text)
    if count != 2:
        raise RuntimeError("variant edit does not apply: the round kernels' marks")
    return out


def variants(imp_src: str, cuh_src: str) -> dict:
    """{name: (fused_imp.cu text, imp.cuh text)}: the committed pair as
    ``base``, and each variant of it."""
    late = _sub(cuh_src, EARLY_LATTICE, LATE, 1)
    word = _sub(imp_src, NODE_LOOP, WORD_LOOP, 2)
    for end in LOOP_ENDS:
        word = _sub(word, end, "  }\n" + end, 1)
    word = _sub(word, SEPARATOR, WORD_MARK + SEPARATOR, 1)
    word = _round_marks(word, r"word_mark(words[j], k, cword, j,\1pool.count")
    for kernel in ("pushsum_round<G>", "gossip_round"):
        word = _sub(word, f"round_grid({kernel}, n_pad,", f"round_grid({kernel}, n_pad / 8,", 1)
    derive = _sub(imp_src, SEPARATOR, DERIVE + SEPARATOR, 1)
    derive = _round_marks(
        derive, r"gossip::imp_mark(derive_word(lattice, j), k.a, k.b, c.a, c.b, j,\1pool.count")
    return {"base": (imp_src, cuh_src), "word": (word, cuh_src), "late": (imp_src, late),
            "early_all": (imp_src, _sub(cuh_src, EARLY_LATTICE, EARLY_ALL, 1)),
            "word+late": (word, late), "derive": (derive, cuh_src)}


def build(name: str, imp_text: str, cuh_text: str, csrc: Path, nvcc_flags, nvcc) -> Path:
    d = ROOT / "build" / "imp_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(cuh_text if h.name == "imp.cuh" else h.read_text())
    (d / "fused_imp.cu").write_text(imp_text)
    lib = d / "libfused_imp.so"
    proc = subprocess.run([nvcc, *nvcc_flags, "-I", str(d), "-o", str(lib),
                           str(d / "fused_imp.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line]
    print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return lib


def main() -> int:
    import concurrent.futures
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology
    from cop5615_gossip_protocol_tpu_torch.models.runner import fused_engine, fused_tier
    from cop5615_gossip_protocol_tpu_torch.ops import rng
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    csrc = kernels.CSRC
    texts = variants((csrc / "fused_imp.cu").read_text(), (csrc / "imp.cuh").read_text())
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: build(kv[0], *kv[1], csrc, kernels.NVCC_FLAGS, kernels.nvcc_path()),
            texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load = kernels.load
    key = rng.PRNGKey(0)
    dev = torch.device("cuda", 0)
    order = list(texts) + list(reversed(texts))
    for algorithm, n in CASES:
        topo = build_topology("imp3d", n)
        cfg = SimConfig(n=n, topology="imp3d", algorithm=algorithm, delivery="pool",
                        pool_size=4)
        tier = fused_tier(topo, cfg)[0]
        eng = fused_engine(topo, cfg, key, tier)
        init = tuple(p.contiguous().to(dev) for p in eng.planes)
        start = MID[algorithm]
        mid, _ = eng.chunk(init, eng.streams(0, start), 0, start)
        streams = eng.streams(start, CHUNK)
        times, want = {}, None
        for name in order:
            kernels.load = (lambda lib: (lambda source: lib if source == "fused_imp"
                                         else real_load(source)))(loaded[name])

            def call():
                return eng.chunk(mid, streams, start, start + CHUNK)

            out, ex = call()
            torch.cuda.synchronize()
            got = tuple(x.view(torch.int32) if x.dtype == torch.float32 else x for x in out)
            if want is None:
                want = (got, int(ex))
            elif int(ex) != want[1] or not all(torch.equal(a, b) for a, b in zip(got, want[0])):
                raise AssertionError(f"{name}: {algorithm} n={n} differs from base")
            samples = []
            for _ in range(REPS):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                samples.append(a.elapsed_time(b))
            times.setdefault(name, []).append(statistics.median(samples) * 1e3 / int(ex))
        kernels.load = real_load
        print(json.dumps({"algorithm": algorithm, "n": topo.n, "tier": tier, "rounds": want[1],
                          "us_per_round": times, "bitwise": True}), flush=True)
        del eng, init, mid, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
