#!/usr/bin/env python3
"""Time kernel A's delay instances (csrc/scatter.cu, kDelay: the ring of
deliveries in flight) against variants of their ring accesses on one
NVIDIA GPU.

    python3 scripts/scatter_ring_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is the committed scatter.cu with one textual change, built
with the port's nvcc flags into build/scatter_variants/<variant>/ and
loaded in place of the committed library for the same wrapper calls
(scripts/scatter_round_variants.py's build helpers):

- ``base``: the committed source (push-sum: each node's words of the
  round's slot read at the top of its absorb step, before its count,
  state and bucket loads, and written with the fresh inboxes after its
  bucket is summed; gossip: read and written where its receipts are);
- ``stamped``: the committed source with the global timer read by one
  thread after every barrier, which splits a push-sum round into its
  scan, place and absorb passes;
- ``stream``: the ring read and written past the L2 (``__ldcs``,
  ``__stcs``: evict first);
- ``late``: push-sum's ring words read after the bucket is summed, just
  before they are written (the instance's first form).

And one split, timed only (its result is not compared): ``split_noring``, the
ring neither read nor written (each node absorbs its fresh inbox, as the
dup instance does).

For full 1,000,000, push-sum and gossip under delay_rounds 3 (and push-sum
with dup_rate 0.05 too), from chip_smoke.py's round-16 carry, a 32-round
chunk is held bitwise against the committed kernel's (planes, ring,
status) and timed by CUDA events (median of 5, after a warm call), every
variant twice (in order, then reversed), beside the faulted instance
without the ring on the same protocol state. Prints each variant's
registers and spills, one JSON line a case (µs a round and, for the
stamped variant, each push-sum pass's median µs), then the card's name and
power limit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke as cs  # noqa: E402  (phase 14q's configs, shared)
import scatter_round_variants as srv  # noqa: E402  (its build helpers and the stamps)

REPS = 5
CASES = (("push-sum", {"delay_rounds": 3}), ("push-sum", cs.DD_KW),
         ("gossip", {"delay_rounds": 3}))

READ_PS = "arrive_s = ring[j];\n        arrive_w = ring[n + j];"
WRITE_PS = "ring[j] = in_s;\n          ring[n + j] = in_w;"
READ_GO = "const int arrive = ring[j];"
WRITE_GO = "ring[j] = got;"
STREAM = ((READ_PS, "arrive_s = __ldcs(ring + j);\n        arrive_w = __ldcs(ring + n + j);", 1),
          (WRITE_PS, "__stcs(ring + j, in_s);\n          __stcs(ring + n + j, in_w);", 1),
          (READ_GO, "const int arrive = __ldcs(ring + j);", 1),
          (WRITE_GO, "__stcs(ring + j, got);", 1))
LATE = ((READ_PS, "", 1),
        (WRITE_PS, "arrive_s = ring[j];\n          arrive_w = ring[n + j];\n          " + WRITE_PS, 1))
NORING = ((READ_PS, "", 1), (WRITE_PS, "arrive_s = in_s;\n          arrive_w = in_w;", 1),
          (READ_GO, "const int arrive = got;", 1), (WRITE_GO, "", 1))


def variants(cu: str, cuh: str) -> dict:
    """{name: (scatter.cu text, scatter.cuh text)}."""
    return {"base": (cu, cuh), "stamped": (srv._edits(cu, srv.STAMPED), cuh),
            "stream": (srv._edits(cu, STREAM), cuh), "late": (srv._edits(cu, LATE), cuh),
            "split_noring": (srv._edits(cu, NORING), cuh)}


def timed(fn) -> float:
    """Median ms of fn() by CUDA events, after one warm call."""
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


def words(carry) -> list:
    """A carry's planes and ring as int32 views, for a bitwise compare."""
    import torch

    from cop5615_gossip_protocol_tpu_torch.models import pipeline

    planes = list(pipeline.proto_of(carry))
    if isinstance(carry, pipeline.Ringed):
        planes.append(carry.ring)
    return [x.view(torch.int32) if x.dtype == torch.float32 else x for x in planes]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from cop5615_gossip_protocol_tpu_torch.models import pipeline
    from cop5615_gossip_protocol_tpu_torch.ops import rng
    from cop5615_gossip_protocol_tpu_torch.utils import kernels

    csrc = kernels.CSRC
    texts = variants(*((csrc / f).read_text() for f in ("scatter.cu", "scatter.cuh")))
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: srv.build(kv[0], *kv[1], csrc, kernels.NVCC_FLAGS,
                                 kernels.nvcc_path()), texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load = kernels.load
    key = rng.PRNGKey(0)
    dev = torch.device("cuda", 0)
    order = list(texts) + list(reversed(texts))
    for algorithm, kw in CASES:
        kernels.load = real_load
        f = cs.dd_fns(dev, key, "full", cs.N, algorithm, kw, False)
        mid, st, _ = f.chunk(f.kern, f.init, 0, cs.DD_MID)
        base_fx = dataclasses.replace(f.faults, delay=0, dup_thresh=None, planes={})
        proto = pipeline.proto_of(mid)
        times, want, passes = {}, None, []
        for variant in order:
            kernels.load = (lambda lib: (lambda source: lib if source == "scatter"
                                         else real_load(source)))(loaded[variant])

            def call():
                return f.chunk(f.kern, mid, cs.DD_MID, cs.CHUNK)

            out, st, _ = call()
            torch.cuda.synchronize()
            got = (words(out), st.tolist())
            if want is None:
                want = got
            elif not variant.startswith("split_") and (
                    got[1] != want[1] or not all(
                        torch.equal(a, b) for a, b in zip(got[0], want[0]))):
                raise AssertionError(f"{variant}: {algorithm} {kw} differs from base")
            ms = timed(call)
            if variant == "stamped" and algorithm == "push-sum":
                passes.append(srv.pass_times(f.graph, want[1][0] - cs.DD_MID))
            times.setdefault(variant, []).append(ms)
        kernels.load = real_load
        without = timed(lambda: f.chunk(f.kern, proto, cs.DD_MID, cs.CHUNK, base_fx))
        rounds = want[1][0] - cs.DD_MID
        rec = {"case": f"{algorithm} full {cs.N} {kw}", "rounds": rounds,
               "us_per_round": {v: [t * 1e3 / rounds for t in ts] for v, ts in times.items()},
               "without_ring_us_per_round": without * 1e3 / rounds}
        if passes:
            rec["stamped_pass_us"] = passes
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
