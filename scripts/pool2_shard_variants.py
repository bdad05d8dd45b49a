#!/usr/bin/env python3
"""Time variants of the PyTorch port's replicated-pool2 round kernel (rows
20-21) beside the streaming pool tier's chunk (rows 3-4) on one NVIDIA GPU.

    python3 scripts/pool2_shard_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each variant is the committed cop5615_gossip_protocol_tpu_torch/csrc/
fused_pool2_shard.cu with one textual change, built with the port's nvcc
flags into build/pool2_shard_variants/<variant>/ and loaded in place of the
committed library for the same wrapper calls:

- ``base``: the committed source (one launch over every row of the card,
  the summary planes read in place at global indices, the plane pointers
  of the round kernels declared ``__restrict__``);
- ``no_restrict``: the same without ``__restrict__``, as csrc/fused_pool2.cu
  declares its planes.

For full 16,777,216 in 4 shards on the one card (push-sum from round 40,
gossip from round 8, the chip_smoke.py mid-run states), pool_size 2, each
variant runs 32 rounds as 32 launches (ping/pong, the verdict in the
launch against a target no round reaches), held bitwise against the
committed kernel's result, and the committed streaming pool chunk (rows
3-4, csrc/fused_pool2.cu: an init launch, a launch a round and a finish
launch) runs 32 and 256 rounds from the same state (gossip stops where it
converges). Each is timed by CUDA events (median of 5, after a warm call),
every variant twice: in order, then in reverse order. Prints one JSON line a protocol (µs a round), then
the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (POOL2_MID, pool2_case, shard_case, shard_launch,  # noqa: E402
                        shard_planes, shard_streams)

N, SHARDS, ROUNDS, LONG, REPS = 2**24, 4, 32, 256, 5


def variants(src: str) -> dict:
    """{name: fused_pool2_shard.cu text}."""
    if src.count(" __restrict__") < 5:
        raise RuntimeError("variant edit does not apply: __restrict__")
    return {"base": src, "no_restrict": src.replace(" __restrict__", "")}


def build(name: str, text: str, csrc: Path, nvcc_flags, nvcc) -> Path:
    d = ROOT / "build" / "pool2_shard_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "fused_pool2_shard.cu").write_text(text)
    lib = d / "libfused_pool2_shard.so"
    proc = subprocess.run([nvcc, *nvcc_flags, "-I", str(d), "-o", str(lib),
                           str(d / "fused_pool2_shard.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    regs = [f"{log[i + 2].strip()}; {log[i + 3].strip()}" for i, line in enumerate(log[:-3])
            if "Compiling entry function" in line and "shard_round" in line]
    print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return lib


def timed(call, rounds: int) -> float:
    """µs a round of ``call()`` (``rounds`` rounds), median of REPS."""
    import torch

    call()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples) * 1e3 / rounds


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
    texts = variants((csrc / "fused_pool2_shard.cu").read_text())
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(texts, pool.map(
            lambda kv: build(kv[0], kv[1], csrc, kernels.NVCC_FLAGS, kernels.nvcc_path()),
            texts.items())))
    loaded = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    real_load = kernels.load
    key = rng.PRNGKey(0)
    dev = torch.device("cuda", 0)
    order = list(texts) + list(reversed(texts))
    for name, algorithm in (("pushsum", "push-sum"), ("gossip", "gossip")):
        p2_kern, _, chunk, init = pool2_case(dev, key, N, algorithm)
        start = POOL2_MID[name]
        mid, _ = chunk(p2_kern, init, 0, start)
        kern, _, kw, _, layout, _, _ = shard_case(dev, key, N, SHARDS, algorithm)
        R = layout.rows
        state = shard_planes(mid, algorithm)
        streams = shard_streams(key, start, ROUNDS, N, dev)
        times, want = {}, None
        for variant in order:
            kernels.load = (lambda lib: (lambda source: lib if source == "fused_pool2_shard"
                                         else real_load(source)))(loaded[variant])
            sets = [tuple(x.clone() for x in state), tuple(torch.empty_like(x) for x in state)]
            ctl = {"u": None, "acc": torch.zeros(2, dtype=torch.int32, device=dev),
                   "ctrl": torch.zeros(2, dtype=torch.int32, device=dev), "target": N + 1}

            def call(sets=sets, ctl=ctl):
                for i in range(ROUNDS):
                    shard_launch(kern, algorithm, kw, sets[i % 2], sets[1 - i % 2], streams,
                                 i, 0, R, **ctl)

            call()
            torch.cuda.synchronize()
            got = tuple((x.view(torch.int32) if x.dtype == torch.float32 else x).clone()
                        for x in sets[ROUNDS % 2])
            if want is None:
                want = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{variant}: {name} differs from base")
            times.setdefault(variant, []).append(timed(call, ROUNDS))
        kernels.load = real_load
        for count in (ROUNDS, LONG):
            out, ex = chunk(p2_kern, mid, start, count)
            times[f"pool2_chunk_{count}"] = [
                timed(lambda: chunk(p2_kern, mid, start, count), int(ex)) for _ in range(2)]
            del out
        print(json.dumps({"kernel": f"{name}_pool2_shard_round", "n": N, "shards": SHARDS,
                          "start": start, "us_per_round": times, "bitwise": True}),
              flush=True)
        del init, mid, state, streams
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
