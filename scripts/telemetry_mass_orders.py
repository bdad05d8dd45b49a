#!/usr/bin/env python3
"""How far a float32 Σw in the telemetry kernels' orders lies from
``sum_f32``'s (the JAX chunked engine's) on the push-sum states of
chip_smoke.py's TELE_RUNS: the spread that chip_smoke's ``tele_row_close``
allows between a card row's mass_residual and the JAX package's.

    python3 scripts/telemetry_mass_orders.py [MAX_N]

For each TELE_RUNS push-sum run with telemetry and at most MAX_N nodes
(default 2,000,000) the port runs on the CPU (bitwise the JAX chunked
engine) to the round of chip_smoke's middle row and to its last round; on
each final w plane it sums in sum_f32's order and in kernel A's and the
lattice and pool kernels' orders (ops/telemetry.slice_order,
strided_order, and pool_order on the plane padded to whole 8 x 128 tiles)
on grids of 1 to 512 blocks, and prints the largest difference, in float32
ulps of n beside chip_smoke's limit, max(1e-2, 4 ulp(n)). Runs on the CPU
alone; the runs at 1,000,000 nodes take some minutes.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cop5615_gossip_protocol_tpu_torch import SimConfig, build_topology, run  # noqa: E402
from cop5615_gossip_protocol_tpu_torch.models.pushsum import sum_f32  # noqa: E402
from cop5615_gossip_protocol_tpu_torch.ops import telemetry  # noqa: E402

GRIDS = (1, 7, 40, 132, 197, 264, 396, 512)


def main() -> int:
    max_n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    worst = 0.0
    for label, _kernel, kind, n, algo, kw, want, tele in chip_smoke.TELE_RUNS:
        if tele is None or algo != "push-sum" or n > max_n:
            continue
        topo = build_topology(kind, n)
        ulp = float(np.spacing(np.float32(topo.n)))
        limit = max(1e-2, 4 * ulp)
        for rounds in (tele[1] + 1, want[0]):
            t0 = time.perf_counter()
            cfg = SimConfig(n=n, topology=kind, algorithm=algo,
                            **dict(kw, max_rounds=rounds, telemetry=False))
            w = run(topo, cfg, device="cpu").state.w.reshape(-1)[:topo.n].contiguous()
            ref = float(sum_f32(w))
            grids = sorted(set(GRIDS) | {max(1, -(-topo.n // 512))})
            # The pool kernels walk a plane padded to whole 8 x 128 tiles.
            w_pad = torch.cat([w, w.new_zeros(-topo.n % 1024)])
            sums = [telemetry.kernel_sum(w, order(g, topo.n)) for g in grids
                    for order in (telemetry.slice_order, telemetry.strided_order)]
            sums += [telemetry.kernel_sum(w_pad, telemetry.pool_order(g, w_pad.numel()))
                     for g in grids]
            diff = max(abs(float(x) - ref) for x in sums)
            worst = max(worst, diff / ulp)
            print(f"{label} (n={topo.n:,}) after round {rounds - 1}: Σw - n {ref - topo.n:.9g}, "
                  f"largest order difference {diff:.9g} = {diff / ulp:.2f} ulp(n), "
                  f"limit {limit:.6g} ({time.perf_counter() - t0:.0f} s)", flush=True)
    print(f"largest difference: {worst:.2f} ulp(n)")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
