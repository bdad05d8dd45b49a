"""Which nodes of the JAX package's compiled push-sum round keep a half in
the scalar remainder's form (ROADMAP C4).

XLA on the CPU emits each fused loop over the n nodes as an LLVM loop that
the loop vectorizer splits into a vector body, sometimes a narrower vector
epilogue, and a scalar remainder. Under the subnormal flush the vector
lanes keep ``flush(x / 2)`` and the scalar ones ``x - flush(x / 2)``. From
a state with every s and w at 1.91e-38 (each half subnormal), one round of
the JAX chunked engine leaves 0 in a sender's kept half in the vector
form and 1.91e-38 in the remainder's, so the nodes holding 1.91e-38 after
the round are the remainder (or, where a plane holds it everywhere, a loop
XLA did not vectorize).

    python scripts/xla_remainder_tails.py line auto '{}' 257 288

prints one JSON line per n: the population and, for s and w, "none",
"all", "tail k" (the last k nodes) or the set. It runs the JAX package on
the CPU and takes a second or two a population.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cop5615_gossip_protocol_tpu import SimConfig, build_topology  # noqa: E402
from cop5615_gossip_protocol_tpu.models import pushsum, runner  # noqa: E402

TINY = np.float32(1.91e-38)


def describe(held, m):
    if len(held) == 0:
        return "none"
    if len(held) == m:
        return "all"
    if (held == np.arange(held[0], m)).all():
        return f"tail {m - held[0]}"
    return f"set {held.tolist()}"


def main(kind, delivery, knobs, lo, hi):
    for n in range(lo, hi + 1):
        topo = build_topology(kind, n)
        m = topo.n
        cfg = SimConfig(n=n, topology=kind, algorithm="push-sum", delivery=delivery,
                        engine="chunked", max_rounds=101, **knobs)
        seen = {}
        state = pushsum.PushSumState(jnp.full(m, TINY), jnp.full(m, TINY),
                                     jnp.zeros(m, jnp.int32), jnp.zeros(m, bool))
        runner.run(topo, cfg, start_state=state, start_round=100,
                   on_chunk=lambda r, st: seen.update(state=st))
        s, w = np.asarray(seen["state"].s), np.asarray(seen["state"].w)
        print(json.dumps({"n": m, "r": m % 32,
                          "s": describe(np.nonzero(s == TINY)[0], m),
                          "w": describe(np.nonzero(w == TINY)[0], m)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]))
