"""Serving plane: the warm-engine cache the replica sweep and the lane
server share (the JAX package's ``serving`` package, the parts this port
carries).

- ``keys`` — the canonical config→engine key (padded-N bucketing,
  fault-class normalization). The single home of engine-cache keying;
  models/sweep.py consults it.
- ``pool`` — the process-wide warm-engine LRU pool those keys index, with
  the quarantine circuit breaker.

The HTTP server, the admission queue, the micro-batcher and the worker
fleet are not ported yet (ROADMAP A9b).

Deliberately import-light: submodules import models/* lazily enough that
``models.sweep`` can import ``serving.keys``/``serving.pool`` without a
cycle.
"""
