"""Warm engine pool — a process-wide LRU keyed by the canonical engine
keys (serving/keys.py), the JAX package's serving/pool.py.

A batch engine (models/sweep.py) holds everything built once for a
(config class, topology, device, lane count): the chunk function over the
topology's device tensors, the failure-model planes and the kernels'
scratch. The pool stores it under the canonical key, so identical-shape
sweeps and serving buckets reuse it instead of rebuilding it.

Entries are whole engines; eviction drops the engine (and with it its
device tensors) once the LRU capacity (``GOSSIP_TPU_ENGINE_POOL_CAP``,
default 64) is exceeded. Thread-safe: the serving plane's threads share
the default pool.

Accounting: hit/miss/eviction/invalidation counts also land in a metrics
registry (utils/obs.py — ``gossip_tpu_engine_pool_*``), so the warm/cold
economics are scrapeable from ``--metrics-dump`` next to the run series.
The default pool reports into the process-wide default registry; tests pin
exact eviction sequences against a private one.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Tuple

from ..utils import obs

DEFAULT_CAPACITY = 64


class WarmEnginePool:
    """LRU of canonical-key → engine (any build product). ``get_or_build``
    returns ``(engine, hit)`` so callers can report warm/cold per
    dispatch."""

    def __init__(self, capacity: int | None = None,
                 registry: obs.Registry | None = None):
        if capacity is None:
            capacity = int(
                os.environ.get("GOSSIP_TPU_ENGINE_POOL_CAP", "")
                or DEFAULT_CAPACITY
            )
        if capacity < 1:
            raise ValueError(f"pool capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # Reentrant: a builder that consults the pool again must not wedge
        # its thread against itself. Cross-thread builds stay serialized.
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        reg = registry if registry is not None else obs.default_registry()
        self._c_hits = reg.counter(
            "gossip_tpu_engine_pool_hits_total",
            "warm-engine pool lookups served from a live executable")
        self._c_misses = reg.counter(
            "gossip_tpu_engine_pool_misses_total",
            "warm-engine pool lookups that built a fresh engine")
        self._c_evictions = reg.counter(
            "gossip_tpu_engine_pool_evictions_total",
            "engines dropped by the LRU capacity bound")
        self._c_invalidations = reg.counter(
            "gossip_tpu_engine_pool_invalidations_total",
            "engines dropped by quarantine invalidation (circuit breaker)")
        self._g_entries = reg.gauge(
            "gossip_tpu_engine_pool_entries", "live pool entries")
        self._g_capacity = reg.gauge(
            "gossip_tpu_engine_pool_capacity", "LRU capacity bound")
        self._g_capacity.set(capacity)

    def get_or_build(self, key, build: Callable[[], object]) -> Tuple[object, bool]:
        """Return ``(engine, True)`` on a warm hit, else build, insert, and
        return ``(engine, False)``. The build runs under the lock, which
        keeps double-builds out."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                self._c_hits.inc()
                return self._entries[key], True
            engine = build()
            self._entries[key] = engine
            self.misses += 1
            self._c_misses.inc()
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                self._c_evictions.inc()
            self._g_entries.set(len(self._entries))
            return engine, False

    def invalidate(self, match: Callable[[object], bool]) -> int:
        """Drop every entry whose key satisfies ``match`` — the quarantine
        path: a wedged bucket's engines are evicted so the half-open
        re-probe rebuilds fresh. Returns the number dropped (also counted
        in ``gossip_tpu_engine_pool_invalidations_total``)."""
        with self._lock:
            doomed = [k for k in self._entries if match(k)]
            for k in doomed:
                del self._entries[k]
            if doomed:
                self.invalidations += len(doomed)
                self._c_invalidations.inc(len(doomed))
                self._g_entries.set(len(self._entries))
            return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._g_entries.set(0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }


class Quarantine:
    """Circuit breaker over engine/bucket keys (the stuck-executor
    failover). Per-key states:

      CLOSED     (key absent) — healthy, the batch engine runs normally;
      OPEN       — a wedged dispatch tripped the breaker: until the
                   cooldown expires, callers must route AROUND the engine;
      HALF-OPEN  — the cooldown expired: exactly ONE probe is handed out
                   (``check`` returns "probe" once); ``record(ok=True)``
                   closes the circuit, ``record(ok=False)`` re-opens it
                   for another cooldown.

    Thread-safe; time injectable for tests via the ``now`` arguments."""

    def __init__(self, cooldown_s: float = 30.0,
                 registry: obs.Registry | None = None,
                 prefix: str = "gossip_tpu_serving"):
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        # key -> [state, t_open] with state in {"open", "half-open"}.
        self._keys: dict = {}
        reg = registry if registry is not None else obs.default_registry()
        # ``prefix`` keeps family names disjoint when two breakers meet in
        # one exposition.
        self._c_tripped = reg.counter(
            f"{prefix}_quarantined_total",
            "circuit-breaker trips (wedged dispatch -> bucket quarantined)")
        self._c_recovered = reg.counter(
            f"{prefix}_quarantine_recovered_total",
            "half-open probes that closed a quarantined circuit")
        self._g_open = reg.gauge(
            f"{prefix}_quarantined_open",
            "circuits currently open or half-open")

    def trip(self, key, cooldown_s: float | None = None,
             now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        cd = self.cooldown_s if cooldown_s is None else float(cooldown_s)
        with self._lock:
            self._keys[key] = ["open", now + cd]
            self._c_tripped.inc()
            self._g_open.set(len(self._keys))

    def check(self, key, now: float | None = None) -> str:
        """The routing verdict for one dispatch of ``key``: "closed"
        (healthy), "open" (route around it), or "probe" (half-open — THIS
        caller may try the engine and must ``record`` the outcome). "probe"
        is handed out once per half-open window; concurrent callers see
        "open" until the probe reports."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ent = self._keys.get(key)
            if ent is None:
                return "closed"
            state, t_open = ent
            if state == "half-open":
                return "open"  # a probe is already out
            if now < t_open:
                return "open"
            ent[0] = "half-open"
            return "probe"

    def record(self, key, ok: bool, now: float | None = None) -> None:
        """Report a half-open probe's outcome (also safe to call on an
        open circuit — the failover path re-arms a probe that wedged)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if key not in self._keys:
                return
            if ok:
                del self._keys[key]
                self._c_recovered.inc()
            else:
                self._keys[key] = ["open", now + self.cooldown_s]
            self._g_open.set(len(self._keys))

    def state(self, key) -> str:
        with self._lock:
            ent = self._keys.get(key)
            return "closed" if ent is None else ent[0]

    def open_count(self) -> int:
        with self._lock:
            return len(self._keys)


_DEFAULT: WarmEnginePool | None = None
_DEFAULT_LOCK = threading.Lock()


def default_pool() -> WarmEnginePool:
    """The process-wide pool models/sweep.py and the serving plane share."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = WarmEnginePool()
        return _DEFAULT
