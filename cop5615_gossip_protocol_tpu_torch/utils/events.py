"""Structured run-event log: schema-versioned JSONL lifecycle events.

The JAX package's ``utils/events.py``, with its schema version and event
vocabulary, so that one reader takes the logs of both packages. One event a
line, each line flushed and fsynced (metrics.append_jsonl), so a killed
run's log is complete up to the kill. Every line carries
``schema_version``, ``event``, ``t_wall`` (seconds since the epoch) and
``t_run`` (seconds since the log was opened).

The one-shot CLI's vocabulary:

  run-start               config + population + lint warnings, once, first
  crash-schedule-applied  the churn planes in force (crash_rate/schedule,
                          revive_rate/schedule, rejoin, quorum)
  byzantine-model-applied the adversary plane in force
  resume                  checkpoint path + round the run restarted from
  checkpoint-written      rounds + path, generation, bytes and write_s, at
                          each checkpoint write (utils/checkpoint.save)
  checkpoint-corrupt-     resume-time quarantine: a generation failed
  quarantined             digest verification and was renamed to
                          *.corrupt (path, reason, corrupt_arrays,
                          quarantined); load_latest_intact fell back past it
  checkpoint-failed       a chunk-boundary checkpoint write failed and the
                          run went on under hook_error="continue" (rounds +
                          the OSError text), after the run, in order
  chunk-retired           per retired chunk, in order: rounds at the
                          boundary and the loop's dispatch_s/fetch_s
                          (models/pipeline.ChunkLoopResult.chunk_log)
  watchdog-fired          the stall watchdog ended the run (rounds)
  sentinel-tripped        the health sentinel ended the run: rounds,
                          unhealthy_round, mass_tolerance
  run-end                 outcome, rounds, wall/compile/dispatch/fetch
                          splits, once, last

The JAX package also writes ``engine-degraded`` when its degradation ladder
walks a rung. The port has no such ladder (a kernel that fails raises), so
it never writes one. Its serving-plane events belong to the serving layer,
not ported here.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from . import metrics

EVENT_SCHEMA_VERSION = 7


class RunEventLog:
    """Append-only event writer, one a run. ``emit`` is never called from
    inside the chunk loop: chunk-retired events are written after the run
    from the loop's chunk_log."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._t0 = time.perf_counter()

    def emit(self, event: str, **fields) -> None:
        metrics.append_jsonl(self.path, {
            "schema_version": EVENT_SCHEMA_VERSION,
            "event": event,
            "t_wall": time.time(),
            "t_run": time.perf_counter() - self._t0,
            **fields,
        })

    def emit_chunks(self, chunk_log) -> None:
        """chunk-retired events from the loop's per-chunk log, in retire
        order (one batched write, one fsync)."""
        if not chunk_log:
            return
        t_wall = time.time()
        t_run = time.perf_counter() - self._t0
        metrics.append_jsonl_many(self.path, ({
            "schema_version": EVENT_SCHEMA_VERSION,
            "event": "chunk-retired",
            "t_wall": t_wall,
            "t_run": t_run,
            "chunk": i,
            **entry,
        } for i, entry in enumerate(chunk_log)))


def read_events(path: str | Path) -> list:
    """Parse an event log back. Refuses a file from a newer schema than
    this build reads."""
    out = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        if rec.get("schema_version", 0) > EVENT_SCHEMA_VERSION:
            raise ValueError(
                f"event log {path} uses schema "
                f"{rec.get('schema_version')}; this build reads up to "
                f"{EVENT_SCHEMA_VERSION}"
            )
        out.append(rec)
    return out
