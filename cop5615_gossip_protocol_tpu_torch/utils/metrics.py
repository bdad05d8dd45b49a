"""Run records and the reference-format console lines.

The structured run record has the JAX package's keys and schema version, so
records from both packages compare field by field.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..config import SimConfig
    from ..models.runner import RunResult
    from ..ops.topology import Topology

# Format version of the run record; the JAX package's current version.
RUN_RECORD_SCHEMA_VERSION = 5


def banner(cfg: SimConfig) -> str:
    """Kickoff banner (the reference's 'Push Sum Started' prints)."""
    return (
        f"Starting {cfg.algorithm} on {cfg.topology} "
        f"({cfg.semantics} semantics, dtype={cfg.dtype})"
    )


def convergence_line(wall_ms: float) -> str:
    """The reference's convergence print: a 59-dash rule, then
    'Convergence Time: %f ms' (program.fs:50-52)."""
    return (
        "-----------------------------------------------------------\n"
        f"Convergence Time: {wall_ms:.6f} ms"
    )


def run_record(cfg: SimConfig, topo: Topology, result: RunResult) -> dict:
    rec = {
        "schema_version": RUN_RECORD_SCHEMA_VERSION,
        "config": dataclasses.asdict(cfg),
        "topology_kind": topo.kind,
        "population": topo.n,
        "max_deg": topo.max_deg,
        **result.to_record(),
    }
    rec["resolved_delta"] = cfg.resolved_delta
    return rec


def append_jsonl(path: str | Path, record: dict) -> None:
    """Append one record, flushed and fsynced before returning."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())


def append_jsonl_many(path: str | Path, records) -> None:
    """Append a batch of records with one flush and fsync for the batch
    (the per-round trace writes thousands of lines a run)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())
