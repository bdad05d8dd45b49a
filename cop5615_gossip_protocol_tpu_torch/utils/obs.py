"""Process-wide metrics registry: counters, gauges and bounded streaming
log-bucket histograms, rendered as Prometheus text exposition format and
dumped by ``--metrics-dump`` after a one-shot CLI run.

A copy of the JAX package's ``utils/obs.py``, with its metric names
(``gossip_tpu_*``), buckets and label sets, so that one scraper reads the
records of both packages.

Design constraints, in order:

1. **Zero device syncs.** Every instrument is host-side arithmetic on
   numbers the program already fetched (chunk timing splits, checkpoint
   walls). Nothing here touches a device tensor.
2. **Bounded memory.** Histograms are fixed bucket arrays (O(1) per
   observation, O(buckets) in all), never reservoirs of samples.
3. **Thread-safe.** One lock per registry; every mutation and every read
   snapshot goes through it. Collect callbacks (refreshing gauges from
   external state) run BEFORE the lock is taken, so a callback that takes
   a lock of its own cannot deadlock against a writer that takes the two
   in the other order.

Histogram quantiles: buckets are log-spaced (upper bounds ``lo *
growth**i``), so a quantile read walks the cumulative counts to the target
bucket and returns that bucket's upper edge clamped into [min_seen,
max_seen]. The true quantile lies in the same bucket, so the reported value
overestimates by at most a factor of ``growth`` (relative error <= growth -
1; the default growth 2**0.25 bounds it at ~19%, and the clamp makes the
extreme quantiles of small samples exact).

Naming follows Prometheus conventions: ``gossip_tpu_<plane>_<what>_<unit>``
with ``_total`` on counters and base units (seconds) on histograms.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Tuple

# Default log-bucket geometry: 0.1 ms .. ~107 s upper edges at growth
# 2**0.25 (four buckets per octave, 81 buckets) — spans a serving-request
# latency to a flagship-run wall with <= 19% relative quantile error.
DEFAULT_LO = 1e-4
DEFAULT_GROWTH = 2 ** 0.25
DEFAULT_BUCKETS = 81


def _fmt(v: float) -> str:
    """Prometheus float formatting: shortest round-trip decimal."""
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotone counter. ``inc`` only — a decreasing 'counter' is a gauge."""

    kind = "counter"

    def __init__(self, registry: "Registry", name: str, help_: str,
                 labels: Tuple[str, ...] = ()):
        self._registry = registry
        self.name = name
        self.help = help_
        self.labelnames = labels
        # label-values tuple -> float; () for the unlabeled series.
        self._values: Dict[tuple, float] = {} if labels else {(): 0.0}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._registry._lock:
            return self._values.get(self._labelkey(labels), 0.0)

    def _labelkey(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {sorted(labels)}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def series(self) -> Dict[tuple, float]:
        with self._registry._lock:
            return dict(self._values)


class Gauge(Counter):
    """Settable instantaneous value; ``set`` is the primary write."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram:
    """Bounded streaming log-bucket histogram (module docstring: O(1) per
    observation, fixed memory, quantile error <= growth - 1)."""

    kind = "histogram"

    def __init__(self, registry: "Registry", name: str, help_: str,
                 lo: float = DEFAULT_LO, growth: float = DEFAULT_GROWTH,
                 n_buckets: int = DEFAULT_BUCKETS):
        if lo <= 0 or growth <= 1 or n_buckets < 1:
            raise ValueError(
                f"histogram {name} needs lo > 0, growth > 1, n_buckets >= 1"
            )
        self._registry = registry
        self.name = name
        self.help = help_
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_growth = math.log(growth)
        # bounds[i] is bucket i's inclusive upper edge; one overflow bucket
        # (le="+Inf") rides past bounds[-1].
        self.bounds = [lo * growth ** i for i in range(n_buckets)]
        self._counts = [0] * (n_buckets + 1)
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return  # a NaN observation would poison sum/quantiles
        if v <= self.lo:
            i = 0
        else:
            # ceil(log(v/lo) / log(growth)) without float-edge surprises:
            # the computed bucket's upper edge must be >= v.
            i = int(math.ceil(math.log(v / self.lo) / self._log_growth))
            i = max(i, 0)
            if i < len(self.bounds) and self.bounds[i] < v:
                i += 1
            i = min(i, len(self.bounds))
        with self._registry._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._registry._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._registry._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Streaming quantile: the upper edge of the bucket holding the
        q-th observation, clamped to [min_seen, max_seen] (exact at the
        tails of small samples). None when empty. Relative error bound:
        <= growth - 1 (class docstring)."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._registry._lock:
            if self._count == 0:
                return None
            # Nearest-rank on the cumulative bucket counts — same rank
            # convention as the old serving reservoir percentile.
            rank = max(1, math.ceil(q * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    edge = (
                        self.bounds[i] if i < len(self.bounds)
                        else self._max
                    )
                    return min(max(edge, self._min), self._max)
            return self._max  # unreachable; defensive

    def series(self) -> dict:
        with self._registry._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class Registry:
    """One metrics namespace: instrument registration is get-or-create by
    name (re-registering with a different type or label set is a loud
    error — silent shadowing would split a series across two objects)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._collects: list = []

    def _get_or_create(self, cls, name: str, help_: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                # Exact-type match: Gauge subclasses Counter, so an
                # isinstance check would silently hand a gauge to a caller
                # that registered a monotone counter (review finding).
                if type(inst) is not cls or (
                    getattr(inst, "labelnames", ()) != kw.get("labels", ())
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__} with labels "
                        f"{getattr(inst, 'labelnames', ())}"
                    )
                return inst
        # Construct outside the lock (constructors take no lock), then
        # publish; a racing double-create resolves to first-wins.
        inst = cls(self, name, help_, **kw)
        with self._lock:
            return self._instruments.setdefault(name, inst)

    def counter(self, name: str, help_: str = "",
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labels=labels)

    def gauge(self, name: str, help_: str = "",
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels=labels)

    def histogram(self, name: str, help_: str = "",
                  lo: float = DEFAULT_LO, growth: float = DEFAULT_GROWTH,
                  n_buckets: int = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, Histogram):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}"
                    )
                return inst
        inst = Histogram(self, name, help_, lo=lo, growth=growth,
                         n_buckets=n_buckets)
        with self._lock:
            return self._instruments.setdefault(name, inst)

    def add_collect(self, fn: Callable[[], None]) -> None:
        """Register a pre-scrape callback that refreshes gauges from
        external state. Runs OUTSIDE the registry lock (module docstring:
        the ABBA rule) at every render()."""
        with self._lock:
            self._collects.append(fn)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4): HELP/TYPE
        headers, counters/gauges one line per label set, histograms as
        cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``."""
        for fn in list(self._collects):
            fn()  # outside the lock, see add_collect
        with self._lock:
            instruments = list(self._instruments.values())
        out = []
        for inst in instruments:
            out.append(f"# HELP {inst.name} {inst.help}")
            out.append(f"# TYPE {inst.name} {inst.kind}")
            if isinstance(inst, Histogram):
                s = inst.series()
                cum = 0
                for bound, c in zip(s["bounds"], s["counts"]):
                    cum += c
                    out.append(
                        f'{inst.name}_bucket{{le="{_fmt(bound)}"}} {cum}'
                    )
                cum += s["counts"][-1]
                out.append(f'{inst.name}_bucket{{le="+Inf"}} {cum}')
                out.append(f"{inst.name}_sum {_fmt(s['sum'])}")
                out.append(f"{inst.name}_count {s['count']}")
            else:
                for key, val in sorted(inst.series().items()):
                    if inst.labelnames:
                        lbl = ",".join(
                            f'{k}="{_escape(v)}"'
                            for k, v in zip(inst.labelnames, key)
                        )
                        out.append(f"{inst.name}{{{lbl}}} {_fmt(val)}")
                    else:
                        out.append(f"{inst.name} {_fmt(val)}")
        return "\n".join(out) + "\n"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_DEFAULT: Optional[Registry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry (the warm-engine pool and one-shot CLI
    runs report here; the serving plane's per-app registry rides next to
    it so two in-process apps never double-count one series)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Registry()
        return _DEFAULT


# ---------------------------------------------------------------- parsing

def _parse_sample(line: str, lineno: int):
    """One exposition sample line -> ``(name, label-items-tuple, value)``;
    raises the loud ValueError both parsers share."""
    try:
        if "{" in line:
            name, rest = line.split("{", 1)
            lbl_text, val_text = rest.rsplit("}", 1)
            labels = []
            for part in _split_labels(lbl_text):
                k, v = part.split("=", 1)
                labels.append((k, _unescape(v[1:-1])))
            key = tuple(labels)
        else:
            name, val_text = line.rsplit(None, 1)
            key = ()
        value = float(val_text)
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"unparseable exposition line {lineno}: {line!r} ({e})"
        ) from e
    return name.strip(), key, value


def parse_prometheus(text: str) -> Dict[str, Dict[tuple, float]]:
    """Parse exposition text back into ``{name: {label-items-tuple:
    value}}`` — the CI metrics-smoke job and the tests consume /metrics
    through this, so a malformed exposition fails loudly at the parse, not
    silently at a missed assertion. Histogram child series keep their
    ``_bucket``/``_sum``/``_count`` suffixed names."""
    out: Dict[str, Dict[tuple, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, key, value = _parse_sample(line, lineno)
        out.setdefault(name, {})[key] = value
    return out


def parse_prometheus_typed(text: str):
    """Like :func:`parse_prometheus` but RETAINS the ``# TYPE``/``# HELP``
    headers — returns ``(series, types, helps)`` where ``types`` maps
    family name -> kind ("counter"/"gauge"/"histogram") and ``helps`` maps
    family name -> help text. The merger needs the kind to know whether a
    series sums (counter), re-exposes per source (gauge), or bucket-merges
    (histogram); the suffix-blind untyped parse cannot tell."""
    series: Dict[str, Dict[tuple, float]] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ValueError(
                    f"unparseable TYPE line {lineno}: {line!r}"
                )
            types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("#"):
            continue
        name, key, value = _parse_sample(line, lineno)
        series.setdefault(name, {})[key] = value
    return series, types, helps


def _sample_line(name: str, key: tuple, val: float) -> str:
    if key:
        lbl = ",".join(f'{k}="{_escape(str(v))}"' for k, v in key)
        return f"{name}{{{lbl}}} {_fmt(val)}"
    return f"{name} {_fmt(val)}"


def merge_prometheus(sources, label: str = "worker") -> str:
    """Merge N expositions into one, by metric TYPE (the federation core
    behind the fleet front's ``GET /metrics`` and the multi-process
    ``--metrics-dump``):

    - **counters** sum per label set across sources (the front-exposed
      total equals the arithmetic sum of per-source scrapes — the CI
      federated-identity pin);
    - **gauges** (and untyped series) re-expose per source with a
      ``label`` label added (a gauge is an instantaneous per-process
      value; summing lane widths across workers would be a lie);
    - **histograms** bucket-merge: cumulative per-``le`` counts, ``_sum``
      and ``_count`` sum — EXACT because every registry histogram shares
      the log-bucket geometry (DEFAULT_LO/GROWTH/BUCKETS); sources whose
      ``le`` sets differ raise loudly instead of merging inexactly.

    ``sources`` is ``{source_id: exposition_text}`` (or an iterable of
    pairs). Output is deterministic: families sorted by name, HELP/TYPE
    retained from the first source that declared them."""
    items = sources.items() if isinstance(sources, dict) else sources
    parsed: Dict[str, Dict[str, Dict[tuple, float]]] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for src, text in items:
        s, t, h = parse_prometheus_typed(text)
        parsed[str(src)] = s
        for fam, kind in t.items():
            if types.setdefault(fam, kind) != kind:
                raise ValueError(
                    f"metric {fam!r} declared as {types[fam]!r} and "
                    f"{kind!r} across sources — refusing to merge"
                )
        for fam, help_ in h.items():
            helps.setdefault(fam, help_)
    hist_children: Dict[str, str] = {}
    for fam, kind in types.items():
        if kind == "histogram":
            for suffix in ("_bucket", "_sum", "_count"):
                hist_children[fam + suffix] = fam
    fams = set(types)
    for s in parsed.values():
        for name in s:
            fams.add(hist_children.get(name, name))
    out = []
    for fam in sorted(fams):
        kind = types.get(fam, "gauge")  # untyped series: per-source gauge
        out.append(f"# HELP {fam} {helps.get(fam, '')}")
        out.append(f"# TYPE {fam} {kind}")
        if kind == "counter":
            merged: Dict[tuple, float] = {}
            for s in parsed.values():
                for key, val in s.get(fam, {}).items():
                    merged[key] = merged.get(key, 0.0) + val
            for key in sorted(merged):
                out.append(_sample_line(fam, key, merged[key]))
        elif kind == "histogram":
            buckets: Dict[str, float] = {}
            total_sum = 0.0
            total_count = 0.0
            le_sets = set()
            for s in parsed.values():
                b = s.get(fam + "_bucket", {})
                if b:
                    le_sets.add(frozenset(dict(k)["le"] for k in b))
                for key, val in b.items():
                    le = dict(key)["le"]
                    buckets[le] = buckets.get(le, 0.0) + val
                total_sum += sum(s.get(fam + "_sum", {}).values())
                total_count += sum(s.get(fam + "_count", {}).values())
            if len(le_sets) > 1:
                raise ValueError(
                    f"histogram {fam!r} bucket geometry differs across "
                    "sources — bucket-merge would be inexact"
                )

            def _le_key(le: str) -> float:
                return math.inf if le == "+Inf" else float(le)

            for le in sorted(buckets, key=_le_key):
                out.append(
                    f'{fam}_bucket{{le="{_escape(le)}"}} '
                    f"{_fmt(buckets[le])}"
                )
            out.append(f"{fam}_sum {_fmt(total_sum)}")
            out.append(f"{fam}_count {_fmt(total_count)}")
        else:
            for src in sorted(parsed):
                fam_series = parsed[src].get(fam, {})
                for key in sorted(fam_series):
                    out.append(_sample_line(
                        fam, ((label, src),) + tuple(key), fam_series[key]
                    ))
    return "\n".join(out) + "\n"


def _unescape(v: str) -> str:
    """Inverse of _escape, scanning left to right — sequential .replace
    passes would corrupt values containing literal backslashes (a
    rendered '\\\\n' must parse as backslash+n, not newline)."""
    out, i = [], 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, ch + nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _split_labels(text: str) -> list:
    """Split 'a="x",b="y"' respecting escaped quotes inside values."""
    parts, cur, in_str, esc = [], [], False, False
    for ch in text:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_str = not in_str
        elif ch == "," and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p]


def metric_value(parsed: dict, name: str, **labels) -> Optional[float]:
    """Convenience lookup over parse_prometheus output."""
    series = parsed.get(name)
    if series is None:
        return None
    key = tuple(sorted(labels.items()))
    for k, v in series.items():
        if tuple(sorted(k)) == key:
            return v
    return None


# ------------------------------------------------- one-shot run reporting

def observe_run_record(record: dict, chunk_log=None,
                       registry: Optional[Registry] = None,
                       telemetry=None, events=None) -> Registry:
    """Stamp one structured run record (utils/metrics.run_record, schema
    >= 4) into a registry — the CLI ``--metrics-dump`` path: a one-shot
    run exposes the same vocabulary a served request does, so ROADMAP
    consumers scrape one format regardless of how the run was launched.
    Purely host-side post-processing of already-fetched numbers.

    ``telemetry`` (a TelemetryTrajectory, duck-typed: ``.columns`` +
    ``.data``) surfaces the fault plane: byzantine node-round
    aggregates become gauges. ``events`` (an iterable of ``(name,
    fields)`` pairs captured from the run's ``on_event`` stream) surfaces
    the autotuner's verdict: the ``plan-chosen`` event becomes a
    labeled counter plus the predicted-floor gauge."""
    reg = registry if registry is not None else default_registry()
    runs = reg.counter(
        "gossip_tpu_runs_total", "completed one-shot runs", ("outcome",)
    )
    runs.inc(outcome=str(record.get("outcome", "unknown")))
    reg.counter(
        "gossip_tpu_run_rounds_total", "protocol rounds executed"
    ).inc(float(record.get("rounds", 0)))
    for field, help_ in (
        ("build_s", "topology build seconds (last run)"),
        ("compile_s", "trace+compile seconds incl. warmup (last run)"),
        ("run_s", "steady-state run-loop wall seconds (last run)"),
        ("dispatch_s", "host chunk-enqueue seconds (last run)"),
        ("fetch_s", "host seconds blocked on predicate/aux readback "
                    "(last run)"),
        ("first_dispatch_s", "first chunk's dispatch seconds — carries "
                             "any residual trace cost (last run)"),
        ("hook_s", "chunk-boundary hook seconds: checkpoint IO + "
                   "watchdog (last run)"),
        ("aux_s", "telemetry aux collection seconds (last run)"),
        ("setup_s", "engine setup seconds: round-fn/plane/state builds "
                    "+ transfers (last run)"),
        ("finalize_s", "result-assembly seconds after the loop "
                       "(last run)"),
        ("residual_s", "run-loop seconds outside the named buckets "
                       "(last run)"),
    ):
        val = record.get(field)
        if val is not None:
            reg.gauge(f"gossip_tpu_run_{field.replace('_s', '_seconds')}",
                      help_).set(float(val))
    # Per-chunk timing splits into the streaming histograms: the same
    # series the wallwalk report reads, scrapeable after any CLI run.
    disp_h = reg.histogram(
        "gossip_tpu_chunk_dispatch_seconds", "per-chunk host enqueue time"
    )
    fetch_h = reg.histogram(
        "gossip_tpu_chunk_fetch_seconds",
        "per-chunk host time blocked on the predicate readback",
    )
    for entry in chunk_log if chunk_log is not None else (
        record.get("chunk_log") or ()
    ):
        disp_h.observe(entry.get("dispatch_s", 0.0))
        fetch_h.observe(entry.get("fetch_s", 0.0))
    # Byzantine node-rounds from the telemetry trajectory
    # (column sum = adversarial node-rounds; rows with count > 0 = rounds
    # under attack). Duck-typed: any object with columns and data.
    if telemetry is not None and getattr(telemetry, "data", None) is not None:
        columns = tuple(getattr(telemetry, "columns", ()))
        if "byzantine_count" in columns:
            col = telemetry.data[:, columns.index("byzantine_count")]
            reg.gauge(
                "gossip_tpu_run_byzantine_node_rounds",
                "sum over rounds of the byzantine node count (last run)",
            ).set(float(col.sum()))
            reg.gauge(
                "gossip_tpu_run_byzantine_rounds",
                "rounds with at least one byzantine node (last run)",
            ).set(float((col > 0).sum()))
    # The autotuner's structured plan-chosen event.
    for name, fields in events or ():
        if name != "plan-chosen":
            continue
        reg.counter(
            "gossip_tpu_plan_chosen_total",
            "autotuner decisions by winning plan", ("winner",)
        ).inc(winner=str(fields.get("winner", "unknown")))
        predicted = fields.get("predicted_us_per_round")
        if predicted is not None:
            reg.gauge(
                "gossip_tpu_plan_predicted_us_per_round",
                "autotuner-scored floor for the chosen plan (last run)",
            ).set(float(predicted))
    return reg


def observe_step_timing(report: dict,
                        registry: Optional[Registry] = None) -> Registry:
    """Stamp a ``step_timing`` report (models/runner, cfg.step_timing=True)
    into a registry: the per-super-step wall histogram the autotuner's
    measured-vs-predicted table reads, plus straggler-skew gauges under
    multi-process meshes. Post-hoc host arithmetic only."""
    reg = registry if registry is not None else default_registry()
    wall_h = reg.histogram(
        "gossip_tpu_superstep_wall_seconds",
        "per-dispatch super-step wall (chunk retire to retire)",
    )
    for w in report.get("wall_s") or ():
        wall_h.observe(float(w))
    for field, help_ in (
        ("median_us_per_round", "measured median us/round (last run)"),
        ("max_us_per_round", "measured max us/round (last run)"),
    ):
        val = report.get(field)
        if val is not None:
            reg.gauge(f"gossip_tpu_superstep_{field}", help_).set(float(val))
    straggler = report.get("straggler") or {}
    for field, help_ in (
        ("max_skew_s", "max per-process super-step skew seconds"),
        ("median_skew_s", "median per-process super-step skew seconds"),
    ):
        val = straggler.get(field)
        if val is not None:
            # Suffix-only rewrite: replace() would also hit the "_s" in
            # "_skew" and mangle the family name.
            reg.gauge(
                f"gossip_tpu_superstep_straggler_{field[:-2]}_seconds",
                help_ + " (last run)",
            ).set(float(val))
    return reg


def dump(path, registry: Optional[Registry] = None) -> None:
    """Write the registry's exposition text to ``path`` ('-' = stdout)."""
    import sys

    reg = registry if registry is not None else default_registry()
    text = reg.render()
    if str(path) == "-":
        sys.stdout.write(text)
    else:
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
