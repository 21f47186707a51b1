"""Own-telemetry: counters/gauges/histograms for the framework itself.

The port's own copy of ``odigos_tpu/utils/telemetry.py`` (standard library
only): the same ``meter``, ``labeled_key`` and exposition helpers, so the
port's engine and failover supervisor publish the reference's metric names
and labels into a process-local registry. Keep the two in step.

The reference injects a self-telemetry pipeline into every collector config
(autoscaler/controllers/clustercollector/configmap.go:42) and appends the
odigostrafficmetrics processor to every pipeline; the UI and the HPA custom
metric (odigos_gateway_memory_limiter_rejections_total) are fed from it.

We keep a process-local metrics registry with the same roles: pipeline
components record into it, the scoring engine's latency accounting reads
from it, and `snapshot()` is the scrape endpoint.

Histograms additionally retain **exemplars** (Dapper-style metric→trace
links): ``record(name, value, exemplar=(trace_id, span_id))`` keeps a
bounded per-histogram set of (value, trace, span, unix_ts) witnesses —
the current maximum plus an algorithm-R reservoir of the rest — so a
latency histogram's tail can be pivoted straight to the self-trace that
populated it.
"""

from __future__ import annotations

import random
import threading
import time
from collections import defaultdict
from typing import Optional

# exemplar slots per histogram: slot 0 is pinned to the running maximum
# (the tail witness an SLO investigation wants first), the rest are an
# algorithm-R reservoir over every exemplar-carrying record
EXEMPLAR_SLOTS = 8

# series-cardinality guard: at most this many
# DISTINCT label sets per metric name may register; overflow writes are
# dropped and counted per metric instead of growing without bound (a
# fleet of labeled publishers — or one bug interpolating span data into
# a label — must not be able to explode the registry). Generous: the
# busiest legitimate metric (per-edge flow counters) sits far below it.
MAX_SERIES_PER_METRIC = 1024
DROPPED_SERIES_METRIC = "odigos_selftelemetry_dropped_series_total"


class _Exemplar:
    """One metric→trace witness; immutable once recorded."""

    __slots__ = ("value", "trace_id", "span_id", "unix_ts")

    def __init__(self, value: float, trace_id: int, span_id: int,
                 unix_ts: float):
        self.value = value
        self.trace_id = trace_id
        self.span_id = span_id
        self.unix_ts = unix_ts

    def to_dict(self) -> dict:
        return {
            "value": self.value,
            "trace_id": f"{self.trace_id:032x}",
            "span_id": f"{self.span_id:016x}",
            "unix_ts": round(self.unix_ts, 3),
        }


class _Histogram:
    """Bounded uniform reservoir (Vitter's algorithm R) with exact
    ``count``/``total``/``vmax``. The old decimation scheme (``values[::2]``
    on overflow) permanently halved resolution after one overflow and
    biased quantiles toward whatever survived the cut; random
    replacement keeps every sample equally likely to be resident, so
    quantile error stays bounded at any stream length. ``vmax`` is
    tracked exactly, outside the reservoir — the max a reservoir reports
    decays as the true max gets replaced, and SLO math must not."""

    __slots__ = ("values", "count", "total", "vmax", "max_samples",
                 "_dirty", "_rng", "exemplars", "_exemplar_seen")

    def __init__(self, max_samples: int = 8192):
        self.values: list[float] = []  # reservoir; sorted lazily
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0  # exact running maximum (not reservoir-subject)
        self.max_samples = max_samples
        self._dirty = False
        # deterministic per-instance stream: quantiles are reproducible
        # for a given record sequence (tests) without a global seed
        self._rng = random.Random(0x9E3779B97F4A7C15)
        # slot 0 = max-value exemplar; slots 1..k = algorithm-R reservoir
        self.exemplars: list[_Exemplar] = []
        self._exemplar_seen = 0

    def record(self, v: float,
               exemplar: Optional[tuple[int, int]] = None) -> None:
        self.count += 1
        self.total += v
        if self.count == 1 or v > self.vmax:
            self.vmax = v
        if len(self.values) < self.max_samples:
            self.values.append(v)
            self._dirty = True
        else:
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self.values[j] = v
                self._dirty = True
        if exemplar is not None:
            self._record_exemplar(v, exemplar)

    def _record_exemplar(self, v: float, exemplar: tuple[int, int]) -> None:
        ex = _Exemplar(v, int(exemplar[0]), int(exemplar[1]), time.time())
        if not self.exemplars or v >= self.exemplars[0].value:
            # new tail witness: the displaced ex-max demotes into the
            # reservoir path below instead of vanishing
            self.exemplars.insert(0, ex)
            if len(self.exemplars) <= EXEMPLAR_SLOTS:
                return
            ex = self.exemplars.pop(1)  # oldest max becomes a candidate
            v = ex.value
        self._exemplar_seen += 1
        if len(self.exemplars) < EXEMPLAR_SLOTS:
            self.exemplars.append(ex)
            return
        j = self._rng.randrange(self._exemplar_seen)
        if j < EXEMPLAR_SLOTS - 1:
            self.exemplars[1 + j] = ex

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        if self._dirty:
            self.values.sort()
            self._dirty = False
        idx = min(int(q * len(self.values)), len(self.values) - 1)
        return self.values[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Meter:
    """Thread-safe metrics registry. Labels are flattened into the name by the
    caller convention ``name{key=value}`` to keep the structure flat."""

    def __init__(self,
                 max_series_per_metric: int = MAX_SERIES_PER_METRIC) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}
        self.max_series_per_metric = max_series_per_metric
        # metric base name -> count of distinct label-carrying keys
        # registered, plus the admitted-key set (a cleared-then-reset
        # gauge must not count twice — profiler gauges recycle)
        self._series_counts: dict[str, int] = {}
        self._series_keys: set[str] = set()

    def _admit(self, name: str) -> bool:
        """Cardinality guard, called under the lock for a key NOT yet in
        its instrument map. Unlabeled names always pass (one series by
        construction); a labeled key past the per-metric cap is dropped
        and counted in the per-metric overflow counter — the registry
        degrades by refusing cardinality, never by growing without
        bound (the seriesstate discipline)."""
        if "{" not in name:
            return True
        if name in self._series_keys:
            return True
        base = name.split("{", 1)[0]
        n = self._series_counts.get(base, 0)
        if n >= self.max_series_per_metric:
            # direct bump: the overflow counter is itself labeled (one
            # series per distinct overflowing metric — bounded), and
            # routing it through add() would re-enter the guard
            self._counters[labeled_key(DROPPED_SERIES_METRIC,
                                       metric=base)] += 1
            return False
        self._series_keys.add(name)
        self._series_counts[base] = n + 1
        return True

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            if name not in self._counters and not self._admit(name):
                return
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._gauges and not self._admit(name):
                return
            self._gauges[name] = value

    def clear_gauge(self, name: str) -> None:
        """Drop a gauge from the scrape (a sampled gauge whose source is
        gone must disappear, not freeze at its last value)."""
        with self._lock:
            self._gauges.pop(name, None)

    def record(self, name: str, value: float,
               exemplar: Optional[tuple[int, int]] = None) -> None:
        """Record into a histogram; ``exemplar=(trace_id, span_id)``
        optionally attaches the self-trace that produced this sample."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if not self._admit(name):
                    return
                h = self._hists[name] = _Histogram()
            h.record(value, exemplar)

    def record_many(self, samples: list[tuple[str, float]],
                    exemplar: Optional[tuple[int, int]] = None) -> None:
        """Record a correlated group of histogram samples under ONE lock
        hold (the latency stage waterfall records ~11 per frame — taking
        the registry lock per stage would make the lock the overhead the
        attribution layer is bounded against). ``exemplar`` applies to
        every sample: the group shares one frame, hence one witness."""
        with self._lock:
            hists = self._hists
            for name, value in samples:
                h = hists.get(name)
                if h is None:
                    if not self._admit(name):
                        continue
                    h = hists[name] = _Histogram()
                h.record(value, exemplar)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
            return h.quantile(q) if h else 0.0

    @staticmethod
    def _stat_key(name: str, suffix: str) -> str:
        """Histogram stat key: the suffix joins the METRIC NAME, before
        any label block — ``name_p50{labels}``, never ``name{labels}_p50``
        (which would splice the suffix into the last label value at
        exposition time)."""
        if "{" in name:
            base, rest = name.split("{", 1)
            return f"{base}_{suffix}{{{rest}"
        return f"{name}_{suffix}"

    def snapshot(self) -> dict[str, float]:
        """Flat scrape of all instruments (histograms as
        _p50/_p90/_p99/_mean/_max/_count)."""
        with self._lock:
            out: dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            for name, h in self._hists.items():
                out[self._stat_key(name, "count")] = float(h.count)
                out[self._stat_key(name, "mean")] = h.mean
                out[self._stat_key(name, "p50")] = h.quantile(0.50)
                out[self._stat_key(name, "p90")] = h.quantile(0.90)
                out[self._stat_key(name, "p99")] = h.quantile(0.99)
                out[self._stat_key(name, "max")] = h.vmax
            return out

    def exemplars(self, name: Optional[str] = None) -> dict[str, list[dict]]:
        """Per-histogram exemplar witnesses, max-value first. ``name``
        restricts to one histogram; default is every histogram that holds
        at least one exemplar (the /metrics annotation feed)."""
        with self._lock:
            items = ([(name, self._hists[name])] if name in self._hists
                     else [] if name is not None
                     else list(self._hists.items()))
            return {n: [e.to_dict() for e in h.exemplars]
                    for n, h in items if h.exemplars}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._series_counts.clear()
            self._series_keys.clear()


def label_value(v: str) -> str:
    """Sanitize a label VALUE for the flat ``name{key=value}`` encoding.

    The flat encoding is ambiguous if a value contains the structural
    characters — ``name{exporter=a,b}`` reads as two labels — so callers
    whose label values come from data (service names, exporter names from
    config) must route them through here at record time. Structural chars
    are replaced, not escaped: the flat string is the registry key and
    must round-trip through naive split."""
    return (v.replace(",", "_").replace("=", "_")
             .replace("{", "_").replace("}", "_"))


def labeled_key(metric: str, /, **labels: str) -> str:
    """Render a flat ``name{key=value}`` registry key, routing every
    label VALUE through ``label_value`` (see its contract). The flat
    encoding's one rule lives here; hot-path callers precompute the key
    once at construction. The metric name is positional-only so a label
    may itself be called ``metric`` (the cardinality-overflow counter's
    label)."""
    inner = ",".join(f"{k}={label_value(str(v))}"
                     for k, v in labels.items())
    return f"{metric}{{{inner}}}"


def _requote(name: str) -> str:
    """Render a flat registry name as Prometheus exposition syntax:
    label values quoted and escaped; legacy unsanitized ',' fragments
    spliced back into the previous value."""
    if "{" not in name:
        return name
    base, rest = name.split("{", 1)
    labels: list[str] = []
    for part in rest.rstrip("}").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            v = v.strip().replace("\\", "\\\\").replace('"', '\\"')
            labels.append(f'{k.strip()}="{v}"')
        elif labels:
            # a ',' inside a legacy unsanitized value: splice the
            # fragment back into the previous value (same escaping
            # as the normal path) rather than emit a bare fragment
            frag = (part.strip().replace("\\", "\\\\")
                    .replace('"', '\\"'))
            labels[-1] = labels[-1][:-1] + "," + frag + '"'
    return base + "{" + ",".join(labels) + "}"


def prometheus_text(snapshot: dict[str, float],
                    exemplars: Optional[dict[str, list[dict]]] = None) -> str:
    """Render a ``snapshot()`` as Prometheus text exposition (the
    own-observability scrape surface; reference: own-observability/
    prometheus ServiceMonitor scraping the collectors' self metrics).
    Flat ``name{label=value}`` names pass through with values quoted.

    ``exemplars`` (``Meter.exemplars()``) adds OpenMetrics-style
    ``# EXEMPLAR`` annotation lines after the samples — comment lines,
    so pre-OpenMetrics scrapers skip them — each linking a histogram to
    the internal trace/span that populated it:

        # EXEMPLAR <hist>{...} {trace_id="...",span_id="..."} <value> <ts>
    """
    lines = []
    for name in sorted(snapshot):
        value = snapshot[name]
        # full float precision: {:g} quantizes to 6 significant digits,
        # which freezes counters past 1e6 on the scrape surface
        lines.append(f"{_requote(name)} {float(value)!r}")
    for name in sorted(exemplars or ()):
        for ex in exemplars[name]:
            lines.append(
                f"# EXEMPLAR {_requote(name)} "
                f'{{trace_id="{ex["trace_id"]}",'
                f'span_id="{ex["span_id"]}"}} '
                f"{float(ex['value'])!r} {ex['unix_ts']!r}")
    return "\n".join(lines) + "\n"


meter = Meter()
