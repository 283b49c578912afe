"""Metrics registry: counters / gauges / histograms for one simulation run.

Port of ``repro/obs/metrics.py``, plain Python as the reference's: the same
classes, schema and scoping, so a snapshot from either package passes the
other's :func:`validate_snapshot`.

The engine layer (``sim/ensemble.py``) emits into the *current* registry
via :func:`registry`; ``sim/api.py`` scopes a fresh :class:`MetricsRegistry`
around each run (:func:`use`) and snapshots it into the telemetry report
under a versioned ``metrics`` key (:meth:`MetricsRegistry.snapshot`,
``telemetry.finalize(metrics=...)``).

Metric taxonomy (names are ``layer.what``; units ride in the snapshot).
The port emits the ``engine.*`` and ``sim.*`` names; the others belong to
layers not ported yet (strategies, the simulation server):

* ``engine.cache_miss``      — engine builds (the lru-cached engine
  constructors only execute on a miss; in the reference each build is an
  XLA lowering, in the port a new set of evaluators and device tables);
* ``engine.bucket_branches`` — capacity buckets across the bucket groups
  of a gather engine build;
* ``sim.events``             — productive block events executed;
* ``sim.tiles_launched``     — kernel grid tiles enqueued (both passes);
* ``sim.tiles_occupancy_bound`` — analytic a-priori tile bound from
  ``hermite.block_level_occupancy`` (launched <= bound, asserted in tests);
* ``sim.tiles_dense_baseline``  — what the masked ``compaction="none"``
  launch would have enqueued;
* ``sim.active_fraction``    — per-chunk histogram of mean active-target
  fraction (force evals / events / n_active^2);
* ``sim.pad_waste``          — padded-slot fraction of the batch;
* ``sim.shard_imbalance``    — max/mean per-shard launched tiles;
* ``sim.bucket_hits``        — capacity-bucket switch hit distribution;
* ``ring.shifts_issued``     — ring ``ppermute`` rounds *traced* per pass
  (counted at trace time: the overlapped sweep unrolls ``p - 1`` real
  shifts, the sync baseline traces one body looped ``p`` times at runtime
  — see ``core.strategies._ring_sweep``);
* ``ring.overlap_frac``      — measured wall-clock fraction the overlapped
  ring saves over the sync baseline, ``1 - wall_overlap / wall_sync``
  (gauge, set by ``benchmarks/bench_ci.py``'s ``ring_overlap`` probe);
* ``serve.queue_depth``      — requests waiting for a slot (gauge);
* ``serve.slot_occupancy``   — live-slot fraction across pods (gauge);
* ``serve.admission_latency_s`` — submit -> admit wait (histogram);
* ``serve.turnaround_s``     — submit -> retire latency (histogram);
* ``serve.requests_admitted`` / ``serve.requests_retired`` — lifecycle
  counters of the simulation server (``repro.serve.sim_engine``).

Everything is plain Python on the host side; values reach it as Python
numbers, never as tensors.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

#: version of the ``metrics`` snapshot schema embedded in telemetry reports
METRICS_SCHEMA_VERSION = 1

#: histograms keep at most this many raw observations (summary stats keep
#: accumulating past the cap — only the percentile resolution degrades)
HISTOGRAM_SAMPLE_CAP = 4096


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name, self.unit, self.help = name, unit, help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        self.value += float(v)

    def dump(self) -> Dict[str, Any]:
        return {"value": self.value, "unit": self.unit}


class Gauge:
    """Last-written value (numbers, or small JSON-able vectors)."""

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name, self.unit, self.help = name, unit, help
        self.value: Any = None

    def set(self, v: Any) -> None:
        self.value = v

    def dump(self) -> Dict[str, Any]:
        return {"value": self.value, "unit": self.unit}


class Histogram:
    """Streaming distribution: count/sum/min/max plus sampled percentiles."""

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name, self.unit, self.help = name, unit, help
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._samples) < HISTOGRAM_SAMPLE_CAP:
            self._samples.append(v)

    def percentile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        xs = sorted(self._samples)
        idx = min(int(q * (len(xs) - 1) + 0.5), len(xs) - 1)
        return xs[idx]

    def dump(self) -> Dict[str, Any]:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "mean": self.sum / self.count if self.count else None,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "unit": self.unit,
        }


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and snapshots."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, unit: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, unit=unit, help=help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "",
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, unit, help)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready, versioned dump — the telemetry ``metrics`` payload."""
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, Any] = {
            "schema_version": METRICS_SCHEMA_VERSION,
            "counters": {}, "gauges": {}, "histograms": {},
        }
        kind = {Counter: "counters", Gauge: "gauges",
                Histogram: "histograms"}
        for name, m in sorted(metrics.items()):
            out[kind[type(m)]][name] = m.dump()
        return out


def validate_snapshot(snap: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``snap`` is a well-formed metrics payload
    of the current schema (the telemetry-report ``metrics`` key contract)."""
    if not isinstance(snap, dict):
        raise ValueError(f"metrics snapshot must be a dict, got {type(snap)}")
    version = snap.get("schema_version")
    if version != METRICS_SCHEMA_VERSION:
        raise ValueError(
            f"metrics schema_version {version!r} != {METRICS_SCHEMA_VERSION}")
    for section, fields in (("counters", ("value",)),
                            ("gauges", ("value",)),
                            ("histograms", ("count", "sum", "mean"))):
        body = snap.get(section)
        if not isinstance(body, dict):
            raise ValueError(f"metrics snapshot missing section {section!r}")
        for name, dump in body.items():
            if not isinstance(dump, dict):
                raise ValueError(f"{section}[{name!r}] must be a dict")
            missing = [f for f in fields if f not in dump]
            if missing:
                raise ValueError(
                    f"{section}[{name!r}] missing fields {missing}")


#: process-default registry: emissions outside any driver run land here
_default = MetricsRegistry()
_current = _default


def registry() -> MetricsRegistry:
    """The current registry (run-scoped inside a driver run)."""
    return _current


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``reg`` (None restores the process default); returns previous."""
    global _current
    prev = _current
    _current = reg if reg is not None else _default
    return prev


@contextmanager
def use(reg: Optional[MetricsRegistry] = None):
    """Scope ``reg`` (or a fresh registry) as current; yields it."""
    reg = reg if reg is not None else MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)
