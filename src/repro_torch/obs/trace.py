"""Event-level span tracing: nested host spans -> Chrome-trace/Perfetto JSON.

Port of ``repro/obs/trace.py``: the same tracer, taxonomy and JSON layout.
A :class:`SpanTracer` records *complete* events (``ph: "X"``) with host
timestamps relative to the tracer's start; Perfetto (https://ui.perfetto.dev)
and ``chrome://tracing`` both infer nesting from time containment on one
track, so a ``with tracer.span("macro-step"): ...`` enclosing
``tracer.span("event")`` renders as a nested flame.

Every live span also enters a ``torch.profiler.record_function`` range of
the same name (the reference opens a profiler annotation there), so when a
``torch.profiler`` window is open the host spans appear on its timeline
next to the card's kernels.

Spans the driver does not time one by one (the events inside an engine
chunk) are reconstructed as *synthetic* spans via
:meth:`SpanTracer.add_span` — evenly subdividing a measured chunk, flagged
``{"synthetic": true}`` so a reader never mistakes them for measured host
timestamps.  The aggregate (chunk wall, event count, tiles) is measured;
only the subdivision is synthetic.

The module-level *current tracer* defaults to a zero-overhead
:class:`NullTracer`; ``sim/api.py`` installs a live tracer for the run
when ``SimConfig.trace`` (CLI ``--trace out.json``) is set.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

#: schema tag carried in the exported JSON's ``otherData``
TRACE_SCHEMA_VERSION = 1


class NullTracer:
    """Disabled tracer: every operation is a no-op (the default)."""

    enabled = False

    @contextmanager
    def span(self, name: str, **args):
        yield

    def add_span(self, name: str, start_us: float, dur_us: float,
                 *, args: Optional[Dict[str, Any]] = None,
                 tid: Optional[int] = None) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def now_us(self) -> float:
        return 0.0

    def export(self, path: str) -> Optional[str]:
        return None


class SpanTracer(NullTracer):
    """Collects nestable spans; thread-safe; exports Chrome trace JSON."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self._events: list = []
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}

    # ------------------------------------------------------------- recording
    def now_us(self) -> float:
        """Microseconds since tracer start (the exported time base)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    @contextmanager
    def span(self, name: str, **args):
        """Live nested span; also a ``torch.profiler.record_function``."""
        t0 = self.now_us()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            self.add_span(name, t0, self.now_us() - t0,
                          args=args or None)

    def add_span(self, name: str, start_us: float, dur_us: float,
                 *, args: Optional[Dict[str, Any]] = None,
                 tid: Optional[int] = None) -> None:
        """Record a span with explicit timestamps (synthetic subdivisions)."""
        ev = {"name": name, "ph": "X", "ts": float(start_us),
              "dur": max(float(dur_us), 0.001), "pid": os.getpid(),
              "tid": self._tid() if tid is None else tid, "cat": "sim"}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker (``ph: "i"``)."""
        ev = {"name": name, "ph": "i", "ts": self.now_us(), "s": "t",
              "pid": os.getpid(), "tid": self._tid(), "cat": "sim"}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # --------------------------------------------------------------- export
    @property
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path.

        Events are sorted by (tid, ts) — what Perfetto's importer expects —
        and stamped with the wall-clock epoch of the tracer start so traces
        from different runs can be aligned offline.
        """
        with self._lock:
            events = sorted(self._events,
                            key=lambda e: (e["tid"], e["ts"], -e["dur"]
                                           if e["ph"] == "X" else 0.0))
        doc = {
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "otherData": {
                "schema_version": TRACE_SCHEMA_VERSION,
                "epoch_unix_s": self.wall_t0,
                "producer": "repro_torch.obs.trace",
            },
        }
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path


_NULL = NullTracer()
_current: NullTracer = _NULL


def get_tracer() -> NullTracer:
    """The current tracer (a :class:`NullTracer` unless a run installed one)."""
    return _current


def set_tracer(tracer: Optional[NullTracer]) -> NullTracer:
    """Install ``tracer`` (None restores the null tracer); returns previous."""
    global _current
    prev = _current
    _current = tracer if tracer is not None else _NULL
    return prev


@contextmanager
def named_scope(name: str):
    """A ``torch.profiler.record_function`` range under the reference's
    ``jax.named_scope`` name (the strategies' ``collective.*`` ranges), and
    a span of the current tracer when one is live."""
    if _current.enabled:
        with _current.span(name):
            yield
    else:
        with torch.profiler.record_function(name):
            yield


@contextmanager
def tracing(path: Optional[str] = None):
    """Scope a live :class:`SpanTracer` as current; export to ``path`` on
    exit when given.  Yields the tracer."""
    tracer = SpanTracer()
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
        if path:
            tracer.export(path)
