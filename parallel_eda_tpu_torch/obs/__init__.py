"""Observability: span tracing, the metrics registry, device profiling
and the run corpus, as in the JAX package's ``obs/`` (its metrics.py,
trace.py, devprof.py, runstore.py and slo.py).

  trace.py    — span tracer -> Chrome trace-event JSON (Perfetto);
                the seconds spent building the CUDA libraries are its
                "cuda.build" spans
  metrics.py  — counters, gauges and histograms, snapshotted per route
                window and per annealing temperature, dumpable as JSON
  devprof.py  — CUDA-event milliseconds per kernel and dispatch variant
                (devprof.json of a stats_dir route)
  runstore.py — the append-only, scenario-keyed run corpus
  slo.py      — latency digests, waterfalls, error budgets and the
                capacity forecaster of the route daemon

Both are no-ops until a driver enables them (``set_tracer``,
``MetricsRegistry.enabled``).
"""

from .devprof import DevProfiler, get_devprof, set_devprof
from .metrics import (COUNTER_TRACKS, Counter, Gauge, Histogram,
                      MetricsRegistry, get_metrics, set_metrics)
from .trace import (FlightRecorder, Tracer, compile_seconds, get_tracer,
                    note_build, reset_compile_seconds, set_tracer, span,
                    stage)

__all__ = [
    "DevProfiler", "get_devprof", "set_devprof",
    "COUNTER_TRACKS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_metrics", "set_metrics",
    "FlightRecorder", "Tracer", "compile_seconds", "get_tracer",
    "note_build", "reset_compile_seconds", "set_tracer", "span", "stage",
]
