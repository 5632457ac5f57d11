"""Observability: span tracing and the metrics registry, as in the JAX
package's ``obs/`` (its metrics.py and trace.py; devprof, the SLO plane
and the run store are not ported).

  trace.py    — span tracer -> Chrome trace-event JSON (Perfetto);
                the seconds spent building the CUDA libraries are its
                "cuda.build" spans
  metrics.py  — counters, gauges and histograms, snapshotted per route
                window and per annealing temperature, dumpable as JSON

Both are no-ops until a driver enables them (``set_tracer``,
``MetricsRegistry.enabled``).
"""

from .metrics import (COUNTER_TRACKS, Counter, Gauge, Histogram,
                      MetricsRegistry, get_metrics, set_metrics)
from .trace import (FlightRecorder, Tracer, compile_seconds, get_tracer,
                    note_build, reset_compile_seconds, set_tracer, span,
                    stage)

__all__ = [
    "COUNTER_TRACKS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_metrics", "set_metrics",
    "FlightRecorder", "Tracer", "compile_seconds", "get_tracer",
    "note_build", "reset_compile_seconds", "set_tracer", "span", "stage",
]
