"""Metrics registry: counters / gauges / histograms + per-iteration
snapshots (the JAX package's ``obs/metrics.py``, same behaviour).

Every layer registers named instruments on one process-wide registry
(``get_metrics()``), the router snapshots them at window boundaries and
the placer at each temperature, and ``dump`` writes the whole
trajectory as JSON (the CLI's ``stats_dir/metrics.json``).  Updating an
instrument is always cheap and always on; only ``snapshot`` is gated on
``enabled``, so an un-instrumented run keeps no history.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .trace import get_tracer

# instruments mirrored as Perfetto counter-track ("C") samples on every
# snapshot, on the tracer's clock
COUNTER_TRACKS = ("route.overused_nodes", "route.pres_fac",
                  "route.relax_steps_wasted",
                  "route.pipeline.stall_ms", "place.t")


class Counter:
    """Monotone accumulator; the increment is any number."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-value instrument."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Streaming summary: count, sum, min, max."""
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "mean": self.mean if self.count else None}


class MetricsRegistry:
    """Named instruments + an append-only list of labeled snapshots."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self.snapshots: List[dict] = []

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def set_gauges(self, values: Dict[str, object]) -> None:
        """Set a family of related gauges in one call."""
        for name, v in values.items():
            self.gauge(name).set(v)

    def values(self, prefix: str = "") -> dict:
        """Current value of every instrument (histograms summarized)."""
        out = {}
        for n, c in self._counters.items():
            if n.startswith(prefix):
                out[n] = c.value
        for n, g in self._gauges.items():
            if n.startswith(prefix):
                out[n] = g.value
        for n, h in self._hists.items():
            if n.startswith(prefix):
                out[n] = h.summary()
        return out

    def snapshot(self, **labels) -> Optional[dict]:
        """Record the current values under ``labels`` (e.g.
        phase="route", iteration=7) and mirror the COUNTER_TRACKS on
        the installed tracer.  A no-op unless enabled."""
        if not self.enabled:
            return None
        snap = {"labels": labels, "values": self.values()}
        self.snapshots.append(snap)
        tr = get_tracer()
        if tr is not None:
            tr.declare_counter_tracks(COUNTER_TRACKS)
            for name in COUNTER_TRACKS:
                v = snap["values"].get(name)
                if isinstance(v, (int, float)) and not isinstance(v,
                                                                  bool):
                    tr.counter(name, v)
        return snap

    def series(self, name: str, **match) -> list:
        """One instrument's values across the snapshots whose labels
        contain ``match``."""
        out = []
        for s in self.snapshots:
            if all(s["labels"].get(k) == v for k, v in match.items()):
                if name in s["values"]:
                    out.append(s["values"][name])
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"values": self.values(),
                       "snapshots": self.snapshots}, f, indent=1)

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        self.snapshots.clear()


# process-wide registry: layers update it unconditionally; snapshots
# accumulate once a driver (the CLI's --trace / --stats_dir, a test)
# sets .enabled
_registry = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return _registry


def set_metrics(reg: MetricsRegistry) -> MetricsRegistry:
    global _registry
    _registry = reg
    return reg
