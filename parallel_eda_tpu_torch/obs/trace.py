"""Span-based tracer exporting Chrome trace-event JSON (the JAX
package's ``obs/trace.py``, same behaviour and event layout), openable
in Perfetto or chrome://tracing.

Spans are complete ("X") events with microsecond timestamps from one
process-wide perf_counter origin, so mdclog records stamped from the
same origin line up.  With no tracer installed, ``span()`` hands back
one shared do-nothing context.

The JAX package also turns XLA's compile phases into "jax.compile.*"
spans.  The port compiles nothing at run time but its CUDA libraries:
``note_build`` books the seconds nvcc spends on one (route/cuda_lib.py)
as a "cuda.build" span and into ``compile_seconds()``.  There is no
listener to enable.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared do-nothing context: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "_t_in")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t_in = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        self.tracer.add_complete(self.name, self._t_in, t - self._t_in,
                                 cat=self.cat, **self.args)
        return False


class Tracer:
    """In-memory span recorder; ``export`` writes the trace-event file.
    Timestamps are perf_counter seconds relative to ``t0`` (µs in the
    file); appends are thread-safe and tid is the OS thread ident."""

    def __init__(self, worker: str = ""):
        self.t0 = time.perf_counter()
        self.worker = str(worker)
        self.events: list = []
        self.declared_counter_tracks: set = set()
        self._lock = threading.Lock()

    def span(self, name: str, cat: str = "flow", **args) -> _Span:
        return _Span(self, name, cat, args)

    def add_complete(self, name: str, t_abs: float, dur: float,
                     cat: str = "flow", **args) -> None:
        """Record a complete event from absolute perf_counter seconds."""
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": (t_abs - self.t0) * 1e6, "dur": max(0.0, dur) * 1e6,
              "pid": 1, "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def mark(self, name: str, t_begin: float, t_end: float,
             cat: str = "flow", **args) -> None:
        """A complete event over a measured [t_begin, t_end) interval."""
        self.add_complete(name, t_begin, t_end - t_begin, cat=cat,
                          **args)

    def instant(self, name: str, cat: str = "flow", **args) -> None:
        ev = {"name": name, "ph": "i", "cat": cat, "s": "t",
              "ts": (time.perf_counter() - self.t0) * 1e6,
              "pid": 1, "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def beacon(self, **args) -> None:
        """Clock-sync instant: a wall-clock / perf_counter pair."""
        self.instant("route.trace.beacon", cat="trace",
                     wall=time.time(), perf=time.perf_counter(), **args)

    def declare_counter_tracks(self, names) -> None:
        """Counter tracks that should exist even with no sample."""
        with self._lock:
            self.declared_counter_tracks.update(str(n) for n in names)

    def counter(self, name: str, value, cat: str = "metrics") -> None:
        """One sample of a Perfetto counter track ("C" event)."""
        ev = {"name": name, "ph": "C", "cat": cat,
              "ts": (time.perf_counter() - self.t0) * 1e6,
              "pid": 1, "tid": threading.get_ident() & 0x7FFFFFFF,
              "args": {"value": float(value)}}
        with self._lock:
            self.events.append(ev)

    def total(self, name_prefix: str) -> float:
        """Seconds of the spans whose name starts with name_prefix."""
        with self._lock:
            return sum(e.get("dur", 0.0) for e in self.events
                       if e["ph"] == "X"
                       and e["name"].startswith(name_prefix)) / 1e6

    def export(self, path: str, atomic: bool = False) -> None:
        """Write the trace; ``atomic`` goes through a temporary file and
        os.replace, so a reader never sees a torn file."""
        with self._lock:
            evs = sorted(self.events, key=lambda e: e["ts"])
            tracks = sorted(self.declared_counter_tracks)
        pname = "parallel_eda_tpu_torch" + (f" {self.worker}"
                                            if self.worker else "")
        meta = [{"name": "process_name", "ph": "M", "pid": 1, "ts": 0,
                 "args": {"name": pname}}]
        doc = {"traceEvents": meta + evs, "displayTimeUnit": "ms"}
        if self.worker:
            doc["worker"] = self.worker
        if tracks:
            doc["declaredCounterTracks"] = tracks
        if atomic:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        else:
            with open(path, "w") as f:
                json.dump(doc, f)


class FlightRecorder:
    """Bounded ring of recent notes for one worker, independent of the
    Tracer and of the metrics registry."""

    def __init__(self, capacity: int = 256, clock=time.monotonic,
                 wall=time.time):
        self.capacity = max(1, int(capacity))
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self.total = 0

    def note(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "mono": round(self._clock(), 6),
              "wall": round(self._wall(), 6)}
        ev.update(fields)
        with self._lock:
            self._ring.append(ev)
            self.total += 1

    def snapshot(self) -> dict:
        """The ring oldest-first and how much history fell off."""
        with self._lock:
            events = list(self._ring)
            total = self.total
        return {"capacity": self.capacity, "recorded": total,
                "dropped": max(0, total - len(events)),
                "events": events}


# ---- process-wide tracer + the disabled fast path ----

_tracer: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear, with None) the process tracer."""
    global _tracer
    _tracer = tracer


def span(name: str, cat: str = "flow", **args):
    """``with span("route.iter", it=3):`` on the installed tracer; a
    shared no-op context when tracing is off."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat=cat, **args)


class _StageCtx:
    """span() that also writes its seconds into a stage -> seconds dict
    (FlowResult.times)."""
    __slots__ = ("name", "times", "inner", "_t_in")

    def __init__(self, name: str, times: Optional[dict], inner):
        self.name = name
        self.times = times
        self.inner = inner

    def __enter__(self):
        self._t_in = time.perf_counter()
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        r = self.inner.__exit__(*exc)
        if self.times is not None:
            self.times[self.name] = time.perf_counter() - self._t_in
        return r


def stage(name: str, times: Optional[dict] = None, **args) -> _StageCtx:
    """Flow-stage span ("pack", "place", "route", ...) that fills the
    times dict on the same clock."""
    return _StageCtx(name, times, span(name, cat="stage", **args))


# ---- CUDA library builds (the port's compile time) ----

_compile_s = 0.0


def note_build(name: str, t_begin: float, seconds: float) -> None:
    """Book one CUDA library build (nvcc, ``seconds`` from perf_counter
    ``t_begin``): into compile_seconds() and, with a tracer installed,
    as a "cuda.build" span."""
    global _compile_s
    _compile_s += seconds
    t = _tracer
    if t is not None:
        t.add_complete("cuda.build", t_begin, seconds, cat="cuda.build",
                       lib=name)


def compile_seconds() -> float:
    """Seconds of CUDA library builds since the last reset."""
    return _compile_s


def reset_compile_seconds() -> None:
    global _compile_s
    _compile_s = 0.0
