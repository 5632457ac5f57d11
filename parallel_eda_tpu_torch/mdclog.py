"""Structured per-(window, category) logging — the zlog/MDC equivalent.

The reference routes structured log records through zlog with MDC keys
so each (iteration, thread) pair gets its own file per category
(parallel_route/log.cxx:40-68 concurrent_log_impl_2, categories
log.h:13-24: delta/rr/net/schedule/...; set up at
partitioning_multi_sink_delta_stepping_route.cxx:5670-5675).  This
analogue keys records by (window, category) — windows are the unit of
host-visible work here, the way threads were there — and, like the
reference's compiled-out log macros (log.h:29-33), the whole subsystem
is a no-op unless a sink directory is configured.

MdcLogger is a context manager: the router holds its negotiation inside
``with MdcLogger(...) as mlog:`` so an exception mid-negotiation can
never leak open per-window file handles.  Records are stamped on
time.perf_counter against a caller-supplied origin (construction time
by default).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

# category registry (log.h:13-24 analogue)
CATEGORIES = ("route", "congestion", "schedule", "timing", "elastic")


class MdcLogger:
    """Sink-per-(window, category) structured logger.

    ``set_mdc(window=...)`` routes subsequent records to
    <dir>/logs/window_<w>/<category>.log (zlog_put_mdc semantics); each
    record is one JSON line with a monotonic timestamp.  ``t0`` is the
    perf_counter origin for those timestamps (defaults to construction
    time); give it the active tracer's t0 to share the trace clock."""

    def __init__(self, base_dir: Optional[str] = None,
                 t0: Optional[float] = None):
        self.base_dir = base_dir
        self._window = 0
        self._files = {}
        self._t0 = time.perf_counter() if t0 is None else t0

    @property
    def enabled(self) -> bool:
        return self.base_dir is not None

    def __enter__(self) -> "MdcLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def set_mdc(self, window: int) -> None:
        if self._window != window:
            self.close()
            self._window = window

    def log(self, category: str, **record) -> None:
        if not self.enabled:
            return
        if category not in CATEGORIES:
            raise ValueError(f"unknown log category {category!r}")
        f = self._files.get(category)
        if f is None:
            d = os.path.join(self.base_dir, "logs",
                             f"window_{self._window}")
            os.makedirs(d, exist_ok=True)
            f = open(os.path.join(d, f"{category}.log"), "a")
            self._files[category] = f
        record["t"] = round(time.perf_counter() - self._t0, 6)
        f.write(json.dumps(record) + "\n")
        f.flush()

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
