"""The traced run's device record: torch.profiler over the window.

``DeviceTrace`` profiles the card's activity (kernels, memsets, copies)
from just before the window opens until every client has finished.  A
marker kernel launched before any client starts ties the profiler's
clock to the host's ``time.perf_counter``.  ``stop`` reduces the
records to what the metrics read: device seconds and launches by name,
the busy seconds (the union of the activity intervals inside the
window, so that overlapping records count once), and the idle gaps."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    name = name.replace("(anonymous namespace)::", "")
    base = name.split("(")[0].split("<")[0].split()
    return base[-1].split("::")[-1] if base else name[:60]


class DeviceTrace:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.by_name: Dict[str, List[float]] = {}   # name -> [s, launches]
        self.intervals: List[Tuple[float, float]] = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self.offset_s = 0.0
        self.records = 0

    def start(self) -> None:
        if not self.cuda:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        mark = torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        mark.fill_(1.0)
        torch.cuda.synchronize()

    def stop(self, t_open: float, t_close: float) -> None:
        self.window_s = t_close - t_open
        if not self.cuda:
            return
        from torch.autograd import DeviceType

        self._prof.__exit__(None, None, None)
        ev = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "is_hidden_event") and e.is_hidden_event():
                continue
            start = (e.start_ns() if hasattr(e, "start_ns")
                     else e.start_us() * 1000)
            ev.append((start * 1e-9, e.duration_ns() * 1e-9, e.name()))
        ev.sort()
        self.records = len(ev)
        if not ev:
            return
        # the first record is the marker fill, launched at _t_mark
        self.offset_s = ev[0][0] - self._t_mark
        lo, hi = t_open + self.offset_s, t_close + self.offset_s
        spans = []
        for s, d, name in ev[1:]:
            e = s + d
            if e <= lo or s >= hi:
                continue
            k = self.by_name.setdefault(short_name(name), [0.0, 0])
            k[0] += d
            k[1] += 1
            spans.append((max(s, lo) - self.offset_s,
                          min(e, hi) - self.offset_s))
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.intervals = [(s, e) for s, e in merged]
        self.busy_s = sum(e - s for s, e in self.intervals)
        self._t_open, self._t_close = t_open, t_close

    def device_seconds(self, match) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose short name
        ``match`` accepts."""
        s = n = 0
        for name, (sec, cnt) in self.by_name.items():
            if match(name):
                s += sec
                n += cnt
        return s, n

    def top_ops(self, k: int = 10) -> list:
        return [[name, sec] for name, (sec, _) in sorted(
            self.by_name.items(), key=lambda kv: -kv[1][0])[:k]]

    def idle_gaps(self, spans: List[Tuple[float, float, str]],
                  k: int = 10) -> list:
        """The ``k`` longest idle gaps of the traced window, each named by
        the innermost host span (the latest to start) around its
        middle."""
        if not self.cuda:
            return []
        edges = ([self._t_open] + [x for iv in self.intervals for x in iv]
                 + [self._t_close])
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inner = max(((s, name) for s, e, name in spans if s <= mid < e),
                        default=(0.0, "no host span"))
            out.append([inner[1], length])
        return out
