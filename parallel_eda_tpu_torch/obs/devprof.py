"""Device-truth profiling per dispatch variant: the counterpart of
parallel_eda_tpu/obs/devprof.py, with its ``get_devprof()``,
``note_variant``, ``capture_all``, ``dump`` (devprof.json), the
dominant-variant rule and ``enabled`` (switched on by a ``stats_dir``
route, as in the JAX package).

XLA's ``cost_analysis()`` has no counterpart on the card.  What the port
records per variant key is what the card measures: the milliseconds of
every kernel launch between a pair of CUDA events, per kernel (K1
``planes_relax_full_cuda``, K2 ``planes_relax_cropped_cuda``, the
cluster kernel ``planes_relax_cluster_cuda`` and the peer kernel
``planes_relax_peer_cuda``), the number
of launches, and beside them the planner's modelled row (the
route.kernel.* layout of route/planes_kernels.py ``kernel_layout``:
``bytes_per_sweep`` is modelled, the time is measured).

The kernel wrappers record their events (``launch``) only while
``enabled`` is set and only on CUDA tensors, on the stream the kernel
is launched on; they are attributed to the variant of the latest
``note_variant``.  Nothing reads an event during the route:
``capture_all()`` waits for them at its end, so enabling the profiler
adds no host sync to the route and changes no result.  A variant whose
launches ran on CPU tensors records ``"unavailable": "cpu tensors: no
CUDA events"`` (the JAX package's graceful "unavailable" contract:
nothing runs in the kernel's place).
"""

from __future__ import annotations

import contextlib
import json
from typing import Optional

from .metrics import get_metrics

# the JAX package's sanity band for a measured-vs-modelled bytes ratio;
# the port measures time, not bytes, so no record carries a delta
DELTA_BAND_LOG10 = 2.0
CPU_UNAVAILABLE = "cpu tensors: no CUDA events"


def _jsonable(x):
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)


class DevProfiler:
    """CUDA-event times per dispatch variant.  Disabled by default; a
    driver (the router when a stats_dir sink is configured, chip_smoke)
    flips ``enabled``.  Keeps its OWN seen-set, independent of the
    router's dispatch-variant set, so a profiler enabled mid-process
    still records every variant the run dispatches."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._seen = set()
        self._pending = {}     # key -> record until capture_all
        self._current = None   # the key launches are attributed to
        self.records = []

    def note_variant(self, key, meta: dict, fn=None, args=(),
                     kwargs=None) -> bool:
        """Attribute the launches that follow to variant ``key`` (the
        canonical signature tuple) with the planner's modelled row
        ``meta``.  ``fn``/``args``/``kwargs`` (the JAX package's
        re-lowering inputs) are accepted and unused.  Returns True when
        the variant is new to this profiler: a variant is captured once,
        at the capture_all after its first note."""
        if not self.enabled:
            return False
        self._current = key
        if key in self._seen:
            return False
        self._seen.add(key)
        self._pending[key] = {"key": key, "meta": dict(meta), "events": [],
                              "cpu_calls": 0}
        return True

    @contextlib.contextmanager
    def launch(self, name: str, device):
        """Bracket one kernel launch on ``device``'s current stream with
        a pair of CUDA events (only while enabled, on a card, with a
        variant noted); CPU tensors are counted as such."""
        rec = self._pending.get(self._current) if self.enabled else None
        if rec is None:
            yield
            return
        if getattr(device, "type", "cpu") != "cuda":
            rec["cpu_calls"] += 1
            yield
            return
        import torch

        stream = torch.cuda.current_stream(device)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record(stream)
        yield
        ev1.record(stream)
        rec["events"].append((name, ev0, ev1))

    def note_cpu_call(self) -> None:
        """A relaxation of the noted variant ran its plain version on CPU
        tensors (no event to record)."""
        rec = self._pending.get(self._current) if self.enabled else None
        if rec is not None:
            rec["cpu_calls"] += 1

    def _capture(self, rec) -> dict:
        out = {"key": _jsonable(rec["key"]), "meta": _jsonable(rec["meta"])}
        if not rec["events"]:
            out["unavailable"] = (CPU_UNAVAILABLE if rec["cpu_calls"]
                                  else "no kernel launches recorded")
            return out
        kernels = {}
        for name, ev0, ev1 in rec["events"]:
            ev1.synchronize()
            k = kernels.setdefault(name, {"launches": 0, "ms": 0.0})
            k["launches"] += 1
            k["ms"] += float(ev0.elapsed_time(ev1))
        for k in kernels.values():
            k["ms_per_launch"] = k["ms"] / k["launches"]
        out["kernels"] = kernels
        out["launches"] = sum(k["launches"] for k in kernels.values())
        out["device_ms"] = sum(k["ms"] for k in kernels.values())
        return out

    def capture_all(self) -> list:
        """Read every pending variant's events (waiting for the card) and
        publish the route.devcost.* gauges.  Call this OUTSIDE measured
        regions; idempotent between notes."""
        pending, self._pending = self._pending, {}
        for rec in pending.values():
            self.records.append(self._capture(rec))
        self._current = None
        if self.records:
            self._publish_gauges()
        return self.records

    def _dominant(self) -> Optional[dict]:
        """The measured record covering the most nets (the same
        dominant-window rule the route.kernel.* gauges use)."""
        measured = [r for r in self.records if "unavailable" not in r]
        if not measured:
            return None
        return max(measured,
                   key=lambda r: r.get("meta", {}).get("nets", 0))

    def _publish_gauges(self) -> None:
        reg = get_metrics()
        reg.gauge("route.devcost.variants").set(len(self.records))
        dom = self._dominant()
        if dom is None:
            return
        reg.set_gauges({"route.devcost.device_ms": dom["device_ms"],
                        "route.devcost.launches": dom["launches"]})

    def summary(self) -> dict:
        """The dominant variant's measured numbers, or unavailable with
        its reason."""
        if not self.records:
            return {"unavailable": "no dispatch variants captured"}
        dom = self._dominant()
        if dom is None:
            return {"unavailable": self.records[0].get(
                "unavailable", "no measured variants"),
                "variants": len(self.records)}
        out = {"variants": len(self.records),
               "measured_variants": len(
                   [r for r in self.records if "unavailable" not in r]),
               "device_ms": dom["device_ms"], "launches": dom["launches"],
               "kernels": dom["kernels"]}
        meta = dom.get("meta", {})
        if "bytes_per_sweep" in meta:
            out["modeled_bytes_per_sweep"] = meta["bytes_per_sweep"]
        if "plane_dtype" in meta:
            out["plane_dtype"] = meta["plane_dtype"]
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"delta_band_log10": DELTA_BAND_LOG10,
                       "records": self.records,
                       "summary": self.summary()}, f, indent=1)

    def reset(self) -> None:
        self._seen.clear()
        self._pending.clear()
        self._current = None
        self.records.clear()


# process-wide profiler, same enablement pattern as the registry: note
# sites call it unconditionally (a disabled note is one attribute read);
# drivers flip .enabled
_profiler = DevProfiler()


def get_devprof() -> DevProfiler:
    return _profiler


def set_devprof(p: DevProfiler) -> DevProfiler:
    global _profiler
    _profiler = p
    return _profiler
