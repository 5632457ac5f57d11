"""Per-dispatch watchdog: retry with capped exponential backoff, then
variant quarantine and descent down a chain of bit-identical rungs (the
counterpart of parallel_eda_tpu/resil/watchdog.py).

The router hands ``DispatchGuard.run`` an ordered chain of ``Rung``s —
alternate ways to execute the SAME window with the SAME arguments (the
relaxation kernels in their shared-memory modes, the fused call and its
per-rung loop, the sharded forms and one card; resil/ladder.py).  Every
rung is bit-identical by construction, so stepping down the chain
changes timing only.  A rung that keeps failing (or exceeds the
watchdog budget) is quarantined *for that dispatch-variant key*: later
dispatches of the same variant skip it, i.e. the variant is
blacklisted from the dispatch cache it failed in.  When every
rung of a chain is exhausted the dispatch is poisoned —
``DispatchPoisonedError`` propagates to the job level, where the queue
retries from the durable checkpoint and the service steps the global
ladder (pipelined -> sync).

Injected faults ("dispatch.hang", "dispatch.error") fire BEFORE the
rung executes.  A real failure may come after some of a window's
launches wrote its state in place: the router's rungs restore the
window-entry state before they run again, so a retry is safe.  The
watchdog times the host call, as the JAX package's does: launches are
asynchronous and nothing here waits for the card.
"""

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer
from .faults import FaultInjected


@dataclass
class Rung:
    label: str
    run: Callable[[], object]
    # Invoked once when this rung is quarantined for a key — e.g. the
    # router steps the mesh dimension of the ladder.
    on_quarantine: Optional[Callable[[str], None]] = None


class DispatchPoisonedError(RuntimeError):
    def __init__(self, key, reason: str):
        super().__init__(f"dispatch poisoned after exhausting all "
                         f"rungs: {reason}")
        self.key = key
        self.reason = reason


class DispatchGuard:
    """Watchdog + retry/backoff + per-variant rung quarantine."""

    def __init__(self, max_attempts: int = 2, timeout_s: float = 120.0,
                 backoff_s: float = 0.05, backoff_mult: float = 2.0,
                 backoff_max_s: float = 2.0, plan=None, ladder=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.max_attempts = max(1, int(max_attempts))
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.backoff_max_s = backoff_max_s
        self.plan = plan
        self.ladder = ladder
        self.clock = clock
        self.sleep = sleep
        self._quarantine: Dict[object, Set[str]] = {}
        get_metrics().gauge("route.resil.retry_cap").set(self.max_attempts)

    def quarantined(self, key) -> Set[str]:
        return self._quarantine.get(key, set())

    def _backoff(self, attempt: int) -> float:
        return min(self.backoff_max_s,
                   self.backoff_s * (self.backoff_mult ** (attempt - 1)))

    def _quarantine_rung(self, key, rung: Rung, reason: str) -> None:
        self._quarantine.setdefault(key, set()).add(rung.label)
        n = sum(len(v) for v in self._quarantine.values())
        m = get_metrics()
        m.gauge("route.resil.quarantined_variants").set(n)
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.resil.quarantine", cat="resil",
                       rung=rung.label, reason=reason[:200])
        if rung.on_quarantine is not None:
            rung.on_quarantine(reason)
        if self.ladder is not None:
            self.ladder.record(rung.label, reason)

    def run(self, key, rungs: List[Rung]):
        """Execute the first healthy rung; retry/degrade on failure."""
        m = get_metrics()
        bad = self.quarantined(key)
        live = [r for r in rungs if r.label not in bad]
        if not live:
            # Everything already quarantined: give the last (most
            # conservative) rung one more chance rather than wedging.
            live = [rungs[-1]]
        li, attempts = 0, 0
        last_err = "unknown"
        while True:
            rung = live[li]
            try:
                if self.plan is not None:
                    self.plan.raise_if("dispatch.hang", detail=rung.label)
                    self.plan.raise_if("dispatch.error", detail=rung.label)
                t0 = self.clock()
                out = rung.run()
                dt = self.clock() - t0
                if dt > self.timeout_s:
                    # Dispatch completed but blew the watchdog budget:
                    # quarantine so future dispatches of this variant
                    # skip the slow rung.
                    m.counter("route.resil.watchdog_timeouts").inc()
                    self._quarantine_rung(
                        key, rung, f"watchdog {dt:.2f}s > {self.timeout_s}s")
                return out
            except DispatchPoisonedError:
                raise
            except Exception as e:  # noqa: BLE001 — any rung failure degrades
                hang = (isinstance(e, FaultInjected)
                        and e.fault.site == "dispatch.hang")
                m.counter("route.resil.watchdog_timeouts" if hang
                          else "route.resil.dispatch_errors").inc()
                last_err = f"{rung.label}: {e}"
                attempts += 1
                if attempts < self.max_attempts:
                    back = self._backoff(attempts)
                    m.counter("route.resil.retries").inc()
                    m.counter("route.resil.backoff_ms").inc(back * 1000.0)
                    tr = get_tracer()
                    w0 = time.perf_counter()
                    self.sleep(back)
                    if tr is not None:
                        tr.mark("route.resil.retry", w0,
                                time.perf_counter(), cat="resil",
                                rung=rung.label, attempt=attempts,
                                backoff_s=back)
                    continue
                # Rung exhausted: blacklist it for this variant and
                # step down the ladder.
                self._quarantine_rung(key, rung, last_err)
                attempts = 0
                li += 1
                if li >= len(live):
                    m.counter("route.resil.poisoned_dispatches").inc()
                    raise DispatchPoisonedError(key, last_err) from e
