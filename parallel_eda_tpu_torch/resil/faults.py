"""Deterministic seeded fault injection: the counterpart of
parallel_eda_tpu/resil/faults.py, with the same sites and the same
sha256-seeded schedule (a plan fires at the same invocation indices of
the same sites as the JAX package's for every (seed, spec)).

A ``FaultPlan`` decides, per named site, *which invocations* of that
site fire a fault.  The schedule is drawn once from a seed, so a chaos
run is replayable: same seed + same spec + same (deterministic)
workload => the same faults fire at the same points.  Sites count
their own invocations; firing is a pure function of (seed, site,
invocation index), independent of wall clock or interleaving of other
sites.

Sites are *cooperative*: the component owning a site calls
``plan.fire(site)`` at the injection point and acts on the returned
``Fault`` (raise, corrupt the bytes it just wrote, prepend a torn
line, ...).  Injection always happens BEFORE the guarded real work;
the port's window writes its state in place, so the guarded dispatch
also restores the window-entry state before a retry (route/router.py
``_WindowEntry``).

Every site name is kept.  ``library.corrupt`` fires in the program
library (serve/library.py), ``lease.steal`` in the route daemon
(serve/daemon.py), and ``worker.kill`` and ``transport.drop`` in the
fleet supervisor and its transport (serve/fleet.py, serve/transport.py).
"""

import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer

# Registry of known injection sites (the "fault kinds" of the chaos
# gate).  A FaultPlan may only schedule sites listed here so typos in
# --chaos specs fail fast.
SITES = {
    "dispatch.hang": "hung window dispatch (watchdog timeout)",
    "dispatch.error": "window-program compile/dispatch failure",
    "library.corrupt": "stale/truncated AOT library entry at dispatch",
    "checkpoint.corrupt": "durable checkpoint file torn after write",
    "corpus.torn": "corrupt JSONL line injected into a corpus append",
    "backend.loss": "simulated backend/device loss at slice start",
    "worker.kill": "fleet supervisor SIGKILLs a worker mid-slice",
    "transport.drop": "transport listener drops a connection mid-request",
    "lease.steal": "a held job lease is force-expired under its owner",
}


@dataclass(frozen=True)
class Fault:
    site: str
    seq: int            # per-site invocation index the fault fired at
    detail: str = ""


class FaultInjected(RuntimeError):
    """Raised (by the owning component) when an injected fault fires."""

    def __init__(self, fault: Fault):
        super().__init__(
            f"injected fault {fault.site}#{fault.seq}"
            + (f" ({fault.detail})" if fault.detail else ""))
        self.fault = fault


class BackendLostError(FaultInjected):
    """Simulated device/backend loss; recovered via durable checkpoint."""


def _site_rng(seed: int, site: str) -> random.Random:
    # hash() on str is salted per-process; derive a stable int seed so
    # the schedule replays across fresh processes.
    h = hashlib.sha256(f"{seed}:{site}".encode("utf-8")).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


class FaultPlan:
    """Seeded, replayable schedule of fault firings.

    ``spec`` maps site -> (count, horizon): ``count`` distinct firing
    indices are sampled (seeded) from the site's first ``horizon``
    invocations.  Keep ``horizon`` no larger than the number of times
    the workload actually reaches the site or some scheduled faults
    will never fire; ``fired_sites()`` reports what actually happened.
    """

    def __init__(self, seed: int, spec: Dict[str, tuple]):
        self.seed = int(seed)
        self.spec = {}
        self._fire_at: Dict[str, frozenset] = {}
        self._seq: Dict[str, int] = {}
        self.fired: List[Fault] = []
        for site, cfg in spec.items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known: {sorted(SITES)}")
            if isinstance(cfg, int):
                count, horizon = cfg, max(2 * cfg, cfg + 1)
            else:
                count, horizon = cfg
            count = int(count)
            horizon = max(int(horizon), count)
            self.spec[site] = (count, horizon)
            idx = _site_rng(self.seed, site).sample(range(horizon), count)
            self._fire_at[site] = frozenset(idx)
            self._seq[site] = 0

    @classmethod
    def parse(cls, seed: int, text: str) -> "FaultPlan":
        """Parse a CLI spec: ``site:count[:horizon],site:count...``."""
        spec = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            site = bits[0]
            count = int(bits[1]) if len(bits) > 1 else 1
            horizon = int(bits[2]) if len(bits) > 2 else max(
                2 * count, count + 1)
            spec[site] = (count, horizon)
        return cls(seed, spec)

    def fire(self, site: str, detail: str = "") -> Optional[Fault]:
        """Advance the site's invocation counter; return a Fault if
        this invocation is scheduled to fail, else None."""
        if site not in self._fire_at:
            return None
        seq = self._seq[site]
        self._seq[site] = seq + 1
        if seq not in self._fire_at[site]:
            return None
        fault = Fault(site, seq, detail)
        self.fired.append(fault)
        get_metrics().counter("route.resil.injections").inc()
        tr = get_tracer()
        if tr is not None:
            tr.instant(f"route.resil.inject.{site}", cat="resil",
                       seq=seq, detail=detail)
        return fault

    def raise_if(self, site: str, detail: str = "") -> None:
        f = self.fire(site, detail)
        if f is not None:
            if site == "backend.loss":
                raise BackendLostError(f)
            raise FaultInjected(f)

    def fired_sites(self) -> List[str]:
        return sorted({f.site for f in self.fired})

    def summary(self) -> dict:
        by_site: Dict[str, List[int]] = {}
        for f in self.fired:
            by_site.setdefault(f.site, []).append(f.seq)
        return {
            "seed": self.seed,
            "spec": {s: list(cfg) for s, cfg in self.spec.items()},
            "fired": by_site,
            "kinds_fired": len(by_site),
        }
