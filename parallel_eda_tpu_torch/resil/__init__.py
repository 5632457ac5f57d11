"""Resilience layer: seeded fault injection, durable checkpoints, the
dispatch watchdog with quarantine, and the graceful-degradation ladder
(the counterpart of parallel_eda_tpu/resil/).

The contract every component here enforces is the repo's bit-identical
discipline: a recovery action may change *timing* (retries, backoff,
slower kernel forms) but never *QoR*.  Each rung of the degradation
ladder is one of the already-proven bit-identical alternates (the
relaxation kernels' shared-memory modes, fused vs per-rung dispatch,
pipelined vs --sync, the sharded forms vs one card, checkpoint-resume vs
straight-through; resil/ladder.py names the port's form of each level),
so a run that weathers injected faults finishes with the wirelength of
the fault-free run.

``journal.py`` holds the daemon's and the fleet's durable state
(``JournalStore``, ``Heartbeat``, ``LeaseStore``).
"""

import time
from dataclasses import dataclass
from typing import Optional

from .checkpoint import CheckpointStore
from .faults import (SITES, BackendLostError, Fault, FaultInjected,
                     FaultPlan)
from .journal import Heartbeat, JournalStore, LeaseStore
from .ladder import DegradationLadder
from .watchdog import DispatchGuard, DispatchPoisonedError, Rung


@dataclass
class ResilOpts:
    """User-facing resilience configuration (see serve/cli.py flags)."""

    fault_plan: Optional[FaultPlan] = None
    checkpoint_dir: Optional[str] = None
    diag_dir: Optional[str] = None
    watchdog_s: float = 120.0
    dispatch_attempts: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0


class Resilience:
    """Runtime bundle threaded through RouterOpts.resil.

    Owns the fault plan, the per-dispatch guard, the global degradation
    ladder, and (when a checkpoint_dir is configured) the durable
    checkpoint store.  One instance per RouteService; the router only
    duck-types against ``.plan``, ``.guard`` and ``.ladder``.
    """

    def __init__(self, opts: ResilOpts, clock=time.monotonic,
                 sleep=time.sleep):
        self.opts = opts
        self.plan = opts.fault_plan
        self.ladder = DegradationLadder()
        self.guard = DispatchGuard(
            max_attempts=opts.dispatch_attempts,
            timeout_s=opts.watchdog_s,
            backoff_s=opts.backoff_s,
            backoff_mult=opts.backoff_mult,
            backoff_max_s=opts.backoff_max_s,
            plan=self.plan,
            ladder=self.ladder,
            clock=clock,
            sleep=sleep,
        )
        self.store = (CheckpointStore(opts.checkpoint_dir, plan=self.plan)
                      if opts.checkpoint_dir else None)


__all__ = [
    "SITES",
    "Fault",
    "FaultInjected",
    "BackendLostError",
    "FaultPlan",
    "CheckpointStore",
    "DispatchGuard",
    "DispatchPoisonedError",
    "Rung",
    "DegradationLadder",
    "Heartbeat",
    "JournalStore",
    "LeaseStore",
    "ResilOpts",
    "Resilience",
]
