"""Multi-tenant route serving, the counterpart of the JAX package's
serve/: the job queue (queue.py), cross-job net packing (batcher.py),
continuous batching (fused.py), the program library (library.py), the
RouteService front end (service.py) and its command line (cli.py,
``python -m parallel_eda_tpu_torch serve``), the long-lived route
daemon (daemon.py, daemon_cli.py: ``python -m parallel_eda_tpu_torch
daemon``), and the fleet of daemons over one inbox (fleet.py, with
its network transport, transport.py: ``daemon fleet``).

Everything here layers ON TOP of route/: no routing semantics live in
this package, and per-job QoR is bit-identical to running the same job
alone.
"""

from .batcher import CrossJobPlan, RungPlan, pack_jobs
from .queue import JobQueue, JobState, RouteJob
from .service import RouteService, ServeJobSpec

__all__ = [
    "JobQueue", "RouteJob", "JobState",
    "CrossJobPlan", "RungPlan", "pack_jobs",
    "RouteService", "ServeJobSpec",
]
