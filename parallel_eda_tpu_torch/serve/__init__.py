"""Multi-tenant route serving, slice A14.1 of the JAX package's serve/:
the job queue (queue.py), cross-job net packing (batcher.py), the
RouteService front end (service.py) and its command line (cli.py,
``python -m parallel_eda_tpu_torch serve``).

Everything here layers ON TOP of route/: no routing semantics live in
this package, and per-job QoR is bit-identical to running the same job
alone.  Not ported yet (ROADMAP.md): continuous batching (fused.py,
A14.2), the program library (library.py, A14.3), the daemon (A14.4) and
the fleet (A14.5).
"""

from .batcher import CrossJobPlan, RungPlan, pack_jobs
from .queue import JobQueue, JobState, RouteJob
from .service import RouteService, ServeJobSpec

__all__ = [
    "JobQueue", "RouteJob", "JobState",
    "CrossJobPlan", "RungPlan", "pack_jobs",
    "RouteService", "ServeJobSpec",
]
