"""Job queue for the route service (the counterpart of
parallel_eda_tpu/serve/queue.py, the same scheduling step for step,
with the batched loop ``run_batch`` of continuous batching and the
daemon's overload eviction ``evict``).

Cooperative (single-threaded) scheduling: the routing device is one
serially-ordered resource, so the queue time-slices it rather than
spawning threads — a job runs for a bounded slice of router
iterations, gets checkpointed via the existing ``RouteCheckpoint``
resume path, and goes back in the heap.  That gives preemption,
priority ordering, per-job deadlines, and bounded retry-with-backoff
without any routing-semantics changes: a preempted-and-resumed job
computes exactly what an uninterrupted one does.

The queue knows nothing about routing.  The runner callback owns the
domain: it receives a ``RouteJob`` and returns one of

    ("done", result)           — job finished
    ("preempted", checkpoint)  — slice expired; requeue with state
    ("failed", message)        — attempt failed; retry or bury

A raised exception counts as a failed attempt.  service.py provides
the Router-backed runner; tests drive the queue with fakes.

Scheduling order is *aged* priority: a job's effective priority grows
with its wait time (``aging_rate`` points per queued second), so a
continuous stream of high-priority arrivals can delay a low-priority
job but never starve it forever.  Because every queued job ages at the
same rate, the relative order of any two jobs is time-invariant —
``p + r*(now - t_admit)`` comparisons cancel the ``now`` — which lets
the heap key stay static: ``r*t_admit - p``.  ``aging_rate=0``
(default) is exact strict-priority, bit-compatible with the pre-aging
queue.

Stdlib + obs.metrics only.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.metrics import get_metrics


class JobState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    TIMEOUT = "timeout"
    SHED = "shed"          # evicted under overload (daemon load shedding)


@dataclass
class RouteJob:
    tenant: str
    payload: Any                       # opaque to the queue
    job_id: str = ""
    priority: int = 0                  # higher runs first
    deadline_s: Optional[float] = None # wall budget from admit()
    max_retries: int = 0
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0         # exponential backoff ceiling
    state: JobState = JobState.QUEUED
    attempts: int = 0
    preemptions: int = 0
    slices: int = 0
    checkpoint: Any = None             # RouteCheckpoint between slices
    result: Any = None
    error: Optional[str] = None
    admitted_t: float = 0.0
    not_before: float = 0.0            # backoff gate
    scratch: Dict[str, Any] = field(default_factory=dict)

    def deadline_exceeded(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.admitted_t > self.deadline_s)

    @property
    def failure_reason(self) -> Optional[str]:
        """Terminal failure reason for the job summary JSON; None for
        non-terminal or successful states."""
        if self.state in (JobState.FAILED, JobState.TIMEOUT):
            return (f"{self.state.value}: {self.error} "
                    f"(attempts={self.attempts})")
        if self.state is JobState.SHED:
            return f"shed: {self.error}"
        return None


Outcome = Tuple[str, Any]
Runner = Callable[[RouteJob], Outcome]


class JobQueue:
    """Priority heap + cooperative run loop."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 aging_rate: float = 0.0):
        self._heap: List[Tuple[float, int, RouteJob]] = []
        self._seq = 0
        self._clock = clock
        self._sleep = sleep
        # priority points gained per queued second (see module doc);
        # 0 = strict priority.  Mutable: the daemon sets it before any
        # admit, but a mid-stream change only affects later pushes.
        self.aging_rate = float(aging_rate)
        self.jobs: List[RouteJob] = []
        self._by_id: Dict[str, RouteJob] = {}

    # ------------------------------------------------------ admit

    def admit(self, job: RouteJob) -> RouteJob:
        """Admit a job; idempotent on job_id.  Re-submitting an id the
        queue already knows (the restart/replay path: a recovered
        journal entry racing the re-read inbox) returns the EXISTING
        job unchanged — never a duplicate heap entry, never a state
        reset on a job that already ran."""
        if job.job_id:
            existing = self._by_id.get(job.job_id)
            if existing is not None:
                get_metrics().counter("route.serve.jobs_deduped").inc()
                return existing
        else:
            job.job_id = f"job{len(self.jobs):04d}"
        job.admitted_t = self._clock()
        job.state = JobState.QUEUED
        self.jobs.append(job)
        self._by_id[job.job_id] = job
        self._push(job)
        get_metrics().counter("route.serve.jobs_admitted").inc()
        self._depth_gauge()
        return job

    def get(self, job_id: str) -> Optional[RouteJob]:
        return self._by_id.get(job_id)

    def effective_priority(self, job: RouteJob,
                           now: Optional[float] = None) -> float:
        """Aged priority at ``now``: the number the heap order (and the
        daemon's shed-victim ranking) is actually based on."""
        now = self._clock() if now is None else now
        return job.priority + self.aging_rate * (now - job.admitted_t)

    def _push(self, job: RouteJob) -> None:
        # fresh seq on every (re)queue: equal-priority jobs round-robin
        # between slices instead of one job monopolizing the device.
        # The key is the time-invariant aged-priority order (module
        # doc): aging_rate * admitted_t - priority, ascending.
        self._seq += 1
        key = self.aging_rate * job.admitted_t - job.priority
        heapq.heappush(self._heap, (key, self._seq, job))

    def _depth_gauge(self) -> None:
        get_metrics().gauge("route.serve.queue_depth").set(self.depth())

    def depth(self) -> int:
        """Queued (runnable) jobs; shed tombstones don't count."""
        return sum(1 for _, _, j in self._heap
                   if j.state is JobState.QUEUED)

    def queued_jobs(self) -> List[RouteJob]:
        """Jobs currently waiting in the heap (admission order not
        guaranteed) — the shed-victim candidate set."""
        return [j for _, _, j in self._heap
                if j.state is JobState.QUEUED]

    # ------------------------------------------------------- evict

    def evict(self, job_id: str, state: JobState = JobState.SHED,
              error: Optional[str] = None) -> Optional[RouteJob]:
        """Remove a QUEUED job from scheduling (overload shedding).
        The heap entry becomes a tombstone the run loop skips; jobs
        already terminal or mid-slice are left alone (returns None)."""
        job = self._by_id.get(job_id)
        if job is None or job.state is not JobState.QUEUED:
            return None
        job.state = state
        job.error = error
        get_metrics().counter("route.serve.jobs_shed").inc()
        self._depth_gauge()
        return job

    # -------------------------------------------------------- run

    def run(self, runner: Runner,
            max_slices: int = 100000) -> List[RouteJob]:
        """Drain the queue through ``runner``; returns all jobs in
        admission order with terminal states set."""
        m = get_metrics()
        slices = 0
        while self._heap and slices < max_slices:
            _, _, job = heapq.heappop(self._heap)
            if job.state is not JobState.QUEUED:
                continue               # shed tombstone; costs no slice
            slices += 1
            self._depth_gauge()
            now = self._clock()
            if job.deadline_exceeded(now):
                job.state = JobState.TIMEOUT
                job.error = (f"deadline {job.deadline_s}s exceeded "
                             f"after {now - job.admitted_t:.2f}s")
                m.counter("route.serve.jobs_timeout").inc()
                continue
            if now < job.not_before:
                # backoff not elapsed; if it's the only job, wait it out
                self._push(job)
                if all(self._clock() < j.not_before
                       for _, _, j in self._heap
                       if j.state is JobState.QUEUED):
                    self._sleep(max(0.0, job.not_before - self._clock()))
                continue
            job.state = JobState.RUNNING
            job.slices += 1
            try:
                verdict, value = runner(job)
            except Exception as e:  # an attempt died; retry or bury
                verdict, value = "failed", f"{type(e).__name__}: {e}"
            self._apply(job, verdict, value)
            self._depth_gauge()
        return list(self.jobs)

    def _apply(self, job: RouteJob, verdict: str, value: Any) -> None:
        """Apply a runner verdict to a job — the single state machine
        shared by the one-at-a-time loop and the batched loop."""
        m = get_metrics()
        if verdict == "done":
            job.state = JobState.DONE
            job.result = value
            m.counter("route.serve.jobs_done").inc()
        elif verdict == "preempted":
            job.checkpoint = value
            job.preemptions += 1
            job.state = JobState.QUEUED
            m.counter("route.serve.jobs_preempted").inc()
            self._push(job)
        elif verdict == "failed":
            job.attempts += 1
            job.error = str(value)
            if job.attempts > job.max_retries:
                job.state = JobState.FAILED
                m.counter("route.serve.jobs_failed").inc()
            else:
                back = min(job.backoff_max_s,
                           job.backoff_s * (
                               job.backoff_mult
                               ** (job.attempts - 1)))
                nb = self._clock() + back
                if (job.deadline_s is not None
                        and nb - job.admitted_t > job.deadline_s):
                    # the retry could only start past the deadline:
                    # fail fast instead of sleeping into a TIMEOUT
                    job.state = JobState.TIMEOUT
                    job.error = (
                        f"retry backoff {back:.3f}s lands past "
                        f"deadline {job.deadline_s}s "
                        f"(after: {value})")
                    m.counter("route.serve.jobs_timeout").inc()
                else:
                    job.not_before = nb
                    job.checkpoint = None  # retry restarts clean
                    job.state = JobState.QUEUED
                    m.counter("route.serve.jobs_retried").inc()
                    self._push(job)
        else:
            raise ValueError(f"runner returned {verdict!r}")

    # -------------------------------------------------- batched run

    def _pop_runnable(self) -> List[RouteJob]:
        """Pop EVERY currently-runnable queued job off the heap (aged
        priority order), skipping tombstones, timing out past-deadline
        jobs, and re-pushing backoff-gated ones.  The batch scheduler's
        admission step: whatever this returns is co-admitted into one
        fused slice."""
        m = get_metrics()
        out: List[RouteJob] = []
        gated: List[RouteJob] = []
        while self._heap:
            _, _, job = heapq.heappop(self._heap)
            if job.state is not JobState.QUEUED:
                continue               # shed tombstone
            now = self._clock()
            if job.deadline_exceeded(now):
                job.state = JobState.TIMEOUT
                job.error = (f"deadline {job.deadline_s}s exceeded "
                             f"after {now - job.admitted_t:.2f}s")
                m.counter("route.serve.jobs_timeout").inc()
                continue
            if now < job.not_before:
                gated.append(job)      # backoff not elapsed
                continue
            out.append(job)
        for job in gated:
            self._push(job)
        return out

    def run_batch(self, batch_runner: Callable[
            [List[RouteJob]], Dict[str, Outcome]],
            max_batches: int = 100000) -> List[RouteJob]:
        """Drain the queue through a BATCH runner: each round pops all
        runnable jobs, hands the whole co-admitted set to
        ``batch_runner`` (returns ``{job_id: (verdict, value)}``), and
        applies each verdict through the same state machine as
        ``run()``.  One round costs one slice per member job; a raised
        batch runner counts as a failed attempt for every member."""
        m = get_metrics()
        rounds = 0
        while rounds < max_batches:
            batch = self._pop_runnable()
            if not batch:
                gated = self.queued_jobs()
                if not gated:
                    break              # drained
                # every queued job is backoff-gated: wait out the
                # soonest gate instead of spinning
                self._sleep(max(0.0, min(j.not_before for j in gated)
                                 - self._clock()))
                continue
            rounds += 1
            for job in batch:
                job.state = JobState.RUNNING
                job.slices += 1
            self._depth_gauge()
            try:
                verdicts = batch_runner(batch)
            except Exception as e:
                verdicts = {j.job_id: (
                    "failed", f"{type(e).__name__}: {e}") for j in batch}
            for job in batch:
                verdict, value = verdicts.get(job.job_id, (
                    "failed", "batch runner returned no verdict"))
                self._apply(job, verdict, value)
            self._depth_gauge()
        return list(self.jobs)
