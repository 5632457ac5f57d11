"""RouteService: the multi-tenant serving front end (the counterpart
of parallel_eda_tpu/serve/service.py).

One Router (one device graph, its kernels' launch plans warm) serves
many admitted jobs: the queue time-slices the device between jobs via
the RouteCheckpoint resume path, and the cross-job batcher publishes
the shared dispatch plan for the admitted set.  Per job the service
verifies legality, publishes per-tenant ``route.serve.*`` telemetry,
and appends a tenant-stamped record to the run corpus.  With
``RouterOpts.program_library_dir`` the Router serves its dispatch
variants through the program library (serve/library.py).  Under
``resil`` the Router's dispatches are guarded, slices flush durable
checkpoints, the fault sites are armed (``backend.loss`` at a slice's
start, ``corpus.torn`` at a corpus append, the store's
``checkpoint.corrupt``), a poisoned dispatch steps the job-level ladder
(pipelined -> sync), and a terminally failed job leaves a diagnostic
bundle; with a program library attached, the plan also arms its
``library.corrupt`` site.  ``fused=True`` is continuous batching: every
slice round co-admits all runnable jobs and drives their window
dispatches in lockstep through one merged call per step
(serve/fused.py), rebatching at each slice boundary.  The route
daemon's hooks are here too: ``begin_drain``, the ``flight`` recorder
slot and the ``diag_extra`` attribution callable that the diagnostic
bundle reads, and the latency columns (``job.scratch["slo_fields"]``)
of the corpus row.

All jobs must target the same device graph (same arch/grid/channel
width); admit() enforces it.  The Router runs on ``device`` (the card
by default).

A preempted, sliced job resumes under the port's rule for a resumed
route (ROADMAP.md C8: the window status's 8-tile live bb sizes), so a
sliced job equals the port's unsliced route; the JAX package's sliced
route may differ from its own unsliced one under crop.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer
from ..resil import Resilience, ResilOpts
from ..resil.watchdog import DispatchPoisonedError
from ..route.router import Router, RouterOpts
from .batcher import pack_jobs
from .queue import JobQueue, JobState, RouteJob


@dataclass
class ServeJobSpec:
    """One admitted routing request: terminals on the service's
    device graph, plus accounting identity."""
    term: Any                       # NetTerminals
    name: str = ""
    max_iterations: int = 0         # 0 = the service default
    crit: Optional[np.ndarray] = None
    detail: Dict[str, Any] = field(default_factory=dict)


class RouteService:
    def __init__(self, rr, opts: Optional[RouterOpts] = None,
                 slice_iters: int = 0, verify: bool = True,
                 runs_dir: Optional[str] = None,
                 scenario: str = "serve_smoke",
                 cfg: Optional[dict] = None,
                 resil: Optional[ResilOpts] = None,
                 fused: bool = False, device=None):
        """``slice_iters`` > 0 preempts each job after that many router
        iterations (checkpointed, requeued) — the fairness knob; 0
        runs each job to completion in one slice.  ``resil`` arms the
        resilience layer: guarded dispatches, durable checkpoints
        (when a checkpoint_dir is set), fault-injection sites, and
        diagnostic bundles for poisoned jobs.  ``fused`` turns on
        continuous batching: every slice round co-admits all runnable
        jobs and drives their window dispatches in lockstep through
        one merged call per step (serve/fused.py), rebatching at
        each slice boundary as jobs join/finish/evict."""
        self.rr = rr
        self.resil = Resilience(resil) if resil is not None else None
        base = opts or RouterOpts()
        if self.resil is not None:
            base = replace(base, resil=self.resil)
        self.base_opts = base
        self.router = Router(rr, self.base_opts, device=device)
        if (self.resil is not None and self.resil.plan is not None
                and self.router._library is not None):
            # arm the library.corrupt injection site
            self.router._library.fault_plan = self.resil.plan
        self.slice_iters = int(slice_iters)
        self.verify = verify
        self.runs_dir = runs_dir
        self.scenario = scenario
        self.cfg = dict(cfg or {})
        self.queue = JobQueue()
        self.draining = False
        self.fused = bool(fused)
        self._fused_runner = None      # built lazily (serve/fused.py)
        # rebatch bookkeeping: the co-admitted set of the previous
        # batch round, and the event log the summary/doctor consume
        self._last_batch_ids: Optional[frozenset] = None
        self._rounds = 0
        self.rebatch_events: List[dict] = []
        self._t_init = time.perf_counter()
        self._first_slice_s: Optional[float] = None
        # host-context hook: the daemon/fleet layer injects a callable
        # returning attribution fields (worker id, held leases) that
        # every diagnostic bundle must carry
        self.diag_extra: Optional[Callable[[], dict]] = None
        # flight recorder injected by the daemon layer: a bounded ring
        # of recent lifecycle notes dumped into the diag bundle
        self.flight = None

    # ------------------------------------------------------- admit

    def begin_drain(self) -> None:
        """Drain hook (the daemon's shutdown path): stop taking new
        work, let everything already queued finish.  admit() refuses
        with a counted error from here on; run() is unaffected."""
        self.draining = True
        get_metrics().gauge("route.serve.draining").set(1)

    def admit(self, spec: ServeJobSpec, tenant: str = "default",
              priority: int = 0, deadline_s: Optional[float] = None,
              max_retries: int = 0, job_id: str = "") -> RouteJob:
        if self.draining:
            get_metrics().counter("route.serve.drain_refusals").inc()
            raise RuntimeError(
                f"service is draining: refusing job "
                f"{spec.name or job_id or '?'} (drain hook active)")
        R, _ = spec.term.sinks.shape
        if R and int(spec.term.source.max()) >= self.rr.num_nodes:
            raise ValueError(
                f"job {spec.name or job_id}: terminals reference node "
                f"{int(spec.term.source.max())} outside this service's "
                f"graph (num_nodes={self.rr.num_nodes}) — all jobs "
                f"must target the same device")
        job = RouteJob(tenant=tenant, payload=spec, job_id=job_id,
                       priority=priority, deadline_s=deadline_s,
                       max_retries=max_retries)
        # queue.admit is idempotent on job_id: a replayed submission
        # returns the EXISTING job (restart/recovery path), so pass
        # that back rather than the discarded duplicate
        job = self.queue.admit(job)
        self._publish_pack_plan()
        return job

    def _publish_pack_plan(self):
        """Shared dispatch plan over every queued job (batcher
        telemetry: how the admitted set folds onto one crop ladder).
        Called at admit AND at every rebatch boundary, so the pack
        gauges (lane_occupancy in particular) always reflect the
        CURRENT co-admitted set, not the initial one."""
        pg = self.router.pg
        if pg is None:
            return None
        Lm = pg.max_span
        job_nets = {}
        for job in self.queue.jobs:
            if job.state not in (JobState.QUEUED, JobState.RUNNING):
                continue
            t = job.payload.term
            job_nets[job.job_id] = (
                (t.bb_xmax - t.bb_xmin + 1 + 2 * Lm).astype(np.int64),
                (t.bb_ymax - t.bb_ymin + 1 + 2 * Lm).astype(np.int64))
        if job_nets:
            return pack_jobs(job_nets, pg.shape_x, pg.shape_y)
        return None

    # ------------------------------------------------------ runner

    def _pre_slice(self, job: RouteJob, fused: bool = False):
        """Shared slice prologue for both schedulers: fire the
        backend-loss site, recover the resume checkpoint (in-memory or
        durable), and build the per-job RouterOpts.  Returns
        ``(total, ck, opts)``."""
        spec = job.payload
        total = spec.max_iterations or self.base_opts.max_router_iterations
        rt = self.resil
        if rt is not None and rt.plan is not None:
            # simulated backend loss fires BEFORE any routing work:
            # the attempt dies clean, the queue retries with backoff,
            # and the retry resumes from the durable checkpoint
            rt.plan.raise_if("backend.loss", detail=job.job_id)
        ck = job.checkpoint
        if ck is None and rt is not None and rt.store is not None:
            # fresh process (or a queue retry, which clears the
            # in-memory checkpoint): resume from the newest verifiable
            # durable snapshot — bit-identical, the resume path just
            # replays the remaining deterministic iterations
            ck = rt.store.load(job.job_id)
            if ck is not None:
                tr = get_tracer()
                if tr is not None:
                    tr.instant("route.trace.resume", cat="lifecycle",
                               job_id=job.job_id,
                               it_done=int(getattr(ck, "it_done", 0)))
        # slice via RouterOpts.slice_iterations (cooperative yield at a
        # window boundary), NOT by shrinking max_router_iterations —
        # the iteration budget feeds the router's per-window K clamp,
        # so capping it would change the window partition and with it
        # the QoR.  The yield path leaves window planning untouched:
        # sliced-and-resumed == unsliced, bit for bit.
        kw = dict(max_router_iterations=total,
                  slice_iterations=max(0, self.slice_iters))
        if fused:
            # lockstep merging needs the generator to yield at the
            # fused dispatch site
            kw["fused_dispatch"] = True
        if (rt is not None and self.base_opts.pipeline
                and rt.ladder.level("pipeline") > 0):
            kw["pipeline"] = False   # degraded: the --sync escape hatch
        return total, ck, replace(self.base_opts, **kw)

    def _post_slice(self, job: RouteJob, res, ck, total: int):
        """Shared slice epilogue: turn a RouteResult into the queue
        verdict, managing the durable checkpoint either way."""
        rt = self.resil
        if res.success:
            if rt is not None and rt.store is not None:
                rt.store.drop(job.job_id)
            return "done", self._finish(job, res)
        ck2 = res.checkpoint
        prev_it = ck.it_done if ck is not None else 0
        if (ck2 is not None and ck2.it_done < total
                and ck2.it_done > prev_it):
            # made progress and the budget isn't exhausted: requeue.
            # The durable flush rides the same window-boundary
            # snapshot: a crash between slices resumes from here
            if rt is not None and rt.store is not None:
                rt.store.save(job.job_id, ck2)
            return "preempted", ck2
        return "failed", f"unroutable within {total} iterations"

    def _note_first_slice(self) -> None:
        if self._first_slice_s is None:
            self._first_slice_s = time.perf_counter() - self._t_init
            get_metrics().gauge("route.serve.warm_start_s").set(
                round(self._first_slice_s, 3))

    def _runner(self, job: RouteJob):
        total, ck, opts = self._pre_slice(job)
        rt = self.resil
        self.router.opts = opts
        t0 = time.perf_counter()
        try:
            res = self.router.route(job.payload.term,
                                    crit=job.payload.crit, resume=ck)
        except DispatchPoisonedError as e:
            # every rung of some dispatch chain is exhausted: step the
            # global ladder so the retry runs one level down, then let
            # the queue count the failed attempt (and bury the job
            # into FAILED + diagnostic bundle once retries run out)
            if rt is not None:
                rt.ladder.step("pipeline", reason=str(e))
            raise
        dt = time.perf_counter() - t0
        self._note_first_slice()
        job.scratch["route_s"] = job.scratch.get("route_s", 0.0) + dt
        return self._post_slice(job, res, ck, total)

    # ---------------------------------------------- fused batch runner

    def _note_rebatch(self, jobs: List[RouteJob]) -> None:
        """Record the rebatch boundary when the co-admitted set
        changed: machine-readable causes, ``route.serve.rebatch.*``
        counters, a lifecycle trace instant, and refreshed pack gauges
        so lane occupancy is live."""
        from .batcher import diff_packs
        cur = frozenset(j.job_id for j in jobs)
        prev = self._last_batch_ids
        self._rounds += 1
        if prev is not None and cur == prev:
            return
        self._last_batch_ids = cur

        def is_done(jid):
            j = self.queue.get(jid)
            return j is not None and j.state is JobState.DONE

        def is_failover(jid):
            j = self.queue.get(jid)
            return j is not None and bool(j.scratch.get("failover"))

        causes = diff_packs(prev, cur, is_done=is_done,
                            is_failover=is_failover)
        m = get_metrics()
        m.counter("route.serve.rebatch.events").inc()
        for c in causes:
            # one counter per cause, named by the cause verbatim:
            # route.serve.rebatch.{join,finish,evict,failover}
            m.counter(f"route.serve.rebatch.{c['cause']}").inc()
        plan = self._publish_pack_plan()   # live pack gauges
        event = dict(
            round=self._rounds, jobs=sorted(cur), causes=causes,
            lane_occupancy=(plan.lane_occupancy
                            if plan is not None else None),
            pack_signature=(repr(plan.signature())
                            if plan is not None else None))
        self.rebatch_events.append(event)
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.trace.rebatch", cat="lifecycle",
                       jobs=len(cur),
                       causes=",".join(f"{c['job_id']}:{c['cause']}"
                                       for c in causes))

    def _batch_runner(self, jobs: List[RouteJob]) -> Dict[str, Any]:
        """Queue batch runner: one fused lockstep slice over the whole
        co-admitted set.  Per-job prologue/epilogue are the same
        _pre_slice/_post_slice the solo runner uses — checkpoints stay
        strictly per job, so SIGKILL/failover resume is unchanged."""
        from .fused import FusedSliceRunner, SliceEntry
        if self._fused_runner is None:
            self._fused_runner = FusedSliceRunner(self.router,
                                                  resil=self.resil)
        self._note_rebatch(jobs)
        rt = self.resil
        verdicts: Dict[str, Any] = {}
        entries: List[SliceEntry] = []
        meta: Dict[str, tuple] = {}
        for job in jobs:
            try:
                total, ck, opts = self._pre_slice(job, fused=True)
            except Exception as e:   # e.g. injected backend loss
                verdicts[job.job_id] = (
                    "failed", f"{type(e).__name__}: {e}")
                continue
            # the generator body runs lazily at first next(); the
            # runner asserts this job's opts/prefix before every
            # advance, so construction order here is immaterial
            gen = self.router.route_gen(job.payload.term,
                                        crit=job.payload.crit,
                                        resume=ck)
            entries.append(SliceEntry(
                job, gen, opts, job.job_id + ":",
                prev_it=(ck.it_done if ck is not None else 0)))
            meta[job.job_id] = (total, ck)
        t0 = time.perf_counter()
        if entries:
            self._fused_runner.run_slice(entries)
        wall = time.perf_counter() - t0
        self._note_first_slice()
        # lockstep wall is a joint cost: attribute evenly.  Aggregate
        # nets/s (the number the A/B benchmark reads) uses the true
        # run() wall, so the attribution policy only shapes per-job
        # route_s reporting.
        share = wall / max(1, len(entries))
        for e in entries:
            job = e.job
            job.scratch["route_s"] = (
                job.scratch.get("route_s", 0.0) + share)
            total, ck = meta[job.job_id]
            if e.error is not None:
                if isinstance(e.error, DispatchPoisonedError) \
                        and rt is not None:
                    rt.ladder.step("pipeline", reason=str(e.error))
                verdicts[job.job_id] = (
                    "failed",
                    f"{type(e.error).__name__}: {e.error}")
            else:
                verdicts[job.job_id] = self._post_slice(
                    job, e.result, ck, total)
        return verdicts

    def rebatch_summary(self) -> dict:
        """Continuous-batching section of the serve summary: batch
        rounds, the rebatch event log (causes per boundary), and the
        fused/rebatch counters — what flow_doctor's rebatch rules
        validate."""
        m = get_metrics()
        return {
            "fused": self.fused,
            "rounds": self._rounds,
            "events": list(self.rebatch_events),
            "counters": {**m.values("route.serve.rebatch."),
                         **m.values("route.serve.fused.")},
        }

    def _finish(self, job: RouteJob, res) -> dict:
        spec = job.payload
        term = spec.term
        if self.verify:
            from ..route.check import check_route
            check_route(self.rr, term, res.paths, occ=res.occ)
        R = len(term.source)
        wall = job.scratch.get("route_s", 0.0)
        nets_per_s = R / max(wall, 1e-9)
        m = get_metrics()
        t = job.tenant
        m.counter(f"route.serve.tenant.{t}.jobs_done").inc()
        m.set_gauges({
            f"route.serve.tenant.{t}.nets_per_s": round(nets_per_s, 3),
            f"route.serve.tenant.{t}.wirelength": res.wirelength,
            f"route.serve.tenant.{t}.iterations": res.iterations,
        })
        summary = dict(
            job_id=job.job_id, tenant=t, name=spec.name,
            success=res.success, wirelength=res.wirelength,
            iterations=res.iterations, nets=R,
            route_s=round(wall, 4), nets_per_s=round(nets_per_s, 3),
            preemptions=job.preemptions, slices=job.slices,
            result=res)
        if self.runs_dir:
            self._corpus_row(job, res, nets_per_s)
        return summary

    def _corpus_row(self, job: RouteJob, res, nets_per_s: float):
        from ..obs.runstore import append_run, make_record, run_path
        spec = job.payload
        dev = self.router.device
        # the JAX package's backend and device-kind names
        backend = "gpu" if dev.type == "cuda" else dev.type
        if dev.type == "cuda":
            import torch

            kind = torch.cuda.get_device_name(dev)
        else:
            kind = dev.type
        rt = self.resil
        if rt is not None and rt.plan is not None:
            f = rt.plan.fire("corpus.torn", detail=job.job_id)
            if f is not None:
                # inject a corrupt line (invalid UTF-8, invalid JSON)
                # ahead of the real append: the tolerant reader must
                # skip it with a counted warning, and flow_doctor
                # --corpus must stay green
                path = run_path(self.runs_dir, self.scenario)
                os.makedirs(self.runs_dir, exist_ok=True)
                fd = os.open(path,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND)
                try:
                    os.write(fd, b'\x80\xfe{"torn": tr\n')
                finally:
                    os.close(fd)
        # optional latency columns (runstore SCHEMA v2): the daemon
        # injects a provider via job.scratch; absent means unknown —
        # a plain serve() run writes the same row shape as ever
        slo_fields = job.scratch.get("slo_fields")
        if callable(slo_fields):
            try:
                slo_fields = slo_fields()
            except Exception:
                # a latency stamp must never block the corpus append;
                # the row is written without the optional columns
                get_metrics().counter(
                    "route.serve.slo_stamp_errors").inc()
                slo_fields = None
        if not isinstance(slo_fields, dict):
            slo_fields = {}
        rec = make_record(
            scenario=self.scenario,
            cfg={**self.cfg, "job": spec.name, "tenant": job.tenant},
            metric="nets_per_s", value=nets_per_s, unit="nets/s",
            backend=backend, device_kind=kind,
            qor=dict(wirelength=int(res.wirelength),
                     iterations=int(res.iterations),
                     success=bool(res.success)),
            gauges={**get_metrics().values("route.serve."),
                    **get_metrics().values("route.resil.")},
            detail=dict(preemptions=job.preemptions,
                        slices=job.slices, **spec.detail),
            tenant=job.tenant, job_id=job.job_id,
            queue_wait_s=slo_fields.get("queue_wait_s"),
            e2e_s=slo_fields.get("e2e_s"),
            n_failovers=slo_fields.get("n_failovers"))
        append_run(self.runs_dir, rec)

    # --------------------------------------------------------- run

    def run(self) -> List[RouteJob]:
        """Drain the queue; returns all jobs with terminal states.
        Fused mode drains through the batched scheduler (continuous
        batching); otherwise one job at a time."""
        t0 = time.perf_counter()
        if self.fused:
            jobs = self.queue.run_batch(self._batch_runner)
        else:
            jobs = self.queue.run(self._runner)
        wall = time.perf_counter() - t0
        done = [j for j in jobs if j.state == JobState.DONE]
        nets = sum(len(j.payload.term.source) for j in done)
        get_metrics().gauge("route.serve.aggregate_nets_per_s").set(
            round(nets / max(wall, 1e-9), 3))
        if self.resil is not None:
            for j in jobs:
                if j.state in (JobState.FAILED, JobState.TIMEOUT):
                    self._diag_bundle(j)
        return jobs

    def _diag_bundle(self, job: RouteJob) -> Optional[str]:
        """Export a diagnostic bundle for a terminally-failed job: the
        failure reason, attempt/quarantine/ladder state, fault log and
        checkpoint provenance, as one JSON file — the poison job's
        post-mortem, instead of a wedged queue and a stack trace."""
        rt = self.resil
        diag_dir = rt.opts.diag_dir or rt.opts.checkpoint_dir
        if diag_dir is None:
            return None
        os.makedirs(diag_dir, exist_ok=True)
        ck_meta = None
        if rt.store is not None:
            p = rt.store._path(job.job_id)
            if os.path.exists(p):
                ck_meta = {"file": p, "bytes": os.path.getsize(p)}
        bundle = {
            "job_id": job.job_id,
            "tenant": job.tenant,
            "state": job.state.value,
            "failure_reason": job.failure_reason,
            "attempts": job.attempts,
            "preemptions": job.preemptions,
            "slices": job.slices,
            "quarantine": {repr(k): sorted(v) for k, v in
                           rt.guard._quarantine.items()},
            "ladder": rt.ladder.snapshot(),
            "faults": rt.plan.summary() if rt.plan is not None else None,
            "checkpoint": ck_meta,
            "resil_metrics": get_metrics().values("route.resil."),
            # the flight recorder's recent history: what the worker was
            # doing in the cycles leading up to this burial
            "flight_recorder": (self.flight.snapshot()
                                if self.flight is not None else None),
        }
        if callable(self.diag_extra):
            # fleet attribution: which worker buried this job, holding
            # which leases — without it a fleet post-mortem is
            # anonymous
            bundle.update(self.diag_extra())
        path = os.path.join(diag_dir, f"{job.job_id}.diag.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        os.replace(tmp, path)
        get_metrics().counter("route.resil.diag_bundles").inc()
        return path
