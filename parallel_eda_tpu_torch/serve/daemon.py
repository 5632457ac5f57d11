"""Long-lived route daemon: durable inbox, admission control, overload
shedding, crash-restart recovery (the counterpart of
parallel_eda_tpu/serve/daemon.py: its inbox layout, its journal, its
``route.daemon.*`` metrics and its summary keys, so that either
package's daemon can recover the other's inbox).

This module is the process-lifetime robustness layer above the
per-dispatch one (resil/): a single-process daemon that

* watches a **durable file inbox** — submitters append one JSON line
  per job to ``<inbox>/submit.jsonl`` (a single ``O_APPEND`` write,
  atomic per POSIX) pointing at an atomically-written per-job spec
  file under ``<inbox>/specs/``.  The consumer is torn-line-tolerant
  under the same reader contract as ``obs/runstore.read_runs_ex``: a
  crash can only tear the *trailing* line, which is skipped with a
  counted warning once it is provably abandoned;
* runs every submission through an explicit **admission controller**:
  capacity is estimated from the program library (warm vs cold start)
  and the recent per-tenant nets/s trajectory in the run corpus, and a job the daemon cannot finish inside its horizon (or
  its own deadline) is REJECTED with a machine-readable reason —
  never silently queued forever;
* **sheds load** under overload: when the backlog outruns the
  overload horizon, the newest/lowest-aged-priority queued jobs are
  evicted with an explicit overload cause, with per-tenant fair-share
  caps ranked first so one tenant cannot starve the heap;
* and **recovers from its own death**: a journal of accepted and
  in-flight job states (``resil/journal.py``, atomic tmp+fsync+rename)
  lets a restarted daemon re-admit every in-flight job idempotently
  (dedupe on job_id) and resume it from its durable route checkpoint
  (``resil/checkpoint.py``) — a SIGKILL between windows changes
  timing only, never QoR.

Liveness is a heartbeat file next to the inbox; health is
``tools/flow_doctor.py --daemon-summary`` over the summary JSON the
daemon prints on exit (rejection-without-reason, shed-without-overload-cause,
heartbeat gaps, recovery-without-journal all fail the gate).

Inbox layout::

    <inbox>/submit.jsonl        appended submissions (O_APPEND lines)
    <inbox>/specs/<job>.json    per-job spec files (atomic writes)
    <inbox>/rejected.jsonl      machine-readable rejections + sheds
    <inbox>/heartbeat.json      liveness (atomic rewrite per beat)
    <inbox>/journal/            job-state journal (+ .prev generation)
    <inbox>/ckpt/               durable route checkpoints
    <inbox>/DRAIN               touch to drain: finish queued work,
                                reject new submissions, exit

The daemon's Router runs on ``build_daemon``'s ``device`` (the card by
default).  Its first slice on a cold process builds the CUDA libraries
with nvcc, which stalls the loop for as long as the build runs — the
heartbeat's ``max_gap_s`` shows it, as JAX's shows its first compile;
``--compile_cache_dir`` and ``--library`` take the build out of a warm
restart.  Fleet membership (``worker``, leases, failover) is here;
the supervisor that spawns several workers is serve/fleet.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.metrics import get_metrics
from ..obs.slo import (CapacityForecaster, SLOPlane, load_objectives,
                       slo_name)
from ..obs.trace import FlightRecorder, compile_seconds, get_tracer
from ..route.router import RouterOpts
from .queue import JobState, RouteJob
from .service import RouteService, ServeJobSpec

SUBMIT_NAME = "submit.jsonl"
SPEC_DIR = "specs"
REJECT_NAME = "rejected.jsonl"
HEARTBEAT_NAME = "heartbeat.json"
TELEMETRY_NAME = "telemetry.json"
DRAIN_NAME = "DRAIN"
LEASE_DIR = "leases"
CKPT_DIR = "ckpt"                  # durable checkpoints, shared by a fleet

#: journal states that survive a restart as live work
_IN_FLIGHT = "in_flight"


def heartbeat_name(worker: str = "") -> str:
    """Solo daemons keep the historical ``heartbeat.json``; fleet
    workers each beat their own ``heartbeat.<worker>.json`` so peers
    (and the supervisor) can age every member independently."""
    return f"heartbeat.{worker}.json" if worker else HEARTBEAT_NAME


def telemetry_name(worker: str = "") -> str:
    """The worker's live telemetry snapshot next to its heartbeat:
    rewritten atomically at slice boundaries, read by ``GET /metrics``
    on the transport, ``daemon status --live`` and the fleet summary —
    pure host memory, so a scrape never forces a device sync."""
    return f"telemetry.{worker}.json" if worker else TELEMETRY_NAME


def preferred_worker(job_id: str, workers: List[str]) -> str:
    """Stable job->worker assignment: every fleet member computes the
    same answer from the sorted roster, so exactly one worker claims a
    fresh submission and the rest hold it as takeover backup."""
    roster = sorted(workers)
    h = int.from_bytes(
        hashlib.sha256(job_id.encode("utf-8")).digest()[:8], "big")
    return roster[h % len(roster)]


@dataclass
class DaemonOpts:
    """Daemon pacing + admission/overload policy knobs."""

    poll_s: float = 0.2            # inbox poll period when idle
    heartbeat_s: float = 1.0       # liveness beat period
    slices_per_cycle: int = 4      # queue slices run between polls
    fused: bool = False            # continuous batching: each slice
    #                                round co-admits every runnable job
    #                                into one lockstep fused dispatch
    admit_horizon_s: float = 600.0  # reject if est. completion exceeds
    overload_factor: float = 2.0   # shed when backlog_s > factor*horizon
    max_queue_depth: int = 64      # hard cap on queued jobs
    fair_share_frac: float = 0.5   # one tenant's max share of the queue
    fair_share_floor: int = 2      # ...but never fewer slots than this
    default_nets_per_s: float = 10.0   # capacity prior with no history
    cold_start_factor: float = 0.25    # rate penalty w/o program library
    aging_rate: float = 0.05       # queue priority points per second
    exit_when_idle: int = 0        # idle cycles before exit (0 = never)
    torn_grace_polls: int = 2      # polls before a torn tail is skipped
    capacity_k: int = 8            # corpus rows in the capacity median
    # ---- fleet membership (empty worker = historical solo daemon)
    worker: str = ""               # this worker's fleet id
    workers: Tuple[str, ...] = ()  # full roster (all members agree)
    lease_ttl_s: float = 10.0      # job-lease expiry on the mono clock
    foreign_grace_s: float = 3.0   # wait before claiming an unleased
    #                                job assigned to a silent peer
    # ---- observability plane
    trace_path: str = ""           # per-cycle trace shard export
    #                                (empty = no shard; the tracer
    #                                itself is installed by the CLI)
    flight_capacity: int = 256     # flight-recorder ring depth
    # ---- SLO plane (obs/slo.py)
    objectives_path: str = ""      # per-tenant objectives JSON (the
    #                                traffic_gen --objectives fixture)
    slo_window: int = 512          # error-budget rolling window (jobs)
    slo_horizon_s: float = 60.0    # capacity forecaster drain target
    slo_max_workers: int = 64      # recommended_workers cap


def submit_job(inbox_dir: str, spec: dict, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               job_id: str = "", ts: Optional[float] = None,
               trace: Optional[dict] = None) -> str:
    """Client half of the inbox protocol: atomically install the spec
    file, then publish the submission as ONE ``O_APPEND`` write — the
    same torn-only-ever-at-the-tail durability argument as
    ``obs/runstore.append_run``.  Returns the job id."""
    os.makedirs(os.path.join(inbox_dir, SPEC_DIR), exist_ok=True)
    if not job_id:
        job_id = f"{tenant}-{spec.get('name') or spec.get('seed', 0)}"
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in job_id)
    spec_rel = os.path.join(SPEC_DIR, f"{safe}.json")
    spec_path = os.path.join(inbox_dir, spec_rel)
    tmp = spec_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(spec, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, spec_path)
    line = {"job_id": safe, "tenant": tenant, "priority": int(priority),
            "spec": spec_rel, "ts": time.time() if ts is None else ts}
    if ts is None:
        # trace-context stamp: a monotonic twin of the wall stamp, so a
        # same-host consumer can measure inbox lag immune to NTP steps
        # (replayed/explicit-ts lines stay wall-only — their mono origin
        # is another boot's)
        line["mono"] = time.monotonic()
    if deadline_s:
        line["deadline_s"] = float(deadline_s)
    if trace:
        # upstream trace context (e.g. the transport client's own
        # submission instant) rides the line job_id-keyed, so the
        # consumer's lifecycle instants can name the true origin
        line["trace"] = dict(trace)
    data = (json.dumps(line, sort_keys=True) + "\n").encode("utf-8")
    fd = os.open(os.path.join(inbox_dir, SUBMIT_NAME),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return safe


class InboxReader:
    """Incremental torn-line-tolerant consumer of ``submit.jsonl``.

    Complete lines are parsed (invalid ones skipped with a counted
    warning, the ``read_runs_ex`` contract); an incomplete trailing
    line is left unconsumed — the submitter may still be mid-write —
    until it survives ``grace`` polls unchanged, at which point it is
    provably abandoned (a crashed submitter) and skipped as torn."""

    def __init__(self, path: str, grace: int = 2):
        self.path = path
        self.offset = 0
        self.grace = max(1, int(grace))
        self.torn = 0
        self._tail = b""
        self._tail_polls = 0

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:
            # the inbox file was truncated/replaced out from under us:
            # start over (dedupe upstream makes re-reads idempotent)
            self.offset = 0
            self._tail, self._tail_polls = b"", 0
        if size == self.offset and not self._tail:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read()
        nl = data.rfind(b"\n")
        complete, rest = (data[:nl + 1], data[nl + 1:]) if nl >= 0 \
            else (b"", data)
        self.offset += len(complete)
        out: List[dict] = []
        for raw in complete.split(b"\n"):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
                if not isinstance(rec, dict):
                    raise ValueError("submission is not an object")
            except (ValueError, UnicodeDecodeError):
                self.torn += 1
                get_metrics().counter(
                    "route.daemon.inbox_torn_lines").inc()
                continue
            out.append(rec)
        if rest:
            if rest == self._tail:
                self._tail_polls += 1
                if self._tail_polls >= self.grace:
                    # unchanged across grace polls: abandoned torn tail
                    self.offset += len(rest)
                    self._tail, self._tail_polls = b"", 0
                    self.torn += 1
                    get_metrics().counter(
                        "route.daemon.inbox_torn_lines").inc()
            else:
                self._tail, self._tail_polls = rest, 0
        else:
            self._tail, self._tail_polls = b"", 0
        return out


class AdmissionController:
    """Explicit admit/reject decisions against a capacity estimate.

    The estimate triangulates what the daemon can actually sustain:
    the median of recent per-tenant (falling back to all-tenant)
    nets/s rows in the run corpus, discounted by ``cold_start_factor``
    when no program library is warm — a cold daemon pays its library
    builds on its first windows, and admission must not promise
    warm-start throughput it cannot deliver.  The rates are the
    corpus's own (the port's rows are the port's measured speed, not
    JAX's).  Over-capacity work is
    REJECTED with a machine-readable reason instead of queued forever.
    """

    def __init__(self, opts: DaemonOpts,
                 runs_dir: Optional[str] = None,
                 scenario: Optional[str] = None,
                 library_warm: bool = False):
        self.opts = opts
        self.runs_dir = runs_dir
        self.scenario = scenario
        self.library_warm = library_warm

    def _corpus_rates(self, tenant: Optional[str]) -> List[float]:
        if not (self.runs_dir and self.scenario):
            return []
        try:
            from ..obs.runstore import read_runs_ex
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                records, _ = read_runs_ex(self.runs_dir, self.scenario)
        except (OSError, ValueError):
            return []
        rows = [r for r in records if r.get("metric") == "nets_per_s"]
        mine = [r for r in rows if tenant and r.get("tenant") == tenant]
        pick = mine or rows
        return [float(r["value"]) for r in pick[-self.opts.capacity_k:]
                if isinstance(r.get("value"), (int, float))]

    def capacity_nets_per_s(self, tenant: Optional[str] = None) -> float:
        rates = self._corpus_rates(tenant)
        if rates:
            rate = statistics.median(rates)
        else:
            rate = self.opts.default_nets_per_s
            if not self.library_warm:
                rate *= self.opts.cold_start_factor
        rate = max(rate, 1e-6)
        get_metrics().gauge("route.daemon.capacity_nets_per_s").set(
            round(rate, 3))
        return rate

    def decide(self, *, nets: int, tenant: str,
               deadline_s: Optional[float], backlog_nets: int,
               queue_depth: int, tenant_depth: int,
               draining: bool = False) -> Optional[dict]:
        """None = admit; otherwise a terminal machine-readable
        rejection: {"code", "detail", ...numbers the code refers to}.
        """
        if draining:
            return {"code": "draining",
                    "detail": "daemon is draining; resubmit to the "
                              "next instance"}
        if queue_depth >= self.opts.max_queue_depth:
            return {"code": "queue_full",
                    "detail": f"queue depth {queue_depth} at the "
                              f"max_queue_depth cap",
                    "queue_depth": queue_depth,
                    "max_queue_depth": self.opts.max_queue_depth}
        share = max(self.opts.fair_share_floor,
                    int(self.opts.fair_share_frac
                        * max(queue_depth + 1,
                              self.opts.fair_share_floor * 2)))
        if tenant_depth >= share:
            return {"code": "tenant_over_fair_share",
                    "detail": f"tenant {tenant} holds {tenant_depth} "
                              f"of {queue_depth} queued jobs "
                              f"(share cap {share})",
                    "tenant_depth": tenant_depth, "share_cap": share}
        rate = self.capacity_nets_per_s(tenant)
        est_s = (backlog_nets + nets) / rate
        horizon = self.opts.admit_horizon_s
        if deadline_s is not None and est_s > deadline_s:
            return {"code": "over_capacity",
                    "detail": f"estimated completion {est_s:.1f}s "
                              f"(backlog {backlog_nets} + {nets} nets "
                              f"at {rate:.2f} nets/s) exceeds the "
                              f"job deadline {deadline_s}s",
                    "est_s": round(est_s, 2),
                    "deadline_s": deadline_s,
                    "rate_nets_per_s": round(rate, 3)}
        if est_s > horizon:
            return {"code": "over_capacity",
                    "detail": f"estimated completion {est_s:.1f}s "
                              f"exceeds the admission horizon "
                              f"{horizon}s",
                    "est_s": round(est_s, 2), "horizon_s": horizon,
                    "rate_nets_per_s": round(rate, 3)}
        return None


class RouteDaemon:
    """The long-lived front end: one RouteService, one inbox, one
    journal; cycles of beat → poll/admit → shed → run slices → flush.

    ``flow_builder(spec) -> object with .term`` turns an admitted spec
    file into routable terminals (default: ``flow.synth_flow`` on the
    daemon's own grid); tests inject fakes.  All clocks are
    injectable; the monotonic ``clock`` paces scheduling, ``wall``
    stamps artifacts other processes read."""

    def __init__(self, service: RouteService, inbox_dir: str,
                 opts: Optional[DaemonOpts] = None, *,
                 grid_cfg: Optional[dict] = None,
                 flow_builder: Optional[Callable[[dict], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep):
        from ..resil.journal import Heartbeat, JournalStore, LeaseStore

        self.service = service
        self.inbox_dir = inbox_dir
        self.opts = opts or DaemonOpts()
        self.grid_cfg = dict(grid_cfg or {})
        self.flow_builder = flow_builder or self._default_flow_builder
        self._clock = clock
        self._wall = wall
        self._sleep = sleep
        os.makedirs(os.path.join(inbox_dir, SPEC_DIR), exist_ok=True)
        self.reader = InboxReader(
            os.path.join(inbox_dir, SUBMIT_NAME),
            grace=self.opts.torn_grace_polls)
        self.worker = self.opts.worker
        # a fleet member keeps its OWN journal generation (two workers
        # sharing one journal.json would clobber each other's truth)
        # and its own heartbeat; leases are the only shared ownership
        # state, and they are single-writer by construction
        journal_dir = os.path.join(inbox_dir, "journal", self.worker) \
            if self.worker else os.path.join(inbox_dir, "journal")
        self.journal = JournalStore(journal_dir)
        self.heartbeat = Heartbeat(
            os.path.join(inbox_dir, heartbeat_name(self.worker)),
            interval_s=self.opts.heartbeat_s, clock=clock, wall=wall)
        self.lease: Optional[LeaseStore] = None
        if self.worker:
            self.lease = LeaseStore(
                os.path.join(inbox_dir, LEASE_DIR), self.worker,
                ttl_s=self.opts.lease_ttl_s, clock=clock, wall=wall)
            # fleet post-mortems must say WHO failed holding WHAT
            service.diag_extra = lambda: {
                "worker": self.worker,
                "held_leases": self.lease.held()}
        # foreign submissions (another worker's assignment) kept as
        # takeover backup: job_id -> (first-seen clock, submission)
        self._foreign: Dict[str, Tuple[float, dict]] = {}
        self.failed_over_ids: List[str] = []
        lib = getattr(self.service.router, "_library", None)
        self.admission = AdmissionController(
            self.opts, runs_dir=service.runs_dir,
            scenario=service.scenario,
            library_warm=bool(lib is not None and lib.keys()))
        self.service.queue.aging_rate = self.opts.aging_rate
        # terminal submissions the queue never saw (rejected) or
        # dropped (shed causes), keyed by job_id, for summary/journal
        self.rejected: Dict[str, dict] = {}
        self.shed_causes: Dict[str, dict] = {}
        self.recovered_ids: List[str] = []
        self._subs: Dict[str, dict] = {}   # job_id -> submission line
        # flight recorder: always on for a daemon (the black box the
        # diag bundle dumps), regardless of whether a trace sink is
        # configured — the tracer's null fast path is a separate knob
        self.recorder = FlightRecorder(
            capacity=self.opts.flight_capacity, clock=clock, wall=wall)
        service.flight = self.recorder
        self._telemetry_path = os.path.join(
            inbox_dir, telemetry_name(self.worker))
        # SLO plane: waterfalls + digests + error budgets, fed from
        # THIS daemon's injectable clock only, published at the same
        # slice-boundary snapshot sites as the telemetry document
        self.slo = SLOPlane(
            objectives=load_objectives(self.opts.objectives_path),
            window=self.opts.slo_window)
        self.forecaster = CapacityForecaster(
            horizon_s=self.opts.slo_horizon_s,
            max_workers=self.opts.slo_max_workers)
        self._slo_path = os.path.join(
            inbox_dir, slo_name(self.worker))
        self.last_verdicts: List[dict] = []   # bounded, newest last
        self._last_slice: Optional[dict] = None
        self._terminal_seen: set = set()
        self._metric_last: Dict[str, float] = {}
        self._t0 = clock()
        self.cycles = 0
        self._idle_cycles = 0
        self._stop = False

    # ----------------------------------------------- spec handling

    def _default_flow_builder(self, spec: dict):
        from ..flow import synth_flow
        flow = synth_flow(num_luts=int(spec["luts"]),
                          chan_width=int(spec.get("chan_width", 16)),
                          seed=int(spec.get("seed", 1)))
        frac = float(spec.get("net_frac", 1.0) or 1.0)
        if 0.0 < frac < 1.0:
            # tiny job on the shared device graph: route a seeded
            # subset of the circuit's nets (traffic_gen small-heavy
            # profile); the subset is fixed by the spec, so replays
            # and failover re-admissions route the same nets
            from ..rr.terminals import subset_terminals
            flow.term = subset_terminals(
                flow.term, frac,
                seed=int(spec.get("net_seed", spec.get("seed", 1))))
        return flow

    def _load_spec(self, rel: str) -> dict:
        path = os.path.join(self.inbox_dir, rel)
        with open(path) as f:
            spec = json.load(f)
        if not isinstance(spec, dict):
            raise ValueError(f"spec {rel} is not an object")
        for key in ("luts", "chan_width"):
            want = self.grid_cfg.get(key)
            if want is not None and key in spec \
                    and int(spec[key]) != int(want):
                raise ValueError(
                    f"grid_mismatch: spec {key}={spec[key]} but this "
                    f"daemon serves {key}={want} (one device graph "
                    f"per daemon)")
        return spec

    # ------------------------------------------------- admission

    def _known(self, job_id: str) -> bool:
        return (self.service.queue.get(job_id) is not None
                or job_id in self.rejected)

    def _backlog_nets(self) -> int:
        total = 0
        for j in self.service.queue.queued_jobs():
            term = getattr(j.payload, "term", None)
            total += len(term.source) if term is not None \
                else int(j.scratch.get("nets", 0))
        return total

    def _reject(self, job_id: str, tenant: str, reason: dict) -> None:
        rec = {"job_id": job_id, "tenant": tenant, "state": "rejected",
               "reason": reason, "ts": self._wall()}
        if self.worker:
            rec["worker"] = self.worker
        self.rejected[job_id] = rec
        get_metrics().counter("route.daemon.rejected").inc()
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.trace.reject", cat="lifecycle",
                       job_id=job_id, code=str(reason.get("code")))
        self.recorder.note("reject", job_id=job_id,
                           code=str(reason.get("code")))
        self._append_reject_line(rec)
        if self.lease is not None:
            # terminal release: a rejected job must not look like a
            # dead peer's work a fleet member should take over
            self.lease.release(job_id, state="rejected")

    def _append_reject_line(self, rec: dict) -> None:
        """One O_APPEND write: the submitter-visible terminal answer
        for work the daemon refused or dropped, attributed to the
        fleet member that decided it."""
        if self.worker:
            rec = {**rec, "worker": self.worker}
        data = (json.dumps(rec, sort_keys=True, default=str)
                + "\n").encode("utf-8")
        fd = os.open(os.path.join(self.inbox_dir, REJECT_NAME),
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)

    def _fleet_claim(self, job_id: str) -> str:
        """Fleet ownership decision for one submission:

        * ``"run"`` — we hold (or just acquired/renewed) the lease;
        * ``"failover"`` — we STOLE an expired peer lease: admit
          unchecked and resume from the shared durable checkpoint;
        * ``"defer"`` — a live peer owns it, or it is a peer's
          assignment still inside its claim window; park it;
        * ``"skip"`` — released terminal record: finished fleet-wide.
        """
        ls = self.lease
        doc = ls.read(job_id)
        if doc is not None:
            if doc.get("released"):
                return "skip"
            if doc.get("worker") == self.worker:
                ls.renew(job_id)
                return "run"
            if ls.expired(doc) and ls.steal(job_id):
                return "failover"
            return "defer"
        roster = list(self.opts.workers) or [self.worker]
        if preferred_worker(job_id, roster) != self.worker:
            return "defer"
        return "run" if ls.acquire(job_id) else "defer"

    def _check_foreign(self) -> None:
        """Takeover scan over parked peer-assigned submissions: a
        released lease drops the parking, an expired one (dead peer)
        is stolen via the normal claim path, and a job its assigned
        worker never leased at all is taken over once the grace
        elapses — no admitted submission can be orphaned by a worker
        that died before claiming it."""
        if self.lease is None or not self._foreign:
            return
        now = self._clock()
        for job_id in sorted(self._foreign):
            first, sub = self._foreign[job_id]
            doc = self.lease.read(job_id)
            if doc is None:
                if now - first >= self.opts.foreign_grace_s \
                        and self.lease.acquire(job_id):
                    del self._foreign[job_id]
                    self._admit_submission(sub)
                continue
            if doc.get("released"):
                del self._foreign[job_id]
                continue
            if doc.get("worker") == self.worker \
                    or self.lease.expired(doc):
                del self._foreign[job_id]
                self._admit_submission(sub)

    def _admit_submission(self, sub: dict, *,
                          recovery: bool = False) -> None:
        job_id = str(sub.get("job_id") or "")
        tenant = str(sub.get("tenant") or "default")
        if not job_id:
            get_metrics().counter(
                "route.daemon.inbox_torn_lines").inc()
            return
        if self._known(job_id):
            get_metrics().counter("route.serve.jobs_deduped").inc()
            return
        failover = False
        if self.lease is not None:
            claim = self._fleet_claim(job_id)
            if claim == "defer":
                self._foreign.setdefault(
                    job_id, (self._clock(), dict(sub)))
                return
            if claim == "skip":
                get_metrics().counter("route.serve.jobs_deduped").inc()
                self._foreign.pop(job_id, None)
                return
            self._foreign.pop(job_id, None)
            if claim == "failover":
                # an expired peer lease was stolen: this is recovery
                # of a peer's in-flight work, not a fresh admission —
                # bypass admission control and resume from the shared
                # durable checkpoint (bit-identical by construction)
                failover = True
                recovery = True
        # inbox lag: prefer the submission's monotonic twin (immune to
        # NTP steps — the same fix Heartbeat.read got), flag the source
        # so a wall-only estimate is never mistaken for a mono one
        ts, mono = sub.get("ts"), sub.get("mono")
        lag = lag_src = None
        if isinstance(mono, (int, float)):
            age = time.monotonic() - mono
            if age >= 0.0:   # a negative age means another boot's clock
                lag, lag_src = age, "mono"
        if lag is None and isinstance(ts, (int, float)):
            lag, lag_src = self._wall() - ts, "wall"
        if lag is not None:
            m = get_metrics()
            m.gauge("route.daemon.inbox_lag_s").set(
                round(max(0.0, lag), 3))
            m.gauge("route.daemon.inbox_lag_src").set(lag_src)
        trace_ctx = sub.get("trace")
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.trace.submit", cat="lifecycle",
                       job_id=job_id, tenant=tenant,
                       lag_s=None if lag is None else round(lag, 6),
                       age_src=lag_src,
                       submit_wall=(trace_ctx.get("submit_wall")
                                    if isinstance(trace_ctx, dict)
                                    else None))
        try:
            spec = self._load_spec(str(sub.get("spec")))
            flow = self.flow_builder(spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            code = "grid_mismatch" if "grid_mismatch" in str(e) \
                else "bad_spec"
            self._reject(job_id, tenant, {
                "code": code,
                "detail": f"{type(e).__name__}: {e}"})
            return
        nets = len(flow.term.source)
        deadline_s = sub.get("deadline_s")
        if not recovery:
            # recovery re-admits journaled in-flight work unchecked:
            # it was admitted once already, and dropping it now would
            # turn a restart into data loss
            verdict = self.admission.decide(
                nets=nets, tenant=tenant,
                deadline_s=deadline_s,
                backlog_nets=self._backlog_nets(),
                queue_depth=self.service.queue.depth(),
                tenant_depth=sum(
                    1 for j in self.service.queue.queued_jobs()
                    if j.tenant == tenant),
                draining=self.service.draining)
            if verdict is not None:
                self._reject(job_id, tenant, verdict)
                return
        try:
            job = self.service.admit(
                ServeJobSpec(term=flow.term,
                             name=str(spec.get("name") or job_id),
                             max_iterations=int(
                                 spec.get("max_iterations", 0))),
                tenant=tenant, priority=int(sub.get("priority", 0)),
                deadline_s=deadline_s,
                max_retries=int(sub.get("max_retries", 0)),
                job_id=job_id)
        except (RuntimeError, ValueError) as e:
            # service-level refusal (drain race, foreign-graph
            # terminals): terminal rejection, not a daemon crash
            code = "draining" if self.service.draining else "bad_spec"
            self._reject(job_id, tenant,
                         {"code": code,
                          "detail": f"{type(e).__name__}: {e}"})
            return
        job.scratch["nets"] = nets
        self._subs[job_id] = dict(sub)
        self.slo.observe_admit(job_id, tenant, self._clock(),
                               lag_s=max(0.0, lag or 0.0),
                               failover=failover)
        # the service's corpus row stamps these at record time (absent
        # for non-daemon serving: the fields are optional by schema)
        job.scratch["slo_fields"] = (
            lambda jid=job_id: self.slo.runstore_fields(
                jid, now=self._clock()))
        if failover:
            # the batch scheduler reads this to stamp the job's
            # rebatch-entry cause as "failover" rather than "join"
            job.scratch["failover"] = True
            self.failed_over_ids.append(job_id)
            get_metrics().counter("route.fleet.jobs_failed_over").inc()
            if tr is not None:
                tr.instant("route.trace.failover", cat="lifecycle",
                           job_id=job_id, worker=self.worker)
            self.recorder.note("failover", job_id=job_id)
        if recovery:
            self.recovered_ids.append(job_id)
            get_metrics().counter("route.daemon.recovered").inc()
        else:
            get_metrics().counter("route.daemon.admitted").inc()
        if tr is not None:
            tr.instant("route.trace.admit", cat="lifecycle",
                       job_id=job_id, tenant=tenant, nets=nets,
                       recovery=recovery, failover=failover)
        self.recorder.note("admit", job_id=job_id, tenant=tenant,
                           nets=nets, recovery=recovery,
                           failover=failover)

    # ------------------------------------------------- shedding

    def _shed_overload(self) -> int:
        """Deadline-aware eviction under overload.  Victim order:
        jobs already doomed by their deadline first, then tenants over
        their fair share, then lowest aged priority, newest admission
        last-in-first-out — the heap survivors are the oldest,
        highest-priority, still-feasible work."""
        q = self.service.queue
        queued = q.queued_jobs()
        if not queued:
            return 0
        rate = self.admission.capacity_nets_per_s()
        backlog_s = self._backlog_nets() / rate
        horizon = self.opts.overload_factor * self.opts.admit_horizon_s
        over_depth = len(queued) > self.opts.max_queue_depth
        if backlog_s <= horizon and not over_depth:
            return 0
        get_metrics().counter("route.daemon.overloaded_cycles").inc()
        now = self._clock()
        by_tenant: Dict[str, int] = {}
        for j in queued:
            by_tenant[j.tenant] = by_tenant.get(j.tenant, 0) + 1
        share = max(self.opts.fair_share_floor,
                    int(self.opts.fair_share_frac * len(queued)))

        # snapshot the backlog the victim ORDER was computed against:
        # the loop below recomputes backlog_s after each eviction (its
        # stop condition must see the shrinking queue), and doomed()
        # closing over that shrinking value would let the shed cause's
        # "deadline already infeasible" annotation disagree with the
        # ordering that picked the victim
        backlog_s0 = backlog_s

        def doomed(j: RouteJob) -> bool:
            return (j.deadline_s is not None
                    and backlog_s0 > j.deadline_s
                    - (now - j.admitted_t))

        victims = sorted(
            queued,
            key=lambda j: (not doomed(j),
                           not (by_tenant[j.tenant] > share),
                           q.effective_priority(j, now),
                           -j.admitted_t))
        shed = 0
        for j in victims:
            backlog_s = self._backlog_nets() / rate
            if backlog_s <= horizon \
                    and q.depth() <= self.opts.max_queue_depth:
                break
            cause = {"code": "overload",
                     "detail": f"backlog {backlog_s:.1f}s over the "
                               f"{horizon:.0f}s overload horizon at "
                               f"{rate:.2f} nets/s"
                               + (" (deadline already infeasible)"
                                  if doomed(j) else ""),
                     "backlog_s": round(backlog_s, 2),
                     "horizon_s": horizon,
                     "queue_depth": q.depth(),
                     "rate_nets_per_s": round(rate, 3)}
            if q.evict(j.job_id, JobState.SHED,
                       error=cause["detail"]) is None:
                continue
            self.shed_causes[j.job_id] = cause
            get_metrics().counter("route.daemon.shed").inc()
            tr = get_tracer()
            if tr is not None:
                tr.instant("route.trace.shed", cat="lifecycle",
                           job_id=j.job_id, code=cause["code"])
            self.recorder.note("shed", job_id=j.job_id,
                               code=cause["code"])
            if self.lease is not None:
                # the fleet shed it, the fleet won't retry it: release
                # terminally so no peer mistakes it for dead-worker work
                self.lease.release(j.job_id, state="shed")
            by_tenant[j.tenant] -= 1
            self._append_reject_line(
                {"job_id": j.job_id, "tenant": j.tenant,
                 "state": "shed", "cause": cause, "ts": self._wall()})
            shed += 1
        return shed

    # ------------------------------------------------- leases

    def _lease_sweep(self) -> int:
        """Per-cycle lease upkeep + fencing; returns jobs fenced off.

        For every live local job: re-assert a missing record, renew a
        healthy one, contest an expired one (the self-steal wins back
        a chaos-forced lease when no peer gets there first), and FENCE
        — evict the local copy — when a peer holds a live lease or a
        released record exists: the job is someone else's now (or
        finished), and running it here would double-execute.  Terminal
        local jobs release their leases so peers never take over work
        that already has an answer."""
        ls = self.lease
        if ls is None:
            return 0
        fenced = 0
        for j in self.service.queue.jobs:
            if j.state in (JobState.QUEUED, JobState.RUNNING):
                doc = ls.read(j.job_id)
                if doc is None:
                    ls.acquire(j.job_id)
                    continue
                stolen = (doc.get("released")
                          or (doc.get("worker") != self.worker
                              and not ls.expired(doc)))
                if not stolen and ls.expired(doc):
                    # lapsed or chaos-forced: steal race, anyone's game
                    stolen = not ls.steal(j.job_id)
                if stolen:
                    cause = {
                        "code": "lease_stolen",
                        "detail": f"lease for {j.job_id} is held "
                                  f"elsewhere (or released); abandoning "
                                  f"the local copy to avoid a double "
                                  f"execution"}
                    if self.service.queue.evict(
                            j.job_id, JobState.SHED,
                            error=cause["detail"]) is not None:
                        self.shed_causes[j.job_id] = cause
                        fenced += 1
                        tr = get_tracer()
                        if tr is not None:
                            tr.instant("route.trace.shed",
                                       cat="lifecycle", job_id=j.job_id,
                                       code=cause["code"])
                        self.recorder.note("shed", job_id=j.job_id,
                                           code=cause["code"])
                elif doc.get("worker") == self.worker:
                    ls.renew(j.job_id)
            elif j.state in (JobState.DONE, JobState.FAILED,
                             JobState.TIMEOUT):
                doc = ls.read(j.job_id)
                if doc is not None and not doc.get("released") \
                        and doc.get("worker") == self.worker:
                    ls.release(j.job_id, state=j.state.value)
        return fenced

    def _chaos_lease_steal(self) -> None:
        """``lease.steal`` injection site: force-expire one held lease
        under its owner.  Peers (or the owner itself, via the sweep's
        steal race) must re-win it; the loser is fenced — exactly the
        split-brain the lease protocol exists to resolve."""
        rt = getattr(self.service, "resil", None)
        if self.lease is None or rt is None \
                or getattr(rt, "plan", None) is None:
            return
        held = self.lease.held()
        if not held:
            return
        f = rt.plan.fire("lease.steal", detail=held[0])
        if f is not None:
            self.lease.force_expire(held[0])

    # ------------------------------------------- slice SLO sampling

    def _stall_seconds(self) -> float:
        """The pipeline's blocked time within the LAST route() call
        (a per-slice gauge the router resets each invocation)."""
        v = get_metrics().gauge("route.pipeline.stall_ms_total").value
        return float(v) / 1e3 if isinstance(v, (int, float)) else 0.0

    def _slice_marks(self) -> Tuple[float, float, float]:
        """Pre-slice readings the waterfall attributes against: the
        daemon clock, the process compile-seconds accumulator, and the
        pipeline stall gauge — all host memory, no device sync."""
        return self._clock(), compile_seconds(), self._stall_seconds()

    def _observe_slice(self, job: RouteJob, t_start: float,
                       compile0: float, stall0: float) -> None:
        # the stall gauge is a per-route()-call TOTAL (the router
        # resets it each invocation), so this slice's stall is the
        # post-slice reading — unless the gauge never moved, i.e. the
        # slice ran no pipelined windows at all
        stall1 = self._stall_seconds()
        self.slo.observe_slice(
            job.job_id, t_start, self._clock(),
            compile_s=max(0.0, compile_seconds() - compile0),
            stall_s=stall1 if stall1 != stall0 else 0.0,
            attempts=job.attempts)

    def _runner(self, job: RouteJob):
        """Queue runner: the service's, plus lease bookkeeping — a
        finished job releases terminally, a preempted one renews so a
        long multi-slice job never lapses mid-flight — wrapped in the
        job's per-slice lifecycle span (the span records even when the
        slice raises: the queue's verdict loop owns the exception)."""
        tr = get_tracer()
        t_start, c0, s0 = self._slice_marks()
        if tr is None:
            verdict, value = self.service._runner(job)
        else:
            with tr.span("route.trace.slice", cat="lifecycle",
                         job_id=job.job_id, slice=job.slices + 1,
                         worker=self.worker or "solo"):
                verdict, value = self.service._runner(job)
        self._observe_slice(job, t_start, c0, s0)
        self._last_slice = {"job_id": job.job_id,
                            "slice": job.slices + 1, "verdict": verdict}
        self.last_verdicts.append(
            {"job_id": job.job_id, "verdict": verdict,
             "slice": job.slices + 1, "ts": round(self._wall(), 3)})
        del self.last_verdicts[:-8]
        self.recorder.note("slice", job_id=job.job_id,
                           slice=job.slices + 1, verdict=verdict)
        if self.lease is not None:
            if verdict == "done":
                self.lease.release(job.job_id, state="done")
            elif verdict == "preempted":
                self.lease.renew(job.job_id)
        return verdict, value

    def _batch_runner(self, jobs: List[RouteJob]):
        """Batched queue runner (continuous batching): the service's
        fused lockstep slice over the whole co-admitted set, then the
        same per-job verdict/lease bookkeeping ``_runner`` does."""
        tr = get_tracer()
        ids = ",".join(j.job_id for j in jobs)
        t_start, c0, s0 = self._slice_marks()
        if tr is None:
            verdicts = self.service._batch_runner(jobs)
        else:
            with tr.span("route.trace.slice", cat="lifecycle",
                         job_id=f"fused[{ids}]",
                         slice=max(j.slices for j in jobs),
                         worker=self.worker or "solo"):
                verdicts = self.service._batch_runner(jobs)
        for job in jobs:
            # lockstep costs are joint: every member LIVED through the
            # whole fused wall, so each job's waterfall is charged the
            # full slice window (per-job nets/s attribution stays the
            # service's even-share route_s policy)
            self._observe_slice(job, t_start, c0, s0)
        for job in jobs:
            verdict = verdicts.get(job.job_id, ("failed", ""))[0]
            self._last_slice = {"job_id": job.job_id,
                                "slice": job.slices,
                                "verdict": verdict}
            self.last_verdicts.append(
                {"job_id": job.job_id, "verdict": verdict,
                 "slice": job.slices, "ts": round(self._wall(), 3)})
            self.recorder.note("slice", job_id=job.job_id,
                               slice=job.slices, verdict=verdict)
            if self.lease is not None:
                if verdict == "done":
                    self.lease.release(job.job_id, state="done")
                elif verdict == "preempted":
                    self.lease.renew(job.job_id)
        del self.last_verdicts[:-8]
        return verdicts

    # ------------------------------------------------- journal

    def _journal_entries(self) -> Dict[str, dict]:
        entries: Dict[str, dict] = {}
        for j in self.service.queue.jobs:
            e = {"tenant": j.tenant, "state": j.state.value,
                 "priority": j.priority,
                 "submission": self._subs.get(j.job_id, {})}
            if j.state in (JobState.QUEUED, JobState.RUNNING):
                e["state"] = _IN_FLIGHT
                ck = j.checkpoint
                if ck is not None:
                    e["it_done"] = int(getattr(ck, "it_done", 0))
            elif j.state is JobState.DONE:
                if isinstance(j.result, dict):
                    e["wirelength"] = j.result.get("wirelength")
                    e["iterations"] = j.result.get("iterations")
            elif j.state is JobState.SHED:
                e["cause"] = self.shed_causes.get(j.job_id)
            else:
                e["reason"] = j.failure_reason
            entries[j.job_id] = e
        for job_id, rec in self.rejected.items():
            entries[job_id] = {"tenant": rec["tenant"],
                               "state": "rejected",
                               "reason": rec["reason"]}
        return entries

    def _flush_journal(self) -> None:
        self.journal.save(self._journal_entries(),
                          extra={"inbox_offset": self.reader.offset,
                                 "cycle": self.cycles})

    def _recover(self) -> None:
        """Restart path: rebuild the job table from the journal.
        In-flight entries are re-admitted (idempotently — the inbox
        re-read dedupes against them) and resume from their durable
        checkpoints via the service's resilience store; terminal
        entries are remembered so replayed submissions of finished
        work stay no-ops."""
        doc = self.journal.load()
        if doc is None:
            return
        self.reader.offset = int(doc.get("inbox_offset", 0) or 0)
        for job_id, e in sorted((doc.get("jobs") or {}).items()):
            state = e.get("state")
            if state == "rejected":
                self.rejected[job_id] = {
                    "job_id": job_id, "tenant": e.get("tenant"),
                    "state": "rejected", "reason": e.get("reason")}
            elif state == _IN_FLIGHT:
                sub = dict(e.get("submission") or {})
                sub.setdefault("job_id", job_id)
                sub.setdefault("tenant", e.get("tenant", "default"))
                self._admit_submission(sub, recovery=True)

    # ------------------------------------------------- telemetry

    def live_snapshot(self) -> dict:
        """The live telemetry document: job table, held leases, recent
        verdicts and current metric values — all host memory already in
        hand, so building it never forces a device sync mid-window."""
        q = self.service.queue
        m = get_metrics()
        fc = self._forecast()
        # publish the route.slo.* gauges BEFORE the registry snapshot
        # so the metrics map and the slo section always agree (the
        # plane returns unprefixed keys; the daemon owns the namespace)
        for k, v in self.slo.gauges(fc).items():
            m.gauge("route.slo." + k).set(v)
        doc = {"schema": 1, "worker": self.worker,
               "ts": round(self._wall(), 3),
               "mono": round(self._clock(), 3),
               "cycle": self.cycles,
               "queue_depth": q.depth(),
               "draining": self.service.draining,
               "in_flight": self._last_slice,
               "jobs": {j.job_id: j.state.value for j in q.jobs},
               "held_leases": (self.lease.held()
                               if self.lease is not None else []),
               "last_verdicts": list(self.last_verdicts),
               "slo": self.slo.snapshot(forecast=fc),
               "metrics": m.values("route.")}
        return doc

    def _forecast(self) -> dict:
        """Capacity forecast from the LAST published capacity gauge
        (refreshed only when admission/shedding has not priced it this
        run — never an extra corpus read per snapshot) and the live
        backlog.  workers_alive=1: a worker forecasts draining ITS OWN
        backlog; the fleet merge re-derives the fleet view."""
        rate = get_metrics().gauge(
            "route.daemon.capacity_nets_per_s").value
        if not isinstance(rate, (int, float)) or rate <= 0:
            rate = self.admission.capacity_nets_per_s()
        return self.forecaster.forecast(
            rate, self._backlog_nets(), workers_alive=1)

    def _write_telemetry(self) -> None:
        """Atomic snapshot publish (tmp + os.replace): a scraper can
        read mid-write and never sees a torn document.  No fsync — a
        live snapshot needs rename atomicity, not power-loss
        durability (stale-after-crash is fine; a per-cycle fsync is
        not)."""
        try:
            doc = self.live_snapshot()
            tmp = self._telemetry_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True, default=str)
            os.replace(tmp, self._telemetry_path)
            # the slo.json twin rides the SAME publish site (and the
            # same snapshot counter): SLO publishing adds no snapshot
            # sites and no mid-window syncs
            tmp = self._slo_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc["slo"], f, sort_keys=True, default=str)
            os.replace(tmp, self._slo_path)
        except OSError as e:
            get_metrics().counter(
                "route.daemon.snapshot_errors").inc()
            self.recorder.note("telemetry_error", error=str(e))
            return
        get_metrics().counter("route.daemon.snapshot_writes").inc()

    def _scan_terminal(self) -> None:
        """Emit one terminal lifecycle instant per job as it reaches a
        terminal state (whoever set it — runner verdict, shed, evict,
        timeout), closing the job's trace chain."""
        tr = get_tracer()
        for j in self.service.queue.jobs:
            if j.job_id in self._terminal_seen \
                    or j.state in (JobState.QUEUED, JobState.RUNNING):
                continue
            self._terminal_seen.add(j.job_id)
            # finalize the job's latency waterfall + digest samples
            # (exactly one per terminal job — the doctor's count rule)
            self.slo.observe_terminal(j.job_id, j.state.value,
                                      self._clock())
            if tr is not None:
                tr.instant("route.trace.terminal", cat="lifecycle",
                           job_id=j.job_id, state=j.state.value,
                           slices=j.slices)
            self.recorder.note("terminal", job_id=j.job_id,
                               state=j.state.value, slices=j.slices)

    def _flight_metric_deltas(self) -> None:
        """Fold this cycle's daemon/serve/fleet/resil counter movement
        into the flight ring — the diag bundle then shows WHAT was
        moving in the last N cycles, not just the final totals."""
        vals = get_metrics().values("route.")
        deltas = {}
        for name, v in vals.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            last = self._metric_last.get(name)
            if last is None or v != last:
                deltas[name] = round(v - (last or 0), 6)
            self._metric_last[name] = v
        if deltas:
            self.recorder.note("metrics", cycle=self.cycles, **deltas)

    def _export_shard(self) -> None:
        """Per-cycle atomic trace-shard export: the merge (and a
        post-SIGKILL post-mortem) always finds every cycle that
        completed before the kill."""
        tr = get_tracer()
        if tr is None or not self.opts.trace_path:
            return
        try:
            tr.export(self.opts.trace_path, atomic=True)
        except OSError as e:
            get_metrics().counter("route.trace.shard_errors").inc()
            self.recorder.note("shard_error", error=str(e))
            return
        get_metrics().counter("route.trace.shard_writes").inc()

    # ------------------------------------------------- main loop

    def request_stop(self) -> None:
        self._stop = True

    def _drain_requested(self) -> bool:
        return os.path.exists(os.path.join(self.inbox_dir, DRAIN_NAME))

    def cycle(self) -> int:
        """One daemon cycle; returns the number of queue slices that
        actually ran (0 = idle)."""
        self.cycles += 1
        q = self.service.queue
        tr = get_tracer()
        if tr is not None:
            # per-cycle clock-sync beacon: the merge aligns this
            # shard's perf origin to the wall timeline from these
            tr.beacon(worker=self.worker or "solo", cycle=self.cycles)
            get_metrics().counter("route.trace.beacons").inc()
        if self._drain_requested() and not self.service.draining:
            self.service.begin_drain()
        hb_state = {"queue_depth": q.depth(), "cycle": self.cycles,
                    "draining": self.service.draining}
        if self.worker:
            hb_state["worker"] = self.worker
        self.heartbeat.beat(**hb_state)
        polled = self.reader.poll()
        for sub in polled:
            self._admit_submission(sub)
        self._check_foreign()
        self._chaos_lease_steal()
        self._shed_overload()
        if polled:
            # durability ordering: a job must be journaled as
            # in-flight BEFORE its first slice runs, or a crash during
            # the first (compile-heavy) slice loses the admission and
            # the restart replays from the inbox instead of recovering
            self._flush_journal()
        before = sum(j.slices for j in q.jobs)
        # one slice at a time with a beat (and a lease fence) between:
        # a compile-heavy slice must not silence the heartbeat, and a
        # stolen job must never get another local slice
        for _ in range(self.opts.slices_per_cycle):
            self._lease_sweep()
            if q.depth() == 0:
                break
            if self.opts.fused:
                # continuous batching: one rebatch-and-fuse round over
                # every runnable job.  The lease sweep above fences
                # stolen jobs BEFORE the re-pack, so a fenced job
                # drops out of the batch at this slice boundary
                q.run_batch(self._batch_runner, max_batches=1)
            else:
                q.run(self._runner, max_slices=1)
            hb_state["queue_depth"] = q.depth()
            self.heartbeat.beat(**hb_state)
            self._scan_terminal()
            # slice boundary: the device window just closed, so the
            # snapshot (and shard) publish costs no mid-window sync
            self._write_telemetry()
            self._export_shard()
        if q.depth() == 0:
            self._lease_sweep()   # release freshly-terminal leases
        ran = sum(j.slices for j in q.jobs) - before
        m = get_metrics()
        m.gauge("route.daemon.uptime_s").set(
            round(self._clock() - self._t0, 3))
        m.gauge("route.daemon.queue_depth").set(q.depth())
        m.counter("route.daemon.cycles").inc()
        self._scan_terminal()
        self._flight_metric_deltas()
        m.gauge("route.trace.flight_records").set(self.recorder.total)
        self._write_telemetry()
        self._flush_journal()
        self._export_shard()
        return ran

    def run(self, max_cycles: int = 0) -> List[RouteJob]:
        """Recover, then cycle until drained/idle/stopped.  Returns
        the queue's job list (terminal states set) for the summary."""
        tr = get_tracer()
        if tr is not None:
            # start-of-life beacon: even a worker killed in its first
            # cycle leaves an alignable shard
            tr.beacon(worker=self.worker or "solo", cycle=0)
            get_metrics().counter("route.trace.beacons").inc()
        self._recover()
        self._flush_journal()
        while not self._stop:
            ran = self.cycle()
            if max_cycles and self.cycles >= max_cycles:
                break
            idle = (ran == 0 and self.service.queue.depth() == 0)
            if idle:
                self._idle_cycles += 1
                if self.service.draining:
                    break
                if self.opts.exit_when_idle \
                        and self._idle_cycles >= self.opts.exit_when_idle:
                    break
                self._sleep(self.opts.poll_s)
            else:
                self._idle_cycles = 0
        self._flush_journal()
        return list(self.service.queue.jobs)

    # ------------------------------------------------- summary

    def summary(self) -> dict:
        """The ``flow_doctor --daemon-summary`` artifact: every job's
        terminal state with its machine-readable reason/cause, plus
        heartbeat/journal provenance and the route.daemon.* metrics."""
        m = get_metrics()
        jobs: List[dict] = []
        for j in self.service.queue.jobs:
            row = {"job_id": j.job_id, "tenant": j.tenant,
                   "state": j.state.value, "priority": j.priority,
                   "preemptions": j.preemptions, "slices": j.slices,
                   "recovered": j.job_id in self.recovered_ids,
                   "failure_reason": j.failure_reason}
            if self.worker:
                row["worker"] = self.worker
                row["failed_over"] = j.job_id in self.failed_over_ids
            if j.state is JobState.SHED:
                row["shed_cause"] = self.shed_causes.get(j.job_id)
            if isinstance(j.result, dict):
                row.update({k: j.result[k] for k in
                            ("wirelength", "iterations", "nets",
                             "nets_per_s") if k in j.result})
            jobs.append(row)
        for rec in self.rejected.values():
            jobs.append({"job_id": rec["job_id"],
                         "tenant": rec.get("tenant"),
                         "state": "rejected",
                         "reject_reason": rec.get("reason")})
        fleet = None
        if self.worker:
            fleet = {"worker": self.worker,
                     "roster": sorted(self.opts.workers or
                                      (self.worker,)),
                     "lease": self.lease.summary(),
                     "failed_over": self.failed_over_ids,
                     "pending_foreign": sorted(self._foreign),
                     "metrics": m.values("route.fleet.")}
        return {
            "scenario": self.service.scenario,
            "jobs": jobs,
            "fleet": fleet,
            "slo": self.slo.snapshot(forecast=self._forecast()),
            "daemon": {
                "inbox": {"dir": self.inbox_dir,
                          "consumed_bytes": self.reader.offset,
                          "torn_lines": self.reader.torn},
                "uptime_s": round(self._clock() - self._t0, 3),
                "cycles": self.cycles,
                "heartbeat": self.heartbeat.summary(),
                "journal": {"file": self.journal.path,
                            "writes": self.journal.writes,
                            "entries": len(self._journal_entries())},
                "recovered": self.recovered_ids,
                "telemetry": {"file": self._telemetry_path,
                              "flight_recorded": self.recorder.total},
                "metrics": m.values("route.daemon."),
            },
            "trace": m.values("route.trace."),
            "serve": m.values("route.serve."),
            "rebatch": (self.service.rebatch_summary()
                        if hasattr(self.service, "rebatch_summary")
                        else {"fused": False, "rounds": 0,
                              "events": [], "counters": {}}),
            "dispatch_compiles": m.counter(
                "route.dispatch.compiles").value,
            "resil": {"metrics": m.values("route.resil.")},
        }


def build_daemon(inbox_dir: str, *, luts: int, chan_width: int = 16,
                 batch_size: int = 32, max_router_iterations: int = 50,
                 slice_iters: int = 2,
                 library_dir: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None,
                 runs_dir: Optional[str] = None,
                 scenario: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 opts: Optional[DaemonOpts] = None,
                 fault_plan=None,
                 sync: bool = False,
                 fused: bool = False,
                 device=None) -> RouteDaemon:
    """Wire a production-shaped daemon: real synth flow on one device
    graph, resilience layer armed with durable checkpoints under the
    inbox, service corpus rows feeding the admission estimator.  The
    Router runs on ``device`` (the card by default; ``"cpu"`` for the
    plain PyTorch versions).  The compile cache installs each library
    with ``os.replace`` under a content digest, so processes may share
    one."""
    from ..flow import synth_flow
    from ..resil import ResilOpts

    fused = fused or bool(opts is not None and opts.fused)
    flow = synth_flow(num_luts=luts, chan_width=chan_width)
    scenario = scenario or f"daemon_l{luts}_w{chan_width}"
    ropts = RouterOpts(
        batch_size=batch_size,
        max_router_iterations=max_router_iterations,
        sink_group=0, pipeline=not sync,
        compile_cache_dir=compile_cache_dir or None,
        program_library_dir=library_dir or None)
    resil = ResilOpts(
        fault_plan=fault_plan,
        checkpoint_dir=checkpoint_dir
        or os.path.join(inbox_dir, CKPT_DIR))
    service = RouteService(
        flow.rr, ropts, slice_iters=slice_iters,
        runs_dir=runs_dir or None, scenario=scenario,
        cfg={"luts": luts, "chan_width": chan_width,
             "slice": slice_iters, "daemon": True},
        resil=resil, fused=fused, device=device)
    if fused and opts is not None and not opts.fused:
        opts = dc_replace(opts, fused=True)
    elif fused and opts is None:
        opts = DaemonOpts(fused=True)
    return RouteDaemon(service, inbox_dir, opts,
                       grid_cfg={"luts": luts,
                                 "chan_width": chan_width})
