"""Fleet supervisor: N replicated route workers over ONE durable inbox
(the counterpart of the JAX package's serve/fleet.py).

``python -m parallel_eda_tpu_torch daemon fleet`` spawns N worker
daemons (``daemon run --worker wK --workers w0,.. --device D``) that
share the inbox, the run corpus, the durable checkpoints, the lease
directory, and the program library — but never a compile cache
directory (each worker gets ``<cache_base>/<worker>``, as the JAX
package fences them).  Every worker routes on ``FleetOpts.device``: the
card unless the caller asks for the CPU; a worker that cannot reach its
device dies at start-up and is reported dead, never respawned elsewhere.
On one card each worker holds its own CUDA context; nothing is shared
between them but the files of the inbox.  The supervisor:

* partitions admission capacity: each worker's ``max_queue_depth`` is
  its share of the fleet total, so the fleet as a whole enforces the
  same backlog bound a solo daemon would;
* runs the network transport (``serve/transport.py``) over the shared
  inbox, with the ``transport.drop`` chaos site armed;
* monitors per-worker heartbeats (monotonic age) and publishes
  ``route.fleet.workers_alive``;
* owns the ``worker.kill`` chaos site: a scheduled firing SIGKILLs a
  seeded-chosen live worker and does NOT respawn it — the surviving
  peers must steal the victim's expired leases and finish its jobs
  from the shared durable checkpoints (the failover the lease
  protocol exists for);
* detects completion by counting *released* lease records, then
  touches ``DRAIN`` and waits the workers out;
* aggregates every worker's summary (plus its own transport/fault/
  lease state) into ONE fleet summary JSON, the artifact
  ``flow_doctor --fleet-summary`` gates.

Stdlib + repo-internal imports only; the workers are full daemons in
their own processes.  A worker's first slice on a cold compile cache
builds the CUDA libraries (nvcc, tens of seconds on the card), which
blocks its loop, its heartbeat and its lease renewals for as long: start
a card fleet over an exported program library (``library_dir``), or give
it a ``lease_ttl_s`` above the build's seconds.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs.metrics import get_metrics
from ..obs.slo import CapacityForecaster, merge_slo_sections
from ..resil.checkpoint import checkpoint_file
from ..resil.journal import Heartbeat, LeaseStore, _atomic_write_json
from .daemon import (CKPT_DIR, LEASE_DIR, DRAIN_NAME, heartbeat_name,
                     telemetry_name)
from .transport import InboxHTTPServer

#: chaos sites the supervisor itself owns; everything else in a fleet
#: --chaos spec is forwarded to the workers
SUPERVISOR_SITES = ("worker.kill", "transport.drop")


def split_chaos(spec: str) -> tuple:
    """Split a ``site:count[:horizon],...`` spec into the
    supervisor-owned part and the worker-forwarded part."""
    sup, wrk = [], []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        (sup if part.split(":")[0] in SUPERVISOR_SITES
         else wrk).append(part)
    return ",".join(sup), ",".join(wrk)


@dataclass
class FleetOpts:
    """Supervisor knobs (the fleet CLI maps flags onto these)."""

    n_workers: int = 2
    luts: int = 10
    chan_width: int = 16
    slice_iters: int = 2
    max_router_iterations: int = 50
    library_dir: str = ""          # shared program library
    cache_base: str = ""           # per-worker compile caches live under
    runs_dir: str = ""
    scenario: str = ""
    sync: bool = False
    fused: bool = False            # workers run continuous batching
    heartbeat_s: float = 0.5
    poll_s: float = 0.1
    lease_ttl_s: float = 4.0
    foreign_grace_s: float = 2.0
    exit_when_idle: int = 0        # workers: idle cycles before exit
    max_queue_depth: int = 64      # FLEET total; partitioned per worker
    chaos_seed: int = 0
    chaos: str = ""                # full spec; split_chaos partitions it
    transport: bool = True
    host: str = "127.0.0.1"
    port: int = 0                  # 0 = ephemeral
    expect_jobs: int = 0           # stop once this many leases released
    tick_s: float = 0.5            # monitor period
    stale_after_s: float = 5.0     # heartbeat age that counts as dead
    trace: bool = False            # per-worker trace shards + merged
    #                                fleet trace (trace.merged.json)
    skew_bound_ms: float = 250.0   # declared post-align residual-skew
    #                                bound the fleet doctor gates
    objectives_path: str = ""      # per-tenant SLO objectives JSON,
    #                                forwarded to every worker
    extra_worker_args: List[str] = field(default_factory=list)
    device: str = "cuda"           # every worker's --device


class FleetSupervisor:
    def __init__(self, inbox_dir: str, opts: Optional[FleetOpts] = None):
        from ..resil.faults import FaultPlan

        self.inbox_dir = inbox_dir
        self.opts = opts or FleetOpts()
        os.makedirs(inbox_dir, exist_ok=True)
        self.roster = [f"w{i}" for i in range(self.opts.n_workers)]
        sup_spec, self.worker_chaos = split_chaos(self.opts.chaos)
        self.plan = (FaultPlan.parse(self.opts.chaos_seed, sup_spec)
                     if sup_spec else None)
        self.server: Optional[InboxHTTPServer] = None
        self.procs: Dict[str, subprocess.Popen] = {}
        self.killed: List[str] = []
        self.exit_codes: Dict[str, Optional[int]] = {}
        # read-only lease view (never acquires: a name outside the
        # roster can't win any race by construction)
        self.leases = LeaseStore(
            os.path.join(inbox_dir, LEASE_DIR), "supervisor",
            ttl_s=self.opts.lease_ttl_s)
        self.timed_out = False
        self._t0 = time.monotonic()

    # ------------------------------------------------- spawning

    def _summary_path(self, worker: str) -> str:
        return os.path.join(self.inbox_dir, f"summary.{worker}.json")

    def _shard_path(self, worker: str) -> str:
        return os.path.join(self.inbox_dir, f"trace.{worker}.json")

    def _log_path(self, worker: str) -> str:
        return os.path.join(self.inbox_dir, f"worker.{worker}.log")

    def _worker_cmd(self, worker: str) -> List[str]:
        o = self.opts
        per_worker_depth = max(
            1, o.max_queue_depth // max(1, o.n_workers))
        cmd = [sys.executable, "-m", "parallel_eda_tpu_torch", "daemon",
               "run", "--inbox", self.inbox_dir,
               "--worker", worker,
               "--workers", ",".join(self.roster),
               "--luts", str(o.luts),
               "--chan_width", str(o.chan_width),
               "--slice", str(o.slice_iters),
               "--max_router_iterations", str(o.max_router_iterations),
               "--heartbeat_s", str(o.heartbeat_s),
               "--poll_s", str(o.poll_s),
               "--lease_ttl_s", str(o.lease_ttl_s),
               "--foreign_grace_s", str(o.foreign_grace_s),
               "--max_queue_depth", str(per_worker_depth),
               "--summary", self._summary_path(worker),
               "--device", o.device]
        if o.exit_when_idle:
            cmd += ["--exit_when_idle", str(o.exit_when_idle)]
        if o.library_dir:
            cmd += ["--library", o.library_dir]
        if o.cache_base:
            # one compile cache dir PER WORKER, as JAX fences them
            cmd += ["--compile_cache_dir",
                    os.path.join(o.cache_base, worker)]
        if o.runs_dir:
            cmd += ["--runs_dir", o.runs_dir]
        if o.scenario:
            cmd += ["--scenario", o.scenario]
        if o.sync:
            cmd += ["--sync"]
        if o.fused:
            cmd += ["--fused"]
        if self.worker_chaos:
            cmd += ["--chaos", self.worker_chaos,
                    "--chaos_seed", str(o.chaos_seed)]
        if o.trace:
            cmd += ["--trace", self._shard_path(worker)]
        if o.objectives_path:
            cmd += ["--objectives", o.objectives_path]
        return cmd + list(o.extra_worker_args)

    def start(self) -> "FleetSupervisor":
        m = get_metrics()
        if self.opts.transport:
            self.server = InboxHTTPServer(
                self.inbox_dir, host=self.opts.host,
                port=self.opts.port, plan=self.plan).start()
            # publish the bound (possibly ephemeral) port durably so
            # submitters can discover the fleet without racing stdout
            _atomic_write_json(
                os.path.join(self.inbox_dir, "transport.json"),
                {"url": self.server.url})
        # the package's parent directory on the workers' path, so that
        # ``-m parallel_eda_tpu_torch`` resolves from any working dir
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))
        for worker in self.roster:
            # each worker's output goes to <inbox>/worker.<w>.log: a
            # worker that dies at start-up leaves its reason there
            with open(self._log_path(worker), "ab") as log:
                self.procs[worker] = subprocess.Popen(
                    self._worker_cmd(worker), env=env,
                    stdout=log, stderr=subprocess.STDOUT)
            m.counter("route.fleet.workers_spawned").inc()
        return self

    # ------------------------------------------------- monitoring

    def alive_workers(self) -> List[str]:
        return [w for w, p in self.procs.items() if p.poll() is None]

    def heartbeats(self) -> Dict[str, dict]:
        out = {}
        for w in self.roster:
            hb = Heartbeat.read(
                os.path.join(self.inbox_dir, heartbeat_name(w)))
            out[w] = {"age_s": hb.get("age_s"),
                      "age_src": hb.get("age_src"),
                      "queue_depth": hb.get("queue_depth"),
                      "beating": hb.get("age_s", float("inf"))
                      <= self.opts.stale_after_s}
        return out

    def _victim_sliced(self, worker: str) -> bool:
        """True once ``worker``'s telemetry snapshot shows a completed
        slice and the trace shard of that slice boundary is on disk.
        The daemon publishes the snapshot just before it exports the
        shard, so the shard must be no older than the snapshot: a kill
        between the two would find no shard (or one from before the
        slice).  A victim passing this check has a slice span on disk —
        the merged fleet trace can then render the failover as a chain
        CROSSING worker tracks instead of a track that dies empty."""
        path = os.path.join(self.inbox_dir, telemetry_name(worker))
        try:
            with open(path) as f:
                if not json.load(f).get("in_flight"):
                    return False
            return (os.stat(self._shard_path(worker)).st_mtime_ns
                    >= os.stat(path).st_mtime_ns)
        except (OSError, ValueError):
            return False

    def _checkpointed(self, job_id: str) -> bool:
        return os.path.exists(checkpoint_file(
            os.path.join(self.inbox_dir, CKPT_DIR), job_id))

    def _chaos_worker_kill(self) -> None:
        if self.plan is None:
            return
        alive = sorted(self.alive_workers())
        if not alive:
            return
        # the site is ARMED only while an alive worker holds a live
        # lease: a kill that cannot orphan in-flight work exercises
        # nothing, so the seeded schedule counts armed ticks — the
        # victim is always mid-job and the peers MUST fail over.  The
        # port arms it only once that job also has a durable checkpoint,
        # so that every kill exercises the failover's resume, never a
        # restart from scratch
        holders = sorted({d.get("worker") for j, d in
                          self.leases.scan().items()
                          if not d.get("released")
                          and self._checkpointed(j)} & set(alive))
        # with tracing on, additionally require a victim that has
        # EXPORTED a slice (first slices are compile-heavy; killing
        # inside one leaves a shard with no span to link the failover)
        if self.opts.trace:
            holders = [w for w in holders if self._victim_sliced(w)]
        if not holders:
            return
        f = self.plan.fire("worker.kill", detail=",".join(holders))
        if f is None:
            return
        victim = holders[f.seq % len(holders)]
        # SIGKILL, not SIGTERM: no journal flush, no lease release —
        # the worker dies the worst way it can, and it STAYS dead
        # (no respawn): the peers must finish its work
        try:
            os.kill(self.procs[victim].pid, signal.SIGKILL)
        except OSError:
            return
        self.procs[victim].wait()
        self.killed.append(victim)
        get_metrics().counter("route.fleet.workers_killed").inc()

    def _released_jobs(self) -> List[str]:
        return sorted(j for j, d in self.leases.scan().items()
                      if d.get("released"))

    def tick(self) -> dict:
        """One monitor pass; returns the instantaneous fleet view."""
        self._chaos_worker_kill()
        alive = self.alive_workers()
        get_metrics().gauge("route.fleet.workers_alive").set(len(alive))
        released = self._released_jobs()
        return {"alive": alive, "released": released,
                "heartbeats": self.heartbeats()}

    def run(self, timeout_s: float = 600.0) -> dict:
        """Spawn (if needed), monitor to completion, aggregate.
        Completion = ``expect_jobs`` released leases (when set), or
        every worker exited on its own."""
        if not self.procs:
            self.start()
        o = self.opts
        deadline = time.monotonic() + timeout_s
        t_serve0 = time.monotonic()
        try:
            while True:
                view = self.tick()
                if o.expect_jobs \
                        and len(view["released"]) >= o.expect_jobs:
                    break
                if not view["alive"]:
                    break
                if time.monotonic() > deadline:
                    self.timed_out = True
                    break
                time.sleep(o.tick_s)
            self._drain_and_wait(deadline)
        finally:
            self._reap()
            if self.server is not None:
                self.server.stop()
        return self.summary(serve_wall_s=time.monotonic() - t_serve0)

    def _drain_and_wait(self, deadline: float) -> None:
        drain = os.path.join(self.inbox_dir, DRAIN_NAME)
        with open(drain + ".tmp", "w") as f:
            f.write("fleet drain\n")
        os.replace(drain + ".tmp", drain)
        while self.alive_workers():
            if time.monotonic() > deadline:
                self.timed_out = True
                break
            time.sleep(min(0.2, self.opts.tick_s))

    def _reap(self) -> None:
        for w, p in self.procs.items():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            self.exit_codes[w] = p.returncode

    # ------------------------------------------------- aggregation

    def _worker_summary(self, worker: str) -> Optional[dict]:
        try:
            with open(self._summary_path(worker)) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    def _scrape_telemetry(self) -> Dict[str, dict]:
        """Condensed final view of every worker's live telemetry
        snapshot — the same files ``GET /metrics`` serves, scraped
        into the fleet summary so a post-mortem has each member's
        last-published state even when the worker died too hard to
        write a summary."""
        out: Dict[str, dict] = {}
        for w in self.roster:
            p = os.path.join(self.inbox_dir, f"telemetry.{w}.json")
            try:
                with open(p) as f:
                    t = json.load(f)
                if not isinstance(t, dict):
                    raise ValueError("telemetry is not an object")
            except (OSError, ValueError) as e:
                out[w] = {"error": str(e)}
                continue
            out[w] = {"cycle": t.get("cycle"),
                      "ts": t.get("ts"),
                      "queue_depth": t.get("queue_depth"),
                      "in_flight": t.get("in_flight"),
                      "held_leases": t.get("held_leases"),
                      "jobs": t.get("jobs"),
                      "last_verdicts": t.get("last_verdicts")}
        return out

    def _merge_traces(self) -> Optional[dict]:
        """Supervisor-side shard merge: load ``tools/trace_merge.py``
        by file path (tools/ is not a package), beacon-align every
        worker's shard onto one wall timeline and write the single
        Perfetto document ``<inbox>/trace.merged.json``.  The tool is
        stdlib only.  Merge failures are recorded, never raised —
        observability must not fail the fleet."""
        if not self.opts.trace:
            return None
        shards = [p for p in (self._shard_path(w) for w in self.roster)
                  if os.path.exists(p)]
        if not shards:
            return {"error": "no trace shards found", "shards": []}
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        tool = os.path.join(repo, "tools", "trace_merge.py")
        out_path = os.path.join(self.inbox_dir, "trace.merged.json")
        try:
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "_trace_merge", tool)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            doc = mod.merge(shards,
                            skew_bound_ms=self.opts.skew_bound_ms)
            blob = json.dumps(doc)
            tmp = out_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, out_path)
        except (OSError, ValueError, ImportError, AttributeError) as e:
            get_metrics().counter(
                "route.fleet.trace_merge_errors").inc()
            return {"error": f"{type(e).__name__}: {e}",
                    "shards": shards}
        meta = doc.get("traceMergeMeta") or {}
        return {"merged": out_path, "shards": shards,
                "events": len(doc.get("traceEvents") or []),
                "residual_skew_ms": meta.get("residual_skew_ms"),
                "skew_bound_ms": meta.get("skew_bound_ms")}

    def _merge_slo(self, sections: Dict[str, dict]) -> Optional[dict]:
        """Bin-wise exact merge of every worker's SLO section (the
        merged digest count equals the sum of the shard counts by
        construction — flow_doctor --slo asserts it), plus a
        fleet-level capacity forecast re-derived from the workers'
        published forecast inputs: summed backlog, mean per-worker
        rate, and the supervisor's own workers_alive reading."""
        if not sections:
            return None
        fcs = [s.get("forecast") for s in sections.values()
               if isinstance(s.get("forecast"), dict)]
        forecast = None
        if fcs:
            rates = [float(f.get("rate_nets_per_s") or 0.0)
                     for f in fcs]
            forecast = CapacityForecaster(
                horizon_s=float(fcs[0].get("horizon_s") or 60.0),
                max_workers=int(fcs[0].get("max_workers") or 64),
            ).forecast(
                sum(rates) / max(1, len(rates)),
                sum(float(f.get("backlog_nets") or 0.0) for f in fcs),
                workers_alive=max(1, len(self.alive_workers())))
        return merge_slo_sections(sections, forecast=forecast)

    def summary(self, serve_wall_s: float = 0.0) -> dict:
        """The ``flow_doctor --fleet-summary`` artifact: merged job
        rows (worker-attributed), fleet-wide route.fleet.* metrics
        (workers' counters summed + the supervisor's own), the lease
        table, transport counters, and the fault log."""
        jobs: List[dict] = []
        merged: Dict[str, float] = dict(
            get_metrics().values("route.fleet."))
        per_worker: Dict[str, dict] = {}
        slo_sections: Dict[str, dict] = {}
        for w in self.roster:
            doc = self._worker_summary(w)
            row = {"worker": w,
                   "pid": self.procs[w].pid if w in self.procs else None,
                   "killed": w in self.killed,
                   "exit_code": self.exit_codes.get(w),
                   "wrote_summary": doc is not None}
            per_worker[w] = row
            if doc is None:
                continue
            jobs.extend(doc.get("jobs") or [])
            if isinstance(doc.get("slo"), dict):
                slo_sections[w] = doc["slo"]
            rb = doc.get("rebatch") or {}
            if rb.get("fused"):
                row["rebatch"] = {"rounds": rb.get("rounds", 0),
                                  "events": len(rb.get("events") or [])}
            fleet = doc.get("fleet") or {}
            for k, v in (fleet.get("metrics") or {}).items():
                if isinstance(v, (int, float)):
                    merged[k] = merged.get(k, 0) + v
            # continuous-batching counters are per-worker serve
            # metrics; sum them fleet-wide so the fused A/B and the
            # doctor see one aggregate rebatch/fusion picture
            for k, v in (doc.get("serve") or {}).items():
                if (k.startswith(("route.serve.rebatch.",
                                  "route.serve.fused."))
                        and isinstance(v, (int, float))
                        and not k.endswith((".width",
                                            ".slice_wall_s"))):
                    merged[k] = merged.get(k, 0) + v
        # a gauge is a point-in-time reading, not summable: report the
        # supervisor's own final observation
        merged["route.fleet.workers_alive"] = len(self.alive_workers())
        fleet_slo = self._merge_slo(slo_sections)
        leases = {j: {"worker": d.get("worker"),
                      "state": d.get("state"),
                      "generation": d.get("generation"),
                      "released": bool(d.get("released"))}
                  for j, d in self.leases.scan().items()}
        nets = sum(int(r.get("nets") or 0) for r in jobs
                   if r.get("state") == "done")
        return {
            "scenario": self.opts.scenario or "fleet",
            "jobs": jobs,
            "slo": fleet_slo,
            "fleet": {
                "inbox": self.inbox_dir,
                "roster": self.roster,
                "workers": per_worker,
                "killed": self.killed,
                "expect_jobs": self.opts.expect_jobs,
                "timed_out": self.timed_out,
                "leases": leases,
                "transport": (self.server.summary()
                              if self.server is not None else None),
                "faults": (self.plan.summary()
                           if self.plan is not None else None),
                "worker_chaos": self.worker_chaos,
                "telemetry": self._scrape_telemetry(),
                "trace": self._merge_traces(),
                "metrics": merged,
                "aggregate": {
                    "nets": nets,
                    "wall_s": round(serve_wall_s, 3),
                    "nets_per_s": round(
                        nets / max(serve_wall_s, 1e-9), 3),
                },
            },
        }
