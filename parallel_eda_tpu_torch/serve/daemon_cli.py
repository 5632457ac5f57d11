"""`python -m parallel_eda_tpu_torch daemon`: the counterpart of the JAX
package's serve/daemon_cli.py, with its flags, plus ``--device``.

Four subcommands around one durable inbox directory:

    # start the long-lived daemon (runs until drained/idle/signaled)
    python -m parallel_eda_tpu_torch daemon run --inbox box/ --luts 10 \
        --exit_when_idle 5 --summary box/summary.json

    # submit work from any process (atomic spec + O_APPEND line)
    python -m parallel_eda_tpu_torch daemon submit --inbox box/ \
        --luts 10 --seed 3 --tenant acme --priority 2

    # liveness + journal peek from outside (no daemon import of state)
    python -m parallel_eda_tpu_torch daemon status --inbox box/

    # N replicated workers over one inbox, with the network transport
    python -m parallel_eda_tpu_torch daemon fleet --inbox box/ \
        --workers 2 --expect_jobs 4 --summary box/fleet.json

``run`` routes on the card unless ``--device cpu``; ``fleet`` spawns
``run`` workers with its own ``--device`` (serve/fleet.py).

`run` prints (and with --summary atomically writes) the summary JSON
that ``tools/flow_doctor.py --daemon-summary`` gates.  A SIGTERM/SIGINT
stops the loop at the next cycle boundary with the journal flushed; a
SIGKILL is the crash the journal + durable checkpoints exist for —
restart with the same --inbox and every in-flight job resumes to a
bit-identical answer.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallel_eda_tpu_torch daemon",
        description="long-lived route daemon: durable inbox, admission "
                    "control, overload shedding, crash-restart recovery")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="start the daemon loop")
    r.add_argument("--inbox", required=True,
                   help="durable inbox directory (submit.jsonl, specs/, "
                   "journal/, ckpt/, heartbeat.json live here)")
    r.add_argument("--luts", type=int, default=10,
                   help="device graph size this daemon serves (all "
                   "jobs must match)")
    r.add_argument("--chan_width", type=int, default=16)
    r.add_argument("--batch_size", type=int, default=32)
    r.add_argument("--max_router_iterations", type=int, default=50)
    r.add_argument("--slice", type=int, default=2, dest="slice_iters",
                   help="router iterations per queue slice (preemption "
                   "grain; also the durable-checkpoint cadence)")
    r.add_argument("--library", default="",
                   help="program library directory (warms the "
                   "admission capacity estimate)")
    r.add_argument("--compile_cache_dir", default="",
                   help="persistent compile cache of the built CUDA "
                   "libraries")
    r.add_argument("--export_library", action="store_true",
                   help="export every dispatch variant seen this run "
                   "(merged pack-shape programs included) into "
                   "--library at shutdown — the warm-up half of the "
                   "warm serving round trip")
    r.add_argument("--runs_dir", default="",
                   help="observatory corpus (also feeds admission "
                   "capacity from recent per-tenant nets/s)")
    r.add_argument("--scenario", default="")
    r.add_argument("--sync", action="store_true")
    r.add_argument("--fused", action="store_true",
                   help="continuous batching: re-pack every runnable "
                   "job into one fused lockstep dispatch per slice "
                   "round, rebatched at each join/finish/evict")
    r.add_argument("--poll_s", type=float, default=0.2)
    r.add_argument("--heartbeat_s", type=float, default=1.0)
    r.add_argument("--slices_per_cycle", type=int, default=4)
    r.add_argument("--admit_horizon_s", type=float, default=600.0)
    r.add_argument("--overload_factor", type=float, default=2.0)
    r.add_argument("--max_queue_depth", type=int, default=64)
    r.add_argument("--aging_rate", type=float, default=0.05,
                   help="queue priority points per waiting second "
                   "(0 = strict priority, starvation possible)")
    r.add_argument("--exit_when_idle", type=int, default=0,
                   help="exit after this many consecutive idle cycles "
                   "(0 = run forever)")
    r.add_argument("--max_cycles", type=int, default=0,
                   help="hard cycle cap (0 = none; tests/smoke)")
    r.add_argument("--summary", default="",
                   help="also write the summary JSON here (atomic)")
    r.add_argument("--worker", default="",
                   help="fleet member id; arms job leases, a "
                   "per-worker journal + heartbeat, and failover")
    r.add_argument("--workers", default="",
                   help="comma-separated fleet roster (all members "
                   "must agree; defaults to just --worker)")
    r.add_argument("--lease_ttl_s", type=float, default=4.0,
                   help="job-lease expiry on the monotonic clock — a "
                   "dead worker's jobs fail over after this long")
    r.add_argument("--foreign_grace_s", type=float, default=2.0,
                   help="wait before claiming a job assigned to a "
                   "peer that never leased it")
    r.add_argument("--chaos", default="",
                   help="seeded fault spec site:count[:horizon],... "
                   "(worker-side sites, e.g. lease.steal)")
    r.add_argument("--chaos_seed", type=int, default=0)
    r.add_argument("--trace", default="",
                   help="write this worker's trace shard here (Chrome "
                   "trace-event JSON, atomically re-exported every "
                   "cycle: job lifecycle spans + clock-sync beacons; "
                   "tools/trace_merge.py aligns shards fleet-wide)")
    r.add_argument("--objectives", default="",
                   help="per-tenant SLO objectives JSON (the "
                   "traffic_gen --objectives fixture): arms error-"
                   "budget burn tracking in the slo.json snapshot "
                   "flow_doctor --slo gates")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="route on the CUDA card (default) or the CPU "
                   "(the plain PyTorch versions of the kernels)")

    s = sub.add_parser("submit", help="submit one synthetic job")
    s.add_argument("--inbox", required=True)
    s.add_argument("--luts", type=int, default=10)
    s.add_argument("--chan_width", type=int, default=16)
    s.add_argument("--seed", type=int, default=1)
    s.add_argument("--name", default="")
    s.add_argument("--tenant", default="default")
    s.add_argument("--priority", type=int, default=0)
    s.add_argument("--deadline_s", type=float, default=0.0)
    s.add_argument("--max_iterations", type=int, default=0)
    s.add_argument("--job_id", default="")

    t = sub.add_parser("status", help="heartbeat + journal peek "
                       "(aggregates every fleet member it finds)")
    t.add_argument("--inbox", required=True)
    t.add_argument("--stale_s", type=float, default=10.0,
                   help="exit 1 when the heartbeat is older than this")
    t.add_argument("--live", action="store_true",
                   help="include each worker's live telemetry snapshot "
                   "(queue depth, in-flight job+slice, held leases, "
                   "last verdicts) from telemetry.<worker>.json")
    t.add_argument("--json", action="store_true",
                   help="print the full machine-readable JSON document "
                   "instead of the human-readable report")

    f = sub.add_parser(
        "fleet", help="spawn + supervise N replicated workers over "
        "one inbox, with the network transport and the fleet chaos "
        "sites (worker.kill, transport.drop, lease.steal)")
    f.add_argument("--inbox", required=True)
    f.add_argument("--workers", type=int, default=2, dest="n_workers")
    f.add_argument("--luts", type=int, default=10)
    f.add_argument("--chan_width", type=int, default=16)
    f.add_argument("--slice", type=int, default=2, dest="slice_iters")
    f.add_argument("--max_router_iterations", type=int, default=50)
    f.add_argument("--library", default="",
                   help="SHARED program library (safe across workers; "
                   "compile caches are per-worker)")
    f.add_argument("--cache_base", default="",
                   help="per-worker compile caches under "
                   "<cache_base>/<worker> — never shared")
    f.add_argument("--runs_dir", default="")
    f.add_argument("--scenario", default="")
    f.add_argument("--sync", action="store_true")
    f.add_argument("--fused", action="store_true",
                   help="every worker runs continuous batching over "
                   "its co-admitted jobs (daemon run --fused)")
    f.add_argument("--heartbeat_s", type=float, default=0.5)
    f.add_argument("--poll_s", type=float, default=0.1)
    f.add_argument("--lease_ttl_s", type=float, default=4.0)
    f.add_argument("--foreign_grace_s", type=float, default=2.0)
    f.add_argument("--exit_when_idle", type=int, default=0)
    f.add_argument("--max_queue_depth", type=int, default=64,
                   help="FLEET-total queue bound, partitioned evenly "
                   "across workers")
    f.add_argument("--chaos", default="",
                   help="seeded fault spec; worker.kill and "
                   "transport.drop run in the supervisor, the rest "
                   "is forwarded to every worker")
    f.add_argument("--chaos_seed", type=int, default=0)
    f.add_argument("--no_transport", action="store_true")
    f.add_argument("--host", default="127.0.0.1")
    f.add_argument("--port", type=int, default=0,
                   help="transport port (0 = ephemeral; the bound "
                   "port is published to <inbox>/transport.json)")
    f.add_argument("--expect_jobs", type=int, default=0,
                   help="drain + exit once this many jobs hold "
                   "released (terminal) leases")
    f.add_argument("--tick_s", type=float, default=0.5)
    f.add_argument("--timeout_s", type=float, default=600.0)
    f.add_argument("--summary", default="",
                   help="write the aggregated fleet summary here "
                   "(atomic); flow_doctor --fleet-summary gates it")
    f.add_argument("--trace", action="store_true",
                   help="every worker writes a per-cycle trace shard "
                   "(trace.<worker>.json); on exit the supervisor "
                   "beacon-aligns them into <inbox>/trace.merged.json "
                   "— one Perfetto timeline, one track per worker, "
                   "job flows connected across failovers")
    f.add_argument("--objectives", default="",
                   help="per-tenant SLO objectives JSON, forwarded to "
                   "every worker; the fleet summary carries the "
                   "merged digests + per-tenant burn")
    f.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="every worker routes on the CUDA card (default) "
                   "or the CPU; a worker that cannot reach its device "
                   "exits and is reported dead")
    return p


def _cmd_run(args) -> int:
    from ..obs.metrics import get_metrics
    from .daemon import DaemonOpts, build_daemon
    from .queue import JobState

    t_start = time.perf_counter()
    get_metrics().enabled = True
    worker = getattr(args, "worker", "")
    trace_path = getattr(args, "trace", "")
    if trace_path:
        # install the process tracer BEFORE any daemon construction so
        # recovery/lease instants of the very first cycle are captured
        from ..obs.trace import Tracer, set_tracer
        set_tracer(Tracer(worker=worker or "daemon"))
    roster = tuple(w for w in getattr(args, "workers", "").split(",")
                   if w) or ((worker,) if worker else ())
    opts = DaemonOpts(
        poll_s=args.poll_s, heartbeat_s=args.heartbeat_s,
        slices_per_cycle=args.slices_per_cycle,
        admit_horizon_s=args.admit_horizon_s,
        overload_factor=args.overload_factor,
        max_queue_depth=args.max_queue_depth,
        aging_rate=args.aging_rate,
        exit_when_idle=args.exit_when_idle,
        fused=getattr(args, "fused", False),
        worker=worker, workers=roster,
        lease_ttl_s=args.lease_ttl_s,
        foreign_grace_s=args.foreign_grace_s,
        trace_path=trace_path,
        objectives_path=getattr(args, "objectives", ""))
    plan = None
    if args.chaos:
        from ..resil.faults import FaultPlan
        plan = FaultPlan.parse(args.chaos_seed, args.chaos)
    daemon = build_daemon(
        args.inbox, luts=args.luts, chan_width=args.chan_width,
        batch_size=args.batch_size,
        max_router_iterations=args.max_router_iterations,
        slice_iters=args.slice_iters,
        library_dir=args.library or None,
        compile_cache_dir=args.compile_cache_dir or None,
        runs_dir=args.runs_dir or None,
        scenario=args.scenario or None,
        opts=opts, fault_plan=plan, sync=args.sync,
        device=args.device)

    def _graceful(signum, frame):
        daemon.request_stop()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    jobs = daemon.run(max_cycles=args.max_cycles)
    exported = 0
    if getattr(args, "export_library", False) and args.library:
        exported = daemon.service.router.export_program_library()
    if trace_path:
        # final shard flush: instants emitted after the last cycle's
        # export (terminal lease releases, drain) must not be lost
        from ..obs.trace import get_tracer
        tr = get_tracer()
        if tr is not None:
            tr.export(trace_path, atomic=True)
    summary = daemon.summary()
    summary["library_exported"] = exported
    summary["wall_s"] = round(time.perf_counter() - t_start, 3)
    blob = json.dumps(summary, default=str)
    if args.summary:
        tmp = args.summary + ".tmp"
        with open(tmp, "w") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.summary)
    print(blob)
    bad = [j for j in jobs
           if j.state in (JobState.FAILED, JobState.TIMEOUT)]
    return 1 if bad else 0


def _cmd_submit(args) -> int:
    from .daemon import submit_job
    spec = {"luts": args.luts, "chan_width": args.chan_width,
            "seed": args.seed,
            "name": args.name or f"l{args.luts}_s{args.seed}"}
    if args.max_iterations:
        spec["max_iterations"] = args.max_iterations
    job_id = submit_job(
        args.inbox, spec, tenant=args.tenant, priority=args.priority,
        deadline_s=args.deadline_s or None,
        job_id=args.job_id or f"{args.tenant}-{spec['name']}")
    print(json.dumps({"job_id": job_id, "inbox": args.inbox}))
    return 0


def _status_doc(args) -> dict:
    from ..resil.journal import Heartbeat, JournalStore
    from .daemon import HEARTBEAT_NAME, TELEMETRY_NAME
    # one inbox may host a solo daemon (heartbeat.json) or a fleet
    # (heartbeat.<worker>.json each): aggregate whatever is there
    hbs, live = {}, {}
    try:
        names = sorted(os.listdir(args.inbox))
    except OSError:
        names = []
    for name in names:
        if name == HEARTBEAT_NAME:
            key = "daemon"
        elif name.startswith("heartbeat.") and name.endswith(".json"):
            key = name[len("heartbeat."):-len(".json")]
        elif name == TELEMETRY_NAME or (name.startswith("telemetry.")
                                        and name.endswith(".json")):
            # the live snapshot carries ts+mono like a heartbeat, so
            # Heartbeat.read ages it with the same NTP-step immunity
            key = "daemon" if name == TELEMETRY_NAME \
                else name[len("telemetry."):-len(".json")]
            live[key] = Heartbeat.read(os.path.join(args.inbox, name))
            continue
        else:
            continue
        hbs[key] = Heartbeat.read(os.path.join(args.inbox, name))
    states = {}
    jdir = os.path.join(args.inbox, "journal")
    jdirs = [jdir] + [os.path.join(jdir, d)
                      for d in (sorted(os.listdir(jdir))
                                if os.path.isdir(jdir) else [])
                      if os.path.isdir(os.path.join(jdir, d))]
    for d in jdirs:
        doc = JournalStore(d).load()
        for e in (doc or {}).get("jobs", {}).values():
            s = e.get("state", "?")
            states[s] = states.get(s, 0) + 1
    alive = {k: hb.get("age_s", float("inf")) <= args.stale_s
             for k, hb in hbs.items()}
    out = {"heartbeats": hbs, "journal_jobs": states,
           "workers_alive": sum(alive.values()),
           "alive": any(alive.values())}
    if getattr(args, "live", False):
        out["live"] = live
    # back-compat: the solo shape keeps its historical top-level key
    if list(hbs) == ["daemon"]:
        out["heartbeat"] = hbs["daemon"]
    return out


def _print_status(out: dict) -> None:
    """Human-readable status report (the --json flag prints the raw
    document instead)."""
    for key, hb in sorted(out["heartbeats"].items()):
        age = hb.get("age_s", float("inf"))
        print(f"{key}: age={age:.2f}s"
              f" src={hb.get('age_src', '?')}"
              f" cycle={hb.get('cycle', '?')}"
              f" queue={hb.get('queue_depth', '?')}"
              f" draining={hb.get('draining', False)}")
    if out.get("journal_jobs"):
        print("journal: " + " ".join(
            f"{s}={n}" for s, n in sorted(out["journal_jobs"].items())))
    for key, t in sorted(out.get("live", {}).items()):
        inf = t.get("in_flight") or {}
        print(f"{key} live: cycle={t.get('cycle', '?')}"
              f" queue={t.get('queue_depth', '?')}"
              f" in_flight={inf.get('job_id', '-')}"
              f"#{inf.get('slice', '-')}"
              f" leases={len(t.get('held_leases') or [])}"
              f" verdicts={len(t.get('last_verdicts') or [])}")
        for v in (t.get("last_verdicts") or [])[-3:]:
            print(f"  {v.get('job_id')}: {v.get('verdict')}"
                  f" (slice {v.get('slice')})")
    print(f"alive: {out['workers_alive']} worker(s)"
          if out["alive"] else "alive: NO live heartbeat")


def _cmd_status(args) -> int:
    out = _status_doc(args)
    if args.json:
        print(json.dumps(out, default=str))
    else:
        _print_status(out)
    return 0 if out["alive"] else 1


def _cmd_fleet(args) -> int:
    from ..obs.metrics import get_metrics
    from .fleet import FleetOpts, FleetSupervisor

    get_metrics().enabled = True
    opts = FleetOpts(
        n_workers=args.n_workers, luts=args.luts,
        chan_width=args.chan_width, slice_iters=args.slice_iters,
        max_router_iterations=args.max_router_iterations,
        library_dir=args.library, cache_base=args.cache_base,
        runs_dir=args.runs_dir, scenario=args.scenario,
        sync=args.sync, fused=args.fused,
        heartbeat_s=args.heartbeat_s,
        poll_s=args.poll_s, lease_ttl_s=args.lease_ttl_s,
        foreign_grace_s=args.foreign_grace_s,
        exit_when_idle=args.exit_when_idle,
        max_queue_depth=args.max_queue_depth,
        chaos_seed=args.chaos_seed, chaos=args.chaos,
        transport=not args.no_transport,
        host=args.host, port=args.port,
        expect_jobs=args.expect_jobs, tick_s=args.tick_s,
        trace=args.trace,
        objectives_path=args.objectives,
        device=args.device)
    sup = FleetSupervisor(args.inbox, opts)
    summary = sup.run(timeout_s=args.timeout_s)
    blob = json.dumps(summary, default=str)
    if args.summary:
        tmp = args.summary + ".tmp"
        with open(tmp, "w") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.summary)
    print(blob)
    # a worker that died on its own (not the chaos kill), e.g. one that
    # could not reach its device at start-up, fails the fleet too
    dead = [w for w, r in summary["fleet"]["workers"].items()
            if not r["killed"] and r["exit_code"] not in (0, None)]
    bad = sup.timed_out or dead or any(
        r.get("state") in ("failed", "timeout")
        for r in summary.get("jobs", []))
    return 1 if bad else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(
        sys.argv[1:] if argv is None else argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "submit":
        return _cmd_submit(args)
    if args.cmd == "fleet":
        return _cmd_fleet(args)
    return _cmd_status(args)


if __name__ == "__main__":
    sys.exit(main())
