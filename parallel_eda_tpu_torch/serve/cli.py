"""`python -m parallel_eda_tpu_torch serve`: the counterpart of the JAX
package's serve/cli.py, with its flags and its one-line JSON summary.

Drives the RouteService over N synthetic jobs spread across tenants on
one shared device graph: admit everything, drain the queue, print a
JSON summary (per-job QoR, the route.serve.* telemetry, the dispatch
variant counts and, under --chaos / --checkpoint_dir / --diag_dir, the
resilience section), and optionally export the program library for the
next process.  Routing runs on the card unless ``--device cpu`` (the
port's own flag, as in the main CLI).

Typical round trip:

    # warm-up process: route once, export the program library
    python -m parallel_eda_tpu_torch serve --jobs 1 --luts 15 \
        --library progs/ --export_library --compile_cache_dir cc/

    # serving process: no nvcc build, no new dispatch variant
    python -m parallel_eda_tpu_torch serve --jobs 4 --tenants 2 \
        --luts 15 --library progs/ --compile_cache_dir cc/ --slice 3

``--fused`` drains the queue through continuous batching
(serve/fused.py); ``--chaos`` arms the fault sites, e.g.
``'dispatch.error:2:4,checkpoint.corrupt:1:3'`` with
``--checkpoint_dir ck/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallel_eda_tpu_torch serve",
        description="multi-tenant route service (job queue + AOT "
                    "program library + cross-job packing telemetry)")
    p.add_argument("--jobs", type=int, default=2,
                   help="synthetic jobs to admit")
    p.add_argument("--tenants", type=int, default=2,
                   help="tenants the jobs round-robin across")
    p.add_argument("--luts", type=int, default=15,
                   help="synthetic circuit size per job")
    p.add_argument("--chan_width", type=int, default=16)
    p.add_argument("--seed0", type=int, default=1,
                   help="job j routes the circuit seeded seed0+j")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_router_iterations", type=int, default=50)
    p.add_argument("--slice", type=int, default=0, dest="slice_iters",
                   help="preempt jobs every this many router "
                   "iterations (0 = run each job to completion)")
    p.add_argument("--deadline_s", type=float, default=0.0,
                   help="per-job wall deadline (0 = none)")
    p.add_argument("--retries", type=int, default=0,
                   help="max retry attempts per job")
    p.add_argument("--library", default="",
                   help="program library directory "
                   "(serve/library.py); empty = disabled")
    p.add_argument("--export_library", action="store_true",
                   help="export every dispatch variant seen this run "
                   "into --library after the queue drains")
    p.add_argument("--compile_cache_dir", default="",
                   help="persistent compile cache of the built CUDA "
                   "libraries (keyed by source, nvcc command and "
                   "version, and the card's compute capability)")
    p.add_argument("--runs_dir", default="",
                   help="append per-job corpus rows here "
                   "(obs/runstore.py; tenant-stamped)")
    p.add_argument("--scenario", default="",
                   help="corpus scenario id (default derived from the "
                   "job config)")
    p.add_argument("--sync", action="store_true",
                   help="disable the host-device pipeline")
    p.add_argument("--fused", action="store_true",
                   help="continuous batching: co-admit every runnable "
                   "job into one fused lockstep dispatch per slice "
                   "round, rebatched at each join/finish/evict "
                   "(serve/fused.py)")
    p.add_argument("--stagger", type=int, default=0,
                   help="admit jobs in waves of this many per batch "
                   "round instead of all upfront (exercises rebatch "
                   "joins; 0 = admit everything before running)")
    p.add_argument("--profile", default="uniform",
                   choices=["uniform", "small-heavy"],
                   help="job-size mix (mirrors tools/traffic_gen.py): "
                   "'small-heavy' routes a seeded net SUBSET of each "
                   "non-heavy job's circuit on the same grid "
                   "(rr/terminals.subset_terminals) — the lane-waste "
                   "shape continuous batching recovers")
    p.add_argument("--small_frac", type=float, default=0.15,
                   help="net fraction a small-heavy tiny job routes")
    p.add_argument("--heavy_every", type=int, default=4,
                   help="in small-heavy, every Nth job is full-size")
    p.add_argument("--checkpoint_dir", default="",
                   help="durable crash-safe job checkpoints (resil/"
                   "checkpoint.py): preempted slices flush here and a "
                   "fresh process resumes bit-identically")
    p.add_argument("--diag_dir", default="",
                   help="diagnostic bundles for poisoned jobs "
                   "(default: --checkpoint_dir)")
    p.add_argument("--chaos", default="",
                   help="seeded fault schedule, e.g. "
                   "'dispatch.hang:2:4,backend.loss:1:3' "
                   "(site:count[:horizon], resil/faults.py)")
    p.add_argument("--chaos_seed", type=int, default=7,
                   help="seed the --chaos schedule replays from")
    p.add_argument("--watchdog_s", type=float, default=120.0,
                   help="per-dispatch watchdog budget (resil)")
    p.add_argument("--dispatch_attempts", type=int, default=2,
                   help="attempts per dispatch rung before quarantine")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="route on the CUDA card (default) or the CPU "
                   "(the plain PyTorch versions of the kernels)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(
        sys.argv[1:] if argv is None else argv)
    t_start = time.perf_counter()

    from ..device import resolve_device
    from ..flow import synth_flow
    from ..obs.metrics import get_metrics
    from ..route.router import RouterOpts
    from .service import RouteService, ServeJobSpec

    device = resolve_device(args.device)
    get_metrics().enabled = True
    flows = [synth_flow(num_luts=args.luts,
                        chan_width=args.chan_width,
                        seed=args.seed0 + j)
             for j in range(args.jobs)]
    rr = flows[0].rr
    for j, f in enumerate(flows[1:], 1):
        if f.rr.num_nodes != rr.num_nodes:
            raise SystemExit(
                f"job {j} landed on a different grid "
                f"({f.rr.num_nodes} vs {rr.num_nodes} rr nodes); all "
                f"jobs must share one device graph — same --luts/"
                f"--chan_width")

    scenario = args.scenario or (
        f"serve_l{args.luts}_w{args.chan_width}_j{args.jobs}")
    opts = RouterOpts(
        batch_size=args.batch_size,
        max_router_iterations=args.max_router_iterations,
        sink_group=0, pipeline=not args.sync,
        compile_cache_dir=args.compile_cache_dir or None,
        program_library_dir=args.library or None)
    resil = None
    if args.chaos or args.checkpoint_dir or args.diag_dir:
        from ..resil import FaultPlan, ResilOpts
        resil = ResilOpts(
            fault_plan=(FaultPlan.parse(args.chaos_seed, args.chaos)
                        if args.chaos else None),
            checkpoint_dir=args.checkpoint_dir or None,
            diag_dir=args.diag_dir or None,
            watchdog_s=args.watchdog_s,
            dispatch_attempts=args.dispatch_attempts)
    svc = RouteService(
        rr, opts, slice_iters=args.slice_iters,
        runs_dir=args.runs_dir or None, scenario=scenario,
        cfg=dict(luts=args.luts, chan_width=args.chan_width,
                 jobs=args.jobs, batch=args.batch_size,
                 slice=args.slice_iters),
        resil=resil, fused=args.fused, device=device)

    terms = {}
    if args.profile == "small-heavy":
        # seeded tiny-job subsets, fixed before any admission (the
        # same plan-fixed-before-delivery contract traffic_gen keeps)
        import random as _random

        from ..rr.terminals import subset_terminals
        rng = _random.Random(args.seed0)
        he = max(1, args.heavy_every)
        for j, f in enumerate(flows):
            frac = round(args.small_frac * rng.uniform(0.6, 1.4), 4)
            sub_seed = rng.randrange(1, 10_000)
            if j % he != he - 1:
                terms[j] = subset_terminals(f.term, frac, seed=sub_seed)

    def _admit(j, f):
        svc.admit(
            ServeJobSpec(term=terms.get(j, f.term),
                         name=f"l{args.luts}_s{args.seed0 + j}"
                              + ("_tiny" if j in terms else ""),
                         max_iterations=args.max_router_iterations),
            tenant=f"t{j % max(1, args.tenants)}",
            deadline_s=args.deadline_s or None,
            max_retries=args.retries)

    pending = list(enumerate(flows))
    first = (len(pending) if args.stagger <= 0
             else min(args.stagger, len(pending)))
    for j, f in pending[:first]:
        _admit(j, f)
    del pending[:first]
    if pending:
        # staggered stream: the next wave joins at each slice
        # boundary, exercising the rebatch path mid-drain
        def _admit_wave():
            for j, f in pending[:args.stagger]:
                _admit(j, f)
            del pending[:args.stagger]

        if args.fused:
            inner_b = svc._batch_runner

            def _wrapped_batch(batch):
                out = inner_b(batch)
                _admit_wave()
                return out
            svc._batch_runner = _wrapped_batch
        else:
            inner_r = svc._runner

            def _wrapped_runner(job):
                out = inner_r(job)
                _admit_wave()
                return out
            svc._runner = _wrapped_runner

    jobs = svc.run()
    exported = 0
    if args.export_library and args.library:
        exported = svc.router.export_program_library()

    m = get_metrics()
    serve_vals = m.values("route.serve.")
    summary = {
        "scenario": scenario,
        "jobs": [
            {"job_id": j.job_id, "tenant": j.tenant,
             "state": j.state.value,
             "preemptions": j.preemptions, "slices": j.slices,
             "error": j.error,
             "failure_reason": j.failure_reason,
             **({k: v for k, v in j.result.items()
                 if k != "result"} if isinstance(j.result, dict)
                else {})}
            for j in jobs],
        "dispatch_compiles": m.counter(
            "route.dispatch.compiles").value,
        "dispatch_cache_hits": m.counter(
            "route.dispatch.cache_hits").value,
        "serve": serve_vals,
        "rebatch": svc.rebatch_summary(),
        "library_exported": exported,
        "wall_s": round(time.perf_counter() - t_start, 3),
    }
    if svc.resil is not None:
        summary["resil"] = {
            "metrics": m.values("route.resil."),
            "ladder": svc.resil.ladder.snapshot(),
            "faults": (svc.resil.plan.summary()
                       if svc.resil.plan is not None else None),
        }
    print(json.dumps(summary, default=str))
    return 0 if all(j.state.value == "done" for j in jobs) else 1


if __name__ == "__main__":
    sys.exit(main())
