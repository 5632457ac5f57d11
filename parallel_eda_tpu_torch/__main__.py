"""Command-line flow: the port's counterpart of ``python -m parallel_eda_tpu``.

The vpr-binary equivalent (vpr/SRC/main.c:310 + base/ReadOptions.c CLI):

    python -m parallel_eda_tpu_torch circuit.blif --route_chan_width 24
    python -m parallel_eda_tpu_torch --luts 200 --binary_search
    python -m parallel_eda_tpu_torch circuit.blif --place_file out/c.place
    python -m parallel_eda_tpu_torch --luts 25 --arch minimal --device cpu

Flags, defaults, messages and printed lines are the JAX package's
(``parallel_eda_tpu/__main__.py``), so the two CLIs' standard output
compares line by line, seconds aside.  The port's own flag is
``--device {cuda,cpu}``: placement and routing run on the CUDA card
unless it says ``cpu`` (the plain PyTorch versions of the kernels), and
asking for the card without one fails.  ``serve`` runs the route
service (serve/cli.py) and ``daemon`` the route daemon and its fleet
(serve/daemon_cli.py), each with its own flags.  ``--compile_cache_dir``
keeps the built CUDA libraries across runs (route/cuda_lib.py).  What
the port does not do yet fails naming its ROADMAP.md item
(``_SUBCOMMANDS``, empty now).  ``--trace FILE`` writes a Chrome trace
of the whole flow
(exported even when the flow fails) and ``--stats_dir`` also gets the
metrics registry as metrics.json and the route's devprof.json, as in
the JAX CLI.  The route is
pipelined unless ``--sync`` asks for the synchronous driver, as in the
JAX CLI (``RouterOpts.pipeline``; both give the same route).  ``--mesh
NETxNODE`` routes over a (net, node) mesh of NET*NODE devices, as the
JAX CLI does (parallel/shard.py: each step's nets split over the NET
rows of the visible cards, or of NET*NODE copies of the CPU under
``--device cpu``, and each row's canvases by columns over its NODE
devices).
"""

from __future__ import annotations

import argparse
import sys
import time

# what the port does not do yet -> its ROADMAP.md item
_SUBCOMMANDS: dict = {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallel_eda_tpu_torch",
        description="PyTorch/CUDA FPGA place & route (VPR-7-class flow)")
    p.add_argument("blif", nargs="?", help="input BLIF netlist "
                   "(omit to use a synthetic circuit, see --luts)")
    p.add_argument("--arch", default="k6_n10",
                   help="arch: k6_n10 | minimal | path to arch XML")
    # synthetic front end
    p.add_argument("--luts", type=int, default=100,
                   help="synthetic circuit size when no BLIF is given")
    p.add_argument("--seed", type=int, default=1)
    # flow stage selection / resume files
    p.add_argument("--no_place", action="store_true",
                   help="keep the deterministic initial placement")
    p.add_argument("--route", action="store_true", default=True)
    p.add_argument("--no_route", dest="route", action="store_false")
    p.add_argument("--net_file", help="read packed netlist (.net) instead "
                   "of running the packer (the logical netlist is still "
                   "needed for timing: give the same BLIF/--luts)")
    p.add_argument("--place_file", help="read placement instead of placing")
    p.add_argument("--out_dir", default="out",
                   help="directory for .net/.place/.route artifacts")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where placement and routing run: the CUDA card "
                   "(the hand-written kernels; fails without one) or the "
                   "CPU (their plain PyTorch versions)")
    # router opts (names per s_router_opts, vpr_types.h:708-770)
    p.add_argument("--route_chan_width", type=int, default=0,
                   help="fixed channel width (0 = arch default; "
                   "ignored with --binary_search)")
    p.add_argument("--binary_search", action="store_true",
                   help="find minimum routable channel width")
    p.add_argument("--max_router_iterations", type=int, default=50)
    p.add_argument("--initial_pres_fac", type=float, default=0.5)
    p.add_argument("--pres_fac_mult", type=float, default=1.3)
    p.add_argument("--acc_fac", type=float, default=1.0)
    p.add_argument("--bb_factor", type=int, default=3)
    p.add_argument("--astar_fac", type=float, default=1.0,
                   help="A* pruning aggressiveness in the bb-windowed "
                   "search (VPR --astar_fac; 1.0 admissible, >1 faster/"
                   "riskier): RouterOpts.astar_fac, read by the ELL "
                   "program's A* gate; no effect on full-device searches "
                   "or the planes route")
    p.add_argument("--batch_size", type=int, default=64,
                   help="nets routed concurrently (replaces --num_threads)")
    p.add_argument("--sink_group", type=int, default=1,
                   help="sinks per wave: 1 = exact VPR incremental "
                   "trees, 0 = all-sink doubling schedule (the batch "
                   "fast path; pairs with the wirelength finishing "
                   "pass), >1 = grouped middle ground")
    p.add_argument("--crop", default="auto",
                   help="bb-cropped planes relaxation: 'auto' (cost "
                   "model picks per-net tiles), 'off' (full canvases), "
                   "or 'WxH' to force a tile (tuning)")
    p.add_argument("--no_finish", action="store_true",
                   help="skip the wirelength finishing pass (one "
                   "precise multi-sink reroute at convergence; only "
                   "active with --sink_group 0)")
    p.add_argument("--mesh", default="",
                   help="multi-device route mesh 'NETxNODE' (e.g. 4x1): "
                   "splits each step's nets over NET rows and each "
                   "row's canvases by columns over its NODE devices (the "
                   "visible cards; copies of the CPU under --device cpu)")
    p.add_argument("--stats_dir", default="",
                   help="write per-run iter_stats.txt / final_stats.txt "
                   "(the reference's <circuit>_stats_N/ files), "
                   "route_report.txt and the per-window logs/ here "
                   "(windows of one iteration) and the metrics "
                   "snapshots as metrics.json and the per-kernel "
                   "CUDA-event times as devprof.json")
    p.add_argument("--profile", default="",
                   help="capture a torch.profiler trace of routing into "
                   "this dir (a Chrome trace-event JSON; open in "
                   "Perfetto or chrome://tracing)")
    p.add_argument("--trace", default="",
                   help="write a Chrome trace-event JSON of the whole "
                   "flow here (stage, place and route spans; open in "
                   "Perfetto or chrome://tracing)")
    p.add_argument("--sync", action="store_true",
                   help="disable the host/device route pipeline (drain "
                   "every window before further host work); "
                   "bit-identical results, for isolating pipeline issues")
    p.add_argument("--compile_cache_dir", default="",
                   help="persistent compile cache of the built CUDA "
                   "libraries (keyed by source, nvcc command and "
                   "version, and the card's compute capability)")
    p.add_argument("--no_timing", action="store_true",
                   help="congestion-driven only (NO_TIMING algorithm)")
    p.add_argument("--sdc", default="",
                   help="SDC constraints file (create_clock subset, "
                   "read_sdc.c equivalent); enables multi-clock slack")
    p.add_argument("--draw", default="",
                   help="write placement.svg / routing.svg views here "
                   "(the graphics.c/draw.c X11 viewer's batch analogue)")
    # placer opts
    p.add_argument("--moves_per_step", type=int, default=256)
    p.add_argument("--inner_num", type=float, default=1.0)
    p.add_argument("--timing_tradeoff", type=float, default=0.5,
                   help="timing vs wirelength weight in placement "
                   "(0 = pure wirelength)")
    p.add_argument("--power", action="store_true",
                   help="estimate power after routing (power.c "
                        "power_total equivalent)")
    p.add_argument("--gen_postsynthesis_netlist", action="store_true",
                   help="write post-synthesis Verilog + SDF "
                        "(verilog_writer.c equivalent)")
    p.add_argument("--settings_file", default="",
                   help="file of 'flag value' lines used as defaults "
                   "(base/read_settings.c); explicit CLI flags win")
    return p


def apply_settings_file(argv, path: str):
    """Prepend the settings file's options so explicit CLI flags override
    them (read_settings.c semantics: file supplies defaults)."""
    file_args = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            flag = toks[0] if toks[0].startswith("--") else "--" + toks[0]
            file_args.append(flag)
            file_args.extend(toks[1:])
    return file_args + list(argv)


def check_options(args) -> None:
    """Option conflict checking (base/CheckOptions.c / CheckSetup.c):
    reject combinations the flow cannot honor rather than misbehaving,
    and options the port does not have yet, naming their ROADMAP.md
    item."""
    errs = []
    if args.binary_search and args.route_chan_width:
        errs.append("--binary_search ignores --route_chan_width; give "
                    "only one")
    if args.binary_search and not args.route:
        errs.append("--binary_search requires routing (drop --no_route)")
    if args.place_file and args.no_place:
        errs.append("--place_file already skips placement; drop "
                    "--no_place")
    if args.mesh:
        try:
            net_ax, node_ax = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            errs.append(f"--mesh '{args.mesh}' is not NETxNODE")
        else:
            if net_ax < 1 or node_ax < 1:
                errs.append("--mesh axes must be >= 1")
    if args.sink_group < 0:
        errs.append("--sink_group must be >= 0")
    args.crop = args.crop.lower()
    if args.crop not in ("auto", "off"):
        try:
            cw, ch = (int(v) for v in args.crop.split("x"))
            if cw < 1 or ch < 1:
                raise ValueError
        except ValueError:
            errs.append(f"--crop '{args.crop}' is not auto/off/WxH")
        else:
            if args.mesh:
                errs.append("--crop WxH conflicts with --mesh (crops "
                            "are net-local; the sharded path keeps "
                            "full canvases)")
    if args.batch_size < 1:
        errs.append("--batch_size must be >= 1")
    if args.timing_tradeoff < 0 or args.timing_tradeoff > 1:
        errs.append("--timing_tradeoff must be in [0, 1]")
    if args.sdc and args.no_timing:
        errs.append("--sdc needs timing analysis; drop --no_timing")
    if args.profile and not args.route:
        errs.append("--profile traces routing; drop --no_route")
    if errs:
        raise SystemExit("option errors:\n  " + "\n  ".join(errs))


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        # the route service subcommand (serve/cli.py): its own flags
        from .serve.cli import main as serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "daemon":
        # the route daemon subcommand (serve/daemon_cli.py)
        from .serve.daemon_cli import main as daemon_main
        return daemon_main(argv[1:])
    if argv and argv[0] in _SUBCOMMANDS:
        raise SystemExit(f"the '{argv[0]}' subcommand is not ported yet "
                         f"(ROADMAP.md {_SUBCOMMANDS[argv[0]]})")
    for i, a in enumerate(argv):
        try:
            if a == "--settings_file":
                if i + 1 >= len(argv):
                    raise SystemExit("--settings_file expects a path")
                argv = apply_settings_file(argv, argv[i + 1])
                break
            if a.startswith("--settings_file="):
                argv = apply_settings_file(argv, a.split("=", 1)[1])
                break
        except OSError as e:
            raise SystemExit(f"--settings_file: {e}")
    args = build_parser().parse_args(argv)
    check_options(args)
    if args.compile_cache_dir:
        # the whole flow's CUDA libraries (placement launches K1 too)
        from .route.cuda_lib import set_cache_dir
        set_cache_dir(args.compile_cache_dir)

    # one tracer and metrics registry for the whole flow; the trace is
    # exported in a finally, so a failed run keeps its timeline
    from .obs import Tracer, get_metrics, set_tracer
    tracer = None
    if args.trace:
        tracer = Tracer()
        set_tracer(tracer)
    if args.trace or args.stats_dir:
        get_metrics().enabled = True
    try:
        return _run_flow(args)
    finally:
        if args.stats_dir:
            import os
            os.makedirs(args.stats_dir, exist_ok=True)
            mpath = os.path.join(args.stats_dir, "metrics.json")
            get_metrics().dump(mpath)
            print(f"metrics snapshots in {mpath}")
        if tracer is not None:
            set_tracer(None)
            tracer.export(args.trace)
            print(f"trace in {args.trace} (open in Perfetto / "
                  f"chrome://tracing; summarize with "
                  f"tools/trace_report.py)")


def _run_flow(args) -> int:
    from .arch.builtin import k6_n10_arch, minimal_arch
    from .device import resolve_device
    from .flow import (binary_search_route, prepare, run_place, run_route,
                       save_artifacts)
    from .netlist.blif import read_blif
    from .netlist.files import read_net_file, read_place_file
    from .netlist.generate import generate_circuit
    from .place.sa import PlacerOpts
    from .route.router import RouterOpts

    # the card is checked before any work: without one this raises
    device = resolve_device(args.device)
    t_flow = time.time()
    if args.arch == "k6_n10":
        arch = k6_n10_arch()
    elif args.arch == "minimal":
        arch = minimal_arch()
    else:
        from .arch.xml_parser import read_arch_xml
        arch = read_arch_xml(args.arch)

    chan_width = args.route_chan_width or arch.default_chan_width

    if args.blif:
        nl = read_blif(args.blif)
        print(f"read {args.blif}: {nl.stats()}")
    else:
        nl = generate_circuit(num_luts=args.luts, K=arch.K, seed=args.seed)
        print(f"synthetic circuit: {nl.stats()}")

    pnl = None
    if args.net_file:
        pnl = read_net_file(args.net_file, arch)
        print(f"packed netlist read from {args.net_file}")
    flow = prepare(nl, arch, chan_width, seed=args.seed,
                   bb_factor=args.bb_factor, pnl=pnl)
    if args.sdc:
        from .timing.sdc import read_sdc
        flow.sdc = read_sdc(args.sdc)
        per = {c: p / 1e-9 for c, p in flow.sdc.clock_periods.items()}
        print(f"sdc: clock periods (ns) {per}")
    print(f"packed: {flow.pnl.stats()}")
    print(f"grid: {flow.grid.nx} x {flow.grid.ny} "
          f"(pack {flow.times['pack']:.2f}s, "
          f"rr graph {flow.rr.num_nodes} nodes / {flow.rr.num_edges} edges "
          f"{flow.times['rr_graph']:.2f}s)")

    if args.place_file:
        from .rr.terminals import net_terminals
        flow.pos, _, _ = read_place_file(flow.pnl, args.place_file)
        flow.term = net_terminals(flow.pnl, flow.rr, flow.pos,
                                  bb_factor=args.bb_factor)
        print(f"placement read from {args.place_file}")
    elif not args.no_place:
        run_place(flow,
                  PlacerOpts(moves_per_step=args.moves_per_step,
                             inner_num=args.inner_num,
                             timing_tradeoff=args.timing_tradeoff,
                             seed=args.seed),
                  timing_driven=not args.no_timing, device=device)
        s = flow.place_stats
        extra = ""
        if not args.no_timing and args.timing_tradeoff > 0:
            extra = (f", est crit path {s.est_crit_path * 1e9:.2f} ns"
                     f" (lookup {flow.times.get('delay_lookup', 0):.2f}s)")
        print(f"placed: cost {s.initial_cost:.1f} -> {s.final_cost:.1f} "
              f"({len(s.temps)} temps, {s.total_moves} moves, "
              f"{flow.times['place']:.2f}s{extra})")

    if args.route:
        mesh = None
        if args.mesh:
            from .parallel.shard import make_mesh
            net_ax, node_ax = (int(v) for v in args.mesh.lower().split("x"))
            n = net_ax * node_ax
            mesh = make_mesh(n, shape=(net_ax, node_ax),
                             devices=[device] * n if device.type == "cpu"
                             else None)
            print(f"route mesh: {net_ax} net x {node_ax} node devices")
        ropts = RouterOpts(
            max_router_iterations=args.max_router_iterations,
            initial_pres_fac=args.initial_pres_fac,
            pres_fac_mult=args.pres_fac_mult,
            acc_fac=args.acc_fac, bb_factor=args.bb_factor,
            astar_fac=args.astar_fac,
            batch_size=args.batch_size, sink_group=args.sink_group,
            crop=args.crop, finish_precise=not args.no_finish,
            stats_dir=args.stats_dir or None, pipeline=not args.sync,
            compile_cache_dir=args.compile_cache_dir or None)
        import contextlib
        prof = contextlib.nullcontext()
        if args.profile:
            prof = _profiler(args.profile, device)
        with prof:
            if args.binary_search:
                wmin = binary_search_route(
                    flow, ropts, timing_driven=not args.no_timing,
                    device=device, mesh=mesh)
                print(f"binary search: W_min = {wmin}")
            else:
                run_route(flow, ropts, timing_driven=not args.no_timing,
                          device=device, mesh=mesh)
        if args.profile:
            print(f"profiler trace in {args.profile}")
        r = flow.route
        if not r.success:
            print(f"ROUTING FAILED after {r.iterations} iterations "
                  f"({r.stats[-1].overused_nodes} overused nodes)")
            return 1
        print(f"routed: {r.iterations} iterations, "
              f"wirelength {r.wirelength}, "
              f"{flow.times['route']:.2f}s")
        from .route.report import route_report
        print(route_report(flow.rr, r.occ, len(flow.term.net_ids)))
        if not args.no_timing:
            print(f"critical path: {flow.crit_path_delay * 1e9:.3f} ns")
            if flow.sdc is not None:
                ws = flow.analyzer.worst_slack
                print(f"worst slack: {ws * 1e9:.3f} ns "
                      f"({'MET' if ws >= 0 else 'VIOLATED'})")

    if args.draw:
        import os

        from .draw import write_placement_svg, write_routing_svg
        os.makedirs(args.draw, exist_ok=True)
        p1 = os.path.join(args.draw, "placement.svg")
        write_placement_svg(flow, p1)
        drawn = [p1]
        if flow.route is not None and flow.route.occ is not None:
            p2 = os.path.join(args.draw, "routing.svg")
            write_routing_svg(flow, p2)
            drawn.append(p2)
        from .viewer import write_interactive_html
        p3 = os.path.join(args.draw, "viewer.html")
        write_interactive_html(flow, p3)
        drawn.append(p3)
        print("drew " + " ".join(drawn))

    if args.power and flow.route is not None:
        from .power import estimate_power
        print(estimate_power(flow))

    paths = save_artifacts(flow, args.out_dir)
    if args.gen_postsynthesis_netlist:
        from .netlist.verilog import write_post_synthesis
        paths.update(write_post_synthesis(flow, args.out_dir))
    print("wrote " + " ".join(sorted(paths.values())))
    print(f"total flow time {time.time() - t_flow:.2f}s")
    return 0


def _profiler(out_dir: str, device):
    """A torch.profiler session (CPU and, on the card, CUDA activity)
    that writes its Chrome trace into ``out_dir`` when it ends."""
    import os

    import torch

    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(out_dir, "route_trace.json"))

    return torch.profiler.profile(activities=acts, on_trace_ready=write)


if __name__ == "__main__":
    sys.exit(main())
