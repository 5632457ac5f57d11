"""Flow orchestration: the JAX package's flow.py in part.

``prepare`` and ``synth_flow`` are the host front end — arch -> netlist
-> pack -> grid -> rr graph -> initial placement -> net terminals, all
numpy.  ``run_place`` anneals on the card (or the CPU when asked),
timing-driven by default; ``run_place_native`` anneals with the native
C++ serial placer instead.  ``run_route`` routes the flow on the card
(or the CPU when asked), timing-driven by default, and checks the
result with the legality oracle; ``routes_from_result`` gives the route
trees, ``save_artifacts`` writes the .net / .place / .route files, and
``binary_search_route`` finds the least routable channel width."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .arch.builtin import k6_n10_arch, minimal_arch
from .arch.model import Arch
from .netlist.generate import generate_circuit
from .netlist.netlist import LogicalNetlist
from .netlist.packed import PackedNetlist
from .obs import stage
from .pack.packer import pack_netlist
from .place.delay_lookup import compute_delay_lookup
from .place.initial import initial_placement
from .place.macros import form_macros
from .place.sa import Placer, PlacerOpts, PlaceStats, PlacerTiming
from .route.check import check_route
from .route.router import RouteResult, Router, RouterOpts
from .rr.graph import RRGraph, build_rr_graph
from .rr.grid import DeviceGrid, size_grid
from .rr.terminals import NetTerminals, net_terminals
from .timing.graph import TimingGraph, build_timing_graph
from .timing.sdc import SdcConstraints
from .timing.sta import TimingAnalyzer


@dataclass
class FlowResult:
    """Everything the flow produced."""
    arch: Arch
    nl: LogicalNetlist
    pnl: PackedNetlist
    grid: DeviceGrid
    pos: np.ndarray
    rr: RRGraph
    term: NetTerminals
    tg: Optional[TimingGraph] = None
    analyzer: Optional[TimingAnalyzer] = None
    route: Optional[RouteResult] = None
    place_stats: Optional[PlaceStats] = None
    bb_factor: int = 3
    times: dict = field(default_factory=dict)   # stage -> seconds
    sdc: Optional[SdcConstraints] = None

    @property
    def crit_path_delay(self) -> float:
        return self.analyzer.crit_path_delay if self.analyzer else float(
            "nan")


def prepare(nl: LogicalNetlist, arch: Arch, chan_width: int,
            seed: int = 0, nx: int = 0, ny: int = 0,
            bb_factor: int = 3,
            pnl: Optional[PackedNetlist] = None) -> FlowResult:
    """Front end through initial placement + rr-graph (no SA, no route).
    Pass ``pnl`` to start from a packed netlist instead of packing."""
    times: dict = {}
    with stage("pack", times):
        if pnl is None:
            pnl = pack_netlist(nl, arch)
    n_io = n_clb = 0
    hard_counts: dict = {}
    for i in range(pnl.num_blocks):
        bt = pnl.block_type(i)
        if bt.is_io:
            n_io += 1
        elif bt.name == "clb":
            n_clb += 1
        else:
            hard_counts[bt.name] = hard_counts.get(bt.name, 0) + 1
    grid = size_grid(n_clb, n_io, arch, nx=nx, ny=ny,
                     hard_counts=hard_counts)
    pos = initial_placement(pnl, grid, seed=seed)
    with stage("rr_graph", times):
        rr = build_rr_graph(arch, grid, chan_width=chan_width)
    term = net_terminals(pnl, rr, pos, bb_factor=bb_factor)
    return FlowResult(arch=arch, nl=nl, pnl=pnl, grid=grid, pos=pos,
                      rr=rr, term=term, bb_factor=bb_factor, times=times)


def synth_flow(num_luts: int = 100, num_inputs: int = 8,
               num_outputs: int = 8, chan_width: int = 16, seed: int = 1,
               ff_ratio: float = 0.3, arch: Optional[Arch] = None,
               use_k6: bool = False, bb_factor: int = 3) -> FlowResult:
    """Synthetic-circuit front end (the shared fixture for tests and
    chip_smoke.py)."""
    arch = arch or (k6_n10_arch() if use_k6 else
                    minimal_arch(chan_width=chan_width))
    nl = generate_circuit(num_luts=num_luts, num_inputs=num_inputs,
                          num_outputs=num_outputs, K=arch.K, seed=seed,
                          ff_ratio=ff_ratio)
    return prepare(nl, arch, chan_width, bb_factor=bb_factor)


def run_place_native(flow: FlowResult, seed: int = 7,
                     inner_num: float = 1.0) -> FlowResult:
    """Anneal with the native C++ serial placer (place/serial_sa.py,
    built from the repo's native/serial_sa.cc) and refresh the net
    terminals for the new positions."""
    from .place.serial_sa import serial_sa_place

    with stage("place", flow.times, native=True):
        res = serial_sa_place(flow.pnl, flow.grid, flow.pos, seed=seed,
                              inner_num=inner_num)
        flow.pos = res.pos
    flow.term = net_terminals(flow.pnl, flow.rr, flow.pos,
                              bb_factor=flow.bb_factor)
    return flow


def run_place(flow: FlowResult, opts: Optional[PlacerOpts] = None,
              timing_driven: bool = True, device="cuda") -> FlowResult:
    """SA placement on ``device`` (the card unless the caller asks for
    the CPU); refreshes the net terminals for the new positions.

    Timing-driven mode (at a nonzero ``timing_tradeoff``) builds the
    delay-lookup matrices by routing sample nets
    (timing_place_lookup.c:981) and feeds lookup-delay STA criticalities
    into the annealer's cost (PATH_TIMING_DRIVEN_PLACE).  Stage seconds
    go to ``flow.times["delay_lookup"]`` and ``flow.times["place"]``."""
    timing = None
    opts = opts or PlacerOpts()
    if timing_driven and opts.timing_tradeoff > 0:
        with stage("delay_lookup", flow.times):
            lookup = compute_delay_lookup(flow.rr, device=device)
        if flow.tg is None:
            flow.tg = build_timing_graph(flow.nl, flow.pnl, flow.term)
        timing = PlacerTiming(flow.pnl, lookup, flow.term, flow.tg,
                              td_place_exp=opts.td_place_exp, device=device)
    with stage("place", flow.times):
        macros = (form_macros(flow.nl, flow.pnl) if flow.nl is not None
                  else [])
        placer = Placer(flow.pnl, flow.grid, opts, timing=timing,
                        macros=macros, device=device)
        flow.pos, flow.place_stats = placer.place(flow.pos)
    flow.term = net_terminals(flow.pnl, flow.rr, flow.pos,
                              bb_factor=flow.bb_factor)
    return flow


def routes_from_result(term: NetTerminals, route: RouteResult,
                       num_nodes: int) -> dict:
    """Per-net route trees {packed net index: [(node, parent), ...]} in
    tree order (SOURCE first, parent -1), from the router's per-sink path
    segments (each stored sink -> join node; the join node is already in
    the tree): the .route file payload (route_common.c print_route)."""
    out = {}
    for r, ni in enumerate(term.net_ids):
        src = int(term.source[r])
        rows = [(src, -1)]
        in_tree = {src}
        segs = []
        for s in range(int(term.num_sinks[r])):
            seg = route.paths[r, s]
            seg = seg[seg < num_nodes]
            if seg.size:
                segs.append(seg)
        # segments were grown in criticality-wave order, not sink-slot
        # order: insert each once its join node (seg[-1]) is in the tree
        while segs:
            progressed = False
            rest = []
            for seg in segs:
                if int(seg[-1]) in in_tree:
                    # seg = [sink ... join]; parent of seg[j] is seg[j+1]
                    for j in range(len(seg) - 2, -1, -1):
                        node = int(seg[j])
                        if node in in_tree:
                            continue
                        rows.append((node, int(seg[j + 1])))
                        in_tree.add(node)
                    progressed = True
                else:
                    rest.append(seg)
            if not progressed:
                raise ValueError(
                    f"net {ni}: disconnected route-tree segments")
            segs = rest
        out[int(ni)] = rows
    return out


def save_artifacts(flow: FlowResult, out_dir: str,
                   prefix: Optional[str] = None) -> dict:
    """Write .net / .place / .route (the flow's checkpoint/resume surface;
    vpr_api.c output files).  Returns {kind: path}."""
    import os

    from .netlist.files import (write_net_file, write_place_file,
                                write_route_file)

    os.makedirs(out_dir, exist_ok=True)
    # nl.name may be a file path (BLIF with no .model line): keep only a
    # safe basename so artifacts always land inside out_dir
    base = os.path.basename(prefix or flow.nl.name) or "circuit"
    paths = {}
    p = os.path.join(out_dir, base + ".net")
    write_net_file(flow.pnl, p)
    paths["net"] = p
    p = os.path.join(out_dir, base + ".place")
    write_place_file(flow.pnl, flow.pos, flow.grid.nx, flow.grid.ny, p,
                     net_file=paths["net"])
    paths["place"] = p
    if flow.route is not None:
        routes = routes_from_result(flow.term, flow.route,
                                    flow.rr.num_nodes)
        p = os.path.join(out_dir, base + ".route")
        write_route_file(flow.pnl, flow.rr, routes, p,
                         flow.grid.nx, flow.grid.ny)
        paths["route"] = p
    return paths


def binary_search_route(flow: FlowResult,
                        opts: Optional[RouterOpts] = None,
                        timing_driven: bool = True, max_width: int = 0,
                        device=None, mesh=None) -> int:
    """Find the minimum routable channel width W_min on ``device`` (the
    reference's binary_search_place_and_route, place_and_route.c:432):
    starting from the flow's current width, halve while routable /
    double while not, then bisect the (failed, routed] bracket.  Leaves
    the flow routed at W_min and returns it.  ``opts.mesh_shards``
    shards every attempt's route, and so does ``mesh`` (run_route).

    Each new width builds a new rr graph, so the relaxation kernels'
    launch plans of the old width (which hold its planes graph on the
    device) are dropped before it: the search's device memory stays
    that of one width."""
    from .route.planes_kernels import drop_plans

    last_w = [flow.rr.chan_width if flow.route is not None else -1]

    def attempt(w: int) -> bool:
        if w != flow.rr.chan_width:
            drop_plans()
            flow.rr = build_rr_graph(flow.arch, flow.grid, chan_width=w)
        flow.term = net_terminals(flow.pnl, flow.rr, flow.pos,
                                  bb_factor=flow.bb_factor)
        flow.tg = None          # routed-delay indices depend on term
        flow.analyzer = None
        run_route(flow, opts, timing_driven=timing_driven, verify=False,
                  device=device, mesh=mesh)
        last_w[0] = w
        return flow.route.success

    w = flow.rr.chan_width
    if attempt(w):
        hi = w
        lo = 0                  # nothing known to fail yet
        while hi > 1:
            half = hi // 2
            if attempt(half):
                hi = half
            else:
                lo = half
                break
    else:
        lo = w
        while True:
            w = min(w * 2, max_width) if max_width else w * 2
            if attempt(w):
                hi = w
                break
            lo = w
            if max_width and w >= max_width:
                raise RuntimeError(f"unroutable even at W={w}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if attempt(mid):
            hi = mid
        else:
            lo = mid
    if last_w[0] != hi:
        attempt(hi)             # leave the flow routed at W_min
    check_route(flow.rr, flow.term, flow.route.paths, occ=flow.route.occ)
    return hi


def run_route(flow: FlowResult, opts: Optional[RouterOpts] = None,
              timing_driven: bool = True, verify: bool = True,
              device=None, mesh=None) -> FlowResult:
    """Route the flow on ``device`` (the card unless the caller asks for
    the CPU), then analyse and check it (try_route_new semantics,
    route_common.c:298; check_route, place_and_route.c:169).

    Timing-driven (the default) builds the timing graph and the analyzer
    once per flow and routes with the STA between iterations inside each
    window; the final routed delays are analysed once more, so
    ``flow.crit_path_delay`` is the routed critical path.  ``verify``
    runs the legality oracle on a successful route.

    ``mesh`` (a parallel.shard.Mesh) runs the same negotiation over the
    mesh, both axes (route.Router); ``device`` then defaults to the
    mesh's first member, which holds the route state and runs the
    STA."""
    if device is None:
        device = "cuda" if mesh is None else mesh.devices[0, 0]
    if timing_driven:
        if flow.tg is None:
            flow.tg = build_timing_graph(flow.nl, flow.pnl, flow.term)
        if flow.analyzer is None:
            flow.analyzer = TimingAnalyzer(flow.tg, sdc=flow.sdc,
                                           device=device)
    router = Router(flow.rr, opts, device=device, mesh=mesh)
    with stage("route", flow.times, timing_driven=timing_driven):
        flow.route = router.route(
            flow.term, analyzer=flow.analyzer if timing_driven else None)
    if timing_driven:
        flow.analyzer.analyze(flow.route.sink_delay)
    if verify and flow.route.success:
        check_route(flow.rr, flow.term, flow.route.paths,
                    occ=flow.route.occ)
    return flow
