"""Negotiated-congestion (PathFinder) routing driver for the planes
program: the counterpart of parallel_eda_tpu/route/router.py.

The PathFinder outer loop runs on the host as a sequence of WINDOWS;
each window is ``planes.route_window_planes`` over every populated rung
of the bounding-box crop ladder (smallest tiles first, the full canvas
last), and the host reads back one packed status word per net plus a
scalar summary per window, from which it decides convergence, plateau
widening, sweep-budget promotion and the next window's batch plan.

This driver is the synchronous one (``pipeline=False`` in the JAX
package, bit-identical to its pipelined mode by construction).  Options
the port does not implement yet raise NotImplementedError naming their
ROADMAP.md item when set to a non-default value.

Reduced-precision planes (``plane_dtype="bf16"``) follow the JAX
package's ``dtype_guard``: "off" commits the bf16 relaxation; "window"
commits the f32 route and replays every window in bf16 on copies of the
window-entry state (the shadow), whose packed summary must stay within
the band of ``_dtype_band_ok`` or the route stops shadowing (a
demotion); "route" shadows only until the first window within the band.
The resilience ladder's "dtype" step is not ported (ROADMAP.md A13).

``stats_dir`` is the diagnostics mode, as in the JAX package: windows of
one iteration, iter_stats.txt / final_stats.txt (``write_stats_files``)
and route_report.txt in that directory, the per-(window, category)
records of ``mdclog.MdcLogger`` under its logs/, and, with
``dump_routes``, every iteration's routes (routes_iter_N.txt).  The JAX
package's metrics.json and devprof.json there come from its obs/
package, which is not ported (ROADMAP.md A13).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..rr.graph import RRGraph
from ..rr.terminals import NetTerminals
from .device_graph import DeviceRRGraph, to_device
from .search import wirelength_on_device


def normalize_crop(value) -> str:
    """Validate + normalize a crop knob ('auto' | 'off' | 'WxH')."""
    s = str(value).strip().lower()
    if s in ("auto", "off"):
        return s
    parts = s.split("x")
    try:
        if len(parts) == 2 and int(parts[0]) > 0 and int(parts[1]) > 0:
            return s
    except ValueError:
        pass
    raise ValueError(
        f"crop must be 'auto', 'off', or 'WxH' (got {value!r})")


@dataclass
class RouterOpts:
    """The JAX package's RouterOpts: same field names and defaults
    (s_router_opts, vpr_types.h:708-770, with SetupVPR.c defaults),
    except ``pipeline``, which defaults to False — the port's driver is
    the synchronous one.  See the JAX package for each knob's meaning."""
    max_router_iterations: int = 50
    initial_pres_fac: float = 0.5
    pres_fac_mult: float = 1.3
    acc_fac: float = 1.0
    bb_factor: int = 3
    batch_size: int = 64          # nets routed concurrently
    program: str = "planes"       # "ell" is not ported yet
    sink_group: int = 0           # 0 = all sinks per wave (doubling)
    max_pres_fac: float = 1000.0
    incremental_after: int = 1
    windowed: bool = True         # ELL-program knob (inert for planes)
    window_max_frac: float = 0.7
    window_max_bytes: int = 4 << 30
    astar_fac: float = 1.0
    plateau_iters: int = 8
    stats_dir: Optional[str] = None
    dump_routes: bool = False
    checkpoint_every: int = 0
    slice_iterations: int = 0
    crop: str = "auto"            # "auto" | "off" | "WxH"
    sweep_budget_div: int = 3
    finish_precise: bool = True
    pipeline: bool = False
    compile_cache_dir: Optional[str] = None
    congestion_topk: int = 8
    program_library_dir: Optional[str] = None
    resil: Optional[object] = None
    plane_dtype: str = "f32"
    dtype_guard: str = "window"
    fused_dispatch: bool = False
    mesh_shards: int = 1


# option -> (default, ROADMAP.md item that ports it)
_NOT_PORTED = {
    "pipeline": (False, "A6 (pipelined window driver)"),
    "resil": (None, "A13 (resilience wiring)"),
    "program_library_dir": (None, "A14 (serve stack / kernel cache)"),
    "compile_cache_dir": (None, "A14 (serve stack / kernel cache)"),
    "fused_dispatch": (False, "A12 (fused ragged dispatch)"),
    "checkpoint_every": (0, "A6 (checkpoint / slicing)"),
    "slice_iterations": (0, "A6 (checkpoint / slicing)"),
    "program": ("planes", "A11 (ELL program)"),
}


DTYPE_GUARDS = ("window", "route", "off")


def _check_ported(opts: RouterOpts) -> None:
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(opts, name) != default:
            raise NotImplementedError(
                f"RouterOpts.{name}={getattr(opts, name)!r} is not ported "
                f"yet (ROADMAP.md {item})")


def _check_plane_dtype(opts: RouterOpts) -> None:
    """The JAX Router's ValueErrors for a bad plane_dtype / dtype_guard."""
    from .planes import PLANE_DTYPES

    if str(opts.plane_dtype) not in PLANE_DTYPES:
        raise ValueError(
            f"plane_dtype must be one of {PLANE_DTYPES} "
            f"(got {opts.plane_dtype!r})")
    if str(opts.dtype_guard) not in DTYPE_GUARDS:
        raise ValueError(
            "dtype_guard must be 'window', 'route', or 'off' "
            f"(got {opts.dtype_guard!r})")


# bf16 shadow acceptance band (RouterOpts.dtype_guard): the fraction of
# per-net status words allowed to disagree with the committed f32
# window, and the relative tolerance on the scalar congestion summary
DTYPE_GUARD_STATUS_FRAC = 0.02
DTYPE_GUARD_SCAL_RTOL = 0.05


def _dtype_band_ok(status_f32, scal_f32, status_bf16, scal_bf16,
                   status_frac: Optional[float] = None,
                   scal_rtol: Optional[float] = None) -> bool:
    """Band compare of a window's bf16 shadow summary against the
    committed f32 window (module level, so a test can force a
    violation).  At most ``status_frac`` of the per-net status words may
    differ, and the scalar summary (N_OVER, OVER_TOTAL, NROUTES, NEXEC,
    MAX_SPAN) must agree to a relative tolerance with an absolute floor
    of 1; the sweep counters are left out (reaching the fixpoint a sweep
    earlier or later is a legitimate reduced-precision outcome)."""
    if status_frac is None:
        status_frac = DTYPE_GUARD_STATUS_FRAC
    if scal_rtol is None:
        scal_rtol = DTYPE_GUARD_SCAL_RTOL
    st_a = np.asarray(status_f32)
    st_b = np.asarray(status_bf16)
    if st_a.size and float((st_a != st_b).mean()) > status_frac:
        return False
    a = np.asarray(scal_f32, dtype=np.float64)[:5]
    b = np.asarray(scal_bf16, dtype=np.float64)[:5]
    tol = np.maximum(1.0, scal_rtol * np.abs(a))
    return bool((np.abs(a - b) <= tol).all())


# how many overused rr-node ids each window's congestion record lists
_CONGESTION_TOPK = 8


def _top_overused(occ, capacity, k: int = _CONGESTION_TOPK) -> list:
    """Top-k overused rr-node ids for the mdclog congestion record:
    [[node_id, overuse], ...] sorted by overuse descending, only nodes
    with occ > capacity."""
    over = np.asarray(occ).astype(np.int64) - np.asarray(capacity)
    k = min(int(k), over.size)
    if k <= 0:
        return []
    idx = np.argpartition(over, -k)[-k:]
    idx = idx[np.argsort(-over[idx], kind="stable")]
    return [[int(i), int(over[i])] for i in idx if over[i] > 0]


def write_stats_files(stats_dir: str, result: "RouteResult") -> None:
    """Emit iter_stats.txt / final_stats.txt in the reference's schema
    (partitioning_multi_sink_delta_stepping_route.cxx:5925-5935 header +
    :6307-6318 rows; :6344-6360 final) so runs can be diffed against the
    reference's own output files."""
    import os

    os.makedirs(stats_dir, exist_ok=True)
    with open(os.path.join(stats_dir, "iter_stats.txt"), "w") as f:
        f.write("iteration route_time relax_steps batches rerouted_nets "
                "overused_nodes overuse_total overuse_pct crit_path_delay\n")
        for s in result.stats:
            f.write(f"{s.iteration} {s.route_time_s:.6f} {s.relax_steps} "
                    f"{s.batches} {s.rerouted_nets} {s.overused_nodes} "
                    f"{s.overuse_total} {s.overuse_pct:.4f} "
                    f"{s.crit_path_delay:.6e}\n")
    with open(os.path.join(stats_dir, "final_stats.txt"), "w") as f:
        f.write(f"routed {int(result.success)}\n")
        f.write(f"num_iterations {result.iterations}\n")
        f.write(f"total_route_time "
                f"{sum(s.route_time_s for s in result.stats):.6f}\n")
        f.write(f"total_relax_steps {result.total_relax_steps}\n")
        f.write(f"total_relax_steps_useful "
                f"{result.total_relax_steps_useful}\n")
        f.write(f"total_relax_steps_wasted "
                f"{result.total_relax_steps_wasted}\n")
        f.write(f"total_net_routes {result.total_net_routes}\n")
        f.write(f"wirelength {result.wirelength}\n")
        # the converged iteration breaks out before its timing callback,
        # so report the last stamped crit-path value
        cpd = float("nan")
        for s in reversed(result.stats):
            if s.crit_path_delay == s.crit_path_delay:
                cpd = s.crit_path_delay
                break
        f.write(f"final_crit_path_delay {cpd:.6e}\n")


def _dump_routes(stats_dir: str, it: int, paths: np.ndarray,
                 N: int) -> None:
    """routes_iter_N.txt per-iteration dump (…cxx:6167 diagnostics):
    one line per (net, sink) with the node path sink->tree."""
    import os

    os.makedirs(stats_dir, exist_ok=True)
    with open(os.path.join(stats_dir, f"routes_iter_{it}.txt"), "w") as f:
        R, S, _ = paths.shape
        for r in range(R):
            for s in range(S):
                seg = paths[r, s]
                seg = seg[seg < N]
                if seg.size:
                    f.write(f"{r} {s}: " +
                            " ".join(str(v) for v in seg) + "\n")


@dataclass
class RouteStats:
    """Per-window stats row (iter_stats.txt schema)."""
    iteration: int
    overused_nodes: int
    overuse_total: int
    rerouted_nets: int
    route_time_s: float
    relax_steps: int = 0
    batches: int = 0
    overuse_pct: float = 0.0
    crit_path_delay: float = float("nan")


@dataclass
class RouteResult:
    success: bool
    iterations: int
    paths: np.ndarray            # [R, Smax, Lmax] int32, sentinel N = pad
    sink_delay: np.ndarray       # [R, Smax] f32
    occ: np.ndarray              # [N] int32 final occupancy
    wirelength: int
    stats: List[RouteStats] = field(default_factory=list)
    total_net_routes: int = 0
    total_relax_steps: int = 0
    total_relax_steps_useful: int = 0
    total_relax_steps_wasted: int = 0
    total_relax_steps_cropped: int = 0
    widened_nets: int = 0
    windowed_nets: int = 0


def _median_cut_bins(pts_x: np.ndarray, pts_y: np.ndarray,
                     depth: int = 4) -> np.ndarray:
    """Recursive median cuts over net centers: every leaf holds about
    the same NUMBER of nets.  Deterministic."""
    n = len(pts_x)
    bins = np.zeros(n, dtype=np.int64)

    def cut(sel: np.ndarray, d: int, vert: bool) -> None:
        if d == 0 or sel.size <= 1:
            return
        vals = pts_x[sel] if vert else pts_y[sel]
        left = vals <= np.median(vals)
        if left.all() or not left.any():
            order = np.argsort(vals, kind="stable")
            left = np.zeros(sel.size, dtype=bool)
            left[order[: sel.size // 2]] = True
        bins[sel[~left]] += 1 << (d - 1)
        cut(sel[left], d - 1, not vert)
        cut(sel[~left], d - 1, not vert)

    cut(np.arange(n), depth, True)
    return bins


def _spatial_order(idx: np.ndarray, cx: np.ndarray, cy: np.ndarray,
                   depth: int = 4) -> np.ndarray:
    """Order nets so consecutive ones come from different regions of the
    device (median-cut leaves dealt round-robin)."""
    if len(idx) <= 1:
        return idx
    bins = _median_cut_bins(cx[idx], cy[idx], depth)
    order = np.argsort(bins, kind="stable")
    sorted_bins = bins[order]
    _, starts = np.unique(sorted_bins, return_index=True)
    within = np.arange(len(order)) - starts[
        np.searchsorted(sorted_bins[starts], sorted_bins)]
    deal = np.lexsort((sorted_bins, within))
    return idx[order[deal]]


def _order_and_chunk(g, nsinks, cx, cy, B):
    """Batch formation: fanout classes, spatial round-robin within a
    class, chunked to B."""
    if len(g) == 0:
        return []
    cls = np.ceil(np.log2(np.maximum(
        1, nsinks[g]).astype(float))).astype(np.int64)
    ordered = np.concatenate([
        _spatial_order(g[cls == c], cx, cy)
        for c in sorted(set(cls.tolist()), reverse=True)])
    return [ordered[lo:lo + B] for lo in range(0, len(ordered), B)]


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _size_class_buckets(need_w: np.ndarray, need_h: np.ndarray,
                        nx: int, ny: int, min_count: int = 1,
                        base: int = 8, full_frac: float = 0.8):
    """Bin nets into pow-2 size-class crop buckets (ladder base, 2*base,
    ... clamped to the grid, stopping at the first rung that covers the
    grid or reaches ``full_frac`` of its area).  Each net gets the
    smallest rung fitting both spans; rungs with fewer than
    ``min_count`` nets merge upward.  Returns (classes, assign) with
    assign == len(classes) meaning the full canvas."""
    n = len(need_w)
    ladder = []
    s = base
    while True:
        cw, ch = min(nx, s), min(ny, s)
        if cw * ch >= full_frac * nx * ny or (cw == nx and ch == ny):
            break
        ladder.append((cw, ch))
        s *= 2
    assign = np.full(n, len(ladder), dtype=np.int64)
    for k in range(len(ladder) - 1, -1, -1):
        cw, ch = ladder[k]
        assign[(need_w <= cw) & (need_h <= ch)] = k
    for k in range(len(ladder)):
        cnt = int((assign == k).sum())
        if 0 < cnt < min_count:
            assign[assign == k] = k + 1
    used = [k for k in range(len(ladder)) if (assign == k).any()]
    lut = np.full(len(ladder) + 1, len(used), dtype=np.int64)
    for j, k in enumerate(used):
        lut[k] = j
    return [ladder[k] for k in used], lut[assign]


def path_budget(span: int, cap: int) -> int:
    """Path-slot budget for a bb half-perimeter ``span``: ~2x the span
    plus winding slack, bucketed to 64, capped at the device budget."""
    return min(cap, ((2 * span + 64 + 63) // 64) * 64)


def _grow_paths(paths, L_new: int, N: int):
    return torch.nn.functional.pad(paths, (0, L_new - paths.shape[2]),
                                   value=N)


# route_window_planes' positional arguments that are the window state
# (occ, acc, paths, sink_delay, all_reached, bb, crit_all)
_SHADOW_SLOTS = (2, 3, 4, 5, 6, 7, 10)


def _shadow_window(rungs, state):
    """The bf16 shadow of a window (JAX router.py:2161-2181): the same
    route_window_planes calls ``rungs`` ((args, kwargs) per rung), each
    on the state the previous one left, from ``state`` (copies of the
    window-entry state, updated in place), with plane_dtype="bf16".
    Returns the last rung's (status, scal) as numpy arrays."""
    from .planes import route_window_planes

    for args, kw in rungs:
        a = list(args)
        for slot, t in zip(_SHADOW_SLOTS, state):
            a[slot] = t
        occ, acc, status, scal, _ = route_window_planes(
            *a, plane_dtype="bf16", **kw)
        state[0], state[1] = occ, acc
    return status.cpu().numpy(), scal.cpu().numpy()


class Router:
    """Holds the device graph across route() calls.  ``device`` defaults
    to ``cuda`` (raises without a card); pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels.

    ``opts.mesh_shards > 1`` shards the relaxation by canvas columns
    (route/planes_shard.py) over that many shards placed round-robin on
    the visible devices of ``device``'s type: ``row_mesh``.  ``metrics``
    holds, under the JAX package's metric names, the halo ledger: the
    counters ``route.mesh.halo_bytes`` and ``route.mesh.halo_exchanges``
    add up over the Router's routes, the gauges ``route.mesh.n_shards``
    and ``route.mesh.overlap_frac`` hold the last window's values; and
    the plane dtype: the counter ``route.kernel.dtype_demotions`` (bf16
    shadows that left the band) and the gauge
    ``route.kernel.plane_dtype`` ("bf16" while a bf16 route is not
    demoted, else "f32")."""

    # escalating sync schedule: window sizes between host round trips
    _WINDOWS = (2, 2, 3, 4, 5, 6, 8, 10, 10)

    def __init__(self, rr: RRGraph, opts: Optional[RouterOpts] = None,
                 device=None):
        self.rr = rr
        self.opts = opts or RouterOpts()
        _check_ported(self.opts)
        self.device = resolve_device(device)
        from .lookahead import build_lookahead
        from .planes import build_planes

        la = build_lookahead(rr)
        self._lmin_seg = tuple(
            int(la.len_same[la.axis == a].min())
            if (la.axis == a).any() else 1 for a in (0, 1))
        self.dev: DeviceRRGraph = to_device(rr, self.device)
        nx, ny = rr.grid.nx, rr.grid.ny
        # path-length bound: a bb-confined path can wind, give slack
        self.max_len = 4 * (nx + ny) + 64
        if rr.wire_switch_of_track is None:
            raise ValueError("program='planes' needs a graph built by "
                             "rr.graph.build_rr_graph (track switch map)")
        self.pg = build_planes(rr, self.device)
        self._pt_key = None
        # lag 1 ("ppermute") on every device.  Lag 2 ("pallas_halo")
        # pays extra sweeps for a transfer that can land behind the next
        # sweep, and here each shard's transfer shares its sweep's
        # stream, so nothing overlaps and lag 2 is only slower on the
        # card (chip_smoke.py's mesh lines time both).  The JAX mesh
        # ladder (pallas_halo -> ppermute -> single chip) is not
        # ported: a failure raises.
        self.row_mesh = None
        self.metrics: dict = {}
        if self.opts.mesh_shards > 1:
            from .planes_shard import make_row_mesh
            self.row_mesh = make_row_mesh(self.opts.mesh_shards, "ppermute",
                                          self.device)

    def _book_halo(self, scal, batch: int, plane_dtype: str) -> None:
        """The halo ledger of one window (JAX router.py:1191-1233): each
        executed sweep exchanged one halo round per internal boundary,
        at the byte volume of the window's plan width ``batch`` in the
        committed relaxation's plane dtype."""
        from .planes import SCAL_S_EXEC
        from .planes_shard import halo_bytes_per_sweep, modeled_overlap_frac

        rm, m = self.row_mesh, self.metrics
        sweeps = int(scal[SCAL_S_EXEC])
        m["route.mesh.halo_bytes"] = (
            m.get("route.mesh.halo_bytes", 0)
            + halo_bytes_per_sweep(self.pg, batch, rm.n_shards,
                                   plane_dtype) * sweeps)
        m["route.mesh.halo_exchanges"] = (
            m.get("route.mesh.halo_exchanges", 0)
            + (rm.n_shards - 1) * sweeps)
        m["route.mesh.n_shards"] = rm.n_shards
        m["route.mesh.overlap_frac"] = modeled_overlap_frac(
            self.pg, batch, rm.n_shards, rm.impl, rm.n_cards > 1,
            plane_dtype)

    def _log_window(self, mlog, widx, it_done, K, ndirty, nexec, w_steps,
                    n_over, over_total, pres, widened, occ, colors, rrm,
                    precise, sweep_boost, cpd, dmax_hist) -> None:
        """The mdclog records of one committed window (JAX router.py
        :1252-1270): route, congestion, schedule and, when timed,
        timing."""
        k = self.opts.congestion_topk
        top = _top_overused(occ.cpu().numpy(),
                            self.dev.capacity.cpu().numpy(),
                            k=k if k > 0 else _CONGESTION_TOPK)
        mlog.set_mdc(widx)
        mlog.log("route", iteration=it_done, K=K, rerouted=ndirty,
                 groups=nexec, relax_steps=w_steps)
        mlog.log("congestion", overused_nodes=n_over,
                 overuse_total=over_total, pres_fac=round(pres, 4),
                 widened=widened, top_overused=top)
        mlog.log("schedule",
                 colors=int(np.max(colors) + 1
                            if colors is not None and len(colors) else 0),
                 dirty_next=int(rrm.sum()), precise=precise,
                 sweep_boost=sweep_boost)
        if cpd == cpd:
            mlog.log("timing", crit_path_delay=cpd,
                     dmax_hist=[None if d != d else float(d)
                                for d in dmax_hist.cpu().tolist()])

    def _planes_terminals(self, term):
        """Terminal tables for ``term`` as device tensors, cached on
        id(term) across route() calls."""
        if self._pt_key != id(term):
            from .planes import build_planes_terminals
            pt = build_planes_terminals(
                self.rr, term.source, term.sinks,
                self.pg.cell_of_node.cpu().numpy(), self.pg.ncells)
            self._pt = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in pt.tables())
            self._pt_key = id(term)
            self._pt_ref = term          # keep id(term) alive
        return self._pt

    def _plan_groups(self, dirty: np.ndarray, colors: Optional[np.ndarray],
                     nsinks: np.ndarray, cx: np.ndarray, cy: np.ndarray,
                     B: int):
        """Static batch plan [G, B_g] for a window: dirty nets split by
        conflict colour, then fanout class, spatially round-robined,
        chunked to B; plan width narrowed to the largest chunk (pow-2,
        floor 8); group count padded to a power of two."""
        batches = []
        if colors is None or len(dirty) <= 1:
            groups = [dirty]
        else:
            cd = colors[dirty]
            groups = [dirty[cd == c] for c in np.unique(cd)]
        for g in groups:
            batches.extend(_order_and_chunk(g, nsinks, cx, cy, B))
        if not batches:
            batches = [np.zeros(0, dtype=np.int64)]
        B_g = min(B, max(8, _pow2_at_least(max(len(b) for b in batches))))
        G = _pow2_at_least(len(batches))
        sel_plan = np.zeros((G, B_g), dtype=np.int32)
        valid_plan = np.zeros((G, B_g), dtype=bool)
        for i, b in enumerate(batches):
            sel_plan[i, :len(b)] = b
            valid_plan[i, :len(b)] = True
        return sel_plan, valid_plan

    def _t(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def route(self, term: NetTerminals, crit: Optional[np.ndarray] = None,
              timing_cb=None, analyzer=None,
              resume=None) -> RouteResult:
        """Route all nets.  ``crit`` [R, Smax] per-sink criticalities
        (None or 0 => congestion-driven), clamped at 0.99.

        ``analyzer`` (timing.sta.TimingAnalyzer on this Router's device)
        runs the full STA between iterations inside each window program
        (multi-iteration windows; criticalities never visit the host)
        and leaves each window's critical-path delay in its stats row and
        in ``analyzer.crit_path_delay``.  ``timing_cb``, without an
        analyzer, is called on the host after every iteration (windows of
        one iteration) with the current result and returns the next
        criticalities (router.cxx:28,42).  ``resume`` is not ported yet
        (ROADMAP.md A6) and raises when given."""
        if resume is not None:
            raise NotImplementedError(
                "resume is not ported yet (ROADMAP.md A6)")
        opts = self.opts
        _check_ported(opts)
        _check_plane_dtype(opts)
        crop = normalize_crop(opts.crop)
        rr = self.rr
        R, Smax = term.sinks.shape
        N = rr.num_nodes
        B = min(opts.batch_size, max(1, R))
        if analyzer is not None and \
                analyzer.dev.device != self.dev.capacity.device:
            raise ValueError(
                f"the analyzer's timing graph is on {analyzer.dev.device}, "
                f"the Router on {self.dev.capacity.device}")
        if crit is None:
            crit = np.zeros((R, Smax), dtype=np.float32)
        else:
            # max_criticality clamp (VPR --max_criticality 0.99): a crit
            # of 1 would zero the congestion term and stall negotiation
            crit = np.minimum(np.asarray(crit, dtype=np.float32), 0.99)
        occ = torch.zeros(N, dtype=torch.int32, device=self.device)
        acc = torch.ones(N, dtype=torch.float32, device=self.device)
        span0 = (int(((term.bb_xmax - term.bb_xmin)
                      + (term.bb_ymax - term.bb_ymin)).max()) if R else 8)
        L = path_budget(span0, self.max_len)
        paths = torch.full((R, Smax, L), N, dtype=torch.int32,
                           device=self.device)
        sink_delay = torch.full((R, Smax), float("inf"),
                                dtype=torch.float32, device=self.device)
        all_reached = torch.zeros(R, dtype=torch.bool, device=self.device)
        bb = self._t(np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                               term.bb_ymax], axis=1).astype(np.int32))
        full_bb = self._t(np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1],
                                   dtype=np.int32))
        result = RouteResult(False, 0, None, None, None, 0)
        from ..mdclog import MdcLogger

        # per-(window, category) records: a no-op without stats_dir
        with MdcLogger(opts.stats_dir) as mlog:
            result = self._route_planes_windows(
                term, crit, timing_cb, analyzer, occ, acc, paths,
                sink_delay, all_reached, bb, full_bb, result, B, crop, mlog)
        if opts.stats_dir:
            import os

            from .report import write_route_report

            write_stats_files(opts.stats_dir, result)
            write_route_report(
                os.path.join(opts.stats_dir, "route_report.txt"),
                rr, result.occ, R)
        return result

    def _route_planes_windows(self, term, crit, timing_cb, analyzer, occ,
                              acc, paths, sink_delay, all_reached, bb,
                              full_bb, result, B, crop, mlog):
        """The synchronous window driver (the JAX package's
        _route_planes_windows with pipeline=False and no checkpoint,
        resilience or fused modes)."""
        from .planes import (SCAL_MAX_SPAN, SCAL_NEXEC, SCAL_NROUTES,
                             SCAL_S_EXEC, SCAL_S_USEFUL,
                             route_window_planes, unpack_window_status)

        opts = self.opts
        rr, dev = self.rr, self.dev
        R, Smax = term.sinks.shape
        N = rr.num_nodes
        grp = Smax if opts.sink_group == 0 else opts.sink_group
        grp = max(1, min(grp, Smax))
        source_d = self._t(term.source.astype(np.int32))
        sinks_d = self._t(term.sinks.astype(np.int32))
        # a copy: with an analyzer the window programs write it in place
        crit_d = torch.tensor(crit, device=self.device)
        # the STA between iterations inside each window (analyzer mode)
        sta_kw = analyzer.sta_kwargs() if analyzer is not None else {}
        host_cb = timing_cb is not None and analyzer is None
        nsinks_np = term.num_sinks.astype(np.int64)
        cx_np = ((term.bb_xmin + term.bb_xmax) // 2).astype(np.int64)
        cy_np = ((term.bb_ymin + term.bb_ymax) // 2).astype(np.int64)
        planes_tbl = self._planes_terminals(term)

        pres = opts.initial_pres_fac
        it_done = 0
        dirty = np.arange(R)
        colors = None
        wide = np.zeros(R, dtype=bool)
        bb_full = np.zeros(R, dtype=bool)
        best_over = 1 << 30
        stall_windows = 0
        sweep_boost = 1
        # two-phase mode switch: a stalled negotiation drops to the exact
        # incremental sink schedule (…cxx:6238-6267)
        precise = opts.sink_group != 0
        full_reroute_done = False
        finish_done = False
        fin_save = None
        force_all_next = False
        widx = 0
        crop_forced = None
        if "x" in crop:
            cwf, chf = (int(v) for v in crop.split("x"))
            crop_forced = (min(cwf, rr.grid.nx - 1),
                           min(chf, rr.grid.ny - 1))
        crop_full = crop != "auto" and crop_forced is None

        L = int(paths.shape[2])
        L_cap = self.max_len
        # static initial bbs: the crop anchor
        bb0_d = self._t(np.stack(
            [term.bb_xmin, term.bb_xmax, term.bb_ymin, term.bb_ymax],
            axis=1).astype(np.int32))
        live_w = (term.bb_xmax - term.bb_xmin + 1).astype(np.int64)
        live_h = (term.bb_ymax - term.bb_ymin + 1).astype(np.int64)
        budget_full = np.zeros(R, dtype=bool)
        rm = self.row_mesh
        # the plane dtype (JAX router.py:1609-1625, :1713-1720): guarded
        # bf16 commits f32 and shadows in bf16, "off" commits bf16
        pd_req, guard = str(opts.plane_dtype), str(opts.dtype_guard)
        dtype_demoted = dtype_validated = False
        m = self.metrics
        m["route.kernel.dtype_demotions"] = m.get(
            "route.kernel.dtype_demotions", 0)
        m["route.kernel.plane_dtype"] = pd_req
        while it_done < opts.max_router_iterations:
            K = self._WINDOWS[min(widx, len(self._WINDOWS) - 1)]
            if host_cb or opts.stats_dir:
                # the host callback needs every iteration's delays; the
                # stats files take one row per iteration
                K = 1
            K = min(K, opts.max_router_iterations - it_done)
            widx += 1

            def spans(sub):
                if not len(sub):
                    return np.array([8]), np.array([8])
                ws = np.where(wide[sub], rr.grid.nx + 2, np.maximum(
                    term.bb_xmax[sub] - term.bb_xmin[sub] + 1,
                    live_w[sub]))
                hs = np.where(wide[sub], rr.grid.ny + 2, np.maximum(
                    term.bb_ymax[sub] - term.bb_ymin[sub] + 1,
                    live_h[sub]))
                return ws, hs

            w_all, h_all = spans(dirty)
            # size-class crop ladder: one cropped window call per
            # populated class, smallest first, full canvas last
            if crop_forced is not None and len(dirty):
                Lm = self.pg.max_span
                narrow = ((w_all + 2 * Lm <= crop_forced[0])
                          & (h_all + 2 * Lm <= crop_forced[1]))
                dispatch = []
                if narrow.any():
                    dispatch.append((dirty[narrow], crop_forced))
                if not narrow.all():
                    dispatch.append((dirty[~narrow], None))
            elif not crop_full and len(dirty):
                Lm = self.pg.max_span
                classes, assign = _size_class_buckets(
                    w_all + 2 * Lm, h_all + 2 * Lm,
                    rr.grid.nx, rr.grid.ny, min_count=max(1, B // 8))
                dispatch = [(dirty[assign == k], tile)
                            for k, tile in enumerate(classes)]
                if (assign == len(classes)).any():
                    dispatch.append((dirty[assign == len(classes)], None))
            else:
                dispatch = [(dirty, None)]
            if rm is not None:
                # the sharded relaxation runs the full canvas: the row
                # mesh splits the canvas instead of the crop ladder
                dispatch = [(dirty, None)]

            widen_d = (None if opts.sweep_budget_div <= 1
                       else self._t(budget_full))
            shadow_now = (pd_req == "bf16" and guard != "off"
                          and not dtype_demoted and not dtype_validated)
            pd_main = ("bf16" if pd_req == "bf16" and guard == "off"
                       and not dtype_demoted else "f32")
            shadow = []
            if shadow_now:
                # the window-entry state, for the shadow's replay
                sh_state = [t.clone() for t in (occ, acc, paths,
                                                sink_delay, all_reached,
                                                bb, crit_d)]
            t0 = time.time()
            rung_scals = []
            for ri, (sub, tile) in enumerate(dispatch):
                sel_p, valid_p = self._plan_groups(
                    sub, colors, nsinks_np, cx_np, cy_np, B)
                ws, hs = spans(sub)
                wok = widen_d
                if len(sub):
                    lx, ly = self._lmin_seg
                    if lx == 1 and ly == 1:
                        spans_full = ws + hs
                    else:
                        spans_full = -(-ws // lx) + -(-hs // ly) + 2
                    sp = spans_full
                    if opts.sweep_budget_div > 1:
                        red = np.maximum(8, spans_full
                                         // opts.sweep_budget_div)
                        sp = np.where(budget_full[sub] | wide[sub],
                                      spans_full, red)
                    span = int(sp.max())
                else:
                    span = 8
                # pow-2 quantized sweep ceiling (the loop exits at its
                # fixpoint; the widen gate compares against this value)
                nsw = min(128, _pow2_at_least(max(8, span * sweep_boost)))
                if wok is not None and len(sub):
                    wok_np = budget_full.copy()
                    wok_np[sub[spans_full <= nsw]] = True
                    wok = self._t(wok_np)
                maxfan = int(nsinks_np[sub].max()) if len(sub) else 1
                doubling = opts.sink_group == 0 and not precise
                grp_w = 1 if precise and opts.sink_group == 0 else grp
                waves = (max(1, math.ceil(math.log2(maxfan + 1))) + 1
                         if doubling
                         else min(Smax, _pow2_at_least(
                             math.ceil(maxfan / grp_w) + 1)))
                # positions 2-7 and 10 are the window state (_SHADOW_SLOTS)
                args = [self.pg, dev, occ, acc, paths, sink_delay,
                        all_reached, bb, source_d, sinks_d, crit_d,
                        *planes_tbl, self._t(sel_p), self._t(valid_p),
                        full_bb, pres, opts.pres_fac_mult, opts.max_pres_fac,
                        opts.acc_fac if ri == 0 else 0.0, it_done,
                        it_done + 1 if force_all_next
                        else opts.incremental_after,
                        K, nsw, L, waves, grp_w, doubling]
                kw = dict(topk=min(4096, N), n_colors=5, crop_tile=tile,
                          bb0_all=bb0_d, widen_ok=wok, mesh=rm, **sta_kw)
                occ, acc, status, scal, dmax_hist = route_window_planes(
                    *args, plane_dtype=pd_main, **kw)
                if shadow_now:
                    shadow.append((args, kw))
                rung_scals.append((scal.cpu().numpy(), tile is not None))
            force_all_next = False
            status_np = status.cpu().numpy()
            scal_np = rung_scals[-1][0]
            if shadow:
                # the dtype guard: replay the window's rungs in bf16 on
                # the window-entry copies and band-compare the summaries
                s_status, s_scal = _shadow_window(shadow, sh_state)
                if _dtype_band_ok(status_np, scal_np, s_status, s_scal):
                    dtype_validated = guard == "route"
                else:
                    dtype_demoted = True
                    m["route.kernel.dtype_demotions"] += 1
                    m["route.kernel.plane_dtype"] = "f32"

            (rrm, colors, dev_wide, unreached, live_w,
             live_h) = unpack_window_status(status_np)
            n_over, over_total = int(scal_np[0]), int(scal_np[1])
            max_span = int(scal_np[SCAL_MAX_SPAN])
            if opts.sweep_budget_div > 1:
                budget_full |= unreached
            wide |= dev_wide
            bb_full |= dev_wide
            it_done += K
            # the last rung's crit-path delay after the window's last
            # iteration
            cpd = (float(dmax_hist[K - 1]) if analyzer is not None
                   else float("nan"))

            # bookkeeping: the work ledger and one stats row per window
            w_steps = w_useful = w_crop = nexec = 0
            for v, cropped in rung_scals:
                result.total_net_routes += int(v[SCAL_NROUTES])
                nexec += int(v[SCAL_NEXEC])
                w_steps += int(v[SCAL_S_EXEC])
                w_useful += int(v[SCAL_S_USEFUL])
                if cropped:
                    w_crop += int(v[SCAL_S_EXEC])
            result.total_relax_steps += w_steps
            result.total_relax_steps_useful += w_useful
            result.total_relax_steps_wasted += w_steps - w_useful
            result.total_relax_steps_cropped += w_crop
            result.stats.append(RouteStats(
                it_done, n_over, over_total, len(dirty), time.time() - t0,
                relax_steps=w_steps, batches=nexec,
                overuse_pct=100.0 * n_over / max(1, N), crit_path_delay=cpd))
            if analyzer is not None and cpd == cpd:
                analyzer.crit_path_delay = cpd
            if mlog.enabled:
                self._log_window(mlog, widx, it_done, K, len(dirty), nexec,
                                 w_steps, n_over, over_total, pres,
                                 result.widened_nets, occ, colors, rrm,
                                 precise, sweep_boost, cpd, dmax_hist)
            if rm is not None:
                # one rung under a mesh: the last plan is the window's
                self._book_halo(scal_np, sel_p.shape[1] if len(dirty) else 1,
                                pd_main)
            pres = min(opts.max_pres_fac, pres * opts.pres_fac_mult ** K)
            if opts.stats_dir and opts.dump_routes:
                _dump_routes(opts.stats_dir, it_done, paths.cpu().numpy(), N)

            if n_over == 0 and not rrm.any():
                finish_set = nsinks_np > 1
                if (opts.finish_precise and opts.sink_group == 0
                        and not finish_done and not full_reroute_done
                        and finish_set.any()
                        and it_done + 4 < opts.max_router_iterations
                        and paths.numel() * 4 <= (1 << 30)):
                    # wirelength finishing pass: one precise reroute of
                    # the multi-sink nets, then back to legality; the
                    # legal state is kept to restore if that fails
                    finish_done = True
                    precise = True
                    force_all_next = True
                    rrm = finish_set
                    fin_save = (occ.clone(), paths.clone(),
                                sink_delay.clone(), all_reached.clone(),
                                bb.clone(), it_done)
                    best_over = 1 << 30
                    stall_windows = 0
                    sweep_boost = 1
                else:
                    result.success = True
                    result.iterations = it_done
                    break

            # path-budget regrowth after device-side bb widening
            if max_span >= rr.grid.nx + rr.grid.ny:
                L_need = L_cap
            else:
                L_need = path_budget(max_span, L_cap)
            if L_need > L:
                paths = _grow_paths(paths, L_need, N)
                L = L_need

            # plateau valve at window granularity (…cxx:6238-6267)
            if n_over < best_over:
                best_over = n_over
                stall_windows = 0
                sweep_boost = 1
            else:
                stall_windows += K
                sweep_boost = min(4, sweep_boost * 2)
                precise = True
            if stall_windows >= opts.plateau_iters and n_over > 0:
                stuck = rrm & ~bb_full
                if stuck.any():
                    wide |= stuck
                    bb_full |= stuck
                    result.widened_nets += int(stuck.sum())
                    bb[self._t(stuck)] = full_bb
                    if L < L_cap:
                        paths = _grow_paths(paths, L_cap, N)
                        L = L_cap
                stall_windows = 0

            dirty = np.where(rrm)[0]
            if 0 < n_over <= 8:
                precise = True
            # phase-2 restart (once): rip up and re-route everything
            # precisely against the accumulated history costs
            if (precise and not full_reroute_done and n_over > 0
                    and widx >= 4):
                dirty = np.arange(R)
                force_all_next = True
                full_reroute_done = True
            if host_cb:
                result.sink_delay = sink_delay.cpu().numpy()
                new_crit = np.minimum(np.asarray(
                    timing_cb(result), dtype=np.float32), 0.99)
                # unchanged criticalities keep the tensor on the device
                if not np.array_equal(new_crit, crit):
                    crit = new_crit
                    crit_d = torch.tensor(crit, device=self.device)
        else:
            result.iterations = opts.max_router_iterations

        if not result.success and fin_save is not None:
            # the finishing pass could not re-legalize within budget:
            # restore the pre-finish legal state
            occ, paths, sink_delay, all_reached, bb, fin_it = fin_save
            result.success = True
            result.iterations = fin_it
        result.wirelength = int(wirelength_on_device(dev, paths))
        result.paths = paths.cpu().numpy()
        result.sink_delay = sink_delay.cpu().numpy()
        result.occ = occ.cpu().numpy()
        return result
