"""Negotiated-congestion (PathFinder) routing driver for the planes
program: the counterpart of parallel_eda_tpu/route/router.py.

The PathFinder outer loop runs on the host as a sequence of WINDOWS;
each window is ``planes.route_window_planes`` over every populated rung
of the bounding-box crop ladder (smallest tiles first, the full canvas
last), and the host reads back one packed status word per net plus a
scalar summary per window, from which it decides convergence, plateau
widening, sweep-budget promotion and the next window's batch plan.

``route()`` drives the generator ``route_gen`` (``_drive_windows``):
the window loop yields a ``WindowDispatchRequest`` at each fused window
dispatch (``fused_dispatch=True``: the window's whole crop ladder as one
``planes.route_window_planes_fused`` call) and takes the call's result
back, so that a caller can drive several jobs' generators in lockstep
and merge their requests into one ``route_window_planes_multi`` call.

``pipeline=True`` (the default, as in the JAX package) is the two-stage
host/device pipeline: the window's packed summary comes back through a
non-blocking copy (pinned host memory and a CUDA event on the card),
the previous window's bookkeeping (stats row, congestion record, mdclog
records, halo ledger) runs while the current window is in flight, and
the summary read is the window's one blocking point.  Every dispatch is
planned from the same fully read summary as ``pipeline=False`` (the
CLI's ``--sync``: every rung drained before further host work), so the
two modes are bit-identical.

Metrics and trace spans go to the process-wide registry and tracer of
``obs`` (``get_metrics()``, ``get_tracer()``) under the JAX package's
names: per window the ``route.*`` work ledger and a snapshot, per route
the final gauges, the ``route.dispatch.*`` variant counters, the
pipeline's ``route.pipeline.*`` figures, and the ``route.window``,
``route.iter``, ``route.kernel`` and ``route.pipeline.{plan,exec}``
spans.

Elastic routing, as in the JAX package: ``checkpoint_every`` snapshots
the whole negotiation at window boundaries into
``RouteResult.checkpoint`` (a ``RouteCheckpoint``), ``route(resume=)``
continues it under this Router's device and ``mesh_shards``, and
``slice_iterations`` yields at the first window boundary past the
slice with ``success=False`` and the checkpoint to resume from.
``checkpoint_to_numpy`` / ``checkpoint_from_numpy`` carry a checkpoint
to and from the JAX package's field names.  ``RouteResult.congestion``
holds the per-window top-k overused nodes (``congestion_topk``).

Options the port does not implement yet raise NotImplementedError
naming their ROADMAP.md item when set to a non-default value
(``_NOT_PORTED``, empty now: every RouterOpts field is ported).

``compile_cache_dir`` keeps the built CUDA libraries across processes
(route/cuda_lib.py ``set_cache_dir``: keyed by source, nvcc command and
version and compute capability), and ``program_library_dir`` attaches
the program library (serve/library.py) on a single-device planes
Router, as in JAX: its entries' variant keys count as seen dispatch
variants from the start, and the dispatch sites (the per-rung call, the
fused request, the guarded chains' "aot" rung, the multi call of
serve/fused.py) serve through it; ``export_program_library()`` writes
what a warm-up route noted.

``RouterOpts.resil`` (a ``resil.Resilience``) runs every window dispatch
under the resilience guard, as in the JAX package: a chain of
bit-identical rungs handed to ``DispatchGuard.run`` (retry with capped
backoff, per-variant quarantine, descent), the fault sites armed, and
the degradation ladder's dimensions consulted at every window
(resil/ladder.py names the port's form of each level).  The per-rung
chain is jit -> pallas_g1 -> xla: the relaxation kernels in the auto
mode, with the mode capped at 1, then at 0 (``kernel_mode_cap``; the
kernel rungs exist on the card, and on the CPU for
``program="planes_pallas"`` as in JAX, where the plain versions take no
mode).  The fused chain is fused -> per_rung, the mesh chain
pallas_halo (the cluster kernel, on a card) -> ppermute (the per-sweep
loop) -> single_chip, and a lost mesh member (``backend.loss``) lands
the route on one device.  The port's window writes paths, sink delays,
reach flags, boxes and crit in place, so a guarded dispatch keeps the
window-entry tensors (``_WindowEntry``) and restores them before a
retry or a descent.  With ``resil=None`` nothing of this runs: no copy,
no extra sync, the same launches.

``program="ell"`` is the JAX package's any-graph fallback: the
gather-based Bellman-Ford search of route/search.py, one batch at a
time against the whole-circuit state, with per-net bounding-box windows
and their A* gate (``windowed``, ``window_max_frac``,
``window_max_bytes``, ``astar_fac``), the conflict-colored commit
schedule and one summary read per iteration (``_route_ell``).  The
pipeline, checkpoints, slicing and congestion records are the planes
program's, as in JAX.  ``program="planes_pallas"`` is the planes route:
the port's relaxation kernels already are its hand-written kernels.

Reduced-precision planes (``plane_dtype="bf16"``) follow the JAX
package's ``dtype_guard``: "off" commits the bf16 relaxation; "window"
commits the f32 route and replays every window in bf16 on copies of the
window-entry state (the shadow), whose packed summary must stay within
the band of ``_dtype_band_ok`` or the route stops shadowing (a
demotion); "route" shadows only until the first window within the band.
A demotion also steps the resilience ladder's "dtype" dimension.

``stats_dir`` is the diagnostics mode, as in the JAX package: windows of
one iteration, iter_stats.txt / final_stats.txt (``write_stats_files``)
and route_report.txt in that directory, the per-(window, category)
records of ``mdclog.MdcLogger`` under its logs/, and, with
``dump_routes``, every iteration's routes (routes_iter_N.txt).  The CLI
writes the registry there as metrics.json, and the route writes
devprof.json (obs/devprof.py: CUDA-event milliseconds per kernel and
dispatch variant, read after the route).  The route.kernel.* layout
gauges carry the port's layout (planes_kernels.kernel_layout).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs import get_devprof, get_metrics, get_tracer
from ..rr.graph import RRGraph
from ..rr.terminals import NetTerminals
from .device_graph import DeviceRRGraph, to_device, wire_cost_floor
from .search import (WindowTables, build_windows, conflict_subset,
                     iteration_summary, route_batch_resident,
                     route_batch_resident_win, window_sizes,
                     wirelength_on_device)


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
    ``pipeline=True`` included.  See the JAX package for each knob's
    meaning."""
    max_router_iterations: int = 50
    initial_pres_fac: float = 0.5
    pres_fac_mult: float = 1.3
    acc_fac: float = 1.0
    bb_factor: int = 3
    batch_size: int = 64          # nets routed concurrently
    program: str = "planes"       # "planes" | "planes_pallas" | "ell"
    sink_group: int = 0           # 0 = all sinks per wave (doubling)
    max_pres_fac: float = 1000.0
    incremental_after: int = 1
    windowed: bool = True         # ELL program: bb windows (+ A* gate)
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
    pipeline: bool = True
    compile_cache_dir: Optional[str] = None
    congestion_topk: int = 8
    program_library_dir: Optional[str] = None
    resil: Optional[object] = None
    plane_dtype: str = "f32"
    dtype_guard: str = "window"
    fused_dispatch: bool = False
    mesh_shards: int = 1


# option -> (default, ROADMAP.md item that ports it); every option of
# the JAX package's RouterOpts is ported
_NOT_PORTED: dict = {}


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
class RouteCheckpoint:
    """Host snapshot of the whole negotiation state at a window boundary
    (JAX router.py:269-294, the same fields): the state arrays as numpy,
    ``it_done``, ``pres``, the host scheduling state ``driver`` (the
    keys of CHECKPOINT_DRIVER_KEYS) and, while the wirelength finishing
    pass is live, ``fin_save``: the pre-finish legal (occ, paths,
    sink_delay, all_reached, bb, it_done), restored by a resumed route
    that cannot re-legalize within its budget.  A checkpoint resumes
    under any device and any ``mesh_shards``."""
    occ: np.ndarray
    acc: np.ndarray
    paths: np.ndarray
    sink_delay: np.ndarray
    all_reached: np.ndarray
    bb: np.ndarray
    crit: np.ndarray
    it_done: int
    pres: float
    driver: dict
    fin_save: Optional[tuple] = None


# RouteCheckpoint.driver's keys (JAX router.py:2470-2483)
CHECKPOINT_DRIVER_KEYS = (
    "widx", "dirty", "colors", "wide", "bb_full", "best_over",
    "stall_windows", "sweep_boost", "precise", "full_reroute_done",
    "force_all_next", "finish_done", "budget_full", "widened_nets",
    "crop_full")
_CHECKPOINT_ARRAYS = ("occ", "acc", "paths", "sink_delay", "all_reached",
                      "bb", "crit")


def checkpoint_to_numpy(ck: RouteCheckpoint) -> dict:
    """``ck`` as a dict under the JAX package's field names (numpy
    arrays, Python scalars, the driver dict, the fin_save tuple), every
    array copied: the JAX package's ``RouteCheckpoint(**d)`` takes it."""
    return copy.deepcopy({f.name: getattr(ck, f.name)
                          for f in dataclasses.fields(ck)})


def checkpoint_from_numpy(fields: dict) -> RouteCheckpoint:
    """The port's checkpoint from a dict carrying the JAX package's
    field names (a JAX RouteCheckpoint's fields), every array copied.
    Raises ValueError when the driver dict lacks one of its keys: a
    resume without it would part from the unsliced route windows
    later."""
    d = copy.deepcopy(dict(fields))
    missing = [k for k in CHECKPOINT_DRIVER_KEYS if k not in d["driver"]]
    if missing:
        raise ValueError(f"checkpoint driver state lacks {missing}")
    for k in _CHECKPOINT_ARRAYS:
        d[k] = np.asarray(d[k])
    fs = d.get("fin_save")
    if fs is not None:
        d["fin_save"] = tuple(np.asarray(a) for a in fs[:5]) + (int(fs[5]),)
    return RouteCheckpoint(**d)


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
    # latest window-boundary snapshot (checkpoint_every, slice_iterations)
    checkpoint: Optional[RouteCheckpoint] = None
    # per-window records {window, iteration, overused_nodes,
    # overuse_total, pres_fac, top_overused: [[node, overuse], ...]}
    # (congestion_topk > 0), in both pipeline modes
    congestion: List[dict] = field(default_factory=list)


# canonical dispatch signatures seen by this process (JAX router.py
# :566-584): a variant's first dispatch counts route.dispatch.compiles,
# every later one route.dispatch.cache_hits.  On the card a new variant
# is a new set of launch shapes, whose launch plans the kernel wrappers
# build at its first launch (planes_kernels._plan); nothing is compiled
# at dispatch.  Process state on purpose: a registry reset keeps warm
# variants warm.
_DISPATCH_VARIANTS = set()


def _note_dispatch_variant(key) -> bool:
    """Record one dispatch signature; True when it is new."""
    reg = get_metrics()
    if key in _DISPATCH_VARIANTS:
        reg.counter("route.dispatch.cache_hits").inc()
        return False
    _DISPATCH_VARIANTS.add(key)
    reg.counter("route.dispatch.compiles").inc()
    return True


class WindowDispatchRequest:
    """One planned fused-window dispatch that ``Router.route_gen``
    yields (JAX router.py:587-609): its variant key, the arguments of
    ``planes.route_window_planes_fused``, the same rungs planned for
    per-rung dispatch (``per_rung_fb``: the last rung of the guarded
    fused chain, the ladder's "dispatch" fallback) and the resilience
    runtime (``RouterOpts.resil`` or None).  The caller sends back the
    call's result: the solo driver through
    ``Router._exec_window_request``, a lockstep driver through one
    ``route_window_planes_multi`` call over several jobs' requests."""
    __slots__ = ("vkey", "f_args", "f_kwargs", "per_rung_fb",
                 "resil_rt")

    def __init__(self, vkey, f_args, f_kwargs, per_rung_fb, resil_rt):
        self.vkey = vkey
        self.f_args = f_args
        self.f_kwargs = f_kwargs
        self.per_rung_fb = per_rung_fb
        self.resil_rt = resil_rt


class _PlanStaging:
    """Named device slots for the per-rung plan tensors (JAX router.py
    :664-690): ``put`` skips the upload when its slot already holds an
    equal array, counting ``route.pipeline.upload_skips``.  The window
    never writes its plan tensors, so a slot is reused across windows as
    it stands."""

    def __init__(self, device):
        self._device = device
        self._slots = {}

    def put(self, name: str, host_arr):
        host_arr = np.asarray(host_arr)
        slot = self._slots.get(name)
        if (slot is not None and slot[0].shape == host_arr.shape
                and slot[0].dtype == host_arr.dtype
                and np.array_equal(slot[0], host_arr)):
            get_metrics().counter("route.pipeline.upload_skips").inc()
            return slot[1]
        # a copy of its own: on the CPU the tensor shares its memory
        own = np.ascontiguousarray(host_arr).copy()
        dev = torch.from_numpy(own).to(self._device, non_blocking=True)
        self._slots[name] = (own, dev)
        return dev


class _HostCopy:
    """Host copies of device tensors, started without blocking the host:
    on the card, non-blocking copies into pinned buffers of their own
    (fresh for every window in flight) fenced by one CUDA event, which
    ``numpy()`` waits for.  Tensors the caller put on the CPU are read
    as they are: they must not be written after the copy is taken."""

    def __init__(self, tensors):
        self._event = None
        self._host = list(tensors)
        if self._host[0].is_cuda:
            dev = self._host[0].device
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))

    def numpy(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _host_snapshot(t) -> np.ndarray:
    """A numpy copy of ``t`` (never a view: the window writes the state
    in place)."""
    return t.detach().to("cpu", copy=True).numpy()


# the window call's arguments it writes in place (paths, sink_delay,
# all_reached, bb, crit_all), in route_window_planes and
# route_window_planes_fused alike; occ and acc come back as new tensors
_IN_PLACE_SLOTS = (4, 5, 6, 7, 10)


class _WindowEntry:
    """The tensors a guarded window call writes in place, copied at its
    entry: a failure after some of the call's launches leaves them half
    written, so every rung but the first restores them before it runs
    (the JAX program is atomic under donation; the port's window is many
    launches)."""

    def __init__(self, args):
        self._live = [args[i] for i in _IN_PLACE_SLOTS]
        self._copy = [t.clone() for t in self._live]
        self._runs = 0

    def __call__(self) -> None:
        """Called at the start of every attempt."""
        if self._runs:
            self.restore()
        self._runs += 1

    def restore(self) -> None:
        """Write the entry copies back into the live tensors."""
        for live, saved in zip(self._live, self._copy):
            live.copy_(saved)


# per-route pipeline gauges (JAX router.py:2594-2604), zeroed at the
# start of every route
_PIPELINE_GAUGES = tuple("route.pipeline." + k for k in (
    "host_plan_ms", "device_exec_ms", "stall_ms", "overlap_frac",
    "host_overlap_frac", "host_plan_ms_total", "device_exec_ms_total",
    "stall_ms_total", "host_serial_ms_total"))


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


def _color_schedule(idx: np.ndarray, conflict: np.ndarray):
    """Greedy-color the net conflict graph (conflict [I, I] bool from
    search.conflict_subset); each color class becomes its own commit
    group (custom_vertex_coloring …cxx:3323)."""
    n = len(idx)
    color = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        taken = np.unique(color[:i][conflict[i, :i]])
        c = 0
        for t in taken:          # taken is sorted: first gap wins
            if t != c:
                break
            c += 1
        color[i] = c
    ncolors = int(color.max()) + 1
    if ncolors == 1:
        return [idx]
    return [idx[color == c] for c in range(ncolors)]


def _pad_to(a: np.ndarray, B: int, fill) -> np.ndarray:
    n = a.shape[0]
    if n == B:
        return a
    pad = np.full((B - n,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


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


def _shadow_window(stash, state):
    """The bf16 shadow of a window (JAX router.py:2161-2181): the
    window's calls ``stash`` ((fn, args, kwargs, variant key) each: one
    route_window_planes call per rung, or the one fused call), each on
    the state the previous one left, from ``state`` (copies of the
    window-entry state, updated in place), with plane_dtype="bf16".
    Returns the last rung's (status, scal) as numpy arrays."""
    for fn, args, kw, vkey in stash:
        _note_dispatch_variant(vkey + ("shadow_bf16",))
        a = list(args)
        for slot, t in zip(_SHADOW_SLOTS, state):
            a[slot] = t
        occ, acc, status, scal, _ = fn(*a, **{**kw, "plane_dtype": "bf16"})
        state[0], state[1] = occ, acc
    if scal.dim() == 2:
        scal = scal[-1]          # the fused call's last rung
    return status.cpu().numpy(), scal.cpu().numpy()


class Router:
    """Holds the device graph across route() calls.  ``device`` defaults
    to ``cuda`` (raises without a card); pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels.

    ``opts.mesh_shards > 1`` shards the relaxation by canvas columns
    (route/planes_shard.py) over that many shards placed round-robin on
    the visible devices of ``device``'s type: ``row_mesh``.

    ``mesh`` (a parallel.shard.Mesh) runs the same negotiation over the
    mesh (JAX router.py:694-803): each step's B nets (B rounded up to a
    multiple of the net axis) are split into contiguous chunks, each
    routed on its row's first device, and the occupancy deltas are
    summed on the home device, which holds every whole-circuit array:
    ``device``, by default the mesh's first member.  A node axis > 1
    splits each row's relaxations over the row's devices: the planes
    canvases by columns (planes.planes_relax_node: on the card one
    launch of the node kernel per card of the row), the ELL program's
    rr-graph rows in its global steps (its windowed steps stay on the
    row's first device, as JAX constrains them on the net axis only).
    Canvases stay full (no crop ladder) and the plan width stays B, as
    in JAX; the result is bit-identical to the one-device route at
    ``crop="off"`` for every mesh shape.

    The registry (``obs.get_metrics()``) gets, under the JAX package's
    names: the halo ledger (counters ``route.mesh.halo_bytes`` and
    ``route.mesh.halo_exchanges``, gauges ``route.mesh.n_shards`` and
    ``route.mesh.overlap_frac``); the plane dtype (counter
    ``route.kernel.dtype_demotions``, bf16 shadows that left the band,
    and gauge ``route.kernel.plane_dtype``); the dispatch shape (gauges
    ``route.kernel.fused_rungs`` and ``route.kernel.dispatches_per_window``);
    and the pipeline: the counters ``route.pipeline.blocking_syncs``
    (one per pipelined window, one per dispatch under
    ``pipeline=False``), ``upload_skips`` and ``crit_upload_skips``, and
    the gauges of _PIPELINE_GAUGES, zeroed at the start of each route.
    Host seconds: ``host_plan`` is planning and staging the rungs plus
    the deferred bookkeeping, ``device_exec`` the span from the first
    dispatch to the summary read (pipelined; under ``pipeline=False``
    the calls and drains), ``stall`` the wait at the summary read,
    ``overlap_frac`` device_exec over the route's wall time and
    ``host_overlap_frac`` the share of host_plan done while a window was
    in flight.  The port's own counters ``route.elastic.checkpoints``
    and ``route.elastic.checkpoint_ms_total`` and the gauge
    ``route.elastic.resume_ms`` time the elastic surface."""

    # escalating sync schedule: window sizes between host round trips
    _WINDOWS = (2, 2, 3, 4, 5, 6, 8, 10, 10)

    def __init__(self, rr: RRGraph, opts: Optional[RouterOpts] = None,
                 device=None, mesh=None):
        self.rr = rr
        self.opts = opts or RouterOpts()
        _check_ported(self.opts)
        members = ()
        if mesh is not None:
            # the legacy (net, node) mesh's errors, before any work (JAX
            # router.py:723-727, :743-747)
            from .netsplit import node_rows
            if self.opts.program == "planes_pallas":
                raise ValueError(
                    "program='planes_pallas' does not support mesh sharding "
                    "yet (the Pallas kernel is single-device VMEM-resident); "
                    "use program='planes' for sharded runs")
            if self.opts.mesh_shards > 1:
                raise ValueError(
                    "mesh_shards > 1 and a legacy (net, node) mesh are "
                    "mutually exclusive — the halo-exchange sharding "
                    "owns the device mesh")
            rows = node_rows(mesh)
            members = tuple(d for row in rows for d in row)
            if device is None:
                device = members[0]
        self.device = resolve_device(device)
        if any(d.type != self.device.type for d in members):
            raise ValueError(f"the mesh's devices must be of the Router's "
                             f"device type ({self.device.type}): {mesh}")
        if (self.device.type == "cuda"
                and self.opts.program in ("planes", "planes_pallas")):
            # the relaxation kernels' scan line limit, before any work
            # (KernelShapeError); the CPU route has none, as JAX.  Every
            # mesh row's card runs K1 on the same canvas, or the node
            # kernel on its column blocks.
            from .planes_kernels import check_canvas
            check_canvas((rr.chan_width, rr.grid.nx, rr.grid.ny + 1),
                         self.opts.mesh_shards,
                         node=0 if mesh is None else mesh.devices.shape[1])
        from .lookahead import build_lookahead
        from .planes import build_planes

        self._la_host = la = build_lookahead(rr)
        self._lmin_seg = tuple(
            int(la.len_same[la.axis == a].min())
            if (la.axis == a).any() else 1 for a in (0, 1))
        # the program switch (JAX router.py:722-758): "planes" and
        # "planes_pallas" run the planes route (the port's relaxation
        # kernels are the hand-written form of both); anything else is
        # the ELL program, the only one that reads the ELL tables
        program = self.opts.program
        planes = program in ("planes", "planes_pallas")
        self.dev: DeviceRRGraph = to_device(rr, self.device, la=la,
                                            ell=not planes)
        nx, ny = rr.grid.nx, rr.grid.ny
        # path-length bound: a bb-confined path can wind, give slack
        self.max_len = 4 * (nx + ny) + 64
        self.pg = None
        if planes:
            if rr.wire_switch_of_track is None:
                raise ValueError(
                    f"program={program!r} needs a graph built by "
                    f"rr.graph.build_rr_graph (track switch map); use "
                    f"program='ell' for foreign graphs")
            self.pg = build_planes(rr, self.device)
        self._pt_key = None
        self._cap_np = None
        # lag 1 ("ppermute") on every device.  Lag 2 ("pallas_halo")
        # pays extra sweeps for a transfer that can land behind the next
        # sweep, and here every sweep of a net waits for every shard's
        # flag of the sweep before (the fixpoint is decided per sweep on
        # the card), so nothing overlaps and lag 2 is only slower on the
        # card (chip_smoke.py's mesh lines time both).  Under
        # RouterOpts.resil the ladder's "mesh" dimension picks the form
        # per window (_active_row_mesh): the cluster kernel, the peer
        # kernel, or one device once a member is lost.
        self.row_mesh = None
        self._row_meshes = None
        self._mesh_lost = False
        # the kernel ladder's rungs (pallas_g1, xla) exist where the
        # relaxation kernels run, and where JAX has them (planes_pallas)
        self._kernel_rungs = (self.device.type == "cuda"
                              or program == "planes_pallas")
        self._staging = _PlanStaging(self.device)
        # staging-slot namespace: a caller driving several jobs'
        # route_gen generators against this Router sets a prefix per job
        # before each advance, so their plan slots do not alias
        self._staging_prefix = ""
        if self.opts.mesh_shards > 1:
            if program == "planes_pallas":
                raise ValueError(
                    "program='planes_pallas' does not support "
                    "mesh_shards > 1 (the packed kernel is "
                    "single-device VMEM-resident); use "
                    "program='planes' — the sharded pallas_halo rung "
                    "engages on TPU backends")
            if self.pg is None:
                raise ValueError(
                    "mesh_shards > 1 needs a planes program "
                    "(program='planes')")
            from .planes_shard import make_row_mesh, uses_cluster
            self.row_mesh = make_row_mesh(self.opts.mesh_shards, "ppermute",
                                          self.device)
            # one mesh per form of the ladder's "mesh" levels: the
            # cluster kernel engages only where it runs (a card holding
            # every shard), as JAX's pallas_halo only on a TPU
            per_sweep = dataclasses.replace(self.row_mesh, per_sweep=True)
            self._row_meshes = {"ppermute": per_sweep}
            # the tensors' device (a card's carries its index)
            if uses_cluster(self.row_mesh, self.pg.device):
                self._row_meshes["pallas_halo"] = self.row_mesh
        if self.opts.compile_cache_dir:
            from .cuda_lib import set_cache_dir
            set_cache_dir(self.opts.compile_cache_dir)
        # the (net, node) mesh: the graphs placed on every net member
        # once, as JAX's shard_graph (the copies live as long as the
        # Router's graphs)
        self.mesh = mesh
        self._net_axis = 0 if mesh is None else mesh.devices.shape[0]
        if mesh is not None:
            from .netsplit import member_copy
            for d in members:
                member_copy(self.dev, d)
                if self.pg is not None:
                    member_copy(self.pg, d)
        # the program library (serve/library.py), single device only as
        # in JAX: loaded keys are pre-registered as SEEN dispatch
        # variants — a warm serve's first window is a cache hit, not a
        # new variant — and the library serves those variants with
        # their launch plans installed at the dispatch sites
        self._library = None
        if (self.opts.program_library_dir and self.opts.mesh_shards <= 1
                and mesh is None and self.pg is not None):
            from ..serve.library import ProgramLibrary
            self._library = lib = ProgramLibrary(
                self.opts.program_library_dir, device=self.device)
            lib.load()
            for key in lib.keys():
                _DISPATCH_VARIANTS.add(key)
            reg = get_metrics()
            reg.gauge("route.serve.library_variants").set(
                len(lib.keys()))
            reg.gauge("route.serve.library_stale").set(
                0 if lib.stale_reason is None else 1)

    def export_program_library(self) -> int:
        """Write every dispatch variant noted since the last save, and
        the CUDA libraries this process loaded, into
        opts.program_library_dir (serve/library.py).  Call after a
        warm-up route(), never mid-serve.  Returns entries written."""
        if self._library is None:
            return 0
        n = self._library.save()
        get_metrics().gauge("route.serve.library_variants").set(
            len(self._library.keys()))
        return n

    def _mesh_label(self, rm) -> str:
        """The ladder's name of mesh form ``rm``."""
        return ("pallas_halo" if self._row_meshes.get("pallas_halo") is rm
                else "ppermute")

    def _active_row_mesh(self, lad):
        """The RowMesh the next window relaxes under (JAX router.py
        :817-832), per the resil ladder's "mesh" dimension; None is the
        one-device floor.  Level 0 is the cluster kernel where it runs
        (a card holding every shard); elsewhere, and without a ladder on
        such a card, the level-0 form is the Router's row mesh, whose
        own path planes_shard picks."""
        if self._row_meshes is None or self._mesh_lost:
            return None
        if lad is None:
            return self.row_mesh
        lvl = lad.level("mesh")
        if lvl >= 2:
            return None
        if lvl == 0 and "pallas_halo" in self._row_meshes:
            return self._row_meshes["pallas_halo"]
        return self._row_meshes["ppermute"]

    def _check_mesh_member(self, resil_rt, rm):
        """backend.loss injection point for the sharded rungs (JAX
        router.py:834-853): fires BEFORE the call and is STICKY — a
        lost device stays lost, so the watchdog's same-rung retry fails
        too and the chain descends to the one-device rung."""
        from ..resil.faults import BackendLostError, Fault

        if self._mesh_lost:
            raise BackendLostError(Fault(
                "backend.loss", -1,
                f"mesh member lost earlier (n_shards={rm.n_shards})"))
        plan = getattr(resil_rt, "plan", None)
        if plan is not None:
            try:
                plan.raise_if("backend.loss",
                              detail=f"shard of row mesh n={rm.n_shards}")
            except BackendLostError:
                self._mesh_lost = True
                raise

    def _mesh_demote(self, resil_rt, reason: str) -> None:
        """Quarantine hook of a sharded rung (JAX router.py:855-873): a
        lost mesh member lands the ladder straight on the one-device
        floor; any other cause steps one level."""
        from ..resil.ladder import DIMS

        lad = getattr(resil_rt, "ladder", None)
        moved = False
        if lad is not None:
            floor = len(DIMS["mesh"]) - 1
            if self._mesh_lost:
                while lad.level("mesh") < floor:
                    lad.step("mesh", reason)
                    moved = True
            else:
                moved = lad.step("mesh", reason)
        if moved or lad is None:
            get_metrics().counter("route.mesh.mesh_demotions").inc()

    def _mesh_rungs(self, resil_rt, vkey, rm, call):
        """The sharded rungs of a mesh chain: ``rm``'s form, then (from
        the cluster kernel) the peer kernel, each running
        ``call(mesh)`` after the sticky backend.loss check."""
        from ..resil.watchdog import Rung

        top = self._mesh_label(rm)

        def mesh_run(label, rm_):
            def run():
                _note_dispatch_variant(vkey if label == top
                                       else vkey + (label,))
                self._check_mesh_member(resil_rt, rm_)
                return call(rm_)
            return run

        def quar(reason):
            self._mesh_demote(resil_rt, reason)

        rungs = [Rung(top, mesh_run(top, rm), quar)]
        if top == "pallas_halo":
            rungs.append(Rung("ppermute", mesh_run(
                "ppermute", self._row_meshes["ppermute"]), quar))
        return rungs

    def _aot_rung(self, vkey, fn, args, kwargs, entry):
        """The program library's rung of a guarded chain (JAX's "aot"):
        ``fn`` through the library; its quarantine evicts the entry, so
        that a later library process never serves it."""
        from ..resil.watchdog import Rung

        def run():
            _note_dispatch_variant(vkey)
            entry()
            return self._library.dispatch(vkey, fn, args, kwargs)

        return Rung("aot", run,
                    lambda reason: self._library.evict(vkey, reason))

    def _guarded_dispatch(self, resil_rt, vkey, wp_args, wp_kwargs):
        """One route_window_planes call under the resilience guard (JAX
        router.py:875-966): an ordered chain of BIT-IDENTICAL rungs,
        fastest first, handed to DispatchGuard.run.  Unsharded: jit (the
        auto mode), pallas_g1 (mode <= 1), xla (mode 0), the last two
        where the Router has kernel rungs; sharded: the mesh rungs, then
        single_chip.  Every rung notes its own variant key, and every
        rung after the first restores the call's in-place state."""
        from ..resil.watchdog import Rung
        from .planes import _as_row_mesh, route_window_planes
        from .planes_kernels import kernel_mode_cap

        entry = _WindowEntry(wp_args)
        rm = _as_row_mesh(wp_kwargs.get("mesh"))
        if rm is not None:
            def sharded(rm_):
                entry()
                return route_window_planes(*wp_args,
                                           **{**wp_kwargs, "mesh": rm_})

            rungs = self._mesh_rungs(resil_rt, vkey, rm, sharded)

            def run_single():
                _note_dispatch_variant(vkey + ("single_chip",))
                entry()
                return route_window_planes(*wp_args,
                                           **{**wp_kwargs, "mesh": None})

            rungs.append(Rung("single_chip", run_single))
            return resil_rt.guard.run(vkey, rungs)

        def capped(key, cap):
            def run():
                _note_dispatch_variant(key)
                entry()
                with kernel_mode_cap(cap):
                    return route_window_planes(*wp_args, **wp_kwargs)
            return run

        ladder = resil_rt.ladder
        rungs = []
        if self._library is not None and ladder.level("program") == 0:
            rungs.append(self._aot_rung(vkey, route_window_planes, wp_args,
                                        wp_kwargs, entry))
        rungs.append(Rung("jit", capped(vkey, None)))
        if self._kernel_rungs and ladder.level("kernel") <= 1:
            rungs.append(Rung("pallas_g1", capped(vkey + ("pallas_g1",), 1)))
        if self._kernel_rungs:
            rungs.append(Rung("xla", capped(vkey + ("xla",), 0)))
        return resil_rt.guard.run(vkey, rungs)

    def _guarded_dispatch_fused(self, resil_rt, vkey, f_args, f_kwargs,
                                per_rung_fb):
        """One route_window_planes_fused call under the resilience guard
        (JAX router.py:968-1035): fused, then the per-rung loop over the
        same planned rungs (the ladder's "dispatch" fallback); sharded:
        the mesh rungs, the one-device fused call, then the per-rung
        loop.  The kernel dimension is left to the per-rung chain, as in
        JAX."""
        from ..resil.watchdog import Rung
        from .planes import _as_row_mesh, route_window_planes_fused

        entry = _WindowEntry(f_args)
        rungs = []
        rm = _as_row_mesh(f_kwargs.get("mesh"))
        if rm is not None:
            def sharded(rm_):
                entry()
                return route_window_planes_fused(
                    *f_args, **{**f_kwargs, "mesh": rm_})

            rungs = self._mesh_rungs(resil_rt, vkey, rm, sharded)

            def run_single():
                _note_dispatch_variant(vkey + ("single_chip",))
                entry()
                return route_window_planes_fused(
                    *f_args, **{**f_kwargs, "mesh": None})

            rungs.append(Rung("single_chip", run_single))
        else:
            if (self._library is not None
                    and resil_rt.ladder.level("program") == 0):
                rungs.append(self._aot_rung(vkey, route_window_planes_fused,
                                            f_args, f_kwargs, entry))

            def run_fused():
                _note_dispatch_variant(vkey)
                entry()
                return route_window_planes_fused(*f_args, **f_kwargs)

            rungs.append(Rung("fused", run_fused))

        def run_per_rung():
            entry()
            return per_rung_fb()

        rungs.append(Rung("per_rung", run_per_rung))
        return resil_rt.guard.run(vkey, rungs)

    def _book_halo(self, rm, scal, batch: int, plane_dtype: str) -> None:
        """The halo ledger of one window (JAX router.py:1191-1233): each
        executed sweep exchanged one halo round per internal boundary,
        at the byte volume of the window's plan width ``batch`` in the
        committed relaxation's plane dtype.  ``rm`` None: the window ran
        on one device although sharding was asked (a demoted mesh),
        booked as one shard."""
        from .planes import SCAL_S_EXEC
        from .planes_shard import halo_bytes_per_sweep, modeled_overlap_frac

        reg = get_metrics()
        if rm is None:
            reg.counter("route.mesh.halo_bytes").inc(0)
            reg.counter("route.mesh.halo_exchanges").inc(0)
            reg.set_gauges({"route.mesh.n_shards": 1,
                            "route.mesh.overlap_frac": 0.0})
            return
        sweeps = int(scal[SCAL_S_EXEC])
        reg.counter("route.mesh.halo_bytes").inc(halo_bytes_per_sweep(
            self.pg, batch, rm.n_shards, plane_dtype) * sweeps)
        reg.counter("route.mesh.halo_exchanges").inc(
            (rm.n_shards - 1) * sweeps)
        reg.set_gauges({
            "route.mesh.n_shards": rm.n_shards,
            "route.mesh.overlap_frac": modeled_overlap_frac(
                self.pg, batch, rm.n_shards, rm.impl, rm.n_cards > 1,
                plane_dtype)})

    def _book_window(self, bk: dict, result: RouteResult, mlog) -> None:
        """The bookkeeping of one committed window (JAX router.py
        :1166-1270), from ``bk``, values captured at the window's control
        step: the work ledger and the stats row, the halo ledger, the
        congestion record and the mdclog records (route, congestion,
        schedule and, when timed, timing).  Nothing here feeds the
        control loop, so the pipelined driver runs it while the next
        window is in flight."""
        from .planes import SCAL_NEXEC, SCAL_NROUTES, SCAL_S_EXEC, \
            SCAL_S_USEFUL

        w_steps = w_useful = w_crop = nexec = 0
        for v, cropped in bk["rung_scals"]:
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
        n_over = bk["n_over"]
        result.stats.append(RouteStats(
            bk["it_done"], n_over, bk["over_total"], bk["ndirty"],
            bk["t_wall1"] - bk["t_wall0"], relax_steps=w_steps,
            batches=nexec,
            overuse_pct=100.0 * n_over / max(1, self.rr.num_nodes),
            crit_path_delay=bk["cpd"]))
        self._obs_window(bk["tw0"], bk["it_done"], bk["K"], n_over,
                         bk["over_total"], bk["ndirty"], w_steps,
                         bk["pres"], bk["cpd"], nexec,
                         relax_useful=w_useful, bucket_occ=bk["bucket_occ"],
                         compaction=bk["compaction"],
                         kernel_plans=bk["kplans"], tw1=bk["tw1"])
        if bk["halo"] is not None:
            self._book_halo(*bk["halo"])
        top = []
        if bk["occ_ref"] is not None:
            if self._cap_np is None:
                self._cap_np = self.dev.capacity.cpu().numpy()
            k = self.opts.congestion_topk
            top = _top_overused(bk["occ_ref"].numpy()[0], self._cap_np,
                                k=k if k > 0 else _CONGESTION_TOPK)
            result.congestion.append({
                "window": bk["widx"], "iteration": bk["it_done"],
                "overused_nodes": n_over,
                "overuse_total": bk["over_total"],
                "pres_fac": round(bk["pres"], 6),
                "top_overused": top})
        if mlog.enabled:
            mlog.set_mdc(bk["widx"])
            mlog.log("route", iteration=bk["it_done"], K=bk["K"],
                     rerouted=bk["ndirty"], groups=nexec,
                     relax_steps=w_steps)
            mlog.log("congestion", overused_nodes=n_over,
                     overuse_total=bk["over_total"],
                     pres_fac=round(bk["pres"], 4), widened=bk["widened"],
                     top_overused=top)
            mlog.log("schedule", colors=bk["colors_max"],
                     dirty_next=bk["dirty_next"], precise=bk["precise"],
                     sweep_boost=bk["sweep_boost"])
            if bk["cpd"] == bk["cpd"]:
                mlog.log("timing", crit_path_delay=bk["cpd"],
                         dmax_hist=[None if d != d else float(d)
                                    for d in bk["dmax_hist"].tolist()])

    def _plan_block_nets(self, tile, nnets: int, nsw: int,
                         plane_dtype: str = "f32", rm=None,
                         batch: int = 1) -> dict:
        """The route.kernel.* row of one dispatch (JAX router.py:1375
        _plan_block_nets, with its fields), in the port's layout
        (planes_kernels.kernel_layout): the kernel the dispatch launches
        (K2 for a crop tile, the cluster kernel or the peer kernel under
        a row mesh ``rm``, K1 otherwise) in the mode it takes on the
        card.  Under a mesh, also the halo fields of JAX's plan at plan
        width ``batch``."""
        from .planes_kernels import kernel_layout
        from .planes_shard import uses_cluster

        shards = 0 if rm is None else rm.n_shards
        peer = rm is not None and not uses_cluster(rm, self.pg.device)
        lay = kernel_layout(self.pg.shape_x, self.pg.shape_y, nnets, nsw,
                            tile=tile, shards=shards, peer=peer,
                            plane_dtype=plane_dtype)
        plan = dict(variant=lay["variant"], block_nets=lay["block_nets"],
                    lane_occupancy=lay["lane_occupancy"],
                    bytes_per_sweep=lay["bytes_per_sweep"],
                    tile=None if tile is None else list(tile),
                    nets=max(1, int(nnets)), nsweeps=int(nsw),
                    plane_dtype=plane_dtype)
        if rm is not None:
            from .planes_shard import halo_bytes_per_sweep, \
                modeled_overlap_frac
            plan.update(
                mesh_shards=rm.n_shards, mesh_impl=self._mesh_label(rm),
                halo_bytes_per_sweep=halo_bytes_per_sweep(
                    self.pg, batch, rm.n_shards, plane_dtype),
                mesh_overlap_frac=modeled_overlap_frac(
                    self.pg, batch, rm.n_shards, rm.impl, rm.n_cards > 1,
                    plane_dtype))
        return plan

    @staticmethod
    def _obs_window(tw0: float, it_done: int, K: int, n_over: int,
                    over_total: int, rerouted: int, relax_steps: int,
                    pres: float, cpd: float, batches: int,
                    relax_useful: Optional[int] = None,
                    bucket_occ=(), compaction: float = 1.0,
                    kernel_plans=(), tw1: Optional[float] = None) -> None:
        """Trace and metrics of one committed window (JAX router.py
        :1088-1163): a route.window span, a route.kernel span per
        dispatched rung, K route.iter spans (the window's wall time
        shared evenly, approx=True when K > 1), the work ledger's
        counters and gauges, and the per-window snapshot.  ``tw1`` is
        the window's end (perf_counter seconds): the pipelined driver
        books a window while the next one runs."""
        if tw1 is None:
            tw1 = time.perf_counter()
        useful = relax_steps if relax_useful is None else relax_useful
        tr = get_tracer()
        if tr is not None:
            tr.add_complete(
                "route.window", tw0, tw1 - tw0, cat="route",
                first_iter=it_done - K + 1, last_iter=it_done, K=K,
                rerouted=rerouted, overused_nodes=n_over,
                relax_steps=relax_steps,
                relax_steps_useful=int(useful),
                relax_steps_wasted=int(relax_steps - useful))
            for kp in kernel_plans:
                tr.add_complete("route.kernel", tw0, 0.0, cat="route",
                                **kp)
            dt = (tw1 - tw0) / max(1, K)
            for j in range(K):
                tr.add_complete("route.iter", tw0 + j * dt, dt,
                                cat="route", it=it_done - K + 1 + j,
                                overused=int(n_over),
                                pres_fac=round(float(pres), 4),
                                approx=K > 1)
        reg = get_metrics()
        reg.counter("route.iterations").inc(K)
        reg.counter("route.relax_steps").inc(relax_steps)
        reg.counter("route.relax_steps_useful").inc(int(useful))
        reg.counter("route.relax_steps_wasted").inc(
            int(relax_steps - useful))
        for occ_frac in bucket_occ:
            reg.histogram("route.bucket_occupancy").record(float(occ_frac))
        reg.gauge("route.compaction_ratio").set(round(float(compaction),
                                                      6))
        if kernel_plans:
            dom = max(kernel_plans, key=lambda kp: kp.get("nets", 0))
            reg.set_gauges({
                "route.kernel.packed_block_size": dom["block_nets"],
                "route.kernel.lane_occupancy": dom["lane_occupancy"],
                "route.kernel.bytes_per_sweep": dom["bytes_per_sweep"],
            })
        reg.counter("route.batches").inc(batches)
        reg.gauge("route.overused_nodes").set(int(n_over))
        reg.gauge("route.overuse_total").set(int(over_total))
        reg.gauge("route.dirty_nets").set(int(rerouted))
        reg.gauge("route.pres_fac").set(round(float(pres), 6))
        if cpd == cpd:
            reg.gauge("route.crit_path_delay").set(float(cpd))
        reg.histogram("route.window_wall_s").record(tw1 - tw0)
        reg.snapshot(phase="route", iteration=int(it_done))

    def _obs_final(self, result: "RouteResult") -> None:
        """The end-of-route gauges and snapshot (JAX router.py
        :1289-1308); overused_wire_nodes is route_report's count."""
        from .report import overused_wire_nodes

        reg = get_metrics()
        reg.gauge("route.success").set(bool(result.success))
        reg.gauge("route.wirelength").set(int(result.wirelength))
        reg.gauge("route.widened_nets").set(int(result.widened_nets))
        reg.gauge("route.net_routes").set(int(result.total_net_routes))
        total = max(1, result.total_relax_steps)
        reg.gauge("route.relax_wasted_frac").set(
            round(result.total_relax_steps_wasted / total, 6))
        reg.gauge("route.overused_wire_nodes").set(
            overused_wire_nodes(self.rr, result.occ))
        reg.snapshot(phase="route_final", iteration=result.iterations)

    def _occ_snapshot(self, occ, pipelined: bool, mlog):
        """Occupancy for one window's congestion record (JAX router.py
        :1271-1287), None with the record off.  Synchronous: the live
        tensor, booked at once.  Pipelined: a copy of its own (``clone``)
        whose host copy streams behind the next window and is read when
        the window is booked."""
        if self.opts.congestion_topk <= 0 and not mlog.enabled:
            return None
        return _HostCopy([occ.clone() if pipelined else occ])

    def _lb_scale(self):
        """[4] scale vector for the windowed A* gate (JAX router.py
        :1311): the flat (congestion, delay) per-tile floors x astar_fac,
        astar_fac itself (applied on the device to the per-cost-index
        delay bound) and the IPIN+SINK delay tail."""
        min_cong, min_delay, _ = wire_cost_floor(self.rr)
        af = self.opts.astar_fac
        return (min_cong * af, min_delay * af, af,
                self._la_host.term_delay)

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
        floor 8), but kept at B under a (net, node) mesh, whose net axis
        splits it (JAX router.py:1356-1364); group count padded to a
        power of two."""
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
        B_g = B
        if self.mesh is None:
            B_g = min(B, max(8, _pow2_at_least(
                max(len(b) for b in batches))))
        G = _pow2_at_least(len(batches))
        sel_plan = np.zeros((G, B_g), dtype=np.int32)
        valid_plan = np.zeros((G, B_g), dtype=bool)
        for i, b in enumerate(batches):
            sel_plan[i, :len(b)] = b
            valid_plan[i, :len(b)] = True
        return sel_plan, valid_plan

    def _batch(self, R: int) -> int:
        """The step width: batch_size (at most R), rounded up to a
        multiple of the mesh's net axis (JAX router.py:2613-2616)."""
        n = max(1, self._net_axis)
        return -(-min(self.opts.batch_size, max(1, R)) // n) * n

    def _t(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _upload(self, a):
        """A device copy of checkpoint array ``a`` (never sharing its
        memory: the route writes its state in place)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def route(self, term: NetTerminals, crit: Optional[np.ndarray] = None,
              timing_cb=None, analyzer=None,
              resume: Optional[RouteCheckpoint] = None) -> RouteResult:
        """Route all nets.  ``crit`` [R, Smax] per-sink criticalities
        (None or 0 => congestion-driven), clamped at 0.99.

        ``analyzer`` (timing.sta.TimingAnalyzer on this Router's device)
        runs the full STA between iterations inside each window program
        (multi-iteration windows; criticalities never visit the host)
        and leaves each window's critical-path delay in its stats row and
        in ``analyzer.crit_path_delay``.  ``timing_cb``, without an
        analyzer, is called on the host after every iteration (windows of
        one iteration) with the current result and returns the next
        criticalities (router.cxx:28,42).  ``resume`` (a RouteCheckpoint,
        e.g. ``RouteResult.checkpoint``) continues that negotiation: its
        state is uploaded to this Router's device and mesh layout and its
        criticalities replace ``crit``.

        The planes program runs ``route_gen`` with ``_drive_windows``,
        which issues every window request as it comes."""
        if self.pg is not None:
            return self._drive_windows(self.route_gen(
                term, crit=crit, timing_cb=timing_cb, analyzer=analyzer,
                resume=resume))
        _check_ported(self.opts)
        get_metrics().set_gauges({k: 0.0 for k in _PIPELINE_GAUGES})
        # the ELL program: the analyzer degrades to the per-iteration
        # host callback (JAX router.py:2702-2705)
        if analyzer is not None and timing_cb is None:
            timing_cb = analyzer.timing_cb
        if resume is not None:
            raise ValueError("resume is supported by the planes program")
        return self._route_ell(term, crit, timing_cb)

    def route_gen(self, term: NetTerminals,
                  crit: Optional[np.ndarray] = None,
                  timing_cb: Optional[Callable] = None, analyzer=None,
                  resume: Optional[RouteCheckpoint] = None):
        """The planes route as a generator (JAX router.py:2559-2684): it
        sets up the route's device state, then runs the window loop,
        yielding a ``WindowDispatchRequest`` at every fused window
        dispatch (``fused_dispatch=True``) and taking the result of
        ``route_window_planes_fused`` on the request's arguments back
        through ``send``.  Its StopIteration value is the RouteResult.
        ``route()`` drives it with ``_drive_windows``; a lockstep
        driver may instead merge several jobs' requests into one
        ``planes.route_window_planes_multi`` call.

        Setup runs at the first ``next()``.  The generator reads this
        Router's ``opts`` and ``_staging_prefix`` as it runs, so a caller
        driving several jobs on one Router sets both for the owning job
        before each advance."""
        if self.pg is None:
            raise ValueError("route_gen is supported by the planes program")
        opts = self.opts
        _check_ported(opts)
        _check_plane_dtype(opts)
        # per-route gauges: a route that never reaches one does not
        # inherit the previous route's value (JAX router.py:2586-2600)
        get_metrics().set_gauges({k: 0.0 for k in _PIPELINE_GAUGES})
        crop = normalize_crop(opts.crop)
        rr = self.rr
        R, Smax = term.sinks.shape
        N = rr.num_nodes
        B = self._batch(R)
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
        if resume is None:
            occ = torch.zeros(N, dtype=torch.int32, device=self.device)
            acc = torch.ones(N, dtype=torch.float32, device=self.device)
            span0 = (int(((term.bb_xmax - term.bb_xmin)
                          + (term.bb_ymax - term.bb_ymin)).max()) if R else 8)
            paths = torch.full((R, Smax, path_budget(span0, self.max_len)),
                               N, dtype=torch.int32, device=self.device)
            sink_delay = torch.full((R, Smax), float("inf"),
                                    dtype=torch.float32, device=self.device)
            all_reached = torch.zeros(R, dtype=torch.bool,
                                      device=self.device)
            bb = self._t(np.stack([term.bb_xmin, term.bb_xmax,
                                   term.bb_ymin, term.bb_ymax],
                                  axis=1).astype(np.int32))
        else:
            # the checkpointed negotiation under THIS Router's device and
            # mesh layout; its path store keeps its own budget
            tr0 = time.perf_counter()
            occ, acc, paths, sink_delay, all_reached, bb = (
                self._upload(getattr(resume, k))
                for k in _CHECKPOINT_ARRAYS[:6])
            crit = resume.crit
            get_metrics().gauge("route.elastic.resume_ms").set(round(
                (time.perf_counter() - tr0) * 1e3, 3))
        full_bb = self._t(np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1],
                                   dtype=np.int32))
        result = RouteResult(False, 0, None, None, None, 0)
        from ..mdclog import MdcLogger

        tr = get_tracer()
        dp = get_devprof()
        dp_was = dp.enabled
        if opts.stats_dir:
            # a stats_dir run is the diagnostics mode: the device profiler
            # rides along and writes devprof.json (JAX router.py:2675);
            # unlike JAX's it is switched back after the route, so that
            # later routes record no events
            dp.enabled = True
        # per-(window, category) records: a no-op without stats_dir;
        # around the yields, so a closed generator closes its files
        with MdcLogger(opts.stats_dir,
                       t0=tr.t0 if tr is not None else None) as mlog:
            result = yield from self._route_planes_windows(
                term, crit, timing_cb, analyzer, occ, acc, paths,
                sink_delay, all_reached, bb, full_bb, result, B, crop, mlog,
                resume)
        self._obs_final(result)
        if opts.stats_dir:
            import os

            from .report import write_route_report

            write_stats_files(opts.stats_dir, result)
            write_route_report(
                os.path.join(opts.stats_dir, "route_report.txt"),
                rr, result.occ, R)
            if dp.enabled:
                # the device-truth ledger: the CUDA events are read here,
                # after the route (JAX router.py:2532-2538)
                dp.capture_all()
                dp.dump(os.path.join(opts.stats_dir, "devprof.json"))
            dp.enabled = dp_was
        return result

    def _exec_window_request(self, req: WindowDispatchRequest):
        """Issue one fused-window request (JAX router.py:1037-1055):
        under the request's resilience runtime the guarded fused chain,
        else the call through the program library when one is attached,
        else the call, which runs or raises."""
        from .planes import route_window_planes_fused

        resil_rt = req.resil_rt
        if resil_rt is not None and resil_rt.guard is not None:
            return self._guarded_dispatch_fused(
                resil_rt, req.vkey, req.f_args, req.f_kwargs,
                req.per_rung_fb)
        _note_dispatch_variant(req.vkey)
        if self._library is not None:
            return self._library.dispatch(
                req.vkey, route_window_planes_fused, req.f_args,
                req.f_kwargs)
        return route_window_planes_fused(*req.f_args, **req.f_kwargs)

    def _drive_windows(self, gen) -> RouteResult:
        """The solo driver of a route_gen generator (JAX router.py
        :1057-1068): each request issued at once, its result sent back."""
        try:
            req = next(gen)
            while True:
                req = gen.send(self._exec_window_request(req))
        except StopIteration as e:
            return e.value

    def _ell_windows(self, bb, R: int):
        """The windowed search's setup (JAX router.py:2803-2841): the
        nets whose boxes hold under ``window_max_frac`` of the nodes get
        window tables (compacted rows, built in chunks of nets); the
        others are born wide and take the global program.  Returns
        (win, win_row, wide, lb_scale), win None when the tables would
        exceed ``window_max_bytes`` or no net is small enough."""
        opts, dev = self.opts, self.dev
        N = dev.num_nodes
        wide = np.zeros(R, dtype=bool)
        # chunk over nets: the [chunk, N] membership intermediate
        chunk = max(1, int(2e8) // max(1, N))
        sizes = np.concatenate(
            [window_sizes(dev, bb[lo:lo + chunk]).cpu().numpy()
             for lo in range(0, R, chunk)])
        small = sizes < opts.window_max_frac * N
        small_idx = np.where(small)[0]
        nbox = int(_pow2_at_least(
            max(1, int(sizes[small].max())))) if small.any() else N
        tbl_bytes = len(small_idx) * nbox * dev.max_in_degree * 9
        if not small.any() or tbl_bytes > opts.window_max_bytes:
            return None, None, wide, None
        bb_small = bb[self._t(small_idx)]
        win = WindowTables.cat([
            build_windows(dev, bb_small[lo:lo + chunk], nbox)
            for lo in range(0, len(small_idx), chunk)])
        win_row = np.full(R, 0, dtype=np.int32)
        win_row[small_idx] = np.arange(len(small_idx), dtype=np.int32)
        lb_scale = torch.tensor(self._lb_scale(), dtype=torch.float32,
                                device=self.device)
        return win, win_row, ~small, lb_scale

    def _route_ell(self, term: NetTerminals, crit, timing_cb) -> RouteResult:
        """The ELL program's route (JAX router.py:2714-3054): every
        iteration rips up and reroutes the nets that need it, batch by
        batch (conflict colors, then windowed and wide nets apart, each
        through _order_and_chunk), each batch one route_batch_resident
        or route_batch_resident_win against the whole-circuit state, then
        ONE summary read (reroute mask, reached flags, overuse, the
        relax-step counter kept on the device).  Unreached nets widen to
        the whole device, the path store grows to the full budget, and a
        plateau widens the stuck nets; ``timing_cb`` runs after every
        iteration.  The pipeline, checkpoints and congestion records
        belong to the planes program."""
        opts = self.opts
        normalize_crop(opts.crop)
        rr, dev = self.rr, self.dev
        R, Smax = term.sinks.shape
        N = rr.num_nodes
        B = self._batch(R)
        if crit is None:
            crit = np.zeros((R, Smax), dtype=np.float32)
        else:
            crit = np.minimum(np.asarray(crit, dtype=np.float32), 0.99)
        occ = torch.zeros(N, dtype=torch.int32, device=self.device)
        acc = torch.ones(N, dtype=torch.float32, device=self.device)
        span0 = (int(((term.bb_xmax - term.bb_xmin)
                      + (term.bb_ymax - term.bb_ymin)).max()) if R else 8)
        L_e = path_budget(span0, self.max_len)
        L_cap = self.max_len
        paths = torch.full((R, Smax, L_e), N, dtype=torch.int32,
                           device=self.device)
        sink_delay = torch.full((R, Smax), float("inf"),
                                dtype=torch.float32, device=self.device)
        all_reached = torch.zeros(R, dtype=torch.bool, device=self.device)
        bb = self._t(np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                               term.bb_ymax], axis=1).astype(np.int32))
        full_bb = self._t(np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1],
                                   dtype=np.int32))
        source_d = self._t(term.source.astype(np.int32))
        sinks_d = self._t(term.sinks.astype(np.int32))
        nsinks_np = term.num_sinks.astype(np.int64)
        cx_np = ((term.bb_xmin + term.bb_xmax) // 2).astype(np.int64)
        cy_np = ((term.bb_ymin + term.bb_ymax) // 2).astype(np.int64)

        win = win_row = lb_scale = None
        wide = np.zeros(R, dtype=bool)   # nets routed in global space
        if opts.windowed:
            win, win_row, wide, lb_scale = self._ell_windows(bb, R)
        bb_full = np.zeros(R, dtype=bool)  # nets already on full-device bb

        pres_fac = opts.initial_pres_fac
        result = RouteResult(False, 0, None, None, None, 0)
        if win is not None:
            result.windowed_nets = int((~wide).sum())
        n_over = -1
        crit_d = None                    # uploaded once; refreshed on cb
        stall = 0                        # phase-two plateau counter
        best_over = 1 << 30
        rrm = np.ones(R, dtype=bool)
        steps_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        prev_steps = 0
        # one static wave cap for every batch (the wave loop ends once
        # every sink is done)
        waves = max(1, Smax)
        grp = Smax if opts.sink_group == 0 else opts.sink_group
        grp = max(1, min(grp, Smax))

        for it in range(1, opts.max_router_iterations + 1):
            t0 = time.time()
            tw0 = time.perf_counter()
            if it <= opts.incremental_after:
                idx = np.arange(R)
            else:
                idx = np.where(rrm)[0]
            if it > 1 and len(idx) > 1 and n_over > 0:
                I = _pow2_at_least(len(idx))
                # top_k's k is at most the node count
                K = min(_pow2_at_least(min(max(n_over, 1), 4096)), N)
                idx_pad = _pad_to(idx.astype(np.int32), I, -1)
                conflict = conflict_subset(dev, occ, paths,
                                           self._t(idx_pad), K).cpu().numpy()
                groups = _color_schedule(idx,
                                         conflict[:len(idx), :len(idx)])
            else:
                groups = [idx]
            # fanout classes, spatial round-robin inside a class; nets on
            # a full-device box cannot use the windows and go through the
            # global program in batches of their own
            batches = []
            for g in groups:
                parts = ((g[~wide[g]], g[wide[g]]) if win is not None
                         else (g,))
                for gp in parts:
                    batches.extend(_order_and_chunk(
                        gp, nsinks_np, cx_np, cy_np, B))
            if crit_d is None:
                crit_d = self._t(crit)
            # the f32 present factor (jnp.float32(pres_fac))
            pres_t = float(np.float32(pres_fac))
            for sel in batches:
                if len(sel) == 0:
                    continue
                nsel = len(sel)
                b_valid = np.zeros(B, dtype=bool)
                b_valid[:nsel] = True
                sel_d = self._t(_pad_to(sel.astype(np.int32), B, 0))
                valid_d = self._t(b_valid)
                if win is not None and not wide[sel[0]]:
                    selw_d = self._t(_pad_to(win_row[sel].astype(np.int32),
                                             B, 0))
                    (paths, sink_delay, all_reached, occ,
                     steps) = route_batch_resident_win(
                        dev, win, occ, acc, pres_t, paths, sink_delay,
                        all_reached, source_d, sinks_d, crit_d, sel_d,
                        selw_d, valid_d, lb_scale, self.max_len, L_e, waves,
                        grp, mesh=self.mesh)
                else:
                    (paths, sink_delay, all_reached, bb, occ,
                     steps) = route_batch_resident(
                        dev, occ, acc, pres_t, paths, sink_delay,
                        all_reached, bb, source_d, sinks_d, crit_d, sel_d,
                        valid_d, full_bb, self.max_len, L_e, waves, grp,
                        mesh=self.mesh)
                steps_dev = steps_dev + steps
                result.total_net_routes += nsel

            # ONE device->host read per iteration: the reroute mask,
            # reached flags, overuse summary and step counter, packed
            rrm_t, ar_t, n_over_t, over_t, st_t = iteration_summary(
                dev, occ, paths, all_reached, steps_dev)
            summ = torch.cat([rrm_t.to(torch.int32), ar_t.to(torch.int32),
                              torch.stack([n_over_t, over_t, st_t])]
                             ).cpu().numpy()
            rrm, ar = summ[:R].astype(bool), summ[R:2 * R].astype(bool)
            n_over, over_total, st_tot = (int(v) for v in summ[2 * R:])
            it_steps = st_tot - prev_steps
            prev_steps = st_tot

            # a net that failed a sink gets the full device next time
            # (place_and_route.c bb relaxation) and leaves the windowed
            # program for good; any unreached sink means a full-device
            # search comes next, so the path store takes the full budget
            if (~ar).any() and L_e < L_cap:
                paths = _grow_paths(paths, L_cap, N)
                L_e = L_cap
            newly_wide = ~ar & ~wide
            if newly_wide.any():
                wide |= newly_wide
                bb_full |= newly_wide
                result.widened_nets += int(newly_wide.sum())
                bb[self._t(newly_wide)] = full_bb
            # phase-two safety valve (…cxx:6238-6267): plateau_iters
            # iterations without a new best overuse widen every congested
            # net not already on a full-device box
            if n_over < best_over:
                stall = 0
                best_over = n_over
            elif n_over > 0:
                stall += 1
            if stall >= opts.plateau_iters and n_over > 0:
                stuck = rrm & ~bb_full
                if stuck.any():
                    wide |= stuck
                    bb_full |= stuck
                    result.widened_nets += int(stuck.sum())
                    bb[self._t(stuck)] = full_bb
                    if L_e < L_cap:
                        paths = _grow_paths(paths, L_cap, N)
                        L_e = L_cap
                stall = 0
            result.total_relax_steps += it_steps
            # no per-sweep convergence measurement here: every step
            # counts as useful (useful + wasted == total)
            result.total_relax_steps_useful += it_steps
            result.stats.append(RouteStats(
                it, n_over, over_total, len(idx), time.time() - t0,
                relax_steps=it_steps, batches=len(batches),
                overuse_pct=100.0 * n_over / max(1, N)))
            self._obs_window(tw0, it, 1, n_over, over_total, len(idx),
                             it_steps, pres_fac, float("nan"), len(batches))
            if opts.stats_dir and opts.dump_routes:
                _dump_routes(opts.stats_dir, it, paths.cpu().numpy(), N)

            if n_over == 0 and bool(ar.all()):
                result.success = True
                result.iterations = it
                break

            # PathFinder history / present update (congestion.h:177-193)
            acc = acc + float(np.float32(opts.acc_fac)) * torch.clamp(
                occ - dev.capacity, min=0).to(torch.float32)
            pres_fac = min(opts.max_pres_fac, pres_fac * opts.pres_fac_mult)

            if timing_cb is not None:
                result.sink_delay = sink_delay.cpu().numpy()
                new_crit = np.minimum(
                    np.asarray(timing_cb(result), dtype=np.float32), 0.99)
                if np.array_equal(new_crit, crit):
                    # unchanged: keep the device copy
                    get_metrics().counter(
                        "route.pipeline.crit_upload_skips").inc()
                else:
                    crit = new_crit
                    crit_d = None
        else:
            result.iterations = opts.max_router_iterations

        result.wirelength = int(wirelength_on_device(dev, paths))
        result.paths = paths.cpu().numpy()
        result.sink_delay = sink_delay.cpu().numpy()
        result.occ = occ.cpu().numpy()
        self._obs_final(result)
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
                              full_bb, result, B, crop, mlog, resume):
        """The window driver, a generator: the JAX package's
        _route_planes_windows with its pipelined and synchronous modes,
        checkpoints, resume, slicing, the resilience guard and ladder,
        and the fused dispatch, which yields its request."""
        from .planes import (SCAL_MAX_SPAN, live_size_bits,
                             route_window_planes, route_window_planes_fused,
                             unpack_window_status)

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
        if "x" in crop and self.mesh is None:
            cwf, chf = (int(v) for v in crop.split("x"))
            crop_forced = (min(cwf, rr.grid.nx - 1),
                           min(chf, rr.grid.ny - 1))
        elif "x" in crop:
            import warnings

            warnings.warn("crop='WxH' is ignored under a mesh (crops "
                          "are net-local; the spatially sharded path "
                          "keeps full canvases)")
        # a (net, node) mesh keeps full canvases (JAX router.py:1512-1524)
        crop_full = (crop != "auto" and crop_forced is None) \
            or self.mesh is not None
        # static initial bbs: the crop anchor
        bb0_d = self._t(np.stack(
            [term.bb_xmin, term.bb_xmax, term.bb_ymin, term.bb_ymax],
            axis=1).astype(np.int32))
        live_w = (term.bb_xmax - term.bb_xmin + 1).astype(np.int64)
        live_h = (term.bb_ymax - term.bb_ymin + 1).astype(np.int64)
        budget_full = np.zeros(R, dtype=bool)
        if resume is not None:
            # elastic resume (JAX router.py:1525-1591): the host
            # scheduling state of the checkpoint; route() uploaded the
            # device state
            pres = resume.pres
            it_done = resume.it_done
            d = resume.driver
            widx = d["widx"]
            dirty = d["dirty"].copy()
            colors = None if d["colors"] is None else d["colors"].copy()
            wide = d["wide"].copy()
            bb_full = d["bb_full"].copy()
            best_over = d["best_over"]
            stall_windows = d["stall_windows"]
            sweep_boost = d["sweep_boost"]
            precise = d["precise"]
            full_reroute_done = d["full_reroute_done"]
            finish_done = d["finish_done"]
            force_all_next = d["force_all_next"]
            result.widened_nets = d["widened_nets"]
            crop_full = d["crop_full"]
            budget_full = d["budget_full"].copy()
            # the live bb sizes as the last window's summary gave them, in
            # 8-tile buckets (ROADMAP.md C8: the JAX Router takes the exact
            # widths here, so its resumed route leaves the unsliced one)
            live_w, live_h = unpack_window_status(live_size_bits(
                torch.from_numpy(np.asarray(resume.bb))).numpy())[4:]
            fs = resume.fin_save
            if fs is not None:
                # re-arm the pre-finish legal snapshot
                fin_save = tuple(self._upload(a) for a in fs[:5]) + (
                    int(fs[5]),)

        L = int(paths.shape[2])
        L_cap = self.max_len
        next_ckpt = (it_done + opts.checkpoint_every
                     if opts.checkpoint_every else None)
        # cooperative yield target: a checkpoint at the slice's edge
        yield_at = (it_done + opts.slice_iterations
                    if opts.slice_iterations else None)
        if yield_at is not None:
            next_ckpt = (yield_at if next_ckpt is None
                         else min(next_ckpt, yield_at))
        sliced_yield = False
        # the resilience runtime (JAX router.py:1619-1621): its ladder's
        # dimensions are read at every window
        resil_rt = getattr(opts, "resil", None)
        lad = resil_rt.ladder if resil_rt is not None else None
        guarded = resil_rt is not None and resil_rt.guard is not None
        # the plane dtype (JAX router.py:1609-1625, :1713-1720): guarded
        # bf16 commits f32 and shadows in bf16, "off" commits bf16
        pd_req, guard = str(opts.plane_dtype), str(opts.dtype_guard)
        dtype_demoted = lad is not None and lad.level("dtype") > 0
        dtype_validated = False
        reg = get_metrics()
        tr = get_tracer()
        reg.gauge("route.kernel.plane_dtype").set(
            "bf16" if pd_req == "bf16" and not dtype_demoted else "f32")
        program_vk = opts.program == "planes_pallas"
        # a host callback and per-iteration stats rows serialize the loop
        # anyway (JAX router.py:1592-1598)
        pipelined = bool(opts.pipeline) and not opts.stats_dir \
            and not host_cb
        book = None           # the last window's deferred bookkeeping
        pl_tot_host = pl_ov_host = pl_exec = pl_stall = pl_serial = 0.0
        t_prev_end = time.perf_counter()
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
            # the row mesh of this window at the ladder's "mesh" level,
            # re-read every window so that a demotion takes effect at the
            # next window boundary
            rm = self._active_row_mesh(lad)
            # the window's mesh: the (net, node) mesh if the Router has
            # one, else the row mesh (JAX router.py:1729-1733)
            mesh_now = self.mesh if self.mesh is not None else rm
            mesh_vk = (False if mesh_now is None else True if rm is None
                       else (rm.n_shards, rm.impl))
            if rm is not None:
                # the sharded relaxation runs the full canvas: the row
                # mesh splits the canvas instead of the crop ladder
                dispatch = [(dirty, None)]

            stg = self._staging_prefix
            widen_d = (None if opts.sweep_budget_div <= 1
                       else self._staging.put(stg + "widen", budget_full))
            dtype_lvl0 = lad is None or lad.level("dtype") == 0
            shadow_now = (pd_req == "bf16" and guard != "off"
                          and not dtype_demoted and not dtype_validated
                          and dtype_lvl0)
            pd_main = ("bf16" if pd_req == "bf16" and guard == "off"
                       and not dtype_demoted and dtype_lvl0 else "f32")
            # fused iff asked, without a (net, node) mesh, and the
            # ladder's "dispatch" dimension at its top (JAX router.py
            # :1721-1723)
            fused_now = (bool(opts.fused_dispatch) and self.mesh is None
                         and (lad is None or lad.level("dispatch") == 0))
            shadow = []
            if shadow_now:
                # the window-entry state, for the shadow's replay
                sh_state = [t.clone() for t in (occ, acc, paths,
                                                sink_delay, all_reached,
                                                bb, crit_d)]

            def plan_rung(sub, tile, ri):
                """Host planning of one rung of this window's crop
                ladder (JAX router.py:1748-1839): batch plan, sweep
                budget, widen gate, wave cap and the staged uploads,
                shared by the per-rung and the fused dispatch, so both
                run the same rungs."""
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
                    wok = self._staging.put(f"{stg}wok{ri}", wok_np)
                maxfan = int(nsinks_np[sub].max()) if len(sub) else 1
                doubling = opts.sink_group == 0 and not precise
                grp_w = 1 if precise and opts.sink_group == 0 else grp
                waves = (max(1, math.ceil(math.log2(maxfan + 1))) + 1
                         if doubling
                         else min(Smax, _pow2_at_least(
                             math.ceil(maxfan / grp_w) + 1)))
                # the route.kernel span's fields and the layout gauges
                # (JAX's _plan_block_nets), in the port's layout
                kplan = self._plan_block_nets(tile, len(sub), nsw, pd_main,
                                              rm, sel_p.shape[1])
                return dict(
                    tile=tile, nsw=nsw, waves=waves, grp_w=grp_w,
                    doubling=doubling, wok=wok,
                    sel_d=self._staging.put(f"{stg}sel{ri}", sel_p),
                    valid_d=self._staging.put(f"{stg}valid{ri}", valid_p),
                    kplan=kplan, sel_shape=sel_p.shape,
                    ledger=(int(valid_p.sum()), valid_p.shape[1],
                            int(valid_p.any(axis=1).sum())))

            force_until = (it_done + 1 if force_all_next
                           else opts.incremental_after)
            # positions 2-7 and 10 are the window state (_SHADOW_SLOTS)
            state_args = lambda: (  # noqa: E731
                self.pg, dev, occ, acc, paths, sink_delay, all_reached, bb,
                source_d, sinks_d, crit_d, *planes_tbl)

            def rung_call(p, esc):
                """Planned rung ``p`` as route_window_planes (args,
                kwargs); ``esc`` applies acc_fac (the first rung)."""
                args = (*state_args(), p["sel_d"], p["valid_d"], full_bb,
                        pres, opts.pres_fac_mult, opts.max_pres_fac,
                        opts.acc_fac if esc else 0.0, it_done, force_until,
                        K, p["nsw"], L, p["waves"], p["grp_w"],
                        p["doubling"])
                # the mesh re-read at call time: the per-rung fallback of
                # a window whose mesh member died mid-chain must not
                # dispatch onto the dead mesh
                kw = dict(topk=min(4096, N), n_colors=5,
                          crop_tile=p["tile"], bb0_all=bb0_d,
                          widen_ok=p["wok"],
                          mesh=None if self._mesh_lost else mesh_now,
                          plane_dtype=pd_main, **sta_kw)
                return args, kw

            def rung_vkey(p):
                return (p["tile"], K, p["nsw"], L, p["waves"], p["grp_w"],
                        p["doubling"], p["sel_shape"][0], p["sel_shape"][1],
                        p["wok"] is None, program_vk, mesh_vk, bool(sta_kw),
                        R, Smax, N, pd_main)

            t0 = time.time()
            tw0 = time.perf_counter()
            kplans, bucket_occ = [], []
            comp_num = comp_den = 0
            plan_s = plan0_s = call_s = sync_block_s = 0.0
            t_disp0 = None

            def book_ledger(p):
                nonlocal comp_num, comp_den
                kplans.append(p["kplan"])
                nvalid, bg, grows = p["ledger"]
                if grows:
                    bucket_occ.append(nvalid / (grows * bg))
                    comp_num += grows * bg
                    comp_den += grows * B

            def drain(scal, t_after, rung):
                # --sync: drain the dispatch before any further host work
                nonlocal sync_block_s
                scal.cpu()
                te1 = time.perf_counter()
                sync_block_s += te1 - t_after
                reg.counter("route.pipeline.blocking_syncs").inc()
                if tr is not None:
                    tr.mark("route.pipeline.exec", t_after, te1,
                            cat="route", window=widx, rung=rung, K=K,
                            pipelined=False)

            if fused_now:
                # the fused dispatch: every populated rung planned first,
                # then the whole ladder as one route_window_planes_fused
                # call, issued by whoever drives this generator
                tp0 = time.perf_counter()
                plans = [plan_rung(sub, tile, ri)
                         for ri, (sub, tile) in enumerate(dispatch)]
                for p in plans:
                    book_ledger(p)
                rung_desc = tuple((p["tile"], p["nsw"], p["waves"],
                                   p["grp_w"], p["doubling"]) for p in plans)
                widen_oks = (None if all(p["wok"] is None for p in plans)
                             else tuple(p["wok"] for p in plans))
                f_args = (*state_args(),
                          tuple(p["sel_d"] for p in plans),
                          tuple(p["valid_d"] for p in plans), full_bb,
                          pres, opts.pres_fac_mult, opts.max_pres_fac,
                          opts.acc_fac, it_done, force_until, K, L)
                f_kwargs = dict(rung_desc=rung_desc, topk=min(4096, N),
                                n_colors=5, mesh=rm, bb0_all=bb0_d,
                                widen_oks=widen_oks, plane_dtype=pd_main,
                                **sta_kw)
                vkey = ("fused", rung_desc, K, L,
                        tuple(p["sel_shape"] for p in plans),
                        widen_oks is None, program_vk, mesh_vk,
                        bool(sta_kw), R, Smax, N, pd_main)
                dom = max(kplans, key=lambda kp: kp.get("nets", 0))
                get_devprof().note_variant(("fused", rung_desc, K, L), dom)
                if shadow_now:
                    shadow.append((route_window_planes_fused, f_args,
                                   f_kwargs, vkey))

                def per_rung_fb(plans=plans, vkey=vkey):
                    # the ladder's "dispatch" fallback: the same planned
                    # rungs, one call each, occ and acc threaded rung to
                    # rung as the fused call threads them
                    scals = []
                    st = None
                    for ri2, p2 in enumerate(plans):
                        _note_dispatch_variant(vkey + ("per_rung", ri2))
                        a2, kw2 = rung_call(p2, ri2 == 0)
                        if st is not None:
                            a2 = a2[:2] + st + a2[4:]
                        out2 = route_window_planes(*a2, **kw2)
                        st = out2[:2]
                        scals.append(out2[3])
                    return out2[:3] + (torch.stack(scals), out2[4])

                tp1 = time.perf_counter()
                plan_s = plan0_s = tp1 - tp0
                t_disp0 = tp1
                if tr is not None:
                    tr.mark("route.pipeline.plan", tp0, tp1, cat="route",
                            stage="plan", window=widx, rung=0,
                            nets=len(dirty), fused=True,
                            rungs=len(dispatch))
                occ, acc, status, scal_stack, dmax_hist = yield \
                    WindowDispatchRequest(vkey, f_args, f_kwargs,
                                          per_rung_fb, resil_rt)
                tp2 = time.perf_counter()
                call_s = tp2 - tp1
                if not pipelined:
                    drain(scal_stack, tp2, 0)
                last_plan = plans[-1]
            else:
                scals = []
                for ri, (sub, tile) in enumerate(dispatch):
                    tp0 = time.perf_counter()
                    p = plan_rung(sub, tile, ri)
                    args, kw = rung_call(p, ri == 0)
                    vkey = rung_vkey(p)
                    if not guarded:
                        # a guarded dispatch notes the rung it ran
                        _note_dispatch_variant(vkey)
                    get_devprof().note_variant(
                        (p["tile"], K, p["nsw"], L, p["waves"], p["grp_w"]),
                        p["kplan"])
                    tp1 = time.perf_counter()
                    plan_s += tp1 - tp0
                    if ri == 0:
                        plan0_s, t_disp0 = tp1 - tp0, tp1
                    if tr is not None:
                        tr.mark("route.pipeline.plan", tp0, tp1,
                                cat="route", stage="plan", window=widx,
                                rung=ri, nets=len(sub),
                                tile=None if tile is None else list(tile))
                    if guarded:
                        occ, acc, status, scal, dmax_hist = \
                            self._guarded_dispatch(resil_rt, vkey, args, kw)
                    elif self._library is not None:
                        # the program library: known variants run with
                        # their launch plans installed; misses note
                        # their plans for export_program_library()
                        occ, acc, status, scal, dmax_hist = \
                            self._library.dispatch(
                                vkey, route_window_planes, args, kw)
                    else:
                        occ, acc, status, scal, dmax_hist = \
                            route_window_planes(*args, **kw)
                    tp2 = time.perf_counter()
                    call_s += tp2 - tp1
                    if shadow_now:
                        shadow.append((route_window_planes, args, kw,
                                       vkey))
                    scals.append(scal)
                    if not pipelined:
                        drain(scal, tp2, ri)
                    book_ledger(p)
                    last_plan = p
                scal_stack = torch.stack(scals)
            rung_cropped = [tile is not None for _, tile in dispatch]
            force_all_next = False
            # one relaxation dispatch per window when fused, one per
            # populated crop rung otherwise (the bf16 shadow's replays
            # are not counted)
            reg.set_gauges({
                "route.kernel.fused_rungs": len(dispatch),
                "route.kernel.dispatches_per_window":
                    1 if fused_now else len(dispatch)})
            # the window's packed summary, copied to the host without
            # blocking; read at the stall below
            summary = _HostCopy(
                [status, scal_stack]
                + ([dmax_hist] if analyzer is not None else []))

            # the overlapped host stage: the previous window's bookkeeping
            # while this one is in flight
            book_s = 0.0
            if book is not None:
                tb0 = time.perf_counter()
                bwidx = book["widx"]
                self._book_window(book, result, mlog)
                book = None
                tb1 = time.perf_counter()
                book_s = tb1 - tb0
                if tr is not None:
                    tr.mark("route.pipeline.plan", tb0, tb1, cat="route",
                            stage="summary", window=bwidx)

            # the stall: the window's one blocking point when pipelined
            t_st0 = time.perf_counter()
            host = summary.numpy()
            t_st1 = time.perf_counter()
            status_np, scal_all = host[0], host[1]
            dmax_np = host[2] if analyzer is not None else None
            scal_np = scal_all[-1]
            if shadow:
                # the dtype guard: replay the window's calls in bf16 on
                # the window-entry copies and band-compare the summaries
                s_status, s_scal = _shadow_window(shadow, sh_state)
                if _dtype_band_ok(status_np, scal_np, s_status, s_scal):
                    dtype_validated = guard == "route"
                else:
                    dtype_demoted = True
                    reg.counter("route.kernel.dtype_demotions").inc()
                    reg.gauge("route.kernel.plane_dtype").set("f32")
                    if lad is not None:
                        lad.step("dtype", "bf16 window summary left the "
                                 "declared ulp band")

            # pipeline accounting (JAX router.py:2232-2281)
            stall_s = (t_st1 - t_st0) + sync_block_s
            if pipelined:
                reg.counter("route.pipeline.blocking_syncs").inc()
                exec_s = t_st1 - t_disp0
                serial_s = t_disp0 - t_prev_end
                if tr is not None:
                    tr.mark("route.pipeline.exec", t_disp0, t_st1,
                            cat="route", window=widx, K=K,
                            rungs=1 if fused_now else len(dispatch),
                            pipelined=True)
            else:
                exec_s = call_s + sync_block_s
                serial_s = (t_st1 - t_prev_end) - exec_s
            t_prev_end = t_st1
            tot_host_w = plan_s + book_s
            ov_host_w = (plan_s - plan0_s) + book_s if pipelined else 0.0
            pl_tot_host += tot_host_w
            pl_ov_host += ov_host_w
            pl_exec += exec_s
            pl_stall += stall_s
            pl_serial += serial_s
            pfx = "route.pipeline."
            reg.set_gauges({
                pfx + "host_plan_ms": round(tot_host_w * 1e3, 3),
                pfx + "device_exec_ms": round(exec_s * 1e3, 3),
                pfx + "stall_ms": round(stall_s * 1e3, 3),
                pfx + "overlap_frac": round(
                    pl_exec / max(pl_exec + pl_serial, 1e-9), 4),
                pfx + "host_overlap_frac": round(
                    pl_ov_host / max(pl_tot_host, 1e-9), 4),
                pfx + "host_plan_ms_total": round(pl_tot_host * 1e3, 3),
                pfx + "device_exec_ms_total": round(pl_exec * 1e3, 3),
                pfx + "stall_ms_total": round(pl_stall * 1e3, 3),
                pfx + "host_serial_ms_total": round(pl_serial * 1e3, 3)})

            # control: everything below feeds the next dispatch, so it
            # stays at the stall in both modes
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
            cpd = (float(dmax_np[K - 1]) if analyzer is not None
                   else float("nan"))
            # the window's bookkeeping, every field a captured value
            book = dict(
                widx=widx, it_done=it_done, K=K, n_over=n_over,
                over_total=over_total, ndirty=len(dirty), pres=pres,
                cpd=cpd, t_wall0=t0, t_wall1=time.time(), tw0=tw0,
                tw1=t_st1, rung_scals=list(zip(scal_all, rung_cropped)),
                bucket_occ=bucket_occ,
                compaction=comp_num / max(1, comp_den), kplans=kplans,
                colors_max=int(np.max(colors) + 1
                               if colors is not None and len(colors)
                               else 0),
                dirty_next=int(rrm.sum()), precise=precise,
                sweep_boost=sweep_boost, widened=result.widened_nets,
                dmax_hist=dmax_np,
                occ_ref=self._occ_snapshot(occ, pipelined, mlog),
                # one rung under a mesh: the last plan is the window's.
                # The mesh resolved after the dispatch, so that a window
                # whose member died mid-chain books as one device
                halo=(None if self.row_mesh is None else
                      (None if rm is None or self._mesh_lost else rm,
                       scal_np, last_plan["sel_shape"][1] if len(dirty)
                       else 1, pd_main)))
            if analyzer is not None and cpd == cpd:
                analyzer.crit_path_delay = cpd
            if not pipelined:
                self._book_window(book, result, mlog)
                book = None
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
                if np.array_equal(new_crit, crit):
                    get_metrics().counter(
                        "route.pipeline.crit_upload_skips").inc()
                else:
                    crit = new_crit
                    crit_d = torch.tensor(crit, device=self.device)

            if next_ckpt is not None and it_done >= next_ckpt:
                # the window-boundary snapshot (JAX router.py:2448-2494):
                # everything a resume needs, under any device or mesh
                tc0 = time.perf_counter()
                a = [_host_snapshot(t) for t in (
                    occ, acc, paths, sink_delay, all_reached, bb, crit_d)]
                fin_ck = None
                if fin_save is not None:
                    # the finishing pass is live: carry its legal state
                    fin_ck = tuple(_host_snapshot(t)
                                   for t in fin_save[:5]) + (
                        int(fin_save[5]),)
                result.checkpoint = RouteCheckpoint(
                    *a, it_done=it_done, pres=pres, driver=dict(
                        widx=widx, dirty=dirty.copy(),
                        colors=(None if colors is None
                                else np.asarray(colors).copy()),
                        wide=wide.copy(), bb_full=bb_full.copy(),
                        best_over=best_over, stall_windows=stall_windows,
                        sweep_boost=sweep_boost, precise=precise,
                        full_reroute_done=full_reroute_done,
                        force_all_next=force_all_next,
                        finish_done=finish_done,
                        budget_full=budget_full.copy(),
                        widened_nets=result.widened_nets,
                        crop_full=crop_full),
                    fin_save=fin_ck)
                next_ckpt = it_done + opts.checkpoint_every
                mlog.log("elastic", event="checkpoint", it_done=it_done,
                         pres=round(pres, 4))
                reg.counter("route.elastic.checkpoints").inc()
                reg.counter("route.elastic.checkpoint_ms_total").inc(round(
                    (time.perf_counter() - tc0) * 1e3, 3))
                if yield_at is not None and it_done >= yield_at:
                    # the slice's yield: the checkpoint is the resume
                    # point
                    sliced_yield = True
                    result.iterations = it_done
                    break
        else:
            result.iterations = opts.max_router_iterations

        if book is not None:
            # the last window's bookkeeping, after the device is idle
            tb0 = time.perf_counter()
            self._book_window(book, result, mlog)
            pl_tot_host += time.perf_counter() - tb0
            reg.set_gauges({
                "route.pipeline.host_overlap_frac": round(
                    pl_ov_host / max(pl_tot_host, 1e-9), 4),
                "route.pipeline.host_plan_ms_total": round(
                    pl_tot_host * 1e3, 3)})

        if not result.success and fin_save is not None and not sliced_yield:
            # the finishing pass could not re-legalize within budget:
            # restore the pre-finish legal state (a slice's yield keeps
            # the in-finish state: its checkpoint carries fin_save)
            occ, paths, sink_delay, all_reached, bb, fin_it = fin_save
            result.success = True
            result.iterations = fin_it
        result.wirelength = int(wirelength_on_device(dev, paths))
        result.paths = paths.cpu().numpy()
        result.sink_delay = sink_delay.cpu().numpy()
        result.occ = occ.cpu().numpy()
        return result
