"""The planes relaxation's hand-written CUDA kernels: the counterpart of
parallel_eda_tpu/route/planes_pallas.py.

    planes_relax_full_cuda    -> planes_relax_full_kernel
        replaces planes_relax_pallas / _sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:308 / :218)
    planes_relax_cropped_cuda -> planes_relax_cropped_kernel
        replaces planes_relax_cropped_pallas / _crop_sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:477 / :417)
    planes_relax_cluster_cuda -> planes_relax_cluster_kernel
        the whole lag-1 row-sharded relaxation with every shard on one
        card: one thread-block cluster per net, one CTA per shard
    planes_relax_peer_cuda    -> planes_relax_peer_kernel
        the whole row-sharded relaxation on any other mesh (shards across
        cards, the lag-2 schedule, the resilience ladder's per-sweep
        mesh): one persistent cooperative launch per card, halos stored
        into the neighbours' mailboxes, the fixpoint decided on the card
        (JAX planes_shard.py planes_relax_sharded :268: K2's kernel per
        shard per sweep, remote_slab_permute between sweeps)
    planes_relax_node_cuda    -> planes_relax_node_kernel
        the (net, node) mesh's node axis: each net's canvases split by
        columns over a node row (route/nodesplit.py), one persistent
        cooperative launch per card of the row on the peer kernel's
        plan, the x-scans across the members in lax.associative_scan's
        grouping and the halos of the same sweep, bit-identical to K1
        (JAX planes.py:906-975, planes_relax with X on the "node" axis,
        which GSPMD splits)

All are compiled from csrc/planes_relax.cu with nvcc for sm_90a into
``parallel_eda_tpu_torch/build/`` at first use and loaded through a
plain C interface with ctypes.  One thread block (one cluster, one set
of partner blocks) relaxes one net for the whole bounded sweep loop, so
a relaxation is one launch per card; the net's dist planes (and, where
they fit beside them, its scan costs) live in shared memory, and its
line scans run level-parallel on lane groups of a warp (design,
exactness argument and what bounds it: the note at the top of the .cu
file).  Every kernel reads and writes the [B, ncells] flats itself and
keeps a plan per (planes graph, batch, tile or shards, card, mode): a
call allocates its outputs, sets their pointers and launches.  The
wrappers take CUDA tensors only and raise on anything else; the CPU path
is the plain version in planes.py / planes_shard.py.  Each wrapper
counts its launches in ``<wrapper>.launches`` (f32 plane mode) and
``<wrapper>.launches_bf16`` (bf16 plane mode: ``plane_dtype="bf16"``,
dist and wenter carried in bfloat16 between f32 sweeps), and per
shared-memory mode in ``<wrapper>.mode_launches`` (0 global state, 1
dist in shared memory, 2 dist and scan costs); each keeps the mode of
its last launch in ``<wrapper>.last_mode``.  All take and return the
f32 flats in both plane modes.

``kernel_mode_cap(cap)`` caps the auto mode of every launch made inside
it (the "kernel" dimension of the resilience ladder, resil/ladder.py:
None, 1 or 0); a wrapper given ``mode=`` takes that mode as it is.  While
the process's DevProfiler (obs/devprof.py) is enabled, each launch is
bracketed by a pair of CUDA events on its stream, read only at the
profiler's ``capture_all``.

``kernel_layout`` is the port's meaning of the JAX package's
route.kernel.* layout gauges (JAX router.py _plan_block_nets): nets per
thread block, canvas cells over launched thread-slots, and the modelled
global-memory bytes of one sweep in the mode the launch takes (with the
card's shared-memory limit modelled by ``SMEM_OPTIN``, so that the CPU
route reports the card's plan).
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Tuple

import torch

from ..obs.devprof import get_devprof

from .cuda_lib import CudaLib, Launch, check_tensor as _check
from .planes import crop_origin_hi, plane_torch_dtype
from .shard_kernels import MAX_SHARDS, _enable_peers

# how a launch addresses its nets (csrc/planes_relax.cu Kind)
FULL, PEER, TILE, CLUSTER, NODE = 0, 1, 2, 3, 4
# launch table sizes (csrc/planes_relax.cu unpack, launch_peer,
# launch_node)
NPTR, NINT = 31, 20
NPEER_PTR, NPEER_INT = 33, 23
NNODE_PTR, NNODE_INT = 35, 25


def threads_for(ncells: int) -> int:
    """Threads per block before the scratch is counted: 1024 for a large
    canvas, 512 for a small one (fewer warps at each barrier)."""
    return 1024 if ncells > 4096 else 512


# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100 (227 KB, the H200's
# too): the limit the planner plans threads with (csrc/planes_relax.cu
# SMEM_PLAN) and kernel_layout models the auto mode with
SMEM_OPTIN = 232448
# the fewest threads the planner gives a block (csrc MIN_THREADS)
MIN_THREADS = 512
# The scan line limit (csrc MAX_LINE): the longest line (X along x, Y
# along y) for which mode 0 fits SMEM_OPTIN at MIN_THREADS, a line of
# more than 128 cells taking one warp's scratch of 2n+1 floats alone.
MAX_LINE = ((SMEM_OPTIN - 8) // (4 * (MIN_THREADS // 32)) - 1) // 2
# the most cells of a net's flats row (csrc MAX_CELLS): int32 cell ids,
# cell loops that step up to four blocks of 1024 threads past the end
MAX_CELLS = 2 ** 31 - 1 - 4 * 1024


def _line_lanes(n: int) -> int:
    g = 2
    while g * 8 < n and g < 32:
        g *= 2
    return g


def warp_scratch(X: int, Y: int) -> int:
    """Scan scratch floats of a warp (csrc scratch_per_warp): the more of
    the two planes' 32 / G lines of 2 len + 1 floats (the chanx plane's
    lines have X cells, the chany plane's Y)."""
    return max((2 * n + 1) * (32 // _line_lanes(n)) for n in (X, Y))


def _smem(kind: int, mode: int, W: int, X: int, Y: int,
          threads: int) -> int:
    ncells = W * X * (Y + 1) + W * (X + 1) * Y
    return (4 * (mode * ncells + threads // 32 * warp_scratch(X, Y))
            + (8 if kind == CLUSTER else 0))


def plan_threads(kind: int, W: int, X: int, Y: int) -> int:
    """Threads per block of a launch on a (W, X, Y) block (csrc
    plan_threads): threads_for's, halved while mode 0 (the scratch
    alone) would not fit SMEM_OPTIN, down to MIN_THREADS."""
    t = threads_for(W * X * (Y + 1) + W * (X + 1) * Y)
    while t > MIN_THREADS and _smem(kind, 0, W, X, Y, t) > SMEM_OPTIN:
        t //= 2
    return t


def smem_bytes(kind: int, mode: int, W: int, X: int, Y: int) -> int:
    """Dynamic shared bytes of a launch in ``mode`` (csrc/planes_relax.cu
    smem_bytes): ``mode`` floats per canvas cell, the line-scan scratch
    of every warp at plan_threads' threads, and the cluster's two
    flags."""
    return _smem(kind, mode, W, X, Y, plan_threads(kind, W, X, Y))


KIND_NAMES = {FULL: "planes_relax_full_cuda (K1)",
              TILE: "planes_relax_cropped_cuda (K2)",
              CLUSTER: "planes_relax_cluster_cuda",
              PEER: "planes_relax_peer_cuda",
              NODE: "planes_relax_node_cuda"}


class KernelShapeError(ValueError):
    """A launch the relaxation kernels cannot plan: a scan line longer
    than MAX_LINE or a net of more than MAX_CELLS cells."""


def check_kernel_shape(kind: int, W: int, X: int, Y: int, nc: int = 0,
                       what: str = "grid") -> None:
    """Raise KernelShapeError unless a launch of ``kind`` on a (W, X, Y)
    block (lines of X cells along x, Y along y) of a canvas of ``nc``
    cells per net can be planned: every such launch has a shared-memory
    mode that fits (mode 0 at plan_threads' threads)."""
    cells = max(int(nc), W * X * (Y + 1) + W * (X + 1) * Y)
    head = f"{what}, block W={W} X={X} Y={Y}: {KIND_NAMES[kind]} takes"
    if max(X, Y) > MAX_LINE:
        raise KernelShapeError(
            f"{head} scan lines of at most {MAX_LINE} cells (the card's "
            f"scan line limit), this one has {max(X, Y)}")
    if cells > MAX_CELLS:
        raise KernelShapeError(
            f"{head} at most {MAX_CELLS} cells per net (int32 cell ids), "
            f"this one has {cells}")


def check_canvas(shape_x, shards: int = 0, node: int = 0) -> None:
    """The card's limit on a route's canvas of plane shape ``shape_x``
    (W, NX, NY + 1), checked by Router.__init__ before any work: K1 on
    the whole canvas (K2's tiles lie inside it), for a row mesh of
    ``shards`` the sharded kernels on a shard's block, and for a node
    axis of ``node`` > 1 devices the node kernel on a member's block.
    The CPU route has no such limit."""
    W, NX, NYp1 = shape_x
    nc = W * NX * NYp1 + W * (NX + 1) * (NYp1 - 1)
    for kind in (FULL, CLUSTER) if shards > 1 else (FULL,):
        mesh = f" at mesh_shards={shards}" if kind == CLUSTER else ""
        check_kernel_shape(kind, *_launch_shape(shape_x, kind, None, shards),
                           nc, f"grid {NX}x{NYp1 - 1}{mesh}")
    if node > 1:
        check_kernel_shape(NODE, *_launch_shape(shape_x, NODE, None, node),
                           nc, f"grid {NX}x{NYp1 - 1} at node axis {node}")


def auto_mode(kind: int, W: int, X: int, Y: int,
              cap_bytes: int = SMEM_OPTIN) -> int:
    """The mode a launch takes without ``mode=`` (csrc/planes_relax.cu
    auto_mode): the most shared state within ``cap_bytes``."""
    for mode in (2, 1):
        if smem_bytes(kind, mode, W, X, Y) <= cap_bytes:
            return mode
    return 0


# the kernel ladder's cap on the auto mode (kernel_mode_cap)
_MODE_CAP = [None]


@contextlib.contextmanager
def kernel_mode_cap(cap):
    """Cap the shared-memory mode of every launch in the block at
    ``cap`` (None: the auto mode), the port's "kernel" ladder levels."""
    old = _MODE_CAP[0]
    _MODE_CAP[0] = cap
    try:
        yield
    finally:
        _MODE_CAP[0] = old


def _launch_shape(shape_x, kind: int, tile=None, shards: int = 0):
    """(W, X, Y) of one launch's block (the table's v[1..3]) on a canvas
    of plane shape ``shape_x`` (planes_shard.row_block_cols for the
    sharded kinds)."""
    W, NX, NYp1 = shape_x
    if kind == TILE:
        return W, int(tile[0]), int(tile[1])
    if kind in (CLUSTER, PEER, NODE):
        return W, max(2, -(-(NX + 2) // shards)) + 2, NYp1 - 1
    return W, NX, NYp1 - 1


# global bytes per canvas cell: a relaxation's flats (d0, cc, wenter0
# read; dist, pred, wenter written; f32 in both plane modes), and one
# sweep of state kept in global memory (cc read, dist and wenter in the
# plane dtype read and written, pred read and written)
FLATS_BYTES_PER_CELL = 24


def global_sweep_bytes_per_cell(itemsize: int) -> int:
    return 4 + 4 * int(itemsize) + 8


def kernel_layout(shape_x, shape_y, nnets: int, nsweeps: int, tile=None,
                  shards: int = 0, peer: bool = False,
                  plane_dtype: str = "f32") -> dict:
    """The route.kernel.* row of one dispatch in the port's layout:
    ``variant`` (the wrapper and the mode its launch takes, e.g.
    "planes_relax_cropped_cuda/mode2"), ``mode``, ``block_nets`` (nets
    per thread block: 1 for K1 and K2, 1 per cluster or set of partner
    blocks for the sharded kernels), ``lane_occupancy`` (the net's
    canvas cells over the thread-slots launched for it: plan_threads'
    threads per block, each taking ceil(cells / threads) cells) and
    ``bytes_per_sweep`` (the global-memory bytes of one sweep over
    ``nnets`` nets: in modes 1-2 the flats' one load and one store per
    relaxation amortised over ``nsweeps``, in mode 0 one traversal of
    the state per sweep).  ``shards``: a row mesh's relaxation, the
    cluster kernel, or with ``peer`` the peer kernel.  ``shape_x`` /
    ``shape_y``: the full canvas's plane shapes (PlanesGraph.shape_x /
    shape_y)."""
    from .planes import plane_itemsize

    kind = (TILE if tile is not None else PEER if peer
            else CLUSTER if shards else FULL)
    W, X, Y = _launch_shape(shape_x, kind, tile, shards)
    ncanvas = (W * shape_x[1] * shape_x[2]
               + shape_y[0] * shape_y[1] * shape_y[2])
    blk = W * X * (Y + 1) + W * (X + 1) * Y
    thr = plan_threads(kind, W, X, Y)
    slots = thr * -(-blk // thr) * (shards if kind in (CLUSTER, PEER)
                                    else 1)
    cells = blk if kind == TILE else ncanvas
    mode = auto_mode(kind, W, X, Y)
    n = max(1, int(nnets))
    if mode == 0:
        per_sweep_bytes = (global_sweep_bytes_per_cell(
            plane_itemsize(plane_dtype)) * cells * n)
    else:
        # K2 reads and writes the full flats and relaxes the tile
        flats = (FLATS_BYTES_PER_CELL * cells if kind != TILE else
                 (FLATS_BYTES_PER_CELL - 4) * ncanvas + 4 * cells)
        per_sweep_bytes = flats * n / max(1, int(nsweeps))
    name = {FULL: "planes_relax_full_cuda", TILE: "planes_relax_cropped_cuda",
            CLUSTER: "planes_relax_cluster_cuda",
            PEER: "planes_relax_peer_cuda"}[kind]
    return dict(variant=f"{name}/mode{mode}", mode=mode, block_nets=1,
                lane_occupancy=round(cells / slots, 4),
                bytes_per_sweep=int(per_sweep_bytes))


def _setup(lib) -> None:
    for fn in (lib.planes_relax_full_launch, lib.planes_relax_cropped_launch,
               lib.planes_relax_cluster_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.planes_relax_peer_launch, lib.planes_relax_node_launch):
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    lib.planes_relax_max_line.restype = ctypes.c_int
    lib.planes_relax_max_cells.restype = ctypes.c_longlong
    lib.planes_relax_threads.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.planes_relax_threads.restype = ctypes.c_int
    lib.planes_relax_smem.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.planes_relax_smem.restype = ctypes.c_longlong
    lib.planes_relax_mode.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.planes_relax_mode.restype = ctypes.c_int
    for fn in (lib.planes_relax_cluster_fit, lib.planes_relax_peer_fit,
               lib.planes_relax_node_fit):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.planes_relax_zero_total.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.planes_relax_zero_total.restype = ctypes.c_int


LIB = CudaLib("planes_relax", _setup)


# the geometry arrays of the launch table, slots 14..25
_GEOM_PTR_NAMES = ("brk_before_x", "brk_after_x", "first_x", "last_x",
                   "brk_before_y", "brk_after_y", "first_y", "last_y",
                   "delay_x", "delay_y", "delay_y_rot0", "delay_y_rot1")


def _geom_ptrs(g, directional: bool, inc_track):
    """Geometry pointers 14..26 of the launch table."""
    ptrs = []
    for k in _GEOM_PTR_NAMES:
        t = getattr(g, k)
        if not t.is_contiguous():
            raise ValueError(f"geometry {k} must be contiguous")
        ptrs.append(t.data_ptr())
    ptrs.append(inc_track.data_ptr() if directional else 0)
    return ptrs


def _ints(kind, B, W, X, Y, stride_x, directional, gstr, mode, device, NX,
          ncx, nc, origin_hi=(0, 0), shards=0, kx=0, plane_dtype="f32"):
    """The launch table's integers (csrc/planes_relax.cu unpack; nsweeps,
    slot 6, is set per call)."""
    return ([B, W, X, Y, stride_x, int(directional), 0] + list(gstr)
            + [plan_threads(kind, W, X, Y), -1 if mode is None else int(mode),
               device.index, NX, ncx, nc, int(origin_hi[0]),
               int(origin_hi[1]), shards, kx, int(plane_dtype == "bf16")])


def _count(wrapper, plane_dtype: str, mode: int) -> None:
    if plane_dtype == "bf16":
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1
    wrapper.mode_launches[mode] += 1


def cluster_geometry(pg, shards: int):
    """The cluster relaxation's block geometry: planes_shard's per-shard
    geometry (padded) stacked on a leading [shards] axis, contiguous on
    pg's device; and kx.  The kernel computes the ids and parity that
    the stack also holds."""
    from .planes_shard import _geom_blocks, row_block_cols

    kx = row_block_cols(pg, shards)
    return _geom_blocks(pg, shards, kx), kx


class _FlatsPlan:
    """The Launch of a relaxation that reads and writes the [B, ncells]
    flats (K1, K2, the cluster relaxation) for one (kind, planes graph,
    batch, tile or shards, card, mode, plane dtype), built once: the
    geometry, the shapes and the shared-memory mode are fixed; a call
    sets its tensors' pointers and nsweeps in the Launch's tables."""

    def __init__(self, kind: int, pg, B: int, device: torch.device, mode,
                 tile=None, shards: int = 0, plane_dtype: str = "f32"):
        W, NX, NYp1 = pg.shape_x
        lib = LIB.get()
        nc = pg.ncells
        ncx = W * NX * NYp1
        self.pg, self.nc, self.kind = pg, nc, kind
        # per-net x-plane and per-output plane byte offsets; output shapes
        self.ncx_bytes, self.plane_bytes = 4 * ncx, 4 * B * nc
        self.shapes = ((3, B, nc), (B + 1, 2))
        self.ws_numel = 0
        geom, gstr, hi, kx = pg, (0, 0), (0, 0), 0
        X, Y = NX, NYp1 - 1
        if kind == FULL:
            fn, what = lib.planes_relax_full_launch, "planes relaxation"
        elif kind == TILE:
            X, Y = tile
            hi = crop_origin_hi(pg, X, Y)
            fn, what = lib.planes_relax_cropped_launch, "cropped relaxation"
        else:
            geom, kx = cluster_geometry(pg, shards)
            X = kx + 2
            gstr = (W * X * NYp1, W * (X + 1) * Y)
            fn, what = lib.planes_relax_cluster_launch, "cluster relaxation"
        check_kernel_shape(kind, W, X, Y, nc,
                           f"{'crop tile' if kind == TILE else 'canvas'} "
                           f"of the {NX}x{NYp1 - 1} grid")
        ptrs = ([0] * 14 + _geom_ptrs(geom, pg.directional, pg.inc_track)
                + [0] * (NPTR - 27))
        self.run = Launch(fn, ptrs, _ints(
            kind, B, W, X, Y, NYp1, pg.directional, gstr, mode, device, NX,
            ncx, nc, hi, shards, kx, plane_dtype), device, what,
            keep=(pg, geom))
        self.mode = lib.planes_relax_mode(kind, self.run.v)
        if kind == CLUSTER:
            if self.mode == 0:
                self.ws_numel = B * shards * (W * X * (Y + 1)
                                              + W * (X + 1) * Y)
            fit = lib.planes_relax_cluster_fit(self.run.v)
            if fit < 0:
                raise RuntimeError(f"cluster relaxation: the occupancy "
                                   f"query failed (cudaError {-fit})")
            if fit == 0:
                raise RuntimeError(
                    f"cluster relaxation: the card cannot schedule a "
                    f"cluster of {shards} blocks of {self.run.v[9]} "
                    f"threads in shared-memory mode {self.mode}")


_PLANS: dict = {}
# the program library's plan log (serve/library.py): while a list is
# installed here, every _plan call appends its arguments and the figures
# of the plan it returned
_PLAN_LOG = [None]


@contextlib.contextmanager
def record_plans():
    """Collect the launch plans the block's launches use, as records of
    ``plan_record``'s form (a library entry's blob)."""
    log: list = []
    _PLAN_LOG[0] = log
    try:
        yield log
    finally:
        _PLAN_LOG[0] = None


def plan_figures(plan: _FlatsPlan) -> dict:
    """A launch plan's kernel kind, shared-memory mode, grid, block and
    dynamic shared bytes (the figures kernel_layout models)."""
    v = plan.run.v
    shards = int(v[17])
    return dict(kind=plan.kind, mode=int(plan.mode),
                grid=int(v[0]) * (shards if plan.kind == CLUSTER else 1),
                block=int(v[9]),
                smem=smem_bytes(plan.kind, int(plan.mode), int(v[1]),
                                int(v[2]), int(v[3])))


def plan_record(kind: int, B: int, tile, shards: int, mode, cap,
                plane_dtype: str, plan: _FlatsPlan) -> dict:
    """One plan log entry: ``_plan``'s arguments, the mode cap in force,
    and ``plan_figures``."""
    return dict(args=dict(kind=int(kind), B=int(B),
                          tile=None if tile is None else [int(t) for t in tile],
                          shards=int(shards),
                          mode=None if mode is None else int(mode),
                          cap=None if cap is None else int(cap),
                          plane_dtype=plane_dtype),
                figures=plan_figures(plan))


def install_plan(rec: dict, pg) -> None:
    """Build the launch plan a ``plan_record`` describes for the planes
    graph ``pg`` (on its card) and check that its figures are the
    recorded ones; raises ValueError when they differ."""
    a = rec["args"]
    with kernel_mode_cap(a["cap"]):
        plan = _plan(a["kind"], pg, a["B"], pg.device, a["mode"],
                     None if a["tile"] is None else tuple(a["tile"]),
                     a["shards"], a["plane_dtype"])
    got = plan_figures(plan)
    if got != rec["figures"]:
        raise ValueError(f"launch plan drift: {got} != {rec['figures']}")


def _plan(kind: int, pg, B: int, device: torch.device, mode, tile=None,
          shards: int = 0, plane_dtype: str = "f32") -> _FlatsPlan:
    """The launch plan; without ``mode`` the auto mode, capped by
    kernel_mode_cap."""
    plan = _plan_exact(kind, pg, B, device, mode, tile, shards, plane_dtype)
    cap = _MODE_CAP[0]
    if mode is None and cap is not None and plan.mode > cap:
        plan = _plan_exact(kind, pg, B, device, int(cap), tile, shards,
                           plane_dtype)
    log = _PLAN_LOG[0]
    if log is not None:
        log.append(plan_record(kind, B, tile, shards, mode, cap,
                               plane_dtype, plan))
    return plan


def _plan_exact(kind: int, pg, B: int, device: torch.device, mode,
                tile=None, shards: int = 0,
                plane_dtype: str = "f32") -> _FlatsPlan:
    plane_torch_dtype(plane_dtype)
    key = (kind, id(pg), B, tile, shards, device.index, mode, plane_dtype)
    plan = _PLANS.get(key)
    if plan is None or plan.pg is not pg:
        if len(_PLANS) > 64:
            _PLANS.clear()
        plan = _PLANS[key] = _FlatsPlan(kind, pg, B, device, mode, tile,
                                        shards, plane_dtype)
    return plan


def drop_plans() -> None:
    """Forget every launch plan (each holds its planes graph and launch
    tables on the device): for a caller that replaces the graph, as a
    channel-width search does at each width."""
    _PLANS.clear()


def _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0):
    """The flats' checks; returns crit as a contiguous [B] tensor.  The
    flats must lie on the planes graph's card, whose geometry the launch
    reads (a net-mesh member relaxes on its own copy of the graph)."""
    if d0_flat.device != pg.device:
        raise ValueError(f"the flats are on {d0_flat.device}, the planes "
                         f"graph on {pg.device}")
    B, nc = d0_flat.shape
    for t, n in ((d0_flat, "d0_flat"), (cc_flat, "cc_flat"),
                 (wenter0, "wenter0")):
        _check(t, torch.float32, (B, nc), n)
    if nc != pg.ncells:
        raise ValueError("d0_flat width must be pg.ncells")
    crit = crit_c.reshape(B)
    if not crit.is_contiguous():
        crit = crit.contiguous()
    _check(crit, torch.float32, (B,), "crit_c")
    return crit


def _launch_flats(plan: _FlatsPlan, d0_flat, cc_flat, crit, wenter0,
                  nsweeps: int, extra=(), name: str = ""):
    """Allocate the outputs, set the plan's pointers (``extra``: (slot,
    pointer) pairs) and launch once.  Returns (dist, pred, wenter,
    stats [B + 1, 2]): each net's [executed, useful] sweeps, then their
    max over nets."""
    dev = d0_flat.device
    B = d0_flat.shape[0]
    # dist, pred (int32 bits), wenter in one allocation.  The plan holds
    # every size and the pointers are set in one slice: at the bench size
    # the wrapper's host time is as long as the kernel.
    out = torch.empty(plan.shapes[0], dtype=torch.float32, device=dev)
    stats = torch.empty(plan.shapes[1], dtype=torch.int32, device=dev)
    d, c, w = d0_flat.data_ptr(), cc_flat.data_ptr(), wenter0.data_ptr()
    o, st = out.data_ptr(), stats.data_ptr()
    e, f = plan.ncx_bytes, plan.plane_bytes
    run = plan.run
    run.p[0:14] = (d, d + e, c, c + e, w, w + e, crit.data_ptr(), o, o + e,
                   o + f, o + f + e, o + 2 * f, o + 2 * f + e, st)
    run.p[27] = st + 8 * B
    for k, ptr in extra:
        run.p[k] = ptr
    run.v[6] = int(nsweeps)
    dp = get_devprof()
    if dp.enabled:
        with dp.launch(name, dev):
            run()
    else:
        run()
    dist, pred, wenter = out.unbind(0)
    return dist, pred.view(torch.int32), wenter, stats


def planes_relax_full_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int, mode=None,
                           plane_dtype: str = "f32"):
    """planes_relax on the card: one launch of planes_relax_full_kernel,
    which also writes the max over nets of the sweep counts.  Same
    contract as planes.planes_relax_plain, ``plane_dtype`` included.
    ``mode`` forces a shared-memory mode (None: the most that fits).  The
    last call's stats [B + 1, 2] stay in
    ``planes_relax_full_cuda.last_stats``: each net's [executed, useful]
    sweeps, then their max over nets."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    plan = _plan(FULL, pg, B, d0_flat.device, mode,
                 plane_dtype=plane_dtype)
    dist, pred, wenter, stats = _launch_flats(
        plan, d0_flat, cc_flat, crit, wenter0, nsweeps,
        name="planes_relax_full_cuda")
    _count(planes_relax_full_cuda, plane_dtype, plan.mode)
    planes_relax_full_cuda.last_mode = plan.mode
    planes_relax_full_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_full_cuda.launches = 0
planes_relax_full_cuda.launches_bf16 = 0
planes_relax_full_cuda.last_stats = None
planes_relax_full_cuda.last_mode = None


def planes_relax_cropped_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps: int, ox, oy, cnx: int, cny: int,
                              mode=None, plane_dtype: str = "f32"):
    """planes_relax_cropped on the card: one launch of
    planes_relax_cropped_kernel, which reads the full flats and the
    shared geometry at each net's origin (``ox``/``oy`` int32 [B] on the
    card, placed in the kernel as planes._crop_index places them: a
    negative origin wraps by each array's extent, then clamps into
    [0, crop_origin_hi]) and writes the full output flats: the relaxed
    tile, and d0 / own id / wenter0 everywhere else.  Same contract as
    planes.planes_relax_cropped_plain; ``mode``, ``plane_dtype`` and
    ``last_stats`` as for planes_relax_full_cuda.  Raises ValueError for
    a tile wider or taller than the grid."""
    _, NX, NYp1 = pg.shape_x
    if not (1 <= cnx <= NX and 1 <= cny <= NYp1 - 1):
        # a tile past the grid would clamp its origins below 0
        raise ValueError(f"crop tile ({cnx}, {cny}) must lie inside the "
                         f"({NX}, {NYp1 - 1}) grid")
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    _check(ox, torch.int32, (B,), "ox")
    _check(oy, torch.int32, (B,), "oy")
    plan = _plan(TILE, pg, B, d0_flat.device, mode, (int(cnx), int(cny)),
                 plane_dtype=plane_dtype)
    dist, pred, wenter, stats = _launch_flats(
        plan, d0_flat, cc_flat, crit, wenter0, nsweeps,
        ((28, ox.data_ptr()), (29, oy.data_ptr())),
        name="planes_relax_cropped_cuda")
    _count(planes_relax_cropped_cuda, plane_dtype, plan.mode)
    planes_relax_cropped_cuda.last_mode = plan.mode
    planes_relax_cropped_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_cropped_cuda.launches = 0
planes_relax_cropped_cuda.launches_bf16 = 0
planes_relax_cropped_cuda.last_stats = None
planes_relax_cropped_cuda.last_mode = None


def planes_relax_cluster_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps: int, shards: int, mode=None,
                              plane_dtype: str = "f32"):
    """The lag-1 row-sharded relaxation (planes_shard.planes_relax_sharded)
    with every shard on d0_flat's card: one launch of
    planes_relax_cluster_kernel, net b a cluster of ``shards`` CTAs, each
    relaxing its shard's column block read straight from the flats, the
    dist halos exchanged through distributed shared memory every sweep,
    each net stopping at its first sweep with no owned change or at
    ``nsweeps`` (the sharded sweep cap).  Writes the full output flats;
    returns (dist, pred, wenter, stats [2]), bit-identical to the
    plain loop.  ``mode``, ``plane_dtype`` (the halos carry the
    rounded dist, and the flag compares the rounded owned cells) and
    ``last_stats`` as for planes_relax_full_cuda.  Raises if the card
    cannot schedule such a cluster."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    dev = d0_flat.device
    plan = _plan(CLUSTER, pg, B, dev, mode, shards=int(shards),
                 plane_dtype=plane_dtype)
    extra = ()
    if plan.ws_numel:
        ws = torch.empty(plan.ws_numel, dtype=torch.float32, device=dev)
        extra = ((30, ws.data_ptr()),)
    dist, pred, wenter, stats = _launch_flats(
        plan, d0_flat, cc_flat, crit, wenter0, nsweeps, extra,
        name="planes_relax_cluster_cuda")
    _count(planes_relax_cluster_cuda, plane_dtype, plan.mode)
    planes_relax_cluster_cuda.last_mode = plan.mode
    planes_relax_cluster_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_cluster_cuda.launches = 0
planes_relax_cluster_cuda.launches_bf16 = 0
planes_relax_cluster_cuda.last_stats = None
planes_relax_cluster_cuda.last_mode = None


@dataclass(frozen=True)
class PeerPlan:
    """Where the peer relaxation's blocks go (peer_launch_plan): ``G``
    blocks per shard (net slots), and per card of the mesh, in the order
    the shards first name it, the ranks of the shards it holds.  Block k
    of a card holds shard ``ranks[k // G]`` and walks the nets k % G,
    k % G + G, ... in order, so a net's partner blocks (one per shard,
    on every card the same slot) always run at the same time."""
    G: int
    cards: Tuple[Tuple[torch.device, Tuple[int, ...]], ...]

    def grid(self, card) -> int:
        """Blocks of ``card``'s launch."""
        return self.G * len(dict(self.cards)[torch.device(card)])

    def block(self, card, k: int):
        """(shard rank, net slot j) of block ``k`` of ``card``'s launch."""
        ranks = dict(self.cards)[torch.device(card)]
        return ranks[k // self.G], k % self.G

    def nets(self, j: int, B: int):
        """The nets net slot ``j`` walks, in order."""
        return range(j, B, self.G)


def peer_launch_plan(devices, B: int, fit) -> PeerPlan:
    """The peer kernel's launch plan for the shards' ``devices`` (one per
    shard, repeats allowed) and ``B`` nets: each card's grid is split
    evenly over the shards it holds, G = min(B, fit[card] // its shards)
    over the cards, ``fit[card]`` being the blocks the card holds at
    once (its occupancy at the launch's shared-memory mode).  Raises
    RuntimeError when some card cannot hold one block per shard it
    holds: one net's shards would not fit at once."""
    cards: dict = {}
    for r, d in enumerate(devices):
        cards.setdefault(torch.device(d), []).append(r)
    G = int(B)
    for d, ranks in cards.items():
        G = min(G, int(fit[d]) // len(ranks))
    if G < 1:
        raise RuntimeError(
            "peer relaxation: one net's shards do not fit at once (blocks "
            f"each card holds {dict((str(d), int(fit[d])) for d in cards)}, "
            f"shards per card {dict((str(d), len(r)) for d, r in cards.items())})")
    return PeerPlan(G, tuple((d, tuple(r)) for d, r in cards.items()))


def _coop_plan(kind: int, fit_fn, ints, devices, B: int, mode, what: str):
    """The shared-memory mode and the launch plan (peer_launch_plan) of a
    cooperative relaxation of ``kind`` over ``devices``: one mode for
    every card, the first card's auto mode under kernel_mode_cap (or
    ``mode``), and each card's occupancy at it (``fit_fn``, the kind's
    fit query).  ``ints(card, mode)`` gives a card's launch integers."""
    lib = LIB.get()
    cards = list(dict.fromkeys(torch.device(d) for d in devices))
    if mode is None:
        v = (ctypes.c_longlong * NINT)(*ints(cards[0], None))
        mode = lib.planes_relax_mode(kind, v)
        cap = _MODE_CAP[0]
        if cap is not None:
            mode = min(mode, int(cap))
    fit = {}
    for card in cards:
        n = fit_fn((ctypes.c_longlong * NINT)(*ints(card, int(mode))))
        if n < 0:
            raise RuntimeError(f"{what}: the occupancy query on {card} "
                               f"failed (cudaError {-n})")
        fit[card] = n
    return int(mode), peer_launch_plan(devices, B, fit)


class _PeerPlan:
    """The peer relaxation of one (planes graph, batch, shard devices,
    mode, plane dtype), built once: per card its copy of the stacked block
    geometry, its launch tables, its shards' halo mailboxes (a ring of
    three generations per net), its copy of the flag words and, in
    mode 0, its blocks' workspace; and the launch plan.  ``epoch`` tags
    each call's flag words."""

    def __init__(self, pg, B: int, devices, mode, plane_dtype: str):
        lib = LIB.get()
        s = len(devices)
        if not 2 <= s <= MAX_SHARDS:
            raise ValueError(f"peer relaxation: needs 2..{MAX_SHARDS} "
                             f"shards, got {s}")
        W, NX, NYp1 = pg.shape_x
        nc, ncx = pg.ncells, W * NX * NYp1
        geom, kx = cluster_geometry(pg, s)
        X, Y = kx + 2, NYp1 - 1
        check_kernel_shape(PEER, W, X, Y, nc,
                           f"grid {NX}x{Y} at {s} shards")
        gstr = (W * X * NYp1, W * (X + 1) * Y)
        cells = W * X * (Y + 1) + W * (X + 1) * Y
        self.pg, self.B, self.nc = pg, B, nc
        self.ncx_bytes, self.plane_bytes = 4 * ncx, 4 * B * nc

        def ints(card, m):
            return _ints(PEER, B, W, X, Y, NYp1, pg.directional, gstr, m,
                         card, NX, ncx, nc, (0, 0), s, kx, plane_dtype)
        self.mode, plan = _coop_plan(PEER, lib.planes_relax_peer_fit, ints,
                                     devices, B, mode, "peer relaxation")
        self.plan = plan
        self.sys = len(plan.cards) > 1
        halo = 2 * W * (Y + 1) + 3 * W * Y
        mbox, flags, keep = {}, {}, [pg, geom]
        for card, ranks in plan.cards:
            mbox[card] = torch.empty((len(ranks), B, 3, halo),
                                     dtype=torch.float32, device=card)
            flags[card] = torch.zeros((B, s, 2), dtype=torch.int64,
                                      device=card)
        rank_box = {}
        for card, ranks in plan.cards:
            for i, r in enumerate(ranks):
                rank_box[r] = mbox[card][i].data_ptr()
        self.cards = []
        for card, ranks in plan.cards:
            g = geom if card == pg.device else SimpleNamespace(**{
                k: getattr(geom, k).to(card) for k in _GEOM_PTR_NAMES})
            inc = (pg.inc_track.to(card) if pg.directional else None)
            ws = (torch.empty(plan.grid(card) * cells, dtype=torch.float32,
                              device=card) if self.mode == 0 else None)
            ptrs = ([0] * 14 + _geom_ptrs(g, pg.directional, inc)
                    + [0] * 3 + [0 if ws is None else ws.data_ptr()])
            q = ([rank_box[r] for r in range(s)] + [0] * (MAX_SHARDS - s)
                 + [flags[c].data_ptr() for c, _ in plan.cards]
                 + [0] * (MAX_SHARDS - len(plan.cards))
                 + [flags[card].data_ptr()])
            w = ([plan.G, len(ranks)] + list(ranks)
                 + [0] * (MAX_SHARDS - len(ranks))
                 + [len(plan.cards), 0, 0, int(self.sys), 0])
            self.cards.append((
                card, (ctypes.c_void_p * NPTR)(*ptrs),
                (ctypes.c_longlong * NINT)(*ints(card, self.mode)),
                (ctypes.c_void_p * NPEER_PTR)(*q),
                (ctypes.c_longlong * NPEER_INT)(*w)))
            keep += [g, inc, ws]
        self.keep = (keep, mbox, flags)
        self.epoch = 0
        self._launch, self.what = (lib.planes_relax_peer_launch,
                                   "peer relaxation")

    def __call__(self, d0_flat, cc_flat, crit, wenter0, nsweeps: int,
                 lag2: bool, name: str):
        """One relaxation: outputs on d0_flat's card (home); returns
        (dist, pred, wenter, stats [B + 1, 2])."""
        lib = LIB.get()
        home = d0_flat.device
        B = self.B
        out = torch.empty((3, B, self.nc), dtype=torch.float32, device=home)
        stats = torch.empty((B + 1, 2), dtype=torch.int32, device=home)
        o, st = out.data_ptr(), stats.data_ptr()
        e, f = self.ncx_bytes, self.plane_bytes
        cross = any(card != home for card, *_ in self.cards)
        if cross:
            _enable_peers([card for card, *_ in self.cards] + [home])
        self.epoch = self.epoch % 0x7fffffff + 1
        # another card reads its own copy of the inputs, allocated on
        # its current stream; ``held`` keeps every copy alive until all
        # the launches are enqueued, after which the stream orders any
        # reuse of its memory behind the launch
        held = []
        for card, p, v, q, w in self.cards:
            ins = (d0_flat, cc_flat, wenter0, crit)
            if card != home:
                ins = tuple(t.to(card) for t in ins)
            held.append(ins)
            d, c, wn = (t.data_ptr() for t in ins[:3])
            p[0:14] = (d, d + e, c, c + e, wn, wn + e, ins[3].data_ptr(),
                       o, o + e, o + f, o + f + e, o + 2 * f, o + 2 * f + e,
                       st)
            p[27] = st + 8 * B
            v[6] = int(nsweeps)
            w[19], w[20], w[22] = self.epoch, int(lag2), int(not cross)
        streams = {card: torch.cuda.current_stream(card)
                   for card, *_ in self.cards}
        home_stream = torch.cuda.current_stream(home)
        dp = get_devprof()
        with (dp.launch(name, home) if dp.enabled
              else contextlib.nullcontext()):
            if cross:
                # before any launch: the total zeroed, every card after
                # home's outputs and after the previous call's launches
                rc = lib.planes_relax_zero_total(st + 8 * B, home.index,
                                                 home_stream.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{self.what}: zeroing the total "
                                       f"failed (cudaError {rc})")
                ready = torch.cuda.Event()
                ready.record(home_stream)
                for card, s_ in streams.items():
                    if card != home:
                        s_.wait_event(ready)
            # every card launches before anything waits on any of them:
            # the grids spin on each other's flags
            for card, p, v, q, w in self.cards:
                rc = self._launch(p, v, q, w, streams[card].cuda_stream)
                if rc != 0:
                    raise RuntimeError(
                        f"{self.what} launch on {card} failed "
                        f"(cudaError {rc}): refused cooperative launch or "
                        "bad table")
            if cross:
                for card, s_ in streams.items():
                    if card != home:
                        done = torch.cuda.Event()
                        done.record(s_)
                        home_stream.wait_event(done)
        del held
        dist, pred, wenter = out.unbind(0)
        return dist, pred.view(torch.int32), wenter, stats


def _peer_plan(pg, B: int, devices, mode, plane_dtype: str) -> _PeerPlan:
    plane_torch_dtype(plane_dtype)
    key = ("peer", id(pg), B, devices, mode, _MODE_CAP[0], plane_dtype)
    plan = _PLANS.get(key)
    if plan is None or plan.pg is not pg:
        if len(_PLANS) > 64:
            _PLANS.clear()
        plan = _PLANS[key] = _PeerPlan(pg, B, devices, mode, plane_dtype)
    return plan


def planes_relax_peer_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int, devices, lag2: bool = False,
                           mode=None, plane_dtype: str = "f32"):
    """The row-sharded relaxation (planes_shard.planes_relax_sharded) on
    any mesh of cards ``devices`` (one per shard, repeats allowed; the
    tensors on a card of their own or of the mesh): one cooperative
    launch of planes_relax_peer_kernel per card of the mesh.  Each block
    relaxes one shard's column block of one net at a time, read straight
    from the flats; after every sweep it stores its owned boundary
    columns into the neighbours' halo mailboxes (through peer pointers
    on another card) and publishes its owned-changed flag; the OR of a
    net's flags decides on the card whether the net goes on: lag 1
    (``lag2`` False, the "ppermute" schedule) stops at the first sweep
    with no owned change, lag 2 ("pallas_halo": halos extracted before
    the sweep before) after two consecutive stable sweeps; ``nsweeps``
    is the sharded sweep cap.  No host read per sweep or per relaxation.
    Writes the full output flats on d0_flat's card; returns (dist, pred,
    wenter, stats [2]), bit-identical to the plain loop
    (planes_shard.planes_relax_sharded_plain).  ``mode``, ``plane_dtype``
    and ``last_stats`` as for planes_relax_full_cuda.  Raises
    RuntimeError when peer access cannot be enabled between two cards of
    the mesh, when a card refuses the cooperative launch, or when one
    net's shards do not fit on the cards at once; never runs another
    form."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    devices = tuple(torch.device(d) for d in devices)
    for d in devices:
        if d.type != "cuda" or d.index is None:
            raise ValueError(f"peer relaxation: shard devices must be cards "
                             f"with an index, got {d}")
    B = d0_flat.shape[0]
    plan = _peer_plan(pg, B, devices, mode, plane_dtype)
    dist, pred, wenter, stats = plan(d0_flat, cc_flat, crit, wenter0,
                                     nsweeps, lag2, "planes_relax_peer_cuda")
    for _ in plan.cards:
        _count(planes_relax_peer_cuda, plane_dtype, plan.mode)
    planes_relax_peer_cuda.last_mode = plan.mode
    planes_relax_peer_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_peer_cuda.launches = 0
planes_relax_peer_cuda.launches_bf16 = 0
planes_relax_peer_cuda.last_stats = None
planes_relax_peer_cuda.last_mode = None

def node_tables(NX: int, m: int):
    """The node kernel's schedule tables (csrc/planes_relax.cu Node.sched)
    for an NX-column grid on an m-member node row: int32 [2 * active
    members] offsets, then per (member, direction) its MemberScan of
    nodesplit.scan_schedule flattened (nslots, len, ops1, ops2, npub,
    ninj, in_slot, out_slot, ops1 triples, ops2 triples, publish
    triples, inject pairs).  Returns (tables, the most slots of a line,
    (forward, backward) published values a line)."""
    from .nodesplit import scan_schedule, x_segments

    segs = x_segments(NX, m)
    scans = (scan_schedule(NX, segs, False), scan_schedule(NX, segs, True))
    head, body = [0] * (2 * len(segs)), []
    for r in range(len(segs)):
        for d, sch in enumerate(scans):
            ms = sch.members[r]
            ops1 = [x for lv in ms.levels1 for op in lv for x in op]
            ops2 = [x for lv in ms.levels2 for op in lv for x in op]
            head[2 * r + d] = len(head) + len(body)
            body += [ms.nslots, len(ms.in_slot), len(ops1) // 3,
                     len(ops2) // 3, len(ms.publish), len(ms.inject)]
            body += (list(ms.in_slot) + list(ms.out_slot) + ops1 + ops2
                     + [x for t in ms.publish for x in t]
                     + [x for t in ms.inject for x in t])
    nslots = max(1, max(ms.nslots for sch in scans for ms in sch.members))
    return (torch.tensor(head + body, dtype=torch.int32), nslots,
            (scans[0].natoms, scans[1].natoms))


class _NodePlan(_PeerPlan):
    """The node-axis relaxation of one (planes graph, batch, node row,
    mode, plane dtype), built once: the active members (nodesplit.
    active_members) placed by peer_launch_plan; per card its copy of the
    members' block geometry, of the schedule tables and its launch
    tables, its members' inboxes ([B, 2, payload] each), its copy of the
    flag words, its blocks' scan workspace and, in mode 0, their dist
    workspace.  Called as the peer relaxation's plan (one schedule, lag
    1's tables)."""

    def __init__(self, pg, B: int, devices, mode, plane_dtype: str):
        from .nodesplit import active_members, node_cols
        from .planes_shard import _geom_blocks

        lib = LIB.get()
        W, NX, NYp1 = pg.shape_x
        m = len(devices)
        if not 2 <= m <= MAX_SHARDS:
            raise ValueError(f"node relaxation: needs 2..{MAX_SHARDS} "
                             f"members, got {m}")
        kx = node_cols(NX, m)
        devices = devices[:active_members(NX, m)]
        s = len(devices)
        nc, ncx = pg.ncells, W * NX * NYp1
        geom = _geom_blocks(pg, s, kx)
        geom = SimpleNamespace(**{k: getattr(geom, k).contiguous()
                                  for k in _GEOM_PTR_NAMES})
        X, Y = kx + 2, NYp1 - 1
        check_kernel_shape(NODE, W, X, Y, nc,
                           f"grid {NX}x{Y} at node axis {m}")
        gstr = (W * X * NYp1, W * (X + 1) * Y)
        cells = W * X * (Y + 1) + W * (X + 1) * Y
        tables, nslots, natoms = node_tables(NX, m)
        nl = W * (Y + 1)
        payload = max(2 * nl * max(natoms), W * (Y + 1), W * Y, 1)
        self.pg, self.B, self.nc = pg, B, nc
        self.ncx_bytes, self.plane_bytes = 4 * ncx, 4 * B * nc
        self.members, self.kx, self.nslots = s, kx, nslots

        def ints(card, md):
            return _ints(NODE, B, W, X, Y, NYp1, pg.directional, gstr, md,
                         card, NX, ncx, nc, (0, 0), s, kx, plane_dtype)
        self.mode, plan = _coop_plan(NODE, lib.planes_relax_node_fit, ints,
                                     devices, B, mode, "node relaxation")
        self.plan = plan
        self.sys = len(plan.cards) > 1
        inbox, flags, keep = {}, {}, [pg, geom]
        for card, ranks in plan.cards:
            inbox[card] = torch.empty((len(ranks), B, 2, payload),
                                      dtype=torch.float32, device=card)
            flags[card] = torch.zeros((B, s, 2), dtype=torch.int64,
                                      device=card)
        rank_box = {}
        for card, ranks in plan.cards:
            for i, r in enumerate(ranks):
                rank_box[r] = inbox[card][i].data_ptr()
        self.cards = []
        for card, ranks in plan.cards:
            g = geom if card == pg.device else SimpleNamespace(**{
                k: getattr(geom, k).to(card) for k in _GEOM_PTR_NAMES})
            inc = (pg.inc_track.to(card) if pg.directional else None)
            tab = tables.to(card)
            xs = torch.empty(plan.grid(card) * 2 * nslots * nl,
                             dtype=torch.float32, device=card)
            ws = (torch.empty(plan.grid(card) * cells, dtype=torch.float32,
                              device=card) if self.mode == 0 else None)
            ptrs = ([0] * 14 + _geom_ptrs(g, pg.directional, inc)
                    + [0] * 3 + [0 if ws is None else ws.data_ptr()])
            q = ([rank_box[r] for r in range(s)] + [0] * (MAX_SHARDS - s)
                 + [flags[c].data_ptr() for c, _ in plan.cards]
                 + [0] * (MAX_SHARDS - len(plan.cards))
                 + [flags[card].data_ptr(), tab.data_ptr(), xs.data_ptr()])
            w = ([plan.G, len(ranks)] + list(ranks)
                 + [0] * (MAX_SHARDS - len(ranks))
                 + [len(plan.cards), 0, 0, int(self.sys), 0, payload,
                    nslots])
            self.cards.append((
                card, (ctypes.c_void_p * NPTR)(*ptrs),
                (ctypes.c_longlong * NINT)(*ints(card, self.mode)),
                (ctypes.c_void_p * NNODE_PTR)(*q),
                (ctypes.c_longlong * NNODE_INT)(*w)))
            keep += [g, inc, ws, tab, xs]
        self.keep = (keep, inbox, flags)
        self.epoch = 0
        self._launch, self.what = (lib.planes_relax_node_launch,
                                   "node relaxation")


def node_plan(pg, B: int, devices, mode=None,
              plane_dtype: str = "f32") -> _NodePlan:
    """The node relaxation's plan (built once per key, as _peer_plan)."""
    plane_torch_dtype(plane_dtype)
    devices = tuple(torch.device(d) for d in devices)
    key = ("node", id(pg), B, devices, mode, _MODE_CAP[0], plane_dtype)
    plan = _PLANS.get(key)
    if plan is None or plan.pg is not pg:
        if len(_PLANS) > 64:
            _PLANS.clear()
        plan = _PLANS[key] = _NodePlan(pg, B, devices, mode, plane_dtype)
    return plan


def planes_relax_node_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int, devices, mode=None,
                           plane_dtype: str = "f32"):
    """planes_relax with every net's canvases split by columns over the
    node row ``devices`` (cards, repeats allowed; d0_flat and ``pg`` on
    the first): one cooperative launch of planes_relax_node_kernel per
    card of the row.  A block relaxes one member's column block of one
    net at a time (nodesplit.py's segments, planes_shard's block
    layout); per sweep the members meet four times through the inboxes
    and flag words (the forward and the backward x-scans' published
    values, the dx and the dy halo column), and the OR of the members'
    owned-change flags decides on the card whether the net goes on.
    Bit-identical to planes_relax_full_cuda (K1) and to the plain
    version (planes.planes_relax_node_plain): every scan combine has
    K1's operands in K1's order.  Writes the full output flats on
    d0_flat's card; returns (dist, pred, wenter, stats [2]); ``mode``,
    ``plane_dtype`` and ``last_stats`` as for planes_relax_full_cuda.
    Raises RuntimeError when peer access cannot be enabled between two
    cards of the row, when a card refuses the cooperative launch, or
    when one net's members do not fit on the cards at once; never runs
    another form."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    devices = tuple(torch.device(d) for d in devices)
    for d in devices:
        if d.type != "cuda" or d.index is None:
            raise ValueError(f"node relaxation: members must be cards "
                             f"with an index, got {d}")
    if devices[0] != d0_flat.device:
        raise ValueError(f"node relaxation: the flats are on "
                         f"{d0_flat.device}, the row's first member is "
                         f"{devices[0]}")
    B = d0_flat.shape[0]
    plan = node_plan(pg, B, devices, mode, plane_dtype)
    dist, pred, wenter, stats = plan(d0_flat, cc_flat, crit, wenter0,
                                     nsweeps, False,
                                     "planes_relax_node_cuda")
    for _ in plan.cards:
        _count(planes_relax_node_cuda, plane_dtype, plan.mode)
    planes_relax_node_cuda.last_mode = plan.mode
    planes_relax_node_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_node_cuda.launches = 0
planes_relax_node_cuda.launches_bf16 = 0
planes_relax_node_cuda.last_stats = None
planes_relax_node_cuda.last_mode = None

WRAPPERS = (planes_relax_full_cuda, planes_relax_cropped_cuda,
            planes_relax_cluster_cuda, planes_relax_peer_cuda,
            planes_relax_node_cuda)
for _w in WRAPPERS:
    _w.mode_launches = {0: 0, 1: 0, 2: 0}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = w.launches_bf16 = 0
        w.mode_launches = {0: 0, 1: 0, 2: 0}


def mode_launch_counts() -> dict:
    """Launches per wrapper and shared-memory mode (both plane modes):
    ``name`` -> {mode: launches}."""
    return {w.__name__: dict(w.mode_launches) for w in WRAPPERS}


def launch_counts() -> dict:
    """Launches per wrapper and plane mode: ``name`` (f32) and
    ``name[bf16]``."""
    out = {}
    for w in WRAPPERS:
        out[w.__name__] = w.launches
        out[w.__name__ + "[bf16]"] = w.launches_bf16
    return out
