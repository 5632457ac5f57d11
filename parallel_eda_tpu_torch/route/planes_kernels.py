"""The planes relaxation's hand-written CUDA kernels: the counterpart of
parallel_eda_tpu/route/planes_pallas.py.

    planes_relax_full_cuda    -> planes_relax_full_kernel
        replaces planes_relax_pallas / _sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:308 / :218)
    planes_relax_cropped_cuda -> planes_relax_cropped_kernel
        replaces planes_relax_cropped_pallas / _crop_sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:477 / :417)
    planes_sweep_block_cuda   -> planes_relax_block_kernel, one sweep
        the per-shard step of the row-sharded relaxation across cards and
        under the lag-2 schedule (route/planes_shard.py; JAX
        planes_shard.py:369); sweep_block_launcher is its form with the
        tables built once
    planes_relax_cluster_cuda -> planes_relax_cluster_kernel
        the whole lag-1 row-sharded relaxation with every shard on one
        card: one thread-block cluster per net, one CTA per shard

All are compiled from csrc/planes_relax.cu with nvcc for sm_90a into
``parallel_eda_tpu_torch/build/`` at first use and loaded through a
plain C interface with ctypes.  One thread block (one cluster) relaxes
one net for the whole bounded sweep loop, so a relaxation is one
launch; the net's dist planes (and, where they fit beside them, its scan
costs) live in shared memory, and its line scans run level-parallel on
lane groups of a warp (design, exactness argument and what bounds it:
the note at the top of the .cu file).  K1, K2 and the cluster
relaxation read and write the [B, ncells] flats themselves and keep a
plan per (planes graph, batch, tile or shards, card, mode): a call
allocates its outputs, sets their pointers and makes one launch.  The
wrappers take CUDA tensors only and raise on anything else; the CPU path
is the plain version in planes.py / planes_shard.py.  Each wrapper
counts its launches in ``<wrapper>.launches`` and keeps the
shared-memory mode of its last launch in ``<wrapper>.last_mode`` (0
global state, 1 dist in shared memory, 2 dist and scan costs).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, Launch, check_tensor as _check
from .planes import crop_origin_hi

OWN_ALL = (0, 2 ** 31 - 1)
# how a launch addresses its nets (csrc/planes_relax.cu Kind)
FULL, BLOCK, TILE, CLUSTER = 0, 1, 2, 3
# launch table sizes (csrc/planes_relax.cu unpack)
NPTR = 36


def threads_for(ncells: int) -> int:
    """Threads per block: 1024 for a large canvas, 512 for a small one
    (fewer warps at each barrier)."""
    return 1024 if ncells > 4096 else 512


def _setup(lib) -> None:
    for fn in (lib.planes_relax_full_launch, lib.planes_relax_cropped_launch,
               lib.planes_sweep_block_launch,
               lib.planes_relax_cluster_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.planes_relax_max_line.restype = ctypes.c_int
    lib.planes_relax_mode.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.planes_relax_mode.restype = ctypes.c_int
    lib.planes_relax_cluster_fit.argtypes = [ctypes.c_void_p]
    lib.planes_relax_cluster_fit.restype = ctypes.c_int


LIB = CudaLib("planes_relax", _setup)


def _geom_ptrs(g, directional: bool, inc_track, ids: bool):
    """Geometry pointers 14..29 of the launch table (``ids``: the id and
    parity arrays of a block geometry)."""
    names = ("brk_before_x", "brk_after_x", "first_x", "last_x",
             "brk_before_y", "brk_after_y", "first_y", "last_y",
             "delay_x", "delay_y", "delay_y_rot0", "delay_y_rot1")
    ptrs = []
    for k in names:
        t = getattr(g, k)
        if not t.is_contiguous():
            raise ValueError(f"geometry {k} must be contiguous")
        ptrs.append(t.data_ptr())
    ptrs.append(inc_track.data_ptr() if directional else 0)
    if ids:
        ptrs += [g.idxx.data_ptr(), g.idxy.data_ptr(), g.base_par.data_ptr()]
    else:
        ptrs += [0, 0, 0]
    return ptrs


def _ints(B, W, X, Y, stride_x, directional, nsweeps, strides, own, mode,
          device, NX=0, ncx=0, nc=0, origin_hi=(0, 0), shards=0, kx=0):
    """The launch table's integers (csrc/planes_relax.cu unpack)."""
    ncells = W * X * (Y + 1) + W * (X + 1) * Y
    return ([B, W, X, Y, stride_x, int(directional), int(nsweeps)]
            + list(strides) + [threads_for(ncells), int(own[0]), int(own[1]),
                               -1 if mode is None else int(mode),
                               device.index, NX, ncx, nc, int(origin_hi[0]),
                               int(origin_hi[1]), shards, kx])


def _check_line(lib, X: int, Yp1: int, what: str) -> None:
    if max(X, Yp1) > lib.planes_relax_max_line():
        raise ValueError(f"{what} exceeds the kernel's scan line limit")


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
    batch, tile or shards, card, mode), built once: the geometry, the
    shapes and the shared-memory mode are fixed; a call sets its
    tensors' pointers and nsweeps in the Launch's tables."""

    def __init__(self, kind: int, pg, B: int, device: torch.device, mode,
                 tile=None, shards: int = 0):
        W, NX, NYp1 = pg.shape_x
        lib = LIB.get()
        nc = pg.ncells
        ncx = W * NX * NYp1
        self.pg, self.nc, self.kind = pg, nc, kind
        # per-net x-plane and per-output plane byte offsets; output shapes
        self.ncx_bytes, self.plane_bytes = 4 * ncx, 4 * B * nc
        self.shapes = ((3, B, nc), (B + 1, 2))
        self.ws_numel = 0
        geom, gstr, own, hi, kx = pg, (0, 0, 0), OWN_ALL, (0, 0), 0
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
            gstr = (W * X * NYp1, W * (X + 1) * Y, (X + 1) * NYp1)
            own = (1, kx + 1)
            fn, what = lib.planes_relax_cluster_launch, "cluster relaxation"
        _check_line(lib, X, Y + 1, "crop tile" if kind == TILE else "grid")
        ptrs = ([0] * 14 + _geom_ptrs(geom, pg.directional, pg.inc_track,
                                      False) + [0] * (NPTR - 30))
        self.run = Launch(fn, ptrs, _ints(
            B, W, X, Y, NYp1, pg.directional, 0, (nc, nc, nc, nc) + gstr,
            own, mode, device, NX, ncx, nc, hi, shards, kx),
            device, what, keep=(pg, geom))
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
                    f"cluster of {shards} blocks of {self.run.v[14]} "
                    f"threads in shared-memory mode {self.mode}")


_PLANS: dict = {}


def _plan(kind: int, pg, B: int, device: torch.device, mode, tile=None,
          shards: int = 0) -> _FlatsPlan:
    key = (kind, id(pg), B, tile, shards, device.index, mode)
    plan = _PLANS.get(key)
    if plan is None or plan.pg is not pg:
        if len(_PLANS) > 64:
            _PLANS.clear()
        plan = _PLANS[key] = _FlatsPlan(kind, pg, B, device, mode, tile,
                                        shards)
    return plan


def _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0):
    """The flats' checks; returns crit as a contiguous [B] tensor."""
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
                  nsweeps: int, extra=()):
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
    run.p[32] = st + 8 * B
    for k, ptr in extra:
        run.p[k] = ptr
    run.v[6] = int(nsweeps)
    run()
    dist, pred, wenter = out.unbind(0)
    return dist, pred.view(torch.int32), wenter, stats


def planes_relax_full_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int, mode=None):
    """planes_relax on the card: one launch of planes_relax_full_kernel,
    which also writes the max over nets of the sweep counts.  Same
    contract as planes.planes_relax_plain.  ``mode`` forces a
    shared-memory mode (None: the most that fits).  The last call's
    stats [B + 1, 2] stay in ``planes_relax_full_cuda.last_stats``: each
    net's [executed, useful] sweeps, then their max over nets."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    plan = _plan(FULL, pg, B, d0_flat.device, mode)
    dist, pred, wenter, stats = _launch_flats(plan, d0_flat, cc_flat, crit,
                                              wenter0, nsweeps)
    planes_relax_full_cuda.launches += 1
    planes_relax_full_cuda.last_mode = plan.mode
    planes_relax_full_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_full_cuda.launches = 0
planes_relax_full_cuda.last_stats = None
planes_relax_full_cuda.last_mode = None


def planes_relax_cropped_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps: int, ox, oy, cnx: int, cny: int,
                              mode=None):
    """planes_relax_cropped on the card: one launch of
    planes_relax_cropped_kernel, which reads the full flats and the
    shared geometry at each net's origin (``ox``/``oy`` int32 [B] on the
    card, clamped in the kernel into [0, crop_origin_hi]) and writes the
    full output flats: the relaxed tile, and d0 / own id / wenter0
    everywhere else.  Same contract as planes.planes_relax_cropped_plain;
    ``mode`` and ``last_stats`` as for planes_relax_full_cuda.  Raises
    ValueError for a tile wider or taller than the grid."""
    _, NX, NYp1 = pg.shape_x
    if not (1 <= cnx <= NX and 1 <= cny <= NYp1 - 1):
        # a tile past the grid would clamp its origins below 0
        raise ValueError(f"crop tile ({cnx}, {cny}) must lie inside the "
                         f"({NX}, {NYp1 - 1}) grid")
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    _check(ox, torch.int32, (B,), "ox")
    _check(oy, torch.int32, (B,), "oy")
    plan = _plan(TILE, pg, B, d0_flat.device, mode, (int(cnx), int(cny)))
    dist, pred, wenter, stats = _launch_flats(
        plan, d0_flat, cc_flat, crit, wenter0, nsweeps,
        ((33, ox.data_ptr()), (34, oy.data_ptr())))
    planes_relax_cropped_cuda.launches += 1
    planes_relax_cropped_cuda.last_mode = plan.mode
    planes_relax_cropped_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_cropped_cuda.launches = 0
planes_relax_cropped_cuda.last_stats = None
planes_relax_cropped_cuda.last_mode = None


def planes_relax_cluster_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps: int, shards: int, mode=None):
    """The lag-1 row-sharded relaxation (planes_shard.planes_relax_sharded)
    with every shard on d0_flat's card: one launch of
    planes_relax_cluster_kernel, net b a cluster of ``shards`` CTAs, each
    relaxing its shard's column block read straight from the flats, the
    dist halos exchanged through distributed shared memory every sweep,
    each net stopping at its first sweep with no owned change or at
    ``nsweeps`` (the sharded sweep cap).  Writes the full output flats;
    returns (dist, pred, wenter, stats [2]), bit-identical to the
    per-sweep loop.  ``mode`` and ``last_stats`` as for
    planes_relax_full_cuda.  Raises if the card cannot schedule such a
    cluster."""
    crit = _check_flats(pg, d0_flat, cc_flat, crit_c, wenter0)
    B = d0_flat.shape[0]
    dev = d0_flat.device
    plan = _plan(CLUSTER, pg, B, dev, mode, shards=int(shards))
    extra = ()
    if plan.ws_numel:
        ws = torch.empty(plan.ws_numel, dtype=torch.float32, device=dev)
        extra = ((35, ws.data_ptr()),)
    dist, pred, wenter, stats = _launch_flats(plan, d0_flat, cc_flat, crit,
                                              wenter0, nsweeps, extra)
    planes_relax_cluster_cuda.launches += 1
    planes_relax_cluster_cuda.last_mode = plan.mode
    planes_relax_cluster_cuda.last_stats = stats
    return dist, pred, wenter, stats[B]


planes_relax_cluster_cuda.launches = 0
planes_relax_cluster_cuda.last_stats = None
planes_relax_cluster_cuda.last_mode = None


def sweep_block_launcher(gm, state, crit_c, cc_x, cc_y, own, out, stats,
                         mode=None):
    """planes_sweep_block_cuda with its checks done and its launch table
    built once: returns a callable that runs one sweep of ``state`` into
    ``out`` and ``stats`` (contract of planes_sweep_block_cuda) and
    counts into ``planes_sweep_block_cuda.launches``.  Its ``mode`` is
    the shared-memory mode the launch takes."""
    dx = state[0]
    B, W, X, Yp1 = dx.shape
    Y = Yp1 - 1
    shx, shy = (B, W, X, Yp1), (B, W, X + 1, Y)
    f32, i32 = torch.float32, torch.int32
    for t, dt, sh, n in zip(state + out + (cc_x, cc_y),
                            (f32, f32, i32, i32, f32, f32) * 2 + (f32, f32),
                            (shx, shy) * 7,
                            ("dx", "dy", "px", "py", "wx", "wy",
                             "out dx", "out dy", "out px", "out py",
                             "out wx", "out wy", "cc_x", "cc_y")):
        _check(t, dt, sh, n)
    _check(stats, i32, (B, 2), "stats")
    crit = crit_c.reshape(B).contiguous()
    _check(crit, f32, (B,), "crit_c")
    for t, sh, n in ((gm.idxx, (1, W, X, Yp1), "idxx"),
                     (gm.idxy, (1, W, X + 1, Y), "idxy"),
                     (gm.base_par, (1, X + 1, Yp1), "base_par"),
                     (gm.delay_x, (1, W, X, Yp1), "delay_x")):
        if tuple(t.shape) != sh or t.device != dx.device:
            raise ValueError(f"block geometry {n} must be {sh} on "
                             f"{dx.device}")
    lib = LIB.get()
    _check_line(lib, X, Yp1, "block")
    sx, sy = W * X * Yp1, W * (X + 1) * Y
    ptrs = ([state[0].data_ptr(), state[1].data_ptr(), cc_x.data_ptr(),
             cc_y.data_ptr(), state[4].data_ptr(), state[5].data_ptr(),
             crit.data_ptr()] + [t.data_ptr() for t in out]
            + [stats.data_ptr()]
            + _geom_ptrs(gm, gm.directional, gm.inc_track, True)
            + [state[2].data_ptr(), state[3].data_ptr()]
            + [0] * (NPTR - 32))
    ints = _ints(B, W, X, Y, gm.stride_x, gm.directional, 1,
                 (sx, sy, sx, sy, 0, 0, 0), own, mode, dx.device)
    launch = Launch(lib.planes_sweep_block_launch, ptrs, ints, dx.device,
                    "planes sweep step",
                    keep=(gm, state, out, stats, crit, cc_x, cc_y))

    def run() -> None:
        launch()
        planes_sweep_block_cuda.launches += 1

    run.mode = lib.planes_relax_mode(BLOCK, launch.v)
    return run


def planes_sweep_block_cuda(gm, state, crit_c, cc_x, cc_y, own,
                            mode=None):
    """One relaxation sweep of one shard's column block on the card: one
    launch of planes_relax_block_kernel with nsweeps = 1, pred carried
    in from ``state``, and the block geometry ``gm`` (G = 1, shared by
    every net) read with stride 0.  ``state`` = (dx, dy, px, py, wx, wy)
    [B, W, X, Y+1] / [B, W, X+1, Y]; ``own`` = (lo, hi), the local x
    columns whose improvement counts as a change.  Returns the new state
    and stats [B, 2] int32 (stats[:, 1] each net's owned-changed flag).
    Same arithmetic as one planes._sweep_once."""
    out = tuple(torch.empty_like(t) for t in state)
    stats = torch.empty((state[0].shape[0], 2), dtype=torch.int32,
                        device=state[0].device)
    sweep_block_launcher(gm, state, crit_c, cc_x, cc_y, own, out, stats,
                         mode)()
    return out, stats


planes_sweep_block_cuda.launches = 0

WRAPPERS = (planes_relax_full_cuda, planes_relax_cropped_cuda,
            planes_sweep_block_cuda, planes_relax_cluster_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
