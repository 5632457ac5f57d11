"""The planes relaxation's hand-written CUDA kernels: the counterpart of
parallel_eda_tpu/route/planes_pallas.py.

    planes_relax_full_cuda    -> planes_relax_full_kernel
        replaces planes_relax_pallas / _sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:308 / :218)
    planes_relax_cropped_cuda -> planes_relax_cropped_kernel
        replaces planes_relax_cropped_pallas / _crop_sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:477 / :417)
    planes_sweep_block_cuda   -> planes_relax_cropped_kernel, one sweep
        the per-shard step of the row-sharded relaxation
        (route/planes_shard.py; JAX planes_shard.py:369);
        sweep_block_launcher is its form with the tables built once

All are compiled from csrc/planes_relax.cu with nvcc for sm_90a into
``parallel_eda_tpu_torch/build/`` at first use and loaded through a
plain C interface with ctypes.  One thread block relaxes one net for
the whole bounded sweep loop, so a relaxation is one launch; the net's
dist planes (and, where they fit beside them, its scan costs) live in
shared memory, and its line scans run level-parallel on lane groups of
a warp (design, exactness argument and what bounds it: the note at the
top of the .cu file).  The wrappers take CUDA tensors only and raise on
anything else; the CPU path is the plain version in planes.py.  Each
wrapper counts its launches in ``<wrapper>.launches`` and keeps the
shared-memory mode of its last launch in ``<wrapper>.last_mode``
(0 global state, 1 dist in shared memory, 2 dist and scan costs).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, Launch, check_tensor as _check

OWN_ALL = (0, 2 ** 31 - 1)


def threads_for(ncells: int) -> int:
    """Threads per block: 1024 for a large canvas, 512 for a small one
    (fewer warps at each barrier)."""
    return 1024 if ncells > 4096 else 512


def _setup(lib) -> None:
    for fn in (lib.planes_relax_full_launch, lib.planes_relax_cropped_launch,
               lib.planes_sweep_block_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.planes_relax_max_line.restype = ctypes.c_int
    lib.planes_relax_mode.argtypes = [ctypes.c_void_p]
    lib.planes_relax_mode.restype = ctypes.c_int


LIB = CudaLib("planes_relax", _setup)


def _geom_ptrs(g, directional: bool, inc_track, cropped: bool):
    """Geometry pointers 14..29 of the launch table."""
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
    if cropped:
        ptrs += [g.idxx.data_ptr(), g.idxy.data_ptr(), g.base_par.data_ptr()]
    else:
        ptrs += [0, 0, 0]
    return ptrs


def _ints(B, W, X, Y, stride_x, directional, nsweeps, strides, own, mode,
          device):
    """The launch table's integers (csrc/planes_relax.cu launch)."""
    ncells = W * X * (Y + 1) + W * (X + 1) * Y
    return ([B, W, X, Y, stride_x, int(directional), int(nsweeps)]
            + list(strides) + [threads_for(ncells), int(own[0]), int(own[1]),
                               -1 if mode is None else int(mode),
                               device.index])


def _check_line(lib, X: int, Yp1: int, what: str) -> None:
    if max(X, Yp1) > lib.planes_relax_max_line():
        raise ValueError(f"{what} exceeds the kernel's scan line limit")


class _FullPlan:
    """planes_relax_full_kernel's Launch for one (planes graph, batch,
    card, mode), built once: the geometry, the shapes and the
    shared-memory mode are fixed; a call sets its tensors' pointers and
    nsweeps in the Launch's tables."""

    def __init__(self, pg, B: int, device: torch.device, mode):
        W, NX, NYp1 = pg.shape_x
        lib = LIB.get()
        _check_line(lib, NX, NYp1, "grid side")
        nc = pg.ncells
        self.pg, self.nc = pg, nc
        # per-net x-plane and per-output plane byte offsets; output shapes
        self.ncx_bytes, self.plane_bytes = 4 * W * NX * NYp1, 4 * B * nc
        self.shapes = ((3, B, nc), (B + 1, 2))
        ptrs = ([0] * 14 + _geom_ptrs(pg, pg.directional, pg.inc_track,
                                      False) + [0, 0, 0])
        self.run = Launch(lib.planes_relax_full_launch, ptrs, _ints(
            B, W, NX, NYp1 - 1, NYp1, pg.directional, 0,
            (nc, nc, nc, nc, 0, 0, 0), OWN_ALL, mode, device),
            device, "planes relaxation", keep=(pg,))
        self.mode = lib.planes_relax_mode(self.run.v)


_FULL_PLANS: dict = {}


def _full_plan(pg, B: int, device: torch.device, mode) -> _FullPlan:
    key = (id(pg), B, device.index, mode)
    plan = _FULL_PLANS.get(key)
    if plan is None or plan.pg is not pg:
        if len(_FULL_PLANS) > 64:
            _FULL_PLANS.clear()
        plan = _FULL_PLANS[key] = _FullPlan(pg, B, device, mode)
    return plan


def planes_relax_full_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int, mode=None):
    """planes_relax on the card: one launch of planes_relax_full_kernel,
    which also writes the max over nets of the sweep counts.  Same
    contract as planes.planes_relax_plain.  ``mode`` forces a
    shared-memory mode (None: the most that fits).  The last call's
    stats [B + 1, 2] stay in ``planes_relax_full_cuda.last_stats``: each
    net's [executed, useful] sweeps, then their max over nets."""
    B, nc = d0_flat.shape
    for t, n in ((d0_flat, "d0_flat"), (cc_flat, "cc_flat"),
                 (wenter0, "wenter0")):
        _check(t, torch.float32, (B, nc), n)
    crit = crit_c.reshape(B)
    if not crit.is_contiguous():
        crit = crit.contiguous()
    _check(crit, torch.float32, (B,), "crit_c")
    dev = d0_flat.device
    plan = _full_plan(pg, B, dev, mode)
    if nc != plan.nc:
        raise ValueError("d0_flat width must be pg.ncells")
    # dist, pred (int32 bits), wenter in one allocation; per-net stats
    # and, in the last row, their max over nets.  The plan holds every
    # size and the pointers are set in one slice: at the bench size this
    # wrapper's host time is as long as the kernel.
    out = torch.empty(plan.shapes[0], dtype=torch.float32, device=dev)
    stats = torch.empty(plan.shapes[1], dtype=torch.int32, device=dev)
    d, c, w = d0_flat.data_ptr(), cc_flat.data_ptr(), wenter0.data_ptr()
    o, st = out.data_ptr(), stats.data_ptr()
    e, f = plan.ncx_bytes, plan.plane_bytes
    run = plan.run
    run.p[0:14] = (d, d + e, c, c + e, w, w + e, crit.data_ptr(), o, o + e,
                   o + f, o + f + e, o + 2 * f, o + 2 * f + e, st)
    run.p[32] = st + 8 * B
    run.v[6] = int(nsweeps)
    run()
    planes_relax_full_cuda.launches += 1
    planes_relax_full_cuda.last_mode = plan.mode
    planes_relax_full_cuda.last_stats = stats
    dist, pred, wenter = out.unbind(0)
    return dist, pred.view(torch.int32), wenter, stats[B]


planes_relax_full_cuda.launches = 0
planes_relax_full_cuda.last_stats = None
planes_relax_full_cuda.last_mode = None


def planes_relax_cropped_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps: int, ox, oy, cnx: int, cny: int):
    """planes_relax_cropped on the card: the per-net tiles and cropped
    geometry are cut in torch (planes.crop_state / geom_cropped), one
    launch of planes_relax_cropped_kernel relaxes them, and the tiles
    are scattered back in torch (planes.scatter_state).  Same contract
    as planes.planes_relax_cropped_plain."""
    from .planes import crop_state, geom_cropped, geom_full, scatter_state

    B, nc = d0_flat.shape
    if nc != pg.ncells:
        raise ValueError("d0_flat width must be pg.ncells")
    for t, n in ((d0_flat, "d0_flat"), (cc_flat, "cc_flat"),
                 (wenter0, "wenter0")):
        _check(t, torch.float32, (B, nc), n)
    crit = crit_c.reshape(B).contiguous()
    _check(crit, torch.float32, (B,), "crit_c")
    lib = LIB.get()
    _check_line(lib, cnx, cny + 1, "crop tile")
    W = pg.shape_x[0]
    gm_full = geom_full(pg)
    gm = geom_cropped(pg, ox, oy, cnx, cny, full=gm_full)
    fulls, (tdx, tdy, ccx, ccy, twx, twy) = crop_state(
        pg, d0_flat, cc_flat, wenter0, ox, oy, cnx, cny)
    sx = W * cnx * (cny + 1)
    sy = W * (cnx + 1) * cny
    dx, dy = torch.empty_like(tdx), torch.empty_like(tdy)
    wx, wy = torch.empty_like(twx), torch.empty_like(twy)
    px = torch.empty(tdx.shape, dtype=torch.int32, device=tdx.device)
    py = torch.empty(tdy.shape, dtype=torch.int32, device=tdy.device)
    # per-net stats and, in the last row, their max over nets
    stats = torch.empty((B + 1, 2), dtype=torch.int32, device=tdx.device)
    ptrs = [tdx.data_ptr(), tdy.data_ptr(), ccx.data_ptr(), ccy.data_ptr(),
            twx.data_ptr(), twy.data_ptr(), crit.data_ptr(),
            dx.data_ptr(), dy.data_ptr(), px.data_ptr(), py.data_ptr(),
            wx.data_ptr(), wy.data_ptr(), stats.data_ptr()] + _geom_ptrs(
        gm, pg.directional, pg.inc_track, True) + [
        0, 0, stats.data_ptr() + 8 * B]
    ints = _ints(B, W, cnx, cny, pg.shape_x[2], pg.directional, nsweeps,
                 (sx, sy, sx, sy, sx, sy, (cnx + 1) * (cny + 1)), OWN_ALL,
                 None, d0_flat.device)
    run = Launch(lib.planes_relax_cropped_launch, ptrs, ints,
                 d0_flat.device, "planes relaxation", keep=(crit,))
    planes_relax_cropped_cuda.last_mode = lib.planes_relax_mode(run.v)
    run()
    planes_relax_cropped_cuda.launches += 1
    planes_relax_cropped_cuda.last_stats = stats
    return scatter_state(gm_full, fulls, (dx, dy, px, py, wx, wy),
                         ox, oy) + (stats[B],)


planes_relax_cropped_cuda.launches = 0
planes_relax_cropped_cuda.last_stats = None
planes_relax_cropped_cuda.last_mode = None


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
            + [state[2].data_ptr(), state[3].data_ptr(), 0])
    ints = _ints(B, W, X, Y, gm.stride_x, gm.directional, 1,
                 (sx, sy, sx, sy, 0, 0, 0), own, mode, dx.device)
    launch = Launch(lib.planes_sweep_block_launch, ptrs, ints, dx.device,
                    "planes sweep step",
                    keep=(gm, state, out, stats, crit, cc_x, cc_y))

    def run() -> None:
        launch()
        planes_sweep_block_cuda.launches += 1

    run.mode = lib.planes_relax_mode(launch.v)
    return run


def planes_sweep_block_cuda(gm, state, crit_c, cc_x, cc_y, own,
                            mode=None):
    """One relaxation sweep of one shard's column block on the card: one
    launch of planes_relax_cropped_kernel with nsweeps = 1, pred carried
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
            planes_sweep_block_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
