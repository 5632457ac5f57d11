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
        (route/planes_shard.py; JAX planes_shard.py:369)

All are compiled from csrc/planes_relax.cu with nvcc for sm_90a into
``parallel_eda_tpu_torch/build/`` at first use and loaded through a
plain C interface with ctypes.  One thread block relaxes one net for
the whole bounded sweep loop, so a relaxation is one launch (design,
exactness argument and what bounds it: the note at the top of the .cu
file).  The wrappers take CUDA tensors only and raise on anything else;
the CPU path is the plain version in planes.py.  Each wrapper counts
its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, check_tensor as _check, launch

THREADS = 256


def _setup(lib) -> None:
    for fn in (lib.planes_relax_full_launch, lib.planes_relax_cropped_launch,
               lib.planes_sweep_block_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.planes_relax_max_line.restype = ctypes.c_int


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


def planes_relax_full_cuda(pg, d0_flat, cc_flat, crit_c, wenter0,
                           nsweeps: int):
    """planes_relax on the card: one launch of planes_relax_full_kernel.
    Same contract as planes.planes_relax_plain.  The per-net
    [executed, useful] counts of the last call stay in
    ``planes_relax_full_cuda.last_net_stats``."""
    B, nc = d0_flat.shape
    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    ncx = W * NX * NYp1
    if nc != pg.ncells:
        raise ValueError("d0_flat width must be pg.ncells")
    for t, n in ((d0_flat, "d0_flat"), (cc_flat, "cc_flat"),
                 (wenter0, "wenter0")):
        _check(t, torch.float32, (B, nc), n)
    crit = crit_c.reshape(B).contiguous()
    _check(crit, torch.float32, (B,), "crit_c")
    lib = LIB.get()
    if max(NX, NYp1) > lib.planes_relax_max_line():
        raise ValueError("grid side exceeds the kernel's scan line limit")
    dist = torch.empty_like(d0_flat)
    wenter = torch.empty_like(d0_flat)
    pred = torch.empty((B, nc), dtype=torch.int32, device=d0_flat.device)
    stats = torch.empty((B, 2), dtype=torch.int32, device=d0_flat.device)
    e = 4   # bytes per element of every flat here
    ptrs = [d0_flat.data_ptr(), d0_flat.data_ptr() + ncx * e,
            cc_flat.data_ptr(), cc_flat.data_ptr() + ncx * e,
            wenter0.data_ptr(), wenter0.data_ptr() + ncx * e,
            crit.data_ptr(),
            dist.data_ptr(), dist.data_ptr() + ncx * e,
            pred.data_ptr(), pred.data_ptr() + ncx * e,
            wenter.data_ptr(), wenter.data_ptr() + ncx * e,
            stats.data_ptr()] + _geom_ptrs(pg, pg.directional,
                                           pg.inc_track, False)
    ints = [B, W, NX, NY, NYp1, int(pg.directional), int(nsweeps),
            nc, nc, nc, nc, 0, 0, 0, THREADS]
    launch(lib.planes_relax_full_launch, ptrs, ints, d0_flat.device,
           "planes relaxation")
    planes_relax_full_cuda.launches += 1
    planes_relax_full_cuda.last_net_stats = stats
    return dist, pred, wenter, stats.amax(dim=0)


planes_relax_full_cuda.launches = 0
planes_relax_full_cuda.last_net_stats = None


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
    if max(cnx, cny + 1) > lib.planes_relax_max_line():
        raise ValueError("crop tile exceeds the kernel's scan line limit")
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
    stats = torch.empty((B, 2), dtype=torch.int32, device=tdx.device)
    ptrs = [tdx.data_ptr(), tdy.data_ptr(), ccx.data_ptr(), ccy.data_ptr(),
            twx.data_ptr(), twy.data_ptr(), crit.data_ptr(),
            dx.data_ptr(), dy.data_ptr(), px.data_ptr(), py.data_ptr(),
            wx.data_ptr(), wy.data_ptr(), stats.data_ptr()] + _geom_ptrs(
        gm, pg.directional, pg.inc_track, True)
    ints = [B, W, cnx, cny, pg.shape_x[2], int(pg.directional),
            int(nsweeps), sx, sy, sx, sy, sx, sy, (cnx + 1) * (cny + 1),
            THREADS]
    launch(lib.planes_relax_cropped_launch, ptrs, ints, d0_flat.device,
           "planes relaxation")
    planes_relax_cropped_cuda.launches += 1
    planes_relax_cropped_cuda.last_net_stats = stats
    return scatter_state(gm_full, fulls, (dx, dy, px, py, wx, wy),
                         ox, oy) + (stats.amax(dim=0),)


planes_relax_cropped_cuda.launches = 0
planes_relax_cropped_cuda.last_net_stats = None

def planes_sweep_block_cuda(gm, state, crit_c, cc_x, cc_y, own):
    """One relaxation sweep of one shard's column block on the card: one
    launch of planes_relax_cropped_kernel with nsweeps = 1, pred carried
    in from ``state``, and the block geometry ``gm`` (G = 1, shared by
    every net) read with stride 0.  ``state`` = (dx, dy, px, py, wx, wy)
    [B, W, X, Y+1] / [B, W, X+1, Y]; ``own`` = (lo, hi), the local x
    columns whose improvement counts as a change.  Returns (the new
    state, stats [B, 2] int32 with stats[:, 1] each net's owned-changed
    flag).  Same arithmetic as one planes._sweep_once."""
    dx = state[0]
    B, W, X, Yp1 = dx.shape
    Y = Yp1 - 1
    shx, shy = (B, W, X, Yp1), (B, W, X + 1, Y)
    f32, i32 = torch.float32, torch.int32
    for t, dt, sh, n in zip(state + (cc_x, cc_y),
                            (f32, f32, i32, i32, f32, f32, f32, f32),
                            (shx, shy, shx, shy, shx, shy, shx, shy),
                            ("dx", "dy", "px", "py", "wx", "wy", "cc_x",
                             "cc_y")):
        _check(t, dt, sh, n)
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
    if max(X, Yp1) > lib.planes_relax_max_line():
        raise ValueError("block exceeds the kernel's scan line limit")
    out = tuple(torch.empty_like(t) for t in state)
    stats = torch.empty((B, 2), dtype=i32, device=dx.device)
    sx, sy = W * X * Yp1, W * (X + 1) * Y
    ptrs = ([state[0].data_ptr(), state[1].data_ptr(), cc_x.data_ptr(),
             cc_y.data_ptr(), state[4].data_ptr(), state[5].data_ptr(),
             crit.data_ptr()] + [t.data_ptr() for t in out]
            + [stats.data_ptr()]
            + _geom_ptrs(gm, gm.directional, gm.inc_track, True)
            + [state[2].data_ptr(), state[3].data_ptr()])
    ints = [B, W, X, Y, gm.stride_x, int(gm.directional), 1,
            sx, sy, sx, sy, 0, 0, 0, THREADS, int(own[0]), int(own[1])]
    launch(lib.planes_sweep_block_launch, ptrs, ints, dx.device,
           "planes sweep step")
    planes_sweep_block_cuda.launches += 1
    return out, stats


planes_sweep_block_cuda.launches = 0

WRAPPERS = (planes_relax_full_cuda, planes_relax_cropped_cuda,
            planes_sweep_block_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
