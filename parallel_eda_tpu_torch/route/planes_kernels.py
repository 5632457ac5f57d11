"""The planes relaxation's hand-written CUDA kernels: the counterpart of
parallel_eda_tpu/route/planes_pallas.py.

    planes_relax_full_cuda    -> planes_relax_full_kernel
        replaces planes_relax_pallas / _sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:308 / :218)
    planes_relax_cropped_cuda -> planes_relax_cropped_kernel
        replaces planes_relax_cropped_pallas / _crop_sweep_kernel
        (parallel_eda_tpu/route/planes_pallas.py:477 / :417)

Both are compiled from csrc/planes_relax.cu with nvcc for sm_90a into
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
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "planes_relax.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD_DIR, "libplanes_relax.so")
THREADS = 256

# filled by build(): seconds, and nvcc's -Xptxas -v register / shared
# memory / spill report
BUILD_INFO: dict = {}
_lib = None


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return p


def nvcc_command() -> list:
    """The build command: sm_90a, no FMA contraction (the kernels must
    round as the plain version does), register/spill report on."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", LIB, SRC]


def start_build() -> subprocess.Popen:
    """Start nvcc in the background (chip_smoke.py builds every source
    at once); finish with finish_build()."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    BUILD_INFO["t0"] = time.time()
    return subprocess.Popen(nvcc_command(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen) -> dict:
    out, _ = proc.communicate()
    BUILD_INFO["seconds"] = time.time() - BUILD_INFO.pop("t0")
    BUILD_INFO["ptxas"] = [ln.strip() for ln in out.splitlines()
                           if "ptxas" in ln or "spill" in ln
                           or "Used" in ln]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
    return BUILD_INFO


def build() -> dict:
    """Compile csrc/planes_relax.cu into build/ (always from source)."""
    return finish_build(start_build())


def _get_lib():
    global _lib
    if _lib is None:
        if (not os.path.exists(LIB)
                or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
            build()
        lib = ctypes.CDLL(LIB)
        for fn in (lib.planes_relax_full_launch,
                   lib.planes_relax_cropped_launch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.planes_relax_max_line.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t, dtype, shape, name):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _launch(fn, ptrs, ints):
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    v = (ctypes.c_longlong * len(ints))(*ints)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(p, v, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"planes relaxation kernel launch failed "
                           f"(cudaError {rc})")


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
    lib = _get_lib()
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
    _launch(lib.planes_relax_full_launch, ptrs, ints)
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
    lib = _get_lib()
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
    _launch(lib.planes_relax_cropped_launch, ptrs, ints)
    planes_relax_cropped_cuda.launches += 1
    planes_relax_cropped_cuda.last_net_stats = stats
    return scatter_state(gm_full, fulls, (dx, dy, px, py, wx, wy),
                         ox, oy) + (stats.amax(dim=0),)


planes_relax_cropped_cuda.launches = 0
planes_relax_cropped_cuda.last_net_stats = None

WRAPPERS = (planes_relax_full_cuda, planes_relax_cropped_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
