"""ctypes binding for the native serial PathFinder (native/serial_route.cc),
the counterpart of the JAX package's route/serial_native.py.

The C++ router is the honest SPEED-CLASS serial baseline (stock VPR is
C++; the pure-Python serial_ref understates the wall-clock bar by the
interpreter factor).  It implements the EXACT algorithm of
route/serial_ref.py — same cost model, same double arithmetic, same heap
tie-breaks — so the cross-oracle test asserts identical route trees.
Built on first use with g++ -O3 into the port's git-ignored build
directory (``parallel_eda_tpu_torch/build/``), through a per-process
temporary file and ``os.replace``, so that several processes may build
it at once and none loads a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from typing import Optional

import numpy as np

from ..rr.graph import CHANX, CHANY, RRGraph
from ..rr.terminals import NetTerminals
from .serial_ref import (SerialRouteResult, SerialRouter,
                         tree_order)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "serial_route.cc")
_SO = os.path.join(_PKG, "build", "libserial_route.so")


def _build_lib() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        tmp = f"{_SO}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return _SO


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(_build_lib())
        _lib.serial_route.restype = ctypes.c_int64
    return _lib


class NativeSerialRouter:
    """Drop-in for serial_ref.SerialRouter backed by the C++ core."""

    def __init__(self, rr: RRGraph, **kw):
        # reuse the Python router's precomputation (edge delays, cost
        # normalisation, A* floor) so both share one derivation
        self._py = SerialRouter(rr, **kw)
        self.rr = rr

    def route(self, term: NetTerminals,
              crit: Optional[np.ndarray] = None,
              deadline_s: Optional[float] = None) -> SerialRouteResult:
        rr, py = self.rr, self._py
        lib = _get_lib()
        N = rr.num_nodes
        R, Smax = term.sinks.shape

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        row_ptr = np.ascontiguousarray(rr.out_row_ptr, np.int32)
        dst = np.ascontiguousarray(rr.out_dst, np.int32)
        edelay = np.ascontiguousarray(py.edge_delay, np.float64)
        base = np.ascontiguousarray(py.base, np.float64)
        cap = np.ascontiguousarray(rr.capacity, np.int32)
        xlow = np.ascontiguousarray(rr.xlow, np.int32)
        xhigh = np.ascontiguousarray(rr.xhigh, np.int32)
        ylow = np.ascontiguousarray(rr.ylow, np.int32)
        yhigh = np.ascontiguousarray(rr.yhigh, np.int32)
        is_wire = np.ascontiguousarray(
            ((rr.node_type == CHANX) | (rr.node_type == CHANY))
            .astype(np.uint8))
        source = np.ascontiguousarray(term.source, np.int32)
        nsinks = np.ascontiguousarray(term.num_sinks, np.int32)
        sinks = np.ascontiguousarray(term.sinks, np.int32)
        bbs0 = np.ascontiguousarray(np.stack(
            [term.bb_xmin, term.bb_xmax, term.bb_ymin, term.bb_ymax],
            axis=1), np.int32)
        crit_a = (np.ascontiguousarray(crit, np.float32)
                  if crit is not None else None)
        # per-node A* lookahead expansions (route/lookahead.py; shared
        # derivation with the Python oracle)
        la_axis = np.ascontiguousarray(py.la.axis, np.uint8)
        la_len_same = np.ascontiguousarray(py.la.len_same, np.int32)
        la_len_ortho = np.ascontiguousarray(py.la.len_ortho, np.int32)
        la_tlin_same = np.ascontiguousarray(py.la.tlin_same, np.float64)
        la_tlin_ortho = np.ascontiguousarray(py.la.tlin_ortho, np.float64)
        occ = np.zeros(N, np.int32)
        iters = ctypes.c_int64()
        pops = ctypes.c_int64()
        wl = ctypes.c_int64()
        rrt = ctypes.c_int64()
        tree_cap = max(1 << 16, 8 * int(nsinks.sum()) * 64)
        t0 = time.time()
        timed_out = ctypes.c_int64()
        while True:
            # fresh bbs every attempt: the C core mutates them (bb
            # widening), and a buffer-grow retry must not inherit that
            bbs = bbs0.copy()
            tree_flat = np.zeros(2 * tree_cap, np.int32)
            tree_off = np.zeros(R + 1, np.int64)
            rc = lib.serial_route(
                ctypes.c_int64(N), p(row_ptr, ctypes.c_int32),
                p(dst, ctypes.c_int32), p(edelay, ctypes.c_double),
                p(base, ctypes.c_double), p(cap, ctypes.c_int32),
                p(xlow, ctypes.c_int32), p(xhigh, ctypes.c_int32),
                p(ylow, ctypes.c_int32), p(yhigh, ctypes.c_int32),
                p(is_wire, ctypes.c_uint8),
                ctypes.c_int64(rr.grid.nx), ctypes.c_int64(rr.grid.ny),
                ctypes.c_int64(R), ctypes.c_int64(Smax),
                p(source, ctypes.c_int32), p(nsinks, ctypes.c_int32),
                p(sinks, ctypes.c_int32), p(bbs, ctypes.c_int32),
                p(crit_a, ctypes.c_float) if crit_a is not None else None,
                ctypes.c_int64(py.max_iterations),
                ctypes.c_double(py.initial_pres_fac),
                ctypes.c_double(py.pres_fac_mult),
                ctypes.c_double(py.acc_fac),
                ctypes.c_double(py.max_pres_fac),
                ctypes.c_double(py.astar_fac),
                ctypes.c_double(py.min_wire_cost),
                ctypes.c_double(deadline_s or 0.0),
                p(la_axis, ctypes.c_uint8),
                p(la_len_same, ctypes.c_int32),
                p(la_len_ortho, ctypes.c_int32),
                p(la_tlin_same, ctypes.c_double),
                p(la_tlin_ortho, ctypes.c_double),
                ctypes.c_double(py.la.term_delay),
                ctypes.c_double(py.min_wire_delay),
                p(occ, ctypes.c_int32),
                ctypes.byref(iters), ctypes.byref(pops), ctypes.byref(wl),
                ctypes.byref(rrt), ctypes.byref(timed_out),
                p(tree_flat, ctypes.c_int32),
                ctypes.c_int64(2 * tree_cap), p(tree_off, ctypes.c_int64))
            if rc == -1:
                tree_cap *= 4
                continue
            break
        wall = time.time() - t0
        if rc == -2:
            raise RuntimeError("native serial route: unreachable sink")
        res = SerialRouteResult(
            success=(rc == 1), iterations=int(iters.value), trees=[],
            occ=occ.astype(np.int64), wirelength=int(wl.value),
            route_time_s=wall, heap_pops=int(pops.value),
            timed_out=bool(timed_out.value),
            stats=[{"iteration": int(iters.value),
                    "rerouted": int(rrt.value), "overused": 0,
                    "heap_pops": int(pops.value)}])
        for r in range(R):
            lo, hi = int(tree_off[r]), int(tree_off[r + 1])
            rows = [(int(tree_flat[2 * k]), int(tree_flat[2 * k + 1]))
                    for k in range(lo, hi)]
            # the C core appends each sink's backtrack target-first
            # (children before parents); re-establish the
            # SerialRouteResult TREE-order contract with the shared
            # helper
            res.trees.append(tree_order(rows))
        return res


def native_available() -> bool:
    try:
        _get_lib()
        return True
    except Exception:
        return False
