"""ctypes binding for the native serial SA placer (native/serial_sa.cc).

The C++ annealer is the CPU measurement baseline for BASELINE.md's "SA
moves/sec/chip" metric (semantics of vpr/SRC/place/place.c try_place):
an honest serial-CPU speed class to hold the batched TPU placer against
— a pure-Python loop would overstate the device win by an order of
magnitude.  Built on first use with g++ -O3 (toolchain is in the image);
the .so goes into the port's git-ignored build directory
(``parallel_eda_tpu_torch/build/``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from dataclasses import dataclass

import numpy as np

from ..netlist.packed import PackedNetlist
from ..rr.grid import DeviceGrid

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "serial_sa.cc")
_SO = os.path.join(_PKG, "build", "libserial_sa.so")

# place.c get_crossing_count table (a copy: the port keeps its own)
_CROSS_COUNT = [
    1.0, 1.0, 1.0, 1.0828, 1.1536, 1.2206, 1.2823, 1.3385, 1.3991, 1.4493,
    1.4974, 1.5455, 1.5937, 1.6418, 1.6899, 1.7304, 1.7709, 1.8114, 1.8519,
    1.8924, 1.9288, 1.9652, 2.0015, 2.0379, 2.0743, 2.1061, 2.1379, 2.1698,
    2.2016, 2.2334, 2.2646, 2.2958, 2.3271, 2.3583, 2.3895, 2.4187, 2.4479,
    2.4772, 2.5064, 2.5356, 2.5610, 2.5864, 2.6117, 2.6371, 2.6625, 2.6887,
    2.7148, 2.7410, 2.7671, 2.7933,
]


def crossing_factor(num_pins: np.ndarray) -> np.ndarray:
    """q per net of num_pins terminals: table entry num_pins-1 for 1..50
    pins, linear extrapolation beyond (place.c get_crossing_count
    semantics)."""
    n = np.asarray(num_pins)
    idx = np.clip(n - 1, 0, 49)
    q = np.where(n <= 50, np.array(_CROSS_COUNT)[idx],
                 2.7933 + 0.02616 * (n - 50))
    return q.astype(np.float32)


def _build_lib() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             _SRC, "-o", _SO],
            check=True, capture_output=True)
    return _SO


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(_build_lib())
        _lib.serial_sa_place.restype = ctypes.c_int64
    return _lib


@dataclass
class SerialPlaceResult:
    pos: np.ndarray
    proposed: int
    accepted: int
    final_cost: float
    temps: int
    wall_s: float

    @property
    def moves_per_sec(self) -> float:
        return self.proposed / max(self.wall_s, 1e-12)


def _tables(pnl: PackedNetlist, grid: DeviceGrid):
    """Flat net/block tables — independently derived from the packed
    netlist (not shared with place.sa's tables: baseline independence)."""
    NB = pnl.num_blocks
    costed = [i for i, n in enumerate(pnl.nets)
              if not n.is_global and n.sinks]
    rows = []
    for ni in costed:
        n = pnl.nets[ni]
        blks = [n.driver.block] + [p.block for p in n.sinks]
        uniq = list(dict.fromkeys(blks))
        rows.append(uniq)
    NN = max(1, len(rows))
    P = max(1, max((len(r) for r in rows), default=1))
    net_blk = np.full((NN, P), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        net_blk[i, :len(r)] = r
    npins = np.array([len(r) for r in rows] + [1] * (NN - len(rows)),
                     dtype=np.int32)[:NN]
    net_q = np.asarray(crossing_factor(npins), dtype=np.float32)

    blk_rows = [[] for _ in range(NB)]
    for i, r in enumerate(rows):
        for b in r:
            blk_rows[b].append(i)
    F = max(1, max((len(x) for x in blk_rows), default=1))
    blk_net = np.full((NB, F), -1, dtype=np.int32)
    for b, nets in enumerate(blk_rows):
        blk_net[b, :len(nets)] = nets

    is_io = np.array([pnl.block_type(i).is_io for i in range(NB)],
                     dtype=np.uint8)
    ring = np.array(grid.io_sites(), dtype=np.int32)
    return net_blk, net_q, blk_net, is_io, ring


def serial_sa_place(pnl: PackedNetlist, grid: DeviceGrid,
                    pos0: np.ndarray, inner_num: float = 1.0,
                    exit_t_frac: float = 0.005, max_temps: int = 500,
                    seed: int = 0) -> SerialPlaceResult:
    lib = _get_lib()
    net_blk, net_q, blk_net, is_io, ring_xy = _tables(pnl, grid)
    NB = pnl.num_blocks
    NN, P = net_blk.shape
    F = blk_net.shape[1]
    NRING = ring_xy.shape[0]

    ring_of = {tuple(xy): i for i, xy in enumerate(grid.io_sites())}
    pos = np.ascontiguousarray(pos0.astype(np.int32)).copy()
    ring = np.full(NB, -1, dtype=np.int32)
    NS = grid.nx * grid.ny + NRING * grid.io_capacity
    occ = np.full(NS, -1, dtype=np.int32)
    for i in range(NB):
        if is_io[i]:
            ring[i] = ring_of[(int(pos[i, 0]), int(pos[i, 1]))]
            s = grid.nx * grid.ny + ring[i] * grid.io_capacity \
                + int(pos[i, 2])
        else:
            s = (int(pos[i, 1]) - 1) * grid.nx + (int(pos[i, 0]) - 1)
        if occ[s] != -1:
            raise ValueError("initial placement has site collisions")
        occ[s] = i

    stats = np.zeros(3, dtype=np.float64)
    c = ctypes
    t0 = time.time()
    proposed = lib.serial_sa_place(
        net_blk.ctypes.data_as(c.c_void_p),
        net_q.ctypes.data_as(c.c_void_p),
        blk_net.ctypes.data_as(c.c_void_p),
        is_io.ctypes.data_as(c.c_void_p),
        ring_xy.ctypes.data_as(c.c_void_p),
        c.c_int32(NN), c.c_int32(P), c.c_int32(NB), c.c_int32(F),
        c.c_int32(NRING), c.c_int32(grid.nx), c.c_int32(grid.ny),
        c.c_int32(grid.io_capacity),
        pos.ctypes.data_as(c.c_void_p),
        ring.ctypes.data_as(c.c_void_p),
        occ.ctypes.data_as(c.c_void_p),
        c.c_double(inner_num), c.c_double(exit_t_frac),
        c.c_int32(max_temps), c.c_uint64(seed),
        stats.ctypes.data_as(c.c_void_p))
    wall = time.time() - t0
    return SerialPlaceResult(
        pos=pos, proposed=int(proposed), accepted=int(stats[0]),
        final_cost=float(stats[1]), temps=int(stats[2]), wall_s=wall)
