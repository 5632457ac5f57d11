"""Flow front end: the host-side stages of the JAX package's flow.py
(``prepare``, ``synth_flow`` and ``run_place_native``) — arch ->
netlist -> pack -> grid -> rr graph -> initial placement -> net
terminals, all numpy, plus the native C++ annealer for placed configs.
Routing is ``route.router.Router(flow.rr, opts, device=...)``."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .arch.builtin import k6_n10_arch, minimal_arch
from .arch.model import Arch
from .netlist.generate import generate_circuit
from .netlist.netlist import LogicalNetlist
from .netlist.packed import PackedNetlist
from .pack.packer import pack_netlist
from .place.initial import initial_placement
from .rr.graph import RRGraph, build_rr_graph
from .rr.grid import DeviceGrid, size_grid
from .rr.terminals import NetTerminals, net_terminals


@dataclass
class FlowResult:
    """Everything the front end produced."""
    arch: Arch
    nl: LogicalNetlist
    pnl: PackedNetlist
    grid: DeviceGrid
    pos: np.ndarray
    rr: RRGraph
    term: NetTerminals
    bb_factor: int = 3
    times: dict = field(default_factory=dict)   # stage -> seconds


def prepare(nl: LogicalNetlist, arch: Arch, chan_width: int,
            seed: int = 0, nx: int = 0, ny: int = 0,
            bb_factor: int = 3,
            pnl: Optional[PackedNetlist] = None) -> FlowResult:
    """Front end through initial placement + rr-graph (no SA, no route).
    Pass ``pnl`` to start from a packed netlist instead of packing."""
    times: dict = {}
    t0 = time.perf_counter()
    if pnl is None:
        pnl = pack_netlist(nl, arch)
    times["pack"] = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    rr = build_rr_graph(arch, grid, chan_width=chan_width)
    times["rr_graph"] = time.perf_counter() - t0
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

    t0 = time.perf_counter()
    res = serial_sa_place(flow.pnl, flow.grid, flow.pos, seed=seed,
                          inner_num=inner_num)
    flow.pos = res.pos
    flow.times["place"] = time.perf_counter() - t0
    flow.term = net_terminals(flow.pnl, flow.rr, flow.pos,
                              bb_factor=flow.bb_factor)
    return flow
