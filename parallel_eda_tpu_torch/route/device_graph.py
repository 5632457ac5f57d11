"""Device-resident rr-graph node arrays: the counterpart of
parallel_eda_tpu/route/device_graph.py.

Every route reads the congestion base costs (pre-multiplied by the
delay-normalisation factor, rr_graph_indexed_data.c semantics),
capacities, node spans (the per-net bounding-box mask) and the wire
mask (wirelength).  The ELL program (route/search.py) also reads the
ELL in-edge tables — every node's in-edges padded to the max in-degree
D, so the pull relaxation is a dense [N, D] gather + min-reduction —
and the per-node lookahead fields of its windowed A* gate.  Those are
built only for the ELL program (``to_device(..., ell=True)``): the
planes program never reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..rr.graph import CHANX, CHANY, RRGraph


@dataclass
class DeviceRRGraph:
    """Per-node tensors on one device."""
    cong_base: torch.Tensor   # f32 [N] base_cost * delay_norm
    capacity: torch.Tensor    # int32 [N]
    xlow: torch.Tensor        # int32 [N]
    xhigh: torch.Tensor
    ylow: torch.Tensor
    yhigh: torch.Tensor
    is_wire: torch.Tensor     # bool [N] CHANX/CHANY
    # ELL in-edges (ELL program only): for node v, slot d: edge
    # (ell_src[v, d] -> v)
    ell_src: Optional[torch.Tensor] = None     # int32 [N, D] (pad: 0)
    ell_delay: Optional[torch.Tensor] = None   # f32 [N, D] (pad: +inf)
    ell_valid: Optional[torch.Tensor] = None   # bool [N, D]
    # per-node A* lookahead expansions (route/lookahead.py) for the
    # windowed search's delay bound (ELL program only)
    la_axis: Optional[torch.Tensor] = None       # int8 [N] 0/1/2
    la_len_same: Optional[torch.Tensor] = None   # int32 [N] >= 1
    la_len_ortho: Optional[torch.Tensor] = None  # int32 [N]
    la_tlin_same: Optional[torch.Tensor] = None  # f32 [N]
    la_tlin_ortho: Optional[torch.Tensor] = None  # f32 [N]

    @property
    def num_nodes(self) -> int:
        return int(self.capacity.shape[0])

    @property
    def max_in_degree(self) -> int:
        return int(self.ell_src.shape[1])

    @property
    def device(self) -> torch.device:
        return self.capacity.device


def ell_from_csr(row_ptr: np.ndarray, col: np.ndarray,
                 val: np.ndarray) -> tuple:
    """CSR -> (ell_col [N,D], ell_val [N,D], valid [N,D])."""
    N = len(row_ptr) - 1
    deg = np.diff(row_ptr)
    D = max(1, int(deg.max()) if N else 1)
    ell_col = np.zeros((N, D), dtype=np.int32)
    ell_val = np.full((N, D), np.inf, dtype=np.float32)
    valid = np.zeros((N, D), dtype=bool)
    # slot index of each edge within its row
    rows = np.repeat(np.arange(N), deg)
    slot = np.arange(len(col)) - row_ptr[rows]
    ell_col[rows, slot] = col
    ell_val[rows, slot] = val
    valid[rows, slot] = True
    return ell_col, ell_val, valid


def delay_normalization(rr: RRGraph) -> float:
    """Mean in-edge delay of wire nodes: scales unitless congestion base
    costs into the delay domain (rr_graph_indexed_data.c semantics)."""
    dst = np.repeat(np.arange(rr.num_nodes), np.diff(rr.in_row_ptr))
    wire = (rr.node_type[dst] == CHANX) | (rr.node_type[dst] == CHANY)
    if not wire.any():
        return 1.0
    d = float(rr.in_delay[wire].mean())
    return d if d > 0 else 1.0


def wire_cost_floor(rr: RRGraph) -> tuple:
    """Admissible per-manhattan-tile cost floors for A* lower bounds
    (get_timing_driven_expected_cost semantics, route_timing.c:693): the
    cheapest wire's delay-normalised congestion cost and cheapest wire
    in-edge delay, spread over the longest segment length.

    Returns (min_cong_per_tile, min_delay_per_tile, lmax)."""
    wire = (rr.node_type == CHANX) | (rr.node_type == CHANY)
    if not wire.any():
        return 0.0, 0.0, 1
    lmax = max(1, int((rr.xhigh - rr.xlow + rr.yhigh
                       - rr.ylow)[wire].max()) + 1)
    norm = delay_normalization(rr)
    min_cong = float((rr.base_cost[wire] * norm).min()) / lmax
    dst = np.repeat(np.arange(rr.num_nodes), np.diff(rr.in_row_ptr))
    wd = rr.in_delay[wire[dst]]
    min_delay = float(wd.min()) / lmax if len(wd) else 0.0
    return min_cong, min_delay, lmax


_FIELDS = {"cong_base": torch.float32, "capacity": torch.int32,
           "xlow": torch.int32, "xhigh": torch.int32,
           "ylow": torch.int32, "yhigh": torch.int32,
           "is_wire": torch.bool}
_ELL_FIELDS = {"ell_src": torch.int32, "ell_delay": torch.float32,
               "ell_valid": torch.bool, "la_axis": torch.int8,
               "la_len_same": torch.int32, "la_len_ortho": torch.int32,
               "la_tlin_same": torch.float32,
               "la_tlin_ortho": torch.float32}


def device_graph_from_numpy(fields: dict, device) -> DeviceRRGraph:
    """Build from numpy arrays keyed by field name — the fields of a
    ``DeviceRRGraph`` of either package (extra keys are ignored; the ELL
    and lookahead fields are taken when present and not None), so a test
    can hand the JAX package's graph state to the port."""
    def t(k, dt):
        return torch.from_numpy(np.array(fields[k])).to(device=device,
                                                        dtype=dt)
    return DeviceRRGraph(
        **{k: t(k, dt) for k, dt in _FIELDS.items()},
        **{k: t(k, dt) for k, dt in _ELL_FIELDS.items()
           if fields.get(k) is not None})


def to_device(rr: RRGraph, device, la=None,
              ell: bool = False) -> DeviceRRGraph:
    """Host RRGraph -> per-node tensors on ``device``; with ``ell`` also
    the ELL in-edge tables and the lookahead fields (``la``: pre-built
    lookahead.Lookahead tables, built here when absent)."""
    norm = delay_normalization(rr)
    is_wire = (rr.node_type == CHANX) | (rr.node_type == CHANY)
    fields = dict(
        cong_base=(rr.base_cost * norm).astype(np.float32),
        capacity=rr.capacity, xlow=rr.xlow, xhigh=rr.xhigh,
        ylow=rr.ylow, yhigh=rr.yhigh, is_wire=is_wire)
    if ell:
        from .lookahead import build_lookahead

        if la is None:
            la = build_lookahead(rr)
        ell_src, ell_delay, valid = ell_from_csr(
            rr.in_row_ptr, rr.in_src, rr.in_delay)
        fields.update(
            ell_src=ell_src, ell_delay=ell_delay, ell_valid=valid,
            la_axis=la.axis, la_len_same=la.len_same,
            la_len_ortho=la.len_ortho,
            la_tlin_same=np.asarray(la.tlin_same, dtype=np.float32),
            la_tlin_ortho=np.asarray(la.tlin_ortho, dtype=np.float32))
    return device_graph_from_numpy(fields, device)
