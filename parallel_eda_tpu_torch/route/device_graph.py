"""Device-resident rr-graph node arrays for the planes router.

Counterpart of parallel_eda_tpu/route/device_graph.py, cut to what the
planes program reads: congestion base costs (pre-multiplied by the
delay-normalisation factor, rr_graph_indexed_data.c semantics),
capacities, node spans (the per-net bounding-box mask) and the wire
mask (wirelength).  The ELL in-edge tables belong to the ELL program,
which is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from dataclasses import dataclass

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

    @property
    def num_nodes(self) -> int:
        return int(self.capacity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.capacity.device


def delay_normalization(rr: RRGraph) -> float:
    """Mean in-edge delay of wire nodes: scales unitless congestion base
    costs into the delay domain (rr_graph_indexed_data.c semantics)."""
    dst = np.repeat(np.arange(rr.num_nodes), np.diff(rr.in_row_ptr))
    wire = (rr.node_type[dst] == CHANX) | (rr.node_type[dst] == CHANY)
    if not wire.any():
        return 1.0
    d = float(rr.in_delay[wire].mean())
    return d if d > 0 else 1.0


_FIELDS = {"cong_base": torch.float32, "capacity": torch.int32,
           "xlow": torch.int32, "xhigh": torch.int32,
           "ylow": torch.int32, "yhigh": torch.int32,
           "is_wire": torch.bool}


def device_graph_from_numpy(fields: dict, device) -> DeviceRRGraph:
    """Build from numpy arrays keyed by field name — the fields of a
    ``DeviceRRGraph`` of either package (extra keys are ignored), so a
    test can hand the JAX package's graph state to the port."""
    return DeviceRRGraph(**{
        k: torch.from_numpy(np.array(fields[k])).to(device=device,
                                                     dtype=dt)
        for k, dt in _FIELDS.items()})


def to_device(rr: RRGraph, device) -> DeviceRRGraph:
    """Host RRGraph -> per-node tensors on ``device``."""
    norm = delay_normalization(rr)
    is_wire = (rr.node_type == CHANX) | (rr.node_type == CHANY)
    return device_graph_from_numpy(dict(
        cong_base=(rr.base_cost * norm).astype(np.float32),
        capacity=rr.capacity, xlow=rr.xlow, xhigh=rr.xhigh,
        ylow=rr.ylow, yhigh=rr.yhigh, is_wire=is_wire), device)
