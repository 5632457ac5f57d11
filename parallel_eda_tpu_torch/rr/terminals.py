"""Net → rr-node terminal mapping.

Equivalent of the reference's ``net_rr_terminals`` setup
(vpr/SRC/route/route_common.c alloc_and_load_rr_node_route_structs /
init.cxx:392 init_nets): for each routable net, the SOURCE rr-node of its
driver pin's class and the SINK rr-node of each sink pin's class, plus the
bb_factor-expanded bounding box the router restricts its search to
(route.h:70-165 net_t semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..netlist.packed import PackedNetlist
from .graph import RRGraph


@dataclass
class NetTerminals:
    """Flat arrays over routable nets (padded to max fanout)."""
    net_ids: np.ndarray        # [R] packed-netlist net index per routable net
    source: np.ndarray         # [R] SOURCE rr-node
    sinks: np.ndarray          # [R, Smax] SINK rr-nodes, -1 padded
    num_sinks: np.ndarray      # [R]
    bb_xmin: np.ndarray        # [R] bounding box (bb_factor expanded)
    bb_xmax: np.ndarray
    bb_ymin: np.ndarray
    bb_ymax: np.ndarray

    @property
    def num_nets(self) -> int:
        return len(self.net_ids)

    @property
    def max_sinks(self) -> int:
        return self.sinks.shape[1]


def net_terminals(pnl: PackedNetlist, rr: RRGraph, pos: np.ndarray,
                  bb_factor: int = 3) -> NetTerminals:
    """``pos`` is [num_blocks, 3] (x, y, subtile).  bb_factor default mirrors
    SetupVPR.c:337."""
    routable = pnl.routed_nets
    R = len(routable)
    Smax = max((pnl.nets[i].num_sinks for i in routable), default=1)
    nx, ny = rr.grid.nx, rr.grid.ny

    source = np.zeros(R, dtype=np.int32)
    sinks = np.full((R, Smax), -1, dtype=np.int32)
    num_sinks = np.zeros(R, dtype=np.int32)
    bbx0 = np.zeros(R, dtype=np.int32); bbx1 = np.zeros(R, dtype=np.int32)
    bby0 = np.zeros(R, dtype=np.int32); bby1 = np.zeros(R, dtype=np.int32)

    for r, ni in enumerate(routable):
        net = pnl.nets[ni]
        bt = pnl.block_type(net.driver.block)
        x, y, z = (int(v) for v in pos[net.driver.block])
        k = bt.pin_class_of[net.driver.pin]
        source[r] = rr.src_of[(x, y, z, k)]
        xs, ys = [x], [y]
        for s, pin in enumerate(net.sinks):
            bt_s = pnl.block_type(pin.block)
            sx, sy, sz = (int(v) for v in pos[pin.block])
            ks = bt_s.pin_class_of[pin.pin]
            sinks[r, s] = rr.sink_of[(sx, sy, sz, ks)]
            xs.append(sx); ys.append(sy)
        num_sinks[r] = net.num_sinks
        bbx0[r] = max(0, min(xs) - bb_factor)
        bbx1[r] = min(nx + 1, max(xs) + bb_factor)
        bby0[r] = max(0, min(ys) - bb_factor)
        bby1[r] = min(ny + 1, max(ys) + bb_factor)

    return NetTerminals(
        net_ids=np.array(routable, dtype=np.int32),
        source=source, sinks=sinks, num_sinks=num_sinks,
        bb_xmin=bbx0, bb_xmax=bbx1, bb_ymin=bby0, bb_ymax=bby1,
    )


def subset_terminals(term: NetTerminals, frac: float,
                     seed: int = 1) -> NetTerminals:
    """Seeded random subset of the routable nets, SAME device grid.

    The multi-tenant serving layer needs "tiny job on a big device"
    workloads (a daemon serves one graph, so a small job cannot shrink
    the grid — it routes fewer nets on it).  The subset is drawn from
    ``seed`` alone, so a submission spec carrying (circuit seed,
    net_frac, net_seed) is a complete, replayable description of the
    job — delivery retries can never change what gets routed.  Max
    fanout padding is left untouched: the sliced job shares the solo
    circuit's Smax, keeping its dispatch shapes on the same ladder."""
    R = term.num_nets
    k = max(1, min(R, int(round(R * float(frac)))))
    if k >= R:
        return term
    idx = np.sort(np.random.RandomState(int(seed)).choice(
        R, size=k, replace=False))
    return NetTerminals(
        net_ids=term.net_ids[idx], source=term.source[idx],
        sinks=term.sinks[idx], num_sinks=term.num_sinks[idx],
        bb_xmin=term.bb_xmin[idx], bb_xmax=term.bb_xmax[idx],
        bb_ymin=term.bb_ymin[idx], bb_ymax=term.bb_ymax[idx])
