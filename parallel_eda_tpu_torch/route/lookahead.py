"""Per-cost-index A* lookahead (route_timing.c:693-760 semantics).

The reference's expected-cost map — ``get_timing_driven_expected_cost``
(vpr/SRC/route/route_timing.c:693) with ``get_expected_segs_to_target``
(:753), ported again at parallel_route/router.cxx:445-640 — estimates
the remaining cost from a wire node to the target as *segment counts*
times *per-segment-class costs*: the distance along the node's own axis
is covered by segments of the node's own class (same-dir count), the
orthogonal distance by the paired class in the other channel
(ortho-dir count), plus an IPIN+SINK tail.  This is sharper than a
flat per-tile floor in both dimensions:

- the DELAY term exists at all (the flat floor used by earlier rounds
  dropped delay for the serial router, so critical-net searches ran
  nearly un-pruned), and is per-class — a long-segment class with one
  switch per 4 tiles prunes 4x harder than a per-tile bound;
- the CONGESTION term counts segments, not tiles, through the node's
  own class length.

Like the reference, the same-class assumption is a deliberate
heuristic: a short-wire node estimates its remaining distance in
short-wire hops even when longer wires exist, which can overestimate
(VPR ships astar_fac 1.2 on top of the same property).  All
per-class constants are minima over the class, so within the
same-class assumption the bound is tight-side.

Tables are built once per rr-graph on the host and expanded to
per-NODE arrays so consumers pay O(1) lookups per heap push (serial
CPU routers) or a handful of gathers per window (device ELL search).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..rr.graph import CHANX, CHANY, IPIN, SINK, RRGraph


@dataclass
class Lookahead:
    """Per-node expected-cost parameters (+ scalar tails).

    For a wire node u and target (tx, ty), with interval distances
    dx = max(xlow[u]-tx, tx-xhigh[u], 0) and dy likewise:

        dsame, dortho = (dx, dy) if axis[u] == 0 else (dy, dx)
        nsame  = ceildiv(dsame,  len_same[u])
        northo = ceildiv(dortho, len_ortho[u])
        h_delay = nsame*tlin_same[u] + northo*tlin_ortho[u] + term_delay
        h_cong  = manhattan * min_wire_cost        (flat per-tile floor)
        h = astar_fac * (cw*h_delay + (1-cw)*h_cong)

    The congestion term deliberately stays the flat floor (min_wire_cost
    per manhattan tile, derived by device_graph.wire_cost_floor — the
    consumers hold it themselves): measured on placed 300/1200-LUT
    fixtures, a per-class congestion term bought no pop reduction
    (1.03-1.12x) and cost ~4% wirelength, while the per-class delay term
    alone cuts timing-driven pops 3.5-5x.  At crit=0 the whole h
    reduces bit-for-bit to the flat heuristic.  Non-wire nodes
    (axis == 2) use the flat floors for both terms.
    """
    axis: np.ndarray        # uint8 [N]: 0 = CHANX, 1 = CHANY, 2 = other
    len_same: np.ndarray    # int32 [N] >= 1 (segment length, tiles)
    len_ortho: np.ndarray   # int32 [N] >= 1
    tlin_same: np.ndarray   # f64 [N] per-segment delay floor
    tlin_ortho: np.ndarray  # f64 [N]
    term_delay: float       # IPIN+SINK delay tail


def build_lookahead(rr: RRGraph) -> Lookahead:
    """Derive the per-class tables from the rr-graph and expand them to
    per-node arrays (load_rr_indexed_data /
    rr_graph_indexed_data.c semantics: T_linear and base cost per cost
    index, ortho_cost_index pairing via the shared segment id)."""
    N = rr.num_nodes
    nt = rr.node_type
    wire = (nt == CHANX) | (nt == CHANY)

    ci = rr.cost_index.astype(np.int64)
    nci = int(ci.max()) + 1 if N else 1
    in_dst = np.repeat(np.arange(N), np.diff(rr.in_row_ptr))

    seg_len = np.ones(nci, dtype=np.int64)
    tlin = np.zeros(nci, dtype=np.float64)
    for c in np.unique(ci[wire]) if wire.any() else []:
        m = wire & (ci == c)
        span = (rr.xhigh.astype(np.int64) - rr.xlow
                + rr.yhigh - rr.ylow)[m]
        # the class's FULL length (edge wires are clipped shorter)
        seg_len[c] = max(1, int(span.max()) + 1)
        ed = rr.in_delay[m[in_dst]]
        tlin[c] = float(ed.min()) if len(ed) else 0.0

    # ortho pairing: wire classes sharing a segment id across CHANX /
    # CHANY are each other's ortho class (rr_indexed_data ortho_cost_index)
    ortho = np.arange(nci, dtype=np.int64)
    if rr.seg_of_track is not None and wire.any():
        W = len(rr.seg_of_track)
        seg_of_node = np.zeros(N, dtype=np.int64)
        seg_of_node[wire] = rr.seg_of_track[rr.ptc[wire] % W]
        by_chan_seg = {}
        for c in np.unique(ci[wire]):
            m = wire & (ci == c)
            by_chan_seg[(int(nt[m][0]), int(seg_of_node[m][0]))] = int(c)
        for (ch, s), c in by_chan_seg.items():
            other = CHANY if ch == CHANX else CHANX
            ortho[c] = by_chan_seg.get((other, s), c)

    axis = np.full(N, 2, dtype=np.uint8)
    axis[nt == CHANX] = 0
    axis[nt == CHANY] = 1
    cio = ortho[ci]
    len_same = np.where(wire, seg_len[ci], 1).astype(np.int32)
    len_ortho = np.where(wire, seg_len[cio], 1).astype(np.int32)
    tlin_same = np.where(wire, tlin[ci], 0.0)
    tlin_ortho = np.where(wire, tlin[cio], 0.0)

    # IPIN + SINK delay tail: every wire-to-target completion pays at
    # least one IPIN hop and one SINK hop (cheapest of each, admissible)
    def _tail(tmask_nodes):
        d = rr.in_delay[tmask_nodes[in_dst]]
        return float(d.min()) if len(d) else 0.0

    return Lookahead(
        axis=axis, len_same=len_same, len_ortho=len_ortho,
        tlin_same=tlin_same, tlin_ortho=tlin_ortho,
        term_delay=_tail(nt == IPIN) + _tail(nt == SINK))
