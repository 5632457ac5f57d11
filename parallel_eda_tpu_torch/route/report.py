"""Post-route wirelength / channel-occupancy reporting.

Equivalent of the reference's stats subsystem (vpr/SRC/base/stats.c
routing_stats: wirelength, channel occupancy factors;
route/segment_stats.c get_segment_usage_stats: per-segment-type wire
counts and utilization).  Pure host reporting over the routed result —
printed after routing and/or written next to the stats files.
"""

from __future__ import annotations

import numpy as np

from ..rr.graph import CHANX, CHANY, RRGraph


def overused_wire_nodes(rr: RRGraph, occ: np.ndarray) -> int:
    """Count of WIRE nodes (CHANX/CHANY) over capacity.  stats.c counts
    overuse on routing wires only — SOURCE/SINK/pin nodes are not
    fabric resources — so every report of it goes through this one
    helper and cannot drift."""
    occ = np.asarray(occ)
    nt = np.asarray(rr.node_type)
    wire = (nt == CHANX) | (nt == CHANY)
    over = occ - np.asarray(rr.capacity, dtype=np.int64)
    return int(((over > 0) & wire).sum())


def route_report(rr: RRGraph, occ: np.ndarray,
                 num_nets: int) -> str:
    """Human-readable routing statistics block."""
    occ = np.asarray(occ)
    is_x = np.asarray(rr.node_type) == CHANX
    is_y = np.asarray(rr.node_type) == CHANY
    wire = is_x | is_y
    used = occ > 0
    span = (np.asarray(rr.xhigh) - np.asarray(rr.xlow)
            + np.asarray(rr.yhigh) - np.asarray(rr.ylow) + 1)

    lines = ["Routing statistics (stats.c routing_stats equivalent):"]
    total_wl = int(span[wire & used].sum())
    lines.append(f"  nets routed: {num_nets}")
    lines.append(f"  total wirelength: {total_wl} tile-lengths "
                 f"({int((wire & used).sum())} wire nodes)")
    lines.append(f"  avg wirelength per net: "
                 f"{total_wl / max(1, num_nets):.2f}")

    # channel occupancy factors (utilization of each channel's tracks)
    for name, m in (("CHANX", is_x), ("CHANY", is_y)):
        cap = int(m.sum())
        u = int((m & used).sum())
        lines.append(f"  {name} utilization: {u}/{cap} "
                     f"({100.0 * u / max(1, cap):.1f}%)")

    # per-segment-type usage (segment_stats.c get_segment_usage_stats);
    # cost_index encodes the segment type for wires
    ci = np.asarray(rr.cost_index)
    for c in sorted(set(ci[wire].tolist())):
        m = wire & (ci == c)
        u = int((m & used).sum())
        L = int(span[m].max()) if m.any() else 0
        lines.append(f"  segment cost_index {int(c)} (len<={L}): "
                     f"{u}/{int(m.sum())} wires used")

    # occupancy histogram: how contested the fabric is (wire nodes
    # only, stats.c semantics — see overused_wire_nodes)
    lines.append(f"  overused nodes: {overused_wire_nodes(rr, occ)}")
    return "\n".join(lines)


def write_route_report(path: str, rr: RRGraph, occ: np.ndarray,
                       num_nets: int) -> None:
    with open(path, "w") as f:
        f.write(route_report(rr, occ, num_nets) + "\n")
