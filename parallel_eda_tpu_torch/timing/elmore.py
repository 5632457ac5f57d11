"""Elmore net-delay model over routed trees (host oracle).

Equivalent of the reference's net delay model (vpr/SRC/timing/net_delay.c
load_net_delay_from_routing: per-net Elmore delay down the route tree).
The device router accumulates a per-edge local delay while searching
(device_graph.to_device: switch Tdel + C_dst*(R_switch + R_dst/2)); with
buffered switches that local model IS the Elmore stage delay of an
unbranched path, but at fanout nodes true Elmore adds the sibling
subtree capacitance hanging off shared wires.  This module computes the
real thing independently, giving (a) a net-delay model for reporting and
(b) an oracle the router's delays are tested against: equal on
unbranched connections, a lower bound everywhere.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..rr.graph import RRGraph


def elmore_tree_delays(rr: RRGraph, tree: List[Tuple[int, int]],
                       buffered: bool = True) -> Dict[int, float]:
    """tree: [(node, parent_node)] rows, SOURCE first (parent -1).
    Returns {node: Elmore delay from the source} for every tree node.

    ``buffered`` mirrors physical_types.h switch.buffered (net_delay.c
    semantics): a buffered switch isolates its downstream load, so each
    stage charges only its own wire's C — which makes the Elmore sum
    along any path equal the device router's accumulated per-edge model
    exactly (the independent-oracle property the test uses).  With
    buffered=False the FULL downstream subtree capacitance loads every
    upstream stage (pass-transistor fabric), which can only increase
    delays.
    """
    children: Dict[int, List[int]] = {}
    parent: Dict[int, int] = {}
    for node, par in tree:
        parent[node] = par
        children.setdefault(par, []).append(node)

    # switch index driving each tree edge: find the out-edge parent->node
    sw_of: Dict[int, int] = {}
    for node, par in tree:
        if par < 0:
            continue
        lo, hi = rr.out_row_ptr[par], rr.out_row_ptr[par + 1]
        for e in range(lo, hi):
            if rr.out_dst[e] == node:
                sw_of[node] = int(rr.out_switch[e])
                break
        else:
            raise ValueError(f"tree edge {par}->{node} not in rr graph")

    # downstream subtree capacitance per node (children-to-parent pass;
    # rows are parent-before-child, so iterate them reversed).  Buffered
    # switches isolate downstream C, so each subtree collapses to the
    # node's own wire C.
    c_sub: Dict[int, float] = {}
    for node, par in reversed(tree):
        c = float(rr.C[node])
        if not buffered:
            for ch in children.get(node, []):
                c += c_sub[ch]
        c_sub[node] = c

    delays: Dict[int, float] = {}
    root = tree[0][0]
    delays[root] = 0.0
    for node, par in tree:
        if par < 0:
            continue
        sw = sw_of[node]
        tdel = float(rr.switch_Tdel[sw])
        r_sw = float(rr.switch_R[sw])
        # the switch resistance charges the whole downstream subtree; the
        # wire's distributed metal R charges its own C at the halfway
        # point and everything beyond it fully
        cs = c_sub[node]
        cw = float(rr.C[node])
        stage = tdel + r_sw * cs + float(rr.R[node]) * (cs - 0.5 * cw)
        delays[node] = delays[par] + stage
    return delays
