"""Timing graph construction (host side).

Equivalent of the reference's timing-graph build
(vpr/SRC/timing/path_delay.c:284 alloc_and_load_timing_graph_new): a DAG of
tnodes over the *logical* primitives with per-connection delays.  Where the
reference allocates pin-level tnodes inside every pb_graph, our cluster
model (arch.model.BlockType T_comb/T_setup/T_clk_to_q stand-ins) needs only
primitive-level nodes:

  inpad        -> one OUT tnode, startpoint (arrival 0)
  lut          -> one OUT tnode; in-edges carry net delay + T_comb
  ff           -> an IN tnode (endpoint; in-edge carries net delay + T_setup)
                  and an OUT tnode (startpoint seeded with T_clk_to_q)
  outpad       -> one IN tnode, endpoint

Each timing edge's delay is  const + routed_delay[ridx]  where ridx indexes
the router's flat per-(net, sink) delay array (the t_net_timing coupling of
vpr_types.h:1134 / path_delay.c:457 load_timing_graph_net_delays_new):
intra-cluster connections get a constant local-interconnect delay and
ridx = -1; inter-cluster connections get ridx >= 0 so every STA call sees
the latest routed delays without rebuilding the graph.

The DAG is levelized on the host once (depth bounds the number of device
relaxation sweeps); clock nets are ideal (no data edges through them,
path_delay.c skips clock nets the same way).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..netlist.netlist import (LogicalNetlist, PRIM_FF, PRIM_HARD,
                               PRIM_INPAD, PRIM_LUT, PRIM_OUTPAD)
from ..netlist.packed import PackedNetlist
from ..rr.terminals import NetTerminals

# intra-cluster feedback-path delay (local output->input mux inside a CLB);
# stands in for VPR7's intra-pb interconnect delays
T_LOCAL = 150e-12


def _ell(num_nodes: int, ends: np.ndarray, other: np.ndarray,
         const: np.ndarray, ridx: np.ndarray):
    """Edge list grouped by ``ends`` -> ELL arrays padded to max degree."""
    order = np.argsort(ends, kind="stable")
    ends, other = ends[order], other[order]
    const, ridx = const[order], ridx[order]
    deg = np.bincount(ends, minlength=num_nodes)
    D = max(1, int(deg.max()) if num_nodes else 1)
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(ends)) - starts[ends]
    e_other = np.zeros((num_nodes, D), dtype=np.int32)
    e_const = np.zeros((num_nodes, D), dtype=np.float32)
    e_ridx = np.full((num_nodes, D), -1, dtype=np.int32)
    e_valid = np.zeros((num_nodes, D), dtype=bool)
    e_other[ends, slot] = other
    e_const[ends, slot] = const
    e_ridx[ends, slot] = ridx
    e_valid[ends, slot] = True
    return e_other, e_const, e_ridx, e_valid


@dataclass
class TimingGraph:
    """Host arrays describing the timing DAG (device copies made by sta)."""
    num_tnodes: int
    depth: int                 # DAG level count (bounds relaxation sweeps)
    # in-edge ELL (forward/arrival sweep): edge (in_src[v,d] -> v)
    in_src: np.ndarray         # int32 [T, D]
    in_const: np.ndarray      # f32   [T, D] constant delay part
    in_ridx: np.ndarray       # int32 [T, D] flat (net, sink) index or -1
    in_valid: np.ndarray      # bool  [T, D]
    # out-edge ELL (backward/required sweep): edge (v -> out_dst[v,d])
    out_dst: np.ndarray
    out_const: np.ndarray
    out_ridx: np.ndarray
    out_valid: np.ndarray
    arrival0: np.ndarray       # f32 [T] startpoint seeds (-inf elsewhere)
    is_endpoint: np.ndarray    # bool [T]
    num_route_slots: int       # R * Smax (size of the routed-delay vector)
    # diagnostics: tnode -> primitive index
    tnode_prim: np.ndarray
    # multi-clock (SDC): endpoint -> clock-domain index into ``domains``
    # (-1 = unclocked endpoint, e.g. outpads: constrained by the default)
    endpoint_domain: np.ndarray = None   # int32 [T]
    domains: list = None                 # domain index -> clock net name
    # SDC I/O constraints (set_input_delay / set_output_delay): pad
    # port/net name -> tnode (inpads keyed by the net they drive,
    # outpads by both the pad name and the net they read)
    inpad_tnode: dict = None
    outpad_tnode: dict = None


def build_timing_graph(nl: LogicalNetlist, pnl: PackedNetlist,
                       term: NetTerminals,
                       t_local: float = T_LOCAL) -> TimingGraph:
    """Build the DAG.  ``term`` supplies the routed-net numbering the delay
    vector uses; pnl supplies prim->block placement of the packing."""
    R, Smax = term.sinks.shape

    block_of_prim = {}
    for bi, b in enumerate(pnl.blocks):
        for p in b.prims:
            block_of_prim[p] = bi

    # (packed net index, sink block) -> flat routed-delay index
    r_of_net = {int(ni): r for r, ni in enumerate(term.net_ids)}
    conn_ridx = {}
    for ni, r in r_of_net.items():
        for s, pin in enumerate(pnl.nets[ni].sinks):
            conn_ridx[(ni, pin.block)] = r * Smax + s

    clocks = set(nl.clocks)

    # ---- tnode numbering ----
    n_prims = len(nl.primitives)
    out_tnode = np.full(n_prims, -1, dtype=np.int32)
    in_tnode = np.full(n_prims, -1, dtype=np.int32)   # ff.IN / outpad.IN
    tnode_prim = []

    def new_tnode(p):
        tnode_prim.append(p)
        return len(tnode_prim) - 1

    for i, p in enumerate(nl.primitives):
        if p.kind == PRIM_INPAD:
            out_tnode[i] = new_tnode(i)
        elif p.kind == PRIM_LUT:
            out_tnode[i] = new_tnode(i)
        elif p.kind in (PRIM_FF, PRIM_HARD):
            # hard macros are registered (RAM/DSP): input setup endpoint,
            # clk-to-q launch point — FF semantics at the block's timing
            in_tnode[i] = new_tnode(i)
            out_tnode[i] = new_tnode(i)
        elif p.kind == PRIM_OUTPAD:
            in_tnode[i] = new_tnode(i)
    T = len(tnode_prim)

    arrival0 = np.full(T, -np.inf, dtype=np.float32)
    is_endpoint = np.zeros(T, dtype=bool)
    # clock domains (SDC multi-clock): one per distinct clock net
    domains = sorted(clocks)
    dom_of = {c: k for k, c in enumerate(domains)}
    endpoint_domain = np.full(T, -1, dtype=np.int32)
    inpad_tnode: dict = {}
    outpad_tnode: dict = {}
    _outpad_dup: set = set()
    for i, p in enumerate(nl.primitives):
        bt = pnl.block_type(block_of_prim[i])
        if p.kind == PRIM_INPAD:
            arrival0[out_tnode[i]] = 0.0
            inpad_tnode[p.name] = int(out_tnode[i])
            if p.output is not None:
                inpad_tnode[p.output] = int(out_tnode[i])
        elif p.kind in (PRIM_FF, PRIM_HARD):
            arrival0[out_tnode[i]] = bt.T_clk_to_q
            is_endpoint[in_tnode[i]] = True
            if p.clock is not None:
                endpoint_domain[in_tnode[i]] = dom_of[p.clock]
        elif p.kind == PRIM_OUTPAD:
            is_endpoint[in_tnode[i]] = True
            outpad_tnode[p.name] = int(in_tnode[i])
            if p.inputs and p.inputs[0] is not None:
                # net-name key only while unambiguous: two pads reading
                # the same net must not alias (the pad NAME always works)
                n = p.inputs[0]
                if n in outpad_tnode and outpad_tnode[n] != int(
                        in_tnode[i]):
                    _outpad_dup.add(n)
                else:
                    outpad_tnode[n] = int(in_tnode[i])

    # ---- edges ----
    e_src, e_dst, e_const, e_ridx = [], [], [], []
    for i, p in enumerate(nl.primitives):
        if p.kind in (PRIM_INPAD,):
            continue
        bt = pnl.block_type(block_of_prim[i])
        if p.kind == PRIM_LUT:
            dst, extra = out_tnode[i], bt.T_comb
        elif p.kind in (PRIM_FF, PRIM_HARD):
            dst, extra = in_tnode[i], bt.T_setup
        else:                                       # outpad
            dst, extra = in_tnode[i], 0.0
        for n in p.inputs:
            if n is None or n in clocks:
                continue          # unconnected port / ideal clock network
            dp = nl.net_driver[n]
            src = out_tnode[dp]
            const, ridx = extra, -1
            if block_of_prim[dp] == block_of_prim[i]:
                const += t_local
            else:
                ni = pnl.net_index.get(n, -1)
                key = (ni, block_of_prim[i])
                if key in conn_ridx:
                    ridx = conn_ridx[key]
                # else: global/unrouted inter-cluster net -> const only
            e_src.append(src); e_dst.append(dst)
            e_const.append(const); e_ridx.append(ridx)

    e_src = np.array(e_src, dtype=np.int32)
    e_dst = np.array(e_dst, dtype=np.int32)
    e_const = np.array(e_const, dtype=np.float32)
    e_ridx = np.array(e_ridx, dtype=np.int32)

    # ---- levelize (Kahn) for the sweep-depth bound ----
    indeg = np.bincount(e_dst, minlength=T) if len(e_dst) else np.zeros(T, int)
    level = np.zeros(T, dtype=np.int32)
    from collections import deque
    adj_starts = None
    order_e = np.argsort(e_src, kind="stable") if len(e_src) else e_src
    srcs_sorted = e_src[order_e]
    dsts_sorted = e_dst[order_e]
    deg_out = np.bincount(e_src, minlength=T) if len(e_src) else np.zeros(T, int)
    starts = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(deg_out, out=starts[1:])
    q = deque(int(v) for v in np.where(indeg == 0)[0])
    seen = 0
    indeg_w = indeg.copy()
    while q:
        v = q.popleft()
        seen += 1
        for e in range(starts[v], starts[v + 1]):
            w = int(dsts_sorted[e])
            if level[w] < level[v] + 1:
                level[w] = level[v] + 1
            indeg_w[w] -= 1
            if indeg_w[w] == 0:
                q.append(w)
    if seen != T:
        raise ValueError("combinational loop in timing graph")
    depth = int(level.max()) + 1 if T else 1

    in_src, in_const, in_ridx, in_valid = _ell(T, e_dst, e_src, e_const,
                                               e_ridx)
    out_dst, out_const, out_ridx, out_valid = _ell(T, e_src, e_dst, e_const,
                                                   e_ridx)
    return TimingGraph(
        num_tnodes=T, depth=depth,
        in_src=in_src, in_const=in_const, in_ridx=in_ridx, in_valid=in_valid,
        out_dst=out_dst, out_const=out_const, out_ridx=out_ridx,
        out_valid=out_valid,
        arrival0=arrival0, is_endpoint=is_endpoint,
        num_route_slots=R * Smax,
        tnode_prim=np.array(tnode_prim, dtype=np.int32),
        endpoint_domain=endpoint_domain, domains=domains,
        inpad_tnode=inpad_tnode,
        outpad_tnode={k: v for k, v in outpad_tnode.items()
                      if k not in _outpad_dup},
    )
