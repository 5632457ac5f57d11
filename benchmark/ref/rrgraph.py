"""Frozen copy of the port's ``rr/graph.py`` (rr-graph construction), kept
with the benchmark as part of its yardstick: the reference rebuilds from
it what the program derives, and compares. Only imports were changed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .arch import Arch, PIN_CLASS_DRIVER, PIN_CLASS_RECEIVER
from .grid import DeviceGrid

# rr-node types (order matches files.py writers and the reference's t_rr_type)
SOURCE, SINK, OPIN, IPIN, CHANX, CHANY = range(6)
RR_TYPE_NAMES = ["SOURCE", "SINK", "OPIN", "IPIN", "CHANX", "CHANY"]

# cost indices (rr_graph_indexed_data.c equivalent)
COST_SOURCE, COST_SINK, COST_OPIN, COST_IPIN = range(4)
# wires: 4 + seg (CHANX), 4 + num_seg + seg (CHANY)


@dataclass
class RRGraph:
    """Flat SoA rr-graph.  All arrays are host numpy; the router uploads the
    ones it needs as jnp device arrays (see route/device_graph.py)."""
    # --- nodes ---
    node_type: np.ndarray       # int8   [N]
    xlow: np.ndarray            # int16  [N]
    ylow: np.ndarray            # int16  [N]
    xhigh: np.ndarray           # int16  [N]
    yhigh: np.ndarray           # int16  [N]
    ptc: np.ndarray             # int32  [N]  pin/class/track index
    capacity: np.ndarray        # int16  [N]
    R: np.ndarray               # f32    [N]
    C: np.ndarray               # f32    [N]
    cost_index: np.ndarray      # int8   [N]
    base_cost: np.ndarray       # f32    [N]
    # --- out-edge CSR ---
    out_row_ptr: np.ndarray     # int32  [N+1]
    out_dst: np.ndarray         # int32  [E]
    out_switch: np.ndarray      # int8   [E]
    # --- in-edge CSR (derived; in_src sorted by destination) ---
    in_row_ptr: np.ndarray      # int32  [N+1]
    in_src: np.ndarray          # int32  [E]
    in_switch: np.ndarray       # int8   [E]
    # per-in-edge traversal delay: switch Tdel + C_dst*(R_switch + R_dst/2)
    in_delay: np.ndarray        # f32    [E]
    # --- lookups (host only) ---
    src_of: Dict[Tuple[int, int, int, int], int]   # (x,y,z,class) -> node
    sink_of: Dict[Tuple[int, int, int, int], int]
    opin_of: Dict[Tuple[int, int, int, int], int]  # (x,y,z,pin)  -> node
    ipin_of: Dict[Tuple[int, int, int, int], int]
    grid: DeviceGrid
    chan_width: int
    switch_Tdel: np.ndarray     # f32 [num_switches+1] (last = delayless)
    switch_R: np.ndarray        # f32 [num_switches+1]
    # per-track segment / wire-to-wire switch (planes kernel co-design:
    # route/planes.py derives its static delay planes from these)
    seg_of_track: Optional[np.ndarray] = None       # int32 [W]
    wire_switch_of_track: Optional[np.ndarray] = None  # int32 [W]
    # unidir graphs: per-track direction (0 = INC, 1 = DEC); None = bidir
    dir_of_track: Optional[np.ndarray] = None       # int32 [W]

    @property
    def unidir(self) -> bool:
        return self.dir_of_track is not None

    @property
    def num_nodes(self) -> int:
        return len(self.node_type)

    @property
    def num_edges(self) -> int:
        return len(self.out_dst)

    def describe(self, node: int) -> str:
        """Pretty printer (parallel_route/utility.c:13 sprintf_rr_node)."""
        t = RR_TYPE_NAMES[self.node_type[node]]
        return (f"{node} {t} ({self.xlow[node]},{self.ylow[node]})"
                f"->({self.xhigh[node]},{self.yhigh[node]}) ptc "
                f"{self.ptc[node]}")


def _fc_tracks(pin_ptc: int, side: int, W: int, fc: float) -> List[int]:
    """Which of the W tracks a pin connects to in one adjacent channel.
    Staggered spread (rr_graph2.c alloc_and_load_pin_to_track_map semantics —
    independently chosen pattern with the same spreading goal)."""
    fc_abs = max(1, int(round(fc * W)))
    fc_abs = min(fc_abs, W)
    start = (pin_ptc * 7 + side * 3) % W
    return [ (start + (j * W) // fc_abs) % W for j in range(fc_abs) ]


def build_rr_graph(arch: Arch, grid: DeviceGrid,
                   chan_width: Optional[int] = None) -> RRGraph:
    """Build the full rr-graph (semantics of rr_graph.c:385 build_rr_graph)."""
    W = chan_width or arch.default_chan_width
    nx, ny = grid.nx, grid.ny
    num_seg = len(arch.segments)

    if getattr(arch, "sb_type", "subset_rotated") not in (
            "subset", "subset_rotated"):
        import warnings

        warnings.warn(
            f"arch requests switch_block type={arch.sb_type!r} "
            f"fs={arch.sb_fs}; this construction implements its co-designed "
            "subset+rotated pattern (same O(W) switch count, the Wilton "
            "index-permutation property via parity-rotated turns — "
            "rr/graph.py switch-box notes).  Connectivity is a superset "
            "of subset and QoR-equivalent in the committed gates, but "
            "track-level topology will differ from VPR's "
            f"{arch.sb_type} box.")

    dirs = {s.directionality for s in arch.segments}
    if len(dirs) > 1:
        raise ValueError(f"segments mix directionalities {dirs}; the rr "
                         f"construction requires one mode (rr_graph.c:432)")
    unidir = dirs == {"unidir"}
    if unidir and W % 2:
        W += 1          # unidir tracks pair INC/DEC; VPR forces even W

    # segment type per track: frequency-proportional contiguous blocks
    # (unidir: assigned per INC/DEC track PAIR so both directions of a
    # lane share a segment type, rr_graph.c unidir pairing)
    Wa = W // 2 if unidir else W
    seg_assign = np.zeros(Wa, dtype=np.int32)
    freqs = np.array([s.frequency for s in arch.segments], dtype=np.float64)
    freqs = freqs / freqs.sum()
    bounds = np.floor(np.cumsum(freqs) * Wa + 0.5).astype(np.int64)
    lo = 0
    for s, hi in enumerate(bounds):
        seg_assign[lo:hi] = s
        lo = hi
    seg_assign[lo:] = num_seg - 1
    seg_of_track = np.repeat(seg_assign, 2) if unidir else seg_assign

    def type_at(x: int, y: int):
        """Block type on tile (x, y), or None (corner/empty).  Interior
        columns may hold heterogeneous types (grid.col_types,
        SetupGrid.c column assignment)."""
        if 1 <= x <= nx and 1 <= y <= ny:
            return arch.block_type(grid.interior_type_name(x))
        if grid.is_io(x, y):
            return arch.io_type
        return None

    ntype: List[int] = []
    xlo: List[int] = []; ylo: List[int] = []
    xhi: List[int] = []; yhi: List[int] = []
    ptc: List[int] = []; cap: List[int] = []
    Rn: List[float] = []; Cn: List[float] = []
    cidx: List[int] = []

    def add_node(t, x1, y1, x2, y2, p, c, r_, c_, ci) -> int:
        ntype.append(t); xlo.append(x1); ylo.append(y1)
        xhi.append(x2); yhi.append(y2); ptc.append(p); cap.append(c)
        Rn.append(r_); Cn.append(c_); cidx.append(ci)
        return len(ntype) - 1

    src_of: Dict = {}; sink_of: Dict = {}
    opin_of: Dict = {}; ipin_of: Dict = {}

    # ---- block-pin nodes (SOURCE/SINK/OPIN/IPIN), per tile/subtile ----
    for x in range(nx + 2):
        for y in range(ny + 2):
            bt = type_at(x, y)
            if bt is None:
                continue
            ncls = len(bt.pin_classes)
            for z in range(bt.capacity):
                for k, cls in enumerate(bt.pin_classes):
                    pc = z * ncls + k
                    if cls.direction == PIN_CLASS_DRIVER:
                        src_of[(x, y, z, k)] = add_node(
                            SOURCE, x, y, x, y, pc, len(cls.pins),
                            0.0, 0.0, COST_SOURCE)
                    else:
                        sink_of[(x, y, z, k)] = add_node(
                            SINK, x, y, x, y, pc, len(cls.pins),
                            0.0, 0.0, COST_SINK)
                for p in range(bt.num_pins):
                    pc = z * bt.num_pins + p
                    k = bt.pin_class_of[p]
                    if bt.pin_classes[k].direction == PIN_CLASS_DRIVER:
                        opin_of[(x, y, z, p)] = add_node(
                            OPIN, x, y, x, y, pc, 1, 0.0, 0.0, COST_OPIN)
                    else:
                        ipin_of[(x, y, z, p)] = add_node(
                            IPIN, x, y, x, y, pc, 1, 0.0, 0.0, COST_IPIN)

    # ---- wire nodes ----
    # chanx_wire[y][t, x] / chany_wire[x][t, y]: node covering that position
    chanx_wire = [np.full((W, nx + 1), -1, dtype=np.int64)
                  for _ in range(ny + 1)]
    chany_wire = [np.full((W, ny + 1), -1, dtype=np.int64)
                  for _ in range(nx + 1)]

    def wire_spans(lo_pos: int, hi_pos: int, L: int, stagger: int):
        """Partition [lo_pos, hi_pos] into length-L spans with break after
        every position p where (p - stagger) % L == 0."""
        spans = []
        a = lo_pos
        for p in range(lo_pos, hi_pos + 1):
            if (p - stagger) % L == 0 or p == hi_pos:
                spans.append((a, p))
                a = p + 1
        return spans

    def stagger(t: int, L: int) -> int:
        # unidir: stagger by LANE PAIR so wire starts of each direction
        # spread over all positions (t % L would give every INC track
        # the same phase, leaving whole columns with no drive point)
        return ((t // 2) % L) if unidir else (t % L)

    for y in range(ny + 1):
        for t in range(W):
            seg = arch.segments[seg_of_track[t]]
            L = max(1, seg.length)
            for (a, b) in wire_spans(1, nx, L, stagger(t, L)):
                span = b - a + 1
                node = add_node(CHANX, a, y, b, y, t, 1,
                                seg.Rmetal * span, seg.Cmetal * span,
                                4 + seg_of_track[t])
                chanx_wire[y][t, a:b + 1] = node
    for x in range(nx + 1):
        for t in range(W):
            seg = arch.segments[seg_of_track[t]]
            L = max(1, seg.length)
            for (a, b) in wire_spans(1, ny, L, stagger(t, L)):
                span = b - a + 1
                node = add_node(CHANY, x, a, x, b, t, 1,
                                seg.Rmetal * span, seg.Cmetal * span,
                                4 + num_seg + seg_of_track[t])
                chany_wire[x][t, a:b + 1] = node

    N = len(ntype)
    node_type = np.array(ntype, dtype=np.int8)
    xlow = np.array(xlo, dtype=np.int16); ylow = np.array(ylo, dtype=np.int16)
    xhigh = np.array(xhi, dtype=np.int16); yhigh = np.array(yhi, dtype=np.int16)

    # ---- switch table (+ appended delayless switch) ----
    nsw = len(arch.switches)
    delayless = nsw
    switch_Tdel = np.array([s.Tdel for s in arch.switches] + [0.0],
                           dtype=np.float32)
    switch_R = np.array([s.R for s in arch.switches] + [0.0],
                        dtype=np.float32)

    e_src: List[int] = []; e_dst: List[int] = []; e_sw: List[int] = []

    def add_edge(s, d, sw):
        e_src.append(s); e_dst.append(d); e_sw.append(sw)

    # ---- SOURCE->OPIN, IPIN->SINK (delayless) ----
    for x in range(nx + 2):
        for y in range(ny + 2):
            bt = type_at(x, y)
            if bt is None:
                continue
            for z in range(bt.capacity):
                for k, cls in enumerate(bt.pin_classes):
                    if cls.direction == PIN_CLASS_DRIVER:
                        s = src_of[(x, y, z, k)]
                        for p in cls.pins:
                            add_edge(s, opin_of[(x, y, z, p)], delayless)
                    else:
                        snk = sink_of[(x, y, z, k)]
                        for p in cls.pins:
                            add_edge(ipin_of[(x, y, z, p)], snk, delayless)

    # ---- pin <-> channel edges ----
    # adjacent channels of tile (x,y): list of (kind, chan_idx, row_idx, pos)
    # where a CHANX adjacency is ('x', y_chan, x) and CHANY is ('y', x_chan, y)
    def adjacent_channels(x: int, y: int):
        adj = []
        if grid.is_clb(x, y):
            adj = [("x", y, x), ("x", y - 1, x),
                   ("y", x, y), ("y", x - 1, y)]
        elif x == 0:                      # left IO
            adj = [("y", 0, y)]
        elif x == nx + 1:                 # right IO
            adj = [("y", nx, y)]
        elif y == 0:                      # bottom IO
            adj = [("x", 0, x)]
        elif y == ny + 1:                 # top IO
            adj = [("x", ny, x)]
        return adj

    def starting_tracks(kind: str, ci: int, pos: int) -> List[int]:
        """Unidir: tracks whose wire STARTS at this channel position (the
        only legal drive points; INC starts at its low end, DEC at its
        high end — rr_graph.c unidir opin/mux placement)."""
        out = []
        for t in range(W):
            w = int(chanx_wire[ci][t, pos] if kind == "x"
                    else chany_wire[ci][t, pos])
            if w < 0:
                continue
            if kind == "x":
                start = (xlo[w] == pos) if t % 2 == 0 else (xhi[w] == pos)
            else:
                start = (ylo[w] == pos) if t % 2 == 0 else (yhi[w] == pos)
            if start:
                out.append(t)
        return out

    for x in range(nx + 2):
        for y in range(ny + 2):
            bt = type_at(x, y)
            if bt is None:
                continue
            adj = adjacent_channels(x, y)
            for z in range(bt.capacity):
                for p in range(bt.num_pins):
                    k = bt.pin_class_of[p]
                    cls = bt.pin_classes[k]
                    is_out = cls.direction == PIN_CLASS_DRIVER
                    node = (opin_of if is_out else ipin_of)[(x, y, z, p)]
                    fc = arch.fc_frac(W, is_out, type_name=bt.name, pin=p)
                    pin_ptc = z * bt.num_pins + p
                    for side, (kind, ci, pos) in enumerate(adj):
                        if unidir and is_out:
                            # single-driver wires: OPINs drive only wire
                            # STARTS; spread Fc over the start set
                            cands = starting_tracks(kind, ci, pos)
                            if not cands:
                                continue
                            fc_abs = min(len(cands),
                                         max(1, int(round(fc * W))))
                            st = (pin_ptc * 7 + side * 3) % len(cands)
                            picks = {cands[(st + (j * len(cands))
                                            // fc_abs) % len(cands)]
                                     for j in range(fc_abs)}
                            for t in sorted(picks):
                                wire = (chanx_wire[ci][t, pos]
                                        if kind == "x"
                                        else chany_wire[ci][t, pos])
                                sw = arch.segments[
                                    seg_of_track[t]].opin_switch
                                add_edge(node, int(wire), sw)
                            continue
                        for t in _fc_tracks(pin_ptc, side, W, fc):
                            wire = (chanx_wire[ci][t, pos] if kind == "x"
                                    else chany_wire[ci][t, pos])
                            if wire < 0:
                                continue
                            if is_out:
                                sw = arch.segments[seg_of_track[t]].opin_switch
                                add_edge(node, int(wire), sw)
                            else:
                                add_edge(int(wire), node, arch.ipin_switch)

    # ---- dedicated direct connections (<directlist>,
    # physical_types.h t_direct_inf): OPIN -> IPIN of the offset
    # neighbour through a private wire, bypassing the fabric ----
    for d in arch.directs:
        sw = d.switch if d.switch >= 0 else delayless
        for x in range(nx + 2):
            for y in range(ny + 2):
                bt = type_at(x, y)
                if bt is None or bt.name != d.from_type:
                    continue
                tx, ty = x + d.dx, y + d.dy
                tt = type_at(tx, ty)
                if tt is None or tt.name != d.to_type:
                    continue
                for z in range(bt.capacity):
                    src_n = opin_of.get((x, y, z, d.from_pin))
                    dst_n = ipin_of.get((tx, ty, z, d.to_pin))
                    if src_n is not None and dst_n is not None:
                        add_edge(src_n, dst_n, sw)

    # ---- switch-box edges (endpoint rule; subset + rotated mixing) ----
    # Straight continuations and same-index turns follow the subset rule
    # (rr_graph_sbox.c get_subset_sbox: track t only meets track t), which
    # converges fast under PathFinder because the per-track subnetworks are
    # interchangeable.  A pure subset box, however, never mixes track
    # indices, so a pin whose Fc track-set misses the target pin's set is
    # simply unreachable (real case: two bottom-edge IO pads with disjoint
    # 2-3 track sets).  We therefore ADD endpoint-gated turns at a rotated
    # index, CHANX t <-> CHANY (t + 1 + (x+y) mod 2) mod W: the shift
    # varies with corner parity so an X->Y->X loop nets an index change of
    # +-1 (the Wilton property that matters — turns permute indices so the
    # reachable track set grows, rr_graph_sbox.c get_wilton_sbox
    # motivation) while every edge still obeys the endpoint rule, keeping
    # the switch count O(W) per corner like the reference's Fs=3 boxes.
    # (A previous variant put rotated turns at EVERY corner a wire passes
    # and dropped same-index turns entirely; it stayed connected but made
    # congestion negotiation ~2-3x slower to converge — per-track
    # interchangeability is what lets PathFinder shift a net sideways.)
    # corner (x, y): x in 0..nx, y in 0..ny
    def ends_at(w: int, x: int, y: int) -> bool:
        if node_type[w] == CHANX:
            return xhigh[w] == x or xlow[w] == x + 1
        return yhigh[w] == y or ylow[w] == y + 1

    if unidir:
        # ---- directed switch box (single-driver rule,
        # rr_graph.c:432-548): at corner (x, y) every wire whose DRIVING
        # end lands on the corner (INC ends at its high end, DEC at its
        # low end) drives wires STARTING at the corner — straight
        # continuation on the same track, same-index turns, and rotated
        # turns with the same corner-parity shift as the bidir box (so
        # the planes kernel keeps its roll structure).  Each edge uses
        # the TARGET segment's mux switch (the mux belongs to the driven
        # wire's start).
        def cxw(t, pos, y):
            return int(chanx_wire[y][t, pos]) if 1 <= pos <= nx else -1

        def cyw(t, pos, x):
            return int(chany_wire[x][t, pos]) if 1 <= pos <= ny else -1

        for x in range(nx + 1):
            for y in range(ny + 1):
                par = (x + y) % 2
                shift = (1 + par) % W
                drv_x = [-1] * W
                tgt_x = [-1] * W
                drv_y = [-1] * W
                tgt_y = [-1] * W
                for t in range(W):
                    if t % 2 == 0:              # INC
                        w = cxw(t, x, y)
                        if w >= 0 and xhi[w] == x:
                            drv_x[t] = w
                        w = cxw(t, x + 1, y)
                        if w >= 0 and xlo[w] == x + 1:
                            tgt_x[t] = w
                        w = cyw(t, y, x)
                        if w >= 0 and yhi[w] == y:
                            drv_y[t] = w
                        w = cyw(t, y + 1, x)
                        if w >= 0 and ylo[w] == y + 1:
                            tgt_y[t] = w
                    else:                       # DEC
                        w = cxw(t, x + 1, y)
                        if w >= 0 and xlo[w] == x + 1:
                            drv_x[t] = w
                        w = cxw(t, x, y)
                        if w >= 0 and xhi[w] == x:
                            tgt_x[t] = w
                        w = cyw(t, y + 1, x)
                        if w >= 0 and ylo[w] == y + 1:
                            drv_y[t] = w
                        w = cyw(t, y, x)
                        if w >= 0 and yhi[w] == y:
                            tgt_y[t] = w
                for t in range(W):
                    sw_t = arch.segments[seg_of_track[t]].wire_switch
                    # straight continuation, same track
                    if drv_x[t] >= 0 and tgt_x[t] >= 0:
                        add_edge(drv_x[t], tgt_x[t], sw_t)
                    if drv_y[t] >= 0 and tgt_y[t] >= 0:
                        add_edge(drv_y[t], tgt_y[t], sw_t)
                    # same-index turns
                    if drv_x[t] >= 0 and tgt_y[t] >= 0:
                        add_edge(drv_x[t], tgt_y[t], sw_t)
                    if drv_y[t] >= 0 and tgt_x[t] >= 0:
                        add_edge(drv_y[t], tgt_x[t], sw_t)
                    # rotated turns (chanx t -> chany t+shift;
                    # chany u -> chanx u-shift: the bidir box's symmetric
                    # pair, kept as two directed rules)
                    if shift:
                        ty = (t + shift) % W
                        if drv_x[t] >= 0 and tgt_y[ty] >= 0:
                            add_edge(drv_x[t], tgt_y[ty],
                                     arch.segments[
                                         seg_of_track[ty]].wire_switch)
                        tx = (t - shift) % W
                        if drv_y[t] >= 0 and tgt_x[tx] >= 0:
                            add_edge(drv_y[t], tgt_x[tx],
                                     arch.segments[
                                         seg_of_track[tx]].wire_switch)

    for x in (range(nx + 1) if not unidir else ()):
        # bidir switch box (the unidir box was emitted above)
        for y in range(ny + 1):
            for t in range(W):
                sw = arch.segments[seg_of_track[t]].wire_switch

                def chanx_at(tt):
                    out: List[int] = []
                    for px in (x, x + 1):
                        if 1 <= px <= nx:
                            w = int(chanx_wire[y][tt, px])
                            if w >= 0 and w not in out:
                                out.append(w)
                    return out

                def chany_at(tt):
                    out: List[int] = []
                    for py in (y, y + 1):
                        if 1 <= py <= ny:
                            w = int(chany_wire[x][tt, py])
                            if w >= 0 and w not in out:
                                out.append(w)
                    return out

                hx = chanx_at(t)
                vy = chany_at(t)
                vy_turn = chany_at((t + 1 + (x + y) % 2) % W)

                # straight continuations (same index, endpoint-gated)
                for i in range(len(hx)):
                    for j in range(i + 1, len(hx)):
                        a, b = hx[i], hx[j]
                        if ends_at(a, x, y) or ends_at(b, x, y):
                            add_edge(a, b, sw)
                            add_edge(b, a, sw)
                for i in range(len(vy)):
                    for j in range(i + 1, len(vy)):
                        a, b = vy[i], vy[j]
                        if ends_at(a, x, y) or ends_at(b, x, y):
                            add_edge(a, b, sw)
                            add_edge(b, a, sw)
                # same-index turns (subset rule, endpoint-gated)
                for a in hx:
                    for b in vy:
                        if ends_at(a, x, y) or ends_at(b, x, y):
                            add_edge(a, b, sw)
                            add_edge(b, a, sw)
                # rotated turns (index mixing, endpoint-gated); at W <= 2
                # the rotated track can coincide with t — skip to avoid
                # duplicating the same-index turns above
                if (t + 1 + (x + y) % 2) % W != t:
                    for a in hx:
                        for b in vy_turn:
                            if ends_at(a, x, y) or ends_at(b, x, y):
                                add_edge(a, b, sw)
                                add_edge(b, a, sw)

    # ---- pack CSR ----
    E = len(e_src)
    esrc = np.array(e_src, dtype=np.int64)
    edst = np.array(e_dst, dtype=np.int64)
    esw = np.array(e_sw, dtype=np.int8)

    order = np.argsort(esrc, kind="stable")
    out_dst = edst[order].astype(np.int32)
    out_switch = esw[order]
    out_row_ptr = np.zeros(N + 1, dtype=np.int32)
    np.add.at(out_row_ptr, esrc + 1, 1)
    out_row_ptr = np.cumsum(out_row_ptr, dtype=np.int64).astype(np.int32)

    iorder = np.argsort(edst, kind="stable")
    in_src = esrc[iorder].astype(np.int32)
    in_switch = esw[iorder]
    in_row_ptr = np.zeros(N + 1, dtype=np.int32)
    np.add.at(in_row_ptr, edst + 1, 1)
    in_row_ptr = np.cumsum(in_row_ptr, dtype=np.int64).astype(np.int32)

    Rarr = np.array(Rn, dtype=np.float32)
    Carr = np.array(Cn, dtype=np.float32)
    in_dst_sorted = edst[iorder]
    in_delay = (switch_Tdel[in_switch.astype(np.int64)]
                + Carr[in_dst_sorted]
                * (switch_R[in_switch.astype(np.int64)]
                   + 0.5 * Rarr[in_dst_sorted])).astype(np.float32)

    # ---- base costs (rr_graph_indexed_data.c semantics, simplified) ----
    cost_index = np.array(cidx, dtype=np.int8)
    base_cost = np.ones(N, dtype=np.float32)
    base_cost[node_type == IPIN] = 0.95
    base_cost[node_type == SINK] = 0.0

    return RRGraph(
        node_type=node_type, xlow=xlow, ylow=ylow, xhigh=xhigh, yhigh=yhigh,
        ptc=np.array(ptc, dtype=np.int32),
        capacity=np.array(cap, dtype=np.int16),
        R=Rarr, C=Carr, cost_index=cost_index, base_cost=base_cost,
        out_row_ptr=out_row_ptr, out_dst=out_dst, out_switch=out_switch,
        in_row_ptr=in_row_ptr, in_src=in_src, in_switch=in_switch,
        in_delay=in_delay,
        src_of=src_of, sink_of=sink_of, opin_of=opin_of, ipin_of=ipin_of,
        grid=grid, chan_width=W,
        switch_Tdel=switch_Tdel, switch_R=switch_R,
        seg_of_track=seg_of_track.astype(np.int32),
        wire_switch_of_track=np.array(
            [arch.segments[s].wire_switch for s in seg_of_track],
            dtype=np.int32),
        dir_of_track=(np.arange(W, dtype=np.int32) % 2) if unidir
        else None,
    )


_LEGAL_EDGES = {
    SOURCE: {OPIN},
    OPIN: {CHANX, CHANY, IPIN},      # OPIN->IPIN = direct connection
    IPIN: {SINK},
    CHANX: {CHANX, CHANY, IPIN},
    CHANY: {CHANX, CHANY, IPIN},
    SINK: set(),
}


def check_rr_graph(rr: RRGraph, reachability: bool = True) -> None:
    """Graph sanity checker (vpr/SRC/route/check_rr_graph.c equivalent).
    Raises AssertionError on any violation."""
    N, E = rr.num_nodes, rr.num_edges
    assert rr.out_row_ptr[0] == 0 and rr.out_row_ptr[-1] == E
    assert rr.in_row_ptr[0] == 0 and rr.in_row_ptr[-1] == E
    assert np.all(rr.out_dst >= 0) and np.all(rr.out_dst < N)
    assert np.all(rr.in_src >= 0) and np.all(rr.in_src < N)

    # type-legal edges, no self loops (vectorized over ALL edges)
    src_ids = np.repeat(np.arange(N), np.diff(rr.out_row_ptr))
    assert not np.any(src_ids == rr.out_dst), "self edge"
    pair_codes = np.unique(rr.node_type[src_ids].astype(np.int64) * 6
                           + rr.node_type[rr.out_dst])
    for code in pair_codes:
        s_t, d_t = int(code) // 6, int(code) % 6
        assert d_t in _LEGAL_EDGES[s_t], \
            f"illegal edge {RR_TYPE_NAMES[s_t]}->{RR_TYPE_NAMES[d_t]}"

    # out/in CSR hold the same multiset of edges
    a = np.stack([src_ids, rr.out_dst.astype(np.int64)], axis=1)
    dst_ids = np.repeat(np.arange(N), np.diff(rr.in_row_ptr))
    b = np.stack([rr.in_src.astype(np.int64), dst_ids], axis=1)
    a = a[np.lexsort((a[:, 1], a[:, 0]))]
    b = b[np.lexsort((b[:, 1], b[:, 0]))]
    assert np.array_equal(a, b), "in/out CSR mismatch"

    # every OPIN drives a wire; every IPIN is driven by a wire
    out_deg = np.diff(rr.out_row_ptr)
    in_deg = np.diff(rr.in_row_ptr)
    opins = rr.node_type == OPIN
    assert np.all(out_deg[opins] >= 1), "dead OPIN"
    ipins = rr.node_type == IPIN
    assert np.all(in_deg[ipins] >= 1), "dead IPIN (no driving wire)"
    assert np.all(out_deg[rr.node_type == SINK] == 0)
    assert np.all(in_deg[rr.node_type == SOURCE] == 0)

    if reachability and N <= 200000:
        # all SINKs reachable from the union of SOURCEs (frontier sweep)
        reach = rr.node_type == SOURCE
        frontier = reach.copy()
        while frontier.any():
            nxt = np.zeros(N, dtype=bool)
            fsrc = np.where(frontier)[0]
            for s in fsrc:
                d = rr.out_dst[rr.out_row_ptr[s]:rr.out_row_ptr[s + 1]]
                nxt[d] = True
            frontier = nxt & ~reach
            reach |= frontier
        sinks = rr.node_type == SINK
        assert np.all(reach[sinks]), \
            f"{int((~reach[sinks]).sum())} unreachable SINKs"
