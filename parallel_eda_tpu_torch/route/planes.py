"""Planes relaxation router in PyTorch: the counterpart of
parallel_eda_tpu/route/planes.py.

The router state of one net is laid out as dense per-direction wire
grids ("planes"), co-designed with the rr-graph construction's channel structure:

    dx [B, W, NX, NY+1]   the CHANX wire covering (track t, x, y)
    dy [B, W, NX+1, NY]   the CHANY wire covering (track t, x, y)

One relaxation sweep is two min-plus scans along x, the switchbox turn
into y, two scans along y and the turn into x, each carrying the
predecessor cell and the entering-edge delay as payload.  Sweeps repeat
to the exact fixpoint or to a ceiling.  On a CUDA tensor the sweep loop
runs as one launch of a hand-written kernel (planes_kernels.py,
csrc/planes_relax.cu); on a CPU tensor the plain PyTorch version below
runs.  The plain version reproduces the JAX package bit for bit: the
min-plus scan follows ``lax.associative_scan``'s odd/even combine tree
exactly (regrouping the float sums changes bits, and one ulp can tip a
PathFinder tie).

Everything around the relaxation (rip-up, jittered congestion, entry
seeding, sink extraction, traceback, commit, the window loop and the
conflict colouring) is plain tensor code on the caller's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..rr.graph import CHANX, CHANY, IPIN, OPIN, RRGraph
from .device_graph import DeviceRRGraph
from .search import JITTER_EPS, congestion_cost, usage_from_paths

INF = float("inf")
_I32 = torch.int32
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Static plane metadata (host build, once per Router)
# ---------------------------------------------------------------------------


@dataclass
class PlanesGraph:
    """Static per-graph plane layout + masks (tensors on one device).

    Cell space: every (track, x, y) channel position is a cell; a length-L
    wire owns L cells.  chanx cells [W, NX, NY+1] flattened first, then
    chany cells [W, NX+1, NY]; ``ncells`` total."""
    node_of_cell: torch.Tensor      # int32 [Ncells] rr-node id of each cell
    cell_of_node: torch.Tensor      # int32 [N] first cell (non-wire: Ncells)
    brk_before_x: torch.Tensor      # bool [W, NX, NY+1] span-break masks
    brk_after_x: torch.Tensor
    brk_before_y: torch.Tensor      # bool [W, NX+1, NY]
    brk_after_y: torch.Tensor
    first_x: torch.Tensor           # bool: cell is its node's span start
    last_x: torch.Tensor
    first_y: torch.Tensor
    last_y: torch.Tensor
    delay_x: torch.Tensor           # f32 [W, NX, NY+1] enter delay
    delay_y: torch.Tensor           # f32 [W, NX+1, NY]
    delay_y_rot0: torch.Tensor      # f32 [W, NX+1, NY] rotated, parity 0
    delay_y_rot1: torch.Tensor      # f32 [W, NX+1, NY] rotated, parity 1
    directional: bool = False       # unidirectional (single-driver) wires
    inc_track: Optional[torch.Tensor] = None    # bool [W] INC tracks
    max_span: int = 1               # longest wire span (crop margin)

    @property
    def shape_x(self):
        return tuple(self.brk_before_x.shape)       # (W, NX, NY+1)

    @property
    def shape_y(self):
        return tuple(self.brk_before_y.shape)       # (W, NX+1, NY)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape_x) + np.prod(self.shape_y))

    @property
    def device(self) -> torch.device:
        return self.delay_x.device


_PG_FIELDS = {
    "node_of_cell": _I32, "cell_of_node": _I32,
    "brk_before_x": torch.bool, "brk_after_x": torch.bool,
    "brk_before_y": torch.bool, "brk_after_y": torch.bool,
    "first_x": torch.bool, "last_x": torch.bool,
    "first_y": torch.bool, "last_y": torch.bool,
    "delay_x": _F32, "delay_y": _F32,
    "delay_y_rot0": _F32, "delay_y_rot1": _F32,
}


def planes_graph_from_numpy(fields: dict, device) -> PlanesGraph:
    """Build from numpy arrays keyed by field name (a PlanesGraph of
    either package, as ``{name: np.asarray(getattr(pg, name))}``), plus
    the statics ``directional``, ``inc_track`` (None unless directional)
    and ``max_span``."""
    t = {k: torch.from_numpy(np.array(fields[k])).to(device=device,
                                                      dtype=dt)
         for k, dt in _PG_FIELDS.items()}
    inc = fields.get("inc_track")
    return PlanesGraph(
        **t, directional=bool(fields.get("directional", False)),
        inc_track=(None if inc is None else torch.from_numpy(
            np.array(inc)).to(device=device, dtype=torch.bool)),
        max_span=int(fields.get("max_span", 1)))


def _cover_cells(ids, t, lo, hi, fixed, horizontal, W, NX, NY):
    """Flat cell indices covered by wire spans (vectorized arange trick)."""
    reps = (hi - lo + 1).astype(np.int64)
    total = int(reps.sum())
    node_rep = np.repeat(ids, reps)
    t_rep = np.repeat(t, reps).astype(np.int64)
    f_rep = np.repeat(fixed, reps).astype(np.int64)
    starts = np.repeat(np.cumsum(reps) - reps, reps)
    pos = np.repeat(lo, reps).astype(np.int64) + (np.arange(total) - starts)
    if horizontal:      # chanx: (t, x=pos in 1..NX, y=fixed in 0..NY)
        cell = (t_rep * NX + (pos - 1)) * (NY + 1) + f_rep
    else:               # chany: (t, x=fixed in 0..NX, y=pos in 1..NY)
        cell = (t_rep * (NX + 1) + f_rep) * NY + (pos - 1)
    return node_rep, cell


def build_planes(rr: RRGraph, device) -> PlanesGraph:
    """Derive the plane layout from a built RRGraph (needs the graph construction's
    per-track switch map, rr.wire_switch_of_track)."""
    if rr.wire_switch_of_track is None:
        raise ValueError("planes need rr.wire_switch_of_track "
                         "(graph not built by rr.graph.build_rr_graph)")
    W = rr.chan_width
    NX, NY = rr.grid.nx, rr.grid.ny
    N = rr.num_nodes
    ncx = W * NX * (NY + 1)
    ncy = W * (NX + 1) * NY
    ncells = ncx + ncy

    node_of_cell = np.full(ncells, N, dtype=np.int64)
    is_x = rr.node_type == CHANX
    is_y = rr.node_type == CHANY
    idx = np.where(is_x)[0]
    nrep, cell = _cover_cells(idx, rr.ptc[idx], rr.xlow[idx], rr.xhigh[idx],
                              rr.ylow[idx], True, W, NX, NY)
    node_of_cell[cell] = nrep
    idy = np.where(is_y)[0]
    nrep, cell = _cover_cells(idy, rr.ptc[idy], rr.ylow[idy], rr.yhigh[idy],
                              rr.xlow[idy], False, W, NX, NY)
    node_of_cell[ncx + cell] = nrep
    assert (node_of_cell < N).all(), "uncovered channel cell"

    cell_of_node = np.full(N + 1, ncells, dtype=np.int64)
    # first covered cell of each node (reverse write keeps the lowest)
    order = np.arange(ncells - 1, -1, -1)
    cell_of_node[node_of_cell[order]] = order
    cell_of_node = cell_of_node[:N]

    nx_pl = node_of_cell[:ncx].reshape(W, NX, NY + 1)
    ny_pl = node_of_cell[ncx:].reshape(W, NX + 1, NY)

    def breaks(pl, axis):
        d = np.diff(pl, axis=axis) != 0
        pad = np.ones(tuple(1 if a == axis else s
                            for a, s in enumerate(pl.shape)), dtype=bool)
        return (np.concatenate([pad, d], axis=axis),
                np.concatenate([d, pad], axis=axis))

    brk_before_x, brk_after_x = breaks(nx_pl, 1)
    brk_before_y, brk_after_y = breaks(ny_pl, 2)

    xcoord = np.arange(1, NX + 1)[None, :, None]
    ycoord = np.arange(1, NY + 1)[None, None, :]

    # enter-delay planes: Tdel[sw] + C[node]*(R[sw] + R[node]/2) — the
    # exact in_delay formula of the graph construction (rr/graph.py in_delay)
    def enter_delay(pl, sw_of_t):
        tdel = rr.switch_Tdel[sw_of_t][:, None, None]
        rs = rr.switch_R[sw_of_t][:, None, None]
        return (tdel + rr.C[pl] * (rs + 0.5 * rr.R[pl])).astype(np.float32)

    swt = rr.wire_switch_of_track.astype(np.int64)
    rot0 = swt[(np.arange(W) - 1) % W]       # parity 0: src = (t-1) mod W
    rot1 = swt[(np.arange(W) - 2) % W]       # parity 1: src = (t-2) mod W
    return planes_graph_from_numpy(dict(
        node_of_cell=node_of_cell, cell_of_node=cell_of_node,
        brk_before_x=brk_before_x, brk_after_x=brk_after_x,
        brk_before_y=brk_before_y, brk_after_y=brk_after_y,
        first_x=rr.xlow[nx_pl] == xcoord, last_x=rr.xhigh[nx_pl] == xcoord,
        first_y=rr.ylow[ny_pl] == ycoord, last_y=rr.yhigh[ny_pl] == ycoord,
        delay_x=enter_delay(nx_pl, swt), delay_y=enter_delay(ny_pl, swt),
        delay_y_rot0=enter_delay(ny_pl, rot0),
        delay_y_rot1=enter_delay(ny_pl, rot1),
        directional=rr.unidir,
        inc_track=(rr.dir_of_track == 0) if rr.unidir else None,
        max_span=int(max(
            (rr.xhigh[is_x] - rr.xlow[is_x] + 1).max(initial=1),
            (rr.yhigh[is_y] - rr.ylow[is_y] + 1).max(initial=1)))),
        device)


# ---------------------------------------------------------------------------
# Per-route-call terminal tables (host numpy; exact edge enumeration)
# ---------------------------------------------------------------------------


@dataclass
class PlanesTerminals:
    """Per-net terminal entry tables (host numpy; see the JAX package's
    PlanesTerminals for the factorized sink-table layout)."""
    opin_node: np.ndarray       # int32 [R, O] source-class OPINs (pad N)
    entry_cell: np.ndarray      # int32 [R, Ko] wire cell (pad Ncells)
    entry_oidx: np.ndarray      # int32 [R, Ko] index into opin_node (pad 0)
    entry_delay: np.ndarray     # f32  [R, Ko] edge delay OPIN -> wire
    sink_uid: np.ndarray        # int32 [R, S] unique-sink row (pad U)
    uid_cell: np.ndarray        # int32 [U+1, K] wire cell (pad Ncells)
    uid_ipin: np.ndarray        # int32 [U+1, K] IPIN node (pad N)
    uid_delay: np.ndarray       # f32  [U+1, K] delay wire->IPIN->SINK
    direct_oidx: np.ndarray     # int32 [R, S] index into opin_node / -1
    direct_ipin: np.ndarray     # int32 [R, S] IPIN node (pad N)
    direct_delay: np.ndarray    # f32  [R, S] OPIN->IPIN->SINK delay

    def tables(self):
        """The 11 arrays in the order _step_core takes them."""
        return (self.opin_node, self.entry_cell, self.entry_oidx,
                self.entry_delay, self.sink_uid, self.uid_cell,
                self.uid_ipin, self.uid_delay, self.direct_oidx,
                self.direct_ipin, self.direct_delay)


def _ragged_flat(row_ptr: np.ndarray, nodes: np.ndarray):
    """Flatten the CSR slices row_ptr[n]:row_ptr[n+1] for every n in
    ``nodes``: (edge_idx [T], owner [T]) with owner nondecreasing."""
    deg = row_ptr[nodes + 1] - row_ptr[nodes]
    tot = int(deg.sum())
    owner = np.repeat(np.arange(len(nodes)), deg)
    off = np.arange(tot) - np.repeat(np.cumsum(deg) - deg, deg)
    return np.repeat(row_ptr[nodes], deg) + off, owner


def _within(owner: np.ndarray, n_owners: int):
    """Running index of each element within its (nondecreasing) owner."""
    cnt = np.bincount(owner, minlength=n_owners)
    return (np.arange(len(owner))
            - np.repeat(np.cumsum(cnt) - cnt, cnt)), cnt


def build_planes_terminals(rr: RRGraph, source: np.ndarray,
                           sinks: np.ndarray, cell_of_node: np.ndarray,
                           ncells: int) -> PlanesTerminals:
    """source [R], sinks [R, S] (-1 pad) -> terminal tables; ``ncells``
    is the pad value (one past the last real cell).  Candidate order is
    the graph's edge order, so routing stays bit-deterministic."""
    R = len(source)
    S = sinks.shape[1]
    N = rr.num_nodes

    orp, odst, osw = rr.out_row_ptr, rr.out_dst, rr.out_switch
    irp, isrc, idel = rr.in_row_ptr, rr.in_src, rr.in_delay
    src = np.asarray(source, dtype=np.int64)

    # --- SOURCE side: net -> OPINs -> wire entries ---
    e1, net_of_op = _ragged_flat(orp, src)
    op_nodes = odst[e1].astype(np.int64)
    oi_of_op, deg_o = _within(net_of_op, R)
    O = max(1, int(deg_o.max()) if R else 1)
    opin_node = np.full((R, O), N, dtype=np.int32)
    opin_node[net_of_op, oi_of_op] = op_nodes

    e2, op_of_e = _ragged_flat(orp, op_nodes)
    wires = odst[e2].astype(np.int64)
    esw = osw[e2].astype(np.int64)
    edel = (rr.switch_Tdel[esw] + rr.C[wires]
            * (rr.switch_R[esw] + 0.5 * rr.R[wires])).astype(np.float32)
    net_of_e = net_of_op[op_of_e]
    ki, ent_cnt = _within(net_of_e, R)
    Ko = max(1, int(ent_cnt.max()) if R else 1)
    entry_cell = np.full((R, Ko), ncells, dtype=np.int32)
    entry_oidx = np.zeros((R, Ko), dtype=np.int32)
    entry_delay = np.zeros((R, Ko), dtype=np.float32)
    entry_cell[net_of_e, ki] = cell_of_node[wires]
    entry_oidx[net_of_e, ki] = oi_of_op[op_of_e]
    entry_delay[net_of_e, ki] = edel

    # --- SINK side: unique sink nodes -> IPINs -> wire candidates ---
    sk_flat = sinks.reshape(-1).astype(np.int64)
    valid = sk_flat >= 0
    uniq, inv = np.unique(sk_flat[valid], return_inverse=True)
    U = len(uniq)
    f1, u_of_1 = _ragged_flat(irp, uniq)
    ipins = isrc[f1].astype(np.int64)
    w1 = idel[f1].astype(np.float64)
    f2, p_of_2 = _ragged_flat(irp, ipins)
    wires2 = isrc[f2].astype(np.int64)
    wtot = (w1[p_of_2] + idel[f2]).astype(np.float32)
    u_of_2 = u_of_1[p_of_2]
    k2, cand_cnt = _within(u_of_2, U)
    K = max(1, int(cand_cnt.max()) if U else 1)
    u_cell = np.full((U + 1, K), ncells, dtype=np.int32)
    u_ipin = np.full((U + 1, K), N, dtype=np.int32)
    u_del = np.zeros((U + 1, K), dtype=np.float32)
    u_cell[u_of_2, k2] = cell_of_node[wires2]
    u_ipin[u_of_2, k2] = ipins[p_of_2]
    u_del[u_of_2, k2] = wtot

    sink_uid = np.full(R * S, U, dtype=np.int32)
    sink_uid[valid] = inv.astype(np.int32)

    # --- direct connections: OPIN -> IPIN -> SINK candidates ---
    direct_oidx = np.full((R, S), -1, dtype=np.int32)
    direct_ipin = np.full((R, S), N, dtype=np.int32)
    direct_delay = np.zeros((R, S), dtype=np.float32)
    ntype = rr.node_type
    e_is_direct = ((ntype[odst] == IPIN)
                   & (ntype.repeat(np.diff(orp))[...] == OPIN)
                   if len(odst) else np.zeros(0, bool))
    if e_is_direct.any():
        opin_owner: dict = {}
        for r, oi in np.argwhere(opin_node < N):
            opin_owner.setdefault(int(opin_node[r, oi]),
                                  []).append((int(r), int(oi)))
        sink_slots: dict = {}
        for r, s in np.argwhere(sinks >= 0):
            sink_slots.setdefault(int(sinks[r, s]),
                                  []).append((int(r), int(s)))
        e_src_all = np.repeat(np.arange(N), np.diff(orp))
        for e in np.where(e_is_direct)[0]:
            o, ip = int(e_src_all[e]), int(odst[e])
            if o not in opin_owner:
                continue
            esw1 = int(rr.out_switch[e])
            d1 = (rr.switch_Tdel[esw1] + rr.C[ip]
                  * (rr.switch_R[esw1] + 0.5 * rr.R[ip]))
            for e2b in range(orp[ip], orp[ip + 1]):
                snk = int(odst[e2b])
                if snk not in sink_slots:
                    continue
                sw2 = int(rr.out_switch[e2b])
                d2 = (rr.switch_Tdel[sw2] + rr.C[snk]
                      * (rr.switch_R[sw2] + 0.5 * rr.R[snk]))
                for (r, s) in sink_slots[snk]:
                    for (ro, oi) in opin_owner[o]:
                        if ro != r:
                            continue
                        dd = np.float32(d1 + d2)
                        if (direct_oidx[r, s] < 0
                                or dd < direct_delay[r, s]):
                            direct_oidx[r, s] = oi
                            direct_ipin[r, s] = ip
                            direct_delay[r, s] = dd
    return PlanesTerminals(opin_node, entry_cell, entry_oidx, entry_delay,
                           sink_uid.reshape(R, S), u_cell, u_ipin, u_del,
                           direct_oidx, direct_ipin, direct_delay)


# ---------------------------------------------------------------------------
# The relaxation: min-plus scans + turn shifts, with (pred, wenter) payload
# ---------------------------------------------------------------------------


def _sl(nd: int, axis: int, s: slice):
    return (slice(None),) * axis + (s,)


def _assoc_scan(c, m, axis: int):
    """The min-plus pair scan in ``lax.associative_scan``'s exact
    combine order: pairwise reduce, recurse on the half, fill the evens,
    interleave.  combine((c1, m1), (c2, m2)) = (c1 + c2, min(m1 + c2, m2))."""
    n = c.shape[axis]
    if n < 2:
        return c, m
    nd = c.ndim

    def comb(ca, ma, cb, mb):
        return ca + cb, torch.minimum(ma + cb, mb)

    ev = _sl(nd, axis, slice(0, n - 1, 2))
    od = _sl(nd, axis, slice(1, None, 2))
    rc, rm = comb(c[ev], m[ev], c[od], m[od])
    oc, om = _assoc_scan(rc, rm, axis)
    e2 = _sl(nd, axis, slice(2, None, 2))
    if n % 2 == 0:
        head = _sl(nd, axis, slice(0, -1))
        ec, em = comb(oc[head], om[head], c[e2], m[e2])
    else:
        ec, em = comb(oc, om, c[e2], m[e2])
    first = _sl(nd, axis, slice(0, 1))
    ec = torch.cat([c[first], ec], dim=axis)
    em = torch.cat([m[first], em], dim=axis)
    out_c = torch.empty_like(c)
    out_m = torch.empty_like(m)
    out_c[_sl(nd, axis, slice(0, None, 2))] = ec
    out_c[_sl(nd, axis, slice(1, None, 2))] = oc
    out_m[_sl(nd, axis, slice(0, None, 2))] = em
    out_m[_sl(nd, axis, slice(1, None, 2))] = om
    return out_c, out_m


def _minplus_scan(d0, c, axis: int, reverse: bool = False):
    """s[x] = min(d0[x], s[x-1] + c[x]) along axis (reverse: x+1 side),
    bit-identical to the JAX package's associative-scan version."""
    if reverse:
        d0 = torch.flip(d0, (axis,))
        c = torch.flip(c, (axis,))
    _, s = _assoc_scan(c, d0, axis)
    if reverse:
        s = torch.flip(s, (axis,))
    return s


def _scan_update(d, pred, w, cstep, wstep, self_idx, stride, axis,
                 reverse):
    """One directional scan folded into (dist, pred, wenter): improved
    cells point at the immediate neighbour in the scan direction."""
    s = _minplus_scan(d, cstep, axis, reverse)
    imp = s < d
    nb = self_idx + (stride if reverse else -stride)
    return (torch.where(imp, s, d), torch.where(imp, nb, pred),
            torch.where(imp, wstep, w))


@dataclass
class PlanesGeom:
    """Sweep-body geometry with a leading broadcast axis G: G == 1 (the
    whole grid, shared) or G == B (per-net bb-cropped tiles).  idxx/idxy
    carry GLOBAL flat cell ids and base_par the GLOBAL corner parity, so
    pred payloads and rotated-turn parity survive cropping."""
    brk_before_x: torch.Tensor      # [G, W, X, Y+1] (crop-local X/Y)
    brk_after_x: torch.Tensor
    brk_before_y: torch.Tensor      # [G, W, X+1, Y]
    brk_after_y: torch.Tensor
    first_x: torch.Tensor
    last_x: torch.Tensor
    first_y: torch.Tensor
    last_y: torch.Tensor
    delay_x: torch.Tensor
    delay_y: torch.Tensor
    delay_y_rot0: torch.Tensor
    delay_y_rot1: torch.Tensor
    idxx: torch.Tensor              # int32 [G, W, X, Y+1] global ids
    idxy: torch.Tensor              # int32 [G, W, X+1, Y]
    base_par: torch.Tensor          # int32 [G, X+1, Y+1] global (x+y)%2
    stride_x: int = 0               # global NY+1
    directional: bool = False
    inc_track: Optional[torch.Tensor] = None     # bool [W] (shared)

    @property
    def shape_x(self):
        return tuple(self.brk_before_x.shape[1:])

    @property
    def shape_y(self):
        return tuple(self.brk_before_y.shape[1:])


_GEOM_ARRAYS = ("brk_before_x", "brk_after_x", "brk_before_y",
                "brk_after_y", "first_x", "last_x", "first_y", "last_y",
                "delay_x", "delay_y", "delay_y_rot0", "delay_y_rot1")


def geom_full(pg: PlanesGraph) -> PlanesGeom:
    """The G=1 shared geometry of the whole grid (views, no copies)."""
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    ncx = W * NX * NYp1
    dev = pg.device
    idxx = torch.arange(ncx, dtype=_I32, device=dev).reshape(1, W, NX, NYp1)
    idxy = (ncx + torch.arange(W * NXp1 * NY, dtype=_I32, device=dev)
            ).reshape(1, W, NXp1, NY)
    base_par = ((torch.arange(NX + 1, device=dev)[:, None]
                 + torch.arange(NY + 1, device=dev)[None, :]) % 2
                ).to(_I32)[None]
    return PlanesGeom(
        **{k: getattr(pg, k)[None] for k in _GEOM_ARRAYS},
        idxx=idxx, idxy=idxy, base_par=base_par, stride_x=NYp1,
        directional=pg.directional, inc_track=pg.inc_track)


def _crop_index(o, size: int, extent: int):
    """Per-net index rows o[b] + arange(size), with the origin clamped
    into [0, extent - size] as lax.dynamic_slice clamps its start."""
    o = torch.clamp(o.long(), 0, extent - size)
    return o[:, None] + torch.arange(size, device=o.device)[None, :]


def crop_origin_hi(pg: PlanesGraph, cnx: int, cny: int):
    """The largest origin (x, y) of a (cnx, cny) tile.  One clamp range
    serves every array of the cropped relaxation: chanx [NX, NY+1] cut at
    (cnx, cny+1), chany [NX+1, NY] at (cnx+1, cny) and the corner parity
    [NX+1, NY+1] at (cnx+1, cny+1) all clamp x into [0, NX-cnx] and y
    into [0, NY-cny], so K2 clamps each net's origin once, in the
    kernel."""
    _, NX, NYp1 = pg.shape_x
    return NX - cnx, NYp1 - 1 - cny


def _crop3(a, xi, yi):
    """a [W, X, Y] (shared) -> [B, W, xs, ys] at per-net rows xi/yi."""
    t = a[:, xi[:, :, None], yi[:, None, :]]        # [W, B, xs, ys]
    return t.permute(1, 0, 2, 3).contiguous()


def geom_cropped(pg: PlanesGraph, ox, oy, cnx: int, cny: int,
                 full: Optional[PlanesGeom] = None) -> PlanesGeom:
    """Per-net cropped geometry: net b's tile starts at grid cell
    (ox[b], oy[b]) and spans a static (cnx, cny) tile.  Exact iff every
    wire a net may use lies inside its tile (callers expand the bb by
    the longest wire span and clamp to the grid)."""
    full = full if full is not None else geom_full(pg)
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y

    def crop(a, xs, ys):
        return _crop3(a[0], _crop_index(ox, xs, a.shape[2]),
                      _crop_index(oy, ys, a.shape[3]))

    def crop_x(a):
        return crop(a, cnx, cny + 1)

    def crop_y(a):
        return crop(a, cnx + 1, cny)

    bp = full.base_par[0]
    xi = _crop_index(ox, cnx + 1, bp.shape[0])
    yi = _crop_index(oy, cny + 1, bp.shape[1])
    return PlanesGeom(
        brk_before_x=crop_x(full.brk_before_x),
        brk_after_x=crop_x(full.brk_after_x),
        brk_before_y=crop_y(full.brk_before_y),
        brk_after_y=crop_y(full.brk_after_y),
        first_x=crop_x(full.first_x), last_x=crop_x(full.last_x),
        first_y=crop_y(full.first_y), last_y=crop_y(full.last_y),
        delay_x=crop_x(full.delay_x), delay_y=crop_y(full.delay_y),
        delay_y_rot0=crop_y(full.delay_y_rot0),
        delay_y_rot1=crop_y(full.delay_y_rot1),
        idxx=crop_x(full.idxx), idxy=crop_y(full.idxy),
        base_par=bp[xi[:, :, None], yi[:, None, :]].contiguous(),
        stride_x=NYp1, directional=pg.directional,
        inc_track=pg.inc_track)


def _fold(best, bsrc, bw, cand, src, w):
    better = cand < best
    return (torch.where(better, cand, best), torch.where(better, src, bsrc),
            torch.where(better, w, bw))


def _turn_triples_into_y(gm: PlanesGeom, dx, crit_c, cc_y):
    """Best switchbox-turn candidate INTO each chany cell from dx:
    (value, global source cell, true enter delay), each [B, W, NX+1, NY].
    Target chany (t', x, v) takes chanx cells (x+a, v-b), a,b in {0,1},
    at corner (x, v-b); rotated turns use track (t'-1-parity) mod W."""
    B = dx.shape[0]
    W, NX, NYp1 = gm.shape_x
    NY = NYp1 - 1

    def canvas_x(a, fill):
        c = torch.full((a.shape[0], W, NX + 2, NY + 2), fill,
                       dtype=a.dtype, device=a.device)
        c[:, :, 1:NX + 1, 0:NY + 1] = a
        return c

    ix = canvas_x(gm.idxx, 0)                       # [G, W, NX+2, NY+2]
    best = torch.full((B, W, NX + 1, NY), INF, dtype=_F32, device=dx.device)
    bsrc = torch.zeros((B, W, NX + 1, NY), dtype=_I32, device=dx.device)
    bw = torch.zeros((B, W, NX + 1, NY), dtype=_F32, device=dx.device)

    def sl(a_off, b_off):
        return (slice(None), slice(None), slice(a_off, a_off + NX + 1),
                slice(1 - b_off, 1 - b_off + NY))

    if gm.directional:
        # unidir: source driving end on the corner AND target starts
        # there; all edges use the target's switch (delay_y)
        inc = gm.inc_track[:, None, None]
        src_inc = canvas_x(torch.where(gm.last_x & inc, dx, INF), INF)
        src_dec = canvas_x(torch.where(gm.first_x & ~inc, dx, INF), INF)
        tgt_of_b = (gm.last_y & ~inc, gm.first_y & inc)
        for b_off in (0, 1):
            tgt_gate = tgt_of_b[b_off]
            par = gm.base_par[:, :, 1 - b_off:1 - b_off + NY]
            for a_off in (0, 1):
                src_c = src_inc if a_off == 0 else src_dec
                s = sl(a_off, b_off)
                cand = torch.where(tgt_gate, src_c[s], INF)
                cand = cand + crit_c * gm.delay_y + cc_y
                best, bsrc, bw = _fold(best, bsrc, bw, cand, ix[s],
                                       gm.delay_y)
                for p in (0, 1):
                    if (1 + p) % W == 0:
                        continue
                    r_src = torch.roll(src_c, 1 + p, dims=1)[s]
                    r_i = torch.roll(ix, 1 + p, dims=1)[s]
                    cand = torch.where(tgt_gate, r_src, INF)
                    cand = cand + crit_c * gm.delay_y + cc_y
                    cand = torch.where(par[:, None] == p, cand, INF)
                    best, bsrc, bw = _fold(best, bsrc, bw, cand, r_i,
                                           gm.delay_y)
        return best, bsrc, bw

    cx_all = canvas_x(dx, INF)
    cx_last = canvas_x(torch.where(gm.last_x, dx, INF), INF)
    cx_first = canvas_x(torch.where(gm.first_x, dx, INF), INF)
    for b_off in (0, 1):
        tgt_gate = gm.last_y if b_off == 0 else gm.first_y
        par = gm.base_par[:, :, 1 - b_off:1 - b_off + NY]
        for a_off in (0, 1):
            src_gated = cx_last if a_off == 0 else cx_first
            s = sl(a_off, b_off)
            cand = torch.minimum(src_gated[s],
                                 torch.where(tgt_gate, cx_all[s], INF))
            cand = cand + crit_c * gm.delay_y + cc_y
            best, bsrc, bw = _fold(best, bsrc, bw, cand, ix[s], gm.delay_y)
            for p in (0, 1):
                if (1 + p) % W == 0:
                    continue
                r_all = torch.roll(cx_all, 1 + p, dims=1)[s]
                r_src = torch.roll(src_gated, 1 + p, dims=1)[s]
                r_i = torch.roll(ix, 1 + p, dims=1)[s]
                dly = gm.delay_y_rot0 if p == 0 else gm.delay_y_rot1
                cand = torch.minimum(r_src,
                                     torch.where(tgt_gate, r_all, INF))
                cand = cand + crit_c * dly + cc_y
                cand = torch.where(par[:, None] == p, cand, INF)
                best, bsrc, bw = _fold(best, bsrc, bw, cand, r_i, dly)
    return best, bsrc, bw


def _turn_triples_into_x(gm: PlanesGeom, dy, crit_c, cc_x):
    """Mirror of _turn_triples_into_y: target chanx (t, u, y) takes
    chany cells (u-a, y+b) at corner (u-a, y); rotated source track is
    (t+1+parity) mod W and every turn into chanx uses delay_x."""
    B = dy.shape[0]
    W, NXp1, NY = gm.shape_y
    NX = NXp1 - 1

    def canvas_y(a, fill):
        c = torch.full((a.shape[0], W, NX + 2, NY + 2), fill,
                       dtype=a.dtype, device=a.device)
        c[:, :, 0:NX + 1, 1:NY + 1] = a
        return c

    iy = canvas_y(gm.idxy, 0)
    best = torch.full((B, W, NX, NY + 1), INF, dtype=_F32, device=dy.device)
    bsrc = torch.zeros((B, W, NX, NY + 1), dtype=_I32, device=dy.device)
    bw = torch.zeros((B, W, NX, NY + 1), dtype=_F32, device=dy.device)

    def sl(a_off, b_off):
        return (slice(None), slice(None), slice(1 - a_off, 1 - a_off + NX),
                slice(b_off, b_off + NY + 1))

    if gm.directional:
        inc = gm.inc_track[:, None, None]
        src_inc = canvas_y(torch.where(gm.last_y & inc, dy, INF), INF)
        src_dec = canvas_y(torch.where(gm.first_y & ~inc, dy, INF), INF)
        tgt_of_a = (gm.last_x & ~inc, gm.first_x & inc)
        for a_off in (0, 1):
            tgt_gate = tgt_of_a[a_off]
            par = gm.base_par[:, 1 - a_off:1 - a_off + NX, :]
            for b_off in (0, 1):
                src_c = src_inc if b_off == 0 else src_dec
                s = sl(a_off, b_off)
                cand = torch.where(tgt_gate, src_c[s], INF)
                cand = cand + crit_c * gm.delay_x + cc_x
                best, bsrc, bw = _fold(best, bsrc, bw, cand, iy[s],
                                       gm.delay_x)
                for p in (0, 1):
                    if (1 + p) % W == 0:
                        continue
                    r_src = torch.roll(src_c, -(1 + p), dims=1)[s]
                    r_i = torch.roll(iy, -(1 + p), dims=1)[s]
                    cand = torch.where(tgt_gate, r_src, INF)
                    cand = cand + crit_c * gm.delay_x + cc_x
                    cand = torch.where(par[:, None] == p, cand, INF)
                    best, bsrc, bw = _fold(best, bsrc, bw, cand, r_i,
                                           gm.delay_x)
        return best, bsrc, bw

    cy_all = canvas_y(dy, INF)
    cy_last = canvas_y(torch.where(gm.last_y, dy, INF), INF)
    cy_first = canvas_y(torch.where(gm.first_y, dy, INF), INF)
    for a_off in (0, 1):
        tgt_gate = gm.last_x if a_off == 0 else gm.first_x
        par = gm.base_par[:, 1 - a_off:1 - a_off + NX, :]
        for b_off in (0, 1):
            src_gated = cy_last if b_off == 0 else cy_first
            s = sl(a_off, b_off)
            cand = torch.minimum(src_gated[s],
                                 torch.where(tgt_gate, cy_all[s], INF))
            cand = cand + crit_c * gm.delay_x + cc_x
            best, bsrc, bw = _fold(best, bsrc, bw, cand, iy[s], gm.delay_x)
            for p in (0, 1):
                if (1 + p) % W == 0:
                    continue
                r_all = torch.roll(cy_all, -(1 + p), dims=1)[s]
                r_src = torch.roll(src_gated, -(1 + p), dims=1)[s]
                r_i = torch.roll(iy, -(1 + p), dims=1)[s]
                cand = torch.minimum(r_src,
                                     torch.where(tgt_gate, r_all, INF))
                cand = cand + crit_c * gm.delay_x + cc_x
                cand = torch.where(par[:, None] == p, cand, INF)
                best, bsrc, bw = _fold(best, bsrc, bw, cand, r_i,
                                       gm.delay_x)
    return best, bsrc, bw


def _sweep_costs(gm: PlanesGeom, crit_c, cc_x, cc_y):
    """Scan step costs: switch delay + congestion only at span breaks.
    Unidir: a forward scan crosses a break only on INC tracks, a
    backward scan only on DEC tracks (INF otherwise)."""
    cost_x = crit_c * gm.delay_x + cc_x
    cost_y = crit_c * gm.delay_y + cc_y
    if gm.directional:
        inc = gm.inc_track[:, None, None]
        cfx = torch.where(gm.brk_before_x, torch.where(inc, cost_x, INF),
                          0.0)
        cbx = torch.where(gm.brk_after_x, torch.where(inc, INF, cost_x),
                          0.0)
        cfy = torch.where(gm.brk_before_y, torch.where(inc, cost_y, INF),
                          0.0)
        cby = torch.where(gm.brk_after_y, torch.where(inc, INF, cost_y),
                          0.0)
    else:
        cfx = torch.where(gm.brk_before_x, cost_x, 0.0)
        cbx = torch.where(gm.brk_after_x, cost_x, 0.0)
        cfy = torch.where(gm.brk_before_y, cost_y, 0.0)
        cby = torch.where(gm.brk_after_y, cost_y, 0.0)
    wfx = torch.where(gm.brk_before_x, gm.delay_x, 0.0)
    wbx = torch.where(gm.brk_after_x, gm.delay_x, 0.0)
    wfy = torch.where(gm.brk_before_y, gm.delay_y, 0.0)
    wby = torch.where(gm.brk_after_y, gm.delay_y, 0.0)
    return cfx, cbx, cfy, cby, wfx, wbx, wfy, wby


def _sweep_once(gm: PlanesGeom, s, crit_c, cc_x, cc_y, costs):
    """One relaxation sweep (2 x-scans, turn into y, 2 y-scans, turn
    into x) over the (dist, pred, wenter) state.  Scan-neighbour strides
    are GLOBAL flat-index strides, so pred stays in global cell ids."""
    cfx, cbx, cfy, cby, wfx, wbx, wfy, wby = costs
    dx, dy, predx, predy, wx, wy = s
    dx, predx, wx = _scan_update(dx, predx, wx, cfx, wfx, gm.idxx,
                                 gm.stride_x, 2, False)
    dx, predx, wx = _scan_update(dx, predx, wx, cbx, wbx, gm.idxx,
                                 gm.stride_x, 2, True)
    tv, ts, tw = _turn_triples_into_y(gm, dx, crit_c, cc_y)
    imp = tv < dy
    dy = torch.where(imp, tv, dy)
    predy = torch.where(imp, ts, predy)
    wy = torch.where(imp, tw, wy)
    dy, predy, wy = _scan_update(dy, predy, wy, cfy, wfy, gm.idxy,
                                 1, 3, False)
    dy, predy, wy = _scan_update(dy, predy, wy, cby, wby, gm.idxy,
                                 1, 3, True)
    tv, ts, tw = _turn_triples_into_x(gm, dy, crit_c, cc_x)
    imp = tv < dx
    dx = torch.where(imp, tv, dx)
    predx = torch.where(imp, ts, predx)
    wx = torch.where(imp, tw, wx)
    return dx, dy, predx, predy, wx, wy


def _run_relax(sweep_fn, state0, nsweeps: int):
    """Run ``sweep_fn`` to the fixpoint or ``nsweeps`` times, whichever
    comes first.  Updates are strict improvements of a monotone state,
    so "no distance improved" is an exact fixpoint test.  Returns
    (state, stats) with stats = int32[2] (sweeps executed, sweeps that
    improved some distance)."""
    i, go, s = 0, True, state0
    while go and i < nsweeps:
        s2 = sweep_fn(s)
        go = bool(((s2[0] < s[0]).any() | (s2[1] < s[1]).any()).item())
        s = s2
        i += 1
    useful = max(0, i - (0 if go else 1))
    return s, torch.tensor([i, useful], dtype=_I32)


def _split_flat(pg: PlanesGraph, a):
    B = a.shape[0]
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    ncx = W * NX * NYp1
    return (a[:, :ncx].reshape(B, W, NX, NYp1),
            a[:, ncx:].reshape(B, W, NXp1, NY))


def _flat(a, b):
    B = a.shape[0]
    return torch.cat([a.reshape(B, -1), b.reshape(B, -1)], dim=1)


def planes_relax_plain(pg: PlanesGraph, d0_flat, cc_flat, crit_c, wenter0,
                       nsweeps: int):
    """The plain PyTorch version of the full-canvas relaxation (any
    device): d0_flat/cc_flat/wenter0 [B, Ncells] f32, crit_c [B,1,1,1].
    Returns (dist, pred, wenter, stats) — dist/wenter f32 and pred int32
    [B, Ncells] (global cell ids), stats int32[2]."""
    dx, dy = _split_flat(pg, d0_flat)
    cc_x, cc_y = _split_flat(pg, cc_flat)
    wx, wy = _split_flat(pg, wenter0)
    gm = geom_full(pg)
    predx = gm.idxx.expand(dx.shape)
    predy = gm.idxy.expand(dy.shape)
    costs = _sweep_costs(gm, crit_c, cc_x, cc_y)
    (dx, dy, predx, predy, wx, wy), stats = _run_relax(
        lambda s: _sweep_once(gm, s, crit_c, cc_x, cc_y, costs),
        (dx, dy, predx, predy, wx, wy), nsweeps)
    return (_flat(dx, dy), _flat(predx, predy), _flat(wx, wy),
            stats.to(d0_flat.device))


def crop_state(pg: PlanesGraph, d0_flat, cc_flat, wenter0, ox, oy,
               cnx: int, cny: int):
    """Reshape the [B, Ncells] flats into canvases and slice each net's
    (cnx, cny) tile at its (clamped) origin.  Returns (full canvases
    (dxf, dyf, wxf, wyf), tiles (dx, dy, ccx, ccy, wx, wy))."""
    dxf, dyf = _split_flat(pg, d0_flat)
    ccxf, ccyf = _split_flat(pg, cc_flat)
    wxf, wyf = _split_flat(pg, wenter0)

    def crop4(a, xs, ys):
        xi = _crop_index(ox, xs, a.shape[2])
        yi = _crop_index(oy, ys, a.shape[3])
        b = torch.arange(a.shape[0], device=a.device)
        t = a.permute(0, 2, 3, 1)[b[:, None, None], xi[:, :, None],
                                  yi[:, None, :]]       # [B, xs, ys, W]
        return t.permute(0, 3, 1, 2).contiguous()

    return ((dxf, dyf, wxf, wyf),
            (crop4(dxf, cnx, cny + 1), crop4(dyf, cnx + 1, cny),
             crop4(ccxf, cnx, cny + 1), crop4(ccyf, cnx + 1, cny),
             crop4(wxf, cnx, cny + 1), crop4(wyf, cnx + 1, cny)))


def scatter_state(gm_full: PlanesGeom, fulls, tiles, ox, oy):
    """Write each net's relaxed tile back into its full canvases (cells
    outside the tile keep d0 / self-pred / wenter0) and flatten to the
    (dist, pred, wenter) flats."""
    dxf, dyf, wxf, wyf = fulls
    dx, dy, predx, predy, wx, wy = tiles

    def put(full, tile):
        out = full.clone()
        xi = _crop_index(ox, tile.shape[2], full.shape[2])
        yi = _crop_index(oy, tile.shape[3], full.shape[3])
        b = torch.arange(full.shape[0], device=full.device)
        v = out.permute(0, 2, 3, 1)
        v[b[:, None, None], xi[:, :, None], yi[:, None, :]] = \
            tile.permute(0, 2, 3, 1)
        return out

    idxx_f = gm_full.idxx.expand(dxf.shape)
    idxy_f = gm_full.idxy.expand(dyf.shape)
    return (_flat(put(dxf, dx), put(dyf, dy)),
            _flat(put(idxx_f, predx), put(idxy_f, predy)),
            _flat(put(wxf, wx), put(wyf, wy)))


def fold_canvas(a, pad_y: int = 0):
    """[B, ..., Y] -> [B, prod(...) * (Y + pad_y)]: pad the trailing
    axis with storage-only columns, then flatten each net to one row."""
    if pad_y:
        a = torch.nn.functional.pad(a, (0, pad_y))
    return a.reshape(a.shape[0], -1)


def unfold_canvas(a2, shape, pad_y: int = 0):
    """Inverse of fold_canvas: [B, row] -> [B, *shape], pad dropped."""
    B = a2.shape[0]
    padded = tuple(shape[:-1]) + (shape[-1] + pad_y,)
    a = a2.reshape((B,) + padded)
    return a[..., :shape[-1]] if pad_y else a


def planes_relax_cropped_plain(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                               wenter0, nsweeps: int, ox, oy,
                               cnx: int, cny: int):
    """The plain PyTorch version of the cropped relaxation (any
    device): net b sweeps only the tile at grid cell (ox[b], oy[b]).
    Same returns as planes_relax_plain."""
    gm_full = geom_full(pg)
    gm = geom_cropped(pg, ox, oy, cnx, cny, full=gm_full)
    fulls, (dx, dy, cc_x, cc_y, wx, wy) = crop_state(
        pg, d0_flat, cc_flat, wenter0, ox, oy, cnx, cny)
    predx = gm.idxx.expand(dx.shape)
    predy = gm.idxy.expand(dy.shape)
    costs = _sweep_costs(gm, crit_c, cc_x, cc_y)
    tiles, stats = _run_relax(
        lambda s: _sweep_once(gm, s, crit_c, cc_x, cc_y, costs),
        (dx, dy, predx, predy, wx, wy), nsweeps)
    return scatter_state(gm_full, fulls, tiles, ox, oy) + (
        stats.to(d0_flat.device),)


def planes_relax(pg: PlanesGraph, d0_flat, cc_flat, crit_c, wenter0,
                 nsweeps: int):
    """Full-canvas planes relaxation with predecessor tracking.

    d0_flat [B, Ncells] seeded distances (a seeded cell's pred is
    itself); cc_flat congestion cost per cell (already (1-crit)-scaled,
    jittered, INF outside the net bb); crit_c [B, 1, 1, 1]; wenter0
    [B, Ncells] true delay payload at seeds.  Runs to the exact fixpoint
    or ``nsweeps`` sweeps.  Returns (dist, pred, wenter, stats).

    CUDA tensors launch the hand-written kernel (planes_kernels.py) or
    raise; CPU tensors run the plain version."""
    if d0_flat.is_cuda:
        from .planes_kernels import planes_relax_full_cuda
        return planes_relax_full_cuda(pg, d0_flat, cc_flat, crit_c,
                                      wenter0, nsweeps)
    return planes_relax_plain(pg, d0_flat, cc_flat, crit_c, wenter0,
                              nsweeps)


def planes_relax_cropped(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                         wenter0, nsweeps: int, ox, oy, cnx: int,
                         cny: int):
    """planes_relax on per-net (cnx, cny) CROPPED canvases.  Exact under
    the caller contract: every finite-cc cell and every seed of net b
    lies inside its tile.  Cells outside the tile return d0 / self-pred
    / wenter0.  CUDA tensors launch the hand-written kernel, which crops
    and scatters inside its one launch, or raise; CPU tensors run the
    plain version."""
    if d0_flat.is_cuda:
        from .planes_kernels import planes_relax_cropped_cuda
        return planes_relax_cropped_cuda(pg, d0_flat, cc_flat, crit_c,
                                         wenter0, nsweeps, ox, oy, cnx,
                                         cny)
    return planes_relax_cropped_plain(pg, d0_flat, cc_flat, crit_c,
                                      wenter0, nsweeps, ox, oy, cnx, cny)


def _as_row_mesh(mesh):
    """The window programs' ``mesh`` argument: None (one device) or a
    planes_shard.RowMesh (the row-sharded relaxation).  The JAX
    package's legacy (net, node) GSPMD mesh is not ported and raises."""
    if mesh is None:
        return None
    from .planes_shard import RowMesh
    if not isinstance(mesh, RowMesh):
        raise TypeError(f"mesh must be a planes_shard.RowMesh or None, got "
                        f"{type(mesh).__name__}")
    return mesh


# ---------------------------------------------------------------------------
# The batch step: rip up, re-route against everyone-but-itself, commit
# ---------------------------------------------------------------------------


def _col(a, fill):
    """Append one trash/pad column along the last axis."""
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=-1)


def _take(a, idx):
    """take_along_axis on axis 1 (idx of any integer dtype)."""
    return torch.gather(a, 1, idx.long())


def _cumsum_xla(x, base: int = 16):
    """Inclusive f32 cumsum along the last axis, summed in the order
    XLA:CPU evaluates the JAX package's ``jnp.cumsum`` (its reduce-window
    rewrite): sequential inside blocks of ``base``, then each block's
    exclusive prefix of block totals (the same scan, recursively) added
    on.  Another grouping would change the last bits of the delays."""
    n = x.shape[-1]
    if n <= base:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for j in range(n):
            acc = acc + x[..., j]
            out[..., j] = acc
        return out
    nb = -(-n // base)
    xp = torch.nn.functional.pad(x, (0, nb * base - n))
    c = _cumsum_xla(xp.reshape(x.shape[:-1] + (nb, base)), base)
    inc = _cumsum_xla(c[..., base - 1], base)
    prefix = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]],
                       dim=-1)
    return (c + prefix[..., None]).reshape(
        x.shape[:-1] + (nb * base,))[..., :n]


def _step_core(pg: PlanesGraph, dev: DeviceRRGraph, occ, acc, pres_fac,
               paths, sink_delay, all_reached, bb,
               source_all, sinks_all, crit_all,
               opin_node_all, entry_cell_all, entry_oidx_all,
               entry_delay_all,
               sink_uid_all, uid_cell, uid_ipin, uid_delay,
               direct_oidx_all, direct_ipin_all, direct_delay_all,
               sel, valid, force, full_bb,
               nsweeps: int, max_len: int, num_waves: int, group: int,
               doubling: bool, crop_tile=None, bb0_all=None,
               widen_ok=None, mesh=None):
    """One fused batch step: rip up the selected nets, re-route each
    against the occupancy of everyone-but-itself with the planes
    relaxation, commit and scatter back.  A selected net is a no-op
    unless it needs rerouting (an overused node on its tree or an
    unreached sink) or ``force`` is true.  With a RowMesh ``mesh`` (and
    no crop tile) the relaxation is the row-sharded one.

    ``paths``, ``sink_delay``, ``all_reached`` and ``bb`` are updated IN
    PLACE at the rerouted rows (the JAX program donates them; here the
    caller's tensors are the window state).  Returns (occ_new, n_routed,
    sweeps_executed, sweeps_useful) — the counts as Python ints."""
    device = occ.device
    N = dev.num_nodes
    B = sel.shape[0]
    S = sinks_all.shape[1]
    ncells = pg.ncells
    Kw = max_len - 4            # walk budget: sink+ipin+opin+source slots
    sel = sel.long()

    b_paths = paths[sel]
    b_src = source_all[sel]
    b_sinks = sinks_all[sel]
    b_bb = bb[sel]
    b_crit = crit_all[sel]
    b_opin = opin_node_all[sel]                  # [B, O]
    b_ecell = entry_cell_all[sel].long()         # [B, Ko]
    b_eoidx = entry_oidx_all[sel]
    b_edelay = entry_delay_all[sel]
    b_uid = sink_uid_all[sel].long()             # [B, S]
    b_scell = uid_cell[b_uid]                    # [B, S, K]
    b_sipin = uid_ipin[b_uid]
    b_swdel = uid_delay[b_uid]
    b_doidx = direct_oidx_all[sel]               # [B, S] (-1 = none)
    b_dipin = direct_ipin_all[sel]
    b_ddel = direct_delay_all[sel]
    O = b_opin.shape[1]
    Ko = b_ecell.shape[1]
    K = b_scell.shape[2]

    # device-side reroute predicate: skip clean nets unless forced
    over_now = _col(occ > dev.capacity, False)
    dirty = over_now[b_paths.long()].flatten(1).any(dim=1) | ~all_reached[sel]
    valid = valid & (dirty | force)

    # --- rip up ---
    old_usage = usage_from_paths(b_paths, N) & valid[:, None]
    occ_rip = occ - old_usage.sum(dim=0, dtype=_I32)
    occ_view = occ[None, :] - old_usage.to(_I32)

    cong = congestion_cost(dev, occ_view, acc, pres_fac)      # [B, N]
    # deterministic per-(net, node) jitter, the JAX package's int32 hash;
    # only its low 16 bits are read, so the int64 product (no wrap) gives
    # the same bits as the int32 wraparound
    h = (sel[:, None] * (2654435761 & 0x7FFFFFFF)
         + torch.arange(N, device=device)[None, :] * 40503)
    jitter = 1.0 + JITTER_EPS * ((h & 0xFFFF).to(_F32) / 65536.0)
    inside = ((dev.xhigh[None, :] >= b_bb[:, 0, None])
              & (dev.xlow[None, :] <= b_bb[:, 1, None])
              & (dev.yhigh[None, :] >= b_bb[:, 2, None])
              & (dev.ylow[None, :] <= b_bb[:, 3, None]))
    congj = torch.where(inside, cong * jitter, INF)            # [B, N]
    congj_p1 = _col(congj, INF)
    cc_flat_base = congj_p1[:, pg.node_of_cell.long()]
    opin_congj = _take(congj_p1, torch.clamp(b_opin, 0, N))    # [B, O]
    ipin_congj = _take(congj_p1, b_sipin.reshape(B, -1)).reshape(B, S, K)

    seed0 = torch.zeros((B, ncells), dtype=torch.bool, device=device)

    # per-net crop origins, anchored on the STATIC initial bb (bb0_all)
    # so a net whose live bb widened keeps a tile covering its terminals
    if crop_tile is not None:
        cnx_t, cny_t = crop_tile
        NXg = pg.shape_x[1]
        NYg = pg.shape_y[2]
        Lm = pg.max_span
        bb_anchor = bb0_all[sel] if bb0_all is not None else b_bb
        crop_ox = torch.clamp(bb_anchor[:, 0] - Lm, 0, NXg - cnx_t).to(_I32)
        crop_oy = torch.clamp(bb_anchor[:, 2] - Lm, 0, NYg - cny_t).to(_I32)

    G = group
    ar_g = torch.arange(G, device=device)[None, :]
    noc_p1 = _col(pg.node_of_cell, N).long()

    def wave_run(wave, state):
        (seed_cells, tdel_cells, opin_used, remaining, wpaths, delay,
         reached_all, st) = state
        crit_w = torch.where(remaining, b_crit, 0.0).amax(dim=1)   # [B]
        cw = 1.0 - crit_w
        cc_flat = cw[:, None] * cc_flat_base
        crit_c = crit_w[:, None, None, None]

        # --- seed + SOURCE-side entries ---
        d_seed = torch.where(seed_cells, 0.0, INF)
        opin_du = torch.where(opin_used, 0.0, cw[:, None] * opin_congj)
        e_du = _take(opin_du, b_eoidx)                          # [B, Ko]
        e_cc = _take(_col(cc_flat, INF), torch.clamp(b_ecell, max=ncells))
        # invalid/clean slots get all-INF entry seeds (never improve)
        e_cost = torch.where(valid[:, None],
                             e_du + crit_w[:, None] * b_edelay + e_cc, INF)
        # scatter-min with the pad entries (cell ncells) into a trash slot
        d0 = _col(d_seed, INF).scatter_reduce(
            1, b_ecell, e_cost, reduce="amin")[:, :ncells].contiguous()
        entry_flag = d0 < d_seed
        # winning entry index per cell (ties -> lowest k, deterministic)
        d0_at_e = _take(_col(d0, INF), torch.clamp(b_ecell, max=ncells))
        e_won = d0_at_e == e_cost
        ks = torch.arange(Ko, dtype=torch.int64, device=device)[None, :]
        wk = torch.full((B, ncells + 1), Ko, dtype=torch.int64,
                        device=device).scatter_reduce(
            1, b_ecell, torch.where(e_won, ks, Ko), reduce="amin"
        )[:, :ncells]
        wenter0 = torch.where(
            entry_flag, _take(_col(b_edelay, 0.0), torch.clamp(wk, max=Ko)),
            0.0)

        if crop_tile is not None:
            dist, pred, wenter, rst = planes_relax_cropped(
                pg, d0, cc_flat, crit_c, wenter0, nsweeps,
                crop_ox, crop_oy, cnx_t, cny_t)
        elif _as_row_mesh(mesh) is not None:
            from .planes_shard import planes_relax_sharded
            dist, pred, wenter, rst = planes_relax_sharded(
                pg, d0, cc_flat, crit_c, wenter0, nsweeps, mesh)
        else:
            dist, pred, wenter, rst = planes_relax(
                pg, d0, cc_flat, crit_c, wenter0, nsweeps)
        st = st + rst.to(st.device)

        # --- sink extraction from the per-net candidate tables ---
        cand = (_take(_col(dist, INF), b_scell.reshape(B, -1)
                      ).reshape(B, S, K)
                + crit_w[:, None, None] * b_swdel
                + cw[:, None, None] * ipin_congj)
        kstar = torch.argmin(cand, dim=2, keepdim=True)         # [B, S, 1]
        sink_dist = torch.gather(cand, 2, kstar)[:, :, 0]
        ent_cell = torch.gather(b_scell, 2, kstar)[:, :, 0]
        ent_ipin = torch.gather(b_sipin, 2, kstar)[:, :, 0]
        ent_wdel = torch.gather(b_swdel, 2, kstar)[:, :, 0]

        # --- dedicated direct candidate (OPIN->IPIN->SINK); the fabric
        # wins exact ties (strict <) ---
        has_d = b_doidx >= 0
        ddu = _take(opin_du, torch.clamp(b_doidx, 0, O - 1))    # [B, S]
        dip_cong = _take(congj_p1, b_dipin)
        dcost = torch.where(has_d, ddu + crit_w[:, None] * b_ddel
                            + cw[:, None] * dip_cong, INF)
        use_direct = dcost < sink_dist
        sink_dist = torch.minimum(sink_dist, dcost)

        # --- pick up to `group` sinks: most critical, then nearest ---
        score = torch.where(remaining & torch.isfinite(sink_dist),
                            sink_dist - b_crit * 1e3, INF)
        order = torch.argsort(score, dim=1, stable=True)[:, :G]  # [B, G]
        pick_valid = (_take(remaining, order)
                      & torch.isfinite(_take(score, order)))
        if doubling:
            # doubling schedule: wave k routes <= 2^k sinks
            limit = 1 << min(wave, 30)
            pick_valid = pick_valid & (ar_g < limit)
        pick_sink = torch.where(pick_valid, _take(b_sinks, order), -1)
        pick_ipin = _take(ent_ipin, order)
        pick_cell = torch.where(pick_valid, _take(ent_cell, order),
                                0).long()
        pick_wdel = _take(ent_wdel, order)
        pick_direct = _take(use_direct, order) & pick_valid
        pick_dipin = _take(b_dipin, order)
        pick_doidx = _take(torch.clamp(b_doidx, 0, O - 1), order)
        pick_ddel = _take(b_ddel, order)
        pick_ipin = torch.where(pick_direct, pick_dipin, pick_ipin)
        pick_cell = torch.where(pick_direct, 0, pick_cell)

        # --- pointer-chase traceback in cell space ---
        cells_w = torch.full((B, G, Kw), ncells, dtype=torch.int64,
                             device=device)
        nodes_w = torch.full((B, G, Kw), N, dtype=torch.int64,
                             device=device)
        wst = torch.zeros((B, G, Kw), dtype=_F32, device=device)
        cur = pick_cell
        done = ~pick_valid | pick_direct
        predl = pred.long()
        for pos in range(Kw):
            # once every walk is done the remaining steps would write
            # the fill values and keep cur: skip them (exact)
            if pos % 8 == 0 and bool(done.all()):
                break
            nd = noc_p1[cur]
            cells_w[:, :, pos] = torch.where(done, ncells, cur)
            nodes_w[:, :, pos] = torch.where(done, N, nd)
            curc = torch.clamp(cur, 0, ncells - 1)
            wst[:, :, pos] = torch.where(done, 0.0, _take(wenter, curc))
            nxt = torch.gather(predl, 1, curc)
            stop = done | (nxt == cur)
            cur = torch.where(stop, cur, nxt)
            done = stop
        join = torch.clamp(cur, 0, ncells - 1)
        okw = pick_valid & (torch.gather(predl, 1, join) == cur)
        ok = torch.where(pick_direct, pick_valid, okw)          # [B, G]

        at_entry = _take(entry_flag, join) & ok & ~pick_direct
        tdel_base = torch.where(at_entry, 0.0, _take(tdel_cells, join))
        # suffix sums of the walk's enter delays
        wsum = torch.flip(_cumsum_xla(torch.flip(wst, (2,))), (2,))
        d_new = torch.where(pick_direct, pick_ddel,
                            tdel_base + wsum[:, :, 0] + pick_wdel)

        # entry suffix: which OPIN fed the winning entry cell
        wk_join = _take(wk, join)
        oidx_join = _take(_col(b_eoidx, 0), torch.clamp(wk_join, max=Ko))
        opin_join = _take(b_opin, oidx_join)

        # --- assemble path rows: [sink, ipin, nodes..., (opin, source)];
        # index max_len is the dropped-write trash column ---
        dup = torch.cat([torch.zeros((B, G, 1), dtype=torch.bool,
                                     device=device),
                         nodes_w[:, :, 1:] == nodes_w[:, :, :-1]], dim=2)
        keep = ~dup & (nodes_w < N) & (ok & ~pick_direct)[:, :, None]
        posn = torch.cumsum(keep, dim=2) - 1
        seg = torch.full((B, G, max_len + 1), N, dtype=_I32, device=device)
        seg[:, :, 0] = torch.where(ok, pick_sink, N)
        seg[:, :, 1] = torch.where(ok, pick_ipin, N)
        seg.scatter_(2, torch.where(keep, posn + 2, max_len),
                     nodes_w.to(_I32))
        nkeep = keep.sum(dim=2)                                  # [B, G]
        put_e = at_entry & ok
        b_src_g = b_src[:, None].expand(B, G).to(_I32)
        seg.scatter_(2, torch.where(put_e, nkeep + 2, max_len)[:, :, None],
                     opin_join.to(_I32)[:, :, None])
        seg.scatter_(2, torch.where(put_e, nkeep + 3, max_len)[:, :, None],
                     b_src_g[:, :, None])
        pdm = pick_direct & ok
        d_opin = _take(b_opin, pick_doidx)
        seg.scatter_(2, torch.where(pdm, 2, max_len)[:, :, None],
                     d_opin.to(_I32)[:, :, None])
        seg.scatter_(2, torch.where(pdm, 3, max_len)[:, :, None],
                     b_src_g[:, :, None])
        seg = seg[:, :, :max_len]

        # --- store results at the picked sink slots ---
        Lp = wpaths.shape[2]
        oidx3 = order[:, :, None].expand(B, G, Lp)
        old = torch.gather(wpaths, 1, oidx3)
        wpaths = wpaths.scatter(1, oidx3,
                                torch.where(ok[:, :, None], seg, old))
        delay = delay.scatter(1, order, torch.where(ok, d_new,
                                                    _take(delay, order)))
        reached_all = reached_all.scatter(
            1, order, ok | _take(reached_all, order))
        remaining = remaining.scatter(
            1, order, _take(remaining, order) & ~ok)

        # --- grow the tree (cell space), deterministically via min ---
        walk_cells = torch.where((ok & ~pick_direct)[:, :, None], cells_w,
                                 ncells).reshape(B, -1)
        walk_tdel = (tdel_base[:, :, None] + wsum).reshape(B, -1)
        buf = torch.full((B, ncells + 1), INF, dtype=_F32, device=device
                         ).scatter_reduce(1, walk_cells, walk_tdel,
                                          reduce="amin")
        newly = torch.isfinite(buf[:, :ncells])
        tdel_cells = torch.where(newly, buf[:, :ncells], tdel_cells)
        seed_cells = seed_cells | newly
        ou = _col(opin_used, False)
        ou = ou.scatter(1, torch.where(put_e, oidx_join.long(), O), True)
        ou = ou.scatter(1, torch.where(pdm, pick_doidx.long(), O), True)
        opin_used = ou[:, :O] | opin_used
        return (seed_cells, tdel_cells, opin_used, remaining, wpaths,
                delay, reached_all, st)

    state = (seed0, torch.zeros((B, ncells), dtype=_F32, device=device),
             torch.zeros((B, O), dtype=torch.bool, device=device),
             (b_sinks >= 0) & valid[:, None],
             torch.full((B, S, max_len), N, dtype=_I32, device=device),
             torch.full((B, S), INF, dtype=_F32, device=device),
             torch.zeros((B, S), dtype=torch.bool, device=device),
             torch.zeros(2, dtype=_I32, device=device))
    for wave in range(num_waves):
        # once every (valid) sink is reached the remaining waves are
        # identity passes: skip their relaxations entirely (exact)
        if not bool(state[3].any()):
            break
        state = wave_run(wave, state)
    (_, _, _, _, p, delay, reached, st) = state

    usage = usage_from_paths(p, N) & valid[:, None]
    occ_new = occ_rip + usage.sum(dim=0, dtype=_I32)

    smask = b_sinks >= 0
    ok = (reached | ~smask).all(dim=1)
    # unreached-sink widening, gated per net by widen_ok (a net routed
    # under a reduced sweep budget is promoted by the host instead)
    may_widen = (torch.ones(B, dtype=torch.bool, device=device)
                 if widen_ok is None else widen_ok[sel])
    new_bb = torch.where((ok | ~may_widen)[:, None], b_bb, full_bb[None, :])

    rows = sel[valid]
    paths[rows] = p[valid]
    sink_delay[rows] = delay[valid]
    all_reached[rows] = ok[valid]
    bb[rows] = new_bb[valid]
    st = st.tolist()
    return occ_new, int(valid.sum()), st[0], st[1]


def _mis_colors(dev: DeviceRRGraph, occ, paths, all_reached,
                topk: int, n_colors: int):
    """Conflict scheduling: greedy parallel MIS colouring of the reroute
    set over the top-K most-overused nodes (a net takes colour c iff it
    holds the min net id on every contested node among the uncoloured).
    Returns (rrm [R], colors [R])."""
    device = occ.device
    N = dev.num_nodes
    R = paths.shape[0]
    over = torch.clamp(occ - dev.capacity, min=0)
    over_p1 = _col(over > 0, False)
    rrm = over_p1[paths.long()].flatten(1).any(dim=1) | ~all_reached
    # lax.top_k order: value descending, ties by ascending index
    val, ids = torch.sort(over, descending=True, stable=True)
    val, ids = val[:topk], ids[:topk]
    ids = torch.where(val > 0, ids, N)
    ids_sorted = torch.sort(ids).values
    flat = paths.reshape(R, -1).long()
    pos = torch.clamp(torch.searchsorted(ids_sorted, flat), 0, topk - 1)
    hit = (ids_sorted[pos] == flat) & (flat < N)
    U = torch.zeros((R, topk + 1), dtype=torch.bool, device=device)
    U.scatter_(1, torch.where(hit, pos, topk), True)
    U = U[:, :topk] & rrm[:, None]
    prio = torch.arange(R, device=device)
    color = torch.full((R,), n_colors - 1, dtype=_I32, device=device)
    uncol = rrm
    for c in range(n_colors - 1):
        Uc = U & uncol[:, None]
        claim = torch.where(Uc, prio[:, None], R).amin(dim=0)
        conflict = (Uc & (claim[None, :] != prio[:, None])).any(dim=1)
        joins = uncol & ~conflict
        color = torch.where(joins, c, color)
        uncol = uncol & ~joins
    return rrm, color


# indices into the packed ``scal`` window summary vector
SCAL_N_OVER = 0
SCAL_OVER_TOTAL = 1
SCAL_NROUTES = 2
SCAL_NEXEC = 3
SCAL_MAX_SPAN = 4
SCAL_S_EXEC = 5
SCAL_S_USEFUL = 6
SCAL_LEN = 7


def route_window_planes(
        pg: PlanesGraph, dev: DeviceRRGraph, occ, acc,
        paths, sink_delay, all_reached, bb,
        source_all, sinks_all, crit_all,
        opin_node_all, entry_cell_all, entry_oidx_all, entry_delay_all,
        sink_uid_all, uid_cell, uid_ipin, uid_delay,
        direct_oidx_all, direct_ipin_all, direct_delay_all,
        sel_plan, valid_plan, full_bb,
        pres0: float, pres_mult: float, max_pres: float, acc_fac: float,
        it0: int, force_until: int,
        K_iters: int, nsweeps: int, max_len: int, num_waves: int,
        group: int, doubling: bool = True, topk: int = 1024,
        n_colors: int = 5, crop_tile=None, bb0_all=None, widen_ok=None,
        mesh=None):
    """A WINDOW of K_iters PathFinder iterations: per iteration, every
    batch group of ``sel_plan`` [G, B] runs the fused rip-up/route/commit
    step (groups with no dirty net are skipped outright), then the
    present/history cost update (congestion.h:177-193).

    ``paths``, ``sink_delay``, ``all_reached`` and ``bb`` are updated in
    place.  Returns (occ, acc, status [R] int32, scal [SCAL_LEN] int32):
    status packs bit0 rrm, bit1 dev_wide, bit2 unreached, bits3-7
    colour, bits8-15 live-h bucket, bits16-23 live-w bucket (8-tile
    buckets); scal holds the window's scalar counters (SCAL_*).  ``mesh``
    (a planes_shard.RowMesh) shards the full-canvas relaxation."""
    device = occ.device
    G = sel_plan.shape[0]
    f32 = lambda v: torch.tensor(v, dtype=_F32, device=device)  # noqa: E731
    pres = f32(pres0)
    pres_mult_t, max_pres_t, acc_fac_t = f32(pres_mult), f32(max_pres), \
        f32(acc_fac)
    nroutes = nexec = s_exec = s_useful = 0
    for it in range(K_iters):
        force = (it0 + it) < force_until
        for g in range(G):
            sel_g = sel_plan[g].long()
            valid_g = valid_plan[g]
            # skip padding groups and fully-clean groups outright
            over_g = _col(occ > dev.capacity, False)
            any_dirty = (valid_g & (
                over_g[paths[sel_g].long()].flatten(1).any(dim=1)
                | ~all_reached[sel_g] | force)).any()
            if not bool(any_dirty):
                continue
            occ, n_act, se, su = _step_core(
                pg, dev, occ, acc, pres, paths, sink_delay, all_reached,
                bb, source_all, sinks_all, crit_all,
                opin_node_all, entry_cell_all, entry_oidx_all,
                entry_delay_all, sink_uid_all, uid_cell, uid_ipin,
                uid_delay, direct_oidx_all, direct_ipin_all,
                direct_delay_all, sel_g, valid_g, force, full_bb,
                nsweeps, max_len, num_waves, group, doubling,
                crop_tile, bb0_all, widen_ok, mesh)
            nroutes += n_act
            nexec += 1
            s_exec += se
            s_useful += su
        # PathFinder history/present escalation once per iteration
        acc = acc + acc_fac_t * torch.clamp(
            occ - dev.capacity, min=0).to(_F32)
        pres = torch.minimum(max_pres_t, pres * pres_mult_t)

    rrm, colors = _mis_colors(dev, occ, paths, all_reached, topk, n_colors)
    over = torch.clamp(occ - dev.capacity, min=0)
    span = (bb[:, 1] - bb[:, 0]) + (bb[:, 3] - bb[:, 2])
    max_span = torch.where(rrm, span, 0).amax()
    NXg = pg.shape_x[1]
    NYg = pg.shape_y[2]
    dev_wide = span >= (NXg + NYg)
    wb = torch.clamp((bb[:, 1] - bb[:, 0] + 1 + 7) // 8, 0, 255)
    hb = torch.clamp((bb[:, 3] - bb[:, 2] + 1 + 7) // 8, 0, 255)
    unreached = ~all_reached
    status = (rrm.to(_I32) | (dev_wide.to(_I32) << 1)
              | (unreached.to(_I32) << 2) | ((colors & 0x1F) << 3)
              | (hb.to(_I32) << 8) | (wb.to(_I32) << 16))
    scal = torch.stack([
        (over > 0).sum(), over.sum(),
        torch.tensor(nroutes, device=device),
        torch.tensor(nexec, device=device), max_span.to(torch.int64),
        torch.tensor(s_exec, device=device),
        torch.tensor(s_useful, device=device)]).to(_I32)
    return occ, acc, status, scal


def unpack_window_status(status):
    """Host-side decode of the packed per-net status word.  Returns
    (rrm, colors, dev_wide, unreached, live_w, live_h) numpy arrays."""
    s = np.asarray(status)
    rrm = (s & 1).astype(bool)
    dev_wide = ((s >> 1) & 1).astype(bool)
    unreached = ((s >> 2) & 1).astype(bool)
    colors = ((s >> 3) & 0x1F).astype(np.int32)
    live_h = (((s >> 8) & 0xFF).astype(np.int64)) * 8
    live_w = (((s >> 16) & 0xFF).astype(np.int64)) * 8
    return rrm, colors, dev_wide, unreached, live_w, live_h
