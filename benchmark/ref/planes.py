"""Frozen copy of the port's ``route/planes.py`` (plane layout and the
plain relaxation), kept with the benchmark as part of its yardstick: the
reference rebuilds from it what the program derives, and compares. Only
imports were changed."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .rrgraph import CHANX, CHANY, RRGraph

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
    """Per-net index rows o[b] + arange(size) into an axis of ``extent``
    cells, with the origin placed as lax.dynamic_slice places its start:
    a negative origin first wraps once by the extent, then the origin is
    clamped into [0, extent - size]."""
    o = o.long()
    o = torch.clamp(torch.where(o < 0, o + extent, o), 0, extent - size)
    return o[:, None] + torch.arange(size, device=o.device)[None, :]


def crop_origin_hi(pg: PlanesGraph, cnx: int, cny: int):
    """The largest origin (x, y) of a (cnx, cny) tile.  One clamp range
    serves every array of the cropped relaxation: chanx [NX, NY+1] cut at
    (cnx, cny+1), chany [NX+1, NY] at (cnx+1, cny) and the corner parity
    [NX+1, NY+1] at (cnx+1, cny+1) all clamp x into [0, NX-cnx] and y
    into [0, NY-cny].  The wrap of a negative origin (_crop_index) is by
    each array's own extent, so an origin below -cnx (x) or -cny (y)
    lands one apart on the two extents; K2 places each net's two x and
    two y origins in the kernel."""
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


# Storage dtypes of the distance/backtrack planes (the JAX package's
# PLANE_DTYPES).  "f32" is the exact oracle.  "bf16" carries dist and
# wenter in bfloat16 between sweeps while every sweep runs in f32 and
# rounds once at its end (round to nearest even); pred stays int32 and
# crit f32, and the congestion input is rounded once through bfloat16.
PLANE_DTYPES = ("f32", "bf16")


def plane_torch_dtype(plane_dtype: str) -> torch.dtype:
    """The storage dtype of a plane-dtype name."""
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(
            f"plane_dtype must be one of {PLANE_DTYPES}, "
            f"got {plane_dtype!r}")
    return torch.bfloat16 if plane_dtype == "bf16" else _F32


def plane_itemsize(plane_dtype: str) -> int:
    """Storage bytes per plane cell (the halo ledger's multiplier)."""
    return 2 if plane_dtype == "bf16" else 4


def quantize_plane_state(s, plane_dtype: str):
    """(dx, dy, predx, predy, wx, wy) -> storage dtypes: dist and wenter
    take the plane dtype (round to nearest even), pred stays int32."""
    dt = plane_torch_dtype(plane_dtype)
    dx, dy, px, py, wx, wy = s
    return dx.to(dt), dy.to(dt), px, py, wx.to(dt), wy.to(dt)


def _dequantize_plane_state(s):
    dx, dy, px, py, wx, wy = s
    return dx.float(), dy.float(), px, py, wx.float(), wy.float()


def round_plane(a, plane_dtype: str):
    """``a`` rounded once through the plane dtype, back in f32 (the
    congestion input of a reduced-precision relaxation)."""
    if plane_dtype == "f32":
        return a
    return a.to(plane_torch_dtype(plane_dtype)).float()


def _run_relax(sweep_fn, state0, nsweeps: int, plane_dtype: str = "f32"):
    """Run ``sweep_fn`` to the fixpoint or ``nsweeps`` times, whichever
    comes first.  Updates are strict improvements of a monotone state,
    so "no distance improved" is an exact fixpoint test.  With
    ``plane_dtype="bf16"`` the state between sweeps is stored in
    bfloat16: each sweep upcasts, runs in f32 and rounds back, and the
    test compares the ROUNDED distances (still exact: rounding is
    monotone, so the rounded state never increases).  Returns (state,
    stats) with stats = int32[2] (sweeps executed, sweeps that improved
    some distance)."""
    step = sweep_fn
    if plane_dtype != "f32":
        state0 = quantize_plane_state(state0, plane_dtype)

        def step(s):
            return quantize_plane_state(
                sweep_fn(_dequantize_plane_state(s)), plane_dtype)
    i, go, s = 0, True, state0
    while go and i < nsweeps:
        s2 = step(s)
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
                       nsweeps: int, plane_dtype: str = "f32"):
    """The plain PyTorch version of the full-canvas relaxation (any
    device): d0_flat/cc_flat/wenter0 [B, Ncells] f32, crit_c [B,1,1,1].
    Returns (dist, pred, wenter, stats) — dist/wenter f32 and pred int32
    [B, Ncells] (global cell ids), stats int32[2].  ``plane_dtype``
    "bf16" relaxes in the reduced-precision plane mode (_run_relax) on
    the congestion rounded once through bfloat16; dist and wenter come
    back as the f32 values of their bfloat16 state."""
    dx, dy = _split_flat(pg, d0_flat)
    cc_x, cc_y = _split_flat(pg, round_plane(cc_flat, plane_dtype))
    wx, wy = _split_flat(pg, wenter0)
    gm = geom_full(pg)
    predx = gm.idxx.expand(dx.shape)
    predy = gm.idxy.expand(dy.shape)
    costs = _sweep_costs(gm, crit_c, cc_x, cc_y)
    state, stats = _run_relax(
        lambda s: _sweep_once(gm, s, crit_c, cc_x, cc_y, costs),
        (dx, dy, predx, predy, wx, wy), nsweeps, plane_dtype)
    dx, dy, predx, predy, wx, wy = _dequantize_plane_state(state)
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
                               cnx: int, cny: int, plane_dtype: str = "f32"):
    """The plain PyTorch version of the cropped relaxation (any
    device): net b sweeps only the tile at grid cell (ox[b], oy[b]).
    Same returns as planes_relax_plain; in the bf16 plane mode only the
    tiles are rounded (cells outside keep d0 / wenter0 as given)."""
    gm_full = geom_full(pg)
    gm = geom_cropped(pg, ox, oy, cnx, cny, full=gm_full)
    fulls, (dx, dy, cc_x, cc_y, wx, wy) = crop_state(
        pg, d0_flat, cc_flat, wenter0, ox, oy, cnx, cny)
    cc_x, cc_y = round_plane(cc_x, plane_dtype), round_plane(cc_y,
                                                             plane_dtype)
    predx = gm.idxx.expand(dx.shape)
    predy = gm.idxy.expand(dy.shape)
    costs = _sweep_costs(gm, crit_c, cc_x, cc_y)
    tiles, stats = _run_relax(
        lambda s: _sweep_once(gm, s, crit_c, cc_x, cc_y, costs),
        (dx, dy, predx, predy, wx, wy), nsweeps, plane_dtype)
    return scatter_state(gm_full, fulls, _dequantize_plane_state(tiles),
                         ox, oy) + (stats.to(d0_flat.device),)
