"""Placement / routing visualization -> SVG.

The reference ships an interactive X11 viewer (vpr/SRC/base/graphics.c
4.0k + draw.c 2.1k, update_screen) for inspecting placements and routed
nets.  A batch flow has no display: the equivalent surface is static
SVG snapshots of the same two views — the placed grid (tiles colored by
block type, IO ring, heterogeneous columns) and the routed wires (CHANX/
CHANY segments drawn in their channels, colored by occupancy) — written
per run and viewable in any browser.
`python -m parallel_eda_tpu_torch --draw out/` emits both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_TILE = 24          # px per grid tile
_TYPE_FILL = {"io": "#cfe8ff", "clb": "#e8e8e8", "bram": "#ffd9a8"}
_EXTRA_FILLS = ["#d8f0d0", "#f0d0e8", "#d0e8f0"]


def _svg_header(w: int, h: int) -> str:
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}" viewBox="0 0 {w} {h}">\n'
            '<rect width="100%" height="100%" fill="white"/>\n')


def _tile_fill(tname: str, extra: dict) -> str:
    if tname in _TYPE_FILL:
        return _TYPE_FILL[tname]
    if tname not in extra:
        extra[tname] = _EXTRA_FILLS[len(extra) % len(_EXTRA_FILLS)]
    return extra[tname]


def _grid_rects(grid) -> list:
    out = []
    extra: dict = {}
    W, H = grid.nx + 2, grid.ny + 2
    for x in range(W):
        for y in range(H):
            if grid.is_corner(x, y):
                continue
            tname = ("io" if grid.is_io(x, y)
                     else grid.interior_type_name(x))
            px, py = x * _TILE, (H - 1 - y) * _TILE
            out.append(f'<rect x="{px + 1}" y="{py + 1}" '
                       f'width="{_TILE - 2}" height="{_TILE - 2}" '
                       f'fill="{_tile_fill(tname, extra)}" '
                       f'stroke="#999" stroke-width="0.5"/>')
    return out


def write_placement_svg(flow, path: str) -> None:
    """Placed-grid view (draw.c drawplace equivalent): tiles by type,
    block names, flightlines of the 10 longest nets."""
    grid, pnl, pos = flow.grid, flow.pnl, flow.pos
    W, H = grid.nx + 2, grid.ny + 2
    parts = [_svg_header(W * _TILE, H * _TILE)]
    parts += _grid_rects(grid)

    def center(x, y):
        return (x * _TILE + _TILE // 2, (H - 1 - y) * _TILE + _TILE // 2)

    for bi in range(pnl.num_blocks):
        x, y, z = (int(v) for v in pos[bi])
        cx, cy = center(x, y)
        parts.append(f'<circle cx="{cx}" cy="{cy}" r="3" fill="#444"/>')

    # flightlines of the widest-spanning nets
    spans = []
    for ni, net in enumerate(pnl.nets):
        if net.is_global or not net.sinks or net.driver is None:
            continue
        blks = [net.driver.block] + [p.block for p in net.sinks]
        xs = pos[blks, 0]; ys = pos[blks, 1]
        spans.append((int(xs.max() - xs.min() + ys.max() - ys.min()), ni))
    for _, ni in sorted(spans, reverse=True)[:10]:
        net = flow.pnl.nets[ni]
        sx, sy = center(int(pos[net.driver.block, 0]),
                        int(pos[net.driver.block, 1]))
        for p in net.sinks:
            tx, ty = center(int(pos[p.block, 0]), int(pos[p.block, 1]))
            parts.append(f'<line x1="{sx}" y1="{sy}" x2="{tx}" y2="{ty}" '
                         'stroke="#c33" stroke-width="0.8" opacity="0.6"/>')
    parts.append("</svg>\n")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def write_routing_svg(flow, path: str,
                      occ: Optional[np.ndarray] = None) -> None:
    """Routed-wires view (draw.c drawroute equivalent): every used CHANX/
    CHANY wire drawn in its channel, colored by occupancy (green=used,
    red=overused)."""
    from .rr.graph import CHANX, CHANY

    rr, grid = flow.rr, flow.grid
    route = flow.route
    H = grid.ny + 2
    parts = [_svg_header((grid.nx + 2) * _TILE, H * _TILE)]
    parts += _grid_rects(grid)

    occ = occ if occ is not None else (route.occ if route is not None
                                       else None)
    if occ is None:
        raise ValueError("no routing to draw")
    cap = np.asarray(rr.capacity, dtype=np.int64)
    used = np.where(occ > 0)[0]
    W = rr.chan_width
    for v in used:
        t = int(rr.node_type[v])
        if t not in (CHANX, CHANY):
            continue
        frac = (int(rr.ptc[v]) + 1) / (W + 1)
        color = "#c22" if occ[v] > cap[v] else "#2a2"
        if t == CHANX:
            y = int(rr.ylow[v])                 # channel above row y
            py = (H - 1 - y) * _TILE - 1 - frac * 6
            x0 = int(rr.xlow[v]) * _TILE + 2
            x1 = (int(rr.xhigh[v]) + 1) * _TILE - 2
            parts.append(f'<line x1="{x0}" y1="{py:.1f}" x2="{x1}" '
                         f'y2="{py:.1f}" stroke="{color}" '
                         'stroke-width="1"/>')
        else:
            x = int(rr.xlow[v])
            px = (x + 1) * _TILE - 1 - frac * 6
            y0 = (H - 1 - int(rr.yhigh[v])) * _TILE + 2
            y1 = (H - int(rr.ylow[v])) * _TILE - 2
            parts.append(f'<line x1="{px:.1f}" y1="{y0}" x2="{px:.1f}" '
                         f'y2="{y1}" stroke="{color}" stroke-width="1"/>')
    parts.append("</svg>\n")
    with open(path, "w") as f:
        f.write("\n".join(parts))
