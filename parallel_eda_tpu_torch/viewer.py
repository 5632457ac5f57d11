"""Interactive placement/routing viewer -> single-file HTML.

The reference's interactive surface is an X11 GUI (vpr/SRC/base/
graphics.c:4.0k + draw.c:2.1k, update_screen): pan/zoom over the placed
grid, toggle nets / routing / congestion, click a net to highlight its
route, highlight the critical path.  A batch flow runs headless, so
the re-design keeps the interactivity but moves it to the artifact: one
self-contained HTML file (no external assets; works from file://) with
the full placement + routing model embedded as JSON and a canvas
renderer providing

  - wheel zoom + drag pan + fit (graphics.c zoom/pan bindings),
  - layer toggles: block labels, net flightlines, routed wires,
    congestion heatmap (draw.c toggle_nets / toggle_rr / congestion
    view),
  - a searchable net list; selecting nets highlights their routed
    wires and flightlines (draw.c highlight_nets),
  - hover inspection of tiles, blocks, and wires (occupancy/capacity),
  - one-click highlight of the worst-delay net (the crit-path display).

`python -m parallel_eda_tpu_torch --draw out/` writes viewer.html next to the
static SVG snapshots.
"""

from __future__ import annotations

import json

import numpy as np

from .draw import _TYPE_FILL, _tile_fill


def _flow_model(flow) -> dict:
    """Extract the embedded JSON model from a FlowResult."""
    from .rr.graph import CHANX, CHANY

    grid, pnl, pos, rr = flow.grid, flow.pnl, flow.pos, flow.rr
    nx, ny = grid.nx, grid.ny

    tiles = []
    extra: dict = {}
    fills = dict(_TYPE_FILL)
    for x in range(nx + 2):
        for y in range(ny + 2):
            if grid.is_corner(x, y):
                continue
            tname = ("io" if grid.is_io(x, y)
                     else grid.interior_type_name(x))
            fills.setdefault(tname, _tile_fill(tname, extra))
            tiles.append([x, y, tname])

    blocks = [{"n": b.name, "t": b.type_name,
               "x": int(pos[bi, 0]), "y": int(pos[bi, 1]),
               "z": int(pos[bi, 2])}
              for bi, b in enumerate(pnl.blocks)]

    # nets: every packed net with a driver; routable ones carry their
    # term row so routed wires can be attached
    row_of_net = {}
    route = flow.route
    if flow.term is not None:
        for r, ni in enumerate(np.asarray(flow.term.net_ids)):
            row_of_net[int(ni)] = r

    # routed CHANX/CHANY wires (drawroute's wire set), indexed once
    wires, wire_idx = [], {}
    if route is not None:
        occ = np.asarray(route.occ)
        cap = np.asarray(rr.capacity)
        for v in np.where(occ > 0)[0]:
            t = int(rr.node_type[v])
            if t not in (CHANX, CHANY):
                continue
            wire_idx[int(v)] = len(wires)
            wires.append({"v": int(v),
                          "h": 1 if t == CHANX else 0,
                          "x0": int(rr.xlow[v]), "y0": int(rr.ylow[v]),
                          "x1": int(rr.xhigh[v]),
                          "y1": int(rr.yhigh[v]),
                          "p": int(rr.ptc[v]), "o": int(occ[v]),
                          "c": int(cap[v])})

    nets = []
    sink_delay = (np.asarray(route.sink_delay)
                  if route is not None and route.sink_delay is not None
                  else None)
    for ni, net in enumerate(pnl.nets):
        if net.driver is None:
            continue
        r = row_of_net.get(ni, -1)
        nwires = []
        tmax = 0.0
        if r >= 0 and route is not None:
            seg = np.asarray(route.paths[r]).ravel()
            ws = {wire_idx[int(v)] for v in seg[seg < rr.num_nodes]
                  if int(v) in wire_idx}
            nwires = sorted(ws)
            if sink_delay is not None:
                ns = len(net.sinks)
                tmax = float(np.max(sink_delay[r, :ns], initial=0.0))
        nets.append({"n": net.name, "g": int(bool(net.is_global)),
                     "d": int(net.driver.block),
                     "s": [int(p.block) for p in net.sinks],
                     "w": nwires, "tm": round(tmax * 1e9, 4)})

    return {"nx": nx, "ny": ny, "W": int(rr.chan_width),
            "fills": fills, "tiles": tiles,
            "blocks": blocks, "nets": nets, "wires": wires,
            "routed": route is not None,
            "crit_ns": (round(flow.crit_path_delay * 1e9, 4)
                        if flow.analyzer else None),
            "name": pnl.name}


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>parallel_eda_tpu viewer</title>
<style>
 body{margin:0;font:13px sans-serif;display:flex;height:100vh}
 #side{width:240px;padding:8px;overflow-y:auto;border-right:1px solid #ccc}
 #main{flex:1;position:relative}
 canvas{position:absolute;top:0;left:0}
 #tip{position:absolute;background:#222;color:#fff;padding:2px 6px;
      border-radius:3px;pointer-events:none;display:none;font-size:12px}
 .net{cursor:pointer;padding:1px 3px;white-space:nowrap;overflow:hidden;
      text-overflow:ellipsis}
 .net.sel{background:#ffe08a}
 label{display:block}
 #stats{color:#555;margin:6px 0;font-size:12px}
 button{margin:2px 2px 2px 0}
</style></head><body>
<div id="side">
 <b id="title"></b>
 <div id="stats"></div>
 <button id="fit">fit</button>
 <button id="worst">worst-delay net</button>
 <button id="clear">clear</button>
 <label><input type="checkbox" id="Lblocks" checked> block labels</label>
 <label><input type="checkbox" id="Lwires" checked> routed wires</label>
 <label><input type="checkbox" id="Lcong"> congestion heat</label>
 <label><input type="checkbox" id="Lfly"> net flightlines</label>
 <input id="q" placeholder="filter nets" style="width:95%">
 <div id="nets"></div>
</div>
<div id="main"><canvas id="cv"></canvas><div id="tip"></div></div>
<script>
const M = __MODEL__;
const cv = document.getElementById('cv'), cx = cv.getContext('2d');
const tip = document.getElementById('tip');
let T = {x: 20, y: 20, s: 24};           // pan/zoom transform
let sel = new Set();
const H = M.ny + 2;
const gx = x => T.x + x * T.s, gy = y => T.y + (H - 1 - y) * T.s;

function resize() {
  const m = document.getElementById('main');
  cv.width = m.clientWidth; cv.height = m.clientHeight; draw();
}
window.addEventListener('resize', resize);

function fit() {
  const m = document.getElementById('main');
  T.s = Math.min(m.clientWidth / (M.nx + 4), m.clientHeight / (H + 2));
  T.x = T.y = T.s; draw();
}

function wireXY(w) {                      // endpoints in canvas coords
  const f = (w.p + 1) / (M.W + 1);
  if (w.h) {
    const y = gy(w.y0) - 2 - f * (T.s * 0.35);
    return [gx(w.x0) + 2, y, gx(w.x1 + 1) - 2, y];
  }
  const x = gx(w.x0 + 1) - 2 - f * (T.s * 0.35);
  return [x, gy(w.y1) + 2, x, gy(w.y0 - 1) - 2];
}

function center(b) {
  return [gx(b.x) + T.s / 2, gy(b.y) + T.s / 2];
}

function draw() {
  cx.clearRect(0, 0, cv.width, cv.height);
  for (const [x, y, t] of M.tiles) {
    cx.fillStyle = M.fills[t] || '#eee';
    cx.fillRect(gx(x) + 1, gy(y) + 1, T.s - 2, T.s - 2);
    cx.strokeStyle = '#999'; cx.lineWidth = 0.5;
    cx.strokeRect(gx(x) + 1, gy(y) + 1, T.s - 2, T.s - 2);
  }
  const cong = el('Lcong').checked;
  if (el('Lwires').checked || cong) {
    for (const w of M.wires) {
      const [x0, y0, x1, y1] = wireXY(w);
      cx.lineWidth = 1;
      cx.strokeStyle = w.o > w.c ? '#c22'
        : cong ? 'rgba(200,80,0,' + Math.min(1, w.o / w.c) + ')'
               : '#2a2';
      cx.beginPath(); cx.moveTo(x0, y0); cx.lineTo(x1, y1); cx.stroke();
    }
  }
  if (el('Lblocks').checked && T.s > 14) {
    cx.fillStyle = '#333'; cx.font = (T.s / 3 | 0) + 'px sans-serif';
    for (const b of M.blocks)
      cx.fillText(b.n.slice(0, 8), gx(b.x) + 2,
                  gy(b.y) + T.s / 2 + b.z * (T.s / 3));
  }
  const fly = el('Lfly').checked;
  for (const ni of (fly ? M.nets.keys() : sel)) {
    const n = M.nets[ni];
    if (!n || n.g) continue;
    const isSel = sel.has(ni);
    if (!isSel && !fly) continue;
    // routed wires of the net
    if (isSel) for (const wi of n.w) {
      const [x0, y0, x1, y1] = wireXY(M.wires[wi]);
      cx.strokeStyle = '#06c'; cx.lineWidth = 3;
      cx.beginPath(); cx.moveTo(x0, y0); cx.lineTo(x1, y1); cx.stroke();
    }
    const [sxp, syp] = center(M.blocks[n.d]);
    for (const t of n.s) {
      const [txp, typ] = center(M.blocks[t]);
      cx.strokeStyle = isSel ? '#e60' : 'rgba(200,50,50,0.25)';
      cx.lineWidth = isSel ? 1.5 : 0.7;
      cx.beginPath(); cx.moveTo(sxp, syp); cx.lineTo(txp, typ);
      cx.stroke();
    }
  }
  cx.fillStyle = '#444';
  for (const b of M.blocks) {
    const [bx, by] = center(b);
    cx.beginPath(); cx.arc(bx, by, Math.max(2, T.s / 9), 0, 7);
    cx.fill();
  }
}

const el = id => document.getElementById(id);
for (const id of ['Lblocks', 'Lwires', 'Lcong', 'Lfly'])
  el(id).onchange = draw;
el('fit').onclick = fit;
el('clear').onclick = () => { sel.clear(); listNets(); draw(); };
el('worst').onclick = () => {
  let best = -1, bi = -1;
  M.nets.forEach((n, i) => { if (n.tm > best) { best = n.tm; bi = i; }});
  if (bi >= 0) { sel.clear(); sel.add(bi); listNets(); draw(); }
};

let drag = null;
cv.onmousedown = e => drag = [e.clientX - T.x, e.clientY - T.y];
window.onmouseup = () => drag = null;
cv.onmousemove = e => {
  if (drag) { T.x = e.clientX - drag[0]; T.y = e.clientY - drag[1];
              draw(); return; }
  hover(e);
};
cv.onwheel = e => {
  e.preventDefault();
  const k = e.deltaY < 0 ? 1.15 : 1 / 1.15;
  T.x = e.offsetX - (e.offsetX - T.x) * k;
  T.y = e.offsetY - (e.offsetY - T.y) * k;
  T.s *= k; draw();
};

function hover(e) {
  const x = Math.floor((e.offsetX - T.x) / T.s);
  const y = H - 1 - Math.floor((e.offsetY - T.y) / T.s);
  let txt = '', best = 3;                     // nearest wire within 3px
  for (const w of M.wires) {
    const [x0, y0, x1, y1] = wireXY(w);
    const d = w.h ? Math.abs(e.offsetY - y0) : Math.abs(e.offsetX - x0);
    const inSpan = w.h
      ? (e.offsetX >= x0 && e.offsetX <= x1)
      : (e.offsetY >= Math.min(y0, y1) && e.offsetY <= Math.max(y0, y1));
    if (d < best && inSpan) {
      best = d;
      txt = (w.h ? 'CHANX' : 'CHANY') + ' track ' + w.p +
            ' occ ' + w.o + '/' + w.c;
    }
  }
  if (!txt) {
    const bs = M.blocks.filter(b => b.x === x && b.y === y);
    if (bs.length) txt = bs.map(b => b.n + ' (' + b.t + ')').join(', ');
    else if (x >= 0 && x < M.nx + 2 && y >= 0 && y < M.ny + 2)
      txt = '(' + x + ',' + y + ')';
  }
  if (txt) { tip.style.display = 'block';
             tip.style.left = (e.offsetX + 14) + 'px';
             tip.style.top = (e.offsetY + 8) + 'px';
             tip.textContent = txt; }
  else tip.style.display = 'none';
}

function listNets() {
  const q = el('q').value.toLowerCase();
  const box = el('nets'); box.innerHTML = '';
  M.nets.forEach((n, i) => {
    if (q && !n.n.toLowerCase().includes(q)) return;
    const d = document.createElement('div');
    d.className = 'net' + (sel.has(i) ? ' sel' : '');
    d.textContent = n.n + (n.g ? ' [global]' : '') +
                    (n.tm ? ' ' + n.tm + 'ns' : '');
    d.onclick = () => { sel.has(i) ? sel.delete(i) : sel.add(i);
                        listNets(); draw(); };
    box.appendChild(d);
  });
}
el('q').oninput = listNets;

el('title').textContent = M.name;
el('stats').textContent =
  M.blocks.length + ' blocks, ' + M.nets.length + ' nets, ' +
  M.wires.length + ' routed wires' +
  (M.crit_ns ? ', crit path ' + M.crit_ns + ' ns' : '');
listNets(); resize(); fit();
</script></body></html>
"""


def write_interactive_html(flow, path: str) -> None:
    """graphics.c/draw.c interactive-viewer equivalent: one
    self-contained HTML file with pan/zoom, layer toggles, net
    highlighting, and hover inspection over the embedded model."""
    model = _flow_model(flow)
    # </script> inside JSON strings would terminate the script block
    blob = json.dumps(model, separators=(",", ":")).replace("</", "<\\/")
    with open(path, "w") as f:
        f.write(_PAGE.replace("__MODEL__", blob))
