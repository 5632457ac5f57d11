"""Placement delay-lookup matrices (the JAX package's
place/delay_lookup.py, routed with the port's Router).

Equivalent of the reference's timing_place_lookup.c:981
compute_delay_lookup_tables: the placer's timing model is "the delay of a
best-case route between two blocks depends only on (|dx|, |dy|)", captured
in small matrices by routing sample two-terminal nets over an *empty*
device.  Where the reference routes each sample net serially with the L5
router, here ALL sample nets (every offset of every source/sink kind pair)
are concatenated into one batched pure-delay route (criticality 0.99,
one iteration).

The four kind matrices (clb_clb, io_clb, clb_io, io_io — the reference's
delta_* tables) are exposed ONLY as one edge-padded stack [4, nx+2, ny+2];
both the host criticality path (conn_delay) and the annealer's device cost
(sa._conn_delay) index this same array, so the two timing views
cannot drift.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..rr.graph import RRGraph
from ..rr.terminals import NetTerminals
from ..route.router import Router, RouterOpts


@dataclass
class DelayLookup:
    """stack[kind, |dx|, |dy|]; kind: 0 clb->clb, 1 io->clb, 2 clb->io,
    3 io->io.  Shape [4, nx+2, ny+2], edge-padded where unsampled."""
    stack: np.ndarray

    def conn_delay(self, sx, sy, s_io, tx, ty, t_io):
        """Vectorized connection delay source -> sink (numpy arrays ok);
        the same select/clip the device kernel (sa._conn_delay) uses."""
        H, W = self.stack.shape[1], self.stack.shape[2]
        dx = np.minimum(np.abs(np.asarray(tx) - np.asarray(sx)), H - 1)
        dy = np.minimum(np.abs(np.asarray(ty) - np.asarray(sy)), W - 1)
        s_io = np.asarray(s_io)
        t_io = np.asarray(t_io)
        sel = np.where(s_io & t_io, 3,
                       np.where(s_io, 1, np.where(t_io, 2, 0)))
        return self.stack[sel, dx, dy].astype(np.float32)


def _route_samples(router: Router, rr: RRGraph, pairs) -> np.ndarray:
    """pairs: [(src_node, sink_node)].  One pure-delay batched route on
    the empty device -> delays (np.nan where unroutable)."""
    n = len(pairs)
    term = NetTerminals(
        net_ids=np.arange(n, dtype=np.int32),
        source=np.array([p[0] for p in pairs], dtype=np.int32),
        sinks=np.array([[p[1]] for p in pairs], dtype=np.int32),
        num_sinks=np.ones(n, dtype=np.int32),
        bb_xmin=np.zeros(n, dtype=np.int32),
        bb_xmax=np.full(n, rr.grid.nx + 1, dtype=np.int32),
        bb_ymin=np.zeros(n, dtype=np.int32),
        bb_ymax=np.full(n, rr.grid.ny + 1, dtype=np.int32),
    )
    crit = np.full((n, 1), 0.99, dtype=np.float32)
    res = router.route(term, crit=crit)
    d = res.sink_delay[:, 0].copy()
    d[~np.isfinite(d)] = np.nan
    return d


def _class_index(rr: RRGraph):
    """One pass over src_of/sink_of -> {(x, y): (z, class)} per kind."""
    drv, rcv = {}, {}
    for (x, y, z, k) in rr.src_of:
        drv.setdefault((x, y), (z, k))
    for (x, y, z, k) in rr.sink_of:
        rcv.setdefault((x, y), (z, k))
    return drv, rcv


def compute_delay_lookup(rr: RRGraph, opts: RouterOpts | None = None,
                         device="cuda") -> DelayLookup:
    """Build the stack.  The CLB sample source sits at (1, 1); IO sweeps
    run from TWO anchors — bottom edge (1, 0) and left edge (0, 1) — so
    both the dx=0 and dy=0 offset rows are really sampled (the reference
    sweeps source positions for irregular grids; an island grid is
    translation-invariant up to edge effects, timing_place_lookup.c
    setup_chan_width comments).  The sample route runs on ``device``, the
    card unless the caller asks for the CPU: there it launches the
    planes relaxation kernels at crit 0.99."""
    import dataclasses

    nx, ny = rr.grid.nx, rr.grid.ny
    opts = (dataclasses.replace(opts, max_router_iterations=1) if opts
            else RouterOpts(batch_size=256, max_router_iterations=1))
    router = Router(rr, opts, device=device)
    drv_of, rcv_of = _class_index(rr)

    def sink_node(x, y, z=None):
        zz, k = rcv_of[(x, y)]
        z = zz if z is None else z
        return rr.sink_of.get((x, y, z, k))

    def src_node(x, y):
        z, k = drv_of[(x, y)]
        return rr.src_of[(x, y, z, k)]

    clb_tiles = [(x, y) for x in range(1, nx + 1) for y in range(1, ny + 1)]
    io_tiles = rr.grid.io_sites()
    anchors = [(1, 0), (0, 1)]          # bottom edge, left edge

    # ---- assemble every sample as (kind, anchor, tile, src, sink) ----
    samples = []

    def add(kind, anchor, tiles, src):
        for t in tiles:
            samples.append((kind, anchor, t, src, sink_node(*t)))

    add(0, (1, 1), clb_tiles, src_node(1, 1))
    for a in anchors:
        add(1, a, clb_tiles, src_node(*a))
    add(2, (1, 1), io_tiles, src_node(1, 1))
    for a in anchors:
        add(3, a, [t for t in io_tiles if t != a], src_node(*a))
    # same-tile io -> io (dx=dy=0) through a second subtile, if any
    same_io = None
    if rr.grid.io_capacity > 1:
        s1 = sink_node(1, 0, z=1)
        if s1 is not None:
            same_io = len(samples)
            samples.append((3, (1, 0), (1, 0), src_node(1, 0), s1))

    delays = _route_samples(router, rr, [(s[3], s[4]) for s in samples])

    # ---- tally into the stack, best-case per (kind, |dx|, |dy|) ----
    H, W = nx + 2, ny + 2
    stack = np.zeros((4, H, W), dtype=np.float32)
    seen = np.zeros((4, H, W), dtype=bool)
    for (kind, anchor, (x, y), _, _), dd in zip(samples, delays):
        if not np.isfinite(dd):
            continue                    # unroutable sample: leave unsampled
        dx, dy = abs(x - anchor[0]), abs(y - anchor[1])
        if not seen[kind, dx, dy] or dd < stack[kind, dx, dy]:
            stack[kind, dx, dy] = dd
            seen[kind, dx, dy] = True
    if same_io is None:
        # single-occupancy io tiles: (0,0) unused; keep it harmless
        if not seen[3, 0, 0]:
            stack[3, 0, 0] = 0.0
            seen[3, 0, 0] = True
    if not seen.any(axis=(1, 2)).all():
        missing = [k for k in range(4) if not seen[k].any()]
        raise RuntimeError(
            f"delay lookup: no routable samples for kinds {missing}")
    for k in range(4):
        _fill(stack[k], seen[k])
    return DelayLookup(stack=stack)


def _fill(mat: np.ndarray, seen: np.ndarray) -> None:
    """Fill never-sampled offsets from the nearest sampled neighbor
    (row-major nearest-smaller fallback)."""
    H, W = mat.shape
    for dx in range(H):
        for dy in range(W):
            if not seen[dx, dy]:
                if dx and seen[dx - 1, dy]:
                    mat[dx, dy] = mat[dx - 1, dy]
                    seen[dx, dy] = True
                elif dy and seen[dx, dy - 1]:
                    mat[dx, dy] = mat[dx, dy - 1]
                    seen[dx, dy] = True
                elif dx and dy and seen[dx - 1, dy - 1]:
                    mat[dx, dy] = mat[dx - 1, dy - 1]
                    seen[dx, dy] = True
    # second pass for any leftovers (top-left corners etc.)
    fallback = mat[seen].max() if seen.any() else 0.0
    mat[~seen] = fallback
