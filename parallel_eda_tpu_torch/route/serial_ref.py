"""Serial host-CPU PathFinder — the measurement baseline and oracle (the
port's copy of the JAX package's route/serial_ref.py).

An independent, heap-based serial implementation of negotiated-congestion
routing with the semantics of the reference's serial baseline
(vpr/SRC/route/route_timing.c:85 try_timing_driven_route: per-net rip-up,
per-sink Dijkstra grown from the partial route tree, present/history cost
update per iteration): same rr-graph, same cost model, same convergence
criterion, pure host code with a binary heap in double arithmetic — no
batching, no device.  It is the one route module of the port without a
device path, as in the JAX package.

It is deliberately a different *algorithm shape* than the device router
(sequential best-first search vs batched pull relaxation), which makes
agreement between the two a strong cross-check: both must produce legal
routings of equal quality class on the same problem.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..rr.graph import CHANX, CHANY, RRGraph
from ..rr.terminals import NetTerminals


@dataclass
class SerialRouteResult:
    success: bool
    iterations: int
    # per net: list of (node, parent_node) in tree order, SOURCE first
    trees: List[List[tuple]]
    occ: np.ndarray
    wirelength: int
    route_time_s: float = 0.0
    heap_pops: int = 0           # perf_t.num_heap_pops analogue
    stats: List[dict] = field(default_factory=list)
    # route() stopped at its deadline_s budget (bench lower-bound mode)
    timed_out: bool = False


def tree_order(rows):
    """Re-order (node, parent) rows into TREE order — SOURCE first,
    every parent before its children (the SerialRouteResult contract;
    consumers like qor.serial_sink_delays accumulate delays in one
    forward pass).  Input rows must contain a (src, -1) root."""
    if not rows:
        return []
    out = [rows[0]]
    seen = {rows[0][0]}
    pending = [rv for rv in rows[1:]]
    while pending:
        rest = []
        progressed = False
        for v, pnode in pending:
            if pnode in seen:
                out.append((v, pnode))
                seen.add(v)
                progressed = True
            else:
                rest.append((v, pnode))
        if not progressed:
            break
        pending = rest
    return out


class SerialRouter:
    """Host serial PathFinder over the shared RRGraph arrays."""

    def __init__(self, rr: RRGraph,
                 max_iterations: int = 50,
                 initial_pres_fac: float = 0.5,
                 pres_fac_mult: float = 1.3,
                 acc_fac: float = 1.0,
                 max_pres_fac: float = 1000.0,
                 astar_fac: float = 1.2):
        from .device_graph import delay_normalization

        self.rr = rr
        self.max_iterations = max_iterations
        self.initial_pres_fac = initial_pres_fac
        self.pres_fac_mult = pres_fac_mult
        self.acc_fac = acc_fac
        self.max_pres_fac = max_pres_fac
        self.astar_fac = astar_fac
        # flat out-CSR copies for fast python access
        self.row = rr.out_row_ptr
        self.dst = rr.out_dst
        # per-edge delay on the OUT csr (switch Tdel + C_dst load), the
        # same model device_graph.to_device builds for in-edges
        sw = rr.out_switch.astype(np.int64)
        self.edge_delay = (rr.switch_Tdel[sw]
                           + rr.C[rr.out_dst]
                           * (rr.switch_R[sw] + 0.5 * rr.R[rr.out_dst])
                           ).astype(np.float64)
        # same delay-normalised congestion scale as the device router
        # (device_graph.to_device), so the two cost models are identical
        self.norm = float(delay_normalization(rr))
        self.base = rr.base_cost.astype(np.float64) * self.norm
        self.cap = rr.capacity.astype(np.int64)
        # A* lookahead (route_timing.c:693 get_timing_driven_expected_cost
        # / parallel_route/router.cxx:445): per-cost-index same/ortho
        # segment tables (see route/lookahead.py); non-wire nodes fall
        # back to the flat per-tile floor
        from .device_graph import wire_cost_floor
        from .lookahead import build_lookahead

        self.min_wire_cost, self.min_wire_delay, self.lmax = \
            wire_cost_floor(rr)
        self.la = build_lookahead(rr)

    def route(self, term: NetTerminals,
              crit: Optional[np.ndarray] = None,
              deadline_s: Optional[float] = None) -> SerialRouteResult:
        """``deadline_s``: optional wall budget — when exceeded the run
        stops and returns with timed_out=True (the bench uses the
        elapsed time as a LOWER BOUND on the serial wall-clock)."""
        rr = self.rr
        N = rr.num_nodes
        R = term.sinks.shape[0]
        occ = np.zeros(N, dtype=np.int64)
        acc = np.ones(N, dtype=np.float64)
        trees: List[dict] = [dict() for _ in range(R)]  # node -> parent
        pres_fac = self.initial_pres_fac
        pops = 0
        t0 = time.time()
        res = SerialRouteResult(False, 0, [], occ, 0)

        # per-net bounding boxes (route.h:70-165 semantics)
        bbs = np.stack([term.bb_xmin, term.bb_xmax,
                        term.bb_ymin, term.bb_ymax], axis=1)

        for it in range(1, self.max_iterations + 1):
            if it == 1:
                reroute = list(range(R))
            else:
                over_set = occ > self.cap
                reroute = [i for i in range(R)
                           if any(over_set[v] for v in trees[i])]
            for ri, i in enumerate(reroute):
                if (deadline_s is not None and (ri & 7) == 0
                        and time.time() - t0 > deadline_s):
                    res.timed_out = True
                    break
                # rip up (pathfinder_update_one_cost -1)
                for v in trees[i]:
                    occ[v] -= 1
                trees[i] = self._route_net(i, term, occ, acc, pres_fac,
                                           bbs, crit)
                for v in trees[i]:
                    occ[v] += 1
                pops += self._last_pops
            if res.timed_out:
                res.iterations = it
                break
            over = np.maximum(0, occ - self.cap)
            n_over = int((over > 0).sum())
            res.stats.append({"iteration": it, "overused": n_over,
                              "heap_pops": pops,
                              "rerouted": len(reroute)})
            if n_over == 0:
                res.success = True
                res.iterations = it
                break
            acc += self.acc_fac * over
            pres_fac = min(self.max_pres_fac, pres_fac * self.pres_fac_mult)
        else:
            res.iterations = self.max_iterations

        res.route_time_s = time.time() - t0
        res.heap_pops = pops
        res.occ = occ
        # tree order output (shared helper; also used by the native
        # C++ binding, serial_native.py)
        out_trees: List[List[tuple]] = []
        for i in range(R):
            rows = [(int(term.source[i]), -1)] + \
                [(v, p) for v, p in trees[i].items() if p != -1]
            out_trees.append(tree_order(rows))
        res.trees = out_trees
        wire = (rr.node_type == CHANX) | (rr.node_type == CHANY)
        used = np.zeros(N, dtype=bool)
        for t in trees:
            for v in t:
                used[v] = True
        res.wirelength = int((used & wire).sum())
        return res

    def _route_net(self, i: int, term: NetTerminals, occ, acc,
                   pres_fac: float, bbs, crit) -> dict:
        """Incremental multi-sink A* (route_timing.c:399
        timing_driven_route_net + :693 expected-cost lookahead): seed with
        the growing tree, route each remaining sink (most critical
        first), merge, repeat."""
        rr = self.rr
        N = rr.num_nodes
        src = int(term.source[i])
        ns = int(term.num_sinks[i])
        sinks = [int(term.sinks[i, s]) for s in range(ns)]
        tree = {src: -1}
        self._last_pops = 0
        bb = bbs[i]
        xlo, xhi_b, ylo, yhi_b = (int(bb[0]), int(bb[1]),
                                  int(bb[2]), int(bb[3]))
        xlow, xhigh = rr.xlow, rr.xhigh
        ylow, yhigh = rr.ylow, rr.yhigh
        row, dst = self.row, self.dst
        la = self.la
        ax, ls, lo = la.axis, la.len_same, la.len_ortho
        tls, tlo = la.tlin_same, la.tlin_ortho
        td = la.term_delay
        af, mwc = self.astar_fac, self.min_wire_cost
        mwd = self.min_wire_delay
        # per-node congestion cost for this net's view (vector once per
        # net, not per pop): occ already excludes this net (caller ripped)
        over = occ + 1 - self.cap
        pres = np.where(over > 0, 1.0 + over * pres_fac, 1.0)
        cong = self.base * pres * acc

        # sink order: most critical first, then nearest-to-source
        order = sorted(range(ns),
                       key=lambda s: (-(float(crit[i, s]) if crit is not None
                                        else 0.0),
                                      abs(int(xlow[sinks[s]]) - int(xlow[src]))
                                      + abs(int(ylow[sinks[s]])
                                            - int(ylow[src]))))
        remaining = [sinks[s] for s in order]
        cws = [float(crit[i, order[k]]) if crit is not None else 0.0
               for k in range(ns)]

        dist = np.full(N, np.inf)
        prev = np.full(N, -1, dtype=np.int64)
        full_bb = (0, rr.grid.nx + 1, 0, rr.grid.ny + 1)
        k = 0
        while k < len(remaining):
            target = remaining[k]
            cw = cws[k]
            tx, ty = int(xlow[target]), int(ylow[target])

            def hcost(u):
                """Expected remaining cost (route_timing.c:693-760 /
                router.cxx:445-640 semantics; lookahead.py tables).
                The DELAY term uses the per-cost-index same/ortho
                segment counts (the reference's T_linear tables); the
                CONGESTION term keeps the flat admissible per-tile
                floor — measured on placed 300/1200-LUT fixtures, the
                per-class congestion term bought no pops (1.03-1.12x)
                and cost 4% wirelength, while the delay term alone cuts
                timing-driven pops 3.5-5x.  At crit=0 this reduces
                bit-for-bit to the round-3 heuristic.  Operation order
                matches native/serial_route.cc bit-for-bit."""
                man = abs(int(xlow[u]) - tx) + abs(int(ylow[u]) - ty)
                if ax[u] == 2:
                    return af * (cw * (man * mwd)
                                 + (1.0 - cw) * (man * mwc))
                dx = max(int(xlow[u]) - tx, tx - int(xhigh[u]), 0)
                dy = max(int(ylow[u]) - ty, ty - int(yhigh[u]), 0)
                if ax[u] == 0:
                    dsame, dortho = dx, dy
                else:
                    dsame, dortho = dy, dx
                nsame = (dsame + int(ls[u]) - 1) // int(ls[u])
                northo = (dortho + int(lo[u]) - 1) // int(lo[u])
                hd = nsame * float(tls[u]) + northo * float(tlo[u]) + td
                return af * (cw * hd + (1.0 - cw) * (man * mwc))

            dist[:] = np.inf
            prev[:] = -1
            heap = []
            for v in tree:
                dist[v] = 0.0
                heapq.heappush(heap, (hcost(v), v))
            found = False
            while heap:
                f, v = heapq.heappop(heap)
                self._last_pops += 1
                if v == target:
                    found = True
                    break
                dv = dist[v]
                for e in range(row[v], row[v + 1]):
                    u = int(dst[e])
                    if not (xlo <= xlow[u] and xhigh[u] <= xhi_b
                            and ylo <= ylow[u] and yhigh[u] <= yhi_b):
                        continue
                    nd = dv + cw * self.edge_delay[e] + (1.0 - cw) * cong[u]
                    if nd < dist[u]:
                        dist[u] = nd
                        prev[u] = v
                        heapq.heappush(heap, (nd + hcost(u), u))
            if not found:
                # bb too tight: retry this sink with the full device and
                # keep the widened box for later reroutes of this net
                if (xlo, xhi_b, ylo, yhi_b) != full_bb:
                    xlo, xhi_b, ylo, yhi_b = full_bb
                    bbs[i] = full_bb
                    continue
                raise RuntimeError(
                    f"net {i}: sink unreachable even on full device")
            v = target
            while v not in tree:
                tree[v] = int(prev[v])
                v = int(prev[v])
            k += 1
        return tree
