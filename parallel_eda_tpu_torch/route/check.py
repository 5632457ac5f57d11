"""Post-route legality checker — the acceptance oracle.

Port of the *semantics* of vpr/SRC/route/check_route.c (check_route: every
net's traceback is connected, uses real rr-edges, reaches every sink) plus
the reference's per-iteration self-verification idea
(check_route_tree / recalculate_occ asserts,
partitioning_multi_sink_delta_stepping_route.cxx:6199-6222): occupancy is
re-derived from scratch and compared against the router's running counts.

Host-side numpy on purpose: the checker must be an independent
implementation from the device router it checks.

Path representation: paths[r, s] is the sink->tree segment produced by the
incremental router — it ends on a node of the net's already-routed tree
(the SOURCE for the first sink).  The union of a net's segments must form a
directed tree rooted at the SOURCE reaching every sink.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..rr.graph import CHANX, CHANY, RRGraph, SINK, SOURCE
from ..rr.terminals import NetTerminals


class RouteError(AssertionError):
    pass


def _edge_key_set(rr: RRGraph) -> set:
    """Edge set for O(1) membership: key = src * N + dst."""
    N = rr.num_nodes
    src_ids = np.repeat(np.arange(N, dtype=np.int64), np.diff(rr.out_row_ptr))
    return set((src_ids * N + rr.out_dst).tolist())


def check_route(rr: RRGraph, term: NetTerminals, paths: np.ndarray,
                occ: Optional[np.ndarray] = None) -> dict:
    """paths [R, Smax, L] int32 (sentinel == num_nodes).  Raises RouteError
    on any violation; returns stats dict."""
    N = rr.num_nodes
    R, Smax, L = paths.shape
    edge_keys = _edge_key_set(rr)

    recomputed_occ = np.zeros(N, dtype=np.int64)
    total_wire = 0

    for r in range(R):
        source = int(term.source[r])
        ns = int(term.num_sinks[r])
        sink_set = set(int(x) for x in term.sinks[r, :ns])
        # parent[child] = parent node in the tree (toward source)
        parent = {}
        used = {source}
        for s in range(ns):
            sink = int(term.sinks[r, s])
            p = paths[r, s]
            p = p[p < N]
            if p.size == 0:
                raise RouteError(f"net {r} sink {s}: no path")
            if int(p[0]) != sink:
                raise RouteError(
                    f"net {r} sink {s}: segment starts at "
                    f"{rr.describe(p[0])}, expected sink {rr.describe(sink)}")
            for k in range(len(p) - 1):
                child, par = int(p[k]), int(p[k + 1])
                # rr-edge direction: parent -> child
                if par * N + child not in edge_keys:
                    raise RouteError(
                        f"net {r} sink {s}: no rr-edge "
                        f"{rr.describe(par)} -> {rr.describe(child)}")
                if child in parent and parent[child] != par:
                    raise RouteError(
                        f"net {r}: node {rr.describe(child)} has two "
                        f"parents {rr.describe(parent[child])} and "
                        f"{rr.describe(par)}")
                parent[child] = par
                used.add(child)
                used.add(par)

        # the union must be a tree rooted at source reaching all sinks
        children = {}
        for c, par in parent.items():
            children.setdefault(par, []).append(c)
        seen = {source}
        dq = deque([source])
        while dq:
            v = dq.popleft()
            for c in children.get(v, ()):
                if c not in seen:
                    seen.add(c)
                    dq.append(c)
        if used - seen:
            stray = next(iter(used - seen))
            raise RouteError(
                f"net {r}: {len(used - seen)} tree nodes not connected to "
                f"source, e.g. {rr.describe(stray)}")
        for sk in sink_set:
            if sk not in seen:
                raise RouteError(
                    f"net {r}: sink {rr.describe(sk)} not connected")

        for v in used:
            t = rr.node_type[v]
            if t == SINK and v not in sink_set:
                raise RouteError(f"net {r} routes through foreign sink {v}")
            if t == SOURCE and v != source:
                raise RouteError(f"net {r} routes through foreign source {v}")
            recomputed_occ[v] += 1
            if t in (CHANX, CHANY):
                total_wire += 1

    over = recomputed_occ - np.asarray(rr.capacity, dtype=np.int64)
    if (over > 0).any():
        worst = int(np.argmax(over))
        raise RouteError(
            f"{int((over > 0).sum())} overused nodes, worst "
            f"{rr.describe(worst)} occ {recomputed_occ[worst]} "
            f"cap {int(rr.capacity[worst])}")

    if occ is not None:
        if not np.array_equal(recomputed_occ,
                              np.asarray(occ, dtype=np.int64)):
            bad = np.where(recomputed_occ != occ)[0][:5]
            raise RouteError(
                f"occupancy drift at nodes {bad.tolist()} "
                f"(recomputed {recomputed_occ[bad].tolist()} vs "
                f"router {np.asarray(occ)[bad].tolist()})")

    return {"wirelength": total_wire,
            "max_occ": int(recomputed_occ.max(initial=0))}


def check_route_trees(rr: RRGraph, term: NetTerminals, trees,
                      occ: Optional[np.ndarray] = None) -> dict:
    """Same oracle for tree-form routings: trees[r] = [(node, parent),...]
    in tree order, SOURCE first with parent -1 (the .route-file payload
    and the serial reference router's output)."""
    N = rr.num_nodes
    R = term.source.shape[0]
    if len(trees) != R:
        raise RouteError(f"{len(trees)} trees for {R} nets")
    edge_keys = _edge_key_set(rr)
    recomputed_occ = np.zeros(N, dtype=np.int64)
    total_wire = 0
    for r, rows in enumerate(trees):
        source = int(term.source[r])
        ns = int(term.num_sinks[r])
        sink_set = set(int(x) for x in term.sinks[r, :ns])
        if not rows or rows[0][0] != source or rows[0][1] != -1:
            raise RouteError(f"net {r}: tree must start at its SOURCE")
        seen = {source}
        for node, par in rows[1:]:
            if par not in seen:
                raise RouteError(
                    f"net {r}: parent {par} of {rr.describe(node)} not yet "
                    f"in tree (rows out of order or disconnected)")
            if node in seen:
                raise RouteError(f"net {r}: node {node} added twice")
            if par * N + node not in edge_keys:
                raise RouteError(f"net {r}: no rr-edge "
                                 f"{rr.describe(par)} -> {rr.describe(node)}")
            seen.add(node)
        for sk in sink_set:
            if sk not in seen:
                raise RouteError(
                    f"net {r}: sink {rr.describe(sk)} not connected")
        for v in seen:
            t = rr.node_type[v]
            if t == SINK and v not in sink_set:
                raise RouteError(f"net {r} routes through foreign sink {v}")
            if t == SOURCE and v != source:
                raise RouteError(f"net {r} routes through foreign source {v}")
            recomputed_occ[v] += 1
            if t in (CHANX, CHANY):
                total_wire += 1
    over = recomputed_occ - np.asarray(rr.capacity, dtype=np.int64)
    if (over > 0).any():
        raise RouteError(f"{int((over > 0).sum())} overused nodes")
    if occ is not None and not np.array_equal(
            recomputed_occ, np.asarray(occ, dtype=np.int64)):
        raise RouteError("occupancy drift vs router counts")
    return {"wirelength": total_wire,
            "max_occ": int(recomputed_occ.max(initial=0))}
