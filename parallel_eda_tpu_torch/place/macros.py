"""Placement macros (carry chains): a copy of the JAX package's
place/macros.py (host numpy).

Equivalent of the reference's ``place_macro.c``: arithmetic
carry chains must stay physically adjacent (the fast carry interconnect
is vertical and nearest-neighbor), so chained blocks form a MACRO that
is placed as a rigid vertical unit and moved as one.

Formation: the netlist's carry-chain annotations (primitive name chains,
netlist.LogicalNetlist.carry_chains — synthesized circuits record them;
the reference derives them from arch <direct> carry ports) are lifted to
the cluster level: consecutive distinct clusters along a chain become a
macro.  A cluster joins at most one macro (first chain wins, matching
alloc_and_load_placement_macros' one-macro-per-block rule).

The placer then (a) aligns macros into vertical runs at initial
placement and (b) moves them rigidly with pairwise swaps against
displaced single blocks (place/sa.py macro_step)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..netlist.netlist import LogicalNetlist
from ..netlist.packed import PackedNetlist
from ..rr.grid import DeviceGrid


def form_macros(nl: LogicalNetlist, pnl: PackedNetlist) -> List[List[int]]:
    """Cluster-level macros from the netlist's carry chains.

    Returns ordered block-id chains (length >= 2); every block id
    appears in at most one macro."""
    if not getattr(nl, "carry_chains", None):
        return []
    prim_idx: Dict[str, int] = {p.name: i
                                for i, p in enumerate(nl.primitives)}
    cluster_of_prim: Dict[int, int] = {}
    for bi, b in enumerate(pnl.blocks):
        for p in (b.prims or []):
            cluster_of_prim[p] = bi

    used = set()
    macros: List[List[int]] = []
    for chain in nl.carry_chains:
        seq: List[int] = []
        for name in chain:
            pi = prim_idx.get(name)
            if pi is None:
                continue
            ci = cluster_of_prim.get(pi)
            if ci is None:
                continue
            if not seq or seq[-1] != ci:
                seq.append(ci)
        seq = [c for c in seq if c not in used]
        # drop consecutive dups again after filtering
        dedup: List[int] = []
        for c in seq:
            if not dedup or dedup[-1] != c:
                dedup.append(c)
        if len(dedup) >= 2:
            macros.append(dedup)
            used.update(dedup)
    return macros


def align_initial(pnl: PackedNetlist, grid: DeviceGrid, pos: np.ndarray,
                  macros: List[List[int]]) -> np.ndarray:
    """Rearrange an initial placement so every macro occupies a vertical
    run (x, y..y+L-1) of CLB sites; blocks displaced from those sites
    take the macro members' old sites.  Pure permutation of the CLB
    sites, so legality is preserved (initial_placement +
    place_macro.c's initial macro placement)."""
    pos = pos.astype(np.int64).copy()
    clb_cols = [x for x in range(1, grid.nx + 1)
                if grid.interior_type_name(x) == "clb"]
    # site occupancy map for interior CLB sites
    occ: Dict[tuple, int] = {}
    for b in range(len(pos)):
        x, y, z = pos[b]
        if 1 <= x <= grid.nx and 1 <= y <= grid.ny:
            occ[(int(x), int(y))] = b

    in_macro = {b for m in macros for b in m}
    for m in sorted(macros, key=len, reverse=True):
        L = len(m)
        placed = False
        for x in clb_cols:
            for y0 in range(1, grid.ny - L + 2):
                run = [(x, y0 + i) for i in range(L)]
                # target run must not contain OTHER macros' members
                if any(occ.get(s) in in_macro and occ.get(s) not in m
                       for s in run):
                    continue
                # swap members into the run; displaced singles take the
                # members' old sites pairwise
                for i, b in enumerate(m):
                    s_new = run[i]
                    cur = occ.get(s_new)
                    if cur == b:
                        continue
                    old = (int(pos[b, 0]), int(pos[b, 1]))
                    if cur is not None:
                        pos[cur, 0], pos[cur, 1] = old
                        occ[old] = cur
                    elif old in occ and occ[old] == b:
                        del occ[old]
                    pos[b, 0], pos[b, 1] = s_new
                    occ[s_new] = b
                placed = True
                break
            if placed:
                break
        if not placed:
            # crowded or short grid: leave this macro unaligned rather
            # than abort (it simply won't get macro moves)
            import warnings

            warnings.warn(f"no vertical run of {L} CLB sites for a "
                          f"macro; leaving it unaligned")
    return pos.astype(pos.dtype)
