"""Molecule-to-pb-tree assignment + route-based cluster legality.

The packing-time half of the multi-mode pb_type subsystem (pb_type.py
holds the tree model and the pin-graph router).  Mirrors the
reference's split: cluster.c picks WHAT goes into a cluster (seed-grow
attraction), cluster_legality.c decides WHETHER the candidate cluster
is legal by choosing modes and detail-routing it
(vpr/SRC/pack/cluster_legality.c alloc_and_load_legalizer /
try_breadth_first_route_cluster).  The flat-crossbar fast path
(packer.cluster_routable) remains for arches without a pb tree.

Model restriction (documented, checked): the root pb_type has one mode
whose children are the SLOT array (e.g. 10 fracturable BLEs); slots
carry the mode choices; slot-mode children are leaves
(.names / .latch).  This covers the fracturable-LUT class of archs
(k6_frac-style) that motivates the subsystem; deeper nesting raises.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from .pb_type import PbType, build_pb_graph, route_cluster

_IDX = re.compile(r"\[(\d+)\]$")


def _slots(tree: PbType) -> List[Tuple[PbType, str]]:
    if len(tree.modes) != 1:
        raise ValueError(
            f"pb tree {tree.name}: the root must have exactly one mode "
            f"(the slot array); got {[m.name for m in tree.modes]}")
    out = []
    for c in tree.modes[0].children:
        for k in range(c.num_pb):
            out.append((c, f"{tree.name}/{c.name}[{k}]"))
    return out


def _mode_leaves(pbt: PbType, mi: int, path: str):
    """(luts [(leaf path, input width)], ffs [leaf path]) of slot
    ``path`` under mode mi."""
    luts: List[Tuple[str, int]] = []
    ffs: List[str] = []
    for c in pbt.modes[mi].children:
        if not c.is_leaf:
            raise ValueError(
                f"pb tree: slot mode {pbt.name}.{pbt.modes[mi].name} "
                f"has non-leaf child {c.name} (unsupported nesting)")
        for k in range(c.num_pb):
            p = f"{path}/{c.name}[{k}]"
            if c.blif_model == ".names":
                luts.append((p, c.input_width()))
            elif c.blif_model == ".latch":
                ffs.append(p)
            # other leaf kinds are inert for LUT/FF molecules
    return luts, ffs


def _paired_ff(lut_path: str, free_ffs: List[str]) -> Optional[str]:
    """Prefer the FF with the lut's instance index (the interconnect's
    usual lut[k].out -> ff[k].D pairing); the router re-checks."""
    m = _IDX.search(lut_path)
    if m:
        want = f"[{m.group(1)}]"
        for f in free_ffs:
            if f.endswith(want):
                return f
    return free_ffs[0] if free_ffs else None


def assign_molecules(bles, members, clocks, tree: PbType):
    """Greedy molecule -> leaf assignment with per-slot mode choice.

    Returns (mode_sel {slot path: mode index},
             {ble index: (lut leaf | None, ff leaf | None)}) or None
    when the molecules cannot fit any mode combination this greedy
    explores (largest-fanin first; minimal fitting mode per slot)."""
    slots = _slots(tree)
    # per-slot: chosen mode index + set of used leaf paths
    st_mode: List[Optional[int]] = [None] * len(slots)
    st_used: List[Set[str]] = [set() for _ in slots]
    assign: Dict[int, Tuple[Optional[str], Optional[str]]] = {}

    def fanin(m) -> int:
        b = bles[m]
        if b.lut is None:
            return 0
        return len([n for n in b.inputs if n not in clocks])

    for m in sorted(members, key=lambda m: (-fanin(m), m)):
        b = bles[m]
        fan = fanin(m)
        placed = False
        # pass 1: partially-filled slots (keep clusters dense); pass 2:
        # empty slots choosing the minimal mode that fits
        for empty_pass in (False, True):
            for si, (pbt, path) in enumerate(slots):
                if (st_mode[si] is None) != empty_pass:
                    continue
                mode_order = ([st_mode[si]] if st_mode[si] is not None
                              else sorted(
                                  range(len(pbt.modes)),
                                  key=lambda mi: max(
                                      [w for _, w in
                                       _mode_leaves(pbt, mi, path)[0]]
                                      or [0])))
                for mi in mode_order:
                    luts, ffs = _mode_leaves(pbt, mi, path)
                    used = st_used[si]
                    free_luts = [(p, w) for p, w in luts
                                 if p not in used and w >= fan]
                    free_ffs = [p for p in ffs if p not in used]
                    if b.lut is not None and not free_luts:
                        continue
                    if b.ff is not None and not free_ffs:
                        continue
                    lp = None
                    fp = None
                    if b.lut is not None:
                        lp = min(free_luts, key=lambda t: t[1])[0]
                    if b.ff is not None:
                        fp = (_paired_ff(lp, free_ffs) if lp
                              else free_ffs[0])
                    st_mode[si] = mi
                    if lp:
                        used.add(lp)
                    if fp:
                        used.add(fp)
                    assign[m] = (lp, fp)
                    placed = True
                    break
                if placed:
                    break
            if placed:
                break
        if not placed:
            return None
    mode_sel = {slots[si][1]: st_mode[si]
                for si in range(len(slots)) if st_mode[si] is not None}
    return mode_sel, assign


def pb_cluster_feasible(bles, members, clocks, arch,
                        consumers=None, ext_nets=None) -> bool:
    """Drop-in for packer.cluster_routable when arch.pb_tree is set:
    assign molecules to leaves (mode choice) and detail-route the
    cluster through the chosen modes' interconnect.

    ``consumers`` (net -> BLE indices) + ``ext_nets`` (nets consumed by
    pads/hard blocks): when given, nets produced in-cluster but needed
    OUTSIDE it must also reach a free cluster output pin (want_out) —
    the output-capacity half of the legality contract."""
    tree: PbType = arch.pb_tree
    got = assign_molecules(bles, members, clocks, tree)
    if got is None:
        return False
    mode_sel, assign = got
    g = build_pb_graph(tree, mode_sel)

    def lut_in_pins(leaf: str) -> List[int]:
        c = g.leaves[leaf]
        port = next(p for p in c.ports if p.dir == "input")
        return [g.pin(leaf, port.name, b) for b in range(port.width)]

    def out_pin(leaf: str) -> int:
        c = g.leaves[leaf]
        port = next(p for p in c.ports if p.dir == "output")
        return g.pin(leaf, port.name, 0)

    def ff_d_pin(leaf: str) -> int:
        c = g.leaves[leaf]
        port = next(p for p in c.ports if p.dir == "input")
        return g.pin(leaf, port.name, 0)

    member_set = set(members)
    produced = {bles[m].output: m for m in member_set}
    signals: List[dict] = []
    # net -> consumers' sink specs inside the cluster
    net_sink_sets: Dict[str, List[List[int]]] = {}
    net_sinks: Dict[str, List[int]] = {}
    for m in member_set:
        b = bles[m]
        lp, fp = assign[m]
        if b.lut is not None:
            for n in b.inputs:
                if n in clocks:
                    continue
                net_sink_sets.setdefault(n, []).append(lut_in_pins(lp))
        else:
            # lone FF: its D input is a fixed pin
            for n in b.inputs:
                if n in clocks:
                    continue
                net_sinks.setdefault(n, []).append(ff_d_pin(fp))
        if b.lut is not None and b.ff is not None:
            # absorbed LUT->FF connection, invisible outside the BLE
            signals.append({"source": out_pin(lp),
                            "sinks": [ff_d_pin(fp)]})

    def needed_outside(n: str) -> bool:
        if consumers is None and ext_nets is None:
            return False
        if ext_nets is not None and n in ext_nets:
            return True
        return any(c not in member_set
                   for c in (consumers or {}).get(n, ()))

    nets = sorted(set(net_sink_sets) | set(net_sinks)
                  | {n for n in produced if needed_outside(n)})
    for n in nets:
        src = None
        want_out = False
        if n in produced:
            m = produced[n]
            lp, fp = assign[m]
            src = out_pin(fp) if bles[m].ff is not None else out_pin(lp)
            want_out = needed_outside(n)
        signals.append({"source": src,
                        "sinks": net_sinks.get(n, []),
                        "sink_sets": net_sink_sets.get(n, []),
                        "want_out": want_out})
    return route_cluster(g, signals) is not None


def validate_pb_tree(tree: PbType) -> None:
    """Fail fast at arch-load time: structure (pb_capacity) AND every
    mode's interconnect specs (a typo'd instance/port or a direct width
    mismatch must surface as a load-time warning + flat-model fallback,
    not a crash mid-pack).  Builds the pin graph once per slot-mode
    index, which expands every interconnect expression."""
    slots = _slots(tree)
    # every slot mode's leaf structure (raises on unsupported nesting,
    # e.g. VTR's fle -> ble6 indirection) ...
    pb_capacity(tree)
    # ... and every mode's interconnect expansion
    n_modes = max(len(pbt.modes) for pbt, _ in slots) if slots else 0
    for mi in range(n_modes):
        sel = {path: min(mi, len(pbt.modes) - 1)
               for pbt, path in slots}
        build_pb_graph(tree, sel)


def pb_capacity(tree: PbType) -> int:
    """Upper bound on molecules per cluster (growth-loop bound)."""
    cap = 0
    for pbt, path in _slots(tree):
        best = 1
        for mi in range(len(pbt.modes)):
            luts, ffs = _mode_leaves(pbt, mi, path)
            best = max(best, max(len(luts), len(ffs)))
        cap += best
    return cap
