"""Multi-mode pb_type trees + route-based intra-cluster legality.

Equivalent of the reference's hierarchical complex-block model and its
packing-time detail router:

- <pb_type>/<mode>/<interconnect> parsing:
  libarchfpga/read_xml_arch_file.c:2528 (ProcessPb_Type /
  ProcessMode / ProcessInterconnect) — a pb_type either names a leaf
  primitive (blif_model) or carries one or more modes, each mode holding
  child pb_type arrays plus the interconnect (complete / direct / mux)
  wiring them;
- intra-cluster legality: vpr/SRC/pack/cluster_legality.c
  (alloc_and_load_legalizer / try_breadth_first_route_cluster) — the
  reference detail-routes every candidate cluster through the pb graph
  of the chosen modes.  Here the same contract is met with a
  pin-exclusive tree-growth router over the expanded pb-pin graph: each
  net claims pins (a mux output pin can carry one signal, which
  subsumes mux select exclusivity), sources are fixed leaf outputs or
  any free cluster input bit, sinks are fixed leaf inputs or any free
  cluster output bit.

Host-only, like the rest of the packing layer (pointer-chasing over
tiny graphs).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class PbPort:
    name: str
    width: int
    dir: str                    # "input" | "output" | "clock"


@dataclass
class PbIc:
    """One <interconnect> element: kind in complete/direct/mux."""
    kind: str
    inputs: List[str]           # port specs (mux: one option per spec)
    output: str
    name: str = ""


@dataclass
class PbMode:
    name: str
    children: List["PbType"] = field(default_factory=list)
    interconnect: List[PbIc] = field(default_factory=list)


@dataclass
class PbType:
    name: str
    num_pb: int = 1
    ports: List[PbPort] = field(default_factory=list)
    blif_model: Optional[str] = None    # leaf primitive class
    modes: List[PbMode] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return self.blif_model is not None

    def port(self, name: str) -> PbPort:
        for p in self.ports:
            if p.name == name:
                return p
        raise KeyError(f"{self.name} has no port {name!r}")

    def input_width(self) -> int:
        return sum(p.width for p in self.ports if p.dir == "input")


def parse_pb_type(elem: ET.Element) -> PbType:
    """Recursive <pb_type> parse (ProcessPb_Type semantics).  Children
    given without an explicit <mode> wrapper form one default mode named
    after the pb_type itself, exactly like the reference."""
    pb = PbType(name=elem.attrib["name"],
                num_pb=int(elem.attrib.get("num_pb", 1)),
                blif_model=elem.attrib.get("blif_model"))
    for tag, d in (("input", "input"), ("output", "output"),
                   ("clock", "clock")):
        for p in elem.findall(tag):
            pb.ports.append(PbPort(p.attrib["name"],
                                   int(p.attrib.get("num_pins", 1)), d))
    mode_elems = elem.findall("mode")
    if mode_elems:
        for m in mode_elems:
            pb.modes.append(_parse_mode(m, m.attrib["name"]))
    else:
        child_pbs = elem.findall("pb_type")
        if child_pbs:
            pb.modes.append(_parse_mode(elem, pb.name))
    if pb.blif_model is None and not pb.modes:
        raise ValueError(f"pb_type {pb.name}: neither blif_model nor "
                         f"children (read_xml_arch_file.c:2528 contract)")
    return pb


def _parse_mode(elem: ET.Element, name: str) -> PbMode:
    mode = PbMode(name=name)
    for c in elem.findall("pb_type"):
        mode.children.append(parse_pb_type(c))
    ic = elem.find("interconnect")
    if ic is not None:
        for e in ic:
            if e.tag not in ("complete", "direct", "mux"):
                raise ValueError(f"interconnect: unknown element {e.tag}")
            mode.interconnect.append(PbIc(
                kind=e.tag,
                inputs=[s for s in e.attrib["input"].split()],
                output=e.attrib["output"],    # may hold several specs
                name=e.attrib.get("name", "")))
    return mode


# ---------------------------------------------------------------------------
# pb-graph expansion for a mode selection
# ---------------------------------------------------------------------------

_SPEC = re.compile(r"^(?P<inst>\w+)(\[(?P<hi>\d+)(:(?P<lo>\d+))?\])?"
                   r"\.(?P<port>\w+)(\[(?P<phi>\d+)(:(?P<plo>\d+))?\])?$")


class PbGraph:
    """Expanded pin graph of a pb tree under one mode selection.

    Pins are ids into flat arrays; adj[u] lists pins u drives.  The
    expansion is per candidate cluster — pb graphs are tiny (hundreds of
    pins), so plain python is fine (the reference's legalizer is also
    host-serial)."""

    def __init__(self):
        self.pin_of: Dict[Tuple[str, str, int], int] = {}
        self.adj: List[List[int]] = []
        # leaf instance path -> PbType for primitive matching
        self.leaves: Dict[str, PbType] = {}
        # cluster-boundary pin pools
        self.cluster_in: List[int] = []
        self.cluster_out: List[int] = []
        self.cluster_clock: List[int] = []

    def pin(self, inst: str, port: str, bit: int) -> int:
        key = (inst, port, bit)
        if key not in self.pin_of:
            self.pin_of[key] = len(self.adj)
            self.adj.append([])
        return self.pin_of[key]

    def add_edge(self, u: int, v: int) -> None:
        if v not in self.adj[u]:
            self.adj[u].append(v)


def _expand_spec(spec: str, scope: Dict[str, Tuple[str, PbType]],
                 g: PbGraph) -> List[int]:
    """Port spec -> pin ids.  ``scope`` maps local instance names (the
    parent pb itself + the current mode's children) to (path prefix,
    PbType); 'ble[0:2].in[3]' expands instances then bits, matching the
    reference's port_parse order."""
    m = _SPEC.match(spec.strip())
    if not m:
        raise ValueError(f"bad port spec {spec!r}")
    inst = m.group("inst")
    if inst not in scope:
        raise ValueError(f"unknown instance {inst!r} in spec {spec!r}")
    prefix, pbt = scope[inst]
    is_child = prefix.endswith("*")
    base = prefix.rstrip("*")
    # instance range: children are always bracket-indexed ([hi:lo] or
    # [lo:hi] both accepted, like the reference's port parser); the
    # parent pb itself is a single unbracketed instance
    if is_child:
        if m.group("hi") is not None:
            a = int(m.group("hi"))
            b = int(m.group("lo")) if m.group("lo") is not None else a
            lo, hi = min(a, b), max(a, b)
        else:
            lo, hi = 0, pbt.num_pb - 1
        insts = [base + f"[{k}]" for k in range(lo, hi + 1)]
    else:
        if m.group("hi") is not None:
            raise ValueError(f"spec {spec!r}: the parent pb is a single "
                             f"instance")
        insts = [base]
    port = pbt.port(m.group("port"))
    if m.group("phi") is not None:
        a = int(m.group("phi"))
        b = int(m.group("plo")) if m.group("plo") is not None else a
        plo, phi = min(a, b), max(a, b)
    else:
        phi, plo = port.width - 1, 0
    pins = []
    for ip in insts:
        for bit in range(plo, phi + 1):
            pins.append(g.pin(ip, port.name, bit))
    return pins


def build_pb_graph(root: PbType, mode_sel: Dict[str, int]) -> PbGraph:
    """Expand the tree under ``mode_sel`` (instance path -> mode index;
    missing entries default to mode 0).  Pin directions follow the
    reference's convention: a parent's input port feeds the mode's
    interconnect sources; leaf input pins are consumers."""
    g = PbGraph()

    def walk(pbt: PbType, path: str):
        if pbt.is_leaf:
            g.leaves[path] = pbt
            return
        mi = mode_sel.get(path, 0)
        mode = pbt.modes[mi]
        scope: Dict[str, Tuple[str, PbType]] = {pbt.name: (path, pbt)}
        for c in mode.children:
            scope[c.name] = (path + "/" + c.name + "*", c)
        for ic in mode.interconnect:
            outs = [p for s in ic.output.split()
                    for p in _expand_spec(s, scope, g)]
            if ic.kind == "complete":
                ins = [p for s in ic.inputs
                       for p in _expand_spec(s, scope, g)]
                for u in ins:
                    for v in outs:
                        g.add_edge(u, v)
            elif ic.kind == "direct":
                ins = [p for s in ic.inputs
                       for p in _expand_spec(s, scope, g)]
                if len(ins) != len(outs):
                    raise ValueError(
                        f"direct {ic.name}: width mismatch "
                        f"{len(ins)} -> {len(outs)}")
                for u, v in zip(ins, outs):
                    g.add_edge(u, v)
            else:                               # mux: one option per spec
                for s in ic.inputs:
                    ins = _expand_spec(s, scope, g)
                    if len(ins) != len(outs):
                        raise ValueError(
                            f"mux {ic.name}: option {s} width "
                            f"{len(ins)} != {len(outs)}")
                    for u, v in zip(ins, outs):
                        g.add_edge(u, v)
        for c in mode.children:
            for k in range(c.num_pb):
                walk(c, path + "/" + c.name + f"[{k}]")

    walk(root, root.name)
    # cluster boundary pools
    for p in root.ports:
        for b in range(p.width):
            pid = g.pin(root.name, p.name, b)
            (g.cluster_in if p.dir == "input" else
             g.cluster_clock if p.dir == "clock" else
             g.cluster_out).append(pid)
    return g


# ---------------------------------------------------------------------------
# route-based legality (cluster_legality.c semantics)
# ---------------------------------------------------------------------------

def route_cluster(g: PbGraph, signals: List[dict]) -> Optional[dict]:
    """Detail-route every signal through the pb graph with pin-exclusive
    usage (try_breadth_first_route_cluster contract: feasible iff every
    net reaches all its in-cluster terminals through the mode's
    interconnect).

    Each signal dict: {"source": pin | None (None = enters on any free
    cluster input), "sinks": [pin...] (each required),
    "sink_sets": [[pin...], ...] (one pin per set — logically
    equivalent leaf input pins, physical_types.h pin equivalence),
    "want_out": bool (must also reach a free cluster output)}.
    Returns {pin: signal index} on success, None when any signal cannot
    be routed (the caller rejects the candidate cluster / mode
    selection)."""
    owner: Dict[int, int] = {}

    def grow(si: int, tree: List[int], targets: set,
             need_all: bool) -> bool:
        """Grow signal si's claimed tree to the targets (all of them,
        or any one when need_all=False); fanout re-branches from the
        already-claimed tree like the big router's wave seeding."""
        remaining = set(targets) - set(tree)
        if not remaining and targets:
            return True
        while remaining:
            prev = {}
            frontier = list(tree)
            seen = set(tree)
            found = None
            while frontier and found is None:
                nxt = []
                for u in frontier:
                    for v in g.adj[u]:
                        if v in seen:
                            continue
                        if v in owner and owner[v] != si:
                            continue
                        prev[v] = u
                        if v in remaining:
                            found = v
                            break
                        seen.add(v)
                        nxt.append(v)
                    if found is not None:
                        break
                frontier = nxt
            if found is None:
                return False
            v = found
            while owner.get(v) != si:
                owner[v] = si
                tree.append(v)
                v = prev.get(v)
                if v is None:
                    break
            remaining.discard(found)
            if not need_all:
                return True
        return True

    def route_one(si: int, entry: int, sig: dict) -> bool:
        tree = [entry]
        owner[entry] = si
        if not grow(si, tree, set(sig.get("sinks", ())), True):
            return False
        for ss in sig.get("sink_sets", ()) or ():
            # logically-equivalent pins: one per set; a pin this signal
            # already claimed satisfies the set (duplicate net inputs)
            if any(owner.get(p) == si for p in ss):
                continue
            cands = {p for p in ss if p not in owner}
            if not cands or not grow(si, tree, cands, False):
                return False
        if sig.get("want_out"):
            free_out = {p for p in g.cluster_out if p not in owner}
            if not free_out or not grow(si, tree, free_out, False):
                return False
        return True

    for si, sig in enumerate(signals):
        snapshot = dict(owner)
        if sig.get("source") is not None:
            if sig["source"] in owner:
                return None
            if not route_one(si, sig["source"], sig):
                owner.clear()
                owner.update(snapshot)
                return None
        else:
            # entering signal: claims ONE free cluster input bit — try
            # each candidate entry until one reaches all targets
            ok = False
            for entry in [p for p in g.cluster_in if p not in owner]:
                owner.clear()
                owner.update(snapshot)
                if route_one(si, entry, sig):
                    ok = True
                    break
            if not ok:
                owner.clear()
                owner.update(snapshot)
                return None
    return owner
