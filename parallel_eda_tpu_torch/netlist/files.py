"""Flow-interchange file IO: .net / .place / .route.

Equivalent of the reference's readers/writers (vpr/SRC/base/read_netlist.c,
read_place.c, route/route_common.c print_route).  These files are the
checkpoint/resume surface of the flow (SURVEY.md §5.4): any stage can be
restarted from them.  Formats follow VPR 7's text layouts: .place and
.route match the reference's printers line-for-line in structure, and the
.net file is VPR7-style packed-netlist XML (read_netlist.c) with
positional class-port names; the legacy JSON .net form is still read.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..arch.model import Arch, PIN_CLASS_DRIVER
from .packed import Block, ClbNet, NetPin, PackedNetlist


# ---------------------------------------------------------------- .net ----
#
# VPR7-style packed-netlist XML (vpr/SRC/base/read_netlist.c /
# output_netlist.c):  a top <block name instance="FPGA_packed_netlist[0]">
# with <inputs>/<outputs>/<clocks> lists, one child <block> per cluster
# with instance="<type>[<i>]" and per-pin-class <port> elements whose
# tokens are net names or "open".  Our pin classes are positional, so
# ports are named "c<k>" by class index (VPR names them from the arch's
# pb_type ports; the structure and token layout match).

def write_net_file(pnl: PackedNetlist, path: str) -> None:
    import xml.etree.ElementTree as ET

    root = ET.Element("block", name=pnl.name,
                      instance="FPGA_packed_netlist[0]")
    ins, outs, clks = [], [], []
    for bi, b in enumerate(pnl.blocks):
        bt = pnl.block_type(bi)
        if bt.is_io:
            # pin 0 = receiver (outpad), pin 1 = driver (inpad)
            if b.pin_nets[1] >= 0:
                ins.append(pnl.nets[b.pin_nets[1]].name)
            if b.pin_nets[0] >= 0:
                outs.append(pnl.nets[b.pin_nets[0]].name)
    clks = [n.name for n in pnl.nets if n.is_global]
    ET.SubElement(root, "inputs").text = " ".join(ins)
    ET.SubElement(root, "outputs").text = " ".join(outs)
    ET.SubElement(root, "clocks").text = " ".join(clks)
    # net-index order, so a reloaded netlist keeps the exact numbering a
    # paired .route file refers to ('Net {i}' rows, print_route); VPR7
    # derives this from traversal order, which port-scan order would not
    # reproduce once globals exist
    ET.SubElement(root, "nets").text = " ".join(n.name for n in pnl.nets)

    for bi, b in enumerate(pnl.blocks):
        bt = pnl.block_type(bi)
        eb = ET.SubElement(root, "block", name=b.name,
                           instance=f"{b.type_name}[{bi}]")
        if b.prims:
            eb.set("prims", " ".join(str(p) for p in b.prims))
        e_in = ET.SubElement(eb, "inputs")
        e_out = ET.SubElement(eb, "outputs")
        e_clk = ET.SubElement(eb, "clocks")
        for k, cls in enumerate(bt.pin_classes):
            toks = []
            for p in cls.pins:
                ni = b.pin_nets[p]
                toks.append(pnl.nets[ni].name if ni >= 0 else "open")
            parent = (e_clk if cls.is_clock else
                      e_out if cls.direction == PIN_CLASS_DRIVER else e_in)
            port = ET.SubElement(parent, "port", name=f"c{k}")
            port.text = " ".join(toks)
    ET.indent(root)
    ET.ElementTree(root).write(path)


def read_net_file(path: str, arch: Arch) -> PackedNetlist:
    """Read a packed netlist: VPR7-style XML (or the legacy JSON form)."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("{"):
        return _read_net_json(text, arch)
    import xml.etree.ElementTree as ET

    root = ET.fromstring(text)
    pnl = PackedNetlist(name=root.get("name", "top"))
    globals_ = set((root.findtext("clocks") or "").split())
    # restore the writer's net numbering when present (route-file pairing)
    for name in (root.findtext("nets") or "").split():
        pnl.add_net(name, is_global=name in globals_)
    for g in sorted(globals_):
        pnl.add_net(g, is_global=True)
    for eb in root.findall("block"):
        inst = eb.get("instance", "")
        tname = inst.split("[", 1)[0]
        bt = arch.block_type(tname)
        pin_nets = [-1] * bt.num_pins
        ports = {p.get("name"): (p.text or "") for sec in eb
                 for p in sec.findall("port")}
        known = {f"c{k}" for k in range(len(bt.pin_classes))}
        unknown = set(ports) - known
        if unknown:
            # the reference's read_netlist.c errors on unknown ports;
            # dropping them silently would lose net connections
            raise ValueError(
                f"block '{eb.get('name')}' ({tname}): unknown port(s) "
                f"{sorted(unknown)}; expected {sorted(known)}")
        for k, cls in enumerate(bt.pin_classes):
            toks = ports.get(f"c{k}", "").split()
            for j, p in enumerate(cls.pins):
                if j < len(toks) and toks[j] != "open":
                    pin_nets[p] = pnl.add_net(
                        toks[j], is_global=toks[j] in globals_)
        prims = [int(v) for v in (eb.get("prims") or "").split()]
        pnl.blocks.append(Block(name=eb.get("name"), type_name=tname,
                                pin_nets=pin_nets, prims=prims))
    pnl.bind_types(arch)
    pnl.connect()
    return pnl


def _read_net_json(text: str, arch: Arch) -> PackedNetlist:
    doc = json.loads(text)
    pnl = PackedNetlist(name=doc["name"])
    for n in doc["nets"]:
        pnl.add_net(n["name"], is_global=n["global"])
    for b in doc["blocks"]:
        pnl.blocks.append(Block(name=b["name"], type_name=b["type"],
                                pin_nets=list(b["pin_nets"]),
                                prims=list(b.get("prims", []))))
    pnl.bind_types(arch)
    pnl.connect()
    return pnl


# -------------------------------------------------------------- .place ----

def write_place_file(pnl: PackedNetlist, pos: np.ndarray,
                     nx: int, ny: int, path: str,
                     net_file: str = "-", arch_file: str = "-") -> None:
    """``pos`` is [num_blocks, 3] int (x, y, subtile).

    Format mirrors VPR's .place (base/read_place.c print_place).
    """
    with open(path, "w") as f:
        f.write(f"Netlist file: {net_file}   Architecture file: {arch_file}\n")
        f.write(f"Array size: {nx} x {ny} logic blocks\n\n")
        f.write("#block name\tx\ty\tsubblk\tblock number\n")
        f.write("#----------\t--\t--\t------\t------------\n")
        for i, b in enumerate(pnl.blocks):
            x, y, z = int(pos[i, 0]), int(pos[i, 1]), int(pos[i, 2])
            f.write(f"{b.name}\t{x}\t{y}\t{z}\t#{i}\n")


def read_place_file(pnl: PackedNetlist, path: str) -> Tuple[np.ndarray, int, int]:
    name_to_idx = {b.name: i for i, b in enumerate(pnl.blocks)}
    pos = np.zeros((len(pnl.blocks), 3), dtype=np.int32)
    nx = ny = 0
    seen = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("Netlist"):
                continue
            if line.startswith("Array size:"):
                tok = line.split()
                nx, ny = int(tok[2]), int(tok[4])
                continue
            tok = line.split()
            if len(tok) < 4:
                continue
            bname = tok[0]
            if bname not in name_to_idx:
                raise ValueError(f"{path}: unknown block {bname}")
            i = name_to_idx[bname]
            pos[i] = [int(tok[1]), int(tok[2]), int(tok[3])]
            seen += 1
    if seen != len(pnl.blocks):
        raise ValueError(f"{path}: {seen}/{len(pnl.blocks)} blocks placed")
    return pos, nx, ny


# -------------------------------------------------------------- .route ----


def write_route_file(pnl: PackedNetlist, rr, routes: Dict[int, List[Tuple[int, int]]],
                     path: str, nx: int, ny: int) -> None:
    """``routes[net] = [(node, parent_node), ...]`` in tree order
    (parent -1 for the root SOURCE).  Mirrors print_route
    (vpr/SRC/route/route_common.c)."""
    # imported here to keep netlist importable without the rr package
    from ..rr.graph import RR_TYPE_NAMES, SOURCE, SINK, OPIN, IPIN

    with open(path, "w") as f:
        f.write(f"Array size: {nx} x {ny} logic blocks.\n\nRouting:\n")
        for ni, net in enumerate(pnl.nets):
            if net.is_global:
                f.write(f"\nNet {ni} ({net.name}): global net\n")
                continue
            f.write(f"\nNet {ni} ({net.name})\n\n")
            if ni not in routes:
                continue
            for node, parent in routes[ni]:
                t = int(rr.node_type[node])
                x, y = int(rr.xlow[node]), int(rr.ylow[node])
                ptc = int(rr.ptc[node])
                kind = RR_TYPE_NAMES[t]
                label = ("Class:" if t in (SOURCE, SINK)
                         else "Pin:" if t in (OPIN, IPIN) else "Track:")
                f.write(f"Node:\t{node}\t{kind} ({x},{y})  "
                        f"{label} {ptc}  Parent: {parent}\n")


def read_route_file(path: str) -> Dict[int, List[Tuple[int, int]]]:
    """Read back a .route file -> {net index: [(node, parent), ...]}."""
    routes: Dict[int, List[Tuple[int, int]]] = {}
    cur: Optional[int] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Net "):
                if line.endswith("global net"):
                    cur = None
                else:
                    cur = int(line.split()[1])
                    routes[cur] = []
            elif line.startswith("Node:") and cur is not None:
                tok = line.split()
                routes[cur].append((int(tok[1]), int(tok[-1])))
    return routes
