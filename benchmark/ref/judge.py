"""The comparison that decides ``correct``.

Every number here is a count of disagreements between what the program
produced and what the reference works out again from the benchmark's own
inputs (the BLIF text, the architecture, the channel width, the
placements' seeds), so each has the limit 0:

  pack_faults      the program's packing against the BLIF netlist: each
                   primitive in one block, clusters within the
                   architecture's N and I, every signal that leaves its
                   block a packed net with the same driver block and sink
                   blocks, every pin of a net in its class and bound to it
  rr_mismatch      entries of the program's rr graph (nodes, both edge
                   CSRs, delays, switches, track maps) that differ from the
                   graph the reference builds for the same grid and width
  place_faults     blocks off a legal site of their type, or sharing one
  term_mismatch    entries of the terminals a route used that differ from
                   the reference's for the placement
  route_faults     per routed job: a sink not reached, a path edge that is
                   not in the reference graph, a node with two parents or
                   not connected to the source, a foreign SOURCE/SINK, an
                   overused node, occupancy entries that differ from the
                   reference's count, a wirelength that differs, success
                   not claimed
  repeat_mismatch  window runs of a job whose route differs from the run
                   of that job that was checked
  relax_mismatch   cells where a relaxation call captured in the window
                   (K1 and K2, inputs and outputs) differs from the
                   reference relaxation on the same inputs, plus one for
                   each kind with no call captured, plus, on the card,
                   each of the kinds' kernel launches in the window that
                   the captured calls' spy did not see

The reference is this package: frozen copies of the port's graph
construction and plain relaxation, and checks written here.  It reads
the program's outputs only to judge them."""

from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np

from . import arch as ref_arch
from . import grid as ref_grid
from . import rrgraph as ref_rr

_RR_ARRAYS = ("node_type", "xlow", "ylow", "xhigh", "yhigh", "ptc",
              "capacity", "R", "C", "cost_index", "base_cost", "out_row_ptr",
              "out_dst", "out_switch", "in_row_ptr", "in_src", "in_switch",
              "in_delay", "switch_Tdel", "switch_R", "seg_of_track",
              "wire_switch_of_track")


# ---------------------------------------------------------------------------
# The BLIF netlist, read by the reference itself
# ---------------------------------------------------------------------------


def read_blif(text: str) -> dict:
    """{primitive name: (kind, [input signals], output signal)} of a flat
    BLIF (.inputs, .outputs, .names, .latch), outputs named "out:<s>"."""
    prims = {}
    lines = [ln.split("#")[0].strip() for ln in text.splitlines()]
    for ln in lines:
        tok = ln.split()
        if not tok:
            continue
        if tok[0] == ".inputs":
            for s in tok[1:]:
                prims[s] = ("inpad", [], s)
        elif tok[0] == ".outputs":
            for s in tok[1:]:
                prims["out:" + s] = ("outpad", [s], None)
        elif tok[0] == ".names":
            prims[tok[-1]] = ("lut", tok[1:-1], tok[-1])
        elif tok[0] == ".latch":
            prims[tok[2]] = ("ff", [tok[1]] + ([tok[4]] if len(tok) > 4
                                               else []), tok[2])
    return prims


def pack_faults(blif: str, nl, pnl, arch) -> int:
    prims = read_blif(blif)
    faults = 0
    block_of: Dict[str, int] = {}
    for bi, b in enumerate(pnl.blocks):
        kinds = {"lut": 0, "ff": 0, "pad": 0}
        for p in b.prims:
            name = nl.primitives[p].name
            if name in block_of or name not in prims:
                faults += 1
            block_of[name] = bi
            k = prims.get(name, ("pad",))[0]
            kinds["pad" if k in ("inpad", "outpad") else k] += 1
        if b.type_name == "clb":
            faults += (kinds["lut"] > arch.N) + (kinds["ff"] > arch.N) \
                + (kinds["pad"] > 0)
        elif b.type_name == "io":
            faults += (kinds["pad"] != 1) + (kinds["lut"] + kinds["ff"] > 0)
        else:
            faults += 1
    faults += sum(1 for name in prims if name not in block_of)
    # every signal that leaves its block is a packed net from the driver's
    # block to exactly the other blocks that read it
    sinks_of: Dict[str, set] = {}
    clocks = set()
    for name, (kind, ins, _) in prims.items():
        for j, s in enumerate(ins):
            sinks_of.setdefault(s, set()).add(block_of.get(name, -1))
            if kind == "ff" and j == 1:
                clocks.add(s)
    inputs_of: Dict[int, set] = {}
    for s, blocks in sinks_of.items():
        if s in clocks:
            continue
        drv = block_of.get(s, -1)
        ext = blocks - {drv}
        ni = pnl.net_index.get(s)
        if not ext:
            if ni is not None and not pnl.nets[ni].is_global and \
                    pnl.nets[ni].sinks:
                faults += 1
            continue
        for b in ext:
            inputs_of.setdefault(b, set()).add(s)
        if ni is None:
            faults += 1
            continue
        net = pnl.nets[ni]
        got = [p.block for p in net.sinks]
        faults += (net.driver.block != drv) + (sorted(got) != sorted(ext))
    for b, sigs in inputs_of.items():
        if pnl.blocks[b].type_name == "clb":
            faults += len(sigs) > arch.I
    # pins: a driver pin in a driver class, sink pins in a receiver
    # class, each pin bound to its net
    types = {t.name: t for t in arch.block_types}
    for ni, net in enumerate(pnl.nets):
        if net.is_global:
            continue
        for role, p in [(ref_arch.PIN_CLASS_DRIVER, net.driver)] + [
                (ref_arch.PIN_CLASS_RECEIVER, q) for q in net.sinks]:
            bt = types[pnl.blocks[p.block].type_name]
            cls = bt.pin_classes[bt.pin_class_of[p.pin]]
            faults += (cls.direction != role) + bool(cls.is_clock) + (
                pnl.blocks[p.block].pin_nets[p.pin] != ni)
    return faults


# ---------------------------------------------------------------------------
# Grid, graph, placement, terminals
# ---------------------------------------------------------------------------


def build_reference(cfg: dict, pnl, chan_width: int):
    """The reference's architecture, grid and rr graph for the cell."""
    arch = getattr(ref_arch, cfg["arch"] + "_arch")()
    n_io = sum(1 for b in pnl.blocks if b.type_name == "io")
    n_clb = sum(1 for b in pnl.blocks if b.type_name == "clb")
    grid = ref_grid.size_grid(n_clb, n_io, arch)
    return arch, grid, ref_rr.build_rr_graph(arch, grid,
                                             chan_width=chan_width)


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.count_nonzero(a != b))


def rr_mismatch(prog_rr, rr) -> int:
    n = sum(_differ(getattr(prog_rr, k), getattr(rr, k))
            for k in _RR_ARRAYS)
    n += (prog_rr.grid.nx != rr.grid.nx) + (prog_rr.grid.ny != rr.grid.ny)
    n += prog_rr.chan_width != rr.chan_width
    return int(n)


def place_faults(pnl, pos: np.ndarray, grid, arch) -> int:
    io_sites = set(map(tuple, grid.io_sites()))
    seen = set()
    faults = 0
    for bi, b in enumerate(pnl.blocks):
        x, y, z = (int(v) for v in pos[bi])
        if b.type_name == "io":
            faults += (x, y) not in io_sites or not 0 <= z < arch.io_capacity
        else:
            faults += not (1 <= x <= grid.nx and 1 <= y <= grid.ny
                           and z == 0
                           and grid.interior_type_name(x) == b.type_name)
        faults += (x, y, z) in seen
        seen.add((x, y, z))
    return faults


def terminals(pnl, rr, arch, pos: np.ndarray, bb_factor: int) -> dict:
    types = {t.name: t for t in arch.block_types}
    routable = [i for i, n in enumerate(pnl.nets)
                if not n.is_global and n.sinks]
    R = len(routable)
    S = max((len(pnl.nets[i].sinks) for i in routable), default=1)
    out = {k: np.zeros(R, np.int64) for k in (
        "source", "num_sinks", "bb_xmin", "bb_xmax", "bb_ymin", "bb_ymax")}
    out["net_ids"] = np.array(routable, np.int64)
    out["sinks"] = np.full((R, S), -1, np.int64)

    def at(p):
        x, y, z = (int(v) for v in pos[p.block])
        k = types[pnl.blocks[p.block].type_name].pin_class_of[p.pin]
        return x, y, z, k

    for r, ni in enumerate(routable):
        net = pnl.nets[ni]
        x, y, z, k = at(net.driver)
        out["source"][r] = rr.src_of[(x, y, z, k)]
        xs, ys = [x], [y]
        for s, p in enumerate(net.sinks):
            sx, sy, sz, sk = at(p)
            out["sinks"][r, s] = rr.sink_of[(sx, sy, sz, sk)]
            xs.append(sx)
            ys.append(sy)
        out["num_sinks"][r] = len(net.sinks)
        out["bb_xmin"][r] = max(0, min(xs) - bb_factor)
        out["bb_xmax"][r] = min(rr.grid.nx + 1, max(xs) + bb_factor)
        out["bb_ymin"][r] = max(0, min(ys) - bb_factor)
        out["bb_ymax"][r] = min(rr.grid.ny + 1, max(ys) + bb_factor)
    return out


def term_mismatch(prog_term, ref_term: dict) -> int:
    return sum(_differ(getattr(prog_term, k), v) for k, v in ref_term.items())


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def route_faults(rr, term: dict, paths: np.ndarray, occ: np.ndarray,
                 wirelength: int, success: bool) -> int:
    """Violations of one route against the reference graph and terminals;
    each sink segment runs from the sink to the node where it joins the
    net's tree (path[k + 1] -> path[k] is an rr edge)."""
    N = rr.num_nodes
    faults = int(not success)
    src = np.repeat(np.arange(N, dtype=np.int64), np.diff(rr.out_row_ptr))
    edge_keys = np.sort(src * N + rr.out_dst.astype(np.int64))
    cap = np.asarray(rr.capacity, np.int64)
    count = np.zeros(N, np.int64)
    wires = np.zeros(N, bool)
    is_wire = np.isin(rr.node_type, (ref_rr.CHANX, ref_rr.CHANY))
    R = len(term["source"])
    if paths.shape[0] != R:
        return faults + R + 1
    for r in range(R):
        source = int(term["source"][r])
        ns = int(term["num_sinks"][r])
        sinks = set(int(v) for v in term["sinks"][r, :ns])
        parent = {}
        used = {source}
        for s in range(ns):
            seg = paths[r, s] if s < paths.shape[1] else np.zeros(0)
            seg = seg[seg < N].astype(np.int64)
            if seg.size == 0 or int(seg[0]) != int(term["sinks"][r, s]):
                faults += 1
                continue
            keys = seg[1:] * N + seg[:-1]
            pos_ = np.searchsorted(edge_keys, keys)
            pos_ = np.minimum(pos_, len(edge_keys) - 1)
            faults += int(np.count_nonzero(edge_keys[pos_] != keys))
            for child, par in zip(seg[:-1].tolist(), seg[1:].tolist()):
                if parent.setdefault(child, par) != par:
                    faults += 1
            used.update(seg.tolist())
        children: Dict[int, List[int]] = {}
        for c, p in parent.items():
            children.setdefault(p, []).append(c)
        seen = {source}
        dq = deque([source])
        while dq:
            for c in children.get(dq.popleft(), ()):
                if c not in seen:
                    seen.add(c)
                    dq.append(c)
        faults += len(used - seen) + len(sinks - seen)
        for v in used:
            t = rr.node_type[v]
            faults += (t == ref_rr.SINK and v not in sinks) + (
                t == ref_rr.SOURCE and v != source)
            count[v] += 1
        wires[[v for v in used if is_wire[v]]] = True
    faults += int(np.count_nonzero(count > cap))
    faults += _differ(np.asarray(occ, np.int64), count)
    faults += int(wires.sum()) != int(wirelength)
    return faults


def repeat_mismatch(checked, runs) -> int:
    return sum(int(not (np.array_equal(o.paths, checked.paths)
                        and np.array_equal(o.occ, checked.occ)
                        and o.wirelength == checked.wirelength
                        and o.iterations == checked.iterations))
               for o in runs)


# ---------------------------------------------------------------------------
# The relaxation
# ---------------------------------------------------------------------------


def relax_mismatch(rr, captured: dict, calls: dict, launched, device) -> int:
    """Cells where each captured call's (dist, pred, wenter) differs from
    the reference relaxation run on the call's inputs (on ``device``),
    plus one per kind (``calls``' keys) with no call captured, and, where
    ``launched`` counts the kernels' launches, the launches that no call
    seen accounts for (or calls seen that launched nothing)."""
    import torch

    from . import planes

    pg = planes.build_planes(rr, device)
    n = sum(kind not in captured for kind in calls)
    if launched is not None:
        n += sum(abs(int(launched[k]) - int(calls[k])) for k in calls)
    for kind, cap in captured.items():
        args = tuple(a.to(device) if torch.is_tensor(a) else a
                     for a in cap["args"])
        with torch.no_grad():
            if kind == "k1":
                out = planes.planes_relax_plain(pg, *args[:5])
            else:
                out = planes.planes_relax_cropped_plain(pg, *args[:9])
        for got, want in zip(cap["out"], out[:3]):
            got = got.to(device)
            if got.shape != want.shape:
                n += max(got.numel(), want.numel())
                continue
            n += int(torch.count_nonzero(got != want).item())
    return n
