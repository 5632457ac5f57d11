"""Post-synthesis Verilog + SDF writer.

The equivalent of the reference's post-synthesized netlist writer
(vpr/SRC/base/verilog_writer.c:26 verilog_writer): emits (1) a structural
Verilog netlist of the routed circuit's primitives (LUTs with their truth-
table masks, DFFs, IO buffers, hard macros as black boxes), (2) a
``primitives.v`` library with the simulation models, and (3) an SDF file
whose IOPATH entries carry the block delays and whose INTERCONNECT entries
carry the ACTUAL ROUTED per-connection delays from the router's sink_delay
arrays (the reference back-annotates the same way from its route trees).

The reference's writer supports LUT/FF/IO/mult/BRAM; ours supports
LUT/FF/IO plus any hard-macro model as an opaque module instance.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from .netlist import (PRIM_FF, PRIM_HARD, PRIM_INPAD, PRIM_LUT,
                      PRIM_OUTPAD, LogicalNetlist)


def _vid(name: str) -> str:
    """Verilog identifier: plain if alphanumeric, else escaped (`\\x `)."""
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_$]*", name):
        return name
    return "\\" + name + " "


def lut_mask(truth_table, K: int) -> int:
    """BLIF .names cover rows -> 2^K-bit init mask (LSB = all-zero input).
    Rows are ``<pattern> 1`` on-set (or ``... 0`` off-set) lines with
    '-' wildcards, pattern MSB = first input (BLIF column order)."""
    size = 1 << K
    on = 0
    off_set = False
    rows = []
    for row in truth_table:
        toks = row.split()
        if len(toks) == 1:          # constant: single output column
            pat, val = "", toks[0]
        else:
            pat, val = toks[0], toks[1]
        rows.append((pat, val))
        if val == "0":
            off_set = True
    for pat, val in rows:
        idxs = [0]
        for pos, ch in enumerate(pat):
            bit = 1 << pos          # input i = bit i (LSB-first)
            if ch == "1":
                idxs = [i | bit for i in idxs]
            elif ch == "-":
                idxs = idxs + [i | bit for i in idxs]
        for i in idxs:
            on |= 1 << i
    if off_set:                     # rows were the OFF set
        on = ~on & ((1 << size) - 1)
    if not rows:
        on = 0
    return on


def write_primitives_v(path: str, K: int) -> None:
    """Simulation models (the reference ships primitives.v; ours is
    generated to match the emitted instances)."""
    with open(path, "w") as f:
        f.write(f"""// parallel_eda_tpu primitive simulation models
module LUT_K #(parameter K = {K}, parameter [2**K-1:0] MASK = 0)
    (input [K-1:0] in, output out);
  assign out = MASK[in];
endmodule

module DFF (input D, input clk, output reg Q);
  always @(posedge clk) Q <= D;
endmodule

module IBUF (input pad, output o);
  assign o = pad;
endmodule

module OBUF (input i, output pad);
  assign pad = i;
endmodule
""")


def write_verilog(nl: LogicalNetlist, path: str, K: int) -> None:
    """Structural post-synthesis netlist (verilog_writer.c semantics:
    one instance per primitive, wires named after BLIF nets)."""
    pis, pos_ = [], []
    for p in nl.primitives:
        if p.kind == PRIM_INPAD:
            pis.append(p.output)
        elif p.kind == PRIM_OUTPAD:
            pos_.append(p.inputs[0])
    ports = [_vid(n) for n in pis] + [_vid(n + "_out") for n in pos_]
    with open(path, "w") as f:
        f.write(f"// post-synthesis netlist of {nl.name}\n")
        f.write(f"module {_vid(nl.name)} (\n    "
                + ",\n    ".join(ports) + ");\n")
        for n in pis:
            f.write(f"  input {_vid(n)};\n")
        for n in pos_:
            f.write(f"  output {_vid(n + '_out')};\n")
        # every driven net becomes a wire (pads drive/consume directly)
        for n in sorted(nl.net_driver):
            if n not in pis:
                f.write(f"  wire {_vid(n)};\n")
        f.write("\n")
        for i, p in enumerate(nl.primitives):
            iname = _vid(f"prim_{i}")
            if p.kind == PRIM_LUT:
                k = len(p.inputs)
                mask = lut_mask(p.truth_table, k)
                ins = ", ".join(_vid(n) for n in p.inputs)
                f.write(f"  LUT_K #(.K({k}), .MASK({1 << k}'h{mask:x})) "
                        f"{iname} (.in({{{ins}}}), "
                        f".out({_vid(p.output)}));\n")
            elif p.kind == PRIM_FF:
                f.write(f"  DFF {iname} (.D({_vid(p.inputs[0])}), "
                        f".clk({_vid(p.clock)}), "
                        f".Q({_vid(p.output)}));\n")
            elif p.kind == PRIM_OUTPAD:
                f.write(f"  OBUF {iname} (.i({_vid(p.inputs[0])}), "
                        f".pad({_vid(p.inputs[0] + '_out')}));\n")
            elif p.kind == PRIM_HARD:
                conns = []
                for j, n in enumerate(p.inputs):
                    if n is not None:
                        conns.append(f".i{j}({_vid(n)})")
                for j, n in enumerate(p.outputs):
                    if n is not None:
                        conns.append(f".o{j}({_vid(n)})")
                if p.clock is not None:
                    conns.append(f".clk({_vid(p.clock)})")
                f.write(f"  {_vid(p.model)} {iname} "
                        f"({', '.join(conns)});\n")
            # inpads: the port itself is the wire
        f.write("endmodule\n")


def _sdf_num(x: float) -> str:
    v = x * 1e9                      # SDF in ns
    return f"{v:.6f}"


def write_sdf(nl: LogicalNetlist, pnl, term, sink_delay: np.ndarray,
              path: str, t_local: float = 150e-12,
              block_delays: Optional[Dict[int, tuple]] = None) -> None:
    """SDF back-annotation (verilog_writer.c SDF part): IOPATH entries
    from the block timing stand-ins, INTERCONNECT delays per connection —
    intra-cluster connections get the local-interconnect constant, inter-
    cluster connections get the ROUTED delay from the router's
    ``sink_delay`` [R, Smax] (the same numbers STA used)."""
    from ..timing.graph import T_LOCAL
    t_local = t_local or T_LOCAL
    R, Smax = sink_delay.shape
    block_of_prim = {}
    for bi, b in enumerate(pnl.blocks):
        for p in b.prims:
            block_of_prim[p] = bi
    conn_delay: Dict[tuple, float] = {}
    r_of_net = {int(ni): r for r, ni in enumerate(term.net_ids)}
    for ni, r in r_of_net.items():
        for s, pin in enumerate(pnl.nets[ni].sinks):
            d = float(sink_delay[r, s]) if s < Smax else float("nan")
            if np.isfinite(d):
                conn_delay[(ni, pin.block)] = d

    def conn(net: str, sink_prim: int) -> float:
        dp = nl.net_driver[net]
        if block_of_prim[dp] == block_of_prim[sink_prim]:
            return t_local
        ni = pnl.net_index.get(net, -1)
        return conn_delay.get((ni, block_of_prim[sink_prim]), t_local)

    with open(path, "w") as f:
        f.write(f'(DELAYFILE\n  (SDFVERSION "2.1")\n'
                f'  (DESIGN "{nl.name}")\n  (DIVIDER /)\n'
                f'  (TIMESCALE 1 ns)\n')
        for i, p in enumerate(nl.primitives):
            if p.kind not in (PRIM_LUT, PRIM_FF):
                continue
            bt = pnl.block_type(block_of_prim[i])
            f.write(f'  (CELL (CELLTYPE '
                    f'"{ "LUT_K" if p.kind == PRIM_LUT else "DFF" }")\n'
                    f'    (INSTANCE prim_{i})\n    (DELAY (ABSOLUTE\n')
            if p.kind == PRIM_LUT:
                for j, n in enumerate(p.inputs):
                    d = _sdf_num(bt.T_comb)
                    f.write(f'      (IOPATH in[{j}] out '
                            f'({d}:{d}:{d}) ({d}:{d}:{d}))\n')
            else:
                d = _sdf_num(bt.T_clk_to_q)
                f.write(f'      (IOPATH (posedge clk) Q '
                        f'({d}:{d}:{d}) ({d}:{d}:{d}))\n')
            f.write('    ))\n')
            if p.kind == PRIM_FF:
                s = _sdf_num(bt.T_setup)
                f.write(f'    (TIMINGCHECK (SETUP D (posedge clk) '
                        f'({s}:{s}:{s})))\n')
            f.write('  )\n')
        # interconnect: one entry per (driver net -> primitive input)
        f.write('  (CELL (CELLTYPE "interconnect")\n'
                f'    (INSTANCE)\n    (DELAY (ABSOLUTE\n')
        for i, p in enumerate(nl.primitives):
            if p.kind in (PRIM_INPAD,):
                continue
            for n in p.inputs:
                if n is None or n in nl.clocks or n not in nl.net_driver:
                    continue
                d = _sdf_num(conn(n, i))
                f.write(f'      (INTERCONNECT {_vid(n)} prim_{i} '
                        f'({d}:{d}:{d}))\n')
        f.write('    ))\n  )\n)\n')


def write_post_synthesis(flow, out_dir: str,
                         prefix: Optional[str] = None) -> Dict[str, str]:
    """Write <base>_post_synthesis.v / .sdf + primitives.v from a routed
    FlowResult (vpr_api.c output stage; verilog_writer.c:26)."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.basename(prefix or flow.nl.name) or "circuit"
    paths = {}
    p = os.path.join(out_dir, "primitives.v")
    write_primitives_v(p, flow.arch.K)
    paths["primitives"] = p
    p = os.path.join(out_dir, base + "_post_synthesis.v")
    write_verilog(flow.nl, p, flow.arch.K)
    paths["verilog"] = p
    if flow.route is not None:
        p = os.path.join(out_dir, base + "_post_synthesis.sdf")
        write_sdf(flow.nl, flow.pnl, flow.term, flow.route.sink_delay, p)
        paths["sdf"] = p
    return paths
