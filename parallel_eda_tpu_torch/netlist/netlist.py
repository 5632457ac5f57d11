"""Logical (technology-mapped) netlist model.

Equivalent of the structures filled by the reference's BLIF reader
(vpr/SRC/base/read_blif.c → ``t_net``/logical_block arrays): a flat list of
primitives (LUT / FF / IO pads) and the nets connecting them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

PRIM_INPAD = 0
PRIM_OUTPAD = 1
PRIM_LUT = 2
PRIM_FF = 3
PRIM_HARD = 4        # hard macro instance (.subckt: RAM / DSP block)

_PRIM_NAMES = {PRIM_INPAD: "inpad", PRIM_OUTPAD: "outpad",
               PRIM_LUT: "lut", PRIM_FF: "ff", PRIM_HARD: "hard"}


@dataclass
class Primitive:
    name: str            # name of the output net it drives (BLIF convention)
    kind: int
    inputs: List[str] = field(default_factory=list)   # input net names
    output: Optional[str] = None                      # output net name
    clock: Optional[str] = None                       # FF clock net
    truth_table: List[str] = field(default_factory=list)  # .names cover rows
    # PRIM_HARD only: .subckt model name + multi-bit output nets (inputs
    # and outputs are positional against the hard block type's pin order)
    model: Optional[str] = None
    outputs: List[str] = field(default_factory=list)


@dataclass
class LogicalNetlist:
    name: str = "top"
    primitives: List[Primitive] = field(default_factory=list)
    # net name -> (driver prim index, [sink prim indices])
    # built by finalize()
    net_driver: Dict[str, int] = field(default_factory=dict)
    net_sinks: Dict[str, List[int]] = field(default_factory=dict)
    clocks: List[str] = field(default_factory=list)
    # carry chains: ordered lists of primitive NAMES forming arithmetic
    # carry structure (synthesis records them; the BLIF reader could
    # derive them from .subckt carry models).  The placer forms placement
    # macros from these (place/macros.py; reference place_macro.c)
    carry_chains: List[List[str]] = field(default_factory=list)

    def add(self, prim: Primitive) -> int:
        self.primitives.append(prim)
        return len(self.primitives) - 1

    def finalize(self) -> None:
        """Build net connectivity maps and detect clock nets."""
        self.net_driver.clear()
        self.net_sinks.clear()
        clocks = set()
        for i, p in enumerate(self.primitives):
            outs = [p.output] if p.output is not None else []
            outs += p.outputs
            for o in outs:
                if o is None:
                    continue            # unconnected hard-macro port
                if o in self.net_driver:
                    raise ValueError(f"net {o} multiply driven")
                self.net_driver[o] = i
            for n in p.inputs:
                if n is not None:
                    self.net_sinks.setdefault(n, []).append(i)
            if p.clock is not None:
                self.net_sinks.setdefault(p.clock, []).append(i)
                clocks.add(p.clock)
        self.clocks = sorted(clocks)
        undriven = [n for n in self.net_sinks if n not in self.net_driver]
        if undriven:
            raise ValueError(f"undriven nets: {undriven[:5]}"
                             f"{'...' if len(undriven) > 5 else ''}")

    @property
    def num_luts(self) -> int:
        return sum(1 for p in self.primitives if p.kind == PRIM_LUT)

    @property
    def num_ffs(self) -> int:
        return sum(1 for p in self.primitives if p.kind == PRIM_FF)

    def stats(self) -> str:
        counts = {}
        for p in self.primitives:
            counts[_PRIM_NAMES[p.kind]] = counts.get(_PRIM_NAMES[p.kind], 0) + 1
        nets = len(self.net_driver)
        return f"{self.name}: {counts}, {nets} nets"
