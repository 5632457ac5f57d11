"""BLIF reader / writer.

Equivalent of the reference's ``read_and_process_blif``
(vpr/SRC/base/read_blif.c, called from vpr_api.c:228).  Supports the
technology-mapped subset VPR consumes: .model/.inputs/.outputs/.names/
.latch/.end with line continuations, plus hard-macro instances:
``.subckt <model> formal=actual ...`` (read_blif.c add_subckt semantics)
with the referenced models declared as black boxes — secondary ``.model``
sections listing .inputs/.outputs/[.clock]/[.blackbox] — whose port order
defines the positional pin mapping onto the matching heterogeneous block
type (arch.hard_models).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .netlist import (LogicalNetlist, Primitive, PRIM_HARD,
                      PRIM_INPAD, PRIM_OUTPAD, PRIM_LUT, PRIM_FF)


@dataclass
class BlackBox:
    """A referenced hard-macro model declaration (port order contract)."""
    name: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    clock: str = None


def _logical_lines(text: str):
    """Yield BLIF logical lines: strip comments, join '\\' continuations."""
    pending = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if line.endswith("\\"):
            pending += line[:-1] + " "
            continue
        line = (pending + line).strip()
        pending = ""
        if line:
            yield line


def read_blif(path: str, K: int = 6) -> LogicalNetlist:
    with open(path) as f:
        text = f.read()
    return parse_blif(text, K=K, name=path)


def parse_blif(text: str, K: int = 6, name: str = "blif") -> LogicalNetlist:
    nl = LogicalNetlist(name=name)
    cur_lut: Primitive = None
    model_seen = False
    boxes: Dict[str, BlackBox] = {}
    cur_box: BlackBox = None          # inside a secondary .model section
    subckts: List[tuple] = []         # (model, {formal: actual}) deferred

    def flush_lut():
        nonlocal cur_lut
        if cur_lut is not None:
            nl.add(cur_lut)
            cur_lut = None

    for line in _logical_lines(text):
        tok = line.split()
        cmd = tok[0]
        if cur_box is not None:
            # secondary model: black-box port declaration only
            if cmd == ".inputs":
                cur_box.inputs += tok[1:]
            elif cmd == ".outputs":
                cur_box.outputs += tok[1:]
            elif cmd == ".clock":
                cur_box.clock = tok[1] if len(tok) > 1 else None
            elif cmd == ".blackbox":
                pass
            elif cmd == ".end":
                boxes[cur_box.name] = cur_box
                cur_box = None
            else:
                raise ValueError(
                    f"black-box model {cur_box.name}: unsupported {cmd}")
            continue
        if cmd == ".model":
            flush_lut()
            if model_seen:
                cur_box = BlackBox(name=tok[1] if len(tok) > 1 else "")
                continue
            model_seen = True
            nl.name = tok[1] if len(tok) > 1 else name
        elif cmd == ".inputs":
            flush_lut()
            for n in tok[1:]:
                nl.add(Primitive(name=n, kind=PRIM_INPAD, output=n))
        elif cmd == ".outputs":
            flush_lut()
            for n in tok[1:]:
                nl.add(Primitive(name="out:" + n, kind=PRIM_OUTPAD, inputs=[n]))
        elif cmd == ".names":
            flush_lut()
            *ins, out = tok[1:]
            if len(ins) > K:
                raise ValueError(f".names {out}: {len(ins)} inputs > K={K}")
            cur_lut = Primitive(name=out, kind=PRIM_LUT,
                                inputs=list(ins), output=out)
        elif cmd == ".latch":
            flush_lut()
            # .latch <input> <output> [<type> <control>] [<init-val>]
            d, q = tok[1], tok[2]
            clock = None
            if len(tok) >= 5:
                clock = tok[4]
            nl.add(Primitive(name=q, kind=PRIM_FF, inputs=[d], output=q,
                             clock=clock))
        elif cmd == ".subckt":
            flush_lut()
            model = tok[1]
            conns = {}
            for pair in tok[2:]:
                formal, actual = pair.split("=", 1)
                conns[formal] = actual
            subckts.append((model, conns))
        elif cmd == ".end":
            flush_lut()
        elif cmd.startswith("."):
            raise ValueError(f"unsupported BLIF construct: {cmd}")
        else:
            # truth table row for the pending .names
            if cur_lut is None:
                raise ValueError(f"stray truth-table row: {line}")
            cur_lut.truth_table.append(line)
    flush_lut()

    # resolve .subckt instances against their black-box declarations
    for k, (model, conns) in enumerate(subckts):
        box = boxes.get(model)
        if box is None:
            raise ValueError(f".subckt {model}: no black-box .model "
                             f"declaration in file")
        clock = None
        ins = []
        for f_ in box.inputs:
            if f_ == box.clock or f_ == "clk":
                clock = conns.get(f_)
                continue
            # unconnected pins stay None placeholders so later ports keep
            # their positional pin mapping (packer leaves them -1)
            ins.append(conns.get(f_))
        outs = [conns.get(f_) for f_ in box.outputs]
        nl.add(Primitive(name=f"{model}_{k}", kind=PRIM_HARD, inputs=ins,
                         outputs=outs, clock=clock, model=model))
    nl.finalize()
    return nl


def write_blif(nl: LogicalNetlist, path: str) -> None:
    with open(path, "w") as f:
        f.write(f".model {nl.name}\n")
        ins = [p.output for p in nl.primitives if p.kind == PRIM_INPAD]
        outs = [p.inputs[0] for p in nl.primitives if p.kind == PRIM_OUTPAD]
        f.write(".inputs " + " ".join(ins) + "\n")
        f.write(".outputs " + " ".join(outs) + "\n")
        hard: Dict[str, Primitive] = {}
        for p in nl.primitives:
            if p.kind == PRIM_LUT:
                f.write(".names " + " ".join(p.inputs + [p.output]) + "\n")
                rows = p.truth_table or ["1" * len(p.inputs) + " 1"]
                for r in rows:
                    f.write(r + "\n")
            elif p.kind == PRIM_FF:
                clk = f" re {p.clock}" if p.clock else ""
                f.write(f".latch {p.inputs[0]} {p.output}{clk} 2\n")
            elif p.kind == PRIM_HARD:
                hard.setdefault(p.model, p)
                pairs = [f"in{j}={n}" for j, n in enumerate(p.inputs)
                         if n is not None]
                pairs += [f"out{j}={n}" for j, n in enumerate(p.outputs)
                          if n is not None]
                if p.clock:
                    pairs.append(f"clk={p.clock}")
                f.write(f".subckt {p.model} " + " ".join(pairs) + "\n")
        f.write(".end\n")
        # black-box declarations for every referenced hard model, with
        # the same positional port-name convention the .subckt lines use
        for model, p in hard.items():
            f.write(f"\n.model {model}\n")
            f.write(".inputs " + " ".join(
                [f"in{j}" for j in range(len(p.inputs))]
                + (["clk"] if p.clock else [])) + "\n")
            f.write(".outputs " + " ".join(
                f"out{j}" for j in range(len(p.outputs))) + "\n")
            if p.clock:
                f.write(".clock clk\n")
            f.write(".blackbox\n.end\n")
