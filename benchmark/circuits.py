"""The benchmark's input circuits, written as BLIF text.

``array_multiplier_blif(n)`` is an n x n unsigned carry-save array
multiplier with registered inputs and outputs, technology-mapped to
LUTs: partial products are AND2 LUTs, full adders (XOR3, MAJ3) LUT
pairs, a final ripple-carry row resolves the upper half.  It is the
structure of the port's ``netlist.synthesis.array_multiplier``, kept
here so that the benchmark makes its own input: the program and the
reference both read this text."""

from __future__ import annotations

_AND2 = ["11 1"]
_XOR2 = ["01 1", "10 1"]
_XOR3 = ["001 1", "010 1", "100 1", "111 1"]
_MAJ3 = ["11- 1", "1-1 1", "-11 1"]


def array_multiplier_blif(n: int, registered: bool = True) -> str:
    body = []

    def lut(out, ins, rows):
        body.append(".names " + " ".join(list(ins) + [out]))
        body.extend(rows)
        return out

    def ff(out, d):
        body.append(f".latch {d} {out} re clk 2")
        return out

    def adder(tag, x, y, c):
        if c is None:
            return lut(f"{tag}_s", [x, y], _XOR2), lut(f"{tag}_c", [x, y],
                                                       _AND2)
        return (lut(f"{tag}_s", [x, y, c], _XOR3),
                lut(f"{tag}_c", [x, y, c], _MAJ3))

    a_in = [f"a{j}" for j in range(n)]
    b_in = [f"b{i}" for i in range(n)]
    if registered:
        a = [ff(f"ra{j}", a_in[j]) for j in range(n)]
        b = [ff(f"rb{i}", b_in[i]) for i in range(n)]
    else:
        a, b = a_in, b_in
    pp = [[lut(f"pp{i}_{j}", [a[j], b[i]], _AND2) for j in range(n)]
          for i in range(n)]
    sums, carries = list(pp[0]), []
    prod = [sums[0]]
    for i in range(1, n):
        new_sums, new_carries = [], []
        for j in range(n):
            x = pp[i][j]
            y = sums[j + 1] if j + 1 < len(sums) else None
            c = carries[j] if j < len(carries) else None
            if y is None and c is None:
                new_sums.append(x)
                continue
            if c is None or y is None:
                s, co = adder(f"fa{i}_{j}", x, y if c is None else c, None)
            else:
                s, co = adder(f"fa{i}_{j}", x, y, c)
            new_sums.append(s)
            new_carries.append(co)
        sums, carries = new_sums, new_carries
        prod.append(sums[0])
    carry = None
    for j in range(1, len(sums)):
        y = sums[j]
        c = carries[j - 1] if j - 1 < len(carries) else None
        if c is None and carry is None:
            prod.append(y)
            continue
        if carry is None:
            s, carry = adder(f"rip{j}", y, c, None)
        elif c is None:
            s, carry = adder(f"rip{j}", y, carry, None)
        else:
            s, carry = adder(f"rip{j}", y, c, carry)
        prod.append(s)
    if carry is not None:
        prod.append(carry)
    outs = [ff(f"rp{k}", p) if registered else p for k, p in
            enumerate(prod)]
    head = [f".model mult{n}x{n}",
            ".inputs " + " ".join((["clk"] if registered else []) + a_in
                                  + b_in),
            ".outputs " + " ".join(outs)]
    return "\n".join(head + body + [".end", ""])


GENERATORS = {"array_multiplier": array_multiplier_blif}


def circuit_blif(spec: dict) -> str:
    """The BLIF text of a configuration's ``circuit`` entry:
    ``{"generator": <name>, <its keyword arguments>}``."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](**kw)
