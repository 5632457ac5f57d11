"""Structured benchmark synthesis: real RTL-class logic mapped to K-LUTs.

The environment ships no MCNC/VTR circuits (and the reference repo carries
none either), so benchmark circuits of that class are synthesized here
from actual arithmetic/coding structures — NOT random graphs
(netlist/generate.py) — giving the flow realistic rent exponents, carry
structure, reconvergent fanout, and register stages:

- ``array_multiplier``: NxN carry-save array multiplier; partial products
  are AND2 LUTs, full adders map to (XOR3, MAJ3) LUT pairs, with optional
  input/output register stages.  tseng-class at N=16 (~768 LUTs).
- ``crc_xor_tree``: W-bit parallel CRC round: per-output XOR trees over
  the state+data window, registered — deep XOR reconvergence, the
  high-fanout structure typical of MCNC's s-series.

Every function returns a finalized LogicalNetlist; write_blif() persists
it as standard technology-mapped BLIF (read back by netlist/blif.py, the
read_blif.c equivalent).
"""

from __future__ import annotations

from typing import List

from .netlist import (LogicalNetlist, Primitive, PRIM_HARD,
                      PRIM_INPAD, PRIM_OUTPAD, PRIM_LUT, PRIM_FF)

# truth tables (BLIF cover rows) for the mapped cells
_AND2 = ["11 1"]
_XOR2 = ["01 1", "10 1"]
_XOR3 = ["001 1", "010 1", "100 1", "111 1"]
_MAJ3 = ["11- 1", "1-1 1", "-11 1"]


def _lut(nl: LogicalNetlist, out: str, ins: List[str],
         rows: List[str]) -> str:
    nl.add(Primitive(name=out, kind=PRIM_LUT, inputs=list(ins), output=out,
                     truth_table=list(rows)))
    return out


def _ff(nl: LogicalNetlist, out: str, d: str, clk: str) -> str:
    nl.add(Primitive(name=out, kind=PRIM_FF, inputs=[d], output=out,
                     clock=clk))
    return out


def _full_adder(nl: LogicalNetlist, tag: str, a: str, b: str, c: str):
    """(sum, carry) as two 3-LUTs."""
    s = _lut(nl, f"{tag}_s", [a, b, c], _XOR3)
    co = _lut(nl, f"{tag}_c", [a, b, c], _MAJ3)
    return s, co


def _half_adder(nl: LogicalNetlist, tag: str, a: str, b: str):
    s = _lut(nl, f"{tag}_s", [a, b], _XOR2)
    co = _lut(nl, f"{tag}_c", [a, b], _AND2)
    return s, co


def array_multiplier(n: int = 16, registered: bool = True,
                     name: str = None) -> LogicalNetlist:
    """NxN unsigned carry-save array multiplier -> 2N-bit product.

    Row i adds the partial products a[j]&b[i] into a carry-save
    accumulator; a final ripple-carry row resolves the upper half.  LUT
    count ~ n*n (AND2) + 2*(n-1)*n (adders)."""
    nl = LogicalNetlist(name=name or f"mult{n}x{n}")
    clk = "clk"
    nl.add(Primitive(name=clk, kind=PRIM_INPAD, output=clk))
    a_in = [f"a{j}" for j in range(n)]
    b_in = [f"b{i}" for i in range(n)]
    for s in a_in + b_in:
        nl.add(Primitive(name=s, kind=PRIM_INPAD, output=s))
    if registered:
        a = [_ff(nl, f"ra{j}", a_in[j], clk) for j in range(n)]
        b = [_ff(nl, f"rb{i}", b_in[i], clk) for i in range(n)]
    else:
        a, b = a_in, b_in

    # partial products
    pp = [[_lut(nl, f"pp{i}_{j}", [a[j], b[i]], _AND2)
           for j in range(n)] for i in range(n)]

    # carry-save rows: row 0 seeds sums with pp[0]; each later row i adds
    # pp[i] to the shifted previous sums.  Column j's adders form a carry
    # chain down the rows; the final ripple row is one long chain — both
    # recorded for placement macros (place/macros.py, place_macro.c
    # semantics)
    col_chain: List[List[str]] = [[] for _ in range(n + 1)]
    rip_chain: List[str] = []
    sums = list(pp[0])           # weight j (for bit j of row base 0)
    carries: List[str] = []
    prod: List[str] = [sums[0]]  # p0
    for i in range(1, n):
        new_sums: List[str] = []
        new_carries: List[str] = []
        for j in range(n):
            x = pp[i][j]
            y = sums[j + 1] if j + 1 < len(sums) else None
            c = carries[j] if j < len(carries) else None
            tag = f"fa{i}_{j}"
            if y is None and c is None:
                new_sums.append(x)
                continue
            if c is None:
                s, co = _half_adder(nl, tag, x, y)
            elif y is None:
                s, co = _half_adder(nl, tag, x, c)
            else:
                s, co = _full_adder(nl, tag, x, y, c)
            col_chain[j].append(f"{tag}_c")
            new_sums.append(s)
            new_carries.append(co)
        sums, carries = new_sums, new_carries
        prod.append(sums[0])
    # final ripple to resolve remaining sums+carries into high bits
    carry = None
    for j in range(1, len(sums)):
        tag = f"rip{j}"
        y = sums[j]
        c = carries[j - 1] if j - 1 < len(carries) else None
        if c is None and carry is None:
            prod.append(y)
            continue
        if carry is None:
            s, carry = _half_adder(nl, tag, y, c)
        elif c is None:
            s, carry = _half_adder(nl, tag, y, carry)
        else:
            s, carry = _full_adder(nl, tag, y, c, carry)
        rip_chain.append(f"{tag}_c")
        prod.append(s)
    if carry is not None:
        prod.append(carry)

    for k, p in enumerate(prod):
        out = _ff(nl, f"rp{k}", p, clk) if registered else p
        nl.add(Primitive(name=f"out:p{k}", kind=PRIM_OUTPAD, inputs=[out]))
    nl.carry_chains = [c for c in col_chain if len(c) >= 2]
    if len(rip_chain) >= 2:
        nl.carry_chains.append(rip_chain)
    nl.finalize()
    return nl


def ram_pipeline(n_mems: int = 3, addr_bits: int = 6, data_bits: int = 8,
                 name: str = None) -> LogicalNetlist:
    """A heterogeneous benchmark: an address counter feeds a chain of
    single-port RAM macros ('spram' .subckt -> 'bram' block type,
    arch.builtin.k6_n10_mem_arch), each RAM's data-out XOR-mixed with the
    external data word before feeding the next.  Exercises hard-macro
    packing, RAM-column placement, and LUT<->RAM routing the way a
    Stratix-IV-class netlist does."""
    nl = LogicalNetlist(name=name or f"rampipe{n_mems}")
    clk = "clk"
    nl.add(Primitive(name=clk, kind=PRIM_INPAD, output=clk))
    we = "we"
    nl.add(Primitive(name=we, kind=PRIM_INPAD, output=we))
    data = [f"d{i}" for i in range(data_bits)]
    for s in data:
        nl.add(Primitive(name=s, kind=PRIM_INPAD, output=s))

    # address counter: a' = a + 1 (ripple XOR/AND chain of registered bits)
    addr = [f"addr{i}" for i in range(addr_bits)]
    carry = None
    for i in range(addr_bits):
        if carry is None:
            d = _lut(nl, f"addr_n{i}", [addr[i]], ["0 1"])   # invert
            carry = addr[i]
        else:
            d = _lut(nl, f"addr_n{i}", [addr[i], carry], _XOR2)
            carry = _lut(nl, f"addr_c{i}", [addr[i], carry], _AND2)
        _ff(nl, addr[i], d, clk)

    # RAM chain with XOR mixing between stages
    din = list(data)
    for m in range(n_mems):
        dout = [f"m{m}_q{j}" for j in range(data_bits)]
        nl.add(Primitive(name=f"spram_{m}", kind=PRIM_HARD, model="spram",
                         inputs=addr + din + [we], outputs=dout,
                         clock=clk))
        if m + 1 < n_mems:
            din = [_lut(nl, f"mix{m}_{j}", [dout[j], data[j]], _XOR2)
                   for j in range(data_bits)]
        else:
            din = dout
    for j, q in enumerate(din):
        nl.add(Primitive(name=f"out:q{j}", kind=PRIM_OUTPAD, inputs=[q]))
    nl.finalize()
    return nl


# CRC-32 (IEEE 802.3) polynomial taps
_CRC32_POLY = 0x04C11DB7


def crc_xor_tree(width: int = 32, data_bits: int = 32, K: int = 6,
                 name: str = None) -> LogicalNetlist:
    """One registered round of a parallel CRC: next_state = F(state, data)
    where every next-state bit is an XOR of a data/state subset (computed
    by symbolic simulation of the serial LFSR), mapped to a K-input XOR
    tree.  Dense reconvergent fanout, wide XOR trees."""
    nl = LogicalNetlist(name=name or f"crc{width}_{data_bits}")
    clk = "clk"
    nl.add(Primitive(name=clk, kind=PRIM_INPAD, output=clk))
    data = [f"d{i}" for i in range(data_bits)]
    for s in data:
        nl.add(Primitive(name=s, kind=PRIM_INPAD, output=s))
    state = [f"s{i}" for i in range(width)]         # FF outputs (declared
    # below once their D inputs exist; BLIF allows forward refs)

    # symbolic serial LFSR advance: each term set is a frozenset of signal
    # names whose XOR gives that state bit
    terms = [frozenset([s]) for s in state]
    poly_taps = [i for i in range(width) if (_CRC32_POLY >> i) & 1]
    for bit in range(data_bits):
        fb = terms[width - 1] ^ frozenset([data[bit]])   # symmetric diff
        new = [fb]
        for i in range(1, width):
            t = terms[i - 1]
            if i in poly_taps:
                t = t ^ fb
            new.append(t)
        terms = new

    # map each XOR set to a tree of K-input XOR LUTs
    def xor_rows(k: int) -> List[str]:
        rows = []
        for m in range(1 << k):
            if bin(m).count("1") % 2 == 1:
                rows.append(format(m, f"0{k}b")[::-1] + " 1")
        return rows

    def build_xor(tag: str, sigs: List[str]) -> str:
        level = 0
        while len(sigs) > 1:
            nxt = []
            for c in range(0, len(sigs), K):
                chunk = sigs[c:c + K]
                if len(chunk) == 1:
                    nxt.append(chunk[0])
                else:
                    nxt.append(_lut(nl, f"{tag}_x{level}_{c // K}", chunk,
                                    xor_rows(len(chunk))))
            sigs = nxt
            level += 1
        return sigs[0]

    for i in range(width):
        sigs = sorted(terms[i])
        d = build_xor(f"n{i}", sigs) if sigs else data[0]
        _ff(nl, state[i], d, clk)
        nl.add(Primitive(name=f"out:crc{i}", kind=PRIM_OUTPAD,
                         inputs=[state[i]]))
    nl.finalize()
    return nl
