"""pack_faults: the program's packing against the BLIF netlist
(ref/judge.py pack_faults). An exact comparison: LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(judge.pack_faults(ref.fe.blif, ref.fe.nl, ref.fe.pnl, ref.arch))
