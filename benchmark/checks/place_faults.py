"""place_faults: blocks of the checked runs' placements off a legal site or
sharing one. An exact comparison: LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(sum(judge.place_faults(ref.fe.pnl, o.pos, ref.grid, ref.arch)
               for o, _, _ in ref.jobs))
