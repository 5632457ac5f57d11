"""rr_mismatch: entries of the program's rr graph that differ from the
reference's. An exact comparison: LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(judge.rr_mismatch(ref.fe.rr, ref.rr))
