"""term_mismatch: entries of the terminals each checked route used that
differ from the reference's for its placement. An exact comparison:
LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(sum(judge.term_mismatch(o.term, t) for o, _, t in ref.jobs))
