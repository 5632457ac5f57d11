"""repeat_mismatch: runs of a job whose route differs from the checked run
of that job. An exact comparison: LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(sum(judge.repeat_mismatch(o, others)
                   for o, others, _ in ref.jobs))
