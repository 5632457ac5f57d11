"""route_faults: violations of the checked routes against the reference
graph and terminals (ref/judge.py route_faults). An exact comparison:
LIMIT 0."""

from ref import judge

LIMIT = 0


def read(ref) -> int:
    return int(sum(judge.route_faults(ref.rr, t, o.paths, o.occ, o.wirelength,
                                  o.success) for o, _, t in ref.jobs))
