"""wirelength: the mean over the pool's jobs, each counted once, of the
wires its route uses (CHANX/CHANY nodes that any net occupies)."""


def read(run):
    jobs = [o for o, _ in run.per_job()]
    return sum(o.wirelength for o in jobs) / len(jobs) if jobs else None
