"""step.launches_per_route: device operations per route other than the
hand-written relaxation kernels: the PyTorch kernels, copies and fills
of the route step around K1/K2 (torch.profiler's device records of the
traced window, the window's first route)."""


def read(run):
    tr, runs = run.profile, run.traced
    if tr is None or not tr.records or not runs:
        return None
    _, total = tr.device_seconds(lambda n: True)
    _, own = tr.device_seconds(lambda n: n.startswith("planes_relax"))
    return (total - own) / len(runs)
