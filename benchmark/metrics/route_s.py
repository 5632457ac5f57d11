"""route_s: seconds of the window per legal route, window seconds /
legal routes.  A round started inside the window is finished and
counted, and the window closes when it ends, so the window holds all
the work over all the time (host clock)."""


def read(run):
    legal = sum(o.success for o in run.window)
    return run.window_s / legal if legal else None
