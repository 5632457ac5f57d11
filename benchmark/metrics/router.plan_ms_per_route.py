"""router.plan_ms_per_route: host milliseconds the route driver spends
planning and staging each route's windows, over the routes of the
traced window (the window's first route; the program's gauge
route.pipeline.host_plan_ms_total, read after each route)."""


def read(run):
    runs = run.traced
    return sum(o.plan_ms for o in runs) / len(runs) if runs else None
