"""router.syncs_per_route: the route driver's blocking host-device
round trips per route of the traced window (the window's first route;
the program's counter route.pipeline.blocking_syncs)."""


def read(run):
    runs = run.traced
    return sum(o.syncs for o in runs) / len(runs) if runs else None
