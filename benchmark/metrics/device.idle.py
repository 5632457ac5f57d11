"""device.idle: the share of the traced window (the window's first
route) in which no operation ran on the card, 100 x (1 - busy / window),
busy being the union of the profiler's device records inside it."""


def read(run):
    tr = run.profile
    if tr is None or not tr.records or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
