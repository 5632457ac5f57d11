"""k1_roofline: K1, the full-canvas relaxation (planes_relax_full_kernel):
its least time over its device time in the window, in %. The least time
of each launch is roofline.py's bound over the launch's shapes and the
sweeps its nets executed (the kernel's own per-net counts); the device
time is the profiler's."""

import roofline


def read(run):
    return roofline.share(run, "k1", "planes_relax_full_kernel")
