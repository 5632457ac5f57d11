"""The relaxation kernels' least time: the arithmetic of the port's
``chip_smoke.py`` (``scan_combines``, ``sweep_ops``, ``launch_ops``,
``bounds``, ``bound_ms``, ``round_ops`` and the H100 peaks), kept here
so that the rooflines are measured with a yardstick the program does
not hold.

A kernel's roofline share is its least time over its device time.  The
least time of one launch is the larger of (the flats read and written
once, with the geometry once) over the HBM rate and (the sweeps the
launch's nets executed times the operations of a sweep, plus the scan
costs once per net) over the f32 rate."""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet): HBM3 bytes/s; f32 operations/s of
# separate add / multiply / min instructions (the kernels are built with
# -fmad=false, so no FMA counts two): 132 SMs x 128 lanes x 1.98 GHz
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 132 * 128 * 1.98e9


def scan_combines(n: int) -> int:
    """Combines of lax.associative_scan's tree over a length-n line."""
    if n < 2:
        return 0
    return n // 2 + (n + 1) // 2 - 1 + scan_combines(n // 2)


def sweep_ops(W: int, X: int, Y: int, directional: bool) -> int:
    """f32 operations that one sweep of one net on an (X, Y) canvas
    needs, counting only what can change its result: four line scans
    (per combine two adds and a min, per cell the compare with dist) and
    two turn stencils (each candidate that can win: two adds and the
    compare, and the min of its two gates on bidirectional tracks; per
    target the compare with dist and crit * delay)."""
    ncx, ncy = W * X * (Y + 1), W * (X + 1) * Y
    scans = (2 * W * (Y + 1) * (3 * scan_combines(X) + X)
             + 2 * W * (X + 1) * (3 * scan_combines(Y) + Y))
    turns = 1 + (W > 2)
    sides = 1 if directional else 2
    cands = turns * sides * (W * Y * 2 * X + W * X * 2 * Y)
    per_target = 2 * ncx + (2 if directional else 4) * ncy
    return scans + cands * (3 if directional else 4) + per_target


def launch_ops(W: int, X: int, Y: int) -> int:
    """Operations a launch needs once per net: crit * delay + cc of
    every cell."""
    return 2 * (W * X * (Y + 1) + W * (X + 1) * Y)


def round_ops(W: int, X: int, Y: int, nets: int, sweeps: int) -> int:
    """The bf16 plane mode's rounding: per cell of a net's canvas, its
    congestion, entry dist and wenter once per launch, and its dist once
    per sweep."""
    cells = W * X * (Y + 1) + W * (X + 1) * Y
    return cells * (3 * nets + sweeps)


def bound_s(shape_x, ncells: int, directional: bool, B: int, sweeps: int,
            tile=None, plane_bytes: int = 4) -> float:
    """Least seconds of one relaxation launch over B nets on the planes
    graph of ``shape_x`` = (W, NX, NY + 1) and ``ncells`` cells, whose
    nets executed ``sweeps`` sweeps in all; ``tile`` (X, Y) for the
    cropped kernel."""
    W, NX, NYp1 = shape_x
    nc = ncells
    geo = 4 * nc + 4 * (W * NX * NYp1 + 3 * (nc - W * NX * NYp1))
    pb = plane_bytes
    nbytes = (3 * pb * B * nc + 4 * B + (2 * pb + 4) * B * nc + 8 * B
              + geo)
    X, Y = (NX, NYp1 - 1) if tile is None else tile
    ops = sweeps * sweep_ops(W, X, Y, directional) + B * launch_ops(W, X, Y)
    if pb == 2:
        ops += round_ops(W, X, Y, B, sweeps)
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)


def share(run, kind: str, kernel: str):
    """The roofline share, in %, of the relaxation ``kind`` ("k1", "k2")
    whose device records carry the short name ``kernel``; None where the
    window launched none or the traced run has no device records."""
    tr, spy = run.profile, run.spy
    if tr is None or not tr.records or spy is None:
        return None
    dev_s, n = tr.device_seconds(lambda name: name == kernel)
    launches = [x for x in spy.launches if x[0] == kind and x[6] is not None]
    if dev_s <= 0 or not launches:
        return None
    if n != len(launches):
        raise RuntimeError(f"{kind}: {len(launches)} calls but {n} device "
                           f"records of {kernel}")
    import torch

    sweeps = torch.stack([x[6][:x[4], 0].sum() for x in launches]).tolist()
    least = sum(bound_s(shape_x, nc, directional, B, int(sw), tile,
                        2 if dtype == "bf16" else 4)
                for (_, shape_x, directional, nc, B, tile, _, dtype), sw
                in zip(launches, sweeps))
    return 100.0 * least / dev_s
