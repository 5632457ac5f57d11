"""Placement legality audit (a copy of the JAX package's place/check.py).

Equivalent of the reference's post-anneal verification (place.c:253
check_place + the cost re-derivation at :654-683): every block sits on a
tile legal for its type, subtile indices are in range, and no two blocks
share a site.  Called by Placer.place() on its final result (not just
tests), so an annealer bug can never hand an illegal placement to the
router silently.
"""

from __future__ import annotations

import numpy as np

from ..netlist.packed import PackedNetlist
from ..rr.grid import DeviceGrid


def check_place(pnl: PackedNetlist, grid: DeviceGrid,
                pos: np.ndarray) -> None:
    """Raises ValueError on any legality violation.  Vectorized (runs on
    every Placer.place() result, so it must stay cheap at large NB)."""
    NB = pnl.num_blocks
    pos = np.asarray(pos)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    is_io = np.array([pnl.block_type(i).is_io for i in range(NB)])
    tname = np.array([b.type_name for b in pnl.blocks])

    errs = []

    def flag(mask, what):
        for bi in np.where(mask)[0][:4]:
            errs.append(f"{what}: block {pnl.blocks[bi].name} at "
                        f"({x[bi]},{y[bi]},{z[bi]})")

    on_edge = (x == 0) | (x == grid.nx + 1) | (y == 0) | (y == grid.ny + 1)
    corner = ((x == 0) | (x == grid.nx + 1)) & ((y == 0) | (y == grid.ny + 1))
    flag(is_io & ~(on_edge & ~corner), "io block off the perimeter ring")
    flag(is_io & ((z < 0) | (z >= grid.io_capacity)),
         "io subtile out of range")

    interior = (x >= 1) & (x <= grid.nx) & (y >= 1) & (y <= grid.ny)
    flag(~is_io & ~interior, "block outside the interior")
    col_t = np.array(["" if c in (0, grid.nx + 1) else
                      grid.interior_type_name(c)
                      for c in range(grid.nx + 2)])
    xc = np.clip(x, 0, grid.nx + 1)
    flag(~is_io & interior & (col_t[xc] != tname),
         "block on a column of another type")
    flag(~is_io & (z != 0), "non-io subtile != 0")

    # site collisions: unique (x, y, z) per block
    key = (x.astype(np.int64) * (grid.ny + 2) + y) \
        * max(grid.io_capacity, 1) + z
    uniq, counts = np.unique(key, return_counts=True)
    if (counts > 1).any():
        dup = uniq[counts > 1][0]
        who = [pnl.blocks[int(i)].name for i in np.where(key == dup)[0][:3]]
        errs.append(f"site shared by {who}")

    if errs:
        raise ValueError("check_place failed:\n  " + "\n  ".join(errs))
