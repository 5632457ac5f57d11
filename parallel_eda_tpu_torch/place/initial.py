"""Initial placement.

Equivalent of the reference's ``initial_placement`` (vpr/SRC/place/place.c:237):
assign every packed block a legal (x, y, subtile) site — IOs onto perimeter
sites, CLBs into the interior — either deterministically (round-robin, useful
as a stable test fixture) or uniformly at random (the SA placer's starting
point).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..netlist.packed import PackedNetlist
from ..rr.grid import DeviceGrid


def initial_placement(pnl: PackedNetlist, grid: DeviceGrid,
                      seed: Optional[int] = None) -> np.ndarray:
    """Returns pos [num_blocks, 3] int32 (x, y, subtile)."""
    rng = np.random.default_rng(seed) if seed is not None else None

    io_sites = [(x, y, z) for (x, y) in grid.io_sites()
                for z in range(grid.io_capacity)]
    # per-type interior site pools (heterogeneous columns route each
    # block type to its own columns, SetupGrid.c semantics)
    type_sites = {}
    for bi in range(pnl.num_blocks):
        t = pnl.blocks[bi].type_name
        if not pnl.block_type(bi).is_io and t not in type_sites:
            type_sites[t] = [(x, y, 0) for (x, y) in grid.sites_of_type(t)]
    if rng is not None:
        rng.shuffle(io_sites)
        for s in type_sites.values():
            rng.shuffle(s)

    pos = np.zeros((pnl.num_blocks, 3), dtype=np.int32)
    io_i = 0
    type_i = {t: 0 for t in type_sites}
    for bi, b in enumerate(pnl.blocks):
        if pnl.block_type(bi).is_io:
            if io_i >= len(io_sites):
                raise ValueError("not enough IO sites")
            pos[bi] = io_sites[io_i]; io_i += 1
        else:
            t = b.type_name
            if type_i[t] >= len(type_sites[t]):
                raise ValueError(f"not enough '{t}' sites")
            pos[bi] = type_sites[t][type_i[t]]; type_i[t] += 1
    return pos
