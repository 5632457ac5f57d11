"""Device grid model + auto-sizing.

Equivalent of the reference's grid setup (vpr/SRC/base/SetupGrid.c and the
auto-size binary search in vpr/SRC/base/vpr_api.c:286-299): an island-style
FPGA — an IO ring around a square interior of logic tiles.

Coordinates follow the VPR convention: the grid is (nx+2) x (ny+2) tiles;
tiles with x in [1, nx] and y in [1, ny] are logic (CLB) tiles; the perimeter
(x==0, x==nx+1, y==0, y==ny+1) is IO, corners empty.  Routing channels:
CHANX(x, y) is the horizontal channel above tile row y (x in [1, nx],
y in [0, ny]); CHANY(x, y) is the vertical channel right of tile column x
(x in [0, nx], y in [1, ny]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..arch.model import Arch


@dataclass
class DeviceGrid:
    nx: int
    ny: int
    io_capacity: int
    # interior column x (1..nx) -> block type name; missing = "clb"
    # (heterogeneous columns, SetupGrid.c t_grid_loc_def col semantics)
    col_types: Dict[int, str] = field(default_factory=dict)

    def interior_type_name(self, x: int) -> str:
        return self.col_types.get(x, "clb")

    @property
    def width(self) -> int:
        return self.nx + 2

    @property
    def height(self) -> int:
        return self.ny + 2

    def is_io(self, x: int, y: int) -> bool:
        on_edge = x == 0 or x == self.nx + 1 or y == 0 or y == self.ny + 1
        return on_edge and not self.is_corner(x, y)

    def is_corner(self, x: int, y: int) -> bool:
        return (x in (0, self.nx + 1)) and (y in (0, self.ny + 1))

    def is_clb(self, x: int, y: int) -> bool:
        return 1 <= x <= self.nx and 1 <= y <= self.ny

    def io_sites(self) -> List[Tuple[int, int]]:
        """Perimeter IO tile coordinates in clockwise order from (0,1).
        Each holds ``io_capacity`` placement sites (subtiles)."""
        sites = []
        for y in range(1, self.ny + 1):              # left edge, bottom-up
            sites.append((0, y))
        for x in range(1, self.nx + 1):              # top edge, left-right
            sites.append((x, self.ny + 1))
        for y in range(self.ny, 0, -1):              # right edge, top-down
            sites.append((self.nx + 1, y))
        for x in range(self.nx, 0, -1):              # bottom edge, right-left
            sites.append((x, 0))
        return sites

    def clb_sites(self) -> List[Tuple[int, int]]:
        return [(x, y) for y in range(1, self.ny + 1)
                for x in range(1, self.nx + 1)
                if self.interior_type_name(x) == "clb"]

    def sites_of_type(self, name: str) -> List[Tuple[int, int]]:
        """Interior tile coordinates holding blocks of ``name``."""
        return [(x, y) for y in range(1, self.ny + 1)
                for x in range(1, self.nx + 1)
                if self.interior_type_name(x) == name]


def assign_columns(arch: Arch, n: int) -> Dict[int, str]:
    """Interior column -> heterogeneous type name (first spec wins),
    SetupGrid.c column fill semantics."""
    cols: Dict[int, str] = {}
    for spec in arch.column_types:
        for x in range(spec.start, n + 1, spec.repeat):
            cols.setdefault(x, spec.type_name)
    return cols


def size_grid(num_clb: int, num_io: int, arch: Arch,
              nx: int = 0, ny: int = 0,
              hard_counts: Optional[Dict[str, int]] = None) -> DeviceGrid:
    """Smallest square grid fitting the design (binary-search equivalent of
    vpr_api.c:286-299; linear scan once heterogeneous columns make the
    capacity function non-monotone in closed form).

    hard_counts: blocks needed per heterogeneous type name."""
    hard_counts = hard_counts or {}
    spec_types = {s.type_name for s in arch.column_types}
    for t, c in hard_counts.items():
        if c > 0 and t not in spec_types:
            raise ValueError(f"netlist needs '{t}' blocks but the arch "
                             f"has no {t} columns")

    def capacities(w: int, h: int):
        cols = assign_columns(arch, w)
        n_hard_cols: Dict[str, int] = {}
        for x in range(1, w + 1):
            t = cols.get(x)
            if t is not None:
                n_hard_cols[t] = n_hard_cols.get(t, 0) + 1
        clb_cols = w - sum(n_hard_cols.values())
        return cols, clb_cols * h, {t: c * h for t, c in
                                    n_hard_cols.items()}

    def fits(n: int) -> bool:
        _, clb_cap, hard_cap = capacities(n, n)
        if clb_cap < num_clb or 4 * n * arch.io_capacity < num_io:
            return False
        return all(hard_cap.get(t, 0) >= c for t, c in hard_counts.items())

    if nx and ny:
        g = DeviceGrid(nx, ny, arch.io_capacity,
                       col_types=assign_columns(arch, nx))
    else:
        n = max(1,
                math.ceil(math.sqrt(max(1, num_clb))),
                math.ceil(num_io / (4 * max(1, arch.io_capacity))))
        while not fits(n):
            n += 1
        g = DeviceGrid(n, n, arch.io_capacity,
                       col_types=assign_columns(arch, n))
    cols, clb_cap, hard_cap = capacities(g.nx, g.ny)
    if clb_cap < num_clb:
        raise ValueError(f"grid {g.nx}x{g.ny} too small for {num_clb} CLBs")
    if len(g.io_sites()) * g.io_capacity < num_io:
        raise ValueError(f"grid {g.nx}x{g.ny} too small for {num_io} IOs")
    for t, c in hard_counts.items():
        if hard_cap.get(t, 0) < c:
            raise ValueError(f"grid {g.nx}x{g.ny}: {c} '{t}' blocks need "
                             f"more {t} columns")
    return g
