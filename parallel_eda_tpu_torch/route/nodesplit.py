"""The node axis of a (net, node) mesh: each net's canvases split by
canvas columns (X) over the devices of its node row, with a line scan
across the members that keeps ``lax.associative_scan``'s grouping, so
that the relaxation is bit-identical to one device (the JAX package
gets this from GSPMD: planes.py's ``P("net", None, "node", None)``
constraint on the [B, W, X, Y] canvases).

Column segmentation (the row mesh's rule, planes_shard.row_block_cols):
with m members and an NX-column grid, kx = max(2, ceil((NX + 2) / m));
member r holds the x-plane columns [r*kx, min((r+1)*kx, NX)) and the
y-plane columns [r*kx, min((r+1)*kx, NX+1)).  The segments are
contiguous and in member order.  The y plane has NX+1 columns, so the
member whose segment reaches NX also holds column NX: its y segment is
its x segment plus that column (and may be that column alone).  A
member with r*kx > NX holds no column of either plane and takes no part
(``active_members``): the active members are the first floor(NX / kx) + 1.

A member relaxes its block (planes_shard's layout: local column 0 is
global column r*kx - 1, its owned columns are local 1..kx) and, per
sweep, exchanges with the others exactly what the one-device sweep
reads across its segment's edges:

  x-scans     forward, then backward: the cross-segment scan below,
              one exchange each;
  dx halo     local dx column 0 <- the left member's column kx, of this
              sweep (after its x-scans): the turn into y of local y
              column 1 reads it;
  turn into y, y-scans (whole columns, local);
  dy halo     local dy column kx+1 <- the right member's column 1, of
              this sweep (after its y-scans): the turn into x of local x
              column kx reads it;
  turn into x.

The cross-segment scan.  The one-device scan of a line of n cells is
the in-place tree of ``planes._assoc_scan`` (csrc/planes_relax.cu
warp_scan): up level k combines positions ((2i+1)2^k - 1, (2i+2)2^k - 1)
into the second, down level k combines (2i 2^k - 1, (2i+1)2^k - 1) for
i >= 1; combine((c1, m1), (c2, m2)) = (c1 + c2, min(m1 + c2, m2)).  The
backward scan runs the same tree on the flipped line (position n-1-x),
so its segments are the mirror images.  ``scan_schedule`` follows every
value of that tree (an element, or a combine of two earlier values) and
the cells it depends on, an interval of the line: a value is local to
the member whose segment holds its interval.  For each member it lists

  * phase 1, before the exchange: the local combines it needs, in tree
    order (grouped by level);
  * the values it publishes: its local values that are operands of a
    combine whose interval crosses a segment edge and that another
    member needs (the maximal aligned sub-blocks of its segment, at
    most ~2 log2 n per line), with the mask of members that read each;
  * the values it reads from the others (``inject``);
  * phase 2, after the exchange: the crossing combines its own cells
    depend on, evaluated redundantly by each member that needs them,
    with the same operands in the same order as on one device.

Every combine of the one-device tree that feeds a member's cells is
evaluated by that member or by the member that publishes its result,
on the same operands, so every cell's result has the same bits.  Values
live in slots (each value its own slot: phase 2 never overwrites a
value phase 1 published).  The plain version (``run_phase1``,
``published``, ``run_phase2``) and the CUDA kernel
(``planes_kernels.node_tables``) read the same schedules.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch


def node_cols(NX: int, m: int) -> int:
    """Columns per member (kx) of an m-member node row on an NX-column
    grid: the row mesh's block width (planes_shard.row_block_cols)."""
    return max(2, -(-(NX + 2) // m))


def active_members(NX: int, m: int) -> int:
    """Members of an m-member node row that hold a column: the first
    floor(NX / kx) + 1 (at most m)."""
    return min(m, NX // node_cols(NX, m) + 1)


def x_segments(NX: int, m: int):
    """The active members' x-plane column segments [(start, end), ...]
    (an end may equal its start: a member holding only y column NX)."""
    kx = node_cols(NX, m)
    return tuple((min(r * kx, NX), min((r + 1) * kx, NX))
                 for r in range(active_members(NX, m)))


def y_segments(NX: int, m: int):
    """The active members' y-plane column segments (NX + 1 columns)."""
    kx = node_cols(NX, m)
    return tuple((min(r * kx, NX + 1), min((r + 1) * kx, NX + 1))
                 for r in range(active_members(NX, m)))


def tree_levels(n: int):
    """The in-place scan tree of a line of n cells: per level, its
    (lo, hi) combines (planes._assoc_scan's operand pairs; the result
    goes to hi)."""
    levels = []
    span = 1
    while 2 * span <= n:
        levels.append(tuple(((2 * i + 1) * span - 1, (2 * i + 2) * span - 1)
                            for i in range(n // (2 * span))))
        span *= 2
    span //= 2
    while span >= 1:
        cnt = (n // span - 1) // 2
        levels.append(tuple((2 * i * span - 1, (2 * i + 1) * span - 1)
                            for i in range(1, cnt + 1)))
        span //= 2
    return tuple(lv for lv in levels if lv)


@dataclass(frozen=True)
class MemberScan:
    """One member's part of a cross-segment scan.  Slots hold (c, m)
    values; combines are (left slot, right slot, out slot) triples."""
    nslots: int
    in_slot: Tuple[int, ...]      # own column offset i -> its element
    out_slot: Tuple[int, ...]     # own column offset i -> its result
    levels1: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    publish: Tuple[Tuple[int, int, int], ...]   # (slot, atom, reader mask)
    inject: Tuple[Tuple[int, int], ...]         # (slot, atom)
    levels2: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def ncombines(self) -> int:
        return sum(len(lv) for lv in self.levels1 + self.levels2)


@dataclass(frozen=True)
class ScanSchedule:
    """The cross-segment scan of a line of ``n`` cells cut into the
    column ``segs`` (member order), forward or ``reverse``: ``natoms``
    published values per line, one MemberScan per member."""
    n: int
    segs: Tuple[Tuple[int, int], ...]
    reverse: bool
    natoms: int
    members: Tuple[MemberScan, ...]


@functools.lru_cache(maxsize=256)
def scan_schedule(n: int, segs, reverse: bool = False) -> ScanSchedule:
    """The schedule of the cross-segment scan (module docstring) of a
    line of ``n`` cells whose columns are cut into the contiguous
    ``segs`` ((start, end) per member, covering 0..n in order; empty
    segments allowed), built once per (n, segs, direction)."""
    segs = tuple((int(s), int(e)) for s, e in segs)
    if (not segs or segs[0][0] != 0 or segs[-1][1] != n
            or any(a[1] != b[0] for a, b in zip(segs, segs[1:]))
            or any(e < s for s, e in segs)):
        raise ValueError(f"segments {segs} do not cut a line of {n} cells")
    pos_of = ((lambda x: n - 1 - x) if reverse else (lambda x: x))
    # segments as position intervals [lo, hi]
    pseg = [(min(pos_of(s), pos_of(e - 1)), max(pos_of(s), pos_of(e - 1)))
            if e > s else None for s, e in segs]
    owner_pos = [0] * n
    for k, (s, e) in enumerate(segs):
        for x in range(s, e):
            owner_pos[pos_of(x)] = k

    # the tree's values: elements 0..n-1, then each combine in order
    left, right, lev = [-1] * n, [-1] * n, [0] * n
    lo_dep, hi_dep = list(range(n)), list(range(n))
    at = list(range(n))
    for li, level in enumerate(tree_levels(n)):
        for lo, hi in level:
            a, b = at[lo], at[hi]
            left.append(a)
            right.append(b)
            lev.append(li + 1)
            lo_dep.append(lo_dep[a])
            hi_dep.append(hi_dep[b])
            at[hi] = len(left) - 1

    def owner(v):
        o = owner_pos[lo_dep[v]]
        iv = pseg[o]
        return o if iv[0] <= lo_dep[v] and hi_dep[v] <= iv[1] else None

    nm = len(segs)
    outs = [[at[pos_of(x)] for x in range(s, e)] for s, e in segs]
    # what each member needs: its local values, the other members'
    # values it reads (atoms), and the crossing combines it evaluates
    needs = []
    for k in range(nm):
        local, inj, glob = set(), set(), set()
        stack = list(outs[k])
        while stack:
            v = stack.pop()
            if v in local or v in inj or v in glob:
                continue
            o = owner(v)
            if o == k:
                local.add(v)
            elif o is not None:
                inj.add(v)
                continue
            else:
                glob.add(v)
            if v >= n:
                stack += (left[v], right[v])
        needs.append((local, inj, glob))
    atoms = sorted({v for _, inj, _ in needs for v in inj},
                   key=lambda v: (owner(v), v))
    atom_ix = {v: i for i, v in enumerate(atoms)}
    readers = {v: 0 for v in atoms}
    for k, (_, inj, _) in enumerate(needs):
        for v in inj:
            readers[v] |= 1 << k

    members = []
    for k, (s, e) in enumerate(segs):
        local, inj, glob = needs[k]
        pub = [v for v in atoms if owner(v) == k]
        # a published value's own local closure
        stack = list(pub)
        while stack:
            v = stack.pop()
            if v in local:
                continue
            local.add(v)
            if v >= n:
                stack += (left[v], right[v])
        elems = [pos_of(x) for x in range(s, e)]
        order = (elems + sorted(v for v in local if v >= n)
                 + sorted(inj) + sorted(glob))
        slot = {v: i for i, v in enumerate(order)}

        def levels(vals):
            by = {}
            for v in sorted(vals):
                by.setdefault(lev[v], []).append(
                    (slot[left[v]], slot[right[v]], slot[v]))
            return tuple(tuple(by[li]) for li in sorted(by))

        members.append(MemberScan(
            nslots=len(order),
            in_slot=tuple(slot[p] for p in elems),
            out_slot=tuple(slot[v] for v in outs[k]),
            levels1=levels(v for v in local if v >= n),
            publish=tuple((slot[v], atom_ix[v], readers[v]) for v in pub),
            inject=tuple((slot[v], atom_ix[v]) for v in sorted(inj)),
            levels2=levels(glob)))
    return ScanSchedule(n, segs, bool(reverse), len(atoms), tuple(members))


def _run_levels(C, M, levels):
    """Evaluate combine levels in place on slot tensors C, M [nslots,
    ...]: within a level every out slot is new and every operand older,
    so a level is one gather and one scatter."""
    for lv in levels:
        idx = torch.tensor(lv, dtype=torch.long, device=C.device)
        a, b, o = idx[:, 0], idx[:, 1], idx[:, 2]
        ca, cb = C.index_select(0, a), C.index_select(0, b)
        ma, mb = M.index_select(0, a), M.index_select(0, b)
        C.index_copy_(0, o, ca + cb)
        M.index_copy_(0, o, torch.minimum(ma + cb, mb))


def run_phase1(ms: MemberScan, c_own, m_own):
    """A member's phase 1 on its own cells: ``c_own`` / ``m_own``
    [len, ...] (own column offset first) -> its slots (C, M) [nslots,
    ...] with the elements placed and the local combines evaluated."""
    shape = (ms.nslots,) + tuple(c_own.shape[1:])
    C = torch.zeros(shape, dtype=c_own.dtype, device=c_own.device)
    M = torch.zeros(shape, dtype=m_own.dtype, device=m_own.device)
    if len(ms.in_slot):
        idx = torch.tensor(ms.in_slot, dtype=torch.long, device=C.device)
        C.index_copy_(0, idx, c_own)
        M.index_copy_(0, idx, m_own)
    _run_levels(C, M, ms.levels1)
    return C, M


def published(ms: MemberScan, slots):
    """The values a member publishes after phase 1: {atom: (c, m)}."""
    C, M = slots
    return {a: (C[s], M[s]) for s, a, _ in ms.publish}


def run_phase2(ms: MemberScan, slots, atoms: dict):
    """A member's phase 2: the other members' values ``atoms`` ({atom:
    (c, m)}, on this member's device) placed, the crossing combines
    evaluated; returns the scanned m of its own cells [len, ...]."""
    C, M = slots
    for s, a in ms.inject:
        C[s] = atoms[a][0]
        M[s] = atoms[a][1]
    _run_levels(C, M, ms.levels2)
    idx = torch.tensor(ms.out_slot, dtype=torch.long, device=C.device)
    return M.index_select(0, idx)


def decomposed_scan(c, m, segs, reverse: bool = False):
    """The min-plus scan of lines ``c`` / ``m`` [..., n] (the cost and
    the initial value of each cell, along the last axis) run member by
    member over the column ``segs`` with the explicit exchange: the
    scanned m [..., n], bit-identical to planes._minplus_scan along that
    axis (the schedule's check)."""
    n = c.shape[-1]
    sch = scan_schedule(n, tuple(segs), reverse)
    cl = c.movedim(-1, 0)
    ml = m.movedim(-1, 0)
    slots = [run_phase1(ms, cl[s:e], ml[s:e])
             for ms, (s, e) in zip(sch.members, segs)]
    box = {}
    for ms, sl in zip(sch.members, slots):
        box.update(published(ms, sl))
    out = [run_phase2(ms, sl, box) for ms, sl in zip(sch.members, slots)]
    return torch.cat(out, 0).movedim(0, -1)
