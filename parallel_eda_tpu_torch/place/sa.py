"""Simulated-annealing placer with batched parallel moves, in PyTorch:
the counterpart of the JAX package's place/sa.py.

Every device step proposes M moves at once (vpr/SRC/place/place.c:246
try_swap, batched), keeps the conflict-free subset by a lowest-index
claim on every source and destination site, evaluates all delta costs
with one batched gather and reduce, and applies the accepted moves with
disjoint scatters.  Cost is VPR's linear-congestion wirelength plus, when
timing-driven, criticality-weighted lookup delays; the schedule is
place.c's (update_t, update_rlim, exit_crit, starting_t).  See the JAX
package for the design; this module keeps its semantics bit for bit.

What "bit for bit" takes:

- The moves are drawn from ``place/prng.py``, the exact threefry2x32
  stream of ``jax.random``, keyed as the JAX package keys it.  A
  segment's draws depend only on its key, so they are hashed for the
  whole segment in a few batched calls before its first step.
- Every float reduction runs in XLA:CPU's order without multiply-add
  contraction (the JAX reference runs under ``--xla_cpu_max_isa=AVX``;
  see "sums" below).  The products and sums are separate ops, rounded
  one at a time.
- ``exp`` in the Metropolis test is the device's own: a decision differs
  from JAX's only when ``u`` falls in the last ulp of
  ``exp(-delta/t)``, which the tests count.

The segment keeps t, rlim, ``done`` and the bb cost on the device, as
the JAX ``lax.scan`` carry does, and ``Placer.place`` reads the device
once per segment (and once more for the criticalities when
timing-driven).  Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..netlist.packed import PackedNetlist
from ..obs import get_metrics, span
from ..rr.grid import DeviceGrid
from . import prng

# VPR's expected-crossing-count correction for the linear-congestion bb cost
# (place.c cross_count table, nets of 1..50 pins; beyond 50 extrapolated)
_CROSS_COUNT = [
    1.0, 1.0, 1.0, 1.0828, 1.1536, 1.2206, 1.2823, 1.3385, 1.3991, 1.4493,
    1.4974, 1.5455, 1.5937, 1.6418, 1.6899, 1.7304, 1.7709, 1.8114, 1.8519,
    1.8924, 1.9288, 1.9652, 2.0015, 2.0379, 2.0743, 2.1061, 2.1379, 2.1698,
    2.2016, 2.2334, 2.2646, 2.2958, 2.3271, 2.3583, 2.3895, 2.4187, 2.4479,
    2.4772, 2.5064, 2.5356, 2.5610, 2.5864, 2.6117, 2.6371, 2.6625, 2.6887,
    2.7148, 2.7410, 2.7671, 2.7933,
]
_BIG = 10 ** 6
F32 = torch.float32


def crossing_factor(num_pins: np.ndarray) -> np.ndarray:
    """q per net of num_pins terminals: table entry num_pins-1 for 1..50
    pins, linear extrapolation beyond (place.c get_crossing_count)."""
    n = np.asarray(num_pins)
    idx = np.clip(n - 1, 0, 49)
    q = np.where(n <= 50, np.array(_CROSS_COUNT)[idx],
                 2.7933 + 0.02616 * (n - 50))
    return q.astype(np.float32)


# ---------------------------------------------------------------- sums
#
# XLA:CPU's float32 reduction orders, read from its optimized IR under
# --xla_cpu_max_isa=AVX (jax 0.9.0; ROADMAP.md C6).  LLVM vectorizes a
# reduction loop (reassociation allowed) or leaves it scalar by its cost
# model, so the order is a property of each reduction site and its trip
# counts, not of the data:
# - over more than 32 elements, TreeReductionRewriter's windows of 32
#   (the padding split low/high, low = pad // 2) come first, each summed
#   in order, then the window sums (_tree_sum);
# - the per-move bb delta over 2F nets: four lanes from 16 to 32
#   (_row_sum);
# - the starting-temperature moments over the M moves: 8 lanes
#   (wirelength) or 4 (timing) for 16 <= M <= 32, two accumulators when
#   M // lanes is even (_moment_sum);
# - the timing delta and the segment's td cost: row-major, in order,
#   within those windows, four lanes over unpadded rows (_sum2);
# - an eager net_td_cost over [NN, P]: lanes over its rows (_eager_sum2);
# - everything else: left to right from +0.0 (_seq_sum).
# tests/test_torch_sum_order.py holds each rule against XLA over sweeps
# of trip counts; ROADMAP.md C6 lists the shapes outside them.

def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis, from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _centre_pad(n: int) -> Tuple[int, int]:
    pad = (-n) % 32
    return pad // 2, pad - pad // 2


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 sum over the last axis."""
    while x.shape[-1] > 32:
        x = F.pad(x, _centre_pad(x.shape[-1]))
        x = _seq_sum(x.reshape(*x.shape[:-1], -1, 32))
    return _seq_sum(x)


def _combine(c: torch.Tensor) -> torch.Tensor:
    """Lanes [..., vf] added by halves ((l0 + l2) + (l1 + l3) at 4)."""
    while c.shape[-1] > 1:
        h = c.shape[-1] // 2
        c = c[..., :h] + c[..., h:]
    return c[..., 0]


def _lanes0(shape, vf: int, like: torch.Tensor) -> torch.Tensor:
    """A vector accumulator: lane 0 at +0.0, the rest at -0.0."""
    p = torch.full((*shape, vf), -0.0, dtype=like.dtype, device=like.device)
    p[..., 0] = 0.0
    return p


def _vec_sum(x: torch.Tensor, vf: int, ic: int = 1) -> torch.Tensor:
    """LLVM's vectorized float32 reduction over the last axis: ``ic``
    interleaved accumulators of ``vf`` lanes take consecutive blocks of
    vf elements (lane 0 of the first starts at +0.0, the rest at -0.0),
    the accumulators are added in order, the lanes combine by halves,
    and the leftover elements follow one by one."""
    n = x.shape[-1]
    W = vf * ic
    iters = n // W
    if iters == 0:
        return _seq_sum(x)
    parts = [_lanes0(x.shape[:-1], vf, x)] + [
        torch.full((*x.shape[:-1], vf), -0.0, dtype=x.dtype,
                   device=x.device) for _ in range(ic - 1)]
    for i in range(iters):
        for k in range(ic):
            parts[k] = parts[k] + x[..., i * W + k * vf:i * W + (k + 1) * vf]
    c = parts[0]
    for k in range(1, ic):
        c = parts[k] + c
    acc = _combine(c)
    for i in range(iters * W, n):
        acc = acc + x[..., i]
    return acc


def _lane_sum(x: torch.Tensor, vf: int = 4) -> torch.Tensor:
    """``vf`` lanes over the rows of [..., A, P]: lane r adds rows r,
    r + vf, ... of each block of vf rows, each row's P values in order;
    the lanes combine by halves, and the rows left over follow one by
    one."""
    A, P = x.shape[-2:]
    lanes = _lanes0(x.shape[:-2], vf, x)
    for i in range(A // vf):
        for p in range(P):
            lanes = lanes + x[..., vf * i:vf * i + vf, p]
    acc = _combine(lanes)
    for a in range(A - A % vf, A):
        for p in range(P):
            acc = acc + x[..., a, p]
    return acc


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The per-move bb delta sum over the 2F nets (vectorized at four
    lanes for 16 <= 2F <= 32)."""
    n = x.shape[-1]
    return _vec_sum(x, 4) if 16 <= n <= 32 else _tree_sum(x)


def _moment_sum(x: torch.Tensor, timing: bool) -> torch.Tensor:
    """The starting-temperature moments dsum and dsq over the M moves:
    LLVM takes 8 lanes (4 when timing-driven) for 16 <= M <= 32, with a
    second interleaved accumulator when M // lanes is even; scalar below
    16, TreeReductionRewriter's windows above 32 (held for every M from
    8 to 34 and 13 values from 40 to 2,048 by the slow sweep of
    tests/test_torch_sum_order.py)."""
    M = x.shape[-1]
    if not 16 <= M <= 32:
        return _tree_sum(x)
    vf = 4 if timing else 8
    return _vec_sum(x, vf, 2 if (M // vf) % 2 == 0 else 1)


def _sum2(x: torch.Tensor) -> torch.Tensor:
    """A sum over the last two axes fused into the step or the segment:
    row-major and scalar within TreeReductionRewriter's 32 x 32 windows
    (the padding split low/high), then the window sums; windows of 32
    unpadded rows (P <= 32) take four lanes over their rows."""
    A, P = x.shape[-2:]
    if A <= 32 and P <= 32:
        return _seq_sum(x.reshape(*x.shape[:-2], A * P))
    if A % 32 == 0 and P <= 32:
        return _tree_sum(_lane_sum(x.reshape(*x.shape[:-2], A // 32, 32,
                                             P)))
    pa = _centre_pad(A) if A > 32 else (0, 0)
    pp = _centre_pad(P) if P > 32 else (0, 0)
    x = F.pad(x, (*pp, *pa))
    wa = 32 if A > 32 else A
    wp = 32 if P > 32 else P
    lead = x.shape[:-2]
    na, npp = x.shape[-2] // wa, x.shape[-1] // wp
    x = x.reshape(*lead, na, wa, npp, wp).transpose(-3, -2)
    return _sum2(_seq_sum(x.reshape(*lead, na, npp, wa * wp)))


def _eager_sum2(x: torch.Tensor) -> torch.Tensor:
    """A standalone sum over all of [A, P] (an eager net_td_cost).  P = 1
    sums as one axis.  Up to 32 rows: four lanes over the rows for A >=
    16 and A in (4, 8) (eight at [8, 3]), two for A = 2, else in order.
    Over 32: windows of 32 rows, each in four lanes when unpadded; with
    one padding row (after the last) each window takes four lanes over
    the 31 rows every window holds, then its 32nd row; otherwise each
    window in order; then the window sums as one axis.  P > 32 takes
    _sum2's order, which XLA's differs from at some shapes (ROADMAP.md
    C6)."""
    A, P = x.shape
    if P == 1:
        return _tree_sum(x[:, 0])
    if P > 32:
        return _sum2(x)
    if A <= 32:
        if (A, P) == (8, 3):
            return _lane_sum(x, 8)
        if A >= 16 or A in (4, 8):
            return _lane_sum(x)
        return _lane_sum(x, 2) if A == 2 else _seq_sum(x.reshape(-1))
    lo, hi = _centre_pad(A)
    w = F.pad(x, (0, 0, lo, hi)).reshape(-1, 32, P)
    if lo > 0:
        return _tree_sum(_seq_sum(w.reshape(-1, 32 * P)))
    if hi == 0:
        return _tree_sum(_lane_sum(w))
    s = _lane_sum(w[:, :31])
    full = torch.arange(w.shape[0], device=x.device) < A // 32
    for p in range(P):
        s = torch.where(full, s + w[:, 31, p], s)
    return _tree_sum(s)


# ---------------------------------------------------------------- problem

@dataclass
class PlaceProblem:
    """Static placement data as tensors on one device (JAX
    ``PlaceProblem``; index tables int64)."""
    # per-net pin ELL: blocks of each costed net, padded with -1.
    # slot 0 is the net driver; slots >= 1 are sink blocks (deduped)
    net_blk: torch.Tensor       # [NN, P]
    net_valid: torch.Tensor     # bool [NN, P]
    net_q: torch.Tensor         # f32 [NN] crossing factor
    blk_net: torch.Tensor       # [NB, F] costed nets of each block, -1 pad
    is_io: torch.Tensor         # bool [NB]
    ring_xy: torch.Tensor       # [NRING, 2] perimeter ring tile coords
    type_id: torch.Tensor       # [NB] interior type index
    col_list: torch.Tensor      # [T, Cmax] interior columns per type
    ncols: torch.Tensor         # [T]
    col_idx_of_x: torch.Tensor  # [T, nx+2] nearest own-column index
    delta: torch.Tensor         # f32 [4, nx+2, ny+2] delay lookup stack
    movable: torch.Tensor       # [NBm] blocks eligible for single moves
    frozen: torch.Tensor        # bool [NB] macro members
    nx: int = 0
    ny: int = 0
    io_cap: int = 1

    @property
    def num_blocks(self) -> int:
        return self.blk_net.shape[0]

    @property
    def num_sites(self) -> int:
        return self.nx * self.ny + self.ring_xy.shape[0] * self.io_cap

    @property
    def device(self) -> torch.device:
        return self.net_blk.device


@dataclass
class PlacerOpts:
    """Annealing knobs (t_annealing_sched / t_placer_opts,
    vpr/SRC/base/vpr_types.h; defaults per SetupVPR.c / place.c)."""
    moves_per_step: int = 256      # M: concurrent proposed moves
    inner_num: float = 1.0         # moves/temp = inner_num * NB^(4/3)
    exit_t_frac: float = 0.005     # exit when t < frac / num_nets
    max_temps: int = 500
    seed: int = 0
    # timing-driven knobs (PATH_TIMING_DRIVEN_PLACE, place.c comp_td_costs)
    timing_tradeoff: float = 0.5   # 0 = pure wirelength
    td_place_exp: float = 8.0      # criticality exponent
    recompute_crit_temps: int = 1  # STA recompute cadence (temperatures)


@dataclass
class PlaceStats:
    temps: List[Tuple[float, float, float, float]] = field(
        default_factory=list)   # (t, bb_cost, success_rate, rlim)
    initial_cost: float = 0.0
    final_cost: float = 0.0
    final_td_cost: float = 0.0
    est_crit_path: float = float("nan")  # lookup-delay STA estimate
    total_moves: int = 0
    # the port's own counters: anneal segments, and the device reads of
    # the whole place() (one per segment, plus the positions the STA
    # reads when timing-driven, plus the few around the anneal)
    segments: int = 0
    host_reads: int = 0


def build_place_problem(pnl: PackedNetlist, grid: DeviceGrid, lookup=None,
                        macros=None, device="cuda") -> PlaceProblem:
    """The tables the device step needs, on ``device``.  ``lookup``: a
    place.delay_lookup.DelayLookup for timing-driven placement (zeros
    otherwise, so the td cost is 0).  ``macros``: block-id chains
    (place/macros.py) whose members are frozen out of single moves."""
    dev = resolve_device(device)
    NB = pnl.num_blocks
    costed = [i for i, n in enumerate(pnl.nets)
              if not n.is_global and n.sinks]
    NN = max(1, len(costed))

    # per-net block lists (driver + sinks; a block pinned twice counts once)
    net_blocks = []
    for ni in costed:
        n = pnl.nets[ni]
        uniq = list(dict.fromkeys(
            [n.driver.block] + [p.block for p in n.sinks]))
        net_blocks.append(uniq)
    P = max(1, max((len(b) for b in net_blocks), default=1))
    net_blk = np.full((NN, P), -1, dtype=np.int64)
    for i, blks in enumerate(net_blocks):
        net_blk[i, :len(blks)] = blks
    npins = np.array([len(b) for b in net_blocks] + [1] * (NN - len(costed)),
                     dtype=np.int32)[:NN]

    blk_nets = [[] for _ in range(NB)]
    for i, blks in enumerate(net_blocks):
        for b in blks:
            blk_nets[b].append(i)
    Fw = max(1, max((len(x) for x in blk_nets), default=1))
    blk_net = np.full((NB, Fw), -1, dtype=np.int64)
    for b, nets in enumerate(blk_nets):
        blk_net[b, :len(nets)] = nets

    is_io = np.array([pnl.block_type(i).is_io for i in range(NB)], dtype=bool)
    ring = np.array(grid.io_sites(), dtype=np.int64)

    # interior type tables (heterogeneous columns)
    itypes = ["clb"] + sorted({t for t in grid.col_types.values()})
    tid_of = {t: i for i, t in enumerate(itypes)}
    cols_by_t = {t: [x for x in range(1, grid.nx + 1)
                     if grid.interior_type_name(x) == t] for t in itypes}
    type_id = np.zeros(NB, dtype=np.int64)
    for i in range(NB):
        if not is_io[i]:
            t = pnl.blocks[i].type_name
            if t not in tid_of or not cols_by_t[t]:
                raise ValueError(f"block type '{t}' has no columns")
            type_id[i] = tid_of[t]
    Cmax = max(1, max(len(c) for c in cols_by_t.values()))
    col_list = np.zeros((len(itypes), Cmax), dtype=np.int64)
    ncols = np.zeros(len(itypes), dtype=np.int64)
    col_idx_of_x = np.zeros((len(itypes), grid.nx + 2), dtype=np.int64)
    for t, cols in cols_by_t.items():
        ti = tid_of[t]
        cols = cols or [1]
        col_list[ti, :len(cols)] = cols
        col_list[ti, len(cols):] = cols[-1]
        ncols[ti] = len(cols)
        ca = np.array(cols)
        for x in range(grid.nx + 2):
            col_idx_of_x[ti, x] = int(np.abs(ca - x).argmin())

    # delta-delay stack [4, nx+2, ny+2]: (clb_clb, io_clb, clb_io, io_io);
    # the same array the host criticality path indexes (DelayLookup.stack)
    H, W = grid.nx + 2, grid.ny + 2
    if lookup is not None:
        delta = np.asarray(lookup.stack, dtype=np.float32)
        if delta.shape != (4, H, W):
            raise ValueError(f"delay lookup stack {delta.shape}, want "
                             f"{(4, H, W)}")
    else:
        delta = np.zeros((4, H, W), dtype=np.float32)

    frozen = np.zeros(NB, dtype=bool)
    for m in (macros or []):
        frozen[list(m)] = True
    movable = np.where(~frozen)[0].astype(np.int64)
    if len(movable) == 0:
        movable = np.zeros(1, dtype=np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return PlaceProblem(
        net_blk=t(net_blk), net_valid=t(net_blk >= 0),
        net_q=t(crossing_factor(npins)), blk_net=t(blk_net),
        is_io=t(is_io), ring_xy=t(ring), type_id=t(type_id),
        col_list=t(col_list), ncols=t(ncols), col_idx_of_x=t(col_idx_of_x),
        delta=t(delta), movable=t(movable), frozen=t(frozen),
        nx=grid.nx, ny=grid.ny, io_cap=grid.io_capacity)


# ---------------------------------------------------------------- site maps

def _site_of(pp: PlaceProblem, pos: torch.Tensor, ring_idx: torch.Tensor
             ) -> torch.Tensor:
    """Unified site id per block: CLB sites [0, nx*ny), then IO ring
    sites.  ring_idx [NB] is the block's ring tile index (-1 for CLBs)."""
    clb = (pos[:, 1] - 1) * pp.nx + (pos[:, 0] - 1)
    io = pp.nx * pp.ny + ring_idx * pp.io_cap + pos[:, 2]
    return torch.where(pp.is_io, io, clb)


def _ring_index_host(grid: DeviceGrid) -> dict:
    return {xy: i for i, xy in enumerate(grid.io_sites())}


# ---------------------------------------------------------------- cost

def _conn_delay(pp: PlaceProblem, sx, sy, s_io, tx, ty, t_io):
    """Lookup delay source -> sink from the delta stack (broadcasting)."""
    sel = torch.where(s_io & t_io, 3,
                      torch.where(s_io, 1, torch.where(t_io, 2, 0)))
    dx = torch.clamp((tx - sx).abs(), 0, pp.nx + 1)
    dy = torch.clamp((ty - sy).abs(), 0, pp.ny + 1)
    return pp.delta[sel, dx, dy]


def net_td_cost(pp: PlaceProblem, pos: torch.Tensor, crit: torch.Tensor,
                fused: bool = False) -> torch.Tensor:
    """Timing cost  sum_conn crit * delay(driver -> sink)  over all costed
    connections (comp_td_costs; slot 0 = driver); a 0-d f32 tensor.
    ``fused``: summed in the order of the JAX segment's fused reduce
    rather than that of an eager call."""
    blk = torch.clamp(pp.net_blk, min=0)
    x, y = pos[blk, 0], pos[blk, 1]
    iof = pp.is_io[blk]
    d = _conn_delay(pp, x[:, :1], y[:, :1], iof[:, :1], x, y, iof)
    P = pp.net_blk.shape[1]
    is_sink = (torch.arange(P, device=pos.device)[None, :] > 0) & \
        pp.net_valid
    d = torch.where(is_sink, crit * d, 0.0)
    return _sum2(d) if fused else _eager_sum2(d)


def net_bb_cost(pp: PlaceProblem, pos: torch.Tensor):
    """Dense bb cost of all costed nets: (0-d f32 total, bb [NN, 4])."""
    blk = torch.clamp(pp.net_blk, min=0)
    px, py = pos[blk, 0], pos[blk, 1]
    xmin = torch.where(pp.net_valid, px, _BIG).amin(dim=1)
    ymin = torch.where(pp.net_valid, py, _BIG).amin(dim=1)
    xmax = torch.where(pp.net_valid, px, -_BIG).amax(dim=1)
    ymax = torch.where(pp.net_valid, py, -_BIG).amax(dim=1)
    cost = pp.net_q * ((xmax - xmin + 1) + (ymax - ymin + 1)).to(F32)
    return _tree_sum(cost), torch.stack([xmin, xmax, ymin, ymax], dim=1)


# ---------------------------------------------------------------- draws

# the raw 32-bit draws of one step, in the order _draws hashes them:
# (hi, lo) words of randint k1, k2b, k3 and k4, then uniform k2 and ka
_RAW = ("b_hi", "b_lo", "dy_hi", "dy_lo", "dr_hi", "dr_lo", "z_hi", "z_lo",
        "u_col", "u_acc")


def _draws(step_keys: torch.Tensor, M: int) -> torch.Tensor:
    """Raw bits [..., 10, M] of the steps keyed by ``step_keys`` [..., 2]:
    sa_step's split(key) -> (kp, ka), _propose's split(kp, 5) -> (k1,
    k2, k2b, k3, k4), each randint's split into its two words."""
    kpa = prng.split(step_keys, 2)
    k5 = prng.split(kpa[..., 0, :], 5)
    words = prng.split(torch.cat([k5[..., :1, :], k5[..., 2:, :]], dim=-2),
                       2)                                 # [..., 4, 2, 2]
    lead = step_keys.shape[:-1]
    keys = torch.cat([words.reshape(*lead, 8, 2), k5[..., 1:2, :],
                      kpa[..., 1:2, :]], dim=-2)
    return prng.random_bits(keys, (M,))


_DRAWN = ("mv", "u_col", "dy", "dr", "nz", "u_acc")


@dataclass
class _StepDraws:
    """One step's (or a stack of steps') draws after the conversions,
    which depend only on the range limit rl: block choice, column offset,
    dy, ring shift, subtile and the Metropolis uniforms."""
    mv: torch.Tensor      # index into pp.movable
    u_col: torch.Tensor   # uniform [-1, 1)
    dy: torch.Tensor
    dr: torch.Tensor
    nz: torch.Tensor
    u_acc: torch.Tensor   # uniform [0, 1)
    rl: torch.Tensor      # 0-d: the range limit they were converted at

    def step(self, i: int) -> "_StepDraws":
        return _StepDraws(*(getattr(self, f)[i] for f in _DRAWN),
                          rl=self.rl)


def _rl(rlim: torch.Tensor) -> torch.Tensor:
    return torch.clamp(rlim.to(torch.int64), min=1)


def _convert(pp: PlaceProblem, raw: torch.Tensor, rlim: torch.Tensor
             ) -> _StepDraws:
    """Raw bits [..., 10, M] -> the draws at range limit ``rlim``."""
    r = dict(zip(_RAW, raw.unbind(dim=-2)))
    rl = _rl(rlim)
    return _StepDraws(
        mv=prng.randint_from_bits(r["b_hi"], r["b_lo"], 0,
                                  pp.movable.shape[0]),
        u_col=prng.uniform_from_bits(r["u_col"], -1.0, 1.0),
        dy=prng.randint_from_bits(r["dy_hi"], r["dy_lo"], -rl, rl + 1),
        dr=prng.randint_from_bits(r["dr_hi"], r["dr_lo"], -2 * rl,
                                  2 * rl + 1),
        nz=prng.randint_from_bits(r["z_hi"], r["z_lo"], 0, pp.io_cap),
        u_acc=prng.uniform_from_bits(r["u_acc"]), rl=rl)


# ---------------------------------------------------------------- one step

def _col_target(pp: PlaceProblem, tid, x0, u, rl):
    """Interior target column: a window around the block's column index
    in its own type's column list (rlim mapped into column-index space)."""
    nc = pp.ncols[tid]
    rl_col = torch.clamp((rl * nc) // pp.nx, min=1)
    ci0 = pp.col_idx_of_x[tid, x0]
    ci = ci0 + torch.round(u * rl_col.to(F32)).to(torch.int64)
    ci = torch.minimum(torch.clamp(ci, min=0), nc - 1)
    return pp.col_list[tid, ci]


def _propose(pp: PlaceProblem, pos, ring_idx, d: _StepDraws):
    """M moves from one step's draws: (block [M], new_pos [M,3],
    new_ring [M])."""
    b = pp.movable[d.mv]
    bio = pp.is_io[b]
    cx = _col_target(pp, pp.type_id[b], pos[b, 0], d.u_col, d.rl)
    cy = torch.clamp(pos[b, 1] + d.dy, 1, pp.ny)
    # IO target: shift along the perimeter ring, random subtile
    nring = torch.remainder(ring_idx[b] + d.dr, pp.ring_xy.shape[0])
    nxny = torch.where(bio[:, None], pp.ring_xy[torch.clamp(nring, min=0)],
                       torch.stack([cx, cy], dim=1))
    npos = torch.cat([nxny, torch.where(bio, d.nz, 0)[:, None]], dim=1)
    return b, npos, torch.where(bio, nring, -1)


@dataclass
class StepTrace:
    """Everything one sa_step decided (for the parity tests): the
    proposals, the site claims, the deltas, the accept mask and the
    scatter indices of the applies (drop slots NB and NS)."""
    b: torch.Tensor
    npos: torch.Tensor
    nring: torch.Tensor
    own: torch.Tensor
    delta: torch.Tensor
    u: torch.Tensor
    thresh: torch.Tensor   # exp(-delta / max(t, 1e-30))
    accept: torch.Tensor
    blk_idx: torch.Tensor  # [2M] blocks written (b then occupants)
    site_idx: torch.Tensor  # [2M] sites written (src then dst)


def _step(pp: PlaceProblem, pos, ring_idx, occ, crit, inv_bb, inv_td,
          tradeoff, t, d: _StepDraws, timing: bool, trace: bool = False):
    """sa_step on converted draws.  Returns (pos, ring_idx, occ, n_acc,
    n_valid, dvalid, StepTrace or None); counts and dvalid stay on the
    device, and the trace is built only when asked for."""
    NB, NS = pp.num_blocks, pp.num_sites
    M = d.mv.shape[0]
    dev = pos.device
    b, npos, nring = _propose(pp, pos, ring_idx, d)
    bio = pp.is_io[b]

    src = _site_of(pp, pos, ring_idx)[b]
    clb_site = (npos[:, 1] - 1) * pp.nx + (npos[:, 0] - 1)
    io_site = pp.nx * pp.ny + nring * pp.io_cap + npos[:, 2]
    dst = torch.where(bio, io_site, clb_site)

    o = occ[dst]                                       # occupant or -1
    ar = torch.arange(M, device=dev)
    # claims: lowest move index wins each site
    claim = torch.full((NS,), M, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(0, src, ar, "amin")
    claim.scatter_reduce_(0, dst, ar, "amin")
    own = ((claim[src] == ar) & (claim[dst] == ar) & (dst != src)
           # a single-block swap must not displace a macro member
           & ~(pp.frozen[torch.clamp(o, min=0)] & (o >= 0)))

    # ---- delta cost of each move (exact under `own` independence) ----
    bnets = pp.blk_net[b]                              # [M, F]
    onets = torch.where(o[:, None] >= 0, pp.blk_net[torch.clamp(o, min=0)],
                        -1)
    dup = (onets[:, :, None] == bnets[:, None, :]).any(dim=2)
    onets = torch.where(dup, -1, onets)
    nets = torch.cat([bnets, onets], dim=1)            # [M, 2F]
    nvalid = nets >= 0
    netsc = torch.clamp(nets, min=0)
    pblk = pp.net_blk[netsc]                           # [M, 2F, P]
    pvalid = pp.net_valid[netsc] & nvalid[:, :, None]
    pbc = torch.clamp(pblk, min=0)
    opx, opy = pos[pbc, 0], pos[pbc, 1]
    # pin coords with the two blocks transposed
    is_b = pblk == b[:, None, None]
    is_o = (pblk == o[:, None, None]) & (o[:, None, None] >= 0)
    px = torch.where(is_b, npos[:, None, None, 0],
                     torch.where(is_o, pos[b, 0][:, None, None], opx))
    py = torch.where(is_b, npos[:, None, None, 1],
                     torch.where(is_o, pos[b, 1][:, None, None], opy))
    q = pp.net_q[netsc]

    def bb_cost(ax, ay):
        xmin = torch.where(pvalid, ax, _BIG).amin(dim=2)
        xmax = torch.where(pvalid, ax, -_BIG).amax(dim=2)
        ymin = torch.where(pvalid, ay, _BIG).amin(dim=2)
        ymax = torch.where(pvalid, ay, -_BIG).amax(dim=2)
        return q * ((xmax - xmin + 1) + (ymax - ymin + 1)).to(F32)

    delta_bb = _row_sum(torch.where(nvalid, bb_cost(px, py)
                                    - bb_cost(opx, opy), 0.0))

    # ---- timing delta: crit * lookup-delay per (driver -> sink) conn ----
    if timing:
        iofg = pp.is_io[pbc]
        critg = crit[netsc]
        P = pp.net_blk.shape[1]
        is_sink = (torch.arange(P, device=dev)[None, None, :] > 0) & pvalid
        d_new = _conn_delay(pp, px[:, :, :1], py[:, :, :1], iofg[:, :, :1],
                            px, py, iofg)
        d_old = _conn_delay(pp, opx[:, :, :1], opy[:, :, :1],
                            iofg[:, :, :1], opx, opy, iofg)
        delta_td = _sum2(torch.where(is_sink, critg * (d_new - d_old), 0.0))
        delta = ((1.0 - tradeoff) * delta_bb * inv_bb
                 + tradeoff * delta_td * inv_td)
    else:
        delta = delta_bb * inv_bb

    # ---- Metropolis ----
    thresh = torch.exp(-delta / torch.clamp(t, min=1e-30))
    accept = own & ((delta <= 0) | (d.u_acc < thresh))

    # ---- apply (accepted moves touch disjoint blocks & sites; every
    # duplicate index lands in the drop slot NB / NS) ----
    bb = torch.where(accept, b, NB)
    oo = torch.where(accept & (o >= 0), o, NB)
    zero = torch.zeros(1, dtype=pos.dtype, device=dev)
    pos2 = torch.cat([pos, zero.expand(1, 3)], dim=0)
    pos2[bb] = npos
    pos2[oo] = pos[b]                  # occupant takes b's old site
    ring2 = torch.cat([ring_idx, zero])
    ring2[bb] = nring
    ring2[oo] = ring_idx[b]
    occ2 = torch.cat([occ, zero])
    ssrc = torch.where(accept, src, NS)
    sdst = torch.where(accept, dst, NS)
    occ2[ssrc] = o                     # -1 if the target was empty
    occ2[sdst] = b

    tr = StepTrace(b=b, npos=npos, nring=nring, own=own, delta=delta,
                   u=d.u_acc, thresh=thresh, accept=accept,
                   blk_idx=torch.cat([bb, oo]),
                   site_idx=torch.cat([ssrc, sdst])) if trace else None
    return (pos2[:NB], ring2[:NB], occ2[:NS], accept.sum(), own.sum(),
            torch.where(own, delta, 0.0), tr)


def _f32(v, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: a tensor as it is, a number
    filled in place (a fill kernel, not a host copy that would wait for
    the device)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(np.float32(v)), dtype=F32, device=device)


def sa_step(pp: PlaceProblem, pos, ring_idx, occ, crit, inv_bb, inv_td,
            tradeoff, key, t, rlim, M: int, timing: bool = False,
            trace: bool = False):
    """One batched SA step (JAX ``sa_step``): M proposals ->
    conflict-free subset -> delta evaluation -> Metropolis on the
    normalized combined cost (1-tt)*dbb*inv_bb + tt*dtd*inv_td -> apply.
    Scalars are 0-d f32 tensors (or numbers) and ``key`` a [2] key.
    Returns (pos, ring_idx, occ, n_acc, n_valid, delta_sum, delta_sq), all
    on the device, and the step's StepTrace last when ``trace``."""
    dev = pos.device
    rlim, t = _f32(rlim, dev), _f32(t, dev)
    d = _convert(pp, _draws(key, M), rlim)
    pos, ring_idx, occ, na, nv, dvalid, tr = _step(
        pp, pos, ring_idx, occ, crit, _f32(inv_bb, dev), _f32(inv_td, dev),
        _f32(tradeoff, dev), t, d, timing, trace)
    out = (pos, ring_idx, occ, na, nv, _moment_sum(dvalid, timing),
           _moment_sum(dvalid * dvalid, timing))
    return out + (tr,) if trace else out


def _temperature(pp, pos, ring_idx, occ, crit, inv_bb, inv_td, tradeoff, t,
                 rlim, raw, timing):
    """All steps of one temperature from its raw draws [S, 10, M]:
    (pos, ring_idx, occ, n_acc, n_valid), the counts on the device."""
    d = _convert(pp, raw, rlim)
    na = nv = torch.zeros((), dtype=torch.int64, device=pos.device)
    for s in range(raw.shape[0]):
        pos, ring_idx, occ, a, v, _, _ = _step(
            pp, pos, ring_idx, occ, crit, inv_bb, inv_td, tradeoff, t,
            d.step(s), timing)
        na, nv = na + a, nv + v
    return pos, ring_idx, occ, na, nv


def sa_temperature(pp: PlaceProblem, pos, ring_idx, occ, crit, inv_bb,
                   inv_td, tradeoff, key, t, rlim, M: int, steps: int,
                   timing: bool = False):
    """All steps of one temperature (JAX ``sa_temperature``): (pos,
    ring_idx, occ, n_acc, n_valid, bb_cost, td_cost) on the device."""
    dev = pos.device
    raw = _draws(prng.split(key, steps), M)
    pos, ring_idx, occ, na, nv = _temperature(
        pp, pos, ring_idx, occ, crit, _f32(inv_bb, dev), _f32(inv_td, dev),
        _f32(tradeoff, dev), _f32(t, dev), _f32(rlim, dev), raw, timing)
    bb_cost, _ = net_bb_cost(pp, pos)
    td_cost = net_td_cost(pp, pos, crit, fused=True) if timing \
        else _f32(0.0, dev)
    return pos, ring_idx, occ, na, nv, bb_cost, td_cost


def sa_segment(pp: PlaceProblem, pos, ring_idx, occ, crit, tradeoff, key, t,
               rlim, exit_t, M: int, steps: int, n_temps: int,
               timing: bool = False):
    """A segment of n_temps whole temperatures (JAX ``sa_segment``): per
    temperature all moves, then update_t / update_rlim (place.c:265) from
    its own success rate, all on the device; once t has fallen below
    exit_t the remaining temperatures run at t = 0 and are reported as
    not live.  No host read.

    Returns (pos, ring_idx, occ, t, rlim, na [n_temps], nv [n_temps],
    bb [n_temps], live [n_temps], ts [n_temps], rls [n_temps])."""
    dev = pos.device
    tradeoff, t, rlim = _f32(tradeoff, dev), _f32(t, dev), _f32(rlim, dev)
    # scalars enter the device ops as Python floats, each cast to float32
    # by the op as JAX's weak-typed constants are
    exit_t = float(np.float32(exit_t))
    rmax = float(max(pp.nx, pp.ny))
    # every draw of the segment: split(key, n_temps), each split(., steps)
    raw = _draws(prng.split(prng.split(key, n_temps), steps), M)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    bb_cost, _ = net_bb_cost(pp, pos)
    rows = []
    for k in range(n_temps):
        td_cost = net_td_cost(pp, pos, crit, fused=True) if timing \
            else torch.ones((), dtype=F32, device=dev)
        inv_bb = 1.0 / torch.clamp(bb_cost, min=1e-30)
        inv_td = 1.0 / torch.clamp(td_cost, min=1e-30)
        t_eff = torch.where(done, 0.0, t)
        pos, ring_idx, occ, na, nv = _temperature(
            pp, pos, ring_idx, occ, crit, inv_bb, inv_td, tradeoff, t_eff,
            rlim, raw[k], timing)
        srat = na.to(F32) / torch.clamp(nv, min=1)
        # update_t (place.c:265)
        fac = torch.where(srat > 0.96, 0.5, torch.where(
            srat > 0.8, 0.9, torch.where((srat > 0.15) | (rlim > 1.0),
                                         0.95, 0.8)))
        t2 = torch.where(done, t, t * fac)
        rlim2 = torch.where(done, rlim, torch.clamp(
            rlim * ((1.0 - 0.44) + srat), 1.0, rmax))
        bb_cost, _ = net_bb_cost(pp, pos)
        rows.append((na, nv, bb_cost, torch.where(done, 0.0, 1.0).to(F32),
                     t, rlim))
        done = done | (t2 < exit_t)
        t, rlim = t2, rlim2
    na, nv, bb, live, ts, rls = (torch.stack(col) for col in zip(*rows))
    return pos, ring_idx, occ, t, rlim, na, nv, bb, live, ts, rls


def _macro_delta_bb(pp: PlaceProblem, pos, blocks, occs, newpos, memv):
    """bb-cost delta of Mm rigid macro moves evaluated jointly: all of a
    proposal's members at their new positions (displaced occupants at the
    members' old ones) at once, so intra-macro nets see no delta under
    pure translation.  blocks/occs [Mm, Lm] (pads -1), newpos [Mm, Lm, 2],
    memv [Mm, Lm].  Returns delta [Mm]."""
    Mm, Lm = blocks.shape
    bc = torch.clamp(blocks, min=0)
    oc = torch.clamp(occs, min=0)
    bnets = torch.where(memv[:, :, None], pp.blk_net[bc], -1)
    onets = torch.where((occs >= 0)[:, :, None], pp.blk_net[oc], -1)
    nets = torch.cat([bnets, onets], dim=1).reshape(Mm, -1)
    # dedupe within a proposal (a net touching two members counts once)
    nets = torch.sort(nets, dim=1).values
    rep = torch.cat([torch.zeros((Mm, 1), dtype=torch.bool,
                                 device=nets.device),
                     nets[:, 1:] == nets[:, :-1]], dim=1)
    nets = torch.where(rep, -1, nets)
    nvalid = nets >= 0
    netsc = torch.clamp(nets, min=0)
    pblk = pp.net_blk[netsc]                       # [Mm, 2LmF, P]
    pvalid = pp.net_valid[netsc] & nvalid[:, :, None]
    px = pos[torch.clamp(pblk, min=0), 0]
    py = pos[torch.clamp(pblk, min=0), 1]
    # member / occupant membership with slot recovery
    eq_m = (pblk[:, :, :, None] == bc[:, None, None, :]) \
        & memv[:, None, None, :]
    is_m = eq_m.any(dim=3)
    mi = torch.argmax(eq_m.to(torch.int32), dim=3)
    eq_o = (pblk[:, :, :, None] == oc[:, None, None, :]) \
        & (occs >= 0)[:, None, None, :]
    is_o = eq_o.any(dim=3) & ~is_m
    oi = torch.argmax(eq_o.to(torch.int32), dim=3)

    def take(v, i):
        return torch.gather(v, 1, i.reshape(Mm, -1)).reshape(i.shape)

    npx = torch.where(is_m, take(newpos[:, :, 0], mi),
                      torch.where(is_o, take(pos[bc, 0], oi), px))
    npy = torch.where(is_m, take(newpos[:, :, 1], mi),
                      torch.where(is_o, take(pos[bc, 1], oi), py))
    q = pp.net_q[netsc]

    def bbsum(ax, ay):
        xmin = torch.where(pvalid, ax, _BIG).amin(dim=2)
        xmax = torch.where(pvalid, ax, -_BIG).amax(dim=2)
        ymin = torch.where(pvalid, ay, _BIG).amin(dim=2)
        ymax = torch.where(pvalid, ay, -_BIG).amax(dim=2)
        return q * ((xmax - xmin + 1) + (ymax - ymin + 1)).to(F32)

    return _tree_sum(torch.where(nvalid, bbsum(npx, npy) - bbsum(px, py),
                                 0.0))


def macro_step(pp: PlaceProblem, mac_blocks, mac_len, pos, ring_idx, occ,
               key, t, rlim, inv_bb, Mm: int, Lm: int, trace: bool = False):
    """Batched rigid macro moves (JAX ``macro_step``, place_macro.c
    semantics): Mm vertical relocations of whole carry-chain macros, each
    member pairwise-swapping with the occupant of (x', y0+i); conflicts
    rejected by the same lowest-index site claims as single moves;
    Metropolis on the joint bb delta.  Interior macros only.  Returns
    (pos, ring_idx, occ, n_acc), plus a dict of the proposals and
    decisions when ``trace``."""
    dev = pos.device
    NM = mac_blocks.shape[0]
    NB, NS = pp.num_blocks, pp.num_sites
    t, rlim, inv_bb = _f32(t, dev), _f32(rlim, dev), _f32(inv_bb, dev)
    ks = prng.split(key, 4)
    mi = prng.randint(ks[0], (Mm,), 0, NM)
    blocks = mac_blocks[mi]                            # [Mm, Lm] pad -1
    L = mac_len[mi]
    lanes = torch.arange(Lm, device=dev)
    memv = (lanes[None, :] < L[:, None]) & (blocks >= 0)
    b0 = torch.clamp(blocks[:, 0], min=0)
    rl = _rl(rlim)
    cx = _col_target(pp, pp.type_id[b0], pos[b0, 0],
                     prng.uniform(ks[1], (Mm,), -1.0, 1.0), rl)
    dy = prng.randint(ks[2], (Mm,), -rl, rl + 1)
    y0 = torch.minimum(torch.clamp(pos[b0, 1] + dy, min=1), pp.ny - L + 1)
    ty = y0[:, None] + lanes[None, :]                  # [Mm, Lm]

    bc = torch.clamp(blocks, min=0)
    src = (pos[bc, 1] - 1) * pp.nx + (pos[bc, 0] - 1)
    dst = (ty - 1) * pp.nx + (cx[:, None] - 1)
    src = torch.where(memv, src, NS)
    dst = torch.where(memv, dst, NS)
    occ_p1 = torch.cat([occ, torch.full((1,), -1, dtype=occ.dtype,
                                        device=dev)])
    o = torch.where(memv, occ_p1[torch.clamp(dst, 0, NS)], -1)
    # an occupant that is a macro member means the runs overlap
    o_frozen = (o >= 0) & pp.frozen[torch.clamp(o, min=0)]
    self_move = (dst == src).all(dim=1)

    idx = torch.arange(Mm, device=dev)[:, None].expand(Mm, Lm)
    claim = torch.full((NS + 1,), Mm, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(0, src.reshape(-1), idx.reshape(-1), "amin")
    claim.scatter_reduce_(0, dst.reshape(-1), idx.reshape(-1), "amin")
    won = torch.where(memv, (claim[src] == idx) & (claim[dst] == idx), True)
    own = (won.all(dim=1) & ~self_move & ~o_frozen.any(dim=1)
           & (torch.where(memv, ty, 1) <= pp.ny).all(dim=1) & (L > 0))

    newpos = torch.stack([cx[:, None].expand(Mm, Lm), ty], dim=2)
    occs = torch.where(memv, o, -1)
    delta = _macro_delta_bb(pp, pos, torch.where(memv, bc, -1), occs,
                            newpos, memv)
    u2 = prng.uniform(ks[3], (Mm,))
    dn = delta * inv_bb
    accept = own & ((dn <= 0)
                    | (u2 < torch.exp(-delta * inv_bb
                                      / torch.clamp(t, min=1e-30))))

    accm = accept[:, None] & memv
    bb_sc = torch.where(accm, bc, NB).reshape(-1)
    oo_sc = torch.where(accm & (o >= 0), o, NB).reshape(-1)
    pos2 = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype, device=dev)])
    pos2[bb_sc] = torch.cat([newpos, torch.zeros((Mm, Lm, 1),
                                                 dtype=pos.dtype,
                                                 device=dev)],
                            dim=2).reshape(-1, 3)
    pos2[oo_sc] = pos[bc].reshape(-1, 3)
    ssrc = torch.where(accm, src, NS).reshape(-1)
    sdst = torch.where(accm, dst, NS).reshape(-1)
    occ2 = torch.cat([occ, torch.zeros(1, dtype=occ.dtype, device=dev)])
    occ2[ssrc] = occs.reshape(-1)
    occ2[sdst] = torch.where(memv, bc, 0).reshape(-1)
    out = (pos2[:NB], ring_idx, occ2[:NS], accept.sum())
    if not trace:
        return out
    return out + (dict(mi=mi, cx=cx, y0=y0, own=own, delta=delta, u=u2,
                       thresh=torch.exp(-delta * inv_bb
                                        / torch.clamp(t, min=1e-30)),
                       accept=accept,
                       blk_idx=torch.cat([bb_sc, oo_sc]),
                       site_idx=torch.cat([ssrc, sdst])),)


# ---------------------------------------------------------------- timing

class PlacerTiming:
    """Wires the placer to the timing subsystem: the delay-lookup stack
    plus the STA for criticality recomputation
    (alloc_lookups_and_criticalities, timing_place.c:121).  The STA runs
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, pnl: PackedNetlist, lookup, term, tg,
                 td_place_exp: float = 8.0, device="cuda"):
        from ..timing.sta import TimingAnalyzer

        self.lookup = lookup
        self.term = term
        self.analyzer = TimingAnalyzer(tg, crit_exp=td_place_exp,
                                       device=device)
        R, Smax = term.sinks.shape
        # per-connection block endpoints for lookup-delay evaluation
        self.drv_blk = np.zeros(R, dtype=np.int64)
        self.snk_blk = np.zeros((R, Smax), dtype=np.int64)
        self.conn_valid = np.zeros((R, Smax), dtype=bool)
        # (r, s) -> (costed-net row, uniq-block slot) for the crit scatter
        self.map_row = np.zeros((R, Smax), dtype=np.int64)
        self.map_slot = np.zeros((R, Smax), dtype=np.int64)
        self.is_io = np.array([pnl.block_type(i).is_io
                               for i in range(pnl.num_blocks)])
        for r, ni in enumerate(term.net_ids):
            net = pnl.nets[int(ni)]
            self.drv_blk[r] = net.driver.block
            uniq = {net.driver.block: 0}
            for p in net.sinks:
                if p.block not in uniq:
                    uniq[p.block] = len(uniq)
            for s, p in enumerate(net.sinks):
                self.snk_blk[r, s] = p.block
                self.conn_valid[r, s] = True
                self.map_row[r, s] = r
                self.map_slot[r, s] = uniq[p.block]

    def criticalities(self, pos: np.ndarray, NN: int, P: int) -> tuple:
        """(crit [NN, P] f32, crit_path_delay) for the positions ``pos``
        from lookup delays (load_criticalities, timing_place.c:81)."""
        sx = pos[self.drv_blk, 0][:, None]
        sy = pos[self.drv_blk, 1][:, None]
        s_io = self.is_io[self.drv_blk][:, None]
        tx = pos[self.snk_blk, 0]
        ty = pos[self.snk_blk, 1]
        t_io = self.is_io[self.snk_blk]
        d = self.lookup.conn_delay(sx, sy, s_io, tx, ty, t_io)
        d = np.where(self.conn_valid, d, 0.0)
        crit_rs = self.analyzer.analyze(d)
        crit = np.zeros((NN, P), dtype=np.float32)
        np.maximum.at(crit, (self.map_row[self.conn_valid],
                             self.map_slot[self.conn_valid]),
                      crit_rs[self.conn_valid])
        return crit, self.analyzer.crit_path_delay


# ---------------------------------------------------------------- driver

class Placer:
    """Host driver owning the annealing schedule (place.c:310 try_place).
    The annealer's tensors live on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, pnl: PackedNetlist, grid: DeviceGrid,
                 opts: Optional[PlacerOpts] = None,
                 timing: Optional[PlacerTiming] = None, macros=None,
                 device="cuda"):
        self.pnl, self.grid = pnl, grid
        self.opts = opts or PlacerOpts()
        self.timing = timing
        self.device = resolve_device(device)
        # a chain taller than the grid splits into column-height segments
        self.macros = []
        for m in (macros or []):
            for lo in range(0, len(m), max(2, grid.ny)):
                seg = m[lo:lo + max(2, grid.ny)]
                if len(seg) >= 2:
                    self.macros.append(seg)
        self.pp = build_place_problem(
            pnl, grid, lookup=timing.lookup if timing else None,
            macros=self.macros, device=self.device)
        self._is_io = self.pp.is_io.cpu().numpy()
        self._ring_of = _ring_index_host(grid)
        self._mac_blocks = self._mac_len = None
        if self.macros:
            Lm = max(len(m) for m in self.macros)
            mb = np.full((len(self.macros), Lm), -1, dtype=np.int64)
            for i, m in enumerate(self.macros):
                mb[i, :len(m)] = m
            self._mac_blocks = torch.from_numpy(mb).to(self.device)
            self._mac_len = torch.tensor([len(m) for m in self.macros],
                                         dtype=torch.int64,
                                         device=self.device)
        self._reads = 0

    def _read(self, x: torch.Tensor) -> np.ndarray:
        self._reads += 1
        return x.cpu().numpy()

    def _state_from_pos(self, pos_np: np.ndarray):
        pp = self.pp
        NB = self.pnl.num_blocks
        ring = np.full(NB, -1, dtype=np.int64)
        for i in np.where(self._is_io)[0]:
            ring[i] = self._ring_of[(int(pos_np[i, 0]), int(pos_np[i, 1]))]
        pos = np.asarray(pos_np, dtype=np.int64)
        site = np.where(self._is_io,
                        pp.nx * pp.ny + ring * pp.io_cap + pos[:, 2],
                        (pos[:, 1] - 1) * pp.nx + (pos[:, 0] - 1))
        if len(site) != len(set(site.tolist())):
            raise ValueError("initial placement has site collisions")
        occ = np.full(pp.num_sites, -1, dtype=np.int64)
        occ[site] = np.arange(NB)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (pos, ring, occ))

    def _crit(self, pos: torch.Tensor):
        NN, P = self.pp.net_blk.shape
        if self.timing is None:
            return (torch.zeros((NN, P), dtype=F32, device=self.device),
                    float("nan"))
        crit, cpd = self.timing.criticalities(self._read(pos), NN, P)
        return torch.from_numpy(crit).to(self.device), cpd

    def place(self, pos0: np.ndarray) -> Tuple[np.ndarray, PlaceStats]:
        opts, pp, dev = self.opts, self.pp, self.device
        timing = self.timing is not None
        NB = self.pnl.num_blocks
        NN = pp.net_blk.shape[0]
        self._reads = 0
        tt = _f32(opts.timing_tradeoff if timing else 0.0, dev)
        M = min(opts.moves_per_step, max(8, NB))
        steps = max(1, math.ceil(opts.inner_num * NB ** (4 / 3) / M))
        if self.macros:
            # macro-align the initial placement (place_macro.c initial
            # macro placement): members occupy vertical runs
            from .macros import align_initial
            pos0 = align_initial(self.pnl, self.grid, pos0, self.macros)
        pos, ring, occ = self._state_from_pos(pos0)
        key = prng.PRNGKey(opts.seed, device=dev)

        crit, _ = self._crit(pos)
        bb_d, _ = net_bb_cost(pp, pos)
        td_d = net_td_cost(pp, pos, crit)
        bb_cost, td_cost = (float(v) for v in self._read(
            torch.stack([bb_d, td_d])))
        stats = PlaceStats(initial_cost=bb_cost)

        # starting_t (place.c:506): std-dev of random-move deltas at t=inf
        key, k = prng.split(key)
        _, _, _, _, nv, dsum, dsq = sa_step(
            pp, pos, ring, occ, crit, np.float32(1.0 / max(bb_cost, 1e-30)),
            np.float32(1.0 / max(td_cost, 1e-30)), tt, k, 1e30,
            max(pp.nx, pp.ny), M, timing)
        nv, dsum, dsq = self._read(torch.stack(
            [nv.to(torch.float64), dsum.to(torch.float64),
             dsq.to(torch.float64)])).tolist()
        nv = max(1, int(nv))
        var = dsq / nv - (dsum / nv) ** 2
        t = 20.0 * math.sqrt(max(var, 1e-12))
        rlim = float(max(pp.nx, pp.ny))

        # segment size: with timing, criticalities refresh every
        # recompute_crit_temps temperatures (host STA round trip); pure
        # wirelength anneals read the device once per SEG temperatures
        exit_t = opts.exit_t_frac / max(1, NN)
        SEG = max(1, opts.recompute_crit_temps) if timing else 8
        temp_i = 0
        while temp_i < opts.max_temps:
            if timing:
                crit, _ = self._crit(pos)
            n_temps = min(SEG, opts.max_temps - temp_i)
            key, k = prng.split(key)
            with span("place.segment", cat="place", n_temps=n_temps,
                      t=float(t)):
                (pos, ring, occ, t_d, rlim_d, na_a, nv_a, bb_a, live_a,
                 ts_a, rl_a) = sa_segment(
                    pp, pos, ring, occ, crit, tt, k, np.float32(t),
                    np.float32(rlim), np.float32(exit_t), M, steps,
                    n_temps, timing)
                # rigid macro relocations ride along once per segment,
                # at the segment's starting t and rlim and the last read
                # bb cost
                if self._mac_blocks is not None:
                    Lm = int(self._mac_blocks.shape[1])
                    Mm = min(32, max(4, len(self.macros)))
                    inv_bb_m = np.float32(1.0 / max(bb_cost, 1e-30))
                    for _ in range(4):
                        key, k2 = prng.split(key)
                        pos, ring, occ, _ = macro_step(
                            pp, self._mac_blocks, self._mac_len, pos, ring,
                            occ, k2, np.float32(t), np.float32(rlim),
                            inv_bb_m, Mm, Lm)
                # ONE host read per segment
                rows = self._read(torch.stack(
                    [na_a.to(torch.float64), nv_a.to(torch.float64),
                     bb_a.to(torch.float64), live_a.to(torch.float64),
                     ts_a.to(torch.float64), rl_a.to(torch.float64),
                     t_d.to(torch.float64).expand(n_temps),
                     rlim_d.to(torch.float64).expand(n_temps)]))
            stats.segments += 1
            t, rlim = float(rows[6, 0]), float(rows[7, 0])
            reg = get_metrics()
            for i in range(n_temps):
                if rows[3, i] == 0.0:
                    break
                na_i, nv_i = int(rows[0, i]), int(rows[1, i])
                srat = na_i / max(1, nv_i)
                stats.temps.append((float(rows[4, i]), float(rows[2, i]),
                                    srat, float(rows[5, i])))
                stats.total_moves += nv_i
                # per-temperature telemetry (JAX place/sa.py:881-891)
                reg.gauge("place.t").set(float(rows[4, i]))
                reg.gauge("place.bb_cost").set(float(rows[2, i]))
                reg.gauge("place.success_rate").set(srat)
                reg.gauge("place.rlim").set(float(rows[5, i]))
                reg.counter("place.moves").inc(nv_i)
                reg.counter("place.accepted_moves").inc(na_i)
                reg.histogram("place.acceptance_rate").record(srat)
                reg.snapshot(phase="place",
                             temperature=len(stats.temps) - 1)
            temp_i += n_temps
            bb_cost = float(rows[2, -1])
            # exit_crit (place.c:270)
            if t < exit_t:
                break

        # final quench at t=0 (through sa_segment, so the cost
        # normalization is computed fresh on the device)
        if timing:
            crit, _ = self._crit(pos)
        key, k = prng.split(key)
        pos, ring, occ, _, _, _, _, bb_a, _, _, _ = sa_segment(
            pp, pos, ring, occ, crit, tt, k, np.float32(0.0),
            np.float32(1.0), np.float32(exit_t), M, steps, 1, timing)
        fin = self._read(torch.stack([bb_a[-1], net_td_cost(pp, pos, crit)
                                      if timing else bb_a[-1]]))
        stats.final_cost = float(fin[0])
        stats.final_td_cost = float(fin[1]) if timing else 0.0
        if timing:
            _, stats.est_crit_path = self._crit(pos)
        reg = get_metrics()
        reg.gauge("place.final_cost").set(stats.final_cost)
        reg.gauge("place.total_moves").set(int(stats.total_moves))
        if stats.est_crit_path == stats.est_crit_path:
            reg.gauge("place.est_crit_path").set(float(stats.est_crit_path))
        reg.snapshot(phase="place_final", temps=len(stats.temps))
        # final legality audit (check_place, place.c:253): an annealer
        # bug must never hand the router an illegal placement silently
        from .check import check_place

        pos_np = self._read(pos).astype(np.int32)
        stats.host_reads = self._reads
        check_place(self.pnl, self.grid, pos_np)
        return pos_np, stats
