"""Row-sharded planes relaxation: halo exchange between column blocks.
The counterpart of parallel_eda_tpu/route/planes_shard.py.

The [B, W, X, Y] relaxation canvases are split along the canvas row (x)
axis into one contiguous column block per shard, and the only traffic
between shards per sweep is the dist halo columns each block shares
with its neighbours (the reference's distributed-memory spatial router,
rr_graph_partitioner.h:840 / route.h:330-365).

Block layout (kx owned columns per shard, PX = n_shards * kx >= NX+2):

    chanx block:  [B, W, kx+2, NY+1]   local col 0 / kx+1 = halo
    chany block:  [B, W, kx+3, NY]     local col 0 = left halo,
                                       kx+1..kx+2 = right halo slab

Everything outside the real canvas is inert (breaks True, endpoints
False, congestion INF), so pad cells stay INF and leak nothing.  Pred
and wenter need no exchange: scan preds come from the cell's own global
id, turn preds from the static global-id canvases, wenter from the
delay canvases.

A shard lives on a ``torch.device`` of the mesh (``RowMesh.devices``;
entries may repeat: shards sharing one card, or ``cpu`` in the tests).
The mesh's ``impl`` names the schedule, as in the JAX package:

* ``"ppermute"`` — lag 1: exchange the halos of the previous sweep,
  sweep, then the global owned-changed flag decides whether to go on;
* ``"pallas_halo"`` — lag 2: sweep t takes halos extracted before
  sweep t-1 (the owned columns of the other state set), so each
  transfer could have a whole sweep to land behind; the loop exits
  after two consecutive globally stable sweeps.

Which path runs is decided by the mesh and the schedule
(``uses_cluster``), never by a failure:

* lag 1 with every shard on the tensors' card: one launch of the
  cluster kernel (planes_kernels.planes_relax_cluster_cuda) runs the
  whole relaxation — a thread-block cluster per net, a CTA per shard,
  the halos moving through distributed shared memory, each net stopping
  at its first sweep with no owned change;
* otherwise (shards across cards, lag 2, or the CPU) the per-sweep loop
  (``planes_relax_sharded_sweeps``): the halos move first, in place (one
  shard_kernels.halo_exchange writes every shard's halo columns from its
  neighbours' owned columns; on the card one launch of the halo kernel
  per sending card), then every shard runs one sweep of its block — on a
  CUDA device the hand-written step kernel (planes_kernels.
  sweep_block_launcher, two state sets per shard ping-ponged so the
  launch tables are built once per relaxation), on the CPU the plain
  planes._sweep_once — and one host read of the shards' flags decides
  whether to go on.

Both relax to the single-device fixpoint; dist and wenter are
bit-identical to it on f32-exact costs (the truncated scans regroup only
exact sums), and the route at the bench configuration is bit-identical
(the JAX package's tiered parity argument, its module docstring).  The
cluster kernel's outputs and stats are bit-identical to the per-sweep
loop's: a net's sweeps after its first stable one are identities on
everything returned, and the batch's [executed, useful] is the max over
nets of each net's pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from .planes import (INF, PlanesGeom, PlanesGraph, _flat, _split_flat,
                     _sweep_costs, _sweep_once)
from .shard_kernels import MAX_SHARDS, HaloExchange, halo_exchange_plain

# ceiling on the inflated sweep budget: information crosses one shard
# boundary per sweep, so a path spanning m blocks needs up to m extra
# sweeps — nsweeps * n_shards, capped (the fixpoint exit keeps the real
# trip count near the single-device one)
MAX_SHARD_SWEEPS = 512

MESH_IMPLS = ("ppermute", "pallas_halo")

# NVIDIA H100 SXM (NVIDIA data sheet): HBM3 at 3.35 TB/s; NVLink 4 at
# 900 GB/s to the other cards of the host, 450 GB/s each way
H100_HBM_BYTES_S = 3.35e12
H100_NVLINK_BYTES_S = 450e9


@dataclass(frozen=True)
class RowMesh:
    """The shards of the row-sharded relaxation: one device per shard
    (repeats allowed) and the exchange schedule."""
    devices: Tuple[torch.device, ...]
    impl: str = "ppermute"
    # per-PlanesGraph block geometry, built once per mesh
    _geom: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.impl not in MESH_IMPLS:
            raise ValueError(f"RowMesh impl must be one of {MESH_IMPLS}, "
                             f"got {self.impl!r}")
        if self.n_shards < 2:
            raise ValueError(f"RowMesh needs >= 2 shards, got "
                             f"{self.n_shards} (use mesh=None for "
                             f"single-device)")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("RowMesh devices must be of one type")
        if self.devices[0].type == "cuda" and self.n_shards > MAX_SHARDS:
            raise ValueError(f"the halo kernel takes at most {MAX_SHARDS} "
                             f"shards, got {self.n_shards}")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards span."""
        return len(set(self.devices))


def make_row_mesh(n_shards: int, impl: str = "ppermute",
                  devices=None) -> RowMesh:
    """A RowMesh of ``n_shards`` shards.  ``devices`` None (``cuda``) or a
    device / device type places the shards round-robin over the visible
    devices of that type (every shard on ``cpu`` for the CPU); a list
    gives the shards' devices explicitly, repeats allowed."""
    if n_shards < 2:
        raise ValueError(f"n_shards must be >= 2, got {n_shards}")
    if devices is None or isinstance(devices, (str, torch.device)):
        kind = torch.device("cuda" if devices is None else devices).type
        if kind == "cuda":
            n = torch.cuda.device_count()
            if n == 0:
                raise ValueError(
                    f"mesh_shards={n_shards} but no CUDA device is "
                    f"visible; pass device='cpu' to shard on the CPU")
            devs = [torch.device("cuda", i % n) for i in range(n_shards)]
        else:
            devs = [torch.device(kind)] * n_shards
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) < n_shards:
            raise ValueError(
                f"mesh_shards={n_shards} but only {len(devs)} device(s) "
                f"given; repeat a device to place several shards on it")
    return RowMesh(tuple(devs[:n_shards]), impl)


def row_block_cols(pg: PlanesGraph, n_shards: int) -> int:
    """Owned canvas columns per shard (kx).  The padded extent
    PX = n_shards * kx covers the real chanx extent NX plus the chany
    extent NX+1 plus one border, and kx >= 2 so the 2-column chany
    halo slab always lands on owned columns of one neighbour."""
    W, NX, NYp1 = pg.shape_x
    return max(2, -(-(NX + 2) // n_shards))


def halo_bytes_per_sweep(pg: PlanesGraph, batch: int, n_shards: int) -> int:
    """Modeled bytes ONE sweep's halo exchange moves: per internal
    boundary, 2 dx columns ([B, W, NY+1]) + 3 dy columns ([B, W, NY]) of
    f32 dist (pred/wenter halos are never read)."""
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    return (n_shards - 1) * batch * W * (2 * NYp1 + 3 * NY) * 4


def modeled_overlap_frac(pg: PlanesGraph, batch: int, n_shards: int,
                         impl: str, cross_card: bool) -> float:
    """Modeled fraction of the halo-exchange time hidden behind sweep
    compute: 0.0 for the lag-1 schedule (the exchange is on the
    critical path); for lag 2, one shard's sweep bytes over one
    boundary's halo bytes scaled by the memory-to-link rate ratio —
    the H100's HBM3 over NVLink 4 one way when the shards sit on
    different cards, 1 when they share one — capped at 1."""
    if impl != "pallas_halo" or n_shards < 2:
        return 0.0
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    sweep_bytes = batch * W * (NX * NYp1 + NXp1 * NY) * 4 / n_shards
    halo_bytes = halo_bytes_per_sweep(pg, batch, n_shards) \
        / max(1, n_shards - 1)
    ratio = H100_HBM_BYTES_S / H100_NVLINK_BYTES_S if cross_card else 1.0
    return round(min(1.0, sweep_bytes / max(1.0, halo_bytes * ratio)), 6)


def _pad_cols(a, left: int, total: int, fill):
    """Pad the canvas x axis (axis -2) with ``left`` fill columns
    before and out to ``total`` columns."""
    out = torch.full(a.shape[:-2] + (total, a.shape[-1]), fill,
                     dtype=a.dtype, device=a.device)
    out[..., left:left + a.shape[-2], :] = a
    return out


def _stack_blocks(a, s: int, kx: int, ext: int):
    """[..., PXpad, Y] -> [s, ..., ext, Y]: block i spans padded
    columns i*kx .. i*kx+ext (owned = local 1..kx)."""
    return torch.stack([a[..., i * kx:i * kx + ext, :] for i in range(s)])


def shard_blocks(a, fill, ext: int, kx: int, devices):
    """Cut a canvas [..., X, Y] into the shards' column blocks: padded
    with ``fill`` columns (one before), block i = padded columns
    i*kx .. i*kx+kx+ext (ext 2 for chanx, 3 for chany), each an own
    contiguous copy on ``devices[i]``."""
    p = _pad_cols(a, 1, len(devices) * kx + ext, fill)
    return [p[..., i * kx:i * kx + kx + ext, :].to(
        d, copy=True, memory_format=torch.contiguous_format)
        for i, d in enumerate(devices)]


def _geom_blocks(pg: PlanesGraph, s: int, kx: int) -> PlanesGeom:
    """Per-shard sweep geometry, stacked on a leading [s] axis (each
    shard's G = 1): the global masks/delays padded with inert columns
    and sliced into overlapping blocks, plus global flat-id and parity
    canvases computed from the padded positions so preds and
    rotated-turn parity stay exact under sharding."""
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    PX = s * kx
    ncx = W * NX * NYp1
    dev = pg.device

    def bx(a, fill):            # chanx-extent field -> [s, 1, W, kx+2, .]
        return _stack_blocks(_pad_cols(a, 1, PX + 2, fill), s, kx,
                             kx + 2)[:, None]

    def by(a, fill):
        return _stack_blocks(_pad_cols(a, 1, PX + 3, fill), s, kx,
                             kx + 3)[:, None]

    def ar(n):
        return torch.arange(n, device=dev)

    # global flat ids at padded positions (real col = position - 1; pad
    # positions clamp into range — their cells stay INF, so the ids
    # never surface in an owned pred)
    gx = torch.clamp(ar(PX + 2) - 1, 0, NX - 1)
    idxx_pad = ((ar(W)[:, None] * NX + gx[None, :]) * NYp1
                )[:, :, None] + ar(NYp1)[None, None, :]
    gy = torch.clamp(ar(PX + 3) - 1, 0, NXp1 - 1)
    idxy_pad = ncx + ((ar(W)[:, None] * NXp1 + gy[None, :]) * NY
                      )[:, :, None] + ar(NY)[None, None, :]
    # global corner parity (x + y) % 2 at padded-y positions
    par_pad = ((ar(PX + 3) - 1)[:, None] + ar(NYp1)[None, :]) % 2
    i32 = torch.int32
    return PlanesGeom(
        brk_before_x=bx(pg.brk_before_x, True),
        brk_after_x=bx(pg.brk_after_x, True),
        brk_before_y=by(pg.brk_before_y, True),
        brk_after_y=by(pg.brk_after_y, True),
        first_x=bx(pg.first_x, False), last_x=bx(pg.last_x, False),
        first_y=by(pg.first_y, False), last_y=by(pg.last_y, False),
        delay_x=bx(pg.delay_x, 0.0), delay_y=by(pg.delay_y, 0.0),
        delay_y_rot0=by(pg.delay_y_rot0, 0.0),
        delay_y_rot1=by(pg.delay_y_rot1, 0.0),
        idxx=_stack_blocks(idxx_pad.to(i32), s, kx, kx + 2)[:, None],
        idxy=_stack_blocks(idxy_pad.to(i32), s, kx, kx + 3)[:, None],
        base_par=_stack_blocks(par_pad.to(i32), s, kx, kx + 3)[:, None],
        stride_x=NYp1, directional=pg.directional,
        inc_track=(pg.inc_track.expand((s,) + tuple(pg.inc_track.shape))
                   if pg.inc_track is not None else None))


def _shard_geoms(pg: PlanesGraph, rmesh: RowMesh, kx: int):
    """Shard i's G = 1 block geometry on its device (cached per mesh)."""
    hit = rmesh._geom.get(id(pg))
    if hit is not None and hit[0] is pg:
        return hit[1]
    gb = _geom_blocks(pg, rmesh.n_shards, kx)
    names = ("brk_before_x", "brk_after_x", "brk_before_y", "brk_after_y",
             "first_x", "last_x", "first_y", "last_y", "delay_x",
             "delay_y", "delay_y_rot0", "delay_y_rot1", "idxx", "idxy",
             "base_par")
    geoms = [PlanesGeom(
        **{k: getattr(gb, k)[i].to(dev).contiguous() for k in names},
        stride_x=gb.stride_x, directional=gb.directional,
        inc_track=(None if gb.inc_track is None
                   else gb.inc_track[i].to(dev).contiguous()))
        for i, dev in enumerate(rmesh.devices)]
    rmesh._geom[id(pg)] = (pg, geoms)
    return geoms


class _PlainSweeps:
    """The plain sharded sweep loop (the CPU's, and the plain version of
    the card's kernels on any device): each sweep makes new state tensors
    (planes._sweep_once) and the exchange writes the current state's halo
    columns in place (halo_exchange_plain)."""

    def __init__(self, gms, states, crits, ccx, ccy, kx, home):
        self.args = list(zip(gms, crits, ccx, ccy))
        self.costs = [_sweep_costs(*a) for a in self.args]
        self.cur = self.prev = states
        self.kx = kx

    def exchange(self, lagged: bool) -> None:
        halo_exchange_plain(self.cur, self.kx, self.prev if lagged else None)

    def sweep(self) -> bool:
        """One sweep of every shard; whether an owned cell improved."""
        own = slice(1, self.kx + 1)
        new, flags = [], []
        for st, a, costs in zip(self.cur, self.args, self.costs):
            st2 = _sweep_once(a[0], st, *a[1:], costs)
            flags.append((st2[0][:, :, own] < st[0][:, :, own]).any()
                         | (st2[1][:, :, own] < st[1][:, :, own]).any())
            new.append(st2)
        self.prev, self.cur = self.cur, new
        return bool(torch.stack(flags).any())


class _CardSweeps:
    """The sharded sweep loop on the card: two state sets per shard,
    ping-ponged (a sweep reads one and writes the other), so every launch
    table is built once per relaxation: each shard's step, and each
    exchange into the current set (from itself, or lagged from the
    other).  One host read per sweep: the owned-changed flags of each
    card's shards."""

    def __init__(self, gms, states, crits, ccx, ccy, kx, home):
        from .planes_kernels import sweep_block_launcher

        B = states[0][0].shape[0]
        self.sets = (states, [tuple(torch.empty_like(t) for t in st)
                              for st in states])
        by_card = {}
        for k, st in enumerate(states):
            by_card.setdefault(st[0].device, []).append(k)
        self.stats = {d: torch.empty((len(ks), B, 2), dtype=torch.int32,
                                     device=d) for d, ks in by_card.items()}
        slot = {k: self.stats[d][j] for d, ks in by_card.items()
                for j, k in enumerate(ks)}
        self.steps = [[sweep_block_launcher(
            gms[k], self.sets[p][k], crits[k], ccx[k], ccy[k], (1, kx + 1),
            self.sets[1 - p][k], slot[k]) for k in range(len(states))]
            for p in (0, 1)]
        self.exchanges = {}
        self.kx, self.home, self.p = kx, home, 0

    @property
    def cur(self):
        return self.sets[self.p]

    def exchange(self, lagged: bool) -> None:
        key = (self.p, 1 - self.p if lagged else self.p)
        run = self.exchanges.get(key)
        if run is None:
            run = self.exchanges[key] = HaloExchange(
                self.sets[key[0]], self.kx, self.sets[key[1]])
        run()

    def sweep(self) -> bool:
        """One sweep of every shard; whether an owned cell improved."""
        for run in self.steps[self.p]:
            run()
        self.p = 1 - self.p
        flags = [st[:, :, 1].any() for st in self.stats.values()]
        if len(flags) == 1:
            return bool(flags[0])
        return bool(torch.stack([f.to(self.home) for f in flags]).any())


def uses_cluster(rmesh: RowMesh, device: torch.device) -> bool:
    """Whether planes_relax_sharded runs as one cluster launch: the lag-1
    schedule with every shard on ``device``, a card."""
    return (rmesh.impl == "ppermute" and device.type == "cuda"
            and set(rmesh.devices) == {device})


def sweep_cap(nsweeps: int, n_shards: int) -> int:
    """The sharded relaxation's sweep budget: information crosses one
    shard boundary per sweep, so nsweeps * n_shards, capped."""
    return int(min(MAX_SHARD_SWEEPS, max(nsweeps, nsweeps * n_shards)))


def planes_relax_sharded(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                         wenter0, nsweeps: int, rmesh: RowMesh):
    """planes_relax, spatially sharded over ``rmesh``: the same contract
    — (dist_flat, pred_flat, wenter_flat, stats) on d0_flat's device —
    with every shard relaxing its own column block and the halo columns
    exchanged every sweep: one cluster launch under lag 1 on one card,
    the per-sweep loop otherwise (module docstring)."""
    home = d0_flat.device
    if uses_cluster(rmesh, home):
        from .planes_kernels import planes_relax_cluster_cuda
        return planes_relax_cluster_cuda(
            pg, d0_flat, cc_flat, crit_c, wenter0,
            sweep_cap(nsweeps, rmesh.n_shards), rmesh.n_shards)
    return planes_relax_sharded_sweeps(pg, d0_flat, cc_flat, crit_c,
                                       wenter0, nsweeps, rmesh)


def planes_relax_sharded_sweeps(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                                wenter0, nsweeps: int, rmesh: RowMesh,
                                plain: bool = False):
    """The per-sweep form of planes_relax_sharded, on any mesh: the card's
    step and halo kernels on CUDA shards, the plain loop (_PlainSweeps)
    on CPU shards or with ``plain``."""
    NX, NXp1 = pg.shape_x[1], pg.shape_y[1]
    s = rmesh.n_shards
    devs = rmesh.devices
    kx = row_block_cols(pg, s)
    nsw_cap = sweep_cap(nsweeps, s)
    lag2 = rmesh.impl == "pallas_halo"
    home = d0_flat.device
    if devs[0].type != home.type:
        raise ValueError(f"the mesh's shards are on {devs[0].type} but the "
                         f"relaxation's tensors on {home.type}")

    def blocks(flat, fill):
        x, y = _split_flat(pg, flat)
        return (shard_blocks(x, fill, 2, kx, devs),
                shard_blocks(y, fill, 3, kx, devs))

    gms = _shard_geoms(pg, rmesh, kx)
    ccx, ccy = blocks(cc_flat, INF)
    crits = [crit_c.to(d) for d in devs]
    states = [(dx, dy, g.idxx.expand(dx.shape).contiguous(),
               g.idxy.expand(dy.shape).contiguous(), wx, wy)
              for dx, dy, wx, wy, g in zip(*blocks(d0_flat, INF),
                                           *blocks(wenter0, 0.0), gms)]
    card = devs[0].type == "cuda" and not plain
    run = (_CardSweeps if card else _PlainSweeps)(
        gms, states, crits, ccx, ccy, kx, home)

    # A sweep's halos come from its own input state (lag 1) or, under
    # lag 2 after the first sweep, from the input of the sweep before
    # (halos extracted before sweep t-1): extraction reads only owned
    # columns and the exchange writes only halo columns, so both read
    # the owned columns of an unchanged generation, in place.
    i = 0
    if not lag2:
        go = True
        while go and i < nsw_cap:
            run.exchange(lagged=False)
            go = run.sweep()
            i += 1
        useful = max(0, i - (0 if go else 1))
    else:
        streak = 0
        while streak < 2 and i < nsw_cap:
            run.exchange(lagged=i > 0)
            anych = run.sweep()
            streak = 0 if anych else streak + 1
            i += 1
        useful = max(0, i - streak)

    own = slice(1, kx + 1)

    def reassemble(idx, real_x):
        return torch.cat([st[idx][:, :, own].to(home) for st in run.cur],
                         dim=2)[:, :, :real_x]

    dx, dy = reassemble(0, NX), reassemble(1, NXp1)
    px, py = reassemble(2, NX), reassemble(3, NXp1)
    wx, wy = reassemble(4, NX), reassemble(5, NXp1)
    stats = torch.tensor([i, useful], dtype=torch.int32, device=home)
    return _flat(dx, dy), _flat(px, py), _flat(wx, wy), stats
