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

Which form runs is decided by the mesh, the schedule and the tensors'
device (``relax_form``), never by a failure of its own (the Router's
resilience ladder may choose the per-sweep mesh, ``RowMesh.per_sweep``,
which runs the peer kernel on a card holding every shard):

* ``"cluster"`` — lag 1 with every shard on the tensors' card and not
  ``per_sweep``: one launch of the cluster kernel
  (planes_kernels.planes_relax_cluster_cuda) runs the whole relaxation —
  a thread-block cluster per net, a CTA per shard, the halos moving
  through distributed shared memory;
* ``"peer"`` — every other mesh of cards (shards across cards, lag 2,
  ``per_sweep``): one persistent cooperative launch of the peer kernel
  per card (planes_kernels.planes_relax_peer_cuda) runs the whole
  relaxation — a block per (shard, net slot), the halos stored into
  the neighbours' mailboxes (over NVLink on another card), the fixpoint
  decided on the card from every shard's published flag;
* ``"plain"`` — the CPU: the plain per-sweep loop
  (``planes_relax_sharded_plain``, also the kernels' plain version on a
  card): the halos move first, in place (shard_kernels.
  halo_exchange_plain writes every shard's halo columns from its
  neighbours' owned columns), then every shard runs one planes.
  _sweep_once of its block, and the shards' flags decide whether to go
  on.

All relax to the single-device fixpoint; dist and wenter are
bit-identical to it on f32-exact costs (the truncated scans regroup only
exact sums), and the route at the bench configuration is bit-identical
(the JAX package's tiered parity argument, its module docstring).  The
kernels' outputs and stats are bit-identical to the plain loop's: each
net stops at its own fixpoint (lag 1 its first sweep with no owned
change, lag 2 its second consecutive one), whose later sweeps are
identities on everything returned, and the batch's [executed, useful]
is the max over nets of each net's pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ..obs.devprof import get_devprof
from .planes import (INF, PlanesGeom, PlanesGraph, _dequantize_plane_state,
                     _flat, _split_flat, _sweep_costs, _sweep_once,
                     plane_itemsize, plane_torch_dtype,
                     quantize_plane_state)
from .shard_kernels import MAX_SHARDS, halo_exchange_plain

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
    # run lag 1 on one card as the peer kernel (the resilience ladder's
    # "ppermute" mesh level) instead of the cluster kernel
    per_sweep: bool = False
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
            raise ValueError(f"the sharded kernels take at most "
                             f"{MAX_SHARDS} shards, got {self.n_shards}")

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


def halo_bytes_per_sweep(pg: PlanesGraph, batch: int, n_shards: int,
                         plane_dtype: str = "f32") -> int:
    """Modeled bytes ONE sweep's halo exchange moves: per internal
    boundary, 2 dx columns ([B, W, NY+1]) + 3 dy columns ([B, W, NY]) of
    dist in the plane storage dtype (pred/wenter halos are never read;
    bf16 planes halve the bytes, and the exchange moves 2-byte
    elements)."""
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    return ((n_shards - 1) * batch * W * (2 * NYp1 + 3 * NY)
            * plane_itemsize(plane_dtype))


def modeled_overlap_frac(pg: PlanesGraph, batch: int, n_shards: int,
                         impl: str, cross_card: bool,
                         plane_dtype: str = "f32") -> float:
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
    sweep_bytes = (batch * W * (NX * NYp1 + NXp1 * NY)
                   * plane_itemsize(plane_dtype) / n_shards)
    halo_bytes = halo_bytes_per_sweep(pg, batch, n_shards, plane_dtype) \
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


def block_geoms(pg: PlanesGraph, devices, kx: int):
    """Block i's G = 1 geometry (_geom_blocks, kx owned columns a block)
    on ``devices[i]``, one block per device."""
    gb = _geom_blocks(pg, len(devices), kx)
    names = ("brk_before_x", "brk_after_x", "brk_before_y", "brk_after_y",
             "first_x", "last_x", "first_y", "last_y", "delay_x",
             "delay_y", "delay_y_rot0", "delay_y_rot1", "idxx", "idxy",
             "base_par")
    return [PlanesGeom(
        **{k: getattr(gb, k)[i].to(dev).contiguous() for k in names},
        stride_x=gb.stride_x, directional=gb.directional,
        inc_track=(None if gb.inc_track is None
                   else gb.inc_track[i].to(dev).contiguous()))
        for i, dev in enumerate(devices)]


def _shard_geoms(pg: PlanesGraph, rmesh: RowMesh, kx: int):
    """Shard i's G = 1 block geometry on its device (cached per mesh)."""
    hit = rmesh._geom.get(id(pg))
    if hit is not None and hit[0] is pg:
        return hit[1]
    geoms = block_geoms(pg, rmesh.devices, kx)
    rmesh._geom[id(pg)] = (pg, geoms)
    return geoms


class _PlainSweeps:
    """The plain sharded sweep loop (the CPU's, and the plain version of
    the card's kernels on any device): each sweep makes new state tensors
    (planes._sweep_once, in f32 and rounded back to the plane dtype) and
    the exchange writes the current state's halo columns in place
    (halo_exchange_plain)."""

    def __init__(self, gms, states, crits, ccx, ccy, kx, plane_dtype="f32"):
        ccx, ccy = [c.float() for c in ccx], [c.float() for c in ccy]
        self.args = list(zip(gms, crits, ccx, ccy))
        self.costs = [_sweep_costs(*a) for a in self.args]
        self.cur = self.prev = states
        self.kx = kx
        self.plane_dtype = plane_dtype

    def exchange(self, lagged: bool) -> None:
        halo_exchange_plain(self.cur, self.kx, self.prev if lagged else None)

    def sweep(self) -> bool:
        """One sweep of every shard; whether an owned cell improved (of
        the rounded state, in the bf16 plane mode)."""
        own = slice(1, self.kx + 1)
        new, flags = [], []
        for st, a, costs in zip(self.cur, self.args, self.costs):
            st2 = quantize_plane_state(
                _sweep_once(a[0], _dequantize_plane_state(st), *a[1:],
                            costs), self.plane_dtype)
            flags.append((st2[0][:, :, own] < st[0][:, :, own]).any()
                         | (st2[1][:, :, own] < st[1][:, :, own]).any())
            new.append(st2)
        self.prev, self.cur = self.cur, new
        return bool(torch.stack(flags).any())


def uses_cluster(rmesh: RowMesh, device: torch.device) -> bool:
    """Whether planes_relax_sharded runs as one cluster launch: the lag-1
    schedule with every shard on ``device``, a card."""
    return (rmesh.impl == "ppermute" and not rmesh.per_sweep
            and device.type == "cuda" and set(rmesh.devices) == {device})


def relax_form(rmesh: RowMesh, device: torch.device) -> str:
    """The form planes_relax_sharded takes for tensors on ``device``:
    "cluster" (uses_cluster), "peer" (any other mesh of cards) or
    "plain" (the CPU)."""
    if device.type != "cuda":
        return "plain"
    return "cluster" if uses_cluster(rmesh, device) else "peer"


def sweep_cap(nsweeps: int, n_shards: int) -> int:
    """The sharded relaxation's sweep budget: information crosses one
    shard boundary per sweep, so nsweeps * n_shards, capped."""
    return int(min(MAX_SHARD_SWEEPS, max(nsweeps, nsweeps * n_shards)))


def planes_relax_sharded(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                         wenter0, nsweeps: int, rmesh: RowMesh,
                         plane_dtype: str = "f32"):
    """planes_relax, spatially sharded over ``rmesh``: the same contract
    — (dist_flat, pred_flat, wenter_flat, stats) on d0_flat's device —
    with every shard relaxing its own column block and the halo columns
    exchanged every sweep: on a card one launch of the cluster kernel,
    or one launch of the peer kernel per card of the mesh; the plain
    loop on the CPU (``relax_form``, module docstring).  ``plane_dtype``
    as for planes.planes_relax: in the bf16 plane mode the block states
    are carried in bfloat16, the halo columns carry the rounded values
    and the owned-changed flag compares the rounded state."""
    home = d0_flat.device
    _check_mesh_device(rmesh, home)
    form = relax_form(rmesh, home)
    cap = sweep_cap(nsweeps, rmesh.n_shards)
    if form == "cluster":
        from .planes_kernels import planes_relax_cluster_cuda
        return planes_relax_cluster_cuda(
            pg, d0_flat, cc_flat, crit_c, wenter0, cap, rmesh.n_shards,
            plane_dtype=plane_dtype)
    if form == "peer":
        from .planes_kernels import planes_relax_peer_cuda
        return planes_relax_peer_cuda(
            pg, d0_flat, cc_flat, crit_c, wenter0, cap, rmesh.devices,
            lag2=rmesh.impl == "pallas_halo", plane_dtype=plane_dtype)
    return planes_relax_sharded_plain(pg, d0_flat, cc_flat, crit_c,
                                      wenter0, nsweeps, rmesh,
                                      plane_dtype=plane_dtype)


def _check_mesh_device(rmesh: RowMesh, home: torch.device) -> None:
    if rmesh.devices[0].type != home.type:
        raise ValueError(f"the mesh's shards are on {rmesh.devices[0].type} "
                         f"but the relaxation's tensors on {home.type}")


def planes_relax_sharded_plain(pg: PlanesGraph, d0_flat, cc_flat, crit_c,
                               wenter0, nsweeps: int, rmesh: RowMesh,
                               plane_dtype: str = "f32"):
    """The plain per-sweep form of planes_relax_sharded on any mesh (the
    CPU's relaxation, and the plain version of the card's kernels):
    _PlainSweeps over the shards' blocks, which in the bf16 plane mode
    are bfloat16 (the congestion rounded once)."""
    NX, NXp1 = pg.shape_x[1], pg.shape_y[1]
    s = rmesh.n_shards
    devs = rmesh.devices
    kx = row_block_cols(pg, s)
    nsw_cap = sweep_cap(nsweeps, s)
    lag2 = rmesh.impl == "pallas_halo"
    home = d0_flat.device
    _check_mesh_device(rmesh, home)

    dt = plane_torch_dtype(plane_dtype)

    def blocks(flat, fill):
        x, y = _split_flat(pg, flat.to(dt))
        return (shard_blocks(x, fill, 2, kx, devs),
                shard_blocks(y, fill, 3, kx, devs))

    gms = _shard_geoms(pg, rmesh, kx)
    ccx, ccy = blocks(cc_flat, INF)
    crits = [crit_c.to(d) for d in devs]
    states = [(dx, dy, g.idxx.expand(dx.shape).contiguous(),
               g.idxy.expand(dy.shape).contiguous(), wx, wy)
              for dx, dy, wx, wy, g in zip(*blocks(d0_flat, INF),
                                           *blocks(wenter0, 0.0), gms)]
    if devs[0].type != "cuda":
        get_devprof().note_cpu_call()
    run = _PlainSweeps(gms, states, crits, ccx, ccy, kx, plane_dtype)

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
                         dim=2)[:, :, :real_x].to(
                             torch.int32 if idx in (2, 3) else torch.float32)

    dx, dy = reassemble(0, NX), reassemble(1, NXp1)
    px, py = reassemble(2, NX), reassemble(3, NXp1)
    wx, wy = reassemble(4, NX), reassemble(5, NXp1)
    stats = torch.tensor([i, useful], dtype=torch.int32, device=home)
    return _flat(dx, dy), _flat(px, py), _flat(wx, wy), stats
