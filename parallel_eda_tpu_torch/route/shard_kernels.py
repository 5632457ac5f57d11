"""The halo transport of the row-sharded relaxation: the counterpart of
``remote_slab_permute`` (parallel_eda_tpu/route/planes_pallas.py:597)
and of the install that follows it (parallel_eda_tpu/route/
planes_shard.py:317-355).  One CUDA kernel, ``slab_permute_kernel``
(csrc/slab_permute.cu), executes a table of strided moves; two wrappers
launch it:

    halo_exchange_cuda       one in-place halo exchange of the shards'
                             block states (the route's call);
                             HaloExchange is its form with the tables
                             built once, for a sweep loop
    halo_exchange_plain      its plain PyTorch version
    remote_slab_permute_cuda the TPU kernel's contract: one slab per
                             shard shifted one hop into fresh buffers
    slab_permute_plain       its plain PyTorch version

An exchange writes each shard's halo columns (dx local column 0 and
kx+1, dy local column 0 and kx+1..kx+2) from its neighbours' owned
boundary columns (dx kx / 1, dy kx / 1..2), and INF where the edge shard
has no neighbour: the JAX package's extract + install, in place, with no
receive buffer.  ``halo_exchange`` and ``remote_slab_permute`` dispatch
on the tensors' device type: CUDA tensors launch the kernel or raise,
CPU tensors take the plain version.  Each CUDA wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from .cuda_lib import CudaLib

MAX_SHARDS = 16          # csrc/slab_permute.cu MAX_MOVES / 4 slabs
INF = float("inf")


def _setup(lib) -> None:
    lib.slab_permute_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    lib.slab_permute_launch.restype = ctypes.c_int
    lib.slab_permute_max_moves.restype = ctypes.c_int
    lib.slab_permute_enable_peer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.slab_permute_enable_peer.restype = ctypes.c_int


LIB = CudaLib("slab_permute", _setup)
# card sets whose pairwise peer access is enabled (process-wide CUDA
# state, like the access itself)
_PEERS_ENABLED: set = set()


def _sender(r: int, n: int, fwd: bool):
    s = r - 1 if fwd else r + 1
    return s if 0 <= s < n else None


def _enable_peers(devices) -> None:
    key = tuple(sorted({d.index for d in devices}))
    if len(key) < 2 or key in _PEERS_ENABLED:
        return
    arr = (ctypes.c_int * len(key))(*key)
    rc = LIB.get().slab_permute_enable_peer(arr, len(key))
    if rc != 0:
        raise RuntimeError(f"peer access between cards {key} failed "
                           f"(cudaError {rc})")
    _PEERS_ENABLED.add(key)


def _rows(t, name: str):
    """(pointer, row stride, rows, row length) of a [B, W, cols, Y]
    float32 CUDA view whose rows (one (b, w)) are contiguous runs of
    cols * Y floats at a uniform stride, as column slices of a
    contiguous canvas are."""
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 CUDA tensor")
    B, W, c, Y = t.shape
    st = t.stride()
    if st[3] != 1 or st[2] != Y or st[0] != W * st[1]:
        raise ValueError(f"{name}: rows must be contiguous runs of cols * Y "
                         "at a uniform stride")
    return t.data_ptr(), st[1], B * W, c * Y


class SlabMoves:
    """One launch table per card, built once: ``moves`` is a list of
    (source view or None, destination view, fill).  A move is launched
    by its source's card, a fill by its destination's card.  Calling
    the object launches every card's table on that card's current
    stream (taken when it was built); across cards the launch waits for
    its receivers' streams (their halo columns are free to write) and
    they wait for it (the TPU kernel's receive semaphore).  Returns the
    number of launches."""

    def __init__(self, moves):
        rows, dsts = {}, {}
        for k, (src, dst, fill) in enumerate(moves):
            dp, ds, nseg, seg = _rows(dst, f"move {k} destination")
            sp, ss = 0, 0
            if src is not None:
                sp, ss, ns2, sg2 = _rows(src, f"move {k} source")
                if (ns2, sg2) != (nseg, seg):
                    raise ValueError(f"move {k}: source and destination "
                                     "shapes differ")
            card = (src if src is not None else dst).device
            bits = struct.unpack("<I", struct.pack("<f", fill))[0]
            rows.setdefault(card, []).extend(
                [sp, ss, dp, ds, nseg, seg, bits])
            dsts.setdefault(card, set()).add(dst.device)
        lib = LIB.get()
        self._fn = lib.slab_permute_launch
        cards = set(rows) | {d for v in dsts.values() for d in v}
        if len(cards) > 1:
            _enable_peers(cards)
        cap = lib.slab_permute_max_moves()
        self.streams = {d: torch.cuda.current_stream(d) for d in cards}
        self.groups = []
        for card, r in rows.items():
            n = len(r) // 7
            if n > cap:
                raise ValueError(f"{n} moves from one card; the kernel "
                                 f"takes at most {cap}")
            peers = sorted(dsts[card] - {card}, key=lambda d: d.index)
            self.groups.append((card.index, (ctypes.c_longlong * len(r))(*r),
                                n, self.streams[card].cuda_stream, card,
                                peers))
        recv = {p for g in self.groups for p in g[5]}
        self.free = {d: torch.cuda.Event() for d in recv}
        self.done = [torch.cuda.Event() if g[5] else None
                     for g in self.groups]

    def __call__(self) -> int:
        for d, ev in self.free.items():
            ev.record(self.streams[d])
        for (idx, tab, n, stream, card, peers), done in zip(self.groups,
                                                            self.done):
            for p in peers:
                self.streams[card].wait_event(self.free[p])
            rc = self._fn(tab, n, idx, stream)
            if rc != 0:
                raise RuntimeError(f"halo move kernel launch failed "
                                   f"(cudaError {rc})")
            if done is not None:
                done.record(self.streams[card])
                for p in peers:
                    self.streams[p].wait_event(done)
        return len(self.groups)


# ---- the route's exchange ---------------------------------------------

def halo_moves(states, kx: int, src=None):
    """The moves of one exchange into ``states`` (per shard (dx, dy,
    ...) block canvases [B, W, kx+2, NY+1] / [B, W, kx+3, NY]) from the
    owned columns of ``src`` (default: ``states`` itself), as (source
    view or None, destination view, fill) — the JAX package's four
    ppermutes and install (planes_shard.py:336-356)."""
    src = states if src is None else src
    s = len(states)
    if len(src) != s:
        raise ValueError("states and src must have one entry per shard")
    moves = []
    for r in range(s):
        dx, dy = states[r][0], states[r][1]
        left = src[r - 1] if r > 0 else None
        right = src[r + 1] if r < s - 1 else None
        for dst, nb, a, b in ((dx[:, :, 0:1], left, 0, (kx, kx + 1)),
                              (dx[:, :, kx + 1:kx + 2], right, 0, (1, 2)),
                              (dy[:, :, 0:1], left, 1, (kx, kx + 1)),
                              (dy[:, :, kx + 1:kx + 3], right, 1, (1, 3))):
            moves.append((None if nb is None else nb[a][:, :, b[0]:b[1]],
                          dst, INF))
    return moves


def halo_exchange_plain(states, kx: int, src=None) -> None:
    """The plain version: write every halo column of ``states`` in place
    from the neighbours' owned columns of ``src``, INF at the edges."""
    for s, d, fill in halo_moves(states, kx, src):
        if s is None:
            d.fill_(fill)
        else:
            d.copy_(s)


class HaloExchange(SlabMoves):
    """halo_exchange_cuda with its tables built once, for a loop that
    exchanges between the same tensors every sweep: calling it launches
    (one launch with every shard on one card, one per sending card
    otherwise) and counts into ``halo_exchange_cuda.launches``."""

    def __init__(self, states, kx: int, src=None):
        if not 2 <= len(states) <= MAX_SHARDS:
            raise ValueError(f"needs 2..{MAX_SHARDS} shards, got "
                             f"{len(states)}")
        super().__init__(halo_moves(states, kx, src))

    def __call__(self) -> int:
        n = super().__call__()
        halo_exchange_cuda.launches += n
        return n


def halo_exchange_cuda(states, kx: int, src=None) -> None:
    """One halo exchange on the card, in place: the shards' dist halo
    columns of ``states`` from the owned columns of ``src`` (module
    docstring)."""
    HaloExchange(states, kx, src)()


halo_exchange_cuda.launches = 0


def halo_exchange(states, kx: int, src=None) -> None:
    """The halo exchange: the kernel for CUDA states, the plain version
    for CPU states."""
    kinds = {st[k].device.type for st in states for k in (0, 1)}
    if src is not None:
        kinds |= {st[k].device.type for st in src for k in (0, 1)}
    if kinds == {"cuda"}:
        return halo_exchange_cuda(states, kx, src)
    if kinds == {"cpu"}:
        return halo_exchange_plain(states, kx, src)
    raise ValueError(f"states on mixed device types {sorted(kinds)}")


# ---- the TPU kernel's contract ----------------------------------------

def slab_permute_plain(slabs, fwd: bool):
    """The plain version: receiver r gets a copy of its sender's slab on
    r's device, or zeros."""
    n = len(slabs)
    out = []
    for r in range(n):
        s = _sender(r, n, fwd)
        dev = slabs[r].device
        if s is None:
            out.append(torch.zeros(slabs[r].shape, dtype=slabs[r].dtype,
                                   device=dev))
        else:
            out.append(slabs[s].to(dev, copy=True,
                                   memory_format=torch.contiguous_format))
    return out


def remote_slab_permute_cuda(slabs, fwd: bool):
    """The non-wrapping one-hop shift of one slab per shard ([B, W, 1 or
    2, Y], each on its shard's card, strided column views allowed) into
    fresh contiguous buffers on the receivers' cards (``fwd``: shard i
    receives shard i-1's, else i+1's; zeros at the edge shard with no
    sender), through the same kernel as the exchange: one launch with
    every shard on one card, one per sending card otherwise."""
    n = len(slabs)
    if not 2 <= n <= MAX_SHARDS:
        raise ValueError(f"needs 2..{MAX_SHARDS} slabs, got {n}")
    for i, t in enumerate(slabs):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"slab {i} must be a float32 CUDA tensor")
        if t.shape != slabs[0].shape or t.stride() != slabs[0].stride():
            raise ValueError("slabs must share one shape and layout")
    out = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
           for t in slabs]
    moves = []
    for r in range(n):
        s = _sender(r, n, fwd)
        moves.append((None if s is None else slabs[s], out[r], 0.0))
    remote_slab_permute_cuda.launches += SlabMoves(moves)()
    return out


remote_slab_permute_cuda.launches = 0


def remote_slab_permute(slabs, fwd: bool):
    """The halo shift: the kernel for CUDA slabs, the plain version for
    CPU slabs."""
    kinds = {t.device.type for t in slabs}
    if kinds == {"cuda"}:
        return remote_slab_permute_cuda(slabs, fwd)
    if kinds == {"cpu"}:
        return slab_permute_plain(slabs, fwd)
    raise ValueError(f"slabs on mixed device types {sorted(kinds)}")


WRAPPERS = (halo_exchange_cuda, remote_slab_permute_cuda)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
