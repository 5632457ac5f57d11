"""The halo transport of the row-sharded relaxation: the counterpart of
``remote_slab_permute`` (parallel_eda_tpu/route/planes_pallas.py:597)
and of the install that follows it (parallel_eda_tpu/route/
planes_shard.py:317-355).

    remote_slab_permute_cuda the TPU kernel's contract: one slab per
                             shard shifted one hop into fresh buffers,
                             through ``slab_permute_kernel``
                             (csrc/slab_permute.cu), which executes a
                             table of strided moves
    slab_permute_plain       its plain PyTorch version
    halo_exchange_plain      the plain sharded loop's in-place exchange

An exchange writes each shard's halo columns (dx local column 0 and
kx+1, dy local column 0 and kx+1..kx+2) from its neighbours' owned
boundary columns (dx kx / 1, dy kx / 1..2), and INF where the edge shard
has no neighbour: the JAX package's extract + install, in place, with no
receive buffer.  On the card the route's sharded relaxation moves its
halos inside its own launch (planes_kernels: the cluster kernel through
distributed shared memory, the peer kernel by stores into the
neighbours' mailboxes), so no exchange runs between its sweeps.
``remote_slab_permute`` dispatches on the slabs' device type: CUDA
slabs launch the kernel or raise, CPU slabs take the plain version.  The
kernel moves float32 (4-byte) or, in the bf16 plane mode, bfloat16
(2-byte) elements.  The CUDA wrapper counts its kernel launches in
``remote_slab_permute_cuda.launches`` (float32) and ``.launches_bf16``.
Peer access between the cards of a mesh is enabled here
(``_enable_peers``), for this kernel and the peer relaxation.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib

# shards of a mesh on the card: csrc/slab_permute.cu MAX_MOVES / 4 slabs,
# csrc/planes_relax.cu MAX_SHARDS (the peer kernel's rank tables)
MAX_SHARDS = 16
INF = float("inf")


def _setup(lib) -> None:
    lib.slab_permute_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
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
    """Enable peer access between every pair of the cards ``devices``
    (once per process); raises RuntimeError when a pair cannot reach
    each other."""
    key = tuple(sorted({d.index for d in devices}))
    if len(key) < 2 or key in _PEERS_ENABLED:
        return
    arr = (ctypes.c_int * len(key))(*key)
    rc = LIB.get().slab_permute_enable_peer(arr, len(key))
    if rc != 0:
        raise RuntimeError(f"peer access between cards {key} failed "
                           f"(cudaError {rc})")
    _PEERS_ENABLED.add(key)


# element types the kernel moves: dtype -> bytes
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _fill_bits(fill: float, dtype) -> int:
    """The bits of ``fill`` as one element of ``dtype``."""
    t = torch.tensor([fill], dtype=dtype)
    return int(t.view(torch.int32 if dtype == torch.float32
                      else torch.int16).item()) & (
        (1 << 8 * ELEM_BYTES[dtype]) - 1)


def _count(wrapper, dtype, n: int) -> None:
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += n
    else:
        wrapper.launches += n


def _rows(t, name: str):
    """(pointer, row stride, rows, row length) of a [B, W, cols, Y]
    float32 or bfloat16 CUDA view whose rows (one (b, w)) are contiguous
    runs of cols * Y elements at a uniform stride, as column slices of a
    contiguous canvas are."""
    if not t.is_cuda or t.dtype not in ELEM_BYTES:
        raise ValueError(f"{name} must be a float32 or bfloat16 CUDA "
                         "tensor")
    B, W, c, Y = t.shape
    st = t.stride()
    if st[3] != 1 or st[2] != Y or st[0] != W * st[1]:
        raise ValueError(f"{name}: rows must be contiguous runs of cols * Y "
                         "at a uniform stride")
    return t.data_ptr(), st[1], B * W, c * Y


class SlabMoves:
    """One launch table per card, built once: ``moves`` is a list of
    (source view or None, destination view, fill), all of one dtype
    (``dtype``).  A move is launched by its source's card, a fill by its
    destination's card.  Calling the object launches every card's table
    on that card's current stream (taken when it was built); across
    cards the launch waits for its receivers' streams (their halo
    columns are free to write) and they wait for it (the TPU kernel's
    receive semaphore).  Returns the number of launches."""

    def __init__(self, moves):
        rows, dsts = {}, {}
        self.dtype = moves[0][1].dtype if moves else torch.float32
        for k, (src, dst, fill) in enumerate(moves):
            if dst.dtype != self.dtype or (src is not None
                                           and src.dtype != self.dtype):
                raise ValueError(f"move {k}: every move of an exchange "
                                 "must have one dtype")
            dp, ds, nseg, seg = _rows(dst, f"move {k} destination")
            sp, ss = 0, 0
            if src is not None:
                sp, ss, ns2, sg2 = _rows(src, f"move {k} source")
                if (ns2, sg2) != (nseg, seg):
                    raise ValueError(f"move {k}: source and destination "
                                     "shapes differ")
            card = (src if src is not None else dst).device
            bits = _fill_bits(fill, self.dtype)
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
            rc = self._fn(tab, n, ELEM_BYTES[self.dtype], idx, stream)
            if rc != 0:
                raise RuntimeError(f"halo move kernel launch failed "
                                   f"(cudaError {rc})")
            if done is not None:
                done.record(self.streams[card])
                for p in peers:
                    self.streams[p].wait_event(done)
        return len(self.groups)


# ---- the plain loop's exchange ----------------------------------------

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
        if not t.is_cuda or t.dtype not in ELEM_BYTES:
            raise ValueError(f"slab {i} must be a float32 or bfloat16 CUDA "
                             "tensor")
        if t.shape != slabs[0].shape or t.stride() != slabs[0].stride() \
                or t.dtype != slabs[0].dtype:
            raise ValueError("slabs must share one shape, layout and dtype")
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in slabs]
    moves = []
    for r in range(n):
        s = _sender(r, n, fwd)
        moves.append((None if s is None else slabs[s], out[r], 0.0))
    _count(remote_slab_permute_cuda, slabs[0].dtype, SlabMoves(moves)())
    return out


remote_slab_permute_cuda.launches = 0
remote_slab_permute_cuda.launches_bf16 = 0


def remote_slab_permute(slabs, fwd: bool):
    """The halo shift: the kernel for CUDA slabs, the plain version for
    CPU slabs."""
    kinds = {t.device.type for t in slabs}
    if kinds == {"cuda"}:
        return remote_slab_permute_cuda(slabs, fwd)
    if kinds == {"cpu"}:
        return slab_permute_plain(slabs, fwd)
    raise ValueError(f"slabs on mixed device types {sorted(kinds)}")


WRAPPERS = (remote_slab_permute_cuda,)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = w.launches_bf16 = 0


def launch_counts() -> dict:
    """Launches per wrapper and element type: ``name`` (float32) and
    ``name[bf16]``."""
    out = {}
    for w in WRAPPERS:
        out[w.__name__] = w.launches
        out[w.__name__ + "[bf16]"] = w.launches_bf16
    return out
