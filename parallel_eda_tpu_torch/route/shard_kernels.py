"""The halo transport of the row-sharded relaxation: the counterpart of
``remote_slab_permute`` (parallel_eda_tpu/route/planes_pallas.py:597).

    remote_slab_permute_cuda -> slab_permute_kernel (csrc/slab_permute.cu)
    slab_permute_plain       -> its plain PyTorch version

Both take one dist halo slab per shard ([B, W, 1 or 2, Y], each on its
shard's device) and return one receive buffer per shard: the
neighbour's slab (``fwd``: shard i receives shard i-1's, ``bwd``: shard
i+1's) on the receiver's device, or zeros at the edge shard that has no
sender — the non-wrapping shift of the TPU kernel and of
``lax.ppermute``.  ``remote_slab_permute`` dispatches on the slabs'
device type: CUDA slabs launch the kernel or raise, CPU slabs take the
plain version.  The CUDA wrapper counts its kernel launches in
``remote_slab_permute_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLib, launch

THREADS = 256
MAX_SHARDS = 16          # csrc/slab_permute.cu MAX_SHARDS
_MAX_BLOCKS = 1024


def _setup(lib) -> None:
    lib.slab_permute_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.slab_permute_launch.restype = ctypes.c_int
    lib.slab_permute_enable_peer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.slab_permute_enable_peer.restype = ctypes.c_int


LIB = CudaLib("slab_permute", _setup)
# card sets whose pairwise peer access is enabled (process-wide CUDA
# state, like the access itself)
_PEERS_ENABLED: set = set()


def _sender(r: int, n: int, fwd: bool):
    s = r - 1 if fwd else r + 1
    return s if 0 <= s < n else None


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


def remote_slab_permute_cuda(slabs, fwd: bool):
    """The halo shift on the card (see the module docstring).  Each slab
    may be a strided view of its shard's canvas (columns of one row
    adjacent, rows at a uniform stride), as the extraction slices it;
    the receive buffers are contiguous.  With every shard on one card it
    is one launch; otherwise each sender's card launches its own copy
    into the receiver's buffer through a peer pointer, ordered by events
    (the receiver's stream waits for the copy before it reads)."""
    n = len(slabs)
    if not 2 <= n <= MAX_SHARDS:
        raise ValueError(f"needs 2..{MAX_SHARDS} slabs, got {n}")
    B, W, c, Y = slabs[0].shape
    st = slabs[0].stride()
    for i, t in enumerate(slabs):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"slab {i} must be a float32 CUDA tensor")
        if tuple(t.shape) != (B, W, c, Y) or t.stride() != st:
            raise ValueError("slabs must share one shape and layout")
    if st[3] != 1 or st[2] != Y or st[0] != W * st[1]:
        raise ValueError("slab rows must be contiguous runs of cols * Y "
                         "at a uniform stride")
    devs = [t.device for t in slabs]
    out = [torch.empty((B, W, c, Y), dtype=torch.float32, device=d)
           for d in devs]
    nseg, seg = B * W, c * Y
    blocks = max(1, min(_MAX_BLOCKS, -(-nseg * seg // THREADS)))
    lib = LIB.get()
    fn = lib.slab_permute_launch
    ptrs = [t.data_ptr() for t in slabs] + [t.data_ptr() for t in out]

    def ints(r0, n_recv):
        return [nseg, seg, st[1], n, int(fwd), r0, n_recv, THREADS, blocks]

    if len(set(devs)) == 1:
        launch(fn, ptrs, ints(0, n), devs[0], "slab permute")
        remote_slab_permute_cuda.launches += 1
        return out
    _enable_peers(devs)
    for r in range(n):
        s = _sender(r, n, fwd)
        if s is None or devs[s] == devs[r]:
            launch(fn, ptrs, ints(r, 1), devs[r], "slab permute")
        else:
            rs = torch.cuda.current_stream(devs[r])
            ss = torch.cuda.current_stream(devs[s])
            free = torch.cuda.Event()
            free.record(rs)          # the receive buffer is free to write
            ss.wait_event(free)
            launch(fn, ptrs, ints(r, 1), devs[s], "slab permute")
            done = torch.cuda.Event()
            done.record(ss)          # the receive semaphore
            rs.wait_event(done)
        remote_slab_permute_cuda.launches += 1
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


def reset_launch_counts() -> None:
    remote_slab_permute_cuda.launches = 0


def launch_counts() -> dict:
    return {"remote_slab_permute_cuda": remote_slab_permute_cuda.launches}
