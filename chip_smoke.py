"""Chip smoke test of the PyTorch/CUDA port (parallel_eda_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):
  1. card      — nvidia-smi name/power limit and torch's device name
  2. build     — nvcc builds csrc/planes_relax.cu and csrc/slab_permute.cu
                 and g++ builds native/serial_sa.cc, all started together,
                 into parallel_eda_tpu_torch/build/
  3. kernels   — each relaxation kernel against its plain PyTorch version
                 on the card at bench and scale shapes (B=64), exact,
                 jittered and crit > 0 costs, K2 with tile origins that
                 clamp, in every shared-memory mode that fits:
                 dist/wenter/pred/stats bit-identical; kernel,
                 plain-version and bound times
  4. halo      — the halo kernel (K3): its one-hop shift
                 (remote_slab_permute_cuda) and the route's in-place
                 exchange (halo_exchange_cuda, lag 1 and lag 2) against
                 their plain versions at the bench blocks (2-4 shards)
                 and the scale block (4 shards): bit-identical; times per
                 exchange beside the library copy_/fill_ loop, the
                 buffered exchange (shifts into fresh buffers, then
                 install copies) and the bound
  5. step      — the one-sweep step entry against one plain sweep on the
                 shards' bench blocks (2, 4 shards) and the scale block
                 (4 shards), pred carried in, in every shared-memory
                 mode that fits: bit-identical; every mode timed
  6. sharded   — the row-sharded relaxation on the card (both schedules,
                 2 and 4 shards) against single-device K1 (dist/wenter)
                 and against its own CPU run (every output and stats);
                 its one-card lag-1 form, the cluster kernel (one launch
                 per relaxation), beside the per-sweep form (step and
                 halo kernels) and the plain per-sweep loop on the card,
                 at the bench (2, 3, 4 shards) and scale (4) shapes, every
                 mode: bit-identical, all three timed
  7. bench     — route the 60-LUT/W=12 bench config end to end on the
                 card: legal, wirelength 537 in 22 iterations
  8. mesh      — the bench route at mesh_shards=2 and 4: legal, 537 / 22,
                 paths and occupancy equal to phase 7's, under the
                 Router's lag-1 schedule (on one card the cluster kernel,
                 across cards the step and halo kernels) and, timed
                 beside it, lag 2 (the step and halo kernels)
  9. scale     — place the 1,200-LUT/W=20 config with the native
                 annealer and route it on the card, single-device and
                 at mesh_shards=4: legal
 10. launches  — every kernel's launch count over the route phases
                 (the lag-2 mesh routes included; with several cards
                 also a mesh-2 route with both shards on card 0, the
                 one-card path)
 11. device    — the kernels' device time per launch (torch.profiler)
                 for the cases phases 3-6 timed, and that K2's and the
                 cluster kernel's wrappers launch one kernel per call
 12. profile   — a torch.profiler breakdown of a warm bench route, a
                 warm mesh_shards=2 bench route and a warm scale route
                 (their untraced seconds taken in phases 7-9)
Then a JSON line of per-kernel numbers and, last, the result line.
It imports nothing of JAX and nothing of the JAX package.

Every host-clock timing (ms per call, route seconds) is taken before
the first profiler session: a session can leave the process's later
launches slower on the host (the "launch" line gives the host's cost
per launch before and after).

The shards of phases 4, 6 and 8 are placed round-robin over the visible
cards, so on a machine with several cards their halos cross NVLink.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM peaks: the HBM3 rate and NVLink 4 to another card, one way
# (NVIDIA data sheet); the f32 rate of separate add / multiply / min
# instructions — the kernels are built with -fmad=false, so no FMA
# counts two operations — 132 SMs x 128 f32 lanes x 1.98 GHz boost
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 132 * 128 * 1.98e9
PEAK_NVLINK_BYTES_S = 450e9
REPLACES = {
    "planes_relax_full_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:308",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
    # K2's kernel, one sweep per launch: the per-shard sweep of
    # parallel_eda_tpu/route/planes_shard.py:369
    "planes_sweep_block_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
    # K3 with the install that followed it (planes_shard.py:317-355); the
    # same kernel serves remote_slab_permute_cuda, held in the halo phase
    "halo_exchange_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:597",
    # the whole sharded relaxation on one card (K2's kernel per shard per
    # sweep, planes_shard.py:369, with remote_slab_permute between)
    "planes_relax_cluster_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
}
SOURCES = {
    "planes_relax_full_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_sweep_block_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "halo_exchange_cuda": "parallel_eda_tpu_torch/csrc/slab_permute.cu",
    "planes_relax_cluster_cuda":
        "parallel_eda_tpu_torch/csrc/planes_relax.cu",
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` warmed calls: CUDA events
    on one card; with several cards visible, the host clock between
    synchronisations of every card (the work spans their streams).  The
    garbage collector is paused while the calls run, as timeit pauses
    it: one collection of this process's heap costs more than a
    bench-size kernel call."""
    import torch

    fn()
    n = torch.cuda.device_count()
    gc.collect()
    gc.disable()
    try:
        if n > 1:
            for d in range(n):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            for d in range(n):
                torch.cuda.synchronize(d)
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps
    finally:
        gc.enable()


# device-time measurements queued by the timing phases and taken in
# phase_device, after every host-clock timing: (tag, dict, field, fn, key)
_DEVICE = []


def device_later(tag, d, field, fn, key: str) -> None:
    """Queue ``d[field] = device_us(fn, key)`` for phase_device.  ``fn``
    must hold its own arguments (functools.partial), not a loop's
    variables."""
    _DEVICE.append((tag, d, field, fn, key))


# wrappers that must launch exactly one kernel per call, checked in
# phase_device: (tag, fn, key)
_ONE_KERNEL = []


def phase_device() -> None:
    for tag, d, field, fn, key in _DEVICE:
        d[field] = device_us(fn, key)
        say("device", f"{tag} {field}: {d[field]:.2f} us per launch")
    _DEVICE.clear()
    for tag, fn, key in _ONE_KERNEL:
        names = kernels_per_call(fn)
        if len(names) != 1 or key not in next(iter(names)) or \
                next(iter(names.values())) != 1:
            raise AssertionError(f"{tag}: one call launched {names}, want "
                                 f"one {key}")
        say("device", f"{tag}: one kernel per call ({names})")
    _ONE_KERNEL.clear()


def kernels_per_call(fn, reps: int = 5) -> dict:
    """The kernels one call of ``fn`` launches on the card, by name,
    per call (memsets and copies aside), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA or \
                    e.key.startswith(("Memset", "Memcpy")):
                continue
            names[e.key] = names.get(e.key, 0) + e.count
        if names:
            return {k: v / reps for k, v in names.items()}
    raise AssertionError("the profiler saw no kernel")


def launch_us(n: int = 20000) -> float:
    """Host µs per launch of a one-element PyTorch add: the process's
    cost of a launch (the host's speed; a profiler session can raise
    it)."""
    import torch

    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def device_us(fn, key: str, reps: int = 20) -> float:
    """Mean device time (µs) per launch of the kernels whose name holds
    ``key`` over ``reps`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the wrapper's host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without the device's activity
    # records; such a trace is taken again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA \
                    and key in e.key:
                us += (getattr(e, "self_device_time_total", 0)
                       or getattr(e, "device_time_total", 0))
                n += e.count
        if n:
            return us / n
    raise AssertionError(f"the profiler saw no {key} launch")


def scan_combines(n: int) -> int:
    """Combines of lax.associative_scan's tree over a length-n line."""
    if n < 2:
        return 0
    return n // 2 + (n + 1) // 2 - 1 + scan_combines(n // 2)


def sweep_ops(W: int, X: int, Y: int, directional: bool) -> int:
    """f32 operations that one sweep of one net on an (X, Y) canvas needs,
    counting only what can change its result.  Four line scans: per
    combine of lax.associative_scan's tree two adds and a min, per cell
    the compare with dist (the scan cost is launch_ops').  Two turn
    stencils: each candidate that can win — the straight turn and the
    rotated turn of the corner's parity, from the source pairs (a, b)
    inside the canvas, on one gate side only on directional tracks — at
    the min of its two gates (not on directional tracks), two adds and
    the compare; per target the compare with dist and crit * delay (into
    y on bidirectional tracks also the two rotated delays)."""
    ncx, ncy = W * X * (Y + 1), W * (X + 1) * Y
    scans = (2 * W * (Y + 1) * (3 * scan_combines(X) + X)
             + 2 * W * (X + 1) * (3 * scan_combines(Y) + Y))
    # straight + rotated (at W = 2 only one parity has a rotated turn)
    turns = 1 + (W > 2)
    sides = 1 if directional else 2
    cands = turns * sides * (W * Y * 2 * X + W * X * 2 * Y)
    per_target = 2 * ncx + (2 if directional else 4) * ncy
    return scans + cands * (3 if directional else 4) + per_target


def launch_ops(W: int, X: int, Y: int) -> int:
    """f32 operations a relaxation launch needs once per net: the scan
    cost crit * delay + cc of every cell."""
    return 2 * (W * X * (Y + 1) + W * (X + 1) * Y)


def bounds(nbytes: float, ops: float) -> dict:
    """The bytes bound (HBM), the operations bound (f32) and the larger
    of the two, in ms."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bytes_bound_ms=tb, ops_bound_ms=to)


def bound_ms(pg, B: int, net_sweeps, tile=None):
    """Least time for one relaxation call: the larger of (flats read and
    written once + the geometry once) / HBM rate and (the sweeps this
    run's data needed x ops per sweep + the scan costs once per net) /
    f32 rate."""
    W, NX, NYp1 = pg.shape_x
    nc = pg.ncells
    geo = 4 * nc + 4 * (W * NX * NYp1 + 3 * (nc - W * NX * NYp1))
    nbytes = 3 * 4 * B * nc + 4 * B + 12 * B * nc + 8 * B + geo
    X, Y = (NX, NYp1 - 1) if tile is None else tile
    return bounds(nbytes, int(net_sweeps.sum())
                  * sweep_ops(W, X, Y, pg.directional)
                  + B * launch_ops(W, X, Y))


def phase_card():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("card", f"{smi} | torch {torch.__version__} cuda "
                f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from parallel_eda_tpu_torch.place import serial_sa
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR

    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    gxx = subprocess.Popen(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         serial_sa._SRC, "-o", serial_sa._SO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = (pk.LIB, sk.LIB)
    procs = [lib.start_build() for lib in libs]
    infos = [lib.finish_build(p) for lib, p in zip(libs, procs)]
    out, _ = gxx.communicate()
    if gxx.returncode != 0:
        raise RuntimeError(f"g++ serial_sa.cc failed:\n{out}")
    for lib, info in zip(libs, infos):
        say("build", f"nvcc {lib.name}.cu {info['seconds']:.1f}s; "
                     + " | ".join(info["ptxas"]))
    say("build", f"all sources {time.time() - t0:.1f}s")


def _instance(rr, pg, B, rng, exact, crit_on=False):
    """Random wire seeds per net, power-of-two (f32-exact) or uniform
    (jittered) congestion, as flats on the card."""
    import torch

    from parallel_eda_tpu_torch.rr.graph import CHANX, CHANY

    N = rr.num_nodes
    noc = pg.node_of_cell.cpu().numpy()
    wires = np.where((rr.node_type == CHANX) | (rr.node_type == CHANY))[0]
    seed = np.zeros((B, N), bool)
    for b in range(B):
        seed[b, rng.choice(wires, 2, replace=False)] = True
    if exact:
        cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
    else:
        cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(np.float32)
    crit = (rng.uniform(0, 0.8, (B, 1, 1, 1)) if crit_on
            else np.zeros((B, 1, 1, 1))).astype(np.float32)
    d0 = np.ascontiguousarray(
        np.where(seed[:, noc], 0.0, np.inf).astype(np.float32))
    cuda = torch.device("cuda")
    return (torch.from_numpy(d0).to(cuda),
            torch.from_numpy(np.ascontiguousarray(cong[:, noc])).to(cuda),
            torch.from_numpy(crit).to(cuda),
            torch.zeros((B, pg.ncells), dtype=torch.float32, device=cuda))


def _compare(tag, got, ref):
    """Bit-identity of (dist, pred, wenter, stats); returns max |err|."""
    names = ("dist", "pred", "wenter", "stats")
    err = 0.0
    for n, a, b in zip(names, got, ref):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if n in ("dist", "wenter"):
            fin = np.isfinite(b)
            if not np.array_equal(np.isfinite(a), fin):
                raise AssertionError(f"{tag}: {n} reachability differs")
            if fin.any():
                err = max(err, float(np.abs(a[fin] - b[fin]).max()))
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag}: {n} not bit-identical "
                                 f"(max abs err {err:g})")
    return err


def phase_kernels(flows):
    """K1 and K2 against their plain versions on the card."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    rows = {}
    rng = np.random.default_rng(0)
    for cfg, flow in flows.items():
        rr = flow.rr
        pg = P.build_planes(rr, "cuda")
        W, NX, NYp1 = pg.shape_x
        NY = NYp1 - 1
        B = 64
        nsw = 32 if NX < 16 else 64
        tiles = [(4, 4)] if NX < 16 else [(8, 8), (16, 16)]
        for kind in ("exact", "jitter", "crit"):
            inst = _instance(rr, pg, B, rng, kind == "exact",
                             crit_on=kind == "crit")
            # --- K1: full canvas ---
            got = P.planes_relax(pg, *inst[:3], inst[3], nsw)
            net_st = pk.planes_relax_full_cuda.last_stats[:-1].cpu().numpy()
            auto = pk.planes_relax_full_cuda.last_mode
            ref = P.planes_relax_plain(pg, *inst[:3], inst[3], nsw)
            err = _compare(f"K1 {cfg} {kind}", got, ref)
            # every smaller shared-memory mode gives the same bits
            for m in range(auto):
                err = max(err, _compare(
                    f"K1 {cfg} {kind} mode {m}", pk.planes_relax_full_cuda(
                        pg, *inst[:3], inst[3], nsw, mode=m), ref))
            case = dict(cfg=cfg, costs=kind, shape=[W, NX, NY], B=B,
                        sweeps=int(got[3][0]), max_abs_err=err, mode=auto)
            if kind == "jitter":
                case["ms"] = cuda_ms(lambda: P.planes_relax(
                    pg, *inst[:3], inst[3], nsw), 100 if NX < 16 else 20)
                # the kernel alone, and its fixed part (one sweep)
                tag = f"K1 {cfg}"
                device_later(tag, case, "device_us", functools.partial(
                    P.planes_relax, pg, *inst[:3], inst[3], nsw),
                    "planes_relax_full")
                device_later(tag, case, "one_sweep_device_us",
                             functools.partial(P.planes_relax, pg,
                                               *inst[:3], inst[3], 1),
                             "planes_relax_full")
                by_mode = case["device_us_by_mode"] = {}
                for m in range(auto + 1):
                    device_later(f"{tag} mode {m}", by_mode, m,
                                 functools.partial(
                                     pk.planes_relax_full_cuda, pg,
                                     *inst[:3], inst[3], nsw, mode=m),
                                 "planes_relax_full")
                case["plain_ms"] = cuda_ms(lambda: P.planes_relax_plain(
                    pg, *inst[:3], inst[3], nsw), 2)
                case.update(bound_ms(pg, B, net_st[:, 0]))
            rows.setdefault("planes_relax_full_cuda", []).append(case)
            say("kernels", f"K1 full {cfg} {kind}: bit-identical, "
                           + json.dumps(case))
            # --- K2: cropped tiles, origins from below 0 to past the
            # grid (the kernel clamps them) ---
            for (cnx, cny) in tiles:
                ox = torch.from_numpy(rng.integers(
                    -3, NX - cnx + 4, B).astype(np.int32)).cuda()
                oy = torch.from_numpy(rng.integers(
                    -3, NY - cny + 4, B).astype(np.int32)).cuda()
                args = (pg, *inst[:3], inst[3], nsw, ox, oy, cnx, cny)
                got = P.planes_relax_cropped(*args)
                net_st = (pk.planes_relax_cropped_cuda.last_stats[:-1]
                          .cpu().numpy())
                auto = pk.planes_relax_cropped_cuda.last_mode
                tag = f"K2 {cfg} {kind} {cnx}x{cny}"
                ref = P.planes_relax_cropped_plain(*args)
                err = _compare(tag, got, ref)
                for m in range(auto):
                    err = max(err, _compare(
                        f"{tag} mode {m}", pk.planes_relax_cropped_cuda(
                            *args, mode=m), ref))
                case = dict(cfg=cfg, costs=kind, tile=[cnx, cny], B=B,
                            sweeps=int(got[3][0]), max_abs_err=err,
                            mode=auto)
                if kind == "jitter":
                    case["ms"] = cuda_ms(
                        lambda: P.planes_relax_cropped(*args), 20)
                    device_later(f"K2 {cfg} {cnx}x{cny}", case,
                                 "device_us", functools.partial(
                                     P.planes_relax_cropped, *args),
                                 "planes_relax_cropped")
                    _ONE_KERNEL.append((
                        f"K2 {cfg} {cnx}x{cny}", functools.partial(
                            P.planes_relax_cropped, *args),
                        "planes_relax_cropped_kernel"))
                    case["plain_ms"] = cuda_ms(
                        lambda: P.planes_relax_cropped_plain(*args), 2)
                    case.update(bound_ms(pg, B, net_st[:, 0],
                                         tile=(cnx, cny)))
                rows.setdefault("planes_relax_cropped_cuda",
                                []).append(case)
                say("kernels", f"K2 cropped {cfg} {kind} {cnx}x{cny}: "
                               "bit-identical, " + json.dumps(case))
    return rows


def _same(tag, got, ref):
    """Bit-identity of tensor sequences; returns max |err| over finite
    reference values."""
    err = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype.kind == "f":
            fin = np.isfinite(b)
            if fin.any() and np.isfinite(a[fin]).all():
                err = max(err, float(np.abs(a[fin] - b[fin]).max()))
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag}: output {k} not bit-identical "
                                 f"(max abs err {err:g})")
    return err


def _sync_all():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def exchange_bound_ms(moves):
    """Least time of one exchange: each moved slab read once and each
    halo written once over HBM, or — across cards — the bytes one NVLink
    direction carries (the largest of the card pairs) over its rate."""
    hbm, link = 0, {}
    for src, dst, _ in moves:
        nb = dst.numel() * 4
        hbm += nb * (2 if src is not None else 1)
        if src is not None and src.device != dst.device:
            key = (src.device, dst.device)
            link[key] = link.get(key, 0) + nb
    return max(hbm / PEAK_BYTES_S,
               max(link.values(), default=0) / PEAK_NVLINK_BYTES_S) * 1e3


def phase_halo(shapes):
    """K3 on the card.  (a) The TPU kernel's contract: the four one-hop
    shifts of an exchange round (dx right/left 1 column, dy right 1 /
    left 2 columns) from strided views of random block canvases, through
    remote_slab_permute_cuda, against its plain version.  (b) The
    route's exchange: halo_exchange_cuda in place on the shards' block
    states, from the same set (lag 1) and from another (lag 2), against
    halo_exchange_plain: bit-identical.  Shard i sits on card i mod
    (visible cards).  Times per exchange (one sweep's halos): the
    prebuilt exchange (HaloExchange), its plain version, the library
    loop (one dst.copy_(src) per halo view plus fill_(INF) at the edges:
    4 * s PyTorch calls on prebuilt views) and the buffered exchange (four
    remote_slab_permute_cuda calls into fresh buffers, then the install
    copies); the bound is exchange_bound_ms."""
    import torch

    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.planes_shard import row_block_cols

    rng = np.random.default_rng(1)
    rows = []
    ncard = torch.cuda.device_count()
    B = 64

    def canvas(shape, i):
        a = rng.uniform(0, 1e-9, shape).astype(np.float32)
        a[rng.random(shape) < 0.3] = np.inf
        return torch.from_numpy(a).to(f"cuda:{i % ncard}")

    for cfg, pg, s in shapes:
        W, NX, NYp1 = pg.shape_x
        NY = NYp1 - 1
        kx = row_block_cols(pg, s)

        def states():
            return [(canvas((B, W, kx + 2, NYp1), i),
                     canvas((B, W, kx + 3, NY), i)) for i in range(s)]

        sts, other = states(), states()
        calls = [([st[0][:, :, kx:kx + 1] for st in sts], True),
                 ([st[0][:, :, 1:2] for st in sts], False),
                 ([st[1][:, :, kx:kx + 1] for st in sts], True),
                 ([st[1][:, :, 1:3] for st in sts], False)]
        err = 0.0
        for slabs, fwd in calls:
            got = sk.remote_slab_permute_cuda(slabs, fwd)
            _sync_all()
            ref = sk.slab_permute_plain(slabs, fwd)
            err = max(err, _same(f"K3 shift {cfg} s={s} fwd={fwd}", got,
                                 ref))
        for src in (None, other):
            ref = [tuple(t.clone() for t in st) for st in sts]
            sk.halo_exchange_plain(ref, kx, src)
            n0 = sk.halo_exchange_cuda.launches
            sk.halo_exchange_cuda(sts, kx, src)
            _sync_all()
            per_sweep = sk.halo_exchange_cuda.launches - n0
            for k in range(s):
                err = max(err, _same(f"K3 exchange {cfg} s={s} lag "
                                     f"{1 if src is None else 2} shard {k}",
                                     sts[k], ref[k]))
        moves = sk.halo_moves(sts, kx)
        lib_moves = [(a, b) for a, b, _ in moves]
        inf = float("inf")

        def library():
            for a, b in lib_moves:
                if a is None:
                    b.fill_(inf)
                else:
                    b.copy_(a)

        def buffered():
            got = [sk.remote_slab_permute_cuda(sl, f) for sl, f in calls]
            for r, st in enumerate(sts):
                lx, rx, ly, ry = (g[r] for g in got)
                for dst, h, edge in ((st[0][:, :, 0:1], lx, r == 0),
                                     (st[0][:, :, kx + 1:kx + 2], rx,
                                      r == s - 1),
                                     (st[1][:, :, 0:1], ly, r == 0),
                                     (st[1][:, :, kx + 1:kx + 3], ry,
                                      r == s - 1)):
                    if edge:
                        dst.fill_(inf)
                    else:
                        dst.copy_(h)

        run = sk.HaloExchange(sts, kx)
        case = dict(
            cfg=cfg, shards=s, B=B, block=[W, kx, NY],
            cards=min(s, ncard), launches_per_sweep=per_sweep,
            max_abs_err=err,
            ms=cuda_ms(run, 500),
            plain_ms=cuda_ms(lambda: sk.halo_exchange_plain(sts, kx), 100),
            library_ms=cuda_ms(library, 200),
            buffered_ms=cuda_ms(buffered, 100),
            shift_ms=cuda_ms(lambda: sk.remote_slab_permute_cuda(*calls[0]),
                             200),
            bound_ms=exchange_bound_ms(moves), bound_by="bytes")
        # the exchange writes into sts: the queued call holds them
        device_later(f"K3 {cfg} s={s}", case, "device_us",
                     functools.partial(lambda r, keep: r(), run, sts),
                     "slab_permute")
        rows.append(case)
        say("halo", "K3 shift and exchange bit-identical, "
                    + json.dumps(case))
    return rows


def _blocks(pg, inst, s, devices):
    """The shards' bench blocks of a random instance: (geometry, state
    after one plain sweep — pred carried in —, crit, ccx, ccy) per
    shard, and kx."""
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_shard as TS

    d0, cc, crit, w0 = inst
    kx = TS.row_block_cols(pg, s)
    gms = TS._shard_geoms(pg, TS.make_row_mesh(s, devices=devices), kx)
    cut = []
    for (x, y), f in zip((P._split_flat(pg, a) for a in (d0, cc, w0)),
                         (np.inf, np.inf, 0.0)):
        cut.append((TS.shard_blocks(x, f, 2, kx, devices),
                    TS.shard_blocks(y, f, 3, kx, devices)))
    (dx, dy), (ccx, ccy), (wx, wy) = cut
    out = []
    for k, g in enumerate(gms):
        st = (dx[k], dy[k], g.idxx.expand(dx[k].shape).contiguous(),
              g.idxy.expand(dy[k].shape).contiguous(), wx[k], wy[k])
        costs = P._sweep_costs(g, crit, ccx[k], ccy[k])
        st = P._sweep_once(g, st, crit, ccx[k], ccy[k], costs)
        out.append((g, st, crit, ccx[k], ccy[k], costs))
    return out, kx


def step_bound_ms(B, W, X, Y, gm):
    """Least time of one step launch: per cell the state (dist, pred,
    wenter) and congestion read once and the new state written once,
    crit read and stats written once per net, the block geometry read
    once (bytes); or one sweep of every net and its scan costs (f32
    operations)."""
    cells = W * X * (Y + 1) + W * (X + 1) * Y
    geo = sum(getattr(gm, k).numel() * getattr(gm, k).element_size()
              for k in ("brk_before_x", "brk_after_x", "brk_before_y",
                        "brk_after_y", "first_x", "last_x", "first_y",
                        "last_y", "delay_x", "delay_y", "delay_y_rot0",
                        "delay_y_rot1", "idxx", "idxy", "base_par"))
    nbytes = B * cells * 4 * (4 + 3) + 4 * B + 8 * B + geo
    return bounds(nbytes, B * (sweep_ops(W, X, Y, gm.directional)
                               + launch_ops(W, X, Y)))


def phase_step(shapes):
    """The step entry against one plain sweep on each shard's block
    (B=64), pred carried in, exact, jittered and crit > 0 costs, in every
    shared-memory mode that fits (the route takes the most that fits);
    the kernel's owned-changed flags against the plain
    sweep's.  Times: the prebuilt launch (sweep_block_launcher, as the
    route calls it) in every mode, the one-shot wrapper, and one plain
    sweep."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    rng = np.random.default_rng(2)
    B = 64
    rows = []
    for cfg, rr, pg, s in shapes:
        W, NX, NYp1 = pg.shape_x
        for kind in ("exact", "jitter", "crit"):
            inst = _instance(rr, pg, B, rng, kind == "exact",
                             crit_on=kind == "crit")
            blocks, kx = _blocks(pg, inst, s, ["cuda"] * s)
            own = slice(1, kx + 1)
            err = 0.0
            for k, (g, st, crit, ccx, ccy, costs) in enumerate(blocks):
                ref = P._sweep_once(g, st, crit, ccx, ccy, costs)
                flag = ((ref[0][:, :, own] < st[0][:, :, own]
                         ).flatten(1).any(1)
                        | (ref[1][:, :, own] < st[1][:, :, own]
                           ).flatten(1).any(1))
                auto = pk.sweep_block_launcher(
                    g, st, crit, ccx, ccy, (1, kx + 1),
                    tuple(torch.empty_like(t) for t in st),
                    torch.empty((B, 2), dtype=torch.int32,
                                device=st[0].device)).mode
                for mode in [None] + list(range(auto + 1)):
                    got, stats = pk.planes_sweep_block_cuda(
                        g, st, crit, ccx, ccy, (1, kx + 1), mode=mode)
                    torch.cuda.synchronize()
                    tag = f"step {cfg} s={s} {kind} shard {k} mode {mode}"
                    err = max(err, _same(tag, got, ref))
                    if not torch.equal(stats[:, 1].bool(), flag):
                        raise AssertionError(f"{tag}: owned-changed flags "
                                             "differ")
            case = dict(cfg=cfg, shards=s, costs=kind, B=B,
                        block=[W, kx + 2, NYp1 - 1], max_abs_err=err)
            if kind == "jitter":
                g, st, crit, ccx, ccy, costs = blocks[0]
                out = tuple(torch.empty_like(t) for t in st)
                stats = torch.empty((B, 2), dtype=torch.int32,
                                    device=st[0].device)
                for j, mode in enumerate(list(range(auto + 1)) + [None]):
                    run = pk.sweep_block_launcher(g, st, crit, ccx, ccy,
                                                  (1, kx + 1), out, stats,
                                                  mode)
                    # the route's mode last, under the plain keys
                    tag = "" if j > auto else f"_mode{mode}"
                    case["ms" + tag] = cuda_ms(run, 200)
                    device_later(f"step {cfg} s={s}{tag}", case,
                                 "device_us" + tag, run,
                                 "planes_relax_block")
                case["mode"] = run.mode
                case["wrapper_ms"] = cuda_ms(
                    lambda: pk.planes_sweep_block_cuda(
                        g, st, crit, ccx, ccy, (1, kx + 1)), 50)
                case["plain_ms"] = cuda_ms(lambda: P._sweep_once(
                    g, st, crit, ccx, ccy, costs), 10)
                case.update(step_bound_ms(B, W, kx + 2, NYp1 - 1, g))
            rows.append(case)
            say("step", "bit-identical, " + json.dumps(case))
    return rows


def phase_sharded(shapes):
    """planes_relax_sharded on the card.  (a) Its one-card lag-1 form, one
    cluster launch per relaxation, against the per-sweep form on the same
    one-card mesh (the step and halo kernels) and the plain per-sweep
    loop on the card: every output and the stats bit-identical, in every
    shared-memory mode; dist and wenter equal single-device K1's
    (power-of-two costs); all three timed.  (b) At the bench shape, the
    route's meshes (shards round-robin over the visible cards), both
    schedules, 2 and 4 shards, against K1 and against the same call on
    CPU tensors (everything equal)."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    rng = np.random.default_rng(3)
    rows = []
    B, nsw = 64, 32
    for cfg, rr, pg, shard_counts in shapes:
        W, NX, NYp1 = pg.shape_x
        inst = _instance(rr, pg, B, rng, True)
        k1 = P.planes_relax(pg, *inst, nsw)
        card = inst[0].device
        for s in shard_counts:
            one = TS.make_row_mesh(s, "ppermute", [card] * s)
            cap = TS.sweep_cap(nsw, s)
            tag = f"cluster {cfg} s={s}"
            c0 = {**pk.launch_counts(), **sk.launch_counts()}
            got = TS.planes_relax_sharded(pg, *inst, nsw, one)
            torch.cuda.synchronize()
            c1 = {**pk.launch_counts(), **sk.launch_counts()}
            dc = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
            if dc != {"planes_relax_cluster_cuda": 1}:
                raise AssertionError(f"{tag}: launches {dc}, want one "
                                     "cluster launch")
            net_st = pk.planes_relax_cluster_cuda.last_stats[:-1]
            auto = pk.planes_relax_cluster_cuda.last_mode
            if not torch.equal(net_st.max(0).values, got[3]):
                raise AssertionError(f"{tag}: stats are not the max over "
                                     "nets")
            sweeps = TS.planes_relax_sharded_sweeps(pg, *inst, nsw, one)
            plain = TS.planes_relax_sharded_sweeps(pg, *inst, nsw, one,
                                                   plain=True)
            err = max(_same(f"{tag} vs per-sweep", got, sweeps),
                      _same(f"{tag} vs plain", got, plain))
            for m in range(auto):
                err = max(err, _same(f"{tag} mode {m} vs plain",
                                     pk.planes_relax_cluster_cuda(
                                         pg, *inst, cap, s, mode=m), plain))
            for k, n in ((0, "dist"), (2, "wenter")):
                if not torch.equal(got[k], k1[k]):
                    raise AssertionError(f"{tag}: {n} differs from K1")
            per_net = net_st.cpu().numpy()
            case = dict(cfg=cfg, shards=s, B=B,
                        block=[W, TS.row_block_cols(pg, s) + 2, NYp1 - 1],
                        mode=auto, sweeps=got[3].tolist(),
                        net_sweeps_min=int(per_net[:, 0].min()),
                        max_abs_err=err)
            case["ms"] = cuda_ms(lambda: TS.planes_relax_sharded(
                pg, *inst, nsw, one), 20)
            case["per_sweep_ms"] = cuda_ms(
                lambda: TS.planes_relax_sharded_sweeps(pg, *inst, nsw, one),
                3)
            case["plain_ms"] = cuda_ms(
                lambda: TS.planes_relax_sharded_sweeps(pg, *inst, nsw, one,
                                                       plain=True), 1)
            run = functools.partial(pk.planes_relax_cluster_cuda, pg,
                                    *inst, cap, s)
            device_later(tag, case, "device_us", run,
                         "planes_relax_cluster")
            by_mode = case["device_us_by_mode"] = {}
            for m in range(auto + 1):
                device_later(f"{tag} mode {m}", by_mode, m,
                             functools.partial(run, mode=m),
                             "planes_relax_cluster")
            _ONE_KERNEL.append((tag, run, "planes_relax_cluster_kernel"))
            # the same function as K1's on the whole canvas: its bound
            # counts each net's executed sweeps over the canvas, not the
            # blocks' halo and pad columns
            case.update(bound_ms(pg, B, per_net[:, 0]))
            rows.append(case)
            say("sharded", f"{tag}: one launch, bit-identical to the "
                           "per-sweep and plain forms, dist/wenter = K1, "
                           + json.dumps(case))
        if cfg != "bench":
            continue
        # more than 8 shards: a non-portable cluster, or the card's
        # stated refusal
        try:
            wide = pk.planes_relax_cluster_cuda(pg, *inst,
                                                TS.sweep_cap(nsw, 9), 9)
            _same("cluster bench s=9 vs plain", wide,
                  TS.planes_relax_sharded_sweeps(
                      pg, *inst, nsw, TS.make_row_mesh(
                          9, "ppermute", [card] * 9), plain=True))
            say("sharded", "cluster bench s=9 (non-portable size): "
                           "bit-identical to the plain loop, mode "
                           f"{pk.planes_relax_cluster_cuda.last_mode}")
        except RuntimeError as e:
            if "cannot schedule" not in str(e):
                raise
            say("sharded", f"cluster bench s=9: refused ({e})")
        pg_cpu = P.build_planes(rr, "cpu")
        for impl in TS.MESH_IMPLS:
            for s in (2, 4):
                rm = TS.make_row_mesh(s, impl, "cuda")
                torch.cuda.synchronize()
                t0 = time.time()
                got = TS.planes_relax_sharded(pg, *inst, nsw, rm)
                torch.cuda.synchronize()
                dt = time.time() - t0
                for k, n in ((0, "dist"), (2, "wenter")):
                    if not torch.equal(got[k], k1[k]):
                        raise AssertionError(f"sharded {impl} s={s}: {n} "
                                             "differs from K1")
                ref = TS.planes_relax_sharded(
                    pg_cpu, *(t.cpu() for t in inst), nsw,
                    TS.make_row_mesh(s, impl, "cpu"))
                _same(f"sharded {impl} s={s} vs CPU", got, ref)
                say("sharded", f"{impl} s={s} on {rm.n_cards} card(s) "
                               f"(cluster: {TS.uses_cluster(rm, card)}): "
                               "dist/wenter = K1, all = CPU; "
                               f"sweeps {got[3].tolist()} (K1 "
                               f"{k1[3].tolist()}), {dt * 1e3:.1f} ms")
    return rows


def _route(tag, flow, opts, impl=None, devices=None):
    """Route ``flow`` on the card, legal or raise; with ``impl``, under
    that exchange schedule instead of the Router's own; with
    ``devices``, the shards on those cards instead of round-robin."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.planes_shard import (make_row_mesh,
                                                           uses_cluster)
    from parallel_eda_tpu_torch.route.router import Router

    router = Router(flow.rr, opts, device="cuda")
    if impl is not None or devices is not None:
        router.row_mesh = make_row_mesh(opts.mesh_shards, impl or "ppermute",
                                        devices or "cuda")
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = router.route(flow.term)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = {**pk.launch_counts(), **sk.launch_counts()}
    if not res.success:
        raise AssertionError(f"{tag}: route did not converge")
    check_route(flow.rr, flow.term, res.paths, occ=res.occ)
    R = len(flow.term.source)
    say(tag, f"legal: wirelength {res.wirelength}, {res.iterations} "
             f"iterations, {dt:.2f} s route, {res.total_net_routes} net "
             f"routes ({res.total_net_routes / dt:.1f}/s), relax sweeps "
             f"{res.total_relax_steps} (cropped "
             f"{res.total_relax_steps_cropped}), {R} nets, grid "
             f"{flow.grid.nx}x{flow.grid.ny}, launches {counts}")
    rm = router.row_mesh
    if rm is not None:
        say(tag, f"mesh_shards={rm.n_shards} ({rm.impl}) on {rm.n_cards} "
                 f"card(s): sweeps executed {res.total_relax_steps}, useful "
                 f"{res.total_relax_steps_useful}; halo ledger "
                 f"{json.dumps(router.metrics)}")
        if uses_cluster(rm, torch.device("cuda", torch.cuda.current_device())):
            # one launch per relaxation: neither the step nor the halo
            # kernel runs, and no host read happens inside a relaxation
            if counts["planes_relax_cluster_cuda"] <= 0 or \
                    counts["planes_sweep_block_cuda"] or \
                    counts["halo_exchange_cuda"]:
                raise AssertionError(f"{tag}: the one-card lag-1 route did "
                                     "not run as one cluster launch per "
                                     f"relaxation: {counts}")
        else:
            if counts["planes_sweep_block_cuda"] <= 0 \
                    or counts["halo_exchange_cuda"] <= 0 \
                    or counts["planes_relax_cluster_cuda"]:
                raise AssertionError(f"{tag}: the sharded route did not run "
                                     "the step and halo kernels")
            if rm.n_cards == 1 and \
                    counts["halo_exchange_cuda"] != res.total_relax_steps:
                raise AssertionError(
                    f"{tag}: {counts['halo_exchange_cuda']} exchange "
                    f"launches for {res.total_relax_steps} sweeps on one "
                    "card (want one per sweep)")
        if counts["remote_slab_permute_cuda"]:
            raise AssertionError(f"{tag}: the route shifted slabs into "
                                 "buffers instead of exchanging in place")
        if counts["planes_relax_full_cuda"] or \
                counts["planes_relax_cropped_cuda"]:
            raise AssertionError(f"{tag}: a single-device relaxation ran "
                                 "under the mesh")
    return res, counts, dt


def warm_route(flow, opts):
    """A Router that has routed ``flow`` once, and the seconds of a
    second (warm, untraced) route on it."""
    import torch

    from parallel_eda_tpu_torch.route.router import Router

    router = Router(flow.rr, opts, device="cuda")
    router.route(flow.term)
    torch.cuda.synchronize()
    t0 = time.time()
    router.route(flow.term)
    torch.cuda.synchronize()
    return router, time.time() - t0


def phase_profile(flow, warm, tag):
    """Where a warm route's time goes on the card: one more route on the
    Router of ``warm`` (warm_route's result) is traced with
    torch.profiler (device activity only) for device time by kernel, the
    hand-written kernels' device time per launch and their share; the
    busy share is device time over warm_route's untraced seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    router, route_s = warm
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        router.route(flow.term)
        torch.cuda.synchronize()
    wall_us = (time.time() - t0) * 1e6
    kern = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "device_time_total", 0))
        kern.append((us, e.count, e.key))
    busy = sum(k[0] for k in kern)
    if busy <= 0:
        say("profile", "not measured: the profiler reported no device "
                       "time")
        return
    kern.sort(reverse=True)
    hand = [k for k in kern if "planes_relax" in k[2]
            or "slab_permute" in k[2]]
    own = "; ".join(f"{k[2].split('(')[0].split('::')[-1]} "
                    f"{k[0] / 1e3:.1f}ms x{k[1]} = {k[0] / k[1]:.1f}us each"
                    for k in hand)
    top = "; ".join(f"{k[2][:60]} {k[0] / 1e3:.1f}ms x{k[1]}"
                    for k in kern[:6])
    hand_us = sum(k[0] for k in hand)
    # PyTorch's elementwise, fill and copy kernels (where the halo
    # installs ran before the exchange wrote in place)
    elem = [k for k in kern if k not in hand and any(
        w in k[2].lower() for w in ("elementwise", "fill", "copy"))]
    say("profile", f"{tag} route traced {wall_us / 1e6:.2f}s wall "
                   f"(untraced {route_s:.2f}s), device busy "
                   f"{busy / 1e3:.1f}ms ({busy / 1e6 / route_s:.3f} of the "
                   f"untraced wall), hand-written kernels "
                   f"{hand_us / 1e3:.1f}ms ({hand_us / busy:.3f} of device "
                   f"time: {own}), {sum(k[1] for k in kern)} kernel "
                   f"launches, of which elementwise/fill/copy "
                   f"{sum(k[1] for k in elem)} "
                   f"({sum(k[0] for k in elem) / 1e3:.1f}ms); top: {top}")


def main(argv) -> int:
    if argv:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    smi = phase_card()
    import torch

    from parallel_eda_tpu_torch.flow import run_place_native, synth_flow
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route.router import RouterOpts

    say("card", f"{torch.cuda.device_count()} visible card(s)")
    phase_build()
    launch0 = launch_us()
    t0 = time.time()
    bench = synth_flow(num_luts=60, num_inputs=12, num_outputs=12,
                       chan_width=12, seed=11)
    scale = synth_flow(num_luts=1200, num_inputs=12, num_outputs=12,
                       chan_width=20, seed=11)
    say("flows", f"front ends built in {time.time() - t0:.1f}s")
    rows = phase_kernels({"bench": bench, "scale": scale})
    pg_bench = P.build_planes(bench.rr, "cuda")
    pg_scale = P.build_planes(scale.rr, "cuda")
    rows["halo_exchange_cuda"] = phase_halo(
        [("bench", pg_bench, s) for s in (2, 3, 4)]
        + [("scale", pg_scale, 4)])
    rows["planes_sweep_block_cuda"] = phase_step(
        [("bench", bench.rr, pg_bench, s) for s in (2, 4)]
        + [("scale", scale.rr, pg_scale, 4)])
    rows["planes_relax_cluster_cuda"] = phase_sharded(
        [("bench", bench.rr, pg_bench, (2, 3, 4)),
         ("scale", scale.rr, pg_scale, (4,))])

    res, c_bench, _ = _route("bench", bench, RouterOpts(batch_size=64))
    if (res.wirelength, res.iterations) != (537, 22):
        raise AssertionError(f"bench: expected wirelength 537 in 22 "
                             f"iterations, got {res.wirelength} in "
                             f"{res.iterations}")
    warm = {"bench": (bench, warm_route(bench, RouterOpts(batch_size=64)))}
    c_mesh, c_lag2 = [], []
    for s in (2, 4):
        # the Router's lag-1 schedule, then lag 2 for comparison, timed
        # in the order lag 1, lag 2, lag 2, lag 1
        opts = RouterOpts(batch_size=64, mesh_shards=s)
        secs = {"ppermute": [], "pallas_halo": []}
        sweeps = {}
        for k, impl in enumerate(("ppermute", "pallas_halo",
                                  "pallas_halo", "ppermute")):
            tag = f"mesh{s}" if impl == "ppermute" else f"mesh{s}_lag2"
            mres, c, dt = _route(tag, bench, opts,
                                 None if impl == "ppermute" else impl)
            if (mres.wirelength, mres.iterations) != (537, 22):
                raise AssertionError(f"{tag}: expected wirelength 537 in "
                                     f"22 iterations, got {mres.wirelength}"
                                     f" in {mres.iterations}")
            if not (np.array_equal(mres.paths, res.paths)
                    and np.array_equal(mres.occ, res.occ)):
                raise AssertionError(f"{tag}: paths/occupancy differ from "
                                     "the single-device bench route")
            secs[impl].append(dt)
            sweeps[impl] = (mres.total_relax_steps,
                            mres.total_relax_steps_useful)
            if k == 0:
                c_mesh.append(c)
            elif k == 1:
                c_lag2.append(c)
        say(f"mesh{s}", "paths and occupancy equal to the single-device "
                        "bench route under both schedules; route s "
                        f"lag 1 {secs['ppermute']}, lag 2 "
                        f"{secs['pallas_halo']}; sweeps executed (useful) "
                        f"lag 1 {sweeps['ppermute']}, lag 2 "
                        f"{sweeps['pallas_halo']}")
    if torch.cuda.device_count() > 1:
        # the route's shards spread over the cards; the one-card path
        # (the cluster kernel) is driven with every shard on card 0
        opts = RouterOpts(batch_size=64, mesh_shards=2)
        mres, c, _ = _route("mesh2_one_card", bench, opts,
                            devices=["cuda:0"] * 2)
        if (mres.wirelength, mres.iterations) != (537, 22) or not (
                np.array_equal(mres.paths, res.paths)
                and np.array_equal(mres.occ, res.occ)):
            raise AssertionError("mesh2_one_card: route differs from the "
                                 "single-device bench route")
        c_mesh.append(c)
    warm["mesh2"] = (bench, warm_route(
        bench, RouterOpts(batch_size=64, mesh_shards=2)))
    t0 = time.time()
    scale = run_place_native(scale)
    say("scale", f"placed {scale.pnl.num_blocks} blocks in "
                 f"{time.time() - t0:.1f}s (native SA)")
    _, c_scale, _ = _route("scale", scale, RouterOpts(batch_size=64))
    warm["scale"] = (scale, warm_route(scale, RouterOpts(batch_size=64)))
    _, c, _ = _route("scale_mesh4", scale,
                     RouterOpts(batch_size=64, mesh_shards=4))
    c_mesh.append(c)

    runs = [c_bench, c_scale] + c_mesh + c_lag2
    launches = {k: sum(r[k] for r in runs) for k in c_bench}
    say("launches", f"bench {c_bench} scale {c_scale} mesh (bench 2, "
                    f"bench 4, [bench 2 on one card,] scale 4) {c_mesh} "
                    f"mesh lag 2 (bench 2, bench 4) {c_lag2}")
    if c_bench["planes_relax_full_cuda"] <= 0:
        raise AssertionError("K1 never launched on the bench route")
    if c_scale["planes_relax_cropped_cuda"] <= 0:
        raise AssertionError("K2 never launched on the scale route")
    idle = [k for k in rows if launches[k] <= 0]
    if idle:
        raise AssertionError(f"never launched on the route phases: {idle}")
    launch1 = launch_us()
    phase_device()
    for tag, (flow, w) in warm.items():
        phase_profile(flow, w, tag)
    del warm
    say("launch", f"host us per PyTorch launch: {launch0:.2f} before any "
                  f"profiler session, {launch1:.2f} after the timings and "
                  f"routes, {launch_us():.2f} after the profiler phases")

    def main_case(name, c):
        if name == "planes_relax_full_cuda":
            return c["cfg"] == "bench" and c.get("tile") is None
        if name == "planes_relax_cropped_cuda":
            return c["cfg"] == "scale" and c.get("tile") == [16, 16]
        return c["cfg"] == "bench" and c["shards"] == 2
    kernels = []
    for name, cases in rows.items():
        m = next(c for c in cases if "ms" in c and main_case(name, c))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m.get("library_ms"),
            cases=cases))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
