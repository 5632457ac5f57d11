"""Chip smoke test of the PyTorch/CUDA port (parallel_eda_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):
  1. card      — nvidia-smi name/power limit and torch's device name
  2. build     — nvcc builds csrc/planes_relax.cu and csrc/slab_permute.cu
                 and g++ builds native/serial_sa.cc, all started together,
                 into parallel_eda_tpu_torch/build/
  3. kernels   — each relaxation kernel against its plain PyTorch version
                 on the card at bench and scale shapes (B=64), exact and
                 jittered costs: dist/wenter/pred bit-identical; kernel,
                 plain-version and bound times
  4. halo      — the halo-shift kernel (K3) against its plain version at
                 the bench slab shapes, 2-4 shards, both directions:
                 bit-identical; kernel, plain, copy_ and bound times
  5. step      — the one-sweep step entry against one plain sweep on the
                 shards' bench blocks, pred carried in: bit-identical
  6. sharded   — the row-sharded relaxation on the card (both schedules,
                 2 and 4 shards) against single-device K1 (dist/wenter)
                 and against its own CPU run (every output and stats)
  7. bench     — route the 60-LUT/W=12 bench config end to end on the
                 card: legal, wirelength 537 in 22 iterations
  8. mesh      — the bench route at mesh_shards=2 and 4: legal, 537 / 22,
                 paths and occupancy equal to phase 7's, under the
                 Router's lag-1 schedule and, timed beside it, lag 2
  9. scale     — place the 1,200-LUT/W=20 config with the native
                 annealer and route it on the card, single-device and
                 at mesh_shards=4: legal
 10. launches  — every kernel's launch count over the route phases
(and, after 7 and after 8, a torch.profiler breakdown of a warm bench
route and of a warm mesh_shards=2 bench route)
Then a JSON line of per-kernel numbers and, last, the result line.
It imports nothing of JAX and nothing of the JAX package.

The shards of phases 4, 6 and 8 are placed round-robin over the visible
cards, so on a machine with several cards their halos cross NVLink.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32
# (non-tensor-core) rate — the min-plus relaxation is f32 add/min work —
# and NVLink 4 to another card, one way
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
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
    "remote_slab_permute_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:597",
}
SOURCES = {
    "planes_relax_full_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_sweep_block_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "remote_slab_permute_cuda":
        "parallel_eda_tpu_torch/csrc/slab_permute.cu",
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` warmed calls: CUDA events
    on one card; with several cards visible, the host clock between
    synchronisations of every card (the work spans their streams)."""
    import torch

    fn()
    n = torch.cuda.device_count()
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


def scan_combines(n: int) -> int:
    """Combines of lax.associative_scan's tree over a length-n line."""
    if n < 2:
        return 0
    return n // 2 + (n + 1) // 2 - 1 + scan_combines(n // 2)


def sweep_ops(W: int, X: int, Y: int) -> int:
    """f32 operations of one sweep of one net on an (X, Y) canvas: four
    line scans (3 ops per combine, 3 per cell for cost/compare) and two
    turn stencils (12 candidates x 5 ops + 1 compare per target)."""
    ncx, ncy = W * X * (Y + 1), W * (X + 1) * Y
    scans = (2 * W * (Y + 1) * (3 * scan_combines(X) + 3 * X)
             + 2 * W * (X + 1) * (3 * scan_combines(Y) + 3 * Y))
    return scans + 61 * (ncx + ncy)


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
    run's data needed x ops per sweep) / f32 rate."""
    W, NX, NYp1 = pg.shape_x
    nc = pg.ncells
    geo = 4 * nc + 4 * (W * NX * NYp1 + 3 * (nc - W * NX * NYp1))
    nbytes = 3 * 4 * B * nc + 4 * B + 12 * B * nc + 8 * B + geo
    X, Y = (NX, NYp1 - 1) if tile is None else tile
    return bounds(nbytes, int(net_sweeps.sum()) * sweep_ops(W, X, Y))


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
            net_st = pk.planes_relax_full_cuda.last_net_stats.cpu().numpy()
            ref = P.planes_relax_plain(pg, *inst[:3], inst[3], nsw)
            err = _compare(f"K1 {cfg} {kind}", got, ref)
            case = dict(cfg=cfg, costs=kind, shape=[W, NX, NY], B=B,
                        sweeps=int(got[3][0]), max_abs_err=err)
            if kind == "jitter":
                case["ms"] = cuda_ms(lambda: P.planes_relax(
                    pg, *inst[:3], inst[3], nsw), 20)
                case["plain_ms"] = cuda_ms(lambda: P.planes_relax_plain(
                    pg, *inst[:3], inst[3], nsw), 2)
                case.update(bound_ms(pg, B, net_st[:, 0]))
            rows.setdefault("planes_relax_full_cuda", []).append(case)
            say("kernels", f"K1 full {cfg} {kind}: bit-identical, "
                           + json.dumps(case))
            # --- K2: cropped tiles ---
            for (cnx, cny) in tiles:
                ox = torch.from_numpy(rng.integers(
                    0, NX - cnx + 1, B).astype(np.int32)).cuda()
                oy = torch.from_numpy(rng.integers(
                    0, NY - cny + 1, B).astype(np.int32)).cuda()
                args = (pg, *inst[:3], inst[3], nsw, ox, oy, cnx, cny)
                got = P.planes_relax_cropped(*args)
                net_st = (pk.planes_relax_cropped_cuda.last_net_stats
                          .cpu().numpy())
                ref = P.planes_relax_cropped_plain(*args)
                err = _compare(f"K2 {cfg} {kind} {cnx}x{cny}", got, ref)
                case = dict(cfg=cfg, costs=kind, tile=[cnx, cny], B=B,
                            sweeps=int(got[3][0]), max_abs_err=err)
                if kind == "jitter":
                    case["ms"] = cuda_ms(
                        lambda: P.planes_relax_cropped(*args), 20)
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


def phase_halo(pg):
    """K3 against its plain version at the bench route's slab shapes:
    per s, the four shifts of one exchange round (dx right/left 1
    column, dy right 1 / left 2 columns) from strided views of random
    block canvases, shard i on card i mod (visible cards).  Times are
    per call, averaged over the four; the library call is dst.copy_(src)
    per receiver plus zero_() at the edge (several PyTorch calls: no
    single one shifts a list of tensors).  The bound is the bytes read
    and written over HBM or, across cards, one slab over one NVLink."""
    import torch

    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.planes_shard import row_block_cols

    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    B = 64
    rng = np.random.default_rng(1)
    rows = []
    ncard = torch.cuda.device_count()

    def canvas(shape, i):
        a = rng.uniform(0, 1e-9, shape).astype(np.float32)
        a[rng.random(shape) < 0.3] = np.inf
        return torch.from_numpy(a).to(f"cuda:{i % ncard}")

    for s in (2, 3, 4):
        kx = row_block_cols(pg, s)
        cx = [canvas((B, W, kx + 2, NYp1), i) for i in range(s)]
        cy = [canvas((B, W, kx + 3, NY), i) for i in range(s)]
        calls = [([c[:, :, kx:kx + 1] for c in cx], True),
                 ([c[:, :, 1:2] for c in cx], False),
                 ([c[:, :, kx:kx + 1] for c in cy], True),
                 ([c[:, :, 1:3] for c in cy], False)]
        err = 0.0
        for slabs, fwd in calls:
            got = sk.remote_slab_permute_cuda(slabs, fwd)
            torch.cuda.synchronize()
            ref = sk.slab_permute_plain(slabs, fwd)
            err = max(err, _same(f"K3 s={s} fwd={fwd}", got, ref))
        dsts = [[torch.empty((B, W) + tuple(sl[0].shape[2:]),
                             device=sl[r].device) for r in range(s)]
                for sl, _ in calls]

        def library():
            for (slabs, fwd), dst in zip(calls, dsts):
                for r in range(s):
                    snd = r - 1 if fwd else r + 1
                    if 0 <= snd < s:
                        dst[r].copy_(slabs[snd])
                    else:
                        dst[r].zero_()

        cards = min(s, ncard)
        moved = sum((2 * s - 1) * sl[0].numel() * 4 for sl, _ in calls) / 4
        slab = sum(sl[0].numel() * 4 for sl, _ in calls) / 4
        bound = max(moved / PEAK_BYTES_S,
                    slab / PEAK_NVLINK_BYTES_S if cards > 1 else 0.0)
        case = dict(
            shards=s, B=B, slabs=[list(sl[0].shape) for sl, _ in calls],
            max_abs_err=err,
            ms=cuda_ms(lambda: [sk.remote_slab_permute_cuda(sl, f)
                                for sl, f in calls], 200) / 4,
            plain_ms=cuda_ms(lambda: [sk.slab_permute_plain(sl, f)
                                      for sl, f in calls], 50) / 4,
            library_ms=cuda_ms(library, 200) / 4,
            bound_ms=bound * 1e3, bound_by="bytes", cards=cards)
        rows.append(case)
        say("halo", "K3 bit-identical, " + json.dumps(case))
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
    once (bytes); or one sweep of every net (f32 operations)."""
    cells = W * X * (Y + 1) + W * (X + 1) * Y
    geo = sum(getattr(gm, k).numel() * getattr(gm, k).element_size()
              for k in ("brk_before_x", "brk_after_x", "brk_before_y",
                        "brk_after_y", "first_x", "last_x", "first_y",
                        "last_y", "delay_x", "delay_y", "delay_y_rot0",
                        "delay_y_rot1", "idxx", "idxy", "base_par"))
    nbytes = B * cells * 4 * (4 + 3) + 4 * B + 8 * B + geo
    return bounds(nbytes, B * sweep_ops(W, X, Y))


def phase_step(rr, pg):
    """The step entry against one plain sweep on each shard's bench
    block (B=64), pred carried in, exact and jittered costs; the
    kernel's owned-changed flags against the plain sweep's."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    rng = np.random.default_rng(2)
    W, NX, NYp1 = pg.shape_x
    B = 64
    rows = []
    for s in (2, 4):
        for kind in ("exact", "jitter"):
            inst = _instance(rr, pg, B, rng, kind == "exact")
            blocks, kx = _blocks(pg, inst, s, ["cuda"] * s)
            own = slice(1, kx + 1)
            err = 0.0
            for k, (g, st, crit, ccx, ccy, costs) in enumerate(blocks):
                got, stats = pk.planes_sweep_block_cuda(g, st, crit, ccx,
                                                        ccy, (1, kx + 1))
                torch.cuda.synchronize()
                ref = P._sweep_once(g, st, crit, ccx, ccy, costs)
                err = max(err, _same(f"step s={s} {kind} shard {k}", got,
                                     ref))
                flag = ((ref[0][:, :, own] < st[0][:, :, own]
                         ).flatten(1).any(1)
                        | (ref[1][:, :, own] < st[1][:, :, own]
                           ).flatten(1).any(1))
                if not torch.equal(stats[:, 1].bool(), flag):
                    raise AssertionError(f"step s={s} {kind}: owned-"
                                         "changed flags differ")
            case = dict(shards=s, costs=kind, B=B,
                        block=[W, kx + 2, NYp1 - 1], max_abs_err=err)
            if kind == "jitter":
                g, st, crit, ccx, ccy, costs = blocks[0]
                case["ms"] = cuda_ms(lambda: pk.planes_sweep_block_cuda(
                    g, st, crit, ccx, ccy, (1, kx + 1)), 50)
                case["plain_ms"] = cuda_ms(lambda: P._sweep_once(
                    g, st, crit, ccx, ccy, costs), 10)
                case.update(step_bound_ms(B, W, kx + 2, NYp1 - 1, g))
            rows.append(case)
            say("step", "bit-identical, " + json.dumps(case))
    return rows


def phase_sharded(rr, pg):
    """planes_relax_sharded on the card against single-device K1 (dist
    and wenter bit-identical on power-of-two costs, finite masks equal)
    and against the same call on CPU tensors (everything equal)."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_shard as TS

    rng = np.random.default_rng(3)
    pg_cpu = P.build_planes(rr, "cpu")
    inst = _instance(rr, pg, 64, rng, True)
    k1 = P.planes_relax(pg, *inst, 32)
    for impl in TS.MESH_IMPLS:
        for s in (2, 4):
            rm = TS.make_row_mesh(s, impl, "cuda")
            torch.cuda.synchronize()
            t0 = time.time()
            got = TS.planes_relax_sharded(pg, *inst, 32, rm)
            torch.cuda.synchronize()
            dt = time.time() - t0
            for k, n in ((0, "dist"), (2, "wenter")):
                if not torch.equal(got[k], k1[k]):
                    raise AssertionError(f"sharded {impl} s={s}: {n} "
                                         "differs from K1")
            ref = TS.planes_relax_sharded(
                pg_cpu, *(t.cpu() for t in inst), 32,
                TS.make_row_mesh(s, impl, "cpu"))
            _same(f"sharded {impl} s={s} vs CPU", got, ref)
            say("sharded", f"{impl} s={s} on {rm.n_cards} card(s): "
                           "dist/wenter = K1, all = CPU; "
                           f"sweeps {got[3].tolist()} (K1 "
                           f"{k1[3].tolist()}), {dt * 1e3:.1f} ms")


def _route(tag, flow, opts, impl=None):
    """Route ``flow`` on the card, legal or raise; with ``impl``, under
    that exchange schedule instead of the Router's own."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.planes_shard import make_row_mesh
    from parallel_eda_tpu_torch.route.router import Router

    router = Router(flow.rr, opts, device="cuda")
    if impl is not None:
        router.row_mesh = make_row_mesh(opts.mesh_shards, impl, "cuda")
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
        if counts["planes_sweep_block_cuda"] <= 0 \
                or counts["remote_slab_permute_cuda"] <= 0:
            raise AssertionError(f"{tag}: the sharded route did not run "
                                 "the step and halo kernels")
        if counts["planes_relax_full_cuda"] or \
                counts["planes_relax_cropped_cuda"]:
            raise AssertionError(f"{tag}: a single-device relaxation ran "
                                 "under the mesh")
    return res, counts, dt


def phase_profile(flow, opts, tag):
    """Where a warm route's time goes on the card: a second route on the
    same Router is timed untraced, a third is traced with torch.profiler
    (device activity only) for device time by kernel, the hand-written
    kernels' device time per launch and their share; the busy share is
    device time over the untraced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    router = Router(flow.rr, opts, device="cuda")
    router.route(flow.term)
    torch.cuda.synchronize()
    t0 = time.time()
    router.route(flow.term)
    torch.cuda.synchronize()
    route_s = time.time() - t0
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
    say("profile", f"{tag} route traced {wall_us / 1e6:.2f}s wall "
                   f"(untraced {route_s:.2f}s), device busy "
                   f"{busy / 1e3:.1f}ms ({busy / 1e6 / route_s:.3f} of the "
                   f"untraced wall), hand-written kernels "
                   f"{hand_us / 1e3:.1f}ms ({hand_us / busy:.3f} of device "
                   f"time: {own}), {sum(k[1] for k in kern)} kernel "
                   f"launches; top: {top}")


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
    t0 = time.time()
    bench = synth_flow(num_luts=60, num_inputs=12, num_outputs=12,
                       chan_width=12, seed=11)
    scale = synth_flow(num_luts=1200, num_inputs=12, num_outputs=12,
                       chan_width=20, seed=11)
    say("flows", f"front ends built in {time.time() - t0:.1f}s")
    rows = phase_kernels({"bench": bench, "scale": scale})
    pg_bench = P.build_planes(bench.rr, "cuda")
    rows["remote_slab_permute_cuda"] = phase_halo(pg_bench)
    rows["planes_sweep_block_cuda"] = phase_step(bench.rr, pg_bench)
    phase_sharded(bench.rr, pg_bench)

    res, c_bench, _ = _route("bench", bench, RouterOpts(batch_size=64))
    if (res.wirelength, res.iterations) != (537, 22):
        raise AssertionError(f"bench: expected wirelength 537 in 22 "
                             f"iterations, got {res.wirelength} in "
                             f"{res.iterations}")
    phase_profile(bench, RouterOpts(batch_size=64), "bench")
    c_mesh = []
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
        say(f"mesh{s}", "paths and occupancy equal to the single-device "
                        "bench route under both schedules; route s "
                        f"lag 1 {secs['ppermute']}, lag 2 "
                        f"{secs['pallas_halo']}; sweeps executed (useful) "
                        f"lag 1 {sweeps['ppermute']}, lag 2 "
                        f"{sweeps['pallas_halo']}")
    phase_profile(bench, RouterOpts(batch_size=64, mesh_shards=2), "mesh2")
    t0 = time.time()
    scale = run_place_native(scale)
    say("scale", f"placed {scale.pnl.num_blocks} blocks in "
                 f"{time.time() - t0:.1f}s (native SA)")
    _, c_scale, _ = _route("scale", scale, RouterOpts(batch_size=64))
    _, c, _ = _route("scale_mesh4", scale,
                     RouterOpts(batch_size=64, mesh_shards=4))
    c_mesh.append(c)

    runs = [c_bench, c_scale] + c_mesh
    launches = {k: sum(r[k] for r in runs) for k in c_bench}
    say("launches", f"bench {c_bench} scale {c_scale} mesh (bench 2, "
                    f"bench 4, scale 4) {c_mesh}")
    if c_bench["planes_relax_full_cuda"] <= 0:
        raise AssertionError("K1 never launched on the bench route")
    if c_scale["planes_relax_cropped_cuda"] <= 0:
        raise AssertionError("K2 never launched on the scale route")

    def main_case(name, c):
        if name == "planes_relax_full_cuda":
            return c["cfg"] == "bench" and c.get("tile") is None
        if name == "planes_relax_cropped_cuda":
            return c["cfg"] == "scale" and c.get("tile") == [16, 16]
        return c["shards"] == 2
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
