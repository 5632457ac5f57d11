"""Chip smoke test of the PyTorch/CUDA port (parallel_eda_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):
  1. card      — nvidia-smi name/power limit and torch's device name
  2. build     — nvcc builds csrc/planes_relax.cu and g++ builds
                 native/serial_sa.cc, both started together, into
                 parallel_eda_tpu_torch/build/
  3. kernels   — each CUDA kernel against its plain PyTorch version on
                 the card at bench and scale shapes (B=64), exact and
                 jittered costs: dist/wenter/pred bit-identical; kernel,
                 plain-version and bound times
  4. bench     — route the 60-LUT/W=12 bench config end to end on the
                 card: legal, wirelength 537 in 22 iterations
  5. scale     — place the 1,200-LUT/W=20 config with the native
                 annealer and route it on the card: legal
  6. launches  — every kernel's launch count over the two route phases
(and, between 4 and 5, a torch.profiler breakdown of a warm bench route)
Then a JSON line of per-kernel numbers and, last, the result line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32
# (non-tensor-core) rate — the min-plus relaxation is f32 add/min work
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
REPLACES = {
    "planes_relax_full_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:308",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
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


def bound_ms(pg, B: int, net_sweeps, tile=None):
    """Least time for one relaxation call: the larger of (flats read and
    written once + the geometry once) / HBM rate and (the sweeps this
    run's data needed x ops per sweep) / f32 rate."""
    W, NX, NYp1 = pg.shape_x
    nc = pg.ncells
    geo = 4 * nc + 4 * (W * NX * NYp1 + 3 * (nc - W * NX * NYp1))
    nbytes = 3 * 4 * B * nc + 4 * B + 12 * B * nc + 8 * B + geo
    X, Y = (NX, NYp1 - 1) if tile is None else tile
    ops = int(net_sweeps.sum()) * sweep_ops(W, X, Y)
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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

    t0 = time.time()
    os.makedirs(pk.BUILD_DIR, exist_ok=True)
    gxx = subprocess.Popen(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         serial_sa._SRC, "-o", serial_sa._SO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    nv = pk.start_build()
    info = pk.finish_build(nv)
    out, _ = gxx.communicate()
    if gxx.returncode != 0:
        raise RuntimeError(f"g++ serial_sa.cc failed:\n{out}")
    say("build", f"nvcc planes_relax.cu {info['seconds']:.1f}s, both "
                 f"sources {time.time() - t0:.1f}s; "
                 + " | ".join(info["ptxas"]))


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
                case["bound_ms"], case["bound_by"] = bound_ms(pg, B, net_st[:, 0])
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
                    case["bound_ms"], case["bound_by"] = bound_ms(
                        pg, B, net_st[:, 0], tile=(cnx, cny))
                rows.setdefault("planes_relax_cropped_cuda",
                                []).append(case)
                say("kernels", f"K2 cropped {cfg} {kind} {cnx}x{cny}: "
                               "bit-identical, " + json.dumps(case))
    return rows


def _route(tag, flow, opts):
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router

    router = Router(flow.rr, opts, device="cuda")
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = router.route(flow.term)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = pk.launch_counts()
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
    return res, counts, dt


def phase_profile(flow):
    """Where a warm bench route's time goes on the card: a second route
    on the same Router is timed untraced, a third is traced with
    torch.profiler (device activity only) for device time by kernel and
    the relaxation kernels' share; the busy share is device time over
    the untraced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    router = Router(flow.rr, RouterOpts(batch_size=64), device="cuda")
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
    relax = sum(k[0] for k in kern if "planes_relax" in k[2])
    top = "; ".join(f"{k[2][:60]} {k[0] / 1e3:.1f}ms x{k[1]}"
                    for k in kern[:6])
    say("profile", f"bench route traced {wall_us / 1e6:.2f}s wall "
                   f"(untraced {route_s:.2f}s), device busy "
                   f"{busy / 1e3:.1f}ms ({busy / 1e6 / route_s:.3f} of the "
                   f"untraced wall), relaxation kernels {relax / 1e3:.1f}ms "
                   f"({relax / busy:.3f} of device time), "
                   f"{sum(k[1] for k in kern)} kernel launches; top: {top}")


def main() -> int:
    smi = phase_card()
    import torch

    from parallel_eda_tpu_torch.flow import run_place_native, synth_flow
    from parallel_eda_tpu_torch.route.router import RouterOpts

    phase_build()
    t0 = time.time()
    bench = synth_flow(num_luts=60, num_inputs=12, num_outputs=12,
                       chan_width=12, seed=11)
    scale = synth_flow(num_luts=1200, num_inputs=12, num_outputs=12,
                       chan_width=20, seed=11)
    say("flows", f"front ends built in {time.time() - t0:.1f}s")
    rows = phase_kernels({"bench": bench, "scale": scale})

    res, c_bench, _ = _route("bench", bench, RouterOpts(batch_size=64))
    if (res.wirelength, res.iterations) != (537, 22):
        raise AssertionError(f"bench: expected wirelength 537 in 22 "
                             f"iterations, got {res.wirelength} in "
                             f"{res.iterations}")
    phase_profile(bench)
    t0 = time.time()
    scale = run_place_native(scale)
    say("scale", f"placed {scale.pnl.num_blocks} blocks in "
                 f"{time.time() - t0:.1f}s (native SA)")
    _, c_scale, _ = _route("scale", scale, RouterOpts(batch_size=64))

    launches = {k: c_bench[k] + c_scale[k] for k in c_bench}
    say("launches", f"bench {c_bench} scale {c_scale}")
    if c_bench["planes_relax_full_cuda"] <= 0:
        raise AssertionError("K1 never launched on the bench route")
    if c_scale["planes_relax_cropped_cuda"] <= 0:
        raise AssertionError("K2 never launched on the scale route")

    main_case = {"planes_relax_full_cuda": ("bench", None),
                 "planes_relax_cropped_cuda": ("scale", [16, 16])}
    kernels = []
    for name, cases in rows.items():
        cfg, tile = main_case[name]
        m = next(c for c in cases if c["cfg"] == cfg and "ms" in c
                 and c.get("tile") == tile)
        kernels.append(dict(
            name=name, route="cuda",
            source="parallel_eda_tpu_torch/csrc/planes_relax.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, cases=cases))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
