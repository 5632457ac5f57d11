"""Chip smoke test of the PyTorch/CUDA port (parallel_eda_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):
  1. card      — nvidia-smi name/power limit and torch's device name
  2. build     — nvcc builds csrc/planes_relax.cu and csrc/slab_permute.cu
                 and g++ builds native/serial_sa.cc and
                 native/serial_route.cc, all started together, into
                 parallel_eda_tpu_torch/build/
  3. kernels   — each relaxation kernel against its plain PyTorch version
                 on the card at bench and scale shapes (B=64), exact,
                 jittered and crit > 0 costs, K2 with tile origins that
                 wrap and clamp, in every shared-memory mode that fits:
                 dist/wenter/pred/stats bit-identical; kernel,
                 plain-version and bound times.  Phases 3-6 also hold
                 each kernel's bf16 plane mode (plane_dtype="bf16":
                 dist and wenter carried in bfloat16 between f32 sweeps)
                 against its plain version, at crit 0 and crit > 0,
                 timed beside the f32 mode on the same input
  4. halo      — the halo kernel (K3), the TPU kernel's contract: its
                 one-hop shifts (remote_slab_permute, the kernel on CUDA
                 slabs) against the plain version at the bench blocks
                 (2-4 shards) and the scale block (4 shards):
                 bit-identical; its launches through that entry point
                 (the route's sharded relaxation moves its halos inside
                 its own launch); times per exchange round beside the
                 library copy_/zero_ loop and the bound
  5. peer      — the peer kernel (one cooperative launch per card runs
                 the whole sharded relaxation: halos stored into the
                 neighbours' mailboxes, the fixpoint decided on the
                 card) through planes_relax_sharded, lag 1 (the
                 ladder's per-sweep mesh) and lag 2, on the shards'
                 bench (2-4 shards) and scale (4) shapes: one launch per
                 relaxation, bit-identical in every shared-memory mode
                 to the plain loop and under lag 1 to the cluster
                 kernel, f32 and bf16; timed beside the cluster kernel
  6. sharded   — the row-sharded relaxation on the card (both schedules,
                 2 and 4 shards) against single-device K1 (dist/wenter)
                 and against its own CPU run (every output and stats);
                 its one-card lag-1 form, the cluster kernel (one launch
                 per relaxation), beside the peer kernel (lag 1 and 2)
                 and the plain per-sweep loop on the card, at the bench
                 (2, 3, 4 shards) and scale (4) shapes, every mode:
                 bit-identical, all timed
  7. bench     — route the 60-LUT/W=12 bench config end to end on the
                 card: legal, wirelength 537 in 22 iterations
  8. mesh      — the bench route at mesh_shards=2 and 4: legal, 537 / 22,
                 paths and occupancy equal to phase 7's, under the
                 Router's lag-1 schedule (on one card the cluster kernel,
                 across cards the peer kernel) and, timed beside it, lag
                 2 (the peer kernel), each relaxation one launch per
                 card
  8b. netmesh  — the (net, node) mesh's net axis (Router(mesh=...),
                 parallel/shard.py: each step's nets split into one
                 chunk per member, each routed on its member's card, the
                 occupancy deltas summed on the home card) on one card,
                 members repeating cuda:0: the bench at net axis 2 and 4
                 = phase 7's route (537 / 22; paths, occupancy, stats
                 rows, sweeps); flow.run_route timing-driven at net 2 =
                 the one-card run_route (522 / 22, the same crit path);
                 the ELL program at net 2 = its one-card route; every
                 planes relaxation K1 on a member's card at the
                 per-member batch, as many on each member; each route's
                 seconds, K1 launches per member and blocking syncs; K1
                 alone at those batches (bench 30 and 15, scale 16)
                 against its plain version, timed (on the kernels line)
  8c. nodemesh — the (net, node) mesh's node axis on one card, members
                 repeating cuda:0 (route/nodesplit.py: each net's
                 canvases split by columns over its node row, the
                 x-scans across the members in lax.associative_scan's
                 grouping): the node kernel against its plain version
                 and K1 at the bench (60 nets) and scale (64) shapes at
                 2 and 4 members, f32 and bf16, crit 0 and > 0, every
                 shared-memory mode, and 6x72 at 4 members:
                 bit-identical, timed beside K1 and the plain version
                 (on the kernels line); the bench at (1, 2), (1, 4) and
                 (2, 2) = the one-card crop="off" route (537 / 22;
                 paths, occupancy, stats rows, sweeps), bf16 at (1, 2) =
                 its one-card route, flow.run_route timing-driven at
                 (1, 2) = the one-card run_route (522 / 22, crit path
                 4.552000110180643e-09 s), the ELL program at (1, 2) =
                 its one-card route (624 / 9); every planes relaxation
                 one node-kernel launch on its row's card at the per-row
                 batch; each route's seconds beside the one-card route's
  9. scale     — place the 1,200-LUT/W=20 config with the native
                 annealer and route it on the card, single-device and
                 at mesh_shards=4: legal
 9b. bf16      — the bf16 plane mode through the Router: the bench at
                 dtype_guard="off" (wirelength 520 in 16 iterations) and
                 at the default guard "window" (537 / 22, the f32 route,
                 with its bf16 shadow windows counted), the bench at
                 mesh_shards=2 on one card (the cluster kernel) and
                 under lag 2 (the peer kernel) at "off", the scale route at "off" (legal) and
                 the bench timing-driven route at "off" (each bench route
                 as the port's CPU route gives it);
                 bench and scale route seconds at f32, "off" and
                 "window", taken in turns
 10. timing    — the timing-driven route (the STA between iterations
                 inside each window): flow.run_route on the bench
                 (wirelength 522 in 22 iterations, crit path
                 4.552000110180643e-09 s) and on the placed scale config
                 (legal), Router.route(analyzer=...) on the bench at
                 mesh_shards=2 on one card (the cluster kernel; paths
                 equal), route(timing_cb=...) and route(crit=0.99) on the
                 15-LUT fixture; K1, K2 and the cluster kernel against
                 their plain versions on relaxation inputs captured from
                 these routes at crit > 0
 10b. place    — the device annealer through flow.run_place: the bench
                 wirelength-only (PlacerOpts(seed=3)) on the card equal
                 to the port's CPU placement, moves/s of a warm anneal
                 beside the native serial annealer's; the bench
                 timing-driven at the default PlacerOpts on the card
                 equal to the CPU's (temperature rows, est crit path;
                 else the first different row is named); a fresh 1,200-LUT
                 config timing-driven at the default PlacerOpts (the
                 delay lookup's sample route launches K1), legal, then
                 routed timing-driven (legal) beside the native-placed
                 scale route; PyTorch launches per annealing step and
                 the device's busy share of a segment (after the
                 profiler-free timings)
 11. launches  — every kernel's launch count over the route phases
                 (the lag-2 mesh routes and the place phase included;
                 with several cards also a mesh-2 route with both shards
                 on card 0, the one-card path); K3 is off the route's
                 path (0 there, exempt from the never-launched gate) and
                 its phase-4 calls are reported as harness_launches
 12. device    — the kernels' device time per launch (torch.profiler)
                 for the cases phases 3-6 timed, and that K2's, the
                 cluster kernel's and the peer kernel's wrappers launch
                 one kernel per call (one card)
 13. profile   — a torch.profiler breakdown of a warm bench route, a
                 warm mesh_shards=2 bench route, a warm scale route and
                 warm timing-driven bench and scale routes (their
                 untraced seconds taken in phases 7-10)
 14. sta       — the STA's kernel launches and device time per call
                 (torch.profiler) and per timing route
 15. cli       — the CLI, ``python -m parallel_eda_tpu_torch``, as
                 subprocesses on the card (each through a launcher that
                 runs the module as ``python -m`` does and writes the
                 kernels' launch counts and the peak device memory when
                 it exits): a tseng-class BLIF (array_multiplier(16):
                 736 LUTs, 64 FFs, 833 nets) on the default k6_n10 arch
                 at W=40, timing-driven place (256 moves per step) and
                 route, --power, --gen_postsynthesis_netlist; the same
                 BLIF on the golden VTR7 XML arch (length-4 unidir
                 segments, the file's own timing; at W=96, the file's
                 W=24 being too narrow for it and W_min 85) and on an XML
                 arch whose cluster has modes (frac_arch's pb tree:
                 multi-mode packing, W=32); the .place resume of
                 the first run (the same .route bytes); --binary_search
                 --no_timing at the bench size (W_min legal, W_min - 1
                 fails); the 25-LUT flow with --stats_dir on the card
                 and with --device cpu (the same artifacts, stats rows
                 and mdclog records, seconds and clocks aside, one row
                 per iteration); the first run once more with --sync
                 (the synchronous window driver): the same .route
                 bytes; each run legal with K1 launched, its
                 stage seconds and peak memory printed (the runs go
                 four at a time, so their seconds are taken beside
                 each other's).  Before them, K1
                 and K2 at the first run's shapes (its rr graph, the
                 crop tiles its grid gives) against their plain
                 versions in every shared-memory mode that fits
 16. elastic   — the route driver's pipeline and elastic surface: the
                 placed scale config routed in turns synchronously
                 (pipeline=False) and pipelined (the default every other
                 phase runs), paths, occupancy, wirelength, iterations,
                 stats rows (seconds aside), sweeps and congestion
                 records equal, each route's seconds and route.pipeline.*
                 figures printed; the scale route with slice_iterations=5
                 resumed slice by slice until it succeeds, bit-identical
                 to the unsliced route (slices, checkpoint bytes, the
                 host ms taking and re-uploading a checkpoint); the bench
                 route's checkpoint of a slice's yield at iteration 4
                 resumed across mesh layouts on one card (1 -> 2 and 4,
                 2 -> 1, 4 -> 1; the cluster kernel at 2 and 4): 537 /
                 22 with paths equal; the scale route's last checkpoint
                 under checkpoint_every=1 (the finishing pass's) resumed
                 with no budget left: legal
 17. ell       — the ELL program (RouterOpts(program="ell"): the
                 gather-based Bellman-Ford search, plain PyTorch on the
                 card, no hand-written kernel): the bench routed windowed
                 (the default) and global (windowed=False) on the card
                 and on the CPU, legal, paths, occupancy, sink delays,
                 stats rows (relax steps per iteration), windowed and
                 widened nets equal, and wirelength / iterations equal
                 to the JAX package's (624 / 9 and 614 / 11); the bench
                 timing-driven through flow.run_route (the analyzer as
                 the per-iteration timing_cb) on the card equal to the
                 CPU route, crit path included; a native-placed 300-LUT
                 config (W=16) whose window tables fit, most nets
                 windowed, on the card equal to the CPU route; the
                 native-placed scale config routed windowed once on the
                 card (its tables pass window_max_bytes): legal, its
                 seconds, iterations, wirelength, windowed / widened
                 nets and relax steps beside the card's name and power
                 limit; its PyTorch launches per route and device busy
                 share from one profiled warm route in phase 13
 18. fused     — the fused window dispatch (RouterOpts.fused_dispatch:
                 each window's crop ladder as one
                 route_window_planes_fused call, issued through
                 Router.route_gen) on the card: the bench fused = the
                 per-rung bench route (phase 7) = the bench fused on the
                 CPU (537 / 22), the route.kernel.fused_rungs and
                 dispatches_per_window gauges per window; fused =
                 per-rung with equal launch counts at bf16 "off" (520 /
                 16), at mesh_shards=2 (the cluster kernel) and
                 timing-driven through flow.run_route (522 / 22, the
                 same crit path); the placed scale config fused =
                 per-rung path for path with equal launches, warm route
                 seconds of both taken in turns, and (after the
                 profiler-free timings) the K1/K2 launches of the scale
                 route's first window in each mode by torch.profiler,
                 equal; two jobs on the
                 bench rr graph (its terminals and an initial placement
                 from seed 5) driven in lockstep by serve/fused.py's
                 FusedSliceRunner through route_window_planes_multi,
                 each equal to its solo fused route
 19. resil     — resilience, devprof and the route service on the card:
                 the bench guarded (RouterOpts.resil) without faults =
                 the unguarded route with the same launches; the kernel
                 ladder forced down (two injected errors quarantine jit
                 -> pallas_g1, mode <= 1; four -> xla, mode 0), each
                 route = the bench route, launches per shared-memory
                 mode counted, six errors on one dispatch poisoned, no
                 plain version on a CUDA tensor; kernel_layout's modelled
                 mode = each K1/K2 case's auto mode; a stats_dir bench
                 route's devprof.json (CUDA-event ms and launches per
                 kernel, as many events as launches) beside phase 3's K1
                 time; a RouteService with four bench-graph jobs (the
                 bench terminals and three seeded placements) on two
                 tenants sliced every 5 iterations, each = its solo card
                 route, then under a five-site plan (dispatch.error,
                 dispatch.hang, checkpoint.corrupt, corpus.torn,
                 backend.loss) the same, every failure the guard absorbed
                 one the plan fired; one bench job at mesh_shards=2 whose
                 member is lost, demoted to single_chip, = the bench
                 route; the placed scale config through the service under
                 dispatch errors and a torn checkpoint = the scale route
                 path for path; and ``python -m parallel_eda_tpu_torch
                 serve`` as subprocesses with and without --chaos: rc 0,
                 the same jobs done
 20. serve     — continuous batching, the program library and the route
                 daemon on the card: the resil phase's four jobs
                 through RouteService(fused=True), each = its solo card
                 route, multi calls of width >= 2 and the K1 launches
                 inside them, fused and interleaved service seconds in
                 turns, and under a dispatch.error at the merged site
                 (the per-job fallback from restored window entries)
                 the same four routes; ``serve --fused`` processes with
                 --library and --compile_cache_dir: an exporting one, a
                 fresh one that starts no nvcc, builds nothing and
                 counts no new dispatch variant, and one over a library
                 whose entry and libplanes_relax copy were truncated
                 (both evicted before load, rebuilt from source; a
                 copy of the library), each
                 with the same jobs, its wall and build seconds; ``daemon
                 run`` (two 6-LUT jobs, slice 2) uninterrupted, then
                 killed -9 after its first durable checkpoint and
                 restarted: the same job states and wirelengths,
                 route.daemon.recovered > 0, the heartbeat's max_gap
                 cold (a fresh compile cache) and warm.  The two cold
                 processes (the export and the uninterrupted daemon)
                 start, at nice 10, before phase 19 and build beside it
 21. qor       — the serial QoR oracle: route.qor_compare on the bench
                 (the device route, timing-driven, on the card; the
                 serial oracle's passes on the host through
                 native/serial_route.cc) = the port's CPU row (crit path
                 and wirelength of both, iterations), K1 launched; the
                 native serial router = route/serial_ref.py's
                 SerialRouter tree for tree on the bench problem, with
                 and without criticalities, both timed
 22. fleet     — ``daemon fleet --workers 2 --device cuda`` over the
                 serve phase's daemon library with a fresh --cache_base
                 (each worker its own CUDA context on the one card): four
                 6-LUT jobs (slice 2) submitted through the
                 TransportClient to transport.json's URL under
                 transport.drop:1,worker.kill:1, --expect_jobs 4,
                 --trace, --summary; beside it a solo card ``daemon
                 run`` over the same jobs.  Every job released once and
                 done once with the solo run's wirelength and
                 iterations; one worker killed (only while it holds a
                 live lease on a job with a durable checkpoint), a job
                 failed over; the plan's one drop and one retry;
                 tools/flow_doctor.py --fleet-summary healthy; no nvcc
                 in any worker (no cuda.build or cuda.nvcc span in its
                 trace shard); each worker's max_gap, the lease_stolen
                 sheds and the phase's seconds printed
 23. long_lines — grids with a side past the old 64-cell scan line
                 limit (the kernels take lines up to
                 planes_kernels.MAX_LINE): K1 on 6x63 (the thin canvas
                 whose scan scratch once overflowed), 6x72, 72x6, 66x66
                 (mode 0), K2 on 8x128 tiles of 10x160, the cluster and
                 the peer kernel (2 and 4 shards, lag 1 and 2) on 6x72,
                 f32 at crit 0 and bf16 at crit > 0,
                 against their plain versions in every mode that fits
                 (bit-identical, on the kernels line, the jittered f32
                 cases timed); the 15-LUT parity netlist routed on 6x72
                 and 72x6 and at mesh_shards=2 on 6x72 (the cluster
                 kernel, and the peer kernel under lag 2), each = the
                 port's CPU route of its grid (from the CPU reference
                 pool; paths, occupancy,
                 wirelength, iterations; stats rows and sweeps too for
                 the single-device routes); and on 66x66: legal,
                 wirelength, iterations, seconds
Then a JSON line of per-kernel numbers and, last, the result line.
It imports nothing of JAX and nothing of the JAX package.

The port's CPU reference routes that phases 17, 18 and 23 hold card
routes against (device="cpu") are made in two spawned workers (one
torch thread each, at the lowest priority), started after phase 6,
beside the route phases (CPU_REFS).

Every route runs the Router's default, the pipelined driver
(RouterOpts.pipeline), so each route phase's bit-identity checks hold
the pipeline too.

Every host-clock timing (ms per call, route seconds) is taken before
the first profiler session: a session can leave the process's later
launches slower on the host (the "launch" line gives the host's cost
per launch before and after).

The shards of phases 4, 6 and 8 are placed round-robin over the visible
cards, so on a machine with several cards their halos cross NVLink;
phase 6 then also holds the peer kernel across the cards against its
one-card form (f32 and bf16, one launch per card, both timed).

    python3 chip_smoke.py --cards

runs only what exists across cards, on a machine with two or more: the
build, phase 4, phase 6, the bench route and its mesh routes of phase 8
(with the mesh-2 route on card 0), the scale route at mesh_shards=4,
and the net mesh across cards: the bench at net axis 2 and 4 over
distinct cards = phase 7's route, and (four cards) the placed scale
config at net axis 4 = its one-card route at crop="off" (paths,
occupancy, stats rows, sweeps), both timed in turns; and the node axis
across cards: the node kernel across the cards = its one-card form =
K1 (scale, f32 and bf16), the bench at (1, 2) on two cards = phase 7's
route, and (four cards) the scale config at (1, 4) and (2, 2) = its
one-card crop="off" route, timed in turns; it ends with the result line
(its ``cards`` key set) and no kernels line, and fails with fewer than
two cards.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import multiprocessing as mp
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np

# H100 SXM peaks: the HBM3 rate and NVLink 4 to another card, one way
# (NVIDIA data sheet); the f32 rate of separate add / multiply / min
# instructions — the kernels are built with -fmad=false, so no FMA
# counts two operations — 132 SMs x 128 f32 lanes x 1.98 GHz boost
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 132 * 128 * 1.98e9
PEAK_NVLINK_BYTES_S = 450e9
BF16 = "[bf16]"         # suffix of a kernel's bf16 plane mode (launch keys)
BENCH_CFG = dict(num_luts=60, num_inputs=12, num_outputs=12, chan_width=12,
                 seed=11)
SCALE_CFG = dict(num_luts=1200, num_inputs=12, num_outputs=12,
                 chan_width=20, seed=11)
REPLACES = {
    "planes_relax_full_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:308",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
    # K3, the one-hop halo shift
    "remote_slab_permute_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:597",
    # the whole sharded relaxation on one card (K2's kernel per shard per
    # sweep, planes_shard.py:369, with remote_slab_permute between)
    "planes_relax_cluster_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
    # the same on every other mesh (across cards, lag 2), one launch per
    # card
    "planes_relax_peer_cuda":
        "parallel_eda_tpu/route/planes_pallas.py:477",
    # the (net, node) mesh's node axis: JAX's planes_relax with the
    # canvases' X axis on the "node" axis (K1's XLA form, split by GSPMD;
    # no pallas_call), one launch per card of a node row
    "planes_relax_node_cuda": "parallel_eda_tpu/route/planes.py:906",
}
SOURCES = {
    "planes_relax_full_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_relax_cropped_cuda":
        "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "remote_slab_permute_cuda": "parallel_eda_tpu_torch/csrc/slab_permute.cu",
    "planes_relax_cluster_cuda":
        "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_relax_peer_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
    "planes_relax_node_cuda": "parallel_eda_tpu_torch/csrc/planes_relax.cu",
}
# the bf16 plane mode of each kernel: the same source and TPU kernel
# (planes_pallas.py takes plane_dtype="bf16" at each of them)
for _k in list(SOURCES):
    REPLACES[_k + BF16] = REPLACES[_k]
    SOURCES[_k + BF16] = SOURCES[_k]


_T0 = time.time()


def say(phase: str, msg: str) -> None:
    """One result line, tagged with its phase and the script's seconds
    so far."""
    print(f"[{phase} {time.time() - _T0:.0f}s] {msg}", flush=True)


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


# whether device_kernels' sums from the raw records equal key_averages'
# (checked on the first session; on a difference every later session
# reads key_averages)
_RAW_EQUAL = [None]


def device_kernels(prof) -> dict:
    """{name: [device µs, launches]} of a finished torch.profiler
    session's device activity (kernels, memsets, copies): the per-name
    sums that key_averages() gives, read from the session's raw records
    without building its event tree, which takes tens of seconds for a
    route's ~10^5 launches.  The first session is read both ways and
    compared."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name

    if _RAW_EQUAL[0] is not False:
        raw = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not (
                    hasattr(e, "is_hidden_event") and e.is_hidden_event()):
                k = raw.setdefault(_rewrite_name(e.name(), True), [0.0, 0])
                k[0] += e.duration_ns() / 1e3
                k[1] += 1
        if _RAW_EQUAL[0]:
            return raw
    avg = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            k = avg.setdefault(e.key, [0.0, 0])
            k[0] += (getattr(e, "self_device_time_total", 0)
                     or getattr(e, "device_time_total", 0))
            k[1] += e.count
    if _RAW_EQUAL[0] is None:
        _RAW_EQUAL[0] = raw.keys() == avg.keys() and all(
            raw[n][1] == avg[n][1]
            and abs(raw[n][0] - avg[n][0]) <= 1e-6 * avg[n][0] + 1e-3
            for n in avg)
        diff = "" if _RAW_EQUAL[0] else f": raw {raw}, key_averages {avg}"
        say("device", "the profiler's raw device records "
                      f"{'equal' if _RAW_EQUAL[0] else 'differ from'} "
                      f"key_averages ({len(avg)} names){diff[:4000]}")
    return avg


def kernels_per_call(fn, reps: int = 5) -> dict:
    """The kernels one call of ``fn`` launches on the card, by name,
    per call (memsets and copies aside), from torch.profiler.  A session
    can drop kernel records (it once counted 3 launches of a kernel in 5
    calls of a wrapper whose counter read 5), so a session whose count
    of some kernel is not a whole number per call is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = {k: n for k, (_, n) in device_kernels(prof).items()
                 if not k.startswith(("Memset", "Memcpy"))}
        if names and all(v % reps == 0 for v in names.values()):
            return {k: v // reps for k, v in names.items()}
        seen.append(names)
    raise AssertionError(f"the profiler gave no whole count per call in "
                         f"{len(seen)} sessions: {seen}")


def profile_call(fn):
    """(kernels launched, device µs) of one call of ``fn`` on the card
    (torch.profiler; memsets and copies counted too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = device_kernels(prof).values()
    n = sum(c for _, c in kern)
    us = sum(u for u, _ in kern)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return n, us


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
        kern = [v for k, v in device_kernels(prof).items() if key in k]
        n = sum(c for _, c in kern)
        if n:
            return sum(u for u, _ in kern) / n
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


def bound_ms(pg, B: int, net_sweeps, tile=None, plane_bytes: int = 4):
    """Least time for one relaxation call: the larger of (flats read and
    written once + the geometry once) / HBM rate and (the sweeps this
    run's data needed x ops per sweep + the scan costs once per net) /
    f32 rate.  ``plane_bytes`` 2 (the bf16 plane mode): d0, cc and
    wenter0 read and dist and wenter written at 2 bytes a cell, pred at
    4, and the rounding's operations added (round_ops)."""
    W, NX, NYp1 = pg.shape_x
    nc = pg.ncells
    geo = 4 * nc + 4 * (W * NX * NYp1 + 3 * (nc - W * NX * NYp1))
    pb = plane_bytes
    nbytes = (3 * pb * B * nc + 4 * B + (2 * pb + 4) * B * nc + 8 * B
              + geo)
    X, Y = (NX, NYp1 - 1) if tile is None else tile
    sweeps = int(net_sweeps.sum())
    ops = sweeps * sweep_ops(W, X, Y, pg.directional) \
        + B * launch_ops(W, X, Y)
    if pb == 2:
        ops += round_ops(W, X, Y, B, sweeps)
    return bounds(nbytes, ops)


def round_ops(W: int, X: int, Y: int, nets: int, sweeps: int) -> int:
    """Operations of the bf16 plane mode's rounding: per cell of a net's
    canvas, its congestion, entry dist and wenter once per launch, and
    its dist once per sweep (a round trip through bfloat16 each)."""
    cells = W * X * (Y + 1) + W * (X + 1) * Y
    return cells * (3 * nets + sweeps)


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
    import threading

    from parallel_eda_tpu_torch.place import serial_sa
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import serial_native
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR

    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    gxx = subprocess.Popen(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
         serial_sa._SRC, "-o", serial_sa._SO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # native/serial_route.cc (the serial QoR oracle's core) through its
    # own binding, beside the other builds
    route_err = []

    def build_route():
        try:
            serial_native._build_lib()
        except subprocess.CalledProcessError as e:
            route_err.append(e.stderr)

    th = threading.Thread(target=build_route)
    th.start()
    libs = (pk.LIB, sk.LIB)
    procs = [lib.start_build() for lib in libs]
    infos = [lib.finish_build(p) for lib, p in zip(libs, procs)]
    out, _ = gxx.communicate()
    if gxx.returncode != 0:
        raise RuntimeError(f"g++ serial_sa.cc failed:\n{out}")
    th.join()
    if route_err:
        raise RuntimeError(f"g++ serial_route.cc failed:\n{route_err[0]}")
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
    # an entry-delay payload at the seeds (rounded in the bf16 mode)
    w0 = np.where(d0 == 0, rng.uniform(0, 1e-10, d0.shape), 0.0).astype(
        np.float32)
    cuda = torch.device("cuda")
    return (torch.from_numpy(d0).to(cuda),
            torch.from_numpy(np.ascontiguousarray(cong[:, noc])).to(cuda),
            torch.from_numpy(crit).to(cuda), torch.from_numpy(w0).to(cuda))


def _np(t):
    """A tensor as a numpy array; bfloat16 as its (exact) float32 values,
    numpy having no bfloat16."""
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _compare(tag, got, ref):
    """Bit-identity of (dist, pred, wenter, stats); returns max |err|."""
    names = ("dist", "pred", "wenter", "stats")
    err = 0.0
    for n, a, b in zip(names, got, ref):
        a, b = _np(a), _np(b)
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
    """K1 and K2 against their plain versions on the card, in the f32
    and (jittered and crit > 0 costs) the bf16 plane mode."""
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
            # K2's tile origins, from below minus the tile (the two plane
            # families one apart) to past the grid: the kernel wraps and
            # clamps them
            origins = {t: tuple(torch.from_numpy(rng.integers(
                -t[i] - 3, n - t[i] + 4, B).astype(np.int32)).cuda()
                for i, n in ((0, NX), (1, NY))) for t in tiles}
            for pd in ("f32", "bf16") if kind != "exact" else ("f32",):
                _kernel_cases(rows, cfg, kind, pd, pg, inst, nsw, tiles,
                              origins, B)
    return rows


def _k1_case(rows, cfg, kind, pd, pg, inst, nsw, B):
    """_kernel_cases' K1 case (the full canvas)."""
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    sfx = BF16 if pd == "bf16" else ""
    pb = 2 if pd == "bf16" else 4
    k1 = functools.partial(P.planes_relax, pg, *inst, nsw, pd)
    got = k1()
    net_st = pk.planes_relax_full_cuda.last_stats[:-1].cpu().numpy()
    auto = pk.planes_relax_full_cuda.last_mode
    ref = P.planes_relax_plain(pg, *inst, nsw, pd)
    err = _compare(f"K1 {cfg} {kind} {pd}", got, ref)
    # every smaller shared-memory mode gives the same bits
    for m in range(auto):
        err = max(err, _compare(
            f"K1 {cfg} {kind} {pd} mode {m}", pk.planes_relax_full_cuda(
                pg, *inst, nsw, mode=m, plane_dtype=pd), ref))
    case = dict(cfg=cfg, costs=kind, plane_dtype=pd, shape=[W, NX, NY], B=B,
                sweeps=int(got[3][0]), max_abs_err=err, mode=auto)
    if kind == "jitter":
        case["ms"] = cuda_ms(k1, 100 if NX < 16 else 20)
        if pd == "bf16":
            case["f32_ms"] = _f32_case(rows, "planes_relax_full_cuda",
                                       cfg)["ms"]
        # the kernel alone, and its fixed part (one sweep)
        tag = f"K1 {cfg} {pd}"
        device_later(tag, case, "device_us", k1, "planes_relax_full")
        device_later(tag, case, "one_sweep_device_us", functools.partial(
            P.planes_relax, pg, *inst, 1, pd), "planes_relax_full")
        by_mode = case["device_us_by_mode"] = {}
        for m in range(auto + 1):
            device_later(f"{tag} mode {m}", by_mode, m, functools.partial(
                pk.planes_relax_full_cuda, pg, *inst, nsw, mode=m,
                plane_dtype=pd), "planes_relax_full")
        case["plain_ms"] = cuda_ms(
            lambda: P.planes_relax_plain(pg, *inst, nsw, pd), 2)
        case.update(bound_ms(pg, B, net_st[:, 0], plane_bytes=pb))
    rows.setdefault("planes_relax_full_cuda" + sfx, []).append(case)
    say("kernels", f"K1 full {cfg} {kind} {pd}: bit-identical, "
                   + json.dumps(case))


def _kernel_cases(rows, cfg, kind, pd, pg, inst, nsw, tiles, origins, B,
                  k1_case=True):
    """phase_kernels' K1 and K2 cases on one instance in plane dtype
    ``pd``: bit-identity in every shared-memory mode; on jittered costs
    the times (the bf16 case beside the f32 case's ms on the same
    input).  ``k1_case`` False: the K2 cases alone."""
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    sfx = BF16 if pd == "bf16" else ""
    pb = 2 if pd == "bf16" else 4
    if k1_case:
        _k1_case(rows, cfg, kind, pd, pg, inst, nsw, B)
    # --- K2: cropped tiles ---
    for (cnx, cny) in tiles:
        ox, oy = origins[(cnx, cny)]
        args = (pg, *inst, nsw, ox, oy, cnx, cny)
        k2 = functools.partial(P.planes_relax_cropped, *args, pd)
        got = k2()
        net_st = pk.planes_relax_cropped_cuda.last_stats[:-1].cpu().numpy()
        auto = pk.planes_relax_cropped_cuda.last_mode
        tag = f"K2 {cfg} {kind} {pd} {cnx}x{cny}"
        ref = P.planes_relax_cropped_plain(*args, pd)
        err = _compare(tag, got, ref)
        for m in range(auto):
            err = max(err, _compare(
                f"{tag} mode {m}", pk.planes_relax_cropped_cuda(
                    *args, mode=m, plane_dtype=pd), ref))
        case = dict(cfg=cfg, costs=kind, plane_dtype=pd, tile=[cnx, cny],
                    B=B, sweeps=int(got[3][0]), max_abs_err=err, mode=auto)
        if kind == "jitter":
            case["ms"] = cuda_ms(k2, 20)
            if pd == "bf16":
                case["f32_ms"] = _f32_case(
                    rows, "planes_relax_cropped_cuda", cfg, [cnx, cny])["ms"]
            device_later(f"K2 {cfg} {pd} {cnx}x{cny}", case, "device_us",
                         k2, "planes_relax_cropped")
            _ONE_KERNEL.append((f"K2 {cfg} {pd} {cnx}x{cny}", k2,
                                "planes_relax_cropped_kernel"))
            case["plain_ms"] = cuda_ms(
                lambda: P.planes_relax_cropped_plain(*args, pd), 2)
            case.update(bound_ms(pg, B, net_st[:, 0], tile=(cnx, cny),
                                 plane_bytes=pb))
        rows.setdefault("planes_relax_cropped_cuda" + sfx, []).append(case)
        say("kernels", f"K2 cropped {cfg} {kind} {pd} {cnx}x{cny}: "
                       "bit-identical, " + json.dumps(case))


def _f32_case(rows, name, cfg, tile=None):
    """The timed f32 case of kernel ``name`` at ``cfg`` (and tile)."""
    return next(c for c in rows[name] if "ms" in c and c["cfg"] == cfg
                and c.get("tile") == tile)


def _same(tag, got, ref):
    """Bit-identity of tensor sequences; returns max |err| over finite
    reference values."""
    err = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = _np(a), _np(b)
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
        nb = dst.numel() * dst.element_size()
        hbm += nb * (2 if src is not None else 1)
        if src is not None and src.device != dst.device:
            key = (src.device, dst.device)
            link[key] = link.get(key, 0) + nb
    return max(hbm / PEAK_BYTES_S,
               max(link.values(), default=0) / PEAK_NVLINK_BYTES_S) * 1e3


def phase_halo(shapes):
    """K3 on the card, the TPU kernel's contract: the four one-hop shifts
    of an exchange round (dx right/left 1 column, dy right 1 / left 2
    columns) from strided views of random block canvases, through the
    entry point remote_slab_permute (CUDA slabs: the kernel), against
    its plain version: bit-identical.  Shard i sits on card i mod
    (visible cards).  The route's sharded relaxation moves its halos
    inside its own launch (phases 5-6), so no route launches K3: its
    launch counts are set to 0 just before the four shifts and read just
    after (``harness_launches``, reported beside the route phases'
    ``launches`` in the kernels line).  Times per exchange round (the four shifts): the kernel, its
    plain version, the library loop (one dst.copy_(src) per receiver
    into preallocated buffers, zero_() at the edge) and the bound
    (exchange_bound_ms).  Each shape also in bfloat16 (2-byte moves),
    timed beside f32.  Returns the f32 and the bf16 cases."""
    rows = {"f32": [], "bf16": []}
    for cfg, pg, s in shapes:
        for pd in ("f32", "bf16"):
            rows[pd].append(_halo_case(cfg, pg, s, pd, rows["f32"]))
    return rows["f32"], rows["bf16"]


def _launches(wrapper, pd: str) -> int:
    return wrapper.launches_bf16 if pd == "bf16" else wrapper.launches


def _halo_case(cfg, pg, s, pd, f32_rows):
    """phase_halo's checks and times at one shape in plane dtype ``pd``."""
    import torch

    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.planes import plane_torch_dtype
    from parallel_eda_tpu_torch.route.planes_shard import row_block_cols

    rng = np.random.default_rng(1)
    ncard = torch.cuda.device_count()
    B = 64
    dt = plane_torch_dtype(pd)

    def canvas(shape, i):
        a = rng.uniform(0, 1e-9, shape).astype(np.float32)
        a[rng.random(shape) < 0.3] = np.inf
        return torch.from_numpy(a).to(f"cuda:{i % ncard}").to(dt)

    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    kx = row_block_cols(pg, s)
    sts = [(canvas((B, W, kx + 2, NYp1), i), canvas((B, W, kx + 3, NY), i))
           for i in range(s)]
    calls = [([st[0][:, :, kx:kx + 1] for st in sts], True),
             ([st[0][:, :, 1:2] for st in sts], False),
             ([st[1][:, :, kx:kx + 1] for st in sts], True),
             ([st[1][:, :, 1:3] for st in sts], False)]

    def shift_all():
        return [sk.remote_slab_permute(sl, f) for sl, f in calls]

    _sync_all()
    sk.reset_launch_counts()
    got = shift_all()
    _sync_all()
    path = _launches(sk.remote_slab_permute_cuda, pd)
    err, moves = 0.0, []
    for (slabs, fwd), out in zip(calls, got):
        err = max(err, _same(f"K3 shift {cfg} s={s} fwd={fwd}", out,
                             sk.slab_permute_plain(slabs, fwd)))
        for r in range(s):
            snd = sk._sender(r, s, fwd)
            moves.append((None if snd is None else slabs[snd], out[r], 0.0))
    lib_moves = [(a, b) for a, b, _ in moves]

    def library():
        for a, b in lib_moves:
            if a is None:
                b.zero_()
            else:
                b.copy_(a)

    case = dict(
        cfg=cfg, shards=s, B=B, block=[W, kx, NY], plane_dtype=pd,
        cards=min(s, ncard), harness_launches=path, max_abs_err=err,
        ms=cuda_ms(shift_all, 200),
        plain_ms=cuda_ms(lambda: [sk.slab_permute_plain(sl, f)
                                  for sl, f in calls], 50),
        library_ms=cuda_ms(library, 200),
        bound_ms=exchange_bound_ms(moves), bound_by="bytes")
    if pd == "bf16":
        case["f32_ms"] = next(c["ms"] for c in f32_rows
                              if (c["cfg"], c["shards"]) == (cfg, s))
    device_later(f"K3 {cfg} s={s} {pd}", case, "device_us", shift_all,
                 "slab_permute")
    say("halo", f"K3 shifts {pd} bit-identical, launched {path} times "
                "through remote_slab_permute, " + json.dumps(case))
    return case


def _timed(fn):
    """(fn(), ms of that one call on the host clock between syncs)."""
    _sync_all()
    t0 = time.perf_counter()
    out = fn()
    _sync_all()
    return out, (time.perf_counter() - t0) * 1e3


def phase_peer(shapes):
    """The peer kernel (planes_relax_peer_cuda: one cooperative launch per
    card runs the whole sharded relaxation, halos stored into the
    neighbours' mailboxes, the fixpoint decided on the card) driven
    through planes_relax_sharded on one-card meshes — lag 1 on the
    resilience ladder's per-sweep mesh, and lag 2 — on the shards' bench
    (2, 3, 4 shards) and scale (4) shapes (B=64), exact, jittered and
    crit > 0 costs, f32 and (jittered, crit > 0) bf16: exactly one
    launch per relaxation; bit-identical in every shared-memory mode
    that fits to the plain loop (planes_relax_sharded_plain) and, under
    lag 1, to the cluster kernel; the per-net stats' max the batch's.
    On jittered costs timed: ms per relaxation (CUDA events), the plain
    loop's one call, the kernel's device time per launch and the bound
    (bound_ms at each net's executed sweeps), the cluster kernel beside
    it under lag 1, and a profiler check of one kernel per call.
    Returns the f32 and the bf16 cases."""
    rng = np.random.default_rng(2)
    B, nsw = 64, 32
    rows = {"f32": [], "bf16": []}
    for cfg, rr, pg, s in shapes:
        for kind in ("exact", "jitter", "crit"):
            inst = _instance(rr, pg, B, rng, kind == "exact",
                             crit_on=kind == "crit")
            for pd in ("f32", "bf16") if kind != "exact" else ("f32",):
                for impl in ("ppermute", "pallas_halo"):
                    rows[pd].append(_peer_case(cfg, pg, s, kind, pd, impl,
                                               inst, B, nsw, rows["f32"]))
    return rows["f32"], rows["bf16"]


def _peer_case(cfg, pg, s, kind, pd, impl, inst, B, nsw, f32_rows):
    """phase_peer's checks (and on jittered costs times) of one instance
    under one schedule in plane dtype ``pd``."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    W, NX, NYp1 = pg.shape_x
    card = inst[0].device
    mesh = TS.make_row_mesh(s, impl, [card] * s)
    # lag 1 takes the peer kernel on the ladder's per-sweep mesh
    drive = dataclasses.replace(mesh, per_sweep=True)
    lag2 = impl == "pallas_halo"
    cap = TS.sweep_cap(nsw, s)
    tag = f"peer {cfg} s={s} {kind} {pd} {impl}"
    relax = functools.partial(TS.planes_relax_sharded, pg, *inst, nsw,
                              drive, pd)
    c0 = {**pk.launch_counts(), **sk.launch_counts()}
    got = relax()
    torch.cuda.synchronize()
    c1 = {**pk.launch_counts(), **sk.launch_counts()}
    dc = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    key = "planes_relax_peer_cuda" + (BF16 if pd == "bf16" else "")
    if dc != {key: 1}:
        raise AssertionError(f"{tag}: launches {dc}, want one {key}")
    net_st = pk.planes_relax_peer_cuda.last_stats[:-1]
    auto = pk.planes_relax_peer_cuda.last_mode
    if not torch.equal(net_st.max(0).values, got[3]):
        raise AssertionError(f"{tag}: stats are not the max over nets")
    plain, plain_ms = _timed(functools.partial(
        TS.planes_relax_sharded_plain, pg, *inst, nsw, mesh, pd))
    err = _same(f"{tag} vs plain", got, plain)
    run = functools.partial(pk.planes_relax_peer_cuda, pg, *inst, cap,
                            mesh.devices, lag2, plane_dtype=pd)
    for m in range(auto):
        err = max(err, _same(f"{tag} mode {m} vs plain", run(mode=m),
                             plain))
    if not lag2:
        err = max(err, _same(f"{tag} vs cluster", got,
                             pk.planes_relax_cluster_cuda(
                                 pg, *inst, cap, s, plane_dtype=pd)))
    per_net = net_st.cpu().numpy()
    case = dict(cfg=cfg, shards=s, costs=kind, impl=impl, plane_dtype=pd,
                B=B, block=[W, TS.row_block_cols(pg, s) + 2, NYp1 - 1],
                mode=auto, sweeps=got[3].tolist(),
                net_sweeps_min=int(per_net[:, 0].min()), max_abs_err=err)
    if kind == "jitter":
        case["ms"] = cuda_ms(relax, 20)
        case["plain_ms"] = plain_ms
        if not lag2:
            case["cluster_ms"] = cuda_ms(functools.partial(
                pk.planes_relax_cluster_cuda, pg, *inst, cap, s,
                plane_dtype=pd), 20)
        if pd == "bf16":
            case["f32_ms"] = next(
                c["ms"] for c in f32_rows if "ms" in c
                and (c["cfg"], c["shards"], c["impl"]) == (cfg, s, impl))
        device_later(tag, case, "device_us", run, "planes_relax_peer")
        _ONE_KERNEL.append((tag, run, "planes_relax_peer_kernel"))
        case.update(bound_ms(pg, B, per_net[:, 0],
                             plane_bytes=2 if pd == "bf16" else 4))
    say("peer", f"{tag}: one launch, bit-identical to the plain loop"
                + ("" if lag2 else " and the cluster kernel")
                + " in every mode, " + json.dumps(case))
    return case


def phase_sharded(shapes):
    """planes_relax_sharded on the card.  (a) Its one-card lag-1 form, one
    cluster launch per relaxation, against the plain per-sweep loop on
    the card: every output and the stats bit-identical, in every
    shared-memory mode; dist and wenter equal single-device K1's
    (power-of-two costs); timed beside the peer kernel on the same
    inputs (``per_sweep_ms``: lag 1 on the ladder's per-sweep mesh,
    ``lag2_ms``: lag 2) and the plain loop's one call.  (b) At the bench
    shape, the route's meshes (shards round-robin over the visible
    cards), both schedules, 2 and 4 shards, against K1 and against the
    same call on CPU tensors (everything equal).  (c) The cluster kernel
    in the bf16 plane mode (_cluster_bf16), at crit 0 and crit > 0.
    Returns the f32 and the bf16 cases."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    rng = np.random.default_rng(3)
    rows, rows_bf16 = [], []
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
            plain, plain_ms = _timed(functools.partial(
                TS.planes_relax_sharded_plain, pg, *inst, nsw, one))
            err = _same(f"{tag} vs plain", got, plain)
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
            per_sweep = dataclasses.replace(one, per_sweep=True)
            lag2 = TS.make_row_mesh(s, "pallas_halo", [card] * s)
            case["per_sweep_ms"] = cuda_ms(
                lambda: TS.planes_relax_sharded(pg, *inst, nsw, per_sweep),
                20)
            lag2_out = TS.planes_relax_sharded(pg, *inst, nsw, lag2)
            case["lag2_sweeps"] = lag2_out[3].tolist()
            case["lag2_ms"] = cuda_ms(
                lambda: TS.planes_relax_sharded(pg, *inst, nsw, lag2), 20)
            case["plain_ms"] = plain_ms
            run = functools.partial(pk.planes_relax_cluster_cuda, pg,
                                    *inst, cap, s)
            device_later(tag, case, "device_us", run,
                         "planes_relax_cluster")
            device_later(tag, case, "per_sweep_device_us", functools.partial(
                pk.planes_relax_peer_cuda, pg, *inst, cap, per_sweep.devices),
                "planes_relax_peer")
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
            say("sharded", f"{tag}: one launch, bit-identical to the plain "
                           "form, dist/wenter = K1, " + json.dumps(case))
        for kind in ("jitter", "crit"):
            rows_bf16.extend(_cluster_bf16(
                cfg, pg, shard_counts, kind, nsw, B, _instance(
                    rr, pg, B, rng, False, crit_on=kind == "crit")))
        if cfg != "bench":
            continue
        # more than 8 shards: a non-portable cluster, or the card's
        # stated refusal
        try:
            wide = pk.planes_relax_cluster_cuda(pg, *inst,
                                                TS.sweep_cap(nsw, 9), 9)
            _same("cluster bench s=9 vs plain", wide,
                  TS.planes_relax_sharded_plain(
                      pg, *inst, nsw, TS.make_row_mesh(
                          9, "ppermute", [card] * 9)))
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
                               f"({TS.relax_form(rm, card)}): "
                               "dist/wenter = K1, all = CPU; "
                               f"sweeps {got[3].tolist()} (K1 "
                               f"{k1[3].tolist()}), {dt * 1e3:.1f} ms")
                if rm.n_cards > 1:
                    _peer_across_cards(cfg, pg, inst, nsw, rm)
    return rows, rows_bf16


def _peer_across_cards(cfg, pg, inst, nsw, rm):
    """The peer kernel with the shards spread over the cards (mesh
    ``rm``) against the same relaxation with every shard on the tensors'
    card (the peer kernel's one-card form), f32 and bf16: one launch per
    card, every output and the stats equal; ms per relaxation of both
    (the input copies to the other cards and the cross-card events
    included)."""
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS

    card = inst[0].device
    one = TS.RowMesh((card,) * rm.n_shards, rm.impl, per_sweep=True)
    for pd in ("f32", "bf16"):
        key = "planes_relax_peer_cuda" + (BF16 if pd == "bf16" else "")
        _sync_all()
        c0 = pk.launch_counts()
        got = TS.planes_relax_sharded(pg, *inst, nsw, rm, pd)
        _sync_all()
        c1 = pk.launch_counts()
        moved = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        if moved != {key: rm.n_cards}:
            raise AssertionError(f"peer {cfg} s={rm.n_shards} {rm.impl} "
                                 f"{pd} across cards: launches {moved}")
        _same(f"peer {cfg} s={rm.n_shards} {rm.impl} {pd} across cards vs "
              "one card", got, TS.planes_relax_sharded(pg, *inst, nsw, one,
                                                       pd))
        case = dict(cfg=cfg, shards=rm.n_shards, impl=rm.impl,
                    plane_dtype=pd, cards=rm.n_cards,
                    sweeps=got[3].tolist(),
                    ms_cards=cuda_ms(lambda: TS.planes_relax_sharded(
                        pg, *inst, nsw, rm, pd), 20),
                    ms_one_card=cuda_ms(lambda: TS.planes_relax_sharded(
                        pg, *inst, nsw, one, pd), 20))
        say("sharded", f"peer {cfg} s={rm.n_shards} {rm.impl} {pd} on "
                       f"{rm.n_cards} cards: one launch per card, equal to "
                       "the one-card form, " + json.dumps(case))


def _cluster_bf16(cfg, pg, shard_counts, kind, nsw, B, inst):
    """The cluster kernel in the bf16 plane mode on one instance: one
    cluster launch per relaxation (counted under its [bf16] key),
    bit-identical in every shared-memory mode to the plain bf16
    per-sweep loop; on jittered costs timed beside the f32 cluster
    relaxation of the same input and the bf16 peer kernel (lag 1)."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    W, NX, NYp1 = pg.shape_x
    card = inst[0].device
    out = []
    for s in shard_counts:
        one = TS.make_row_mesh(s, "ppermute", [card] * s)
        cap = TS.sweep_cap(nsw, s)
        tag = f"cluster {cfg} s={s} bf16 {kind}"
        c0 = {**pk.launch_counts(), **sk.launch_counts()}
        relax = functools.partial(TS.planes_relax_sharded, pg, *inst, nsw,
                                  one, "bf16")
        got = relax()
        torch.cuda.synchronize()
        c1 = {**pk.launch_counts(), **sk.launch_counts()}
        dc = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        if dc != {"planes_relax_cluster_cuda" + BF16: 1}:
            raise AssertionError(f"{tag}: launches {dc}, want one bf16 "
                                 "cluster launch")
        net_st = pk.planes_relax_cluster_cuda.last_stats[:-1]
        auto = pk.planes_relax_cluster_cuda.last_mode
        if not torch.equal(net_st.max(0).values, got[3]):
            raise AssertionError(f"{tag}: stats are not the max over nets")
        plain, plain_ms = _timed(functools.partial(
            TS.planes_relax_sharded_plain, pg, *inst, nsw, one,
            plane_dtype="bf16"))
        err = _same(f"{tag} vs plain", got, plain)
        run = functools.partial(pk.planes_relax_cluster_cuda, pg, *inst,
                                cap, s, plane_dtype="bf16")
        for m in range(auto):
            err = max(err, _same(f"{tag} mode {m} vs plain", run(mode=m),
                                 plain))
        per_net = net_st.cpu().numpy()
        case = dict(cfg=cfg, shards=s, B=B, costs=kind, plane_dtype="bf16",
                    block=[W, TS.row_block_cols(pg, s) + 2, NYp1 - 1],
                    mode=auto, sweeps=got[3].tolist(), max_abs_err=err)
        if kind == "jitter":
            case["ms"] = cuda_ms(relax, 20)
            case["f32_ms"] = cuda_ms(functools.partial(
                TS.planes_relax_sharded, pg, *inst, nsw, one), 20)
            case["per_sweep_ms"] = cuda_ms(functools.partial(
                TS.planes_relax_sharded, pg, *inst, nsw,
                dataclasses.replace(one, per_sweep=True), "bf16"), 20)
            case["plain_ms"] = plain_ms
            device_later(tag, case, "device_us", run, "planes_relax_cluster")
            _ONE_KERNEL.append((tag, run, "planes_relax_cluster_kernel"))
            case.update(bound_ms(pg, B, per_net[:, 0], plane_bytes=2))
        out.append(case)
        say("sharded", f"{tag}: one launch, bit-identical to the plain "
                       "form, " + json.dumps(case))
    return out


def _fresh_metrics(snapshots=False):
    """A fresh process metrics registry (kept as ``_fresh_metrics.last``):
    the Router's counters and gauges of the routes that follow, and with
    ``snapshots`` their per-window snapshots."""
    from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics

    _fresh_metrics.last = set_metrics(MetricsRegistry(enabled=snapshots))
    return _fresh_metrics.last


def _route(tag, flow, opts, impl=None, devices=None, analyzer=None,
           snapshots=False):
    """Route ``flow`` on the card, legal or raise; with ``impl``, under
    that exchange schedule instead of the Router's own; with
    ``devices``, the shards on those cards instead of round-robin; with
    ``analyzer``, timing-driven (the STA between iterations inside each
    window).  The route's metrics are in a registry of its own (the
    process registry until the next route).  Returns (result, launches,
    seconds, router)."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.planes_shard import (make_row_mesh,
                                                           uses_cluster)
    from parallel_eda_tpu_torch.route.router import Router

    reg = _fresh_metrics(snapshots)
    router = Router(flow.rr, opts, device="cuda")
    if impl is not None or devices is not None:
        router.row_mesh = make_row_mesh(opts.mesh_shards, impl or "ppermute",
                                        devices or "cuda")
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with _Spy(planes_shard, "planes_relax_sharded") as relaxations:
        res = router.route(flow.term, analyzer=analyzer)
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
    if opts.plane_dtype != "f32":
        say(tag, f"plane dtype {opts.plane_dtype}, guard "
                 f"{opts.dtype_guard}: "
                 f"{json.dumps(reg.values('route.kernel.'))}")
    rm = router.row_mesh
    if rm is not None:
        say(tag, f"mesh_shards={rm.n_shards} ({rm.impl}) on {rm.n_cards} "
                 f"card(s): sweeps executed {res.total_relax_steps}, useful "
                 f"{res.total_relax_steps_useful}; halo ledger "
                 f"{json.dumps(reg.values('route.mesh.'))}")
        # the committed relaxation's kernels (a mesh route here is f32 or
        # bf16 "off"); the other mode's must not run
        on = BF16 if opts.plane_dtype == "bf16" else ""
        off = "" if on else BF16
        c = {k: counts[k + on] for k in counts if not k.endswith(BF16)}
        if any(counts[k + off] for k in c):
            raise AssertionError(f"{tag}: a kernel of the other plane mode "
                                 f"ran: {counts}")
        if uses_cluster(rm, torch.device("cuda", torch.cuda.current_device())):
            # one launch per relaxation, no host read inside it
            if c["planes_relax_cluster_cuda"] != relaxations.calls or \
                    c["planes_relax_peer_cuda"]:
                raise AssertionError(f"{tag}: the one-card lag-1 route did "
                                     "not run as one cluster launch per "
                                     f"relaxation ({relaxations.calls} "
                                     f"relaxations): {counts}")
        elif c["planes_relax_peer_cuda"] != relaxations.calls * rm.n_cards \
                or c["planes_relax_cluster_cuda"]:
            # one peer launch per card per relaxation, no per-sweep launch
            raise AssertionError(f"{tag}: the sharded route did not run as "
                                 "one peer launch per card per relaxation "
                                 f"({relaxations.calls} relaxations on "
                                 f"{rm.n_cards} card(s)): {counts}")
        if c["remote_slab_permute_cuda"]:
            raise AssertionError(f"{tag}: the route shifted slabs into "
                                 "buffers instead of exchanging in place")
        if c["planes_relax_full_cuda"] or c["planes_relax_cropped_cuda"]:
            raise AssertionError(f"{tag}: a single-device relaxation ran "
                                 "under the mesh")
    return res, counts, dt, router


class _CallLog:
    """While in use, wraps ``module.name`` and logs each call's first
    tensor argument's (device, rows): the relaxations a route ran, where
    and at which batch.  The route code looks the function up at each
    call."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def log(pg, d0, *args, **kw):
            self.calls.append((str(d0.device), int(d0.shape[0])))
            return orig(pg, d0, *args, **kw)

        setattr(self.module, self.name, log)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _sync_cards():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _netmesh_route(tag, flow, opts, mesh, want=None, timing=False):
    """Route ``flow`` on the card(s) over the (net, node) mesh ``mesh``
    (each step's nets split over its rows), legal or raise; equal to
    ``want`` (a RouteResult, route phases' _same_route) when given.
    Timing-driven through flow.run_route with ``timing``.  Every planes
    relaxation must run on its row's first card at the per-row batch,
    as many on each row: K1 where the node axis is 1, else the node
    kernel, one launch per card of the row; nothing else may launch.
    Returns (result, launches, seconds)."""
    from parallel_eda_tpu_torch.flow import run_route
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.netsplit import node_rows
    from parallel_eda_tpu_torch.route.router import Router

    rows = node_rows(mesh)
    n, node = len(rows), len(rows[0]) > 1
    heads = [str(r[0]) for r in rows]
    reg = _fresh_metrics()
    router = None if timing else Router(flow.rr, opts, mesh=mesh)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    _sync_cards()
    t0 = time.time()
    with _CallLog(P, "planes_relax_node" if node else "planes_relax") as log:
        if timing:
            run_route(flow, opts, timing_driven=True, mesh=mesh)
            res = flow.route
        else:
            res = router.route(flow.term)
    _sync_cards()
    dt = time.time() - t0
    counts = {**pk.launch_counts(), **sk.launch_counts()}
    if not res.success:
        raise AssertionError(f"{tag}: route did not converge")
    check_route(flow.rr, flow.term, res.paths, occ=res.occ)
    if want is not None:
        _same_route(tag, res, want)
    B = min(opts.batch_size, len(flow.term.source))
    B = -(-B // n) * n
    per = {}
    for k, (dev, nb) in enumerate(log.calls):
        if dev != heads[k % n] or nb != B // n:
            raise AssertionError(f"{tag}: relaxation {k} ran {nb} nets on "
                                 f"{dev}, not {B // n} on row {k % n}'s "
                                 f"first card {heads[k % n]}")
        per[k % n] = per.get(k % n, 0) + 1
    key = ("planes_relax_node_cuda" if node else "planes_relax_full_cuda") \
        + (BF16 if opts.plane_dtype == "bf16" else "")
    cards_per_row = len(set(rows[0])) if node else 1
    if opts.program == "ell":
        if any(counts.values()) or log.calls:
            raise AssertionError(f"{tag}: a planes relaxation ran on the "
                                 f"ELL route: {counts}")
    elif (counts[key] != len(log.calls) * cards_per_row
          or len(set(per.values())) != 1 or len(per) != n
          or any(v for k, v in counts.items() if k != key)):
        raise AssertionError(f"{tag}: the route did not run {key} alone, "
                             f"as often on each row: per row {per}, "
                             f"launches {counts}")
    pl = reg.values("route.pipeline.")
    say(tag, f"mesh {n} net x {len(rows[0])} node on "
             f"{[[str(d) for d in r] for r in rows]}: legal, wirelength "
             f"{res.wirelength}, {res.iterations} iterations"
             + (f", crit path {flow.crit_path_delay!r} s" if timing else "")
             + f", {dt:.2f} s route, per-row batch {B // n}, {key} "
             f"launches per row "
             f"{[per.get(k, 0) * cards_per_row for k in range(n)]}, "
             f"blocking syncs {pl.get('route.pipeline.blocking_syncs')}, "
             f"launches {counts}")
    return res, counts, dt


def _wl_it(tag, res, want):
    if (res.wirelength, res.iterations) != want:
        raise AssertionError(f"{tag}: expected (wirelength, iterations) "
                             f"{want}, got {(res.wirelength, res.iterations)}")


def phase_netmesh(bench, bench_res, rows, graphs):
    """The (net, node) mesh's net axis on one card (docstring, phase
    8b): members repeating cuda:0.  Returns the launch counts of its
    routes; adds K1 at the per-member batches to ``rows``."""
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.parallel import make_mesh
    from parallel_eda_tpu_torch.route.router import RouterOpts

    t0 = time.time()
    out = []
    for n in (2, 4):
        mesh = make_mesh(n, devices=["cuda:0"] * n)
        res, c, _ = _netmesh_route(f"netmesh{n}", bench,
                                   RouterOpts(batch_size=64), mesh,
                                   want=bench_res)
        _wl_it(f"netmesh{n}", res, (537, 22))
        out.append(c)
    # timing-driven at net axis 2 against the one-card run_route
    mesh = make_mesh(2, devices=["cuda:0"] * 2)
    one = synth_flow(**BENCH_CFG)
    _timing_run_route("netmesh_timing_ref", one, RouterOpts(batch_size=64))
    two = synth_flow(**BENCH_CFG)
    res, c, _ = _netmesh_route("netmesh2_timing", two,
                               RouterOpts(batch_size=64), mesh,
                               want=one.route, timing=True)
    _wl_it("netmesh2_timing", res, (522, 22))
    if two.crit_path_delay != one.crit_path_delay:
        raise AssertionError(f"netmesh2_timing: crit path "
                             f"{two.crit_path_delay!r}, one card "
                             f"{one.crit_path_delay!r}")
    out.append(c)
    # the ELL program at net axis 2 against its one-card route
    opts = RouterOpts(batch_size=64, program="ell")
    ref, _, _, _ = _ell_route("netmesh_ell_ref", bench, opts, "cuda")
    res, c, _ = _netmesh_route("netmesh2_ell", bench, opts, mesh)
    _ell_same("netmesh2_ell", res, ref)
    out.append(c)
    # K1 alone at the per-member batches of these routes (bench 60 nets:
    # 30 and 15) and of the scale route at net axis 4 (16)
    rng = np.random.default_rng(17)
    for cfg, rr, pg, B in (("bench", bench.rr, graphs["bench"], 30),
                           ("bench", bench.rr, graphs["bench"], 15),
                           ("scale", graphs["scale_rr"], graphs["scale"],
                            16)):
        nsw = 32 if cfg == "bench" else 64
        _k1_case(rows, cfg, "jitter", "f32", pg,
                 _instance(rr, pg, B, rng, False), nsw, B)
    say("netmesh", f"bench net axis 2 and 4 = the one-card bench route "
                   f"(537 / 22), timing-driven net 2 = the one-card "
                   f"run_route (522 / 22), ELL net 2 = its one-card route; "
                   f"phase {time.time() - t0:.1f}s")
    return out


def phase_netmesh_cards(bench, bench_res, scale, smi):
    """The net axis across cards (--cards): the bench at net axis 2 and
    4 on distinct cards = the one-card bench route; the placed scale
    config at net axis 4 across four cards = its one-card route at
    crop="off", both timed in turns.  Returns the routes' launches."""
    import torch

    from parallel_eda_tpu_torch.parallel import make_mesh
    from parallel_eda_tpu_torch.route.router import RouterOpts

    out = []
    ncards = torch.cuda.device_count()
    for n in (2, 4):
        if n > ncards:
            continue
        _, c, _ = _netmesh_route(f"netmesh{n}_cards", bench,
                                 RouterOpts(batch_size=64), make_mesh(n),
                                 want=bench_res)
        out.append(c)
    if ncards < 4:
        return out
    opts = RouterOpts(batch_size=64, crop="off")
    secs = {"one card": [], "net 4": []}
    one = None
    for k in range(4):
        if k in (0, 3):
            res, c, dt, _ = _route("scale_crop_off", scale, opts)
            one = res if one is None else one
            if k == 3:
                _same_route("scale_crop_off", res, one)
            secs["one card"].append(dt)
        else:
            res, c, dt = _netmesh_route("scale_net4_cards", scale,
                                        RouterOpts(batch_size=64),
                                        make_mesh(4), want=one)
            secs["net 4"].append(dt)
        out.append(c)
    say("netmesh_cards", f"scale at net axis 4 across cards = the "
                         f"one-card crop=\"off\" route (wirelength "
                         f"{one.wirelength}, {one.iterations} iterations; "
                         f"paths, occupancy, stats rows, sweeps); route s "
                         f"in turns (one, net 4, net 4, one): {secs} on "
                         f"{smi}")
    return out


def _node_case(rows, cfg, kind, pd, pg, inst, nsw, B, m, timed):
    """The node kernel with ``m`` members repeating cuda:0 against its
    plain version (planes_relax_node_plain on the same card tensors) and
    against K1 on one instance: every output and the stats bit-identical,
    in every shared-memory mode that fits.  ``timed``: its ms per call
    beside K1's and the plain version's, its device time, and the bound
    (the relaxation's own: K1's, bound_ms)."""
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    W, NX, NYp1 = pg.shape_x
    devs = ["cuda:0"] * m
    sfx = BF16 if pd == "bf16" else ""
    node = functools.partial(P.planes_relax_node, pg, *inst, nsw, devs, pd)
    got = node()
    net_st = pk.planes_relax_node_cuda.last_stats[:-1].cpu().numpy()
    auto = pk.planes_relax_node_cuda.last_mode
    tag = f"node {cfg} {kind} {pd} {m} members"
    plain = functools.partial(P.planes_relax_node_plain, pg, *inst, nsw,
                              devs, pd)
    k1 = functools.partial(pk.planes_relax_full_cuda, pg, *inst, nsw,
                           plane_dtype=pd)
    err = max(_compare(f"{tag} vs plain", got, plain()),
              _compare(f"{tag} vs K1", got, k1()))
    for md in range(auto):
        err = max(err, _compare(f"{tag} mode {md}", pk.planes_relax_node_cuda(
            pg, *inst, nsw, devs, mode=md, plane_dtype=pd), got))
    case = dict(cfg=cfg, costs=kind, plane_dtype=pd, shape=[W, NX, NYp1 - 1],
                B=B, node=m, sweeps=int(got[3][0]), max_abs_err=err,
                mode=auto)
    if timed:
        reps = 50 if NX < 16 else 10
        case["ms"] = cuda_ms(node, reps)
        case["k1_ms"] = cuda_ms(k1, reps)
        case["plain_ms"] = cuda_ms(plain, 1)
        device_later(tag, case, "device_us", node, "planes_relax_node")
        case.update(bound_ms(pg, B, net_st[:, 0],
                             plane_bytes=2 if pd == "bf16" else 4))
    rows.setdefault("planes_relax_node_cuda" + sfx, []).append(case)
    say("nodemesh", f"{tag}: bit-identical to its plain version and K1, "
                    + json.dumps(case))


def phase_nodemesh(bench, bench_res, rows, graphs, smi):
    """The (net, node) mesh's node axis on one card (docstring, phase
    8c): members repeating cuda:0.  Adds the node kernel's cases to
    ``rows``; returns the launch counts of its routes."""
    from parallel_eda_tpu_torch.arch.builtin import minimal_arch
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.parallel import make_mesh
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route.router import RouterOpts
    from parallel_eda_tpu_torch.rr.graph import build_rr_graph
    from parallel_eda_tpu_torch.rr.grid import DeviceGrid

    t0 = time.time()
    rng = np.random.default_rng(23)
    # the node kernel at the routes' batches: bench 60 nets, scale 64
    for cfg, rr, pg, B, nsw in (
            ("bench", bench.rr, graphs["bench"], 60, 32),
            ("scale", graphs["scale_rr"], graphs["scale"], 64, 64)):
        for kind in ("jitter", "crit"):
            inst = _instance(rr, pg, B, rng, False, crit_on=kind == "crit")
            for pd in ("f32", "bf16"):
                for m in (2, 4):
                    _node_case(rows, cfg, kind, pd, pg, inst, nsw, B, m,
                               timed=kind == "jitter")
    a = minimal_arch(chan_width=10)
    rr = build_rr_graph(a, DeviceGrid(6, 72, a.io_capacity))
    pg = P.build_planes(rr, "cuda")
    _node_case(rows, "6x72", "jitter", "f32", pg,
               _instance(rr, pg, 16, rng, False), 64, 16, 4, timed=False)
    t_kern = time.time() - t0

    def mesh(shape):
        n = shape[0] * shape[1]
        return make_mesh(n, shape=shape, devices=["cuda:0"] * n)

    out, secs = [], {}
    ref, c, dt, _ = _route("nodemesh_ref", bench,
                           RouterOpts(batch_size=64, crop="off"))
    _same_route("nodemesh_ref", ref, bench_res)
    secs["one card crop off"] = dt
    for shape in ((1, 2), (1, 4), (2, 2)):
        tag = f"nodemesh{shape[0]}x{shape[1]}"
        res, c, dt = _netmesh_route(tag, bench, RouterOpts(batch_size=64),
                                     mesh(shape), want=bench_res)
        _wl_it(tag, res, (537, 22))
        secs[f"{shape[0]}x{shape[1]}"] = dt
        out.append(c)
    # the bf16 plane mode at (1, 2) against its one-card crop="off" route
    opts = RouterOpts(batch_size=64, plane_dtype="bf16", dtype_guard="off")
    ref16, _, _, _ = _route("nodemesh_bf16_ref", bench,
                            dataclasses.replace(opts, crop="off"))
    res, c, _ = _netmesh_route("nodemesh1x2_bf16", bench, opts,
                                mesh((1, 2)), want=ref16)
    out.append(c)
    # timing-driven at (1, 2) against the one-card run_route
    one = synth_flow(**BENCH_CFG)
    _timing_run_route("nodemesh_timing_ref", one, RouterOpts(batch_size=64))
    two = synth_flow(**BENCH_CFG)
    res, c, _ = _netmesh_route("nodemesh1x2_timing", two,
                                RouterOpts(batch_size=64), mesh((1, 2)),
                                want=one.route, timing=True)
    _wl_it("nodemesh1x2_timing", res, (522, 22))
    if not (two.crit_path_delay == one.crit_path_delay
            == 4.552000110180643e-09):
        raise AssertionError(f"nodemesh1x2_timing: crit path "
                             f"{two.crit_path_delay!r}, one card "
                             f"{one.crit_path_delay!r}")
    out.append(c)
    # the ELL program at (1, 2): its relaxation's rr-graph rows split
    opts = RouterOpts(batch_size=64, program="ell")
    eref, _, _, _ = _ell_route("nodemesh_ell_ref", bench, opts, "cuda")
    res, c, _ = _netmesh_route("nodemesh1x2_ell", bench, opts, mesh((1, 2)))
    _ell_same("nodemesh1x2_ell", res, eref)
    _wl_it("nodemesh1x2_ell", res, (624, 9))
    out.append(c)
    say("nodemesh", f"node kernel = its plain version = K1 at bench and "
                    f"scale (2, 4 members), 6x72 (4); bench (1, 2), (1, 4), "
                    f"(2, 2) = the one-card crop=\"off\" route (537 / 22), "
                    f"bf16 (1, 2) = its one-card route, timing (1, 2) 522 / "
                    f"22, ELL (1, 2) 624 / 9; route s {secs} on {smi}; "
                    f"kernel cases {t_kern:.1f}s, phase "
                    f"{time.time() - t0:.1f}s")
    return out


def phase_nodemesh_cards(bench, bench_res, scale, smi):
    """The node axis across cards (--cards): the node kernel across the
    cards against its one-card form and K1; the bench at (1, 2) on two
    cards = the one-card bench route; (four cards) the placed scale
    config at (1, 4) and (2, 2) = its one-card crop="off" route, timed in
    turns with it.  Returns the routes' launches."""
    import torch

    from parallel_eda_tpu_torch.parallel import make_mesh
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route.router import RouterOpts

    ncards = torch.cuda.device_count()
    rng = np.random.default_rng(29)
    pg = P.build_planes(scale.rr, "cuda:0")
    inst = _instance(scale.rr, pg, 64, rng, False, crit_on=True)
    for m in sorted({2, min(4, ncards)}):
        devs = [f"cuda:{k}" for k in range(m)]
        for pd in ("f32", "bf16"):
            got = pk.planes_relax_node_cuda(pg, *inst, 64, devs,
                                            plane_dtype=pd)
            _compare(f"node scale {m} cards {pd} vs one card", got,
                     pk.planes_relax_node_cuda(pg, *inst, 64,
                                               ["cuda:0"] * m,
                                               plane_dtype=pd))
            _compare(f"node scale {m} cards {pd} vs K1", got,
                     pk.planes_relax_full_cuda(pg, *inst, 64,
                                               plane_dtype=pd))
    say("nodemesh_cards", f"node kernel across {sorted({2, min(4, ncards)})}"
                          f" cards = its one-card form = K1 (scale, crit > "
                          f"0, f32 and bf16)")
    out = []
    _, c, _ = _netmesh_route("nodemesh1x2_cards", bench,
                              RouterOpts(batch_size=64),
                              make_mesh(2, shape=(1, 2)), want=bench_res)
    out.append(c)
    if ncards < 4:
        return out
    opts = RouterOpts(batch_size=64, crop="off")
    secs = {"one card": [], "1x4": [], "2x2": []}
    one = None
    for k, what in enumerate(("one card", "1x4", "2x2", "2x2", "1x4",
                              "one card")):
        if what == "one card":
            res, c, dt, _ = _route("scale_crop_off", scale, opts)
            if one is not None:
                _same_route("scale_crop_off", res, one)
            one = res
        else:
            shape = tuple(int(v) for v in what.split("x"))
            res, c, dt = _netmesh_route(
                f"scale_node{what}_cards", scale, RouterOpts(batch_size=64),
                make_mesh(4, shape=shape), want=one)
        secs[what].append(round(dt, 3))
        out.append(c)
    say("nodemesh_cards", f"scale at (1, 4) and (2, 2) across four cards = "
                          f"the one-card crop=\"off\" route (wirelength "
                          f"{one.wirelength}, {one.iterations} iterations; "
                          f"paths, occupancy, stats rows, sweeps); route s "
                          f"in turns: {secs} on {smi}")
    return out


def warm_route(flow, opts, analyzer=None):
    """A zero-argument call that routes ``flow`` once more on a Router
    that has routed it once (timing-driven with ``analyzer``), and the
    seconds of one such warm, untraced route."""
    import torch

    from parallel_eda_tpu_torch.route.router import Router

    run = functools.partial(Router(flow.rr, opts, device="cuda").route,
                            flow.term, analyzer=analyzer)
    run()
    torch.cuda.synchronize()
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    return run, time.time() - t0


def phase_profile(warm, tag):
    """Where a warm route's time goes on the card: one more route through
    ``warm`` (warm_route's result) is traced with torch.profiler (device
    activity only) for device time by kernel, the hand-written kernels'
    device time per launch and their share; the busy share is device
    time over warm_route's untraced seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run, route_s = warm
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.time() - t0) * 1e6
    kern = [(us, n, k) for k, (us, n) in device_kernels(prof).items()]
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


class _Spy:
    """While in use, wraps ``module.name``: counts its calls and keeps the
    arguments (tensors cloned) of the first call whose argument ``arg``
    holds a value > 0 — one host read per call until then, and none
    after.  The route code looks the function up at each call."""

    def __init__(self, module, name, arg=None):
        self.module, self.name, self.arg = module, name, arg
        self.calls = 0
        self.args = None

    def __enter__(self):
        import torch

        orig = self.orig = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls += 1
            if self.arg is not None and self.args is None and \
                    bool((args[self.arg] > 0).any()):
                self.args = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
            return orig(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _timing_run_route(tag, flow, opts):
    """``flow.run_route`` timing-driven on the card, legal (its own
    check) or raise; (result, launches, route seconds)."""
    import torch

    from parallel_eda_tpu_torch.flow import run_route
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    run_route(flow, opts, timing_driven=True, device="cuda")
    torch.cuda.synchronize()
    counts = {**pk.launch_counts(), **sk.launch_counts()}
    res, dt = flow.route, flow.times["route"]
    if not res.success:
        raise AssertionError(f"{tag}: route did not converge")
    say(tag, f"legal: wirelength {res.wirelength}, {res.iterations} "
             f"iterations, crit path {flow.crit_path_delay!r} s, "
             f"{dt:.2f} s route, {res.total_net_routes} net routes, relax "
             f"sweeps {res.total_relax_steps} (cropped "
             f"{res.total_relax_steps_cropped}), timing graph "
             f"{flow.tg.num_tnodes} tnodes, depth {flow.tg.depth}, "
             f"launches {counts}")
    return res, counts, dt


def _check_captured(rows, name, tag, spy, cfg):
    """Hold the kernel of ``name`` against its plain version on the
    relaxation inputs ``spy`` captured from a timing-driven route (crit
    > 0), in every shared-memory mode; add the case to the kernel's
    row."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS

    if spy.args is None:
        raise AssertionError(f"{tag}: the route made no relaxation call at "
                             "crit > 0")
    args = spy.args
    pg, crit = args[0], args[3]
    if name == "planes_relax_full_cuda":
        got, ref = P.planes_relax(*args), P.planes_relax_plain(*args)
        wrapper = pk.planes_relax_full_cuda
        modes = [functools.partial(wrapper, *args, mode=m)
                 for m in range(wrapper.last_mode)]
        check = _compare
    elif name == "planes_relax_cropped_cuda":
        got = P.planes_relax_cropped(*args)
        ref = P.planes_relax_cropped_plain(*args)
        wrapper = pk.planes_relax_cropped_cuda
        modes = [functools.partial(wrapper, *args, mode=m)
                 for m in range(wrapper.last_mode)]
        check = _compare
    else:
        mesh = args[6]
        n0 = pk.planes_relax_cluster_cuda.launches
        got = TS.planes_relax_sharded(*args)
        torch.cuda.synchronize()
        if pk.planes_relax_cluster_cuda.launches != n0 + 1:
            raise AssertionError(f"{tag}: not one cluster launch")
        ref = TS.planes_relax_sharded_plain(*args)
        wrapper = pk.planes_relax_cluster_cuda
        cap = TS.sweep_cap(args[5], mesh.n_shards)
        modes = [functools.partial(wrapper, *args[:5], cap, mesh.n_shards,
                                   mode=m) for m in range(wrapper.last_mode)]
        check = _same
    auto = wrapper.last_mode
    err = check(tag, got, ref)
    for m, run in enumerate(modes):
        err = max(err, check(f"{tag} mode {m}", run(), ref))
    case = dict(cfg=cfg, costs="timing route, crit > 0", B=int(crit.shape[0]),
                crit_max=float(crit.max()), sweeps=got[3].tolist(),
                max_abs_err=err, mode=auto)
    if name == "planes_relax_cropped_cuda":
        case["tile"] = [args[8], args[9]]
    rows[name].append(case)
    say("timing", f"{tag}: bit-identical to the plain version in every "
                  "mode, " + json.dumps(case))


def phase_timing(bench, scale, rows, warm):
    """The timing-driven route on the card through the user's entry
    points: ``run_route`` on the bench (wirelength 522 in 22 iterations,
    crit path 4.552000110180643e-09 s: the JAX package with XLA:CPU's
    multiply-add contraction off) and the placed scale config (legal),
    ``Router.route(analyzer=...)`` at mesh_shards=2 with both shards on
    one card (the cluster kernel; paths equal the bench route's), and
    ``route(timing_cb=...)`` and ``route(crit=0.99)`` on the 15-LUT
    fixture (65 / 7 and 64 / 4, as the JAX package).  K1, K2 and the
    cluster kernel against their plain versions on relaxation inputs
    captured from these routes at crit > 0.  Adds warm timing routes to
    ``warm`` for the profile phase.  Returns the routes' launch counts
    and the STA cases for phase_sta."""
    import torch

    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_shard as TS
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.timing import sta
    from parallel_eda_tpu_torch.timing.graph import build_timing_graph

    counts, sta_cases = [], []
    with _Spy(P, "planes_relax", 3) as k1, _Spy(sta, "sta_crit") as n_sta:
        res, c, dt = _timing_run_route("bench_timing", bench,
                                       RouterOpts(batch_size=64))
    counts.append(c)
    got = (res.wirelength, res.iterations, bench.crit_path_delay)
    if got != (522, 22, 4.552000110180643e-09):
        raise AssertionError(f"bench_timing: expected wirelength 522 in 22 "
                             "iterations, crit path 4.552000110180643e-09 "
                             f"s; got {got}")
    if c["planes_relax_full_cuda"] <= 0:
        raise AssertionError("bench_timing: K1 never launched")
    sta_cases.append(("bench", bench, n_sta.calls, res.iterations))
    _check_captured(rows, "planes_relax_full_cuda", "K1 bench timing", k1,
                    "bench")

    with _Spy(TS, "planes_relax_sharded", 3) as cl:
        mres, c, mdt, _ = _route("mesh2_timing", bench,
                              RouterOpts(batch_size=64, mesh_shards=2),
                              devices=["cuda:0"] * 2,
                              analyzer=bench.analyzer)
    counts.append(c)
    if (mres.wirelength, mres.iterations) != (522, 22) or not (
            np.array_equal(mres.paths, res.paths)
            and np.array_equal(mres.occ, res.occ)
            and np.array_equal(mres.sink_delay, res.sink_delay)):
        raise AssertionError("mesh2_timing: route differs from the "
                             "single-device bench timing route")
    if c["planes_relax_cluster_cuda"] <= 0:
        raise AssertionError("mesh2_timing: the cluster kernel never "
                             "launched")
    say("mesh2_timing", "paths, occupancy and sink delays equal to the "
                        f"single-device timing route; {mdt:.2f} s route")
    _check_captured(rows, "planes_relax_cluster_cuda",
                    "cluster bench mesh 2 timing", cl, "bench")
    warm["bench_timing"] = warm_route(bench, RouterOpts(batch_size=64),
                                      bench.analyzer)

    with _Spy(P, "planes_relax", 3) as k1, \
            _Spy(P, "planes_relax_cropped", 3) as k2, \
            _Spy(sta, "sta_crit") as n_sta:
        res, c, dt = _timing_run_route("scale_timing", scale,
                                       RouterOpts(batch_size=64))
    counts.append(c)
    if c["planes_relax_cropped_cuda"] <= 0:
        raise AssertionError("scale_timing: K2 never launched")
    sta_cases.append(("scale", scale, n_sta.calls, res.iterations))
    _check_captured(rows, "planes_relax_cropped_cuda", "K2 scale timing", k2,
                    "scale")
    _check_captured(rows, "planes_relax_full_cuda", "K1 scale timing", k1,
                    "scale")
    warm["scale_timing"] = warm_route(scale, RouterOpts(batch_size=64),
                                      scale.analyzer)

    # the other two entry points, on the 15-LUT fixture
    small = synth_flow(num_luts=15, num_inputs=6, num_outputs=6,
                       chan_width=10, seed=3)
    ta = sta.TimingAnalyzer(build_timing_graph(small.nl, small.pnl,
                                               small.term), device="cuda")
    crit = np.full(small.term.sinks.shape, 0.99, np.float32)
    for tag, opts, kw, want in (
            ("timing_cb", RouterOpts(batch_size=32),
             dict(timing_cb=ta.timing_cb), (65, 7)),
            ("crit_0.99", RouterOpts(batch_size=32, sink_group=1),
             dict(crit=crit), (64, 4))):
        r = Router(small.rr, opts, device="cuda").route(small.term, **kw)
        torch.cuda.synchronize()
        if not r.success or (r.wirelength, r.iterations) != want:
            raise AssertionError(f"{tag}: expected wirelength {want[0]} in "
                                 f"{want[1]} iterations, got "
                                 f"{r.wirelength} in {r.iterations}")
        check_route(small.rr, small.term, r.paths, occ=r.occ)
        say("timing", f"15-LUT route({next(iter(kw))}=...) on the card: "
                      f"legal, {r.wirelength} in {r.iterations} iterations")
    return counts, sta_cases


# the bf16 plane mode's bench routes at dtype_guard="off", as the port's
# CPU route gives them (the plain versions, device="cpu"): (wirelength,
# iterations, relaxation sweeps).  The sharded routes are not the
# single-device one: a path crossing a shard boundary is rounded to bf16
# at the end of each sweep it spans, so the rounded fixpoint depends on
# the schedule (the JAX package's row-mesh route gives the same figures)
BENCH_BF16 = {"single": (520, 16, 964), "mesh2": (530, 16, 806),
              "mesh2_lag2": (518, 16, 1308)}
# the bench timing-driven route (run_route) at "off": wirelength,
# iterations, critical path (s), as the port's CPU route gives them
BENCH_TIMING_BF16 = (516, 30, 4.550595456009887e-09)


class _ShadowWindows:
    """While in use, counts the window-program calls in the bf16 plane
    mode (a guarded route's shadow rungs; its committed ones are f32)."""

    def __enter__(self):
        from parallel_eda_tpu_torch.route import planes as P

        self.P, self.orig, self.calls = P, P.route_window_planes, 0

        def spy(*args, **kw):
            self.calls += kw.get("plane_dtype") == "bf16"
            return self.orig(*args, **kw)

        P.route_window_planes = spy
        return self

    def __exit__(self, *exc):
        self.P.route_window_planes = self.orig


def _want(tag, res, want):
    got = (res.wirelength, res.iterations, res.total_relax_steps)
    if got != want:
        raise AssertionError(f"{tag}: expected (wirelength, iterations, "
                             f"sweeps) {want}, got {got}")


def phase_bf16(bench, scale, bench_f32, warm):
    """The bf16 plane mode through the user's entry points (the Router
    and flow.run_route): the bench at dtype_guard="off" and at the
    default "window" (the f32 route, its bf16 shadow windows counted),
    the bench at mesh_shards=2 with both shards on card 0 under lag 1
    (the cluster kernel) and lag 2 (the peer kernel) at "off",
    the scale route at "off" (legal) and the bench timing route at
    "off"; then bench and scale route seconds at f32, "off" and
    "window" on warm Routers, in turns.  Returns the routes' launch
    counts."""
    import torch

    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    counts = []
    off = dict(plane_dtype="bf16", dtype_guard="off")
    res, c, _, _ = _route("bench_bf16", bench,
                          RouterOpts(batch_size=64, **off))
    _want("bench_bf16", res, BENCH_BF16["single"])
    if c["planes_relax_full_cuda" + BF16] <= 0 or \
            c["planes_relax_full_cuda"]:
        raise AssertionError(f"bench_bf16: not every relaxation ran K1 in "
                             f"the bf16 mode: {c}")
    counts.append(c)

    with _ShadowWindows() as sh:
        wres, c, _, router = _route("bench_bf16_window", bench,
                                    RouterOpts(batch_size=64,
                                               plane_dtype="bf16"))
    if not (np.array_equal(wres.paths, bench_f32.paths)
            and np.array_equal(wres.occ, bench_f32.occ)):
        raise AssertionError("bench_bf16_window: the guarded route is not "
                             "the f32 route")
    _want("bench_bf16_window", wres, (537, 22, bench_f32.total_relax_steps))
    if sh.calls <= 0 or c["planes_relax_full_cuda" + BF16] <= 0:
        raise AssertionError("bench_bf16_window: no bf16 shadow ran")
    say("bench_bf16_window", f"the f32 route (537 / 22); {sh.calls} bf16 "
                             "shadow window rung(s), "
                             f"{c['planes_relax_full_cuda' + BF16]} bf16 K1 "
                             "launches, dtype demotions "
                             + str(_metric("route.kernel.dtype_demotions")))
    counts.append(c)

    for tag, impl in (("mesh2", None), ("mesh2_lag2", "pallas_halo")):
        mres, c, _, _ = _route(f"bench_bf16_{tag}", bench,
                               RouterOpts(batch_size=64, mesh_shards=2, **off),
                               impl, devices=["cuda:0"] * 2)
        _want(f"bench_bf16_{tag}", mres, BENCH_BF16[tag])
        counts.append(c)

    sres, c, _, _ = _route("scale_bf16", scale,
                           RouterOpts(batch_size=64, **off))
    if c["planes_relax_cropped_cuda" + BF16] <= 0:
        raise AssertionError("scale_bf16: K2 never launched in the bf16 "
                             "mode")
    counts.append(c)

    # on a copy of the flow with its own analyzer: the bench flow keeps
    # its f32 timing route and analyzer for the sta phase
    tflow = dataclasses.replace(bench, analyzer=None, route=None, times={})
    tres, c, _ = _timing_run_route("bench_timing_bf16", tflow,
                                   RouterOpts(batch_size=64, **off))
    got = (tres.wirelength, tres.iterations, tflow.crit_path_delay)
    if got != BENCH_TIMING_BF16:
        raise AssertionError(f"bench_timing_bf16: expected (wirelength, "
                             f"iterations, crit path) {BENCH_TIMING_BF16}, "
                             f"got {got}")
    counts.append(c)

    # route seconds on warm Routers, f32 / off / window, in turns
    for cfg, flow in (("bench", bench), ("scale", scale)):
        runs = {}
        for name, kw in (("f32", {}), ("off", off),
                         ("window", dict(plane_dtype="bf16"))):
            runs[name] = functools.partial(
                Router(flow.rr, RouterOpts(batch_size=64, **kw),
                       device="cuda").route, flow.term)
            runs[name]()
        secs = {name: [] for name in runs}
        for name in ("f32", "off", "window", "window", "off", "f32"):
            torch.cuda.synchronize()
            t0 = time.time()
            r = runs[name]()
            torch.cuda.synchronize()
            secs[name].append(time.time() - t0)
            if name == "off":
                wl_it = (r.wirelength, r.iterations)
        say("bf16", f"{cfg} route seconds (warm, in turns f32 off window "
                    f"window off f32): {json.dumps(secs)}; bf16 off "
                    f"wirelength / iterations {wl_it}")
    warm["bench_bf16"] = warm_route(bench, RouterOpts(batch_size=64, **off))
    return counts


def phase_sta(cases):
    """The STA's launches per call (one call per iteration and rung) and
    its device time per call, from torch.profiler at each timing route's
    shapes on its final delays; times the calls the route made, for its
    device time per route."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parallel_eda_tpu_torch.timing.sta import sta_crit

    for cfg, flow, calls, iters in cases:
        a = flow.analyzer
        flat = torch.cat([torch.from_numpy(flow.route.sink_delay).cuda()
                          .reshape(-1), torch.zeros(1, device="cuda")])
        run = functools.partial(sta_crit, a.dev, flat, a.tg.depth,
                                a.crit_exp, a.max_crit,
                                req_seed=a._req_seed,
                                use_sdc=a._req_seed is not None)
        reps = 20
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        kern = device_kernels(prof).values()
        us = sum(u for u, _ in kern)
        n = sum(c for _, c in kern)
        if not n:
            say("sta", f"{cfg}: not measured (the profiler saw no kernel)")
            continue
        say("sta", f"{cfg}: {a.tg.num_tnodes} tnodes, depth {a.tg.depth}; "
                   f"{n / reps:.0f} kernel launches and {us / reps:.1f} us "
                   f"of device time per STA call; {calls} calls in the "
                   f"{iters}-iteration run_route, its final analysis "
                   f"included ({calls / iters:.2f} per iteration) -> "
                   f"{calls * n / reps / iters:.0f} launches per iteration, "
                   f"{calls * n / reps:.0f} launches and "
                   f"{calls * us / reps / 1e3:.2f} ms of device time per "
                   "route")


def _first_temp_diff(a, b) -> str:
    for i, (x, y) in enumerate(zip(a.temps, b.temps)):
        if x != y:
            return f"temperature {i}: {x} against {y}"
    return f"{len(a.temps)} against {len(b.temps)} temperatures"


def phase_place(bench_cfg, scale_cfg, scale_native):
    """The device annealer (place/sa.py) through ``flow.run_place``:

    - the bench config, wirelength-only with PlacerOpts(seed=3), as
      bench.py's place_microbench places it: the card's placement equal
      to the port's CPU placement (or the first different temperature is
      named and the phase fails), moves/s of a warm anneal (total moves
      over anneal seconds, bench.py:505) beside the native serial
      annealer's on the same initial placement;
    - a fresh 1,200-LUT/W=20 config, timing-driven at the default
      PlacerOpts (M 256, tradeoff 0.5, td_place_exp 8): legal
      (check_place), K1 launched by the delay lookup's sample route, the
      place seconds split into delay lookup and anneal; then run_route
      on it, legal, beside the native-placed scale route's numbers
      ``scale_native`` (wirelength, iterations, crit path).

    Returns the launch counts of the lookup and of the route, and a
    zero-argument call for after the profiler-free timings: PyTorch
    launches per step and the device's busy share of one segment
    (torch.profiler)."""
    import torch

    from parallel_eda_tpu_torch.flow import run_place, run_route, synth_flow
    from parallel_eda_tpu_torch.place import prng
    from parallel_eda_tpu_torch.place.check import check_place
    from parallel_eda_tpu_torch.place.sa import (Placer, PlacerOpts,
                                                 sa_segment, sa_step)
    from parallel_eda_tpu_torch.place.serial_sa import serial_sa_place
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.router import RouterOpts

    # ---- bench, wirelength-only: card against CPU, moves/s ----
    opts = PlacerOpts(seed=3)
    gpu = run_place(synth_flow(**bench_cfg), opts, timing_driven=False,
                    device="cuda")
    cpu = _cpu_result("place_bench")
    if not np.array_equal(gpu.pos, cpu.pos) or \
            gpu.place_stats.temps != cpu.place_stats.temps:
        raise AssertionError(
            "place bench: the card's placement differs from the CPU's; "
            "first different temperature (8 per segment) "
            f"{_first_temp_diff(gpu.place_stats, cpu.place_stats)}")
    f = synth_flow(**bench_cfg)
    pos0 = f.pos.copy()
    placer = Placer(f.pnl, f.grid, opts, device="cuda")
    placer.place(pos0)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = placer.place(pos0)
    dt = time.perf_counter() - t0
    ser = serial_sa_place(f.pnl, f.grid, pos0, seed=3)
    say("place", f"bench wirelength-only: card placement equal to the CPU "
                 f"placement ({len(st.temps)} temperatures, {st.segments} "
                 f"segments, final bb cost {st.final_cost!r}); warm anneal "
                 f"{dt:.3f} s, {st.total_moves} moves, sa_moves_per_sec "
                 f"{st.total_moves / dt:.1f}; native serial_sa_place "
                 f"{ser.wall_s:.3f} s, {ser.proposed} moves, "
                 f"{ser.moves_per_sec:.1f} moves/s, final bb cost "
                 f"{ser.final_cost:.2f}; host reads {st.host_reads} "
                 f"({st.host_reads / st.segments:.2f} per segment)")

    # ---- bench, timing-driven at the default PlacerOpts: card against
    # CPU (ROADMAP.md C11) ----
    t0 = time.perf_counter()
    tp = {"cuda": run_place(synth_flow(**bench_cfg), PlacerOpts(),
                            device="cuda")}
    secs = {"cuda": time.perf_counter() - t0}
    tp["cpu"] = _cpu_result("place_bench_timing")
    secs["cpu"] = tp["cpu"].seconds
    g, c = tp["cuda"].place_stats, tp["cpu"].place_stats
    if not np.array_equal(tp["cuda"].pos, tp["cpu"].pos) or \
            g.temps != c.temps or g.final_cost != c.final_cost or \
            g.est_crit_path != c.est_crit_path:
        raise AssertionError(
            "place bench timing-driven: the card's placement differs from "
            "the CPU's; first different temperature row "
            f"{_first_temp_diff(g, c)}; est crit path {g.est_crit_path!r} "
            f"against {c.est_crit_path!r}")
    say("place", f"bench timing-driven, default PlacerOpts: card placement "
                 f"= CPU placement ({len(g.temps)} temperatures, final bb "
                 f"cost {g.final_cost!r}, est crit path "
                 f"{g.est_crit_path!r} s); {secs['cuda']:.2f} s card, "
                 f"{secs['cpu']:.2f} s CPU (delay lookup and anneal)")

    # ---- scale, timing-driven at full width ----
    scale = synth_flow(**scale_cfg)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scale = run_place(scale, device="cuda")
    wall = time.perf_counter() - t0
    c_lookup = {**pk.launch_counts(), **sk.launch_counts()}
    if c_lookup["planes_relax_full_cuda"] <= 0:
        raise AssertionError("place scale: the delay lookup's sample route "
                             f"never launched K1: {c_lookup}")
    check_place(scale.pnl, scale.grid, scale.pos)
    st = scale.place_stats
    anneal = scale.times["place"]
    say("place", f"scale timing-driven ({scale.pnl.num_blocks} blocks, "
                 f"grid {scale.grid.nx}x{scale.grid.ny}, default "
                 f"PlacerOpts): legal; {wall:.2f} s = delay lookup "
                 f"{scale.times['delay_lookup']:.2f} s + anneal "
                 f"{anneal:.2f} s; {st.total_moves} moves, "
                 f"{st.total_moves / anneal:.1f} moves/s, "
                 f"{len(st.temps)} temperatures in {st.segments} segments, "
                 f"bb cost {st.initial_cost!r} -> {st.final_cost!r}, "
                 f"est_crit_path {st.est_crit_path!r} s, host reads "
                 f"{st.host_reads} ({st.host_reads / st.segments:.2f} per "
                 f"segment); lookup launches {c_lookup}")
    res, c_route, _ = _timing_run_route("place_scale_route", scale,
                                        RouterOpts(batch_size=64))
    say("place", f"scale routed after the port's annealer: wirelength "
                 f"{res.wirelength}, {res.iterations} iterations, crit path "
                 f"{scale.crit_path_delay!r} s; after the native annealer "
                 f"{scale_native}")

    # one warm anneal segment (one temperature of S steps) per cost mode,
    # timed here, before any profiler session; traced after them
    segs = []
    for tag, fl, timing in (("bench", gpu, False), ("scale", scale, False),
                            ("scale", scale, True)):
        pl = Placer(fl.pnl, fl.grid, device="cuda")
        pos, ring, occ = pl._state_from_pos(fl.pos)
        NB = pl.pp.num_blocks
        M = min(256, max(8, NB))
        S = max(1, math.ceil(NB ** (4 / 3) / M))
        crit = torch.rand(pl.pp.net_blk.shape, device="cuda")
        key = prng.PRNGKey(0, device="cuda")
        seg = functools.partial(sa_segment, pl.pp, pos, ring, occ, crit, 0.5,
                                key, 0.01, 3.0, 1e-6, M, S, 1, timing)
        step = functools.partial(sa_step, pl.pp, pos, ring, occ, crit, 1e-3,
                                 1e9, 0.5, key, 0.01, 3.0, M, timing)
        seg()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg()
        torch.cuda.synchronize()
        segs.append((tag, timing, M, S, seg, step, time.perf_counter() - t0))

    def launches_per_step():
        """PyTorch kernels per step inside a segment and per lone sa_step
        call (which also hashes its own draws), and the device's busy
        share of a segment (torch.profiler against the untraced
        seconds)."""
        for tag, timing, M, S, seg, step, dt in segs:
            n, busy_us = profile_call(seg)
            n1, _ = profile_call(step)
            say("place", f"{tag} segment (timing={timing}, M={M}, one "
                         f"temperature of {S} steps): {n / S:.1f} PyTorch "
                         f"kernel launches per step ({n} per segment), "
                         f"{n1} per lone sa_step call; device busy "
                         f"{busy_us / 1e3:.2f} ms of the untraced "
                         f"{dt * 1e3:.2f} ms ({busy_us / 1e6 / dt:.3f})")
    return [c_lookup, c_route], launches_per_step


# runs the CLI module as ``python -m parallel_eda_tpu_torch ARGS`` does
# (runpy, sys.argv altered) and, at exit, writes the relaxation and halo
# kernels' launch counts and the process's peak device memory to the
# JSON file named by its first argument
_CLI_CHILD = """\
import atexit, json, runpy, sys
import torch
from parallel_eda_tpu_torch.route import planes_kernels as pk
from parallel_eda_tpu_torch.route import shard_kernels as sk
out = sys.argv.pop(1)
def report():
    c = {**pk.launch_counts(), **sk.launch_counts()}
    c["peak_bytes"] = (torch.cuda.max_memory_allocated()
                       if torch.cuda.is_initialized() else 0)
    with open(out, "w") as f:
        json.dump(c, f)
atexit.register(report)
runpy.run_module("parallel_eda_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""
CLI_BASE = ["--luts", "25", "--arch", "minimal", "--route_chan_width", "12",
            "--batch_size", "16", "--moves_per_step", "16"]
GOLDEN_XML = os.path.join("tests", "golden", "k6_frac_n10_mem.xml")
# the golden XML's route width for mult16x16: above the W_min of 85
# that --binary_search found on the H100
GOLDEN_W = 96
# an arch file whose cluster has modes: frac_arch's pb tree (pb=) with IO
# pads, length-1 bidir wires and Fc, as tests/test_pb_pack.py writes it
FRAC_XML = """<architecture>
  <complexblocklist>
    <pb_type name="io" capacity="8"/>
    {pb}
  </complexblocklist>
  <device><fc default_in_type="frac" default_in_val="0.5"
              default_out_type="frac" default_out_val="0.4"/></device>
  <segmentlist>
    <segment name="l1" length="1" freq="1" type="bidir"></segment>
  </segmentlist>
</architecture>"""
# mult16x16 packs into 96 such clusters on a 10x10 grid; it routes at
# W=24 in 30 iterations (native placement, the CPU): 32 leaves room
FRAC_W = 32


def _cli_wave(work, plan, width=4, timeout=900):
    """The CLI runs of ``plan`` as subprocesses, ``width`` at a time, each
    in ``work``/tag: an entry (tag, args, want_rc, after) starts, in
    plan order, once the run named ``after`` (or None) has ended; its
    ``args`` may be a function of the runs ended so far.  Returns {tag:
    (stdout, launches and peak memory, wall seconds)}; fails unless each
    run exits with its ``want_rc``.  The runs share the card and the
    host's cores, so their seconds are taken beside each other's."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("."))
    pending, running, done = list(plan), {}, {}
    try:
        while pending or running:
            for entry in list(pending):
                tag, args, want_rc, after = entry
                if len(running) >= width:
                    break
                if after is not None and after not in done:
                    continue
                pending.remove(entry)
                d = os.path.join(work, tag)
                os.makedirs(d, exist_ok=True)
                log = open(os.path.join(d, "stdout.txt"), "w+")
                err = open(os.path.join(d, "stderr.txt"), "w+")
                args = args(done) if callable(args) else args
                p = subprocess.Popen(
                    [sys.executable, "-c", _CLI_CHILD,
                     os.path.join(d, "counts.json"), *args],
                    cwd=d, env=env, stdout=log, stderr=err, text=True)
                running[tag] = (p, log, err, want_rc, time.time())
            for tag, (p, log, err, want_rc, t0) in list(running.items()):
                if p.poll() is None:
                    if time.time() - t0 > timeout:
                        raise AssertionError(f"cli {tag}: over {timeout} s")
                    continue
                dt = time.time() - t0
                del running[tag]
                log.seek(0)
                err.seek(0)
                out, errs = log.read(), err.read()
                log.close()
                err.close()
                if p.returncode != want_rc:
                    raise AssertionError(
                        f"cli {tag}: exit {p.returncode}, want {want_rc}\n"
                        f"{out[-3000:]}\n{errs[-3000:]}")
                with open(os.path.join(work, tag, "counts.json")) as f:
                    done[tag] = (out, json.load(f), dt)
            time.sleep(0.05)
    finally:
        for p, log, err, _, _ in running.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
            err.close()
    return done


def _cli_stages(tag, out, c, dt):
    """Print a run's stage seconds (from its own lines), K1 / K2 launches
    and peak memory; fails on a critical path that is not finite."""
    m = re.search(r"\(pack ([\d.]+)s, rr graph .* ([\d.]+)s\)", out)
    stages = {"pack": float(m.group(1)), "rr_graph": float(m.group(2))}
    m = re.search(r"placed: .*, ([\d.]+)s(, est crit path [\d.]+ ns "
                  r"\(lookup ([\d.]+)s\))?\)", out)
    if m:
        stages["place"] = float(m.group(1))
        if m.group(3):
            stages["lookup"] = float(m.group(3))
    m = re.search(r"routed: (\d+) iterations, wirelength (\d+), "
                  r"([\d.]+)s", out)
    if m is None:
        raise AssertionError(f"cli {tag}: no routed line")
    stages["route"] = float(m.group(3))
    crit = re.search(r"critical path: (\S+) ns", out)
    say("cli", f"{tag}: {m.group(1)} iterations, wirelength {m.group(2)}"
               + (f", crit path {crit.group(1)} ns" if crit else "")
               + f"; stage s {json.dumps(stages)}; process {dt:.1f} s; "
               f"K1 {c['planes_relax_full_cuda']} K2 "
               f"{c['planes_relax_cropped_cuda']} cluster "
               f"{c['planes_relax_cluster_cuda']} launches; peak device "
               f"memory {c['peak_bytes'] / 2 ** 20:.1f} MiB")
    if crit is not None and not math.isfinite(float(crit.group(1))):
        raise AssertionError(f"cli {tag}: critical path {crit.group(1)}")


def _check_route_file(tag, flow, route_path):
    """The .route file against the flow it was read into: every routable
    net's tree starts at its SOURCE, holds its SINKs and has each node's
    parent earlier in it, and no rr node is used past its capacity."""
    from parallel_eda_tpu_torch.netlist.files import read_route_file

    routes = read_route_file(route_path)
    term, rr = flow.term, flow.rr
    occ = np.zeros(rr.num_nodes, dtype=np.int64)
    for r, ni in enumerate(term.net_ids):
        rows = routes.get(int(ni))
        if not rows or rows[0] != (int(term.source[r]), -1):
            raise AssertionError(f"cli {tag}: net {ni} has no tree from "
                                 "its source")
        seen = set()
        for node, parent in rows:
            if parent != -1 and parent not in seen:
                raise AssertionError(f"cli {tag}: net {ni} node {node} "
                                     "before its parent")
            seen.add(node)
        sinks = term.sinks[r, :int(term.num_sinks[r])]
        if not set(int(v) for v in sinks) <= seen:
            raise AssertionError(f"cli {tag}: net {ni} misses a sink")
        occ[list(seen)] += 1
    over = int((occ > np.asarray(rr.capacity)).sum())
    if over:
        raise AssertionError(f"cli {tag}: {over} rr nodes over capacity")


def _read_flow(blif, arch, chan_width, d, base):
    """The flow of a CLI run read back from its .net and .place files."""
    from parallel_eda_tpu_torch.flow import prepare
    from parallel_eda_tpu_torch.netlist.blif import read_blif
    from parallel_eda_tpu_torch.netlist.files import (read_net_file,
                                                      read_place_file)
    from parallel_eda_tpu_torch.rr.terminals import net_terminals

    pnl = read_net_file(os.path.join(d, base + ".net"), arch)
    flow = prepare(read_blif(blif), arch, chan_width, pnl=pnl)
    flow.pos, _, _ = read_place_file(pnl, os.path.join(d, base + ".place"))
    flow.term = net_terminals(pnl, flow.rr, flow.pos)
    return flow


def _tree_bytes(root):
    out = {}
    for r, _, files in os.walk(root):
        for f in files:
            p = os.path.join(r, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# metrics.json's host-clock instruments
TIMED_METRICS = ("route.pipeline.host_plan_ms", "route.pipeline.device_exec_ms",
                 "route.pipeline.stall_ms", "route.pipeline.overlap_frac",
                 "route.pipeline.host_overlap_frac",
                 "route.pipeline.host_plan_ms_total",
                 "route.pipeline.device_exec_ms_total",
                 "route.pipeline.stall_ms_total",
                 "route.pipeline.host_serial_ms_total", "route.window_wall_s")
# devprof's measured gauges: CUDA-event times on the card, none on the
# CPU (route.devcost.variants stays compared)
DEVPROF_MEASURED = ("route.devcost.device_ms", "route.devcost.launches")


def _stats_view(tree):
    """A --stats_dir tree with its seconds and clocks left out: the
    route_time column of iter_stats.txt, final_stats.txt's
    total_route_time, each mdclog record's "t", metrics.json's
    TIMED_METRICS and DEVPROF_MEASURED, and devprof.json's measurements
    (its variants and their modelled rows are kept)."""
    out = {}
    for k, v in tree.items():
        lines = v.decode().splitlines()
        if k == "metrics.json":
            doc = json.loads(v)
            for vals in [doc["values"]] + [sn["values"]
                                           for sn in doc["snapshots"]]:
                for name in TIMED_METRICS + DEVPROF_MEASURED:
                    vals.pop(name, None)
            out[k] = doc
        elif k == "devprof.json":
            out[k] = [(r["key"], r["meta"])
                      for r in json.loads(v)["records"]]
        elif k.endswith(".log"):
            recs = [json.loads(ln) for ln in lines]
            for rec in recs:
                rec.pop("t")
            out[k] = recs
        elif k.endswith("_stats.txt"):
            out[k] = [tok[:1] + tok[2:]
                      if tok[0].isdigit() or tok[0] == "total_route_time"
                      else tok for tok in (ln.split() for ln in lines)]
        else:
            out[k] = lines
    return out


def phase_cli(rows):
    """The CLI on the card (docstring, phase 15).  ``rows`` gains K1's
    and K2's cases at the first run's shapes.  Returns the launch counts
    summed over the runs on the card."""
    import shutil
    import warnings

    import torch

    from parallel_eda_tpu_torch.arch.builtin import _FRAC_PB_XML, k6_n10_arch
    from parallel_eda_tpu_torch.arch.xml_parser import read_arch_xml
    from parallel_eda_tpu_torch.flow import prepare
    from parallel_eda_tpu_torch.netlist.blif import read_blif, write_blif
    from parallel_eda_tpu_torch.netlist.synthesis import array_multiplier
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR
    from parallel_eda_tpu_torch.route.router import _size_class_buckets

    work = os.path.join(BUILD_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    blif = os.path.join(work, "mult16x16.blif")
    write_blif(array_multiplier(16), blif)
    arch = k6_n10_arch()

    # ---- K1 and K2 at the k6_n10 shapes, against their plain versions
    flow = prepare(read_blif(blif), arch, arch.default_chan_width)
    pg = P.build_planes(flow.rr, "cuda")
    nx, ny = flow.grid.nx, flow.grid.ny
    # every rung of the crop ladder the grid gives (the Router's crop
    # "auto" picks among them)
    spans = np.array([2 ** k for k in range(3, 12) if 2 ** k <= max(nx, ny)]
                     or [8])
    tiles = [tuple(t) for t in _size_class_buckets(spans, spans, nx, ny)[0]]
    rng = np.random.default_rng(1)
    _, NX, NYp1 = pg.shape_x
    B = 64
    for kind in ("exact", "jitter", "crit"):
        inst = _instance(flow.rr, pg, B, rng, kind == "exact",
                         crit_on=kind == "crit")
        origins = {t: tuple(torch.from_numpy(rng.integers(
            -t[i] - 3, n - t[i] + 4, B).astype(np.int32)).cuda()
            for i, n in ((0, NX), (1, NYp1 - 1))) for t in tiles}
        _kernel_cases(rows, "cli", kind, "f32", pg, inst, 64, tiles,
                      origins, B)
    del flow, pg

    # ---- the runs, four at a time (their checks follow, in this order)
    a1 = ["../mult16x16.blif", "--arch", "k6_n10", "--out_dir", "out",
          "--power", "--gen_postsynthesis_netlist"]
    xml = os.path.abspath(GOLDEN_XML)
    # the file's own width (24) leaves mult16x16 unroutable on the H100
    # (646 overused nodes after 50 iterations; 39 at W=60); --binary_search
    # found W_min 85 there (78 s of process), so the run routes at
    # GOLDEN_W above it (the binary search runs at the bench size below)
    gw = GOLDEN_W
    # a multi-mode XML arch: frac_arch's pb tree (one 6-LUT or two 5-LUTs
    # per BLE slot) in an XML file, so the packer takes the multi-mode
    # path (mode choice and pb routing)
    fxml = os.path.join(work, "frac.xml")
    with open(fxml, "w") as f:
        f.write(FRAC_XML.format(pb=_FRAC_PB_XML.format(I=20, O=8, N=4,
                                                       NM1=3)))
    farch = read_arch_xml(fxml)
    if farch.pb_tree is None:
        raise AssertionError("cli frac_xml: the XML's modes were not read")
    bs = ["--luts", str(BENCH_CFG["num_luts"]), "--seed",
          str(BENCH_CFG["seed"]), "--arch", "minimal", "--no_timing",
          "--out_dir", "out"]

    def narrow(done):
        wmin = int(re.search(r"binary search: W_min = (\d+)",
                             done["binary_search"][0]).group(1))
        return bs + ["--route_chan_width", str(wmin - 1), "--place_file",
                     "../binary_search/out/synth.place"]

    flow25 = CLI_BASE + ["--out_dir", "out", "--stats_dir", "stats",
                         "--device"]
    ran = _cli_wave(work, [
        ("mult16x16", a1, 0, None),
        ("binary_search", bs + ["--binary_search"], 0, None),
        ("golden_xml", ["../mult16x16.blif", "--arch", xml, "--out_dir",
                        "out", "--route_chan_width", str(gw)], 0, None),
        ("frac_xml", ["../mult16x16.blif", "--arch", "../frac.xml",
                      "--out_dir", "out", "--route_chan_width",
                      str(FRAC_W)], 0, None),
        ("resume", ["../mult16x16.blif", "--arch", "k6_n10", "--out_dir",
                    "out", "--place_file",
                    "../mult16x16/out/mult16x16.place"], 0, "mult16x16"),
        ("binary_search_narrow", narrow, 1, "binary_search"),
        ("mult16x16_sync", a1 + ["--sync"], 0, None),
        ("flow25_cuda", flow25 + ["cuda"], 0, None),
        ("flow25_cpu", flow25 + ["cpu"], 0, None)])
    runs = [ran[t][1] for t in ran if t != "flow25_cpu"]

    # ---- 1. the tseng-class BLIF on k6_n10 at the defaults
    out, c, dt = ran["mult16x16"]
    _cli_stages("mult16x16", out, c, dt)
    if c["planes_relax_full_cuda"] <= 0:
        raise AssertionError("cli mult16x16: K1 never launched")
    if "Power estimation" not in out:
        raise AssertionError("cli mult16x16: no power report")
    d1 = os.path.join(work, "mult16x16", "out")
    for f in ("mult16x16_post_synthesis.v", "mult16x16_post_synthesis.sdf"):
        if not os.path.getsize(os.path.join(d1, f)):
            raise AssertionError(f"cli mult16x16: {f} is empty")
    _check_route_file("mult16x16", _read_flow(blif, arch, 40, d1,
                                              "mult16x16"),
                      os.path.join(d1, "mult16x16.route"))

    # ---- 1b. the same run under --sync (the synchronous window
    # driver): the same .route bytes
    _cli_stages("mult16x16_sync", *ran["mult16x16_sync"])
    if _tree_bytes(d1)["mult16x16.route"] != _tree_bytes(os.path.join(
            work, "mult16x16_sync", "out"))["mult16x16.route"]:
        raise AssertionError("cli --sync: the .route differs from the "
                             "default (pipelined) run's")
    say("cli", "--sync: the .route bytes of the default run")

    # ---- 2. the same BLIF on the golden VTR7 XML arch
    _cli_stages("golden_xml", *ran["golden_xml"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        garch = read_arch_xml(xml)
    d2 = os.path.join(work, "golden_xml", "out")
    _check_route_file("golden_xml", _read_flow(
        blif, garch, gw, d2, "mult16x16"),
        os.path.join(d2, "mult16x16.route"))

    # ---- 2b. the same BLIF on the multi-mode XML arch
    _cli_stages("frac_xml", *ran["frac_xml"])
    d3 = os.path.join(work, "frac_xml", "out")
    _check_route_file("frac_xml", _read_flow(blif, farch, FRAC_W, d3,
                                             "mult16x16"),
                      os.path.join(d3, "mult16x16.route"))

    # ---- 3. the .place resume of run 1
    _cli_stages("resume", *ran["resume"])
    if _tree_bytes(d1)["mult16x16.route"] != _tree_bytes(os.path.join(
            work, "resume", "out"))["mult16x16.route"]:
        raise AssertionError("cli resume: the .route differs from run 1's")
    say("cli", "resume: the .place resume gives run 1's .route bytes")

    # ---- 4. --binary_search --no_timing at the bench size
    _cli_stages("binary_search", *ran["binary_search"])
    wmin = int(re.search(r"binary search: W_min = (\d+)",
                         ran["binary_search"][0]).group(1))
    out, c, dt = ran["binary_search_narrow"]
    if "ROUTING FAILED" not in out:
        raise AssertionError("cli binary_search: W_min - 1 did not fail")
    say("cli", f"binary_search: W_min = {wmin} routes legal, W_min - 1 "
               f"= {wmin - 1} fails ({out.strip().splitlines()[-1]}; "
               f"{dt:.1f} s, peak device memory "
               f"{c['peak_bytes'] / 2 ** 20:.1f} MiB)")

    # ---- 5. the 25-LUT flow with --stats_dir, card against CPU
    trees = {}
    for dev in ("cuda", "cpu"):
        tag = f"flow25_{dev}"
        out, c, dt = ran[tag]
        _cli_stages(tag, out, c, dt)
        if dev == "cuda" and c["planes_relax_full_cuda"] <= 0:
            raise AssertionError(f"cli {tag}: K1 never launched")
        d = os.path.join(work, tag)
        trees[dev] = (_tree_bytes(os.path.join(d, "out")),
                      _stats_view(_tree_bytes(os.path.join(d, "stats"))))
    if trees["cuda"][0] != trees["cpu"][0]:
        raise AssertionError("cli flow25: the card's artifacts differ from "
                             "the CPU's")
    if trees["cuda"][1] != trees["cpu"][1]:
        raise AssertionError("cli flow25: the card's stats files differ "
                             "from the CPU's")
    # devprof.json: the same variants and modelled rows; CUDA-event
    # times on the card, "unavailable" on the CPU
    dps = {}
    for dev in ("cuda", "cpu"):
        with open(os.path.join(work, f"flow25_{dev}", "stats",
                               "devprof.json")) as f:
            dps[dev] = json.load(f)["records"]
    if not any("kernels" in r for r in dps["cuda"]) or any(
            r.get("unavailable", "").startswith("cpu") for r in dps["cuda"]) \
            or any("unavailable" not in r for r in dps["cpu"]):
        raise AssertionError("cli flow25: devprof.json not measured on the "
                             "card or measured on the CPU")
    rows25 = trees["cuda"][1]["iter_stats.txt"][1:]
    if [int(r[0]) for r in rows25] != list(range(1, len(rows25) + 1)):
        raise AssertionError("cli flow25: not one stats row per iteration")
    say("cli", f"flow25: card artifacts, stats files (metrics.json but "
               f"for its host-clock and CUDA-event instruments, "
               f"devprof.json's variants: {len(dps['cuda'])}, measured on "
               f"the card) and mdclog records "
               f"equal the CPU's ({len(rows25)} iteration rows, "
               f"{sum(k.endswith('.log') for k in trees['cuda'][1])} "
               "mdclog files)")
    return {k: sum(r[k] for r in runs) for k in runs[0]
            if k != "peak_bytes"}


def _same_route(tag, got, want, whole=True):
    """``got`` equals ``want``: wirelength, iterations, paths and
    occupancy and, for a ``whole`` route (not a route's last slice), the
    stats rows (seconds aside), the sweep ledger and the congestion
    records."""
    def rows(r):
        return [(s.iteration, s.overused_nodes, s.overuse_total,
                 s.rerouted_nets, s.relax_steps, s.batches, s.overuse_pct)
                for s in r.stats]
    diff = [k for k, same in (
        ("wirelength", got.wirelength == want.wirelength),
        ("iterations", got.iterations == want.iterations),
        ("paths", np.array_equal(got.paths, want.paths)),
        ("occ", np.array_equal(got.occ, want.occ)),
        ("congestion", not whole or got.congestion == want.congestion),
        ("stats", not whole or rows(got) == rows(want)),
        ("sweeps", not whole
         or got.total_relax_steps == want.total_relax_steps)) if not same]
    if diff:
        raise AssertionError(f"{tag}: {diff} differ")


def _ckpt_bytes(ck) -> int:
    """Host bytes of a RouteCheckpoint's arrays (state, driver, fin_save)."""
    arrs = [getattr(ck, k) for k in ("occ", "acc", "paths", "sink_delay",
                                     "all_reached", "bb", "crit")]
    arrs += [v for v in ck.driver.values() if isinstance(v, np.ndarray)]
    arrs += list((ck.fin_save or ())[:5])
    return int(sum(a.nbytes for a in arrs))


def _slices(tag, flow, opts, resume=None):
    """Route ``flow`` on the card, resuming each slice's checkpoint until
    the route succeeds.  Returns (last result, slices, launches summed,
    seconds, checkpoints taken, their host ms, resume ms summed, the
    largest checkpoint's bytes)."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router

    reg = _fresh_metrics()
    router = Router(flow.rr, opts, device="cuda")
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = router.route(flow.term, resume=resume)
    n, ck_bytes, resume_ms = 1, 0, 0.0
    while not res.success:
        if res.checkpoint is None or n > 100:
            raise AssertionError(f"{tag}: failed without a checkpoint")
        ck_bytes = max(ck_bytes, _ckpt_bytes(res.checkpoint))
        res = router.route(flow.term, resume=res.checkpoint)
        resume_ms += reg.gauge("route.elastic.resume_ms").value
        n += 1
    torch.cuda.synchronize()
    dt = time.time() - t0
    check_route(flow.rr, flow.term, res.paths, occ=res.occ)
    m = reg.values()
    return (res, n, {**pk.launch_counts(), **sk.launch_counts()}, dt,
            m.get("route.elastic.checkpoints", 0),
            m.get("route.elastic.checkpoint_ms_total", 0.0), resume_ms,
            ck_bytes)


def _metric(name):
    """An instrument's value in the process registry (0 if unset)."""
    from parallel_eda_tpu_torch.obs import get_metrics

    return get_metrics().values().get(name, 0)


def _pipeline_figures() -> str:
    """The last route's route.pipeline.* figures (its own registry)."""
    from parallel_eda_tpu_torch.obs import get_metrics

    return json.dumps({k.split(".")[-1]: v for k, v in
                       get_metrics().values("route.pipeline.").items()})


def phase_elastic(bench, bench_res, scale):
    """The pipelined and elastic route driver on the card (docstring,
    phase 16).  Returns the launch counts summed over its routes."""
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    runs = []
    # ---- pipelined against sync at scale, in turns
    secs = {True: [], False: []}
    ref = None
    for p in (False, True, True, False):
        tag = "elastic_scale_" + ("pipelined" if p else "sync")
        res, c, dt, router = _route(tag, scale, RouterOpts(
            batch_size=64, pipeline=p))
        runs.append(c)
        secs[p].append(dt)
        say("elastic", f"{tag}: {dt:.3f} s, route.pipeline.* "
                       f"{_pipeline_figures()}")
        if ref is None:
            ref = res
        else:
            _same_route(tag, res, ref)
    if not ref.congestion:
        raise AssertionError("elastic: the scale route recorded no "
                             "congestion")
    say("elastic", f"scale route s pipelined {secs[True]}, sync "
                   f"{secs[False]} (turns sync, pipelined, pipelined, "
                   f"sync); {len(ref.congestion)} congestion records equal")

    # ---- sliced and resumed at scale
    res, n, c, dt, cks, ck_ms, rs_ms, ck_b = _slices(
        "elastic_sliced", scale, RouterOpts(batch_size=64,
                                            slice_iterations=5))
    runs.append(c)
    _same_route("elastic_sliced", res, ref, whole=False)
    if n < 2:
        raise AssertionError("elastic_sliced: the route was not sliced")
    say("elastic", f"scale slice_iterations=5: {n} slices, bit-identical "
                   f"to the unsliced route; {dt:.3f} s in all; "
                   f"checkpoint {ck_b} bytes, taken in "
                   f"{ck_ms / max(1, cks):.3f} ms ({cks} taken), resumed "
                   f"(uploaded) in {rs_ms / max(1, n - 1):.3f} ms")

    # ---- mesh resumes at bench, each way, on one card: the checkpoint
    # of a slice's yield at iteration 4
    for src, dsts in ((1, (2, 4)), (2, (1,)), (4, (1,))):
        r = Router(bench.rr, RouterOpts(batch_size=64, mesh_shards=src,
                                        slice_iterations=4), device="cuda")
        ck = r.route(bench.term).checkpoint
        if ck is None:
            raise AssertionError(f"elastic: no checkpoint at mesh {src}")
        for dst in dsts:
            tag = f"elastic_mesh{src}_to_{dst}"
            mres, n, c, _, _, _, _, _ = _slices(
                tag, bench, RouterOpts(batch_size=64, mesh_shards=dst),
                resume=ck)
            runs.append(c)
            if (mres.wirelength, mres.iterations) != (537, 22) or not \
                    np.array_equal(mres.paths, bench_res.paths):
                raise AssertionError(
                    f"{tag}: {mres.wirelength} / {mres.iterations}, paths "
                    "differ from the single-device bench route")
            say("elastic", f"{tag}: checkpoint at iteration {ck.it_done} "
                           f"resumed: 537 / 22, paths equal; cluster "
                           f"launches {c['planes_relax_cluster_cuda']}")

    # ---- the finishing pass's checkpoint at scale, no budget left
    res, _, c, _, cks, ck_ms, _, _ = _slices(
        "elastic_finish", scale, RouterOpts(batch_size=64,
                                            checkpoint_every=1))
    runs.append(c)
    ck = res.checkpoint
    if not (ck.driver["finish_done"] and ck.fin_save is not None):
        raise AssertionError("elastic_finish: the last checkpoint is not "
                             "the finishing pass's")
    back = Router(scale.rr, RouterOpts(
        batch_size=64, max_router_iterations=ck.it_done),
        device="cuda").route(scale.term, resume=ck)
    if not back.success:
        raise AssertionError("elastic_finish: the legal route was lost")
    check_route(scale.rr, scale.term, back.paths, occ=back.occ)
    say("elastic", f"finishing pass: checkpoint at iteration {ck.it_done} "
                   f"({_ckpt_bytes(ck)} bytes with fin_save; {cks} "
                   f"checkpoints in {ck_ms:.3f} ms), resumed with no budget "
                   f"left: legal, wirelength {back.wirelength} in "
                   f"{back.iterations} iterations")

    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


# the ELL program's bench routes (RouterOpts(batch_size=64,
# program="ell")): wirelength and iterations of the JAX package's Router
# on XLA:CPU, windowed (the default) and global (windowed=False)
ELL_BENCH = {True: (624, 9), False: (614, 11)}


def _ell_same(tag, got, want):
    """``got`` equals ``want`` as _same_route holds a whole route, and
    in sink delays and windowed / widened nets."""
    _same_route(tag, got, want)
    diff = [k for k, same in (
        ("sink_delay", np.array_equal(got.sink_delay, want.sink_delay)),
        ("windowed_nets", got.windowed_nets == want.windowed_nets),
        ("widened_nets", got.widened_nets == want.widened_nets))
        if not same]
    if diff:
        raise AssertionError(f"{tag}: {diff} differ")


def _ell_route(tag, flow, opts, device):
    """Route ``flow`` with the ELL program on ``device``, legal or raise.
    Returns (result, hand-written kernel launches, seconds, router)."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router

    router = Router(flow.rr, opts, device=device)
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
    say(tag, f"{device}: legal: wirelength {res.wirelength}, "
             f"{res.iterations} iterations, {dt:.2f} s route, "
             f"{res.total_net_routes} net routes, windowed nets "
             f"{res.windowed_nets}, widened {res.widened_nets}, relax "
             f"steps {res.total_relax_steps} (per iteration "
             f"{[s.relax_steps for s in res.stats]}), {len(flow.term.source)}"
             f" nets, grid {flow.grid.nx}x{flow.grid.ny}, "
             f"{flow.rr.num_nodes} rr nodes, in-degree "
             f"{router.dev.max_in_degree}")
    return res, counts, dt, router


def _ell_bench(bench):
    """The ELL program's bench routes on the card against the CPU and the
    JAX numbers, windowed and global, and timing-driven."""
    from parallel_eda_tpu_torch.flow import run_route, synth_flow
    from parallel_eda_tpu_torch.route.router import RouterOpts

    for windowed in (True, False):
        tag = "ell_bench" if windowed else "ell_bench_global"
        opts = RouterOpts(batch_size=64, program="ell", windowed=windowed)
        card, c, dt, _ = _ell_route(tag, bench, opts, "cuda")
        cpu = _cpu_result(tag)
        dt_cpu = cpu.seconds
        _ell_same(tag, card, cpu)
        if (card.wirelength, card.iterations) != ELL_BENCH[windowed]:
            raise AssertionError(
                f"{tag}: expected wirelength {ELL_BENCH[windowed][0]} in "
                f"{ELL_BENCH[windowed][1]} iterations (JAX), got "
                f"{card.wirelength} in {card.iterations}")
        if any(c.values()):
            raise AssertionError(f"{tag}: a planes kernel ran on the ELL "
                                 f"route: {c}")
        say(tag, f"card route = CPU route (paths, occupancy, sink delays, "
                 f"stats rows, windowed/widened nets) = JAX's "
                 f"{ELL_BENCH[windowed]}; {dt:.2f} s card, {dt_cpu:.2f} s "
                 "CPU")

    # timing-driven: run_route's analyzer, the host timing_cb per iteration
    f = synth_flow(**BENCH_CFG)
    run_route(f, RouterOpts(batch_size=64, program="ell"),
              timing_driven=True, device="cuda")
    cpu = _cpu_result("ell_timing")
    _ell_same("ell_timing", f.route, cpu)
    cpd = (f.crit_path_delay, cpu.crit_path_delay)
    if cpd[0] != cpd[1]:
        raise AssertionError(f"ell_timing: crit path {cpd[0]!r} on the "
                             f"card, {cpd[1]!r} on the CPU")
    r = f.route
    say("ell_timing", f"run_route timing-driven: card = CPU route, "
                      f"wirelength {r.wirelength}, {r.iterations} "
                      f"iterations, crit path {cpd[0]!r} s, "
                      f"{f.times['route']:.2f} s card, "
                      f"{cpu.seconds:.2f} s CPU")


# a mid-size config whose ELL window tables fit window_max_bytes, so
# that its nets take the windowed program: held card = CPU (ROADMAP.md
# C10; the scale config's CPU route takes too long for this script)
ELL_MID_CFG = dict(SCALE_CFG, num_luts=300, chan_width=16)


def phase_ell(bench, scale, smi, warm):
    """The ELL program (docstring, phase 17).  ``warm`` gains the scale
    route for the profile phase."""
    from parallel_eda_tpu_torch.flow import run_place_native, synth_flow
    from parallel_eda_tpu_torch.route.router import RouterOpts

    _ell_bench(bench)
    # the mid-size config, native-placed, windowed: card against CPU
    mid = run_place_native(synth_flow(**ELL_MID_CFG))
    opts = RouterOpts(batch_size=64, program="ell")
    card, c, dt, _ = _ell_route("ell_mid", mid, opts, "cuda")
    cpu = _cpu_result("ell_mid")
    dt_cpu = cpu.seconds
    _ell_same("ell_mid", card, cpu)
    R = len(mid.term.source)
    if card.windowed_nets * 2 <= R or any(c.values()):
        raise AssertionError(f"ell_mid: {card.windowed_nets} of {R} nets "
                             f"windowed, planes launches {c}")
    say("ell_mid", f"{ELL_MID_CFG['num_luts']} LUTs, W="
                   f"{ELL_MID_CFG['chan_width']}: card route = CPU route "
                   f"(paths, occupancy, sink delays, stats rows, "
                   f"windowed/widened nets), {card.windowed_nets} of {R} "
                   f"nets windowed; {dt:.2f} s card, {dt_cpu:.2f} s CPU")
    # the scale config at full size, windowed, once on the card
    opts = RouterOpts(batch_size=64, program="ell")
    res, c, dt, router = _ell_route("ell_scale", scale, opts, "cuda")
    if any(c.values()):
        raise AssertionError(f"ell_scale: a planes kernel ran: {c}")
    say("ell_scale", f"{dt:.2f} s route, {res.iterations} iterations, "
                     f"wirelength {res.wirelength}, windowed nets "
                     f"{res.windowed_nets}, widened {res.widened_nets}, "
                     f"relax steps {res.total_relax_steps}, net routes "
                     f"{res.total_net_routes} on {smi}")
    # launches per route and busy share: one profiled warm route (phase 13)
    warm["scale_ell"] = (functools.partial(router.route, scale.term), dt)


def _lockstep(router, jobs):
    """Several jobs' route_gen generators on one Router, driven to the
    end in lockstep by serve/fused.py's FusedSliceRunner (one
    route_window_planes_multi call a step while two or more requests are
    pending).  ``jobs``: [(term, opts)].  Returns (results, multi
    calls)."""
    import types

    from parallel_eda_tpu_torch.serve.fused import (FusedSliceRunner,
                                                    SliceEntry)

    entries = []
    for j, (term, opts) in enumerate(jobs):
        router.opts = opts
        entries.append(SliceEntry(types.SimpleNamespace(job_id=f"job{j}"),
                                  router.route_gen(term), opts, f"job{j}/"))
    reg = _fresh_metrics()
    FusedSliceRunner(router).run_slice(entries)
    for e in entries:
        if e.error is not None:
            raise e.error
    return ([e.result for e in entries],
            reg.counter("route.serve.fused.dispatches").value)


def _profiled_launches(run, keys, want):
    """Launches of the kernels whose device name holds each of ``keys``
    in one call of ``run`` (torch.profiler), taken again (three times at
    most) while they differ from the wrappers' counts ``want`` (a trace
    now and then drops records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        got = {k: sum(c for name, (_, c) in kern.items() if k in name)
               for k in keys}
        if [got[k] for k in keys] == want:
            break
    return got


def phase_fused(bench, bench_res, scale):
    """The fused window dispatch (RouterOpts.fused_dispatch: a window's
    whole crop ladder as one route_window_planes_fused call, issued
    through Router.route_gen) and the multi-job window on the card
    (docstring, phase 18).  Returns the launch counts summed over its
    card routes and a zero-argument call for after the profiler-free
    timings, which traces the first window (two iterations) of the scale
    route in each mode, a window of several crop rungs, and holds their
    K1/K2 launches by torch.profiler equal to each other and to the
    wrappers' counts (a whole scale route takes ~50 s to trace)."""
    import torch

    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.place.initial import initial_placement
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.rr.terminals import net_terminals

    runs = []
    # ---- bench: fused on the card = per-rung on the card = fused on
    # the CPU, f32; then bf16 "off" and mesh 2 (the cluster kernel)
    fused = RouterOpts(batch_size=64, fused_dispatch=True)
    res, c, dt, _ = _route("fused_bench", bench, fused, snapshots=True)
    runs.append(c)
    reg = _fresh_metrics.last
    rungs = reg.series("route.kernel.fused_rungs", phase="route")
    disp = reg.series("route.kernel.dispatches_per_window", phase="route")
    _same_route("fused_bench", res, bench_res)
    _want("fused_bench", res, (537, 22, bench_res.total_relax_steps))
    cpu = _cpu_result("fused_bench")
    dt_cpu = cpu.seconds
    _same_route("fused_bench_cpu", cpu, res)
    if set(disp) != {1} or len(rungs) != len(res.stats):
        raise AssertionError(f"fused_bench: gauges fused_rungs {rungs}, "
                             f"dispatches_per_window {disp}")
    say("fused", f"bench fused on the card = per-rung on the card = fused "
                 f"on the CPU (537 / 22, paths, occupancy, stats rows, "
                 f"congestion records); {dt:.2f} s card, {dt_cpu:.2f} s "
                 f"CPU; per window (pipelined, booked a window late) "
                 f"route.kernel.fused_rungs {rungs}, "
                 f"dispatches_per_window {disp}")
    off = dict(plane_dtype="bf16", dtype_guard="off")
    for tag, kw, want in (("bf16_off", off, (520, 16)),
                          ("mesh2", dict(mesh_shards=2), (537, 22))):
        per, c0, dt0, _ = _route(f"fused_{tag}_per_rung", bench,
                                 RouterOpts(batch_size=64, **kw))
        fres, c1, dt1, _ = _route(f"fused_{tag}", bench, RouterOpts(
            batch_size=64, fused_dispatch=True, **kw))
        runs += [c0, c1]
        _same_route(f"fused_{tag}", fres, per)
        if (fres.wirelength, fres.iterations) != want or c0 != c1:
            raise AssertionError(f"fused_{tag}: {fres.wirelength} / "
                                 f"{fres.iterations} (want {want}), "
                                 f"launches {c1} against {c0}")
        say("fused", f"bench {tag}: fused = per-rung ({want[0]} / "
                     f"{want[1]}), launches equal {c1}; {dt1:.2f} s fused, "
                     f"{dt0:.2f} s per-rung")
    # timing-driven with the analyzer (the device STA through the rungs)
    tim = {}
    for fz in (False, True):
        f = synth_flow(**BENCH_CFG)
        tres, c, dt = _timing_run_route(
            "fused_timing" if fz else "fused_timing_per_rung", f,
            RouterOpts(batch_size=64, fused_dispatch=fz))
        runs.append(c)
        tim[fz] = (tres, f.crit_path_delay, dt)
    _same_route("fused_timing", tim[True][0], tim[False][0])
    if tim[True][1] != tim[False][1] or \
            (tim[True][0].wirelength, tim[True][0].iterations) != (522, 22):
        raise AssertionError(f"fused_timing: crit path {tim[True][1]!r} "
                             f"against {tim[False][1]!r}")
    say("fused", f"bench timing-driven: fused = per-rung (522 / 22, crit "
                 f"path {tim[True][1]!r} s both); {tim[True][2]:.2f} s "
                 f"fused, {tim[False][2]:.2f} s per-rung")

    # ---- scale: fused = per-rung, path for path; then warm seconds of
    # the same Routers in turns
    import parallel_eda_tpu_torch.route.planes_kernels as pk
    import parallel_eda_tpu_torch.route.shard_kernels as sk

    routers, sres, launches = {}, {}, {}
    for fz in (False, True):
        routers[fz] = Router(scale.rr, RouterOpts(
            batch_size=64, fused_dispatch=fz), device="cuda")
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        sres[fz] = routers[fz].route(scale.term)
        launches[fz] = {**pk.launch_counts(), **sk.launch_counts()}
        check_route(scale.rr, scale.term, sres[fz].paths, occ=sres[fz].occ)
        runs.append(launches[fz])
    _same_route("fused_scale", sres[True], sres[False])
    if launches[True] != launches[False]:
        raise AssertionError(f"fused_scale: launches {launches[True]} "
                             f"against per-rung {launches[False]}")
    secs = {False: [], True: []}
    for fz in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.time()
        routers[fz].route(scale.term)
        torch.cuda.synchronize()
        secs[fz].append(time.time() - t0)
    say("fused", f"scale fused = per-rung (wirelength "
                 f"{sres[True].wirelength}, {sres[True].iterations} "
                 f"iterations, paths, occupancy, stats rows, sweeps), "
                 f"launches equal {launches[True]}; warm route s in turns "
                 f"per-rung {secs[False]}, fused {secs[True]}")

    # ---- multi: two jobs on the bench rr graph in lockstep
    pos_b = initial_placement(bench.pnl, bench.grid, seed=5)
    term_b = net_terminals(bench.pnl, bench.rr, pos_b,
                           bb_factor=bench.bb_factor)
    solo_b = Router(bench.rr, fused, device="cuda").route(term_b)
    check_route(bench.rr, term_b, solo_b.paths, occ=solo_b.occ)
    t0 = time.time()
    (ma, mb), calls = _lockstep(Router(bench.rr, fused, device="cuda"),
                                [(bench.term, fused), (term_b, fused)])
    torch.cuda.synchronize()
    dt = time.time() - t0
    _same_route("fused_multi_a", ma, res)
    _same_route("fused_multi_b", mb, solo_b)
    say("fused", f"multi: two jobs on the bench rr graph (its terminals "
                 f"and an initial placement from seed 5) in lockstep, "
                 f"{calls} route_window_planes_multi calls: job a = its "
                 f"solo fused route ({ma.wirelength} / {ma.iterations}), "
                 f"job b = its solo fused route ({mb.wirelength} / "
                 f"{mb.iterations}); {dt:.2f} s for both")
    if calls < 1:
        raise AssertionError("fused_multi: no multi call was made")

    def later():
        keys = ["planes_relax_full_kernel", "planes_relax_cropped_kernel"]
        got, want = {}, {}
        for fz in (False, True):
            r = Router(scale.rr, RouterOpts(
                batch_size=64, fused_dispatch=fz, max_router_iterations=2),
                device="cuda")
            pk.reset_launch_counts()
            r.route(scale.term)                  # counted, and warm
            c = pk.launch_counts()
            want[fz] = [c["planes_relax_full_cuda"],
                        c["planes_relax_cropped_cuda"]]
            got[fz] = _profiled_launches(
                functools.partial(r.route, scale.term), keys, want[fz])
        say("fused", f"scale, first window: K1/K2 launches by "
                     f"torch.profiler per-rung {got[False]}, fused "
                     f"{got[True]} (wrappers: {want[False]}, {want[True]})")
        if got[True] != got[False] or want[True] != want[False] or \
                [got[True][k] for k in keys] != want[True]:
            raise AssertionError("fused_scale: the profiler's K1/K2 "
                                 "launches differ between the modes")

    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}, later


RESIL_CHAOS = ("dispatch.error:3:20,dispatch.hang:2:20,checkpoint.corrupt:1:4,"
               "corpus.torn:1:4,backend.loss:1:6")
SERVE_CHAOS = "dispatch.error:2:4,dispatch.hang:1:4,checkpoint.corrupt:1:3"


def _resil_counts():
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk

    return {**pk.launch_counts(), **sk.launch_counts()}


def _guard_absorbed_only_plan(tag, m, fired):
    """Every failure the guard absorbed is a firing of the plan: injected
    errors and hangs against the guard's error and timeout counters, and
    no poisoned dispatch."""
    n_err = len(fired.get("dispatch.error", ()))
    n_hang = len(fired.get("dispatch.hang", ()))
    got = (m.get("route.resil.dispatch_errors", 0),
           m.get("route.resil.watchdog_timeouts", 0),
           m.get("route.resil.poisoned_dispatches", 0))
    if got != (n_err, n_hang, 0):
        raise AssertionError(f"{tag}: the guard absorbed (errors, timeouts, "
                             f"poisoned) {got}; the plan fired {n_err} "
                             f"errors and {n_hang} hangs")


def _service(tag, flow, opts, jobs, slice_iters, resil=None, runs=None):
    """``jobs`` [(name, terminals, tenant)] through a RouteService on the
    card; returns (the jobs in admission order, seconds, service)."""
    import torch

    from parallel_eda_tpu_torch.serve.service import (RouteService,
                                                      ServeJobSpec)

    _fresh_metrics()
    svc = RouteService(flow.rr, opts, slice_iters=slice_iters,
                       runs_dir=runs, scenario=tag, resil=resil,
                       device="cuda")
    for name, term, tenant in jobs:
        svc.admit(ServeJobSpec(term=term, name=name), tenant=tenant,
                  max_retries=3, job_id=name)
    torch.cuda.synchronize()
    t0 = time.time()
    done = svc.run()
    torch.cuda.synchronize()
    dt = time.time() - t0
    bad = [(j.job_id, j.state.value, j.error) for j in done
           if j.state.value != "done"]
    if bad:
        raise AssertionError(f"{tag}: jobs not done: {bad}")
    order = {name: k for k, (name, _, _) in enumerate(jobs)}
    return sorted(done, key=lambda j: order[j.job_id]), dt, svc


def phase_resil(bench, bench_res, scale, scale_res, rows, smi):
    """Resilience, devprof and the route service on the card (docstring,
    phase 19).  Returns the launch counts summed over its card work."""
    import torch

    from parallel_eda_tpu_torch.obs import get_devprof
    from parallel_eda_tpu_torch.place.initial import initial_placement
    from parallel_eda_tpu_torch.resil import (DispatchPoisonedError,
                                              FaultPlan, Resilience,
                                              ResilOpts)
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.rr.terminals import net_terminals

    work = os.path.join(BUILD_DIR, "resil")
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    runs = []
    opts = RouterOpts(batch_size=64)

    # no plain version on a CUDA tensor in any rung of this phase
    plain = {}

    def no_plain(name, fn):
        def run(*a, **k):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                raise AssertionError(f"{name} ran on a CUDA tensor")
            return fn(*a, **k)
        plain[name] = fn
        setattr(P, name, run)
    no_plain("planes_relax_plain", P.planes_relax_plain)
    no_plain("planes_relax_cropped_plain", P.planes_relax_cropped_plain)
    try:
        # ---- the model mode of kernel_layout = the card's auto mode
        # (the cases whose canvas the row names: a phase-10 case captured
        # from a route names no shape)
        widths = {k["cfg"]: k["shape"][0]
                  for k in rows["planes_relax_full_cuda"] if "shape" in k}
        checked = 0
        for name, kind in (("planes_relax_full_cuda", pk.FULL),
                           ("planes_relax_cropped_cuda", pk.TILE)):
            for c in rows[name]:
                key = "tile" if kind == pk.TILE else "shape"
                if key not in c or c["cfg"] not in widths:
                    continue
                W = widths[c["cfg"]]
                X, Y = c["tile"] if kind == pk.TILE else c["shape"][1:]
                checked += 1
                if pk.auto_mode(kind, W, X, Y) != c["mode"]:
                    raise AssertionError(
                        f"resil: kernel_layout's mode "
                        f"{pk.auto_mode(kind, W, X, Y)} != the card's "
                        f"{c['mode']} for {name} {c['cfg']} {X}x{Y}")
        if checked < 4:
            raise AssertionError(f"resil: {checked} kernel cases named "
                                 "their canvas")

        # ---- the guard without faults: the unguarded route's launches
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        g0 = Router(bench.rr, opts, device="cuda").route(bench.term)
        c_none = _resil_counts()
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        rt = Resilience(ResilOpts())
        g1 = Router(bench.rr, RouterOpts(batch_size=64, resil=rt),
                    device="cuda").route(bench.term)
        c_guard = _resil_counts()
        _same_route("resil_guard", g1, bench_res)
        _same_route("resil_none", g0, bench_res)
        if c_guard != c_none:
            raise AssertionError(f"resil_guard: launches {c_guard} != the "
                                 f"unguarded route's {c_none}")
        runs += [c_none, c_guard]
        # the guard's cost: warm bench routes unguarded and guarded (no
        # fault), in turns
        ru = Router(bench.rr, opts, device="cuda")
        rg = Router(bench.rr, RouterOpts(batch_size=64, resil=Resilience(
            ResilOpts())), device="cuda")
        ru.route(bench.term)
        rg.route(bench.term)
        secs = {"none": [], "guard": []}
        for tag, r in (("none", ru), ("guard", rg), ("guard", rg),
                       ("none", ru)):
            torch.cuda.synchronize()
            t0 = time.time()
            r.route(bench.term)
            torch.cuda.synchronize()
            secs[tag].append(time.time() - t0)
        per_win = ((sum(secs["guard"]) - sum(secs["none"])) / 2
                   / len(g1.stats) * 1e3)
        say("resil_guard", f"warm bench route s unguarded {secs['none']}, "
                           f"guarded (no fault) {secs['guard']}: "
                           f"{per_win:+.3f} ms per window over "
                           f"{len(g1.stats)} windows on {smi}")

        # ---- the kernel dimension: auto -> mode <= 1 -> mode 0
        modes = {}
        for n_err, label in ((2, "pallas_g1"), (4, "xla")):
            pk.reset_launch_counts()
            sk.reset_launch_counts()
            rt = Resilience(ResilOpts(fault_plan=FaultPlan(
                1, {"dispatch.error": (n_err, n_err)}), backoff_s=0.0))
            r = Router(bench.rr, RouterOpts(batch_size=64, resil=rt),
                       device="cuda").route(bench.term)
            _same_route(f"resil_{label}", r, bench_res)
            q = sorted(v for vs in rt.guard._quarantine.values() for v in vs)
            modes[label] = pk.mode_launch_counts()
            runs.append(_resil_counts())
            lo = 1 if label == "pallas_g1" else 0
            if sum(modes[label][w][lo] for w in modes[label]) <= 0 or \
                    any(modes[label][w][m] for w in modes[label]
                        for m in range(lo)):
                raise AssertionError(f"resil_{label}: launches per mode "
                                     f"{modes[label]}")
            want_q = ["jit"] if label == "pallas_g1" else ["jit",
                                                           "pallas_g1"]
            if q != want_q:
                raise AssertionError(f"resil_{label}: quarantined {q}")
        rt = Resilience(ResilOpts(fault_plan=FaultPlan(
            1, {"dispatch.error": (6, 6)}), backoff_s=0.0))
        try:
            Router(bench.rr, RouterOpts(batch_size=64, resil=rt),
                   device="cuda").route(bench.term)
            raise AssertionError("resil_poison: six errors on one dispatch "
                                 "did not poison it")
        except DispatchPoisonedError as e:
            poisoned = str(e)
        say("resil", f"bench guarded without faults = unguarded (537 / 22, "
                     f"the same launches {c_guard}); forced descent: "
                     f"jit quarantined -> pallas_g1 (mode <= 1) and jit, "
                     f"pallas_g1 quarantined -> xla (mode 0), each route "
                     f"= the bench route, launches per mode {modes}; six "
                     f"errors on one dispatch: {poisoned[:80]}; no plain "
                     f"version on a CUDA tensor")

        # ---- devprof: a stats_dir route's CUDA-event ms
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        sd = os.path.join(work, "stats")
        torch.cuda.synchronize()
        t0 = time.time()
        sres = Router(bench.rr, RouterOpts(batch_size=64, stats_dir=sd),
                      device="cuda").route(bench.term)
        dt = time.time() - t0
        runs.append(_resil_counts())
        if get_devprof().enabled:
            raise AssertionError("devprof stayed on after the route")
        with open(os.path.join(sd, "devprof.json")) as f:
            doc = json.load(f)
        # a variant whose dispatches found no dirty net launched nothing
        recs = [r for r in doc["records"] if "kernels" in r]
        if not recs or any(r["unavailable"] != "no kernel launches recorded"
                           for r in doc["records"] if "kernels" not in r):
            raise AssertionError(
                f"devprof: records {[r.get('unavailable') for r in doc['records']]}")
        per = {}
        for r in recs:
            for k, v in r["kernels"].items():
                a = per.setdefault(k, [0, 0.0])
                a[0] += v["launches"]
                a[1] += v["ms"]
        c_sd = runs[-1]
        for k, (n, _) in per.items():
            if n != c_sd[k]:
                raise AssertionError(f"devprof: {n} {k} events, "
                                     f"{c_sd[k]} launches")
        k1 = next(c for c in rows["planes_relax_full_cuda"]
                  if c["cfg"] == "bench" and "ms" in c)
        say("resil_devprof", f"bench stats_dir route ({sres.wirelength} / "
                             f"{sres.iterations}, {dt:.2f} s): "
                             f"{len(recs)} variants measured; per kernel "
                             f"launches and CUDA-event ms "
                             f"{json.dumps(per)}; K1 ms per launch "
                             f"{per['planes_relax_full_cuda'][1] / per['planes_relax_full_cuda'][0]:.4f} "
                             f"beside the kernel phase's bench K1 "
                             f"{k1['ms']:.4f} ms (B=64, {k1['sweeps']} "
                             f"sweeps); dominant {json.dumps(doc['summary'])}"
                             f" on {smi}")

        # ---- the route service: four jobs, two tenants, sliced
        terms = [("bench", bench.term, "t0")]
        for sd_ in (5, 6, 7):
            pos = initial_placement(bench.pnl, bench.grid, seed=sd_)
            terms.append((f"place{sd_}", net_terminals(
                bench.pnl, bench.rr, pos, bb_factor=bench.bb_factor),
                f"t{sd_ % 2}"))
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        solo, solo_s = {}, 0.0
        for name, term, _ in terms:
            t0 = time.time()
            solo[name] = (bench_res if name == "bench" else
                          Router(bench.rr, opts, device="cuda").route(term))
            solo_s += time.time() - t0
        jobs, dt_free, _ = _service("resil_serve", bench, opts, terms, 5)
        for j in jobs:
            _same_route(f"resil_serve {j.job_id}", j.result["result"],
                        solo[j.job_id], whole=False)
        if any(j.preemptions == 0 for j in jobs):
            raise AssertionError("resil_serve: a job was never preempted")
        runs.append(_resil_counts())
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        plan = FaultPlan.parse(7, RESIL_CHAOS)
        cjobs, dt_chaos, _ = _service(
            "resil_chaos", bench, opts, terms, 5, ResilOpts(
                fault_plan=plan, checkpoint_dir=os.path.join(work, "ck"),
                watchdog_s=10.0, backoff_s=0.01),
            runs=os.path.join(work, "runs"))
        runs.append(_resil_counts())
        for j in cjobs:
            _same_route(f"resil_chaos {j.job_id}", j.result["result"],
                        solo[j.job_id], whole=False)
        fired = plan.summary()["fired"]
        if len(fired) != 5:
            raise AssertionError(f"resil_chaos: fired {fired}")
        m = _metric_values("route.resil.")
        _guard_absorbed_only_plan("resil_chaos", m, fired)
        retried = _metric_values("route.serve.").get(
            "route.serve.jobs_retried", 0)
        if retried != len(fired["backend.loss"]):
            raise AssertionError(f"resil_chaos: {retried} job retries for "
                                 f"{fired['backend.loss']} backend losses")
        say("resil_serve", f"4 jobs, 2 tenants, sliced every 5 iterations, "
                           f"each = its solo card route "
                           f"{[(j.job_id, j.result['wirelength'], j.result['iterations'], j.preemptions) for j in jobs]}"
                           f"; {dt_free:.2f} s service ({dt_free / 4:.2f} s "
                           f"per job) beside {solo_s:.2f} s of solo routes; "
                           f"under the plan {json.dumps(fired)} the same "
                           f"jobs and paths in {dt_chaos:.2f} s, "
                           f"route.resil.* {json.dumps(m)}, "
                           f"{retried} job retries; on {smi}")
        # one job at mesh_shards=2: the loss lands it on one card
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        # the loss fires at the fourth window's mesh check (index 0 is
        # the slice's start): the cluster kernel ran before it
        mplan = FaultPlan(12, {"backend.loss": (1, 6)})
        mjobs, dt_m, msvc = _service(
            "resil_mesh", bench, RouterOpts(batch_size=64, mesh_shards=2),
            terms[:1], 0, ResilOpts(fault_plan=mplan))
        runs.append(_resil_counts())
        _same_route("resil_mesh", mjobs[0].result["result"], bench_res,
                    whole=False)
        mm = _metric_values("route.mesh.")
        cm = runs[-1]
        if msvc.resil.ladder.name("mesh") != "single_chip" or \
                mm.get("route.mesh.mesh_demotions", 0) < 1 or \
                mplan.summary()["fired"] != {"backend.loss": [4]} or \
                cm["planes_relax_cluster_cuda"] <= 0 or \
                cm["planes_relax_full_cuda"] <= 0:
            raise AssertionError(f"resil_mesh: ladder "
                                 f"{msvc.resil.ladder.snapshot()}, {mm}, "
                                 f"launches {cm}")
        say("resil_mesh", f"bench at mesh_shards=2 (cluster kernel) with a "
                          f"member lost at its fourth window: demoted to "
                          f"single_chip, = the bench route, {dt_m:.2f} s; "
                          f"{json.dumps(mm)}; launches {cm}")

        # ---- the scale config: one job, dispatch errors and a torn
        # checkpoint
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        splan = FaultPlan.parse(7, "dispatch.error:2:20,"
                                   "checkpoint.corrupt:1:2")
        sjobs, dt_s, _ = _service(
            "resil_scale", scale, opts, [("scale", scale.term, "t0")], 10,
            ResilOpts(fault_plan=splan,
                      checkpoint_dir=os.path.join(work, "ck_scale"),
                      watchdog_s=30.0, backoff_s=0.01))
        runs.append(_resil_counts())
        _same_route("resil_scale", sjobs[0].result["result"], scale_res,
                    whole=False)
        sfired = splan.summary()["fired"]
        if set(sfired) != {"dispatch.error", "checkpoint.corrupt"}:
            raise AssertionError(f"resil_scale: fired {sfired}")
        _guard_absorbed_only_plan("resil_scale",
                                  _metric_values("route.resil."), sfired)
        say("resil_scale", f"scale job through the service, sliced every "
                           f"10 iterations, under {json.dumps(sfired)}: "
                           f"wirelength {sjobs[0].result['wirelength']}, "
                           f"{sjobs[0].result['iterations']} iterations, "
                           f"paths = the scale route's; {dt_s:.2f} s on "
                           f"{smi}")
    finally:
        for name, fn in plain.items():
            setattr(P, name, fn)

    # ---- python -m parallel_eda_tpu_torch serve, with and without
    # chaos, both at once
    out, procs = {}, {}
    try:
        for tag, extra in (("free", []),
                           ("chaos", ["--chaos", SERVE_CHAOS])):
            ck = os.path.join(work, f"serve_ck_{tag}")
            logs = [open(os.path.join(work, f"serve_{tag}.{k}"), "w+")
                    for k in ("out", "err")]
            procs[tag] = (subprocess.Popen(
                [sys.executable, "-m", "parallel_eda_tpu_torch", "serve",
                 "--jobs", "2", "--luts", "15", "--slice", "3",
                 "--watchdog_s", "10", "--checkpoint_dir", ck] + extra,
                stdout=logs[0], stderr=logs[1], text=True), logs,
                time.time())
        t1, t_end = {}, time.time() + 300
        while len(t1) < len(procs):
            for tag, (p, _, _) in procs.items():
                if tag not in t1 and p.poll() is not None:
                    t1[tag] = time.time()
            if time.time() > t_end:
                raise AssertionError("resil serve: over 300 s")
            time.sleep(0.05)
        for tag, (p, logs, t0) in procs.items():
            rc, dt = p.returncode, t1[tag] - t0
            for f in logs:
                f.seek(0)
            stdout, stderr = (f.read() for f in logs)
            if rc != 0:
                raise AssertionError(f"serve {tag}: rc {rc}\n"
                                     f"{stderr[-3000:]}")
            doc = json.loads(stdout.strip().splitlines()[-1])
            out[tag] = ([(j["state"], j["wirelength"], j["iterations"])
                         for j in doc["jobs"]], dt, doc)
    finally:
        for p, logs, _ in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in logs:
                f.close()
    if out["chaos"][0] != out["free"][0] or any(
            st != "done" for st, _, _ in out["free"][0]):
        raise AssertionError(f"serve: chaos {out['chaos'][0]} != "
                             f"{out['free'][0]}")
    res_doc = out["chaos"][2]["resil"]
    say("resil_cli", f"python -m parallel_eda_tpu_torch serve (2 jobs, "
                     f"sliced every 3): rc 0, jobs {out['free'][0]} "
                     f"with and without --chaos '{SERVE_CHAOS}' "
                     f"(fired {json.dumps(res_doc['faults']['fired'])}, "
                     f"ladder {json.dumps(res_doc['ladder'])}); "
                     f"{out['free'][1]:.1f} s / {out['chaos'][1]:.1f} s "
                     f"per process, side by side")
    return {k: sum(r[k] for r in runs) for k in runs[0]}, (terms, solo)


# the serve phase's subprocess launcher: runs ``python -m
# parallel_eda_tpu_torch <args>`` and writes, at exit, the kernel launch
# counts, the seconds of CUDA library builds, the nvcc processes started
# and the library files the compile cache refused
_SERVE_CHILD = """\
import atexit, json, os, runpy, subprocess, sys, time
from parallel_eda_tpu_torch.obs import compile_seconds
from parallel_eda_tpu_torch.route import cuda_lib
from parallel_eda_tpu_torch.route import planes_kernels as pk
out = sys.argv.pop(1)
nvcc = []
_popen = subprocess.Popen.__init__
def popen(self, args, *a, **k):
    if os.path.basename(str(args[0])) == "nvcc":
        nvcc.append(" ".join(map(str, args[1:3])))
    _popen(self, args, *a, **k)
subprocess.Popen.__init__ = popen
def report():
    with open(out, "w") as f:
        json.dump({"launches": pk.launch_counts(),
                   "compile_s": compile_seconds(), "nvcc": nvcc,
                   "evicted": [e for lib in cuda_lib.LOADED
                               for e in lib.evicted],
                   "loaded": [lib.loaded_path for lib in cuda_lib.LOADED],
                   "t_exit": time.time()}, f)
atexit.register(report)
runpy.run_module("parallel_eda_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""
SERVE_ARGS = ["serve", "--jobs", "2", "--luts", "15", "--slice", "3",
              "--fused"]


_CHILDREN = []          # every _ServeChild started, stopped at exit


class _ServeChild:
    """One ``python -m parallel_eda_tpu_torch`` process through
    _SERVE_CHILD, started at once; ``result()`` waits and returns (its
    last stdout line as JSON, its exit report, wall seconds from start
    to exit, as _wait_all stamped it)."""

    def __init__(self, tag, work, args, timeout=600, nice=0):
        _CHILDREN.append(self)
        self.tag, self.timeout = tag, timeout
        self.counts = os.path.join(work, f"{tag}.counts.json")
        self.out = open(os.path.join(work, f"{tag}.out"), "w+")
        self.t0 = time.time()
        self.t1 = None
        self.p = subprocess.Popen(
            [sys.executable, "-c", _SERVE_CHILD, self.counts, *args],
            preexec_fn=(lambda: os.nice(nice)) if nice else None,
            env=dict(os.environ, PYTHONPATH=os.path.abspath(".")),
            stdout=self.out, stderr=subprocess.STDOUT, text=True)

    def kill(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait()
        self.out.close()

    def result(self):
        _wait_all([self])
        rc = self.p.returncode
        self.kill()
        dt = self.t1 - self.t0
        with open(self.out.name) as f:
            text = f.read()
        if rc != 0:
            raise AssertionError(f"serve {self.tag}: rc {rc}\n"
                                 f"{text[-4000:]}")
        with open(self.counts) as f:
            c = json.load(f)
        # the child's own exit time: its parent may look only later
        dt = min(dt, c["t_exit"] - self.t0)
        line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
        return json.loads(line), c, dt


def _wait_all(children):
    """Wait for every child, stamping each one's exit time."""
    while True:
        for c in children:
            if c.t1 is None and c.p.poll() is not None:
                c.t1 = time.time()
            if c.t1 is None and time.time() - c.t0 > c.timeout:
                c.kill()
                raise AssertionError(f"serve {c.tag}: over {c.timeout} s")
        if all(c.t1 is not None for c in children):
            return
        time.sleep(0.05)


def _job_rows(line):
    return [{k: v for k, v in j.items() if k not in ("route_s",
                                                      "nets_per_s")}
            for j in line["jobs"]]


def _daemon(work, tag, inbox, extra=(), nice=0):
    """``daemon run`` over ``inbox`` (two 6-LUT jobs, slice 2) with the
    serve phase's daemon library and compile cache."""
    return _ServeChild(tag, work, [
        "daemon", "run", "--inbox", inbox, "--luts", "6", "--slice", "2",
        "--heartbeat_s", "2.0", "--exit_when_idle", "2", "--summary",
        os.path.join(inbox, "summary.json"), "--library",
        os.path.join(work, "Ld"), "--compile_cache_dir",
        os.path.join(work, "Cd"), *extra], nice=nice)


def serve_cold_start():
    """The serve phase's two cold processes, started before the resil
    phase so that their nvcc builds (each into its own fresh cache) run
    beside it, at a lower priority: the exporting ``serve --fused``
    process and the uninterrupted daemon over two submitted jobs (the
    same two go into the inbox of the daemon that phase 20 kills)."""
    from types import SimpleNamespace

    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR
    from parallel_eda_tpu_torch.serve.daemon import submit_job

    t0 = time.time()
    work = os.path.join(BUILD_DIR, "serve")
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    lib, cc = os.path.join(work, "L"), os.path.join(work, "C")
    ref_box, box = os.path.join(work, "ref"), os.path.join(work, "box")
    for inbox in (ref_box, box):
        # the spec and line ``daemon submit`` writes
        for jid, seed in (("jobA", 3), ("jobB", 4)):
            submit_job(inbox, {"luts": 6, "chan_width": 16, "seed": seed,
                               "name": f"l6_s{seed}"}, job_id=jid)
    p_exp = _ServeChild("lib_export", work, SERVE_ARGS + [
        "--library", lib, "--compile_cache_dir", cc, "--export_library"],
        nice=10)
    p_ref = _daemon(work, "daemon_ref", ref_box, ("--export_library",),
                    nice=10)
    return SimpleNamespace(t0=t0, work=work, lib=lib, cc=cc, box=box,
                           p_exp=p_exp, p_ref=p_ref)


def phase_serve(bench, serve_jobs, smi, cold):
    """Continuous batching, the program library and the route daemon on
    the card (docstring, phase 20); ``cold`` is serve_cold_start()'s.
    Returns the launch counts of its in-process card work."""
    import shutil
    import signal

    import torch

    from parallel_eda_tpu_torch.resil import FaultPlan, ResilOpts
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.router import RouterOpts
    from parallel_eda_tpu_torch.serve.service import (RouteService,
                                                      ServeJobSpec)

    t_phase = time.time()
    work, lib, cc, box = cold.work, cold.lib, cold.cc, cold.box
    p_exp, p_ref = cold.p_exp, cold.p_ref
    terms, solo = serve_jobs
    opts = RouterOpts(batch_size=64)
    runs = []

    def states(doc):
        return {j["job_id"]: (j["state"], j.get("wirelength"),
                              j.get("iterations")) for j in doc["jobs"]}

    # ---- the program library and the route daemon, in fresh processes
    # (the library processes' seconds are taken beside a daemon
    # process's).  The export and the uninterrupted daemon, both cold,
    # have been building since the resil phase began
    _wait_all([p_exp, p_ref])
    first, c1, w1 = p_exp.result()
    ref, cr, wr = p_ref.result()
    # a copy of the library with an entry and its libplanes_relax copy
    # torn, its process (a fresh cache: it builds from source) beside
    # the in-process services
    lib_t = os.path.join(work, "Lt")
    shutil.copytree(lib, lib_t)
    with open(os.path.join(lib_t, "library.json")) as f:
        idx = json.load(f)
    kid, meta = sorted(idx["entries"].items())[0]
    so = idx["libs"]["planes_relax"]
    for rel in (meta["file"], so["file"]):
        path = os.path.join(lib_t, rel)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    p_torn = _ServeChild("lib_torn", work, SERVE_ARGS + [
        "--library", lib_t, "--compile_cache_dir",
        os.path.join(work, "C3")], nice=10)

    # ---- continuous batching: the resil phase's four jobs, fused
    multi_k1 = [0, 0]
    real_multi = P.route_window_planes_multi

    def counted_multi(*a, **k):
        n0 = pk.planes_relax_full_cuda.launches
        out = real_multi(*a, **k)
        multi_k1[0] += 1
        multi_k1[1] += pk.planes_relax_full_cuda.launches - n0
        return out

    def service(fused, resil=None):
        reg = _fresh_metrics()
        svc = RouteService(bench.rr, opts, slice_iters=5, fused=fused,
                           resil=resil, device="cuda")
        for name, term, tenant in terms:
            svc.admit(ServeJobSpec(term=term, name=name), tenant=tenant,
                      job_id=name)
        torch.cuda.synchronize()
        t0 = time.time()
        done = svc.run()
        torch.cuda.synchronize()
        dt = time.time() - t0
        for j in done:
            if j.state.value != "done":
                raise AssertionError(f"serve_fused: {j.job_id} "
                                     f"{j.state.value} {j.error}")
            _same_route(f"serve_fused {j.job_id} fused={fused}",
                        j.result["result"], solo[j.job_id], whole=False)
        return dt, reg.values("route.serve.fused."), svc

    P.route_window_planes_multi = counted_multi
    try:
        # in turns: fused, interleaved, interleaved, fused; the first
        # run's multi calls and counters are the ones reported
        secs = {False: [], True: []}
        for k, fz in enumerate((True, False, False, True)):
            pk.reset_launch_counts()
            sk.reset_launch_counts()
            dt, vals, svc = service(fz)
            secs[fz].append(dt)
            runs.append(_resil_counts())
            if k == 0:
                fv, k1 = vals, list(multi_k1)
                rebatch = svc.rebatch_summary()["counters"]
        if fv.get("route.serve.fused.dispatches", 0) <= 0 or \
                fv["route.serve.fused.jobs"] < \
                2 * fv["route.serve.fused.dispatches"]:
            raise AssertionError(f"serve_fused: {fv}")
        # a dispatch.error firing at its first invocation: the merged
        # site of the first lockstep step
        pk.reset_launch_counts()
        sk.reset_launch_counts()
        plan = FaultPlan.parse(7, "dispatch.error:1:1")
        dt_f, cv, _ = service(True, ResilOpts(fault_plan=plan,
                                              backoff_s=0.0))
        runs.append(_resil_counts())
    finally:
        P.route_window_planes_multi = real_multi
    if cv.get("route.serve.fused.fallbacks", 0) < 1 or \
            plan.summary()["fired"] != {"dispatch.error": [0]}:
        raise AssertionError(f"serve_fused_fallback: {cv}, fired "
                             f"{plan.summary()['fired']}")
    say("serve_fused", f"RouteService(fused=True), the resil phase's 4 "
                       f"bench-graph jobs sliced every 5 iterations: each "
                       f"= its solo card route "
                       f"{[(n, solo[n].wirelength, solo[n].iterations) for n, _, _ in terms]}"
                       f"; {json.dumps(fv)}; {k1[0]} multi calls, {k1[1]} "
                       f"K1 launches inside them; service s in turns "
                       f"fused {secs[True]}, interleaved {secs[False]}; "
                       f"under dispatch.error at the merged site the same "
                       f"4 routes, fallbacks "
                       f"{cv['route.serve.fused.fallbacks']}, {dt_f:.2f} s; "
                       f"rebatch {json.dumps(rebatch)}"
                       f" on {smi}")

    # the warm library process beside the daemon that is killed -9 after
    # its first durable checkpoint
    p_warm = _ServeChild("lib_warm", work, SERVE_ARGS + [
        "--library", lib, "--compile_cache_dir", cc])
    p_kill = _daemon(work, "daemon_kill", box)
    ck = os.path.join(box, "ckpt")
    try:
        t_end = time.time() + 300
        while not (os.path.isdir(ck) and any(
                n.endswith(".ck") for n in os.listdir(ck))):
            if p_kill.p.poll() is not None or time.time() > t_end:
                raise AssertionError(f"daemon_kill: no durable checkpoint "
                                     f"before exit ({p_kill.p.poll()})")
            for c in (p_warm, p_torn):
                if c.t1 is None and c.p.poll() is not None:
                    c.t1 = time.time()
            time.sleep(0.02)
        os.kill(p_kill.p.pid, signal.SIGKILL)
    finally:
        p_kill.kill()
    if os.path.exists(os.path.join(box, "summary.json")):
        raise AssertionError("daemon_kill: the daemon finished before the "
                             "kill")
    p_restart = _daemon(work, "daemon_restart", box)
    second, c2, w2 = p_warm.result()
    if c2["compile_s"] != 0 or c2["nvcc"] or \
            second["dispatch_compiles"] != 0 or \
            second["serve"].get("route.serve.aot_hits", 0) <= 0 or \
            _job_rows(second) != _job_rows(first) or \
            first["library_exported"] <= 0:
        raise AssertionError(f"serve_library warm: compile_s "
                             f"{c2['compile_s']}, nvcc {c2['nvcc']}, "
                             f"compiles {second['dispatch_compiles']}, "
                             f"{second['serve']}, jobs {_job_rows(second)} "
                             f"vs {_job_rows(first)}")
    _wait_all([p_torn, p_restart])
    third, c3, w3 = p_torn.result()
    got, cg, wg = p_restart.result()
    if _job_rows(third) != _job_rows(first) or c3["compile_s"] <= 0 or \
            third["serve"].get("route.serve.aot_errors", 0) < 2 or \
            any(p.startswith(lib_t) for p in c3["loaded"]):
        raise AssertionError(f"serve_library torn: {third['serve']}, "
                             f"{c3}")
    say("serve_library", f"serve --fused (2 jobs, 15 LUTs, slice 3) with "
                         f"--library and --compile_cache_dir: export "
                         f"process {w1:.1f} s (compile_seconds "
                         f"{c1['compile_s']:.1f}, nvcc {c1['nvcc']}, "
                         f"{first['library_exported']} entries); fresh "
                         f"process {w2:.1f} s (compile_seconds "
                         f"{c2['compile_s']}, no nvcc, "
                         f"dispatch_compiles 0, aot_hits "
                         f"{second['serve']['route.serve.aot_hits']}), the "
                         f"same jobs; entry {kid} and the library's "
                         f"libplanes_relax copy truncated in a copy of "
                         f"the library, fresh cache: "
                         f"{w3:.1f} s, both evicted before load "
                         f"(aot_errors "
                         f"{third['serve']['route.serve.aot_errors']}), "
                         f"rebuilt from source (compile_seconds "
                         f"{c3['compile_s']:.1f}), the same jobs; K1 "
                         f"launches {c1['launches']['planes_relax_full_cuda']}"
                         f" / {c2['launches']['planes_relax_full_cuda']} / "
                         f"{c3['launches']['planes_relax_full_cuda']}; "
                         f"the export beside the cold daemon, both at nice "
                         f"10 during the resil phase, the torn one (nice "
                         f"10) beside the in-process services, the fresh "
                         f"one beside the killed daemon, on {smi}")
    if states(got) != states(ref) or any(
            st != "done" for st, _, _ in states(ref).values()) or \
            got["daemon"]["metrics"].get("route.daemon.recovered", 0) <= 0:
        raise AssertionError(f"daemon: restart {states(got)} vs "
                             f"uninterrupted {states(ref)}, "
                             f"{got['daemon']['metrics']}")
    if cg["compile_s"] != 0 or cg["nvcc"]:
        raise AssertionError(f"daemon restart built: {cg}")
    say("serve_daemon", f"python -m parallel_eda_tpu_torch daemon run (2 "
                        f"jobs at 6 LUTs, slice 2) on the card: "
                        f"uninterrupted {states(ref)} in {wr:.1f} s, "
                        f"heartbeat max_gap cold "
                        f"{ref['daemon']['heartbeat']['max_gap_s']} s "
                        f"(compile_seconds {cr['compile_s']:.1f}); killed "
                        f"-9 after its first durable checkpoint and "
                        f"restarted: the same states and wirelengths, "
                        f"recovered "
                        f"{got['daemon']['metrics']['route.daemon.recovered']}"
                        f", {wg:.1f} s, max_gap warm (library + compile "
                        f"cache) {got['daemon']['heartbeat']['max_gap_s']} "
                        f"s, no build; "
                        f"phase {time.time() - t_phase:.1f} s on {smi}")
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# the bench's QorRow on the port's CPU (device="cpu"), equal to the JAX
# package's under --xla_cpu_max_isa=AVX: the device route is the timing
# phase's (522 / 22), the serial oracle's passes end at 465 wires after
# 13 iterations in all
QOR_BENCH = dict(device_cpd=4.552000110180643e-09,
                 serial_cpd=4.673999853821442e-09, device_wl=522,
                 serial_wl=465, device_iters=22, serial_iters=13)


def phase_qor(bench, smi):
    """The serial QoR oracle (docstring, phase 21).  Returns the launch
    counts of its card route."""
    import torch

    from parallel_eda_tpu_torch.route import QorRow, qor_compare
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import shard_kernels as sk
    from parallel_eda_tpu_torch.route.router import RouterOpts
    from parallel_eda_tpu_torch.route.serial_native import (
        NativeSerialRouter, native_available)
    from parallel_eda_tpu_torch.route.serial_ref import SerialRouter

    t_phase = time.time()
    if not native_available():
        raise AssertionError("qor: native/serial_route.cc did not build")
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    row = qor_compare(bench, "bench", RouterOpts(batch_size=64),
                      device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = _resil_counts()
    if not isinstance(row, QorRow) or \
            {k: getattr(row, k) for k in QOR_BENCH} != QOR_BENCH:
        raise AssertionError(f"qor: {row} against the CPU row {QOR_BENCH}")
    if counts["planes_relax_full_cuda"] <= 0:
        raise AssertionError(f"qor: the device route launched no K1 "
                             f"{counts}")
    # the native core against the Python oracle, tree for tree: the
    # congestion-only route and one with criticalities from a seed
    rng = np.random.default_rng(0)
    crit = (rng.uniform(0, 0.9, bench.term.sinks.shape)
            * (bench.term.sinks >= 0)).astype(np.float32)
    secs = []
    for c in (None, crit):
        rp = SerialRouter(bench.rr).route(bench.term, crit=c)
        rn = NativeSerialRouter(bench.rr).route(bench.term, crit=c)
        if not (rp.success and rn.success
                and (rp.iterations, rp.heap_pops, rp.wirelength)
                == (rn.iterations, rn.heap_pops, rn.wirelength)
                and np.array_equal(rp.occ, rn.occ)
                and [sorted(t) for t in rp.trees]
                == [sorted(t) for t in rn.trees]):
            raise AssertionError(f"qor: native serial route differs from "
                                 f"SerialRouter (crit "
                                 f"{'on' if c is not None else 'off'}): "
                                 f"{rn.wirelength}/{rn.iterations} vs "
                                 f"{rp.wirelength}/{rp.iterations}")
        secs.append((rp.wirelength, rp.iterations, rp.heap_pops,
                     round(rp.route_time_s, 4), round(rn.route_time_s, 4)))
    say("qor", f"qor_compare(bench) with the device route on the card: "
               f"device {row.device_wl} / {row.device_iters} crit path "
               f"{row.device_cpd!r} s in {row.device_windows} windows, "
               f"serial {row.serial_wl} / {row.serial_iters} crit path "
               f"{row.serial_cpd!r} s (= the port's CPU row): crit path "
               f"{row.cpd_delta_pct:+.3f}%, wirelength "
               f"{row.wl_delta_pct:+.3f}%, {dt:.2f} s, K1 launches "
               f"{counts['planes_relax_full_cuda']}; NativeSerialRouter = "
               f"SerialRouter tree for tree on the bench problem, "
               f"(wirelength, iterations, heap pops, SerialRouter s, "
               f"native s) crit off {secs[0]}, crit on {secs[1]}; phase "
               f"{time.time() - t_phase:.1f} s on {smi}")
    return counts


FLEET_JOBS = (("fj3", "t0", 3), ("fj4", "t1", 4), ("fj5", "t2", 5),
              ("fj6", "t3", 6))


def _shard_spans(path, cat):
    """(count, seconds) of a trace shard's complete spans of ``cat``."""
    try:
        with open(path) as f:
            evs = json.load(f).get("traceEvents") or []
    except (OSError, ValueError):
        return None
    sp = [e for e in evs if e.get("ph") == "X" and e.get("cat") == cat]
    return len(sp), round(sum(e.get("dur", 0.0) for e in sp) / 1e6, 3)


def phase_fleet(smi):
    """The fleet on one card (docstring, phase 22)."""
    from parallel_eda_tpu_torch.route.cuda_lib import BUILD_DIR
    from parallel_eda_tpu_torch.serve.daemon import submit_job
    from parallel_eda_tpu_torch.serve.transport import TransportClient

    t_phase = time.time()
    work = os.path.join(BUILD_DIR, "fleet")
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    # the serve phase's daemon library (6-LUT variants and the .so copies)
    lib = os.path.join(BUILD_DIR, "serve", "Ld")
    if not os.path.exists(os.path.join(lib, "library.json")):
        raise AssertionError(f"fleet: no exported library at {lib}")

    def spec(seed):
        return {"luts": 6, "chan_width": 16, "seed": seed,
                "name": f"l6_s{seed}"}

    solo, box = os.path.join(work, "solo"), os.path.join(work, "box")
    for jid, tenant, seed in FLEET_JOBS:
        submit_job(solo, spec(seed), tenant=tenant, job_id=jid)
    summary = os.path.join(box, "fleet.json")
    # the fleet, and beside it the solo card daemon over the same jobs;
    # each over the library with a fresh compile cache
    p_fleet = _ServeChild("fleet", work, [
        "daemon", "fleet", "--inbox", box, "--workers", "2", "--luts", "6",
        "--slice", "2", "--device", "cuda", "--library", lib,
        "--cache_base", os.path.join(work, "cb"), "--expect_jobs",
        str(len(FLEET_JOBS)), "--tick_s", "0.05", "--chaos",
        "transport.drop:1,worker.kill:1", "--trace", "--timeout_s", "300",
        "--summary", summary], timeout=420)
    p_solo = _ServeChild("fleet_solo", work, [
        "daemon", "run", "--inbox", solo, "--luts", "6", "--slice", "2",
        "--heartbeat_s", "2.0", "--exit_when_idle", "2", "--summary",
        os.path.join(solo, "summary.json"), "--library", lib,
        "--compile_cache_dir", os.path.join(work, "Csolo")], timeout=420)
    try:
        url_doc = os.path.join(box, "transport.json")
        t_end = time.time() + 120
        while not os.path.exists(url_doc):
            if p_fleet.p.poll() is not None or time.time() > t_end:
                raise AssertionError(f"fleet: no transport.json "
                                     f"({p_fleet.p.poll()})")
            time.sleep(0.02)
        with open(url_doc) as f:
            client = TransportClient(json.load(f)["url"], max_attempts=4,
                                     backoff_s=0.05)
        for jid, tenant, seed in FLEET_JOBS:
            if client.submit(spec(seed), tenant=tenant, job_id=jid) != jid:
                raise AssertionError(f"fleet: submit {jid}")
        _wait_all([p_fleet, p_solo])
        doc, cf, wf = p_fleet.result()
        ref, cs, ws = p_solo.result()
    finally:
        p_fleet.kill()
        p_solo.kill()
    fl = doc["fleet"]
    done = [j for j in doc["jobs"] if j["state"] == "done"]

    def rows(d):
        return {j["job_id"]: (j["state"], j.get("wirelength"),
                              j.get("iterations"))
                for j in d["jobs"] if j["state"] == "done"}

    m = fl["metrics"]
    want = sorted(j for j, _, _ in FLEET_JOBS)
    problems = []
    if sorted(j["job_id"] for j in done) != want:
        problems.append(f"done rows {sorted(j['job_id'] for j in done)}")
    if sorted(fl["leases"]) != want or not all(
            v["released"] for v in fl["leases"].values()):
        problems.append(f"leases {fl['leases']}")
    if rows(doc) != rows(ref) or len(rows(ref)) != len(want):
        problems.append(f"jobs {rows(doc)} vs solo {rows(ref)}")
    if m.get("route.fleet.workers_killed") != 1 or len(fl["killed"]) != 1 \
            or m.get("route.fleet.jobs_failed_over", 0) < 1:
        problems.append(f"kill/failover {fl['killed']} {m}")
    tp = fl["transport"]
    if (tp["drops"], tp["retries"]) != (1, 1) or client.retries != 1:
        problems.append(f"transport {tp}, client retries {client.retries}")
    dr = subprocess.run([sys.executable, os.path.join(
        "tools", "flow_doctor.py"), "--fleet-summary", summary],
        capture_output=True, text=True, timeout=120)
    if dr.returncode != 0:
        problems.append(f"flow_doctor: {dr.stdout[-1500:]}"
                        f"{dr.stderr[-1500:]}")
    # per worker: builds and nvcc runs from its trace shard, the
    # heartbeat's max_gap from its summary (none for the killed one)
    workers = {}
    stolen = 0
    for w in fl["roster"]:
        shard = os.path.join(box, f"trace.{w}.json")
        b, n = _shard_spans(shard, "cuda.build"), _shard_spans(
            shard, "cuda.nvcc")
        ws_path = os.path.join(box, f"summary.{w}.json")
        gap = None
        if os.path.exists(ws_path):
            with open(ws_path) as f:
                wdoc = json.load(f)
            gap = wdoc["daemon"]["heartbeat"].get("max_gap_s")
            stolen += sum(1 for j in wdoc["jobs"]
                          if (j.get("shed_cause") or {}).get("code")
                          == "lease_stolen")
        workers[w] = {"killed": w in fl["killed"],
                      "exit": fl["workers"][w]["exit_code"],
                      "compile_s": b[1] if b else None,
                      "builds": b[0] if b else None,
                      "nvcc_version_runs": n[0] if n else None,
                      "max_gap_s": gap}
        if b is None or n is None or b[0] != 0 or n[0] != 0:
            problems.append(f"{w}: nvcc in the worker (builds {b}, "
                            f"--version {n})")
    if cs["compile_s"] != 0 or cs["nvcc"]:
        problems.append(f"solo daemon built: {cs}")
    if problems:
        for w in fl["roster"]:
            with open(os.path.join(box, f"worker.{w}.log")) as f:
                problems.append(f"worker.{w}.log: {f.read()[-2000:]}")
        raise AssertionError("fleet: " + "; ".join(problems))
    say("fleet", f"daemon fleet --workers 2 --device cuda (4 jobs at 6 "
                 f"LUTs, slice 2, through the TransportClient under "
                 f"transport.drop:1,worker.kill:1; the serve phase's "
                 f"library, a fresh --cache_base): {rows(doc)} = the solo "
                 f"card daemon's (beside it, {ws:.1f} s), each released "
                 f"once; killed {fl['killed']}, failed over "
                 f"{m['route.fleet.jobs_failed_over']}, lease steals "
                 f"{m.get('route.fleet.lease_steals')}, leases expired "
                 f"{m.get('route.fleet.leases_expired')}, lease_stolen "
                 f"sheds {stolen}; transport {tp['requests']} requests, "
                 f"{tp['drops']} drop, {tp['retries']} retry; workers "
                 f"{json.dumps(workers)}; trace merged "
                 f"{(fl.get('trace') or {}).get('events')} events; "
                 f"flow_doctor --fleet-summary HEALTHY; fleet process "
                 f"{wf:.1f} s, phase {time.time() - t_phase:.1f} s on "
                 f"{smi}")


# the 15-LUT parity netlist (tests/test_torch_long_lines.py) placed on
# grids with a side past the old 64-cell scan line limit
LONG_NETLIST = dict(num_luts=15, num_inputs=6, num_outputs=6, seed=3)
LONG_ROUTES = ((6, 72), (72, 6), (66, 66))


def _long_flow(nx, ny):
    from parallel_eda_tpu_torch.arch.builtin import minimal_arch
    from parallel_eda_tpu_torch.flow import prepare
    from parallel_eda_tpu_torch.netlist.generate import generate_circuit

    arch = minimal_arch(chan_width=10)
    return prepare(generate_circuit(K=arch.K, **LONG_NETLIST), arch, 10,
                   nx=nx, ny=ny)


# the port's CPU reference routes (device="cpu"), made in a pool of two
# spawned workers that main starts before the bench route, so that they
# run beside the card phases; each phase that holds a card route against
# one of them waits for it.  Submitted longest first
CPU_REFS = ("ell_mid", "long 72x6", "long 6x72", "fused_bench",
            "ell_bench", "ell_bench_global", "ell_timing", "place_bench",
            "place_bench_timing")
_REFS = {}


def _route_fields(r, seconds, **extra):
    """What _same_route and _ell_same compare of a RouteResult ``r``,
    with the route's seconds."""
    from types import SimpleNamespace

    stats = [SimpleNamespace(**{k: getattr(st, k) for k in (
        "iteration", "overused_nodes", "overuse_total", "rerouted_nets",
        "relax_steps", "batches", "overuse_pct")}) for st in r.stats]
    return SimpleNamespace(
        wirelength=r.wirelength, iterations=r.iterations, paths=r.paths,
        occ=r.occ, congestion=r.congestion, stats=stats,
        total_relax_steps=r.total_relax_steps, sink_delay=r.sink_delay,
        windowed_nets=r.windowed_nets, widened_nets=r.widened_nets,
        seconds=seconds, **extra)


def _cpu_ref(name):
    """One of CPU_REFS, in a worker of the reference pool (one torch
    thread, at the lowest priority, so that the card phases' host work
    keeps its cores): the long-line fixture on a thin grid (phase 23), the ELL
    program's bench routes, windowed, global and timing-driven, and its
    mid-size config (phase 17), the bench's fused route (phase 18); or
    the bench's placement, wirelength-only and timing-driven (phase
    10b): its positions, temperature rows, final cost and est crit
    path, and its seconds."""
    from types import SimpleNamespace

    import torch

    from parallel_eda_tpu_torch.flow import (run_place, run_place_native,
                                             run_route, synth_flow)
    from parallel_eda_tpu_torch.place.sa import PlacerOpts
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    torch.set_num_threads(1)
    if name.startswith("place_bench"):
        timing = name == "place_bench_timing"
        t0 = time.perf_counter()
        f = run_place(synth_flow(**BENCH_CFG),
                      PlacerOpts() if timing else PlacerOpts(seed=3),
                      timing_driven=timing, device="cpu")
        st = f.place_stats
        return SimpleNamespace(
            pos=f.pos, place_stats=SimpleNamespace(
                temps=st.temps, final_cost=st.final_cost,
                est_crit_path=st.est_crit_path),
            seconds=time.perf_counter() - t0)
    if name == "ell_timing":
        f = synth_flow(**BENCH_CFG)
        run_route(f, RouterOpts(batch_size=64, program="ell"),
                  timing_driven=True, device="cpu")
        return _route_fields(f.route, f.times["route"],
                             crit_path_delay=f.crit_path_delay)
    if name.startswith("long "):
        nx, ny = map(int, name[5:].split("x"))
        f, opts = _long_flow(nx, ny), RouterOpts(batch_size=32)
    elif name == "ell_mid":
        f = run_place_native(synth_flow(**ELL_MID_CFG))
        opts = RouterOpts(batch_size=64, program="ell")
    elif name == "fused_bench":
        f = synth_flow(**BENCH_CFG)
        opts = RouterOpts(batch_size=64, fused_dispatch=True)
    else:
        f = synth_flow(**BENCH_CFG)
        opts = RouterOpts(batch_size=64, program="ell",
                          windowed=name == "ell_bench")
    t0 = time.time()
    r = Router(f.rr, opts, device="cpu").route(f.term)
    if not r.success:
        raise AssertionError(f"{name}: the CPU route did not converge")
    return _route_fields(r, time.time() - t0)


def _start_cpu_refs():
    pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"),
                               initializer=os.nice, initargs=(19,))
    for name in CPU_REFS:
        _REFS[name] = pool.submit(_cpu_ref, name)
    _REFS["pool"] = pool


def _cpu_result(name):
    """The reference route ``name``, waiting for it if need be."""
    t0 = time.time()
    r = _REFS.pop(name).result()
    if time.time() - t0 > 1:
        say("refs", f"waited {time.time() - t0:.1f} s for the CPU "
                    f"reference {name}")
    return r


def _stop_children():
    """Stop the reference pool's workers and every serve child still
    running (on a failure, mid-route)."""
    for c in _CHILDREN:
        if c.p.poll() is None:
            c.p.kill()
            c.p.wait()
    pool = _REFS.pop("pool", None)
    if pool is None:
        return
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(10)


def _long_cluster_case(rows, cfg, pg, s, kind, pd, inst, B, nsw):
    """The cluster kernel on a long-line canvas against the plain
    per-sweep loop on the card, in every shared-memory mode that fits
    (on jittered costs timed)."""
    import torch

    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route import planes_shard as TS

    W, NX, NYp1 = pg.shape_x
    mesh = TS.make_row_mesh(s, "ppermute", [inst[0].device] * s)
    run = functools.partial(pk.planes_relax_cluster_cuda, pg, *inst,
                            TS.sweep_cap(nsw, s), s, plane_dtype=pd)
    got = run()
    torch.cuda.synchronize()
    auto = pk.planes_relax_cluster_cuda.last_mode
    per_net = pk.planes_relax_cluster_cuda.last_stats[:-1].cpu().numpy()
    tag = f"cluster {cfg} s={s} {kind} {pd}"
    plain, plain_ms = _timed(functools.partial(
        TS.planes_relax_sharded_plain, pg, *inst, nsw, mesh, pd))
    err = _same(f"{tag} vs plain", got, plain)
    for m in range(auto):
        err = max(err, _same(f"{tag} mode {m} vs plain", run(mode=m),
                             plain))
    case = dict(cfg=cfg, shards=s, costs=kind, plane_dtype=pd, B=B,
                block=[W, TS.row_block_cols(pg, s) + 2, NYp1 - 1],
                mode=auto, sweeps=got[3].tolist(), max_abs_err=err)
    if kind == "jitter":
        case["ms"] = cuda_ms(run, 20)
        case["plain_ms"] = plain_ms
        device_later(tag, case, "device_us", run, "planes_relax_cluster")
        case.update(bound_ms(pg, B, per_net[:, 0],
                             plane_bytes=2 if pd == "bf16" else 4))
    rows.setdefault("planes_relax_cluster_cuda"
                    + (BF16 if pd == "bf16" else ""), []).append(case)
    say("long_lines", f"{tag}: bit-identical to the plain loop in every "
                      "mode, " + json.dumps(case))


def _long_kernel_cases(rows, graphs):
    """phase_long_lines (a): every kernel at the long shapes against its
    plain version, jittered costs in f32 (timed) and crit > 0 in bf16
    (the gpu tests hold every pairing): K1 on each graph but 10x160, K2
    on 8x128 tiles of 10x160, the cluster and the peer kernel on
    6x72."""
    import torch

    from parallel_eda_tpu_torch.route import planes as P

    rng = np.random.default_rng(16)
    B, nsw = 32, 64
    for cfg, rr in graphs.items():
        pg = P.build_planes(rr, "cuda")
        W, NX, NYp1 = pg.shape_x
        tiles = [(8, 128)] if cfg == "10x160" else []
        for kind, pd in (("jitter", "f32"), ("crit", "bf16")):
            inst = _instance(rr, pg, B, rng, False, crit_on=kind == "crit")
            origins = {t: tuple(torch.from_numpy(rng.integers(
                -t[i] - 3, n - t[i] + 4, B).astype(np.int32)).cuda()
                for i, n in ((0, NX), (1, NYp1 - 1))) for t in tiles}
            _kernel_cases(rows, cfg, kind, pd, pg, inst, nsw, tiles,
                          origins, B, k1_case=not tiles)
            if cfg != "6x72":
                continue
            sfx = BF16 if pd == "bf16" else ""
            for s in (2, 4):
                _long_cluster_case(rows, cfg, pg, s, kind, pd, inst, B, nsw)
                for impl in ("ppermute", "pallas_halo"):
                    rows["planes_relax_peer_cuda" + sfx].append(_peer_case(
                        cfg, pg, s, kind, pd, impl, inst, B, nsw,
                        rows["planes_relax_peer_cuda"]))


def phase_long_lines(rows, smi):
    """Grids with a side past the old 64-cell scan line limit (docstring,
    phase 23).  Adds its kernel cases to ``rows``; returns the launch
    counts of its card routes."""
    from parallel_eda_tpu_torch.arch.builtin import minimal_arch
    from parallel_eda_tpu_torch.route import planes_kernels as pk
    from parallel_eda_tpu_torch.route.router import RouterOpts
    from parallel_eda_tpu_torch.rr.graph import build_rr_graph
    from parallel_eda_tpu_torch.rr.grid import DeviceGrid

    t_phase = time.time()
    flows = {f"{nx}x{ny}": _long_flow(nx, ny) for nx, ny in LONG_ROUTES}
    arch = minimal_arch(chan_width=10)
    graphs = {k: f.rr for k, f in flows.items()}
    for nx, ny in ((6, 63), (10, 160)):
        graphs[f"{nx}x{ny}"] = build_rr_graph(
            arch, DeviceGrid(nx, ny, arch.io_capacity))
    _long_kernel_cases(rows, graphs)
    say("long_lines", f"kernels at the long shapes bit-identical, "
                      f"{time.time() - t_phase:.1f} s")
    # the thin grids' CPU routes, from the reference pool
    cpu = {f"{nx}x{ny}": _cpu_result(f"long {nx}x{ny}")
           for nx, ny in LONG_ROUTES[:2]}
    # ---- (b) the thin grids routed on the card = the port's CPU route,
    # single-device and at mesh_shards=2 (lag 1 the cluster kernel, lag
    # 2 the peer kernel); (c) the 66 x 66 grid routed on the card
    counts = []
    opts = RouterOpts(batch_size=32)
    for cfg, want in cpu.items():
        runs = [(cfg, opts, None)]
        if cfg == "6x72":
            mesh = RouterOpts(batch_size=32, mesh_shards=2)
            runs += [(f"{cfg} mesh2", mesh, None),
                     (f"{cfg} mesh2_lag2", mesh, "pallas_halo")]
        for tag, o, impl in runs:
            res, c, dt, _ = _route(f"long_lines {tag}", flows[cfg], o, impl)
            # the sharded relaxation counts sweeps of its own (stats
            # rows and sweeps), as in the mesh phase
            _same_route(f"long_lines {tag}", res, want,
                        whole=o.mesh_shards <= 1)
            counts.append(c)
            say("long_lines", f"{tag}: = the port's CPU route "
                              f"({want.wirelength} / {want.iterations}, "
                              f"CPU {want.seconds:.2f} s; paths, occupancy"
                              + (")" if o.mesh_shards > 1 else
                                 ", stats rows, sweeps)")
                              + f", card {dt:.2f} s")
    res, c, dt, _ = _route("long_lines 66x66", flows["66x66"], opts)
    counts.append(c)
    say("long_lines", f"66x66: legal, wirelength {res.wirelength}, "
                      f"{res.iterations} iterations, {dt:.2f} s on the "
                      f"card (K1 mode {pk.planes_relax_full_cuda.last_mode})"
                      f"; phase {time.time() - t_phase:.1f} s on {smi}")
    return counts


def _metric_values(prefix):
    from parallel_eda_tpu_torch.obs import get_metrics

    return get_metrics().values(prefix)


def main(argv) -> int:
    cards = argv == ["--cards"]
    if argv and not cards:
        print("usage: python3 chip_smoke.py [--cards]", file=sys.stderr)
        return 2
    smi = phase_card()
    import torch

    from parallel_eda_tpu_torch.flow import run_place_native, synth_flow
    from parallel_eda_tpu_torch.route import planes as P
    from parallel_eda_tpu_torch.route.router import RouterOpts

    say("card", f"{torch.cuda.device_count()} visible card(s)")
    if cards and torch.cuda.device_count() < 2:
        raise AssertionError("--cards needs two or more visible cards")
    phase_build()
    launch0 = launch_us()
    t0 = time.time()
    bench = synth_flow(**BENCH_CFG)
    scale = synth_flow(**SCALE_CFG)
    say("flows", f"front ends built in {time.time() - t0:.1f}s")
    rows = {} if cards else phase_kernels({"bench": bench, "scale": scale})
    pg_bench = P.build_planes(bench.rr, "cuda")
    pg_scale = P.build_planes(scale.rr, "cuda")
    for name, phase, shapes in (
            ("remote_slab_permute_cuda", phase_halo,
             [("bench", pg_bench, s) for s in (2, 3, 4)]
             + [("scale", pg_scale, 4)]),
            ("planes_relax_peer_cuda", phase_peer,
             [("bench", bench.rr, pg_bench, s) for s in (2, 3, 4)]
             + [("scale", scale.rr, pg_scale, 4)]),
            ("planes_relax_cluster_cuda", phase_sharded,
             [("bench", bench.rr, pg_bench, (2, 3, 4)),
              ("scale", scale.rr, pg_scale, (4,))])):
        if cards and phase is phase_peer:
            continue                # the peer kernel on each card alone
        rows[name], rows[name + BF16] = phase(shapes)
    if not cards:
        # after the kernels' own timings: the CPU reference routes run
        # beside the route phases
        _start_cpu_refs()

    res, c_bench, _, _ = _route("bench", bench, RouterOpts(batch_size=64))
    if (res.wirelength, res.iterations) != (537, 22):
        raise AssertionError(f"bench: expected wirelength 537 in 22 "
                             f"iterations, got {res.wirelength} in "
                             f"{res.iterations}")
    warm = ({} if cards
            else {"bench": warm_route(bench, RouterOpts(batch_size=64))})
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
            mres, c, dt, _ = _route(tag, bench, opts,
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
        mres, c, _, _ = _route("mesh2_one_card", bench, opts,
                            devices=["cuda:0"] * 2)
        if (mres.wirelength, mres.iterations) != (537, 22) or not (
                np.array_equal(mres.paths, res.paths)
                and np.array_equal(mres.occ, res.occ)):
            raise AssertionError("mesh2_one_card: route differs from the "
                                 "single-device bench route")
        c_mesh.append(c)
    c_net = c_node = []
    if not cards:
        warm["mesh2"] = warm_route(bench,
                                   RouterOpts(batch_size=64, mesh_shards=2))
        graphs = {"bench": pg_bench, "scale": pg_scale,
                  "scale_rr": scale.rr}
        c_net = phase_netmesh(bench, res, rows, graphs)
        c_node = phase_nodemesh(bench, res, rows, graphs, smi)
    t0 = time.time()
    scale = run_place_native(scale)
    say("scale", f"placed {scale.pnl.num_blocks} blocks in "
                 f"{time.time() - t0:.1f}s (native SA)")
    if not cards:
        scale_res, c_scale, _, _ = _route("scale", scale,
                                          RouterOpts(batch_size=64))
        warm["scale"] = warm_route(scale, RouterOpts(batch_size=64))
    _, c, _, _ = _route("scale_mesh4", scale,
                     RouterOpts(batch_size=64, mesh_shards=4))
    c_mesh.append(c)
    if cards:
        c_net = phase_netmesh_cards(bench, res, scale, smi)
        c_node = phase_nodemesh_cards(bench, res, scale, smi)
        # the paths that exist only across cards and what they are held
        # against; every other phase runs on one card
        say("cards", f"mesh routes (bench 2, bench 4, bench 2 on one "
                     f"card, scale 4) {c_mesh} lag 2 (bench 2, bench 4) "
                     f"{c_lag2} net mesh (bench 2, bench 4, scale one "
                     f"card, net 4, net 4, one card) {c_net} node mesh "
                     f"(bench 1x2, scale one card, 1x4, 2x2, 2x2, 1x4, "
                     f"one card) {c_node}")
        print(smi)
        print(json.dumps({"ok": True, "cards": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    c_timing, sta_cases = phase_timing(bench, scale, rows, warm)
    scale_native = (f"wirelength {scale.route.wirelength}, "
                    f"{scale.route.iterations} iterations, crit path "
                    f"{scale.crit_path_delay!r} s")
    c_bf16 = phase_bf16(bench, scale, res, warm)
    c_place, place_later = phase_place(BENCH_CFG, SCALE_CFG, scale_native)
    c_cli = phase_cli(rows)
    c_elastic = phase_elastic(bench, res, scale)
    phase_ell(bench, scale, smi, warm)
    c_fused, fused_later = phase_fused(bench, res, scale)
    cold = serve_cold_start()
    c_resil, serve_jobs = phase_resil(bench, res, scale, scale_res, rows,
                                      smi)
    c_serve = phase_serve(bench, serve_jobs, smi, cold)
    c_qor = phase_qor(bench, smi)
    phase_fleet(smi)
    c_long = phase_long_lines(rows, smi)

    runs = [c_bench, c_scale] + c_mesh + c_lag2 + c_net + c_node + \
        c_timing + c_bf16 + c_place + [c_cli, c_elastic, c_fused, c_resil,
                                       c_serve, c_qor] + c_long
    launches = {k: sum(r[k] for r in runs) for k in c_bench}
    # K3 is off the route's path: the sharded relaxations move their
    # halos inside planes_relax_peer_kernel (peer_publish/peer_install)
    # and the cluster kernel, so its route count is 0.  The halo phase's
    # own calls of remote_slab_permute are reported apart, as
    # harness_launches, and K3 alone is exempt from the idle gate below
    off_path = ("remote_slab_permute_cuda", "remote_slab_permute_cuda" + BF16)
    harness = {k: sum(c["harness_launches"] for c in rows[k])
               for k in off_path}
    say("launches", f"bench {c_bench} scale {c_scale} mesh (bench 2, "
                    f"bench 4, [bench 2 on one card,] scale 4) {c_mesh} "
                    f"mesh lag 2 (bench 2, bench 4) {c_lag2} net mesh "
                    f"(bench 2, bench 4, timing 2, ell 2) {c_net} node "
                    f"mesh (bench 1x2, 1x4, 2x2, bf16 1x2, timing 1x2, ell "
                    f"1x2) {c_node} timing "
                    f"(bench, bench mesh 2, scale) {c_timing} bf16 (bench "
                    f"off, bench window, bench mesh 2, bench mesh 2 lag 2, "
                    f"scale off, bench timing off) {c_bf16} place "
                    f"(scale delay lookup, scale route) {c_place} cli "
                    f"(the CLI runs on the card) {c_cli} elastic "
                    f"(its routes, resumes and CLI run) {c_elastic} fused "
                    f"(its card routes) {c_fused} resil (its card routes "
                    f"and services) {c_resil} serve (its fused services; "
                    f"its subprocesses count their own) {c_serve} qor "
                    f"(its card route) {c_qor} long_lines (6x72, 72x6, "
                    f"6x72 mesh 2 lag 1 and 2, 66x66) {c_long}; the "
                    f"fleet's workers launch in their own processes")
    if c_bench["planes_relax_full_cuda"] <= 0:
        raise AssertionError("K1 never launched on the bench route")
    if c_scale["planes_relax_cropped_cuda"] <= 0:
        raise AssertionError("K2 never launched on the scale route")
    idle = [k for k in rows if launches[k] <= 0 and k not in off_path]
    if idle:
        raise AssertionError(f"never launched on the route phases: {idle}")
    launch1 = launch_us()
    phase_device()
    place_later()
    fused_later()
    for tag, w in warm.items():
        phase_profile(w, tag)
    del warm
    phase_sta(sta_cases)
    say("launch", f"host us per PyTorch launch: {launch0:.2f} before any "
                  f"profiler session, {launch1:.2f} after the timings and "
                  f"routes, {launch_us():.2f} after the profiler phases")

    def main_case(name, c):
        name = name.replace(BF16, "")
        if name == "planes_relax_full_cuda":
            return c["cfg"] == "bench" and c.get("tile") is None
        if name == "planes_relax_cropped_cuda":
            return c["cfg"] == "scale" and c.get("tile") == [16, 16]
        if name == "planes_relax_peer_cuda":
            return (c["cfg"], c["shards"], c["impl"]) == (
                "bench", 2, "pallas_halo")
        if name == "planes_relax_node_cuda":
            return (c["cfg"], c["node"]) == ("bench", 2)
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
            **({"harness_launches": harness[name]} if name in harness
               else {}),
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
    finally:
        _stop_children()
