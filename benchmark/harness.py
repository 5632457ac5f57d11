"""One run of one benchmark cell of ``parallel_eda_tpu_torch``.

A cell is a configuration (``configs/<name>.json``: the circuit, the
architecture, the channel width search's result) under a traffic mix
(``traffic/<name>.json``: the pool of jobs, their kind
``jobs/<kind>.py``, the channel-width rule, the router's options).
``CellRun.execute`` builds the front end once, sets up the pool (each
job's placement, the Router, one warm run of every job), then opens the
window: one closed-loop client runs the pool in rounds, every job once a
round in an order drawn from the seed, until ``seconds`` have passed; a
round started inside the window is finished and counted.  After the
window it reads the device's memory peak; ``free_program_state`` drops
the program's state, and ``verdict`` hands the results to the reference
(``ref/``) through the checks (``checks/<name>.py``), whose numbers decide
``correct``.  The metrics are read by ``metrics/<name>.py``.

Nothing here imports JAX or the JAX package; the program is the port.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import time
from typing import Callable, List, Optional

import numpy as np

from circuits import circuit_blif

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


# ---------------------------------------------------------------------------
# The cell: BENCHMARK.json's entry, its configuration and traffic files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]         # BENCHMARK.json's entries of the cell
    per_layer: List[dict]

    @property
    def chan_width(self) -> int:
        rule = self.traffic["chan_width"]
        return int(math.ceil(rule["factor"] * self.config[rule["of"]]
                             - 1e-9))


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str) -> Cell:
    """The cell ``workload`` of BENCHMARK.json, its files read."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark "
                         f"has {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _listed(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _listed(m, workload)])


def sub_seed(seed: int, *keys: int) -> int:
    """A 31-bit seed drawn from ``seed`` (any whole number) and keys."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64)] + list(keys))
    return int(ss.generate_state(1)[0] & 0x7FFFFFFF)


_MODULES: dict = {}


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, folder, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def read_metric(name: str, run: "CellRun"):
    """The metric's value in this run, or None where its reader
    (metrics/<name>.py) finds nothing to read."""
    return load_module("metrics", name).read(run)


# ---------------------------------------------------------------------------
# The front end and the jobs
# ---------------------------------------------------------------------------


class FrontEnd:
    """The configuration's circuit packed onto its architecture, on a
    grid with the cell's channel width: shared by every job."""

    def __init__(self, cfg: dict, chan_width: int):
        from parallel_eda_tpu_torch.arch import builtin
        from parallel_eda_tpu_torch.flow import prepare
        from parallel_eda_tpu_torch.netlist.blif import parse_blif

        self.blif = circuit_blif(cfg["circuit"])
        self.nl = parse_blif(self.blif, K=6, name=cfg["name"])
        self.arch = getattr(builtin, cfg["arch"] + "_arch")()
        self.bb_factor = int(cfg["bb_factor"])
        self.flow = prepare(self.nl, self.arch, chan_width, seed=0,
                            bb_factor=self.bb_factor)
        self.pnl, self.grid, self.rr = (self.flow.pnl, self.flow.grid,
                                        self.flow.rr)

    def place_native(self, seed: int) -> np.ndarray:
        """VPR's annealer (the port's native serial placer) from an
        initial placement of the same seed."""
        from parallel_eda_tpu_torch.place.initial import initial_placement
        from parallel_eda_tpu_torch.place.serial_sa import serial_sa_place

        pos0 = initial_placement(self.pnl, self.grid, seed=seed)
        return serial_sa_place(self.pnl, self.grid, pos0, seed=seed).pos

    def terminals(self, pos: np.ndarray):
        from parallel_eda_tpu_torch.rr.terminals import net_terminals

        return net_terminals(self.pnl, self.rr, pos,
                             bb_factor=self.bb_factor)


def job_seed(index: int) -> int:
    """The placement seed of the pool's job ``index``.  Not drawn from
    ``--seed``: placements of other seeds take other numbers of rip-up
    iterations, so every ``--seed`` routes the same pool, in an order of
    its own."""
    return sub_seed(0, 0, index)


@dataclasses.dataclass
class Job:
    index: int
    seed: int
    pos: Optional[np.ndarray] = None
    term: object = None


@dataclasses.dataclass
class Outcome:
    """What one run of a job gave."""
    index: int
    t0: float
    t1: float
    success: bool
    iterations: int
    wirelength: int
    paths: np.ndarray
    occ: np.ndarray
    pos: np.ndarray
    term: object
    syncs: float            # the driver's blocking syncs in this run
    plan_ms: float          # its host planning milliseconds


# ---------------------------------------------------------------------------
# Spies on the relaxation: captured calls (the reference checks them) and
# launch shapes (the rooflines read them)
# ---------------------------------------------------------------------------


RELAX_NAMES = {"k1": "planes_relax", "k2": "planes_relax_cropped"}
# the kernel wrappers (planes_kernels.launch_counts) behind each kind
RELAX_WRAPPERS = {"k1": "planes_relax_full_cuda",
                  "k2": "planes_relax_cropped_cuda"}


def relax_launches(cuda: bool) -> Optional[dict]:
    """Launches of each relaxation kind's kernel so far, in both plane
    modes, as the program's wrappers count them; None off the card."""
    if not cuda:
        return None
    from parallel_eda_tpu_torch.route.planes_kernels import launch_counts

    counts = launch_counts()
    return {k: counts[w] + counts[w + "[bf16]"]
            for k, w in RELAX_WRAPPERS.items()}


class RelaxSpy:
    """Wraps ``planes.planes_relax`` (K1) and ``planes.planes_relax_cropped``
    (K2), which the route step looks up at each call.  Keeps, for each,
    the inputs and outputs of one call inside the window (``arm`` ..
    ``disarm``), drawn uniformly from all of the window's calls of that
    kind by ``rngs[kind]`` (a reservoir of one), and with
    ``record_launches`` the shapes and per-net sweep counts of every
    call.  On the card it also counts the kernels' launches over the
    window (``launched``), which the check holds against the calls it
    saw: a launch that bypassed the spy shows."""

    def __init__(self, rngs: dict, record_launches: bool, cuda: bool):
        from parallel_eda_tpu_torch.route import planes

        self.planes = planes
        self.rngs = dict(rngs)
        self.calls = {k: 0 for k in RELAX_NAMES}
        self.captured = {}
        self.launches: List[tuple] = []
        self.record_launches = record_launches
        self.cuda = cuda
        self.launched: Optional[dict] = None
        self._launched0: Optional[dict] = None
        self.armed = False
        self.orig = {}

    def arm(self) -> None:
        self._launched0 = relax_launches(self.cuda)
        self.armed = True

    def disarm(self) -> None:
        self.armed = False
        end = relax_launches(self.cuda)
        if end is not None:
            self.launched = {k: end[k] - self._launched0[k] for k in end}

    def install(self) -> None:
        for kind, name in RELAX_NAMES.items():
            orig = self.orig[kind] = getattr(self.planes, name)
            setattr(self.planes, name, self._wrap(kind, orig))

    def uninstall(self) -> None:
        for kind, name in RELAX_NAMES.items():
            if kind in self.orig:
                setattr(self.planes, name, self.orig[kind])

    def _wrap(self, kind: str, orig: Callable):
        import torch

        def spy(pg, *args, **kw):
            if not self.armed or kw.get("mesh") is not None:
                return orig(pg, *args, **kw)
            n = self.calls[kind]
            self.calls[kind] = n + 1
            take = self.rngs[kind].random() * (n + 1) < 1.0
            if take:
                inputs = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
            out = orig(pg, *args, **kw)
            if take:
                self.captured[kind] = dict(
                    args=inputs, out=tuple(o.clone() for o in out[:3]))
            if self.record_launches:
                # the kernel wrappers return stats[B], a view of each
                # net's [executed, useful] sweeps
                stats = out[3]._base
                tile = (int(args[7]), int(args[8])) if kind == "k2" else None
                self.launches.append((kind, tuple(pg.shape_x),
                                      bool(pg.directional), pg.ncells,
                                      int(args[0].shape[0]), tile, stats,
                                      kw.get("plane_dtype", "f32")))
            return out
        return spy


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def build_program(cuda: bool) -> float:
    """Build the program's CUDA library and native annealer into the
    port's fixed build directory inside the checkout (nothing to do where
    they are there and current); returns the seconds it took."""
    t0 = time.perf_counter()
    from parallel_eda_tpu_torch.place.serial_sa import _get_lib

    _get_lib()
    if cuda:
        from parallel_eda_tpu_torch.route.planes_kernels import LIB

        LIB.get()
    return time.perf_counter() - t0


class CellRun:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.jobs: List[Job] = []
        self.warm: List[Outcome] = []
        self.window: List[Outcome] = []
        self.t_open = self.t_close = 0.0
        self.setup_s = self.build_s = self.window_s = 0.0
        self.memory_peak_bytes = 0
        self.profile = None             # devtrace.DeviceTrace, traced runs
        self.t_trace_end: Optional[float] = None
        self.spy: Optional[RelaxSpy] = None
        self.registry = None
        self.tracer = None
        self.router = None
        self.fe: Optional[FrontEnd] = None

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def job_kind(self):
        """jobs/<kind>.py of the traffic's ``job``."""
        return load_module("jobs", self.cell.traffic["job"])

    def router_opts(self):
        from parallel_eda_tpu_torch.route.router import RouterOpts

        return RouterOpts(**self.cell.traffic.get("router_opts", {}))

    def run_job(self, job: Job) -> Outcome:
        syncs = self.registry.counter("route.pipeline.blocking_syncs")
        syncs0 = syncs.value
        t0 = time.perf_counter()
        res = self.job_kind().run(self, job)
        t1 = time.perf_counter()
        plan = self.registry.gauge("route.pipeline.host_plan_ms_total")
        return Outcome(
            index=job.index, t0=t0, t1=t1, success=bool(res.success),
            iterations=int(res.iterations), wirelength=int(res.wirelength),
            paths=res.paths, occ=res.occ, pos=job.pos, term=job.term,
            syncs=syncs.value - syncs0, plan_ms=float(plan.value or 0.0))

    def execute(self) -> None:
        import torch

        from parallel_eda_tpu_torch import obs

        torch.set_num_threads(1)
        self.build_s = build_program(self.cuda)
        self.registry = obs.set_metrics(obs.MetricsRegistry())
        if self.trace:
            self.tracer = obs.Tracer()
            obs.set_tracer(self.tracer)
        self.fe = FrontEnd(self.cell.config, self.cell.chan_width)
        kind = self.job_kind()
        for i in range(int(self.cell.traffic["jobs"])):
            job = Job(i, job_seed(i))
            kind.prepare(self, job)
            self.jobs.append(job)
        self.warm = [self.run_job(job) for job in self.jobs]
        # each relaxation kind's captured call: drawn from the seed among
        # all of the window's calls
        self.spy = RelaxSpy({k: np.random.default_rng(
                                 sub_seed(self.seed, 7, j))
                             for j, k in enumerate(RELAX_NAMES)},
                            record_launches=self.trace, cuda=self.cuda)
        self.spy.install()
        # set-up's objects out of the collector's way, so that its pauses
        # inside the window stay short and alike from run to run
        gc.collect()
        gc.freeze()
        try:
            self._window()
        finally:
            self.spy.uninstall()
        if self.cuda:
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def _window(self) -> None:
        self.spy.arm()
        if self.trace:
            from devtrace import DeviceTrace

            self.profile = DeviceTrace(self.cuda)
            self.profile.start()
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - self.t_start
        deadline = self.t_open + self.seconds
        rounds = 0
        while time.perf_counter() < deadline:
            # a round: every job once, in an order drawn from the seed; a
            # round started in the window is finished
            order = np.random.default_rng(
                sub_seed(self.seed, 1000 + rounds)).permutation(
                len(self.jobs))
            for i in order:
                self.window.append(self.run_job(self.jobs[i]))
                if self.profile is not None and self.t_trace_end is None:
                    # a traced run traces the window's first job, so that
                    # reading the trace stays short
                    self.t_trace_end = self.window[0].t1
                    self.spy.record_launches = False
                    self.profile.stop(self.t_open, self.t_trace_end)
            rounds += 1
        self.spy.disarm()
        self.t_close = self.window[-1].t1 if self.window else \
            time.perf_counter()
        self.window_s = self.t_close - self.t_open

    def free_program_state(self) -> None:
        """Drop the Router before the reference runs."""
        self.router = None
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()

    # -- views the metric readers and checks use ---------------------------

    @property
    def traced(self) -> List[Outcome]:
        """The window's jobs that ended inside the traced window."""
        end = self.t_trace_end
        return [o for o in self.window if end is not None and o.t1 <= end]

    def per_job(self) -> List[tuple]:
        """Per job: the run checked in full (its first window run, or its
        warm run where the window did not reach it) and its other runs."""
        out = []
        for i, warm in enumerate(self.warm):
            runs = [o for o in self.window if o.index == i] + [warm]
            out.append((runs[0], runs[1:]))
        return out


# ---------------------------------------------------------------------------
# The verdict: the reference's numbers, each beside its limit
# ---------------------------------------------------------------------------


class Reference:
    """What the reference works out for a run, which the checks
    (checks/<name>.py) compare with the program's outputs: the cell's
    architecture, grid and rr graph, and per job the checked run, its
    other runs and the reference's terminals for its placement."""

    def __init__(self, run: CellRun):
        from ref import judge

        self.run, self.fe = run, run.fe
        self.arch, self.grid, self.rr = judge.build_reference(
            run.cell.config, run.fe.pnl, run.cell.chan_width)
        self.jobs = [(o, others, judge.terminals(
            run.fe.pnl, self.rr, self.arch, o.pos, run.fe.bb_factor))
            for o, others in run.per_job()]


def check_names() -> List[str]:
    """Every check of the benchmark: the files checks/<name>.py."""
    return sorted(n[:-3] for n in os.listdir(os.path.join(BENCH_DIR,
                                                          "checks"))
                  if n.endswith(".py"))


def verdict(run: CellRun) -> dict:
    """{check name: (number, limit)}: every check (checks/<name>.py) on
    this run."""
    ref = Reference(run)
    out = {}
    for name in check_names():
        mod = load_module("checks", name)
        out[name] = (mod.read(ref), mod.LIMIT)
    return out
