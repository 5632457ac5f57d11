"""Tests of the benchmark itself, on the CPU at a tiny size: the
required shape of BENCHMARK.json, that nothing of JAX is loaded, that
a sound run reads correct, and that the control and each fault that a
route cell can have read not correct.  The card tests (marked gpu) run
the same on the card.

    python -m pytest benchmark/tests
"""

import json
import os
import re
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

import harness  # noqa: E402
import run as runmod  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(router_opts=None):
    """An 8 x 8 multiplier on the cells' architecture, a pool of one
    job; bounding boxes not widened and 4 x 4 crop tiles, so that its
    routes run both relaxation kinds, as the cells' larger grids do."""
    with open(os.path.join(BENCH_DIR, "configs",
                           "mult16_k6n10l1.json")) as f:
        cfg = json.load(f)
    cfg["circuit"]["n"] = 8
    cfg["bb_factor"] = 0
    cfg["w_min"] = 30
    traffic = {"job": "route", "jobs": 1,
               "chan_width": {"factor": 1.3, "of": "w_min"},
               "router_opts": dict({"crop": "4x4"}, **(router_opts or {}))}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    return harness.Cell("tiny", 1, cfg, traffic, bench["end_to_end"],
                        bench["per_layer"])


def run_tiny(cell, seed=2 ** 31 + 7, trace=False):
    run = harness.CellRun(cell, seed, 0.5, trace, device="cpu")
    run.execute()
    run.free_program_state()
    checks = harness.verdict(run)
    return run, checks, runmod.result(run, checks)


# ---------------------------------------------------------------------------
# BENCHMARK.json and its files
# ---------------------------------------------------------------------------


def test_benchmark_json_shape():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert len(json.dumps(bench)) < 64 * 1024


# ---------------------------------------------------------------------------
# Nothing of JAX, by whole top-level names
# ---------------------------------------------------------------------------


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    """The port's name begins with the JAX package's: names are compared
    whole, before the first dot."""
    fake = type(sys)("fake")
    for name in ("parallel_eda_tpu_torch", "parallel_eda_tpu_torch.route",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert runmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "parallel_eda_tpu.route", fake)
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    assert runmod.forbidden_modules() == ["jax", "parallel_eda_tpu"]


def test_no_jax_in_a_run():
    """Every benchmark module imported and a tiny cell run in a fresh
    process: no module of jax, jaxlib, flax or the JAX package loaded."""
    code = f"""
import glob, importlib.util, json, os, sys
sys.path.insert(0, {BENCH_DIR!r}); sys.path.insert(1, {ROOT!r})
import harness, run, devtrace, roofline, circuits, wmin, control
from ref import arch, grid, rrgraph, planes, judge
for p in glob.glob(os.path.join({BENCH_DIR!r}, "metrics", "*.py")):
    spec = importlib.util.spec_from_file_location("m", p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
sys.path.insert(0, os.path.join({BENCH_DIR!r}, "tests"))
import test_benchmark_cells as t
r, checks, out = t.run_tiny(t.tiny_cell())
top = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(top & {{"jax", "jaxlib", "flax",
                                "parallel_eda_tpu"}})))
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [] and json.loads(lines[-1]) == []


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card here: exit 3 and no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "mult16_k6n10l1.route_pool4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_every_check_file_is_a_check():
    """The checks are the files checks/<name>.py, each with its limit."""
    names = harness.check_names()
    assert names == sorted(n[:-3] for n in os.listdir(
        os.path.join(BENCH_DIR, "checks")) if n.endswith(".py"))
    assert "relax_mismatch" in names and "route_faults" in names
    for name in names:
        mod = harness.load_module("checks", name)
        assert callable(mod.read) and mod.LIMIT == 0


def test_kernel_short_names():
    from devtrace import short_name

    assert short_name("void (anonymous namespace)::planes_relax_full_kernel"
                      "<2, float>((anonymous namespace)::Args)") == \
        "planes_relax_full_kernel"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


# ---------------------------------------------------------------------------
# A sound run, the control and the faults
# ---------------------------------------------------------------------------


def test_sound_run_is_correct():
    """A traced run: correct, every check 0, the relaxation calls of the
    window captured and compared."""
    run, checks, out = run_tiny(tiny_cell(), trace=True)
    assert out["correct"], checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(v == 0 for v, _ in checks.values())
    assert "router.syncs_per_route" in out["metrics"]
    assert list(out)[-1] == "checks"
    assert run.spy.captured


def test_launches_the_spy_did_not_see_count():
    """relax_mismatch holds the captured calls against the kernels'
    launch counts: a launch past the spy, or a kind never captured,
    counts as a mismatch."""
    from ref import judge

    run, checks, _ = run_tiny(tiny_cell())
    ref = harness.Reference(run)
    spy = run.spy
    assert set(spy.captured) == set(spy.calls)
    assert judge.relax_mismatch(ref.rr, spy.captured, spy.calls,
                                dict(spy.calls), "cpu") == 0
    more = dict(spy.calls, k1=spy.calls["k1"] + 3)
    assert judge.relax_mismatch(ref.rr, spy.captured, spy.calls, more,
                                "cpu") == 3
    fewer = {k: v for k, v in spy.captured.items() if k != "k2"}
    assert judge.relax_mismatch(ref.rr, fewer, spy.calls, None, "cpu") == 1


def test_control_bf16_planes_is_not_correct():
    """The control: the program's own reduced-precision plane mode."""
    _, checks, out = run_tiny(tiny_cell(router_opts=dict(
        plane_dtype="bf16", dtype_guard="off")))
    assert not out["correct"]
    assert checks["relax_mismatch"][0] > 0


def _relax_fault(kind):
    from parallel_eda_tpu_torch.route import planes

    orig = planes.planes_relax

    def broken(pg, d0, cc, crit, wenter0, nsweeps, *a, **kw):
        dist, pred, wenter, st = orig(pg, d0, cc, crit, wenter0, nsweeps,
                                      *a, **kw)
        if kind == "unchanged":
            return d0.clone(), pred, wenter0.clone(), st
        half = d0.shape[0] // 2
        dist = dist.clone()
        dist[half:] = d0[half:]
        return dist, pred, wenter, st
    return planes, "planes_relax", broken


def _answer_fault():
    from parallel_eda_tpu_torch.route import router

    orig = router.Router.route

    def broken(self, term, *a, **kw):
        res = orig(self, term, *a, **kw)
        paths = res.paths.copy()
        seg = paths[0, 0]
        seg[0] = (int(seg[0]) + 1) % self.rr.num_nodes
        res.paths = paths
        return res
    return router.Router, "route", broken


def _wrap(module, name, change):
    """``module.name`` with ``change`` applied to what it returns."""
    orig = getattr(module, name)

    def broken(*a, **kw):
        out = orig(*a, **kw)
        change(out)
        return out
    return module, name, broken


def _move_prim(pnl):
    clbs = [b for b in pnl.blocks if b.type_name == "clb"]
    clbs[1].prims.append(clbs[0].prims.pop())


def _alter_rr(rr):
    rr.in_delay = rr.in_delay.copy()
    rr.in_delay[-1] += 1e-12


def _overlap(res):
    res.pos = res.pos.copy()
    res.pos[-1] = res.pos[-2]


def _widen_bb(term):
    term.bb_xmax = term.bb_xmax.copy()
    term.bb_xmax[0] += 1


def _front_end_fault(kind):
    from parallel_eda_tpu_torch import flow
    from parallel_eda_tpu_torch.place import serial_sa
    from parallel_eda_tpu_torch.rr import terminals

    return {"pack_moved": (flow, "pack_netlist", _move_prim),
            "rr_altered": (flow, "build_rr_graph", _alter_rr),
            "place_overlap": (serial_sa, "serial_sa_place", _overlap),
            "term_altered": (terminals, "net_terminals", _widen_bb)}[kind]


# each fault and the check that has to catch it
FAULTS = {"step_unchanged": "relax_mismatch", "half_batch": "relax_mismatch",
          "relax_bypassed": "relax_mismatch",
          "answer_altered": "route_faults", "pack_moved": "pack_faults",
          "rr_altered": "rr_mismatch", "place_overlap": "place_faults",
          "term_altered": "term_mismatch"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    if fault == "step_unchanged":
        target = _relax_fault("unchanged")
    elif fault == "half_batch":
        target = _relax_fault("half")
    elif fault == "answer_altered":
        target = _answer_fault()
    elif fault == "relax_bypassed":
        # the route step reaching the relaxation past the spy, as a step
        # that binds it elsewhere would
        target = (harness.RelaxSpy, "install", lambda self: None)
    else:
        target = _wrap(*_front_end_fault(fault))
    monkeypatch.setattr(*target)
    _, checks, out = run_tiny(tiny_cell(router_opts=dict(
        max_router_iterations=4)))
    assert not out["correct"], checks
    assert checks[FAULTS[fault]][0] > 0, checks


@pytest.mark.gpu
def test_control_on_the_card():
    """The control at the tiny size on the card: the bf16 kernels fail
    the relaxation comparison, the f32 kernels pass it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for opts, want in (({}, True), (dict(plane_dtype="bf16",
                                         dtype_guard="off"), False)):
        cell = tiny_cell(router_opts=opts)
        run = harness.CellRun(cell, 11, 0.5, False, device="cuda:0")
        run.execute()
        run.free_program_state()
        checks = harness.verdict(run)
        assert runmod.result(run, checks)["correct"] is want, checks
