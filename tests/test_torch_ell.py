"""The port's ELL program, ``Router(rr, RouterOpts(program="ell"))``,
against the JAX Router's, on the CPU: every field of RouteResult and
every RouteStats row (seconds aside) equal.

Fixtures: the 15-LUT parity fixture, whose boxes all exceed
``window_max_frac`` (every net is born wide, so the windowed route is
the global program's), and the 16x16 big-grid fixture of
tests/test_router.py, where the windows engage (windowed_nets >
0.3 R, widened_nets 0, as JAX's own test requires).  Cases vary
``sink_group`` 0 / 1, ``windowed`` on / off and ``astar_fac`` 1.0 / 1.2
(the big grid's windowed routes run the global program too, for its
born-wide nets; tests/test_torch_ell_gpu.py routes it with
``windowed=False`` on the card against the CPU).

The timing-driven case (the analyzer, which the ELL program degrades to
its per-iteration ``timing_cb``) multiplies and adds at crit > 0, so
its JAX reference runs in a subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (ROADMAP.md C2): this file run as a
script writes it to an .npz."""

import importlib
import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

JAX_PKG, PORT_PKG = "parallel_eda_tpu", "parallel_eda_tpu_torch"
FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
# name -> (fixture, RouterOpts fields)
CASES = {
    "fixture_g0": ("fixture", dict(sink_group=0)),
    "fixture_g1": ("fixture", dict(sink_group=1)),
    "fixture_global_g1": ("fixture", dict(sink_group=1, windowed=False)),
    "big_g1": ("big", dict(sink_group=1)),
    "big_g0_af12": ("big", dict(sink_group=0, astar_fac=1.2)),
}
TIMING = ("fixture", dict(sink_group=0))
_STATS_FIELDS = ("iteration", "overused_nodes", "overuse_total",
                 "rerouted_nets", "relax_steps", "batches", "overuse_pct",
                 "crit_path_delay")
_SCALARS = ("success", "iterations", "wirelength", "total_net_routes",
            "total_relax_steps", "total_relax_steps_useful",
            "total_relax_steps_wasted", "total_relax_steps_cropped",
            "widened_nets", "windowed_nets")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU runs: the ELL search issues
    many small ops, each a parallel region that waits for every thread
    of its pool, and the tier-1 run's workers share the cores (its
    results do not depend on the thread count: no float reduction)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "flow", "route.router", "timing.graph", "timing.sta",
        "arch.builtin", "netlist.generate")}


def _flow(pkg, fixture):
    m = _mods(pkg)
    if fixture == "fixture":
        return m["flow"].synth_flow(**FIXTURE)
    nl = m["netlist.generate"].generate_circuit(
        num_luts=20, num_inputs=4, num_outputs=4, K=4, seed=9)
    return m["flow"].prepare(nl, m["arch.builtin"].minimal_arch(
        chan_width=10), chan_width=10, nx=16, ny=16, seed=9)


def _kw(pkg):
    """The port runs on the CPU only when asked."""
    return {} if pkg == JAX_PKG else {"device": "cpu"}


def _opts(pkg, fields):
    return _mods(pkg)["route.router"].RouterOpts(
        batch_size=32, program="ell", **fields)


def _as_arrays(res) -> dict:
    """Every field of a RouteResult as arrays (stats rows without their
    seconds)."""
    out = {k: np.array(getattr(res, k)) for k in _SCALARS}
    out.update(paths=res.paths, occ=res.occ, sink_delay=res.sink_delay,
               stats=np.array([[getattr(s, f) for f in _STATS_FIELDS]
                               for s in res.stats], np.float64),
               checkpoint=np.array(res.checkpoint is None),
               congestion=np.array(len(res.congestion)))
    return out


def route(pkg, fixture, fields, timing=False, stats_dir=None):
    m = _mods(pkg)
    f = _flow(pkg, fixture)
    if stats_dir is not None:
        fields = dict(fields, stats_dir=stats_dir, dump_routes=True)
    router = m["route.router"].Router(f.rr, _opts(pkg, fields), **_kw(pkg))
    if not timing:
        return _as_arrays(router.route(f.term)), f
    ta = m["timing.sta"].TimingAnalyzer(
        m["timing.graph"].build_timing_graph(f.nl, f.pnl, f.term),
        **_kw(pkg))
    out = _as_arrays(router.route(f.term, analyzer=ta))
    out["cpd"] = np.array(ta.crit_path_delay)
    return out, f


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k], equal_nan=True), k


@pytest.mark.parametrize("name", list(CASES))
def test_ell_route_matches_jax(name):
    from parallel_eda_tpu_torch.route.check import check_route

    fixture, fields = CASES[name]
    want, f = route(JAX_PKG, fixture, fields)
    got, _ = route(PORT_PKG, fixture, fields)
    _assert_same(got, want)
    assert bool(got["success"])
    check_route(f.rr, f.term, got["paths"], occ=got["occ"])
    R = f.term.num_nets
    if fixture == "big" and fields.get("windowed", True):
        # the windows engage and route their nets (tests/test_router.py)
        assert int(got["windowed_nets"]) > 0.3 * R
        assert int(got["widened_nets"]) == 0
    if fixture == "fixture":
        # every box exceeds window_max_frac: born wide, no tables
        assert int(got["windowed_nets"]) == 0


def write_reference(path):
    """The JAX timing-driven ELL route into the .npz ``path``; run under
    the reference flags."""
    out, _ = route(JAX_PKG, *TIMING, timing=True)
    np.savez(path, **out)


def test_ell_timing_route_matches_jax(tmp_path):
    """Router.route(analyzer=...) with program="ell": the analyzer's
    timing_cb after every iteration, its criticalities re-uploaded only
    when they change; every field, the stats rows' crit-path column and
    the final crit path bit-identical."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    path = tmp_path / "ref.npz"
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    got, _ = route(PORT_PKG, *TIMING, timing=True)
    _assert_same(got, want)
    crit_col = got["stats"][:, _STATS_FIELDS.index("crit_path_delay")]
    # every iteration but the converged one was stamped
    assert np.isfinite(crit_col[:-1]).all()


def _stats_tree(d) -> dict:
    """The stats_dir's files, the seconds columns left out of the two
    stats files."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as fh:
            lines = fh.read().splitlines()
        if name == "iter_stats.txt":
            lines = [ln.split() for ln in lines]
            lines = [r[:1] + r[2:] for r in lines]
        elif name == "final_stats.txt":
            lines = [ln for ln in lines
                     if not ln.startswith("total_route_time")]
        out[name] = lines
    return out


def test_ell_stats_dir_matches_jax(tmp_path):
    """stats_dir with dump_routes: iter_stats.txt and final_stats.txt
    (seconds aside), route_report.txt and every routes_iter_N.txt equal
    to the JAX Router's, and the same set of files."""
    fixture, fields = CASES["fixture_g1"]
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    route(JAX_PKG, fixture, fields, stats_dir=dj)
    got, _ = route(PORT_PKG, fixture, fields, stats_dir=dp)
    a, b = _stats_tree(dp), _stats_tree(dj)
    assert a == b
    assert {"iter_stats.txt", "final_stats.txt", "route_report.txt",
            f"routes_iter_{int(got['iterations'])}.txt"} <= set(a)
    assert len(a["iter_stats.txt"]) == int(got["iterations"]) + 1


def _raised(pkg, fixture, fields, call):
    """The ValueError's text when ``call`` (ctor or route) raises it."""
    m = _mods(pkg)
    f = _flow(pkg, fixture)
    with pytest.raises(ValueError) as e:
        r = m["route.router"].Router(f.rr, m["route.router"].RouterOpts(
            batch_size=32, **fields), **_kw(pkg))
        if call == "resume":
            r.route(f.term, resume=object())
    return str(e.value)


@pytest.mark.parametrize("fields,call", [
    (dict(program="ell"), "resume"),
    (dict(program="ell", mesh_shards=2), "init"),
    (dict(program="planes_pallas", mesh_shards=2), "init"),
])
def test_ell_raises_as_jax(fields, call):
    assert _raised(PORT_PKG, "fixture", fields, call) == \
        _raised(JAX_PKG, "fixture", fields, call)


def test_planes_pallas_is_the_planes_route():
    """program="planes_pallas" runs the planes route (the port's
    relaxation kernels are the hand-written kernels of both)."""
    m = _mods(PORT_PKG)
    f = _flow(PORT_PKG, "fixture")
    out = []
    for program in ("planes", "planes_pallas"):
        r = m["route.router"].Router(f.rr, m["route.router"].RouterOpts(
            batch_size=32, program=program), device="cpu")
        res = r.route(f.term)
        assert res.success
        out.append(_as_arrays(res))
    _assert_same(out[1], out[0])


if __name__ == "__main__":
    write_reference(sys.argv[1])
