"""The port's timing-driven routing (parallel_eda_tpu_torch/timing/,
the STA inside route_window_planes, Router.route's crit / timing_cb /
analyzer, flow.run_route) against the JAX package, on the CPU.

The reference is the JAX package run under
``XLA_FLAGS=--xla_cpu_max_isa=AVX``.  With its default flags XLA:CPU
contracts ``a*b + c`` into one fused multiply-add, and the timing-driven
step computes ``crit*delay + cost`` in many places (JAX
route/planes.py:1287, :1341, :1361, :755 and the turn candidates); the
port's plain versions and its ``-fmad=false`` kernels round the product
and the sum separately, as XLA does when it is limited to AVX.  The flag
has to be set before JAX starts, and this test process has started JAX
already (tests/conftest.py), so one module-scoped fixture runs this file
as a script in a subprocess, which writes the JAX references to an .npz.
At the 15-LUT fixture the default flags give wirelength 67 and the
uncontracted order 66, both in 11 iterations (ROADMAP.md C).

Every comparison is exact, except the Elmore oracle's, which sums in
float64 what the router sums in float32 (the tolerance of
tests/test_timing.py)."""

import dataclasses
import importlib
import os
import subprocess
import sys
import warnings

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
CROP_FIXTURE = dict(num_luts=40, num_inputs=6, num_outputs=6,
                    chan_width=10, seed=3, bb_factor=0)
BENCH = dict(num_luts=60, num_inputs=12, num_outputs=12, chan_width=12,
             seed=11)
SDC_TEXT = ("create_clock -period 100.0 clk_a\n"
            "create_clock -period 2.0 clk_b\n")
# name -> (flow, RouterOpts fields, entry point)
ROUTES = {
    "analyzer": (FIXTURE, dict(batch_size=32), "analyzer"),
    "timing_cb": (FIXTURE, dict(batch_size=32), "timing_cb"),
    "crit99": (FIXTURE, dict(batch_size=32, sink_group=1), "crit"),
    "crop": (CROP_FIXTURE, dict(batch_size=32, crop="4x4"), "analyzer"),
    "sdc": ("two_clock", dict(batch_size=32), "analyzer"),
    "bench": (BENCH, dict(batch_size=64), "analyzer"),
}
# (wirelength, iterations) of the JAX reference
EXPECT = {"analyzer": (66, 11), "timing_cb": (65, 7), "crit99": (64, 4),
          "crop": (242, 16), "bench": (522, 22)}
# sta_crit cases: name -> (flow, seed of the sink delays)
STA = {"seq25": (dict(num_luts=25, num_inputs=4, num_outputs=4,
                      chan_width=12, seed=2), 0),
       "comb15": (dict(num_luts=15, num_inputs=4, num_outputs=4,
                       chan_width=12, seed=4, ff_ratio=0.0), 1),
       "sdc": ("two_clock", 2)}
STA_SDC = (SDC_TEXT + "set_multicycle_path -setup -to clk_b 2\n"
           "set_input_delay -clock clk_b 0.75 in_b\n"
           "set_output_delay -clock clk_a 1.5 out:a\n")
PARSE_CASES = [
    SDC_TEXT,
    STA_SDC,
    """
    # two port clocks + a virtual clock
    create_clock -period 4.0 clk_a
    create_clock -period 1.5 [get_ports {clk_b}]
    create_clock -period 8 -name virt -waveform {0 4}
    set_clock_groups -exclusive -group {clk_a} -group {clk_b}
    set_false_path -from foo -to bar
    """,
    """
    create_clock -period 4.0 clk
    set_input_delay -clock clk -max 1.25 [get_ports {a b}]
    set_input_delay -clock clk -min 0.25 [get_ports {a b}]
    set_output_delay -clock clk -max 0.5 out1
    set_output_delay -clock clk -min -0.1 out1
    set_multicycle_path -setup -from clk -to clk 3
    set_multicycle_path -hold -to clk 4
    set_multicycle_path -setup -from clk_a 2
    """,
    "create_clock -period 2.0\n",
    "create_clock clk\n",
    "set_input_delay -clock clk 1.0\n",
    "set_multicycle_path -setup -to clk 0\n",
    "create_clock -period 1 -bogus clk\n",
    "report_timing\n",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "flow", "route.router", "timing.graph", "timing.sta",
        "timing.sdc", "netlist.netlist", "arch.builtin")}


def _two_clock_netlist(nm):
    """tests/test_sdc.py's circuit, built with netlist module ``nm``: two
    registered LUT chains on different clocks, clk_a deep, clk_b
    shallow."""
    nl = nm.LogicalNetlist(name="twoclk")
    for c in ("clk_a", "clk_b"):
        nl.add(nm.Primitive(name=c, kind=nm.PRIM_INPAD, output=c))
    for tag, clk, depth in (("a", "clk_a", 3), ("b", "clk_b", 1)):
        nl.add(nm.Primitive(name=f"in_{tag}", kind=nm.PRIM_INPAD,
                            output=f"in_{tag}"))
        nl.add(nm.Primitive(name=f"r{tag}0", kind=nm.PRIM_FF,
                            inputs=[f"in_{tag}"], output=f"r{tag}0",
                            clock=clk))
        prev = f"r{tag}0"
        for d in range(depth):
            out = f"l{tag}{d}"
            nl.add(nm.Primitive(name=out, kind=nm.PRIM_LUT, inputs=[prev],
                                output=out, truth_table=["1 1"]))
            prev = out
        nl.add(nm.Primitive(name=f"r{tag}z", kind=nm.PRIM_FF, inputs=[prev],
                            output=f"r{tag}z", clock=clk))
        nl.add(nm.Primitive(name=f"out:{tag}", kind=nm.PRIM_OUTPAD,
                            inputs=[f"r{tag}z"]))
    nl.finalize()
    return nl


def _flow(pkg, cfg):
    m = _mods(pkg)
    if cfg == "two_clock":
        f = m["flow"].prepare(_two_clock_netlist(m["netlist.netlist"]),
                              m["arch.builtin"].minimal_arch(),
                              chan_width=10)
        f.sdc = m["timing.sdc"].parse_sdc(SDC_TEXT)
        return f
    return m["flow"].synth_flow(**cfg)


def _kw(pkg):
    """The port runs on the CPU only when asked."""
    return {} if pkg == JAX_PKG else {"device": "cpu"}


def _opts(pkg, fields):
    extra = {"pipeline": False} if pkg == JAX_PKG else {}
    return _mods(pkg)["route.router"].RouterOpts(**fields, **extra)


def _route(pkg, name, mesh_shards=1):
    """Route case ``name`` with package ``pkg``; the result as arrays."""
    cfg, fields, entry = ROUTES[name]
    m = _mods(pkg)
    f = _flow(pkg, cfg)
    if mesh_shards > 1:
        fields = dict(fields, mesh_shards=mesh_shards)
    opts = _opts(pkg, fields)
    if entry == "analyzer":
        f = m["flow"].run_route(f, opts, timing_driven=True, **_kw(pkg))
        res, cpd = f.route, f.crit_path_delay
    elif entry == "timing_cb":
        ta = m["timing.sta"].TimingAnalyzer(
            m["timing.graph"].build_timing_graph(f.nl, f.pnl, f.term),
            **_kw(pkg))
        res = m["route.router"].Router(f.rr, opts, **_kw(pkg)).route(
            f.term, timing_cb=ta.timing_cb)
        cpd = ta.crit_path_delay
    else:
        crit = np.full(f.term.sinks.shape, 0.99, np.float32)
        res = m["route.router"].Router(f.rr, opts, **_kw(pkg)).route(
            f.term, crit=crit)
        cpd = float("nan")
    return dict(
        success=np.array(res.success), wirelength=np.array(res.wirelength),
        iterations=np.array(res.iterations), paths=res.paths, occ=res.occ,
        sink_delay=res.sink_delay, cpd=np.array(cpd),
        stats=np.array([(s.iteration, s.overused_nodes, s.overuse_total,
                         s.rerouted_nets, s.relax_steps, s.batches)
                        for s in res.stats], np.int64),
        stats_crit=np.array([s.crit_path_delay for s in res.stats]),
        ledger=np.array([res.total_net_routes, res.total_relax_steps,
                         res.total_relax_steps_useful,
                         res.total_relax_steps_cropped, res.widened_nets]))


def _sta_inputs(pkg, name):
    """(timing graph, sdc or None, flat routed delays) of STA case
    ``name``: seeded uniform delays, a tenth of the slots unrouted
    (inf), and the trailing 0 slot."""
    cfg, seed = STA[name]
    m = _mods(pkg)
    f = _flow(pkg, cfg)
    tg = m["timing.graph"].build_timing_graph(f.nl, f.pnl, f.term)
    rng = np.random.default_rng(seed)
    d = rng.uniform(1e-10, 2e-9, tg.num_route_slots).astype(np.float32)
    d[rng.random(d.size) < 0.1] = np.inf
    sdc = m["timing.sdc"].parse_sdc(STA_SDC) if cfg == "two_clock" else None
    return tg, sdc, np.append(d, np.float32(0.0))


def _jax_sta(name, crit_exp):
    from parallel_eda_tpu.timing.sta import TimingAnalyzer, sta_sweep

    tg, sdc, flat = _sta_inputs(JAX_PKG, name)
    ta = TimingAnalyzer(tg, sdc=sdc)
    out = sta_sweep(ta.dev, jax.numpy.asarray(flat), tg.depth, crit_exp,
                    0.99, req_seed=ta._req_seed, use_sdc=sdc is not None)
    return dict(zip(("crit", "dmax", "worst", "arr"),
                    (np.asarray(o) for o in out)))


def write_reference(path, names):
    """The JAX references of route cases ``names`` and of every sta_crit
    case, into the .npz ``path``.  Run under the reference flags."""
    out = {}
    for name in names:
        for k, v in _route(JAX_PKG, name).items():
            out[f"route/{name}/{k}"] = v
    for name in STA:
        for e in (1.0, 2.0):
            for k, v in _jax_sta(name, e).items():
                out[f"sta/{name}/{e}/{k}"] = v
    np.savez(path, **out)


def _reference(path, names):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path), *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("jax_ref") / "ref.npz",
                      [n for n in ROUTES if n != "bench"])


def _assert_route(ref, name, got, ledger=True):
    want = {k.split("/")[-1]: v for k, v in ref.items()
            if k.startswith(f"route/{name}/")}
    assert got["success"] and want["success"]
    for k in ("wirelength", "iterations", "paths", "occ", "sink_delay"):
        assert np.array_equal(got[k], want[k]), k
    # the critical path and every window's crit-path column, bit for bit
    assert np.array_equal(got["cpd"], want["cpd"], equal_nan=True)
    assert np.array_equal(got["stats_crit"], want["stats_crit"],
                          equal_nan=True)
    if ledger:
        assert np.array_equal(got["stats"], want["stats"])
        assert np.array_equal(got["ledger"], want["ledger"])
    if name in EXPECT:
        assert (int(got["wirelength"]), int(got["iterations"])) == \
            EXPECT[name]


@pytest.mark.parametrize("name", [n for n in ROUTES if n != "bench"])
def test_timing_route_matches_jax(ref, name):
    got = _route(PORT_PKG, name)
    _assert_route(ref, name, got)
    if ROUTES[name][2] == "analyzer":
        assert np.isfinite(got["stats_crit"]).all()
    if name == "crop":
        assert got["ledger"][3] > 0           # cropped sweeps ran


def test_timing_route_mesh2_matches_jax(ref):
    """The row-sharded route at crit > 0 equals the JAX single-device
    route path for path (its sweep ledger is the mesh's own)."""
    _assert_route(ref, "analyzer", _route(PORT_PKG, "analyzer", 2),
                  ledger=False)


@pytest.mark.slow
def test_timing_route_bench_matches_jax(tmp_path):
    ref = _reference(tmp_path / "ref.npz", ["bench"])
    got = _route(PORT_PKG, "bench")
    _assert_route(ref, "bench", got)
    assert float(got["cpd"]) == 4.552000110180643e-09


@pytest.mark.parametrize("crit_exp", [1.0, 2.0])
@pytest.mark.parametrize("name", sorted(STA))
def test_sta_crit_matches_jax(ref, name, crit_exp):
    """crit, Dmax, worst slack and arrivals bit-identical, in
    single-clock and SDC mode (multicycle, input and output delays);
    through sta_crit and through TimingAnalyzer.analyze."""
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer, sta_crit

    tg, sdc, flat = _sta_inputs(PORT_PKG, name)
    ta = TimingAnalyzer(tg, crit_exp=crit_exp, sdc=sdc, device="cpu")
    got = sta_crit(ta.dev, torch.from_numpy(flat), tg.depth, crit_exp,
                   0.99, req_seed=ta._req_seed, use_sdc=sdc is not None)
    want = {k.split("/")[-1]: v for k, v in ref.items()
            if k.startswith(f"sta/{name}/{crit_exp}/")}
    for k, g in zip(("crit", "dmax", "worst", "arr"), got):
        assert np.array_equal(g.numpy(), want[k]), k
    assert (want["crit"] > 0).sum() > 1
    crit = ta.analyze(flat[:-1].reshape(-1, 1))
    assert np.array_equal(crit.ravel(), want["crit"])
    assert ta.crit_path_delay == float(want["dmax"])
    assert ta.worst_slack == float(want["worst"])


@pytest.mark.parametrize("ff_ratio", [0.3, 0.0])
@pytest.mark.parametrize("num_luts", [15, 25])
def test_timing_graph_matches_jax(num_luts, ff_ratio):
    cfg = dict(num_luts=num_luts, num_inputs=4, num_outputs=4,
               chan_width=12, seed=num_luts, ff_ratio=ff_ratio)
    jf, tf = _flow(JAX_PKG, cfg), _flow(PORT_PKG, cfg)
    jg = _mods(JAX_PKG)["timing.graph"].build_timing_graph(jf.nl, jf.pnl,
                                                           jf.term)
    tg = _mods(PORT_PKG)["timing.graph"].build_timing_graph(tf.nl, tf.pnl,
                                                            tf.term)
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert jg.depth > 1 and jg.in_valid.sum() > num_luts


def test_timing_graph_two_clocks_matches_jax():
    jf, tf = _flow(JAX_PKG, "two_clock"), _flow(PORT_PKG, "two_clock")
    jg = _mods(JAX_PKG)["timing.graph"].build_timing_graph(jf.nl, jf.pnl,
                                                           jf.term)
    tg = _mods(PORT_PKG)["timing.graph"].build_timing_graph(tf.nl, tf.pnl,
                                                            tf.term)
    assert tg.domains == jg.domains == ["clk_a", "clk_b"]
    assert tg.inpad_tnode == jg.inpad_tnode
    assert tg.outpad_tnode == jg.outpad_tnode
    assert np.array_equal(tg.endpoint_domain, jg.endpoint_domain)


def _parse(pkg, text):
    """(constraints as a dict, warnings) or the error's type and text."""
    sdc = _mods(pkg)["timing.sdc"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            got = dataclasses.asdict(sdc.parse_sdc(text))
        except ValueError as e:
            return ("ValueError", str(e)), []
    return got, [str(x.message) for x in w]


@pytest.mark.parametrize("case", range(len(PARSE_CASES)))
def test_parse_sdc_matches_jax(case):
    text = PARSE_CASES[case]
    assert _parse(PORT_PKG, text) == _parse(JAX_PKG, text)


def test_analyzer_sdc_errors_match_jax():
    """Undeclared clocks and unknown ports raise in both packages."""
    from parallel_eda_tpu.timing.sta import TimingAnalyzer as JTA
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer as TTA

    for extra in ("set_output_delay -clock clk_b 1.0 nosuch\n",
                  "set_input_delay -clock clk_b 1.0 nosuch\n",
                  "set_input_delay -clock clk_z 1.0 in_b\n"):
        errs = []
        for pkg, cls, kw in ((JAX_PKG, JTA, {}),
                             (PORT_PKG, TTA, {"device": "cpu"})):
            f = _flow(pkg, "two_clock")
            tg = _mods(pkg)["timing.graph"].build_timing_graph(
                f.nl, f.pnl, f.term)
            sdc = _mods(pkg)["timing.sdc"].parse_sdc(SDC_TEXT + extra)
            with pytest.raises(ValueError) as e:
                cls(tg, sdc=sdc, **kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("timing_driven", [True, False])
def test_elmore_oracle_matches_router_delays(timing_driven):
    """The independent Elmore delays over the port's route trees equal
    the JAX package's oracle exactly and the router's own sink delays
    within float32 accumulation (tests/test_timing.py:99); the route
    trees equal JAX's routes_from_result."""
    from parallel_eda_tpu.flow import routes_from_result as j_routes
    from parallel_eda_tpu.timing.elmore import elmore_tree_delays as j_elm
    from parallel_eda_tpu_torch.flow import routes_from_result, run_route
    from parallel_eda_tpu_torch.timing.elmore import elmore_tree_delays

    f = run_route(_flow(PORT_PKG, FIXTURE), _opts(PORT_PKG, dict(
        batch_size=32)), timing_driven=timing_driven, device="cpu")
    assert (f.analyzer is not None) == timing_driven
    trees = routes_from_result(f.term, f.route, f.rr.num_nodes)
    assert trees == j_routes(f.term, f.route, f.rr.num_nodes)
    jrr = _flow(JAX_PKG, FIXTURE).rr
    checked = 0
    for r, ni in enumerate(f.term.net_ids):
        tree = trees[int(ni)]
        d = elmore_tree_delays(f.rr, tree, buffered=True)
        d_pass = elmore_tree_delays(f.rr, tree, buffered=False)
        assert d == j_elm(jrr, tree, buffered=True)
        assert d_pass == j_elm(jrr, tree, buffered=False)
        for s in range(int(f.term.num_sinks[r])):
            sink = int(f.term.sinks[r, s])
            rd = float(f.route.sink_delay[r, s])
            assert abs(d[sink] - rd) < 1e-12 + 1e-5 * abs(rd)
            assert d_pass[sink] >= d[sink] - 1e-15
            checked += 1
    assert checked > 20


def test_run_route_defaults_to_card():
    """run_route and TimingAnalyzer run on the card unless the caller
    asks for the CPU; without a card they raise."""
    from parallel_eda_tpu_torch.flow import run_route
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer

    if torch.cuda.is_available():
        return
    f = _flow(PORT_PKG, FIXTURE)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_route(f)
    tg = _mods(PORT_PKG)["timing.graph"].build_timing_graph(f.nl, f.pnl,
                                                            f.term)
    with pytest.raises(RuntimeError, match="CUDA"):
        TimingAnalyzer(tg)


def test_route_refuses_analyzer_on_another_device():
    from parallel_eda_tpu_torch.route.router import Router
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer

    f = _flow(PORT_PKG, FIXTURE)
    tg = _mods(PORT_PKG)["timing.graph"].build_timing_graph(f.nl, f.pnl,
                                                            f.term)
    ta = TimingAnalyzer(tg, device="cpu")
    ta.dev.arrival0 = ta.dev.arrival0.to("meta")
    with pytest.raises(ValueError, match="analyzer"):
        Router(f.rr, _opts(PORT_PKG, {}), device="cpu").route(
            f.term, analyzer=ta)


if __name__ == "__main__":
    write_reference(sys.argv[1], sys.argv[2:])
