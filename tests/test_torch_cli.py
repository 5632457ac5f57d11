"""The port's CLI (``python -m parallel_eda_tpu_torch``, run on the CPU
with ``--device cpu``) against the JAX package's CLI on the same
arguments: the .net / .place / .route artifacts byte for byte, the
printed lines but for their seconds, the stats files but for their
seconds and clocks, the views, the power report and the post-synthesis
Verilog and SDF, and the names in the --trace file and in metrics.json.

The JAX side is timing-driven, so it runs under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (ROADMAP.md C2: with its default
flags XLA:CPU contracts ``crit*delay + cost`` into an FMA), which has to
be set before JAX starts; this test process has started JAX already
(tests/conftest.py), so one module-scoped fixture runs this file as a
script in a subprocess that runs every JAX case, each in a directory of
its own with the same relative paths the port's case uses (the .place
file names the .net file's path)."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import warnings

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the 25-LUT minimal flow of tests/test_cli.py
BASE = ["--luts", "25", "--arch", "minimal", "--route_chan_width", "12",
        "--batch_size", "16", "--moves_per_step", "16", "--out_dir", "out"]
GOLDEN_XML = os.path.join(REPO, "tests", "golden", "k6_frac_n10_mem.xml")
# name -> arguments; each case runs in <dir>/<name>, the resumes read the
# "timing" case's artifacts, "blif_k6_n10" reads <dir>/mult6x6.blif
CASES = {
    "timing": BASE + ["--draw", "draw", "--power",
                      "--gen_postsynthesis_netlist"],
    "timing_sync": BASE + ["--sync"],
    "no_timing": BASE + ["--no_timing", "--sync"],
    "place_resume": BASE + ["--place_file", "../timing/out/synth.place"],
    "net_resume": BASE + ["--net_file", "../timing/out/synth.net",
                          "--stats_dir", "stats", "--trace", "trace.json"],
    "binary_search": ["--luts", "10", "--arch", "minimal", "--seed", "4",
                      "--batch_size", "16", "--moves_per_step", "16",
                      "--max_router_iterations", "25", "--no_timing",
                      "--binary_search", "--out_dir", "out"],
    "blif_k6_n10": ["../mult6x6.blif", "--arch", "k6_n10", "--batch_size",
                    "32", "--moves_per_step", "32", "--out_dir", "out"],
    "golden_xml": ["--luts", "40", "--arch", GOLDEN_XML, "--batch_size",
                   "32", "--moves_per_step", "32", "--out_dir", "out"],
    # the (net, node) mesh's net axis (ROADMAP C14), and the one-device
    # route it equals
    "mesh": BASE + ["--no_timing", "--mesh", "2x1"],
    "mesh_crop_off": BASE + ["--no_timing", "--crop", "off"],
    # the node axis: the canvases split by columns over two devices
    "mesh_node": BASE + ["--no_timing", "--mesh", "1x2"],
}
TIER1 = ["timing", "no_timing", "place_resume", "net_resume"]
SLOW = ["binary_search", "blif_k6_n10", "golden_xml"]
# the JAX CLI's W_min on the "binary_search" case (checked against the
# JAX package by the slow test_cli_matches_jax[binary_search])
WMIN = 3


def write_inputs(d):
    """The BLIF the "blif_k6_n10" case reads: a 6x6 registered array
    multiplier from the port's generator."""
    from parallel_eda_tpu_torch.netlist.blif import write_blif
    from parallel_eda_tpu_torch.netlist.synthesis import array_multiplier

    os.makedirs(d, exist_ok=True)
    write_blif(array_multiplier(6), os.path.join(d, "mult6x6.blif"))


def run_case(main, name, cwd):
    """Run ``main`` on case ``name`` in ``cwd``/``name``; returns (rc,
    stdout)."""
    d = os.path.join(cwd, name)
    os.makedirs(d, exist_ok=True)
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = main(list(CASES[name]))
    finally:
        os.chdir(old)
    return rc, buf.getvalue()


def write_reference(out_dir, names):
    """Script mode: run the JAX CLI on ``names`` under ``out_dir``."""
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.__main__ import main

    write_inputs(out_dir)
    for name in names:
        t0 = time.time()
        rc, out = run_case(main, name, out_dir)
        with open(os.path.join(out_dir, name, "stdout.txt"), "w") as f:
            f.write(out)
        with open(os.path.join(out_dir, name, "rc.txt"), "w") as f:
            f.write(str(rc))
        print(f"{name}: rc {rc}, {time.time() - t0:.1f}s", file=sys.stderr)


def _jax_reference(d, names, xla_flags=""):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=("--xla_cpu_max_isa=AVX " + xla_flags).strip())
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(d), *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return str(d)


def _port_runs(d, names):
    from parallel_eda_tpu_torch.__main__ import main

    write_inputs(str(d))
    for name in names:
        rc, out = run_case(lambda a: main(a + ["--device", "cpu"]), name,
                           str(d))
        with open(os.path.join(d, name, "stdout.txt"), "w") as f:
            f.write(out)
        with open(os.path.join(d, name, "rc.txt"), "w") as f:
            f.write(str(rc))
    return str(d)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return _jax_reference(tmp_path_factory.mktemp("jax_cli"), TIER1)


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return _port_runs(tmp_path_factory.mktemp("port_cli"), TIER1)


@pytest.fixture(scope="module")
def jax_slow_dir(tmp_path_factory):
    return _jax_reference(tmp_path_factory.mktemp("jax_cli_slow"), SLOW)


@pytest.fixture(scope="module")
def port_slow_dir(tmp_path_factory):
    return _port_runs(tmp_path_factory.mktemp("port_cli_slow"), SLOW)


def _text(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


def _bytes(*parts):
    with open(os.path.join(*parts), "rb") as f:
        return f.read()


def _stdout(d, name):
    """The case's printed lines with every seconds figure masked."""
    return [re.sub(r"\d+\.\d+s\b", "<s>", ln)
            for ln in _text(d, name, "stdout.txt").splitlines()]


def _tree(d, name, sub):
    """{relative path: bytes} of every file under <d>/<name>/<sub>."""
    root = os.path.join(d, name, sub)
    out = {}
    for r, _, files in os.walk(root):
        for f in files:
            p = os.path.join(r, f)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


def _assert_same_run(jd, td, name):
    assert _text(jd, name, "rc.txt") == _text(td, name, "rc.txt") == "0"
    assert _stdout(td, name) == _stdout(jd, name)
    j, t = _tree(jd, name, "out"), _tree(td, name, "out")
    assert any(k.endswith(".route") for k in t)
    assert t == j


@pytest.mark.parametrize("name", TIER1)
def test_cli_matches_jax(jax_dir, port_dir, name):
    """rc, printed lines (seconds aside) and every artifact byte for
    byte: timing-driven (with --draw, --power and
    --gen_postsynthesis_netlist), --no_timing --sync, and the .place and
    .net resumes (the latter with --stats_dir and --trace)."""
    _assert_same_run(jax_dir, port_dir, name)


def test_cli_resumes_give_the_same_route(port_dir):
    """The .place resume routes the timing run's placement to its .route;
    the .net resume re-places the timing run's clusters into its
    placement (and routes it in windows of one iteration, under
    --stats_dir)."""
    assert _bytes(port_dir, "place_resume", "out", "synth.route") == _bytes(
        port_dir, "timing", "out", "synth.route")
    for f in ("synth.net", "synth.place"):
        assert _bytes(port_dir, "net_resume", "out", f) == _bytes(
            port_dir, "timing", "out", f)


def test_cli_sync_matches_jax_default(jax_dir, tmp_path):
    """--sync (the synchronous driver) writes the .net, .place and .route
    bytes of the JAX CLI's default, pipelined run."""
    d = _port_runs(tmp_path, ["timing_sync"])
    assert _text(d, "timing_sync", "rc.txt") == "0"
    for f in ("synth.net", "synth.place", "synth.route"):
        assert _bytes(d, "timing_sync", "out", f) == _bytes(
            jax_dir, "timing", "out", f), f


def test_cli_views_and_post_synthesis_match_jax(jax_dir, port_dir):
    for sub in ("draw", "out"):
        assert _tree(port_dir, "timing", sub) == _tree(jax_dir, "timing",
                                                       sub)
    draw = _tree(port_dir, "timing", "draw")
    assert set(draw) == {"placement.svg", "routing.svg", "viewer.html"}
    out = _tree(port_dir, "timing", "out")
    assert {"synth_post_synthesis.v", "synth_post_synthesis.sdf",
            "primitives.v"} <= set(out)


def _stats_rows(d, name, fname, skip):
    """The stats file's rows with the seconds columns ``skip`` left
    out."""
    rows = [ln.split() for ln in _text(d, name, "stats", fname)
            .splitlines()]
    return [[v for i, v in enumerate(r) if i not in skip(r)] for r in rows]


def test_cli_stats_dir_matches_jax(jax_dir, port_dir):
    """The .net resume's --stats_dir: iter_stats.txt and final_stats.txt
    equal in every column but the seconds, route_report.txt equal, one
    iter_stats row per iteration (windows of one iteration), and the
    mdclog records equal but for their clocks."""
    it_skip = (lambda r: {1} if r[0] != "iteration" else set())
    fin_skip = (lambda r: {1} if r[0] == "total_route_time" else set())
    for fname, skip in (("iter_stats.txt", it_skip),
                        ("final_stats.txt", fin_skip)):
        assert _stats_rows(port_dir, "net_resume", fname, skip) == \
            _stats_rows(jax_dir, "net_resume", fname, skip)
    rows = _stats_rows(port_dir, "net_resume", "iter_stats.txt", it_skip)[1:]
    assert [int(r[0]) for r in rows] == list(range(1, len(rows) + 1))
    assert _text(port_dir, "net_resume", "stats", "route_report.txt") == \
        _text(jax_dir, "net_resume", "stats", "route_report.txt")

    def logs(d):
        out = {}
        for rel, body in _tree(d, "net_resume", os.path.join("stats",
                                                         "logs")).items():
            recs = [json.loads(ln) for ln in body.decode().splitlines()]
            for r in recs:
                assert isinstance(r.pop("t"), float)
            out[rel] = recs
        return out
    t = logs(port_dir)
    assert t == logs(jax_dir)
    assert os.path.join("window_1", "timing.log") in t
    files = set(os.listdir(os.path.join(port_dir, "net_resume", "stats")))
    assert files == {"iter_stats.txt", "final_stats.txt",
                     "route_report.txt", "logs", "metrics.json",
                     "devprof.json"}
    assert set(os.listdir(os.path.join(jax_dir, "net_resume",
                                       "stats"))) == files

    # devprof.json is compared by its keys and its variant set, not its
    # bytes: JAX's records hold XLA's cost analysis, the port's the
    # card's CUDA-event times (on the CPU: "unavailable")
    def devprof(d):
        with open(os.path.join(d, "net_resume", "stats",
                               "devprof.json")) as f:
            return json.load(f)
    tdp, jdp = devprof(port_dir), devprof(jax_dir)
    assert set(tdp) == set(jdp) == {"delta_band_log10", "records",
                                    "summary"}
    assert sorted(json.dumps(r["key"]) for r in tdp["records"]) == \
        sorted(json.dumps(r["key"]) for r in jdp["records"])
    assert all(r["unavailable"] == "cpu tensors: no CUDA events"
               for r in tdp["records"])


# what the JAX CLI's trace and metrics.json hold that the port's do not:
# XLA's compile phases (the port builds its CUDA libraries instead, as
# "cuda.build" spans, on the card only), and the devprof gauges of XLA's
# cost analysis (the port's route.devcost.* are CUDA-event times, which a
# CPU run does not have)
COMPILE_SPANS = ("jax.compile.",)
A13_REST = ("route.devcost.",)


def _trace_names(d):
    with open(os.path.join(d, "net_resume", "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    return {(e["name"], e["ph"]) for e in evs
            if e["ph"] != "M" and not e["name"].startswith(COMPILE_SPANS)}


def _metric_names(d):
    with open(os.path.join(d, "net_resume", "stats", "metrics.json")) as f:
        doc = json.load(f)
    names = set(doc["values"])
    for s in doc["snapshots"]:
        names |= set(s["values"])
    return ({n for n in names if not n.startswith(A13_REST)},
            [s["labels"]["phase"] for s in doc["snapshots"]])


def test_cli_trace_and_metrics_names_match_jax(jax_dir, port_dir):
    """--trace and --stats_dir on the .net resume: the trace's event
    names (span, counter track) and metrics.json's instrument names and
    snapshot phases are the JAX CLI's, but for XLA's compile spans and
    the devprof gauges (A13_REST); the kernel-layout gauges are there in
    both."""
    t = _trace_names(port_dir)
    assert {("route.window", "X"), ("route.pipeline.plan", "X"),
            ("route.kernel", "X"), ("place.segment", "X"),
            ("route.overused_nodes", "C")} <= t
    assert t == _trace_names(jax_dir)
    names, phases = _metric_names(port_dir)
    assert {"route.dispatch.compiles", "route.wirelength", "place.t",
            "route.kernel.fused_rungs", "route.kernel.lane_occupancy",
            "route.kernel.bytes_per_sweep",
            "route.kernel.packed_block_size"} <= names
    assert (names, phases) == _metric_names(jax_dir)


def test_cli_binary_search_wmin(tmp_path, monkeypatch):
    """--binary_search --no_timing finds the JAX CLI's W_min; the route
    there is legal and one track less fails (the same placement, read
    back from the .place file)."""
    from parallel_eda_tpu_torch.__main__ import main

    d = _port_runs(tmp_path, ["binary_search"])
    out = _text(d, "binary_search", "stdout.txt")
    assert f"binary search: W_min = {WMIN}\n" in out
    assert _text(d, "binary_search", "rc.txt") == "0"
    monkeypatch.chdir(os.path.join(d, "binary_search"))
    args = [a for a in CASES["binary_search"] if a != "--binary_search"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args + ["--place_file", "out/synth.place",
                          "--route_chan_width", str(WMIN - 1),
                          "--out_dir", "narrow", "--device", "cpu"])
    assert rc == 1
    assert "ROUTING FAILED after 25 iterations" in buf.getvalue()


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_cli_matches_jax_slow(jax_slow_dir, port_slow_dir, name):
    """--binary_search --no_timing, a BLIF on the k6_n10 arch
    (timing-driven, W=40) and the golden VTR7 XML arch (length-4 unidir
    segments, the file's own timing): the same runs as the JAX CLI's."""
    _assert_same_run(jax_slow_dir, port_slow_dir, name)
    if name == "binary_search":
        assert f"binary search: W_min = {WMIN}" in _text(
            jax_slow_dir, name, "stdout.txt")


@pytest.mark.slow
def test_cli_mesh_matches_unmeshed(tmp_path):
    """--mesh 2x1 is the JAX CLI's (net, node) mesh (ROADMAP C14): rc,
    printed lines (the "route mesh: 2 net x 1 node devices" line
    included) and every artifact of the JAX CLI's --mesh 2x1 run, whose
    eight virtual CPU devices the JAX side gets from XLA_FLAGS; and the
    .route of the unmeshed run at --crop off (a mesh keeps full
    canvases)."""
    jd = _jax_reference(tmp_path / "jax", ["mesh"],
                        "--xla_force_host_platform_device_count=8")
    td = _port_runs(tmp_path / "port", ["mesh", "mesh_crop_off"])
    _assert_same_run(jd, td, "mesh")
    assert "route mesh: 2 net x 1 node devices" in _text(td, "mesh",
                                                         "stdout.txt")
    assert _bytes(td, "mesh", "out", "synth.route") == _bytes(
        td, "mesh_crop_off", "out", "synth.route")


def test_cli_flags_are_the_jax_clis_plus_device():
    from parallel_eda_tpu.__main__ import build_parser as jax_parser
    from parallel_eda_tpu_torch.__main__ import build_parser

    def flags(p):
        return {(a.dest, tuple(a.option_strings), a.default)
                for a in p._actions if a.dest != "device"}
    assert flags(build_parser()) == flags(jax_parser())
    dev = next(a for a in build_parser()._actions if a.dest == "device")
    assert dev.default == "cuda" and tuple(dev.choices) == ("cuda", "cpu")
    assert "--device" in build_parser().format_help()


CONFLICTS = [
    ["--binary_search", "--route_chan_width", "24"],
    ["--binary_search", "--no_route"],
    ["--place_file", "p.place", "--no_place"],
    ["--mesh", "bogus"],
    ["--mesh", "0x2"],
    ["--sink_group", "-1"],
    ["--crop", "9"],
    ["--crop", "4x4", "--mesh", "2x1"],
    ["--batch_size", "0"],
    ["--timing_tradeoff", "1.5"],
    ["--sdc", "x.sdc", "--no_timing"],
    ["--profile", "p", "--no_route"],
]


@pytest.mark.parametrize("argv", CONFLICTS, ids=lambda a: "_".join(a))
def test_cli_conflicts_match_jax(argv):
    from parallel_eda_tpu.__main__ import main as jax_main
    from parallel_eda_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as j:
        jax_main(list(argv))
    with pytest.raises(SystemExit) as t:
        main(list(argv))
    assert str(t.value) == str(j.value)
    assert str(t.value).startswith("option errors:")


def test_cli_settings_file(tmp_path, monkeypatch):
    """The settings file supplies defaults, explicit flags win (the JAX
    CLI's apply_settings_file on the same file and argv)."""
    from parallel_eda_tpu.__main__ import apply_settings_file as jax_apply
    from parallel_eda_tpu_torch.__main__ import apply_settings_file, main

    sf = tmp_path / "settings.txt"
    sf.write_text("# defaults\nluts 20\nroute_chan_width 16\n"
                  "moves_per_step 16\nno_timing\n--device cpu\n")
    argv = ["--settings_file", str(sf), "--out_dir", "o", "--luts", "12"]
    assert apply_settings_file(argv, str(sf)) == jax_apply(argv, str(sf))
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    out = buf.getvalue()
    assert "synthetic circuit: synth: {" in out and "'lut': 12" in out
    assert "rr graph" in out and (tmp_path / "o" / "synth.route").exists()
    with pytest.raises(SystemExit, match="--settings_file"):
        main(["--settings_file", str(tmp_path / "missing.txt")])


@pytest.mark.parametrize("argv,item", [
    (["serve", "--help"], "A14"), (["daemon", "run"], "A14"),
    (["--trace", "t.json"], "A13"), (["--compile_cache_dir", "c"], "A14")])
def test_cli_unported_fail_naming_roadmap(argv, item, port_dir):
    """What the port does not do fails naming its ROADMAP.md item, and
    no item is left (``_SUBCOMMANDS`` is empty).  ``serve`` (A14.1-3) is
    ported: its help exits 0.  So are ``daemon`` (A14.4) and ``daemon
    fleet`` (A14.5): their help exits 0 (tests/test_torch_daemon.py
    drives run, submit and status, tests/test_torch_fleet.py the fleet).
    So is ``--compile_cache_dir`` (A14.3): check_options accepts it.
    ``--trace`` (A13) is ported: the .net resume's run wrote its trace,
    exported after the flow, with the flow's stages in it."""
    from parallel_eda_tpu_torch.__main__ import (_SUBCOMMANDS, build_parser,
                                                 check_options, main)

    if argv[0] in ("serve", "daemon"):
        assert _SUBCOMMANDS == {}
        for sub in ([argv[0]], ["daemon", "fleet"]):
            with pytest.raises(SystemExit) as ei:
                main([*sub, "--help"])
            assert ei.value.code == 0
        return
    if argv[0] == "--trace":
        assert "trace in trace.json (open in Perfetto" in _text(
            port_dir, "net_resume", "stdout.txt")
        with open(os.path.join(port_dir, "net_resume", "trace.json")) as f:
            doc = json.load(f)
        stages = {e["name"] for e in doc["traceEvents"]
                  if e.get("cat") == "stage"}
        assert {"pack", "rr_graph", "place", "route"} <= stages
        return
    args = build_parser().parse_args(argv)
    check_options(args)
    assert args.compile_cache_dir == "c"


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without --device the CLI asks for the card and, with none, fails
    before any work (no CPU fallback)."""
    import torch

    from parallel_eda_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(list(BASE))
    assert not (tmp_path / "out").exists()


def test_cli_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    from parallel_eda_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(BASE + ["--no_timing", "--no_place", "--profile",
                            "prof", "--device", "cpu"]) == 0
    assert "profiler trace in prof" in buf.getvalue()
    with open(tmp_path / "prof" / "route_trace.json") as f:
        assert json.load(f)["traceEvents"]


if __name__ == "__main__":
    write_reference(sys.argv[1], sys.argv[2:])
