"""The port's serial QoR oracle (parallel_eda_tpu_torch/route/serial_ref.py,
serial_native.py and qor.py) against the JAX package's, on the CPU.

* ``SerialRouter``: each package's heap PathFinder on its own front end
  of the same fixture (the 15-LUT parity fixture, and a unidir graph of
  tests/test_unidir.py's arch with criticalities from a seed): the same
  trees (tree order included), occupancy, wirelength, iterations, heap
  pops and stats rows.
* ``NativeSerialRouter`` (native/serial_route.cc, built by the port into
  its own build directory): equal to the port's ``SerialRouter`` tree
  for tree; skipped at run time where g++ cannot build it.
* ``serial_sink_delays`` and ``QorRow``: the port's against JAX's on the
  same serial trees.
* ``qor_compare``: the port's on the CPU (``device="cpu"``) against
  JAX's on the 15-LUT fixture.  It routes timing-driven, so the JAX
  reference runs under ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (ROADMAP.md
  C2) in the module's one subprocess: this file run as a script.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
# tests/test_unidir.py's arch (length-2 unidir wires, W=14), a smaller
# circuit at its initial placement
UNIDIR = dict(num_luts=20, num_inputs=6, num_outputs=6, K=4, seed=3)
QOR_OPTS = dict(batch_size=32)


def _jax_reference(out_path):
    """Script mode: JAX's qor_compare on the fixture, under the AVX
    flag (set by the parent before JAX starts)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.route.qor import qor_compare
    from parallel_eda_tpu.route.router import RouterOpts

    row = qor_compare(synth_flow(**FIXTURE), "fix15",
                      RouterOpts(**QOR_OPTS))
    with open(out_path, "w") as f:
        json.dump(dataclasses.asdict(row), f)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
    sys.exit(0)


_PROC = {}


@pytest.fixture(scope="module", autouse=True)
def _start_jax_reference(tmp_path_factory):
    """Start the module's one JAX reference subprocess at once, so that
    it runs beside the in-process cases."""
    out = str(tmp_path_factory.mktemp("jax_qor"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    log = open(os.path.join(out, "log.txt"), "w")
    _PROC["p"] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         os.path.join(out, "row.json")], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    _PROC["out"] = out
    yield
    p = _PROC.pop("p")
    if p.poll() is None:
        p.kill()
        p.wait()
    log.close()


@pytest.fixture(scope="module")
def jax_row():
    p = _PROC["p"]
    rc = p.wait(timeout=900)
    out = _PROC["out"]
    assert rc == 0, open(os.path.join(out, "log.txt")).read()[-4000:]
    with open(os.path.join(out, "row.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the port's qor route is many small PyTorch ops
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow(pkg, case):
    import importlib

    flow = importlib.import_module(f"{pkg}.flow")
    if case == "fix15":
        return flow.synth_flow(**FIXTURE)
    builtin = importlib.import_module(f"{pkg}.arch.builtin")
    gen = importlib.import_module(f"{pkg}.netlist.generate")
    arch = builtin.unidir_arch(chan_width=14, length=2)
    nl = gen.generate_circuit(**UNIDIR)
    return flow.prepare(nl, arch, 14, seed=5)


def _crit(term, case):
    if case == "fix15":
        return None
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 0.9, term.sinks.shape)
            * (term.sinks >= 0)).astype(np.float32)


def _result(r):
    return {"success": r.success, "iterations": r.iterations,
            "trees": r.trees, "occ": r.occ.tolist(),
            "wirelength": r.wirelength, "heap_pops": r.heap_pops,
            "stats": r.stats, "timed_out": r.timed_out}


_FLOWS = {}


def _flows(case):
    if case not in _FLOWS:
        _FLOWS[case] = {pkg: _flow(pkg, case) for pkg in
                        ("parallel_eda_tpu", "parallel_eda_tpu_torch")}
    return _FLOWS[case]


@pytest.mark.parametrize("case", ["fix15", "unidir_crit"])
def test_serial_router_matches_jax(case):
    """Each package's SerialRouter on its own front end of the fixture
    (the rr graphs and terminals equal): the same result, field for
    field."""
    from parallel_eda_tpu.route.serial_ref import SerialRouter as JSR
    from parallel_eda_tpu_torch.route.serial_ref import SerialRouter as TSR

    fl = _flows(case)
    jf, tf = fl["parallel_eda_tpu"], fl["parallel_eda_tpu_torch"]
    for k in ("out_row_ptr", "out_dst", "out_switch", "base_cost",
              "capacity"):
        assert np.array_equal(getattr(jf.rr, k), getattr(tf.rr, k)), k
    assert np.array_equal(jf.term.sinks, tf.term.sinks)
    crit = _crit(tf.term, case)
    jr = JSR(jf.rr).route(jf.term, crit=crit)
    tr = TSR(tf.rr).route(tf.term, crit=crit)
    assert tr.success and _result(tr) == _result(jr)
    # the SerialRouteResult contract: TREE order, parents first
    for t in tr.trees:
        seen = set()
        for v, p in t:
            assert p == -1 or p in seen
            seen.add(v)


@pytest.mark.parametrize("case", ["fix15", "unidir_crit"])
def test_native_serial_matches_serial_ref(case):
    """The port's binding of native/serial_route.cc: the same trees,
    occupancy, iterations, heap pops and wirelength as the port's
    SerialRouter, its library built into the port's build directory."""
    from parallel_eda_tpu_torch.route import serial_native as SN
    from parallel_eda_tpu_torch.route.serial_ref import SerialRouter

    if not SN.native_available():
        pytest.skip("g++ cannot build native/serial_route.cc here")
    assert os.path.dirname(SN._SO) == os.path.join(
        REPO, "parallel_eda_tpu_torch", "build")
    tf = _flows(case)["parallel_eda_tpu_torch"]
    crit = _crit(tf.term, case)
    rp = SerialRouter(tf.rr).route(tf.term, crit=crit)
    rn = SN.NativeSerialRouter(tf.rr).route(tf.term, crit=crit)
    assert rp.success == rn.success and rn.success
    assert (rp.iterations, rp.heap_pops, rp.wirelength) == \
        (rn.iterations, rn.heap_pops, rn.wirelength)
    assert np.array_equal(rp.occ, rn.occ)
    assert [sorted(t) for t in rp.trees] == [sorted(t) for t in rn.trees]
    for t in rn.trees:
        seen = set()
        for v, p in t:
            assert p == -1 or p in seen
            seen.add(v)


def test_native_build_installs_by_replace(tmp_path, monkeypatch):
    """A build writes a per-process temporary file and installs it with
    os.replace: the final name never holds a half-written library, and
    no temporary file stays behind."""
    from parallel_eda_tpu_torch.route import serial_native as SN

    if not SN.native_available():
        pytest.skip("g++ cannot build native/serial_route.cc here")
    so = str(tmp_path / "build" / "libserial_route.so")
    monkeypatch.setattr(SN, "_SO", so)
    seen = []
    real = os.replace

    def spy(a, b):
        seen.append((os.path.basename(a), os.path.basename(b),
                     os.path.exists(b)))
        real(a, b)

    monkeypatch.setattr(SN.os, "replace", spy)
    assert SN._build_lib() == so and os.path.exists(so)
    assert seen == [(f"libserial_route.so.tmp.{os.getpid()}",
                     "libserial_route.so", False)]
    assert os.listdir(os.path.dirname(so)) == ["libserial_route.so"]
    assert SN._build_lib() == so and len(seen) == 1   # up to date


def test_serial_sink_delays_and_qor_row_match_jax():
    """serial_sink_delays over the same serial trees, and QorRow's
    deltas, in both packages."""
    from parallel_eda_tpu.route import qor as JQ
    from parallel_eda_tpu_torch.route import qor as TQ
    from parallel_eda_tpu_torch.route.serial_ref import SerialRouter

    for case in ("fix15", "unidir_crit"):
        fl = _flows(case)
        tf, jf = fl["parallel_eda_tpu_torch"], fl["parallel_eda_tpu"]
        r = SerialRouter(tf.rr).route(tf.term, crit=_crit(tf.term, case))
        tsd = TQ.serial_sink_delays(tf.rr, tf.term, r.trees)
        jsd = JQ.serial_sink_delays(jf.rr, jf.term, r.trees)
        assert tsd.dtype == jsd.dtype and np.array_equal(tsd, jsd)
        assert np.isfinite(tsd[tf.term.sinks >= 0]).all()
    args = ("c", 2.5e-9, 2.4e-9, 110, 100, 12, 9, 4)
    t, j = TQ.QorRow(*args), JQ.QorRow(*args)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.cpd_delta_pct, t.wl_delta_pct) == \
        (j.cpd_delta_pct, j.wl_delta_pct)
    assert [f.name for f in dataclasses.fields(TQ.QorRow)] == \
        [f.name for f in dataclasses.fields(JQ.QorRow)]


def test_qor_compare_matches_jax(jax_row):
    """qor_compare on the 15-LUT fixture: the port on the CPU against
    JAX under the AVX flag — every QorRow field equal."""
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route import QorRow, qor_compare
    from parallel_eda_tpu_torch.route.router import RouterOpts

    row = qor_compare(synth_flow(**FIXTURE), "fix15",
                      RouterOpts(**QOR_OPTS), device="cpu")
    assert isinstance(row, QorRow)
    assert dataclasses.asdict(row) == jax_row
    assert np.isfinite(row.device_cpd) and np.isfinite(row.serial_cpd)
    assert row.device_windows <= row.device_iters
