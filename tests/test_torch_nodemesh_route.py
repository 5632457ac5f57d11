"""The (net, node) mesh's node axis through the port's Router against
the JAX Router's mesh routes on the 8-device virtual CPU mesh of
tests/conftest.py (the port's members are "cpu").  Exact equality of
every RouteResult field and stats row.

Tier-1: the 15-LUT parity fixture at (1, 2) and (2, 2).  ``slow``:
tests/test_parallel.py's fixtures at their node meshes (the window
program with the device STA at (2, 4) and (4, 2), the windowed ELL route
and the full loop at (4, 2), the multislice mesh with
node_per_slice=2)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tests.test_torch_nodemesh import cpu_mesh, jax_mesh  # noqa: E402
from tests.test_torch_parallel import (  # noqa: E402
    LOOP_FIXTURE, _big_grid_flow)
from tests.test_torch_route import FIXTURE, _assert_same_route  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small-op CPU work: one PyTorch thread (six xdist workers share
    the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the Router over a node mesh


def _routes(shape, cfg=FIXTURE, **opts):
    """(the port's route on the CPU over ``shape``, its metrics, the JAX
    Router's mesh route) of ``cfg``."""
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    tf = synth_flow(**cfg)
    reg = MetricsRegistry(enabled=True)
    old = set_metrics(reg)
    try:
        tres = Router(tf.rr, RouterOpts(**opts), device="cpu",
                      mesh=cpu_mesh(shape)).route(tf.term)
    finally:
        set_metrics(old)
    assert tres.success
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)
    jf = jsynth(**cfg)
    jres = JRouter(jf.rr, JOpts(pipeline=False, **opts),
                   mesh=jax_mesh(shape)).route(jf.term)
    return tres, reg.values(), jres


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_router_node_mesh_matches_jax(shape):
    """The 15-LUT parity fixture at a node mesh: every RouteResult field
    and stats row = the JAX Router's mesh route; legal; one blocking host
    read a window (route.pipeline.blocking_syncs), as one device makes
    pipelined."""
    tres, tv, jres = _routes(shape, batch_size=32)
    _assert_same_route(jres, tres)
    assert tv["route.pipeline.blocking_syncs"] == len(tres.stats) > 0


# --------------------------------------------------------------------------
# slow: tests/test_parallel.py's node-mesh fixtures


@pytest.mark.slow
def test_full_route_loop_node_mesh_matches_jax():
    """tests/test_parallel.py's full-loop fixture at (4, 2)."""
    tres, _, jres = _routes((4, 2), LOOP_FIXTURE, batch_size=16)
    _assert_same_route(jres, tres)


@pytest.mark.slow
def test_multislice_mesh_matches_jax():
    """make_multislice_mesh(2, 4, node_per_slice=2) (a (4, 2) mesh, each
    node row inside one slice) on the full-loop fixture = the JAX
    Router's multislice route."""
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.parallel import make_multislice_mesh as jmm
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.parallel import make_multislice_mesh
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    mesh = make_multislice_mesh(2, 4, node_per_slice=2,
                                devices=["cpu"] * 8)
    assert mesh.shape == {"net": 4, "node": 2}
    tf = synth_flow(**LOOP_FIXTURE)
    tres = Router(tf.rr, RouterOpts(batch_size=16), mesh=mesh).route(
        tf.term)
    jf = jsynth(**LOOP_FIXTURE)
    jres = JRouter(jf.rr, JOpts(batch_size=16, pipeline=False),
                   mesh=jmm(2, 4, node_per_slice=2)).route(jf.term)
    _assert_same_route(jres, tres)


@pytest.mark.slow
def test_ell_windowed_node_mesh_matches_jax():
    """tests/test_parallel.py's windowed ELL fixture at (4, 2): the
    global steps' relaxation rows split over each node row, the windowed
    steps on each row's first device."""
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    opts = dict(batch_size=16, program="ell", sink_group=1, windowed=True)
    jf = _big_grid_flow("parallel_eda_tpu", 13)
    jres = JRouter(jf.rr, JOpts(pipeline=False, **opts),
                   mesh=jax_mesh((4, 2))).route(jf.term)
    tf = _big_grid_flow("parallel_eda_tpu_torch", 13)
    tres = Router(tf.rr, RouterOpts(**opts), mesh=cpu_mesh((4, 2))).route(
        tf.term)
    assert tres.windowed_nets == jres.windowed_nets > 0
    _assert_same_route(jres, tres)


def _timing_reference(out, shape):
    """Script mode: JAX's timing-driven mesh route of the full-loop
    fixture at ``shape`` under the AVX flag (ROADMAP C2)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.route import Router, RouterOpts
    from parallel_eda_tpu.timing import TimingAnalyzer, build_timing_graph

    f = synth_flow(**LOOP_FIXTURE)
    ta = TimingAnalyzer(build_timing_graph(f.nl, f.pnl, f.term))
    r = Router(f.rr, RouterOpts(batch_size=16, pipeline=False),
               mesh=jax_mesh(shape)).route(f.term, analyzer=ta)
    np.savez(out, paths=r.paths, occ=r.occ, sink_delay=r.sink_delay,
             it=r.iterations, wl=r.wirelength, cpd=ta.crit_path_delay)


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_timing_route_node_mesh_matches_jax(tmp_path, shape):
    """tests/test_parallel.py's window program with the device STA at a
    node mesh: paths, occupancy, sink delays, iterations and the
    critical path equal JAX's (run in a subprocess under the AVX
    flag)."""
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.timing.graph import build_timing_graph
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer

    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out), f"{shape[0]}x{shape[1]}"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    j = np.load(out)
    f = synth_flow(**LOOP_FIXTURE)
    ta = TimingAnalyzer(build_timing_graph(f.nl, f.pnl, f.term),
                        device="cpu")
    r = Router(f.rr, RouterOpts(batch_size=16), mesh=cpu_mesh(shape)).route(
        f.term, analyzer=ta)
    assert r.success
    assert (r.iterations, r.wirelength) == (int(j["it"]), int(j["wl"]))
    assert np.array_equal(r.paths, j["paths"])
    assert np.array_equal(r.occ, j["occ"])
    assert np.array_equal(r.sink_delay, j["sink_delay"])
    assert ta.crit_path_delay == float(j["cpd"])


if __name__ == "__main__":
    _timing_reference(sys.argv[1],
                      tuple(int(v) for v in sys.argv[2].split("x")))
