"""The (net, node) mesh's net axis in the port (parallel/shard.py,
route/netsplit.py) against the JAX package's mesh on the 8-device
virtual CPU mesh of tests/conftest.py: the port's members are "cpu"
(``make_mesh(n, devices=["cpu"] * n)``).  Exact equality throughout.

Tier-1: ShardedRouter.route_step at net axis 2 and 4 on the 25-LUT step
fixture of tests/test_parallel.py, the mesh's errors, a full route at
net axis 2 on the 15-LUT parity fixture, the batch rounded up to a
multiple of the net axis (3), and the ELL program's windowed step split
over two members.  ``slow``: the JAX fixtures at (4, 1) (the planes
route, timing-driven with its JAX reference under the AVX flag, ROADMAP
C2; the ELL windowed route), resumes across net meshes, a full route at
net axis 3, and the 300-LUT W=16 ELL config against the JAX package
(ROADMAP C10)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tests.test_torch_route import FIXTURE, _assert_same_route  # noqa: E402

# the 25-LUT step fixture of tests/test_parallel.py
STEP_FIXTURE = dict(num_luts=25, chan_width=12, seed=2)
STEP_STATICS = dict(max_steps=96, max_len=96, num_waves=2, group=1)
# the full-loop fixture of tests/test_parallel.py
LOOP_FIXTURE = dict(num_luts=20, chan_width=10, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small-op CPU work: one PyTorch thread (six xdist workers share
    the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n, shape=None):
    from parallel_eda_tpu_torch.parallel import make_mesh

    return make_mesh(n, shape=shape, devices=["cpu"] * n)


def jax_mesh(n, shape=None):
    from parallel_eda_tpu.parallel.shard import make_mesh

    return make_mesh(n, shape=shape)


# --------------------------------------------------------------------------
# the mesh value


def test_make_mesh_shape_and_errors_match_jax():
    from parallel_eda_tpu.parallel import shard as J
    from parallel_eda_tpu_torch.parallel import shard as T

    for shape in (None, (4, 2), (2, 4), (8, 1), (1, 8)):
        jm, tm = J.make_mesh(8, shape=shape), T.make_mesh(
            8, shape=shape, devices=["cpu"] * 8)
        assert dict(tm.shape) == dict(jm.shape)
        assert tm.devices.shape == jm.devices.shape
        assert all(d == torch.device("cpu") for d in tm.devices.flat)
    # the shape checks' messages are JAX's
    for shape in ((4,), (0, 8), (3, 2), (2.0, 4)):
        with pytest.raises(ValueError) as j:
            J.make_mesh(8, shape=shape)
        with pytest.raises(ValueError) as t:
            T.make_mesh(8, shape=shape, devices=["cpu"] * 8)
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        T.make_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="asked for 3 devices but only 2"):
        T.make_mesh(3, devices=["cpu"] * 2)
    assert T.make_mesh(2, devices=["cpu"] * 2) == cpu_mesh(2)
    assert cpu_mesh(2) != cpu_mesh(2, shape=(1, 2))


def test_multislice_mesh_matches_jax():
    from parallel_eda_tpu.parallel import make_multislice_mesh as jmm
    from parallel_eda_tpu_torch.parallel import make_multislice_mesh as tmm

    for args in ((2, 4, 2), (2, 4, 1), (4, 2, 2)):
        jm = jmm(*args)
        tm = tmm(*args, devices=["cpu"] * 8)
        assert dict(tm.shape) == dict(jm.shape)
    for args in ((0, 4, 1), (2, 3, 2), (4, 4, 1)):
        with pytest.raises(ValueError) as j:
            jmm(*args)
        with pytest.raises(ValueError) as t:
            tmm(*args, devices=["cpu"] * 8)
        assert str(t.value) == str(j.value)


# --------------------------------------------------------------------------
# ShardedRouter.route_step (search.route_and_commit over the net axis)


def _step_inputs(B):
    """The step fixture's arrays as numpy (tests/test_parallel.py
    _setup): the first B nets, padded."""
    from parallel_eda_tpu_torch.flow import synth_flow

    f = synth_flow(**STEP_FIXTURE)
    rr, term = f.rr, f.term
    N = rr.num_nodes
    R, Smax = term.sinks.shape
    take = min(B, R)

    def pad(a, fill):
        out = np.full((B,) + a.shape[1:], fill, dtype=a.dtype)
        out[:take] = a[:take]
        return out

    return f.rr, dict(
        source=pad(term.source.astype(np.int32), 0),
        sinks=pad(term.sinks.astype(np.int32), -1),
        bb=pad(np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                         term.bb_ymax], axis=1).astype(np.int32), 0),
        crit=np.zeros((B, Smax), np.float32),
        net_key=pad(np.arange(R, dtype=np.int32), 0),
        valid=np.arange(B) < take,
        prev_paths=np.full((B, Smax, 96), N, np.int32),
        occ=np.zeros(N, np.int32), acc=np.ones(N, np.float32))


_ORDER = ("prev_paths", "source", "sinks", "bb", "crit", "net_key", "valid")


def _jax_step(n, B=8):
    """JAX's ShardedRouter.route_step at net axis ``n`` (None: JAX's
    one-device route_and_commit) on the step fixture, as numpy."""
    import jax.numpy as jnp
    from jax import tree_util

    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.parallel.shard import ShardedRouter
    from parallel_eda_tpu.route.device_graph import to_device
    from parallel_eda_tpu.route.search import route_and_commit

    _, a = _step_inputs(B)
    dev = to_device(synth_flow(**STEP_FIXTURE).rr)
    x = {k: jnp.asarray(v) for k, v in a.items()}
    args = (x["occ"], x["acc"], jnp.float32(0.5)) + tuple(
        x[k] for k in _ORDER)
    if n is None:
        out = route_and_commit(dev, *args, **STEP_STATICS)
    else:
        r = ShardedRouter(jax_mesh(n))
        out = r.route_step(r.shard_graph(dev), *args, **STEP_STATICS)
    return tree_util.tree_map(np.asarray, tuple(out))


def _port_step(n, B=8):
    from parallel_eda_tpu_torch.parallel import ShardedRouter
    from parallel_eda_tpu_torch.route.device_graph import to_device

    rr, a = _step_inputs(B)
    dev = to_device(rr, "cpu", ell=True)
    x = {k: torch.from_numpy(v) for k, v in a.items()}
    r = ShardedRouter(cpu_mesh(n))
    out = r.route_step(r.shard_graph(dev), x["occ"], x["acc"], 0.5,
                       *(x[k] for k in _ORDER), **STEP_STATICS)
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax(n):
    """paths, reached, delay, committed occupancy and relax steps of the
    port's net-axis step = JAX's ShardedRouter.route_step on (n, 1) =
    JAX's one-device route_and_commit."""
    from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics

    reg = MetricsRegistry(enabled=True)
    old = set_metrics(reg)
    try:
        t = _port_step(n)
    finally:
        set_metrics(old)
    j = _jax_step(n)
    j1 = _jax_step(None)
    for a, b, c in zip(t, j, j1):
        assert np.array_equal(a, b, equal_nan=True)
        assert np.array_equal(b, c, equal_nan=True)
    v = reg.values()
    assert v["shard.route_steps"] == 1
    assert (v["shard.batch_per_device"], v["shard.mesh_net"],
            v["shard.mesh_node"]) == (8 // n, n, 1)


def test_sharded_step_errors():
    """A batch the net axis does not divide raises JAX's ValueError; a
    node axis > 1 routes (the call that raised before the node axis was
    ported): equal to the one-device route_and_commit."""
    from parallel_eda_tpu.parallel.shard import ShardedRouter as JSR
    from parallel_eda_tpu_torch.parallel import ShardedRouter

    rr, a = _step_inputs(6)
    x = {k: torch.from_numpy(v) for k, v in a.items()}
    args = (None, x["occ"], x["acc"], 0.5) + tuple(x[k] for k in _ORDER)
    with pytest.raises(ValueError) as t:
        ShardedRouter(cpu_mesh(4)).route_step(*args, **STEP_STATICS)
    with pytest.raises(ValueError) as j:
        JSR(jax_mesh(4)).route_step(*args, **STEP_STATICS)
    assert str(t.value) == str(j.value) == \
        "batch 6 not divisible by net axis 4"
    from parallel_eda_tpu_torch.route.device_graph import to_device
    from parallel_eda_tpu_torch.route.search import route_and_commit

    rr, a = _step_inputs(8)
    dev = to_device(rr, "cpu", ell=True)
    x = {k: torch.from_numpy(v) for k, v in a.items()}
    args = (x["occ"], x["acc"], 0.5) + tuple(x[k] for k in _ORDER)
    got = ShardedRouter(cpu_mesh(4, shape=(2, 2))).route_step(
        dev, *args, **STEP_STATICS)
    want = route_and_commit(dev, *args, **STEP_STATICS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_planes_relax_net_mesh_matches_jax(n=4):
    """planes.planes_relax with a mesh (JAX planes.py:907-975: the
    canvases' batch on the net axis) = JAX's planes_relax on the same
    inputs, every output and the stats."""
    import jax.numpy as jnp

    from parallel_eda_tpu.route import planes as JP
    from parallel_eda_tpu_torch.route import planes as TP
    from tests.test_torch_planes import to_port
    from tests.test_torch_shard import _instance

    pg, tpg, args, ref = _instance("minimal")          # B = 4
    jout = JP.planes_relax(pg, *(jnp.asarray(x) for x in args), 24,
                           mesh=jax_mesh(n, shape=(n, 1)))
    out = TP.planes_relax(to_port(pg), *(torch.from_numpy(x) for x in args),
                          24, mesh=cpu_mesh(n))
    for a, b, c in zip(out, jout, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(np.asarray(b), c)


# --------------------------------------------------------------------------
# the Router over a net mesh


def test_router_mesh_errors_match_jax():
    """program="planes_pallas" and mesh_shards > 1 with a mesh raise the
    JAX Router's ValueErrors; so does a mesh of another device type than
    the Router's.  A node axis > 1 routes, as the JAX Router's does (the
    Router that raised before the node axis was ported): legal."""
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    jf, tf = jsynth(**FIXTURE), synth_flow(**FIXTURE)
    for kw in (dict(program="planes_pallas"), dict(mesh_shards=2)):
        with pytest.raises(ValueError) as j:
            JRouter(jf.rr, JOpts(**kw), mesh=jax_mesh(2))
        with pytest.raises(ValueError) as t:
            Router(tf.rr, RouterOpts(**kw), mesh=cpu_mesh(2))
        assert str(t.value) == str(j.value)
    from parallel_eda_tpu_torch.route.check import check_route

    res = Router(tf.rr, RouterOpts(), mesh=cpu_mesh(2, shape=(1, 2))
                 ).route(tf.term)
    assert res.success
    check_route(tf.rr, tf.term, res.paths, occ=res.occ)
    with pytest.raises(ValueError, match="device type"):
        Router(tf.rr, RouterOpts(), device="cpu",
               mesh=cpu_mesh_of("meta", 2))


def cpu_mesh_of(device, n):
    from parallel_eda_tpu_torch.parallel import make_mesh

    return make_mesh(n, devices=[device] * n)


_ROUTES: dict = {}


def _port_route(n, cfg=FIXTURE, **opts):
    """The port's route of ``cfg`` on the CPU over a net mesh of ``n``
    (None: one device) with a fresh metrics registry; cached."""
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    key = (n, tuple(sorted(cfg.items())), tuple(sorted(opts.items())))
    if key not in _ROUTES:
        f = synth_flow(**cfg)
        reg = MetricsRegistry(enabled=True)
        old = set_metrics(reg)
        try:
            r = Router(f.rr, RouterOpts(**opts), device="cpu",
                       mesh=None if n is None else cpu_mesh(n))
            res = r.route(f.term)
        finally:
            set_metrics(old)
        _ROUTES[key] = f, r, res, reg.values()
    return _ROUTES[key]


def _jax_route(n, cfg=FIXTURE, **opts):
    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts

    jf = synth_flow(**cfg)
    return jf, JRouter(jf.rr, JOpts(pipeline=False, **opts),
                       mesh=jax_mesh(n)).route(jf.term)


def test_router_net_mesh_matches_jax():
    """The 15-LUT parity fixture at net axis 2: every RouteResult field
    and stats row = the JAX Router's mesh route, legal; one blocking
    host read a window (route.pipeline.blocking_syncs), as one device
    makes pipelined."""
    from parallel_eda_tpu_torch.route.check import check_route

    tf, _, tres, tv = _port_route(2, batch_size=32)
    jf, jres = _jax_route(2, batch_size=32)
    _assert_same_route(jres, tres)
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)
    assert tv["route.pipeline.blocking_syncs"] == len(tres.stats) > 0


def test_batch_rounding_matches_jax():
    """Net axis 3 and batch 32: B = 33, the plan width stays B, and the
    groups' membership is the JAX Router's."""
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    cfg = dict(num_luts=60, num_inputs=12, num_outputs=12, chan_width=12,
               seed=11)
    tf, jf = synth_flow(**cfg), jsynth(**cfg)
    term = tf.term
    R = len(term.source)
    r = Router(tf.rr, RouterOpts(batch_size=32), device="cpu",
               mesh=cpu_mesh(3))
    jr = JRouter(jf.rr, JOpts(batch_size=32), mesh=jax_mesh(3))
    B = r._batch(R)
    assert B == 33
    nsinks = term.num_sinks.astype(np.int64)
    cx = ((term.bb_xmin + term.bb_xmax) // 2).astype(np.int64)
    cy = ((term.bb_ymin + term.bb_ymax) // 2).astype(np.int64)
    rng = np.random.default_rng(5)
    for dirty, colors in ((np.arange(R), None),
                          (np.sort(rng.choice(R, 9, replace=False)), None),
                          (np.arange(R), rng.integers(0, 3, R))):
        t = r._plan_groups(dirty, colors, nsinks, cx, cy, B)
        j = jr._plan_groups(dirty, colors, nsinks, cx, cy, B, R)
        assert t[0].shape[1] == B
        for a, b in zip(t, j):
            assert np.array_equal(a, b)
    # one device narrows the plan width of a small dirty set
    r1 = Router(tf.rr, RouterOpts(batch_size=32), device="cpu")
    assert r1._plan_groups(np.arange(9), None, nsinks, cx, cy,
                           32)[0].shape[1] == 16


def test_ell_windowed_step_split_matches_one_device():
    """The ELL program's windowed and global steps split over two
    members (route_batch_resident_win / route_batch_resident with
    ``mesh``): the route equals the one-device route field for field."""
    opts = dict(batch_size=16, program="ell", sink_group=1, windowed=True,
                window_max_frac=1.5)
    _, _, r1, _ = _port_route(None, **opts)
    _, _, r2, _ = _port_route(2, **opts)
    assert r1.windowed_nets > 0 and r2.windowed_nets == r1.windowed_nets
    _assert_same_route(r1, r2)


def test_member_copy_per_device_lives_with_its_graph():
    """A member on another device than the graph gets its own copy,
    built once and dropped with the graph; a member on the graph's device
    uses the graph itself (the CPU routes above make no copy)."""
    import gc

    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.parallel import shard_graph
    from parallel_eda_tpu_torch.route import netsplit
    from parallel_eda_tpu_torch.route.device_graph import to_device

    dev = to_device(synth_flow(**FIXTURE).rr, "cpu")
    meta = torch.device("meta")
    cp = netsplit.member_copy(dev, meta)
    assert cp is not dev and cp.capacity.device == meta
    assert cp.capacity.shape == dev.capacity.shape
    assert netsplit.member_copy(dev, meta) is cp
    assert netsplit.member_copy(dev, torch.device("cpu")) is dev
    assert shard_graph(dev, cpu_mesh(2)) == [dev, dev]
    n = len(netsplit._COPIES)
    del dev, cp
    gc.collect()
    assert len(netsplit._COPIES) == n - 1


def test_cli_mesh_node_axis_matches_crop_off(tmp_path):
    """--device cpu --mesh 1x2 (the node axis: each canvas split by
    columns over two CPU members) writes the artifacts and prints the
    lines of the unmeshed --crop off run (a mesh keeps full canvases),
    seconds aside, and its "route mesh:" line."""
    from tests.test_torch_cli import _port_runs, _stdout, _tree

    d = _port_runs(tmp_path, ["mesh_node", "mesh_crop_off"])
    node, off = _stdout(d, "mesh_node"), _stdout(d, "mesh_crop_off")
    mesh_line = "route mesh: 1 net x 2 node devices"
    assert mesh_line in node
    assert [ln for ln in node if ln != mesh_line] == off
    out = _tree(d, "mesh_node", "out")
    assert any(k.endswith(".route") for k in out)
    assert out == _tree(d, "mesh_crop_off", "out")


# --------------------------------------------------------------------------
# slow: the JAX package's mesh fixtures


@pytest.mark.slow
def test_router_net_mesh_3_matches_jax():
    """Net axis 3 (B rounded to 33): the JAX Router's mesh route."""
    tf, _, tres, _ = _port_route(3, batch_size=32)
    _, jres = _jax_route(3, batch_size=32)
    _assert_same_route(jres, tres)


@pytest.mark.slow
def test_full_route_loop_net_4_matches_jax():
    """tests/test_parallel.py's full-loop fixture at (4, 1)."""
    _, _, tres, _ = _port_route(4, LOOP_FIXTURE, batch_size=16)
    _, jres = _jax_route(4, LOOP_FIXTURE, batch_size=16)
    _assert_same_route(jres, tres)


def _timing_reference(out):
    """Script mode: JAX's timing-driven mesh route at (4, 1) under the
    AVX flag (ROADMAP C2), written to ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.route import Router, RouterOpts
    from parallel_eda_tpu.timing import TimingAnalyzer, build_timing_graph

    f = synth_flow(**LOOP_FIXTURE)
    ta = TimingAnalyzer(build_timing_graph(f.nl, f.pnl, f.term))
    r = Router(f.rr, RouterOpts(batch_size=16, pipeline=False),
               mesh=jax_mesh(4)).route(f.term, analyzer=ta)
    np.savez(out, paths=r.paths, occ=r.occ, sink_delay=r.sink_delay,
             it=r.iterations, wl=r.wirelength, cpd=ta.crit_path_delay)


@pytest.mark.slow
def test_timing_route_net_4_matches_jax(tmp_path):
    """tests/test_parallel.py's window program with the device STA at
    (4, 1): paths, occupancy, iterations and the critical path equal
    JAX's (run in a subprocess under the AVX flag)."""
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts
    from parallel_eda_tpu_torch.timing.sta import TimingAnalyzer
    from parallel_eda_tpu_torch.timing.graph import build_timing_graph

    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "timing", str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    j = np.load(out)
    f = synth_flow(**LOOP_FIXTURE)
    ta = TimingAnalyzer(build_timing_graph(f.nl, f.pnl, f.term),
                        device="cpu")
    r = Router(f.rr, RouterOpts(batch_size=16), mesh=cpu_mesh(4)).route(
        f.term, analyzer=ta)
    assert r.success
    assert (r.iterations, r.wirelength) == (int(j["it"]), int(j["wl"]))
    assert np.array_equal(r.paths, j["paths"])
    assert np.array_equal(r.occ, j["occ"])
    assert np.array_equal(r.sink_delay, j["sink_delay"])
    assert ta.crit_path_delay == float(j["cpd"])


def _big_grid_flow(pkg, seed):
    """tests/test_router.py's few-nets-on-a-16x16-grid flow, where the
    windowed program engages, built by package ``pkg``."""
    import importlib

    arch = importlib.import_module(f"{pkg}.arch.builtin")
    flow = importlib.import_module(f"{pkg}.flow")
    gen = importlib.import_module(f"{pkg}.netlist.generate")
    nl = gen.generate_circuit(num_luts=20, num_inputs=4, num_outputs=4,
                              K=4, seed=seed)
    return flow.prepare(nl, arch.minimal_arch(chan_width=10),
                        chan_width=10, nx=16, ny=16, seed=seed)


@pytest.mark.slow
def test_ell_windowed_net_4_matches_jax():
    """tests/test_parallel.py's windowed ELL fixture at (4, 1)."""
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    opts = dict(batch_size=16, program="ell", sink_group=1, windowed=True)
    jf = _big_grid_flow("parallel_eda_tpu", 13)
    jres = JRouter(jf.rr, JOpts(pipeline=False, **opts),
                   mesh=jax_mesh(4)).route(jf.term)
    tf = _big_grid_flow("parallel_eda_tpu_torch", 13)
    tres = Router(tf.rr, RouterOpts(**opts), mesh=cpu_mesh(4)).route(
        tf.term)
    assert tres.windowed_nets == jres.windowed_nets > 0
    _assert_same_route(jres, tres)


@pytest.mark.slow
def test_resume_across_net_meshes():
    """tests/test_elastic.py's shrink: a checkpoint taken at net axis 4
    resumes on one device and at net axis 2, and the two resumes agree
    bit for bit (and with JAX's resume on one device)."""
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route.check import check_route
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    cfg = dict(num_luts=40, num_inputs=8, num_outputs=8, chan_width=12,
               seed=3)
    f = synth_flow(**cfg)
    res_a = Router(f.rr, RouterOpts(batch_size=16, checkpoint_every=2,
                                    max_router_iterations=4),
                   mesh=cpu_mesh(4)).route(f.term)
    ck = res_a.checkpoint
    assert ck is not None and not res_a.success
    res_b = Router(f.rr, RouterOpts(batch_size=16), device="cpu").route(
        f.term, resume=ck)
    res_m = Router(f.rr, RouterOpts(batch_size=16), mesh=cpu_mesh(2)).route(
        f.term, resume=ck)
    assert res_b.success and res_m.success
    check_route(f.rr, f.term, res_m.paths, occ=res_m.occ)
    assert np.array_equal(res_b.paths, res_m.paths)
    assert np.array_equal(res_b.occ, res_m.occ)
    jf = jsynth(**cfg)
    ja = JRouter(jf.rr, JOpts(batch_size=16, checkpoint_every=2,
                              max_router_iterations=4),
                 mesh=jax_mesh(4)).route(jf.term)
    jb = JRouter(jf.rr, JOpts(batch_size=16)).route(jf.term,
                                                     resume=ja.checkpoint)
    assert np.array_equal(jb.paths, res_b.paths)
    assert np.array_equal(jb.occ, res_b.occ)


@pytest.mark.slow
def test_ell_mid_config_matches_jax():
    """ROADMAP C10: chip_smoke.py's phase_ell config (300 LUTs, W=16,
    native-placed, windowed ELL, batch 64) routed on the CPU = the JAX
    Router's route."""
    from parallel_eda_tpu.flow import run_place_native as jplace
    from parallel_eda_tpu.flow import synth_flow as jsynth
    from parallel_eda_tpu.route import Router as JRouter
    from parallel_eda_tpu.route import RouterOpts as JOpts
    from parallel_eda_tpu_torch.flow import run_place_native, synth_flow
    from parallel_eda_tpu_torch.route.router import Router, RouterOpts

    cfg = dict(num_luts=300, num_inputs=12, num_outputs=12, chan_width=16,
               seed=11)
    jf = jplace(jsynth(**cfg))
    jres = JRouter(jf.rr, JOpts(batch_size=64, program="ell",
                                pipeline=False)).route(jf.term)
    tf = run_place_native(synth_flow(**cfg))
    assert np.array_equal(tf.pos, jf.pos)
    tres = Router(tf.rr, RouterOpts(batch_size=64, program="ell"),
                  device="cpu").route(tf.term)
    assert tres.windowed_nets == jres.windowed_nets > len(tf.term.source) // 2
    assert tres.widened_nets == jres.widened_nets
    _assert_same_route(jres, tres)


if __name__ == "__main__":
    if sys.argv[1] == "timing":
        _timing_reference(sys.argv[2])
