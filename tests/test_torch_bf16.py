"""The port's reduced-precision plane mode (``plane_dtype="bf16"``)
against the JAX package's, on the CPU.

In the bf16 plane mode dist and wenter are carried in bfloat16 between
sweeps while every sweep runs in f32 and rounds once at its end (round
to nearest even), and the congestion input is rounded once.  Inputs are
made with numpy from a seed and go through the JAX function and its port
(the plain versions); every comparison is bit-identical: dist, pred,
wenter and the sweep counts of the relaxations (full canvas, cropped,
row-sharded), every state array and the packed summary of the window
program, and paths, occupancy, wirelength, iterations and the sweep
ledger of the routes.  At crit > 0 the JAX side runs in a subprocess
under ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (XLA:CPU otherwise contracts
``crit*delay + cost`` into a fused multiply-add; tests/test_torch_planes.py
and tests/test_torch_timing.py do the same): a module fixture runs this
file as a script, which writes the JAX results to an .npz.

Also here: each net run alone equals the batch run (per-net
termination, which the card's kernels use), the Router's ``dtype_guard``
("off" commits bf16; "window" / "route" commit f32 and shadow each
window in bf16, with JAX's demotion metrics; a forced band violation
demotes once and still returns the f32 route) and its ValueErrors."""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_planes as TPL  # noqa: E402
import test_torch_timing as TT  # noqa: E402
from parallel_eda_tpu.flow import synth_flow as jax_synth_flow  # noqa: E402
from parallel_eda_tpu.obs import (MetricsRegistry, get_metrics,  # noqa: E402
                                  set_metrics)
from parallel_eda_tpu.route import Router as JRouter  # noqa: E402
from parallel_eda_tpu.route import RouterOpts as JOpts  # noqa: E402
from parallel_eda_tpu.route import planes as JP  # noqa: E402
from parallel_eda_tpu.route import router as JR  # noqa: E402
from parallel_eda_tpu_torch.flow import synth_flow  # noqa: E402
from parallel_eda_tpu_torch.route import planes as TP  # noqa: E402
from parallel_eda_tpu_torch.route import planes_shard as TS  # noqa: E402
from parallel_eda_tpu_torch.route import router as TR  # noqa: E402
from parallel_eda_tpu_torch.route.check import check_route  # noqa: E402
from test_torch_route import (CROP_FIXTURE, FIXTURE,  # noqa: E402
                              metric_values, port_metrics,
                              _assert_same_route, window_matches_jax)

BF = "bf16"
# the row-sharded cases at crit > 0 (arch, shards, schedule): 2, 3 and 4
# shards, both archs, both schedules (each JAX reference is a ~10 s
# compile)
SHARD_CASES = [("minimal", 2, "ppermute"), ("unidir", 2, "pallas_halo"),
               ("minimal", 3, "pallas_halo"), ("unidir", 4, "ppermute")]
# the 15-LUT timing-driven route (run_route) at dtype_guard="off"
TIMING_OPTS = dict(batch_size=32, plane_dtype=BF, dtype_guard="off")
# (wirelength, iterations) of the JAX reference routes
EXPECT = {"fixture": (66, 11), "crop": (239, 22), "f32": (71, 11),
          "timing": (69, 11), "bench": (520, 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timing_route(pkg):
    """run_route timing-driven on the 15-LUT fixture at bf16 "off"."""
    m = TT._mods(pkg)
    f = m["flow"].run_route(TT._flow(pkg, FIXTURE),
                            TT._opts(pkg, TIMING_OPTS), timing_driven=True,
                            **TT._kw(pkg))
    r = f.route
    return dict(
        wirelength=np.array(r.wirelength), iterations=np.array(r.iterations),
        paths=r.paths, occ=r.occ, sink_delay=r.sink_delay,
        cpd=np.array(f.crit_path_delay),
        ledger=np.array([r.total_net_routes, r.total_relax_steps,
                         r.total_relax_steps_useful]))


def write_reference(path):
    """The JAX results of the crit > 0 relaxations in the bf16 plane
    mode and of the timing route, into the .npz ``path``.  Run under the
    reference flags."""
    TPL.write_crit_reference(
        path, [BF], {f"timing/{k}": v
                     for k, v in _timing_route(TT.JAX_PKG).items()},
        shard_cases=SHARD_CASES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return TPL.avx_reference(tmp_path_factory.mktemp("jax_ref") / "bf16.npz",
                             __file__, [])


# ---- the rounding --------------------------------------------------

def test_plane_dtypes_match_jax():
    assert TP.PLANE_DTYPES == JP.PLANE_DTYPES
    for dt in JP.PLANE_DTYPES:
        assert TP.plane_itemsize(dt) == JP.plane_itemsize(dt)
    with pytest.raises(ValueError, match="plane_dtype"):
        TP.plane_torch_dtype("fp8")
    # round to nearest even, ties, the subnormal range and INF, as XLA
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 31, 4096, dtype=np.int64).astype(np.uint32)
    x = np.concatenate([bits.view(np.float32), np.float32(
        [0.0, np.inf, 1.00390625, 1.01171875, 3e-39, 1e-45, 3.4e38])])
    x = x[np.isfinite(x) | np.isinf(x)]
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    got = TP.round_plane(torch.from_numpy(x), BF).numpy()
    assert np.array_equal(want, got, equal_nan=True)


# ---- the plain relaxations -----------------------------------------

@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch,nx,ny,seed", TPL.RELAX_GRID)
def test_planes_relax_bf16_matches_jax(ref, arch, nx, ny, seed, costs):
    pg, args, tres = TPL._relax_port(arch, nx, ny, seed, costs,
                                     plane_dtype=BF)
    if costs == "crit":
        jres = TPL.crit_results(ref, BF, "full/" + TPL._grid_key(
            arch, nx, ny, seed))
    else:
        jres = TPL._jitted(
            lambda *a: JP.planes_relax(pg, *a, 64, plane_dtype=BF), *args)
    TPL._compare(jres, tres)
    # the mode is not the f32 one: the rounded state reaches another
    # fixpoint
    f32 = TPL._relax_port(arch, nx, ny, seed, costs)[2]
    assert not torch.equal(tres[0], f32[0])


@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch,seed", TPL.CROP_CASES)
def test_planes_relax_cropped_bf16_matches_jax(ref, arch, seed, costs):
    pg, args, tres = TPL._cropped_port(arch, seed, costs, BF)
    if costs == "crit":
        jres = TPL.crit_results(ref, BF, f"crop/{arch}-{seed}")
    else:
        jres = TPL._cropped_jax(pg, args, BF)
    TPL._compare(jres, tres)


@pytest.mark.parametrize("arch,s,impl", SHARD_CASES)
def test_planes_relax_sharded_bf16_matches_jax(ref, arch, s, impl):
    """The row-sharded relaxation in the bf16 plane mode (halos carry the
    rounded dist, the owned-changed flag compares the rounded state)
    against the JAX package's on its virtual CPU mesh, at crit > 0."""
    got = TPL.sharded_crit_port(arch, s, impl, BF)
    TPL._compare(TPL.crit_results(ref, BF, f"shard/{arch}-{s}-{impl}"), got)


# ---- per-net termination -------------------------------------------

def _per_net(run, args, B):
    """Each net of the batch run alone: (dist, pred, wenter)
    concatenated, and the [executed, useful] pairs [B, 2]."""
    nets = [run(*(a[b:b + 1] for a in args)) for b in range(B)]
    return ([torch.cat([n[k] for n in nets]) for k in range(3)],
            torch.stack([n[3] for n in nets]))


def _assert_per_net(batch, outs, per_net):
    for k in range(3):
        assert torch.equal(outs[k], batch[k]), k
    assert torch.equal(per_net.max(0).values, batch[3])
    # the instance has nets that stop at different sweeps
    assert len(set(per_net[:, 0].tolist())) > 1


def _stopping_instance(args):
    """The instance's arrays with the last net an empty slot (all-INF
    seeds, as the route gives a clean net): it stops after one sweep."""
    d0 = args[0].copy()
    d0[-1] = np.inf
    return (d0,) + tuple(args[1:])


@pytest.mark.parametrize("costs", ["jitter", "crit"])
def test_full_relax_bf16_per_net_termination(costs):
    """The card's kernels stop each net at its own fixpoint (the rounded
    dist unchanged by a sweep).  In the bf16 plane mode, each net run
    alone, its counts max-reduced, equals the batch run."""
    rr, pg = TPL._graph("mixed", 7, 7)
    args = [torch.from_numpy(a) for a in _stopping_instance(
        TPL._instance(rr, pg, 4, 7, costs))]
    tpg = TPL.to_port(pg)

    def run(*a):
        return TP.planes_relax(tpg, *a, 64, BF)
    _assert_per_net(run(*args), *_per_net(run, args, 4))


@pytest.mark.parametrize("costs", ["jitter", "crit"])
def test_cropped_relax_bf16_per_net_termination(costs):
    rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny = TPL._crop_instance(
        "mixed", 3, costs)
    args = [torch.from_numpy(a) for a in
            _stopping_instance((d0, cc, crit, w0, ox, oy))]
    tpg = TPL.to_port(pg)

    def run(d0, cc, crit, w0, ox, oy):
        return TP.planes_relax_cropped(tpg, d0, cc, crit, w0, 64, ox, oy,
                                       cnx, cny, BF)
    _assert_per_net(run(*args), *_per_net(run, args, 4))


@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch", sorted(TPL.SHARD_GRAPHS))
@pytest.mark.parametrize("s", [2, 3, 4])
def test_sharded_relax_bf16_per_net_termination(s, arch, costs):
    """The cluster kernel's rule in the bf16 plane mode: the plain lag-1
    sharded loop run one net at a time equals the batch run."""
    nx, ny, seed = TPL.SHARD_GRAPHS[arch]
    rr, pg = TPL._graph(arch, nx, ny)
    args = [torch.from_numpy(a) for a in _stopping_instance(
        TPL._instance(rr, pg, 4, seed, costs))]
    tpg = TPL.to_port(pg)
    mesh = TS.make_row_mesh(s, "ppermute", "cpu")

    def run(*a):
        return TS.planes_relax_sharded(tpg, *a, 24, mesh, BF)
    _assert_per_net(run(*args), *_per_net(run, args, 4))


# ---- the window program --------------------------------------------

@pytest.mark.parametrize("cfg,tile,widen", [(FIXTURE, None, False),
                                            (CROP_FIXTURE, (4, 4), True)])
def test_window_bf16_matches_jax(cfg, tile, widen):
    """One K_iters=2 window in the bf16 plane mode: every state array and
    the packed status/scal summary equal the JAX program's."""
    scal = window_matches_jax(cfg, tile, widen, BF)
    assert int(scal[TP.SCAL_S_EXEC]) > 0


# ---- the Router ----------------------------------------------------

_ROUTES: dict = {}


def _jax_route(cfg, fields, mesh_shards=1):
    """The JAX Router's route (pipeline=False) and its route.* metrics,
    cached per configuration."""
    key = (tuple(sorted(cfg.items())), tuple(sorted(fields.items())),
           mesh_shards)
    if key not in _ROUTES:
        old = set_metrics(MetricsRegistry())
        try:
            jf = jax_synth_flow(**cfg)
            res = JRouter(jf.rr, JOpts(pipeline=False, mesh_shards=mesh_shards,
                                       **fields)).route(jf.term)
            reg = get_metrics()
            m = {k: reg.counter(k).value for k in (
                "route.kernel.dtype_demotions", "route.mesh.halo_bytes",
                "route.mesh.halo_exchanges")}
            m["route.kernel.plane_dtype"] = reg.gauge(
                "route.kernel.plane_dtype").value
        finally:
            set_metrics(old)
        _ROUTES[key] = res, m
    return _ROUTES[key]


def _port_route(cfg, fields, mesh_shards=1):
    """The port's route and its metrics (a registry of its own)."""
    tf = synth_flow(**cfg)
    with port_metrics() as reg:
        r = TR.Router(tf.rr, TR.RouterOpts(mesh_shards=mesh_shards,
                                           **fields), device="cpu")
        res = r.route(tf.term)
    check_route(tf.rr, tf.term, res.paths, occ=res.occ)
    return metric_values(reg), res


@pytest.mark.parametrize("name,cfg,fields", [
    ("fixture", FIXTURE, dict(batch_size=32)),
    ("crop", CROP_FIXTURE, dict(batch_size=32, crop="4x4"))])
def test_route_bf16_off_matches_jax(name, cfg, fields):
    """dtype_guard="off" commits the bf16 relaxation: the route equals
    the JAX Router's bf16 route (a different route from the f32 one)."""
    fields = dict(fields, plane_dtype=BF, dtype_guard="off")
    jres, jm = _jax_route(cfg, fields)
    m, tres = _port_route(cfg, fields)
    _assert_same_route(jres, tres)
    assert (tres.wirelength, tres.iterations) == EXPECT[name]
    if name == "crop":
        assert tres.total_relax_steps_cropped > 0
    assert m["route.kernel.plane_dtype"] == \
        jm["route.kernel.plane_dtype"] == BF
    assert m["route.kernel.dtype_demotions"] == 0


@pytest.mark.parametrize("guard", ["window", "route"])
def test_route_bf16_guarded_matches_jax(guard):
    """The guarded modes commit the f32 route (by construction) and
    shadow each window in bf16 until it leaves the band (or, "route",
    until one window is within it): the route equals the JAX Router's
    and the f32 route, and the demotion counter and plane-dtype gauge
    read JAX's registry values."""
    fields = dict(batch_size=32, plane_dtype=BF, dtype_guard=guard)
    jres, jm = _jax_route(FIXTURE, fields)
    m, tres = _port_route(FIXTURE, fields)
    _assert_same_route(jres, tres)
    assert (tres.wirelength, tres.iterations) == EXPECT["f32"]
    for k in ("route.kernel.dtype_demotions", "route.kernel.plane_dtype"):
        assert m[k] == jm[k], k


def test_forced_band_violation_demotes_dtype(monkeypatch):
    """A bf16 shadow summary outside the band demotes the route to f32:
    the counter fires once, the gauge reads "f32", the route is the f32
    one, and under a resilience runtime the ladder's "dtype" dimension
    steps once (the JAX package's test)."""
    from parallel_eda_tpu_torch.resil import Resilience, ResilOpts

    monkeypatch.setattr(TR, "_dtype_band_ok", lambda *a, **k: False)
    rt = Resilience(ResilOpts())
    m, tres = _port_route(FIXTURE, dict(batch_size=32, plane_dtype=BF,
                                        resil=rt))
    assert rt.ladder.level("dtype") == 1
    assert m["route.resil.level.dtype"] == 1
    _, base = _port_route(FIXTURE, dict(batch_size=32))
    assert np.array_equal(tres.paths, base.paths)
    assert np.array_equal(tres.occ, base.occ)
    assert tres.wirelength == base.wirelength
    assert m["route.kernel.dtype_demotions"] == 1
    assert m["route.kernel.plane_dtype"] == "f32"


def test_dtype_band_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(50):
        st = rng.integers(0, 4, 60).astype(np.int32)
        st2 = np.where(rng.random(60) < rng.uniform(0, 0.05), st + 1, st)
        sc = rng.integers(0, 200, 7).astype(np.int32)
        sc2 = (sc + rng.integers(-12, 13, 7)).astype(np.int32)
        assert TR._dtype_band_ok(st, sc, st2, sc2) == \
            JR._dtype_band_ok(st, sc, st2, sc2)
    assert (TR.DTYPE_GUARD_STATUS_FRAC, TR.DTYPE_GUARD_SCAL_RTOL) == \
        (JR.DTYPE_GUARD_STATUS_FRAC, JR.DTYPE_GUARD_SCAL_RTOL)


@pytest.mark.parametrize("name,value", [("plane_dtype", "fp8"),
                                        ("dtype_guard", "sometimes")])
def test_bad_plane_options_raise_as_jax(name, value):
    """An unknown plane_dtype or dtype_guard raises ValueError when the
    route starts, with the JAX Router's message."""
    msgs = []
    jf = jax_synth_flow(**FIXTURE)
    with pytest.raises(ValueError) as e:
        JRouter(jf.rr, JOpts(pipeline=False, **{name: value})).route(jf.term)
    msgs.append(str(e.value))
    tf = synth_flow(**FIXTURE)
    with pytest.raises(ValueError) as e:
        TR.Router(tf.rr, TR.RouterOpts(**{name: value}),
                  device="cpu").route(tf.term)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_router_mesh2_bf16_matches_jax_mesh_route():
    """The row-sharded route at bf16 "off" (block states and halos in
    bfloat16) equals the JAX Router's own mesh_shards=2 route, and its
    halo ledger (2 bytes a cell) JAX's."""
    fields = dict(batch_size=32, plane_dtype=BF, dtype_guard="off")
    jres, jm = _jax_route(FIXTURE, fields, mesh_shards=2)
    m, tres = _port_route(FIXTURE, fields, mesh_shards=2)
    _assert_same_route(jres, tres)
    for k in ("route.mesh.halo_bytes", "route.mesh.halo_exchanges"):
        assert m[k] == jm[k], k
    assert m["route.kernel.plane_dtype"] == BF


def test_timing_route_bf16_matches_jax(ref):
    """flow.run_route timing-driven (the STA between iterations) at bf16
    "off": paths, occupancy, sink delays and the critical path equal the
    JAX reference's."""
    got = _timing_route(TT.PORT_PKG)
    for k, v in got.items():
        assert np.array_equal(v, ref[f"timing/{k}"], equal_nan=True), k
    assert (int(got["wirelength"]), int(got["iterations"])) == \
        EXPECT["timing"]


@pytest.mark.slow
def test_bench_bf16_off_matches_jax():
    cfg = dict(num_luts=60, num_inputs=12, num_outputs=12, chan_width=12,
               seed=11)
    fields = dict(batch_size=64, plane_dtype=BF, dtype_guard="off")
    jres, _ = _jax_route(cfg, fields)
    _, tres = _port_route(cfg, fields)
    _assert_same_route(jres, tres)
    assert (tres.wirelength, tres.iterations) == EXPECT["bench"]


if __name__ == "__main__":
    write_reference(sys.argv[1])
