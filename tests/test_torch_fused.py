"""The port's fused window dispatch (``RouterOpts.fused_dispatch``:
``planes.route_window_planes_fused``), its generator driver
(``Router.route_gen`` / ``_drive_windows``) and the multi-job window
(``planes.route_window_planes_multi``) on the CPU, against the JAX
package and against the port's per-rung route.

The fixture is the 40-LUT ``bb_factor=0`` flow at ``crop="4x4"``: its
first window has two rungs (a 4x4 tile and the full canvas), the four
after it one.  The module makes one JAX fused route (pipeline=False,
with a registry and a tracer of its own), which the route, metrics and
trace checks read; the window check drives both packages' route_gen to
their first request and calls their fused windows on it (JAX's program
is the one that route compiled)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu import obs as JOBS
from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu.place.initial import \
    initial_placement as jax_initial_placement
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu.route import planes as JP
from parallel_eda_tpu.route import router as JR
from parallel_eda_tpu.rr.terminals import net_terminals as jax_net_terminals
from parallel_eda_tpu.serve import fused as JF
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.flow import run_route, synth_flow
from parallel_eda_tpu_torch.place.initial import initial_placement
from parallel_eda_tpu_torch.route import planes as TP
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route
from parallel_eda_tpu_torch.rr.terminals import net_terminals
from parallel_eda_tpu_torch.serve import fused as TF
from test_torch_route import (CROP_FIXTURE, FIXTURE, _assert_same_route,
                              metric_values, port_metrics)

OPTS = dict(batch_size=32, crop="4x4")
FUSED = dict(OPTS, fused_dispatch=True)
# the fixture's fused route: wirelength / iterations, and the rungs of
# each of its five windows
EXPECT = (257, 16)
RUNGS = [2, 1, 1, 1, 1]
# timings: excluded from the value comparison
TIMED = tuple("route.pipeline." + k for k in (
    "host_plan_ms", "device_exec_ms", "stall_ms", "overlap_frac",
    "host_overlap_frac", "host_plan_ms_total", "device_exec_ms_total",
    "stall_ms_total", "host_serial_ms_total")) + ("route.window_wall_s",)
# the kernel-layout gauges: JAX's names, the port's layout (their
# values are pinned by tests/test_torch_obs.py)
A13_REST = ("route.kernel.bytes_per_sweep", "route.kernel.lane_occupancy",
            "route.kernel.packed_block_size")
# a second terminal set of the fixture's netlist on the same grid
SEED_B = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CPU route issues many small ops and the
    tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace_names(events):
    return {(e["name"], e["ph"]) for e in events
            if not e["name"].startswith("jax.compile.")}


def _observed(run):
    """Run ``run()`` with a fresh registry (enabled) and tracer of the
    package ``mod`` and the dispatch-variant set emptied; returns (its
    result, the registry, the trace's event names)."""
    def go(mod, router_mod):
        saved = set(router_mod._DISPATCH_VARIANTS)
        router_mod._DISPATCH_VARIANTS.clear()
        old = mod.get_metrics()
        reg = mod.set_metrics(mod.MetricsRegistry(enabled=True))
        tr = mod.Tracer()
        mod.set_tracer(tr)
        try:
            res = run()
        finally:
            mod.set_tracer(None)
            mod.set_metrics(old)
            router_mod._DISPATCH_VARIANTS |= saved
        return res, reg, _trace_names(tr.events)
    return go


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX Router's fused route of the fixture (pipeline=False)."""
    jf = jax_synth_flow(**CROP_FIXTURE)
    return _observed(lambda: JRouter(jf.rr, JOpts(
        pipeline=False, **FUSED)).route(jf.term))(JOBS, JR)


@pytest.fixture(scope="module")
def tflow():
    return synth_flow(**CROP_FIXTURE)


_PORT: dict = {}


def _port_route(tf, pipeline=True, observed=False, **kw):
    """The port's route of ``tf`` (cached per options); with
    ``observed``, (result, registry, trace names) as _observed gives."""
    key = (id(tf), pipeline, observed, tuple(sorted(kw.items())))
    if key not in _PORT:
        def run():
            return TR.Router(tf.rr, TR.RouterOpts(pipeline=pipeline, **kw),
                             device="cpu").route(tf.term)
        if observed:
            _PORT[key] = _observed(run)(TOBS, TR)
        else:
            with port_metrics() as reg:
                _PORT[key] = run(), metric_values(reg)
    return _PORT[key]


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sync"])
def test_fused_route_matches_jax(jax_fused, tflow, pipeline):
    """RouterOpts(fused_dispatch=True) through route() (which drives
    route_gen): paths, occupancy, wirelength, iterations and stats rows
    of the JAX Router's fused route, in both pipeline modes, one
    dispatch a window; the per-window rung counts (synchronous mode
    books each window before the next dispatch) are JAX's, 2, 1, 1, 1,
    1."""
    jres, jreg, _ = jax_fused
    if pipeline:
        tres, m = _port_route(tflow, True, **FUSED)
        assert m["route.kernel.dispatches_per_window"] == 1
    else:
        tres, reg, _ = _port_route(tflow, False, True, **FUSED)
        for k in ("route.kernel.fused_rungs",
                  "route.kernel.dispatches_per_window"):
            assert reg.series(k, phase="route") == jreg.series(
                k, phase="route"), k
        assert reg.series("route.kernel.fused_rungs",
                          phase="route") == RUNGS
    _assert_same_route(jres, tres)
    assert (tres.wirelength, tres.iterations) == EXPECT
    assert tres.total_relax_steps_cropped > 0
    check_route(tflow.rr, tflow.term, tres.paths, occ=tres.occ)


def test_fused_metrics_and_trace_match_jax(jax_fused, tflow):
    """On the same route, the port's instrument names are the JAX
    Router's; every counter, gauge and histogram but the timings (TIMED)
    and the kernel-layout gauges (A13_REST, the port's layout) has JAX's
    value, at the end and in every snapshot; the trace has JAX's span
    and counter-track names (XLA's compile spans aside)."""
    _, jreg, jnames = jax_fused
    _, reg, names = _port_route(tflow, False, True, **FUSED)
    want = jreg.values()
    got = reg.values()
    assert set(got) == set(want)
    for k in want:
        if k not in TIMED and not k.startswith(A13_REST):
            assert got[k] == want[k], k
    assert got["route.dispatch.compiles"] == 5
    assert [s["labels"] for s in reg.snapshots] == \
        [s["labels"] for s in jreg.snapshots]
    for s, js in zip(reg.snapshots, jreg.snapshots):
        assert set(s["values"]) == set(js["values"])
        for k in s["values"]:
            if k not in TIMED and not k.startswith(A13_REST):
                assert s["values"][k] == js["values"][k], (s["labels"], k)
    assert names == jnames
    assert {("route.window", "X"), ("route.kernel", "X"),
            ("route.iter", "X"), ("route.pipeline.plan", "X"),
            ("route.pipeline.exec", "X")} <= names


def _first_request(router, term):
    """``router``'s route_gen on ``term``, driven to its first request."""
    gen = router.route_gen(term)
    return gen, next(gen)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def test_fused_window_matches_jax(jax_fused):
    """The fixture's first window request, in both packages from their
    route_gen: the same arguments (variant key, state, plans, rung
    table), and route_window_planes_fused on them gives the same state,
    status and stacked per-rung scal (two rungs)."""
    jf = jax_synth_flow(**CROP_FIXTURE)
    jr = JRouter(jf.rr, JOpts(pipeline=False, **FUSED))
    tf = synth_flow(**CROP_FIXTURE)
    tr = TR.Router(tf.rr, TR.RouterOpts(pipeline=False, **FUSED),
                   device="cpu")
    jgen, jreq = _first_request(jr, jf.term)
    tgen, treq = _first_request(tr, tf.term)
    assert treq.vkey == jreq.vkey
    assert len(treq.f_kwargs["rung_desc"]) == 2
    assert treq.f_kwargs["rung_desc"][0][0] == (4, 4)
    ja, ta = jreq.f_args, treq.f_args
    assert len(ta) == len(ja) == 33
    for i in list(range(2, 22)) + [24]:
        assert np.array_equal(_np(ta[i]), _np(ja[i])), i
    for i in (22, 23):
        assert len(ta[i]) == len(ja[i]) == 2
        for a, b in zip(ta[i], ja[i]):
            assert np.array_equal(_np(a), _np(b)), i
    for i in range(25, 33):
        # the port passes Python numbers, which the window rounds to
        # float32 as JAX's float32 scalars are
        assert np.float32(ta[i]) == np.float32(ja[i]), i
    for k in ("rung_desc", "topk", "n_colors", "plane_dtype"):
        assert treq.f_kwargs[k] == jreq.f_kwargs[k], k
    assert np.array_equal(_np(treq.f_kwargs["bb0_all"]),
                          _np(jreq.f_kwargs["bb0_all"]))
    assert len(treq.f_kwargs["widen_oks"]) == 2
    for a, b in zip(treq.f_kwargs["widen_oks"], jreq.f_kwargs["widen_oks"]):
        assert np.array_equal(_np(a), _np(b))
    jo = JP.route_window_planes_fused(*ja, **jreq.f_kwargs)
    occ, acc, status, scals, dmax = TP.route_window_planes_fused(
        *ta, **treq.f_kwargs)
    for j, p in ((jo[0], occ), (jo[1], acc), (jo[2], ta[4]), (jo[3], ta[5]),
                 (jo[4], ta[6]), (jo[5], ta[7]), (jo[13], ta[10]),
                 (jo[21], status), (jo[23], scals)):
        assert np.array_equal(np.asarray(j), p.numpy())
    assert scals.shape == (2, TP.SCAL_LEN)
    assert np.array_equal(np.asarray(jo[22]), scals[-1].numpy())
    assert np.array_equal(np.asarray(jo[14]), dmax.numpy(), equal_nan=True)
    jgen.close()
    tgen.close()


@pytest.mark.parametrize("case", ["bf16_window", "timing"])
def test_fused_equals_per_rung(case, tflow):
    """Fused equals per-rung in the port: the bf16 plane mode under
    dtype_guard="window" (the shadow replays the stashed fused call) on
    the crop fixture, and the timing-driven route with the analyzer
    (the device STA through every rung) on the 15-LUT fixture."""
    out = {}
    for fused in (False, True):
        if case == "timing":
            tf = synth_flow(**FIXTURE)
            with port_metrics() as reg:
                run_route(tf, TR.RouterOpts(batch_size=32,
                                            fused_dispatch=fused),
                          device="cpu")
            res = tf.route
            out[fused] = (res, tf.crit_path_delay, metric_values(reg))
        else:
            res, m = _port_route(tflow, True, plane_dtype="bf16",
                                 fused_dispatch=fused, **OPTS)
            out[fused] = (res, None, m)
        assert res.success
    (a, cpd_a, ma), (b, cpd_b, mb) = out[False], out[True]
    _assert_same_route(a, b)
    assert cpd_a == cpd_b
    assert mb["route.kernel.dispatches_per_window"] == 1
    for k in ("route.kernel.dtype_demotions", "route.kernel.plane_dtype",
              "route.relax_steps", "route.net_routes"):
        assert ma[k] == mb[k], k
    if case == "timing":
        assert cpd_a == cpd_a
    else:
        # the guard commits the f32 route; the bf16 shadow of this
        # fixture leaves the band once, fused as per-rung
        assert (b.wirelength, b.iterations) == EXPECT
        assert mb["route.kernel.dtype_demotions"] == 1


def lockstep(router, jobs):
    """Several jobs' route_gen generators on one Router, driven to the
    end in lockstep by serve/fused.py's FusedSliceRunner (one
    route_window_planes_multi call a step while two or more requests are
    pending).  ``jobs`` is a list of (term, opts); returns their
    RouteResults and the multi calls made."""
    import types

    entries = []
    for j, (term, opts) in enumerate(jobs):
        router.opts = opts
        entries.append(TF.SliceEntry(types.SimpleNamespace(job_id=f"job{j}"),
                                     router.route_gen(term), opts,
                                     f"job{j}/"))
    with port_metrics() as reg:
        TF.FusedSliceRunner(router).run_slice(entries)
        calls = reg.counter("route.serve.fused.dispatches").value
    for e in entries:
        if e.error is not None:
            raise e.error
    return [e.result for e in entries], calls


def second_terms(tf, net_terminals_fn, initial_placement_fn):
    """A second terminal set of the flow's netlist on its grid: the
    initial placement from another seed."""
    pos = initial_placement_fn(tf.pnl, tf.grid, seed=SEED_B)
    return net_terminals_fn(tf.pnl, tf.rr, pos, bb_factor=tf.bb_factor)


def test_multi_window_matches_solo(tflow):
    """Two jobs on one Router and rr graph (the fixture's terminals and
    a second terminal set) routed in lockstep through
    route_window_planes_multi: each job's route is its solo fused route,
    exactly."""
    term_b = second_terms(tflow, net_terminals, initial_placement)
    opts = TR.RouterOpts(pipeline=True, **FUSED)
    solo_a, _ = _port_route(tflow, True, **FUSED)
    with port_metrics():
        solo_b = TR.Router(tflow.rr, opts, device="cpu").route(term_b)
        router = TR.Router(tflow.rr, opts, device="cpu")
        (ra, rb), calls = lockstep(router, [(tflow.term, opts),
                                            (term_b, opts)])
    assert calls >= 4
    assert solo_b.success and solo_b.paths.shape[0] == solo_a.paths.shape[0]
    _assert_same_route(solo_a, ra)
    _assert_same_route(solo_b, rb)
    check_route(tflow.rr, term_b, rb.paths, occ=rb.occ)


@pytest.mark.slow
def test_multi_step_matches_jax():
    """One lockstep step of the two jobs: JAX's route_window_planes_multi
    and the port's on the same two first requests (each package's
    route_gen) give the same per-job state, status and scal stacks."""
    jf = jax_synth_flow(**CROP_FIXTURE)
    tf = synth_flow(**CROP_FIXTURE)
    jterm_b = second_terms(jf, jax_net_terminals, jax_initial_placement)
    term_b = second_terms(tf, net_terminals, initial_placement)
    jr = JRouter(jf.rr, JOpts(**FUSED))
    tr = TR.Router(tf.rr, TR.RouterOpts(**FUSED), device="cpu")
    reqs = {}
    for pkg, r, terms in (("jax", jr, (jf.term, jterm_b)),
                          ("port", tr, (tf.term, term_b))):
        reqs[pkg] = []
        for j, term in enumerate(terms):
            r._staging_prefix = f"job{j}/"
            reqs[pkg].append(next(r.route_gen(term)))
    jsplit = list(zip(*(JF._split_request(q) for q in reqs["jax"])))
    tsplit = list(zip(*(TF._split_request(q) for q in reqs["port"])))
    assert jsplit[2] == tsplit[2]
    jouts = JP.route_window_planes_multi(
        jr.pg, jr.dev, jsplit[0], jsplit[1], job_statics=jsplit[2],
        n_colors=5, plane_dtype="f32")
    touts = TP.route_window_planes_multi(
        tr.pg, tr.dev, tsplit[0], tsplit[1], job_statics=tsplit[2],
        n_colors=5, plane_dtype="f32")
    for jo, to, st in zip(jouts, touts, tsplit[0]):
        for j, p in ((jo[0], to[0]), (jo[1], to[1]), (jo[2], st[2]),
                     (jo[3], st[3]), (jo[4], st[4]), (jo[5], st[5]),
                     (jo[21], to[2]), (jo[23], to[3])):
            assert np.array_equal(np.asarray(j), p.numpy())


def test_route_gen_rejects_ell():
    """route_gen drives the planes program only: on program="ell" its
    first advance raises JAX's ValueError."""
    msgs = []
    jf = jax_synth_flow(**FIXTURE)
    with pytest.raises(ValueError) as e:
        next(JRouter(jf.rr, JOpts(program="ell")).route_gen(jf.term))
    msgs.append(str(e.value))
    tf = synth_flow(**FIXTURE)
    gen = TR.Router(tf.rr, TR.RouterOpts(program="ell"),
                    device="cpu").route_gen(tf.term)
    with pytest.raises(ValueError) as e:
        next(gen)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "route_gen is supported by the planes program"
