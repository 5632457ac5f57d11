"""The port's resilience layer (parallel_eda_tpu_torch/resil/ and
RouterOpts.resil) on the CPU, against the JAX package's.

* fault plans, the dispatch guard, the degradation ladder and the
  checkpoint store, driven step for step beside the JAX package's with
  fake clocks and recorded sleeps: the same firings, outcomes, sleeps
  and ``route.resil.*`` values;
* the guarded route: ``Router(resil=...)`` under a multi-site fault plan
  on the 15-LUT fixture (per-rung and fused) and on the 40-LUT crop
  fixture (K2's rungs) equals the fault-free route and the JAX Router's
  resil route, with JAX's ``route.resil.*`` values; mesh 2 with
  ``backend.loss`` lands on single_chip as JAX's does, with its
  ``route.mesh.mesh_demotions``;
* a relaxation that raises in the middle of a window: the guard
  restores the window-entry state and the route equals the fault-free
  one.

Every route here is congestion-driven (crit 0), so the JAX Router runs
in this process.
"""

import os

import numpy as np
import pytest
import torch

from parallel_eda_tpu import obs as JOBS
from parallel_eda_tpu import resil as JRES
from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu.resil import ladder as JLAD
from parallel_eda_tpu.resil import watchdog as JWD
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch import resil as TRES
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.resil import ladder as TLAD
from parallel_eda_tpu_torch.resil import watchdog as TWD
from parallel_eda_tpu_torch.route import planes as TP
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route
from test_torch_route import (CROP_FIXTURE, FIXTURE, _assert_same_route,
                              metric_values, port_metrics)

OPTS = dict(batch_size=32)
CROP = dict(batch_size=32, crop="4x4")
# a multi-site plan that fires on the fixtures' first windows
CHAOS = "dispatch.error:2:6,dispatch.hang:1:4"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CPU route issues many small ops and the
    tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries():
    jold, told = JOBS.get_metrics(), TOBS.get_metrics()
    JOBS.set_metrics(JOBS.MetricsRegistry())
    TOBS.set_metrics(TOBS.MetricsRegistry())
    yield
    JOBS.set_metrics(jold)
    TOBS.set_metrics(told)


def _both():
    """(JAX values, port values) of the resil instruments."""
    return (JOBS.get_metrics().values("route.resil."),
            TOBS.get_metrics().values("route.resil."))


# ---- fault plans -----------------------------------------------------

@pytest.mark.parametrize("seed,spec", [
    (7, "dispatch.hang:2:6,backend.loss:1:3"),
    (1, "dispatch.error:3:9,checkpoint.corrupt:1:2,corpus.torn:2:5"),
    (123, "dispatch.error:2,dispatch.hang:1:1,library.corrupt:1:3,"
          "worker.kill:1:2,transport.drop:2:4,lease.steal:1:1"),
    (0, "backend.loss:4:4")])
def test_fault_plan_firings_match_jax(seed, spec):
    """For each (seed, spec): the same scheduled indices, the same
    firings along each site's invocations (past the horizon too), the
    same summary and the same injection count, every site included."""
    jp, tp = JRES.FaultPlan.parse(seed, spec), TRES.FaultPlan.parse(seed,
                                                                    spec)
    assert tp._fire_at == jp._fire_at and tp.spec == jp.spec
    for site in sorted(tp.spec):
        horizon = tp.spec[site][1]
        for k in range(horizon + 2):
            jf, tf = jp.fire(site, detail=str(k)), tp.fire(site,
                                                           detail=str(k))
            assert (jf is None) == (tf is None), (site, k)
            if tf is not None:
                assert (tf.site, tf.seq, tf.detail) == (jf.site, jf.seq,
                                                        jf.detail)
    assert tp.summary() == jp.summary()
    assert tp.fired_sites() == jp.fired_sites()
    jv, tv = _both()
    assert tv == jv


def test_fault_plan_raise_and_unknown_site():
    p = TRES.FaultPlan(3, {"backend.loss": (1, 1), "dispatch.error": (1, 1)})
    with pytest.raises(TRES.BackendLostError):
        p.raise_if("backend.loss")
    with pytest.raises(TRES.FaultInjected) as ei:
        p.raise_if("dispatch.error", detail="jit")
    assert not isinstance(ei.value, TRES.BackendLostError)
    assert ei.value.fault.site == "dispatch.error"
    assert str(ei.value) == "injected fault dispatch.error#0 (jit)"
    with pytest.raises(ValueError, match="unknown fault site"):
        TRES.FaultPlan(1, {"dispatch.typo": 1})
    assert TRES.SITES == JRES.SITES


# ---- the dispatch guard (fake clocks, recorded sleeps) ---------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scenario(mod, wd, lad_mod, name):
    """Run guard scenario ``name`` on package ``mod``'s classes; returns
    a transcript (outcomes, raised keys, sleeps, quarantine sets)."""
    sleeps, out = [], []
    clock = _Clock()

    def bad():
        raise RuntimeError("dead rung")

    if name == "backoff":
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 4:
                raise RuntimeError("boom")
            return "ok"

        g = wd.DispatchGuard(max_attempts=4, timeout_s=10.0, backoff_s=0.1,
                             backoff_mult=4.0, backoff_max_s=0.9,
                             clock=clock, sleep=sleeps.append)
        out.append(g.run(("k",), [wd.Rung("jit", flaky)]))
    elif name == "quarantine":
        ev = []
        g = wd.DispatchGuard(max_attempts=2, backoff_s=0.0, clock=clock,
                             sleep=sleeps.append,
                             ladder=lad_mod.DegradationLadder())
        out.append(g.run("k1", [wd.Rung("jit", bad, on_quarantine=ev.append),
                                wd.Rung("pallas_g1", lambda: 42)]))
        out.append(g.run("k1", [wd.Rung("jit", bad),
                                wd.Rung("pallas_g1", lambda: 7)]))
        out += [sorted(g.quarantined("k1")), sorted(g.quarantined("k2")),
                ev]
    elif name == "poison":
        g = wd.DispatchGuard(max_attempts=2, backoff_s=0.0, clock=clock,
                             sleep=sleeps.append)
        try:
            g.run("k", [wd.Rung("jit", bad), wd.Rung("xla", bad)])
        except wd.DispatchPoisonedError as e:
            out.append(("poisoned", e.key, e.reason))
        out.append(g.run("k", [wd.Rung("jit", bad),
                               wd.Rung("xla", lambda: "ok")]))
    elif name == "watchdog":
        def slow():
            clock.t += 5.0
            return "late"

        g = wd.DispatchGuard(max_attempts=2, timeout_s=1.0, clock=clock,
                             sleep=sleeps.append)
        out.append(g.run("k", [wd.Rung("jit", slow),
                               wd.Rung("pallas_g1", lambda: "f")]))
        out.append(sorted(g.quarantined("k")))
        out.append(g.run("k", [wd.Rung("jit", slow),
                               wd.Rung("pallas_g1", lambda: "fast")]))
    elif name == "injected":
        plan = mod.FaultPlan(1, {"dispatch.hang": (1, 1),
                                 "dispatch.error": (2, 3)})
        g = wd.DispatchGuard(max_attempts=2, backoff_s=0.01, plan=plan,
                             clock=clock, sleep=sleeps.append)
        for _ in range(3):
            try:
                out.append(g.run("k", [wd.Rung("jit", lambda: 3),
                                       wd.Rung("xla", lambda: 4)]))
            except wd.DispatchPoisonedError as e:
                out.append(("poisoned", e.reason))
        out.append(plan.summary())
    return out, sleeps


@pytest.mark.parametrize("name", ["backoff", "quarantine", "poison",
                                  "watchdog", "injected"])
def test_guard_matches_jax_step_for_step(name):
    """Retry with capped exponential backoff, quarantine that sticks per
    variant, poisoning after the last rung (and the last rung's one more
    chance), the watchdog on an injected clock, and injected hangs and
    errors: the same transcript, sleeps and route.resil.* values as the
    JAX package's guard."""
    j = _scenario(JRES, JWD, JLAD, name)
    t = _scenario(TRES, TWD, TLAD, name)
    assert t == j
    jv, tv = _both()
    assert tv == jv and tv


def test_ladder_levels_floors_and_counters_match_jax():
    """Six dimensions with JAX's level names; step to the floor, records,
    gauges and counters as JAX's; the port's kernel-level map."""
    jl, tl = JLAD.DegradationLadder(), TLAD.DegradationLadder()
    assert TLAD.DIMS == JLAD.DIMS
    assert tl.snapshot() == jl.snapshot()
    for dim in TLAD.DIMS:
        while True:
            a, b = jl.step(dim, "r"), tl.step(dim, "r")
            assert a == b
            assert tl.snapshot() == jl.snapshot()
            if not b:
                break
    for label in ("pallas_packed", "ppermute", "per_rung", "unknown"):
        jl.record(label, "q")
        tl.record(label, "q")
    jv, tv = _both()
    assert tv == jv
    assert tv["route.resil.degradation_steps"] == 12
    assert TLAD.KERNEL_MODE_CAP == {"pallas_packed": None, "pallas_g1": 1,
                                    "xla": 0}


# ---- the checkpoint store --------------------------------------------

def test_checkpoint_store_roundtrip_fallback_drop(tmp_path):
    st = TRES.CheckpointStore(str(tmp_path))
    st.save("j1", {"it": 1})
    st.save("j1", {"it": 2})
    assert st.load("j1") == {"it": 2}
    p = st._path("j1")
    with open(p, "r+b") as f:
        f.truncate(20)
    TOBS.set_metrics(TOBS.MetricsRegistry())
    assert st.load("j1") == {"it": 1}
    v = TOBS.get_metrics().values("route.resil.")
    assert v["route.resil.checkpoint_fallbacks"] == 1
    assert v["route.resil.checkpoint_recoveries"] == 1
    with open(p + ".prev", "r+b") as f:
        f.write(b"not a checkpoint")
    assert st.load("j1") is None
    st.drop("j1")
    assert not os.path.exists(p) and st.load("j1") is None


def test_checkpoint_corrupt_injection_and_gc_match_jax(tmp_path):
    """checkpoint.corrupt tears the file written (the load falls back),
    and startup GC removes only the store's orphaned *.ck.tmp: the same
    files, loads and counters as the JAX store."""
    out = {}
    for name, mod, reg in (("jax", JRES, JOBS), ("port", TRES, TOBS)):
        d = tmp_path / name
        plan = mod.FaultPlan(5, {"checkpoint.corrupt": (1, 2)})
        st = mod.CheckpointStore(str(d), plan=plan)
        loads = []
        for it in range(3):
            st.save("j", {"it": it})
            loads.append(st.load("j"))
        for orphan in ("dead1.ck.tmp", "dead2.ck.tmp"):
            (d / orphan).write_bytes(b"torn mid-write")
        (d / "notes.txt").write_text("keep me")
        mod.CheckpointStore(str(d))
        out[name] = (loads, sorted(os.listdir(d)),
                     reg.get_metrics().values("route.resil."))
    assert out["port"] == out["jax"]
    assert out["port"][2]["route.resil.checkpoint_gc"] == 2


def test_checkpoint_store_keeps_route_checkpoints(tmp_path):
    """A RouteCheckpoint is stored as its checkpoint_to_numpy fields and
    comes back field for field; the resumed route equals the unsliced
    one."""
    tf = synth_flow(**FIXTURE)
    with port_metrics():
        full = TR.Router(tf.rr, TR.RouterOpts(**OPTS),
                         device="cpu").route(tf.term)
        sl = TR.Router(tf.rr, TR.RouterOpts(slice_iterations=2, **OPTS),
                       device="cpu").route(tf.term)
        st = TRES.CheckpointStore(str(tmp_path))
        st.save("job", sl.checkpoint)
        ck = TRES.CheckpointStore(str(tmp_path)).load("job")
        assert isinstance(ck, TR.RouteCheckpoint)
        for k in ("occ", "acc", "paths", "sink_delay", "all_reached", "bb",
                  "crit"):
            assert np.array_equal(getattr(ck, k), getattr(sl.checkpoint, k))
        assert ck.driver.keys() == sl.checkpoint.driver.keys()
        res = TR.Router(tf.rr, TR.RouterOpts(**OPTS),
                        device="cpu").route(tf.term, resume=ck)
    assert res.success and (res.iterations, res.wirelength) == (
        full.iterations, full.wirelength)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(res, k), getattr(full, k)), k


# ---- the guarded route -----------------------------------------------

_REF: dict = {}


def _jax_route(cfg, opts, spec=None, mesh=0):
    """The JAX Router's route (pipeline=False) of ``cfg``, under a resil
    runtime with plan ``spec`` when given; (result, resil values, mesh
    values, ladder snapshot), cached."""
    key = (tuple(sorted(cfg.items())), tuple(sorted(opts.items())), spec,
           mesh)
    if key not in _REF:
        jf = jax_synth_flow(**cfg)
        old = JOBS.get_metrics()
        reg = JOBS.set_metrics(JOBS.MetricsRegistry())
        try:
            rt = None
            if spec is not None:
                # the watchdog times the host call, XLA's compiles
                # included: a budget no compile reaches keeps the
                # comparison off the host's load
                rt = JRES.Resilience(JRES.ResilOpts(
                    fault_plan=JRES.FaultPlan.parse(7, spec),
                    backoff_s=0.0, watchdog_s=3600.0))
            kw = dict(opts, resil=rt, pipeline=False)
            if mesh:
                kw["mesh_shards"] = mesh
            res = JRouter(jf.rr, JOpts(**kw)).route(jf.term)
        finally:
            JOBS.set_metrics(old)
        _REF[key] = (res, reg.values("route.resil."),
                     reg.values("route.mesh."),
                     None if rt is None else rt.ladder.snapshot(),
                     None if rt is None else rt.plan.summary())
    return _REF[key]


_FREE: dict = {}


def _port_free(cfg, opts):
    """The port's fault-free route (resil=None), cached."""
    key = (tuple(sorted(cfg.items())), tuple(sorted(opts.items())))
    if key not in _FREE:
        _FREE[key] = _port_route(cfg, opts)[0]
    return _FREE[key]


def _port_route(cfg, opts, spec=None, mesh=0, plan=None):
    """The port's route, as _jax_route gives (uncached)."""
    tf = synth_flow(**cfg)
    with port_metrics() as reg:
        rt = None
        if spec is not None or plan is not None:
            rt = TRES.Resilience(TRES.ResilOpts(
                fault_plan=plan or TRES.FaultPlan.parse(7, spec),
                backoff_s=0.0, watchdog_s=3600.0))
        kw = dict(opts, resil=rt)
        if mesh:
            kw["mesh_shards"] = mesh
        res = TR.Router(tf.rr, TR.RouterOpts(**kw),
                        device="cpu").route(tf.term)
    check_route(tf.rr, tf.term, res.paths, occ=res.occ)
    return (res, reg.values("route.resil."), reg.values("route.mesh."),
            None if rt is None else rt.ladder.snapshot(),
            None if rt is None else rt.plan.summary())


@pytest.mark.parametrize("case", [
    "per_rung", "fused", "crop",
    pytest.param("crop_fused", marks=pytest.mark.slow)])
def test_resil_route_matches_jax(case):
    """Under a multi-site plan (injected dispatch errors and a hang) the
    port's guarded route equals its fault-free route and the JAX Router's
    resil route, with JAX's firings, route.resil.* values and ladder:
    the 15-LUT fixture per-rung and fused, and the 40-LUT crop fixture
    (its first window dispatches K2's 4x4 rung, then the full canvas),
    per-rung and fused."""
    cfg = CROP_FIXTURE if case.startswith("crop") else FIXTURE
    opts = dict(CROP if case.startswith("crop") else OPTS)
    if case.endswith("fused"):
        opts["fused_dispatch"] = True
    jres, jv, _, jlad, jfired = _jax_route(cfg, opts, CHAOS)
    free = _port_free(cfg, opts)
    tres, tv, _, tlad, tfired = _port_route(cfg, opts, CHAOS)
    _assert_same_route(free, tres)
    _assert_same_route(jres, tres)
    assert tfired == jfired and tfired["kinds_fired"] == 2
    assert tv == jv
    assert tlad == jlad
    assert tv["route.resil.retries"] >= 2
    if case.startswith("crop"):
        assert tres.total_relax_steps_cropped > 0


def test_fused_descends_to_per_rung_and_dispatch_floor():
    """The fused chain's last rung is the per-rung loop (its occ and acc
    threaded rung to rung): two dispatch errors on the crop fixture's
    first fused window quarantine "fused" for that variant and the
    window runs per rung; a stepped "dispatch" dimension routes every
    window per rung.  Both equal the fused route."""
    opts = dict(CROP, fused_dispatch=True)
    free = _port_free(CROP_FIXTURE, opts)
    plan = TRES.FaultPlan(3, {"dispatch.error": (2, 2)})
    res, v, _, lad, _ = _port_route(CROP_FIXTURE, opts, plan=plan)
    _assert_same_route(free, res)
    assert v["route.resil.quarantined_variants"] == 1
    assert v["route.resil.degradation_steps"] == 1
    tf = synth_flow(**CROP_FIXTURE)
    with port_metrics() as reg:
        rt = TRES.Resilience(TRES.ResilOpts())
        rt.ladder.step("dispatch", "test")
        res2 = TR.Router(tf.rr, TR.RouterOpts(resil=rt, **opts),
                         device="cpu").route(tf.term)
    _assert_same_route(free, res2)
    assert reg.gauge("route.kernel.dispatches_per_window").value == 1
    assert metric_values(reg)["route.kernel.fused_rungs"] == 1


def test_mesh2_backend_loss_lands_on_single_chip_as_jax():
    """mesh_shards=2 under a backend.loss plan: the sticky loss
    quarantines the sharded rung, the ladder lands on single_chip
    (mesh_demotions counted, n_shards 1), and the route equals the JAX
    Router's and the fault-free one.  The CPU chain is ppermute ->
    single_chip in both packages (the cluster kernel's level engages
    only on a card)."""
    spec = "backend.loss:1:2"
    jres, jv, jm, jlad, jfired = _jax_route(FIXTURE, OPTS, spec, mesh=2)
    tres, tv, tm, tlad, tfired = _port_route(FIXTURE, OPTS, spec, mesh=2)
    _assert_same_route(jres, tres)
    _assert_same_route(_port_free(FIXTURE, OPTS), tres)
    assert tfired == jfired and "backend.loss" in tfired["fired"]
    assert tlad == jlad and tlad["mesh"] == "single_chip"
    assert tv == jv
    for k in ("route.mesh.mesh_demotions", "route.mesh.n_shards",
              "route.mesh.halo_exchanges", "route.mesh.overlap_frac"):
        assert tm[k] == jm[k], k
    assert tm["route.mesh.mesh_demotions"] >= 1
    assert tm["route.mesh.n_shards"] == 1


def test_mid_window_relaxation_failure_restores_entry_state(monkeypatch):
    """A relaxation that raises on its n-th call, in the middle of a
    window whose earlier launches already wrote paths, sink delays,
    reach flags and boxes in place: the guard restores the window-entry
    tensors before its retry, and the route equals the fault-free one
    (per-rung and fused)."""
    for fused, fail_at in ((False, 7), (True, 12)):
        opts = dict(OPTS, fused_dispatch=fused)
        free = _port_free(FIXTURE, opts)
        real = TP.planes_relax
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == fail_at:
                raise RuntimeError("relaxation launch failed")
            return real(*a, **k)

        monkeypatch.setattr(TP, "planes_relax", flaky)
        res, v, _, _, _ = _port_route(FIXTURE, opts, spec="")
        monkeypatch.setattr(TP, "planes_relax", real)
        assert calls["n"] > fail_at
        _assert_same_route(free, res)
        assert v["route.resil.dispatch_errors"] == 1
        assert v["route.resil.retries"] == 1


def test_resil_none_is_unchanged():
    """resil=None routes as before (the route of test_torch_route's
    parity fixture) and publishes no route.resil.* instrument."""
    res, v, _, _, _ = _port_route(FIXTURE, OPTS)
    assert v == {}
    assert (res.wirelength, res.iterations) == (71, 11)
