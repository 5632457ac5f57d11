"""The port's observability package (``parallel_eda_tpu_torch/obs``)
against the JAX package's ``obs`` on the same scripted calls: the
registry's values, snapshots, series, dump JSON and reset; the tracer's
exported events (times, thread ids and the beacon's clock readings
normalised), declared counter tracks and span totals; the flight
recorder's ring; the no-op fast path; and the CUDA-build spans that
stand in for XLA's compile spans."""

import json

import pytest

from parallel_eda_tpu import obs as JOBS
from parallel_eda_tpu.obs.trace import FlightRecorder as JFlightRecorder
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.obs import trace as TTRACE


@pytest.fixture
def fresh():
    """Each package's process registry and tracer, restored after."""
    saved = [(m, m.get_metrics(), m.get_tracer()) for m in (JOBS, TOBS)]
    yield
    for m, reg, tr in saved:
        m.set_metrics(reg)
        m.set_tracer(tr)


def _script(mod, tmp_path, tag):
    """The same calls on package ``mod``'s registry and tracer; returns
    (registry, tracer, the trace file's JSON, the dump's JSON)."""
    reg = mod.set_metrics(mod.MetricsRegistry(enabled=True))
    tr = mod.Tracer(worker="w1")
    mod.set_tracer(tr)
    reg.counter("route.relax_steps").inc(3)
    reg.counter("route.relax_steps").inc(2.5)
    reg.gauge("route.kernel.plane_dtype").set("f32")
    reg.set_gauges({"route.pres_fac": 0.5, "route.overused_nodes": 7,
                    "route.success": True})
    for v in (1, 4, 0.25):
        reg.histogram("route.bucket_occupancy").record(v)
    reg.snapshot(phase="route", iteration=1)
    reg.gauge("route.overused_nodes").set(2)
    reg.gauge("place.t").set(1.5)
    reg.snapshot(phase="route", iteration=2)
    reg.snapshot(phase="place", temperature=0)
    with mod.span("route.window", cat="route", K=2):
        with tr.span("inner"):
            pass
    # scripted times far past the clock-stamped events around them, so
    # that the export's time order does not depend on how fast the
    # script runs (at t0 + 1 ms a loaded host stamped some counters
    # later than the mark)
    tr.mark("route.pipeline.plan", tr.t0 + 100.001, tr.t0 + 100.003,
            cat="route", window=1)
    tr.add_complete("route.kernel", tr.t0 + 100.002, -1.0, cat="route",
                    tile=[4, 4])
    tr.instant("route.trace.submit", cat="lifecycle", job="j")
    tr.counter("route.pres_fac", 2)
    tr.beacon(cycle=1)
    times = {}
    with mod.stage("pack", times, native=True):
        pass
    assert set(times) == {"pack"} and times["pack"] >= 0.0
    mod.set_tracer(None)
    assert mod.span("off") is mod.span("off2")   # the shared no-op
    with mod.span("off"):
        pass
    reg.snapshot(phase="route_final", iteration=2)
    path = tmp_path / f"{tag}_trace.json"
    tr.export(str(path), atomic=True)
    dpath = tmp_path / f"{tag}_metrics.json"
    reg.dump(str(dpath))
    return reg, tr, json.loads(path.read_text()), json.loads(
        dpath.read_text())


def _normalised(doc):
    evs = []
    for e in doc["traceEvents"][1:]:
        e = dict(e)
        for k in ("ts", "dur", "tid"):
            if k in e:
                e[k] = type(e[k]).__name__
        if e["name"] == "route.trace.beacon":
            e["args"] = {k: type(v).__name__ for k, v in e["args"].items()}
        evs.append(e)
    return evs


def test_registry_matches_jax(fresh, tmp_path):
    jreg, _, _, jdump = _script(JOBS, tmp_path, "jax")
    treg, _, _, tdump = _script(TOBS, tmp_path, "port")
    assert treg.values() == jreg.values()
    assert treg.values("route.p") == jreg.values("route.p") != {}
    assert treg.snapshots == jreg.snapshots
    assert len(treg.snapshots) == 4
    for name, match in (("route.overused_nodes", dict(phase="route")),
                        ("place.t", {}), ("route.relax_steps",
                                          dict(iteration=2))):
        assert treg.series(name, **match) == jreg.series(name, **match)
    assert treg.series("route.overused_nodes", phase="route") == [7, 2]
    assert tdump == jdump
    assert treg.histogram("route.bucket_occupancy").mean == \
        jreg.histogram("route.bucket_occupancy").mean
    for reg in (treg, jreg):
        reg.reset()
    assert treg.values() == jreg.values() == {}
    assert treg.snapshots == jreg.snapshots == []
    # snapshots are opt-in
    assert TOBS.MetricsRegistry().snapshot(a=1) is None
    assert TOBS.COUNTER_TRACKS == JOBS.COUNTER_TRACKS


def test_tracer_export_matches_jax(fresh, tmp_path):
    _, jtr, jdoc, _ = _script(JOBS, tmp_path, "jax")
    _, ttr, tdoc, _ = _script(TOBS, tmp_path, "port")
    # JAX's compile listener adds nothing here: no jit ran
    assert _normalised(tdoc) == _normalised(jdoc)
    for k in ("displayTimeUnit", "worker", "declaredCounterTracks"):
        assert tdoc[k] == jdoc[k], k
    assert tdoc["traceEvents"][0]["args"]["name"] == \
        "parallel_eda_tpu_torch w1"
    assert ttr.total("route.pipeline") == pytest.approx(0.002)
    assert ttr.total("route.kernel") == 0.0
    # the snapshots mirrored the counter tracks onto the trace
    c = [e for e in tdoc["traceEvents"] if e["ph"] == "C"]
    assert {e["name"] for e in c} == {"route.pres_fac",
                                      "route.overused_nodes", "place.t"}


def test_flight_recorder_matches_jax():
    def clocks():
        n = iter(range(100))
        return dict(clock=lambda: next(n) * 0.5, wall=lambda: 1000.0)
    recs = [cls(capacity=3, **clocks())
            for cls in (JFlightRecorder, TOBS.FlightRecorder)]
    for r in recs:
        for i in range(5):
            r.note("lease", job=f"j{i}")
    assert recs[1].snapshot() == recs[0].snapshot()
    assert recs[1].snapshot()["dropped"] == 2


def test_cuda_builds_are_the_compile_spans(fresh):
    """note_build (called by route/cuda_lib.py for each nvcc build)
    books the build's seconds into compile_seconds() and, with a tracer
    on, a "cuda.build" span: the port's counterpart of XLA's compile
    spans."""
    TOBS.reset_compile_seconds()
    tr = TOBS.Tracer()
    TOBS.set_tracer(tr)
    TOBS.note_build("planes_relax", tr.t0 + 1.0, 2.5)
    TOBS.set_tracer(None)
    TOBS.note_build("slab_permute", 0.0, 0.5)
    assert TOBS.compile_seconds() == 3.0
    (ev,) = tr.events
    assert (ev["name"], ev["cat"], ev["args"]) == (
        "cuda.build", "cuda.build", {"lib": "planes_relax"})
    assert (ev["ts"], ev["dur"]) == (1e6, 2.5e6)
    TTRACE.reset_compile_seconds()
    assert TOBS.compile_seconds() == 0.0


def test_kernel_layout_gauges_pin_their_formulas(fresh):
    """The route.kernel.* gauges and route.kernel span fields carry the
    port's layout (planes_kernels.kernel_layout), pinned here on the
    40-LUT crop fixture, whose first window dispatches K2 on 4x4 tiles
    and K1 on the full canvas: the mode is the most shared state that
    fits the card's limit (smem_bytes, SMEM_OPTIN), one net per thread
    block, occupancy = canvas cells over threads_for's thread-slots, and
    bytes per sweep = the flats' one load and one store per relaxation
    over nsweeps (K2 reading and writing the full flats around its
    tile); the gauges are the dominant dispatch's row."""
    import torch

    from parallel_eda_tpu_torch.flow import synth_flow
    from parallel_eda_tpu_torch.route import planes_kernels as PK
    from parallel_eda_tpu_torch.route import router as TR
    from test_torch_route import CROP_FIXTURE

    tf = synth_flow(**CROP_FIXTURE)
    reg = TOBS.set_metrics(TOBS.MetricsRegistry())
    tr = TOBS.Tracer()
    TOBS.set_tracer(tr)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = TR.Router(tf.rr, TR.RouterOpts(batch_size=32, crop="4x4",
                                           pipeline=False), device="cpu")
        r.route(tf.term)
    finally:
        torch.set_num_threads(n)
        TOBS.set_tracer(None)
    rows = [e["args"] for e in tr.events if e["name"] == "route.kernel"]
    W, NX, NYp1 = r.pg.shape_x
    ncells = r.pg.ncells
    kinds = set()
    for kp in rows:
        tile = kp["tile"]
        X, Y = (tile if tile else (NX, NYp1 - 1))
        kind = PK.TILE if tile else PK.FULL
        kinds.add(kind)
        mode = PK.auto_mode(kind, W, X, Y)
        assert PK.smem_bytes(kind, mode, W, X, Y) <= PK.SMEM_OPTIN
        assert mode == 2 or PK.smem_bytes(kind, mode + 1, W, X, Y) > \
            PK.SMEM_OPTIN
        name = ("planes_relax_cropped_cuda" if tile
                else "planes_relax_full_cuda")
        assert kp["variant"] == f"{name}/mode{mode}"
        cells = W * X * (Y + 1) + W * (X + 1) * Y
        th = PK.threads_for(cells)
        assert kp["block_nets"] == 1
        assert kp["lane_occupancy"] == round(
            cells / (th * -(-cells // th)), 4)
        flats = (24 * cells if not tile else 20 * ncells + 4 * cells)
        assert kp["bytes_per_sweep"] == int(
            flats * kp["nets"] / kp["nsweeps"])
    assert kinds == {PK.TILE, PK.FULL}
    # the gauges: the last window's dispatch covering the most nets
    kev = [e for e in tr.events if e["name"] == "route.kernel"]
    last = [e["args"] for e in kev if e["ts"] == kev[-1]["ts"]]
    dom = max(last, key=lambda kp: kp["nets"])
    g = reg.values("route.kernel.")
    assert (g["route.kernel.packed_block_size"],
            g["route.kernel.lane_occupancy"],
            g["route.kernel.bytes_per_sweep"]) == (
        dom["block_nets"], dom["lane_occupancy"], dom["bytes_per_sweep"])
    # a canvas past the card's shared memory takes mode 0: one
    # traversal of the state per sweep
    shx, shy = (40, 30, 31), (40, 31, 30)
    big = 2 * 40 * 30 * 31
    assert PK.smem_bytes(PK.FULL, 1, 40, 30, 30) > PK.SMEM_OPTIN
    for pd, isz in (("f32", 4), ("bf16", 2)):
        lay = PK.kernel_layout(shx, shy, 8, 16, plane_dtype=pd)
        assert lay["mode"] == 0 and lay["bytes_per_sweep"] == (
            PK.global_sweep_bytes_per_cell(isz) * big * 8)
