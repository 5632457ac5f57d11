"""The port's Router (device="cpu", plain relaxation) against the JAX
Router (pipeline=False): paths, occupancy, iterations, wirelength, the
relaxation ledger and the per-window stats rows must be identical, and
check_route legal.  Also the host-side helpers and the search.py subset
against their JAX counterparts."""

import collections
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu.route import check_route as jax_check_route
from parallel_eda_tpu.route import planes as JP
from parallel_eda_tpu.route import router as JR
from parallel_eda_tpu.route import search as JS
from parallel_eda_tpu.route.device_graph import to_device as jax_to_device
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.route import planes as TP
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route import search as TS
from parallel_eda_tpu_torch.route.check import check_route
from parallel_eda_tpu_torch.route.device_graph import (
    device_graph_from_numpy)

FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
# smallest fixture found where a forced crop engages the cropped
# relaxation (the 15-LUT grid is 3x3: no crop can hold a net there)
CROP_FIXTURE = dict(num_luts=40, num_inputs=6, num_outputs=6,
                    chan_width=10, seed=3, bb_factor=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def port_metrics():
    """A fresh port metrics registry for the block (the process's own
    restored after it)."""
    old = TOBS.get_metrics()
    reg = TOBS.set_metrics(TOBS.MetricsRegistry())
    try:
        yield reg
    finally:
        TOBS.set_metrics(old)


def metric_values(reg):
    """The registry's values; an instrument never touched reads 0, as a
    counter the JAX tests read with ``reg.counter(k).value`` does."""
    return collections.defaultdict(int, reg.values())


_JAX_ROUTES: dict = {}


def _jax_route(cfg, opts):
    """The JAX Router's route (pipeline=False), cached per configuration."""
    key = (tuple(sorted(cfg.items())), tuple(sorted(opts.items())))
    if key not in _JAX_ROUTES:
        jf = jax_synth_flow(**cfg)
        _JAX_ROUTES[key] = jf, JRouter(jf.rr, JOpts(
            pipeline=False, **opts)).route(jf.term)
    return _JAX_ROUTES[key]


def _route_both(cfg, opts):
    jf, jres = _jax_route(cfg, opts)
    tf = synth_flow(**cfg)
    tres = TR.Router(tf.rr, TR.RouterOpts(**opts), device="cpu").route(
        tf.term)
    return jf, jres, tf, tres


def _assert_same_route(jres, tres):
    assert tres.success and jres.success
    assert tres.iterations == jres.iterations
    assert tres.wirelength == jres.wirelength
    assert np.array_equal(tres.paths, jres.paths)
    assert np.array_equal(tres.occ, jres.occ)
    assert tres.total_net_routes == jres.total_net_routes
    assert tres.total_relax_steps == jres.total_relax_steps
    assert tres.total_relax_steps_useful == jres.total_relax_steps_useful
    assert tres.total_relax_steps_cropped == jres.total_relax_steps_cropped
    assert tres.widened_nets == jres.widened_nets
    rows = [(s.iteration, s.overused_nodes, s.overuse_total,
             s.rerouted_nets, s.relax_steps, s.batches)
            for s in jres.stats]
    assert rows == [(s.iteration, s.overused_nodes, s.overuse_total,
                     s.rerouted_nets, s.relax_steps, s.batches)
                    for s in tres.stats]
    assert np.array_equal(tres.sink_delay, jres.sink_delay)


def test_router_matches_jax_parity_fixture():
    jf, jres, tf, tres = _route_both(FIXTURE, dict(batch_size=32))
    _assert_same_route(jres, tres)
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)
    jax_check_route(jf.rr, jf.term, tres.paths, occ=tres.occ)


def test_router_matches_jax_forced_crop():
    jf, jres, tf, tres = _route_both(CROP_FIXTURE,
                                     dict(batch_size=32, crop="4x4"))
    assert jres.total_relax_steps_cropped > 0
    _assert_same_route(jres, tres)
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)


@pytest.mark.slow
def test_router_matches_jax_bench_config():
    cfg = dict(num_luts=60, num_inputs=12, num_outputs=12, chan_width=12,
               seed=11)
    jf, jres, tf, tres = _route_both(cfg, dict(batch_size=64))
    assert (tres.wirelength, tres.iterations) == (537, 22)
    _assert_same_route(jres, tres)
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)


def test_router_opts_defaults_match_jax():
    jd = {f.name: f.default for f in dataclasses.fields(JR.RouterOpts)}
    td = {f.name: f.default for f in dataclasses.fields(TR.RouterOpts)}
    assert set(jd) == set(td)
    assert jd == td


@pytest.mark.parametrize("name,value", [
    ("fused_dispatch", True), ("mesh_shards", 2),
    ("stats_dir", "x"), ("program", "ell"), ("resil", object()),
    ("program_library_dir", "x"), ("compile_cache_dir", "x")])
def test_unported_options_raise(name, value, tmp_path):
    """Each option the port does not have raises naming its ROADMAP.md
    item.  ``stats_dir`` is ported: its case routes the parity fixture
    with the stats files in ``value`` and holds them against the JAX
    Router's.  ``program="ell"`` is ported too: its Router is built (the
    ELL tables on the device) and tests/test_torch_ell.py holds its
    routes against the JAX Router's.  So is ``fused_dispatch``: its case
    routes the parity fixture fused, one dispatch a window, and holds it
    against the JAX route of test_router_matches_jax_parity_fixture
    (JAX's tests/test_kernel_pack.py holds JAX's fused route equal to
    that one).  So is ``resil``: its case routes the parity fixture under
    a resilience runtime with no fault plan, equal to that JAX route
    (tests/test_torch_resil.py holds the routes under faults).  So are
    ``program_library_dir`` and ``compile_cache_dir``: routed through a
    program library (its first route notes every variant) and with a
    compile cache set, the route is that JAX route; the library attaches
    on one device only (tests/test_torch_library.py holds the library
    and the cache)."""
    if name in ("program_library_dir", "compile_cache_dir"):
        from parallel_eda_tpu_torch.route import cuda_lib

        tf = synth_flow(**FIXTURE)
        saved = cuda_lib.cache_dir()
        try:
            with port_metrics() as reg:
                r = TR.Router(tf.rr, TR.RouterOpts(
                    batch_size=32, **{name: str(tmp_path / value)}),
                    device="cpu")
                tres = r.route(tf.term)
            cached = cuda_lib.cache_dir()
        finally:
            cuda_lib.set_cache_dir(saved)
        _assert_same_route(_jax_route(FIXTURE, dict(batch_size=32))[1],
                           tres)
        if name == "compile_cache_dir":
            assert cached == str(tmp_path / value) and r._library is None
        else:
            assert reg.counter("route.serve.jit_fallbacks").value > 0
            assert r.export_program_library() > 0
        return
    if name == "stats_dir":
        _check_stats_dir(tmp_path / value)
        return
    if name == "fused_dispatch":
        tf = synth_flow(**FIXTURE)
        with port_metrics() as reg:
            tres = TR.Router(tf.rr, TR.RouterOpts(batch_size=32,
                                                  fused_dispatch=value),
                             device="cpu").route(tf.term)
        _assert_same_route(_jax_route(FIXTURE, dict(batch_size=32))[1],
                           tres)
        assert reg.gauge("route.kernel.dispatches_per_window").value == 1
        return
    if name == "resil":
        from parallel_eda_tpu_torch.resil import Resilience, ResilOpts

        tf = synth_flow(**FIXTURE)
        with port_metrics() as reg:
            rt = Resilience(ResilOpts())
            tres = TR.Router(tf.rr, TR.RouterOpts(batch_size=32, resil=rt),
                             device="cpu").route(tf.term)
        _assert_same_route(_jax_route(FIXTURE, dict(batch_size=32))[1],
                           tres)
        assert reg.gauge("route.resil.retry_cap").value == 2
        assert rt.ladder.snapshot()["kernel"] == "pallas_packed"
        return
    if name == "program":
        r = TR.Router(synth_flow(**FIXTURE).rr, TR.RouterOpts(program=value),
                      device="cpu")
        assert r.pg is None and r.dev.max_in_degree > 0
        return
    tf = synth_flow(**FIXTURE)
    # mesh_shards: the mesh is ported, and so is every option under it;
    # a program library is attached on one device only, as in JAX
    r = TR.Router(tf.rr, TR.RouterOpts(
        **{name: value}, program_library_dir=str(tmp_path / "L")),
        device="cpu")
    assert r.row_mesh is not None and r._library is None
    assert TR._NOT_PORTED == {}


def _stats_lines(d, fname):
    """The stats file's lines with the seconds column left out."""
    out = []
    for ln in (d / fname).read_text().splitlines():
        tok = ln.split()
        if tok[0] != "iteration" and (fname == "iter_stats.txt"
                                      or tok[0] == "total_route_time"):
            del tok[1]
        out.append(tok)
    return out


def _check_stats_dir(d):
    """The port's stats_dir files against the JAX Router's on the parity
    fixture, congestion-driven: iter_stats.txt (one row per iteration),
    final_stats.txt and route_report.txt equal but for the seconds, the
    mdclog records equal but for their clocks, routes_iter_N.txt
    (``dump_routes``) equal, and devprof.json compared by its keys and
    variant set (JAX's records hold XLA's cost analysis, the port's
    "unavailable" on CPU tensors)."""
    import json

    opts = dict(batch_size=32, dump_routes=True)
    jf = jax_synth_flow(**FIXTURE)
    JRouter(jf.rr, JOpts(pipeline=False, stats_dir=str(d / "jax"),
                         **opts)).route(jf.term)
    tf = synth_flow(**FIXTURE)
    tres = TR.Router(tf.rr, TR.RouterOpts(stats_dir=str(d / "port"),
                                          **opts), device="cpu").route(
        tf.term)
    assert tres.success
    assert [s.iteration for s in tres.stats] == list(
        range(1, tres.iterations + 1))
    for f in ("iter_stats.txt", "final_stats.txt"):
        assert _stats_lines(d / "port", f) == _stats_lines(d / "jax", f)
    port_files = sorted(p.relative_to(d / "port")
                        for p in (d / "port").rglob("*") if p.is_file())
    assert len(port_files) > 4
    for rel in port_files:
        body = (d / "port" / rel).read_text()
        want = (d / "jax" / rel).read_text()
        if rel.suffix == ".log":
            body, want = ([{k: v for k, v in json.loads(ln).items()
                            if k != "t"} for ln in t.splitlines()]
                          for t in (body, want))
        elif rel.name in ("iter_stats.txt", "final_stats.txt"):
            continue
        elif rel.name == "devprof.json":
            body, want = ([json.dumps(r["key"]) for r in json.loads(t)[
                "records"]] for t in (body, want))
        assert body == want, rel


@pytest.mark.parametrize("nx,ny,min_count", [(25, 25, 8), (9, 12, 1),
                                             (40, 17, 4), (6, 6, 1)])
def test_size_class_buckets_match_jax(nx, ny, min_count):
    rng = np.random.default_rng(nx * ny)
    w = rng.integers(3, nx + 3, 200)
    h = rng.integers(3, ny + 3, 200)
    jc, ja = JR._size_class_buckets(w, h, nx, ny, min_count=min_count)
    tc, ta = TR._size_class_buckets(w, h, nx, ny, min_count=min_count)
    assert jc == tc
    assert np.array_equal(ja, ta)


def test_order_and_chunk_match_jax():
    rng = np.random.default_rng(5)
    R = 300
    nsinks = rng.integers(1, 20, R)
    cx = rng.integers(0, 30, R)
    cy = rng.integers(0, 30, R)
    g = np.sort(rng.choice(R, 200, replace=False))
    ja = JR._order_and_chunk(g, nsinks, cx, cy, 64)
    ta = TR._order_and_chunk(g, nsinks, cx, cy, 64)
    assert len(ja) == len(ta)
    assert all(np.array_equal(a, b) for a, b in zip(ja, ta))
    for span in (0, 7, 40, 500):
        assert TR.path_budget(span, 264) == JR.path_budget(span, 264)


def _dev_pair():
    jf = jax_synth_flow(**FIXTURE)
    jdev = jax_to_device(jf.rr)
    fields = {f.name: np.asarray(getattr(jdev, f.name))
              for f in dataclasses.fields(jdev)
              if getattr(jdev, f.name) is not None}
    return jf, jdev, device_graph_from_numpy(fields, "cpu")


def _random_route_state(jf, seed):
    rng = np.random.default_rng(seed)
    N = jf.rr.num_nodes
    R, S = jf.term.sinks.shape
    L = 24
    paths = rng.integers(0, N + 1, (R, S, L)).astype(np.int32)
    paths[rng.random((R, S, L)) < 0.5] = N
    occ = rng.integers(0, 3, N).astype(np.int32)
    acc = rng.uniform(1, 3, N).astype(np.float32)
    reached = rng.random(R) < 0.8
    return paths, occ, acc, reached


def test_search_subset_matches_jax():
    jf, jdev, tdev = _dev_pair()
    paths, occ, acc, reached = _random_route_state(jf, 0)
    N = jf.rr.num_nodes
    occ_b = np.stack([occ, occ - 1, occ + 1]).astype(np.int32)
    for pres in (0.5, 0.5 * 1.3 ** 7, 37.1):
        want = np.asarray(JS.congestion_cost(
            jdev, jnp.asarray(occ_b), jnp.asarray(acc),
            jnp.float32(pres)))
        got = TS.congestion_cost(tdev, torch.from_numpy(occ_b),
                                 torch.from_numpy(acc),
                                 torch.tensor(pres, dtype=torch.float32))
        assert np.array_equal(want, got.numpy())
    want = np.asarray(JS.usage_from_paths(jnp.asarray(paths),
                                          jnp.zeros(N + 1)))
    got = TS.usage_from_paths(torch.from_numpy(paths), N).numpy()
    assert np.array_equal(want, got)
    assert int(JS.wirelength_on_device(jdev, jnp.asarray(paths))) == int(
        TS.wirelength_on_device(tdev, torch.from_numpy(paths)))
    jw = JS.iteration_summary(jdev, jnp.asarray(occ), jnp.asarray(paths),
                              jnp.asarray(reached), jnp.int32(5))
    tw = TS.iteration_summary(tdev, torch.from_numpy(occ),
                              torch.from_numpy(paths),
                              torch.from_numpy(reached),
                              torch.tensor(5, dtype=torch.int32))
    for a, b in zip(jw, tw):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed,topk", [(0, 8), (1, 64), (2, 1024)])
def test_mis_colors_match_jax(seed, topk):
    jf, jdev, tdev = _dev_pair()
    paths, occ, acc, reached = _random_route_state(jf, seed)
    topk = min(topk, jf.rr.num_nodes)
    jr, jc = JP._mis_colors(jdev, jnp.asarray(occ), jnp.asarray(paths),
                            jnp.asarray(reached), topk, 5)
    tr, tc = TP._mis_colors(tdev, torch.from_numpy(occ),
                            torch.from_numpy(paths),
                            torch.from_numpy(reached), topk, 5)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 60, 124, 257, 300])
def test_cumsum_matches_xla_order(n):
    """The walk's delay suffix sums group the f32 adds as XLA:CPU does."""
    w = np.random.default_rng(n).uniform(0, 1e-10, (3, 4, n)
                                         ).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(w), axis=2))
    assert np.array_equal(want, TP._cumsum_xla(torch.from_numpy(w)).numpy())


def test_unpack_window_status_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 1 << 24, 100).astype(np.int32)
    for a, b in zip(JP.unpack_window_status(s),
                    TP.unpack_window_status(s)):
        assert np.array_equal(a, b)


def _port_pg(pg):
    f = {k: np.asarray(getattr(pg, k)) for k in TP._PG_FIELDS}
    f.update(directional=pg.directional, max_span=pg.max_span,
             inc_track=(None if pg.inc_track is None
                        else np.asarray(pg.inc_track)))
    return TP.planes_graph_from_numpy(f, "cpu")


@pytest.mark.parametrize("cfg,tile,widen", [(FIXTURE, None, False),
                                            (CROP_FIXTURE, (4, 4), True)])
def test_window_matches_jax(cfg, tile, widen):
    """One K_iters=2 window from a fresh state: every state array and the
    packed status/scal summary equal the JAX program's, on the very same
    graph (the JAX graph state handed over through numpy)."""
    window_matches_jax(cfg, tile, widen)


def window_matches_jax(cfg, tile, widen, plane_dtype="f32"):
    """test_window_matches_jax's comparison, in plane dtype
    ``plane_dtype``; returns the port's scal."""
    jf = jax_synth_flow(**cfg)
    rr, term = jf.rr, jf.term
    jr = JRouter(rr, JOpts(batch_size=32, pipeline=False))
    R, S = term.sinks.shape
    N = rr.num_nodes
    L = 64
    pt = JP.build_planes_terminals(rr, term.source, term.sinks,
                                   np.asarray(jr.pg.cell_of_node),
                                   jr.pg.ncells)
    tables = (pt.opin_node, pt.entry_cell, pt.entry_oidx, pt.entry_delay,
              pt.sink_uid, pt.uid_cell, pt.uid_ipin, pt.uid_delay,
              pt.direct_oidx, pt.direct_ipin, pt.direct_delay)
    nsinks = term.num_sinks.astype(np.int64)
    cx = ((term.bb_xmin + term.bb_xmax) // 2).astype(np.int64)
    cy = ((term.bb_ymin + term.bb_ymax) // 2).astype(np.int64)
    sel, valid = jr._plan_groups(np.arange(R), None, nsinks, cx, cy, 32, R)
    bb = np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                   term.bb_ymax], axis=1).astype(np.int32)
    full_bb = np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1], np.int32)
    widen_ok = (np.arange(R) % 2 == 0) if widen else None
    state = dict(occ=np.zeros(N, np.int32), acc=np.ones(N, np.float32),
                 paths=np.full((R, S, L), N, np.int32),
                 sd=np.full((R, S), np.inf, np.float32),
                 ar=np.zeros(R, bool), bb=bb.copy())
    common = dict(K_iters=2, nsweeps=16, max_len=L, num_waves=4, group=S,
                  doubling=True, topk=min(4096, N), n_colors=5,
                  crop_tile=tile)
    jo = JP.route_window_planes(
        jr.pg, jr.dev, *(jnp.asarray(state[k].copy()) for k in
                         ("occ", "acc", "paths", "sd", "ar", "bb")),
        jnp.asarray(term.source.astype(np.int32)),
        jnp.asarray(term.sinks.astype(np.int32)),
        jnp.zeros((R, S), jnp.float32), *(jnp.asarray(a) for a in tables),
        jnp.asarray(sel), jnp.asarray(valid), jnp.asarray(full_bb),
        jnp.float32(0.5), jnp.float32(1.3), jnp.float32(1000.0),
        jnp.float32(1.0), jnp.int32(0), jnp.int32(1),
        bb0_all=jnp.asarray(bb),
        widen_ok=None if widen_ok is None else jnp.asarray(widen_ok),
        plane_dtype=plane_dtype, **common)
    fields = {f.name: np.asarray(getattr(jr.dev, f.name))
              for f in dataclasses.fields(jr.dev)
              if getattr(jr.dev, f.name) is not None}

    def t(a):
        return torch.from_numpy(np.array(a))
    tp = {k: t(state[k]) for k in state}
    occ, acc, status, scal, dmax_hist = TP.route_window_planes(
        _port_pg(jr.pg), device_graph_from_numpy(fields, "cpu"),
        tp["occ"], tp["acc"], tp["paths"], tp["sd"], tp["ar"], tp["bb"],
        t(term.source.astype(np.int32)), t(term.sinks.astype(np.int32)),
        torch.zeros((R, S)), *(t(a) for a in tables), t(sel), t(valid),
        t(full_bb), 0.5, 1.3, 1000.0, 1.0, 0, 1, bb0_all=t(bb),
        widen_ok=None if widen_ok is None else t(widen_ok),
        plane_dtype=plane_dtype, **common)
    for j, p in ((jo[0], occ), (jo[1], acc), (jo[2], tp["paths"]),
                 (jo[3], tp["sd"]), (jo[4], tp["ar"]), (jo[5], tp["bb"]),
                 (jo[21], status), (jo[22], scal)):
        assert np.array_equal(np.asarray(j), p.numpy())
    # no timing graph: the crit-path history stays NaN
    assert np.array_equal(np.asarray(jo[14]), dmax_hist.numpy(),
                          equal_nan=True)
    if tile is not None:
        assert int(scal[TP.SCAL_S_EXEC]) > 0
    return scal
