"""The port's pipelined window driver (``RouterOpts.pipeline``, now the
default) against its synchronous one and the JAX Router in the same
mode, on the CPU: routes, stats rows (seconds aside) and congestion
records equal; checkpoints taken pipelined equal the synchronous ones
and resume identically in both modes; the plan and criticality uploads
skipped when unchanged; the blocking syncs and skipped uploads counted
as the JAX Router counts them; ``congestion_topk=0`` records nothing.
Every comparison is exact."""

import numpy as np
import pytest
import torch
from test_torch_elastic import (FLOW, OPTS, assert_same_checkpoint,
                                assert_same_route)

from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu.obs import MetricsRegistry, get_metrics, set_metrics
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route
from test_torch_route import metric_values, port_metrics

MODES = [True, False]
CK = dict(checkpoint_every=2, max_router_iterations=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(jf, pipeline, resume=None, **kw):
    """The JAX route in mode ``pipeline`` and its route.pipeline.*
    metrics."""
    old = set_metrics(MetricsRegistry())
    try:
        res = JRouter(jf.rr, JOpts(pipeline=pipeline, **OPTS, **kw)).route(
            jf.term, resume=resume)
        return res, get_metrics().values("route.pipeline.")
    finally:
        set_metrics(old)


def _port(tf, pipeline, resume=None, **kw):
    """The port's route in mode ``pipeline`` and its metrics."""
    with port_metrics() as reg:
        r = TR.Router(tf.rr, TR.RouterOpts(pipeline=pipeline, **OPTS, **kw),
                      device="cpu")
        res = r.route(tf.term, resume=resume)
    return res, metric_values(reg)


@pytest.fixture(scope="module")
def tflow():
    return synth_flow(**FLOW)


@pytest.fixture(scope="module")
def jax_runs():
    jf = jax_synth_flow(**FLOW)
    out = {}
    for p in MODES:
        out["solo", p] = _jax(jf, p)
        out["ck", p] = _jax(jf, p, **CK)
    out["resumed"] = _jax(jf, True, resume=out["ck", True][0].checkpoint)
    out["topk0"] = _jax(jf, True, congestion_topk=0, **CK)
    return out


@pytest.fixture(scope="module")
def port_solo(tflow):
    return {p: _port(tflow, p) for p in MODES}


@pytest.mark.parametrize("pipeline", MODES, ids=["pipelined", "sync"])
def test_route_matches_jax(jax_runs, port_solo, tflow, pipeline):
    """Paths, occupancy, ledger, stats rows and congestion records equal
    the JAX route in the same mode and the port's other mode (JAX
    test_congestion_telemetry_pipelined_matches_sync)."""
    res, _ = port_solo[pipeline]
    assert res.success
    assert_same_route(jax_runs["solo", pipeline][0], res)
    assert_same_route(port_solo[not pipeline][0], res)
    assert res.congestion
    assert {"window", "iteration", "overused_nodes", "overuse_total",
            "pres_fac", "top_overused"} == set(res.congestion[0])
    for node, over in (e for r in res.congestion
                       for e in r["top_overused"]):
        assert 0 <= node < tflow.rr.num_nodes and over > 0
    check_route(tflow.rr, tflow.term, res.paths, occ=res.occ)


@pytest.mark.parametrize("pipeline", MODES, ids=["pipelined", "sync"])
def test_pipeline_metrics_match_jax(jax_runs, port_solo, pipeline):
    """One blocking sync per pipelined window and one per rung when
    synchronous, and the skipped plan uploads: the JAX Router's counts.
    The host seconds: every gauge set, host work overlapped only when
    pipelined."""
    res, m = port_solo[pipeline]
    jm = jax_runs["solo", pipeline][1]
    for k in ("blocking_syncs", "upload_skips"):
        assert m["route.pipeline." + k] == jm["route.pipeline." + k], k
    if pipeline:
        assert m["route.pipeline.blocking_syncs"] == len(res.stats)
        assert 0.0 < m["route.pipeline.host_overlap_frac"] <= 1.0
    else:
        assert m["route.pipeline.blocking_syncs"] >= len(res.stats)
        assert m["route.pipeline.host_overlap_frac"] == 0.0
    assert m["route.pipeline.upload_skips"] > 0
    for k in TR._PIPELINE_GAUGES:
        assert m[k] >= 0.0, k
    assert 0.0 < m["route.pipeline.overlap_frac"] <= 1.0


def test_pipelined_checkpoint_matches_sync(jax_runs, tflow):
    """A checkpoint lands after the in-flight window's summary is read:
    taken pipelined it equals the synchronous one and JAX's, and resumes
    to the same route in both modes, JAX's resume (JAX
    test_checkpoint_resume_drains_pipeline)."""
    ck = {p: _port(tflow, p, **CK)[0] for p in MODES}
    for p in MODES:
        assert not ck[p].success
        assert_same_route(jax_runs["ck", p][0], ck[p])
        assert_same_checkpoint(jax_runs["ck", p][0].checkpoint,
                               ck[p].checkpoint)
    assert_same_checkpoint(ck[False].checkpoint, ck[True].checkpoint)
    fin = {p: _port(tflow, p, resume=ck[True].checkpoint)[0]
           for p in MODES}
    assert fin[True].success
    assert_same_route(fin[False], fin[True])
    assert_same_route(jax_runs["resumed"][0], fin[True])


def test_congestion_topk_zero_records_nothing(jax_runs, tflow):
    for p in MODES:
        res, _ = _port(tflow, p, congestion_topk=0, **CK)
        assert res.congestion == [] == jax_runs["topk0"][0].congestion
        assert_same_route(jax_runs["topk0"][0], res)


def test_crit_upload_skipped_when_unchanged():
    """A timing_cb that returns the same criticalities leaves them on the
    device: one skip per callback, each after a window that did not
    converge (JAX test_crit_upload_skipped_when_unchanged).  A host
    callback keeps the synchronous order in both modes."""
    tf = synth_flow(num_luts=15, num_inputs=6, num_outputs=6,
                    chan_width=10, seed=3)
    const = np.full(tf.term.sinks.shape, 0.4, dtype=np.float32)
    out = {}
    for p in MODES:
        with port_metrics() as reg:
            r = TR.Router(tf.rr, TR.RouterOpts(pipeline=p, **OPTS),
                          device="cpu")
            res = r.route(tf.term, crit=const, timing_cb=lambda _r: const)
        assert res.success
        assert reg.counter("route.pipeline.crit_upload_skips").value == \
            len(res.stats) - 1 >= 1
        out[p] = res
    assert_same_route(out[False], out[True])


def test_plan_staging_skips_equal_uploads():
    """_PlanStaging reuses a slot's tensor for an equal array (counting
    the skip), uploads a changed one, keeps slots apart by name, and
    never shares memory with the caller's array."""
    with port_metrics() as reg:
        st = TR._PlanStaging(torch.device("cpu"))
        a = np.arange(12, dtype=np.int32).reshape(3, 4)
        d1 = st.put("sel", a)
        assert st.put("sel", a.copy()) is d1
        assert reg.counter("route.pipeline.upload_skips").value == 1
        a[0, 0] = 7
        assert int(d1[0, 0]) == 0
        d3 = st.put("sel", a)
        assert d3 is not d1 and torch.equal(d3, torch.from_numpy(a))
        assert st.put("valid", a) is not d3
        assert reg.counter("route.pipeline.upload_skips").value == 1
