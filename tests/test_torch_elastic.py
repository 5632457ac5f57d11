"""The port's elastic route (RouteCheckpoint, resume, checkpoint_every,
slice_iterations) against the JAX Router on the CPU: checkpoints equal
field by field and driver key by driver key, checkpoints carried both
ways resume to the JAX package's own resumed route, the finishing pass
survives a checkpoint, sliced routes resumed until success equal the
unsliced route (a resume keeps the last window's live bb sizes:
ROADMAP.md C8), a mesh_shards=2 checkpoint resumes at 1 and 4 shards,
and a timing-driven route sliced and resumed equals JAX's.  Every
comparison is exact; stats rows are compared without their seconds.

The timing-driven JAX reference runs under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` in a subprocess
(test_torch_planes.avx_reference): this file, run as a script, writes
it to an .npz."""

import dataclasses
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch
import test_torch_planes as TPL  # noqa: E402
import test_torch_timing as TT  # noqa: E402

from parallel_eda_tpu.flow import synth_flow as jax_synth_flow  # noqa: E402
from parallel_eda_tpu.route import Router as JRouter  # noqa: E402
from parallel_eda_tpu.route import RouterOpts as JOpts  # noqa: E402
from parallel_eda_tpu.route import router as JR  # noqa: E402
from parallel_eda_tpu_torch.flow import synth_flow  # noqa: E402
from parallel_eda_tpu_torch.route import router as TR  # noqa: E402
from parallel_eda_tpu_torch.route.check import check_route  # noqa: E402

# the 40-LUT flow of tests/test_elastic.py
FLOW = dict(num_luts=40, num_inputs=8, num_outputs=8, chan_width=12, seed=3)
OPTS = dict(batch_size=32)
# interrupted mid-negotiation, with a checkpoint at iteration >= 2
CK = dict(checkpoint_every=2, max_router_iterations=4)
# the timing-driven case's slice
TIMING_SLICE = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stats_rows(res):
    return [(s.iteration, s.overused_nodes, s.overuse_total,
             s.rerouted_nets, s.relax_steps, s.batches, s.overuse_pct)
            for s in res.stats]


def assert_same_route(want, got):
    """Result, state, ledger, stats rows (seconds aside) and congestion
    records equal."""
    assert (got.success, got.iterations, got.wirelength) == \
        (want.success, want.iterations, want.wirelength)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for k in ("total_net_routes", "total_relax_steps",
              "total_relax_steps_useful", "total_relax_steps_cropped",
              "widened_nets"):
        assert getattr(got, k) == getattr(want, k), k
    assert stats_rows(got) == stats_rows(want)
    assert got.congestion == want.congestion


def _same_value(a, b, name):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b), name
    else:
        assert type(a) is type(b) and a == b, (name, a, b)


def assert_same_checkpoint(want, got):
    """Every field, every driver key and fin_save equal, dtypes and
    Python types included."""
    assert want is not None and got is not None
    for f in dataclasses.fields(JR.RouteCheckpoint):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "driver":
            assert set(b) == set(a) == set(TR.CHECKPOINT_DRIVER_KEYS)
            for k in a:
                if a[k] is None:
                    assert b[k] is None, k
                else:
                    _same_value(a[k], b[k], k)
        elif f.name == "fin_save":
            assert (a is None) == (b is None)
            for i, (x, y) in enumerate(zip(a or (), b or ())):
                _same_value(x, y, f"fin_save[{i}]")
        else:
            _same_value(a, b, f.name)


def jax_fields(ck):
    return {f.name: getattr(ck, f.name) for f in dataclasses.fields(ck)}


@pytest.fixture(scope="module")
def jflow():
    return jax_synth_flow(**FLOW)


@pytest.fixture(scope="module")
def tflow():
    return synth_flow(**FLOW)


def jroute(jf, resume=None, **kw):
    return JRouter(jf.rr, JOpts(pipeline=False, **{**OPTS, **kw})).route(
        jf.term, resume=resume)


def troute(tf, resume=None, **kw):
    return TR.Router(tf.rr, TR.RouterOpts(**{**OPTS, **kw}),
                     device="cpu").route(tf.term, resume=resume)


@pytest.fixture(scope="module")
def jax_runs(jflow):
    """The JAX Router's routes: whole, interrupted with a checkpoint,
    resumed from it, and the finishing-pass checkpoint resumed with no
    budget left."""
    out = {"solo": jroute(jflow), "ck": jroute(jflow, **CK)}
    out["resumed"] = jroute(jflow, resume=out["ck"].checkpoint)
    out["fin"] = jroute(jflow, checkpoint_every=1)
    fck = out["fin"].checkpoint
    out["fin_resumed"] = jroute(jflow, resume=fck,
                                max_router_iterations=fck.it_done)
    return out


@pytest.fixture(scope="module")
def port_ck(tflow):
    return troute(tflow, **CK)


def test_checkpoint_matches_jax(jax_runs, port_ck):
    assert not port_ck.success
    assert port_ck.checkpoint.it_done >= 2
    assert port_ck.iterations == jax_runs["ck"].iterations
    assert_same_route(jax_runs["ck"], port_ck)
    assert_same_checkpoint(jax_runs["ck"].checkpoint, port_ck.checkpoint)


def test_checkpoint_numpy_round_trip(port_ck):
    """checkpoint_to_numpy / checkpoint_from_numpy copy every array and
    carry every field; a driver dict without one of its keys raises."""
    ck = port_ck.checkpoint
    d = TR.checkpoint_to_numpy(ck)
    assert set(d) == {f.name for f in dataclasses.fields(JR.RouteCheckpoint)}
    back = TR.checkpoint_from_numpy(d)
    assert_same_checkpoint(ck, back)
    d["occ"][:] = -1
    back.paths[:] = -1
    assert (ck.occ >= 0).all() and (ck.paths >= 0).all()
    d = TR.checkpoint_to_numpy(ck)
    del d["driver"]["budget_full"]
    with pytest.raises(ValueError, match="budget_full"):
        TR.checkpoint_from_numpy(d)


def test_port_resumes_jax_checkpoint(jax_runs, tflow):
    """A JAX checkpoint resumed in the port ends as JAX's own resume; the
    resume leaves the checkpoint as it was."""
    ck = TR.checkpoint_from_numpy(jax_fields(jax_runs["ck"].checkpoint))
    keep = TR.checkpoint_to_numpy(ck)
    res = troute(tflow, resume=ck)
    assert res.success
    assert_same_route(jax_runs["resumed"], res)
    check_route(tflow.rr, tflow.term, res.paths, occ=res.occ)
    assert_same_checkpoint(TR.checkpoint_from_numpy(keep), ck)


def test_jax_resumes_port_checkpoint(jax_runs, jflow, port_ck):
    ck = JR.RouteCheckpoint(**TR.checkpoint_to_numpy(port_ck.checkpoint))
    assert_same_route(jax_runs["resumed"], jroute(jflow, resume=ck))


def test_finishing_pass_checkpoint(jax_runs, tflow):
    """With checkpoint_every=1 the final checkpoint is taken while the
    finishing pass is live: it carries finish_done and the pre-finish
    legal state, and a resume with no budget left restores that legal
    route (JAX test_checkpoint_during_finishing_pass_preserves_success)."""
    res = troute(tflow, checkpoint_every=1)
    assert res.success
    assert_same_route(jax_runs["fin"], res)
    ck = res.checkpoint
    assert ck.driver["finish_done"] and ck.fin_save is not None
    assert_same_checkpoint(jax_runs["fin"].checkpoint, ck)
    back = troute(tflow, resume=ck, max_router_iterations=ck.it_done)
    assert back.success and not back.stats
    assert_same_route(jax_runs["fin_resumed"], back)
    check_route(tflow.rr, tflow.term, back.paths, occ=back.occ)


@pytest.mark.parametrize("slice_iterations", [1, 2])
def test_sliced_resume_matches_unsliced(jax_runs, tflow, slice_iterations):
    """Yield at every slice's edge and resume until success: the route,
    and the slices' stats rows and congestion records joined, equal the
    unsliced JAX route's (as JAX's queue preemption test, without the
    queue)."""
    r = TR.Router(tflow.rr, TR.RouterOpts(
        slice_iterations=slice_iterations, **OPTS), device="cpu")
    res = r.route(tflow.term)
    slices = [res]
    while not res.success:
        assert res.checkpoint is not None
        assert res.iterations == res.checkpoint.it_done
        res = r.route(tflow.term, resume=res.checkpoint)
        slices.append(res)
    assert len(slices) > 2
    solo = jax_runs["solo"]
    for k in ("iterations", "wirelength"):
        assert getattr(res, k) == getattr(solo, k), k
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(res, k), getattr(solo, k)), k
    assert [row for s in slices for row in stats_rows(s)] == \
        stats_rows(solo)
    assert [c for s in slices for c in s.congestion] == solo.congestion
    assert sum(s.total_relax_steps for s in slices) == \
        solo.total_relax_steps


def test_resume_keeps_the_windows_live_sizes():
    """ROADMAP.md C8: a resumed route takes each net's live bb size as the
    last window's summary gave it, in 8-tile buckets, so a sliced route
    under a forced 4x4 crop (which only an exact width can fit) equals
    the unsliced JAX route; the JAX Router resumes with the exact widths
    and its own sliced route leaves its unsliced one here."""
    cfg = dict(num_luts=40, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3, bb_factor=0)
    fields = dict(batch_size=32, crop="4x4", slice_iterations=1)
    jf, tf = jax_synth_flow(**cfg), synth_flow(**cfg)
    solo = JRouter(jf.rr, JOpts(pipeline=False, batch_size=32,
                                crop="4x4")).route(jf.term)
    assert solo.total_relax_steps_cropped > 0
    for router, term in ((JRouter(jf.rr, JOpts(pipeline=False, **fields)),
                          jf.term),
                         (TR.Router(tf.rr, TR.RouterOpts(**fields),
                                    device="cpu"), tf.term)):
        res = router.route(term)
        while not res.success:
            res = router.route(term, resume=res.checkpoint)
        if isinstance(router, JRouter):
            assert (res.wirelength, res.iterations) != (solo.wirelength,
                                                        solo.iterations)
    assert (res.wirelength, res.iterations) == (solo.wirelength,
                                                solo.iterations)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(res, k), getattr(solo, k)), k


@pytest.fixture(scope="module")
def mesh2_ck(tflow):
    return troute(tflow, mesh_shards=2, **CK)


@pytest.mark.parametrize("shards", [1, 4])
def test_mesh_checkpoint_resumes(jax_runs, tflow, mesh2_ck, shards):
    """A checkpoint taken at mesh_shards=2 equals the single-device one
    and resumes at 1 and 4 shards to JAX's single-device resume (JAX
    test_elastic_shrink_mesh_to_single, with the port's row mesh)."""
    assert_same_checkpoint(jax_runs["ck"].checkpoint, mesh2_ck.checkpoint)
    res = troute(tflow, resume=mesh2_ck.checkpoint, mesh_shards=shards)
    assert res.success
    want = jax_runs["resumed"]
    assert (res.iterations, res.wirelength) == (want.iterations,
                                                want.wirelength)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(res, k), getattr(want, k)), k
    assert res.congestion == want.congestion


def timing_slices(pkg, slice_iterations):
    """The 15-LUT parity fixture routed timing-driven (the analyzer's STA
    between iterations) with ``pkg``, sliced and resumed until success;
    the final analysis gives the critical path."""
    m = TT._mods(pkg)
    f = TT._flow(pkg, TT.FIXTURE)
    ta = m["timing.sta"].TimingAnalyzer(
        m["timing.graph"].build_timing_graph(f.nl, f.pnl, f.term),
        **TT._kw(pkg))
    router = m["route.router"].Router(f.rr, TT._opts(pkg, dict(
        batch_size=32, slice_iterations=slice_iterations)), **TT._kw(pkg))
    res = router.route(f.term, analyzer=ta)
    n = 1
    while not res.success:
        res = router.route(f.term, analyzer=ta, resume=res.checkpoint)
        n += 1
    ta.analyze(res.sink_delay)
    return dict(paths=res.paths, occ=res.occ, sink_delay=res.sink_delay,
                wirelength=np.array(res.wirelength),
                iterations=np.array(res.iterations),
                cpd=np.array(ta.crit_path_delay), slices=np.array(n))


def write_reference(path):
    """JAX's timing-driven routes, whole and sliced, into the .npz
    ``path``.  Run under the reference flags."""
    out = {}
    for s in (0, TIMING_SLICE):
        for k, v in timing_slices(TT.JAX_PKG, s).items():
            out[f"{s}/{k}"] = v
    np.savez(path, **out)


def test_timing_slices_match_jax(tmp_path):
    """Sliced and resumed with an analyzer, the route and its critical
    path equal JAX's sliced route, JAX's whole route and the port's
    whole route (the criticalities travel in the checkpoint)."""
    ref = TPL.avx_reference(tmp_path / "timing.npz", __file__, [])
    whole = timing_slices(TT.PORT_PKG, 0)
    got = timing_slices(TT.PORT_PKG, TIMING_SLICE)
    assert int(got["slices"]) > 2 and int(whole["slices"]) == 1
    for k, v in got.items():
        if k != "slices":
            for want in (ref[f"{TIMING_SLICE}/{k}"], ref[f"0/{k}"],
                         whole[k]):
                assert np.array_equal(v, want), k
    assert int(ref[f"{TIMING_SLICE}/slices"]) == int(got["slices"])
    assert (int(got["wirelength"]), int(got["iterations"])) == \
        TT.EXPECT["analyzer"]


if __name__ == "__main__":
    write_reference(sys.argv[1])
