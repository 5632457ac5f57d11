"""The port's continuous batching (parallel_eda_tpu_torch/serve/fused.py,
the queue's batch half in serve/queue.py, ``RouteService(fused=True)``
and ``serve --fused``) against the JAX package's, on the CPU.

* the queue's batch half (``queued_jobs``, ``evict``, ``_pop_runnable``,
  ``run_batch``) step for step beside JAX's: the scenarios of JAX
  tests/test_fused.py:61-200 run on both queues with the same fake
  runners and clocks, and their transcripts must be equal;
* the fused-window request's argument layout (``_split_request``'s
  index map) in the port's route_gen;
* routes: ONE JAX reference subprocess per module (this file run as a
  script) runs the JAX ``serve --fused`` CLI over a join/leave schedule
  (three 10-LUT jobs, the first and third a seeded net subset, admitted
  two then one at the first slice boundary, slice 2) and keeps each
  job's occupancy and paths.  The port's ``serve --fused`` on the same
  schedule must give JAX's summary line but for seconds (per-job
  wirelength and iterations, the route.serve.fused.* values, the
  rebatch events) and JAX's occupancy and paths, job for job; and each
  job must equal its solo route;
* a multi call that fails — at the merged ``dispatch.error`` site, or
  after it has advanced its first member — degrades to per-job solo
  dispatch from each member's restored window entry, with the solo
  routes' results.
"""

import ast
import contextlib
import io
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["serve", "--jobs", "3", "--luts", "10", "--slice", "2", "--fused",
       "--stagger", "2", "--profile", "small-heavy", "--heavy_every", "2"]
# the summary's seconds, and the port's layout figure
TIMED_JOB = ("route_s", "nets_per_s")
TIMED_SERVE = ("route.serve.warm_start_s", "route.serve.aggregate_nets_per_s",
               "route.serve.fused.slice_wall_s",
               "route.serve.tenant.t0.nets_per_s",
               "route.serve.tenant.t1.nets_per_s",
               "route.serve.pack.lane_occupancy")


def _capture_run(service_mod, sink):
    """Wrap ``service_mod.RouteService.run`` to keep the drained jobs."""
    orig = service_mod.RouteService.run

    def run(self):
        jobs = orig(self)
        sink["jobs"] = jobs
        return jobs

    service_mod.RouteService.run = run
    return orig


def _jax_reference(out_dir):
    """Script mode: JAX's ``serve --fused`` over the module's schedule;
    writes its summary line and each job's occupancy and paths."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.__main__ import main
    from parallel_eda_tpu.serve import service

    sink = {}
    _capture_run(service, sink)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(CLI))
    with open(os.path.join(out_dir, "cli.json"), "w") as f:
        f.write(buf.getvalue().strip().splitlines()[-1])
    arrays = {}
    for j in sink["jobs"]:
        res = j.result["result"]
        arrays[j.job_id + "/occ"] = np.asarray(res.occ)
        arrays[j.job_id + "/paths"] = np.asarray(res.paths)
    np.savez(os.path.join(out_dir, "routes.npz"), **arrays)


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
    sys.exit(0)


import torch  # noqa: E402

from parallel_eda_tpu import obs as JOBS  # noqa: E402
from parallel_eda_tpu.serve import queue as JQ  # noqa: E402
from parallel_eda_tpu_torch import obs as TOBS  # noqa: E402
from parallel_eda_tpu_torch.__main__ import main as port_main  # noqa: E402
from parallel_eda_tpu_torch.flow import synth_flow  # noqa: E402
from parallel_eda_tpu_torch.resil import FaultPlan, ResilOpts  # noqa: E402
from parallel_eda_tpu_torch.route import planes as TP  # noqa: E402
from parallel_eda_tpu_torch.route import router as TR  # noqa: E402
from parallel_eda_tpu_torch.route.check import check_route  # noqa: E402
from parallel_eda_tpu_torch.rr.terminals import subset_terminals  # noqa
from parallel_eda_tpu_torch.serve import fused as TF  # noqa: E402
from parallel_eda_tpu_torch.serve import queue as TQ  # noqa: E402
from parallel_eda_tpu_torch.serve import service as TS  # noqa: E402

OPTS = dict(batch_size=32, sink_group=0, max_router_iterations=50)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries():
    jold, told = JOBS.get_metrics(), TOBS.get_metrics()
    JOBS.set_metrics(JOBS.MetricsRegistry())
    TOBS.set_metrics(TOBS.MetricsRegistry(enabled=True))
    yield
    JOBS.set_metrics(jold)
    TOBS.set_metrics(told)


_PROC = {}


@pytest.fixture(scope="module", autouse=True)
def _start_jax_reference(tmp_path_factory):
    """Start the module's one JAX reference subprocess at once, so that
    it runs beside the in-process cases."""
    out = str(tmp_path_factory.mktemp("jax_fused"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    log = open(os.path.join(out, "log.txt"), "w")
    _PROC["p"] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out], cwd=REPO,
        env=env, stdout=log, stderr=subprocess.STDOUT)
    _PROC["out"] = out
    yield
    p = _PROC.pop("p")
    if p.poll() is None:
        p.kill()
        p.wait()
    log.close()


@pytest.fixture(scope="module")
def jax_ref():
    rc = _PROC["p"].wait(timeout=900)
    out = _PROC["out"]
    assert rc == 0, open(os.path.join(out, "log.txt")).read()[-4000:]
    with open(os.path.join(out, "cli.json")) as f:
        line = json.load(f)
    return line, dict(np.load(os.path.join(out, "routes.npz")))


# ---- the queue's batch half --------------------------------------------

def _batch_scenario(Q, name):
    """Run batch scenario ``name`` on queue module ``Q``; returns its
    transcript."""
    clk = {"t": 0.0}
    slept, rounds = [], []

    def sleep(dt):
        slept.append(dt)
        clk["t"] += dt

    def job(**kw):
        return Q.RouteJob(tenant=kw.pop("tenant", "t"), payload=None, **kw)

    q = Q.JobQueue(clock=lambda: clk["t"], sleep=sleep)
    if name == "coadmit":
        a, b = q.admit(job()), q.admit(job())

        def br(batch):
            rounds.append(sorted(j.job_id for j in batch))
            out = {}
            for j in batch:
                assert j.state is Q.JobState.RUNNING
                if j.job_id == a.job_id and j.checkpoint is None:
                    out[j.job_id] = ("preempted", {"it": 2})
                else:
                    out[j.job_id] = ("done", {"ok": True})
            return out
    elif name == "missing_verdict":
        a, b = q.admit(job()), q.admit(job())

        def br(batch):
            rounds.append(sorted(j.job_id for j in batch))
            return {a.job_id: ("done", {})}
    elif name == "raise_then_retry":
        q.admit(job(max_retries=1))
        q.admit(job(max_retries=1, backoff_s=0.2))
        calls = {"n": 0}

        def br(batch):
            calls["n"] += 1
            rounds.append(sorted(j.job_id for j in batch))
            if calls["n"] == 1:
                raise RuntimeError("fused slice died")
            return {j.job_id: ("done", {}) for j in batch}
    elif name == "deadline_tombstones":
        q.admit(job())
        q.admit(job(deadline_s=1.0))
        shed = q.admit(job())
        rounds.append(q.evict(shed.job_id, error="overload").job_id)
        rounds.append(q.evict(shed.job_id) is None)   # already terminal
        rounds.append(q.evict("nobody") is None)
        clk["t"] = 5.0

        def br(batch):
            rounds.append(sorted(j.job_id for j in batch))
            return {j.job_id: ("done", {}) for j in batch}
    elif name == "priorities_and_gates":
        for p in (0, 5, 2):
            q.admit(job(priority=p, max_retries=2, backoff_s=0.5))
        rounds.append(sorted(j.job_id for j in q.queued_jobs()))
        n = {"r": 0}

        def br(batch):
            n["r"] += 1
            rounds.append([j.job_id for j in batch])
            out = {}
            for i, j in enumerate(batch):
                if n["r"] == 1 and i == 0:
                    out[j.job_id] = ("failed", "first member failed")
                elif n["r"] < 3:
                    out[j.job_id] = ("preempted", {"r": n["r"]})
                else:
                    out[j.job_id] = ("done", {"r": n["r"]})
            return out
    jobs = q.run_batch(br, max_batches=50)
    return {"rounds": rounds, "slept": slept, "t": clk["t"],
            "jobs": [(j.job_id, j.state.value, j.attempts, j.slices,
                      j.preemptions, j.error, j.checkpoint, j.not_before)
                     for j in jobs],
            "depth": q.depth(), "queued": len(q.queued_jobs())}


@pytest.mark.parametrize("name", ["coadmit", "missing_verdict",
                                  "raise_then_retry", "deadline_tombstones",
                                  "priorities_and_gates"])
def test_batch_queue_matches_jax(name):
    """run_batch / _pop_runnable / evict / queued_jobs: the same rounds,
    sleeps, job states and route.serve.* counters as JAX's queue."""
    out = {}
    for pkg, Q, O in (("jax", JQ, JOBS), ("port", TQ, TOBS)):
        O.set_metrics(O.MetricsRegistry())
        out[pkg] = (_batch_scenario(Q, name),
                    O.get_metrics().values("route.serve."))
    assert out["port"] == out["jax"]
    assert out["port"][0]["jobs"]


# ---- the request layout -------------------------------------------------

def test_split_request_index_map():
    """The port's fused request carries JAX's 33 positional arguments:
    the split puts the seven state tensors, the eleven terminal tables
    and the statics (K, L, rung_desc, topk) where route_window_planes_multi
    reads them."""
    f = synth_flow(num_luts=10, seed=1)
    r = TR.Router(f.rr, TR.RouterOpts(fused_dispatch=True, **OPTS),
                  device="cpu")
    gen = r.route_gen(f.term)
    req = next(gen)
    gen.close()
    a, kw = req.f_args, req.f_kwargs
    assert len(a) == 33
    state, dyn, static = TF._split_request(req)
    assert all(isinstance(t, torch.Tensor) for t in state)
    assert len(dyn[2]) == 11 and all(isinstance(t, torch.Tensor)
                                     for t in dyn[2])
    assert isinstance(dyn[3], tuple) and isinstance(dyn[4], tuple)
    assert all(isinstance(v, (int, float)) for v in dyn[6:12])
    assert static == (a[31], a[32], kw["rung_desc"], kw["topk"])
    assert isinstance(a[31], int) and isinstance(a[32], int)
    assert TF._mergeable(req)
    assert TF._shared_key(req) == (5, False, "f32")


# ---- the fused service -----------------------------------------------------

def _cli_terms():
    """The CLI schedule's terminal sets (serve/cli.py's small-heavy
    profile: jobs 0 and 2 a seeded net subset)."""
    flows = [synth_flow(num_luts=10, seed=1 + j) for j in range(3)]
    rng = random.Random(1)
    terms = []
    for j, f in enumerate(flows):
        frac = round(0.15 * rng.uniform(0.6, 1.4), 4)
        sub_seed = rng.randrange(1, 10_000)
        terms.append(subset_terminals(f.term, frac, seed=sub_seed)
                     if j % 2 != 1 else f.term)
    return flows[0].rr, terms


def _strip(line):
    line = json.loads(json.dumps(line))
    line.pop("wall_s")
    for j in line["jobs"]:
        for k in TIMED_JOB:
            j.pop(k)
    for k in TIMED_SERVE:
        line["serve"].pop(k, None)
        line["rebatch"]["counters"].pop(k, None)
    for e in line["rebatch"]["events"]:
        # the port's layout figures (serve/batcher.py: block_nets and the
        # occupancy carry the port's launch layout); the rungs' tiles and
        # plane shapes stay compared
        e.pop("lane_occupancy")
        sig = ast.literal_eval(e.pop("pack_signature"))
        e["pack_rungs"] = [r[:3] for r in sig]
    return line


def test_serve_fused_cli_matches_jax(jax_ref):
    """``serve --fused`` over the join/leave schedule: JAX's summary line
    but for seconds and the layout figure, JAX's occupancy and paths job
    for job, and each job its solo route."""
    line, arrays = jax_ref
    sink = {}
    orig = _capture_run(TS, sink)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = port_main(CLI + ["--device", "cpu"])
    finally:
        TS.RouteService.run = orig
    assert rc == 0
    port = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert _strip(port) == _strip(line)
    c = port["rebatch"]["counters"]
    assert c["route.serve.fused.dispatches"] > 0
    assert c["route.serve.fused.jobs"] > c["route.serve.fused.dispatches"]
    causes = [x["cause"] for e in port["rebatch"]["events"]
              for x in e["causes"]]
    assert "join" in causes and "finish" in causes
    rr, terms = _cli_terms()
    for j, term in zip(sink["jobs"], terms):
        res = j.result["result"]
        assert np.array_equal(res.occ, arrays[j.job_id + "/occ"])
        assert np.array_equal(res.paths, arrays[j.job_id + "/paths"])
        solo = TR.Router(rr, TR.RouterOpts(**OPTS), device="cpu").route(term)
        assert (res.wirelength, res.iterations) == (solo.wirelength,
                                                    solo.iterations)
        assert np.array_equal(res.paths, solo.paths)
        assert np.array_equal(res.occ, solo.occ)
        check_route(rr, term, res.paths, occ=res.occ)


def _fused_two(resil=None):
    """Two full 10-LUT jobs through RouteService(fused=True), slice 2;
    returns the jobs and the solo routes of their terminals."""
    flows = [synth_flow(num_luts=10, seed=s) for s in (1, 2)]
    rr = flows[0].rr
    solo = [TR.Router(rr, TR.RouterOpts(**OPTS), device="cpu").route(f.term)
            for f in flows]
    TOBS.set_metrics(TOBS.MetricsRegistry(enabled=True))
    svc = TS.RouteService(rr, TR.RouterOpts(**OPTS), slice_iters=2,
                          fused=True, resil=resil, device="cpu")
    for i, f in enumerate(flows):
        svc.admit(TS.ServeJobSpec(term=f.term, name=f"j{i}"),
                  tenant=f"t{i}")
    return svc.run(), solo


def _assert_solo(jobs, solo):
    for job, ref in zip(jobs, solo):
        assert job.state.value == "done", job.error
        res = job.result["result"]
        assert (res.wirelength, res.iterations) == (ref.wirelength,
                                                    ref.iterations)
        assert np.array_equal(res.paths, ref.paths)
        assert np.array_equal(res.occ, ref.occ)


def test_multi_dispatch_error_degrades_to_solo():
    """A ``dispatch.error`` plan firing at its first invocation hits the
    merged site of the first lockstep step: that step degrades to per-job
    solo dispatch (fused.fallbacks 1), and every job ends with its solo
    route."""
    plan = FaultPlan.parse(7, "dispatch.error:1:1")
    jobs, solo = _fused_two(ResilOpts(fault_plan=plan, backoff_s=0.0))
    _assert_solo(jobs, solo)
    v = TOBS.get_metrics().values("route.serve.fused.")
    assert v["route.serve.fused.fallbacks"] == 1
    assert v["route.serve.fused.dispatches"] > 0
    assert plan.summary()["fired"] == {"dispatch.error": [0]}


def test_multi_failure_after_first_member_restores_entries(monkeypatch):
    """A multi call that raises after it has relaxed its first member
    (whose paths, sink delays, reach flags, boxes and crit it wrote in
    place): the runner restores every member's window entry before the
    solo dispatch, so each job still ends with its solo route."""
    real = TP.route_window_planes_multi
    hit = {"n": 0}

    def flaky(pg, dev, states, dyns, job_statics=(), **kw):
        if hit["n"] == 0 and len(states) > 1:
            hit["n"] += 1
            real(pg, dev, states[:1], dyns[:1], job_statics[:1], **kw)
            raise RuntimeError("injected: multi call died after member 0")
        return real(pg, dev, states, dyns, job_statics, **kw)

    monkeypatch.setattr(TP, "route_window_planes_multi", flaky)
    jobs, solo = _fused_two()
    assert hit["n"] == 1
    _assert_solo(jobs, solo)
    v = TOBS.get_metrics().values("route.serve.fused.")
    assert v["route.serve.fused.fallbacks"] == 1
