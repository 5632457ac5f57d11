"""The port's route service, slice A14.1 (parallel_eda_tpu_torch/serve/,
obs/runstore.py), on the CPU, against the JAX package's serve/.

* the job queue step for step beside the JAX package's (fake clocks and
  runners): priorities, deadlines, retry backoff, preemption, aging,
  idempotent resubmission;
* the batcher: the same rungs, tiles and slots as JAX's, strict demux,
  the port's layout meaning of block_nets and lane occupancy, rebatch
  causes; a relaxation batch mixing two jobs' nets equals each job's
  solo batch net for net;
* the runstore: records with JAX's keys and deterministic values;
* ``python -m parallel_eda_tpu_torch serve`` against the JAX package's
  ``serve`` CLI on two 15-LUT / W=10 jobs (seeds 3 and 4, batch 32)
  sliced every 2 iterations under a five-site fault plan (dispatch.hang,
  dispatch.error, checkpoint.corrupt, corpus.torn, backend.loss): the
  same summary line but for its seconds, the same faults, recoveries,
  job-level ladder step and per-job QoR, and corpus rows with JAX's
  keys and values (the torn line skipped in both);
* the RouteService on the same jobs: two tenants with preemption, and a
  crash with a fresh-process resume from the CheckpointStore, each job
  equal to its solo route and to JAX's service job.

The jobs' grid (3x3) has no crop rung, so the port's resume rule for a
sliced route (ROADMAP.md C8: the window status's 8-tile live bb sizes)
and JAX's give the same route here; a sliced job is held to the port's
unsliced route, which is the port's rule.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from parallel_eda_tpu import obs as JOBS
from parallel_eda_tpu.__main__ import main as jax_main
from parallel_eda_tpu.route import router as JR
from parallel_eda_tpu.serve import batcher as JB
from parallel_eda_tpu.serve import queue as JQ
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.__main__ import main as port_main
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.obs import runstore as TRS
from parallel_eda_tpu_torch.resil import ResilOpts
from parallel_eda_tpu_torch.route import planes as TP
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route
from parallel_eda_tpu_torch.route.planes_kernels import kernel_layout
from parallel_eda_tpu_torch.serve import batcher as TB
from parallel_eda_tpu_torch.serve import queue as TQ
from parallel_eda_tpu_torch.serve.service import RouteService, ServeJobSpec

CHAOS = ("dispatch.hang:2:4,dispatch.error:1:4,checkpoint.corrupt:1:2,"
         "corpus.torn:1:2,backend.loss:1:3")
JOB_FLOWS = [dict(num_luts=15, chan_width=10, seed=s) for s in (3, 4)]
CLI = ["serve", "--jobs", "2", "--tenants", "2", "--luts", "15",
       "--chan_width", "10", "--seed0", "3", "--batch_size", "32",
       "--slice", "2", "--retries", "3", "--chaos", CHAOS,
       # the watchdog times the host call, which in the JAX package
       # includes XLA's compiles: a budget no compile reaches keeps the
       # comparison off the host's load (dispatch.hang is injected)
       "--watchdog_s", "3600"]
OPTS = dict(batch_size=32, sink_group=0)
# the summary's seconds, and the pack occupancy (the port's layout)
TIMED_JOB = ("route_s", "nets_per_s")
TIMED_SERVE = ("route.serve.warm_start_s", "route.serve.aggregate_nets_per_s",
               "route.serve.tenant.t0.nets_per_s",
               "route.serve.tenant.t1.nets_per_s",
               "route.serve.pack.lane_occupancy")


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
    TOBS.set_metrics(TOBS.MetricsRegistry())
    yield
    JOBS.set_metrics(jold)
    TOBS.set_metrics(told)


# ---- the job queue ----------------------------------------------------

def _queue_scenario(Q, name):
    """Run queue scenario ``name`` on module ``Q``; returns its
    transcript and the route.serve.* values of the registry."""
    now = [0.0]
    waits, ran = [], []

    def sleep(s):
        waits.append(s)
        now[0] += s

    def job(**kw):
        return Q.RouteJob(tenant=kw.pop("tenant", "t"), payload=None, **kw)

    q = Q.JobQueue(clock=lambda: now[0], sleep=sleep,
                   aging_rate=1.0 if name == "aging" else 0.0)
    if name == "priority":
        jobs = [q.admit(job(priority=p)) for p in (0, 5, 2)]
        q.run(lambda j: (ran.append(j.job_id), ("done", None))[1])
    elif name == "deadline":
        jobs = [q.admit(job(deadline_s=10.0)), q.admit(job(deadline_s=1.0))]

        def runner(j):
            ran.append(j.job_id)
            if j.preemptions == 0:
                now[0] += 2.0
                return "preempted", f"ck-{j.job_id}"
            return "done", None
        q.run(runner)
    elif name == "retry":
        jobs = [q.admit(job(max_retries=2, backoff_s=1.0, backoff_mult=10.0,
                            backoff_max_s=3.0))]

        def runner(j):
            ran.append(j.checkpoint)
            raise RuntimeError("device fell over")
        q.run(runner)
    elif name == "backoff_past_deadline":
        jobs = [q.admit(job(deadline_s=1.0, max_retries=5, backoff_s=64.0))]

        def runner(j):
            now[0] += 0.1
            raise RuntimeError("flaky backend")
        q.run(runner)
    elif name == "preemption":
        jobs = [q.admit(job()), q.admit(job(tenant="u"))]

        def runner(j):
            ran.append(j.job_id)
            if j.preemptions < 2:
                return "preempted", f"ck{len(ran)}"
            return "done", None
        q.run(runner)
    elif name == "aging":
        jobs = [q.admit(job(priority=0))]
        for _ in range(4):
            now[0] += 2.0
            jobs.append(q.admit(job(priority=5)))
        ran.append(q.effective_priority(jobs[0]))
        q.run(lambda j: (ran.append(j.job_id), ("done", None))[1])
    elif name == "idempotent":
        a = q.admit(job(job_id="jobA", priority=3))
        dup = q.admit(job(job_id="jobA", priority=0))
        ran.append((dup is a, dup.priority, q.depth()))
        q.run(lambda j: ("done", None))
        dup2 = q.admit(job(job_id="jobA"))
        ran.append((dup2 is a, q.depth()))
        jobs = [a]
    states = [(j.job_id, j.state.value, j.attempts, j.preemptions,
               j.slices, j.error, j.failure_reason) for j in jobs]
    return (states, ran, waits), None


@pytest.mark.parametrize("name", [
    "priority", "deadline", "retry", "backoff_past_deadline",
    "preemption", "aging", "idempotent"])
def test_queue_matches_jax_step_for_step(name):
    """Priority order, deadline timeout, capped retry backoff with its
    terminal reason, backoff past the deadline, round-robin preemption,
    aging against starvation and idempotent resubmission: the same run
    order, job states, reasons, sleeps and route.serve.* values as the
    JAX package's queue."""
    j = _queue_scenario(JQ, name)
    t = _queue_scenario(TQ, name)
    assert t == j
    jv = JOBS.get_metrics().values("route.serve.")
    tv = TOBS.get_metrics().values("route.serve.")
    assert tv == jv and tv


# ---- the batcher ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batcher_slots_and_demux_match_jax(seed):
    """pack_jobs on random spans: JAX's rungs, tiles, plane shapes and
    (job, net) slots; every net in exactly one slot, the demux the
    inverse; block_nets and lane occupancy the port's kernel layout (one
    net per thread block, cells over thread-slots); the pack gauges but
    the occupancy equal JAX's."""
    rng = np.random.default_rng(seed)
    job_nets = {
        "jobA": (rng.integers(4, 12, 9), rng.integers(4, 12, 9)),
        "jobB": (rng.integers(4, 30, 5), rng.integers(4, 30, 5)),
        "jobC": (rng.integers(2, 40, 7), rng.integers(2, 40, 7)),
    }
    shx, shy = (6, 20, 17), (6, 21, 16)
    jp = JB.pack_jobs(job_nets, shx, shy)
    tp = TB.pack_jobs(job_nets, shx, shy)
    assert [(r.tile, r.shape_x, r.shape_y, r.slots) for r in tp.rungs] == \
        [(r.tile, r.shape_x, r.shape_y, r.slots) for r in jp.rungs]
    assert tp.jobs == jp.jobs and tp.total_nets == jp.total_nets == 21
    seen = {}
    for ri, rung in enumerate(tp.rungs):
        lay = kernel_layout(shx, shy, rung.nets, 1, tile=rung.tile)
        assert rung.block_nets == 1 and rung.blocks == rung.nets
        assert rung.lane_occupancy == lay["lane_occupancy"]
        for slot, key in enumerate(rung.slots):
            assert key not in seen
            seen[key] = (ri, slot)
    for job, nw in job_nets.items():
        slots = tp.job_slots(job)
        assert sorted(idx for _, _, idx in slots) == list(range(len(nw[0])))
        assert all(seen[(job, idx)] == (ri, s) for ri, s, idx in slots)
    jv = JOBS.get_metrics().values("route.serve.pack.")
    tv = TOBS.get_metrics().values("route.serve.pack.")
    occ = "route.serve.pack.lane_occupancy"
    assert {k: v for k, v in tv.items() if k != occ} == \
        {k: v for k, v in jv.items() if k != occ}
    assert tv[occ] == tp.lane_occupancy


def test_batcher_rebatch_causes_match_jax():
    cases = [(None, {"a", "b"}), ({"a", "b"}, {"b", "c"}),
             ({"a", "b", "c"}, {"c"}), ({"x"}, {"y"})]
    for prev, cur in cases:
        kw = dict(is_done=lambda j: j == "a",
                  is_failover=lambda j: j == "y")
        assert TB.diff_packs(prev, cur, **kw) == JB.diff_packs(prev, cur,
                                                               **kw)
        assert TB.diff_packs(prev, cur) == JB.diff_packs(prev, cur)
    assert TB.REBATCH_CAUSES == JB.REBATCH_CAUSES


def test_batcher_cross_job_relax_parity():
    """A relaxation batch mixing two jobs' nets equals each job's solo
    batch, net for net: the kernels are per-net, so sharing a dispatch
    across jobs changes nothing (the plain version of K1 here; the card
    holds K1 to it bit for bit)."""
    from test_torch_planes import _graph, _instance, to_port

    rr, jpg = _graph("minimal", 4, 4)
    pg = to_port(jpg)
    args = [torch.from_numpy(a) for a in _instance(rr, jpg, 7, 11,
                                                   "exact")]
    shared = TP.planes_relax(pg, *args, 12)
    for sl in (slice(0, 3), slice(3, 7)):
        solo = TP.planes_relax(pg, *(a[sl] for a in args), 12)
        for k in range(3):
            assert torch.equal(shared[k][sl], solo[k]), k


# ---- the runstore -----------------------------------------------------

def test_runstore_records_match_jax(tmp_path):
    """make_record / append_run / the tolerant reader: the same record
    (keys and values) as the JAX package's for the same inputs, a torn
    line skipped with a count."""
    import parallel_eda_tpu.obs.runstore as JRS

    kw = dict(scenario="serve t/1", cfg={"a": 1, "b": [2, 3]},
              metric="nets_per_s", value=10.0, unit="nets/s",
              backend="cpu", device_kind="cpu", qor={"wirelength": 5},
              gauges={"route.serve.jobs_done": 1}, detail={"slices": 2},
              ts="2026-01-01T00:00:00Z", rev="abc1234", tenant="acme",
              job_id="job0001", n_shards=2, queue_wait_s=0.5)
    tr, jr = TRS.make_record(**kw), JRS.make_record(**kw)
    assert tr == jr and TRS.SCHEMA_VERSION == JRS.SCHEMA_VERSION == 2
    assert TRS.validate_record(tr) == []
    assert TRS.validate_record({"x": 1}) == JRS.validate_record({"x": 1})
    d = str(tmp_path)
    path = TRS.append_run(d, tr)
    assert path == TRS.run_path(d, "serve t/1")
    with open(path, "ab") as f:
        f.write(b'\x80\xfe{"torn": tr\n')
    TRS.append_run(d, tr)
    with pytest.warns(RuntimeWarning, match="skipped 1"):
        recs, skipped = TRS.read_runs_ex(d, "serve t/1")
    assert skipped == 1 and recs == [tr, tr]
    assert TRS.scenarios(d) == ["serve_t_1"]
    assert TRS.config_hash({"b": 1, "a": 2}) == JRS.config_hash(
        {"a": 2, "b": 1})


# ---- the serve CLI ----------------------------------------------------

def _cli_run(main, argv, d, mod, router_mod):
    """``main(argv)`` in directory ``d`` (checkpoints and corpus there),
    with a fresh registry of package ``mod`` and its dispatch-variant set
    emptied; returns (rc, summary, corpus records, skipped lines)."""
    saved = set(router_mod._DISPATCH_VARIANTS)
    router_mod._DISPATCH_VARIANTS.clear()
    old = mod.get_metrics()
    mod.set_metrics(mod.MetricsRegistry())
    os.makedirs(d, exist_ok=True)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv + ["--checkpoint_dir", os.path.join(d, "ck"),
                              "--runs_dir", os.path.join(d, "runs")])
    finally:
        mod.set_metrics(old)
        router_mod._DISPATCH_VARIANTS |= saved
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with pytest.warns(RuntimeWarning):
        recs, skipped = TRS.read_runs_ex(os.path.join(d, "runs"),
                                         summary["scenario"])
    return rc, summary, recs, skipped


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The JAX package's serve CLI and the port's (--device cpu) on the
    same jobs and fault plan."""
    d = tmp_path_factory.mktemp("serve_cli")
    jax = _cli_run(jax_main, list(CLI), str(d / "jax"), JOBS, JR)
    port = _cli_run(port_main, CLI + ["--device", "cpu"], str(d / "port"),
                    TOBS, TR)
    return jax, port


def _untimed(summary):
    s = json.loads(json.dumps(summary))
    s.pop("wall_s")
    for j in s["jobs"]:
        for k in TIMED_JOB:
            j.pop(k, None)
    for k in TIMED_SERVE:
        s["serve"].pop(k)
    return s


def test_serve_cli_line_matches_jax(clis):
    """The summary line of ``serve`` under the five-site plan: rc 0, the
    JAX CLI's line but for its seconds and the pack occupancy (the
    port's layout): every job done with JAX's wirelength and iterations,
    the same preemptions, slices, errors, dispatch variants, route.serve.*
    and route.resil.* values, ladder (pipeline stepped to sync by the
    poisoned dispatch) and fired faults (all five kinds)."""
    (jrc, js, _, _), (trc, ts, _, _) = clis
    assert trc == jrc == 0
    assert _untimed(ts) == _untimed(js)
    assert [j["state"] for j in ts["jobs"]] == ["done", "done"]
    assert ts["resil"]["faults"]["kinds_fired"] == 5
    assert ts["resil"]["ladder"]["pipeline"] == "sync"
    assert ts["serve"]["route.serve.jobs_retried"] == 2


def test_serve_cli_corpus_rows_match_jax(clis):
    """The corpus rows: one per job plus the injected torn line (skipped
    in both), JAX's keys, and JAX's values for every deterministic
    field; the gauges' names are JAX's."""
    (_, _, jrecs, jsk), (_, _, trecs, tsk) = clis
    assert tsk == jsk == 1 and len(trecs) == len(jrecs) == 2
    for t, j in zip(trecs, jrecs):
        assert set(t) == set(j)
        for k in ("schema_version", "git_rev", "scenario", "config_hash",
                  "backend", "device_kind", "metric", "unit", "qor",
                  "detail", "tenant", "job_id"):
            assert t[k] == j[k], k
        assert set(t["gauges"]) == set(j["gauges"])
        assert t["backend"] == "cpu"


# ---- the RouteService -------------------------------------------------

_SOLO: dict = {}


def _flows():
    return [synth_flow(**cfg) for cfg in JOB_FLOWS]


def _solo(i):
    """Job i routed alone by the port (resil=None), cached."""
    if i not in _SOLO:
        f = _flows()[i]
        _SOLO[i] = TR.Router(f.rr, TR.RouterOpts(**OPTS),
                             device="cpu").route(f.term)
    return _SOLO[i]


def _assert_job(job, i, jax_job):
    res = job.result["result"]
    solo = _solo(i)
    assert job.result["wirelength"] == solo.wirelength == \
        jax_job["wirelength"]
    assert job.result["iterations"] == solo.iterations == \
        jax_job["iterations"]
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(res, k), getattr(solo, k)), k


def test_service_two_tenants_preemption_parity(tmp_path, clis):
    """Two tenants' jobs through the queue, preempted every 2 iterations:
    each job equals its solo route and the JAX service's job, legal,
    with tenant-stamped corpus rows and route.serve.* telemetry."""
    flows = _flows()
    jax_jobs = clis[0][1]["jobs"]
    runs = str(tmp_path / "runs")
    svc = RouteService(flows[0].rr, TR.RouterOpts(**OPTS), slice_iters=2,
                       runs_dir=runs, scenario="serve_test",
                       cfg={"luts": 15}, device="cpu")
    for i, fl in enumerate(flows):
        svc.admit(ServeJobSpec(term=fl.term, name=f"s{i}"), tenant=f"t{i}")
    jobs = svc.run()
    assert [j.state.value for j in jobs] == ["done", "done"]
    assert all(j.preemptions > 0 for j in jobs)
    for i, (job, fl) in enumerate(zip(jobs, flows)):
        _assert_job(job, i, jax_jobs[i])
        check_route(fl.rr, fl.term, job.result["result"].paths,
                    occ=job.result["result"].occ)
    v = TOBS.get_metrics().values("route.serve.")
    assert v["route.serve.jobs_done"] == 2
    assert v["route.serve.tenant.t1.wirelength"] == _solo(1).wirelength
    recs = TRS.read_runs(runs, "serve_test")
    assert sorted(r["tenant"] for r in recs) == ["t0", "t1"]
    # continuous batching is ported (tests/test_torch_serve_fused.py
    # holds its routes): the fused service is built, drained of nothing
    fsvc = RouteService(flows[0].rr, TR.RouterOpts(**OPTS), fused=True,
                        device="cpu")
    assert fsvc.run() == [] and fsvc.rebatch_summary()["fused"]


def test_crash_and_fresh_process_resume_parity(tmp_path, clis):
    """One slice, then a "crash" (the service abandoned); a fresh service
    (new registry, same checkpoint dir) resumes the same job id from the
    CheckpointStore and finishes with the solo route and the JAX
    service's job; the checkpoint is dropped after success."""
    f = _flows()[0]

    def service():
        return RouteService(f.rr, TR.RouterOpts(**OPTS), slice_iters=2,
                            resil=ResilOpts(
                                checkpoint_dir=str(tmp_path / "ck")),
                            device="cpu")

    svc1 = service()
    svc1.admit(ServeJobSpec(term=f.term, name="s0"), job_id="jobA")
    svc1.queue.run(svc1._runner, max_slices=1)
    ck_file = svc1.resil.store._path("jobA")
    assert os.path.exists(ck_file)
    TOBS.set_metrics(TOBS.MetricsRegistry())
    svc2 = service()
    j = svc2.admit(ServeJobSpec(term=f.term, name="s0"), job_id="jobA")
    svc2.run()
    assert j.state.value == "done"
    _assert_job(j, 0, clis[0][1]["jobs"][0])
    assert TOBS.get_metrics().values("route.resil.")[
        "route.resil.checkpoint_recoveries"] >= 1
    assert not os.path.exists(ck_file)


@pytest.mark.parametrize("flag,item", [
    ("--library", "A14.3"), ("--export_library", "A14.3"),
    ("--compile_cache_dir", "A14.3"), ("--fused", "A14.2")])
def test_serve_cli_refuses_unported_flags(flag, item, tmp_path):
    """The flags the port once refused (the program library, A14.3, and
    continuous batching, A14.2) now run: each one on a small job, with
    its effect in the summary line (tests/test_torch_library.py and
    tests/test_torch_serve_fused.py hold them against JAX)."""
    from parallel_eda_tpu_torch.route import cuda_lib

    lib, cache = str(tmp_path / "L"), str(tmp_path / "C")
    extra = {"--library": ["--library", lib],
             "--export_library": ["--library", lib, "--export_library"],
             "--compile_cache_dir": ["--compile_cache_dir", cache],
             "--fused": ["--fused"]}[flag]
    saved = cuda_lib.cache_dir()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = port_main(["serve", "--device", "cpu", "--jobs", "2",
                            "--luts", "6", "--slice", "2", *extra])
        cached = cuda_lib.cache_dir()
    finally:
        cuda_lib.set_cache_dir(saved)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and [j["state"] for j in line["jobs"]] == ["done"] * 2
    if flag == "--library":
        assert line["serve"]["route.serve.library_stale"] == 1
        assert line["serve"]["route.serve.jit_fallbacks"] > 0
        assert line["library_exported"] == 0
    elif flag == "--export_library":
        # (the process's earlier cases may have seen these variants, so
        # the dispatch counts are not read here)
        assert line["library_exported"] == line["serve"][
            "route.serve.library_variants"] > 0
        assert os.path.exists(os.path.join(lib, "library.json"))
    elif flag == "--compile_cache_dir":
        assert cached == cache
    else:
        assert line["rebatch"]["fused"] and line["rebatch"]["rounds"] > 0
        assert line["rebatch"]["counters"][
            "route.serve.fused.dispatches"] > 0
