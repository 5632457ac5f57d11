"""The port's route-worker fleet (parallel_eda_tpu_torch/serve/fleet.py,
serve/transport.py and ``python -m parallel_eda_tpu_torch daemon
fleet``) against the JAX package's, on the CPU.

* transport, in process: both packages' InboxHTTPServer on an ephemeral
  port with their own TransportClient — the durable roundtrip, torn
  requests writing nothing, a seeded ``transport.drop`` and the
  client's idempotent retry, the bounded backoff when every attempt
  drops, job-id sanitising, and the /metrics and /status scrapes.  The
  cases mirror JAX tests/test_fleet.py and tests/test_fleet_trace.py;
  everything each package's client, server, inbox and metrics show
  must be equal (URLs, paths and wall stamps aside).
* fleet functions and scenarios, in process: ``split_chaos``, the
  supervisor's worker command and its summary over the same worker
  summaries, telemetry, leases and trace shards; and the fleet loop of
  JAX tests/test_fleet.py — partition exactly once, failover that
  steals an expired lease and fences the owner, foreign-grace takeover,
  ``lease.steal`` — on both packages' RouteDaemons over a fake service
  with the same injected clocks: equal summaries, journals, telemetry,
  leases and metrics.
* one two-worker fleet in subprocesses: ``daemon fleet --device cpu``
  over two 6-LUT jobs submitted through the TransportClient under
  ``transport.drop:1,worker.kill:1``.  Each job is released exactly
  once, with the wirelength and iterations of the JAX package's solo
  daemon over the same jobs (this file run as a script, the module's
  one JAX reference subprocess); the failed-over job resumed from the
  durable checkpoints, held to the port's rule that a sliced route
  equals the unsliced one (ROADMAP.md C8); JAX's tools/flow_doctor.py
  --fleet-summary signs off.  A fleet asked for the card where there is
  none reports its worker dead and exits non-zero.
"""

import json
import os
import re
import subprocess
import sys
import time
import types
from urllib import error as urlerror
from urllib import request as urlrequest

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_DOCTOR = os.path.join(REPO, "tools", "flow_doctor.py")
LUTS = 6
# (job id, tenant, seed); one tenant each, so that neither worker's
# fair-share admission turns a job away
JOBS = (("fjA", "t0", 3), ("fjB", "t1", 4))
RUN = ["--luts", str(LUTS), "--slice", "2", "--heartbeat_s", "2.0",
       "--exit_when_idle", "2"]


def _spec(seed):
    return {"luts": LUTS, "chan_width": 16, "seed": seed,
            "name": f"l{LUTS}_s{seed}"}


def _jax_reference(out_dir):
    """Script mode: the JAX package's solo daemon over JOBS."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.obs import MetricsRegistry, set_metrics
    from parallel_eda_tpu.serve.daemon import submit_job
    from parallel_eda_tpu.serve.daemon_cli import main

    box = os.path.join(out_dir, "solo")
    os.makedirs(box)
    for jid, tenant, seed in JOBS:
        submit_job(box, _spec(seed), tenant=tenant, job_id=jid)
    set_metrics(MetricsRegistry())
    main(["run", "--inbox", box, *RUN,
          "--summary", os.path.join(box, "summary.json")])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
    sys.exit(0)


from parallel_eda_tpu import obs as JOBS_OBS  # noqa: E402
from parallel_eda_tpu.resil import faults as JF  # noqa: E402
from parallel_eda_tpu.resil import journal as JJ  # noqa: E402
from parallel_eda_tpu.serve import daemon as JD  # noqa: E402
from parallel_eda_tpu.serve import fleet as JFL  # noqa: E402
from parallel_eda_tpu.serve import queue as JQ  # noqa: E402
from parallel_eda_tpu.serve import transport as JT  # noqa: E402
from parallel_eda_tpu_torch import obs as TOBS  # noqa: E402
from parallel_eda_tpu_torch.resil import faults as TF  # noqa: E402
from parallel_eda_tpu_torch.resil import journal as TJ  # noqa: E402
from parallel_eda_tpu_torch.serve import daemon as TD  # noqa: E402
from parallel_eda_tpu_torch.serve import fleet as TFL  # noqa: E402
from parallel_eda_tpu_torch.serve import queue as TQ  # noqa: E402
from parallel_eda_tpu_torch.serve import transport as TT  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(D=JD, Q=JQ, O=JOBS_OBS, F=JF, J=JJ,
                                 FL=JFL, T=JT),
    "port": types.SimpleNamespace(D=TD, Q=TQ, O=TOBS, F=TF, J=TJ,
                                  FL=TFL, T=TT),
}
ROSTER = ("w0", "w1")


@pytest.fixture(autouse=True)
def _fresh_registries():
    jold, told = JOBS_OBS.get_metrics(), TOBS.get_metrics()
    JOBS_OBS.set_metrics(JOBS_OBS.MetricsRegistry())
    TOBS.set_metrics(TOBS.MetricsRegistry())
    yield
    JOBS_OBS.set_metrics(jold)
    TOBS.set_metrics(told)


_PROC = {}


@pytest.fixture(scope="module", autouse=True)
def _start_jax_reference(tmp_path_factory):
    """Start the module's one JAX reference subprocess at once, so that
    it runs beside the in-process cases."""
    out = str(tmp_path_factory.mktemp("jax_fleet"))
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
    p = _PROC["p"]
    rc = p.wait(timeout=900)
    out = _PROC["out"]
    assert rc == 0, open(os.path.join(out, "log.txt")).read()[-4000:]
    with open(os.path.join(out, "solo", "summary.json")) as f:
        return json.load(f)


def _norm(doc, *paths):
    """``doc`` through JSON with every path in ``paths`` made a tag."""
    s = json.dumps(doc, default=str, sort_keys=True)
    for i, p in enumerate(paths):
        s = s.replace(p, f"<p{i}>")
    return json.loads(s)


# ---- transport (in-thread server, ephemeral port) -----------------------

def _submit_lines(P, box):
    path = os.path.join(box, P.D.SUBMIT_NAME)
    if not os.path.exists(path):
        return None
    out = []
    for s in P.D.InboxReader(path).poll():
        s = dict(s)
        with open(os.path.join(box, s["spec"])) as f:
            s["spec_doc"] = json.load(f)
        # wall and monotonic stamps of the submission
        for k in ("ts", "mono"):
            s.pop(k, None)
        if isinstance(s.get("trace"), dict):
            s["trace"] = {k: v for k, v in s["trace"].items()
                          if k != "submit_wall"}
        out.append(s)
    return out


def _serve(P, box, plan=None):
    return P.T.InboxHTTPServer(box, port=0, plan=plan).start()


def _tr_roundtrip(P, box):
    srv = _serve(P, box)
    try:
        cl = P.T.TransportClient(srv.url, max_attempts=2)
        jid = cl.submit({"luts": 4, "seed": 1, "name": "a"},
                        tenant="t0", priority=2, job_id="job-1")
        return [jid, cl.healthz()["ok"], cl.retries, srv.summary(),
                _submit_lines(P, box)]
    finally:
        srv.stop()


def _tr_torn(P, box):
    srv = _serve(P, box)
    out = []
    try:
        for body in (b'{"spec": {"luts"', b'{"tenant": "t0"}'):
            req = urlrequest.Request(srv.url + "/submit", data=body,
                                     method="POST")
            try:
                urlrequest.urlopen(req, timeout=5)
                out.append("accepted")
            except urlerror.HTTPError as e:
                out.append([e.code, json.loads(e.read().decode())])
        spec_dir = os.path.join(box, "specs")
        out += [srv.summary(), _submit_lines(P, box),
                sorted(os.listdir(spec_dir)) if os.path.isdir(spec_dir)
                else None]
        return out
    finally:
        srv.stop()


def _tr_drop_retry(P, box):
    # horizon 1: invocation 0 (the first request) always drops
    plan = P.F.FaultPlan.parse(7, "transport.drop:1:1")
    srv = _serve(P, box, plan=plan)
    sleeps = []
    try:
        cl = P.T.TransportClient(srv.url, max_attempts=3, backoff_s=0.01,
                                 sleep=sleeps.append)
        jid = cl.submit({"luts": 4, "seed": 2, "name": "b"},
                        job_id="job-2")
        return [jid, cl.retries, sleeps, srv.summary(), plan.summary(),
                _submit_lines(P, box)]
    finally:
        srv.stop()


def _tr_exhaustion(P, box):
    plan = P.F.FaultPlan.parse(7, "transport.drop:4:4")   # drop all
    srv = _serve(P, box, plan=plan)
    sleeps = []
    try:
        cl = P.T.TransportClient(srv.url, max_attempts=3, backoff_s=0.05,
                                 backoff_mult=4.0, backoff_max_s=0.1,
                                 sleep=sleeps.append)
        try:
            cl.submit({"luts": 4, "seed": 3}, job_id="job-3")
            err = None
        except P.T.TransportError as e:
            err = str(e).split(" (last:")[0]
        return [err, sleeps, cl.retries, srv.summary(),
                _submit_lines(P, box)]
    finally:
        srv.stop()


def _tr_sanitize(P, box):
    srv = _serve(P, box)
    try:
        cl = P.T.TransportClient(srv.url, max_attempts=1)
        out = [cl.submit({"luts": 4, "seed": 4}, job_id="we ird/id"),
               cl.submit({"luts": 4, "seed": 5, "name": "n/x"},
                         tenant="a b")]
        return out + [_submit_lines(P, box)]
    finally:
        srv.stop()


def _tr_scrape(P, box):
    os.makedirs(box)
    with open(os.path.join(box, P.D.telemetry_name("w0")), "w") as f:
        json.dump({"schema": 1, "cycle": 3, "queue_depth": 1,
                   "in_flight": {"job_id": "a", "slice": 2},
                   "held_leases": ["a"], "draining": False}, f)
    with open(os.path.join(box, P.D.telemetry_name("w1")), "w") as f:
        f.write('{"torn": tru')
    with open(os.path.join(box, P.D.telemetry_name("w2")) + ".tmp",
              "w") as f:
        f.write("{}")
    srv = _serve(P, box)
    try:
        docs = []
        for path in ("/metrics", "/status", "/healthz"):
            with urlrequest.urlopen(srv.url + path, timeout=5) as r:
                docs.append(json.loads(r.read().decode("utf-8")))
        docs[0].pop("ts")
        try:
            urlrequest.urlopen(srv.url + "/nowhere", timeout=5)
        except urlerror.HTTPError as e:
            docs.append(e.code)
        return docs
    finally:
        srv.stop()


TRANSPORT = {"roundtrip": _tr_roundtrip, "torn_request": _tr_torn,
             "drop_then_retry": _tr_drop_retry,
             "exhaustion_bounded_backoff": _tr_exhaustion,
             "job_id_sanitized": _tr_sanitize, "scrape": _tr_scrape}
# what JAX tests/test_fleet.py asserts of each case, held on the port's
EXPECT = {
    "roundtrip": lambda o: o[0] == "job-1" and o[3]["requests"] == 1
    and o[3]["retry_cap_seen"] == 2 and len(o[4]) == 1,
    "torn_request": lambda o: [o[0][0], o[1][0]] == [400, 400]
    and o[3] is None,
    "drop_then_retry": lambda o: o[1] == 1 and o[2] == [0.01]
    and o[3]["drops"] == 1 and o[3]["retries"] == 1
    and [s["job_id"] for s in o[5]] == ["job-2"],
    "exhaustion_bounded_backoff": lambda o: o[0] is not None
    and o[1] == [0.05, 0.1] and o[2] == 2 and o[3]["drops"] == 3
    and o[4] is None,
    "job_id_sanitized": lambda o: o[:2] == ["we_ird_id", "a_b-n_x"],
    "scrape": lambda o: list(o[0]["workers"]) == ["w0"]
    and o[1]["workers"]["w0"]["in_flight"]["job_id"] == "a"
    and o[3] == 404,
}


@pytest.mark.parametrize("name", sorted(TRANSPORT))
def test_transport_matches_jax(name, tmp_path):
    """Each transport case on both packages' server and client: equal
    replies, counters, client retries and backoff sleeps, inbox lines
    and specs, fault plans and route.fleet.* metrics."""
    outs = {}
    for pkg, P in PKGS.items():
        box = str(tmp_path / pkg / "box")
        text = json.dumps(TRANSPORT[name](P, box), default=str)
        out = json.loads(re.sub(r"http://127\.0\.0\.1:\d+", "<url>",
                                text.replace(box, "<box>")))
        outs[pkg] = (out, P.O.get_metrics().values("route."))
    assert outs["port"] == outs["jax"]
    assert EXPECT[name](outs["port"][0]), outs["port"][0]


# ---- fleet functions ------------------------------------------------------

def test_split_chaos_matches_jax():
    specs = ["worker.kill:1,lease.steal:2,transport.drop:3:9", "",
             " worker.kill:2 , dispatch.error:1:4,,transport.drop:1",
             "lease.steal:1:1", "checkpoint.corrupt:1:3,worker.kill:1:2"]
    for s in specs:
        assert TFL.split_chaos(s) == JFL.split_chaos(s), s
    assert TFL.split_chaos(specs[0]) == ("worker.kill:1,transport.drop:3:9",
                                         "lease.steal:2")
    assert TFL.SUPERVISOR_SITES == JFL.SUPERVISOR_SITES


def test_worker_command_matches_jax(tmp_path):
    """The port's worker command is JAX's with the port's module and its
    --device; every flag the options map to is JAX's."""
    kw = dict(n_workers=3, luts=7, chan_width=12, slice_iters=3,
              library_dir="L", cache_base="C", runs_dir="R",
              scenario="sc", sync=True, fused=True, exit_when_idle=4,
              max_queue_depth=10, chaos_seed=5,
              chaos="worker.kill:1,lease.steal:1", trace=True,
              objectives_path="obj.json", extra_worker_args=["--x"])
    box = str(tmp_path)
    j = JFL.FleetSupervisor(box, JFL.FleetOpts(**kw))
    for dev in ("cuda", "cpu"):
        t = TFL.FleetSupervisor(box, TFL.FleetOpts(device=dev, **kw))
        for w in ("w0", "w2"):
            jc, tc = j._worker_cmd(w), t._worker_cmd(w)
            assert jc[1:3] == ["-m", "parallel_eda_tpu"]
            i = tc.index("--device")
            assert tc[i + 1] == dev
            want = jc[:2] + ["parallel_eda_tpu_torch"] + jc[3:]
            assert tc[:i] + tc[i + 2:] == want
            assert tc[tc.index("--compile_cache_dir") + 1] == \
                os.path.join("C", w)
    assert TFL.FleetOpts().device == "cuda"


# ---- the fleet loop over a fake service (shared injected clock) ----------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _TickClock(_Clock):
    """Every read advances a hair, like a real monotonic clock."""

    def __call__(self):
        self.t += 1e-4
        return self.t


class _FakeFlow:
    def __init__(self, nets):
        self.term = types.SimpleNamespace(source=list(range(nets)))


class _FakeService:
    """RouteService's daemon-facing surface over package P's JobQueue."""

    def __init__(self, P, clock, runner=None):
        self.Q = P.Q
        self.queue = P.Q.JobQueue(clock=clock, sleep=lambda s: None)
        self.draining = False
        self.runs_dir = None
        self.scenario = "fleet-fake"
        self.router = types.SimpleNamespace(_library=None)
        self.resil = None
        self.diag_extra = None
        self.flight = None
        self.runner = runner or (
            lambda job: ("done", {"wirelength": 7, "iterations": 2,
                                  "nets": len(job.payload.term.source)}))

    def begin_drain(self):
        self.draining = True

    def admit(self, spec, tenant="default", priority=0,
              deadline_s=None, max_retries=0, job_id=""):
        if self.draining:
            raise RuntimeError("service is draining")
        job = self.Q.RouteJob(tenant=tenant, payload=spec, job_id=job_id,
                              priority=priority, deadline_s=deadline_s,
                              max_retries=max_retries)
        return self.queue.admit(job)

    def _runner(self, job):
        return self.runner(job)


def _mk_worker(P, box, worker, clock, runner=None, **opts_kw):
    opts_kw.setdefault("lease_ttl_s", 5.0)
    opts_kw.setdefault("foreign_grace_s", 3.0)
    svc = _FakeService(P, clock, runner=runner)
    d = P.D.RouteDaemon(
        svc, box,
        P.D.DaemonOpts(default_nets_per_s=10.0, cold_start_factor=1.0,
                       worker=worker, workers=ROSTER, **opts_kw),
        flow_builder=lambda spec: _FakeFlow(int(spec.get("nets", 10))),
        clock=clock, wall=lambda: 1000.0 + clock.t,
        sleep=lambda s: setattr(clock, "t", clock.t + s))
    return d, svc


def _ids_for(P, worker, n=1):
    out, i = [], 0
    while len(out) < n:
        jid = f"fj{i}"
        if P.D.preferred_worker(jid, list(ROSTER)) == worker:
            out.append(jid)
        i += 1
    return out[0] if n == 1 else out


def _submit_fake(P, box, job_id, nets=10):
    return P.D.submit_job(box, {"nets": nets, "name": job_id},
                          job_id=job_id, ts=999.0)


def _fleet_state(P, box, daemons):
    """Every worker's summary, journal, telemetry and heartbeat (its pid
    aside), the lease table, and the jobs' states per worker."""
    out = {}
    for d in daemons:
        w = d.worker
        doc = {"summary": d.summary(), "journal": d.journal.load(),
               "queue": sorted((j.job_id, j.state.value)
                               for j in d.service.queue.jobs)}
        if doc["journal"] is not None:
            doc["journal"].pop("ts")
        for name in (P.D.telemetry_name(w), P.D.heartbeat_name(w)):
            p = os.path.join(box, name)
            if os.path.exists(p):
                with open(p) as f:
                    doc[name] = json.load(f)
                doc[name].pop("pid", None)
        out[w] = doc
    out["leases"] = daemons[0].lease.scan()
    return _norm(out, box)


def _sc_partition(P, box):
    clock = _Clock()
    d0, s0 = _mk_worker(P, box, "w0", clock)
    d1, s1 = _mk_worker(P, box, "w1", clock)
    j0, j1 = _ids_for(P, "w0"), _ids_for(P, "w1")
    _submit_fake(P, box, j0)
    _submit_fake(P, box, j1)
    for _ in range(2):
        d0.cycle()
        d1.cycle()
    assert [j.job_id for j in s0.queue.jobs
            if j.state is P.Q.JobState.DONE] == [j0]
    assert [j.job_id for j in s1.queue.jobs
            if j.state is P.Q.JobState.DONE] == [j1]
    return [j0, j1, d0.service.diag_extra(), _fleet_state(P, box, [d0, d1])]


def _sc_failover(P, box):
    clock = _Clock()
    # w0 never finishes its slice (always preempted): the in-flight job
    # holds a lease that goes stale the moment w0 stops cycling
    d0, s0 = _mk_worker(P, box, "w0", clock,
                        runner=lambda job: ("preempted", None))
    d1, s1 = _mk_worker(P, box, "w1", clock)
    j0 = _ids_for(P, "w0")
    _submit_fake(P, box, j0)
    d0.cycle()
    d1.cycle()
    out = [sorted(d1._foreign), s1.queue.get(j0) is None]
    clock.t += 6.0
    d1.cycle()
    out += [d1.failed_over_ids, s1.queue.get(j0).state.value]
    # the zombie owner is fenced at its next sweep
    out += [d0._lease_sweep(), s0.queue.get(j0).state.value,
            d0.shed_causes.get(j0)]
    assert out[3] == "done" and out[5] == "shed"
    return out + [_fleet_state(P, box, [d0, d1])]


def _sc_foreign_grace(P, box):
    clock = _Clock()
    d1, s1 = _mk_worker(P, box, "w1", clock, foreign_grace_s=3.0)
    j0 = _ids_for(P, "w0")            # assigned to a worker that
    _submit_fake(P, box, j0)          # never comes up
    d1.cycle()
    out = [sorted(d1._foreign), s1.queue.get(j0) is None]
    clock.t += 3.1
    d1.cycle()
    out += [s1.queue.get(j0).state.value, d1.lease.read(j0)["released"]]
    assert out[2] == "done"
    return out + [_fleet_state(P, box, [d1])]


def _sc_lease_steal(P, box):
    clock = _TickClock()
    d0, s0 = _mk_worker(P, box, "w0", clock)
    s0.resil = types.SimpleNamespace(
        plan=P.F.FaultPlan.parse(3, "lease.steal:1:1"))
    j0 = _ids_for(P, "w0")
    _submit_fake(P, box, j0)
    d0.cycle()
    out = [s0.resil.plan.fired_sites(), s0.queue.get(j0).state.value,
           d0.lease.read(j0)["generation"]]
    assert out == [["lease.steal"], "done", 2]
    return out + [_fleet_state(P, box, [d0])]


SCENARIOS = {"partition_exactly_once": _sc_partition,
             "failover_steal_and_fence": _sc_failover,
             "foreign_grace_takeover": _sc_foreign_grace,
             "chaos_lease_steal": _sc_lease_steal}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenario_matches_jax(name, tmp_path):
    """Each fleet-loop scenario of JAX tests/test_fleet.py on both
    packages' daemons: equal outcomes, summaries, journals, telemetry,
    heartbeats, leases and metrics."""
    outs = {}
    for pkg, P in PKGS.items():
        box = str(tmp_path / pkg / "box")
        outs[pkg] = (SCENARIOS[name](P, box),
                     P.O.get_metrics().values("route."))
    assert outs["port"] == outs["jax"]


def _shard(path, worker, origin, job_id):
    """A worker's trace shard: two clock-sync beacons and one slice span
    (the form tools/trace_merge.py aligns)."""
    def beacon(ts_us, wall):
        return {"name": "route.trace.beacon", "ph": "i", "cat": "trace",
                "s": "t", "ts": ts_us, "pid": 1, "tid": 1,
                "args": {"wall": wall, "perf": ts_us / 1e6}}
    evs = [beacon(0.0, origin), beacon(2e6, origin + 2.0),
           {"name": "route.trace.slice", "ph": "X", "cat": "lifecycle",
            "ts": 5e5, "dur": 1000.0, "pid": 1, "tid": 1,
            "args": {"job_id": job_id, "slice": 1, "worker": worker}}]
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "worker": worker,
                   "displayTimeUnit": "ms"}, f)


@pytest.mark.parametrize("trace", [False, True])
def test_fleet_summary_matches_jax(trace, tmp_path):
    """The supervisor's summary over the same worker artifacts — the
    partition scenario's two workers' summaries (as ``daemon run
    --summary`` writes them), telemetry, SLO sections and leases, a
    worker killed, and (with ``trace``) two trace shards merged: the
    port's equals JAX's, paths aside, and JAX's flow_doctor
    --fleet-summary reads it as JAX's."""
    outs, docs = {}, {}
    for pkg, P in PKGS.items():
        box = str(tmp_path / pkg / "box")
        _sc_partition(P, box)
        # the daemons wrote telemetry and leases; write their summaries
        # as the workers' CLI does at exit
        clock = _Clock()
        for w in ROSTER:
            d, _ = _mk_worker(P, box, w, clock)
            with open(os.path.join(box, f"summary.{w}.json"), "w") as f:
                json.dump(d.summary(), f, default=str)
        if trace:
            for k, (w, origin) in enumerate(((ROSTER[0], 5000.0),
                                             (ROSTER[1], 5000.25))):
                _shard(os.path.join(box, f"trace.{w}.json"), w, origin,
                       f"fj{k}")
        sup = P.FL.FleetSupervisor(box, P.FL.FleetOpts(
            chaos="worker.kill:1,lease.steal:2,transport.drop:3:9",
            transport=False, expect_jobs=2, trace=trace))
        sup.killed = ["w0"]
        sup.exit_codes = {"w0": -9, "w1": 0}
        doc = sup.summary(serve_wall_s=2.0)
        docs[pkg] = doc
        outs[pkg] = (_norm(doc, box), P.O.get_metrics().values("route."))
    assert outs["port"] == outs["jax"]
    if trace:
        assert outs["port"][0]["fleet"]["trace"]["events"] > 0
    d = _doctor()
    for pkg, doc in docs.items():
        errs, notes = d.check_fleet(doc)
        docs[pkg] = (errs, notes)
    assert docs["port"][0] == docs["jax"][0]


def _doctor():
    import importlib.util

    spec = importlib.util.spec_from_file_location("flow_doctor",
                                                  FLOW_DOCTOR)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the fleet in subprocesses ---------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _jobs(doc):
    return {j["job_id"]: (j["state"], j.get("wirelength"),
                          j.get("iterations")) for j in doc["jobs"]}


def test_fleet_worker_kill_matches_jax_solo(tmp_path, request):
    """``daemon fleet --workers 2 --device cpu`` over two 6-LUT jobs
    submitted through the transport under ``transport.drop:1,
    worker.kill:1``: the supervisor SIGKILLs a worker that holds a live
    lease on a job with a durable checkpoint, the survivor steals the
    lease and finishes the job from the checkpoint.  Every job is done
    once and released once, with the JAX solo daemon's wirelength and
    iterations; the transport shows the plan's one drop and its retry;
    flow_doctor --fleet-summary signs off."""
    box = str(tmp_path / "box")
    summary = os.path.join(str(tmp_path), "fleet.json")
    cmd = [sys.executable, "-m", "parallel_eda_tpu_torch", "daemon",
           "fleet", "--inbox", box, "--workers", "2", "--luts", str(LUTS),
           "--slice", "2", "--device", "cpu", "--heartbeat_s", "2.0",
           "--lease_ttl_s", "8.0", "--foreign_grace_s", "1.0",
           "--tick_s", "0.05", "--expect_jobs", str(len(JOBS)),
           "--chaos", "transport.drop:1,worker.kill:1", "--timeout_s",
           "300", "--summary", summary]
    p = subprocess.Popen(cmd, cwd=REPO, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        url_doc = os.path.join(box, "transport.json")
        deadline = time.time() + 120
        while not os.path.exists(url_doc):
            assert p.poll() is None, p.communicate()[1][-3000:]
            assert time.time() < deadline, "no transport.json"
            time.sleep(0.05)
        with open(url_doc) as f:
            url = json.load(f)["url"]
        cl = TT.TransportClient(url, max_attempts=4, backoff_s=0.05)
        for jid, tenant, seed in JOBS:
            assert cl.submit(_spec(seed), tenant=tenant, job_id=jid) == jid
        out, err = p.communicate(timeout=400)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    with open(summary) as f:
        doc = json.load(f)
    assert json.loads(out.strip().splitlines()[-1]) == doc
    # the JAX reference ran beside the fleet; wait for it only now
    jax_ref = request.getfixturevalue("jax_ref")
    fl = doc["fleet"]
    rows = [j for j in doc["jobs"] if j["state"] == "done"]
    assert sorted(j["job_id"] for j in rows) == sorted(j for j, _, _ in JOBS)
    assert _jobs({"jobs": rows}) == _jobs(jax_ref)
    assert all(s == "done" for s, _, _ in _jobs(jax_ref).values())
    assert sorted(fl["leases"]) == sorted(j for j, _, _ in JOBS)
    assert all(v["released"] for v in fl["leases"].values())
    m = fl["metrics"]
    assert m["route.fleet.workers_killed"] == 1 and len(fl["killed"]) == 1
    assert m["route.fleet.jobs_failed_over"] >= 1
    assert m["route.fleet.lease_steals"] >= 1
    assert any(j.get("failed_over") for j in rows)
    assert fl["transport"]["drops"] == 1 and fl["transport"]["retries"] == 1
    assert fl["faults"]["fired"]["transport.drop"] and \
        fl["faults"]["fired"]["worker.kill"]
    victim = fl["killed"][0]
    assert fl["workers"][victim]["exit_code"] == -9
    assert cl.retries == 1
    r = subprocess.run([sys.executable, FLOW_DOCTOR, "--fleet-summary",
                        summary], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_without_card_reports_dead_worker(tmp_path):
    """A fleet asked for the card (the default) where there is none: its
    worker exits non-zero at start-up, the supervisor reports it dead
    without respawning it anywhere, and the fleet exits non-zero."""
    import torch

    if torch.cuda.is_available():
        return
    box = str(tmp_path / "box")
    r = subprocess.run(
        [sys.executable, "-m", "parallel_eda_tpu_torch", "daemon", "fleet",
         "--inbox", box, "--workers", "1", "--no_transport", "--tick_s",
         "0.05", "--timeout_s", "120"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=180)
    assert r.returncode != 0
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    w0 = doc["fleet"]["workers"]["w0"]
    assert w0["exit_code"] not in (0, None) and not w0["killed"]
    assert not w0["wrote_summary"] and doc["fleet"]["killed"] == []
    assert doc["fleet"]["metrics"]["route.fleet.workers_spawned"] == 1
    with open(os.path.join(box, "worker.w0.log")) as f:
        assert "CUDA" in f.read()
