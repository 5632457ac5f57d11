"""The port's route daemon (parallel_eda_tpu_torch/serve/daemon.py and
``python -m parallel_eda_tpu_torch daemon``) against the JAX package's,
on the CPU.

* host logic in process: every scenario of the daemon loop (the inbox
  reader's torn-line tolerance, admission verdicts, fair-share and
  doomed-deadline shedding, drain, journal recovery and dedupe, the
  single-worker lease sweep and the ``lease.steal`` site, SLO
  publishing) runs on both packages' RouteDaemon over a fake service
  (each package's own JobQueue, a fake runner) with the same injected
  clocks and the same submissions; the summaries, journals, telemetry,
  rejected.jsonl lines and metrics must be equal (exact, paths aside).
  The scenarios mirror JAX tests/test_daemon.py and tests/test_slo.py.
* routes, in subprocesses: ONE JAX reference subprocess per module (this
  file run as a script) runs the JAX daemon on two 6-LUT jobs (seeds 3
  and 4, slice 2) uninterrupted, and once more for two one-slice
  cycles, leaving a journal and durable checkpoints in flight.  The port's
  daemon (``daemon run --device cpu``) must give JAX's summary (job
  states, wirelengths, iterations and the route.daemon.* counts that
  are not seconds); recover the JAX daemon's journal and checkpoints
  (carried into the port's checkpoint format: the JSON journal is read
  as JAX wrote it) to JAX's wirelengths; and, SIGKILLed once a durable
  checkpoint exists and restarted on the same inbox, interleaved or
  ``--fused``, equal its uninterrupted run, with JAX's
  tools/flow_doctor.py --daemon-summary (daemon and rebatch rules)
  signing off.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_DOCTOR = os.path.join(REPO, "tools", "flow_doctor.py")
LUTS = 6
JOBS = (("jobA", 3), ("jobB", 4))
RUN = ["--luts", str(LUTS), "--slice", "2", "--heartbeat_s", "2.0",
       "--exit_when_idle", "2"]
# route.daemon.* values that are seconds or wall-clock dependent
TIMED = ("route.daemon.heartbeats", "route.daemon.heartbeat_age_s",
         "route.daemon.uptime_s", "route.daemon.inbox_lag_s")


def _jax_reference(out_dir):
    """Script mode: the JAX daemon over the module's jobs, uninterrupted
    (``ref``) and for two cycles of one slice each (``carry``: both jobs
    in flight, journaled and checkpointed)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.obs import MetricsRegistry, set_metrics
    from parallel_eda_tpu.serve.daemon import submit_job
    from parallel_eda_tpu.serve.daemon_cli import main

    # carry: strict priority, so that the two one-slice cycles go one to
    # each job (the aged order would give both to the older job)
    for name, extra in (("ref", []), ("carry", ["--slices_per_cycle", "1",
                                                "--aging_rate", "0",
                                                "--max_cycles", "2"])):
        box = os.path.join(out_dir, name)
        os.makedirs(box)
        for jid, seed in JOBS:
            submit_job(box, {"luts": LUTS, "chan_width": 16, "seed": seed,
                             "name": f"l{LUTS}_s{seed}"}, job_id=jid)
        set_metrics(MetricsRegistry())
        main(["run", "--inbox", box, *RUN,
              "--summary", os.path.join(box, "summary.json"), *extra])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
    sys.exit(0)


from parallel_eda_tpu import obs as JOBS_OBS  # noqa: E402
from parallel_eda_tpu.obs import runstore as JRS  # noqa: E402
from parallel_eda_tpu.serve import daemon as JD  # noqa: E402
from parallel_eda_tpu.serve import queue as JQ  # noqa: E402
from parallel_eda_tpu_torch import obs as TOBS  # noqa: E402
from parallel_eda_tpu_torch.obs import runstore as TRS  # noqa: E402
from parallel_eda_tpu_torch.serve import daemon as TD  # noqa: E402
from parallel_eda_tpu_torch.serve import queue as TQ  # noqa: E402

PKGS = {"jax": (JD, JQ, JOBS_OBS, JRS), "port": (TD, TQ, TOBS, TRS)}


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
    out = str(tmp_path_factory.mktemp("jax_daemon"))
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
    return out


# ---- host logic: the daemon loop over a fake service --------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeFlow:
    def __init__(self, nets):
        self.term = types.SimpleNamespace(source=list(range(nets)))


class _FakeService:
    """RouteService's daemon-facing surface over package ``Q``'s real
    JobQueue, with a fake runner."""

    def __init__(self, Q, clock, runner=None, sleep=lambda s: None):
        self.Q = Q
        self.queue = Q.JobQueue(clock=clock, sleep=sleep)
        self.draining = False
        self.runs_dir = None
        self.scenario = "fake"
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


def _mk(P, box, clock=None, opts=None, runner=None, svc=None, **okw):
    D, Q = P[0], P[1]
    clock = clock or _Clock()
    svc = svc or _FakeService(Q, clock, runner=runner)
    opts = opts or D.DaemonOpts(default_nets_per_s=10.0,
                                cold_start_factor=1.0, exit_when_idle=1,
                                **okw)
    d = D.RouteDaemon(
        svc, box, opts,
        flow_builder=lambda spec: _FakeFlow(int(spec.get("nets", 10))),
        clock=clock, wall=lambda: 1000.0 + clock.t,
        sleep=lambda s: setattr(clock, "t", clock.t + s))
    return d, svc, clock


def _sub(P, box, spec, ts=999.0, **kw):
    return P[0].submit_job(box, spec, ts=ts, **kw)


def _state(d, box):
    """Everything a scenario's daemon left behind, paths made relative."""
    def rd(name):
        p = os.path.join(box, name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            if name.endswith(".jsonl"):
                return [json.loads(ln) for ln in f]
            return json.load(f)

    doc = {"summary": d.summary(), "journal": d.journal.load(),
           "rejected": rd("rejected.jsonl"), "telemetry": rd("telemetry.json"),
           "slo": rd("slo.json"), "heartbeat": rd("heartbeat.json")}
    if doc["journal"] is not None:
        doc["journal"].pop("ts")
    if doc["heartbeat"] is not None:
        doc["heartbeat"].pop("pid")
    return json.loads(json.dumps(doc, default=str).replace(box, "<box>"))


def _sc_admit_run(P, box):
    d, svc, clock = _mk(P, box)
    _sub(P, box, {"nets": 5, "name": "a"}, tenant="t0", job_id="a",
         ts=999.5)
    _sub(P, box, {"nets": 5, "name": "b"}, tenant="t1", job_id="b",
         ts=999.9)
    d.run()
    return _state(d, box)


def _sc_reject(P, box):
    d, svc, clock = _mk(P, box, opts=P[0].DaemonOpts(
        admit_horizon_s=5.0, default_nets_per_s=10.0,
        cold_start_factor=1.0, exit_when_idle=1))
    _sub(P, box, {"nets": 1000, "name": "big"}, job_id="big")
    _sub(P, box, {"nets": 5, "name": "ok"}, job_id="ok", deadline_s=0.1)
    d.run()
    return _state(d, box)


def _sc_bad_spec(P, box):
    d, svc, clock = _mk(P, box)
    line = {"job_id": "ghost", "tenant": "t", "spec": "specs/none.json",
            "ts": 999.0}
    with open(os.path.join(box, P[0].SUBMIT_NAME), "ab") as f:
        f.write((json.dumps(line) + "\n").encode())
        f.write(b'\x80\xfe{"torn": tr\n')
        f.write(b'{"job_id": "half')
    d.run()
    return _state(d, box)


def _sc_overload(P, box):
    clock = _Clock()
    svc = _FakeService(P[1], clock)
    d, svc, clock = _mk(P, box, clock=clock, svc=svc,
                        opts=P[0].DaemonOpts(
                            admit_horizon_s=10.0, overload_factor=1.0,
                            default_nets_per_s=10.0, cold_start_factor=1.0,
                            exit_when_idle=1))
    for i in range(4):
        svc.admit(_FakeFlow(60), tenant=f"t{i}", priority=i, job_id=f"j{i}")
        clock.t += 1.0
    out = [d._shed_overload(), d._backlog_nets()]
    return out + [_state(d, box)]


def _sc_fair_share(P, box):
    clock = _Clock()
    svc = _FakeService(P[1], clock)
    d, svc, clock = _mk(P, box, clock=clock, svc=svc, opts=P[0].DaemonOpts(
        admit_horizon_s=1.0, overload_factor=1.0, default_nets_per_s=10.0,
        cold_start_factor=1.0, fair_share_frac=0.5, fair_share_floor=1))
    for i, ten in enumerate(("hog", "hog", "hog", "meek")):
        svc.admit(_FakeFlow(10), tenant=ten, job_id=f"{ten}{i}")
    out = [d._shed_overload(),
           sorted(j.job_id for j in svc.queue.queued_jobs())]
    return out + [_state(d, box)]


def _sc_doomed(P, box):
    clock = _Clock()
    svc = _FakeService(P[1], clock)
    d, svc, clock = _mk(P, box, clock=clock, svc=svc, opts=P[0].DaemonOpts(
        admit_horizon_s=2.0, overload_factor=1.0, default_nets_per_s=10.0,
        cold_start_factor=1.0))
    svc.admit(_FakeFlow(20), tenant="a", priority=9, deadline_s=1.0,
              job_id="doomed")
    svc.admit(_FakeFlow(20), tenant="b", priority=0, deadline_s=999.0,
              job_id="ok")
    for jid, dl in (("big", None), ("dead1", 250.0), ("dead2", 290.0)):
        svc.admit(_FakeFlow(1000), tenant="c", deadline_s=dl, job_id=jid)
    return [d._shed_overload(), _state(d, box)]


def _sc_drain(P, box):
    d, svc, clock = _mk(P, box)
    _sub(P, box, {"nets": 5}, job_id="early")
    out = [d.cycle()]
    open(os.path.join(box, "DRAIN"), "w").close()
    _sub(P, box, {"nets": 5}, job_id="late")
    d.run()
    return out + [svc.draining, _state(d, box)]


def _sc_recovery(P, box):
    clock1 = _Clock()
    svc1 = _FakeService(P[1], clock1,
                        runner=lambda job: ("preempted", {"it_done": 3}))
    d1, svc1, clock1 = _mk(P, box, clock=clock1, svc=svc1)
    _sub(P, box, {"nets": 5, "name": "a"}, job_id="a")
    _sub(P, box, {"nets": 5, "name": "b"}, job_id="b")
    d1.cycle()
    out = [_state(d1, box)]
    _sub(P, box, {"nets": 5, "name": "a"}, job_id="a")
    _sub(P, box, {"nets": 5, "name": "b"}, job_id="b")
    d2, svc2, clock2 = _mk(P, box)
    d2.run()
    return out + [_state(d2, box)]


def _sc_recovery_rejections(P, box):
    opts = P[0].DaemonOpts(admit_horizon_s=5.0, default_nets_per_s=10.0,
                           cold_start_factor=1.0, exit_when_idle=1)
    d1, _, _ = _mk(P, box, opts=opts)
    _sub(P, box, {"nets": 1000}, job_id="big")
    d1.run()
    _sub(P, box, {"nets": 1000}, job_id="big")
    d2, svc2, _ = _mk(P, box, opts=opts)
    d2.run()
    return [svc2.queue.get("big") is None, _state(d2, box)]


def _sc_retry_failures(P, box):
    calls = {}

    def runner(job):
        calls[job.job_id] = calls.get(job.job_id, 0) + 1
        if job.job_id == "flaky" and calls["flaky"] < 2:
            return "failed", "boom"
        if job.job_id == "dead":
            return "failed", "always"
        if calls[job.job_id] < 3:
            return "preempted", {"it_done": calls[job.job_id]}
        return "done", {"wirelength": 3, "iterations": 1, "nets": 5}

    clock = _Clock()
    # the queue waits a retry's backoff out on the injected clock
    svc = _FakeService(P[1], clock, runner=runner,
                       sleep=lambda s: setattr(clock, "t", clock.t + s))
    d, svc, clock = _mk(P, box, clock=clock, svc=svc)
    with open(os.path.join(box, "specs", "flaky.json"), "w") as f:
        json.dump({"nets": 5, "name": "flaky"}, f)
    line = {"job_id": "flaky", "tenant": "t0", "spec": "specs/flaky.json",
            "max_retries": 2, "ts": 999.0}
    with open(os.path.join(box, P[0].SUBMIT_NAME), "ab") as f:
        f.write((json.dumps(line) + "\n").encode())
    _sub(P, box, {"nets": 5, "name": "dead"}, job_id="dead", priority=2,
         tenant="t1")
    _sub(P, box, {"nets": 5, "name": "slow"}, job_id="slow", tenant="t2")
    d.run()
    return _state(d, box)


def _sc_leases(P, box):
    """A single fleet worker: it claims its own jobs, parks and then
    takes over a job a silent peer never leased, is fenced off a job a
    live peer holds, and a ``lease.steal`` plan force-expires a held
    lease that the sweep wins back."""
    D, Q, O = P[0], P[1], P[2]
    from importlib import import_module

    faults = import_module(O.__name__.rsplit(".", 1)[0] + ".resil.faults")
    journal = import_module(O.__name__.rsplit(".", 1)[0] + ".resil.journal")
    clock = _Clock()
    svc = _FakeService(Q, clock, runner=lambda job: (
        ("preempted", {"it_done": 1}) if job.slices < 2 else
        ("done", {"wirelength": 5, "iterations": 2, "nets": 5})))
    svc.resil = types.SimpleNamespace(
        plan=faults.FaultPlan.parse(3, "lease.steal:1:1"))
    opts = D.DaemonOpts(default_nets_per_s=10.0, cold_start_factor=1.0,
                        exit_when_idle=4, worker="w0",
                        workers=("w0", "w1"), lease_ttl_s=5.0,
                        foreign_grace_s=0.3)
    d, svc, clock = _mk(P, box, clock=clock, svc=svc, opts=opts)
    for i, jid in enumerate(("j0", "j1", "j2", "j3", "j4", "j5")):
        _sub(P, box, {"nets": 5, "name": jid}, job_id=jid, tenant=f"t{i}")
    peer = journal.LeaseStore(os.path.join(box, D.LEASE_DIR), "w1",
                              ttl_s=1000.0, clock=clock,
                              wall=lambda: 1000.0 + clock.t)
    claims = {jid: D.preferred_worker(jid, ["w0", "w1"])
              for jid in ("j0", "j1", "j2", "j3", "j4", "j5")}
    held = sorted(j for j, w in claims.items() if w == "w1")
    if held:
        peer.acquire(held[0])     # a live peer holds one of its jobs
    d.run(max_cycles=12)
    return [claims, d.service.queue.depth(), _state(d, box)]


def _sc_slo(P, box):
    obj = os.path.join(os.path.dirname(box), "objectives.json")
    os.makedirs(os.path.dirname(obj), exist_ok=True)
    with open(obj, "w") as f:
        json.dump({"tenants": {"t0": {"e2e_p95_s": 0.001,
                                      "budget_frac": 0.05}}}, f)
    d, svc, clock = _mk(P, box, objectives_path=obj)
    _sub(P, box, {"nets": 5, "name": "a"}, tenant="t0", job_id="a")
    _sub(P, box, {"nets": 5, "name": "b"}, tenant="t1", job_id="b")
    d.run()
    return _state(d, box)


def _sc_inbox_reader(P, box):
    """InboxReader alone: a roundtrip, a torn tail within grace, one
    completed in time, one abandoned, and a truncated inbox."""
    D = P[0]
    os.makedirs(box)
    path = os.path.join(box, D.SUBMIT_NAME)
    out = []
    jid = _sub(P, box, {"luts": 4, "seed": 1, "name": "a"}, tenant="t0",
               priority=3)
    r = D.InboxReader(path, grace=2)
    out.append(r.poll())
    with open(path, "ab") as f:
        f.write(b'{"job_id": "half')
    out += [r.poll(), r.torn]
    with open(path, "ab") as f:
        f.write(b'_done", "spec": "s.json"}\n{"job_id": "aband')
    out += [r.poll(), r.poll(), r.poll(), r.poll(), r.torn, r.offset]
    with open(path, "wb") as f:
        f.write(b'{"job_id": "b"}\n')
    out += [r.poll(), r.offset, jid]
    return json.loads(json.dumps(out).replace(box, "<box>"))


def _sc_admission(P, box):
    D = P[0]
    opts = D.DaemonOpts(max_queue_depth=4, admit_horizon_s=100.0,
                        default_nets_per_s=10.0, cold_start_factor=1.0)
    ac = D.AdmissionController(opts)
    base = dict(nets=10, tenant="t0", deadline_s=None, backlog_nets=0,
                queue_depth=0, tenant_depth=0)
    cases = [{}, {"queue_depth": 4}, {"queue_depth": 3, "tenant_depth": 3},
             {"nets": 2000}, {"nets": 50, "deadline_s": 1.0},
             {"draining": True}, {"backlog_nets": 990},
             {"queue_depth": 1, "tenant_depth": 2}]
    out = [ac.decide(**{**base, **c}) for c in cases]
    c = D.DaemonOpts(default_nets_per_s=10.0, cold_start_factor=0.25)
    out += [D.AdmissionController(c, library_warm=w).capacity_nets_per_s()
            for w in (False, True)]
    # corpus rows (each package's own runstore): the tenant's median,
    # else the all-tenant median
    RS = P[3]
    runs = os.path.join(os.path.dirname(box), "runs")
    for v, ten in ((4.0, "t0"), (8.0, "t0"), (6.0, "t0"), (99.0, "tz")):
        RS.append_run(runs, RS.make_record(
            scenario="dmn", cfg={"j": ten}, metric="nets_per_s", value=v,
            unit="nets/s", backend="cpu", device_kind="cpu", tenant=ten,
            job_id=f"{ten}-{v}"))
    ac = D.AdmissionController(D.DaemonOpts(), runs_dir=runs, scenario="dmn")
    out += [ac.capacity_nets_per_s("t0"), ac.capacity_nets_per_s("new")]
    return out


SCENARIOS = {
    "admit_run_journal": _sc_admit_run, "reject_reason": _sc_reject,
    "bad_spec_torn_lines": _sc_bad_spec, "overload_shed": _sc_overload,
    "fair_share_shed": _sc_fair_share, "doomed_deadline_shed": _sc_doomed,
    "drain_file": _sc_drain, "recovery_dedupe": _sc_recovery,
    "recovery_rejections": _sc_recovery_rejections,
    "retry_failures": _sc_retry_failures, "single_worker_leases": _sc_leases,
    "slo_publish": _sc_slo, "inbox_reader": _sc_inbox_reader,
    "admission": _sc_admission}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_daemon_scenario_matches_jax(name, tmp_path):
    """Each daemon-loop scenario on both packages, under the same
    injected clocks and submissions: equal summaries, journals,
    telemetry, slo.json, rejected.jsonl lines and metrics."""
    outs = {}
    for pkg, P in PKGS.items():
        box = str(tmp_path / pkg / "box")
        out = SCENARIOS[name](P, box)
        outs[pkg] = (out, P[2].get_metrics().values("route."))
    assert outs["port"] == outs["jax"]


# ---- the CLI in subprocesses --------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _port_cli(args, **kw):
    return subprocess.run([sys.executable, "-m", "parallel_eda_tpu_torch",
                           "daemon", *args], cwd=REPO, env=_env(),
                          capture_output=True, text=True, **kw)


def _port_submit(box):
    for jid, seed in JOBS:
        r = _port_cli(["submit", "--inbox", box, "--luts", str(LUTS),
                       "--seed", str(seed), "--job_id", jid])
        assert r.returncode == 0, r.stderr


def _run_cmd(box, extra=()):
    return [sys.executable, "-m", "parallel_eda_tpu_torch", "daemon", "run",
            "--inbox", box, *RUN, "--device", "cpu",
            "--summary", os.path.join(box, "summary.json"), *extra]


def _summary(box):
    with open(os.path.join(box, "summary.json")) as f:
        return json.load(f)


def _jobs(doc):
    return {j["job_id"]: (j["state"], j.get("wirelength"),
                          j.get("iterations")) for j in doc["jobs"]}


def _counts(doc):
    return {k: v for k, v in doc["daemon"]["metrics"].items()
            if k not in TIMED}


@pytest.fixture(scope="module")
def port_ref(tmp_path_factory):
    """The port's uninterrupted daemon over the module's two jobs."""
    box = str(tmp_path_factory.mktemp("port_ref"))
    _port_submit(box)
    r = subprocess.run(_run_cmd(box), cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return box


def test_daemon_cli_status_and_fleet(tmp_path, port_ref):
    """``daemon status`` reads the heartbeat and journal of a finished
    daemon (stale: exit 1, the journal's job states); ``daemon fleet``
    is a subcommand with JAX's flags and the port's ``--device``
    (tests/test_torch_fleet.py runs it)."""
    r = _port_cli(["status", "--inbox", port_ref, "--json",
                   "--stale_s", "0"])
    doc = json.loads(r.stdout)
    assert r.returncode == 1 and not doc["alive"]
    assert doc["journal_jobs"] == {"done": 2}
    assert doc["heartbeat"]["cycle"] >= 1
    r = _port_cli(["fleet", "--help"])
    assert r.returncode == 0, r.stderr
    for flag in ("--workers", "--library", "--cache_base", "--expect_jobs",
                 "--tick_s", "--timeout_s", "--no_transport", "--host",
                 "--port", "--summary", "--trace", "--objectives",
                 "--chaos", "--device"):
        assert flag in r.stdout, flag


def test_daemon_graceful_sigterm(tmp_path):
    """SIGTERM stops the loop at the next cycle boundary: the daemon
    exits 0 with its summary written and its journal flushed."""
    box = str(tmp_path)
    p = subprocess.Popen(_run_cmd(box, ("--poll_s", "0.05")), cwd=REPO,
                         env=_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        hb = os.path.join(box, "heartbeat.json")
        deadline = time.time() + 120
        while not os.path.exists(hb) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.exists(hb)
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-2000:]
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["jobs"] == [] and doc["daemon"]["journal"]["writes"] >= 2
    assert _summary(box) == doc


def test_port_daemon_matches_jax_daemon(port_ref, jax_ref):
    """Two jobs through the port's daemon and the JAX daemon: the same
    job states, wirelengths and iterations, and the same route.daemon.*
    counts but for seconds."""
    port, jax_doc = _summary(port_ref), _summary(os.path.join(jax_ref,
                                                              "ref"))
    assert _jobs(port) == _jobs(jax_doc)
    assert all(s == "done" for s, _, _ in _jobs(port).values())
    assert _counts(port) == _counts(jax_doc)
    assert port["daemon"]["cycles"] == jax_doc["daemon"]["cycles"]
    assert set(port) == set(jax_doc)
    assert set(port["daemon"]) == set(jax_doc["daemon"])
    assert port["dispatch_compiles"] > 0


def test_port_daemon_recovers_jax_journal(tmp_path, jax_ref):
    """The JAX daemon's in-flight inbox (journal, durable checkpoints,
    submit offset), taken over by the port's daemon: the JSON journal as
    JAX wrote it, each checkpoint carried into the port's format
    (checkpoint_from_numpy of its JAX fields).  Every in-flight job
    resumes and finishes with the JAX daemon's uninterrupted wirelength,
    and a job the JAX daemon finished stays finished."""
    import dataclasses
    import shutil

    from parallel_eda_tpu.resil.checkpoint import \
        CheckpointStore as JStore
    from parallel_eda_tpu_torch.resil.checkpoint import \
        CheckpointStore as TStore
    from parallel_eda_tpu_torch.route.router import checkpoint_from_numpy

    box = str(tmp_path / "carry")
    shutil.copytree(os.path.join(jax_ref, "carry"), box)
    os.remove(os.path.join(box, "summary.json"))
    with open(os.path.join(box, "journal", "journal.json")) as f:
        journal = json.load(f)
    flight = sorted(j for j, e in journal["jobs"].items()
                    if e["state"] == "in_flight")
    assert flight == ["jobA", "jobB"]
    ck_dir = os.path.join(box, "ckpt")
    for jid in flight:
        ck = JStore(ck_dir).load(jid)
        assert ck is not None and ck.it_done > 0
        for suffix in (".ck", ".ck.prev"):
            if os.path.exists(os.path.join(ck_dir, jid + suffix)):
                os.remove(os.path.join(ck_dir, jid + suffix))
        TStore(ck_dir).save(jid, checkpoint_from_numpy(
            {f.name: getattr(ck, f.name) for f in dataclasses.fields(ck)}))
    r = subprocess.run(_run_cmd(box), cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = _summary(box)
    ref = _jobs(_summary(os.path.join(jax_ref, "ref")))
    assert _jobs(doc) == {j: ref[j] for j in flight}
    assert doc["daemon"]["metrics"]["route.daemon.recovered"] == len(flight)
    assert sorted(doc["daemon"]["recovered"]) == flight
    assert doc["resil"]["metrics"][
        "route.resil.checkpoint_recoveries"] >= len(flight)
    # the finished job stays finished: the journal keeps JAX's answer
    with open(os.path.join(box, "journal", "journal.json")) as f:
        after = json.load(f)["jobs"]
    for jid, e in journal["jobs"].items():
        if e["state"] == "done":
            assert after[jid]["state"] == "done"
            assert after[jid]["wirelength"] == ref[jid][1]


@pytest.mark.parametrize("mode", ["interleaved", "fused"])
def test_port_daemon_sigkill_restart(mode, tmp_path, port_ref):
    """The port's daemon SIGKILLed once a durable checkpoint exists,
    then restarted on the same inbox (interleaved, or ``--fused`` as
    JAX tests/test_fused.py does): every job ends as in the port's
    uninterrupted interleaved daemon (state, wirelength, iterations),
    route.daemon.recovered > 0, and JAX's flow_doctor --daemon-summary
    (its daemon and rebatch rules) signs off on the summary."""
    extra = ("--fused",) if mode == "fused" else ()
    box = str(tmp_path)
    _port_submit(box)
    proc = subprocess.Popen(_run_cmd(box, extra), cwd=REPO, env=_env(),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    ckpt = os.path.join(box, "ckpt")
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if (os.path.isdir(ckpt)
                    and any(n.endswith(".ck") for n in os.listdir(ckpt))):
                break
            if proc.poll() is not None:
                pytest.fail("the daemon exited before any durable "
                            "checkpoint was written")
            time.sleep(0.02)
        else:
            pytest.fail("no durable checkpoint appeared in time")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not os.path.exists(os.path.join(box, "summary.json"))
    r = subprocess.run(_run_cmd(box, extra), cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = _summary(box)
    assert _jobs(doc) == _jobs(_summary(port_ref))
    assert doc["daemon"]["metrics"].get("route.daemon.recovered", 0) > 0
    if mode == "fused":
        assert doc["rebatch"]["fused"] and doc["rebatch"]["events"]
    r = subprocess.run([sys.executable, FLOW_DOCTOR, "--daemon-summary",
                        os.path.join(box, "summary.json")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
