"""The port's daemon journal, heartbeat and leases
(parallel_eda_tpu_torch/resil/journal.py) and its SLO plane
(parallel_eda_tpu_torch/obs/slo.py) against the JAX package's, on the
CPU.

Every scenario runs twice, once on each package's module, from the same
observation sequence and the same injected clocks, and returns a
transcript (documents, counters, digests, quantiles, burns, forecasts,
snapshots, merges); the two transcripts must be equal — exactly, every
number and every JSON field.  The JSON documents are the contract: a
journal, a heartbeat or a lease written by either package reads the
same in the other (``test_documents_read_across_packages``, both ways).
The SLO scenarios mirror JAX tests/test_slo.py's units.
"""

import json
import os

import pytest

from parallel_eda_tpu import obs as JOBS
from parallel_eda_tpu.obs import slo as JSLO
from parallel_eda_tpu.resil import journal as JJ
from parallel_eda_tpu_torch import obs as TOBS
from parallel_eda_tpu_torch.obs import slo as TSLO
from parallel_eda_tpu_torch.resil import journal as TJ

PKGS = {"jax": (JJ, JSLO, JOBS), "port": (TJ, TSLO, TOBS)}


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _fresh_registries():
    jold, told = JOBS.get_metrics(), TOBS.get_metrics()
    JOBS.set_metrics(JOBS.MetricsRegistry())
    TOBS.set_metrics(TOBS.MetricsRegistry())
    yield
    JOBS.set_metrics(jold)
    TOBS.set_metrics(told)


def _strip(doc, keys=("ts", "pid")):
    """A document without its process-dependent fields (wall stamps of
    the real clock, the writer's pid)."""
    if isinstance(doc, dict):
        return {k: _strip(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [_strip(v, keys) for v in doc]
    return doc


def _rel(doc, root):
    """``doc`` with the scenario's directory replaced by "<dir>"."""
    return json.loads(json.dumps(doc, default=str).replace(root, "<dir>"))


# ---- journal, heartbeat, leases ---------------------------------------

def _journal(J, d):
    js = J.JournalStore(d)
    js.save({"a": {"state": "in_flight"}}, extra={"inbox_offset": 10})
    js.save({"a": {"state": "done"}}, extra={"inbox_offset": 20})
    out = [_strip(js.load())]
    # a torn current generation falls back to .prev
    with open(js.path, "wb") as f:
        f.write(b"{torn")
    out.append(_strip(js.load()))
    # a newer schema is refused (both generations)
    for p in (js.path, js.path + ".prev"):
        with open(p, "w") as f:
            json.dump({"schema": 999, "jobs": {}}, f)
    out.append(js.load())
    out.append(js.writes)
    return out


def _heartbeat(J, d):
    clk = _Clock()
    hb = J.Heartbeat(os.path.join(d, "hb.json"), interval_s=1.0,
                     clock=clk, wall=lambda: 500.0 + clk.t)
    out = [hb.beat(cycle=1)]
    for t, c in ((0.5, 2), (1.2, 3), (8.0, 4), (8.5, 5), (9.25, 6)):
        clk.t = t
        out.append(hb.beat(cycle=c, queue_depth=c - 1))
    out.append(hb.beats)
    out.append(hb.max_gap_s)
    out.append(hb.summary())
    out.append(_strip(J.Heartbeat.read(hb.path,
                                       wall=lambda: 500.0 + clk.t + 2.0,
                                       mono=lambda: clk.t + 1.5)))
    # a reader on another boot (negative mono age) ages by the wall
    out.append(_strip(J.Heartbeat.read(hb.path,
                                       wall=lambda: 500.0 + clk.t + 3.0,
                                       mono=lambda: -1.0)))
    out.append(J.Heartbeat.read(os.path.join(d, "nope.json"))["age_s"])
    return out


def _leases(J, d):
    clk, wall = _Clock(100.0), _Clock(5000.0)
    a = J.LeaseStore(d, "w0", ttl_s=4.0, clock=clk, wall=wall)
    b = J.LeaseStore(d, "w1", ttl_s=4.0, clock=clk, wall=wall)
    out = [a.acquire("j1"), b.acquire("j1"), a.owns("j1"), b.owns("j1")]
    clk.t += 1.0
    out += [a.renew("j1", state="running"), b.renew("j1")]
    out.append(b.steal("j1"))                 # live: no steal
    clk.t += 10.0
    out += [a.expired(a.read("j1")), b.steal("j1"), a.owns("j1"),
            b.owns("j1"), a.renew("j1")]      # a is fenced
    out += [a.acquire("j2"), a.force_expire("j2"), b.expired(b.read("j2")),
            b.steal("j2")]
    out += [b.release("j1", state="done"), b.expired(b.read("j1")),
            a.steal("j1"), a.acquire("j1")]
    out.append(a.held())
    out.append(b.held())
    out.append(_rel(a.summary(), d))
    out.append({j: _strip(doc) for j, doc in a.scan().items()})
    out.append(sorted(os.listdir(d)))
    return out


SCENARIOS = {"journal": _journal, "heartbeat": _heartbeat,
             "leases": _leases}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_journal_scenario_matches_jax(name, tmp_path):
    """The same journal/heartbeat/lease sequence, under the same
    injected clocks, on both packages: equal transcripts and equal
    route.resil.* / route.daemon.* / route.fleet.* counters."""
    outs = {}
    for pkg, (J, _, O) in PKGS.items():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        t = SCENARIOS[name](J, d)
        outs[pkg] = (_rel(t, d), O.get_metrics().values("route."))
    assert outs["port"] == outs["jax"]


def test_lease_steal_is_link_and_rename(tmp_path, monkeypatch):
    """Ownership is taken by os.link (exactly one winner) and a steal by
    os.rename of the record aside, in both packages: the same calls, in
    the same order."""
    calls = {}
    for pkg, (J, _, _) in PKGS.items():
        seen = []
        real_link, real_rename = os.link, os.rename
        monkeypatch.setattr(os, "link", lambda s, t: (
            seen.append(("link", os.path.basename(t))), real_link(s, t))[1])
        monkeypatch.setattr(os, "rename", lambda s, t: (
            seen.append(("rename", os.path.basename(s),
                         os.path.basename(t))), real_rename(s, t))[1])
        clk = _Clock()
        d = str(tmp_path / pkg)
        a = J.LeaseStore(d, "w0", ttl_s=1.0, clock=clk, wall=clk)
        b = J.LeaseStore(d, "w1", ttl_s=1.0, clock=clk, wall=clk)
        a.acquire("j")
        clk.t = 5.0
        b.steal("j")
        monkeypatch.undo()
        calls[pkg] = seen
    assert calls["port"] == calls["jax"] == [
        ("link", "j.lease"), ("rename", "j.lease", "j.lease.steal.w1"),
        ("link", "j.lease")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_documents_read_across_packages(writer, tmp_path):
    """A journal, a heartbeat and a lease written by one package read
    the same in the other."""
    reader = "port" if writer == "jax" else "jax"
    WJ, RJ = PKGS[writer][0], PKGS[reader][0]
    d = str(tmp_path)
    clk = _Clock(50.0)
    WJ.JournalStore(os.path.join(d, "journal")).save(
        {"jobA": {"state": "in_flight", "it_done": 4, "tenant": "t0",
                  "submission": {"job_id": "jobA", "spec": "specs/a.json"}},
         "jobB": {"state": "rejected", "reason": {"code": "queue_full"}}},
        extra={"inbox_offset": 321, "cycle": 7})
    hb = WJ.Heartbeat(os.path.join(d, "heartbeat.json"), clock=clk,
                      wall=lambda: 9000.0)
    hb.beat(cycle=7, queue_depth=1)
    WJ.LeaseStore(os.path.join(d, "leases"), "w0", ttl_s=3.0, clock=clk,
                  wall=lambda: 9000.0).acquire("jobA")
    got = {}
    for pkg, J in ((writer, WJ), (reader, RJ)):
        got[pkg] = (
            _strip(J.JournalStore(os.path.join(d, "journal")).load()),
            _strip(J.Heartbeat.read(os.path.join(d, "heartbeat.json"),
                                    wall=lambda: 9001.0,
                                    mono=lambda: 51.0)),
            J.LeaseStore(os.path.join(d, "leases"), "w1", ttl_s=3.0,
                         clock=lambda: 52.0, wall=lambda: 9002.0
                         ).read("jobA"),
            J.LeaseStore(os.path.join(d, "leases"), "w1", ttl_s=3.0,
                         clock=lambda: 54.0, wall=lambda: 9004.0
                         ).expired(J.LeaseStore(
                             os.path.join(d, "leases"), "w1").read("jobA")))
    assert got[reader] == got[writer]
    assert got[reader][0]["inbox_offset"] == 321
    assert got[reader][1]["age_s"] == 1.0
    assert got[reader][3] is True


# ---- the SLO plane -------------------------------------------------------

def _digests(S):
    a, b = S.QuantileDigest(), S.QuantileDigest()
    xs = [0.001, 0.5, 0.5, 3.0, 42.0, 1e-6, 2e6]
    for x in xs:
        a.add(x)
    for x in reversed(xs):
        b.add(x)
    out = [a.to_dict(), b.to_dict(),
           [a.quantile(q) for q in (0.0, 0.5, 0.95, 1.0)],
           S.QuantileDigest().quantile(0.95)]
    w0, w1 = S.QuantileDigest(), S.QuantileDigest()
    for i in range(100):
        w0.add(0.01 * (i + 1))
    for i in range(37):
        w1.add(10.0 + 1000.0 * i)
    merged = S.QuantileDigest.from_dict(w0.to_dict())
    merged.merge(S.QuantileDigest.from_dict(w1.to_dict()))
    out += [merged.to_dict(), merged.quantile(0.95),
            S.merge_digest_dicts([w0.to_dict(), w1.to_dict()]),
            S.merge_digest_dicts([])]
    errs = []
    for bad in (lambda: S.QuantileDigest.from_dict(
                    dict(a.to_dict(), count=5)),
                lambda: a.merge(S.QuantileDigest(bins_per_decade=4)),
                lambda: S.QuantileDigest(lo=1.0, hi=2.0)):
        try:
            bad()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    return out + [errs]


def _waterfalls(S):
    out = []
    p = S.SLOPlane()
    p.observe_admit("j", "t0", 10.0, lag_s=0.25)
    p.observe_slice("j", 12.0, 13.0, compile_s=0.4, stall_s=0.1)
    p.observe_slice("j", 13.5, 14.0)
    out.append(p.runstore_fields("j", now=14.0))
    wf = p.observe_terminal("j", "done", 14.2)
    out += [wf, S.waterfall_exact(wf), p.observe_terminal("j", "done", 15),
            p.untracked_terminals, p.runstore_fields("nope", now=1.0)]
    p2 = S.SLOPlane()
    p2.observe_admit("j", "t0", 100.0, lag_s=2.0, failover=True)
    p2.observe_slice("j", 101.0, 102.0, attempts=0)
    p2.observe_slice("j", 105.0, 106.0, attempts=1)
    out.append(p2.observe_terminal("j", "failed", 106.0))
    p3 = S.SLOPlane()
    p3.observe_admit("k", "t0", 0.0)
    p3.observe_slice("k", 0.0, 1.0, compile_s=9.0, stall_s=9.0)
    out.append(p3.observe_terminal("k", "done", 1.0))
    p4 = S.SLOPlane()
    p4.observe_admit("s", "t0", 0.0, lag_s=0.5)
    out.append(p4.observe_terminal("s", "shed", 4.5))
    out.append(S.waterfall_exact({**wf, "e2e_us": wf["e2e_us"] + 1}))
    out.append(S.waterfall_exact(
        {**wf, "stages_us": dict(wf["stages_us"], exec=1.0e6)}))
    out.append(list(S.STAGES))
    return out


def _trackers(S, tmp):
    tr = S.SLOTracker("t0", {"e2e_p95_s": 1.0, "failure_rate": 0.10,
                             "budget_frac": 0.05}, window=100)
    out = []
    for _ in range(18):
        tr.observe(0.5, 0.0, failed=False)
    tr.observe(2.0, 0.0, failed=False)
    out.append(tr.snapshot())
    tr.observe(0.1, 0.0, failed=True)
    out.append(tr.snapshot())
    free = S.SLOTracker("t1")
    free.observe(9999.0, 9999.0, failed=True)
    out.append(free.snapshot())
    fix = os.path.join(tmp, "obj.json")
    with open(fix, "w") as f:
        json.dump({"schema": 1, "tenants": {
            "t0": {"e2e_p95_s": 30.0, "bogus": "x"}}}, f)
    bare = os.path.join(tmp, "bare.json")
    with open(bare, "w") as f:
        json.dump({"t1": {"failure_rate": 0.1}}, f)
    out += [S.load_objectives(fix), S.load_objectives(bare),
            S.load_objectives(os.path.join(tmp, "missing.json")),
            S.load_objectives("")]
    return out


def _forecasts(S):
    fc = S.CapacityForecaster(horizon_s=60.0, max_workers=8)
    return [fc.forecast(rate_nets_per_s=10.0, backlog_nets=3000.0,
                        workers_alive=2),
            S.CapacityForecaster().forecast(10.0, 0.0),
            S.CapacityForecaster(horizon_s=5.0).forecast(0.5, 77.0, 3),
            S.recommended_workers(1e9, 60.0, 8),
            S.recommended_workers(300.0, 60.0, 8),
            S.recommended_workers(0.0, 60.0, 8)]


def _planes(S, tmp):
    """Two workers' planes over skewed clocks, their snapshots, gauges
    and the fleet merge; slo.json written and read back."""
    obj = {"t0": {"e2e_p95_s": 2.0, "budget_frac": 0.1},
           "t1": {"queue_wait_p95_s": 0.5, "failure_rate": 0.2}}
    secs = {}
    out = []
    for w, skew in (("w0", 0.0), ("w1", 1000.0)):
        p = S.SLOPlane(objectives=obj, window=16)
        for i in range(12):
            jid = f"{w}-j{i}"
            t0 = skew + 3.0 * i
            p.observe_admit(jid, f"t{i % 2}", t0, lag_s=0.1 * (i % 3),
                            failover=(i == 5))
            p.observe_slice(jid, t0 + 0.5 + 0.1 * i, t0 + 1.5 + 0.2 * i,
                            compile_s=0.05 * (i % 4), stall_s=0.01,
                            attempts=int(i == 7))
            if i % 4:
                p.observe_slice(jid, t0 + 2.0 + 0.2 * i,
                                t0 + 2.5 + 0.3 * i)
            p.observe_terminal(jid, ("done", "failed", "done",
                                     "shed")[i % 4], t0 + 3.0 + 0.4 * i)
        fc = S.CapacityForecaster(horizon_s=30.0).forecast(
            4.0 + len(w), 120.0, workers_alive=1)
        out.append(p.gauges(fc))
        secs[w] = p.snapshot(forecast=fc)
        out.append(secs[w])
    merged = S.merge_slo_sections(
        secs, forecast=S.CapacityForecaster().forecast(9.0, 240.0, 2))
    out.append(merged)
    out.append(S.merge_slo_sections({}))
    out.append([S.slo_name(), S.slo_name("w3")])
    with open(os.path.join(tmp, S.slo_name("w0")), "w") as f:
        json.dump(secs["w0"], f)
    out.append(S.read_slo(tmp, "w0") == secs["w0"])
    out.append(S.read_slo(tmp, "nobody"))
    return out


SLO_SCENARIOS = {"digests": lambda S, t: _digests(S),
                 "waterfalls": lambda S, t: _waterfalls(S),
                 "trackers": _trackers,
                 "forecasts": lambda S, t: _forecasts(S),
                 "planes": _planes}


@pytest.mark.parametrize("name", sorted(SLO_SCENARIOS))
def test_slo_scenario_matches_jax(name, tmp_path):
    """The same observation sequence on both packages' SLO plane: equal
    digests, quantiles, waterfalls, burns, forecasts, gauges, snapshots
    and fleet merges (exact; the digests' wire formats equal field for
    field)."""
    outs = {}
    for pkg, (_, S, _) in PKGS.items():
        d = str(tmp_path / pkg)
        os.makedirs(d)
        outs[pkg] = json.loads(json.dumps(SLO_SCENARIOS[name](S, d),
                                          default=str))
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_digest_wire_format_crosses_packages(direction):
    """A digest serialized by one package loads and merges in the other
    with the same bins and quantiles."""
    src, dst = ((JSLO, TSLO) if direction == "jax_to_port"
                else (TSLO, JSLO))
    d = src.QuantileDigest()
    for v in (0.002, 0.05, 1.5, 1.5, 30.0, 900.0):
        d.add(v)
    got = dst.QuantileDigest.from_dict(d.to_dict())
    extra = dst.QuantileDigest()
    extra.add(7.0)
    got.merge(extra)
    d.merge(src.QuantileDigest.from_dict(extra.to_dict()))
    assert got.to_dict() == d.to_dict()
    assert got.quantile(0.9) == d.quantile(0.9)
