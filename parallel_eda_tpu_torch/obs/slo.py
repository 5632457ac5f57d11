"""Fleet SLO plane: streaming latency digests, per-job latency
waterfalls, per-tenant error budgets, and the capacity forecaster (the
counterpart of parallel_eda_tpu/obs/slo.py: the same digests, bins,
burns, forecasts and wire formats, so that a digest or a summary
written by either package merges with and reads in the other).

The serve stack records every lifecycle transition and slice span, and
the corpus prices tenants from history; this module turns those events
into the signals a serving fleet is operated on: latency percentiles,
an exact per-job decomposition of *where* the time went, objective burn
per tenant, and a worker-count recommendation for an autoscaling
supervisor.  Four pieces:

``QuantileDigest``
    A deterministic, mergeable streaming quantile sketch: a fixed
    log-spaced bin histogram (not a t-digest — t-digest centroids
    depend on insertion order, so two workers' digests would not merge
    reproducibly).  Bins are fixed at construction, ``add`` is a
    bisect, ``merge`` is a bin-wise integer sum — so per-worker shards
    sum EXACTLY into one fleet digest, independent of arrival order,
    and the merged count always equals the sum of the shard counts.
    Quantiles are reported as the upper edge of the covering bin
    (a guaranteed over-estimate, never an interpolation artifact).

``Waterfall`` (built by ``SLOPlane``)
    Per terminal job, end-to-end latency decomposed into
    queue_wait + compile + exec + stall + backoff + failover_gap +
    other.  All stage arithmetic is INTEGER MICROSECONDS: ``other`` is
    the signed residual ``e2e_us - sum(named stages)``, so
    ``sum(stages_us.values()) == e2e_us`` holds exactly, always —
    the same telescoping contract as observatory's nets/s waterfall,
    but immune to float non-associativity.  flow_doctor --slo gates
    that identity on every published waterfall.

``SLOTracker``
    Per-tenant declared objectives (e2e p95, queue-wait p95, failure
    rate) with rolling error-budget burn over a bounded window.  Burn
    is FRACTION-BASED: burn = (fraction of windowed jobs over the
    threshold) / (budgeted fraction), so burn > 1.0 is *definitionally*
    a breached objective — the doctor's "burn > 1 requires a breach"
    rule is a consistency check on the publisher, not a tautology it
    can fudge.

``CapacityForecaster``
    Converts a nets/s capacity estimate (corpus medians via the
    admission controller) + live backlog into backlog seconds,
    time-to-drain at the current worker count, and
    ``recommended_workers`` — the autoscaling input.  The forecast
    publishes every input it used, so the doctor re-derives the
    recommendation from the published numbers and compares exactly.

Deliberately STDLIB-ONLY (like runstore.py): a reader of a summary JSON
can load this module by file path, without torch or the repo on
sys.path.  Nothing here touches a
device: the daemon feeds it host-side clock readings at the existing
slice-boundary snapshot sites, so publishing SLO state never adds a
mid-window device sync.
"""

from __future__ import annotations

import json
import math
import os
from bisect import bisect_right
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

SLO_SCHEMA = 1

#: the waterfall stage vocabulary, in display order.  ``other`` is the
#: signed residual that makes the telescoping identity exact.
STAGES = ("queue_wait", "compile", "exec", "stall", "backoff",
          "failover_gap", "other")

#: objective keys a tenant may declare (threshold units in the name);
#: ``budget_frac`` is the budgeted over-threshold fraction for the two
#: latency objectives (default 0.05 — the p95 complement).
OBJECTIVE_KEYS = ("e2e_p95_s", "queue_wait_p95_s", "failure_rate")
DEFAULT_BUDGET_FRAC = 0.05


def _us(seconds: float) -> int:
    """Seconds -> integer microseconds (the waterfall's exact unit)."""
    return int(round(float(seconds) * 1e6))


# ---------------------------------------------------------------- digest


class QuantileDigest:
    """Fixed log-spaced bin histogram over positive seconds.

    ``bins_per_decade`` bins per factor of 10 between ``lo`` and
    ``hi``, plus an underflow and an overflow bin.  The bin edges are
    a pure function of the three parameters, so any two digests built
    with the same parameters are bin-compatible and ``merge`` is an
    exact integer sum — the property the fleet merge relies on.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e5,
                 bins_per_decade: int = 8):
        if not (lo > 0 and hi > lo and bins_per_decade > 0):
            raise ValueError("digest needs 0 < lo < hi and "
                             "bins_per_decade >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        decades = math.log10(self.hi / self.lo)
        n = int(round(decades * self.bins_per_decade))
        if abs(decades * self.bins_per_decade - n) > 1e-9:
            raise ValueError("hi/lo must span a whole number of bins")
        # n+1 edges delimit n bins; counts[0] is underflow (< lo) and
        # counts[n+1] is overflow (>= hi): n+2 counters total
        lg = math.log10(self.lo)
        self._edges = [10.0 ** (lg + i / self.bins_per_decade)
                       for i in range(n + 1)]
        self._edges[-1] = self.hi   # pin the top edge exactly
        self.counts = [0] * (n + 2)
        self.count = 0

    # -- ingest

    def add(self, seconds: float) -> None:
        self.counts[bisect_right(self._edges, float(seconds))] += 1
        self.count += 1

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        if (self.lo, self.hi, self.bins_per_decade) != \
                (other.lo, other.hi, other.bins_per_decade):
            raise ValueError(
                f"digest parameter mismatch: "
                f"({self.lo}, {self.hi}, {self.bins_per_decade}) vs "
                f"({other.lo}, {other.hi}, {other.bins_per_decade})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        return self

    # -- query

    def quantile(self, q: float) -> float:
        """Upper edge of the bin covering the q-quantile (0 when
        empty).  Underflow reports ``lo``; overflow reports ``hi``."""
        if self.count <= 0:
            return 0.0
        target = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i >= len(self._edges):      # overflow bin
                    return self.hi
                return self._edges[i] if i else self.lo
        return self.hi

    # -- wire format (sparse: only non-zero bins travel)

    def to_dict(self) -> dict:
        return {
            "schema": SLO_SCHEMA,
            "lo": self.lo, "hi": self.hi,
            "bins_per_decade": self.bins_per_decade,
            "count": self.count,
            "counts": {str(i): c for i, c in enumerate(self.counts)
                       if c},
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "QuantileDigest":
        d = cls(lo=float(doc.get("lo", 1e-4)),
                hi=float(doc.get("hi", 1e5)),
                bins_per_decade=int(doc.get("bins_per_decade", 8)))
        total = 0
        for k, c in (doc.get("counts") or {}).items():
            i, c = int(k), int(c)
            if not (0 <= i < len(d.counts)) or c < 0:
                raise ValueError(f"digest bin {k}={c} out of range")
            d.counts[i] = c
            total += c
        declared = int(doc.get("count", total))
        if declared != total:
            raise ValueError(f"digest count {declared} != bin sum "
                             f"{total}")
        d.count = total
        return d


def merge_digest_dicts(docs: List[dict]) -> Optional[dict]:
    """Merge serialized digests (skipping unparseable ones is the
    caller's job — this raises on parameter mismatch)."""
    merged: Optional[QuantileDigest] = None
    for doc in docs:
        d = QuantileDigest.from_dict(doc)
        merged = d if merged is None else merged.merge(d)
    return merged.to_dict() if merged is not None else None


# ------------------------------------------------------------- waterfall


class _JobTrack:
    """Mutable per-job accumulator between admit and terminal."""

    __slots__ = ("tenant", "admit_us", "lag_us", "failover",
                 "first_slice_us", "prev_end_us", "prev_attempts",
                 "compile_us", "exec_us", "stall_us", "backoff_us",
                 "n_slices")

    def __init__(self, tenant: str, admit_us: int, lag_us: int,
                 failover: bool):
        self.tenant = tenant
        self.admit_us = admit_us
        self.lag_us = max(0, lag_us)
        self.failover = bool(failover)
        self.first_slice_us: Optional[int] = None
        self.prev_end_us = admit_us
        self.prev_attempts = 0
        self.compile_us = 0
        self.exec_us = 0
        self.stall_us = 0
        self.backoff_us = 0
        self.n_slices = 0


def waterfall_exact(wf: dict) -> bool:
    """The telescoping identity flow_doctor --slo gates: the integer
    stage sum (signed residual included) reconstructs e2e exactly."""
    stages = wf.get("stages_us")
    if not isinstance(stages, dict) or set(stages) != set(STAGES):
        return False
    vals = list(stages.values())
    if not all(isinstance(v, int) and not isinstance(v, bool)
               for v in vals):
        return False
    return sum(vals) == wf.get("e2e_us")


# --------------------------------------------------------------- tracker


def load_objectives(path: str) -> Dict[str, dict]:
    """Tolerant objectives loader: accepts the traffic_gen fixture
    shape ``{"schema": 1, "tenants": {...}}`` or a bare tenant map.
    Missing/unreadable file -> no declared objectives (never raises:
    observability must not fail the daemon)."""
    if not path:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict):
        return {}
    tenants = doc.get("tenants", doc)
    if not isinstance(tenants, dict):
        return {}
    out = {}
    for t, obj in tenants.items():
        if isinstance(obj, dict):
            out[str(t)] = {k: float(obj[k]) for k in
                           (*OBJECTIVE_KEYS, "budget_frac")
                           if isinstance(obj.get(k), (int, float))}
    return out


class SLOTracker:
    """One tenant's objectives + rolling error-budget burn.

    The window is the last ``window`` terminal jobs (not wall time):
    deterministic under fake clocks, bounded in memory, and exactly
    reproducible from the job sequence.  ``burn`` per objective is
    (observed violating fraction) / (budgeted fraction); > 1.0 means
    the budget is spent — i.e. the objective is breached.
    """

    def __init__(self, tenant: str, objectives: Optional[dict] = None,
                 window: int = 512):
        self.tenant = tenant
        self.objectives = dict(objectives or {})
        self.window: deque = deque(maxlen=max(1, int(window)))
        self.jobs = 0
        self.failed = 0
        self.digest_e2e = QuantileDigest()
        self.digest_queue_wait = QuantileDigest()

    def observe(self, e2e_s: float, queue_wait_s: float,
                failed: bool) -> None:
        self.jobs += 1
        self.failed += int(bool(failed))
        o = self.objectives
        self.window.append((
            "e2e_p95_s" in o and e2e_s > o["e2e_p95_s"],
            "queue_wait_p95_s" in o
            and queue_wait_s > o["queue_wait_p95_s"],
            bool(failed)))

    def burn(self) -> Dict[str, float]:
        n = len(self.window)
        if n == 0 or not self.objectives:
            return {}
        o = self.objectives
        budget = max(1e-9, float(o.get("budget_frac",
                                       DEFAULT_BUDGET_FRAC)))
        e2e_over = sum(1 for a, _, _ in self.window if a)
        qw_over = sum(1 for _, b, _ in self.window if b)
        n_failed = sum(1 for _, _, c in self.window if c)
        out = {}
        if "e2e_p95_s" in o:
            out["e2e_p95_s"] = round(e2e_over / n / budget, 4)
        if "queue_wait_p95_s" in o:
            out["queue_wait_p95_s"] = round(qw_over / n / budget, 4)
        if "failure_rate" in o:
            allowed = max(1e-9, float(o["failure_rate"]))
            out["failure_rate"] = round(n_failed / n / allowed, 4)
        return out

    def snapshot(self) -> dict:
        burn = self.burn()
        return {
            "objectives": self.objectives or None,
            "burn": burn,
            "burn_max": max(burn.values()) if burn else 0.0,
            "breached": sorted(k for k, v in burn.items() if v > 1.0),
            "counts": {"jobs": self.jobs, "failed": self.failed,
                       "window": len(self.window)},
        }


# ------------------------------------------------------------ forecaster


class CapacityForecaster:
    """Backlog -> time-to-drain -> recommended worker count.

    ``horizon_s`` is the drain target: recommend enough workers that
    the current backlog drains within one horizon.  Every input lands
    in the forecast dict, and ``recommended_workers`` is derived from
    the PUBLISHED (rounded) ``backlog_s``, so flow_doctor --slo can
    re-derive it from the document alone and compare exactly."""

    def __init__(self, horizon_s: float = 60.0, max_workers: int = 64):
        self.horizon_s = float(horizon_s)
        self.max_workers = int(max_workers)

    def forecast(self, rate_nets_per_s: float, backlog_nets: float,
                 workers_alive: int = 1) -> dict:
        rate = max(float(rate_nets_per_s), 1e-9)
        backlog_s = round(max(0.0, float(backlog_nets)) / rate, 6)
        alive = max(1, int(workers_alive))
        return {
            "rate_nets_per_s": round(rate, 6),
            "backlog_nets": float(backlog_nets),
            "backlog_s": backlog_s,
            "workers_alive": alive,
            "time_to_drain_s": round(backlog_s / alive, 6),
            "horizon_s": self.horizon_s,
            "max_workers": self.max_workers,
            "recommended_workers": recommended_workers(
                backlog_s, self.horizon_s, self.max_workers),
        }


def recommended_workers(backlog_s: float, horizon_s: float,
                        max_workers: int) -> int:
    """The shared recommendation formula (publisher AND doctor): at
    least one worker, enough to drain the backlog within one horizon,
    never more than the fleet cap."""
    if backlog_s <= 0:
        return 1
    need = math.ceil(backlog_s / max(1e-9, float(horizon_s)))
    return max(1, min(int(max_workers), need))


# ----------------------------------------------------------------- plane


class SLOPlane:
    """The daemon-side composite: waterfalls + digests + trackers.

    The daemon calls ``observe_admit`` / ``observe_slice`` /
    ``observe_terminal`` with readings from ITS OWN injectable clock
    (fake clocks in tests skew freely), and ``snapshot`` at the
    existing slice-boundary publish sites.  One terminal job feeds the
    digests exactly once — so every digest's count equals the number
    of terminal jobs this plane observed, the invariant the doctor's
    count rules lean on."""

    def __init__(self, objectives: Optional[Dict[str, dict]] = None,
                 window: int = 512, max_waterfalls: int = 256):
        self.objectives = dict(objectives or {})
        self.window = int(window)
        self.digest_e2e = QuantileDigest()
        self.digest_queue_wait = QuantileDigest()
        self.trackers: Dict[str, SLOTracker] = {}
        self._tracks: Dict[str, _JobTrack] = {}
        self.waterfalls: deque = deque(maxlen=max(1, int(max_waterfalls)))
        self.recorded = 0
        self.untracked_terminals = 0

    # -- observation hooks (host clock readings only)

    def observe_admit(self, job_id: str, tenant: str, t_admit: float,
                      lag_s: float = 0.0,
                      failover: bool = False) -> None:
        if job_id in self._tracks:
            return        # idempotent: replayed admits keep the first
        self._tracks[job_id] = _JobTrack(
            tenant, _us(t_admit), _us(lag_s), failover)

    def observe_slice(self, job_id: str, t_start: float, t_end: float,
                      compile_s: float = 0.0, stall_s: float = 0.0,
                      attempts: int = 0) -> None:
        tk = self._tracks.get(job_id)
        if tk is None:
            return
        start_us, end_us = _us(t_start), _us(t_end)
        wall = max(0, end_us - start_us)
        if tk.first_slice_us is None:
            tk.first_slice_us = start_us
        elif attempts > tk.prev_attempts:
            # the gap before a RETRY slice is the queue's backoff hold
            tk.backoff_us += max(0, start_us - tk.prev_end_us)
        tk.prev_attempts = max(tk.prev_attempts, int(attempts))
        c = min(wall, max(0, _us(compile_s)))
        s = min(wall - c, max(0, _us(stall_s)))
        tk.compile_us += c
        tk.stall_us += s
        tk.exec_us += wall - c - s
        tk.prev_end_us = end_us
        tk.n_slices += 1

    def runstore_fields(self, job_id: str, now: float) -> dict:
        """The optional corpus latency columns (runstore SCHEMA v2):
        queue_wait_s / e2e_s / n_failovers for a still-tracked job,
        measured at record time — the service writes its corpus row
        inside the job's final slice, so ``e2e_s`` is latency-so-far
        at that instant (the waterfall, finalized at the terminal
        scan, is the exact-decomposition artifact)."""
        tk = self._tracks.get(job_id)
        if tk is None:
            return {}
        now_us = _us(now)
        first = tk.first_slice_us if tk.first_slice_us is not None \
            else now_us
        qw_us = max(0, first - tk.admit_us)
        if not tk.failover:
            qw_us += tk.lag_us
        e2e_us = max(0, now_us - (tk.admit_us - tk.lag_us))
        return {"queue_wait_s": round(qw_us / 1e6, 6),
                "e2e_s": round(e2e_us / 1e6, 6),
                "n_failovers": int(tk.failover)}

    def observe_terminal(self, job_id: str, state: str,
                         t_term: float) -> Optional[dict]:
        tk = self._tracks.pop(job_id, None)
        if tk is None:
            self.untracked_terminals += 1
            return None
        term_us = _us(t_term)
        # submit instant = admit minus the measured inbox lag; on a
        # failover re-admission the lag is the orphaned window, its own
        # stage, not queue wait
        submit_us = tk.admit_us - tk.lag_us
        e2e_us = max(0, term_us - submit_us)
        first = tk.first_slice_us if tk.first_slice_us is not None \
            else term_us
        queue_wait_us = max(0, first - tk.admit_us)
        failover_gap_us = tk.lag_us if tk.failover else 0
        if not tk.failover:
            queue_wait_us += tk.lag_us
        stages = {
            "queue_wait": queue_wait_us,
            "compile": tk.compile_us,
            "exec": tk.exec_us,
            "stall": tk.stall_us,
            "backoff": tk.backoff_us,
            "failover_gap": failover_gap_us,
        }
        stages["other"] = e2e_us - sum(stages.values())   # signed
        wf = {
            "job_id": job_id, "tenant": tk.tenant, "state": state,
            "e2e_us": e2e_us, "e2e_s": round(e2e_us / 1e6, 6),
            "stages_us": stages,
            "stages_s": {k: round(v / 1e6, 6)
                         for k, v in stages.items()},
            "n_slices": tk.n_slices,
            "n_failovers": int(tk.failover),
        }
        e2e_s = e2e_us / 1e6
        qw_s = queue_wait_us / 1e6
        self.digest_e2e.add(e2e_s)
        self.digest_queue_wait.add(qw_s)
        tr = self.trackers.get(tk.tenant)
        if tr is None:
            tr = self.trackers[tk.tenant] = SLOTracker(
                tk.tenant, self.objectives.get(tk.tenant),
                window=self.window)
        tr.digest_e2e.add(e2e_s)
        tr.digest_queue_wait.add(qw_s)
        tr.observe(e2e_s, qw_s,
                   failed=state in ("failed", "timeout"))
        self.waterfalls.append(wf)
        self.recorded += 1
        return wf

    # -- publishing

    def gauges(self, forecast: Optional[dict] = None) -> Dict[str, Any]:
        """Gauge values published at snapshot sites.  Keys are
        UNPREFIXED: the daemon owns the metric namespace and registers
        each as ``route.slo.<key>`` (the family OBSERVABILITY.md's
        registry table documents) — this module stays namespace-free
        like the rest of the stdlib-only obs core."""
        burns = [t.snapshot() for t in self.trackers.values()]
        g = {
            "terminal_jobs": self.digest_e2e.count,
            "e2e_p50_s": round(self.digest_e2e.quantile(.50), 6),
            "e2e_p95_s": round(self.digest_e2e.quantile(.95), 6),
            "e2e_p99_s": round(self.digest_e2e.quantile(.99), 6),
            "queue_wait_p95_s": round(
                self.digest_queue_wait.quantile(.95), 6),
            "burn_max": max(
                [b["burn_max"] for b in burns], default=0.0),
            "breaches": sum(len(b["breached"]) for b in burns),
        }
        if forecast:
            g["backlog_s"] = forecast["backlog_s"]
            g["time_to_drain_s"] = forecast["time_to_drain_s"]
            g["recommended_workers"] = forecast["recommended_workers"]
        return g

    def snapshot(self, forecast: Optional[dict] = None) -> dict:
        tenants = {}
        for t, tr in sorted(self.trackers.items()):
            snap = tr.snapshot()
            snap["digest_e2e"] = tr.digest_e2e.to_dict()
            snap["digest_queue_wait"] = tr.digest_queue_wait.to_dict()
            tenants[t] = snap
        return {
            "schema": SLO_SCHEMA,
            "terminal_jobs": self.digest_e2e.count,
            "untracked_terminals": self.untracked_terminals,
            "digest_e2e": self.digest_e2e.to_dict(),
            "digest_queue_wait": self.digest_queue_wait.to_dict(),
            "tenants": tenants,
            "waterfalls": list(self.waterfalls),
            "waterfalls_recorded": self.recorded,
            "waterfalls_dropped": self.recorded - len(self.waterfalls),
            "forecast": forecast,
        }


# ------------------------------------------------------------ fleet merge


def merge_slo_sections(sections: Dict[str, dict],
                       forecast: Optional[dict] = None) -> dict:
    """Supervisor-side merge of per-worker slo sections into ONE fleet
    section.  Digests merge bin-wise (exact) and tenant counts sum;
    burn cannot be recomputed without the raw per-job windows, so the
    fleet view reports each tenant's worst per-worker burn (a
    conservative, order-independent aggregate) plus the union of
    breached objectives.  ``shards`` records each worker's digest count so the
    doctor can assert merged count == sum of shards."""
    shard_counts: Dict[str, int] = {}
    e2e_docs: List[dict] = []
    qw_docs: List[dict] = []
    tenants: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    untracked = 0
    for worker, sec in sorted(sections.items()):
        if not isinstance(sec, dict):
            errors[worker] = "slo section missing"
            continue
        try:
            d = sec.get("digest_e2e") or {}
            shard_counts[worker] = int(d.get("count", 0))
            e2e_docs.append(d)
            if sec.get("digest_queue_wait"):
                qw_docs.append(sec["digest_queue_wait"])
        except (TypeError, ValueError) as e:
            errors[worker] = f"bad digest: {e}"
            continue
        untracked += int(sec.get("untracked_terminals") or 0)
        for t, snap in (sec.get("tenants") or {}).items():
            cur = tenants.setdefault(t, {
                "objectives": snap.get("objectives"),
                "burn_max": 0.0, "breached": [],
                "counts": {"jobs": 0, "failed": 0},
                "digests": []})
            cur["burn_max"] = max(cur["burn_max"],
                                  float(snap.get("burn_max") or 0.0))
            cur["breached"] = sorted(
                set(cur["breached"]) | set(snap.get("breached") or ()))
            for k in ("jobs", "failed"):
                cur["counts"][k] += int(
                    (snap.get("counts") or {}).get(k) or 0)
            if snap.get("digest_e2e"):
                cur["digests"].append(snap["digest_e2e"])
    for t, cur in tenants.items():
        docs = cur.pop("digests")
        try:
            cur["digest_e2e"] = merge_digest_dicts(docs)
        except ValueError as e:
            cur["digest_e2e"] = None
            errors[f"tenant:{t}"] = str(e)
    try:
        merged_e2e = merge_digest_dicts(e2e_docs)
    except ValueError as e:
        merged_e2e, errors["fleet:e2e"] = None, str(e)
    try:
        merged_qw = merge_digest_dicts(qw_docs)
    except ValueError as e:
        merged_qw, errors["fleet:queue_wait"] = None, str(e)
    return {
        "schema": SLO_SCHEMA,
        "shards": shard_counts,
        "terminal_jobs": sum(shard_counts.values()),
        "untracked_terminals": untracked,
        "digest_e2e": merged_e2e,
        "digest_queue_wait": merged_qw,
        "tenants": tenants,
        "forecast": forecast,
        "errors": errors or None,
    }


# ------------------------------------------------------------- file names


def slo_name(worker: str = "") -> str:
    """slo.json (solo) / slo.<worker>.json (fleet member) — written
    beside telemetry.json at the same snapshot sites."""
    return f"slo.{worker}.json" if worker else "slo.json"


def read_slo(inbox_dir: str, worker: str = "") -> Optional[dict]:
    """Tolerant reader for the published snapshot (None on any
    problem: the file is a live view, racing a writer is normal)."""
    try:
        with open(os.path.join(inbox_dir, slo_name(worker))) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None
