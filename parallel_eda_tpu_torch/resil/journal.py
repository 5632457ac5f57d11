"""Daemon job-state journal, liveness heartbeat file, and job leases
(the counterpart of parallel_eda_tpu/resil/journal.py: the JSON
documents are the contract, so a journal, heartbeat or lease written by
either package reads the same in the other).

The route daemon (serve/daemon.py) survives its own death by writing
small durable artifacts next to its inbox:

* **journal** — one JSON document of every known job's admission state
  (accepted/in-flight/terminal, with rejection reasons and shed
  causes).  Written atomically — tmp + fsync + rename, the same dance
  as ``resil/checkpoint.py`` — with the previous good generation kept
  as ``.prev`` fallback.  A restarted daemon re-admits every
  ``in_flight`` entry idempotently (dedupe on job_id) and resumes it
  from its durable route checkpoint, so a SIGKILL between windows
  changes timing only, never QoR.
* **heartbeat** — a tiny liveness file rewritten (atomically) every
  ``interval_s``; its wall-clock age is how an external watcher (or
  ``python -m parallel_eda_tpu_torch daemon status``) distinguishes
  "busy" from "dead".
  The daemon also tracks its own worst inter-beat gap, which
  ``tools/flow_doctor.py --daemon-summary`` gates: a daemon that stops
  beating while claiming to be alive is unhealthy.
* **leases** — one tiny two-generation record per job giving a worker
  FLEET-WIDE exclusive ownership of that job.  Acquisition is an
  ``os.link`` of a private temp file (exactly one winner, no locks);
  renewal rotates the previous generation to ``.prev``; expiry rides
  the heartbeat clock (monotonic, system-wide on Linux) so a SIGKILLed
  worker's lease lapses and a peer may *steal* it — an ``os.rename``
  with, again, exactly one winner — and resume the job from its
  durable checkpoint.  Completed jobs keep a released terminal record
  so no peer ever re-runs them.

All stores are deliberately dependency-light (stdlib + obs.metrics):
they must stay writable while the routing layer is on fire.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer

JOURNAL_SCHEMA = 1


def _atomic_write_json(path: str, doc: dict, rotate: bool = False) -> None:
    """tmp + fsync + rename (checkpoint.py conventions); with
    ``rotate`` the current generation is kept as ``path + ".prev"`` so
    a torn write can never cost more than one update."""
    blob = json.dumps(doc, sort_keys=True, default=str).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    if rotate and os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


class JournalStore:
    """Atomic two-generation journal of daemon job states.

    The journal is one document, not an append log: the daemon's whole
    job table is small (bounded by the admission controller), and a
    single atomic rewrite per cycle means recovery never has to replay
    anything — load() is the complete truth as of the last flush."""

    NAME = "journal.json"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.NAME)
        self.writes = 0

    def save(self, jobs: dict, extra: Optional[dict] = None) -> str:
        """Flush the full job table (job_id -> state dict) plus any
        daemon bookkeeping (``extra``, e.g. the consumed inbox
        offset)."""
        doc = {"schema": JOURNAL_SCHEMA, "ts": time.time(),
               "jobs": jobs}
        if extra:
            doc.update(extra)
        _atomic_write_json(self.path, doc, rotate=True)
        self.writes += 1
        get_metrics().counter("route.resil.journal_writes").inc()
        return self.path

    def load(self) -> Optional[dict]:
        """Newest verifiable journal document, or None (fresh start).
        A generation that fails to parse falls back to ``.prev`` with
        a counted fallback, mirroring CheckpointStore.load()."""
        m = get_metrics()
        for cand in (self.path, self.path + ".prev"):
            try:
                with open(cand, "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            try:
                doc = json.loads(blob.decode("utf-8"))
                if not isinstance(doc, dict) \
                        or not isinstance(doc.get("jobs"), dict):
                    raise ValueError("journal has no job table")
                if int(doc.get("schema", 0)) > JOURNAL_SCHEMA:
                    raise ValueError("journal schema newer than reader")
            except (ValueError, UnicodeDecodeError) as e:
                m.counter("route.resil.journal_fallbacks").inc()
                tr = get_tracer()
                if tr is not None:
                    tr.instant("route.resil.journal.fallback",
                               cat="resil", file=cand, error=str(e))
                continue
            m.counter("route.resil.journal_recoveries").inc()
            return doc
        return None


class Heartbeat:
    """Liveness heartbeat file + worst-gap tracker.

    ``beat()`` is called once per daemon cycle; it rewrites the file
    (atomically) only when ``interval_s`` has elapsed, and records the
    worst observed inter-beat gap — the number the doctor's
    heartbeat-gap rule checks against ``interval_s``."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.path = path
        self.interval_s = float(interval_s)
        self._clock = clock
        self._wall = wall
        self._t0 = clock()
        self._last: Optional[float] = None
        self.beats = 0
        self.max_gap_s = 0.0

    def beat(self, **state) -> bool:
        """Write the heartbeat if due.  Extra ``state`` (queue depth,
        cycle counter) rides along for ``status`` readers."""
        now = self._clock()
        if self._last is not None:
            gap = now - self._last
            if gap < self.interval_s:
                return False
            self.max_gap_s = max(self.max_gap_s, gap)
            get_metrics().gauge("route.daemon.heartbeat_age_s").set(
                round(gap, 3))
        self._last = now
        self.beats += 1
        get_metrics().counter("route.daemon.heartbeats").inc()
        _atomic_write_json(self.path, {
            "ts": self._wall(), "mono": now, "pid": os.getpid(),
            "uptime_s": round(now - self._t0, 3),
            "interval_s": self.interval_s, **state})
        return True

    def summary(self) -> dict:
        return {"file": self.path, "interval_s": self.interval_s,
                "beats": self.beats,
                "max_gap_s": round(self.max_gap_s, 3)}

    @staticmethod
    def read(path: str, wall: Callable[[], float] = time.time,
             mono: Callable[[], float] = time.monotonic) -> dict:
        """Read a heartbeat file from outside the daemon; returns the
        document plus its ``age_s`` (inf when missing or unreadable —
        absent liveness is indistinguishable from dead).

        Age prefers the beat's monotonic stamp: CLOCK_MONOTONIC is
        system-wide on Linux, so a reader on the same host ages a peer
        worker's beat without trusting the wall clock — an NTP step
        can neither fake a dead worker nor mask a real one.  A
        negative monotonic age (different boot, or a pre-``mono``
        writer) falls back to the wall-clock difference, flagged via
        ``age_src``."""
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
            if not isinstance(doc, dict):
                raise ValueError("not an object")
        except (OSError, ValueError, UnicodeDecodeError) as e:
            return {"age_s": float("inf"), "error": str(e)}
        m, ts = doc.get("mono"), doc.get("ts")
        if isinstance(m, (int, float)) and mono() - m >= 0.0:
            doc["age_s"], doc["age_src"] = mono() - m, "mono"
        elif isinstance(ts, (int, float)):
            doc["age_s"], doc["age_src"] = wall() - ts, "wall"
        else:
            doc["age_s"] = float("inf")
        return doc


LEASE_SCHEMA = 1


class LeaseStore:
    """Atomic per-job ownership leases for a replicated worker fleet.

    One record per job under ``dir/<job_id>.lease``.  The protocol:

    * ``acquire`` — create the record via hard-link from a private
      temp file.  ``os.link`` fails with EEXIST if ANY record exists,
      so exactly one worker wins without locks or fsync races.
    * ``renew`` — atomic rewrite (tmp + fsync + replace) keeping the
      previous generation as ``.prev``, pushing the expiry forward on
      both the monotonic and wall clocks.  Renewal is refused if the
      record no longer names this worker: a stolen lease *fences* its
      old owner, which must abandon the job (``owns()`` is checked
      before every slice).
    * ``steal`` — only a lease whose expiry has lapsed and that is not
      released may be stolen: ``os.rename`` the record aside (one
      winner; the loser's rename raises) and acquire fresh with the
      generation bumped.  The renamed ``.steal.<worker>`` file stays
      behind as a forensic record of the failover.
    * ``release`` — terminal rewrite with ``released: true``.  The
      record is kept, NOT unlinked: a released lease can never expire,
      so no peer re-admits a finished job.

    Expiry compares the record's absolute monotonic deadline against
    this process's monotonic clock — valid across processes on the
    same Linux host — with the wall-clock deadline as fallback for
    records written before a reboot."""

    SUFFIX = ".lease"

    def __init__(self, directory: str, worker: str,
                 ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.worker = str(worker)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._wall = wall

    def path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}{self.SUFFIX}")

    def _doc(self, job_id: str, generation: int, state: str,
             **extra) -> dict:
        return {"schema": LEASE_SCHEMA, "job_id": job_id,
                "worker": self.worker, "generation": int(generation),
                "state": state, "released": False,
                "ttl_s": self.ttl_s,
                "expires_mono": self._clock() + self.ttl_s,
                "expires_wall": self._wall() + self.ttl_s,
                "renewals": 0, **extra}

    def _link_new(self, path: str, doc: dict) -> bool:
        """Create ``path`` atomically-exclusively via os.link; the
        loser of a race sees FileExistsError and reports failure."""
        tmp = f"{path}.tmp.{os.getpid()}.{self.worker}"
        blob = json.dumps(doc, sort_keys=True).encode("utf-8")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            return True
        except OSError:
            return False
        finally:
            os.unlink(tmp)

    def read(self, job_id: str) -> Optional[dict]:
        """Current lease record (``.prev`` fallback on a torn write),
        or None when the job has never been leased."""
        path = self.path(job_id)
        for cand in (path, path + ".prev"):
            try:
                with open(cand, "rb") as f:
                    doc = json.loads(f.read().decode("utf-8"))
                if isinstance(doc, dict) and doc.get("job_id"):
                    return doc
            except (OSError, ValueError, UnicodeDecodeError):
                continue
        return None

    def expired(self, doc: Optional[dict]) -> bool:
        """True when the record's deadline has lapsed (a released
        record never expires).  Prefers the monotonic deadline."""
        if not isinstance(doc, dict) or doc.get("released"):
            return False
        em = doc.get("expires_mono")
        if isinstance(em, (int, float)) and em >= 0:
            return self._clock() > em
        ew = doc.get("expires_wall")
        return isinstance(ew, (int, float)) and self._wall() > ew

    def acquire(self, job_id: str, state: str = "running",
                **extra) -> bool:
        """Claim a never-leased job.  Returns False when any record
        exists (held, expired-but-unstolen, or released) — claiming
        an expired lease must go through ``steal`` so the generation
        bump and forensic record happen."""
        ok = self._link_new(self.path(job_id),
                            self._doc(job_id, 1, state, **extra))
        if ok:
            get_metrics().counter("route.fleet.leases_acquired").inc()
            tr = get_tracer()
            if tr is not None:
                tr.instant("route.fleet.lease.acquire", cat="fleet",
                           job_id=job_id, worker=self.worker)
        return ok

    def renew(self, job_id: str, state: Optional[str] = None,
              **extra) -> bool:
        """Push the expiry forward.  Refused (False, counted as a
        lost lease) when the record was stolen or released under us."""
        doc = self.read(job_id)
        if not doc or doc.get("worker") != self.worker \
                or doc.get("released"):
            get_metrics().counter("route.fleet.leases_lost").inc()
            return False
        doc.update(expires_mono=self._clock() + self.ttl_s,
                   expires_wall=self._wall() + self.ttl_s,
                   renewals=int(doc.get("renewals", 0)) + 1, **extra)
        if state is not None:
            doc["state"] = state
        _atomic_write_json(self.path(job_id), doc, rotate=True)
        get_metrics().counter("route.fleet.lease_renewals").inc()
        return True

    def steal(self, job_id: str) -> bool:
        """Take over an EXPIRED peer lease.  The rename-aside has
        exactly one winner; the fresh record bumps the generation and
        names the previous owner for the post-mortem."""
        doc = self.read(job_id)
        if not doc or doc.get("released") or not self.expired(doc):
            return False
        path = self.path(job_id)
        try:
            os.rename(path, f"{path}.steal.{self.worker}")
        except OSError:
            return False      # a peer won the steal race
        try:                   # stale .prev must not shadow the steal
            os.unlink(path + ".prev")
        except OSError:
            pass
        m = get_metrics()
        m.counter("route.fleet.leases_expired").inc()
        ok = self._link_new(path, self._doc(
            job_id, int(doc.get("generation", 0)) + 1, "stolen",
            stolen_from=doc.get("worker")))
        if ok:
            m.counter("route.fleet.lease_steals").inc()
            tr = get_tracer()
            if tr is not None:
                # the steal link: the instant that joins a failed-over
                # job's chain across two worker tracks in a merged trace
                tr.instant("route.fleet.lease.steal", cat="fleet",
                           job_id=job_id, worker=self.worker,
                           stolen_from=doc.get("worker"),
                           generation=int(doc.get("generation", 0)) + 1)
        return ok

    def release(self, job_id: str, state: str = "done") -> bool:
        """Terminal rewrite: mark released (kept forever) so no peer
        can ever re-admit the job."""
        doc = self.read(job_id)
        if not doc or doc.get("worker") != self.worker:
            return False
        doc.update(released=True, state=state,
                   released_wall=self._wall())
        _atomic_write_json(self.path(job_id), doc, rotate=True)
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.fleet.lease.release", cat="fleet",
                       job_id=job_id, worker=self.worker, state=state)
        return True

    def owns(self, job_id: str) -> bool:
        """Fencing check — run before every slice: does the CURRENT
        record still name this worker, unreleased?"""
        doc = self.read(job_id)
        return bool(doc and doc.get("worker") == self.worker
                    and not doc.get("released"))

    def force_expire(self, job_id: str) -> bool:
        """Chaos hook (``lease.steal`` site): collapse the deadline to
        *now* under the owner, without telling it — peers see an
        expired lease and steal; the old owner is fenced at its next
        ``owns()`` check."""
        doc = self.read(job_id)
        if not doc or doc.get("released"):
            return False
        doc.update(expires_mono=self._clock(),
                   expires_wall=self._wall(), forced=True)
        _atomic_write_json(self.path(job_id), doc, rotate=True)
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.fleet.lease.force_expire", cat="fleet",
                       job_id=job_id, worker=self.worker)
        return True

    def scan(self) -> dict:
        """All current lease records, job_id -> doc."""
        out = {}
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(self.SUFFIX):
                continue
            doc = self.read(name[:-len(self.SUFFIX)])
            if doc:
                out[doc["job_id"]] = doc
        return out

    def held(self) -> list:
        """job_ids whose current record names this worker, live."""
        return sorted(j for j, d in self.scan().items()
                      if d.get("worker") == self.worker
                      and not d.get("released"))

    def summary(self) -> dict:
        docs = self.scan()
        return {"dir": self.dir, "worker": self.worker,
                "ttl_s": self.ttl_s, "leases": len(docs),
                "held": self.held(),
                "released": sorted(j for j, d in docs.items()
                                   if d.get("released")),
                "expired": sorted(j for j, d in docs.items()
                                  if self.expired(d))}
