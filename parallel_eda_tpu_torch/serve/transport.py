"""Network transport for the route daemon fleet: a stdlib HTTP
listener that speaks the durable inbox protocol, and a retrying
idempotent client (the counterpart of the JAX package's
serve/transport.py: the same endpoints, headers, counters and
``route.fleet.*`` metrics).

The listener is deliberately thin: a ``POST /submit`` is translated
into exactly the same two durable operations every inbox submission
already makes — atomic spec-file install, then ONE ``O_APPEND`` line
to ``submit.jsonl`` (``daemon.submit_job``) — so every crash-recovery
guarantee of the file protocol carries over unchanged.  The network
adds only *delivery* failure modes, and those are the client's job:

* the client assigns the ``job_id`` BEFORE the first attempt, so a
  resubmission after a dropped connection hits the daemons' journal
  dedupe and is free — retries are idempotent by construction;
* retries use capped exponential backoff with a hard attempt cap, and
  each request carries ``X-Attempt``/``X-Retry-Cap`` headers so the
  server can *observe* client retry behaviour (the doctor's
  "transport retries bounded" rule reads those counters);
* the ``transport.drop`` chaos site fires server-side BEFORE the
  durable writes: a dropped request loses nothing, and the retry
  resubmits the identical payload.

Stdlib (http.server/urllib) + obs.metrics only — the transport must
stay alive while the routing layer is on fire.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib import error as urlerror
from urllib import request as urlrequest

from ..obs.metrics import get_metrics
from .daemon import submit_job


class InboxHTTPServer:
    """HTTP front end over one durable inbox directory.

    Endpoints::

        POST /submit    {"spec": {...}, "tenant", "priority",
                         "deadline_s", "job_id"}  ->  {"job_id": ...}
        GET  /healthz   liveness + inbox path
        GET  /status    transport counters + per-worker live state
        GET  /metrics   the fleet's live telemetry: every worker's
                        atomically-published snapshot (job table, held
                        leases, metric values) read back from
                        ``telemetry.<worker>.json`` — pure file reads
                        on the HTTP thread, so a scrape NEVER forces a
                        device sync in any worker

    ``plan`` arms the ``transport.drop`` site: a scheduled firing
    closes the connection before any durable write, exactly the
    failure the client's idempotent retry exists for."""

    def __init__(self, inbox_dir: str, host: str = "127.0.0.1",
                 port: int = 0, plan=None):
        self.inbox_dir = inbox_dir
        self.plan = plan
        self._lock = threading.Lock()
        self.requests = 0
        self.drops = 0
        self.retries = 0          # resubmissions observed (X-Attempt>1)
        self.max_attempt_seen = 0
        self.retry_cap_seen = 0   # largest X-Retry-Cap a client declared
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "parallel-eda-inbox/1"

            def log_message(self, fmt, *args):  # quiet by design
                pass

            def _reply(self, code: int, doc: dict) -> None:
                blob = json.dumps(doc, sort_keys=True).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True,
                                      "inbox": outer.inbox_dir})
                elif self.path == "/status":
                    self._reply(200, outer.status())
                elif self.path == "/metrics":
                    self._reply(200, outer.metrics_snapshot())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/submit":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                outer._observe_attempt(self.headers)
                fault = outer.plan.fire("transport.drop") \
                    if outer.plan is not None else None
                if fault is not None:
                    # chaos: die BEFORE the durable writes — the
                    # client's idempotent resubmission loses nothing
                    with outer._lock:
                        outer.drops += 1
                    get_metrics().counter(
                        "route.fleet.transport_drops").inc()
                    self.close_connection = True
                    self.connection.close()
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n).decode("utf-8"))
                    if not isinstance(body, dict) \
                            or not isinstance(body.get("spec"), dict):
                        raise ValueError("submission needs a spec object")
                except (ValueError, UnicodeDecodeError) as e:
                    # torn/garbled request: terminal 400, nothing was
                    # written — the inbox never sees a partial job
                    self._reply(400, {"error": f"bad submission: {e}"})
                    return
                trace = body.get("trace")
                job_id = submit_job(
                    outer.inbox_dir, body["spec"],
                    tenant=str(body.get("tenant") or "default"),
                    priority=int(body.get("priority", 0)),
                    deadline_s=body.get("deadline_s"),
                    job_id=str(body.get("job_id") or ""),
                    trace=trace if isinstance(trace, dict) else None)
                self._reply(200, {"job_id": job_id, "ok": True})

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _observe_attempt(self, headers) -> None:
        m = get_metrics()
        m.counter("route.fleet.transport_requests").inc()
        try:
            attempt = int(headers.get("X-Attempt", 1))
            cap = int(headers.get("X-Retry-Cap", 0))
        except (TypeError, ValueError):
            attempt, cap = 1, 0
        with self._lock:
            self.requests += 1
            self.max_attempt_seen = max(self.max_attempt_seen, attempt)
            self.retry_cap_seen = max(self.retry_cap_seen, cap)
            if attempt > 1:
                self.retries += 1
                m.counter("route.fleet.transport_retries").inc()

    def start(self) -> "InboxHTTPServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="inbox-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def summary(self) -> dict:
        with self._lock:
            return {"url": self.url, "inbox": self.inbox_dir,
                    "requests": self.requests, "drops": self.drops,
                    "retries": self.retries,
                    "max_attempt_seen": self.max_attempt_seen,
                    "retry_cap_seen": self.retry_cap_seen}

    def _telemetry_docs(self) -> dict:
        """Every worker's atomically-published telemetry snapshot,
        keyed by worker id ("daemon" for a solo instance).  Snapshots
        are written tmp+os.replace at slice boundaries, so a read here
        is never torn; a missing/unparsable file just means that
        worker has not published yet (counted, not fatal)."""
        out = {}
        try:
            names = sorted(os.listdir(self.inbox_dir))
        except OSError:
            return out
        for name in names:
            if name == "telemetry.json":
                key = "daemon"
            elif name.startswith("telemetry.") \
                    and name.endswith(".json"):
                key = name[len("telemetry."):-len(".json")]
            else:
                continue
            try:
                with open(os.path.join(self.inbox_dir, name)) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict):
                    raise ValueError("telemetry is not an object")
            except (OSError, ValueError, UnicodeDecodeError):
                get_metrics().counter(
                    "route.fleet.telemetry_read_errors").inc()
                continue
            out[key] = doc
        return out

    def metrics_snapshot(self) -> dict:
        """``GET /metrics``: the fleet's live state as of each
        worker's last slice boundary."""
        get_metrics().counter("route.fleet.metrics_scrapes").inc()
        return {"ts": time.time(),
                "workers": self._telemetry_docs(),
                "transport": self.summary()}

    def status(self) -> dict:
        """``GET /status``: transport counters (the historical shape)
        enriched with a condensed per-worker liveness view."""
        doc = self.summary()
        workers = {}
        for key, t in self._telemetry_docs().items():
            workers[key] = {
                "cycle": t.get("cycle"),
                "queue_depth": t.get("queue_depth"),
                "in_flight": t.get("in_flight"),
                "held_leases": t.get("held_leases"),
                "draining": t.get("draining")}
        doc["workers"] = workers
        return doc


class TransportError(RuntimeError):
    """Submission failed after the full retry budget."""


class TransportClient:
    """Idempotent submitter with timeout + capped exponential backoff.

    The ``job_id`` is fixed before the first attempt, so every retry
    of a dropped/timed-out request is a byte-identical resubmission
    the daemons' journal dedupe collapses — at-least-once delivery
    with exactly-once admission."""

    def __init__(self, url: str, timeout_s: float = 5.0,
                 max_attempts: int = 4, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0, backoff_max_s: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.backoff_max_s = float(backoff_max_s)
        self._sleep = sleep
        self.retries = 0          # retries spent over this client's life

    def _post(self, path: str, doc: dict, attempt: int) -> dict:
        blob = json.dumps(doc, sort_keys=True).encode("utf-8")
        req = urlrequest.Request(
            self.url + path, data=blob, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Attempt": str(attempt),
                     "X-Retry-Cap": str(self.max_attempts)})
        with urlrequest.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def submit(self, spec: dict, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               job_id: str = "") -> str:
        if not job_id:
            job_id = f"{tenant}-{spec.get('name') or spec.get('seed', 0)}"
        job_id = "".join(c if (c.isalnum() or c in "-_.") else "_"
                         for c in job_id)
        doc = {"spec": spec, "tenant": tenant, "priority": int(priority),
               "job_id": job_id,
               # trace context, stamped ONCE before the first attempt:
               # retries resubmit the identical payload, so the origin
               # instant survives any number of redeliveries
               "trace": {"submit_wall": round(time.time(), 6),
                         "client": "transport"}}
        if deadline_s:
            doc["deadline_s"] = float(deadline_s)
        last: Optional[Exception] = None
        for attempt in range(1, self.max_attempts + 1):
            if attempt > 1:
                self.retries += 1
                back = min(self.backoff_max_s,
                           self.backoff_s
                           * self.backoff_mult ** (attempt - 2))
                self._sleep(back)
            try:
                out = self._post("/submit", doc, attempt)
                got = str(out.get("job_id") or "")
                if got != job_id:
                    raise TransportError(
                        f"server acknowledged {got!r} for submission "
                        f"{job_id!r} — idempotency key mismatch")
                return got
            except urlerror.HTTPError as e:
                if e.code < 500:
                    # terminal client error (bad spec): retrying the
                    # identical payload cannot succeed
                    raise TransportError(
                        f"submit {job_id}: HTTP {e.code} "
                        f"{e.read().decode('utf-8', 'replace')}") from e
                last = e
            except (urlerror.URLError, ConnectionError, OSError,
                    json.JSONDecodeError) as e:
                # dropped/refused/timed-out/torn-response: the retry
                # resubmits idempotently
                last = e
        raise TransportError(
            f"submit {job_id}: all {self.max_attempts} attempts failed "
            f"(last: {type(last).__name__}: {last})")

    def healthz(self) -> dict:
        with urlrequest.urlopen(self.url + "/healthz",
                                timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
