"""Append-only, scenario-keyed run corpus: the counterpart of
parallel_eda_tpu/obs/runstore.py, with its record schema, so that rows
of both packages share one reader.

Every run that appends (the route service's finished jobs, here)
writes ONE self-describing record to ``runs/<scenario>.jsonl`` — schema
version, git rev, backend and device kind, scenario id + config hash,
QoR, the gauge snapshot, per-iteration series, and a rasterized
congestion heatmap distilled from the router's per-window
``top_overused`` ids.  The reader (``read_runs_ex``) skips a torn or
corrupt line with a count instead of failing: the service's
``corpus.torn`` fault site writes such a line ahead of a real append.

Deliberately STDLIB-ONLY: the JAX package's tools load this schema by
file path and must run anywhere the corpus lands.  Helpers that need
array data (node spans for the heatmap) take plain sequences.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import time
from typing import Optional

# v2 adds OPTIONAL multi-tenant provenance: ``tenant`` / ``job_id``
# string fields on records emitted by the route service
# (serve/service.py).  Optional means v1 rows (and v2 writers with no
# tenancy) stay valid — readers group by tenant only when present.
SCHEMA_VERSION = 2

# every corpus record must carry these, with these types — the schema
# floor validate_record() rejects on.  Everything else (qor, gauges,
# series, congestion, detail, tags) is optional by design: older eras
# and non-route metrics carry less, and readers must tolerate that.
REQUIRED_FIELDS = (
    ("schema_version", int),
    ("ts", str),
    ("git_rev", str),
    ("scenario", str),
    ("config_hash", str),
    ("backend", str),
    ("device_kind", str),
    ("metric", str),
    ("value", (int, float)),
    ("unit", str),
)

# optional string fields: validated for type when present, never
# required (the v2 tenancy columns, plus the plane storage dtype a
# reduced-precision run routed with — absent means f32, so v1/v2 rows
# written before the dtype era stay valid and comparable)
OPTIONAL_STR_FIELDS = ("tenant", "job_id", "plane_dtype")

# optional int fields, same contract: the device-mesh shard count a
# multi-chip run relaxed with (scale_bench --mesh), and the number of
# fleet failovers a served job survived (daemon-stamped).  Absent
# means 1 shard / unknown failovers — a single-device row written
# before (or without) the mesh era is the same shape as always, so
# MULTICHIP_* rows mix with BENCH_* readers.
OPTIONAL_INT_FIELDS = ("n_shards", "n_failovers")

# optional float fields: the per-job latency columns the route daemon
# stamps on serve-corpus rows (obs/slo.py) — queue wait from admission
# to first slice, and end-to-end latency measured at record time.
# Absent ⇒ unknown: v1/v2 rows written before the SLO era (and rows
# from non-daemon serving) stay valid, and the observatory's latency
# columns render "-" for them.
OPTIONAL_FLOAT_FIELDS = ("queue_wait_s", "e2e_s")

_SCENARIO_OK = re.compile(r"[^A-Za-z0-9._-]+")


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def git_rev(repo_dir: Optional[str] = None) -> str:
    """Short git revision of the repo (or "unknown" outside one /
    without git): the provenance stamp that lets trend rows be mapped
    back to the commit that produced them."""
    try:
        cmd = ["git"]
        if repo_dir:
            cmd += ["-C", repo_dir]
        cmd += ["rev-parse", "--short", "HEAD"]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=10)
        rev = r.stdout.strip()
        return rev if r.returncode == 0 and rev else "unknown"
    except Exception:
        return "unknown"


def sanitize_scenario(scenario: str) -> str:
    """Scenario ids become file names: anything outside [A-Za-z0-9._-]
    collapses to '_' so a config-derived id can never escape runs/."""
    s = _SCENARIO_OK.sub("_", scenario).strip("._")
    return s or "unnamed"


def config_hash(cfg: dict) -> str:
    """Stable 12-hex digest of a config dict (sorted-key JSON): two
    runs share it iff they ran the same config, whatever produced the
    scenario id."""
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def make_record(scenario: str, cfg: dict, metric: str, value,
                unit: str, backend: str, device_kind: str,
                qor: Optional[dict] = None,
                gauges: Optional[dict] = None,
                series: Optional[dict] = None,
                congestion: Optional[dict] = None,
                detail: Optional[dict] = None,
                tags: Optional[dict] = None,
                ts: Optional[str] = None,
                rev: Optional[str] = None,
                repo_dir: Optional[str] = None,
                tenant: Optional[str] = None,
                job_id: Optional[str] = None,
                plane_dtype: Optional[str] = None,
                n_shards: Optional[int] = None,
                queue_wait_s: Optional[float] = None,
                e2e_s: Optional[float] = None,
                n_failovers: Optional[int] = None) -> dict:
    rec = {
        "schema_version": SCHEMA_VERSION,
        "ts": ts or now_iso(),
        "git_rev": rev or git_rev(repo_dir),
        "scenario": sanitize_scenario(scenario),
        "config_hash": config_hash(cfg),
        "backend": str(backend),
        "device_kind": str(device_kind),
        "metric": str(metric),
        "value": float(value),
        "unit": str(unit),
    }
    if tenant is not None:
        rec["tenant"] = str(tenant)
    if job_id is not None:
        rec["job_id"] = str(job_id)
    if plane_dtype is not None:
        rec["plane_dtype"] = str(plane_dtype)
    if n_shards is not None:
        rec["n_shards"] = int(n_shards)
    if queue_wait_s is not None:
        rec["queue_wait_s"] = float(queue_wait_s)
    if e2e_s is not None:
        rec["e2e_s"] = float(e2e_s)
    if n_failovers is not None:
        rec["n_failovers"] = int(n_failovers)
    for key, val in (("qor", qor), ("gauges", gauges),
                     ("series", series), ("congestion", congestion),
                     ("detail", detail), ("tags", tags)):
        if val:
            rec[key] = val
    errs = validate_record(rec)
    if errs:
        raise ValueError(f"refusing to build an invalid record: {errs}")
    return rec


def validate_record(rec) -> list:
    """Schema floor: returns a list of problems (empty = valid).  An
    append-only corpus is only useful if every line can be trusted to
    parse the same way forever, so writers validate before appending
    and readers skip (or refuse, strict=True) anything that fails."""
    errs = []
    if not isinstance(rec, dict):
        return [f"record is not an object ({type(rec).__name__})"]
    for name, typ in REQUIRED_FIELDS:
        if name not in rec:
            errs.append(f"missing required field {name!r}")
        elif not isinstance(rec[name], typ) or isinstance(rec[name],
                                                          bool):
            errs.append(f"field {name!r} has type "
                        f"{type(rec[name]).__name__}, wanted "
                        f"{typ if isinstance(typ, type) else 'number'}")
    for name in OPTIONAL_STR_FIELDS:
        if name in rec and not isinstance(rec[name], str):
            errs.append(f"field {name!r} has type "
                        f"{type(rec[name]).__name__}, wanted str")
    for name in OPTIONAL_INT_FIELDS:
        if name in rec and (not isinstance(rec[name], int)
                            or isinstance(rec[name], bool)):
            errs.append(f"field {name!r} has type "
                        f"{type(rec[name]).__name__}, wanted int")
    for name in OPTIONAL_FLOAT_FIELDS:
        if name in rec and (not isinstance(rec[name], (int, float))
                            or isinstance(rec[name], bool)):
            errs.append(f"field {name!r} has type "
                        f"{type(rec[name]).__name__}, wanted number")
    sv = rec.get("schema_version")
    if isinstance(sv, int) and sv > SCHEMA_VERSION:
        errs.append(f"schema_version {sv} is newer than this reader's "
                    f"{SCHEMA_VERSION}")
    return errs


def run_path(runs_dir: str, scenario: str) -> str:
    return os.path.join(runs_dir,
                        f"{sanitize_scenario(scenario)}.jsonl")


def append_run(runs_dir: str, rec: dict) -> str:
    """Validate + append one record to runs/<scenario>.jsonl (one JSON
    object per line, append-only).  Returns the file path.

    The append is ONE O_APPEND os.write of the fully-encoded line:
    POSIX appends of a single write are atomic with respect to other
    appenders, and a crash can only ever leave a torn *trailing* line
    — which read_runs_ex skips with a counted warning — never
    interleave two writers' bytes into one poisoned line."""
    errs = validate_record(rec)
    if errs:
        raise ValueError(f"invalid corpus record: {errs}")
    path = run_path(runs_dir, rec["scenario"])
    os.makedirs(runs_dir, exist_ok=True)
    data = (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return path


def read_runs_ex(runs_dir: str, scenario: str,
                 strict: bool = False) -> tuple:
    """(records, skipped) of one scenario, oldest first.  Corrupt,
    torn-trailing, or schema-invalid lines are counted and skipped
    with a warning (the corpus outlives crashes and schema mistakes)
    unless strict, which raises on the first one.  The file is read
    as bytes: a torn multi-byte UTF-8 sequence must count as one more
    skipped line, not crash the reader."""
    import warnings

    path = run_path(runs_dir, scenario)
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        data = f.read()
    out, skipped = [], 0
    for i, raw in enumerate(data.split(b"\n"), 1):
        if not raw.strip():
            continue
        try:
            rec = json.loads(raw.decode("utf-8"))
            errs = validate_record(rec)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            rec, errs = None, [f"unparseable line: {e}"]
        if errs:
            if strict:
                raise ValueError(
                    f"{path}:{i}: invalid record: {errs}")
            skipped += 1
            continue
        out.append(rec)
    if skipped:
        warnings.warn(
            f"{path}: skipped {skipped} corrupted/torn JSONL "
            f"line(s)", RuntimeWarning, stacklevel=2)
    return out, skipped


def read_runs(runs_dir: str, scenario: str,
              strict: bool = False) -> list:
    """Records of one scenario, oldest first; see read_runs_ex for
    the skip/warn contract on corrupt lines."""
    return read_runs_ex(runs_dir, scenario, strict=strict)[0]


def scenarios(runs_dir: str) -> list:
    """Scenario ids present in the corpus, sorted."""
    if not os.path.isdir(runs_dir):
        return []
    return sorted(os.path.splitext(n)[0] for n in os.listdir(runs_dir)
                  if n.endswith(".jsonl"))


def latest_same_backend(records: list, backend: str, k: int,
                        exclude_ts: Optional[str] = None) -> list:
    """The trajectory tail gates compare against: the last ``k``
    records on the SAME backend (cross-backend rows are not comparable
    — the r04/r05 CPU-fallback lesson), with pre-era imports
    (tags.pre_pr2) and the fresh row itself (by ts) excluded."""
    hist = [r for r in records
            if r.get("backend") == backend
            and not (r.get("tags") or {}).get("pre_pr2")
            and (exclude_ts is None or r.get("ts") != exclude_ts)]
    return hist[-k:] if k > 0 else hist


# ---- congestion heatmaps -------------------------------------------
#
# The router records, per committed window, the top-k overused rr-node
# ids ([[node, overuse], ...]).  The corpus stores them twice over:
# as per-window (x, y, overuse) points (node ids resolved to grid
# coordinates, so the corpus is self-describing without the rr graph)
# and as one aggregate bins x bins raster per run — the training
# substrate for the ROADMAP's congestion-predictive planner.

def node_points(top_overused, xlow, ylow, xhigh, yhigh) -> list:
    """[[x, y, overuse], ...] for one window's top-overused list: one
    point per grid tile the rr node spans (a length-L wire contributes
    its overuse at each tile it crosses), so long wires keep their
    spatial extent in the raster."""
    pts = []
    for node, over in top_overused:
        n = int(node)
        for x in range(int(xlow[n]), int(xhigh[n]) + 1):
            for y in range(int(ylow[n]), int(yhigh[n]) + 1):
                pts.append([x, y, int(over)])
    return pts


def rasterize(points, extent_x: int, extent_y: int,
              bins: int = 16) -> list:
    """Accumulate weighted (x, y, w) points into a bins x bins grid
    (row-major: heatmap[by][bx]).  ``extent_*`` is the coordinate
    domain size (grid nx + 2 to cover the IO ring); out-of-range
    points clamp to the edge bins rather than vanish."""
    bins = max(1, int(bins))
    hm = [[0 for _ in range(bins)] for _ in range(bins)]
    sx = bins / max(1, extent_x)
    sy = bins / max(1, extent_y)
    for x, y, w in points:
        bx = min(bins - 1, max(0, int(x * sx)))
        by = min(bins - 1, max(0, int(y * sy)))
        hm[by][bx] += w
    return hm


def congestion_blob(cong_records, xlow, ylow, xhigh, yhigh,
                    extent_x: int, extent_y: int,
                    bins: int = 16) -> Optional[dict]:
    """Distill the router's per-window congestion records
    (RouteResult.congestion) into the corpus congestion payload:
    per-window point lists + one aggregate raster.  None when the run
    recorded no congestion (telemetry off, or zero windows)."""
    if not cong_records:
        return None
    windows = []
    agg = []
    for rec in cong_records:
        pts = node_points(rec.get("top_overused") or [],
                          xlow, ylow, xhigh, yhigh)
        agg.extend(pts)
        windows.append({
            "window": rec.get("window"),
            "iteration": rec.get("iteration"),
            "overused_nodes": rec.get("overused_nodes"),
            "overuse_total": rec.get("overuse_total"),
            "pres_fac": rec.get("pres_fac"),
            "points": pts,
        })
    return {"bins": int(bins), "extent": [int(extent_x),
                                          int(extent_y)],
            "windows": windows,
            "heatmap": rasterize(agg, extent_x, extent_y, bins)}
