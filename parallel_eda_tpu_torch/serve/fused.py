"""Continuous batching: co-admitted jobs fused into one merged dispatch,
rebatched at every slice boundary (the counterpart of
parallel_eda_tpu/serve/fused.py, with its counters, its variant keys and
its per-job fallback).

Each admitted job's routing runs as a window-dispatch GENERATOR
(``Router.route_gen`` yields a ``WindowDispatchRequest`` per fused
window), and the ``FusedSliceRunner`` drives every co-admitted job's
generator in LOCKSTEP: at each step it collects the requests all
still-active jobs yielded, merges them (canonically ordered, chunked)
into ONE ``planes.route_window_planes_multi`` call, and sends each job
its own result back.  Joiners enter at the next slice boundary,
finishers leave mid-slice (the merge simply shrinks), and a job that
cannot merge (a row or (net, node) mesh, device-resident STA, a
singleton step) dispatches solo through ``Router._exec_window_request``,
the exact solo code path.

Bit-identical per-job QoR is the invariant: every job keeps its own
state tensors and its own rung ladder inside the multi call, and
nothing is computed across jobs, so each job's part is its
route_window_planes_fused call (tests/test_torch_serve_fused.py holds
wirelength, occupancy and paths against solo routes and against the
JAX package's fused service).

The merged variant key is the canonicalized pack shape, ``("multi",)``
plus the member jobs' fused window keys in canonical order, and both
the dispatch-variant registry and the program library (serve/library.py)
key on it, so a replayed stream rebatches every join and finish without
a new variant once the library is warm.

Unlike the JAX program, whose state is donated functionally, the port's
window writes each job's paths, sink delays, reach flags, boxes and
criticalities in place, and the multi call runs the jobs one after the
other: a call that fails part-way has already advanced its first
members.  ``_dispatch_multi`` therefore snapshots every member's
window-entry tensors (``router._WindowEntry``) before the call and
restores them before the member is dispatched solo.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..obs.metrics import get_metrics
from ..route.router import (WindowDispatchRequest, _note_dispatch_variant,
                            _WindowEntry)

#: merged-dispatch width cap: pack shapes quantize to at most this many
#: jobs per multi call, so the pack-shape variety stays a small ladder
#: (wider admitted sets split into several calls)
FUSE_MAX = 8


class SliceEntry:
    """One job's lockstep context: its window generator plus the
    router state (opts, staging-slot prefix) that must be asserted
    before EVERY advance — the generators all share one Router."""
    __slots__ = ("job", "gen", "opts", "prefix", "prev_it", "pending",
                 "result", "error", "windows", "fused_windows")

    def __init__(self, job, gen, opts, prefix, prev_it=0):
        self.job = job
        self.gen = gen
        self.opts = opts
        self.prefix = prefix
        self.prev_it = int(prev_it)
        self.pending: Optional[WindowDispatchRequest] = None
        self.result = None
        self.error: Optional[BaseException] = None
        self.windows = 0          # window dispatches this slice
        self.fused_windows = 0    # ...carried by a multi call

    @property
    def job_id(self) -> str:
        return self.job.job_id


def _mergeable(req: WindowDispatchRequest) -> bool:
    """A request can join a multi call iff its window runs the
    single-device, host-crit configuration route_window_planes_multi
    supports (JAX serve/fused.py:79-81): no mesh — neither a row mesh
    nor a (net, node) mesh, whose Router yields no fused request anyway
    — and no device-resident STA."""
    kw = req.f_kwargs
    return kw.get("mesh") is None and kw.get("tdev") is None


def _shared_key(req: WindowDispatchRequest):
    """Grid-level static config that must agree across every member of
    one multi call (it is shared, not per-job, in the signature).
    ``use_pallas`` is JAX's kernel switch: the port's fused requests
    carry none, so it reads False for every job.  topk is deliberately
    NOT here — it tracks each job's net count and rides the per-job
    statics, so a tiny job fuses with a big one."""
    kw = req.f_kwargs
    return (kw.get("n_colors"), bool(kw.get("use_pallas")),
            kw.get("plane_dtype"))


def _split_request(req: WindowDispatchRequest):
    """Demux one fused-window request's f_args/f_kwargs into the multi
    call's per-job (state, dynamics, statics) triple.  The port's f_args
    (Router._route_planes_windows, the fused dispatch) are:
    [0] pg [1] dev [2:8] state (occ, acc, paths, sink_delay,
    all_reached, bb) [8] source [9] sinks [10] crit [11:22] the eleven
    terminal tables [22] sel plans [23] valid plans [24] full_bb
    [25:31] pres0, pres_mult, max_pres, acc_fac, it0, force_until
    [31] K [32] L — the JAX package's index map, position for
    position."""
    a = req.f_args
    kw = req.f_kwargs
    state = (a[2], a[3], a[4], a[5], a[6], a[7], a[10])
    dyn = (a[8], a[9], tuple(a[11:22]), a[22], a[23], a[24],
           a[25], a[26], a[27], a[28], a[29], a[30],
           kw.get("bb0_all"), kw.get("widen_oks"))
    static = (a[31], a[32], kw["rung_desc"], kw["topk"])
    return state, dyn, static


class FusedSliceRunner:
    """Lockstep executor over co-admitted jobs' window generators.

    ``run_slice(entries)`` advances every entry's generator to its
    first yielded WindowDispatchRequest, then repeats: merge the
    currently pending requests into multi dispatches (plus solo
    dispatches for unmergeable/singleton steps), send each job its
    result, and re-collect — until every generator returned (slice
    yield or route completion).  Per-generator exceptions are captured
    on the entry (the service turns them into queue verdicts); one
    job's death never takes down its batchmates' slice.

    A failed multi dispatch degrades to per-job solo dispatch through
    ``Router._exec_window_request``, each member restored to its window
    entry first — each job's full resilience rung chain (watchdog,
    retry, quarantine, per-rung fallback) applies there, so chaos-plan
    faults hit the same recovery ladder fused serving as interleaved
    serving."""

    def __init__(self, router, resil=None, fuse_max: int = FUSE_MAX):
        self.router = router
        self.resil = resil
        self.fuse_max = max(1, int(fuse_max))

    # ------------------------------------------------- generator IO

    def _advance(self, e: SliceEntry, value, first: bool) -> None:
        # per-advance router context: opts and the staging-slot
        # namespace belong to the job whose generator is running
        self.router.opts = e.opts
        self.router._staging_prefix = e.prefix
        try:
            e.pending = next(e.gen) if first else e.gen.send(value)
        except StopIteration as s:
            e.pending, e.result = None, s.value
        except Exception as ex:   # captured; verdict decided upstream
            e.pending, e.error = None, ex

    def _solo(self, e: SliceEntry):
        self.router.opts = e.opts
        self.router._staging_prefix = e.prefix
        return self.router._exec_window_request(e.pending)

    # --------------------------------------------------- dispatch

    def _dispatch_multi(self, group: List[SliceEntry]):
        """One multi call over ``group`` (canonical order already
        applied).  Returns {job_id: result}.  Any failure — injected
        dispatch faults included — restores every member's window
        entry and falls back to per-job solo dispatch with the full
        per-job guard chain."""
        from ..route.planes import route_window_planes_multi
        m = get_metrics()
        reqs = [e.pending for e in group]
        states, dyns, statics = zip(*(_split_request(r) for r in reqs))
        kw0 = reqs[0].f_kwargs
        m_args = (self.router.pg, self.router.dev,
                  tuple(states), tuple(dyns))
        m_kwargs = dict(job_statics=tuple(statics),
                        n_colors=kw0["n_colors"],
                        plane_dtype=kw0["plane_dtype"])
        # the canonicalized pack shape IS the variant key: the member
        # window keys in canonical order — same members, same key,
        # regardless of join order
        vkey = ("multi",) + tuple(r.vkey for r in reqs)
        entries = [_WindowEntry(r.f_args) for r in reqs]
        try:
            rt = self.resil
            if rt is not None and rt.plan is not None:
                # injected dispatch faults fire at the merged site too,
                # exercising the per-job degradation below
                rt.plan.raise_if("dispatch.error", detail="multi")
            _note_dispatch_variant(vkey)
            if self.router._library is not None:
                outs = self.router._library.dispatch(
                    vkey, route_window_planes_multi, m_args, m_kwargs)
            else:
                outs = route_window_planes_multi(*m_args, **m_kwargs)
        except Exception:
            # degrade: the SAME requests, one at a time, through the
            # guarded solo chain, each from its restored window entry
            m.counter("route.serve.fused.fallbacks").inc()
            m.gauge("route.serve.fused.width").set(1)
            outs = {}
            for e, entry in zip(group, entries):
                entry.restore()
                outs[e.job_id] = self._solo(e)
            return outs
        m.counter("route.serve.fused.dispatches").inc()
        m.counter("route.serve.fused.jobs").inc(len(group))
        m.gauge("route.serve.fused.width").set(len(group))
        for e in group:
            e.fused_windows += 1
        return {e.job_id: outs[i] for i, e in enumerate(group)}

    def _step(self, pend: List[SliceEntry]) -> Dict[str, Any]:
        """One lockstep step: dispatch every pending request — merged
        where possible — and return {job_id: result}."""
        m = get_metrics()
        outs: Dict[str, Any] = {}
        merge = [e for e in pend if _mergeable(e.pending)]
        solo = [e for e in pend if not _mergeable(e.pending)]
        # canonical multiset order: sort by the member key's repr
        # (vkeys mix tuples/None/ints and don't compare directly),
        # job id as the deterministic tiebreak
        merge.sort(key=lambda e: (repr(e.pending.vkey), e.job_id))
        # group by the shared grid-level statics, then chunk to the
        # pack-width cap: the pack-shape variety stays a small ladder
        by_cfg: Dict[Any, List[SliceEntry]] = {}
        for e in merge:
            by_cfg.setdefault(_shared_key(e.pending), []).append(e)
        for members in by_cfg.values():
            for lo in range(0, len(members), self.fuse_max):
                group = members[lo:lo + self.fuse_max]
                if len(group) == 1:
                    solo.append(group[0])
                    continue
                outs.update(self._dispatch_multi(group))
        for e in solo:
            # singleton / unmergeable step: the exact solo code path
            # (same variant keys, so the solo library entries stay warm)
            outs[e.job_id] = self._solo(e)
            m.counter("route.serve.fused.solo_windows").inc()
        return outs

    # -------------------------------------------------------- slice

    def run_slice(self, entries: List[SliceEntry]) -> List[SliceEntry]:
        """Drive every entry's generator to its slice boundary (or
        route completion/error).  Returns the entries with
        result/error set; per-entry wall share is left to the caller
        (lockstep wall is a joint cost)."""
        m = get_metrics()
        t0 = time.perf_counter()
        for e in entries:
            self._advance(e, None, first=True)
        steps = 0
        while True:
            pend = [e for e in entries if e.pending is not None]
            if not pend:
                break
            outs = self._step(pend)
            steps += 1
            for e in pend:
                e.windows += 1
                self._advance(e, outs[e.job_id], first=False)
        m.counter("route.serve.fused.steps").inc(steps)
        m.gauge("route.serve.fused.slice_wall_s").set(
            round(time.perf_counter() - t0, 4))
        return entries

    def close(self, entries: List[SliceEntry]) -> None:
        """Abandon un-finished generators (evicted/fenced jobs): close
        them so their MdcLogger contexts unwind via GeneratorExit."""
        for e in entries:
            if e.pending is not None:
                e.gen.close()
                e.pending = None
