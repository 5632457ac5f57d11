"""Cross-job net bin-packing: the counterpart of
parallel_eda_tpu/serve/batcher.py.

Folds nets from multiple admitted jobs into shared size-class
dispatches.  The relaxation kernels are per-net (one thread block, or
one cluster, relaxes one net on its own canvas against its own
congestion view), so a batch mixing nets from different jobs computes,
net for net, exactly what each job's solo batch computes.  The
batcher's job is therefore pure bookkeeping: bin the UNION of all jobs'
nets onto one size-class crop ladder (the same ``_size_class_buckets``
pow-2 ladder the Router uses solo), plan each populated rung's kernel
layout, and demultiplex slots strictly back to (job, net) — a slot
belongs to exactly one job, pad slots to none.

The layout is the port's (route/planes_kernels.py ``kernel_layout``,
the meaning of the route.kernel.* gauges): ``block_nets`` is nets per
thread block (1), ``lane_occupancy`` the canvas cells over the launched
thread-slots, so the ``route.serve.pack.*`` gauges carry that meaning.
The rungs, tiles and slots equal the JAX package's.

Inputs are plain numpy spans; no tensor, no Router.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.metrics import get_metrics


@dataclass
class RungPlan:
    """One shared dispatch class: a crop tile (None = full canvas), its
    plane shapes, the kernel layout's block size and lane occupancy,
    and the (job, net) slot assignment in dispatch order."""
    tile: Optional[Tuple[int, int]]
    shape_x: Tuple[int, int, int]
    shape_y: Tuple[int, int, int]
    block_nets: int
    lane_occupancy: float
    slots: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def nets(self) -> int:
        return len(self.slots)

    @property
    def blocks(self) -> int:
        g = max(1, self.block_nets)
        return (len(self.slots) + g - 1) // g

    def demux(self) -> Dict[str, List[Tuple[int, int]]]:
        """job_id -> [(packed_slot, job_net_idx)] — strict: every
        occupied slot maps to exactly one job; pad slots (beyond
        ``nets`` up to blocks*G) map to none."""
        out: Dict[str, List[Tuple[int, int]]] = {}
        for s, (job, idx) in enumerate(self.slots):
            out.setdefault(job, []).append((s, idx))
        return out


@dataclass
class CrossJobPlan:
    rungs: List[RungPlan]
    jobs: List[str]

    @property
    def total_nets(self) -> int:
        return sum(r.nets for r in self.rungs)

    @property
    def lane_occupancy(self) -> float:
        """Net-weighted lane occupancy across the shared rungs — the
        number ``route.serve.pack.lane_occupancy`` publishes."""
        if not self.rungs:
            return 0.0
        return round(sum(r.lane_occupancy * r.nets for r in self.rungs)
                     / max(1, self.total_nets), 4)

    def signature(self) -> Tuple:
        """Canonicalized pack shape: the rung descriptor table + block
        layout, independent of job identity and arrival order.  Packs
        that quantize to the same signature dispatch through the same
        compiled program family, so a join/finish that lands on an
        already-seen signature recompiles nothing."""
        return tuple((r.tile, r.shape_x, r.shape_y, r.block_nets,
                      r.blocks) for r in self.rungs)

    def job_slots(self, job_id: str) -> List[Tuple[int, int, int]]:
        """[(rung, packed_slot, job_net_idx)] for one job."""
        out = []
        for ri, r in enumerate(self.rungs):
            for s, idx in r.demux().get(job_id, []):
                out.append((ri, s, idx))
        return out


#: machine-readable rebatch causes (flow_doctor validates against this)
REBATCH_CAUSES = ("join", "finish", "evict", "failover")


def diff_packs(prev_ids, cur_ids,
               is_done=None, is_failover=None) -> List[Dict[str, str]]:
    """Classify one rebatch boundary: which jobs entered/left the
    co-admitted set between two slice rounds, each with a
    machine-readable cause from ``REBATCH_CAUSES``.  ``is_done`` /
    ``is_failover`` are job_id predicates supplied by the scheduler
    (queue terminal state; fleet failover admission) — without them
    entries default to ``join`` and exits to ``evict``."""
    prev = frozenset(prev_ids or ())
    cur = frozenset(cur_ids)
    causes: List[Dict[str, str]] = []
    for jid in sorted(cur - prev):
        fo = is_failover is not None and is_failover(jid)
        causes.append({"job_id": jid, "cause": "failover" if fo
                       else "join"})
    for jid in sorted(prev - cur):
        done = is_done is not None and is_done(jid)
        causes.append({"job_id": jid, "cause": "finish" if done
                       else "evict"})
    return causes


def pack_jobs(job_nets: Dict[str, Tuple[np.ndarray, np.ndarray]],
              shape_x: Tuple[int, int, int],
              shape_y: Tuple[int, int, int],
              min_count: int = 1, base: int = 8,
              publish_gauges: bool = True) -> CrossJobPlan:
    """Plan shared dispatches for several jobs' nets.

    ``job_nets`` maps job_id -> (need_w, need_h) per-net canvas spans
    (grid cells, crop margin included — the same arrays the Router
    feeds ``_size_class_buckets``).  ``shape_x``/``shape_y`` are the
    full-canvas plane shapes (``pg.shape_x``/``pg.shape_y``); all jobs
    must target the same device grid, which is what makes their
    variant keys shareable in the first place.
    """
    from ..route.planes_kernels import kernel_layout
    from ..route.router import _size_class_buckets

    W, NX, NYp1 = shape_x
    _, NXp1, NY = shape_y
    nx, ny = NX, NY

    jobs = sorted(job_nets)
    # union spans, with provenance back to (job, net)
    owners: List[Tuple[str, int]] = []
    need_w_all, need_h_all = [], []
    for job in jobs:
        nw, nh = job_nets[job]
        nw = np.asarray(nw)
        nh = np.asarray(nh)
        if nw.shape != nh.shape:
            raise ValueError(f"{job}: span arrays disagree "
                             f"{nw.shape} vs {nh.shape}")
        for i in range(len(nw)):
            owners.append((job, i))
        need_w_all.append(nw)
        need_h_all.append(nh)
    if not owners:
        return CrossJobPlan(rungs=[], jobs=jobs)
    need_w = np.concatenate(need_w_all)
    need_h = np.concatenate(need_h_all)

    classes, assign = _size_class_buckets(
        need_w, need_h, nx, ny, min_count=min_count, base=base)

    rungs: List[RungPlan] = []
    for k, tile in enumerate(list(classes) + [None]):
        idx = np.nonzero(assign == k)[0]
        if len(idx) == 0:
            continue
        if tile is not None:
            cnx, cny = tile
            shx, shy = (W, cnx, cny + 1), (W, cnx + 1, cny)
        else:
            shx, shy = (W, NX, NYp1), (W, NXp1, NY)
        lay = kernel_layout(shape_x, shape_y, len(idx), 1, tile=tile)
        rungs.append(RungPlan(
            tile=tile, shape_x=shx, shape_y=shy,
            block_nets=lay["block_nets"],
            lane_occupancy=lay["lane_occupancy"],
            slots=[owners[i] for i in idx]))

    plan = CrossJobPlan(rungs=rungs, jobs=jobs)
    if publish_gauges and rungs:
        get_metrics().set_gauges({
            "route.serve.pack.jobs": len(jobs),
            "route.serve.pack.shared_rungs": len(rungs),
            "route.serve.pack.nets": plan.total_nets,
            "route.serve.pack.lane_occupancy": plan.lane_occupancy,
        })
    return plan
