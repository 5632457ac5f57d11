"""The graceful-degradation ladder: the counterpart of
parallel_eda_tpu/resil/ladder.py, with its six dimensions, their level
names and counts, the ``route.resil.degradation_steps`` counter, the
``route.resil.level.<dim>`` gauges and the ``route.resil.degrade``
trace instant.

Each dimension is an ordered list of execution levels, fastest first.
The level names are the JAX package's; where a level names a TPU form,
the port runs its own form of the same work:

  kernel:   pallas_packed -> pallas_g1 -> xla.  The shared-memory mode
            of the relaxation kernels (csrc/planes_relax.cu auto_mode;
            route/planes_kernels.py ``mode=``): pallas_packed is the
            auto mode (2, dist and scan costs in shared memory, or 1
            where 2 does not fit), pallas_g1 caps the mode at 1 (dist
            in shared memory), xla at 0 (all state in global memory).
            Every level is a hand-written kernel; none is the plain
            PyTorch version, which runs on CPU tensors only.  On the
            CPU the wrappers' plain versions take no mode, so the
            levels name the same computation there.
  pipeline: pipelined -> sync   (RouterOpts.pipeline)
  program:  aot -> jit.  "aot" is a dispatch through the program
            library (serve/library.py: the variant's launch plans
            installed), "jit" the same window function planning its
            launches at first use; a chain holds an "aot" rung only with
            a library attached (RouterOpts.program_library_dir).
  dtype:    bf16 -> f32   (stepped when a bf16 shadow window leaves the
            band of router._dtype_band_ok)
  dispatch: fused -> per_rung   (one route_window_planes_fused call a
            window vs one route_window_planes call per crop rung)
  mesh:     pallas_halo -> ppermute -> single_chip.  The row-sharded
            relaxation (route/planes_shard.py): pallas_halo is the
            cluster kernel (lag 1, every shard on one card, one launch
            a relaxation), ppermute the peer kernel (one launch a
            relaxation per card, planes_kernels.py), and
            single_chip the unsharded K1/K2 on one card, the floor a
            lost mesh member lands on (router._mesh_demote).
            pallas_halo engages only where the cluster kernel runs (a
            card); on CPU tensors ppermute is the top rung, as it is
            off the TPU in the JAX package.  Inert unless
            RouterOpts.mesh_shards > 1.

All levels are bit-identical but "dtype", whose levels are QoR-identical
under the router's shadow guard.  "kernel" and "program" descend *per
dispatch-variant* inside ``DispatchGuard`` (quarantine picks the rung);
the ladder records every such step.  "pipeline", "dtype", "dispatch",
and floor overrides for the other two are *global*: the service steps
them when a whole job attempt is poisoned, the router's dtype guard
steps "dtype" on a band violation, and the router consults ``level()``
when building a dispatch chain.  The "dtype"/"dispatch" levels are inert
unless the matching RouterOpts knob opted in (plane_dtype="bf16" /
fused_dispatch=True).
"""

from typing import Dict, List, Optional

from ..obs.metrics import get_metrics
from ..obs.trace import get_tracer

DIMS: Dict[str, tuple] = {
    "kernel": ("pallas_packed", "pallas_g1", "xla"),
    "pipeline": ("pipelined", "sync"),
    "program": ("aot", "jit"),
    "dtype": ("bf16", "f32"),
    "dispatch": ("fused", "per_rung"),
    "mesh": ("pallas_halo", "ppermute", "single_chip"),
}

# the port's form of each "kernel" level: the cap on the relaxation
# kernels' shared-memory mode (None: the auto mode)
KERNEL_MODE_CAP = {"pallas_packed": None, "pallas_g1": 1, "xla": 0}

# Rung labels (watchdog chain) -> ladder dimension, for step records.
_LABEL_DIM = {
    "aot": "program",
    "jit": "program",
    "pallas_packed": "kernel",
    "pallas_g1": "kernel",
    "xla": "kernel",
    "bf16": "dtype",
    "f32": "dtype",
    "fused": "dispatch",
    "per_rung": "dispatch",
    "pallas_halo": "mesh",
    "ppermute": "mesh",
    "single_chip": "mesh",
}


class DegradationLadder:
    def __init__(self):
        self._level = {dim: 0 for dim in DIMS}
        m = get_metrics()
        for dim, lvl in self._level.items():
            m.gauge(f"route.resil.level.{dim}").set(lvl)

    def level(self, dim: str) -> int:
        return self._level[dim]

    def name(self, dim: str) -> str:
        return DIMS[dim][min(self._level[dim], len(DIMS[dim]) - 1)]

    def record(self, from_label: str, reason: str) -> None:
        """Log one per-variant step-down (quarantine of ``from_label``)
        without moving the global level."""
        m = get_metrics()
        m.counter("route.resil.degradation_steps").inc()
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.resil.degrade", cat="resil",
                       dim=_LABEL_DIM.get(from_label, "?"),
                       rung=from_label, reason=reason[:200])

    def step(self, dim: str, reason: str = "") -> bool:
        """Move a global dimension one level down; False at the floor."""
        names = DIMS[dim]
        if self._level[dim] >= len(names) - 1:
            return False
        self._level[dim] += 1
        m = get_metrics()
        m.counter("route.resil.degradation_steps").inc()
        m.gauge(f"route.resil.level.{dim}").set(self._level[dim])
        tr = get_tracer()
        if tr is not None:
            tr.instant("route.resil.degrade", cat="resil", dim=dim,
                       to=self.name(dim), reason=reason[:200])
        return True

    def snapshot(self) -> Dict[str, str]:
        return {dim: self.name(dim) for dim in DIMS}
