"""QoR parity harness: device router vs the independent serial oracle
(the counterpart of the JAX package's route/qor.py).

The acceptance bar for the whole framework (BASELINE.md, restating the
reference's published claims) is wall-clock speedup at <= 1% CRITICAL-PATH
DELAY degradation — wirelength alone is not the metric.  This module runs
the complete timing-driven negotiation on both routers over the same
placed problem and reports crit-path delay + wirelength deltas
(get_critical_path_delay semantics, reference
vpr/SRC/timing/path_delay.c:3791).

The device side is the port's Router on ``device`` (the card unless the
caller asks for the CPU), with the STA inside each window.  The serial
side runs on the host, through the same analyze -> update-criticalities
-> reroute outer loop the device Router runs
(parallel_route/router.cxx:28,42): each timing pass re-routes with the
previous pass's criticalities until the crit path stops improving; its
analyses run on ``device`` as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..timing import TimingAnalyzer, build_timing_graph
from .router import Router, RouterOpts
from .serial_ref import SerialRouter


def serial_sink_delays(rr, term, trees) -> np.ndarray:
    """Per-sink pure delays of a serial routing: walk each net tree
    accumulating the out-edge delays (switch Tdel + C_dst load, the same
    per-edge delay model both routers use)."""
    R, Smax = term.sinks.shape
    # out-edge delay lookup (parent, child) -> delay
    rp, dst = rr.out_row_ptr, rr.out_dst
    sw = rr.out_switch.astype(np.int64)
    edelay = (rr.switch_Tdel[sw] + rr.C[dst]
              * (rr.switch_R[sw] + 0.5 * rr.R[dst]))
    out = np.full((R, Smax), np.inf, dtype=np.float32)
    for i in range(R):
        delay = {}
        for node, parent in trees[i]:
            if parent < 0:
                delay[node] = 0.0
                continue
            d = np.inf
            for e in range(rp[parent], rp[parent + 1]):
                if dst[e] == node:
                    d = edelay[e]
                    break
            delay[node] = delay.get(parent, 0.0) + (
                0.0 if not np.isfinite(d) else d)
        for s in range(int(term.num_sinks[i])):
            sk = int(term.sinks[i, s])
            if sk in delay:
                out[i, s] = delay[sk]
    return out


@dataclass
class QorRow:
    circuit: str
    device_cpd: float
    serial_cpd: float
    device_wl: int
    serial_wl: int
    device_iters: int
    serial_iters: int
    # host syncs the device route paid (= windows dispatched; < iters
    # when the STA inside the window kept multi-iteration windows alive)
    device_windows: int = 0

    @property
    def cpd_delta_pct(self) -> float:
        return 100.0 * (self.device_cpd - self.serial_cpd) / self.serial_cpd

    @property
    def wl_delta_pct(self) -> float:
        return 100.0 * (self.device_wl - self.serial_wl) / max(
            1, self.serial_wl)


def qor_compare(flow, name: str = "circuit",
                opts: Optional[RouterOpts] = None,
                timing_passes: int = 3, device="cuda") -> QorRow:
    """Run the timing-driven flow on a prepared+placed FlowResult with
    BOTH routers and report crit-path/wirelength parity.  The device
    route and both analyzers run on ``device``; the serial routes on the
    host."""
    rr, term, nl, pnl = flow.rr, flow.term, flow.nl, flow.pnl
    tg = build_timing_graph(nl, pnl, term)

    # --- device: per-iteration criticality feedback inside each window
    # (analyzer mode: the STA runs between iterations, K>1 windows) ---
    ta_d = TimingAnalyzer(tg, device=device)
    router = Router(rr, opts or RouterOpts(batch_size=64), device=device)
    res_d = router.route(term, analyzer=ta_d)
    assert res_d.success, "device route failed"
    ta_d.analyze(res_d.sink_delay)
    cpd_d = float(ta_d.crit_path_delay)

    # --- serial: analyze -> crit -> reroute passes (the native C++
    # router when available — bit-identical to serial_ref, ~30x faster;
    # tests/test_torch_serial.py enforces the equivalence) ---
    try:
        from .serial_native import NativeSerialRouter, native_available
        serial_cls = (NativeSerialRouter if native_available()
                      else SerialRouter)
    except Exception:
        serial_cls = SerialRouter
    ta_s = TimingAnalyzer(tg, device=device)
    crit = None
    cpd_s = np.inf
    res_s = None
    iters_s = 0
    for _ in range(timing_passes):
        sr = serial_cls(rr)
        r = sr.route(term, crit=crit)
        assert r.success, "serial route failed"
        sd = serial_sink_delays(rr, term, r.trees)
        crit = ta_s.analyze(sd)
        iters_s += r.iterations
        if float(ta_s.crit_path_delay) >= cpd_s * 0.999:
            if float(ta_s.crit_path_delay) < cpd_s:
                cpd_s, res_s = float(ta_s.crit_path_delay), r
            break
        cpd_s, res_s = float(ta_s.crit_path_delay), r
    return QorRow(name, cpd_d, cpd_s, res_d.wirelength, res_s.wirelength,
                  res_d.iterations, iters_s,
                  device_windows=len(res_d.stats))
