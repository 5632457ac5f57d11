"""Static timing analysis in PyTorch: the counterpart of the JAX
package's timing/sta.py.

Max-plus / min-plus relaxations over the timing DAG's ELL in-/out-edge
tables: ``depth`` dense sweeps converge exactly on a DAG of that depth,
each one [T, D] gather and reduce.  The per-connection criticality
crit = (1 - slack/Dmax) ** exp (vpr/SRC/route/route_timing.c:225-268) is
scattered back to the router's [R, Smax] layout with a max-reduce.

The analysis is plain tensor code on the tensors' device (no hand
kernel: the JAX package runs it as XLA gathers and reductions too), and
``sta_crit`` never reads a value to the host, so the router can run it
between PathFinder iterations inside a window (route/planes.py
route_window_planes).  Every operation is a single f32 add, subtract,
compare, divide or max, so the results are bit-identical to the JAX
package's on any device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .graph import TimingGraph

NEG = float("-inf")
INF = float("inf")


@dataclass
class DeviceTimingGraph:
    """The timing graph's tables as tensors on one device."""
    in_src: torch.Tensor       # int64 [T, D]
    in_const: torch.Tensor     # f32   [T, D]
    in_ridx: torch.Tensor      # int64 [T, D], -1 = no routed part
    in_valid: torch.Tensor     # bool  [T, D]
    out_dst: torch.Tensor
    out_const: torch.Tensor
    out_ridx: torch.Tensor
    out_valid: torch.Tensor
    arrival0: torch.Tensor     # f32 [T]
    is_endpoint: torch.Tensor  # bool [T]

    @property
    def device(self) -> torch.device:
        return self.arrival0.device


def to_device(tg: TimingGraph, device) -> DeviceTimingGraph:
    """``tg``'s tables on ``device``; index tables as int64 (torch's
    index dtype; -1 indexes the last slot, as in JAX)."""
    dev = torch.device(device)

    def t(name):
        a = np.ascontiguousarray(getattr(tg, name))
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(dev)

    return DeviceTimingGraph(**{f.name: t(f.name)
                                for f in fields(DeviceTimingGraph)})


def sta_crit(dev: DeviceTimingGraph, route_delay: torch.Tensor,
             depth: int, crit_exp: float = 1.0, max_crit: float = 0.99,
             req_seed: Optional[torch.Tensor] = None, use_sdc: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """The STA core (JAX ``sta_crit``), on ``route_delay``'s device with
    no host read.

    route_delay: flat [R*Smax + 1] f32 routed per-connection delays with
    a trailing 0 slot, so ridx == -1 gathers a zero.  Single-clock mode:
    an endpoint's required time is the critical-path delay itself.  SDC
    mode (``use_sdc``): req_seed [T] carries each endpoint's required
    time, and each tnode's slack is normalised by the period of the
    domain whose endpoint sets its required time (the first on ties, as
    ``jnp.argmin``).

    Returns (crit_flat [R*Smax], Dmax, worst_slack, arrival [T]), the
    scalars as 0-d tensors."""
    rd = torch.where(torch.isfinite(route_delay), route_delay, 0.0)
    d_in = dev.in_const + rd[dev.in_ridx]
    d_out = dev.out_const + rd[dev.out_ridx]

    arr = dev.arrival0
    for _ in range(depth):
        cand = torch.where(dev.in_valid, arr[dev.in_src] + d_in, NEG)
        arr = torch.maximum(dev.arrival0, cand.amax(dim=1))

    dmax = torch.where(dev.is_endpoint, arr, NEG).amax()
    dmax = torch.where(torch.isfinite(dmax), dmax, 0.0)

    if use_sdc:
        req0 = torch.where(dev.is_endpoint, req_seed, INF)
        per0 = torch.where(dev.is_endpoint & torch.isfinite(req_seed),
                           req_seed, 0.0)
        req, per = req0, per0
        for _ in range(depth):
            cand = torch.where(dev.out_valid, req[dev.out_dst] - d_out, INF)
            cper = torch.where(dev.out_valid, per[dev.out_dst], 0.0)
            cand_all = torch.cat([cand, req0[:, None]], dim=1)
            per_all = torch.cat([cper, per0[:, None]], dim=1)
            j = torch.argmin(cand_all, dim=1, keepdim=True)
            req = torch.gather(cand_all, 1, j)[:, 0]
            per = torch.gather(per_all, 1, j)[:, 0]
        denom = torch.where(per > 0, per,
                            torch.clamp(dmax, min=1e-30))[:, None]
    else:
        req0 = torch.where(dev.is_endpoint, dmax, INF)
        req = req0
        for _ in range(depth):
            cand = torch.where(dev.out_valid, req[dev.out_dst] - d_out, INF)
            req = torch.minimum(req0, cand.amin(dim=1))
        denom = torch.clamp(dmax, min=1e-30)

    worst = torch.where(dev.is_endpoint & torch.isfinite(req0), req0 - arr,
                        INF).amin()
    worst = torch.where(torch.isfinite(worst), worst, 0.0)

    # per in-edge slack -> criticality, scattered to (net, sink) slots;
    # the max_crit clamp keeps the congestion term alive
    slack = req[:, None] - arr[dev.in_src] - d_in
    crit = torch.clamp(1.0 - slack / denom, 0.0, max_crit)
    if crit_exp != 1.0:
        crit = crit ** crit_exp
    ok = dev.in_valid & (dev.in_ridx >= 0) & torch.isfinite(slack)
    RS = route_delay.shape[0] - 1
    idx = torch.where(ok, dev.in_ridx, RS)
    crit_flat = torch.zeros(RS + 1, dtype=torch.float32,
                            device=route_delay.device).scatter_reduce_(
        0, idx.reshape(-1), torch.where(ok, crit, 0.0).reshape(-1), "amax",
        include_self=True)
    return crit_flat[:RS], dmax, worst, arr


@functools.lru_cache(maxsize=None)
def _powf():
    f = ctypes.CDLL(ctypes.util.find_library("m")).powf
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float, ctypes.c_float]
    return f


def libm_powf(x: np.ndarray, e: float) -> np.ndarray:
    """float32 ``x ** e`` element by element through the C library's
    ``powf`` (zeros stay zero; e > 0)."""
    out = np.array(x, dtype=np.float32)
    flat = out.reshape(-1)
    powf = _powf()
    for i in np.flatnonzero(flat):
        flat[i] = powf(float(flat[i]), e)
    return out


class TimingAnalyzer:
    """Owns the timing graph on one device and exposes the router's
    callback (JAX ``TimingAnalyzer``).  ``device`` defaults to ``cuda``
    (raises without a card); the router that takes this analyzer must
    run on the same device.

    ``sdc``: optional timing.sdc.SdcConstraints — constrained mode
    (per-clock-domain required times, read_sdc.c semantics); without it
    one ideal clock normalised to the critical path is assumed."""

    def __init__(self, tg: TimingGraph, crit_exp: float = 1.0,
                 max_crit: float = 0.99, sdc=None, device="cuda"):
        self.tg = tg
        self.device = resolve_device(device)
        self.dev = to_device(tg, self.device)
        self.crit_exp = crit_exp
        self.max_crit = max_crit
        self.crit_path_delay = float("nan")
        self.worst_slack = float("nan")
        self.sdc = sdc
        self._req_seed = None
        if sdc is not None:
            # a typo'd -clock reference must error, not silently fall
            # back to the default period
            declared = set(sdc.clock_periods) | set(sdc.virtual_clocks)
            for port, (clk, _d) in list(sdc.input_delays.items()) + \
                    list(sdc.output_delays.items()):
                if clk is not None and clk not in declared:
                    raise ValueError(
                        f"I/O delay on {port!r} references undeclared "
                        f"clock {clk!r}")
            req = np.full(tg.num_tnodes, np.inf, dtype=np.float32)
            default = sdc.default_period or np.inf
            for t in np.where(tg.is_endpoint)[0]:
                d = int(tg.endpoint_domain[t])
                cname = tg.domains[d] if d >= 0 else None
                p = sdc.period_of(cname) if d >= 0 else default
                p = p if p is not None else np.inf
                # set_multicycle_path -setup relaxes to N periods
                if np.isfinite(p):
                    p = p * sdc.multicycle_for(cname)
                req[t] = p
            # set_output_delay: required time = N * period - delay
            for port, (clk, dly) in sdc.output_delays.items():
                t = (tg.outpad_tnode or {}).get(port)
                if t is None:
                    raise ValueError(
                        f"set_output_delay: unknown output port {port!r}")
                p = sdc.period_of(clk)
                p = p if p is not None else np.inf
                if np.isfinite(p):
                    req[t] = p * sdc.multicycle_for(clk) - dly
            self._req_seed = torch.from_numpy(req).to(self.device)
            # set_input_delay: the pad launches after the external delay
            if sdc.input_delays:
                arr0 = np.array(tg.arrival0, copy=True)
                for port, (clk, dly) in sdc.input_delays.items():
                    t = (tg.inpad_tnode or {}).get(port)
                    if t is None:
                        raise ValueError(
                            f"set_input_delay: unknown input port "
                            f"{port!r}")
                    arr0[t] = dly
                self.dev.arrival0 = torch.from_numpy(arr0).to(self.device)

    def sta_kwargs(self) -> dict:
        """The keyword arguments of route_window_planes that run this
        analysis between iterations inside a window."""
        return dict(tdev=self.dev, req_seed=self._req_seed,
                    sta_depth=self.tg.depth, crit_exp=self.crit_exp,
                    max_crit=self.max_crit,
                    use_sdc=self._req_seed is not None)

    def analyze(self, sink_delay: np.ndarray) -> np.ndarray:
        """sink_delay [R, Smax] -> criticalities [R, Smax]; also records
        crit_path_delay and worst_slack, both in seconds.

        An exponent other than 1 and 2 is applied on the host with the C
        library's ``powf``, as XLA:CPU applies it (it rewrites x ** 2 as
        x * x and calls ``powf`` otherwise); ``torch.pow`` differs from
        it in the last bit on about 2% of inputs at exponent 8.  The
        exponent is monotone on [0, 1], so it commutes with the per-slot
        max of sta_crit."""
        R, Smax = sink_delay.shape
        flat = np.append(np.asarray(sink_delay, np.float32).ravel(),
                         np.float32(0.0))
        host_pow = self.crit_exp not in (1.0, 2.0)
        crit, dmax, worst, _ = sta_crit(
            self.dev, torch.from_numpy(flat).to(self.device), self.tg.depth,
            1.0 if host_pow else self.crit_exp, self.max_crit,
            req_seed=self._req_seed, use_sdc=self._req_seed is not None)
        self.crit_path_delay = float(dmax)
        self.worst_slack = float(worst)
        crit = crit.cpu().numpy().reshape(R, Smax)
        return libm_powf(crit, self.crit_exp) if host_pow else crit

    def timing_cb(self, result) -> np.ndarray:
        """The router's timing_cb hook; stamps the crit-path delay into
        the last stats row."""
        crit = self.analyze(result.sink_delay)
        if result.stats:
            result.stats[-1].crit_path_delay = self.crit_path_delay
        return crit
