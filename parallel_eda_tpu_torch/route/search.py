"""The congestion and bookkeeping helpers of parallel_eda_tpu/route/search.py
that the planes program calls (the ELL search itself is not ported yet).

Every function takes and returns tensors on the caller's device and
computes in float32 / int32 exactly as the JAX functions do.
"""

from __future__ import annotations

import torch

from .device_graph import DeviceRRGraph

# relative magnitude of the symmetry-breaking congestion jitter (see the
# JAX package's search.py for why a deterministic per-(net, node)
# perturbation is needed)
JITTER_EPS = 0.02


def congestion_cost_arrays(base, capacity, occ, acc, pres_fac):
    """base * pres * acc, pres = 1 + over * pres_fac where the node would
    be overused with one more user (route_common.c get_rr_cong_cost)."""
    over = occ + 1 - capacity
    one = torch.ones((), dtype=torch.float32, device=base.device)
    pres = torch.where(over > 0, 1.0 + over.to(torch.float32) * pres_fac,
                       one)
    return base * pres * acc


def congestion_cost(dev: DeviceRRGraph, occ, acc, pres_fac):
    """Per-node congestion cost; ``occ`` may be [N] or [B, N] (each net
    sees the occupancy of everyone but itself)."""
    return congestion_cost_arrays(dev.cong_base, dev.capacity, occ, acc,
                                  pres_fac)


def usage_from_paths(path, num_nodes: int):
    """Per-net deduplicated node usage mask: path [B, S, L] with
    sentinel N -> bool [B, N]."""
    B = path.shape[0]
    flat = path.reshape(B, -1).long()
    u = torch.zeros((B, num_nodes + 1), dtype=torch.bool,
                    device=path.device)
    u.scatter_(1, flat, True)
    return u[:, :-1]


def iteration_summary(dev: DeviceRRGraph, occ, paths, all_reached,
                      steps_total):
    """(reroute mask, reached flags, #overused nodes, total overuse,
    steps) — the per-iteration summary of the JAX package."""
    over = torch.clamp(occ - dev.capacity, min=0)
    over_p1 = torch.cat([occ > dev.capacity,
                         torch.zeros(1, dtype=torch.bool,
                                     device=occ.device)])
    rrm = over_p1[paths.long()].flatten(1).any(dim=1) | ~all_reached
    return (rrm, all_reached, (over > 0).sum().to(torch.int32),
            over.sum().to(torch.int32), steps_total)


def wirelength_on_device(dev: DeviceRRGraph, paths) -> torch.Tensor:
    """Number of distinct CHANX/CHANY nodes used by any net."""
    N = dev.num_nodes
    used = torch.zeros(N + 1, dtype=torch.bool, device=paths.device)
    used[paths.reshape(-1).long()] = True
    return (used[:N] & dev.is_wire).sum().to(torch.int32)
