"""Multi-device routing over a (net, node) mesh: the counterpart of
parallel_eda_tpu/parallel/shard.py.

The JAX package maps the reference's two distribution strategies onto
the two axes of a jax.sharding.Mesh:

- the "net" axis is the MPI flagship's net partitioning
  (mpi_route_load_balanced_nonblocking_send_recv_encoded.cxx:402): the
  batch of nets of each step is split across devices, and the per-net
  usage masks are summed into one global occupancy delta by one
  deterministic integer reduction;
- the "node" axis is the rr-graph spatial partitioning
  (rr_graph_partitioner.h:840): the canvases' X axis sharded across
  devices.

Here a ``Mesh`` is a [net][node] grid of ``torch.device``s.  The net
axis is ported: ``Router(rr, opts, mesh=m)``, ``run_route(...,
mesh=m)`` and ``ShardedRouter.route_step`` cut each step's B nets into
contiguous chunks of B / n, one per row of the mesh, each routed on its
row's first device, and sum the members' int32 occupancy deltas on the
home device in member order (route/netsplit.py).  A net's route does
not depend on the other nets of its step, so the result is
bit-identical to one device, as the JAX package's is.  The node axis
splits each row's work over the row's devices: the planes relaxation's
canvases by columns, with a line scan across the members that keeps
``lax.associative_scan``'s grouping (route/nodesplit.py, planes.
planes_relax_node; on a card one launch of the node kernel per card of
the row), and the ELL relaxation's rr-graph rows (search._relax_co).
Every split computes the same operations on the same operands, so the
route stays bit-identical to one device at any mesh shape.

A mesh may repeat a device: ``make_mesh(2, devices=["cpu"] * 2)`` is a
virtual two-member mesh on the CPU (the tests' counterpart of JAX's
8-device virtual CPU mesh), ``devices=["cuda:0"] * 4`` one on a card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import get_metrics, span
from ..route.device_graph import DeviceRRGraph
from ..route.netsplit import member_copy
from ..route.search import route_and_commit

NET, NODE = "net", "node"


class Mesh:
    """A (net, node) grid of torch devices: ``devices`` an object array
    of shape (net, node), ``shape`` {"net": n, "node": m} as
    jax.sharding.Mesh.shape gives it.  Equal meshes hash equal (the
    Router keys its dispatch variants on the mesh)."""

    def __init__(self, devices):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for i, row in enumerate(devices):
            for j, d in enumerate(row):
                arr[i, j] = _device(d)
        self.devices = arr
        self.shape = {NET: int(arr.shape[0]), NODE: int(arr.shape[1])}

    def _key(self):
        return tuple(str(d) for d in self.devices.flat) + (
            self.shape[NET],)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh(net={self.shape[NET]}, node={self.shape[NODE]}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _device(d) -> torch.device:
    """``d`` as a torch.device; a card without an index is the current
    card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _cards():
    """The visible cards, in index order."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D (net, node) mesh over the first devices (JAX shard.py:48):
    the visible cards, or ``devices`` (which may repeat one: a virtual
    mesh on one card or on ``"cpu"``).  ``shape=None`` puts every device
    on the net axis.  The shape checks and their messages are JAX's."""
    devs = _cards() if devices is None else list(devices)
    hint = "pass devices=[...], which may repeat one, e.g. ['cpu'] * n"
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices but only "
                             f"{len(devs)} are visible ({hint})")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError(f"no CUDA card is visible ({hint})")
    if shape is None:
        shape = (n, 1)
    shape = tuple(shape)
    # validate BEFORE any shape[i] access, as JAX does
    if len(shape) != 2:
        raise ValueError(f"mesh shape must be 2-D (net, node), got "
                         f"{shape!r} with {len(shape)} axis(es)")
    if not all(isinstance(s, (int, np.integer)) and s >= 1
               for s in shape):
        raise ValueError(f"mesh shape axes must be positive ints, got "
                         f"{shape!r}")
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} needs "
                         f"{shape[0] * shape[1]} devices, have {n} "
                         f"(net axis {shape[0]} x node axis {shape[1]})")
    return Mesh([devs[i * shape[1]:(i + 1) * shape[1]]
                 for i in range(shape[0])])


def make_multislice_mesh(num_slices: int, chips_per_slice: int,
                         node_per_slice: int = 1,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The multi-slice (net, node) mesh (JAX shard.py:97): devices in
    slice-major order, every node-axis row inside one slice, the net
    axis across slices.  Cards report no slice membership, so the layout
    is the convention alone (JAX's branch for devices without
    ``slice_index``)."""
    if num_slices < 1 or chips_per_slice < 1 or node_per_slice < 1:
        raise ValueError("num_slices, chips_per_slice, node_per_slice "
                         "must all be >= 1")
    if chips_per_slice % node_per_slice:
        raise ValueError(f"chips_per_slice {chips_per_slice} not "
                         f"divisible by node_per_slice {node_per_slice}")
    total = num_slices * chips_per_slice
    if devices is None:
        devices = _cards()
    if len(devices) < total:
        raise ValueError(f"need {total} devices, have {len(devices)}")
    return make_mesh(total, shape=(total // node_per_slice, node_per_slice),
                     devices=devices)


def shard_graph(dev: DeviceRRGraph, mesh: Mesh):
    """Place the rr-graph on the mesh (JAX shard.py:143): one copy per
    member, on its device (``dev`` itself where it is there already).
    Returns the members' graphs row by row (the net axis's rows, each
    its node-axis members in order), ``mesh.devices.flat``'s order."""
    return [member_copy(dev, d) for d in mesh.devices.flat]


class ShardedRouter:
    """Binds a (net, node) mesh to the fused single-step route
    (search.route_and_commit), as JAX's does by input shardings.  For
    the complete negotiation loop use route.Router(..., mesh=mesh)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shard_graph(self, dev: DeviceRRGraph):
        return shard_graph(dev, self.mesh)

    def route_step(self, dev, occ, acc, pres_fac,
                   prev_paths, source, sinks, bb, crit, net_key, valid,
                   max_steps: int, max_len: int, num_waves: int,
                   group: int = 1):
        """One route_and_commit step over the mesh: the batch split over
        its rows, each row's relaxations over the row's devices.  ``dev``
        is the graph (or shard_graph's list, whose first member is
        taken); the batch tensors and ``occ``/``acc`` lie on the home
        device, which gets the results.  Batch size must be divisible by
        the mesh's net-axis size."""
        if isinstance(dev, (list, tuple)):
            dev = dev[0]
        B = source.shape[0]
        n_net = self.mesh.shape[NET]
        if B % n_net:
            raise ValueError(f"batch {B} not divisible by net axis "
                             f"{n_net}")
        # per-step telemetry, under JAX's names: the span covers the
        # chunks' dispatch and the lockstep host reads
        reg = get_metrics()
        reg.counter("shard.route_steps").inc()
        reg.gauge("shard.batch_per_device").set(B // n_net)
        reg.gauge("shard.mesh_net").set(int(n_net))
        reg.gauge("shard.mesh_node").set(int(self.mesh.shape[NODE]))
        with span("shard.route_step", cat="parallel", batch=int(B),
                  net_axis=int(n_net),
                  node_axis=int(self.mesh.shape[NODE])):
            return route_and_commit(
                dev, occ, acc, pres_fac, prev_paths, source, sinks, bb,
                crit, net_key, valid, max_steps, max_len, num_waves, group,
                mesh=self.mesh)
