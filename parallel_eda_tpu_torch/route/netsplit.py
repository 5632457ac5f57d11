"""The net axis of a (net, node) mesh (parallel/shard.py) inside the
batch steps: each step's B nets are cut into contiguous chunks of B / n,
one per net-axis member, as the JAX package's ``P("net")`` sharding
cuts them.

A member routes its chunk on its own device against the step's
occupancy; the home device (the Router's, where every whole-circuit
array lives) gathers the rows back and sums the members' integer
occupancy deltas in member order.  A net's route does not depend on the
other nets of its step, so the rows equal the one-device step's, and so
does the int32 sum.

The step functions are written as coroutines (generators) that yield
at every host decision a device flag and a combine rule, ``("any", t)``
or ``("all", t)``: a wave that starts while some sink remains, a
traceback that stops once every walk is done, a fixpoint loop that
stops once no net improved.  ``run1`` drives one member, reading each
flag as it comes, which is exactly the one-device loop.  ``lockstep``
drives the members together: it advances every member to its next
flag (so that each device's work is queued before the host waits on
any), combines the flags on the home device and reads that one value,
the read the one-device step makes at the same point.  Every member
therefore runs the one-device step's loop trips; the trips past a
member's own fixpoint leave its state as it is.  Cross-device copies
(the rows out, the flags and rows back) are PyTorch's, which order the
two devices' current streams by events, with no host wait.

Per-wave step counts combine by max over the members: a relaxation's
count is the max over its nets (the loop runs until no net improves),
so the max over members' counts is the one-device count.

The node axis: each net-axis member is a row of the mesh, and its step
runs on the row's first device.  Where the row has more than one
device, the step's relaxations split their work over the row: the
planes relaxation's canvases by columns (planes.planes_relax_node,
nodesplit.py), the ELL relaxation's rr-graph rows (search._relax_co).
``split_run`` hands each member its row in place of ``NODE_ROW`` in the
static arguments (None for a row of one device).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch



class _NodeRow:
    """The static-argument placeholder split_run replaces by each
    member's node row."""

    def __repr__(self):
        return "NODE_ROW"


NODE_ROW = _NodeRow()


def node_rows(mesh):
    """The rows of ``mesh`` (one per net-axis member, in order), each the
    tuple of its node-axis devices.  Raises TypeError for anything but a
    parallel.shard.Mesh."""
    from ..parallel.shard import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.shard.Mesh, got "
                        f"{type(mesh).__name__}")
    return tuple(tuple(row) for row in mesh.devices)


def net_members(mesh):
    """The devices the net axis's chunks run on, in order: each row's
    first device."""
    return tuple(row[0] for row in node_rows(mesh))


def chunks(B: int, n: int):
    """The members' row slices of a B-wide step (B divisible by n)."""
    if B % n:
        raise ValueError(f"batch {B} not divisible by net axis {n}")
    c = B // n
    return [slice(k * c, (k + 1) * c) for k in range(n)]


# (id(obj), device) -> (weak reference to obj, its copy): the graphs'
# member copies, dropped with the object they copy
_COPIES: dict = {}


def member_copy(obj, device: torch.device):
    """``obj`` (a dataclass of tensors: DeviceRRGraph, PlanesGraph) with
    every tensor on ``device``, built once per (object, device) and kept
    as long as ``obj`` lives; ``obj`` itself where its tensors are there
    already."""
    t0 = next(v for v in (getattr(obj, f.name)
                          for f in dataclasses.fields(obj))
              if isinstance(v, torch.Tensor))
    if t0.device == device:
        return obj
    key = (id(obj), str(device))
    hit = _COPIES.get(key)
    if hit is not None and hit[0]() is obj:
        return hit[1]
    cp = dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
    _COPIES[key] = (weakref.ref(obj), cp)
    weakref.finalize(obj, _COPIES.pop, key, None)
    return cp


def run1(gen):
    """Drive one step coroutine, reading each yielded flag on the host
    as it comes; returns the coroutine's value."""
    try:
        _, flag = next(gen)
        while True:
            _, flag = gen.send(bool(flag))
    except StopIteration as e:
        return e.value


def lockstep(gens, home: torch.device):
    """Drive the members' step coroutines together: at each yield every
    member's flag is copied to ``home``, combined by the yielded rule
    and read once, and the decision is sent to every member.  Returns
    the members' values, in order.  One member: ``run1``."""
    if len(gens) == 1:
        return [run1(gens[0])]
    outs = [None] * len(gens)
    send = None
    while True:
        reqs = []
        for k, g in enumerate(gens):
            try:
                reqs.append(g.send(send))
            except StopIteration as e:
                outs[k] = e.value
        if len(reqs) == 0:
            return outs
        if len(reqs) != len(gens) or len({op for op, _ in reqs}) != 1:
            raise RuntimeError("net-mesh members left lockstep")
        flags = torch.stack([t.to(home) for _, t in reqs])
        send = bool(flags.any() if reqs[0][0] == "any" else flags.all())


def split_run(co, mesh, home: torch.device, rows, shared, graphs, rest,
              keep=None):
    """Run the step coroutine ``co`` over a step's rows: one member on
    ``home`` (``mesh`` None), else one chunk of B / n rows per member of
    ``mesh``'s net axis, on the member's device, in lockstep.  ``co``
    takes (*graphs, *shared, *rows, *rest): ``graphs`` dataclasses of
    tensors (each member's copy, member_copy), ``shared`` tensors every
    member reads whole (copied to its device), ``rows`` the [B, ...] row
    tensors on ``home`` (each member's chunk copied to its device),
    ``rest`` the static arguments, where ``NODE_ROW`` becomes the member's
    node row (None for a row of one device, and without a mesh).
    ``keep`` (row positions, or None for all) drops rows first; a member
    left with none takes no part.  Returns the members' values, in
    member order."""
    B = rows[0].shape[0]
    keep_set = None if keep is None else set(keep)
    if mesh is None:
        parts = [(home, range(B), None)]
    else:
        nrows = node_rows(mesh)
        parts = [(row[0], range(sl.start, sl.stop),
                  row if len(row) > 1 else None)
                 for row, sl in zip(nrows, chunks(B, len(nrows)))]
    gens = []
    for d, pos, node in parts:
        if keep_set is not None:
            pos = [i for i in pos if i in keep_set]
        if not len(pos):
            continue
        if len(pos) == B:
            rws = rows
        else:
            idx = torch.tensor(list(pos), device=home)
            rws = [r[idx] for r in rows]
        gens.append(co(*(member_copy(g, d) for g in graphs),
                       *(t.to(d) if isinstance(t, torch.Tensor) else t
                         for t in shared),
                       *(r.to(d) for r in rws),
                       *(node if a is NODE_ROW else a for a in rest)))
    return lockstep(gens, home)


def sum_waves(waves, zero):
    """Per-wave step counts summed onto ``zero`` (its shape, dtype and
    device)."""
    steps = zero
    for s in waves:
        steps = steps + s.to(zero.device)
    return steps


def gather(outs, home: torch.device, delta_at: int, waves_at: int,
           zero=None):
    """The members' values from split_run merged on ``home``: the [N]
    int32 occupancy deltas at ``delta_at`` summed in member order, the
    per-wave step lists at ``waves_at`` reduced by max over members and
    summed (onto ``zero``, default an int32 scalar 0), every other value
    (a row block) concatenated."""
    if zero is None:
        zero = torch.zeros((), dtype=torch.int32, device=home)
    merged = []
    for j in range(len(outs[0])):
        vals = [o[j] for o in outs]
        if j == delta_at:
            acc = vals[0].to(home)
            for v in vals[1:]:
                acc = acc + v.to(home)
            merged.append(acc)
        elif j == waves_at:
            merged.append(sum_waves(wave_max(vals, home), zero))
        else:
            merged.append(to_home(vals, home))
    return merged


def to_home(ts, home: torch.device):
    """The members' row blocks ``ts`` concatenated on ``home`` (one
    member: its block as it is)."""
    if len(ts) == 1:
        return ts[0].to(home)
    return torch.cat([t.to(home) for t in ts])


def wave_max(per_member, home: torch.device):
    """Per-wave step counts of the members (lists of equal length, each
    entry a device tensor) -> one list, each wave's max over members."""
    if len(per_member) == 1:
        return per_member[0]
    return [torch.stack([w.to(home) for w in ws]).amax(dim=0)
            for ws in zip(*per_member)]
