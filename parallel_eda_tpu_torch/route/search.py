"""Batched shortest-path search: the counterpart of
parallel_eda_tpu/route/search.py.

The congestion and bookkeeping helpers here serve both programs.  The
rest is the ELL program (``RouterOpts(program="ell")``): a pull-based
Bellman-Ford relaxation over the padded in-edge table, batched over
nets,

    dist[b, v] <- min(dist[b, v],
                      min_d dist[b, ell_src[v, d]] + w(b, v, d))

with w = crit_b * edge_delay + (1 - crit_b) * cong_cost[b, v] (the
PathFinder cost of route_timing.c timing_driven_expand_neighbours),
multi-sink nets routed incrementally in sink waves seeded with the tree
so far, and per-net bounding boxes either as a mask over the whole
device (the global program) or as gathered [Nbox] windows with
localized in-edge tables and an admissible A* gate (the windowed
program).

Every function takes and returns tensors on the caller's device and
computes in float32 / int32 exactly as the JAX functions do: the same
operations in the same order (a product and the sum it feeds rounded
separately), first-index argmin, stable sorts, and JAX's step counts.
The JAX package runs its loops as device while_loops; here a loop
yields its exit condition every few steps to the step's driver
(netsplit.py: one device reads it on the host; the members of a net
mesh's step are combined first), a fixpoint being stable, so the extra
steps change nothing, while its step counter stops on the device at the
step JAX stops at.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .device_graph import DeviceRRGraph
from .netsplit import NODE_ROW, gather, member_copy, run1, split_run, sum_waves

INF = float("inf")
_F32, _I32 = torch.float32, torch.int32

# relative magnitude of the symmetry-breaking congestion jitter (see the
# JAX package's search.py for why a deterministic per-(net, node)
# perturbation is needed)
JITTER_EPS = 0.02

# a relaxation or traceback loop reads its exit condition on the host
# once per this many steps
_CHECK_EVERY = 8


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


def congestion_jitter(net_key, node_ids):
    """The deterministic per-(net, node) jitter in [1, 1 + JITTER_EPS):
    net_key [B] and node_ids [N] or [B, N] (global node ids) ->
    f32 [B, N].  JAX hashes in int32 with wraparound; only the hash's
    low 16 bits are read, so the int64 product (no wrap) gives the same
    bits."""
    if node_ids.dim() == 1:
        node_ids = node_ids[None, :]
    h = (net_key.long()[:, None] * (2654435761 & 0x7FFFFFFF)
         + node_ids.long() * 40503)
    return 1.0 + JITTER_EPS * ((h & 0xFFFF).to(_F32) / 65536.0)


def usage_from_paths(path, num_nodes: int):
    """Per-net deduplicated node usage mask: path [B, S, L] with
    sentinel N -> bool [B, N]."""
    B = path.shape[0]
    flat = path.reshape(B, -1).long()
    u = torch.zeros((B, num_nodes + 1), dtype=torch.bool,
                    device=path.device)
    u.scatter_(1, flat, True)
    return u[:, :-1]


def occupancy_delta(usage, valid):
    """Sum per-net usage masks into an occupancy delta [N] (int32)."""
    return (usage & valid[:, None]).sum(dim=0, dtype=_I32)


def _fixpoint(step, state, max_steps: int, device):
    """Run ``step`` (state -> (state, improved)) until a step improves
    nothing, at most ``max_steps`` times: lax.while_loop's
    (state, steps), steps counting up to and including the first step
    that improves nothing.  A coroutine (netsplit.py): the exit
    condition is yielded every _CHECK_EVERY steps; the steps past the
    fixpoint leave the state as it is and are not counted."""
    live = torch.ones((), dtype=torch.bool, device=device)
    steps = torch.zeros((), dtype=_I32, device=device)
    for it in range(max_steps):
        if it and it % _CHECK_EVERY == 0 and not (yield "any", live):
            break
        state, improved = step(state)
        steps = steps + live.to(_I32)
        live = live & improved
    return state, steps


def _blocks(D: int):
    """The ELL slot blocks of JAX's relaxation: DB = min(8, D) slots
    each, the last block shifted to D - DB (it overlaps the one before;
    the strict < merge keeps the earlier slot on a tie)."""
    DB = min(8, D)
    return [(min(b * DB, D - DB), DB) for b in range(-(-D // DB))]


def _min_over_blocks(gather_ds, terms, cong3, shape, device, dim: int):
    """One relaxation step's candidate minimum over the in-edge blocks:
    per block, cand = (dist[src] + crit*w) + cong, its min and first
    argmin over the slot axis ``dim`` (torch.min, as jnp.argmin, takes
    the first index), merged across blocks with a strict <.  ``terms``
    holds per block (d0, the crit*w term); ``gather_ds(b)`` gives block
    b's dist[src].  Returns (best, slot): slot the winning in-edge slot,
    -1 where every candidate is INF."""
    best = torch.full(shape, INF, dtype=_F32, device=device)
    gslot = torch.full(shape, -1, dtype=torch.long, device=device)
    for b, (d0, cw) in enumerate(terms):
        cand3 = gather_ds(b).add_(cw).add_(cong3)
        bbest, slot = torch.min(cand3, dim=dim)
        better = bbest < best
        best = torch.where(better, bbest, best)
        gslot = torch.where(better, slot + d0, gslot)
    return best, gslot


def _relax(dev: DeviceRRGraph, cong_c, crit_c, inside, seed, seed_tdel,
           max_steps: int):
    """One seeded Bellman-Ford solve for a batch (JAX search.py:77): the
    coroutine _relax_co driven alone."""
    return run1(_relax_co(dev, cong_c, crit_c, inside, seed, seed_tdel,
                          max_steps))


def node_blocks(N: int, m: int):
    """The rr-graph rows [n0, n1) of the m members of a node row: the
    contiguous blocks of ceil(N / m) rows, in member order (a member
    past the last row gets none)."""
    c = -(-N // m)
    return [(k * c, min((k + 1) * c, N)) for k in range(m) if k * c < N]


def _relax_co(dev: DeviceRRGraph, cong_c, crit_c, inside, seed, seed_tdel,
              max_steps: int, node=None):
    """_relax as a coroutine (netsplit.py).

    cong_c [B, N] congestion term (already scaled by (1-crit) and
    jitter); crit_c [B, 1] delay-term weight; inside [B, N] bb mask;
    seed [B, N] tree nodes (dist 0); seed_tdel [B, N] true delay from the
    source at tree nodes.  Returns (dist, prev, tdel, steps): tdel is the
    accumulated pure delay along the chosen min-cost path; steps an
    int32 device scalar.

    Loop-invariant terms are formed once: crit*w per block with the
    invalid slots at INF (JAX's masked candidate: INF + cong is INF), and
    the congestion term at INF outside the box (JAX's masked cand: such
    a node never improves).  The loop runs node-major ([N, B] state) and
    slot-major within a block ([DB, N, B] candidates): a node's in-edge
    gather copies whole rows of B values, and the slot min reduces across
    whole [N, B] planes.  The winning slot's source and delay are
    gathered once per step.

    ``node`` (a node row of the mesh, or None) splits each step's rows
    over the row's devices (node_blocks; JAX shards the ELL tables and
    the [N] arrays over the node axis, parallel/shard.py:143): each
    member reads the whole dist and tdel, copied to it every step,
    computes its rows' best, source and delay with the same operations
    in the same slot order on its own copy of the graph, and the rows
    come back to this device in member order.  Row by row the values
    are the one-device values."""
    B, N = cong_c.shape
    device = cong_c.device
    dist0 = torch.where(seed, 0.0, INF).T.contiguous()
    tdel0 = torch.where(seed, seed_tdel, 0.0).T.contiguous()
    prev0 = torch.full((N, B), -1, dtype=_I32, device=device)
    crit3 = crit_c[:, 0][None, None, :]
    blocks = _blocks(dev.max_in_degree)
    cong3 = torch.where(inside, cong_c, INF).T.contiguous()[None]

    def part(d, n0, n1):
        # rows n0..n1-1 on device d: the step's tables and its function
        g = member_copy(dev, d)
        rows = slice(n0, n1)
        c3 = crit3.to(d)
        srcs = [g.ell_src[rows, d0:d0 + DB].T.reshape(-1).long()
                for d0, DB in blocks]
        terms = [(d0, torch.where(g.ell_valid[rows, d0:d0 + DB].T[:, :, None],
                                  c3 * g.ell_delay[rows, d0:d0 + DB].T[
                                      :, :, None], INF))
                 for d0, DB in blocks]
        cong = cong3[:, rows].to(d)
        src_all = g.ell_src[rows].long()
        delay = g.ell_delay[rows]
        n = n1 - n0

        def run(dist, tdel):
            dist, tdel = dist.to(d), tdel.to(d)
            best, gslot = _min_over_blocks(
                lambda b: torch.index_select(dist, 0, srcs[b]).view(-1, n, B),
                terms, cong, (n, B), d, dim=0)
            slot = gslot.clamp(min=0)
            bsrc = torch.gather(src_all, 1, slot)
            btdel = torch.gather(tdel, 0, bsrc) + torch.gather(delay, 1, slot)
            return best, bsrc, btdel
        return run

    if node is None:
        parts = [part(device, 0, N)]
    else:
        parts = [part(d, n0, n1) for d, (n0, n1)
                 in zip(node, node_blocks(N, len(node)))]

    def step(state):
        dist, prev, tdel = state
        outs = [run(dist, tdel) for run in parts]
        best, bsrc, btdel = (
            outs[0][k] if len(outs) == 1
            else torch.cat([o[k].to(device) for o in outs])
            for k in range(3))
        improved = best < dist
        return ((torch.where(improved, best, dist),
                 torch.where(improved, bsrc.to(_I32), prev),
                 torch.where(improved, btdel, tdel)), improved.any())

    (dist, prev, tdel), steps = yield from _fixpoint(
        step, (dist0, prev0, tdel0), max_steps, device)
    return (dist.T.contiguous(), prev.T.contiguous(), tdel.T.contiguous(),
            steps)


def _traceback(prev, seed, sink, max_len: int):
    """Walk prev pointers from each sink until a seed (tree) node
    (JAX search.py:152): prev [B, N], seed [B, N], sink [B, G] (-1: none).
    Returns (path [B, G, max_len] node ids, sentinel N = pad; reached
    [B, G]).  The joining tree node is included in the path.  A
    coroutine (netsplit.py)."""
    B, N = prev.shape
    G = sink.shape[1]
    valid0 = sink >= 0
    node = torch.where(valid0, sink, -1).long()
    done = ~valid0
    prevl = prev.long()
    path = torch.full((B, G, max_len), N, dtype=_I32, device=prev.device)
    for pos in range(max_len):
        # a finished walk emits the pad and stays put: skip the rest
        if pos % _CHECK_EVERY == 0 and (yield "all", done.all()):
            break
        nc = node.clamp(min=0)
        at_tree = torch.gather(seed, 1, nc)
        stop = done | (node < 0)
        path[:, :, pos] = torch.where(stop, N, node).to(_I32)
        node = torch.where(stop | at_tree, node, torch.gather(prevl, 1, nc))
        done = stop | at_tree
    reached = valid0 & (node >= 0) & torch.gather(seed, 1, node.clamp(min=0))
    path = torch.where(reached[:, :, None], path, N)
    return path, reached


def _scatter_rows(arr, idx, vals):
    """arr [B, S, L], idx [B, G], vals [B, G, L] -> arr with rows
    replaced."""
    return arr.scatter(1, idx[:, :, None].expand(-1, -1, arr.shape[2]),
                       vals)


def _scatter_vals(arr, idx, vals):
    """arr [B, S], idx [B, G], vals [B, G]."""
    return arr.scatter(1, idx, vals)


def _pick_sinks(dist_at_sinks, remaining, crit, group: int):
    """The wave's sink pick (JAX search.py:240-249): most critical first,
    nearest to the current tree among equals, up to ``group`` sinks;
    argsort is stable, as jnp.argsort (the INF scores tie).  Returns
    (order [B, G] sink slots, pick_valid [B, G])."""
    score = torch.where(remaining & torch.isfinite(dist_at_sinks),
                        dist_at_sinks - crit * 1e3, INF)
    order = torch.argsort(score, dim=1, stable=True)[:, :group]
    pick_valid = (torch.gather(remaining, 1, order)
                  & torch.isfinite(torch.gather(score, 1, order)))
    return order, pick_valid


def _store_wave(order, ok, seg, d_new, paths, delay, reached_all,
                remaining):
    """Store a wave's segments and delays at the picked sink slots."""
    old = torch.gather(paths, 1, order[:, :, None].expand(
        -1, -1, paths.shape[2]))
    paths = _scatter_rows(paths, order, torch.where(ok[:, :, None], seg,
                                                    old))
    delay = _scatter_vals(delay, order, torch.where(
        ok, d_new, torch.gather(delay, 1, order)))
    reached_all = _scatter_vals(reached_all, order,
                                ok | torch.gather(reached_all, 1, order))
    remaining = _scatter_vals(remaining, order,
                              torch.gather(remaining, 1, order) & ~ok)
    return paths, delay, reached_all, remaining


def _grow_tree(ok, seg, tdel, tdel_tree, seed, n: int):
    """Segment nodes become seeds with their true delay (the tree grows);
    seed [B, n], ``n`` the node count (the sentinel)."""
    B = seg.shape[0]
    flat = torch.where(ok[:, :, None], seg, n).reshape(B, -1).long()
    newly = torch.zeros((B, n + 1), dtype=torch.bool, device=seg.device)
    newly.scatter_(1, flat, True)
    newly = newly[:, :n]
    return torch.where(newly, tdel, tdel_tree), seed | newly


def _bb_inside(dev: DeviceRRGraph, bb):
    """bb [B, 4] (xmin, xmax, ymin, ymax) -> in-box node mask [B, N]."""
    return ((dev.xhigh[None, :] >= bb[:, 0, None])
            & (dev.xlow[None, :] <= bb[:, 1, None])
            & (dev.yhigh[None, :] >= bb[:, 2, None])
            & (dev.ylow[None, :] <= bb[:, 3, None]))


def route_net_batch(dev: DeviceRRGraph, cong, source, sinks, bb, crit,
                    net_key, max_steps: int, max_len: int,
                    num_waves: int, group: int):
    """Route a batch of B nets completely: all sinks, the tree grown
    incrementally (JAX search.py:184).

    cong [B, N] per-net congestion cost; source [B]; sinks [B, S] (-1
    pad); bb [B, 4]; crit [B, S] per-sink criticalities; net_key [B]
    stable ids for the jitter.  Returns (paths [B, S, max_len] sink->tree
    segments, reached [B, S], sink_delay [B, S], usage [B, N] tree-node
    masks, relax_steps: an int32 device scalar, the sum of every wave's
    Bellman-Ford steps)."""
    p, reached, delay, usage, waves = run1(_route_net_batch_co(
        dev, cong, source, sinks, bb, crit, net_key, max_steps, max_len,
        num_waves, group))
    return p, reached, delay, usage, sum_waves(
        waves, torch.zeros((), dtype=_I32, device=cong.device))


def _route_net_batch_co(dev: DeviceRRGraph, cong, source, sinks, bb, crit,
                        net_key, max_steps: int, max_len: int,
                        num_waves: int, group: int, node=None):
    """route_net_batch as a coroutine (netsplit.py) whose last value is
    the list of each wave's step count, not their sum; ``node`` as for
    _relax_co."""
    B, S = sinks.shape
    N = dev.num_nodes
    device = cong.device
    inside = _bb_inside(dev, bb)
    jitter = congestion_jitter(net_key, torch.arange(N, device=device))
    seed = torch.zeros((B, N + 1), dtype=torch.bool, device=device)
    seed[torch.arange(B, device=device), source.long()] = True
    seed = seed[:, :N]
    tdel_tree = torch.zeros((B, N), dtype=_F32, device=device)
    remaining = sinks >= 0
    paths = torch.full((B, S, max_len), N, dtype=_I32, device=device)
    delay = torch.full((B, S), INF, dtype=_F32, device=device)
    reached_all = torch.zeros((B, S), dtype=torch.bool, device=device)
    waves = []
    sink_c = sinks.clamp(min=0).long()

    for _ in range(num_waves):
        # a batch whose sinks are all done ends the wave loop; a sink
        # that stays unreachable keeps it going to the cap (JAX's
        # wave_cond)
        if not (yield "any", remaining.any()):
            break
        # wave criticality: the strongest remaining sink
        crit_w = torch.where(remaining, crit, 0.0).amax(dim=1)
        cong_c = (1.0 - crit_w)[:, None] * cong * jitter
        dist, prev, tdel, steps = yield from _relax_co(
            dev, cong_c, crit_w[:, None], inside, seed, tdel_tree, max_steps,
            node)
        waves.append(steps)

        order, pick_valid = _pick_sinks(torch.gather(dist, 1, sink_c),
                                        remaining, crit, group)
        pick_sink = torch.where(pick_valid, torch.gather(sinks, 1, order),
                                -1)
        seg, seg_reached = yield from _traceback(prev, seed, pick_sink,
                                                 max_len)
        ok = pick_valid & seg_reached
        d_new = torch.gather(tdel, 1, pick_sink.clamp(min=0).long())
        paths, delay, reached_all, remaining = _store_wave(
            order, ok, seg, d_new, paths, delay, reached_all, remaining)
        tdel_tree, seed = _grow_tree(ok, seg, tdel, tdel_tree, seed, N)

    return paths, reached_all, delay, seed, waves


def _commit_co(dev: DeviceRRGraph, occ, acc, pres_fac, b_paths, b_src,
               b_sinks, b_bb, b_crit, net_key, valid, max_steps: int,
               max_len: int, num_waves: int, group: int, node=None):
    """One member's part of the global-program step (a coroutine,
    netsplit.py): rip up its rows' old trees, route them against the
    occupancy of everyone-but-itself and return (paths, reached, delay,
    its int32 occupancy delta [N], per-wave steps).  ``node``: its node
    row (the relaxations' rr-graph rows split over it, _relax_co)."""
    N = dev.num_nodes
    old_usage = usage_from_paths(b_paths, N) & valid[:, None]
    occ_view = occ[None, :] - old_usage.to(_I32)
    cong = congestion_cost(dev, occ_view, acc, pres_fac)
    p, reached, delay, usage, waves = yield from _route_net_batch_co(
        dev, cong, b_src, b_sinks, b_bb, b_crit, net_key, max_steps,
        max_len, num_waves, group, node)
    delta = occupancy_delta(usage, valid) - old_usage.sum(dim=0,
                                                          dtype=_I32)
    return p, reached, delay, delta, waves


def route_and_commit(dev: DeviceRRGraph, occ, acc, pres_fac, prev_paths,
                     source, sinks, bb, crit, net_key, valid,
                     max_steps: int, max_len: int, num_waves: int,
                     group: int, mesh=None):
    """One fused batch step (JAX search.py:306): rip up the batch's
    previous paths, route every net against the occupancy view of
    everyone-but-itself, commit the new occupancy.  ``mesh`` (a
    parallel.shard.Mesh) splits the B nets over its net axis
    (netsplit.py; B divisible by its size), each chunk routed on its
    row's first device with its relaxations' rr-graph rows split over
    the row (_relax_co), the deltas summed on ``occ``'s device.

    Returns (paths, reached, delay, occ_new, relax_steps)."""
    home = occ.device
    outs = split_run(_commit_co, mesh, home,
                      (prev_paths, source, sinks, bb, crit, net_key, valid),
                      (occ, acc, pres_fac), (dev,),
                      (max_steps, max_len, num_waves, group, NODE_ROW))
    p, reached, delay, delta, steps = gather(outs, home, 3, 4)
    return p, reached, delay, occ + delta, steps


def _distinct_keep(sel, valid, sel_win=None):
    """The rows of a batch that are computed: every valid row and, of the
    padded rows, the first for each distinct (sel, sel_win).  Padded
    rows with the same selection are the same net with nothing ripped
    up, so they compute the same values; one of them stands for the
    rest in the batch's step count (the relaxation runs until every row
    has converged), and the padded rows are dropped anyway.  Returns
    the kept positions, or None when every row is kept."""
    s, v = sel.cpu().numpy(), valid.cpu().numpy()
    w = None if sel_win is None else sel_win.cpu().numpy()
    seen, keep = set(), []
    for i in range(len(s)):
        key = (int(s[i]), None if w is None else int(w[i]))
        if v[i] or key not in seen:
            keep.append(i)
        if not v[i]:
            seen.add(key)
    return None if len(keep) == len(s) else keep


def _put_rows(valid, sel, dst_src):
    """Scatter the batch's rows back, dropping the padded ones (JAX's
    ``.at[sel_v].set(..., mode="drop")`` with sel_v = R at padding)."""
    rows = sel.long()[valid]
    for dst, src in dst_src:
        dst[rows] = src[valid]


def _kept(keep, home, *ts):
    """``ts`` cut to the kept positions (all of them for None)."""
    if keep is None:
        return ts
    idx = torch.tensor(keep, device=home)
    return tuple(t[idx] for t in ts)


def route_batch_resident(dev: DeviceRRGraph, occ, acc, pres_fac, paths,
                         sink_delay, all_reached, bb, source_all, sinks_all,
                         crit_all, sel, valid, full_bb, max_steps: int,
                         max_len: int, num_waves: int, group: int,
                         mesh=None):
    """One fused batch step against the whole-circuit state (JAX
    search.py:370): gather the batch rows, rip up, route every net
    against the occupancy of everyone-but-itself, commit, scatter the
    rows back, and widen the bounding box of any net with an unreached
    sink to ``full_bb``.  ``sel`` [B] picks the nets (``valid`` [B]
    masks padding: padded rows are routed and dropped, as in JAX; of
    identical ones only one is computed, _distinct_keep).  ``mesh`` (a
    parallel.shard.Mesh) routes the batch's chunks on its rows' first
    devices, each relaxation's rr-graph rows split over the row
    (netsplit.py, _relax_co).

    ``paths``, ``sink_delay``, ``all_reached`` and ``bb`` are updated IN
    PLACE (the JAX program donates them).  Returns (paths, sink_delay,
    all_reached, bb, occ_new, relax_steps)."""
    home = occ.device
    keep = _distinct_keep(sel, valid)
    sl = sel.long()
    b_sinks, b_bb = sinks_all[sl], bb[sl]
    outs = split_run(
        _commit_co, mesh, home,
        (paths[sl], source_all[sl], b_sinks, b_bb, crit_all[sl],
         sel.to(_I32), valid),
        (occ, acc, pres_fac), (dev,),
        (max_steps, max_len, num_waves, group, NODE_ROW), keep)
    p, reached, delay, delta, relax_steps = gather(outs, home, 3, 4)
    sel, valid, b_sinks, b_bb = _kept(keep, home, sel, valid, b_sinks, b_bb)
    ok = (reached | (b_sinks < 0)).all(dim=1)
    new_bb = torch.where(ok[:, None], b_bb, full_bb[None, :])
    _put_rows(valid, sel, ((paths, p), (sink_delay, delay),
                           (all_reached, ok), (bb, new_bb)))
    return paths, sink_delay, all_reached, bb, occ + delta, relax_steps


def reroute_mask(dev: DeviceRRGraph, occ, paths, all_reached):
    """Nets that must reroute: any overused node on their tree, or an
    unreached sink (route_timing.c should_route_net semantics)."""
    over_p1 = torch.cat([occ > dev.capacity,
                         torch.zeros(1, dtype=torch.bool,
                                     device=occ.device)])
    return over_p1[paths.long()].flatten(1).any(dim=1) | ~all_reached


def overuse_summary(dev: DeviceRRGraph, occ):
    """(num overused nodes, total overuse) as int32 device scalars."""
    over = torch.clamp(occ - dev.capacity, min=0)
    return (over > 0).sum().to(_I32), over.sum().to(_I32)


def iteration_summary(dev: DeviceRRGraph, occ, paths, all_reached,
                      steps_total):
    """(reroute mask, reached flags, #overused nodes, total overuse,
    steps): everything the ELL route reads per iteration, in one
    fetch."""
    n_over, over_total = overuse_summary(dev, occ)
    return (reroute_mask(dev, occ, paths, all_reached), all_reached,
            n_over, over_total, steps_total)


def conflict_subset(dev: DeviceRRGraph, occ, paths, idx_pad, K: int):
    """Conflict matrix among a padded subset of nets (JAX
    search.py:468): C[i, j] = nets idx_pad[i] and idx_pad[j] share one of
    the K most-overused nodes.  lax.top_k's order: value descending,
    then index ascending (a stable descending sort)."""
    N = dev.num_nodes
    I = idx_pad.shape[0]
    over_amt = torch.clamp(occ - dev.capacity, min=0)
    val, ids = torch.sort(over_amt, descending=True, stable=True)
    val, ids = val[:K], ids[:K].to(_I32)
    over_ids = torch.sort(torch.where(val > 0, ids, N + 1)).values
    p = paths[idx_pad.long().clamp(min=0)].reshape(I, -1)
    pos = torch.searchsorted(over_ids, p.contiguous())
    posc = pos.clamp(0, K - 1)
    hit = over_ids[posc] == p
    U = torch.zeros((I, K + 1), dtype=_F32, device=occ.device)
    U.scatter_(1, torch.where(hit, posc, K), 1.0)
    U = U[:, :K]
    # 0/1 products: the f32 matmul counts exactly
    return (U @ U.T) > 0.5


def wirelength_on_device(dev: DeviceRRGraph, paths) -> torch.Tensor:
    """Number of distinct CHANX/CHANY nodes used by any net."""
    N = dev.num_nodes
    used = torch.zeros(N + 1, dtype=torch.bool, device=paths.device)
    used[paths.reshape(-1).long()] = True
    return (used[:N] & dev.is_wire).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# Bounding-box-windowed search: each net's in-box nodes gathered into a
# fixed [Nbox] window with a localized in-edge table; the relaxation runs
# in window coordinates, rip-up, commit and stored paths stay global.
# ---------------------------------------------------------------------------


@dataclass
class WindowTables:
    """Per-net localized search windows (JAX search.py:517), built once
    per route for the windowable nets (compacted rows)."""
    win_nodes: torch.Tensor   # int32 [R, Nbox] global node id (pad: N)
    lsrc: torch.Tensor        # int32 [R, Nbox, D] local src (pad: Nbox)
    ldelay: torch.Tensor      # f32 [R, Nbox, D] (pad: 0, not inf: an inf
    #   pad would make 0*inf NaN at crit 0 and poison the block min)
    xl: torch.Tensor          # int16 [R, Nbox] node spans (A* bound)
    xh: torch.Tensor
    yl: torch.Tensor
    yh: torch.Tensor

    @property
    def nbox(self) -> int:
        return int(self.win_nodes.shape[1])

    @staticmethod
    def cat(parts) -> "WindowTables":
        """Row-wise concatenation of chunked tables."""
        if len(parts) == 1:
            return parts[0]
        return WindowTables(*(torch.cat([getattr(p, f) for p in parts])
                              for f in ("win_nodes", "lsrc", "ldelay", "xl",
                                        "xh", "yl", "yh")))


def window_sizes(dev: DeviceRRGraph, bbs):
    """Per-net in-box node count [R] int32 (to size Nbox on the host)."""
    return _bb_inside(dev, bbs).sum(dim=1, dtype=_I32)


def build_windows(dev: DeviceRRGraph, bbs, Nbox: int) -> WindowTables:
    """bbs [R, 4] -> localized window tables (JAX search.py:539).

    win_nodes rows are the in-box node ids ascending (jnp.nonzero with
    size=Nbox, fill_value=N), so global->local translation is a per-row
    left searchsorted; an in-edge whose source lies outside the window
    maps to the sentinel Nbox."""
    N = dev.num_nodes
    R = bbs.shape[0]
    inside = _bb_inside(dev, bbs)
    # the k-th in-box node (ascending ids) goes to column k; the nodes
    # past Nbox and the outside ones into a dropped trash column
    pos = inside.cumsum(dim=1, dtype=_I32) - 1
    tgt = torch.where(inside & (pos < Nbox), pos, Nbox).long()
    win = torch.full((R, Nbox + 1), N, dtype=_I32, device=bbs.device)
    win.scatter_(1, tgt, torch.arange(N, dtype=_I32, device=bbs.device
                                      ).expand(R, N))
    win = win[:, :Nbox].contiguous()
    wn_c = win.long().clamp(0, N - 1)
    valid_node = win < N
    D = dev.max_in_degree
    gsrc = dev.ell_src[wn_c]                                 # [R, Nbox, D]
    gvalid = dev.ell_valid[wn_c] & valid_node[:, :, None]
    pos = torch.searchsorted(win, gsrc.reshape(R, -1).contiguous()
                             ).reshape(R, Nbox, D)
    pos = pos.clamp(0, Nbox - 1)
    hit = torch.gather(win, 1, pos.reshape(R, -1)).reshape(pos.shape) == gsrc
    lsrc = torch.where(gvalid & hit, pos, Nbox).to(_I32)
    ldelay = torch.where(lsrc < Nbox, dev.ell_delay[wn_c], 0.0)
    return WindowTables(
        win_nodes=win, lsrc=lsrc, ldelay=ldelay,
        xl=dev.xlow[wn_c].to(torch.int16),
        xh=dev.xhigh[wn_c].to(torch.int16),
        yl=dev.ylow[wn_c].to(torch.int16),
        yh=dev.yhigh[wn_c].to(torch.int16))


def _col(a, fill):
    """Append one trash/pad column along the last axis."""
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=-1)


def _relax_local(lsrc, ldelay, cong_c, crit_c, lb, seed, seed_tdel,
                 sink_loc, remaining, max_steps: int):
    """Seeded Bellman-Ford in window coordinates with the A* gate (JAX
    search.py:585): lsrc [B, Nbox, D] local in-edge table (Nbox = outside
    the window); cong_c [B, Nbox]; crit_c [B, 1]; lb [B, Nbox]
    admissible lower bound to the nearest remaining sink; seed [B, Nbox];
    sink_loc [B, S] local sink indices; remaining [B, S].  A relaxation
    that cannot beat the best remaining sink's distance (cand + lb >=
    bound) is suppressed.  Returns (dist, prev, tdel, steps)."""
    return run1(_relax_local_co(lsrc, ldelay, cong_c, crit_c, lb, seed,
                                seed_tdel, sink_loc, remaining, max_steps))


def _relax_local_co(lsrc, ldelay, cong_c, crit_c, lb, seed, seed_tdel,
                    sink_loc, remaining, max_steps: int):
    """_relax_local as a coroutine (netsplit.py)."""
    B, Nbox, D = lsrc.shape
    device = cong_c.device
    dist0 = torch.where(seed, 0.0, INF)
    tdel0 = torch.where(seed, seed_tdel, 0.0)
    prev0 = torch.full((B, Nbox), -1, dtype=_I32, device=device)
    sink_c = sink_loc.long().clamp(0, Nbox - 1)
    crit3 = crit_c[:, :, None]
    # slot-major blocks [B, DB, Nbox]: the slot min reduces across rows
    blocks = _blocks(D)
    srcs = [lsrc[:, :, d0:d0 + DB].transpose(1, 2).reshape(B, -1).long()
            for d0, DB in blocks]
    # the pad delay is 0: the sentinel source's INF dist makes it INF
    terms = [(d0, crit3 * ldelay[:, :, d0:d0 + DB].transpose(1, 2))
             for d0, DB in blocks]
    cong3 = cong_c[:, None, :]
    src_all = lsrc.long()

    def step(state):
        dist, prev, tdel = state
        dist_p = _col(dist, INF)
        best, gslot = _min_over_blocks(
            lambda b: torch.gather(dist_p, 1, srcs[b]).view(B, -1, Nbox),
            terms, cong3, (B, Nbox), device, dim=1)
        slot = gslot.clamp(min=0)[:, :, None]
        bsrc = torch.gather(src_all, 2, slot)[:, :, 0]
        btdel = torch.gather(_col(tdel, 0.0), 1, bsrc) + torch.gather(
            ldelay, 2, slot)[:, :, 0]
        # A* gate: the best distance any remaining sink has so far
        sd = torch.gather(dist, 1, sink_c)
        bound = torch.where(remaining, sd, INF).amin(dim=1)
        improved = (best < dist) & (best + lb < bound[:, None])
        return ((torch.where(improved, best, dist),
                 torch.where(improved, bsrc.to(_I32), prev),
                 torch.where(improved, btdel, tdel)), improved.any())

    (dist, prev, tdel), steps = yield from _fixpoint(
        step, (dist0, prev0, tdel0), max_steps, device)
    return dist, prev, tdel, steps


def _to_local(wn, gids):
    """Global node ids [B, K] -> (local window indices, Nbox where the
    node is absent; present mask)."""
    Nbox = wn.shape[1]
    p = torch.searchsorted(wn, gids.contiguous()).clamp(0, Nbox - 1)
    ok = torch.gather(wn, 1, p) == gids
    return torch.where(ok, p, Nbox), ok


def _astar_bound(xl, xh, yl, yh, sx, sy, remaining, crit_w, la, lb_scale):
    """The A* lower bound [B, Nbox] (JAX search.py:770-811): min over the
    remaining sinks of a node's expected remaining cost, from the
    interval distance of its span to the sink — a flat per-tile
    congestion floor plus the lookahead's same/ortho segment-count delay
    bound (the flat delay floor for non-wire nodes).  lb_scale [4] =
    (min_cong*af, min_delay*af, af, ipin+sink delay tail).  Sinks in
    chunks of 8, as JAX, so the transient stays [B, Nbox, 8]."""
    la_ax, la_ls, la_lo, la_ts, la_to = (a[:, :, None] for a in la)
    B, Nbox = xl.shape
    S = sx.shape[1]
    CH = min(8, S)
    cwc = crit_w[:, None, None]
    xl3, xh3, yl3, yh3 = (a[:, :, None] for a in (xl, xh, yl, yh))
    lb = torch.full((B, Nbox), INF, dtype=_F32, device=xl.device)
    for s0 in range(0, S, CH):
        sxc = sx[:, None, s0:s0 + CH]
        syc = sy[:, None, s0:s0 + CH]
        remc = remaining[:, None, s0:s0 + CH]
        dx = torch.clamp(torch.maximum(xl3 - sxc, sxc - xh3), min=0)
        dy = torch.clamp(torch.maximum(yl3 - syc, syc - yh3), min=0)
        man = (dx + dy).to(_F32)
        dsame = torch.where(la_ax == 0, dx, dy)
        dortho = torch.where(la_ax == 0, dy, dx)
        nsame = torch.div(dsame + la_ls - 1, la_ls,
                          rounding_mode="floor").to(_F32)
        northo = torch.div(dortho + la_lo - 1, la_lo,
                           rounding_mode="floor").to(_F32)
        lbd = (nsame * la_ts + northo * la_to + lb_scale[3]) * lb_scale[2]
        lbd = torch.where(la_ax == 2, man * lb_scale[1], lbd)
        cost = (1.0 - cwc) * man * lb_scale[0] + cwc * lbd
        lb = torch.minimum(lb, torch.where(remc, cost, INF).amin(dim=2))
    return lb


def route_batch_resident_win(dev: DeviceRRGraph, win: WindowTables, occ,
                             acc, pres_fac, paths, sink_delay, all_reached,
                             source_all, sinks_all, crit_all, sel, sel_win,
                             valid, lb_scale, max_steps: int, max_len: int,
                             num_waves: int, group: int, mesh=None):
    """The windowed batch step (JAX search.py:666): the contract of
    route_batch_resident with the search in [B, Nbox] window
    coordinates.  ``sel`` holds net ids into the whole-circuit arrays,
    ``sel_win`` rows of the compacted window tables; ``lb_scale`` [4]
    f32 the A* gate's scales (Router._lb_scale).  Sinks outside their
    own window stay unreached (the Router widens the net and routes it
    through the global program).  ``mesh`` as for route_batch_resident,
    but each chunk runs whole on its row's first device: JAX constrains
    the windowed step on the net axis only (its search.py:703-716).
    ``paths``, ``sink_delay`` and ``all_reached`` are updated in place.
    Returns (paths, sink_delay, all_reached, occ_new, relax_steps)."""
    home = occ.device
    keep = _distinct_keep(sel, valid, sel_win)
    sl, sw = sel.long(), sel_win.long()
    b_sinks = sinks_all[sl]
    outs = split_run(
        _commit_win_co, mesh, home,
        (paths[sl], source_all[sl], b_sinks, crit_all[sl],
         win.win_nodes[sw], win.lsrc[sw], win.ldelay[sw],
         *(getattr(win, f)[sw].to(_I32) for f in ("xl", "xh", "yl", "yh")),
         sel, valid),
        (occ, acc, pres_fac, lb_scale), (dev,),
        (max_steps, max_len, num_waves, group), keep)
    p, reached_all, delay, delta, relax_steps = gather(outs, home, 3, 4)
    sel, valid, b_sinks = _kept(keep, home, sel, valid, b_sinks)
    ok = (reached_all | (b_sinks < 0)).all(dim=1)
    _put_rows(valid, sel, ((paths, p), (sink_delay, delay),
                           (all_reached, ok)))
    return paths, sink_delay, all_reached, occ + delta, relax_steps


def _commit_win_co(dev: DeviceRRGraph, occ, acc, pres_fac, lb_scale,
                   b_paths, b_src, b_sinks, b_crit, wn, lsrc, ldelay,
                   xl, xh, yl, yh, sel, valid, max_steps: int,
                   max_len: int, num_waves: int, group: int):
    """One member's part of the windowed step (a coroutine, netsplit.py):
    its rows' rip-up, localized search and occupancy delta.  Returns
    (paths, reached, delay, int32 delta [N], per-wave steps)."""
    N = dev.num_nodes
    B = sel.shape[0]
    Nbox = wn.shape[1]
    S = b_sinks.shape[1]
    device = occ.device

    # --- rip up in global space ---
    old_usage = usage_from_paths(b_paths, N) & valid[:, None]
    occ_view = occ[None, :] - old_usage.to(_I32)

    # --- localize: congestion cost + terminals in window coordinates ---
    wn_c = wn.long().clamp(0, N - 1)
    node_ok = wn < N
    occ_l = torch.gather(occ_view, 1, wn_c)
    cong_l = congestion_cost_arrays(dev.cong_base[wn_c],
                                    dev.capacity[wn_c], occ_l, acc[wn_c],
                                    pres_fac)
    # the global program's per-(net, global node) hash
    jitter = congestion_jitter(sel, wn_c)
    cong_l = torch.where(node_ok, cong_l, INF)
    src_loc, _ = _to_local(wn, b_src[:, None])
    sink_loc, sink_in = _to_local(wn, b_sinks.clamp(min=0))
    sink_loc = torch.where(b_sinks >= 0, sink_loc, Nbox)
    la = (dev.la_axis[wn_c], dev.la_len_same[wn_c], dev.la_len_ortho[wn_c],
          dev.la_tlin_same[wn_c], dev.la_tlin_ortho[wn_c])
    sc = sink_loc.clamp(0, Nbox - 1)
    sx = torch.gather(xl, 1, sc)
    sy = torch.gather(yl, 1, sc)

    seed = torch.zeros((B, Nbox + 1), dtype=torch.bool, device=device)
    seed.scatter_(1, src_loc, True)
    seed = seed[:, :Nbox]
    tdel_tree = torch.zeros((B, Nbox), dtype=_F32, device=device)
    # sinks outside their own window can never be reached: not remaining
    remaining = (b_sinks >= 0) & sink_in
    lpaths = torch.full((B, S, max_len), Nbox, dtype=_I32, device=device)
    delay = torch.full((B, S), INF, dtype=_F32, device=device)
    reached_all = torch.zeros((B, S), dtype=torch.bool, device=device)
    waves = []

    for _ in range(num_waves):
        if not (yield "any", remaining.any()):
            break
        crit_w = torch.where(remaining, b_crit, 0.0).amax(dim=1)
        cong_c = (1.0 - crit_w)[:, None] * cong_l * jitter
        lb = _astar_bound(xl, xh, yl, yh, sx, sy, remaining, crit_w, la,
                          lb_scale)
        dist, prev, tdel, steps = yield from _relax_local_co(
            lsrc, ldelay, cong_c, crit_w[:, None], lb, seed, tdel_tree,
            sink_loc, remaining, max_steps)
        waves.append(steps)

        sd = torch.gather(_col(dist, INF), 1, sink_loc.long())
        order, pick_valid = _pick_sinks(sd, remaining, b_crit, group)
        pick_sink = torch.where(pick_valid, torch.gather(sink_loc, 1, order),
                                -1)
        seg, seg_reached = yield from _traceback(prev, seed, pick_sink,
                                                 max_len)
        ok = pick_valid & seg_reached
        d_new = torch.gather(_col(tdel, 0.0), 1,
                             pick_sink.clamp(min=0).long())
        lpaths, delay, reached_all, remaining = _store_wave(
            order, ok, seg, d_new, lpaths, delay, reached_all, remaining)
        tdel_tree, seed = _grow_tree(ok, seg, tdel, tdel_tree, seed, Nbox)

    # --- back to global ids ---
    p = torch.gather(_col(wn, N), 1, lpaths.reshape(B, -1).long()
                     ).reshape(lpaths.shape)
    usage = torch.zeros((B, N + 1), dtype=torch.bool, device=device)
    usage.scatter_(1, torch.where(seed, wn, N).long(), True)
    delta = occupancy_delta(usage[:, :N], valid) - old_usage.sum(
        dim=0, dtype=_I32)
    return p, reached_all, delay, delta, waves
