"""Greedy AAPack-style packer.

TPU-native equivalent of the reference packing layer
(vpr/SRC/pack/pack.c:20 try_pack → cluster.c:232 do_clustering, prepack.c
molecule formation).  The reference runs this serially on the host and so do
we — packing is pointer-chasing over small data and is never the bottleneck
(SURVEY.md §7 step 5 ranks it lowest priority for TPU offload).

Algorithm (same shape as AAPack, independently implemented):
  1. BLE ("molecule") formation: a LUT absorbs the FF it feeds iff that FF is
     the LUT's only fanout (prepack.c pattern-match equivalent); remaining
     FFs become single-FF BLEs.
  2. Seed-grow clustering: repeatedly seed a new cluster with the unclustered
     BLE of highest fanin+fanout degree, then greedily add the BLE with the
     highest attraction (shared-net count) subject to legality: ≤N BLEs,
     ≤I distinct external input nets, single clock per cluster
     (cluster_legality.c equivalent, enforced by construction).
  3. Pin assignment + inter-cluster net extraction; clocks marked global.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..arch.model import Arch
from ..netlist.netlist import (LogicalNetlist, PRIM_HARD, PRIM_INPAD,
                               PRIM_OUTPAD, PRIM_LUT, PRIM_FF)
from ..netlist.packed import Block, PackedNetlist


class _BLE:
    __slots__ = ("lut", "ff", "inputs", "output", "clock")

    def __init__(self, lut: Optional[int], ff: Optional[int],
                 inputs: List[str], output: str, clock: Optional[str]):
        self.lut = lut
        self.ff = ff
        self.inputs = inputs    # external input net names
        self.output = output    # net name this BLE drives
        self.clock = clock


def _form_bles(nl: LogicalNetlist) -> List[_BLE]:
    bles: List[_BLE] = []
    absorbed_ff: Set[int] = set()
    for i, p in enumerate(nl.primitives):
        if p.kind != PRIM_LUT:
            continue
        sinks = nl.net_sinks.get(p.output, [])
        ff = None
        if len(sinks) == 1 and nl.primitives[sinks[0]].kind == PRIM_FF:
            ff = sinks[0]
            absorbed_ff.add(ff)
        out = nl.primitives[ff].output if ff is not None else p.output
        clock = nl.primitives[ff].clock if ff is not None else None
        bles.append(_BLE(i, ff, list(p.inputs), out, clock))
    for i, p in enumerate(nl.primitives):
        if p.kind == PRIM_FF and i not in absorbed_ff:
            bles.append(_BLE(None, i, list(p.inputs), p.output, p.clock))
    return bles


def _ble_criticalities(bles: List[_BLE], producers: Dict[str, int]):
    """Unit-delay slack analysis over the BLE graph (the packer-time
    timing estimate AAPack uses before any placement exists,
    pack/cluster.c timing-driven gain): returns crit [nble] in [0, 1],
    1 = on the longest combinational path.  FF boundaries cut paths (a
    registered BLE output launches a new path)."""
    nble = len(bles)
    # combinational edges u -> v: v consumes u's output and u is NOT
    # registered (a FF output starts a fresh path)
    succ: List[List[int]] = [[] for _ in range(nble)]
    indeg = [0] * nble
    for v, b in enumerate(bles):
        for n in b.inputs:
            u = producers.get(n)
            if u is not None and bles[u].ff is None:
                succ[u].append(v)
                indeg[v] += 1
    # single-pass longest path over a topological order (Kahn), O(V+E) —
    # the fixpoint-relaxation this replaced was O(depth * E), which a
    # 10^4-BLE carry-chain circuit turns into minutes of host time
    from collections import deque
    order: List[int] = []
    q = deque(v for v in range(nble) if indeg[v] == 0)
    work = indeg[:]
    while q:
        u = q.popleft()
        order.append(u)
        for v in succ[u]:
            work[v] -= 1
            if work[v] == 0:
                q.append(v)
    if len(order) != nble:
        # a combinational cycle (LUT loop with no FF) is a malformed
        # netlist; the timing-graph build rejects it the same way
        raise ValueError("combinational loop in BLE graph")
    arr = [0] * nble
    for u in order:
        au1 = arr[u] + 1
        for v in succ[u]:
            if arr[v] < au1:
                arr[v] = au1
    req_from = [0] * nble
    for u in reversed(order):
        best = 0
        for v in succ[u]:
            if req_from[v] >= best:
                best = req_from[v] + 1
        req_from[u] = best
    dmax = max((arr[v] + req_from[v] for v in range(nble)), default=0)
    if dmax == 0:
        return [0.0] * nble
    return [(arr[v] + req_from[v]) / dmax for v in range(nble)]


def _xbar_allowed(p: int, j: int, k: int, density: float,
                  I: int = 0) -> bool:
    """Is crossbar switch point (source pin p -> BLE j input k)
    populated?  Deterministic staggered pattern with the given density
    (the sparse-crossbar model; a real arch would supply the pattern,
    this mirrors the staggered-spread style of rr Fc patterns).  Every
    (j, k) keeps one guaranteed baseline pin — real sparse crossbars
    never strand a BLE input — so a lone BLE is always routable and
    infeasibility is a genuine multi-signal matching conflict."""
    if I > 0 and p == (j * 5 + k) % I:
        return True
    return ((p * 13 + j * 7 + k * 3) % 97) < density * 97


def cluster_routable(bles: List[_BLE], members, clocks, arch: Arch) -> bool:
    """Intra-cluster routability check (pack/cluster_legality.c
    semantics — the reference detail-routes each candidate cluster
    through the pb graph; here the cluster interconnect model is a
    crossbar, so feasibility is a bipartite matching problem).

    Under a sparse crossbar (arch.xbar_density < 1), a signal entering
    on cluster input pin p reaches BLE input (j, k) only where the
    switch point exists.  Internal feedbacks are pinned to dedicated
    sources (pin I+j for BLE slot j).  Feasible iff every internal
    signal's fixed source covers all its consumers AND the external
    signals admit a matching onto distinct input pins that each cover
    all of that signal's consumers.  Full crossbar returns True without
    work (the fast path)."""
    d = getattr(arch, "xbar_density", 1.0)
    if d >= 1.0:
        return True
    I = arch.I
    ordered = sorted(members)
    outs = {bles[m].output: j for j, m in enumerate(ordered)}
    sig_cons: Dict[str, List[tuple]] = {}
    for j, m in enumerate(ordered):
        for k, n in enumerate(bles[m].inputs):
            if n in clocks:
                continue
            sig_cons.setdefault(n, []).append((j, k))

    ext_pin_options: List[List[int]] = []
    for s, cons in sig_cons.items():
        if s in outs:
            p = I + outs[s]
            if not all(_xbar_allowed(p, j, k, d) for (j, k) in cons):
                return False
        else:
            opts = [p for p in range(I)
                    if all(_xbar_allowed(p, j, k, d, I)
                           for (j, k) in cons)]
            if not opts:
                return False
            ext_pin_options.append(opts)

    # Kuhn's augmenting-path matching: external signals -> distinct pins
    pin_of: Dict[int, int] = {}

    def try_assign(si: int, seen) -> bool:
        for p in ext_pin_options[si]:
            if p in seen:
                continue
            seen.add(p)
            if p not in pin_of or try_assign(pin_of[p], seen):
                pin_of[p] = si
                return True
        return False

    for si in range(len(ext_pin_options)):
        if not try_assign(si, set()):
            return False
    return True


def pack_netlist(nl: LogicalNetlist, arch: Arch,
                 timing_driven: bool = True,
                 alpha: float = 0.75) -> PackedNetlist:
    """AAPack-style seed-grow clustering (pack/cluster.c:232
    do_clustering).  timing_driven weighs the attraction toward
    critical-path neighbours (VPR's  gain = alpha * timing_gain +
    (1 - alpha) * connection_gain) and seeds clusters with the most
    critical unclustered BLE, so long combinational chains pack into the
    same CLB and ride the fast intra-cluster interconnect."""
    N, I = arch.N, arch.I
    clocks = set(nl.clocks)
    bles = _form_bles(nl)
    nble = len(bles)

    # legality backend: multi-mode pb tree (assignment + detail route,
    # cluster_legality.c semantics) when the arch carries one, else the
    # flat crossbar model
    pb_tree = getattr(arch, "pb_tree", None)
    if pb_tree is not None:
        from .pb_pack import pb_capacity, pb_cluster_feasible

        # nets consumed by pads / hard blocks must surface on cluster
        # output pins (the want_out leg of the legality route)
        ext_nets = {p.inputs[0] for p in nl.primitives
                    if p.kind == PRIM_OUTPAD and p.inputs}
        for p in nl.primitives:
            if p.kind == PRIM_HARD:
                ext_nets.update(n for n in p.inputs if n is not None)

        def feasible(mem):
            # ``consumers`` binds late: the map is filled just below
            return pb_cluster_feasible(bles, mem, clocks, arch,
                                       consumers=consumers,
                                       ext_nets=ext_nets)
        cap = pb_capacity(pb_tree)
        I_eff = sum(p.width for p in pb_tree.ports if p.dir == "input")
    else:
        def feasible(mem):
            return cluster_routable(bles, mem, clocks, arch)
        cap = N
        I_eff = I

    # net -> producing/consuming BLE indices (over non-clock nets)
    producers: Dict[str, int] = {}
    consumers: Dict[str, List[int]] = {}
    for bi, b in enumerate(bles):
        producers[b.output] = bi
        for n in b.inputs:
            if n not in clocks:
                consumers.setdefault(n, []).append(bi)

    crit = (_ble_criticalities(bles, producers)
            if timing_driven else [0.0] * nble)

    # adjacency weight = number of shared nets between BLE pairs
    degree = [len(b.inputs) + len(consumers.get(b.output, [])) for b in bles]
    unclustered = set(range(nble))
    clusters: List[List[int]] = []

    def attraction(cluster_bles: Set[int], cand: int) -> float:
        conn = 0
        tgain = 0.0
        b = bles[cand]
        for n in b.inputs:
            p = producers.get(n)
            if p is not None and p in cluster_bles:
                conn += 1
                tgain = max(tgain, min(crit[p], crit[cand]))
        for c in consumers.get(b.output, []):
            if c in cluster_bles:
                conn += 1
                tgain = max(tgain, min(crit[cand], crit[c]))
        if not timing_driven:
            return float(conn)
        return alpha * tgain * 10.0 + (1.0 - alpha) * conn

    # static seed order: crit desc, degree desc, index asc (cluster.c
    # get_seed_logical_molecule_with_most_critical_inputs semantics; crit
    # and degree never change, so one sort replaces the per-cluster
    # O(nble) max scan)
    seed_order = sorted(range(nble),
                        key=lambda b: (-crit[b], -degree[b], b))
    seed_ptr = 0

    while unclustered:
        while seed_order[seed_ptr] not in unclustered:
            seed_ptr += 1
        seed = seed_order[seed_ptr]
        if not feasible({seed}):
            # a lone BLE that cannot route through the cluster crossbar
            # means the netlist does not fit this arch at all — error
            # out like the reference's cluster_legality failure path
            raise ValueError(
                f"BLE {seed} is not routable through the sparse "
                f"crossbar (xbar_density="
                f"{getattr(arch, 'xbar_density', 1.0)}) even alone")
        members: Set[int] = {seed}
        unclustered.remove(seed)
        clk = bles[seed].clock
        # incrementally-maintained cluster state (identical to the
        # from-scratch recomputation it replaced, O(deg) per step):
        # outs = member outputs, ext = external input nets,
        # cands = unclustered BLEs adjacent to any member
        outs: Set[str] = set()
        ext: Set[str] = set()
        cands: Set[int] = set()

        def absorb(m: int):
            b = bles[m]
            outs.add(b.output)
            ext.discard(b.output)
            for n in b.inputs:
                if n not in clocks and n not in outs:
                    ext.add(n)
            for n in b.inputs:
                p = producers.get(n)
                if p is not None and p in unclustered:
                    cands.add(p)
            for c in consumers.get(b.output, []):
                if c in unclustered:
                    cands.add(c)
            cands.discard(m)

        def inputs_with(cand: int) -> int:
            """|external inputs| if cand joined (exact recomputation
            semantics: cand's output leaves ext, its non-clock inputs
            join unless already internal)."""
            b = bles[cand]
            n = len(ext) - (1 if b.output in ext else 0)
            seen: Set[str] = set()
            for s in b.inputs:
                if (s not in clocks and s not in outs and s != b.output
                        and s not in ext and s not in seen):
                    seen.add(s)
                    n += 1
            return n

        absorb(seed)
        while len(members) < cap:
            best, best_score = None, -1.0
            for c in sorted(cands):
                bc = bles[c]
                if bc.clock is not None and clk is not None and bc.clock != clk:
                    continue
                if inputs_with(c) > I_eff:
                    continue
                if not feasible(members | {c}):
                    continue
                s = attraction(members, c)
                if s > best_score:
                    best, best_score = c, s
            if best is None:
                # fall back: any legal unclustered BLE (keeps clusters full,
                # like AAPack's unrelated-clustering phase)
                for c in sorted(unclustered):
                    bc = bles[c]
                    if bc.clock is not None and clk is not None and bc.clock != clk:
                        continue
                    if (inputs_with(c) <= I_eff
                            and feasible(members | {c})):
                        best = c
                        break
            if best is None:
                break
            members.add(best)
            unclustered.remove(best)
            absorb(best)
            if clk is None:
                clk = bles[best].clock
        clusters.append(sorted(members))

    # ---- build the packed netlist ----
    pnl = PackedNetlist(name=nl.name)
    clb_t = arch.clb_type
    io_t = arch.io_type

    # which BLE outputs are needed outside their cluster
    cluster_of_ble = {}
    for ci, mem in enumerate(clusters):
        for m in mem:
            cluster_of_ble[m] = ci

    pad_consumers: Dict[str, bool] = {}
    for p in nl.primitives:
        if p.kind == PRIM_OUTPAD:
            pad_consumers[p.inputs[0]] = True
        elif p.kind == PRIM_HARD:
            # hard blocks live outside every cluster: their input nets
            # must surface on cluster output pins
            for n in p.inputs:
                if n is not None:
                    pad_consumers[n] = True

    def net_needed_outside(ci: int, net: str) -> bool:
        if net in pad_consumers:
            return True
        for c in consumers.get(net, []):
            if cluster_of_ble[c] != ci:
                return True
        return False

    # IO blocks first (inpads drive nets, outpads consume), then hard
    # macros 1:1 onto their matching heterogeneous block type
    # (arch.hard_models .subckt-model lookup, read_blif.c semantics)
    for i, p in enumerate(nl.primitives):
        if p.kind == PRIM_INPAD:
            ni = pnl.add_net(p.output, is_global=(p.output in clocks))
            blk = Block(name=p.name, type_name=io_t.name,
                        pin_nets=[-1, ni], prims=[i])
            pnl.blocks.append(blk)
        elif p.kind == PRIM_OUTPAD:
            ni = pnl.add_net(p.inputs[0])
            blk = Block(name=p.name, type_name=io_t.name,
                        pin_nets=[ni, -1], prims=[i])
            pnl.blocks.append(blk)
        elif p.kind == PRIM_HARD:
            tname = arch.hard_models.get(p.model, p.model)
            ht = arch.block_type(tname)
            n_in = ht.num_input_pins
            if len(p.inputs) > n_in or len(p.outputs) > ht.num_output_pins:
                raise ValueError(
                    f"hard macro {p.name} ({p.model}) exceeds block type "
                    f"{tname} pins")
            pin_nets = [-1] * ht.num_pins
            for k, n in enumerate(p.inputs):
                if n is not None:       # None = unconnected port
                    pin_nets[k] = pnl.add_net(n)
            for k, n in enumerate(p.outputs):
                if n is not None:
                    pin_nets[n_in + k] = pnl.add_net(n)
            if p.clock is not None:
                pin_nets[ht.num_pins - 1] = pnl.add_net(p.clock,
                                                        is_global=True)
            pnl.blocks.append(Block(name=p.name, type_name=tname,
                                    pin_nets=pin_nets, prims=[i]))

    in_base = 0
    out_base = arch.I
    clk_pin = arch.I + arch.N
    for ci, mem in enumerate(clusters):
        pin_nets = [-1] * clb_t.num_pins
        outs = {bles[m].output for m in mem}
        ext_in: List[str] = []
        clk = None
        prims: List[int] = []
        for m in mem:
            b = bles[m]
            if b.lut is not None:
                prims.append(b.lut)
            if b.ff is not None:
                prims.append(b.ff)
            if b.clock is not None:
                clk = b.clock
            for n in b.inputs:
                if n not in clocks and n not in outs and n not in ext_in:
                    ext_in.append(n)
        assert len(ext_in) <= arch.I, "packer produced illegal cluster"
        for k, n in enumerate(ext_in):
            pin_nets[in_base + k] = pnl.add_net(n)
        oidx = 0
        for m in mem:
            b = bles[m]
            if net_needed_outside(ci, b.output):
                pin_nets[out_base + oidx] = pnl.add_net(b.output)
                oidx += 1
        if clk is not None:
            pin_nets[clk_pin] = pnl.add_net(clk, is_global=True)
        pnl.blocks.append(Block(name=f"clb{ci}", type_name=clb_t.name,
                                pin_nets=pin_nets, prims=sorted(prims)))

    pnl.bind_types(arch)
    pnl.connect()
    return pnl
