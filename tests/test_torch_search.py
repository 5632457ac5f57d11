"""The port's ELL search (parallel_eda_tpu_torch/route/search.py)
against the JAX package's route/search.py, function by function, on the
CPU.

Each case builds its inputs with numpy from a seed on the JAX package's
graph of one fixture — the 15-LUT parity fixture (N = 444, in-degree D =
20: not a multiple of the 8-slot relaxation block, so the last block is
shifted and overlaps) or the 16x16 big-grid fixture of
tests/test_router.py (small boxes on a large grid, where the windows
engage) — and carries the graph to the port through
``device_graph_from_numpy``.  Every output is compared bit for bit:
dist, prev, tdel, step counts, paths, occupancy, sink delays, flags,
window tables and conflict matrices.

Cases at crit 0 run the JAX reference in this process.  Cases at
crit > 0 multiply and add (``ds + crit*w + cong``, the A* bound), which
XLA:CPU contracts into fused multiply-adds under its default flags
(ROADMAP.md C2), so their reference runs in a subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX``: this file run as a script writes
the references of the cases it is given to an .npz."""

import functools
import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)

# name -> (function, fixture, parameters).  "crit": criticalities > 0
# (reference under the AVX flag); "pow2": power-of-two costs and delays,
# so equal candidates tie exactly; "cap": a max_steps / num_waves that
# binds; "pad": in-degree padded with invalid slots to D + 5
CASES = {
    "relax_c0": ("relax", "fixture", dict(seed=1)),
    "relax_pow2": ("relax", "fixture", dict(seed=2, pow2=True)),
    "relax_pow2_crit": ("relax", "fixture", dict(seed=3, pow2=True,
                                                 crit=0.5)),
    "relax_crit": ("relax", "fixture", dict(seed=4, crit=0.7)),
    "relax_cap": ("relax", "fixture", dict(seed=5, max_steps=3)),
    "relax_pad": ("relax", "fixture", dict(seed=6, pad=5)),
    "relax_big": ("relax", "big", dict(seed=7)),
    "relax_local_c0": ("relax_local", "big", dict(seed=11)),
    "relax_local_pow2": ("relax_local", "big", dict(seed=12, pow2=True)),
    "relax_local_crit": ("relax_local", "big", dict(seed=13, crit=0.6)),
    "relax_local_cap": ("relax_local", "big", dict(seed=14, max_steps=4)),
    "relax_local_af": ("relax_local", "big", dict(seed=15, crit=0.3,
                                                  astar_fac=1.2)),
    "net_batch_c0": ("net_batch", "fixture", dict(seed=21, group=0)),
    "net_batch_g1": ("net_batch", "fixture", dict(seed=22, group=1)),
    "net_batch_pow2": ("net_batch", "fixture", dict(seed=23, group=2,
                                                    pow2=True)),
    "net_batch_crit": ("net_batch", "fixture", dict(seed=24, group=1,
                                                    crit=0.8)),
    "net_batch_cap": ("net_batch", "fixture", dict(seed=25, group=1,
                                                   waves=2, max_steps=5)),
    "resident_c0": ("resident", "fixture", dict(seed=31)),
    "resident_crit": ("resident", "fixture", dict(seed=32, crit=0.5,
                                                  group=1)),
    "resident_big": ("resident", "big", dict(seed=33, group=1)),
    "resident_win_c0": ("resident_win", "big", dict(seed=41)),
    "resident_win_g1": ("resident_win", "big", dict(seed=42, group=1)),
    "resident_win_crit": ("resident_win", "big", dict(seed=43, crit=0.9,
                                                      group=1)),
    "resident_win_af": ("resident_win", "big", dict(seed=44, crit=0.4,
                                                    astar_fac=1.2)),
    "resident_win_small": ("resident_win", "fixture", dict(seed=45)),
    "windows_big": ("windows", "big", dict(seed=51)),
    "windows_fixture": ("windows", "fixture", dict(seed=52)),
    "conflict_k4": ("conflict", "fixture", dict(seed=61, K=4)),
    "conflict_k64": ("conflict", "big", dict(seed=62, K=64)),
    "conflict_k16": ("conflict", "big", dict(seed=63, K=16)),
    "helpers_fixture": ("helpers", "fixture", dict(seed=71)),
    "helpers_big": ("helpers", "big", dict(seed=72)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU runs: the ELL search issues
    many small ops, each a parallel region that waits for every thread
    of its pool, and the tier-1 run's workers share the cores (its
    results do not depend on the thread count: no float reduction)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crit_case(name) -> bool:
    return CASES[name][2].get("crit", 0.0) > 0


@functools.lru_cache(maxsize=None)
def _flow(fixture):
    """(rr, term) of the JAX package's fixture."""
    from parallel_eda_tpu.flow import prepare, synth_flow

    if fixture == "fixture":
        f = synth_flow(**FIXTURE)
    else:
        from parallel_eda_tpu.arch.builtin import minimal_arch
        from parallel_eda_tpu.netlist.generate import generate_circuit

        nl = generate_circuit(num_luts=20, num_inputs=4, num_outputs=4,
                              K=4, seed=9)
        f = prepare(nl, minimal_arch(chan_width=10), chan_width=10, nx=16,
                    ny=16, seed=9)
    return f.rr, f.term


def _graph_np(fixture, pad=0, pow2_rng=None) -> dict:
    """The JAX DeviceRRGraph of ``fixture`` as numpy arrays; ``pad``
    invalid ELL slots appended; with ``pow2_rng`` power-of-two delays."""
    from parallel_eda_tpu.route.device_graph import to_device

    rr, _ = _flow(fixture)
    d = to_device(rr)
    g = {k: np.asarray(getattr(d, k)) for k in (
        "ell_src", "ell_delay", "ell_valid", "cong_base", "capacity",
        "xlow", "xhigh", "ylow", "yhigh", "is_wire", "la_axis",
        "la_len_same", "la_len_ortho", "la_tlin_same", "la_tlin_ortho")}
    if pow2_rng is not None:
        e = pow2_rng.integers(-34, -31, g["ell_delay"].shape)
        g["ell_delay"] = np.where(g["ell_valid"], np.ldexp(1.0, e),
                                  np.inf).astype(np.float32)
    if pad:
        N = g["ell_src"].shape[0]
        g["ell_src"] = np.concatenate(
            [g["ell_src"], np.zeros((N, pad), np.int32)], axis=1)
        g["ell_delay"] = np.concatenate(
            [g["ell_delay"], np.full((N, pad), np.inf, np.float32)], axis=1)
        g["ell_valid"] = np.concatenate(
            [g["ell_valid"], np.zeros((N, pad), bool)], axis=1)
    return g


def _costs(rng, shape, pow2):
    if pow2:
        return np.ldexp(1.0, rng.integers(-33, -30, shape)).astype(
            np.float32)
    return rng.uniform(1e-11, 4e-10, shape).astype(np.float32)


def _bbs(rng, term, R, nx, ny, grow=1):
    """Net bounding boxes [R, 4] from the terminals' boxes, grown by a
    random margin and clipped to the grid."""
    bb = np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                   term.bb_ymax], axis=1).astype(np.int32)[:R]
    m = rng.integers(0, grow + 1, bb.shape)
    bb = bb + m * np.array([-1, 1, -1, 1])
    return np.clip(bb, 0, [[nx + 1, nx + 1, ny + 1, ny + 1]]).astype(
        np.int32)


def _inputs(name) -> dict:
    """Case ``name``'s graph, arrays and static arguments, from its
    seed."""
    fn, fixture, p = CASES[name]
    rng = np.random.default_rng(p["seed"])
    rr, term = _flow(fixture)
    g = _graph_np(fixture, p.get("pad", 0),
                  rng if p.get("pow2") else None)
    N = g["ell_src"].shape[0]
    nx, ny = rr.grid.nx, rr.grid.ny
    R, S = term.sinks.shape
    max_len = 4 * (nx + ny) + 64
    crit = np.float32(p.get("crit", 0.0))
    x = dict(graph=g, static=dict(max_steps=p.get("max_steps", max_len),
                                  max_len=max_len))
    if fn in ("relax", "relax_local"):
        B = 8
        x["crit_c"] = np.full((B, 1), crit, np.float32)
        if fn == "relax":
            bb = _bbs(rng, term, B, nx, ny, grow=2)
            x["bb"] = bb
            x["cong_c"] = _costs(rng, (B, N), p.get("pow2"))
            x["seed"] = np.zeros((B, N), bool)
            x["seed"][np.arange(B), term.source[:B]] = True
            extra = rng.integers(0, N, (B, 3))
            x["seed"][np.arange(B)[:, None], extra] = True
            x["seed_tdel"] = np.where(
                x["seed"], rng.uniform(0, 1e-9, (B, N)), 0).astype(
                    np.float32)
        else:
            x["bbs"] = _bbs(rng, term, B, nx, ny, grow=1)
            x["astar_fac"] = p.get("astar_fac", 1.0)
            x["pow2"] = bool(p.get("pow2"))
            x["sink_rng_seed"] = p["seed"]
        return x
    if fn == "net_batch":
        B = min(8, R)
        sel = rng.permutation(R)[:B].astype(np.int32)
        x["sel"] = sel
        x["cong"] = _costs(rng, (B, N), p.get("pow2"))
        x["bb"] = _bbs(rng, term, R, nx, ny)[sel]
        x["crit"] = np.where(term.sinks[sel] >= 0, crit * rng.uniform(
            0.5, 1.0, term.sinks[sel].shape), 0).astype(np.float32)
        grp = p["group"] or S
        x["static"].update(num_waves=p.get("waves", S), group=grp)
        return x
    if fn in ("resident", "resident_win"):
        B = 8
        x["static"].update(num_waves=S, group=p.get("group", 0) or S)
        x["occ"] = rng.integers(0, 2, N).astype(np.int32)
        x["acc"] = rng.uniform(1, 3, N).astype(np.float32)
        x["pres_fac"] = np.float32(0.845)
        x["crit"] = np.where(term.sinks >= 0, crit * rng.uniform(
            0.5, 1.0, term.sinks.shape), 0).astype(np.float32)
        x["bb"] = _bbs(rng, term, R, nx, ny, grow=0)
        if fn == "resident_win":
            # one net's box shrunk so a sink falls outside its window
            r0 = int(np.argmax(term.num_sinks))
            x["bb"][r0, 1] = x["bb"][r0, 0]
            x["astar_fac"] = p.get("astar_fac", 1.0)
        # two batches, the second padded and overlapping the first
        perm = rng.permutation(R)
        x["sels"] = [perm[:B].astype(np.int32),
                     np.concatenate([perm[B - 2:B + 3],
                                     np.zeros(3, int)]).astype(np.int32)]
        x["valids"] = [np.ones(B, bool), np.arange(B) < 5]
        return x
    if fn == "windows":
        x["bbs"] = _bbs(rng, term, R, nx, ny, grow=1)
        return x
    # conflict / helpers: random trees, overused nodes with tied amounts
    # (from the low node ids, where the top-k's index-ascending tie
    # rule picks among the most overused)
    L = 12
    paths = rng.integers(0, min(N, 400), (R, S, L)).astype(np.int32)
    paths[rng.random((R, S, L)) < 0.4] = N
    x["paths"] = paths
    x["occ"] = rng.integers(0, 4, N).astype(np.int32)
    x["all_reached"] = rng.random(R) < 0.8
    if fn == "conflict":
        idx = rng.permutation(R)[:R - 3].astype(np.int32)
        I = 1 << (len(idx) - 1).bit_length()
        x["idx_pad"] = np.concatenate([idx, np.full(I - len(idx), -1,
                                                    np.int32)])
        x["static"] = dict(K=p["K"])
    else:
        x["usage"] = rng.random((R, N)) < 0.1
        x["valid"] = rng.random(R) < 0.7
    return x


def _lb_scale(fixture, astar_fac):
    """Router._lb_scale of the JAX package, as f32 [4]."""
    from parallel_eda_tpu.route.router import Router, RouterOpts

    rr, _ = _flow(fixture)
    r = Router(rr, RouterOpts(program="ell", astar_fac=astar_fac))
    return np.asarray(r._lb_scale(), np.float32)


def _window_inputs(x, fixture, win_np):
    """_relax_local's arguments for the windows ``win_np``: a local cost,
    seeds at the net sources, sinks and remaining flags."""
    rng = np.random.default_rng(x["sink_rng_seed"] + 1000)
    rr, term = _flow(fixture)
    B, Nbox = win_np["win_nodes"].shape
    S = term.sinks.shape[1]
    wn = win_np["win_nodes"]
    N = x["graph"]["ell_src"].shape[0]
    cong = _costs(rng, (B, Nbox), x["pow2"])
    cong = np.where(wn < N, cong, np.inf).astype(np.float32)

    def loc(gids):
        p = np.array([np.searchsorted(wn[b], gids[b]) for b in range(B)])
        p = np.clip(p, 0, Nbox - 1)
        ok = np.take_along_axis(wn, p, 1) == gids
        return np.where(ok, p, Nbox).astype(np.int32), ok

    src, _ = loc(term.source[:B, None])
    sinks = term.sinks[:B]
    sink_loc, sink_in = loc(np.clip(sinks, 0, None))
    sink_loc = np.where(sinks >= 0, sink_loc, Nbox).astype(np.int32)
    seed = np.zeros((B, Nbox + 1), bool)
    seed[np.arange(B)[:, None], src] = True
    seed = seed[:, :Nbox]
    lb = rng.uniform(0, 2e-10, (B, Nbox)).astype(np.float32)
    lb[rng.random((B, Nbox)) < 0.5] = 0
    return dict(cong_c=cong, lb=lb, seed=seed,
                seed_tdel=np.zeros((B, Nbox), np.float32),
                sink_loc=sink_loc, remaining=(sinks >= 0) & sink_in)


def _np(v):
    return {k: np.asarray(a) for k, a in v.items()}


def jax_run(name) -> dict:
    """Case ``name`` through the JAX package; outputs as numpy."""
    from parallel_eda_tpu.route import search as js
    from parallel_eda_tpu.route.device_graph import DeviceRRGraph

    fn, fixture, p = CASES[name]
    x = _inputs(name)
    dev = DeviceRRGraph(**{k: jnp.asarray(v) for k, v in x["graph"].items()})
    st = x["static"]
    a = jnp.asarray
    if fn == "relax":
        bb = a(x["bb"])
        ins = ((dev.xhigh[None, :] >= bb[:, 0, None])
               & (dev.xlow[None, :] <= bb[:, 1, None])
               & (dev.yhigh[None, :] >= bb[:, 2, None])
               & (dev.ylow[None, :] <= bb[:, 3, None]))
        out = jax.jit(js._relax, static_argnums=6)(
            dev, a(x["cong_c"]), a(x["crit_c"]), ins, a(x["seed"]),
            a(x["seed_tdel"]), st["max_steps"])
        return _np(dict(zip(("dist", "prev", "tdel", "steps"), out)))
    if fn == "relax_local":
        B = x["bbs"].shape[0]
        win = js.build_windows(dev, a(x["bbs"]), _nbox(dev, x["bbs"]))
        win_np = {"win_nodes": np.asarray(win.win_nodes)}
        w = _window_inputs(x, fixture, win_np)
        out = jax.jit(js._relax_local, static_argnums=9)(
            win.lsrc, win.ldelay, a(w["cong_c"]), a(x["crit_c"]),
            a(w["lb"]), a(w["seed"]), a(w["seed_tdel"]), a(w["sink_loc"]),
            a(w["remaining"]), st["max_steps"])
        assert out[0].shape[0] == B
        return _np(dict(zip(("dist", "prev", "tdel", "steps"), out)))
    rr, term = _flow(fixture)
    if fn == "net_batch":
        out = js.route_net_batch(
            dev, a(x["cong"]), a(term.source[x["sel"]].astype(np.int32)),
            a(term.sinks[x["sel"]].astype(np.int32)), a(x["bb"]),
            a(x["crit"]), a(x["sel"]), **st)
        return _np(dict(zip(("paths", "reached", "delay", "usage",
                             "steps"), out)))
    if fn in ("resident", "resident_win"):
        R, S = term.sinks.shape
        N = dev.num_nodes
        occ, acc = a(x["occ"]), a(x["acc"])
        paths = jnp.full((R, S, st["max_len"]), N, jnp.int32)
        sd = jnp.full((R, S), jnp.inf, jnp.float32)
        ar = jnp.zeros(R, bool)
        bb = a(x["bb"])
        full_bb = a(np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1],
                             np.int32))
        src = a(term.source.astype(np.int32))
        sinks = a(term.sinks.astype(np.int32))
        crit = a(x["crit"])
        out = {}
        if fn == "resident_win":
            win = js.build_windows(dev, bb, _nbox(dev, x["bb"]))
            lb = a(_lb_scale(fixture, x["astar_fac"]))
        for k, (sel, valid) in enumerate(zip(x["sels"], x["valids"])):
            if fn == "resident":
                paths, sd, ar, bb, occ, steps = js.route_batch_resident(
                    dev, occ, acc, jnp.float32(x["pres_fac"]), paths, sd,
                    ar, bb, src, sinks, crit, a(sel), a(valid), full_bb,
                    **st)
            else:
                paths, sd, ar, occ, steps = js.route_batch_resident_win(
                    dev, win, occ, acc, jnp.float32(x["pres_fac"]), paths,
                    sd, ar, src, sinks, crit, a(sel), a(sel), a(valid), lb,
                    **st)
            # copies now: the next call donates these buffers
            out[f"steps{k}"] = np.asarray(steps)
            out[f"occ{k}"] = np.asarray(occ)
            out[f"paths{k}"] = np.asarray(paths)
        out.update(sink_delay=sd, all_reached=ar, bb=bb)
        return _np(out)
    if fn == "windows":
        win = js.build_windows(dev, a(x["bbs"]), _nbox(dev, x["bbs"]))
        out = {f: getattr(win, f) for f in ("win_nodes", "lsrc", "ldelay",
                                            "xl", "xh", "yl", "yh")}
        out["sizes"] = js.window_sizes(dev, a(x["bbs"]))
        return _np(out)
    if fn == "conflict":
        out = js.conflict_subset(dev, a(x["occ"]), a(x["paths"]),
                                 a(x["idx_pad"]), st["K"])
        return {"conflict": np.asarray(out)}
    occ, paths = a(x["occ"]), a(x["paths"])
    n_over, over_total = js.overuse_summary(dev, occ)
    return _np(dict(
        rrm=js.reroute_mask(dev, occ, paths, a(x["all_reached"])),
        n_over=n_over, over_total=over_total,
        delta=js.occupancy_delta(a(x["usage"]), a(x["valid"]))))


def _nbox(dev, bbs):
    """Nbox of the router's window setup: the largest box, pow-2."""
    from parallel_eda_tpu.route import search as js

    n = int(np.asarray(js.window_sizes(dev, jnp.asarray(bbs))).max())
    return 1 << max(0, (n - 1).bit_length())


def port_run(name) -> dict:
    """Case ``name`` through the port on the CPU; outputs as numpy."""
    from parallel_eda_tpu_torch.route import search as ts
    from parallel_eda_tpu_torch.route.device_graph import \
        device_graph_from_numpy

    fn, fixture, p = CASES[name]
    x = _inputs(name)
    dev = device_graph_from_numpy(x["graph"], "cpu")
    st = x["static"]

    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v))

    def out_np(d):
        return {k: v.numpy() for k, v in d.items()}

    if fn == "relax":
        ins = ts._bb_inside(dev, t(x["bb"]))
        out = ts._relax(dev, t(x["cong_c"]), t(x["crit_c"]), ins,
                        t(x["seed"]), t(x["seed_tdel"]), st["max_steps"])
        return out_np(dict(zip(("dist", "prev", "tdel", "steps"), out)))
    if fn == "relax_local":
        win = ts.build_windows(dev, t(x["bbs"]), _port_nbox(dev, x["bbs"]))
        w = _window_inputs(x, fixture, {"win_nodes": win.win_nodes.numpy()})
        out = ts._relax_local(
            win.lsrc, win.ldelay, t(w["cong_c"]), t(x["crit_c"]),
            t(w["lb"]), t(w["seed"]), t(w["seed_tdel"]), t(w["sink_loc"]),
            t(w["remaining"]), st["max_steps"])
        return out_np(dict(zip(("dist", "prev", "tdel", "steps"), out)))
    rr, term = _flow(fixture)
    if fn == "net_batch":
        out = ts.route_net_batch(
            dev, t(x["cong"]), t(term.source[x["sel"]].astype(np.int32)),
            t(term.sinks[x["sel"]].astype(np.int32)), t(x["bb"]),
            t(x["crit"]), t(x["sel"]), **st)
        return out_np(dict(zip(("paths", "reached", "delay", "usage",
                                "steps"), out)))
    if fn in ("resident", "resident_win"):
        R, S = term.sinks.shape
        N = dev.num_nodes
        occ, acc = t(x["occ"]), t(x["acc"])
        paths = torch.full((R, S, st["max_len"]), N, dtype=torch.int32)
        sd = torch.full((R, S), float("inf"))
        ar = torch.zeros(R, dtype=torch.bool)
        bb = t(x["bb"].copy())
        full_bb = t(np.array([0, rr.grid.nx + 1, 0, rr.grid.ny + 1],
                             np.int32))
        src = t(term.source.astype(np.int32))
        sinks = t(term.sinks.astype(np.int32))
        crit = t(x["crit"])
        pres = float(x["pres_fac"])
        out = {}
        if fn == "resident_win":
            win = ts.build_windows(dev, bb, _port_nbox(dev, x["bb"]))
            lb = t(_lb_scale(fixture, x["astar_fac"]))
        for k, (sel, valid) in enumerate(zip(x["sels"], x["valids"])):
            if fn == "resident":
                paths, sd, ar, bb, occ, steps = ts.route_batch_resident(
                    dev, occ, acc, pres, paths, sd, ar, bb, src, sinks,
                    crit, t(sel), t(valid), full_bb, **st)
            else:
                paths, sd, ar, occ, steps = ts.route_batch_resident_win(
                    dev, win, occ, acc, pres, paths, sd, ar, src, sinks,
                    crit, t(sel), t(sel), t(valid), lb, **st)
            out[f"steps{k}"] = steps
            out[f"occ{k}"] = occ
            out[f"paths{k}"] = paths.clone()
        out.update(sink_delay=sd, all_reached=ar, bb=bb)
        return out_np(out)
    if fn == "windows":
        win = ts.build_windows(dev, t(x["bbs"]), _port_nbox(dev, x["bbs"]))
        out = {f: getattr(win, f) for f in ("win_nodes", "lsrc", "ldelay",
                                            "xl", "xh", "yl", "yh")}
        out["sizes"] = ts.window_sizes(dev, t(x["bbs"]))
        return out_np(out)
    if fn == "conflict":
        out = ts.conflict_subset(dev, t(x["occ"]), t(x["paths"]),
                                 t(x["idx_pad"]), st["K"])
        return {"conflict": out.numpy()}
    occ, paths = t(x["occ"]), t(x["paths"])
    n_over, over_total = ts.overuse_summary(dev, occ)
    return out_np(dict(
        rrm=ts.reroute_mask(dev, occ, paths, t(x["all_reached"])),
        n_over=n_over, over_total=over_total,
        delta=ts.occupancy_delta(t(x["usage"]), t(x["valid"]))))


def _port_nbox(dev, bbs):
    from parallel_eda_tpu_torch.route import search as ts

    n = int(ts.window_sizes(dev, torch.from_numpy(bbs)).max())
    return 1 << max(0, (n - 1).bit_length())


def write_reference(path, names):
    """The JAX outputs of cases ``names`` into the .npz ``path``; run
    under the reference flags."""
    out = {}
    for name in names:
        for k, v in jax_run(name).items():
            out[f"{name}/{k}"] = v
    np.savez(path, **out)


@pytest.fixture(scope="module")
def avx_ref(tmp_path_factory):
    """The crit > 0 cases' JAX references, computed in a subprocess
    under XLA_FLAGS=--xla_cpu_max_isa=AVX (no FMA contraction)."""
    path = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    names = [n for n in CASES if _crit_case(n)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path), *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _reference(name, request):
    if not _crit_case(name):
        return jax_run(name)
    ref = request.getfixturevalue("avx_ref")
    return {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(CASES))
def test_search_matches_jax(name, request):
    want = _reference(name, request)
    got = port_run(name)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), (name, k)
    fn, _, p = CASES[name]
    # the cases reach what they are named for
    if fn in ("relax", "relax_local"):
        if "max_steps" in p:
            assert int(got["steps"]) == p["max_steps"]
        else:
            assert 2 < int(got["steps"]) < _inputs(name)["static"][
                "max_steps"]
        assert np.isfinite(got["dist"]).sum() > got["dist"].shape[0]
    if fn == "conflict":
        n_over = int((_inputs(name)["occ"] > _inputs(name)["graph"][
            "capacity"]).sum())
        assert n_over > p["K"]
        c = got["conflict"]
        assert (c & ~np.eye(len(c), dtype=bool)).any()


def test_pow2_relax_is_tie_heavy():
    """The power-of-two relaxation case ties exactly: at its fixpoint
    many nodes have several in-edges at the minimum, so its bit-identity
    above holds the first-slot argmin (jnp.argmin's rule)."""
    x = _inputs("relax_pow2")
    g = x["graph"]
    dist = jax_run("relax_pow2")["dist"]
    ties = 0
    for b in range(dist.shape[0]):
        for v in np.where(np.isfinite(dist[b]))[0]:
            c = np.where(g["ell_valid"][v], dist[b][g["ell_src"][v]]
                         + x["cong_c"][b, v], np.inf)
            ties += int(np.isfinite(c.min()) and (c == c.min()).sum() > 1)
    assert ties > 50


# ROADMAP.md C9: (over, pres_fac) where XLA:CPU's default flags contract
# the present cost 1 + over * pres_fac into one FMA, one ulp off
C9_CASES = ((97, 0.65), (393, 0.65), (605, 0.845))


def _c9_inputs():
    over = np.array([o for o, _ in C9_CASES], np.int32)
    cap = np.ones_like(over)
    pres = np.array([p for _, p in C9_CASES], np.float32)
    return over, cap, over + cap - 1, pres


def c9_jax() -> np.ndarray:
    """JAX's congestion_cost_arrays at the C9 cases under this
    process's flags: one jit call each, base and acc 1, pres_fac a
    float32 scalar."""
    import jax
    import jax.numpy as jnp

    from parallel_eda_tpu.route.search import congestion_cost_arrays

    over, cap, occ, pres = _c9_inputs()
    f = jax.jit(congestion_cost_arrays)
    one = np.ones(1, np.float32)
    return np.array([np.asarray(f(one, cap[i:i + 1], occ[i:i + 1], one,
                                  jnp.float32(pres[i])))[0]
                     for i in range(len(over))], np.float32)


def _host_has_fma() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return "fma" in f.read().split()
    except OSError:
        return False


def test_congestion_cost_arrays_c9_pinned(tmp_path):
    """ROADMAP.md C9, pinned: the port's present cost rounds the product
    and the sum separately, so at the C9 cases it equals numpy's float32
    1 + (over * pres) and JAX's function under
    XLA_FLAGS=--xla_cpu_max_isa=AVX (run in a subprocess), with pres_fac
    a float32 tensor (the planes step) or a Python float (the ELL
    search).  Recorded: JAX with its default flags, in this process,
    contracts the FMA on a host that has one and is one ulp off at every
    case."""
    from parallel_eda_tpu_torch.route.search import congestion_cost_arrays

    over, cap, occ, pres = _c9_inputs()
    want = np.float32(1.0) + over.astype(np.float32) * pres
    one = torch.ones(1)
    for i in range(len(over)):
        args = (one, torch.from_numpy(cap[i:i + 1]),
                torch.from_numpy(occ[i:i + 1]), one)
        for p in (torch.tensor(pres[i]), float(pres[i])):
            got = congestion_cost_arrays(*args, p)
            assert got.dtype == torch.float32
            assert got.numpy()[0] == want[i], (C9_CASES[i], p)
    path = tmp_path / "c9.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path), "--c9"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert np.array_equal(np.load(path), want)
    ulps = np.abs(c9_jax().view(np.int32) - want.view(np.int32))
    assert ulps.tolist() == ([1] * len(over) if _host_has_fma()
                             else [0] * len(over))


if __name__ == "__main__":
    if sys.argv[2:] == ["--c9"]:
        np.save(sys.argv[1], c9_jax())
    else:
        write_reference(sys.argv[1], sys.argv[2:])
