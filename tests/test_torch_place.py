"""The port's device annealer (parallel_eda_tpu_torch/place/sa.py,
macros.py, check.py and flow.run_place) against the JAX package, on the
CPU.

The JAX references run in a subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (this file run as a script writes
them to an .npz): with its default flags XLA:CPU contracts ``a*b + c``
into fused multiply-adds, in the cost sums and in the timing cost alike
(ROADMAP.md C2), and the port rounds every product and sum on its own.
Every comparison is exact: the proposals, the site claims, the accept
mask, the new state, the counts, the float cost sums and the whole
anneal's positions and temperature rows.

The one float the port cannot match by construction is ``exp`` in the
Metropolis test (XLA's and the C library's differ in the last ulp on a
few percent of inputs): a decision whose uniform draw lies within 2 ulp
of exp(-delta/t) is a near-tie.  The step tests count them, expect none
on these fixtures, and leave any they find out of the comparison with a
warning that names the move.  Where a whole anneal diverges, the test
replays both packages step by step and names the segment, temperature,
step and move of the first different decision."""

import dataclasses
import importlib
import os
import subprocess
import sys
import warnings

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

JAX_PKG, PORT_PKG = "parallel_eda_tpu", "parallel_eda_tpu_torch"
F15 = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10, seed=3)
F25 = dict(num_luts=25, num_inputs=6, num_outputs=6, chan_width=10, seed=3)
F40 = dict(num_luts=40, num_inputs=6, num_outputs=6, chan_width=10, seed=3)
FIXTURES = {"f15": F15, "f25": F25, "f40": F40}
# one-step cases: name -> (fixture, timing, key seed, t)
# (t is where the Metropolis test accepts some uphill moves and rejects
# others)
STEPS = {"f15_wl": ("f15", False, 0, 0.01), "f15_td": ("f15", True, 1, 0.05),
         "f40_wl": ("f40", False, 2, 0.02), "f40_td": ("f40", True, 3, 0.1),
         "f25_td": ("f25", True, 4, 0.005)}
# whole anneals: name -> (fixture, PlacerOpts fields, timing-driven,
# hand-built macros, route afterwards)
ANNEALS = {
    "wl15": ("f15", dict(seed=1), False, False, False),
    "flow15": ("f15", dict(seed=1), True, False, True),
    "td40": ("f40", dict(seed=2, max_temps=12), True, False, False),
    "wl25": ("f25", dict(seed=5, max_temps=16), False, False, False),
    "macro40": ("f40", dict(seed=2, max_temps=16), False, True, False),
    # slow: the timing-driven anneals of the larger fixtures to the end
    "td25_full": ("f25", dict(seed=1), True, False, False),
    "td40_full": ("f40", dict(seed=1), True, False, False),
}
SLOW = ("td25_full", "td40_full")
# (costed nets, pins per net) of the fixtures: the sum orders the tests
# hold (windowed at 35 nets, four lanes at 16 to 32 rows) depend on them
SHAPES = {"f15": (17, 6), "f25": (22, 6), "f40": (35, 9)}


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "flow", "place.sa", "place.macros", "place.check",
        "place.initial", "place.delay_lookup", "route.router")}


def _kw(pkg):
    """The port runs on the CPU only when asked."""
    return {} if pkg == JAX_PKG else {"device": "cpu"}


def _flow(pkg, name):
    return _mods(pkg)["flow"].synth_flow(**FIXTURES[name])


def _macros(pnl):
    """Three hand-built chains of CLBs (lengths 3, 3, 2)."""
    clb = [b for b in range(pnl.num_blocks)
           if not pnl.block_type(b).is_io]
    return [clb[0:3], clb[5:8], clb[10:12]]


def _lookup(pkg, grid, seed=0):
    """A seeded delay-lookup stack, growing with the offset."""
    H, W = grid.nx + 2, grid.ny + 2
    rng = np.random.default_rng(seed)
    base = rng.uniform(5e-11, 2e-10, (4, 1, 1))
    stack = base * (1 + np.arange(H)[None, :, None]
                    + np.arange(W)[None, None, :])
    stack += rng.uniform(0, 3e-11, (4, H, W))
    return _mods(pkg)["place.delay_lookup"].DelayLookup(
        stack=stack.astype(np.float32))


def _problem(pkg, name, timing):
    """(flow, Placer, pp, state, crit, M) of step case inputs: the
    fixture at a seeded random initial placement."""
    m = _mods(pkg)
    f = _flow(pkg, name)
    sa = m["place.sa"]
    pos0 = m["place.initial"].initial_placement(f.pnl, f.grid, seed=7)
    placer = sa.Placer(f.pnl, f.grid, sa.PlacerOpts(moves_per_step=32),
                       **_kw(pkg))
    pp = sa.build_place_problem(
        f.pnl, f.grid, lookup=_lookup(pkg, f.grid) if timing else None,
        **_kw(pkg))
    NN, P = pp.net_blk.shape
    crit = np.random.default_rng(1).uniform(0, 1, (NN, P)).astype(
        np.float32)
    M = min(32, max(8, pp.num_blocks))
    return f, placer, pp, placer._state_from_pos(pos0), crit, M


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _jax_step(name):
    """JAX sa_step outputs, its proposals, its site claims and its
    Metropolis uniforms for step case ``name``."""
    import jax.numpy as jnp
    sa = _mods(JAX_PKG)["place.sa"]
    fx, timing, seed, t = STEPS[name]
    f, placer, pp, (pos, ring, occ), crit, M = _problem(JAX_PKG, fx, timing)
    key = jax.random.PRNGKey(seed)
    args = (pp, pos, ring, occ, jnp.asarray(crit), jnp.float32(0.0123),
            jnp.float32(3.7e8), jnp.float32(0.5), key, jnp.float32(t),
            jnp.float32(3.0))
    out = sa.sa_step(*args, M, timing)
    kp, ka = jax.random.split(key)
    b, npos, nring = sa._propose(pp, pos, ring, kp, jnp.float32(3.0), M)
    # the claim rule of sa_step (:352-367) on the proposals, for `own`
    NS = pp.num_sites
    site = sa._site_of(pp, pos, ring)
    src = site[b]
    clb = (npos[:, 1] - 1) * pp.nx + (npos[:, 0] - 1)
    io = pp.nx * pp.ny + nring * pp.io_cap + npos[:, 2]
    dst = jnp.where(pp.is_io[b], io, clb)
    o = occ[dst]
    ar = jnp.arange(M, dtype=jnp.int32)
    claim = jnp.full(NS, M, jnp.int32).at[src].min(ar).at[dst].min(ar)
    own = ((claim[src] == ar) & (claim[dst] == ar) & (dst != src)
           & ~(pp.frozen[jnp.clip(o, 0)] & (o >= 0)))
    res = dict(zip(("pos", "ring", "occ", "na", "nv", "dsum", "dsq"),
                   map(np.asarray, out)))
    res.update(b=np.asarray(b), npos=np.asarray(npos),
               nring=np.asarray(nring), own=np.asarray(own),
               u=np.asarray(jax.random.uniform(ka, (M,))))
    return res


# sa_temperature cases: (fixture, timing); three steps at t 0.02
TEMPS = [("f15", False), ("f40", True), ("f25", True)]


def _temperature(pkg, fx, timing):
    """sa_temperature's outputs: (pos, ring, occ, n_acc, n_valid, bb
    cost, td cost)."""
    sa = _mods(pkg)["place.sa"]
    f, placer, pp, (pos, ring, occ), crit, M = _problem(pkg, fx, timing)
    if pkg == JAX_PKG:
        import jax.numpy as jnp
        out = sa.sa_temperature(
            pp, pos, ring, occ, jnp.asarray(crit), jnp.float32(0.0123),
            jnp.float32(3.7e8), jnp.float32(0.5), jax.random.PRNGKey(5),
            jnp.float32(0.02), jnp.float32(3.0), M, 3, timing)
    else:
        from parallel_eda_tpu_torch.place import prng
        out = sa.sa_temperature(
            pp, pos, ring, occ, torch.from_numpy(crit), np.float32(0.0123),
            np.float32(3.7e8), 0.5, prng.PRNGKey(5, device="cpu"), 0.02,
            3.0, M, 3, timing)
    return [_np(x) for x in out]


def _macro_case(pkg):
    """macro_step inputs at F40 with the hand-built macros, aligned."""
    m = _mods(pkg)
    f = _flow(pkg, "f40")
    macros = _macros(f.pnl)
    placer = m["place.sa"].Placer(f.pnl, f.grid, macros=macros, **_kw(pkg))
    pos0 = m["place.macros"].align_initial(f.pnl, f.grid, f.pos, macros)
    return placer, placer._state_from_pos(pos0)


# (key seed, t): downhill, rejected and accepted uphill macro moves
MACRO_T = ((13, 0.1), (14, 0.0), (15, 0.1), (14, 1.0))


def _jax_macro():
    import jax.numpy as jnp
    sa = _mods(JAX_PKG)["place.sa"]
    placer, (pos, ring, occ) = _macro_case(JAX_PKG)
    out = {}
    for i, (seed, t) in enumerate(MACRO_T):
        p, r, o, na = sa.macro_step(
            placer.pp, placer._mac_blocks, placer._mac_len, pos, ring, occ,
            jax.random.PRNGKey(seed), jnp.float32(t), jnp.float32(4.0),
            jnp.float32(0.02), 4, 3)
        out.update({f"{i}/pos": np.asarray(p), f"{i}/occ": np.asarray(o),
                    f"{i}/na": np.asarray(na)})
    return out


def _costs(pkg, name):
    """Eager net_bb_cost and net_td_cost at the fixture's placement."""
    m = _mods(pkg)
    sa = m["place.sa"]
    f = _flow(pkg, name)
    pp = sa.build_place_problem(f.pnl, f.grid, lookup=_lookup(pkg, f.grid),
                                **_kw(pkg))
    NN, P = pp.net_blk.shape
    crit = np.random.default_rng(2).uniform(0, 1, (NN, P)).astype(np.float32)
    if pkg == JAX_PKG:
        pos, crit = jax.numpy.asarray(f.pos), jax.numpy.asarray(crit)
    else:
        pos, crit = (torch.from_numpy(f.pos.astype(np.int64)),
                     torch.from_numpy(crit))
    total, bb = sa.net_bb_cost(pp, pos)
    return dict(bb_total=_np(total), bb=_np(bb),
                td_total=_np(sa.net_td_cost(pp, pos, crit)))


def _anneal(pkg, name):
    """Whole anneal ``name``: placement, stats and, for flow cases, the
    route after it."""
    fx, fields, timing, macros, route = ANNEALS[name]
    m = _mods(pkg)
    sa = m["place.sa"]
    f = _flow(pkg, fx)
    opts = sa.PlacerOpts(moves_per_step=32, **fields)
    if macros:
        placer = sa.Placer(f.pnl, f.grid, opts, macros=_macros(f.pnl),
                           **_kw(pkg))
        f.pos, f.place_stats = placer.place(f.pos)
    else:
        f = m["flow"].run_place(f, opts, timing_driven=timing, **_kw(pkg))
    st = f.place_stats
    out = dict(pos=np.asarray(f.pos), temps=np.array(st.temps, np.float64),
               stats=np.array([st.initial_cost, st.final_cost,
                               st.final_td_cost, st.est_crit_path,
                               st.total_moves], np.float64),
               term_sinks=f.term.sinks, term_bb=np.stack(
                   [f.term.bb_xmin, f.term.bb_xmax, f.term.bb_ymin,
                    f.term.bb_ymax]))
    if route:
        extra = {"pipeline": False} if pkg == JAX_PKG else {}
        f = m["flow"].run_route(
            f, m["route.router"].RouterOpts(batch_size=32, **extra),
            **_kw(pkg))
        out.update(route=np.array([f.route.success, f.route.wirelength,
                                   f.route.iterations]),
                   paths=f.route.paths, cpd=np.array(f.crit_path_delay))
    return out


def _step_positions(pkg, name):
    """Positions after every annealing step of anneal ``name`` (the
    starting-temperature probe first, then every step of every segment),
    recorded by wrapping the package's step function; the port's also
    carry each step's StepTrace.  Used only to name a divergence."""
    sa = _mods(pkg)["place.sa"]
    attr = "sa_step" if pkg == JAX_PKG else "_step"
    orig, rec = getattr(sa, attr), []

    def step(*args, **kw):
        if pkg != JAX_PKG:
            kw["trace"] = True
        out = orig(*args, **kw)
        if pkg == JAX_PKG:
            jax.debug.callback(lambda p: rec.append(np.asarray(p)), out[0],
                               ordered=True)
        else:
            rec.append((out[0].numpy().copy(), out[-1]))
        return out

    setattr(sa, attr, step)
    try:
        _anneal(pkg, name)
    finally:
        setattr(sa, attr, orig)
    return rec


def _name_divergence(name, jax_steps):
    """Segment, temperature, step and move of the first decision where
    the port's anneal ``name`` leaves JAX's (whose positions after each
    step are ``jax_steps``)."""
    port = _step_positions(PORT_PKG, name)
    fx, fields, timing, _, _ = ANNEALS[name]
    f = _flow(PORT_PKG, fx)
    NB = f.pnl.num_blocks
    M = min(32, max(8, NB))
    steps = max(1, int(np.ceil(NB ** (4 / 3) / M)))
    seg = 1 if timing else 8
    for i, (want, (got, tr)) in enumerate(zip(jax_steps, port)):
        if np.array_equal(want, got):
            continue
        b, npos, own = _np(tr.b), _np(tr.npos), _np(tr.own)
        jacc = own & (want[b] == npos).all(axis=1)
        m = int(np.flatnonzero(jacc != _np(tr.accept))[0])
        where = ("the starting-temperature probe" if i == 0 else
                 f"segment {(i - 1) // steps // seg}, temperature "
                 f"{(i - 1) // steps}, step {(i - 1) % steps}")
        return (f"{where}, move {m}: JAX accepts {bool(jacc[m])}, delta "
                f"{float(tr.delta[m])!r}, u {float(tr.u[m])!r}, "
                f"exp(-delta/t) {float(tr.thresh[m])!r}")
    return f"no step differs in {min(len(jax_steps), len(port))} steps"


def write_step_positions(path, name):
    np.savez(path, steps=np.stack(_step_positions(JAX_PKG, name)))


def write_reference(path, names):
    """The JAX references: every step, macro-step and cost case, and the
    anneals ``names``, into the .npz ``path``.  Run under the AVX flag."""
    out = {}
    for name in STEPS:
        for k, v in _jax_step(name).items():
            out[f"step/{name}/{k}"] = v
    for k, v in _jax_macro().items():
        out[f"macro/{k}"] = v
    for fx, timing in TEMPS:
        for i, v in enumerate(_temperature(JAX_PKG, fx, timing)):
            out[f"temp/{fx}/{timing}/{i}"] = v
    for name in FIXTURES:
        for k, v in _costs(JAX_PKG, name).items():
            out[f"costs/{name}/{k}"] = v
    for name in names:
        for k, v in _anneal(JAX_PKG, name).items():
            out[f"anneal/{name}/{k}"] = v
    np.savez(path, **out)


def _reference(path, names):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path), *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return dict({k: z[k] for k in z.files}, _path=str(path))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("jax_place") / "ref.npz",
                      [n for n in ANNEALS if n not in SLOW])


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("with_macros", [False, True])
def test_build_place_problem_matches_jax(name, with_macros):
    jsa, tsa = _mods(JAX_PKG)["place.sa"], _mods(PORT_PKG)["place.sa"]
    jf, tf = _flow(JAX_PKG, name), _flow(PORT_PKG, name)
    mac = _macros(jf.pnl) if with_macros else None
    jp = jsa.build_place_problem(jf.pnl, jf.grid,
                                 lookup=_lookup(JAX_PKG, jf.grid),
                                 macros=mac)
    tp = tsa.build_place_problem(tf.pnl, tf.grid,
                                 lookup=_lookup(PORT_PKG, tf.grid),
                                 macros=mac, device="cpu")
    for fld in dataclasses.fields(tp):
        a, b = getattr(jp, fld.name), getattr(tp, fld.name)
        if isinstance(b, torch.Tensor):
            assert np.array_equal(np.asarray(a), b.numpy()), fld.name
        else:
            assert a == b, fld.name
    assert tp.net_blk.shape == SHAPES[name]
    assert tp.num_sites == jp.num_sites and tp.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_site_of_and_state_match_jax(name):
    """_site_of and the initial (pos, ring, occ) of Placer."""
    jsa, tsa = _mods(JAX_PKG)["place.sa"], _mods(PORT_PKG)["place.sa"]
    jf, tf = _flow(JAX_PKG, name), _flow(PORT_PKG, name)
    js = jsa.Placer(jf.pnl, jf.grid)._state_from_pos(jf.pos)
    tpl = tsa.Placer(tf.pnl, tf.grid, device="cpu")
    ts = tpl._state_from_pos(tf.pos)
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jsa._site_of(
        jsa.build_place_problem(jf.pnl, jf.grid), js[0], js[1])),
        tsa._site_of(tpl.pp, ts[0], ts[1]).numpy())
    with pytest.raises(ValueError, match="collisions"):
        bad = tf.pos.copy()
        bad[1] = bad[0]
        tpl._state_from_pos(bad)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_costs_match_jax(ref, name):
    """net_bb_cost's bb (integers) and total, net_td_cost's total: bit
    for bit (NN = 35 at f40 takes XLA's windowed order)."""
    want = _sub(ref, f"costs/{name}/")
    got = _costs(PORT_PKG, name)
    for k in ("bb_total", "bb", "td_total"):
        assert np.array_equal(want[k], got[k]), k
    assert got["td_total"] > 0


def test_crossing_factor_matches_jax():
    from parallel_eda_tpu.place.sa import crossing_factor as jq
    from parallel_eda_tpu_torch.place.sa import crossing_factor as tq

    n = np.arange(0, 80)
    assert np.array_equal(jq(n), tq(n))


# ---------------------------------------------------------------- one step

def _port_step(name):
    tsa = _mods(PORT_PKG)["place.sa"]
    from parallel_eda_tpu_torch.place import prng

    fx, timing, seed, t = STEPS[name]
    f, placer, pp, (pos, ring, occ), crit, M = _problem(PORT_PKG, fx,
                                                         timing)
    out = tsa.sa_step(pp, pos, ring, occ, torch.from_numpy(crit),
                      np.float32(0.0123), np.float32(3.7e8), 0.5,
                      prng.PRNGKey(seed, device="cpu"), t, 3.0, M, timing,
                      trace=True)
    return pp, pos, out


def _near_ties(u, thresh, delta, own):
    """Moves whose Metropolis draw lies within 2 ulp of the threshold."""
    gap = np.abs(u.astype(np.float64) - thresh.astype(np.float64))
    return np.where(own & (delta > 0)
                    & (gap <= 2 * np.spacing(thresh)))[0].tolist()


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sa_step_matches_jax(ref, name):
    """Proposals, own, accept mask, new state, counts and the moments
    of delta (its sum and sum of squares over the owned moves)."""
    want = _sub(ref, f"step/{name}/")
    pp, pos, out = _port_step(name)
    tr = out[-1]
    for k in ("b", "npos", "nring", "own", "u"):
        assert np.array_equal(want[k], _np(getattr(tr, k))), k
    own = want["own"]
    delta, thresh = _np(tr.delta), _np(tr.thresh)
    ties = _near_ties(want["u"], thresh, delta, own)
    if ties:
        warnings.warn(f"{name}: near-tie Metropolis decisions at moves "
                      f"{ties} left out of the accept comparison")
    # JAX's accept mask: an owned move is accepted iff its block moved to
    # its proposal (owned moves touch disjoint blocks)
    jacc = own & (want["pos"][want["b"]] == want["npos"]).all(axis=1)
    keep = np.ones(len(own), bool)
    keep[ties] = False
    assert np.array_equal(jacc[keep], _np(tr.accept)[keep])
    assert 0 < jacc.sum() < own.sum(), "fixture should mix accepts/rejects"
    if not ties:
        for k, g in zip(("pos", "ring", "occ", "na", "nv", "dsum", "dsq"),
                        out[:7]):
            assert np.array_equal(want[k], _np(g)), k


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sa_step_scatters_hit_drop_slot_only(name):
    """The applies write each block and each site at most once; every
    repeated index is the drop slot (NB, NS), so index_put_ on the card
    has no undefined winner."""
    pp, pos, out = _port_step(name)
    tr = out[-1]
    for idx, drop in ((tr.blk_idx, pp.num_blocks),
                      (tr.site_idx, pp.num_sites)):
        live = idx[idx != drop]
        assert len(live) == len(torch.unique(live)), name
    assert int(out[3]) > 0


@pytest.mark.parametrize("fx,timing", TEMPS)
def test_sa_temperature_matches_jax(ref, fx, timing):
    """All steps of one temperature and its closing costs."""
    got = _temperature(PORT_PKG, fx, timing)
    for i, g in enumerate(got):
        assert np.array_equal(ref[f"temp/{fx}/{timing}/{i}"], g), i
    assert 0 < got[3] < got[4]


def test_macro_step_matches_jax(ref):
    tsa = _mods(PORT_PKG)["place.sa"]
    from parallel_eda_tpu_torch.place import prng

    placer, (pos, ring, occ) = _macro_case(PORT_PKG)
    accepted = []
    for i, (seed, t) in enumerate(MACRO_T):
        p, r, o, na, tr = tsa.macro_step(
            placer.pp, placer._mac_blocks, placer._mac_len, pos, ring, occ,
            prng.PRNGKey(seed, device="cpu"), t, 4.0, 0.02, 4, 3, trace=True)
        ties = _near_ties(_np(tr["u"]), _np(tr["thresh"]),
                          _np(tr["delta"]), _np(tr["own"]))
        assert not ties, ties
        assert np.array_equal(ref[f"macro/{i}/pos"], p.numpy())
        assert np.array_equal(ref[f"macro/{i}/occ"], o.numpy())
        assert int(ref[f"macro/{i}/na"]) == int(na)
        for idx, drop in ((tr["blk_idx"], placer.pp.num_blocks),
                          (tr["site_idx"], placer.pp.num_sites)):
            live = idx[idx != drop]
            assert len(live) == len(torch.unique(live))
        accepted.append(int(na))
    assert accepted == [2, 1, 1, 2]


# ---------------------------------------------------------------- anneal

def _first_divergence(want_temps, got_temps, seg):
    """The first temperature row (t, bb cost, success rate, rlim) that
    differs, with its segment of ``seg`` temperatures."""
    for i, (a, b) in enumerate(zip(want_temps, got_temps)):
        if not np.array_equal(a, b):
            return (f"segment {i // seg}, temperature {i}: JAX "
                    f"{a.tolist()} port {b.tolist()}")
    return f"{len(want_temps)} against {len(got_temps)} temperatures"


def _assert_anneal(ref, name):
    want = _sub(ref, f"anneal/{name}/")
    got = _anneal(PORT_PKG, name)
    seg = 1 if ANNEALS[name][2] else 8      # Placer.place's SEG
    where = _first_divergence(want["temps"], got["temps"], seg)
    if not np.array_equal(want["pos"], got["pos"]):
        steps = _reference(os.path.join(os.path.dirname(ref["_path"]),
                                        f"steps_{name}.npz"),
                           ["--steps", name])["steps"]
        pytest.fail(f"{name}: placements differ; first different "
                    f"temperature row: {where}; first different decision: "
                    f"{_name_divergence(name, steps)}")
    assert np.array_equal(want["temps"], got["temps"]), where
    assert np.array_equal(want["stats"], got["stats"], equal_nan=True)
    for k in ("term_sinks", "term_bb"):
        assert np.array_equal(want[k], got[k]), k
    if "route" in want:
        for k in ("route", "paths", "cpd"):
            assert np.array_equal(want[k], got[k]), k
    return got


@pytest.mark.parametrize("name", [n for n in ANNEALS
                                  if n not in SLOW and n != "flow15"])
def test_place_matches_jax(ref, name):
    """Placer.place (through run_place unless macros are hand-built):
    positions, every temperature row (t, bb cost, success rate, rlim),
    initial/final cost, final td cost, est_crit_path and total moves."""
    got = _assert_anneal(ref, name)
    temps = got["temps"]
    assert temps[-1, 1] < temps[0, 1]          # the anneal improved
    if ANNEALS[name][3]:
        from parallel_eda_tpu_torch.flow import synth_flow
        f = synth_flow(**FIXTURES[ANNEALS[name][0]])
        for m in _macros(f.pnl):
            xs = {int(got["pos"][b, 0]) for b in m}
            ys = [int(got["pos"][b, 1]) for b in m]
            assert len(xs) == 1 and ys == list(range(ys[0],
                                                     ys[0] + len(m)))


def test_run_place_then_route_matches_jax(ref):
    """run_place (timing-driven, delay lookup, macros formed from the
    netlist) then run_route: positions, terminals, wirelength,
    iterations, paths and crit path equal the JAX flow's."""
    got = _assert_anneal(ref, "flow15")
    assert got["route"][0] and np.isfinite(got["cpd"])
    assert np.isfinite(got["stats"][3])       # est_crit_path


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_place_timing_full_matches_jax(tmp_path, name):
    _assert_anneal(_reference(tmp_path / "ref.npz", [name]), name)


def test_sa_segment_reports_done_temperatures_dead():
    """After t falls below exit_t the remaining temperatures run at t=0
    and are reported as not live, with t and rlim frozen."""
    tsa = _mods(PORT_PKG)["place.sa"]
    from parallel_eda_tpu_torch.place import prng

    f, placer, pp, (pos, ring, occ), crit, M = _problem(PORT_PKG, "f15",
                                                         False)
    out = tsa.sa_segment(pp, pos, ring, occ, torch.from_numpy(crit), 0.0,
                         prng.PRNGKey(0, device="cpu"), 1e-3, 1.0, 0.99e-3,
                         M, 2, 4)
    live, ts = out[8].numpy(), out[9].numpy()
    assert live[0] == 1.0 and live[-1] == 0.0
    dead = live == 0.0
    assert (ts[dead] == ts[dead][0]).all()


def test_placer_defaults_to_card():
    """Placer, build_place_problem and run_place run on the card unless
    the caller asks for the CPU; without a card they raise."""
    from parallel_eda_tpu_torch.flow import run_place
    tsa = _mods(PORT_PKG)["place.sa"]

    if torch.cuda.is_available():
        return
    f = _flow(PORT_PKG, "f15")
    for call in (lambda: tsa.Placer(f.pnl, f.grid),
                 lambda: tsa.build_place_problem(f.pnl, f.grid),
                 lambda: run_place(f, timing_driven=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------- host

def test_check_place_matches_jax():
    """The legality audit accepts a legal placement and raises the same
    error as the JAX package's on each kind of violation."""
    from parallel_eda_tpu.place.check import check_place as jchk
    from parallel_eda_tpu_torch.place.check import check_place as tchk

    f = _flow(PORT_PKG, "f40")
    tchk(f.pnl, f.grid, f.pos)
    io = next(b for b in range(f.pnl.num_blocks)
              if f.pnl.block_type(b).is_io)
    clb = next(b for b in range(f.pnl.num_blocks)
               if not f.pnl.block_type(b).is_io)
    breaks = [(io, (0, 0, 0)), (io, None), (clb, (0, 2, 0)),
              (clb, (2, 2, 1)), (clb, "dup")]
    for b, xyz in breaks:
        pos = f.pos.copy()
        if xyz is None:
            pos[b, 2] = f.grid.io_capacity
        elif xyz == "dup":
            pos[b] = pos[b + 1]
        else:
            pos[b] = xyz
        errs = []
        for chk in (jchk, tchk):
            with pytest.raises(ValueError) as e:
                chk(f.pnl, f.grid, pos)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_macros_match_jax():
    """form_macros on carry chains laid over the netlist's LUTs, and
    align_initial on them, equal the JAX package's."""
    out = []
    for pkg in (JAX_PKG, PORT_PKG):
        m = _mods(pkg)
        f = _flow(pkg, "f40")
        luts = [p.name for p in f.nl.primitives if p.kind == 2]   # PRIM_LUT
        f.nl.carry_chains = [luts[0:4], luts[4:7], luts[7:9], luts[9:10]]
        macros = m["place.macros"].form_macros(f.nl, f.pnl)
        pos = m["place.macros"].align_initial(f.pnl, f.grid, f.pos, macros)
        out.append((macros, pos))
    assert out[0][0] == out[1][0] and len(out[0][0]) >= 2
    assert np.array_equal(out[0][1], out[1][1])


if __name__ == "__main__":
    if sys.argv[2:3] == ["--steps"]:
        write_step_positions(sys.argv[1], sys.argv[3])
    else:
        write_reference(sys.argv[1], sys.argv[2:])
