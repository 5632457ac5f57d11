"""The port's float32 reduction orders (parallel_eda_tpu_torch/place/sa.py,
"sums") against XLA:CPU's, bit for bit, over sweeps of trip counts
rather than at the fixtures' shapes alone:

- a standalone 1-D sum (net_bb_cost over the NN nets) at lengths 1 to
  5,000, and a standalone 2-D sum (an eager net_td_cost over [NN, P]) at
  NN 1 to 2,048 and P 1 to 32, on seeded data of mixed sign and scale;
- sa_step's moments over the M moves (the starting temperature), at
  every branch of _moment_sum's rule and at the default M = 256, with
  the accept mask and new state at a temperature that mixes accepts and
  rejects, on the 1,200-LUT scale config's placement problem (its
  packed netlist at NN 1,107, P 10, 2F 16; no routing graph is built);
- the same step with each block's and each net's table padded wider
  (2F up to 96, P up to 40; P 22 to 32, ROADMAP.md C6's former open
  case, at 22, 24 and 32 here and at every P in the slow sweep), and
  the scale config's eager costs and one temperature's fused costs.

The JAX references run in a subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (this file run as a script writes
them to an .npz), as in tests/test_torch_place.py: the orders are read
from XLA:CPU's code at that ISA.  ROADMAP.md C6 lists what the sweeps
leave out."""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

JAX_PKG, PORT_PKG = "parallel_eda_tpu", "parallel_eda_tpu_torch"
SCALE = dict(num_luts=1200, num_inputs=12, num_outputs=12, chan_width=20,
             seed=11)
# 1-D lengths: the scalar range, the window boundary, one and two levels
# of windows with every padding parity, the scale config's NN
LENGTHS = [1, 2, 7, 15, 16, 17, 31, 32, 33, 40, 63, 64, 65, 100, 255, 256,
           257, 1000, 1023, 1024, 1025, 1107, 2047, 2048, 5000]
# 2-D rows: each branch of _eager_sum2 (in order, two lanes, four lanes,
# unpadded and one-row-padded windows, other padding, two window levels)
ROWS = [1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 24, 31, 32, 33, 35, 40, 62,
        63, 64, 65, 95, 96, 100, 127, 128, 481, 1023, 1024, 1107, 2048]
COLS = [1, 2, 3, 4, 6, 8, 9, 10, 16, 17, 31, 32]
# moves per step: scalar, each (lanes, accumulators) of the rule in both
# modes, the first windowed M, the default
MOVES = [15, 16, 20, 24, 28, 31, 32, 33, 256]
# (2F, P) of the padded-table steps, timing-driven: the bb delta past
# the vectorized 2F, unpadded and padded [2F, P] windows, P up to 32 (22,
# 24 and 32: ROADMAP.md C6's former open case) and past 32
WIDE = [(24, 10), (40, 10), (64, 10), (80, 10), (96, 10), (16, 16),
        (16, 21), (16, 22), (16, 24), (16, 32), (34, 33), (40, 40)]
# net counts the scale problem is padded to (rows of -1): the segment's
# fused td cost over unpadded and one-row-padded windows
NETS = [1120, 1151]
TIER1 = dict(lengths=LENGTHS, rows=ROWS, cols=COLS, moves=MOVES, wide=WIDE,
             nets=NETS)
# the whole sweep (slow): every M from 8 to 34, every NN to 69, ...
FULL = dict(
    lengths=sorted(set(range(1, 200)) | {255, 256, 257, 500, 1000, 1023,
                                         1024, 1025, 1107, 2000, 4096,
                                         5000, 33000}),
    rows=list(range(1, 70)) + [94, 95, 96, 97, 127, 128, 129, 480, 481,
                               500, 511, 512, 1000, 1023, 1024, 1025, 1107,
                               2000, 2047, 2048, 5000],
    cols=list(range(1, 12)) + [15, 16, 17, 24, 31, 32],
    moves=list(range(8, 35)) + [40, 55, 64, 100, 128, 256, 257, 300, 512,
                                513, 1000, 1024, 2048],
    wide=[(f, 10) for f in (18, 20, 24, 30, 32, 34, 40, 48, 62, 64, 80, 94,
                             96)]
    + [(16, p) for p in range(11, 33)] + [(16, 33), (16, 40), (34, 33),
                                          (40, 40)],
    nets=[1119, 1120, 1121, 1151, 1152, 1184, 1200])
T_MIX = 0.01     # a temperature that accepts some uphill moves, not all


def _data(shape, rep):
    """Seeded float32 values of mixed sign over six decades."""
    rng = np.random.default_rng([*shape, rep, 7])
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "place.sa", "place.initial", "place.delay_lookup", "rr.grid",
        "pack.packer", "netlist.generate", "arch.builtin")}


def _problem(pkg, timing, wide=None, nn=None):
    """(sa module, pp, (pos, ring, occ), crit) at the scale config's
    placement problem (a seeded initial placement, a seeded lookup when
    timing-driven); ``wide`` = (2F, P) pads blk_net and net_blk with -1
    columns, ``nn`` pads net_blk with rows of -1 (nets of no pin)."""
    m = _mods(pkg)
    arch = m["arch.builtin"].minimal_arch(chan_width=SCALE["chan_width"])
    nl = m["netlist.generate"].generate_circuit(
        num_luts=SCALE["num_luts"], num_inputs=SCALE["num_inputs"],
        num_outputs=SCALE["num_outputs"], K=arch.K, seed=SCALE["seed"],
        ff_ratio=0.3)
    pnl = m["pack.packer"].pack_netlist(nl, arch)
    n_io = sum(pnl.block_type(i).is_io for i in range(pnl.num_blocks))
    grid = m["rr.grid"].size_grid(pnl.num_blocks - n_io, n_io, arch,
                                  hard_counts={})
    sa = m["place.sa"]
    kw = {} if pkg == JAX_PKG else {"device": "cpu"}
    H, W = grid.nx + 2, grid.ny + 2
    rng = np.random.default_rng(0)
    stack = (rng.uniform(5e-11, 2e-10, (4, 1, 1))
             * (1 + np.arange(H)[None, :, None]
                + np.arange(W)[None, None, :])
             + rng.uniform(0, 3e-11, (4, H, W))).astype(np.float32)
    lookup = m["place.delay_lookup"].DelayLookup(stack=stack)
    placer = sa.Placer(pnl, grid, **kw)
    pp = sa.build_place_problem(pnl, grid, lookup=lookup if timing else None,
                                **kw)
    state = placer._state_from_pos(
        m["place.initial"].initial_placement(pnl, grid, seed=7))
    NN, P = pp.net_blk.shape
    if wide is not None:
        F2, P = wide[0] // 2, wide[1]
        bn0, nb0 = np.asarray(pp.blk_net), np.asarray(pp.net_blk)
        bn = np.full((pp.num_blocks, F2), -1, bn0.dtype)
        bn[:, :bn0.shape[1]] = bn0
        nb = np.full((NN, P), -1, nb0.dtype)
        nb[:, :nb0.shape[1]] = nb0
        if pkg == JAX_PKG:
            import jax.numpy as jnp
            pp = pp.replace(blk_net=jnp.asarray(bn), net_blk=jnp.asarray(nb),
                            net_valid=jnp.asarray(nb >= 0))
        else:
            pp = dataclasses.replace(pp, blk_net=torch.from_numpy(bn),
                                     net_blk=torch.from_numpy(nb),
                                     net_valid=torch.from_numpy(nb >= 0))
    if nn is not None:
        nb0, q0 = np.asarray(pp.net_blk), np.asarray(pp.net_q)
        nb = np.full((nn, nb0.shape[1]), -1, nb0.dtype)
        nb[:NN] = nb0
        q = np.ones(nn, np.float32)
        q[:NN] = q0
        NN = nn
        if pkg == JAX_PKG:
            import jax.numpy as jnp
            pp = pp.replace(net_blk=jnp.asarray(nb), net_q=jnp.asarray(q),
                            net_valid=jnp.asarray(nb >= 0))
        else:
            pp = dataclasses.replace(pp, net_blk=torch.from_numpy(nb),
                                     net_q=torch.from_numpy(q),
                                     net_valid=torch.from_numpy(nb >= 0))
    crit = np.random.default_rng(1).uniform(0, 1, (NN, P)).astype(
        np.float32)
    return sa, pp, state, crit


def _steps(pkg, timing, M, wide=None):
    """sa_step's seven outputs at t = 1e30 (the starting-temperature
    probe: the moments) and at T_MIX, for two keys."""
    sa, pp, (pos, ring, occ), crit = _problem(pkg, timing, wide)
    out = {}
    for seed in (0, 1):
        for t in (1e30, T_MIX):
            if pkg == JAX_PKG:
                import jax
                import jax.numpy as jnp
                o = sa.sa_step(pp, pos, ring, occ, jnp.asarray(crit),
                               jnp.float32(0.0123), jnp.float32(3.7e8),
                               jnp.float32(0.5), jax.random.PRNGKey(seed),
                               jnp.float32(t), jnp.float32(3.0), M, timing)
            else:
                from parallel_eda_tpu_torch.place import prng
                o = sa.sa_step(pp, pos, ring, occ, torch.from_numpy(crit),
                               np.float32(0.0123), np.float32(3.7e8), 0.5,
                               prng.PRNGKey(seed, device="cpu"), t, 3.0, M,
                               timing)
            for i, v in enumerate(o):
                out[f"{seed}/{t}/{i}"] = np.asarray(v)
    return out


def _scale_costs(pkg, timing, nn=None):
    """Eager net_bb_cost and net_td_cost, then one temperature of three
    steps at M 256 (its fused bb and td costs), at the scale config
    (its nets padded to ``nn``)."""
    sa, pp, (pos, ring, occ), crit = _problem(pkg, timing, nn=nn)
    if pkg == JAX_PKG:
        import jax
        import jax.numpy as jnp
        c = jnp.asarray(crit)
        temp = sa.sa_temperature(
            pp, pos, ring, occ, c, jnp.float32(0.0123), jnp.float32(3.7e8),
            jnp.float32(0.5), jax.random.PRNGKey(5), jnp.float32(0.02),
            jnp.float32(3.0), 256, 3, timing)
    else:
        from parallel_eda_tpu_torch.place import prng
        c = torch.from_numpy(crit)
        temp = sa.sa_temperature(
            pp, pos, ring, occ, c, np.float32(0.0123), np.float32(3.7e8),
            0.5, prng.PRNGKey(5, device="cpu"), 0.02, 3.0, 256, 3, timing)
    total, bb = sa.net_bb_cost(pp, pos)
    out = dict(bb_total=total, bb=bb, td_total=sa.net_td_cost(pp, pos, c))
    out.update({f"temp/{i}": v for i, v in enumerate(temp)})
    return {k: np.asarray(v) for k, v in out.items()}


def write_reference(path, sweep):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for n in sweep["lengths"]:
        for r in (0, 1):
            out[f"tree/{n}/{r}"] = np.asarray(jnp.sum(jnp.asarray(
                _data((n,), r))))
    for A in sweep["rows"]:
        for P in sweep["cols"]:
            for r in (0, 1):
                out[f"eager2/{A}x{P}/{r}"] = np.asarray(jnp.sum(
                    jnp.asarray(_data((A, P), r))))
    for timing in (False, True):
        for M in sweep["moves"]:
            for k, v in _steps(JAX_PKG, timing, M).items():
                out[f"step/{timing}/{M}/{k}"] = v
        for k, v in _scale_costs(JAX_PKG, timing).items():
            out[f"scale/{timing}/{k}"] = v
    for w in sweep["wide"]:
        for k, v in _steps(JAX_PKG, True, 64, w).items():
            out[f"wide/{w}/{k}"] = v
    for nn in sweep["nets"]:
        for k, v in _scale_costs(JAX_PKG, True, nn).items():
            out[f"nets/{nn}/{k}"] = v
    np.savez(path, **out)


def _reference(path, full=False):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path)] + (["--full"] if full else []),
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("jax_sums") / "ref.npz")


def _sa():
    return importlib.import_module(f"{PORT_PKG}.place.sa")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _check_tree(ref, n):
    for r in (0, 1):
        got = _sa()._tree_sum(torch.from_numpy(_data((n,), r)))
        assert _bits(ref[f"tree/{n}/{r}"]) == _bits(got.numpy()), (n, r)


def _check_eager2(ref, A, cols):
    bad = []
    for P in cols:
        for r in (0, 1):
            got = _sa()._eager_sum2(torch.from_numpy(_data((A, P), r)))
            if _bits(ref[f"eager2/{A}x{P}/{r}"]) != _bits(got.numpy()):
                bad.append((P, r))
    assert not bad, f"[{A}, P] differs at (P, rep) {bad}"


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _check_steps(want, got, mixed=True):
    for k, v in got.items():
        assert np.array_equal(want[k], v), k
    # the T_MIX steps accepted some moves and rejected some owned ones
    for seed in (0, 1) if mixed else ():
        na, nv = (int(got[f"{seed}/{T_MIX}/{i}"]) for i in (3, 4))
        assert 0 < na < nv


def _check_costs(want, got, timing):
    for k, v in got.items():
        assert np.array_equal(want[k], v), k
    if timing:
        assert got["td_total"] > 0


@pytest.mark.parametrize("n", LENGTHS)
def test_tree_sum_matches_xla(ref, n):
    _check_tree(ref, n)


@pytest.mark.parametrize("A", ROWS)
def test_eager_sum2_matches_xla(ref, A):
    _check_eager2(ref, A, COLS)


@pytest.mark.parametrize("M", MOVES)
@pytest.mark.parametrize("timing", [False, True])
def test_step_moments_match_xla(ref, timing, M):
    """sa_step at M moves: the moments dsum and dsq over the owned
    deltas, the counts and the new state, bit for bit."""
    _check_steps(_sub(ref, f"step/{timing}/{M}/"),
                 _steps(PORT_PKG, timing, M))


@pytest.mark.parametrize("wide", WIDE, ids=[f"2F{f}-P{p}" for f, p in WIDE])
def test_wide_tables_step_matches_xla(ref, wide):
    """The timing-driven step with wider per-block and per-net tables:
    the bb delta over 2F nets past the vectorized range, and the timing
    delta's [2F, P] windows."""
    _check_steps(_sub(ref, f"wide/{wide}/"), _steps(PORT_PKG, True, 64, wide))


@pytest.mark.parametrize("timing", [False, True])
def test_scale_costs_match_xla(ref, timing):
    """At the scale config: the eager bb and td cost totals, the bb per
    net, and one temperature's state, counts and fused costs."""
    _check_costs(_sub(ref, f"scale/{timing}/"), _scale_costs(PORT_PKG, timing),
                 timing)


@pytest.mark.parametrize("nn", NETS)
def test_padded_nets_costs_match_xla(ref, nn):
    """The same, timing-driven, with the nets padded to ``nn`` rows: the
    eager and the fused td cost over unpadded and padded windows."""
    _check_costs(_sub(ref, f"nets/{nn}/"), _scale_costs(PORT_PKG, True, nn),
                 True)


@pytest.mark.slow
def test_full_sweep_matches_xla(tmp_path):
    """Every case of FULL, the sweep behind the rules in place/sa.py
    (ROADMAP.md C6): ~1,700 sums, 80 step shapes and 7 net counts."""
    ref = _reference(tmp_path / "ref.npz", full=True)
    for n in FULL["lengths"]:
        _check_tree(ref, n)
    for A in FULL["rows"]:
        _check_eager2(ref, A, FULL["cols"])
    for timing in (False, True):
        for M in FULL["moves"]:
            _check_steps(_sub(ref, f"step/{timing}/{M}/"),
                         _steps(PORT_PKG, timing, M), mixed=False)
    for w in FULL["wide"]:
        _check_steps(_sub(ref, f"wide/{w}/"), _steps(PORT_PKG, True, 64, w),
                     mixed=False)
    for nn in FULL["nets"]:
        _check_costs(_sub(ref, f"nets/{nn}/"),
                     _scale_costs(PORT_PKG, True, nn), True)


if __name__ == "__main__":
    write_reference(sys.argv[1], FULL if "--full" in sys.argv else TIER1)
