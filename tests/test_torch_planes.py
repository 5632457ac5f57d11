"""The port's plain planes relaxation against the JAX package's.

Same inputs, made from a seed with numpy, go through the JAX function
and its PyTorch counterpart (on the CPU, the plain version).  With
crit == 0 the results must be BIT-identical — dist, pred, wenter and
the [executed, useful] sweep counts — on exact (power-of-two) and on
jittered (uniform) costs: the port's min-plus scan reproduces
lax.associative_scan's combine tree.  With crit > 0, XLA:CPU contracts
``cand + crit*delay`` into an FMA and PyTorch does not, so there the
tolerance is rtol=1e-5 (the one the JAX package's Pallas tests use)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_eda_tpu.arch.builtin import minimal_arch, unidir_arch
from parallel_eda_tpu.arch.model import SegmentInf
from parallel_eda_tpu.route import planes as JP
from parallel_eda_tpu.rr.graph import CHANX, CHANY, build_rr_graph
from parallel_eda_tpu.rr.grid import DeviceGrid
from parallel_eda_tpu_torch.route import planes as TP


def _mixed_len_arch():
    arch = minimal_arch(chan_width=12)
    arch.segments = [
        SegmentInf(name="l1", length=1, frequency=0.4, wire_switch=0,
                   opin_switch=1),
        SegmentInf(name="l2", length=2, frequency=0.3, Rmetal=80.0,
                   Cmetal=15e-15, wire_switch=1, opin_switch=1),
        SegmentInf(name="l4", length=4, frequency=0.3, Rmetal=60.0,
                   Cmetal=12e-15, wire_switch=0, opin_switch=0),
    ]
    return arch


def _unidir_mixed_arch():
    arch = unidir_arch(chan_width=8)
    arch.segments = [
        SegmentInf(name="l1", length=1, frequency=0.5, wire_switch=0,
                   opin_switch=1, directionality="unidir"),
        SegmentInf(name="l2", length=2, frequency=0.5, Rmetal=80.0,
                   Cmetal=15e-15, wire_switch=1, opin_switch=1,
                   directionality="unidir"),
    ]
    return arch


ARCHS = {"minimal": lambda: minimal_arch(chan_width=6),
         "mixed": _mixed_len_arch,
         "unidir": lambda: unidir_arch(chan_width=8),
         "unidir_mixed": _unidir_mixed_arch}


def to_port(pg):
    """The JAX package's PlanesGraph as the port's (via numpy)."""
    f = {k: np.asarray(getattr(pg, k)) for k in TP._PG_FIELDS}
    f.update(directional=pg.directional, max_span=pg.max_span,
             inc_track=(None if pg.inc_track is None
                        else np.asarray(pg.inc_track)))
    return TP.planes_graph_from_numpy(f, "cpu")


def _graph(arch_name, nx, ny):
    arch = ARCHS[arch_name]()
    rr = build_rr_graph(arch, DeviceGrid(nx, ny, arch.io_capacity))
    return rr, JP.build_planes(rr)


def _instance(rr, pg, B, seed, costs):
    rng = np.random.default_rng(seed)
    N = rr.num_nodes
    wires = np.where((rr.node_type == CHANX) | (rr.node_type == CHANY))[0]
    noc = np.asarray(pg.node_of_cell)
    seed_m = np.zeros((B, N), bool)
    for b in range(B):
        seed_m[b, rng.choice(wires, 2, replace=False)] = True
    if costs == "exact":
        cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
    else:
        cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(np.float32)
    crit = (rng.uniform(0.0, 0.9, (B, 1, 1, 1)) if costs == "crit"
            else np.zeros((B, 1, 1, 1))).astype(np.float32)
    d0 = np.where(seed_m[:, noc], 0.0, np.inf).astype(np.float32)
    w0 = (rng.uniform(0, 1e-10, (B, pg.ncells)) * (d0 == 0)
          ).astype(np.float32)
    return (np.ascontiguousarray(d0), np.ascontiguousarray(cong[:, noc]),
            crit, w0)


def _compare(jres, tres, costs):
    jd, jp, jw, js = (np.asarray(a) for a in jres)
    td, tpr, tw, ts = (a.numpy() for a in tres)
    if costs == "crit":
        assert np.array_equal(np.isfinite(jd), np.isfinite(td))
        fin = np.isfinite(jd)
        np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5)
        return
    assert np.array_equal(jd, td)
    assert np.array_equal(jp, tpr)
    assert np.array_equal(jw, tw)
    assert np.array_equal(js, ts)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 13, 16, 26])
@pytest.mark.parametrize("reverse", [False, True])
def test_minplus_scan_bit_identical(n, reverse):
    rng = np.random.default_rng(n + 100 * reverse)
    d0 = np.where(rng.random((3, 4, n, 5)) < 0.3,
                  rng.uniform(0, 1e-9, (3, 4, n, 5)), np.inf
                  ).astype(np.float32)
    c = (rng.uniform(0.5, 2.0, (3, 4, n, 5)) * 1e-10).astype(np.float32)
    c[rng.random(c.shape) < 0.2] = 0.0
    c[rng.random(c.shape) < 0.05] = np.inf
    want = np.asarray(JP._minplus_scan(jnp.asarray(d0), jnp.asarray(c), 2,
                                       reverse))
    got = TP._minplus_scan(torch.from_numpy(d0), torch.from_numpy(c), 2,
                           reverse).numpy()
    assert np.array_equal(want, got)


# the instance grid of tests/test_planes.py (planes_relax_matches_ell)
# plus the unidir archs of its cropped test
RELAX_GRID = [("minimal", 4, 4, 0), ("mixed", 7, 7, 7), ("mixed", 5, 9, 11),
              ("unidir", 5, 6, 5), ("unidir_mixed", 6, 5, 3)]


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch,nx,ny,seed", RELAX_GRID)
def test_planes_relax_matches_jax(arch, nx, ny, seed, costs):
    rr, pg = _graph(arch, nx, ny)
    d0, cc, crit, w0 = _instance(rr, pg, 4, seed, costs)
    jres = JP.planes_relax(pg, jnp.asarray(d0), jnp.asarray(cc),
                           jnp.asarray(crit), jnp.asarray(w0), 64)
    tres = TP.planes_relax(to_port(pg), torch.from_numpy(d0),
                           torch.from_numpy(cc), torch.from_numpy(crit),
                           torch.from_numpy(w0), 64)
    _compare(jres, tres, costs)


def test_planes_relax_ceiling_counts():
    """A sweep ceiling below the fixpoint: every executed sweep counts as
    useful, and the truncated state still matches bit for bit."""
    rr, pg = _graph("mixed", 7, 7)
    d0, cc, crit, w0 = _instance(rr, pg, 4, 1, "jitter")
    jres = JP.planes_relax(pg, jnp.asarray(d0), jnp.asarray(cc),
                           jnp.asarray(crit), jnp.asarray(w0), 2)
    tres = TP.planes_relax(to_port(pg), torch.from_numpy(d0),
                           torch.from_numpy(cc), torch.from_numpy(crit),
                           torch.from_numpy(w0), 2)
    assert tres[3].tolist() == [2, 2]
    _compare(jres, tres, "jitter")


def _crop_instance(arch, seed, costs, B=4):
    """tests/test_planes.py's cropped instance: per-net 3x3 bbs on a 14x12
    grid, seeds inside, tiles bucketed to one (cnx, cny)."""
    rr, pg = _graph(arch, 14, 12)
    W, NX, NYp1 = pg.shape_x
    _, NXp1, NY = pg.shape_y
    ncx = W * NX * NYp1
    N = rr.num_nodes
    rng = np.random.default_rng(seed)
    inside = np.zeros((B, N), bool)
    for b in range(B):
        x0 = int(rng.integers(1, NX - 2))
        y0 = int(rng.integers(1, NY - 2))
        x1, y1 = min(NX, x0 + 3), min(NY, y0 + 3)
        inside[b] = ((rr.xhigh >= x0) & (rr.xlow <= x1)
                     & (rr.yhigh >= y0) & (rr.ylow <= y1)
                     & ((rr.node_type == CHANX) | (rr.node_type == CHANY)))
    if costs == "exact":
        cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
    else:
        cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(np.float32)
    crit = (rng.uniform(0.0, 0.9, (B, 1, 1, 1)) if costs == "crit"
            else np.zeros((B, 1, 1, 1))).astype(np.float32)
    cong_m = np.where(inside, cong, np.inf).astype(np.float32)
    noc = np.asarray(pg.node_of_cell)
    cc = np.ascontiguousarray(cong_m[:, noc])
    d0 = np.full((B, pg.ncells), np.inf, np.float32)
    for b in range(B):
        fin = np.where(np.isfinite(cc[b]))[0]
        d0[b, rng.choice(fin, 2, replace=False)] = 0.0
    finx = np.isfinite(cc[:, :ncx]).reshape(B, W, NX, NYp1)
    finy = np.isfinite(cc[:, ncx:]).reshape(B, W, NXp1, NY)
    ox = np.zeros(B, np.int32)
    oy = np.zeros(B, np.int32)
    need_x = need_y = 1
    for b in range(B):
        ax = np.where(finx[b].any(axis=(0, 2)))[0]
        ay = np.where(finx[b].any(axis=(0, 1)))[0]
        bx = np.where(finy[b].any(axis=(0, 2)))[0]
        by = np.where(finy[b].any(axis=(0, 1)))[0]
        o_x = min(ax.min(initial=NX), bx.min(initial=NX))
        o_y = min(ay.min(initial=NYp1), by.min(initial=NY))
        ox[b], oy[b] = o_x, o_y
        need_x = max(need_x, ax.max(initial=0) - o_x + 1,
                     bx.max(initial=0) - o_x)
        need_y = max(need_y, ay.max(initial=0) - o_y,
                     by.max(initial=0) - o_y + 1)
    cnx = min(NX, int(need_x) + 1)
    cny = min(NY, int(need_y) + 1)
    # one origin past the grid edge: the clamp (lax.dynamic_slice's) must
    # agree
    ox[0] = NX
    w0 = np.zeros((B, pg.ncells), np.float32)
    return rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch,seed", [("mixed", 3), ("unidir_mixed", 5),
                                       ("minimal", 2)])
def test_planes_relax_cropped_matches_jax(arch, seed, costs):
    rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny = _crop_instance(
        arch, seed, costs)
    jres = JP.planes_relax_cropped(
        pg, jnp.asarray(d0), jnp.asarray(cc), jnp.asarray(crit),
        jnp.asarray(w0), 64, jnp.asarray(ox), jnp.asarray(oy), cnx, cny)
    tres = TP.planes_relax_cropped(
        to_port(pg), torch.from_numpy(d0), torch.from_numpy(cc),
        torch.from_numpy(crit), torch.from_numpy(w0), 64,
        torch.from_numpy(ox), torch.from_numpy(oy), cnx, cny)
    _compare(jres, tres, costs)


def _tile_ids(pg, x0, y0, cnx, cny):
    """K2's rule for the global flat ids and corner parity of each net's
    tile cells, from its clamped origin (x0, y0) [B], as the kernel
    computes them: (t*NX + x0+x)*(NY+1) + y0+y on chanx, ncx +
    (t*(NX+1) + x0+x)*NY + y0+y on chany, (x0+x + y0+y) & 1 at the
    corners.  Returns idxx [B, W, cnx, cny+1], idxy [B, W, cnx+1, cny],
    par [B, cnx+1, cny+1] (int32)."""
    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    x0, y0 = x0[:, None, None, None], y0[:, None, None, None]
    ar = torch.arange
    t = ar(W)[None, :, None, None]
    idxx = (t * NX + x0 + ar(cnx)[:, None]) * NYp1 + y0 + ar(cny + 1)
    idxy = (W * NX * NYp1 + (t * (NX + 1) + x0 + ar(cnx + 1)[:, None]) * NY
            + y0 + ar(cny))
    par = (x0[:, 0] + ar(cnx + 1)[:, None] + y0[:, 0] + ar(cny + 1)) & 1
    return (idxx.to(torch.int32), idxy.to(torch.int32),
            par.to(torch.int32))


@pytest.mark.parametrize("tile", [(3, 3), (5, 2), (2, 6), None])
@pytest.mark.parametrize("arch", ["mixed", "unidir_mixed"])
def test_crop_origin_rule_matches_crop_index(arch, tile):
    """K2's addressing rule: one origin per net, clamped into [0,
    crop_origin_hi], cuts every state plane and geometry array where
    _crop_index and the JAX package's lax.dynamic_slice cut it, for
    origins below 0 and past the grid (tile None: the whole grid); the
    ids and parity computed from that origin (_tile_ids) equal
    geom_cropped's idxx / idxy / base_par, the port's and JAX's.  The JAX
    package's lax.dynamic_slice first wraps a negative start by the
    array's extent (ROADMAP C: never reached, the window program clamps
    the origins to >= 0 first), so JAX is held to the rule on the
    origins >= 0 and the port's _crop_index on all of them."""
    rr, pg = _graph(arch, 14, 12)
    tpg = to_port(pg)
    W, NX, NYp1 = tpg.shape_x
    NY = NYp1 - 1
    cnx, cny = tile if tile is not None else (NX, NY)
    ox = np.array([-5, -1, 0, 1, NX - cnx, NX - cnx + 1, NX, NX + 7],
                  np.int32)
    oy = np.array([NY + 3, 0, -2, NY - cny, 1, NY, -9, NY - cny + 1],
                  np.int32)
    B = len(ox)
    tox, toy = torch.from_numpy(ox), torch.from_numpy(oy)
    hx, hy = TP.crop_origin_hi(tpg, cnx, cny)
    x0, y0 = tox.long().clamp(0, hx), toy.long().clamp(0, hy)
    # each array's (x, y) extent; its tile is (cnx, cny) plus what its
    # extent has beyond (NX, NY)
    extents = {k: tuple(getattr(tpg, k).shape[1:]) for k in TP._GEOM_ARRAYS}
    extents.update(state_x=(NX, NYp1), state_y=(NX + 1, NY),
                   base_par=(NX + 1, NYp1))
    nonneg = (ox >= 0) & (oy >= 0)
    jgm = JP.geom_cropped(pg, jnp.asarray(ox[nonneg]),
                          jnp.asarray(oy[nonneg]), cnx, cny)
    for name, (ex, ey) in extents.items():
        sx, sy = cnx + ex - NX, cny + ey - NY
        xi = x0[:, None] + torch.arange(sx)
        yi = y0[:, None] + torch.arange(sy)
        assert torch.equal(TP._crop_index(tox, sx, ex), xi), name
        assert torch.equal(TP._crop_index(toy, sy, ey), yi), name
        if name in TP._GEOM_ARRAYS:
            full = np.asarray(getattr(pg, name))
            want = np.stack([full[:, xi[b].numpy()][:, :, yi[b].numpy()]
                             for b in np.where(nonneg)[0]])
            assert np.array_equal(np.asarray(getattr(jgm, name)), want), name
    # the state planes as the JAX package crops them
    flat = np.arange(B * tpg.ncells, dtype=np.float32).reshape(B, -1)
    _, tiles = JP.crop_state(pg, *(jnp.asarray(flat[nonneg]),) * 3,
                             jnp.asarray(ox[nonneg]),
                             jnp.asarray(oy[nonneg]), cnx, cny)
    fx, fy = TP._split_flat(tpg, torch.from_numpy(flat))
    for tile_j, full, (sx, sy) in ((tiles[0], fx, (cnx, cny + 1)),
                                   (tiles[1], fy, (cnx + 1, cny))):
        want = torch.stack([
            full[b][:, x0[b] + torch.arange(sx)][:, :, y0[b]
                                                 + torch.arange(sy)]
            for b in np.where(nonneg)[0]])
        assert np.array_equal(np.asarray(tile_j), want.numpy())
    idxx, idxy, par = _tile_ids(tpg, x0, y0, cnx, cny)
    tgm = TP.geom_cropped(tpg, tox, toy, cnx, cny)
    assert torch.equal(idxx, tgm.idxx) and torch.equal(idxy, tgm.idxy)
    assert torch.equal(par, tgm.base_par)
    assert np.array_equal(idxx[nonneg].numpy(), np.asarray(jgm.idxx))
    assert np.array_equal(idxy[nonneg].numpy(), np.asarray(jgm.idxy))
    assert np.array_equal(par[nonneg].numpy(), np.asarray(jgm.base_par))


@pytest.mark.parametrize("pad_y", [0, 3])
def test_fold_unfold_match_jax(pad_y):
    a = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    want = np.asarray(JP.fold_canvas(jnp.asarray(a), pad_y))
    got = TP.fold_canvas(torch.from_numpy(a), pad_y)
    assert np.array_equal(want, got.numpy())
    back = TP.unfold_canvas(got, a.shape[1:], pad_y).numpy()
    assert np.array_equal(back, a)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise (they never fall back);
    the public planes_relax takes the plain version for CPU tensors."""
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    rr, pg = _graph("minimal", 4, 4)
    d0, cc, crit, w0 = (torch.from_numpy(a) for a in
                        _instance(rr, pg, 2, 0, "exact"))
    tpg = to_port(pg)
    with pytest.raises(ValueError):
        pk.planes_relax_full_cuda(tpg, d0, cc, crit, w0, 8)
    with pytest.raises(ValueError):
        pk.planes_relax_cropped_cuda(tpg, d0, cc, crit, w0, 8,
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32),
                                     2, 2)
    with pytest.raises(ValueError):
        pk.planes_relax_cluster_cuda(tpg, d0, cc, crit, w0, 8, 2)
    assert pk.launch_counts() == {"planes_relax_full_cuda": 0,
                                  "planes_relax_cropped_cuda": 0,
                                  "planes_sweep_block_cuda": 0,
                                  "planes_relax_cluster_cuda": 0}


@pytest.mark.parametrize("wide,tall", [(1, 0), (0, 1), (1, 1), (-1, 0),
                                       (0, -1)])
def test_cropped_cuda_refuses_tiles_past_the_grid(wide, tall):
    """K2's wrapper refuses a tile wider or taller than the grid (its
    clamp range would go below 0) or empty, before it looks at the
    tensors."""
    from parallel_eda_tpu_torch.route import planes_kernels as pk

    rr, pg = _graph("minimal", 4, 4)
    d0, cc, crit, w0 = (torch.from_numpy(a) for a in
                        _instance(rr, pg, 2, 0, "exact"))
    tpg = to_port(pg)
    _, NX, NYp1 = tpg.shape_x
    pick = {1: lambda n: n + 1, 0: lambda n: n, -1: lambda n: 0}
    cnx, cny = pick[wide](NX), pick[tall](NYp1 - 1)
    z = torch.zeros(2, dtype=torch.int32)
    n0 = pk.planes_relax_cropped_cuda.launches
    with pytest.raises(ValueError, match="must lie inside"):
        pk.planes_relax_cropped_cuda(tpg, d0, cc, crit, w0, 8, z, z,
                                     cnx, cny)
    assert pk.planes_relax_cropped_cuda.launches == n0


@pytest.mark.slow
def test_planes_relax_matches_pallas_interpret():
    """The plain port against the JAX package's Pallas kernels, run in
    interpret mode (as that package's own tests run them on the CPU)."""
    from parallel_eda_tpu.route.planes_pallas import (
        planes_relax_cropped_pallas, planes_relax_pallas)

    rr, pg = _graph("mixed", 5, 9)
    d0, cc, crit, w0 = _instance(rr, pg, 4, 11, "jitter")
    jres = planes_relax_pallas(pg, jnp.asarray(d0), jnp.asarray(cc),
                               jnp.asarray(crit), jnp.asarray(w0), 64,
                               interpret=True)
    tres = TP.planes_relax(to_port(pg), torch.from_numpy(d0),
                           torch.from_numpy(cc), torch.from_numpy(crit),
                           torch.from_numpy(w0), 64)
    _compare(jres, tres, "jitter")
    rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny = _crop_instance(
        "mixed", 3, "jitter")
    jres = planes_relax_cropped_pallas(
        pg, jnp.asarray(d0), jnp.asarray(cc), jnp.asarray(crit),
        jnp.asarray(w0), 64, jnp.asarray(ox), jnp.asarray(oy), cnx, cny,
        interpret=True)
    tres = TP.planes_relax_cropped(
        to_port(pg), torch.from_numpy(d0), torch.from_numpy(cc),
        torch.from_numpy(crit), torch.from_numpy(w0), 64,
        torch.from_numpy(ox), torch.from_numpy(oy), cnx, cny)
    _compare(jres, tres, "jitter")
