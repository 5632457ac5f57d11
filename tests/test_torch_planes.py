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
    assert pk.launch_counts() == {"planes_relax_full_cuda": 0,
                                  "planes_relax_cropped_cuda": 0,
                                  "planes_sweep_block_cuda": 0}


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
