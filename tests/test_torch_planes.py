"""The port's plain planes relaxation against the JAX package's.

Same inputs, made from a seed with numpy, go through the JAX function
and its PyTorch counterpart (on the CPU, the plain version).  The
results must be BIT-identical — dist, pred, wenter and the [executed,
useful] sweep counts — on exact (power-of-two), jittered (uniform) and
crit > 0 costs: the port's min-plus scan reproduces
lax.associative_scan's combine tree.  At crit > 0 the reference is the
JAX package run under ``XLA_FLAGS=--xla_cpu_max_isa=AVX``: with its
default flags XLA:CPU contracts ``crit*delay + cost`` into a fused
multiply-add, which the port (and its ``-fmad=false`` kernels) rounds
twice.  The flag must be set before JAX starts and this process has
started it, so a module fixture runs this file as a script in a
subprocess (``python tests/test_torch_planes.py out.npz f32``), which
writes the JAX results of every crit > 0 case (full canvas, cropped,
row-sharded) to an .npz (tests/test_torch_timing.py does the same)."""

import os
import subprocess
import sys

import jax
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _compare(jres, tres):
    """Bit-identity of (dist, pred, wenter, stats)."""
    for k, (a, b) in enumerate(zip(jres, tres)):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.dtype == b.dtype, k
        assert np.array_equal(a, b, equal_nan=True), k


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 13, 16, 26, 63, 64, 65,
                               100, 128, 129, 256, 257, 300])
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
# the cropped instances (_crop_instance: arch, seed)
CROP_CASES = [("mixed", 3), ("unidir_mixed", 5), ("minimal", 2)]
# the row-sharded instances at crit > 0: arch -> (nx, ny, seed), and the
# (arch, shards, schedule) cases run on them (each JAX reference is a
# ~10 s compile)
SHARD_GRAPHS = {"minimal": (6, 5, 21), "unidir": (7, 5, 22)}
SHARD_CRIT = [("minimal", 2, "ppermute"), ("unidir", 3, "pallas_halo"),
              ("minimal", 4, "ppermute")]


def _grid_key(arch, nx, ny, seed):
    return f"{arch}-{nx}-{ny}-{seed}"


def _np(a):
    return tuple(np.asarray(x) for x in a)


def _jitted(fn, *arrays):
    """``fn(*arrays)`` through jax.jit, its array arguments traced: one
    compile of the whole relaxation instead of the eager path's per-op
    work (the same XLA operations)."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def _jax_crit_results(plane_dtype, shard_cases=None):
    """The JAX package's results of every crit > 0 case (the sharded ones
    of ``shard_cases``, default SHARD_CRIT): key -> (dist, pred, wenter,
    stats) as numpy arrays.  Run under the reference flags
    (avx_reference)."""
    from parallel_eda_tpu.route import planes_shard as JS

    out = {}
    for arch, nx, ny, seed in RELAX_GRID:
        rr, pg = _graph(arch, nx, ny)
        args = _instance(rr, pg, 4, seed, "crit")
        out["full/" + _grid_key(arch, nx, ny, seed)] = _np(_jitted(
            lambda *a: JP.planes_relax(pg, *a, 64, plane_dtype=plane_dtype),
            *args))
    for arch, seed in CROP_CASES:
        rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny = _crop_instance(
            arch, seed, "crit")
        out[f"crop/{arch}-{seed}"] = _np(_cropped_jax(
            pg, (d0, cc, crit, w0, ox, oy, cnx, cny), plane_dtype))
    for arch, s, impl in (SHARD_CRIT if shard_cases is None
                          else shard_cases):
        nx, ny, seed = SHARD_GRAPHS[arch]
        rr, pg = _graph(arch, nx, ny)
        args = _instance(rr, pg, 4, seed, "crit")
        mesh = JS.make_row_mesh(s, impl)
        out[f"shard/{arch}-{s}-{impl}"] = _np(_jitted(
            lambda *a: JS.planes_relax_sharded(pg, *a, 24, mesh,
                                               plane_dtype=plane_dtype),
            *args))
    return out


def write_crit_reference(path, plane_dtypes, extra=None, shard_cases=None):
    """The JAX results of every crit > 0 case in each plane dtype of
    ``plane_dtypes``, into the .npz ``path`` (keys
    "<dtype>/<case>/<output index>"); ``extra`` (a dict of arrays)
    joins them.  Run under the reference flags."""
    out = dict(extra or {})
    for dt in plane_dtypes:
        for key, res in _jax_crit_results(dt, shard_cases).items():
            for k, a in enumerate(res):
                out[f"{dt}/{key}/{k}"] = a
    np.savez(path, **out)


def avx_reference(path, script, args, timeout=600):
    """Run test file ``script`` as a script with ``args`` in a
    subprocess under the reference flags (XLA:CPU limited to AVX, the
    8 virtual CPU devices) and load the .npz it writes to ``path``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, os.path.abspath(script),
                          str(path), *args], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def crit_results(ref, plane_dtype, key):
    """The reference's (dist, pred, wenter, stats) of one case."""
    return tuple(ref[f"{plane_dtype}/{key}/{k}"] for k in range(4))


@pytest.fixture(scope="module")
def crit_ref(tmp_path_factory):
    return avx_reference(tmp_path_factory.mktemp("jax_ref") / "crit.npz",
                         __file__, ["f32"])


def _relax_port(arch, nx, ny, seed, costs, nsweeps=64, plane_dtype="f32"):
    rr, pg = _graph(arch, nx, ny)
    args = _instance(rr, pg, 4, seed, costs)
    return pg, args, TP.planes_relax(
        to_port(pg), *(torch.from_numpy(a) for a in args), nsweeps,
        plane_dtype)


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch,nx,ny,seed", RELAX_GRID)
def test_planes_relax_matches_jax(crit_ref, arch, nx, ny, seed, costs):
    pg, args, tres = _relax_port(arch, nx, ny, seed, costs)
    if costs == "crit":
        jres = crit_results(crit_ref, "f32",
                            "full/" + _grid_key(arch, nx, ny, seed))
    else:
        jres = _jitted(lambda *a: JP.planes_relax(pg, *a, 64), *args)
    _compare(jres, tres)


def test_planes_relax_ceiling_counts():
    """A sweep ceiling below the fixpoint: every executed sweep counts as
    useful, and the truncated state still matches bit for bit."""
    pg, args, tres = _relax_port("mixed", 7, 7, 1, "jitter", nsweeps=2)
    jres = _jitted(lambda *a: JP.planes_relax(pg, *a, 2), *args)
    assert tres[3].tolist() == [2, 2]
    _compare(jres, tres)


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


def _cropped_port(arch, seed, costs, plane_dtype="f32"):
    rr, pg, d0, cc, crit, w0, ox, oy, cnx, cny = _crop_instance(
        arch, seed, costs)
    args = (d0, cc, crit, w0, ox, oy, cnx, cny)
    return pg, args, TP.planes_relax_cropped(
        to_port(pg), torch.from_numpy(d0), torch.from_numpy(cc),
        torch.from_numpy(crit), torch.from_numpy(w0), 64,
        torch.from_numpy(ox), torch.from_numpy(oy), cnx, cny, plane_dtype)


def _cropped_jax(pg, args, plane_dtype="f32"):
    d0, cc, crit, w0, ox, oy, cnx, cny = args
    return _jitted(lambda d, c, k, w, x, y: JP.planes_relax_cropped(
        pg, d, c, k, w, 64, x, y, cnx, cny, plane_dtype=plane_dtype),
        d0, cc, crit, w0, ox, oy)


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch,seed", CROP_CASES)
def test_planes_relax_cropped_matches_jax(crit_ref, arch, seed, costs):
    pg, args, tres = _cropped_port(arch, seed, costs)
    if costs == "crit":
        jres = crit_results(crit_ref, "f32", f"crop/{arch}-{seed}")
    else:
        jres = _cropped_jax(pg, args)
    _compare(jres, tres)


def sharded_crit_port(arch, s, impl, plane_dtype="f32"):
    """The port's plain sharded relaxation of the SHARD_CRIT instance."""
    from parallel_eda_tpu_torch.route import planes_shard as TS

    nx, ny, seed = SHARD_GRAPHS[arch]
    rr, pg = _graph(arch, nx, ny)
    args = _instance(rr, pg, 4, seed, "crit")
    return TS.planes_relax_sharded(
        to_port(pg), *(torch.from_numpy(a) for a in args), 24,
        TS.make_row_mesh(s, impl, "cpu"), plane_dtype)


@pytest.mark.parametrize("arch,s,impl", SHARD_CRIT)
def test_planes_relax_sharded_crit_matches_jax(crit_ref, arch, s, impl):
    """The row-sharded relaxation at crit > 0 (both schedules, 2-4
    shards) against the JAX package's planes_relax_sharded on its
    virtual CPU mesh: every output and the sweep counts
    bit-identical."""
    got = sharded_crit_port(arch, s, impl)
    _compare(crit_results(crit_ref, "f32", f"shard/{arch}-{s}-{impl}"), got)
    assert (got[1] >= 0).all() and got[3][1] > 0


@pytest.mark.parametrize("ox", [-1, -5])
def test_cropped_negative_origin_matches_jax(ox):
    """A negative tile origin wraps once by each array's extent before
    the clamp, as lax.dynamic_slice does: at -1 the chanx and chany
    planes land on one origin, at -5 (below -cnx) one apart.  The
    14x12 mixed grid, 3x3 tiles, against JAX planes_relax_cropped."""
    rr, pg, d0, cc, crit, w0, _, oy, _, _ = _crop_instance("mixed", 3,
                                                           "jitter")
    oxs = np.full(len(oy), ox, np.int32)
    args = (d0, cc, crit, w0, oxs, oy, 3, 3)
    tres = TP.planes_relax_cropped(
        to_port(pg), *(torch.from_numpy(a) for a in args[:4]), 64,
        torch.from_numpy(oxs), torch.from_numpy(oy), 3, 3)
    _compare(_cropped_jax(pg, args), tres)


def _place(o, extent: int, hi: int):
    """K2's origin rule (csrc/planes_relax.cu place_origin): a negative
    origin wraps once by the array's extent, then clamps into [0, hi]."""
    o = o.long()
    return torch.where(o < 0, o + extent, o).clamp(0, hi)


def _tile_ids(pg, ox, oy, cnx, cny):
    """K2's rule for the global flat ids and corner parity of each net's
    tile cells, from its origins ox, oy [B], as the kernel computes
    them: the chanx planes at (x0, y0) = the origins placed on extents
    (NX, NY+1), the chany planes at (x1, y1) placed on (NX+1, NY), the
    corner parity at (x1, y0); ids (t*NX + x0+x)*(NY+1) + y0+y on chanx,
    ncx + (t*(NX+1) + x1+x)*NY + y1+y on chany, (x1+x + y0+y) & 1 at the
    corners.  Returns idxx [B, W, cnx, cny+1], idxy [B, W, cnx+1, cny],
    par [B, cnx+1, cny+1] (int32)."""
    W, NX, NYp1 = pg.shape_x
    NY = NYp1 - 1
    hx, hy = TP.crop_origin_hi(pg, cnx, cny)

    def col(a):
        return a[:, None, None, None]
    x0, x1 = col(_place(ox, NX, hx)), col(_place(ox, NX + 1, hx))
    y0, y1 = col(_place(oy, NYp1, hy)), col(_place(oy, NY, hy))
    ar = torch.arange
    t = ar(W)[None, :, None, None]
    idxx = (t * NX + x0 + ar(cnx)[:, None]) * NYp1 + y0 + ar(cny + 1)
    idxy = (W * NX * NYp1 + (t * (NX + 1) + x1 + ar(cnx + 1)[:, None]) * NY
            + y1 + ar(cny))
    par = (x1[:, 0] + ar(cnx + 1)[:, None] + y0[:, 0] + ar(cny + 1)) & 1
    return (idxx.to(torch.int32), idxy.to(torch.int32),
            par.to(torch.int32))


@pytest.mark.parametrize("tile", [(3, 3), (5, 2), (2, 6), None])
@pytest.mark.parametrize("arch", ["mixed", "unidir_mixed"])
def test_crop_origin_rule_matches_crop_index(arch, tile):
    """K2's addressing rule: each net's origins, placed per array as
    lax.dynamic_slice places a start (a negative origin wraps once by
    the array's extent, then clamps into [0, crop_origin_hi]), cut every
    state plane and geometry array where _crop_index and the JAX
    package's lax.dynamic_slice cut it, for origins below 0 (above and
    below minus the tile) and past the grid (tile None: the whole
    grid); the ids and parity computed from those origins (_tile_ids)
    equal geom_cropped's idxx / idxy / base_par, the port's and JAX's."""
    rr, pg = _graph(arch, 14, 12)
    tpg = to_port(pg)
    W, NX, NYp1 = tpg.shape_x
    NY = NYp1 - 1
    cnx, cny = tile if tile is not None else (NX, NY)
    ox = np.array([-5, -1, 0, 1, NX - cnx, NX - cnx + 1, NX, NX + 7, -NX - 2,
                   -cnx - 1], np.int32)
    oy = np.array([NY + 3, 0, -2, NY - cny, 1, NY, -9, NY - cny + 1, -1,
                   -cny - 1], np.int32)
    B = len(ox)
    tox, toy = torch.from_numpy(ox), torch.from_numpy(oy)
    hx, hy = TP.crop_origin_hi(tpg, cnx, cny)
    # each array's (x, y) extent; its tile is (cnx, cny) plus what its
    # extent has beyond (NX, NY)
    extents = {k: tuple(getattr(tpg, k).shape[1:]) for k in TP._GEOM_ARRAYS}
    extents.update(state_x=(NX, NYp1), state_y=(NX + 1, NY),
                   base_par=(NX + 1, NYp1))
    jgm = JP.geom_cropped(pg, jnp.asarray(ox), jnp.asarray(oy), cnx, cny)
    rows = {}
    for name, (ex, ey) in extents.items():
        sx, sy = cnx + ex - NX, cny + ey - NY
        xi = _place(tox, ex, hx)[:, None] + torch.arange(sx)
        yi = _place(toy, ey, hy)[:, None] + torch.arange(sy)
        rows[name] = xi, yi
        assert torch.equal(TP._crop_index(tox, sx, ex), xi), name
        assert torch.equal(TP._crop_index(toy, sy, ey), yi), name
        if name in TP._GEOM_ARRAYS:
            full = np.asarray(getattr(pg, name))
            want = np.stack([full[:, xi[b].numpy()][:, :, yi[b].numpy()]
                             for b in range(B)])
            assert np.array_equal(np.asarray(getattr(jgm, name)), want), name
    # origins below minus the tile put the two plane families one apart
    if tile is not None:
        assert not torch.equal(rows["state_x"][0][:, 0],
                               rows["state_y"][0][:, 0])
    # the state planes as the JAX package crops them
    flat = np.arange(B * tpg.ncells, dtype=np.float32).reshape(B, -1)
    _, tiles = JP.crop_state(pg, *(jnp.asarray(flat),) * 3,
                             jnp.asarray(ox), jnp.asarray(oy), cnx, cny)
    fx, fy = TP._split_flat(tpg, torch.from_numpy(flat))
    for tile_j, full, name in ((tiles[0], fx, "state_x"),
                               (tiles[1], fy, "state_y")):
        xi, yi = rows[name]
        want = torch.stack([full[b][:, xi[b]][:, :, yi[b]]
                            for b in range(B)])
        assert np.array_equal(np.asarray(tile_j), want.numpy())
    idxx, idxy, par = _tile_ids(tpg, tox, toy, cnx, cny)
    tgm = TP.geom_cropped(tpg, tox, toy, cnx, cny)
    assert torch.equal(idxx, tgm.idxx) and torch.equal(idxy, tgm.idxy)
    assert torch.equal(par, tgm.base_par)
    assert np.array_equal(idxx.numpy(), np.asarray(jgm.idxx))
    assert np.array_equal(idxy.numpy(), np.asarray(jgm.idxy))
    assert np.array_equal(par.numpy(), np.asarray(jgm.base_par))


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
    with pytest.raises(ValueError):
        pk.planes_relax_full_cuda(tpg, d0, cc, crit, w0, 8,
                                  plane_dtype="bf16")
    with pytest.raises(ValueError):
        pk.planes_relax_node_cuda(tpg, d0, cc, crit, w0, 8, ["cpu"] * 2)
    names = ("planes_relax_full_cuda", "planes_relax_cropped_cuda",
             "planes_relax_cluster_cuda", "planes_relax_peer_cuda",
             "planes_relax_node_cuda")
    assert pk.launch_counts() == {
        n + m: 0 for n in names for m in ("", "[bf16]")}


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
    _compare(jres, tres)
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
    _compare(jres, tres)


if __name__ == "__main__":
    write_crit_reference(sys.argv[1], sys.argv[2:])
