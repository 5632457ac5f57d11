"""The port's row-sharded relaxation (parallel_eda_tpu_torch/route/
planes_shard.py, shard_kernels.py) against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the conftest's 8 virtual CPU devices.  Every
comparison is exact:

* block geometry, halo byte model and the transport's plain version
  equal JAX's field by field / its non-wrapping ``lax.ppermute``;
* the port's sharded relaxation on the CPU (shards on repeated ``cpu``
  devices) against JAX's single-device ``planes_relax`` on power-of-two
  costs: dist and wenter bit-identical, finite masks equal (pred only up
  to equal-cost ties, as tests/test_planes_shard.py states), and
  against JAX's own ``planes_relax_sharded``: every output and the
  sweep counts equal;
* the sharded Router on the 15-LUT fixture against the JAX Router's
  single-device route: paths, occupancy, wirelength, iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from parallel_eda_tpu.arch.builtin import minimal_arch, unidir_arch
from parallel_eda_tpu.flow import synth_flow as jax_synth_flow
from parallel_eda_tpu.obs import MetricsRegistry, get_metrics, set_metrics
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu.route import planes as JP
from parallel_eda_tpu.route import planes_shard as JS
from parallel_eda_tpu.rr.graph import CHANX, CHANY, build_rr_graph
from parallel_eda_tpu.rr.grid import DeviceGrid
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.route import planes as TP
from parallel_eda_tpu_torch.route import planes_kernels as pk
from parallel_eda_tpu_torch.route import planes_shard as TS
from parallel_eda_tpu_torch.route import shard_kernels as sk
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route
from test_torch_planes import to_port
from test_torch_route import FIXTURE, _assert_same_route

ARCHS = {"minimal": (lambda: minimal_arch(chan_width=6), 6, 5, 4, 0),
         "unidir": (lambda: unidir_arch(chan_width=6, length=2), 7, 5, 3, 2)}
_CACHE = {}


def _instance(arch):
    """tests/test_planes_shard.py's instance: random wire seeds and
    power-of-two (f32-exact) congestion, crit 0; numpy arrays."""
    if arch not in _CACHE:
        mk, nx, ny, B, seed = ARCHS[arch]
        a = mk()
        rr = build_rr_graph(a, DeviceGrid(nx, ny, a.io_capacity))
        pg = JP.build_planes(rr)
        N = rr.num_nodes
        rng = np.random.default_rng(seed)
        wires = np.where((rr.node_type == CHANX)
                         | (rr.node_type == CHANY))[0]
        noc = np.asarray(pg.node_of_cell)
        seed_m = np.zeros((B, N), bool)
        for b in range(B):
            seed_m[b, rng.choice(wires, 2, replace=False)] = True
        cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
        d0 = np.where(seed_m[:, noc], 0.0, np.inf).astype(np.float32)
        args = (d0, np.ascontiguousarray(cong[:, noc]),
                np.zeros((B, 1, 1, 1), np.float32),
                np.zeros((B, pg.ncells), np.float32))
        ref = JP.planes_relax(pg, *(jnp.asarray(x) for x in args), 24)
        _CACHE[arch] = (pg, to_port(pg), args,
                        tuple(np.asarray(r) for r in ref))
    return _CACHE[arch]


def _port_relax(tpg, args, s, impl):
    out = TS.planes_relax_sharded(
        tpg, *(torch.from_numpy(x) for x in args), 24,
        TS.make_row_mesh(s, impl, "cpu"))
    return tuple(o.numpy() for o in out)


# ---- geometry and models ---------------------------------------------

@pytest.mark.parametrize("arch", ["minimal", "unidir"])
@pytest.mark.parametrize("s", [2, 3, 4, 5, 7])
def test_block_geometry_matches_jax(s, arch):
    pg, tpg, _, _ = _instance(arch)
    kx = JS.row_block_cols(pg, s)
    assert TS.row_block_cols(tpg, s) == kx
    for B in (1, 4, 64):
        assert TS.halo_bytes_per_sweep(tpg, B, s) == \
            JS.halo_bytes_per_sweep(pg, B, s)
    jg = JS._geom_blocks(pg, s, kx)
    tg = TS._geom_blocks(tpg, s, kx)
    for name in TP._GEOM_ARRAYS + ("idxx", "idxy", "base_par"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert (tg.stride_x, tg.directional) == (jg.stride_x, jg.directional)
    if jg.inc_track is None:
        assert tg.inc_track is None
    else:
        assert np.array_equal(np.asarray(jg.inc_track),
                              tg.inc_track.numpy())


def test_modeled_overlap_frac():
    pg, tpg, _, _ = _instance("minimal")
    assert TS.modeled_overlap_frac(tpg, 4, 4, "ppermute", True) == 0.0
    same = TS.modeled_overlap_frac(tpg, 4, 4, "pallas_halo", False)
    cross = TS.modeled_overlap_frac(tpg, 4, 4, "pallas_halo", True)
    assert 0.0 < cross <= same <= 1.0
    # the JAX formula with the H100's HBM3 : NVLink-one-way ratio in
    # place of its ICI:HBM 10
    W, NX, NYp1 = tpg.shape_x
    _, NXp1, NY = tpg.shape_y
    sweep = 4 * W * (NX * NYp1 + NXp1 * NY) * 4 / 4
    halo = TS.halo_bytes_per_sweep(tpg, 4, 4) / 3
    assert cross == round(min(1.0, sweep / (halo * 3.35e12 / 450e9)), 6)


def test_make_row_mesh_validation():
    with pytest.raises(ValueError, match=">= 2"):
        TS.make_row_mesh(1, devices="cpu")
    with pytest.raises(ValueError, match="impl"):
        TS.make_row_mesh(2, impl="bogus", devices="cpu")
    with pytest.raises(ValueError, match="repeat"):
        TS.make_row_mesh(3, devices=["cpu", "cpu"])
    m = TS.make_row_mesh(3, "pallas_halo", devices="cpu")
    assert m.devices == (torch.device("cpu"),) * 3
    assert (m.n_shards, m.n_cards, m.impl) == (3, 1, "pallas_halo")
    with pytest.raises(ValueError, match="at most"):
        TS.RowMesh((torch.device("cuda"),) * (sk.MAX_SHARDS + 1))
    with pytest.raises(ValueError, match=">= 2 shards"):
        TS.RowMesh((torch.device("cpu"),))
    with pytest.raises(ValueError, match="one type"):
        TS.RowMesh((torch.device("cpu"), torch.device("meta")))
    assert TS.MESH_IMPLS == JS.MESH_IMPLS
    assert TP._as_row_mesh(None) is None
    assert TP._as_row_mesh(m) is m
    with pytest.raises(TypeError):
        TP._as_row_mesh(object())


# ---- the halo transport ----------------------------------------------

def _jax_permute(x, s, fwd):
    mesh = Mesh(np.array(jax.devices()[:s]), ("row",))
    perm = ([(i, i + 1) for i in range(s - 1)] if fwd
            else [(i, i - 1) for i in range(1, s)])
    f = shard_map(lambda a: lax.ppermute(a, "row", perm), mesh=mesh,
                  in_specs=P("row"), out_specs=P("row"), check_rep=False)
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("cols", [1, 2])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_slab_permute_plain_matches_ppermute(s, fwd, cols):
    rng = np.random.default_rng(s * 10 + cols + fwd)
    x = rng.uniform(0, 1, (s, 3, 4, cols, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.inf
    want = _jax_permute(x, s, fwd)
    # the slabs as the extraction cuts them: strided column views
    canv = np.zeros((s, 3, 4, 6, 5), np.float32)
    canv[:, :, :, 2:2 + cols] = x
    slabs = [torch.from_numpy(canv[i])[:, :, 2:2 + cols] for i in range(s)]
    got = sk.remote_slab_permute(slabs, fwd)
    assert [tuple(g.shape) for g in got] == [x.shape[1:]] * s
    assert np.array_equal(want, np.stack([g.numpy() for g in got]))
    assert sk.slab_permute_plain(slabs, fwd)[0 if fwd else s - 1].eq(
        0).all()


def _jax_exchange(dxb, dyb, sxb, syb, s, kx):
    """The JAX package's extract + install (planes_shard.py:336-356) on
    the conftest's virtual CPU devices: the halo columns of the (dxb,
    dyb) blocks from the owned boundary columns of the (sxb, syb)
    blocks, INF at the edge shards."""
    mesh = Mesh(np.array(jax.devices()[:s]), (JS.ROW_AXIS,))
    fwd = [(i, i + 1) for i in range(s - 1)]
    bwd = [(i, i - 1) for i in range(1, s)]

    def body(dx, dy, sx, sy):
        dx, dy, sx, sy = dx[0], dy[0], sx[0], sy[0]
        ridx = lax.axis_index(JS.ROW_AXIS)

        def send(slab, to_right):
            return lax.ppermute(slab, JS.ROW_AXIS, fwd if to_right else bwd)

        lx, rx = send(sx[:, :, kx:kx + 1], True), send(sx[:, :, 1:2], False)
        ly, ry = send(sy[:, :, kx:kx + 1], True), send(sy[:, :, 1:3], False)
        dx = dx.at[:, :, 0:1].set(jnp.where(ridx == 0, JP.INF, lx))
        dx = dx.at[:, :, kx + 1:kx + 2].set(
            jnp.where(ridx == s - 1, JP.INF, rx))
        dy = dy.at[:, :, 0:1].set(jnp.where(ridx == 0, JP.INF, ly))
        dy = dy.at[:, :, kx + 1:kx + 3].set(
            jnp.where(ridx == s - 1, JP.INF, ry))
        return dx[None], dy[None]

    f = shard_map(body, mesh=mesh, in_specs=(P(JS.ROW_AXIS),) * 4,
                  out_specs=(P(JS.ROW_AXIS),) * 2, check_rep=False)
    return tuple(np.asarray(a) for a in f(*(jnp.asarray(x) for x in
                                            (dxb, dyb, sxb, syb))))


@pytest.mark.parametrize("lagged", [False, True])
@pytest.mark.parametrize("arch", ["minimal", "unidir"])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_halo_exchange_plain_matches_jax(s, arch, lagged):
    """The port's in-place exchange against the JAX package's extract +
    install: both halo directions (left dx/dy from the left neighbour,
    right dx/dy from the right one), edge INF, owned columns untouched;
    ``lagged`` reads the halos from another state set (lag 2)."""
    _, tpg, _, _ = _instance(arch)
    W, NX, NYp1 = tpg.shape_x
    kx = TS.row_block_cols(tpg, s)
    B = 3
    rng = np.random.default_rng(100 * s + 10 * lagged + len(arch))

    def canv(ext, ny):
        a = rng.uniform(0, 1, (s, B, W, kx + ext, ny)).astype(np.float32)
        a[rng.random(a.shape) < 0.2] = np.inf
        return a

    dxb, dyb = canv(2, NYp1), canv(3, NYp1 - 1)
    sxb, syb = (canv(2, NYp1), canv(3, NYp1 - 1)) if lagged else (dxb, dyb)
    want = _jax_exchange(dxb, dyb, sxb, syb, s, kx)
    states = [(torch.from_numpy(dxb[k].copy()), torch.from_numpy(dyb[k].copy()))
              for k in range(s)]
    src = ([(torch.from_numpy(sxb[k]), torch.from_numpy(syb[k]))
            for k in range(s)] if lagged else None)
    sk.halo_exchange(states, kx, src)
    for k in range(s):
        assert np.array_equal(states[k][0].numpy(), want[0][k])
        assert np.array_equal(states[k][1].numpy(), want[1][k])
    # the halo columns changed, the owned ones did not
    got_x = np.stack([st[0].numpy() for st in states])
    assert np.array_equal(got_x[:, :, :, 1:kx + 1], dxb[:, :, :, 1:kx + 1])
    assert np.isinf(got_x[0, :, :, 0]).all()
    assert np.array_equal(got_x[1, :, :, 0], sxb[0, :, :, kx])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The shard kernels' wrappers raise on CPU tensors (they never fall
    back to the plain version) and count nothing."""
    _, tpg, args, _ = _instance("minimal")
    sk.reset_launch_counts()
    slabs = [torch.zeros((2, 3, 1, 4)) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        sk.remote_slab_permute_cuda(slabs, True)
    with pytest.raises(ValueError):
        sk.remote_slab_permute_cuda(slabs[:1], True)
    with pytest.raises(ValueError, match="mixed"):
        sk.remote_slab_permute([slabs[0], slabs[1].to("meta")], True)
    kx = TS.row_block_cols(tpg, 2)
    m = TS.make_row_mesh(2, devices="cpu")
    g = TS._shard_geoms(tpg, m, kx)[0]
    B = args[0].shape[0]
    W, _, NYp1 = tpg.shape_x
    sx, sy = (B, W, kx + 2, NYp1), (B, W, kx + 3, NYp1 - 1)
    st = (torch.zeros(sx), torch.zeros(sy), torch.zeros(sx, dtype=torch.int32),
          torch.zeros(sy, dtype=torch.int32), torch.zeros(sx),
          torch.zeros(sy))
    n0 = pk.planes_sweep_block_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pk.planes_sweep_block_cuda(g, st, torch.zeros(B), st[0], st[1],
                                   (1, kx + 1))
    assert pk.planes_sweep_block_cuda.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        sk.halo_exchange_cuda([st, st], kx)
    with pytest.raises(ValueError, match="mixed"):
        sk.halo_exchange([st, tuple(t.to("meta") for t in st)], kx)
    assert sk.launch_counts() == {"halo_exchange_cuda": 0,
                                  "remote_slab_permute_cuda": 0}


# ---- the sharded relaxation ------------------------------------------

@pytest.mark.parametrize("arch", ["minimal", "unidir"])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_matches_jax_single_device(impl, s, arch):
    _, tpg, args, ref = _instance(arch)
    out = _port_relax(tpg, args, s, impl)
    assert np.array_equal(ref[0], out[0])          # dist
    assert np.array_equal(ref[2], out[2])          # wenter
    assert np.array_equal(np.isfinite(ref[0]), np.isfinite(out[0]))
    assert out[3][0] >= out[3][1] > 0


@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_matches_jax_sharded(impl):
    pg, tpg, args, _ = _instance("minimal")
    jout = JS.planes_relax_sharded(pg, *(jnp.asarray(x) for x in args), 24,
                                   JS.make_row_mesh(4, impl))
    out = _port_relax(tpg, args, 4, impl)
    for a, b in zip(jout, out):                    # dist pred wenter stats
        assert np.array_equal(np.asarray(a), b)


def _costs_instance(arch, costs, B=4):
    """The shard instance with power-of-two (exact) or uniform (jittered)
    congestion; numpy arrays."""
    key = (arch, costs, B)
    if key not in _CACHE:
        mk, nx, ny, _, seed = ARCHS[arch]
        a = mk()
        rr = build_rr_graph(a, DeviceGrid(nx, ny, a.io_capacity))
        pg = JP.build_planes(rr)
        N = rr.num_nodes
        rng = np.random.default_rng(seed + 17)
        wires = np.where((rr.node_type == CHANX)
                         | (rr.node_type == CHANY))[0]
        noc = np.asarray(pg.node_of_cell)
        seed_m = np.zeros((B, N), bool)
        for b in range(B):
            seed_m[b, rng.choice(wires, 1 + b % 3, replace=False)] = True
        if costs == "exact":
            cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
        else:
            cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(
                np.float32)
        d0 = np.where(seed_m[:, noc], 0.0, np.inf).astype(np.float32)
        # the last net is an empty slot (all-INF seeds, as the route
        # gives a clean net): it stops after its first sweep
        d0[-1] = np.inf
        args = (d0, np.ascontiguousarray(cong[:, noc]),
                np.zeros((B, 1, 1, 1), np.float32),
                np.zeros((B, pg.ncells), np.float32))
        _CACHE[key] = (pg, to_port(pg), args)
    return _CACHE[key]


@pytest.mark.parametrize("costs", ["exact", "jitter"])
@pytest.mark.parametrize("arch", ["minimal", "unidir"])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_sharded_relax_per_net_termination(s, arch, costs):
    """The cluster kernel's termination rule: each net stops at its own
    first sweep with no owned change.  The plain lag-1 sharded loop run
    one net at a time, its per-net [executed, useful] max-reduced,
    equals the batch run (every output bit-identical, stats equal) and
    the JAX package's planes_relax_sharded."""
    pg, tpg, args = _costs_instance(arch, costs)
    B = args[0].shape[0]
    mesh = TS.make_row_mesh(s, "ppermute", "cpu")
    batch = TS.planes_relax_sharded(tpg, *(torch.from_numpy(x)
                                           for x in args), 24, mesh)
    nets = [TS.planes_relax_sharded(
        tpg, *(torch.from_numpy(x[b:b + 1]) for x in args), 24, mesh)
        for b in range(B)]
    per_net = torch.stack([n[3] for n in nets])
    # the nets do not all stop at the same sweep
    assert per_net[-1].tolist() == [1, 0] < per_net[0].tolist()
    for k in range(3):
        assert torch.equal(torch.cat([n[k] for n in nets]), batch[k])
    assert torch.equal(per_net.max(0).values, batch[3])
    jout = JS.planes_relax_sharded(pg, *(jnp.asarray(x) for x in args), 24,
                                   JS.make_row_mesh(s, "ppermute"))
    for a, b in zip(jout, batch):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_cluster_dispatch_rule():
    """planes_relax_sharded takes the cluster launch exactly for the
    lag-1 schedule with every shard on the tensors' card; across cards,
    under lag 2 and on the CPU it runs the per-sweep loop."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    one = TS.RowMesh((c0,) * 3)
    assert TS.uses_cluster(one, c0)
    assert not TS.uses_cluster(one, c1)
    assert not TS.uses_cluster(TS.RowMesh((c0,) * 3, "pallas_halo"), c0)
    assert not TS.uses_cluster(TS.RowMesh((c0, c1)), c0)
    cpu = TS.make_row_mesh(2, "ppermute", "cpu")
    assert not TS.uses_cluster(cpu, torch.device("cpu"))
    assert TS.sweep_cap(24, 4) == 96
    assert TS.sweep_cap(300, 4) == TS.MAX_SHARD_SWEEPS


def test_sharded_relax_sweep_ceiling():
    """A ceiling below the fixpoint caps the sweeps at nsweeps * s."""
    pg, tpg, args, _ = _instance("unidir")
    for impl in TS.MESH_IMPLS:
        jout = JS.planes_relax_sharded(pg, *(jnp.asarray(x) for x in args),
                                       2, JS.make_row_mesh(2, impl))
        out = TS.planes_relax_sharded(
            tpg, *(torch.from_numpy(x) for x in args), 2,
            TS.make_row_mesh(2, impl, "cpu"))
        assert out[3].tolist() == [4, 4]
        for a, b in zip(jout, out):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_sharded_relax_refuses_mesh_of_another_device_type():
    """Shards on one device type and tensors on another raise: nothing
    is copied over to the mesh's devices and relaxed there instead."""
    _, tpg, args, _ = _instance("minimal")
    meta = TS.make_row_mesh(2, devices=["meta", "meta"])
    with pytest.raises(ValueError, match="meta.*cpu"):
        TS.planes_relax_sharded(tpg, *(torch.from_numpy(x) for x in args),
                                24, meta)


# ---- the sharded route -----------------------------------------------

def _jax_route():
    if "route" not in _CACHE:
        jf = jax_synth_flow(**FIXTURE)
        _CACHE["route"] = JRouter(jf.rr, JOpts(batch_size=32,
                                               pipeline=False)).route(jf.term)
    return _CACHE["route"]


def _port_mesh_route(s):
    tf = synth_flow(**FIXTURE)
    r = TR.Router(tf.rr, TR.RouterOpts(batch_size=32, mesh_shards=s),
                  device="cpu")
    res = r.route(tf.term)
    check_route(tf.rr, tf.term, res.paths, occ=res.occ)
    return r, res


def _assert_route_matches_single_device(s):
    jres = _jax_route()
    r, tres = _port_mesh_route(s)
    assert tres.success
    assert (tres.wirelength, tres.iterations) == (jres.wirelength,
                                                  jres.iterations)
    assert np.array_equal(tres.paths, jres.paths)
    assert np.array_equal(tres.occ, jres.occ)
    m = r.metrics
    assert m["route.mesh.halo_exchanges"] == (s - 1) * tres.total_relax_steps
    assert m["route.mesh.halo_bytes"] > 0
    assert m["route.mesh.n_shards"] == s
    assert m["route.mesh.overlap_frac"] == 0.0     # lag-1 on the CPU
    assert r.row_mesh.impl == "ppermute"
    return r, tres


def test_router_mesh2_matches_jax_route():
    _assert_route_matches_single_device(2)


@pytest.mark.slow
def test_router_mesh4_matches_jax_route():
    _assert_route_matches_single_device(4)


@pytest.mark.slow
def test_router_mesh2_ledger_matches_jax_mesh_route():
    """Route and halo ledger equal to the JAX Router's own mesh_shards=2
    route (its ppermute rung on CPU devices)."""
    old = set_metrics(MetricsRegistry())
    try:
        jf = jax_synth_flow(**FIXTURE)
        jres = JRouter(jf.rr, JOpts(batch_size=32, pipeline=False,
                                    mesh_shards=2)).route(jf.term)
        jm = get_metrics().values("route.mesh.")
    finally:
        set_metrics(old)
    r, tres = _port_mesh_route(2)
    _assert_same_route(jres, tres)
    for k in ("route.mesh.halo_bytes", "route.mesh.halo_exchanges",
              "route.mesh.n_shards", "route.mesh.overlap_frac"):
        assert r.metrics[k] == jm[k], k


@pytest.mark.parametrize("name,value", [
    ("resil", object()), ("plane_dtype", "bf16"), ("fused_dispatch", True)])
def test_mesh_rejects_unported_combinations(name, value):
    tf = synth_flow(**FIXTURE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TR.Router(tf.rr, TR.RouterOpts(mesh_shards=2, **{name: value}),
                  device="cpu")


def test_router_mesh_placement():
    """mesh_shards places one shard per device round-robin over the
    Router's device type; mesh_shards <= 1 routes on one device."""
    tf = synth_flow(**FIXTURE)
    r = TR.Router(tf.rr, TR.RouterOpts(mesh_shards=3), device="cpu")
    rm = r.row_mesh
    assert rm.devices == (torch.device("cpu"),) * 3 and rm.n_cards == 1
    for s in (0, 1):
        r = TR.Router(tf.rr, TR.RouterOpts(mesh_shards=s), device="cpu")
        assert r.row_mesh is None and r.metrics == {}
