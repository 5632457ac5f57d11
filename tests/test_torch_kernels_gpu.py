"""The port's hand-written CUDA kernels on the card: each against its
plain PyTorch version on the same inputs (bit-identical), launch
counting, the row-sharded relaxation on the card against its CPU run,
and the Router on CUDA against the Router on the CPU.

Run on a machine with a CUDA device:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
Without one, every test here skips (the decision is taken inside the
``cuda`` fixture, never at import)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu_torch.arch.builtin import minimal_arch, unidir_arch
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.route import planes as P
from parallel_eda_tpu_torch.route import planes_kernels as pk
from parallel_eda_tpu_torch.route import planes_shard as TS
from parallel_eda_tpu_torch.route import shard_kernels as sk
from parallel_eda_tpu_torch.route.check import check_route
from parallel_eda_tpu_torch.route.router import Router, RouterOpts
from parallel_eda_tpu_torch.rr.graph import CHANX, CHANY, build_rr_graph
from parallel_eda_tpu_torch.rr.grid import DeviceGrid

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _instance(arch, nx, ny, B, seed, costs, device):
    rr = build_rr_graph(arch, DeviceGrid(nx, ny, arch.io_capacity))
    pg = P.build_planes(rr, device)
    rng = np.random.default_rng(seed)
    N = rr.num_nodes
    wires = np.where((rr.node_type == CHANX) | (rr.node_type == CHANY))[0]
    noc = pg.node_of_cell.cpu().numpy()
    seed_m = np.zeros((B, N), bool)
    for b in range(B):
        seed_m[b, rng.choice(wires, 2, replace=False)] = True
    if costs == "exact":
        cong = (2.0 ** rng.integers(-6, 3, (B, N))).astype(np.float32)
    else:
        cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(np.float32)
    crit = (rng.uniform(0, 0.9, (B, 1, 1, 1)) if costs == "crit"
            else np.zeros((B, 1, 1, 1))).astype(np.float32)
    d0 = np.ascontiguousarray(
        np.where(seed_m[:, noc], 0.0, np.inf).astype(np.float32))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return pg, t(d0), t(cong[:, noc]), t(crit), torch.zeros(
        (B, pg.ncells), dtype=torch.float32, device=device)


def _same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b.cpu())


ARCHS = [(lambda: minimal_arch(chan_width=8), 6, 5),
         (lambda: unidir_arch(chan_width=8), 7, 6)]


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_full_kernel_matches_plain(cuda, arch_i, costs):
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 3, costs, cuda)
    n0 = pk.planes_relax_full_cuda.launches
    got = P.planes_relax(pg, d0, cc, crit, w0, 32)
    torch.cuda.synchronize()
    assert pk.planes_relax_full_cuda.launches == n0 + 1
    _same(got, P.planes_relax_plain(pg, d0, cc, crit, w0, 32))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_full_kernel_modes_match_plain(cuda, arch_i, costs, mode):
    """Every shared-memory mode of K1 gives the plain version's bits."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 9, costs, cuda)
    got = pk.planes_relax_full_cuda(pg, d0, cc, crit, w0, 32, mode=mode)
    torch.cuda.synchronize()
    assert pk.planes_relax_full_cuda.last_mode == mode
    _same(got, P.planes_relax_plain(pg, d0, cc, crit, w0, 32))


def _origins(rng, n, B, cuda):
    """Tile origins from below 0 to past the grid: the kernel clamps
    them as the plain version does."""
    return torch.from_numpy(rng.integers(-3, n + 3, B).astype(np.int32)
                            ).to(cuda)


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_cropped_kernel_matches_plain(cuda, arch_i, costs):
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 4, costs, cuda)
    rng = np.random.default_rng(1)
    ox, oy = _origins(rng, nx, 16, cuda), _origins(rng, ny, 16, cuda)
    n0 = pk.planes_relax_cropped_cuda.launches
    args = (pg, d0, cc, crit, w0, 32, ox, oy, 3, 3)
    got = P.planes_relax_cropped(*args)
    torch.cuda.synchronize()
    assert pk.planes_relax_cropped_cuda.launches == n0 + 1
    _same(got, P.planes_relax_cropped_plain(*args))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_cropped_kernel_modes_match_plain(cuda, arch_i, costs, mode):
    """Every shared-memory mode of K2, origins that clamp, against the
    plain version: dist, pred, wenter and stats bit-identical."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 11, costs, cuda)
    rng = np.random.default_rng(12)
    ox, oy = _origins(rng, nx, 16, cuda), _origins(rng, ny, 16, cuda)
    args = (pg, d0, cc, crit, w0, 32, ox, oy, 4, 3)
    got = pk.planes_relax_cropped_cuda(*args, mode=mode)
    torch.cuda.synchronize()
    assert pk.planes_relax_cropped_cuda.last_mode == mode
    _same(got, P.planes_relax_cropped_plain(*args))


def test_cropped_kernel_allocates_only_outputs(cuda):
    """K2's wrapper on the card: one launch, and no memory beyond its
    outputs (one [3, B, ncells] block and the [B + 1, 2] stats)."""
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 6, 5, 16,
                                     13, "jitter", cuda)
    ox = torch.zeros(16, dtype=torch.int32, device=cuda)
    args = (pg, d0, cc, crit, w0, 32, ox, ox, 3, 3)
    P.planes_relax_cropped(*args)           # the plan is built once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    m0 = torch.cuda.memory_allocated(cuda)
    n0 = pk.planes_relax_cropped_cuda.launches
    got = P.planes_relax_cropped(*args)
    torch.cuda.synchronize()
    assert pk.planes_relax_cropped_cuda.launches == n0 + 1

    def blocks(nbytes):                     # the caching allocator's unit
        return -(-nbytes // 512) * 512
    want = blocks(3 * 16 * pg.ncells * 4) + blocks(17 * 2 * 4)
    assert torch.cuda.max_memory_allocated(cuda) - m0 == want
    _same(got, P.planes_relax_cropped_plain(*args))


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
def test_kernels_long_lines_match_plain(cuda, costs):
    """A 40x40 grid: scan lines of 40 cells (longer than a warp), several
    cells per lane, dist in shared memory; K1 on the full canvas and K2
    on 34x34 crop tiles."""
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 40, 40, 8,
                                     7, costs, cuda)
    assert pg.shape_x[1:] == (40, 41)
    got = P.planes_relax(pg, d0, cc, crit, w0, 48)
    torch.cuda.synchronize()
    assert pk.planes_relax_full_cuda.last_mode >= 1
    _same(got, P.planes_relax_plain(pg, d0, cc, crit, w0, 48))
    rng = np.random.default_rng(2)
    ox = torch.from_numpy(rng.integers(0, 7, 8).astype(np.int32)).to(cuda)
    oy = torch.from_numpy(rng.integers(0, 7, 8).astype(np.int32)).to(cuda)
    args = (pg, d0, cc, crit, w0, 48, ox, oy, 34, 34)
    got = P.planes_relax_cropped(*args)
    torch.cuda.synchronize()
    _same(got, P.planes_relax_cropped_plain(*args))


@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
def test_full_kernel_global_state_matches_plain(cuda, costs):
    """W=8 at 63x63: 258 KB of dist per net, more than a block's shared
    memory, so the kernel keeps the state in global memory (mode 0)."""
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 63, 63, 4,
                                     8, costs, cuda)
    assert pg.ncells * 4 > 232448
    got = P.planes_relax(pg, d0, cc, crit, w0, 24)
    torch.cuda.synchronize()
    assert pk.planes_relax_full_cuda.last_mode == 0
    _same(got, P.planes_relax_plain(pg, d0, cc, crit, w0, 24))


def test_router_cuda_matches_cpu(cuda):
    cfg = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
    f = synth_flow(**cfg)
    rc = Router(f.rr, RouterOpts(batch_size=32), device="cpu").route(f.term)
    pk.reset_launch_counts()
    rg = Router(f.rr, RouterOpts(batch_size=32), device=cuda).route(f.term)
    assert pk.planes_relax_full_cuda.launches > 0
    assert (rg.wirelength, rg.iterations) == (rc.wirelength, rc.iterations)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    check_route(f.rr, f.term, rg.paths, occ=rg.occ)


def test_bench_config_on_card(cuda):
    f = synth_flow(num_luts=60, num_inputs=12, num_outputs=12,
                   chan_width=12, seed=11)
    r = Router(f.rr, RouterOpts(batch_size=64), device=cuda).route(f.term)
    assert (r.wirelength, r.iterations) == (537, 22)
    check_route(f.rr, f.term, r.paths, occ=r.occ)


@pytest.mark.slow
def test_scale_route_cuda_matches_cpu(cuda):
    """The placed 1,200-LUT config: the route through the CUDA kernels
    equals the route through the plain versions on the CPU of the same
    machine, path for path (~10 min, most of it the CPU route)."""
    from parallel_eda_tpu_torch.flow import run_place_native

    f = run_place_native(synth_flow(num_luts=1200, num_inputs=12,
                                    num_outputs=12, chan_width=20, seed=11))
    pk.reset_launch_counts()
    rg = Router(f.rr, RouterOpts(batch_size=64), device=cuda).route(f.term)
    assert pk.planes_relax_cropped_cuda.launches > 0
    rc = Router(f.rr, RouterOpts(batch_size=64), device="cpu").route(f.term)
    assert (rg.wirelength, rg.iterations, rg.total_relax_steps) == (
        rc.wirelength, rc.iterations, rc.total_relax_steps)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    assert np.array_equal(rg.sink_delay, rc.sink_delay)
    check_route(f.rr, f.term, rg.paths, occ=rg.occ)


@pytest.mark.parametrize("cols", [1, 2])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_slab_permute_kernel_matches_plain(cuda, s, fwd, cols):
    rng = np.random.default_rng(s * 10 + cols + fwd)
    canv = rng.uniform(0, 1, (s, 64, 12, 6, 7)).astype(np.float32)
    canv[rng.random(canv.shape) < 0.2] = np.inf
    slabs = [torch.from_numpy(canv[i]).to(cuda)[:, :, 2:2 + cols]
             for i in range(s)]
    n0 = sk.remote_slab_permute_cuda.launches
    got = sk.remote_slab_permute(slabs, fwd)
    torch.cuda.synchronize()
    assert sk.remote_slab_permute_cuda.launches == n0 + 1
    _same(got, sk.slab_permute_plain(slabs, fwd))


def _blocks(pg, d0, cc, w0, s, device):
    kx = TS.row_block_cols(pg, s)
    devs = [device] * s
    sp = [P._split_flat(pg, a) for a in (d0, cc, w0)]
    bl = [(TS.shard_blocks(x, f, 2, kx, devs), TS.shard_blocks(y, f, 3, kx,
                                                              devs))
          for (x, y), f in zip(sp, (float("inf"), float("inf"), 0.0))]
    return kx, bl


@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_sweep_block_kernel_matches_plain(cuda, arch_i, costs, mode):
    """One step-kernel sweep of every shard's block, pred carried in from
    a plain sweep, against one more plain sweep, in every shared-memory
    mode (None: the most that fits; 0 global state, 1 dist in shared
    memory, 2 dist and scan costs)."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 5, costs, cuda)
    s = 2
    kx, ((dx, dy), (ccx, ccy), (wx, wy)) = _blocks(pg, d0, cc, w0, s, cuda)
    gms = TS._shard_geoms(pg, TS.make_row_mesh(s, devices=[cuda] * s), kx)
    own = slice(1, kx + 1)
    for k in range(s):
        g = gms[k]
        st = (dx[k], dy[k], g.idxx.expand(dx[k].shape).contiguous(),
              g.idxy.expand(dy[k].shape).contiguous(), wx[k], wy[k])
        costs_k = P._sweep_costs(g, crit, ccx[k], ccy[k])
        st1 = P._sweep_once(g, st, crit, ccx[k], ccy[k], costs_k)
        n0 = pk.planes_sweep_block_cuda.launches
        got, stats = pk.planes_sweep_block_cuda(g, st1, crit, ccx[k],
                                                ccy[k], (1, kx + 1),
                                                mode=mode)
        torch.cuda.synchronize()
        assert pk.planes_sweep_block_cuda.launches == n0 + 1
        ref = P._sweep_once(g, st1, crit, ccx[k], ccy[k], costs_k)
        _same(got, ref)
        flag = ((ref[0][:, :, own] < st1[0][:, :, own]).flatten(1).any(1)
                | (ref[1][:, :, own] < st1[1][:, :, own]).flatten(1).any(1))
        assert torch.equal(stats[:, 1].bool().cpu(), flag.cpu())
        assert (stats[:, 0] == 1).all()


def _pg_to(pg, device):
    f = {k: getattr(pg, k).cpu().numpy() for k in P._PG_FIELDS}
    f.update(directional=pg.directional, max_span=pg.max_span,
             inc_track=(None if pg.inc_track is None
                        else pg.inc_track.cpu().numpy()))
    return P.planes_graph_from_numpy(f, device)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_cuda_matches_cpu(cuda, impl, s):
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 6, 5, 16,
                                     6, "exact", cuda)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    mesh = TS.make_row_mesh(s, impl, [d0.device] * s)
    got = TS.planes_relax_sharded(pg, d0, cc, crit, w0, 24, mesh)
    torch.cuda.synchronize()
    sweeps = int(got[3][0])
    if impl == "ppermute":
        # lag 1 on one card: one cluster launch for the whole relaxation
        assert pk.planes_relax_cluster_cuda.launches == 1
        assert pk.planes_sweep_block_cuda.launches == 0
        assert sk.halo_exchange_cuda.launches == 0
    else:
        # one step launch per shard and one exchange launch per sweep
        assert pk.planes_sweep_block_cuda.launches == s * sweeps
        assert sk.halo_exchange_cuda.launches == sweeps
        assert pk.planes_relax_cluster_cuda.launches == 0
    cpu = [t.cpu() for t in (d0, cc, crit, w0)]
    ref = TS.planes_relax_sharded(_pg_to(pg, "cpu"), *cpu, 24,
                                  TS.make_row_mesh(s, impl, "cpu"))
    _same(got, ref)
    single = P.planes_relax_plain(pg, d0, cc, crit, w0, 24)
    for k in (0, 2):
        assert torch.equal(got[k].cpu(), single[k].cpu())


@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_cluster_relax_matches_plain_sweeps(cuda, s, arch_i, costs, mode):
    """The one-launch cluster relaxation against the plain per-sweep loop
    (_PlainSweeps) on the card and the step-and-halo-kernel loop: every
    output and the stats bit-identical, in every shared-memory mode; on
    f32-exact costs dist and wenter equal single-device K1's."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, 16, 20 + s, costs, cuda)
    d0[3] = float("inf")                    # a net that stops at once
    n0 = pk.planes_relax_cluster_cuda.launches
    got = pk.planes_relax_cluster_cuda(pg, d0, cc, crit, w0,
                                       TS.sweep_cap(24, s), s, mode=mode)
    torch.cuda.synchronize()
    assert pk.planes_relax_cluster_cuda.launches == n0 + 1
    if mode is not None:
        assert pk.planes_relax_cluster_cuda.last_mode == mode
    per_net = pk.planes_relax_cluster_cuda.last_stats[:-1].cpu()
    assert per_net[3].tolist() == [1, 0]
    assert torch.equal(per_net.max(0).values, got[3].cpu())
    mesh = TS.make_row_mesh(s, "ppermute", [d0.device] * s)
    plain = TS.planes_relax_sharded_sweeps(pg, d0, cc, crit, w0, 24, mesh,
                                           plain=True)
    _same(got, plain)
    _same(got, TS.planes_relax_sharded_sweeps(pg, d0, cc, crit, w0, 24,
                                              mesh))
    if costs == "exact":
        single = pk.planes_relax_full_cuda(pg, d0, cc, crit, w0, 24)
        for k in (0, 2):
            assert torch.equal(got[k], single[k])


@pytest.mark.parametrize("s", [9, 16])
def test_cluster_relax_beyond_portable_size(cuda, s):
    """More than 8 shards: a non-portable cluster, bit-identical to the
    plain loop where the card schedules it, else a stated refusal."""
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 6, 5, 8,
                                     30 + s, "jitter", cuda)
    try:
        got = pk.planes_relax_cluster_cuda(pg, d0, cc, crit, w0,
                                           TS.sweep_cap(24, s), s)
    except RuntimeError as e:
        assert "cannot schedule a cluster" in str(e)
        return
    torch.cuda.synchronize()
    mesh = TS.make_row_mesh(s, "ppermute", [d0.device] * s)
    _same(got, TS.planes_relax_sharded_sweeps(pg, d0, cc, crit, w0, 24,
                                              mesh, plain=True))


def test_router_mesh_cuda_matches_cpu(cuda):
    cfg = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
    f = synth_flow(**cfg)
    rc = Router(f.rr, RouterOpts(batch_size=32), device="cpu").route(f.term)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    router = Router(f.rr, RouterOpts(batch_size=32, mesh_shards=2),
                    device=cuda)
    rg = router.route(f.term)
    if router.row_mesh.n_cards == 1:
        # lag 1 with both shards on the card: one cluster launch per
        # relaxation, no step, no halo kernel
        assert pk.planes_relax_cluster_cuda.launches > 0
        assert pk.planes_sweep_block_cuda.launches == 0
        assert sk.halo_exchange_cuda.launches == 0
    else:
        assert pk.planes_relax_cluster_cuda.launches == 0
        assert pk.planes_sweep_block_cuda.launches > 0
        assert sk.halo_exchange_cuda.launches > 0
    assert sk.remote_slab_permute_cuda.launches == 0
    assert pk.planes_relax_full_cuda.launches == 0
    assert (rg.wirelength, rg.iterations) == (rc.wirelength, rc.iterations)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    check_route(f.rr, f.term, rg.paths, occ=rg.occ)


def _cards(n):
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs two or more CUDA devices")
    return [torch.device("cuda", i % k) for i in range(n)]


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_across_cards_matches_cpu(cuda, impl, s):
    """The shards round-robin over the cards: both schedules take the
    per-sweep loop (one step launch per shard and one exchange launch per
    sending card each sweep, no cluster launch); every output and the
    stats equal the CPU run."""
    devs = _cards(s)
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=8), 6, 5, 16,
                                     6, "exact", cuda)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    mesh = TS.make_row_mesh(s, impl, devs)
    assert mesh.n_cards > 1
    got = TS.planes_relax_sharded(pg, d0, cc, crit, w0, 24, mesh)
    for d in set(devs):
        torch.cuda.synchronize(d)
    sweeps = int(got[3][0])
    assert pk.planes_sweep_block_cuda.launches == s * sweeps
    assert sk.halo_exchange_cuda.launches == len(set(devs)) * sweeps
    assert pk.planes_relax_cluster_cuda.launches == 0
    cpu = [t.cpu() for t in (d0, cc, crit, w0)]
    ref = TS.planes_relax_sharded(_pg_to(pg, "cpu"), *cpu, 24,
                                  TS.make_row_mesh(s, impl, "cpu"))
    _same(got, ref)


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_slab_permute_kernel_across_cards(cuda, s, fwd):
    """Shards on several cards: each sender's card writes the receiver's
    buffer through a peer pointer; the result lands on the receiver's
    card, equal to the plain version."""
    devs = _cards(s)
    rng = np.random.default_rng(s + 10 * fwd)
    canv = rng.uniform(0, 1, (s, 64, 12, 6, 7)).astype(np.float32)
    canv[rng.random(canv.shape) < 0.2] = np.inf
    slabs = [torch.from_numpy(canv[i]).to(d)[:, :, 2:4]
             for i, d in enumerate(devs)]
    n0 = sk.remote_slab_permute_cuda.launches
    got = sk.remote_slab_permute(slabs, fwd)
    assert [g.device for g in got] == devs
    # one launch per card that sends (or fills its own edge buffer)
    launchers = {devs[r - 1 if fwd else r + 1] if 0 <= (r - 1 if fwd else
                                                       r + 1) < s
                 else devs[r] for r in range(s)}
    assert sk.remote_slab_permute_cuda.launches == n0 + len(launchers)
    _same(got, sk.slab_permute_plain(slabs, fwd))


def _block_states(s, kx, devs, seed, B=64, W=12, NY=6):
    """Random (dx, dy) block canvases per shard ([B, W, kx+2, NY+1] /
    [B, W, kx+3, NY], 20% INF) on the shards' devices."""
    rng = np.random.default_rng(seed)
    out = []
    for d in devs:
        pair = []
        for ext, ny in ((2, NY + 1), (3, NY)):
            a = rng.uniform(0, 1, (B, W, kx + ext, ny)).astype(np.float32)
            a[rng.random(a.shape) < 0.2] = np.inf
            pair.append(torch.from_numpy(a).to(d))
        out.append(tuple(pair))
    return out


def _exchange_matches_plain(s, devs, lagged):
    kx = 3
    states = _block_states(s, kx, devs, s + 7 * lagged)
    src = _block_states(s, kx, devs, 99 + s) if lagged else None
    ref = [tuple(t.cpu() for t in st) for st in states]
    ref_src = None if src is None else [tuple(t.cpu() for t in st)
                                        for st in src]
    sk.halo_exchange_plain(ref, kx, ref_src)
    n0 = sk.halo_exchange_cuda.launches
    sk.halo_exchange(states, kx, src)
    for d in set(devs):
        torch.cuda.synchronize(d)
    for got, want in zip(states, ref):
        _same(got, want)
    return sk.halo_exchange_cuda.launches - n0


@pytest.mark.parametrize("lagged", [False, True])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_halo_exchange_kernel_matches_plain(cuda, s, lagged):
    """The fused in-place exchange on one card: one launch, every halo
    column bit-identical to the plain version's."""
    assert _exchange_matches_plain(s, [cuda] * s, lagged) == 1


@pytest.mark.parametrize("lagged", [False, True])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_halo_exchange_kernel_across_cards(cuda, s, lagged):
    """The exchange with the shards on several cards: each card launches
    once for what it sends, through peer pointers."""
    devs = _cards(s)
    assert _exchange_matches_plain(s, devs, lagged) == len(set(devs))


def test_router_mesh_across_cards(cuda):
    devs = _cards(4)
    f = synth_flow(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
                   seed=3)
    r1 = Router(f.rr, RouterOpts(batch_size=32), device=cuda).route(f.term)
    router = Router(f.rr, RouterOpts(batch_size=32, mesh_shards=4),
                    device=cuda)
    assert router.row_mesh.devices == tuple(devs)
    r4 = router.route(f.term)
    assert (r4.wirelength, r4.iterations) == (r1.wirelength, r1.iterations)
    assert np.array_equal(r4.paths, r1.paths)
    assert np.array_equal(r4.occ, r1.occ)
