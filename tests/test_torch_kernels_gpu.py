"""The port's hand-written CUDA kernels on the card: each against its
plain PyTorch version on the same inputs (bit-identical), launch
counting, the row-sharded relaxation on the card (the cluster and the
peer kernel) against its plain loop and its CPU run, and the Router on
CUDA against the Router on the CPU.

Run on a machine with a CUDA device:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
Without one, every test here skips (the decision is taken inside the
``cuda`` fixture, never at import)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu_torch.arch.builtin import minimal_arch, unidir_arch
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics
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


@pytest.mark.parametrize("cfg,opts,kernel", [
    (dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10, seed=3),
     dict(batch_size=32), "planes_relax_full_cuda"),
    (dict(num_luts=40, num_inputs=6, num_outputs=6, chan_width=10, seed=3,
          bb_factor=0), dict(batch_size=32, crop="4x4"),
     "planes_relax_cropped_cuda")])
def test_timing_route_cuda_matches_cpu(cuda, cfg, opts, kernel):
    """The timing-driven route (the STA between iterations inside each
    window, the relaxation kernels at crit > 0) on the card equals the
    same route on the CPU: paths, occupancy, sink delays, the critical
    path and every window's crit-path column."""
    from parallel_eda_tpu_torch.flow import run_route

    fc = run_route(synth_flow(**cfg), RouterOpts(**opts), device="cpu")
    pk.reset_launch_counts()
    fg = run_route(synth_flow(**cfg), RouterOpts(**opts), device=cuda)
    assert pk.launch_counts()[kernel] > 0
    rc, rg = fc.route, fg.route
    assert (rg.wirelength, rg.iterations, rg.total_relax_steps) == (
        rc.wirelength, rc.iterations, rc.total_relax_steps)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    assert np.array_equal(rg.sink_delay, rc.sink_delay)
    assert fg.crit_path_delay == fc.crit_path_delay
    assert [s.crit_path_delay for s in rg.stats] == [
        s.crit_path_delay for s in rc.stats]


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
    assert sweeps > 1
    # one launch for the whole relaxation: lag 1 on one card the cluster
    # kernel, lag 2 the peer kernel
    want = ("planes_relax_cluster_cuda" if impl == "ppermute"
            else "planes_relax_peer_cuda")
    assert {k: v for k, v in pk.launch_counts().items() if v} == {want: 1}
    assert sk.launch_counts()["remote_slab_permute_cuda"] == 0
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
    (_PlainSweeps) on the card and the peer kernel under lag 1: every
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
    plain = TS.planes_relax_sharded_plain(pg, d0, cc, crit, w0, 24, mesh)
    _same(got, plain)
    _same(got, pk.planes_relax_peer_cuda(pg, d0, cc, crit, w0,
                                         TS.sweep_cap(24, s), mesh.devices))
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
    _same(got, TS.planes_relax_sharded_plain(pg, d0, cc, crit, w0, 24,
                                             mesh))


def _peer_case(s, inst, mode, impl, plane_dtype="f32"):
    """The peer kernel on one card against the plain loop (and, under lag
    1, the cluster kernel): one launch per relaxation, every output and
    the stats bit-identical, the per-net stats' max the batch's, the
    empty net 3 stopped after its first (lag 1) or second (lag 2) sweep."""
    pg, d0, cc, crit, w0 = inst
    d0[3] = float("inf")
    mesh = TS.make_row_mesh(s, impl, [d0.device] * s)
    lag2 = impl == "pallas_halo"
    cap = TS.sweep_cap(24, s)
    c0 = pk.launch_counts()
    got = pk.planes_relax_peer_cuda(pg, d0, cc, crit, w0, cap, mesh.devices,
                                    lag2=lag2, mode=mode,
                                    plane_dtype=plane_dtype)
    torch.cuda.synchronize()
    c1 = pk.launch_counts()
    key = "planes_relax_peer_cuda" + ("[bf16]" if plane_dtype == BF else "")
    assert {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]} == {key: 1}
    if mode is not None:
        assert pk.planes_relax_peer_cuda.last_mode == mode
    per_net = pk.planes_relax_peer_cuda.last_stats[:-1].cpu()
    assert per_net[3].tolist() == [2 if lag2 else 1, 0]
    assert torch.equal(per_net.max(0).values, got[3].cpu())
    _same(got, TS.planes_relax_sharded_plain(pg, d0, cc, crit, w0, 24, mesh,
                                             plane_dtype))
    if not lag2:
        _same(got, pk.planes_relax_cluster_cuda(pg, d0, cc, crit, w0, cap, s,
                                                mode=mode,
                                                plane_dtype=plane_dtype))
    return got


@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["exact", "jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_peer_relax_matches_plain(cuda, s, arch_i, costs, mode, impl):
    """The peer kernel (one cooperative launch, halos through the
    mailboxes, the fixpoint on the card) in every shared-memory mode,
    both schedules, against the plain loop and, under lag 1, the
    cluster kernel; on f32-exact costs dist and wenter equal K1's."""
    mk, nx, ny = ARCHS[arch_i]
    inst = _instance(mk(), nx, ny, 16, 70 + s, costs, cuda)
    got = _peer_case(s, inst, mode, impl)
    if costs == "exact":
        single = pk.planes_relax_full_cuda(*inst, 24)
        for k in (0, 2):
            assert torch.equal(got[k], single[k])


@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_peer_relax_bf16_matches_plain(cuda, s, arch_i, costs, mode, impl):
    """The peer kernel in the bf16 plane mode: the mailboxes carry the
    rounded dist, the flags compare the rounded owned cells."""
    _peer_case(s, _bf16_instance(arch_i, 80 + s, costs, cuda), mode, impl,
               BF)


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
        # relaxation
        assert pk.planes_relax_cluster_cuda.launches > 0
        assert pk.planes_relax_peer_cuda.launches == 0
    else:
        # across cards: one peer launch per card per relaxation
        assert pk.planes_relax_cluster_cuda.launches == 0
        assert pk.planes_relax_peer_cuda.launches > 0
        assert pk.planes_relax_peer_cuda.launches % \
            router.row_mesh.n_cards == 0
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
    peer kernel (one launch per card for the whole relaxation, halos
    over NVLink, no cluster launch); every output and the stats equal
    the CPU run."""
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
    assert int(got[3][0]) > 1
    assert pk.planes_relax_peer_cuda.launches == len(set(devs))
    assert pk.planes_relax_cluster_cuda.launches == 0
    cpu = [t.cpu() for t in (d0, cc, crit, w0)]
    ref = TS.planes_relax_sharded(_pg_to(pg, "cpu"), *cpu, 24,
                                  TS.make_row_mesh(s, impl, "cpu"))
    _same(got, ref)
    # f32 and bf16: equal to the peer kernel's one-card form (every
    # shard on the tensors' card), one launch per card
    one = TS.RowMesh((d0.device,) * s, impl, per_sweep=True)
    for pd, key in (("f32", "planes_relax_peer_cuda"),
                    ("bf16", "planes_relax_peer_cuda[bf16]")):
        n0 = pk.launch_counts()[key]
        got = TS.planes_relax_sharded(pg, d0, cc, crit, w0, 24, mesh, pd)
        for d in set(devs):
            torch.cuda.synchronize(d)
        assert pk.launch_counts()[key] == n0 + len(set(devs))
        _same(got, TS.planes_relax_sharded(pg, d0, cc, crit, w0, 24, one,
                                           pd))


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


# ---- the bf16 plane mode ---------------------------------------------

BF = "bf16"


def _bf16_instance(arch_i, seed, costs, device, B=16):
    """_instance with a wenter payload at the seeds (rounded in the bf16
    plane mode) and one net that stops after its first sweep."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _instance(mk(), nx, ny, B, seed, costs, device)
    rng = np.random.default_rng(seed + 1)
    w0 = torch.from_numpy(rng.uniform(0, 1e-10, tuple(d0.shape)).astype(
        np.float32)).to(device) * (d0 == 0)
    d0[3] = float("inf")
    return pg, d0, cc, crit, w0


@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_full_kernel_bf16_matches_plain(cuda, arch_i, costs, mode):
    """K1 in the bf16 plane mode, every shared-memory mode: bit-identical
    to the plain bf16 relaxation (the batch loop; the kernel stops each
    net at its own fixpoint), counted under launches_bf16."""
    pg, d0, cc, crit, w0 = _bf16_instance(arch_i, 40, costs, cuda)
    n0, f0 = (pk.planes_relax_full_cuda.launches_bf16,
              pk.planes_relax_full_cuda.launches)
    got = pk.planes_relax_full_cuda(pg, d0, cc, crit, w0, 32, mode=mode,
                                    plane_dtype=BF)
    torch.cuda.synchronize()
    assert pk.planes_relax_full_cuda.launches_bf16 == n0 + 1
    assert pk.planes_relax_full_cuda.launches == f0
    if mode is not None:
        assert pk.planes_relax_full_cuda.last_mode == mode
    assert pk.planes_relax_full_cuda.last_stats[3].tolist() == [1, 0]
    _same(got, P.planes_relax_plain(pg, d0, cc, crit, w0, 32, BF))


@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
def test_cropped_kernel_bf16_matches_plain(cuda, arch_i, costs, mode):
    """K2 in the bf16 plane mode: the tile rounded, the cells outside it
    d0 / wenter0 as given; origins that wrap and clamp."""
    mk, nx, ny = ARCHS[arch_i]
    pg, d0, cc, crit, w0 = _bf16_instance(arch_i, 41, costs, cuda)
    rng = np.random.default_rng(42)
    ox, oy = _origins(rng, nx, 16, cuda), _origins(rng, ny, 16, cuda)
    args = (pg, d0, cc, crit, w0, 32, ox, oy, 4, 3)
    n0 = pk.planes_relax_cropped_cuda.launches_bf16
    got = pk.planes_relax_cropped_cuda(*args, mode=mode, plane_dtype=BF)
    torch.cuda.synchronize()
    assert pk.planes_relax_cropped_cuda.launches_bf16 == n0 + 1
    _same(got, P.planes_relax_cropped_plain(*args, plane_dtype=BF))


@pytest.mark.parametrize("plane_dtype", ["f32", BF])
@pytest.mark.parametrize("ox", [-1, -5])
def test_cropped_kernel_negative_origin(cuda, ox, plane_dtype):
    """A negative origin wraps by each array's extent before the clamp
    (lax.dynamic_slice's rule): on the 14x12 mixed-length grid with 3x3
    tiles, -1 lands the chanx and chany planes on one origin, -5 one
    apart; K2 equals the plain version."""
    from parallel_eda_tpu_torch.arch.model import SegmentInf

    arch = minimal_arch(chan_width=12)
    arch.segments = [
        SegmentInf(name="l1", length=1, frequency=0.4, wire_switch=0,
                   opin_switch=1),
        SegmentInf(name="l2", length=2, frequency=0.3, Rmetal=80.0,
                   Cmetal=15e-15, wire_switch=1, opin_switch=1),
        SegmentInf(name="l4", length=4, frequency=0.3, Rmetal=60.0,
                   Cmetal=12e-15, wire_switch=0, opin_switch=0)]
    pg, d0, cc, crit, w0 = _instance(arch, 14, 12, 8, 43, "jitter", cuda)
    oxs = torch.full((8,), ox, dtype=torch.int32, device=cuda)
    oy = torch.arange(8, dtype=torch.int32, device=cuda) - 2
    args = (pg, d0, cc, crit, w0, 32, oxs, oy, 3, 3)
    got = P.planes_relax_cropped(*args, plane_dtype=plane_dtype)
    torch.cuda.synchronize()
    _same(got, P.planes_relax_cropped_plain(*args, plane_dtype=plane_dtype))


@pytest.mark.parametrize("mode", [None, 0, 1, 2])
@pytest.mark.parametrize("costs", ["jitter", "crit"])
@pytest.mark.parametrize("arch_i", [0, 1])
@pytest.mark.parametrize("s", [2, 4])
def test_cluster_relax_bf16_matches_plain(cuda, s, arch_i, costs, mode):
    """The cluster kernel in the bf16 plane mode (rounded halos through
    distributed shared memory, the flag on rounded owned cells, per-net
    termination) against the plain bf16 per-sweep loop and the peer
    kernel under lag 1."""
    pg, d0, cc, crit, w0 = _bf16_instance(arch_i, 44 + s, costs, cuda)
    n0 = pk.planes_relax_cluster_cuda.launches_bf16
    got = pk.planes_relax_cluster_cuda(pg, d0, cc, crit, w0,
                                       TS.sweep_cap(24, s), s, mode=mode,
                                       plane_dtype=BF)
    torch.cuda.synchronize()
    assert pk.planes_relax_cluster_cuda.launches_bf16 == n0 + 1
    per_net = pk.planes_relax_cluster_cuda.last_stats[:-1].cpu()
    assert per_net[3].tolist() == [1, 0]
    assert torch.equal(per_net.max(0).values, got[3].cpu())
    mesh = TS.make_row_mesh(s, "ppermute", [d0.device] * s)
    _same(got, TS.planes_relax_sharded_plain(pg, d0, cc, crit, w0, 24, mesh,
                                             plane_dtype=BF))
    b0 = pk.planes_relax_peer_cuda.launches_bf16
    _same(got, pk.planes_relax_peer_cuda(pg, d0, cc, crit, w0,
                                         TS.sweep_cap(24, s), mesh.devices,
                                         plane_dtype=BF))
    assert pk.planes_relax_peer_cuda.launches_bf16 == b0 + 1


@pytest.mark.parametrize("fwd", [True, False])
def test_slab_permute_kernel_bf16_matches_plain(cuda, fwd):
    rng = np.random.default_rng(60 + fwd)
    canv = rng.uniform(0, 1, (3, 64, 12, 6, 7)).astype(np.float32)
    canv[rng.random(canv.shape) < 0.2] = np.inf
    slabs = [torch.from_numpy(canv[i]).to(cuda).to(torch.bfloat16)[:, :, 2:4]
             for i in range(3)]
    got = sk.remote_slab_permute(slabs, fwd)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.bfloat16 for g in got)
    _same(got, sk.slab_permute_plain(slabs, fwd))


@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_bf16_cuda_matches_cpu(cuda, impl):
    pg, d0, cc, crit, w0 = _bf16_instance(0, 61, "crit", cuda)
    mesh = TS.make_row_mesh(2, impl, [d0.device] * 2)
    got = TS.planes_relax_sharded(pg, d0, cc, crit, w0, 24, mesh, BF)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (d0, cc, crit, w0)]
    _same(got, TS.planes_relax_sharded(_pg_to(pg, "cpu"), *cpu, 24,
                                       TS.make_row_mesh(2, impl, "cpu"), BF))


@pytest.mark.parametrize("fields", [
    dict(plane_dtype=BF, dtype_guard="off"),
    dict(plane_dtype=BF, dtype_guard="window"),
    dict(plane_dtype=BF, dtype_guard="off", mesh_shards=2),
    dict(plane_dtype=BF, dtype_guard="off", crop="4x4")])
def test_router_bf16_cuda_matches_cpu(cuda, fields):
    """The Router in the bf16 plane mode on the card equals the same
    route on the CPU, and launches the bf16 kernels."""
    cfg = (dict(num_luts=40, num_inputs=6, num_outputs=6, chan_width=10,
                seed=3, bb_factor=0) if "crop" in fields else
           dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
                seed=3))
    f = synth_flow(**cfg)
    rc = Router(f.rr, RouterOpts(batch_size=32, **fields),
                device="cpu").route(f.term)
    pk.reset_launch_counts()
    sk.reset_launch_counts()
    rg = Router(f.rr, RouterOpts(batch_size=32, **fields),
                device=cuda).route(f.term)
    counts = pk.launch_counts()
    assert sum(v for k, v in counts.items() if k.endswith("[bf16]")) > 0
    assert (rg.wirelength, rg.iterations, rg.total_relax_steps) == (
        rc.wirelength, rc.iterations, rc.total_relax_steps)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    assert np.array_equal(rg.sink_delay, rc.sink_delay)
    check_route(f.rr, f.term, rg.paths, occ=rg.occ)


# the 40-LUT flow of tests/test_torch_elastic.py
ELASTIC_FLOW = dict(num_luts=40, num_inputs=8, num_outputs=8,
                    chan_width=12, seed=3)


def _same_route(a, b):
    assert (a.success, a.iterations, a.wirelength) == (
        b.success, b.iterations, b.wirelength)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.congestion == b.congestion


def test_router_pipelined_cuda_matches_sync(cuda):
    """On the card the pipelined route (pinned summaries, one blocking
    read a window) equals the synchronous one and the CPU route: state,
    stats rows and congestion records."""
    f = synth_flow(**ELASTIC_FLOW)
    res = {}
    for dev, p in (("cpu", True), (cuda, True), (cuda, False)):
        reg = set_metrics(MetricsRegistry())
        r = Router(f.rr, RouterOpts(batch_size=32, pipeline=p), device=dev)
        res[str(dev), p] = r.route(f.term)
        if dev is cuda and p:
            assert reg.counter("route.pipeline.blocking_syncs").value == \
                len(res[str(dev), p].stats)
    want = res["cpu", True]
    assert want.success and want.congestion
    for k in ((str(cuda), True), (str(cuda), False)):
        _same_route(res[k], want)
        assert [(s.iteration, s.relax_steps) for s in res[k].stats] == \
            [(s.iteration, s.relax_steps) for s in want.stats]


def test_router_sliced_resume_cuda_matches_cpu(cuda):
    """Sliced on the card (slice_iterations=2) and resumed until success,
    the route equals the CPU's unsliced route."""
    f = synth_flow(**ELASTIC_FLOW)
    want = Router(f.rr, RouterOpts(batch_size=32), device="cpu").route(
        f.term)
    r = Router(f.rr, RouterOpts(batch_size=32, slice_iterations=2),
               device=cuda)
    got = r.route(f.term)
    slices = 1
    while not got.success:
        got = r.route(f.term, resume=got.checkpoint)
        slices += 1
    assert slices > 2
    for k in ("iterations", "wirelength"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    check_route(f.rr, f.term, got.paths, occ=got.occ)


# ---------------------------------------------------------------- placer

def test_prng_cuda_matches_cpu(cuda):
    """The threefry stream on the card equals the CPU's: split, bits,
    randint (tensor and int bounds) and uniform."""
    from parallel_eda_tpu_torch.place import prng

    for seed in (0, 3, 11):
        kc = prng.PRNGKey(seed, device="cpu")
        kg = prng.PRNGKey(seed, device=cuda)
        kc, kg = prng.split(kc, 5), prng.split(kg, 5)
        assert torch.equal(kc, kg.cpu())
        assert torch.equal(prng.split(kc, 7), prng.split(kg, 7).cpu())
        assert torch.equal(prng.random_bits(kc, (3, 64)),
                           prng.random_bits(kg, (3, 64)).cpu())
        rl = torch.arange(1, 65)
        assert torch.equal(prng.randint(kc[0], (64,), -rl, rl + 1),
                           prng.randint(kg[0], (64,), -rl.to(cuda),
                                        rl.to(cuda) + 1).cpu())
        assert torch.equal(prng.randint(kc[1], (64,), 0, 1101),
                           prng.randint(kg[1], (64,), 0, 1101).cpu())
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0)):
            assert torch.equal(prng.uniform(kc[2], (256,), lo, hi),
                               prng.uniform(kg[2], (256,), lo, hi).cpu())


@pytest.mark.parametrize("timing", [False, True])
def test_sa_step_cuda_matches_cpu(cuda, timing):
    """One sa_step on one state, card against CPU: proposals, own,
    delta, accept mask, new state, counts and moments, bit for bit."""
    from parallel_eda_tpu_torch.place import prng
    from parallel_eda_tpu_torch.place.delay_lookup import DelayLookup
    from parallel_eda_tpu_torch.place.sa import (Placer, PlacerOpts,
                                                 build_place_problem,
                                                 sa_step)

    f = synth_flow(num_luts=60, num_inputs=12, num_outputs=12,
                   chan_width=12, seed=11)
    rng = np.random.default_rng(0)
    H, W = f.grid.nx + 2, f.grid.ny + 2
    lk = DelayLookup(stack=(rng.uniform(1e-10, 2e-10, (4, 1, 1))
                            * (1 + np.arange(H)[None, :, None]
                               + np.arange(W)[None, None, :])
                            ).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda):
        pl = Placer(f.pnl, f.grid, PlacerOpts(), device=dev)
        pp = build_place_problem(f.pnl, f.grid, lookup=lk, device=dev)
        pos, ring, occ = pl._state_from_pos(f.pos)
        NN, P = pp.net_blk.shape
        crit = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (NN, P)).astype(np.float32)).to(dev)
        M = min(256, max(8, pp.num_blocks))
        outs.append(sa_step(pp, pos, ring, occ, crit, 2.6e-3, 3.7e8, 0.5,
                            prng.PRNGKey(4, device=dev), 0.02, 6.0, M,
                            timing, trace=True))
    (*a, ta), (*b, tb) = outs
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())
    for k in ("b", "npos", "nring", "own", "delta", "u", "accept",
              "blk_idx", "site_idx"):
        assert torch.equal(getattr(ta, k), getattr(tb, k).cpu()), k
    assert 0 < int(a[3]) < int(a[4])


def test_cli_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """The 25-LUT CLI flow (timing-driven place and route) on the card
    writes the same .net, .place and .route bytes as with --device cpu,
    and the card's run launches K1."""
    import os

    from parallel_eda_tpu_torch.__main__ import main

    args = ["--luts", "25", "--arch", "minimal", "--route_chan_width", "12",
            "--batch_size", "16", "--moves_per_step", "16", "--out_dir",
            "out"]
    files = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        monkeypatch.chdir(tmp_path / dev)
        n0 = pk.planes_relax_full_cuda.launches
        assert main(args + ["--device", dev]) == 0
        if dev == "cuda":
            assert pk.planes_relax_full_cuda.launches > n0
        files[dev] = {f: (tmp_path / dev / "out" / f).read_bytes()
                      for f in sorted(os.listdir(tmp_path / dev / "out"))}
    assert set(files["cuda"]) == {"synth.net", "synth.place", "synth.route"}
    assert files["cuda"] == files["cpu"]


# ---- resilience and devprof on the card -------------------------------

@pytest.mark.parametrize("cap", [1, 0])
def test_kernel_mode_cap_descent_matches_plain(cuda, cap):
    """The kernel ladder's forms: under kernel_mode_cap(1) and (0) K1 and
    K2 launch in that mode (counted per mode) and stay bit-identical to
    their plain versions; the cap leaves a forced mode= alone."""
    arch = minimal_arch(chan_width=6)
    pg, d0, cc, crit, w0 = _instance(arch, 6, 5, 4, 3, "jitter", cuda)
    ref = P.planes_relax_plain(pg, d0, cc, crit, w0, 24)
    pk.reset_launch_counts()
    with pk.kernel_mode_cap(cap):
        got = P.planes_relax(pg, d0, cc, crit, w0, 24)
        assert pk.planes_relax_full_cuda.last_mode == cap
        ox = torch.zeros(4, dtype=torch.int32, device=cuda)
        oy = torch.ones(4, dtype=torch.int32, device=cuda)
        got_c = P.planes_relax_cropped(pg, d0, cc, crit, w0, 24, ox, oy,
                                       4, 3)
        assert pk.planes_relax_cropped_cuda.last_mode == cap
        pk.planes_relax_full_cuda(pg, d0, cc, crit, w0, 24, mode=2)
        assert pk.planes_relax_full_cuda.last_mode == 2
    ref_c = P.planes_relax_cropped_plain(pg, d0, cc, crit, w0, 24, ox, oy,
                                         4, 3)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b.cpu())
    for a, b in zip(got_c, ref_c):
        assert torch.equal(a.cpu(), b.cpu())
    m = pk.mode_launch_counts()
    assert m["planes_relax_full_cuda"][cap] == 1
    assert m["planes_relax_full_cuda"][2] == 1
    assert m["planes_relax_cropped_cuda"][cap] == 1


def test_devprof_events_read_only_at_capture(cuda, tmp_path):
    """With the profiler on, every K1 launch records a CUDA-event pair on
    its stream and nothing waits for them before capture_all, which
    reads one time per launch; off, the wrappers record nothing."""
    from parallel_eda_tpu_torch.obs import devprof as dp_mod

    arch = minimal_arch(chan_width=6)
    pg, d0, cc, crit, w0 = _instance(arch, 6, 5, 4, 3, "jitter", cuda)
    p = dp_mod.DevProfiler(enabled=True)
    old = dp_mod.get_devprof()
    dp_mod.set_devprof(p)
    waited = []
    real = torch.cuda.Event.synchronize
    try:
        torch.cuda.Event.synchronize = lambda ev: (waited.append(ev),
                                                   real(ev))[1]
        p.note_variant(("k1",), {"nets": 4})
        for _ in range(3):
            P.planes_relax(pg, d0, cc, crit, w0, 24)
        assert waited == [] and len(p._pending[("k1",)]["events"]) == 3
        recs = p.capture_all()
        assert len(waited) == 3
        k = recs[0]["kernels"]["planes_relax_full_cuda"]
        assert k["launches"] == 3 and k["ms"] > 0
        p.enabled = False
        p.note_variant(("off",), {"nets": 4})
        P.planes_relax(pg, d0, cc, crit, w0, 24)
        assert p.capture_all() == recs
    finally:
        torch.cuda.Event.synchronize = real
        dp_mod.set_devprof(old)


def test_resil_route_on_card_matches_cpu(cuda):
    """The 15-LUT route under RouterOpts.resil with injected errors that
    push its first dispatch down to xla (mode 0) on the card equals the
    CPU route; at mesh_shards=2 on one card the mesh ladder starts at
    the cluster kernel; a dispatch that exhausts jit, pallas_g1 and xla
    raises DispatchPoisonedError."""
    from parallel_eda_tpu_torch.resil import (DispatchPoisonedError,
                                              FaultPlan, Resilience,
                                              ResilOpts)

    f = synth_flow(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
                   seed=3)
    set_metrics(MetricsRegistry())
    cpu = Router(f.rr, RouterOpts(batch_size=32), device="cpu").route(
        f.term)
    rt = Resilience(ResilOpts(fault_plan=FaultPlan(
        1, {"dispatch.error": (4, 4)}), backoff_s=0.0))
    pk.reset_launch_counts()
    card = Router(f.rr, RouterOpts(batch_size=32, resil=rt),
                  device="cuda").route(f.term)
    assert np.array_equal(card.paths, cpu.paths)
    assert card.wirelength == cpu.wirelength
    assert pk.mode_launch_counts()["planes_relax_full_cuda"][0] > 0
    # on one card the mesh ladder's top level is the cluster kernel
    r = Router(f.rr, RouterOpts(batch_size=32, mesh_shards=2,
                                resil=Resilience(ResilOpts())),
               device="cuda")
    assert r._active_row_mesh(r.opts.resil.ladder) is r.row_mesh
    assert TS.uses_cluster(r.row_mesh, r.pg.device)
    rt = Resilience(ResilOpts(fault_plan=FaultPlan(
        1, {"dispatch.error": (6, 6)}), backoff_s=0.0))
    with pytest.raises(DispatchPoisonedError):
        Router(f.rr, RouterOpts(batch_size=32, resil=rt),
               device="cuda").route(f.term)


# ---- long scan lines (up to planes_kernels.MAX_LINE) -------------------

# thin and square canvases past the old 64-cell limit: 6 x 63 overflowed
# the parent's scan scratch; 66 x 66 at W=8 keeps its state in global
# memory (mode 0)
LONG_CANVASES = [(6, 63), (6, 72), (72, 6), (66, 66)]
LONG_COSTS = [("f32", "exact"), ("f32", "jitter"), ("f32", "crit"),
              (BF, "jitter"), (BF, "crit")]


def _long_instance(nx, ny, seed, costs, device, W=8, B=8):
    """_instance on an nx x ny canvas with a wenter payload at the seeds
    and one net (3) that stops after its first sweep."""
    pg, d0, cc, crit, w0 = _instance(minimal_arch(chan_width=W), nx, ny, B,
                                     seed, costs, device)
    rng = np.random.default_rng(seed + 1)
    w0 = torch.from_numpy(rng.uniform(0, 1e-10, tuple(d0.shape)).astype(
        np.float32)).to(device) * (d0 == 0)
    d0[3] = float("inf")
    return pg, d0, cc, crit, w0


def _plan_matches_mirror(kind, v):
    """The C planner's threads, bytes and auto mode of a launch table
    equal the Python mirror's (route/planes_kernels.py)."""
    lib = pk.LIB.get()
    W, X, Y = int(v[1]), int(v[2]), int(v[3])
    assert lib.planes_relax_max_line() == pk.MAX_LINE
    assert lib.planes_relax_max_cells() == pk.MAX_CELLS
    assert lib.planes_relax_threads(kind, v) == int(v[9]) == \
        pk.plan_threads(kind, W, X, Y)
    for m in (0, 1, 2):
        assert lib.planes_relax_smem(kind, m, v) == \
            pk.smem_bytes(kind, m, W, X, Y)
    if int(v[10]) < 0:
        assert lib.planes_relax_mode(kind, v) == pk.auto_mode(kind, W, X, Y)


@pytest.mark.parametrize("pd,costs", LONG_COSTS)
@pytest.mark.parametrize("nx,ny", LONG_CANVASES)
def test_long_lines_full_kernel_matches_plain(cuda, nx, ny, pd, costs):
    """K1 on canvases past the old scan line limit, in its auto mode and
    every mode below it: dist, pred, wenter and stats bit-identical to
    the plain version; the C planner equals the mirror."""
    inst = _long_instance(nx, ny, 100 + nx + ny, costs, cuda)
    pg = inst[0]
    ref = P.planes_relax_plain(*inst, 48, pd)
    got = pk.planes_relax_full_cuda(*inst, 48, plane_dtype=pd)
    torch.cuda.synchronize()
    auto = pk.planes_relax_full_cuda.last_mode
    W, NX, NYp1 = pg.shape_x
    assert auto == pk.auto_mode(pk.FULL, W, NX, NYp1 - 1)
    assert auto == (0 if (nx, ny) == (66, 66) else 2)
    _same(got, ref)
    for m in range(auto):
        _same(pk.planes_relax_full_cuda(*inst, 48, mode=m, plane_dtype=pd),
              ref)
    plan = pk._plan(pk.FULL, pg, 8, inst[1].device, None,
                    plane_dtype=pd)
    _plan_matches_mirror(pk.FULL, plan.run.v)


@pytest.mark.parametrize("pd,costs", LONG_COSTS)
@pytest.mark.parametrize("shape,modes", [
    ((2, 6, 100), (0, 1, 2)),
    # 1,000-cell lines: 512 threads, mode 2 does not fit
    ((2, 4, 1000), (0, 1))])
def test_long_lines_forced_modes_match_plain(cuda, shape, modes, pd,
                                             costs):
    """Every shared-memory mode that fits a long thin canvas at a small
    W, forced, for K1 and the cluster kernel (2 shards): bit-identical
    to the plain versions."""
    W, nx, ny = shape
    inst = _long_instance(nx, ny, 7 * nx + ny, costs, cuda, W=W)
    pg = inst[0]
    ref = P.planes_relax_plain(*inst, 40, pd)
    cap = TS.sweep_cap(24, 2)
    mesh = TS.make_row_mesh(2, "ppermute", [inst[1].device] * 2)
    ref_s = TS.planes_relax_sharded_plain(*inst, 24, mesh, pd)
    assert pk.auto_mode(pk.FULL, W, nx, ny) == modes[-1]
    for m in modes:
        got = pk.planes_relax_full_cuda(*inst, 40, mode=m, plane_dtype=pd)
        torch.cuda.synchronize()
        assert pk.planes_relax_full_cuda.last_mode == m
        _same(got, ref)
        _plan_matches_mirror(pk.FULL, pk._plan(
            pk.FULL, pg, 8, inst[1].device, m, plane_dtype=pd).run.v)
        got = pk.planes_relax_cluster_cuda(*inst, cap, 2, mode=m,
                                           plane_dtype=pd)
        torch.cuda.synchronize()
        _same(got, ref_s)
    assert pk.plan_threads(pk.FULL, W, nx, ny) == (512 if ny > 907 else
                                                   pk.threads_for(
                                                       pg.ncells))


@pytest.mark.parametrize("pd,costs", LONG_COSTS)
def test_long_lines_cropped_kernel_matches_plain(cuda, pd, costs):
    """K2 on 8 x 128 tiles of a 10 x 160 canvas, origins that wrap and
    clamp, every mode that fits: bit-identical to the plain version."""
    inst = _long_instance(10, 160, 31, costs, cuda)
    pg = inst[0]
    rng = np.random.default_rng(32)
    ox, oy = _origins(rng, 10, 8, cuda), _origins(rng, 160, 8, cuda)
    args = (*inst, 48, ox, oy, 8, 128)
    ref = P.planes_relax_cropped_plain(*args, plane_dtype=pd)
    got = pk.planes_relax_cropped_cuda(*args, plane_dtype=pd)
    torch.cuda.synchronize()
    auto = pk.planes_relax_cropped_cuda.last_mode
    assert auto == pk.auto_mode(pk.TILE, 8, 8, 128)
    _same(got, ref)
    for m in range(auto):
        _same(pk.planes_relax_cropped_cuda(*args, mode=m, plane_dtype=pd),
              ref)
    _plan_matches_mirror(pk.TILE, pk._plan(
        pk.TILE, pg, 8, inst[1].device, None, (8, 128),
        plane_dtype=pd).run.v)


@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("pd,costs", [("f32", "exact"), ("f32", "crit"),
                                      (BF, "jitter"), (BF, "crit")])
@pytest.mark.parametrize("nx,ny", LONG_CANVASES)
def test_long_lines_sharded_kernels_match_plain(cuda, nx, ny, pd, costs, s,
                                                impl):
    """The peer kernel (lag 1 and 2) and, under lag 1, the cluster kernel
    on one card on canvases past the old limit: bit-identical to the
    plain per-sweep loop (_peer_case); the C planner equals the
    mirror."""
    inst = _long_instance(nx, ny, 200 + s + nx, costs, cuda)
    _peer_case(s, inst, None, impl, pd)
    pg = inst[0]
    card = inst[1].device
    plan = pk._plan(pk.CLUSTER, pg, 8, card, None, shards=s, plane_dtype=pd)
    _plan_matches_mirror(pk.CLUSTER, plan.run.v)
    peer = pk._peer_plan(pg, 8, (card,) * s, None, pd)
    _plan_matches_mirror(pk.PEER, peer.cards[0][2])


@pytest.mark.parametrize("nx,ny", [(6, 72), (72, 6), (66, 66)])
def test_long_lines_route_cuda_matches_cpu(cuda, nx, ny):
    """The 15-LUT parity netlist placed on a thin or a 66 x 66 grid: the
    route on the card (K1 launched) equals the port's CPU route, path
    for path; legal."""
    from parallel_eda_tpu_torch.flow import prepare
    from parallel_eda_tpu_torch.netlist.generate import generate_circuit

    arch = minimal_arch(chan_width=10)
    f = prepare(generate_circuit(num_luts=15, num_inputs=6, num_outputs=6,
                                 K=arch.K, seed=3), arch, 10, nx=nx, ny=ny)
    rc = Router(f.rr, RouterOpts(batch_size=32), device="cpu").route(f.term)
    pk.reset_launch_counts()
    rg = Router(f.rr, RouterOpts(batch_size=32), device=cuda).route(f.term)
    assert pk.planes_relax_full_cuda.launches > 0
    assert (rg.wirelength, rg.iterations, rg.total_relax_steps) == (
        rc.wirelength, rc.iterations, rc.total_relax_steps)
    assert np.array_equal(rg.paths, rc.paths)
    assert np.array_equal(rg.occ, rc.occ)
    check_route(f.rr, f.term, rg.paths, occ=rg.occ)


def test_router_refuses_a_line_past_the_limit_on_card(cuda):
    """A CUDA Router raises KernelShapeError for a grid side past the
    limit before any work; the same shapes launch below it."""
    rr = build_rr_graph(minimal_arch(chan_width=2),
                        DeviceGrid(1, pk.MAX_LINE + 1, 1))
    with pytest.raises(pk.KernelShapeError):
        Router(rr, RouterOpts(batch_size=8), device=cuda)
