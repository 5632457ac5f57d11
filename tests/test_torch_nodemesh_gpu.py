"""The node kernel (planes_kernels.planes_relax_node_cuda) on the card
against its plain version (planes.planes_relax_node_plain, on the same
card tensors) and against K1 (planes_relax_full_cuda): every output and
the stats bit-identical, at the bench canvas, a scale-sized canvas, the
long-line shapes 6 x 72 and 72 x 6 and the 66 x 66 canvas, at 2, 3 and
4 members, in every shared-memory mode that fits, f32 and bf16, crit 0
and > 0, at batches the net axis does not divide; members repeating the
card, and (``across_cards``) on distinct cards.  Then node-mesh routes
on the card equal the same routes on the CPU.

Run on a machine with a CUDA device:
    python -m pytest --noconftest -m gpu tests/test_torch_nodemesh_gpu.py
Without one, every test here skips (the decision is taken inside the
``cuda`` fixture, never at import)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu_torch.arch.builtin import minimal_arch
from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.parallel import make_mesh
from parallel_eda_tpu_torch.route import planes as P
from parallel_eda_tpu_torch.route import planes_kernels as pk
from parallel_eda_tpu_torch.route.router import Router, RouterOpts
from parallel_eda_tpu_torch.rr.graph import CHANX, CHANY, build_rr_graph
from parallel_eda_tpu_torch.rr.grid import DeviceGrid

pytestmark = pytest.mark.gpu

# (name, nx, ny, W): the bench canvas (60 LUTs, W = 12: 6 x 6), a
# scale-sized one, the long-line shapes and the canvas past shared memory
SHAPES = [("bench", 6, 6, 12), ("scale", 25, 25, 20), ("6x72", 6, 72, 10),
          ("72x6", 72, 6, 10), ("66x66", 66, 66, 10)]
FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)
_GRAPHS: dict = {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _graph(name, nx, ny, w, device):
    key = (name, str(device))
    if key not in _GRAPHS:
        a = minimal_arch(chan_width=w)
        rr = build_rr_graph(a, DeviceGrid(nx, ny, a.io_capacity))
        _GRAPHS[key] = (rr, P.build_planes(rr, device))
    return _GRAPHS[key]


def _instance(rr, pg, B, seed, crit_on):
    """Two random wire seeds a net, jittered congestion, crit 0 or
    uniform in [0, 0.8), an entry-delay payload at the seeds."""
    rng = np.random.default_rng(seed)
    N = rr.num_nodes
    noc = pg.node_of_cell.cpu().numpy()
    wires = np.where((rr.node_type == CHANX) | (rr.node_type == CHANY))[0]
    seed_m = np.zeros((B, N), bool)
    for b in range(B):
        seed_m[b, rng.choice(wires, 2, replace=False)] = True
    cong = (rng.uniform(0.5, 2.0, (B, N)) * 1e-10).astype(np.float32)
    crit = (rng.uniform(0, 0.8, (B, 1, 1, 1)) if crit_on
            else np.zeros((B, 1, 1, 1))).astype(np.float32)
    d0 = np.where(seed_m[:, noc], 0.0, np.inf).astype(np.float32)
    w0 = np.where(d0 == 0, rng.uniform(0, 1e-10, d0.shape), 0.0).astype(
        np.float32)
    dev = pg.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (d0, cong[:, noc], crit, w0))


def _equal(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.cpu(), b.cpu()), k


@pytest.mark.parametrize("pd", ["f32", "bf16"])
@pytest.mark.parametrize("crit_on", [False, True])
@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s[0])
def test_node_kernel_matches_plain_and_k1(cuda, shape, m, crit_on, pd):
    """One launch per call (every member on the card); B = 7 nets."""
    rr, pg = _graph(*shape, cuda)
    inst = _instance(rr, pg, 7, shape[1] * 31 + m, crit_on)
    devs = [cuda] * m
    n0 = pk.launch_counts()["planes_relax_node_cuda"
                            + ("[bf16]" if pd == "bf16" else "")]
    got = pk.planes_relax_node_cuda(pg, *inst, 48, devs, plane_dtype=pd)
    assert pk.launch_counts()["planes_relax_node_cuda"
                              + ("[bf16]" if pd == "bf16" else "")] == n0 + 1
    _equal(got, pk.planes_relax_full_cuda(pg, *inst, 48, plane_dtype=pd))
    _equal(got, P.planes_relax_node_plain(pg, *inst, 48, devs, pd))
    for mode in range(pk.planes_relax_node_cuda.last_mode):
        _equal(pk.planes_relax_node_cuda(pg, *inst, 48, devs, mode=mode,
                                         plane_dtype=pd), got)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_planes_relax_node_mesh_on_the_card(cuda, shape):
    """planes_relax with a node mesh of the card (B = 6: not a multiple
    of 4 members, nor of 2 at the net axis's 3) = K1 on the whole batch;
    every relaxation the node kernel."""
    rr, pg = _graph(*SHAPES[0], cuda)
    inst = _instance(rr, pg, 6, 5, True)
    n = shape[0] * shape[1]
    pk.reset_launch_counts()
    got = P.planes_relax(pg, *inst, 48,
                         mesh=make_mesh(n, shape=shape, devices=[cuda] * n))
    assert pk.launch_counts()["planes_relax_node_cuda"] == shape[0]
    assert pk.launch_counts()["planes_relax_full_cuda"] == 0
    _equal(got, pk.planes_relax_full_cuda(pg, *inst, 48))


@pytest.mark.parametrize("pd", ["f32", "bf16"])
def test_node_kernel_across_cards(cuda, pd):
    """The members on distinct cards (one launch per card, the inboxes
    and flag words over NVLink) = the members on one card = K1."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    rr, pg = _graph(*SHAPES[1], cuda)
    inst = _instance(rr, pg, 9, 3, True)
    for m in sorted({2, min(n, 4)}):
        devs = [cuda] + [torch.device("cuda", (cuda.index + k) % n)
                         for k in range(1, m)]
        got = pk.planes_relax_node_cuda(pg, *inst, 48, devs,
                                        plane_dtype=pd)
        _equal(got, pk.planes_relax_node_cuda(pg, *inst, 48, [cuda] * m,
                                              plane_dtype=pd))
        _equal(got, pk.planes_relax_full_cuda(pg, *inst, 48,
                                              plane_dtype=pd))


def _same(a, b):
    assert (a.success, a.iterations, a.wirelength, a.total_relax_steps) == (
        b.success, b.iterations, b.wirelength, b.total_relax_steps)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert [(s.overused_nodes, s.relax_steps, s.batches) for s in a.stats] \
        == [(s.overused_nodes, s.relax_steps, s.batches) for s in b.stats]


@pytest.mark.parametrize("program", ["planes", "ell"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_node_mesh_route_on_the_card_matches_cpu(cuda, shape, program):
    """The 15-LUT parity fixture over a node mesh of the card = the same
    route over a node mesh of the CPU (the batch of 32 rounded up to 33
    at net axis 3); every planes relaxation the node kernel."""
    f = synth_flow(**FIXTURE)
    n = shape[0] * shape[1]
    opts = RouterOpts(batch_size=32, program=program)
    cpu = Router(f.rr, opts, mesh=make_mesh(
        n, shape=shape, devices=["cpu"] * n)).route(f.term)
    pk.reset_launch_counts()
    card = Router(f.rr, opts, mesh=make_mesh(
        n, shape=shape, devices=[cuda] * n)).route(f.term)
    _same(card, cpu)
    c = pk.launch_counts()
    if program == "planes":
        assert c["planes_relax_node_cuda"] > 0
        assert c["planes_relax_full_cuda"] == 0
    else:
        assert not any(c.values())


def test_node_mesh_route_across_cards_matches_cpu(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    f = synth_flow(**FIXTURE)
    opts = RouterOpts(batch_size=32)
    cpu = Router(f.rr, opts, mesh=make_mesh(
        2, shape=(1, 2), devices=["cpu"] * 2)).route(f.term)
    card = Router(f.rr, opts, mesh=make_mesh(2, shape=(1, 2))).route(
        f.term)
    _same(card, cpu)
