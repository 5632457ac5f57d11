"""The (net, node) mesh's net axis on the card against the same route on
the CPU: ``Router(mesh=...)`` on the 15-LUT parity fixture with members
repeating the card (and, with two cards, on distinct cards), the planes
program (K1 on every member) and the ELL program.  Every output equal,
and every planes relaxation a K1 launch at the per-member batch.

Run on a machine with a CUDA device:
    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
Without one, every test here skips (the decision is taken inside the
``cuda`` fixture, never at import)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu_torch.flow import synth_flow
from parallel_eda_tpu_torch.parallel import make_mesh
from parallel_eda_tpu_torch.route import planes as P
from parallel_eda_tpu_torch.route import planes_kernels as pk
from parallel_eda_tpu_torch.route.router import Router, RouterOpts

pytestmark = pytest.mark.gpu

FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _same(a, b):
    assert (a.success, a.iterations, a.wirelength, a.total_relax_steps) == (
        b.success, b.iterations, b.wirelength, b.total_relax_steps)
    for k in ("paths", "occ", "sink_delay"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert [(s.overused_nodes, s.relax_steps, s.batches) for s in a.stats] \
        == [(s.overused_nodes, s.relax_steps, s.batches) for s in b.stats]


@pytest.mark.parametrize("program", ["planes", "ell"])
@pytest.mark.parametrize("n", [2, 4])
def test_net_mesh_route_on_the_card_matches_cpu(cuda, n, program):
    f = synth_flow(**FIXTURE)
    opts = RouterOpts(batch_size=32, program=program)
    cpu = Router(f.rr, opts, mesh=make_mesh(n, devices=["cpu"] * n)).route(
        f.term)
    calls = []
    orig = P.planes_relax

    def log(pg, d0, *a, **k):
        calls.append((d0.device, d0.shape[0]))
        return orig(pg, d0, *a, **k)

    pk.reset_launch_counts()
    P.planes_relax = log
    try:
        card = Router(f.rr, opts, mesh=make_mesh(
            n, devices=[cuda] * n)).route(f.term)
    finally:
        P.planes_relax = orig
    _same(card, cpu)
    per_member = -(-min(32, len(f.term.source)) // n)   # B rounded up
    if program == "planes":
        assert calls and all(c == (cuda, per_member) for c in calls)
        assert pk.launch_counts()["planes_relax_full_cuda"] == len(calls)
    else:
        assert not calls


def test_net_mesh_across_cards_matches_cpu(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    f = synth_flow(**FIXTURE)
    opts = RouterOpts(batch_size=32)
    cpu = Router(f.rr, opts, mesh=make_mesh(2, devices=["cpu"] * 2)).route(
        f.term)
    card = Router(f.rr, opts, mesh=make_mesh(2)).route(f.term)
    _same(card, cpu)
