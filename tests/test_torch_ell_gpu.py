"""The ELL program on the card against the same program on the CPU:
``Router(program="ell")`` routes on the 15-LUT parity fixture and the
16x16 big-grid fixture (windowed, global, sink_group 0 and 1, astar_fac
1.2), and the search's pieces where ties decide: the relaxations on
power-of-two costs (first-index argmin) and conflict_subset with K below
the overused count (top-k's index-ascending ties).  Every output equal.

The ELL program is plain PyTorch (no hand-written kernel: the JAX
package computes it with XLA ops outside any Pallas kernel).

Run on a machine with a CUDA device:
    python -m pytest --noconftest -m gpu tests/test_torch_ell_gpu.py
Without one, every test here skips (the decision is taken inside the
``cuda`` fixture, never at import)."""

import numpy as np
import pytest
import torch

from parallel_eda_tpu_torch.arch.builtin import minimal_arch
from parallel_eda_tpu_torch.flow import prepare, synth_flow
from parallel_eda_tpu_torch.netlist.generate import generate_circuit
from parallel_eda_tpu_torch.route import search as S
from parallel_eda_tpu_torch.route.check import check_route
from parallel_eda_tpu_torch.route.device_graph import to_device
from parallel_eda_tpu_torch.route.router import Router, RouterOpts

pytestmark = pytest.mark.gpu

FIXTURE = dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
               seed=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flow(fixture):
    if fixture == "fixture":
        return synth_flow(**FIXTURE)
    nl = generate_circuit(num_luts=20, num_inputs=4, num_outputs=4, K=4,
                          seed=9)
    return prepare(nl, minimal_arch(chan_width=10), chan_width=10, nx=16,
                   ny=16, seed=9)


def _result(res) -> dict:
    out = {k: np.array(getattr(res, k)) for k in (
        "success", "iterations", "wirelength", "total_net_routes",
        "total_relax_steps", "widened_nets", "windowed_nets")}
    out.update(paths=res.paths, occ=res.occ, sink_delay=res.sink_delay,
               stats=np.array([(s.iteration, s.overused_nodes,
                                s.overuse_total, s.rerouted_nets,
                                s.relax_steps, s.batches)
                               for s in res.stats]))
    return out


@pytest.mark.parametrize("fixture,fields", [
    ("fixture", dict(sink_group=0)),
    ("fixture", dict(sink_group=1)),
    ("big", dict(sink_group=1)),
    ("big", dict(sink_group=0, astar_fac=1.2)),
    ("big", dict(sink_group=1, windowed=False)),
])
def test_ell_route_card_equals_cpu(cuda, fixture, fields):
    f = _flow(fixture)
    opts = RouterOpts(batch_size=32, program="ell", **fields)
    card = Router(f.rr, opts, device=cuda).route(f.term)
    cpu = Router(f.rr, opts, device="cpu").route(f.term)
    assert card.success
    check_route(f.rr, f.term, card.paths, occ=card.occ)
    a, b = _result(card), _result(cpu)
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    if fixture == "big" and fields.get("windowed", True):
        assert card.windowed_nets > 0.3 * f.term.num_nets


def _pow2_relax_inputs(f, device, B=8, seed=2):
    """A batch of seeded relaxations on power-of-two costs (exact sums,
    so equal candidates tie), with crit 0 and crit 0.5."""
    rng = np.random.default_rng(seed)
    rr, term = f.rr, f.term
    N = rr.num_nodes
    dev = to_device(rr, device, ell=True)
    cong = np.ldexp(1.0, rng.integers(-33, -30, (B, N))).astype(np.float32)
    seed_m = np.zeros((B, N), bool)
    seed_m[np.arange(B), term.source[:B]] = True
    bb = np.stack([term.bb_xmin, term.bb_xmax, term.bb_ymin,
                   term.bb_ymax], axis=1).astype(np.int32)[:B]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dev, t(cong), t(seed_m), t(bb)


@pytest.mark.parametrize("crit", [0.0, 0.5])
def test_relax_ties_card_equals_cpu(cuda, crit):
    """The global relaxation on tie-heavy power-of-two costs: dist, prev,
    tdel and the step count equal on the card and the CPU."""
    f = _flow("fixture")
    out = []
    for device in (cuda, torch.device("cpu")):
        dev, cong, seed, bb = _pow2_relax_inputs(f, device)
        B, N = cong.shape
        crit_c = torch.full((B, 1), crit, device=device)
        r = S._relax(dev, cong, crit_c, S._bb_inside(dev, bb), seed,
                     torch.zeros((B, N), device=device), 200)
        out.append([x.cpu() for x in r])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int(out[0][3]) > 2


def test_window_tables_and_local_relax_card_equal_cpu(cuda):
    """build_windows and the windowed relaxation (A* gate) on the
    big-grid fixture, power-of-two costs."""
    f = _flow("big")
    term = f.term
    out = []
    for device in (cuda, torch.device("cpu")):
        dev = to_device(f.rr, device, ell=True)
        bbs = torch.from_numpy(np.stack(
            [term.bb_xmin, term.bb_xmax, term.bb_ymin, term.bb_ymax],
            axis=1).astype(np.int32)).to(device)
        win = S.build_windows(dev, bbs, 1024)
        B, Nbox = win.win_nodes.shape
        rng = np.random.default_rng(5)
        cong = torch.from_numpy(np.ldexp(1.0, rng.integers(
            -33, -30, (B, Nbox))).astype(np.float32)).to(device)
        src, _ = S._to_local(win.win_nodes, torch.from_numpy(
            term.source[:, None].astype(np.int32)).to(device))
        sinks = torch.from_numpy(term.sinks.astype(np.int32)).to(device)
        sink_loc, sink_in = S._to_local(win.win_nodes, sinks.clamp(min=0))
        seed = torch.zeros((B, Nbox + 1), dtype=torch.bool, device=device)
        seed.scatter_(1, src, True)
        r = S._relax_local(
            win.lsrc, win.ldelay, cong, torch.full((B, 1), 0.25,
                                                   device=device),
            torch.zeros((B, Nbox), device=device), seed[:, :Nbox],
            torch.zeros((B, Nbox), device=device), sink_loc,
            (sinks >= 0) & sink_in, 200)
        out.append([x.cpu() for x in (win.win_nodes, win.lsrc,
                                      win.ldelay, *r)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_conflict_subset_ties_card_equals_cpu(cuda):
    """conflict_subset with K below the overused count: the K most
    overused nodes, ties by ascending id (lax.top_k), on both devices."""
    f = _flow("big")
    rng = np.random.default_rng(7)
    R, Smax = f.term.sinks.shape
    N = f.rr.num_nodes
    occ = rng.integers(0, 4, N).astype(np.int32)
    paths = rng.integers(0, 400, (R, Smax, 12)).astype(np.int32)
    idx = np.concatenate([np.arange(R - 3), -np.ones(3)]).astype(np.int32)
    out = []
    for device in (cuda, torch.device("cpu")):
        dev = to_device(f.rr, device, ell=True)

        def t(a):
            return torch.from_numpy(a).to(device)
        out.append(S.conflict_subset(dev, t(occ), t(paths), t(idx),
                                     16).cpu())
    assert torch.equal(out[0], out[1])
    assert int(out[0].sum()) > R
