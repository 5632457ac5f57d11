"""Long scan lines: grids with a side past 64 cells, which the card's
relaxation kernels take up to planes_kernels.MAX_LINE.

The planner (route/planes_kernels.py, the mirror of csrc/planes_relax.cu's
plan_threads / smem_bytes / auto_mode) is held, for every kernel kind,
over thin and square blocks up to the limit: mode 0 fits at the
planner's threads, so every shape up to the limit has a mode; square
shapes inside the old 64-cell limit keep the plan they had (the same
threads, mode and bytes: no bench or scale launch changes plan); and the
limit check raises only above the limit, from Router.__init__ on a card
before any work.  The 15-LUT parity netlist placed on thin grids (6 x 72
and, under ``slow``, 72 x 6 and 6 x 63) routes on the CPU exactly as the
JAX Router routes it: the route the card's kernels are held to."""

import types

import numpy as np
import pytest
import torch

from parallel_eda_tpu.arch.builtin import minimal_arch as jax_minimal_arch
from parallel_eda_tpu.flow import prepare as jax_prepare
from parallel_eda_tpu.netlist.generate import (
    generate_circuit as jax_generate_circuit)
from parallel_eda_tpu.route import Router as JRouter
from parallel_eda_tpu.route import RouterOpts as JOpts
from parallel_eda_tpu_torch.arch.builtin import minimal_arch
from parallel_eda_tpu_torch.flow import prepare
from parallel_eda_tpu_torch.netlist.generate import generate_circuit
from parallel_eda_tpu_torch.route import planes_kernels as PK
from parallel_eda_tpu_torch.route import router as TR
from parallel_eda_tpu_torch.route.check import check_route

KINDS = (PK.FULL, PK.PEER, PK.TILE, PK.CLUSTER)
# the 15-LUT parity netlist (tests/test_torch_route.py FIXTURE) placed
# on a grid of the given size
NETLIST = dict(num_luts=15, num_inputs=6, num_outputs=6, seed=3)
CHAN_WIDTH = 10


def _cells(W, X, Y):
    return W * X * (Y + 1) + W * (X + 1) * Y


def _parent_plan(kind, mode, W, X, Y):
    """(threads, bytes) of a launch as planned before the per-plane scan
    scratch: threads from the cell count alone and every warp's scratch
    the longest line times the shortest line's group count."""
    threads = PK.threads_for(_cells(W, X, Y))
    scratch = (2 * max(X, Y) + 1) * (32 // PK._line_lanes(min(X, Y)))
    return threads, (4 * (mode * _cells(W, X, Y) + threads // 32 * scratch)
                     + (8 if kind == PK.CLUSTER else 0))


def _parent_mode(kind, W, X, Y):
    for mode in (2, 1):
        if _parent_plan(kind, mode, W, X, Y)[1] <= PK.SMEM_OPTIN:
            return mode
    return 0


# lines up to the limit: every length through 140 (the lane groups'
# steps), then a stride, and the thread plan's edges
LENGTHS = sorted(set(range(1, 141)) | set(range(141, PK.MAX_LINE, 29))
                 | {255, 256, 257, 512, 907, 908, 1024, PK.MAX_LINE - 1,
                    PK.MAX_LINE})
SIDES = (1, 2, 6, 8, 25)
WIDTHS = (1, 2, 3, 7, 10, 20, 64, 150, 300)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the route's results do not depend on the thread
    count: its float reductions are min and max)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_max_line_is_named_and_at_least_1024():
    assert PK.MAX_LINE == 1815 >= 1024
    # mode 0 at the fewest threads fits the limit's line, not one more
    assert PK._smem(PK.CLUSTER, 0, 1, PK.MAX_LINE, 1, PK.MIN_THREADS) \
        <= PK.SMEM_OPTIN
    assert PK._smem(PK.CLUSTER, 0, 1, PK.MAX_LINE + 1, 1,
                    PK.MIN_THREADS) > PK.SMEM_OPTIN


@pytest.mark.parametrize("kind", KINDS)
def test_planner_fits_every_line_up_to_the_limit(kind):
    """Thin blocks of both orientations and W from 1 to 300: the planner's
    threads keep mode 0 within the card's limit, auto_mode picks the
    most shared state that fits, the plan never takes more bytes than
    the parent's formula, and the shape passes the limit check."""
    for W in WIDTHS:
        for side in SIDES:
            for n in LENGTHS:
                for X, Y in ((side, n), (n, side)):
                    th = PK.plan_threads(kind, W, X, Y)
                    assert th in (PK.MIN_THREADS, 1024)
                    assert th == PK.threads_for(_cells(W, X, Y)) or \
                        max(X, Y) > 907
                    assert PK.smem_bytes(kind, 0, W, X, Y) <= PK.SMEM_OPTIN
                    mode = PK.auto_mode(kind, W, X, Y)
                    assert PK.smem_bytes(kind, mode, W, X, Y) <= \
                        PK.SMEM_OPTIN
                    assert mode == 2 or PK.smem_bytes(
                        kind, mode + 1, W, X, Y) > PK.SMEM_OPTIN
                    if th == PK.threads_for(_cells(W, X, Y)):
                        assert PK.smem_bytes(kind, mode, W, X, Y) <= \
                            _parent_plan(kind, mode, W, X, Y)[1]
                    PK.check_kernel_shape(kind, W, X, Y)


@pytest.mark.parametrize("kind", KINDS)
def test_planner_keeps_square_plans(kind):
    """Every square shape inside the old 64-cell limit keeps its threads,
    mode and bytes in every mode (bench K1 (12, 6, 6), scale K1 (20, 25,
    25), the CLI's k6_n10 (40, 9, 9) among them)."""
    for W in range(1, 301):
        for n in range(1, 64):
            assert PK.plan_threads(kind, W, n, n) == \
                _parent_plan(kind, 0, W, n, n)[0]
            assert PK.auto_mode(kind, W, n, n) == _parent_mode(kind, W, n, n)
            for mode in (0, 1, 2):
                assert PK.smem_bytes(kind, mode, W, n, n) == \
                    _parent_plan(kind, mode, W, n, n)[1]


def test_planner_thin_shapes():
    """The thin canvas the parent overflowed (W=10, 6 x 63: 260,096 bytes
    in mode 0) now fits mode 2; the scale mesh-4 block (20, 9, 25) keeps
    mode 2 at fewer bytes; a line past ~900 cells halves the threads."""
    assert _parent_plan(PK.FULL, 0, 10, 6, 63)[1] == 260096 > PK.SMEM_OPTIN
    assert PK.smem_bytes(PK.FULL, 0, 10, 6, 63) == 65024
    assert PK.auto_mode(PK.FULL, 10, 6, 63) == 2
    assert _parent_plan(PK.CLUSTER, 2, 20, 9, 25)[1] == 181896
    assert PK.smem_bytes(PK.CLUSTER, 2, 20, 9, 25) == 129672
    assert PK.auto_mode(PK.CLUSTER, 20, 9, 25) == 2
    assert PK.plan_threads(PK.FULL, 2, 4, 907) == 1024
    assert PK.plan_threads(PK.FULL, 2, 4, 908) == 512
    assert PK.plan_threads(PK.FULL, 8, 66, 66) == 1024
    assert PK.auto_mode(PK.FULL, 8, 66, 66) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_check_kernel_shape_raises_only_above_the_limit(kind):
    for W in (1, 10, 300):
        for n in (1, 63, 64, 65, 1024, PK.MAX_LINE):
            PK.check_kernel_shape(kind, W, 6, n)
            PK.check_kernel_shape(kind, W, n, 6)
        for n in (PK.MAX_LINE + 1, 4 * PK.MAX_LINE):
            for X, Y in ((6, n), (n, 6)):
                with pytest.raises(PK.KernelShapeError) as e:
                    PK.check_kernel_shape(kind, W, X, Y, what="grid")
                msg = str(e.value)
                assert PK.KIND_NAMES[kind] in msg
                assert str(PK.MAX_LINE) in msg and "grid" in msg
                assert isinstance(e.value, ValueError)
    # the cells of a net: int32 cell ids
    with pytest.raises(PK.KernelShapeError, match="cells per net"):
        PK.check_kernel_shape(kind, 1000, PK.MAX_LINE, PK.MAX_LINE)
    PK.check_kernel_shape(kind, 300, PK.MAX_LINE, PK.MAX_LINE)


def test_check_canvas():
    PK.check_canvas((10, 6, 73))
    PK.check_canvas((10, 6, PK.MAX_LINE + 1), 2)
    with pytest.raises(PK.KernelShapeError, match="K1"):
        PK.check_canvas((10, 6, PK.MAX_LINE + 2))
    with pytest.raises(PK.KernelShapeError, match="K1"):
        PK.check_canvas((10, PK.MAX_LINE + 1, 7), 2)
    # a grid whose shard block is wider than the canvas
    PK.check_canvas((10, 1, 7), 16)


def test_router_checks_the_limit_before_any_work(monkeypatch):
    """A Router for a card raises KernelShapeError for a canvas past the
    limit before it touches the graph (here a stand-in that holds
    nothing but the sizes); a CPU Router has no limit."""
    rr = types.SimpleNamespace(chan_width=CHAN_WIDTH,
                               grid=types.SimpleNamespace(nx=6, ny=2000))
    monkeypatch.setattr(TR, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(PK.KernelShapeError, match="grid 6x2000"):
        TR.Router(rr, TR.RouterOpts(batch_size=32), device="cuda")
    with pytest.raises(PK.KernelShapeError, match="K1"):
        TR.Router(rr, TR.RouterOpts(batch_size=32, mesh_shards=2),
                  device="cuda")
    monkeypatch.setattr(TR, "resolve_device", lambda d: torch.device("cpu"))
    with pytest.raises(AttributeError):      # past the check: the graph
        TR.Router(rr, TR.RouterOpts(batch_size=32), device="cpu")


def test_kernel_layout_uses_the_planned_threads():
    """route.kernel.lane_occupancy counts the planner's threads: at W=2 on
    4 x 1100 the block takes 512 threads (its 1,100-cell lines), 39
    rounds of them over 19,808 cells, in mode 1."""
    W, NX, NY = 2, 4, 1100
    lay = PK.kernel_layout((W, NX, NY + 1), (W, NX + 1, NY), 8, 16)
    cells = _cells(W, NX, NY)
    assert cells == 19808
    assert PK.plan_threads(PK.FULL, W, NX, NY) == 512
    assert lay["mode"] == 1
    assert lay["variant"] == "planes_relax_full_cuda/mode1"
    assert lay["lane_occupancy"] == round(cells / (512 * 39), 4) == 0.992
    assert lay["bytes_per_sweep"] == 24 * cells * 8 // 16


_JAX_ROUTES: dict = {}


def _jax_route(nx, ny):
    """The JAX Router's route of the netlist on an nx x ny grid
    (pipeline=False, as tests/test_torch_route.py), one per grid."""
    if (nx, ny) not in _JAX_ROUTES:
        arch = jax_minimal_arch(chan_width=CHAN_WIDTH)
        jf = jax_prepare(jax_generate_circuit(K=arch.K, **NETLIST), arch,
                         CHAN_WIDTH, nx=nx, ny=ny)
        _JAX_ROUTES[nx, ny] = JRouter(jf.rr, JOpts(
            pipeline=False, batch_size=32)).route(jf.term)
    return _JAX_ROUTES[nx, ny]


def _port_flow(nx, ny):
    arch = minimal_arch(chan_width=CHAN_WIDTH)
    return prepare(generate_circuit(K=arch.K, **NETLIST), arch, CHAN_WIDTH,
                   nx=nx, ny=ny)


@pytest.mark.parametrize("nx,ny,want", [
    (6, 72, (675, 11)),
    pytest.param(72, 6, (773, 16), marks=pytest.mark.slow),
    pytest.param(6, 63, None, marks=pytest.mark.slow)])
def test_thin_grid_route_matches_jax(nx, ny, want):
    """The port's CPU route of a thin grid (a side past the old 64-cell
    limit, or 6 x 63, whose scan scratch once overflowed the card's
    shared memory) equals the JAX Router's: paths, occupancy,
    wirelength, iterations and relaxation sweeps; legal."""
    tf = _port_flow(nx, ny)
    assert (tf.grid.nx, tf.grid.ny) == (nx, ny)
    tres = TR.Router(tf.rr, TR.RouterOpts(batch_size=32),
                     device="cpu").route(tf.term)
    jres = _jax_route(nx, ny)
    assert tres.success and jres.success
    if want is not None:
        assert (tres.wirelength, tres.iterations) == want
    assert (tres.wirelength, tres.iterations) == (jres.wirelength,
                                                  jres.iterations)
    assert tres.total_relax_steps == jres.total_relax_steps
    assert np.array_equal(tres.paths, jres.paths)
    assert np.array_equal(tres.occ, jres.occ)
    check_route(tf.rr, tf.term, tres.paths, occ=tres.occ)
