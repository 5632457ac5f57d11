"""The row-sharded relaxation's per-net termination rule
(parallel_eda_tpu_torch/route/planes_shard.py) against the JAX package's
planes_relax_sharded, split from tests/test_torch_shard.py so that the
tier-1 run's workers can take the two modules apart: its JAX references
(one uncached shard_map run each, ~10-17 s here) are most of that
module's time.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the conftest's 8 virtual CPU devices.  Every
comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_eda_tpu.route import planes as JP
from parallel_eda_tpu.route import planes_shard as JS
from parallel_eda_tpu.rr.graph import CHANX, CHANY, build_rr_graph
from parallel_eda_tpu.rr.grid import DeviceGrid
from parallel_eda_tpu_torch.route import planes_shard as TS
from test_torch_planes import to_port
from test_torch_shard import ARCHS

_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's CPU work: its many small ops
    otherwise each wait for a pool of threads that the tier-1 run's six
    workers share (the results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
@pytest.mark.parametrize("impl", ["ppermute", "pallas_halo"])
def test_sharded_relax_per_net_termination(impl, s, arch, costs):
    """The sharded kernels' termination rule: each net stops at its own
    fixpoint — lag 1 ("ppermute", the cluster and peer kernels) at its
    first sweep with no owned change, lag 2 ("pallas_halo", the peer
    kernel) after its second consecutive one.  The plain sharded loop
    run one net at a time, its per-net [executed, useful] max-reduced,
    equals the batch run (every output bit-identical, stats equal) and
    the JAX package's planes_relax_sharded."""
    pg, tpg, args = _costs_instance(arch, costs)
    B = args[0].shape[0]
    mesh = TS.make_row_mesh(s, impl, "cpu")
    batch = TS.planes_relax_sharded(tpg, *(torch.from_numpy(x)
                                           for x in args), 24, mesh)
    nets = [TS.planes_relax_sharded(
        tpg, *(torch.from_numpy(x[b:b + 1]) for x in args), 24, mesh)
        for b in range(B)]
    per_net = torch.stack([n[3] for n in nets])
    # the nets do not all stop at the same sweep; the empty one stops
    # at its first (lag 1) or second (lag 2) stable sweep
    stable = 1 if impl == "ppermute" else 2
    assert per_net[-1].tolist() == [stable, 0] < per_net[0].tolist()
    for k in range(3):
        assert torch.equal(torch.cat([n[k] for n in nets]), batch[k])
    assert torch.equal(per_net.max(0).values, batch[3])
    if impl == "ppermute":
        # lag 1: every output and the stats against the JAX package on
        # this instance
        for a, b in zip(_jax_sharded(arch, s, impl, args), batch):
            assert np.array_equal(a, b.numpy())
        return
    # lag 2: against the JAX package on both cost instances as one batch
    # (one JAX compile for the exact and the jittered case): every output
    # and the joined batch's stats equal, and this instance's rows equal
    # its own batch's
    both = _both_costs(arch)
    key = ("jax sharded", arch, s, impl)
    if key not in _CACHE:
        _CACHE[key] = _jax_sharded(arch, s, impl, both)
    port = TS.planes_relax_sharded(tpg, *(torch.from_numpy(x)
                                          for x in both), 24, mesh)
    for a, b in zip(_CACHE[key], port):
        assert np.array_equal(a, b.numpy())
    rows = slice(0, B) if costs == "exact" else slice(B, 2 * B)
    for k in range(3):
        assert torch.equal(port[k][rows], batch[k])


def _jax_sharded(arch, s, impl, args):
    """JAX's planes_relax_sharded on ``args`` (numpy) as numpy, through
    one jitted function per (arch, shards, schedule): the exact and the
    jittered instance share its compile."""
    key = ("jax fn", arch, s, impl)
    if key not in _CACHE:
        pg = _costs_instance(arch, "exact")[0]
        mesh = JS.make_row_mesh(s, impl)
        _CACHE[key] = jax.jit(
            lambda *a: JS.planes_relax_sharded(pg, *a, 24, mesh))
    return tuple(np.asarray(a) for a in _CACHE[key](
        *(jnp.asarray(x) for x in args)))


def _both_costs(arch):
    """The exact and the jittered cost instance of ``arch`` as one batch
    (numpy arrays, exact first)."""
    pairs = zip(_costs_instance(arch, "exact")[2],
                _costs_instance(arch, "jitter")[2])
    return tuple(np.ascontiguousarray(np.concatenate(p)) for p in pairs)
