"""The (net, node) mesh's node axis in the port (route/nodesplit.py,
planes.planes_relax_node, the ELL relaxation's row split) against the
JAX package's mesh on the 8-device virtual CPU mesh of tests/conftest.py
(the port's members are "cpu": ``make_mesh(n, shape=..., devices=["cpu"]
* n)``).  Exact equality throughout, unless a case says otherwise.

All tier-1: the cross-segment scan's schedule against the one-device
scan; the column segmentation rule; the kernel's tables; the node
relaxation against one device on every arch family; planes_relax at
node meshes (1, 2), (1, 4) and (2, 2) against JAX's planes_relax(mesh=
...) (crit > 0 references in a subprocess under the AVX flag, ROADMAP
C2); ShardedRouter.route_step at (1, 8), (2, 4) and (4, 2).  The routes
over node meshes are in tests/test_torch_nodemesh_route.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tests.test_torch_parallel import (  # noqa: E402
    STEP_FIXTURE, STEP_STATICS, _ORDER, _step_inputs)

NODE_MESHES = [(1, 2), (1, 4), (2, 2)]
# the crit > 0 relaxation instance (the minimal graph of the shard tests)
CRIT_GRAPH = ("minimal", 6, 5, 31)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small-op CPU work: one PyTorch thread (six xdist workers share
    the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    from parallel_eda_tpu_torch.parallel import make_mesh

    n = shape[0] * shape[1]
    return make_mesh(n, shape=shape, devices=["cpu"] * n)


def jax_mesh(shape):
    from parallel_eda_tpu.parallel.shard import make_mesh

    return make_mesh(shape[0] * shape[1], shape=shape)


# --------------------------------------------------------------------------
# the cross-segment scan and the segmentation rule


def _segments(rng, n, k):
    """k contiguous segments covering 0..n; from three segments on, one
    is empty and one holds a single column."""
    if k >= 3 and n >= 1:
        lens = np.zeros(k, np.int64)
        e, one = rng.choice(k, 2, replace=False)
        lens[one] = 1
        rest = [j for j in range(k) if j not in (e, one)]
        lens[rest] = rng.multinomial(n - 1, [1 / len(rest)] * len(rest))
    else:
        cuts = np.sort(rng.integers(0, n + 1, k - 1))
        lens = np.diff(np.concatenate([[0], cuts, [n]]))
    ends = np.cumsum(lens)
    return tuple((int(b - a), int(b)) for a, b in zip(lens, ends))


def _lines(rng, n):
    """Jittered, non-power-of-two costs (some 0: no span break, some
    INF) and sparse finite initial values, [4, 3, n]."""
    c = (rng.uniform(0.5, 2.0, (4, 3, n)) * 1.37e-10).astype(np.float32)
    c[rng.random(c.shape) < 0.25] = 0.0
    c[rng.random(c.shape) < 0.05] = np.inf
    d = np.where(rng.random((4, 3, n)) < 0.3,
                 rng.uniform(0, 1e-9, (4, 3, n)), np.inf).astype(np.float32)
    return torch.from_numpy(c), torch.from_numpy(d)


@pytest.mark.parametrize("k", range(1, 9))
def test_decomposed_scan_bit_identical(k):
    """nodesplit's scan (each member's phase 1, the published values
    exchanged, each member's phase 2) = planes._minplus_scan, both
    directions, for every line length n from 1 to 300 with n % 8 = k - 1
    cut into k segments, and (k = 7, 8) n = 907 and 1,815, which are
    also held against the JAX package's scan."""
    import jax
    import jax.numpy as jnp

    from parallel_eda_tpu.route import planes as JP
    from parallel_eda_tpu_torch.route import nodesplit as NS
    from parallel_eda_tpu_torch.route.planes import _minplus_scan

    rng = np.random.default_rng(k)
    ns = [n for n in range(1, 301) if n % 8 == k - 1]
    long = {7: [907], 8: [1815]}.get(k, [])
    for n in ns + long:
        c, d = _lines(rng, n)
        segs = _segments(rng, n, k)
        for rev in (False, True):
            got = NS.decomposed_scan(c, d, segs, rev)
            assert torch.equal(got, _minplus_scan(d, c, 2, rev)), (n, segs)
            if n in long:
                want = jax.jit(lambda a, b: JP._minplus_scan(a, b, 2, rev))(
                    jnp.asarray(d.numpy()), jnp.asarray(c.numpy()))
                assert np.array_equal(np.asarray(want), got.numpy())


def test_schedule_publishes_what_the_others_read():
    """Each published value goes to the members that inject it, and
    only there; no member evaluates more combines than the one-device
    tree has; a member's phase 1 reads only its own cells."""
    from parallel_eda_tpu_torch.route import nodesplit as NS

    for n, segs in ((25, NS.x_segments(25, 4)), (13, ((0, 5), (5, 5),
                                                      (5, 6), (6, 13))),
                    (64, ((0, 31), (31, 33), (33, 64)))):
        ntree = sum(len(lv) for lv in NS.tree_levels(n))
        for rev in (False, True):
            sch = NS.scan_schedule(n, segs, rev)
            readers = {}
            for k, ms in enumerate(sch.members):
                for _, a in ms.inject:
                    readers[a] = readers.get(a, 0) | (1 << k)
                assert ms.ncombines <= ntree
                assert len(ms.in_slot) == len(ms.out_slot) == \
                    segs[k][1] - segs[k][0]
                local = set(ms.in_slot)
                for lv in ms.levels1:
                    for a, b, o in lv:
                        assert a in local and b in local
                        local.add(o)
            pub = {a: mask for ms in sch.members for _, a, mask in ms.publish}
            assert pub == readers
            assert sorted(pub) == list(range(sch.natoms))


def test_segmentation_rule():
    """kx = max(2, ceil((NX + 2) / m)) columns a member (the row mesh's
    block width); the y plane's last column goes with the segment that
    reaches NX; members past NX take no part."""
    from parallel_eda_tpu_torch.route import nodesplit as NS

    assert NS.x_segments(6, 2) == ((0, 4), (4, 6))
    assert NS.y_segments(6, 2) == ((0, 4), (4, 7))
    assert NS.x_segments(6, 4) == ((0, 2), (2, 4), (4, 6), (6, 6))
    assert NS.y_segments(6, 4) == ((0, 2), (2, 4), (4, 6), (6, 7))
    assert NS.active_members(6, 8) == 4
    assert NS.x_segments(25, 4) == ((0, 7), (7, 14), (14, 21), (21, 25))
    assert NS.y_segments(25, 4)[-1] == (21, 26)
    for NX in range(1, 40):
        for m in range(2, 9):
            xs, ys = NS.x_segments(NX, m), NS.y_segments(NX, m)
            assert xs[0][0] == 0 and xs[-1][1] == NX
            assert ys[0][0] == 0 and ys[-1][1] == NX + 1
            assert all(b[0] == a[1] for a, b in zip(xs, xs[1:]))
            assert all(y[1] - y[0] >= 1 for y in ys)
            assert len(xs) == NS.active_members(NX, m) <= m


def test_node_tables_decode_to_the_schedule():
    """The node kernel's int32 tables (planes_kernels.node_tables), read
    the way csrc/planes_relax.cu reads them, give back every member's
    schedule."""
    from parallel_eda_tpu_torch.route import nodesplit as NS
    from parallel_eda_tpu_torch.route.planes_kernels import node_tables

    for NX, m in ((6, 2), (6, 8), (25, 4), (13, 3)):
        t, nslots, natoms = node_tables(NX, m)
        t = t.tolist()
        segs = NS.x_segments(NX, m)
        for r in range(len(segs)):
            for d in (0, 1):
                ms = NS.scan_schedule(NX, segs, bool(d)).members[r]
                o = t[2 * r + d]
                ns, ln, n1, n2, npub, ninj = t[o:o + 6]
                o += 6
                assert (ns, ln) == (ms.nslots, len(ms.in_slot))
                assert tuple(t[o:o + ln]) == ms.in_slot
                assert tuple(t[o + ln:o + 2 * ln]) == ms.out_slot
                o += 2 * ln
                ops = [tuple(t[o + 3 * i:o + 3 * i + 3])
                       for i in range(n1 + n2)]
                assert ops[:n1] == [op for lv in ms.levels1 for op in lv]
                assert ops[n1:] == [op for lv in ms.levels2 for op in lv]
                o += 3 * (n1 + n2)
                assert [tuple(t[o + 3 * i:o + 3 * i + 3])
                        for i in range(npub)] == list(ms.publish)
                o += 3 * npub
                assert [tuple(t[o + 2 * i:o + 2 * i + 2])
                        for i in range(ninj)] == list(ms.inject)
                assert ms.nslots <= nslots
        assert natoms == tuple(NS.scan_schedule(NX, segs, d).natoms
                               for d in (False, True))


# --------------------------------------------------------------------------
# the node relaxation


@pytest.mark.parametrize("arch,nx,ny", [("minimal", 7, 4), ("mixed", 5, 6),
                                        ("unidir", 6, 5),
                                        ("unidir_mixed", 9, 3)])
def test_node_relax_equals_one_device(arch, nx, ny):
    """planes_relax_node_plain at 2, 3, 4 and 8 members = planes_relax
    on one device, every output and the stats, on jittered costs at
    crit 0 and > 0, in both plane dtypes (directional archs included)."""
    from parallel_eda_tpu_torch.route import planes as TP
    from tests.test_torch_planes import _graph, _instance, to_port

    rr, pg = _graph(arch, nx, ny)
    tpg = to_port(pg)
    for costs in ("jitter", "crit"):
        args = [torch.from_numpy(a) for a in
                _instance(rr, pg, 3, nx * ny, costs)]
        for pd in ("f32", "bf16"):
            want = TP.planes_relax(tpg, *args, 64, pd)
            for m in (2, 3, 4, 8):
                got = TP.planes_relax_node(tpg, *args, 64, ["cpu"] * m, pd)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (costs, pd, m)


def _crit_instance():
    """The crit > 0 instance: jittered costs on the minimal 6 x 5 graph,
    B = 4."""
    from tests.test_torch_planes import _graph, _instance

    arch, nx, ny, seed = CRIT_GRAPH
    rr, pg = _graph(arch, nx, ny)
    return pg, _instance(rr, pg, 4, seed, "crit")


def write_crit_reference(path):
    """Script mode (under the AVX flag and 8 virtual devices): JAX's
    planes_relax(mesh=...) of the crit > 0 instance at every node mesh
    and plane dtype, into the .npz ``path``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parallel_eda_tpu.route import planes as JP
    from tests.test_torch_planes import _jitted

    pg, args = _crit_instance()
    out = {}
    for shape in NODE_MESHES:
        m = jax_mesh(shape)
        for pd in ("f32", "bf16"):
            res = _jitted(lambda *a: JP.planes_relax(
                pg, *a, 24, mesh=m, plane_dtype=pd), *args)
            for k, a in enumerate(res):
                out[f"{shape[0]}x{shape[1]}/{pd}/{k}"] = np.asarray(a)
    np.savez(path, **out)


@pytest.fixture(autouse=True, scope="module")
def _crit_proc(tmp_path_factory):
    """The subprocess that computes JAX's crit > 0 node-mesh relaxations
    under XLA_FLAGS=--xla_cpu_max_isa=AVX (ROADMAP C2) and the 8 virtual
    devices, started with the module so that it runs beside the tests
    before the ones that read it (crit_ref); stopped at the end."""
    d = tmp_path_factory.mktemp("node_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=8")
    with open(d / "stderr.txt", "w") as err:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              str(d / "crit.npz")], cwd=REPO, env=env,
                             stdout=subprocess.DEVNULL, stderr=err)
    yield p, d
    if p.poll() is None:
        p.kill()
    p.wait()


@pytest.fixture(scope="module")
def crit_ref(_crit_proc):
    p, d = _crit_proc
    rc = p.wait(timeout=900)
    assert rc == 0, (d / "stderr.txt").read_text()[-4000:]
    with np.load(d / "crit.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("pd", ["f32", "bf16"])
@pytest.mark.parametrize("shape", NODE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_planes_relax_node_mesh_matches_jax(shape, pd):
    """planes_relax with a node mesh = JAX's planes_relax(mesh=...) (the
    canvases' X axis on the "node" axis) = the one-device result, every
    output and the stats: the minimal instance of tests/test_torch_shard.
    py at crit 0 (exact costs)."""
    import jax

    from parallel_eda_tpu.route import planes as JP
    from parallel_eda_tpu_torch.route import planes as TP
    from tests.test_torch_planes import _jitted
    from tests.test_torch_shard import _instance

    pg, tpg, args, ref = _instance("minimal")          # B = 4
    m = jax_mesh(shape)
    jout = _jitted(lambda *a: JP.planes_relax(pg, *a, 24, mesh=m,
                                              plane_dtype=pd), *args)
    targs = [torch.from_numpy(x) for x in args]
    out = TP.planes_relax(tpg, *targs, 24, pd, mesh=cpu_mesh(shape))
    one = TP.planes_relax(tpg, *targs, 24, pd)
    for a, b, c in zip(out, jax.device_get(jout), one):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)
    if pd == "f32":
        for a, c in zip(out, ref):
            assert np.array_equal(a.numpy(), c)


@pytest.mark.parametrize("pd", ["f32", "bf16"])
@pytest.mark.parametrize("shape", NODE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_planes_relax_node_mesh_crit_matches_jax(crit_ref, shape, pd):
    """The same at crit > 0 on jittered costs, against JAX run under the
    AVX flag (XLA:CPU would otherwise fuse crit * delay + cc into an
    FMA); equal to the one-device result."""
    from parallel_eda_tpu_torch.route import planes as TP
    from tests.test_torch_planes import to_port

    pg, args = _crit_instance()
    tpg = to_port(pg)
    targs = [torch.from_numpy(x) for x in args]
    out = TP.planes_relax(tpg, *targs, 24, pd, mesh=cpu_mesh(shape))
    one = TP.planes_relax(tpg, *targs, 24, pd)
    for k, (a, c) in enumerate(zip(out, one)):
        assert np.array_equal(a.numpy(),
                              crit_ref[f"{shape[0]}x{shape[1]}/{pd}/{k}"])
        assert torch.equal(a, c)


# --------------------------------------------------------------------------
# ShardedRouter.route_step (the ELL step: its relaxation's rows split)


def _jax_step_mesh(shape, B=8):
    """JAX's ShardedRouter.route_step on the node mesh ``shape`` (None:
    its one-device route_and_commit) on the step fixture, as numpy."""
    import jax.numpy as jnp
    from jax import tree_util

    from parallel_eda_tpu.flow import synth_flow
    from parallel_eda_tpu.parallel.shard import ShardedRouter
    from parallel_eda_tpu.route.device_graph import to_device
    from parallel_eda_tpu.route.search import route_and_commit

    _, a = _step_inputs(B)
    dev = to_device(synth_flow(**STEP_FIXTURE).rr)
    x = {k: jnp.asarray(v) for k, v in a.items()}
    args = (x["occ"], x["acc"], jnp.float32(0.5)) + tuple(
        x[k] for k in _ORDER)
    if shape is None:
        out = route_and_commit(dev, *args, **STEP_STATICS)
    else:
        r = ShardedRouter(jax_mesh(shape))
        out = r.route_step(r.shard_graph(dev), *args, **STEP_STATICS)
    return tree_util.tree_map(np.asarray, tuple(out))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_node_mesh_matches_jax(shape):
    """The port's step at a node mesh: paths, reached, committed
    occupancy and relax steps = JAX's one-device route_and_commit, and
    delay = it too; delay = JAX's own mesh step to that test's allclose
    (tests/test_parallel.py:64-75: JAX's node-sharded step regroups its
    delay sums), its other outputs exactly.  The gauges are JAX's."""
    from parallel_eda_tpu_torch.obs import MetricsRegistry, set_metrics
    from parallel_eda_tpu_torch.parallel import ShardedRouter
    from parallel_eda_tpu_torch.route.device_graph import to_device

    rr, a = _step_inputs(8)
    dev = to_device(rr, "cpu", ell=True)
    x = {k: torch.from_numpy(v) for k, v in a.items()}
    reg = MetricsRegistry(enabled=True)
    old = set_metrics(reg)
    try:
        r = ShardedRouter(cpu_mesh(shape))
        t = r.route_step(r.shard_graph(dev), x["occ"], x["acc"], 0.5,
                         *(x[k] for k in _ORDER), **STEP_STATICS)
    finally:
        set_metrics(old)
    t = tuple(v.numpy() for v in t)
    j1 = _jax_step_mesh(None)
    jm = _jax_step_mesh(shape)
    for k, (a_, b_, c_) in enumerate(zip(t, j1, jm)):
        assert np.array_equal(a_, b_, equal_nan=True), k
        if k == 2:
            assert np.allclose(a_, c_, equal_nan=True)
        else:
            assert np.array_equal(a_, c_, equal_nan=True), k
    v = reg.values()
    assert (v["shard.batch_per_device"], v["shard.mesh_net"],
            v["shard.mesh_node"]) == (8 // shape[0], shape[0], shape[1])


if __name__ == "__main__":
    write_crit_reference(sys.argv[1])
