"""The port's delay lookup (parallel_eda_tpu_torch/place/delay_lookup.py)
and the placer's criticalities (sa.PlacerTiming) against the JAX
package, on the CPU.

The lookup routes every sample net in one batched route at crit 0.99,
so its JAX reference runs in a subprocess under
``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (this file run as a script), as
every crit > 0 route reference does (ROADMAP.md C2).  The criticalities
take the STA's ``crit ** td_place_exp`` at exponent 8: XLA:CPU calls the
C library's powf for it, and so does the port (timing/sta.py
``libm_powf``); ``torch.pow`` would differ in the last bit on ~2% of
inputs.  Every comparison is exact."""

import importlib
import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

JAX_PKG, PORT_PKG = "parallel_eda_tpu", "parallel_eda_tpu_torch"
FIXTURES = {
    "f15": dict(num_luts=15, num_inputs=6, num_outputs=6, chan_width=10,
                seed=3),
    "f25": dict(num_luts=25, num_inputs=4, num_outputs=4, chan_width=12,
                seed=2),
}


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "flow", "place.sa", "place.delay_lookup", "timing.graph")}


def _kw(pkg):
    return {} if pkg == JAX_PKG else {"device": "cpu"}


def _case(pkg, name):
    """(lookup stack, crit [NN, P], est crit path, crit at a scrambled
    placement) of fixture ``name``."""
    m = _mods(pkg)
    f = m["flow"].synth_flow(**FIXTURES[name])
    lk = m["place.delay_lookup"].compute_delay_lookup(f.rr, **_kw(pkg))
    tg = m["timing.graph"].build_timing_graph(f.nl, f.pnl, f.term)
    pt = m["place.sa"].PlacerTiming(f.pnl, lk, f.term, tg, td_place_exp=8.0,
                                    **_kw(pkg))
    pp = m["place.sa"].build_place_problem(f.pnl, f.grid, lookup=lk,
                                           **_kw(pkg))
    NN, P = pp.net_blk.shape
    crit, cpd = pt.criticalities(f.pos, NN, P)
    rng = np.random.default_rng(0)
    pos2 = f.pos.copy()
    clb = np.where(~np.asarray(pt.is_io))[0]
    pos2[clb] = pos2[rng.permutation(clb)]
    crit2, cpd2 = pt.criticalities(pos2, NN, P)
    return dict(stack=lk.stack, crit=np.asarray(crit), cpd=np.array(cpd),
                crit2=np.asarray(crit2), cpd2=np.array(cpd2))


def _pow_inputs():
    return np.random.default_rng(5).uniform(0, 0.99, 4096).astype(
        np.float32)


def write_reference(path):
    out = {}
    for name in FIXTURES:
        for k, v in _case(JAX_PKG, name).items():
            out[f"{name}/{k}"] = v
    out["pow8"] = np.asarray(jax.jit(lambda c: c ** 8.0)(_pow_inputs()))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_lookup") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_delay_lookup_matches_jax(ref, name):
    """The stack (every kind, every offset) and the placer's
    criticalities and est crit path at two placements, bit for bit."""
    got = _case(PORT_PKG, name)
    for k in ("stack", "crit", "cpd", "crit2", "cpd2"):
        assert np.array_equal(ref[f"{name}/{k}"], got[k]), k
    st = got["stack"]
    assert st.dtype == np.float32 and (st > 0).all()
    assert (got["crit"] > 0).sum() > 10
    # the best-case delay grows with the offset along each axis
    assert (np.diff(st[0, :, 1]) >= 0).all() and \
        (np.diff(st[0, 1, :]) >= 0).all()


def test_libm_powf_matches_xla_pow(ref):
    from parallel_eda_tpu_torch.timing.sta import libm_powf

    x = _pow_inputs()
    assert np.array_equal(ref["pow8"], libm_powf(x, 8.0))
    assert libm_powf(np.zeros(3, np.float32), 8.0).tolist() == [0.0] * 3


def test_class_index_and_conn_delay_match_jax():
    from parallel_eda_tpu.place import delay_lookup as jdl
    from parallel_eda_tpu_torch.place import delay_lookup as tdl

    jf = _mods(JAX_PKG)["flow"].synth_flow(**FIXTURES["f25"])
    tf = _mods(PORT_PKG)["flow"].synth_flow(**FIXTURES["f25"])
    assert jdl._class_index(jf.rr) == tdl._class_index(tf.rr)
    rng = np.random.default_rng(1)
    H, W = jf.grid.nx + 2, jf.grid.ny + 2
    stack = rng.uniform(1e-11, 1e-9, (4, H, W)).astype(np.float32)
    args = [rng.integers(0, H, 50), rng.integers(0, W, 50),
            rng.random(50) < 0.3, rng.integers(0, H, 50),
            rng.integers(0, W, 50), rng.random(50) < 0.3]
    assert np.array_equal(jdl.DelayLookup(stack).conn_delay(*args),
                          tdl.DelayLookup(stack).conn_delay(*args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_matches_jax(seed):
    from parallel_eda_tpu.place.delay_lookup import _fill as jfill
    from parallel_eda_tpu_torch.place.delay_lookup import _fill as tfill

    rng = np.random.default_rng(seed)
    mat = rng.uniform(0, 1, (7, 6)).astype(np.float32)
    seen = rng.random((7, 6)) < 0.4
    a, sa, b, sb = mat.copy(), seen.copy(), mat.copy(), seen.copy()
    jfill(a, sa)
    tfill(b, sb)
    assert np.array_equal(a, b) and np.array_equal(sa, sb)


def test_delay_lookup_defaults_to_card():
    from parallel_eda_tpu_torch.place.delay_lookup import \
        compute_delay_lookup

    if torch.cuda.is_available():
        return
    f = _mods(PORT_PKG)["flow"].synth_flow(**FIXTURES["f15"])
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_delay_lookup(f.rr)


if __name__ == "__main__":
    write_reference(sys.argv[1])
