"""The port's threefry stream (parallel_eda_tpu_torch/place/prng.py)
against ``jax.random`` on the CPU, bit for bit: PRNGKey, split,
random bits, randint and uniform, at the shapes and ranges the annealer
draws (place/sa.py).  Integer arithmetic and one exact float conversion,
so the JAX side runs in this process with its default flags."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from parallel_eda_tpu_torch.place import prng  # noqa: E402

SEEDS = [0, 1, 3, 11, 12345, 2 ** 31 - 1, -7]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _keys(seed, n=3):
    return jax.random.split(jax.random.PRNGKey(seed), n), prng.split(
        prng.PRNGKey(seed, device="cpu"), n)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_jax(seed):
    assert np.array_equal(_np(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed, device="cpu").numpy())


def test_prngkey_rejects_wide_seed():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 31, device="cpu")


def test_prngkey_defaults_to_card():
    """A key lives on the card unless the caller asks for the CPU, and
    every draw follows its key; without a card the default raises."""
    if torch.cuda.is_available():
        assert prng.PRNGKey(0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.PRNGKey(0)


def test_threefry_matches_jax_hash():
    """The raw hash on the Threefry reference vector and on seeded
    counters (JAX ``prng.threefry_2x32``)."""
    from jax._src import prng as jprng

    rng = np.random.default_rng(0)
    for key, count in [((0x13198A2E, 0x03707344),
                        (0x243F6A88, 0x85A308D3)),
                       tuple(map(tuple, rng.integers(0, 2 ** 32, (2, 2))))]:
        want = _np(jprng.threefry_2x32(np.array(key, np.uint32),
                                       np.array(count, np.uint32)))
        k = torch.tensor(key, dtype=torch.int64)
        c = torch.tensor(count, dtype=torch.int64)
        got = prng.threefry2x32(k[0], k[1], c[:1], c[1:])
        assert [int(got[0]), int(got[1])] == want.tolist()


# split counts: 2, 4, 5 (sa_step, macro_step, _propose) and the steps /
# n_temps the fixtures reach
@pytest.mark.parametrize("n", [2, 4, 5, 1, 3, 8, 22, 37, 300])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_split_matches_jax(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")
    assert np.array_equal(_np(jax.random.split(jk, n)),
                          prng.split(tk, n).numpy())


def test_split_batched_matches_jax():
    """split of a [T, 2] batch of keys (a segment's temperatures into
    steps) equals the per-key splits."""
    jk, tk = _keys(5, 4)
    got = prng.split(tk, 7)
    assert got.shape == (4, 7, 2)
    for i in range(4):
        assert np.array_equal(_np(jax.random.split(jk[i], 7)),
                              got[i].numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (64,), (3, 5)])
def test_random_bits_matches_jax(shape):
    jk, tk = _keys(2)
    for i in range(3):
        assert np.array_equal(_np(jax.random.bits(jk[i], shape)),
                              prng.random_bits(tk[i], shape).numpy())
    batched = prng.random_bits(tk, shape)
    for i in range(3):
        assert np.array_equal(batched[i].numpy(),
                              prng.random_bits(tk[i], shape).numpy())


# spans of 1, powers of two and not, negative minval, maxval <= minval,
# and a span above 2**16 (the wrap-around of the multiplier)
RANGES = [(0, 1), (0, 2), (0, 7), (0, 8), (-3, 4), (-5, 6), (-12, 13),
          (0, 21), (0, 1101), (-40, 41), (0, 1000003), (5, 5), (3, 1)]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_randint_matches_jax(lo, hi):
    jk, tk = _keys(7)
    for i in range(3):
        for shape in ((32,), (4, 5)):
            want = _np(jax.random.randint(jk[i], shape, lo, hi))
            assert np.array_equal(want, prng.randint(tk[i], shape, lo,
                                                     hi).numpy())


def test_randint_array_bounds_match_jax():
    """Per-element bounds [-rl, rl] as _propose draws them."""
    jk, tk = _keys(9)
    rl = np.arange(1, 17, dtype=np.int32)
    want = _np(jax.random.randint(jk[0], (16,), -rl, rl + 1))
    r = torch.from_numpy(rl.astype(np.int64))
    assert np.array_equal(want, prng.randint(tk[0], (16,), -r,
                                             r + 1).numpy())


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("shape", [(32,), (64,), (3, 5)])
def test_uniform_matches_jax(lo, hi, shape):
    jk, tk = _keys(4)
    for i in range(3):
        want = np.asarray(jax.random.uniform(jk[i], shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(tk[i], shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_uniform_inside_range():
    u = prng.uniform(prng.PRNGKey(1, device="cpu"), (4096,), -1.0, 1.0)
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
