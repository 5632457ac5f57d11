"""The slice of ``jax.random`` that the annealer draws from, bit for bit.

JAX's default PRNG is threefry2x32 in the partitionable counter layout
(``jax_threefry_partitionable``, on by default): ``split(key, n)`` and
``random_bits(key, shape)`` hash the 64-bit row-major iota of the output
shape, high word and low word, under the key (JAX ``prng.py``
``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``).
``randint`` draws two 32-bit words per value and reduces them modulo the
span (JAX ``random.py`` ``_randint``); ``uniform`` puts 23 random bits
into the mantissa of a float in [1, 2) (``_uniform``).

Everything here is integer arithmetic on int64 tensors masked to 32 bits,
so it is exact on any device.  Keys are ``[..., 2]`` tensors (the JAX
package's legacy uint32 keys), so a batch of keys is one tensor: every
function broadcasts over the key's leading dimensions, and the draws of
``key[i]`` equal ``jax.random.<f>(key[i], ...)``.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..device import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash of counters (x1, x2) under key (k1, k2),
    20 rounds (JAX ``_threefry2x32_lowering``); broadcasting int64
    tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed mod 2**32]
    as a [2] int64 tensor on ``device`` (the card unless the caller asks
    for the CPU).  The other functions follow their key's device."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _hash_iota(key: torch.Tensor, shape: tuple):
    """threefry2x32 of the row-major uint64 iota over ``shape`` under
    every key of ``key`` [..., 2] -> two [..., *shape] tensors."""
    n = 1
    for s in shape:
        n *= s
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    hi = (iota >> 32).reshape(shape)
    lo = (iota & MASK).reshape(shape)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2
          ) -> torch.Tensor:
    """``jax.random.split``: [..., 2] -> [..., *num, 2]."""
    b1, b2 = _hash_iota(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` at 32 bits: [..., *shape] int64
    holding uint32 values."""
    b1, b2 = _hash_iota(key, _shape(shape))
    return b1 ^ b2


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval,
                      maxval) -> torch.Tensor:
    """JAX's span reduction of two 32-bit draws into [minval, maxval):
    (hi mod span) * (2**32 mod span) + (lo mod span), mod span, with the
    uint32 wrap-arounds of the JAX code.  int32 bounds, as Python ints
    or int64 tensors on the draws' device (no host copy); int64 result."""
    if isinstance(minval, int) and isinstance(maxval, int):
        span = 1 if maxval <= minval else (maxval - minval) & MASK
    else:
        span = torch.where(maxval <= minval, 1, (maxval - minval) & MASK)
    mult = (1 << 16) % span
    mult = (mult * mult & MASK) % span
    off = ((higher % span) * mult & MASK) + lower % span
    off = (off & MASK) % span
    return minval + off


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 bounds,
    broadcast against ``shape``); int64 values."""
    k = split(key)
    shape = _shape(shape)
    return randint_from_bits(random_bits(k[..., 0, :], shape),
                             random_bits(k[..., 1, :], shape),
                             minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 conversion: the top 23 bits as the mantissa of a
    float in [1, 2), minus one, scaled by the float32 span and shifted
    (the product and the sum each rounded), then max(minval, .)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * span + lo, min=lo)


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32."""
    return uniform_from_bits(random_bits(key, _shape(shape)), minval, maxval)
