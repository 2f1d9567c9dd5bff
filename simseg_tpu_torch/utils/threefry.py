"""JAX's counter-based random draws, in numpy, for the one draw the port
must reproduce: MixUpNCE's Beta(alpha, alpha) coefficient
(``simseg_tpu/engine/train_step.py:56-66``, ``jax.random.beta``).

What JAX computes (``jax/_src/prng.py`` and ``jax/_src/random.py``, with
``jax_threefry_partitionable`` on, its default):

- a key is two uint32 words; ``key(seed)`` is (0, seed);
- ``threefry2x32(key, (x0, x1))`` is the 20-round Threefry-2x32 hash;
- ``fold_in(key, d)`` and element ``i`` of ``split(key, n)`` are both
  ``threefry2x32(key, (0, d))``; 32 random bits are the xor of the two
  words of ``threefry2x32(key, (0, 0))``;
- ``uniform`` puts 23 of those bits in the mantissa of a float in [1, 2)
  and subtracts 1; ``normal`` is sqrt(2) erfinv(u) with XLA's float32
  erfinv polynomial (Giles); ``exponential`` is -log1p(-u);
- ``beta(a, b)`` draws log Gamma(a) and log Gamma(b) with Marsaglia and
  Tsang's rejection sampler in log space and returns
  exp(la - m) / (exp(la - m) + exp(lb - m)), m = max(la, lb).

Everything is float32, one operation at a time, as XLA computes it. Its
log, exp and log1p may differ from numpy's by an ulp, which moves the
result by about 1e-7 relative, unless the ulp flips one of the sampler's
comparisons (a rejection test, or ``v <= 0``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

f32 = np.float32
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erfinv coefficients (w < 5 and w >= 5)
_ERFINV_LT5 = tuple(f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))

Key = Tuple[int, int]


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The Threefry-2x32 hash (20 rounds) of the count (x0, x1)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = ((x[1] << r) | (x[1] >> (32 - r))) & _MASK
            x[1] ^= x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a 32-bit seed."""
    return 0, seed & _MASK


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k, 0, data & _MASK)


def split(k: Key, n: int = 2):
    return [threefry2x32(k, 0, i) for i in range(n)]


def uniform(k: Key, minval=f32(0.0), maxval=f32(1.0)) -> np.float32:
    bits = np.uint32(np.bitwise_xor(*threefry2x32(k, 0, 0)))
    floats = (np.uint32((int(bits) >> 9) | 0x3F800000).view(np.float32)
              - f32(1.0))
    return max(minval, f32(f32(floats * f32(maxval - minval)) + minval))


def _erfinv(x: np.float32) -> np.float32:
    w = -np.log1p(f32(x * -x))
    lt = w < f32(5.0)
    coef = _ERFINV_LT5 if lt else _ERFINV_GE5
    w = f32(w - f32(2.5)) if lt else f32(np.sqrt(w) - f32(3.0))
    p = coef[0]
    for c in coef[1:]:
        p = f32(c + f32(p * w))
    return f32(p * x)


def normal(k: Key) -> np.float32:
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=np.float32)
    return f32(f32(np.sqrt(2)) * _erfinv(uniform(k, lo, f32(1.0))))


def exponential(k: Key) -> np.float32:
    return -np.log1p(-uniform(k))


def log_gamma(k: Key, alpha: np.float32) -> np.float32:
    """log of a Gamma(alpha) draw (``jax.random.loggamma``, one value)."""
    (k,) = split(k, 1)   # the sampler's per-element key
    one, third = f32(1.0), f32(1.0 / 3.0)
    boost = alpha >= one
    a = alpha if boost else f32(alpha + one)
    d = f32(a - third)
    c = f32(third / np.sqrt(d))
    k, subkey = split(k)
    big_x, big_v, big_u = f32(0.0), one, f32(2.0)

    def rejected(x2, v3, u):
        return (u >= f32(one - f32(f32(0.0331) * f32(x2 * x2)))) and (
            np.log(u) >= f32(f32(x2 * f32(0.5))
                             + f32(d * f32(f32(one - v3) + np.log(v3)))))

    while rejected(big_x, big_v, big_u):
        k, x_key, u_key = split(k, 3)
        x, v = f32(0.0), f32(-1.0)
        while v <= f32(0.0):
            x_key, sub = split(x_key)
            x = normal(sub)
            v = f32(one + f32(x * c))
        big_x, big_v = f32(x * x), f32(f32(v * v) * v)
        big_u = uniform(u_key)
    log_samples = -exponential(subkey)
    log_boost = (f32(0.0) if boost or log_samples == 0
                 else f32(log_samples * f32(one / alpha)))
    return f32(f32(np.log(d) + np.log(big_v)) + log_boost)


def beta(k: Key, a: float, b: float) -> np.float32:
    """``jax.random.beta(k, a, b)`` in float32."""
    key_a, key_b = split(k)
    la, lb = log_gamma(key_a, f32(a)), log_gamma(key_b, f32(b))
    m = max(la, lb)
    ga, gb = np.exp(f32(la - m)), np.exp(f32(lb - m))
    return f32(ga / f32(ga + gb))
