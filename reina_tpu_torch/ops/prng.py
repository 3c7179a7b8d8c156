"""jax.random's threefry2x32 PRNG, ported bit for bit.

The JAX package draws every random number from counter-based threefry
keys (``jax.random`` with ``jax_threefry_partitionable=True``, the
default of jax 0.9). The port reproduces those bits exactly so that a
day stepped by both packages from the same state and keys draws the
same uniforms.

Keys are host values: a key is a numpy ``uint32`` array whose last axis
holds the two key words, and every derivation (``split``, ``fold_in``)
runs in numpy, vectorised over any leading axes. Only the draws run on
the device: element ``k`` of a draw of shape ``s`` hashes the counter
pair ``(0, k)`` of the flattened shape, so a draw is one threefry pass
over ``arange(prod(s))``. Device words are int32 tensors holding the
uint32 bits (torch has no unsigned 32-bit arithmetic; int32 addition
and left shifts wrap the same way).

The floats follow ``jax._src.random``: ``uniform`` fills the mantissa of
``[1, 2)`` and shifts; ``normal`` is ``sqrt(2)·erf_inv(u)`` with XLA's
single-precision erf_inv polynomial; ``gumbel`` is ``−log(−log(u))``.
Uniform bits are exact. ``normal`` and ``gumbel`` pass through ``log1p``,
``log`` and ``sqrt``, which XLA:CPU does not round correctly, so they
agree with ``jax.random`` to a few ulp (tests/test_torch_prng.py states
the bound).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# the hash, once for numpy uint32 (keys) and once for int64 tensors (draws)

def _threefry_np(k1, k2, x1, x2):
    """threefry2x32 on numpy uint32 arrays (broadcasting); uint32
    arithmetic wraps, which is the hash's own modulus."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    x = [np.asarray(x1, np.uint32), np.asarray(x2, np.uint32)]
    ks = [k1, k2, k1 ^ k2 ^ np.uint32(_PARITY)]
    with np.errstate(over="ignore"):
        x = [x[0] + ks[0], x[1] + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x[0] + x[1]
                x1 = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x = [x0, x0 ^ x1]
            x = [x[0] + ks[(i + 1) % 3],
                 x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)]
    return x[0], x[1]


def _s32(k: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    k = int(k) & _M32
    return k - (1 << 32) if k >= 1 << 31 else k


def _threefry_t(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """threefry2x32 of scalar key words over int32 counter tensors.
    int32 addition and left shift wrap modulo 2^32, which is the hash's
    arithmetic; the logical right shift is an arithmetic shift masked
    to its low bits. In-place ops keep the allocator quiet."""
    ks = [int(k1), int(k2), int(k1) ^ int(k2) ^ _PARITY]
    x0 = x1 + _s32(ks[0])
    y = x2 + _s32(ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(y)
            t = (y >> (32 - r)).bitwise_and_((1 << r) - 1)
            y = (y << r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(_s32(ks[(i + 1) % 3]))
        y.add_(_s32(ks[(i + 2) % 3] + i + 1))
    return x0, y


# ---------------------------------------------------------------------------
# keys (host)

def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey for a 32-bit seed: the words (0, seed)."""
    return np.array([0, int(seed) & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split: key (..., 2) → (..., num, 2); element i hashes
    the counter pair (0, i)."""
    key = np.asarray(key, np.uint32)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = _threefry_np(k1, k2, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """jax.random.fold_in, vectorised: key (..., 2) and integer data of
    any broadcastable shape → (broadcast shape, 2)."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data).astype(np.int64) & _M32
    b1, b2 = _threefry_np(key[..., 0], key[..., 1], np.zeros_like(data),
                          data.astype(np.uint32))
    return np.stack([b1, b2], axis=-1)


# ---------------------------------------------------------------------------
# draws (device)

def _key_words(key):
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {key.shape}")
    return int(key[0]), int(key[1])


def random_bits(key, shape: Sequence[int], device) -> torch.Tensor:
    """32 random bits per element, as int32 with the same bits."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 31:
        raise ValueError(f"draw of {n} elements exceeds the int32 counter")
    k1, k2 = _key_words(key)
    lo = torch.arange(n, dtype=torch.int32, device=device)
    b1, b2 = _threefry_t(k1, k2, torch.zeros_like(lo), lo)
    return b1.bitwise_xor_(b2).reshape(shape)


def _f32(x) -> float:
    return float(np.float32(x))


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32."""
    bits = random_bits(key, shape, device)
    fb = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    floats = fb.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = _f32(hi - lo)
    out = floats * scale + float(lo)
    return torch.clamp_min(out, float(lo))


# XLA's single-precision erf_inv (Giles' polynomials, as lowered by
# chlo.erf_inv): w = −log1p(−x²); two degree-8 polynomials split at w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    p = p.to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, _f32(a), _f32(b)) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = _f32(np.sqrt(2))


def normal(key, shape, device) -> torch.Tensor:
    """jax.random.normal in float32."""
    u = uniform(key, shape, device, _NORMAL_LO, 1.0)
    return erf_inv(u) * _SQRT2


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape, device) -> torch.Tensor:
    """jax.random.gumbel (mode "low") in float32."""
    u = uniform(key, shape, device, _TINY, 1.0)
    return -torch.log(-torch.log(u))


def randint_scalar(key, minval: int, maxval: int) -> int:
    """jax.random.randint(key, (), minval, maxval) for int32 bounds —
    the two-draw modulus algorithm, in uint32 arithmetic on the host."""
    ks = split(key)
    hi = int(np.bitwise_xor(*_threefry_np(ks[0, 0], ks[0, 1], 0, 0)))
    lo = int(np.bitwise_xor(*_threefry_np(ks[1, 0], ks[1, 1], 0, 0)))
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + lo % span
    off = (off & _M32) % span
    return minval + off
