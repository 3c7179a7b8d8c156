"""jax.random's threefry2x32 PRNG, ported bit for bit.

The JAX package draws every random number from counter-based threefry
keys (``jax.random`` with ``jax_threefry_partitionable=True``, the
default of jax 0.9). The port reproduces those bits exactly so that a
day stepped by both packages from the same state and keys draws the
same uniforms.

Keys are host values: a key is a numpy ``uint32`` array whose last axis
holds the two key words, and every derivation (``split``, ``fold_in``)
runs in numpy, vectorised over any leading axes. A draw also takes a
:class:`DevKey`, the same words in device memory (a row of the day
step's key table): the kernel reads them when it runs, which is what a
captured CUDA graph needs to draw with each replayed day's keys (the
twins read them back to the host). Only the draws run on the
device: element ``k`` of a draw of shape ``s`` hashes the counter
pair ``(0, k)`` of the flattened shape, so a draw is one threefry pass
over ``arange(prod(s))``. On CUDA a draw is one launch of
``kernels/csrc/threefry.cu``, which writes the bits or the floats; on
the CPU the twins (``random_bits_twin``, ``uniform_twin``,
``normal_twin``, ``gumbel_twin``) run the hash as eager ops on int32
tensors holding the uint32 bits (torch has no unsigned 32-bit
arithmetic; int32 addition and left shifts wrap the same way).

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
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import kernels

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
# draws (device): on CUDA one launch of kernels/csrc/threefry.cu a draw,
# on the CPU the twins, which run the hash as eager int32 ops

class DevKey(NamedTuple):
    """A key in device memory: ``words`` (int32 holding the uint32
    bits) starts with the key's two words; a sampler's key
    (ops/random.py) follows them with the words its kernel takes, split
    on the host for ``rounds`` rounds."""
    words: torch.Tensor
    rounds: int = 0


def host_key(key) -> np.ndarray:
    """A key's two words as a numpy uint32 (2,) (a DevKey's are read
    back from its device)."""
    if isinstance(key, DevKey):
        key = key.words[:2].cpu().numpy().view(np.uint32)
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {key.shape}")
    return key


def dev_key(key, device, tail=None, rounds: int = 0) -> DevKey:
    """``key`` (and a sampler's ``tail`` words) as a DevKey on
    ``device``."""
    words = host_key(key)
    if tail is not None:
        words = np.concatenate([words, np.asarray(tail, np.uint32)])
    return DevKey(torch.from_numpy(words.view(np.int32).copy()).to(device),
                  rounds)


def _key_words(key):
    key = host_key(key)
    return int(key[0]), int(key[1])


def _draw_shape(shape, start: int):
    """The draw's shape as ints and its element count; a draw from a
    start counter is 1-D, and its counters stay below 2^31."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if start and len(shape) != 1:
        raise ValueError("a draw from a start counter must be 1-D")
    if start < 0 or start + n >= 2 ** 31:
        raise ValueError(f"draw of {n} elements from {start} exceeds the "
                         "int32 counter")
    return shape, n


def _f32(x) -> float:
    return float(np.float32(x))


def affine(minval: float, maxval: float):
    """(lo, scale) of a uniform on [minval, maxval) as float32 values:
    the twin's ``floats * scale + lo``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), _f32(hi - lo)


# the modes of the draw kernel's entry point (threefry.cu)
_BITS, _UNIFORM, _NORMAL, _GUMBEL = 0, 1, 2, 3


def _draw(mode: int, key, shape, device, start: int, lo: float = 0.0,
          scale: float = 1.0) -> torch.Tensor:
    """One launch of the draw kernel: ``shape`` elements from counter
    ``start``, as int32 bits (mode _BITS) or float32."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"prng: unsupported device {device}")
    shape, n = _draw_shape(shape, start)
    out = torch.empty(shape, device=device,
                      dtype=torch.int32 if mode == _BITS else torch.float32)
    if isinstance(key, DevKey):
        if key.words.device != out.device or key.words.dtype != torch.int32:
            raise ValueError(f"prng: a device key on {key.words.device} "
                             f"({key.words.dtype}) for a draw on "
                             f"{out.device}")
        k1 = k2 = 0
        key_dev = key.words.data_ptr()
    else:
        k1, k2 = _key_words(key)
        key_dev = None
    if n == 0:
        return out
    from ..kernels import build
    build.check(build.lib().reina_draw(
        out.data_ptr(), n, int(start), k1, k2, key_dev, mode, lo, scale,
        build.stream_of(out)), "prng.draw")
    kernels.launched("prng.draw")
    return out


def _on_cpu(device) -> bool:
    return torch.device(device).type == "cpu"


def random_bits_twin(key, shape: Sequence[int], device,
                     start: int = 0) -> torch.Tensor:
    """32 random bits per element, as int32 with the same bits.

    ``start``: the counter of the first element. A 1-D draw of
    ``(hi - lo,)`` from ``start=lo`` is ``random_bits(key, (N,))[lo:hi]``
    bit for bit (the counters are the flat positions), which is how an
    agent shard draws its slab of a global (N,) draw."""
    shape, n = _draw_shape(shape, start)
    lo = torch.arange(start, start + n, dtype=torch.int32, device=device)
    return _bits_at(key, lo).reshape(shape)


def _bits_at(key, counters: torch.Tensor) -> torch.Tensor:
    """The bits of a draw of ``key`` at the flat positions ``counters``
    (int32): random_bits_twin's elements there."""
    k1, k2 = _key_words(key)
    b1, b2 = _threefry_t(k1, k2, torch.zeros_like(counters), counters)
    return b1.bitwise_xor_(b2)


def random_bits(key, shape: Sequence[int], device,
                start: int = 0) -> torch.Tensor:
    """random_bits_twin's bits: its twin on the CPU, the kernel on CUDA."""
    if _on_cpu(device):
        return random_bits_twin(key, shape, device, start)
    return _draw(_BITS, key, shape, device, start)


def uniform_twin(key, shape, device, minval: float = 0.0,
                 maxval: float = 1.0, start: int = 0) -> torch.Tensor:
    """jax.random.uniform in float32 (``start``: see random_bits_twin)."""
    return _uniform_of(random_bits_twin(key, shape, device, start), minval,
                       maxval)


def uniform_twin_at(key, counters: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """uniform_twin's elements at the flat positions ``counters`` (int32,
    1-D) of a draw of ``key``, of any shape that holds them."""
    return _uniform_of(_bits_at(key, counters), minval, maxval)


def _uniform_of(bits, minval: float, maxval: float) -> torch.Tensor:
    fb = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    floats = fb.view(torch.float32) - 1.0
    lo, scale = affine(minval, maxval)
    out = floats * scale + lo
    return torch.clamp_min(out, lo)


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0, start: int = 0) -> torch.Tensor:
    """uniform_twin's floats: its twin on the CPU, the kernel on CUDA."""
    if _on_cpu(device):
        return uniform_twin(key, shape, device, minval, maxval, start)
    return _draw(_UNIFORM, key, shape, device, start,
                 *affine(minval, maxval))


# XLA's single-precision erf_inv (Giles' polynomials, as lowered by
# chlo.erf_inv): w = −log1p(−x²); two degree-8 polynomials split at w = 5
# (threefry.cuh holds the same float32 values)
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


def normal_twin(key, shape, device, start: int = 0) -> torch.Tensor:
    """jax.random.normal in float32 (``start``: see random_bits_twin)."""
    u = uniform_twin(key, shape, device, _NORMAL_LO, 1.0, start)
    return erf_inv(u) * _SQRT2


def normal(key, shape, device, start: int = 0) -> torch.Tensor:
    """normal_twin's floats: its twin on the CPU, the kernel on CUDA."""
    if _on_cpu(device):
        return normal_twin(key, shape, device, start)
    return _draw(_NORMAL, key, shape, device, start,
                 *affine(_NORMAL_LO, 1.0))


_TINY = float(np.finfo(np.float32).tiny)


def gumbel_twin(key, shape, device) -> torch.Tensor:
    """jax.random.gumbel (mode "low") in float32."""
    u = uniform_twin(key, shape, device, _TINY, 1.0)
    return -torch.log(-torch.log(u))


def gumbel(key, shape, device) -> torch.Tensor:
    """gumbel_twin's floats: its twin on the CPU, the kernel on CUDA."""
    if _on_cpu(device):
        return gumbel_twin(key, shape, device)
    return _draw(_GUMBEL, key, shape, device, 0, *affine(_TINY, 1.0))


def randint(keys, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, (), minval, maxval) for int32 bounds, of
    each key of ``keys`` (..., 2) — the two-draw modulus algorithm, in
    uint64 arithmetic on the host, vectorised over the leading axes.
    Returns int64 of the leading shape."""
    ks = split(np.asarray(keys, np.uint32))                  # (..., 2, 2)
    bits = np.bitwise_xor(*_threefry_np(ks[..., 0], ks[..., 1], 0, 0))
    hi, lo = bits[..., 0].astype(np.uint64), bits[..., 1].astype(np.uint64)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    m32, span, mult = np.uint64(_M32), np.uint64(span), np.uint64(mult)
    off = (((hi % span) * mult) & m32) + lo % span
    off = (off & m32) % span
    return minval + off.astype(np.int64)


def randint_scalar(key, minval: int, maxval: int) -> int:
    """``randint`` of one key."""
    return int(randint(host_key(key), minval, maxval))
