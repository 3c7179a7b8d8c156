"""The benchmark reference's frozen copy of reina_tpu_torch/ops/random.py (its plain forms only: every kernel path taken out).

While-free samplers with fixed rejection rounds (port of
reina_tpu/ops/random.py).

The rounds, the key splits and the float expressions follow the JAX
package one for one, so that the same keys draw the same uniforms and
the samples agree up to the ulp differences of ``log``/``exp`` between
XLA:CPU and torch. Powers are written as products (``x * (x * x)``),
which is how ``lax.integer_pow`` evaluates them. The fixed-unroll
bisects of the JAX package existed for its toolchain's gather cost;
here they are ``torch.searchsorted``, exact on sorted input.

On CUDA each sampler call is one launch of ``kernels/csrc/samplers.cu``
(gamma: a lane's rounds side by side, one thread a round; binomial: a
thread a lane, the lanes of a CTA laid out by branch; only the branch a
lane keeps, up to the round where it settles), and ``gamma_fixed_pair``
draws two gamma samples of one shape in one launch; on the CPU the
twins (``gamma_fixed_twin``, ``binomial_fixed_twin``) run every round
on every lane as eager ops. Both give the same samples from the same
keys. The kernel takes the keys split on the host (``gamma_words``,
``binomial_words``) by value, or from device memory for a
``prng.DevKey`` made with the same words (the day step's key table,
read by a captured graph at replay).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import prng

F32 = torch.float32


def _cube(x):
    return x * (x * x)


# the kernel's largest round count (samplers.cu MAX_ROUNDS)
MAX_ROUNDS = 8


def _check_rounds(rounds: int) -> None:
    if not 1 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"the sampler kernel runs 1 to {MAX_ROUNDS} "
                         f"rounds, not {rounds}")


def _gamma_scalars(kappa: float):
    """(d, c) as the twin uses them: d a Python float (torch rounds it to
    float32 in each op), c the float32 of 1/sqrt(9d)."""
    if not kappa > 1.0:
        raise ValueError("gamma_fixed requires kappa > 1")
    d = kappa - 1.0 / 3.0
    return d, float(np.float32(1.0) / np.sqrt(np.float32(9.0 * d)))


def gamma_fixed_twin(key, kappa: float, shape, device, rounds: int = 4):
    """Standard Gamma(kappa), kappa > 1, by Marsaglia–Tsang with
    ``rounds`` rejection rounds; lanes that never accept take the mean."""
    d, c = _gamma_scalars(kappa)
    out = torch.full(shape, float("nan"), dtype=F32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for k in prng.split(prng.host_key(key), rounds):
        kx, ku = prng.split(k)
        x = prng.normal_twin(kx, shape, device)
        v = _cube(1.0 + c * x)
        u = prng.uniform_twin(ku, shape, device, minval=1e-37)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-37)))
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
    return torch.where(done, out, torch.tensor(kappa, dtype=F32,
                                               device=device))


def _affines():
    """The float32 affines of the samplers' uniforms, as samplers.cu's
    Affines: [0, 1), [1e-37, 1), [_NORMAL_LO, 1)."""
    return (ctypes.c_float * 6)(*prng.affine(0.0, 1.0),
                                *prng.affine(1e-37, 1.0),
                                *prng.affine(prng._NORMAL_LO, 1.0))


def _rounds_padded(keys, rounds: int):
    """(…, rounds, 2) keys zero-padded to (…, MAX_ROUNDS, 2)."""
    pad = np.zeros(keys.shape[:-2] + (MAX_ROUNDS - rounds, 2), np.uint32)
    return np.concatenate([keys, pad], axis=-2)


def gamma_words(key, rounds: int = 4) -> np.ndarray:
    """The 4·MAX_ROUNDS key words of samplers.cu's gamma kernel for
    ``key`` (…, 2), vectorised over leading axes: split(split(key,
    rounds)) as the twin splits it, the kx of each round zero-padded to
    MAX_ROUNDS, then the ku."""
    _check_rounds(rounds)
    kxu = prng.split(prng.split(np.asarray(key, np.uint32), rounds))
    lead = kxu.shape[:-3]
    return np.concatenate(
        [_rounds_padded(kxu[..., 0, :], rounds),
         _rounds_padded(kxu[..., 1, :], rounds)],
        axis=-2).reshape(lead + (4 * MAX_ROUNDS,))


def binomial_words(key, rounds: int = 6) -> np.ndarray:
    """The 2 + 4·MAX_ROUNDS key words of samplers.cu's binomial kernel
    for ``key`` (…, 2): k_inv, then the ku and the kv of each BTRS round
    zero-padded to MAX_ROUNDS, as the twin splits them."""
    _check_rounds(rounds)
    ks = prng.split(np.asarray(key, np.uint32))
    kuv = prng.split(prng.split(ks[..., 1, :], rounds))
    lead = kuv.shape[:-3]
    return np.concatenate(
        [ks[..., 0:1, :], _rounds_padded(kuv[..., 0, :], rounds),
         _rounds_padded(kuv[..., 1, :], rounds)],
        axis=-2).reshape(lead + (2 + 4 * MAX_ROUNDS,))


def dev_key(key, device, words_of, rounds: int) -> prng.DevKey:
    """``key`` with its sampler words (``gamma_words`` or
    ``binomial_words``) as a prng.DevKey on ``device``."""
    return prng.dev_key(key, device, words_of(prng.host_key(key), rounds),
                        rounds)


def gamma_fixed(key, kappa: float, shape, device, rounds: int = 4):
    """gamma_fixed_twin's samples: its twin on the CPU; on CUDA one
    launch of kernels/csrc/samplers.cu."""
    return gamma_fixed_twin(key, kappa, shape, device, rounds)


def gamma_fixed_pair(key1, kappa1: float, key2, kappa2: float, shape,
                     device, rounds: int = 4):
    """(gamma_fixed(key1, kappa1, …), gamma_fixed(key2, kappa2, …)) of
    one shape: the two twins on the CPU; on CUDA both in one launch of
    kernels/csrc/samplers.cu."""
    return (gamma_fixed_twin(key1, kappa1, shape, device, rounds),
            gamma_fixed_twin(key2, kappa2, shape, device, rounds))


def _lane_uniform(key, n, at, minval: float = 0.0):
    """The uniforms of a draw of ``key`` for lanes ``n``: at every flat
    position of n's shape, or (``at``, int32) at those positions of a
    larger draw whose lanes n holds."""
    if at is None:
        return prng.uniform_twin(key, n.shape, n.device, minval=minval)
    return prng.uniform_twin_at(key, at, minval=minval)


def _all_settled(settled) -> bool:
    """Whether every lane has settled, so that the rounds or steps left
    change nothing (asked on the CPU only: on a card the twin reads
    nothing on the host)."""
    return settled.device.type == "cpu" and bool(settled.all())


def _binomial_inversion(key, n, p, max_count: int = 48, at=None):
    """Binomial by CDF inversion over a fixed horizon: exact for counts
    < max_count, clamped above (for n·p ≲ 10). ``at``: see
    :func:`_lane_uniform`."""
    n = n.to(F32)
    p = torch.clamp(p.to(F32), 0.0, 1.0)
    u = _lane_uniform(key, n, at)
    q = torch.clamp_min(1.0 - p, 1e-37)
    f = torch.exp(n * torch.log(q))
    ratio = p / q
    cdf = f
    count = torch.zeros_like(n)
    settled = u < f
    for k in range(max_count):
        if _all_settled(settled):
            break
        # / (k + 1) as torch on CUDA divides by a Python scalar: times its
        # float32 reciprocal, written out so the CPU computes the same
        inv = float(np.float32(1.0) / np.float32(k + 1.0))
        f = torch.clamp_min(f * (n - float(k)) * inv * ratio, 0.0)
        cdf = cdf + f
        newly = ~settled & (u < cdf)
        count = torch.where(newly, k + 1.0, count)
        settled = settled | newly
    return torch.where(settled, count, torch.clamp_max(n, float(max_count)))


def _fc(x):
    # Stirling correction: lgamma(x+1) = .5·log(2π) + (x+.5)·log(x) − x + fc(x)
    return 1.0 / (12.0 * x) - 1.0 / (360.0 * _cube(x))


def _binomial_btrs(key, n, p, rounds: int = 6, at=None):
    """Binomial by BTRS transformed rejection (Hörmann 1993) with fixed
    rounds; needs n·p ≥ 10 and p ≤ 0.5. ``at``: see
    :func:`_lane_uniform`."""
    n = n.to(F32)
    p = torch.clamp(p.to(F32), 1e-9, 0.5)
    q = 1.0 - p
    spq = torch.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c_ = n * p + 0.5
    v_r = 0.92 - 4.2 / b
    log_r = torch.log(p) - torch.log(q)
    alpha = (2.83 + 5.1 / b) * spq
    m = torch.floor((n + 1.0) * p)

    def log_pmf_ratio(k):
        """log f(k) − log f(m), with the Stirling terms paired through
        log1p of small deltas (see the JAX package)."""
        d = k - m
        k_s = torch.clamp_min(k, 0.5)
        part1 = -((m + 0.5) * torch.log1p(d / m) + d * torch.log(k_s)
                  - d + _fc(torch.clamp_min(k, 1.0)) - _fc(m))
        part1 = torch.where(k < 0.5,
                            (m + 0.5) * torch.log(m) - m + _fc(m) + 0.9189385,
                            part1)
        a_ = torch.clamp_min(n - k, 0.5)
        b_ = torch.clamp_min(n - m, 1.0)
        part2 = ((a_ + 0.5) * torch.log1p(d / a_) + d * torch.log(b_)
                 - d + _fc(b_) - _fc(torch.clamp_min(n - k, 1.0)))
        return d * log_r + part1 + part2

    out = torch.full_like(n, float("nan"))
    done = torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    for rk in prng.split(key, rounds):
        if _all_settled(done):
            break
        ku, kv = prng.split(rk)
        u = _lane_uniform(ku, n, at) - 0.5
        v = _lane_uniform(kv, n, at, minval=1e-37)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a / us + b) * u + c_)
        in_range = (k >= 0) & (k <= n)
        k_c = torch.minimum(torch.clamp_min(k, 0.0), n)
        easy = (us >= 0.07) & (v <= v_r)
        v2 = torch.log(v * alpha / (a / (us * us) + b))
        accept = in_range & (easy | (v2 <= log_pmf_ratio(k_c)))
        take = accept & ~done
        out = torch.where(take, k_c, out)
        done = done | accept
    return torch.where(done, out, torch.round(n * p))


def _lanes(mask) -> torch.Tensor:
    """The flat positions where ``mask`` (1-D) holds, as int32."""
    return torch.nonzero(mask).reshape(-1).to(torch.int32)


def binomial_fixed_twin(key, n, p, rounds: int = 6):
    """Binomial(n, p), while-free: inversion for n·p ≤ 10, BTRS above,
    p > 0.5 by flipping."""
    n = n.to(F32)
    p = torch.clamp(p.to(F32), 0.0, 1.0)
    flip = p > 0.5
    p_eff = torch.where(flip, 1.0 - p, p)
    mean = n * p_eff
    k_inv, k_btrs = prng.split(prng.host_key(key))
    small_m = mean <= 10.0
    # each branch on its own lanes, drawing at their flat positions (the
    # same uniforms as a draw over all lanes): the inversion on small
    # lanes that can draw (n = 0 or p_eff = 0 counts 0 there), BTRS on
    # the rest, a lane whose mean is not above 10 (NaN) as n = 100,
    # p = 0.2
    fn, fp = n.reshape(-1), p_eff.reshape(-1)
    cnt = torch.zeros_like(fn)
    inv = _lanes(small_m.reshape(-1) & (fn > 0) & (fp > 0))
    if inv.numel():
        cnt[inv.long()] = _binomial_inversion(k_inv, fn[inv.long()],
                                              fp[inv.long()], at=inv)
    big = _lanes(~small_m.reshape(-1))
    if big.numel():
        b = big.long()
        m_b = mean.reshape(-1)[b] > 10.0
        cnt[b] = _binomial_btrs(k_btrs, torch.where(m_b, fn[b], 100.0),
                                torch.where(m_b, fp[b], 0.2), rounds, at=big)
    cnt = torch.minimum(torch.clamp_min(cnt.reshape(n.shape), 0.0), n)
    return torch.where(flip, n - cnt, cnt)


def binomial_fixed(key, n, p, rounds: int = 6):
    """binomial_fixed_twin's samples: its twin for CPU tensors; on CUDA
    one launch of kernels/csrc/samplers.cu (n and p of one shape, on one
    device)."""
    return binomial_fixed_twin(key, n, p, rounds)


def searchsorted(sorted_arr, queries, side: str = "left"):
    """jnp.searchsorted over a 1-D sorted tensor, as int32."""
    q = queries.to(sorted_arr.dtype).contiguous()
    return torch.searchsorted(sorted_arr, q, right=side == "right").to(
        torch.int32)
