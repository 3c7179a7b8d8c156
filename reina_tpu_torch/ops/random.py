"""While-free samplers with fixed rejection rounds (port of
reina_tpu/ops/random.py).

The rounds, the key splits and the float expressions follow the JAX
package one for one, so that the same keys draw the same uniforms and
the samples agree up to the ulp differences of ``log``/``exp`` between
XLA:CPU and torch. Powers are written as products (``x * (x * x)``),
which is how ``lax.integer_pow`` evaluates them. The fixed-unroll
bisects of the JAX package existed for its toolchain's gather cost;
here they are ``torch.searchsorted``, exact on sorted input.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

F32 = torch.float32


def _cube(x):
    return x * (x * x)


def gamma_fixed(key, kappa: float, shape, device, rounds: int = 4):
    """Standard Gamma(kappa), kappa > 1, by Marsaglia–Tsang with
    ``rounds`` rejection rounds; lanes that never accept take the mean."""
    if not kappa > 1.0:
        raise ValueError("gamma_fixed requires kappa > 1")
    d = kappa - 1.0 / 3.0
    c = float(np.float32(1.0) / np.sqrt(np.float32(9.0 * d)))
    out = torch.full(shape, float("nan"), dtype=F32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for k in prng.split(key, rounds):
        kx, ku = prng.split(k)
        x = prng.normal(kx, shape, device)
        v = _cube(1.0 + c * x)
        u = prng.uniform(ku, shape, device, minval=1e-37)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-37)))
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
    return torch.where(done, out, torch.tensor(kappa, dtype=F32,
                                               device=device))


def _binomial_inversion(key, n, p, max_count: int = 48):
    """Binomial by CDF inversion over a fixed horizon: exact for counts
    < max_count, clamped above (for n·p ≲ 10)."""
    n = n.to(F32)
    p = torch.clamp(p.to(F32), 0.0, 1.0)
    u = prng.uniform(key, n.shape, n.device)
    q = torch.clamp_min(1.0 - p, 1e-37)
    f = torch.exp(n * torch.log(q))
    ratio = p / q
    cdf = f
    count = torch.zeros_like(n)
    settled = u < f
    for k in range(max_count):
        k = float(k)
        f = torch.clamp_min(f * (n - k) / (k + 1.0) * ratio, 0.0)
        cdf = cdf + f
        newly = ~settled & (u < cdf)
        count = torch.where(newly, k + 1.0, count)
        settled = settled | newly
    return torch.where(settled, count, torch.clamp_max(n, float(max_count)))


def _fc(x):
    # Stirling correction: lgamma(x+1) = .5·log(2π) + (x+.5)·log(x) − x + fc(x)
    return 1.0 / (12.0 * x) - 1.0 / (360.0 * _cube(x))


def _binomial_btrs(key, n, p, rounds: int = 6):
    """Binomial by BTRS transformed rejection (Hörmann 1993) with fixed
    rounds; needs n·p ≥ 10 and p ≤ 0.5."""
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
        ku, kv = prng.split(rk)
        u = prng.uniform(ku, n.shape, n.device) - 0.5
        v = prng.uniform(kv, n.shape, n.device, minval=1e-37)
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


def binomial_fixed(key, n, p, rounds: int = 6):
    """Binomial(n, p), while-free: inversion for n·p ≤ 10, BTRS above,
    p > 0.5 by flipping."""
    n = n.to(F32)
    p = torch.clamp(p.to(F32), 0.0, 1.0)
    flip = p > 0.5
    p_eff = torch.where(flip, 1.0 - p, p)
    mean = n * p_eff
    k_inv, k_btrs = prng.split(key)
    small_m = mean <= 10.0
    small = _binomial_inversion(k_inv, n,
                                torch.where(small_m, p_eff, 0.0))
    big = _binomial_btrs(k_btrs, torch.where(mean > 10.0, n, 100.0),
                         torch.where(mean > 10.0, p_eff, 0.2), rounds)
    cnt = torch.where(small_m, small, big)
    cnt = torch.minimum(torch.clamp_min(cnt, 0.0), n)
    return torch.where(flip, n - cnt, cnt)


def searchsorted(sorted_arr, queries, side: str = "left"):
    """jnp.searchsorted over a 1-D sorted tensor, as int32."""
    q = queries.to(sorted_arr.dtype).contiguous()
    return torch.searchsorted(sorted_arr, q, right=side == "right").to(
        torch.int32)
