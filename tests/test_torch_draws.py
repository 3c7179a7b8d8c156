"""CPU models of the draw kernels (reina_tpu_torch/kernels/csrc/
threefry.cu, samplers.cu) against the port's twins and the JAX package.

No card here: each model is the loop its CUDA kernel runs, written out
in Python. The hash model groups elements by thread as threefry.cu does
(ELEMS and THREADS read from its source) and is held bit for bit to
``jax.random.bits``/``uniform`` for odd sizes and non-zero starts. The
sampler models map threads to lanes as samplers.cu does (GAMMA_THREADS,
BIN_THREADS, MAX_COUNT and the reciprocal table read from its source):
gamma a group of threads a lane, one round each, the group's first
accepting round kept, the samples of a launch side by side; binomial
the lanes of a CTA laid out by branch, a thread a lane. Each lane runs
only the branch the twin keeps, stopping at the round or step where it
settles, with the kernel's rounding: float32 arithmetic in numpy (each
op rounded on its own, as the kernel's __fmul_rn/__fadd_rn), the
transcendental functions through torch on the CPU as the twins call them
(torch's CPU kernels give an element the same value whatever its
position in a tensor). They
must equal the twins bit for bit on every lane, and the JAX package's
samplers from the same keys within ROADMAP.md queue 3's bounds (at
least 99.9% of binomials equal; gammas within 1e-5 relative). The card
tests (tests/test_torch_cuda.py) hold the kernels to the twins.
"""
import math
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reina_tpu.ops import random as jrandom
from reina_tpu_torch import kernels
from reina_tpu_torch.ops import prng
from reina_tpu_torch.ops import random as trandom

torch.set_num_threads(1)

F = np.float32
CSRC = Path(trandom.__file__).resolve().parents[1] / "kernels" / "csrc"
SOURCES = {name: (CSRC / name).read_text()
           for name in ("threefry.cuh", "threefry.cu", "samplers.cu")}


def _constexpr(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCES[source]).group(1))


ELEMS = _constexpr("threefry.cu", "ELEMS")
THREADS = _constexpr("threefry.cu", "THREADS")
MAX_ROUNDS = _constexpr("samplers.cu", "MAX_ROUNDS")
MAX_COUNT = _constexpr("samplers.cu", "MAX_COUNT")
MAX_SAMPLES = _constexpr("samplers.cu", "MAX_SAMPLES")
GAMMA_THREADS = _constexpr("samplers.cu", "GAMMA_THREADS")
BIN_THREADS = _constexpr("samplers.cu", "BIN_THREADS")
# the inversion's table of float32 reciprocals, as the source writes it
RECIP = [np.float32(x) for x in re.findall(
    r"([\d.e-]+)f", re.search(r"RECIP\[MAX_COUNT\] = \{(.*?)\};",
                              SOURCES["samplers.cu"], re.S).group(1))]


def _torch_fn(fn):
    """fn of a float32 scalar as torch computes it on the CPU."""
    return lambda x: F(fn(torch.tensor(x, dtype=torch.float32)).item())


log, log1p, exp, sqrt = (_torch_fn(f) for f in (torch.log, torch.log1p,
                                                 torch.exp, torch.sqrt))


# ---------------------------------------------------------------------------
# one element: the hash and the floats of threefry.cuh

def _bits(key, ctr) -> int:
    b1, b2 = prng._threefry_np(key[0], key[1], 0, np.uint32(ctr))
    return int(b1 ^ b2)


def _uniform(b: int, lo: float, scale: float):
    f = np.array((b >> 9) | 0x3F800000, np.uint32).view(np.float32)[()]
    u = (f - F(1)) * F(scale) + F(lo)
    return F(lo) if u < F(lo) else u            # clamp_min, NaN kept


def _erf_inv(x):
    w = -log1p(-(x * x))
    lt = w < F(5)
    w = w - F(2.5) if lt else sqrt(w) - F(3)
    coeffs = prng._ERFINV_LT5 if lt else prng._ERFINV_GE5
    p = F(coeffs[0])
    for c in coeffs[1:]:
        p = F(c) + p * w
    return x * F(math.inf) if abs(x) == F(1) else p * x


def _normal(b: int, lo: float, scale: float):
    return _erf_inv(_uniform(b, lo, scale)) * F(prng._SQRT2)


UNIT = prng.affine(0.0, 1.0)
TINY = prng.affine(1e-37, 1.0)
NORMAL = prng.affine(prng._NORMAL_LO, 1.0)


def _clamp_min(x, m):
    return x if np.isnan(x) or x >= m else F(m)


def _clamp_max(x, m):
    return x if np.isnan(x) or x <= m else F(m)


def _minimum(a, b):
    return a if np.isnan(a) else b if np.isnan(b) else min(a, b)


# ---------------------------------------------------------------------------
# the hash kernel: threads of ELEMS consecutive elements

@pytest.mark.parametrize("shape,start", [
    ((7,), 0), ((1023,), 5), ((4097,), 843264), ((33, 5), 0),
    ((5, 10, 2), 0)])
def test_hash_kernel_model(shape, start):
    """threefry.cu's grid: thread t of ceil(n / (THREADS·ELEMS)) blocks
    writes elements [t·ELEMS, t·ELEMS + ELEMS) ∩ [0, n), element k from
    counter start + k, whatever the shape; bits and uniform floats equal
    jax.random's, a 1-D draw from ``start`` its slab of the whole draw."""
    seed = 20 + len(shape) + start % 97
    key, jkey = prng.PRNGKey(seed), jr.PRNGKey(seed)
    n = math.prod(shape)
    grid = -(-n // (THREADS * ELEMS))
    out = np.zeros(n, np.uint32)
    written = np.zeros(n, np.int32)
    for t in range(grid * THREADS):
        base = t * ELEMS
        if base >= n:
            continue
        k = np.arange(base, min(base + ELEMS, n))
        b1, b2 = prng._threefry_np(key[0], key[1], 0,
                                   (start + k).astype(np.uint32))
        out[k] = b1 ^ b2
        written[k] += 1
    assert (written == 1).all()
    if start:
        want = np.asarray(jr.bits(jkey, (start + n,)))[start:]
        want_u = np.asarray(jr.uniform(jkey, (start + n,)))[start:]
    else:
        want = np.asarray(jr.bits(jkey, shape)).reshape(-1)
        want_u = np.asarray(jr.uniform(jkey, shape)).reshape(-1)
    np.testing.assert_array_equal(out, want)
    u = ((out >> 9) | np.uint32(0x3F800000)).view(np.float32) - F(1)
    u = np.maximum(u * F(UNIT[1]) + F(UNIT[0]), F(UNIT[0]))
    np.testing.assert_array_equal(u.view(np.int32), want_u.view(np.int32))
    # the twin draws the same bits
    got = prng.random_bits_twin(key, shape, "cpu", start).numpy()
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint32), out)


# ---------------------------------------------------------------------------
# the samplers, one lane at a time

# the JAX package's samplers as its day step runs them, under jit
_jax_gamma = jax.jit(jrandom.gamma_fixed, static_argnums=(1, 2, 3))
_jax_binomial = jax.jit(jrandom.binomial_fixed)


def _lane_bits(key, n: int):
    """The hash of counters 0..n-1 under ``key``: each lane's draw."""
    b1, b2 = prng._threefry_np(key[0], key[1], 0,
                               np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def _gamma_round(bx, bu, d, c):
    """gamma_round of a lane from its round's two hashes: (accepts, d·v)."""
    x = _normal(int(bx), *NORMAL)
    t = F(1) + F(c) * x
    v = t * (t * t)
    if not v > F(0):
        return False, d * v
    u = _uniform(int(bu), *TINY)
    rhs = F(0.5) * x * x + d
    rhs = rhs - d * v
    rhs = rhs + d * log(_clamp_min(v, F(1e-37)))
    return bool(log(u) < rhs), d * v


def _gamma_model(samples, n, rounds=4):
    """gamma_kernel's grid for ``samples``, a list of (key, kappa):
    thread t of sample h (the grid's y) runs round t & (width - 1) of
    lane t >> shift, width = 1 << shift the least power of two >= rounds;
    in each warp the ballot of accepting rounds gives each group its
    first, whose thread writes d·v, or the group's first thread kappa
    where none accepts. Returns (samples, n)."""
    assert 1 <= len(samples) <= MAX_SAMPLES and 1 <= rounds <= MAX_ROUNDS
    shift = max(rounds - 1, 0).bit_length()
    width = 1 << shift
    assert GAMMA_THREADS % 32 == 0 and width <= 32
    threads = -(-(n << shift) // GAMMA_THREADS) * GAMMA_THREADS
    out = np.zeros((len(samples), n), np.float32)
    written = np.zeros((len(samples), n), np.int32)
    for h, (key, kappa) in enumerate(samples):
        d, c = trandom._gamma_scalars(kappa)
        kxu = prng.split(prng.split(key, rounds))
        bx = [_lane_bits(kxu[r, 0], n) for r in range(rounds)]
        bu = [_lane_bits(kxu[r, 1], n) for r in range(rounds)]
        for w0 in range(0, threads, 32):
            t = np.arange(w0, w0 + 32)
            lane, rnd = t >> shift, t & (width - 1)
            res = [_gamma_round(bx[r][i], bu[r][i], F(d), c)
                   if i < n and r < rounds else (False, F(0))
                   for i, r in zip(lane, rnd)]
            vote = sum(1 << j for j, (ok, _) in enumerate(res) if ok)
            for j in range(32):
                if lane[j] >= n:
                    continue
                group = (vote >> (j & ~(width - 1))) & ((1 << width) - 1)
                first = (group & -group).bit_length() - 1 if group else 0
                if rnd[j] == first:
                    out[h, lane[j]] = res[j][1] if group else F(kappa)
                    written[h, lane[j]] += 1
    assert (written == 1).all()
    return out


def _inversion_lane(i, key, n, p):
    p = _clamp_min(_clamp_max(p, F(1)), F(0))
    u = _uniform(_bits(key, i), *UNIT)
    q = _clamp_min(F(1) - p, F(1e-37))
    f = exp(n * log(q))
    ratio = p / q
    cdf = f
    if u < f:
        return F(0)
    for k in range(MAX_COUNT):
        f = f * (n - F(k)) * RECIP[k]
        f = _clamp_min(f * ratio, F(0))
        cdf = cdf + f
        if u < cdf:
            return F(k + 1)
    return _clamp_max(n, F(MAX_COUNT))


def _fc(x):
    return F(1) / (x * F(12)) - F(1) / (F(360) * (x * (x * x)))


def _btrs_lane(i, ku, kv, rounds, n, p):
    p = _clamp_min(_clamp_max(p, F(0.5)), F(1e-9))
    q = F(1) - p
    spq = sqrt(n * p * q)
    b = F(2.53) * spq + F(1.15)
    a = F(0.0248) * b + F(-0.0873) + F(0.01) * p
    c_ = n * p + F(0.5)
    v_r = F(0.92) - (F(1) / b) * F(4.2)
    log_r = log(p) - log(q)
    alpha = ((F(1) / b) * F(5.1) + F(2.83)) * spq
    m = np.floor((n + F(1)) * p)
    for r in range(rounds):
        u = _uniform(_bits(ku[r], i), *UNIT) - F(0.5)
        us = F(0.5) - abs(u)
        k = np.floor((F(2) * a / us + b) * u + c_)
        if not (k >= F(0) and k <= n):
            continue
        v = _uniform(_bits(kv[r], i), *TINY)
        k_c = _minimum(_clamp_min(k, F(0)), n)
        if us >= F(0.07) and v <= v_r:
            return k_c
        v2 = log(v * alpha / (a / (us * us) + b))
        d = k_c - m
        if k_c < F(0.5):
            part1 = (m + F(0.5)) * log(m) - m + _fc(m) + F(0.9189385)
        else:
            part1 = -((m + F(0.5)) * log1p(d / m)
                      + d * log(_clamp_min(k_c, F(0.5))) - d
                      + _fc(_clamp_min(k_c, F(1))) - _fc(m))
        a_ = _clamp_min(n - k_c, F(0.5))
        b_ = _clamp_min(n - m, F(1))
        part2 = ((a_ + F(0.5)) * log1p(d / a_) + d * log(b_) - d + _fc(b_)
                 - _fc(_clamp_min(n - k_c, F(1))))
        if v2 <= d * log_r + part1 + part2:
            return k_c
    return np.rint(n * p)


def _lane_kind(n, p):
    """binomial_kernel's Lane: (kind, n, p_eff, flip, mean), kind 0 for a
    lane settled without a draw, 1 the inversion, 2 BTRS."""
    pc = _clamp_min(_clamp_max(F(p), F(1)), F(0))
    flip = pc > F(0.5)
    p_eff = F(1) - pc if flip else pc
    with np.errstate(invalid="ignore"):          # inf · 0 is NaN
        mean = F(n) * p_eff
    if not mean <= F(10):
        kind = 2                                 # a NaN mean too
    else:
        kind = 0 if F(n) == 0 or p_eff == 0 else 1
    return kind, F(n), p_eff, flip, mean


def _binomial_model(key, n, p, rounds=6):
    """binomial_kernel's CTAs, BIN_THREADS lanes each: settled lanes
    written at once, the others laid out by the warps' ballots,
    inversion lanes first, then BTRS lanes, each in thread order; thread
    j computes the lane at place j, only its branch. Also checks that
    every warp but one a CTA runs one branch."""
    k_inv, k_btrs = prng.split(key)
    kuv = prng.split(prng.split(k_btrs, rounds))
    out = np.zeros(len(n), np.float32)
    written = np.zeros(len(n), np.int32)
    mixed = 0
    for base in range(0, len(n), BIN_THREADS):
        lanes = {t: _lane_kind(n[base + t], p[base + t])
                 for t in range(min(BIN_THREADS, len(n) - base))}
        order = ([t for t, l in lanes.items() if l[0] == 1]
                 + [t for t, l in lanes.items() if l[0] == 2])
        for j0 in range(0, len(order), 32):
            mixed += len({lanes[t][0] for t in order[j0:j0 + 32]}) > 1
        for t in [t for t, l in lanes.items() if l[0] == 0] + order:
            kind, ni, p_eff, flip, mean = lanes[t]
            i = base + t
            if kind == 0:
                cnt = F(0)
            elif kind == 1:
                cnt = _inversion_lane(i, k_inv, ni, p_eff)
            else:
                big = mean > F(10)
                cnt = _btrs_lane(i, kuv[:, 0], kuv[:, 1], rounds,
                                 ni if big else F(100),
                                 p_eff if big else F(0.2))
            cnt = _minimum(_clamp_min(cnt, F(0)), ni)
            out[i] = ni - cnt if flip else cnt
            written[i] += 1
    assert (written == 1).all()
    assert mixed <= -(-len(n) // BIN_THREADS)
    return out


def _binomial_lanes(seed: int):
    """384 lanes: the darts' kind (many n = 0, small p), n·p on both sides
    of 10 and at 10, p above 0.5, p at 0, 0.5 and 1, large n, NaN p."""
    r = np.random.default_rng(seed)
    n = np.concatenate([
        np.where(r.random(128) < 0.5, 0, np.floor(r.random(128) ** 3 * 400)),
        np.floor(r.random(128) * 3000),
        [0, 0, 20, 20, 40, 12, 1e5, 3e5, 50, 50, 7, 7, 1, 1, 1000, 2000],
        np.floor(10 + r.random(112) * 90)]).astype(np.float32)
    p = np.concatenate([
        r.random(128) * 0.05, r.random(128) ** 2,
        [0.3, 0.9, 0.5, 0.25, 0.75, 1.0, 1e-4, 0.5, 0, 1, 0.5, 0.99, 0.5,
         np.nan, np.nan, 0.6],
        10.0 / np.floor(10 + r.random(112) * 90) * r.uniform(0.8, 1.2, 112)
        ]).astype(np.float32)
    return n, p


KAPPAS = (1.0 / 0.86 ** 2, 1.0 / 0.45 ** 2)


@pytest.mark.parametrize("kappas,rounds,lanes", [
    (KAPPAS, 4, 384), (KAPPAS[::-1], 4, 389), ((1.01, 1.2), 1, 389),
    ((2.5, 1.05), 6, 101)])
def test_gamma_lane_model(kappas, rounds, lanes):
    """The pair's two samples, each a group of threads a lane with the
    first accepting round chosen across the group, equal their twins bit
    for bit and the one-sample launch; one round at a kappa near 1 takes
    the kappa fallback on some lanes. Within 1e-5 of the JAX package."""
    keys = prng.split(prng.PRNGKey(3), 2)
    model = _gamma_model(list(zip(keys, kappas)), lanes, rounds)
    one = _gamma_model([(keys[1], kappas[1])], lanes, rounds)
    np.testing.assert_array_equal(one[0].view(np.int32),
                                  model[1].view(np.int32))
    for h, (key, kappa) in enumerate(zip(keys, kappas)):
        twin = trandom.gamma_fixed_twin(key, kappa, (lanes,), "cpu",
                                        rounds).numpy()
        np.testing.assert_array_equal(model[h].view(np.int32),
                                      twin.view(np.int32))
        want = np.asarray(_jax_gamma(jnp.asarray(key), kappa, (lanes,),
                                     rounds))
        np.testing.assert_allclose(model[h], want, rtol=1e-5, atol=0)
    if rounds == 1:
        assert (model[0] == F(kappas[0])).sum() > 0


@pytest.mark.parametrize("seed", [4, 5, "edges"])
def test_binomial_lane_model(seed):
    """The CTAs' branch partition, the settled lanes and the reciprocal
    table against the twin bit for bit, on made-up lanes and on
    kernels/checks.py's edges; at least 99.9% equal to the JAX
    package's samples."""
    if seed == "edges":
        from reina_tpu_torch.kernels import checks
        n, p = (x.numpy() for x in checks.binomial_edges("cpu"))
        seed = 6
    else:
        n, p = _binomial_lanes(seed)
    key = prng.PRNGKey(seed)
    model = _binomial_model(key, n, p)
    twin = trandom.binomial_fixed_twin(key, torch.from_numpy(n),
                                       torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(model.view(np.int32), twin.view(np.int32))
    assert ((model >= 0) & (model <= n)).all()
    want = np.asarray(_jax_binomial(jr.PRNGKey(seed), jnp.asarray(n),
                                    jnp.asarray(p)))
    assert (model == want).mean() >= 0.999, np.flatnonzero(model != want)


def test_gamma_fixed_pair_on_cpu_is_two_twins():
    """gamma_fixed_pair on the CPU: the two twin calls, bit for bit, for
    keys by value and in (CPU) memory, and no launch."""
    before = kernels.launches()
    k1, k2 = prng.split(prng.PRNGKey(8), 2)
    for shape, rounds in (((4608,), 4), ((7, 3), 1), ((1,), 6)):
        dk = trandom.dev_key(k2, "cpu", trandom.gamma_words, rounds)
        for key2 in (k2, dk):
            got = trandom.gamma_fixed_pair(k1, KAPPAS[0], key2, KAPPAS[1],
                                           shape, "cpu", rounds)
            assert len(got) == 2
            for g, key, kappa in zip(got, (k1, k2), KAPPAS):
                want = trandom.gamma_fixed_twin(key, kappa, shape, "cpu",
                                                rounds)
                assert g.shape == want.shape
                assert torch.equal(g.view(torch.int32),
                                   want.view(torch.int32))
    assert kernels.launches() == before


def test_wrappers_on_cpu_run_twins_and_launch_nothing():
    """On CPU tensors every wrapper is its twin, bit for bit, and counts
    no launch; on a device that is neither, it raises (no twin)."""
    key = prng.PRNGKey(11)
    before = kernels.launches()
    n = torch.tensor([0.0, 3.0, 40.0, 500.0])
    p = torch.tensor([0.2, 0.7, 0.5, 0.1])
    pairs = [
        (prng.random_bits(key, (5, 3), "cpu"),
         prng.random_bits_twin(key, (5, 3), "cpu")),
        (prng.uniform(key, (9,), "cpu", 1e-37, 1.0, start=4),
         prng.uniform_twin(key, (9,), "cpu", 1e-37, 1.0, start=4)),
        (prng.normal(key, (9,), "cpu", start=2),
         prng.normal_twin(key, (9,), "cpu", start=2)),
        (prng.gumbel(key, (4, 6), "cpu"),
         prng.gumbel_twin(key, (4, 6), "cpu")),
        (trandom.gamma_fixed(key, 2.5, (17,), "cpu"),
         trandom.gamma_fixed_twin(key, 2.5, (17,), "cpu")),
        (torch.stack(trandom.gamma_fixed_pair(key, 2.5, key, 1.5, (17,),
                                              "cpu")),
         torch.stack([trandom.gamma_fixed_twin(key, 2.5, (17,), "cpu"),
                      trandom.gamma_fixed_twin(key, 1.5, (17,), "cpu")])),
        (trandom.binomial_fixed(key, n, p),
         trandom.binomial_fixed_twin(key, n, p)),
    ]
    for got, want in pairs:
        assert got.device.type == "cpu" and torch.equal(got, want)
    assert kernels.launches() == before
    with pytest.raises(ValueError, match="device"):
        prng.uniform(key, (4,), "meta")
    with pytest.raises(ValueError, match="device"):
        trandom.gamma_fixed(key, 2.5, (4,), "meta")
    with pytest.raises(ValueError, match="device"):
        trandom.gamma_fixed_pair(key, 2.5, key, 1.5, (4,), "meta")
    with pytest.raises(ValueError, match="device"):
        trandom.binomial_fixed(key, n.to("meta"), p.to("meta"))
    assert kernels.launches() == before


# ---------------------------------------------------------------------------
# the kernels' constants

def _nearest_f32(literal: str):
    """The float32 nearest the decimal ``literal`` (ties to even), as a
    C++ compiler rounds a float literal."""
    x = Fraction(literal)
    a = np.float32(float(literal))
    cands = [a, np.nextafter(a, F(-np.inf)), np.nextafter(a, F(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))


def test_kernel_constants_are_the_twins():
    """Every float literal of the draw kernels' sources rounds straight to
    the float32 the twin's Python scalar becomes (no double rounding),
    the erf_inv coefficients are prng's in order, the round limits are
    random.py's."""
    lit = re.compile(r"(?<![\w.])(\d+\.\d*(?:e[-+]?\d+)?|\d+e[-+]?\d+)f\b")
    found = 0
    for src in SOURCES.values():
        for s in lit.findall(src):
            assert _nearest_f32(s) == np.float32(float(s)), s
            found += 1
    assert found > 40
    pairs = re.findall(r"lt \? (-?[\d.e-]+)f : (-?[\d.e-]+)f",
                       SOURCES["threefry.cuh"])
    assert [F(a) for a, _ in pairs] == [F(c) for c in prng._ERFINV_LT5]
    assert [F(b) for _, b in pairs] == [F(c) for c in prng._ERFINV_GE5]
    assert "1.41421354f" in SOURCES["threefry.cuh"]
    assert F(1.41421354) == F(prng._SQRT2)
    assert MAX_ROUNDS == trandom.MAX_ROUNDS
    assert MAX_COUNT == 48
    # the inversion's reciprocals: the twin's float32 1 / (k + 1)
    assert RECIP == [F(1) / F(k + 1) for k in range(MAX_COUNT)]
