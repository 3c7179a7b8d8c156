"""The port's threefry PRNG against jax.random (jax 0.9,
jax_threefry_partitionable=True).

Tolerances: key derivations (PRNGKey, split, fold_in), random bits,
uniform (with and without minval) and randint are bit-exact.
``normal`` and ``gumbel`` pass the same uniform bits through
log1p/log/sqrt, which XLA:CPU does not round correctly (its sqrt alone
differs from the IEEE result on ~0.6% of floats), so they are held to
4 ulp (normal) and 2e-6 absolute (gumbel, whose values cross 0 where
ulps shrink).
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reina_tpu.core.step import EngineConfig as JaxConfig
from reina_tpu.core.step import derive_day_keys as jax_day_keys
from reina_tpu_torch.core.step import EngineConfig, derive_day_keys
from reina_tpu_torch.ops import prng

torch.set_num_threads(1)

SHAPES = [(7,), (1000,), (8, 16), (33, 5), (5, 10, 2), (4, 3, 9)]


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1])
def test_keys_split_fold_in(seed):
    k, kp = jr.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k), kp)
    for num in (2, 4, 17):
        np.testing.assert_array_equal(np.asarray(jr.split(k, num)),
                                      prng.split(kp, num))
    for data in (0, 1, 77, 1000, 2 ** 31 - 1):
        np.testing.assert_array_equal(np.asarray(jr.fold_in(k, data)),
                                      prng.fold_in(kp, data))
    ks = jr.split(k, 5)
    vm = jax.vmap(lambda kk: jr.fold_in(kk, 9))(ks)
    np.testing.assert_array_equal(np.asarray(vm),
                                  prng.fold_in(prng.split(kp, 5), 9))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bits_exact(shape):
    k, kp = jr.PRNGKey(42), prng.PRNGKey(42)
    np.testing.assert_array_equal(
        _bits(jr.uniform(k, shape, jnp.float32)),
        _bits(prng.uniform(kp, shape, "cpu").numpy()))
    np.testing.assert_array_equal(
        _bits(jr.uniform(k, shape, jnp.float32, minval=1e-37)),
        _bits(prng.uniform(kp, shape, "cpu", minval=1e-37).numpy()))
    # 2-D draws are not prefix-stable: the port must keep the shape
    if len(shape) == 2 and shape[1] > 4:
        sub = prng.uniform(kp, (shape[0], 4), "cpu").numpy()
        assert not np.array_equal(
            sub, prng.uniform(kp, shape, "cpu").numpy()[:, :4])


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_and_gumbel(shape):
    k, kp = jr.PRNGKey(7), prng.PRNGKey(7)
    a = np.asarray(jr.normal(k, shape, jnp.float32))
    b = prng.normal(kp, shape, "cpu").numpy()
    ulp = np.abs(_bits(a).astype(np.int64) - _bits(b))
    assert ulp.max() <= 4, ulp.max()
    g = np.asarray(jr.gumbel(k, shape, jnp.float32))
    h = prng.gumbel(kp, shape, "cpu").numpy()
    np.testing.assert_allclose(h, g, rtol=0, atol=2e-6)


def test_normal_large_sample_ulp_bound():
    k, kp = jr.PRNGKey(11), prng.PRNGKey(11)
    a = np.asarray(jr.normal(k, (200_000,), jnp.float32))
    b = prng.normal(kp, (200_000,), "cpu").numpy()
    ulp = np.abs(_bits(a).astype(np.int64) - _bits(b))
    assert ulp.max() <= 4
    assert (ulp > 0).mean() < 0.1


@pytest.mark.parametrize("maxval", [7, 1000, 20480, 1686528])
def test_randint_scalar_exact(maxval):
    for s in range(25):
        assert int(jr.randint(jr.PRNGKey(s), (), 0, maxval)) == \
            prng.randint_scalar(prng.PRNGKey(s), 0, maxval)


# jax.random.randint of each key of a (D, 2) array, the bound traced
_randint_each = jax.jit(jax.vmap(lambda k, hi: jr.randint(k, (), 0, hi),
                                 in_axes=(0, None)))


@pytest.mark.parametrize("maxval", [20480, 480256, 1686528])
def test_randint_of_day_keys(maxval):
    """The vectorised randint over the ledger offsets' keys of 564 days
    (three seeds) equals randint_scalar key by key, and jax.random.randint
    of each key."""
    for seed in (0, 77, 2 ** 32 - 3):
        keys = derive_day_keys(EngineConfig(), prng.PRNGKey(seed),
                               np.arange(564)).base[:, 14]
        got = prng.randint(keys, 0, maxval)
        assert got.shape == (564,) and got.dtype == np.int64
        assert got.tolist() == [prng.randint_scalar(k, 0, maxval)
                                for k in keys]
        np.testing.assert_array_equal(
            np.asarray(_randint_each(jnp.asarray(keys), maxval)), got)


@pytest.mark.parametrize("vacc_slots", [1, 3])
def test_derive_day_keys_exact(vacc_slots):
    jcfg = JaxConfig(vacc_slots=vacc_slots)
    cfg = EngineConfig(vacc_slots=vacc_slots)
    base = jr.PRNGKey(5)
    days = np.arange(0, 40, 13)
    ours = derive_day_keys(cfg, prng.PRNGKey(5), days)
    for i, d in enumerate(days):
        ref = jax_day_keys(jcfg, base, jnp.int32(d))
        for name, r in ref._asdict().items():
            np.testing.assert_array_equal(np.asarray(r),
                                          getattr(ours, name)[i], name)
