"""The port's kernel twins and plain ops against the JAX package's
functions, run as the JAX package's own tests run them on the CPU: the
Pallas kernels in interpret mode (``force="interpret"``) and their XLA
forms (``force="xla"``). Inputs come from numpy seeds.

Tolerances: the fused bodies' integer and bool outputs are exact and
their float outputs within 2 ulp (``exp`` differs between XLA:CPU and
torch by up to 1 ulp); the ledger grants, the prefix sums (integer and
real-valued weights), the histograms and the compaction are exact. The
samplers draw the same uniforms; their transcendental functions differ
by ulps, so gamma draws are held to 1e-5 relative and binomial counts
agree on at least 99.9% of entries.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from reina_tpu.core import step as jstep
from reina_tpu.ops import clamped as jclamped
from reina_tpu.ops import compact as jcompact
from reina_tpu.ops import fusedmap as jfm
from reina_tpu.ops import random as jrandom
from reina_tpu_torch.core import step as tstep
from reina_tpu_torch.ops import clamped, compact, fusedmap, prng
from reina_tpu_torch.ops import random as trandom

torch.set_num_threads(1)

N = 4096
V, T, B = 2, 21, 9
FORCES = ["interpret", "xla"]


def _streams(seed):
    r = np.random.default_rng(seed)
    return dict(
        st=r.integers(0, 7, N).astype(np.int8),
        sev=r.integers(0, 5, N).astype(np.int8),
        var=r.integers(0, V, N).astype(np.int8),
        dl=r.integers(0, 4, N).astype(np.int16),
        doil=r.integers(-2, 12, N).astype(np.int16),
        doi=r.integers(-1, 30, N).astype(np.int16),
        b=[r.random(N) < p for p in (0.3, 0.5, 0.7, 0.2, 0.6, 0.4, 0.5,
                                      0.3, 0.1, 0.5, 0.5, 0.5, 0.5, 0.5)],
        f=[r.random(N).astype(np.float32) for _ in range(6)],
        z=r.standard_normal(N).astype(np.float32),
        nc=(r.random(N) * 30).astype(np.float32),
        ninf=r.integers(0, 5, N).astype(np.int32),
        band=r.integers(0, B, N).astype(np.int32),
        lam=np.log1p(-r.random((V, N)) * 1e-3).astype(np.float32),
        o2r=(r.random(N) * 30).astype(np.float32),
        vnew=r.integers(0, V, N).astype(np.int32),
        tabs=[(r.random(V) * 0.8 + 0.05).astype(np.float32)
              for _ in range(6)],
        iot=(r.random((V, T)) * 0.2).astype(np.float32),
        D=np.floor(r.random((V, B)) * 500).astype(np.float32),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def _cmp(jax_outs, torch_outs, max_ulp=2):
    assert len(jax_outs) == len(torch_outs)
    for i, (a, b) in enumerate(zip(jax_outs, torch_outs)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.int32 and b.dtype != np.int32:
            b = b.astype(np.int32)   # the JAX twin widened a narrow field
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if a.dtype == np.float32:
            ulp = np.abs(a.view(np.int32).astype(np.int64)
                         - b.view(np.int32))
            assert ulp.max() <= max_ulp, (i, ulp.max())
        else:
            np.testing.assert_array_equal(a.astype(b.dtype), b,
                                          err_msg=f"output {i}")


@pytest.mark.parametrize("force", FORCES)
def test_prologue(force):
    s = _streams(1)
    b = s["b"]
    args = [s["st"], s["dl"], s["doil"], s["doi"], s["sev"], s["var"],
            b[0], b[1], b[2], s["z"], s["nc"], b[3], s["ninf"]]
    day = 12
    want = jfm.fused_map(jstep._phase4_prologue, 7,
                         [jnp.asarray(a) for a in args],
                         [jnp.asarray(s["iot"]), jnp.asarray(s["tabs"][0]),
                          jnp.asarray(s["tabs"][1]), jnp.int32(day)],
                         force=force)
    got = tstep.prologue(*[_t(a) for a in args], _t(s["iot"]),
                         _t(s["tabs"][0]), _t(s["tabs"][1]), day)
    _cmp(want, got)


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("mode", [0, 1, 3])
def test_recv_front(force, mode):
    s = _streams(2)
    b, f = s["b"], s["f"]
    streams = [s["band"], s["lam"][0], s["lam"][1], b[0], b[1], b[2], f[0],
               f[1], s["st"], s["doi"], s["dl"], s["o2r"], s["sev"], b[3],
               b[4], s["doil"], f[2], s["var"]]
    day, dap = 15, np.float32(0.4)
    want = jfm.fused_map(
        jstep._make_recv_front_body(V, B), 16,
        [jnp.asarray(a) for a in streams],
        [jnp.asarray(s["D"]), jnp.asarray(s["tabs"][0]),
         jnp.asarray(s["tabs"][1]), jnp.asarray([day, mode], jnp.int32),
         jnp.asarray(dap)], force=force)
    targs = [_t(a) for a in streams]
    got = tstep.recv_front(targs[0], _t(s["lam"]), *targs[3:],
                           _t(s["D"]), _t(s["tabs"][0]), _t(s["tabs"][1]),
                           day, mode, float(dap))
    _cmp(want, got)


@pytest.mark.parametrize("force", FORCES)
def test_post(force):
    s = _streams(3)
    b = s["b"]
    args = [s["st"], s["sev"], s["var"], s["o2r"], s["dl"], b[0], b[1],
            s["f"][0], b[2], b[3], b[4], b[5], b[6], b[7], b[8], b[9],
            b[10], b[11], b[12], b[13]]
    tabs = s["tabs"][:4]
    want = jfm.fused_map(jstep._phase5_post, 7,
                         [jnp.asarray(a) for a in args],
                         [jnp.asarray(t) for t in tabs], force=force)
    got = tstep.post(*[_t(a) for a in args], *[_t(t) for t in tabs])
    _cmp(want, got)


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("ct", [0, 1])
def test_finalize(force, ct):
    s = _streams(4)
    b = s["b"]
    args = [s["st"], s["sev"], s["var"], s["vnew"], s["dl"], s["doil"],
            s["doi"], b[0], b[1], b[2], b[3], b[4]]
    jargs = [jnp.asarray(a) for a in args]
    for i in (0, 1, 2):   # the JAX day step passes these widened
        jargs[i] = jargs[i].astype(jnp.int32)
    want = jfm.fused_map(jstep._finalize_body, 9, jargs,
                         [jnp.int32(9), jnp.int32(ct)], force=force)
    got = tstep.finalize(*[_t(a) for a in args], 9, ct)
    _cmp(want, got)


def _ledger_inputs(seed, n):
    r = np.random.default_rng(seed)
    rel = [r.integers(0, 2, n).astype(np.int32) * (r.random(n) < 0.05)
           for _ in range(2)]
    req = [r.random(n) < 0.08 for _ in range(2)]
    return rel, req


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("case", [(0, 0, (3, 1)), (1, 777, (40, 9)),
                                  (2, 4095, (0, 0)), (3, 2048, (500, 100))])
def test_clamped_counter_grants(force, case):
    seed, offset, init = case
    rel, req = _ledger_inputs(seed, N)
    (jg0, jg1), jfin = jclamped.clamped_counter_grants(
        [jnp.asarray(x) for x in rel], [jnp.asarray(x) for x in req],
        jnp.asarray(init, jnp.int32), jnp.int32(offset), force=force)
    (g0, g1), fin = clamped.clamped_counter_grants(
        [_t(x) for x in rel], [_t(x) for x in req],
        torch.tensor(init, dtype=torch.int32), offset)
    np.testing.assert_array_equal(np.asarray(jg0), g0.numpy())
    np.testing.assert_array_equal(np.asarray(jg1), g1.numpy())
    np.testing.assert_array_equal(np.asarray(jfin), fin.numpy())


@pytest.mark.parametrize("offset", [0, 1, 1500, 4095])
def test_grants_from_kernel_streams(offset):
    """The glue the CUDA path runs after the ledger kernel, fed the U/rm
    streams of the JAX package's Pallas ledger kernel (interpret)."""
    rel, req = _ledger_inputs(5, N)
    init = np.array([20, 4], np.int32)
    U, rm, _ = jclamped._ledger_kernel(
        [jnp.asarray(x) for x in rel], [jnp.asarray(x) for x in req],
        jnp.int32(offset), jnp.int32(0), interpret=True)
    granted, fin = clamped.grants_from_streams(
        [_t(np.asarray(u)) for u in U], [_t(np.asarray(x)) for x in rm],
        [_t(x) for x in rel], [_t(x) for x in req], _t(init), offset)
    (t0, t1), tfin = clamped.grants_twin(
        [_t(x) for x in rel], [_t(x) for x in req], _t(init), offset)
    np.testing.assert_array_equal(granted[0].numpy(), t0.numpy())
    np.testing.assert_array_equal(granted[1].numpy(), t1.numpy())
    np.testing.assert_array_equal(fin.numpy(), tfin.numpy())


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("n_seg,integer", [(1, True), (1, False),
                                           (2, True), (2, False)])
def test_fused_concat_prefix(force, n_seg, integer):
    r = np.random.default_rng(6)
    n = 8192
    w = (r.random(n) * 3).astype(np.float32)
    if integer:
        w = np.floor(w * 10).astype(np.float32)
    codes = r.integers(0, n_seg, n).astype(np.int32)
    jc = None if n_seg == 1 else jnp.asarray(codes)
    tc = None if n_seg == 1 else _t(codes)
    for rows in (2048, 16):   # one block per segment, then several
        want = np.asarray(jfm.fused_concat_prefix(
            jnp.asarray(w), jc, n_seg, max_block_rows=rows, force=force))
        got = fusedmap.fused_concat_prefix(_t(w), tc, n_seg,
                                           max_block_rows=rows).numpy()
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


@pytest.mark.parametrize("force", FORCES)
def test_fused_onehot_sum(force):
    r = np.random.default_rng(7)
    K, nb = 13, 11
    parts = [r.random(N) < 0.3 for _ in range(K)]
    code = r.integers(-1, nb + 2, N).astype(np.int32)
    want = jfm.fused_onehot_sum([jnp.asarray(p) for p in parts],
                                jnp.asarray(code), nb, max_block=1024,
                                force=force)
    got = fusedmap.fused_onehot_sum([_t(p) for p in parts], _t(code), nb)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("force", FORCES)
def test_fused_bihistogram(force):
    r = np.random.default_rng(8)
    na, nb = 84, 101
    ca = r.integers(-1, na + 1, N).astype(np.int32)
    cb = r.integers(0, nb, N).astype(np.int32)
    w = r.integers(0, 129, N).astype(np.float32)
    want = jfm.fused_bihistogram(jnp.asarray(ca), na, jnp.asarray(w),
                                 jnp.asarray(cb), nb, max_block=1024,
                                 force=force)
    got = fusedmap.fused_bihistogram(_t(ca), na, _t(w), _t(cb), nb)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("force", FORCES)
def test_fused_fn_onehot_sum(force):
    s = _streams(9)
    b = s["b"]
    code = np.random.default_rng(9).integers(0, 11, N).astype(np.int32)
    fields = [b[0], b[1], b[2], s["doi"], b[3], s["st"], b[4], b[5], b[6]]
    want = jfm.fused_fn_onehot_sum(
        [jnp.asarray(f) for f in fields], jstep._output_masks_reduced, 10,
        jnp.asarray(code), 11, max_block=1024, force=force)
    got = fusedmap.fused_fn_onehot_sum(
        [_t(f) for f in fields], tstep._output_masks_reduced, 10, _t(code),
        11)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("p,cap", [(0.001, 64), (0.05, 64), (0.3, 4096)])
def test_compact_indices(force, p, cap):
    mask = np.random.default_rng(10).random(N) < p
    jb, jn = jcompact.compact_indices(jnp.asarray(mask), cap, head=16,
                                      force=force)
    tb, tn = compact.compact_indices(_t(mask), cap)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    assert int(jn) == int(tn)


@pytest.mark.parametrize("kappa", [1.0 / 0.86 ** 2, 1.0 / 0.45 ** 2])
def test_gamma_fixed(kappa):
    want = np.asarray(jrandom.gamma_fixed(jr.PRNGKey(3), kappa, (5000,)))
    got = trandom.gamma_fixed(prng.PRNGKey(3), kappa, (5000,), "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_binomial_fixed():
    r = np.random.default_rng(11)
    n = np.floor(r.random(20000) ** 3 * 3000).astype(np.float32)
    p = (r.random(20000) ** 2).astype(np.float32)
    want = np.asarray(jrandom.binomial_fixed(jr.PRNGKey(4), jnp.asarray(n),
                                             jnp.asarray(p)))
    got = trandom.binomial_fixed(prng.PRNGKey(4), _t(n), _t(p)).numpy()
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= n).all()
    assert (got == want).mean() >= 0.999, (got != want).sum()


def test_expand_by_age():
    """The gather form equals the bf16 one-hot matmuls exactly."""
    r = np.random.default_rng(12)
    A = 101
    ages = r.integers(0, A, 3000).astype(np.int32)
    per_age = (r.random(A) * 40).astype(np.float32)

    class J:
        age_onehot_hi = jnp.asarray(np.eye(13)[ages // 8], jnp.bfloat16)
        age_onehot_lo = jnp.asarray(np.eye(8)[ages % 8], jnp.bfloat16)

    class Tt:
        pass
    Tt.ages = _t(ages)
    for terms in (2, 3):
        want = np.asarray(jstep.expand_by_age(J, jnp.asarray(per_age), terms))
        got = tstep.expand_by_age(Tt, _t(per_age), terms).numpy()
        np.testing.assert_array_equal(want, got)
