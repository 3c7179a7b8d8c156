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
import functools

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
from reina_tpu_torch.kernels.checks import post_edge_args
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


@pytest.mark.parametrize("force,n", [("xla", 4013), ("interpret", 4096)])
def test_post_rounding_edge(force, n):
    """hosp_days and icu_days on the rounding edge of floor(o2r * x +
    0.5) (kernels/checks.py:post_edge_args). The twin rounds the product
    and the sum each on its own; on these inputs a fused multiply-add
    gives other days_left, so the CUDA kernel, held to the twin on the
    same inputs on the card, must not contract them. The JAX package's
    XLA form (run op by op) equals the twin at an N that is not a
    multiple of 16; its Pallas form in interpret mode, compiled whole by
    XLA:CPU, contracts them into an FMA (ROADMAP.md, queue 3): there the
    twin differs from it on the edge agents only."""
    args = post_edge_args(n, 0, "cpu")
    got = tstep.post(*args)
    np_args = [a.numpy() for a in args]
    want = jfm.fused_map(jstep._phase5_post, 7,
                         [jnp.asarray(a) for a in np_args[:20]],
                         [jnp.asarray(t) for t in np_args[20:]], force=force)
    o2r, sev, var = np_args[3], np_args[1], np_args[2].astype(np.int64)
    bed, icu, gbed, gicu = np_args[8], np_args[9], np_args[5], np_args[6]
    rb, rw, one = np_args[20][var], np_args[21][var], np.float32(1)
    x = np.where(icu, (one - rw) - rb, np.where(sev == 2, one - rb, rw))
    p = o2r.astype(np.float64) * x.astype(np.float64)      # exact
    apart = np.floor(p.astype(np.float32) + np.float32(0.5))
    fused = np.floor((p + 0.5).astype(np.float32))
    u, p_icu = np_args[7], np_args[22][var]
    icu_enter = icu & (gicu | (u >= np.where(sev == 4, 1, p_icu)))
    days = (bed & gbed) | icu_enter        # agents that take a day count
    np.testing.assert_array_equal(got[1].numpy()[days], apart[days])
    assert (apart[days] != fused[days]).sum() > n // 10
    assert set(np.unique(apart[days])) == {0.0, 1.0}
    if force == "xla":
        _cmp(want, got)
    else:
        jdl = np.asarray(want[1])
        np.testing.assert_array_equal(jdl[days], fused[days])
        edge = days & (apart != fused)
        np.testing.assert_array_equal(jdl[~edge], got[1].numpy()[~edge])
        _cmp(want[:1] + want[2:], got[:1] + got[2:])


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


# ---- plain-torch models of the CUDA kernels' association, held to the
# twins here because the kernels themselves run only on the card

NEG = -(1 << 30)               # the key of a position without a request
NEG_INF = -(1 << 62)
ID = (0, NEG_INF, NEG_INF)     # identity of the ledger monoid


def _combine(x, y):
    """(s, ka, kf) of segment x followed by segment y (ledger.cu)."""
    return (x[0] + y[0], torch.maximum(x[1], y[1] - x[0]),
            torch.maximum(x[2], y[2] - x[0]))


def _shift(x, k):
    """Each part moved k places later along the last axis, identities
    in front."""
    return tuple(torch.cat([torch.full_like(v[..., :k], i), v[..., :-k]],
                           -1) for v, i in zip(x, ID))


def _scan(x):
    """Inclusive monoid scan along the last axis (Hillis-Steele, the
    association of the kernel's shuffles; any gives the same ints)."""
    k = 1
    while k < x[0].shape[-1]:
        x = _combine(_shift(x, k), x)
        k *= 2
    return x


def _ledger_model(rel, req, init, offset, tile):
    """ledger.cu's three launches over tiles of ``tile`` agents: tile
    folds (and the fold of offset's tile before offset), the scan of
    the tile folds with the boundary scalars, the rescan that emits the
    grants. int64 throughout."""
    n = rel[0].shape[0]
    ntiles = -(-n // tile)
    idx = torch.arange(ntiles * tile)
    valid = idx < n
    t_off, o = divmod(offset, tile)
    granted, finals = [], []
    for r, q, i0 in zip(rel, req, init):
        r = torch.nn.functional.pad(r.long(), (0, ntiles * tile - n))
        q = torch.nn.functional.pad(q.long(), (0, ntiles * tile - n))
        s = r - q
        kf = torch.where(q == 1, 0, NEG) - s
        ka = torch.where(idx >= offset, kf, NEG_INF)
        e = tuple(torch.where(valid, v, i).reshape(ntiles, tile)
                  for v, i in zip((s, ka, kf), ID))
        # K1
        inc = _scan(e)
        folds = tuple(v[:, -1] for v in inc)
        pre = ID if o == 0 else tuple(v[t_off, o - 1] for v in inc)
        # K2
        tinc = _scan(folds)
        excl = _shift(tinc, 1)
        total = tuple(v[-1] for v in tinc)
        at_off = _combine(tuple(v[t_off] for v in excl),
                          tuple(torch.as_tensor(v) for v in pre))
        c_off = at_off[0]
        base_a = int(i0) - c_off
        final_a = total[0] + torch.maximum(base_a, total[1])
        finals.append(c_off + torch.maximum(final_a, at_off[2]))
        # K3
        cur = _combine(tuple(v[:, None] for v in excl), _shift(inc, 1))
        cur = tuple(v.reshape(-1) for v in cur)
        m = torch.where(idx >= offset, torch.maximum(base_a, cur[1]),
                        torch.maximum(final_a, cur[2]))
        granted.append(((q == 1) & (cur[0] + r + m > 0))[:n])
    return granted, torch.stack(finals).to(torch.int32)


NL = 9 * 1024            # 2.25 tiles of 4096: the last one partial


@functools.lru_cache(maxsize=None)
def _jax_grants(offset):
    """The JAX package's Pallas ledger (interpret) on test inputs."""
    rel, req = _ledger_inputs(5, NL)
    return jclamped.clamped_counter_grants(
        [jnp.asarray(x) for x in rel], [jnp.asarray(x) for x in req],
        jnp.asarray(np.array([20, 4], np.int32)), jnp.int32(offset),
        force="interpret")


@pytest.mark.parametrize("offset", [0, 1, 4096, NL - 1],
                         ids=["0", "1", "tile-edge", "last"])
@pytest.mark.parametrize("tile", [4, 64, 4096])
def test_ledger_kernel_model(tile, offset):
    """The kernel's tile fold, tile scan with boundary scalars and emit
    equal the twin and the JAX package's Pallas ledger (interpret)."""
    rel, req = _ledger_inputs(5, NL)
    init = np.array([20, 4], np.int32)
    (j0, j1), jfin = _jax_grants(offset)
    trel, treq = [_t(x) for x in rel], [_t(x) for x in req]
    granted, fin = _ledger_model(trel, treq, init, offset, tile)
    (t0, t1), tfin = clamped.grants_twin(trel, treq, _t(init), offset)
    for got, twin, jax_ in ((granted[0], t0, j0), (granted[1], t1, j1),
                            (fin, tfin, jfin)):
        np.testing.assert_array_equal(got.numpy(), twin.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_))


def _shift_lanes(v, m):
    """Lane l gets lane l - m's value, +0.0 for l < m (__shfl_up_sync)."""
    out = torch.zeros_like(v)
    out[:, m:] = v[:, :-m]
    return out


def _row_lane_scan(v):
    """prefix.cu's lane_scan of (rows, 32 lanes, 4 values): steps k = 1, 2
    within a lane and its left neighbour, k >= 4 across k / 4 lanes."""
    u3 = _shift_lanes(v[..., 3], 1)
    v = torch.stack([v[..., 0] + u3, v[..., 1] + v[..., 0],
                     v[..., 2] + v[..., 1], v[..., 3] + v[..., 2]], -1)
    u2, u3 = _shift_lanes(v[..., 2], 1), _shift_lanes(v[..., 3], 1)
    v = torch.stack([v[..., 0] + u2, v[..., 1] + u3,
                     v[..., 2] + v[..., 0], v[..., 3] + v[..., 1]], -1)
    m = 1
    while m < 32:
        v = v + _shift_lanes(v, m)
        m *= 2
    return v


def _row_total(v):
    """prefix.cu's row_total of (rows, 32 lanes, 4 values): a pairwise
    tree in each lane, then 5 xor-shuffle rounds; every lane ends with
    the row's total."""
    x = (v[..., 3] + v[..., 2]) + (v[..., 1] + v[..., 0])
    lanes = torch.arange(32)
    m = 1
    while m < 32:
        x = x + x[:, lanes ^ m]
        m *= 2
    return x


def _prefix_model(w, codes, n_seg, max_block_rows):
    """prefix.cu's three phases: row totals as a pairwise tree, each
    logical block's row-offset scan and last value, then the serial
    carry and (x_ls + d) + carry from the lane scan."""
    R = w.shape[0] // fusedmap.LANE
    blk = fusedmap._largest_block(R, max_block_rows, 8)
    G = R // blk
    x = w.reshape(R, 32, 4)
    rows, offsets, last = [], [], []
    for s in range(n_seg):
        v = x if codes is None else torch.where(
            codes.reshape(R, 32, 4) == s, x, torch.zeros(()))
        tot = _row_total(v)                                   # 1
        assert (tot == tot[:, :1]).all()
        t = tot[:, 31].reshape(G, blk)
        r, k = t, 1
        while k < blk:                                        # 2
            r = r + torch.cat([torch.zeros_like(r[:, :k]), r[:, :-k]], 1)
            k *= 2
        rows.append(v)
        offsets.append((r - t).reshape(R))
        last.append(t[:, -1] + (r[:, -1] - t[:, -1]))
    carry, c = [], torch.zeros((), dtype=torch.float32)
    for h in torch.cat(last):                                 # 3
        carry.append(c)
        c = h + c
    row_block = torch.arange(R) // blk
    outs = [(_row_lane_scan(v) + d[:, None, None])
            + torch.stack(carry[s * G:(s + 1) * G])[row_block][:, None, None]
            for s, (v, d) in enumerate(zip(rows, offsets))]
    return torch.cat([o.reshape(-1) for o in outs])


@pytest.mark.parametrize("n_seg", [1, 2])
@pytest.mark.parametrize("blk", [8, 16, 24])
def test_prefix_kernel_model(n_seg, blk):
    """The kernel's tree row totals, register lane scan, row-offset scan
    and carry equal concat_prefix_twin bit for bit on real-valued
    weights."""
    r = np.random.default_rng(11)
    n = 48 * fusedmap.LANE      # 48 rows: blocks of 8, 16 and 24
    w = _t((r.random(n) * 3).astype(np.float32))
    codes = None if n_seg == 1 else _t(r.integers(0, n_seg, n)
                                       .astype(np.int32))
    assert fusedmap._largest_block(48, blk, 8) == blk
    got = _prefix_model(w, codes, n_seg, blk)
    want = fusedmap.concat_prefix_twin(w, codes, n_seg, max_block_rows=blk)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())


# ---- the sharded forms: every slab of an agent-sharded run in turn,
# the exchange between them done by stacking

def _slab_fold_model(rel, req, offset, base, tile):
    """ledger.cu's fold entry on a slab from global position ``base``:
    the tile folds (the cyclic mask at the global position), then, in
    the CTA whose ticket comes last, their scan; returns the slab's folds
    (its whole fold and the fold of its positions before offset, per
    ledger) and, per ledger, the tile scans the emit entry rescans."""
    n = rel[0].shape[0]
    ntiles = -(-n // tile)
    idx = torch.arange(ntiles * tile)
    valid = idx < n
    off = offset - base
    t_off, o = divmod(off, tile) if 0 < off < n else (0, 0)
    folds, scans = [], []
    for r, q in zip(rel, req):
        r = torch.nn.functional.pad(r.long(), (0, ntiles * tile - n))
        q = torch.nn.functional.pad(q.long(), (0, ntiles * tile - n))
        s = r - q
        kf = torch.where(q == 1, 0, NEG) - s
        ka = torch.where(idx >= off, kf, NEG_INF)
        e = tuple(torch.where(valid, v, i).reshape(ntiles, tile)
                  for v, i in zip((s, ka, kf), ID))
        inc = _scan(e)                                          # each CTA
        pre = ID if o == 0 else tuple(v[t_off, o - 1] for v in inc)
        tinc = _scan(tuple(v[:, -1] for v in inc))              # last CTA
        excl = _shift(tinc, 1)
        total = tuple(v[-1] for v in tinc)
        if off <= 0:
            before = tuple(torch.as_tensor(v) for v in ID)
        elif off >= n:
            before = total
        else:
            before = _combine(tuple(v[t_off] for v in excl),
                              tuple(torch.as_tensor(v) for v in pre))
        folds.append(torch.stack([torch.stack(total), torch.stack(before)]))
        scans.append((inc, excl, r, q))
    return torch.stack(folds), scans


def _slab_emit_model(scans, init, offset, base, all_folds, index, n):
    """ledger.cu's emit entry: warp 0's shuffle scan of the k slabs'
    folds (32 slabs a round; here k <= 32) gives the carry from the slabs
    before this one and, from all of them, the boundary scalars; then
    the tile rescans."""
    granted, finals = [], []
    for led, ((inc, excl, r, q), i0) in enumerate(zip(scans, init)):
        f = _scan(tuple(all_folds[:, led, 0, c] for c in range(3)))
        g = _scan(tuple(all_folds[:, led, 1, c] for c in range(3)))
        total = tuple(v[-1] for v in f)
        at_off = tuple(v[-1] for v in g)
        carry = (tuple(torch.as_tensor(v) for v in ID) if index == 0
                 else tuple(v[index - 1] for v in f))
        base_a = int(i0) - at_off[0]
        final_a = total[0] + torch.maximum(base_a, total[1])
        finals.append(at_off[0] + torch.maximum(final_a, at_off[2]))
        cur = _combine(tuple(v[None, None] for v in carry),
                       _combine(tuple(v[:, None] for v in excl),
                                _shift(inc, 1)))
        cur = tuple(v.reshape(-1) for v in cur)
        idx = torch.arange(cur[0].shape[0]) + base
        m = torch.where(idx >= offset, torch.maximum(base_a, cur[1]),
                        torch.maximum(final_a, cur[2]))
        granted.append(((q == 1) & (cur[0] + r + m > 0))[:n])
    return granted, torch.stack(finals).to(torch.int32)


def _sharded_ledger_model(rel, req, init, offset, k, tile):
    n = rel[0].shape[0] // k
    slabs = [([x[j * n:(j + 1) * n] for x in rel],
              [x[j * n:(j + 1) * n] for x in req]) for j in range(k)]
    folded = [_slab_fold_model(r, q, offset, j * n, tile)
              for j, (r, q) in enumerate(slabs)]
    all_folds = torch.stack([f for f, _ in folded])
    outs = [_slab_emit_model(sc, init, offset, j * n, all_folds, j, n)
            for j, (_, sc) in enumerate(folded)]
    for _, fin in outs[1:]:
        assert torch.equal(fin, outs[0][1])
    return ([torch.cat([g[led] for g, _ in outs]) for led in range(2)],
            outs[0][1])


def _sharded_ledger_twin(rel, req, init, offset, k):
    n = rel[0].shape[0] // k
    slabs = [([x[j * n:(j + 1) * n] for x in rel],
              [x[j * n:(j + 1) * n] for x in req]) for j in range(k)]
    all_folds = torch.stack([clamped.slab_folds_twin(r, q, offset, j * n)
                             for j, (r, q) in enumerate(slabs)])
    outs = [clamped.grants_twin_sharded(r, q, init, offset, j * n,
                                        all_folds, j)
            for j, (r, q) in enumerate(slabs)]
    for _, fin in outs[1:]:
        assert torch.equal(fin, outs[0][1])
    return ([torch.cat([g[led] for g, _ in outs]) for led in range(2)],
            outs[0][1])


@pytest.mark.parametrize("tile", [64, 4096])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_sharded_ledger_kernel_model(k, tile):
    """The sharded ledger's fold and emit entries, slab by slab, and
    grants_twin_sharded equal grants_twin bit for bit. NL / k is 4608,
    3072, 2304 or 1152 agents: tiles of 64 end on the slab edges, tiles
    of 4096 straddle them; offsets at 0, in the middle of a slab near
    its edge, on an edge and at the end."""
    rel, req = _ledger_inputs(5, NL)
    trel, treq = [_t(x) for x in rel], [_t(x) for x in req]
    init = _t(np.array([20, 4], np.int32))
    n = NL // k
    for offset in (0, n - 7, n, NL - 1):
        want, wfin = clamped.grants_twin(trel, treq, init, offset)
        for got, fin in (_sharded_ledger_model(trel, treq, init, offset, k,
                                               tile),
                         _sharded_ledger_twin(trel, treq, init, offset, k)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())
            np.testing.assert_array_equal(fin.numpy(), wfin.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_ledger_matches_jax(k, monkeypatch):
    """The port's sharded twin and kernel model equal the JAX package's
    _grants_sharded (4 virtual devices, shard_pallas, interpret mode),
    run as tests/test_clamped.py::test_sharded_grants_match_unsharded
    runs it; the twin also with the day's offset as a 0-d int32 tensor
    (the device offset a captured day's slab entries read; the kernel
    model reads the same value), at offsets on, just before and just
    after the slab edges and inside a slab."""
    import jax
    from jax.sharding import Mesh

    monkeypatch.setenv("REINA_SHARD_INTERPRET", "1")
    mesh = Mesh(np.array(jax.devices()[:k]).reshape(1, k), ("seed", "agent"))
    n = 8192
    nl = n // k
    rel, req = _ledger_inputs(7, n)
    init = np.array([4, 1], np.int32)
    trel, treq = [_t(x) for x in rel], [_t(x) for x in req]
    for off in (0, 1, n // 4, n // 2 + 3, n - 1, nl - 1, nl, nl + 1,
                n - nl - 1, n - nl):
        with jfm.shard_pallas(mesh):
            (j0, j1), jfin = jax.jit(
                lambda r, q, o: jclamped.clamped_counter_grants(
                    list(r), list(q), jnp.asarray(init), o))(
                [jnp.asarray(x) for x in rel],
                [jnp.asarray(x) for x in req], jnp.int32(off))
        dev_off = torch.tensor(off, dtype=torch.int32)
        for got, fin in (_sharded_ledger_twin(trel, treq, _t(init), off, k),
                         _sharded_ledger_twin(trel, treq, _t(init), dev_off,
                                              k),
                         _sharded_ledger_model(trel, treq, _t(init), off, k,
                                               4096)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(j0))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(j1))
            np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))


def _hs_rows(t):
    """prefix.cu's hs_rows: the Hillis-Steele scan of row totals along
    the last axis."""
    r, kk = t, 1
    while kk < t.shape[-1]:
        r = r + torch.cat([torch.zeros_like(r[..., :kk]), r[..., :-kk]], -1)
        kk *= 2
    return r


def _tree_last(tb):
    """prefix.cu's block_last of row totals tb (blk <= 2048): right-aligned
    in 2048 slots, zeros in front; 8 slots a thread as a tree, then the 32
    lanes of a warp and the 8 warps by xor-shuffles."""
    blk = tb.shape[-1]
    x = torch.cat([torch.zeros(2048 - blk), tb]).reshape(8, 32, 8)
    v = [x[..., j] for j in range(8)]
    x = ((v[7] + v[6]) + (v[5] + v[4])) + ((v[3] + v[2]) + (v[1] + v[0]))
    m = 1
    while m < 32:
        x = x + x[:, torch.arange(32) ^ m]
        m *= 2
    y = x[:, 0]
    m = 1
    while m < 8:
        y = y + y[torch.arange(8) ^ m]
        m *= 2
    return tb[-1] + (y[0] - tb[-1])


def _sharded_prefix_model(w, codes, n_seg, max_block_rows, k):
    """prefix.cu's two sharded entries slab by slab. Launch 1: the slab's
    row totals as a pairwise tree; its message (head and tail totals,
    then each whole block's last value by block_last). Launch 2, from the
    stacked messages: a role a block of the slab's own and a block that
    straddles a slab edge: an own block's phase 2 (the row offsets of
    the slab's rows in it), a straddling block's last value by
    block_last; every block's last value from the message of the slab
    that holds it or from its role, the serial carry, and (x_ls + d) +
    carry on the slab's rows only. Returns the slabs' outputs put back
    into the unsharded (n_seg·N,) order, and the segments' last
    values."""
    N = w.shape[0]
    R, nl = N // fusedmap.LANE, N // k
    Rl = R // k
    blk = fusedmap._largest_block(R, max_block_rows, 8)
    G = R // blk
    M = fusedmap.message_width(Rl, blk, k)
    lay = [fusedmap.slab_layout(Rl, blk, j) for j in range(k)]

    def seg(x, c, s):
        return x if c is None else torch.where(c == s, x, torch.zeros(()))

    def rows_of(j):
        x = w[j * nl:(j + 1) * nl].reshape(Rl, 32, 4)
        c = None if codes is None else codes[j * nl:(j + 1) * nl].reshape(
            Rl, 32, 4)
        return x, c

    msgs, tds = [], []
    for j in range(k):                                        # launch 1
        x, c = rows_of(j)
        td = torch.stack([_row_total(seg(x, c, s))[:, 31]
                          for s in range(n_seg)])
        a, h, t, fw, W = lay[j]
        msg = torch.zeros(n_seg, M)
        msg[:, :h], msg[:, h:h + t] = td[:, :h], td[:, Rl - t:]
        for wb in range(W):                                   # ticket's CTA
            for s in range(n_seg):
                msg[s, h + t + wb] = _tree_last(
                    td[s, h + wb * blk:h + (wb + 1) * blk])
        msgs.append(msg)
        tds.append(td)
    gathered = torch.stack(msgs)                              # (k, n_seg, M)
    strad = fusedmap.straddling(Rl, blk, k)
    out = torch.zeros(n_seg, N)
    for j in range(k):                                        # launch 2
        a = lay[j][0]
        td = tds[j].clone()
        own = range(a // blk, (a + Rl - 1) // blk + 1)

        def total(s, r):
            q = r // Rl
            if q == j:
                return tds[j][s, r - a]
            aq, hq, tq, _, _ = lay[q]
            return gathered[q, s, r - aq if r < aq + hq
                            else hq + r - (aq + Rl - tq)]
        hs = {}
        for s in range(n_seg):                                # the roles
            for B in sorted(set(own) | set(strad)):
                tb = torch.stack([total(s, B * blk + i) for i in range(blk)])
                if B in strad:
                    hs[s, B] = _tree_last(tb)
                if B in own:
                    rb = _hs_rows(tb)
                    for i in range(blk):
                        if a <= B * blk + i < a + Rl:
                            td[s, B * blk + i - a] = rb[i] - tb[i]

        def last(s, B):
            q = B * blk // Rl
            if (B * blk + blk - 1) // Rl == q:
                _, hq, tq, fwq, _ = lay[q]
                return gathered[q, s, hq + tq + B - fwq]
            return hs[s, B]
        carry, c_ = {}, torch.zeros(())
        for s in range(n_seg):
            for B in range(G):
                carry[s, B] = c_
                c_ = last(s, B) + c_
        ends = torch.stack([last(s, G - 1) + carry[s, G - 1]
                            for s in range(n_seg)])
        x, c = rows_of(j)
        rows = torch.arange(a, a + Rl)
        for s in range(n_seg):
            cb = torch.stack([carry[s, int(r) // blk] for r in rows])
            o = ((_row_lane_scan(seg(x, c, s)) + td[s][:, None, None])
                 + cb[:, None, None])
            out[s, j * nl:(j + 1) * nl] = o.reshape(-1)
    return out.reshape(-1), ends


@pytest.mark.parametrize("blk", [1, 8, 24, 1464, 2048])
def test_block_last_equals_the_scans_last(blk):
    """prefix.cu's block_last (and the twin's ``_block_last``) equals the
    last value of the row-offset scan, bit for bit, on real-valued row
    totals of a block of blk rows (1,464: HUS's block)."""
    r = np.random.default_rng(blk)
    for scale in (1.0, 3e4):
        tb = _t((r.random(blk) * scale).astype(np.float32))
        want = fusedmap._block_scan(tb)[1]
        for got in (_tree_last(tb), fusedmap._block_last(tb)):
            assert got.view(torch.int32) == want.view(torch.int32)


@pytest.mark.parametrize("blk", [8, 16, 24])
@pytest.mark.parametrize("n_seg", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_sharded_prefix_kernel_model(k, n_seg, blk):
    """The sharded prefix's two entries, slab by slab, and
    concat_prefix_twin_sharded equal concat_prefix_twin bit for bit on
    real-valued weights. 48 rows in slabs of 24, 16, 12 or 6: slab edges
    on block edges and inside blocks of 8, 16 and 24 rows, slabs with
    whole blocks and none, blocks that straddle one edge and several."""
    r = np.random.default_rng(13)
    N = 48 * fusedmap.LANE
    w = _t((r.random(N) * 3).astype(np.float32))
    codes = None if n_seg == 1 else _t(r.integers(0, n_seg, N)
                                       .astype(np.int32))
    want = fusedmap.concat_prefix_twin(w, codes, n_seg, max_block_rows=blk)
    got, ends = _sharded_prefix_model(w, codes, n_seg, blk, k)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(torch.int32).numpy())
    nl = N // k
    parts = [(w[j * nl:(j + 1) * nl],
              None if codes is None else codes[j * nl:(j + 1) * nl])
             for j in range(k)]
    gathered = torch.stack([
        fusedmap.row_totals_twin(x, c, n_seg, j * nl // fusedmap.LANE, N,
                                 blk)
        for j, (x, c) in enumerate(parts)])
    # a slab sends its head, tail and whole blocks, not all its rows
    # (where its edges fall inside blocks, it may send all of them)
    assert gathered.shape[2] == fusedmap.message_width(48 // k, blk, k)
    for j, (x, c) in enumerate(parts):
        out, tends = fusedmap.concat_prefix_twin_sharded(
            x, c, n_seg, j * nl // fusedmap.LANE, N, gathered, blk)
        np.testing.assert_array_equal(
            out.view(torch.int32).numpy(),
            want.reshape(n_seg, N)[:, j * nl:(j + 1) * nl]
            .reshape(-1).view(torch.int32).numpy())
        np.testing.assert_array_equal(tends.view(torch.int32).numpy(),
                                      ends.view(torch.int32).numpy())
    np.testing.assert_array_equal(
        ends.view(torch.int32).numpy(),
        want.reshape(n_seg, N)[:, -1].view(torch.int32).numpy())


VEC = 16                 # consecutive agents a histogram thread takes


def _model_grid(n, threads, ctas):
    """(thread, its vector steps) of a persistent grid of ``ctas`` CTAs
    of ``threads`` in each CTA, in CTA order, then the tail agents of
    each CTA."""
    nvec, stride = n // VEC, threads * ctas
    for b in range(ctas):
        steps = {t: range(b * threads + t, nvec, stride)
                 for t in range(threads)}
        tail = [i for i in range(nvec * VEC + b * threads,
                                 nvec * VEC + (b + 1) * threads) if i < n]
        yield steps, tail


def _finish_model(acc, ctas):
    """hist_finish.cuh after every CTA has folded: the last ticket
    writes float32 and zeroes acc and the counter."""
    out = None
    for _ in range(ctas):
        acc[-1] += 1
        if acc[-1] == ctas:
            out = torch.tensor(acc[:-1], dtype=torch.float32)
            acc[:] = [0] * len(acc)
    return out


def _runs_model(masks_of, code, nb, K, threads=64, ctas=3):
    """onehot_runs.cuh step by step, then each CTA's fold of its non-zero
    bins and the last CTA's finish: 16 agents a thread a step, run-length
    counts flushed to the CTA's bins when the code changes, the last runs
    of a warp summed when all 32 lanes end on one code, the scalar tail.
    ``masks_of(i)``: agent i's K mask bits, or None where it counts
    nowhere. Returns (out, the scratch after the launch, the number of
    warp sums)."""
    code = code.tolist()
    n = len(code)

    def masks(i):
        return masks_of(i) if 0 <= code[i] < nb else None

    def flush(h, g, c):
        for k in range(K):
            h[k * nb + g] += c[k]

    acc, warp_sums = [0] * (K * nb + 1), 0
    for steps, tail in _model_grid(n, threads, ctas):
        h = [0] * (K * nb)
        for w0 in range(0, threads, 32):
            lanes = [list(steps[t]) for t in range(w0, w0 + 32)]
            for s in range(len(lanes[0])):         # warp-uniform trips
                ends = []
                for lane in lanes:
                    cur, c = -1, [0] * K
                    if s < len(lane):
                        for i in range(lane[s] * VEC, lane[s] * VEC + VEC):
                            m = masks(i)
                            if m is None:
                                continue
                            if code[i] != cur:
                                if cur >= 0:
                                    flush(h, cur, c)
                                cur, c = code[i], [0] * K
                            c = [x + bool(b) for x, b in zip(c, m)]
                    ends.append((cur, c))
                if len({cur for cur, _ in ends}) == 1:
                    if ends[0][0] >= 0:
                        warp_sums += 1
                        flush(h, ends[0][0], [sum(c[k] for _, c in ends)
                                              for k in range(K)])
                else:
                    for cur, c in ends:
                        if cur >= 0:
                            flush(h, cur, c)
        for i in tail:
            m = masks(i)
            if m is not None:
                flush(h, code[i], [bool(b) for b in m])
        for j, x in enumerate(h):
            acc[j] += x
    return _finish_model(acc, ctas).reshape(K, nb), acc, warp_sums


def _fn_onehot_model(fields, code, nb):
    """fn_onehot.cu: the runs model over the 10 phase-7 masks of active
    agents."""
    act, inf, imm, dov, det, st, evi, dout, nw = [f.tolist() for f in fields]
    C = tstep.C

    def masks_of(i):
        if not act[i]:
            return None
        dead = st[i] == C.DEAD
        return [dov[i] >= 0, inf[i] or imm[i], det[i], st[i] == C.IN_ICU,
                evi[i], st[i] == C.HOSPITALIZED, dead, st[i] == C.RECOVERED,
                dead and dout[i], nw[i]]

    return _runs_model(masks_of, code, nb, 10)


def _onehot_model(parts, code, nb):
    """onehot.cu: the runs model over K bool masks read where they lie."""
    ps = [p.tolist() for p in parts]
    return _runs_model(lambda i: [p[i] for p in ps], code, nb, len(ps))


def _bihist_model(gate, code_a, w, code_b, na, nb, threads=64, ctas=3):
    """bihist.cu step by step: 16 agents a thread a step, a gate word
    that is all zero skipped, code_a, w and code_b read only for gated
    agents, the scalar tail, counts added straight into the scratch, the
    last CTA's finish."""
    ca, cb = code_a.tolist(), code_b.tolist()
    wi = [int(round(x)) for x in w.tolist()]
    g = None if gate is None else gate.tolist()
    n = len(ca)
    acc = [0] * (na * nb + 1)

    def add(i):
        a, b = ca[i], cb[i]
        if 0 <= a < na and 0 <= b < nb and wi[i]:
            acc[a * nb + b] += wi[i]

    for steps, tail in _model_grid(n, threads, ctas):
        for t in range(threads):
            for v in steps[t]:
                agents = range(v * VEC, v * VEC + VEC)
                if g is not None and not any(g[i] for i in agents):
                    continue
                for i in agents:
                    if g is None or g[i]:
                        add(i)
        for i in tail:
            if g is None or g[i]:
                add(i)
    return _finish_model(acc, ctas).reshape(na, nb), acc


def _phase7_inputs(case):
    """Phase-7 fields and group codes: agents sorted by group (as the day
    step lays them out), shuffled, with codes out of range, or sorted
    with a partial last step of 16 (N % 16 == 13)."""
    r = np.random.default_rng(13)
    n = 4013 if case == "tail" else N
    st = r.choice(7, n, p=[.4, .05, .05, .05, .05, .3, .1]).astype(np.int8)
    fields = [r.random(n) < 0.95, r.random(n) < 0.3, r.random(n) < 0.3,
              np.where(r.random(n) < 0.2, r.integers(0, 365, n), -1)
              .astype(np.int16), r.random(n) < 0.1, st, r.random(n) < 0.1,
              r.random(n) < 0.4, r.random(n) < 0.1]
    code = np.sort(r.integers(0, 11, n)).astype(np.int32)
    if case == "random":
        code = r.permutation(code)
    elif case == "out_of_range":
        code = np.sort(r.integers(-2, 14, n)).astype(np.int32)
    return fields, code


PHASE7 = [("sorted", "interpret"), ("sorted", "xla"), ("random", "interpret"),
          ("random", "xla"), ("out_of_range", "interpret"),
          ("out_of_range", "xla"), ("tail", "xla")]


@pytest.mark.parametrize("case,force", PHASE7,
                         ids=[f"{c}-{f}" for c, f in PHASE7])
def test_fn_onehot_kernel_model(case, force):
    """fn_onehot.cu's vector steps, run-length counts, warp sums, tail,
    fold and last-CTA finish equal the twin and the JAX package (the
    Pallas kernel in interpret mode needs N % 1024 == 0, so the partial
    tail is held to its XLA form), and leave the scratch zeroed."""
    fields, code = _phase7_inputs(case)
    tf = [_t(f) for f in fields]
    got, acc, _ = _fn_onehot_model(tf, _t(code), 11)
    twin = fusedmap.fn_onehot_sum_twin(tf, tstep._output_masks_reduced, 10,
                                       _t(code), 11)
    want = jfm.fused_fn_onehot_sum(
        [jnp.asarray(f) for f in fields], jstep._output_masks_reduced, 10,
        jnp.asarray(code), 11, max_block=1024, force=force)
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not any(acc)
    assert got.sum() > 0


def _onehot_inputs(K, case):
    """K bool masks and codes as the two callers give them: 13 masks by 11
    groups (the snapshot) or one mask by 101 ages (vaccination), agents
    sorted by code with one code holding 40% of them (so whole warps lie
    in one run, as at HUS size); shuffled; with codes out of range; or
    sorted with N % 16 == 13."""
    r = np.random.default_rng(15 + K)
    n = 4013 if case == "tail" else N
    nb = 11 if K == 13 else 101
    p = np.full(nb, 0.6 / (nb - 1))
    p[nb // 2] = 0.4
    code = np.sort(r.choice(nb, n, p=p)).astype(np.int32)
    if case == "random":
        code = r.permutation(code)
    elif case == "out_of_range":
        code = np.sort(np.where(r.random(n) < 0.1, r.integers(-2, 0, n),
                                code + r.integers(0, 3, n) * (code > nb - 3))
                       ).astype(np.int32)
    parts = [r.random(n) < q for q in np.linspace(0.05, 0.9, K)]
    return parts, code, nb


ONEHOT = [("sorted", "interpret"), ("random", "xla"),
          ("out_of_range", "interpret"), ("tail", "xla")]


@pytest.mark.parametrize("case,force", ONEHOT,
                         ids=[f"{c}-{f}" for c, f in ONEHOT])
@pytest.mark.parametrize("K", [1, 13])
def test_onehot_kernel_model(K, case, force):
    """onehot.cu's vector steps, run-length counts, warp sums (sorted
    codes take them), tail, fold and last-CTA finish equal the twin and
    the JAX package (the Pallas kernel in interpret mode needs N % 1024
    == 0, so the partial tail is held to its XLA form), and leave the
    scratch zeroed."""
    parts, code, nb = _onehot_inputs(K, case)
    tp = [_t(p) for p in parts]
    got, acc, warp_sums = _onehot_model(tp, _t(code), nb)
    twin = fusedmap.onehot_sum_twin(tp, _t(code), nb)
    want = jfm.fused_onehot_sum([jnp.asarray(p) for p in parts],
                                jnp.asarray(code), nb, max_block=1024,
                                force=force)
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not any(acc)
    assert (warp_sums > 0) == (case != "random")
    if case == "out_of_range":
        assert ((code < 0) | (code >= nb)).any()


def _bihist_inputs(case):
    """Exposer codes, gate, int32 contact counts <= 128 and source ages
    as the day step gives them (ages sorted), or shuffled, or with codes
    out of range, or an all-false gate, or N % 16 == 13."""
    r = np.random.default_rng(14)
    n = 4013 if case == "tail" else N
    ages = np.sort(r.integers(0, 101, n)).astype(np.int32)
    if case == "random":
        ages = r.permutation(ages)
    vts = r.integers(0, 84, n).astype(np.int32)
    if case == "out_of_range":
        vts = r.integers(-1, 86, n).astype(np.int32)
        ages = r.integers(-1, 103, n).astype(np.int32)
    gate = r.random(n) < (0.0 if case == "gate_false" else 0.1)
    k_s = np.where(gate, r.integers(0, 129, n), 0).astype(np.int32)
    return gate, vts, k_s, ages


BIHIST = [("sorted", "interpret"), ("sorted", "xla"), ("random", "interpret"),
          ("random", "xla"), ("out_of_range", "interpret"),
          ("out_of_range", "xla"), ("gate_false", "xla"), ("tail", "xla")]


@functools.lru_cache(maxsize=None)
def _jax_bihist(case, force):
    """The JAX package's call before the gate: where(gate, vts, -1) and
    float32 weights."""
    gate, vts, k_s, ages = _bihist_inputs(case)
    return np.asarray(jfm.fused_bihistogram(
        jnp.where(jnp.asarray(gate), jnp.asarray(vts), -1), 84,
        jnp.asarray(k_s).astype(jnp.float32), jnp.asarray(ages), 101,
        max_block=1024, force=force))


@pytest.mark.parametrize("w_dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("case,force", BIHIST,
                         ids=[f"{c}-{f}" for c, f in BIHIST])
def test_bihist_kernel_model(case, force, w_dtype):
    """bihist.cu's gated vector steps, tail, bins and last-CTA finish,
    with int32 or float32 weights (the kernel's four instances: gated or
    not, by weight type), equal the twin with the gate and the JAX
    package on where(gate, vts, -1), and leave the scratch zeroed;
    without a gate, the same on where(gate, vts, -1)."""
    gate, vts, k_s, ages = _bihist_inputs(case)
    want = _jax_bihist(case, force)
    tg, tv, ta = _t(gate), _t(vts), _t(ages)
    tk = _t(k_s).to(w_dtype)
    got, acc = _bihist_model(tg, tv, tk, ta, 84, 101)
    twin = fusedmap.bihistogram_twin(tv, 84, tk, ta, 101, gate=tg)
    ungated = torch.where(tg, tv, -1)
    got_ng, acc_ng = _bihist_model(None, ungated, tk, ta, 84, 101)
    for x in (got, twin, got_ng):
        np.testing.assert_array_equal(x.numpy(), want)
    assert not any(acc) and not any(acc_ng)
    assert (want.sum() > 0) == (case != "gate_false")


@pytest.mark.parametrize("force", FORCES)
def test_fused_bihistogram_gate(force):
    """The day step's call, fused_bihistogram(vts, VTS, k_s, ages, A,
    gate=exposer) with int32 k_s, equals the JAX package's
    fused_bihistogram(where(exposer, vts, -1), VTS, k_s as float32,
    ages, A)."""
    gate, vts, k_s, ages = _bihist_inputs("sorted")
    got = fusedmap.fused_bihistogram(_t(vts), 84, _t(k_s), _t(ages), 101,
                                     gate=_t(gate))
    np.testing.assert_array_equal(got.numpy(), _jax_bihist("sorted", force))


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
