"""Kernel-against-twin tests on the card (marker ``gpu``).

Run on a machine with a CUDA device:

    python -m pytest -m gpu tests/test_torch_cuda.py

Without one every test skips. Whether there is a card is decided inside
each test, never at import, so every pytest worker collects the same
tests. The tolerances are those of reina_tpu_torch/kernels/checks.py:
exact for the prefix sums, histograms and ledger, the draws and the
samplers; exact integer and bool outputs and floats within 2 ulp for the
fused bodies.
"""
import numpy as np
import pytest
import torch

from reina_tpu_torch import kernels

pytestmark = pytest.mark.gpu

KERNELS = ["fused_map.prologue", "fused_map.recv_front", "fused_map.post",
           "fused_map.finalize", "ledger_scan", "fused_concat_prefix",
           "fused_onehot_sum", "fused_fn_onehot_sum", "fused_bihistogram"]
# the launch counts of the ledger's and the prefix's sharded forms
SHARDED = ("ledger_sharded.fold", "ledger_sharded.emit",
           "concat_prefix_sharded.totals", "concat_prefix_sharded.emit",
           "concat_prefix_sharded.pick")
# the draw kernel and the samplers (threefry.cu, samplers.cu)
DRAWS = ["prng.draw", "random.gamma_fixed", "random.binomial_fixed"]
IVS = [["test-with-contact-tracing", "2020-02-20", 60],
       ["import-infections", "2020-02-20", 50],
       ["vaccinate", "2020-02-22", 700, 60, None]]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("n", [8192, 1686528], ids=["small", "hus"])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_twin(name, n):
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    c = {c.name: c for c in checks.checks(n, 0, "cuda")}[name]
    before = kernels.launches()[name]
    r = checks.run_check(c, timing=False)
    assert kernels.launches()[name] > before
    assert r.ok, r


@pytest.mark.parametrize("name", DRAWS)
def test_draw_kernel_matches_twin(name):
    """Each draw kernel against its twin on the card, bit for bit: 1-D
    draws of odd sizes from start 0 and from non-zero starts, 2-D and 3-D
    shapes, gumbel, gamma and the gamma pair at every slot tier and at
    their edges (the kappa fallback, groups of 1 to 8 threads, odd lane
    counts), binomial on made-up day-step lanes and at its edges (n = 0,
    means of exactly 10, the flip, p_eff = 0, NaN means)
    (checks.draw_checks)."""
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    c = {c.name: c for c in checks.draw_checks(0, "cuda")}[name]
    before = kernels.launches()[name]
    r = checks.run_check(c, timing=False)
    assert kernels.launches()[name] > before
    assert r.ok, r


def test_gamma_pair_is_one_launch():
    """The day step's two gamma samples in one launch, each equal to its
    twin bit for bit, at every slot tier; one launch each."""
    _need_cuda()
    from reina_tpu_torch.core import constants as C
    from reina_tpu_torch.core import step
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.ops import random as trandom
    k1, k2 = prng.split(prng.PRNGKey(5), 2)
    kappas = (1.0 / C.INCUBATION_CV ** 2, 1.0 / C.ONSET_TO_REMOVED_CV ** 2)
    for lo, seg in step.tier_bounds(512, 65536):
        before = kernels.launches()["random.gamma_fixed"]
        got = trandom.gamma_fixed_pair(k1, kappas[0], k2, kappas[1],
                                       (lo + seg,), "cuda")
        assert kernels.launches()["random.gamma_fixed"] == before + 1
        for g, key, kappa in zip(got, (k1, k2), kappas):
            want = trandom.gamma_fixed_twin(key, kappa, (lo + seg,), "cuda")
            assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def test_uniform_bits_on_cuda_match_cpu():
    _need_cuda()
    from reina_tpu_torch.ops import prng
    k = prng.PRNGKey(9)
    for shape in [(1686528,), (512, 10, 2), (300, 101)]:
        a = prng.uniform(k, shape, "cuda").cpu()
        b = prng.uniform(k, shape, "cpu")
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_synthetic_run_on_cuda():
    _need_cuda()
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=20000, days=14, seed=3,
                              interventions=IVS)
    kernels.reset_launches()
    out, state, carry, _ = run_days(run, chunk_days=8)
    counts = kernels.launches()
    # every kernel of the one-card path, and none of the sharded forms
    assert all(v > 0 for k, v in counts.items() if k not in SHARDED), counts
    assert all(counts[k] == 0 for k in SHARDED), counts
    # one a stepped day, beside the day graphs' warm-ups
    warm = kernels.warmups()
    assert counts["fused_map.prologue"] == 13 + warm["fused_map.prologue"]
    susceptible = out.by_group[:, 0].sum(axis=1)
    all_infected = out.by_group[:, 3].sum(axis=1)
    np.testing.assert_array_equal(susceptible + all_infected, 20000)
    assert all_infected[-1] > all_infected[0]
    assert state.state.is_cuda


def test_ensemble_and_grid_on_cuda_equal_run_days():
    """An ensemble member on the card equals run_days with its seed, and
    a grid point equals run_days of its own build with the base cfg and
    schedules, bit for bit."""
    _need_cuda()
    from dataclasses import replace
    from reina_tpu_torch.calibration import sweep_grid
    from reina_tpu_torch.core.engine import build_run, run_days
    from reina_tpu_torch.ensemble import run_ensemble
    from reina_tpu_torch.testing import (build_synthetic_run,
                                         synthetic_age_counts,
                                         synthetic_variables)
    run = build_synthetic_run("cuda", n_agents=20000, days=10, seed=3,
                              interventions=IVS)
    seeds = [4, 5]
    outs = run_ensemble(run, seeds)
    for i, s in enumerate(seeds):
        out, _, _, _ = run_days(run, seed=s)
        for name, a, b in zip(out._fields, outs, out):
            np.testing.assert_array_equal(a[i], b[1:], err_msg=name)
    assert not np.array_equal(outs.by_group[0], outs.by_group[1])

    v = synthetic_variables(days=10, seed=3, interventions=IVS)
    ages = synthetic_age_counts(20000)
    points, outs, base = sweep_grid(
        v, {"infectiousness_multiplier": [0.4, 0.9]},
        age_counts_override=ages)
    assert base.device.type == "cuda"
    for g, pt in enumerate(points):
        own = replace(build_run(dict(v, **pt), "cuda",
                                age_counts_override=ages),
                      cfg=base.cfg, schedules=base.schedules)
        out, _, _, _ = run_days(own, seed=base.random_seed)
        for name, a, b in zip(out._fields, outs, out):
            np.testing.assert_array_equal(a[g], b[1:], err_msg=name)


def test_resume_on_cuda_equals_uninterrupted(tmp_path):
    """9 days with a checkpoint at day 4, resumed: outputs, state and
    carry equal the uninterrupted run bit for bit."""
    _need_cuda()
    from reina_tpu_torch import convert
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=20000, days=9, seed=4,
                              interventions=IVS)
    ref, rs, rc, _ = run_days(run, chunk_days=3)
    run_days(run, n_days=5, chunk_days=3, checkpoint_dir=str(tmp_path),
             checkpoint_every=4)
    out, st, cr, _ = run_days(run, chunk_days=3,
                              checkpoint_dir=str(tmp_path))
    for name, a, b in zip(ref._fields, ref, out):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for want, got in ((rs, st), (rc, cr)):
        w, g = convert.to_numpy(want), convert.to_numpy(got)
        for k in w:
            if k == "bkt_dst":       # the spare drop slot is never read
                w[k], g[k] = w[k][:-1], g[k][:-1]
            np.testing.assert_array_equal(w[k], g[k], err_msg=k)


def test_wrappers_raise_and_never_fall_back():
    """On CUDA tensors the wrappers launch their kernel or raise: a
    mask function without a kernel, a wrong dtype (int64 or float64
    weights among them), an offset outside the ledger, a misaligned or
    non-contiguous stream or gate, a count of masks outside 1 to
    ONEHOT_MAX_K, a multi-dimensional draw from a start counter or one
    past the int32 counter, binomial lanes of two shapes or devices, or
    a sampler's rounds outside 1 to MAX_ROUNDS are refused, never run by
    the twin, and no launch is counted."""
    _need_cuda()
    from reina_tpu_torch.core import step
    from reina_tpu_torch.kernels import checks
    from reina_tpu_torch.ops import fusedmap
    s = checks._streams(8192, 0, "cuda")
    fields, grp = s["fields"], s["grp"]

    def other_masks(*fs):
        return step._output_masks_reduced(*fs)

    before = kernels.launches()
    with pytest.raises(TypeError, match="no kernel"):
        fusedmap.fused_fn_onehot_sum(fields, other_masks, 10, grp, 11)
    with pytest.raises(ValueError):
        fusedmap.fused_fn_onehot_sum(fields, step._output_masks_reduced, 9,
                                     grp, 11)
    wrong = list(fields)
    wrong[3] = wrong[3].to(torch.int32)             # dov must be int16
    with pytest.raises(TypeError):
        fusedmap.fused_fn_onehot_sum(wrong, step._output_masks_reduced, 10,
                                     grp, 11)
    with pytest.raises(TypeError):
        fusedmap.fused_fn_onehot_sum(fields, step._output_masks_reduced, 10,
                                     grp.long(), 11)
    with pytest.raises(TypeError, match="aligned"):
        fusedmap.fused_fn_onehot_sum([f[1:] for f in fields],
                                     step._output_masks_reduced, 10,
                                     grp[1:], 11)
    gate, vts, ks, ages = s["gate"], s["vts"], s["k_s"], s["ages"]
    for w in (ks.long(), ks.double()):
        with pytest.raises(TypeError):
            fusedmap.fused_bihistogram(vts, 84, w, ages, 101, gate=gate)
    with pytest.raises(TypeError):
        fusedmap.fused_bihistogram(vts.long(), 84, ks, ages, 101, gate=gate)
    with pytest.raises(TypeError):
        fusedmap.fused_bihistogram(vts, 84, ks, ages, 101,
                                   gate=gate.to(torch.uint8))
    with pytest.raises(TypeError, match="aligned"):
        fusedmap.fused_bihistogram(vts[1:], 84, ks[1:], ages[1:], 101,
                                   gate=gate[1:])
    with pytest.raises(TypeError, match="aligned"):
        fusedmap.fused_bihistogram(vts[1:], 84, ks[1:], ages[1:], 101)
    from reina_tpu_torch.ops import clamped
    rel, req = s["rel"], s["req"]
    init = torch.tensor([3, 1], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="offset"):
        clamped.clamped_counter_grants(rel, req, init, 8192)
    with pytest.raises(ValueError, match="aligned"):
        clamped.clamped_counter_grants([r[1:] for r in rel],
                                       [q[1:] for q in req], init, 0)
    with pytest.raises(TypeError):
        fusedmap.fused_concat_prefix(s["w"][1:1025], None, 1)
    masks = s["b"][:13]
    for k in (0, fusedmap.ONEHOT_MAX_K + 1):
        with pytest.raises(ValueError):
            fusedmap.fused_onehot_sum(s["b"][:1] * k, grp, 11)
    with pytest.raises(TypeError, match="aligned"):
        fusedmap.fused_onehot_sum([m[1:] for m in masks], grp[1:], 11)
    with pytest.raises(TypeError):
        fusedmap.fused_onehot_sum([torch.stack(masks[:2], 1)[:, 0]], grp, 11)
    with pytest.raises(TypeError):
        fusedmap.fused_onehot_sum(masks, grp.long(), 11)
    from reina_tpu_torch.kernels import fused_bodies
    po = checks.post_args(s)
    with pytest.raises(TypeError, match="aligned"):
        fused_bodies.post(*[a[1:] for a in po[:20]], *po[20:])
    strided = list(po)
    strided[3] = torch.stack([po[3], po[3]], 1)[:, 0]     # o2r
    with pytest.raises(ValueError):
        fused_bodies.post(*strided)
    with pytest.raises(TypeError):
        fused_bodies.post(*po[:20], po[20].double(), *po[21:])
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.ops import random as trandom
    key = prng.PRNGKey(1)
    with pytest.raises(ValueError, match="1-D"):
        prng.uniform(key, (4, 4), "cuda", start=3)
    with pytest.raises(ValueError, match="int32 counter"):
        prng.random_bits(key, (16,), "cuda", start=2 ** 31 - 8)
    nb = torch.ones(8, device="cuda")
    pb = torch.full((8,), 0.3, device="cuda")
    with pytest.raises(ValueError, match="one shape"):
        trandom.binomial_fixed(key, nb, pb[:4])
    with pytest.raises(ValueError, match="one CUDA device"):
        trandom.binomial_fixed(key, nb, pb.cpu())
    with pytest.raises(ValueError, match="rounds"):
        trandom.binomial_fixed(key, nb, pb, rounds=trandom.MAX_ROUNDS + 1)
    with pytest.raises(ValueError, match="rounds"):
        trandom.gamma_fixed(key, 2.0, (8,), "cuda", rounds=0)
    with pytest.raises(ValueError, match="kappa"):
        trandom.gamma_fixed(key, 0.5, (8,), "cuda")
    assert kernels.launches() == before


def _histogram_calls(n, gate_p=None):
    """(kernel, twin) of the three histograms on checks' streams cut to n
    agents (the 2-D histogram gated and not, the one-hot sums at the
    snapshot's and the vaccination's shapes), the gate drawn with
    probability gate_p where given."""
    from reina_tpu_torch.core import step
    from reina_tpu_torch.kernels import checks
    from reina_tpu_torch.ops import fusedmap
    s = checks._streams(8192, 1, "cuda")
    fields = [f[:n].clone() for f in s["fields"]]
    grp, vts, ks, ages = (s[k][:n].clone()
                          for k in ("grp", "vts", "k_s", "ages"))
    gate = s["gate"][:n].clone()
    if gate_p is not None:
        gate = torch.rand(n, device="cuda") < gate_p
    masks = step._output_masks_reduced
    code_a, wf = torch.where(gate, vts, -1), ks.float()
    bools = [b[:n].clone() for b in s["b"][:13]]
    return [
        (lambda: fusedmap.fused_fn_onehot_sum(fields, masks, 10, grp, 11),
         lambda: fusedmap.fn_onehot_sum_twin(fields, masks, 10, grp, 11)),
        (lambda: fusedmap.fused_bihistogram(vts, 84, ks, ages, 101,
                                            gate=gate),
         lambda: fusedmap.bihistogram_twin(vts, 84, ks, ages, 101, gate)),
        (lambda: fusedmap.fused_bihistogram(code_a, 84, wf, ages, 101),
         lambda: fusedmap.bihistogram_twin(vts, 84, ks, ages, 101, gate)),
        (lambda: fusedmap.fused_onehot_sum(bools, grp, 11),
         lambda: fusedmap.onehot_sum_twin(bools, grp, 11)),
        (lambda: fusedmap.fused_onehot_sum(bools[:1], ages, 101),
         lambda: fusedmap.onehot_sum_twin(bools[:1], ages, 101)),
    ]


def _device_ops(fn):
    """fn's result and the device operations (kernels, memsets, copies)
    it ran, in the order they started, by torch.profiler. A profiled
    fill first starts CUPTI, whose first session in a process can miss
    events."""
    for warm_up in (True, False):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = torch.zeros(1, device="cuda") if warm_up else fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, [e.name for e in sorted(events,
                                        key=lambda e: e.time_range.start)]


def test_histograms_reset_their_scratch():
    """Three calls in a row of each histogram give equal outputs, equal
    to the twin: each launch leaves its scratch zeroed. Each call is one
    device kernel (no stack of the masks, no memset, no finish kernel),
    and counts one launch."""
    _need_cuda()
    from reina_tpu_torch.ops import fusedmap
    calls = _histogram_calls(8192)
    for kernel, _ in calls:
        kernel()                        # the first call allocates the scratch
    before = kernels.launches()
    outs, ops = _device_ops(
        lambda: [[kernel() for _ in range(3)] for kernel, _ in calls])
    after = kernels.launches()
    assert sum(after.values()) - sum(before.values()) == 3 * len(calls)
    assert len(ops) == 3 * len(calls), ops
    for c, ((_, twin), three) in enumerate(zip(calls, outs)):
        assert len(set(ops[3 * c:3 * c + 3])) == 1, ops
        for o in three:
            assert torch.equal(o, twin())
    assert not any(t.any() for t in fusedmap._SCRATCH.values())


@pytest.mark.parametrize("n", [8192 - 3, 4096 + 1001, 13],
                         ids=["13-tail", "9-tail", "tail-only"])
def test_histograms_partial_tail(n):
    """Lengths with a partial last step of 16 agents: the scalar tail."""
    _need_cuda()
    for kernel, twin in _histogram_calls(n):
        assert torch.equal(kernel(), twin())


@pytest.mark.parametrize("p", [0.0, 1.0], ids=["all-false", "all-true"])
def test_bihistogram_gate_all_false_and_all_true(p):
    _need_cuda()
    for kernel, twin in _histogram_calls(8192, gate_p=p)[1:3]:
        got = kernel()
        assert torch.equal(got, twin())
        assert (got.sum() == 0) == (p == 0.0)


@pytest.mark.parametrize("n", [1, 16384, 16384 + 7])
def test_post_kernel_matches_twin(n):
    """The post body at one agent (the tail only), 16k agents and 16k + 7
    (a tail of 7), on checks' streams and on the rounding edge of the day
    counts: equal to the twin, one launch each."""
    _need_cuda()
    from reina_tpu_torch.core import step
    from reina_tpu_torch.kernels import checks, fused_bodies
    s = checks._streams(n, 2, "cuda")
    for args in (checks.post_args(s), checks.post_edge_args(n, 3, "cuda")):
        before = kernels.launches()["fused_map.post"]
        got = fused_bodies.post(*args)
        assert kernels.launches()["fused_map.post"] == before + 1
        for g, w in zip(got, step.post(*args)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("K", [1, 13, 16])
def test_onehot_sum_masks(K):
    """K masks (up to ONEHOT_MAX_K) by sorted, random and out-of-range
    codes, with a tail of 5."""
    _need_cuda()
    from reina_tpu_torch.ops import fusedmap
    assert fusedmap.ONEHOT_MAX_K == 16
    r = np.random.default_rng(K)
    n = 8192 + 5
    masks = [torch.from_numpy(r.random(n) < q).cuda()
             for q in np.linspace(0.05, 0.9, K)]
    for code in (np.sort(r.integers(0, 11, n)), r.integers(0, 11, n),
                 np.sort(r.integers(-3, 14, n))):
        c = torch.from_numpy(code.astype(np.int32)).cuda()
        assert torch.equal(fusedmap.fused_onehot_sum(masks, c, 11),
                           fusedmap.onehot_sum_twin(masks, c, 11))


@pytest.mark.parametrize("L", [1, 2])
def test_ledger_partial_last_tile(L):
    """3 tiles of 4096 agents and 1001 more (a length % 4 != 0): the
    kernel's scalar tail, at offsets on and beside the tile edges."""
    _need_cuda()
    from reina_tpu_torch.ops import clamped
    r = np.random.default_rng(3)
    n = 3 * 4096 + 1001
    rel = [torch.from_numpy((r.random(n) < 0.05).astype(np.int32)).cuda()
           for _ in range(L)]
    req = [torch.from_numpy(r.random(n) < 0.08).cuda() for _ in range(L)]
    init = torch.tensor([20, 4][:L], dtype=torch.int32, device="cuda")
    for offset in (0, 1, 4095, 4096, 3 * 4096, n - 1):
        got, fin = clamped.clamped_counter_grants(rel, req, init, offset)
        want, tfin = clamped.grants_twin(rel, req, init, offset)
        for g, w in zip(got, want):
            assert torch.equal(g, w), offset
        assert torch.equal(fin, tfin), offset


@pytest.mark.parametrize("n_seg", [1, 2])
def test_prefix_many_blocks(n_seg):
    """max_block_rows=16: 32 logical blocks a segment, real-valued
    weights, bit for bit."""
    _need_cuda()
    from reina_tpu_torch.ops import fusedmap
    r = np.random.default_rng(4)
    n = 512 * fusedmap.LANE
    w = torch.from_numpy((r.random(n) * 3).astype(np.float32)).cuda()
    codes = None if n_seg == 1 else torch.from_numpy(
        r.integers(0, n_seg, n).astype(np.int32)).cuda()
    got = fusedmap.fused_concat_prefix(w, codes, n_seg, max_block_rows=16)
    want = fusedmap.concat_prefix_twin(w, codes, n_seg, max_block_rows=16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_concurrent_runs_equal_runs_alone():
    """Two threads run simulate_individuals on the card at once, as the
    server's workers do (one HUS configuration, 20 days, seeds 11 and
    12): the build cache builds once and reseeds, the histogram kernels
    share their cached scratch on the default stream, and each result
    equals the same seed run alone."""
    _need_cuda()
    import threading

    from reina_tpu_torch.simulation import simulate_individuals

    def store(seed):
        return {"area_name": "HUS", "simulation_days": 20,
                "random_seed": seed}

    results, errors = {}, []

    def work(seed):
        try:
            results[seed] = simulate_individuals(
                variable_store=store(seed), device="cuda", skip_cache=True,
                step_callback=lambda cols: True, callback_day_interval=7)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(s,)) for s in (11, 12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
    for seed in (11, 12):
        cols, cube = simulate_individuals(variable_store=store(seed),
                                          device="cuda", skip_cache=True)
        got, got_cube = results[seed]
        for k in cols:
            if k != "us_per_infected":
                np.testing.assert_array_equal(got[k], cols[k],
                                              err_msg=f"seed {seed}: {k}")
        np.testing.assert_array_equal(got_cube.values, cube.values)
    assert not np.array_equal(results[11][0]["all_infected"],
                              results[12][0]["all_infected"])


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_forms_match_twins(k):
    """The sharded ledger and prefix over k slabs (each in turn, the
    exchange by stacking) equal their sharded twins and the unsharded
    kernel and twin bit for bit, at offsets 0, N - 1 and inside slab 0's
    last tile, and on prefix blocks that straddle the slabs."""
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    before = kernels.launches()
    for c in checks.sharded_checks(24576, 0, "cuda", k):
        r = checks.run_check(c, timing=False)
        assert r.ok, (c.name, r.mismatches, r.max_abs_err)
    after = kernels.launches()
    for name in SHARDED:
        assert after[name] > before[name], name


def test_sharded_entries_raise():
    """The sharded entries launch or raise: a slab that is not 16-byte
    aligned or not whole rows, a wrong dtype, folds or gathered messages
    of the wrong shape, a scratch from another slab, tensors on the CPU.
    No launch is counted."""
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    from reina_tpu_torch.ops import clamped, fusedmap
    n = 8192
    s = checks._streams(n, 0, "cuda")
    rel, req = s["rel"], s["req"]
    init = torch.tensor([3, 1], dtype=torch.int32, device="cuda")
    half = n // 2
    slab = ([r[:half] for r in rel], [q[:half] for q in req])
    before = kernels.launches()
    with pytest.raises(ValueError, match="aligned"):
        clamped.ledger_fold_slab([r[1:half + 1] for r in rel],
                                 [q[1:half + 1] for q in req], 0, 1, n)
    with pytest.raises(TypeError):
        clamped.ledger_fold_slab([r.long() for r in slab[0]], slab[1], 0, 0,
                                 n)
    with pytest.raises(ValueError):
        clamped.ledger_fold_slab([r.cpu() for r in slab[0]],
                                 [q.cpu() for q in slab[1]], 0, 0, n)
    with pytest.raises(ValueError, match="outside"):
        clamped.ledger_fold_slab(*slab, n, 0, n)
    after_check = kernels.launches()
    assert after_check == before
    folds, scratch = clamped.ledger_fold_slab(*slab, 5, 0, n)
    both = torch.stack([folds, folds])
    for bad in (both[:, :1].contiguous(), both.to(torch.int32),
                both.reshape(2, 2, 6)):
        with pytest.raises(TypeError):
            clamped.ledger_emit_slab(*slab, init, 5, 0, bad, 0, scratch)
    with pytest.raises(ValueError):
        clamped.ledger_emit_slab(*slab, init, 5, 0, both, 2, scratch)
    with pytest.raises(TypeError, match="scratch"):
        clamped.ledger_emit_slab(*slab, init, 5, 0, both, 0, scratch[:-1])
    w, codes = s["w"], s["var"].to(torch.int32)
    with pytest.raises(TypeError, match="aligned"):
        fusedmap.prefix_row_totals(w[1:half + 1], None, 1, 0, n)
    with pytest.raises(ValueError, match="whole rows"):
        fusedmap.prefix_row_totals(w[:100], None, 1, 0, n)
    with pytest.raises(TypeError):
        fusedmap.prefix_row_totals(w[:half].double(), None, 1, 0, n)
    with pytest.raises(TypeError):
        fusedmap.prefix_row_totals(w[:half], codes[:half].long(), 2, 0, n)
    tot, sc = fusedmap.prefix_row_totals(w[:half], codes[:half], 2, 0, n)
    gathered = torch.stack([tot, tot])
    for bad in (gathered[:1].contiguous(), gathered.double(),
                gathered[:, :1].contiguous()):
        with pytest.raises(TypeError):
            fusedmap.prefix_emit_slab(w[:half], codes[:half], 2, 0, n, bad,
                                      sc)
    with pytest.raises(TypeError, match="scratch"):
        fusedmap.prefix_emit_slab(w[:half], codes[:half], 2, 0, n, gathered,
                                  sc[:-1])
    with pytest.raises(ValueError):
        fusedmap.prefix_emit_slab(w[:half], codes[:half], 2, 0, n + 512,
                                  gathered, sc)
    with pytest.raises(ValueError):
        fusedmap.prefix_emit_slab(w[:half], codes[:half], 2, 40, n, gathered,
                                  sc)
    after = kernels.launches()
    assert after["ledger_sharded.emit"] == before["ledger_sharded.emit"]
    assert (after["concat_prefix_sharded.emit"]
            == before["concat_prefix_sharded.emit"])


# the calendar of tests/test_torch_step.py: testing, imports, weekly
# imports, mobility limits, masks, contact tracing, vaccination and
# capacity builds
STEP_IVS = [
    ["test-all-with-symptoms", "2020-02-20"],
    ["import-infections", "2020-02-20", 50],
    ["import-infections-weekly", "2020-02-25", 35],
    ["limit-mobility", "2020-03-01", 30],
    ["wear-masks", "2020-03-05", 50],
    ["test-with-contact-tracing", "2020-03-05", 60],
    ["vaccinate", "2020-03-01", 700, 60, None],
    ["build-new-icu-units", "2020-03-03", 5],
    ["build-new-hospital-beds", "2020-03-03", 20],
]


def test_gates_stop_a_split_span():
    """The gates of a graphed shard (csrc/daygraph.cu) on one card: a span
    captured with two guard points (where a captured collective would
    end), split into its three pieces, each assembled behind a gate on a
    stop word, runs whole while the word is 0 and runs no piece once the
    host has set it."""
    _need_cuda()
    import ctypes
    from reina_tpu_torch.core import daygraph
    from reina_tpu_torch.kernels import build
    from reina_tpu_torch.parallel import mesh as M
    x = torch.zeros(3, device="cuda")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with kernels.capturing(guards=True):
        with torch.cuda.graph(g, stream=torch.cuda.Stream()):
            for i in range(3):
                x[i].add_(1)
                if i < 2:
                    kernels.guard_point(
                        torch.cuda.current_stream().cuda_stream)
        guards = kernels.guards()
    pieces = daygraph.split(g.raw_cuda_graph(), guards, "test span")
    assert len(guards) == 2 and len(pieces) == 3
    word = M.StopWord(True)
    lib = build.lib()
    top, ex = ctypes.c_void_p(), ctypes.c_void_p()
    daygraph._check(lib.reina_dg_create(ctypes.byref(top)), "create")
    dep = None
    for p in pieces:
        node, body, child = ctypes.c_void_p(), ctypes.c_void_p(), \
            ctypes.c_void_p()
        daygraph._check(lib.reina_dg_gate(top, dep, word.dev,
                                          ctypes.byref(node),
                                          ctypes.byref(body)), "gate")
        daygraph._check(lib.reina_dg_child(body, None, p,
                                           ctypes.byref(child)), "piece")
        dep = node
    daygraph._check(lib.reina_dg_instantiate(top, ctypes.byref(ex)),
                    "instantiate")
    stream = torch.cuda.current_stream().cuda_stream
    try:
        for stop, want in ((False, [1, 1, 1]), (False, [2, 2, 2]),
                           (True, [2, 2, 2])):
            if stop:
                word.set()
            daygraph._check(lib.reina_dg_launch(ex, stream), "launch")
            torch.cuda.synchronize()
            assert x.tolist() == want, (stop, x.tolist())
    finally:
        lib.reina_dg_destroy(top, ex)
        daygraph.destroy_graphs(pieces)
        word.free()
        g.reset()


def test_graphed_run_on_a_card_not_current():
    """A graphed run of a build on cuda:1 while cuda:0 is current equals,
    bit for bit (outputs, final state and carry, picks), the same run
    with cuda:1 current, and leaves cuda:0 current: every entry that
    launches on a run's card makes that card current for its duration
    (the ctypes kernels launch on the current device)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import graphs as G
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda:1", n_agents=20000, days=25, seed=3,
                              interventions=IVS)
    got = {}
    for current in (1, 0):
        G.drop_idle()
        with torch.cuda.device(current):
            picks = []
            out, state, carry, _ = run_days(run, chunk_days=8, picks=picks)
            assert torch.cuda.current_device() == current
        got[current] = (out, convert.to_numpy(state), convert.to_numpy(carry),
                        np.asarray(picks))
    assert got[1][3].shape[0] == 24 and (got[1][3] >= 0).any()
    for f, a, b in zip(got[1][0]._fields, got[1][0], got[0][0]):
        np.testing.assert_array_equal(a, b, err_msg=f"out.{f}")
    for i, what in ((1, "state"), (2, "carry")):
        for f, a in got[1][i].items():
            np.testing.assert_array_equal(np.asarray(a),
                                          np.asarray(got[0][i][f]),
                                          err_msg=f"{what}.{f}")
    np.testing.assert_array_equal(got[1][3], got[0][3])


def test_graphed_run_equals_eager():
    """25 days of the step calendar (tracing, vaccination and import
    days among them) as day graphs and with the plain day step: every
    output row, the final state and the final carry equal bit for bit,
    the device's picks equal the host's, every kernel launched as often
    (the spans' and branches' tallies; the prefix launches with picks
    among the eager run's prefix launches, one a fold's first pick, and
    one reduce-and-pick for each of T2's and T4's picks) beside the
    warm-ups' launches, one day-graph launch and no host read a day, the
    tracing spans
    captured, and the second run of the build captures nothing."""
    _need_cuda()
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import daygraph, graphs, step
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=20000, days=25, seed=3,
                              interventions=STEP_IVS)
    kernels.reset_launches()
    host_picks = []
    want = run_days(run, chunk_days=8, graphs=False, picks=host_picks)
    eager_launches = kernels.launches()
    fused = daygraph.fold_launches(host_picks)
    assert fused["fused_concat_prefix.pick"] and fused["daygraph.max_pick"]
    graphs.drop_idle()
    for captures in (True, False):
        kernels.reset_launches()
        step.reset_stats()
        dev_picks = []
        got = run_days(run, chunk_days=8, picks=dev_picks)
        st = dict(step.STATS)
        np.testing.assert_array_equal(np.array(dev_picks),
                                      np.array(host_picks))
        launches = kernels.launches()
        # the day graphs' warm-ups launch eagerly and count apart too
        warm = kernels.warmups()
        assert bool(warm) == captures
        assert launches.pop("daygraph.max_pick") == (
            fused["daygraph.max_pick"] + warm.get("daygraph.max_pick", 0))
        n = launches.pop("fused_concat_prefix.pick")
        assert n == fused["fused_concat_prefix.pick"]
        launches["fused_concat_prefix"] += n
        assert launches == {k: v + warm.get(k, 0)
                            for k, v in eager_launches.items()
                            if k not in fused}
        assert (st.get("captures", 0) > 0) == captures, st
        assert st["launches"] == st["days"] == 24 and "reads" not in st
        for name, a, b in zip(want[0]._fields, want[0], got[0]):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for w, g in ((want[1], got[1]), (want[2], got[2])):
            w, g = convert.to_numpy(w), convert.to_numpy(g)
            for k in w:
                np.testing.assert_array_equal(w[k], g[k], err_msg=k)
    gs = graphs._IDLE[-1]
    assert {"A", "T1", "T2", "T3", "T4", "B", "AB", "C"} <= {
        name for name, _ in gs.bodies}


def test_device_key_draws_match_twins():
    """The draw and sampler kernels reading their keys from device
    memory (the day's key table) equal the twins on the host keys, bit
    for bit (checks.dev_key_pairs)."""
    _need_cuda()
    from reina_tpu_torch.kernels import checks
    before = kernels.launches()
    for name, kernel, twin in checks.dev_key_pairs(0, "cuda"):
        for g, w in zip(kernel(), twin()):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w), name
    after = kernels.launches()
    assert after["prng.draw"] - before["prng.draw"] == 5
    # one launch the single sample, one the pair
    assert after["random.gamma_fixed"] - before["random.gamma_fixed"] == 2
    assert (after["random.binomial_fixed"]
            - before["random.binomial_fixed"]) == 1


def test_graphed_agent_axis_refuses_gloo():
    """The graphed agent axis captures its collectives, which gloo
    cannot: run_days(graphs=True) on a gloo mesh on the card raises
    before any collective, a graph set on a gloo shard raises GraphError,
    and a gloo collective met under capture CollectiveError (each naming
    the backend); the default on a gloo mesh is the plain step."""
    _need_cuda()
    from reina_tpu_torch.core import graphs
    from reina_tpu_torch.core.engine import run_days
    from reina_tpu_torch.parallel import mesh as M
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=8192, days=3, seed=1)
    mesh = M.Mesh(n_seed=1, n_agent=2, rank=0, seed_index=0, agent_index=0,
                  device=torch.device("cuda"), backend="gloo",
                  agent_group=None, seed_group=None)
    with pytest.raises(ValueError, match="gloo"):
        run_days(run, mesh=mesh, graphs=True)
    shard = M.AgentShard(mesh, 8192)
    arrays, schedules, state, carry = M.shard_run(run, mesh)
    with pytest.raises(graphs.GraphError, match="gloo"):
        graphs.GraphSet(run.cfg, arrays, schedules, state, carry, "cuda",
                        shard)
    g = torch.cuda.CUDAGraph()
    x = torch.ones(4, dtype=torch.int32, device="cuda")
    with pytest.raises(M.CollectiveError, match="gloo"):
        with torch.cuda.graph(g):
            M.all_reduce(x, None, "gloo")
    torch.cuda.synchronize()
    assert int(x.sum()) == 4


def test_capture_failure_raises():
    """A span that reads a device value on the host cannot be captured:
    the graph runner raises, naming the span and its key; the card stays
    usable."""
    _need_cuda()
    from reina_tpu_torch.core import graphs
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=8192, days=3, seed=1)
    gs = graphs.GraphSet(run.cfg, run.arrays, run.schedules, run.init_state,
                         run.init_carry, "cuda")

    def host_read():
        x = torch.ones(8, device="cuda")
        return {"y": x * float(x.sum())}

    with pytest.raises(graphs.GraphError, match=r"span X \(7,\)"):
        gs.capture("X", (7,), host_read)
    torch.cuda.synchronize()
    assert float(torch.ones(4, device="cuda").sum()) == 4.0


def test_pick_kernel_matches_twin():
    """The tier picks folded into their producers (the prefix with its
    picks, the reduce-and-pick) against their twins (the producer's twin,
    then the picks' twin) at every branch of every pick of a tracing day
    and past each cap (checks.fold_checks, at the HUS agent count): the
    producer's outputs, the picks row, the branch tallies and the problem
    bits (with the overflow bits), exact; one launch a case."""
    _need_cuda()
    from reina_tpu_torch.core import daygraph, step
    from reina_tpu_torch.kernels import checks
    cfg = step.EngineConfig()
    cases = checks.fold_cases(cfg, checks.HUS_N)
    for name in daygraph.FOLDS:
        for node in daygraph.fold_nodes(cfg, name):
            n = 2 if isinstance(node, step.If) else len(node.keys())
            branches = set()
            for f, counts in cases:
                if f == name:
                    b = 0
                    for p in node.picks:
                        b = b * len(p.ends) + step.tier_branch(p, counts[
                            p.src])
                    branches.add(b)
            assert branches == set(range(n)), node.name
    for c in checks.fold_checks(checks.HUS_N, 0, "cuda"):
        before = kernels.launches()[c.name]
        r = checks.run_check(c, timing=False)
        assert kernels.launches()[c.name] - before == 1 + len(c.extra)
        assert r.ok, r


@pytest.mark.parametrize("day", [10, 18], ids=["plain_day", "tracing_day"])
def test_day_graph_equals_plain_step(day):
    """One day graph launch from the plain step's state before ``day``
    (day 10: no contact tracing, AB then the slot switch; day 18: A, the
    tracing if with its four switches, B, the slot switch) equals the
    plain day step's day bit for bit: outputs, state, carry, picks; no
    host read."""
    _need_cuda()
    from reina_tpu_torch import convert
    from reina_tpu_torch.core import graphs, step
    from reina_tpu_torch.core.engine import sched_row
    from reina_tpu_torch.core.schedule import Schedules
    from reina_tpu_torch.ops import prng
    from reina_tpu_torch.testing import build_synthetic_run
    run = build_synthetic_run("cuda", n_agents=20000, days=25, seed=3,
                              interventions=STEP_IVS)
    cfg = run.cfg
    host = Schedules(*(x.cpu().numpy() for x in run.schedules))
    key = prng.PRNGKey(run.random_seed)
    state = run.init_state
    carry = run.init_carry._replace(bkt_dst=run.init_carry.bkt_dst.clone())
    for d in range(day + 1):
        if d == day:
            before = (state, carry._replace(bkt_dst=carry.bkt_dst.clone()))
        picks = []
        dk = step.derive_day_keys(cfg, key, [d]).day(0)
        state, carry, out = step.day_step(cfg, run.arrays,
                                          sched_row(run.schedules, host, d),
                                          state, carry, dk, picks=picks)
    gs = graphs.GraphSet(cfg, run.arrays, run.schedules, *before, "cuda")
    plans = gs.prepare(host, key, day, 1, before[1].weekly_leftover,
                       state.age.shape[0])
    assert plans[0].ct_active == (day == 18)
    gs.start(cfg, run.arrays, run.schedules, *before, day, plans)
    step.reset_stats()
    gs.step(plans)
    torch.cuda.synchronize()
    assert step.STATS["launches"] == 1 and "reads" not in step.STATS
    st, cr = gs.state_carry(day + 1, plans[0].leftover, plans[0].problem,
                            clone=True)
    got = step.DayOutputs(*(x[0] for x in gs.outputs(day, day + 1, plans)))
    np.testing.assert_array_equal(gs.picks[day].cpu().numpy(), picks[0])
    for what, w, g in (("state", state, st), ("carry", carry, cr),
                       ("out", out, got)):
        w, g = convert.to_numpy(w), convert.to_numpy(g)
        for k in w:
            np.testing.assert_array_equal(w[k], g[k], err_msg=f"{what}.{k}")
