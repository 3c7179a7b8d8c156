"""The launchers of the day step's four fused per-agent passes.

Replaces reina_tpu/ops/fusedmap.py:fused_map (the Pallas kernel) for its
four bodies in reina_tpu/core/step.py: the exposure prologue, the
receiver plus progression front half, the post-ledger progression pass
and the end-of-day merge. Their plain PyTorch twins are the functions of
the same names in reina_tpu_torch/core/step.py. The post-ledger pass is
a CUDA kernel (kernels/csrc/post.cu, 16 agents a thread); the other
three are Triton kernels here, whose expressions are their twins written
out in ``tl``, operation for operation.

What bounds them on the card: bytes. Each body is pure elementwise over
the agent axis, 30-70 bytes per agent in and out (~120 MB for the
receiver pass at HUS size), with a handful of gathers from tables of at
most V·21 floats that stay in L1. The design is the Pallas one: one
masked block load of every stream, the arithmetic in registers, one
store of every output, so each byte crosses HBM once. i8 and i16 streams
load as they are; bool streams travel as uint8 views.

Numerics: ``exp`` and ``floor`` come from libdevice (``tl.exp`` is an
approximation and would flip the contact-count floors and infection
draws against the twin), and the kernels compile with
``enable_fp_fusion=False`` so no multiply-add pair becomes an FMA that
the twin does not perform.

The day-varying scalars (the day, the testing mode, the detect-anyway
probability, contact tracing on or off) reach the kernels through a
pointer, as one-element device tensors: a captured CUDA graph then
reads each replayed day's values from the day row (core/step.py), and
Triton, which specialises integer arguments on their values, compiles
each kernel once.

Triton is imported, and the kernels are compiled, at first launch: the
module is importable without it. The constants of
reina_tpu_torch/core/constants.py appear as literals here and in
post.cu, and are asserted below (states
SUSCEPTIBLE..DEAD = 0..6, severities ASYMPTOMATIC..FATAL = 0..4, testing
modes ALL_WITH_SYMPTOMS_CT = 1, ALL_WITH_SYMPTOMS = 2,
ONLY_SEVERE_SYMPTOMS = 3).
"""
from __future__ import annotations

import torch

from . import launched
from ..core import constants as C

BLOCK = 1024
_jit = {}


def _load_triton():
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:  # older Triton layouts
        try:
            from triton.language.extra.cuda import libdevice
        except ImportError:
            libdevice = tl.math
    g = globals()
    g["tl"], g["ld"], g["triton"] = tl, libdevice, triton
    return triton


def _kernel(fn):
    if fn.__name__ not in _jit:
        triton = _load_triton()
        _jit[fn.__name__] = triton.jit(fn)
    return _jit[fn.__name__]


def _b(x):
    """A bool stream as bytes."""
    return x.view(torch.uint8)


def _check(n, device, **streams):
    for name, (t, dt) in streams.items():
        if t.device != device or not t.is_cuda:
            raise ValueError(f"{name}: expected a tensor on {device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.shape[-1] != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (..., {n})")


def _scalar(x, dtype, dev):
    """A scalar argument: the one-element tensor on ``dev`` that the
    kernel loads (a 0-d view of the day row on the main path)."""
    if not isinstance(x, torch.Tensor) or x.device != dev \
            or x.dtype != dtype or x.numel() != 1:
        raise TypeError(f"expected one {dtype} element on {dev}, got {x!r}")
    return x


def _launch(fn, n, *args, **meta):
    grid = ((n + BLOCK - 1) // BLOCK,)
    _kernel(fn)[grid](*args, n, BLOCK=BLOCK, num_warps=4,
                      enable_fp_fusion=False, **meta)


# ---------------------------------------------------------------------------
# kernels (compiled at first launch; `tl` and `ld` are bound then)

def _prologue_kernel(st8, dl, doil, doi, sev8, var8, wdet, isinf, act, z,
                     nc_ag, incl, ninf, iot, asym, infm, day_ptr,
                     o_exposer, o_inf_base, o_k_s, o_vts, o_count_now,
                     o_included, o_ninf_m, n,
                     V: tl.constexpr, T: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    st = tl.load(st8 + offs, mask=m, other=0).to(tl.int32)
    sev = tl.load(sev8 + offs, mask=m, other=0).to(tl.int32)
    var = tl.load(var8 + offs, mask=m, other=0).to(tl.int32)
    dl_ = tl.load(dl + offs, mask=m, other=0).to(tl.int32)
    doil_ = tl.load(doil + offs, mask=m, other=0).to(tl.int32)
    doi_ = tl.load(doi + offs, mask=m, other=0).to(tl.int32)
    wdet_ = tl.load(wdet + offs, mask=m, other=0) != 0
    isinf_ = tl.load(isinf + offs, mask=m, other=0) != 0
    act_ = tl.load(act + offs, mask=m, other=0) != 0
    incl_ = tl.load(incl + offs, mask=m, other=0) != 0
    z_ = tl.load(z + offs, mask=m, other=0.0)
    nc = tl.load(nc_ag + offs, mask=m, other=0.0)
    ninf_ = tl.load(ninf + offs, mask=m, other=0)
    day = tl.load(day_ptr)

    removed = (st == 5) | (st == 6)
    count_now = removed & (incl_ == 0) & act_
    included = incl_ | count_now
    ninf_m = tl.where(count_now, ninf_, 0)

    day_rel = tl.where(st == 1, -dl_, doil_)
    iot_idx = day_rel + 10
    iot_ok = (iot_idx >= 0) & (iot_idx < T)
    iot_idx_c = tl.minimum(tl.maximum(iot_idx, 0), T - 1)
    can_expose = ((st == 1) & (doi_ < day)) | (st == 2)
    asympt = sev == 0
    iot_val = tl.load(iot + var * T + iot_idx_c,
                      mask=m & (var >= 0) & (var < V), other=0.0)
    vt = tl.where((var >= 1) & (var < V), var, 0)
    asym_v = tl.load(asym + vt, mask=m, other=0.0)
    infm_v = tl.load(infm + vt, mask=m, other=0.0)
    inf_base = iot_val * tl.where(asympt, asym_v, 1.0) * infm_v
    exposer = can_expose & iot_ok & act_ & (wdet_ == 0) & isinf_
    inf_base = tl.where(exposer, inf_base, 0.0)
    exposer = inf_base > 0

    sympt_ill = (st == 2) & (asympt == 0)
    factor = tl.where(sympt_ill, 0.5, 1.0)
    limit = tl.where(sympt_ill, 5, 100)
    f = ld.exp(0.5 * z_) * nc * factor
    f = tl.maximum(f, 1.0)
    k_s = ld.floor(f).to(tl.int32) - 1
    k_s = tl.minimum(tl.maximum(k_s, 0), limit)
    k_s = tl.where(exposer, k_s, 0)
    vts = (var * T + iot_idx_c) * 2 + asympt.to(tl.int32)

    tl.store(o_exposer + offs, exposer.to(tl.uint8), mask=m)
    tl.store(o_inf_base + offs, inf_base, mask=m)
    tl.store(o_k_s + offs, k_s, mask=m)
    tl.store(o_vts + offs, vts, mask=m)
    tl.store(o_count_now + offs, count_now.to(tl.uint8), mask=m)
    tl.store(o_included + offs, included.to(tl.uint8), mask=m)
    tl.store(o_ninf_m + offs, ninf_m, mask=m)


def _recv_front_kernel(band, lam, isinf, hasimm, act, u_inf, u_var, st8, doi,
                       dl, o2r, sev8, wdet, dout, doil, u_day, var8,
                       D, rbt, rwt, day_ptr, mode_ptr, dap_ptr,
                       o_nc, o_nv, o_susc, o_dl_a, o_doil, o_onset, o_queue,
                       o_die_home, o_bed_req, o_recover_ill, o_hosp_end,
                       o_icu_req, o_hosp_recover, o_icu_end, o_icu_die,
                       o_icu_recover, n,
                       V: tl.constexpr, B: tl.constexpr,
                       BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    band_ = tl.load(band + offs, mask=m, other=0)
    isinf_ = tl.load(isinf + offs, mask=m, other=0) != 0
    hasimm_ = tl.load(hasimm + offs, mask=m, other=0) != 0
    act_ = tl.load(act + offs, mask=m, other=0) != 0
    u_inf_ = tl.load(u_inf + offs, mask=m, other=0.0)
    u_var_ = tl.load(u_var + offs, mask=m, other=0.0)

    # receiver: per-band dart intensity → infection draw and variant pick
    band_ok = m & (band_ >= 0) & (band_ < B)
    one_minus = tl.full((BLOCK,), 1.0, tl.float32)
    h_sum = tl.zeros((BLOCK,), tl.float32)
    for v in tl.static_range(V):
        d_ag = tl.load(D + v * B + band_, mask=band_ok, other=0.0)
        lam_v = tl.load(lam + v * n + offs, mask=m, other=0.0)
        h = 1.0 - ld.exp(d_ag * lam_v)
        one_minus = one_minus * (1.0 - h)
        h_sum = h_sum + h
    p_inf = 1.0 - one_minus
    susc = act_ & (isinf_ == 0) & (hasimm_ == 0)
    nc = susc & (u_inf_ < p_inf)
    u = u_var_ * tl.maximum(h_sum, 1e-30)
    run = tl.zeros((BLOCK,), tl.float32)
    nv = tl.zeros((BLOCK,), tl.int32)
    for v in tl.static_range(V - 1):
        d_ag = tl.load(D + v * B + band_, mask=band_ok, other=0.0)
        lam_v = tl.load(lam + v * n + offs, mask=m, other=0.0)
        run = run + (1.0 - ld.exp(d_ag * lam_v))
        nv = nv + (u >= run).to(tl.int32)
    nv = tl.minimum(tl.maximum(nv, 0), V - 1)

    # progression front half: counters, transitions, seeks, requests
    st = tl.load(st8 + offs, mask=m, other=0).to(tl.int32)
    sev = tl.load(sev8 + offs, mask=m, other=0).to(tl.int32)
    var = tl.load(var8 + offs, mask=m, other=0).to(tl.int32)
    doi_ = tl.load(doi + offs, mask=m, other=0).to(tl.int32)
    dl_ = tl.load(dl + offs, mask=m, other=0).to(tl.int32)
    doil_ = tl.load(doil + offs, mask=m, other=0).to(tl.int32)
    o2r_ = tl.load(o2r + offs, mask=m, other=0.0)
    wdet_ = tl.load(wdet + offs, mask=m, other=0) != 0
    dout_ = tl.load(dout + offs, mask=m, other=0) != 0
    u_ = tl.load(u_day + offs, mask=m, other=0.0)
    day = tl.load(day_ptr)
    mode = tl.load(mode_ptr)
    dap = tl.load(dap_ptr)

    live = isinf_ & act_
    adv_inc = (st == 1) & (doi_ < day) & live
    adv_ill = (st == 2) & live
    adv_hosp = (st == 3) & live
    adv_icu = (st == 4) & live
    adv_any = adv_inc | adv_ill | adv_hosp | adv_icu
    dl_new = tl.where(adv_any, tl.maximum(dl_ - 1, 0), dl_)
    fire = adv_any & (dl_new == 0)

    vt = tl.where((var >= 1) & (var < V), var, 0)
    rb = tl.load(rbt + vt, mask=m, other=0.0)
    onset = adv_inc & fire
    illness_days = ld.floor(o2r_ * tl.where(sev >= 2, rb, 1.0) + 0.5).to(
        tl.int16).to(tl.int32)
    dl_a = tl.where(onset, illness_days, dl_new).to(tl.int16)

    asympt = sev == 0
    seek = onset & (asympt == 0) & (wdet_ == 0)
    queue_new = seek & ((mode == 2) | (mode == 1)
                        | ((mode == 3) & ((sev >= 2) | (u_ < dap))))
    ill_end = adv_ill & fire
    die_home = ill_end & (sev == 4) & dout_
    bed_request = ill_end & (sev >= 2) & (die_home == 0)
    recover_ill = ill_end & (die_home == 0) & (bed_request == 0)
    doil_new = tl.where(adv_ill, doil_ + 1, doil_).to(tl.int16)
    hosp_end = adv_hosp & fire
    icu_request = hosp_end & (sev >= 3)
    hosp_recover = hosp_end & (icu_request == 0)
    icu_end = adv_icu & fire
    icu_die = icu_end & (sev == 4)
    icu_recover = icu_end & (icu_die == 0)

    tl.store(o_nc + offs, nc.to(tl.uint8), mask=m)
    tl.store(o_nv + offs, nv, mask=m)
    tl.store(o_susc + offs, susc.to(tl.uint8), mask=m)
    tl.store(o_dl_a + offs, dl_a, mask=m)
    tl.store(o_doil + offs, doil_new, mask=m)
    tl.store(o_onset + offs, onset.to(tl.uint8), mask=m)
    tl.store(o_queue + offs, queue_new.to(tl.uint8), mask=m)
    tl.store(o_die_home + offs, die_home.to(tl.uint8), mask=m)
    tl.store(o_bed_req + offs, bed_request.to(tl.uint8), mask=m)
    tl.store(o_recover_ill + offs, recover_ill.to(tl.uint8), mask=m)
    tl.store(o_hosp_end + offs, hosp_end.to(tl.uint8), mask=m)
    tl.store(o_icu_req + offs, icu_request.to(tl.uint8), mask=m)
    tl.store(o_hosp_recover + offs, hosp_recover.to(tl.uint8), mask=m)
    tl.store(o_icu_end + offs, icu_end.to(tl.uint8), mask=m)
    tl.store(o_icu_die + offs, icu_die.to(tl.uint8), mask=m)
    tl.store(o_icu_recover + offs, icu_recover.to(tl.uint8), mask=m)


def _finalize_kernel(st8, sev8, var8, var_new, dl, doil, doi, newly, isinf,
                     trc, det, det_hosp, day_ptr, ct_ptr,
                     o_st, o_sev, o_var, o_dl, o_doil, o_doi, o_isinf,
                     o_trc, o_det, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    st = tl.load(st8 + offs, mask=m, other=0).to(tl.int32)
    sev = tl.load(sev8 + offs, mask=m, other=0)
    var = tl.load(var8 + offs, mask=m, other=0).to(tl.int32)
    vnew = tl.load(var_new + offs, mask=m, other=0)
    dl_ = tl.load(dl + offs, mask=m, other=0)
    doil_ = tl.load(doil + offs, mask=m, other=0).to(tl.int32)
    doi_ = tl.load(doi + offs, mask=m, other=0).to(tl.int32)
    newly_ = tl.load(newly + offs, mask=m, other=0) != 0
    isinf_ = tl.load(isinf + offs, mask=m, other=0) != 0
    trc_ = tl.load(trc + offs, mask=m, other=0) != 0
    det_ = tl.load(det + offs, mask=m, other=0) != 0
    det_hosp_ = tl.load(det_hosp + offs, mask=m, other=0) != 0
    day = tl.load(day_ptr)
    ct = tl.load(ct_ptr)

    tl.store(o_st + offs, tl.where(newly_, 1, st).to(tl.int8), mask=m)
    tl.store(o_sev + offs, sev, mask=m)
    tl.store(o_var + offs, tl.where(newly_, vnew, var).to(tl.int8), mask=m)
    tl.store(o_dl + offs, dl_, mask=m)
    tl.store(o_doil + offs, tl.where(newly_, 0, doil_).to(tl.int16), mask=m)
    tl.store(o_doi + offs, tl.where(newly_, day, doi_).to(tl.int16), mask=m)
    tl.store(o_isinf + offs, (isinf_ | newly_).to(tl.uint8), mask=m)
    tl.store(o_trc + offs, (trc_ | (newly_ & (ct != 0))).to(tl.uint8),
             mask=m)
    tl.store(o_det + offs, (det_ | det_hosp_).to(tl.uint8), mask=m)


# ---------------------------------------------------------------------------
# launchers: same arguments as the twins in core/step.py

I8, I16, I32 = torch.int8, torch.int16, torch.int32
F32, BOOL = torch.float32, torch.bool


def _empty(n, dev, *dts):
    return [torch.empty(n, dtype=dt, device=dev) for dt in dts]


def prologue(st8, dl, doil, doi, sev8, var8, wdet, isinf, act, z, nc_ag,
             incl, ninf, iot, asym, infm, day):
    n, dev = st8.shape[0], st8.device
    _check(n, dev, st8=(st8, I8), dl=(dl, I16), doil=(doil, I16),
           doi=(doi, I16), sev8=(sev8, I8), var8=(var8, I8),
           wdet=(wdet, BOOL), isinf=(isinf, BOOL), act=(act, BOOL),
           z=(z, F32), nc_ag=(nc_ag, F32), incl=(incl, BOOL),
           ninf=(ninf, I32))
    V, T = iot.shape
    outs = _empty(n, dev, BOOL, F32, I32, I32, BOOL, BOOL, I32)
    launched("fused_map.prologue")
    _launch(_prologue_kernel, n, st8, dl, doil, doi, sev8, var8, _b(wdet),
            _b(isinf), _b(act), z, nc_ag, _b(incl), ninf,
            iot.contiguous(), asym.contiguous(), infm.contiguous(),
            _scalar(day, I32, dev),
            *[_b(o) if o.dtype == BOOL else o for o in outs], V=V, T=T)
    return tuple(outs)


def recv_front(band, lam, isinf, hasimm, act, u_inf, u_var, st8, doi, dl,
               o2r, sev8, wdet, dout, doil, u_day, var8, D, rbt, rwt, day,
               mode, dap):
    n, dev = st8.shape[0], st8.device
    _check(n, dev, band=(band, I32), lam=(lam, F32), isinf=(isinf, BOOL),
           hasimm=(hasimm, BOOL), act=(act, BOOL), u_inf=(u_inf, F32),
           u_var=(u_var, F32), st8=(st8, I8), doi=(doi, I16), dl=(dl, I16),
           o2r=(o2r, F32), sev8=(sev8, I8), wdet=(wdet, BOOL),
           dout=(dout, BOOL), doil=(doil, I16), u_day=(u_day, F32),
           var8=(var8, I8))
    V, B = D.shape
    if lam.shape != (V, n):
        raise ValueError(f"lam: expected ({V}, {n}), got {tuple(lam.shape)}")
    outs = _empty(n, dev, BOOL, I32, BOOL, I16, I16, *([BOOL] * 11))
    launched("fused_map.recv_front")
    _launch(_recv_front_kernel, n, band, lam, _b(isinf), _b(hasimm),
            _b(act), u_inf, u_var, st8, doi, dl, o2r, sev8, _b(wdet),
            _b(dout), doil, u_day, var8, D.contiguous(), rbt.contiguous(),
            rwt.contiguous(), _scalar(day, I32, dev), _scalar(mode, I32, dev),
            _scalar(dap, F32, dev),
            *[_b(o) if o.dtype == BOOL else o for o in outs], V=V, B=B)
    return tuple(outs)


def post(st8, sev8, var8, o2r, dl_a, gbed, gicu, u_day, bed_request,
         icu_request, die_home, recover_ill, hosp_recover, icu_die,
         icu_recover, wdet, isinf, hasimm, evericu, onset, rbt, rwt, picut,
         phospt, events=None):
    """kernels/csrc/post.cu, one launch: every stream (N,), contiguous
    and 16-byte aligned, the four tables (V,) float32. ``events``: None,
    or 2 recorded CUDA events the kernel records again before and after
    its launch (for timing)."""
    n, dev = st8.shape[0], st8.device
    streams = dict(
        st8=(st8, I8), sev8=(sev8, I8), var8=(var8, I8), o2r=(o2r, F32),
        dl_a=(dl_a, I16), gbed=(gbed, BOOL), gicu=(gicu, BOOL),
        u_day=(u_day, F32), bed_request=(bed_request, BOOL),
        icu_request=(icu_request, BOOL), die_home=(die_home, BOOL),
        recover_ill=(recover_ill, BOOL), hosp_recover=(hosp_recover, BOOL),
        icu_die=(icu_die, BOOL), icu_recover=(icu_recover, BOOL),
        wdet=(wdet, BOOL), isinf=(isinf, BOOL), hasimm=(hasimm, BOOL),
        evericu=(evericu, BOOL), onset=(onset, BOOL))
    _check(n, dev, **streams)
    ins = [t for t, _ in streams.values()]
    tabs = [rbt, rwt, picut, phospt]
    V = rbt.shape[0]
    if any(t.dim() != 1 for t in ins) or V < 1 or any(
            t.device != dev or t.dtype != F32 or t.shape != (V,)
            or not t.is_contiguous() for t in tabs):
        raise TypeError("post kernel takes (N,) streams and four contiguous "
                        "(V,) float32 tables")
    outs = _empty(n, dev, I8, I16, BOOL, BOOL, BOOL, BOOL, BOOL)
    if any(t.data_ptr() % 16 for t in ins + outs):
        raise TypeError("post kernel takes 16-byte aligned streams")
    from . import build
    build.check(build.lib().reina_post(
        build.pointers(ins), build.pointers(tabs), V, build.pointers(outs),
        n, build.event_handles(events), build.stream_of(st8)),
        "fused_map.post")
    launched("fused_map.post")
    return tuple(outs)


def finalize(st8, sev8, var8, var_new, dl, doil, doi, newly, isinf, trc,
             det, det_hosp, day, ct):
    n, dev = st8.shape[0], st8.device
    _check(n, dev, st8=(st8, I8), sev8=(sev8, I8), var8=(var8, I8),
           var_new=(var_new, I32), dl=(dl, I16), doil=(doil, I16),
           doi=(doi, I16), newly=(newly, BOOL), isinf=(isinf, BOOL),
           trc=(trc, BOOL), det=(det, BOOL), det_hosp=(det_hosp, BOOL))
    outs = _empty(n, dev, I8, I8, I8, I16, I16, I16, BOOL, BOOL, BOOL)
    launched("fused_map.finalize")
    _launch(_finalize_kernel, n, st8, sev8, var8, var_new, dl, doil, doi,
            _b(newly), _b(isinf), _b(trc), _b(det), _b(det_hosp),
            _scalar(day, I32, dev), _scalar(ct, I32, dev), *[_b(o) if o.dtype == BOOL else o for o in outs])
    return tuple(outs)


LAUNCHERS = {"prologue": prologue, "recv_front": recv_front, "post": post,
             "finalize": finalize}

assert C.INCUBATION == 1 and C.DEAD == 6 and C.FATAL == 4
assert (C.ILLNESS, C.HOSPITALIZED, C.IN_ICU, C.RECOVERED) == (2, 3, 4, 5)
assert (C.SEVERE, C.CRITICAL) == (2, 3)
assert C.TESTING_ALL_WITH_SYMPTOMS_CT == 1 and C.TESTING_ONLY_SEVERE_SYMPTOMS == 3
