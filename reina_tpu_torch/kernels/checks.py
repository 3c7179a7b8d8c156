"""Kernel-against-twin checks on a CUDA device.

For each hand-written kernel of the main path: inputs at a given agent
count made from a numpy seed (value ranges as the day step produces
them), one launch through the kernel's wrapper and one through its
plain PyTorch twin on the same device, the comparison with its stated
tolerance, and three device times (kernel, twin and, where one PyTorch
call computes the same function, that call). The draw and sampler
kernels are also held to their twins with their keys read from device
memory (``dev_key_pairs``, as a captured day step passes them), and the
day graph's tier picks, folded into the launches that produce their
counts, at every branch of every pick of the day (``fold_checks``). Used by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the prefix sums, histograms and ledger outputs (grants and
final balances) are exact, and so is the post body (integer and bool
outputs only); the other fused bodies' integer and bool outputs are
exact and their float outputs within 2 ulp (libdevice ``exp`` and the
twin's ``torch.exp`` may round differently).

Timing (:func:`time_ms`): the median of 7 single launches, each with a
cold L2 (a 64 MiB buffer is written just before it) and each behind a
device-side sleep long enough for the host to enqueue the launch, so
that the CUDA events bracket device time only. :func:`launch_times`
times each launch of the CUDA kernels the same way, through the CUDA
events their entry points record around it.

Bound (:func:`bound_ms`): the larger of the bytes the function must
move (each input read once, each output written once; for the
2-D histogram, the gate for every agent and ``code_a``, ``w`` and
``code_b`` only where it is true)
over the H100 SXM's 3.35 TB/s, and its operations over the 67 TFLOP/s
of the CUDA cores (``OPS_PER_AGENT``, counted from the twin's
arithmetic: a compare, select, add or multiply is one, a transcendental
about ten). The draws and the samplers are bound by integer operations
instead, over :func:`int32_ops_per_s` (64 INT32 lanes an SM × 132 SMs ×
the SM clock that ``nvidia-smi --query-gpu=clocks.max.sm`` reports):
``OPS_PER_AGENT`` counts their threefry hashes, ~72 INT32 operations
each (20 rounds of add, funnel shift and xor, and the key injections).
``prng.draw`` is one hash an element. ``random.gamma_fixed`` is two a
lane of each sample (the normal and the uniform of the first round; the
few lanes that reject and run later rounds are not counted; the day
step's call draws two samples). ``random.binomial_fixed`` is one for a
lane that the CDF inversion takes (n·p ≤ 10, n and p non-zero), none for
a lane with n = 0 or p = 0 there, and two for a BTRS lane (its first
round), counted from the lanes' n and p (:func:`binomial_int_ops`).
Their float arithmetic, a few dozen operations a round on other units,
is not counted: the bound stays a lower bound.
"""
from __future__ import annotations

import functools
import math
import subprocess
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core import step
from ..ops import clamped, fusedmap, prng
from ..ops import random as samplers
from . import fused_bodies

HUS_N = 1686528          # the HUS run's padded agent count
HUS_AGENTS = 1685983
VS_N = 480256            # Varsinais-Suomi's, padded to a multiple of 1024
VS_AGENTS = 479861
# the real agents of a run's padded count (the rest are padding)
REAL_AGENTS = {HUS_N: HUS_AGENTS, VS_N: VS_AGENTS}
V, T, B, G, A = 2, 21, 9, 10, 101
VTS = V * T * 2

HBM_BYTES_PER_S = 3.35e12      # H100 SXM 80 GB, published peak
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
INT32_LANES_PER_SM, SMS = 64, 132   # H100 SXM
MAX_SM_CLOCK_HZ = 1.98e9       # H100 SXM boost, when nvidia-smi says none

HASH_OPS = 72                  # INT32 operations of one threefry hash

# operations per agent of each function (see the module docstring); for
# the draws and the samplers INT32 operations an element or lane
OPS_PER_AGENT = {
    "fused_map.prologue": 60, "fused_map.recv_front": 150,
    "fused_map.post": 80, "fused_map.finalize": 25, "ledger_scan": 16,
    "fused_concat_prefix": 60, "fused_onehot_sum": 26,
    "fused_fn_onehot_sum": 35, "fused_bihistogram": 4,
    "ledger_sharded": 16, "concat_prefix_sharded": 60,
    "prng.draw": HASH_OPS, "random.gamma_fixed": 2 * HASH_OPS,
    "random.binomial_fixed": HASH_OPS,          # a BTRS lane: 2 * HASH_OPS
    # the prefix with a pick (a pick's few dozen operations are nothing
    # beside N agents'); the maximum: a compare a fill value
    "fused_concat_prefix.pick": 60, "daygraph.max_pick": 1,
    "concat_prefix_sharded.pick": 60,
}
INT32_BOUND = ("prng.draw", "random.gamma_fixed", "random.binomial_fixed")

@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), or
    MAX_SM_CLOCK_HZ where nvidia-smi gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return MAX_SM_CLOCK_HZ


def int32_ops_per_s() -> float:
    return INT32_LANES_PER_SM * SMS * sm_clock_hz()


@dataclass
class Check:
    name: str
    route: str
    source: str
    replaces: str
    kernel: Callable[[], tuple]
    twin: Callable[[], tuple]
    float_ulp: int = 0
    inputs: Sequence = ()             # tensors the function reads
    library: Optional[Callable] = None  # one PyTorch call, same function
    library_note: str = ""            # what it is, or why there is none
    read_bytes: Optional[int] = None  # data-dependent input bytes
    # the bytes it writes, where less than the outputs compared
    write_bytes: Optional[int] = None
    # the elements or lanes the bound counts (default: inputs[0]'s)
    n: Optional[int] = None
    int_ops: Optional[float] = None   # data-dependent INT32 operations
    # further (kernel, twin) pairs compared but not timed
    extra: Sequence = field(default_factory=tuple)


@dataclass
class Result:
    name: str
    ok: bool
    mismatches: int
    max_abs_err: float
    max_ulp: int
    ms: float
    plain_ms: float
    library_ms: Optional[float]
    bound_ms: float
    bound_by: str


def _streams(n, seed, dev):
    r = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dict(
        st=t(r.integers(0, 7, n).astype(np.int8)),
        sev=t(r.integers(0, 5, n).astype(np.int8)),
        var=t(r.integers(0, V, n).astype(np.int8)),
        dl=t(r.integers(0, 4, n).astype(np.int16)),
        doil=t(r.integers(-2, 12, n).astype(np.int16)),
        doi=t(r.integers(-1, 30, n).astype(np.int16)),
        b=[t(r.random(n) < p) for p in np.linspace(0.05, 0.7, 14)],
        f=[t(r.random(n).astype(np.float32)) for _ in range(3)],
        z=t(r.standard_normal(n).astype(np.float32)),
        nc=t((r.random(n) * 30).astype(np.float32)),
        ninf=t(r.integers(0, 5, n).astype(np.int32)),
        band=t(r.integers(0, B, n).astype(np.int32)),
        lam=t(np.log1p(-r.random((V, n)) * 1e-3).astype(np.float32)),
        o2r=t((r.random(n) * 30).astype(np.float32)),
        vnew=t(r.integers(0, V, n).astype(np.int32)),
        tabs=[t((r.random(V) * 0.8 + 0.05).astype(np.float32))
              for _ in range(4)],
        iot=t((r.random((V, T)) * 0.2).astype(np.float32)),
        D=t(np.floor(r.random((V, B)) * 500).astype(np.float32)),
        rel=[t((r.random(n) < 0.002).astype(np.int32)) for _ in range(2)],
        req=[t(r.random(n) < 0.003) for _ in range(2)],
        w=t((r.random(n) * (r.random(n) < 0.05) * 40).astype(np.float32)),
        newly=t((r.random(n) < 0.001).astype(np.float32)),
        code=t(r.integers(0, G + 1, n).astype(np.int32)),
        offset=int(r.integers(0, n)),
        **_histogram_streams(r, n, t),
    )


def _histogram_streams(r, n, t):
    """Phase-7 fields and the dart aggregation's inputs as the day step
    passes them, with its value ranges: agents laid out by age
    (``np.repeat(arange(101), counts)``, padding last with group code
    G), a gate of ~3% exposers, a vts code for every agent, int32
    contact counts <= 128 (0 off the gate)."""
    n_real = REAL_AGENTS.get(n, n - n // 300)
    ages = np.sort(r.integers(0, A, n)).astype(np.int32)
    grp = np.minimum(ages // 10, G - 1).astype(np.int32)
    grp[n_real:] = G
    active = np.arange(n) < n_real
    st = r.choice(7, n, p=[.6, .02, .02, .005, .002, .34, .013]) \
        .astype(np.int8)
    exposer = r.random(n) < 0.03
    return dict(
        ages=t(ages), ages_random=t(r.permutation(ages)),
        grp=t(grp), grp_random=t(r.permutation(grp)),
        fields=[t(active), t(r.random(n) < 0.03), t(r.random(n) < 0.3),
                t(np.where(r.random(n) < 0.2, r.integers(0, 365, n), -1)
                  .astype(np.int16)),
                t(r.random(n) < 0.002), t(st), t(r.random(n) < 0.001),
                t(r.random(n) < 0.005), t(r.random(n) < 0.002)],
        gate=t(exposer),
        vts=t(r.integers(0, VTS, n).astype(np.int32)),
        k_s=t(np.where(exposer, r.integers(0, 129, n), 0).astype(np.int32)),
    )


def post_args(s):
    """The post body's 20 streams and 4 tables, from :func:`_streams`."""
    b, f = s["b"], s["f"]
    return ([s["st"], s["sev"], s["var"], s["o2r"], s["dl"]] + b[:2]
            + [f[2]] + b[2:14] + s["tabs"])


# float32 products p = o2r * x in this open interval round to 0.5 - 2^-25,
# and fl(fl(p) + 0.5) = 1 (a tie, to even), while a fused multiply-add
# rounds p + 0.5 once, to 1 - 2^-24: floor(o2r * x + 0.5) is 1 without
# contraction and 0 with it
ROUND_EDGE = (0.5 - 1.5 * 2.0 ** -25, 0.5 - 2.0 ** -25)


def _edge_o2r(x) -> np.ndarray:
    """The float32 o2r values near 0.5 / x whose exact product with the
    float32 x lies in ROUND_EDGE."""
    x = np.float32(x)
    o = np.float32(np.float64(sum(ROUND_EDGE) / 2) / np.float64(x))
    near = [o]
    for _ in range(8):
        near = ([np.nextafter(near[0], np.float32(0))] + near
                + [np.nextafter(near[-1], np.float32(np.inf))])
    p = np.array(near, np.float64) * np.float64(x)
    return np.array(near, np.float32)[(p > ROUND_EDGE[0])
                                      & (p < ROUND_EDGE[1])]


def post_edge_args(n, seed, dev):
    """Post-body inputs on the rounding edge of hosp_days and icu_days:
    tables of V = 2 variants whose three day ratios (1 - rb, rw and
    1 - rw - rb, in float32) each have o2r values in ROUND_EDGE; half the
    agents granted a bed, half an ICU unit (a few denied), each with an
    edge o2r of its ratio or one up to 3 ulps beside it, so that
    floor(o2r * x + 0.5) takes both values. Where a kernel contracts the
    product and the sum into an FMA, its days_left differs from the
    twin's."""
    r = np.random.default_rng(seed)
    tabs, edges = [], []
    for _ in range(V):
        while True:
            rb, rw = r.uniform(0.05, 0.45, 2).astype(np.float32)
            one = np.float32(1)
            xs = (one - rb, rw, (one - rw) - rb)
            hits = [_edge_o2r(x) for x in xs]
            if all(len(h) for h in hits):
                break
        tabs.append((rb, rw))
        edges.append(hits)
    var = r.integers(0, V, n).astype(np.int8)
    sev = r.integers(2, 5, n).astype(np.int8)
    icu = r.random(n) < 0.5
    kind = np.where(icu, 2, np.where(sev == 2, 0, 1))
    o2r = np.empty(n, np.float32)
    for v in range(V):
        for k in range(3):
            sel = (var == v) & (kind == k)
            o = r.choice(edges[v][k], int(sel.sum()))
            for _ in range(3):   # up to 3 ulps beside the edge
                step = r.integers(-1, 2, o.size)
                o = np.where(step < 0, np.nextafter(o, np.float32(0)),
                             np.where(step > 0,
                                      np.nextafter(o, np.float32(np.inf)),
                                      o)).astype(np.float32)
            o2r[sel] = o
    granted = r.random(n) < 0.9

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def bools(p):
        return t(r.random(n) < p)

    no = t(np.zeros(n, bool))
    rb_t = np.array([a for a, _ in tabs], np.float32)
    rw_t = np.array([b for _, b in tabs], np.float32)
    return ([t(r.integers(0, 7, n).astype(np.int8)), t(sev), t(var),
             t(o2r), t(r.integers(0, 30, n).astype(np.int16)),
             t(~icu & granted), t(icu & granted),
             t(r.random(n).astype(np.float32)), t(~icu), t(icu), no,
             bools(0.01), bools(0.01), no, bools(0.01), bools(0.5),
             bools(0.9), bools(0.1), bools(0.1), no]
            + [t(rb_t), t(rw_t), t(r.uniform(0.05, 0.9, V).astype(np.float32)),
               t(r.uniform(0.05, 0.9, V).astype(np.float32))])


_FM = "reina_tpu/ops/fusedmap.py"
_STEP = "reina_tpu/core/step.py"
_RND = "reina_tpu/ops/random.py"


def checks(n: int, seed: int, dev) -> List[Check]:
    s = _streams(n, seed, dev)
    b, f = s["b"], s["f"]
    # the day's scalars as the day step passes them: 0-d tensors of its
    # day row, which the kernels load through a pointer

    def scalar(x, dt):
        return torch.tensor(x, dtype=dt, device=dev)

    day, mode, dap, ct = (scalar(40, torch.int32), scalar(3, torch.int32),
                          scalar(0.25, torch.float32), scalar(1, torch.int32))

    pro = [s["st"], s["dl"], s["doil"], s["doi"], s["sev"], s["var"], b[0],
           b[1], b[2], s["z"], s["nc"], b[3], s["ninf"], s["iot"],
           s["tabs"][0], s["tabs"][1], day]
    rf = [s["band"], s["lam"], b[4], b[5], b[6], f[0], f[1], s["st"],
          s["doi"], s["dl"], s["o2r"], s["sev"], b[7], b[8], s["doil"],
          f[2], s["var"], s["D"], s["tabs"][0], s["tabs"][1], day, mode,
          dap]
    po = post_args(s)
    fin = [s["st"], s["sev"], s["var"], s["vnew"], s["dl"], s["doil"],
           s["doi"], b[0], b[1], b[2], b[3], b[4], day, ct]
    init = torch.tensor([300, 60], dtype=torch.int32, device=dev)

    def ledger(fn, offset, rel=s["rel"], req=s["req"]):
        def call():
            g, fin_ = fn(rel, req, init, offset)
            return tuple(g) + (fin_,)
        return call

    def ledger_pair(offset, **kw):
        return (ledger(clamped.clamped_counter_grants, offset, **kw),
                ledger(clamped.grants_twin, offset, **kw))

    # a partial last tile of 4096 agents and a length % 4 != 0
    n_odd = n - 3095
    rel_odd = [r[:n_odd].clone() for r in s["rel"]]
    req_odd = [q[:n_odd].clone() for q in s["req"]]
    # prefix weights that are not integers (f[0]), and 21504 of them,
    # whose blocks of 56 rows (max_block_rows 64) are no power of two
    r56 = np.random.default_rng(seed + 1)
    w56 = torch.from_numpy(r56.random(21504).astype(np.float32)).to(dev)
    codes56 = torch.from_numpy(r56.integers(0, V, 21504)
                               .astype(np.int32)).to(dev)

    def prefix_pair(w, c, n_seg, rows):
        return (lambda: (fusedmap.fused_concat_prefix(w, c, n_seg, rows),),
                lambda: (fusedmap.concat_prefix_twin(w, c, n_seg, rows),))

    masks = [bb for bb in b[:13]]
    codes = s["var"].to(torch.int32)
    masks_f = [m.to(torch.float32) for m in masks]
    fields, grp = s["fields"], s["grp"]
    out_masks = step._output_masks_reduced(*fields)
    out_masks_f = [m.to(torch.float32) for m in out_masks]
    gate, vts, ks, ages = s["gate"], s["vts"], s["k_s"], s["ages"]
    elig = fields[0] & (ages >= 16) & (ages <= 79) & b[13]
    exposers = int(gate.sum())
    flat = torch.where(gate, vts * A + ages, VTS * A).long()
    ks_f = ks.to(torch.float32)
    grp_l = grp.long()
    cat = torch.cat([torch.where(codes == v, s["w"], 0.0) for v in range(V)])

    def post_pair(args):
        return (lambda: fused_bodies.post(*args), lambda: step.post(*args))

    def onehot_pair(ms, code, nb):
        return (lambda: (fusedmap.fused_onehot_sum(ms, code, nb),),
                lambda: (fusedmap.onehot_sum_twin(ms, code, nb),))

    def bincounts(ms, code, nb):
        return [torch.bincount(code, weights=m, minlength=nb) for m in ms]

    return [
        Check("fused_map.prologue", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.prologue(*pro),
              lambda: step.prologue(*pro), 2, pro,
              library_note="none: no one call computes a fused body"),
        Check("fused_map.recv_front", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.recv_front(*rf),
              lambda: step.recv_front(*rf), 2, rf,
              library_note="none: no one call computes a fused body"),
        Check("fused_map.post", "cuda",
              "reina_tpu_torch/kernels/csrc/post.cu", f"{_FM}:191",
              lambda: fused_bodies.post(*po),
              lambda: step.post(*po), 0, po,
              library_note="none: no one call computes a fused body",
              # the rounding edge of the day counts, with a tail of 7
              extra=[post_pair(post_edge_args(n, seed, dev)),
                     post_pair(post_edge_args(n - 9, seed + 1, dev))]),
        Check("fused_map.finalize", "triton",
              "reina_tpu_torch/kernels/fused_bodies.py", f"{_FM}:191",
              lambda: fused_bodies.finalize(*fin),
              lambda: step.finalize(*fin), 2, fin,
              library_note="none: no one call computes a fused body"),
        Check("ledger_scan", "cuda", "reina_tpu_torch/kernels/csrc/ledger.cu",
              "reina_tpu/ops/clamped.py:159", *ledger_pair(s["offset"]),
              inputs=s["rel"] + s["req"] + [init],
              library_note="none: no one call computes the FCFS ledger",
              extra=[ledger_pair(0), ledger_pair(n - 1), ledger_pair(4096),
                     ledger_pair(n_odd - 1, rel=rel_odd, req=req_odd),
                     ledger_pair(n_odd // 2, rel=rel_odd, req=req_odd)]),
        Check("fused_concat_prefix", "cuda",
              "reina_tpu_torch/kernels/csrc/prefix.cu", f"{_FM}:553",
              lambda: (fusedmap.fused_concat_prefix(s["newly"], None, 1),
                       fusedmap.fused_concat_prefix(s["w"], codes, V)),
              lambda: (fusedmap.concat_prefix_twin(s["newly"], None, 1),
                       fusedmap.concat_prefix_twin(s["w"], codes, V)),
              inputs=[s["newly"], s["w"], codes],
              library=lambda: (torch.cumsum(s["newly"], 0),
                               torch.cumsum(cat, 0)),
              library_note="torch.cumsum of newly and of the materialised "
                           "concatenation (not bit-equal: another "
                           "association)",
              extra=[prefix_pair(f[0], None, 1, 16),
                     prefix_pair(f[0], codes, V, 16),
                     prefix_pair(w56, None, 1, 64),
                     prefix_pair(w56, codes56, V, 64)]),
        # the snapshot's call: 13 masks by the group code, sorted by age
        Check("fused_onehot_sum", "cuda",
              "reina_tpu_torch/kernels/csrc/onehot.cu", f"{_FM}:318",
              lambda: (fusedmap.fused_onehot_sum(masks, grp, G + 1),),
              lambda: (fusedmap.onehot_sum_twin(masks, grp, G + 1),),
              inputs=masks + [grp],
              library=lambda: bincounts(masks_f, grp_l, G + 1),
              library_note="torch.bincount(code, weights=mask) for each of "
                           "the 13 masks (float masks made beforehand)",
              # random codes; the vaccination call's shape, one
              # eligibility mask by age, sorted and shuffled
              extra=[onehot_pair(masks, s["code"], G + 1),
                     onehot_pair([elig], ages, A),
                     onehot_pair([elig], s["ages_random"], A)]),
        Check("fused_fn_onehot_sum", "cuda",
              "reina_tpu_torch/kernels/csrc/fn_onehot.cu", f"{_FM}:391",
              lambda: (fusedmap.fused_fn_onehot_sum(
                  fields, step._output_masks_reduced, 10, grp, G + 1),),
              lambda: (fusedmap.fn_onehot_sum_twin(
                  fields, step._output_masks_reduced, 10, grp, G + 1),),
              inputs=fields + [grp],
              library=lambda: bincounts(out_masks_f, grp_l, G + 1),
              library_note="torch.bincount(code, weights=mask) for each of "
                           "the 10 masks (masks made beforehand)",
              extra=[(lambda: (fusedmap.fused_fn_onehot_sum(
                          fields, step._output_masks_reduced, 10,
                          s["grp_random"], G + 1),),
                      lambda: (fusedmap.fn_onehot_sum_twin(
                          fields, step._output_masks_reduced, 10,
                          s["grp_random"], G + 1),))]),
        Check("fused_bihistogram", "cuda",
              "reina_tpu_torch/kernels/csrc/bihist.cu", f"{_FM}:641",
              lambda: (fusedmap.fused_bihistogram(vts, VTS, ks, ages, A,
                                                  gate=gate),),
              lambda: (fusedmap.bihistogram_twin(vts, VTS, ks, ages, A,
                                                 gate),),
              inputs=[gate, vts, ks, ages],
              # the gate for all; vts, k_s and age for the exposers only
              read_bytes=gate.numel() + 12 * exposers,
              library=lambda: torch.bincount(flat, weights=ks_f,
                                             minlength=VTS * A + 1),
              library_note="one torch.bincount(code_a * n_b + code_b, w) "
                           "(flat index and float weights made "
                           "beforehand, off-gate to one extra bin)",
              extra=[(lambda: (fusedmap.fused_bihistogram(
                          vts, VTS, ks, s["ages_random"], A, gate=gate),),
                      lambda: (fusedmap.bihistogram_twin(
                          vts, VTS, ks, s["ages_random"], A, gate),))]),
    ]


def _slabs(ts, k: int):
    """Each of the (n,) tensors ``ts`` cut into k contiguous slabs:
    [[t[slab j] for t in ts] for j < k]."""
    n = ts[0].shape[0] // k
    return [[None if t is None else t[j * n:(j + 1) * n] for t in ts]
            for j in range(k)]


def sharded_ledger(rel, req, init, offset, k: int, kernel: bool):
    """The sharded ledger over k slabs in one process, the slabs' folds
    exchanged by stacking: (grants of each ledger over all slabs, slab
    0's finals, every slab's finals (k, L))."""
    n, L = rel[0].shape[0], len(rel)
    nl = n // k
    parts = [(p[:L], p[L:]) for p in _slabs(list(rel) + list(req), k)]
    if kernel:
        folded = [clamped.ledger_fold_slab(r, q, offset, j * nl, n)
                  for j, (r, q) in enumerate(parts)]
        folds = torch.stack([f for f, _ in folded])
        outs = [clamped.ledger_emit_slab(r, q, init, offset, j * nl, folds, j,
                                         sc)
                for j, ((r, q), (_, sc)) in enumerate(zip(parts, folded))]
    else:
        folds = torch.stack([clamped.slab_folds_twin(r, q, offset, j * nl)
                             for j, (r, q) in enumerate(parts)])
        outs = [clamped.grants_twin_sharded(r, q, init, offset, j * nl,
                                            folds, j)
                for j, (r, q) in enumerate(parts)]
    return (tuple(torch.cat([g[led] for g, _ in outs]) for led in range(L))
            + (outs[0][1], torch.stack([f for _, f in outs])))


def sharded_prefix(w, codes, n_seg: int, k: int, kernel: bool,
                   rows: int = 2048):
    """The sharded prefix over k slabs in one process, the slabs'
    messages exchanged by stacking: (the (n_seg·N,) prefix in the
    unsharded order, every slab's segment ends (k, n_seg))."""
    n = w.shape[0]
    nl = n // k
    parts = _slabs([w, codes], k)
    if kernel:
        done = [fusedmap.prefix_row_totals(x, c, n_seg, j * nl // 128, n,
                                           rows)
                for j, (x, c) in enumerate(parts)]
        msgs = torch.stack([m for m, _ in done])
        outs = [fusedmap.prefix_emit_slab(x, c, n_seg, j * nl // 128, n,
                                          msgs, sc, rows)
                for j, ((x, c), (_, sc)) in enumerate(zip(parts, done))]
    else:
        msgs = torch.stack([fusedmap.row_totals_twin(x, c, n_seg,
                                                     j * nl // 128, n, rows)
                            for j, (x, c) in enumerate(parts)])
        outs = [fusedmap.concat_prefix_twin_sharded(x, c, n_seg,
                                                    j * nl // 128, n, msgs,
                                                    rows)
                for j, (x, c) in enumerate(parts)]
    out = torch.stack([o.reshape(n_seg, nl) for o, _ in outs], 1)
    return out.reshape(-1), torch.stack([e for _, e in outs])


def sharded_checks(n: int, seed: int, dev, k: int) -> List[Check]:
    """The ledger's and the prefix's sharded forms over k slabs (each
    slab in turn in one process): held to their sharded twins, and,
    through the extra pairs, to the unsharded kernels and twins, on
    :func:`checks`' inputs, at offsets 0, N - 1, inside the tile of slab
    0's end and random, and on prefix blocks that straddle slabs. The
    kernel's time is that of all k slabs in turn after one cold L2."""
    s = _streams(n, seed, dev)
    codes = s["var"].to(torch.int32)
    init = torch.tensor([300, 60], dtype=torch.int32, device=dev)
    rel, req = s["rel"], s["req"]
    nl = n // k

    def ledger(kernel, offset):
        return lambda: sharded_ledger(rel, req, init, offset, k, kernel)

    def vs_unsharded(offset, fn):
        def call():
            g, fin = fn(rel, req, init, offset)
            return tuple(g) + (fin, fin.expand(k, -1))
        return (ledger(True, offset), call)

    def prefix(kernel, w, c, n_seg, rows=2048):
        return lambda: sharded_prefix(w, c, n_seg, k, kernel, rows)

    def prefix_vs(w, c, n_seg, rows, fn):
        def call():
            out = fn(w, c, n_seg, rows)
            return out, out.reshape(n_seg, -1)[:, -1].expand(k, -1)
        return (prefix(True, w, c, n_seg, rows), call)

    # 21,504 agents in blocks of 56 rows (max_block_rows 64): the slab
    # edges at 84, 42 and 21 rows lie inside blocks
    r56 = np.random.default_rng(seed + 1)
    w56 = torch.from_numpy(r56.random(21504).astype(np.float32)).to(dev)
    c56 = torch.from_numpy(r56.integers(0, V, 21504).astype(np.int32)).to(dev)
    cat = torch.cat([torch.where(codes == v, s["w"], 0.0) for v in range(V)])
    ledger_extra = [vs_unsharded(s["offset"], clamped.clamped_counter_grants)]
    for off in (0, n - 1, nl - 7):
        ledger_extra += [(ledger(True, off), ledger(False, off)),
                         vs_unsharded(off, clamped.clamped_counter_grants),
                         vs_unsharded(off, clamped.grants_twin)]
    # the day's offset in device memory (a captured day's), on and across
    # the slab edges: the kernel's entries against the twins given the
    # same 0-d tensor and against the unsharded kernel given the int
    for off in (0, nl - 1, nl, nl + 1, n - 1, s["offset"]):
        dev_off = torch.tensor(off, dtype=torch.int32, device=dev)
        ledger_extra += [(ledger(True, dev_off), ledger(False, dev_off)),
                         (ledger(True, dev_off),
                          vs_unsharded(off, clamped.clamped_counter_grants)[1])]
    prefix_extra = []
    for w, c, n_seg, rows in ((s["newly"], None, 1, 2048),
                              (s["w"], codes, V, 2048),
                              (w56, None, 1, 64), (w56, c56, V, 64)):
        prefix_extra += [
            (prefix(True, w, c, n_seg, rows), prefix(False, w, c, n_seg, rows)),
            prefix_vs(w, c, n_seg, rows, fusedmap.fused_concat_prefix),
            prefix_vs(w, c, n_seg, rows, fusedmap.concat_prefix_twin)]
    return [
        Check("ledger_sharded", "cuda",
              "reina_tpu_torch/kernels/csrc/ledger.cu",
              "reina_tpu/ops/clamped.py:159", ledger(True, s["offset"]),
              ledger(False, s["offset"]), inputs=rel + req + [init],
              library_note="none: no one call computes the FCFS ledger",
              extra=ledger_extra),
        Check("concat_prefix_sharded", "cuda",
              "reina_tpu_torch/kernels/csrc/prefix.cu", f"{_FM}:553",
              lambda: (prefix(True, s["newly"], None, 1)()
                       + prefix(True, s["w"], codes, V)()),
              lambda: (prefix(False, s["newly"], None, 1)()
                       + prefix(False, s["w"], codes, V)()),
              inputs=[s["newly"], s["w"], codes],
              library=lambda: (torch.cumsum(s["newly"], 0),
                               torch.cumsum(cat, 0)),
              library_note="torch.cumsum of newly and of the materialised "
                           "concatenation over the whole axis",
              extra=prefix_extra),
        sharded_fold_check(n, seed, dev, k),
    ]


def sharded_ledger_offset_ms(n: int, seed: int, dev, k: int):
    """The sharded ledger's entries over k slabs (all in turn, as
    :func:`sharded_checks` times them) with the sweep's offset as a host
    int and as a 0-d int32 tensor that the launches read (a captured
    day's), timed host, device, device, host: (host ms, device ms), each
    the mean of its two medians (:func:`time_ms`)."""
    s = _streams(n, seed, dev)
    init = torch.tensor([300, 60], dtype=torch.int32, device=dev)
    off = s["offset"]
    dev_off = torch.tensor(off, dtype=torch.int32, device=dev)
    host, device = (lambda: sharded_ledger(s["rel"], s["req"], init, off, k,
                                           True),
                    lambda: sharded_ledger(s["rel"], s["req"], init, dev_off,
                                           k, True))
    t = [time_ms(f) for f in (host, device, device, host)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


class _Slab:
    """Slab ``index`` of ``k`` of an agent axis of ``n`` in one process:
    the shard a sharded entry takes, whose all-gather hands back the
    slabs' stacked messages (``gathered``)."""

    def __init__(self, n: int, k: int, index: int, gathered):
        self.n, self.k, self.index = n, k, index
        self.n_local = n // k
        self.lo = index * self.n_local
        self.gathered = gathered

    def all_gather(self, t):
        return self.gathered


def _sharded_fold_pair(name, counts, n, dev, k, w=None, seed=0, days=4,
                       day=2):
    """(kernel, twin): :func:`_fold_pair`'s prefix count ``name`` (n_new,
    n_d, n_f) on k slabs of the agent axis in one process, the slabs'
    messages exchanged by stacking: each slab's emit makes the count and
    the picks into tables of its own (each rank's), as
    ``fusedmap.sharded_prefix_count`` under a fold site; the twin is the
    sharded twin, then the picks' twin. Each returns the slabs' prefixes
    in the unsharded order, then for every slab the count, the day's
    picks row, the tallies and the problem bits (the same inputs as
    ``_fold_pair(name, counts, n, dev, w, seed)``)."""
    from ..core import daygraph
    cfg = step.EngineConfig()
    nodes = daygraph.fold_nodes(cfg, name)
    if w is None:
        g = torch.Generator(device="cpu").manual_seed(seed)
        w = torch.zeros(n, dtype=torch.float32)
        w[torch.randperm(n, generator=g)[:counts[name]]] = 1.0
        w = w.to(dev)
    given = {c: torch.tensor(v, dtype=torch.int32, device=dev)
             for c, v in counts.items() if c != name}
    nl = n // k
    parts = [w[j * nl:(j + 1) * nl] for j in range(k)]

    def side(kernel):
        def run():
            tot = torch.stack([fusedmap.prefix_row_totals(
                                   x, None, 1, j * nl // 128, n)[0]
                               if kernel and x.is_cuda else
                               fusedmap.row_totals_twin(
                                   x, None, 1, j * nl // 128, n)
                               for j, x in enumerate(parts)])
            cums, rest = [], []
            for j, x in enumerate(parts):
                table = torch.full((days, len(step.PICK_COLS)), -1,
                                   dtype=torch.int32, device=dev)
                tallies = [torch.zeros(2 if isinstance(nd, step.If)
                                       else len(nd.keys()),
                                       dtype=torch.int32, device=dev)
                           for nd in nodes]
                problem = torch.full((), 4, dtype=torch.int32, device=dev)
                counter = torch.full((), day, dtype=torch.int64, device=dev)
                fold = daygraph.Fold(
                    nodes, [step.PICK_COLS.index(nd.name) for nd in nodes],
                    tallies, table, counter, problem,
                    lookup=lambda p: given[p.src])
                slab = _Slab(n, k, j, tot)
                if kernel:
                    cum, cnt = fusedmap.sharded_prefix_count(
                        x, slab, name, given, site=fold)
                else:
                    cum, ends = fusedmap.concat_prefix_twin_sharded(
                        x, None, 1, slab.lo // fusedmap.LANE, n, tot)
                    cnt = ends[0].to(torch.int32)
                    fold.twin({name: cnt, **given})
                cums.append(cum)
                rest += [cnt, table[day], *tallies, problem]
            return (torch.cat(cums), *rest)
        return run

    return side(True), side(False)


def sharded_fold_check(n: int, seed: int, dev, k: int) -> Check:
    """The sharded prefix's emit with its count and picks
    (``fusedmap.sharded_prefix_count`` under a fold site) over k slabs:
    against the sharded twin and the picks' twin, and against the
    unsharded prefix with its count and picks (each slab's tables equal
    the one card's), at every branch of every prefix fold's picks and
    past each cap (``fold_cases``), exact. Timed: the slot pick of the
    checks' ``newly`` stream, all k slabs in turn."""
    cfg = step.EngineConfig()
    s = _streams(n, seed, dev)
    extra = []
    for i, (name, counts) in enumerate(fold_cases(cfg, n)):
        if name.startswith("fill"):
            continue
        kern, twin = _sharded_fold_pair(name, counts, n, dev, k,
                                        seed=seed + i)
        one = _fold_pair(name, counts, n, dev, seed=seed + i)[0]

        def unsharded(one=one):
            got = one()
            return (got[0],) + tuple(got[1:]) * k
        extra += [(kern, twin), (kern, unsharded)]
    newly = s["newly"]
    return Check("concat_prefix_sharded.pick", "cuda",
                 "reina_tpu_torch/kernels/csrc/prefix.cu", f"{_FM}:553",
                 *_sharded_fold_pair("n_new", {"n_new": int(newly.sum())},
                                     n, dev, k, w=newly),
                 inputs=[newly],
                 library_note="none: a conditional node is set from a "
                              "kernel only",
                 # every slab reads the newly stream's slab and writes its
                 # prefix; each slab writes its count, picks and tally
                 # entries and reads the count and the day counter
                 read_bytes=4 * n + 12 * k, write_bytes=4 * n + 12 * k,
                 extra=extra)


# ---------------------------------------------------------------------------
# the day's draws and samplers (csrc/threefry.cu, csrc/samplers.cu)

_DRAW_NOTE = ("none: torch.rand is Philox and torch.binomial another "
              "algorithm, so no one call computes the same function")


def binomial_int_ops(n, p) -> int:
    """INT32 operations of the first-round hashes of binomial_fixed on
    lanes n, p: one a lane for the inversion (n·p_eff <= 10), none where
    n or p_eff is 0 there (settled without a draw), two a lane for
    BTRS."""
    n = n.to(torch.float32)
    p = torch.clamp(p.to(torch.float32), 0.0, 1.0)
    p_eff = torch.where(p > 0.5, 1.0 - p, p)
    small_m = n * p_eff <= 10.0
    small = int(small_m.sum())
    drawn = int((small_m & (n != 0) & (p_eff != 0)).sum())
    return HASH_OPS * (drawn + 2 * (n.numel() - small))


@contextmanager
def _recording(module, name: str, keep):
    """module.name's calls append their arguments to ``keep`` meanwhile."""
    fn = getattr(module, name)

    def record(*args, **kwargs):
        keep.append(args)
        return fn(*args, **kwargs)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, fn)


def capture_samplers(run, day: int) -> dict:
    """The arguments of the day step's sampler calls on ``day`` of
    ``run`` (run_days to that day): ``binomial`` the (n, p) of its two
    binomial_fixed calls, the darts' (A, V, T, S, B) and the per-place
    exposures' (A, P), flattened; ``gamma`` the (kappa1, kappa2, shape)
    of its gamma_fixed_pair call."""
    from ..core.engine import run_days
    binom, gamma = deque(maxlen=2), deque(maxlen=1)
    with _recording(step, "binomial_fixed", binom), \
            _recording(step, "gamma_fixed_pair", gamma):
        # the plain day step: a replayed graph calls no Python
        run_days(run, n_days=day + 1, chunk_days=day + 1, graphs=False)
    (_, kappa1, _, kappa2, shape, *_), = gamma
    return {"binomial": [(a[1], a[2]) for a in binom],
            "gamma": (kappa1, kappa2, tuple(shape))}


def _binomial_cases(seed: int, dev):
    """(n, p) lanes of the day step's kinds and edges: darts-like (many
    n = 0, small p), n·p on both sides of 10 and at 10, p above 0.5, p
    at 0, 0.5 and 1, large n, NaN p; 76,356 lanes, the darts' shape
    (A, V, T, S, B) at this module's B = 9 bands (HUS has 15)."""
    r = np.random.default_rng(seed)
    k = A * V * T * 2 * B
    n = np.floor(r.random(k) ** 3 * 3000)
    n[r.random(k) < 0.4] = 0
    p = r.random(k) ** 3 * 0.2
    sel = r.random(k) < 0.1                      # p above 0.5
    p[sel] = 0.5 + r.random(int(sel.sum())) * 0.5
    sel = r.random(k) < 0.1                      # n·p near 10
    n[sel] = np.floor(10 + r.random(int(sel.sum())) * 90)
    p[sel] = 10.0 / n[sel] * r.uniform(0.9, 1.1, int(sel.sum()))
    edge_n = [0, 0, 20, 20, 40, 12, 1e5, 3e5, 50, 50, 7, 7, 1, 1, 1000, 2000]
    edge_p = [0.3, 0.9, 0.5, 0.25, 0.75, 1.0, 1e-4, 0.5, 0, 1, 0.5, 0.99,
              0.5, np.nan, np.nan, 0.6]
    n[:16], p[:16] = edge_n, edge_p

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    return t(n), t(p)


def binomial_edges(dev):
    """(n, p) lanes at binomial_fixed's edges, 4 CTAs of the kernel
    mixing them: n = 0 (with p 0, 0.3, 0.7, 1 and NaN), a mean of
    exactly 10.0 (n·p_eff, also after the flip), p > 0.5 (the flip) on
    both sides of 10, p_eff = 0 (p 0 and 1), a NaN mean (NaN p, inf n at
    p 0), large n, and lanes whose counts come near the inversion's
    horizon of 48."""
    nan, inf = np.nan, np.inf
    edges = [
        (0, 0.0), (0, 0.3), (0, 0.7), (0, 1.0), (0, nan),
        (20, 0.5), (40, 0.25), (80, 0.125), (160, 0.0625), (1000, 0.01),
        (20, 0.5), (40, 0.75), (80, 0.875), (10, 1.0), (10, 0.0),
        (21, 0.5), (19, 0.5), (30, 0.7), (30, 0.6), (200, 0.96),
        (5, nan), (12, 0.9), (inf, 0.0), (3, 0.5), (1e7, 1e-6),
        (3e5, 0.5), (1e5, 1e-4), (48, 0.2), (60, 0.16), (100, 0.1),
        (2000, 0.005), (7, 0.99)]
    perm = np.random.default_rng(13).permutation(16 * len(edges))
    n = np.tile([e[0] for e in edges], 16)[perm]
    p = np.tile([e[1] for e in edges], 16)[perm]

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    return t(n), t(p)


def gamma_edges(seed: int, dev) -> list:
    """(kernel, twin) pairs of gamma_fixed and gamma_fixed_pair at their
    edges: one round at a kappa near 1, where many lanes reject every
    round and take kappa; 2, 3, 5 and 8 rounds (groups of 2, 4 and 8
    threads a lane); lane counts that are no multiple of a group, a warp
    or a CTA; keys by value and in device memory for each sample."""
    keys = prng.split(prng.PRNGKey(seed + 29), 4)

    def pair(k1, kap1, k2, kap2, shape, rounds):
        return (lambda: samplers.gamma_fixed_pair(k1, kap1, k2, kap2, shape,
                                                  dev, rounds),
                lambda: (samplers.gamma_fixed_twin(prng.host_key(k1), kap1,
                                                   shape, dev, rounds),
                         samplers.gamma_fixed_twin(prng.host_key(k2), kap2,
                                                   shape, dev, rounds)))

    def one(k, kappa, shape, rounds):
        return (lambda: (samplers.gamma_fixed(k, kappa, shape, dev,
                                              rounds),),
                lambda: (samplers.gamma_fixed_twin(prng.host_key(k), kappa,
                                                   shape, dev, rounds),))

    dk = samplers.dev_key(keys[2], dev, samplers.gamma_words, 1)
    return [pair(keys[0], 1.01, keys[1], 1.2, (4097,), 1),
            pair(dk, 1.01, keys[1], 1.05, (33,), 1),
            one(keys[0], 1.01, (100003,), 1),
            one(keys[1], 1.5, (777,), 2), one(keys[2], 1.5, (31, 3), 3),
            pair(keys[3], 2.5, keys[0], 9.0, (1025,), 5),
            one(keys[1], 1.1, (4608,), 8), one(keys[3], 3.0, (1,), 4)]


def dev_key_pairs(seed: int, dev, n: int = HUS_N) -> list:
    """(name, kernel, twin) triples of the draw and sampler kernels
    given their keys in device memory (prng.DevKey, as the day step's
    key table gives them), each against its twin on the host key, at the
    day step's kinds of calls for ``n`` agents."""
    from ..core import constants as C
    keys = prng.split(prng.PRNGKey(seed + 19), 7)
    N, half = n, n // 2
    dk = [prng.dev_key(k, dev) for k in keys[:4]]
    gk, gk2 = (samplers.dev_key(k, dev, samplers.gamma_words,
                                step.GAMMA_ROUNDS) for k in keys[4:6])
    bk = samplers.dev_key(keys[6], dev, samplers.binomial_words,
                          step.BINOMIAL_ROUNDS)
    n_b, p_b = _binomial_cases(seed, dev)

    def pair(name, fn, twin, key, *args, **kw):
        return (name, lambda: (fn(key, *args, **kw),),
                lambda: (twin(prng.host_key(key), *args, **kw),))

    kappa = 1.0 / C.INCUBATION_CV ** 2
    kappa2 = 1.0 / C.ONSET_TO_REMOVED_CV ** 2
    return [
        pair("uniform", prng.uniform, prng.uniform_twin, dk[0], (N,), dev),
        pair("uniform slab", prng.uniform, prng.uniform_twin, dk[0],
             (N - half,), dev, start=half),
        pair("normal slab", prng.normal, prng.normal_twin, dk[1],
             (N - half,), dev, start=half),
        pair("bits 2-D", prng.random_bits, prng.random_bits_twin, dk[2],
             (4608, 12), dev),
        pair("gumbel", prng.gumbel, prng.gumbel_twin, dk[3], (4608, A), dev),
        pair("gamma", samplers.gamma_fixed, samplers.gamma_fixed_twin, gk,
             kappa, (4608,), dev, step.GAMMA_ROUNDS),
        ("gamma pair", lambda: samplers.gamma_fixed_pair(
            gk, kappa, gk2, kappa2, (4608,), dev, step.GAMMA_ROUNDS),
         lambda: tuple(samplers.gamma_fixed_twin(
             prng.host_key(k), kap, (4608,), dev, step.GAMMA_ROUNDS)
             for k, kap in ((gk, kappa), (gk2, kappa2)))),
        ("binomial", lambda: (samplers.binomial_fixed(
            bk, n_b, p_b, step.BINOMIAL_ROUNDS),),
         lambda: (samplers.binomial_fixed_twin(
             prng.host_key(bk), n_b, p_b, step.BINOMIAL_ROUNDS),)),
    ]


def draw_checks(seed: int, dev, captured=None,
                n: int = HUS_N) -> List[Check]:
    """The draw kernel at the day step's shapes for N = ``n`` agents (a
    1-D uniform of N timed; normal and bits of N, each from start 0 and
    from the second slab's start N/2, odd sizes and starts, a uniform
    from 1e-37, the tracing tables' 2-D shapes, the imports' 3-D one,
    gumbel of (m, 101)); gamma_fixed_pair at ``captured``'s call of a
    run (timed; the day step's two kappas at 4,608 lanes without it),
    gamma_fixed and the pair at every slot tier for both kappas and at
    their edges (gamma_edges); binomial_fixed at ``captured``'s inputs
    of a run (capture_samplers; made up at the darts' shape without it),
    made-up lanes and edges (binomial_edges). Each against its twin on
    the same device."""
    from ..core import constants as C
    keys = prng.split(prng.PRNGKey(seed + 9), 12)
    N, half = n, n // 2

    def pair(fn, twin, *args, **kw):
        return (lambda: (fn(*args, **kw),), lambda: (twin(*args, **kw),))

    def uni(key, shape, *a, **kw):
        return pair(prng.uniform, prng.uniform_twin, key, shape, dev, *a,
                    **kw)

    draws = [
        pair(prng.normal, prng.normal_twin, keys[1], (N,), dev),
        pair(prng.random_bits, prng.random_bits_twin, keys[2], (N,), dev),
        uni(keys[0], (N - half,), start=half),
        pair(prng.normal, prng.normal_twin, keys[1], (N - half,), dev,
             start=half),
        pair(prng.random_bits, prng.random_bits_twin, keys[2], (N - half,),
             dev, start=half),
        uni(keys[3], (N - 3,), start=3), uni(keys[3], (7,), start=5),
        uni(keys[4], (N,), 1e-37),
        uni(keys[5], (4608, 12)), uni(keys[5], (513, 5)),
        uni(keys[6], (512, 10, 2)),
        pair(prng.gumbel, prng.gumbel_twin, keys[7], (4608, A), dev),
        pair(prng.gumbel, prng.gumbel_twin, keys[7], (13, A), dev),
    ]
    # the same kernels with their keys in device memory
    by_kernel = {"gamma": [], "binomial": []}
    for name, k, t in dev_key_pairs(seed, dev, n):
        by_kernel.get(name.split()[0], draws).append((k, t))
    kappas = (1.0 / C.INCUBATION_CV ** 2, 1.0 / C.ONSET_TO_REMOVED_CV ** 2)
    ends = [lo + seg for lo, seg in step.tier_bounds(512, 65536)]

    def gamma_pair(kappa1, kappa2, shape):
        return (lambda: samplers.gamma_fixed_pair(
                    keys[9], kappa1, keys[8], kappa2, shape, dev),
                lambda: (samplers.gamma_fixed_twin(keys[9], kappa1, shape,
                                                   dev),
                         samplers.gamma_fixed_twin(keys[8], kappa2, shape,
                                                   dev)))

    gamma = ([pair(samplers.gamma_fixed, samplers.gamma_fixed_twin, keys[8],
                   kappa, (e,), dev) for e in ends for kappa in kappas]
             + [gamma_pair(*kappas, (e,)) for e in ends]
             + gamma_edges(seed, dev))
    g_kappa1, g_kappa2, g_shape = (captured["gamma"] if captured
                                   else (*kappas, (4608,)))
    if captured:
        (n_b, p_b), (n_x, p_x) = captured["binomial"]
    else:
        n_b, p_b = _binomial_cases(seed, dev)
        n_x, p_x = n_b[:A * 6].clone(), p_b[:A * 6].clone()
    n_e, p_e = _binomial_cases(seed + 1, dev)

    def binom(k, n, p):
        return pair(samplers.binomial_fixed, samplers.binomial_fixed_twin,
                    k, n, p)

    return [
        Check("prng.draw", "cuda", "reina_tpu_torch/kernels/csrc/threefry.cu",
              f"{_STEP}:1106", *uni(keys[0], (N,)), n=N,
              library_note=_DRAW_NOTE, extra=draws),
        Check("random.gamma_fixed", "cuda",
              "reina_tpu_torch/kernels/csrc/samplers.cu", f"{_RND}:29",
              *gamma_pair(g_kappa1, g_kappa2, g_shape),
              n=2 * math.prod(g_shape), library_note=_DRAW_NOTE,
              extra=gamma + by_kernel["gamma"]),
        Check("random.binomial_fixed", "cuda",
              "reina_tpu_torch/kernels/csrc/samplers.cu", f"{_RND}:159",
              *binom(keys[10], n_b, p_b), inputs=[n_b, p_b],
              int_ops=binomial_int_ops(n_b, p_b),
              library_note=_DRAW_NOTE,
              extra=[binom(keys[11], n_x, p_x), binom(keys[10], n_e, p_e),
                     binom(keys[11], n_e[:7], p_e[:7]),
                     binom(keys[11], *binomial_edges(dev))]
              + by_kernel["binomial"]),
    ]


# ---------------------------------------------------------------------------
# the day graph's tier picks, each folded into the launch that produces
# its count (csrc/pick.cuh; core/daygraph.py:FOLDS)

def fold_cases(cfg, n: int):
    """(fold name, {count: value}) at every branch of every pick of each
    fold of a tracing day's program and past each cap: each count at 0,
    1, each ceiling and the one above it, its cap + 1 and 10^6 (a count a
    prefix makes at most ``n``, its agents)."""
    from ..core import daygraph
    cases = []

    def edges(p):
        xs = {0, 1, p.cap + 1 if p.cap is not None else p.ends[-1] + 1,
              10 ** 6}
        for e in p.ends:
            xs |= {e, e + 1}
        return sorted(xs)

    for name in daygraph.FOLDS:
        first = {}
        for node in daygraph.fold_nodes(cfg, name):
            for p in node.picks:
                first.setdefault(p.src, p)
        srcs = list(first)
        combos = [{}]
        for src in srcs:
            xs = [x for x in edges(first[src])
                  if src != name or name.startswith("fill") or x <= n]
            combos = [{**c, src: x} for c in combos for x in xs]
        cases.extend((name, c) for c in combos)
    return cases


def _fold_pair(name, counts, n, dev, w=None, seed=0, days=4, day=2):
    """(kernel, twin): the producer of count ``name`` with its fold, made
    to produce ``counts[name]`` (a prefix over a 0/1 mask of ``n``
    agents with that many set at random, or a maximum over ``n`` fill
    values), the other counts given; each side into tables of its own on
    ``dev`` made here. Each returns the producer's outputs, the day's
    picks row, the picks' tallies and the problem bits, as one call
    leaves them. ``w``: the prefix's weights instead of a mask."""
    from ..core import daygraph
    from ..ops import compact
    cfg = step.EngineConfig()
    nodes = daygraph.fold_nodes(cfg, name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = counts[name]
    if name.startswith("fill"):
        vals = torch.randint(0, max(x, 1), (n,), generator=g,
                             dtype=torch.int32)
        vals[int(torch.randint(0, n, (1,), generator=g))] = x
        vals = vals.to(dev)
    elif w is None:
        w = torch.zeros(n, dtype=torch.float32)
        w[torch.randperm(n, generator=g)[:x]] = 1.0
        w = w.to(dev)
    given = {k: torch.tensor(v, dtype=torch.int32, device=dev)
             for k, v in counts.items() if k != name}

    def side(kernel):
        table = torch.full((days, len(step.PICK_COLS)), -1,
                           dtype=torch.int32, device=dev)
        tallies = [torch.zeros(2 if isinstance(nd, step.If)
                               else len(nd.keys()), dtype=torch.int32,
                               device=dev) for nd in nodes]
        problem = torch.full((), 4, dtype=torch.int32, device=dev)
        counter = torch.full((), day, dtype=torch.int64, device=dev)
        fold = daygraph.Fold(
            nodes, [step.PICK_COLS.index(nd.name) for nd in nodes], tallies,
            table, counter, problem, lookup=lambda p: given[p.src])

        def run():
            if name.startswith("fill"):
                if kernel:
                    out = (compact.count_max(vals, name, site=fold),)
                else:
                    m = vals.max()
                    fold.twin({name: m})
                    out = (m,)
            elif kernel:
                out = fusedmap.prefix_count(w, name, given, site=fold)
            else:
                cum = fusedmap.concat_prefix_twin(w, None, 1)
                cnt = cum[-1].to(torch.int32)
                fold.twin({name: cnt, **given})
                out = (cum, cnt)
            return (*out, table[day], *tallies, problem)
        return run

    return side(True), side(False)


# the tier each timed fused entry is timed at: a day's slot pick of
# 4,000 new infections on the checks' newly stream's agents; T2's pick
# of 1,000 drained agents over the bucket fills of 1,536 members
FILL_MEMBERS, FILL_N_D = 1536, 1000


def fold_checks(n: int, seed: int, dev) -> List[Check]:
    """The fused tier picks against their twins (the producer's twin,
    then daygraph.pick_twin) at every branch of every pick and past each
    cap (``fold_cases``), exact: the producer's outputs, the picks row,
    the tallies and the problem bits. Timed: the prefix of the checks'
    ``newly`` stream with the slot pick, and T2's reduce-and-pick."""
    cfg = step.EngineConfig()
    s = _streams(n, seed, dev)
    pre, mx = [], []
    for i, (name, counts) in enumerate(fold_cases(cfg, n)):
        pair = _fold_pair(name, counts, FILL_MEMBERS if name.startswith(
            "fill") else n, dev, seed=seed + i)
        (mx if name.startswith("fill") else pre).append(pair)
    note = "none: a conditional node is set from a kernel only"
    newly = s["newly"]
    return [
        Check("fused_concat_prefix.pick", "cuda",
              "reina_tpu_torch/kernels/csrc/prefix.cu",
              f"{_FM}:553",
              *_fold_pair("n_new", {"n_new": int(newly.sum())}, n, dev,
                          w=newly),
              inputs=[newly], library_note=note,
              # the newly stream, its prefix and its count; the pick
              # reads the count and the day counter (12 B) and writes
              # its picks entry and tally entry (8 B)
              read_bytes=4 * n + 12, write_bytes=4 * n + 4 + 8, extra=pre),
        Check("daygraph.max_pick", "cuda",
              "reina_tpu_torch/kernels/csrc/daygraph.cu",
              f"{_STEP}:912",
              *_fold_pair("fill_max", {"n_d": FILL_N_D, "fill_max": 37},
                          FILL_MEMBERS, dev, seed=seed),
              n=FILL_MEMBERS, library_note=note,
              # the fills and n_d, the day counter; the maximum, the
              # picks entry and the tally entry
              read_bytes=4 * FILL_MEMBERS + 4 + 8 + 4, write_bytes=4 + 8,
              extra=mx),
    ]


def compare(got, want, float_ulp: int):
    """(mismatches, max_abs_err, max_ulp) over paired outputs."""
    mism, err, ulp = 0, 0.0, 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (
            g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype == torch.float32:
            d = (g.view(torch.int32).to(torch.int64)
                 - w.view(torch.int32).to(torch.int64)).abs()
            u = int(d.max()) if d.numel() else 0
            ulp = max(ulp, u)
            mism += int((d > float_ulp).sum())
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            ne = g != w
            mism += int(ne.sum())
            if ne.any():
                err = max(err, float((g.to(torch.float64)
                                      - w.to(torch.float64)).abs().max()))
    return mism, err, ulp


_flush = None


def _cold() -> None:
    """A device-side sleep for the host to enqueue behind, then an L2
    flush (64 MiB written)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    torch.cuda._sleep(4_000_000)     # ~2 ms at the H100's boost clock
    _flush.fill_(1)


def _events(k: int):
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(k)]
    for e in evs:
        e.record()                   # creates the CUDA event
    return evs


def time_ms(fn, repeats: int = 7) -> float:
    """Median device time of ``repeats`` single calls, each with a cold
    L2 and behind a device-side sleep (see the module docstring)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a, b = _events(2)
        _cold()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launch_times(n: int, seed: int, dev, repeats: int = 7) -> dict:
    """{call: [ms of each launch]}: the median device time of each launch
    of the prefix kernel (one; the day step's n_seg 1 and n_seg 2 calls
    apart), of the ledger kernel (three) and of the phase-7 count, 2-D
    histogram, post body and one-hot kernels (one each, at the day step's
    and the snapshot's calls), on
    :func:`checks`' inputs, between the CUDA events their entry points
    record around each launch, cold L2 before each call as in
    :func:`time_ms`."""
    s = _streams(n, seed, dev)
    codes = s["var"].to(torch.int32)
    init = torch.tensor([300, 60], dtype=torch.int32, device=dev)
    calls = {
        "fused_concat_prefix n_seg 1": (1, lambda ev: fusedmap.
                                        fused_concat_prefix(
                                            s["newly"], None, 1, events=ev)),
        "fused_concat_prefix n_seg 2": (1, lambda ev: fusedmap.
                                        fused_concat_prefix(
                                            s["w"], codes, V, events=ev)),
        "ledger_scan": (3, lambda ev: clamped.ledger_grants(
            s["rel"], s["req"], init, s["offset"], events=ev)),
        "fused_fn_onehot_sum": (1, lambda ev: fusedmap.fused_fn_onehot_sum(
            s["fields"], step._output_masks_reduced, 10, s["grp"], G + 1,
            events=ev)),
        "fused_bihistogram": (1, lambda ev: fusedmap.fused_bihistogram(
            s["vts"], VTS, s["k_s"], s["ages"], A, gate=s["gate"],
            events=ev)),
        "fused_map.post": (1, lambda ev: fused_bodies.post(*post_args(s),
                                                           events=ev)),
        "fused_onehot_sum": (1, lambda ev: fusedmap.fused_onehot_sum(
            s["b"][:13], s["grp"], G + 1, events=ev)),
    }
    out = {}
    for name, (k, fn) in calls.items():
        evs = _events(k + 1)
        for _ in range(2):
            fn(evs)
        torch.cuda.synchronize()
        per = [[] for _ in range(k)]
        for _ in range(repeats):
            _cold()
            fn(evs)
            torch.cuda.synchronize()
            for j in range(k):
                per[j].append(evs[j].elapsed_time(evs[j + 1]))
        out[name] = [float(np.median(p)) for p in per]
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_ms(c: Check, outputs, n: int):
    """(least time in ms, "bytes" or "operations") for the function of
    ``c`` on its inputs, given the outputs it wrote."""
    moved = ((c.read_bytes if c.read_bytes is not None
              else _nbytes(c.inputs))
             + (c.write_bytes if c.write_bytes is not None
                else _nbytes(outputs)))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    if c.name in INT32_BOUND:
        ops = (c.int_ops if c.int_ops is not None
               else OPS_PER_AGENT[c.name] * n)
        t_ops = ops / int32_ops_per_s() * 1e3
    else:
        t_ops = OPS_PER_AGENT[c.name] * n / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_check(c: Check, timing: bool = True) -> Result:
    got = c.kernel()
    want = c.twin()
    pairs = [(got, want)] + [(k(), t()) for k, t in c.extra]
    torch.cuda.synchronize()
    mism, err, ulp = 0, 0.0, 0
    for g, w in pairs:
        m, e, u = compare(g, w, c.float_ulp)
        mism, err, ulp = mism + m, max(err, e), max(ulp, u)
    bms, by = bound_ms(c, want, c.n if c.n is not None
                       else c.inputs[0].numel())
    nan = float("nan")
    ms = time_ms(c.kernel) if timing else nan
    plain = time_ms(c.twin) if timing else nan
    lib = (time_ms(c.library) if timing else nan) if c.library else None
    return Result(c.name, mism == 0, mism, err, ulp, ms, plain, lib, bms, by)
