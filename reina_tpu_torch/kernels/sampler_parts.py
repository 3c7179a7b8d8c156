"""Design variants of the two samplers, timed on one card at the day
step's calls.

    python -m reina_tpu_torch.kernels.sampler_parts

Each variant is built from this checkout's ``samplers.cu`` (nvcc,
sm_90a) into ``build/reina_tpu_torch/parts/`` and launched as the day
step launches it, keys in device memory. Times are ``checks.time_ms``
(cold L2, median of 7).

gamma_fixed, both samples of a day (the incubation and the
onset-to-removed kappas, 4 rounds) in one launch, at the slot tiers of
HUS (4,608 lanes) and Varsinais-Suomi (1,536), and at the largest tier
(65,536):

  groups        the kernel as it is: a group of 4 threads a lane, one
                round each, the first accepting round taken by ballot;
                CTAs of 128
  lane          a thread a lane running its rounds in turn until one
                accepts, in CTAs of 64 (2·4,608 lanes: 144 CTAs)

binomial_fixed at day 100's two calls of the HUS run (the darts and the
per-place exposures, ``checks.capture_samplers``):

  partition     the kernel as it is: each CTA's lanes laid out by
                branch, a thread a lane, BTRS's rounds in turn
  groups        the same, but each BTRS lane a group of 8 threads, a
                round each, in the warps the inversion leaves free
  no_btrs       BTRS lanes count 0 (wrong on purpose: the cost of
  no_inversion  inversion lanes count 0   the part cut)

Each line also says whether the variant's samples equal the twin's bit
for bit. Beside them: a one-element fill, the floor of this timing for
any launch. Needs a CUDA device.
"""
from __future__ import annotations

import re
import subprocess

import torch

from . import build, checks

# design (a): a thread a lane, its rounds in turn
_LANE_KERNEL = '''__global__ void __launch_bounds__(GAMMA_THREADS)
    gamma_kernel(const __grid_constant__ GammaArgs a) {
  const GammaSample& s = a.s[blockIdx.y];
  const long long i = (long long)blockIdx.x * GAMMA_THREADS + threadIdx.x;
  if (i >= a.n) return;
  const GammaKeys* k = s.dev != nullptr ? s.dev : &s.keys;
  float res = s.kappa, dv;
  for (int r = 0; r < a.rounds; ++r)
    if (gamma_round(k, r, (uint32_t)i, s, a.af, &dv)) {
      res = dv;
      break;
    }
  a.out[blockIdx.y * a.n + i] = res;
}
'''


# binomial: each BTRS lane a group of threads, a round each
_BTRS_GROUPS = '''  __syncthreads();
  const BinomialKeys& keys = a.dev != nullptr ? *a.dev : a.keys;
  if (tid < n_inv) {
    const int j = lane_at[tid];
    const Lane l(n_of[j], p_of[j]);
    a.out[base + j] = l.out(
        inversion(keys.inv, (uint32_t)(base + j), l.n, l.p_eff, a.af));
  }
  int shift = 0;
  while ((1 << shift) < a.rounds) ++shift;
  const int width = 1 << shift;
  const int w0 = min((n_inv + 31) / 32, WARPS - 1);
  if (warp < w0) return;
  for (int at = (warp - w0) * 32; at < (n_btrs << shift);
       at += (WARPS - w0) * 32) {
    const int g = (at + wl) >> shift, r = (at + wl) & (width - 1);
    const bool live = g < n_btrs;
    const int j = live ? lane_at[n_inv + g] : 0;
    const uint32_t ctr = (uint32_t)(base + j);
    const Lane l(n_of[j], p_of[j]);
    const bool big_m = l.mean > 10.0f;
    const Btrs s(big_m ? l.n : 100.0f, big_m ? l.p_eff : 0.2f);
    float k = 0.0f;
    const bool ok = live && r < a.rounds &&
                    s.round(reina_rng::bits(keys.u[r], ctr),
                            reina_rng::bits(keys.v[r], ctr), a.af, &k);
    const unsigned vote = __ballot_sync(0xffffffffu, ok);
    const unsigned group =
        (vote >> (wl & ~(width - 1))) & ((1u << width) - 1);
    const int first = group != 0 ? __ffs(group) - 1 : 0;
    if (live && r == first)
      a.out[base + j] = l.out(group != 0 ? k : s.fallback());
  }
}
'''


def _variants():
    src = (build.CSRC / "samplers.cu").read_text()
    kernel = re.search(r"__global__ void __launch_bounds__\(GAMMA_THREADS\)"
                       r".*?\n}\n", src, re.S).group(0)
    tail = re.search(r"  __syncthreads\(\);\n  if \(tid >= n_inv \+ n_btrs\)"
                     r".*?\n}\n", src, re.S).group(0)
    return {("gamma", "groups"): (),
            ("gamma", "lane"): (
                (kernel, _LANE_KERNEL),
                ("constexpr int GAMMA_THREADS = 128;",
                 "constexpr int GAMMA_THREADS = 64;"),
                ("  while ((1 << a.shift) < rounds) ++a.shift;\n", "")),
            ("binomial", "partition"): (),
            ("binomial", "groups"): ((tail, _BTRS_GROUPS),),
            ("binomial", "no_btrs"): (
                ("    cnt = btrs(keys, a.rounds, ctr, big_m ? l.n : 100.0f,\n"
                 "               big_m ? l.p_eff : 0.2f, a.af);\n",
                 "    (void)big_m;\n    cnt = 0.0f;\n"),),
            ("binomial", "no_inversion"): (
                ("    cnt = inversion(keys.inv, ctr, l.n, l.p_eff, a.af);\n",
                 "    cnt = 0.0f;\n"),)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..config.variables import VARIABLE_DEFAULTS
    from ..core import constants as C
    from ..core import step
    from ..core.engine import build_run
    from ..ops import prng
    from ..ops import random as samplers
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    run = build_run(dict(VARIABLE_DEFAULTS, simulation_days=365), "cuda")
    calls = checks.capture_samplers(run, 100)["binomial"]
    del run
    g_rounds, b_rounds = step.GAMMA_ROUNDS, step.BINOMIAL_ROUNDS
    kappas = (1.0 / C.INCUBATION_CV ** 2, 1.0 / C.ONSET_TO_REMOVED_CV ** 2)
    keys = [samplers.dev_key(k, "cuda", samplers.gamma_words, g_rounds)
            for k in prng.split(prng.PRNGKey(5), 2)]
    kb = samplers.dev_key(prng.PRNGKey(6), "cuda", samplers.binomial_words,
                          b_rounds)
    stream = torch.cuda.current_stream().cuda_stream
    for (kernel, name), cuts in _variants().items():
        entry = f"reina_{kernel}_fixed"
        fn = build.build_variant("samplers.cu", entry, f"{kernel}_{name}",
                                 cuts)
        if kernel == "gamma":
            cases = []
            for n in (4608, 1536, 65536):
                out = torch.empty((2, n), dtype=torch.float32, device="cuda")
                words, devs, dck = samplers.gamma_args(
                    list(zip(keys, kappas)), g_rounds, out.device, name)
                cases.append((f"n={n}", out, lambda out=out, n=n, w=words,
                              d=devs, k=dck: fn(
                    out.data_ptr(), n, 2, w, d, g_rounds, k,
                    samplers._affines(), stream), [
                    samplers.gamma_fixed_twin(prng.host_key(keys[h]),
                                              kappas[h], (n,), "cuda")
                    for h in range(2)]))
        else:
            cases = []
            for what, (n_in, p_in) in zip(("darts", "place"), calls):
                out = torch.empty_like(n_in)
                cases.append((f"{what} {n_in.numel()} lanes", out,
                              lambda out=out, n_in=n_in, p_in=p_in: fn(
                    out.data_ptr(), n_in.data_ptr(), p_in.data_ptr(),
                    n_in.numel(), None, kb.words[2:].data_ptr(), b_rounds,
                    samplers._affines(), stream), [
                    samplers.binomial_fixed_twin(prng.host_key(kb), n_in,
                                                 p_in, b_rounds)]))
        for label, out, launch, want in cases:
            def call(launch=launch, name=name):
                build.check(launch(), name)

            call()
            torch.cuda.synchronize()
            equal = all(torch.equal(o.view(torch.int32), w.view(torch.int32))
                        for o, w in zip(out.reshape(len(want), -1), want))
            print(f"{kernel} {name} {label}: {checks.time_ms(call):.4f} ms, "
                  f"equal to the twin {equal}", flush=True)
    one = torch.empty(1, device="cuda")
    print(f"one-element fill: {checks.time_ms(lambda: one.fill_(1)):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
