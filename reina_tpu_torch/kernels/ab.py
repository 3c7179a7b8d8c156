"""The hand-written kernels of two source trees, timed on one card in
turns.

    python -m reina_tpu_torch.kernels.ab [--other DIR] [--rounds 1]
                                         [--sharded]

DIR is another checkout of this repository (for example an earlier
commit unpacked with ``git archive``). Each tree runs in an interpreter
of its own, since both packages are named ``reina_tpu_torch``, in the
order other, this, this, other (``--rounds`` times); without
``--other``, this tree runs once. The inputs are those of
``kernels/checks.py`` at the HUS agent count. Each run prints one line
``AB <tree> {json}`` with:

  * ``prefix_ms``: ``fused_concat_prefix`` of ``newly`` (n_seg 1) and of
    the weights (n_seg 2), the pair the day step makes; ``cumsum_ms``:
    ``torch.cumsum`` of the same two, in the same process;
  * ``prefix_one_ms``: ``fused_concat_prefix`` of ``newly`` alone, as
    its callers without a pick make it;
  * ``slot_pick_ms``: the prefix of ``newly``, its count and the slot
    tier pick: in a tree with fused picks one launch of the prefix with
    its fold (``fusedmap.prefix_count``), in an older tree the prefix,
    ``cum[-1].to(int32)`` and the pick kernel; ``t2_pick_ms``: T2's pick
    on the maximum of 1,536 bucket fills and a member count of 1,000,
    the reduce-and-pick (``compact.count_max``) against torch's max and
    the pick kernel;
  * ``ledger_ms``: ``clamped_counter_grants`` for both ledgers;
  * ``fn_onehot_ms``: ``fused_fn_onehot_sum`` of the phase-7 fields;
  * ``bihist_site_ms``: the day step's histogram call,
    ``fused_bihistogram(vts, VTS, k_s, ages, A, gate=exposer)``;
  * ``post_ms``: the post-ledger body through ``fused_map``, as the day
    step calls it;
  * ``onehot_ms``: ``fused_onehot_sum`` at the snapshot's call: 13
    masks by the group code (agents sorted by age, padding in the last
    group); ``onehot_random_ms``: the same masks by random codes;
    ``onehot_vacc_ms``: at the vaccination call, one mask by age;
  * the samplers at the day step's calls on day 100 of the HUS run
    (``checks.capture_samplers``), with their keys in device memory as
    the day's key table gives them: ``gamma_ms`` the day's two gamma
    draws (``gamma_fixed_pair`` where the tree has it, else two
    ``gamma_fixed`` calls), ``gamma_one_ms`` one ``gamma_fixed`` call of
    the same shape, ``binomial_ms`` both ``binomial_fixed`` calls (the
    darts and the per-place exposures), ``binomial_darts_ms`` the
    darts' call alone;
  * ``device_us``: device time per call by kernel name, and
    ``kernels_per_call``: device operations (kernels, memsets, copies)
    per call, both from torch.profiler over 20 back-to-back calls of
    each (warm L2);
  * ``triton_post``, for a tree whose post body is a Triton kernel: for
    blocks of 1,024 and 2,048 agents (8 and 16 agents a thread at 4
    warps), its registers and spills, the count of each global load and
    store instruction in its PTX by width, and its time.

With ``--sharded`` each run times the sharded forms of the ledger and
the prefix instead (an agent-sharded run's entries, every slab of k in
turn in one process, the exchange between the slabs by stacking, as
``checks.sharded_checks`` runs them), for k = 2, 4 and 8:
``ledger_k<k>_ms`` (``checks.sharded_ledger``), ``prefix_k<k>_ms`` (the
day step's pair, ``newly`` and the weights by variant:
``checks.sharded_prefix``) and ``pick_k<k>_ms`` (the slot pick's
prefix with its count and picks: ``checks.sharded_fold_check``'s
kernel), each with its ``device_us`` and ``kernels_per_call`` (device
operations a call, memsets and copies included) for all k slabs.

The ``_ms`` times are ``checks.time_ms``: cold L2, median of 7. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

_CHILD = r'''
import json, re, sys
from collections import Counter, defaultdict
import torch
sys.path.insert(0, ".")
from reina_tpu_torch.core import step
from reina_tpu_torch.kernels import checks, fused_bodies
from reina_tpu_torch.ops import clamped, fusedmap
s = checks._streams(checks.HUS_N, 0, "cuda")
VTS, A, G = checks.VTS, checks.A, checks.G
codes = s["var"].to(torch.int32)
init = torch.tensor([300, 60], dtype=torch.int32, device="cuda")
cat = torch.cat([torch.where(codes == v, s["w"], 0.0)
                 for v in range(checks.V)])
b, f = s["b"], s["f"]
po = ([s["st"], s["sev"], s["var"], s["o2r"], s["dl"]] + b[:2] + [f[2]]
      + b[2:14])
elig = s["fields"][0] & (s["ages"] >= 16) & (s["ages"] <= 79) & b[13]
from reina_tpu_torch.config.variables import VARIABLE_DEFAULTS
from reina_tpu_torch.core.engine import build_run
from reina_tpu_torch.ops import prng
from reina_tpu_torch.ops import random as samplers
run = build_run(dict(VARIABLE_DEFAULTS, simulation_days=365), "cuda")
cap = checks.capture_samplers(run, 100)
del run
kg = [samplers.dev_key(k, "cuda", samplers.gamma_words, step.GAMMA_ROUNDS)
      for k in prng.split(prng.PRNGKey(5), 2)]
kb = [samplers.dev_key(k, "cuda", samplers.binomial_words,
                       step.BINOMIAL_ROUNDS)
      for k in prng.split(prng.PRNGKey(6), 2)]
if hasattr(samplers, "gamma_fixed_pair"):
    kap1, kap2, g_shape = cap["gamma"]
    gamma = lambda: samplers.gamma_fixed_pair(kg[0], kap1, kg[1], kap2,
                                              g_shape, "cuda")
else:
    (kap1, g_shape), (kap2, _) = cap["gamma"]
    gamma = lambda: (samplers.gamma_fixed(kg[0], kap1, g_shape, "cuda"),
                     samplers.gamma_fixed(kg[1], kap2, g_shape, "cuda"))
(nb, pb), (nx, px) = cap["binomial"]
from reina_tpu_torch.core import daygraph
nodes = {n.name: n for n in step.conditionals(step.day_program(
    step.EngineConfig(), True, False, False))}
i32 = dict(dtype=torch.int32, device="cuda")
table = torch.full((4, len(step.PICK_COLS)), -1, **i32)
counter = torch.full((), 2, dtype=torch.int64, device="cuda")
problem = torch.zeros((), **i32)
tally_c = torch.zeros(len(nodes["C"].keys()), **i32)
tally_t2 = torch.zeros(len(nodes["T2"].keys()), **i32)
gen = torch.Generator(device="cpu").manual_seed(7)
fills = torch.randint(0, 38, (1536,), generator=gen).to(**i32)
n_d = torch.tensor(1000, **i32)
col_c, col_t2 = step.PICK_COLS.index("C"), step.PICK_COLS.index("T2")
if hasattr(daygraph, "Fold"):
    from reina_tpu_torch.ops import compact
    fold_c = daygraph.Fold([nodes["C"]], [col_c], [tally_c], table, counter,
                           problem)
    fold_t2 = daygraph.Fold([nodes["T2"]], [col_t2], [tally_t2], table,
                            counter, problem, lookup=lambda p: n_d)
    slot_pick = lambda: fusedmap.prefix_count(s["newly"], "n_new",
                                              site=fold_c)
    t2_pick = lambda: compact.count_max(fills, "fill_max", site=fold_t2)
else:
    def slot_pick():
        cum = fusedmap.fused_concat_prefix(s["newly"], None, 1)
        daygraph.pick([cum[-1].to(torch.int32)], nodes["C"].picks, table,
                      counter, col_c, tally_c, problem)

    def t2_pick():
        daygraph.pick([n_d, fills.max()], nodes["T2"].picks, table, counter,
                      col_t2, tally_t2, problem)
out = {"sampler_lanes": {"gamma": list(g_shape),
                         "binomial": [nb.numel(), nx.numel()]}}
fns = {
    "prefix": lambda: (fusedmap.fused_concat_prefix(s["newly"], None, 1),
                       fusedmap.fused_concat_prefix(s["w"], codes, checks.V)),
    "prefix_one": lambda: fusedmap.fused_concat_prefix(s["newly"], None, 1),
    "slot_pick": slot_pick,
    "t2_pick": t2_pick,
    "cumsum": lambda: (torch.cumsum(s["newly"], 0), torch.cumsum(cat, 0)),
    "ledger": lambda: clamped.clamped_counter_grants(s["rel"], s["req"],
                                                     init, s["offset"]),
    "fn_onehot": lambda: fusedmap.fused_fn_onehot_sum(
        s["fields"], step._output_masks_reduced, 10, s["grp"], G + 1),
    "bihist_site": lambda: fusedmap.fused_bihistogram(
        s["vts"], VTS, s["k_s"], s["ages"], A, gate=s["gate"]),
    "post": lambda: fusedmap.fused_map(step.post, po, s["tabs"]),
    "onehot": lambda: fusedmap.fused_onehot_sum(b[:13], s["grp"], G + 1),
    "onehot_random": lambda: fusedmap.fused_onehot_sum(b[:13], s["code"],
                                                       G + 1),
    "onehot_vacc": lambda: fusedmap.fused_onehot_sum([elig], s["ages"], A),
    "gamma": gamma,
    "gamma_one": lambda: samplers.gamma_fixed(kg[0], kap1, g_shape, "cuda"),
    "binomial": lambda: (samplers.binomial_fixed(kb[0], nb, pb),
                         samplers.binomial_fixed(kb[1], nx, px)),
    "binomial_darts": lambda: samplers.binomial_fixed(kb[0], nb, pb),
}
out |= {k + "_ms": checks.time_ms(f) for k, f in fns.items()}
out["device_us"], out["kernels_per_call"] = {}, {}
for k, f in fns.items():
    f()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            f()
        torch.cuda.synchronize()
    by = defaultdict(float)
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name[:80]] += e.time_range.elapsed_us() / 20
            count += 1
    out["device_us"][k] = dict(by)
    out["kernels_per_call"][k] = count / 20
if hasattr(fused_bodies, "_post_kernel"):
    out["triton_post"] = {}
    want = step.post(*po, *s["tabs"])
    launch = fused_bodies._launch
    for block in (1024, 2048):
        got = []

        def _launch(fn, n, *args, **meta):
            grid = ((n + block - 1) // block,)
            got.append(fused_bodies._kernel(fn)[grid](
                *args, n, BLOCK=block, num_warps=4, enable_fp_fusion=False,
                **meta))

        fused_bodies._launch = _launch
        res = fused_bodies.post(*po, *s["tabs"])
        k = got[-1]
        ptx = k.asm["ptx"] if hasattr(k, "asm") else ""
        out["triton_post"][block] = {
            "n_regs": getattr(k, "n_regs", None),
            "n_spills": getattr(k, "n_spills", None),
            "ld_st": dict(Counter(re.findall(r"\b(?:ld|st)\.global[\w.]*",
                                             ptx))),
            "equal": all(torch.equal(x, y) for x, y in zip(res, want)),
            "ms": checks.time_ms(lambda: fused_bodies.post(*po, *s["tabs"])),
        }
    fused_bodies._launch = launch
print("AB " + sys.argv[1] + " " + json.dumps(out), flush=True)
'''


_SHARDED_CHILD = r'''
import json, sys
from collections import defaultdict
import torch
sys.path.insert(0, ".")
from reina_tpu_torch.kernels import checks
s = checks._streams(checks.HUS_N, 0, "cuda")
codes = s["var"].to(torch.int32)
init = torch.tensor([300, 60], dtype=torch.int32, device="cuda")
out = {"device_us": {}, "kernels_per_call": {}}
for k in (2, 4, 8):
    fns = {
        f"ledger_k{k}": lambda k=k: checks.sharded_ledger(
            s["rel"], s["req"], init, s["offset"], k, True),
        f"prefix_k{k}": lambda k=k: (
            checks.sharded_prefix(s["newly"], None, 1, k, True),
            checks.sharded_prefix(s["w"], codes, checks.V, k, True)),
        f"pick_k{k}": checks.sharded_fold_check(checks.HUS_N, 0, "cuda",
                                                k).kernel,
    }
    for name, f in fns.items():
        out[name + "_ms"] = checks.time_ms(f)
        f()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                f()
            torch.cuda.synchronize()
        by, count = defaultdict(float), 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name[:80]] += e.time_range.elapsed_us() / 20
                count += 1
        out["device_us"][name] = dict(by)
        out["kernels_per_call"][name] = count / 20
print("AB " + sys.argv[1] + " " + json.dumps(out), flush=True)
'''


def run_tree(tree: Path, label: str, child: str = _CHILD) -> dict:
    r = subprocess.run([sys.executable, "-c", child, label], cwd=tree,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"{label} ({tree}) failed:\n{r.stderr[-4000:]}")
    line = [x for x in r.stdout.splitlines() if x.startswith("AB ")][-1]
    print(line, flush=True)
    return json.loads(line.split(" ", 2)[2])


def in_turns(other, rounds: int, run_tree, here: Path = HERE) -> dict:
    """{label: [run_tree(tree, label), ...]}: tree ``other`` ("other")
    and ``here`` ("this") in the order other, this, this, other,
    ``rounds`` times; without ``other``, ``here`` once a round. Prints
    the card's nvidia-smi line first."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    order = ("other", "this", "this", "other") if other else ("this",)
    runs = {label: [] for label in order}
    for _ in range(rounds):
        for label in order:
            tree = Path(other).resolve() if label == "other" else here
            runs[label].append(run_tree(tree, label))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args(argv)
    child = _SHARDED_CHILD if args.sharded else _CHILD
    runs = in_turns(args.other, args.rounds,
                    lambda tree, label: run_tree(tree, label, child))
    for label, rs in runs.items():
        keys = sorted(k for k in rs[0] if k.endswith("_ms"))
        print(f"{label}: " + ", ".join(
            f"{k} " + " / ".join(f"{r[k]:.4f}" for r in rs) for k in keys))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
