"""Two seed spreads side by side: the port's on the card against the JAX
package's on XLA:CPU (or any two runs of the same configuration).

    python -m reina_tpu_torch.mc_compare A.jsonl B.jsonl [--days 60,120]

Each file holds one JSON object a seed with its daily totals, a row a
stepped day, as ``python -m reina_tpu_torch.mc_spread --curves`` (the
port) or ``tests/jax_mc_spread.py`` (the JAX package) writes them; day k
below is the k-th stepped day, and the last is the final all_infected.
It prints, for each file, the seeds S, the
mean and the std (ddof 0, as BENCH_MC.json) of the final all_infected
and the mean daily all_infected at the ``--days``; the difference of
the means B - A with its standard error (sqrt(sA²/SA + sB²/SB), ddof 1);
over the seeds both hold (same base keys, bit-equal at the start), the
paired difference's mean and standard error; and the first stepped day
from which each daily total's mean curves stay more than 3 standard
errors of their difference apart for ``RUN`` days in a row, if any. One JSON line ends the output.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

TOTALS = ("all_infected", "new_infections", "all_detected", "in_ward",
          "in_icu", "dead")


def load(path: str) -> dict:
    """{seed: {total: (stepped days,) array}} of a JSONL file."""
    seeds = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            seeds[int(rec["seed"])] = {
                k: np.asarray(rec[k], np.float64) for k in TOTALS if k in rec}
    return seeds


# days in a row the mean curves must stay apart to count as parted
RUN = 7


def _stats(x: np.ndarray):
    """(mean, std with ddof 0, std with ddof 1)."""
    sd1 = float(x.std(ddof=1)) if len(x) > 1 else float("nan")
    return float(x.mean()), float(x.std()), sd1


def compare(a: dict, b: dict, days) -> dict:
    """The figures :func:`main` prints, for spreads ``a`` and ``b``."""
    out = {}
    finals = {}
    for name, s in (("a", a), ("b", b)):
        fin = np.array([v["all_infected"][-1] for v in s.values()])
        cur = np.stack([v["all_infected"] for v in s.values()])
        mean, std, sd1 = _stats(fin)
        finals[name] = (fin, sd1)
        out[name] = {"seeds": len(s), "final_mean": mean, "final_std": std,
                     "stepped_days": cur.shape[1],
                     "curve_mean": {d: float(cur[:, d - 1].mean())
                                    for d in days if d <= cur.shape[1]}}
    (fa, sa), (fb, sb) = finals["a"], finals["b"]
    out["diff"] = float(fb.mean() - fa.mean())
    out["diff_se"] = float(np.sqrt(sa ** 2 / len(fa) + sb ** 2 / len(fb)))
    common = sorted(set(a) & set(b))
    if len(common) > 1:
        d = np.array([b[s]["all_infected"][-1] - a[s]["all_infected"][-1]
                      for s in common])
        out["paired"] = {"seeds": len(common), "mean": float(d.mean()),
                         "se": float(d.std(ddof=1) / np.sqrt(len(d)))}
    first = {}
    for k in TOTALS:
        if not all(k in v for v in list(a.values()) + list(b.values())):
            continue
        ca = np.stack([v[k] for v in a.values()])
        cb = np.stack([v[k] for v in b.values()])
        n = min(ca.shape[1], cb.shape[1])
        if len(ca) < 2 or len(cb) < 2:
            continue
        se = np.sqrt(ca[:, :n].var(0, ddof=1) / len(ca)
                     + cb[:, :n].var(0, ddof=1) / len(cb))
        gap = np.abs(cb[:, :n].mean(0) - ca[:, :n].mean(0))
        apart = (gap > 3 * se) & (se > 0)
        runs = np.convolve(apart, np.ones(RUN, int), "valid") == RUN
        first[k] = int(np.argmax(runs)) + 1 if runs.any() else None
    out["first_day_apart"] = first
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--days", default="60,120,180,240,364")
    args = ap.parse_args(argv)
    days = [int(x) for x in args.days.split(",")]
    res = compare(load(args.a), load(args.b), days)
    for name, path in (("a", args.a), ("b", args.b)):
        r = res[name]
        print(f"{name} {path}: S={r['seeds']}, final all_infected mean "
              f"{r['final_mean']:.3f}, std {r['final_std']:.3f}; mean "
              "all_infected on stepped days " + ", ".join(
                  f"{d}: {v:.1f}" for d, v in r["curve_mean"].items()))
    print(f"b - a: {res['diff']:.3f} ± {res['diff_se']:.3f} (standard "
          f"error), {res['diff'] / res['diff_se']:.2f} standard errors")
    if "paired" in res:
        p = res["paired"]
        print(f"paired over {p['seeds']} seeds: {p['mean']:.3f} ± "
              f"{p['se']:.3f}")
    print(f"first stepped day from which the mean curves stay > 3 "
          f"standard errors apart for {RUN} days: {res['first_day_apart']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
