"""The comparison that decides ``correct``.

The program's answers are its runs' daily outputs: each member's of an
ensemble, each served scenario's result columns. A run of 564 days
cannot be followed by the plain reference in the time of a check (the
reference steps a HUS day in about a fifth of a second), and a one-ulp
difference between a kernel and its plain form (``exp`` in a fused body)
flips a threshold draw somewhere in 1.7 M agents within days, after
which two runs of one seed part. So the reference follows the program
step by step from the program's own state, on days drawn from the seed,
and the stages this skips are checked by themselves:

* start: the reference compiles the run from the same variables and
  archives itself (``reference/build.py``); the program's build (its
  model arrays, schedules, initial state and carry) must equal it
  element for element (``start_off``, exact);
* replay: for each day d drawn, the program's own ``run_days`` of the
  same build and seed to day d and to day d + 1 gives its state there
  and its outputs up to there; those outputs must equal what the timed
  path produced, bit for bit (``replay_off``; for a served scenario its
  result columns against the reference's columns of those outputs);
  the last day is always drawn, so every row of the answer is covered;
* step: the reference steps day d from the program's state at d with
  the seed's keys for d; its state, carry and outputs must agree with
  the program's at d + 1: ``elements_off`` counts the state and carry
  elements that differ (floats by more than ``ULPS`` ulp), the largest
  over the days drawn, and ``outputs_off`` the sum of the absolute
  differences of the day's integer outputs plus the float outputs more
  than ``ULPS`` ulp apart.

The control puts the reference computed with every float32 rounded to
bfloat16 (``reference.build.step(lower=True)``) in the program's place
for the step."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

ULPS = 4
NUMBERS = ("start_off", "replay_off", "elements_off", "outputs_off")


def _ordered(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _off(a, b) -> int:
    """Elements of ``a`` and ``b`` that differ: integers and bools at
    all, float32 by more than ULPS ulp (NaN equal to NaN)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    b = b.to(a.device)
    if a.dtype.is_floating_point:
        a, b = a.to(torch.float32), b.to(torch.float32)
        both_nan = torch.isnan(a) & torch.isnan(b)
        far = (_ordered(a) - _ordered(b)).abs() > ULPS
        return int((far & ~both_nan).sum())
    return int((a != b.to(a.dtype)).sum())


def _abs_diff(a, b) -> int:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype.is_floating_point:
        return _off(a, b)
    return int((a.to(torch.int64) - b.to(a.device).to(torch.int64))
               .abs().sum())


def _fields(t) -> Dict[str, object]:
    return {k: v for k, v in t._asdict().items()
            if isinstance(v, torch.Tensor)}


def _elements_off(sa, ca, sb, cb) -> int:
    n = sum(_off(a, b) for a, b in zip(sa, sb))
    fa, fb = _fields(ca), _fields(cb)
    return n + sum(_off(fa[k], fb[k]) for k in fa if k in fb)


def _outputs_off(oa, ob) -> int:
    return sum(_abs_diff(a, b) for a, b in zip(oa, ob))


def _row(out, i: int):
    return type(out)(*(np.asarray(x)[i] for x in out))


def start_off(run, rb) -> int:
    """Elements of the program's build that differ from the reference's."""
    n = 0
    for a, b in ((run.arrays, rb.arrays), (run.schedules, rb.schedules),
                 (run.init_state, rb.state)):
        n += sum(_off(x, y) for x, y in zip(a, b))
    fa, fb = _fields(run.init_carry), _fields(rb.carry)
    n += sum(_off(fa[k], fb[k]) for k in fb)
    return n + int(dataclasses.asdict(run.cfg)
                   != dataclasses.asdict(rb.cfg))


def sample_days(rng, steps: int, k: int) -> List[int]:
    """``k`` days of [0, steps) drawn from ``rng``: the first and the
    last always."""
    inner = rng.choice(np.arange(1, steps - 1), size=max(k - 2, 0),
                       replace=False)
    return sorted({0, steps - 1, *(int(d) for d in inner)})


def compare(items: list, rng, k: int, device, control: bool = False,
            log=print) -> Dict[str, int]:
    """The numbers compared over ``items`` (see the module docstring):
    each item a dict with ``variables``, ``seed``, the program's
    ``run`` (a CompiledRun of those variables), and its answer:
    ``outputs`` (a member's DayOutputs without the day-0 row) or
    ``columns`` (a served scenario's result columns)."""
    from reina_tpu_torch.core.engine import run_days
    from ..reference import build as R
    nums = dict.fromkeys(NUMBERS, 0)
    for item in items:
        t0 = time.perf_counter()
        run, seed = item["run"], item["seed"]
        rb = R.build(R.resolved(item["variables"]), device)
        nums["start_off"] += start_off(run, rb)
        nums["replay_off"] += item.get("client_off", 0)
        steps = run.days - 1
        for d in sample_days(rng, steps, k):
            out_d, st_d, cr_d, _ = run_days(run, n_days=d + 1, seed=seed)
            out_e, st_e, cr_e, _ = run_days(run, n_days=d + 2, seed=seed)
            if item.get("outputs") is not None:
                want = item["outputs"]
                nums["replay_off"] += sum(
                    _off(np.asarray(a)[1:d + 2], np.asarray(b)[:d + 1])
                    for a, b in zip(out_e, want))
            if item.get("columns") is not None and d == steps - 1:
                cols = R.daily_columns(out_e, rb.variant_names,
                                       rb.start_date, d + 2)
                got = item["columns"]
                for name, want in cols.items():
                    if name == "date":
                        same = np.array_equal(np.asarray(got[name]), want)
                        nums["replay_off"] += 0 if same else len(want)
                    elif name not in got:
                        nums["replay_off"] += len(want)
                    else:
                        nums["replay_off"] += _off(
                            torch.from_numpy(np.asarray(got[name])),
                            torch.from_numpy(np.asarray(want)))
            ref = R.step(rb, st_d, cr_d, seed)
            if control:
                prog = R.step(rb, st_d, cr_d, seed, lower=True)
                p_state, p_carry, p_out = prog
            else:
                p_state, p_carry, p_out = st_e, cr_e, _row(out_e, d + 1)
            e = _elements_off(p_state, p_carry, ref[0], ref[1])
            o = _outputs_off(p_out, ref[2])
            nums["elements_off"] = max(nums["elements_off"], e)
            nums["outputs_off"] = max(nums["outputs_off"], o)
            del ref, st_d, cr_d, st_e, cr_e
        log(f"check: seed {seed}, {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{k} {v}" for k, v in nums.items()))
    return nums
