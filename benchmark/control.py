"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size.

    python3 -m benchmark.control --workload <cell> [--seeds 3]
        [--sound 12]

Sets the cell up once, then for each of ``--sound`` seeds takes one
answer of the timed path (a member of the seed's, or a what-if of the
seed's served through the server) and prints the numbers the check
compares for it (the lower readings), and for the first ``--seeds`` of
them the same numbers with the control, the reference computed in
bfloat16, in the program's place (the upper readings). The last line of
standard output is a JSON object {"sound": [...], "control": [...]}."""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    args = ap.parse_args(argv)
    from .run import cache_dirs, driver
    from .harness import check
    from .harness.cell import cell as find_cell
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    c = find_cell(args.workload)
    d = driver(c, args.first_seed, "cuda")
    d.setup()
    k = int(c.traffic["check_days"])
    out = {"sound": [], "control": []}
    for i in range(max(args.sound, args.seeds)):
        seed = args.first_seed + i
        rng = np.random.default_rng([seed, 0x434845])
        # one answer of the timed path: a member of the seed's, or the
        # seed's first what-if served through the server
        items = d.one(seed, rng)
        if not items:
            raise SystemExit(f"seed {seed}: no answer to compare")
        state = rng.bit_generator.state
        if i < args.sound:
            nums = check.compare(items, rng, k, "cuda",
                                 log=lambda s: print(s, file=sys.stderr))
            out["sound"].append(nums)
            print(f"seed {seed} sound {nums}", flush=True)
        if i < args.seeds:
            rng.bit_generator.state = state
            nums = check.compare(items, rng, k, "cuda", control=True,
                                 log=lambda s: print(s, file=sys.stderr))
            out["control"].append(nums)
            print(f"seed {seed} control {nums}", flush=True)
    d.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
