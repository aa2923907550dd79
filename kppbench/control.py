"""The control of the check, on the card at a cell's own size: each run
drives the cell as the benchmark does and, besides the reference in
float64, runs the reference in bfloat16 (the precision below the
configuration's float32) in the program's place over the same two
stretches and columns, and judges it by the harness's own numbers and
limits.  Prints, per seed, the program's ``correct`` and numbers (the
lower readings) beside the control's ``correct`` and numbers (the upper
ones) and the limits; exits with 1 where a control comes out correct.
The benchmark's own runs never run it.

    python3 kppbench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 10]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kppbench.control: no CUDA card", file=sys.stderr)
        return 3
    from kppbench import harness
    rc = 0
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             root=ROOT, control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": r["correct"], "steps": r["run"]["steps"],
            "program": {k: c["value"] for k, c in r["checks"].items()},
            "control_correct": r["control"]["correct"],
            "control": r["control"]["values"],
            "limits": {k: c["limit"] for k, c in r["checks"].items()}}),
            flush=True)
        rc |= int(r["control"]["correct"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
