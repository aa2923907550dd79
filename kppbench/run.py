"""Run one cell of the benchmark once and print its result line.

    python3 kppbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(``python3 -m kppbench.run`` from the repository's root does the same.)
The cell's set-up, window and check are ``harness.run_cell``; the last
lines on standard error are the numbers compared, each with its limit,
and the last line on standard output is the result's JSON object.  A run
needs as many CUDA cards as the cell asks for, and exits with code 3
without a result where there are fewer."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    from kppbench import harness, spec
    cell = spec.resolve(args.workload, ROOT)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"kppbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{have} found", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), root=ROOT, t0=T0)
    print(f"bytes_written {result['run']['bytes_written']} "
          f"window_steps {result['run']['steps']} "
          f"card {result['run']['card']}", flush=True)
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
