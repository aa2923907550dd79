#!/usr/bin/env python3
"""Time the main path's kernels in this checkout and in another, in turns.

    python3 chip_ab.py OTHER_TREE [--reps 10] [--nz 69]

One process a turn, in the order OTHER_TREE, this tree, this tree,
OTHER_TREE, each run from its tree's root with that tree's
``chip_smoke.py`` and ``mckpp_torch``: build the float32 library whose
kernels take ``--nz`` (3 level slots at the main path's nz = 69, 4 at
single_column's nz = 100, a column over 4 warps at nz = 510, over a
cluster past 1022), drive the main path's columns (144,507,
~12% land, float32) at that nz for two steps, capture each kernel's
inputs on the third and time each kernel three times over ``--reps``
launches.  Prints the card's name and power limit, then one JSON line a
turn.  Both trees run on the one card of this call, so their times
compare; times from two calls do not.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def turn(label, reps, nz):
    """This process's turn: the tree is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from mckpp_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    geom = ck.launch_geometry(nz, torch.float32, cs.NCOL_MAIN)
    ck.build((torch.float32,), slots=(geom.lib,))
    build_s = time.perf_counter() - t0
    model, st, prm, frc = cs.build(cs.NCOL_MAIN, nz, land=cs.LAND_SHARE)
    st, frc = cs.run_steps(model, st, prm, frc, 1, 2)
    caps = {}
    for impl in ("cuda", "cuda_step"):
        m = cs.build(cs.NCOL_MAIN, nz, pass_impl=impl,
                     land=cs.LAND_SHARE)[0]
        with cs.Capture() as cap:
            cs.run_steps(m, st, prm, frc, 3, 1)
        caps[impl] = cap
    out = {"tree": label, "path": os.getcwd(), "nz": nz,
           "library": ck._lib_tag(geom.lib), "build_s": build_s}
    for kname, impl in (("fused_pass_fast", "cuda"),
                        ("fused_pass_full", "cuda_step"),
                        ("fused_step", "cuda_step")):
        w, a = caps[impl].first(kname)
        out[kname + "_ms"] = [cs.time_cuda(lambda: w.launch(*a), reps)
                              for _ in range(3)]
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--turn":
        turn(argv[1], int(argv[2]), int(argv[3]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 10
    nz = int(argv[argv.index("--nz") + 1]) if "--nz" in argv else 69
    if not os.path.exists(os.path.join(other, "chip_smoke.py")):
        print(f"chip_ab: {other} holds no chip_smoke.py", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for label, tree in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", label,
             str(reps), str(nz)], cwd=tree, timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
