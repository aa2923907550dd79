#!/usr/bin/env python3
"""Time the main path's kernels in this checkout and in another, in turns.

    python3 chip_ab.py OTHER_TREE [--reps 10] [--nz NZ[:NCOL[:DMAX]] ...]
                       [--ncol N] [--dmax M] [--layout col_lanes|z_lanes ...]
                       [--dtype float32|float64 ...]

One process a turn, in the order OTHER_TREE, this tree, this tree,
OTHER_TREE, each run from its tree's root with that tree's
``chip_smoke.py`` and ``mckpp_torch``: build the libraries whose kernels
take each ``--nz`` (3 level slots at the main path's nz = 69, 4 at
single_column's nz = 100, a column over 4 warps at nz = 510, over a
cluster past 1022) in each ``--layout`` and ``--dtype`` (float32 by
default), all at once; then for each of them drive the main path's
columns (the nz's own NCOL, else ``--ncol``, by default 144,507; ~12%
land) at that nz over its DMAX m (else ``--dmax``, by default 1000 m)
for two steps, capture each kernel's
inputs on the third and time each kernel three times over ``--reps``
launches.  A turn prints one JSON line a case: the times, a digest
(sha256) of each kernel's inputs and of the outputs of one launch, so
that two trees' kernels compare bit for bit as well as in time (the
inputs are equal where the two trees' earlier steps were), and the
registers, stack and spills ptxas reported for the library where the
turn built it.  Both trees run on the one card of this call, so their
times compare; times from two calls do not.

Prints the card's name and power limit first.  To try a change to the
kernels' source (a register cap, say), unpack a copy of this tree into
a directory .gitignore lists, edit it there and give it as OTHER_TREE.

At the deep spreads (PERF.md's cw and cl rows; ~55 GB of device memory
at nz = 510 on 144,507 columns):

    python3 chip_ab.py PARENT --nz 510 --nz 2046:16384:4000 \
        --layout col_lanes --layout z_lanes
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = (("fused_pass_fast", "cuda"), ("fused_pass_full", "cuda_step"),
           ("fused_step", "cuda_step"))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--nz", action="append")
    ap.add_argument("--ncol", type=int, default=None)
    ap.add_argument("--dmax", type=float, default=1000.0)
    ap.add_argument("--layout", action="append",
                    choices=("col_lanes", "z_lanes"))
    ap.add_argument("--dtype", action="append",
                    choices=("float32", "float64"))
    ap.add_argument("--turn", default=None)      # a turn's label (internal)
    a = ap.parse_args(argv)
    a.nz = a.nz or ["69"]
    a.layout = a.layout or ["col_lanes"]
    a.dtype = a.dtype or ["float32"]
    return a


def digest(tensors):
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cases(args, torch, cs, ck):
    """(nz, dtype, layout, ncol, dmax, geometry) of each case."""
    for spec in args.nz:
        nz, *more = spec.split(":")
        nz = int(nz)
        ncol = int(more[0]) if more else (
            cs.NCOL_MAIN if args.ncol is None else args.ncol)
        dmax = float(more[1]) if len(more) > 1 else args.dmax
        for dt in args.dtype:
            for layout in args.layout:
                yield (nz, dt, layout, ncol, dmax,
                       ck.launch_geometry(nz, getattr(torch, dt), ncol))


def captured(cs, nz, dt, layout, ncol, dmax):
    """{kernel: (wrapper, inputs)} of the third step of the main path at
    this case, one kernel's inputs at a time (the deep cases' captures
    take tens of GB)."""
    kw = dict(land=cs.LAND_SHARE, dmax=dmax, layout=layout, dtype=dt)
    model, st, prm, frc = cs.build(ncol, nz, **kw)
    st, frc = cs.run_steps(model, st, prm, frc, 1, 2)
    del model
    for kname, impl in KERNELS:
        m = cs.build(ncol, nz, pass_impl=impl, **kw)[0]
        with cs.Capture() as cap:
            cs.run_steps(m, st, prm, frc, 3, 1)
        del m
        w, a = cap.first(kname)
        del cap
        yield kname, w, a
        del w, a


def turn(args):
    """This process's turn: the tree is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from mckpp_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    todo = list(cases(args, torch, cs, ck))
    # every library of the turn, one nvcc process each, all at once
    ptxas = cs.ptxas_tables(ck.build(
        tuple(getattr(torch, d) for d in args.dtype),
        slots=tuple({c[5].lib for c in todo}),
        zaxes=tuple({cs.LAYOUTS.index(c[2]) for c in todo})))
    build_s = time.perf_counter() - t0
    for nz, dt, layout, ncol, dmax, geom in todo:
        zaxis = cs.LAYOUTS.index(layout)
        out = {"tree": args.turn, "path": os.getcwd(), "nz": nz,
               "dtype": dt, "layout": layout, "ncol": ncol, "dmax": dmax,
               "library": ck._lib_tag(geom.lib, zaxis), "build_s": build_s}
        for kname, w, a in captured(cs, nz, dt, layout, ncol, dmax):
            out[kname + "_inputs"] = digest(a)
            res = w.launch(*a)
            torch.cuda.synchronize()
            out[kname + "_outputs"] = digest(res)
            del res
            out[kname + "_ms"] = [cs.time_cuda(lambda: w.launch(*a),
                                               args.reps) for _ in range(3)]
            del w, a
        # the library's registers, stack and spills (none where this turn
        # found it built already)
        out["ptxas"] = ptxas.get(f"{dt}/{ck._lib_tag(geom.lib, zaxis)}")
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


def main(argv):
    args = parse(argv)
    if args.turn is not None:
        turn(args)
        return 0
    if args.other is None:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    if not os.path.exists(os.path.join(other, "chip_smoke.py")):
        print(f"chip_ab: {other} holds no chip_smoke.py", file=sys.stderr)
        return 2
    turns = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    rest = [x for x in argv if x != args.other]
    for label, tree in turns:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", label,
             *rest], cwd=tree, timeout=3000)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
