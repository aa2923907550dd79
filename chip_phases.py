#!/usr/bin/env python3
"""Where the cycles go inside the pass body, on one CUDA card.

    python3 chip_phases.py [--nz 69] [--ncol 144507] [--dmax 1000]
                           [--layout col_lanes|z_lanes]
                           [--dtype float32|float64]

Drives the main path of ``chip_smoke.py`` (``--dtype``, by default
float32; ~12% land; by default its 144,507 columns at nz = 69) at ``--nz`` levels over
``--dmax`` m and ``--ncol`` columns for two steps and captures each
kernel's inputs on the third.  Then it builds the kernels of that depth
(one warp a column up to 126 levels, a pair of warps a column, "pw3" and
"pw4", up to 254, a column over a block's warps, "cw", up to 1022, over
a cluster of blocks, "cl", past it) with the stage
clocks of ``mckpp_torch/csrc/fused_pass.cuh`` on
(``cuda_kernels.build(phases=True)``, a library of its own name beside
the port's), points this process's wrappers at that library, launches
each kernel twice on its captured inputs and prints one JSON line per
kernel: its time, the share of warp cycles spent in each stage of the
pass body (``KPP_MARK``), per warp the share spent staging inputs, on its
column, waiting for the block's slowest warp and writing back
(``KPP_BMARK``), and the column's barriers (``col_sync``): their share of
the stages' warp cycles and their number a block and a column-pass.  The
shares are warp time (issue plus stalls), so they say where a warp waits
as well as where it computes.

At the deep spreads (the pair, cw and cl kernels of PERF.md's table):

    python3 chip_phases.py --nz 150 --layout z_lanes
    python3 chip_phases.py --nz 254 --layout z_lanes

    python3 chip_phases.py --nz 510 --layout z_lanes
    python3 chip_phases.py --nz 2046 --ncol 16384 --dmax 4000 --layout z_lanes
"""

import argparse
import ctypes
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# KPP_MARK(i) in csrc/fused_pass.cuh ends stage i of the pass body
STAGES = ["relax+eos", "solar+fluxes", "ref_averages", "rimix+ddmix",
          "bldepth", "blmix+enhance", "uv_solves", "ts_solves", "instability"]
# KPP_BMARK(10 + i) ends stage i of a block, per warp
BLOCK = ["staging", "column_work", "block_wait", "write_back"]
BAR_CYCLES, BAR_COUNT = 14, 15     # the barriers' slots of kpp_phase
LAUNCHES = 2                       # launches the counters sum over


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=None,
                    help="levels (default: the main path's 69)")
    ap.add_argument("--ncol", type=int, default=None,
                    help="columns (default: the main path's 144,507)")
    ap.add_argument("--dmax", type=float, default=1000.0,
                    help="depth of the column in m")
    ap.add_argument("--layout", default="col_lanes",
                    choices=("col_lanes", "z_lanes"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    return ap.parse_args(argv)


def main(argv=()):
    args = parse(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mckpp_torch.ops import cuda_kernels as ck
    name = torch.cuda.get_device_name(0)
    nz = cs.NZ_MAIN if args.nz is None else args.nz
    ncol = cs.NCOL_MAIN if args.ncol is None else args.ncol
    zaxis = cs.LAYOUTS.index(args.layout)
    dtype = getattr(torch, args.dtype)
    kw = dict(land=cs.LAND_SHARE, dmax=args.dmax, layout=args.layout,
              dtype=args.dtype)
    model, st, prm, frc = cs.build(ncol, nz, **kw)
    st, frc = cs.run_steps(model, st, prm, frc, 1, 2)
    del model
    caps = {}
    for impl, kname in (("cuda", "fused_pass_fast"),
                        ("cuda_step", "fused_pass_full"),
                        ("cuda_step", "fused_step")):
        m = cs.build(ncol, nz, pass_impl=impl, **kw)[0]
        with cs.Capture() as cap:
            cs.run_steps(m, st, prm, frc, 3, 1)
        caps[kname] = cap.first(kname)
        del m, cap
    del st, prm, frc
    # the geometry the wrappers take on these inputs (aref's real prefix)
    a = caps["fused_step"][1]
    geom = ck.launch_geometry(nz, dtype, ncol, ck._ref_extents(
        ck._kernel_aref(a[-1], zaxis))[1])
    del a
    lib = ck.load(dtype, geom.lib, phases=True, zaxis=zaxis)
    ck._libs[dtype, geom.lib, zaxis] = lib   # the wrappers' library
    # barriers are counted once a block (by its thread 0): a column over
    # a cluster counts its barriers once in each of its cb blocks, and a
    # block of several columns (one warp or a pair of warps each) counts
    # those of its first column
    per_column = (geom.cb if geom.cb > 1 else 1.0 / geom.cols_per_block)
    for kname, (w, a) in caps.items():
        out = w.launch(*a)
        torch.cuda.synchronize()
        if kname == "fused_step":            # the passes its columns ran
            colstep = out[8] if zaxis == 0 else out[8].T
            passes = float(colstep[7].double().sum())
        else:
            passes = float(ncol)
        del out
        if lib.kpp_phase_zero() != 0:
            raise RuntimeError("could not zero the phase counters")
        ms = cs.time_cuda(lambda: w.launch(*a), LAUNCHES - 1)
        buf = (ctypes.c_ulonglong * 16)()
        if lib.kpp_phase_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("could not read the phase counters")
        total = sum(buf[:len(STAGES)])
        btotal = sum(buf[10:10 + len(BLOCK)])
        if total == 0:
            raise RuntimeError(f"{kname}: the stage clocks counted nothing "
                               "(the wrapper launched another library?)")
        blocks = LAUNCHES * geom.blocks
        cs.emit({"kernel": kname, "card": name, "nvidia_smi": cs.smi_line(),
                 "nz": nz, "ncol": ncol, "dmax": args.dmax,
                 "layout": args.layout, "dtype": args.dtype,
                 "library": ck._lib_tag(geom.lib),
                 "warps_per_block": geom.warps,
                 "columns_per_block": geom.cols_per_block,
                 "blocks_per_cluster": geom.cb,
                 "ms_instrumented": ms, "warp_cycles": total,
                 "share": {s: buf[i] / total for i, s in enumerate(STAGES)},
                 "block_warp_cycles": btotal,
                 "block_share": {s: buf[10 + i] / btotal
                                 for i, s in enumerate(BLOCK)},
                 "barrier_share": buf[BAR_CYCLES] / total,
                 "barriers_per_block": buf[BAR_COUNT] / blocks,
                 "barriers_per_column_pass":
                     buf[BAR_COUNT] / (LAUNCHES * passes * per_column),
                 "passes_per_launch": passes})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
