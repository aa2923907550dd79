#!/usr/bin/env python3
"""Where the cycles go inside the pass body, on one CUDA card.

    python3 chip_phases.py

Drives the main path of ``chip_smoke.py`` (144,507 columns, nz = 69,
float32) for two steps and captures each kernel's inputs on the third.
Then it builds the kernels with the stage clocks of
``mckpp_torch/csrc/fused_pass.cuh`` on (``cuda_kernels.build(phases=True)``,
a library of its own name beside the port's), points this process's
wrappers at that library, launches each kernel twice on its captured
inputs and prints one JSON line per kernel: its time, the share of warp
cycles spent in each stage of the pass body (``KPP_MARK``), and per warp
the share spent staging inputs, on its column, waiting for the block's
slowest warp and writing back (``KPP_BMARK``).  The shares are warp time
(issue plus stalls), so they say where a warp waits as well as where it
computes.
"""

import ctypes
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# KPP_MARK(i) in csrc/fused_pass.cuh ends stage i of the pass body
STAGES = ["relax+eos", "solar+fluxes", "ref_averages", "rimix+ddmix",
          "bldepth", "blmix+enhance", "uv_solves", "ts_solves", "instability"]
# KPP_BMARK(10 + i) ends stage i of a block, per warp
BLOCK = ["staging", "column_work", "block_wait", "write_back"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mckpp_torch.ops import cuda_kernels as ck
    name = torch.cuda.get_device_name(0)
    model, st, prm, frc = cs.build(cs.NCOL_MAIN, cs.NZ_MAIN,
                                   land=cs.LAND_SHARE)
    st, frc = cs.run_steps(model, st, prm, frc, 1, 2)
    caps = {}
    for impl, kname in (("cuda", "fused_pass_fast"),
                        ("cuda_step", "fused_pass_full"),
                        ("cuda_step", "fused_step")):
        m = cs.build(cs.NCOL_MAIN, cs.NZ_MAIN, pass_impl=impl,
                     land=cs.LAND_SHARE)[0]
        with cs.Capture() as cap:
            cs.run_steps(m, st, prm, frc, 3, 1)
        caps[kname] = cap.first(kname)
    lib = ck.load(torch.float32, 3, phases=True)
    ck._libs[torch.float32, 3] = lib       # the wrappers launch it from here
    for kname, (w, a) in caps.items():
        w.launch(*a)
        torch.cuda.synchronize()
        if lib.kpp_phase_zero() != 0:
            raise RuntimeError("could not zero the phase counters")
        ms = cs.time_cuda(lambda: w.launch(*a), 1)     # two launches
        buf = (ctypes.c_ulonglong * 16)()
        if lib.kpp_phase_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("could not read the phase counters")
        total = sum(buf[:len(STAGES)])
        btotal = sum(buf[10:10 + len(BLOCK)])
        cs.emit({"kernel": kname, "card": name, "nvidia_smi": cs.smi_line(),
                 "ms_instrumented": ms, "warp_cycles": total,
                 "share": {s: buf[i] / total for i, s in enumerate(STAGES)},
                 "block_warp_cycles": btotal,
                 "block_share": {s: buf[10 + i] / btotal
                                 for i, s in enumerate(BLOCK)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
