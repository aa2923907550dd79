"""roofline.fused_step_ns4: ``roofline.fused_step`` of the 4-slot
one-warp build alone (``nz + 2`` of 97 to 128 levels): the least time of
one launch of the whole-step kernel (the larger of its bytes,
``yardstick.step_bytes``, over the HBM peak and its operations, the
window's mean step, over the float32 peak) over the trace's device time
per launch of the ``kpp::fused_step_kernel`` launches whose template
arguments name 4 level slots and the one-warp spread
(``fused_step_kernel<float, 4, (kpp::Spread)0, ...>``), in percent.
None where the window launched no such kernel: the 3-slot build, the
pair builds (``(kpp::Spread)3``) and the deeper ones never count."""

import re

from kppbench import tracing

NS4 = re.compile(r"kpp::fused_step_kernel<\s*(?:float|double)\s*,\s*4\s*,"
                 r"\s*(?:\(kpp::Spread\)0|kpp::WARP)\s*[,>]")


def read(run):
    if not run.events:
        return None
    ms, n = tracing.kernel_ms(run.events,
                              lambda name: NS4.search(name) is not None)
    if not n or ms <= 0:
        return None
    flops, bw = run.peaks
    bound_s = max(run.step_bytes / bw, run.ops_per_step / flops)
    return 100.0 * bound_s * n / (ms / 1e3)
