"""roofline.fused_step: the least time of one launch of the whole-step
kernel (the larger of its bytes, ``yardstick.step_bytes``, over the HBM
peak and its operations, the window's mean step, over the float32 peak)
over the trace's device time per launch of ``kpp::fused_step_kernel``,
in percent."""

from kppbench import tracing


def read(run):
    if not run.events:
        return None
    ms, n = tracing.kernel_ms(
        run.events, lambda name: "kpp::" in name
        and "fused_step_kernel" in name)
    if not n or ms <= 0:
        return None
    flops, bw = run.peaks
    bound_s = max(run.step_bytes / bw, run.ops_per_step / flops)
    return 100.0 * bound_s * n / (ms / 1e3)
