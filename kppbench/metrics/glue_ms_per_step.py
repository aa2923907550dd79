"""glue_ms_per_step: the device milliseconds of every kernel, copy and
set in the traced window that is not one of the port's ``kpp::`` kernels,
over the window's N steps: the step glue, the diagnostics' device
reductions and fetches and the graphs' buffer copies together."""

from kppbench import tracing


def read(run):
    if not run.events:
        return None
    ms, n = tracing.kernel_ms(run.events, lambda name: "kpp::" not in name)
    return ms / run.steps if n else None
