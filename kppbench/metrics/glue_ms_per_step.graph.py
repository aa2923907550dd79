"""glue_ms_per_step.graph: the device milliseconds a step of the kernels
and copies other than the port's ``kpp::`` kernels that run inside the
CUDA graphs' replays (the ``chain.replay`` spans on the card: the step
glue and the diagnostics' reductions), over the window's N steps
(``kppbench/spans.py``)."""

from kppbench import spans


def read(run):
    return spans.ms_per_step(run, ("chain.replay",))
