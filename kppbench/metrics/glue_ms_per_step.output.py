"""glue_ms_per_step.output: the device milliseconds a step of the
diagnostics' and the restarts' fetches to the host (the writer thread's
``diag.d2h`` and ``restart.d2h`` spans, from the program's span log
aligned to the trace), over the window's N steps
(``kppbench/spans.py``)."""

from kppbench import spans


def read(run):
    return spans.ms_per_step(run, ("diag.d2h", "restart.d2h"))
