"""glue_ms_per_step.buffers: the device milliseconds a step of the copies
into and out of the CUDA graphs' static buffers (the ``chain.load`` and
``chain.hand_out`` spans on the card), over the window's N steps
(``kppbench/spans.py``)."""

from kppbench import spans


def read(run):
    return spans.ms_per_step(run, ("chain.load", "chain.hand_out"))
