"""hour_ms_p95: the 95th percentile (nearest rank) over the timed run's
coupling hours of each hour's device time, from the ``loop.hour`` spans'
device marks in the CLI's summary (one CUDA event at each hour's start
and at the end; ``kppbench/spans.py``), in ms.  Read with or without a
trace; None where the program keeps no such marks."""

from kppbench import spans


def read(run):
    hours = spans.hour_ms(spans.log(run) or [])
    return spans.p95(hours) if hours else None
