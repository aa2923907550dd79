"""step_block_fill: the block fill of the program's whole-step kernel, as
the program reports it (the CLI summary's ``step_kernel["block_fill"]``):
the ocean columns over the column slots of the launch's blocks that hold
at least one, in the order its blocks take their columns.  A block holds
its SM's warp slots until its slowest column is done, and a land column's
warp idles meanwhile, so a fill under 1 is held warp slots that do no
work.  None where the program reports no fill."""


def read(run):
    fill = (run.summary.get("step_kernel") or {}).get("block_fill")
    return None if fill is None else float(fill)
