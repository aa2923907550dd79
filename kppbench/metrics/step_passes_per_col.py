"""step_passes_per_col: the program's ``step.passes`` counter (the passes
each ocean column ran in each step of the timed run, from the step
kernel's per-column output, summed on the device and read once after the
run's last synchronise) over the window's ocean column-steps (the CLI
summary's ``ocean_columns`` x N).  None where the program keeps no such
counter."""


def read(run):
    passes = (run.summary.get("counters") or {}).get("step.passes")
    ocean = run.summary.get("ocean_columns")
    if passes is None or not ocean or not run.steps:
        return None
    return passes / (ocean * run.steps)
