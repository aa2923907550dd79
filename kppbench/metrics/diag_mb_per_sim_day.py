"""diag_mb_per_sim_day: the CLI summary's ``bytes_written`` (every
diagnostic file of the timed run) in MB (1e6 bytes) over the simulated
days of its N steps."""


def read(run):
    days = run.steps * run.dto / 86400.0
    return run.summary["bytes_written"] / 1e6 / days
