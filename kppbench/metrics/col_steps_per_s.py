"""col_steps_per_s: every grid column (land included, as the CLI counts
them) times the window's N steps over the window's seconds on the host's
clock (the end of the timed run's Initialization timer to the return of
``cli.run``, after its last flush and restart)."""


def read(run):
    return run.ncol * run.steps / run.window_s
