"""setup_s: the host's seconds from the process's start to the window's
start: imports, the inputs, the warm run (which builds the kernel library
on a checkout's first run) and the timed run's Initialization."""


def read(run):
    return run.setup_s
