"""init_s: the CLI's Initialization timer of the timed run (namelist,
input reads, the model's set-up and the initial mixing pass), seconds."""


def read(run):
    return run.init_s
