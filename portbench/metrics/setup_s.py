"""Set-up time: from the start of the run's script to the first timed
unit (imports, the card, kernel loads or builds, inputs, warm-up)."""


def read(run):
    return run.setup_s
