"""Process start to the first timed step (the loop's `setup_done`)."""


def read(run):
    return run.setup_s
