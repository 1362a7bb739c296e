"""Process start to the first timed call, in s."""


def read(run):
    return run.setup_s
