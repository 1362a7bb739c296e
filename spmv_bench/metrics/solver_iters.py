"""The mean iterations a solve in the window, counted by the
benchmark's loop."""


def read(run):
    solves = run.counts.get("solves")
    if not solves:
        return None
    return run.counts["iters"] / solves
