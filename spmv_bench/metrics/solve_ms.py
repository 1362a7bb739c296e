"""The window over the solves completed, in ms."""


def read(run):
    solves = run.counts.get("solves")
    if not solves:
        return None
    return run.window_s / solves * 1e3
