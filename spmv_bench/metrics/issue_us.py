"""The median host time to issue one SpMV call, from bursts too short to
fill the launch queue, with no synchronize inside a burst, in us."""

import statistics


def read(run):
    if not run.issue_s:
        return None
    return statistics.median(run.issue_s) * 1e6
