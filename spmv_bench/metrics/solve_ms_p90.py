"""The 90th percentile of the window's solve times (each from its start
to the read that ends it), in ms."""

import numpy as np


def read(run):
    if not run.solve_s:
        return None
    return float(np.percentile(run.solve_s, 90)) * 1e3
