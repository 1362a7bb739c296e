"""2 nnz(A) x the calls completed, over the whole window (which ends at
the synchronize that drains the queue), in GFLOP/s."""


def read(run):
    calls = run.counts.get("calls")
    if not calls:
        return None
    return 2.0 * run.nnz * calls / run.window_s / 1e9
