"""Device us an iteration that rank 0 spends in the collectives' kernels
(every device operation whose name starts with "nccl": the halo's sends
and receives, the dots' all-gathers, the loop's agreement), over the
traced window's iterations. A kernel of a collective runs until every
rank has joined it, so the time includes the wait for a slower rank.
Only rank 0 is traced."""

PREFIX = "nccl"


def read(run):
    t, iters = run.trace, run.counts.get("traced_iters")
    if t is None or not iters:
        return None
    s = t.device_s_of(PREFIX)
    return s / iters * 1e6 if s > 0 else None
