"""Host seconds of the port's group start on rank 0
(`multihost.initialize`: the TCP store, every rank's arrival, the NCCL
communicator and its first collective), timed by the benchmark around
the call."""


def read(run):
    return run.spans.get("group.start")
