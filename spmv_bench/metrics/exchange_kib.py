"""KiB that rank 0 sends plus receives in one SpMV's exchange of x, from
the placed layout: its halo rows, both ways, at each boundary with
another process's shard, or the whole padded x where the layout gathers
x instead."""


def read(run):
    b = run.counts.get("exchange_bytes")
    return None if b is None else b / 2**10
