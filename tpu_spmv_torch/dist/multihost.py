"""The (hosts, rows) mesh in one process: the one-process half of
`tpu_spmv/dist/multihost.py`.

`make_hybrid_mesh` lays the devices out as (hosts, rows), hosts-major:
row shard h * R + r lies on devices[h * R + r], and a sharded call over
the tuple axis ("hosts", "rows") shards rows over both (`row_spec`), as
the reference's PartitionSpec((hosts, rows)) does. The layouts and
calls of dist/sharding.py, dist/sts.py and sts/ic0.py take that axis as
they take "rows" (`sharding.mesh_axis_size` multiplies the named axes).
In one process the host axis is a label: the exchange between two shards
is the same copy whichever axis separates them, so a (2, D / 2) mesh runs
the schedule a two-host deployment would, as the reference simulates it
on virtual CPU devices.

`initialize` reads the reference's environment variables. One process is
the only mode the port runs: more than one is refused, naming ROADMAP
item A13d (a torch.distributed process group for the exchange).
"""

from __future__ import annotations

import os

from tpu_spmv_torch.dist.sharding import RowMesh, make_row_mesh

# The port's refusal of more than one process.
REFUSED = "A13d (multi-process torch.distributed)"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """False for a single process (the arguments, or the reference's
    variables TPU_SPMV_NUM_PROCESSES, TPU_SPMV_COORDINATOR and
    TPU_SPMV_PROCESS_ID, name no other); more than one process raises
    SystemExit naming ROADMAP item A13d."""
    if num_processes is None:
        num_processes = int(
            os.environ.get("TPU_SPMV_NUM_PROCESSES", "0")) or None
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPU_SPMV_COORDINATOR") or None
    if process_id is None:
        pid = os.environ.get("TPU_SPMV_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if num_processes in (None, 1) and coordinator_address is None:
        return False
    raise SystemExit(
        f"multi-process mode ({num_processes or '?'} processes, coordinator "
        f"{coordinator_address}, process {process_id}) is not ported to the "
        f"GPU yet (ROADMAP.md item {REFUSED}); run one process, with the "
        "shards on its cards"
    )


def make_hybrid_mesh(axis_hosts: str = "hosts", axis_rows: str = "rows",
                     num_hosts: int | None = None, devices=None) -> RowMesh:
    """A (num_hosts, per_host) RowMesh named (axis_hosts, axis_rows) over
    `devices` (default: every CUDA card; e.g. ["cpu"] * 8 for the plain
    versions), flattened hosts-major. num_hosts defaults to 1 (one
    process); devices past num_hosts * per_host are left out, as the
    reference leaves them."""
    base = make_row_mesh(devices)
    num_hosts = num_hosts or 1
    per_host = base.size // num_hosts
    keep = num_hosts * per_host
    return RowMesh(base.devices[:keep], base.streams[:keep],
                   base.halo_streams[:keep], shape=(num_hosts, per_host),
                   axis_names=(axis_hosts, axis_rows))


def row_spec(axis_hosts: str = "hosts", axis_rows: str = "rows") -> tuple:
    """The axis that shards rows over both mesh axes, hosts-major: pass
    it as `axis` to the sharded calls."""
    return (axis_hosts, axis_rows)


__all__ = ["initialize", "make_hybrid_mesh", "row_spec"]
