"""The (hosts, rows) mesh and the process group: the port of
`tpu_spmv/dist/multihost.py`.

`initialize` reads the reference's arguments and environment variables
(TPU_SPMV_NUM_PROCESSES, TPU_SPMV_COORDINATOR, TPU_SPMV_PROCESS_ID). One
process returns False and starts nothing. More than one starts a
torch.distributed process group over a TCP store at the coordinator
(what init_method="tcp://host:port" builds) and returns True; a second
call returns True. Unlike jax.distributed on a TPU pod, torch cannot
detect the number of processes, so a coordinator without it raises.

The backend follows a rule, not a fallback: gloo when a process runs on
the CPU; NCCL when every process has a card of its own; gloo when
processes share a card, since an NCCL communicator refuses two ranks on
one device. Before the group starts each process publishes its device
(host name and the card's UUID) on the store and reads the others', so
every process takes the same backend; a failed NCCL start raises.

`make_hybrid_mesh` lays the devices out as (hosts, rows), hosts-major:
row shard h * R + r lies on device r of host h, and a sharded call over
the tuple axis ("hosts", "rows") shards rows over both (`row_spec`), as
the reference's PartitionSpec((hosts, rows)) does. The layouts and calls
of dist/sharding.py, dist/sts.py and sts/ic0.py take that axis as they
take "rows" (`sharding.mesh_axis_size` multiplies the named axes). In
one process the host axis is a label: a (2, D / 2) mesh runs the
schedule a two-host deployment would, as the reference simulates it on
virtual CPU devices. Over several processes each process is a host and
holds its own devices' shards; the exchange between hosts goes over the
process group (dist/group.py).
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from tpu_spmv_torch.dist.sharding import RowMesh, make_row_mesh

# How long a collective, or the start of the group, waits for every
# process before it raises: a process that failed or took another path
# ends the run instead of hanging it.
GROUP_TIMEOUT_S = 300.0


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str | None:
    """The group's backend, "gloo" or "nccl"; None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def process_device(rank: int, device=None) -> torch.device:
    """The device of process `rank`: `device`, where a card without an
    index (and None) means card rank % device_count. Raises RuntimeError
    for a card when none is present (pass "cpu")."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" for the '
                               "plain versions")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _identity(device: torch.device) -> str:
    if device.type != "cuda":
        return f"{socket.gethostname()}/cpu"
    uuid = torch.cuda.get_device_properties(device).uuid
    return f"{socket.gethostname()}/cuda/{uuid}"


def choose_backend(identities) -> str:
    """The backend every process takes, from every process's device
    identity ("host/cpu" or "host/cuda/uuid"): gloo when any runs on the
    CPU or two share a card, else NCCL."""
    if any("/cuda/" not in i for i in identities):
        return "gloo"
    return "nccl" if len(set(identities)) == len(identities) else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """False for a single process (the arguments, or the reference's
    variables TPU_SPMV_NUM_PROCESSES, TPU_SPMV_COORDINATOR and
    TPU_SPMV_PROCESS_ID, name no other). Else starts the process group
    of num_processes processes at coordinator_address ("host:port";
    process 0 listens there), this one of rank process_id on `device`
    (process_device), and returns True; True again once started.
    Raises ValueError when the count, the coordinator or the rank is
    missing."""
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
    if dist.is_initialized():
        return True
    for value, name in ((num_processes, "TPU_SPMV_NUM_PROCESSES"),
                        (coordinator_address, "TPU_SPMV_COORDINATOR"),
                        (process_id, "TPU_SPMV_PROCESS_ID")):
        if value is None:
            raise ValueError(
                f"a process group needs {name} (or its argument): torch "
                "cannot detect the processes' count, coordinator or rank")
    dev = process_device(process_id, device)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout)
    store.set(f"tpu_spmv/device/{process_id}", _identity(dev))
    name = choose_backend([
        store.get(f"tpu_spmv/device/{r}").decode()
        for r in range(num_processes)])
    if name == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        name, store=store, rank=process_id, world_size=num_processes,
        timeout=timeout, device_id=dev if name == "nccl" else None)
    # One collective now: every process has joined, and NCCL's
    # communicator exists before any capture or point-to-point batch.
    dist.all_reduce(torch.zeros(1, device=dev if name == "nccl" else "cpu"))
    return True


def make_hybrid_mesh(axis_hosts: str = "hosts", axis_rows: str = "rows",
                     num_hosts: int | None = None, devices=None) -> RowMesh:
    """A (num_hosts, per_host) RowMesh named (axis_hosts, axis_rows),
    flattened hosts-major.

    In one process: over `devices` (default: every CUDA card; e.g.
    ["cpu"] * 8 for the plain versions), num_hosts default 1; devices
    past num_hosts * per_host are left out, as the reference leaves them.

    In a process group: num_hosts is the number of processes (its
    default; another raises ValueError), `devices` this process's
    (default: process_device), per_host = len(devices), the same on
    every process; global shard h * per_host + r lies on process h's
    device r."""
    world, rank = process_count(), process_index()
    if world == 1:
        base = make_row_mesh(devices)
        num_hosts = num_hosts or 1
        per_host = base.size // num_hosts
        keep = num_hosts * per_host
        return RowMesh(base.devices[:keep], base.streams[:keep],
                       base.halo_streams[:keep], shape=(num_hosts, per_host),
                       axis_names=(axis_hosts, axis_rows))
    if num_hosts not in (None, world):
        raise ValueError(f"over {world} processes the host axis is the "
                         f"processes; num_hosts={num_hosts}")
    local = make_row_mesh([process_device(rank)] if devices is None
                          else devices)
    per_host = local.size

    def spread(items):
        out = [None] * (world * per_host)
        out[rank * per_host:(rank + 1) * per_host] = items
        return out

    return RowMesh(spread(local.devices), spread(local.streams),
                   spread(local.halo_streams), shape=(world, per_host),
                   axis_names=(axis_hosts, axis_rows), rank=rank,
                   world=world)


def row_spec(axis_hosts: str = "hosts", axis_rows: str = "rows") -> tuple:
    """The axis that shards rows over both mesh axes, hosts-major: pass
    it as `axis` to the sharded calls."""
    return (axis_hosts, axis_rows)


__all__ = ["backend", "choose_backend", "initialize", "make_hybrid_mesh",
           "process_count", "process_device", "process_index", "row_spec"]
