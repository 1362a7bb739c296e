"""The exchange between processes: the collectives and point-to-point
copies the sharded calls make over a RowMesh's process group, where the
reference's `ppermute`s, all-gathers and `psum`s cross hosts.

multihost.initialize starts the group: NCCL when every process has a
card of its own, gloo on the CPU or when processes share a card. NCCL
takes tensors on the card, orders its work after the caller's current
stream and makes that stream wait for it, so nothing here blocks the
host. gloo's point-to-point calls take host tensors only, so under gloo a
tensor on a card is staged through host memory here, for every operation
alike: the call then blocks the host until its data have arrived, and a
loop over it runs eagerly (no CUDA graph can hold a host call).

Every process must make the same calls in the same order, including for
shards it does not own; a missed call hangs until the group's timeout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(mesh, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and mesh.backend == "gloo"


def all_gather_rows(mesh, local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` (one shape on all of them) joined along
    dim 0 in rank order, on local's device."""
    src = local.contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    out = src.new_empty((mesh.world * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    return out.to(local.device) if staged else out


def broadcast_(mesh, t: torch.Tensor, src: int) -> None:
    """Overwrite t (contiguous, one shape on every process) with process
    src's t."""
    if not _staged(mesh, t):
        dist.broadcast(t, src, group=mesh.group)
        return
    buf = t.cpu() if mesh.rank == src else torch.empty(t.shape,
                                                       dtype=t.dtype)
    dist.broadcast(buf, src, group=mesh.group)
    if mesh.rank != src:
        t.copy_(buf)


def exchange(mesh, sends, recvs) -> None:
    """Post every send and receive, each (tensor, peer rank, tag), in one
    batch (dist.batch_isend_irecv) and wait for all of them; a receive
    overwrites its tensor. Each pair of processes must list its messages
    in the same order on both sides."""
    staged = [_staged(mesh, t) for t, _, _ in recvs]
    wire_recvs = [(torch.empty(t.shape, dtype=t.dtype) if s else t, peer, tag)
                  for (t, peer, tag), s in zip(recvs, staged)]
    ops = [dist.P2POp(dist.isend, t.cpu() if _staged(mesh, t) else t, peer,
                      mesh.group, tag) for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, mesh.group, tag)
            for t, peer, tag in wire_recvs]
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for (t, _, _), (w, _, _), s in zip(recvs, wire_recvs, staged):
        if s:
            t.copy_(w)


__all__ = ["all_gather_rows", "broadcast_", "exchange"]
