"""Lower-triangular solve over D row shards by block forward
substitution: the port of `tpu_spmv/dist/sts.py`.

    for d in 0..D-1:                       # a chain, shard after shard
        x_d = solve(L_dd, b_d - L_d,<d @ x_<d)

The pack-padded strict-L system of sts/solve.py (rows already in
dependency order) is cut into D blocks of rows_per_shard rows, a
multiple of 8 * 128, so no solve chunk straddles two shards. Shard d
holds its diagonal block L_dd (columns in its own rows, local
coordinates), solved by `lower_solve_blocks`, and its off-diagonal block
L_d,<d (columns in earlier shards, global padded coordinates, n =
padded_m), a SELL SpMV by `spmv_sell`; both are pre-scaled by 1/diag as
the single-device layout is, so each step is one subtraction between the
two kernels.

The layout holds the reference's stacked arrays on the host, equal array
for array, and one port container a shard built from its slice: the
diagonal block with its wait table (formats/sell.wait_fields) and the
plain version's step table (kernels/sts.solve_steps, from the packs'
chunk ranges when the system is known), the off-diagonal block with its
segment table. Those tables end at the shard's real sub-tiles: the
stacks' padding (sub_chunk = num_chunks_local) is never walked.

The reference runs every step on every device and keeps the owner's
result (a `where`, to stay SPMD). Here step d runs on shard d only, on
shard d's stream, after steps 0..d-1: each step's stream waits on the
one before, all forked from the caller's current stream and joined back
to it (dist/sharding._forked), so one solve (and a PCG iteration of
two) is captured in one CUDA graph when the shards share a card. x is
one padded_m buffer a device: on one card the all-gather costs nothing,
as shard d's slice is a view of it; on D cards, step d first copies the
rows [0, d * R) it lacks to its card. Across processes every process
walks the D steps in the same order: the owner of step d runs it and
broadcasts its rows over the process group as it ends, and every other
process receives them into its first shard's buffer, so the later steps
find them there and every process ends with every row.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from tpu_spmv_torch.dist import group
from tpu_spmv_torch.dist.sharding import (
    RowMesh, _check_mesh, _forked, _on, _round_up, local_sell, placed,
    stack_sell,
)
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import LANES, SUBLANES, SellSlabs, to_tensor
from tpu_spmv_torch.kernels import sell as ksell
from tpu_spmv_torch.kernels import sts as ksts
from tpu_spmv_torch.sts.host import TriangularSystem
from tpu_spmv_torch.sts.solve import _round_up_arr, _with_waits


def local_steps(chunk_ptr, pack_chunk_ptr, c0: int, num_chunks: int):
    """The plain version's step table of a block of num_chunks chunks that
    starts at global chunk c0: the packs' chunk boundaries cut to the
    block (a pack's rows are mutually independent, so any run of its
    chunks is a step), plus the block's end; chunk by chunk without
    pack_chunk_ptr."""
    if pack_chunk_ptr is None:
        return ksts.solve_steps(chunk_ptr)
    cuts = np.clip(np.asarray(pack_chunk_ptr, np.int64) - c0, 0, num_chunks)
    return ksts.solve_steps(chunk_ptr, np.unique(
        np.concatenate([[0], cuts, [num_chunks]])))


@dataclasses.dataclass
class ShardedLowerSolve:
    """Per-shard diagonal-solve and off-diagonal SpMV layouts, stacked on
    a leading axis of D (host tensors, equal to the reference's arrays),
    and the port's containers a shard (see the module docstring).
    pack_chunk_ptr: the global chunk boundary of each pack (None when
    the system is unknown: the plain versions then step chunk by chunk).
    """

    # Diagonal block: strict-L columns inside the shard (local coords).
    dvals: torch.Tensor
    dcols: torch.Tensor
    dsub_b0: torch.Tensor
    dsub_nb: torch.Tensor
    dsub_chunk: torch.Tensor
    # Off-diagonal block: columns in earlier shards (global padded
    # coords), values pre-scaled by the owning row's inv_diag.
    ovals: torch.Tensor
    ocols: torch.Tensor
    osub_b0: torch.Tensor
    osub_nb: torch.Tensor
    osub_chunk: torch.Tensor
    b_scale: torch.Tensor  # (D, num_chunks_local + 1, 128)
    inv_diag: torch.Tensor  # (D, num_chunks_local + 1, 128)
    m: int
    padded_m: int
    rows_per_shard: int
    num_chunks_local: int
    d_max_nb: int
    o_max_nb: int
    n_devices: int
    pack_chunk_ptr: np.ndarray | None = None
    diag: list = None  # SellSlabs a shard, with its wait table
    off: list = None  # SellSlabs a shard (n = padded_m)
    steps: list = None  # the plain solve's step table a shard
    b_local: list = None  # b_scale[d], placed with the shard
    inv_local: list = None  # inv_diag[d], placed with the shard

    def __post_init__(self):
        if self.diag is not None:
            return
        D, R, nc = self.n_devices, self.rows_per_shard, self.num_chunks_local
        dstack = (self.dvals, self.dcols, self.dsub_b0, self.dsub_nb,
                  self.dsub_chunk)
        ostack = (self.ovals, self.ocols, self.osub_b0, self.osub_nb,
                  self.osub_chunk)
        self.diag = [_with_waits(local_sell(dstack, d, R, R, nc,
                                            self.d_max_nb)) for d in range(D)]
        self.off = [local_sell(ostack, d, R, self.padded_m, nc,
                               self.o_max_nb) for d in range(D)]
        self.steps = [local_steps(s.chunk_ptr, self.pack_chunk_ptr, d * nc, nc)
                      for d, s in enumerate(self.diag)]
        self.b_local = list(self.b_scale)
        self.inv_local = list(self.inv_diag)

    def device_put(self, mesh: RowMesh, axis="rows") -> "ShardedLowerSolve":
        """This layout with shard d's containers on mesh.devices[d] (None
        for a shard of another process)."""
        _check_mesh(self, mesh, axis)
        out = copy.copy(self)
        out.diag = placed(self.diag, mesh)
        out.off = placed(self.off, mesh)
        out.b_local = placed(self.b_local, mesh)
        out.inv_local = placed(self.inv_local, mesh)
        return out

    @classmethod
    def build(cls, sys: TriangularSystem, b: np.ndarray,
              n_devices: int) -> tuple["ShardedLowerSolve", np.ndarray]:
        """Returns (layout, pad_index). pad_index maps the system's
        permuted rows into the flattened (padded_m,) solution: apply it
        on the host after the solve."""
        L = sys.lower
        m = L.m
        lens = L.row_lengths
        if not np.all(lens >= 1):
            raise ValueError("lower factor has an empty row")
        diag_pos = L.indptr[1:].astype(np.int64) - 1
        diag = L.data[diag_pos]
        if np.any(diag == 0.0):
            raise ValueError("zero diagonal entry; system is singular")
        inv_diag = (1.0 / diag).astype(np.float32)

        # Global pack padding (as LowerSolveLayout.build pads).
        pack_sizes = np.diff(sys.pack_ptr)
        padded_sizes = np.maximum(_round_up_arr(pack_sizes, LANES), LANES)
        pad_start = np.zeros(sys.num_packs + 1, dtype=np.int64)
        np.cumsum(padded_sizes, out=pad_start[1:])
        m_pad = int(pad_start[-1])
        row_pack = np.repeat(np.arange(sys.num_packs, dtype=np.int64),
                             pack_sizes)
        pad_index = pad_start[row_pack] + (
            np.arange(m, dtype=np.int64) - sys.pack_ptr[row_pack]
        )

        # Shard boundaries on whole solve chunks (8 * 128 rows).
        rows_per_shard = _round_up(
            _round_up(m_pad, n_devices) // n_devices, SUBLANES * LANES
        )
        padded_m = rows_per_shard * n_devices
        num_chunks_local = rows_per_shard // LANES

        # Strict lower in padded coordinates, b scaled by inv_diag (in
        # float64, then cast, as the reference scales it). Padding rows
        # have no entries and b = 0, so they solve to x = 0.
        keep = np.ones(L.nnz, dtype=bool)
        keep[diag_pos] = False
        row_of = np.repeat(np.arange(m, dtype=np.int64), lens)[keep]
        rows_p = pad_index[row_of]
        cols_p = pad_index[L.indices[keep].astype(np.int64)]
        vals = (L.data[keep].astype(np.float64) * inv_diag[row_of]).astype(
            np.float32)
        b_pad = np.zeros(padded_m, np.float32)
        b_pad[pad_index] = np.asarray(b, np.float64) * inv_diag

        def block(rows_b, cols_b, vals_b, n_cols):
            indptr = np.zeros(rows_per_shard + 1, np.int64)
            np.add.at(indptr, rows_b + 1, 1)
            np.cumsum(indptr, out=indptr)
            return CSRMatrix(indptr.astype(np.int32), cols_b.astype(np.int32),
                             vals_b.astype(np.float32),
                             (rows_per_shard, n_cols))

        # (rows_p, cols_p) stay row-major with ascending columns: the
        # repeat keeps row order and pad_index is increasing.
        d_shards, o_shards = [], []
        for d in range(n_devices):
            r0, r1 = d * rows_per_shard, (d + 1) * rows_per_shard
            sel = (rows_p >= r0) & (rows_p < r1)
            rd, cd, vd = rows_p[sel] - r0, cols_p[sel], vals[sel]
            in_diag = cd >= r0
            if not np.all(cd < r1):
                raise ValueError("strict-L entry above the diagonal block")
            d_shards.append(SellSlabs.from_csr(block(
                rd[in_diag], cd[in_diag] - r0, vd[in_diag], rows_per_shard)))
            o_shards.append(SellSlabs.from_csr(block(
                rd[~in_diag], cd[~in_diag], vd[~in_diag], padded_m)))

        (dv, dc, db0, dnb, dch), d_max_nb = stack_sell(d_shards,
                                                        num_chunks_local)
        (ov, oc, ob0, onb, och), o_max_nb = stack_sell(o_shards,
                                                        num_chunks_local)
        shape = (n_devices, num_chunks_local + 1, LANES)
        b_blocks = np.zeros(shape, np.float32)
        b_blocks[:, :num_chunks_local] = b_pad.reshape(
            n_devices, num_chunks_local, LANES)
        inv_pad = np.zeros(padded_m, np.float32)
        inv_pad[pad_index] = inv_diag
        inv_blocks = np.zeros(shape, np.float32)
        inv_blocks[:, :num_chunks_local] = inv_pad.reshape(
            n_devices, num_chunks_local, LANES)
        return cls(
            dvals=dv, dcols=dc, dsub_b0=db0, dsub_nb=dnb, dsub_chunk=dch,
            ovals=ov, ocols=oc, osub_b0=ob0, osub_nb=onb, osub_chunk=och,
            b_scale=to_tensor(b_blocks), inv_diag=to_tensor(inv_blocks),
            m=m, padded_m=padded_m, rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local, d_max_nb=d_max_nb,
            o_max_nb=o_max_nb, n_devices=n_devices,
            pack_chunk_ptr=pad_start // LANES,
        ), pad_index


def _check_rhs(layout: ShardedLowerSolve, b, mesh: RowMesh) -> None:
    if len(b) != layout.n_devices or any(
            (t is None) != (dev is None) or t is not None and (
                t.shape != (layout.rows_per_shard,) or t.device != dev)
            for t, dev in zip(b, mesh.devices)):
        got = [t if t is None else (tuple(t.shape), str(t.device)) for t in b]
        raise ValueError(
            f"b must be {layout.n_devices} shards of {layout.rows_per_shard} "
            f"rows on the mesh's devices (shard_vector), got {got}")


def solve_buffers(layout: ShardedLowerSolve, mesh: RowMesh, b=None,
                  plain: bool = False) -> dict:
    """The solve (see sts_solve_sharded); returns {device: its (padded_m,)
    x buffer} for this process's devices. Shard d's rows are final in the
    buffer of its device. In one process the last shard's device holds
    every row; across processes, this process's first shard's device."""
    D, R, nc = layout.n_devices, layout.rows_per_shard, layout.num_chunks_local
    if b is not None:
        _check_rhs(layout, b, mesh)
    off_fn = ksell.spmv_sell_reference if plain else ksell.spmv_sell
    solve_fn = (ksts.lower_solve_blocks_reference if plain
                else ksts.lower_solve_blocks)
    home = mesh.home
    # Allocated on the callers' streams, which the shard streams fork from.
    bufs = {mesh.devices[d]: torch.zeros(layout.padded_m, dtype=torch.float32,
                                         device=mesh.devices[d])
            for d in mesh.local}
    have = {dev: set() for dev in bufs}  # shards whose rows each holds

    def holder(k):  # the buffer that holds shard k's rows
        dev = mesh.devices[k]
        return bufs[home if dev is None else dev]

    def chained(dev):  # dev's current stream after steps 0..d-1
        if dev.type != "cuda":
            return None
        cur = torch.cuda.current_stream(dev)
        if prev is not None:
            cur.wait_stream(prev)
        return cur

    prev = None
    with _forked(mesh, mesh.streams):
        for d, (dev, s) in enumerate(zip(mesh.devices, mesh.streams)):
            rows = slice(d * R, (d + 1) * R)
            if dev is None:  # another process's step: its rows arrive
                prev = chained(home)
                group.broadcast_(mesh, bufs[home][rows], mesh.owner(d))
                have[home].add(d)
                continue
            with _on(s):
                rhs = torch.empty((nc + 1, LANES), dtype=torch.float32,
                                  device=dev)
                if b is None:
                    rhs.copy_(layout.b_local[d])
                else:
                    torch.mul(b[d].view(nc, LANES), layout.inv_local[d][:nc],
                              out=rhs[:nc])
                    rhs[nc].zero_()
                cur = chained(dev)
                x = bufs[dev]
                for k in range(d):  # the rows of earlier shards it lacks
                    if k not in have[dev]:
                        lk = slice(k * R, (k + 1) * R)
                        x[lk].copy_(holder(k)[lk], non_blocking=True)
                        have[dev].add(k)
                corr = off_fn(layout.off[d], x)
                rhs[:nc] -= corr.view(nc, LANES)
                xd = solve_fn(layout.diag[d], rhs, layout.steps[d])
                x[rows].copy_(xd[:nc].view(-1))
                have[dev].add(d)
                if mesh.world > 1:
                    group.broadcast_(mesh, x[rows], mesh.rank)
                prev = cur
    if mesh.world > 1:  # this process's rows on its other devices
        for k in mesh.local:
            if k not in have[home]:
                lk = slice(k * R, (k + 1) * R)
                bufs[home][lk].copy_(holder(k)[lk], non_blocking=True)
    return bufs


def sts_solve_sharded(layout: ShardedLowerSolve, mesh: RowMesh, axis="rows",
                      b=None, plain: bool = False) -> list:
    """Solve L x = b over the mesh; returns x as D shards of
    rows_per_shard rows in the padded system coordinates (on one card,
    views of one buffer; None for a shard of another process). On the
    host: gather_vector(x, mesh)[pad_index].

    b: an optional fresh right-hand side, D shards of rows_per_shard rows,
    unscaled, in the padded system coordinates (scatter through pad_index
    first); it overrides the build-time b_scale and is scaled by inv_diag
    here, in float32, as the reference scales it. plain=True runs the
    kernels' plain versions on the same schedule."""
    _check_mesh(layout, mesh, axis)
    bufs = solve_buffers(layout, mesh, b, plain)
    R = layout.rows_per_shard
    return [None if dev is None else bufs[dev][d * R:(d + 1) * R]
            for d, dev in enumerate(mesh.devices)]


def solve_whole(layout: ShardedLowerSolve, mesh: RowMesh, b=None,
                plain: bool = False) -> torch.Tensor:
    """The solve's x, every padded_m row, on this process's first shard's
    device (one chain of ShardedIC0Preconditioner)."""
    bufs = solve_buffers(layout, mesh, b, plain)
    full = mesh.home if mesh.world > 1 else mesh.devices[-1]
    return bufs[full].to(mesh.home, non_blocking=True)


def from_reference(layout, sys: TriangularSystem | None = None
                   ) -> ShardedLowerSolve:
    """The port's ShardedLowerSolve for the JAX package's (its stacked
    arrays read through NumPy), on the host; device_put places it. With
    `sys`, the system it was built from, the plain versions step pack by
    pack; without, chunk by chunk."""
    fields = {}
    for f in dataclasses.fields(ShardedLowerSolve):
        if not hasattr(layout, f.name):
            continue
        v = getattr(layout, f.name)
        fields[f.name] = v if isinstance(v, int) else to_tensor(v)
    if sys is not None:
        padded = np.maximum(_round_up_arr(np.diff(sys.pack_ptr), LANES), LANES)
        fields["pack_chunk_ptr"] = np.concatenate(
            [[0], np.cumsum(padded // LANES)])
    return ShardedLowerSolve(**fields)


__all__ = ["ShardedLowerSolve", "from_reference", "solve_buffers",
           "solve_whole", "sts_solve_sharded"]
