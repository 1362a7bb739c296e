"""Row-sharded SpMV and SpMM over a list of devices, with the halo
exchange and its overlap: the port of `tpu_spmv/dist/sharding.py`.

Rows are cut into D equal blocks, each a multiple of 8 * 128 rows; shard
d owns block d and runs the single-device kernel (spmv_ranked, spmv_sell,
spmm_ranked or spmm_ranked_windowed) on it. x arrives row-sharded like
y, as a list of D tensors. Each shard needs the window of x its columns
read: after RCM, its own rows plus a narrow band, so the default
exchange copies H rows from each neighbour into a per-shard window
buffer [left H | own rows | right H] (the reference's two `ppermute`s);
a matrix whose columns reach past the neighbours gathers x whole
instead. Columns are shifted into window coordinates when the layout is
built.

The mesh (`make_row_mesh`) is a list of D torch devices plus, on a card,
the shards' CUDA streams: shard 0's kernels run on the caller's current
stream, shard d's (d > 0) on a stream of its own, and each shard's
overlap halo copies on a halo stream. Every sharded call forks its
streams from the caller's current stream and joins them back before it
returns, so its results are ordered after everything the caller queued
and before anything it queues next, and one call (or a CG iteration of
several) can be captured in a CUDA graph. The same code runs when
shards share one card (`[cuda:0] * 4`) and when each has its own; on the
CPU (`["cpu"] * D`) the shards run one after the other through the
kernels' plain versions.

A sharded layout holds the reference's stacked arrays, shard by shard
on a leading axis of D (padded to common shapes, equal to the JAX
package's on the same matrix), on the host, and one port container per
shard built from its slice of them (with the port's segment, run and
window tables); `device_put(mesh)` moves shard d's container to
mesh.devices[d]. A sharded vector is a list of D tensors
(`shard_vector`, `gather_vector`).

Over several processes (a mesh from multihost.make_hybrid_mesh after
multihost.initialize), each process builds the same host layout and
places only its own shards; a shard of another process is None in every
list, and every loop walks this process's shards (`RowMesh.local`) by
their global index. The halo rows that cross a process boundary, and x
gathered whole, move over the process group (dist/group.py) before any
kernel reads them; a neighbour on the same process is still a copy.

Every call takes plain=True to run the kernels' plain versions on the
same exchange (the check of each kernel against its plain version on
the card).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import types

import numpy as np
import torch
import torch.distributed as dist

from tpu_spmv_torch import obs
from tpu_spmv_torch.dist import group
from tpu_spmv_torch.formats.convert import ranked_container, sell_container
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import (
    LANES, SUBLANES, RankedSlabs, SellSlabs, to_tensor,
)
from tpu_spmv_torch.kernels import sell, spmm
from tpu_spmv_torch.kernels.sell import resident_x_fits


@dataclasses.dataclass
class RowMesh:
    """D devices along the row axis, with the streams of the shards that
    lie on a card: `streams[d]` runs shard d's kernels (None: the
    caller's current stream, this process's first shard's; and every
    shard's on the CPU), `halo_streams[d]` its overlap halo copies.
    `shape` and `axis_names` name the mesh's axes as the reference's Mesh
    does: ("rows",) over D by default, ("hosts", "rows") over (H, D / H)
    from multihost.make_hybrid_mesh, whose `devices` are the mesh
    flattened hosts-major, the order rows are sharded in over the tuple
    axis.

    Over several processes (multihost.make_hybrid_mesh after
    multihost.initialize), `world` processes of rank 0..world-1 hold D /
    world shards each, hosts-major: shard d lies on process d // (D /
    world), and devices[d], streams[d] and halo_streams[d] are None for a
    shard of another process. `group` is the process group (None: the
    default one)."""

    devices: list
    streams: list
    halo_streams: list
    shape: tuple = None
    axis_names: tuple = ("rows",)
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        if self.shape is None:
            self.shape = (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> list:
        """The global indices of this process's shards."""
        return [d for d, dev in enumerate(self.devices) if dev is not None]

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[self.local[0]]

    def owner(self, d: int) -> int:
        """The rank of the process that holds shard d."""
        return d // (self.size // self.world)

    @property
    def backend(self) -> str | None:
        """The process group's backend ("gloo" or "nccl"); None in one
        process."""
        return dist.get_backend(self.group) if self.world > 1 else None


def make_row_mesh(devices=None) -> RowMesh:
    """A RowMesh over `devices` (torch devices or their names; default:
    every CUDA card, one shard each), its one axis named "rows". A device
    may repeat: D shards on one card each get their own streams. Shard 0
    runs on the caller's stream: a one-shard call forks nothing (a fork
    and join cost about 2.5 us in a CUDA graph on the H100)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the devices (e.g. "
                               "['cpu'] * D) for the plain versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]

    def streams():
        return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                for d in devices]

    return RowMesh(devices, [None, *streams()[1:]], streams())


def mesh_axis_size(mesh: RowMesh, axis="rows") -> int:
    """Devices under `axis`: a name, or a tuple of names whose sizes
    multiply (the multi-host ("hosts", "rows") case shards rows over
    both). A name the mesh lacks raises KeyError, as the reference's
    `mesh.shape[name]` does."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for name in names:
        if name not in mesh.axis_names:
            raise KeyError(f"mesh has no axis {name!r}; its axes are "
                           f"{mesh.axis_names}")
        size *= mesh.shape[mesh.axis_names.index(name)]
    return size


def _check_mesh(layout, mesh: RowMesh, axis="rows") -> None:
    D_mesh = mesh_axis_size(mesh, axis)
    if D_mesh != layout.n_devices:
        raise ValueError(
            f"layout was built for {layout.n_devices} shards but axis "
            f"{axis!r} spans {D_mesh} devices"
        )


def placed(items, mesh: RowMesh) -> list:
    """items[d] moved to mesh.devices[d] (anything with .to), None for a
    shard of another process."""
    return [None if dev is None else t.to(dev)
            for t, dev in zip(items, mesh.devices)]


def each(fn, *shards) -> list:
    """fn applied shard by shard to sharded vectors (lists of D), None
    where this process holds no shard."""
    return [None if v[0] is None else fn(*v) for v in zip(*shards)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _slice_shard_blocks(mat: CSRMatrix, n_devices: int, halo: str):
    """Cut rows into n_devices equal blocks (every sharded layout's cut).
    Returns (blocks, halo_rows, rows_per_shard); the blocks' columns are
    shifted into window coordinates when the neighbour exchange applies
    (tpu_spmv.dist.sharding._slice_shard_blocks)."""
    m, n = mat.shape
    rows_per_shard = _round_up(
        _round_up(m, n_devices) // n_devices, SUBLANES * LANES
    )
    # x travels as (padded_m,) row-sharded pieces: the all-gather
    # rebuilds at most padded_m columns, so a wider matrix would lose
    # its high columns. Refuse at build.
    if n > rows_per_shard * n_devices:
        raise ValueError(
            f"distributed layouts carry x in row-sharded (padded_m,) "
            f"pieces; n={n} exceeds padded_m="
            f"{rows_per_shard * n_devices} and the high columns would "
            f"be dropped — shard a square/narrower operator, or add "
            f"devices"
        )

    halo_rows = 0
    if halo != "never" and m == n and n_devices > 1:
        reach = 0
        for d in range(n_devices):
            r0 = min(d * rows_per_shard, m)
            r1 = min((d + 1) * rows_per_shard, m)
            cs = mat.indices[mat.indptr[r0] : mat.indptr[r1]]
            if cs.size:
                reach = max(
                    reach, int(r0 - cs.min()), int(int(cs.max()) + 1 - r1)
                )
        if reach <= rows_per_shard:
            halo_rows = _round_up(max(reach, LANES), LANES)
        elif halo == "always":
            raise ValueError(
                f"halo exchange requested but columns reach {reach} rows "
                f"past the shard (> rows_per_shard={rows_per_shard})"
            )

    blocks = []
    for d in range(n_devices):
        r0 = min(d * rows_per_shard, m)
        r1 = min((d + 1) * rows_per_shard, m)
        sl_indptr = (
            mat.indptr[r0 : r1 + 1].astype(np.int64) - int(mat.indptr[r0])
            if r1 > r0
            else np.zeros(1, dtype=np.int64)
        )
        pad_rows = rows_per_shard - (r1 - r0)
        if pad_rows:
            sl_indptr = np.concatenate(
                [sl_indptr, np.full(pad_rows, sl_indptr[-1], dtype=np.int64)]
            )
        cols_d = mat.indices[mat.indptr[r0] : mat.indptr[r1]].astype(np.int64)
        if halo_rows:
            cols_d = cols_d - (r0 - halo_rows)
        shard_n = rows_per_shard + 2 * halo_rows if halo_rows else n
        blocks.append(
            CSRMatrix(
                sl_indptr.astype(np.int32),
                cols_d.astype(np.int32),
                mat.data[mat.indptr[r0] : mat.indptr[r1]],
                (rows_per_shard, shard_n),
            )
        )
    return blocks, halo_rows, rows_per_shard


def _padk(a: torch.Tensor, target: int, fill) -> torch.Tensor:
    pad = target - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype)])


_SELL_FIELDS = ("vals", "cols", "sub_b0", "sub_nb", "sub_chunk")


def stack_sell(shards, num_chunks_local: int):
    """The shards' SellSlabs arrays stacked to common shapes, as the
    reference stacks them: ([vals, cols, sub_b0, sub_nb, sub_chunk],
    max_nb); padding slots hold 0, padding sub-tiles nb 1 and chunk
    num_chunks_local."""
    total_k = max(int(s.vals.shape[0]) for s in shards)
    S = max(s.num_subtiles for s in shards)
    out = []
    for name, fill in zip(_SELL_FIELDS, (0.0, 0, 0, 1, num_chunks_local)):
        target = total_k if name in ("vals", "cols") else S
        out.append(torch.stack([_padk(getattr(s, name), target, fill)
                                for s in shards]))
    return out, max(s.max_nb for s in shards)


def local_sell(stack, d: int, m: int, n: int, num_chunks: int, max_nb: int,
               nnz: int = 0, chunk_q: int = 0) -> SellSlabs:
    """Shard d's SellSlabs from the slices of a stack (vals, cols,
    sub_b0, sub_nb, sub_chunk), with its segment table; its tables end
    at the shard's real sub-tiles."""
    vals, cols, b0, nb, chunk = stack
    return sell_container(types.SimpleNamespace(
        vals=vals[d], cols=cols[d], sub_b0=b0[d], sub_nb=nb[d],
        sub_chunk=chunk[d].numpy(), m=m, n=n, nnz=nnz,
        num_chunks=num_chunks, max_nb=max_nb, chunk_q=chunk_q,
    ))


def _uniform_q(shards, S: int, num_chunks_local: int) -> int:
    """The shards' common chunk_q, or 0: padding to common shapes keeps
    per-shard uniformity only when every shard agrees."""
    q = shards[0].chunk_q
    same = all(s.chunk_q == q and s.num_subtiles == S
               and s.num_chunks == num_chunks_local for s in shards)
    return q if same else 0


class _Stacked:
    """What ShardedSell and ShardedRanked share: placement and sizes."""

    @obs.span("build.to_device")
    def device_put(self, mesh: RowMesh, axis="rows"):
        """This layout with shard d's container on mesh.devices[d]; a
        shard of another process is left out (None), as the reference's
        make_array_from_callback places only the local shards."""
        _check_mesh(self, mesh, axis)
        out = copy.copy(self)
        out.shards = placed(self.shards, mesh)
        return out

    @property
    def padded_m(self) -> int:
        return self.rows_per_shard * self.n_devices

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards if s is not None)


@dataclasses.dataclass
class ShardedSell(_Stacked):
    """Per-shard SELL layouts (absolute or window-local int32 columns),
    stacked on a leading axis of D and padded to common shapes (host
    tensors, equal to tpu_spmv.dist.sharding.ShardedSell's arrays), and
    `shards`: each shard's SellSlabs."""

    vals: torch.Tensor  # (D, total_k, 128) float32
    cols: torch.Tensor  # (D, total_k, 128) int32: global ids (all-gather)
    #                     or window-local ids (halo)
    sub_b0: torch.Tensor  # (D, S)
    sub_nb: torch.Tensor  # (D, S)
    sub_chunk: torch.Tensor  # (D, S); padding sub-tiles: num_chunks_local
    m: int
    n: int
    nnz: int
    rows_per_shard: int  # a multiple of 8 * 128
    num_chunks_local: int
    max_nb: int
    n_devices: int
    halo: int = 0  # halo rows (0: x is gathered whole)
    chunk_q: int = 0
    shards: list = None

    def __post_init__(self):
        if self.shards is None:
            self.shards = [self._local(d) for d in range(self.n_devices)]

    @property
    def local_n(self) -> int:
        return self.rows_per_shard + 2 * self.halo if self.halo else self.n

    def _local(self, d: int) -> SellSlabs:
        return local_sell(
            (self.vals, self.cols, self.sub_b0, self.sub_nb, self.sub_chunk),
            d, self.rows_per_shard, self.local_n, self.num_chunks_local,
            self.max_nb, self.nnz, self.chunk_q)

    @classmethod
    def build(cls, mat: CSRMatrix, n_devices: int,
              halo: str = "auto") -> "ShardedSell":
        """Cut rows into n_devices equal blocks and build their layouts.
        halo: "auto" takes the neighbour exchange when every shard's
        columns stay within its neighbours' rows, else gathers x whole;
        "never" always gathers; "always" raises ValueError unless the
        exchange applies."""
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, halo
        )
        shards = [SellSlabs.from_csr(block) for block in blocks]
        num_chunks_local = rows_per_shard // LANES
        (vals, cols, b0, nb, chunk), max_nb = stack_sell(shards,
                                                         num_chunks_local)
        return cls(
            vals=vals, cols=cols, sub_b0=b0, sub_nb=nb, sub_chunk=chunk,
            m=m, n=n, nnz=mat.nnz, rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local, max_nb=max_nb,
            n_devices=n_devices, halo=halo_rows,
            chunk_q=_uniform_q(shards, int(b0.shape[1]), num_chunks_local),
        )



@dataclasses.dataclass
class ShardedRanked(_Stacked):
    """Per-shard rank-windowed layouts, stacked and padded as ShardedSell
    (equal to tpu_spmv.dist.sharding.ShardedRanked's arrays), and
    `shards`: each shard's RankedSlabs. rank_nb is the most over the
    shards; every shard shares shard 0's group plan (or none) and one
    tile."""

    vals: torch.Tensor  # (D, total_k, 128) float32 or bfloat16
    lcols: torch.Tensor  # (D, total_k, 128) window-local columns
    sub_b0: torch.Tensor  # (D, S)
    sub_dlo: torch.Tensor  # (D, S) int32 view of uint32 packed deltas
    sub_dhi: torch.Tensor  # (D, S)
    sub_chunk: torch.Tensor  # (D, S)
    tile_b0: torch.Tensor  # (D, T)
    m: int
    n: int
    nnz: int
    rows_per_shard: int
    num_chunks_local: int
    rank_nb: int
    n_devices: int
    halo: int = 0
    chunk_q: int = 0
    win_w: int = 0
    tile_k: int = 512
    grp_b0: torch.Tensor = None  # (D, S*G), (D, 0) when ungrouped
    group_code: int = 0
    # x rows each shard's kernel reads; 0: rows_per_shard + 2 * halo with
    # a halo, else n. The overlap's stacks set it: the main stack reads
    # the shard's own rows, the edge stack the 2 * halo exchanged rows.
    local_n: int = 0
    shards: list = None

    def __post_init__(self):
        if self.shards is None:
            self.shards = [self._local(d) for d in range(self.n_devices)]

    @property
    def shard_n(self) -> int:
        return self.local_n or (
            self.rows_per_shard + 2 * self.halo if self.halo else self.n
        )

    def _local(self, d: int) -> RankedSlabs:
        return ranked_container(types.SimpleNamespace(
            vals=self.vals[d], lcols=self.lcols[d], sub_b0=self.sub_b0[d],
            sub_dlo=self.sub_dlo[d], sub_dhi=self.sub_dhi[d],
            sub_chunk=self.sub_chunk[d].numpy(), tile_b0=self.tile_b0[d],
            grp_b0=self.grp_b0[d], m=self.rows_per_shard, n=self.shard_n,
            nnz=self.nnz, num_chunks=self.num_chunks_local,
            rank_nb=self.rank_nb, chunk_q=self.chunk_q, win_w=self.win_w,
            tile_k=self.tile_k, group_code=self.group_code,
        ))

    @classmethod
    @obs.span("build.layout")
    def build(cls, mat: CSRMatrix, n_devices: int, halo: str = "auto",
              bin_blocks: int = 0, val_dtype=None) -> "ShardedRanked":
        """As ShardedSell.build, on rank-windowed layouts (column-binned
        at bin_blocks when > 0). val_dtype: each shard's value storage,
        torch.float32 (default) or torch.bfloat16."""
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, halo
        )
        return cls._from_blocks(
            blocks, m=m, n=n, nnz=mat.nnz, rows_per_shard=rows_per_shard,
            halo_rows=halo_rows, bin_blocks=bin_blocks, val_dtype=val_dtype,
        )

    @classmethod
    def _from_blocks(
        cls, blocks, *, m, n, nnz, rows_per_shard, halo_rows,
        bin_blocks=0, val_dtype=None, local_n=0, allow_groups=True,
    ) -> "ShardedRanked":
        n_devices = len(blocks)

        # Every shard must run one grouped walk: shard 0's greedy
        # partition becomes the plan the others are built against, under
        # shard 0's read budget (the stack runs at the largest rank, so a
        # narrower shard must not refuse the plan on its own budget). If
        # any shard cannot keep the plan, no shard is grouped.
        def build_all(tile=None):
            kw = {} if tile is None else {"tile_k": tile}
            built = [RankedSlabs.from_csr(
                blocks[0], bin_blocks=bin_blocks, allow_groups=allow_groups,
                val_dtype=val_dtype, **kw)]
            plan = built[0].group_members if built[0].group_code else None
            r0 = built[0].rank_nb
            budget = 1 if r0 == 1 else 2 * max((r0 + 1) // 2, 1)
            try:
                for block in blocks[1:]:
                    built.append(RankedSlabs.from_csr(
                        block, bin_blocks=bin_blocks, allow_groups=False,
                        group_plan=plan, group_plan_budget=budget,
                        val_dtype=val_dtype, **kw))
            except ValueError:
                built = [RankedSlabs.from_csr(
                    block, bin_blocks=bin_blocks, allow_groups=False,
                    val_dtype=val_dtype, **kw) for block in blocks]
            return built

        shards = build_all()
        # Shards of uneven density pick different tiles (pad_up_tile),
        # and the stacked per-tile metadata (tile_b0) needs one: rebuild
        # at the smallest until they agree (the smallest only falls).
        while len({s.tile_k for s in shards}) > 1:
            shards = build_all(tile=min(s.tile_k for s in shards))

        total_k = max(int(s.vals.shape[0]) for s in shards)
        S = max(s.num_subtiles for s in shards)
        T = max(int(s.tile_b0.shape[0]) for s in shards)
        num_chunks_local = rows_per_shard // LANES
        # The widest local-column type of any shard (each narrows alone).
        dts = {s.lcols.dtype for s in shards}
        lcol_dtype = (torch.int32 if torch.int32 in dts
                      else torch.int16 if torch.int16 in dts else torch.uint8)
        group_code = shards[0].group_code
        if group_code:
            # (S, G) sub-tile-major per shard; padding sub-tiles read
            # block 0 with values 0.
            G = shards[0].num_groups
            grp_b0 = torch.stack([
                _padk(s.grp_b0.view(-1, G), S, 0).reshape(-1) for s in shards
            ])
        else:
            grp_b0 = torch.zeros((n_devices, 0), dtype=torch.int32)
        return cls(
            vals=torch.stack([_padk(s.vals, total_k, 0.0) for s in shards]),
            # Padding local columns of 0 read the window base (values 0).
            lcols=torch.stack([_padk(s.lcols.to(lcol_dtype), total_k, 0)
                               for s in shards]),
            sub_b0=torch.stack([_padk(s.sub_b0, S, 0) for s in shards]),
            sub_dlo=torch.stack([_padk(s.sub_dlo, S, 0) for s in shards]),
            sub_dhi=torch.stack([_padk(s.sub_dhi, S, 0) for s in shards]),
            sub_chunk=torch.stack(
                [_padk(s.sub_chunk, S, num_chunks_local) for s in shards]),
            tile_b0=torch.stack([_padk(s.tile_b0, T, 0) for s in shards]),
            m=m, n=n, nnz=nnz, rows_per_shard=rows_per_shard,
            num_chunks_local=num_chunks_local,
            rank_nb=max(s.rank_nb for s in shards), n_devices=n_devices,
            halo=halo_rows, chunk_q=_uniform_q(shards, S, num_chunks_local),
            win_w=max(s.win_w for s in shards),
            tile_k=min(s.tile_k for s in shards), grp_b0=grp_b0,
            group_code=group_code, local_n=local_n,
        )



@dataclasses.dataclass
class OverlapRanked:
    """The exchange overlapped behind the kernel: every nonzero belongs to
    one of two stacks,

      main: columns among the shard's own rows, read from x's shard
            directly (nothing to wait for);
      edge: columns in a neighbour's rows (at most `halo` past either
            boundary), read from the 2 * halo exchanged rows only.

    y = main(x_shard) + edge(from_left | from_right): the main kernel
    runs while the halo rows are copied, and only the edge kernel, over
    the band's boundary nonzeros, waits for them. Boundary rows add the
    edge's sum after the main one, an order that differs from
    spmv_sharded's by rounding (~1 ulp)."""

    main: ShardedRanked
    edge: ShardedRanked

    @property
    def halo(self) -> int:
        return self.main.halo

    @property
    def n_devices(self) -> int:
        return self.main.n_devices

    @property
    def rows_per_shard(self) -> int:
        return self.main.rows_per_shard

    @property
    def padded_m(self) -> int:
        return self.main.padded_m

    @property
    def m(self) -> int:
        return self.main.m

    @property
    def n(self) -> int:
        return self.main.n

    @property
    def nnz(self) -> int:
        return self.main.nnz + self.edge.nnz

    @property
    def nbytes(self) -> int:
        return self.main.nbytes + self.edge.nbytes

    def device_put(self, mesh: RowMesh, axis="rows") -> "OverlapRanked":
        return OverlapRanked(main=self.main.device_put(mesh, axis),
                             edge=self.edge.device_put(mesh, axis))

    @classmethod
    def build(cls, mat: CSRMatrix, n_devices: int, bin_blocks: int = 0,
              val_dtype=None) -> "OverlapRanked":
        """Raises ValueError when the neighbour exchange does not apply
        (the split means nothing when x is gathered whole; callers fall
        back to ShardedRanked)."""
        m, n = mat.shape
        blocks, halo_rows, rows_per_shard = _slice_shard_blocks(
            mat, n_devices, "always"
        )
        if halo_rows == 0:
            # "always" raises only on too wide a coupling; a rectangular
            # matrix or one device falls through with halo 0, where the
            # split would read global columns as shard-local.
            raise ValueError(
                "overlap split needs the banded neighbor halo (square "
                f"matrix, >1 device); got shape {mat.shape}, "
                f"n_devices={n_devices}"
            )
        H = halo_rows

        def split(blk, rows, mask, width, shift):
            ip = np.zeros(blk.m + 1, np.int64)
            np.add.at(ip, rows[mask] + 1, 1)
            np.cumsum(ip, out=ip)
            return CSRMatrix(
                ip.astype(np.int32),
                shift(blk.indices[mask].astype(np.int64)).astype(np.int32),
                blk.data[mask],
                (blk.m, width),
            )

        main_blocks, edge_blocks, edge_nnz = [], [], 0
        for blk in blocks:
            rows = np.repeat(np.arange(blk.m, dtype=np.int64),
                             blk.row_lengths)
            cols = blk.indices.astype(np.int64)
            interior = (cols >= H) & (cols < H + rows_per_shard)
            main_blocks.append(
                split(blk, rows, interior, rows_per_shard, lambda c: c - H))
            edge_nnz += int((~interior).sum())
            edge_blocks.append(split(
                blk, rows, ~interior, 2 * H,
                lambda c: np.where(c < H, c, c - rows_per_shard)))
        main = ShardedRanked._from_blocks(
            main_blocks, m=m, n=n, nnz=mat.nnz - edge_nnz,
            rows_per_shard=rows_per_shard, halo_rows=H,
            bin_blocks=bin_blocks, val_dtype=val_dtype,
            local_n=rows_per_shard,
        )
        edge = ShardedRanked._from_blocks(
            edge_blocks, m=m, n=n, nnz=edge_nnz,
            rows_per_shard=rows_per_shard, halo_rows=H,
            val_dtype=val_dtype, local_n=2 * H, allow_groups=False,
        )
        return cls(main=main, edge=edge)


def shard_vector(vec, mesh: RowMesh, padded_m: int | None = None) -> list:
    """A host vector (n,) or matrix (n, B) cut into mesh.size equal
    row pieces, piece d on mesh.devices[d] (float32; None for a shard of
    another process). padded_m: zero rows appended up to this length
    first (a layout's padded_m)."""
    h = np.asarray(vec, dtype=np.float32)
    if padded_m is not None and h.shape[0] < padded_m:
        h = np.concatenate(
            [h, np.zeros((padded_m - h.shape[0], *h.shape[1:]), np.float32)])
    if h.shape[0] % mesh.size:
        raise ValueError(f"{h.shape[0]} rows do not cut into {mesh.size} "
                         "equal shards")
    return [None if dev is None else torch.from_numpy(piece.copy()).to(dev)
            for piece, dev in zip(np.split(h, mesh.size), mesh.devices)]


def gather_vector(shards, mesh: RowMesh | None = None) -> np.ndarray:
    """The row pieces of a sharded vector, joined on the host. Pieces of
    other processes (None) are gathered over the mesh's process group: a
    collective, which every process calls, and every process gets the
    whole vector."""
    if all(t is not None for t in shards):
        return np.concatenate([t.detach().cpu().numpy() for t in shards])
    if mesh is None:
        raise ValueError("the vector has shards on other processes: pass "
                         "the mesh to gather them over its process group")
    local = torch.cat([t.detach().to(mesh.home) for t in shards
                       if t is not None])
    return group.all_gather_rows(mesh, local).cpu().numpy()


@contextlib.contextmanager
def _on(stream):
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


@contextlib.contextmanager
def _forked(mesh: RowMesh, streams):
    """Shard streams that start after the caller's queued work on their
    device and that the caller's stream on their device waits for on
    exit, as does the caller's stream on this process's first shard's
    device (so an event there times the whole call); a no-op on the CPU.
    Shards of other processes have no stream."""
    for dev, s in zip(mesh.devices, streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(dev))
    try:
        yield
    finally:
        home = mesh.home
        home = torch.cuda.current_stream(home) if home.type == "cuda" else None
        for dev, s in zip(mesh.devices, streams):
            if s is not None:
                caller = torch.cuda.current_stream(dev)
                caller.wait_stream(s)
                if caller != home:
                    home.wait_stream(s)


def _halo_rows(xs, d: int, H: int, out: torch.Tensor, at: int,
               remote=None) -> None:
    """Copy shard d's neighbours' H boundary rows into out[at:at + H]
    (from the left) and out[-H:] (from the right): a neighbour of this
    process's from its shard, one of another process's from `remote`
    (_remote_halos; skipped when None). The first shard's left and the
    last shard's right stay the zeros out was made with."""
    if d > 0:
        left = (xs[d - 1][-H:] if xs[d - 1] is not None
                else None if remote is None else remote[d, -1])
        if left is not None:
            out[at : at + H].copy_(left, non_blocking=True)
    if d < len(xs) - 1:
        right = (xs[d + 1][:H] if xs[d + 1] is not None
                 else None if remote is None else remote[d, 1])
        if right is not None:
            out[-H:].copy_(right, non_blocking=True)


def _remote_halos(xs, H: int, mesh: RowMesh) -> dict:
    """{(d, side): H rows} for each of this process's shards d whose
    neighbour lies on another process: the neighbour's boundary rows
    (side -1: the last H of shard d - 1; +1: the first H of shard d + 1),
    received on shard d's device, while ours go the other way. Every
    boundary between two processes is crossed both ways in one batch,
    boundaries in order on every process, before any kernel reads them."""
    got, sends, recvs = {}, [], []
    for b in range(len(xs) - 1):  # the boundary of shards b and b + 1
        lo, hi = mesh.owner(b), mesh.owner(b + 1)
        if lo == hi:
            continue
        if xs[b] is not None:
            got[b, 1] = torch.empty_like(xs[b][:H])
            sends.append((xs[b][-H:], hi, 2 * b))
            recvs.append((got[b, 1], hi, 2 * b + 1))
        if xs[b + 1] is not None:
            got[b + 1, -1] = torch.empty_like(xs[b + 1][:H])
            recvs.append((got[b + 1, -1], lo, 2 * b))
            sends.append((xs[b + 1][:H], lo, 2 * b + 1))
    group.exchange(mesh, sends, recvs)
    return got


def _remote(layout, xs, mesh: RowMesh):
    """What the shards' windows need from other processes, moved before
    any kernel runs (on the caller's stream, which the shard streams
    fork from): the halo rows (_remote_halos), or x gathered whole on
    this process's first shard's device; None in one process. Held until
    the call returns, after its streams are joined."""
    if mesh.world == 1:
        return None
    if layout.halo:
        return _remote_halos(xs, layout.halo, mesh)
    return group.all_gather_rows(mesh, torch.cat(
        [t.to(mesh.home) for t in xs if t is not None]))


def _exchange_x(layout, xs, d: int, remote=None) -> torch.Tensor:
    """Shard d's window of x, on its device: [left H | own rows | right
    H] with a halo (zero-filled: padding slots read their window base
    with value 0, and 0 * NaN of unset memory would be NaN), else x
    gathered whole and cut to n. remote: _remote's rows of other
    processes. Runs on the caller's current stream."""
    x = xs[d]
    H = layout.halo
    if H:
        R = layout.rows_per_shard
        win = torch.zeros((R + 2 * H, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        win[H : H + R].copy_(x)
        _halo_rows(xs, d, H, win, 0, remote)
        return win
    if len(xs) == 1:  # one shard holds x whole: a view, not a copy
        return x[: layout.n]
    if remote is not None:  # x gathered over the process group
        return remote.to(x.device, non_blocking=True)[: layout.n]
    return torch.cat([t.to(x.device, non_blocking=True) for t in xs])[
        : layout.n]


def _check_vector(layout, xs, mesh: RowMesh) -> None:
    if len(xs) != layout.n_devices or any(
            (t is None) != (dev is None)
            or (t is not None and t.shape[0] != layout.rows_per_shard)
            for t, dev in zip(xs, mesh.devices)):
        raise ValueError(
            f"x must be {layout.n_devices} shards of {layout.rows_per_shard} "
            f"rows (shard_vector), got "
            f"{[None if t is None else tuple(t.shape) for t in xs]}")


def spmv_sharded(layout, xs, mesh: RowMesh, axis="rows",
                 plain: bool = False) -> list:
    """y = A @ x with rows sharded over the mesh; x arrives as D shards
    of rows_per_shard rows (zeros past n) and y leaves so (zeros past m),
    None where a shard lies on another process.

    layout: ShardedSell (spmv_sell per shard) or ShardedRanked
    (spmv_ranked per shard), placed on `mesh` (device_put). Each shard's
    window of x is exchanged, then its kernel runs on its stream.
    plain=True runs the kernels' plain versions."""
    if isinstance(layout, ShardedRanked):
        kernel = sell.spmv_ranked_reference if plain else sell.spmv_ranked
    else:
        kernel = sell.spmv_sell_reference if plain else sell.spmv_sell
    return sharded_call(layout, xs, mesh, lambda d, lay, x: kernel(lay, x),
                        axis)


def sharded_call(layout, xs, mesh: RowMesh, kernel, axis="rows") -> list:
    """spmv_sharded's exchange and streams around kernel(d, shard d's
    layout, shard d's window of x) -> y_d, on each of this process's
    shards (the fused CG iteration's walk, dist/solvers, passes its own)."""
    _check_mesh(layout, mesh, axis)
    _check_vector(layout, xs, mesh)
    remote = _remote(layout, xs, mesh)
    ys = [None] * layout.n_devices
    with _forked(mesh, mesh.streams):
        for d in mesh.local:
            with _on(mesh.streams[d]):
                ys[d] = kernel(d, layout.shards[d],
                               _exchange_x(layout, xs, d, remote))
    return ys


def spmm_sharded(layout: ShardedRanked, Xs, mesh: RowMesh, axis="rows",
                 kernel: str = "auto", plain: bool = False) -> list:
    """Y = A @ X with rows sharded over the mesh: X as D shards of
    (rows_per_shard, B) rows, exchanged as x is (H rows of B columns from
    each neighbour), then spmm_ranked or spmm_ranked_windowed per shard.

    kernel: 'resident' | 'windowed' | 'auto'. auto decides per shard by
    the port's residency gate, kernels/sell.resident_x_fits(shard,
    batch=B): half the L2 of the card the shard lies on (shards that
    share a card also share its L2; the gate charges each alone).
    Raises ValueError for 'windowed' on a layout without per-tile windows
    (win_w <= 0), as the reference does."""
    if not isinstance(layout, ShardedRanked):
        raise TypeError("spmm_sharded expects the ShardedRanked flagship")
    _check_mesh(layout, mesh, axis)
    _check_vector(layout, Xs, mesh)
    B = int(Xs[mesh.local[0]].shape[-1])
    choice = [kernel] * layout.n_devices
    if kernel == "auto":
        choice = [None if lay is None else "resident"
                  if resident_x_fits(lay, batch=B) else "windowed"
                  for lay in layout.shards]
    if "windowed" in choice and layout.win_w <= 0:
        raise ValueError(
            "per-shard staged X exceeds the VMEM budget and the layout "
            "has no per-tile windows (scattered structure); rebuild with "
            "windows or reduce B"
        )
    fns = {"resident": (spmm.spmm_ranked_reference if plain
                        else spmm.spmm_ranked),
           "windowed": (spmm.spmm_ranked_windowed_reference if plain
                        else spmm.spmm_ranked_windowed)}
    remote = _remote(layout, Xs, mesh)
    Ys = [None] * layout.n_devices
    with _forked(mesh, mesh.streams):
        for d in mesh.local:
            with _on(mesh.streams[d]):
                Ys[d] = fns[choice[d]](layout.shards[d],
                                       _exchange_x(layout, Xs, d, remote))
    return Ys


def _run_overlap(layout: OverlapRanked, xs, mesh: RowMesh, axis, matrix,
                 plain) -> list:
    """The overlapped call: per shard, the halo rows of this process's
    neighbours are copied on the shard's halo stream while its main
    kernel runs on x's shard on its own stream; the rows of other
    processes' shards then cross the process boundary on the first
    shard's halo stream, after every main kernel is queued (under gloo
    the host waits for them there, while the main kernels run). The
    edge kernel waits for the halo stream and adds into the main
    kernel's y (main first, then edge, as the reference adds)."""
    _check_mesh(layout, mesh, axis)
    _check_vector(layout, xs, mesh)
    H = layout.halo
    if matrix:
        main_fn = spmm.spmm_ranked_reference if plain else spmm.spmm_ranked

        def add_edge(lay, xe, y):
            return y.add_(main_fn(lay, xe))
    else:
        main_fn = (sell.spmv_ranked_reference if plain
                   else sell.spmv_ranked)

        def add_edge(lay, xe, y):
            if plain:
                return y.add_(sell.spmv_ranked_reference(lay, xe))
            return sell.spmv_ranked(lay, xe, out=y)

    D = layout.n_devices
    edges = [None] * D
    ys = [None] * D
    local = mesh.local
    with _forked(mesh, mesh.streams), _forked(mesh, mesh.halo_streams):
        for d in local:
            with _on(mesh.halo_streams[d]):
                x = xs[d]
                edges[d] = torch.zeros((2 * H, *x.shape[1:]), dtype=x.dtype,
                                       device=x.device)
                _halo_rows(xs, d, H, edges[d], 0)
        for d in local:
            with _on(mesh.streams[d]):
                ys[d] = main_fn(layout.main.shards[d], xs[d])
        if mesh.world > 1:
            h0 = mesh.halo_streams[local[0]]
            with _on(h0):
                remote = _remote_halos(xs, H, mesh)
            for (d, side), rows in remote.items():
                with _on(mesh.halo_streams[d]):
                    if h0 is not None:
                        torch.cuda.current_stream().wait_stream(h0)
                    edge = edges[d][:H] if side < 0 else edges[d][-H:]
                    edge.copy_(rows, non_blocking=True)
        for d in local:
            h = mesh.halo_streams[d]
            with _on(mesh.streams[d]):
                if h is not None:
                    torch.cuda.current_stream(mesh.devices[d]).wait_stream(h)
                ys[d] = add_edge(layout.edge.shards[d], edges[d], ys[d])
    return ys


def spmv_overlap(layout: OverlapRanked, xs, mesh: RowMesh, axis="rows",
                 plain: bool = False) -> list:
    """y = A @ x with the halo exchange overlapped behind the main kernel
    (see OverlapRanked); x and y as in spmv_sharded."""
    return _run_overlap(layout, xs, mesh, axis, False, plain)


def spmm_overlap(layout: OverlapRanked, Xs, mesh: RowMesh, axis="rows",
                 plain: bool = False) -> list:
    """Y = A @ X with the (H, B) halo blocks overlapped behind the main
    spmm_ranked; X and Y as in spmm_sharded (resident only)."""
    return _run_overlap(layout, Xs, mesh, axis, True, plain)


def from_reference(layout):
    """The port's ShardedSell, ShardedRanked, OverlapRanked or
    ShardedLowerSolve (dist/sts.py) for the JAX package's (its stacked
    arrays read through NumPy), on the host; device_put places it."""
    kind = type(layout).__name__
    if kind == "OverlapRanked":
        return OverlapRanked(main=from_reference(layout.main),
                             edge=from_reference(layout.edge))
    if kind == "ShardedLowerSolve":
        from tpu_spmv_torch.dist import sts

        return sts.from_reference(layout)
    cls = {"ShardedSell": ShardedSell, "ShardedRanked": ShardedRanked}[kind]
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name == "shards":
            continue
        v = getattr(layout, f.name)
        fields[f.name] = v if isinstance(v, int) else to_tensor(v)
    return cls(**fields)


__all__ = [
    "OverlapRanked", "RowMesh", "ShardedRanked", "ShardedSell",
    "gather_vector", "make_row_mesh", "mesh_axis_size", "shard_vector",
    "spmm_overlap", "spmm_sharded", "spmv_overlap", "spmv_sharded",
]
