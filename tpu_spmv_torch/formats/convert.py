"""Layouts carried across from the JAX package.

`from_reference` turns a `tpu_spmv` layout (DiaSlabs, SellSlabs,
RankedSlabs or PackedRanked, whose arrays np.asarray can read) into the
port's container, so a layout built once can be run through both
packages' kernels. It reads the arrays through NumPy and never imports
JAX. The port's derived fields come from the reference's arrays alone:
chunk_ptr from sub_chunk, the segment table from chunk_ptr
(formats/sell.segment_fields), RankedSlabs' run table from the segment
table (formats/packed.ranked_walk_fields) and its window table from the
segment table and the bases (formats/sell.window_fields), and PackedRanked's
chunk_koff from out_row and bmeta, and its segment and run tables from
chunk_koff (formats/packed.walk_fields).

Two encodings need care: numpy has no bf16 of its own and
torch.from_numpy rejects ml_dtypes' bfloat16, so bf16 crosses as its
uint16 bits; and sub_dlo/sub_dhi stay the int32 view of their uint32
packed deltas, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_spmv_torch.formats.dia import DiaSlabs
from tpu_spmv_torch.formats.packed import (
    PackedRanked, chunk_koff_from_segments, ranked_walk_fields, walk_fields,
)
from tpu_spmv_torch.formats.sell import (
    RankedSlabs, SellSlabs, _chunk_ptr, segment_fields, to_tensor,
    window_fields,
)


def from_reference(layout):
    """The port's container for a JAX-package layout (same arrays, plus
    the port's derived fields)."""
    kind = type(layout).__name__
    if kind == "DiaSlabs":
        return DiaSlabs(
            vals=to_tensor(layout.vals),
            offs=torch.tensor(layout.offsets, dtype=torch.int32),
            offsets=tuple(int(o) for o in layout.offsets),
            m=layout.m, n=layout.n, nnz=layout.nnz,
            rows_per_tile=layout.rows_per_tile,
        )
    if kind == "PackedRanked":
        koff = chunk_koff_from_segments(layout.out_row, layout.bmeta)
        return PackedRanked(
            vals=to_tensor(layout.vals),
            lcols=to_tensor(layout.lcols),
            sub_b0=to_tensor(layout.sub_b0),
            sub_dlo=to_tensor(layout.sub_dlo),
            sub_dhi=to_tensor(layout.sub_dhi),
            bmeta=to_tensor(layout.bmeta),
            out_row=to_tensor(layout.out_row),
            grp_b0=to_tensor(layout.grp_b0),
            chunk_koff=torch.from_numpy(koff),
            **walk_fields(koff),
            m=layout.m, n=layout.n, nnz=layout.nnz,
            num_chunks=layout.num_chunks, rank_nb=layout.rank_nb,
            tile_k=layout.tile_k, group_code=layout.group_code,
        )
    sub_chunk = np.asarray(layout.sub_chunk)
    chunk_ptr = _chunk_ptr(sub_chunk, layout.num_chunks)
    segments = (ranked_walk_fields if kind == "RankedSlabs"
                else segment_fields)(chunk_ptr)
    chunk_ptr = torch.from_numpy(chunk_ptr)
    if kind == "SellSlabs":
        return SellSlabs(
            vals=to_tensor(layout.vals),
            cols=to_tensor(layout.cols),
            sub_b0=to_tensor(layout.sub_b0),
            sub_nb=to_tensor(layout.sub_nb),
            sub_chunk=to_tensor(sub_chunk),
            chunk_ptr=chunk_ptr,
            **segments,
            m=layout.m, n=layout.n, nnz=layout.nnz,
            num_chunks=layout.num_chunks, max_nb=layout.max_nb,
            chunk_q=layout.chunk_q,
        )
    if kind == "RankedSlabs":
        return RankedSlabs(
            vals=to_tensor(layout.vals),
            lcols=to_tensor(layout.lcols),
            sub_b0=to_tensor(layout.sub_b0),
            sub_dlo=to_tensor(layout.sub_dlo),
            sub_dhi=to_tensor(layout.sub_dhi),
            sub_chunk=to_tensor(sub_chunk),
            tile_b0=to_tensor(layout.tile_b0),
            grp_b0=to_tensor(layout.grp_b0),
            chunk_ptr=chunk_ptr,
            **segments,
            m=layout.m, n=layout.n, nnz=layout.nnz,
            num_chunks=layout.num_chunks, rank_nb=layout.rank_nb,
            chunk_q=layout.chunk_q, win_w=layout.win_w,
            tile_k=layout.tile_k, group_code=layout.group_code,
            **window_fields(segments["seg_ptr"], layout.sub_b0,
                            layout.sub_dlo, layout.sub_dhi, layout.rank_nb),
        )
    raise TypeError(f"no port container for a {kind}")

