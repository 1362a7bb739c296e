"""Column-striped multi-pass SpMV: a scattered matrix whose x is past the
L2 residency gate.

Counterpart of `tpu_spmv/kernels/striped.py`, which has no Pallas kernel
of its own: a lax.scan of spmv_ranked over column stripes. The resident
ranked walk needs x in L2 (kernels/sell.resident_x_fits), and the
windowed walk needs band locality for its ring of x blocks; a
column-binned matrix with tens of millions of columns has neither. Here
the columns are cut into stripes of `stripe_cols` (a quarter of the L2
by default_stripe_cols), and each stripe keeps every row's nonzeros in
it as its own column-binned RankedSlabs, so each pass is the segment
walk of
csrc/sell.cu with that stripe's slice of x in L2:

    y = sum_p A_p @ x[p * stripe_cols : (p + 1) * stripe_cols]

Pass 0 stores y and each later pass adds into it (spmv_ranked's
accumulate mode), in stripe order, so a call gives the same bits every
time. The stripes are kept as a list of layouts, each with its own
segment, run and window tables, not padded to one shape as the
reference's are (its padding sub-tiles carry chunk id num_chunks, which
the walk has no row for). Each pass reads a view of x with the stripe's
true width as its n, so the ragged last stripe needs no padded copy of x.

The stripes store f32 or bf16 values (from_csr's val_dtype; the walk
widens bf16 to f32 on load). The reference refuses bf16 on its stripes,
measured slower there; bf16_pays takes that decision from the current
card's calibration instead (tools/tune.py step 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_spmv_torch import hw
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import LANES, RankedSlabs
from tpu_spmv_torch.kernels.sell import partial_rows, spmv_ranked


# Stripe width as a fraction of the L2 (default_stripe_cols): a quarter,
# where the residency gate (kernels/sell.resident_x_fits) would allow half.
# The slabs stream through the same L2 and evict x. On scattered_16m
# (NVIDIA H100 80GB HBM3, 700.00 W, bench/scattered_16m.py, warm TimeMin
# in one run): stripes of a quarter of the L2 (3,276,800 columns, P = 6)
# took 1286.6 us in f32 and 1071-1072 in bf16, against 1351-1354 and 1152
# at half (P = 3), 1301.0 and 1123.4 at an eighth (P = 11) and 1371.0 and
# 1236.7 at a sixteenth (P = 21).
L2_FRACTION = 4


def bf16_ratio() -> float:
    """The current card's striped_bf16 (hw.kernel_calibration, read as
    the planner reads its constants: tune/model._cal): spmv_striped's
    time with bf16 stripes over its time with f32 stripes; 1.0 (no gain)
    when the entry has no such key."""
    from tpu_spmv_torch.tune import model

    return model._cal("striped_bf16", 1.0)


def bf16_pays() -> bool:
    """Whether the striped route stores bf16 values when asked to: only
    when the card's calibration times bf16 stripes faster than f32 ones
    by more than the spread of two timings (striped_bf16 < 1 -
    tools.tune.NOISE). Without the key (no entry for the card, an entry
    measured before the key existed, the CPU) the answer is no: the
    reference's gate."""
    from tpu_spmv_torch.tools.tune import NOISE

    return bf16_ratio() < 1.0 - NOISE


def default_stripe_cols(device=None) -> int:
    """Stripe width whose x slice fills a quarter of the L2 of `device`
    (hw.l2_bytes: the H100's 50 MB off the card; L2_FRACTION), in floats,
    rounded down to 128 columns, so it passes kernels/sell.
    resident_x_fits. At least one 128-column block, so an L2 of 0 (a test
    forcing every route past the gate) still gives a width."""
    return max(hw.l2_bytes(device) // L2_FRACTION // 4 // LANES * LANES,
               LANES)


@dataclasses.dataclass
class StripedRanked:
    """One column-binned RankedSlabs per stripe of columns; stripe p
    covers columns [p * stripe_cols, p * stripe_cols + its n)."""

    stripes: list  # of RankedSlabs, stripe-local columns
    m: int
    n: int
    nnz: int
    stripe_cols: int
    bin_blocks: int

    @property
    def num_stripes(self) -> int:
        return len(self.stripes)

    @property
    def rank_nb(self) -> int:
        return max(s.rank_nb for s in self.stripes)

    @property
    def val_dtype(self) -> torch.dtype:
        """The dtype the stripes store their values in."""
        return self.stripes[0].vals.dtype

    @property
    def padded_nnz(self) -> int:
        return sum(s.vals.numel() for s in self.stripes)

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    @property
    def hbm_bytes(self) -> int:
        """The reference's per-SpMV traffic formula: the slabs and window
        bases of every stripe, x once and y once a pass."""
        return sum(
            s.vals.numel() * s.vals.element_size()
            + s.lcols.numel() * s.lcols.element_size()
            + s.num_subtiles * LANES * 4
            for s in self.stripes
        ) + 4 * (self.n + self.num_stripes * self.m)

    @property
    def nbytes(self) -> int:
        """Bytes the stripes' tensors hold on their device."""
        return sum(s.nbytes for s in self.stripes)

    def _map(self, fn):
        return dataclasses.replace(self, stripes=[fn(s) for s in self.stripes])

    def to(self, device):
        return self._map(lambda s: s.to(device))

    def clone(self):
        """Copy with distinct storage (the cold-regime timing)."""
        return self._map(lambda s: s.clone())

    @classmethod
    def from_csr(cls, mat: CSRMatrix, stripe_cols: int | None = None,
                 bin_blocks: int = 16, val_dtype=None,
                 device=None) -> "StripedRanked":
        """Cut the columns into stripes and build one binned RankedSlabs
        per stripe (rows unchanged; stripe p's columns relabelled by
        -p * stripe_cols), as tpu_spmv/kernels/striped.py:145-169 does,
        on `device` (hw.target_device: the card when None). Each stripe's
        arrays equal the reference's for that stripe; its n is the
        stripe's true width (the last one may be narrower). Raises
        ValueError when the matrix fits one stripe."""
        device = hw.target_device(device)
        m, n = mat.shape
        sc = stripe_cols or default_stripe_cols(device)
        sc = -(-sc // LANES) * LANES
        P = max(-(-n // sc), 1)
        if P == 1:
            raise ValueError(
                f"matrix has {n} columns <= one stripe ({sc}); use "
                "RankedSlabs directly"
            )
        rows = np.repeat(np.arange(m, dtype=np.int64), mat.row_lengths)
        stripe_of = mat.indices.astype(np.int64) // sc
        stripes = []
        for p in range(P):
            sel = stripe_of == p
            indptr = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows[sel], minlength=m), out=indptr[1:])
            sub = CSRMatrix(
                indptr,
                (mat.indices[sel].astype(np.int64) - p * sc).astype(np.int32),
                mat.data[sel],
                (m, min(sc, n - p * sc)),
            )
            stripes.append(RankedSlabs.from_csr(
                sub, bin_blocks=bin_blocks, allow_groups=False,
                val_dtype=val_dtype,
            ).to(device))
        return cls(stripes=stripes, m=m, n=n, nnz=mat.nnz, stripe_cols=sc,
                   bin_blocks=bin_blocks)


def _stripe_x(layout: StripedRanked, x: torch.Tensor, p: int) -> torch.Tensor:
    return x.narrow(0, p * layout.stripe_cols, layout.stripes[p].n)


def spmv_striped_reference(layout: StripedRanked,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain version: the stripes' plain ranked products added in stripe
    order."""
    from tpu_spmv_torch.kernels.sell import spmv_ranked_reference

    if x.shape != (layout.n,):
        raise ValueError(f"spmv_striped: x must be ({layout.n},), got "
                         f"{tuple(x.shape)}")
    y = torch.zeros(layout.m, dtype=torch.float32, device=x.device)
    for p, s in enumerate(layout.stripes):
        y += spmv_ranked_reference(s, _stripe_x(layout, x, p))
    return y


def spmv_striped(layout: StripedRanked, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the column stripes: one spmv_ranked call a stripe,
    the first storing y, the rest adding into it, with one partials
    scratch sized for the stripe that needs most. x: (n,) float32 ->
    y: (m,) float32. One count a call; spmv_ranked counts each pass."""
    if x.device.type == "cpu":
        return spmv_striped_reference(layout, x)
    if x.shape != (layout.n,):
        raise ValueError(f"spmv_striped: x must be ({layout.n},), got "
                         f"{tuple(x.shape)}")
    part = torch.empty(max(partial_rows(s) for s in layout.stripes) * LANES,
                       dtype=torch.float32, device=x.device)
    y = spmv_ranked(layout.stripes[0], _stripe_x(layout, x, 0), part=part)
    for p in range(1, layout.num_stripes):
        spmv_ranked(layout.stripes[p], _stripe_x(layout, x, p), out=y,
                    part=part)
    spmv_striped.launches += 1
    return y


spmv_striped.launches = 0
