"""The fused CG iteration: three hand-written kernels a shard that
advance the state (x, r, p, rz) in place (dist/solvers.cg_step on the
card).

  spmv_ranked_dot  K1: spmv_ranked's walk (csrc/sell.cu, the segment
                   walk and its split fix-up) with the RowDot epilogue:
                   Ap = A p and the shard's p . Ap.
  cg_update        K2 (csrc/cg.cu): alpha = rz / max(pAp, 1e-30) from
                   the D shards' p . Ap; x += alpha p, r -= alpha Ap;
                   the shard's r . r.
  cg_direction     K3 (csrc/cg.cu): beta = rr / max(rz, 1e-30) from the
                   D shards' r . r; p = r + beta p; the last shard's
                   writes rz <- rr.

A shard's dot is a deterministic sum over the kernel's CTAs (csrc/
grid_sum.cuh: one partial a CTA, added in order by the last CTA), so two
runs from one state give the same bits; the D shards' partials are added
in shard order, as dist/solvers._dot adds them. The plain version of the
three is dist/solvers' composed step (torch's vector operations around
spmv_sharded), which also runs wherever the fused step does not
(dist/solvers.fused). Each wrapper counts its calls in `.launches`.
"""

from __future__ import annotations

import torch

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels.sell import ranked_walk_args

# CTAs of K2 at most, per SM of the card (csrc/cg.cu's kCtasPerSm).
CTAS_PER_SM = 8


class CGScratch:
    """One shard's device scratch of the fused iteration: one float per
    CTA of K1 (the walk's segments and the fix-up's split chunks) and of
    K2 (at most CTAS_PER_SM an SM), and the done counters of K1, K2 and
    K3, which are 0 between launches (each kernel's last CTA zeroes its
    own)."""

    def __init__(self, layout: RankedSlabs, device: torch.device):
        self.walk_ctas = layout.seg_chunk.numel() + layout.split_seg.shape[1]
        self.update_cap = CTAS_PER_SM * torch.cuda.get_device_properties(
            device).multi_processor_count
        self.partials = torch.empty(self.walk_ctas + self.update_cap,
                                    dtype=torch.float32, device=device)
        self.counts = torch.zeros(3, dtype=torch.int32, device=device)

    def walk(self) -> tuple:
        return self.partials.data_ptr(), self.counts.data_ptr()

    def update(self) -> tuple:
        return (self.partials.data_ptr() + 4 * self.walk_ctas,
                self.update_cap, self.counts.data_ptr() + 4)

    def direction(self) -> int:
        return self.counts.data_ptr() + 8


def _check_vectors(what: str, n: int, device, **vecs) -> None:
    for name, v in vecs.items():
        if (v.dtype != torch.float32 or v.device != device
                or not v.is_contiguous() or v.numel() != n):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"of {n} on {device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def _check_slots(what: str, device, **slots) -> None:
    for name, v in slots.items():
        if (v.dtype != torch.float32 or v.device != device
                or not v.is_contiguous() or v.numel() < 1):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"on {device}")


@obs.entry
def spmv_ranked_dot(layout: RankedSlabs, x: torch.Tensor, p: torch.Tensor,
                    scratch: CGScratch, into: torch.Tensor) -> torch.Tensor:
    """K1: y = A @ x as spmv_ranked, and into[0] = the sum of p[i] * y[i]
    over the layout's m rows. p: (m,) float32, the shard's own rows of the
    vector x windows; into: a float32 slot on the card."""
    what = "spmv_ranked_dot"
    _check_vectors(what, layout.m, x.device, p=p)
    _check_slots(what, x.device, into=into)
    y, args = ranked_walk_args(layout, x, what)
    if args is None:
        into.zero_()
        return y
    obs.step("entry.launch")
    rc = _build.library().tsp_spmv_ranked_dot(
        *args, p.data_ptr(), *scratch.walk(), into.data_ptr(),
        _build.stream_of(x))
    _build.check(rc, what)
    spmv_ranked_dot.launches += 1
    return y


def cg_update(pap: torch.Tensor, rz: torch.Tensor, p: torch.Tensor,
              ap: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
              scratch: CGScratch, rr_out: torch.Tensor) -> None:
    """K2: alpha = rz / max(pap[0] + ... + pap[D-1], 1e-30); x += alpha
    p and r -= alpha ap in place; rr_out[0] = r . r. pap: (D,) float32;
    rz: a float32 scalar; p, ap, x, r: one shard's float32 rows."""
    what = "cg_update"
    dev = x.device
    _check_vectors(what, x.numel(), dev, p=p, ap=ap, x=x, r=r)
    _check_slots(what, dev, pap=pap, rz=rz, rr_out=rr_out)
    rc = _build.library().tsp_cg_update(
        pap.data_ptr(), pap.numel(), rz.data_ptr(), p.data_ptr(),
        ap.data_ptr(), x.data_ptr(), r.data_ptr(), x.numel(),
        *scratch.update(), rr_out.data_ptr(), _build.stream_of(x))
    _build.check(rc, what)
    cg_update.launches += 1


def cg_direction(rr: torch.Tensor, rz: torch.Tensor, r: torch.Tensor,
                 p: torch.Tensor, scratch: CGScratch | None) -> None:
    """K3: beta = (rr[0] + ... + rr[D-1]) / max(rz, 1e-30); p = r + beta
    p in place. With scratch (the last shard's call), rz <- that sum once
    every CTA has read rz; without, rz is left."""
    what = "cg_direction"
    dev = p.device
    _check_vectors(what, p.numel(), dev, r=r, p=p)
    _check_slots(what, dev, rr=rr, rz=rz)
    rc = _build.library().tsp_cg_direction(
        rr.data_ptr(), rr.numel(), rz.data_ptr(), r.data_ptr(),
        p.data_ptr(), p.numel(),
        None if scratch is None else scratch.direction(),
        _build.stream_of(p))
    _build.check(rc, what)
    cg_direction.launches += 1


spmv_ranked_dot.launches = 0
cg_update.launches = 0
cg_direction.launches = 0
