"""The planner: `tpu_plan(mat)` picks the kernel and the layout's knobs
from the matrix's structure (the port of `tpu_spmv.tune.model`).

Two families, as in the reference:

  * reference_gpu_params: the published per-architecture density models
    of the CSR-3 super(-super)-row sizes (volta, ampere, mi100, legacy),
    kept for tools.reformat --auto;
  * tpu_plan: the least cost over the candidate layouts, in units of one
    plain gather iteration: sell (ordinal slots), aligned ranked and
    packed, ranked and packed over column bins of _BIN_WIDTHS blocks,
    sell over column stripes of _STRIPE_WIDTHS blocks, and dia, plus a
    SELL-C-sigma recommendation and the estimate-only path that may send
    a matrix to the segsum baseline.

Every cost constant is read through _cal from hw.kernel_calibration(),
the entry that tools.tune --calibrate measures on the card; each
lookup's default is the reference's module value, measured on a TPU
v5e, and applies only where the entry lacks the key (no card, or a card
never calibrated). A card's entry is in its own unit, one spmv_sell
sub-tile at a chunk span of 8 blocks (unit_ns gives its length), and
holds every constant below:

  ranked_fixed, pair_cost  a ranked sub-tile: ranked_fixed + pair_cost
                           * pairs (pairs = ceil(rank_nb / 2));
  sell_fixed, span_cost    a sell sub-tile: sell_fixed + span_cost *
                           chunk span (the reference: ranked_fixed + 1
                           a block);
  traffic_floor            the least a ranked sub-tile, a sell
                           sub-tile's span part or a DIA unit costs:
                           streaming a sub-tile's slabs;
  packed_over, epi_cost    the packed surcharge and the charge of a
                           ragged quantized layout;
  dia_step_cost            one diagonal over 1024 rows;
  span_limit               the widest chunk span sell is offered at;
  ranked_iter_cost         a ranked sub-tile's time over a sell one's,
                           which weighs the rank span against the chunk
                           span on the estimate-only path;
  solve_*                  the two triangular solves (sts/solve.py).

An entry without unit_ns predates that unit: its constants are in the
reference's unit, one plain gather iteration, and it is read so, every
key it lacks at the reference's value (hw.kernel_calibration warns).
The width tuples and sigma's window and threshold are candidate sets,
not costs, and stay the reference's.

The one deliberate difference is the residency gate of the packed
candidates (_packed_x_fits): the port's packed kernels keep x in the
card's L2, so x is charged against half of it
(kernels/sell.resident_x_fits), where the reference charges its TPU's
VMEM.
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np

from tpu_spmv_torch import obs
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import LANES, SUBLANES


def reference_gpu_params(density: float, arch: str = "ampere") -> dict:
    """(ssrs, srs, vec, veclevel, block_dims) from the density nnz / m
    (tpu_spmv.tune.model.reference_gpu_params)."""
    d = max(float(density), 1e-9)
    ln = math.log(d)

    def r(v):  # round half up, the reference's floor(x + 0.5)
        return int(math.floor(v + 0.5))

    if arch == "ampere":
        ssrs, srs = r(9.175 - 1.32 * ln), r(20.5 - 3.5 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
        if 8.0 < d <= 16.0:
            vec, srs = True, ssrs * 4
        elif 16.0 < d <= 32.0:
            vec, veclevel, by = True, 8, 8
            ssrs = r(ssrs * 2.5)
            srs = ssrs * 3
        elif 32.0 < d <= 64.0:
            vec, veclevel, by = True, 16, 4
            ssrs *= 2
            srs = ssrs * 2
        elif d > 64.0:
            vec, veclevel, by = True, 32, 2
            ssrs = r(ssrs * 2.7)
            srs = r(ssrs / 4)
    elif arch == "volta":
        ssrs, srs = r(8.89888 - 1.25 * ln), r(10.14618 - 1.5 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
        if 8.0 < d <= 16.0:
            vec = True
            ssrs = r(ssrs * 1.5)
            srs = ssrs * 2
        elif 16.0 < d <= 32.0:
            vec, veclevel, by = True, 8, 8
            ssrs *= 4
            srs = ssrs >> 1
        elif 32.0 < d <= 64.0:
            vec, veclevel, by = True, 16, 4
            ssrs *= 5
            srs = ssrs >> 1
        elif d > 64.0:
            vec, veclevel, by = True, 32, 2
            ssrs *= 5
            srs = ssrs >> 1
    elif arch == "mi100":
        ssrs, srs = r(8.489 - 1.15 * ln), r(10.711 - 1.607 * ln)
        vec, veclevel, bx, by = False, 4, 8, 12
    elif arch == "legacy":
        ssrs = r(3.333 + 20.0 / (d * max(ln, 1e-9)))
        srs = r(0.667 * ssrs + 2.667)
        vec, veclevel, bx, by = False, 4, 8, 12
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return {
        "ssrs": max(ssrs, 1),
        "srs": max(srs, 1),
        "vec": vec,
        "veclevel": veclevel,
        "block_dims": (bx, by),
    }


@dataclasses.dataclass
class TpuPlan:
    kernel: str  # 'ranked' | 'sell' | 'packed' | 'dia' | 'segsum'
    tile_k: int
    needs_rcm: bool
    est_max_nb: float  # chunk span (blocks): the plain gather loop
    est_rank_nb: float  # per-slot span (blocks): the ranked loop
    reason: str
    bin_blocks: int = 0  # > 0: column bins of this many x blocks
    est_cost: float = 0.0  # plain-iteration units (relative)
    sigma: int = 0  # > 0: the SELL-C-sigma row sort window worth applying


# Past this chunk span (blocks) the plain gather loop is not offered.
_SPAN_LIMIT = 96
# Ranked gather iteration over a plain one (the estimate-only path).
_RANKED_ITER_COST = 1.6
# Ranked sub-tile cost, fixed part and per pair of gather iterations.
_RANKED_FIXED = 3.3
_PAIR_COST = 0.95
# The least a sub-tile costs: streaming its slabs.
_TRAFFIC_FLOOR = 1.7
# Column-bin widths (x blocks) of the binned ranked and packed layouts.
_BIN_WIDTHS = (1, 2, 4, 8, 16, 32, 64)
# Column-stripe widths of the binned sell candidates.
_STRIPE_WIDTHS = (16, 32, 64)
# DIA cost of one diagonal over 1024 rows.
_DIA_STEP_COST = 1.1
# Packed sub-tile surcharge over the ranked cost.
_PACKED_OVER = 3.0
# Charge per sub-tile of a ragged quantized layout (slab heights that
# differ between chunks); 0 for a uniform one.
_EPI_COST = 3.3


def exact_rank_nb(mat, align: bool = True, slots=None) -> tuple:
    """(chunk span, per-slot span) in x blocks, exact, O(nnz)
    (tpu_spmv.tune.model.exact_rank_nb). align measures the
    cluster-aligned slots RankedSlabs builds (_aligned_slots), else the
    ordinal ranks; slots: (ranks, kc) already computed."""
    from tpu_spmv_torch.formats.sell import _aligned_slots

    m = mat.m
    lens = mat.row_lengths.astype(np.int64)
    if mat.nnz == 0 or m == 0:
        return 1, 1
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    if align:
        ranks, kc_raw = slots if slots is not None else _aligned_slots(mat)
        maxlen = int(kc_raw.max())
    else:
        maxlen = int(lens.max())
        ranks = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
            mat.indptr[:-1].astype(np.int64), lens
        )
    blocks = mat.indices.astype(np.int64) >> 7
    chunks = rows // LANES
    nchunks = int(chunks.max()) + 1

    key = chunks * maxlen + ranks
    if nchunks * maxlen <= 8 * max(mat.nnz, 1):
        lo = np.full(nchunks * maxlen, np.iinfo(np.int64).max)
        hi = np.full(nchunks * maxlen, -1)
        np.minimum.at(lo, key, blocks)
        np.maximum.at(hi, key, blocks)
        used = hi >= 0
        rank_nb = int((hi[used] - lo[used]).max()) + 1 if used.any() else 1
    else:
        # One very long row on many chunks: sort by key and reduce over
        # the groups instead of a chunks x maxlen scratch.
        order = np.argsort(key, kind="stable")
        kb = blocks[order]
        starts = np.flatnonzero(
            np.concatenate(([True], key[order][1:] != key[order][:-1]))
        )
        glo = np.minimum.reduceat(kb, starts)
        ghi = np.maximum.reduceat(kb, starts)
        rank_nb = int((ghi - glo).max()) + 1 if starts.size else 1

    return _exact_chunk_nb(mat), rank_nb


def _exact_chunk_nb(mat) -> int:
    """The largest column span of a 128-row chunk, in x blocks. A chunk's
    entries are contiguous in CSR order, so its extremes are reductions
    over one slice each (the reference's scatter-min and scatter-max,
    without the scatter)."""
    if mat.nnz == 0 or mat.m == 0:
        return 1
    bounds = mat.indptr.astype(np.int64)[::LANES]
    if bounds[-1] != mat.nnz:
        bounds = np.append(bounds, mat.nnz)
    starts = bounds[:-1][bounds[1:] > bounds[:-1]]  # chunks with entries
    blocks = mat.indices.astype(np.int64) >> 7
    lo = np.minimum.reduceat(blocks, starts)
    hi = np.maximum.reduceat(blocks, starts)
    return int((hi - lo).max()) + 1


def _sample_chunks(mat, max_chunks: int = 256):
    """(submatrix of at most max_chunks evenly spaced 128-row chunks,
    total chunks / sampled ones). Slots are assigned per chunk, so
    per-chunk statistics of the sample scale linearly."""
    m = mat.m
    num_chunks = max(-(-m // LANES), 1)
    if num_chunks <= max_chunks:
        return mat, 1.0
    pick = np.unique(
        np.linspace(0, num_chunks - 1, max_chunks).astype(np.int64)
    )
    indptr = [np.zeros(1, np.int64)]
    indices, data = [], []
    total = 0
    ip = mat.indptr.astype(np.int64)
    for c in pick:
        r0, r1 = c * LANES, min((c + 1) * LANES, m)
        e0, e1 = int(ip[r0]), int(ip[r1])
        indptr.append(ip[r0 + 1 : r1 + 1] - e0 + total)
        indices.append(mat.indices[e0:e1])
        data.append(mat.data[e0:e1])
        total += e1 - e0
        if r1 - r0 < LANES:  # tail chunk: keep 128-row framing via pad rows
            indptr.append(np.full(LANES - (r1 - r0), total, np.int64))
    sub = CSRMatrix(
        np.concatenate(indptr).astype(np.int32),
        np.concatenate(indices),
        np.concatenate(data).astype(np.float32),
        (pick.shape[0] * LANES, mat.n),
    )
    return sub, num_chunks / pick.shape[0]


def _subtiles_from_kc(kc) -> int:
    """Sub-tiles of a quantized layout with per-chunk slot counts kc:
    each chunk rounded up to whole sub-tiles, at least one."""
    kcq = np.maximum((kc + SUBLANES - 1) // SUBLANES, 1)
    return int(kcq.sum())


def _cal(name: str, default: float) -> float:
    """A cost constant: the current card's measured value
    (hw.kernel_calibration) or `default`."""
    from tpu_spmv_torch.hw import kernel_calibration

    try:
        return float(kernel_calibration().get(name, default))
    except (TypeError, ValueError):
        return default


def _ranked_subtile_cost(rank_nb: int) -> float:
    pairs = max((rank_nb + 1) // 2, 1)
    return max(
        _cal("ranked_fixed", _RANKED_FIXED)
        + _cal("pair_cost", _PAIR_COST) * pairs,
        _cal("traffic_floor", _TRAFFIC_FLOOR),
    )


def _sell_subtile_cost(span: float) -> float:
    """A plain (sell) sub-tile over a chunk span of `span` blocks: the
    reference's ranked_fixed + max(span, floor) at the defaults."""
    return (_cal("sell_fixed", _cal("ranked_fixed", _RANKED_FIXED))
            + max(_cal("span_cost", 1.0) * span,
                  _cal("traffic_floor", _TRAFFIC_FLOOR)))


def _epi_cost(kc) -> float:
    """Per-sub-tile charge of a quantized layout with per-chunk slot
    counts kc: 0 when every chunk rounds to the same sub-tile count, the
    calibrated epi_cost otherwise."""
    kcq = np.maximum((np.asarray(kc) + SUBLANES - 1) // SUBLANES, 1)
    if kcq.size and (kcq == kcq[0]).all():
        return 0.0
    return _cal("epi_cost", _EPI_COST)


def _packed_x_fits(mat, rank_nb: int) -> bool:
    """kernels/sell.resident_x_fits for a layout not built yet: the
    packed kernels have no windowed variant, so a packed candidate is
    offered only when the padded x fits half of the L2 (hw.l2_bytes: the
    current card's, else the H100's)."""
    from tpu_spmv_torch.kernels.sell import resident_x_fits

    return resident_x_fits(types.SimpleNamespace(
        rank_nb=max(rank_nb, 1), n=mat.n, max_nb=1, vals=None))


@obs.span("build.plan")
def tpu_plan(mat, assume_rcm: bool = False, exact: bool = True,
             candidates: list | None = None) -> TpuPlan:
    """The least-cost kernel and layout for y = A @ x
    (tpu_spmv.tune.model.tpu_plan).

    mat: CSRMatrix, after RCM when assume_rcm. exact measures the spans
    (O(nnz); the slot statistics on a sample of at most 256 chunks);
    exact=False estimates from band percentiles alone. candidates: a
    list to which every candidate weighed is appended, as (cost, kernel,
    bin_blocks, reason, padding) (bench/calibration.py compares them
    with measured times).
    """
    from tpu_spmv_torch.formats.sell import _aligned_slots, _binned_slots

    m = mat.m
    bands = mat.row_bands()
    est_span_cols = float(np.percentile(bands, 95)) + LANES if m else 1.0
    est_nb = est_span_cols / LANES
    est_rank = est_nb
    if candidates is None:
        candidates = []  # (cost, kernel, bin_blocks, reason, pad_ratio)
    span_limit = _cal("span_limit", _SPAN_LIMIT)

    sampled = None
    if exact and mat.nnz and int(mat.row_lengths.max()) <= 2048:
        chunk_nb = _exact_chunk_nb(mat)  # the whole matrix's
        sampled, scale = _sample_chunks(mat)
        # The aligned slots of the sample serve both the rank span and
        # the aligned sub-tile count.
        ali_slots = _aligned_slots(sampled)
        _, rank_nb = exact_rank_nb(sampled, slots=ali_slots)
        est_nb, est_rank = float(chunk_nb), float(rank_nb)

        lens = sampled.row_lengths.astype(np.int64)
        nch = max(-(-sampled.m // LANES), 1)
        lpad = np.zeros(nch * LANES, np.int64)
        lpad[: sampled.m] = lens
        kc_ord = lpad.reshape(nch, LANES).max(axis=1)
        s_ord = _subtiles_from_kc(kc_ord) * scale
        if est_nb <= span_limit:
            candidates.append((
                s_ord * (_sell_subtile_cost(est_nb) + _epi_cost(kc_ord)),
                "sell", 0,
                f"plain gather loop over chunk span {est_nb:.0f} blocks",
                s_ord * SUBLANES * LANES / max(mat.nnz, 1),
            ))

        s_ali = _subtiles_from_kc(ali_slots[1]) * scale
        if est_rank <= 250:
            candidates.append((
                s_ali * (_ranked_subtile_cost(int(est_rank))
                         + _epi_cost(ali_slots[1])),
                "ranked", 0,
                f"aligned rank windows, span {est_rank:.0f} blocks",
                s_ali * SUBLANES * LANES / max(mat.nnz, 1),
            ))

        # Packed: the aligned slots without the 8-slot quantum (chunks of
        # max(kc, MIN_KC) slots back to back), when x passes the gate.
        if est_rank <= 250 and _packed_x_fits(mat, int(est_rank)):
            kc_pk = np.maximum(ali_slots[1], 4)  # formats.packed.MIN_KC
            s_pk = (-(-int(kc_pk.sum()) // SUBLANES)) * scale
            candidates.append((
                s_pk * (_ranked_subtile_cost(int(est_rank))
                        + _cal("packed_over", _PACKED_OVER)),
                "packed", 0,
                f"packed mixed-height slabs, span {est_rank:.0f} blocks "
                f"(pad {s_pk * SUBLANES * LANES / max(mat.nnz, 1):.2f}x)",
                s_pk * SUBLANES * LANES / max(mat.nnz, 1),
            ))

        binned = {}  # the bin slots, again used by the stripe candidates
        for w in _BIN_WIDTHS:
            if w * LANES >= 2 * max(mat.n, 1):
                break
            try:
                binned[w] = _binned_slots(sampled, w)
            except ValueError:
                continue
            kc_bin = binned[w][1]
            s_bin = _subtiles_from_kc(kc_bin) * scale
            candidates.append((
                s_bin * (_ranked_subtile_cost(w) + _epi_cost(kc_bin)),
                "ranked", w,
                f"column-binned rank windows, W={w} blocks, "
                f"padding {s_bin * SUBLANES * LANES / max(mat.nnz, 1):.1f}x",
                s_bin * SUBLANES * LANES / max(mat.nnz, 1),
            ))
            if _packed_x_fits(mat, w):
                kc_pk = np.maximum(kc_bin, 4)  # formats.packed.MIN_KC
                s_pk = (-(-int(kc_pk.sum()) // SUBLANES)) * scale
                candidates.append((
                    s_pk * (_ranked_subtile_cost(w)
                            + _cal("packed_over", _PACKED_OVER)),
                    "packed", w,
                    f"packed column-binned slabs, W={w} blocks (pad "
                    f"{s_pk * SUBLANES * LANES / max(mat.nnz, 1):.2f}x)",
                    s_pk * SUBLANES * LANES / max(mat.nnz, 1),
                ))

        # Column stripes: binned slots under the plain kernel, every
        # sub-tile paying the layout's span, measured on the sample's
        # layout (host only).
        from tpu_spmv_torch.formats.sell import SellSlabs

        for w in _STRIPE_WIDTHS:
            if w * LANES >= 2 * max(mat.n, 1):
                break
            try:
                n_sub, span = SellSlabs.shape_stats(
                    sampled, bin_blocks=w, slots=binned.get(w))
            except ValueError:
                continue
            if span > span_limit:
                continue
            s_str = n_sub * scale
            candidates.append((
                s_str * _sell_subtile_cost(float(span)),
                "sell", w,
                f"column-striped plain kernel, W={w} blocks "
                f"(span {span}, padding "
                f"{s_str * SUBLANES * LANES / max(mat.nnz, 1):.1f}x)",
                s_str * SUBLANES * LANES / max(mat.nnz, 1),
            ))

        # DIA: a sampled probe first, the exact profile only when the
        # sample passes the diagonal gate.
        from tpu_spmv_torch.formats.dia import (
            DIA_MAX_DIAGS, DIA_MAX_FILL, diagonal_profile,
        )

        d_s, _ = diagonal_profile(mat, sample_rows=256)
        if d_s <= DIA_MAX_DIAGS:
            d_x, fill_x = diagonal_profile(mat)
            if d_x <= DIA_MAX_DIAGS and fill_x <= DIA_MAX_FILL:
                units = max(-(-m // (SUBLANES * LANES)), 1)
                candidates.append((
                    units * max(d_x * _cal("dia_step_cost", _DIA_STEP_COST),
                                _cal("traffic_floor", _TRAFFIC_FLOOR)),
                    "dia", 0,
                    f"{d_x} constant diagonals, fill {fill_x:.2f}x — "
                    "index-free DIA kernel",
                    float(fill_x),
                ))

    needs_rcm = not assume_rcm and est_nb > 8 and m > LANES

    # SELL-C-sigma: recommended when the row sort cuts the sample's
    # ordinal sub-tiles by more than 20%.
    sigma = 0
    if sampled is not None and sampled.nnz:
        from tpu_spmv_torch.formats.sell import sigma_sort

        lens = sampled.row_lengths.astype(np.int64)
        nch = max(-(-sampled.m // LANES), 1)
        lpad = np.zeros(nch * LANES, np.int64)
        lpad[: sampled.m] = lens
        s_now = _subtiles_from_kc(lpad.reshape(nch, LANES).max(axis=1))
        cand_sigma = 32 * LANES
        sorted_sub, _ = sigma_sort(sampled, cand_sigma)
        lpad[: sampled.m] = sorted_sub.row_lengths
        s_sorted = _subtiles_from_kc(lpad.reshape(nch, LANES).max(axis=1))
        if s_sorted < 0.8 * s_now:
            sigma = cand_sigma

    if not candidates:
        # Estimate-only path (exact=False, or no candidate): span
        # thresholds.
        ric = _cal("ranked_iter_cost", _RANKED_ITER_COST)
        if est_nb > span_limit and est_rank * ric > span_limit:
            kernel, bin_blocks, reason = "segsum", 0, (
                f"chunk span ~{est_nb:.0f} blocks exceeds {span_limit:g}; "
                "the segment-sum baseline"
            )
        elif est_nb > ric * est_rank and est_rank <= 250:
            kernel, bin_blocks, reason = "ranked", 0, (
                f"rank span {est_rank:.0f} vs chunk span {est_nb:.0f}"
            )
        else:
            kernel, bin_blocks, reason = "sell", 0, (
                f"chunk span {est_nb:.0f} vs rank span {est_rank:.0f}"
            )
        cost = 0.0
    else:
        cost, kernel, bin_blocks, reason, pad = min(
            candidates, key=lambda c: c[0]
        )
        # The least cost may still carry 10-80x fill on uniformly
        # scattered structure: say so.
        if pad > 8.0:
            reason += " [padding-floor class: scattered structure;"\
                " see PERF_NOTES scattered-floor model]"

    if kernel == "dia":
        # A permutation or a row sort would break the diagonals.
        needs_rcm = False
        sigma = 0

    return TpuPlan(
        kernel=kernel,
        tile_k=2048,
        needs_rcm=needs_rcm,
        est_max_nb=est_nb,
        est_rank_nb=est_rank,
        reason=reason,
        bin_blocks=bin_blocks,
        est_cost=float(cost),
        sigma=sigma,
    )
