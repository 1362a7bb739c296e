"""Format-overhead and load-balance analyzers.

Role-equivalents of the reference's offline analysis helpers:
  * calculate_overhead.m (helpers/calculate_overhead.m:5-35): bytes in
    memory per format (coo/csr/csr2/csr3) — extended with the device
    layouts (SELL slabs / rank-windowed slabs).
  * analyze_warp_nnz.m (helpers/analyze_warp_nnz.m:23-66): replays the
    kernel's work decomposition counting nnz per work unit to expose
    load imbalance — here per (8,128) sub-tile and per 512-sublane tile.

The port's copy of `tpu_spmv.tools.analyze`, on the port's layouts
(whose arrays, and so whose byte counts, are the reference's): the
reference's keys, plus `<layout>_device_bytes`, what the port's
container holds on the card with its derived tables (segment, run and
window tables). The dense datum uses the card's data-sheet bandwidth,
the H100's without a card. Held to the reference by
tests/test_torch_tools.py.

Usage: python -m tpu_spmv_torch.tools.analyze matrix.csr [--k 3 --sizes 8 8]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def format_overheads(mat, k: int = 3, sup_row_sizes=(8, 8)) -> dict:
    """Bytes in memory per representation (4-byte words like the
    reference: calculate_overhead.m:5-13)."""
    m, nnz = mat.m, mat.nnz
    out = {
        "coo": 3 * nnz * 4,
        "csr": (m + 1 + 2 * nnz) * 4,
    }
    # csr2 = (sr + m + 2 nnz) * 4 ; csr3 = (ssr + sr + m + 2 nnz) * 4 with
    # level sizes from the actual hierarchy.
    try:
        from tpu_spmv_torch.formats.csrk import CSRkMatrix

        if k >= 2:
            c2 = CSRkMatrix.build(mat, k=2, sup_row_sizes=sup_row_sizes[:1])
            out["csr2"] = (c2.maps[0].shape[0] + m + 2 * nnz) * 4
        if k >= 3:
            c3 = CSRkMatrix.build(mat, k=3, sup_row_sizes=sup_row_sizes[:2])
            out["csr3"] = (
                c3.maps[0].shape[0] + c3.maps[1].shape[0] + m + 2 * nnz
            ) * 4
    except Exception as e:  # singular structures; report what we can
        out["csrk_error"] = str(e)

    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs

    sell = SellSlabs.from_csr(mat)
    out["sell"] = sell.hbm_bytes
    out["sell_padding_ratio"] = sell.padding_ratio
    out["sell_device_bytes"] = sell.nbytes
    try:
        ranked = RankedSlabs.from_csr(mat)
        out["ranked"] = ranked.hbm_bytes
        out["ranked_rank_nb"] = ranked.rank_nb
        out["sell_max_nb"] = sell.max_nb
        out["ranked_device_bytes"] = ranked.nbytes
    except ValueError as e:
        out["ranked_error"] = str(e)
    # Round-3 formats: report when the structure admits them.
    try:
        from tpu_spmv_torch.formats.packed import PackedRanked

        pk = PackedRanked.from_csr(mat)
        out["packed"] = pk.hbm_bytes
        out["packed_padding_ratio"] = pk.padding_ratio
        out["packed_device_bytes"] = pk.nbytes
    except Exception as e:
        out["packed_error"] = str(e)
    try:
        from tpu_spmv_torch.formats.dia import DiaSlabs

        dl = DiaSlabs.from_csr(mat)
        out["dia"] = dl.hbm_bytes
        out["dia_num_diagonals"] = dl.num_diagonals
        out["dia_device_bytes"] = dl.nbytes
    except Exception as e:
        out["dia_error"] = str(e)
    return out


def load_balance(mat) -> dict:
    """Work distribution across the kernels' units (the reference
    counts nnz and loop iterations per 4-super-row warp,
    analyze_warp_nnz.m:23-57)."""
    from tpu_spmv_torch.formats.sell import LANES, SUBLANES, SellSlabs

    sell = SellSlabs.from_csr(mat)
    vals = sell.vals.numpy()
    real = (vals != 0.0).reshape(sell.num_subtiles, SUBLANES * LANES)
    per_sub = real.sum(axis=1)
    tile_subs = 512 // SUBLANES
    ntiles = max(sell.num_subtiles // tile_subs, 1)
    per_tile = per_sub[: ntiles * tile_subs].reshape(ntiles, tile_subs).sum(axis=1)
    nb = sell.sub_nb.numpy()

    def spread(a):
        a = a.astype(np.float64)
        return {
            "min": float(a.min()) if a.size else 0.0,
            "max": float(a.max()) if a.size else 0.0,
            "avg": float(a.mean()) if a.size else 0.0,
            "cv": float(a.std() / max(a.mean(), 1e-30)) if a.size else 0.0,
        }

    return {
        "subtile_nnz": spread(per_sub),
        "tile_nnz": spread(per_tile),
        "subtile_gather_blocks": spread(nb),
        "num_subtiles": sell.num_subtiles,
        "padding_ratio": sell.padding_ratio,
    }


def dense_roofline(mat) -> dict:
    """Dense-GEMV equivalent datum — the 'fourth vendor baseline' role.

    The reference reports MKL/cuSPARSE/hipSPARSE/Kokkos numbers per
    matrix; the extra baseline is the DENSE operator: a dense y = A x
    moves m*n*4 bytes of operator at HBM rate (arithmetic is never the
    bound at these aspect ratios), so its achievable effective-sparse
    rate is 2*nnz / (m*n*4 / BW). For every benchmark matrix this is
    orders of magnitude below the sparse kernels.
    """
    import torch

    from tpu_spmv_torch import hw

    bw = (hw.device_spec().hbm_bytes_per_s if torch.cuda.is_available()
          else hw.hbm_bytes_per_s("H100"))
    dense_bytes = mat.m * mat.n * 4
    dense_time = dense_bytes / bw
    return {
        "dense_operator_mb": dense_bytes / 2**20,
        "dense_time_s": dense_time,
        "dense_equiv_gflops": 2 * mat.nnz / dense_time / 1e9,
        "density": mat.nnz / max(mat.m * mat.n, 1),
    }


def main(argv=None):
    from tpu_spmv_torch.tools.stats import load

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--sizes", type=int, nargs="*", default=[8, 8])
    args = ap.parse_args(argv)

    mat = load(args.input)
    print("== format overheads (bytes)")
    for name, v in format_overheads(mat, args.k, tuple(args.sizes)).items():
        print(f"{name}: {v}")
    print("== kernel load balance")
    for name, v in load_balance(mat).items():
        print(f"{name}: {v}")
    print("== dense-GEMV equivalent (vendor-baseline datum)")
    for name, v in dense_roofline(mat).items():
        print(f"{name}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
