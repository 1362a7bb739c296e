"""Multi-card scaling report: shard balance and interconnect traffic
(the port of `python -m tpu_spmv.tools.scaling`).

  * report(): per-shard rows/nnz balance, the halo width the banded
    exchange needs (and whether it applies), and the bytes a device
    moves a SpMV: the halo exchange (2 * halo * 4 B) against the
    all-gather (n * (D - 1) / D * 4 B). Host only, the reference's dict
    key for key. The key and line names keep the reference's "ici": on
    the card it is the peer link (NVLink).
  * weak_scaling(): m = D * base_rows, the work a device constant; the
    model's efficiency from the single-card SpMV rate and the link rates
    (_model_rates), and the sharded SpMV (spmv_sharded, and spmv_overlap
    where the halo applies) executed and validated against the serial
    oracle on a (2, D / 2) (hosts, rows) mesh when D >= 4 and even, as
    the reference runs it, else on a row mesh: D shards on the CPU with
    --device cpu; on the card, D cards when the machine has them, else D
    shards on the one card.

Usage:
  python -m tpu_spmv_torch.tools.scaling matrix.mtx|synthetic:NAME
      --devices 8 [--rcm]
  python -m tpu_spmv_torch.tools.scaling --weak [--devices 2 4 8]
      [--base-rows 4096] [--band 64] [--out rows.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def report(mat, n_devices: int) -> dict:
    from tpu_spmv_torch.dist.sharding import _round_up
    from tpu_spmv_torch.formats.sell import LANES

    m, n = mat.shape
    rows_per_shard = _round_up(_round_up(m, n_devices) // n_devices, 8 * LANES)
    shard_nnz = []
    reach = 0
    for d in range(n_devices):
        r0 = min(d * rows_per_shard, m)
        r1 = min((d + 1) * rows_per_shard, m)
        shard_nnz.append(int(mat.indptr[r1] - mat.indptr[r0]))
        cs = mat.indices[mat.indptr[r0] : mat.indptr[r1]]
        if cs.size:
            reach = max(reach, int(r0 - cs.min()), int(int(cs.max()) + 1 - r1))
    halo_ok = reach <= rows_per_shard
    halo_rows = _round_up(max(reach, LANES), LANES) if halo_ok else 0
    halo_bytes = 2 * halo_rows * 4
    allgather_bytes = int(n * (n_devices - 1) / n_devices * 4)
    nnz_arr = np.asarray(shard_nnz, dtype=np.float64)
    return {
        "devices": n_devices,
        "rows_per_shard": rows_per_shard,
        "shard_nnz_min": int(nnz_arr.min()),
        "shard_nnz_max": int(nnz_arr.max()),
        "shard_nnz_imbalance": float(nnz_arr.max() / max(nnz_arr.mean(), 1)),
        "halo_applicable": halo_ok,
        "halo_rows": halo_rows,
        "ici_bytes_per_dev_halo": halo_bytes,
        "ici_bytes_per_dev_allgather": allgather_bytes,
        "halo_traffic_saving": (
            round(allgather_bytes / max(halo_bytes, 1), 1) if halo_ok else 1.0
        ),
    }


def _model_rates() -> tuple[float, float, float]:
    """(single-card nnz/s, peer-link B/s, network B/s) for the efficiency
    projection: the card's HBM rate (the H100's without a card) over
    hw.SPMV_BYTES_PER_NNZ, and the H100 SXM's data-sheet link rates."""
    from tpu_spmv_torch import hw

    hbm = (hw.device_spec().hbm_bytes_per_s if torch.cuda.is_available()
           else hw.hbm_bytes_per_s("H100"))
    return (hbm / hw.SPMV_BYTES_PER_NNZ, hw.H100_PEER_BYTES_PER_S,
            hw.H100_NETWORK_BYTES_PER_S)


def _devices(d: int, device) -> list:
    """The devices of a D-shard run: D shards on the CPU; on the card, D
    cards when the machine has them, else D shards on the one card."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * d
    if torch.cuda.device_count() >= d:
        return [torch.device("cuda", i) for i in range(d)]
    return [torch.device("cuda", 0)] * d


def weak_scaling(d_list, base_rows: int = 4096, band: int = 64,
                 nnz_per_row: int = 8, execute: bool = True,
                 device="cuda") -> list:
    """Weak scaling: m = D * base_rows, the work a device constant, the
    halo traffic a device O(band), not O(n). Executes the sharded
    rank-windowed SpMV on `device` (see the module docstring) and
    validates it against the serial oracle; returns the rows (the CSV
    schema), the reference's keys and model."""
    from tpu_spmv_torch.bench.harness import validate
    from tpu_spmv_torch.bench.matrices import random_banded
    from tpu_spmv_torch.dist.multihost import make_hybrid_mesh
    from tpu_spmv_torch.dist.sharding import (
        OverlapRanked, ShardedRanked, gather_vector, make_row_mesh,
        shard_vector, spmv_overlap, spmv_sharded,
    )
    from tpu_spmv_torch.reorder import rcm as rcm_fn

    rows = []
    for d in d_list:
        mat = random_banded(base_rows * d, band, nnz_per_row, seed=0)
        mat = mat.permuted(rcm_fn(mat.indptr, mat.indices))
        lay = ShardedRanked.build(mat, d)
        # >= 4 even devices: the two-host schedule, a (2, d/2) mesh whose
        # host-boundary halo pair crosses the network.
        hosts = 2 if (d >= 4 and d % 2 == 0) else 1
        halo_bytes = 2 * lay.halo * 4
        exchange_bytes = halo_bytes if lay.halo else int(
            mat.n * (d - 1) / max(d, 1) * 4
        )
        local_nnz = mat.nnz / d
        chip_nnzs, ici_bs, dcn_bs = _model_rates()
        t_comp = local_nnz / chip_nnzs
        # Pairwise exchanges run together; the slowest link bounds the
        # step: the network pair of the two-host mesh.
        link_bs = dcn_bs if hosts > 1 else ici_bs
        t_comm = exchange_bytes / link_bs if d > 1 else 0.0
        # The overlap hides the exchange behind the interior kernel; only
        # the edge share of the compute waits for it.
        t_plain = t_comp + t_comm
        t_over = t_plain
        if d > 1 and lay.halo:
            rps = lay.rows_per_shard
            row_of = np.repeat(np.arange(mat.m, dtype=np.int64),
                               mat.row_lengths)
            edge_nnz = int(np.sum((mat.indices // rps) != (row_of // rps)))
            edge_frac = edge_nnz / max(mat.nnz, 1)
            t_over = (max(t_comp * (1 - edge_frac), t_comm)
                      + t_comp * edge_frac)
        row = {
            "devices": d,
            "hosts": hosts,
            "rows": mat.m,
            "nnz": mat.nnz,
            "halo_rows": lay.halo,
            "ici_bytes_per_dev": exchange_bytes,
            "model_efficiency": t_comp / t_plain,
            "overlap_efficiency": t_comp / t_over,
            "executed": False,
            "num_wrong": "",
            "rel_l2": "",
        }
        if execute:
            devs = _devices(d, device)
            if hosts > 1:
                mesh = make_hybrid_mesh(num_hosts=hosts, devices=devs)
                axis = ("hosts", "rows")
            else:
                mesh, axis = make_row_mesh(devs), "rows"
            lp = lay.device_put(mesh, axis)
            x = np.random.default_rng(1).standard_normal(mat.n).astype(
                np.float32)
            xs = shard_vector(x, mesh, lp.padded_m)
            y = gather_vector(spmv_sharded(lp, xs, mesh, axis))[: mat.m]
            y_ref = mat.matvec(x)
            wrong, rel = validate(y, y_ref)
            if d > 1 and lay.halo:
                # The overlapped schedule must agree too.
                op = OverlapRanked.build(mat, d).device_put(mesh, axis)
                y_o = gather_vector(spmv_overlap(op, xs, mesh, axis))[: mat.m]
                wrong += validate(y_o, y_ref)[0]
            row.update(executed=True, num_wrong=wrong, rel_l2=f"{rel:.3g}")
        rows.append(row)
    return rows


def main(argv=None):
    from tpu_spmv_torch.tools.spmv import load_input

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None,
                    help="matrix file / synthetic:<name> (traffic report "
                    "mode); omit with --weak")
    ap.add_argument("--devices", type=int, nargs="*", default=[2, 4, 8, 16])
    ap.add_argument("--rcm", action="store_true",
                    help="apply RCM first (halo width depends on it)")
    ap.add_argument("--weak", action="store_true",
                    help="run the executable weak-scaling harness "
                    "(m = D * base-rows per step) instead of the static "
                    "traffic report")
    ap.add_argument("--base-rows", type=int, default=4096)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--out", default=None, help="CSV output (weak mode)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="weak mode: where the shards run (cpu: the plain "
                    "versions)")
    args = ap.parse_args(argv)

    if args.weak:
        import csv as csvmod

        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the port runs on a CUDA card "
                             "(use --device cpu for a CPU check)")
        rows = weak_scaling(args.devices, base_rows=args.base_rows,
                            band=args.band, device=args.device)
        for r in rows:
            print(
                f"D={r['devices']}: rows={r['rows']} "
                f"halo={r['halo_rows']} rows, "
                f"{r['ici_bytes_per_dev']} B/dev over ICI, "
                f"model efficiency {100 * r['model_efficiency']:.1f}% "
                f"(overlapped {100 * r['overlap_efficiency']:.1f}%)"
                + (
                    f" | executed wrong={r['num_wrong']} rel={r['rel_l2']}"
                    if r["executed"] else " | not executed (devices)"
                )
            )
        if args.out:
            with open(args.out, "w", newline="") as f:
                w = csvmod.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
        worst = min(
            (r["model_efficiency"] for r in rows if r["devices"] > 1),
            default=1.0,
        )
        print(f"worst model efficiency: {100 * worst:.1f}% (target >= 70%)")
        return 0 if worst >= 0.70 else 1

    mat = load_input(args.input)
    if args.rcm:
        from tpu_spmv_torch.reorder import rcm

        mat = mat.permuted(rcm(mat.indptr, mat.indices))
    for d in args.devices:
        r = report(mat, d)
        print(
            f"D={r['devices']}: rows/shard {r['rows_per_shard']} "
            f"nnz imbalance {r['shard_nnz_imbalance']:.2f} | "
            + (
                f"halo {r['halo_rows']} rows -> "
                f"{r['ici_bytes_per_dev_halo']} B/dev over ICI "
                f"({r['halo_traffic_saving']}x less than all-gather)"
                if r["halo_applicable"]
                else f"all-gather {r['ici_bytes_per_dev_allgather']} B/dev "
                "(columns reach past neighbor shards)"
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
