"""Reformat a .csr file into CSR-k artifacts.

The port's copy of `tpu_spmv.tools.reformat` (host code, no device), held
equal to it by tests/test_torch_tools.py.

Role-equivalent of reformat-csr-to-csr3 (reference: spmv.cpp:132-197 for
`reformat`, spmv-auto.cpp:132-202 for `reformat-auto`): runs the CSR-3
preprocessing (coarsen + RCM + reorder) and writes either the reordered
plain CSR or a .csr3 file carrying both super-row pointer arrays.

Super-row sizes come from the command line or (with --auto) from the
reference's density model (--arch selects which published formula).

Usage:
  python -m tpu_spmv_torch.tools.reformat in.csr out.csr3 --auto [--arch volta]
  python -m tpu_spmv_torch.tools.reformat in.csr out.csr --srs 24 --ssrs 8 --plain
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_spmv_torch.formats.csrk import CSRkMatrix
from tpu_spmv_torch.io.csr_text import (
    read_csr_text,
    write_csr2_text,
    write_csr3_text,
    write_csr_text,
)
from tpu_spmv_torch.tune.model import reference_gpu_params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--auto", action="store_true",
                    help="pick srs/ssrs from the density model")
    ap.add_argument("--arch", default="volta",
                    choices=("volta", "ampere", "mi100", "legacy"),
                    help="density model used with --auto (reformat-auto embeds volta)")
    ap.add_argument("--srs", type=int, help="super-row size (rows)")
    ap.add_argument("--ssrs", type=int, help="super-super-row size (super-rows)")
    ap.add_argument("--plain", action="store_true",
                    help="write reordered plain .csr instead of .csr3")
    args = ap.parse_args(argv)

    mat = read_csr_text(args.input)
    if args.auto:
        p = reference_gpu_params(mat.density, args.arch)
        srs, ssrs = p["srs"], p["ssrs"]
        print(f"using ssrs {ssrs}, srs {srs}")
    else:
        if args.srs is None or args.ssrs is None:
            ap.error("--srs and --ssrs are required without --auto")
        srs, ssrs = args.srs, args.ssrs

    tic = time.perf_counter()
    k = 2 if args.output.endswith(".csr2") else 3
    sup = (srs,) if k == 2 else (srs, ssrs)
    ck = CSRkMatrix.build(mat, k=k, sup_row_sizes=sup)
    print(f"preprocessing took {time.perf_counter() - tic:f}s")

    if args.plain:
        write_csr_text(args.output, ck.matrix)
    elif k == 2:
        write_csr2_text(args.output, ck.matrix, ck.maps[0])
    else:
        write_csr3_text(args.output, ck.matrix, ck.maps[1], ck.maps[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
