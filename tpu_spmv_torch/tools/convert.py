"""Convert MatrixMarket files to .csr text, optionally RCM-reordered.

The port's copy of `tpu_spmv.tools.convert` (host code, no device), held
equal to it by tests/test_torch_tools.py.

Role-equivalent of helpers/converter.m (reference: converter.m:4-52):
for each input .mtx, write `<name>.csr` (original order) and
`<name>.rcm.csr` (symmetric RCM permutation) next to the requested
output directories.

Usage:
  python -m tpu_spmv_torch.tools.convert matrix.mtx [more.mtx ...] \
      [--norm-dir norm] [--rcm-dir rcm] [--backend auto|native|numpy]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from tpu_spmv_torch import obs
from tpu_spmv_torch.io.csr_text import write_csr_text
from tpu_spmv_torch.io.matrix_market import read_mtx
from tpu_spmv_torch.reorder import rcm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="+", help=".mtx files")
    ap.add_argument("--norm-dir", default="norm")
    ap.add_argument("--rcm-dir", default="rcm")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--base", type=int, default=0, choices=(0, 1),
                    help="index base for the .csr output (reference files are 0-based)")
    ap.add_argument("--mtx-out", action="store_true",
                    help="also write the RCM-permuted matrix as "
                    "<name>.rcm in MatrixMarket form (converter_mm.m role)")
    args = ap.parse_args(argv)

    norm_dir = pathlib.Path(args.norm_dir)
    rcm_dir = pathlib.Path(args.rcm_dir)
    norm_dir.mkdir(parents=True, exist_ok=True)
    rcm_dir.mkdir(parents=True, exist_ok=True)

    for path in args.inputs:
        name = pathlib.Path(path).name
        print(f"Converting matrix {name}...", end="", flush=True)
        mat = read_mtx(path)
        since = obs.mark()
        perm = rcm(mat.indptr, mat.indices, backend=args.backend)
        reordered = mat.permuted(perm)
        print(f"reordered in {obs.phase_seconds(since):f}...", end="")
        write_csr_text(norm_dir / f"{name}.csr", mat, base=args.base)
        write_csr_text(rcm_dir / f"{name}.rcm.csr", reordered, base=args.base)
        if args.mtx_out:
            from tpu_spmv_torch.io.matrix_market import write_mtx

            write_mtx(rcm_dir / f"{name}.rcm", reordered)
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
