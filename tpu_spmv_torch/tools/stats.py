"""Matrix-structure diagnostics for .csr/.csr3/.mtx files.

The port's copy of `tpu_spmv.tools.stats` (host code, no device), held
equal to it by tests/test_torch_tools.py.

Role-equivalent of the reference's stats tools (spmv-csr/stats.c:57-123
and reformat-csr-to-csr3/stats.c:85-160), printing the same keys.

Usage: python -m tpu_spmv_torch.tools.stats file.csr [file2.csr3 ...]
"""

from __future__ import annotations

import argparse
import sys

from tpu_spmv_torch.io.csr_text import read_csr2_text, read_csr3_text, read_csr_text
from tpu_spmv_torch.io.matrix_market import read_mtx


def load(path):
    if path.endswith(".csr3"):
        mat, _, _ = read_csr3_text(path)
        return mat
    if path.endswith(".csr2"):
        mat, _ = read_csr2_text(path)
        return mat
    if path.endswith(".mtx") or path.endswith(".mtx.gz"):
        return read_mtx(path)
    return read_csr_text(path)


def print_stats(mat):
    s = mat.stats()
    m = max(mat.m, 1)
    print(f"NNZ Avg: {s['nnz_avg']:f} ")
    print(f"NNZ Min: {s['nnz_min']}  Percent: {s['nnz_min'] / m:f} ")
    print(f"NNZ Max: {s['nnz_max']}  Percent: {s['nnz_max'] / m:f} ")
    print(f"NNZ Var: {s['nnz_var']:f} ")
    print(f"Band Avg: {s['band_avg']:f} ")
    print(f"Band Max: {s['band_max']} Percent: {s['band_max'] / m:f} ")
    print(f"Band Min: {s['band_min']} Percent: {s['band_min'] / m:f} ")
    print(f"Band Var: {s['band_var']:f} ")
    print(f"Total NNZ: {s['total_nnz']}")
    print(f"Dim: {s['dim'][0]}x{s['dim'][1]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    for path in args.inputs:
        if len(args.inputs) > 1:
            print(f"== {path}")
        print_stats(load(path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
