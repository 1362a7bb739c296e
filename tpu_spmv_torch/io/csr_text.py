"""Reference-compatible .csr / .csr3 text formats.

The reference pipeline persists matrices as whitespace-separated text:

  .csr   "m n nnz" then m+1 row pointers, nnz column indices, nnz values
         (written 0-based by helpers/converter.m:25-49 via sparse2csr.m:5-6;
         the plain-CSR readers consume it as-is, spmv-csr/spmv.c:11-57, while
         the CSR-k readers subtract 1 expecting 1-based input,
         spmv-csrk/spmv.cpp:32-79 — we autodetect and normalize to 0-based).

  .csr3  "numCoarsestRows numCoarserRows m n nnz" then the coarsest and
         coarser super-row pointer arrays, then r/c/val
         (reformat-csr-to-csr3/spmv-auto.cpp:30-65).
"""

from __future__ import annotations

import numpy as np

from tpu_spmv_torch.formats.csr import CSRMatrix


def _read_tokens(path):
    with open(path) as f:
        return f.read().split()


def _read_numeric(path) -> np.ndarray | None:
    """Parse the whole file as whitespace-separated numbers with NumPy's
    C tokenizer (the native data-loader path — the reference reads these
    files with C scanf loops, spmv-csr/spmv.c:11-57; the Python
    str.split tokenizer takes minutes at reference scale). float64 holds
    integers exactly below 2^53, far above any index here. Returns None
    when the file has non-numeric tokens (fallback to the slow path)."""
    try:
        arr = np.fromfile(path, dtype=np.float64, sep=" ")
    except (ValueError, OSError):
        return None
    return arr if arr.size else None


def _detect_base(indptr: np.ndarray, indices: np.ndarray, n: int) -> int:
    """Infer whether the on-disk arrays are 0- or 1-based."""
    if indptr[0] == 0:
        return 0
    if indptr[0] == 1:
        return 1
    raise ValueError(f"cannot infer index base: indptr[0]={indptr[0]}")


def read_csr_text(path, base: int | None = None) -> CSRMatrix:
    """Read a .csr text file, normalizing to 0-based indices.

    base: force 0 or 1; None autodetects from indptr[0] (and sanity-checks
    column range).
    """
    num = _read_numeric(path)
    if num is not None and num.shape[0] >= 3:
        m, n, nnz = int(num[0]), int(num[1]), int(num[2])
        need = 3 + (m + 1) + 2 * nnz
        if num.shape[0] < need:
            # np.fromfile stops silently at the first non-numeric token,
            # so a short parse may mean exotic formatting (e.g. Fortran
            # 1.5D0) rather than truncation — retry with the tokenizer,
            # whose errors name the offending token.
            num = None
    else:
        num = None
    if num is not None:
        indptr = num[3 : 3 + m + 1].astype(np.int64)
        indices = num[3 + m + 1 : 3 + m + 1 + nnz].astype(np.int64)
        data = num[3 + m + 1 + nnz : need].astype(np.float32)
    else:
        tok = _read_tokens(path)
        m, n, nnz = int(tok[0]), int(tok[1]), int(tok[2])
        need = 3 + (m + 1) + 2 * nnz
        if len(tok) < need:
            raise ValueError(f"{path}: expected {need} tokens, found {len(tok)}")
        indptr = np.array(tok[3 : 3 + m + 1], dtype=np.int64)
        indices = np.array(tok[3 + m + 1 : 3 + m + 1 + nnz], dtype=np.int64)
        data = np.array(tok[3 + m + 1 + nnz : need], dtype=np.float32)
    if base is None:
        base = _detect_base(indptr, indices, n)
    if base == 1:
        indptr = indptr - 1
        indices = indices - 1
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(f"{path}: column indices out of range for base={base}")
    return CSRMatrix(indptr, indices, data, (m, n))


def write_csr_text(path, mat: CSRMatrix, base: int = 0) -> None:
    """Write .csr text (0-based by default, matching converter.m output)."""
    off = int(base)
    with open(path, "w") as f:
        f.write(f"{mat.m} {mat.n} {mat.nnz}\n")
        f.write(" ".join(map(str, (mat.indptr.astype(np.int64) + off).tolist())))
        f.write(" \n")
        f.write(" ".join(map(str, (mat.indices.astype(np.int64) + off).tolist())))
        f.write(" \n")
        f.write(" ".join(f"{v:.6f}" for v in mat.data.tolist()))
        f.write(" \n")


def read_csr2_text(path):
    """Read a .csr2 file: returns (mat, sup_row_ptr).

    Single-level analog of .csr3 (reference: the `./reformat in out srs`
    path, reformat-csr-to-csr3/spmv.cpp:132-197): header of four ints
    (numCoarserRows m n nnz), the super-row pointer array, then CSR.
    """
    num = _read_numeric(path)
    if num is None or num.shape[0] < 4:
        num = np.array(_read_tokens(path), dtype=np.float64)
    n_sup, m, n, nnz = (int(t) for t in num[:4])
    if num.shape[0] < 4 + (n_sup + 1) + (m + 1) + 2 * nnz:
        num = np.array(_read_tokens(path), dtype=np.float64)  # exotic tokens
    p = 4
    sup = num[p : p + n_sup + 1].astype(np.int64)
    p += n_sup + 1
    indptr = num[p : p + m + 1].astype(np.int64)
    p += m + 1
    indices = num[p : p + nnz].astype(np.int64)
    p += nnz
    data = num[p : p + nnz].astype(np.float32)
    return CSRMatrix(indptr, indices, data, (m, n)), sup.astype(np.int32)


def write_csr2_text(path, mat: CSRMatrix, sup_row_ptr) -> None:
    """Write a .csr2 file (single pointer level; see read_csr2_text)."""
    sup_row_ptr = np.asarray(sup_row_ptr, dtype=np.int64)
    with open(path, "w") as f:
        f.write(f"{sup_row_ptr.shape[0] - 1} {mat.m} {mat.n} {mat.nnz} \n")
        for arr in (
            sup_row_ptr,
            mat.indptr.astype(np.int64),
            mat.indices.astype(np.int64),
        ):
            f.write(" ".join(map(str, arr.tolist())))
            f.write(" ")
        f.write(" ".join(f"{v:.6f}" for v in mat.data.tolist()))
        f.write(" ")


def read_csr3_text(path):
    """Read a .csr3 file: returns (mat, coarsest_ptr, coarser_ptr).

    Layout per reformat-csr-to-csr3/spmv-auto.cpp:38-63: header of five ints,
    then the two super-row pointer arrays (0-based), then plain CSR arrays.
    """
    num = _read_numeric(path)
    if num is None or num.shape[0] < 5:
        num = np.array(_read_tokens(path), dtype=np.float64)
    n_coarsest, n_coarser, m, n, nnz = (int(t) for t in num[:5])
    if num.shape[0] < 5 + (n_coarsest + 1) + (n_coarser + 1) + (m + 1) + 2 * nnz:
        num = np.array(_read_tokens(path), dtype=np.float64)  # exotic tokens
    p = 5
    coarsest = num[p : p + n_coarsest + 1].astype(np.int64)
    p += n_coarsest + 1
    coarser = num[p : p + n_coarser + 1].astype(np.int64)
    p += n_coarser + 1
    indptr = num[p : p + m + 1].astype(np.int64)
    p += m + 1
    indices = num[p : p + nnz].astype(np.int64)
    p += nnz
    data = num[p : p + nnz].astype(np.float32)
    mat = CSRMatrix(indptr, indices, data, (m, n))
    return mat, coarsest.astype(np.int32), coarser.astype(np.int32)


def write_csr3_text(path, mat: CSRMatrix, coarsest_ptr, coarser_ptr) -> None:
    """Write a .csr3 file (reformat-auto's my_write_csr equivalent)."""
    coarsest_ptr = np.asarray(coarsest_ptr, dtype=np.int64)
    coarser_ptr = np.asarray(coarser_ptr, dtype=np.int64)
    with open(path, "w") as f:
        f.write(
            f"{coarsest_ptr.shape[0] - 1} {coarser_ptr.shape[0] - 1} "
            f"{mat.m} {mat.n} {mat.nnz} \n"
        )
        for arr in (
            coarsest_ptr,
            coarser_ptr,
            mat.indptr.astype(np.int64),
            mat.indices.astype(np.int64),
        ):
            f.write(" ".join(map(str, arr.tolist())))
            f.write(" ")
        f.write(" ".join(f"{v:.6f}" for v in mat.data.tolist()))
        f.write(" ")
