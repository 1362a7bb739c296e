"""The roofline counts on a hand-worked matrix."""

import numpy as np
import pytest

from spmv_bench import roofline
from spmv_bench.matrices import Csr

# [[4, -1, 0], [-1, 4, -1], [0, -1, 4]]: n = 3, nnz = 7, lower nnz 5.
A = Csr(np.array([0, 2, 5, 7]), np.array([0, 1, 0, 1, 2, 1, 2], np.int32),
        np.array([4, -1, -1, 4, -1, -1, 4], np.float32), 3)


def test_spmv_counts():
    w = roofline.spmv(A.n, A.nnz)
    assert w.flops == 14 and w.nbytes == 4 * 7 + 4 * 3 + 4 * 3 == 52
    assert w.least_s == pytest.approx(52 / 3.35e12)


def test_iteration_counts():
    assert A.lower_nnz() == 5
    cg = roofline.cg_iteration(A.n, A.nnz)
    assert (cg.flops, cg.nbytes) == (14, 4 * 7 + 8 * 4 * 3)
    pcg = roofline.pcg_ic0_iteration(A.n, A.nnz, A.lower_nnz())
    assert (pcg.flops, pcg.nbytes) == (14 + 20, 4 * 7 + 2 * 4 * 5 + 12 * 4 * 3)
    assert roofline.cg_start(3).nbytes == 48
    assert roofline.pcg_ic0_start(3, 5).nbytes == 4 * 10 + 6 * 12


def test_least_time_takes_the_larger_bound():
    w = roofline.Work(flops=67e12, nbytes=1.0)
    assert w.least_s == pytest.approx(1.0)
    assert (w * 2 + w).least_s == pytest.approx(3.0)


def test_cell_sizes():
    n, nnz = 1_124_864, 29_791_000
    assert roofline.spmv(n, nnz).nbytes == pytest.approx(128.162912e6)
    assert roofline.spmv(1_000_000, 4_996_000).nbytes == 27.984e6
    assert roofline.cg_iteration(n, nnz).nbytes == pytest.approx(155.159648e6)
