"""The port's column-striped SpMV (kernels/striped.py) and the accumulate
mode of spmv_ranked it runs on, on the CPU.

On the reference's own shapes (tests/test_striped.py): each stripe's
arrays equal the reference's stacked stripe with its padding cut (values
compared, not dtypes: the reference widens every stripe's lcols to the
widest, the port keeps each stripe's own), and y agrees with the JAX
spmv_striped in interpret mode and with the serial oracle: RelL2 <= 1e-6
against both, Number Wrong 0 at the magnitude-aware 0.01. bf16 stripes
carry the reference's bf16 bits and are held to the bf16-rounded
oracle the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import random_general as jax_random_general
from tpu_spmv.formats.csr import CSRMatrix as JaxCSR
from tpu_spmv.kernels.striped import StripedRanked as JaxStriped
from tpu_spmv.kernels.striped import spmv_striped as jax_spmv_striped

from tpu_spmv_torch import hw
from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats.csr import CSRMatrix
from tpu_spmv_torch.formats.sell import RankedSlabs
from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_ranked_reference
from tpu_spmv_torch.kernels.striped import (
    StripedRanked, default_stripe_cols, spmv_striped, spmv_striped_reference,
)

from test_striped import _wide_scattered
from test_torch_gpu import _RANKED, _wide


def _ragged():
    """tests/test_striped.py::test_striped_ragged_last_stripe's matrix:
    600 x 1100, its second stripe of 1024 holds 76 columns."""
    rng = np.random.default_rng(12)
    m, n, per_row = 600, 1100, 5
    indptr = np.arange(0, m * per_row + 1, per_row, dtype=np.int64)
    indices = np.sort(rng.integers(0, n, size=(m, per_row)), axis=1)
    data = rng.standard_normal(m * per_row).astype(np.float32)
    return JaxCSR(indptr, indices.reshape(-1).astype(np.int32), data, (m, n))


# name -> (reference matrix, stripe_cols, bin_blocks, stripes, x seed)
CASES = {
    "wide_512x8192": (lambda: _wide_scattered(512, 8192, 6, seed=3), 1024,
                      2, 8, 0),
    "square_general_1024": (lambda: jax_random_general(1024, 6, seed=7), 512,
                            2, 2, 1),
    "ragged_600x1100": (_ragged, 1024, 2, 2, 5),
}


def _port(jm) -> CSRMatrix:
    return CSRMatrix(jm.indptr, jm.indices, jm.data, jm.shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_y(y, y_ref, oracle, x):
    assert _rel(y, y_ref) <= 1e-6
    wrong, rel = validate(y, oracle.matvec(x))
    assert wrong == 0 and rel <= 1e-6, (wrong, rel)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stripes_equal_the_reference(case):
    make, sc, w, P, _ = CASES[case]
    jm = make()
    ref = JaxStriped.from_csr(jm, stripe_cols=sc, bin_blocks=w)
    lay = StripedRanked.from_csr(_port(jm), stripe_cols=sc, bin_blocks=w,
                                 device="cpu")
    assert ref.num_stripes == lay.num_stripes == P
    assert (lay.m, lay.n, lay.nnz, lay.stripe_cols) == (
        ref.m, ref.n, ref.nnz, ref.stripe_cols)
    assert lay.rank_nb == ref.rank_nb
    for p, s in enumerate(lay.stripes):
        assert s.n == min(sc, jm.n - p * sc)
        assert s.num_chunks == ref.num_chunks
        k, S, T = s.vals.shape[0], s.num_subtiles, s.tile_b0.numel()
        for name, got, want in (
            ("vals", s.vals, np.asarray(ref.vals[p])[:k]),
            ("lcols", s.lcols, np.asarray(ref.lcols[p])[:k]),
            ("sub_b0", s.sub_b0, np.asarray(ref.sub_b0[p])[:S]),
            ("sub_dlo", s.sub_dlo, np.asarray(ref.sub_dlo[p])[:S].view(np.int32)),
            ("sub_dhi", s.sub_dhi, np.asarray(ref.sub_dhi[p])[:S].view(np.int32)),
            ("sub_chunk", s.sub_chunk, np.asarray(ref.sub_chunk[p])[:S]),
            ("tile_b0", s.tile_b0, np.asarray(ref.tile_b0[p])[:T]),
        ):
            assert np.array_equal(got.numpy().astype(np.int64 if name != "vals"
                                                     else np.float32),
                                  want.astype(np.int64 if name != "vals"
                                              else np.float32)), (p, name)
        # What the port leaves out is the reference's padding: inert
        # values and the dropped chunk id.
        assert not np.asarray(ref.vals[p])[k:].any()
        assert (np.asarray(ref.sub_chunk[p])[S:] == ref.num_chunks).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_striped_matches_jax_and_the_oracle(case):
    make, sc, w, _, seed = CASES[case]
    jm = make()
    mat = _port(jm)
    x = np.random.default_rng(seed).standard_normal(mat.n).astype(np.float32)
    y_jax = np.asarray(jax_spmv_striped(
        JaxStriped.from_csr(jm, stripe_cols=sc, bin_blocks=w),
        jnp.asarray(x), interpret=True))
    lay = StripedRanked.from_csr(mat, stripe_cols=sc, bin_blocks=w,
                                 device="cpu")
    before = spmv_striped.launches
    y = spmv_striped(lay, torch.from_numpy(x)).numpy()
    assert spmv_striped.launches == before  # the plain version ran
    assert np.array_equal(y, spmv_striped_reference(
        lay, torch.from_numpy(x)).numpy())
    _check_y(y, y_jax, mat, x)


def test_striped_rejects_single_stripe():
    jm = jax_random_general(1024, 6, seed=1)
    with pytest.raises(ValueError, match="one stripe") as port:
        StripedRanked.from_csr(_port(jm), stripe_cols=2048, device="cpu")
    with pytest.raises(ValueError, match="one stripe") as ref:
        JaxStriped.from_csr(jm, stripe_cols=2048)
    assert str(port.value) == str(ref.value)


def test_split_chunk_in_a_later_stripe():
    """Row 5 holds every column of stripe 1: only stripe 1 has split
    chunks, and the passes still sum to the oracle and the reference."""
    mat = _wide(long_row=(5, 1024, 2048))
    lay = StripedRanked.from_csr(mat, stripe_cols=1024, bin_blocks=2,
                                 device="cpu")
    splits = [s.split_seg.shape[1] for s in lay.stripes]
    assert splits[0] == 0 and splits[1] >= 1 and not any(splits[2:])
    x = np.random.default_rng(2).standard_normal(mat.n).astype(np.float32)
    jm = JaxCSR(mat.indptr, mat.indices, mat.data, mat.shape)
    y_jax = np.asarray(jax_spmv_striped(
        JaxStriped.from_csr(jm, stripe_cols=1024, bin_blocks=2),
        jnp.asarray(x), interpret=True))
    _check_y(spmv_striped(lay, torch.from_numpy(x)).numpy(), y_jax, mat, x)


@pytest.mark.parametrize("case", ["lap2d_u8_ungrouped", "long_row_grouped",
                                  "long_row_bf16_delta"])
def test_ranked_out_adds_the_plain_product(case):
    """spmv_ranked(out=y) on the CPU is y plus the plain call, in place;
    no count (the plain version ran)."""
    make, kw = _RANKED[case]
    mat = make()
    lay = RankedSlabs.from_csr(mat, **kw)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(mat.n).astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal(mat.m).astype(np.float32))
    out = y0.clone()
    before = spmv_ranked.launches
    assert spmv_ranked(lay, x, out=out) is out
    assert spmv_ranked.launches == before
    assert torch.equal(out, y0 + spmv_ranked_reference(lay, x))


def test_default_stripe_cols_is_a_quarter_of_the_l2(monkeypatch):
    """A quarter of the L2 in floats, rounded down to 128 columns (the
    width measured fastest on scattered_16m): 3,276,800 on the H100's 50
    MB, so its 16,777,216 columns take 6 stripes, each x slice within the
    residency gate; at least one block when the L2 is forced to 0."""
    assert default_stripe_cols("cpu") == hw.H100_L2_BYTES // 16 // 128 * 128
    assert default_stripe_cols("cpu") == 3_276_800
    assert -(-16_777_216 // default_stripe_cols("cpu")) == 6
    assert 4 * default_stripe_cols("cpu") <= hw.H100_L2_BYTES / 2
    monkeypatch.setattr(hw, "H100_L2_BYTES", 0)
    assert default_stripe_cols("cpu") == 128


def test_striped_layout_moves_and_clones():
    mat = _port(_ragged())
    lay = StripedRanked.from_csr(mat, stripe_cols=1024, bin_blocks=2,
                                 device="cpu")
    twin = lay.clone()
    assert twin.nbytes == lay.nbytes == sum(s.nbytes for s in lay.stripes)
    assert all(a.vals.data_ptr() != b.vals.data_ptr()
               for a, b in zip(lay.stripes, twin.stripes))
    assert lay.to("cpu").num_stripes == 2
    # hbm_bytes: the stripes' slabs and window bases, x once, y a pass.
    slabs = sum(s.vals.numel() * 4 + s.lcols.numel() * s.lcols.element_size()
                + s.num_subtiles * 128 * 4 for s in lay.stripes)
    assert lay.hbm_bytes == slabs + 4 * (mat.n + 2 * mat.m)
    with pytest.raises(ValueError, match="x must be"):
        spmv_striped(lay, torch.zeros(mat.n + 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_stripes_equal_the_reference(case):
    """bf16 stripes (val_dtype): each stripe's values carry the bits of
    the reference's bf16 stripe (with its padding cut), and the rest of
    its arrays are the f32 stripes'."""
    make, sc, w, P, _ = CASES[case]
    jm = make()
    ref = JaxStriped.from_csr(jm, stripe_cols=sc, bin_blocks=w,
                              val_dtype=jnp.bfloat16)
    lay = StripedRanked.from_csr(_port(jm), stripe_cols=sc, bin_blocks=w,
                                 val_dtype=torch.bfloat16, device="cpu")
    f32 = StripedRanked.from_csr(_port(jm), stripe_cols=sc, bin_blocks=w,
                                 device="cpu")
    assert lay.val_dtype == torch.bfloat16 and f32.val_dtype == torch.float32
    assert lay.num_stripes == ref.num_stripes == P
    assert 2 * sum(s.vals.nbytes for s in lay.stripes) == sum(
        t.vals.nbytes for t in f32.stripes)
    for p, (s, t) in enumerate(zip(lay.stripes, f32.stripes)):
        k = s.vals.shape[0]
        want = np.asarray(ref.vals[p])
        assert want.dtype == jnp.bfloat16
        assert np.array_equal(s.vals.view(torch.int16).numpy(),
                              want[:k].view(np.int16)), p
        assert not want[k:].astype(np.float32).any()
        assert torch.equal(s.vals.float(), t.vals.to(torch.bfloat16).float())
        for name in ("lcols", "sub_b0", "sub_dlo", "sub_dhi", "sub_chunk",
                     "tile_b0", "seg_ptr", "run_ptr"):
            assert torch.equal(getattr(s, name), getattr(t, name)), (p, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_striped_matches_jax_and_the_rounded_oracle(case):
    """spmv_striped on bf16 stripes against the JAX spmv_striped on the
    reference's bf16 stripes (interpret mode) and the serial oracle of
    the bf16-rounded operator: both multiply the same rounded values in
    f32, so RelL2 <= 1e-6 against each and Number Wrong 0 at 0.01;
    against the f32 oracle the difference is the values' bf16 rounding
    (RelL2 <= 1e-2, bf16 keeping 8 bits of mantissa)."""
    make, sc, w, _, seed = CASES[case]
    jm = make()
    mat = _port(jm)
    x = np.random.default_rng(seed).standard_normal(mat.n).astype(np.float32)
    y_jax = np.asarray(jax_spmv_striped(
        JaxStriped.from_csr(jm, stripe_cols=sc, bin_blocks=w,
                            val_dtype=jnp.bfloat16),
        jnp.asarray(x), interpret=True))
    lay = StripedRanked.from_csr(mat, stripe_cols=sc, bin_blocks=w,
                                 val_dtype=torch.bfloat16, device="cpu")
    before = spmv_striped.launches
    y = spmv_striped(lay, torch.from_numpy(x)).numpy()
    assert spmv_striped.launches == before  # the plain version ran
    assert np.array_equal(y, spmv_striped_reference(
        lay, torch.from_numpy(x)).numpy())
    _check_y(y, y_jax, mat.rounded(), x)
    assert 1e-6 < _rel(y, mat.matvec(x)) <= 1e-2
