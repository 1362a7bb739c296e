"""The port's packed mixed-height layout and spmv_packed against the JAX
package's.

Same matrix in, same arrays out: every field of tpu_spmv's PackedRanked
equals the port's (bf16 compared as its uint16 bits), and the port's
derived chunk_koff, rebuilt by formats.convert from out_row and bmeta
alone, equals from_csr's. On one layout, the port's spmv_packed (on
the CPU, its plain version) agrees with the Pallas kernel in interpret
mode and with the serial CSR oracle: RelL2 <= 1e-6 and Number Wrong 0
at the magnitude-aware 0.01 (bf16 against the bf16-rounded operator).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_spmv.bench.matrices import (
    laplacian_2d, power_law, random_banded, random_general,
)
from tpu_spmv.formats import packed as jpacked
from tpu_spmv.formats.csr import CSRMatrix
from tpu_spmv.kernels.packed import spmv_packed as jax_spmv_packed
from tpu_spmv.reorder.rcm import rcm

from tpu_spmv_torch.bench.harness import validate
from tpu_spmv_torch.formats import packed as tpacked
from tpu_spmv_torch.formats.convert import from_reference
from tpu_spmv_torch.kernels.packed import spmv_packed
from tpu_spmv_torch.tools import spmv as cli

from test_torch_formats import assert_same_layout, rounded

MATRICES = {
    "lap2d_37": lambda: laplacian_2d(37),
    "banded_1100": lambda: random_banded(1100, 70, 9),
    "banded_640": lambda: random_banded(640, 25, 3),
    "general_900": lambda: random_general(900, 7),
    "powerlaw_1500": lambda: power_law(1500, 6, max_len=96),
}


def _rcm(mat):
    return mat.permuted(rcm(mat.indptr, mat.indices))


def _kw(slots, groups, dtype, bf16):
    kw = dict(bin_blocks=4 if slots == "binned_w4" else 0,
              allow_groups=groups == "grouped")
    if dtype == "bf16":
        kw["val_dtype"] = bf16
    return kw


def _build_both(mat, slots, groups, dtype):
    """(reference layout, port layout), or the two ValueErrors when the
    packed-delta range rejects the matrix."""
    try:
        ref = jpacked.PackedRanked.from_csr(
            mat, **_kw(slots, groups, dtype, jnp.bfloat16)
        )
    except ValueError as e:
        with pytest.raises(ValueError) as port_err:
            tpacked.PackedRanked.from_csr(
                mat, **_kw(slots, groups, dtype, torch.bfloat16)
            )
        assert str(port_err.value) == str(e)
        return None, None
    return ref, tpacked.PackedRanked.from_csr(
        mat, **_kw(slots, groups, dtype, torch.bfloat16)
    )


def assert_chunk_koff(port):
    """chunk_koff: int32, starts at 0, one range per chunk, each at least
    MIN_KC slots, inside the slabs."""
    koff = port.chunk_koff.numpy()
    assert koff.dtype == np.int32 and koff.shape == (port.num_chunks + 1,)
    assert koff[0] == 0 and (np.diff(koff) >= tpacked.MIN_KC).all()
    assert koff[-1] <= port.vals.shape[0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups", ["grouped", "ungrouped"])
@pytest.mark.parametrize("slots", ["aligned", "binned_w4"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_packed_layout_matches_reference(name, slots, groups, dtype):
    ref, port = _build_both(_rcm(MATRICES[name]()), slots, groups, dtype)
    if ref is None:
        return  # both rejected the matrix with the same message
    assert_same_layout(ref, port)
    assert_chunk_koff(port)
    carried = from_reference(ref)
    assert_same_layout(ref, carried)
    assert torch.equal(carried.chunk_koff, port.chunk_koff)


def test_chunk_koff_from_segments_on_subtile_boundaries():
    """Chunk 0 (8 slots) and chunk 2 (3 slots, raised to MIN_KC = 4) end
    at position 8 of a sub-tile, not 0; chunk 1 (4 slots) ends mid
    sub-tile. The derivation from out_row and bmeta must give from_csr's
    koff for all of them."""
    rows, cols = [], []
    lens = [8] * 128 + [4] * 128 + [3] * 128 + [12] * 128 + [8] * 100
    for r, k in enumerate(lens):
        for j in range(k):
            rows.append(r)
            cols.append((r + 7 * j) % len(lens))
    m = len(lens)
    mat = CSRMatrix.from_coo(rows, cols, np.ones(len(rows)), (m, m))
    ref = jpacked.PackedRanked.from_csr(mat, allow_groups=False)
    port = tpacked.PackedRanked.from_csr(mat, allow_groups=False)
    koff = port.chunk_koff.numpy()
    assert koff[:4].tolist() == [0, 8, 12, 16]  # 8 and 16: position 8
    assert np.array_equal(
        tpacked.chunk_koff_from_segments(ref.out_row, ref.bmeta), koff
    )
    assert torch.equal(from_reference(ref).chunk_koff, port.chunk_koff)


def test_packed_delta_rejection_matches_reference():
    """Two slots of one sub-tile whose window bases lie 312 blocks apart
    exceed the 256-block packed-delta range."""
    rows = np.repeat(np.arange(128), 2)
    cols = np.stack([np.zeros(128, np.int64), 40000 + np.arange(128)], 1)
    mat = CSRMatrix.from_coo(rows, cols.ravel(), np.ones(256), (41000, 41000))
    with pytest.raises(ValueError) as ref:
        jpacked.PackedRanked.from_csr(mat)
    with pytest.raises(ValueError) as port:
        tpacked.PackedRanked.from_csr(mat)
    assert "packed-delta" in str(port.value)
    assert str(port.value) == str(ref.value)


def test_three_chunk_ends_rejection_matches_reference(monkeypatch):
    """With the minimum slab height lowered to 1 slot, one-nonzero chunks
    put 8 chunk ends into one sub-tile: both packages' from_csr must
    raise rather than fold a chunk total into the carry."""
    monkeypatch.setattr(jpacked, "MIN_KC", 1)
    monkeypatch.setattr(tpacked, "MIN_KC", 1)
    m = 128 * 10
    mat = CSRMatrix.from_coo(np.arange(m), np.arange(m), np.ones(m), (m, m))
    with pytest.raises(ValueError) as ref:
        jpacked.PackedRanked.from_csr(mat)
    with pytest.raises(ValueError) as port:
        tpacked.PackedRanked.from_csr(mat)
    assert ">2 chunk ends" in str(port.value)
    assert str(port.value) == str(ref.value)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


_KERNEL_VARIANTS = {
    "grouped": ("aligned", "grouped", "f32"),
    "delta": ("aligned", "ungrouped", "f32"),
    "bf16": ("aligned", "grouped", "bf16"),
    "binned_w4": ("binned_w4", "grouped", "f32"),
}


@pytest.mark.parametrize("variant", sorted(_KERNEL_VARIANTS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_packed_matches_pallas(name, variant):
    mat = _rcm(MATRICES[name]())
    ref, _ = _build_both(mat, *_KERNEL_VARIANTS[variant])
    if ref is None:
        return  # rejection checked in test_packed_layout_matches_reference
    x = _x(mat.n)
    y_ref = np.asarray(jax_spmv_packed(ref, jnp.asarray(x), interpret=True))
    y = spmv_packed(from_reference(ref), torch.from_numpy(x)).numpy()
    oracle = rounded(mat) if variant == "bf16" else mat
    for other in (y_ref, oracle.matvec(x)):
        wrong, rel = validate(y, other)
        assert wrong == 0 and rel <= 1e-6, (wrong, rel)


@pytest.mark.parametrize("spec", ["lap2d_32", "banded_1k", "general_1k"])
def test_cli_packed_validates(spec, capsys):
    rc = cli.main([f"synthetic:{spec}", "3", "--kernel", "packed",
                   "--device", "cpu", "--validate-only"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "packed mixed-height slabs" in out
    assert "Number Wrong: 0 " in out


def test_cli_packed_falls_back_to_ranked_then_sell(tmp_path, capsys):
    """A matrix whose sub-tiles span more than the packed-delta range:
    packed falls back to ranked, which falls back to sell, each saying
    so, and the run still validates."""
    from tpu_spmv.io import write_mtx

    rows = np.repeat(np.arange(128), 2)
    cols = np.stack([np.zeros(128, np.int64), 40000 + np.arange(128)], 1)
    mat = CSRMatrix.from_coo(rows, cols.ravel(), np.ones(256), (41000, 41000))
    path = tmp_path / "wide.mtx"
    write_mtx(str(path), mat)
    rc = cli.main([str(path), "--kernel", "packed", "--rcm", "never",
                   "--device", "cpu", "--validate-only"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "packed layout unavailable" in out
    assert "ranked layout unavailable" in out
    assert "Number Wrong: 0 " in out
