"""The port's host tools (tools/{sweep,gen,convert,reformat,stats,
analyze}.py) and config.RunConfig against the JAX package's, on the CPU.

Files are compared byte for byte and printed reports line for line. The
sweep runs the port's plain versions (`--device cpu`, time columns
empty) beside the reference's interpret-mode sweep on the same matrices:
the same CSV header and, row for row, the same non-timing columns; the
relative errors differ in the last digits (each package sums in its own
order) and both stay within the suite's 1e-6.
"""

import csv
import pathlib

import numpy as np
import pytest

from tpu_spmv import config as jconfig
from tpu_spmv.bench.matrices import random_banded
from tpu_spmv.io.matrix_market import write_mtx
from tpu_spmv.tools import analyze as janalyze
from tpu_spmv.tools import convert as jconvert
from tpu_spmv.tools import gen as jgen
from tpu_spmv.tools import reformat as jreformat
from tpu_spmv.tools import stats as jstats
from tpu_spmv.tools import sweep as jsweep

from tpu_spmv_torch import config as tconfig
from tpu_spmv_torch.tools import analyze as tanalyze
from tpu_spmv_torch.tools import convert as tconvert
from tpu_spmv_torch.tools import gen as tgen
from tpu_spmv_torch.tools import reformat as treformat
from tpu_spmv_torch.tools import stats as tstats
from tpu_spmv_torch.tools import sweep as tsweep

_TIMES = ("time_min", "time_max", "time_avg", "gflops", "gnnzs")


@pytest.fixture
def mtx(tmp_path):
    """tests/test_tools.py's scrambled band, as a .mtx file."""
    mat = random_banded(600, 40, 8, seed=0)
    scr = mat.permuted(np.random.default_rng(0).permutation(600))
    p = tmp_path / "t.mtx"
    write_mtx(p, scr)
    return p


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_sweep_rows_match_reference(tmp_path, capsys):
    argv = ["--matrices", "lap2d_32", "banded_1k", "--scale", "tiny",
            "--kernels", "auto", "sell", "ranked", "packed", "dia", "segsum",
            "bcoo", "dense", "--k", "1", "--srs", "8", "--rcm", "auto"]
    assert jsweep.main(["--out", str(tmp_path / "ref.csv"), *argv]) == 0
    assert tsweep.main(["--out", str(tmp_path / "port.csv"), *argv,
                        "--device", "cpu"]) == 0
    assert "planner keeps natural order" in capsys.readouterr().out
    (ref_fields, ref), (fields, port) = (_rows(tmp_path / "ref.csv"),
                                         _rows(tmp_path / "port.csv"))
    assert tsweep.CSV_FIELDS == jsweep.CSV_FIELDS == fields == ref_fields
    assert len(port) == len(ref) == 15  # dia refuses banded_1k in both
    for a, b in zip(ref, port):
        for f in fields:
            if f in _TIMES:
                assert b[f] == "" and float(a[f]) > 0, f
            elif f == "rel_l2":
                assert float(a[f]) <= 1e-6 and float(b[f]) <= 1e-6
            else:
                assert a[f] == b[f], (f, a, b)


def test_sweep_resumes_and_labels_the_packed_fallback(tmp_path):
    """tests/test_tools.py's wide scattered matrix: packed overflows the
    delta range, the row says packed>ranked, and a rerun adds nothing."""
    from tpu_spmv.formats.csr import CSRMatrix

    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(384), 4)
    cols = rng.integers(0, 50_000, size=rows.size)
    mat = CSRMatrix.from_coo(rows, cols, np.ones(rows.size, np.float32),
                             (384, 50_000))
    p = tmp_path / "wide.mtx"
    write_mtx(str(p), mat)
    out = tmp_path / "s.csv"
    argv = ["--out", str(out), "--matrices", str(p), "--kernels", "packed",
            "--k", "1", "--srs", "16", "--rcm", "never", "--bin-blocks", "2",
            "--device", "cpu"]
    assert tsweep.main(argv) == 0
    _, rows = _rows(out)
    assert len(rows) == 1 and rows[0]["kernel"] == "packed>ranked", rows
    assert rows[0]["num_wrong"] == "0" and rows[0]["matrix"].endswith(
        "/wide.mtx")
    before = out.read_text()
    assert tsweep.main(argv) == 0
    assert out.read_text() == before


def test_sweep_refuses_a_foreign_header(tmp_path):
    out = tmp_path / "s.csv"
    out.write_text("matrix,kernel\n")
    with pytest.raises(SystemExit, match="does not match"):
        tsweep.main(["--out", str(out), "--matrices", "lap2d_32", "--scale",
                     "tiny", "--device", "cpu"])


@pytest.mark.parametrize("family,size", [("road", 3000), ("delaunay", 2000),
                                         ("fem", 2000), ("fem3d", 9)])
def test_gen_files_match_reference(family, size, tmp_path, capsys):
    a, b = tmp_path / "ref.mtx", tmp_path / "port.mtx"
    assert jgen.main([family, str(size), "--out", str(a)]) == 0
    ref_out = capsys.readouterr().out
    assert tgen.main([family, str(size), "--out", str(b)]) == 0
    assert capsys.readouterr().out.replace(str(b), str(a)) == ref_out
    assert a.read_bytes() == b.read_bytes()


def test_convert_and_reformat_files_match_reference(mtx, tmp_path, capsys):
    for tool, root in ((jconvert, tmp_path / "ref"),
                       (tconvert, tmp_path / "port")):
        assert tool.main([str(mtx), "--norm-dir", str(root / "norm"),
                          "--rcm-dir", str(root / "rcm"), "--mtx-out"]) == 0
    capsys.readouterr()
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(ref) == ["norm/t.mtx.csr", "rcm/t.mtx.rcm",
                           "rcm/t.mtx.rcm.csr"]
    assert ref == port
    src = tmp_path / "ref" / "rcm" / "t.mtx.rcm.csr"
    for args in (["--auto", "--arch", "volta"], ["--auto", "--arch", "ampere"],
                 ["--srs", "24", "--ssrs", "8", "--plain"]):
        for ext in (".csr3", ".csr2"):
            a, b = tmp_path / f"ref{ext}", tmp_path / f"port{ext}"
            assert jreformat.main([str(src), str(a), *args]) == 0
            assert treformat.main([str(src), str(b), *args]) == 0
            assert a.read_bytes() == b.read_bytes(), (args, ext)
    out = capsys.readouterr().out
    assert "using ssrs" in out


def test_stats_output_matches_reference(mtx, tmp_path, capsys):
    jconvert.main([str(mtx), "--norm-dir", str(tmp_path / "n"), "--rcm-dir",
                   str(tmp_path / "r")])
    capsys.readouterr()
    files = [str(tmp_path / "n" / "t.mtx.csr"), str(mtx)]
    assert jstats.main(files) == 0
    ref = capsys.readouterr().out
    assert tstats.main(files) == 0
    assert capsys.readouterr().out == ref
    assert "Band Var:" in ref and "Dim: 600x600" in ref


def test_analyze_matches_reference(mtx):
    from tpu_spmv.io import read_mtx as jread
    from tpu_spmv_torch.io import read_mtx as tread

    jm, tm = jread(str(mtx)), tread(str(mtx))
    ref = janalyze.format_overheads(jm, 3, (8, 8))
    port = tanalyze.format_overheads(tm, 3, (8, 8))
    for k, v in ref.items():
        assert port[k] == v, k
    for k in ("sell", "ranked", "packed", "dia"):
        if k in ref:  # the port's container with its derived tables
            assert port[f"{k}_device_bytes"] > 0
    assert tanalyze.load_balance(tm) == janalyze.load_balance(jm)
    jd, td = janalyze.dense_roofline(jm), tanalyze.dense_roofline(tm)
    for k in ("dense_operator_mb", "density"):
        assert jd[k] == td[k]
    assert td["dense_time_s"] > 0


def test_analyze_cli_runs(mtx, capsys):
    assert tanalyze.main([str(mtx), "--k", "2", "--sizes", "8"]) == 0
    out = capsys.readouterr().out
    assert "csr2" in out and "subtile_nnz" in out
    assert "ranked_device_bytes" in out


def test_run_config_matches_reference(tmp_path, monkeypatch):
    for text in ("SpMV hand 3 8 16\n", "STS LS hem 3 8\n", "SpMV rand 1\n"):
        p = tmp_path / "cfg.txt"
        p.write_text(text)
        a, b = jconfig.RunConfig.parse_file(str(p)), \
            tconfig.RunConfig.parse_file(str(p))
        assert vars(a) == vars(b)
        a.write_file(str(tmp_path / "a.txt"))
        b.write_file(str(tmp_path / "b.txt"))
        assert (tmp_path / "a.txt").read_bytes() == \
            (tmp_path / "b.txt").read_bytes()
    monkeypatch.setenv("TPU_SPMV_KERNEL", "ranked")
    monkeypatch.setenv("TPU_SPMV_SUP_ROW_SIZES", "8,16")
    monkeypatch.setenv("TPU_SPMV_K", "3")
    assert vars(jconfig.RunConfig.from_env()) == \
        vars(tconfig.RunConfig.from_env())
    for bad in ("", "SpMV nope 2 8\n", "FOO hand 2\n"):
        p = tmp_path / "bad.txt"
        p.write_text(bad)
        with pytest.raises(ValueError):
            tconfig.RunConfig.parse_file(str(p))
