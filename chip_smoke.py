"""Smoke run of the PyTorch + CUDA port (tpu_spmv_torch) on one card.

Run from the root of the repository, on a machine with one CUDA card:

    python chip_smoke.py

It builds the port's CUDA kernels from tpu_spmv_torch/kernels/csrc/,
then, at the main path's real sizes (lap2d_1024: 1.05M rows, 5.2M nnz;
varstencil_1024; banded_1m: 1M rows, 16.9M nnz):

  1. checks each kernel against its plain PyTorch version on the card
     (max |kernel - plain| <= 1e-5 * max(1, max |plain|): both sum in
     f32, in different orders and with or without fused multiply-add),
     validates it against the serial CSR oracle (Number Wrong 0 at the
     magnitude-aware 0.01 tolerance, RelL2 <= 1e-6; bf16 layouts against
     the bf16-rounded operator), and times kernel and plain version in
     the warm regime (one operator, which may stay in L2) and the cold
     one (operator copies rotated, >= 4x L2 in all);
  2. zeroes the kernels' launch counters, drives the port's CLI
     (tpu_spmv_torch.tools.spmv.main) on lap2d_1024 (auto, then bf16
     cold) and banded_1m (auto, then --kernel sell), and fails unless
     every kernel of the path was launched in that run.

It prints the card (nvidia-smi name and power limit), the toolchain, the
build time and ptxas's register/spill report, one line per phase, a JSON
line with each kernel's launches, error and times, and last
{"ok": true, "device": {...}}. Any failure exits non-zero without that
last line, as does a machine without a CUDA card or a directory without
the port's package.
"""

from __future__ import annotations

import json
import sys

X_SEED = 0
L2_TOL = 1e-6
PLAIN_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel: name, registers, spills."""
    import re
    import shutil
    import subprocess

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(
                    ["c++filt", name], capture_output=True, text=True
                ).stdout.strip().replace("(anonymous namespace)::", "")
                name = name.split("(")[0]
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def _check_kernel(label, kernel, plain, layout, mat, perm, oracle, stats):
    """One phase: kernel vs plain on the card, oracle validation, warm
    and cold timings of both. Appends to stats[kernel name]."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import (
        bench_spmv, bench_spmv_cold, validate,
    )
    from tpu_spmv_torch.hw import device_spec

    dev = torch.device("cuda")
    lay = layout.to(dev)
    x = np.random.default_rng(X_SEED).standard_normal(mat.n).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(dev)
    before = kernel.launches
    yk = kernel(lay, xt)
    yp = plain(lay, xt)
    torch.cuda.synchronize()
    delta = kernel.launches - before
    err = float((yk - yp).abs().max())
    scale = max(1.0, float(yp.abs().max()))
    wrong, rel = validate(yk.cpu().numpy(), oracle.matvec(x)[perm])
    if delta != 1:
        raise SmokeFailure(f"{label}: launch counter moved by {delta}, not 1")
    if not err <= PLAIN_TOL * scale:
        raise SmokeFailure(
            f"{label}: kernel differs from plain by {err:.3g} "
            f"(limit {PLAIN_TOL * scale:.3g})"
        )
    if wrong != 0 or not rel <= L2_TOL:
        raise SmokeFailure(f"{label}: Number Wrong {wrong}, RelL2 {rel:.3g}")

    nnz = mat.nnz
    lbytes = lay.nbytes
    t = {}
    # Kernel and plain version in turns: warm, then cold, then the
    # kernel's eager (host-launched) warm time.
    for name, fn in (("kernel", kernel), ("plain", plain)):
        t[name, "warm"] = bench_spmv(fn, lay, xt, nnz=nnz)
    for name, fn in (("plain", plain), ("kernel", kernel)):
        t[name, "cold"] = bench_spmv_cold(
            fn, lay.clone, xt, nnz=nnz, layout_bytes=lbytes
        )
    eager = bench_spmv(kernel, lay, xt, nnz=nnz, graph=False)
    bw = device_spec().hbm_bytes_per_s
    us = lambda s: f"{s * 1e6:.2f}"  # noqa: E731
    kw, kc = t["kernel", "warm"], t["kernel", "cold"]
    print(
        f"[{label}] {kernel.__name__}: launches +{delta}, "
        f"max|kernel-plain| {err:.3g}, Number Wrong {wrong}, RelL2 {rel:.3g}"
        f", layout {lbytes / 2**20:.1f} MB, K={kc.iters[2]} cold copies",
        flush=True,
    )
    for name in ("kernel", "plain"):
        w, c = t[name, "warm"], t[name, "cold"]
        print(
            f"    {name:6s} TimeMin/TimeAvg us (CUDA graph): warm "
            f"{us(w.time_min)}/{us(w.time_avg)}, cold "
            f"{us(c.time_min)}/{us(c.time_avg)} | GF/s warm "
            f"{w.gflops:.1f}, cold {c.gflops:.1f} | layout bytes at "
            f"{100 * lbytes / w.time_min / bw:.0f}% (warm, L2 may hold "
            f"them) / {100 * lbytes / c.time_avg / bw:.0f}% (cold) of "
            f"{bw / 1e12:.2f} TB/s",
            flush=True,
        )
    print(f"    kernel eager launches (Python + ctypes): warm TimeMin/TimeAvg"
          f" {us(eager.time_min)}/{us(eager.time_avg)} us", flush=True)
    stats.setdefault(kernel.__name__, []).append(
        dict(label=label, err=err, ms=kw.time_min * 1e3,
             plain_ms=t["plain", "warm"].time_min * 1e3)
    )


def _phases(stats):
    import torch

    from tpu_spmv_torch.formats.convert import rounded
    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.dia import spmv_dia, spmv_dia_reference
    from tpu_spmv_torch.kernels.sell import (
        spmv_ranked, spmv_ranked_reference, spmv_sell, spmv_sell_reference,
    )
    from tpu_spmv_torch.tools.spmv import load_input, prepare
    from tpu_spmv_torch.tune.plan import gpu_plan

    bf16 = torch.bfloat16
    for name in ("lap2d_1024", "varstencil_1024"):
        mat = load_input(f"synthetic:{name}")
        plan = gpu_plan(mat)
        if plan.kernel != "dia":
            raise SmokeFailure(f"{name}: auto planned {plan.kernel}, not dia")
        ck, perm = prepare(mat, "auto")
        for vdt, oracle in ((None, mat), (bf16, rounded(mat))):
            lay = DiaSlabs.from_csr(ck.matrix, val_dtype=vdt)
            tag = "bf16" if vdt else "f32"
            _check_kernel(f"{name} dia {tag}", spmv_dia, spmv_dia_reference,
                          lay, mat, perm, oracle, stats)

    mat = load_input("synthetic:lap2d_1024")
    ck, perm = prepare(mat, "always")
    for groups in (True, False):
        lay = RankedSlabs.from_csr(ck.matrix, allow_groups=groups)
        if bool(lay.group_code) != groups:
            raise SmokeFailure("lap2d_1024 rcm: grouping not as requested")
        kind = f"grouped G={lay.num_groups}" if groups else "ungrouped"
        _check_kernel(f"lap2d_1024 rcm ranked {kind}", spmv_ranked,
                      spmv_ranked_reference, lay, mat, perm, mat, stats)
    _check_kernel("lap2d_1024 rcm sell", spmv_sell, spmv_sell_reference,
                  SellSlabs.from_csr(ck.matrix), mat, perm, mat, stats)

    mat = load_input("synthetic:banded_1m")
    ck, perm = prepare(mat, "auto")
    _check_kernel("banded_1m ranked", spmv_ranked, spmv_ranked_reference,
                  RankedSlabs.from_csr(ck.matrix), mat, perm, mat, stats)
    _check_kernel("banded_1m sell", spmv_sell, spmv_sell_reference,
                  SellSlabs.from_csr(ck.matrix), mat, perm, mat, stats)


def _main_path():
    """Launch counts of the kernels over the CLI runs."""
    from tpu_spmv_torch.kernels.dia import spmv_dia
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.tools import spmv as cli

    wrappers = (spmv_dia, spmv_ranked, spmv_sell)
    for w in wrappers:
        w.launches = 0
    for argv in (
        ["synthetic:lap2d_1024", "20"],
        ["synthetic:lap2d_1024", "20", "--val-dtype", "bf16", "--cold"],
        ["synthetic:banded_1m", "20"],
        ["synthetic:banded_1m", "20", "--kernel", "sell"],
    ):
        print(f"== tools.spmv.main({argv})", flush=True)
        rc = cli.main(argv)
        if rc != 0:
            raise SmokeFailure(f"tools.spmv.main({argv}) returned {rc}")
    counts = {w.__name__: w.launches for w in wrappers}
    missing = [k for k, v in counts.items() if v < 1]
    if missing:
        raise SmokeFailure(f"main path never launched {missing}: {counts}")
    return counts


_KERNELS = {
    "spmv_dia": ("tpu_spmv_torch/kernels/csrc/dia.cu",
                 "tpu_spmv/kernels/dia.py:115", "lap2d_1024 dia f32"),
    "spmv_ranked": ("tpu_spmv_torch/kernels/csrc/sell.cu",
                    "tpu_spmv/kernels/pallas_sell.py:541", "banded_1m ranked"),
    "spmv_sell": ("tpu_spmv_torch/kernels/csrc/sell.cu",
                  "tpu_spmv/kernels/pallas_sell.py:279", "banded_1m sell"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from tpu_spmv_torch import hw
        from tpu_spmv_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2

    smi = hw.nvidia_smi()
    print(f"nvidia-smi: {smi}")
    tc = hw.toolchain()
    print(f"torch {tc['torch']} | CUDA {tc['cuda']} | nvcc {tc['nvcc']} | "
          f"triton present: {tc['triton']}")
    info = _build.build(verbose=True, force=True)
    print(f"kernel build: {info.seconds:.1f} s -> {info.path.name}")
    for line in _ptxas_summary(info.log):
        print(f"  ptxas: {line}")
    print(f"device: {hw.device_spec()}", flush=True)

    stats = {}
    try:
        _phases(stats)
        counts = _main_path()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        print("chip_smoke: FAILED: jax was imported", file=sys.stderr)
        return 1

    kernels = []
    for name, (source, replaces, main_phase) in _KERNELS.items():
        rows = stats[name]
        at = next(r for r in rows if r["label"] == main_phase)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=max(r["err"] for r in rows),
            ms=at["ms"], plain_ms=at["plain_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
