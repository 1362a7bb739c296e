"""Smoke run of the PyTorch + CUDA port (tpu_spmv_torch) on one card.

Run from the root of the repository, on a machine with one CUDA card:

    python chip_smoke.py

It builds the port's CUDA kernels from tpu_spmv_torch/kernels/csrc/ and
its C++ host core from tpu_spmv_torch/reorder/csrc/ (it fails unless the
core builds), then, at the main paths' real sizes (lap2d_1024: 1.05M
rows, 5.2M nnz; varstencil_1024; banded_1m: 1M rows, 16.9M nnz;
lap3d_101: 1.03M rows, 7.2M nnz; lap2d_4096: 16.8M rows, 83.9M nnz, whose
x is past the L2 residency gate):

  1. checks each kernel against its plain PyTorch version on the card
     (max |kernel - plain| <= 1e-5 * max(1, max |plain|): both sum in
     f32, in different orders and with or without fused multiply-add),
     validates it against the serial CSR oracle (Number Wrong 0 at the
     magnitude-aware 0.01 tolerance, RelL2 <= 1e-6, every column of an
     SpMM; bf16 layouts against the bf16-rounded operator), and times
     kernel and plain version in the warm regime (one operator, which
     may stay in L2) and the cold one (operator copies rotated, >= 4x L2
     in all), beside its bound (layout, x and y moved once at the HBM
     rate) and the one PyTorch call computing the same product (a CSR
     tensor times x: cuSPARSE). The single-vector kernels spmv_dia,
     spmv_ranked, spmv_sell and spmv_packed (delta, grouped, bf16,
     column-binned) run at one x; spmm_ranked and spmm_packed at B = 8
     and B = 5 columns (before each spmm_ranked phase a line gives the
     runs its walk takes and the device launches per call, and two
     replays of a captured call at B = 8 must give the same bits); the
     windowed kernels spmv_dia_windowed (lap2d_4096 f32 and bf16,
     lap2d_1024), spmv_ranked_windowed (lap2d_4096 and lap2d_1024 after
     RCM, banded_1m) and spmm_ranked_windowed (lap2d_1024 after RCM, B =
     8 and 5 at the CLI's step and column passes) are also held to their
     resident kernels on the same layout (spmv_dia_windowed to spmv_dia
     and spmv_ranked_windowed to spmv_ranked bit for bit, and two
     replays of a captured call of each must give the same bits), before
     each ring phase a line gives the ring's size (DIA: the step S, the
     ring W and the stage bytes; ranked: the ring's bytes and the
     steps), the CTAs, the column passes and the launches per call
     (lap2d_1024 at B = 8 must run in one pass), and lap2d_4096's host
     set-up seconds are printed; before each phase of spmv_ranked and spmv_sell a line
     gives the segment table it walks (segments, Q, split chunks and
     their partial rows), and on banded_1m two replays of one captured
     call of each must give the same bits (max |y1 - y2| printed); so too
     for the packed walk of spmv_packed and spmm_packed (its segment
     table in slots, the runs a block walks and the device launches per
     call, on lap2d_1024 after RCM and banded_1m, whose chunk of an
     887-nonzero row is split; replays of spmv_packed and of spmm_packed
     at B = 8 on both);
  2. prints R, the packed-to-ranked time per walked sub-tile measured in
     step 1 on lap2d_1024 after RCM, for SpMV and for SpMM (B = 5),
     beside the planner's constants, and the plan auto takes on each
     matrix for each, also on general_500k and powerlaw_1m, which the
     reference planner sends to packed;
  3. checks both triangular-solve kernels (lower_solve_ranked and
     lower_solve_blocks) against their plain versions (RelL2 <= 1e-5)
     and a float64 forward substitution (RelL2 <= 1e-5, Number Wrong 0
     at 0.01 for x = ones), and times them warm and cold (the plain
     versions, a host loop over the packs, eagerly), first on the
     bidiagonal chain of 4096 rows (4096 chunks, each reading only the
     one before: the least a dependency level costs, printed as us per
     link), then on lap2d_1024 in level (LS) and COLOR order, lap3d_101
     LS and banded_1m LS (the column-binned rank windows); it prints the
     host set-up seconds and each system's dependency depth, by rows and
     by chunks (the kernel waits on whole chunks), also for lap2d_1024
     k=3, the solve's bound by bytes beside the floor of this design
     (chunk levels times the kernel's own us per link: a floor of the
     design, not of the card), the wait table's size, and
     the time of torch.triangular_solve on the system as a sparse CSR
     tensor; on lap2d_1024 LS two replays of one captured call of each
     kernel must give the same bits;
  4. on lap3d_101 and lap2d_1024 checks IC0Preconditioner.apply against
     its plain version, times one CUDA-graph-captured PCG iteration and
     prints the residual as lap3d_101 converges;
  5. drives each main path with every launch counter zeroed just before
     and read just after: the SpMV/SpMM CLIs (tools.spmv, tools.spmm on
     lap2d_1024 and banded_1m, and on the windowed routes: tools.spmv on
     lap2d_4096, natural and --kernel ranked after RCM, tools.spmm on
     lap2d_1024 at B = 8 and --kernel windowed), the solve CLIs
     (tools.sts on lap2d_1024 LS, COLOR and k=3 and lap3d_101 --part
     upper; tools.solve --precond ic0 on lap3d_101), and the library's
     lower_solve with ranked=False;
     it fails unless every kernel was launched on its path.

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
import time

X_SEED = 0
L2_TOL = 1e-6
PLAIN_TOL = 1e-5
# A triangular solve carries f32 rounding along its dependency chain.
SOLVE_TOL = 1e-5
# tools.solve on lap3d_101: the RMS residual levels off near 3.3e-4
# (float32 x of magnitude ~1e3) above the CLI's default --tol 1e-4, so the
# run asks for 1e-3, which IC(0)-PCG reaches in under 50 iterations.
PCG_ITERS = 60
PCG_TOL = 1e-3
# The bound of a kernel (the least time the card could take for its
# work): NVIDIA's data sheet for the H100 SXM at 700 W, HBM 3.35 TB/s and
# 67 TFLOP/s in float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


def _validate_columns(y, x, oracle, perm):
    """(Number Wrong summed over columns, worst column's RelL2) of y (in
    the layout's row order) against the serial oracle applied to x (in
    the original order); y and x are (n,) or (n, B)."""
    from tpu_spmv_torch.bench.harness import validate

    ys, xs = y.reshape(y.shape[0], -1), x.reshape(x.shape[0], -1)
    wrong, rel = 0, 0.0
    for b in range(ys.shape[1]):
        w, r = validate(ys[:, b], oracle.matvec(xs[:, b])[perm])
        wrong, rel = wrong + w, max(rel, r)
    return wrong, rel


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the HBM rate and the f32 operations over
    the f32 peak outside the tensor cores (the data-sheet H100 SXM
    figures at 700 W)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _csr_tensor(csr, dev):
    """The matrix as a torch CSR tensor on the card (int32 indices)."""
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices),
        torch.from_numpy(csr.data), size=csr.shape, device=dev,
    )


def _time_library(csr, xt, nnz):
    """Warm TimeMin (s) of one PyTorch call computing the same product
    on the same reordered matrix and x: a CSR tensor times x (n,) or X
    (n, B), which PyTorch runs through cuSPARSE (SpMV / SpMM), timed from
    a CUDA graph like the kernels."""
    from tpu_spmv_torch.bench.harness import bench_spmv

    return bench_spmv(lambda a, v: a @ v, _csr_tensor(csr, xt.device), xt,
                      nnz=nnz).time_min


def _check_kernel(label, kernel, plain, layout, mat, perm, oracle, stats,
                  batch=None, twin=None, csr=None, twin_equal=False):
    """One phase: kernel vs plain on the card, oracle validation, warm
    and cold timings of both. x is (n,), or (n, batch) for an SpMM.
    twin: a windowed kernel's resident counterpart, run on the same
    layout and x (max difference printed; with twin_equal the two must
    give the same bits). csr: the matrix the layout
    was built from, for the library call's time (f32 layouts only).
    Appends to stats[kernel name] and returns the kernel's warm
    TimeMin in seconds."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv, bench_spmv_cold
    from tpu_spmv_torch.hw import device_spec

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    lay = layout.to(dev)
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(X_SEED).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(dev)
    before = kernel.launches
    yk = kernel(lay, xt)
    yp = plain(lay, xt)
    torch.cuda.synchronize()
    delta = kernel.launches - before
    err = float((yk - yp).abs().max())
    scale = max(1.0, float(yp.abs().max()))
    wrong, rel = _validate_columns(yk.cpu().numpy(), x, oracle, perm)
    del yp
    twin_err = None
    if twin is not None:
        y_twin = twin(lay, xt)
        twin_err = float((yk - y_twin).abs().max())
        if twin_equal and not torch.equal(yk, y_twin):
            raise SmokeFailure(f"{label}: not bit for bit {twin.__name__}'s "
                               f"result (max difference {twin_err:.3g})")
        del y_twin
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
    cols = 1 if batch is None else batch
    bound_ms, bound_by = _bound(lbytes + 4 * (mat.n + mat.m) * cols,
                                2 * nnz * cols)
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
    twin_s = None if twin is None else bench_spmv(twin, lay, xt,
                                                 nnz=nnz).time_min
    library_ms = None
    if csr is not None:
        library_ms = _time_library(csr, xt, nnz) * 1e3
    bw = device_spec().hbm_bytes_per_s
    us = lambda s: f"{s * 1e6:.2f}"  # noqa: E731
    kw, kc = t["kernel", "warm"], t["kernel", "cold"]
    colstr = "" if batch is None else f", B={batch} (GF/s count 2*nnz*B)"
    print(
        f"[{label}] {kernel.__name__}: launches +{delta}, "
        f"max|kernel-plain| {err:.3g}, Number Wrong {wrong}, RelL2 {rel:.3g}"
        + ("" if twin_err is None else
           f", max|kernel-{twin.__name__}| {twin_err:.3g}")
        + f", layout {lbytes / 2**20:.1f} MB, K={kc.iters[2]} cold copies"
        f"{colstr}",
        flush=True,
    )
    lib_txt = "none" if library_ms is None else f"{library_ms * 1e3:.2f}"
    print(f"    bound {bound_ms * 1e3:.2f} us ({bound_by}: layout + x + y "
          f"once at {bw / 1e12:.2f} TB/s) | library call (CSR tensor @ x, "
          f"cuSPARSE) warm TimeMin us: {lib_txt}"
          + ("" if twin_s is None else
             f" | {twin.__name__} on the same layout: warm TimeMin us "
             f"{twin_s * 1e6:.2f}"), flush=True)
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
          f" {us(eager.time_min)}/{us(eager.time_avg)} us | phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats.setdefault(kernel.__name__, []).append(
        dict(label=label, err=err, ms=kw.time_min * 1e3,
             plain_ms=t["plain", "warm"].time_min * 1e3, bound_ms=bound_ms,
             bound_by=bound_by, library_ms=library_ms)
    )
    return kw.time_min


def _segments(label, lay):
    """One line on the segment table that spmv_ranked and spmv_sell
    (formats/sell.segment_fields) or spmv_packed and spmm_packed (the
    same cut in slots, and the runs a block walks: formats/packed.
    walk_fields) walk, with a packed layout's device launches per call."""
    import numpy as np

    from tpu_spmv_torch.formats import packed as fpacked
    from tpu_spmv_torch.formats.sell import SEGMENT_SUBTILES
    from tpu_spmv_torch.kernels.packed import packed_launches

    ss = lay.split_seg.cpu().numpy()
    split = (f"split chunks {ss.shape[1]} ({int((ss[2] - ss[1]).sum())} "
             "partial rows)")
    if isinstance(lay, fpacked.PackedRanked):
        koff = lay.chunk_koff.cpu().numpy().astype(np.int64)
        touched = -(-koff[1:] // 8) - koff[:-1] // 8
        runs = lay.run_ptr.shape[1] - 1
        print(f"    [{label}] segments {lay.seg_chunk.numel()} of at most "
              f"Q={SEGMENT_SUBTILES} sub-tiles over {lay.num_chunks} chunks "
              f"({int(koff[-1])} slots, longest chunk {int(np.diff(koff).max())}"
              f" slots touching {int(touched.max())} sub-tiles); {split}; "
              f"{runs} runs of at most {fpacked.RUN_SUBTILES} sub-tiles and "
              f"{fpacked.RUN_SEGMENTS} segments, one block each; device "
              f"launches per call: {packed_launches(lay)} (B <= 8), "
              f"{packed_launches(lay, 13)} (B = 13)", flush=True)
        return
    cp = np.diff(lay.chunk_ptr.cpu().numpy())
    print(f"    [{label}] segments {lay.seg_chunk.numel()} of at most "
          f"Q={SEGMENT_SUBTILES} sub-tiles over {lay.num_chunks} chunks "
          f"({int(cp.sum())} sub-tiles, longest chunk {int(cp.max())}); "
          f"{split}", flush=True)


def _replay_check(label, name, call):
    """Two replays of one captured call() on the card give the same bits
    (prints max |y1 - y2|, fails unless it is 0)."""
    import torch

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    y1 = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    diff = float((out - y1).abs().max())
    print(f"    [{label}] two CUDA-graph replays of {name}: "
          f"max |y1 - y2| = {diff}", flush=True)
    if diff != 0.0:
        raise SmokeFailure(f"{label}: graph replays differ by {diff}")


def _ring(label, lay, batch=1, passes=1):
    """One line on the ring a windowed phase walks (formats/sell.
    window_fields): its shared memory (ring and stages), the steps, the
    CTAs a launch runs, the column passes and the device launches per
    call."""
    from tpu_spmv_torch.kernels.sell import (
        window_bytes, windowed_ctas, windowed_launches,
    )

    print(f"    [{label}] ring {lay.ring_blocks} blocks x {batch} column(s) "
          f"and stages of {lay.stage_subtiles} sub-tiles = "
          f"{window_bytes(lay, batch)} bytes of shared memory, "
          f"{lay.step_lo.numel()} steps of {lay.step_subtiles} sub-tile(s), "
          f"{windowed_ctas(lay, batch)} CTAs, {passes} column pass(es), "
          f"{windowed_launches(lay, batch)} launch(es) per call", flush=True)


def _dia_ring(label, lay):
    """One line on the ring of a spmv_dia_windowed phase (kernels/dia.
    dia_ring): the step S, the ring W (span + 2S floats, rounded), the
    bytes of a stage and of all shared memory, the CTAs a launch runs and
    the launches one call counts (a call on x = 0)."""
    import torch

    from tpu_spmv_torch.kernels.dia import (
        dia_ring, dia_smem_budget, dia_windowed_ctas, spmv_dia_windowed,
    )

    ring = dia_ring(lay, dia_smem_budget(lay.vals.device))
    span = max(lay.offsets) - min(lay.offsets)
    before = spmv_dia_windowed.launches
    spmv_dia_windowed(lay, torch.zeros(lay.n, device=lay.vals.device))
    launches = spmv_dia_windowed.launches - before
    print(f"    [{label}] steps of S={ring.step_rows} rows "
          f"({-(-lay.m // ring.step_rows)} steps), ring W={ring.ring} floats "
          f"(span {span} + 2S), stages of {ring.stage_bytes} bytes "
          f"({lay.num_diagonals} diagonals), {ring.smem} bytes of shared "
          f"memory, {dia_windowed_ctas(lay, ring)} CTAs, {launches} "
          "launch(es) per call", flush=True)
    return ring


def _ranked_runs(label, lay, batch):
    """One line on the run table spmm_ranked walks (formats/packed.
    ranked_walk_fields) and its device launches per call at batch."""
    from tpu_spmv_torch.formats import packed as fpacked
    from tpu_spmv_torch.kernels.packed import packed_launches

    print(f"    [{label}] {lay.run_ptr.shape[1] - 1} runs of at most "
          f"{fpacked.RUN_SUBTILES} sub-tiles and {fpacked.RUN_SEGMENTS} "
          f"segments over {lay.seg_chunk.numel()} segments, one block each; "
          f"device launches per call: {packed_launches(lay, batch)}",
          flush=True)


def _spmv_replay_check(label, kernel, layout, mat, perm, batch=None):
    """_replay_check of one SpMV kernel (or, with batch, SpMM kernel) on
    the layout, at x = X_SEED's."""
    import numpy as np
    import torch

    lay = layout.to(torch.device("cuda"))
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(X_SEED).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(lay.vals.device)
    _replay_check(label, kernel.__name__, lambda: kernel(lay, xt))


def _phases(stats):
    """The DIA, ranked and sell phases, then the packed and SpMM phases.
    Returns the warm times R is computed from."""
    import torch

    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.dia import spmv_dia, spmv_dia_reference
    from tpu_spmv_torch.kernels.packed import spmv_packed, spmv_packed_reference
    from tpu_spmv_torch.kernels.sell import (
        spmv_ranked, spmv_ranked_reference, spmv_ranked_windowed,
        spmv_ranked_windowed_reference, spmv_sell, spmv_sell_reference,
    )
    from tpu_spmv_torch.kernels.spmm import (
        spmm_packed, spmm_packed_reference, spmm_ranked, spmm_ranked_reference,
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
        for vdt, oracle in ((None, mat), (bf16, mat.rounded())):
            lay = DiaSlabs.from_csr(ck.matrix, val_dtype=vdt)
            tag = "bf16" if vdt else "f32"
            _check_kernel(f"{name} dia {tag}", spmv_dia, spmv_dia_reference,
                          lay, mat, perm, oracle, stats,
                          csr=None if vdt else ck.matrix)

    r_times = {}
    mat = load_input("synthetic:lap2d_1024")
    ck, perm = prepare(mat, "always")
    for groups in (True, False):
        lay = RankedSlabs.from_csr(ck.matrix, allow_groups=groups)
        if bool(lay.group_code) != groups:
            raise SmokeFailure("lap2d_1024 rcm: grouping not as requested")
        kind = f"grouped G={lay.num_groups}" if groups else "ungrouped"
        _segments(f"lap2d_1024 rcm ranked {kind}", lay)
        t = _check_kernel(f"lap2d_1024 rcm ranked {kind}", spmv_ranked,
                          spmv_ranked_reference, lay, mat, perm, mat, stats,
                          csr=ck.matrix)
        if groups:
            r_times["ranked"] = (t, int(lay.chunk_ptr[-1]))
            # The same layout through the windowed kernel (x of 4 MB
            # passes the gate: a comparison, not a CLI route).
            label = f"lap2d_1024 rcm ranked_windowed {kind}"
            _ring(label, lay)
            _check_kernel(label, spmv_ranked_windowed,
                          spmv_ranked_windowed_reference, lay, mat, perm,
                          mat, stats, twin=spmv_ranked, csr=ck.matrix,
                          twin_equal=True)
    sell = SellSlabs.from_csr(ck.matrix)
    _segments("lap2d_1024 rcm sell", sell)
    _check_kernel("lap2d_1024 rcm sell", spmv_sell, spmv_sell_reference,
                  sell, mat, perm, mat, stats, csr=ck.matrix)
    del sell
    for vdt, groups in ((None, True), (None, False), (bf16, True)):
        lay = PackedRanked.from_csr(ck.matrix, allow_groups=groups,
                                    val_dtype=vdt)
        if bool(lay.group_code) != groups:
            raise SmokeFailure("lap2d_1024 rcm packed: grouping not as "
                               "requested")
        kind = ("bf16 " if vdt else "f32 ") + (
            f"grouped G={lay.num_groups}" if groups else "delta")
        if groups and vdt is None:
            _segments(f"lap2d_1024 rcm packed {kind}", lay)
        t = _check_kernel(f"lap2d_1024 rcm packed {kind}", spmv_packed,
                          spmv_packed_reference, lay, mat, perm,
                          mat.rounded() if vdt else mat, stats,
                          csr=None if vdt else ck.matrix)
        if groups and vdt is None:
            r_times["packed"] = (t, int(lay.chunk_koff[-1]) / 8)
    lap_layouts = (RankedSlabs.from_csr(ck.matrix),
                   PackedRanked.from_csr(ck.matrix))
    for B in (8, 5):
        _ranked_runs(f"lap2d_1024 rcm spmm_ranked B={B}", lap_layouts[0], B)
        t_rk = _check_kernel(f"lap2d_1024 rcm spmm_ranked B={B}", spmm_ranked,
                             spmm_ranked_reference, lap_layouts[0], mat, perm,
                             mat, stats, batch=B, csr=ck.matrix)
        t_pk = _check_kernel(f"lap2d_1024 rcm spmm_packed B={B}", spmm_packed,
                             spmm_packed_reference, lap_layouts[1], mat, perm,
                             mat, stats, batch=B, csr=ck.matrix)
    _spmv_replay_check("lap2d_1024 rcm packed", spmv_packed, lap_layouts[1],
                       mat, perm)
    _spmv_replay_check("lap2d_1024 rcm spmm_packed B=8", spmm_packed,
                       lap_layouts[1], mat, perm, batch=8)
    _spmv_replay_check("lap2d_1024 rcm spmm_ranked B=8", spmm_ranked,
                       lap_layouts[0], mat, perm, batch=8)
    r_times["spmm ranked"] = (t_rk, r_times["ranked"][1])
    r_times["spmm packed"] = (t_pk, r_times["packed"][1])
    del lap_layouts

    mat = load_input("synthetic:banded_1m")
    ck, perm = prepare(mat, "auto")
    ranked = RankedSlabs.from_csr(ck.matrix)
    _segments(f"banded_1m ranked grouped G={ranked.num_groups}", ranked)
    _check_kernel("banded_1m ranked", spmv_ranked, spmv_ranked_reference,
                  ranked, mat, perm, mat, stats, csr=ck.matrix)
    _spmv_replay_check("banded_1m ranked", spmv_ranked, ranked, mat, perm)
    sell = SellSlabs.from_csr(ck.matrix)
    _segments("banded_1m sell", sell)
    _check_kernel("banded_1m sell", spmv_sell, spmv_sell_reference,
                  sell, mat, perm, mat, stats, csr=ck.matrix)
    _spmv_replay_check("banded_1m sell", spmv_sell, sell, mat, perm)
    del sell
    packed = PackedRanked.from_csr(ck.matrix)
    _segments(f"banded_1m packed grouped G={packed.num_groups}", packed)
    _check_kernel("banded_1m packed", spmv_packed, spmv_packed_reference,
                  packed, mat, perm, mat, stats, csr=ck.matrix)
    _spmv_replay_check("banded_1m packed", spmv_packed, packed, mat, perm)
    binned = None
    for w in (4, 2, 1):
        try:
            binned = PackedRanked.from_csr(ck.matrix, bin_blocks=w)
            break
        except ValueError as e:
            print(f"banded_1m packed W={w}: {e}", flush=True)
    if binned is None:
        raise SmokeFailure("banded_1m: no column-binned packed layout builds")
    _check_kernel(f"banded_1m packed binned W={w}", spmv_packed,
                  spmv_packed_reference, binned, mat, perm, mat, stats)
    del binned
    for B in (8, 5):
        _ranked_runs(f"banded_1m spmm_ranked B={B}", ranked, B)
        _check_kernel(f"banded_1m spmm_ranked B={B}", spmm_ranked,
                      spmm_ranked_reference, ranked, mat, perm, mat, stats,
                      batch=B, csr=ck.matrix)
        _check_kernel(f"banded_1m spmm_packed B={B}", spmm_packed,
                      spmm_packed_reference, packed, mat, perm, mat, stats,
                      batch=B, csr=ck.matrix)
    _spmv_replay_check("banded_1m spmm_packed B=8", spmm_packed, packed, mat,
                       perm, batch=8)
    _spmv_replay_check("banded_1m spmm_ranked B=8", spmm_ranked, ranked, mat,
                       perm, batch=8)
    # spmv_ranked_windowed on the aligned (bin 0) ranked layout of this
    # banded matrix, whose split chunk takes the fix-up launch: x of 4 MB
    # passes the gate, so this is a comparison with the resident kernel,
    # not a CLI route.
    _ring("banded_1m ranked_windowed", ranked)
    _check_kernel("banded_1m ranked_windowed", spmv_ranked_windowed,
                  spmv_ranked_windowed_reference, ranked, mat, perm, mat,
                  stats, twin=spmv_ranked, csr=ck.matrix, twin_equal=True)
    _spmv_replay_check("banded_1m ranked_windowed", spmv_ranked_windowed,
                       ranked, mat, perm)
    return r_times


def _windowed_phases(stats):
    """The windowed kernels where the CLIs route to them: lap2d_4096
    (16.8M rows, 83.9M nnz; x 67 MB, past half the 50 MB L2) in natural
    order through spmv_dia_windowed (f32 and bf16) and after RCM through
    spmv_ranked_windowed, and lap2d_1024 after RCM through
    spmm_ranked_windowed at B = 8 and 5, at the step and column passes B'
    the CLI picks (B = 8 must take one pass); plus lap2d_1024's DIA layout
    through spmv_dia_windowed beside spmv_dia. Each is also held to its
    resident kernel on the same layout (the single-vector ones bit for
    bit). Prints the host set-up seconds."""
    import torch

    from tpu_spmv_torch.formats.dia import DiaSlabs
    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.kernels.dia import (
        dia_x_fits, spmv_dia, spmv_dia_windowed, spmv_dia_windowed_reference,
    )
    from tpu_spmv_torch.kernels.sell import (
        resident_x_fits, spmv_ranked, spmv_ranked_windowed,
        spmv_ranked_windowed_reference,
    )
    from tpu_spmv_torch.kernels.spmm import (
        spmm_ranked, spmm_ranked_windowed, spmm_ranked_windowed_reference,
    )
    from tpu_spmv_torch.tools.spmv import fit_window, load_input, prepare

    dev = torch.device("cuda")
    setup = {}
    t0 = time.perf_counter()
    mat = load_input("synthetic:lap2d_4096")
    setup["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck, perm = prepare(mat, "auto")
    setup["plan (natural order)"] = time.perf_counter() - t0
    for vdt in (None, torch.bfloat16):
        tag = "bf16" if vdt else "f32"
        t0 = time.perf_counter()
        lay = DiaSlabs.from_csr(ck.matrix, val_dtype=vdt).to(dev)
        setup[f"DIA {tag} build"] = time.perf_counter() - t0
        if dia_x_fits(lay):
            raise SmokeFailure("lap2d_4096: x passes the DIA residency gate")
        label = f"lap2d_4096 dia_windowed {tag}"
        ring = _dia_ring(label, lay)
        _check_kernel(f"{label} (S={ring.step_rows})", spmv_dia_windowed,
                      spmv_dia_windowed_reference, lay, mat, perm,
                      mat.rounded() if vdt else mat, stats, twin=spmv_dia,
                      csr=None if vdt else ck.matrix, twin_equal=True)
        del lay
    t0 = time.perf_counter()
    ck, perm = prepare(mat, "always")
    setup["RCM + permute"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay = RankedSlabs.from_csr(ck.matrix).to(dev)
    setup["ranked build"] = time.perf_counter() - t0
    if resident_x_fits(lay):
        raise SmokeFailure("lap2d_4096: x passes the ranked residency gate")
    lay, _ = fit_window(lay, 1, dev)
    _ring("lap2d_4096 rcm ranked_windowed", lay)
    _check_kernel("lap2d_4096 rcm ranked_windowed", spmv_ranked_windowed,
                  spmv_ranked_windowed_reference, lay, mat, perm, mat, stats,
                  twin=spmv_ranked, csr=ck.matrix, twin_equal=True)
    _spmv_replay_check("lap2d_4096 rcm ranked_windowed", spmv_ranked_windowed,
                       lay, mat, perm)
    del lay, ck, mat
    print("lap2d_4096 host set-up s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in setup.items()), flush=True)

    mat = load_input("synthetic:lap2d_1024")
    ck, perm = prepare(mat, "auto")
    lay = DiaSlabs.from_csr(ck.matrix).to(dev)
    _dia_ring("lap2d_1024 dia_windowed f32", lay)
    _check_kernel("lap2d_1024 dia_windowed f32", spmv_dia_windowed,
                  spmv_dia_windowed_reference, lay, mat, perm, mat, stats,
                  twin=spmv_dia, csr=ck.matrix, twin_equal=True)
    _spmv_replay_check("lap2d_1024 dia_windowed f32", spmv_dia_windowed, lay,
                       mat, perm)
    del lay
    ck, perm = prepare(mat, "always")
    for B in (8, 5):
        lay = RankedSlabs.from_csr(ck.matrix).to(dev)
        if resident_x_fits(lay, batch=B) != (B == 5):
            raise SmokeFailure(f"lap2d_1024 B={B}: gate not as expected")
        lay, cols = fit_window(lay, B, dev)
        passes = -(-B // cols)
        label = f"lap2d_1024 rcm spmm_ranked_windowed B={B}"
        _ring(label, lay, cols, passes)
        if B == 8 and passes != 1:
            raise SmokeFailure(f"{label}: {passes} column passes, not one")
        _check_kernel(f"{label} (B'={cols}: {passes} pass(es))",
                      spmm_ranked_windowed,
                      spmm_ranked_windowed_reference, lay, mat, perm, mat,
                      stats, batch=cols, twin=spmm_ranked, csr=ck.matrix)


def _solve_oracle(sys_, b):
    """x of L x = b in float64, pack by pack (a pack's rows are mutually
    independent), from the host system alone: no layout, no kernel."""
    import numpy as np
    import scipy.sparse as sp

    L = sys_.lower.to_scipy().tocsr().astype(np.float64)
    d = L.diagonal()
    strict = (L - sp.diags(d)).tocsr()
    x = np.zeros(L.shape[0])
    b = np.asarray(b, np.float64)
    ptr = sys_.pack_ptr
    for p in range(sys_.num_packs):
        r0, r1 = int(ptr[p]), int(ptr[p + 1])
        x[r0:r1] = (b[r0:r1] - strict[r0:r1] @ x) / d[r0:r1]
    return x


def _chunk_depth(sys_, lay):
    """Dependency depth of the solve at chunk granularity: chunk c waits
    on chunk b when any row of c reads a row of b. The kernel waits on
    whole chunks, so this, not the row-level depth, bounds its chain."""
    import numpy as np
    import scipy.sparse as sp

    from tpu_spmv_torch.sts.host import find_levels

    L = sys_.lower
    rows = np.repeat(np.arange(L.m, dtype=np.int64), np.diff(L.indptr))
    pad = lay.pad_index.cpu().numpy().astype(np.int64)
    c_row = pad[rows] >> 7
    c_col = pad[L.indices.astype(np.int64)] >> 7
    dep = c_col < c_row
    n = lay.slabs.num_chunks
    g = sp.csr_matrix(
        (np.ones(int(dep.sum()), np.float32), (c_row[dep], c_col[dep])),
        shape=(n, n),
    )
    g.sum_duplicates()
    return int(find_levels(g.indptr.astype(np.int32),
                           g.indices.astype(np.int32)).max()) + 1


def _time_eager(fn, layouts, b, calls):
    """Seconds per call of `calls` eager calls over `layouts` in rotation,
    after one warm call on each (CUDA events)."""
    import torch

    for lay in layouts:
        fn(lay, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(layouts[i % len(layouts)], b)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / calls


def _time_solve_library(label, sys_, b):
    """Warm seconds per call of the one PyTorch call that solves the same
    system: torch.triangular_solve with L as a sparse CSR tensor, which
    PyTorch runs through cuSPARSE's SpSV (its analysis included, as each
    call redoes it), eagerly; torch.linalg.solve_triangular takes dense
    matrices only."""
    import numpy as np
    import torch

    L = _csr_tensor(sys_.lower, torch.device("cuda"))
    bt = torch.from_numpy(np.asarray(b, np.float32)).to(L.device)[:, None]

    def solve(A, v):
        return torch.triangular_solve(v, A, upper=False).solution

    x = solve(L, bt).cpu().numpy().ravel()
    wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
    t = _time_eager(solve, [L], bt, 3)
    print(f"    [{label}] library solve (torch.triangular_solve, sparse CSR "
          f"L, cuSPARSE SpSV, eager): {t * 1e6:.2f} us, Number Wrong "
          f"{wrong} for x = ones", flush=True)
    return t


def _check_solve(label, sys_, b, ranked, stats, setup, library_s,
                 link_us=None, replay=False):
    """One solve phase: build the layout (timed), kernel vs plain on the
    card, the float64 oracle, then warm and cold times (kernel from a
    CUDA graph, plain eagerly). library_s: the library solve's time on
    the same system. link_us: kernel name -> its us per link on the
    chain, for the bound by depth. replay: also _replay_check the
    kernel. Returns the layout (on the card) and the kernel's warm
    TimeMin in seconds."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv, bench_spmv_cold
    from tpu_spmv_torch.kernels.sts import (
        lower_solve_blocks, lower_solve_blocks_reference, lower_solve_ranked,
        lower_solve_ranked_reference,
    )
    from tpu_spmv_torch.sts.host import find_levels
    from tpu_spmv_torch.sts.solve import LowerSolveLayout

    # The dependency depth of the solved system (below the pack count
    # when the packs are sorted by size).
    depth = int(find_levels(sys_.lower.indptr, sys_.lower.indices).max()) + 1
    t0 = time.perf_counter()
    lay = LowerSolveLayout.build(sys_, b, ranked=ranked)
    setup = dict(setup, layout=time.perf_counter() - t0)
    chunk_depth = _chunk_depth(sys_, lay)
    if lay.ranked is not None:
        kernel, plain = lower_solve_ranked, lower_solve_ranked_reference
        slabs, steps = lay.ranked, lay.ranked_steps
        shape = f"rank_nb {slabs.rank_nb}"
    else:
        kernel, plain = lower_solve_blocks, lower_solve_blocks_reference
        slabs, steps = lay.slabs, lay.slab_steps
        shape = f"max_nb {slabs.max_nb}"
    bs = lay.b_scale
    before = kernel.launches
    xk = kernel(slabs, bs)
    xp = plain(slabs, bs, steps)
    torch.cuda.synchronize()
    delta = kernel.launches - before
    err = float((xk - xp).abs().max())
    rel_plain = float((xk - xp).norm() / xp.norm().clamp_min(1e-30))
    x = xk.reshape(-1)[lay.pad_index].cpu().numpy()
    del xp
    wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
    x_ref = _solve_oracle(sys_, b)
    rel = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
    if delta != 1:
        raise SmokeFailure(f"{label}: launch counter moved by {delta}, not 1")
    if not rel_plain <= SOLVE_TOL:
        raise SmokeFailure(f"{label}: kernel differs from plain, RelL2 "
                           f"{rel_plain:.3g}")
    if wrong != 0 or not rel <= SOLVE_TOL:
        raise SmokeFailure(f"{label}: Number Wrong {wrong}, RelL2 {rel:.3g}")

    nnz = sys_.lower.nnz
    bflat = bs.reshape(-1)
    # The bound: slabs read once, b read and x written once. Beside it,
    # the floor of this design: each chunk level costs at least a link of
    # this kernel's own chain (a floor of the design, not of the card).
    bound_ms, bound_by = _bound(slabs.nbytes + 8 * bs.numel(), 2 * nnz)
    link = (link_us or {}).get(kernel.__name__)
    depth_txt = "no chain link measured" if link is None else (
        f"floor of this design (depth x own link) {chunk_depth} chunk "
        f"levels x {link:.3f} us = {chunk_depth * link:.2f} us")

    def kfn(sl, bf):
        return kernel(sl, bf.view(-1, 128))

    def pfn(sl, bf):
        return plain(sl, bf.view(-1, 128), steps)

    if replay:
        _replay_check(label, kernel.__name__, lambda: kernel(slabs, bs))
    t0 = time.perf_counter()
    warm = bench_spmv(kfn, slabs, bflat, nnz=nnz)
    cold = bench_spmv_cold(kfn, slabs.clone, bflat, nnz=nnz,
                           layout_bytes=slabs.nbytes)
    eager = bench_spmv(kfn, slabs, bflat, nnz=nnz, graph=False, samples=3)
    k = cold.iters[2]
    p_warm = _time_eager(pfn, [slabs], bflat, 3)
    p_cold = _time_eager(pfn, [slabs.clone() for _ in range(k)], bflat, k)
    us = lambda s: f"{s * 1e6:.2f}"  # noqa: E731
    print(
        f"[{label}] {kernel.__name__}: launches +{delta}, RelL2 vs plain "
        f"{rel_plain:.3g} (max abs {err:.3g}), Number Wrong {wrong}, RelL2 "
        f"vs f64 oracle {rel:.3g} | packs {sys_.num_packs}, dependency "
        f"levels {depth} (rows) / {chunk_depth} (chunks), chunks "
        f"{slabs.num_chunks}, {shape}, slabs {slabs.nbytes / 2**20:.1f} MB, "
        f"wait table {slabs.wait_chunk.numel()} entries (at most "
        f"{int(slabs.wait_ptr.diff().max())} a chunk) | host set-up s: "
        + ", ".join(f"{k_} {v:.2f}" for k_, v in setup.items()),
        flush=True,
    )
    print(f"    kernel TimeMin/TimeAvg us (CUDA graph): warm "
          f"{us(warm.time_min)}/{us(warm.time_avg)}, cold "
          f"{us(cold.time_min)}/{us(cold.time_avg)} (K={k}) | eager warm "
          f"{us(eager.time_min)} | GF/s warm {warm.gflops:.2f} | "
          f"{1e6 * warm.time_min / sys_.num_packs:.3f} us per pack, "
          f"{1e6 * warm.time_min / depth:.3f} us per row level, "
          f"{1e6 * warm.time_min / chunk_depth:.3f} us per chunk level",
          flush=True)
    print(f"    plain  us per solve (eager host loop over the packs): warm "
          f"{us(p_warm)}, cold {us(p_cold)} | bound by bytes "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), {depth_txt} | timing wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats.setdefault(kernel.__name__, []).append(
        dict(label=label, err=err, ms=warm.time_min * 1e3,
             plain_ms=p_warm * 1e3, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=library_s * 1e3)
    )
    return lay, warm.time_min


def _solve_phases(stats):
    """Both solve kernels at full size, on the schedules users run, after
    the bidiagonal chain that measures a link."""
    from tpu_spmv_torch.bench.solve_times import CHAIN_ROWS, system
    from tpu_spmv_torch.sts.host import build_sts, compute_b, find_levels
    from tpu_spmv_torch.sts.solve import RANKED_SOLVE_MAX_NB, LowerSolveLayout
    from tpu_spmv_torch.tools.spmv import load_input

    sys_ = system("chain")
    b = compute_b(sys_.lower)
    library_s = _time_solve_library("chain LS", sys_, b)
    link_us = {}
    for ranked in (True, False):
        label = f"chain {CHAIN_ROWS} LS {'ranked' if ranked else 'blocks'}"
        lay, t = _check_solve(label, sys_, b, ranked, stats, {}, library_s)
        name = "lower_solve_ranked" if ranked else "lower_solve_blocks"
        if ranked and lay.ranked is None:
            raise SmokeFailure(f"{label}: no rank-windowed layout built")
        link_us[name] = t * 1e6 / CHAIN_ROWS
        print(f"    [{label}] {name}: {link_us[name]:.3f} us per link "
              f"({CHAIN_ROWS} chunks in a chain, one real slot each)",
              flush=True)

    for name, order, variants in (
        ("lap2d_1024", "LS", (True, False)),
        ("lap2d_1024", "COLOR", (True,)),
        ("lap3d_101", "LS", (True, False)),
        ("banded_1m", "LS", (True,)),
    ):
        t0 = time.perf_counter()
        mat = load_input(f"synthetic:{name}")
        t1 = time.perf_counter()
        sys_ = build_sts(mat, order_type=order)
        setup = dict(load=t1 - t0, build_sts=time.perf_counter() - t1)
        b = compute_b(sys_.lower)
        library_s = _time_solve_library(f"{name} {order}", sys_, b)
        for ranked in variants:
            label = f"{name} {order} {'ranked' if ranked else 'blocks'}"
            lay, _ = _check_solve(label, sys_, b, ranked, stats, setup,
                                  library_s, link_us,
                                  replay=(name, order) == ("lap2d_1024", "LS"))
            if ranked and lay.ranked is None:
                raise SmokeFailure(f"{label}: no rank-windowed layout built")
            if name == "banded_1m":
                # Scattered dependencies: the exact windows span far more
                # than RANKED_SOLVE_MAX_NB blocks, so the binned ones
                # engaged (tests/test_sts.py's scattered-solve check).
                if not (lay.ranked.rank_nb <= RANKED_SOLVE_MAX_NB
                        < lay.slabs.max_nb):
                    raise SmokeFailure(f"{label}: binned path not engaged")
            del lay

    # The k=3 schedule (one chunk per pack), timed by its CLI run: its
    # row-level and chunk-level depths.
    mat = load_input("synthetic:lap2d_1024")
    sys_ = build_sts(mat, order_type="LS", k=3, sup_row_sizes=(32,))
    lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower))
    rows = int(find_levels(sys_.lower.indptr, sys_.lower.indices).max()) + 1
    print(f"[lap2d_1024 LS k=3] packs {sys_.num_packs}, dependency levels "
          f"{rows} (rows) / {_chunk_depth(sys_, lay)} (chunks), chunks "
          f"{lay.slabs.num_chunks}", flush=True)


def _ic0_phases():
    """IC(0) apply, kernel vs plain, and one graph-captured PCG iteration
    on lap3d_101 and lap2d_1024; the residual as lap3d_101 converges."""
    import numpy as np
    import torch

    from tpu_spmv_torch.formats.sell import RankedSlabs
    from tpu_spmv_torch.sts.ic0 import (
        IC0Preconditioner, capture_pcg_step, pcg_ic0_init,
    )
    from tpu_spmv_torch.tools.spmv import load_input

    dev = torch.device("cuda")
    for name in ("lap3d_101", "lap2d_1024"):
        mat = load_input(f"synthetic:{name}")
        t0 = time.perf_counter()
        pre = IC0Preconditioner.build(mat)
        build_s = time.perf_counter() - t0
        lay = RankedSlabs.from_csr(mat).to(dev)
        r = torch.from_numpy(np.random.default_rng(X_SEED).standard_normal(
            mat.m).astype(np.float32)).to(dev)
        zk, zp = pre.apply(r), pre.apply(r, plain=True)
        rel = float((zk - zp).norm() / zp.norm())
        if not rel <= SOLVE_TOL:
            raise SmokeFailure(f"{name} ic0 apply: RelL2 vs plain {rel:.3g}")
        t_apply = _time_eager(lambda p, v: p.apply(v), [pre], r, 3)
        t_plain = _time_eager(lambda p, v: p.apply(v, plain=True), [pre], r, 2)

        b = torch.ones(mat.m, device=dev)
        state = pcg_ic0_init(b, pre)
        graph = capture_pcg_step(lay, pre, state)
        trace, done = [], 0
        for it in (10, 20, 30, 40, 50, 60, 100) if name == "lap3d_101" else ():
            for _ in range(it - done):
                graph.replay()
            done = it
            x = state[0].cpu().numpy()
            res = np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m)
            if not np.isfinite(res):
                raise SmokeFailure(f"{name} pcg: residual {res} at {it}")
            trace.append(f"{it}:{res:.3e}")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            graph.replay()
        stop.record()
        stop.synchronize()
        it_us = start.elapsed_time(stop) / 10 * 1e3
        print(f"[{name} ic0] apply RelL2 vs plain {rel:.3g} | host set-up "
              f"(factor + both layouts) {build_s:.2f} s | L {pre.lay_l.kernel}"
              f" {pre.lay_l.num_packs} packs, L^T {pre.lay_u.kernel} "
              f"{pre.lay_u.num_packs} packs | apply eager us: kernels "
              f"{t_apply * 1e6:.1f}, plain {t_plain * 1e6:.1f} | PCG "
              f"iteration (CUDA graph) {it_us:.1f} us", flush=True)
        if trace:
            print(f"    rms residual by iteration: {' '.join(trace)}",
                  flush=True)
        del pre, lay, graph, state


def _plans(r_times):
    """R measured in this run, for SpMV and for SpMM (B = 5), beside the
    planner's constants, and the plan auto takes on each matrix for
    each (the sampled sub-tile counts are in the plan's reason)."""
    from tpu_spmv_torch.tools.spmv import load_input, prepare
    from tpu_spmv_torch.tune import plan

    for op, const in (("", "PACKED_OVER_RANKED"),
                      ("spmm ", "SPMM_PACKED_OVER_RANKED")):
        (t_pk, s_pk), (t_rk, s_rk) = (r_times[op + "packed"],
                                      r_times[op + "ranked"])
        r = (t_pk / s_pk) / (t_rk / s_rk)
        print(f"R {op or 'spmv '}(packed/ranked warm time per walked "
              f"sub-tile, lap2d_1024 rcm, grouped{', B=5' if op else ''}): "
              f"{r:.3f} = ({t_pk * 1e6:.2f} us / {s_pk:.0f}) / "
              f"({t_rk * 1e6:.2f} us / {s_rk}); plan.py {const} = "
              f"{getattr(plan, const)}", flush=True)
    for name, rcm in (("lap2d_1024", "auto"), ("lap2d_1024", "always"),
                      ("banded_1m", "auto"), ("general_500k", "auto"),
                      ("powerlaw_1m", "auto")):
        ck, _ = prepare(load_input(f"synthetic:{name}"), rcm)
        for spmm in (False, True):
            p = plan.gpu_plan(ck.matrix, assume_rcm=rcm == "always",
                              spmm=spmm)
            print(f"auto plan on {name} (rcm {rcm}) for "
                  f"{'SpMM' if spmm else 'SpMV'}: {p.kernel} ({p.reason})",
                  flush=True)


def _drive(steps):
    """Zero every launch counter, run the steps, return the counts. A
    step is a (CLI module, argv) pair, whose main must return 0, or a
    callable that raises SmokeFailure."""
    from tpu_spmv_torch.kernels import dia, packed, sell, spmm, sts

    wrappers = (dia.spmv_dia, dia.spmv_dia_windowed, sell.spmv_ranked,
                sell.spmv_ranked_windowed, sell.spmv_sell, packed.spmv_packed,
                spmm.spmm_ranked, spmm.spmm_ranked_windowed, spmm.spmm_packed,
                sts.lower_solve_ranked, sts.lower_solve_blocks)
    for w in wrappers:
        w.launches = 0
    for step in steps:
        if callable(step):
            step()
            continue
        cli, argv = step
        t0 = time.perf_counter()
        print(f"== tools.{cli.__name__.rsplit('.', 1)[1]}.main({argv})",
              flush=True)
        rc = cli.main(argv)
        print(f"   (wall {time.perf_counter() - t0:.1f} s)", flush=True)
        if rc != 0:
            raise SmokeFailure(f"{cli.__name__}.main({argv}) returned {rc}")
    return {w.__name__: w.launches for w in wrappers}


def _library_blocks():
    """Launch counts of the library's lower_solve on layouts built
    (before the counters are zeroed) with ranked=False."""
    import numpy as np

    from tpu_spmv_torch.sts.host import build_sts, compute_b
    from tpu_spmv_torch.sts.solve import LowerSolveLayout, lower_solve
    from tpu_spmv_torch.tools.spmv import load_input

    def solve(name, lay):
        def run():
            x = lower_solve(lay).cpu().numpy()
            wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
            print(f"== lower_solve({name} LS, ranked=False): {lay.kernel}, "
                  f"Number Wrong {wrong}", flush=True)
            if wrong:
                raise SmokeFailure(f"library lower_solve on {name}: Number "
                                   f"Wrong {wrong}")
        return run

    steps = []
    for name in ("lap2d_1024", "lap3d_101"):
        sys_ = build_sts(load_input(f"synthetic:{name}"), order_type="LS")
        lay = LowerSolveLayout.build(sys_, compute_b(sys_.lower), ranked=False)
        steps.append(solve(name, lay))
    return _drive(steps)


def _main_path():
    """Launch counts of each kernel over its own path's run."""
    from tpu_spmv_torch.tools import solve as solve_cli
    from tpu_spmv_torch.tools import spmm as spmm_cli
    from tpu_spmv_torch.tools import spmv as spmv_cli
    from tpu_spmv_torch.tools import sts as sts_cli

    spmv_path = _drive((
        (spmv_cli, ["synthetic:lap2d_1024", "20"]),
        (spmv_cli, ["synthetic:lap2d_1024", "20", "--val-dtype", "bf16",
                    "--cold"]),
        (spmv_cli, ["synthetic:lap2d_1024", "20", "--kernel", "packed",
                    "--rcm", "always"]),
        (spmv_cli, ["synthetic:banded_1m", "20"]),
        (spmv_cli, ["synthetic:banded_1m", "20", "--kernel", "ranked"]),
        (spmv_cli, ["synthetic:banded_1m", "20", "--kernel", "sell"]),
        (spmv_cli, ["synthetic:banded_1m", "20", "--kernel", "packed"]),
        (spmm_cli, ["synthetic:lap2d_1024", "20", "--batch", "8"]),
        (spmm_cli, ["synthetic:lap2d_1024", "20", "--batch", "8", "--kernel",
                    "resident"]),
        (spmm_cli, ["synthetic:lap2d_1024", "20", "--batch", "5", "--rcm",
                    "always"]),
        (spmm_cli, ["synthetic:lap2d_1024", "20", "--batch", "5", "--kernel",
                    "windowed", "--rcm", "always"]),
        (spmv_cli, ["synthetic:lap2d_4096", "20"]),
        (spmv_cli, ["synthetic:lap2d_4096", "20", "--kernel", "ranked",
                    "--rcm", "always"]),
    ))
    sts_path = _drive((
        (sts_cli, ["synthetic:lap2d_1024", "5"]),
        (sts_cli, ["synthetic:lap2d_1024", "5", "--order", "COLOR"]),
        (sts_cli, ["synthetic:lap2d_1024", "3", "--k", "3"]),
        (sts_cli, ["synthetic:lap3d_101", "5", "--part", "upper"]),
        (solve_cli, ["synthetic:lap3d_101", "--precond", "ic0", "--iters",
                     str(PCG_ITERS), "--tol", str(PCG_TOL)]),
    ))
    library = _library_blocks()
    counts = dict(spmv_path,
                  lower_solve_ranked=sts_path["lower_solve_ranked"],
                  lower_solve_blocks=library["lower_solve_blocks"])
    print(f"launches: SpMV/SpMM CLIs {spmv_path} | solve CLIs {sts_path} | "
          f"library lower_solve(ranked=False) {library}", flush=True)
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
    "spmv_packed": ("tpu_spmv_torch/kernels/csrc/packed.cu",
                    "tpu_spmv/kernels/packed.py:319",
                    "lap2d_1024 rcm packed f32 grouped"),
    "spmm_ranked": ("tpu_spmv_torch/kernels/csrc/packed.cu",
                    "tpu_spmv/kernels/spmm.py:183",
                    "lap2d_1024 rcm spmm_ranked B=8"),
    "spmm_packed": ("tpu_spmv_torch/kernels/csrc/packed.cu",
                    "tpu_spmv/kernels/spmm.py:691",
                    "lap2d_1024 rcm spmm_packed B=8"),
    "lower_solve_ranked": ("tpu_spmv_torch/kernels/csrc/sts.cu",
                           "tpu_spmv/sts/solve.py:369",
                           "lap2d_1024 LS ranked"),
    "lower_solve_blocks": ("tpu_spmv_torch/kernels/csrc/sts.cu",
                           "tpu_spmv/sts/solve.py:450",
                           "lap2d_1024 LS blocks"),
    "spmv_dia_windowed": ("tpu_spmv_torch/kernels/csrc/windowed.cu",
                          "tpu_spmv/kernels/dia.py:244",
                          "lap2d_4096 dia_windowed f32"),
    "spmv_ranked_windowed": ("tpu_spmv_torch/kernels/csrc/windowed.cu",
                             "tpu_spmv/kernels/pallas_sell.py:706",
                             "lap2d_4096 rcm ranked_windowed"),
    "spmm_ranked_windowed": ("tpu_spmv_torch/kernels/csrc/windowed.cu",
                             "tpu_spmv/kernels/spmm.py:391",
                             "lap2d_1024 rcm spmm_ranked_windowed B=5"),
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

    t_start = time.perf_counter()
    smi = hw.nvidia_smi()
    print(f"nvidia-smi: {smi}")
    tc = hw.toolchain()
    print(f"torch {tc['torch']} | CUDA {tc['cuda']} | nvcc {tc['nvcc']} | "
          f"triton present: {tc['triton']}")
    info = _build.build(verbose=True, force=True)
    print(f"kernel build (one nvcc per source, in parallel, then one link): "
          f"{info.seconds:.1f} s -> {info.path.name}")
    for line in _ptxas_summary(info.log):
        print(f"  ptxas: {line}")
    from tpu_spmv_torch.reorder import native

    t0 = time.perf_counter()
    if not native.available():
        print(f"chip_smoke: FAILED: the C++ host core did not build "
              f"({native.load_error()})", file=sys.stderr)
        return 1
    print(f"host core (reorder/csrc/reorder.cc) ready in "
          f"{time.perf_counter() - t0:.1f} s -> {native._LIB_PATH.name}")
    print(f"device: {hw.device_spec()}", flush=True)

    stats = {}
    try:
        t0 = time.perf_counter()
        r_times = _phases(stats)
        print(f"kernel phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _windowed_phases(stats)
        print(f"windowed phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _plans(r_times)
        print(f"plans: wall {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        _solve_phases(stats)
        print(f"solve phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _ic0_phases()
        print(f"ic0 phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        counts = _main_path()
        print(f"CLI runs: wall {time.perf_counter() - t0:.1f} s", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        print("chip_smoke: FAILED: jax was imported", file=sys.stderr)
        return 1

    kernels = []
    for name, (source, replaces, main_phase) in _KERNELS.items():
        rows = stats[name]
        at = next(r for r in rows if r["label"].startswith(main_phase))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=max(r["err"] for r in rows),
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], library_ms=at["library_ms"],
        ))
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
