"""Smoke run of the PyTorch + CUDA port (tpu_spmv_torch) on one card.

Run from the root of the repository, on a machine with one CUDA card:

    python chip_smoke.py

It builds the port's CUDA kernels from tpu_spmv_torch/kernels/csrc/ and
its C++ host core from tpu_spmv_torch/reorder/csrc/ (it fails unless the
core builds), then, at the main paths' real sizes (lap2d_1024: 1.05M
rows, 5.2M nnz; varstencil_1024; banded_1m: 1M rows, 16.9M nnz;
lap3d_101: 1.03M rows, 7.2M nnz; lap2d_4096: 16.8M rows, 83.9M nnz, and
scattered_16m: 131,072 x 16,777,216, 21.0M nnz, whose x is past the L2
residency gate):

  1. checks each kernel against its plain PyTorch version on the card
     (max |kernel - plain| <= 1e-5 * max(1, max |plain|): both sum in
     f32, in different orders and with or without fused multiply-add),
     validates it against the serial CSR oracle (Number Wrong 0 at the
     magnitude-aware 0.01 tolerance, RelL2 <= 1e-6, every column of an
     SpMM; bf16 layouts against the bf16-rounded operator), and times
     kernel and plain version in the warm regime (one operator, which
     may stay in L2) and the kernel in the cold one (operator copies
     rotated, >= 4x L2 in all), beside its bound (layout, x and y moved once at the HBM
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
     at B = 8 on both); scattered_16m goes through spmv_striped, the
     column-striped passes of spmv_ranked's walk (the bin width W picked
     on a row sample as bench/scattered_16m.py picks it), at
     default_stripe_cols with f32 and with bf16 stripes, each phase held
     to its plain version, the oracle (the bf16-rounded one for bf16)
     and two graph replays, with a line on the stripes (padding, split
     chunks, launches per call), the bound of this design (y moved 2P - 1
     times) and the host set-up seconds, then both timed in turns (f32,
     bf16, bf16, f32); its rows count as spmv_ranked's;
  2. runs the planner's calibration (tools.tune's protocol, through
     bench/calibration.py) on the card at CALIB_SCALE, printing its
     points and fit, then tools.tune --calibrate --dry-run itself at its
     default scale (its launches join step 6's), and prints both fits,
     each constant's ratio between them, the shipped entry for this card
     (or a line saying there is none and the planner runs on its module
     defaults) and the decisions each gives, and the entry of the old
     unit (OLD_UNIT_ENTRY) too: the kernel on
     lap2d_1024 after RCM (D1) and banded_1m (D2), the bin width on
     scattered_16m (D3), banded_1m's sigma = 4096 sort kept or rejected
     (D4), the solve kernel on banded_1m LS and lap2d_1024 LS (D5) and
     the value dtype tools.spmv --val-dtype bf16 stores on
     scattered_16m's stripes (D6, kernels/striped.bf16_pays); then
     prints tune/model.tpu_plan's plan (kernel, W, sigma, cost,
     reason) for lap2d_1024 in natural order (which must plan dia) and
     after RCM, banded_1m, general_500k and scattered_16m, and D1-D6
     under the shipped and the old-unit entry, each as the planned choice, the
     fastest choice timed in this run, both warm times and planned /
     fastest (the kernel and striped phases' times, spmv_striped at W =
     32 too, the sorted banded_1m layout of its re-plan, step 3's solve
     times, the striped phase's f32 and bf16 times in turns); this step
     runs after step 3;
  3. checks both triangular-solve kernels (lower_solve_ranked and
     lower_solve_blocks) against their plain versions (RelL2 <= 1e-5)
     and a float64 forward substitution (RelL2 <= 1e-5, Number Wrong 0
     at 0.01 for x = ones), and times them warm and cold (the plain
     versions, a host loop over the packs, by their checking call),
     first on the
     bidiagonal chain of 4096 rows (4096 chunks, each reading only the
     one before: the least a dependency level costs, printed as us per
     link), then on lap2d_1024 in level (LS) and COLOR order, lap3d_101
     LS and banded_1m LS (the column-binned rank windows, and its blocks
     solve); it prints which kernel lower_solve runs on each, the
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
  5. runs the distributed layer (tpu_spmv_torch.dist) with D shards on
     the one card, each on its own streams, on lap2d_1024 after RCM:
     spmv_sharded over ShardedRanked at D = 1 (bit for bit spmv_ranked
     on its one shard), 2 and 4 (the halo exchange), 4 with x gathered
     whole, over ShardedSell at D = 4, spmv_overlap at D = 4 (the edge's
     share of nnz printed), spmm_sharded at B = 8 on D = 1 (X past the
     gate: windowed) and D = 4 (resident), spmm_overlap at B = 8, D = 4;
     each held to the same call through the kernels' plain versions and
     to the oracle, its launches checked (one a shard, two with the
     overlap), its warm time from a CUDA graph printed beside the
     single-device kernel's from step 1 and its bound (the layout, the x
     windows, y and the halo rows once at the HBM rate);
  5b. runs the sharded triangular solve (dist/sts.py) with D shards on
     the one card on lap2d_1024 LS at D = 1, 2 and 4: sts_solve_sharded
     against the same solve through the kernels' plain versions and the
     float64 substitution (RelL2 <= 1e-5, Number Wrong 0 for x = ones,
     padding rows 0, a fresh b too), its launches (D of spmv_sell and of
     lower_solve_blocks), two graph replays at D > 1, its warm time from
     a CUDA graph beside the single-device lower_solve_blocks of step 3
     and its bound (bytes; and the floor of this design, the shards'
     chunk depths times step 3's us per link); first a line gives
     spmv_ranked's bytes a nonzero on lap2d_1024 RCM (hw.
     SPMV_BYTES_PER_NNZ); then on lap3d_101 at D = 4 both distributed
     IC(0) preconditioners (exact, two chains an application, and
     block-Jacobi): apply against its plain version, apply's warm time,
     one captured PCG iteration in us and the RMS residual by iteration
     beside step 4's single-device trace, below PCG_TOL at 100;
  5c. runs the distributed layer across processes (bench/multiproc.py,
     started once the kernels are built, within MULTIPROC_WALL_S): 2
     processes x 2 shards on the one card over gloo (4 x 1, a card
     each, over NCCL on a machine of 4 cards or more), spmv_sharded,
     spmv_overlap and spmm_sharded at B = 8 on lap2d_1024 RCM, cg_solve
     on lap3d_101 for DIST_ITERS, sts_solve_sharded on lap2d_1024 LS and
     exact and block-Jacobi IC(0)-PCG on lap3d_101 for PCG_ITERS; each
     process holds its paths to their plain versions and times them
     (eager us a call or an iteration, printed per process); each
     process's rows are held to the oracle and to the one-process D = 4
     call's bits; its launches (spmv_ranked, spmv_sell, spmm_ranked and
     lower_solve_blocks, each at least once) join the kernels line
     (`python chip_smoke.py --multiproc-only` runs this phase alone);
  6. drives each main path with every launch counter zeroed just before
     and read just after: the SpMV/SpMM CLIs (tools.spmv, tools.spmm on
     lap2d_1024 and banded_1m, and on the windowed routes: tools.spmv on
     lap2d_4096, natural and --kernel ranked after RCM, tools.spmm on
     lap2d_1024 at B = 8 and --kernel windowed), the solve CLIs
     (tools.sts on lap2d_1024 LS, COLOR and k=3 and lap3d_101 --part
     upper; tools.solve --precond ic0 on lap3d_101), the library's
     lower_solve with ranked=False, the baselines (tools.spmv
     --kernel segsum and bcoo on lap2d_1024, dense on an 8,192 x 8,192
     matrix at its cap and refused on lap2d_1024) and the flagship bench
     (bench.flagship, whose JSON line must parse with value > 0); then
     the paths of the planner and the host tools: tools.spmv --kernel
     auto on scattered_16m without --bin-blocks (the plan's W must take
     the striped route, which must print "column-striped passes"), and
     again with --val-dtype bf16 (under the shipped entry it must store
     bf16 stripes and validate them against the bf16-rounded operator),
     --sigma -1 on powerlaw_1m and --sigma 4096 on
     banded_1m, --layout-cache on lap2d_4096 after RCM twice (the
     windowed ranked run above writes the cache; the second run must
     load it and give the first run's bits), tools.sweep over
     lap2d_256 and banded_100k x auto, ranked and sell (its CSV
     printed), and step 2's tools.tune --calibrate --dry-run; and the
     distributed paths: tools.solve plain CG and --pcg on lap3d_101 with
     --devices 1 (--tol DIST_TOL), cg_solve's captured iteration over 4
     shards (the residual at a quarter, half and all of DIST_ITERS),
     tools.spmm --devices 0 at B = 8 and one call of each sharded entry
     point on step 5's D = 4 layouts; and the CLIs' D > 1 solve paths
     through the functions they call, 4 shards on the card
     (tools.sts.sharded on lap2d_1024 LS, tools.solve.ic0_sharded ic0 and
     ic0-bj on lap3d_101), with tools.sts --devices 4 and tools.solve
     --precond ic0 --devices 4 themselves on a machine of 4 cards;
     it fails unless every kernel was launched on its path.

It prints the card (nvidia-smi name and power limit), the toolchain, the
build time and ptxas's register/spill report, one line per phase, a JSON
line with each kernel's launches, error and times, and last
{"ok": true, "device": {...}}. Any failure exits non-zero without that
last line, as does a machine without a CUDA card or a directory without
the port's package.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# tools.solve plain CG and Jacobi-PCG on lap3d_101 (Jacobi on a constant
# diagonal is CG), and cg_solve over 4 shards: iterations and the RMS
# residual bound they must meet. Plain CG in f32 levels off there at
# ~4.9e-4 (H100: 6.2e-2 at 100 iterations, 4.9e-4 to 5.1e-4 from 200 to
# 1,600), the level of IC(0)-PCG's floor, so the bound is 1e-3.
DIST_ITERS = 400
DIST_TOL = 1e-3
# The multiproc phase's wall limit: a process that hangs in a collective
# (or fails while the others wait in one) ends the phase here.
MULTIPROC_WALL_S = 300
# The calibration phase's sample scale (tools.tune --scale): the second
# scale, beside tools.tune's default (tools/tune.CALIB_SCALE), at which
# every sample takes 50 us or more on an H100 too.
CALIB_SCALE = 12.0
# The H100 entry the planner ran on before the card's unit (the first
# calibration protocol, in the reference's unit): the decisions it gives
# are the previous release's, printed beside the shipped entry's.
OLD_UNIT_ENTRY = {"ranked_fixed": 25.305, "pair_cost": 2.146,
                "ranked_iter_cost": 2.146, "packed_over": 5.754,
                "epi_cost": 0.0}
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
    """The matrix as a torch CSR tensor on the card (int32 indices): the
    bcoo baseline's layout (kernels/bcoo.py)."""
    from tpu_spmv_torch.kernels.bcoo import BCOOLayout

    return BCOOLayout.from_csr(csr, device=dev).mat


def _time_library(csr, xt, nnz):
    """Warm TimeMin (s) of one PyTorch call computing the same product
    on the same reordered matrix and x: the bcoo baseline (kernels/
    bcoo.spmv_bcoo, the call `tools.spmv --kernel bcoo` times), a CSR
    tensor times x (n,) or X (n, B), which PyTorch runs through cuSPARSE
    (SpMV / SpMM), timed from a CUDA graph like the kernels."""
    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.kernels.bcoo import BCOOLayout, spmv_bcoo

    return bench_spmv(spmv_bcoo, BCOOLayout.from_csr(csr, device=xt.device),
                      xt, nnz=nnz).time_min


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
    # Kernel and plain version in turns warm, then the kernel cold (the
    # plain version's cold time is left out to keep the run inside its
    # time), then the kernel's eager (host-launched) warm time.
    for name, fn in (("kernel", kernel), ("plain", plain)):
        t[name, "warm"] = bench_spmv(fn, lay, xt, nnz=nnz)
    t["kernel", "cold"] = bench_spmv_cold(
        kernel, lay.clone, xt, nnz=nnz, layout_bytes=lbytes)
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
    w, c = kw, kc
    print(
        f"    kernel TimeMin/TimeAvg us (CUDA graph): warm "
        f"{us(w.time_min)}/{us(w.time_avg)}, cold "
        f"{us(c.time_min)}/{us(c.time_avg)} | GF/s warm "
        f"{w.gflops:.1f}, cold {c.gflops:.1f} | layout bytes at "
        f"{100 * lbytes / w.time_min / bw:.0f}% (warm, L2 may hold "
        f"them) / {100 * lbytes / c.time_avg / bw:.0f}% (cold) of "
        f"{bw / 1e12:.2f} TB/s",
        flush=True,
    )
    w = t["plain", "warm"]
    print(f"    plain  TimeMin/TimeAvg us (CUDA graph): warm "
          f"{us(w.time_min)}/{us(w.time_avg)}, cold not measured | GF/s "
          f"warm {w.gflops:.1f}", flush=True)
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

    dev = torch.device("cuda")
    lay = layout.to(dev)
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(X_SEED).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x[perm]).to(dev)
    _replay_check(label, kernel.__name__, lambda: kernel(lay, xt))


def _phases(stats):
    """The DIA, ranked and sell phases, then the packed and SpMM phases.
    Returns the warm times of the SpMV layouts the planner weighs on
    lap2d_1024 after RCM and banded_1m, by (matrix, kernel, W), and
    those two matrices as the layouts were built from them, by name."""
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
    from tpu_spmv_torch.tune.model import tpu_plan

    bf16 = torch.bfloat16
    for name in ("lap2d_1024", "varstencil_1024"):
        mat = load_input(f"synthetic:{name}")
        plan = tpu_plan(mat)
        if plan.kernel != "dia":
            raise SmokeFailure(f"{name}: auto planned {plan.kernel}, not dia")
        ck, perm = prepare(mat, "auto")
        for vdt, oracle in ((None, mat), (bf16, mat.rounded())):
            lay = DiaSlabs.from_csr(ck.matrix, val_dtype=vdt)
            tag = "bf16" if vdt else "f32"
            _check_kernel(f"{name} dia {tag}", spmv_dia, spmv_dia_reference,
                          lay, mat, perm, oracle, stats,
                          csr=None if vdt else ck.matrix)

    # Warm times of the layouts the planner weighs: (matrix, kernel, W).
    times = {}
    mat = load_input("synthetic:lap2d_1024")
    ck, perm = prepare(mat, "always")
    times["lap2d_1024 rcm"] = ck.matrix  # the matrix the plans phase plans
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
            times["lap2d_1024 rcm", "ranked", 0] = t
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
    times["lap2d_1024 rcm", "sell", 0] = _check_kernel(
        "lap2d_1024 rcm sell", spmv_sell, spmv_sell_reference, sell, mat,
        perm, mat, stats, csr=ck.matrix)
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
            times["lap2d_1024 rcm", "packed", 0] = t
    lap_layouts = (RankedSlabs.from_csr(ck.matrix),
                   PackedRanked.from_csr(ck.matrix))
    for B in (8, 5):
        _ranked_runs(f"lap2d_1024 rcm spmm_ranked B={B}", lap_layouts[0], B)
        _check_kernel(f"lap2d_1024 rcm spmm_ranked B={B}", spmm_ranked,
                      spmm_ranked_reference, lap_layouts[0], mat, perm, mat,
                      stats, batch=B, csr=ck.matrix)
        _check_kernel(f"lap2d_1024 rcm spmm_packed B={B}", spmm_packed,
                      spmm_packed_reference, lap_layouts[1], mat, perm, mat,
                      stats, batch=B, csr=ck.matrix)
    _spmv_replay_check("lap2d_1024 rcm packed", spmv_packed, lap_layouts[1],
                       mat, perm)
    _spmv_replay_check("lap2d_1024 rcm spmm_packed B=8", spmm_packed,
                       lap_layouts[1], mat, perm, batch=8)
    _spmv_replay_check("lap2d_1024 rcm spmm_ranked B=8", spmm_ranked,
                       lap_layouts[0], mat, perm, batch=8)
    del lap_layouts

    mat = load_input("synthetic:banded_1m")
    ck, perm = prepare(mat, "auto")
    times["banded_1m"] = ck.matrix
    ranked = RankedSlabs.from_csr(ck.matrix)
    _segments(f"banded_1m ranked grouped G={ranked.num_groups}", ranked)
    times["banded_1m", "ranked", 0] = _check_kernel(
        "banded_1m ranked", spmv_ranked, spmv_ranked_reference, ranked, mat,
        perm, mat, stats, csr=ck.matrix)
    _spmv_replay_check("banded_1m ranked", spmv_ranked, ranked, mat, perm)
    sell = SellSlabs.from_csr(ck.matrix)
    _segments("banded_1m sell", sell)
    times["banded_1m", "sell", 0] = _check_kernel(
        "banded_1m sell", spmv_sell, spmv_sell_reference, sell, mat, perm,
        mat, stats, csr=ck.matrix)
    _spmv_replay_check("banded_1m sell", spmv_sell, sell, mat, perm)
    del sell
    packed = PackedRanked.from_csr(ck.matrix)
    _segments(f"banded_1m packed grouped G={packed.num_groups}", packed)
    times["banded_1m", "packed", 0] = _check_kernel(
        "banded_1m packed", spmv_packed, spmv_packed_reference, packed, mat,
        perm, mat, stats, csr=ck.matrix)
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
    times["banded_1m", "packed", w] = _check_kernel(
        f"banded_1m packed binned W={w}", spmv_packed, spmv_packed_reference,
        binned, mat, perm, mat, stats)
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
    return times


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


def _striped_phases(stats, times):
    """scattered_16m (131,072 x 16,777,216, 160 a row, 21.0M nnz; x 64 MB,
    past half the L2) through spmv_striped, the column-striped passes of
    spmv_ranked's walk, at default_stripe_cols with f32 and with bf16
    stripes: kernel against plain, the oracle (bf16: the bf16-rounded
    operator), warm and cold times, the library call (cuSPARSE on the
    operator the stripes store) and two graph replays. W is picked on a
    row sample as bench/scattered_16m.py picks it. Prints each layout's
    stripes, bins, padding, split chunks and launches per call, the bound
    of this design (layout and x once, y 2P - 1 times) and the host
    set-up seconds; then times both layouts in turns (f32, bf16, bf16,
    f32). The rows count as spmv_ranked's; the f32 layout's warm time
    goes to times under ("scattered_16m", "ranked", W), the least of each
    dtype's turns under "scattered_16m dtype" (D6). Returns W."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.kernels.sell import partial_rows

    from tpu_spmv_torch.bench.scattered_16m import pick_bin_blocks
    from tpu_spmv_torch.kernels.striped import (
        StripedRanked, default_stripe_cols, spmv_striped,
        spmv_striped_reference,
    )
    from tpu_spmv_torch.tools.spmv import load_input
    from tpu_spmv_torch.tune.model import _packed_x_fits

    dev = torch.device("cuda")
    setup = {}
    t0 = time.perf_counter()
    mat = load_input("synthetic:scattered_16m")
    setup["generate"] = time.perf_counter() - t0
    if _packed_x_fits(mat, 1):
        raise SmokeFailure("scattered_16m: x passes the residency gate")
    t0 = time.perf_counter()
    w, sample_pad = pick_bin_blocks(mat)
    setup["W choice"] = time.perf_counter() - t0
    sc = default_stripe_cols(dev)
    layouts = {}
    for name, vdt in (("f32", None), ("bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        oracle = mat if vdt is None else mat.rounded()
        lay = StripedRanked.from_csr(mat, stripe_cols=sc, bin_blocks=w,
                                     val_dtype=vdt, device=dev)
        torch.cuda.synchronize()
        setup[f"{name} build"] = time.perf_counter() - t0
        P = lay.num_stripes
        splits = [s.split_seg.shape[1] for s in lay.stripes]
        part_bytes = sum(partial_rows(s) for s in lay.stripes) * 128 * 4
        label = f"scattered_16m striped W={w} P={P} {name}"
        print(f"    [{label}] stripes of {sc} columns, x "
              f"{4 * mat.n / 2**20:.1f} MB; W={w} (sample padding "
              f"{sample_pad:.2f}x), padding {lay.padding_ratio:.2f}x, rank_nb "
              f"{lay.rank_nb}, values {str(lay.val_dtype)[6:]}, lcols "
              f"{[str(s.lcols.dtype)[6:] for s in lay.stripes]}, "
              f"split chunks by stripe {splits} (partial rows "
              f"{part_bytes / 2**20:.1f} MB in all); device launches per "
              f"call {P + sum(k > 0 for k in splits)} (spmv_ranked calls "
              f"{P})", flush=True)
        t = _check_kernel(label, spmv_striped, spmv_striped_reference, lay,
                          mat, slice(None), oracle, stats, csr=oracle)
        if vdt is None:
            times["scattered_16m", "ranked", w] = t
        row = stats["spmv_striped"][-1]
        design_ms, _ = _bound(lay.nbytes + 4 * mat.n + 4 * mat.m * (2 * P - 1),
                              2 * mat.nnz)
        split_ms, _ = _bound(lay.nbytes + 4 * mat.n + 4 * mat.m * (2 * P - 1)
                             + 2 * part_bytes, 2 * mat.nnz)
        print(f"    bound of this design (layout + x once, y {2 * P - 1} "
              f"times) {design_ms * 1e3:.2f} us, {split_ms * 1e3:.2f} with "
              f"the partial rows written and read once | loss: "
              f"{row['ms'] / design_ms:.2f}x this bound, "
              f"{row['ms'] / row['bound_ms']:.2f}x the bound, "
              f"{row['ms'] / row['library_ms']:.2f}x the library call",
              flush=True)
        _spmv_replay_check(label, spmv_striped, lay, mat, slice(None))
        layouts[name] = lay
        del oracle
    x = torch.from_numpy(np.random.default_rng(X_SEED).standard_normal(
        mat.n).astype(np.float32)).to(dev)
    turns = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        turns[name].append(bench_spmv(spmv_striped, layouts[name], x,
                                      nnz=mat.nnz).time_min)
    best = {k: min(v) for k, v in turns.items()}
    times["scattered_16m dtype"] = best
    print(f"    [scattered_16m striped W={w}] in turns (f32, bf16, bf16, "
          f"f32), warm TimeMin us: f32 " + "/".join(
              f"{t * 1e6:.2f}" for t in turns["f32"]) + ", bf16 " + "/".join(
              f"{t * 1e6:.2f}" for t in turns["bf16"])
          + f"; bf16 / f32 {best['bf16'] / best['f32']:.4f}", flush=True)
    del layouts, x
    print("scattered_16m host set-up s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in setup.items()), flush=True)
    stats.setdefault("spmv_ranked", []).extend(stats.pop("spmv_striped"))
    return w


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
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    xp = plain(slabs, bs, steps)
    torch.cuda.synchronize()
    # The plain version's time: this one call, the check's (a host loop
    # over the packs, seconds a solve on the largest systems).
    p_warm = time.perf_counter() - t_plain
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

    if replay:
        _replay_check(label, kernel.__name__, lambda: kernel(slabs, bs))
    t0 = time.perf_counter()
    warm = bench_spmv(kfn, slabs, bflat, nnz=nnz)
    cold = bench_spmv_cold(kfn, slabs.clone, bflat, nnz=nnz,
                           layout_bytes=slabs.nbytes)
    eager = bench_spmv(kfn, slabs, bflat, nnz=nnz, graph=False, samples=3)
    k = cold.iters[2]
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
    print(f"    plain  us per solve (eager host loop over the packs, the "
          f"checking call): {us(p_warm)}, cold not measured | bound by bytes "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), {depth_txt} | timing wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats.setdefault(kernel.__name__, []).append(
        dict(label=label, err=err, ms=warm.time_min * 1e3,
             plain_ms=p_warm * 1e3, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=library_s * 1e3)
    )
    return lay, warm.time_min


def _chain_arrays(slabs):
    """What sts/solve.solve_cost reads of a solve layout, on the host."""
    import types

    return types.SimpleNamespace(
        chunk_ptr=slabs.chunk_ptr.cpu(), wait_ptr=slabs.wait_ptr.cpu(),
        wait_chunk=slabs.wait_chunk.cpu())


def _solve_shape(label, lay):
    """One line: the kernel lower_solve runs on the layout (sts/solve.
    solve_choice) and, for each solve layout, what its cost reads:
    sub-tiles a chunk, the chunk depth, the most rounds of SOLVE_GROUP
    sub-tiles on one chain of chunks and the cost under the card's
    entry in us (solve_cost through unit_ns)."""
    import numpy as np

    from tpu_spmv_torch.sts.solve import solve_constants, solve_cost
    from tpu_spmv_torch.tune.model import _cal

    consts, unit = solve_constants(), _cal("unit_ns", 0.0) * 1e-3
    parts = []
    for kernel, sl in (("ranked", lay.ranked), ("blocks", lay.slabs)):
        sub = np.diff(sl.chunk_ptr.cpu().numpy().astype(np.int64))
        cost = ("" if consts is None or not unit else
                f", cost {unit * solve_cost(sl, *consts[kernel]):.2f} us")
        parts.append(f"{kernel}: sub-tiles a chunk median "
                     f"{int(np.median(sub))} max {int(sub.max())}, chunk "
                     f"depth {solve_cost(sl, 1.0, 0.0):.0f}, most rounds on "
                     f"a chain {solve_cost(sl, 0.0, 1.0):.0f}{cost}")
    print(f"    [{label}] lower_solve runs {lay.kernel} (sts/solve."
          f"solve_choice) | " + " | ".join(parts), flush=True)


def _solve_phases(stats, solves):
    """Both solve kernels at full size, on the schedules users run, after
    the bidiagonal chain that measures a link. Fills solves["NAME ORDER"]
    with each kernel's warm seconds, the kernel lower_solve chooses and
    the chains it chose on. Returns each kernel's us per link on the
    chain."""
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
        ("banded_1m", "LS", (True, False)),
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
            lay, t = _check_solve(label, sys_, b, ranked, stats, setup,
                                  library_s, link_us,
                                  replay=(name, order) == ("lap2d_1024", "LS"))
            if ranked and lay.ranked is None:
                raise SmokeFailure(f"{label}: no rank-windowed layout built")
            rec = solves.setdefault(f"{name} {order}", {})
            rec["ranked" if ranked else "blocks"] = t
            if ranked:
                # The choice under the card's calibration, and what
                # sts/solve.solve_choice reads to make it under another.
                rec["choice"] = lay.kernel
                rec["chains"] = tuple(_chain_arrays(sl) for sl in (
                    lay.slabs, lay.ranked))
                _solve_shape(f"{name} {order}", lay)
            if name == "banded_1m" and ranked:
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
    return link_us


def _ic0_phases():
    """IC(0) apply, kernel vs plain, and one graph-captured PCG iteration
    on lap3d_101 and lap2d_1024; the residual as lap3d_101 converges.
    Returns lap3d_101's residual trace."""
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
            lap3d_trace = " ".join(trace)
        del pre, lay, graph, state
    return lap3d_trace


def _dist_bound(lay, batch):
    """(bound_ms, bound_by) of one sharded call: the layout's tensors,
    the x windows its kernels read, y and the halo rows the exchange
    moves, each once at the HBM rate; 2 * nnz * B operations."""
    from tpu_spmv_torch.dist.sharding import OverlapRanked

    D, H, R = lay.n_devices, lay.halo, lay.rows_per_shard
    window = R + 2 * H if (H or isinstance(lay, OverlapRanked)) else lay.n
    nbytes = lay.nbytes + 4 * batch * (D * window + lay.padded_m
                                       + 2 * (D - 1) * H)
    return _bound(nbytes, 2 * lay.nnz * batch)


def _dist_check(label, call, kernel, lay, mesh, mat, perm, stats,
                single=None, batch=None, twin=None):
    """One sharded call on the card: kernels against the same call
    through their plain versions (PLAIN_TOL), the oracle (Number Wrong 0,
    RelL2 <= L2_TOL), the kernel's launches (one per shard, two with the
    overlap's edge), warm TimeMin/TimeAvg from a CUDA graph beside the
    single-device kernel's (`single`: (name, seconds) or None) and the
    call's bound. mat: the matrix in its original order (the oracle);
    the layout was built from mat permuted by perm. twin: a callable
    whose result must equal the sharded result bit for bit. Appends the
    error to stats[kernel name]; returns the warm TimeMin in seconds."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist.sharding import (
        OverlapRanked, gather_vector, shard_vector,
    )

    t0 = time.perf_counter()
    shape = (mat.n,) if batch is None else (mat.n, batch)
    x = np.random.default_rng(X_SEED).standard_normal(shape).astype(np.float32)
    xs = shard_vector(x[perm], mesh, lay.padded_m)
    before = kernel.launches
    yk = call(lay, xs, mesh)
    torch.cuda.synchronize()
    delta = kernel.launches - before
    yp = call(lay, xs, mesh, plain=True)
    yk_h, yp_h = gather_vector(yk)[: mat.m], gather_vector(yp)[: mat.m]
    err = float(np.abs(yk_h - yp_h).max())
    scale = max(1.0, float(np.abs(yp_h).max()))
    wrong, rel = _validate_columns(yk_h, x, mat, perm)
    D = lay.n_devices
    want = D * (2 if isinstance(lay, OverlapRanked) else 1)
    if delta != want:
        raise SmokeFailure(f"{label}: {kernel.__name__} launched {delta} "
                           f"times, not {want}")
    if not err <= PLAIN_TOL * scale:
        raise SmokeFailure(f"{label}: kernels differ from plain by {err:.3g}")
    if wrong != 0 or not rel <= L2_TOL:
        raise SmokeFailure(f"{label}: Number Wrong {wrong}, RelL2 {rel:.3g}")
    if twin is not None and not np.array_equal(yk_h, twin()[: mat.m]):
        raise SmokeFailure(f"{label}: not bit for bit the single-device "
                           "kernel's result")
    B = 1 if batch is None else batch
    warm = bench_spmv(lambda lay_, _x: call(lay_, xs, mesh), lay, xs[0],
                      nnz=mat.nnz)
    bound_ms, bound_by = _dist_bound(lay, B)
    single_txt = "not timed" if single is None else (
        f"{single[0]} {single[1] * 1e6:.2f} us, sharded / single "
        f"{warm.time_min / single[1]:.2f}")
    print(f"[{label}] D={D} halo={lay.halo} rows/shard={lay.rows_per_shard}"
          f": {kernel.__name__} launches +{delta}, max|kernel-plain| "
          f"{err:.3g}, Number Wrong {wrong}, RelL2 {rel:.3g}"
          + (", same bits as the single-device kernel" if twin else ""),
          flush=True)
    print(f"    warm TimeMin/TimeAvg us (CUDA graph): "
          f"{warm.time_min * 1e6:.2f}/{warm.time_avg * 1e6:.2f} | single "
          f"device: {single_txt} | bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}: layout {lay.nbytes / 2**20:.1f} MB + x windows + y "
          f"+ halo once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{warm.time_min * 1e3 / bound_ms:.2f}x | phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats.setdefault(kernel.__name__, []).append(
        dict(label=f"dist {label}", err=err))
    return warm.time_min


def _single_ms(stats, kernel, label):
    """(label, seconds) of an earlier phase's warm TimeMin, or None."""
    rows = [r for r in stats.get(kernel, ()) if r["label"].startswith(label)
            and "ms" in r]
    return (label, rows[0]["ms"] / 1e3) if rows else None


def _dist_phases(stats):
    """The distributed layer on lap2d_1024 after RCM (1,048,576 rows),
    D shards on the one card: spmv_sharded with ShardedRanked at D = 1
    (the bits of spmv_ranked on its shard), 2 and 4 (halo), 4 with
    halo="never" (x gathered whole), ShardedSell at D = 4, spmv_overlap at
    D = 4 (the edge's share of nnz printed), spmm_sharded at B = 8 and D =
    1 (X past the residency gate: windowed) and D = 4 (resident), and
    spmm_overlap at B = 8, D = 4; each held by _dist_check. Returns the
    D = 4 layouts and the mesh, for the main path's run."""
    import torch

    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.kernels import sell, spmm
    from tpu_spmv_torch.kernels.sell import resident_x_fits
    from tpu_spmv_torch.tools.spmv import load_input, prepare

    dev = torch.device("cuda")
    mat = load_input("synthetic:lap2d_1024")
    ck, perm = prepare(mat, "always")
    a = ck.matrix  # the layouts' rows; mat (original order) is the oracle
    ranked_single = _single_ms(stats, "spmv_ranked",
                               "lap2d_1024 rcm ranked grouped")
    keep = {}
    for D, halo in ((1, "auto"), (2, "auto"), (4, "auto"), (4, "never")):
        t0 = time.perf_counter()
        mesh = dsh.make_row_mesh([dev] * D)
        lay = dsh.ShardedRanked.build(a, D, halo=halo).device_put(mesh)
        build_s = time.perf_counter() - t0
        twin = None
        if D == 1:
            if lay.halo or lay.shard_n != a.n:
                raise SmokeFailure("D=1: a halo or a window past n")

            def twin(lay=lay, mesh=mesh):
                import numpy as np

                x = np.random.default_rng(X_SEED).standard_normal(
                    a.n).astype(np.float32)[perm]
                return sell.spmv_ranked(
                    lay.shards[0], torch.from_numpy(x).to(dev)).cpu().numpy()
        label = f"lap2d_1024 rcm spmv_sharded ranked halo={halo}"
        print(f"    [{label} D={D}] host build {build_s:.2f} s", flush=True)
        _dist_check(label, dsh.spmv_sharded, sell.spmv_ranked, lay, mesh, mat,
                    perm, stats, ranked_single, twin=twin)
        if D == 1:
            B = 8
            if resident_x_fits(lay.shards[0], batch=B):
                raise SmokeFailure("D=1 B=8: X passes the residency gate")
            _dist_check(f"lap2d_1024 rcm spmm_sharded B={B} (windowed)",
                        dsh.spmm_sharded, spmm.spmm_ranked_windowed, lay,
                        mesh, mat, perm, stats,
                        _single_ms(stats, "spmm_ranked_windowed",
                                   "lap2d_1024 rcm spmm_ranked_windowed B=8"),
                        batch=B)
        if D == 4 and halo == "auto":
            if not all(resident_x_fits(s, batch=8) for s in lay.shards):
                raise SmokeFailure("D=4 B=8: X fails the residency gate")
            _dist_check("lap2d_1024 rcm spmm_sharded B=8 (resident)",
                        dsh.spmm_sharded, spmm.spmm_ranked, lay, mesh, mat,
                        perm, stats, _single_ms(
                            stats, "spmm_ranked",
                            "lap2d_1024 rcm spmm_ranked B=8"), batch=8)
            keep["ranked"], keep["mesh"] = lay, mesh
        del lay
    mesh = keep["mesh"]
    sell_lay = dsh.ShardedSell.build(a, 4).device_put(mesh)
    _dist_check("lap2d_1024 rcm spmv_sharded sell", dsh.spmv_sharded,
                sell.spmv_sell, sell_lay, mesh, mat, perm, stats,
                _single_ms(stats, "spmv_sell", "lap2d_1024 rcm sell"))
    keep["sell"] = sell_lay
    over = dsh.OverlapRanked.build(a, 4).device_put(mesh)
    print(f"    [lap2d_1024 rcm overlap D=4] edge nnz {over.edge.nnz} of "
          f"{over.nnz} ({100 * over.edge.nnz / over.nnz:.2f}%) waits on the "
          f"exchange; halo {over.halo}", flush=True)
    _dist_check("lap2d_1024 rcm spmv_overlap", dsh.spmv_overlap,
                sell.spmv_ranked, over, mesh, mat, perm, stats, ranked_single)
    _dist_check("lap2d_1024 rcm spmm_overlap B=8", dsh.spmm_overlap,
                spmm.spmm_ranked, over, mesh, mat, perm, stats,
                _single_ms(stats, "spmm_ranked",
                           "lap2d_1024 rcm spmm_ranked B=8"), batch=8)
    keep["overlap"] = over
    keep["matrix"], keep["perm"] = mat, perm
    return keep


def _dist_cg(iters):
    """A _drive step: cg_solve's captured iteration over 4 shards on the
    one card, on lap3d_101 in natural order (already banded), b = ones,
    replayed `iters` times: the RMS residual at a quarter, half and all
    of them (CG's level in f32 shows where it stops falling; the last
    must be below DIST_TOL) and the us per iteration."""
    def run():
        import numpy as np
        import torch

        from tpu_spmv_torch.dist import sharding as dsh
        from tpu_spmv_torch.dist import solvers
        from tpu_spmv_torch.tools.spmv import load_input

        mat = load_input("synthetic:lap3d_101")
        mesh = dsh.make_row_mesh([torch.device("cuda")] * 4)
        lay = dsh.ShardedRanked.build(mat, 4).device_put(mesh)
        b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
        state = solvers.cg_init(b, mesh)
        graph = solvers.capture_step(lay, mesh, state)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        done, ms, res = 0, 0.0, []
        for upto in (iters // 4, iters // 2, iters):
            start.record()
            for _ in range(upto - done):
                graph.replay()
            stop.record()
            stop.synchronize()
            ms += start.elapsed_time(stop)
            done = upto
            x = dsh.gather_vector(state[0])[: mat.m]
            res.append((upto, float(np.linalg.norm(mat.matvec(x) - 1.0)
                                    / np.sqrt(mat.m))))
        print(f"== cg_solve lap3d_101 over D=4 shards on one card (halo "
              f"{lay.halo}): rms_residual " + ", ".join(
                  f"{r:.3e} at {i}" for i, r in res)
              + f" iterations | {ms / iters * 1e3:.2f} us per iteration "
              "(CUDA graph)", flush=True)
        if not res[-1][1] < DIST_TOL:
            raise SmokeFailure(f"cg_solve lap3d_101 D=4: residual "
                               f"{res[-1][1]:.3e}")
    return run


def _dist_calls(keep):
    """_drive steps: one call of each sharded entry point on the dist
    phase's D = 4 layouts (ShardedSell, ShardedRanked resident SpMM, the
    overlap's SpMV and SpMM), each validated against the oracle."""
    import numpy as np

    from tpu_spmv_torch.dist import sharding as dsh

    a, perm, mesh = keep["matrix"], keep["perm"], keep["mesh"]

    def step(name, call, lay, batch=None):
        def run():
            shape = (a.n,) if batch is None else (a.n, batch)
            x = np.random.default_rng(X_SEED).standard_normal(shape).astype(
                np.float32)
            y = dsh.gather_vector(call(lay, dsh.shard_vector(
                x[perm], mesh, lay.padded_m), mesh))[: a.m]
            wrong, rel = _validate_columns(y, x, a, perm)
            print(f"== {name} lap2d_1024 rcm D=4: Number Wrong {wrong}, "
                  f"RelL2 {rel:.3g}", flush=True)
            if wrong or not rel <= L2_TOL:
                raise SmokeFailure(f"{name}: Number Wrong {wrong}, RelL2 "
                                   f"{rel:.3g}")
        return run

    return (step("spmv_sharded(ShardedSell)", dsh.spmv_sharded, keep["sell"]),
            step("spmm_sharded(B=8)", dsh.spmm_sharded, keep["ranked"], 8),
            step("spmv_overlap", dsh.spmv_overlap, keep["overlap"]),
            step("spmm_overlap(B=8)", dsh.spmm_overlap, keep["overlap"], 8))


def _wait_depth(slabs):
    """Dependency depth of a solve layout at chunk granularity, from its
    wait table: the chain the solve kernel itself walks."""
    import numpy as np

    ptr = slabs.wait_ptr.cpu().numpy()
    chunk = slabs.wait_chunk.cpu().numpy()
    depth = np.zeros(slabs.num_chunks, np.int64)
    for c in range(slabs.num_chunks):
        w = chunk[ptr[c]:ptr[c + 1]]
        depth[c] = 1 + (int(depth[w].max()) if w.size else 0)
    return int(depth.max()) if depth.size else 0


def _dist_solve(label, sys_, b, D, stats, x_ref, single, link_us):
    """sts_solve_sharded over D shards on the one card: kernels against
    the same solve through their plain versions and against the float64
    oracle x_ref (RelL2 <= SOLVE_TOL, Number Wrong 0 for x = ones,
    padding rows 0), the launches (D of spmv_sell and of
    lower_solve_blocks), a fresh b, two graph replays (D > 1), then warm
    TimeMin from a CUDA graph beside the single-device blocks solve
    (`single`: (label, seconds)) and the bound: bytes once at the HBM
    rate, and the floor of this design (the shards' chunk depths, which
    the chain runs one after the other, times the kernel's us per
    link)."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.dist.sts import ShardedLowerSolve, sts_solve_sharded
    from tpu_spmv_torch.kernels import sell, sts as ksts

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lay, pad = ShardedLowerSolve.build(sys_, b, D)
    build_s = time.perf_counter() - t0
    mesh = dsh.make_row_mesh([dev] * D)
    lay = lay.device_put(mesh)
    t0 = time.perf_counter()
    before = (sell.spmv_sell.launches, ksts.lower_solve_blocks.launches)
    xk = dsh.gather_vector(sts_solve_sharded(lay, mesh))
    delta = (sell.spmv_sell.launches - before[0],
             ksts.lower_solve_blocks.launches - before[1])
    xp = dsh.gather_vector(sts_solve_sharded(lay, mesh, plain=True))
    err = float(np.abs(xk - xp).max())
    rel_plain = float(np.linalg.norm(xk - xp) / np.linalg.norm(xp))
    x = xk[pad]
    wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
    rel = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
    padding = np.ones(lay.padded_m, bool)
    padding[pad] = False
    bp = np.zeros(lay.padded_m, np.float32)
    bp[pad] = b
    xf = dsh.gather_vector(sts_solve_sharded(
        lay, mesh, b=dsh.shard_vector(bp, mesh)))[pad]
    rel_fresh = float(np.linalg.norm(xf - x_ref) / np.linalg.norm(x_ref))
    if delta != (D, D):
        raise SmokeFailure(f"{label}: spmv_sell and lower_solve_blocks "
                           f"launched {delta} times, not {D} each")
    if not rel_plain <= SOLVE_TOL:
        raise SmokeFailure(f"{label}: kernels differ from plain, RelL2 "
                           f"{rel_plain:.3g}")
    if wrong or not rel <= SOLVE_TOL or not rel_fresh <= SOLVE_TOL:
        raise SmokeFailure(f"{label}: Number Wrong {wrong}, RelL2 {rel:.3g}"
                           f" (fresh b {rel_fresh:.3g})")
    if xk[padding].any() or xp[padding].any():
        raise SmokeFailure(f"{label}: a padding row solved to nonzero")
    if D > 1:
        _replay_check(label, "sts_solve_sharded",
                      lambda: torch.cat(sts_solve_sharded(lay, mesh)))
    warm = bench_spmv(lambda lay_, _x: sts_solve_sharded(lay_, mesh), lay,
                      lay.b_local[0], nnz=sys_.lower.nnz)
    slab_bytes = sum(s.nbytes for s in lay.diag + lay.off)
    bound_ms, bound_by = _bound(
        slab_bytes + 4 * (D * lay.b_local[0].numel() + lay.padded_m),
        2 * sys_.lower.nnz)
    depth = [_wait_depth(s) for s in lay.diag]
    link = link_us.get("lower_solve_blocks")
    floor = ("no chain link measured" if link is None else
             f"floor of this design (sum of the shards' chunk depths x own "
             f"link) {sum(depth)} x {link:.3f} us = {sum(depth) * link:.2f}"
             " us")
    single_txt = "not timed" if single is None else (
        f"{single[0]} {single[1] * 1e6:.2f} us, sharded / single "
        f"{warm.time_min / single[1]:.2f}")
    print(f"[{label}] D={D} rows/shard={lay.rows_per_shard} padded_m "
          f"{lay.padded_m}: spmv_sell +{delta[0]}, lower_solve_blocks "
          f"+{delta[1]}, RelL2 vs plain {rel_plain:.3g} (max abs {err:.3g}),"
          f" Number Wrong {wrong}, RelL2 vs f64 oracle {rel:.3g} (fresh b "
          f"{rel_fresh:.3g}), padding rows 0 | chunk depth a shard {depth}"
          f" | stacks: diagonal {lay.dvals.numel() // 128} and off-diagonal"
          f" {lay.ovals.numel() // 128} slot rows of 128 "
          f"({(lay.dvals.nbytes + lay.dcols.nbytes) / 1e6:.1f} and "
          f"{(lay.ovals.nbytes + lay.ocols.nbytes) / 1e6:.1f} MB) | host "
          f"build {build_s:.2f} s", flush=True)
    print(f"    warm TimeMin/TimeAvg us (CUDA graph): "
          f"{warm.time_min * 1e6:.2f}/{warm.time_avg * 1e6:.2f} | single "
          f"device: {single_txt} | bound by bytes {bound_ms * 1e3:.2f} us "
          f"({bound_by}), {floor} | phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stats.setdefault("lower_solve_blocks", []).append(
        dict(label=f"dist sts {label} D={D}", err=err))
    return warm.time_min


def _dist_precond(name, cls, mat, mesh, lay, trace_single):
    """One distributed IC(0) preconditioner on lap3d_101 over the mesh's
    4 shards on one card: apply with the kernels against apply with the
    plain versions (RelL2 <= SOLVE_TOL, padding rows 0, the launches),
    apply's warm TimeMin from a CUDA graph, one captured PCG iteration in
    us, and the RMS residual by iteration beside the single-device
    IC(0)'s, the last below PCG_TOL."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.kernels import sell, sts as ksts
    from tpu_spmv_torch.sts.ic0 import (
        capture_pcg_sharded_step, pcg_ic0_sharded_init,
    )

    D = mesh.size
    t0 = time.perf_counter()
    pre = cls.build(mat, D, lay.padded_m).device_put(mesh)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = dsh.shard_vector(np.random.default_rng(X_SEED).standard_normal(
        mat.m).astype(np.float32), mesh, lay.padded_m)
    before = (sell.spmv_sell.launches, ksts.lower_solve_blocks.launches)
    zk = dsh.gather_vector(pre.apply(r, mesh))
    delta = (sell.spmv_sell.launches - before[0],
             ksts.lower_solve_blocks.launches - before[1])
    zp = dsh.gather_vector(pre.apply(r, mesh, plain=True))
    rel = float(np.linalg.norm(zk - zp) / np.linalg.norm(zp))
    want = (2 * D, 2 * D) if name == "ic0" else (0, 2 * D)
    if delta != want:
        raise SmokeFailure(f"{name} apply: spmv_sell and lower_solve_blocks "
                           f"launched {delta} times, not {want}")
    if not rel <= SOLVE_TOL or zk[mat.m:].any():
        raise SmokeFailure(f"{name} apply: RelL2 vs plain {rel:.3g}, or a "
                           "padding row nonzero")
    apply_us = bench_spmv(lambda p, _x: p.apply(r, mesh), pre, r[0],
                          nnz=mat.nnz).time_min * 1e6

    b = dsh.shard_vector(np.ones(mat.m, np.float32), mesh, lay.padded_m)
    state = pcg_ic0_sharded_init(b, pre, mesh)
    graph = capture_pcg_sharded_step(lay, pre, mesh, state)
    trace, done, res = [], 0, float("nan")
    for it in (10, 20, 30, 40, 50, 60, 100):
        for _ in range(it - done):
            graph.replay()
        done = it
        x = dsh.gather_vector(state[0])[: mat.m]
        res = float(np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m))
        if not np.isfinite(res):
            raise SmokeFailure(f"{name} pcg D={D}: residual {res} at {it}")
        trace.append(f"{it}:{res:.3e}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    stop.record()
    stop.synchronize()
    it_us = start.elapsed_time(stop) / 10 * 1e3
    print(f"[lap3d_101 {name} D={D}] apply: spmv_sell +{delta[0]}, "
          f"lower_solve_blocks +{delta[1]}, RelL2 vs plain {rel:.3g}, padding "
          f"rows 0 | breakdowns {pre.breakdowns} | host build {build_s:.2f} s"
          f" | apply warm TimeMin (CUDA graph) {apply_us:.1f} us | PCG "
          f"iteration (CUDA graph) {it_us:.1f} us | phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"    rms residual by iteration: {' '.join(trace)} | single-device"
          f" IC(0): {trace_single}", flush=True)
    if not res < PCG_TOL:
        raise SmokeFailure(f"{name} pcg D={D}: residual {res:.3e} after "
                           f"100 iterations")


def _dist_sts_phases(stats, link_us, trace_single):
    """The sharded solve on lap2d_1024 LS at D = 1, 2 and 4 (_dist_solve),
    then both distributed IC(0) preconditioners on lap3d_101 at D = 4
    (_dist_precond), every shard on the one card. First, the port's
    bytes a nonzero of spmv_ranked on lap2d_1024 RCM (hw.
    SPMV_BYTES_PER_NNZ, tools/scaling.py's single-card rate)."""
    import torch

    from tpu_spmv_torch import hw
    from tpu_spmv_torch.dist import sharding as dsh
    from tpu_spmv_torch.sts.host import build_sts, compute_b
    from tpu_spmv_torch.sts.ic0 import (
        BlockJacobiIC0Preconditioner, ShardedIC0Preconditioner,
    )
    from tpu_spmv_torch.tools.spmv import load_input

    ranked = _single_ms(stats, "spmv_ranked", "lap2d_1024 rcm ranked grouped")
    if ranked is not None:
        nnz = 5_238_784
        print(f"spmv_ranked on lap2d_1024 RCM: {ranked[1] * 1e6:.2f} us, "
              f"{HBM_BYTES_PER_S * ranked[1] / nnz:.2f} B a nonzero at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (hw.SPMV_BYTES_PER_NNZ = "
              f"{hw.SPMV_BYTES_PER_NNZ})", flush=True)
    t0 = time.perf_counter()
    mat = load_input("synthetic:lap2d_1024")
    sys_ = build_sts(mat, order_type="LS")
    b = compute_b(sys_.lower)
    x_ref = _solve_oracle(sys_, b)
    print(f"    [lap2d_1024 LS] host set-up (system, oracle) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    single = _single_ms(stats, "lower_solve_blocks", "lap2d_1024 LS blocks")
    for D in (1, 2, 4):
        _dist_solve("lap2d_1024 LS sts_solve_sharded", sys_, b, D, stats,
                    x_ref, single, link_us)
    del sys_, x_ref

    mat = load_input("synthetic:lap3d_101")
    mesh = dsh.make_row_mesh([torch.device("cuda")] * 4)
    lay = dsh.ShardedRanked.build(mat, 4).device_put(mesh)
    for name, cls in (("ic0", ShardedIC0Preconditioner),
                      ("ic0-bj", BlockJacobiIC0Preconditioner)):
        _dist_precond(name, cls, mat, mesh, lay, trace_single)


def _multiproc_phase(stats):
    """The distributed layer across processes (bench/multiproc.py, suite
    "full"): 2 processes x 2 shards on the one card (gloo, host-staged;
    on a machine of 4 cards or more, 4 processes x 1 shard, a card each,
    NCCL), started after the kernels are built and held to a wall limit:
    spmv_sharded, spmv_overlap and spmm_sharded at B = 8 on lap2d_1024
    RCM, cg_solve on lap3d_101 for DIST_ITERS, sts_solve_sharded on
    lap2d_1024 LS and exact and block-Jacobi IC(0)-PCG on lap3d_101 for
    PCG_ITERS. Each process holds each path to its plain version
    (PLAIN_TOL) and times it (eager us a call or an iteration; with NCCL
    also from a CUDA graph); here each process's rows are held to the
    oracle and to the same calls in one process over [cuda:0] * 4, bit
    for bit (built while the processes run). Returns the processes'
    kernel launches over their paths, summed."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from tpu_spmv_torch.bench import multiproc
    from tpu_spmv_torch.bench.harness import validate
    from tpu_spmv_torch.dist import sharding as dsh

    n = 4 if torch.cuda.device_count() >= 4 else 2
    want = "nccl" if n == 4 else "gloo"
    argv = ["--suite", "full", "--device", "cuda", "--check", "--time",
            "--cg-iters", str(DIST_ITERS), "--pcg-iters", str(PCG_ITERS)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, \
            ThreadPoolExecutor(1) as pool:
        group = pool.submit(multiproc.spawn, n, argv, out, MULTIPROC_WALL_S)
        built = multiproc.build("full")
        res = group.result()
        wall = time.perf_counter() - t0
        for r, (code, log) in enumerate(res):
            if code != 0 or f"OK process {r}" not in log:
                how = "timed out" if code is None else f"exited {code}"
                raise SmokeFailure(f"multiproc: process {r} of {n} {how}:"
                                   f"\n{log[-3000:]}")
        loaded = multiproc.load(out, n)
    print(f"[multiproc] {n} processes x {4 // n} shards, {want}: group "
          f"wall {wall:.1f} s, parent host build {built.seconds:.1f} s, "
          "process host builds " + ", ".join(
              f"{f['host_build_s']:.1f}" for f, _ in loaded) + " s, paths "
          + ", ".join(f"{f['paths_s']:.1f}" for f, _ in loaded) + " s",
          flush=True)
    mesh = dsh.make_row_mesh([torch.device("cuda")] * 4)
    one, _ = multiproc.run_paths(built, mesh, cg_iters=DIST_ITERS,
                                 pcg_iters=PCG_ITERS)

    def whole(name):  # every process's rows, joined
        got = {d: y for _, rows in loaded for d, y in rows[name].items()}
        return np.concatenate([got[d] for d in sorted(got)])

    def rms(mat, name):
        x = whole(name)[: mat.m]
        return float(np.linalg.norm(mat.matvec(x) - 1.0) / np.sqrt(mat.m))

    a = built.spmv
    X = {"spmv": built.x, "overlap": built.x, "spmm": built.X}
    kernel = {"spmv": "spmv_ranked", "overlap": "spmv_ranked",
              "spmm": "spmm_ranked", "sts": "lower_solve_blocks",
              "ic0": "lower_solve_blocks", "ic0_bj": "lower_solve_blocks"}
    launches = {}
    for facts, _ in loaded:
        if facts["backend"] != want or facts["library_stale"]:
            raise SmokeFailure(f"multiproc: process {facts['rank']} ran "
                               f"{facts['backend']} (not {want}) or built "
                               "the kernel library itself")
        for k, v in facts["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for name in ("spmv", "overlap", "spmm", "cg", "sts", "ic0", "ic0_bj"):
        oracle = ""
        for facts, rows in loaded:
            got = rows[name]
            f = facts["paths"][name]
            if "plain" in f:
                err, scale = f["plain"]
                if not err <= PLAIN_TOL * max(1.0, scale):
                    raise SmokeFailure(f"multiproc {name}: process "
                                       f"{facts['rank']}'s kernels differ "
                                       f"from plain by {err:.3g}")
                stats.setdefault(kernel[name], []).append(
                    dict(label=f"multiproc {name}", err=err))
            if any(not np.array_equal(y, one[name][d].cpu().numpy())
                   for d, y in got.items()):
                raise SmokeFailure(f"multiproc {name}: process "
                                   f"{facts['rank']}'s rows are not the "
                                   "one-process D = 4 call's bits")
            if name in X:
                R = built.ranked.rows_per_shard
                v = X[name].reshape(a.n, -1)
                ref = np.stack([a.matvec(c) for c in v.T], 1)
                ref = np.concatenate([ref, np.zeros(
                    (built.ranked.padded_m - a.m, v.shape[1]))])
                for d, y in got.items():
                    w, rel = validate(y.reshape(R, -1),
                                      ref[d * R:(d + 1) * R])
                    if w or not rel <= L2_TOL:
                        raise SmokeFailure(
                            f"multiproc {name} shard {d}: Number Wrong "
                            f"{w}, RelL2 {rel:.3g}")
                oracle = f"Number Wrong 0, RelL2 <= {L2_TOL}"
        if name == "cg":
            res = rms(built.cg, name)
            if not res < DIST_TOL:
                raise SmokeFailure(f"multiproc cg: residual {res:.3e}")
            oracle = f"rms residual {res:.3e} after {DIST_ITERS}"
        elif name == "sts":
            x = whole(name)[built.sts_pad]
            wrong = int(np.sum(np.abs(x - 1.0) > 0.01))
            rel = float(np.linalg.norm(x - 1.0) / np.sqrt(x.size))
            if wrong or not rel <= SOLVE_TOL:
                raise SmokeFailure(f"multiproc sts: Number Wrong {wrong}, "
                                   f"RelL2 {rel:.3g}")
            oracle = f"x = ones: Number Wrong 0, RelL2 {rel:.3g}"
        elif name in ("ic0", "ic0_bj"):
            res = rms(built.ic0, name)
            if not res < PCG_TOL:
                raise SmokeFailure(f"multiproc {name}: residual {res:.3e}")
            oracle = f"rms residual {res:.3e} after {PCG_ITERS}"

        def us(v):
            return f"{v:.2f}" if isinstance(v, float) else str(v)

        times = " | ".join(
            f"process {f['rank']}: eager {us(f['paths'][name]['eager_us'])}"
            + (f", graph {us(f['paths'][name]['graph_us'])}"
               if "graph_us" in f["paths"][name] else "")
            for f, _ in loaded)
        per = "an iteration" if name in ("cg", "ic0", "ic0_bj") else "a call"
        print(f"[multiproc {name}] {oracle}; the one-process D=4 call's "
              f"bits; us {per}: {times}", flush=True)
    missing = [f"{k} (multiproc)" for k in (
        "spmv_ranked", "spmv_sell", "spmm_ranked", "lower_solve_blocks")
        if launches.get(k, 0) < 1]
    if missing:
        raise SmokeFailure(f"multiproc path never launched {missing}: "
                           f"{launches}")
    print(f"[multiproc] launches over the processes' paths: {launches} | "
          f"phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _dist_sts_steps():
    """_drive steps: the CLIs' D > 1 paths through the functions they
    call, with 4 shards on the one card (tools.sts.sharded on lap2d_1024
    LS; tools.solve.ic0_sharded, exact and block-Jacobi, on lap3d_101 at
    --tol PCG_TOL), and on a machine of 4 cards or more the CLIs
    themselves with --devices 4."""
    import torch

    from tpu_spmv_torch.tools import solve as solve_cli
    from tpu_spmv_torch.tools import sts as sts_cli
    from tpu_spmv_torch.tools.spmv import load_input

    four = [torch.device("cuda")] * 4

    def sts_run():
        from tpu_spmv_torch.sts.host import build_sts, compute_b

        def run():
            sys_ = build_sts(load_input("synthetic:lap2d_1024"),
                             order_type="LS")
            return sts_cli.sharded(sys_, compute_b(sys_.lower), four, 0.01)

        rc, out = _captured("tools.sts.sharded(lap2d_1024 LS, [cuda:0] * 4)",
                            run)
        if rc != 0 or "Number Wrong: 0" not in out:
            raise SmokeFailure(f"tools.sts.sharded: rc {rc}")

    def ic0_run(precond):
        def run():
            mat = load_input("synthetic:lap3d_101")
            rc, out = _captured(
                f"tools.solve.ic0_sharded(lap3d_101, {precond!r}, "
                f"[cuda:0] * 4, {PCG_ITERS}, {PCG_TOL})",
                lambda: solve_cli.ic0_sharded(mat, precond, four, PCG_ITERS,
                                              PCG_TOL))
            if rc != 0 or "us per iteration" not in out:
                raise SmokeFailure(f"tools.solve.ic0_sharded({precond}): rc "
                                   f"{rc}")
        return run

    steps = [sts_run, ic0_run("ic0"), ic0_run("ic0-bj")]
    if torch.cuda.device_count() >= 4:
        steps += [
            (sts_cli, ["synthetic:lap2d_1024", "--devices", "4"]),
            (solve_cli, ["synthetic:lap3d_101", "--precond", "ic0",
                         "--devices", "4", "--iters", str(PCG_ITERS), "--tol",
                         str(PCG_TOL)]),
        ]
    return steps


def _calibration(times, solves):
    """The planner's calibration at two scales: tools.tune's protocol at
    CALIB_SCALE (bench/calibration.calibrate: its points and fit), then
    tools.tune --calibrate --dry-run itself, at its default scale, driven
    with every launch counter zeroed (its counts join the main path's).
    Prints both fits, each constant's ratio between them, the shipped
    entry, and the decisions D1-D6 that each gives, the shipped entry
    and OLD_UNIT_ENTRY too (_decisions). Returns (tools.tune's launches,
    {entry: decisions})."""
    from tpu_spmv_torch import hw
    from tpu_spmv_torch.bench.calibration import calibrate, shipped_entry
    from tpu_spmv_torch.formats.sell import sigma_sort
    from tpu_spmv_torch.tools import tune as tune_cli
    from tpu_spmv_torch.tools.spmv import load_input

    fit_a = calibrate((CALIB_SCALE,), "cuda")[CALIB_SCALE][1]
    out = {}

    def run():
        argv = ["--calibrate", "--dry-run"]
        rc, text = _captured(f"tools.tune.main({argv})",
                             lambda: tune_cli.main(argv))
        line = json.loads(text.strip().splitlines()[-1])
        if rc != 0 or list(line) != [hw.device_kind()]:
            raise SmokeFailure(f"tools.tune: rc {rc}, last line {line}")
        out["fit"] = line[hw.device_kind()]

    counts = _drive((run,))
    fit_b, shipped = out["fit"], shipped_entry()
    a, b = f"scale {CALIB_SCALE:g}", f"scale {tune_cli.CALIB_SCALE:g}"
    print(f"calibration fits on {hw.device_kind()}: {a} (the protocol "
          f"above) {json.dumps(fit_a)} | {b} (tools.tune) "
          f"{json.dumps(fit_b)} | shipped " + (
              json.dumps(shipped) if shipped else "none: the planner runs "
              "on the module defaults (the reference's TPU v5e constants)"),
          flush=True)
    print(f"    ratio {b} / {a}: " + ", ".join(
        f"{k} {fit_b[k] / fit_a[k]:.3f}" if fit_a[k] else f"{k} {fit_b[k]}/0"
        for k in fit_a), flush=True)
    times["banded_1m sorted"] = sigma_sort(times["banded_1m"], 4096)[0]
    times["scattered_16m"] = load_input("synthetic:scattered_16m")
    decided = {}
    with _memo_slots():
        for label, entry in (("shipped", shipped), (a, fit_a), (b, fit_b),
                             ("old unit", OLD_UNIT_ENTRY)):
            decided[label] = _decisions(entry, times, solves)
            print(f"    decisions under {label}: " + " | ".join(
                f"{k} {v}" for k, v in decided[label].items()
                if k != "plans"), flush=True)
    same = all(decided[a][k] == decided[b][k] for k in decided[a]
               if k != "plans")
    print(f"    the two fits give {'the same' if same else 'different'} "
          "decisions", flush=True)
    return counts, decided


@contextlib.contextmanager
def _memo_slots():
    """Within the block, formats/sell's slot assignments and
    SellSlabs.shape_stats keep what they compute for a matrix: the
    decisions plan the same matrices under several entries, and this
    host work, most of the planner's time, does not depend on the
    entry."""
    from tpu_spmv_torch.formats import sell

    memo = {}

    def key(name, mat, *rest):
        return (name, mat.shape, mat.nnz, hash(mat.indptr[::97].tobytes()),
                hash(mat.indices[::9973].tobytes()), rest)

    def cached(name, fn):
        def call(mat, *args, **kw):
            k = key(name, mat, args, tuple(sorted(
                (a, b) for a, b in kw.items() if a != "slots")))
            if k not in memo:
                memo[k] = fn(mat, *args, **kw)
            return memo[k]
        return call

    saved = (sell._aligned_slots, sell._binned_slots,
             sell.SellSlabs.__dict__["shape_stats"])
    sell._aligned_slots = cached("aligned", saved[0])
    sell._binned_slots = cached("binned", saved[1])
    sell.SellSlabs.shape_stats = staticmethod(
        cached("stats", sell.SellSlabs.shape_stats))
    try:
        yield
    finally:
        sell._aligned_slots, sell._binned_slots = saved[:2]
        sell.SellSlabs.shape_stats = saved[2]


def _decisions(entry, times, solves):
    """D1-D6 with `entry` as the card's calibration: the planned (kernel,
    W) on lap2d_1024 after RCM (D1), banded_1m (D2) and scattered_16m
    (D3); whether banded_1m keeps its sigma = 4096 sort, the re-plan of
    the sorted matrix costing less (D4, with the sorted plan); the solve
    lower_solve runs on banded_1m LS and lap2d_1024 LS (D5); the value
    dtype tools.spmv --val-dtype bf16 stores on the stripes (D6). "plans"
    holds the TpuPlans."""
    from tpu_spmv_torch.bench.calibration import pinned
    from tpu_spmv_torch.kernels.striped import bf16_pays
    from tpu_spmv_torch.sts.solve import solve_choice
    from tpu_spmv_torch.tune.model import tpu_plan

    with pinned(entry):
        plans = {name: tpu_plan(times[name], assume_rcm=name.endswith("rcm"))
                 for name in ("lap2d_1024 rcm", "banded_1m", "banded_1m sorted",
                              "scattered_16m")}
        d5 = {f"D5 {n}": solve_choice(*solves[n]["chains"])
              for n in ("banded_1m LS", "lap2d_1024 LS")}
        d6 = "bf16" if bf16_pays() else "f32"
    kw = lambda p: f"{p.kernel} W={p.bin_blocks}"  # noqa: E731
    kept = plans["banded_1m sorted"].est_cost < plans["banded_1m"].est_cost
    return {"D1": kw(plans["lap2d_1024 rcm"]), "D2": kw(plans["banded_1m"]),
            "D3": kw(plans["scattered_16m"]),
            "D4": f"sigma={plans['banded_1m'].sigma} "
                  + ("kept" if kept else "rejected"),
            **d5, "D6": d6, "plans": plans}


def _plans(times, solves, decided):
    """tpu_plan (kernel, W, sigma, est_cost, reason) under the card's
    calibration (the shipped entry) on lap2d_1024 in natural order and
    after RCM, banded_1m, general_500k and scattered_16m (powerlaw_1m's
    plan is printed by its --sigma -1 CLI run);
    fails unless lap2d_1024 in natural order plans dia. Then D1-D6, each
    as the planned choice, the fastest choice timed in this run, both
    warm times and planned / fastest: the kernel on lap2d_1024 after RCM
    (D1) and banded_1m (D2) among sell, ranked and packed (the kernel
    phases'), the bin width on scattered_16m (D3: spmv_striped at
    default_stripe_cols, W of the striped phase and 32), the sigma = 4096
    sort on banded_1m kept or rejected (D4: each side's plan), the solve
    kernel on banded_1m LS and lap2d_1024 LS (D5: the solve phases'), the
    stripes' value dtype on scattered_16m (D6: the striped phase's f32 and
    bf16 times in turns), under the shipped entry and under
    OLD_UNIT_ENTRY. A planned layout not timed yet is built and timed
    here."""
    import numpy as np
    import torch

    from tpu_spmv_torch.bench.harness import bench_spmv
    from tpu_spmv_torch.formats.packed import PackedRanked
    from tpu_spmv_torch.formats.sell import RankedSlabs, SellSlabs
    from tpu_spmv_torch.kernels.packed import spmv_packed
    from tpu_spmv_torch.kernels.sell import spmv_ranked, spmv_sell
    from tpu_spmv_torch.kernels.striped import (
        StripedRanked, default_stripe_cols, spmv_striped,
    )
    from tpu_spmv_torch.tools.spmv import load_input, prepare
    from tpu_spmv_torch.tune.model import tpu_plan

    plans = decided["shipped"]["plans"]
    for name, rcm, key in (("lap2d_1024", "auto", None),
                           ("lap2d_1024", "always", "lap2d_1024 rcm"),
                           ("banded_1m", "auto", "banded_1m"),
                           ("general_500k", "auto", None),
                           ("scattered_16m", "auto", "scattered_16m")):
        t0 = time.perf_counter()
        p = plans[key] if key else tpu_plan(
            prepare(load_input(f"synthetic:{name}"), rcm)[0].matrix)
        print(f"plan on {name} (rcm {rcm}): {p.kernel} W={p.bin_blocks} "
              f"sigma={p.sigma} est_cost {p.est_cost:.0f} ({p.reason}); "
              f"planner {time.perf_counter() - t0:.2f} s", flush=True)
        if (name, rcm) == ("lap2d_1024", "auto") and p.kernel != "dia":
            raise SmokeFailure(f"lap2d_1024 natural order planned {p.kernel}, "
                               "not dia")

    dev = torch.device("cuda")
    builds = {"sell": (spmv_sell, SellSlabs.from_csr),
              "ranked": (spmv_ranked, RankedSlabs.from_csr),
              "packed": (spmv_packed, PackedRanked.from_csr)}

    def timed(tag, p):
        """Warm seconds of the plan p's layout of times[tag]."""
        key = (tag, p.kernel, p.bin_blocks)
        if key not in times:
            mat = times[tag]
            x = torch.from_numpy(np.random.default_rng(X_SEED).standard_normal(
                mat.n).astype(np.float32)).to(dev)
            if tag == "scattered_16m":
                fn, lay = spmv_striped, StripedRanked.from_csr(
                    mat, stripe_cols=default_stripe_cols(dev),
                    bin_blocks=p.bin_blocks, device=dev)
            else:
                fn, build = builds[p.kernel]
                lay = build(mat, bin_blocks=p.bin_blocks).to(dev)
            times[key] = bench_spmv(fn, lay, x).time_min
            del lay
        return times[key]

    def line(label, planned, t_planned, options):
        best = min(options, key=options.get)
        print(f"{label}: planned {planned} {t_planned * 1e6:.2f} us | "
              f"fastest timed {best} {options[best] * 1e6:.2f} us | planned "
              f"/ fastest {t_planned / options[best]:.3f} (timed: " + ", ".join(
                  f"{k} {v * 1e6:.2f}" for k, v in sorted(options.items()))
              + ")", flush=True)

    # Every choice of both entries is timed first, so both tables weigh
    # the same options.
    for who in ("shipped", "old unit"):
        _decision_table(decided[who], times, solves, timed,
                        lambda *args: None)
    for who in ("shipped", "old unit"):
        print(f"decisions under the {who} entry, planned against fastest "
              "timed in this run:", flush=True)
        _decision_table(decided[who], times, solves, timed, line)


def _decision_table(decided, times, solves, timed, line):
    """The D1-D6 lines of _plans for one entry's decisions."""
    plans = decided["plans"]
    for d, tag in (("D1", "lap2d_1024 rcm"), ("D2", "banded_1m"),
                   ("D3", "scattered_16m")):
        p = plans[tag]
        if tag == "scattered_16m":
            # spmv_striped at W = 32 too: the plan before the card's unit.
            timed(tag, dataclasses.replace(p, kernel="ranked", bin_blocks=32))
            if p.kernel != "ranked":
                print(f"{d} {tag}: planned {p.kernel} W={p.bin_blocks}, not "
                      "the striped route: not timed", flush=True)
                continue
        t = timed(tag, p)
        options = {f"{k[1]} W={k[2]}": v for k, v in times.items()
                   if isinstance(k, tuple) and k[0] == tag}
        line(f"{d} {tag} {'bin width' if d == 'D3' else 'kernel'}",
             f"{p.kernel} W={p.bin_blocks}", t, options)
    p, ps = plans["banded_1m"], plans["banded_1m sorted"]
    sides = {f"unsorted ({p.kernel} W={p.bin_blocks})": timed("banded_1m", p),
             f"sorted ({ps.kernel} W={ps.bin_blocks})":
                 timed("banded_1m sorted", ps)}
    kept = ps.est_cost < p.est_cost
    line(f"D4 banded_1m sigma={p.sigma} (re-plan est_cost {ps.est_cost:.0f} "
         f"{'<' if kept else '>='} {p.est_cost:.0f})",
         "kept" if kept else "rejected", list(sides.values())[kept], sides)
    for name in ("banded_1m LS", "lap2d_1024 LS"):
        rec, choice = solves[name], decided[f"D5 {name}"]
        line(f"D5 {name} solve kernel", choice, rec[choice],
             {k: rec[k] for k in ("ranked", "blocks")})
    dtypes = times["scattered_16m dtype"]
    line("D6 scattered_16m --val-dtype bf16 stores", decided["D6"],
         dtypes[decided["D6"]], dtypes)


def _drive(steps):
    """Zero every launch counter, run the steps, return the counts. A
    step is a (CLI module, argv) pair, whose main must return 0, or a
    callable that raises SmokeFailure."""
    from tpu_spmv_torch.kernels import dia, packed, sell, spmm, striped, sts

    wrappers = (dia.spmv_dia, dia.spmv_dia_windowed, sell.spmv_ranked,
                sell.spmv_ranked_windowed, sell.spmv_sell, packed.spmv_packed,
                spmm.spmm_ranked, spmm.spmm_ranked_windowed, spmm.spmm_packed,
                sts.lower_solve_ranked, sts.lower_solve_blocks,
                striped.spmv_striped)
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


def _captured(label, fn):
    """(return value, stdout) of fn(), its stdout also printed; an exit
    of fn is a SmokeFailure."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    print(f"== {label}", flush=True)
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    except SystemExit as e:
        raise SmokeFailure(f"{label} exited: {e}")
    finally:
        print(buf.getvalue(), end="", flush=True)
    print(f"   (wall {time.perf_counter() - t0:.1f} s)", flush=True)
    return out, buf.getvalue()


def _cli_run(cli, argv, expect=""):
    """A _drive step: cli.main(argv) must return 0 and print Number
    Wrong 0 and `expect`."""
    def run():
        name = f"tools.{cli.__name__.rsplit('.', 1)[1]}.main({argv})"
        rc, out = _captured(name, lambda: cli.main(argv))
        if rc != 0 or "Number Wrong: 0 " not in out or expect not in out:
            raise SmokeFailure(f"{name}: rc {rc}, expected Number Wrong 0 "
                               f"and {expect!r}")
    return run


def _cli_refusal(cli, argv, expect):
    """A _drive step: cli.main(argv) must exit with `expect` in its
    message."""
    def run():
        try:
            cli.main(argv)
        except SystemExit as e:
            print(f"== {cli.__name__}.main({argv}) refused: {e}", flush=True)
            if expect in str(e):
                return
        raise SmokeFailure(f"{cli.__name__}.main({argv}) was not refused "
                           f"with {expect!r}")
    return run


def _cli_first_output(cli, argv, module, name, outputs, expect=""):
    """A _drive step: cli.main(argv) (must return 0, print Number Wrong 0
    and `expect`) with module.name wrapped so that the first result it
    returns (the CLI's validation call) is kept, bits and all, in
    outputs[argv-tuple]; the wrapped kernel counts its launches as
    before."""
    def run():
        kernel = getattr(module, name)
        seen = []

        def first(*args, **kw):
            y = kernel(*args, **kw)
            if not seen:
                seen.append(y.detach().clone())
            return y

        # The wrapper stands in for the kernel's module attribute, which
        # the wrapper's own launch count is read from.
        first.launches = kernel.launches
        setattr(module, name, first)
        try:
            _cli_run(cli, argv, expect)()
        finally:
            kernel.launches = first.launches
            setattr(module, name, kernel)
        if not seen:
            raise SmokeFailure(f"{name} never ran in {argv}")
        outputs[tuple(argv)] = seen[0]
    return run


def _flagship():
    """A _drive step: bench.flagship.main(), whose last stdout line must
    be bench.py's JSON with value > 0."""
    from tpu_spmv_torch.bench import flagship

    rc, out = _captured("bench.flagship.main([])", lambda: flagship.main([]))
    try:
        line = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise SmokeFailure(f"bench.flagship: no JSON last line (rc {rc})")
    if rc != 0 or line.get("metric") != "spmv_gflops" or not (
            line.get("value", 0) > 0 and line.get("vs_baseline", 0) > 0):
        raise SmokeFailure(f"bench.flagship: rc {rc}, line {line}")


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


def _baselines():
    """Launch counts of the baselines (segsum and bcoo on lap2d_1024,
    dense on an 8,192 x 8,192 matrix at its cap and refused on
    lap2d_1024) and the flagship bench."""
    import os
    import tempfile

    from tpu_spmv_torch.bench.matrices import random_general
    from tpu_spmv_torch.io import write_mtx
    from tpu_spmv_torch.tools import spmv as spmv_cli

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "general_8192.mtx")
        write_mtx(path, random_general(8192, 10, seed=2))
        baselines = _drive((
            _cli_run(spmv_cli, ["synthetic:lap2d_1024", "20", "--kernel",
                                "segsum"]),
            _cli_run(spmv_cli, ["synthetic:lap2d_1024", "20", "--kernel",
                                "bcoo"]),
            _cli_run(spmv_cli, [path, "20", "--kernel", "dense"],
                     "dense baseline: operator 256.0 MB"),
            _cli_refusal(spmv_cli, ["synthetic:lap2d_1024", "--kernel",
                                    "dense"], "dense baseline capped"),
        ))
    flag_path = _drive((_flagship,))
    return baselines, flag_path


def _planner_paths(cache, outputs, bin_blocks):
    """Launch counts of the paths this slice added, each driven with the
    counters zeroed: tools.spmv --kernel auto on scattered_16m without
    --bin-blocks (the plan's W, which must take the striped route: the
    run that drives spmv_striped on the main path), and with --val-dtype
    bf16 (under the shipped entry it must store bf16 stripes, validated
    against the bf16-rounded operator),
    --sigma -1 on powerlaw_1m and a forced --sigma 4096 on banded_1m,
    the second --layout-cache run on lap2d_4096 after RCM (the first is
    the windowed ranked run of _main_path: this one must load the cache
    and give its bits) and tools.sweep over two matrices x three kernels
    (its CSV printed). tools.tune --calibrate --dry-run is driven in the
    calibration phase."""
    import os

    import torch

    from tpu_spmv_torch.kernels import sell
    from tpu_spmv_torch.tools import spmv as spmv_cli
    from tpu_spmv_torch.tools import sweep as sweep_cli

    def scattered_auto():
        import re

        argv = ["synthetic:scattered_16m", "20"]
        rc, out = _captured(f"tools.spmv.main({argv})",
                            lambda: spmv_cli.main(argv))
        w = re.search(r"planner bin width: W=(\d+)", out)
        t = re.search(r"TimeMin: (\S+)", out)
        if rc != 0 or "Number Wrong: 0 " not in out or w is None or (
                "column-striped passes" not in out):
            raise SmokeFailure(f"tools.spmv {argv}: rc {rc}, expected the "
                               "plan's W and the striped route")
        print(f"scattered_16m --kernel auto: the plan's W={w.group(1)}, "
              f"route striped, warm TimeMin {float(t.group(1)) * 1e6:.2f} "
              f"us (the striped phase's W={bin_blocks} was picked by "
              "padding on a row sample)", flush=True)

    def scattered_bf16():
        import re

        argv = ["synthetic:scattered_16m", "20", "--val-dtype", "bf16"]
        rc, out = _captured(f"tools.spmv.main({argv})",
                            lambda: spmv_cli.main(argv))
        t = re.search(r"TimeMin: (\S+)", out)
        if rc != 0 or "Number Wrong: 0 " not in out or t is None or not all(
                s in out for s in (
                    "column-striped passes", "storing bf16 values",
                    "bf16 values: validated vs the bf16-rounded operator")):
            raise SmokeFailure(f"tools.spmv {argv}: rc {rc}, expected the "
                               "striped route storing bf16 stripes, "
                               "validated against the bf16-rounded operator")
        print(f"scattered_16m --val-dtype bf16: route striped, bf16 "
              f"stripes, warm TimeMin {float(t.group(1)) * 1e6:.2f} us",
              flush=True)

    auto = _drive((scattered_auto, scattered_bf16))
    sigma = _drive((
        _cli_run(spmv_cli, ["synthetic:powerlaw_1m", "20", "--sigma", "-1"]),
        _cli_run(spmv_cli, ["synthetic:banded_1m", "20", "--sigma", "4096"],
                 "sigma=4096 row sort applied"),
    ))
    argv = _cache_argv(cache)
    first = outputs[tuple(argv)]
    loaded = _drive((_cli_first_output(spmv_cli, argv, sell,
                                       "spmv_ranked_windowed", outputs,
                                       "loaded layout from"),))
    second = outputs[tuple(argv)]
    if not torch.equal(first, second):
        raise SmokeFailure("lap2d_4096: the cached layout's y differs from "
                           "the built layout's")
    print(f"lap2d_4096 rcm: the loaded layout gives the built layout's bits "
          f"({first.numel()} values)", flush=True)
    csv_path = os.path.join(os.path.dirname(cache), "sweep.csv")
    sweep = _drive(((sweep_cli, [
        "--out", csv_path, "--scale", "small", "--matrices", "lap2d_256",
        "banded_100k", "--kernels", "auto", "ranked", "sell", "--k", "1",
        "--srs", "8", "--rcm", "auto"]),))
    with open(csv_path) as f:
        rows = f.read().splitlines()
    print(f"sweep: {len(rows) - 1} rows in {csv_path}", flush=True)
    for row in rows:
        print(f"    {row}", flush=True)
    if len(rows) != 7 or any(r.split(",")[11] != "0" for r in rows[1:]):
        raise SmokeFailure(f"tools.sweep: expected 6 rows with Number Wrong "
                           f"0, got {rows}")
    return dict(auto=auto, sigma=sigma, loaded=loaded, sweep=sweep)


def _cache_argv(cache):
    """The tools.spmv argv of both --layout-cache runs on lap2d_4096."""
    return ["synthetic:lap2d_4096", "20", "--kernel", "ranked", "--rcm",
            "always", "--bin-blocks", "0", "--layout-cache", cache]


def _main_path(bin_blocks, tune, dist, multiproc):
    """Launch counts of each kernel over its own path's run. bin_blocks:
    the striped phase's W; tune: the launches of the calibration phase's
    tools.tune run; dist: the dist phase's D = 4 layouts (_dist_phases); multiproc:
    the multiproc phase's launches (its processes count their own paths
    from 0)."""
    import tempfile

    from tpu_spmv_torch.kernels import sell
    from tpu_spmv_torch.tools import solve as solve_cli
    from tpu_spmv_torch.tools import spmm as spmm_cli
    from tpu_spmv_torch.tools import spmv as spmv_cli
    from tpu_spmv_torch.tools import sts as sts_cli

    tmp = tempfile.TemporaryDirectory()
    cache = f"{tmp.name}/lap2d_4096_rcm.npz"
    outputs = {}

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
        _cli_first_output(spmv_cli, _cache_argv(cache), sell,
                          "spmv_ranked_windowed", outputs,
                          "saved layout to"),
    ))
    sts_path = _drive((
        (sts_cli, ["synthetic:lap2d_1024", "5"]),
        (sts_cli, ["synthetic:lap2d_1024", "5", "--order", "COLOR"]),
        (sts_cli, ["synthetic:lap2d_1024", "3", "--k", "3"]),
        (sts_cli, ["synthetic:lap3d_101", "5", "--part", "upper"]),
        (solve_cli, ["synthetic:lap3d_101", "--precond", "ic0", "--iters",
                     str(PCG_ITERS), "--tol", str(PCG_TOL)]),
    ))
    dist_argv = ["synthetic:lap3d_101", "--iters", str(DIST_ITERS), "--tol",
                 str(DIST_TOL), "--devices", "1"]
    dist_path = _drive((
        (solve_cli, dist_argv),
        (solve_cli, [*dist_argv, "--pcg"]),
        _dist_cg(DIST_ITERS),
        # --devices 0 is every card (one here): a D = 1 mesh whose X of
        # 33.5 MB is past the residency gate, so spmm_ranked_windowed.
        (spmm_cli, ["synthetic:lap2d_1024", "20", "--batch", "8",
                    "--devices", "0"]),
        *_dist_calls(dist),
    ))
    dist_sts_path = _drive(_dist_sts_steps())
    library = _library_blocks()
    baselines, flag_path = _baselines()
    with tmp:
        planner = _planner_paths(cache, outputs, bin_blocks)
    planner["tune"] = tune
    counts = dict(spmv_path,
                  lower_solve_ranked=sts_path["lower_solve_ranked"],
                  lower_solve_blocks=library["lower_solve_blocks"])
    # The striped route: tools.spmv --kernel auto on scattered_16m.
    counts["spmv_ranked"] += planner["auto"]["spmv_ranked"]
    counts["spmv_striped"] = planner["auto"]["spmv_striped"]
    dist_kernels = ("spmv_ranked", "spmv_sell", "spmm_ranked",
                    "spmm_ranked_windowed")
    for k in dist_kernels:
        counts[k] += dist_path[k]
    dist_sts_kernels = ("spmv_sell", "lower_solve_blocks", "spmv_ranked")
    for k in dist_sts_kernels:
        counts[k] += dist_sts_path[k]
    multiproc_kernels = ("spmv_ranked", "spmv_sell", "spmm_ranked",
                         "lower_solve_blocks")
    for k in multiproc_kernels:
        counts[k] += multiproc.get(k, 0)
    print(f"launches: SpMV/SpMM CLIs {spmv_path} | solve CLIs {sts_path} | "
          f"dist (tools.solve CG and Jacobi-PCG, cg_solve D=4, tools.spmm "
          f"--devices 0, the D=4 sharded calls) {dist_path} | dist sts "
          f"(tools.sts.sharded, tools.solve.ic0_sharded ic0 and ic0-bj, "
          f"D=4 on one card) {dist_sts_path} | multiproc (the processes' "
          f"paths) {multiproc} | "
          f"library lower_solve(ranked=False) {library} | baseline CLIs "
          f"{baselines} | flagship "
          f"{flag_path} | " + " | ".join(
              f"{k} {v}" for k, v in planner.items()), flush=True)
    missing = [k for k, v in counts.items() if v < 1]
    missing += [f"{k} (dist)" for k in dist_kernels if dist_path[k] < 1]
    missing += [f"{k} (dist sts)" for k in dist_sts_kernels
                if dist_sts_path[k] < 1]
    missing += [f"{k} (multiproc)" for k in multiproc_kernels
                if multiproc.get(k, 0) < 1]
    missing += [f"{k} (flagship)" for k in ("spmv_dia", "spmv_packed")
                if flag_path[k] < 1]
    missing += [f"{k} (auto on scattered_16m)" for k in (
        "spmv_ranked", "spmv_striped") if planner["auto"][k] < 1]
    missing += [f"{k} (cached layout)" for k in ("spmv_ranked_windowed",)
                if planner["loaded"][k] < 1]
    missing += [f"{k} (calibration)" for k in (
        "spmv_sell", "spmv_ranked", "spmv_packed") if planner["tune"][k] < 1]
    missing += ["any kernel (sigma runs)"] * (sum(planner["sigma"].values())
                                              < 2)
    missing += ["any kernel (sweep)"] * (sum(planner["sweep"].values()) < 4)
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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's smoke run on the "
                                 "card (see the module docstring)")
    ap.add_argument("--multiproc-only", action="store_true",
                    help="build, then run the multiproc phase alone (4 "
                    "processes, NCCL, on a machine of 4 cards) and print "
                    "no result line")
    args = ap.parse_args(argv)
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
    if args.multiproc_only:
        try:
            _multiproc_phase(stats)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(f"total wall {time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        t0 = time.perf_counter()
        times = _phases(stats)
        print(f"kernel phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _windowed_phases(stats)
        print(f"windowed phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        bin_blocks = _striped_phases(stats, times)
        print(f"striped phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        solves = {}
        link_us = _solve_phases(stats, solves)
        print(f"solve phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        tune, decided = _calibration(times, solves)
        print(f"calibration: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _plans(times, solves, decided)
        print(f"plans: wall {time.perf_counter() - t0:.1f} s", flush=True)
        del times, decided
        t0 = time.perf_counter()
        ic0_trace = _ic0_phases()
        print(f"ic0 phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        dist = _dist_phases(stats)
        print(f"dist phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        _dist_sts_phases(stats, link_us, ic0_trace)
        print(f"dist sts phases: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        multiproc = _multiproc_phase(stats)
        print(f"multiproc phase: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        counts = _main_path(bin_blocks, tune, dist, multiproc)
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
