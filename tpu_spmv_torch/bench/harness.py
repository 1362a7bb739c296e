"""Timing and validation harness for the port.

Counterpart of `tpu_spmv/bench/harness.py`, with the same result keys
(TimeMin/TimeMax/TimeAvg/GFLOPs) and the same `validate`.

Timing is on the card only, with CUDA events: warm up, size a batch of
N back-to-back launches from a timed warm batch, then time several
samples of N launches each and report the per-launch min, max and
average over the samples. By default the N launches are captured once
in a CUDA graph and each sample replays it, so the figure is the
device's time: a kernel of ~20 us is otherwise bounded by the Python
and ctypes cost of launching it. `graph=False` times the eager launches
instead, which is what a Python caller looping over calls sees. The
slope protocol of the JAX harness was a workaround for a remote TPU
link and does not carry over.

Two regimes, always labelled:
  warm  the same operator every launch. The H100's 50 MB L2 can hold a
        whole operator of a few tens of MB (lap2d_1024's DIA operator
        is 10.5 MB in bf16, 21 MB in f32, plus 8 MB of x and y), so this
        measures L2, not HBM;
  cold  K distinct copies of the operator, launched in rotation, with
        K * operator bytes >= 4x L2, so each launch streams its operator
        from HBM. x and y (a few MB) still stay in L2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Target length of one timed sample; N launches per sample follow from it.
_SAMPLE_S = 0.02
_MAX_LAUNCHES = 5000


@dataclasses.dataclass
class BenchResult:
    time_min: float  # seconds per SpMV, min over samples
    time_max: float
    time_avg: float
    nnz: int
    iters: tuple  # (launches per sample, samples, operator copies)
    regime: str  # "warm" or "cold"
    launch: str  # "graph" (device time) or "eager" (Python launches)

    @property
    def gflops(self) -> float:
        return 2.0 * self.nnz / self.time_min / 1e9

    def summary(self) -> str:
        """The reference's stdout keys (spmv-csr/spmv.c:183-185)."""
        return (
            f"TimeMin: {self.time_min:.6g}\n"
            f"TimeMax: {self.time_max:.6g}\n"
            f"TimeAvg: {self.time_avg:.6g}\n"
            f"GFLOPs: {self.gflops:.4g}\n"
        )


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(
            f"timing needs a CUDA card; x is on {x.device} (CPU numbers "
            "are not device times)"
        )


def _time_rotation(spmv, layouts, x, warmup: int, samples: int,
                   graph: bool):
    """Per-launch seconds of `samples` batches of N launches over
    `layouts` in rotation; returns (times, N)."""
    k = len(layouts)

    def run(count: int) -> None:
        for i in range(count):
            spmv(layouts[i % k], x)

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3

    run(max(warmup, k))
    torch.cuda.synchronize(x.device)
    # Size N from a warm eager batch (never from a first, building call);
    # eager time per launch bounds the device time from above.
    probe = max(10, k)
    per = timed(lambda: run(probe)) / probe
    count = int(np.clip(_SAMPLE_S / max(per, 1e-9), probe, _MAX_LAUNCHES))
    count = -(-count // k) * k  # whole rotations
    if not graph:
        return [timed(lambda: run(count)) / count for _ in range(samples)], count
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        run(count)
    g.replay()
    torch.cuda.synchronize(x.device)
    return [timed(g.replay) / count for _ in range(samples)], count


def _result(times, nnz, count, copies, regime, graph) -> BenchResult:
    return BenchResult(
        time_min=min(times), time_max=max(times),
        time_avg=sum(times) / len(times), nnz=nnz,
        iters=(count, len(times), copies), regime=regime,
        launch="graph" if graph else "eager",
    )


def bench_spmv(spmv, layout, x: torch.Tensor, samples: int = 5,
               warmup: int = 5, nnz: int | None = None,
               graph: bool = True) -> BenchResult:
    """Warm regime: the same operator every launch (see module doc)."""
    _require_cuda(x)
    times, count = _time_rotation(spmv, [layout], x, warmup, samples, graph)
    return _result(times, nnz if nnz is not None else layout.nnz, count,
                   1, "warm", graph)


def cold_copies(layout_bytes: int, l2_bytes: int) -> int:
    """Operator copies K with K * layout_bytes >= 4x L2 (at least 2)."""
    return max(2, -(-4 * l2_bytes // max(layout_bytes, 1)))


def bench_spmv_cold(spmv, make_layout, x: torch.Tensor, nnz: int,
                    layout_bytes: int, l2_bytes: int | None = None,
                    samples: int = 5, warmup: int = 5,
                    graph: bool = True) -> BenchResult:
    """Cold regime: K distinct operator copies from `make_layout()`
    (each with its own storage) launched in rotation (see module doc)."""
    _require_cuda(x)
    if l2_bytes is None:
        from tpu_spmv_torch.hw import device_spec

        l2_bytes = device_spec(x.device).l2_bytes
    k = cold_copies(layout_bytes, l2_bytes)
    layouts = [make_layout() for _ in range(k)]
    times, count = _time_rotation(spmv, layouts, x, warmup, samples, graph)
    return _result(times, nnz, count, k, "cold", graph)


def roofline_nnzs(bytes_per_nnz: float,
                  hbm_bytes_per_s: float | None = None) -> float:
    """Max nnz/s if the kernel were purely HBM-bandwidth-bound, against
    the card's data-sheet bandwidth (hw.DeviceSpec) by default."""
    if hbm_bytes_per_s is None:
        from tpu_spmv_torch.hw import device_spec

        hbm_bytes_per_s = device_spec().hbm_bytes_per_s
    return hbm_bytes_per_s / bytes_per_nnz


def validate(y_device: np.ndarray, y_oracle_permuted: np.ndarray,
             tol: float = 0.01):
    """(Number Wrong, RelL2), with tpu_spmv.bench.harness.validate's
    semantics: an entry is wrong when |delta| > tol * max(1, |y_oracle|)
    (magnitude-aware, not the reference's absolute 0.01)."""
    y_device = np.asarray(y_device)
    scale = np.maximum(1.0, np.abs(y_oracle_permuted))
    num_wrong = int(np.sum(np.abs(y_device - y_oracle_permuted) > tol * scale))
    rel_l2 = float(
        np.linalg.norm(y_device - y_oracle_permuted)
        / max(np.linalg.norm(y_oracle_permuted), 1e-30)
    )
    return num_wrong, rel_l2
