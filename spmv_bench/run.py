"""Run one cell of the benchmark and print its result line.

  python -m spmv_bench.run --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

from the root of a checkout. The run sets up (the matrix and inputs from
the seed, the program's build, the warm-up of the cell's own shapes),
measures a closed loop for --seconds, and with --trace 1 then reads the
per-layer metrics (the issue bursts, a short window under the profiler).
Once the window has closed and the program's state is freed, the answers
kept from the window are judged against the plain reference. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the numbers compared
beside their limits, which also end standard error. Without as many
CUDA cards as the cell's `chips` the run fails and prints no result.
A cell on N > 1 cards runs as N processes, one card each, this one rank
0 (spmv_bench/ranks.py): only rank 0 reports, traces and judges. With
--control 1 the bfloat16 reference runs in the program's place, on one
card: the control of `correct`, which has to come out false."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "spmv_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_spmv")


def manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's entry of `workloads`, its configuration, traffic mix
    and limits, each read from the file its name leads to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; known: "
                         + ", ".join(cells))
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    return {
        "workload": w,
        "config": _json(root / configs[w["config"]]["file"]),
        "traffic": _json(root / "spmv_bench" / "traffic"
                         / f"{w['traffic']}.json"),
        "limits": _json(root / "spmv_bench" / "cells" / f"{cell}.json"),
    }


def reader(name: str, root: pathlib.Path = ROOT):
    """The read() of metrics/<name>.py; where there is no such file, that
    of the name with its last ".<part>" taken off, and so on: the cells'
    classes of one quantity (device_idle.host_bound, device_idle.cg)
    share one reader."""
    base = name
    path = root / "spmv_bench" / "metrics" / f"{base}.py"
    while not path.exists() and "." in base:
        base = base.rsplit(".", 1)[0]
        path = root / "spmv_bench" / "metrics" / f"{base}.py"
    if not path.exists():
        raise SystemExit(f"no reader metrics/<prefix of {name}>.py")
    spec = importlib.util.spec_from_file_location(
        "spmv_bench.metrics." + base.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_specs(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with trace its per-layer ones:
    those whose `workloads` name the cell, and those without the key."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's or the
    JAX package's, compared whole: tpu_spmv_torch is not tpu_spmv."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Compile caches at fixed paths inside the checkout. The port's own
    builds go to tpu_spmv_torch/{kernels,reorder}/_build/."""
    cache = root / "spmv_bench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def power_limit_w():
    """The card's power limit (nvidia-smi), or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def rank_args(cell: str, seed: int, seconds: float, trace: bool,
              device: str, root: pathlib.Path = ROOT,
              config: dict | None = None) -> list:
    """The arguments of the run that the other ranks are given."""
    return ["--workload", cell, "--seed", str(seed), "--seconds",
            repr(float(seconds)), "--trace", str(int(trace)), "--device",
            device, "--root", str(root), "--config", json.dumps(config or {})]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             root: pathlib.Path = ROOT, config: dict | None = None,
             t0: float | None = None, control: bool = False,
             rank: int = 0, started: bool = False) -> dict | None:
    """One run of `cell`; returns the result object. config overrides
    keys of the cell's configuration (the tests' small grids); control
    puts the bfloat16 reference in the program's place, judged by the
    same check, in one process. A cell on N > 1 cards runs as N
    processes: rank 0 (this call; `started` where its caller has
    started them) starts the others (ranks.started), each on its card
    (cuda:r) or on the CPU where `device` is the CPU, and they call
    run_cell with their rank, which returns None."""
    import torch

    from spmv_bench import matrices, ranks
    from spmv_bench.core import Run
    from spmv_bench.trace import profile

    t0 = T0 if t0 is None else t0
    bench = manifest(root)
    files = cell_files(bench, cell, root)
    cfg = dict(files["config"], **(config or {}))
    n = 1 if control else int(files["workload"]["chips"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    with ranks.started(1 if rank or started else n, rank_args(
            cell, seed, seconds, trace, device.type, root, config)):
        run = Run(cell, cfg, files["traffic"], files["limits"], seed,
                  device, control, processes=n, rank=rank)
        runner = importlib.import_module(f"spmv_bench.entries.{run.entry}")
        with contextlib.redirect_stdout(sys.stderr):
            with run.span("input.matrix"):
                csr = matrices.generate(cfg, seed)
            run.nnz = csr.nnz
            entry = runner.Entry(run, csr)
            # What set-up leaves behind is never collected again: the
            # window's collections then scan only the window's objects.
            gc.collect()
            gc.freeze()
            run.setup_s = time.perf_counter() - t0
            entry.window(seconds)
            if trace:
                if hasattr(entry, "issue"):
                    entry.issue()
                secs = min(seconds, float(run.traffic["trace_seconds"]))
                if rank == 0:
                    run.traced_work, run.trace = profile(
                        lambda: entry.traced(secs), device)
                else:
                    entry.traced(secs)
            if device.type == "cuda":
                run.memory_peak_bytes = torch.cuda.max_memory_allocated(
                    device)
            numbers, wrong = entry.check()
        gc.unfreeze()
    if rank:
        print(f"spmv_bench: rank {rank} spans_s {json.dumps(run.spans)}",
              file=sys.stderr, flush=True)
        return None

    metrics = {}
    for m in metric_specs(bench, cell, trace):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # A number that is not finite fails its limit; JSON has no NaN.
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": run.limits[k]} for k, v in numbers.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": run.processes,
           "memory_peak_bytes": run.memory_peak_bytes}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    out = {
        "correct": wrong == 0 and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in checks.values()),
        "attempted": run.counts.get("calls", run.counts.get("solves", 0)),
        "failed": wrong,
        "metrics": metrics,
        "device": dev,
        "route": dict(run.notes),
        "spans_s": dict(run.spans),
    }
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: run the bfloat16 reference in the program's "
                    "place (the control of `correct`, which must read "
                    "false)")
    args = ap.parse_args(argv)

    from spmv_bench import ranks

    chips = cell_files(manifest(), args.workload)["workload"]["chips"]
    chips = 1 if args.control else chips
    set_cache_dirs()
    # The other ranks start before this process imports torch, so that
    # their start overlaps this one's and the group's start waits less.
    with ranks.started(chips, rank_args(args.workload, args.seed,
                                        args.seconds, bool(args.trace),
                                        "cuda")):
        import torch

        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < chips):
            print(f"spmv_bench: the cell needs {chips} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0),
                          control=bool(args.control), started=True)
    bad = forbidden_modules()
    if bad:
        print(f"spmv_bench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
