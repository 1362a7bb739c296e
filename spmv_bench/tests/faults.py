"""Faults planted under a run's timed path, for the tests that see
`correct` come out false, and the runner of a cell whose ranks are
processes of their own: the fault is planted in every rank, since a
fault in one rank alone would leave the others waiting in a collective.

Not a test module: the tests import it, and a group's ranks run it as
their preamble (`preamble`)."""

from __future__ import annotations

import importlib
import os
import pathlib
import subprocess
import sys

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parents[1]

# The solver step each mix's `precond` runs, where a fault is planted.
STEPS = {"none": ("tpu_spmv_torch.dist.solvers", "cg_step"),
         "ic0": ("tpu_spmv_torch.sts.ic0", "pcg_ic0_step")}


def break_step(setattr_, precond: str, fault: str) -> None:
    """Replace the program's solver step with one that returns its state
    unchanged ("unchanged") or alters one entry of this process's first
    shard of x ("answer_altered"). setattr_: setattr, or a test's
    monkeypatch.setattr."""
    mod_name, fn_name = STEPS[precond]
    mod = importlib.import_module(mod_name)
    step = getattr(mod, fn_name)

    def broken(*args, **kw):
        state = args[-1]
        if fault == "unchanged":
            return state
        x, r, p, rz = step(*args, **kw)
        x0 = (next(t for t in x if t is not None) if isinstance(x, list)
              else x)
        x0[x0.numel() // 3] += 1.0
        return x, r, p, rz

    setattr_(mod, fn_name, broken)


def leave_out_exchange(setattr_) -> None:
    """Replace the program's exchange between processes (the halo rows'
    sends and receives) with one that sends nothing and receives
    zeros."""
    from tpu_spmv_torch.dist import group

    def none(mesh, sends, recvs):
        for t, _, _ in recvs:
            t.zero_()

    setattr_(group, "exchange", none)


def plant(fault) -> None:
    """Plant `fault` in this process: None; in every rank ("step",
    precond, kind) or ("exchange",), the halo exchange left out; in rank
    `rank` alone, ("exit", rank, seconds) to kill it that many seconds
    after it starts, in its set-up, or ("module", rank, name) to load an
    empty module of that name."""
    if fault is None:
        return
    kind, *args = fault
    if kind == "step":
        break_step(setattr, *args)
    elif kind == "exchange":
        leave_out_exchange(setattr)
    elif int(os.environ.get("TPU_SPMV_PROCESS_ID", "0")) != args[0]:
        return
    elif kind == "exit":
        import signal
        import threading

        threading.Timer(args[1], os.kill,
                        (os.getpid(), signal.SIGKILL)).start()
    else:
        import types

        sys.modules[args[1]] = types.ModuleType(args[1])


def preamble(fault) -> str:
    """Python that plants `fault` in a fresh process."""
    return (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]; "
            f"import faults; faults.plant({fault!r}); ")


def run_group(cell: str, seed: int, seconds: float, trace: bool,
              config: dict, fault=None, root: pathlib.Path = ROOT,
              timeout: float = 600):
    """run_cell of a cell on several processes, on the CPU, with rank 0
    in a process of its own and `fault` planted in every rank. Returns
    the finished process (its last line of output the result's JSON,
    where it printed one)."""
    pre = preamble(fault)
    child = pre + "from spmv_bench import ranks; sys.exit(ranks.main())"
    code = (pre + "import json, pathlib, torch; "
            "from spmv_bench import ranks, run; "
            "ranks.child_command = lambda args: "
            f"[sys.executable, '-c', {child!r}, *args]; "
            f"out = run.run_cell({cell!r}, {seed!r}, {seconds!r}, {trace!r}, "
            f"torch.device('cpu'), root=pathlib.Path({str(root)!r}), "
            f"config={config!r}); "
            "print(json.dumps(out))")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    for k in ("TPU_SPMV_COORDINATOR", "TPU_SPMV_NUM_PROCESSES",
              "TPU_SPMV_PROCESS_ID"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
