"""The ranks of a cell on more than one card: the launcher that rank 0,
the harness's own process, runs, and the entry point of the others.

A cell whose `chips` is N > 1 runs as N processes of one machine, one
card each, that start the port's own process group
(`tpu_spmv_torch.dist.multihost.initialize`, from the port's variables
TPU_SPMV_COORDINATOR, TPU_SPMV_NUM_PROCESSES and TPU_SPMV_PROCESS_ID,
which this module sets). The harness's process is rank 0, on cuda:0;
it starts ranks 1..N-1 (`python -m spmv_bench.ranks`, with the run's
own arguments), rank r on cuda:r, or on the CPU for the tests, where
the group runs over gloo. Every rank runs the same cell; only rank 0
reports. The others write to rank 0's standard error.

A watchdog thread of rank 0 ends the run with no result as soon as a
rank exits with another code than 0 or is killed, instead of waiting
out the group's timeout: it kills the other ranks, waits for them and
exits. A rank started here is killed when rank 0 ends
(PR_SET_PDEATHSIG), so none outlives the run. Each rank looks for JAX
in its own modules once its run is over, and exits with another code
than 0 where it finds it; rank 0 then prints no result."""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

VARS = ("TPU_SPMV_COORDINATOR", "TPU_SPMV_NUM_PROCESSES",
        "TPU_SPMV_PROCESS_ID")
# How often the watchdog looks at the ranks, and how long rank 0 waits,
# once its own run is over, for the others to end.
POLL_S = 0.25
END_S = 60.0
# The exit code of a run that another rank's failure ended.
FAILED = 4
PR_SET_PDEATHSIG = 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_command(args: list) -> list:
    """The command line of a rank other than 0: this module, with the
    run's arguments."""
    return [sys.executable, "-m", "spmv_bench.ranks", *args]


class Ranks:
    """Ranks 1..n-1 of one run, started by rank 0, and the watchdog that
    ends the run when one of them fails. Rank 0's own variables are set
    in os.environ until close()."""

    def __init__(self, n: int, args: list):
        self.coordinator = f"127.0.0.1:{free_port()}"
        self._saved = {k: os.environ.get(k) for k in VARS}
        os.environ.update(TPU_SPMV_COORDINATOR=self.coordinator,
                          TPU_SPMV_NUM_PROCESSES=str(n),
                          TPU_SPMV_PROCESS_ID="0")
        here = str(pathlib.Path(__file__).resolve().parent.parent)
        path = os.pathsep.join(
            p for p in (here, os.environ.get("PYTHONPATH")) if p)
        self.procs = []
        try:
            for r in range(1, n):
                env = dict(os.environ, TPU_SPMV_PROCESS_ID=str(r),
                           PYTHONPATH=path)
                self.procs.append(subprocess.Popen(
                    child_command([*args, "--parent", str(os.getpid())]),
                    env=env, stdin=subprocess.DEVNULL, stdout=2, stderr=2))
                print(f"spmv_bench: rank {r} pid {self.procs[-1].pid}",
                      file=sys.stderr, flush=True)
        except BaseException:
            self._kill()
            self._restore()
            raise
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _watchdog(self) -> None:
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc:
                    self._kill()
                    print(f"spmv_bench: rank {r} exited with code {rc}; the "
                          "run ends without a result", file=sys.stderr,
                          flush=True)
                    os._exit(FAILED)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _restore(self) -> None:
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def close(self, failed: bool) -> None:
        """Stop the watchdog, then wait END_S for the ranks to end (kill
        them at once when rank 0 failed). Raises SystemExit, so that the
        run prints no result, where a rank ended with another code than
        0 or had to be killed."""
        self._done.set()
        self._watch.join()
        self._restore()
        if failed:
            self._kill()
            return
        deadline = time.monotonic() + END_S
        late = []
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                late.append(r)
        self._kill()
        bad = [f"rank {r} exited with code {p.returncode}"
               for r, p in enumerate(self.procs, 1) if p.returncode]
        bad += [f"rank {r} did not end within {END_S:.0f} s" for r in late]
        if bad:
            raise SystemExit("spmv_bench: " + "; ".join(bad))


@contextlib.contextmanager
def started(n: int, args: list):
    """Ranks 1..n-1 of a run for the length of the block (None for one
    process)."""
    if n == 1:
        yield None
        return
    ranks = Ranks(n, args)
    try:
        yield ranks
    except BaseException:
        ranks.close(failed=True)
        raise
    ranks.close(failed=False)


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when rank 0 ends, and end now
    if it already has."""
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(FAILED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--config", default="{}",
                    help="JSON: keys of the configuration to override")
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with(args.parent)

    import torch

    from spmv_bench import run

    rank = int(os.environ["TPU_SPMV_PROCESS_ID"])
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda" and torch.cuda.device_count() <= rank:
        print(f"spmv_bench: rank {rank} has no CUDA card of its own; torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr, flush=True)
        return 2
    run.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 device, root=pathlib.Path(args.root),
                 config=json.loads(args.config) or None, rank=rank)
    bad = run.forbidden_modules()
    if bad:
        print(f"spmv_bench: rank {rank} loaded {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
