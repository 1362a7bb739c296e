import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    """run_cell on the CPU at the grid its configuration's `small` key
    gives (the cells' own sizes run on the card): (cell, seed, ...,
    **config keys) -> result. A cell on several cards runs its ranks
    under gloo, rank 0 in a process of its own (faults.run_group).
    fault: ("step", precond, kind), planted under the timed path of
    every rank (faults.break_step), or for a group any fault that
    faults.plant takes."""
    import faults
    from spmv_bench.run import cell_files, manifest, run_cell

    def go(cell, seed=2**31 + 11, seconds=0.3, trace=False, control=False,
           fault=None, root=ROOT, **kw):
        files = cell_files(manifest(root), cell, root)
        config = dict(files["config"]["small"], **kw)
        if files["workload"]["chips"] > 1 and not control:
            done = faults.run_group(cell, seed, seconds, trace, config,
                                    fault, root)
            assert done.returncode == 0, done.stderr[-4000:]
            return json.loads(done.stdout.splitlines()[-1])
        if fault is not None:
            faults.break_step(monkeypatch.setattr, *fault[1:])
        return run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                        root=root, config=config, control=control)

    return go
