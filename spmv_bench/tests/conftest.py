import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small grids that a CPU run holds; the cells' own sizes run on the card.
SMALL = {"ecology1": {"nx": 48, "ny": 40},
         "hpcg_104": {"nx": 12, "ny": 10, "nz": 8}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small():
    """run_cell on the CPU at a small grid: (cell, seed, **kw) -> result."""
    from spmv_bench.run import cell_files, manifest, run_cell

    def go(cell, seed=2**31 + 11, seconds=0.3, trace=False, control=False,
           **kw):
        config = cell_files(manifest(), cell)["workload"]["config"]
        return run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                        config=dict(SMALL[config], **kw), control=control)

    return go
