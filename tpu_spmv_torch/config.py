"""Run configuration: the reference's config-file format plus env knobs.

The port's copy of `tpu_spmv.config` (host code, no device), held
equal to it by tests/test_torch_tools.py.

The reference has four config mechanisms (SURVEY.md §5): positional argv,
a (dormant) whitespace config file parsed by readConfigFile
(spmv-csrk/csrk.cpp:15-54), OMP_* environment variables set by runners
(run_scripts/run_cuda_new.py:75-79), and build-time defines. This module
covers the first three in one place:

  * `RunConfig.parse_file` reads the reference's exact format:
      SpMV <coarsenType> <k> <supRowSizes...>
      STS  <orderingType> <coarsenType> <k> <supRowSizes...>
  * `RunConfig.from_env` reads TPU_SPMV_* environment variables (the
    TPU-native replacement for OMP_NUM_THREADS/OMP_SCHEDULE).
"""

from __future__ import annotations

import dataclasses
import os

_COARSEN_ALIASES = {
    "hand": "hand",
    "rand": "random",
    "random": "random",
    "hem": "heavy",
    "heavy": "heavy",
    "lem": "light",
    "light": "light",
}


@dataclasses.dataclass
class RunConfig:
    """Kernel/preprocessing configuration."""

    kernel_type: str = "SpMV"  # "SpMV" | "STS"
    ordering_type: str = "none"  # STS: "LS" | "COLOR"
    coarsen_type: str = "hand"  # "hand" | "random" | "heavy" | "light"
    k: int = 2
    sup_row_sizes: tuple = ()
    # TPU execution knobs (no reference analog; replaces OMP_* env).
    kernel: str = "auto"  # "auto" | "ranked" | "plain" | "segsum" | "bcoo"
    tile_k: int = 512
    num_runs: int = 20

    @classmethod
    def parse_file(cls, path: str) -> "RunConfig":
        """Parse the reference's whitespace-token config format
        (readConfigFile, spmv-csrk/csrk.cpp:15-54)."""
        with open(path) as f:
            tokens = f.read().split()
        if not tokens:
            raise ValueError(f"empty config file: {path}")
        it = iter(tokens)
        kernel_type = next(it)
        if kernel_type == "SpMV":
            ordering = "none"
            coarsen = next(it)
            k = int(next(it))
            n_sizes = k - 1
        elif kernel_type == "STS":
            ordering = next(it)
            coarsen = next(it)
            k = int(next(it))
            n_sizes = k - 2
        else:
            raise ValueError(f"unsupported kernel type {kernel_type!r}")
        sizes = tuple(int(next(it)) for _ in range(max(n_sizes, 0)))
        coarsen = _COARSEN_ALIASES.get(coarsen.lower())
        if coarsen is None:
            raise ValueError(f"unknown coarsening type in {path}")
        return cls(
            kernel_type=kernel_type,
            ordering_type=ordering,
            coarsen_type=coarsen,
            k=k,
            sup_row_sizes=sizes,
        )

    @classmethod
    def from_env(cls, base: "RunConfig | None" = None) -> "RunConfig":
        """Overlay TPU_SPMV_* environment variables on `base`."""
        cfg = dataclasses.replace(base) if base else cls()
        env = os.environ
        if "TPU_SPMV_KERNEL" in env:
            cfg.kernel = env["TPU_SPMV_KERNEL"]
        if "TPU_SPMV_TILE_K" in env:
            cfg.tile_k = int(env["TPU_SPMV_TILE_K"])
        if "TPU_SPMV_NUM_RUNS" in env:
            cfg.num_runs = int(env["TPU_SPMV_NUM_RUNS"])
        if "TPU_SPMV_K" in env:
            cfg.k = int(env["TPU_SPMV_K"])
        if "TPU_SPMV_SUP_ROW_SIZES" in env:
            cfg.sup_row_sizes = tuple(
                int(t) for t in env["TPU_SPMV_SUP_ROW_SIZES"].replace(",", " ").split()
            )
        return cfg

    def write_file(self, path: str) -> None:
        """Emit the reference-format config file."""
        with open(path, "w") as f:
            if self.kernel_type == "SpMV":
                f.write(f"SpMV {self.coarsen_type} {self.k} ")
            else:
                f.write(
                    f"STS {self.ordering_type} {self.coarsen_type} {self.k} "
                )
            f.write(" ".join(str(s) for s in self.sup_row_sizes))
            f.write("\n")
