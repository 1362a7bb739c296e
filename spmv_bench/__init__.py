"""The benchmark of `tpu_spmv_torch` on one CUDA card.

`python -m spmv_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON
line. Everything a cell needs is found by name: its configuration in
`configs/`, its traffic mix in `traffic/`, the runner of the port's entry
in `entries/`, its limits in `cells/`, each metric's reader in
`metrics/`. See README.md.
"""
