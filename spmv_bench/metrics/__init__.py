"""One reader a metric, in `<metric name>.py`: `read(run)` returns the
metric's value from a finished run (spmv_bench.core.Run), or None where
the run holds nothing to read, and the harness then leaves the metric
out of the line. A reader never returns 0 for a share of a roofline."""
