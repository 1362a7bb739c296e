"""Host seconds of the program's plan (tune/model.tpu_plan), from its
own build.plan spans where no other build phase encloses them."""

from spmv_bench.spans import phase_s


def read(run):
    return phase_s("build.plan")
