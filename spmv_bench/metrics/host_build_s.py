"""Host seconds of the program's build (reorder, plan, layouts, factor),
timed by the benchmark around those calls."""


def read(run):
    build = [v for k, v in run.spans.items() if k.startswith("build.")]
    return sum(build) if build else None
