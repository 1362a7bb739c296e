"""Runners of the program's entries, one module an entry, found by the
`entry` key of a traffic mix. A module has a class `Entry(run, csr)`
whose constructor is the set-up (the program's build, the inputs from
the seed, the warm-up of the cell's own shapes) and whose methods are
`window(seconds)` (the measured closed loop), `traced(seconds)` (the
same loop under the profiler; returns the roofline.Work it did) and
`check()` (frees the program's state, then returns {number: value} and
the count of wrong answers); `issue()` is optional."""
