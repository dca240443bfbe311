"""Kernel B1 (the fused preprocess) against its bytes bound: the least time
of a launch (the source sectors its nearest map selects read once, the
output written once, at 3.35 TB/s) over its mean device time a launch in
the traced sub-window, found by its kernel's name."""

#: The key ``ops/launches.py`` counts this kernel's launches under, and the
#: names it has in the trace: a traced run holds the two to each other.
LAUNCHES = ("preprocess", ("preprocess_kernel",))


def read(view):
    if view.kind != "serve" or view.trace is None:
        return None
    n, seconds = view.trace.kernel_time(*LAUNCHES[1])
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * view.work["b1_launch_bound_s"] / seconds
