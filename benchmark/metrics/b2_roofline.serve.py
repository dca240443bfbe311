"""Kernel B2 (the stride-1 depthwise conv) against its roofline in the
traced sub-window of a serve cell: max(FLOPs at the float32 peak, bytes at
3.35 TB/s) summed over a forward's B2 layers, times the forwards its
launches make, over B2's device time, found by its kernels' names."""

#: The key ``ops/launches.py`` counts this kernel's launches under, and the
#: names it has in the trace: a traced run holds the two to each other.
LAUNCHES = ("depthwise", ("depthwise_tiled", "depthwise_scalar"))


def read(view):
    if view.kind != "serve" or view.trace is None or not view.work.get(
            "b2_layers"):
        return None
    n, seconds = view.trace.kernel_time(*LAUNCHES[1])
    if n == 0 or seconds <= 0:
        return None
    forwards = n / view.work["b2_layers"]
    return 100.0 * forwards * view.work["b2_forward_bound_s"] / seconds
