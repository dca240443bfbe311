"""Serving's share of the chip's bf16 peak: the frames served in the traced
sub-window times the forward FLOPs of a frame (the benchmark's count on its
reference model), over the sub-window's seconds and 989 TFLOP/s."""


def read(view):
    if view.kind != "serve" or view.trace is None or not view.frames:
        return None
    return (100.0 * view.frames * view.work["flops_forward"]
            / view.trace.window_s / view.peaks["bf16_flops_per_s"])
