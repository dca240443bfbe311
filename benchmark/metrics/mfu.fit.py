"""Training's share of the chip's bf16 peak over the traced epoch: each
trained frame's training FLOPs (forward, plus the input and weight
gradients the phase's trainable layers need) and each validated frame's
forward FLOPs, over the sub-window's seconds and 989 TFLOP/s."""


def read(view):
    if view.kind != "fit" or view.trace is None or not view.frames:
        return None
    flops = (view.frames * view.work["flops_train"]
             + view.val_frames * view.work["flops_forward"])
    return (100.0 * flops / view.trace.window_s
            / view.peaks["bf16_flops_per_s"])
