"""The pointwise chain's share of the device's busy time in the traced
sub-window of a serve cell: the batch norms (ATen's channels-last
transform, its 64-bit general path and the per-layer inverse deviation),
the swish (SiLU), the squeeze-excite gate's sigmoid and its broadcast
multiply, found by their kernels' names in the cell's first trace (H100,
PyTorch 2.11). Inside a CUDA-graph replay the program's spans record
nothing, so the device trace is what sees these layers."""

#: Substrings of the kernels' names in the trace. The multiply is the
#: bfloat16 tensor-by-tensor one: the 55 gates and the stem's one
#: per-channel rescale (0.1% of it), not the stem's scalar x / 255.
KERNELS = ("batch_norm", "silu_kernel", "sigmoid_kernel",
           "BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, "
           "at::native::binary_internal::MulFunctor")


def read(view):
    if view.kind != "serve" or view.trace is None or view.trace.busy_s <= 0:
        return None
    n, seconds = view.trace.kernel_time(*KERNELS)
    if n == 0:
        return None
    return 100.0 * seconds / view.trace.busy_s
