"""Depthwise convolution on the GPU: kernel ``csrc/depthwise.cu``.

It replaces the JAX package's TPU kernel
``ops/depthwise_pallas.py::_kernel``: a K x K depthwise conv at stride 1
with zero ``SAME`` padding, odd K up to 7, bfloat16 or float32 NHWC input,
float32 accumulation and output in the input's dtype. The TPU kernel
shift-MACs whole (W-sublane x C-lane) tiles in VMEM and groups its terms by
column shift to save sublane relayouts; on the GPU each thread computes one
output element, channels fastest so that a warp's loads of each tap
coalesce, and the caches serve the K^2-fold reuse of each input element.
See ``ops/depthwise.py`` for the entry point and the plain version.

:func:`cuda_depthwise` takes the graph's NCHW tensor whose memory is NHWC
(``channels_last``); any other layout is copied to it first. The weight
comes repacked once per layer to float32 ``[K, K, C]``
(:func:`pack_weight`). The output is NHWC memory, returned as the NCHW
view, on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes

import torch

#: Kernel launches since the last :func:`reset_launch_count`; only the
#: launch site below adds to it.
launch_count = 0

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``[C, 1, K, K]`` depthwise weight -> contiguous float32 ``[K, K, C]``
    (the taps of one (dh, dw) contiguous over channels)."""
    c, _, k, kw = w.shape
    return (w.detach().to(torch.float32).permute(2, 3, 0, 1)
            .reshape(k, kw, c).contiguous())


def _bind(lib: ctypes.CDLL):
    fn = lib.ablc_depthwise
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, ctypes.c_longlong, i, i, i, i, p]
        fn.restype = i
        lib.ablc_error_string.argtypes = [i]
        lib.ablc_error_string.restype = ctypes.c_char_p
    return fn


def cuda_depthwise(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA ``[B, C, H, W]`` tensor with a packed
    ``[K, K, C]`` float32 weight (stride 1, zero ``SAME`` padding)."""
    global launch_count
    from ab_line_classifier_torch.ops._build import load_library

    if x.device.type != "cuda":
        raise ValueError(f"cuda_depthwise needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"expected a float32 or bfloat16 [B, C, H, W] "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    k = packed.shape[0]
    if (packed.dtype != torch.float32 or tuple(packed.shape) != (k, k, c)
            or not packed.is_contiguous() or packed.device != x.device):
        raise ValueError(f"packed weight must be contiguous float32 "
                         f"[K, K, {c}] on {x.device}, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if k % 2 != 1 or k > 7:
        raise ValueError(f"kernel size {k}: the kernel takes odd K <= 7")
    if b * h >= 2 ** 31 or w * c >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the grid")
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        xh = xh.contiguous()
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y.permute(0, 3, 1, 2)

    lib = load_library("depthwise")
    fn = _bind(lib)
    with torch.cuda.device(x.device):
        rc = fn(xh.data_ptr(), packed.data_ptr(), y.data_ptr(),
                int(x.dtype == torch.bfloat16), b * h, h, w, c, k,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("depthwise kernel launch failed: "
                           + lib.ablc_error_string(rc).decode())
    launch_count += 1
    return y.permute(0, 3, 1, 2)
