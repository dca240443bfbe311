"""A conv's bias, ReLU and 2x2 max-pool in one pass on the GPU: kernel
``csrc/conv_epilogue.cu``.

It replaces no TPU kernel (XLA fuses a conv's epilogue into the conv on
the TPU). On the card cuDNN runs the conv without its bias, and PyTorch's
bias add, ReLU and max-pool then read and write the conv's output three
times; the kernel reads it once and writes it once, or only its pooled
quarter (see the note at the top of the source). :class:`graph.GraphModule`
routes a conv through it wherever autograd records nothing there.

:func:`conv_epilogue` takes the conv's output ``y`` without its bias, a
``[B, C, H, W]`` NCHW view of NHWC memory (``channels_last``), and the
bias ``[C]`` in ``y``'s dtype, and computes ``relu?(y + bias)`` as
PyTorch's ``add_`` and ``clamp_min`` round it: in place into ``y``, or,
with ``pool``, into a new ``[B, C, H // 2, W // 2]`` channels_last tensor
holding each 2x2 window's max (``F.max_pool2d(., 2, 2)``: odd rows and
columns dropped, a NaN wins). A CUDA tensor launches the kernel or raises;
a CPU tensor takes :func:`conv_epilogue_plain`. A launch reads nothing back
to the host and allocates only the pooled output, on the current stream,
so a CUDA graph's capture records it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ab_line_classifier_torch.ops._build import Kernel, check_nhwc

#: The conv's activations the kernel applies, by the names
#: ``bn_act_cuda.ACTS`` gives them.
ACTS = ("none", "relu")
#: The pool it takes from the conv's reader, as the graph's node states it
#: (``LayerSpec.op``).
POOL = ("max_pool", (2, 2), (2, 2), "VALID")
#: Threads per block at most (the kernels' ``__launch_bounds__``).
MAX_THREADS = 256
#: Vector loads a thread has in flight in the in-place kernel (its
#: ``kUnroll``).
UNROLL = 4

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("conv_epilogue", "epilogue",
                ablc_conv_epilogue=[_p, _p, _p, _i, _i, _ll] + [_i] * 7
                + [_p],
                ablc_conv_epilogue_blocks_per_sm=[_i] * 4)


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, relu: bool,
                        pool: bool) -> torch.Tensor:
    """The plain version: PyTorch's bias add, ReLU and 2x2 max-pool, in
    place into ``y`` unless ``pool`` (then ``y`` is left as it was)."""
    b = bias.view(1, -1, 1, 1)
    z = y + b if pool else y.add_(b)
    if relu:
        z = torch.relu_(z)
    return F.max_pool2d(z, 2, 2) if pool else z


def block_threads(cvecs: int) -> int:
    """Threads a block for ``cvecs`` vectors a pixel: the most up to
    :data:`MAX_THREADS` that is a multiple of ``cvecs``."""
    if not 0 < cvecs <= MAX_THREADS:
        raise ValueError(f"{cvecs} vectors a pixel: the kernel takes 1 to "
                         f"{MAX_THREADS}")
    return MAX_THREADS - MAX_THREADS % cvecs


def launch_geometry(units: int, cvecs: int, sms: int, blocks_per_sm: int,
                    per_thread: int = 1) -> Tuple[int, int]:
    """``(threads, grid)`` over ``units`` 16-byte vectors, ``cvecs`` a
    pixel: blocks of a multiple of ``cvecs`` threads, so that the grid's
    stride keeps each thread on the same channels; persistent blocks, as
    many as fit on the card at once (``blocks_per_sm`` on each of
    ``sms``), fewer where the work, at ``per_thread`` vectors a thread a
    step, needs fewer."""
    threads = block_threads(cvecs)
    need = -(-units // (threads * per_thread))
    grid = max(1, min(need, sms * blocks_per_sm))
    if grid * threads >= 2 ** 31:
        raise ValueError(f"{grid} blocks of {threads} exceed the grid")
    return threads, grid


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    check_nhwc(y, "y")
    c = y.shape[1]
    if (bias.dtype != y.dtype or tuple(bias.shape) != (c,)
            or not bias.is_contiguous() or bias.device != y.device):
        raise ValueError(f"bias must be contiguous {y.dtype} [{c}] on "
                         f"{y.device}, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool,
                  pool: bool) -> torch.Tensor:
    """``relu?(y + bias)`` in place into ``y``, or with ``pool`` its 2x2
    max-pool as a new tensor (module docstring): the kernel for a CUDA
    ``y``, which raises on what the kernel does not take; the plain version
    for a CPU one."""
    if not y.is_cuda:
        return conv_epilogue_plain(y, bias, relu, pool)
    _check(y, bias)
    b, c, h, w = y.shape
    cvecs = c * y.element_size() // 16
    out = None
    if pool:
        out = torch.empty((b, c, h // 2, w // 2), dtype=y.dtype,
                          device=y.device,
                          memory_format=torch.channels_last)
        if b * (h // 2) * (w // 2) >= 2 ** 31:
            raise ValueError(f"shape {tuple(y.shape)} exceeds the kernel's "
                             f"32-bit pixel index")
        units = out.numel() * y.element_size() // 16
    else:
        units = y.numel() * y.element_size() // 16
    if units == 0:
        return y if out is None else out
    bf16 = y.dtype == torch.bfloat16
    sms, fit = KERNEL.occupancy("ablc_conv_epilogue_blocks_per_sm", y.device,
                                int(bf16), int(relu), int(pool),
                                block_threads(cvecs))
    threads, grid = launch_geometry(units, cvecs, sms, fit,
                                    1 if pool else UNROLL)
    KERNEL.launch("ablc_conv_epilogue", y.device, y.data_ptr(),
                  bias.data_ptr(), None if out is None else out.data_ptr(),
                  int(bf16), int(relu), units, h, w, h // 2, w // 2, cvecs,
                  grid, threads)
    return y if out is None else out
