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
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

#: Kernel launches since the last :func:`reset_launch_count`; the launch
#: site below adds to it, and ``ops/launches.py`` takes a CUDA graph's
#: capture's calls back off and adds them again at each replay, where the
#: captured launches run.
launch_count = 0

#: The dtypes the kernel takes.
DTYPES = (torch.float32, torch.bfloat16)
#: Threads per block at most (the kernels' ``__launch_bounds__``).
MAX_THREADS = 256
#: Vector loads a thread has in flight in the in-place kernel (its
#: ``kUnroll``).
UNROLL = 4


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its functions typed."""
    global _lib
    if _lib is None:
        from ab_line_classifier_torch.ops._build import load_library

        lib = load_library("conv_epilogue")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ablc_conv_epilogue.argtypes = ([p, p, p, i, i, ll] + [i] * 7
                                           + [p])
        lib.ablc_conv_epilogue.restype = i
        lib.ablc_conv_epilogue_blocks_per_sm.argtypes = [i] * 4
        lib.ablc_conv_epilogue_blocks_per_sm.restype = i
        lib.ablc_error_string.argtypes = [i]
        lib.ablc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _fit(device: torch.device, bf16: bool, relu: bool, pool: bool,
         threads: int):
    """``(SMs, blocks of the variant that fit on one at once)``."""
    with torch.cuda.device(device):
        n = _library().ablc_conv_epilogue_blocks_per_sm(
            int(bf16), int(relu), int(pool), threads)
    if n < 1:
        raise RuntimeError(f"no block of {threads} threads of the conv "
                           f"epilogue fits on an SM")
    return torch.cuda.get_device_properties(device).multi_processor_count, n


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.ndim != 4 or y.dtype not in DTYPES:
        raise ValueError(f"expected a float32 or bfloat16 [B, C, H, W] "
                         f"tensor, got {tuple(y.shape)} {y.dtype}")
    c = y.shape[1]
    if (bias.dtype != y.dtype or tuple(bias.shape) != (c,)
            or not bias.is_contiguous() or bias.device != y.device):
        raise ValueError(f"bias must be contiguous {y.dtype} [{c}] on "
                         f"{y.device}, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")
    if c * y.element_size() % 16:
        raise ValueError(f"{c} channels of {y.dtype}: the kernel takes "
                         f"whole 16-byte vectors")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be channels_last (NHWC memory)")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool,
                  pool: bool) -> torch.Tensor:
    """``relu?(y + bias)`` in place into ``y``, or with ``pool`` its 2x2
    max-pool as a new tensor (module docstring): the kernel for a CUDA
    ``y``, which raises on what the kernel does not take; the plain version
    for a CPU one."""
    global launch_count
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
    sms, fit = _fit(y.device, bf16, relu, pool, block_threads(cvecs))
    threads, grid = launch_geometry(units, cvecs, sms, fit,
                                    1 if pool else UNROLL)
    lib = _lib or _library()
    args = (y.data_ptr(), bias.data_ptr(),
            None if out is None else out.data_ptr(), int(bf16), int(relu),
            units, h, w, h // 2, w // 2, cvecs, grid, threads,
            torch.cuda.current_stream(y.device).cuda_stream)
    if y.device.index == torch.cuda.current_device():
        rc = lib.ablc_conv_epilogue(*args)
    else:
        with torch.cuda.device(y.device):
            rc = lib.ablc_conv_epilogue(*args)
    if rc != 0:
        raise RuntimeError("conv epilogue kernel launch failed: "
                           + lib.ablc_error_string(rc).decode())
    launch_count += 1
    return y if out is None else out
