"""A batch norm that normalizes with its running statistics, and the
activation that reads it, in one pass on the GPU: kernel
``csrc/bn_act.cu``.

It replaces no TPU kernel (XLA fuses an inference batch norm and its
activation into the conv before them on the TPU). On the card ATen's
``F.batch_norm`` launches a side kernel for the inverse deviation, then its
channels-last transform, at about half its bytes bound, and the activation
reads and writes the tensor a second time; the kernel reads it once and
writes it once (see the note at the top of the source).
:class:`graph.GraphModule` routes a batch norm through it wherever autograd
records nothing there.

:func:`bn_act` takes ``x``, a ``[B, C, H, W]`` NCHW view of NHWC memory
(``channels_last``), float32 or bfloat16, and the layer's float32 ``[C]``
vectors, and returns a new channels_last tensor in ``x``'s dtype holding
``act((x - mean) / sqrt(var + eps) * weight + bias)``, bit-equal to the
library chain (``F.batch_norm``'s rounding order, its output rounded to
``x``'s dtype, the activation on that; the note at the top of the source);
``act`` is one of :data:`ACTS`. A CUDA tensor launches
the kernel or raises; a CPU tensor takes :func:`bn_act_plain`. A launch
reads nothing back to the host and allocates only its output, on the
current stream, so a CUDA graph's capture records it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

#: Kernel launches since the last :func:`reset_launch_count`; the launch
#: site below adds to it, and ``ops/launches.py`` takes a CUDA graph's
#: capture's calls back off and adds them again at each replay, where the
#: captured launches run.
launch_count = 0

#: The dtypes the kernel takes.
DTYPES = (torch.float32, torch.bfloat16)
#: The activations, by the kernel's code (their index).
ACTS = ("none", "relu", "relu6", "swish")
#: Threads a block (the kernel's ``kThreads``).
THREADS = 256
#: Vector loads a thread has in flight (its ``kUnroll``).
UNROLL = 4


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def relu6(x: torch.Tensor) -> torch.Tensor:
    """ReLU6 as the port computes it: ``clamp(x, 0, 6)``."""
    return torch.clamp(x, 0.0, 6.0)


#: The library's function of each activation.
ACT_FNS = {"none": None, "relu": F.relu, "relu6": relu6, "swish": F.silu}


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: Optional[torch.Tensor], bias: torch.Tensor,
                 eps: float, act: str) -> torch.Tensor:
    """The plain version: the library chain the kernel replaces,
    ``F.batch_norm`` with the running statistics, then the activation."""
    y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
    fn = ACT_FNS[act]
    return y if fn is None else fn(y)


def launch_grid(units: int, cvecs: int, sms: int,
                blocks_per_sm: int) -> int:
    """Blocks of :data:`THREADS` over ``units`` 16-byte vectors, ``cvecs``
    a pixel: a multiple of ``cvecs / gcd(THREADS, cvecs)``, so that the
    grid's stride keeps each thread on the same channels; persistent
    blocks, as many such as fit on the card at once (``blocks_per_sm`` on
    each of ``sms``), fewer where the work, at :data:`UNROLL` vectors a
    thread a step, needs fewer, and at least one such multiple."""
    if cvecs < 1:
        raise ValueError(f"{cvecs} vectors a pixel")
    step = cvecs // math.gcd(THREADS, cvecs)
    need = -(-units // (THREADS * UNROLL))
    grid = step * max(1, min(-(-need // step), sms * blocks_per_sm // step))
    if grid * THREADS >= 2 ** 31:
        raise ValueError(f"{grid} blocks of {THREADS} exceed the grid")
    return grid


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, its functions typed."""
    global _lib
    if _lib is None:
        from ab_line_classifier_torch.ops._build import load_library

        lib = load_library("bn_act")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ablc_bn_act.argtypes = ([p] * 6 + [ctypes.c_float, i, i, ll, i,
                                               i, p])
        lib.ablc_bn_act.restype = i
        lib.ablc_bn_act_blocks_per_sm.argtypes = [i, i]
        lib.ablc_bn_act_blocks_per_sm.restype = i
        lib.ablc_error_string.argtypes = [i]
        lib.ablc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _fit(device: torch.device, bf16: bool, act: int):
    """``(SMs, blocks of the variant that fit on one at once)``."""
    with torch.cuda.device(device):
        n = _library().ablc_bn_act_blocks_per_sm(int(bf16), act)
    if n < 1:
        raise RuntimeError(f"no block of {THREADS} threads of the batch "
                           f"norm pass fits on an SM")
    return torch.cuda.get_device_properties(device).multi_processor_count, n


def _check(x: torch.Tensor, vectors) -> None:
    if x.ndim != 4 or x.dtype not in DTYPES:
        raise ValueError(f"expected a float32 or bfloat16 [B, C, H, W] "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    for v in vectors:
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (c,)
                              or not v.is_contiguous()
                              or v.device != x.device):
            raise ValueError(f"statistics and affine must be contiguous "
                             f"float32 [{c}] on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if c * x.element_size() % 16:
        raise ValueError(f"{c} channels of {x.dtype}: the kernel takes "
                         f"whole 16-byte vectors")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last (NHWC memory)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: Optional[torch.Tensor], bias: torch.Tensor, eps: float,
           act: str) -> torch.Tensor:
    """``act`` of ``x`` normalized by ``mean`` and ``var``, scaled by
    ``weight`` (``None``: 1) and shifted by ``bias``, as a new tensor
    (module docstring): the kernel for a CUDA ``x``, which raises on what
    the kernel does not take; the plain version for a CPU one."""
    global launch_count
    if not x.is_cuda:
        return bn_act_plain(x, mean, var, weight, bias, eps, act)
    code = ACTS.index(act)
    _check(x, (mean, var, weight, bias))
    out = torch.empty_like(x, memory_format=torch.channels_last)
    units = x.numel() * x.element_size() // 16
    if units == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    cvecs = x.shape[1] * x.element_size() // 16
    sms, fit = _fit(x.device, bf16, code)
    grid = launch_grid(units, cvecs, sms, fit)
    lib = _lib or _library()
    args = (x.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(),
            None if weight is None else weight.data_ptr(), bias.data_ptr(),
            float(eps), int(bf16), code, units, cvecs, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        rc = lib.ablc_bn_act(*args)
    else:
        with torch.cuda.device(x.device):
            rc = lib.ablc_bn_act(*args)
    if rc != 0:
        raise RuntimeError("batch norm kernel launch failed: "
                           + lib.ablc_error_string(rc).decode())
    launch_count += 1
    return out
