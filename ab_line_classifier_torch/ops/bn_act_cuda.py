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
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ab_line_classifier_torch.ops._build import Kernel, check_nhwc

#: The activations, by the kernel's code (their index).
ACTS = ("none", "relu", "relu6", "swish")
#: Threads a block (the kernel's ``kThreads``).
THREADS = 256
#: Vector loads a thread has in flight (its ``kUnroll``).
UNROLL = 4

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = Kernel("bn_act", "bn_act",
                ablc_bn_act=[_p] * 6 + [ctypes.c_float, _i, _i, _ll, _i, _i,
                                        _p],
                ablc_bn_act_blocks_per_sm=[_i, _i])


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


def _check(x: torch.Tensor, vectors) -> None:
    check_nhwc(x, "x")
    c = x.shape[1]
    for v in vectors:
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (c,)
                              or not v.is_contiguous()
                              or v.device != x.device):
            raise ValueError(f"statistics and affine must be contiguous "
                             f"float32 [{c}] on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: Optional[torch.Tensor], bias: torch.Tensor, eps: float,
           act: str) -> torch.Tensor:
    """``act`` of ``x`` normalized by ``mean`` and ``var``, scaled by
    ``weight`` (``None``: 1) and shifted by ``bias``, as a new tensor
    (module docstring): the kernel for a CUDA ``x``, which raises on what
    the kernel does not take; the plain version for a CPU one."""
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
    sms, fit = KERNEL.occupancy("ablc_bn_act_blocks_per_sm", x.device,
                                int(bf16), code)
    KERNEL.launch("ablc_bn_act", x.device, x.data_ptr(), out.data_ptr(),
                  mean.data_ptr(), var.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  bias.data_ptr(), float(eps), int(bf16), code, units, cvecs,
                  launch_grid(units, cvecs, sms, fit))
    return out
