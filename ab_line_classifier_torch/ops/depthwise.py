"""Depthwise convolution (port of the JAX package's
``ops/depthwise_pallas.py``): kernel B2's plain version, the grouped-conv
reference, and :func:`depthwise_conv`, the entry point every
``DepthwiseConv`` layer calls.

Layouts follow PyTorch's grouped conv: ``x`` is an NCHW ``[B, C, H, W]``
tensor (the graph's channels_last views of NHWC memory) and ``w`` is
``[C, 1, K, K]``.

* :func:`depthwise_reference` is the grouped ``F.conv2d``, the counterpart
  of the JAX package's ``_lax_reference``. It computes every configuration
  the kernel does not take (stride 2, ``VALID``), as the JAX package does
  outside its Pallas kernel.
* :func:`depthwise_plain` is the kernel's plain version: a float32
  shift-MAC, ``dw`` outer and ``dh`` inner, as the Pallas ``_kernel``.
  The CUDA kernel (``csrc/depthwise.cu``) sums the same products in the
  same order with rounded multiplies and adds, so the two agree exactly.
* :func:`depthwise_conv`: for a supported layer (:func:`_supported`:
  stride 1, ``SAME``, square odd K up to 7) an autograd function whose
  forward launches the CUDA kernel for a CUDA tensor and runs the plain
  version for a CPU tensor, and whose backward is the grouped conv's
  gradients, as the JAX ``custom_vjp`` is. There is no switch: on CUDA a
  supported layer always launches the kernel, and a failed build or launch
  raises. Under ``torch.func.vmap`` (stacked trials with per-trial
  weights) it launches once over all trials (:func:`depthwise_trials`),
  the counterpart of the trial axis that JAX's ``vmap`` adds to the
  Pallas grid.

On the H100 a K x K depthwise conv is bound by bytes, not operations: it
does 2K^2 FLOP per element against 4 bytes moved in bf16 (4.5 FLOP/byte at
K=3, 12.5 at K=5), below the card's ~20 FLOP/byte balance of float32 CUDA
cores to HBM.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ab_line_classifier_torch.ops import depthwise_cuda
from ab_line_classifier_torch.ops.padding import pad_same


def depthwise_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """Grouped-conv depthwise convolution, TF ``SAME`` or ``VALID``."""
    if padding == "SAME":
        x = pad_same(x, tuple(w.shape[2:]), (stride, stride))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=x.shape[1])


def depthwise_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version (stride 1, ``SAME``, odd K): zero-pad,
    then accumulate ``x[.., h+dh, w+dw] * w[c, dh, dw]`` in float32, ``dw``
    outer and ``dh`` inner; the result in ``x``'s dtype."""
    _, c, h, wd = x.shape
    k = w.shape[-1]
    p = k // 2
    xp = F.pad(x.to(torch.float32), (p, p, p, p))
    taps = w.to(torch.float32)
    acc = None
    for dw in range(k):
        col = xp[:, :, :, dw:dw + wd]
        for dh in range(k):
            tap = taps[:, 0, dh, dw].view(1, c, 1, 1)
            term = col[:, :, dh:dh + h, :] * tap
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def _supported(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: str) -> bool:
    k, kw = int(w.shape[2]), int(w.shape[3])
    return (stride == 1 and padding == "SAME" and k == kw and k % 2 == 1
            and k <= 7 and x.ndim == 4 and w.shape[1] == 1
            and w.shape[0] == x.shape[1])


class _DepthwiseConv(torch.autograd.Function):
    """Forward: the CUDA kernel (CUDA tensor) or its plain version (CPU
    tensor). Backward: the grouped conv's input and weight gradients.
    Under ``torch.func.vmap`` (stacked trials, per-trial weights) it runs
    once over all trials (:meth:`vmap`)."""

    @staticmethod
    def forward(x, w, packed):
        if x.device.type == "cpu":
            return depthwise_plain(x, w)
        if packed is None:
            packed = depthwise_cuda.pack_weight(w)
        return depthwise_cuda.cuda_depthwise(x, packed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        c, p = x.shape[1], w.shape[-1] // 2
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w.to(g.dtype), g,
                                            padding=p, groups=c)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x.to(g.dtype), w.shape, g,
                                             padding=p, groups=c).to(w.dtype)
        return gx, gw, None

    @staticmethod
    def vmap(info, in_dims, x, w, packed):
        """The batching rule: trial t's ``[B, C, H, W]`` input and ``[C, 1,
        K, K]`` weight at index t of the vmapped axis, as one launch over
        ``F * C`` channels (:func:`depthwise_trials`)."""
        x_dim, w_dim, _ = in_dims
        n = info.batch_size
        x = (x.movedim(x_dim, 1) if x_dim is not None
             else x.unsqueeze(1).expand(-1, n, -1, -1, -1))
        w = (w.movedim(w_dim, 0) if w_dim is not None
             else w.unsqueeze(0).expand(n, -1, -1, -1, -1))
        return depthwise_trials(x, w), 1


def depthwise_trials(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """F trials' depthwise convs in one launch of the kernel (its plain
    version on the CPU): ``x`` ``[B, F, C, H, W]``, trial t's activations
    at ``x[:, t]``, and ``w`` ``[F, C, 1, K, K]``. The trials become the
    ``F * C`` channels of one ``[B, F * C, H, W]`` tensor, which is a view
    when ``x`` lies in memory as ``[B, H, W, F, C]`` (what vmap's conv and
    batch-norm rules leave in channels_last: trial-major channels); the
    weight packs to ``[K, K, F * C]``. Each output channel is computed
    from its own input channel and taps alone, so trial t's result is
    what a launch on its own would give, bit for bit. Autograd records
    one grouped conv over ``F * C`` channels for the backward. Returns
    ``[B, F, C, H, W]``."""
    b, f, c, h, wd = x.shape
    y = _DepthwiseConv.apply(x.reshape(b, f * c, h, wd),
                             w.reshape(f * c, 1, *w.shape[-2:]), None)
    return y.unflatten(1, (f, c))


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                   padding: str = "SAME",
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise conv: kernel B2 (or, on the CPU, its plain version) for a
    supported layer, the grouped conv otherwise. ``packed`` is ``w``
    repacked for the kernel (``depthwise_cuda.pack_weight``), which a layer
    caches; without it a CUDA call repacks."""
    if _supported(x, w, stride, padding):
        return _DepthwiseConv.apply(x, w, packed)
    return depthwise_reference(x, w, stride, padding)
