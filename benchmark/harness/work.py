"""The work a cell asks of the device, counted from the configuration's
shapes on the benchmark's own reference model (never from the program's
modules, so the count stays whatever implements the layers), and the
chip's peaks.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from reference.layers import Conv, Dense
from reference.preprocess import nearest_indices

PEAKS = {
    "bf16_flops_per_s": 989e12,   # tensor cores, bf16, dense
    "f32_flops_per_s": 67e12,     # CUDA cores, float32
    "hbm_bytes_per_s": 3.35e12,   # HBM3
}


def flops_per_frame(model: nn.Module, input_shape: Sequence[int],
                    trainable: Sequence[str] = (),
                    training: bool = False) -> float:
    """Multiply-add FLOPs (2 per MAC) of one frame through the convs
    (depthwise ones by their groups) and dense layers, from the layer
    shapes of a one-frame float32 forward on the CPU.

    ``training``: a training step's, as autograd records them when the
    layers in ``trainable`` train: each layer's forward, plus its input
    gradient (the same MACs again) where its input requires grad, plus its
    weight gradient (again) where its weight does. Elementwise work (batch
    norm, activations, the optimizer) is not counted."""
    total = 0.0
    saved = {n: p.requires_grad for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.requires_grad_(training and n.split(".", 1)[0] in trainable)

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, Conv):
            kh, kw = mod.kernel_size
            macs = out.numel() * (mod.in_channels // mod.groups) * kh * kw
        else:
            macs = out.numel() * mod.in_features
        total += 2.0 * macs
        if training:
            total += 2.0 * macs * (bool(inputs[0].requires_grad)
                                   + bool(mod.weight.requires_grad))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    try:
        with torch.set_grad_enabled(training):
            model.eval()(torch.zeros((1,) + tuple(input_shape)))
    finally:
        for h in hooks:
            h.remove()
        for n, p in model.named_parameters():
            p.requires_grad_(saved[n])
    return total


def depthwise_layers(model: nn.Module, input_shape: Sequence[int]
                     ) -> List[Tuple[Tuple[int, int, int, int], int]]:
    """``(NHWC input shape at batch 1, K)`` of every stride-1 ``SAME``
    depthwise conv of one forward, in order: the layers kernel B2 serves."""
    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append(((1, x.shape[2], x.shape[3], x.shape[1]),
                     mod.kernel_size[0]))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, Conv) and m.groups == m.in_channels > 1
             and m.stride == (1, 1) and m.tf_padding == "SAME"]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros((1,) + tuple(input_shape)))
    finally:
        for h in hooks:
            h.remove()
    return seen


def depthwise_bound_s(shape, k: int, itemsize: int) -> float:
    """Least seconds of one K x K stride-1 ``SAME`` depthwise conv on NHWC
    ``shape``: the larger of one read of x and the float32 weight plus one
    write of y at HBM speed, and the multiply-adds of the taps inside the
    image at the float32 CUDA-core peak the kernel accumulates at."""
    b, h, w, c = shape
    p = k // 2

    def taps(n):
        return sum(min(n - 1, i + p) - max(0, i - p) + 1 for i in range(n))

    flops = 2.0 * b * c * taps(h) * taps(w)
    nbytes = 2 * b * h * w * c * itemsize + k * k * c * 4
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["f32_flops_per_s"])


def depthwise_forward_bound_s(layers, batch: int, itemsize: int) -> float:
    """:func:`depthwise_bound_s` summed over a forward's B2 layers."""
    return sum(depthwise_bound_s((batch,) + tuple(s[1:]), k, itemsize)
               for s, k in layers)


def preprocess_bytes(batch: int, src_hw, out_hw, resize_mode: str,
                     out_itemsize: int) -> int:
    """Bytes a fused preprocess (kernel B1) must move: the 32-byte sectors
    of the source rows its nearest map selects, each read once, and one
    write of the output."""
    hs, ws = src_hw
    hd, wd = out_hw
    rows = np.unique(nearest_indices(hs, hd, resize_mode))
    cols = nearest_indices(ws, wd, resize_mode)
    byte_cols = (cols[:, None] * 3 + np.arange(3)).ravel()
    sectors = sum(np.unique((r * ws * 3 + byte_cols) // 32).size
                  for r in rows)
    return batch * sectors * 32 + batch * hd * wd * 3 * out_itemsize


def preprocess_bound_s(*args) -> float:
    return preprocess_bytes(*args) / PEAKS["hbm_bytes_per_s"]


def cell_work(model: nn.Module, config: dict, traffic: dict) -> Dict:
    """The counts a cell's metric readers use."""
    shape = config["input_shape"]
    itemsize = 2 if config["mixed_precision"] else 4
    trainable = config.get("train_phase", {}).get("trainable", ())
    work = {"flops_forward": flops_per_frame(model, shape),
            "flops_train": flops_per_frame(model, shape, trainable, True),
            "b2_layers": len(depthwise_layers(model, shape))}
    batch = traffic.get("chunk", traffic.get("batch"))
    work["b2_forward_bound_s"] = depthwise_forward_bound_s(
        depthwise_layers(model, shape), batch, itemsize)
    src = traffic["frame_hw"]
    work["b1_launch_bound_s"] = preprocess_bound_s(
        batch, src, shape[:2], config["resize_mode"], itemsize)
    return work
