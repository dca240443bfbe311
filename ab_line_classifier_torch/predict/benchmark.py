"""Serving benchmark (port of ``clip_inference_benchmark`` in
the JAX package's ``predict/benchmark.py``).

:func:`clip_inference_benchmark` measures frames/sec for end-to-end batched
clip inference through the production serving forward — device-resident
uint8 frames -> preprocess (the CUDA kernel) -> bf16 forward -> float32
softmax — steady state, timed with CUDA events. The batch-1 latency
benchmark waits for a later slice.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.graph import DepthwiseConv
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec

# Each model's config.yml HPARAMS (the card has no PyYAML to read them).
ZOO_HPARAMS = {
    "cutoffvgg16": {"LR_EXTRACT": 3e-4, "LR_FINETUNE": 9.3e-6,
                    "DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7,
                    "EXTRACT_EPOCHS": 6},
    "mobilenetv2": {"LR": 1e-4, "DROPOUT": 0.35, "L2_LAMBDA": 1e-3,
                    "NODES_DENSE0": 32, "FREEZE_IDX": 116, "CUTOFF_IDX": 115},
    "vgg16": {"LR": 0.01, "DROPOUT": 0.5, "L2_LAMBDA": 0.01,
              "NODES_DENSE0": 64, "FREEZE_IDX": -1},
    "xception": {"LR": 0.01, "DROPOUT": 0.5, "FREEZE_IDX": -1,
                 "L2_LAMBDA": 0.01},
    "efficientnetb7": {"LR": 0.1, "DROPOUT": 0.5, "L2_LAMBDA": 0.01,
                       "FREEZE_IDX": -1},
    "cnn0": {"LR": 1e-3, "DROPOUT": 0.35, "L2_LAMBDA": 1e-4,
             "NODES_DENSE0": 64, "KERNEL_SIZE": 3, "STRIDES": 1,
             "MAXPOOL_SIZE": 2, "BLOCKS": 4, "INIT_FILTERS": 32,
             "FILTER_EXP_BASE": 2},
    "custom_resnetv2": {"LR": 4.6e-5, "DROPOUT0": 0.45, "DROPOUT1": 0.40,
                        "STRIDES": 1, "BLOCKS": 2, "INIT_FILTERS": 16},
}


def build_zoo(name: str, img_dim: Tuple[int, int] = (128, 128)
              ) -> ModelSpec:
    """Mixed-precision zoo model ``name`` with its config.yml
    hyperparameters, 2 classes."""
    return build_model(name, ZOO_HPARAMS[name], tuple(img_dim) + (3,), 2,
                       mixed_precision=True)


def build_flagship(img_dim: Tuple[int, int] = (128, 128)) -> ModelSpec:
    """Mixed-precision cutoffvgg16, the production model."""
    return build_zoo("cutoffvgg16", img_dim)


def dispatch_guarded_seconds(run_many: Callable[[int], float],
                             fallback: Callable[[int], float],
                             n_iters: int) -> float:
    """Steady-state seconds for ``n_iters`` executions, defended against
    under-reporting: doubling the iterations must about double the time.
    When it does, the double-count run halved is the answer; when it does
    not, ``fallback`` (which synchronizes every iteration) is trusted.

    :param run_many: ``iters -> seconds``, synchronizing once at the end.
    :param fallback: ``iters -> seconds`` with per-iteration sync.
    """
    dt = run_many(n_iters)
    dt2 = run_many(2 * n_iters)
    if 1.5 * dt <= dt2:
        return dt2 / 2.0
    return fallback(n_iters)


def timers(fn: Callable[[], object], device: torch.device):
    """``(run_many, fallback)`` for :func:`dispatch_guarded_seconds`: CUDA
    events around the launches on a GPU, the host clock on the CPU (where
    each call finishes before it returns)."""
    if device.type != "cuda":
        def host(iters: int) -> float:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return time.perf_counter() - t0
        return host, host

    def run_many(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def fallback(iters: int) -> float:
        return sum(run_many(1) for _ in range(iters))

    return run_many, fallback


def flops_per_frame(module: nn.Module, input_shape: Tuple[int, int, int],
                    dtype: torch.dtype, device: torch.device) -> float:
    """Multiply-add FLOPs (2 per MAC) of one frame through the convs,
    depthwise convs and dense layers, counted from the layer shapes of a
    one-frame forward."""
    total = 0.0

    def conv_hook(mod, inputs, out):
        nonlocal total
        kh, kw = mod.kernel_size
        total += 2.0 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    def depthwise_hook(mod, inputs, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.weight[0, 0].numel()

    def dense_hook(mod, inputs, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.in_features

    hooks = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, DepthwiseConv):
            hooks.append(m.register_forward_hook(depthwise_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(dense_hook))
    try:
        with torch.inference_mode():
            module(torch.zeros((1,) + tuple(input_shape), dtype=dtype,
                               device=device))
    finally:
        for h in hooks:
            h.remove()
    return total


def depthwise_layer_shapes(spec: ModelSpec) -> list:
    """``(NHWC shape at batch 1, K)`` of every depthwise layer that kernel
    B2 runs in one forward of ``spec`` (stride 1, ``SAME``), in order."""
    mod = spec.module().eval()
    seen = []

    def hook(m, args):
        if m.stride == 1 and m.padding == "SAME":
            x = args[0]
            seen.append(((1, x.shape[2], x.shape[3], x.shape[1]),
                         m.weight.shape[-1]))

    hooks = [m.register_forward_pre_hook(hook) for m in mod.modules()
             if isinstance(m, DepthwiseConv)]
    try:
        with torch.no_grad():
            mod(torch.zeros((1, *spec.input_shape)))
    finally:
        for h in hooks:
            h.remove()
    return seen


def clip_inference_benchmark(batch_size: int = 512,
                             img_dim: Tuple[int, int] = (128, 128),
                             src_hw: Optional[Tuple[int, int]] = None,
                             n_warmup: int = 5, n_iters: int = 30,
                             state_dict: Optional[Dict] = None,
                             spec: Optional[ModelSpec] = None,
                             device=None, seed: int = 0,
                             verbose: bool = True) -> Dict:
    """Frames/sec for end-to-end batched clip inference of ``spec``
    (default: mixed-precision cutoffvgg16; any zoo model through
    :func:`build_zoo`) on ``device`` (default cuda).
    Weights are ``state_dict``, else a seeded Keras-style init."""
    from ab_line_classifier_torch.predict.predict import Predictor

    device = resolve_device(device)
    spec = spec or build_flagship(img_dim)
    if state_dict is None:
        gen = torch.Generator().manual_seed(seed)
        state_dict = spec.module(generator=gen).state_dict()
    predictor = Predictor(spec, state_dict, batch_size=batch_size,
                          device=device)
    src = tuple(src_hw or img_dim)
    frames = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 256, (batch_size, *src, 3), dtype=np.uint8)).to(device)

    for _ in range(n_warmup):
        predictor.forward(frames)
    run_many, fallback = timers(lambda: predictor.forward(frames), device)
    dt = dispatch_guarded_seconds(run_many, fallback, n_iters)
    fps = batch_size * n_iters / dt
    result = {
        "frames_per_sec": float(fps),
        "batch_size": batch_size,
        "ms_per_batch": float(dt / n_iters * 1000),
        "model": spec.name,
        "src_hw": list(src),
        "flops_per_frame": flops_per_frame(
            predictor.module, spec.input_shape, spec.dtype, device),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if verbose:
        print(f"{spec.name} clip inference on {result['device']}: "
              f"{fps:,.0f} frames/sec (batch {batch_size}, "
              f"{result['ms_per_batch']:.2f} ms/batch)")
    return result
