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
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec

CUTOFFVGG16_HPARAMS = {"LR_EXTRACT": 3e-4, "LR_FINETUNE": 9.3e-6,
                       "DROPOUT": 0.45, "CUTOFF_LAYER": 10,
                       "FINETUNE_LAYER": 7, "EXTRACT_EPOCHS": 6}


def build_flagship(img_dim: Tuple[int, int] = (128, 128)) -> ModelSpec:
    """Mixed-precision cutoffvgg16 with its config.yml hyperparameters."""
    return build_model("cutoffvgg16", CUTOFFVGG16_HPARAMS,
                       tuple(img_dim) + (3,), 2, mixed_precision=True)


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
    """Multiply-add FLOPs (2 per MAC) of one frame through the convs and
    dense layers, counted from the layer shapes of a one-frame forward."""
    total = 0.0

    def conv_hook(mod, inputs, out):
        nonlocal total
        kh, kw = mod.kernel_size
        total += 2.0 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    def dense_hook(mod, inputs, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.in_features

    hooks = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
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


def clip_inference_benchmark(batch_size: int = 512,
                             img_dim: Tuple[int, int] = (128, 128),
                             src_hw: Optional[Tuple[int, int]] = None,
                             n_warmup: int = 5, n_iters: int = 30,
                             state_dict: Optional[Dict] = None,
                             spec: Optional[ModelSpec] = None,
                             device=None, seed: int = 0,
                             verbose: bool = True) -> Dict:
    """Frames/sec for end-to-end batched clip inference of ``spec``
    (default: mixed-precision cutoffvgg16) on ``device`` (default cuda).
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
