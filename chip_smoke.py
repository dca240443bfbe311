#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ab_line_classifier_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and serves.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. device — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel from ``ab_line_classifier_torch/csrc`` into
   ``build/kernels``, one nvcc per source, all started together; ptxas's
   registers and spills of each instance of the depthwise kernel;
3. preprocess kernel (B1) — against its plain PyTorch version over modes x
   resize maps x masks x output dtypes and several source sizes, plus 2048
   frames of 1080x1440 (past 2^31 bytes: the 64-bit offsets), and the
   shapes of the Grad-CAM batches and a batch-1 latency step in every mode
   and output dtype; then, at the serving path's shapes, the same
   comparison and the kernel's time, the plain
   version's, a resize-only library yardstick
   (``F.interpolate(mode="nearest-exact")``, which the port never calls)
   and the bytes-moved bound;
4. depthwise kernel (B2) — against its plain version, exactly
   (``torch.equal``), over K 1/3/5/7 x dtypes x channel counts (multiples
   of the 16-byte vector or not) x frame sizes x batch, inputs whose data
   pointer is not 16-byte aligned, an input that is not channels_last (one
   counted copy), one f32 input past 2^31 bytes, every distinct stride-1
   shape of the three depthwise models at batch 256 (Grad-CAM) and of
   mobilenetv2 at batch 1 (latency) in bf16 and f32, and of mobilenetv2
   at batch 2048 and of xception and efficientnetb7 at 512 (serving) in
   bf16; at mobilenetv2's shapes and efficientnetb7's
   largest 5x5 one the kernel's time, the plain version's, cuDNN's grouped
   conv (``F.conv2d(groups=C)``, which the port never calls) and the
   bound, and per forward of each of the three models the kernel's time
   summed over its layers beside cuDNN's and the bound;
5. cutoffvgg16 serving — full width (mixed precision, 128x128, random
   weights from a numpy seed through the weight bridge), 4096 frames of
   480x640 and 4096 of 128x128 through ``Predictor``, then clip grouping
   and all three aggregations on the card; B1's launch count on this phase
   alone must be > 0. The served forward is held against the same port on
   the CPU at ``block3_conv3`` and the logits;
6. mobilenetv2 serving — the same at full width, with batch-norm
   statistics set from a calibration batch; B2 launches exactly 10 times
   per forward and copies no input; GPU against CPU at ``block_12_add``
   and the logits;
7. xception and efficientnetb7 serving — 1024 frames at batch 256 through
   ``Predictor``, 34 and 51 B2 launches per forward and no input copy, GPU
   against CPU at one tap each;
8. throughput — ``clip_inference_benchmark`` for cutoffvgg16 and
   mobilenetv2 at batch 1024 and 2048 and for xception and efficientnetb7
   at 512 (each run's kernel launches counted), and a ``torch.profiler``
   breakdown by kernel of a cutoffvgg16 and a mobilenetv2 batch, with the
   copy and fill kernels attributed to the PyTorch operators that launch
   them;
9. Grad-CAM — cutoffvgg16, mobilenetv2, xception and efficientnetb7 (the
   weights of phases 5-7), 512 frames of 480x640 and 512 of 128x128 in
   batches of 256 through ``GradCAMExplainer.explain_frames``, both modes:
   B1 launches once and B2 0 / 10 / 34 / 51 times per batch, no input
   copied; GPU (in batches of 256) against the port on the CPU, in bf16
   and float32, on 16 lit frames whose top-2 margin clears the probability
   bar (drawn from up to 64), with channel-swap and frame-order faults;
   ``gradcam_benchmark`` beside ``clip_inference_benchmark`` at batch 256;
   a profile of a cutoffvgg16 and a mobilenetv2 Grad-CAM batch;
10. batch-1 latency — ``single_frame_latency_benchmark`` of cutoffvgg16 and
   mobilenetv2 (a dependency chain captured once as a CUDA graph and
   replayed, and run eagerly; the replayed chain's probabilities equal to
   the eager chain's, and against ``Predictor`` on the CPU), the launches
   captured per step, the kernels one replay runs (the profiler's count),
   and ``clock_avg_runtime``.

The last two lines of standard output are a JSON line of per-kernel
numbers (launches per path: the wrappers' counts, which tick once at a
CUDA graph's capture; the kernel's runs in one replay of each latency
graph, counted by the profiler, and the replays) and
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

OUT_HW = (128, 128)
MAIN_BATCH = 2048
ZOO_BATCH = 256
# The bf16 serving tolerance of the port's tests (tests/test_torch_model.py).
BF16_PROB_ATOL = 2e-2
# GPU vs CPU (both bf16) at a tap and the logits: relative Frobenius
# error. The script prints the CPU's own bf16-vs-float32 difference beside
# it (the rounding floor). Two bf16 computations of the same float32
# function each sit about one floor away from it, so the bar is the larger
# of ACT_RTOL and twice the floor; frames with their channels swapped — a
# channel-order fault — must land beyond three times the bar.
ACT_RTOL = 3e-2
# A bar above this is too loose to hold anything to: the serving phases
# fail there; Grad-CAM's bf16 heatmaps are then held in float32 only.
BAR_CEILING = 0.3
# Grad-CAM GPU vs CPU: lit check frames are drawn, CHECK_KEEP at a time,
# until CHECK_KEEP of them clear the top-2 margin, at most CHECK_DRAW.
CHECK_DRAW, CHECK_KEEP = 64, 16
# GPU vs CPU in float32 (TF32 off): relative Frobenius error. The two sum in
# other orders, float32 rounding (2^-24) amplified by cancellation.
F32_RTOL = 1e-3
# Kernels scaled by GAIN / sqrt(fan_in), as in tests/test_torch_model.py,
# so the logits are O(1) and vary from frame to frame.
GAIN = 1.5
# Batch-norm scale of the zoo's random weights; the BN statistics are then
# set from a calibration batch (graph.adapt_batch_norm), as in
# tests/test_torch_zoo.py. At 0.4, efficientnetb7's 55 random blocks
# amplify bf16 rounding until its bf16 and float32 logits no longer agree
# within the bars below; at 0.15 they do.
BN_SCALE = {"efficientnetb7": 0.15}
DEFAULT_BN_SCALE = 0.4
WARMUP, ITERS = 3, 20
# name -> (tap inside the backbone, B2 launches per forward)
ZOO = {"mobilenetv2": ("block_12_add", 10), "xception": ("add_6", 34),
       "efficientnetb7": ("block5a_project_bn", 51)}
# Parts of the kernels' names as the profiler reports them.
KERNEL_KEYS = {"preprocess": ("preprocess_kernel",),
               "depthwise": ("depthwise_tiled", "depthwise_scalar")}


def phase(title):
    print(f"== {title}", flush=True)


def cuda_ms(fn, iters=ITERS, warmup=WARMUP):
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time_by_kernel(fn, n_iters=3):
    """Where the device time of ``fn`` goes: ``torch.profiler`` over
    ``n_iters`` calls (after one warm call), summed by kernel name. Returns
    ``{"wall_ms", "busy_ms", "kernels": [(name, ms), ...], "calls": {name:
    runs}, "copies": [(op, ms), ...]}`` per call, kernels sorted by time;
    ``busy_ms`` is 0.0 when the profiler saw no device activity. ``calls``
    counts each kernel's runs on the card that the profiler recorded
    (those a CUDA graph replays too; it has been seen to miss one of 64).
    ``copies`` sums the copy and fill kernels (``direct_copy_kernel``,
    ``FillFunctor``) by the outermost PyTorch operator that launched
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iters):
            fn()
        end.record()
        end.synchronize()
    # Kernels only: a named region (``annotate``) also has a span on the
    # device's timeline.
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / n_iters)
         for e in device if e.self_device_time_total),
        key=lambda kv: -kv[1])
    calls = {e.key: e.count / n_iters for e in device}
    copies = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if "direct_copy_kernel" in k.name or "FillFunctor" in k.name:
                op = e
                while (op.cpu_parent is not None
                       and op.cpu_parent.name.startswith("aten::")):
                    op = op.cpu_parent
                copies[op.name] = (copies.get(op.name, 0.0)
                                   + k.duration / 1e3 / n_iters)
    return {"wall_ms": start.elapsed_time(end) / n_iters,
            "busy_ms": sum(ms for _, ms in kernels), "kernels": kernels,
            "calls": calls,
            "copies": sorted(copies.items(), key=lambda kv: -kv[1])}


def beam_mask(hs, ws):
    """A 0/1 ultrasound-fan mask: a 70-degree sector below the top centre."""
    yy, xx = torch.meshgrid(torch.arange(hs, device="cuda"),
                            torch.arange(ws, device="cuda"), indexing="ij")
    ang = torch.atan2((xx - ws / 2).float(), yy.float() + 1.0)
    r = torch.sqrt(((xx - ws / 2) ** 2 + yy ** 2).float())
    return ((ang.abs() < np.deg2rad(35)) & (r < 0.95 * hs)).float()


def preprocess_bytes(b, src_hw, out_hw, mode, out_itemsize, with_mask):
    """Bytes the preprocess must move: the 32-byte sectors of the source
    rows its index map selects (computed for one frame and scaled by b,
    exact when a frame is a whole number of sectors), its index vectors
    and mask reads, and one write of the output."""
    from ab_line_classifier_torch.ops.image import nearest_indices

    hs, ws = src_hw
    hd, wd = out_hw
    rows = np.unique(nearest_indices(hs, hd, mode))
    cidx = nearest_indices(ws, wd, mode).astype(np.int64)
    cols = (cidx[:, None] * 3 + np.arange(3)).ravel()
    px = sum(np.unique((r * ws * 3 + cols) // 32).size for r in rows) * 32
    extra = (hd + wd) * 4
    if with_mask:
        extra += sum(np.unique((r * ws + cidx) * 4 // 32).size
                     for r in rows) * 32
    return b * px + extra + b * hd * wd * 3 * out_itemsize


def depthwise_bound(shape, k, itemsize):
    """``(bound_ms, bound_by, bytes, flops)`` of one K x K stride-1 SAME
    depthwise conv on NHWC ``shape``: one read of x and the float32 weight
    and one write of y, against the multiply-adds of the taps that fall
    inside the image (padding taps are skipped), at the float32 CUDA-core
    peak the kernel accumulates at."""
    b, h, w, c = shape
    p = k // 2

    def taps(n):
        return sum(min(n - 1, i + p) - max(0, i - p) + 1 for i in range(n))

    flops = 2.0 * b * c * taps(h) * taps(w)
    nbytes = 2 * b * h * w * c * itemsize + k * k * c * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", nbytes, flops)


def serving_weights(spec, seed=0):
    """A JAX-layout numpy tree for ``spec``, drawn leaf by leaf in the
    module's order: zero-mean normal kernels scaled by GAIN / sqrt(fan_in)
    (HWIO / [in, out]; a depthwise kernel's fan-in is K*K), small biases,
    batch-norm scales N(BN_SCALE, 0.1). Statistics keep the module's own
    values (``calibrated`` sets the batch norms')."""
    bn_scale = BN_SCALE.get(spec.name, DEFAULT_BN_SCALE)
    from ab_line_classifier_torch.utils.jax_params import flax_from_state_dict

    rng = np.random.RandomState(seed)
    tree = flax_from_state_dict(spec.module().state_dict())

    def draw(node):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                draw(leaf)
            elif name == "kernel":
                std = 0.5 * GAIN / np.sqrt(np.prod(leaf.shape[:-1]))
                node[name] = rng.normal(0.0, std, leaf.shape).astype(
                    np.float32)
            elif name == "scale":
                node[name] = rng.normal(bn_scale, 0.1, leaf.shape).astype(
                    np.float32)
            else:
                node[name] = rng.normal(0.01, 0.05, leaf.shape).astype(
                    np.float32)

    draw(tree["params"])
    return tree


def calibrated(spec, state_dict, seed=5, n=256):
    """``state_dict`` with every batch norm's statistics set from ``n``
    random frames of random brightness (0.15-1.0, the range of the GPU-vs-
    CPU check frames; ``graph.adapt_batch_norm``, float32 on the card)."""
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames

    if not any(k.endswith("running_var") for k in state_dict):
        return state_dict
    mod = spec.module()
    mod.load_state_dict(state_dict)
    mod = mod.eval().to(device="cuda", memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (n, *spec.input_shape[:2], 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    gain = 0.15 + 0.85 * torch.rand((n, 1, 1, 1), device="cuda",
                                    generator=gen)
    frames = (frames * gain).to(torch.uint8)
    with torch.inference_mode():
        x = preprocess_frames(frames, out_hw=tuple(spec.input_shape[:2]),
                              preprocess_mode=spec.preprocess_mode)
    G.adapt_batch_norm(mod, x)
    return {k: v.detach().cpu() for k, v in mod.state_dict().items()}


def served_activations(spec, state_dict, frames, device, taps):
    """``Predictor.forward``'s sequence (preprocess_frames, then the model
    in ``spec.dtype``, channels_last) on host frames, read at ``taps``;
    float32 on the CPU."""
    from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames

    mod = spec.module(capture=tuple(taps))
    mod.load_state_dict(state_dict)
    mod = mod.eval().to(device=device, dtype=spec.dtype,
                        memory_format=torch.channels_last)
    with torch.inference_mode():
        x = preprocess_frames(torch.as_tensor(frames).to(device),
                              out_hw=tuple(spec.input_shape[:2]),
                              preprocess_mode=spec.preprocess_mode,
                              out_dtype=spec.dtype)
        _, caps = mod(x)
    return {k: v.float().cpu() for k, v in caps.items()}


def rel_err(got, want):
    return float((got - want).norm() / want.norm())


def gpu_vs_cpu(spec, state_dict, predictor, frames, tap, smi):
    """The served forward on the GPU against the same port on the CPU
    (both bf16) at ``tap`` and the logits, the CPU's bf16-vs-float32 floor,
    a channel-swap fault and the probabilities (``predictor``'s on the GPU);
    raises past the bars."""
    taps = (tap, "logits")
    gpu = served_activations(spec, state_dict, frames, "cuda", taps)
    cpu = served_activations(spec, state_dict, frames, "cpu", taps)
    f32 = served_activations(dataclasses.replace(spec, dtype=torch.float32),
                             state_dict, frames, "cpu", taps)
    swapped = served_activations(spec, state_dict, frames[..., ::-1].copy(),
                                 "cuda", taps)
    # A fault that mixed frames up would move the logits by their spread
    # across frames: it must stand 3x above the logits' bar, relative to
    # their RMS, for the comparison to see one.
    logits = cpu["logits"]
    spread = float(logits.max() - logits.min())
    seen = spread / float(logits.pow(2).mean().sqrt())
    errs = {k: rel_err(gpu[k], cpu[k]) for k in taps}
    floor = {k: rel_err(cpu[k], f32[k]) for k in taps}
    bars = {k: max(ACT_RTOL, 2 * floor[k]) for k in taps}
    fault = rel_err(swapped[tap], cpu[tap])
    # Predictor.forward's softmax of the served logits, on the CPU.
    cpu_probs, f32_probs = (torch.softmax(a["logits"], -1).numpy()
                            for a in (cpu, f32))
    prob_err = float(np.abs(cpu_probs - predictor.predict_probs(frames)).max())
    prob_floor = float(np.abs(cpu_probs - f32_probs).max())
    prob_bar = max(BF16_PROB_ATOL, 2 * prob_floor)
    print(f"{spec.name} GPU vs CPU on {len(frames)} frames ({smi}): "
          f"relative error {tap} {errs[tap]:.3e}, logits "
          f"{errs['logits']:.3e} (bars {bars[tap]:.3e} / "
          f"{bars['logits']:.3e}; CPU bf16 vs float32 {floor[tap]:.3e} / "
          f"{floor['logits']:.3e}; channels swapped {fault:.3e}); logit "
          f"spread {spread:.3f} ({seen:.3f} of their RMS); max |dp| "
          f"{prob_err:.2e} (bar "
          f"{prob_bar:.2e}; CPU bf16 vs float32 {prob_floor:.2e})",
          flush=True)
    if seen < 3 * bars["logits"]:
        raise AssertionError(f"{spec.name}: logits too flat to compare "
                             f"(spread {spread}, {seen} of their RMS)")
    for k in taps:
        if bars[k] > BAR_CEILING:
            raise AssertionError(f"{spec.name}: CPU bf16 vs float32 {k} "
                                 f"differ by {floor[k]}: too far apart for "
                                 f"a comparison")
        if errs[k] > bars[k]:
            raise AssertionError(f"{spec.name}: GPU vs CPU {k} differ by "
                                 f"{errs[k]} > {bars[k]}")
    if fault < 3 * bars[tap]:
        raise AssertionError(f"{spec.name}: a channel swap moves {tap} by "
                             f"only {fault}")
    if prob_err > prob_bar:
        raise AssertionError(f"{spec.name}: GPU vs CPU probabilities differ "
                             f"by {prob_err}")


def host_frames(seed, n480, n128):
    """uint8 host frames: ``n480`` of 480x640 (512 distinct, tiled) and
    ``n128`` of 128x128, from a numpy seed."""
    rng = np.random.default_rng(seed)
    big = np.tile(rng.integers(0, 256, (min(512, n480), 480, 640, 3),
                               dtype=np.uint8),
                  (max(1, n480 // 512), 1, 1, 1))[:n480]
    return big, rng.integers(0, 256, (n128, 128, 128, 3), dtype=np.uint8)


def serve_clips(predictor, frames480, frames128):
    """Frames through ``predict_probs`` from both sources, grouped into
    clips and aggregated three ways on the card; checks the outputs.
    Returns ``(probs, n_clips, seconds)``."""
    from ab_line_classifier_torch.ops.clip_aggregation import aggregate_clips
    from ab_line_classifier_torch.predict.predict import group_clip_probs

    n = len(frames480) + len(frames128)
    lengths = [17, 32, 45, 9, 60, 23, 3, 51]
    names, paths = [], []
    while len(paths) < n:
        m = min(lengths[len(names) % len(lengths)], n - len(paths))
        names.append(f"clip{len(names):04d}")
        paths += [f"{names[-1]}_{i}.jpg" for i in range(m)]
    t0 = time.perf_counter()
    probs = np.concatenate([predictor.predict_probs(frames480),
                            predictor.predict_probs(frames128)])
    padded, mask = group_clip_probs(paths, probs, names)
    clips = {algo: aggregate_clips(
        torch.as_tensor(padded, device="cuda"),
        torch.as_tensor(mask, device="cuda"), algorithm=algo,
        classification_threshold=0.7, contiguity_threshold=3,
        window=4).cpu().numpy()
        for algo in ("average", "contiguous", "sliding_window")}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if probs.shape != (n, 2) or not np.isfinite(probs).all():
        raise AssertionError(f"bad frame probabilities {probs.shape}")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-5:
        raise AssertionError("frame probability rows do not sum to 1")
    for algo, out in clips.items():
        if out.shape != (len(names), 2) or not np.isfinite(out).all() \
                or np.abs(out.sum(1) - 1.0).max() > 1e-5:
            raise AssertionError(f"bad {algo} clip probabilities")
    return probs, len(names), seconds


def ptxas_report(log):
    """``[(instance, "N registers, S bytes spill stores, L bytes spill
    loads"), ...]`` of the depthwise kernel's instances in nvcc's
    ``-Xptxas -v`` output."""
    import re

    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"depthwise_(tiled|scalar)I(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)+)", m.group(1))
            if k:
                args = re.findall(r"Li(\d+)E", k.group(3))
                keys = (("K", "V", "rows") if k.group(1) == "tiled"
                        else ("K", "rows"))
                dtype = "f32" if k.group(2) == "f" else "bf16"
                name = (f"{k.group(1)}<{dtype}, " + ", ".join(
                    f"{key}={a}" for key, a in zip(keys, args)) + ">")
            else:
                name = None
        elif name and "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((name, f"{regs} registers, {spills}"))
            name = None
    return out


def make_depthwise(shape, k, dtype, gen):
    """An NCHW view of NHWC ``shape`` memory and a ``[C, 1, K, K]`` weight."""
    b, h, w, c = shape
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype).permute(
        0, 3, 1, 2)
    wt = (0.2 * torch.randn((c, 1, k, k), device="cuda", generator=gen)
          ).to(dtype)
    return x, wt


def check_depthwise(x, wt, label):
    """B2 against its plain version: raises unless ``torch.equal``; returns
    the max abs err (0.0)."""
    from ab_line_classifier_torch.ops import depthwise as D
    from ab_line_classifier_torch.ops import depthwise_cuda as DC

    got = DC.cuda_depthwise(x, DC.pack_weight(wt))
    want = D.depthwise_plain(x, wt)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"depthwise {label}: differs from its plain "
                             f"version, max abs err {err}")
    return err


def time_depthwise(shape, k, dtype, gen, plain=True):
    """B2 at NHWC ``shape``: exact agreement with the plain version, and
    the kernel's time, cuDNN's and the plain version's (unless ``plain`` is
    false) with the bound."""
    from ab_line_classifier_torch.ops import depthwise as D
    from ab_line_classifier_torch.ops import depthwise_cuda as DC

    c = shape[-1]
    x, wt = make_depthwise(shape, k, dtype, gen)
    packed = DC.pack_weight(wt)
    err = check_depthwise(x, wt, f"{shape} K={k} {dtype}")
    bound_ms, bound_by, nbytes, flops = depthwise_bound(
        shape, k, x.element_size())
    out = dict(err=err, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops,
               ms=cuda_ms(lambda: DC.cuda_depthwise(x, packed)),
               plain_ms=(cuda_ms(lambda: D.depthwise_plain(x, wt)) if plain
                         else 0.0),
               library_ms=cuda_ms(lambda: F.conv2d(x, wt, padding=k // 2,
                                                   groups=c)))
    del x
    return out


def phase_preprocess(kind):
    """Phase 3; returns B1's main-path timing and its max abs err."""
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.ops.image import (
        MASK_OPTIONS, OUT_DTYPES, PREPROCESS_MODES, RESIZE_MODES,
        fused_preprocess, mask_kwargs, max_ulp_error)

    phase("3 preprocess kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, n_calls, count0 = 0.0, 0, PC.launch_count
    for hs, ws in ((128, 128), (480, 640), (601, 803)):
        x = torch.randint(0, 256, (8, hs, ws, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        beam = beam_mask(hs, ws)
        for mode, resize, mask, dtype in itertools.product(
                PREPROCESS_MODES, RESIZE_MODES, MASK_OPTIONS, OUT_DTYPES):
            kw = dict(out_hw=OUT_HW, preprocess_mode=mode,
                      resize_mode=resize, out_dtype=dtype,
                      **mask_kwargs(mask, beam))
            got = PC.cuda_preprocess(x, **kw)
            want = fused_preprocess(x, **kw)
            max_err = max(max_err, max_ulp_error(got, want, dtype, mode))
            n_calls += 1
    n_grid = n_calls
    # The shapes of a batch-1 latency step and of the Grad-CAM batches.
    for b, hs, ws in ((1, 128, 128), (ZOO_BATCH, 128, 128),
                      (ZOO_BATCH, 480, 640)):
        x = torch.randint(0, 256, (b, hs, ws, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        for mode, dtype in itertools.product(PREPROCESS_MODES, OUT_DTYPES):
            kw = dict(out_hw=OUT_HW, preprocess_mode=mode, out_dtype=dtype)
            got = PC.cuda_preprocess(x, **kw)
            want = fused_preprocess(x, **kw)
            max_err = max(max_err, max_ulp_error(got, want, dtype, mode))
            n_calls += 1
    torch.cuda.synchronize()
    if PC.launch_count - count0 != n_calls:
        raise AssertionError("launch counter did not count every launch")
    print(f"grid: {n_grid} combinations over 3 source sizes, and "
          f"{n_calls - n_grid} at the Grad-CAM and batch-1 shapes (1 x "
          f"128x128, {ZOO_BATCH} x 128x128 and 480x640; every mode and "
          f"output dtype) agree, max abs err {max_err}")

    big = torch.randint(0, 256, (2048, 1080, 1440, 3), dtype=torch.uint8,
                        device="cuda", generator=gen)
    kw = dict(out_hw=OUT_HW, preprocess_mode="caffe", resize_mode="tf",
              mask=beam_mask(1080, 1440), out_dtype=torch.bfloat16)
    err = max_ulp_error(PC.cuda_preprocess(big, **kw),
                        fused_preprocess(big, **kw), torch.bfloat16, "caffe")
    torch.cuda.synchronize()
    print(f"2048 x 1080x1440 ({big.numel() / 2 ** 31:.2f} x 2^31 bytes): "
          f"agree, max abs err {err}")
    max_err = max(max_err, err)
    del big
    torch.cuda.empty_cache()

    # The main path's shapes: what Predictor.forward hands the kernel.
    timing = {}
    for src in ((480, 640), (128, 128)):
        x = torch.randint(0, 256, (MAIN_BATCH, *src, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        kw = dict(out_hw=OUT_HW, preprocess_mode="caffe", resize_mode="tf",
                  out_dtype=torch.bfloat16)
        err = max_ulp_error(PC.cuda_preprocess(x, **kw),
                            fused_preprocess(x, **kw), torch.bfloat16,
                            "caffe")
        max_err = max(max_err, err)
        kernel_ms = cuda_ms(lambda: PC.cuda_preprocess(x, **kw))
        plain_ms = cuda_ms(lambda: fused_preprocess(x, **kw))
        library_ms = cuda_ms(lambda: F.interpolate(
            x.permute(0, 3, 1, 2), size=OUT_HW, mode="nearest-exact"))
        n_out = MAIN_BATCH * OUT_HW[0] * OUT_HW[1] * 3
        nbytes = preprocess_bytes(MAIN_BATCH, src, OUT_HW, "tf", 2, False)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_out * 3 / PEAK_F32_FLOPS * 1e3  # 2 multiplies, 1 add
        whole_ms = (x.numel() + n_out * 2) / HBM_BYTES_PER_S * 1e3
        timing[src] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations")
        print(f"preprocess {MAIN_BATCH} x {src[0]}x{src[1]} -> 128x128 bf16 "
              f"caffe on {kind}: agrees with the plain version (max abs err "
              f"{err}); kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.interpolate {library_ms:.4f} ms, bytes bound "
              f"{bytes_ms:.4f} ms ({nbytes / 1e6:.1f} MB), ops bound "
              f"{ops_ms:.4f} ms, whole-input bound {whole_ms:.4f} ms",
              flush=True)
        del x
    return timing[(480, 640)], max_err


def depthwise_grid(gen):
    """B2 against its plain version over the grid and the edge cases;
    returns (number of launches, max abs err)."""
    from ab_line_classifier_torch.ops import depthwise_cuda as DC

    n, err = 0, 0.0
    for c, k, dtype, (b, h, w) in itertools.product(
            (3, 13, 36, 32, 96, 200, 728, 3840), (1, 3, 5, 7),
            (torch.float32, torch.bfloat16),
            ((1, 9, 7), (3, 8, 8), (2, 4, 4), (1, 20, 13))):
        x, wt = make_depthwise((b, h, w, c), k, dtype, gen)
        err = max(err, check_depthwise(x, wt, f"{(b, h, w, c)} K={k} "
                                              f"{dtype}"))
        n += 1
    # Data pointers off the 16-byte grid: a batch slice of frames of 910
    # (bf16) or 1820 (f32) bytes with odd C, and a 40-channel tensor one
    # element into its storage (the kernel takes one channel a thread).
    copies = DC.copy_count
    for k, dtype in itertools.product((1, 3, 5, 7),
                                      (torch.float32, torch.bfloat16)):
        x, wt = make_depthwise((3, 5, 7, 13), k, dtype, gen)
        flat = torch.randn(1 + 2 * 6 * 6 * 40, device="cuda",
                           generator=gen).to(dtype)
        shifted = flat[1:].view(2, 6, 6, 40).permute(0, 3, 1, 2)
        w40 = make_depthwise((1, 1, 1, 40), k, dtype, gen)[1]
        for xx, ww in ((x[1:], wt), (shifted, w40)):
            if xx.data_ptr() % 16 == 0:
                raise AssertionError("the unaligned case is aligned")
            err = max(err, check_depthwise(xx, ww, f"unaligned "
                                                   f"{tuple(xx.shape)} K={k} "
                                                   f"{dtype}"))
            n += 1
    if DC.copy_count != copies:
        raise AssertionError("a channels_last input was copied")
    # NCHW memory: copied once to channels_last, then the same result.
    x, wt = make_depthwise((2, 6, 6, 40), 3, torch.bfloat16, gen)
    err = max(err, check_depthwise(x.contiguous(), wt, "NCHW memory"))
    n += 1
    if DC.copy_count != copies + 1:
        raise AssertionError(f"copy_count {DC.copy_count - copies} for one "
                             f"NCHW input")
    return n, err


def depthwise_path_shapes(gen, shapes):
    """B2 against its plain version at every distinct stride-1 shape of
    the three depthwise models at the Grad-CAM batch (ZOO_BATCH) and of
    mobilenetv2 at batch 1 (a latency step), in bf16 and float32; returns
    (number of launches, max abs err)."""
    n, err = 0, 0.0
    cases = {(ZOO_BATCH,) + shape[1:] + (k,) for name in ZOO
             for shape, k in shapes[name]}
    cases |= {shape + (k,) for shape, k in shapes["mobilenetv2"]}
    for *shape, k in sorted(cases):
        for dtype in (torch.bfloat16, torch.float32):
            x, wt = make_depthwise(tuple(shape), k, dtype, gen)
            err = max(err, check_depthwise(x, wt, f"{tuple(shape)} K={k} "
                                                  f"{dtype}"))
            n += 1
    return n, err


def phase_depthwise(smi, shapes, b7_shape):
    """Phase 4; returns B2's timing summed over one forward of each zoo
    model (mobilenetv2 at MAIN_BATCH, the others at 512), its time at
    efficientnetb7's largest 5x5 layer, and its max abs err."""
    from ab_line_classifier_torch.ops import depthwise as D
    from ab_line_classifier_torch.ops import depthwise_cuda as DC

    phase("4 depthwise kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(1)
    count0 = DC.launch_count
    n_calls, max_err = depthwise_grid(gen)
    n_path, path_err = depthwise_path_shapes(gen, shapes)
    torch.cuda.synchronize()
    if DC.launch_count - count0 != n_calls + n_path:
        raise AssertionError("launch counter did not count every launch")
    print(f"grid: {n_calls} cases (K 1/3/5/7, f32/bf16, C 3..3840 with and "
          f"without whole 16-byte vectors, H/W 4..20, batch 1..3, unaligned "
          f"data pointers, NCHW memory) equal to the plain version, max abs "
          f"err {max_err}; {n_path} cases at the Grad-CAM and batch-1 "
          f"shapes (every distinct stride-1 layer of the three models at "
          f"batch {ZOO_BATCH} and of mobilenetv2 at batch 1, bf16 and f32) "
          f"equal, max abs err {path_err}")
    max_err = max(max_err, path_err)

    big = torch.randn((2048, 64, 64, 128), device="cuda",
                      generator=gen).permute(0, 3, 1, 2)
    wt = 0.2 * torch.randn((128, 1, 3, 3), device="cuda", generator=gen)
    got = DC.cuda_depthwise(big, DC.pack_weight(wt))
    for i in range(0, 2048, 256):  # the plain version in slices
        if not torch.equal(got[i:i + 256],
                           D.depthwise_plain(big[i:i + 256], wt)):
            raise AssertionError(f"f32 2048x64x64x128: frames {i}.. differ")
    torch.cuda.synchronize()
    print(f"f32 2048x64x64x128 ({big.numel() * 4 / 2 ** 31:.2f} x 2^31 "
          f"bytes): equal to the plain version")
    del big, got
    torch.cuda.empty_cache()

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")
    totals = {}
    for name, batch in (("mobilenetv2", MAIN_BATCH), ("xception", 512),
                        ("efficientnetb7", 512)):
        total = dict.fromkeys(keys, 0.0)
        counts = {}
        for shape, k in shapes[name]:
            counts[(shape, k)] = counts.get((shape, k), 0) + 1
        for (shape, k), n in counts.items():
            shape = (batch,) + shape[1:]
            t = time_depthwise(shape, k, torch.bfloat16, gen,
                               plain=name == "mobilenetv2")
            for key in keys:
                total[key] += n * t[key]
            plain = (f"plain {t['plain_ms']:.4f} ms, "
                     if name == "mobilenetv2" else "")
            print(f"depthwise bf16 {'x'.join(map(str, shape))} K={k} "
                  f"(x{n} per {name} forward) on {smi}: equal; kernel "
                  f"{t['ms']:.4f} ms ({t['bytes'] / t['ms'] / 1e9:.2f} TB/s, "
                  f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound), "
                  f"{plain}cuDNN grouped conv {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                  f"{t['bytes'] / 1e6:.1f} MB, {t['flops'] / 1e9:.2f} "
                  f"GFLOP)", flush=True)
        total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                             >= total["flops"] / PEAK_F32_FLOPS
                             else "operations")
        total["batch"] = batch
        totals[name] = total
        plain = (f"plain {total['plain_ms']:.4f} ms, "
                 if name == "mobilenetv2" else "")
        print(f"depthwise, the {len(shapes[name])} layers of one {name} "
              f"forward at batch {batch} on {smi}: kernel {total['ms']:.4f} "
              f"ms ({100 * total['bound_ms'] / total['ms']:.1f}% of the "
              f"bound), {plain}cuDNN {total['library_ms']:.4f} ms, bound "
              f"{total['bound_ms']:.4f} ms ({total['bound_by']})",
              flush=True)
    shape, k = (MAIN_BATCH,) + b7_shape[0][1:], b7_shape[1]
    b7 = time_depthwise(shape, k, torch.bfloat16, gen)
    print(f"depthwise bf16 {'x'.join(map(str, shape))} K={k} "
          f"(efficientnetb7's largest 5x5) on {smi}: equal; kernel "
          f"{b7['ms']:.4f} ms ({100 * b7['bound_ms'] / b7['ms']:.1f}% of the "
          f"bound), plain {b7['plain_ms']:.4f} ms, cuDNN grouped conv "
          f"{b7['library_ms']:.4f} ms, bound {b7['bound_ms']:.4f} ms "
          f"({b7['bound_by']}: {b7['bytes'] / 1e6:.1f} MB)", flush=True)
    return totals, b7, max_err


def phase_serving(spec, state_dict, batch, frames480, frames128, tap,
                  per_forward, smi):
    """Serve host frames of both sources through ``Predictor`` with the
    kernel counts reset just before; check B1 launched and B2 ``per_forward``
    times per forward; then GPU vs CPU. Returns (predictor, B1 launches,
    B2 launches)."""
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.predict import Predictor

    predictor = Predictor(spec, state_dict, batch_size=batch, device="cuda")
    PC.reset_launch_count()
    DC.reset_launch_count()
    probs, n_clips, seconds = serve_clips(predictor, frames480, frames128)
    pre, dw = PC.launch_count, DC.launch_count
    forwards = -(-len(frames480) // batch) - (-len(frames128) // batch)
    if pre != forwards:
        raise AssertionError(f"{spec.name}: {pre} preprocess launches for "
                             f"{forwards} forwards")
    if dw != per_forward * forwards:
        raise AssertionError(f"{spec.name}: {dw} depthwise launches for "
                             f"{forwards} forwards, want {per_forward} each")
    if DC.copy_count:
        raise AssertionError(f"{spec.name}: the depthwise wrapper copied "
                             f"{DC.copy_count} inputs to channels_last")
    print(f"{spec.name}: served {len(probs)} frames into {n_clips} clips in "
          f"{seconds:.2f} s at batch {batch} (host frames, pinned copies, 3 "
          f"aggregations); preprocess launches {pre}, depthwise launches "
          f"{dw} ({per_forward} per forward), depthwise input copies "
          f"{DC.copy_count}; P(b_lines) range "
          f"[{probs[:, 1].min():.4f}, {probs[:, 1].max():.4f}]", flush=True)
    # GPU against the same port on the CPU, on frames of graded brightness
    # so that their logits differ.
    n = 4 if spec.name == "efficientnetb7" else 8
    check = (frames480[:n] * np.linspace(0.15, 1.0, n)[:, None, None, None]
             ).astype(np.uint8)
    gpu_vs_cpu(spec, state_dict, predictor, check, tap, smi)
    return predictor, pre, dw


def throughput(spec, state_dict, bs, per_forward, smi):
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.benchmark import (
        clip_inference_benchmark)

    PC.reset_launch_count()
    DC.reset_launch_count()
    r = clip_inference_benchmark(batch_size=bs, img_dim=OUT_HW,
                                 n_warmup=WARMUP, n_iters=ITERS,
                                 state_dict=state_dict, spec=spec,
                                 device="cuda", verbose=False)
    # Warm-up, then n and 2n timed forwards (n more if the n-vs-2n dispatch
    # check falls back to per-iteration syncs); the FLOP count's one-frame
    # forward of the model adds one more depthwise pass.
    forwards = PC.launch_count
    if forwards not in (WARMUP + 3 * ITERS, WARMUP + 4 * ITERS):
        raise AssertionError(f"benchmark launched the preprocess kernel "
                             f"{forwards} times")
    if DC.launch_count != per_forward * (forwards + 1):
        raise AssertionError(f"benchmark launched the depthwise kernel "
                             f"{DC.launch_count} times in {forwards} "
                             f"forwards")
    if DC.copy_count:
        raise AssertionError(f"benchmark: the depthwise wrapper copied "
                             f"{DC.copy_count} inputs")
    share = r["frames_per_sec"] * r["flops_per_frame"] / PEAK_BF16_FLOPS
    print(f"throughput on {smi}: {spec.name} 128x128 batch {bs}: "
          f"{r['frames_per_sec']:.1f} frames/s, {r['ms_per_batch']:.3f} "
          f"ms/batch, {r['flops_per_frame'] / 1e9:.4f} GFLOP/frame, "
          f"{100 * share:.2f}% of 989 TFLOP/s bf16; preprocess launches "
          f"{forwards}, depthwise launches {DC.launch_count}", flush=True)


def profile_batch(name, predictor, smi, sources, gen):
    for src in sources:
        x = torch.randint(0, 256, (MAIN_BATCH, *src, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        prof = device_time_by_kernel(lambda: predictor.forward(x))
        wall, busy = prof["wall_ms"], prof["busy_ms"]
        print(f"profile, {name} batch {MAIN_BATCH} from {src[0]}x{src[1]} on "
              f"{smi}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"(idle share {1 - busy / wall:.4f})")
        for kname, ms in prof["kernels"][:10]:
            print(f"  {ms:9.3f} ms {100 * ms / wall:6.2f}%  {kname[:110]}")
        for label, keys in KERNEL_KEYS.items():
            ms = sum(v for k, v in prof["kernels"]
                     if any(key in k for key in keys))
            print(f"  {label} kernel: {ms:.4f} ms "
                  f"({100 * ms / wall:.3f}% of the batch)", flush=True)
        print("  copy and fill kernels by the operator that launched them: "
              + ", ".join(f"{op} {ms:.3f} ms" for op, ms in prof["copies"]),
              flush=True)
        del x


def explain_config(mode):
    """The config keys ``GradCAMExplainer`` reads (the card has no PyYAML
    to load config.yml); no PNG is written, so no paths."""
    from ab_line_classifier_torch.config import Config

    return Config({"DATA": {"IMG_DIM": list(OUT_HW),
                            "CLASSES": ["a_lines", "b_lines"]},
                   "PATHS": {"HEATMAPS": "", "FRAMES": ""},
                   "EXPLAINABILITY": {"GRAD_CAM": {"MODE": mode}}})


def margins(probs):
    """Top-2 probability margin of each frame."""
    top = np.sort(probs, axis=1)
    return top[:, -1] - top[:, -2]


def lit_frames(frames, n):
    """The first ``n`` frames, of graded brightness (0.15 to 1), each lit
    through a half-plane turned 135 degrees from the previous frame's and
    dimmed to 0.2 outside it, so that the logits and the heatmaps differ
    from frame to frame."""
    h, w = frames.shape[1:3]
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i, gain in enumerate(np.linspace(0.15, 1.0, n)):
        ang = 0.75 * np.pi * i
        lit = (xx - w / 2) * np.cos(ang) + (yy - h / 2) * np.sin(ang) > 0
        out.append(frames[i] * (gain * np.where(lit, 1.0, 0.2))[..., None])
    return np.stack(out).astype(np.uint8)


def gradcam_gpu_vs_cpu(spec, state_dict, explainer, frames, filler, smi):
    """Grad-CAM on the GPU against the same port on the CPU, over the
    check ``frames`` whose top-2 margin clears the probability bar on the
    CPU in bf16 and in float32 (a borderline frame may pick the other
    class, and then its heatmap differs completely), by relative Frobenius
    error:

    * in bf16 (the served dtype), probabilities and heatmaps within bars
      set as ``gpu_vs_cpu`` sets them: the larger of ACT_RTOL and twice the
      CPU's own bf16-vs-float32 floor; the heatmaps only where that bar is
      at most BAR_CEILING;
    * in float32 (the same weights, the same kernels), within F32_RTOL.

    The frames are taken CHECK_KEEP at a time (every fourth, so that each
    draw spans the brightness range) until CHECK_KEEP clear the margin.
    The GPU explains each draw as the first frames of a batch of ZOO_BATCH
    (the timed batch; ``filler`` frames make up the rest), the CPU the
    draw alone.

    Faults are held against the float32 bar: frames with their channels
    swapped, and each frame's heatmap taken for the next frame's, must
    move the heatmaps beyond three times it. The bf16 bar cannot serve
    there: the heatmap is a sum over the tap's channels that largely
    cancels, so bf16 rounding of the tap moves the random-weight models'
    heatmaps far from float32 (mobilenetv2's by 17-29%) while the GPU and
    the CPU, rounding alike, agree within a few percent. Raises past the
    bars."""
    from ab_line_classifier_torch.explain.gradcam import GradCAMExplainer

    cfg, mode = explain_config(explainer.mode), explainer.mode
    spec32 = dataclasses.replace(spec, dtype=torch.float32)
    gpu32 = GradCAMExplainer(cfg, spec32, state_dict, mode, "cuda")
    cpu = GradCAMExplainer(cfg, spec, state_dict, mode, "cpu")
    cpu32 = GradCAMExplainer(cfg, spec32, state_dict, mode, "cpu")

    def in_batch(ex, draw):
        batch = np.concatenate([draw, filler[:ZOO_BATCH - len(draw)]])
        return tuple(out[:len(draw)] for out in ex.explain_frames(batch))

    step = len(frames) // CHECK_KEEP
    parts = []
    for j in range(step):
        draw = frames[j::step]
        parts.append({"gpu": in_batch(explainer, draw),
                      "cpu": cpu.explain_frames(draw),
                      "gpu32": in_batch(gpu32, draw),
                      "cpu32": cpu32.explain_frames(draw),
                      "swapped": in_batch(gpu32, draw[..., ::-1].copy())})
        runs = {name: tuple(np.concatenate([p[name][i] for p in parts])
                            for i in range(2)) for name in parts[0]}
        cpu_p, cpu32_p = runs["cpu"][0], runs["cpu32"][0]
        prob_bar = max(BF16_PROB_ATOL,
                       2 * float(np.abs(cpu_p - cpu32_p).max()))
        keep = (margins(cpu_p) >= prob_bar) & (margins(cpu32_p) >= prob_bar)
        if keep.sum() >= CHECK_KEEP:
            break
    n_drawn = len(keep)
    if keep.sum() < CHECK_KEEP:
        raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: only "
                             f"{keep.sum()} of {n_drawn} frames clear the "
                             f"margin {prob_bar}")
    t = {(name, k): torch.from_numpy(out[i][keep])
         for name, out in runs.items() for i, k in enumerate("pc")}
    for name in ("gpu", "gpu32"):
        if (t[name, "p"].argmax(1) != t["cpu", "p"].argmax(1)).any():
            raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: a kept "
                                 f"frame changed class ({name})")
    if float(t["cpu32", "c"].norm()) == 0.0:
        raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: every kept "
                             f"heatmap is empty")
    errs = {k: rel_err(t["gpu", k], t["cpu", k]) for k in "pc"}
    floors = {k: rel_err(t["cpu", k], t["cpu32", k]) for k in "pc"}
    bars = {k: max(ACT_RTOL, 2 * floors[k]) for k in "pc"}
    errs32 = {k: rel_err(t["gpu32", k], t["cpu32", k]) for k in "pc"}
    faults = {"channels swapped": rel_err(t["swapped", "c"],
                                          t["cpu32", "c"]),
              "next frame's": rel_err(t["gpu32", "c"].roll(1, 0),
                                      t["cpu32", "c"])}
    held = bars["c"] <= BAR_CEILING
    print(f"{spec.name} Grad-CAM [{mode}] GPU vs CPU ({smi}): "
          f"{int(keep.sum())} of {n_drawn} frames kept (top-2 margin at "
          f"least {prob_bar:.2e}), GPU in batches of {ZOO_BATCH}; bf16 "
          f"relative error probabilities {errs['p']:.3e}, heatmaps "
          f"{errs['c']:.3e} (bars {bars['p']:.3e} / {bars['c']:.3e}"
          + ("" if held else f" > {BAR_CEILING}: heatmaps held in float32 "
             f"only") + f"; CPU bf16 vs float32 {floors['p']:.3e} / "
          f"{floors['c']:.3e}); float32 {errs32['p']:.3e} / "
          f"{errs32['c']:.3e} (bar {F32_RTOL:.0e}); float32 heatmap "
          f"faults: " + ", ".join(f"{k} {v:.3e}" for k, v in faults.items()),
          flush=True)
    if bars["p"] > BAR_CEILING:
        raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: CPU bf16 vs "
                             f"float32 probabilities differ by "
                             f"{floors['p']}: too far apart to compare")
    for k, label in (("p", "probabilities"), ("c", "heatmaps")):
        bar = bars[k] if k == "p" or held else float("inf")
        if not (errs[k] <= bar and errs32[k] <= F32_RTOL):
            raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: GPU vs CPU "
                                 f"{label} differ by {errs[k]} (bf16) / "
                                 f"{errs32[k]} (float32)")
    for k, v in faults.items():
        if not v >= 3 * F32_RTOL:
            raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: the fault "
                                 f"'{k}' moves the heatmaps by only {v}")


def phase_gradcam(spec, state_dict, per_forward, frames480, frames128, smi):
    """Grad-CAM of ``spec`` on the card, both modes, batches of ZOO_BATCH
    host frames of both sources through ``GradCAMExplainer.explain_frames``
    with the kernel counts reset just before; checks the outputs, B1's
    launch per batch and B2's ``per_forward`` launches per batch with no
    input copied; then GPU vs CPU, the serving and Grad-CAM rates at
    ZOO_BATCH. Returns (B1 launches, B2 launches)."""
    from ab_line_classifier_torch.explain.gradcam import (GradCAMExplainer,
                                                          heatmap_overlay)
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.benchmark import (
        clip_inference_benchmark, gradcam_benchmark)

    explainers = {mode: GradCAMExplainer(explain_config(mode), spec,
                                         state_dict, mode, "cuda")
                  for mode in ("normal", "plusplus")}
    PC.reset_launch_count()
    DC.reset_launch_count()
    t0 = time.perf_counter()
    n_batches = 0
    for mode, ex in explainers.items():
        for frames in (frames480, frames128):
            for i in range(0, len(frames), ZOO_BATCH):
                probs, cams = ex.explain_frames(frames[i:i + ZOO_BATCH])
                n = len(frames[i:i + ZOO_BATCH])
                n_batches += 1
                if probs.shape != (n, 2) or cams.shape != (n, *OUT_HW) \
                        or not (np.isfinite(probs).all()
                                and np.isfinite(cams).all()):
                    raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: "
                                         f"bad outputs")
                if np.abs(probs.sum(1) - 1).max() > 1e-5 \
                        or cams.min() < 0 or cams.max() > 1 + 1e-6 \
                        or cams.max() < 0.5:
                    raise AssertionError(f"{spec.name} Grad-CAM [{mode}]: "
                                         f"probabilities or heatmaps out "
                                         f"of range")
    seconds = time.perf_counter() - t0
    pre, dw = PC.launch_count, DC.launch_count
    if pre != n_batches or dw != per_forward * n_batches or DC.copy_count:
        raise AssertionError(f"{spec.name} Grad-CAM: {pre} preprocess and "
                             f"{dw} depthwise launches, {DC.copy_count} "
                             f"input copies in {n_batches} batches")
    overlay = heatmap_overlay(frames128[0], cams[-1])
    if overlay.shape != frames128[0].shape or overlay.dtype != np.uint8:
        raise AssertionError("bad heatmap overlay")
    print(f"{spec.name} Grad-CAM: {n_batches} batches of {ZOO_BATCH} host "
          f"frames (480x640 and 128x128, normal and plusplus) in "
          f"{seconds:.2f} s; preprocess launches {pre}, depthwise launches "
          f"{dw} ({dw // n_batches} per forward), depthwise input copies "
          f"{DC.copy_count}", flush=True)
    check = lit_frames(frames480, CHECK_DRAW)
    for ex in explainers.values():
        gradcam_gpu_vs_cpu(spec, state_dict, ex, check,
                           frames480[CHECK_DRAW:], smi)
    serve = clip_inference_benchmark(batch_size=ZOO_BATCH, img_dim=OUT_HW,
                                     n_warmup=WARMUP, n_iters=ITERS,
                                     state_dict=state_dict, spec=spec,
                                     device="cuda", verbose=False)
    for mode in explainers:
        r = gradcam_benchmark(batch_size=ZOO_BATCH, img_dim=OUT_HW,
                              mode=mode, n_warmup=WARMUP, n_iters=ITERS,
                              state_dict=state_dict, spec=spec,
                              device="cuda", verbose=False)
        print(f"throughput on {smi}: {spec.name} 128x128 batch {ZOO_BATCH}: "
              f"Grad-CAM [{mode}] {r['gradcam_frames_per_sec']:.1f} "
              f"frames/s ({r['ms_per_batch']:.3f} ms/batch), serving "
              f"{serve['frames_per_sec']:.1f} frames/s "
              f"({serve['ms_per_batch']:.3f} ms/batch); Grad-CAM / serving "
              f"{r['gradcam_frames_per_sec'] / serve['frames_per_sec']:.4f}",
              flush=True)
    return pre, dw


def profile_gradcam(spec, state_dict, smi, gen):
    """Where the device time of one Grad-CAM batch (ZOO_BATCH frames of
    128x128, normal) goes."""
    from ab_line_classifier_torch.explain.gradcam import build_fused_gradcam
    from ab_line_classifier_torch.predict.predict import load_module

    fused = build_fused_gradcam(spec, load_module(spec, state_dict,
                                                  torch.device("cuda")))
    x = torch.randint(0, 256, (ZOO_BATCH, *OUT_HW, 3), dtype=torch.uint8,
                      device="cuda", generator=gen)
    prof = device_time_by_kernel(lambda: fused(x))
    wall, busy = prof["wall_ms"], prof["busy_ms"]
    print(f"profile, {spec.name} Grad-CAM batch {ZOO_BATCH} from 128x128 on "
          f"{smi}: wall {wall:.3f} ms, device busy {busy:.3f} ms (idle "
          f"share {1 - busy / wall:.4f})")
    for kname, ms in prof["kernels"][:12]:
        print(f"  {ms:9.3f} ms {100 * ms / wall:6.2f}%  {kname[:110]}")
    print("  copy and fill kernels by the operator that launched them: "
          + ", ".join(f"{op} {ms:.3f} ms" for op, ms in prof["copies"]),
          flush=True)


def phase_latency(spec, state_dict, per_forward, smi):
    """Batch-1 latency of ``spec`` (CUDA graph and eager, and the
    reference's host-clock mechanism), with the kernel counts reset just
    before. Checks the kernels captured per step, that one replay runs
    them on the card (the profiler's count), and the chain's probabilities
    on its two check frames (the replayed graph's, which the benchmark
    holds equal to the eager chain's) against ``Predictor`` on the CPU in
    bf16, within the larger of BF16_PROB_ATOL and twice the CPU's
    bf16-vs-float32 floor. Returns (B1 launches, B2 launches, {kernel:
    runs per replay}, replays)."""
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.benchmark import (
        clock_avg_runtime, single_frame_latency_benchmark)
    from ab_line_classifier_torch.predict.predict import Predictor

    PC.reset_launch_count()
    DC.reset_launch_count()
    r = single_frame_latency_benchmark(img_dim=OUT_HW, state_dict=state_dict,
                                       spec=spec, device="cuda",
                                       verbose=False)
    pre, dw = PC.launch_count, DC.launch_count
    per_step = r["graph_launches_per_step"]
    if per_step != {"preprocess": 1, "depthwise": per_forward}:
        raise AssertionError(f"{spec.name}: captured per step {per_step}")
    calls = device_time_by_kernel(r["graph"].replay, n_iters=1)["calls"]
    per_replay = {label: sum(n for k, n in calls.items()
                             if any(key in k for key in keys))
                  for label, keys in KERNEL_KEYS.items()}
    # The wrappers count at capture only: the profiler shows that the
    # replays run the kernels on the card.
    for label, n in per_step.items():
        if (per_replay[label] > 0) != (n > 0):
            raise AssertionError(f"{spec.name}: one replay ran "
                                 f"{per_replay[label]} {label} kernels, "
                                 f"{n} captured per step")
    frames = torch.as_tensor(r["check_frames"])
    cpu, cpu32 = (Predictor(s, state_dict, batch_size=1,
                            compute_dtype=s.dtype, device="cpu"
                            ).forward(frames).numpy()
                  for s in (spec, dataclasses.replace(spec,
                                                      dtype=torch.float32)))
    err = float(np.abs(r["check_probs"] - cpu).max())
    floor = float(np.abs(cpu - cpu32).max())
    bar = max(BF16_PROB_ATOL, 2 * floor)
    mean_ms, std_ms = clock_avg_runtime(img_dim=OUT_HW,
                                        state_dict=state_dict, spec=spec,
                                        device="cuda", verbose=False)
    print(f"latency on {smi}: {spec.name} batch 1, chain of "
          f"{r['chain_len']}: CUDA graph {r['graph_ms_per_frame']:.4f} "
          f"ms/frame, eager {r['eager_ms_per_frame']:.4f} ms/frame; "
          f"clock_avg_runtime {mean_ms:.4f} +- {std_ms:.4f} ms; captured "
          f"per step preprocess {per_step['preprocess']:g}, depthwise "
          f"{per_step['depthwise']:g} launches; one replay ran preprocess "
          f"{per_replay['preprocess']:g}, depthwise "
          f"{per_replay['depthwise']:g} kernels (profiler; "
          f"{r['chain_len']} steps captured); "
          f"{r['replayed_steps'] // r['chain_len']} replays; wrapper counts "
          f"{pre} / {dw}; replayed graph equal to the eager chain on 2 "
          f"frames, against the CPU max |dp| {err:.2e} (bar {bar:.2e}; CPU "
          f"bf16 vs float32 {floor:.2e})", flush=True)
    if not err <= bar:
        raise AssertionError(f"{spec.name}: batch-1 GPU vs CPU probabilities "
                             f"differ by {err}")
    return pre, dw, per_replay, r["replayed_steps"] // r["chain_len"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ab_line_classifier_torch.ops import _build
    from ab_line_classifier_torch.predict.benchmark import (
        build_flagship, build_zoo, depthwise_layer_shapes)
    from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

    t_start = time.perf_counter()
    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    # Comparisons of float32 paths run in full float32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(_build.build, _build.kernel_names()))
    print(f"built {len(libs)} kernel(s) in {time.perf_counter() - t0:.2f} s:"
          f" {[os.path.relpath(p, REPO) for p in libs]}")
    for name, line in ptxas_report(_build.build_log("depthwise")):
        print(f"ptxas {name}: {line}")

    b1, b1_err = phase_preprocess(kind)
    specs = {name: build_zoo(name, OUT_HW) for name in ZOO}
    shapes = {name: depthwise_layer_shapes(spec)
              for name, spec in specs.items()}
    for name, (_, per_forward) in ZOO.items():
        if len(shapes[name]) != per_forward:
            raise AssertionError(f"{name} has {len(shapes[name])} kernel "
                                 f"depthwise layers")
    b7_5x5 = max((s for s in shapes["efficientnetb7"] if s[1] == 5),
                 key=lambda s: np.prod(s[0]))
    b2_models, b2_b7, b2_err = phase_depthwise(smi, shapes, b7_5x5)
    b2 = b2_models["mobilenetv2"]

    phase("5 main path: cutoffvgg16 serving + clip aggregation")
    frames480, frames128 = host_frames(1, 4096, 4096)
    vgg = build_flagship(OUT_HW)
    vgg_sd = state_dict_from_flax(serving_weights(vgg))
    vgg_pred, b1_launches, _ = phase_serving(
        vgg, vgg_sd, MAIN_BATCH, frames480, frames128, "block3_conv3", 0,
        smi)

    phase("6 main path: mobilenetv2 serving + clip aggregation")
    mbv2 = specs["mobilenetv2"]
    weights = {name: calibrated(spec, state_dict_from_flax(
        serving_weights(spec))) for name, spec in specs.items()}
    mbv2_pred, pre, b2_launches = phase_serving(
        mbv2, weights["mobilenetv2"], MAIN_BATCH, frames480, frames128,
        ZOO["mobilenetv2"][0], ZOO["mobilenetv2"][1], smi)
    b1_launches += pre

    phase("7 xception and efficientnetb7 serving")
    for name in ("xception", "efficientnetb7"):
        _, pre, dw = phase_serving(specs[name], weights[name], ZOO_BATCH,
                                   frames480[:512], frames128[:512],
                                   *ZOO[name], smi)
        b1_launches += pre
        b2_launches += dw
    frames480, frames128 = frames480[:512].copy(), frames128[:512].copy()
    launches = {"serving": (b1_launches, b2_launches)}

    phase("8 throughput")
    for bs in (1024, 2048):
        throughput(vgg, vgg_sd, bs, 0, smi)
        throughput(mbv2, weights["mobilenetv2"], bs, 10, smi)
    for name in ("xception", "efficientnetb7"):
        throughput(specs[name], weights[name], 512, ZOO[name][1], smi)
    gen = torch.Generator(device="cuda").manual_seed(2)
    profile_batch("cutoffvgg16", vgg_pred, smi, ((128, 128), (480, 640)),
                  gen)
    profile_batch("mobilenetv2", mbv2_pred, smi, ((128, 128),), gen)
    torch.cuda.synchronize()

    phase("9 Grad-CAM")
    weights["cutoffvgg16"] = vgg_sd
    grad_specs = {"cutoffvgg16": vgg, **specs}
    per_forward = {"cutoffvgg16": 0, **{k: v[1] for k, v in ZOO.items()}}
    launches["gradcam"] = tuple(map(sum, zip(*(
        phase_gradcam(grad_specs[name], weights[name], per_forward[name],
                      frames480, frames128, smi) for name in grad_specs))))
    del frames480, frames128
    for name in ("cutoffvgg16", "mobilenetv2"):
        profile_gradcam(grad_specs[name], weights[name], smi, gen)

    phase("10 batch-1 latency")
    per_replay, replays = {}, {}
    counts = []
    for name in ("cutoffvgg16", "mobilenetv2"):
        pre, dw, per_replay[name], replays[name] = phase_latency(
            grad_specs[name], weights[name], per_forward[name], smi)
        counts.append((pre, dw))
    launches["latency"] = tuple(map(sum, zip(*counts)))
    torch.cuda.synchronize()

    def graph_runs(kernel):
        """Runs on the card of ``kernel`` in one replay of each model's
        latency graph (the profiler's count), and the benchmark's
        replays."""
        return {"profiled_runs_per_graph_replay": {
                    name: n[kernel] for name, n in per_replay.items()},
                "graph_replays": replays}

    kernels = [
        {"name": "preprocess", "route": "cuda",
         "source": "ab_line_classifier_torch/csrc/preprocess.cu",
         "replaces": "ab_line_classifier_tpu/ops/preprocess_pallas.py:66",
         "launches": sum(b1 for b1, _ in launches.values()),
         "launches_by_path": {k: b1 for k, (b1, _) in launches.items()},
         **graph_runs("preprocess"),
         "max_abs_err": b1_err,
         "ms": b1["ms"], "plain_ms": b1["plain_ms"],
         "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": b1["library_ms"],
         "shape": f"{MAIN_BATCH}x480x640x3 uint8 -> 128x128x3 bf16"},
        {"name": "depthwise", "route": "cuda",
         "source": "ab_line_classifier_torch/csrc/depthwise.cu",
         "replaces": "ab_line_classifier_tpu/ops/depthwise_pallas.py:60",
         "launches": sum(b2 for _, b2 in launches.values()),
         "launches_by_path": {k: b2 for k, (_, b2) in launches.items()},
         **graph_runs("depthwise"),
         "max_abs_err": b2_err,
         "ms": b2["ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": b2["library_ms"],
         "shape": f"the 10 stride-1 layers of a mobilenetv2 forward, bf16, "
                  f"batch {MAIN_BATCH}",
         "per_forward": {
             f"{name} batch {t['batch']}": {
                 "ms": t["ms"], "library_ms": t["library_ms"],
                 "bound_ms": t["bound_ms"]}
             for name, t in b2_models.items()},
         "efficientnetb7_largest_5x5": {
             key: b2_b7[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms")}},
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
