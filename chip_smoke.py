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
   shapes of the Grad-CAM batches, a batch-1 latency step and a training
   validation batch (64 x 128x128) in every mode and output dtype; then,
   at the serving path's shapes, the same
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
   mobilenetv2 at batch 1 (latency) and 64 (training) in bf16 and f32,
   and of mobilenetv2
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
   and ``clock_avg_runtime``;
11. training — cutoffvgg16 at full width (128x128, batch 64, bf16 compute
   on float32 master weights, the config's augmentation) through both
   phases of its plan with ``Trainer.fit`` on a device-cached array
   dataset (344 training frames: the last batch padded by wraparound; 96
   validation frames), B1 launched once per validation batch; the
   backbone bit-unchanged through ``extract``, only block3_conv2/3 moved
   by ``finetune``; mobilenetv2 (its one phase, the backbone and every
   batch norm frozen) for one epoch, B2 launched 10 times in every
   training forward and validation batch, no input copied; on each, the
   loss of 30 steps on one fixed batch must fall (bars from a CPU
   rehearsal). Then, outside the counted run: one step of each
   cutoffvgg16 phase on the GPU against the CPU in float32 (the updates
   held tight where a float64 CPU gradient is large enough for the first
   step to be flat in it); gradients through B2 against the grouped conv's
   at every stride-1 depthwise shape of mobilenetv2; a cnn0 training step
   in bf16 whose batch norms train: running statistics by flax's rule
   against float64 statistics of each layer's input, and the cost of a
   training batch norm beside ``F.batch_norm`` alone;
   ``training_throughput_benchmark`` of every phase at
   batch 256 and 1024 (cutoffvgg16) and 256 (mobilenetv2), with share of
   bf16 peak and a profiled step (idle share, top kernels);
12. cross-validation and hyperparameter search — the port's own
   ``cross_validation`` (cutoffvgg16, full width, config.yml's
   hyperparameters, ``extract`` then ``finetune`` one epoch each, batch
   64) over 3 patient-grouped folds (config.yml has 5: cut for time) of
   480 synthetic frames of 24 patients, through the array seam
   (``FoldSource`` over ``FrameArrays``: each fold's rows cached on the
   card for its run),
   interrupted as fold 1 starts and resumed (fold 0's record
   byte-identical); then ``hparam_search`` (mobilenetv2, full width,
   ``METHOD: bayes``, 4 trials of one epoch over config.yml's space),
   whose fourth suggestion must equal what the same controller suggests
   on the CPU after replaying the card's three observations. Per fold and
   trial: wall and setup seconds, training frames/s, B1 and B2 launches
   (held to the counts the data gives; B2's input copies 0) and
   ``max_memory_allocated``, the last run's peak within 5% of the
   first's;
13. trial-parallel cross-validation and LR search — kernel B2's launch
   over F trials (``torch.func.vmap`` of the depthwise entry point, the
   trials as F * C channels) at every stride-1 mobilenetv2 shape at batch
   64, F = 4 and 10, bf16 and f32: one launch, no input copied, each
   trial ``torch.equal`` to its own one-trial launch and to the plain
   version, stacked float32 gradients against each trial's grouped conv,
   and its time per forward beside F one-trial launches, cuDNN's grouped
   conv over the F * C channels, the plain version and the bound; one
   stacked float32 step (no augmentation, dropout 0) against F serial
   ``Trainer`` steps on the card (cutoffvgg16 ``extract`` and
   ``finetune`` at F = 3, mobilenetv2 at F = 4) by the train-step rule;
   a profiled stacked step of each model (idle share, top kernels); then
   on phase 12's data ``cross_validation_parallel`` (cutoffvgg16, its 3
   folds, cuDNN deterministic: interrupted after the ``extract`` epoch and
   resumed, then whole, the resumed test rows and weights bit-equal to
   the whole run's), ``lr_search_parallel`` (mobilenetv2,
   4 trials over config.yml's LR range, DROPOUT ignored with the JAX
   package's message) and both again at config.yml's counts (5 folds, 10
   trials): B1 and B2 launches held to the counts the data gives, no
   input copied, wall and setup seconds, training frames/s and peak
   memory beside phase 12's serial numbers;
14. the raw-clip path — deploy serving: full-width cutoffvgg16 and
   mobilenetv2 (phases 5-6's weights, saved as port checkpoints) served by
   ``predict_wavebase_mp4`` over a 256-frame 480x640 clip and a 64-frame
   1080x1440 clip (graded brightness, odd content in the UI box), counts
   reset just before each call: B1 once a clip, B2 10 a mobilenetv2 clip,
   no input copied; the CSV's rows and values; 8 frames against the port
   on the CPU by the serving bar; a clip that differs only in the 50x160
   UI box gives equal probabilities; B1 against its plain version at the
   deploy settings (cv2 map, UI blank, f32 out) within 1 ulp;
   ``check_preprocess_parity`` of cutoffvgg16, mobilenetv2 and
   efficientnetb7 on the card below 1e-5; per clip the pageable upload
   (and a pinned one beside it), B1's time beside its plain version's and
   its bytes bound, the forward, frames/s. Auto-masking: a U-Net of width
   16 (random weights from a numpy seed) on 11 frames sampled from a
   110-frame clip at 480x640 and 1080x1440, with PyTorch's TF32 default
   back on for the path: probabilities against the CPU within 1e-5 (and
   the U-Net called outside the path's IEEE float32 scope, reported),
   ``clip_mask`` equal to the CPU chain on the same probabilities, erode,
   dilate and vote (24x24 and 54x54 ellipses) on noisy fan masks equal to
   the CPU's, ``mask_frames`` with and without the crop; per-step times
   and a profile of the 54x54 dilate. The clip-rule experiments
   (contiguous, total, sliding window) on a frame table made from the
   deploy probabilities: rows and CSVs on the card equal to the CPU's.

The last two lines of standard output are a JSON line of per-kernel
numbers (launches per path, ``training``, the trial-parallel, ``deploy``
and ``automask`` paths included: the wrappers' counts,
which tick once at a CUDA graph's capture; the kernel's runs in one
replay of each latency graph, counted by the profiler, and the replays)
and ``{"ok": true, "device": {...}}``.
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
# Phase 11 (training): batch 64 (config.yml), 344 training frames (5 full
# batches and one of 24 real rows padded by wraparound) and 96 validation
# frames; cutoffvgg16 extracts for 2 epochs and finetunes for 2
# (TRAIN.EPOCHS 3); mobilenetv2 trains one epoch on 128 frames.
TRAIN_BATCH = 64
TRAIN_FRAMES, VAL_FRAMES, MBV2_FRAMES = 344, 96, 128
VGG_EXTRACT_EPOCHS, VGG_EPOCHS = 2, 3
# Loss on one fixed batch (the first 64 training frames, no augmentation,
# dropout 0, the first phase's optimizer and rate): the mean of the last 5
# of LOSS_STEPS steps must fall to LOSS_FALL[model] of the first step's
# loss or below. The bars were set from a CPU rehearsal of these steps; on
# an H100 80GB HBM3 at 700 W they give 0.855 for cutoffvgg16 (Adam 3e-4 on
# the head) and 0.983 for mobilenetv2 (Adam 1e-4 on fc0 and the logits).
LOSS_STEPS = 30
LOSS_FALL = {"cutoffvgg16": 0.92, "mobilenetv2": 0.995}
# Gradients of one depthwise layer on B2 against on the grouped conv,
# float32: relative Frobenius error of the output and the input and weight
# gradients.
DW_LAYER_RTOL = 1e-5
# GPU vs CPU one-step updates: an element's update is held within 1e-2 of
# lr where its float64 gradient is above G_FLAT. There the first step of
# Keras Adam (eps 1e-7 on sqrt(v), ~3.2e-6 on |g|) and of RMSprop (rho
# 0.9, eps 1e-7) is flat in g: a relative gradient error r moves it by at
# most 0.086 r lr (Adam; RMSprop 0.033 r lr). At 1e-6 the slope is up to
# 0.58, so float32 rounding of a gradient 1e-4 of its tensor's RMS moves
# the update past 1e-2 of lr.
G_FLAT = 3e-5
# A training batch norm's running statistics after one step against flax's
# rule on float64 statistics of its input: the mean's error over the
# input's RMS, the variance's over its mean square (the scale of float32
# rounding in E[x^2] - E[x]^2).
BN_STAT_RTOL = 1e-4
TRAIN_ITERS = 10


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


def graph_ms(fn, iters=ITERS, warmup=WARMUP):
    """Mean milliseconds per replay of ``fn`` captured once as a CUDA graph
    (warmed on a side stream first): the device's time for work whose
    eager launches take longer on the host than on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters, warmup=warmup)


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


def preprocess_bytes(b, src_hw, out_hw, mode, out_itemsize, with_mask,
                     blank=False):
    """Bytes the preprocess must move: the 32-byte sectors of the source
    rows its index map selects (computed for one frame and scaled by b,
    exact when a frame is a whole number of sectors; with ``blank``, not
    the pixels of the UI box, which need no read), its index vectors and
    mask reads, and one write of the output."""
    from ab_line_classifier_torch.ops.image import UI_BLANK_HW, nearest_indices

    hs, ws = src_hw
    hd, wd = out_hw
    rows = np.unique(nearest_indices(hs, hd, mode))
    cidx = nearest_indices(ws, wd, mode).astype(np.int64)

    def row_cols(r):
        c = cidx[cidx >= UI_BLANK_HW[1]] if blank and r < UI_BLANK_HW[0] \
            else cidx
        return (c[:, None] * 3 + np.arange(3)).ravel()

    px = sum(np.unique((r * ws * 3 + row_cols(r)) // 32).size
             for r in rows) * 32
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
    # The shapes of a batch-1 latency step, of the Grad-CAM batches and of
    # a training validation batch.
    for b, hs, ws in ((1, 128, 128), (ZOO_BATCH, 128, 128),
                      (ZOO_BATCH, 480, 640), (TRAIN_BATCH, 128, 128)):
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
          f"{n_calls - n_grid} at the Grad-CAM, batch-1 and training "
          f"validation shapes (1 x 128x128, {ZOO_BATCH} x 128x128 and "
          f"480x640, {TRAIN_BATCH} x 128x128; every mode and output dtype) "
          f"agree, max abs err {max_err}")

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
    mobilenetv2 at batch 1 (a latency step) and TRAIN_BATCH (its training
    steps and validation batches), in bf16 and float32; returns (number of
    launches, max abs err)."""
    n, err = 0, 0.0
    cases = {(ZOO_BATCH,) + shape[1:] + (k,) for name in ZOO
             for shape, k in shapes[name]}
    cases |= {(b,) + shape[1:] + (k,) for shape, k in shapes["mobilenetv2"]
              for b in (1, TRAIN_BATCH)}
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
          f"err {max_err}; {n_path} cases at the Grad-CAM, batch-1 and "
          f"training shapes (every distinct stride-1 layer of the three "
          f"models at batch {ZOO_BATCH} and of mobilenetv2 at batch 1 and "
          f"{TRAIN_BATCH}, bf16 and f32) equal, max abs err {path_err}")
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


def labelled_frames(n, seed):
    """uint8 ``[n, 128, 128, 3]`` frames and int64 labels from a numpy seed:
    speckle with 1-2 faint horizontal bands (class 0, A-line-like) or 3-5
    bright vertical streaks 8 pixels wide (class 1, B-line-like): class 1
    frames are brighter by ~30 gray levels on the mean, which survives the
    config's augmentation (rotations of any angle), so a model can learn
    the classes."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n).astype(np.int64)
    frames = rng.randint(20, 80, (n, *OUT_HW, 3)).astype(np.int32)
    for i, y in enumerate(labels):
        if y:
            for c in rng.randint(8, 116, rng.randint(3, 6)):
                frames[i, 16:, c:c + 8] += 150
        else:
            for r in rng.randint(16, 120, rng.randint(1, 3)):
                frames[i, r:r + 3, 8:120] += 60
    return np.clip(frames, 0, 255).astype(np.uint8), labels


class EpochSnapshots:
    """A fit callback that keeps a copy of the weights after each epoch."""

    def __init__(self):
        self.states = {}

    def on_epoch_end(self, epoch, state):
        self.states[epoch] = {k: v.detach().cpu().clone()
                              for k, v in state.items()}


def fixed_batch_losses(name, sd, images, labels, steps=LOSS_STEPS):
    """Losses of ``steps`` bf16 training steps of ``name``'s first phase
    (dropout 0, no augmentation) from weights ``sd`` on one batch."""
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
    from ab_line_classifier_torch.train.loop import Trainer

    spec = build_model(name, dict(ZOO_HPARAMS[name], DROPOUT=0.0),
                       OUT_HW + (3,), 2, mixed_precision=True)
    trainer = Trainer(spec, seed=1, compute_dtype=torch.bfloat16,
                      device=images.device)
    trainer.begin_phase(0, spec.phases[0], sd)
    mask = torch.ones(len(labels), device=trainer.device)
    metrics = M.init_metrics(trainer.spec.n_classes, device=trainer.device)
    losses = [trainer.train_step(images, labels, mask, metrics)
              for _ in range(steps)]
    return torch.stack(losses).float().cpu().numpy()


def check_loss_falls(name, losses):
    first, last = float(losses[0]), float(losses[-5:].mean())
    print(f"{name}: loss over {len(losses)} steps on one batch of "
          f"{TRAIN_BATCH} (dropout 0): first {first:.4f}, mean of the last "
          f"5 {last:.4f} ({last / first:.4f} of the first; bar "
          f"{LOSS_FALL[name]})", flush=True)
    if not (np.isfinite(losses).all() and last <= LOSS_FALL[name] * first):
        raise AssertionError(f"{name}: the loss on a fixed batch did not "
                             f"fall: {losses.round(4).tolist()}")


def train_cutoffvgg16(sd, tr, va, images, labels):
    """cutoffvgg16 at full width through both phases of its plan
    (``Trainer.fit``, bf16 compute, float32 master weights, the config's
    augmentation), then 30 steps on one fixed batch. Checks what each
    phase may move. Returns (B1, B2 launches)."""
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.benchmark import (TRAIN_AUG,
                                                            ZOO_HPARAMS)
    from ab_line_classifier_torch.train.loop import Trainer

    hp = dict(ZOO_HPARAMS["cutoffvgg16"], EXTRACT_EPOCHS=VGG_EXTRACT_EPOCHS)
    spec = build_model("cutoffvgg16", hp, OUT_HW + (3,), 2,
                       mixed_precision=True, total_epochs=VGG_EPOCHS)
    trainer = Trainer(spec, aug_config=TRAIN_AUG, seed=10001,
                      compute_dtype=torch.bfloat16, device="cuda")
    snaps = EpochSnapshots()
    PC.reset_launch_count()
    DC.reset_launch_count()
    t0 = time.perf_counter()
    final, hist = trainer.fit(tr, va, batch_size=TRAIN_BATCH,
                              epochs=VGG_EPOCHS, patience=15, variables=sd,
                              callbacks=[snaps], verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1, b2 = PC.launch_count, DC.launch_count
    val_batches = len(hist) * va.n_batches(TRAIN_BATCH)
    phases = [h.phase for h in hist]
    want = ["extract"] * VGG_EXTRACT_EPOCHS + ["finetune"] * (
        VGG_EPOCHS - VGG_EXTRACT_EPOCHS + 1)
    if phases != want or b1 != val_batches or b2:
        raise AssertionError(f"cutoffvgg16 fit: phases {phases}, preprocess "
                             f"launches {b1} for {val_batches} validation "
                             f"batches, depthwise launches {b2}")
    if any(p.dtype != torch.float32 for p in trainer.module.parameters()):
        raise AssertionError("the master weights are not float32")
    for h in hist:
        print(f"  [{h.phase}] epoch {h.epoch}: loss {h.train['loss']:.4f} "
              f"acc {h.train['accuracy']:.4f}, val loss "
              f"{h.val['loss']:.4f} acc {h.val['accuracy']:.4f} auc "
              f"{h.val['auc']:.4f}, lr {h.lr:.2e}", flush=True)
        if not all(np.isfinite(v) for v in (*h.train.values(),
                                            *h.val.values())):
            raise AssertionError(f"non-finite metrics in epoch {h.epoch}")
    extract_end = snaps.states[VGG_EXTRACT_EPOCHS - 1]
    moved = {"extract": [], "finetune": []}
    for k, v in sd.items():
        layer = k.split(".")[0]
        if not layer.startswith("block"):
            continue
        if not torch.equal(extract_end[k], v):
            moved["extract"].append(k)
        if not torch.equal(final[k], extract_end[k]):
            moved["finetune"].append(layer)
    if moved["extract"] or set(moved["finetune"]) != {"block3_conv2",
                                                      "block3_conv3"}:
        raise AssertionError(f"moved: {moved}")
    print(f"cutoffvgg16 fit: {len(hist)} epochs ({TRAIN_FRAMES} frames, "
          f"{VAL_FRAMES} validation) in {seconds:.2f} s; the backbone "
          f"bit-unchanged through extract, finetune moved only "
          f"block3_conv2/3; preprocess launches {b1} ({val_batches} "
          f"validation batches), depthwise {b2}", flush=True)
    losses = fixed_batch_losses("cutoffvgg16", sd, images[:TRAIN_BATCH],
                                labels[:TRAIN_BATCH])
    check_loss_falls("cutoffvgg16", losses)
    return PC.launch_count, DC.launch_count


def train_mobilenetv2(spec, sd, tr, va, images, labels):
    """mobilenetv2 through one phase of its plan (``Trainer.fit``, one
    epoch, bf16) with B2 launched 10 times per training forward and per
    validation batch and no input copied, then 30 steps on one fixed batch.
    Returns (B1, B2 launches)."""
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.predict.benchmark import TRAIN_AUG
    from ab_line_classifier_torch.train.loop import Trainer

    per_forward = ZOO["mobilenetv2"][1]
    trainer = Trainer(spec, aug_config=TRAIN_AUG, seed=10001,
                      compute_dtype=torch.bfloat16, device="cuda")
    PC.reset_launch_count()
    DC.reset_launch_count()
    _, hist = trainer.fit(tr, va, batch_size=TRAIN_BATCH, epochs=1,
                          variables=sd, verbose=False)
    steps, evals = tr.n_batches(TRAIN_BATCH), va.n_batches(TRAIN_BATCH)
    fit_counts = (PC.launch_count, DC.launch_count)
    if fit_counts != (evals, per_forward * (steps + evals)) \
            or DC.copy_count:
        raise AssertionError(f"mobilenetv2 fit: launches {fit_counts} for "
                             f"{steps} steps and {evals} validation "
                             f"batches, {DC.copy_count} input copies")
    h = hist[0]
    print(f"mobilenetv2 fit, 1 epoch: loss {h.train['loss']:.4f}, val loss "
          f"{h.val['loss']:.4f}; preprocess launches {fit_counts[0]}, "
          f"depthwise launches {fit_counts[1]} ({per_forward} in each of "
          f"{steps} training forwards and {evals} validation batches), "
          f"input copies {DC.copy_count}", flush=True)
    before = DC.launch_count
    losses = fixed_batch_losses("mobilenetv2", sd, images[:TRAIN_BATCH],
                                labels[:TRAIN_BATCH])
    if DC.launch_count - before != per_forward * len(losses) \
            or DC.copy_count:
        raise AssertionError(f"mobilenetv2: {DC.launch_count - before} "
                             f"depthwise launches in {len(losses)} steps")
    check_loss_falls("mobilenetv2", losses)
    return PC.launch_count, DC.launch_count


def step_gpu_vs_cpu(spec, sd, images, labels, smi):
    """One training step of each phase of ``spec`` (built with dropout 0) in
    float32 (TF32 off) from weights ``sd`` on the same un-augmented batch,
    on the GPU and on the CPU: loss and gradients by relative (Frobenius)
    error within F32_RTOL; frozen parameters bit-unchanged; the updated
    parameters by the magnitude-aware rule of the JAX package's Keras
    parity test. Adam's and RMSprop's first steps are about ``lr *
    sign(g)``, and steep in ``g`` where ``|g|`` nears eps, so an element
    whose gradient is within float32 noise of zero may move the other way.
    Which elements are held tight is decided from neither device's
    float32 result: a third step on the CPU computes in float64
    (``compute_dtype``), and an element counts where that gradient
    ``g64`` is above G_FLAT, where the first step is flat in ``g``. There
    the updates are held within 1e-2 of the learning rate (and these
    elements must be more than half); elsewhere within twice the first
    step's size. The float32 gradients' largest errors against ``g64``,
    over their tensor's RMS, are printed."""
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.train.loop import Trainer

    spec32 = dataclasses.replace(spec, dtype=torch.float32)
    mask = torch.ones(len(labels))
    for phase_idx, phase in enumerate(spec.phases):
        out = {}
        for key, dev, dtype in (("cuda", "cuda", torch.float32),
                                ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
            t = Trainer(spec32, seed=0, compute_dtype=dtype, device=dev)
            t.begin_phase(phase_idx, phase, sd)
            loss = t.train_step(images.to(dev), labels.to(dev),
                                mask.to(dev), M.init_metrics(2, device=dev))
            grads = {n: p.grad.detach().cpu()
                     for n, p in t.module.named_parameters()
                     if p.grad is not None}
            out[key] = (float(loss), grads, t.state())
        (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
        g64 = out["cpu64"][1]
        loss_err = abs(lg - lc) / abs(lc)
        grad_err = max(rel_err(gg[n], gc[n]) for n in gc)
        step = 1.0 if phase.optimizer == "adam" else 1.0 / np.sqrt(0.1)
        upd_err, n_flip, n_res, n_all, n_apart = 0.0, 0, 0, 0, 0
        noise = {"GPU": 0.0, "CPU": 0.0}
        for k, w0 in sd.items():
            if k not in gc:
                if not (torch.equal(sg[k], w0) and torch.equal(sc[k], w0)):
                    raise AssertionError(f"{spec.name} [{phase.name}]: "
                                         f"frozen {k} moved")
                continue
            d = (sg[k] - sc[k]).abs()
            g = g64[k].abs()
            rms = float(g.square().mean().sqrt())
            for dev, got in (("GPU", gg[k]), ("CPU", gc[k])):
                noise[dev] = max(noise[dev], float(
                    (got - g64[k]).abs().max()) / max(rms, 1e-30))
            flat = g > G_FLAT
            n_res += int(flat.sum())
            n_all += flat.numel()
            n_apart += int(((gg[k] - gc[k]).abs()[flat]
                            > 1e-3 * g[flat]).sum())
            if flat.any():
                upd_err = max(upd_err, float(d[flat].max()) / phase.lr)
            n_flip += int((d[~flat] > 1e-2 * phase.lr).sum())
            if float(d.max()) > 2 * step * phase.lr + 1e-7:
                raise AssertionError(f"{spec.name} [{phase.name}]: {k} "
                                     f"moved apart by {float(d.max())}")
        print(f"{spec.name} [{phase.name}] one step GPU vs CPU float32 "
              f"({smi}): loss {lg:.6f} / {lc:.6f} (relative "
              f"{loss_err:.2e}), gradients max relative {grad_err:.2e} "
              f"(bar {F32_RTOL:.0e}, {len(gc)} trained tensors); updates of "
              f"the {n_res} of {n_all} elements whose float64 gradient "
              f"is over {G_FLAT:.0e} within {upd_err:.2e} of lr (bar 1e-2; "
              f"{n_apart} of them with GPU and CPU gradients over 1e-3 "
              f"apart; float32 gradients off float64 by at most "
              f"{noise['GPU']:.2e} / {noise['CPU']:.2e} of their tensor's "
              f"RMS, GPU / CPU); "
              f"{n_flip} other elements moved apart by more, none beyond "
              f"twice the first step", flush=True)
        if not (loss_err <= F32_RTOL and grad_err <= F32_RTOL
                and upd_err <= 1e-2 and n_res > n_all / 2):
            raise AssertionError(f"{spec.name} [{phase.name}]: GPU vs CPU "
                                 f"step out of the bars")


def depthwise_gradients(spec, smi):
    """Gradients through B2, float32, TF32 off: at every distinct stride-1
    depthwise shape of ``spec`` (mobilenetv2) at batch TRAIN_BATCH, the
    output and the input and weight gradients (for one random upstream
    gradient) of ``depthwise_conv`` on B2 against the grouped conv's, on
    the same ``x`` and ``w``: relative Frobenius error within
    DW_LAYER_RTOL (B2's backward is the grouped conv's gradient; its
    forward agrees with cuDNN's to float32 rounding)."""
    from ab_line_classifier_torch.ops import depthwise as DW
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)

    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = sorted(set(depthwise_layer_shapes(spec)))
    layer_err = 0.0
    count0 = DC.launch_count
    for (_, h, w, c), k in shapes:
        x = torch.randn((TRAIN_BATCH, h, w, c), device="cuda",
                        generator=gen).permute(0, 3, 1, 2)
        wt = torch.randn((c, 1, k, k), device="cuda", generator=gen) / k
        g = torch.randn(x.shape, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last)
        outs = []
        for fn in (DW.depthwise_conv, DW.depthwise_reference):
            xi, wi = x.clone().requires_grad_(), wt.clone().requires_grad_()
            y = fn(xi, wi)
            outs.append((y.detach(),)
                        + torch.autograd.grad(y, (xi, wi), g))
        layer_err = max(layer_err,
                        *(rel_err(a, b) for a, b in zip(*outs)))
    launches = DC.launch_count - count0
    print(f"depthwise gradients through B2 vs the grouped conv, float32 "
          f"({smi}): {len(shapes)} layer shapes of {spec.name} at batch "
          f"{TRAIN_BATCH}, output and gradients max relative "
          f"{layer_err:.2e} (bar {DW_LAYER_RTOL:.0e}); B2 launched "
          f"{launches} times", flush=True)
    if layer_err > DW_LAYER_RTOL or launches != len(shapes):
        raise AssertionError("gradients through B2 differ from the grouped "
                             "conv's")


def bn_stat_errors(bn, stats):
    """Errors of ``bn``'s running statistics, moved by one training
    forward from zero, against flax's rule on float64 ``stats`` (mean,
    biased variance, mean square) of its input: the mean's error over the
    input's RMS and the variance's over its mean square."""
    mean, var, ms = stats
    m = 1.0 - bn.momentum
    mean_hat = bn.running_mean.double() / m
    var_hat = bn.running_var.double() / m
    return (float(((mean_hat - mean).abs() / ms.sqrt().clamp_min(1e-30))
                  .max()),
            float(((var_hat - var).abs() / ms.clamp_min(1e-30)).max()))


def bn_training_step(smi):
    """Batch norms that train, on the card: one bf16 training step of a
    full-width cnn0 (128x128, batch TRAIN_BATCH; its four batch norms
    train), its running statistics started at zero and held within
    BN_STAT_RTOL of flax's rule on float64 statistics of each layer's
    input (captured by a hook); a lone batch norm over 16 values per
    channel, where the unbiased variance would miss by 1/15; and the time
    of each of cnn0's batch norms in a training forward beside
    ``F.batch_norm`` alone (which keeps no statistics)."""
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
    from ab_line_classifier_torch.train.loop import Trainer

    def f64_stats(a):
        a = a.detach().double()
        dims = [d for d in range(a.ndim) if d != 1]
        return (a.mean(dims), a.var(dims, unbiased=False),
                (a * a).mean(dims))

    spec = build_model("cnn0", ZOO_HPARAMS["cnn0"], OUT_HW + (3,), 2,
                       mixed_precision=True)
    trainer = Trainer(spec, seed=0, compute_dtype=torch.bfloat16,
                      device="cuda")
    sd = {k: (torch.zeros_like(v) if k.endswith(("running_mean",
                                                  "running_var")) else v)
          for k, v in trainer.module.state_dict().items()}
    trainer.begin_phase(0, spec.phases[0], sd)
    bns = {n: m for n, m in trainer.module.named_modules()
           if isinstance(m, G.BatchNorm)}
    stats, inputs = {}, {}

    def capture(name):
        def hook(bn, args):
            stats[name] = f64_stats(args[0])
            inputs[name] = (tuple(args[0].shape), args[0].dtype)
        return hook

    hooks = [m.register_forward_pre_hook(capture(n)) for n, m in bns.items()]
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randint(0, 256, (TRAIN_BATCH, *OUT_HW, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    labels = torch.randint(0, 2, (TRAIN_BATCH,), device="cuda",
                           generator=gen)
    try:
        trainer.train_step(images, labels,
                           torch.ones(TRAIN_BATCH, device="cuda"),
                           M.init_metrics(2, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    errs = {n: bn_stat_errors(bns[n], stats[n]) for n in bns}
    mean_err = max(e[0] for e in errs.values())
    var_err = max(e[1] for e in errs.values())

    lone = G.BatchNorm(8).to("cuda").train()
    lone.running_var.zero_()
    x = (torch.randn((4, 8, 2, 2), device="cuda", generator=gen) * 2
         + 1).to(torch.bfloat16)
    lone(x)
    mean64, var64, ms64 = f64_stats(x)
    lone_err = bn_stat_errors(lone, (mean64, var64, ms64))
    unbiased_err = float(((var64 * 16 / 15 - var64) / ms64).max())

    times = []
    with torch.no_grad():
        for n, (shape, dtype) in inputs.items():
            a = torch.randn(shape, device="cuda", generator=gen).to(
                dtype).contiguous(memory_format=torch.channels_last)
            bn = G.BatchNorm(shape[1]).to("cuda").train()
            times.append((cuda_ms(lambda: bn(a)), cuda_ms(
                lambda: F.batch_norm(a, None, None, bn.weight, bn.bias,
                                     True, 0.0, bn.epsilon))))
    layers = ", ".join(f"{'x'.join(map(str, s))} {t:.4f} / {p:.4f}"
                       for ((s, _), (t, p)) in zip(inputs.values(), times))
    print(f"batch norms training on {smi}: cnn0 128x128 batch "
          f"{TRAIN_BATCH}, {len(bns)} layers, inputs "
          f"{sorted({str(d) for _, d in inputs.values()})}; running "
          f"statistics against flax's rule on float64 statistics: mean "
          f"{mean_err:.2e} of the RMS, variance {var_err:.2e} of the mean "
          f"square (bar {BN_STAT_RTOL:.0e}); a lone layer over 16 values a "
          f"channel {lone_err[0]:.2e} / {lone_err[1]:.2e} (the unbiased "
          f"variance would be {unbiased_err:.2e} off); ms per training "
          f"forward, layer / F.batch_norm alone: {layers}", flush=True)
    if max(mean_err, var_err, *lone_err) > BN_STAT_RTOL \
            or unbiased_err <= BN_STAT_RTOL:
        raise AssertionError(f"batch-norm statistics: {errs}, lone "
                             f"{lone_err}")


def training_throughput(spec, sd, bs, smi):
    """``training_throughput_benchmark`` of every phase of ``spec`` at
    batch ``bs`` (frames/s, share of bf16 peak from the shape-counted
    FLOPs), and a profiled step of each phase (device idle share, top
    kernels)."""
    from ab_line_classifier_torch.predict.benchmark import (
        TRAIN_AUG, training_throughput_benchmark)
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.train.loop import Trainer

    r = training_throughput_benchmark(batch_size=bs, img_dim=OUT_HW,
                                      n_warmup=WARMUP, n_iters=TRAIN_ITERS,
                                      state_dict=sd, spec=spec,
                                      device="cuda", verbose=False)
    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.randint(0, 256, (bs, *OUT_HW, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.randint(0, 2, (bs,), device="cuda", generator=gen)
    mask = torch.ones(bs, device="cuda")
    trainer = Trainer(spec, aug_config=TRAIN_AUG, seed=0,
                      compute_dtype=spec.dtype, device="cuda")
    for phase_idx, (ph, res) in enumerate(zip(spec.phases, r["phases"])):
        trainer.begin_phase(phase_idx, ph, sd)
        metrics = M.init_metrics(2, device="cuda")
        prof = device_time_by_kernel(
            lambda: trainer.train_step(images, labels, mask, metrics))
        wall, busy = prof["wall_ms"], prof["busy_ms"]
        share = (res["train_frames_per_sec"] * res["flops_per_frame"]
                 / PEAK_BF16_FLOPS)
        print(f"training throughput on {smi}: {spec.name} [{ph.name}] "
              f"128x128 batch {bs}: {res['train_frames_per_sec']:.1f} "
              f"frames/s, {res['ms_per_step']:.3f} ms/step, "
              f"{res['flops_per_frame'] / 1e9:.4f} GFLOP/frame, "
              f"{100 * share:.2f}% of 989 TFLOP/s bf16; profiled step: wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
              f"{1 - busy / wall:.4f})", flush=True)
        for kname, ms in prof["kernels"][:8]:
            print(f"  {ms:9.3f} ms {100 * ms / wall:6.2f}%  {kname[:110]}")
        ms = sum(v for k, v in prof["kernels"]
                 if any(key in k for key in KERNEL_KEYS["depthwise"]))
        print(f"  depthwise kernel: {ms:.4f} ms; copy and fill kernels by "
              f"the operator that launched them: "
              + ", ".join(f"{op} {t:.3f} ms" for op, t in prof["copies"][:6]),
              flush=True)


def phase_training(vgg_sd, mbv2, mbv2_sd, smi):
    """Phase 11: the training path (module docstring). Returns the
    training path's (B1, B2) launches."""
    from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset

    images, labels = labelled_frames(TRAIN_FRAMES + VAL_FRAMES, seed=11)
    tr = DeviceCachedDataset.from_arrays(images[:TRAIN_FRAMES],
                                         labels[:TRAIN_FRAMES], "cuda")
    va = DeviceCachedDataset.from_arrays(images[TRAIN_FRAMES:],
                                         labels[TRAIN_FRAMES:], "cuda")
    fixed_images, fixed_labels = tr.frames, tr.labels_dev
    vgg = train_cutoffvgg16(vgg_sd, tr, va, fixed_images, fixed_labels)
    small_tr = DeviceCachedDataset.from_arrays(
        images[:MBV2_FRAMES], labels[:MBV2_FRAMES], "cuda")
    mb = train_mobilenetv2(mbv2, mbv2_sd, small_tr, va, fixed_images,
                           fixed_labels)
    launches = (vgg[0] + mb[0], vgg[1] + mb[1])

    # Checks and measurements outside the path's counted run.
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS

    vgg_spec = build_model("cutoffvgg16", ZOO_HPARAMS["cutoffvgg16"],
                           OUT_HW + (3,), 2, mixed_precision=True)
    # Dropout 0: the GPU's and the CPU's generators draw different masks.
    no_dropout = build_model(
        "cutoffvgg16", dict(ZOO_HPARAMS["cutoffvgg16"], DROPOUT=0.0),
        OUT_HW + (3,), 2, mixed_precision=True)
    batch = torch.as_tensor(images[:TRAIN_BATCH])
    step_gpu_vs_cpu(no_dropout, vgg_sd, batch,
                    torch.as_tensor(labels[:TRAIN_BATCH]), smi)
    depthwise_gradients(mbv2, smi)
    bn_training_step(smi)
    for bs in (256, 1024):
        training_throughput(vgg_spec, vgg_sd, bs, smi)
    training_throughput(mbv2, mbv2_sd, 256, smi)
    return launches


# Phase 12 (cross-validation and hyperparameter search): 24 patients of 20
# frames; 3 folds (config.yml's N_FOLDS is 5: cut for the smoke's time),
# K_FOLD_VALIDATION_SPLIT 0.1; one epoch a phase; a Bayesian sweep of 4
# trials (the fourth suggestion from the GP) over config.yml's mobilenetv2
# space. Peak memory of the last run within MEM_DRIFT of the first's.
EXP_PATIENTS, EXP_FRAMES_PER_PATIENT, EXP_FOLDS, EXP_TRIALS = 24, 20, 3, 4
MEM_DRIFT = 0.05
MBV2_SEARCH = {"LR": {"TYPE": "float_log", "RANGE": [1e-5, 1e-3]},
               "DROPOUT": {"TYPE": "float_uniform", "RANGE": [0.0, 0.5]}}


class Interrupted(Exception):
    pass


def experiment_config(root, model, experiment):
    """The port's Config for ``model`` at 128x128 with config.yml's values
    (built as a dict: the card has no PyYAML), every output under
    ``root``, one epoch a phase, batch 64. Sweeps score by the validation
    loss (config.yml: AUC, which sits at 0.5 for every trial after one
    epoch from random weights, and a GP over one value tests nothing)."""
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.predict.benchmark import (TRAIN_AUG,
                                                            ZOO_HPARAMS)

    paths = {k: os.path.join(root, k.lower()) for k in (
        "EXPERIMENTS", "IMAGES", "MODEL_WEIGHTS", "EXPERIMENT_VISUALIZATIONS",
        "LOGS")}
    return Config({
        "PATHS": dict(paths, FRAMES=root),
        "WANDB": {"ARTIFACT_SEED": 42},
        "TRACKER": {"BACKEND": "local", "DIR": os.path.join(root, "runs")},
        "DATA": {"IMG_DIM": list(OUT_HW), "CLASSES": ["a_lines", "b_lines"],
                 "K_FOLD_VALIDATION_SPLIT": 0.1},
        "TRAIN": {"MODEL_DEF": model, "EXPERIMENT_TYPE": experiment,
                  "SEED": 10001, "BATCH_SIZE": TRAIN_BATCH, "EPOCHS": 1,
                  "PATIENCE": 15, "MIXED_PRECISION": True,
                  "CACHE_DATASET": "auto", "DATA_AUG": TRAIN_AUG,
                  "HPARAM_SEARCH": {"N_EVALS": EXP_TRIALS, "METHOD": "bayes",
                                    "METRIC_GOAL": "minimize",
                                    "METRIC_NAME": "epoch/val_loss",
                                    "BACKEND": "native"}},
        "HPARAMS": {"CUTOFFVGG16": dict(ZOO_HPARAMS["cutoffvgg16"],
                                        EXTRACT_EPOCHS=1),
                    "MOBILENETV2": ZOO_HPARAMS["mobilenetv2"]},
        "HPARAM_SEARCH": {"MOBILENETV2": MBV2_SEARCH}})


def grouped_folds(patients, n_folds, val_split, seed):
    """A patient-grouped fold set without sklearn: the patients shuffled
    by ``np.random.RandomState(seed)`` and dealt to the folds in turn; fold
    k tests on its own patients, validates on the first ``val_split`` of
    the others' (at least one) and trains on the rest."""
    from ab_line_classifier_torch.data.splits import FoldSet

    ids = np.random.RandomState(seed).permutation(np.unique(patients))
    fold_of = {p: i % n_folds for i, p in enumerate(ids)}
    rows = np.arange(len(patients))
    fold = np.array([fold_of[p] for p in patients])
    out = FoldSet([], [], [])
    for k in range(n_folds):
        rest = [p for p in ids if fold_of[p] != k]
        val_ids = rest[:max(1, round(val_split * len(rest)))]
        in_val = np.isin(patients, val_ids)
        out.train.append(rows[(fold != k) & ~in_val])
        out.val.append(rows[in_val])
        out.test.append(rows[fold == k])
        groups = [set(patients[r]) for r in (out.train[k], out.val[k],
                                              out.test[k])]
        if any(a & b for a, b in itertools.combinations(groups, 2)):
            raise AssertionError(f"fold {k}: a patient in two sets")
    return out


class RunMeter:
    """Per run of ``perform_single_run`` (the port's functions wrapped, not
    copied): wall and setup seconds (to ``Trainer.fit``'s start: model
    build, weight upload, the run's frames cached on the card), training
    frames/s (frames over the training epochs' time, synchronized), the
    kernels' launches, B2's input copies and the peak of
    ``torch.cuda.max_memory_allocated``. ``stop_at`` makes that run raise
    :class:`Interrupted` as it starts."""

    def __init__(self, stop_at=None):
        self.runs, self.stop_at = [], stop_at

    def __enter__(self):
        from ab_line_classifier_torch.ops import depthwise_cuda as DC
        from ab_line_classifier_torch.ops import preprocess_cuda as PC
        from ab_line_classifier_torch.train import experiment as E
        from ab_line_classifier_torch.train.loop import Trainer

        self.saved = (E.perform_single_run, Trainer.fit, Trainer.run_epoch)
        run_fn, fit, run_epoch = self.saved
        meter = self

        def perform_single_run(cfg, **kw):
            key = kw.get("fold_id", kw.get("hparam_overrides"))
            if meter.stop_at is not None and len(meter.runs) == meter.stop_at:
                raise Interrupted
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = {"run": key, "t0": time.perf_counter(), "train_s": 0.0,
                   "frames": 0, "pre": PC.launch_count,
                   "dw": DC.launch_count, "copies": DC.copy_count}
            meter.runs.append(rec)
            result = run_fn(cfg, **kw)
            torch.cuda.synchronize()
            rec.update(wall=time.perf_counter() - rec["t0"],
                       pre=PC.launch_count - rec["pre"],
                       dw=DC.launch_count - rec["dw"],
                       copies=DC.copy_count - rec["copies"],
                       peak=torch.cuda.max_memory_allocated(),
                       result=result)
            return result

        def timed_fit(trainer, *a, **kw):
            meter.runs[-1]["setup"] = time.perf_counter() - meter.runs[-1][
                "t0"]
            return fit(trainer, *a, **kw)

        def timed_epoch(trainer, dataset, batch_size, *, train, **kw):
            if not train:
                return run_epoch(trainer, dataset, batch_size, train=train,
                                 **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_epoch(trainer, dataset, batch_size, train=train, **kw)
            torch.cuda.synchronize()
            meter.runs[-1]["train_s"] += time.perf_counter() - t0
            meter.runs[-1]["frames"] += len(dataset)
            return out

        E.perform_single_run = perform_single_run
        Trainer.fit, Trainer.run_epoch = timed_fit, timed_epoch
        return self

    def __exit__(self, *exc):
        from ab_line_classifier_torch.train import experiment as E
        from ab_line_classifier_torch.train.loop import Trainer

        E.perform_single_run, Trainer.fit, Trainer.run_epoch = self.saved
        return False


def check_runs(label, runs, source, per_forward, smi):
    """Print each run's numbers; hold its launches to the count its data
    gives (B1: each validation batch of each epoch, the prediction table's
    one batch an epoch and each test batch; B2: ``per_forward`` in each of
    those and each training forward), no input copied, and the last run's
    peak memory within MEM_DRIFT of the first's."""
    def nb(n):
        return -(-n // TRAIN_BATCH)

    for rec, (tr, va, te) in zip(runs, source):
        epochs = len(rec["result"].history)
        evals = epochs * (nb(len(va)) + 1) + nb(len(te))
        want = (evals, per_forward * (epochs * nb(len(tr)) + evals))
        print(f"{label} {rec['run']} on {smi}: wall {rec['wall']:.3f} s, "
              f"setup {rec['setup']:.3f} s, training "
              f"{rec['frames'] / rec['train_s']:.1f} frames/s ({epochs} "
              f"epochs of {len(tr)} frames), val {len(va)}, test "
              f"{len(te)}; preprocess launches {rec['pre']}, depthwise "
              f"{rec['dw']}, input copies {rec['copies']}; "
              f"max_memory_allocated {rec['peak']} bytes; test "
              f"accuracy {rec['result'].test_metrics['accuracy']:.4f}",
              flush=True)
        if (rec["pre"], rec["dw"]) != want or rec["copies"]:
            raise AssertionError(f"{label} {rec['run']}: launches "
                                 f"{(rec['pre'], rec['dw'])}, want {want}, "
                                 f"copies {rec['copies']}")
    first, last = runs[0]["peak"], runs[-1]["peak"]
    print(f"{label}: peak memory first run {first}, last {last} "
          f"({last / first - 1:+.4f}; bar {MEM_DRIFT})", flush=True)
    if abs(last / first - 1) > MEM_DRIFT:
        raise AssertionError(f"{label}: peak memory drifts from {first} to "
                             f"{last}")


def phase_experiments(smi):
    """Phase 12: ``cross_validation`` (cutoffvgg16) with an interruption
    and a resume, and a Bayesian ``hparam_search`` (mobilenetv2), both
    through the array seam (``FoldSource``). Returns each path's (B1, B2)
    launches."""
    import shutil

    from ab_line_classifier_torch.data.pipeline import FrameArrays
    from ab_line_classifier_torch.data.splits import FoldSet
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.train import experiment as E
    from ab_line_classifier_torch.train.sweep import (make_controller,
                                                      replay_trials,
                                                      space_from_config)

    root = os.path.join(REPO, "build", "phase12")
    shutil.rmtree(root, ignore_errors=True)
    n = EXP_PATIENTS * EXP_FRAMES_PER_PATIENT
    images, labels = labelled_frames(n, seed=12)
    patients = np.repeat(np.arange(EXP_PATIENTS), EXP_FRAMES_PER_PATIENT)
    frames = FrameArrays(images, labels, [f"frame{i:04d}.png"
                                          for i in range(n)])
    folds = grouped_folds(patients, EXP_FOLDS, 0.1, seed=42)
    launches = {}

    cfg = experiment_config(os.path.join(root, "kfold"), "cutoffvgg16",
                            "cross_validation")
    source = E.FoldSource(frames, folds)
    records = os.path.join(cfg["PATHS"]["EXPERIMENTS"], "kfold-smoke.jsonl")
    PC.reset_launch_count()
    DC.reset_launch_count()
    t0 = time.perf_counter()
    with RunMeter(stop_at=1) as first:
        try:
            E.cross_validation(cfg, group="kfold-smoke", verbose=False,
                               device="cuda", source=source)
            raise AssertionError("the interrupted run went on")
        except Interrupted:
            pass
    with open(records, "rb") as f:
        done = f.read()
    with RunMeter() as rest:
        summary = E.cross_validation(cfg, group="kfold-smoke", resume=True,
                                     verbose=False, device="cuda",
                                     source=source)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(records, "rb") as f:
        after = f.read()
    runs = first.runs + rest.runs
    if ([r["run"] for r in runs] != list(range(EXP_FOLDS))
            or not after.startswith(done) or done.count(b"\n") != 1
            or after.count(b"\n") != EXP_FOLDS):
        raise AssertionError(f"cross-validation resume: runs "
                             f"{[r['run'] for r in runs]}, records {after!r}")
    check_runs("cross_validation fold", runs,
               [folds.fold(k) for k in range(EXP_FOLDS)], 0, smi)
    if (sum(r["pre"] for r in runs), sum(r["dw"] for r in runs)) != (
            PC.launch_count, DC.launch_count):
        raise AssertionError("launches outside the folds' runs")
    launches["cross_validation"] = (PC.launch_count, DC.launch_count)
    serial = {"cross_validation": serial_stats(runs, seconds)}
    stats = {r["fold"]: r for r in summary}
    print(f"cross_validation: {EXP_FOLDS} folds of cutoffvgg16 128x128 "
          f"({n} frames, {EXP_PATIENTS} patients) in {seconds:.2f} s, "
          f"interrupted after fold 0 and resumed (fold 0's record "
          f"byte-identical, folds 1-2 run on resume); accuracy mean "
          f"{stats['mean']['accuracy']:.4f} std "
          f"{stats['std']['accuracy']:.4f}, AUC mean "
          f"{stats['mean'].get('macro_mean_auc', float('nan')):.4f}",
          flush=True)
    if len(summary) != EXP_FOLDS + 2 or not all(
            np.isfinite(r["accuracy"]) for r in summary):
        raise AssertionError(f"cross-validation summary: {summary}")

    cfg = experiment_config(os.path.join(root, "sweep"), "mobilenetv2",
                            "hparam_search")
    split = FoldSet(*([part] for part in folds.fold(0)))
    source = E.FoldSource(frames, split)
    PC.reset_launch_count()
    DC.reset_launch_count()
    t0 = time.perf_counter()
    with RunMeter() as sweep:
        out = E.hparam_search(cfg, sweep_id="sweep-smoke", verbose=False,
                              device="cuda", source=source)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_runs("hparam_search trial", sweep.runs, [split.fold(0)] * len(
        sweep.runs), ZOO["mobilenetv2"][1], smi)
    launches["hparam_search"] = (PC.launch_count, DC.launch_count)
    serial["hparam_search"] = serial_stats(sweep.runs, seconds)
    trials = out["trials"]
    replay = make_controller("bayes", space_from_config(MBV2_SEARCH),
                             seed=10001)
    replay_trials(replay, trials[:-1])
    gp = replay.suggest()
    want = {k: v for k, v in trials[-1].items()
            if k not in ("trial", "objective")}
    print(f"hparam_search: {len(trials)} bayes trials of mobilenetv2 "
          f"128x128 in {seconds:.2f} s; objectives (-val loss) "
          f"{[round(t['objective'], 6) for t in trials]}; trial "
          f"{len(trials) - 1} (the GP's) {want}, the CPU's replay of the "
          f"card's {len(trials) - 1} observations suggests {gp}", flush=True)
    if len(trials) != EXP_TRIALS or gp != want:
        raise AssertionError(f"the GP's suggestion on the card {want} is not "
                             f"the CPU replay's {gp}")
    if DC.copy_count:
        raise AssertionError(f"{DC.copy_count} depthwise input copies")
    return launches, serial


def serial_stats(runs, seconds):
    """Phase 12's numbers of one experiment, for phase 13 to print beside
    its own: wall seconds, runs, training frames/s over all runs, the
    largest peak memory."""
    return {"wall": seconds, "runs": len(runs),
            "fps": sum(r["frames"] for r in runs)
            / sum(r["train_s"] for r in runs),
            "peak": max(r["peak"] for r in runs)}


# Phase 13 (trial-parallel): phase 12's data; cutoffvgg16 over its 3 folds
# and mobilenetv2 over 4 LR trials, then config.yml's own counts (N_FOLDS
# 5, N_EVALS 10). B2's trial launch is held against F one-trial launches
# and the plain version at F = 4 and 10, batch 64; one stacked float32 step
# against F serial steps at TP_STEP_TRIALS trials.
TP_FULL_FOLDS, TP_FULL_TRIALS = 5, 10
TP_DW_TRIALS = (4, 10)
TP_STEP_TRIALS = {"cutoffvgg16": 3, "mobilenetv2": 4}


def stacked_depthwise_case(shape, k, n_trials, dtype, gen):
    """F trials' ``[B, H, W, C]`` inputs in the layout vmap's rules leave
    (memory ``[B, H, W, F, C]``) as the ``[B, F, C, H, W]`` view, and
    their ``[F, C, 1, K, K]`` weights."""
    b, h, w, c = shape
    x = torch.randn((b, h, w, n_trials, c), device="cuda",
                    generator=gen).to(dtype)
    wt = (torch.randn((n_trials, c, 1, k, k), device="cuda", generator=gen)
          / k).to(dtype)
    return x.permute(0, 3, 4, 1, 2), wt


def trial_launch_checks(spec, smi):
    """B2's launch over F trials (``torch.func.vmap`` of the depthwise
    entry point: ``depthwise_trials``, trial-major ``F * C`` channels) at
    every stride-1 shape of ``spec`` (mobilenetv2) at batch TRAIN_BATCH,
    F in TP_DW_TRIALS, bf16 and f32: one launch, no input copied, each
    trial ``torch.equal`` to its own one-trial launch and to the plain
    version; float32 gradients of the stacked call within DW_LAYER_RTOL of
    each trial's grouped conv; and per forward (the 10 layers) the trial
    launch's time beside F one-trial launches, cuDNN's grouped conv over
    the F * C channels, the plain version and the bytes bound, each as
    CUDA-graph replays (at batch 64 an eager launch takes longer on the
    host than on the card), and the eager launches' time beside. Returns
    the timings by F."""
    from ab_line_classifier_torch.ops import depthwise as DW
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)

    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = depthwise_layer_shapes(spec)
    vdw = torch.func.vmap(DW.depthwise_conv, in_dims=(1, 0))
    n_cases, grad_err = 0, 0.0
    for n, dtype in itertools.product(TP_DW_TRIALS,
                                      (torch.float32, torch.bfloat16)):
        for shape, k in sorted(set(shapes)):
            x, wt = stacked_depthwise_case((TRAIN_BATCH,) + shape[1:], k, n,
                                           dtype, gen)
            launches, copies = DC.launch_count, DC.copy_count
            y = vdw(x, wt)
            if (DC.launch_count - launches, DC.copy_count - copies) != (1, 0):
                raise AssertionError(f"trial launch at {shape} F={n}: "
                                     f"{DC.launch_count - launches} launches"
                                     f", {DC.copy_count - copies} copies")
            for t in range(n):
                xt = x[:, t].contiguous(memory_format=torch.channels_last)
                one = DC.cuda_depthwise(xt, DC.pack_weight(wt[t]))
                if not (torch.equal(y[t], one) and torch.equal(
                        y[t], DW.depthwise_plain(xt, wt[t]))):
                    raise AssertionError(f"trial launch {shape} K={k} F={n} "
                                         f"{dtype}: trial {t} differs")
            n_cases += 1
            if n == TP_DW_TRIALS[0] and dtype == torch.float32:
                xg = x.clone().requires_grad_()
                wg = wt.clone().requires_grad_()
                yg = vdw(xg, wg)
                g = torch.randn(yg.shape, device="cuda", generator=gen)
                gx, gw = torch.autograd.grad(yg, (xg, wg), g)
                for t in range(n):
                    xr = x[:, t].clone().requires_grad_()
                    wr = wt[t].clone().requires_grad_()
                    yr = DW.depthwise_reference(xr, wr)
                    rx, rw = torch.autograd.grad(yr, (xr, wr), g[t])
                    grad_err = max(grad_err, rel_err(gx[:, t], rx),
                                   rel_err(gw[t], rw))
    print(f"B2 trial launch ({smi}): {n_cases} cases ({len(set(shapes))} "
          f"stride-1 mobilenetv2 shapes at batch {TRAIN_BATCH}, F in "
          f"{TP_DW_TRIALS}, f32 and bf16) each one launch, no copy, every "
          f"trial equal to its own launch and to the plain version; "
          f"stacked float32 gradients vs each trial's grouped conv max "
          f"relative {grad_err:.2e} (bar {DW_LAYER_RTOL:.0e})", flush=True)
    if grad_err > DW_LAYER_RTOL:
        raise AssertionError("stacked depthwise gradients differ from the "
                             "grouped conv's")

    timings = {}
    for n in TP_DW_TRIALS:
        cases = [stacked_depthwise_case((TRAIN_BATCH,) + s[1:], k, n,
                                        torch.bfloat16, gen)
                 for s, k in shapes]
        wide = [(x.reshape(x.shape[0], -1, *x.shape[3:]),
                 wt.reshape(-1, 1, *wt.shape[-2:])) for x, wt in cases]
        packed = [DC.pack_weight(w) for _, w in wide]
        ones = [[(x[:, t].contiguous(memory_format=torch.channels_last),
                  DC.pack_weight(wt[t])) for t in range(n)]
                for x, wt in cases]
        def trial(wide=wide, packed=packed):
            return [DC.cuda_depthwise(x, p)
                    for (x, _), p in zip(wide, packed)]

        def one(ones=ones):
            return [DC.cuda_depthwise(x, p) for layer in ones
                    for x, p in layer]

        def library(wide=wide):
            return [F.conv2d(x, w, padding=w.shape[-1] // 2,
                             groups=x.shape[1]) for x, w in wide]

        def plain(wide=wide):
            return [DW.depthwise_plain(x, w) for x, w in wide]

        t = {"ms": graph_ms(trial), "one_trial_launches_ms": graph_ms(one),
             "library_ms": graph_ms(library),
             "plain_ms": graph_ms(plain, iters=3, warmup=1),
             "eager_ms": cuda_ms(trial),
             "one_trial_launches_eager_ms": cuda_ms(one)}
        bounds = [depthwise_bound((TRAIN_BATCH, s[1], s[2], s[3] * n), k, 2)
                  for s, k in shapes]
        t["bound_ms"] = sum(b[0] for b in bounds)
        t["bound_by"] = ("bytes" if all(b[1] == "bytes" for b in bounds)
                         else "operations")
        timings[n] = t
        print(f"B2 trial launch F={n} per mobilenetv2 forward (10 layers, "
              f"batch {TRAIN_BATCH}, bf16, {smi}), CUDA-graph replays: "
              f"{t['ms']:.4f} ms; {n} one-trial launches a layer "
              f"{t['one_trial_launches_ms']:.4f} ms; cuDNN grouped conv over "
              f"F*C channels {t['library_ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.1f}% of "
              f"it); launched eagerly {t['eager_ms']:.4f} ms, one-trial "
              f"launches {t['one_trial_launches_eager_ms']:.4f} ms",
              flush=True)
    return timings


def stacked_vs_serial_step(name, n, smi):
    """One stacked float32 step (TF32 off, no augmentation, dropout 0) of
    ``n`` trials of ``name`` at full width, each trial from its own seeded
    weights with its own class weights and batch, against each trial's
    serial ``Trainer`` step on the card, for every phase: the updates held
    by the train-step rule (an element whose float64 gradient, a serial
    float64 step on the card with the depthwise layers on the grouped
    conv, is above G_FLAT and above 0.1 of its tensor's RMS, within 1e-2
    of lr; every element within twice the first step; frozen tensors
    bit-equal), the gradients within F32_RTOL (relative Frobenius) and the
    loss within F32_RTOL."""
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import depthwise as DW
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer, _stack)
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
    from ab_line_classifier_torch.train.loop import Trainer

    spec = build_model(name, dict(ZOO_HPARAMS[name], DROPOUT=0.0),
                       OUT_HW + (3,), 2)
    images, labels = labelled_frames(n * TRAIN_BATCH, seed=13)
    images = torch.as_tensor(images).view(n, TRAIN_BATCH, *OUT_HW, 3).cuda()
    labels = torch.as_tensor(labels).view(n, TRAIN_BATCH).cuda()
    mask = torch.ones((n, TRAIN_BATCH), device="cuda")
    mask[-1, -8:] = 0.0
    cw = np.stack([np.array([1.0 + 0.1 * t, 1.0 - 0.05 * t], np.float32)
                   for t in range(n)])
    states = [Trainer(spec, seed=t, device="cpu").state() for t in range(n)]

    def serial(t, phase_idx, dtype):
        tr = Trainer(spec, class_weight=dict(enumerate(cw[t].tolist())),
                     compute_dtype=dtype, device="cuda")
        if dtype == torch.float64:
            for m in tr.module.modules():
                if isinstance(m, G.BatchNorm):
                    for p_ in m.parameters(recurse=False):
                        p_.data = p_.data.double()
                    for bn, b_ in list(m.named_buffers(recurse=False)):
                        setattr(m, bn, b_.double())
        tr.begin_phase(phase_idx, spec.phases[phase_idx], states[t])
        metrics = M.init_metrics(2, device="cuda")
        loss = tr.train_step(images[t], labels[t], mask[t], metrics)
        grads = {k: p_.grad.detach().double()
                 for k, p_ in tr.module.named_parameters()
                 if p_.grad is not None}
        return float(loss), grads, tr.state()

    for phase_idx, phase in enumerate(spec.phases):
        pt = ParallelFoldTrainer(spec, n, class_weights=cw, device="cuda")
        pnames = {k for k, _ in pt.module.named_parameters()}
        params = {k: _stack([s[k] for s in states], "cuda")
                  for k in states[0] if k in pnames}
        buffers = {k: _stack([s[k] for s in states], "cuda")
                   for k in states[0] if k not in pnames}
        opt = pt.begin_phase(phase_idx, phase, params)
        dc0 = (DC.launch_count, DC.copy_count)
        losses = pt.train_step(params, buffers, opt, images, labels, mask,
                               np.ones(n), np.ones(n),
                               M.init_metrics(2, device="cuda", trials=n))
        dw = DC.launch_count - dc0[0]
        step = 1.0 if phase.optimizer == "adam" else 1.0 / np.sqrt(0.1)
        upd_err, grad_err, loss_err, n_held, n_all = 0.0, 0.0, 0.0, 0, 0
        for t in range(n):
            loss, grads, sd = serial(t, phase_idx, torch.float32)
            supported = DW._supported
            DW._supported = lambda *a: False
            try:
                _, g64, _ = serial(t, phase_idx, torch.float64)
            finally:
                DW._supported = supported
            loss_err = max(loss_err, abs(float(losses[t]) - loss) / abs(loss))
            for k, w0 in states[t].items():
                got = (params[k] if k in params else buffers[k])[t].detach()
                got = got.cpu()
                if k not in grads:
                    if not (torch.equal(got, w0) and torch.equal(sd[k], w0)):
                        raise AssertionError(f"{name} [{phase.name}] trial "
                                             f"{t}: frozen {k} moved")
                    continue
                grad_err = max(grad_err, rel_err(
                    params[k].grad[t].double(), grads[k]))
                g = g64[k].abs().cpu()
                held = (g > G_FLAT) & (g > 0.1 * g.square().mean().sqrt())
                d = (got - sd[k]).abs()
                n_held += int(held.sum())
                n_all += held.numel()
                if held.any():
                    upd_err = max(upd_err, float(d[held].max()) / phase.lr)
                if float(d.max()) > 2 * step * phase.lr + 1e-7:
                    raise AssertionError(f"{name} [{phase.name}] trial {t}: "
                                         f"{k} apart by {float(d.max())}")
        print(f"{name} [{phase.name}] one stacked float32 step of {n} trials "
              f"vs {n} serial steps on {smi}: loss max relative "
              f"{loss_err:.2e}, gradients max relative {grad_err:.2e} (bar "
              f"{F32_RTOL:.0e}); updates of the {n_held} of {n_all} "
              f"elements held (float64 gradient over {G_FLAT:.0e} and 0.1 "
              f"of its tensor's RMS) within {upd_err:.2e} of lr (bar 1e-2); "
              f"B2 launches in the stacked step {dw}", flush=True)
        if not (loss_err <= F32_RTOL and grad_err <= F32_RTOL
                and upd_err <= 1e-2 and n_held > 0):
            raise AssertionError(f"{name} [{phase.name}]: stacked step out "
                                 f"of the bars")
        want_dw = 10 if name == "mobilenetv2" else 0
        if dw != want_dw or DC.copy_count != dc0[1]:
            raise AssertionError(f"{name}: {dw} B2 launches in a stacked "
                                 f"step, want {want_dw}")


class TrialMeter:
    """Per trial-parallel experiment (the port's functions wrapped, not
    copied): setup seconds (to ``ParallelFoldTrainer.fit``'s first epoch:
    model build, the frame table's upload, the stacked initialization),
    training frames/s (every trial's rows over the training epochs' time,
    synchronized), the fit's returned weights, and with ``stop_after`` an
    :class:`Interrupted` raised once that many epoch checkpoints are
    saved."""

    def __init__(self, stop_after=None):
        self.stop_after, self.saves = stop_after, 0
        self.rec = {"train_s": 0.0, "frames": 0, "setup": None,
                    "t0": time.perf_counter()}

    def __enter__(self):
        from ab_line_classifier_torch.parallel.trial_parallel import (
            ParallelFoldTrainer as P)

        self.saved = (P.fit, P.run_epoch, P._save_resume)
        fit, run_epoch, save = self.saved
        meter = self

        def timed_fit(trainer, *a, **kw):
            out = fit(trainer, *a, **kw)
            meter.rec["best"] = out[0]
            meter.rec["history"] = out[1]
            return out

        def timed_epoch(trainer, params, buffers, opt, cache, idx_tab,
                        mask_tab, *, train, **kw):
            if meter.rec["setup"] is None:
                meter.rec["setup"] = time.perf_counter() - meter.rec["t0"]
            if not train:
                return run_epoch(trainer, params, buffers, opt, cache,
                                 idx_tab, mask_tab, train=train, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_epoch(trainer, params, buffers, opt, cache, idx_tab,
                            mask_tab, train=train, **kw)
            torch.cuda.synchronize()
            meter.rec["train_s"] += time.perf_counter() - t0
            meter.rec["frames"] += int(mask_tab.sum())
            return out

        def counted_save(trainer, *a, **kw):
            save(trainer, *a, **kw)
            meter.saves += 1
            if meter.stop_after is not None and meter.saves >= \
                    meter.stop_after:
                raise Interrupted

        P.fit, P.run_epoch, P._save_resume = (timed_fit, timed_epoch,
                                              counted_save)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        from ab_line_classifier_torch.parallel.trial_parallel import (
            ParallelFoldTrainer as P)

        torch.cuda.synchronize()
        self.rec["wall"] = time.perf_counter() - self.rec["t0"]
        self.rec["peak"] = torch.cuda.max_memory_allocated()
        P.fit, P.run_epoch, P._save_resume = self.saved
        return False


def run_trial_parallel(label, fn, want, smi, serial=None, **kw):
    """Run one trial-parallel experiment with the launch counts set to 0
    just before and read just after; hold them to ``want`` (B1, B2) and no
    input copied; print its wall, setup, training frames/s and peak memory
    beside ``serial``'s (phase 12's). Returns (result, meter record,
    launches)."""
    import contextlib
    import io

    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC

    PC.reset_launch_count()
    DC.reset_launch_count()
    out = io.StringIO()
    with TrialMeter() as meter, contextlib.redirect_stdout(out):
        result = fn(device="cuda", verbose=False, **kw)
    got = (PC.launch_count, DC.launch_count)
    rec = meter.rec
    text = out.getvalue()
    print(f"{label} on {smi}: wall {rec['wall']:.3f} s, setup "
          f"{rec['setup']:.3f} s, training "
          f"{rec['frames'] / rec['train_s']:.1f} frames/s ({rec['frames']} "
          f"frames of every trial in {rec['train_s']:.3f} s), "
          f"max_memory_allocated {rec['peak']} bytes; launches B1 {got[0]} "
          f"B2 {got[1]} (want {want}), input copies {DC.copy_count}",
          flush=True)
    if serial is not None:
        print(f"  phase 12's serial run of the same model and data: wall "
              f"{serial['wall']:.3f} s for {serial['runs']} runs, training "
              f"{serial['fps']:.1f} frames/s, peak {serial['peak']} bytes",
              flush=True)
    if got != tuple(want) or DC.copy_count:
        raise AssertionError(f"{label}: launches {got}, want {want}, copies "
                             f"{DC.copy_count}")
    return result, rec, got, text


def profile_stacked_step(name, n, smi):
    """A profiled stacked training step (bf16, the config's augmentation
    and dropout) of ``n`` trials of ``name`` at batch TRAIN_BATCH: device
    idle share and top kernels."""
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)
    from ab_line_classifier_torch.predict.benchmark import (TRAIN_AUG,
                                                            ZOO_HPARAMS)

    spec = build_model(name, ZOO_HPARAMS[name], OUT_HW + (3,), 2,
                       mixed_precision=True)
    pt = ParallelFoldTrainer(spec, n, class_weights=np.ones((n, 2)),
                             aug_config=TRAIN_AUG, seed=0,
                             compute_dtype=torch.bfloat16, device="cuda")
    params, buffers = pt.init_stacked()
    opt = pt.begin_phase(0, spec.phases[0], params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randint(0, 256, (n, TRAIN_BATCH, *OUT_HW, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    labels = torch.randint(0, 2, (n, TRAIN_BATCH), device="cuda",
                           generator=gen)
    mask = torch.ones((n, TRAIN_BATCH), device="cuda")
    metrics = M.init_metrics(2, device="cuda", trials=n)
    prof = device_time_by_kernel(lambda: pt.train_step(
        params, buffers, opt, images, labels, mask, np.ones(n), np.ones(n),
        metrics))
    wall, busy = prof["wall_ms"], prof["busy_ms"]
    print(f"profiled stacked step on {smi}: {name} [{spec.phases[0].name}] "
          f"{n} trials x batch {TRAIN_BATCH}: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms (idle share {1 - busy / wall:.4f}), "
          f"{n * TRAIN_BATCH / wall * 1e3:.1f} frames/s", flush=True)
    for kname, ms in prof["kernels"][:8]:
        print(f"  {ms:9.3f} ms {100 * ms / wall:6.2f}%  {kname[:110]}")


def phase_trial_parallel(smi, serial):
    """Phase 13: the trial-parallel experiments (module docstring).
    Returns each path's (B1, B2) launches and B2's trial-launch
    timings."""
    import shutil

    from ab_line_classifier_torch.data.pipeline import FrameArrays
    from ab_line_classifier_torch.data.splits import FoldSet
    from ab_line_classifier_torch.predict.benchmark import build_zoo
    from ab_line_classifier_torch.train import experiment as E

    timings = trial_launch_checks(build_zoo("mobilenetv2"), smi)
    for name, n in TP_STEP_TRIALS.items():
        stacked_vs_serial_step(name, n, smi)

    root = os.path.join(REPO, "build", "phase13")
    shutil.rmtree(root, ignore_errors=True)
    n = EXP_PATIENTS * EXP_FRAMES_PER_PATIENT
    images, labels = labelled_frames(n, seed=12)
    patients = np.repeat(np.arange(EXP_PATIENTS), EXP_FRAMES_PER_PATIENT)
    frames = FrameArrays(images, labels, [f"frame{i:04d}.png"
                                          for i in range(n)])

    def nb(rows):
        return -(-len(rows) // TRAIN_BATCH)

    def cv_launches(folds, epochs):
        return (epochs * max(nb(v) for v in folds.val)
                + sum(nb(t) for t in folds.test), 0)

    # A profiled stacked step of each model first: it warms cuDNN's
    # grouped-conv plans for the metered runs after it.
    profile_stacked_step("cutoffvgg16", EXP_FOLDS, smi)
    profile_stacked_step("mobilenetv2", EXP_TRIALS, smi)
    profile_stacked_step("mobilenetv2", TP_FULL_TRIALS, smi)

    launches = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        folds = grouped_folds(patients, EXP_FOLDS, 0.1, seed=42)
        source = E.FoldSource(frames, folds)
        cfg = experiment_config(os.path.join(root, "kfold"), "cutoffvgg16",
                                "cross_validation")
        ck = os.path.join(root, "kfold_resume")
        try:
            with TrialMeter(stop_after=1):
                E.cross_validation_parallel(cfg, verbose=False,
                                            device="cuda", source=source,
                                            checkpoint_dir=ck)
            raise AssertionError("the interrupted run went on")
        except Interrupted:
            pass
        with TrialMeter() as resumed:
            resumed_rows = E.cross_validation_parallel(
                cfg, verbose=False, device="cuda", source=source,
                checkpoint_dir=ck, resume=True)
        summary, rec, launches["cross_validation_parallel"], _ = \
            run_trial_parallel(
                f"cross_validation_parallel ({EXP_FOLDS} folds of "
                f"cutoffvgg16)", E.cross_validation_parallel,
                cv_launches(folds, 2), smi, serial["cross_validation"],
                cfg=cfg, source=source)
        same = str(resumed_rows) == str(summary) and all(
            torch.equal(v, resumed.rec["best"][part][k])
            for part in ("params", "buffers")
            for k, v in rec["best"][part].items())
        print(f"cross_validation_parallel interrupted after the extract "
              f"epoch and resumed: {len(resumed.rec['history'])} epochs in "
              f"the history, test rows and final weights "
              f"{'bit-equal' if same else 'DIFFERENT'} to the uninterrupted "
              f"run's; accuracy mean {summary[-2]['accuracy']:.4f}",
              flush=True)
        if not same or [h["epoch"] for h in resumed.rec["history"]] != [0, 1]:
            raise AssertionError("the resumed trial-parallel run differs "
                                 "from the uninterrupted one")

        split = FoldSet(*([part] for part in folds.fold(0)))
        tr, va, _ = split.fold(0)
        cfg = experiment_config(os.path.join(root, "sweep"), "mobilenetv2",
                                "hparam_search")
        sweep_want = (nb(va), ZOO["mobilenetv2"][1] * (nb(tr) + nb(va)))
        out, _, launches["lr_search_parallel"], text = run_trial_parallel(
            f"lr_search_parallel ({EXP_TRIALS} LR trials of mobilenetv2)",
            E.lr_search_parallel, sweep_want, smi, serial["hparam_search"],
            cfg=cfg, source=E.FoldSource(frames, split))
        lrs = [t["LR"] for t in out["trials"]]
        print(f"lr_search_parallel: LRs {lrs}, objectives (val loss at each "
              f"trial's best epoch) "
              f"{[round(t['objective'], 6) for t in out['trials']]}, best "
              f"{out['best_params']}", flush=True)
        if ("ignoring search variables ['DROPOUT']" not in text
                or len(lrs) != EXP_TRIALS
                or not np.allclose([lrs[0], lrs[-1]], [1e-5, 1e-3])
                or not np.isfinite(out["best_objective"])):
            raise AssertionError(f"lr_search_parallel: {out['trials']}")

        full = grouped_folds(patients, TP_FULL_FOLDS, 0.1, seed=42)
        cfg = experiment_config(os.path.join(root, "kfold_full"),
                                "cutoffvgg16", "cross_validation")
        summary, _, launches["cross_validation_parallel_full"], _ = \
            run_trial_parallel(
                f"cross_validation_parallel ({TP_FULL_FOLDS} folds, "
                f"config.yml's N_FOLDS)", E.cross_validation_parallel,
                cv_launches(full, 2), smi, cfg=cfg,
                source=E.FoldSource(frames, full))
        if len(summary) != TP_FULL_FOLDS + 2 or not all(
                np.isfinite(r["accuracy"]) for r in summary):
            raise AssertionError(f"5-fold summary: {summary}")
        cfg = experiment_config(os.path.join(root, "sweep_full"),
                                "mobilenetv2", "hparam_search").replace(
            TRAIN={"HPARAM_SEARCH": {"N_EVALS": TP_FULL_TRIALS}})
        out, _, launches["lr_search_parallel_full"], _ = run_trial_parallel(
            f"lr_search_parallel ({TP_FULL_TRIALS} trials, config.yml's "
            f"N_EVALS)", E.lr_search_parallel, sweep_want, smi, cfg=cfg,
            source=E.FoldSource(frames, split))
        if len(out["trials"]) != TP_FULL_TRIALS:
            raise AssertionError(f"10-trial search: {out['trials']}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return launches, timings


# Phase 14 (the raw-clip path). Deploy serving: each clip goes up once, B1
# runs once over it at its source size, the model once over its frames.
DEPLOY_CLIPS = ((256, (480, 640)), (64, (1080, 1440)))
DEPLOY_MODELS = ("cutoffvgg16", "mobilenetv2")
# Frames of each clip held against the port on the CPU.
DEPLOY_CHECK = 8
# Auto-masking: 11 frames sampled (every 10th, as the reference's 10%) of
# a 110-frame clip; U-Net probabilities GPU vs CPU in IEEE float32.
AUTOMASK_FRAMES, AUTOMASK_STEP = 110, 10
AUTOMASK_SIZES = ((480, 640), (1080, 1440))
MASK_PROB_ATOL = 1e-5
# Frames per clip of the threshold experiments' frame table.
EXP_CLIP_FRAMES = 32


def deploy_clip(n, hw, seed):
    """uint8 RGB frames of graded brightness (so the served logits differ
    from frame to frame) with odd content in the 50x160 UI box (bright
    stripes, which a path without the blank would see)."""
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    for i, scale in enumerate(np.linspace(0.15, 1.0, n, dtype=np.float32)):
        clip[i] = (clip[i] * scale).astype(np.uint8)
    clip[:, :50, :160] = 0
    clip[:, 8:44:4, 4:156] = 255
    return clip


def save_deploy_checkpoint(root, name, spec, state_dict):
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
    from ab_line_classifier_torch.utils import checkpoint as ckpt

    return ckpt.save_model(os.path.join(root, name), state_dict, {
        "model_name": name, "hparams": ZOO_HPARAMS[name],
        "input_shape": list(spec.input_shape), "n_classes": spec.n_classes,
        "classes": ["a_lines", "b_lines"],
        "preprocess_mode": spec.preprocess_mode, "mixed_precision": True})


def read_preds_csv(path, probs):
    """The deploy CSV's header, rows and values against ``probs``."""
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["Frame", "A lines", "B lines"]:
        raise AssertionError(f"CSV header {rows[0]}")
    body = rows[1:]
    if [int(r[0]) for r in body] != list(range(len(probs))):
        raise AssertionError(f"CSV has {len(body)} rows for {len(probs)} "
                             f"frames")
    vals = np.array([[np.float32(r[1]), np.float32(r[2])] for r in body])
    if not np.array_equal(vals, probs[:, :2]):
        raise AssertionError("CSV probabilities differ from the returned ones")


def deploy_gpu_vs_cpu(name, ckpt_dir, clip, gpu_probs, smi):
    """DEPLOY_CHECK frames spread over the clip (so over its brightness)
    served by the port on the CPU (the same bf16 model) against the card's
    probabilities, by the serving bar of phases 5-6: max(BF16_PROB_ATOL,
    2 x the CPU's bf16-vs-float32 difference). The probabilities must
    spread wider than the bar across those frames, or a frame-order fault
    would pass. Returns (error, bar)."""
    from ab_line_classifier_torch.predict import deploy as D
    from ab_line_classifier_torch.predict.predict import load_module
    from ab_line_classifier_torch.utils import checkpoint as ckpt

    pick = np.linspace(0, len(clip) - 1, DEPLOY_CHECK).astype(int)
    x = torch.from_numpy(np.ascontiguousarray(clip[pick]))
    spec, module = D.load_deploy_model(ckpt_dir, device="cpu")
    cpu = D.deploy_forward(spec, module, x).numpy()
    spec32 = dataclasses.replace(spec, dtype=torch.float32)
    f32 = D.deploy_forward(spec32, load_module(
        spec32, ckpt.load_model(ckpt_dir)[0], torch.device("cpu")), x).numpy()
    err = float(np.abs(gpu_probs[pick] - cpu).max())
    floor = float(np.abs(cpu - f32).max())
    bar = max(BF16_PROB_ATOL, 2 * floor)
    spread = float(np.ptp(cpu[:, 1]))
    print(f"{name} deploy GPU vs CPU on {DEPLOY_CHECK} frames ({smi}): max "
          f"|dp| {err:.3e} (bar {bar:.3e}; CPU bf16 vs float32 "
          f"{floor:.3e}); P(b_lines) spread {spread:.4f}", flush=True)
    if spread < bar:
        raise AssertionError(f"{name}: probabilities too flat to compare "
                             f"({spread} across the check frames)")
    if err > bar:
        raise AssertionError(f"{name}: deploy GPU vs CPU differ by {err}")
    return err, bar


def serve_deploy_clip(name, ckpt_dir, clip, smi):
    """``predict_wavebase_mp4`` over one clip with the counts reset just
    before: B1 once, B2 ``ZOO``'s count per forward, no input copy; the
    CSV; GPU vs CPU; a clip that differs only in the UI box; then B1
    against its plain version at the deploy settings and the per-clip
    times (upload, B1, forward). Returns (B1, B2 launches, timing)."""
    import tempfile

    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.ops.image import (fused_preprocess,
                                                    max_ulp_error)
    from ab_line_classifier_torch.predict import deploy as D

    n, hs, ws = clip.shape[:3]
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "preds.csv")
        torch.cuda.synchronize()
        PC.reset_launch_count()
        DC.reset_launch_count()
        t0 = time.perf_counter()
        probs = D.predict_wavebase_mp4(ckpt_dir, "", csv_path, frames=clip,
                                       device="cuda")
        wall = time.perf_counter() - t0
        b1, b2, copies = PC.launch_count, DC.launch_count, DC.copy_count
        read_preds_csv(csv_path, probs)
    want_b2 = ZOO[name][1] if name in ZOO else 0
    if (b1, b2, copies) != (1, want_b2, 0):
        raise AssertionError(f"{name} deploy {n}x{hs}x{ws}: B1 {b1}, B2 "
                             f"{b2}, copies {copies}; want 1, {want_b2}, 0")
    if probs.shape != (n, 2) or not np.isfinite(probs).all():
        raise AssertionError(f"{name} deploy: probabilities {probs.shape}")
    err, bar = deploy_gpu_vs_cpu(name, ckpt_dir, clip, probs, smi)

    spec, module = D.load_deploy_model(ckpt_dir, device="cuda")
    uploads = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dev = torch.from_numpy(clip).to("cuda")
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t) * 1e3)
    pinned = torch.from_numpy(clip).pin_memory()
    pinned_ms = cuda_ms(lambda: pinned.to("cuda", non_blocking=True),
                        iters=3, warmup=1)
    del pinned
    other = dev.clone()
    other[:, :50, :160] = torch.randint(
        0, 256, (n, 50, 160, 3), dtype=torch.uint8, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(14))
    if not torch.equal(D.deploy_forward(spec, module, dev),
                       D.deploy_forward(spec, module, other)):
        raise AssertionError(f"{name}: the UI box reaches the model")
    del other
    kw = dict(out_hw=tuple(spec.input_shape[:2]),
              preprocess_mode=spec.preprocess_mode, resize_mode="cv2",
              blank_ui_region=True, out_dtype=torch.float32)
    x = D.deploy_preprocess(spec, dev)
    b1_err = max_ulp_error(x, fused_preprocess(dev, **kw), torch.float32,
                           spec.preprocess_mode)
    b1_ms = cuda_ms(lambda: D.deploy_preprocess(spec, dev))
    plain_ms = cuda_ms(lambda: fused_preprocess(dev, **kw), iters=5)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: module(x.to(spec.dtype)), iters=5)
    nbytes = preprocess_bytes(n, (hs, ws), kw["out_hw"], "cv2", 4, False,
                              blank=True)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    upload_ms = float(np.median(uploads))
    timing = dict(frames=n, upload_ms=upload_ms, pinned_upload_ms=pinned_ms,
                  b1_ms=b1_ms, b1_plain_ms=plain_ms, b1_bound_ms=bound_ms,
                  b1_max_abs_err=b1_err, forward_ms=fwd_ms,
                  device_frames_per_s=n / ((b1_ms + fwd_ms) / 1e3),
                  with_upload_frames_per_s=n / ((upload_ms + b1_ms + fwd_ms)
                                                / 1e3),
                  call_wall_s=wall, prob_err=err, prob_bar=bar)
    print(f"{name} deploy {n} x {hs}x{ws} ({smi}): B1 {b1}, B2 {b2}, copies "
          f"{copies}; upload {upload_ms:.3f} ms (pageable; pinned "
          f"{pinned_ms:.3f}), B1 {b1_ms:.4f} ms (plain {plain_ms:.4f}, bytes "
          f"bound {bound_ms:.4f}; max abs err {b1_err}), forward "
          f"{fwd_ms:.3f} ms; {timing['device_frames_per_s']:.1f} frames/s on "
          f"the card, {timing['with_upload_frames_per_s']:.1f} with the "
          f"upload; predict_wavebase_mp4 call {wall:.3f} s (restore, CSV "
          f"included); UI box blanked (probabilities equal)", flush=True)
    del dev, x
    torch.cuda.empty_cache()
    return b1, b2, timing, probs


def beam_masks(n, hw, seed, flip=2e-4):
    """0/1 float32 masks of an ultrasound fan with a ``flip`` share of the
    pixels flipped in each frame: holes that the erode widens and the vote
    closes, specks outside that the dilate grows and the vote drops."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    ang = np.arctan2(xx - w / 2, yy + 0.1 * h)
    r = np.hypot(xx - w / 2, yy + 0.1 * h)
    fan = (np.abs(ang) < 0.6) & (r < h) & (r > 0.15 * h)
    return (fan[None] ^ (rng.random((n, h, w)) < flip)).astype(np.float32)


def beam_frames(n, hw, seed):
    """uint8 RGB frames of a noisy fan on a dark background."""
    m = beam_masks(1, hw, seed)[0] > 0
    rng = np.random.default_rng(seed + 1)
    f = rng.integers(0, 30, (n, *hw, 3), dtype=np.uint8)
    f[:, m] = rng.integers(60, 256, (n, int(m.sum()), 3), dtype=np.uint8)
    return f


def automask_steps(seg, sampled, hw):
    """Per-step card times (CUDA events) of one clip's mask, in IEEE
    float32 as ``clip_mask`` runs them."""
    from ab_line_classifier_torch.data.auto_masking import (
        PROB_THRESHOLD, UNET_INPUT, ieee_float32)
    from ab_line_classifier_torch.ops import morphology as M
    from ab_line_classifier_torch.ops.image import (linear_resize,
                                                    skimage_downsample)

    h = hw[0]
    erode, dilate = max(int(h * (1 - 0.95)), 3), max(int(h * 0.05), 3)
    with ieee_float32(), torch.inference_mode():
        u8 = torch.from_numpy(sampled).to("cuda")

        def gray():
            x = u8.to(torch.float64)
            return (0.299 * x[..., 0] + 0.587 * x[..., 1]
                    + 0.114 * x[..., 2]).to(torch.float32)

        g = gray()
        small = skimage_downsample(g, UNET_INPUT) / 255.0
        probs = seg.model(small[..., None])[..., 0]
        b128 = (probs > PROB_THRESHOLD).to(torch.float32)
        support = (linear_resize(b128, hw) > 0).to(torch.float32)
        ek = torch.as_tensor(M.ellipse_kernel(erode), device="cuda")
        dk = torch.as_tensor(M.ellipse_kernel(dilate), device="cuda")
        eroded = M.binary_erode(support, ek)
        cleaned = M.binary_dilate(eroded, dk)
        steps = {
            "grayscale": cuda_ms(gray, iters=5),
            "downsample": cuda_ms(
                lambda: skimage_downsample(g, UNET_INPUT), iters=5),
            "unet": cuda_ms(lambda: seg.model(small[..., None]), iters=5),
            "upsample": cuda_ms(
                lambda: linear_resize(b128, hw) > 0, iters=5),
            "erode": cuda_ms(lambda: M.binary_erode(support, ek), iters=5),
            "dilate": cuda_ms(lambda: M.binary_dilate(eroded, dk), iters=5),
            "vote": cuda_ms(lambda: M.majority_average_mask(cleaned),
                            iters=5)}
    return steps, (erode, dilate)


def morphology_profile(hw, size, n=AUTOMASK_FRAMES // AUTOMASK_STEP):
    """``device_time_by_kernel`` of one ``size`` x ``size`` elliptical
    dilate of ``n`` fan masks of ``hw``, in a fresh process (in the
    smoke's own process, after phases 5-13, the profiler has been seen to
    record no device time here). Returns its dict."""
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke as cs\n"
        "from ab_line_classifier_torch.data.auto_masking import "
        "ieee_float32\n"
        "from ab_line_classifier_torch.ops import morphology as M\n"
        f"x = torch.from_numpy(cs.beam_masks({n}, {tuple(hw)!r}, 0)).cuda()\n"
        f"k = torch.as_tensor(M.ellipse_kernel({size}), device='cuda')\n"
        "with ieee_float32():\n"
        "    p = cs.device_time_by_kernel(lambda: M.binary_dilate(x, k), 2)\n"
        "print(json.dumps({'busy_ms': p['busy_ms'], "
        "'kernels': p['kernels'][:4]}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_automask(smi):
    """Auto-masking on the card against the port on the CPU: the U-Net's
    probabilities, the morphology and vote on noisy fan masks, ``clip_mask``
    end to end (once with PyTorch's TF32 default back on), ``mask_frames``
    with and without the crop; per-step times and a profile of the
    morphology. Returns (B1, B2 launches of the path, timings)."""
    from ab_line_classifier_torch.data.auto_masking import (
        UNET_INPUT, UnetSegmentation, ieee_float32)
    from ab_line_classifier_torch.models.unet import seeded_unet_state
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.ops import morphology as M
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.ops.image import skimage_downsample

    state = seeded_unet_state(16, 8)
    gpu = UnetSegmentation(base_filters=16, device="cuda")
    cpu = UnetSegmentation(base_filters=16, device="cpu")
    gpu.model.load_state_dict(state)
    cpu.model.load_state_dict(state)
    timings = {}
    b1 = b2 = 0
    tf32_default = (True, False)   # cudnn.allow_tf32, matmul.allow_tf32
    for hw in AUTOMASK_SIZES:
        label = f"{hw[0]}x{hw[1]}"
        sampled = beam_frames(AUTOMASK_FRAMES, hw, hw[0])[::AUTOMASK_STEP]
        # The main path, with PyTorch's TF32 default back on.
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32_default
        try:
            torch.cuda.synchronize()
            PC.reset_launch_count()
            DC.reset_launch_count()
            t0 = time.perf_counter()
            probs = gpu.predict_masks(sampled)
            mask, bbox = gpu.clip_mask(sampled, hw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b1 += PC.launch_count
            b2 += DC.launch_count
            t0 = time.perf_counter()
            gpu.clip_mask(sampled, hw)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            if (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) != tf32_default:
                raise AssertionError("clip_mask left the TF32 flags changed")
            # What the IEEE scope saves: the U-Net called directly, under
            # the TF32 default, on the same 128x128 inputs.
            with ieee_float32():
                small = skimage_downsample(torch.from_numpy(
                    sampled @ np.array([0.299, 0.587, 0.114])).to(
                        "cuda", torch.float32), UNET_INPUT) / 255.0
            with torch.inference_mode():
                tf32_probs = gpu.model(small[..., None])[..., 0].cpu()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        want = cpu.predict_masks(sampled)
        err = float((probs.cpu() - want).abs().max())
        tf32_err = float((tf32_probs - want).abs().max())
        band = (want - 0.4).abs() < MASK_PROB_ATOL
        flips = (probs.cpu() > 0.4) != (want > 0.4)
        if err > MASK_PROB_ATOL or (flips & ~band).any():
            raise AssertionError(f"U-Net GPU vs CPU {label}: {err}")
        cpu_mask = cpu.mask_from_probs(probs.cpu(), hw)
        if not torch.equal(mask.cpu(), cpu_mask):
            raise AssertionError(f"clip_mask GPU vs CPU {label} differ in "
                                 f"{int((mask.cpu() != cpu_mask).sum())} px")
        if list(M.bounding_box(cpu_mask)) != bbox:
            raise AssertionError(f"bounding box {label}")

        fans = beam_masks(len(sampled), hw, hw[1])
        erode = max(int(hw[0] * (1 - 0.95)), 3)
        dilate = max(int(hw[0] * 0.05), 3)
        clean_g = M.clean_binary_masks(torch.from_numpy(fans).cuda(),
                                       erode_size=erode, dilate_size=dilate)
        clean_c = M.clean_binary_masks(torch.from_numpy(fans),
                                       erode_size=erode, dilate_size=dilate)
        vote_g = M.majority_average_mask(clean_g)
        vote_c = M.majority_average_mask(clean_c)
        if not (torch.equal(clean_g.cpu(), clean_c)
                and torch.equal(vote_g.cpu(), vote_c)):
            raise AssertionError(f"morphology GPU vs CPU {label}")
        kept = float(vote_c.mean())
        if not 0.05 < kept < 0.95:
            raise AssertionError(f"fan masks {label}: the chain keeps a "
                                 f"{kept} share: trivial")

        gen = torch.Generator(device="cuda").manual_seed(hw[0])
        clip = torch.randint(0, 256, (AUTOMASK_FRAMES, *hw, 3),
                             dtype=torch.uint8, device="cuda", generator=gen)
        for box in (None, bbox):
            out = gpu.mask_frames(clip, mask, box)
            want_out = cpu.mask_frames(clip[:4].cpu(), mask.cpu(), box)
            if not torch.equal(out[:4].cpu(), want_out):
                raise AssertionError(f"mask_frames {label} crop {box}")
        mask_frames_ms = cuda_ms(lambda: gpu.mask_frames(clip, mask), iters=5)
        steps, sizes = automask_steps(gpu, sampled, hw)
        profile = morphology_profile(hw, sizes[1])
        del clip
        torch.cuda.empty_cache()
        timings[label] = dict(first_call_wall_ms=wall * 1e3,
                              clip_mask_wall_ms=warm * 1e3,
                              mask_frames_ms=mask_frames_ms,
                              unet_max_abs_err=err,
                              unet_tf32_max_abs_err=tf32_err, **steps)
        print(f"automask {label} ({smi}): {len(sampled)} sampled of "
              f"{AUTOMASK_FRAMES}; U-Net GPU vs CPU max |dp| {err:.2e} (bar "
              f"{MASK_PROB_ATOL}, {int(band.sum())} within it of 0.4, "
              f"{int(flips.sum())} flipped; the U-Net called outside the "
              f"IEEE scope under TF32 {tf32_err:.2e}); clip_mask equal to "
              f"the CPU chain on the same probabilities, bbox {bbox}, mask "
              f"share "
              f"{float(mask.mean()):.4f}; fan masks: erode/dilate "
              f"{erode}x{erode} / {dilate}x{dilate} and vote equal "
              f"(kept share {kept:.4f}); mask_frames equal with and without "
              f"the crop; predict_masks + clip_mask first call "
              f"{wall * 1e3:.2f} ms, clip_mask again {warm * 1e3:.2f} ms "
              f"(host clock, TF32 default on); ms per step " + ", ".join(
                  f"{k} {v:.4f}" for k, v in steps.items())
              + f"; mask_frames of {AUTOMASK_FRAMES} frames "
              f"{mask_frames_ms:.4f} ms", flush=True)
        print(f"automask {label} dilate {sizes[1]}x{sizes[1]} profile: busy "
              f"{profile['busy_ms']:.4f} ms, kernels "
              + "; ".join(f"{k[:120]} {v:.4f} ms" for k, v in
                          profile["kernels"][:4]), flush=True)
        timings[label]["dilate_profile"] = (profile["kernels"][:2]
                                            if profile["busy_ms"]
                                            else "not measured")
    if (b1, b2) != (0, 0):
        raise AssertionError(f"the auto-mask path launched B1 {b1}, B2 {b2}")
    return (b1, b2), timings


def phase_threshold_experiments(deploy_probs, smi):
    """The clip-rule experiments on a frame table made from the deploy
    step's probabilities (clips of EXP_CLIP_FRAMES frames, ``Frame Path``
    ``{clip}_{idx}``, a seeded ``Class`` per clip), on the card and on the
    CPU: the rows and every CSV written must be equal. Returns seconds per
    device."""
    import tempfile

    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.predict import experiments as E
    from ab_line_classifier_torch.utils.tables import write_table

    rng = np.random.default_rng(14)
    paths, labels, b_probs = [], [], []
    for label, probs in deploy_probs.items():
        for k, start in enumerate(range(0, len(probs), EXP_CLIP_FRAMES)):
            chunk = probs[start:start + EXP_CLIP_FRAMES, 1]
            paths += [f"{label}-{k}_{i}" for i in range(len(chunk))]
            labels += [int(rng.integers(0, 2))] * len(chunk)
            b_probs.append(chunk)
    b = np.concatenate(b_probs).astype(np.float32)
    n_clips = len(set(p.rpartition("_")[0] for p in paths))
    runs = (
        ("contiguous", lambda cfg, path, dev: E.b_line_threshold_experiment(
            cfg, path, 1, 16, contiguous=True, document=True, device=dev)),
        ("total", lambda cfg, path, dev: E.b_line_threshold_experiment(
            cfg, path, 1, 16, contiguous=False, document=True, device=dev)),
        ("sliding_window",
         lambda cfg, path, dev: E.sliding_window_variation_experiment(
             cfg, path, 1, 16, document=True, device=dev)))
    seconds = {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "frame_preds.csv")
        write_table(path, {"Frame Path": np.array(paths, object),
                             "Class": np.array(labels, np.int64),
                             "a_lines": 1.0 - b, "b_lines": b}, index=True)
        out = {}
        for dev in ("cuda", "cpu"):
            for name, run in runs:
                d = os.path.join(root, dev, name)
                cfg = Config({"PATHS": {
                    "EXPERIMENTS": d, "EXPERIMENT_VISUALIZATIONS": d,
                    "CLASS_NAME_MAP": ""},
                    "DATA": {"CLASSES": ["a_lines", "b_lines"]}})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = run(cfg, path, dev)
                seconds[f"{name} {dev}"] = time.perf_counter() - t0
                files = []
                for f in sorted(os.listdir(d)):
                    if f.endswith(".csv"):
                        with open(os.path.join(d, f), "rb") as fh:
                            files.append(fh.read())
                out[(dev, name)] = (rows, files)
        for name, _ in runs:
            if out[("cuda", name)] != out[("cpu", name)]:
                raise AssertionError(f"{name} experiment: card and CPU "
                                     f"differ")
    best = max(out[("cuda", "contiguous")][0],
               key=lambda r: (r["f1"], -r["B-line Threshold"]))
    print(f"threshold experiments ({smi}): {len(b)} frames in {n_clips} "
          f"clips; contiguous, total and sliding-window rows and CSVs equal "
          f"on the card and the CPU; best contiguous threshold "
          f"{best['B-line Threshold']} (f1 {best['f1']:.4f}); seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()),
          flush=True)
    return seconds


def phase_raw_clip(smi, served):
    """Phase 14: deploy serving of ``served`` ({name: (spec, state)}) over
    each DEPLOY_CLIPS clip, auto-masking, the threshold experiments.
    Returns ({path: (B1, B2 launches)}, timings)."""
    import tempfile

    from ab_line_classifier_torch.predict import deploy as D

    frame = deploy_clip(1, (480, 640), 3)[0]
    parity = {m: D.check_preprocess_parity(frame, m, device="cuda")
              for m in ("cutoffvgg16", "mobilenetv2", "efficientnetb7")}
    print(f"check_preprocess_parity on the card: {parity}", flush=True)
    if max(parity.values()) >= 1e-5:
        raise AssertionError(f"deploy preprocessing parity {parity}")

    clips = [deploy_clip(n, hw, hw[0]) for n, hw in DEPLOY_CLIPS]
    launches, timings, probs_by_clip = [0, 0], {}, {}
    with tempfile.TemporaryDirectory() as root:
        for name, (spec, state) in served.items():
            ckpt_dir = save_deploy_checkpoint(root, name, spec, state)
            for clip in clips:
                b1, b2, t, probs = serve_deploy_clip(name, ckpt_dir, clip, smi)
                label = f"{name}-{clip.shape[1]}x{clip.shape[2]}"
                launches[0] += b1
                launches[1] += b2
                timings[label] = t
                probs_by_clip[label] = probs
    del clips
    automask, automask_timings = phase_automask(smi)
    experiments = phase_threshold_experiments(probs_by_clip, smi)
    return ({"deploy": tuple(launches), "automask": automask},
            {"deploy": timings, "automask": automask_timings,
             "experiments_s": experiments, "parity": parity})


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

    phase("11 training")
    launches["training"] = phase_training(vgg_sd, mbv2,
                                          weights["mobilenetv2"], smi)
    torch.cuda.synchronize()

    phase("12 cross-validation and hyperparameter search")
    paths, serial = phase_experiments(smi)
    launches.update(paths)
    torch.cuda.synchronize()

    phase("13 trial-parallel cross-validation and LR search")
    paths, trial_timings = phase_trial_parallel(smi, serial)
    launches.update(paths)
    torch.cuda.synchronize()

    phase("14 raw-clip path: deploy serving, auto-masking, threshold "
          "experiments")
    paths, raw_clip = phase_raw_clip(smi, {
        "cutoffvgg16": (vgg, vgg_sd),
        "mobilenetv2": (mbv2, weights["mobilenetv2"])})
    launches.update(paths)
    b1_err = max([b1_err] + [t["b1_max_abs_err"]
                             for t in raw_clip["deploy"].values()])

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
         "shape": f"{MAIN_BATCH}x480x640x3 uint8 -> 128x128x3 bf16",
         "deploy_per_clip": {
             label: {key: t[key] for key in (
                 "frames", "b1_ms", "b1_plain_ms", "b1_bound_ms",
                 "b1_max_abs_err", "upload_ms", "pinned_upload_ms",
                 "forward_ms", "device_frames_per_s",
                 "with_upload_frames_per_s")}
             for label, t in raw_clip["deploy"].items()}},
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
                                         "bound_ms")},
         "trial_launch_per_mobilenetv2_forward_batch_64": {
             f"F={n}": t for n, t in trial_timings.items()}},
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
