#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ab_line_classifier_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right and serves.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. device — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel from ``ab_line_classifier_torch/csrc`` into
   ``build/kernels``;
3. kernel — the preprocess kernel against its plain PyTorch version over
   modes x resize maps x masks x output dtypes and several source sizes,
   plus 2048 frames of 1080x1440 (past 2^31 bytes: the 64-bit offsets);
   then, at the main path's shapes, the same comparison and the kernel's
   time, the plain version's, a resize-only library yardstick
   (``F.interpolate(mode="nearest-exact")``, which the port never calls)
   and the bytes-moved bound;
4. main path — full-width cutoffvgg16 (mixed precision, 128x128, random
   weights from a numpy seed through the weight bridge) serving 4096
   frames of 480x640 and 4096 of 128x128 through ``Predictor``, then clip
   grouping and all three aggregations on the card; the kernel's launch
   count on this phase alone must be > 0. The served forward is then held
   against the same port on the CPU at ``block3_conv3`` and the logits;
5. throughput — ``clip_inference_benchmark`` at batch 1024 and 2048 (each
   run's kernel launches counted), and a ``torch.profiler`` breakdown of
   one serving batch by kernel.

The last two lines of standard output are a JSON line of per-kernel
numbers and ``{"ok": true, "device": {...}}``.
"""

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
# The bf16 serving tolerance of the port's tests (tests/test_torch_model.py).
BF16_PROB_ATOL = 2e-2
# GPU vs CPU (both bf16) at block3_conv3 and the logits: relative
# Frobenius error. The script prints the CPU's own bf16-vs-float32
# difference beside it (the rounding floor), and checks that frames with
# their channels swapped — a channel-order fault — land far beyond it.
ACT_RTOL = 3e-2
TAP = "block3_conv3"
# Kernels scaled by GAIN / sqrt(fan_in), as in tests/test_torch_model.py,
# so the logits are O(1) and vary from frame to frame.
GAIN = 1.5
WARMUP, ITERS = 3, 20


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
    ``{"wall_ms", "busy_ms", "kernels": [(name, ms), ...]}`` per call,
    kernels sorted by time; ``busy_ms`` is 0.0 when the profiler saw no
    device activity."""
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
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / n_iters)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total),
        key=lambda kv: -kv[1])
    return {"wall_ms": start.elapsed_time(end) / n_iters,
            "busy_ms": sum(ms for _, ms in kernels), "kernels": kernels}


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


def serving_weights(spec, seed=0):
    """A JAX-layout (HWIO / [in, out]) numpy tree for ``spec``: zero-mean
    normal kernels scaled by GAIN / sqrt(fan_in), small biases."""
    rng = np.random.RandomState(seed)
    params = {}
    for name, mod in spec.module().named_children():
        if not hasattr(mod, "weight"):  # dropout
            continue
        w = tuple(mod.weight.shape)
        shape = ((w[2], w[3], w[1], w[0]) if len(w) == 4 else (w[1], w[0]))
        std = 0.5 * GAIN / np.sqrt(np.prod(shape[:-1]))
        params[name] = {
            "kernel": rng.normal(0.0, std, shape).astype(np.float32),
            "bias": rng.normal(0.01, 0.05, w[0]).astype(np.float32)}
    return {"params": params}


def served_activations(spec, state_dict, frames, device):
    """``Predictor.forward``'s sequence (preprocess_frames, then the model
    in ``spec.dtype``, channels_last) on host frames, read at block3_conv3
    and the logits; float32 on the CPU."""
    from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames

    mod = spec.module(capture=(TAP, "logits"))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ab_line_classifier_torch.ops import _build
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.ops.clip_aggregation import aggregate_clips
    from ab_line_classifier_torch.ops.image import (
        MASK_OPTIONS, OUT_DTYPES, PREPROCESS_MODES, RESIZE_MODES,
        fused_preprocess, mask_kwargs, max_ulp_error)
    from ab_line_classifier_torch.predict.benchmark import (
        build_flagship, clip_inference_benchmark)
    from ab_line_classifier_torch.predict.predict import (Predictor,
                                                          group_clip_probs)
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
    libs = [_build.build(name) for name in _build.kernel_names()]
    print(f"built {len(libs)} kernel(s) in {time.perf_counter() - t0:.2f} s:"
          f" {[os.path.relpath(p, REPO) for p in libs]}")

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
    torch.cuda.synchronize()
    if PC.launch_count - count0 != n_calls:
        raise AssertionError("launch counter did not count every launch")
    print(f"grid: {n_calls} combinations over 3 source sizes agree, max abs "
          f"err {max_err}")

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

    phase("4 main path: cutoffvgg16 serving + clip aggregation")
    spec = build_flagship(OUT_HW)
    state_dict = state_dict_from_flax(serving_weights(spec))
    predictor = Predictor(spec, state_dict, batch_size=MAIN_BATCH,
                          device="cuda")
    rng = np.random.default_rng(1)
    frames480 = np.tile(rng.integers(0, 256, (512, 480, 640, 3),
                                     dtype=np.uint8), (8, 1, 1, 1))
    frames128 = rng.integers(0, 256, (4096, 128, 128, 3), dtype=np.uint8)
    lengths = [17, 32, 45, 9, 60, 23, 3, 51]
    names, paths = [], []
    while len(paths) < len(frames480) + len(frames128):
        n = min(lengths[len(names) % len(lengths)],
                len(frames480) + len(frames128) - len(paths))
        names.append(f"clip{len(names):04d}")
        paths += [f"{names[-1]}_{i}.jpg" for i in range(n)]

    PC.reset_launch_count()
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
    main_s = time.perf_counter() - t0
    launches = PC.launch_count
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    if probs.shape != (8192, 2) or not np.isfinite(probs).all():
        raise AssertionError(f"bad frame probabilities {probs.shape}")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-5:
        raise AssertionError("frame probability rows do not sum to 1")
    for algo, out in clips.items():
        if out.shape != (len(names), 2) or not np.isfinite(out).all() \
                or np.abs(out.sum(1) - 1.0).max() > 1e-5:
            raise AssertionError(f"bad {algo} clip probabilities")
    print(f"served 8192 frames into {len(names)} clips in {main_s:.2f} s "
          f"(host frames, pinned copies, 3 aggregations); preprocess "
          f"launches {launches}; P(b_lines) range "
          f"[{probs[:, 1].min():.4f}, {probs[:, 1].max():.4f}]", flush=True)

    # GPU against the same port on the CPU, on 8 frames of graded
    # brightness so that their logits differ.
    check = (frames480[:8] * np.linspace(0.15, 1.0, 8)[:, None, None, None]
             ).astype(np.uint8)
    gpu = served_activations(spec, state_dict, check, "cuda")
    cpu = served_activations(spec, state_dict, check, "cpu")
    f32 = served_activations(dataclasses.replace(spec, dtype=torch.float32),
                             state_dict, check, "cpu")
    swapped = served_activations(spec, state_dict, check[..., ::-1].copy(),
                                 "cuda")
    logits = cpu["logits"]
    spread = float(logits.max() - logits.min())
    errs = {k: rel_err(gpu[k], cpu[k]) for k in (TAP, "logits")}
    floor = {k: rel_err(cpu[k], f32[k]) for k in (TAP, "logits")}
    fault = rel_err(swapped[TAP], cpu[TAP])
    prob_err = float(np.abs(Predictor(spec, state_dict, batch_size=8,
                                      device="cpu").predict_probs(check)
                            - predictor.predict_probs(check)).max())
    print(f"GPU vs CPU on 8 frames: relative error {TAP} {errs[TAP]:.3e}, "
          f"logits {errs['logits']:.3e} (tolerance {ACT_RTOL}; CPU bf16 vs "
          f"float32 {floor[TAP]:.3e} / {floor['logits']:.3e}; channels "
          f"swapped {fault:.3e}); logit spread {spread:.3f}; max |dp| "
          f"{prob_err:.2e} (tolerance {BF16_PROB_ATOL})", flush=True)
    if spread < 20 * ACT_RTOL:
        raise AssertionError(f"logits too flat to compare ({spread})")
    if max(errs.values()) > ACT_RTOL:
        raise AssertionError(f"GPU vs CPU activations differ: {errs}")
    if fault < 3 * ACT_RTOL:
        raise AssertionError(f"a channel swap moves {TAP} by only {fault}")
    if prob_err > BF16_PROB_ATOL:
        raise AssertionError(f"GPU vs CPU probabilities differ by {prob_err}")

    phase("5 throughput")
    for bs in (1024, 2048):
        PC.reset_launch_count()
        r = clip_inference_benchmark(batch_size=bs, img_dim=OUT_HW,
                                     n_warmup=WARMUP, n_iters=ITERS,
                                     state_dict=state_dict, spec=spec,
                                     device="cuda", verbose=False)
        # Warm-up, then n and 2n timed forwards (n more if the n-vs-2n
        # dispatch check falls back to per-iteration syncs).
        bench_launches = PC.launch_count
        if bench_launches not in (WARMUP + 3 * ITERS, WARMUP + 4 * ITERS):
            raise AssertionError(f"benchmark launched the kernel "
                                 f"{bench_launches} times")
        share = r["frames_per_sec"] * r["flops_per_frame"] / PEAK_BF16_FLOPS
        print(f"throughput on {smi}: cutoffvgg16 128x128 batch {bs}: "
              f"{r['frames_per_sec']:.1f} frames/s, {r['ms_per_batch']:.3f} "
              f"ms/batch, {r['flops_per_frame'] / 1e9:.4f} GFLOP/frame, "
              f"{100 * share:.2f}% of 989 TFLOP/s bf16; preprocess launches "
              f"{bench_launches}", flush=True)
    for src in ((128, 128), (480, 640)):
        x = torch.randint(0, 256, (MAIN_BATCH, *src, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        prof = device_time_by_kernel(lambda: predictor.forward(x))
        wall, busy = prof["wall_ms"], prof["busy_ms"]
        print(f"profile, batch {MAIN_BATCH} from {src[0]}x{src[1]} on {smi}: "
              f"wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"(idle share {1 - busy / wall:.4f})")
        for name, ms in prof["kernels"][:8]:
            print(f"  {ms:9.3f} ms {100 * ms / wall:6.2f}%  {name[:110]}")
        pre = sum(ms for name, ms in prof["kernels"]
                  if "preprocess_kernel" in name)
        print(f"  preprocess kernel: {pre:.4f} ms "
              f"({100 * pre / wall:.3f}% of the batch)", flush=True)
        del x
    torch.cuda.synchronize()

    t = timing[(480, 640)]
    kernel = {"name": "preprocess", "route": "cuda",
              "source": "ab_line_classifier_torch/csrc/preprocess.cu",
              "replaces": "ab_line_classifier_tpu/ops/preprocess_pallas.py:66",
              "launches": launches, "max_abs_err": max_err,
              "max_err": max_err, "ms": t["ms"], "kernel_ms": t["ms"],
              "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
              "bound_by": t["bound_by"], "library_ms": t["library_ms"],
              "shape": f"{MAIN_BATCH}x480x640x3 uint8 -> 128x128x3 bf16"}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
