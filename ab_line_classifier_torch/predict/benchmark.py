"""Benchmarks of the port (counterparts of the JAX package's
``predict/benchmark.py``), each on the device it is given (default cuda):

* :func:`clip_inference_benchmark` — frames/sec of batched clip inference
  through the production serving forward: device-resident uint8 frames ->
  preprocess (kernel B1) -> bf16 forward -> float32 softmax, steady state,
  timed with CUDA events and the n-vs-2n check
  (:func:`dispatch_guarded_seconds`).
* :func:`gradcam_benchmark` — frames/sec of the batched Grad-CAM pass
  (preprocess -> forward -> tap gradient -> heatmaps), timed the same way.
* :func:`single_frame_latency_benchmark` — serial batch-1 latency through
  the serving forward, as a dependency-chained loop: captured once as a
  CUDA graph and replayed, beside the same loop run eagerly.
* :func:`clock_avg_runtime` — the reference's mechanism: single-image
  forwards timed one by one on the host clock, mean and std ms.
* :func:`training_throughput_benchmark` — frames/sec of the full training
  step (augmentation, forward, backward, optimizer update) per phase of
  the model's plan, each result labelled with its phase.
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


def seeded_state(spec: ModelSpec, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A Keras-style initialization of ``spec``'s module from ``seed``."""
    return spec.module(generator=torch.Generator().manual_seed(seed)
                       ).state_dict()


def random_frames(n: int, src_hw: Tuple[int, int], seed: int,
                  device: torch.device) -> torch.Tensor:
    """``n`` uint8 ``[n, H, W, 3]`` frames from a numpy seed, on
    ``device``."""
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 256, (n, *src_hw, 3), dtype=np.uint8)).to(device)


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
                    dtype: torch.dtype, device: torch.device,
                    training: bool = False) -> float:
    """Multiply-add FLOPs (2 per MAC) of one frame through the convs,
    depthwise convs and dense layers, counted from the layer shapes of a
    one-frame forward (in eval mode: nothing it runs changes the module).

    ``training``: a training step's FLOPs instead, as the module's
    ``requires_grad`` flags make autograd record them: each layer's
    forward, plus its input gradient (the same MACs again) where its input
    requires grad, plus its weight gradient (again) where its weight
    does. Elementwise work (batch norm, activations, the optimizer) is not
    counted."""
    total = 0.0

    def count(mod, inputs, macs: float) -> None:
        nonlocal total
        total += 2.0 * macs
        if training:
            total += 2.0 * macs * (bool(inputs[0].requires_grad)
                                   + bool(mod.weight.requires_grad))

    def conv_hook(mod, inputs, out):
        kh, kw = mod.kernel_size
        count(mod, inputs,
              out.numel() * (mod.in_channels // mod.groups) * kh * kw)

    def depthwise_hook(mod, inputs, out):
        count(mod, inputs, out.numel() * mod.weight[0, 0].numel())

    def dense_hook(mod, inputs, out):
        count(mod, inputs, out.numel() * mod.in_features)

    hooks = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, DepthwiseConv):
            hooks.append(m.register_forward_hook(depthwise_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(dense_hook))
    was_training = module.training
    module.eval()
    try:
        with (torch.enable_grad() if training else torch.inference_mode()):
            module(torch.zeros((1,) + tuple(input_shape), dtype=dtype,
                               device=device))
    finally:
        for h in hooks:
            h.remove()
        module.train(was_training)
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
    predictor = Predictor(spec, state_dict or seeded_state(spec, seed),
                          batch_size=batch_size, device=device)
    src = tuple(src_hw or img_dim)
    frames = random_frames(batch_size, src, seed, device)

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
        "device": _device_name(device),
    }
    if verbose:
        print(f"{spec.name} clip inference on {result['device']}: "
              f"{fps:,.0f} frames/sec (batch {batch_size}, "
              f"{result['ms_per_batch']:.2f} ms/batch)")
    return result


def gradcam_benchmark(batch_size: int = 256,
                      img_dim: Tuple[int, int] = (128, 128),
                      mode: str = "normal",
                      src_hw: Optional[Tuple[int, int]] = None,
                      n_warmup: int = 3, n_iters: int = 10,
                      state_dict: Optional[Dict] = None,
                      spec: Optional[ModelSpec] = None,
                      device=None, seed: int = 0,
                      verbose: bool = True) -> Dict:
    """Frames/sec of the batched Grad-CAM pass of ``spec`` (default:
    mixed-precision cutoffvgg16) in ``mode``: device-resident uint8 frames
    -> preprocess -> forward -> tap gradient -> heatmaps, one pass per
    batch (the JAX package's ``gradcam_benchmark``)."""
    from ab_line_classifier_torch.explain.gradcam import build_fused_gradcam
    from ab_line_classifier_torch.predict.predict import load_module

    device = resolve_device(device)
    spec = spec or build_flagship(img_dim)
    module = load_module(spec, state_dict or seeded_state(spec, seed),
                         device)
    fused = build_fused_gradcam(spec, module, mode)
    src = tuple(src_hw or img_dim)
    frames = random_frames(batch_size, src, seed, device)
    for _ in range(n_warmup):
        fused(frames)
    run_many, fallback = timers(lambda: fused(frames), device)
    dt = dispatch_guarded_seconds(run_many, fallback, n_iters)
    fps = batch_size * n_iters / dt
    result = {"gradcam_frames_per_sec": float(fps),
              "batch_size": batch_size, "mode": mode,
              "ms_per_batch": float(dt / n_iters * 1000),
              "model": spec.name, "src_hw": list(src),
              "device": _device_name(device)}
    if verbose:
        print(f"{spec.name} Grad-CAM [{mode}] on {result['device']}: "
              f"{fps:,.0f} frames/sec (batch {batch_size})")
    return result


def single_frame_latency_benchmark(img_dim: Tuple[int, int] = (128, 128),
                                   chain_len: int = 64,
                                   n_warmup: int = 3, n_iters: int = 5,
                                   state_dict: Optional[Dict] = None,
                                   spec: Optional[ModelSpec] = None,
                                   device=None, seed: int = 0,
                                   verbose: bool = True) -> Dict:
    """Serial serving latency at batch 1, ms/frame, of ``spec`` (default:
    mixed-precision cutoffvgg16): one uint8 frame on the device through
    ``Predictor.forward`` (B1 -> forward in ``spec.dtype`` -> float32
    softmax), ``chain_len`` times in a dependency chain: each step's input
    is the previous one offset by a value computed from the previous
    output that is always zero (``uint8(probs * 1e-30)``, probabilities
    being at most 1), so no step can start before the one before it ends.

    On CUDA the chain is captured once as a CUDA graph and replayed (the
    JAX package compiles it into one ``lax.scan`` program); the result
    gives the launches captured per step (``graph_launches_per_step``),
    the number of steps replayed and ``replay`` (each call runs the chain
    once more). Every replay is counted in the kernels' launch counts
    (``ops/launches.py``). Capture needs the
    wrappers' caches warm (B1's index vectors, B2's packed weights and
    launch geometry): the chain runs ``n_warmup`` times on a side stream
    first. A failed capture raises. The same chain run eagerly
    (``eager_ms_per_frame``) shows what the graph saves; on the CPU only
    the eager chain runs. Both are timed with :func:`timers` and the
    n-vs-2n check.

    ``check_frames`` (the timed frame and a second one, uint8 ``[2, H, W,
    3]``) and ``check_probs`` (float32 ``[2, C]``) are the chain's output
    on each, eager; the replayed graph, given each frame as its input,
    must reproduce them exactly, or the benchmark raises."""
    from ab_line_classifier_torch.ops import launches
    from ab_line_classifier_torch.predict.predict import Predictor

    device = resolve_device(device)
    spec = spec or build_flagship(img_dim)
    predictor = Predictor(spec, state_dict or seeded_state(spec, seed),
                          batch_size=1, device=device)
    frame = random_frames(1, tuple(img_dim), seed, device)

    @torch.inference_mode()
    def chain(x: torch.Tensor) -> torch.Tensor:
        probs = None
        for _ in range(chain_len):
            probs = predictor.forward(x)
            x = x + (probs[0, 0] * 1e-30).to(torch.uint8)
        return probs

    def ms_per_frame(fn) -> float:
        run_many, fallback = timers(fn, device)
        return dispatch_guarded_seconds(run_many, fallback,
                                        n_iters) / n_iters / chain_len * 1e3

    for _ in range(n_warmup):
        chain(frame)
    checks = [frame.clone(), random_frames(1, tuple(img_dim), seed + 1,
                                           device)]
    eager = [chain(x) for x in checks]
    result = {"model": spec.name, "chain_len": chain_len,
              "eager_ms_per_frame": ms_per_frame(lambda: chain(frame)),
              "graph_ms_per_frame": None, "device": _device_name(device),
              "check_frames": torch.cat(checks).cpu().numpy(),
              "check_probs": torch.cat(eager).cpu().numpy()}
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(n_warmup):
                chain(frame)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with launches.capture() as captured, torch.cuda.graph(graph):
            out = chain(frame)
        replays = 0

        def replay():
            nonlocal replays
            graph.replay()
            captured.replayed()
            replays += 1

        for _ in range(n_warmup):
            replay()
        result["graph_ms_per_frame"] = ms_per_frame(replay)
        # The graph reads its input frame anew on every replay, and runs the
        # same kernels on it as the eager chain.
        for x, want in zip(checks, eager):
            frame.copy_(x)
            replay()
            if not torch.equal(out, want):
                raise RuntimeError(
                    f"the replayed chain differs from the eager one by "
                    f"{float((out - want).abs().max())}")
        result["graph_launches_per_step"] = {
            name: n / chain_len for name, n in captured.per_replay.items()}
        result["replayed_steps"] = replays * chain_len
        result["replay"] = replay
    if verbose:
        graph_ms = result["graph_ms_per_frame"]
        print(f"{spec.name} batch-1 latency on {result['device']}: "
              f"eager {result['eager_ms_per_frame']:.4f} ms/frame"
              + (f", CUDA graph {graph_ms:.4f} ms/frame"
                 if graph_ms is not None else ""))
    return result


def clock_avg_runtime(n_warmup_runs: int = 10, n_experiment_runs: int = 50,
                      img_dim: Tuple[int, int] = (128, 128),
                      state_dict: Optional[Dict] = None,
                      spec: Optional[ModelSpec] = None, device=None,
                      seed: int = 0, verbose: bool = True
                      ) -> Tuple[float, float]:
    """Single-image latency by the reference's mechanism: a ``(1, H, W,
    3)`` standard-normal image (already on the device, in ``spec.dtype``)
    through the model's forward, each call timed on the host clock up to
    its probabilities on the host. Returns ``(mean_ms, std_ms)``."""
    from ab_line_classifier_torch.predict.predict import load_module
    from ab_line_classifier_torch.utils.profiling import StepTimer

    device = resolve_device(device)
    spec = spec or build_flagship(img_dim)
    module = load_module(spec, state_dict or seeded_state(spec, seed),
                         device)
    rng = np.random.RandomState(seed)
    timer = StepTimer(warmup=n_warmup_runs)
    with torch.inference_mode():
        for _ in range(n_warmup_runs + n_experiment_runs):
            x = torch.from_numpy(rng.randn(1, *img_dim, 3)).to(
                device=device, dtype=spec.dtype)
            with timer:
                module(x).cpu()
    stats = timer.summary()
    mean_ms, std_ms = stats["mean_ms"], stats["std_ms"]
    if verbose:
        print(f"Average runtime = {mean_ms:.3f} ms, "
              f"standard deviation = {std_ms:.3f} ms")
    return mean_ms, std_ms


# The config's augmentation (config.yml TRAIN.DATA_AUG).
TRAIN_AUG = {"ZOOM_RANGE": 0.1, "WIDTH_SHIFT_RANGE": 0.2,
             "HEIGHT_SHIFT_RANGE": 0.2, "ROTATION_RANGE": 45,
             "HORIZONTAL_FLIP": True, "BRIGHTNESS_RANGE": 0.3}


def training_throughput_benchmark(model_name: str = "cutoffvgg16",
                                  batch_size: int = 256,
                                  img_dim: Tuple[int, int] = (128, 128),
                                  n_warmup: int = 3, n_iters: int = 10,
                                  phase: Optional[str] = None,
                                  state_dict: Optional[Dict] = None,
                                  spec: Optional[ModelSpec] = None,
                                  device=None, seed: int = 0,
                                  verbose: bool = True) -> Dict:
    """Frames/sec of the full training step (augmentation -> forward ->
    backward -> optimizer update, ``Trainer.train_step``) of ``spec``
    (default: mixed-precision ``model_name``, float32 parameters) on one
    device-resident uint8 batch, per phase of its plan (``phase``: only
    that one), steady state, timed with :func:`timers` and the n-vs-2n
    check. The phases run in order on one trainer, so a later phase starts
    from the weights the earlier one's steps left.

    Each phase's result carries ``flops_per_frame``, counted from layer
    shapes with the phase's trainability (:func:`flops_per_frame`,
    ``training=True``). Returns ``{"phases": [...], **last phase}``."""
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.train.loop import Trainer

    device = resolve_device(device)
    spec = spec or build_zoo(model_name, img_dim)
    trainer = Trainer(spec, seed=seed, compute_dtype=spec.dtype,
                      aug_config=TRAIN_AUG, device=device)
    if state_dict is not None:
        trainer.module.load_state_dict(state_dict)
    images = random_frames(batch_size, tuple(img_dim), seed, device)
    labels = torch.as_tensor(np.random.RandomState(seed).randint(
        0, spec.n_classes, batch_size)).to(device)
    mask = torch.ones((batch_size,), device=device)
    results = []
    for phase_idx, ph in enumerate(spec.phases):
        if phase is not None and ph.name != phase:
            continue
        trainer.begin_phase(phase_idx, ph)
        metrics = M.init_metrics(spec.n_classes, device=device)

        def step():
            trainer.train_step(images, labels, mask, metrics)

        for _ in range(n_warmup):
            step()
        run_many, fallback = timers(step, device)
        dt = dispatch_guarded_seconds(run_many, fallback, n_iters)
        r = {"phase": ph.name, "model": spec.name,
             "train_frames_per_sec": float(batch_size * n_iters / dt),
             "batch_size": batch_size,
             "ms_per_step": float(dt / n_iters * 1000),
             "flops_per_frame": flops_per_frame(
                 trainer.module, spec.input_shape, spec.dtype, device,
                 training=True),
             "device": _device_name(device)}
        results.append(r)
        if verbose:
            print(f"{spec.name} train step [{ph.name}] on {r['device']}: "
                  f"{r['train_frames_per_sec']:,.0f} frames/sec (batch "
                  f"{batch_size}, {r['flops_per_frame'] / 1e9:.3f} "
                  f"GFLOP/frame)")
    if not results:
        raise ValueError(f"no phase named {phase!r} in {spec.name}")
    return {**results[-1], "phases": results}


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
