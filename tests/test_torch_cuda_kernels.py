"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version. Every test here needs an NVIDIA GPU and nvcc, and skips
with a reason elsewhere (the kernels have no CPU mode). The module imports
only torch, numpy and the port, so it runs on a machine without JAX::

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda

Tolerance of the preprocess kernel: float32 within 1 ulp, bfloat16 within
1 bfloat16 ulp, taken at the larger of |out| and |bias[c]|
(``ops/image.py::max_ulp_error``). The port's kernel and plain version
agree exactly in practice. The depthwise kernel sums the plain version's
products in the same order with the same roundings: it must agree
exactly.
"""

import itertools

import pytest
import torch

from ab_line_classifier_torch.ops import depthwise as torch_depthwise
from ab_line_classifier_torch.ops import depthwise_cuda
from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.ops import launches
from ab_line_classifier_torch.ops import preprocess_cuda
from ab_line_classifier_torch.ops.image import (MASK_OPTIONS, OUT_DTYPES,
                                                PREPROCESS_MODES, RESIZE_MODES,
                                                mask_kwargs, max_ulp_error)

OUT_HW = (32, 32)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, over the
    whole grid, with a 0/1 beam mask."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for hs, ws in ((70, 190), (480, 640), (601, 803)):
        x = torch.randint(0, 256, (3, hs, ws, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        m = (torch.rand((hs, ws), device="cuda", generator=gen)
             > 0.3).float()
        for mode, resize, mask, dtype in itertools.product(
                PREPROCESS_MODES, RESIZE_MODES, MASK_OPTIONS, OUT_DTYPES):
            kw = dict(out_hw=OUT_HW, preprocess_mode=mode,
                      resize_mode=resize, out_dtype=dtype,
                      **mask_kwargs(mask, m))
            before = launches.count("preprocess")
            got = preprocess_cuda.cuda_preprocess(x, **kw)
            assert launches.count("preprocess") == before + 1
            want = torch_image.fused_preprocess(x, **kw)
            max_ulp_error(got, want, dtype, mode)


@pytest.mark.cuda
def test_cuda_kernel_64bit_offsets():
    """A batch past 2^31 source bytes (1100 frames of 1080x1440x3): the
    last frames are read through 64-bit offsets."""
    _need_cuda()
    x = torch.randint(0, 256, (1100, 1080, 1440, 3), dtype=torch.uint8,
                      device="cuda")
    assert x.numel() > 2 ** 31
    kw = dict(out_hw=(128, 128), preprocess_mode="caffe", resize_mode="tf",
              out_dtype=torch.bfloat16)
    got = preprocess_cuda.cuda_preprocess(x, **kw)
    want = torch_image.fused_preprocess(x, **kw)
    max_ulp_error(got[-8:], want[-8:], torch.bfloat16, "caffe")
    assert torch.equal(got, want)


# The shapes the port's paths give the preprocess kernel: (batch, source,
# resize map, output dtype, UI blank) -> 128x128 caffe. Serving at 2048
# from 128x128 and 480x640 frames, deploy clips of 480x640 and 1080x1440,
# a batch-1 latency step.
PATH_SHAPES = ((2048, (128, 128), "tf", torch.bfloat16, False),
               (2048, (480, 640), "tf", torch.bfloat16, False),
               (256, (480, 640), "cv2", torch.float32, True),
               (64, (1080, 1440), "cv2", torch.float32, True),
               (1, (128, 128), "tf", torch.bfloat16, False))


def _on_path(x, path, out_hw, preprocess_mode="scale", resize_mode="tf",
             mask=None, out_dtype=torch.float32, blank_ui_region=False):
    """The preprocess kernel on one of its paths (a key of
    ``preprocess_cuda.PATHS``), launched through the plan: counts
    nothing."""
    b, hs, ws, _ = x.shape
    _, args = preprocess_cuda.plan_launch(
        b, (hs, ws), out_hw, resize_mode, preprocess_mode, out_dtype,
        blank_ui_region, x.device, path=path)
    out = torch.empty((b, *out_hw, 3), dtype=out_dtype, device=x.device)
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device).float().contiguous()
    preprocess_cuda.launch(x, out, args, mask)
    return out


def _assert_preprocess_equal(x, paths=(), **kw):
    """The wrapper (the plan's path; one launch counted) and each of
    ``paths`` (none counted) bit-equal to the plain version."""
    want = torch_image.fused_preprocess(x, **kw)
    before = launches.count("preprocess")
    assert torch.equal(preprocess_cuda.cuda_preprocess(x, **kw), want), kw
    for path in paths:
        assert torch.equal(_on_path(x, path, **kw), want), (path, kw)
    assert launches.count("preprocess") == before + 1


@pytest.mark.cuda
def test_preprocess_kernel_at_the_path_shapes():
    """Bit-equal to the plain version where the main paths call it, and,
    on every path of the kernel, on a batch slice whose data pointer is off
    the 16-byte grid (601x803 frames) and where the map upsamples (64x64 ->
    128x128)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, src, resize, dtype, blank in PATH_SHAPES:
        x = torch.randint(0, 256, (b, *src, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        _assert_preprocess_equal(x, out_hw=(128, 128),
                                 preprocess_mode="caffe", resize_mode=resize,
                                 out_dtype=dtype, blank_ui_region=blank)
    odd = torch.randint(0, 256, (5, 601, 803, 3), dtype=torch.uint8,
                        device="cuda", generator=gen)[1:]
    assert odd.data_ptr() % 16 != 0
    up = torch.randint(0, 256, (6, 64, 64, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    for x, out_hw in ((odd, (128, 128)), (odd, (32, 32)), (up, (128, 128))):
        for mode, resize, mask, dtype in itertools.product(
                PREPROCESS_MODES, RESIZE_MODES, MASK_OPTIONS, OUT_DTYPES):
            beam = (torch.rand(x.shape[1:3], device="cuda", generator=gen)
                    > 0.3).float()
            _assert_preprocess_equal(x, preprocess_cuda.PATHS,
                                     out_hw=out_hw, preprocess_mode=mode,
                                     resize_mode=resize, out_dtype=dtype,
                                     **mask_kwargs(mask, beam))


@pytest.mark.cuda
def test_preprocess_kernel_in_a_cuda_graph():
    """Captured once and replayed twice on new frames copied into the
    captured input, on the plan's path and each path of the kernel, at a
    staged, a blanked and a gathered (4K) shape: each replay equal to the
    plain version."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (b, src, blank), path in itertools.product(
            ((64, (128, 128), False), (32, (480, 640), True),
             (4, (2160, 3840), False)), (None, *preprocess_cuda.PATHS)):
        kw = dict(out_hw=(128, 128), preprocess_mode="caffe",
                  resize_mode="cv2", out_dtype=torch.bfloat16,
                  blank_ui_region=blank)

        def run():
            if path is None:
                return preprocess_cuda.cuda_preprocess(x, **kw)
            return _on_path(x, path, **kw)

        x = torch.zeros((b, *src, 3), dtype=torch.uint8, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = run()
        for _ in range(2):
            x.copy_(torch.randint(0, 256, x.shape, dtype=torch.uint8,
                                  device="cuda", generator=gen))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, torch_image.fused_preprocess(x, **kw)), \
                path


def _depthwise_case(shape, k, dtype, gen):
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    wt = (0.2 * torch.randn((shape[-1], 1, k, k), device="cuda",
                            generator=gen)).to(dtype)
    return x.permute(0, 3, 1, 2), wt


def _assert_depthwise_equal(x, wt):
    before = launches.count("depthwise")
    got = depthwise_cuda.cuda_depthwise(x, depthwise_cuda.pack_weight(wt))
    assert launches.count("depthwise") == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, torch_depthwise.depthwise_plain(x, wt))


@pytest.mark.cuda
def test_depthwise_kernel_matches_plain_version():
    """K in {1, 3, 5, 7}, float32 and bfloat16, C a whole number of 16-byte
    vectors or not (3, 13, 36, ...), odd and even H/W, frames of at most 4
    rows, batch 1 and more; then an input past 2^31 bytes (64-bit
    offsets)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((1, 16, 16, 32), (3, 9, 7, 96), (2, 8, 8, 200),
              (4, 4, 4, 728), (2, 5, 6, 3840), (2, 7, 5, 3), (1, 4, 9, 13),
              (3, 11, 3, 36))
    for shape, k, dtype in itertools.product(
            shapes, (1, 3, 5, 7), (torch.float32, torch.bfloat16)):
        _assert_depthwise_equal(*_depthwise_case(shape, k, dtype, gen))
    x = torch.randn((1100, 64, 64, 128), device="cuda", generator=gen
                    ).permute(0, 3, 1, 2)
    assert x.numel() * 4 > 2 ** 31
    wt = 0.2 * torch.randn((128, 1, 3, 3), device="cuda", generator=gen)
    got = depthwise_cuda.cuda_depthwise(x, depthwise_cuda.pack_weight(wt))
    assert torch.equal(got[-4:], torch_depthwise.depthwise_plain(x[-4:], wt))


@pytest.mark.cuda
def test_depthwise_kernel_unaligned_and_copied_inputs():
    """Data pointers off the 16-byte grid (a batch slice of frames of 910 or
    1820 bytes with odd C; a 40-channel tensor one element into its
    storage) need no copy and give the plain version's result; an input in
    NCHW memory is copied once to channels_last, and counted."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for k, dtype in itertools.product((1, 3, 5, 7),
                                      (torch.float32, torch.bfloat16)):
        x, wt = _depthwise_case((3, 5, 7, 13), k, dtype, gen)
        flat = torch.randn(1 + 2 * 6 * 6 * 40, device="cuda",
                           generator=gen).to(dtype)
        shifted = flat[1:].view(2, 6, 6, 40).permute(0, 3, 1, 2)
        w40 = _depthwise_case((1, 1, 1, 40), k, dtype, gen)[1]
        copies = depthwise_cuda.copy_count
        for xx, ww in ((x[1:], wt), (shifted, w40)):
            assert xx.data_ptr() % 16 != 0
            _assert_depthwise_equal(xx, ww)
        assert depthwise_cuda.copy_count == copies
    x, wt = _depthwise_case((2, 6, 6, 40), 3, torch.bfloat16, gen)
    copies = depthwise_cuda.copy_count
    _assert_depthwise_equal(x.contiguous(), wt)
    assert depthwise_cuda.copy_count == copies + 1


@pytest.mark.cuda
def test_depthwise_kernel_at_every_zoo_shape():
    """Every distinct stride-1 depthwise shape of mobilenetv2, xception and
    efficientnetb7 at 128x128 (two frames each), in both dtypes."""
    _need_cuda()
    from ab_line_classifier_torch.predict.benchmark import (
        build_zoo, depthwise_layer_shapes)

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = {s for name in ("mobilenetv2", "xception", "efficientnetb7")
              for s in depthwise_layer_shapes(build_zoo(name))}
    assert len(shapes) == 23
    for (shape, k), dtype in itertools.product(
            sorted(shapes), (torch.float32, torch.bfloat16)):
        _assert_depthwise_equal(*_depthwise_case((2,) + shape[1:], k, dtype,
                                                 gen))


@pytest.mark.cuda
def test_depthwise_trial_launch_matches_plain_version():
    """B2's launch over F trials (``depthwise_trials``: trial-major
    ``F * C`` channels, per-trial weights), as ``torch.func.vmap`` reaches
    it, at every stride-1 mobilenetv2 shape at 128x128 (4 frames, F = 4),
    in both dtypes: one launch, no input copied, each trial equal to its
    own one-trial launch and to the plain version."""
    _need_cuda()
    from ab_line_classifier_torch.predict.benchmark import (
        build_zoo, depthwise_layer_shapes)

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 4
    for (shape, k), dtype in itertools.product(
            depthwise_layer_shapes(build_zoo("mobilenetv2")),
            (torch.float32, torch.bfloat16)):
        _, h, w, c = shape
        x = torch.randn((4, h, w, n, c), device="cuda",
                        generator=gen).to(dtype).permute(0, 3, 4, 1, 2)
        wt = (0.2 * torch.randn((n, c, 1, k, k), device="cuda",
                                generator=gen)).to(dtype)
        launches.reset()
        depthwise_cuda.copy_count = 0
        y = torch.func.vmap(torch_depthwise.depthwise_conv,
                            in_dims=(1, 0))(x, wt)
        assert (launches.count("depthwise"),
                depthwise_cuda.copy_count) == (1, 0)
        for t in range(n):
            xt = x[:, t].contiguous(memory_format=torch.channels_last)
            one = depthwise_cuda.cuda_depthwise(
                xt, depthwise_cuda.pack_weight(wt[t]))
            assert torch.equal(y[t], one)
            assert torch.equal(y[t], torch_depthwise.depthwise_plain(
                xt, wt[t]))


@pytest.mark.cuda
def test_gradcam_through_the_depthwise_kernel():
    """Grad-CAM of mobilenetv2 on the card: its forward launches the
    depthwise kernel 10 times, the tap gradient is taken after them, and
    the probabilities are those of ``Predictor.forward`` on the same batch
    (same module, same preprocess, same kernels)."""
    _need_cuda()
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.explain.gradcam import build_fused_gradcam
    from ab_line_classifier_torch.predict.benchmark import (build_zoo,
                                                            seeded_state)
    from ab_line_classifier_torch.predict.predict import Predictor

    spec = build_zoo("mobilenetv2")
    predictor = Predictor(spec, seeded_state(spec, 3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randint(0, 256, (16, 128, 128, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    G.adapt_batch_norm(predictor.module, preprocess_cuda.preprocess_frames(
        frames, out_hw=(128, 128), preprocess_mode=spec.preprocess_mode,
        out_dtype=spec.dtype))
    fused = build_fused_gradcam(spec, predictor.module, "plusplus")
    before = launches.count("depthwise")
    probs, cams = fused(frames)
    assert launches.count("depthwise") == before + 10
    torch.testing.assert_close(probs, predictor.forward(frames), rtol=0,
                               atol=0)
    assert cams.shape == (16, 128, 128) and cams.dtype == torch.float32
    assert torch.isfinite(cams).all()
    assert 0.0 <= float(cams.min()) and float(cams.max()) <= 1.0
    assert float(cams.amax(dim=(1, 2)).max()) > 0.5


@pytest.mark.cuda
def test_graphed_gradcam_equals_the_eager_pass():
    """Grad-CAM of a 32x32 mobilenetv2 (bf16, cuDNN deterministic), both
    modes, over two batches in the order a, b, b, a: the graphed pass (the
    first call eager on the side stream, the second captured and
    replayed, the rest replayed) bit-equal to the eager pass on every
    call, so no result is overwritten by a later replay; B1 once and B2
    once a depthwise layer per batch in both, the replays' launches
    counted."""
    _need_cuda()
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.explain.gradcam import (MODES,
                                                          build_fused_gradcam)
    from ab_line_classifier_torch.predict.benchmark import (
        build_zoo, depthwise_layer_shapes, seeded_state)
    from ab_line_classifier_torch.predict.predict import load_module

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        spec = build_zoo("mobilenetv2", (32, 32))
        module = load_module(spec, seeded_state(spec, 3),
                             torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(4)
        batches = [torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8,
                                 device="cuda", generator=gen)
                   for _ in range(2)]
        G.adapt_batch_norm(module, preprocess_cuda.preprocess_frames(
            torch.cat(batches), out_hw=(32, 32),
            preprocess_mode=spec.preprocess_mode, out_dtype=spec.dtype))
        per_forward = len(depthwise_layer_shapes(spec))
        assert per_forward > 0
        order = (0, 1, 1, 0)
        for mode in MODES:
            fused = build_fused_gradcam(spec, module, mode)
            assert fused.graph_mode == "graphed"
            runs = []
            for fn in (fused, fused.eager):
                launches.reset()
                depthwise_cuda.copy_count = 0
                outs = [fn(batches[i]) for i in order]
                torch.cuda.synchronize()
                runs.append((outs, _launches()))
            (got, got_n), (want, want_n) = runs
            assert got_n == want_n == (4, 4 * per_forward)
            assert depthwise_cuda.copy_count == 0
            for (gp, gc), (wp, wc) in zip(got, want):
                assert torch.equal(gp, wp) and torch.equal(gc, wc), mode
            assert not torch.equal(got[0][1], got[1][1])
            summary, = fused.summaries().values()
            assert summary["eager_steps"] == 1 and summary["replays"] == 3
            # The batch norm pass: the 38 before the tap (the tap's
            # block_12_project_BN is recorded by autograd).
            assert summary["captured_launches"] == {
                "preprocess": 1, "depthwise": per_forward, "epilogue": 0,
                "bn_act": 38}
    finally:
        torch.backends.cudnn.deterministic = flags


@pytest.mark.cuda
def test_graphed_serving_equals_the_eager_forward():
    """The serving forward of a 32x32 mobilenetv2 (bf16, cuDNN
    deterministic) over two batches in the order a, b, b, a: the graphed
    forward (the first call eager on the side stream, the second captured
    and replayed, the rest replayed) bit-equal to ``Predictor.eager`` on
    every call, so no result is overwritten by a later replay; B1 once
    and B2 once a depthwise layer per call in both, the replays' launches
    counted; weights copied in place are seen by the next replay; a
    ragged host sweep through the batch's one program."""
    _need_cuda()
    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.predict.benchmark import (
        build_zoo, depthwise_layer_shapes, seeded_state)
    from ab_line_classifier_torch.predict.predict import Predictor

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        spec = build_zoo("mobilenetv2", (32, 32))
        predictor = Predictor(spec, seeded_state(spec, 3), batch_size=16,
                              device="cuda")
        assert predictor.graph_mode == "graphed"
        gen = torch.Generator(device="cuda").manual_seed(4)
        batches = [torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8,
                                 device="cuda", generator=gen)
                   for _ in range(2)]
        G.adapt_batch_norm(predictor.module, preprocess_cuda.preprocess_frames(
            torch.cat(batches), out_hw=(32, 32),
            preprocess_mode=spec.preprocess_mode, out_dtype=spec.dtype))
        per_forward = len(depthwise_layer_shapes(spec))
        assert per_forward > 0
        order = (0, 1, 1, 0)
        runs = []
        for fn in (predictor.forward, predictor.eager):
            launches.reset()
            depthwise_cuda.copy_count = 0
            outs = [fn(batches[i]) for i in order]
            torch.cuda.synchronize()
            runs.append((outs, _launches()))
        (got, got_n), (want, want_n) = runs
        assert got_n == want_n == (4, 4 * per_forward)
        assert depthwise_cuda.copy_count == 0
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert not torch.equal(got[0], got[1])
        summary, = predictor.summaries().values()
        assert summary["eager_steps"] == 1 and summary["replays"] == 3
        assert summary["captured_launches"] == {"preprocess": 1,
                                                "depthwise": per_forward,
                                                "epilogue": 0, "bn_act": 39}
        state = {k: v * 1.05 if k.endswith("weight") else v
                 for k, v in predictor.module.state_dict().items()}
        predictor.module.load_state_dict(state)
        moved = predictor.forward(batches[0])
        assert torch.equal(moved, predictor.eager(batches[0]))
        assert not torch.equal(moved, got[0])
        host = torch.cat(batches).cpu().numpy()[:27]
        probs = predictor.predict_probs(host)
        tail = torch.zeros_like(batches[0])
        tail[:11] = batches[1][:11]
        assert torch.equal(torch.as_tensor(probs), torch.cat(
            [predictor.eager(batches[0]), predictor.eager(tail)[:11]]).cpu())
        assert list(predictor.summaries()) == ["16x32x32x3"]
    finally:
        torch.backends.cudnn.deterministic = flags


@pytest.mark.cuda
def test_mobilenetv2_training_step_through_the_depthwise_kernel():
    """A mobilenetv2 training step on the card (every layer but the batch
    norms trainable, float32, TF32 off): B2 launched once per stride-1
    depthwise layer, no input copied, and every gradient within 1e-4
    (relative Frobenius) of the same step with the depthwise layers on the
    grouped conv (B2's backward is the grouped conv's gradient; the
    forwards agree to float32 rounding)."""
    _need_cuda()
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
    from ab_line_classifier_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = dict(ZOO_HPARAMS["mobilenetv2"], FREEZE_IDX=-1, DROPOUT=0.0)
    spec = build_model("mobilenetv2", hp, (32, 32, 3), 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.randint(0, 2, (16,), device="cuda", generator=gen)
    mask = torch.ones(16, device="cuda")
    state = spec.module().state_dict()

    def step():
        t = Trainer(spec, seed=0, device="cuda")
        t.begin_phase(0, spec.phases[0], state)
        t.train_step(images, labels, mask, M.init_metrics(2, device="cuda"))
        return {n: p.grad for n, p in t.module.named_parameters()
                if p.grad is not None}

    launches.reset()
    depthwise_cuda.copy_count = 0
    got = step()
    assert launches.count("depthwise") == 10
    assert depthwise_cuda.copy_count == 0
    supported = torch_depthwise._supported
    torch_depthwise._supported = lambda *a: False
    try:
        want = step()
    finally:
        torch_depthwise._supported = supported
    assert launches.count("depthwise") == 10
    assert set(got) == set(want)
    assert any("depthwise" in n for n in got)
    for n in want:
        err = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(
            1e-30))
        assert err <= 1e-4, (n, err)


# -- graphed epochs (train/graphed.py): CUDA graphs of the training step ----
GRAPH_HP = {
    "cnn0": {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 1e-4,
             "NODES_DENSE0": 8, "KERNEL_SIZE": 3, "STRIDES": 2,
             "MAXPOOL_SIZE": 2, "BLOCKS": 1, "INIT_FILTERS": 4,
             "FILTER_EXP_BASE": 2},
    "mobilenetv2": {"DROPOUT": 0.2, "CUTOFF_IDX": 53, "FREEZE_IDX": -1}}
GRAPH_AUG = {"ZOOM_RANGE": 0.1, "ROTATION_RANGE": 45, "HORIZONTAL_FLIP": True,
             "WIDTH_SHIFT_RANGE": 0.2, "HEIGHT_SHIFT_RANGE": 0.2,
             "BRIGHTNESS_RANGE": 0.3}


def _graph_case(name):
    """A 32x32 model of ``name``, 40 frames cached on the card, cuDNN
    deterministic (restored by the caller from the returned flags)."""
    import numpy as np

    from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    hp = dict(ZOO_HPARAMS.get(name, {}), **GRAPH_HP[name])
    spec = build_model(name, hp, (32, 32, 3), 2)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (40, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 2, 40)
    return spec, images, labels, DeviceCachedDataset.from_arrays(
        images, labels, "cuda"), flags


def _launches():
    return launches.count("preprocess"), launches.count("depthwise")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
def test_graphed_epoch_equals_the_eager_epoch(name):
    """Two epochs over a device cache at batch 16 (the last batch padded;
    augmentation and dropout on; the rate halved between them), graphed
    (one capture for training, one for evaluation, the rest replays) and
    per step: weights, statistics, optimizer state and metrics bit-equal,
    and the kernels' launches (the replays' counted in) equal."""
    _need_cuda()
    from ab_line_classifier_torch.models.common import scale_learning_rate
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)
    from ab_line_classifier_torch.train.loop import Trainer

    spec, _, _, cache, flags = _graph_case(name)
    try:
        runs = []
        for per_step in (False, True):
            launches.reset()
            depthwise_cuda.copy_count = 0
            t = Trainer(spec, seed=1, aug_config=GRAPH_AUG, device="cuda")
            t.begin_phase(0, spec.phases[0])
            run = t.run_epoch_per_step if per_step else t.run_epoch
            logs = []
            for epoch in range(2):
                logs.append(run(cache, 16, train=True, shuffle_seed=epoch))
                logs.append(run(cache, 16, train=False))
                assert t.epoch_mode == ("per-step" if per_step
                                        else "graphed")
                if epoch == 0:
                    scale_learning_rate(t.optimizer, 0.5)
            if not per_step:
                steps = {k: p.step.summary()
                         for k, p in t.epoch_programs.items()}
                assert steps["train"]["replays"] == 5
                assert steps["eval"]["replays"] == 5
            runs.append((t, logs, _launches()))
        (g, g_logs, g_n), (e, e_logs, e_n) = runs
        assert g_logs == e_logs
        assert g_n == e_n and g_n[0] == 6
        assert g_n[1] == 12 * len(depthwise_layer_shapes(spec))
        sg, se = g.module.state_dict(), e.module.state_dict()
        for k in se:
            assert torch.equal(sg[k], se[k]), k
        og, oe = g.optimizer.state_dict(), e.optimizer.state_dict()
        for i, slots in oe["state"].items():
            for k, v in slots.items():
                assert torch.equal(og["state"][i][k], v), (i, k)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
def test_graphed_stacked_epoch_equals_the_eager_epoch(name):
    """Two trials' stacked epoch (their host draws copied in before each
    replay; trial 1 at half the rate and stopped in the second epoch),
    graphed and per step: bit-equal, the same launches (B2 once a forward
    over both trials' channels)."""
    _need_cuda()
    import numpy as np

    from ab_line_classifier_torch.parallel import trial_parallel as tp
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)

    spec, _, _, cache, flags = _graph_case(name)
    train = [np.arange(0, 21), np.arange(14, 40)]
    val = [np.arange(0, 8), np.arange(21, 30)]
    try:
        runs = []
        for per_step in (False, True):
            launches.reset()
            depthwise_cuda.copy_count = 0
            pt = tp.ParallelFoldTrainer(
                spec, 2, class_weights=np.ones((2, 2), np.float32), seed=4,
                aug_config=GRAPH_AUG, device="cuda")
            params, buffers = pt.init_stacked()
            opt = pt.begin_phase(0, spec.phases[0], params)
            run = pt.run_epoch_per_step if per_step else pt.run_epoch
            v_idx, v_mask = pt._batch_tables(val, 16)
            logs = []
            for epoch, active in enumerate(([1.0, 1.0], [1.0, 0.0])):
                rng = np.random.RandomState(epoch)
                idx, mask = pt._batch_tables(
                    [rng.permutation(ix) for ix in train], 16)
                logs.append(run(params, buffers, opt, cache, idx, mask,
                                train=True,
                                lr_factor=np.array([1.0, 0.5], np.float32),
                                active=np.array(active, np.float32)))
                logs.append(run(params, buffers, None, cache, v_idx, v_mask,
                                train=False))
                assert pt.epoch_mode == ("per-step" if per_step
                                         else "graphed")
            runs.append(({**params, **buffers}, opt, logs, _launches()))
        (g, g_opt, g_logs, g_n), (e, e_opt, e_logs, e_n) = runs
        assert g_logs == e_logs and g_n == e_n
        assert g_n == (2, 6 * len(depthwise_layer_shapes(spec)))
        for k in e:
            assert torch.equal(g[k], e[k]), k
        assert g_opt.count.tolist() == e_opt.count.tolist() == [4, 2]
        for n, slots in e_opt.state.items():
            for k, v in slots.items():
                assert torch.equal(g_opt.state[n][k], v), (n, k)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
def test_streamed_graph_equals_the_eager_epoch(name):
    """Two epochs from host memory at batch 16 (``FrameArrays``: pinned
    staging, the last batch padded; augmentation and dropout on; the rate
    halved between them) through the streamed programs (one capture for
    training, one for evaluation, the rest replays) and op by op:
    weights, statistics, optimizer state and metrics bit-equal, and the
    kernels' launches equal."""
    _need_cuda()
    from ab_line_classifier_torch.data.pipeline import FrameArrays
    from ab_line_classifier_torch.models.common import scale_learning_rate
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)
    from ab_line_classifier_torch.train.loop import Trainer

    spec, images, labels, _, flags = _graph_case(name)
    ds = FrameArrays(images, labels, [str(i) for i in range(len(labels))])
    try:
        runs = []
        for per_step in (False, True):
            launches.reset()
            depthwise_cuda.copy_count = 0
            t = Trainer(spec, seed=1, aug_config=GRAPH_AUG, device="cuda")
            t.begin_phase(0, spec.phases[0])
            run = t.run_epoch_per_step if per_step else t.run_epoch
            logs = []
            for epoch in range(2):
                logs.append(run(ds, 16, train=True, shuffle_seed=epoch))
                logs.append(run(ds, 16, train=False))
                assert t.epoch_mode == ("per-step" if per_step
                                        else "streamed-graphed")
                if epoch == 0:
                    scale_learning_rate(t.optimizer, 0.5)
            if not per_step:
                steps = t.streamed_summaries()
                assert steps["train 16x32x32x3"]["replays"] == 5
                assert steps["eval 16x32x32x3"]["replays"] == 5
            runs.append((t, logs, _launches()))
        (g, g_logs, g_n), (e, e_logs, e_n) = runs
        assert g_logs == e_logs
        assert g_n == e_n and g_n[0] == 6
        assert g_n[1] == 12 * len(depthwise_layer_shapes(spec))
        sg, se = g.module.state_dict(), e.module.state_dict()
        for k in se:
            assert torch.equal(sg[k], se[k]), k
        og, oe = g.optimizer.state_dict(), e.optimizer.state_dict()
        for i, slots in oe["state"].items():
            for k, v in slots.items():
                assert torch.equal(og["state"][i][k], v), (i, k)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


@pytest.mark.cuda
def test_training_benchmark_times_the_graphed_step():
    """On the card the training benchmark replays the streamed step's
    CUDA graph: captured once a phase, its path and capture reported."""
    _need_cuda()
    from ab_line_classifier_torch.predict.benchmark import (
        training_throughput_benchmark)

    r = training_throughput_benchmark(model_name="cnn0", batch_size=8,
                                      img_dim=(32, 32), n_warmup=1,
                                      n_iters=2, device="cuda",
                                      verbose=False)
    assert r["graph_mode"] == "graphed"
    assert r["capture_seconds"] is not None and r["capture_seconds"] > 0
    assert r["train_frames_per_sec"] > 0


def _fan_frames(n, hw, seed):
    """uint8 RGB frames of a noisy ultrasound fan on a dark background
    (``tests/test_torch_automask.py``'s)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    ang = np.arctan2(xx - w / 2, yy + h * 0.1)
    r = np.hypot(xx - w / 2, yy + h * 0.1)
    sector = (np.abs(ang) < 0.6) & (r < h) & (r > 0.15 * h)
    f = rng.integers(0, 30, (n, h, w, 3), dtype=np.uint8)
    f[:, sector] = rng.integers(60, 256, (n, int(sector.sum()), 3),
                                dtype=np.uint8)
    return f


@pytest.mark.cuda
def test_graphed_automask_equals_the_eager_chain():
    """``UnetSegmentation.clip_mask`` (a width-16 U-Net, cuDNN
    deterministic, PyTorch's TF32 default on) over two clips of each of
    two keys in the order a, b, b, a (eager step, capture, replays) and a
    device copy of a: every mask bit-equal to ``.eager`` and every box to
    the mask's, the TF32 flags left as they were, no kernel launched;
    weights copied in place are seen by the next replay; the replayed
    mask equal to the CPU chain on the card's probabilities."""
    _need_cuda()
    from ab_line_classifier_torch.data.auto_masking import UnetSegmentation
    from ab_line_classifier_torch.models.unet import seeded_unet_state
    from ab_line_classifier_torch.ops.morphology import bounding_box

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        seg = UnetSegmentation(device="cuda")
        seg.model.load_state_dict(seeded_unet_state(16, 3))
        assert seg.graph_mode == "graphed"
        launches.reset()
        depthwise_cuda.copy_count = 0
        cases = (((96, 128), 11), ((200, 240), 10))
        for hw, n in cases:
            clips = [_fan_frames(n, hw, seed) for seed in (1, 2)]
            got = [seg.clip_mask(clips[i], hw) for i in (0, 1, 1, 0)]
            got.append(seg.clip_mask(torch.from_numpy(clips[0]).cuda(), hw))
            want = [seg.eager(clips[i], hw) for i in (0, 1, 1, 0, 0)]
            for (mask, box), w in zip(got, want):
                assert torch.equal(mask, w)
                assert box == list(bounding_box(w))
            assert not torch.equal(got[0][0], got[1][0])
            assert 0.05 < float(got[0][0].mean()) < 0.95
        assert _launches() == (0, 0)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, False)
        summaries = seg.summaries()
        assert len(summaries) == len(cases)
        for s in summaries.values():
            assert (s["eager_steps"], s["replays"]) == (1, 4)
            assert s["captured_launches"] == {"preprocess": 0,
                                              "depthwise": 0, "epilogue": 0,
                                              "bn_act": 0}
        seg.model.load_state_dict(seeded_unet_state(16, 8))
        moved, _ = seg.clip_mask(clips[0], hw)
        assert torch.equal(moved, seg.eager(clips[0], hw))
        assert not torch.equal(moved, got[0][0])
        cpu = UnetSegmentation(device="cpu")
        probs = seg.predict_masks(clips[0]).cpu()
        assert torch.equal(cpu.mask_from_probs(probs, hw), moved.cpu())
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _bits(t):
    """``t``'s bits: NaNs and signed zeros compare too."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _epilogue_case(shape, dtype, gen):
    """A channels_last ``[B, C, H, W]`` conv output and a bias in ``dtype``,
    the first frame's first pixels holding NaN, infinities, signed zeros
    (a pixel of -0 against the bias's 0 and -0), denormals, and values that
    cancel the bias (to +0) exactly or nearly."""
    b, c, h, w = shape
    y = (4 * torch.randn((b, h, w, c), device="cuda", generator=gen)
         ).to(dtype)
    bias = torch.randn(c, device="cuda", generator=gen).to(dtype)
    bias[:2] = torch.tensor([0.0, -0.0])
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                            0.0, -1e-40, 1e-40, -3.0], device="cuda")
    y[0, 0, 0, :8] = special.to(dtype)
    y[0, 0, 1, :8] = special.flip(0).to(dtype)
    y[0, 0, 2] = -0.0
    y[0, 1, 0] = -bias
    y[0, 1, 1, 2:] = (-bias[2:].float() * (1 + 2 ** -9)).to(dtype)
    return y.permute(0, 3, 1, 2), bias


@pytest.mark.cuda
def test_conv_epilogue_kernel_matches_plain_version():
    """Both variants (in place, and the 2x2 pool into a new tensor), ReLU on
    and off, bf16 and float32, 64 / 128 / 256 channels, even and odd H and
    W (the pool drops the last odd row and column): bit for bit the plain
    version, NaN, infinities, signed zeros and denormals included; one
    counted launch a call."""
    _need_cuda()
    from ab_line_classifier_torch.ops import conv_epilogue_cuda as CE

    gen = torch.Generator(device="cuda").manual_seed(21)
    for dtype, c, relu, pool, (b, h, w) in itertools.product(
            (torch.bfloat16, torch.float32), (64, 128, 256), (True, False),
            (True, False), ((2, 8, 8), (3, 7, 9), (1, 5, 6), (4, 33, 32))):
        y, bias = _epilogue_case((b, c, h, w), dtype, gen)
        x = y.clone()
        before = launches.count("epilogue")
        got = CE.conv_epilogue(x, bias, relu, pool)
        assert launches.count("epilogue") == before + 1
        want = CE.conv_epilogue_plain(y.clone(), bias, relu, pool)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want)), (dtype, c, relu, pool,
                                                      (b, h, w))
        if pool:
            assert torch.equal(_bits(x), _bits(y))
        else:
            assert got.data_ptr() == x.data_ptr()


@pytest.mark.cuda
def test_conv_epilogue_kernel_in_a_cuda_graph():
    """Captured once inside ``launches.capture()`` and replayed on new
    values copied into the captured input: each replay bit-equal to the
    plain version, one launch counted a replay."""
    _need_cuda()
    from ab_line_classifier_torch.ops import conv_epilogue_cuda as CE

    gen = torch.Generator(device="cuda").manual_seed(22)
    for pool in (True, False):
        src, bias = _epilogue_case((8, 64, 16, 16), torch.bfloat16, gen)
        y = src.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            CE.conv_epilogue(y, bias, True, pool)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with launches.capture() as captured, torch.cuda.graph(graph):
            out = CE.conv_epilogue(y, bias, True, pool)
        assert captured.per_replay["epilogue"] == 1
        for _ in range(2):
            new, _ = _epilogue_case((8, 64, 16, 16), torch.bfloat16, gen)
            y.copy_(new)
            before = launches.counts()["epilogue"]
            graph.replay()
            captured.replayed()
            torch.cuda.synchronize()
            assert launches.counts()["epilogue"] == before + 1
            want = CE.conv_epilogue_plain(new.clone(), bias, True, pool)
            assert torch.equal(_bits(out), _bits(want)), pool


@pytest.mark.cuda
def test_conv_epilogue_raises_on_what_the_kernel_does_not_take():
    """No fallback on the card: channels that are not whole 16-byte
    vectors, NCHW memory, a bias of another dtype or shape, float16."""
    _need_cuda()
    from ab_line_classifier_torch.ops import conv_epilogue_cuda as CE

    def cl(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="cuda").contiguous(
            memory_format=torch.channels_last)

    bias = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    cases = [(cl((2, 12, 4, 4)), bias[:12]),
             (torch.zeros((2, 64, 4, 4), dtype=torch.bfloat16,
                          device="cuda"), bias),
             (cl((2, 64, 4, 4)), bias.float()),
             (cl((2, 64, 4, 4)), bias[:32]),
             (cl((2, 64, 4, 4), torch.float16), bias.half())]
    for y, b in cases:
        for pool in (True, False):
            with pytest.raises(ValueError):
                CE.conv_epilogue(y, b, True, pool)


@pytest.mark.cuda
def test_cutoffvgg16_through_the_conv_epilogue():
    """A 32x32 cutoffvgg16 on the card, cuDNN deterministic: a bf16 serving
    forward (7 launches) and a ``finetune`` step with bf16 compute (5
    launches: the frozen prefix) bit-equal to the library chain's, loss
    and gradients included."""
    _need_cuda()
    import torch.nn.functional as F

    from ab_line_classifier_torch import graph as G
    from ab_line_classifier_torch.models.common import make_optimizer
    from ab_line_classifier_torch.predict.benchmark import (build_zoo,
                                                            seeded_state)
    from ab_line_classifier_torch.predict.predict import load_module

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        spec = build_zoo("cutoffvgg16", (32, 32))
        state = seeded_state(spec, 5)
        gen = torch.Generator(device="cuda").manual_seed(23)
        x = 60 * torch.randn((16, 32, 32, 3), device="cuda", generator=gen)
        labels = torch.randint(0, 2, (16,), device="cuda", generator=gen)
        module = load_module(spec, state, torch.device("cuda"))
        served, counts = [], []
        for table in (module._routes, {}):
            module._routes = table
            launches.reset()
            with torch.inference_mode():
                served.append(module(x.to(spec.dtype)))
            counts.append(launches.count("epilogue"))
        assert counts == [7, 0]
        assert torch.equal(served[0], served[1])
        finetune = {p.name: p for p in spec.phases}["finetune"]
        steps, counts = [], []
        for chain in (False, True):
            m = spec.module().cuda().to(memory_format=torch.channels_last)
            m.load_state_dict(state)
            G.set_compute_dtype(m, spec.dtype)
            if chain:
                m._routes = {}
            make_optimizer(finetune, m)
            launches.reset()
            probs = m.train()(x, generator=torch.Generator(
                device="cuda").manual_seed(3))
            loss = F.nll_loss(torch.log(probs), labels)
            loss.backward()
            counts.append(launches.count("epilogue"))
            steps.append((loss.detach(), {n: p.grad for n, p in
                                          m.named_parameters()
                                          if p.grad is not None}))
        assert counts == [5, 0]
        (loss, grads), (loss0, grads0) = steps
        assert torch.equal(loss, loss0)
        assert grads.keys() == grads0.keys()
        for n in grads:
            assert torch.equal(grads[n], grads0[n]), n
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
