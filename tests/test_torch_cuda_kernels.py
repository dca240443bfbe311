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
            before = preprocess_cuda.launch_count
            got = preprocess_cuda.cuda_preprocess(x, **kw)
            assert preprocess_cuda.launch_count == before + 1
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


def _depthwise_case(shape, k, dtype, gen):
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    wt = (0.2 * torch.randn((shape[-1], 1, k, k), device="cuda",
                            generator=gen)).to(dtype)
    return x.permute(0, 3, 1, 2), wt


def _assert_depthwise_equal(x, wt):
    before = depthwise_cuda.launch_count
    got = depthwise_cuda.cuda_depthwise(x, depthwise_cuda.pack_weight(wt))
    assert depthwise_cuda.launch_count == before + 1
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
        depthwise_cuda.reset_launch_count()
        y = torch.func.vmap(torch_depthwise.depthwise_conv,
                            in_dims=(1, 0))(x, wt)
        assert (depthwise_cuda.launch_count,
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
    before = depthwise_cuda.launch_count
    probs, cams = fused(frames)
    assert depthwise_cuda.launch_count == before + 10
    torch.testing.assert_close(probs, predictor.forward(frames), rtol=0,
                               atol=0)
    assert cams.shape == (16, 128, 128) and cams.dtype == torch.float32
    assert torch.isfinite(cams).all()
    assert 0.0 <= float(cams.min()) and float(cams.max()) <= 1.0
    assert float(cams.amax(dim=(1, 2)).max()) > 0.5


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

    depthwise_cuda.reset_launch_count()
    got = step()
    assert depthwise_cuda.launch_count == 10
    assert depthwise_cuda.copy_count == 0
    supported = torch_depthwise._supported
    torch_depthwise._supported = lambda *a: False
    try:
        want = step()
    finally:
        torch_depthwise._supported = supported
    assert depthwise_cuda.launch_count == 10
    assert set(got) == set(want)
    assert any("depthwise" in n for n in got)
    for n in want:
        err = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(
            1e-30))
        assert err <= 1e-4, (n, err)
