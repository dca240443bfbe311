"""PyTorch port, depthwise convolution (kernel B2): the kernel's plain
version and the grouped-conv reference against the JAX package's Pallas
kernel (interpret mode) and its XLA reference, and the autograd entry
point's dispatch and gradients; and the CUDA kernel's launch geometry,
which must give every output to exactly one thread. The CUDA kernel itself
is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``).

Layouts: JAX takes NHWC ``x`` and a ``[K, K, 1, C]`` kernel, the port an
NCHW view and ``[C, 1, K, K]``. Tolerances as
``tests/test_depthwise_pallas.py``: float32 within 1e-5 (different
summation orders), bfloat16 within 1e-2 absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.ops.depthwise_pallas import (
    _lax_reference, depthwise_conv_interpret)
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.ops import depthwise as D
from ab_line_classifier_torch.ops import depthwise_cuda, launches

# The shapes of tests/test_depthwise_pallas.py.
SHAPES = [
    ((3, 16, 16, 96), 3),    # C < 128
    ((2, 8, 8, 200), 5),     # 5x5 (efficientnetb7 blocks), ragged C
    ((5, 9, 7, 64), 3),      # odd H/W
    ((1, 32, 32, 128), 3),
    ((70, 4, 4, 256), 3),    # many frames
]


def _inputs(shape, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kern = rng.standard_normal((k, k, 1, shape[-1])) * 0.2
    return x, kern.astype(np.float32)


def _port(x, kern, dtype=torch.float32):
    """NHWC numpy -> the port's NCHW (channels_last) tensor and weight."""
    tx = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    tw = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()).to(dtype)
    return tx, tw


def _nhwc(t):
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_matches_pallas_kernel(shape, k):
    x, kern = _inputs(shape, k, 0)
    want = np.asarray(depthwise_conv_interpret(jnp.asarray(x),
                                               jnp.asarray(kern)))
    got = D.depthwise_plain(*_port(x, kern))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_reference_matches_lax_reference(shape, k):
    x, kern = _inputs(shape, k, 1)
    want = np.asarray(_lax_reference(jnp.asarray(x), jnp.asarray(kern)))
    got = D.depthwise_reference(*_port(x, kern))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_plain_bf16_matches_pallas_bf16():
    """bf16 inputs, float32 accumulation, bf16 output on both sides."""
    x, kern = _inputs((4, 12, 12, 96), 3, 2)
    want = depthwise_conv_interpret(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(kern, jnp.bfloat16))
    got = D.depthwise_plain(*_port(x, kern, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("stride,padding", [(2, "VALID"), (2, "SAME"),
                                            (1, "VALID")])
def test_unsupported_configs_take_the_reference(stride, padding):
    """Stride 2 and VALID (the zoo's zero-padded reductions) run the
    grouped conv, equal to the XLA reference."""
    x, kern = _inputs((2, 17, 17, 48), 3, 4)
    tx, tw = _port(x, kern)
    assert not D._supported(tx, tw, stride, padding)
    want = np.asarray(_lax_reference(jnp.asarray(x), jnp.asarray(kern),
                                     stride, padding))
    got = D.depthwise_conv(tx, tw, stride, padding)
    assert got.shape == D.depthwise_reference(tx, tw, stride, padding).shape
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_supported_layer_runs_the_plain_version_on_cpu():
    """On a CPU tensor a supported layer computes the kernel's plain
    version (bit for bit) and launches nothing."""
    x, kern = _inputs((3, 10, 9, 40), 5, 5)
    tx, tw = _port(x, kern)
    assert D._supported(tx, tw, 1, "SAME")
    before = launches.count("depthwise")
    got = D.depthwise_conv(tx, tw)
    assert launches.count("depthwise") == before
    torch.testing.assert_close(got, D.depthwise_plain(tx, tw), rtol=0,
                               atol=0)


def test_grad_matches_jax_grad_of_lax_reference():
    """The autograd function's backward (grouped-conv gradients) against
    ``jax.grad`` of the XLA reference, for the loss ``sum(y * g)`` with a
    fixed random cotangent ``g`` of scale 0.05 (gradients of order 0.1, so
    1e-5 is a float32 bar)."""
    x, kern = _inputs((2, 10, 10, 32), 3, 3)
    g = (np.random.default_rng(6).standard_normal(x.shape) * 0.05
         ).astype(np.float32)

    def loss(a, b):
        return jnp.sum(_lax_reference(a, b) * g)

    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kern))
    tx, tw = _port(x, kern)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    (D.depthwise_conv(tx, tw) * _port(g, kern)[0]).sum().backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gk), atol=1e-5)


def test_packed_weight_layout_and_cache():
    """The kernel's ``[K, K, C]`` float32 weight, cached per layer and
    rebuilt when the weight changes in place or is cast."""
    layer = G.depthwise_conv2d("dw", G.INPUT, 6, (3, 3)).module_fn(
        torch.Generator().manual_seed(0))
    w = layer.weight.detach()
    packed = depthwise_cuda.pack_weight(w)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    for dh in range(3):
        for dw in range(3):
            torch.testing.assert_close(packed[dh, dw], w[:, 0, dh, dw],
                                       rtol=0, atol=0)
    first = layer.packed_weight()
    assert layer.packed_weight() is first
    with torch.no_grad():
        layer.weight.mul_(2.0)
    torch.testing.assert_close(layer.packed_weight(), 2.0 * first, rtol=0,
                               atol=0)
    layer.to(torch.bfloat16)
    assert layer.packed_weight().dtype == torch.float32
    torch.testing.assert_close(layer.packed_weight(),
                               depthwise_cuda.pack_weight(layer.weight),
                               rtol=0, atol=0)


def _writes(g, b, h, w, c):
    """How many threads write each output of a ``[b, h, w, c]`` tensor
    under geometry ``g``, by the kernel's index math (``Geometry``'s
    docstring, ``csrc/depthwise.cu::tile_at``); raises on a write outside
    it."""
    bx, by = g.block
    t = np.arange(g.count(b))
    ct, t = t % g.ch_tiles, t // g.ch_tiles
    wt, t = t % g.col_tiles, t // g.col_tiles
    rt, frame = t % g.row_tiles, t // g.row_tiles
    cv = ct[:, None] * bx + np.arange(bx)               # [tile, tx]
    xo = wt[:, None] * by + np.arange(by)               # [tile, ty]
    row = rt[:, None] * g.rows + np.arange(g.rows)      # [tile, t]
    ch = cv[:, :, None] * g.vec + np.arange(g.vec)      # [tile, tx, e]
    # Threads past w or c compute nothing; rows past h are not stored.
    live = ((cv * g.vec < c)[:, :, None, None, None]
            & (xo < w)[:, None, :, None, None]
            & (row < h)[:, None, None, :, None])
    lin = ((((frame[:, None, None, None, None] * h
              + row[:, None, None, :, None]) * w
             + xo[:, None, :, None, None]) * c)
           + ch[:, :, None, None, :])
    lin = np.broadcast_to(lin, np.broadcast_shapes(lin.shape, live.shape))
    live = np.broadcast_to(live, lin.shape)
    assert ch[(cv * g.vec < c)].max() < c
    return np.bincount(lin[live], minlength=b * h * w * c)


@pytest.mark.parametrize("k,itemsize,aligned,threads", [
    (3, 2, True, 0), (1, 2, True, 256), (3, 2, False, 256),
    (5, 4, True, 128), (7, 2, True, 32)])
def test_launch_geometry_covers_every_output_once(k, itemsize, aligned,
                                                  threads):
    """H, W in 1..20, C in 1..70, 2 frames: each output has exactly one
    writer; the tiled kernel (16-byte vectors) only where C is a whole
    number of them and the tensors are aligned, else the scalar kernel; 4
    rows a thread for frames of at most 4 rows or K >= 5, else 8; at most
    ``threads`` threads a block (0: the default, 256 or 128 by rows) and
    the shared memory within its cap. Fewer threads a block split channels
    and columns into more tiles."""
    b = 2
    for h in range(1, 21):
        for w in range(1, 21):
            for c in range(1, 71):
                g = depthwise_cuda.launch_geometry(b, h, w, c, k, itemsize,
                                                   aligned, threads=threads)
                want_vec = 16 // itemsize
                assert g.vec == (want_vec if aligned and c % want_vec == 0
                                 else 1)
                assert g.rows == (4 if h <= 4 or k >= 5 else 8)
                most = threads or (256 if g.rows == 8 else 128)
                assert g.block[0] * g.block[1] <= most
                assert g.smem <= depthwise_cuda.SMEM_MAX
                counts = _writes(g, b, h, w, c)
                assert counts.min() == 1 and counts.max() == 1, (h, w, c)


@pytest.mark.parametrize("shape,k", [((2048, 64, 64, 32), 3),
                                     ((512, 4, 4, 2304), 5),
                                     ((512, 8, 8, 728), 3),
                                     ((512, 61, 61, 64), 7),
                                     ((1100, 61, 61, 3), 3)])
def test_launch_geometry_at_serving_shapes(shape, k):
    """The zoo's shapes at serving batch (and a ragged C): within the
    grid's limit and the shared-memory cap, and every output written once
    (checked on two frames: the frames only repeat the tiling of one)."""
    b, h, w, c = shape
    g = depthwise_cuda.launch_geometry(b, h, w, c, k, 2, True)
    assert g.count(b) < 2 ** 31 and g.smem <= depthwise_cuda.SMEM_MAX
    counts = _writes(g, 2, h, w, c)
    assert counts.min() == 1 and counts.max() == 1


def test_launch_geometry_rejects_what_the_kernel_lacks():
    for kw in (dict(rows=16), dict(threads=512), dict(k=4)):
        with pytest.raises(ValueError):
            depthwise_cuda.launch_geometry(
                1, 8, 8, 8, kw.pop("k", 3), 2, True, **kw)


def _stacked_case(shape, k, n_trials, dtype, seed):
    """F trials' NHWC inputs laid out as vmap's conv rules leave them
    (memory ``[B, H, W, F, C]``), as the ``[B, F, C, H, W]`` view, and
    their weights ``[F, C, 1, K, K]``."""
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, n_trials, c), generator=gen).to(dtype)
    wt = (0.2 * torch.randn((n_trials, c, 1, k, k), generator=gen)).to(dtype)
    return x.permute(0, 3, 4, 1, 2), wt


def _mobilenetv2_slice():
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS

    hp = dict(ZOO_HPARAMS["mobilenetv2"], DROPOUT=0.0, CUTOFF_IDX=53,
              FREEZE_IDX=-1)
    return build_model("mobilenetv2", hp, (32, 32, 3), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_trials_equal_per_trial_plain(dtype):
    """Under ``torch.func.vmap`` with per-trial weights, the depthwise
    entry point runs once over all trials (``depthwise_trials``: the
    trials as ``F * C`` channels of one tensor, a view of vmap's layout);
    on the CPU that is the plain version, and each trial's output equals
    ``depthwise_plain`` of that trial alone, bit for bit, at every
    stride-1 shape of a mobilenetv2 slice (32x32, 3 trials); the weight
    and input gradients (one grouped conv over the ``F * C`` channels)
    are each trial's grouped-conv gradients within 1e-5 of the tensor's
    largest in float32 (other summation orders), 2e-2 in bfloat16."""
    from ab_line_classifier_torch.predict.benchmark import (
        depthwise_layer_shapes)

    shapes = depthwise_layer_shapes(_mobilenetv2_slice())
    assert len(shapes) == 4
    for i, (shape, k) in enumerate(shapes):
        x, wt = _stacked_case((2,) + shape[1:], k, 3, dtype, i)
        x.requires_grad_(True)
        wt.requires_grad_(True)
        y = torch.func.vmap(D.depthwise_conv, in_dims=(1, 0))(x, wt)
        assert y.shape == (3, 2) + x.shape[2:]
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(i))
        (y.float() * g).sum().backward()
        for t in range(3):
            xt = x[:, t].detach()
            assert torch.equal(y[t], D.depthwise_plain(xt, wt[t].detach()))
            xr = xt.clone().requires_grad_(True)
            wr = wt[t].detach().clone().requires_grad_(True)
            (D.depthwise_reference(xr, wr).float() * g[t]).sum().backward()
            share = 1e-5 if dtype == torch.float32 else 2e-2
            for got, want in ((x.grad[:, t], xr.grad), (wt.grad[t], wr.grad)):
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=0,
                    atol=share * float(want.abs().max()))


def test_stacked_mobilenetv2_slice_forward_equals_per_trial():
    """A mobilenetv2 slice's stacked forward (``functional_call`` under
    ``vmap``, the trial-parallel trainer's form, batch norms in their
    stacked form) equals each trial's own module forward, in float32."""
    from torch.func import functional_call, vmap

    from ab_line_classifier_torch.parallel.trial_parallel import _stack

    spec = _mobilenetv2_slice()
    mods = [spec.logits_module(generator=torch.Generator().manual_seed(s))
            for s in range(3)]
    x = torch.rand((3, 4, 32, 32, 3), generator=torch.Generator()
                   .manual_seed(9))
    for m in mods:
        G.adapt_batch_norm(m.eval(), x[0])
    states = [m.state_dict() for m in mods]
    stacked = {k: _stack([s[k] for s in states], "cpu") for k in states[0]}
    template = mods[0].to(memory_format=torch.channels_last).eval()
    got = vmap(lambda s, xx: functional_call(
        template, s, (xx,), {"bn_stats": {}}))(stacked, x)
    for t, m in enumerate(mods):
        m.load_state_dict(states[t])
        with torch.no_grad():
            want = m.eval()(x[t])
        torch.testing.assert_close(got[t].detach(), want, rtol=1e-5,
                                   atol=1e-5)


def test_stacked_step_keeps_the_trials_channels_last(monkeypatch):
    """In a stacked mixed-precision mobilenetv2 training step and
    evaluation (the trial-parallel trainer's), every input that reaches the
    trial launch lies in memory as ``[B, H, W, F, C]``: the ``F * C``-wide
    tensor B2 takes is then a view, and the kernel copies nothing
    (``copy_count`` 0 on the card). The zero pads before the stride-2
    layers keep that layout (``ops/padding.py::pad_hw``)."""
    import numpy as np

    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import metrics as M
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)
    from ab_line_classifier_torch.predict.benchmark import (TRAIN_AUG,
                                                            ZOO_HPARAMS)

    layouts = []
    trials = D.depthwise_trials

    def spy(x, w):
        layouts.append(x.permute(0, 3, 4, 1, 2).is_contiguous())
        return trials(x, w)

    monkeypatch.setattr(D, "depthwise_trials", spy)
    spec = build_model("mobilenetv2", ZOO_HPARAMS["mobilenetv2"],
                       (64, 64, 3), 2, mixed_precision=True)
    n, b = 2, 4
    pt = ParallelFoldTrainer(spec, n, class_weights=np.ones((n, 2)),
                             aug_config=TRAIN_AUG,
                             compute_dtype=torch.bfloat16, device="cpu")
    params, buffers = pt.init_stacked()
    opt = pt.begin_phase(0, spec.phases[0], params)
    images = torch.randint(0, 256, (n, b, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    labels = torch.zeros((n, b), dtype=torch.int64)
    mask = torch.ones((n, b))
    pt.train_step(params, buffers, opt, images, labels, mask, np.ones(n),
                  np.ones(n), M.init_metrics(2, trials=n))
    pt.eval_step(params, buffers, images, labels, mask,
                 M.init_metrics(2, trials=n))
    assert layouts == [True] * 20
