"""PyTorch port, depthwise convolution (kernel B2): the kernel's plain
version and the grouped-conv reference against the JAX package's Pallas
kernel (interpret mode) and its XLA reference, and the autograd entry
point's dispatch and gradients. The CUDA kernel itself is held to the plain
version on the card (``tests/test_torch_cuda_kernels.py``).

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
from ab_line_classifier_torch.ops import depthwise_cuda

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
    before = depthwise_cuda.launch_count
    got = D.depthwise_conv(tx, tw)
    assert depthwise_cuda.launch_count == before
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
