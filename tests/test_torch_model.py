"""PyTorch port, model: the weight bridge, the cutoffvgg16 forward against
the JAX package's, capture/overrides, and the graph IR's index semantics.

Weights: every leaf randomized (``conftest.randomize_leaves``), then each
kernel centred and scaled by ``GAIN / sqrt(fan_in)`` and each bias by 0.1.
Unscaled, the N(0.1, 0.5) kernels blow the logits up to ~1e3, the softmax
saturates to exact 0/1 and a comparison of probabilities is vacuous; at
this gain the logits are O(1).

Tolerances: float32 probabilities within 1e-4 (the zoo's Keras-parity bar).
bfloat16 (mixed precision) probabilities within 2e-2: both sides round
every conv output to bfloat16 (8 significant bits, 2^-8 relative), but XLA
and PyTorch accumulate and add the bias in different orders, so single
roundings differ by one bf16 ulp and compound over seven convs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import randomize_leaves

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

HPARAMS = {"DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7}
SHAPE = (32, 32, 3)
GAIN = 1.5
F32_ATOL = 1e-4
BF16_ATOL = 2e-2


def serving_variables(spec, seed=0):
    """Randomized-leaf JAX variables scaled to keep the logits O(1)."""
    v = randomize_leaves(spec.init_variables(jax.random.PRNGKey(0)), seed)
    params = {}
    for name, leaves in v["params"].items():
        k = np.asarray(leaves["kernel"])
        fan_in = np.prod(k.shape[:-1])
        params[name] = {
            "kernel": ((k - 0.1) * GAIN / np.sqrt(fan_in)).astype(np.float32),
            "bias": (np.asarray(leaves["bias"]) * 0.1).astype(np.float32)}
    return {"params": params}


@pytest.fixture(scope="module")
def jax_spec():
    return jax_build_model("cutoffvgg16", HPARAMS, SHAPE, 2)


@pytest.fixture(scope="module")
def variables(jax_spec):
    return serving_variables(jax_spec)


@pytest.fixture(scope="module")
def inputs():
    frames = np.random.RandomState(3).randint(0, 256, (4,) + SHAPE)
    return np.array(fused_preprocess(jnp.asarray(frames.astype(np.uint8)),
                                     out_hw=SHAPE[:2],
                                     preprocess_mode="caffe"))


def port_module(variables, mixed_precision=False, capture=()):
    spec = build_model("cutoffvgg16", HPARAMS, SHAPE, 2,
                       mixed_precision=mixed_precision)
    m = spec.module(capture=capture)
    m.load_state_dict(state_dict_from_flax(variables))
    return m.eval().to(dtype=spec.dtype)


def test_bridge_round_trip_is_exact(jax_spec):
    v = randomize_leaves(jax_spec.init_variables(jax.random.PRNGKey(0)), 1)
    v = jax.tree.map(np.asarray, v)
    back = flax_from_state_dict(state_dict_from_flax(v))
    assert set(back) == {"params"}
    assert (jax.tree_util.tree_structure(back["params"])
            == jax.tree_util.tree_structure(v["params"]))
    for a, b in zip(jax.tree.leaves(v["params"]),
                    jax.tree.leaves(back["params"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    sd = state_dict_from_flax(v)
    assert tuple(sd["block1_conv1.weight"].shape) == (64, 3, 3, 3)
    assert tuple(sd["logits.weight"].shape) == (2, 256)
    # Loads strictly: same keys and shapes as the port's module.
    build_model("cutoffvgg16", HPARAMS, SHAPE, 2).module().load_state_dict(sd)


def test_forward_float32_matches_jax(jax_spec, variables, inputs):
    want, caps = jax_spec.module(capture=("logits",)).apply(variables,
                                                             inputs)
    with torch.no_grad():
        got, got_caps = port_module(variables, capture=("logits",))(
            torch.from_numpy(inputs))
    logits = np.asarray(caps["logits"])
    assert np.ptp(logits) > 0.5, "weights saturate or flatten the logits"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(got_caps["logits"].numpy(), logits,
                               rtol=1e-4, atol=1e-4)


def test_forward_bfloat16_matches_jax(variables, inputs):
    spec = jax_build_model("cutoffvgg16", HPARAMS, SHAPE, 2,
                           mixed_precision=True)
    x = jnp.asarray(inputs, jnp.bfloat16)
    want = np.asarray(spec.module().apply(variables, x))
    with torch.no_grad():
        got = port_module(variables, mixed_precision=True)(
            torch.from_numpy(inputs).to(torch.bfloat16))
    assert got.dtype == torch.float32  # the softmax runs in float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_capture_and_overrides_match_jax(jax_spec, variables, inputs):
    """``capture`` returns the same block3_conv3 activation (NHWC) as JAX,
    and ``overrides`` injecting it reproduces the output on both sides."""
    tap = jax_spec.last_conv_layer
    assert tap == "block3_conv3"
    jmod = jax_spec.module(capture=(tap,))
    want_out, want_caps = jmod.apply(variables, inputs)
    act = np.asarray(want_caps[tap])
    pmod = port_module(variables, capture=(tap,))
    with torch.no_grad():
        got_out, got_caps = pmod(torch.from_numpy(inputs))
        assert tuple(got_caps[tap].shape) == act.shape
        np.testing.assert_allclose(got_caps[tap].numpy(), act,
                                   rtol=1e-4, atol=1e-4)
        # Overrides: a zeroed input still yields the captured output.
        over_out, _ = pmod(torch.zeros_like(torch.from_numpy(inputs)),
                           overrides={tap: got_caps[tap]})
    torch.testing.assert_close(over_out, got_out, rtol=0, atol=0)
    jover, _ = jmod.apply(variables, jnp.zeros_like(inputs),
                          overrides={tap: want_caps[tap]})
    np.testing.assert_allclose(over_out.numpy(), np.asarray(jover),
                               atol=F32_ATOL)


def test_graph_indices_match_jax(jax_spec):
    """Keras layer numbering, cut point, freeze masks and the Grad-CAM tap
    are the JAX package's."""
    spec = build_model("cutoffvgg16", HPARAMS, SHAPE, 2)
    assert spec.graph.layer_names == jax_spec.graph.layer_names
    for freeze_idx in (-1, 0, 4, 9, 12):
        assert (spec.graph.trainable_mask(freeze_idx, backbone_len=10)
                == jax_spec.graph.trainable_mask(freeze_idx,
                                                 backbone_len=10))
    assert spec.last_conv_layer == jax_spec.last_conv_layer
    vgg_hp = {"DROPOUT": 0.5, "LR": 0.01}
    full = jax_build_model("vgg16", vgg_hp, SHAPE, 2)
    assert (build_model("vgg16", vgg_hp, SHAPE, 2)
            .graph.layer_names == full.graph.layer_names)


@pytest.mark.parametrize("name", ["shufflenetv2", "bitr50x1", "unet",
                                  "no_such_model"])
def test_unported_models_raise(name):
    """A name outside the zoo raises (config.yml's vestigial SHUFFLENETV2 /
    BiTR50x1 sections, the auto-masking U-Net), where the JAX registry
    would fall back to cnn0."""
    with pytest.raises(NotImplementedError, match="no model"):
        build_model(name, HPARAMS, SHAPE, 2)


def test_output_bias_init():
    bias = np.array([0.25, -0.75], np.float32)
    spec = build_model("cutoffvgg16", HPARAMS, SHAPE, 2, output_bias=bias)
    np.testing.assert_array_equal(
        spec.module().logits.bias.detach().numpy(), bias)
