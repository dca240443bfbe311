"""PyTorch port, model zoo: mobilenetv2, xception, efficientnet (b0 here,
b7 by graph), cnn0 and custom_resnetv2 against the JAX package's.

For each model: the layer names and order (Keras numbering), the Grad-CAM
tap and freeze masks equal the JAX graph's; the weight bridge round-trips
every leaf exactly, ``batch_stats`` included; the forward agrees with the
JAX forward at 32x32 in float32 and in bfloat16, and so does an activation
captured inside the backbone.

Weights: every leaf randomized (``conftest.randomize_leaves``: variances
stay positive), then each kernel centred and scaled by ``GAIN /
sqrt(fan_in)``, each bias by 0.2 and each batch-norm scale to
N(0.4, 0.1). The batch-norm statistics are then set from each BN's input
on the 16 test frames (``graph.adapt_batch_norm``, the port in float32),
so that activations stay O(1) through the deep stacks and the logits vary
from frame to frame without saturating the softmax. Both packages load the
same tree. A BN scale near 1 puts the deep random stacks in a regime where
bfloat16 rounding noise grows layer by layer, until JAX's own bfloat16
forward moves the probabilities from its float32 one by more than the bar
below.

Tolerances: float32 probabilities within 1e-4 (the zoo's Keras-parity bar)
and logits and taps within 1e-4 relative to their scale; bfloat16
probabilities within 2e-2 (as ``tests/test_torch_model.py``): both sides
round every layer's output to bfloat16, but accumulate in different
orders, so single roundings differ by one bf16 ulp and compound with depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import randomize_leaves

from ab_line_classifier_tpu import graph as jax_G
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.models import common as jax_C
from ab_line_classifier_tpu.models.efficientnet import (
    efficientnet_backbone as jax_efficientnet_backbone)
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.efficientnet import build_efficientnet
from ab_line_classifier_torch.predict.benchmark import (
    ZOO_HPARAMS, build_zoo, clip_inference_benchmark, flops_per_frame)
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

SHAPE = (32, 32, 3)
GAIN = 1.5
F32_ATOL = 1e-4
BF16_ATOL = 2e-2

# The config.yml hyperparameters of each model (b0 takes b7's).
HPARAMS = {name: ZOO_HPARAMS[name] for name in (
    "mobilenetv2", "xception", "cnn0", "custom_resnetv2")}
HPARAMS["efficientnetb0"] = ZOO_HPARAMS["efficientnetb7"]
# A tap inside each backbone (a residual add, a SAME max-pool...).
TAPS = {"mobilenetv2": "block_12_add", "xception": "block13_pool",
        "efficientnetb0": "block4c_add", "cnn0": "maxpool2",
        "custom_resnetv2": "stage2_unit0_add"}
PREPROCESS = {"mobilenetv2": "tf", "xception": "tf",
              "efficientnetb0": "identity", "cnn0": "tf",
              "custom_resnetv2": "tf"}
MODELS = tuple(HPARAMS)


def jax_graph(name, mixed_precision=False):
    """The JAX package's graph; efficientnet b0 is its b7 builder's graph
    at b0's widths and depths."""
    if name != "efficientnetb0":
        return jax_build_model(name, HPARAMS[name], SHAPE, 2,
                               mixed_precision=mixed_precision).graph
    dtype = jnp.bfloat16 if mixed_precision else None
    graph, _ = jax_C.classifier_head(
        jax_efficientnet_backbone("b0", input_size=SHAPE[:2], dtype=dtype),
        n_classes=2, dropout=0.5, dtype=dtype)
    return graph


def port_spec(name, mixed_precision=False, shape=SHAPE):
    if name == "efficientnetb0":
        return build_efficientnet("b0", HPARAMS[name], shape, 2,
                                  mixed_precision=mixed_precision)
    return build_model(name, HPARAMS[name], shape, 2,
                       mixed_precision=mixed_precision)


def random_variables(name, seed):
    """Every leaf of the JAX variable tree randomized (shapes from
    ``jax.eval_shape``, no init run)."""
    module = jax_G.GraphModule(graph=jax_graph(name))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda k: module.init({"params": k, "dropout": k},
                              jnp.zeros((1,) + SHAPE), train=False), key)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return jax.tree.map(np.asarray, randomize_leaves(zeros, seed))


def serving_variables(name, inputs, seed=0):
    """Scaled random leaves with batch-norm statistics set from ``inputs``
    (module docstring; ``inputs`` may be of another size than SHAPE where
    the parameters' shapes do not depend on it)."""
    def scale(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = np.prod(a.shape[:-1])
            return ((a - 0.1) * GAIN / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "scale":
            return (0.4 + 0.2 * (a - 0.1)).astype(np.float32)
        if leaf == "bias":
            return (0.2 * (a - 0.1)).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(scale,
                                         random_variables(name, seed))
    module = port_spec(name, shape=inputs.shape[1:]).module()
    module.load_state_dict(state_dict_from_flax(v))
    G.adapt_batch_norm(module.eval(), torch.from_numpy(inputs))
    return flax_from_state_dict(module.state_dict())


def port_module(name, variables, mixed_precision=False, capture=()):
    spec = port_spec(name, mixed_precision)
    m = spec.module(capture=capture)
    m.load_state_dict(state_dict_from_flax(variables))
    return m.eval().to(dtype=spec.dtype)


def _frames():
    return np.random.RandomState(3).randint(0, 256, (16,) + SHAPE
                                            ).astype(np.uint8)


@pytest.fixture(scope="module", params=MODELS)
def zoo(request):
    name = request.param
    inputs = np.array(fused_preprocess(
        jnp.asarray(_frames()), out_hw=SHAPE[:2],
        preprocess_mode=PREPROCESS[name]))
    return name, serving_variables(name, inputs), inputs


def jax_apply(name, variables, x, mixed_precision=False, capture=()):
    module = jax_G.GraphModule(graph=jax_graph(name, mixed_precision),
                               capture=capture)
    return jax.jit(module.apply)(variables, x)


def test_forward_float32_matches_jax(zoo):
    name, variables, inputs = zoo
    want, caps = jax_apply(name, variables, inputs, capture=("logits",))
    with torch.no_grad():
        got, got_caps = port_module(name, variables, capture=("logits",))(
            torch.from_numpy(inputs))
    logits = np.asarray(caps["logits"])
    assert np.ptp(logits[:, 1] - logits[:, 0]) > 0.05, "logits are flat"
    assert np.asarray(want).min() > 1e-3, "the softmax saturates"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(got_caps["logits"].numpy(), logits,
                               atol=F32_ATOL * np.abs(logits).max())


def test_forward_bfloat16_matches_jax(zoo):
    name, variables, inputs = zoo
    want = np.asarray(jax_apply(name, variables,
                                jnp.asarray(inputs, jnp.bfloat16),
                                mixed_precision=True))
    module = port_module(name, variables, mixed_precision=True)
    for m in module.modules():  # statistics stay float32 through the cast
        if isinstance(m, (G.BatchNorm, G.Normalization)):
            assert all(t.dtype == torch.float32 for t in m.state_dict()
                       .values())
    with torch.no_grad():
        got = module(torch.from_numpy(inputs).to(torch.bfloat16))
    assert got.dtype == torch.float32  # the softmax runs in float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_capture_tap_matches_jax(zoo):
    """An activation captured inside the backbone (NHWC) equals JAX's."""
    name, variables, inputs = zoo
    tap = TAPS[name]
    _, caps = jax_apply(name, variables, inputs, capture=(tap,))
    want = np.asarray(caps[tap])
    with torch.no_grad():
        _, got = port_module(name, variables, capture=(tap,))(
            torch.from_numpy(inputs))
    assert tuple(got[tap].shape) == want.shape
    np.testing.assert_allclose(got[tap].numpy(), want,
                               atol=F32_ATOL * np.abs(want).max())


@pytest.mark.parametrize("name", MODELS)
def test_graph_matches_jax(name):
    """Keras layer names and order, freeze masks and the Grad-CAM tap."""
    jax_graph_ = jax_graph(name)
    spec = port_spec(name)
    assert spec.graph.layer_names == jax_graph_.layer_names
    assert ([s.kind for s in spec.graph.layers]
            == [s.kind for s in jax_graph_.layers])
    for freeze_idx in (-1, 10, 116):
        assert (spec.graph.trainable_mask(freeze_idx, backbone_len=100)
                == jax_graph_.trainable_mask(freeze_idx, backbone_len=100))
    assert spec.last_conv_layer == jax_graph_.last_layer_of_kind(
        jax_G.KIND_CONV, jax_G.KIND_DEPTHWISE)


def test_efficientnetb7_graph_matches_jax():
    """The served B7 at 128x128, by graph only (no init): 55 blocks, 51 of
    their depthwise layers stride-1 SAME (the CUDA kernel's)."""
    hp = {"LR": 0.1, "DROPOUT": 0.5, "FREEZE_IDX": -1}
    want = jax_build_model("efficientnetb7", hp, (128, 128, 3), 2).graph
    spec = build_model("efficientnetb7", hp, (128, 128, 3), 2)
    assert spec.preprocess_mode == "identity"
    assert spec.graph.layer_names == want.layer_names
    dw = [s for s in spec.module().modules()
          if isinstance(s, G.DepthwiseConv)]
    assert len(dw) == 55
    assert sum(m.stride == 1 and m.padding == "SAME" for m in dw) == 51


@pytest.mark.parametrize("name", MODELS)
def test_bridge_round_trip_is_exact(name):
    v = random_variables(name, seed=1)
    assert set(v) == {"params", "batch_stats"}
    sd = state_dict_from_flax(v)
    port_spec(name).module().load_state_dict(sd)  # strict: same keys/shapes
    back = flax_from_state_dict(sd)
    assert set(back) == set(v)
    for col in v:
        assert (jax.tree_util.tree_structure(back[col])
                == jax.tree_util.tree_structure(v[col]))
        for a, b in zip(jax.tree.leaves(v[col]), jax.tree.leaves(back[col])):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_predictor_matches_jax(zoo):
    """The serving entry point on the CPU: uint8 frames through
    ``Predictor.predict_probs`` (the preprocess's plain version, then the
    model) against the JAX forward, in float32."""
    name, variables, inputs = zoo
    want = np.asarray(jax_apply(name, variables, inputs))
    predictor = Predictor(port_spec(name), state_dict_from_flax(variables),
                          batch_size=6, compute_dtype=torch.float32,
                          device="cpu")
    np.testing.assert_allclose(predictor.predict_probs(_frames()), want,
                               atol=F32_ATOL)


def test_restore_serves_a_zoo_checkpoint(tmp_path):
    """A mixed-precision mobilenetv2 checkpoint restored by
    ``Predictor.restore`` (the predict CLI's path) serves what the saved
    weights give."""
    spec = build_zoo("mobilenetv2", SHAPE[:2])
    sd = spec.module(generator=torch.Generator().manual_seed(2)).state_dict()
    meta = {"model_name": "mobilenetv2", "hparams": HPARAMS["mobilenetv2"],
            "input_shape": list(SHAPE), "n_classes": 2,
            "mixed_precision": True}
    torch_ckpt.save_model(str(tmp_path / "model1"), sd, meta)
    restored = Predictor.restore(str(tmp_path / "latest"), batch_size=8,
                                 device="cpu")
    assert restored.spec.dtype == torch.bfloat16
    direct = Predictor(spec, sd, batch_size=8, device="cpu")
    frames = _frames()
    np.testing.assert_array_equal(restored.predict_probs(frames),
                                  direct.predict_probs(frames))


def test_flops_per_frame_counts_depthwise():
    """The benchmark's FLOP count includes each depthwise layer's
    2 * out * K^2 (a grouped conv in the port's own module)."""
    module = G.GraphModule(G.graph_of(
        G.depthwise_conv2d("dw", G.INPUT, 4, (3, 3)),
        G.separable_conv2d("sep", "dw", 4, 5, (5, 5)),
        G.global_avg_pool("gap", "sep"),
        G.dense("logits", "gap", 5, 2)))
    want = (2 * 36 * 4 * 9) + (2 * 36 * 4 * 25 + 2 * 36 * 5 * 4) + 2 * 2 * 5
    assert flops_per_frame(module, (6, 6, 4), torch.float32,
                           torch.device("cpu")) == want
    r = clip_inference_benchmark(batch_size=2, img_dim=SHAPE[:2],
                                 n_warmup=1, n_iters=1,
                                 spec=build_zoo("mobilenetv2", SHAPE[:2]),
                                 device="cpu", verbose=False)
    assert r["model"] == "mobilenetv2" and r["frames_per_sec"] > 0
    assert r["flops_per_frame"] > 0
