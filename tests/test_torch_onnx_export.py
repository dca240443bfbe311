"""PyTorch port, ONNX export (``models/onnx_export.py``, ``export.py``) and
its numpy evaluator (``utils/onnx_eval.py``) against the JAX package.

The port's file, run through the port's evaluator (an interpreter written
from the ONNX operator spec, independent of the port's graph), is within
5e-6 of the port's own float32 forward and within 1e-5 of the JAX
package's forward on the same weights (the two forwards sum their convs
in other orders). Both packages' importers read the port's file back bit
for bit, every leaf first set to a non-zero value (a zero-initialized leaf
would round-trip through an importer that skips it). The port's evaluator
agrees with the JAX package's on a file the JAX package exported, within
1e-6: the port's sums its conv and matmul products in float64 and rounds
once, the JAX package's sums in float32.

Inputs and weights come from numpy seeds; weights cross between the
packages through ``utils/jax_params.py``. Batch-norm statistics are set
from the test frames (``graph.adapt_batch_norm``), so the probabilities
vary from frame to frame rather than saturating at 0 or 1. The full
efficientnetb7 export runs on the card (``chip_smoke.py``), not here.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import REPO_ROOT, randomize_leaves

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.models import common as jax_C
from ab_line_classifier_tpu.models.efficientnet import (
    efficientnet_backbone as jax_efficientnet_backbone)
from ab_line_classifier_tpu.models.onnx_export import (
    export_onnx as jax_export_onnx)
from ab_line_classifier_tpu.models.onnx_weights import import_onnx_weights
from ab_line_classifier_tpu.models.weights import export_h5_weights
from ab_line_classifier_tpu.utils import onnx_proto as jax_OP
from ab_line_classifier_tpu.utils.onnx_eval import evaluate as jax_evaluate
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.config import load_config
from ab_line_classifier_torch.export import export_checkpoint, main
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.efficientnet import build_efficientnet
from ab_line_classifier_torch.models.onnx_export import (ExportError,
                                                         export_onnx)
from ab_line_classifier_torch.models.onnx_weights import import_onnx_state
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.utils import onnx_proto as OP
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)
from ab_line_classifier_torch.utils.onnx_eval import evaluate

IMG = (64, 64, 3)
# The six zoo models of the JAX package's export test, and efficientnet at
# b0's widths (efficientnetb7's graph).
ZOO = ("cutoffvgg16", "cnn0", "mobilenetv2", "xception", "custom_resnetv2",
       "vgg16", "efficientnetb0")
HPARAMS = {name: ZOO_HPARAMS[name] for name in ZOO[:-1]}
HPARAMS["efficientnetb0"] = ZOO_HPARAMS["efficientnetb7"]
EVAL_ATOL = 5e-6   # the port's file against the port's float32 forward
JAX_ATOL = 1e-5    # ... against the JAX package's float32 forward


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small CPU ops (module initializations, the
    evaluator's per-tap sums), which PyTorch's intra-op threads only slow
    down when several test workers share the host: one thread each, the
    process's setting restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def specs(name, shape=IMG, mixed_precision=False):
    """(port spec, JAX spec) of ``name`` at ``shape``."""
    if name != "efficientnetb0":
        return (build_model(name, HPARAMS[name], shape, 2,
                            mixed_precision=mixed_precision),
                jax_build_model(name, HPARAMS[name], shape, 2))
    graph, regs = jax_C.classifier_head(
        jax_efficientnet_backbone("b0", input_size=shape[:2]),
        n_classes=2, dropout=0.5)
    jax_spec = jax_C.ModelSpec(name="efficientnetb0", graph=graph,
                               preprocess_mode="identity",
                               phases=jax_C.single_phase(graph, -1, 0.1),
                               input_shape=shape, n_classes=2,
                               activity_regularizers=regs)
    return build_efficientnet("b0", HPARAMS[name], shape, 2), jax_spec


def frames(n=2, seed=0, shape=IMG):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


def calibrated_state(spec, x, seed=3):
    """Weights from a numpy seed: kernels N(0, 1) scaled by 1.5 /
    sqrt(fan_in), biases by 0.2, batch-norm scales N(0.4, 0.1) (as
    ``tests/test_torch_zoo.py``), then the batch-norm statistics set from
    ``x``."""
    module = spec.module()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.as_tensor(rng.standard_normal(p.shape)
                                        * 1.5 / np.sqrt(fan_in)))
            elif name.endswith("bias"):
                p.copy_(torch.as_tensor(rng.standard_normal(p.shape) * 0.2))
            else:
                p.copy_(torch.as_tensor(rng.normal(0.4, 0.1, p.shape)))
    G.adapt_batch_norm(module.eval(), torch.as_tensor(x))
    return module.state_dict()


def port_forward(spec, state, x):
    module = spec.module()
    module.load_state_dict(state)
    with torch.inference_mode():
        return module.eval()(torch.as_tensor(x)).numpy()


def randomized_state(spec, seed):
    """Every leaf non-zero (``conftest.randomize_leaves`` on the tree of a
    fresh port module); returns (port state dict, JAX tree)."""
    tree = randomize_leaves(flax_from_state_dict(spec.module().state_dict()),
                            seed)
    return state_dict_from_flax(tree), tree


@pytest.mark.parametrize("name", ZOO)
def test_export_matches_port_and_jax_forward(name, tmp_path):
    spec, jax_spec = specs(name)
    x = frames()
    state = calibrated_state(spec, x)
    path = str(tmp_path / f"{name}.onnx")
    model = export_onnx(spec, state, path, batch_size=2)
    convs = [n for n in model.graph.node if n.op_type == "Conv"]
    inits = OP.initializer_arrays(model.graph)
    assert convs and inits[convs[0].input[1]].ndim == 4  # OIHW kernels
    assert all(a.dtype != np.float64 for a in inits.values())

    got = evaluate(OP.load_model(path), {"input_1": x})[0]
    want = port_forward(spec, state, x)
    np.testing.assert_allclose(got, want, atol=EVAL_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert np.ptp(want[:, 0]) > 2 * EVAL_ATOL  # the frames are told apart

    variables = jax.tree.map(jnp.asarray, flax_from_state_dict(state))
    ref = np.asarray(jax_spec.module().apply(variables, jnp.asarray(x),
                                             train=False))
    np.testing.assert_allclose(got, ref, atol=JAX_ATOL)


@pytest.mark.parametrize("name", ("cutoffvgg16", "cnn0", "mobilenetv2",
                                  "xception", "efficientnetb0"))
def test_both_importers_read_the_port_file_back_bitwise(name, tmp_path):
    """Conv, depthwise, separable, batch norm, Normalization and dense
    leaves all come back exactly, through the JAX package's importer and
    the port's, with no partial-import warning."""
    spec, jax_spec = specs(name, (32, 32, 3))
    state, tree = randomized_state(spec, seed=17)
    path = str(tmp_path / f"{name}.onnx")
    export_onnx(spec, state, path, batch_size=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        imported, _ = import_onnx_weights(
            path, randomized_state(spec, seed=42)[1], graph=jax_spec.graph,
            verbose=False)
        port_state, copied = import_onnx_state(
            path, spec.module(generator=torch.Generator().manual_seed(9)
                              ).state_dict(), graph=spec.graph,
            verbose=False)
    for col in tree:
        want = jax.tree_util.tree_flatten_with_path(tree[col])[0]
        got = dict((jax.tree_util.keystr(k), a) for k, a in
                   jax.tree_util.tree_flatten_with_path(imported[col])[0])
        for k, a in want:
            np.testing.assert_array_equal(
                np.asarray(got[jax.tree_util.keystr(k)]), np.asarray(a),
                err_msg=f"{col}{jax.tree_util.keystr(k)}")
    assert port_state.keys() == state.keys()
    for k, t in state.items():
        assert torch.equal(port_state[k], t), k
    assert copied == len({k.split(".")[0] for k in state})


@pytest.mark.parametrize("name", ("cnn0", "mobilenetv2"))
def test_port_evaluator_equals_jax_evaluator_on_a_jax_file(name, tmp_path):
    _, jax_spec = specs(name, (32, 32, 3))
    variables = jax_spec.init_variables(jax.random.PRNGKey(0))
    path = str(tmp_path / f"jax_{name}.onnx")
    jax_export_onnx(jax_spec, variables, path, batch_size=2)
    x = frames(shape=(32, 32, 3))
    want = jax_evaluate(jax_OP.load_model(path), {"input_1": x})[0]
    got = evaluate(OP.load_model(path), {"input_1": x})[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bf16_model_exports_as_float32(tmp_path):
    spec, _ = specs("cnn0", (32, 32, 3), mixed_precision=True)
    x = frames(shape=(32, 32, 3))
    state = {k: v.to(torch.bfloat16) for k, v in
             calibrated_state(spec, x).items()}
    path = str(tmp_path / "mp.onnx")
    model = export_onnx(spec, state, path, batch_size=2)
    T = model.graph.initializer[0].__class__
    assert {t.data_type for t in model.graph.initializer
            if t.name.startswith("model/")} == {T.FLOAT}
    got = evaluate(model, {"input_1": x})[0]
    # Against the float32 forward of the bf16-rounded weights, and the
    # bf16 forward itself (bf16 compute drift only).
    f32 = {k: v.to(torch.float32) for k, v in state.items()}
    np.testing.assert_allclose(got, port_forward(
        build_model("cnn0", HPARAMS["cnn0"], (32, 32, 3), 2), f32, x),
        atol=EVAL_ATOL)
    module = spec.module()
    module.load_state_dict(f32)
    module = module.eval().to(torch.bfloat16)
    with torch.inference_mode():
        bf16 = module(torch.as_tensor(x, dtype=torch.bfloat16)).float()
    assert np.abs(got - bf16.numpy()).max() < 2e-2


def port_config(tmp_path, model_name, onnx_or_h5):
    """config.yml with the model, 64x64 frames and PATHS.MODEL_TO_LOAD
    pointing at ``onnx_or_h5``; returns (Config, its YAML path)."""
    with open(os.path.join(REPO_ROOT, "config.yml")) as f:
        d = yaml.safe_load(f)
    d["DATA"]["IMG_DIM"] = list(IMG[:2])
    d["TRAIN"]["MODEL_DEF"] = model_name
    d["HPARAMS"][model_name.upper()] = dict(HPARAMS[model_name])
    d["PATHS"]["MODEL_TO_LOAD"] = onnx_or_h5
    cfg_path = str(tmp_path / "config.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(d, f)
    return load_config(cfg_path), cfg_path


def test_export_checkpoint_from_h5_and_the_cli(tmp_path):
    spec, jax_spec = specs("cnn0")
    x = frames()
    state = calibrated_state(spec, x)
    h5 = str(tmp_path / "w.h5")
    export_h5_weights(h5, flax_from_state_dict(state))
    cfg, cfg_path = port_config(tmp_path, "cnn0", h5)
    out = str(tmp_path / "m.onnx")
    export_checkpoint(h5, out, batch_size=2, cfg=cfg, device="cpu")
    want = port_forward(spec, state, x)
    got = evaluate(OP.load_model(out), {"input_1": x})[0]
    np.testing.assert_allclose(got, want, atol=EVAL_ATOL)

    cli_out = str(tmp_path / "cli.onnx")
    assert main(["--config", cfg_path, "--out", cli_out, "--batch-size",
                 "2", "--device", "cpu"]) == 0
    got = evaluate(OP.load_model(cli_out), {"input_1": x})[0]
    np.testing.assert_allclose(got, want, atol=EVAL_ATOL)


@pytest.mark.parametrize("name", ("cutoffvgg16", "mobilenetv2"))
def test_restored_onnx_serves_as_the_direct_predictor(name, tmp_path):
    """Checkpoint -> ONNX -> ``Predictor.restore`` on the CPU serves the
    probabilities of a predictor built on the same weights (float32
    preprocessing, uint8 frames through kernel B1's plain version)."""
    spec, _ = specs(name)
    state = calibrated_state(spec, frames(8, seed=4))
    path = str(tmp_path / f"{name}.onnx")
    export_onnx(spec, state, path, batch_size=1)
    cfg, _ = port_config(tmp_path, name, path)
    restored = Predictor.restore(path, cfg=cfg, device="cpu",
                                 compute_dtype=torch.float32)
    direct = Predictor(spec, state, device="cpu",
                       compute_dtype=torch.float32)
    u8 = np.random.RandomState(0).randint(0, 256, (4, *IMG)).astype(np.uint8)
    np.testing.assert_allclose(restored.predict_probs(u8),
                               direct.predict_probs(u8), atol=1e-6)


def test_unknown_layer_raises_export_error(tmp_path):
    graph = G.graph_of(G.conv2d("conv", G.INPUT, 3, 4, (3, 3)),
                       G.activation("act", "conv", torch.tanh),
                       G.global_avg_pool("gap", "act"),
                       G.dense("logits", "gap", 4, 2),
                       G.softmax("output", "logits"))
    spec = build_model("cnn0", HPARAMS["cnn0"], (8, 8, 3), 2)
    spec = spec.__class__(name="toy", graph=graph, preprocess_mode="tf",
                          input_shape=(8, 8, 3), n_classes=2)
    with pytest.raises(ExportError, match="act"):
        export_onnx(spec, spec.module().state_dict(),
                    str(tmp_path / "toy.onnx"))


def test_average_pools_and_odd_pads_match_the_forward(tmp_path):
    """The layer kinds no zoo model has at these sizes: a TF ``SAME``
    average pool at stride 2 on an odd size (asymmetric pads, counted in
    the mean), a ``VALID`` one, a ``SAME`` max pool on an odd size and a
    stride-2 ``SAME`` conv (``SameConv2d``)."""
    graph = G.graph_of(
        G.conv2d("conv", G.INPUT, 3, 4, (3, 3), strides=(2, 2),
                 padding="SAME", act=torch.relu),
        G.avg_pool("avg_same", "conv", (3, 3), (2, 2), padding="SAME"),
        G.max_pool("max_same", "avg_same", (2, 2), (2, 2), padding="SAME"),
        G.avg_pool("avg_valid", "conv", (2, 2)),
        G.global_avg_pool("gap0", "max_same"),
        G.global_avg_pool("gap1", "avg_valid"),
        G.add("sum", "gap0", "gap1"),
        G.dense("logits", "sum", 4, 2),
        G.softmax("output", "logits"))
    spec = build_model("cnn0", HPARAMS["cnn0"], (8, 8, 3), 2)
    spec = spec.__class__(name="toy", graph=graph, preprocess_mode="tf",
                          input_shape=(19, 21, 3), n_classes=2)
    x = frames(3, seed=2, shape=(19, 21, 3))
    state = calibrated_state(spec, x)
    model = export_onnx(spec, state, str(tmp_path / "toy.onnx"),
                        batch_size=3)
    got = evaluate(model, {"input_1": x})[0]
    np.testing.assert_allclose(got, port_forward(spec, state, x),
                               atol=EVAL_ATOL)
