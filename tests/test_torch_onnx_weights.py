"""PyTorch port, ONNX weights: ``utils/onnx_proto.py`` and
``models/onnx_weights.py`` against the JAX package's.

Each file (the tf2onnx-style and torch-style cnn0 fixtures of
``tests/test_onnx_weights.py``, and the JAX package's own ``export_onnx``
of cnn0 and cutoffvgg16 at 32x32) imports into the port with the same
state as the JAX importer gives, bit for bit (compared through the weight
bridge), and the port's float32 forward then agrees with the JAX forward
within 1e-4 (the zoo's Keras-parity bar). The partial-import warning and
the tensor decoding are the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import randomize_leaves
from test_onnx_weights import HP as CNN0_HP
from test_onnx_weights import _add_init, _add_node, _new_model
from test_onnx_weights import _write_cnn0_onnx
from test_torch_model import serving_variables as vgg_variables

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.models.onnx_export import export_onnx
from ab_line_classifier_tpu.models.onnx_weights import (
    import_onnx_weights as jax_import_onnx)
from ab_line_classifier_tpu.utils import onnx_proto as jax_OP
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models import onnx_weights
from ab_line_classifier_torch.utils import onnx_proto as OP
from ab_line_classifier_torch.utils.onnx_minimal_pb2 import messages
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

SHAPE = (32, 32, 3)
F32_ATOL = 1e-4
VGG_HP = {"DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7}


def _cnn0():
    jax_spec = jax_build_model("cnn0", CNN0_HP, SHAPE, 2)
    v = randomize_leaves(jax_spec.init_variables(jax.random.PRNGKey(0)),
                         seed=17)
    return jax_spec, build_model("cnn0", CNN0_HP, SHAPE, 2), jax.tree.map(
        np.asarray, v)


def _vgg():
    jax_spec = jax_build_model("cutoffvgg16", VGG_HP, SHAPE, 2)
    return (jax_spec, build_model("cutoffvgg16", VGG_HP, SHAPE, 2),
            jax.tree.map(np.asarray, vgg_variables(jax_spec)))


def _check(path, jax_spec, spec, variables, graph=True):
    """The port's import of ``path`` equals the JAX importer's, bit for bit,
    and serves the JAX forward of ``variables`` within F32_ATOL."""
    fresh = jax.tree.map(np.zeros_like, variables)
    want, want_n = jax_import_onnx(path, fresh,
                                   graph=jax_spec.graph if graph else None,
                                   verbose=False)
    state, n = onnx_weights.import_onnx_state(
        path, spec.module().state_dict(),
        graph=spec.graph if graph else None, verbose=False)
    assert n == want_n > 0
    want_state = state_dict_from_flax(want)
    assert set(state) == set(want_state)
    for k, v in want_state.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    x = np.random.RandomState(0).normal(0, 40, (4,) + SHAPE).astype(
        np.float32)
    module = spec.module()
    module.load_state_dict(state)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_spec.module().apply(variables, x, train=False))
    assert np.ptp(ref[:, 1]) > 1e-4, "the probabilities are flat"
    np.testing.assert_allclose(got, ref, atol=F32_ATOL)
    return state


@pytest.mark.parametrize("style", ["tf2onnx", "torch"])
def test_exporter_styles_match_jax(tmp_path, style):
    """tf2onnx style (layer names kept, MatMul + Add dense) binds by name
    with no graph; torch style (anonymous names, Gemm transB=1) needs the
    graph for the positional strategy."""
    jax_spec, spec, v = _cnn0()
    path = str(tmp_path / "m.onnx")
    _write_cnn0_onnx(path, jax_spec, v, style=style)
    if style == "torch":
        with pytest.raises(ValueError, match="layer names"):
            onnx_weights.import_onnx_state(path, spec.module().state_dict(),
                                           verbose=False)
    state = _check(path, jax_spec, spec, v, graph=style == "torch")
    back = flax_from_state_dict(state)
    for layer, leaves in v["params"].items():
        for k, arr in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][k], arr)


@pytest.mark.parametrize("name", ["cnn0", "cutoffvgg16"])
def test_jax_export_onnx_matches_jax(tmp_path, name):
    """The JAX package's own ``export_onnx`` (batch norms decomposed into
    arithmetic, restored by the named-initializer fill)."""
    jax_spec, spec, v = _cnn0() if name == "cnn0" else _vgg()
    path = str(tmp_path / f"{name}.onnx")
    export_onnx(jax_spec, v, path, batch_size=2)
    _check(path, jax_spec, spec, v)


def test_separable_missing_pointwise_bias_warns_and_leaves_layer(tmp_path):
    """All-or-nothing separable import: a pointwise Conv without the bias
    the layer expects fails the whole layer, with the partial-import
    warning, and the layer keeps its values."""
    rng = np.random.RandomState(1)
    m = _new_model()
    g = m.graph
    w1 = _add_init(g, "model/sepconv1/depthwise_kernel:0",
                   rng.randn(4, 1, 3, 3).astype(np.float32))
    x = _add_node(g, "Conv", "model/sepconv1/separable_conv2d",
                  ["input", w1], ["dw_out"], group=4)
    w2 = _add_init(g, "model/sepconv1/pointwise_kernel:0",
                   rng.randn(8, 4, 1, 1).astype(np.float32))
    _add_node(g, "Conv", "model/sepconv1/separable_conv2d_pw", [x, w2],
              ["pw_out"], group=1)
    path = str(tmp_path / "sep.onnx")
    jax_OP.save_model(m, path)
    state = {"sepconv1.depthwise.weight": torch.full((4, 1, 3, 3), 0.5),
             "sepconv1.pointwise.weight": torch.full((8, 4, 1, 1), 0.25),
             "sepconv1.pointwise.bias": torch.full((8,), 0.125)}
    with pytest.warns(UserWarning, match="partial ONNX import"):
        out, copied = onnx_weights.import_onnx_state(path, state,
                                                     verbose=False)
    assert copied == 0
    for k, v in state.items():
        torch.testing.assert_close(out[k], v, rtol=0, atol=0)
    # With the bias, the pair binds to the layer: (C, 1, kH, kW) group=C
    # becomes the depthwise weight as it stands.
    b = _add_init(g, "model/sepconv1/bias:0",
                  rng.randn(8).astype(np.float32))
    g.node[1].input.append(b)
    jax_OP.save_model(m, path)
    out, copied = onnx_weights.import_onnx_state(path, state, verbose=False)
    assert copied == 1
    inits = jax_OP.initializer_arrays(jax_OP.load_model(path).graph)
    np.testing.assert_array_equal(out["sepconv1.depthwise.weight"].numpy(),
                                  inits["model/sepconv1/depthwise_kernel:0"])
    np.testing.assert_array_equal(out["sepconv1.pointwise.bias"].numpy(),
                                  inits["model/sepconv1/bias:0"])


def test_tensor_decoding_matches_jax():
    """raw_data, the typed repeated fields, float16 and the bfloat16 bit
    pattern decode as in the JAX package; a tensor the port encodes reads
    back in the JAX package."""
    T = messages().TensorProto
    cases = [OP.array_to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                                "w"),
             OP.array_to_tensor(np.asarray([7, -9], np.int64), "i")]
    t = T(name="f", data_type=T.FLOAT)
    t.dims.extend([3])
    t.float_data.extend([1.0, 2.0, 3.0])
    cases.append(t)
    t = T(name="h", data_type=T.FLOAT16)
    t.dims.extend([2])
    t.raw_data = np.asarray([1.5, -2.25], np.float16).tobytes()
    cases.append(t)
    t = T(name="b", data_type=T.BFLOAT16)
    t.dims.extend([2])
    t.raw_data = ((np.asarray([1.0, -3.0], np.float32).view(np.uint32)
                   >> 16).astype(np.uint16)).tobytes()
    cases.append(t)
    for t in cases:
        jax_t = jax_OP.P.TensorProto()
        jax_t.ParseFromString(t.SerializeToString())
        got, want = OP.tensor_to_array(t), jax_OP.tensor_to_array(jax_t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
