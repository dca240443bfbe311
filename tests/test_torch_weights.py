"""PyTorch port, Keras ``.h5`` weights: ``models/weights.py`` against the
JAX package's importer and exporter.

* A file written by the JAX package's ``export_h5_weights`` imports into a
  fresh port module (through the weight bridge) with every tensor equal to
  the source tree's, and the port's float32 forward then agrees with the
  JAX forward within 1e-4 (the zoo's Keras-parity bar), for cutoffvgg16,
  mobilenetv2 and xception.
* A file the port exports imports into the JAX package with every leaf
  bit-equal.
* Keras 3 ``.weights.h5`` (layers addressed by class and order), a partial
  match and a layer that fails half-way behave as in the JAX package.

Weights: every leaf randomized and scaled (``tests/test_torch_model.py``,
``tests/test_torch_zoo.py``), so a skipped leaf cannot compare equal by
accident.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import randomize_leaves
from test_torch_model import serving_variables as vgg_variables
from test_torch_zoo import (HPARAMS as ZOO_HP, PREPROCESS, SHAPE, jax_apply,
                            port_spec, serving_variables as zoo_variables)

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.models import weights as jax_weights
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models import weights
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

F32_ATOL = 1e-4
VGG_HP = {"DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7}
MODELS = ("cutoffvgg16", "mobilenetv2", "xception")


def _inputs(name):
    frames = np.random.RandomState(3).randint(0, 256, (8,) + SHAPE)
    mode = "caffe" if name == "cutoffvgg16" else PREPROCESS[name]
    return np.array(fused_preprocess(jnp.asarray(frames.astype(np.uint8)),
                                     out_hw=SHAPE[:2], preprocess_mode=mode))


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, JAX spec, port spec, JAX variables, preprocessed inputs)."""
    name = request.param
    x = _inputs(name)
    if name == "cutoffvgg16":
        jax_spec = jax_build_model(name, VGG_HP, SHAPE, 2)
        return (name, jax_spec, build_model(name, VGG_HP, SHAPE, 2),
                jax.tree.map(np.asarray, vgg_variables(jax_spec)), x)
    return (name, jax_build_model(name, ZOO_HP[name], SHAPE, 2),
            port_spec(name), zoo_variables(name, x), x)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for col in want:
        assert (jax.tree_util.tree_structure(got[col])
                == jax.tree_util.tree_structure(want[col])), col
        for a, b in zip(jax.tree.leaves(got[col]), jax.tree.leaves(want[col])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_apply_any(name, jax_spec, variables, x):
    if name == "cutoffvgg16":
        return jax_spec.module().apply(variables, x)
    return jax_apply(name, variables, x)


def test_jax_export_imports_into_port(model, tmp_path):
    name, jax_spec, spec, variables, x = model
    path = str(tmp_path / "w.h5")
    jax_weights.export_h5_weights(path, variables, graph=jax_spec.graph)
    state, copied = weights.import_h5_state(
        path, spec.module().state_dict(), graph=spec.graph, verbose=False)
    assert copied == len(variables["params"]) + sum(
        n not in variables["params"] for n in variables.get("batch_stats",
                                                            {}))
    want = state_dict_from_flax(variables)
    assert set(state) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    module = spec.module()
    module.load_state_dict(state)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_apply_any(name, jax_spec,
                                                        variables, x)),
                               atol=F32_ATOL)


def test_port_export_imports_into_jax_bit_equal(model, tmp_path):
    name, jax_spec, spec, variables, _ = model
    path = str(tmp_path / "w.h5")
    weights.export_h5_state(path, state_dict_from_flax(variables),
                            graph=spec.graph)
    fresh = jax.tree.map(np.zeros_like, variables)
    got, copied = jax_weights.import_h5_weights(path, fresh, verbose=False,
                                                graph=jax_spec.graph)
    assert copied > 0
    _assert_trees_equal(got, variables)


def _write_keras3(path, graph, variables):
    """A Keras 3 ``.weights.h5``: ``layers/<class>[_N]/vars/<i>`` in the
    graph's layer order, var order as keras ``layer.weights``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    counters = {}
    with h5py.File(path, "w") as f:
        layers = f.create_group("layers")
        for s in graph.layers:
            if s.name not in params and s.name not in stats:
                continue
            p = params.get(s.name, {})
            if s.kind == "bn":
                cls, ws = "batch_normalization", [
                    p["scale"], p["bias"], stats[s.name]["mean"],
                    stats[s.name]["var"]]
            elif s.kind == "dense":
                cls, ws = "dense", [p["kernel"], p["bias"]]
            else:
                cls, ws = "conv2d", [p["kernel"], p["bias"]]
            n = counters.get(cls, 0)
            counters[cls] = n + 1
            g = layers.create_group(cls if n == 0 else f"{cls}_{n}")
            g = g.create_group("vars")
            for i, w in enumerate(ws):
                g.create_dataset(str(i), data=np.asarray(w))


CNN0_HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 0.0, "NODES_DENSE0": 8,
           "KERNEL_SIZE": 3, "STRIDES": 1, "MAXPOOL_SIZE": 2, "BLOCKS": 2,
           "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}


def test_keras3_layout_matches_jax(tmp_path):
    """cnn0 (convs, batch norms, dense) in the Keras 3 layout: the port
    imports what the JAX package imports, and needs the graph."""
    jax_spec = jax_build_model("cnn0", CNN0_HP, SHAPE, 2)
    spec = build_model("cnn0", CNN0_HP, SHAPE, 2)
    v = jax.tree.map(np.asarray, randomize_leaves(
        jax_spec.init_variables(jax.random.PRNGKey(0)), seed=8))
    path = str(tmp_path / "model.weights.h5")
    _write_keras3(path, jax_spec.graph, v)
    want, want_n = jax_weights.import_h5_weights(
        path, jax.tree.map(np.zeros_like, v), verbose=False,
        graph=jax_spec.graph)
    fresh = spec.module().state_dict()
    with pytest.raises(ValueError, match="graph="):
        weights.import_h5_state(path, fresh, verbose=False)
    state, n = weights.import_h5_state(path, fresh, graph=spec.graph,
                                       verbose=False)
    assert n == want_n == len(v["params"])
    _assert_trees_equal(flax_from_state_dict(state), want)
    _assert_trees_equal(want, v)


def test_partial_match_skips_missing(tmp_path):
    """Another architecture: only same-named layers of matching shapes are
    copied (the reference's try/except name-matched copy)."""
    jax_spec = jax_build_model("cutoffvgg16", VGG_HP, (64, 64, 3), 2)
    v1 = randomize_leaves(jax_spec.init_variables(jax.random.PRNGKey(0)),
                          seed=4)
    path = str(tmp_path / "w.h5")
    jax_weights.export_h5_weights(path, v1)
    spec2 = build_model("cutoffvgg16", dict(VGG_HP, CUTOFF_LAYER=7),
                        (64, 64, 3), 2)
    fresh = spec2.module().state_dict()
    state, copied = weights.import_h5_state(path, fresh, verbose=False)
    n_layers = len({k.split(".")[0] for k in fresh})
    assert 0 < copied < n_layers
    np.testing.assert_array_equal(
        flax_from_state_dict(state)["params"]["block1_conv1"]["kernel"],
        np.asarray(v1["params"]["block1_conv1"]["kernel"]))
    # 'logits' takes 256 inputs in the file but 128 here: left as it was.
    torch.testing.assert_close(state["logits.weight"],
                               fresh["logits.weight"], rtol=0, atol=0)


def test_partial_layer_failure_is_atomic(tmp_path):
    """A layer whose h5 arrays are partly wrong (one good array, one of the
    wrong shape) is skipped whole: none of its leaves change, the other
    layers import, and the count leaves it out."""
    path = str(tmp_path / "torn.h5")
    good_kernel = np.arange(3 * 3 * 4 * 8, dtype=np.float32).reshape(
        3, 3, 4, 8)
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        g = root.create_group("conv_ok").create_group("conv_ok")
        g.create_dataset("kernel:0", data=good_kernel)
        b = root.create_group("bn_torn").create_group("bn_torn")
        b.create_dataset("gamma:0", data=np.arange(8, dtype=np.float32) + 1)
        b.create_dataset("moving_mean:0",
                         data=np.arange(8, dtype=np.float32) + 10.0)
        b.create_dataset("beta:0", data=np.zeros(5, np.float32))  # WRONG
        root.attrs["layer_names"] = [b"conv_ok", b"bn_torn"]
    # Not fresh-init constants: an early commit would show.
    state = {"conv_ok.weight": torch.zeros(8, 4, 3, 3),
             "bn_torn.weight": torch.full((8,), 7.0),
             "bn_torn.bias": torch.full((8,), 3.0),
             "bn_torn.running_mean": torch.full((8,), 5.5),
             "bn_torn.running_var": torch.full((8,), 2.25)}
    out, copied = weights.import_h5_state(path, state, verbose=False)
    assert copied == 1
    torch.testing.assert_close(out["conv_ok.weight"], torch.from_numpy(
        good_kernel.transpose(3, 2, 0, 1).copy()), rtol=0, atol=0)
    for k in ("bn_torn.weight", "bn_torn.bias", "bn_torn.running_mean",
              "bn_torn.running_var"):
        torch.testing.assert_close(out[k], state[k], rtol=0, atol=0)
