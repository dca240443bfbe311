"""PyTorch port, the Grad-CAM pass as one program per input shape
(``explain/gradcam.py::FusedGradCAM``): on the card a CUDA graph per batch
shape, here on the CPU the same body uncaptured, against the JAX package's
jitted ``build_fused_gradcam``.

The same numpy-seeded frames and weights (as in
``tests/test_torch_gradcam.py``, carried across by the weight bridge) go
through both packages in float32: cutoffvgg16 and mobilenetv2 at 32x32,
cnn0 at config.yml's stride 1, whose tap is larger than the heatmap, and
vgg16 and custom_resnetv2 at 32x32 (``tests/test_torch_predict_graph.py``'s
``zoo_models``).
Each pass object takes two batch shapes (another batch size and another
source size: two programs). Tolerances are ``tests/test_torch_gradcam.py``'s:
probabilities within 1e-5, heatmaps within 1e-4. The body against the
port's own eager pass, and across calls, is exact.

``PredictionTableLogger``'s heatmaps over two epochs whose weights differ
are held against the JAX package's logger, which compiles its pass once a
run, as the port's now keeps one module and one pass. A graph module's
forward lets each activation go after its last reader (a CUDA graph of
the pass keeps the pass's peak memory for as long as it lives).
"""

import glob
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_gradcam import (CAM_ATOL, CNN0_HP, CPU, PROB_ATOL, _frames,
                                _models)
from test_torch_predict_graph import zoo_models

from ab_line_classifier_tpu.data.pipeline import (
    FrameDataset as JaxFrameDataset)
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.explain import gradcam as jax_gradcam
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.train.callbacks import (
    PredictionTableLogger as JaxLogger)
from ab_line_classifier_torch.data.pipeline import FrameDataset
from ab_line_classifier_torch.explain import gradcam
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.predict.benchmark import (ZOO_HPARAMS,
                                                        gradcam_benchmark)
from ab_line_classifier_torch.predict.predict import load_module
from ab_line_classifier_torch.train.callbacks import PredictionTableLogger
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

CNN0_TAP_HP = dict(CNN0_HP, STRIDES=1)


def _cnn0_models():
    """cnn0 at stride 1 (a 34x34 tap of a 32x32 frame): (JAX spec, port
    spec, JAX variables)."""
    shape = (32, 32, 3)
    jax_spec = jax_build_model("cnn0", CNN0_TAP_HP, shape, 2)
    return (jax_spec, build_model("cnn0", CNN0_TAP_HP, shape, 2),
            jax_spec.init_variables(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module",
                params=["cutoffvgg16", "mobilenetv2", "cnn0", "vgg16",
                        "custom_resnetv2"])
def case(request):
    name = request.param
    if name == "cnn0":
        return name, _cnn0_models()
    if name in ("vgg16", "custom_resnetv2"):
        return name, zoo_models(name)
    return name, _models(name)


def _batches(size):
    """Two batch shapes: 4 frames at the model's size, 6 of a larger
    source (resized by the pass's preprocess)."""
    return (_frames(4, size, seed=21),
            np.random.RandomState(22).randint(
                0, 256, (6, size + 16, size + 8, 3)).astype(np.uint8))


def _pass(spec, variables, mode):
    module = load_module(spec, state_dict_from_flax(variables), CPU)
    return gradcam.build_fused_gradcam(spec, module, mode)


@pytest.mark.parametrize("mode", gradcam.MODES)
def test_graph_body_matches_jax_at_two_shapes(case, mode):
    name, (jax_spec, spec, variables) = case
    size = spec.input_shape[0]
    fused = _pass(spec, variables, mode)
    assert fused.graph_mode == "uncaptured"
    jax_fused = jax_gradcam.build_fused_gradcam(jax_spec, mode)
    for frames in _batches(size):
        got_p, got_c = fused(torch.from_numpy(frames))
        want_p, want_c = jax_fused(variables, jnp.asarray(frames))
        want_p = np.asarray(want_p, np.float32)
        want_c = np.asarray(want_c, np.float32)
        assert got_c.shape == (len(frames), size, size)
        assert got_p.dtype == got_c.dtype == torch.float32
        assert want_c.max() > 0.5, "the heatmaps are empty"
        np.testing.assert_allclose(got_p.numpy(), want_p, atol=PROB_ATOL)
        np.testing.assert_allclose(got_c.numpy(), want_c, atol=CAM_ATOL)
    assert sorted(fused.summaries()) == [f"4x{size}x{size}x3",
                                         f"6x{size + 16}x{size + 8}x3"]
    assert all(s["mode"] == "uncaptured" and s["capture_seconds"] is None
               for s in fused.summaries().values())


@pytest.mark.parametrize("mode", gradcam.MODES)
def test_graph_body_equals_the_eager_pass(case, mode):
    """The body through its fixed input, called twice a shape, against the
    same pass dispatched op by op on the frames: bit-equal."""
    _, (_, spec, variables) = case
    fused = _pass(spec, variables, mode)
    for frames in _batches(spec.input_shape[0]) * 2:
        x = torch.from_numpy(frames)
        got, want = fused(x), fused.eager(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(fused.summaries()) == 2


def test_results_are_not_aliased():
    """What the first call returned is unchanged by a second call of the
    same shape on other frames (the outputs are not the fixed buffers)."""
    _, spec, variables = _cnn0_models()
    fused = _pass(spec, variables, "normal")
    first = fused(torch.from_numpy(_frames(4, 32, seed=1)))
    kept = tuple(t.clone() for t in first)
    second = fused(torch.from_numpy(_frames(4, 32, seed=2)))
    assert not torch.equal(second[1], kept[1])
    assert torch.equal(first[0], kept[0]) and torch.equal(first[1], kept[1])


def test_forward_lets_dead_activations_go():
    """A pass holds what is live, not every activation of the graph (a
    CUDA graph of the pass keeps its peak for as long as it lives): when
    mobilenetv2's last layer runs, of the 81 module outputs before it only
    its own input is still held."""
    spec = build_model("mobilenetv2", ZOO_HPARAMS["mobilenetv2"],
                       (32, 32, 3), 2)
    module = spec.module().eval()
    names = [n for n, _ in module.named_children()]
    refs, alive = [], []

    def hook(name):
        def record(mod, args, out):
            if name == names[-1]:
                alive.append(sum(r() is not None for r in refs))
            refs.append(weakref.ref(out))
        return record

    for name, child in module.named_children():
        child.register_forward_hook(hook(name))
    with torch.no_grad():
        module(torch.zeros((2, 32, 32, 3)))
    assert len(refs) == len(names) == 82
    assert alive == [1]


def test_linear_resize_caches_its_weights():
    """The resize weights are made on the device once per (src, dst,
    antialias, device), and the values are those of fresh weights."""
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 34, 30)
                         .astype(np.float32))
    torch_image._resize_weights.clear()
    first = torch_image.linear_resize(x, (32, 32))
    made = dict(torch_image._resize_weights)
    assert sorted(k[:3] for k in made) == [(30, 32, True), (34, 32, True)]
    second = torch_image.linear_resize(x, (32, 32))
    assert torch_image._resize_weights.keys() == made.keys()
    assert all(torch_image._resize_weights[k] is w for k, w in made.items())
    wh = torch.as_tensor(torch_image.linear_resize_weights(34, 32))
    ww = torch.as_tensor(torch_image.linear_resize_weights(30, 32))
    want = torch.einsum("bhw,wj->bhj", torch.einsum("bhw,hi->biw", x, wh),
                        ww)
    assert torch.equal(first, want) and torch.equal(second, want)


def test_gradcam_benchmark_reports_its_path():
    r = gradcam_benchmark(batch_size=2, img_dim=(32, 32), n_warmup=1,
                          n_iters=1, device="cpu", verbose=False)
    assert r["graph_mode"] == "uncaptured"
    assert r["capture_seconds"] is None
    assert r["mode"] == "normal" and r["gradcam_frames_per_sec"] > 0


def test_prediction_table_logger_heatmaps_match_jax(tmp_path, monkeypatch):
    """``n_heatmaps=2`` over two epochs whose weights differ: each
    epoch's heatmaps (taken where the logger overlays them) against the
    JAX package's logger on the same frames and weights, within CAM_ATOL;
    the table's rows alike. The port's logger keeps one predictor (the
    same parameter tensors, new weights copied in) and one pass."""
    ws = str(tmp_path)
    fcsv, _, fdir = generate_dataset(ws, n_patients=3, clips_per_patient=1,
                                     frames_per_clip=3, hw=(32, 32), seed=5)
    jax_spec = jax_build_model("cnn0", CNN0_HP, (32, 32, 3), 2)
    spec = build_model("cnn0", CNN0_HP, (32, 32, 3), 2)
    epochs = [jax_spec.init_variables(jax.random.PRNGKey(k))
              for k in (3, 4)]
    jax_logger = JaxLogger(jax_spec, JaxFrameDataset.from_csv(
        fcsv, fdir, img_dim=(32, 32)), max_rows=4, n_heatmaps=2,
        heatmap_dir=os.path.join(ws, "jax"))
    logger = PredictionTableLogger(
        spec, FrameDataset(pd.read_csv(fcsv), fdir, img_dim=(32, 32),
                           use_native=False),
        max_rows=4, n_heatmaps=2, heatmap_dir=os.path.join(ws, "port"),
        device="cpu")

    seen = {"jax": [], "port": []}

    def recorder(key, overlay):
        def record(orig, cam, *args):
            seen[key].append((np.asarray(orig), np.asarray(cam)))
            return overlay(orig, cam, *args)
        return record

    monkeypatch.setattr(jax_gradcam, "heatmap_overlay",
                        recorder("jax", jax_gradcam.heatmap_overlay))
    monkeypatch.setattr(gradcam, "heatmap_overlay",
                        recorder("port", gradcam.heatmap_overlay))
    ptrs, passes = None, []
    for epoch, variables in enumerate(epochs):
        want = jax_logger.on_epoch_end(epoch, variables)
        rows = logger.on_epoch_end(epoch, state_dict_from_flax(variables))
        assert [r["idx"] for r in rows] == list(want["idx"])
        assert [r["pred"] for r in rows] == list(want["pred"])
        np.testing.assert_allclose([r["probs"] for r in rows],
                                   np.stack(want["probs"]), atol=2e-5)
        params = dict(logger.predictor.module.named_parameters())
        now = [p.data_ptr() for p in params.values()]
        assert ptrs is None or now == ptrs
        ptrs = now
        state = state_dict_from_flax(variables)
        assert all(torch.equal(p, state[k]) for k, p in params.items())
        passes.append(logger.gradcam)
    assert passes[0] is passes[1]
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for (im, cam), (want_im, want_cam) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(im, want_im)
        np.testing.assert_allclose(cam, want_cam, atol=CAM_ATOL)
    assert max(c.max() for _, c in seen["jax"]) > 0.5
    assert not np.allclose(seen["jax"][0][1], seen["jax"][2][1],
                           atol=CAM_ATOL), "the weights did not change"
    assert logger.gradcam.summaries().keys() == {"2x32x32x3"}
    assert len(glob.glob(os.path.join(ws, "port", "*.png"))) == 4
