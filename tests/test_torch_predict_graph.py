"""PyTorch port, the serving forward as one program per input shape
(``predict/predict.py::Predictor``): on the card a CUDA graph per chunk
shape, here on the CPU the same body uncaptured, against the JAX
package's jitted ``Predictor``.

The same numpy-seeded frames and weights (carried across by the weight
bridge) go through both packages in float32: cnn0, mobilenetv2, vgg16
(caffe preprocessing) and custom_resnetv2 at 32x32, two classes, the last
two with their config.yml hyperparameters and the scaled, batch-norm
calibrated weights of ``tests/test_torch_train_step.py``. Each predictor serves two chunk shapes (frames of the
model's size and of a larger source, resized by the forward's
preprocess), each sweep ending in a ragged chunk that both packages pad
with zero frames to the batch size. Probabilities within
``tests/test_torch_predict.py``'s ``PROB_ATOL`` (1e-4); the body against
the port's own eager forward, across calls and across the padding, is
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_gradcam import CNN0_HP, _frames, _models
from test_torch_predict import PROB_ATOL
from test_torch_train_step import scaled_variables

from ab_line_classifier_tpu.data.pipeline import (
    FrameDataset as JaxFrameDataset)
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.predict.predict import Predictor as JaxPredictor
from ab_line_classifier_tpu.train.callbacks import (
    PredictionTableLogger as JaxLogger)
from ab_line_classifier_torch.data.pipeline import FrameDataset
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.predict import benchmark
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.train.callbacks import PredictionTableLogger
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

BATCH = 4


def _cnn0_models():
    """(JAX spec, port spec, JAX variables) of cnn0 at 32x32."""
    shape = (32, 32, 3)
    jax_spec = jax_build_model("cnn0", CNN0_HP, shape, 2)
    return (jax_spec, build_model("cnn0", CNN0_HP, shape, 2),
            jax_spec.init_variables(jax.random.PRNGKey(1)))


def zoo_models(name):
    """vgg16 or custom_resnetv2 at 32x32 with its config.yml
    hyperparameters: (JAX spec, port spec, JAX variables), the variables
    scaled and their batch-norm statistics set from 16 frames."""
    shape = (32, 32, 3)
    jax_spec = jax_build_model(name, ZOO_HPARAMS[name], shape, 2)
    spec = build_model(name, ZOO_HPARAMS[name], shape, 2)
    return jax_spec, spec, scaled_variables(jax_spec, spec,
                                            _frames(16, 32, seed=5))


@pytest.fixture(scope="module", params=["cnn0", "mobilenetv2", "vgg16",
                                        "custom_resnetv2"])
def case(request):
    name = request.param
    if name == "cnn0":
        return name, _cnn0_models()
    if name in ("vgg16", "custom_resnetv2"):
        return name, zoo_models(name)
    return name, _models(name)


def _sweeps():
    """Two chunk shapes, each sweep ragged at batch 4: 10 frames of
    32x32 (chunks 4, 4, 2) and 7 of 48x40 (4, 3)."""
    return (_frames(10, 32, seed=31),
            np.random.RandomState(32).randint(
                0, 256, (7, 48, 40, 3)).astype(np.uint8))


def _predictor(spec, variables, batch_size=BATCH):
    return Predictor(spec, state_dict_from_flax(variables),
                     batch_size=batch_size, compute_dtype=torch.float32,
                     device="cpu")


def test_serving_body_matches_jax_at_two_shapes(case):
    _, (jax_spec, spec, variables) = case
    predictor = _predictor(spec, variables)
    assert predictor.graph_mode == "uncaptured"
    jax_predictor = JaxPredictor(jax_spec, variables, batch_size=BATCH,
                                 compute_dtype=jnp.float32)
    for frames in _sweeps():
        got = predictor.predict_probs(frames)
        want = jax_predictor.predict_probs(frames)
        assert got.shape == want.shape == (len(frames), 2)
        np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert sorted(predictor.summaries()) == ["4x32x32x3", "4x48x40x3"]
    assert all(s["mode"] == "uncaptured" and s["capture_seconds"] is None
               for s in predictor.summaries().values())


def test_serving_body_equals_the_eager_forward(case):
    """The body through its fixed input, twice a shape, from the device
    (here the CPU) and from a host array, against the forward dispatched
    op by op on the frames: bit-equal."""
    _, (_, spec, variables) = case
    predictor = _predictor(spec, variables)
    for frames in [f[:BATCH] for f in _sweeps()] * 2:
        want = predictor.eager(torch.from_numpy(frames))
        assert want.dtype == torch.float32 and want.shape == (BATCH, 2)
        assert torch.equal(predictor.forward(torch.from_numpy(frames)), want)
        assert torch.equal(predictor.forward(frames), want)
    assert len(predictor.summaries()) == 2


def test_results_are_not_aliased():
    """Calls on a, b, b, a: what each call returned is unchanged by the
    later calls of the same shape (the outputs are not the fixed
    buffers)."""
    _, spec, variables = _cnn0_models()
    predictor = _predictor(spec, variables)
    batches = [torch.from_numpy(_frames(BATCH, 32, seed=s)) for s in (1, 2)]
    outs = [predictor.forward(batches[i]) for i in (0, 1, 1, 0)]
    kept = [o.clone() for o in outs]
    predictor.forward(batches[1])
    assert not torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[3]) and torch.equal(outs[1], outs[2])
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    assert list(predictor.summaries()) == ["4x32x32x3"]


def test_ragged_chunk_is_padded_to_the_batch(monkeypatch):
    """The JAX package's static chunk shape: the last chunk of 10 frames
    at batch 4 goes through the batch's one program padded with two zero
    frames, and the pad rows are dropped."""
    _, spec, variables = _cnn0_models()
    predictor = _predictor(spec, variables)
    shapes = []
    forward = Predictor.forward

    def recorded(self, frames):
        shapes.append(tuple(frames.shape))
        return forward(self, frames)

    monkeypatch.setattr(Predictor, "forward", recorded)
    frames = _frames(10, 32, seed=33)
    got = predictor.predict_probs(frames)
    assert shapes == [(BATCH, 32, 32, 3)] * 3
    assert got.shape == (10, 2)
    padded = np.zeros((BATCH, 32, 32, 3), np.uint8)
    padded[:2] = frames[8:]
    want = torch.cat([predictor.eager(frames[:4]), predictor.eager(
        frames[4:8]), predictor.eager(padded)[:2]]).numpy()
    assert np.array_equal(got, want)
    assert list(predictor.summaries()) == ["4x32x32x3"]


def test_predict_dataset_serves_static_batches(tmp_path):
    """``predict_dataset`` over a frames table whose last batch is
    ragged: every batch through one program, rows equal to the eager
    forward of the dataset's padded batches."""
    fcsv, _, fdir = generate_dataset(str(tmp_path), n_patients=2,
                                     clips_per_patient=1, frames_per_clip=5,
                                     hw=(32, 32), seed=7)
    _, spec, variables = _cnn0_models()
    predictor = _predictor(spec, variables)
    ds = FrameDataset(pd.read_csv(fcsv), fdir, img_dim=(32, 32),
                      use_native=False)
    got = predictor.predict_dataset(ds)
    want = np.zeros_like(got)
    for batch in ds.batches(BATCH):
        valid = batch.mask > 0
        want[batch.indices[valid]] = predictor.eager(
            batch.images).numpy()[valid]
    assert got.shape == (10, 2) and np.array_equal(got, want)
    assert list(predictor.summaries()) == ["4x32x32x3"]


def test_latency_chain_runs_the_eager_forward(monkeypatch):
    """The batch-1 chain calls ``Predictor.eager`` (a CUDA graph cannot
    be captured inside the chain's own capture), never the per-shape
    program."""
    def refused(self, frames):
        raise AssertionError("the latency chain called Predictor.forward")

    calls = []
    eager = Predictor.eager

    def counted(self, frames):
        calls.append(tuple(frames.shape))
        return eager(self, frames)

    monkeypatch.setattr(Predictor, "forward", refused)
    monkeypatch.setattr(Predictor, "eager", counted)
    r = benchmark.single_frame_latency_benchmark(
        img_dim=(32, 32), chain_len=3, n_warmup=1, n_iters=1,
        spec=benchmark.build_zoo("cnn0", (32, 32)), device="cpu",
        verbose=False)
    assert r["eager_ms_per_frame"] > 0 and r["graph_ms_per_frame"] is None
    assert calls and set(calls) == {(1, 32, 32, 3)}
    assert len(calls) % 3 == 0


def test_clip_inference_benchmark_reports_its_path():
    r = benchmark.clip_inference_benchmark(
        batch_size=2, img_dim=(32, 32), n_warmup=1, n_iters=1,
        spec=benchmark.build_zoo("cnn0", (32, 32)), device="cpu",
        verbose=False)
    assert r["graph_mode"] == "uncaptured"
    assert r["capture_seconds"] is None and r["frames_per_sec"] > 0


def test_prediction_table_logger_matches_jax(tmp_path):
    """The logger's table over two epochs whose weights differ, against
    the JAX package's logger on the same frames and weights: one
    predictor for the run (the same parameter tensors, new weights copied
    in) and one program for its table batches."""
    ws = str(tmp_path)
    fcsv, _, fdir = generate_dataset(ws, n_patients=3, clips_per_patient=1,
                                     frames_per_clip=3, hw=(32, 32), seed=6)
    jax_spec, spec, _ = _cnn0_models()
    epochs = [jax_spec.init_variables(jax.random.PRNGKey(k))
              for k in (5, 6)]
    jax_logger = JaxLogger(jax_spec, JaxFrameDataset.from_csv(
        fcsv, fdir, img_dim=(32, 32)), max_rows=6)
    logger = PredictionTableLogger(
        spec, FrameDataset(pd.read_csv(fcsv), fdir, img_dim=(32, 32),
                           use_native=False),
        max_rows=6, device="cpu")
    ptrs, predictors, tables = None, [], []
    for epoch, variables in enumerate(epochs):
        want = jax_logger.on_epoch_end(epoch, variables)
        rows = logger.on_epoch_end(epoch, state_dict_from_flax(variables))
        assert [r["idx"] for r in rows] == list(want["idx"])
        assert [r["frame"] for r in rows] == list(want["frame"])
        assert [r["label"] for r in rows] == list(want["label"])
        assert [r["pred"] for r in rows] == list(want["pred"])
        np.testing.assert_allclose([r["probs"] for r in rows],
                                   np.stack(want["probs"]), atol=2e-5)
        now = [p.data_ptr() for p in logger.predictor.module.parameters()]
        assert ptrs is None or now == ptrs
        ptrs = now
        predictors.append(logger.predictor)
        tables.append(np.stack(want["probs"]))
    assert predictors[0] is predictors[1]
    assert not np.allclose(tables[0], tables[1], atol=1e-3), \
        "the weights did not change"
    assert list(logger.predictor.summaries()) == ["6x32x32x3"]
