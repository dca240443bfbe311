"""PyTorch port, WaveBase deploy serving (``predict/deploy.py``) against
the JAX package's on the same numpy-seeded frames, on the CPU.

The served model is a cnn0 checkpoint saved by the JAX package and
converted by ``scripts/orbax_to_torch.py``. Tolerances: the host
preprocessing and B1's plain version exactly; parity below 1e-5 (the
JAX package's bar, ``tests/test_etl.py``); probabilities within 1e-5
(float32 convolutions summed in another order). The two packages' CSVs
differ only where their probabilities do: the port's writer, given the
JAX package's probabilities, writes the JAX package's file byte for byte,
and the port's own file has the same rows with probabilities within 1e-5.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from conftest import REPO_ROOT
from test_torch_zoo import serving_variables as zoo_variables

from ab_line_classifier_tpu.models import get_model as jax_get_model
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_tpu.predict import deploy as jax_deploy
from ab_line_classifier_tpu.utils import checkpoint as jax_ckpt
from ab_line_classifier_torch.models.registry import get_model
from ab_line_classifier_torch.ops import preprocess_cuda
from ab_line_classifier_torch.predict import deploy
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS

PROB_ATOL = 1e-5
SHAPE = (32, 32, 3)
SRC_HW = (96, 200)
MODELS = ("cutoffvgg16", "mobilenetv2", "efficientnetb7")


def clip_frames(n=12, hw=SRC_HW, seed=0):
    """uint8 frames whose brightness varies from frame to frame."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n,) + hw + (3,)) * rng.uniform(0.2, 1.0, (
        n, 1, 1, 1))
    return x.astype(np.uint8)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A float32 cnn0 checkpoint saved by the JAX package (scaled random
    weights, batch-norm statistics set from the served inputs), and its
    port conversion by ``scripts/orbax_to_torch.py``."""
    root = tmp_path_factory.mktemp("deploy")
    inputs = np.array(fused_preprocess(
        jnp.asarray(clip_frames()), out_hw=SHAPE[:2], preprocess_mode="tf",
        resize_mode="cv2", blank_ui_region=True))
    variables = zoo_variables("cnn0", inputs)
    meta = {"model_name": "cnn0", "hparams": ZOO_HPARAMS["cnn0"],
            "input_shape": list(SHAPE), "n_classes": 2,
            "classes": ["a_lines", "b_lines"], "preprocess_mode": "tf",
            "mixed_precision": False}
    src = jax_ckpt.save_model(str(root / "jax_cnn0"), variables, meta)
    script = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO_ROOT, "scripts",
                                       "orbax_to_torch.py"))
    converter = importlib.util.module_from_spec(script)
    script.loader.exec_module(converter)
    return src, converter.convert(src, str(root / "port_cnn0")), root


@pytest.mark.parametrize("model", MODELS)
def test_host_preprocess_equal_to_jax(model):
    frame = np.random.RandomState(1).randint(0, 256, (240, 320, 3)).astype(
        np.uint8)
    want = jax_deploy.ab_classifier_preprocess(frame[None],
                                               jax_get_model(model)[1])
    got = deploy.ab_classifier_preprocess(frame[None], get_model(model)[1])
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("model", MODELS)
def test_preprocess_parity_below_1e_5(model):
    frame = np.random.RandomState(1).randint(0, 256, (240, 320, 3)).astype(
        np.uint8)
    assert deploy.check_preprocess_parity(frame, model, device="cpu") < 1e-5
    assert jax_deploy.check_preprocess_parity(frame, model) < 1e-5


def test_parity_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    frame = np.zeros((60, 80, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.check_preprocess_parity(frame, "cutoffvgg16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.load_deploy_model("unused")


def test_wavebase_probabilities_and_csv_match_jax(checkpoints, tmp_path):
    src, dst, _ = checkpoints
    frames = clip_frames()
    want = jax_deploy.predict_wavebase_mp4(src, "unused.mp4",
                                           str(tmp_path / "jax.csv"),
                                           frames=frames)
    preprocess_cuda.reset_launch_count()
    got = deploy.predict_wavebase_mp4(dst, "unused.mp4",
                                      str(tmp_path / "port.csv"),
                                      frames=frames, device="cpu")
    assert preprocess_cuda.launch_count == 0   # the plain version on the CPU
    assert got.dtype == np.float32 and got.shape == (12, 2)
    assert np.ptp(np.asarray(want)[:, 1]) > 1e-3, "probabilities are flat"
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)

    deploy.write_preds_csv(np.asarray(want), str(tmp_path / "rewrite.csv"))
    with open(tmp_path / "jax.csv", "rb") as a, \
            open(tmp_path / "rewrite.csv", "rb") as b:
        assert a.read() == b.read()
    ours = pd.read_csv(tmp_path / "port.csv")
    theirs = pd.read_csv(tmp_path / "jax.csv")
    assert list(ours.columns) == ["Frame", "A lines", "B lines"]
    assert list(ours.columns) == list(theirs.columns)
    np.testing.assert_array_equal(ours["Frame"], theirs["Frame"])
    np.testing.assert_allclose(ours[["A lines", "B lines"]].to_numpy(),
                               theirs[["A lines", "B lines"]].to_numpy(),
                               rtol=0, atol=PROB_ATOL)


def test_ui_box_is_blanked(checkpoints, tmp_path):
    """Two clips that differ only inside the 50x160 UI box give equal
    probabilities; one pixel outside it changes them."""
    _, dst, _ = checkpoints
    a = clip_frames(seed=2)
    b = a.copy()
    b[:, :50, :160] = np.random.default_rng(9).integers(
        0, 256, (len(b), 50, 160, 3), dtype=np.uint8)
    spec, module = deploy.load_deploy_model(dst, device="cpu")
    pa = deploy.deploy_forward(spec, module, torch.from_numpy(a))
    pb = deploy.deploy_forward(spec, module, torch.from_numpy(b))
    assert torch.equal(pa, pb)
    c = a.copy()
    c[:, :, 160:] = 255 - c[:, :, 160:]
    assert not torch.equal(pa, deploy.deploy_forward(spec, module,
                                                     torch.from_numpy(c)))


def test_decode_mp4_frames_equal_to_jax(checkpoints, tmp_path):
    import cv2
    _, dst, _ = checkpoints
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (SRC_HW[1], SRC_HW[0]), True)
    for frame in clip_frames(n=6, seed=4):
        writer.write(frame)
    writer.release()
    want = jax_deploy.decode_mp4_frames(path)
    got = deploy.decode_mp4_frames(path)
    assert got.shape == (6,) + SRC_HW + (3,)
    np.testing.assert_array_equal(got, want)
    # The mp4 path of the serving entry point decodes the same frames.
    preds = deploy.predict_wavebase_mp4(dst, path, str(tmp_path / "p.csv"),
                                        device="cpu")
    spec, module = deploy.load_deploy_model(dst, device="cpu")
    assert torch.equal(torch.from_numpy(preds), deploy.deploy_forward(
        spec, module, torch.from_numpy(np.ascontiguousarray(want))))
